"""The MCP endpoint: the platform's retrieval tools for agent LLMs."""
