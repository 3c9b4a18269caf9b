from super_rag_tpu_torch.agent.runtime import AgentSession, Tool, ToolRegistry
from super_rag_tpu_torch.agent.session_manager import AgentSessionManager

__all__ = ["AgentSession", "Tool", "ToolRegistry", "AgentSessionManager"]
