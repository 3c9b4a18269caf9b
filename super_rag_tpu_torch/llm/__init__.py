"""Model-provider layer of the port (port of the JAX package's llm/):
the error taxonomy, the provider clients over ``http.client`` (openai,
anthropic, dashscope, gemini; bedrock and vertex in ``signed.py``), the
per-collection resolver and the prompt library."""

from super_rag_tpu_torch.llm.errors import (
    LLMError,
    AuthenticationError,
    RateLimitError,
    ContextWindowExceededError,
    ProviderUnavailableError,
    is_retryable_error,
    wrap_provider_error,
)
from super_rag_tpu_torch.llm.client import OpenAICompatClient
from super_rag_tpu_torch.llm.resolver import ModelResolver

__all__ = [
    "LLMError", "AuthenticationError", "RateLimitError",
    "ContextWindowExceededError", "ProviderUnavailableError",
    "is_retryable_error", "wrap_provider_error",
    "OpenAICompatClient", "ModelResolver",
]
