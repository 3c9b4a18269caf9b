"""LLM provider error taxonomy (port of the JAX package's llm/errors.py).

Counterpart of the reference's llm/llm_error_types.py (the error
taxonomy, wrap_litellm_error and is_retryable_error).  Errors wrap raw
provider / HTTP failures into typed exceptions that the retry logic and
the graceful-degradation paths can reason about.  The JAX package
classifies httpx's exceptions; the port's clients speak the standard
library's ``http.client``, so here the transport's own faults are
classified: a socket timeout, a refused or reset connection, and an HTTP
status (``ProviderHTTPError``), each into the class the JAX package gives
the matching httpx exception.
"""

from __future__ import annotations

import socket
from typing import Optional


class LLMError(Exception):
    retryable = False

    def __init__(self, message: str, provider: str = "", model: str = "",
                 status_code: Optional[int] = None):
        super().__init__(message)
        self.provider = provider
        self.model = model
        self.status_code = status_code


class AuthenticationError(LLMError):
    retryable = False


class PermissionError_(LLMError):
    retryable = False


class NotFoundError(LLMError):
    retryable = False


class BadRequestError(LLMError):
    retryable = False


class ContextWindowExceededError(BadRequestError):
    retryable = False


class RateLimitError(LLMError):
    retryable = True


class TimeoutError_(LLMError):
    retryable = True


class ProviderUnavailableError(LLMError):
    retryable = True


class ConnectionError_(LLMError):
    retryable = True


class ProviderHTTPError(Exception):
    """A provider answered with a status outside 2xx (the transport's
    counterpart of httpx's ``HTTPStatusError``)."""

    def __init__(self, status_code: int, text: str, url: str = ""):
        super().__init__(f"HTTP {status_code} from {url}: {text[:200]}")
        self.status_code = status_code
        self.text = text
        self.url = url


def is_retryable_error(err: Exception) -> bool:
    return isinstance(err, LLMError) and err.retryable


def wrap_provider_error(err: Exception, provider: str = "",
                        model: str = "") -> LLMError:
    """Classify a transport / provider exception into the taxonomy."""
    if isinstance(err, LLMError):
        return err
    if isinstance(err, TimeoutError):  # socket.timeout is TimeoutError
        return TimeoutError_(str(err) or "timed out", provider, model)
    if isinstance(err, (ConnectionError, socket.gaierror)):
        # refused, reset, aborted, a closed pipe, or a host that does not
        # resolve (httpx's ConnectError covers the last)
        return ConnectionError_(str(err), provider, model)
    if isinstance(err, ProviderHTTPError):
        sc = err.status_code
        msg = err.text[:500]
        if sc == 401:
            return AuthenticationError(msg, provider, model, sc)
        if sc == 403:
            return PermissionError_(msg, provider, model, sc)
        if sc == 404:
            return NotFoundError(msg, provider, model, sc)
        if sc == 429:
            return RateLimitError(msg, provider, model, sc)
        if sc == 400:
            if "context" in msg.lower() and "length" in msg.lower():
                return ContextWindowExceededError(msg, provider, model, sc)
            return BadRequestError(msg, provider, model, sc)
        if sc >= 500:
            return ProviderUnavailableError(msg, provider, model, sc)
        return LLMError(msg, provider, model, sc)
    return LLMError(str(err), provider, model)
