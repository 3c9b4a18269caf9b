"""Spans and decorators (port of the JAX package's trace/)."""

from super_rag_tpu_torch.trace.tracing import (
    Span,
    SpanContext,
    Tracer,
    get_tracer,
    trace_function,
    trace_async_function,
)

__all__ = ["Span", "SpanContext", "Tracer", "get_tracer", "trace_function",
           "trace_async_function"]
