"""Lightweight tracing (OpenTelemetry-shaped, stdlib only; port of the JAX
package's trace/tracing.py).

The same surface as the JAX package's: hierarchical spans through
contextvars, W3C-style trace and span ids, a bounded in-memory ring of
finished spans with optional logging, ``@trace_function`` /
``@trace_async_function`` decorators.  Where the JAX package's
``trace_function(device_profile_dir=...)`` wraps the call in
``jax.profiler.trace``, this one wraps it in ``torch.profiler.profile``
(CPU activity, and CUDA where a card is present) and writes a Chrome
trace into that directory; the span attribute is ``torch_profile``.
"""

from __future__ import annotations

import contextvars
import functools
import logging
import os
import secrets
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

logger = logging.getLogger("super_rag_tpu_torch.trace")

_current_span: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "current_span", default=None
)


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    start: float = field(default_factory=time.time)
    end: Optional[float] = None
    attributes: dict = field(default_factory=dict)
    status: str = "OK"

    @property
    def duration_ms(self) -> float:
        return ((self.end or time.time()) - self.start) * 1000.0

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def to_dict(self) -> dict:
        return {
            "name": self.name, "trace_id": self.trace_id,
            "span_id": self.span_id, "parent_id": self.parent_id,
            "start": self.start, "duration_ms": round(self.duration_ms, 3),
            "attributes": self.attributes, "status": self.status,
        }


class Tracer:
    def __init__(self, service_name: str = "super_rag_tpu_torch",
                 max_spans: int = 10_000, log_spans: bool = False):
        self.service_name = service_name
        self.spans: deque[Span] = deque(maxlen=max_spans)
        self.log_spans = log_spans
        self._lock = threading.Lock()

    def start_span(self, name: str, attributes: Optional[dict] = None) -> "SpanContext":
        return SpanContext(self, name, attributes or {})

    def _record(self, span: Span) -> None:
        with self._lock:
            self.spans.append(span)
        if self.log_spans:
            logger.info("span %s %.2fms %s", span.name, span.duration_ms,
                        span.attributes)

    def current_trace_id(self) -> Optional[str]:
        span = _current_span.get()
        return span.trace_id if span else None

    def recent(self, limit: int = 100) -> list[dict]:
        with self._lock:
            return [s.to_dict() for s in list(self.spans)[-limit:]]


class SpanContext:
    def __init__(self, tracer: Tracer, name: str, attributes: dict):
        self.tracer = tracer
        self.name = name
        self.attributes = attributes
        self.span: Optional[Span] = None
        self._token = None

    def __enter__(self) -> Span:
        parent = _current_span.get()
        self.span = Span(
            name=self.name,
            trace_id=parent.trace_id if parent else secrets.token_hex(16),
            span_id=secrets.token_hex(8),
            parent_id=parent.span_id if parent else None,
            attributes=dict(self.attributes),
        )
        self._token = _current_span.set(self.span)
        return self.span

    def __exit__(self, exc_type, exc, tb):
        assert self.span is not None
        self.span.end = time.time()
        if exc_type is not None:
            self.span.status = "ERROR"
            self.span.attributes["error"] = str(exc)
        _current_span.reset(self._token)
        self.tracer._record(self.span)
        return False


_global_tracer: Optional[Tracer] = None


def get_tracer() -> Tracer:
    global _global_tracer
    if _global_tracer is None:
        _global_tracer = Tracer()
    return _global_tracer


def _profiled(fn: Callable, args, kwargs, profile_dir: str) -> tuple:
    """``fn(*args, **kwargs)`` under ``torch.profiler.profile`` (CPU, and
    CUDA with a card); the Chrome trace goes to a new file in
    ``profile_dir``.  Returns ``(result, trace path)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        out = fn(*args, **kwargs)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(profile_dir, f"trace-{os.getpid()}-{secrets.token_hex(4)}.json")
    prof.export_chrome_trace(path)
    return out, path


def trace_function(name: Optional[str] = None,
                   device_profile_dir: Optional[str] = None):
    """Decorator: wrap a sync function in a span; optionally capture a
    ``torch.profiler`` trace of the call into ``device_profile_dir``
    (kernel-path profiling): the span's ``torch_profile`` attribute names
    the directory, ``torch_trace`` the file."""

    def deco(fn: Callable):
        span_name = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with get_tracer().start_span(span_name) as span:
                if device_profile_dir:
                    out, path = _profiled(fn, args, kwargs, device_profile_dir)
                    span.set_attribute("torch_profile", device_profile_dir)
                    span.set_attribute("torch_trace", path)
                    return out
                return fn(*args, **kwargs)

        return wrapped

    return deco


def trace_async_function(name: Optional[str] = None):
    def deco(fn: Callable):
        span_name = name or fn.__qualname__

        @functools.wraps(fn)
        async def wrapped(*args, **kwargs):
            with get_tracer().start_span(span_name):
                return await fn(*args, **kwargs)

        return wrapped

    return deco
