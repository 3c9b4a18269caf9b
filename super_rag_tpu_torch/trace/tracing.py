"""Lightweight tracing (OpenTelemetry-shaped; port of the JAX package's
trace/tracing.py), and the program's stage spans.

The same surface as the JAX package's: hierarchical spans through
contextvars, W3C-style trace and span ids, a bounded in-memory ring of
finished spans with optional logging, ``@trace_function`` /
``@trace_async_function`` decorators.  Where the JAX package's
``trace_function(device_profile_dir=...)`` wraps the call in
``jax.profiler.trace``, this one wraps it in ``torch.profiler.profile``
(CPU activity, and CUDA where a card is present) and writes a Chrome
trace into that directory; the span attribute is ``torch_profile``.

Stage spans (``Tracer.stage``) time the served path's layers from inside
the program.  They record only while ``Tracer.enable()`` is in force or a
``torch.profiler`` capture runs; otherwise a stage is one flag check that
returns a shared no-op.  A record is a tuple of plain values (name, ids
from an integer counter, thread, ``perf_counter`` start and end, numeric
attributes) in a bounded buffer, so a traced stretch leaves nothing for
the garbage collector to walk.  A device stage also records a CUDA event
at enter and at exit on the current stream (never synchronizing), which
``Tracer.stages`` turns into ``perf_counter`` seconds.  While recording,
every full (generation 2) collection is a stage ``runtime.gc``.  Spans and
stages share one clock, ``time.perf_counter``; ``Span.to_dict`` gives an
epoch ``start`` through one offset taken at import.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import gc
import itertools
import logging
import math
import os
import secrets
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.autograd.profiler as _torch_profiler

logger = logging.getLogger("super_rag_tpu_torch.trace")

_current_span: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "current_span", default=None
)

# perf_counter seconds + _EPOCH = seconds since the epoch
_EPOCH = time.time() - time.perf_counter()

# a 51 s traced window of the served path is ~330 dispatches of ~20 stages
STAGE_RECORDS = 1 << 15
# CUDA events are reused in turn; a record's events resolve until reused
EVENT_RING = 1 << 14
# the traced stretches whose reference events are kept
STRETCHES_KEPT = 8


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    start: float = field(default_factory=time.perf_counter)
    end: Optional[float] = None
    attributes: dict = field(default_factory=dict)
    status: str = "OK"

    @property
    def duration_ms(self) -> float:
        return ((self.end or time.perf_counter()) - self.start) * 1000.0

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def to_dict(self) -> dict:
        return {
            "name": self.name, "trace_id": self.trace_id,
            "span_id": self.span_id, "parent_id": self.parent_id,
            "start": self.start + _EPOCH, "duration_ms": round(self.duration_ms, 3),
            "attributes": self.attributes, "status": self.status,
        }


class Stage(NamedTuple):
    """One stage record as ``Tracer.stages`` exports it.  Times are
    ``perf_counter`` seconds; ``device`` is the (start, end) of a device
    stage's two events on the card, None elsewhere."""
    name: str
    span_id: int
    parent_id: Optional[int]
    trace_id: int  # the span id of its root
    thread: int
    t0: float
    t1: float
    attrs: tuple  # (name, number) pairs
    device: Optional[tuple]


# what a stage is while nothing records: shared, and enters as None
_NO_STAGE = contextlib.nullcontext()


class _StageSpan:
    __slots__ = ("tracer", "name", "device", "span_id", "parent_id", "trace_id",
                 "t0", "e0", "attrs")

    def __init__(self, tracer: "Tracer", name: str, device):
        self.tracer, self.name, self.device = tracer, name, device
        self.attrs: tuple = ()

    def __enter__(self) -> "_StageSpan":
        tr = self.tracer
        stack = tr._stack()
        sid = self.span_id = next(tr._ids)
        self.parent_id, self.trace_id = stack[-1] if stack else (None, sid)
        stack.append((sid, self.trace_id))
        self.e0 = None if self.device is None else tr._event(self.device)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        tr = self.tracer
        e1 = None if self.e0 is None else tr._event(self.device)
        tr._stack().pop()
        tr._stage_records.append((self.name, self.span_id, self.parent_id, self.trace_id,
                                  threading.get_ident(), self.t0, t1, self.attrs, self.e0, e1))
        return False


class Tracer:
    def __init__(self, service_name: str = "super_rag_tpu_torch",
                 max_spans: int = 10_000, log_spans: bool = False):
        self.service_name = service_name
        self.spans: deque[Span] = deque(maxlen=max_spans)
        self.log_spans = log_spans
        self._lock = threading.Lock()
        # stage spans: recording state, records, ids, each thread's open stages
        self._enabled = False
        self._armed = False  # the gc hook is installed
        self._stage_records: deque = deque(maxlen=STAGE_RECORDS)
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._gc_t0: Optional[float] = None
        # device stages: a ring of CUDA events a card, and each traced
        # stretch's reference event (recorded after a synchronize)
        self._events: dict = {}  # device index -> list of events
        self._event_ids = itertools.count()
        self._stretches = itertools.count(1)
        self._ref: Optional[tuple] = None  # (stretch, device index) now
        self._refs: dict = {}  # stretch -> (event, perf_counter s, device index)

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

    # -- stage spans -----------------------------------------------------------

    def enable(self, on: bool = True) -> None:
        """Record stage spans from now on (``on=False``: only while a
        ``torch.profiler`` capture runs, which is the default)."""
        self._enabled = on
        if on:
            self._arm()
        elif not self.active():
            self._disarm()

    def active(self) -> bool:
        """Whether stage spans record now."""
        return self._enabled or _torch_profiler._is_profiler_enabled

    def stage(self, name: str, device: Optional[torch.device] = None):
        """A context manager timing one stage of the served path; entered,
        it gives the open stage (set its ``attrs`` to (name, number) pairs
        before it closes), or None while nothing records.  With a CUDA
        ``device`` it is a device stage: an event on that device's current
        stream at enter and at exit brackets the work it enqueues."""
        if self._enabled or _torch_profiler._is_profiler_enabled:
            if not self._armed:
                self._arm()
            return _StageSpan(self, name, device)
        if self._armed:
            self._disarm()
        return _NO_STAGE

    def stages(self, t_from: float = -math.inf, t_to: float = math.inf) -> list[Stage]:
        """The stage records that start in ``[t_from, t_to)``, oldest first,
        each device stage's events as ``perf_counter`` seconds (the card is
        synchronized first; None where its events were reused)."""
        if not self.active():
            self._disarm()
        recs = [r for r in list(self._stage_records) if t_from <= r[5] < t_to]
        clocks = self._clocks({r[8][0] for r in recs if r[8] is not None})
        oldest = next(self._event_ids) - EVENT_RING
        out = []
        for name, sid, parent, trace, thread, t0, t1, attrs, e0, e1 in recs:
            dev = None
            if e0 is not None and e1 is not None and e0[0] in clocks and e0[1] > oldest:
                to_host = clocks[e0[0]]
                try:
                    dev = (to_host(e0[1]), to_host(e1[1]))
                except RuntimeError:  # an event not recorded or not complete
                    dev = None
            out.append(Stage(name, sid, parent, trace, thread, t0, t1, attrs, dev))
        return out

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _arm(self) -> None:
        # the collection alone: its start taken after every other
        # callback's, its end before every other's
        with self._lock:
            if not self._armed:
                gc.callbacks.append(self._gc_started)
                gc.callbacks.insert(0, self._gc_stopped)
                self._armed = True

    def _disarm(self) -> None:
        with self._lock:
            if self._armed:
                gc.callbacks.remove(self._gc_started)
                gc.callbacks.remove(self._gc_stopped)
                self._armed = False
            self._ref = None  # the next device stage opens a new stretch

    def _gc_started(self, phase: str, info: dict) -> None:
        if phase == "start" and info["generation"] == 2:
            self._gc_t0 = time.perf_counter() if self.active() else None

    def _gc_stopped(self, phase: str, info: dict) -> None:
        if phase == "stop" and info["generation"] == 2 and self._gc_t0 is not None:
            t1 = time.perf_counter()
            sid = next(self._ids)
            self._stage_records.append(("runtime.gc", sid, None, sid, threading.get_ident(),
                                        self._gc_t0, t1, (), None, None))
            self._gc_t0 = None

    def _event(self, device: torch.device) -> Optional[tuple]:
        """Record the next event of the ring on ``device``'s current
        stream: ``(stretch, sequence number)``, or None off the card."""
        if device.type != "cuda":
            return None
        index = device.index if device.index is not None else torch.cuda.current_device()
        ref = self._ref or self._open_stretch(index)
        if ref[1] != index:
            return None
        seq = next(self._event_ids)
        slot = seq % EVENT_RING
        ring = self._events.get(index)
        if ring is None or slot >= len(ring):
            with self._lock:
                ring = self._events.setdefault(index, [])
                while len(ring) <= slot:
                    ring.append(torch.cuda.Event(enable_timing=True))
        ring[slot].record(torch.cuda.current_stream(index))
        return (ref[0], seq)

    def _open_stretch(self, index: int) -> tuple:
        with self._lock:
            if self._ref is None:
                stream = torch.cuda.current_stream(index)
                ev = torch.cuda.Event(enable_timing=True)
                ev.record(stream)  # its first record creates it
                torch.cuda.synchronize(index)
                t = time.perf_counter()
                ev.record(stream)
                stretch = next(self._stretches)
                self._refs[stretch] = (ev, t, index)
                for old in sorted(self._refs)[:-STRETCHES_KEPT]:
                    del self._refs[old]
                self._ref = (stretch, index)
            return self._ref

    def _clocks(self, stretches: set) -> dict:
        """Per stretch, a map from an event's sequence number to
        ``perf_counter`` seconds: linear between the stretch's reference
        event and one recorded now, each taken after a synchronize."""
        out = {}
        for stretch in stretches & set(self._refs):
            ref, t_ref, index = self._refs[stretch]
            stream = torch.cuda.current_stream(index)
            end = torch.cuda.Event(enable_timing=True)
            end.record(stream)
            torch.cuda.synchronize(index)
            t_end = time.perf_counter()
            end.record(stream)
            end.synchronize()
            span_s = ref.elapsed_time(end) / 1e3
            scale = (t_end - t_ref) / span_s if span_s > 0 else 1.0
            ring = self._events[index]

            def to_host(seq: int, ref=ref, t_ref=t_ref, scale=scale, ring=ring) -> float:
                return t_ref + ref.elapsed_time(ring[seq % EVENT_RING]) / 1e3 * scale

            out[stretch] = to_host
        return out


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
        self.span.end = time.perf_counter()
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
