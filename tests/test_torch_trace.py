"""The port's tracer (``super_rag_tpu_torch/trace/``) against the JAX
package's: the four cases of ``tests/test_trace.py`` run on both, and the
``torch.profiler`` hook of ``trace_function(device_profile_dir=...)`` on
the CPU."""

import asyncio
import json
import os

import pytest

from super_rag_tpu import trace as jtrace
from super_rag_tpu.trace import tracing as jtracing
from super_rag_tpu_torch import trace as ttrace
from super_rag_tpu_torch.trace import tracing as ttracing

TRACERS = {"jax": jtrace, "port": ttrace}


def shape(spans: list) -> list:
    """What two tracers can agree on: names, statuses, attributes and the
    parent links as positions (ids are random)."""
    ids = {s["span_id"]: i for i, s in enumerate(spans)}
    return [(s["name"], s["status"], s["attributes"], ids.get(s["parent_id"]),
             s["trace_id"] == spans[0]["trace_id"]) for s in spans]


def hierarchy(mod):
    t = mod.Tracer()
    with t.start_span("parent") as parent:
        with t.start_span("child") as child:
            assert child.trace_id == parent.trace_id
            assert child.parent_id == parent.span_id
            assert t.current_trace_id() == parent.trace_id
    assert t.current_trace_id() is None
    spans = t.recent()
    assert [s["name"] for s in spans] == ["child", "parent"]
    assert spans[1]["duration_ms"] >= spans[0]["duration_ms"]
    return spans


def error_status(mod):
    t = mod.Tracer()
    with pytest.raises(ValueError):
        with t.start_span("boom", {"k": 1}):
            raise ValueError("nope")
    s = t.recent()[-1]
    assert s["status"] == "ERROR" and "nope" in s["attributes"]["error"]
    return t.recent()


def decorators(mod):
    tracer = mod.get_tracer()
    before = len(tracer.recent(10_000))

    @mod.trace_function()
    def work(x):
        return x * 2

    @mod.trace_async_function("async-work")
    async def awork(x):
        return x + 1

    assert work(21) == 42
    loop = asyncio.new_event_loop()
    try:
        assert loop.run_until_complete(awork(1)) == 2
    finally:
        loop.close()
    spans = tracer.recent(10_000)[before:]
    names = [s["name"] for s in spans]
    assert any("work" in n for n in names) and "async-work" in names
    return spans


def ring_buffer(mod):
    t = mod.Tracer(max_spans=5)
    for i in range(10):
        with t.start_span(f"s{i}"):
            pass
    assert len(t.recent(100)) == 5
    return t.recent(100)


@pytest.mark.parametrize("case", [hierarchy, error_status, decorators, ring_buffer],
                         ids=lambda f: f.__name__)
def test_cases_agree_with_the_jax_tracer(case):
    got = {name: case(mod) for name, mod in TRACERS.items()}
    assert shape(got["port"]) == shape(got["jax"])


def test_surface_matches():
    assert set(jtrace.__all__) <= set(ttrace.__all__)
    assert set(ttrace.__all__) - set(jtrace.__all__) == {"SpanContext"}
    assert ttracing.Span.__dataclass_fields__.keys() == jtracing.Span.__dataclass_fields__.keys()


def test_profiler_hook_writes_a_chrome_trace(tmp_path):
    """``device_profile_dir``: the call runs under ``torch.profiler`` and a
    Chrome trace lands in the directory, named on the span (the JAX
    tracer's ``jax_profile`` attribute is ``torch_profile`` here)."""
    import torch

    out_dir = tmp_path / "profile"

    @ttrace.trace_function("profiled", device_profile_dir=str(out_dir))
    def work(x):
        return torch.matmul(x, x).sum()

    assert float(work(torch.ones(8, 8))) == 512.0
    span = ttrace.get_tracer().recent(1)[-1]
    assert span["name"] == "profiled" and span["status"] == "OK"
    assert span["attributes"]["torch_profile"] == str(out_dir)
    path = span["attributes"]["torch_trace"]
    assert os.path.dirname(path) == str(out_dir) and os.path.exists(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
