"""The readers of the program's own stage spans (``program_trace.py`` and
the eight metrics on it), each on a hand-made run whose values are worked
by hand, and on a program that records no stages."""

import json
import os

import pytest
from conftest import ROOT

from benchmark import program_trace, registry, trace
from benchmark.readers import Run
from super_rag_tpu_torch.trace import tracing
from super_rag_tpu_torch.trace.tracing import Stage

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
STAGE_METRICS = ["queue_wait_ms", "tokenize_ms", "encoder_launches", "query_analysis_ms",
                 "lexical_device_ms", "hits_ms", "idle_in_gc", "idle_unattributed"]
W, OTHER = 7, 8  # the batcher's worker thread, and another thread


def _dispatch(sid, t0, t1, queries, wait, stages):
    """A ``batcher.dispatch`` record and its stages: ``(name, t0, t1,
    device)`` in order, each under the last open stage that holds it."""
    out = [Stage("batcher.dispatch", sid, None, sid, W, t0, t1,
                 (("queries", queries), ("wait_sum_s", wait)), None)]
    parents = {"engine.search_batch": "batcher.dispatch", "embed": "engine.search_batch",
               "embed.tokenize": "embed", "embed.forward": "embed",
               "index.search_hybrid": "engine.search_batch",
               "index.analyze": "index.search_hybrid", "index.lexical": "index.search_hybrid",
               "engine.copy": "engine.search_batch", "engine.hits": "engine.search_batch"}
    ids = {"batcher.dispatch": sid}
    for i, (name, s, e, dev) in enumerate(stages, 1):
        ids[name] = sid + i
        out.append(Stage(name, sid + i, ids[parents[name]], sid, W, s, e, (), dev))
    return out


def _run() -> tuple:
    """A 10 s window (10, 20): dispatches A and B inside it, C cut by its
    end, D started before it; a full collection inside A's hits and one
    across the window's start; a leaf stage on another thread."""
    recs = []
    recs += _dispatch(1, 11.0, 13.0, 4, 2.0, [
        ("engine.search_batch", 11.0, 13.0, None), ("embed", 11.0, 11.6, None),
        ("embed.tokenize", 11.0, 11.1, None), ("embed.forward", 11.1, 11.5, (11.15, 11.55)),
        ("index.search_hybrid", 11.6, 12.4, None), ("index.analyze", 11.6, 11.8, None),
        ("index.lexical", 11.8, 11.9, (11.9, 12.3)), ("engine.copy", 12.4, 12.5, None),
        ("engine.hits", 12.5, 12.9, None)])
    recs += _dispatch(20, 14.0, 16.0, 2, 1.0, [
        ("engine.search_batch", 14.0, 16.0, None), ("embed", 14.0, 14.5, None),
        ("embed.tokenize", 14.0, 14.2, None), ("embed.forward", 14.2, 14.4, (14.25, 14.45)),
        ("index.search_hybrid", 14.5, 15.5, None), ("index.analyze", 14.5, 14.6, None),
        ("index.lexical", 14.6, 14.7, (14.7, 15.0)), ("engine.copy", 15.5, 15.6, None),
        ("engine.hits", 15.6, 15.8, None)])
    recs += _dispatch(40, 19.5, 20.5, 8, 4.0, [
        ("engine.search_batch", 19.5, 20.5, None), ("embed", 19.5, 19.8, None),
        ("embed.tokenize", 19.5, 19.6, None), ("embed.forward", 19.6, 19.7, (19.6, 19.7))])
    recs += _dispatch(60, 9.0, 9.8, 100, 100.0, [("engine.search_batch", 9.0, 9.8, None)])
    recs += [Stage("runtime.gc", 80, None, 80, W, 12.6, 12.8, (), None),
             Stage("runtime.gc", 81, None, 81, OTHER, 9.9, 10.1, (), None),
             Stage("embed.tokenize", 82, None, 82, OTHER, 17.0, 17.5, (), None)]
    kernels = [("fwd", 11.1, 11.12), ("fwd", 11.2, 11.25), ("fwd", 11.3, 11.4),
               ("fwd", 11.5, 11.52), ("lex", 11.95, 12.05), ("lex", 12.0, 12.1),
               ("lex", 12.25, 12.35), ("fwd", 14.3, 14.35), ("fwd", 14.4, 14.42),
               ("lex", 14.8, 14.9), ("fwd", 19.65, 19.68)]
    window = (10.0, 20.0)
    run = Run(cell="a10m.batch512", config={}, traffic={}, queries=[], requests=[],
              window=window, setup_s=1.0, counters={},
              device=trace.DeviceTrace(kernels, window))
    return run, sorted(recs, key=lambda r: r.t0)


# worked by hand (the docstring of each case says how)
WANT = {
    # (2 + 1 + 4) s over 4 + 2 + 8 queries of A, B, C; D began before the window
    "queue_wait_ms": 500.0,
    # A 0.1 + B 0.2 + C 0.1 s over three dispatches
    "tokenize_ms": 400.0 / 3,
    # A 0.2 + B 0.1 s over three dispatches
    "query_analysis_ms": 100.0,
    # A 0.4 s less the 0.2 s collection in it, B 0.2 s, over three dispatches
    "hits_ms": 400.0 / 3,
    # A's forward holds 3 starts (11.1 is before its enter event), B's 2; C is cut
    "encoder_launches": 2.5,
    # A: 11.95-12.1 and 12.25-12.3 inside (11.9, 12.3); B: 0.1 s; over A and B
    "lexical_device_ms": 150.0,
    # the card is idle through both collections' 0.1 + 0.2 s in the window
    "idle_in_gc": 3.0,
    # idle 10 - 0.64 busy = 9.36 s; the collections and the worker's leaves
    # cover 2.5 s, 0.25 of it busy; the leaf on another thread covers nothing
    "idle_unattributed": 100.0 * (9.36 - 2.25) / 10.0,
}


@pytest.fixture
def stages(monkeypatch):
    run, recs = _run()
    monkeypatch.setattr(program_trace, "fetch",
                        lambda t_from, t_to: [r for r in recs if t_from <= r.t0 < t_to] or None)
    return run


@pytest.mark.parametrize("name", STAGE_METRICS)
def test_each_reader_on_a_hand_made_run(stages, name):
    assert registry.metric_reader(name)(stages) == pytest.approx(WANT[name], rel=1e-9)


@pytest.mark.parametrize("name", STAGE_METRICS)
def test_readers_give_none_without_the_programs_stages(monkeypatch, name):
    run, _ = _run()
    tracer = tracing.Tracer()  # nothing recorded
    monkeypatch.setattr(tracing, "get_tracer", lambda: tracer)
    assert registry.metric_reader(name)(run) is None
    # a program whose tracer keeps no stage records
    monkeypatch.setattr(tracing, "get_tracer", lambda: object())
    assert registry.metric_reader(name)(run) is None


def test_device_readers_give_none_without_a_device_trace(stages):
    stages.device = None
    for name in ("encoder_launches", "lexical_device_ms", "idle_in_gc", "idle_unattributed"):
        assert registry.metric_reader(name)(stages) is None
    assert registry.metric_reader("queue_wait_ms")(stages) == pytest.approx(500.0)


def test_every_stage_metric_is_an_entry():
    entries = {m["name"]: m for m in SPEC["per_layer"]}
    for name in STAGE_METRICS:
        assert entries[name]["workloads"] == ["a10m.batch512"]
        assert entries[name]["source"] in ("program_span", "device_trace")


def test_intervals():
    assert program_trace.union([(3, 4), (1, 2), (1.5, 2.5), (5, 5)]) == [(1, 2.5), (3, 4)]
    assert program_trace.overlap_s([(0, 2), (3, 5)], [(1, 4)]) == 2.0
    assert program_trace.clip([(0, 2), (3, 5), (6, 7)], (1, 4)) == [(1, 2), (3, 4)]
