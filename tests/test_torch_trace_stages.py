"""The port's stage spans (``Tracer.stage``): off unless ``Tracer.enable()``
or a ``torch.profiler`` capture turns them on, the tree a served dispatch
records through ``QueryBatcher`` and ``CollectionEngine``, full
collections as ``runtime.gc`` stages, and no device intervals without a
card."""

import asyncio
import gc
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from super_rag_tpu_torch.engine import batcher as batcher_mod
from super_rag_tpu_torch.engine import index as tindex
from super_rag_tpu_torch.engine.batcher import QueryBatcher
from super_rag_tpu_torch.engine.collection import CollectionEngine
from super_rag_tpu_torch.models.encoder import EncoderConfig
from super_rag_tpu_torch.models.encoder_service import EncoderService
from super_rag_tpu_torch.trace import tracing

# each stage of a hybrid dispatch and the stage it opens in
TREE = {"engine.search_batch": "batcher.dispatch", "embed": "engine.search_batch",
        "embed.tokenize": "embed", "embed.forward": "embed",
        "index.search_hybrid": "engine.search_batch", "index.analyze": "index.search_hybrid",
        "index.dense": "index.search_hybrid", "index.lexical": "index.search_hybrid",
        "index.rescore": "index.search_hybrid", "index.rrf": "index.search_hybrid",
        "engine.copy": "engine.search_batch", "engine.hits": "engine.search_batch"}


@pytest.fixture
def tracer():
    t = tracing.Tracer()
    yield t
    t.enable(False)


def test_off_records_nothing_and_returns_the_shared_no_op(tracer):
    assert not tracer.active()
    spans = {id(tracer.stage(name, torch.device("cpu"))) for name in ("a", "b", "c")}
    assert spans == {id(tracing._NO_STAGE)}
    blocks = sys.getallocatedblocks()
    for _ in range(10_000):
        with tracer.stage("a") as span:
            assert span is None
    assert sys.getallocatedblocks() - blocks < 100
    assert tracer.stages() == []
    assert tracer._gc_started not in gc.callbacks


def test_on_during_a_profiler_capture_and_off_after_it(tracer):
    with tracer.stage("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracer.active()
        with tracer.stage("outer") as outer:
            outer.attrs = (("n", 3),)
            with tracer.stage("inner"):
                pass
    assert not tracer.active()
    with tracer.stage("after") as span:
        assert span is None
    recs = tracer.stages()
    assert [r.name for r in recs] == ["inner", "outer"]
    inner, outer = recs
    assert outer.parent_id is None and outer.trace_id == outer.span_id
    assert inner.parent_id == outer.span_id and inner.trace_id == outer.span_id
    assert outer.attrs == (("n", 3),) and inner.attrs == ()
    assert outer.t0 <= inner.t0 <= inner.t1 <= outer.t1
    assert tracer._gc_started not in gc.callbacks  # disarmed by the first stage after


def test_enable_and_the_export_window(tracer):
    tracer.enable()
    assert tracer.active()
    for name in ("a", "b", "c"):
        with tracer.stage(name):
            time.sleep(0.002)
    tracer.enable(False)
    recs = tracer.stages()
    assert [r.name for r in recs] == ["a", "b", "c"]
    assert [r.name for r in tracer.stages(recs[1].t0, recs[2].t0)] == ["b"]
    assert len({r.span_id for r in recs}) == 3
    assert all(r.thread == threading.get_ident() and r.device is None for r in recs)


def test_a_full_collection_is_a_runtime_gc_stage_and_the_hook_goes_off(tracer):
    tracer.enable()
    assert tracer._gc_started in gc.callbacks and tracer._gc_stopped in gc.callbacks
    # the collection's own time: its start after every other callback's,
    # its end before every other's
    assert gc.callbacks[0] == tracer._gc_stopped and gc.callbacks[-1] == tracer._gc_started
    was = gc.isenabled()
    gc.disable()
    try:
        t0 = time.perf_counter()
        gc.collect(1)
        gc.collect()
        t1 = time.perf_counter()
    finally:
        if was:
            gc.enable()
    tracer.enable(False)
    assert tracer._gc_started not in gc.callbacks and tracer._gc_stopped not in gc.callbacks
    recs = [r for r in tracer.stages() if r.name == "runtime.gc"]
    assert len(recs) == 1
    r = recs[0]
    assert t0 <= r.t0 <= r.t1 <= t1 and r.parent_id is None and r.trace_id == r.span_id
    gc.collect()
    assert len([r for r in tracer.stages() if r.name == "runtime.gc"]) == 1


def test_device_intervals_are_none_without_a_card(tracer):
    tracer.enable()
    for dev in (torch.device("cpu"), None):
        with tracer.stage("d", dev):
            torch.ones(4).sum()
    tracer.enable(False)
    assert [r.device for r in tracer.stages()] == [None, None]


def test_threads_keep_their_own_stage_stacks(tracer):
    """More threads than cores open nested stages under a short switch
    interval: each record's parent is an open stage of its own thread."""
    tracer.enable()
    n_threads, depth, rounds = 16, 3, 50
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        for _ in range(rounds):
            with tracer.stage("s0"):
                with tracer.stage("s1"):
                    with tracer.stage("s2"):
                        pass

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
        tracer.enable(False)
    assert not any(th.is_alive() for th in threads)
    recs = tracer.stages()
    assert len(recs) == n_threads * depth * rounds
    by_id = {r.span_id: r for r in recs}
    assert len(by_id) == len(recs)
    for r in recs:
        level = int(r.name[1])
        if level == 0:
            assert r.parent_id is None
        else:
            p = by_id[r.parent_id]
            assert p.name == f"s{level - 1}" and p.thread == r.thread
            assert p.t0 <= r.t0 <= r.t1 <= p.t1 and r.trace_id == p.trace_id


def test_spans_keep_the_epoch_start():
    t = tracing.Tracer()
    before = time.time()
    with t.start_span("s"):
        pass
    (span,) = t.recent()
    assert before - 0.5 <= span["start"] <= time.time() + 0.5


def _engine():
    rng = np.random.default_rng(61)
    words = [f"w{i}" for i in range(200)]
    texts = [" ".join(rng.choice(words, rng.integers(4, 12))) for _ in range(300)]
    cfg = EncoderConfig(vocab_size=257, hidden_dim=32, num_layers=1, num_heads=4, mlp_dim=64,
                        max_len=64, dtype=torch.float32)
    enc = EncoderService(cfg, batch_size=4, max_len=32, device="cpu")
    eng = CollectionEngine(tindex.IndexSpec(dim=enc.dim, vocab_size=1 << 12, min_capacity=256),
                           embedder=enc, device="cpu")
    eng.ingest(texts)
    eng.index.compact_lexical()
    return eng, [" ".join(t.split()[:3]) for t in texts[:21]]


def test_a_served_dispatch_records_its_tree(monkeypatch):
    """``QueryBatcher`` over a CPU ``CollectionEngine``: one trace a
    dispatch rooted at ``batcher.dispatch`` on the worker thread, every
    stage of the hybrid path under its parent, and the dispatch's
    ``queries`` and ``wait_sum_s`` from the requests' enqueue stamps."""
    eng, queries = _engine()
    stamps = iter(float(i) for i in range(1, 1000))
    monkeypatch.setattr(batcher_mod, "time", types.SimpleNamespace(perf_counter=lambda: next(stamps)))
    tracer = tracing.get_tracer()
    batcher = QueryBatcher(max_batch=8)

    async def many():
        return await asyncio.gather(*(batcher.search(eng, q, top_k=5) for q in queries))

    t_start = time.perf_counter()
    tracer.enable()
    try:
        got = asyncio.run(many())
    finally:
        tracer.enable(False)
        batcher.close()
    assert all(got)
    recs = [r for r in tracer.stages(t_start) if r.name != "runtime.gc"]
    roots = sorted((r for r in recs if r.name == "batcher.dispatch"), key=lambda r: r.t0)
    assert roots and all(r.parent_id is None and r.trace_id == r.span_id for r in roots)
    assert len({r.thread for r in roots}) == 1 and roots[0].thread != threading.get_ident()
    attrs = [dict(r.attrs) for r in roots]
    assert sum(a["queries"] for a in attrs) == len(queries) == batcher.queries
    # FIFO: the dispatches take the requests' stamps 1, 2, ... in turn
    first = 1
    for r, a in zip(roots, attrs):
        n = a["queries"]
        want = sum(r.t0 - s for s in range(first, first + n))
        assert a["wait_sum_s"] == pytest.approx(want, rel=1e-12)
        first += n
    by_id = {r.span_id: r for r in recs}
    for root in roots:
        tree = [r for r in recs if r.trace_id == root.span_id and r is not root]
        names = [r.name for r in tree]
        assert set(names) == set(TREE)
        assert names.count("embed.tokenize") == names.count("embed.forward") >= 1
        for r in tree:
            parent = by_id[r.parent_id]
            assert parent.name == TREE[r.name] and r.thread == root.thread
            assert parent.t0 <= r.t0 <= r.t1 <= parent.t1
            assert r.device is None and r.attrs == ()
