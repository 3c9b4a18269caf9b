"""The yardstick's arithmetic on hand-worked cases: bounds, operation and
byte counts, percentiles over every request, and the readers' sums."""

import math

import pytest
from conftest import ROOT  # noqa: F401 (puts the repository on the path)

from benchmark import arith, registry, trace
from benchmark.readers import Run, kernel_roofline, window_work_s
from benchmark.trace import Dispatch, DeviceTrace


def test_bound_takes_the_larger_time():
    assert arith.bound_s(3.35e12, 0.0, 1e12) == (1.0, "bytes")
    assert arith.bound_s(0.0, 1979e12, arith.PEAK_OPS_PER_S["int8"]) == (1.0, "operations")


def test_dense_topk_work_by_hand():
    # B 2, N 10, D 4, 1 tile, kt 3, int8 rows and queries:
    # ops 2*2*10*4 = 160; bytes 40 rows + 10 mask + 40 scales + 8 queries
    # + 8 query scales + 1*2*3*8 lists = 154
    assert arith.dense_topk_work(2, 10, 4, 1, 3, "int8", "int8") == (160.0, 154)
    # bf16 rows and queries: 80 rows + 10 mask + 16 queries + 48 lists
    assert arith.dense_topk_work(2, 10, 4, 1, 3, "bfloat16", "bfloat16") == (160.0, 154)


def test_encoder_flops_by_hand():
    # h 2, m 4, one layer, one row of 3 tokens:
    # 2*3*(4*4 + 2*2*4) + 4*9*2 = 192 + 72 = 264; the pooler adds 2*(4 + 2)
    assert arith.encoder_flops([3], 2, 4, 1) == 264.0
    assert arith.encoder_flops([3], 2, 4, 1, pooler=True) == 276.0
    assert arith.encoder_flops([3, 3], 2, 4, 2) == 4 * 264.0


def test_percentile_is_over_every_request():
    vals = list(range(1, 101))
    assert arith.percentile(vals, 50) == 50
    assert arith.percentile(vals, 95) == 95
    assert arith.percentile([5.0, math.inf], 50) == 5.0
    assert arith.percentile([5.0, math.inf], 95) == math.inf
    with pytest.raises(ValueError):
        arith.percentile([], 50)


def _run(**kw):
    base = dict(cell="x", config={}, traffic={}, queries=[], requests=[], window=(10.0, 20.0),
                setup_s=3.0, counters={"dispatches": [4, 14], "queries": [100, 600]})
    base.update(kw)
    return Run(**base)


def _read(name, run):
    return registry.metric_reader(name)(run)


def test_end_to_end_readers_by_hand():
    reqs = [(0, "q", 9.0, 10.5),  # sent before the window: not in the latency set
            (0, "q", 10.0, 10.1), (1, "q", 11.0, 11.3), (2, "q", 19.0, 20.5),
            (3, "q", 19.5, None)]  # never answered
    d1 = Dispatch(8.0, 12.0, 4)  # half inside the window: 2 queries
    d2 = Dispatch(13.0, 14.0, 2)  # inside: 2
    d3 = Dispatch(19.0, 23.0, 8)  # a quarter inside: 2
    run = _run(requests=reqs, dispatches=[d1, d2, d3], gc_pauses=[[9.0, 2.0], [15.0, 0.5]])
    assert _read("qps", run) == pytest.approx(6 / 10.0)
    assert _read("gc_pause_share", run) == pytest.approx(100 * 1.5 / 10.0)
    assert _read("latency_p50_ms", run) == pytest.approx(300.0)
    assert _read("latency_p95_ms", run) == math.inf
    assert _read("setup_s", run) == 3.0
    assert _read("batch_size_mean", run) == 50.0


def test_span_readers_by_hand():
    spans = [("search_batch", 11.0, 11.1), ("embed", 11.0, 11.03), ("search_hybrid", 11.03, 11.08),
             ("search_batch", 12.0, 12.2), ("embed", 12.0, 12.05),
             ("search_hybrid", 12.05, 12.1), ("rerank", 12.1, 12.19),
             ("search_batch", 25.0, 26.0)]  # after the window
    run = _run(spans=spans)
    assert _read("embed_ms", run) == pytest.approx(40.0)
    assert _read("search_hybrid_ms", run) == pytest.approx(50.0)
    assert _read("rerank_ms", run) == pytest.approx(90.0)
    assert _read("engine_self_ms", run) == pytest.approx((20.0 + 10.0) / 2)


def test_device_readers_by_hand():
    kernels = [("void dense_topk_tc_kernel<2>(x)", 11.0, 11.004),
               ("void dense_topk_tc_kernel<2>(x)", 12.0, 12.004),
               ("gemm", 11.002, 11.006), ("void dense_topk_tcs_kernel<0, 64, false>(y)", 13.0, 13.002)]
    # one launch of B 512 over 1e7 int8 rows at D 384, tile 2048, kt 2
    launch = (11.0, 512, 384, 10_000_000, 2048, 2, "torch.int8", "torch.int8")
    run = _run(device=DeviceTrace(kernels, (10.0, 20.0)), launches=[launch, launch])
    busy = 0.006 + 0.004 + 0.002
    assert _read("device_idle", run) == pytest.approx(100 * (1 - busy / 10.0))
    ops, nbytes = arith.dense_topk_work(512, 10_000_000, 384, 4883, 2, "int8", "int8")
    bound = max(ops / arith.PEAK_OPS_PER_S["int8"], nbytes / arith.HBM_BYTES_PER_S)
    assert kernel_roofline(run, "dense_topk_tc_kernel") == pytest.approx(100 * bound / 0.004)
    assert _read("dense_topk_tc_roofline", run) == pytest.approx(100 * bound / 0.004)
    assert _read("device_idle", _run()) is None


def test_mfu_counts_the_work_of_the_window():
    cfg = {"rows": 1000, "dim": 8, "storage_dtype": "int8",
           "encoder": {"model": {"hidden_size": 2, "intermediate_size": 4, "num_hidden_layers": 1,
                                 "vocab_size": 100}, "max_len": 64, "activations": "bfloat16"}}
    d = Dispatch(12.0, 12.5, 1, queries=["a"], pairs=[])  # [CLS] a [SEP]: 3 tokens
    late = Dispatch(30.0, 30.5, 1, queries=["a b"], pairs=[])
    run = _run(config=cfg, dispatches=[d, late])
    want = 264.0 / 989e12 + 2.0 * 1000 * 8 / 1979e12
    assert window_work_s(run) == pytest.approx(want)
    assert _read("mfu", run) == pytest.approx(100 * want / 10.0)


def test_idle_gaps_by_host_activity():
    busy = trace.busy_intervals([("a", 1.0, 2.0), ("b", 1.5, 3.0), ("c", 5.0, 6.0)])
    assert busy == [(1.0, 3.0), (5.0, 6.0)]
    gaps = trace.idle_gaps(busy, (0.0, 8.0))
    assert gaps == [(0.0, 1.0), (3.0, 5.0), (6.0, 8.0)]
    segs = trace.host_segments([("search_batch", 0.5, 7.0), ("embed", 0.5, 2.0),
                                ("search_hybrid", 4.0, 6.5)])
    assert segs == [(0.5, 2.0, "embed"), (2.0, 4.0, "engine"), (4.0, 6.5, "search_hybrid"),
                    (6.5, 7.0, "engine")]
    idle = trace.idle_by_activity(gaps, segs)
    assert idle == pytest.approx({"embed": 0.5, "between dispatches": 1.5, "engine": 1.5,
                                  "search_hybrid": 1.5})
