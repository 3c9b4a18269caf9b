"""One run of one cell: set-up, warm-up, the measured window under the
cell's traffic, the metrics, and the output check against the plain
reference.  ``run`` returns the result line's object and the check's
lines; ``run.py`` is the command that prints them.
"""

from __future__ import annotations

import asyncio
import gc
import sys
import time
from typing import Callable, Optional

import torch

from benchmark import arith, check, data, registry, system, trace
from benchmark.readers import Run

FORBIDDEN = ("jax", "jaxlib", "flax", "super_rag_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is the JAX
    stack's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _merge(base: dict, over: Optional[dict]) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


class _Hooks:
    """The load shape's view of the harness: the batcher's counters at the
    window's open and close, and each answer, which the recorder checks
    against the positions it keeps."""

    def __init__(self, batcher, rec: trace.Recorder):
        self.batcher = batcher
        self.rec = rec
        self.counters = {"dispatches": [0, 0], "queries": [0, 0]}

    def dispatches(self) -> int:
        return self.batcher.dispatches

    def _snap(self, i: int) -> None:
        self.counters["dispatches"][i] = self.batcher.dispatches
        self.counters["queries"][i] = self.batcher.queries

    def opened(self, t: float) -> None:
        self._snap(0)
        self.rec.open(t)

    def closed(self, t: float) -> None:
        self._snap(1)

    def answered(self, request: tuple, answer) -> None:
        self.rec.delivered(request[1], answer)


def _top(pairs: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(pairs.items(), key=lambda kv: -kv[1])[:n]]


def run(cell_name: str, seed: int, seconds: float, trace_on: bool, t_start: float,
        device: str = "cuda", bench_dir: str = registry.HERE, spec_path: str = "",
        overrides: Optional[dict] = None, log: Callable = print) -> tuple[dict, list]:
    from super_rag_tpu_torch.engine.batcher import QueryBatcher

    overrides = overrides or {}
    cell = registry.find_cell(cell_name, bench_dir, spec_path)
    cfg = _merge(cell.config, overrides.get("config"))
    traffic = _merge(cell.traffic, overrides.get("traffic"))
    limits = _merge(cell.limits, overrides.get("limits"))
    drive = registry.load_shape(traffic["kind"], bench_dir)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    t_build = time.perf_counter()
    sut = system.build(cfg, traffic, seed, device, log)
    t_built = time.perf_counter()
    engine = sut.engine
    params = {k: traffic[k] for k in ("mode", "top_k", "candidates", "rerank")}
    batcher = QueryBatcher(max_batch=traffic["max_batch"], max_wait_ms=traffic["max_wait_ms"])
    rec = trace.Recorder(engine, trace_on, device, trace.Picker(traffic["check_sample"], seed))
    hooks = _Hooks(batcher, rec)
    prof = None

    async def serve() -> dict:
        nonlocal prof
        # every batch the batcher can form pads to one of these sizes; the
        # rerank's shapes do not depend on the batch, so one call warms them
        b, plain = 1, dict(params, rerank=False)
        while True:
            qs = sut.queries[:min(b, traffic["max_batch"])]
            await batcher.run(lambda qs=qs: engine.search_batch(qs, **plain))
            if b >= traffic["max_batch"]:
                break
            b *= 2
        await batcher.run(lambda: engine.search_batch(sut.queries[:1], **params))
        marks["warm-up"] = time.perf_counter() - t_built
        if trace_on and cuda:
            prof = trace.Profiler()
        return await drive(lambda q: batcher.search(engine, q, **params), sut.queries,
                           traffic, seconds, hooks)

    marks: dict = {}
    pauses: list = []  # (start, seconds) of each full garbage collection

    def gc_clock(phase: str, info: dict) -> None:
        if info["generation"] == 2:
            if phase == "start":
                pauses.append([time.perf_counter(), 0.0])
            elif pauses:
                pauses[-1][1] = time.perf_counter() - pauses[-1][0]

    gc.callbacks.append(gc_clock)
    try:
        load = asyncio.run(serve())
    finally:
        batcher.close()
        gc.callbacks.remove(gc_clock)
    if cuda:
        torch.cuda.synchronize()
    window = load["window"]
    log(f"set-up (s): before the build {t_build - t_start:.3f}, build {t_built - t_build:.3f}, "
        f"warm-up {marks['warm-up']:.3f}, the load's ramp "
        f"{window[0] - t_built - marks['warm-up']:.3f}")
    t0 = time.perf_counter()
    device_trace = prof.stop(window) if prof is not None else None
    if prof is not None:
        log(f"device trace: {len(device_trace.kernels)} operations in the window, read in "
            f"{time.perf_counter() - t0:.1f} s")
    full = [p for p in pauses if window[0] <= p[0] < window[1]]
    log(f"full garbage collections in the window: {len(full)}, "
        f"{sum(p[1] for p in full):.3f} s, longest {max((p[1] for p in full), default=0):.3f} s")
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0

    r = Run(cell=cell.name, config=cfg, traffic=traffic, queries=sut.queries,
            requests=load["requests"], window=window, setup_s=window[0] - t_start,
            counters=hooks.counters, dispatches=rec.dispatches, spans=rec.spans,
            launches=rec.launches, device=device_trace, gc_pauses=pauses)
    wanted = cell.per_layer if trace_on else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = registry.metric_reader(m["name"], bench_dir)(r)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    sent = [q for q in load["requests"] if window[0] <= q[2] < window[1]]
    lat = sorted((q[3] - q[2]) * 1e3 for q in sent if q[3] is not None)
    if lat:
        log(f"latency of {len(lat)} answered requests (ms): mean {sum(lat) / len(lat):.1f}, "
            f"p99 {arith.percentile(lat, 99):.1f}, max {lat[-1]:.1f}")
    result = {"correct": False, "attempted": len(sent),
              "failed": sum(1 for q in sent if q[3] is None), "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                         "count": cell.chips, "memory_peak_bytes": int(memory_peak)}}
    if device_trace is not None:
        busy = trace.busy_intervals(device_trace.kernels)
        result["device"]["busy_s"] = sum(t - s for s, t in busy)
        result["device"]["window_s"] = window[1] - window[0]
        ops: dict = {}
        for name, s, t in device_trace.kernels:
            ops[name] = ops.get(name, 0.0) + (t - s)
        idle = trace.idle_by_activity(trace.idle_gaps(busy, window),
                                      trace.host_segments(rec.spans))
        result["breakdown"] = {"device_ops": _top(ops), "idle_gaps": _top(idle)}

    samples = rec.samples()
    # the program's state goes before the reference runs on the card
    rec.uninstall()
    del r, rec, hooks, batcher, engine, sut, load
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = check.judge(samples, cfg, traffic, seed, device)
    log(f"reference check of {len(samples)} answers: {time.perf_counter() - t0:.1f} s")
    result["correct"], lines, result["check"] = check.verdict(numbers, limits, result["failed"])
    return result, lines


def card_line() -> str:
    """The card's name and power limit beside the peaks the rooflines use."""
    import subprocess

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        smi = "nvidia-smi not readable"
    peaks = ", ".join(f"{k} {v / 1e12:g} T/s" for k, v in arith.PEAK_OPS_PER_S.items())
    return f"card: {smi}; published peaks: {peaks}, HBM {arith.HBM_BYTES_PER_S / 1e12:g} TB/s"
