"""What the metric readers (``metrics/<name>.py``) share: the run they
read, and the sums over its window."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from benchmark import arith, trace
from benchmark.reference import text


@dataclass
class Run:
    """Everything a reader may read.  ``requests`` holds ``(client, query,
    sent, answered or None)``; times are the host's
    ``perf_counter`` seconds."""
    cell: str
    config: dict
    traffic: dict
    queries: list
    requests: list
    window: tuple
    setup_s: float
    counters: dict  # batcher counters at the window's open and close
    dispatches: list = field(default_factory=list)  # trace.Dispatch records
    spans: list = field(default_factory=list)
    launches: list = field(default_factory=list)
    device: Optional[trace.DeviceTrace] = None
    gc_pauses: list = field(default_factory=list)  # [start, seconds] of each full collection

    @property
    def seconds(self) -> float:
        return self.window[1] - self.window[0]


def sent_in_window(run: Run) -> list:
    ws, we = run.window
    return [r for r in run.requests if ws <= r[2] < we]


def latencies_ms(run: Run) -> list[float]:
    """Every request sent in the window, send to answer (inf: none came)."""
    return [(r[3] - r[2]) * 1e3 if r[3] is not None else math.inf
            for r in sent_in_window(run)]


def dispatch_spans(run: Run) -> list[dict]:
    """Per dispatch whose ``search_batch`` span starts in the window, the
    seconds of each layer span inside it."""
    ws, we = run.window
    out = []
    spans = sorted(run.spans, key=lambda s: s[1])
    for name, s, e in spans:
        if name == "search_batch" and ws <= s < we:
            out.append({"search_batch": e - s, "_range": (s, e)})
    j = 0
    for d in out:
        s0, e0 = d["_range"]
        while j < len(spans) and spans[j][1] < s0:
            j += 1
        k = j
        while k < len(spans) and spans[k][1] < e0:
            name, s, e = spans[k]
            if name != "search_batch":
                d[name] = d.get(name, 0.0) + (e - s)
            k += 1
    return out


def mean_span_ms(run: Run, name: str) -> Optional[float]:
    per = [d[name] for d in dispatch_spans(run) if name in d]
    return 1e3 * sum(per) / len(per) if per else None


def busy_s(run: Run) -> Optional[float]:
    if run.device is None or not run.device.kernels:
        return None
    return sum(t - s for s, t in trace.busy_intervals(run.device.kernels))


def kernel_roofline(run: Run, kernel: str) -> Optional[float]:
    """The kernel's share of its roofline in the window, %: the least time
    of its launches (from their shapes) over its device time."""
    if run.device is None:
        return None
    times = [t - s for name, s, t in run.device.kernels
             if kernel + "<" in name or kernel + "(" in name]
    ws, we = run.window
    shapes = [ln for ln in run.launches if ws <= ln[0] < we]
    if not times or not shapes:
        return None
    bounds = []
    for _, b, d, n, tile, kt, qd, vd in shapes:
        storage, query = vd.removeprefix("torch."), qd.removeprefix("torch.")
        ops, nbytes = arith.dense_topk_work(b, n, d, -(-n // tile), kt, storage, query)
        bounds.append(arith.bound_s(nbytes, ops, arith.PEAK_OPS_PER_S[storage])[0])
    mean_bound = sum(bounds) / len(bounds)
    return 100.0 * mean_bound * len(times) / sum(times)


def window_work_s(run: Run) -> Optional[float]:
    """The least time at the published peaks of the model and scoring
    work of the dispatches that started in the window: the encoder's
    forwards over the queries' own tokens, the cross-encoder's over the
    pairs' tokens (bfloat16 peak), and the dense products, 2 N D a query
    at the storage type's peak."""
    ws, we = run.window
    cfg = run.config
    enc = cfg["encoder"]
    em = enc["model"]
    rr = cfg.get("reranker")
    storage = cfg["storage_dtype"]
    peak_act = arith.PEAK_OPS_PER_S[enc["activations"]]
    enc_lengths, pair_lengths, n_queries = [], [], 0
    for d in run.dispatches:
        if not ws <= d.t0 < we:
            continue
        n_queries += d.size
        enc_lengths += [text.text_length(q, enc["max_len"]) for q in d.queries]
        for q, texts in d.pairs:
            pair_lengths += [text.pair_length(q, t, rr["max_len"]) for t in texts]
    if not n_queries:
        return None
    t = arith.encoder_flops(enc_lengths, em["hidden_size"], em["intermediate_size"],
                            em["num_hidden_layers"]) / peak_act
    if pair_lengths:
        rm = rr["model"]
        t += arith.encoder_flops(pair_lengths, rm["hidden_size"], rm["intermediate_size"],
                                 rm["num_hidden_layers"], pooler=True) / peak_act
    t += 2.0 * cfg["rows"] * cfg["dim"] * n_queries / arith.PEAK_OPS_PER_S[storage]
    return t
