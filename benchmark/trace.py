"""What the benchmark records around the calls into the program: each
dispatch's times and size (always), the answers the output check judges
(a sample, ``Picker``), spans of the layers, the queries and reranker
pairs that ``mfu`` counts, and the dense kernel's launch shapes (with
``--trace 1``), and the device's kernels from ``torch.profiler`` (with
``--trace 1``).

The wrappers sit on the engine's instance (``search_batch``, ``_embed``,
``_maybe_rerank``, ``reranker``, ``index.search_hybrid``) and on two
module attributes of the port (``ops.hybrid._rrf_on_device``, whose
arguments are the dense and lexical candidate lists, and
``ops.dense_topk.tile_topk``).  A span that stops a device layer's clock
first synchronizes the device.  ``uninstall`` puts every attribute back.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from benchmark import check, data


class Picker:
    """A sample of ``count`` items drawn from the seed as they are offered
    (a reservoir), the item of the largest key always in it.  An item is
    made (``make()``) only where it is kept."""

    def __init__(self, count: int, seed: int):
        self.count = count
        self.rng = random.Random(int(data.generator(seed, "queries", 2, "cpu").initial_seed()))
        self.seen = 0
        self.kept: list = []
        self.top: Optional[tuple] = None  # (key, item)

    def offer(self, key, make: Callable):
        n, self.seen = self.seen, self.seen + 1
        slot = n if n < self.count else self.rng.randrange(n + 1)
        top = self.top is None or key > self.top[0]
        if slot >= self.count and not top:
            return None
        item = make()
        if slot < len(self.kept):
            self.kept[slot] = item
        elif slot < self.count:
            self.kept.append(item)
        if top:
            self.top = (key, item)
        return item

    def picked(self) -> list:
        """The kept items, the top one first."""
        if self.top is None:
            return []
        return [self.top[1]] + [e for e in self.kept if e is not self.top[1]][:self.count - 1]


@dataclass
class Dispatch:
    t0: float
    t1: float
    size: int
    queries: Optional[list] = None  # with --trace 1: the queries (mfu counts their tokens)
    pairs: Optional[list] = None  # with --trace 1: (query, texts) of each reranker call


@dataclass
class _Made:
    """What the window's current dispatch has made so far."""
    emb: Optional[torch.Tensor] = None  # [B_padded, D] query embeddings
    rrf: Optional[tuple] = None  # (dense scores, dense rows, lexical scores, lexical rows, out)
    candidates: Optional[list] = None  # hits handed to the reranker
    ce: list = field(default_factory=list)  # (query, texts, scores) of each reranker call


@dataclass
class Kept:
    """One sampled position: its query, its answer, and the timed path's
    outputs for it (on the device until the window has closed)."""
    query: str
    answer: list
    emb: Optional[torch.Tensor] = None
    lists: Optional[tuple] = None  # dense scores, rows, lexical scores, rows, fused rows, scores
    cands: Optional[list] = None
    ce: Optional[object] = None
    delivered: bool = False


def _rows_scores(hits) -> tuple:
    return (np.array([h.row for h in hits], np.int64),
            np.array([h.score for h in hits], np.float64))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().double().cpu().numpy()


class Recorder:
    """Records the dispatches; from ``open(t)`` on it offers each position
    of a dispatch that starts at ``t`` or later to ``picker``, and keeps
    what the output check needs of the positions kept."""

    def __init__(self, engine, trace: bool, device: str, picker: Picker):
        self.engine = engine
        self.trace = trace
        self.picker = picker
        self.cuda = torch.device(device).type == "cuda"
        self.opened: Optional[float] = None
        self.dispatches: list[Dispatch] = []
        self.spans: list[tuple[str, float, float]] = []
        self.launches: list[tuple] = []  # (host time, b, d, n, tile, kt, q dtype, row dtype)
        self._by_answer: dict = {}  # id(answer) -> the Kept positions that served it
        self._cur: Optional[_Made] = None
        self._undo: list = []
        self._install()

    def open(self, t: float) -> None:
        self.opened = t
        self.dispatches, self.spans, self.launches = [], [], []

    def delivered(self, query: str, answer) -> None:
        """A client that sent ``query`` received ``answer``."""
        for k in self._by_answer.get(id(answer), ()):
            k.delivered = k.delivered or k.query == query

    def samples(self) -> list:
        """The kept positions as the check's samples, on the host."""
        out = []
        for k in self.picker.picked():
            s = check.Sample(query=k.query, answer=_rows_scores(k.answer),
                             found=k.delivered and k.lists is not None and k.emb is not None)
            if s.found:
                dv, di, lv, li, fi, fv = (_np(t) for t in k.lists)
                s.emb = _np(k.emb)
                s.dense = (di.astype(np.int64), dv)
                s.lex = (li.astype(np.int64), lv)
                s.fused = (fi.astype(np.int64), fv)
                if k.cands is not None:
                    s.cands = _rows_scores(k.cands)
                    s.ce = None if k.ce is None else np.asarray(k.ce, np.float64)
            out.append(s)
        return out

    def _keep(self, p: int, q: str, made: _Made, out: list) -> Kept:
        k = Kept(query=q, answer=out[p])
        n = min(made.emb.shape[0], made.rrf[4].indices.shape[0]) \
            if made.emb is not None and made.rrf is not None else 0
        if p < n:  # the dispatch made outputs for this position
            dv, di, lv, li, fo = made.rrf
            k.emb = made.emb[p].clone()
            k.lists = tuple(t[p].clone() for t in (dv, di, lv, li, fo.indices, fo.scores))
        if made.candidates is not None and p < len(made.candidates):
            k.cands = made.candidates[p]
            k.ce = next((sc for cq, _, sc in made.ce if cq == q), None)
        self._by_answer.setdefault(id(out[p]), []).append(k)
        return k

    def _sync(self) -> None:
        if self.trace and self.cuda:
            torch.cuda.synchronize()

    def _span(self, name: str, t0: float) -> None:
        if self.trace:
            self._sync()
            self.spans.append((name, t0, time.perf_counter()))

    def _set(self, obj, name: str, value) -> None:
        had = name in vars(obj)
        old = vars(obj).get(name)
        self._undo.append((obj, name, had, old))
        setattr(obj, name, value)

    def uninstall(self) -> None:
        for obj, name, had, old in reversed(self._undo):
            if had:
                setattr(obj, name, old)
            else:
                delattr(obj, name)
        self._undo = []

    def _install(self) -> None:
        import super_rag_tpu_torch.ops.dense_topk as dt
        import super_rag_tpu_torch.ops.hybrid as hy

        eng, idx = self.engine, self.engine.index
        search_batch, embed = eng.search_batch, eng._embed
        maybe_rerank, search_hybrid = eng._maybe_rerank, idx.search_hybrid
        rrf, tile_topk, reranker = hy._rrf_on_device, dt.tile_topk, eng.reranker

        def rec_search_batch(queries, **params):
            made = self._cur = _Made()
            t0 = time.perf_counter()
            out = search_batch(queries, **params)
            self._span("search_batch", t0)
            d = Dispatch(t0, time.perf_counter(), len(queries))
            if self.trace:
                d.queries = list(queries)
                d.pairs = [(q, t) for q, t, _ in made.ce]
            self.dispatches.append(d)
            if self.opened is not None and t0 >= self.opened:
                for p, q in enumerate(queries):
                    self.picker.offer(len(q.split()), lambda p=p, q=q: self._keep(p, q, made, out))
            self._cur = None
            return out

        def rec_embed(texts):
            t0 = time.perf_counter()
            e = embed(texts)
            self._span("embed", t0)
            self._cur.emb = e
            return e

        def rec_search_hybrid(query_emb, *args, **kwargs):
            t0 = time.perf_counter()
            out = search_hybrid(query_emb, *args, **kwargs)
            self._span("search_hybrid", t0)
            return out

        def rec_rrf(dv, di, lv, li, k, rrf_k):
            out = rrf(dv, di, lv, li, k, rrf_k)
            self._cur.rrf = (dv, di, lv, li, out)
            return out

        def rec_maybe_rerank(queries, results, rerank, top_k):
            if rerank:
                self._cur.candidates = results
            t0 = time.perf_counter()
            out = maybe_rerank(queries, results, rerank, top_k)
            if rerank:
                self._span("rerank", t0)
            return out

        def rec_reranker(query, texts):
            scores = reranker(query, texts)
            self._cur.ce.append((query, texts, scores))
            return scores

        def rec_tile_topk(q, qscale, values, scales, norms, mask, n, tile, kt):
            if self.trace:
                self.launches.append((time.perf_counter(), q.shape[0], q.shape[1], n, tile,
                                      kt, str(q.dtype), str(values.dtype)))
            return tile_topk(q, qscale, values, scales, norms, mask, n, tile, kt)

        self._set(eng, "search_batch", rec_search_batch)
        self._set(eng, "_embed", rec_embed)
        self._set(eng, "_maybe_rerank", rec_maybe_rerank)
        self._set(idx, "search_hybrid", rec_search_hybrid)
        if reranker is not None:
            self._set(eng, "reranker", rec_reranker)
        self._set(hy, "_rrf_on_device", rec_rrf)
        self._set(dt, "tile_topk", rec_tile_topk)


# -- the device's kernels -----------------------------------------------------

@dataclass
class DeviceTrace:
    kernels: list  # (name, start s, end s) on the host clock, inside the window
    window: tuple  # (start, end) on the host clock


class Profiler:
    """``torch.profiler`` over the device's kernels.  Its clock is tied to
    the host's by a marker kernel launched right after a synchronize,
    before any other work of the traced stretch."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        self.t_mark = time.perf_counter()
        torch.cuda._sleep(20000)
        torch.cuda.synchronize()

    def stop(self, window: tuple) -> DeviceTrace:
        """The device's operations in ``window`` (host seconds), read from
        the profiler's raw events (``(name, start ns, end ns)``)."""
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        self.prof.stop()
        try:
            events = [(e.name(), e.start_ns(), e.end_ns())
                      for e in self.prof.profiler.kineto_results.events()
                      if e.device_type() == DeviceType.CUDA]
        except AttributeError:  # a torch without the raw events' accessors
            events = [(e.name, int(e.time_range.start * 1e3), int(e.time_range.end * 1e3))
                      for e in self.prof.events() if e.device_type == DeviceType.CUDA]
        if not events:
            return DeviceTrace([], window)
        marks = [e for e in events if "sleep" in e[0] or "spin" in e[0]]
        first = min(marks or events, key=lambda e: e[1])

        def host(ns: int) -> float:
            return self.t_mark + (ns - first[1]) / 1e9

        ws, we = window
        kernels = []
        for e in events:
            s, t = host(e[1]), host(e[2])
            if t > ws and s < we and e is not first:
                kernels.append((e[0], max(s, ws), min(t, we)))
        return DeviceTrace(kernels, window)


def busy_intervals(kernels: list) -> list[tuple[float, float]]:
    """The union of the kernels' intervals, merged and ordered."""
    merged: list[list[float]] = []
    for _, s, t in sorted(kernels, key=lambda k: k[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return [(s, t) for s, t in merged]


def idle_gaps(busy: list, window: tuple) -> list[tuple[float, float]]:
    gaps, at = [], window[0]
    for s, t in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, t)
    if at < window[1]:
        gaps.append((at, window[1]))
    return gaps


def host_segments(spans: list) -> list[tuple[float, float, str]]:
    """The host's activity as ordered, disjoint segments: each layer's
    span, and the part of a ``search_batch`` span that its layers leave
    (the engine's own work: padding, hits, copies)."""
    children = sorted((s, e, n) for n, s, e in spans if n != "search_batch")
    segs = list(children)
    for n, s, e in spans:
        if n != "search_batch":
            continue
        at = s
        for cs, ce, _ in children:
            if ce <= s or cs >= e:
                continue
            if cs > at:
                segs.append((at, cs, "engine"))
            at = max(at, ce)
        if at < e:
            segs.append((at, e, "engine"))
    return sorted(segs)


def idle_by_activity(gaps: list, segments: list) -> dict:
    """Idle seconds by what the host was doing: each gap's overlap with
    each segment, the rest "between dispatches" (the batcher's queue and
    the clients)."""
    out: dict = {}
    j = 0
    for gs, ge in gaps:
        covered = 0.0
        while j < len(segments) and segments[j][1] <= gs:
            j += 1
        k = j
        while k < len(segments) and segments[k][0] < ge:
            s, e, name = segments[k]
            ov = min(e, ge) - max(s, gs)
            if ov > 0:
                out[name] = out.get(name, 0.0) + ov
                covered += ov
            k += 1
        out["between dispatches"] = out.get("between dispatches", 0.0) + (ge - gs - covered)
    return out
