#!/usr/bin/env python3
"""Smoke run of the PyTorch port (super_rag_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line with its seconds:
  1. device: the card's name and power limit (nvidia-smi), torch / CUDA;
  2. build: nvcc builds the kernels from super_rag_tpu_torch/csrc;
  3. kernel vs plain version at small shapes, every mode (int8 x int8 must
     match bit for bit, the float modes within a stated tolerance);
  4. full size: 1M x 768 int8 corpus + 64-slot zipfian BM25 table made on
     the card from a seed, DeviceIndex + compact_lexical, then
     search_hybrid at batch 512 (kernel held against its plain version,
     the hybrid result against the same path on the plain version, the
     dense top-10 against an exact f32 search: recall >= 0.9), and
     timings of the kernel, the plain version, a library yardstick, the
     whole search_hybrid batch and its stages;
  5. serving: >= 256 concurrent text requests through QueryBatcher over
     a CollectionEngine on that index, each checked against a direct
     search_batch of the same query;
  6. a ``{"kernels": [...]}`` JSON line;
  7. last line: ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero.  There is no CPU path: without a
CUDA device, or without the package beside it, it exits non-zero and
prints no result.  Nothing is written under the repo except the kernel
library in super_rag_tpu_torch/_build/.
"""

from __future__ import annotations

import asyncio
import json
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# full-size configuration: the repo's north-star single-card setup
N_ROWS = 1_000_000
DIM = 768
SLOTS = 64
VOCAB = 1 << 17
BATCH = 512
CANDIDATES = 100
TOP_K = 10
QUERY_TERMS = 6
SERVE_REQUESTS = 256
SEED = 0
TIMED_REPS = 20
DEVICE = "cuda"

# H100 SXM published peaks (dense): HBM bytes/s and int8 operations/s
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = TIMED_REPS, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, each between two
    CUDA events on the current stream, after ``warmup`` runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int = TIMED_REPS, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` + a device synchronize, on the host
    clock (end to end: host work and device work together)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float, ops_per_s: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 3: kernel vs plain version at small shapes ------------------------

def _tolerance(d: int, ref: torch.Tensor) -> float:
    """Float modes: both sides take exact products and sum D of them in f32
    in different orders, so they may differ by up to ~D ulps of the
    largest score."""
    finite = ref[torch.isfinite(ref)]
    scale = float(finite.abs().max()) if finite.numel() else 1.0
    return d * 2.0 ** -23 * (scale + 1.0)


def _compare(got_v, got_i, ref_v, ref_i, exact: bool, tol: float,
             scores=None) -> float:
    """Raise unless kernel and plain outputs agree; returns max |diff| over
    finite values.  Ids are compared where values are finite; in the
    float modes an id may differ only at a near-tie: the slot's plain
    value lies within ``tol`` of a neighbour's, or the id got scores
    (``scores``, the plain [B, N] scores) within ``tol`` of it."""
    fin = torch.isfinite(ref_v)
    if not torch.equal(fin, torch.isfinite(got_v)):
        raise AssertionError("kernel and plain version disagree on -inf slots")
    diff = (got_v - ref_v).abs()[fin]
    err = float(diff.max()) if diff.numel() else 0.0
    if exact:
        if not (torch.equal(got_v, ref_v) and torch.equal(got_i[fin], ref_i[fin])):
            raise AssertionError(f"int8 x int8 mismatch (max |diff| {err})")
        return err
    if err > tol:
        raise AssertionError(f"values differ by {err} > tolerance {tol}")
    bad = fin & (got_i != ref_i)
    if bad.any():
        prev = torch.nn.functional.pad((ref_v[..., 1:] - ref_v[..., :-1]).abs(),
                                       (1, 0), value=float("inf"))
        nxt = torch.nn.functional.pad((ref_v[..., 1:] - ref_v[..., :-1]).abs(),
                                      (0, 1), value=float("inf"))
        near_tie = torch.minimum(prev, nxt) <= tol
        if scores is not None:
            got_s = torch.gather(scores.expand(got_i.shape[0], -1, -1), -1,
                                 torch.where(fin, got_i, 0).long())
            near_tie |= (got_s - ref_v).abs() <= tol
        if (bad & ~near_tie).any():
            raise AssertionError("ids differ away from any near-tie")
    return err


def phase_small() -> int:
    from super_rag_tpu_torch.ops import dense_topk as dt
    from super_rag_tpu_torch.ops.dense import Metric, build_corpus

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    b, n, d, k = 20, 5000, 96, 10  # ragged: B % 16, N % tile, D % 256
    modes = [("int8 x int8", torch.int8, True), ("int8 + bf16 q", torch.int8, False),
             ("bf16", torch.bfloat16, False), ("f32", torch.float32, False)]
    cases = 0
    for metric in (Metric.COSINE, Metric.DOT, Metric.L2):
        x = torch.randn(n, d, device=DEVICE, generator=gen)
        queries = torch.randn(b, d, device=DEVICE, generator=gen)
        keep = torch.rand(n, device=DEVICE, generator=gen) < 0.6
        for name, dtype, i8q in modes:
            corpus = build_corpus(x, metric=metric, dtype=dtype)
            for tile in (200, 1024, 2048):
                for mask in (None, keep):
                    for ptk in (None, 2):
                        q, qs, kt, _ = dt.prepare(queries, corpus, k, metric, tile,
                                                  i8q, ptk)
                        norms = corpus.norms_sq if metric == Metric.L2 else None
                        args = (q, qs, corpus.values, corpus.scales, norms, mask, n,
                                tile, kt)
                        got = dt.tile_topk(*args)
                        ref = dt.tile_topk_plain(*args)
                        torch.cuda.synchronize()
                        _compare(*got, *ref, exact=i8q,
                                 tol=_tolerance(d, ref[0]),
                                 scores=dt.plain_scores(*args[:6], 0, n))
                        cases += 1
    return cases


# -- phase 4: the full-size corpus, made on the card --------------------------

def _zipf(gen, a: float, shape) -> torch.Tensor:
    """Inverse-CDF power-law draw, P(X = k) ~ k^-a, X >= 1 (the recipe of
    the repo's benchmark corpus, drawn on the card)."""
    u = torch.rand(shape, device=DEVICE, generator=gen).to(torch.float64)
    u = torch.clamp(u, min=1e-9)
    x = torch.exp(torch.log(u) * (-1.0 / (a - 1.0)))
    x = torch.clamp(x, max=2.0 ** 62)
    return torch.clamp(x.to(torch.int64), min=1)


def make_corpus(n: int, gen: torch.Generator):
    """Codes, scales and a zipfian doc-term table on the card, plus the
    host state a DeviceIndex snapshot carries.  Term buckets are the
    analyzer's hashes of the words ``t<rank>``, so text queries made of
    those words hit the same buckets."""
    from super_rag_tpu_torch.ops.dense import build_corpus
    from super_rag_tpu_torch.tokenize.analyzer import fnv1a32

    codes = torch.empty((n, DIM), dtype=torch.int8, device=DEVICE)
    scales = torch.empty((n,), dtype=torch.float32, device=DEVICE)
    step = 131072
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        x = torch.randn(hi - lo, DIM, device=DEVICE, generator=gen)
        c = build_corpus(x, dtype=torch.int8)
        codes[lo:hi], scales[lo:hi] = c.values, c.scales

    bucket_of_rank = torch.tensor([fnv1a32(f"t{r}") & (VOCAB - 1)
                                   for r in range(VOCAB)],
                                  dtype=torch.int32, device=DEVICE)
    ranks = (_zipf(gen, 1.3, (n, SLOTS)) - 1) % VOCAB
    terms = bucket_of_rank[ranks]
    tfs = torch.clamp(_zipf(gen, 2.0, (n, SLOTS)), max=8).to(torch.float32)
    pad = torch.rand((n, SLOTS), device=DEVICE, generator=gen) < 0.2
    terms[pad] = VOCAB
    tfs[pad] = 0.0
    ranks[pad] = -1
    doc_len = tfs.sum(1) * 2.0 + 1.0

    sorted_terms = torch.sort(terms, dim=1).values
    first = torch.ones_like(sorted_terms, dtype=torch.bool)
    first[:, 1:] = sorted_terms[:, 1:] != sorted_terms[:, :-1]
    uniq = sorted_terms[first]
    df = torch.bincount(uniq[uniq < VOCAB].long(), minlength=VOCAB)
    df_host = df.cpu().numpy()
    arrays = {
        "emb": codes, "scales": scales, "terms": terms, "tfs": tfs,
        "doc_len": doc_len,
        "valid": torch.ones(n, dtype=torch.bool, device=DEVICE),
        "indexer_code": torch.zeros(n, dtype=torch.int32, device=DEVICE),
        "chat_code": torch.zeros(n, dtype=torch.int32, device=DEVICE),
    }
    host = {
        "spec": {"dim": DIM, "metric": "cosine", "dtype": "int8",
                 "bm25_slots": SLOTS, "vocab_size": VOCAB,
                 "min_capacity": 4096},
        "size": n,
        "row_meta": [{"text": f"chunk {r}"} for r in range(n)],
        "df": {"df": {int(t): int(df_host[t]) for t in np.flatnonzero(df_host)},
               "num_docs": n,
               "total_len": float(doc_len.to(torch.float64).sum())},
    }
    return arrays, host, ranks, df_host


def make_query_texts(ranks, df_host, gen, count: int) -> list[str]:
    """Queries of up to QUERY_TERMS discriminative words from random rows
    (df <= max(64, N/50), as the repo's benchmark picks them)."""
    n = ranks.shape[0]
    rows = torch.randint(0, n, (count,), device=DEVICE, generator=gen)
    row_ranks = ranks[rows].cpu().numpy()
    df_cap = max(64, n // 50)
    from super_rag_tpu_torch.tokenize.analyzer import fnv1a32

    texts = []
    for rr in row_ranks:
        words, seen = [], set()
        for r in rr.tolist():
            if r < 0:
                continue
            bucket = fnv1a32(f"t{r}") & (VOCAB - 1)
            if bucket in seen or df_host[bucket] > df_cap:
                continue
            seen.add(bucket)
            words.append(f"t{r}")
            if len(words) == QUERY_TERMS:
                break
        texts.append(" ".join(words))
    return texts


def library_topk(q_i8, q_scale, codes, scales, mask, n, tile, kt):
    """Yardstick only, never used by the port: torch._int_mm (cuBLASLt
    int8 GEMM) + the same epilogue + torch.topk per tile, in chunks."""
    b = q_i8.shape[0]
    num_tiles = -(-n // tile)
    out_v = torch.empty((num_tiles, b, kt), dtype=torch.float32, device=DEVICE)
    tiles_per_chunk = 32
    for t0 in range(0, num_tiles, tiles_per_chunk):
        t1 = min(num_tiles, t0 + tiles_per_chunk)
        r0, r1 = t0 * tile, min(n, t1 * tile)
        s = torch._int_mm(q_i8, codes[r0:r1].t()).to(torch.float32)
        s = s * q_scale[:, None] * scales[None, r0:r1]
        s = torch.where(mask[None, r0:r1], s, float("-inf"))
        s = torch.nn.functional.pad(s, (0, (t1 - t0) * tile - (r1 - r0)),
                                    value=float("-inf"))
        out_v[t0:t1] = torch.topk(s.view(b, t1 - t0, tile), kt, dim=-1).values.transpose(0, 1)
    return out_v


def phase_full(results: dict):
    from super_rag_tpu_torch.engine.index import DeviceIndex
    from super_rag_tpu_torch.models.hash_embedder import HashEmbedder
    from super_rag_tpu_torch.ops import dense_topk as dt
    from super_rag_tpu_torch.ops.dense import normalize_queries

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    t0 = time.perf_counter()
    arrays, host, ranks, df_host = make_corpus(N_ROWS, gen)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx = DeviceIndex.from_snapshot(arrays, host, device=DEVICE)
    del arrays
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.compact_lexical(postings_per_term=max(256, N_ROWS // 500))
    torch.cuda.synchronize()
    t_compact = time.perf_counter() - t0
    log(f"[full] corpus {N_ROWS} x {DIM} int8 + {SLOTS}-slot table made on the "
        f"card in {t_gen:.2f} s; DeviceIndex in {t_load:.2f} s (capacity "
        f"{idx._capacity}); compact_lexical (torch build + per_tile_k "
        f"calibration -> {idx._per_tile_k}) in {t_compact:.2f} s")

    q_emb = torch.randn(BATCH, DIM, device=DEVICE, generator=gen)
    texts = make_query_texts(ranks, df_host, gen, BATCH)
    del ranks

    # the main path, counted
    dt.launches.count = 0
    t0 = time.perf_counter()
    res = idx.search_hybrid(q_emb, texts, k=TOP_K, candidates=CANDIDATES)
    torch.cuda.synchronize()
    launches = dt.launches.count
    log(f"[full] search_hybrid batch {BATCH}: first call {time.perf_counter() - t0:.3f} s, "
        f"dense_topk launches {launches}")
    if launches < 1:
        raise AssertionError("search_hybrid did not launch the dense_topk kernel")
    ids = res.indices.cpu().numpy()
    if ids.shape != (BATCH, TOP_K) or not np.isfinite(res.scores.cpu().numpy()).all():
        raise AssertionError("hybrid result has the wrong shape or non-finite scores")
    if len(set(ids[0].tolist())) != TOP_K or ids.min() < 0:
        raise AssertionError("hybrid result rows are not TOP_K distinct rows")

    # the whole hybrid batch against the same path on the plain version
    with mock.patch.object(dt, "tile_topk", dt.tile_topk_plain):
        res_plain = idx.search_hybrid(q_emb, texts, k=TOP_K, candidates=CANDIDATES)
    if not (torch.equal(res.indices, res_plain.indices)
            and torch.equal(res.scores, res_plain.scores)):
        raise AssertionError("hybrid result differs between kernel and plain version")

    # the kernel against its plain version at the main path's inputs: the
    # index's live rows (its capacity past them is padding, not scanned)
    corpus = idx.dense_corpus()
    mask = idx._mask(None)
    n = corpus.live_rows
    tile = 2048
    q, qs, kt, _ = dt.prepare(q_emb, corpus, CANDIDATES, tile=tile,
                              int8_queries=True, per_tile_k=idx._per_tile_k)
    args = (q, qs, corpus.values, corpus.scales, None, mask, n, tile, kt)
    kv, ki = dt.tile_topk(*args)
    pv, pi = dt.tile_topk_plain(*args)
    torch.cuda.synchronize()
    err = _compare(kv, ki, pv, pi, exact=True, tol=0.0)
    log(f"[full] kernel vs plain [num_tiles={kv.shape[0]}, B={BATCH}, kt={kt}]: "
        f"bit-equal (max |diff| {err})")

    kernel_ms = cuda_ms(lambda: dt.tile_topk(*args))
    plain_ms = cuda_ms(lambda: dt.tile_topk_plain(*args))
    lib_ms = cuda_ms(lambda: library_topk(q, qs, corpus.values, corpus.scales,
                                          mask, n, tile, kt))
    hybrid_ms = host_ms(lambda: idx.search_hybrid(q_emb, texts, k=TOP_K,
                                                  candidates=CANDIDATES))
    num_tiles = kv.shape[0]
    nbytes = (n * DIM + n * 4 + n + BATCH * DIM + BATCH * 4
              + num_tiles * BATCH * kt * 8)
    bound, bound_by = bound_ms(nbytes, 2.0 * BATCH * n * DIM, INT8_OPS_PER_S)
    log(f"[full] dense_topk kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"library (_int_mm + topk) {lib_ms:.3f} ms, bound {bound:.3f} ms "
        f"({bound_by}); search_hybrid batch {BATCH}: {hybrid_ms:.3f} ms "
        f"({BATCH / hybrid_ms * 1e3:.1f} queries/s)")
    # quality against an exact reference: the dense branch's top-10
    # (int8 queries, per-tile cap) vs an exact f32 search of the same
    # stored rows (codes x scales) for 64 queries
    sample = q_emb[:64]
    _, got = dt.dense_topk(sample, corpus, TOP_K, mask=mask, tile=tile,
                           int8_queries=True, per_tile_k=idx._per_tile_k,
                           device=DEVICE)
    qn = normalize_queries(sample, "cosine")
    gold = torch.empty((64, 0), device=DEVICE)
    gold_i = torch.empty((64, 0), dtype=torch.int64, device=DEVICE)
    for lo in range(0, n, 131072):
        hi = min(n, lo + 131072)
        s = qn @ (corpus.values[lo:hi].to(torch.float32) * corpus.scales[lo:hi, None]).T
        s = torch.where(mask[None, lo:hi], s, float("-inf"))
        v, i = torch.topk(torch.cat([gold, s], 1), TOP_K)
        gold_i = torch.gather(torch.cat([gold_i, torch.arange(lo, hi, device=DEVICE)
                                         .expand(64, -1)], 1), 1, i)
        gold = v
    recall = float(np.mean([len(set(a) & set(b)) / TOP_K for a, b in
                            zip(got.cpu().tolist(), gold_i.cpu().tolist())]))
    log(f"[full] dense recall@{TOP_K} vs exact f32 over the stored rows "
        f"(64 queries): {recall:.4f}")
    if recall < 0.9:
        raise AssertionError(f"dense recall@{TOP_K} {recall} < 0.9")
    results["recall"] = recall

    # where the batch's time goes, stage by stage (each timed alone)
    from super_rag_tpu_torch.ops.bm25_inverted import inverted_bm25_search

    t0 = time.perf_counter()
    qt, qi = idx._query_arrays(texts, 16)
    analyze_ms = (time.perf_counter() - t0) * 1e3
    # the served path embeds its texts first (CollectionEngine.search_batch)
    embedder = HashEmbedder(dim=DIM, device=DEVICE)
    embed_ms = host_ms(lambda: embedder.embed(texts))
    dense_ms = cuda_ms(lambda: dt.dense_topk(
        q_emb, corpus, CANDIDATES, mask=mask, tile=tile, int8_queries=True,
        per_tile_k=idx._per_tile_k, device=DEVICE))
    lex_ms = cuda_ms(lambda: inverted_bm25_search(
        qt, qi, idx._inverted, k=2 * CANDIDATES, mask=mask,
        postings_per_query_term=768))
    args64 = (q[:64], qs[:64]) + args[2:]
    kernel64_ms = cuda_ms(lambda: dt.tile_topk(*args64))
    bound64, bound64_by = bound_ms(nbytes - (BATCH - 64) * (DIM + 4 + num_tiles * kt * 8),
                                   2.0 * 64 * n * DIM, INT8_OPS_PER_S)
    log(f"[full] breakdown at batch {BATCH}: query embedding (hash embedder, "
        f"not part of search_hybrid) {embed_ms:.3f} ms; host query analysis {analyze_ms:.3f} ms, "
        f"dense branch (prep + kernel + merge) {dense_ms:.3f} ms, inverted "
        f"BM25 generation {lex_ms:.3f} ms, rest (rescore + RRF) "
        f"{hybrid_ms - analyze_ms - dense_ms - lex_ms:.3f} ms; kernel at "
        f"batch 64: {kernel64_ms:.3f} ms (bound {bound64:.3f} ms, {bound64_by})")
    results["dense_topk"] = {
        "launches": launches, "max_abs_err": err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
        "library_ms": lib_ms,
    }
    results["hybrid_ms"] = hybrid_ms
    return idx, texts, embedder


# -- phase 5: serving through CollectionEngine + QueryBatcher ----------------

def phase_serve(idx, texts, embedder) -> dict:
    from super_rag_tpu_torch.engine.batcher import QueryBatcher
    from super_rag_tpu_torch.engine.collection import CollectionEngine
    from super_rag_tpu_torch.engine.index import IndexSpec
    from super_rag_tpu_torch.ops import dense_topk as dt

    engine = CollectionEngine(
        IndexSpec(dim=DIM, dtype=torch.int8, bm25_slots=SLOTS, vocab_size=VOCAB,
                  min_capacity=4096),
        embedder=embedder, device=DEVICE)
    engine.index = idx
    requests = texts[:SERVE_REQUESTS]
    batcher = QueryBatcher(max_batch=64)

    async def serve():
        return await asyncio.gather(*(batcher.search(engine, t, top_k=TOP_K)
                                      for t in requests))

    try:
        dt.launches.count = 0
        t0 = time.perf_counter()
        answers = asyncio.run(serve())
        wall = time.perf_counter() - t0
        launches = dt.launches.count
    finally:
        batcher.close()
    if launches < 1:
        raise AssertionError("served requests did not launch the dense_topk kernel")
    for text, got in zip(requests, answers):
        want = engine.search_batch([text], top_k=TOP_K)[0]
        if ([(h.row, h.score) for h in got] != [(h.row, h.score) for h in want]
                or len(got) != TOP_K):
            raise AssertionError(f"batched answer differs for {text!r}")
    stats = batcher.stats()
    # one dispatch's worth, stage by stage: the embedding of 64 texts and
    # the whole search_batch of them (embedding + search_hybrid + hits)
    batch = requests[:64]
    embed64_ms = host_ms(lambda: embedder.embed(batch), reps=10)
    batch64_ms = host_ms(lambda: engine.search_batch(batch, top_k=TOP_K), reps=10)
    log(f"[serve] {len(requests)} concurrent requests in {wall:.3f} s: "
        f"{stats['dispatches']} dispatches, {stats['queries']} queries, "
        f"dense_topk launches {launches}; every answer equals a direct "
        f"search_batch; search_batch of 64 texts {batch64_ms:.3f} ms, of "
        f"which embedding {embed64_ms:.3f} ms")
    return stats


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script has no CPU path",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "super_rag_tpu_torch")):
        print("chip_smoke: super_rag_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 plain version
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, {torch.cuda.get_device_name(0)} "
        f"({time.perf_counter() - t0:.2f} s)")

    from super_rag_tpu_torch import _build

    t0 = time.perf_counter()
    took = _build.build(["dense_topk"])
    ptxas = [ln.strip() for ln in _build.build_logs.get("dense_topk", "").splitlines()
             if "registers" in ln or "spill" in ln]
    for ln in ptxas:
        log(f"[build] ptxas: {ln}")
    log(f"[build] nvcc {took} in {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    cases = phase_small()
    log(f"[small] kernel vs plain version: {cases} cases agree "
        f"(int8 x int8 bit-equal) in {time.perf_counter() - t0:.2f} s")

    results: dict = {}
    t0 = time.perf_counter()
    idx, texts, embedder = phase_full(results)
    log(f"[full] phase in {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    phase_serve(idx, texts, embedder)
    log(f"[serve] phase in {time.perf_counter() - t0:.2f} s")

    k = results["dense_topk"]
    kernels = {"kernels": [{
        "name": "dense_topk",
        "route": "cuda",
        "source": "super_rag_tpu_torch/csrc/dense_topk.cu",
        "replaces": "super_rag_tpu/ops/pallas_topk.py:36",
        **k,
    }]}
    log(f"[done] wall {time.perf_counter() - t_start:.2f} s")
    log(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
