#!/usr/bin/env python3
"""Smoke run of the PyTorch port (super_rag_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line with its seconds:
  1. device: the card's name and power limit (nvidia-smi), torch / CUDA;
  2. build: nvcc builds the kernels from super_rag_tpu_torch/csrc;
  3. kernel vs plain version at small shapes, every mode (int8 x int8 must
     match bit for bit, the float modes within a stated tolerance), for
     the dense top-k and both IVF kernels;
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
  6. IVF tier: a clustered 1M x 768 int8 corpus made on the card,
     DeviceIndex + compact_lexical + compact_dense(nlist 1024, nprobe 16)
     (timed streaming build), search_hybrid at batch 32 (the union
     kernel) and search_dense at batch 512 (the per-query kernel) with
     their launches counted, each kernel held against its plain version
     at those calls' inputs, the batch-32 hybrid result against the same
     path on the plain versions, recall@10 against an exact f32 search,
     and timings of the calls, the kernels, the plain versions and a
     library yardstick;
  7. IVF serving: >= 128 concurrent requests through
     QueryBatcher(max_batch=32) on the IVF index, each answer equal to a
     direct search_batch of its dispatch's batch, one union-kernel launch
     per dispatch;
  8. a ``{"kernels": [...]}`` JSON line;
  9. last line: ``{"ok": true, "device": {...}}``.

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
# the IVF tier: the reference's own IVF setting at 1M x 768 int8
# (scripts/bench_p50.py: compact_dense(nlist=1024, nprobe=16) over 2048
# clustered centres); B = 32 hybrid takes the union kernel, B = 512
# search_dense the per-query kernel
IVF_CENTERS = 2048
IVF_NLIST = 1024
IVF_NPROBE = 16
IVF_HYBRID_BATCH = 32
IVF_DENSE_BATCH = 512
IVF_SERVE_REQUESTS = 128

# H100 SXM published peaks (dense): HBM bytes/s, int8 and bf16 operations/s
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12


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


def make_corpus(n: int, gen: torch.Generator, centers=None):
    """Codes, scales and a zipfian doc-term table on the card, plus the
    host state a DeviceIndex snapshot carries.  Term buckets are the
    analyzer's hashes of the words ``t<rank>``, so text queries made of
    those words hit the same buckets.  Rows are iid Gaussian, or, given
    ``centers``, a random centre plus N(0, 1) noise (the repo's clustered
    IVF recipe); build_corpus L2-normalises and quantizes them."""
    from super_rag_tpu_torch.ops.dense import build_corpus
    from super_rag_tpu_torch.tokenize.analyzer import fnv1a32

    codes = torch.empty((n, DIM), dtype=torch.int8, device=DEVICE)
    scales = torch.empty((n,), dtype=torch.float32, device=DEVICE)
    step = 131072
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        x = torch.randn(hi - lo, DIM, device=DEVICE, generator=gen)
        if centers is not None:
            x += centers[torch.randint(0, centers.shape[0], (hi - lo,),
                                       device=DEVICE, generator=gen)]
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


def exact_topk(queries, corpus, mask, n: int) -> torch.Tensor:
    """Ids of the exact f32 top-TOP_K over the stored rows (codes x
    scales) of the first ``n`` rows, for cosine queries."""
    from super_rag_tpu_torch.ops.dense import normalize_queries

    qn = normalize_queries(queries, "cosine")
    b = qn.shape[0]
    gold = torch.empty((b, 0), device=DEVICE)
    gold_i = torch.empty((b, 0), dtype=torch.int64, device=DEVICE)
    for lo in range(0, n, 131072):
        hi = min(n, lo + 131072)
        s = qn @ (corpus.values[lo:hi].to(torch.float32) * corpus.scales[lo:hi, None]).T
        s = torch.where(mask[None, lo:hi], s, float("-inf"))
        v, i = torch.topk(torch.cat([gold, s], 1), TOP_K)
        gold_i = torch.gather(torch.cat([gold_i, torch.arange(lo, hi, device=DEVICE)
                                         .expand(b, -1)], 1), 1, i)
        gold = v
    return gold_i


def recall_at_k(got: torch.Tensor, gold: torch.Tensor) -> float:
    return float(np.mean([len(set(a[:TOP_K]) & set(b)) / TOP_K for a, b in
                          zip(got.cpu().tolist(), gold.cpu().tolist())]))


def phase_full(results: dict):
    from super_rag_tpu_torch.engine.index import DeviceIndex
    from super_rag_tpu_torch.models.hash_embedder import HashEmbedder
    from super_rag_tpu_torch.ops import dense_topk as dt

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
    recall = recall_at_k(got, exact_topk(sample, corpus, mask, n))
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


# -- the IVF dense tier ------------------------------------------------------

def _scores_err(got: torch.Tensor, ref: torch.Tensor, d: int) -> tuple[float, float]:
    """Raise unless two raw candidate-score arrays agree: the same -inf
    slots, finite values within ``_tolerance`` (sums of exact products,
    or of f32 products, in other orders).  Returns (max |diff|, tol)."""
    fin = torch.isfinite(ref)
    if not torch.equal(fin, torch.isfinite(got)):
        raise AssertionError("kernel and plain version disagree on -inf slots")
    tol = _tolerance(d, ref)
    diff = (got - ref).abs()[fin]
    err = float(diff.max()) if diff.numel() else 0.0
    if err > tol:
        raise AssertionError(f"scores differ by {err} > tolerance {tol}")
    return err, tol


def _compare_candidates(got: torch.Tensor, ref: torch.Tensor, d: int, k: int) -> float:
    """Kernel vs plain candidate scores ``[B, ...]``: the raw arrays within
    tolerance, then their top-k as the glue takes it (stable_topk), ids
    equal up to near-ties (``_compare``).  Returns max |diff|."""
    from super_rag_tpu_torch.ops.topk import stable_topk

    err, tol = _scores_err(got, ref, d)
    b = ref.shape[0]
    gv, gi = stable_topk(got.reshape(b, -1), k)
    rv, ri = stable_topk(ref.reshape(b, -1), k)
    _compare(gv[None], gi[None], rv[None], ri[None], exact=False, tol=tol,
             scores=ref.reshape(b, -1))
    return err


def phase_small_ivf() -> int:
    """Both IVF kernels against their plain versions at small shapes:
    every values mode, a ragged capacity (200) and a 128-multiple one,
    empty slots, with and without a keep-mask and the residual add-back,
    and probe lists that cover every tile (nprobe = nlist)."""
    from super_rag_tpu_torch.ops import ivf_topk as it

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    nlist, d, b = 12, 96, 20
    cases = 0
    for dtype in (torch.int8, torch.bfloat16, torch.float32):
        for cap in (200, 256):
            x = torch.randn(nlist, cap, d, device=DEVICE, generator=gen)
            if dtype == torch.int8:
                values = torch.clamp(torch.round(x * 40), -127, 127).to(torch.int8)
                scales = torch.rand(nlist, cap, device=DEVICE, generator=gen) * 0.01
            else:
                values, scales = x.to(dtype), None
            row_ids = torch.randperm(nlist * cap, device=DEVICE, generator=gen).to(
                torch.int32).reshape(nlist, cap)
            row_ids[torch.rand(nlist, cap, device=DEVICE, generator=gen) < 0.2] = -1
            q = torch.randn(b, d, device=DEVICE, generator=gen).to(
                torch.float32 if dtype == torch.float32 else torch.bfloat16)
            cs_all = torch.randn(b, nlist, device=DEVICE, generator=gen)
            keep = torch.rand(nlist * cap, device=DEVICE, generator=gen) < 0.7
            union_sets = [torch.tensor([3, 0, 11, 7], dtype=torch.int32, device=DEVICE),
                          torch.arange(nlist, dtype=torch.int32, device=DEVICE)]
            probe_sets = [torch.randint(0, nlist, (b, 5), device=DEVICE, generator=gen,
                                        dtype=torch.int32),
                          torch.stack([torch.randperm(nlist, device=DEVICE, generator=gen)
                                       for _ in range(b)]).to(torch.int32)]
            for residual in (False, True):
                for mask in (None, keep):
                    cs = cs_all if residual else None
                    for tiles in union_sets:
                        args = (q, tiles, values, scales, cs, row_ids, mask)
                        _compare_candidates(it.union_scores(*args),
                                            it.union_scores_plain(*args), d, 10)
                        cases += 1
                    for probes in probe_sets:
                        args = (q, probes, values, scales, cs, row_ids, mask)
                        _compare_candidates(it.probe_scores(*args),
                                            it.probe_scores_plain(*args), d, 10)
                        cases += 1
    torch.cuda.synchronize()
    return cases


def _reset_counts() -> None:
    from super_rag_tpu_torch.ops import dense_topk as dt
    from super_rag_tpu_torch.ops import ivf_topk as it

    dt.launches.count = 0
    it.union_launches.count = 0
    it.probe_launches.count = 0


def _counts() -> dict:
    from super_rag_tpu_torch.ops import dense_topk as dt
    from super_rag_tpu_torch.ops import ivf_topk as it

    return {"dense_topk": dt.launches.count, "ivf_union": it.union_launches.count,
            "ivf_probe": it.probe_launches.count}


def _recording(calls: dict, name: str, fn):
    """``fn`` that keeps the arguments of its last call in ``calls``."""
    def wrapped(*args):
        calls[name] = args
        return fn(*args)
    return wrapped


def phase_ivf(results: dict):
    """The IVF tier at full size: clustered 1M x 768 int8 corpus made on
    the card, DeviceIndex + compact_lexical + compact_dense(nlist 1024,
    nprobe 16) (the streaming build), then search_hybrid at B = 32 (union
    kernel) and search_dense at B = 512 (per-query kernel), each kernel
    held against its plain version at those calls' inputs."""
    from super_rag_tpu_torch.engine.index import DeviceIndex
    from super_rag_tpu_torch.ops import ivf_topk as it
    from super_rag_tpu_torch.ops.bm25_inverted import inverted_bm25_search

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    t0 = time.perf_counter()
    centers = torch.randn(IVF_CENTERS, DIM, device=DEVICE, generator=gen) * 3.0
    arrays, host, ranks, df_host = make_corpus(N_ROWS, gen, centers=centers)
    idx = DeviceIndex.from_snapshot(arrays, host, device=DEVICE)
    del arrays
    idx.compact_lexical(postings_per_term=max(256, N_ROWS // 500))
    torch.cuda.synchronize()
    t_make = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.compact_dense(nlist=IVF_NLIST, nprobe=IVF_NPROBE)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    ivf = idx._ivf
    of_rows = 0 if ivf.overflow is None else ivf.overflow.size
    log(f"[ivf] clustered corpus {N_ROWS} x {DIM} int8 ({IVF_CENTERS} centres x 3.0 "
        f"+ N(0,1), normalised) + DeviceIndex + compact_lexical in {t_make:.2f} s; "
        f"compact_dense(nlist={IVF_NLIST}, nprobe={IVF_NPROBE}) streaming build in "
        f"{t_build:.2f} s: capacity C={ivf.capacity}, overflow rows {of_rows}, "
        f"residual {ivf.residual}, sign plane {ivf.sign_plane is not None}")
    t0 = time.perf_counter()
    calibrated = idx._calibrate_nprobe(IVF_NPROBE, 0.95, 32, TOP_K)
    log(f"[ivf] _calibrate_nprobe(from {IVF_NPROBE}, recall target 0.95) would pick "
        f"nprobe {calibrated} ({time.perf_counter() - t0:.2f} s; printed only, "
        f"the index keeps {idx._ivf_nprobe})")

    qa = centers[torch.randint(0, IVF_CENTERS, (IVF_DENSE_BATCH,), device=DEVICE,
                               generator=gen)]
    qa = qa + torch.randn(IVF_DENSE_BATCH, DIM, device=DEVICE, generator=gen)
    texts = make_query_texts(ranks, df_host, gen, IVF_DENSE_BATCH)
    del ranks
    q32, t32 = qa[:IVF_HYBRID_BATCH], texts[:IVF_HYBRID_BATCH]

    # main path 1: search_hybrid at B = 32, the union kernel's tier; the
    # wrappers' operands are kept to hold each kernel against its plain
    # version at exactly these inputs
    calls: dict = {}
    _reset_counts()
    with mock.patch.object(it, "union_scores",
                           _recording(calls, "union", it.union_scores)):
        res = idx.search_hybrid(q32, t32, k=TOP_K, candidates=CANDIDATES)
    torch.cuda.synchronize()
    hyb_counts = _counts()
    if hyb_counts["ivf_union"] < 1:
        raise AssertionError(f"search_hybrid B={IVF_HYBRID_BATCH} launched no union "
                             f"kernel: {hyb_counts}")
    ids = res.indices.cpu().numpy()
    if (ids.shape != (IVF_HYBRID_BATCH, TOP_K) or ids.min() < 0
            or not np.isfinite(res.scores.cpu().numpy()).all()):
        raise AssertionError("IVF hybrid result has the wrong shape or empty slots")
    # main path 2: search_dense at B = 512, the per-query kernel's tier
    _reset_counts()
    with mock.patch.object(it, "probe_scores",
                           _recording(calls, "probe", it.probe_scores)):
        dv, di = idx.search_dense(qa, k=TOP_K)
    torch.cuda.synchronize()
    dense_counts = _counts()
    if dense_counts["ivf_probe"] < 1:
        raise AssertionError(f"search_dense B={IVF_DENSE_BATCH} launched no "
                             f"per-query kernel: {dense_counts}")
    if tuple(di.shape) != (IVF_DENSE_BATCH, TOP_K) or int(di.min()) < 0:
        raise AssertionError("IVF search_dense result has the wrong shape")
    log(f"[ivf] launches: search_hybrid B={IVF_HYBRID_BATCH} {hyb_counts}; "
        f"search_dense B={IVF_DENSE_BATCH} {dense_counts}")

    # the whole B = 32 hybrid result against the same path on the plain versions
    with mock.patch.object(it, "union_scores", it.union_scores_plain), \
            mock.patch.object(it, "probe_scores", it.probe_scores_plain):
        res_plain = idx.search_hybrid(q32, t32, k=TOP_K, candidates=CANDIDATES)
    if not torch.equal(res.indices, res_plain.indices):
        raise AssertionError("IVF hybrid ids differ between kernel and plain version")
    hyb_err = float((res.scores - res_plain.scores).abs().max())
    dense_err = float((res.dense_scores - res_plain.dense_scores).abs().max())
    if hyb_err > 0 or dense_err > 1e-6:
        raise AssertionError(f"IVF hybrid scores differ: rrf {hyb_err}, dense {dense_err}")
    log(f"[ivf] hybrid B={IVF_HYBRID_BATCH} on the kernels equals the plain versions' "
        f"ids and RRF scores (dense branch scores max |diff| {dense_err}, limit 1e-6: "
        f"the sign-plane refine re-scores the pool from the codes)")

    mask = idx._mask(None)
    cap = ivf.capacity
    # union kernel vs plain at the B = 32 call's inputs
    uargs = calls["union"]
    q_in, union = uargs[0], uargs[1]
    uk, up = it.union_scores(*uargs), it.union_scores_plain(*uargs)
    union_err = _compare_candidates(uk, up, DIM, CANDIDATES)
    n_union = union.shape[0]
    del uk, up
    # per-query kernel vs plain at the B = 512 call's inputs
    pargs = calls["probe"]
    probes_a = pargs[1]
    pk, pp = it.probe_scores(*pargs), it.probe_scores_plain(*pargs)
    probe_err = _compare_candidates(pk, pp, DIM, TOP_K)
    del pk, pp
    log(f"[ivf] union kernel vs plain [B={IVF_HYBRID_BATCH}, U={n_union}, C={cap}]: "
        f"max |diff| {union_err:.3g}; per-query kernel vs plain [B={IVF_DENSE_BATCH}, "
        f"nprobe={IVF_NPROBE}, C={cap}]: max |diff| {probe_err:.3g} (tolerance "
        f"D * 2^-23 * (max|s| + 1); top-k ids equal up to near-ties)")

    # recall@10 of the IVF tier against an exact f32 search of the stored rows
    n = idx.size
    gold = exact_topk(qa[:64], idx.dense_corpus(), mask, n)
    recall_probe = recall_at_k(di[:64], gold)
    got_union = torch.cat([idx.search_dense(qa[lo:lo + IVF_HYBRID_BATCH], k=TOP_K)[1]
                           for lo in (0, IVF_HYBRID_BATCH)])
    recall_union = recall_at_k(got_union, gold)
    log(f"[ivf] dense recall@{TOP_K} at nprobe {IVF_NPROBE} vs exact f32 over the "
        f"stored rows (64 queries): {recall_probe:.4f} (per-query route, "
        f"B={IVF_DENSE_BATCH}: own probes), {recall_union:.4f} (union route, "
        f"B={IVF_HYBRID_BATCH}: the batch's probe union)")
    if recall_probe < 0.5:
        raise AssertionError(f"IVF recall@{TOP_K} {recall_probe} < 0.5")

    # timings
    qa32 = qa[:IVF_HYBRID_BATCH]
    hyb32_ms = host_ms(lambda: idx.search_hybrid(q32, t32, k=TOP_K, candidates=CANDIDATES))
    # where the B = 32 hybrid batch's time goes, stage by stage (each alone)
    t0 = time.perf_counter()
    qt, qi = idx._query_arrays(t32, 16)
    analyze32_ms = (time.perf_counter() - t0) * 1e3
    dense32_branch_ms = cuda_ms(lambda: it.ivf_topk(q32, ivf, CANDIDATES,
                                                    nprobe=idx._ivf_nprobe, mask=mask,
                                                    device=DEVICE))
    lex32_ms = cuda_ms(lambda: inverted_bm25_search(
        qt, qi, idx._inverted, k=2 * CANDIDATES, mask=mask, postings_per_query_term=768))
    _reset_counts()
    idx.search_hybrid(qa, texts, k=TOP_K, candidates=CANDIDATES)
    big_counts = _counts()
    hyb512_ms = host_ms(lambda: idx.search_hybrid(qa, texts, k=TOP_K,
                                                  candidates=CANDIDATES), reps=10)
    dense512_ms = host_ms(lambda: idx.search_dense(qa, k=TOP_K), reps=10)
    dense32_ms = host_ms(lambda: idx.search_dense(qa32, k=TOP_K))
    union_ms = cuda_ms(lambda: it.union_scores(*uargs))
    union_plain_ms = cuda_ms(lambda: it.union_scores_plain(*uargs), reps=5)
    # library yardstick: one cuBLAS bf16 matmul of the query block against
    # the union tiles, gathered beforehand (the gather is not timed)
    tiles_bf16 = ivf.values[union.long()].reshape(n_union * cap, DIM).to(torch.bfloat16)
    union_lib_ms = cuda_ms(lambda: q_in @ tiles_bf16.T)
    del tiles_bf16
    probe_ms = cuda_ms(lambda: it.probe_scores(*pargs), reps=10)
    probe_plain_ms = cuda_ms(lambda: it.probe_scores_plain(*pargs), reps=3, warmup=1)
    b32, b512 = IVF_HYBRID_BATCH, IVF_DENSE_BATCH
    u_bytes = (n_union * cap * (DIM + 4 + 4 + 1) + b32 * DIM * 2 + n_union * 4
               + b32 * n_union * 4 + b32 * n_union * cap * 4)
    u_bound, u_by = bound_ms(u_bytes, 2.0 * b32 * n_union * cap * DIM, BF16_OPS_PER_S)
    distinct = int(torch.unique(probes_a).numel())
    p_bytes = (distinct * cap * (DIM + 4 + 4 + 1) + b512 * DIM * 2
               + b512 * IVF_NPROBE * (4 + 4) + b512 * IVF_NPROBE * cap * 4)
    p_bound, p_by = bound_ms(p_bytes, 2.0 * b512 * IVF_NPROBE * cap * DIM, BF16_OPS_PER_S)
    per_query_reads_ms = b512 * IVF_NPROBE * cap * DIM / HBM_BYTES_PER_S * 1e3
    log(f"[ivf] breakdown of search_hybrid B={b32}: host query analysis "
        f"{analyze32_ms:.3f} ms, dense branch (ivf_topk: probes + union kernel + "
        f"top-{CANDIDATES} + overflow scan + sign-plane refine) {dense32_branch_ms:.3f} ms, "
        f"inverted BM25 generation {lex32_ms:.3f} ms, rest (rescore + RRF) "
        f"{hyb32_ms - analyze32_ms - dense32_branch_ms - lex32_ms:.3f} ms")
    log(f"[ivf] search_hybrid B={b32} (union tier) {hyb32_ms:.3f} ms; B={b512} "
        f"(whole-index scan tier, launches {big_counts}) {hyb512_ms:.3f} ms; "
        f"search_dense B={b512} (per-query tier) {dense512_ms:.3f} ms, B={b32} "
        f"(union tier) {dense32_ms:.3f} ms")
    log(f"[ivf] union kernel {union_ms:.3f} ms, plain {union_plain_ms:.3f} ms, library "
        f"(cuBLAS bf16 matmul over the pre-gathered {n_union} tiles, gather not timed) "
        f"{union_lib_ms:.3f} ms, bound {u_bound:.3f} ms ({u_by}: {u_bytes / 1e9:.3f} GB)")
    log(f"[ivf] per-query kernel {probe_ms:.3f} ms, plain {probe_plain_ms:.3f} ms, "
        f"library none (no single PyTorch call scores each query against only its own "
        f"probed tiles: a bmm needs the [{b512},{IVF_NPROBE},{cap},{DIM}] gather first), "
        f"bound {p_bound:.3f} ms ({p_by}: {distinct} distinct tiles read once, "
        f"{p_bytes / 1e9:.3f} GB); reading each query's own tiles moves "
        f"{b512 * IVF_NPROBE * cap * DIM / 1e9:.2f} GB, {per_query_reads_ms:.3f} ms")
    results["ivf_union"] = {
        "launches": hyb_counts["ivf_union"], "max_abs_err": union_err, "ms": union_ms,
        "plain_ms": union_plain_ms, "bound_ms": u_bound, "bound_by": u_by,
        "library_ms": union_lib_ms,
    }
    results["ivf_probe"] = {
        "launches": dense_counts["ivf_probe"], "max_abs_err": probe_err, "ms": probe_ms,
        "plain_ms": probe_plain_ms, "bound_ms": p_bound, "bound_by": p_by,
        "library_ms": None,
    }
    return idx, texts


def phase_ivf_serve(idx, texts) -> dict:
    """>= 128 concurrent text requests through QueryBatcher(max_batch=32)
    over a CollectionEngine on the IVF index.  The union tier scores each
    query against its batch's probe union (the reference's semantics), so
    each answer is held against a direct search_batch of the batch it was
    dispatched in; every dispatch must launch the union kernel once."""
    from super_rag_tpu_torch.engine.batcher import QueryBatcher
    from super_rag_tpu_torch.engine.collection import CollectionEngine
    from super_rag_tpu_torch.engine.index import IndexSpec
    from super_rag_tpu_torch.models.hash_embedder import HashEmbedder
    from super_rag_tpu_torch.ops import ivf_topk as it

    engine = CollectionEngine(
        IndexSpec(dim=DIM, dtype=torch.int8, bm25_slots=SLOTS, vocab_size=VOCAB,
                  min_capacity=4096),
        embedder=HashEmbedder(dim=DIM, device=DEVICE), device=DEVICE)
    engine.index = idx
    requests = list(dict.fromkeys(texts))[:IVF_SERVE_REQUESTS]
    if len(requests) < IVF_SERVE_REQUESTS:
        raise AssertionError(f"only {len(requests)} distinct query texts")
    dispatched = []
    direct = engine.search_batch

    def recording(queries, **kw):
        dispatched.append((list(queries), kw))
        return direct(queries, **kw)

    engine.search_batch = recording
    batcher = QueryBatcher(max_batch=IVF_HYBRID_BATCH)

    async def serve():
        return await asyncio.gather(*(batcher.search(engine, t, top_k=TOP_K)
                                      for t in requests))

    try:
        _reset_counts()
        t0 = time.perf_counter()
        answers = asyncio.run(serve())
        wall = time.perf_counter() - t0
        counts = _counts()
    finally:
        batcher.close()
    stats = batcher.stats()
    if counts["ivf_union"] != stats["dispatches"] or stats["dispatches"] != len(dispatched):
        raise AssertionError(f"union launches {counts} != dispatches {stats['dispatches']}")
    served = dict(zip(requests, answers))
    for queries, kw in dispatched:
        for text, want in zip(queries, direct(queries, **kw)):
            got = served[text]
            if ([(h.row, h.score) for h in got] != [(h.row, h.score) for h in want]
                    or len(got) != TOP_K):
                raise AssertionError(f"served answer differs for {text!r}")
    sizes = sorted(len(q) for q, _ in dispatched)
    log(f"[ivf-serve] {len(requests)} concurrent requests in {wall:.3f} s: "
        f"{stats['dispatches']} dispatches (sizes {sizes}), union kernel launches "
        f"{counts['ivf_union']} (all launches {counts}); every answer equals a direct "
        f"search_batch of its dispatch's batch")
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
    took = _build.build(["dense_topk", "ivf_scan"])  # one nvcc each, together
    for name in ("dense_topk", "ivf_scan"):
        for ln in _build.build_logs.get(name, "").splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                log(f"[build] {name} ptxas: {ln.strip()}")
    log(f"[build] nvcc {took} in {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    cases = phase_small()
    log(f"[small] dense_topk kernel vs plain version: {cases} cases agree "
        f"(int8 x int8 bit-equal) in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    cases = phase_small_ivf()
    log(f"[small] IVF kernels vs plain versions: {cases} cases agree in "
        f"{time.perf_counter() - t0:.2f} s")

    results: dict = {}
    t0 = time.perf_counter()
    idx, texts, embedder = phase_full(results)
    log(f"[full] phase in {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    phase_serve(idx, texts, embedder)
    log(f"[serve] phase in {time.perf_counter() - t0:.2f} s")
    del idx, texts, embedder
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    idx, texts = phase_ivf(results)
    log(f"[ivf] phase in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_ivf_serve(idx, texts)
    log(f"[ivf-serve] phase in {time.perf_counter() - t0:.2f} s")

    source = "super_rag_tpu_torch/csrc/"
    kernels = {"kernels": [
        {"name": "dense_topk", "route": "cuda", "source": source + "dense_topk.cu",
         "replaces": "super_rag_tpu/ops/pallas_topk.py:36", **results["dense_topk"]},
        {"name": "ivf_union", "route": "cuda", "source": source + "ivf_scan.cu",
         "replaces": "super_rag_tpu/ops/pallas_ivf.py:93", **results["ivf_union"]},
        {"name": "ivf_probe", "route": "cuda", "source": source + "ivf_scan.cu",
         "replaces": "super_rag_tpu/ops/pallas_ivf.py:48", **results["ivf_probe"]},
    ]}
    log(f"[done] wall {time.perf_counter() - t_start:.2f} s")
    log(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
