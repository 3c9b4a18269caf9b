#!/usr/bin/env python3
"""Smoke run of the PyTorch port (super_rag_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line with its seconds:
  1. device: the card's name and power limit (nvidia-smi), torch / CUDA;
  2. build: nvcc builds the kernels from super_rag_tpu_torch/csrc;
  3. kernel vs plain version at small shapes, every mode (int8 x int8 must
     match bit for bit, the float modes within a stated tolerance), for
     the dense top-k (both variants: int8 tensor cores at kt <= 8, SIMT
     above and for float queries) and both IVF kernels; prints the ptxas
     report (registers, shared memory, spills) of every kernel built;
  4. full size: 1M x 768 int8 corpus + 64-slot zipfian BM25 table made on
     the card from a seed, DeviceIndex + compact_lexical, then
     search_hybrid at batch 512 (the tensor-core kernel launched and held
     bit for bit against its plain version, the hybrid result against the
     same path on the plain version, the dense top-10 against an exact
     f32 search: recall >= 0.9), and timings of the kernel, the SIMT
     kernel on the same inputs, the plain version, a library yardstick,
     the whole search_hybrid batch and its stages;
  5. serving: >= 256 concurrent text requests through QueryBatcher over
     a CollectionEngine on that index, each checked against a direct
     search_batch of the same query;
  6. IVF tier: a clustered 1M x 768 int8 corpus made on the card,
     DeviceIndex + compact_lexical + compact_dense(nlist 1024, nprobe 16)
     (timed streaming build), search_hybrid at batch 32 (the union
     kernel) and search_dense at batch 512 (the tensor-core per-query
     kernel over its tile-major work list) with their launches counted
     per variant, each kernel held against its plain version
     at those calls' inputs, the batch-32 hybrid result against the same
     path on the plain versions (bit for bit for every query whose union
     candidate list matches the plain version's; RRF scores equal where
     ids agree for the others, which differ at near-ties of the tensor
     cores' sums), recall@10 against an exact f32 dot (gated) and cosine
     search, timings of the calls, the kernels, the plain versions and
     a library yardstick each, and search_dense B = 512 stage by stage;
  7. IVF serving: >= 128 concurrent requests through
     QueryBatcher(max_batch=32) on the IVF index, each answer equal to a
     direct search_batch of its dispatch's batch, one union-kernel launch
     per dispatch;
  8. semantic tier: the encoder and cross-encoder at the in-repo
     checkpoints' config (6 x 256, bf16; weights drawn from flax's
     initialisers with a seed), f32 on the card held against the CPU and
     bf16 against f32; a 1M x 256 int8 index whose rows' texts are their
     own words; search_batch(hybrid, rerank, top-100 -> top-5) at batch 32
     (one tensor-core dense_topk launch at D = 256, held bit for bit
     against its plain version; every top-5 among the hybrid top-100),
     chunk embedding (65,536 texts at [128, 128]), query embedding (512),
     hybrid without rerank at 512, each forward's FLOPs and bound, and 64
     reranked requests through QueryBatcher(max_batch=32), each with the
     rows of a direct search_batch;
  9. CSR lexical tier at the north star's 10,002,432 rows x 768 int8 with
     a 48-slot zipfian table: compact_lexical picks CSR by itself;
     search_hybrid at batch 512 and 32 with the 10M budgets (pq 2048 +
     deep 4 x 16384, lex_gen 250), unsharded and with 16 doc shards,
     stage by stage; gates: CSR generation at full coverage equals the
     exact doc-major BM25 top-100, the 16-shard build equals it too, the
     dense_topk kernel inside the call is bit-equal to its plain version,
     dense recall@10 >= 0.9, hybrid fidelity against an exact hybrid
     (RRF of the exact branches) >= 0.8;
  10. engine layer: EngineManager builds an engine from a collection
     config, 65,536 texts ingested (native analyzer and Python loop
     timed), snapshot to a LocalObjectStore, a fresh manager restores from
     the store alone and answers as the original, batched_search through a
     QueryBatcher equals direct searches;
  11. a ``{"kernels": [...]}`` JSON line;
  12. last line: ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero.  There is no CPU path: without a
CUDA device, or without the package beside it, it exits non-zero and
prints no result.  Nothing is written under the repo except the kernel
and analyzer libraries in super_rag_tpu_torch/_build/; the engine phase's
snapshots go to a temporary directory that it removes.
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
# the CSR lexical tier at the north star's scale: scripts/bench_10m.py's
# rows and lexical recipe (48 slots over 2^17 buckets, 16 discriminative
# query terms, pq 2048 + deep 4 x 16384, lex_gen 250), the flat dense tier
CSR_ROWS = 8192 * 1221
CSR_SLOTS = 48
CSR_QUERY_TERMS = 16
CSR_BATCH = 512
CSR_SMALL_BATCH = 32
CSR_PQ = 2048
CSR_DEEP_TERMS = 4
CSR_DEEP_POSTINGS = 16384
CSR_LEX_GEN = 250
CSR_SHARDS = 16
CSR_GATE_QUERIES = 8
CSR_EVAL_QUERIES = 64
# CSR impacts are bf16 (relative rounding <= 2^-9), the doc-major scorer's
# f32: a sum of nonnegative weights stays within 2^-9, held at 2^-8
CSR_BF16_RTOL = 2.0 ** -8
# the engine layer: texts ingested through EngineManager / CollectionEngine
ENGINE_TEXTS = 65_536
ENGINE_WORDS = 128
ENGINE_INGEST_BATCH = 2048
ENGINE_QUERIES = 64
SEM_ROWS = 1_000_000
SEM_WORDS = 128  # words a row's text holds: every (query, row) pair fills 128 tokens
SEM_CHUNKS = 65_536
SEM_CHUNK_BATCH = 128
SEM_QUERY_BATCH = 512
SEM_RERANK_QUERIES = 32
SEM_RERANK_BATCH = 32
SEM_SERVE_REQUESTS = 64
SEM_CHECK_TEXTS = 128
SEM_CPU_TEXTS = 16  # a full-width CPU forward at [16, 128] takes about a second
# the semantic tier: the in-repo encoder_semantic checkpoints' config
# (checkpoints/encoder_semantic{,_reranker}.json); the weights are drawn
# from flax's initialisers with a seed (checkpoints/ is not copied to the
# card), over a 1M-row index of the encoder's 256-dim embeddings
SEMANTIC_CONFIG = {"vocab_size": 30522, "hidden_dim": 256, "num_layers": 6,
                   "num_heads": 8, "mlp_dim": 1024, "max_len": 128,
                   "type_vocab_size": 2, "layer_norm_eps": 1e-12,
                   "embed_dim": None, "dtype": "bfloat16"}

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
    # int8 x int8 at every register-list depth of the tensor-core variant
    # and one above its cap (the SIMT variant), ragged B and D, a mask
    # with an all-masked tile, duplicate rows (ties)
    for bq, dq in ((1, 16), (17, 48), (130, 768)):
        codes = torch.randint(-127, 128, (n, dq), device=DEVICE, generator=gen,
                              dtype=torch.int8)
        codes[64:96] = codes[:32]
        row_scale = torch.rand(n, device=DEVICE, generator=gen) * 0.01 + 0.001
        row_scale[64:96] = row_scale[:32]
        q8 = torch.randint(-127, 128, (bq, dq), device=DEVICE, generator=gen,
                           dtype=torch.int8)
        qs8 = torch.rand(bq, device=DEVICE, generator=gen) * 0.01 + 0.001
        keep = torch.rand(n, device=DEVICE, generator=gen) < 0.7
        keep[2048:4096] = False
        for kt in (1, 2, 3, 8, 9):
            want = "tc" if kt <= dt.TC_MAX_KT else "simt"
            if dt.kernel_variant(dt.MODE_INT8, kt, dq) != want:
                raise AssertionError(f"kt={kt}, D={dq} did not take the {want} variant")
            counter = dt.tc_launches if want == "tc" else dt.simt_launches
            for mask in (None, keep):
                args = (q8, qs8, codes, row_scale, None, mask, n, 2048, kt)
                before = counter.count
                got = dt.tile_topk(*args)
                if counter.count != before + 1:
                    raise AssertionError(f"the {want} variant was not launched")
                ref = dt.tile_topk_plain(*args)
                torch.cuda.synchronize()
                if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
                    raise AssertionError(f"int8 {want} kernel differs from plain at "
                                         f"B={bq}, D={dq}, kt={kt}")
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


def make_corpus(n: int, gen: torch.Generator, centers=None, dim: int = DIM,
                slots: int = SLOTS, vocab: int = VOCAB, pad: float = 0.2):
    """Codes, scales and a zipfian doc-term table of ``slots`` slots over
    ``vocab`` buckets on the card (a ``pad`` share of the slots padded),
    plus the host state a DeviceIndex snapshot carries.  Term buckets are
    the analyzer's hashes of the words ``t<rank>``, so text queries made
    of those words hit the same buckets.  Rows are iid Gaussian, or,
    given ``centers``, a random centre plus N(0, 1) noise (the repo's
    clustered IVF recipe); build_corpus L2-normalises and quantizes them.
    Returns the int32 ranks too (-1 on pad slots)."""
    from super_rag_tpu_torch.ops.dense import build_corpus
    from super_rag_tpu_torch.tokenize.analyzer import fnv1a32

    codes = torch.empty((n, dim), dtype=torch.int8, device=DEVICE)
    scales = torch.empty((n,), dtype=torch.float32, device=DEVICE)
    step = 131072
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        x = torch.randn(hi - lo, dim, device=DEVICE, generator=gen)
        if centers is not None:
            x += centers[torch.randint(0, centers.shape[0], (hi - lo,),
                                       device=DEVICE, generator=gen)]
        c = build_corpus(x, dtype=torch.int8)
        codes[lo:hi], scales[lo:hi] = c.values, c.scales

    bucket_of_rank = torch.tensor([fnv1a32(f"t{r}") & (vocab - 1)
                                   for r in range(vocab)],
                                  dtype=torch.int32, device=DEVICE)
    ranks = ((_zipf(gen, 1.3, (n, slots)) - 1) % vocab).to(torch.int32)
    terms = bucket_of_rank[ranks]
    tfs = torch.clamp(_zipf(gen, 2.0, (n, slots)), max=8).to(torch.float32)
    if pad > 0:
        padded = torch.rand((n, slots), device=DEVICE, generator=gen) < pad
        terms[padded] = vocab
        tfs[padded] = 0.0
        ranks[padded] = -1
        del padded
    doc_len = tfs.sum(1) * 2.0 + 1.0

    sorted_terms = torch.sort(terms, dim=1).values
    first = torch.ones_like(sorted_terms, dtype=torch.bool)
    first[:, 1:] = sorted_terms[:, 1:] != sorted_terms[:, :-1]
    uniq = sorted_terms[first]
    del sorted_terms, first
    df = torch.bincount(uniq[uniq < vocab].long(), minlength=vocab)
    del uniq
    df_host = df.cpu().numpy()
    arrays = {
        "emb": codes, "scales": scales, "terms": terms, "tfs": tfs,
        "doc_len": doc_len,
        "valid": torch.ones(n, dtype=torch.bool, device=DEVICE),
        "indexer_code": torch.zeros(n, dtype=torch.int32, device=DEVICE),
        "chat_code": torch.zeros(n, dtype=torch.int32, device=DEVICE),
    }
    host = {
        "spec": {"dim": dim, "metric": "cosine", "dtype": "int8",
                 "bm25_slots": slots, "vocab_size": vocab,
                 "min_capacity": 4096},
        "size": n,
        "row_meta": [{"text": f"chunk {r}"} for r in range(n)],
        "df": {"df": {int(t): int(df_host[t]) for t in np.flatnonzero(df_host)},
               "num_docs": n,
               "total_len": float(doc_len.to(torch.float64).sum())},
    }
    return arrays, host, ranks, df_host


def make_query_texts(ranks, df_host, gen, count: int, terms: int = QUERY_TERMS,
                     vocab: int = VOCAB) -> list[str]:
    """Queries of up to ``terms`` discriminative words from random rows
    (df <= max(64, N/50), as the repo's benchmarks pick them)."""
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
            bucket = fnv1a32(f"t{r}") & (vocab - 1)
            if bucket in seen or df_host[bucket] > df_cap:
                continue
            seen.add(bucket)
            words.append(f"t{r}")
            if len(words) == terms:
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


def exact_topk(queries, corpus, mask, n: int, cosine: bool = False,
               k: int = TOP_K) -> torch.Tensor:
    """Ids of the exact f32 top-``k`` over the stored rows (codes x
    scales) of the first ``n`` rows, for cosine queries: the dot with the
    stored rows, or with ``cosine`` the cosine (the rows renormalised, as
    the IVF build renormalises them)."""
    from super_rag_tpu_torch.ops.dense import normalize_queries

    qn = normalize_queries(queries, "cosine")
    b = qn.shape[0]
    gold = torch.empty((b, 0), device=DEVICE)
    gold_i = torch.empty((b, 0), dtype=torch.int64, device=DEVICE)
    for lo in range(0, n, 131072):
        hi = min(n, lo + 131072)
        rows = corpus.values[lo:hi].to(torch.float32) * corpus.scales[lo:hi, None]
        if cosine:
            rows = normalize_queries(rows, "cosine")
        s = qn @ rows.T
        s = torch.where(mask[None, lo:hi], s, float("-inf"))
        v, i = torch.topk(torch.cat([gold, s], 1), k)
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
    _reset_counts()
    t0 = time.perf_counter()
    res = idx.search_hybrid(q_emb, texts, k=TOP_K, candidates=CANDIDATES)
    torch.cuda.synchronize()
    counts = _counts()
    launches = counts["dense_topk_tc"]
    log(f"[full] search_hybrid batch {BATCH}: first call {time.perf_counter() - t0:.3f} s, "
        f"launches {counts}")
    if launches < 1:
        raise AssertionError("search_hybrid did not launch the tensor-core dense_topk kernel")
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

    if dt.kernel_variant(dt.MODE_INT8, kt, DIM) != "tc":
        raise AssertionError(f"the main path's kt={kt} is outside the tensor-core variant")
    kernel_ms = cuda_ms(lambda: dt.tile_topk(*args))
    # the earlier (SIMT dp4a) kernel on the same inputs, for the record
    with mock.patch.object(dt, "kernel_variant", lambda *a: "simt"):
        sv, si = dt.tile_topk(*args)
        _compare(sv, si, pv, pi, exact=True, tol=0.0)
        simt_ms = cuda_ms(lambda: dt.tile_topk(*args), reps=5)
    plain_ms = cuda_ms(lambda: dt.tile_topk_plain(*args))
    lib_ms = cuda_ms(lambda: library_topk(q, qs, corpus.values, corpus.scales,
                                          mask, n, tile, kt))
    hybrid_ms = host_ms(lambda: idx.search_hybrid(q_emb, texts, k=TOP_K,
                                                  candidates=CANDIDATES))
    num_tiles = kv.shape[0]
    nbytes = (n * DIM + n * 4 + n + BATCH * DIM + BATCH * 4
              + num_tiles * BATCH * kt * 8)
    bound, bound_by = bound_ms(nbytes, 2.0 * BATCH * n * DIM, INT8_OPS_PER_S)
    log(f"[full] dense_topk tensor-core kernel {kernel_ms:.3f} ms (SIMT kernel "
        f"{simt_ms:.3f} ms), plain {plain_ms:.3f} ms, "
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
        "variant": "tc (mma.sync m16n8k32 s8)", "launches": launches,
        "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": bound_by, "library_ms": lib_ms, "simt_ms": simt_ms,
        "batch64_ms": kernel64_ms,
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
        _reset_counts()
        t0 = time.perf_counter()
        answers = asyncio.run(serve())
        wall = time.perf_counter() - t0
        launches = _counts()["dense_topk_tc"]
    finally:
        batcher.close()
    if launches < 1:
        raise AssertionError("served requests did not launch the tensor-core dense_topk "
                             "kernel")
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
        f"tensor-core dense_topk launches {launches}; every answer equals a direct "
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
    D = 96 and, on the tensor cores, 1536, empty slots, with and without
    a keep-mask and the residual add-back; probe lists with repeats, that
    cover every tile (nprobe = nlist), that all hold one tile, and that
    put every query on the same two tiles (a tile over several groups of
    the work list).  Each per-query call must launch the variant its mode
    picks."""
    from super_rag_tpu_torch.ops import ivf_topk as it

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    nlist, b = 12, 20
    cases = 0
    for dtype in (torch.int8, torch.bfloat16, torch.float32):
        variant = it.probe_variant(it.MODES[dtype])
        counter = it.probe_tc_launches if variant == "tc" else it.probe_simt_launches
        shapes = ((200, 96), (256, 96)) + (((200, 1536),) if variant == "tc" else ())
        for cap, d in shapes:
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
            one_tile = torch.randint(0, nlist, (b, 5), device=DEVICE, generator=gen,
                                     dtype=torch.int32)
            one_tile[:, 2] = 7
            probe_sets = [torch.randint(0, nlist, (b, 5), device=DEVICE, generator=gen,
                                        dtype=torch.int32),
                          torch.stack([torch.randperm(nlist, device=DEVICE, generator=gen)
                                       for _ in range(b)]).to(torch.int32),
                          one_tile,
                          torch.tensor([[11, 4]], dtype=torch.int32,
                                       device=DEVICE).repeat(b, 2)]
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
                        before = counter.count
                        got = it.probe_scores(*args)
                        if counter.count != before + 1:
                            raise AssertionError(f"{dtype} per-query call did not launch "
                                                 f"the {variant} variant")
                        _compare_candidates(got, it.probe_scores_plain(*args), d, 10)
                        cases += 1
    torch.cuda.synchronize()
    return cases


def _reset_counts() -> None:
    from super_rag_tpu_torch.ops import dense_topk as dt
    from super_rag_tpu_torch.ops import ivf_topk as it

    for counter in (dt.tc_launches, dt.simt_launches, it.union_tc_launches,
                    it.union_simt_launches, it.probe_tc_launches, it.probe_simt_launches):
        counter.count = 0


def _counts() -> dict:
    from super_rag_tpu_torch.ops import dense_topk as dt
    from super_rag_tpu_torch.ops import ivf_topk as it

    return {"dense_topk_tc": dt.tc_launches.count,
            "dense_topk_simt": dt.simt_launches.count,
            "ivf_union_tc": it.union_tc_launches.count,
            "ivf_union_simt": it.union_simt_launches.count,
            "ivf_probe_tc": it.probe_tc_launches.count,
            "ivf_probe_simt": it.probe_simt_launches.count}


def _recording(calls: dict, name: str, fn):
    """``fn`` that keeps the arguments of its last call in ``calls``."""
    def wrapped(*args):
        calls[name] = args
        return fn(*args)
    return wrapped


def _dense_stages(idx, qa, mask, want):
    """search_dense at qa's batch on the per-query route, stage by stage
    (each timed alone on CUDA events): probe selection, work-list build,
    the tensor-core kernel, top-k of the [B, nprobe * C] candidates, the
    overflow scan + sign-plane refine.  The staged result must equal
    ``want``, the (scores, ids) of the call itself.  Returns the stage
    times, the work list, the kernel's ms and the library yardstick's ms:
    one torch.bmm of the groups' tiles against their queries, padded to
    the group size, both gathered and made bf16 beforehand (not timed)."""
    from super_rag_tpu_torch.ops import ivf_topk as it
    from super_rag_tpu_torch.ops.dense import normalize_queries
    from super_rag_tpu_torch.ops.ivf import attach_overflow_and_refine
    from super_rag_tpu_torch.ops.topk import stable_topk

    ivf = idx._ivf
    b = qa.shape[0]
    nlist, cap, _ = ivf.values.shape
    nprobe = min(idx._ivf_nprobe, nlist)

    def select():
        q = normalize_queries(qa, idx.spec.metric)
        cs = q @ ivf.centroids.T
        return q, cs, stable_topk(cs, nprobe)[1].to(torch.int32)

    q, cs, probes = select()
    groups = it.probe_groups(probes, nlist, it.PROBE_QG)
    q_in = q.to(torch.bfloat16).contiguous()
    cs_in = cs.contiguous() if ivf.residual else None
    out = torch.empty((b, nprobe, cap), dtype=torch.float32, device=DEVICE)
    mode = it.MODES[ivf.values.dtype]

    def kernel():
        it._probe_tc(mode, q_in, groups, nprobe, ivf.values, ivf.scales, cs_in,
                     ivf.row_ids, mask, out)

    kernel()
    cv = out.reshape(b, -1)
    fv, pos = stable_topk(cv, TOP_K)
    floc = torch.gather(probes.long(), 1, pos // cap) * cap + pos % cap
    fi = torch.where(torch.isfinite(fv), ivf.row_ids.reshape(-1)[floc], -1)

    def tail():
        return attach_overflow_and_refine(q, cs, ivf, fv, fi, floc, TOP_K, mask=mask)

    got = tail()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("search_dense staged for timing differs from the call")
    stages = {
        "probe selection": cuda_ms(select),
        "work-list build": cuda_ms(lambda: it.probe_groups(probes, nlist, it.PROBE_QG)),
        "tensor-core kernel": cuda_ms(kernel),
        f"top-{TOP_K} of [{b}, {nprobe * cap}]": cuda_ms(lambda: stable_topk(cv, TOP_K)),
        "overflow scan + sign-plane refine": cuda_ms(tail),
    }
    # the yardstick's operands: group g's tile and its queries, padded
    n_groups = int(groups.group_off[-1])
    g = torch.arange(n_groups, device=DEVICE, dtype=torch.int32)
    tile_of = torch.searchsorted(groups.group_off, g, right=True) - 1
    first = groups.pair_off[tile_of] + (g - groups.group_off[tile_of]) * it.PROBE_QG
    slot = first[:, None] + torch.arange(it.PROBE_QG, device=DEVICE)[None]
    filled = slot < groups.pair_off[tile_of + 1][:, None]
    pairs = groups.order.long()[slot.clamp(max=b * nprobe - 1)]
    qblk = torch.where(filled[..., None], q_in[pairs // nprobe], 0).transpose(1, 2)
    tiles = ivf.values[tile_of.long()].to(torch.bfloat16)
    lib_ms = cuda_ms(lambda: torch.bmm(tiles, qblk), reps=10)
    del tiles, qblk
    return stages, groups, stages["tensor-core kernel"], lib_ms


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
    if hyb_counts["ivf_union_tc"] < 1:
        raise AssertionError(f"search_hybrid B={IVF_HYBRID_BATCH} launched no tensor-core "
                             f"union kernel: {hyb_counts}")
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
    if dense_counts["ivf_probe_tc"] < 1:
        raise AssertionError(f"search_dense B={IVF_DENSE_BATCH} launched no tensor-core "
                             f"per-query kernel: {dense_counts}")
    if tuple(di.shape) != (IVF_DENSE_BATCH, TOP_K) or int(di.min()) < 0:
        raise AssertionError("IVF search_dense result has the wrong shape")
    log(f"[ivf] launches: search_hybrid B={IVF_HYBRID_BATCH} {hyb_counts}; "
        f"search_dense B={IVF_DENSE_BATCH} {dense_counts}")

    mask = idx._mask(None)
    cap = ivf.capacity
    # union kernel vs plain at the B = 32 call's inputs
    from super_rag_tpu_torch.ops.topk import stable_topk

    uargs = calls["union"]
    q_in, union = uargs[0], uargs[1]
    uk, up = it.union_scores(*uargs), it.union_scores_plain(*uargs)
    union_err = _compare_candidates(uk, up, DIM, CANDIDATES)
    n_union = union.shape[0]
    # queries whose candidate lists (the top-CANDIDATES of the union scores)
    # come out in the same order on the kernel and on the plain version
    ki_ = stable_topk(uk.reshape(IVF_HYBRID_BATCH, -1), CANDIDATES)[1]
    pi_ = stable_topk(up.reshape(IVF_HYBRID_BATCH, -1), CANDIDATES)[1]
    same_cands = (ki_ == pi_).all(1)
    del uk, up, ki_, pi_

    # the whole B = 32 hybrid result against the same path on the plain
    # versions: bit-equal for every query whose candidate list is the plain
    # version's; a query whose list differs (only at near-ties of the union
    # scores, checked above: the tensor cores add in their own order) is
    # held to the kernel's contract: RRF scores equal where ids are
    with mock.patch.object(it, "union_scores", it.union_scores_plain), \
            mock.patch.object(it, "probe_scores", it.probe_scores_plain):
        res_plain = idx.search_hybrid(q32, t32, k=TOP_K, candidates=CANDIDATES)
    rows_eq = ((res.indices == res_plain.indices).all(1)
               & (res.scores == res_plain.scores).all(1))
    dense_err = (float((res.dense_scores - res_plain.dense_scores)[same_cands].abs().max())
                 if bool(same_cands.any()) else 0.0)
    if bool((same_cands & ~rows_eq).any()) or dense_err > 1e-6:
        raise AssertionError(f"IVF hybrid differs between kernel and plain version for a "
                             f"query with the same candidates (dense {dense_err})")
    same_ids = res.indices == res_plain.indices
    if not torch.equal(res.scores[same_ids], res_plain.scores[same_ids]):
        raise AssertionError("IVF hybrid RRF scores differ where the ids agree")
    log(f"[ivf] hybrid B={IVF_HYBRID_BATCH} on the kernels vs the plain versions: "
        f"{int(same_cands.sum())} of {IVF_HYBRID_BATCH} queries have the same candidate "
        f"list and equal the plain result bit for bit (dense branch scores max |diff| "
        f"{dense_err}, limit 1e-6: the sign-plane refine re-scores the pool from the "
        f"codes); {int((~rows_eq).sum())} rows differ, each where the candidate list "
        f"differs at a near-tie, with RRF scores equal where ids agree")

    # per-query kernel vs plain at the B = 512 call's inputs
    pargs = calls["probe"]
    probes_a = pargs[1]
    pk, pp = it.probe_scores(*pargs), it.probe_scores_plain(*pargs)
    probe_err = _compare_candidates(pk, pp, DIM, TOP_K)
    del pk, pp
    log(f"[ivf] union kernel vs plain [B={IVF_HYBRID_BATCH}, U={n_union}, C={cap}]: "
        f"max |diff| {union_err:.3g}; tensor-core per-query kernel vs plain [B={IVF_DENSE_BATCH}, "
        f"nprobe={IVF_NPROBE}, C={cap}]: max |diff| {probe_err:.3g} (tolerance "
        f"D * 2^-23 * (max|s| + 1); top-k ids equal up to near-ties)")

    # recall@10 of the IVF tier against an exact f32 search of the stored rows
    n = idx.size
    gold = exact_topk(qa[:64], idx.dense_corpus(), mask, n)
    gold_cos = exact_topk(qa[:64], idx.dense_corpus(), mask, n, cosine=True)
    recall_probe = recall_at_k(di[:64], gold)
    got_union = torch.cat([idx.search_dense(qa[lo:lo + IVF_HYBRID_BATCH], k=TOP_K)[1]
                           for lo in (0, IVF_HYBRID_BATCH)])
    recall_union = recall_at_k(got_union, gold)
    log(f"[ivf] dense recall@{TOP_K} at nprobe {IVF_NPROBE} (64 queries) vs the exact "
        f"f32 dot with the stored rows: {recall_probe:.4f} (per-query route, "
        f"B={IVF_DENSE_BATCH}: own probes), {recall_union:.4f} (union route, "
        f"B={IVF_HYBRID_BATCH}: the batch's probe union); vs the exact cosine with "
        f"the stored rows (the IVF's own metric): {recall_at_k(di[:64], gold_cos):.4f} "
        f"(per-query), {recall_at_k(got_union, gold_cos):.4f} (union)")
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
    probe_wrapper_ms = cuda_ms(lambda: it.probe_scores(*pargs), reps=10)
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
    stages, groups, probe_ms, probe_lib_ms = _dense_stages(idx, qa, mask, (dv, di))
    n_groups = int(groups.group_off[-1])
    log(f"[ivf] breakdown of search_hybrid B={b32}: host query analysis "
        f"{analyze32_ms:.3f} ms, dense branch (ivf_topk: probes + union kernel + "
        f"top-{CANDIDATES} + overflow scan + sign-plane refine) {dense32_branch_ms:.3f} ms, "
        f"inverted BM25 generation {lex32_ms:.3f} ms, rest (rescore + RRF) "
        f"{hyb32_ms - analyze32_ms - dense32_branch_ms - lex32_ms:.3f} ms")
    log(f"[ivf] search_hybrid B={b32} (union tier) {hyb32_ms:.3f} ms; B={b512} "
        f"(whole-index scan tier, launches {big_counts}) {hyb512_ms:.3f} ms; "
        f"search_dense B={b512} (per-query tier) {dense512_ms:.3f} ms, B={b32} "
        f"(union tier) {dense32_ms:.3f} ms")
    log(f"[ivf] union tensor-core kernel {union_ms:.3f} ms, plain {union_plain_ms:.3f} ms, library "
        f"(cuBLAS bf16 matmul over the pre-gathered {n_union} tiles, gather not timed) "
        f"{union_lib_ms:.3f} ms, bound {u_bound:.3f} ms ({u_by}: {u_bytes / 1e9:.3f} GB)")
    log(f"[ivf] per-query kernel, variant tc (mma.sync m16n8k16 bf16, tile-major over "
        f"{n_groups} groups of <= {it.PROBE_QG} pairs on {distinct} tiles, grid of "
        f"{groups.max_groups} groups), launches {dense_counts['ivf_probe_tc']} in "
        f"search_dense B={b512}: kernel {probe_ms:.3f} ms, with the work list "
        f"{probe_wrapper_ms:.3f} ms, plain {probe_plain_ms:.3f} ms, library (torch.bmm of "
        f"the {n_groups} groups' tiles against their queries padded to {it.PROBE_QG}, "
        f"bf16, gathered beforehand, gather not timed) {probe_lib_ms:.3f} ms, bound "
        f"{p_bound:.3f} ms ({p_by}: {distinct} distinct tiles read once, "
        f"{p_bytes / 1e9:.3f} GB); reading each query's own tiles moves "
        f"{b512 * IVF_NPROBE * cap * DIM / 1e9:.2f} GB, {per_query_reads_ms:.3f} ms")
    rest = dense512_ms - sum(stages.values())
    log(f"[ivf] breakdown of search_dense B={b512} ({dense512_ms:.3f} ms): "
        + ", ".join(f"{name} {ms:.3f} ms" for name, ms in stages.items())
        + f", rest (gathers, host) {rest:.3f} ms")
    results["ivf_union"] = {
        "variant": "tc (mma.sync m16n8k16 bf16)", "launches": hyb_counts["ivf_union_tc"],
        "max_abs_err": union_err, "ms": union_ms, "plain_ms": union_plain_ms,
        "bound_ms": u_bound, "bound_by": u_by, "library_ms": union_lib_ms,
    }
    results["ivf_probe"] = {
        "variant": "tc (mma.sync m16n8k16 bf16)", "launches": dense_counts["ivf_probe_tc"],
        "max_abs_err": probe_err, "ms": probe_ms, "plain_ms": probe_plain_ms,
        "bound_ms": p_bound, "bound_by": p_by, "library_ms": probe_lib_ms,
        "with_work_list_ms": probe_wrapper_ms,
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
    if counts["ivf_union_tc"] != stats["dispatches"] or stats["dispatches"] != len(dispatched):
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
        f"{stats['dispatches']} dispatches (sizes {sizes}), tensor-core union kernel "
        f"launches {counts['ivf_union_tc']} (all launches {counts}); every answer equals a direct "
        f"search_batch of its dispatch's batch")
    return stats


# -- the semantic tier: encoder -> hybrid search -> cross-encoder rerank ------

def semantic_config(dtype: torch.dtype):
    """The checkpoints' EncoderConfig at activation ``dtype``."""
    from super_rag_tpu_torch.models.encoder import EncoderConfig

    return EncoderConfig(**{**SEMANTIC_CONFIG, "dtype": dtype})


def row_texts(ranks: torch.Tensor, tfs: torch.Tensor, words: int) -> list[str]:
    """Each row's text: its own words ``t<rank>`` in slot order, each
    repeated tf times, the sequence repeated until it is ``words`` long
    (a chunk that fills the encoders' 128-token bucket).  Built on the
    card (a searchsorted of each position into the row's cumulative tf),
    joined on the host from fixed-width 8-byte words."""
    table = np.array([f"t{r}".ljust(8).encode() for r in range(VOCAB)], dtype="S8")
    out: list[str] = []
    pos = torch.arange(words, device=DEVICE)
    for lo in range(0, ranks.shape[0], 131072):
        r, tf = ranks[lo:lo + 131072], tfs[lo:lo + 131072].to(torch.int64)
        cum = torch.cumsum(tf, 1)
        total = torch.clamp(cum[:, -1:], min=1)
        slot = torch.searchsorted(cum, (pos[None] % total).contiguous(), right=True)
        word = torch.gather(r, 1, slot.clamp(max=r.shape[1] - 1)).clamp(min=0)
        row = table[word.to(torch.int32).cpu().numpy()]
        out.extend(b.decode() for b in row.view(f"S{8 * words}").ravel().tolist())
    return out


def encoder_flops(b: int, s: int, cfg, pooler: bool = False) -> float:
    """Multiply-adds x 2 of one forward at [b, s]: the Q, K, V and output
    products, the two attention products and the MLP of every layer (and
    the cross-encoder's pooler and head)."""
    h, m = cfg.hidden_dim, cfg.mlp_dim
    per_layer = 2.0 * b * s * (4 * h * h + 2 * h * m) + 4.0 * b * s * s * h
    return cfg.num_layers * per_layer + (2.0 * b * (h * h + h) if pooler else 0.0)


def encoder_bound(b: int, s: int, model, flops: float) -> tuple[float, str]:
    """The forward's bound: its stored (f32) weights read once, except
    the token table, of which the b * s rows gathered; ids, mask and
    type ids read once; the output written once."""
    emb = model.backbone.token_embed.weight
    weights = sum(p.numel() for p in model.parameters()) - emb.numel()
    nbytes = weights * 4 + b * s * (emb.shape[1] * 4 + 4 + 1 + 4) + b * emb.shape[1] * 4
    return bound_ms(nbytes, flops, BF16_OPS_PER_S)


def interleaved_ms(fns: dict, reps: int = 10, warmup: int = 1) -> dict:
    """Median milliseconds of each function + a device synchronize, on the
    host clock; the functions run in turn within each repetition, so a
    drift of the shared host falls on all of them alike."""
    for _ in range(warmup):
        for fn in fns.values():
            fn()
    torch.cuda.synchronize()
    times: dict = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: statistics.median(t) for name, t in times.items()}


def device_busy(fn, wall_ms: float, reps: int = 5) -> str:
    """The card's kernel time and kernel count per call of ``fn``, from a
    torch.profiler trace, and the idle share of ``wall_ms`` (the call's
    untraced CUDA-event time) that leaves: the card waiting on the host's
    launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return "device busy time not measured (the trace holds no kernel)"
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / reps
    return (f"{len(kernels) / reps:.0f} kernels, busy {busy:.3f} ms "
            f"(idle {max(0.0, 1 - busy / wall_ms):.1%} of the call)")


def _close(got, want, rel: float) -> float:
    """Raise unless |got - want| <= rel * (1 + |want|); return the largest
    |got - want| / (1 + |want|)."""
    err = float(((got - want).abs() / (1 + want.abs())).max())
    if not err <= rel:
        raise AssertionError(f"scores differ by {err} (1 + |s|) > {rel} (1 + |s|)")
    return err


def semantic_checks(enc, rr, texts: list[str], queries: list[str]) -> dict:
    """The encoder and cross-encoder in f32 on the card (TF32 off) against
    the same modules and weights on the CPU, and the bf16 modules on the
    card against their f32 run on the card.  Returns the margins."""
    from super_rag_tpu_torch import convert
    from super_rag_tpu_torch.models.cross_encoder import rerank_scores
    from super_rag_tpu_torch.models.encoder import flax_params

    cfg32 = semantic_config(torch.float32)
    enc_p, ce_p = flax_params(enc.model), flax_params(rr.model)
    ids, mask = enc.tokenizer.encode_batch(texts, max_len=enc.max_len)
    pids, pmask, ptt = rr.tokenizer.encode_pairs(
        [queries[i % len(queries)] for i in range(len(texts))], texts, max_len=rr.max_len)

    def run(model, dev, n, pairs=False):
        args = (pids, pmask, ptt) if pairs else (ids, mask)
        args = [torch.from_numpy(a[:n]).to(dev) for a in args]
        with torch.inference_mode():
            return (rerank_scores(model, *args) if pairs else model(*args)).float().cpu()

    out = {}
    n_cpu = SEM_CPU_TEXTS
    enc32 = convert.encoder_from_jax(enc_p, cfg32, device=DEVICE)
    ce32 = convert.cross_encoder_from_jax(ce_p, cfg32, device=DEVICE)
    emb_card, ce_card = run(enc32, DEVICE, len(texts)), run(ce32, DEVICE, len(texts), True)
    emb_cpu = run(convert.encoder_from_jax(enc_p, cfg32, device="cpu"), "cpu", n_cpu)
    ce_cpu = run(convert.cross_encoder_from_jax(ce_p, cfg32, device="cpu"), "cpu", n_cpu, True)
    out["f32_emb_err"] = float((emb_card[:n_cpu] - emb_cpu).abs().max())
    if not out["f32_emb_err"] <= 1e-5:
        raise AssertionError(f"f32 embeddings on the card differ from the CPU by "
                             f"{out['f32_emb_err']} > 1e-5")
    out["f32_ce_err"] = _close(ce_card[:n_cpu], ce_cpu, 1e-4)
    emb16, ce16 = run(enc.model, DEVICE, len(texts)), run(rr.model, DEVICE, len(texts), True)
    out["bf16_min_cos"] = float((emb16 * emb_card).sum(1).min())
    out["bf16_emb_err"] = float((emb16 - emb_card).abs().max())
    if not (out["bf16_min_cos"] >= 0.9995 and out["bf16_emb_err"] <= 1e-2):
        raise AssertionError(f"bf16 embeddings vs f32: min cosine {out['bf16_min_cos']} "
                             f"(limit 0.9995), max |diff| {out['bf16_emb_err']} (limit 1e-2)")
    out["bf16_ce_err"] = _close(ce16, ce_card, 2e-2)
    out["ce_abs_max"] = float(ce_card.abs().max())
    return out


def phase_semantic(results: dict):
    """The served path of hybrid search + cross-encoder rerank: query texts
    -> EncoderService (TextEncoder) -> CollectionEngine.search_batch(hybrid,
    rerank) -> DeviceIndex.search_hybrid (flat tier, dense_topk at D = 256)
    -> RerankService (CrossEncoder) -> z-fused top-5, over 1M rows of
    256-dim int8 embeddings and the zipfian 64-slot lexical table, each
    row's text its own words; the encoders at the checkpoints' full width
    with seeded weights."""
    from super_rag_tpu_torch.engine.batcher import QueryBatcher
    from super_rag_tpu_torch.engine.collection import CollectionEngine
    from super_rag_tpu_torch.engine.index import DeviceIndex, IndexSpec
    from super_rag_tpu_torch.models.encoder_service import EncoderService
    from super_rag_tpu_torch.ops import dense_topk as dt
    from super_rag_tpu_torch.service.rerank_service import RerankService

    cfg = semantic_config(torch.bfloat16)
    dim, seq = cfg.out_dim, cfg.max_len
    enc = EncoderService(cfg, batch_size=SEM_CHUNK_BATCH, max_len=seq, seed=SEED,
                         device=DEVICE)
    rr = RerankService(cfg, max_len=seq, batch_size=SEM_RERANK_BATCH, seed=SEED + 1,
                       device=DEVICE)
    forwards = {"encoder": 0, "cross_encoder": 0}

    def counting(name):
        def hook(module, args):
            if args[0].device.type == torch.device(DEVICE).type:
                forwards[name] += 1
        return hook

    enc.model.register_forward_pre_hook(counting("encoder"))
    rr.model.register_forward_pre_hook(counting("cross_encoder"))

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    t0 = time.perf_counter()
    arrays, host, ranks, df_host = make_corpus(SEM_ROWS, gen, dim=dim)
    torch.cuda.synchronize()
    t_corpus = time.perf_counter() - t0
    t0 = time.perf_counter()
    texts_all = row_texts(ranks, arrays["tfs"], SEM_WORDS)
    host["row_meta"] = [{"text": t} for t in texts_all]
    t_texts = time.perf_counter() - t0
    idx = DeviceIndex.from_snapshot(arrays, host, device=DEVICE)
    del arrays, host
    idx.compact_lexical(postings_per_term=max(256, SEM_ROWS // 500))
    torch.cuda.synchronize()
    engine = CollectionEngine(
        IndexSpec(dim=dim, dtype=torch.int8, bm25_slots=SLOTS, vocab_size=VOCAB,
                  min_capacity=4096), embedder=enc, reranker=rr, device=DEVICE)
    engine.index = idx
    queries = make_query_texts(ranks, df_host, gen, SEM_QUERY_BATCH)
    del ranks
    log(f"[semantic] on {results['card']}: corpus {SEM_ROWS} x {dim} int8 + "
        f"{SLOTS}-slot table in {t_corpus:.2f} s; row texts ({SEM_WORDS} words each) "
        f"in {t_texts:.2f} s; "
        f"encoder and cross-encoder {cfg.num_layers} layers x {cfg.hidden_dim} "
        f"({cfg.num_heads} heads, MLP {cfg.mlp_dim}, vocab {cfg.vocab_size}, "
        f"{str(cfg.dtype)[6:]}), weights drawn from flax's initialisers (seeds "
        f"{SEED}, {SEED + 1}), HashTokenizer")

    # hard checks: f32 on the card vs the CPU, bf16 vs f32 on the card
    checks = semantic_checks(enc, rr, texts_all[:SEM_CHECK_TEXTS], queries)
    log(f"[semantic] f32 (TF32 off) card vs CPU, {SEM_CPU_TEXTS} texts / pairs: "
        f"embeddings max |diff| {checks['f32_emb_err']:.3g} (limit 1e-5), CE scores "
        f"{checks['f32_ce_err']:.3g} (1 + |s|) (limit 1e-4); bf16 vs f32 on the card, "
        f"{SEM_CHECK_TEXTS} texts / pairs: embeddings min cosine "
        f"{checks['bf16_min_cos']:.6f} (limit 0.9995), max |diff| "
        f"{checks['bf16_emb_err']:.3g} (limit 1e-2), CE scores "
        f"{checks['bf16_ce_err']:.3g} (1 + |s|) (limit 2e-2; max |s| "
        f"{checks['ce_abs_max']:.3f})")

    # the main path, counted: B = 32 hybrid + rerank top-100 -> top-5
    q32 = queries[:SEM_RERANK_QUERIES]
    calls: dict = {}
    _reset_counts()
    forwards.update(encoder=0, cross_encoder=0)
    with mock.patch.object(dt, "tile_topk", _recording(calls, "tile", dt.tile_topk)):
        hits = engine.search_batch(q32, mode="hybrid", rerank=True,
                                   candidates=CANDIDATES, top_k=5)
    torch.cuda.synchronize()
    counts = _counts()
    n_fwd = dict(forwards)
    if counts["dense_topk_tc"] != 1:
        raise AssertionError(f"hybrid + rerank B={len(q32)} launched {counts}, not one "
                             f"tensor-core dense_topk")
    want_ce = len(q32) * -(-CANDIDATES // SEM_RERANK_BATCH)
    if n_fwd["encoder"] < 1 or n_fwd["cross_encoder"] != want_ce:
        raise AssertionError(f"forwards on cuda {n_fwd}; expected >= 1 encoder and "
                             f"{want_ce} cross-encoder forwards")
    cands = engine.search_batch(q32, mode="hybrid", candidates=CANDIDATES,
                                top_k=CANDIDATES)
    for q, got, cand in zip(q32, hits, cands):
        if len(got) != 5 or len(cand) != CANDIDATES:
            raise AssertionError(f"{q!r}: {len(got)} reranked hits of "
                                 f"{len(cand)} candidates")
        if not {h.row for h in got} <= {h.row for h in cand}:
            raise AssertionError(f"{q!r}: a reranked row is not among the hybrid "
                                 f"top-{CANDIDATES}")
        if not all(np.isfinite(h.score) and h.recall_type == "reranked" for h in got):
            raise AssertionError(f"{q!r}: reranked hits malformed")
    log(f"[semantic] search_batch(hybrid, rerank, candidates {CANDIDATES}, top_k 5) "
        f"B={len(q32)}: launches {counts}, forwards on cuda {n_fwd}; every top-5 "
        f"lies in its query's hybrid top-{CANDIDATES}")

    # dense_topk at this path's shape (D = 256) against its plain version
    targs = calls["tile"]
    kv, ki = dt.tile_topk(*targs)
    pv, pi = dt.tile_topk_plain(*targs)
    torch.cuda.synchronize()
    err = _compare(kv, ki, pv, pi, exact=True, tol=0.0)
    q8, n, tile, kt = targs[0], targs[6], targs[7], targs[8]
    b = q8.shape[0]
    k_ms = cuda_ms(lambda: dt.tile_topk(*targs))
    p_ms = cuda_ms(lambda: dt.tile_topk_plain(*targs), reps=10)
    keep = targs[5] if targs[5] is not None else torch.ones(n, dtype=torch.bool,
                                                             device=DEVICE)
    lib_ms = cuda_ms(lambda: library_topk(*targs[:4], keep, n, tile, kt), reps=10)
    num_tiles = kv.shape[0]
    nbytes = n * dim + n * 4 + n + b * dim + b * 4 + num_tiles * b * kt * 8
    k_bound, k_by = bound_ms(nbytes, 2.0 * b * n * dim, INT8_OPS_PER_S)
    log(f"[semantic] dense_topk tensor-core kernel vs plain [num_tiles={num_tiles}, "
        f"B={b}, D={dim}, kt={kt}]: bit-equal (max |diff| {err}); kernel {k_ms:.3f} ms, "
        f"plain {p_ms:.3f} ms, library (_int_mm + topk) {lib_ms:.3f} ms, bound "
        f"{k_bound:.3f} ms ({k_by})")
    results["dense_topk"]["semantic"] = {
        "launches": counts["dense_topk_tc"], "batch": b, "dim": dim,
        "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": k_bound,
        "bound_by": k_by, "library_ms": lib_ms}

    # a. chunk embedding, 65,536 texts at [128, 128]
    chunks = texts_all[:SEM_CHUNKS]
    ids, mask = enc.tokenizer.encode_batch(chunks[:SEM_CHUNK_BATCH], max_len=seq)
    if ids.shape != (SEM_CHUNK_BATCH, seq):
        raise AssertionError(f"chunk batch tokenized to {ids.shape}")
    ids_d, mask_d = torch.from_numpy(ids).to(DEVICE), torch.from_numpy(mask).to(DEVICE)
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: enc.model(ids_d, mask_d))
        fwd_busy = device_busy(lambda: enc.model(ids_d, mask_d), fwd_ms)
    enc.embed_device(chunks[:SEM_CHUNK_BATCH])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb = enc.embed_device(chunks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    for lo in range(0, len(chunks), SEM_CHUNK_BATCH):
        enc.tokenizer.encode_batch(chunks[lo:lo + SEM_CHUNK_BATCH], max_len=seq)
    tok_s = time.perf_counter() - t0
    if tuple(emb.shape) != (len(chunks), dim) or not bool(torch.isfinite(emb).all()):
        raise AssertionError("chunk embeddings malformed")
    norms = emb.norm(dim=1)
    if float((norms - 1).abs().max()) > 1e-3:
        raise AssertionError("chunk embeddings are not unit-norm")
    e_flops = encoder_flops(SEM_CHUNK_BATCH, seq, cfg)
    e_bound, e_by = encoder_bound(SEM_CHUNK_BATCH, seq, enc.model, e_flops)
    log(f"[semantic] a. EncoderService.embed_device of {len(chunks)} chunks at "
        f"[{SEM_CHUNK_BATCH}, {seq}]: {wall:.3f} s, {len(chunks) / wall:.0f} chunks/s "
        f"(host tokenization alone {tok_s:.3f} s); TextEncoder forward "
        f"[{SEM_CHUNK_BATCH}, {seq}] {fwd_ms:.3f} ms ({SEM_CHUNK_BATCH / fwd_ms * 1e3:.0f} "
        f"chunks/s on the card), {fwd_busy}, {e_flops / 1e9:.2f} GFLOP, bound "
        f"{e_bound:.3f} ms ({e_by})")
    del emb

    # b. query embedding, B = 512
    qemb_ms = host_ms(lambda: enc.embed(queries), reps=10)
    qids, _ = enc.tokenizer.encode_batch(queries[:SEM_CHUNK_BATCH], max_len=seq)
    q_flops = encoder_flops(SEM_CHUNK_BATCH, qids.shape[1], cfg)
    q_bound, q_by = encoder_bound(SEM_CHUNK_BATCH, qids.shape[1], enc.model, q_flops)
    log(f"[semantic] b. EncoderService.embed of {len(queries)} queries: {qemb_ms:.3f} ms "
        f"({len(queries) // SEM_CHUNK_BATCH} forwards at [{SEM_CHUNK_BATCH}, "
        f"{qids.shape[1]}], each {q_flops / 1e9:.2f} GFLOP, bound {q_bound:.3f} ms ({q_by}))")

    # c. hybrid + rerank, B = 32, and its stages
    q_emb = engine._embed(q32)
    cand_texts = [[h.text for h in c] for c in cands]
    c_ms = interleaved_ms({
        "total": lambda: engine.search_batch(q32, mode="hybrid", rerank=True,
                                             candidates=CANDIDATES, top_k=5),
        "embed": lambda: engine._embed(q32),
        "search_hybrid": lambda: idx.search_hybrid(q_emb, q32, k=CANDIDATES,
                                                   candidates=CANDIDATES),
        "rerank": lambda: [rr(q, t) for q, t in zip(q32, cand_texts)],
    })
    pids, pmask, ptt = rr.tokenizer.encode_pairs([q32[0]] * SEM_RERANK_BATCH,
                                                 cand_texts[0][:SEM_RERANK_BATCH],
                                                 max_len=rr.max_len)
    if pids.shape != (SEM_RERANK_BATCH, seq):
        raise AssertionError(f"rerank pairs tokenized to {pids.shape}, not the "
                             f"{seq} bucket")
    pargs = [torch.from_numpy(a).to(DEVICE) for a in (pids, pmask, ptt)]
    with torch.inference_mode():
        ce_ms = cuda_ms(lambda: rr.model(*pargs))
        ce_busy = device_busy(lambda: rr.model(*pargs), ce_ms)
    t0 = time.perf_counter()
    for q, t in zip(q32, cand_texts):
        rr.tokenizer.encode_pairs([q] * len(t), t, max_len=rr.max_len)
    pair_tok_ms = (time.perf_counter() - t0) * 1e3
    c_flops = encoder_flops(SEM_RERANK_BATCH, seq, cfg, pooler=True)
    c_bound, c_by = encoder_bound(SEM_RERANK_BATCH, seq, rr.model, c_flops)
    log(f"[semantic] c. search_batch(hybrid, rerank=True, candidates {CANDIDATES}, "
        f"top_k 5) B={len(q32)}: {c_ms['total']:.3f} ms; stages (each alone, in "
        f"turn): embed {c_ms['embed']:.3f} ms, search_hybrid "
        f"{c_ms['search_hybrid']:.3f} ms, rerank {c_ms['rerank']:.3f} ms (pair "
        f"tokenization {pair_tok_ms:.3f} ms; {want_ce} CrossEncoder forwards at "
        f"[{SEM_RERANK_BATCH}, {seq}], each {ce_ms:.3f} ms, {ce_busy}, "
        f"{c_flops / 1e9:.2f} GFLOP, bound {c_bound:.3f} ms ({c_by})), rest "
        f"{c_ms['total'] - c_ms['embed'] - c_ms['search_hybrid'] - c_ms['rerank']:.3f} ms")

    # d. hybrid without rerank, B = 512
    q_emb512 = engine._embed(queries)
    d_ms = interleaved_ms({
        "total": lambda: engine.search_batch(queries, mode="hybrid", top_k=TOP_K),
        "embed": lambda: engine._embed(queries),
        "search_hybrid": lambda: idx.search_hybrid(q_emb512, queries, k=CANDIDATES,
                                                   candidates=CANDIDATES),
    })
    log(f"[semantic] d. search_batch(hybrid, top_k {TOP_K}) B={len(queries)}: "
        f"{d_ms['total']:.3f} ms; stages (each alone, in turn): embed "
        f"{d_ms['embed']:.3f} ms, search_hybrid {d_ms['search_hybrid']:.3f} ms, rest "
        f"{d_ms['total'] - d_ms['embed'] - d_ms['search_hybrid']:.3f} ms")

    # e. served: 64 requests through QueryBatcher(max_batch=32) with rerank
    requests = list(dict.fromkeys(queries))[:SEM_SERVE_REQUESTS]
    batcher = QueryBatcher(max_batch=SEM_RERANK_QUERIES)

    async def serve():
        return await asyncio.gather(*(batcher.search(
            engine, t, mode="hybrid", rerank=True, candidates=CANDIDATES, top_k=5)
            for t in requests))

    try:
        _reset_counts()
        t0 = time.perf_counter()
        answers = asyncio.run(serve())
        serve_s = time.perf_counter() - t0
        served_counts = _counts()
    finally:
        batcher.close()
    stats = batcher.stats()
    if served_counts["dense_topk_tc"] != stats["dispatches"]:
        raise AssertionError(f"served launches {served_counts} != dispatches {stats}")
    worst = 0.0
    for text, got in zip(requests, answers):
        want = engine.search_batch([text], mode="hybrid", rerank=True,
                                   candidates=CANDIDATES, top_k=5)[0]
        if [h.row for h in got] != [h.row for h in want] or len(got) != 5:
            raise AssertionError(f"served answer differs for {text!r}")
        worst = max(worst, _close(torch.tensor([h.score for h in got]),
                                  torch.tensor([h.score for h in want]), 2e-2))
    log(f"[semantic] e. {len(requests)} concurrent requests (rerank) through "
        f"QueryBatcher(max_batch={SEM_RERANK_QUERIES}) in {serve_s:.3f} s: "
        f"{stats['dispatches']} dispatches, dense_topk launches "
        f"{served_counts['dense_topk_tc']}; every answer has the rows of a direct "
        f"search_batch, scores within {worst:.3g} (1 + |s|) (limit 2e-2)")


# -- the CSR lexical tier at the north star's 10M chunks -----------------------

def _compare_rel(got_v, got_i, ref_v, ref_i, rtol: float, scores) -> float:
    """Raise unless two top-k lists agree as tests/torch_parity.py holds
    them: the same -inf slots, finite values within ``rtol`` relative,
    and an id that differs only where its ``scores`` value (the reference
    scorer's [B, N] scores) lies within that tolerance of the slot's
    reference value (a tie).  Returns the largest relative difference."""
    fin = torch.isfinite(ref_v)
    if not torch.equal(fin, torch.isfinite(got_v)):
        raise AssertionError("the two lists disagree on empty slots")
    ref0 = torch.where(fin, ref_v, 0.0)
    tol = rtol * ref0.abs()
    diff = torch.where(fin, (got_v - ref_v).abs(), 0.0)
    if bool((diff > tol).any()):
        raise AssertionError(f"scores differ by {float(diff.max())} > {rtol} relative")
    got_s = torch.gather(scores, 1, torch.where(fin, got_i, 0).long())
    bad = fin & (got_i != ref_i) & ((got_s - ref0).abs() > 2 * tol)
    if bool(bad.any()):
        raise AssertionError(f"{int(bad.sum())} ids differ away from any tie")
    rel = diff / ref0.abs().clamp(min=1e-30)
    return float(rel.max()) if rel.numel() else 0.0


def _bm25_all_scores(idx, qt, qi, step: int = 1 << 20) -> torch.Tensor:
    """Exact doc-major BM25 of every live row for each query ``[B, N]``,
    in row blocks (the doc-major scorer of ops/bm25.py)."""
    from super_rag_tpu_torch.ops.bm25 import _bm25_block, _idf_table, clamp_avgdl

    table = _idf_table(qt, qi, idx.spec.vocab_size)
    avgdl = clamp_avgdl(idx.df.avgdl, qt.device)
    n = idx.size
    out = torch.empty((qt.shape[0], n), dtype=torch.float32, device=qt.device)
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        out[:, lo:hi] = _bm25_block(table, idx.terms[lo:hi], idx.tfs[lo:hi],
                                    idx.doc_len[lo:hi], avgdl, 1.2, 0.75)
    return out


def _ranked_topk(scores: torch.Tensor, k: int):
    """Top-``k`` per row, value descending and lowest index first among
    ties (a topk of a little more, then a stable re-sort)."""
    v, i = torch.topk(scores, min(scores.shape[1], 4 * k))
    i, order = torch.sort(i, dim=1)
    v = torch.gather(v, 1, order)
    v, order = torch.sort(v, dim=1, descending=True, stable=True)
    return v[:, :k], torch.gather(i, 1, order)[:, :k].to(torch.int32)


def _csr_stages(idx, q_emb, texts, opts: dict, reps: int) -> dict:
    """search_hybrid at one batch, and its stages each timed alone: host
    query analysis, the dense branch (its kernel apart), the CSR gather,
    the sort + segment sum + top-k (with the shard merge), and the rest
    (exact rescore + RRF + glue) as the remainder."""
    from super_rag_tpu_torch.ops import bm25_inverted as bi
    from super_rag_tpu_torch.ops import dense_topk as dt

    calls: dict = {}
    with mock.patch.object(dt, "tile_topk", _recording(calls, "tile", dt.tile_topk)):
        idx.search_hybrid(q_emb, texts, k=TOP_K, candidates=CANDIDATES, **opts)
    total = host_ms(lambda: idx.search_hybrid(q_emb, texts, k=TOP_K,
                                              candidates=CANDIDATES, **opts), reps=reps)
    t0 = time.perf_counter()
    qt, qi = idx._query_arrays(texts, 16)
    analysis = (time.perf_counter() - t0) * 1e3
    corpus, mask = idx.dense_corpus(), idx._mask(None)
    dense = cuda_ms(lambda: dt.dense_topk(q_emb, corpus, CANDIDATES, mask=mask, tile=2048,
                                          int8_queries=True, per_tile_k=idx._per_tile_k,
                                          device=DEVICE), reps=reps)
    targs = calls["tile"]
    kernel = cuda_ms(lambda: dt.tile_topk(*targs), reps=reps)
    def gather():
        return bi._csr_gather_budgets(qt, qi, idx._inverted, mask,
                                      opts["postings_per_query_term"],
                                      opts["lex_deep_terms"], opts["lex_deep_postings"])

    ids, w = gather()
    k_gen = min(opts["lex_gen"], idx.size)
    stages = {
        "total": total, "host query analysis": analysis,
        "dense branch": dense, "dense_topk kernel": kernel,
        "CSR gather": cuda_ms(gather, reps=reps),
        "sort + segment sum + top-k": cuda_ms(lambda: bi._csr_aggregate(ids, w, k_gen),
                                              reps=reps),
        "width": int(ids.shape[-1]) * (ids.shape[1] if ids.dim() == 3 else 1),
    }
    stages["rest (rescore + RRF)"] = (total - analysis - dense - stages["CSR gather"]
                                      - stages["sort + segment sum + top-k"])
    return stages


def _log_stages(tag: str, b: int, st: dict) -> None:
    log(f"[csr] {tag} search_hybrid B={b}: {st['total']:.3f} ms "
        f"({b / st['total'] * 1e3:.1f} queries/s); stages (each alone): host query "
        f"analysis {st['host query analysis']:.3f} ms, dense branch "
        f"{st['dense branch'] - st['dense_topk kernel']:.3f} ms + kernel "
        f"{st['dense_topk kernel']:.3f} ms, CSR gather {st['CSR gather']:.3f} ms "
        f"({st['width']} postings a query), sort + segment sum + top-k "
        f"{st['sort + segment sum + top-k']:.3f} ms, rest (rescore + RRF) "
        f"{st['rest (rescore + RRF)']:.3f} ms")


def phase_csr(results: dict) -> None:
    """The north star's lexical scale on the card: 10,002,432 rows x 768
    int8 with a 48-slot zipfian doc-term table (scripts/bench_10m.py's
    lexical recipe, no pad slots; the 1M smoke's flat dense tier in place
    of its IVF).  compact_lexical must pick the CSR tier by itself; then
    search_hybrid at B = 512 and 32 with the 10M budgets, unsharded and
    with 16 doc shards, gated: (a) CSR generation at full coverage is the
    exact doc-major BM25 top-k, (b) the 16-shard build gives the same, (c)
    the dense_topk kernel launched inside search_hybrid is bit-equal to its
    plain version, (d) dense recall@10 >= 0.9; hybrid fidelity against an
    exact hybrid gold >= 0.8."""
    import dataclasses

    from super_rag_tpu_torch.engine.index import DeviceIndex
    from super_rag_tpu_torch.ops import dense_topk as dt
    from super_rag_tpu_torch.ops.bm25_inverted import (
        CSRInvertedIndex, _shard_depth, inverted_bm25_search)
    from super_rag_tpu_torch.ops.fusion import rrf_fuse

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    arrays, host, ranks, df_host = make_corpus(CSR_ROWS, gen, dim=DIM, slots=CSR_SLOTS,
                                               vocab=VOCAB, pad=0.0)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx = DeviceIndex.from_snapshot(arrays, host, device=DEVICE)
    del arrays, host
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    if idx.spec.lex_tier != "auto" or idx.size < idx.spec.csr_auto_rows:
        raise AssertionError("the 10M index is not on the auto tier past csr_auto_rows")
    t0 = time.perf_counter()
    idx.compact_lexical()
    torch.cuda.synchronize()
    t_compact = time.perf_counter() - t0
    csr = idx._inverted
    if not isinstance(csr, CSRInvertedIndex) or csr.shards != 1:
        raise AssertionError(f"compact_lexical at {idx.size} rows built {type(csr).__name__}")
    e = csr.postings_docs.shape[0]
    csr_bytes = e * 6 + csr.offsets.numel() * 4
    log(f"[csr] on {results['card']}: corpus {CSR_ROWS} x {DIM} int8 + {CSR_SLOTS}-slot zipfian table (V = "
        f"{VOCAB}, no pad slots) made on the card in {t_gen:.2f} s; DeviceIndex in "
        f"{t_load:.2f} s (capacity {idx._capacity}); compact_lexical with lex_tier "
        f"'auto' picked {type(csr).__name__} (csr_auto_rows {idx.spec.csr_auto_rows}): "
        f"{t_compact:.2f} s with the per_tile_k calibration (-> {idx._per_tile_k}); "
        f"{e} postings, {csr_bytes / 1e9:.3f} GB of CSR arrays; card memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB at peak in this phase")

    q_all = torch.randn(CSR_BATCH, DIM, device=DEVICE, generator=gen)
    texts = make_query_texts(ranks, df_host, gen, CSR_BATCH, terms=CSR_QUERY_TERMS,
                             vocab=VOCAB)
    del ranks
    opts = dict(postings_per_query_term=CSR_PQ, lex_deep_terms=CSR_DEEP_TERMS,
                lex_deep_postings=CSR_DEEP_POSTINGS, lex_gen=CSR_LEX_GEN, rescore=True)

    # the main path, counted: search_hybrid at B = 512 on the CSR tier
    calls: dict = {}
    _reset_counts()
    with mock.patch.object(dt, "tile_topk", _recording(calls, "tile", dt.tile_topk)):
        res = idx.search_hybrid(q_all, texts, k=TOP_K, candidates=CANDIDATES, **opts)
    torch.cuda.synchronize()
    counts = _counts()
    if counts["dense_topk_tc"] < 1:
        raise AssertionError(f"search_hybrid on the CSR tier launched {counts}")
    ids = res.indices.cpu().numpy()
    if (ids.shape != (CSR_BATCH, TOP_K) or ids.min() < 0
            or not np.isfinite(res.scores.cpu().numpy()).all()):
        raise AssertionError("CSR hybrid result has the wrong shape or empty slots")

    # (c) the kernel inside that call against its plain version
    targs = calls["tile"]
    kv, ki = dt.tile_topk(*targs)
    pv, pi = dt.tile_topk_plain(*targs)
    torch.cuda.synchronize()
    k_err = _compare(kv, ki, pv, pi, exact=True, tol=0.0)
    q8, n_scan, tile, kt = targs[0], targs[6], targs[7], targs[8]
    num_tiles = kv.shape[0]
    del kv, ki, pv, pi
    k_ms = cuda_ms(lambda: dt.tile_topk(*targs))
    p_ms = cuda_ms(lambda: dt.tile_topk_plain(*targs), reps=5, warmup=1)
    keep = targs[5] if targs[5] is not None else torch.ones(n_scan, dtype=torch.bool,
                                                             device=DEVICE)
    lib_ms = cuda_ms(lambda: library_topk(*targs[:4], keep, n_scan, tile, kt), reps=5,
                     warmup=1)
    b = q8.shape[0]
    nbytes = (n_scan * DIM + n_scan * 4 + n_scan + b * DIM + b * 4
              + num_tiles * b * kt * 8)
    k_bound, k_by = bound_ms(nbytes, 2.0 * b * n_scan * DIM, INT8_OPS_PER_S)
    log(f"[csr] (c) dense_topk inside search_hybrid B={b} [num_tiles={num_tiles}, "
        f"kt={kt}]: launches {counts}; bit-equal to its plain version (max |diff| "
        f"{k_err}); kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, library (_int_mm + topk, "
        f"in 32-tile chunks) {lib_ms:.3f} ms, bound {k_bound:.3f} ms ({k_by}; "
        f"{nbytes / 1e9:.2f} GB, {2.0 * b * n_scan * DIM / 1e12:.2f} T int8 operations)")
    results["dense_topk_10m"] = {
        "variant": "tc (mma.sync m16n8k32 s8)", "launches": counts["dense_topk_tc"],
        "rows": n_scan, "batch": b, "max_abs_err": k_err, "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": k_bound, "bound_by": k_by, "library_ms": lib_ms}

    # exact references for 64 queries: BM25 scores of every row, the exact
    # BM25 and dense top-100, and the exact hybrid (RRF of the two)
    ev = CSR_EVAL_QUERIES
    qt, qi = idx._query_arrays(texts[:ev], 16)
    mask = idx._mask(None)
    corpus = idx.dense_corpus()
    full_bm25 = _bm25_all_scores(idx, qt, qi)
    gold_lv, gold_li = _ranked_topk(full_bm25, CANDIDATES)
    gold_lex = torch.where(gold_lv > 0, gold_li, -1)
    gold_di = exact_topk(q_all[:ev], corpus, mask, idx.size, k=CANDIDATES)
    gold_hyb = rrf_fuse(gold_di.to(torch.int32), gold_lex, k=TOP_K)[1]

    # (a) full coverage: a budget at the longest run of the gate queries'
    # terms makes CSR generation exact BM25
    g = CSR_GATE_QUERIES
    qg, qig = qt[:g], qi[:g]
    live = qg < VOCAB
    runs = (csr.offsets[qg.long() + 1] - csr.offsets[qg.long()])[live]
    budget = int(runs.max())
    t0 = time.perf_counter()
    cv, ci = inverted_bm25_search(qg, qig, csr, k=CANDIDATES, mask=mask,
                                  postings_per_query_term=budget)
    torch.cuda.synchronize()
    t_full = time.perf_counter() - t0
    rv = torch.where(gold_lv[:g] > 0, gold_lv[:g], float("-inf"))
    a_err = _compare_rel(cv, ci, rv, gold_lex[:g], CSR_BF16_RTOL, full_bm25[:g])
    # the unsharded tier's own scores of its top-4096, the tie rule of (b)
    uv, ui = inverted_bm25_search(qg, qig, csr, k=4096, mask=mask,
                                  postings_per_query_term=budget)
    csr_scores = torch.full((g, idx.size), float("-inf"), device=DEVICE)
    csr_scores.scatter_(1, ui.clamp(min=0).long(), torch.where(ui >= 0, uv, float("-inf")))
    del uv, ui
    log(f"[csr] (a) {g} queries at full coverage (budget {budget} = the longest run of "
        f"their terms, {int(live.sum())} terms, {t_full:.3f} s): CSR generation top-"
        f"{CANDIDATES} = the exact doc-major BM25 top-{CANDIDATES}: ids equal up to ties, "
        f"scores within {a_err:.3g} relative (limit {CSR_BF16_RTOL:.3g}: bf16 impacts)")

    # lexical generation overlap and hybrid fidelity over the 64 queries
    gen_v, gen_i = inverted_bm25_search(qt, qi, csr, k=CSR_LEX_GEN, mask=mask,
                                        postings_per_query_term=CSR_PQ,
                                        deep_terms=CSR_DEEP_TERMS,
                                        deep_postings=CSR_DEEP_POSTINGS)
    lex_overlap = float(np.mean([
        len(set(a) & {x for x in gl if x >= 0}) / max(1, sum(1 for x in gl if x >= 0))
        for a, gl in zip(gen_i.cpu().tolist(), gold_lex.cpu().tolist())]))
    fidelity = recall_at_k(res.indices[:ev], gold_hyb)
    _, got_d = dt.dense_topk(q_all[:ev], corpus, TOP_K, mask=mask, tile=2048,
                             int8_queries=True, per_tile_k=idx._per_tile_k, device=DEVICE)
    recall = recall_at_k(got_d, gold_di[:, :TOP_K])
    log(f"[csr] {ev} queries: lexical generation (pq {CSR_PQ} + deep {CSR_DEEP_TERMS} x "
        f"{CSR_DEEP_POSTINGS}, top-{CSR_LEX_GEN}) holds {lex_overlap:.4f} of the exact BM25 "
        f"top-{CANDIDATES}; hybrid top-{TOP_K} fidelity against the exact hybrid (RRF of the "
        f"exact dense and exact BM25 top-{CANDIDATES}) {fidelity:.4f} (gate 0.8); (d) dense "
        f"recall@{TOP_K} vs exact f32 over the stored rows {recall:.4f} (gate 0.9)")
    if fidelity < 0.8:
        raise AssertionError(f"hybrid fidelity {fidelity} < 0.8")
    if recall < 0.9:
        raise AssertionError(f"dense recall@{TOP_K} {recall} < 0.9")
    del full_bm25, gen_v, gen_i

    # stage times, unsharded
    stages = {}
    for bb in (CSR_BATCH, CSR_SMALL_BATCH):
        stages[(1, bb)] = _csr_stages(idx, q_all[:bb], texts[:bb], opts,
                                      reps=10 if bb == CSR_BATCH else 20)
        _log_stages("C=1", bb, stages[(1, bb)])

    # (b) 16 doc shards: the same index recompacted, full coverage equal
    idx.spec = dataclasses.replace(idx.spec, csr_shards=CSR_SHARDS)
    del csr
    t0 = time.perf_counter()
    idx.compact_lexical()
    torch.cuda.synchronize()
    t_compact16 = time.perf_counter() - t0
    csr16 = idx._inverted
    if not isinstance(csr16, CSRInvertedIndex) or csr16.shards != CSR_SHARDS:
        raise AssertionError("the csr_shards=16 compaction did not build 16 shards")
    lens = (csr16.offsets[:, qg.long() + 1] - csr16.offsets[:, qg.long()])
    depth = _shard_depth(budget, CSR_SHARDS)
    if int(lens.max()) > depth:
        raise AssertionError(f"a shard run of {int(lens.max())} > the shard depth {depth}")
    sv, si = inverted_bm25_search(qg, qig, csr16, k=CANDIDATES, mask=mask,
                                  postings_per_query_term=budget)
    b_err = _compare_rel(sv, si, cv, ci, 1e-6, csr_scores)
    log(f"[csr] (b) csr_shards={CSR_SHARDS}: compact_lexical {t_compact16:.2f} s; at full "
        f"coverage (per-shard depth {depth} >= the longest shard run {int(lens.max())}) "
        f"the result equals the unsharded one: ids up to ties, scores within "
        f"{b_err:.3g} relative (limit 1e-6)")
    res16 = idx.search_hybrid(q_all, texts, k=TOP_K, candidates=CANDIDATES, **opts)
    fid16 = recall_at_k(res16.indices[:ev], gold_hyb)
    log(f"[csr] C={CSR_SHARDS} hybrid fidelity {fid16:.4f}; rows equal to C=1 for "
        f"{int((res16.indices == res.indices).all(1).sum())} of {CSR_BATCH} queries")
    for bb in (CSR_BATCH, CSR_SMALL_BATCH):
        stages[(CSR_SHARDS, bb)] = _csr_stages(idx, q_all[:bb], texts[:bb], opts,
                                               reps=10 if bb == CSR_BATCH else 20)
        _log_stages(f"C={CSR_SHARDS}", bb, stages[(CSR_SHARDS, bb)])
    results["csr"] = {"fidelity": fidelity, "lex_overlap": lex_overlap, "recall": recall,
                      "stages": {f"C={c} B={bb}": st for (c, bb), st in stages.items()}}
    del idx, res, res16


# -- the engine layer under the serving seam ---------------------------------

def phase_engine(results: dict) -> None:
    """EngineManager (Settings with its data directory in a temporary
    directory outside the repo, a LocalObjectStore as its snapshot
    store) builds an engine from a collection config with ``hybrid``
    keys; 65,536 texts go in through CollectionEngine.ingest (timed, the
    analyzer's share with the native path and with the Python loop); the
    index is snapshotted to the store and a fresh manager restores it from
    the store alone; the restored engine's hybrid answers must equal the
    original's, and batched_search through a QueryBatcher must equal a
    direct search."""
    import dataclasses
    import shutil
    import tempfile

    from super_rag_tpu_torch.config import Settings
    from super_rag_tpu_torch.engine.batcher import QueryBatcher, batched_search
    from super_rag_tpu_torch.engine.manager import EngineManager
    from super_rag_tpu_torch.engine.snapshot import snapshot_exists, store_snapshot_exists
    from super_rag_tpu_torch.store.objectstore import LocalObjectStore
    from super_rag_tpu_torch.tokenize import native
    from super_rag_tpu_torch.tokenize.analyzer import Analyzer

    if not native.available():
        raise AssertionError("the native analyzer did not build here (g++)")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_engine_")
    try:
        store = LocalObjectStore(os.path.join(tmp, "objects"))
        config = {"embedding": {"dim": DIM}, "index_dtype": "int8", "bm25_slots": SLOTS,
                  "vocab_size": VOCAB,
                  "hybrid": {"rescore": True, "postings_per_query_term": 768,
                             "lex_deep_terms": 2, "lex_deep_postings": 4096}}

        def manager(name):
            m = EngineManager(dataclasses.replace(Settings(),
                                                  data_dir=os.path.join(tmp, name)),
                              device=DEVICE)
            m.snapshot_store = store
            return m

        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
        ranks = ((_zipf(gen, 1.3, (ENGINE_TEXTS, SLOTS)) - 1) % VOCAB).to(torch.int32)
        tfs = torch.clamp(_zipf(gen, 2.0, (ENGINE_TEXTS, SLOTS)), max=4)
        texts = row_texts(ranks, tfs, ENGINE_WORDS)
        queries = list(dict.fromkeys(" ".join(t.split()[3:7]) for t in texts[::509]))
        queries = queries[:ENGINE_QUERIES]
        del ranks, tfs

        analyzer_s = {"t": 0.0}
        real = Analyzer.batch_doc_entries

        def timed(self, *a, **kw):
            t0 = time.perf_counter()
            try:
                return real(self, *a, **kw)
            finally:
                analyzer_s["t"] += time.perf_counter() - t0

        def ingest(eng, **kw):
            analyzer_s["t"] = 0.0
            with mock.patch.object(Analyzer, "batch_doc_entries",
                                   lambda self, t, s: timed(self, t, s, **kw)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for lo in range(0, len(texts), ENGINE_INGEST_BATCH):
                    eng.ingest(texts[lo:lo + ENGINE_INGEST_BATCH])
                torch.cuda.synchronize()
                return time.perf_counter() - t0, analyzer_s["t"]

        m1 = manager("a")
        eng = m1.get("c", config)
        if (eng.hybrid_opts != config["hybrid"]
                or eng.index.device.type != torch.device(DEVICE).type):
            raise AssertionError(f"engine built with {eng.hybrid_opts} on {eng.index.device}")
        wall, ana = ingest(eng)
        py_eng = manager("p").get("py", config)
        py_wall, py_ana = ingest(py_eng, prefer_native=False)
        if not (torch.equal(py_eng.index.terms, eng.index.terms)
                and torch.equal(py_eng.index.tfs, eng.index.tfs)):
            raise AssertionError("the native and Python analyzers indexed other terms")
        del py_eng
        log(f"[engine] on {results['card']}: EngineManager engine (int8, {DIM}-dim hash embedder, hybrid keys "
            f"{sorted(config['hybrid'])}) ingested {len(texts)} texts of {ENGINE_WORDS} "
            f"words in batches of {ENGINE_INGEST_BATCH}: {wall:.3f} s, "
            f"{len(texts) / wall:.0f} chunks/s, analyzer {ana:.3f} s ({ana / wall:.1%}, "
            f"native); with prefer_native=False {py_wall:.3f} s, "
            f"{len(texts) / py_wall:.0f} chunks/s, analyzer {py_ana:.3f} s "
            f"({py_ana / py_wall:.1%}); both indexed the same terms and tfs")

        t0 = time.perf_counter()
        want = eng.search_batch(queries, top_k=TOP_K)
        t_first = time.perf_counter() - t0
        m1.snapshot("c")
        if not store_snapshot_exists(store, "snapshots/c"):
            raise AssertionError("the snapshot did not reach the store")
        m2 = manager("b")  # a fresh machine: no file snapshot
        if snapshot_exists(m2._snapshot_path("c")):
            raise AssertionError("the fresh manager sees a file snapshot")
        t0 = time.perf_counter()
        restored = m2.get("c", config)
        t_restore = time.perf_counter() - t0
        if restored.index.size != eng.index.size or restored is eng:
            raise AssertionError("the store restore holds other rows")
        _reset_counts()
        got = restored.search_batch(queries, top_k=TOP_K)
        torch.cuda.synchronize()
        counts = _counts()
        if counts["dense_topk_tc"] < 1:
            raise AssertionError(f"the restored engine's search launched {counts}")
        for q, g_, w_ in zip(queries, got, want):
            if ([(h.row, h.score) for h in g_] != [(h.row, h.score) for h in w_]
                    or len(g_) != TOP_K):
                raise AssertionError(f"restored answer differs for {q!r}: "
                                     f"{[(h.row, h.score) for h in g_]} vs "
                                     f"{[(h.row, h.score) for h in w_]}")
        batcher = QueryBatcher(max_batch=32)

        async def serve():
            return await asyncio.gather(*(batched_search({"batcher": batcher}, restored,
                                                         q, top_k=TOP_K) for q in queries))

        try:
            served = asyncio.run(serve())
        finally:
            batcher.close()
        for q, s_ in zip(queries, served):
            direct = restored.search(q, top_k=TOP_K)
            if [(h.row, h.score) for h in s_] != [(h.row, h.score) for h in direct]:
                raise AssertionError(f"batched_search differs from a direct search for {q!r}")
        log(f"[engine] snapshot to the LocalObjectStore and restore by a fresh manager "
            f"from the store alone ({t_restore:.3f} s); the restored engine's "
            f"search_batch(hybrid) of {len(queries)} queries equals the original's "
            f"(first search {t_first:.3f} s with the lexical compaction; launches "
            f"{counts}); {len(queries)} batched_search requests through "
            f"QueryBatcher(max_batch=32) in {batcher.stats()['dispatches']} dispatches "
            f"equal direct searches")
        results["engine"] = {"chunks_per_s": len(texts) / wall,
                             "analyzer_share": ana / wall,
                             "chunks_per_s_python": len(texts) / py_wall,
                             "analyzer_share_python": py_ana / py_wall}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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

    import threading

    from super_rag_tpu_torch import _build
    from super_rag_tpu_torch.tokenize import native

    t0 = time.perf_counter()
    # the native analyzer (g++) builds while nvcc builds the kernels
    analyzer_build = threading.Thread(target=native.load)
    analyzer_build.start()
    took = _build.build(["dense_topk", "ivf_scan"])  # one nvcc each, together
    analyzer_build.join()
    for name in ("dense_topk", "ivf_scan"):
        for ln in _build.build_logs.get(name, "").splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                log(f"[build] {name} ptxas: {ln.strip()}")
    log(f"[build] nvcc {took}, native analyzer {native.available()}, in "
        f"{time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    cases = phase_small()
    log(f"[small] dense_topk kernel vs plain version: {cases} cases agree "
        f"(int8 x int8 bit-equal) in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    cases = phase_small_ivf()
    log(f"[small] IVF kernels vs plain versions: {cases} cases agree in "
        f"{time.perf_counter() - t0:.2f} s")

    results: dict = {"card": smi}
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
    del idx, texts
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    phase_semantic(results)
    log(f"[semantic] phase in {time.perf_counter() - t0:.2f} s")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    phase_csr(results)
    log(f"[csr] phase in {time.perf_counter() - t0:.2f} s")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    phase_engine(results)
    log(f"[engine] phase in {time.perf_counter() - t0:.2f} s")

    source = "super_rag_tpu_torch/csrc/"
    kernels = {"kernels": [
        {"name": "dense_topk", "route": "cuda", "source": source + "dense_topk.cu",
         "replaces": "super_rag_tpu/ops/pallas_topk.py:36", **results["dense_topk"]},
        {"name": "dense_topk_10m", "route": "cuda", "source": source + "dense_topk.cu",
         "replaces": "super_rag_tpu/ops/pallas_topk.py:36", **results["dense_topk_10m"]},
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
