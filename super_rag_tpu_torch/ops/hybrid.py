"""Fused hybrid search: dense + BM25 + RRF (port of
the JAX package's ops/hybrid.py).

    dense scores  -> IVF tier (ops/ivf.py, ops/ivf_topk.py), per-tile
                     top-K (CUDA kernel, ops/dense_topk.py) or the
                     blocked exact search (ops/dense.py); optional
                     sign-plane refinement of the flat int8 pool
    bm25          -> inverted postings (+ doc-major fresh tail), or a
                     doc-major scan when there is no inverted snapshot
    rescore       -> exact BM25 of the fused candidate pool
    RRF           -> rank fusion of the two lists -> final top-k

The stages run back to back on the query's device with no host sync.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from super_rag_tpu_torch.device import DeviceLike, check_device
from super_rag_tpu_torch.ops.bm25 import (
    LexicalCorpus, _bm25_block, _blocked_topk, _idf_table, _sat, clamp_avgdl)
from super_rag_tpu_torch.ops.bm25_inverted import (
    CSRInvertedIndex, InvertedIndex, inverted_bm25_search)
from super_rag_tpu_torch.ops.dense import (
    DenseCorpus, Metric, dense_search, normalize_queries)
from super_rag_tpu_torch.ops.dense_topk import dense_topk
from super_rag_tpu_torch.ops.ivf import (
    IVFIndex, ivf_flat_topk, ivf_search, unpack_signs)
from super_rag_tpu_torch.ops.ivf_topk import ivf_topk
from super_rag_tpu_torch.ops.topk import NEG_INF, stable_topk

INT32_MAX = 2**31 - 1


class HybridResult(NamedTuple):
    scores: torch.Tensor  # [B, k] fused RRF scores
    indices: torch.Tensor  # [B, k] corpus rows (-1 = empty)
    dense_scores: torch.Tensor  # [B, k] dense score of each winner (0 if none)
    bm25_scores: torch.Tensor  # [B, k] bm25 score of each winner (0 if none)


def _rrf_on_device(dv, di, lv, li, k: int, rrf_k: float) -> HybridResult:
    """RRF of the dense and lexical lists with branch scores carried.
    Each match sum adds at most one nonzero term, so it is exact."""
    dev = di.device
    ka, kb = di.shape[1], li.shape[1]
    valid_a = torch.isfinite(dv)
    valid_b = torch.isfinite(lv) & (lv > 0)  # bm25 score 0 = no term match
    ia = torch.where(valid_a, di, -1)
    ib = torch.where(valid_b, li, -1)
    contrib_a = 1.0 / (rrf_k + torch.arange(ka, device=dev, dtype=torch.float32) + 1.0)
    contrib_b = 1.0 / (rrf_k + torch.arange(kb, device=dev, dtype=torch.float32) + 1.0)
    hit = ((ia[:, :, None] == ib[:, None, :])
           & valid_a[:, :, None] & valid_b[:, None, :])
    match = hit.to(torch.float32)
    score_a = torch.where(valid_a,
                          contrib_a[None, :] + (match * contrib_b).sum(-1),
                          NEG_INF)
    dup_b = hit.any(dim=1)
    score_b = torch.where(valid_b & ~dup_b, contrib_b[None, :], NEG_INF)
    scores = torch.cat([score_a, score_b], dim=1)
    ids = torch.cat([ia, ib], dim=1)
    lv0 = torch.where(valid_b, lv, 0.0)
    d_branch = torch.cat([torch.where(valid_a, dv, 0.0),
                          torch.zeros_like(lv)], dim=1)
    bm_for_a = (match * lv0[:, None, :]).sum(-1)
    b_branch = torch.cat([bm_for_a, lv0], dim=1)
    fv, pos = stable_topk(scores, min(k, ka + kb))
    fi = torch.gather(ids, -1, pos)
    fi = torch.where(fv > NEG_INF, fi, -1)
    return HybridResult(scores=fv, indices=fi,
                        dense_scores=torch.gather(d_branch, -1, pos),
                        bm25_scores=torch.gather(b_branch, -1, pos))


def _exact_bm25_rescore(pool_ids, query_terms, query_idf,
                        lexical: LexicalCorpus, avgdl, k1: float, b: float):
    """Exact BM25 of pooled candidates against their full doc-term rows:
    a loop over the L slots, each a [B, P, Q] one-hot match against the
    query terms.  Slot-level semantics of ``_bm25_block``."""
    safe = pool_ids.clamp(min=0).long()
    terms = lexical.terms[safe]  # [B, P, L]
    tfs = lexical.tfs[safe].to(torch.float32)
    dl = lexical.doc_len[safe].to(torch.float32)
    avgdl = clamp_avgdl(avgdl, pool_ids.device)
    acc = torch.zeros(pool_ids.shape, dtype=torch.float32,
                      device=pool_ids.device)
    for slot in range(terms.shape[2]):
        sat = _sat(tfs[:, :, slot], dl, avgdl, k1, b)
        hit = terms[:, :, slot, None] == query_terms[:, None, :]
        w = (hit.to(torch.float32) * query_idf[:, None, :]).sum(-1)
        acc = acc + w * sat
    return torch.where(pool_ids >= 0, acc, NEG_INF)


def _rescored_lexical_branch(dv, di, lv, li, query_terms, query_idf,
                             lexical: LexicalCorpus, avgdl, kc: int,
                             k1: float, b: float):
    """Re-rank the fused candidate pool by exact BM25 and return its top
    ``kc`` as the lexical branch.  The pool is sorted by doc id (invalids
    last) so adjacent compares dedup it and the stable top-k ranks ties
    lowest id first, as an exact doc-major scan does."""
    ia = torch.where(torch.isfinite(dv), di, -1).to(torch.int32)
    ib = torch.where(torch.isfinite(lv) & (lv > 0), li, -1).to(torch.int32)
    pool = torch.cat([ia, ib], dim=1)
    key = torch.where(pool >= 0, pool, INT32_MAX)
    order = torch.argsort(key, dim=-1, stable=True)
    pool = torch.gather(pool, -1, order)
    valid = pool >= 0
    dup = torch.zeros_like(valid)
    dup[:, 1:] = pool[:, 1:] == pool[:, :-1]
    s = _exact_bm25_rescore(pool, query_terms, query_idf, lexical, avgdl,
                            k1, b)
    s = torch.where(valid & ~dup & (s > 0), s, NEG_INF)
    lv2, pos = stable_topk(s, min(kc, pool.shape[1]))
    li2 = torch.gather(pool, -1, pos)
    return lv2, torch.where(torch.isfinite(lv2), li2, -1)


def hybrid_search(
    query_emb: torch.Tensor,  # [B, D] f32
    query_terms: torch.Tensor,  # [B, Q] int32 (pad = vocab_size)
    query_idf: torch.Tensor,  # [B, Q] f32
    dense: Optional[DenseCorpus],
    lexical: Optional[LexicalCorpus],
    avgdl,
    inverted: Optional[Union[InvertedIndex, CSRInvertedIndex]] = None,
    ivf: Optional[IVFIndex] = None,
    tail_lexical: Optional[LexicalCorpus] = None,
    tail_mask: Optional[torch.Tensor] = None,
    tail_offset: int = 0,
    *,
    vocab_size: int,
    k: int,
    candidates: int = 100,
    metric: Metric = Metric.COSINE,
    mask: Optional[torch.Tensor] = None,
    k1: float = 1.2,
    b: float = 0.75,
    rrf_k: float = 60.0,
    use_kernel: bool = False,
    dense_tile: int = 2048,
    block_size: int = 8192,
    bm25_block_size: int = 4096,
    postings_per_query_term: Optional[int] = None,
    int8_queries: bool = False,
    per_tile_k: Optional[int] = None,
    nprobe: int = 32,
    rescore: bool = True,
    lex_gen: Optional[int] = None,
    dense_gen: Optional[int] = None,
    num_docs: Optional[int] = None,
    lex_deep_terms: int = 0,
    lex_deep_postings: Optional[int] = None,
    lex_approx_topk: bool = False,
    dense_approx_topk: bool = False,
    dense_refine: int = 0,
    device: DeviceLike = None,
) -> HybridResult:
    """Hybrid top-k.  ``candidates`` is the per-branch recall depth
    feeding RRF.

    Dense branch tiers: IVF (``ivf`` given; bytes per query ~ nprobe /
    nlist) > fused per-tile top-k (``use_kernel``: ``ops/dense_topk.py``,
    the CUDA kernel for CUDA tensors) > blocked exact search.  Within the
    IVF tier, as in the reference: a batch whose probes could cover the
    index (B * nprobe >= nlist) scans every tile (``ivf_flat_topk``);
    otherwise ``use_kernel`` takes the probe-streaming kernels
    (``ivf_topk``), else the plain gather tier (``ivf_search``).
    ``dense_refine`` re-scores a deeper flat int8 pool with the corpus's
    error sign plane.  ``rescore`` (inverted path) re-scores the fused
    pool with exact BM25 before fusion; ``lex_gen`` deepens the lexical
    generation (default ``2 * candidates``).  ``inverted`` is the table or
    the CSR tier (``ops/bm25_inverted.py``); the rest of the program is
    the same for both.

    ``dense`` may be None when ``ivf`` serves the dense branch alone (no
    second flat copy of a large index); ``num_docs`` then gives the row
    count, and the flat-only ``dense_refine`` is skipped.
    ``lex_approx_topk`` / ``dense_approx_topk`` are accepted for the
    reference's contract; the port's top-k is exact either way.

    ``device`` (default CUDA) is where it runs; the corpora must already
    live there."""
    del lex_approx_topk, dense_approx_topk
    if dense is None:
        if ivf is None or num_docs is None:
            raise ValueError("hybrid_search needs a dense corpus, or an ivf "
                             "index and num_docs to serve the dense branch")
        dev = check_device(ivf.values, device)
        n = num_docs
    else:
        dev = check_device(dense.values, device)
        n = dense.size
    metric = Metric(metric)
    kc = min(candidates, n)
    kd = min(max(kc, dense_gen), n) if dense_gen is not None else kc
    # sign-plane refinement: phase-1 int8 ranks only have to keep the true
    # winners inside the refine pool
    do_refine = (dense_refine > 0 and dense is not None
                 and dense.sign_plane is not None
                 and metric in (Metric.COSINE, Metric.DOT))
    if do_refine:
        kd = min(max(kd, dense_refine), n)
    if ivf is not None:
        if query_emb.shape[0] * nprobe >= ivf.nlist:
            dv, di = ivf_flat_topk(query_emb, ivf, k=kd, metric=metric,
                                   mask=mask, int8_queries=int8_queries)
        elif use_kernel:
            dv, di = ivf_topk(query_emb, ivf, k=kd, nprobe=nprobe, mask=mask,
                              metric=metric, device=dev)
        else:
            dv, di = ivf_search(query_emb, ivf, k=kd, nprobe=nprobe,
                                mask=mask, metric=metric)
    elif use_kernel:
        dv, di = dense_topk(query_emb, dense, k=kd, metric=metric, mask=mask,
                            tile=dense_tile, int8_queries=int8_queries,
                            per_tile_k=per_tile_k, device=dev)
    else:
        dv, di = dense_search(query_emb, dense, k=kd, metric=metric,
                              mask=mask, block_size=block_size)
    if do_refine:
        # codes + 0.25 * sign at full f32 query precision (refine_candidates
        # semantics): half the int8 quantization noise
        qf = normalize_queries(query_emb, metric)
        safe = di.clamp(min=0).long()
        codes = dense.values[safe].to(torch.float32)
        sgn = unpack_signs(dense.sign_plane[safe])
        scl = dense.scales[safe].to(torch.float32)
        dots = torch.einsum("bkd,bd->bk", codes + 0.25 * sgn, qf) * scl
        refined = torch.where(torch.isfinite(dv), dots, NEG_INF)
        dv, pos = stable_topk(refined, refined.shape[1])
        di = torch.gather(di, -1, pos)
    dv_pool, di_pool = dv, di
    if kd > kc:
        dv, di = dv[:, :kc], di[:, :kc]

    # `b` is the BM25 length-normalisation parameter throughout: the batch
    # size must never shadow it (the reference's IVF-rescore bug)
    if inverted is not None:
        kg = min(lex_gen if lex_gen is not None else 2 * kc, n)
        lv, li = inverted_bm25_search(
            query_terms, query_idf, inverted, k=kg, mask=mask,
            postings_per_query_term=postings_per_query_term,
            deep_terms=lex_deep_terms, deep_postings=lex_deep_postings,
        )
        if tail_lexical is not None:
            table = _idf_table(query_terms, query_idf, vocab_size)
            ts = _bm25_block(table, tail_lexical.terms, tail_lexical.tfs,
                             tail_lexical.doc_len,
                             clamp_avgdl(avgdl, query_terms.device), k1, b)
            if tail_mask is not None:
                ts = torch.where(tail_mask[None, :], ts, NEG_INF)
            tv, ti = stable_topk(ts, min(kg, ts.shape[1]))
            ti = (ti + tail_offset).to(torch.int32)
            lv, pos = stable_topk(torch.cat([lv, tv], 1), kg)
            li = torch.gather(torch.cat([li, ti], 1), -1, pos)
        if rescore and lexical is not None:
            lv, li = _rescored_lexical_branch(
                dv_pool, di_pool, lv, li.to(torch.int32), query_terms,
                query_idf, lexical, avgdl, kc, k1, b)
        elif lv.shape[1] > kc:
            lv, pos = stable_topk(lv, kc)
            li = torch.gather(li, -1, pos)
        return _rrf_on_device(dv, di.to(torch.int32), lv,
                              li.to(torch.int32), k, rrf_k)

    # doc-major fallback (small corpora and the un-compacted index); its
    # block is small because the idf gather is [B, block, slots] f32
    table = _idf_table(query_terms, query_idf, vocab_size)
    lv, li = _blocked_topk(table, lexical,
                           clamp_avgdl(avgdl, query_terms.device), kc, mask,
                           k1, b, bm25_block_size)
    return _rrf_on_device(dv, di.to(torch.int32), lv, li.to(torch.int32), k,
                          rrf_k)
