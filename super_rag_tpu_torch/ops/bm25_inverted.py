"""Inverted BM25: impact-ordered postings + sort-based aggregation
(port of the table tier of the JAX package's ops/bm25_inverted.py).

  postings_ids     [V+1, P] int32   doc rows per term bucket, sorted by
  postings_impact  [V+1, P] bf16    descending impact sat(tf, dl); -1 pad

A query gathers its Q posting rows, weights impacts by idf, sorts the
(doc_id, weight) pairs by doc id and sums equal-id runs, then takes the
top-k of the run totals.  Per-term postings keep the top-P impacts.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from super_rag_tpu_torch.ops.topk import NEG_INF, stable_topk


class InvertedIndex(NamedTuple):
    postings_ids: torch.Tensor  # [V+1, P] int32 (-1 = empty)
    postings_impact: torch.Tensor  # [V+1, P] bf16 (idf NOT included)
    num_docs: int

    @property
    def vocab_size(self) -> int:
        return self.postings_ids.shape[0] - 1

    @property
    def postings_per_term(self) -> int:
        return self.postings_ids.shape[1]


def build_inverted(
    terms: torch.Tensor,  # [N, L] int32, pad = vocab_size
    tfs: torch.Tensor,  # [N, L] float
    doc_len: torch.Tensor,  # [N] float
    vocab_size: int,
    postings_per_term: int = 256,
    k1: float = 1.2,
    b: float = 0.75,
    avgdl: Optional[float] = None,
) -> InvertedIndex:
    """Build on the tensors' device: flatten the (term, impact, doc)
    entries, order them by (term asc, impact desc, doc asc) and keep the
    first P of each term run.  One stable sort on a packed int64 key gives
    the order numpy's ``lexsort((-impact, term))`` gives (impacts are
    >= 0, so their f32 bit patterns sort as the values do), and the
    impacts are the reference's f32 operations, so the tables are
    bit-identical to the JAX package's host build."""
    dev = terms.device
    terms = terms.to(torch.int64)
    tfs = tfs.to(torch.float32)
    doc_len = doc_len.to(torch.float32)
    n, slots = terms.shape
    if avgdl is None:
        # numpy's f32 mean, as the reference computes it
        avgdl = float(doc_len.cpu().numpy().mean()) if n else 1.0
    avgdl_t = torch.tensor(max(avgdl, 1e-6), dtype=torch.float32, device=dev)
    norm = k1 * (1.0 - b + b * doc_len[:, None] / avgdl_t)
    impact = tfs * (k1 + 1.0) / (tfs + norm)  # [N, L]; 0 where tf=0

    flat_terms = terms.reshape(-1)
    flat_impact = impact.reshape(-1)
    keep = flat_terms < vocab_size
    flat_docs = torch.arange(n, device=dev, dtype=torch.int64).repeat_interleave(slots)
    flat_terms, flat_impact, flat_docs = (
        flat_terms[keep], flat_impact[keep], flat_docs[keep])
    # + 0.0 turns a -0.0 impact into +0.0, which lexsort ranks equal
    bits = (flat_impact + 0.0).view(torch.int32).to(torch.int64)
    key = flat_terms * (1 << 31) + (0x7FFFFFFF - bits)
    order = torch.sort(key, stable=True).indices
    flat_terms = flat_terms[order]
    flat_impact = flat_impact[order]
    flat_docs = flat_docs[order]

    idx = torch.arange(flat_terms.shape[0], device=dev)
    is_start = torch.ones_like(flat_terms, dtype=torch.bool)
    is_start[1:] = flat_terms[1:] != flat_terms[:-1]
    run_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    rank = idx - run_start
    keep = rank < postings_per_term
    ids = torch.full((vocab_size + 1, postings_per_term), -1,
                     dtype=torch.int32, device=dev)
    imp = torch.zeros((vocab_size + 1, postings_per_term),
                      dtype=torch.float32, device=dev)
    t_k, r_k = flat_terms[keep], rank[keep]
    ids[t_k, r_k] = flat_docs[keep].to(torch.int32)
    imp[t_k, r_k] = flat_impact[keep]
    return InvertedIndex(postings_ids=ids,
                         postings_impact=imp.to(torch.bfloat16), num_docs=n)


def _segment_sum_runs(ids: torch.Tensor, w: torch.Tensor):
    """Per row: sort (id, w) by id, sum equal-id runs, return run totals
    at run ends (other positions -inf) plus the sorted ids.

    The run sums come from a cumsum in f64 (run total = cumsum at the run
    end minus cumsum before its start), rounded to f32.  Each f32 total is
    then the rounded exact sum whatever order the scan adds in, so a query
    gets the same totals in any batch; an f32 cumsum would carry the
    rounding of the whole row's prefix into every run.  Needs ``w >= 0``
    (a nondecreasing cumsum for the cummax run base)."""
    sorted_ids, order = torch.sort(ids, dim=-1, stable=True)
    sorted_w = torch.gather(w, -1, order).to(torch.float64)
    csum = torch.cumsum(sorted_w, dim=-1)
    prev = torch.nn.functional.pad(sorted_ids[..., :-1], (1, 0), value=-2)
    is_start = sorted_ids != prev
    base_at_start = torch.where(is_start, csum - sorted_w, float("-inf"))
    run_base = torch.cummax(base_at_start, dim=-1).values
    run_total = (csum - run_base).to(torch.float32)
    nxt = torch.nn.functional.pad(sorted_ids[..., 1:], (0, 1), value=-3)
    is_end = sorted_ids != nxt
    totals = torch.where(is_end & (sorted_ids >= 0), run_total, NEG_INF)
    return sorted_ids, totals


def inverted_bm25_search(
    query_terms: torch.Tensor,  # [B, Q] int32, pad = vocab_size
    query_idf: torch.Tensor,  # [B, Q] f32
    index: InvertedIndex,
    k: int,
    mask: Optional[torch.Tensor] = None,  # [N] bool keep-mask
    has_mask: Optional[bool] = None,
    postings_per_query_term: Optional[int] = None,
    deep_terms: int = 0,
    deep_postings: Optional[int] = None,
    approx_topk: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k BM25 via the inverted index: ``(scores [B, k], int32 ids)``.

    ``postings_per_query_term`` caps each query term's postings at query
    time (the highest-impact prefix).  With ``deep_terms`` > 0 each row's
    ``deep_terms`` lowest-idf terms (highest df: the ones the cap
    truncates) read ``deep_postings`` rows instead.  ``has_mask`` (default:
    whether ``mask`` is given) says whether the mask applies, as in the
    reference.  ``approx_topk`` is accepted for the reference's contract;
    the port's top-k is exact either way."""
    del approx_topk
    if has_mask is None:
        has_mask = mask is not None
    if not has_mask:
        mask = None
    bsz, q = query_terms.shape
    p = index.postings_per_term
    if postings_per_query_term is not None:
        p = min(p, postings_per_query_term)

    def weighted_gather(qt, qidf, depth):
        qt = qt.long()
        ids_ = index.postings_ids[qt][..., :depth]
        imp_ = index.postings_impact[qt][..., :depth].to(torch.float32)
        w_ = imp_ * qidf[..., None]
        if mask is not None:
            valid = mask[ids_.clamp(min=0).long()] & (ids_ >= 0)
            ids_ = torch.where(valid, ids_, -1)
            w_ = torch.where(valid, w_, 0.0)
        return ids_.reshape(bsz, -1), w_.reshape(bsz, -1)

    s = min(deep_terms, q)
    if s > 0:
        pd = min(deep_postings or index.postings_per_term,
                 index.postings_per_term)
        # pads (idf <= 0) sort last, high-df terms first
        key = torch.where(query_idf > 0, query_idf, float("inf"))
        order = torch.argsort(key, dim=1, stable=True)
        qt_s = torch.gather(query_terms, 1, order)
        qi_s = torch.gather(query_idf, 1, order)
        ids_d, w_d = weighted_gather(qt_s[:, :s], qi_s[:, :s], pd)
        ids_r, w_r = weighted_gather(qt_s[:, s:], qi_s[:, s:], p)
        ids = torch.cat([ids_d, ids_r], dim=1)
        w = torch.cat([w_d, w_r], dim=1)
    else:
        ids, w = weighted_gather(query_terms, query_idf, p)

    sorted_ids, totals = _segment_sum_runs(ids, w)
    v, pos = stable_topk(totals, min(k, ids.shape[1]))
    i = torch.gather(sorted_ids, -1, pos)
    i = torch.where(torch.isfinite(v) & (v > 0), i, -1)
    v = torch.where(i >= 0, v, NEG_INF)
    return v, i.to(torch.int32)
