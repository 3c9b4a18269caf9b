"""Inverted BM25: impact-ordered postings + sort-based aggregation
(port of the JAX package's ops/bm25_inverted.py, both tiers).

Table tier (``InvertedIndex``), the top-P impacts of every term:

  postings_ids     [V+1, P] int32   doc rows per term bucket, sorted by
  postings_impact  [V+1, P] bf16    descending impact sat(tf, dl); -1 pad

CSR tier (``CSRInvertedIndex``), every posting stored once, optionally
partitioned into id-disjoint doc shards; the query budget is the only
truncation.

A query gathers its terms' impact prefixes, weights impacts by idf, sorts
the (doc_id, weight) pairs by doc id and sums equal-id runs, then takes
the top-k of the run totals (per shard, then one merge, on the sharded
CSR tier).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
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


def _flat_entries(terms, tfs, doc_len, vocab_size: int, k1: float, b: float,
                  avgdl: Optional[float]):
    """``(term, impact, doc)`` of every non-pad slot in row-major order, on
    the tensors' device: int32 terms, f32 impacts ``sat(tf, dl)`` in the
    reference's order of f32 operations (0 where tf = 0), int32 docs."""
    dev = terms.device
    n, slots = terms.shape
    tfs = tfs.to(torch.float32)
    doc_len = doc_len.to(torch.float32)
    if avgdl is None:
        # numpy's f32 mean, as the reference computes it
        avgdl = float(doc_len.cpu().numpy().mean()) if n else 1.0
    avgdl_t = torch.tensor(max(avgdl, 1e-6), dtype=torch.float32, device=dev)
    norm = k1 * (1.0 - b + b * doc_len[:, None] / avgdl_t)
    flat_impact = (tfs * (k1 + 1.0) / (tfs + norm)).reshape(-1)
    del norm, tfs
    flat_terms = terms.reshape(-1).to(torch.int32)
    flat_docs = torch.arange(n, device=dev, dtype=torch.int32).repeat_interleave(slots)
    keep = flat_terms < vocab_size
    if not bool(keep.all()):
        flat_terms, flat_impact, flat_docs = (
            flat_terms[keep], flat_impact[keep], flat_docs[keep])
    return flat_terms, flat_impact, flat_docs


def _impact_key(major: torch.Tensor, impact: torch.Tensor) -> torch.Tensor:
    """int64 sort key ``major << 31 | (0x7FFFFFFF - impact bits)``: a stable
    ascending sort on it gives numpy's ``lexsort((-impact, major))`` order
    (impacts are >= 0, so their f32 bit patterns sort as the values do;
    + 0.0 turns a -0.0 impact into +0.0, which lexsort ranks equal)."""
    key = major.to(torch.int64) * (1 << 31)
    key += 0x7FFFFFFF
    key -= (impact + 0.0).view(torch.int32)
    return key


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
    flat_terms, flat_impact, flat_docs = _flat_entries(
        terms, tfs, doc_len, vocab_size, k1, b, avgdl)
    flat_terms = flat_terms.to(torch.int64)
    order = torch.sort(_impact_key(flat_terms, flat_impact), stable=True).indices
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
    ids[t_k, r_k] = flat_docs[keep]
    imp[t_k, r_k] = flat_impact[keep]
    return InvertedIndex(postings_ids=ids,
                         postings_impact=imp.to(torch.bfloat16),
                         num_docs=terms.shape[0])


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
    index: Union[InvertedIndex, "CSRInvertedIndex"],
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
    the port's top-k is exact either way.  A ``CSRInvertedIndex`` takes
    the CSR body (same contract; its budgets default to 4096 and 4x that,
    with no build cap to clip them)."""
    del approx_topk
    if has_mask is None:
        has_mask = mask is not None
    if not has_mask:
        mask = None
    if isinstance(index, CSRInvertedIndex):
        return _csr_bm25_search(query_terms, query_idf, index, k, mask,
                                postings_per_query_term, deep_terms,
                                deep_postings)
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
        width = ids_.shape[1] * ids_.shape[2]  # a term list may be empty
        return ids_.reshape(bsz, width), w_.reshape(bsz, width)

    pd = min(deep_postings or index.postings_per_term, index.postings_per_term)
    ids, w = _gather_budgets(weighted_gather, query_terms, query_idf,
                             deep_terms, pd, p)
    sorted_ids, totals = _segment_sum_runs(ids, w)
    v, pos = stable_topk(totals, min(k, ids.shape[1]))
    return _final(v, torch.gather(sorted_ids, -1, pos))


def _gather_budgets(weighted_gather, query_terms, query_idf, deep_terms: int,
                    deep_depth: int, depth: int):
    """``weighted_gather`` of every query term at ``depth``, or, with
    ``deep_terms`` > 0, of each row's ``deep_terms`` lowest-idf terms at
    ``deep_depth`` and the rest at ``depth``, joined on the last axis."""
    s = min(deep_terms, query_terms.shape[1])
    if s <= 0:
        return weighted_gather(query_terms, query_idf, depth)
    # pads (idf <= 0) sort last, high-df terms first
    key = torch.where(query_idf > 0, query_idf, float("inf"))
    order = torch.argsort(key, dim=1, stable=True)
    qt_s = torch.gather(query_terms, 1, order)
    qi_s = torch.gather(query_idf, 1, order)
    ids_d, w_d = weighted_gather(qt_s[:, :s], qi_s[:, :s], deep_depth)
    ids_r, w_r = weighted_gather(qt_s[:, s:], qi_s[:, s:], depth)
    return torch.cat([ids_d, ids_r], dim=-1), torch.cat([w_d, w_r], dim=-1)


def _final(v: torch.Tensor, i: torch.Tensor):
    """Slots with no positive finite total become (-inf, -1)."""
    i = torch.where(torch.isfinite(v) & (v > 0), i, -1)
    v = torch.where(i >= 0, v, NEG_INF)
    return v, i.to(torch.int32)


class CSRInvertedIndex(NamedTuple):
    """Every posting once, in CSR layout: no build-time truncation.

    postings_docs    [E] int32   doc rows, term-major, impact-desc in-term
                                 (stable: lowest doc first among equals)
    postings_impact  [E] bf16    sat(tf, dl) impact (idf NOT included)
    offsets          [V+2] int32 run start per term; the pad bucket
                                 (term id == vocab_size) is the empty run
                                 [offsets[V], offsets[V+1])

    Doc-sharded (``offsets`` of shape [C, V+2]): the postings are
    partitioned by ``doc_id % C`` into C id-disjoint shards, each laid out
    as above (shard-major, term-major, impact-desc in-run); row c's last
    entry is the start of shard c + 1.  A document's postings all live in
    one shard, so per-shard run sums are exact and the global top-k is
    the top-k of the per-shard top-ks: the aggregation runs as C sorts of
    width W / C.  Query budgets stay total per-term budgets; each shard
    reads ``_shard_depth(budget, C)``."""

    postings_docs: torch.Tensor
    postings_impact: torch.Tensor
    offsets: torch.Tensor
    num_docs: int

    @property
    def vocab_size(self) -> int:
        return self.offsets.shape[-1] - 2

    @property
    def shards(self) -> int:
        return self.offsets.shape[0] if self.offsets.dim() == 2 else 1

    @property
    def postings_per_term(self) -> int:
        # no build-time cap: the effective per-term depth is query-time
        return self.postings_docs.shape[0]


def build_inverted_csr(
    terms: torch.Tensor,  # [N, L] int32, pad = vocab_size
    tfs: torch.Tensor,  # [N, L] float
    doc_len: torch.Tensor,  # [N] float
    vocab_size: int,
    k1: float = 1.2,
    b: float = 0.75,
    avgdl: Optional[float] = None,
    shards: int = 1,
) -> CSRInvertedIndex:
    """CSR build on the tensors' device: every (term, impact, doc) entry,
    ordered by ([shard,] term asc, impact desc, doc asc), with per-term
    (per shard and term) offsets.  One stable sort on a packed int64 key,
    ``major << 31 | (0x7FFFFFFF - impact bits)`` with major = term, or
    ``(doc % C) * (V+1) + term`` sharded (< 2^54 for C <= 64 at V = 2^17),
    gives numpy's ``lexsort((-impact, term[, shard]))`` order, so docs,
    bf16 impacts and offsets are bit-identical to the JAX package's host
    build."""
    n = terms.shape[0]
    flat_terms, flat_impact, flat_docs = _flat_entries(
        terms, tfs, doc_len, vocab_size, k1, b, avgdl)
    total = flat_terms.shape[0]
    assert total < 2 ** 31, f"{total} postings overflow int32 offsets"
    if shards > 1:
        major = (flat_docs % shards).to(torch.int64) * (vocab_size + 1)
        major += flat_terms
        del flat_terms
        key = _impact_key(major, flat_impact)
        offsets = _sharded_offsets(major, vocab_size, shards, total)
        del major
    else:
        key = _impact_key(flat_terms, flat_impact)
        # run lengths do not depend on the order: count before sorting
        counts = torch.bincount(flat_terms, minlength=vocab_size + 1)
        del flat_terms
        offsets = torch.zeros(vocab_size + 2, dtype=torch.int64,
                              device=counts.device)
        torch.cumsum(counts, 0, out=offsets[1:])
    order = torch.sort(key, stable=True).indices
    del key
    return CSRInvertedIndex(
        postings_docs=flat_docs[order],
        postings_impact=flat_impact[order].to(torch.bfloat16),
        offsets=offsets.to(torch.int32), num_docs=n)


def _sharded_offsets(keys: torch.Tensor, vocab_size: int, shards: int,
                     total: int) -> torch.Tensor:
    """[C, V+2] run-start table from shard-major ``shard * (V+1) + term``
    keys (in any order).  Row c's trailing entry is the start of shard
    c + 1 (the shard sections are contiguous), so every run
    [off[c, t], off[c, t+1]) slices without special cases."""
    v1 = vocab_size + 1
    counts = torch.bincount(keys, minlength=shards * v1)
    flat_off = torch.zeros(shards * v1 + 1, dtype=torch.int64,
                           device=keys.device)
    torch.cumsum(counts, 0, out=flat_off[1:])
    assert int(flat_off[-1]) == total
    rows = (torch.arange(shards, device=keys.device)[:, None] * v1
            + torch.arange(v1 + 1, device=keys.device)[None])
    return flat_off[rows]


def reshard_csr_host(
    docs: np.ndarray,  # [E] int32, unsharded CSR postings (term-major)
    impact: np.ndarray,  # [E] impact payload (any dtype, carried)
    offsets: np.ndarray,  # [V+2] unsharded run starts
    shards: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Re-partition an unsharded CSR into the doc-sharded layout without
    rebuilding from the corpus: one stable sort by (shard, term) keeps
    the impact-desc order inside every (shard, term) run.  Host numpy in
    and out (int64 offsets), as the reference's."""
    v1 = len(offsets) - 1  # term buckets incl. the pad bucket
    counts = torch.from_numpy(np.diff(np.asarray(offsets, np.int64)))
    flat_terms = torch.repeat_interleave(torch.arange(v1), counts)
    key = torch.from_numpy(np.asarray(docs, np.int64)) % shards * v1 + flat_terms
    order = torch.sort(key, stable=True).indices
    offsets2d = _sharded_offsets(key, v1 - 1, shards, len(docs))
    order = order.numpy()
    return docs[order], impact[order], offsets2d.numpy()


def _shard_depth(depth: int, shards: int) -> int:
    """Per-shard read depth for a total per-term budget of ``depth``:
    ceil(depth / C) covers a truncated run's global prefix split about
    evenly; where the budget covers the whole run, a shard's run length is
    Binomial(df, 1/C) and may pass df / C by a few sigma, which the
    + 4 sqrt Poisson slack covers, so full-coverage results stay equal to
    the unsharded tier's."""
    base = -(-depth // shards)
    return base + 4 * max(1, int(base ** 0.5)) + 8


def _csr_weighted_gather(index: CSRInvertedIndex, qt, qidf, depth: int,
                         mask, bsz: int):
    """Each term's top-``depth`` impact prefix from the flat arrays, the
    rows past its run masked: ids / weights of [B, W], or, sharded,
    [B, C, W'] at the per-shard depth ``_shard_depth(depth, C)``."""
    qt = qt.long()
    sharded = index.offsets.dim() == 2
    if sharded:
        start = index.offsets[:, qt]  # [C, B, S]
        length = index.offsets[:, qt + 1] - start
        depth = _shard_depth(depth, index.offsets.shape[0])
    else:
        start = index.offsets[qt]  # [B, S]
        length = index.offsets[qt + 1] - start
    steps = torch.arange(depth, device=qt.device, dtype=torch.int64)
    valid = steps < length[..., None]
    pos = torch.where(valid, start[..., None] + steps, 0)
    ids_ = torch.where(valid, index.postings_docs[pos], -1)
    imp_ = index.postings_impact[pos].to(torch.float32)
    w_ = torch.where(valid, imp_ * qidf[..., None], 0.0)
    if mask is not None:
        live = mask[ids_.clamp(min=0).long()] & (ids_ >= 0)
        ids_ = torch.where(live, ids_, -1)
        w_ = torch.where(live, w_, 0.0)
    width = qt.shape[-1] * depth  # explicit: a term list may be empty
    if sharded:
        c = ids_.shape[0]
        return (ids_.transpose(0, 1).reshape(bsz, c, width),
                w_.transpose(0, 1).reshape(bsz, c, width))
    return ids_.reshape(bsz, width), w_.reshape(bsz, width)


def _csr_bm25_search(query_terms, query_idf, index: CSRInvertedIndex, k: int,
                     mask, postings_per_query_term, deep_terms: int,
                     deep_postings):
    """The CSR twin of the table body: the same aggregation, only the
    gather differs.  Query terms are < vocab_size or the pad id, whose
    run is empty by construction."""
    ids, w = _csr_gather_budgets(query_terms, query_idf, index, mask,
                                 postings_per_query_term, deep_terms,
                                 deep_postings)
    return _csr_aggregate(ids, w, k)


def _csr_gather_budgets(query_terms, query_idf, index: CSRInvertedIndex, mask,
                        postings_per_query_term, deep_terms: int,
                        deep_postings):
    """Ids / weights of every query term's budgeted prefix: ``[B, W]``, or
    ``[B, C, W']`` sharded.  The budgets default to 4096 and 4x that, with
    no build cap to clip them."""
    bsz = query_terms.shape[0]
    p = postings_per_query_term or 4096
    pd = deep_postings or 4 * p

    def gather(qt, qidf, depth):
        return _csr_weighted_gather(index, qt, qidf, depth, mask, bsz)

    return _gather_budgets(gather, query_terms, query_idf, deep_terms, pd, p)


def _csr_aggregate(ids: torch.Tensor, w: torch.Tensor, k: int):
    """Run totals and their top-k.  Sharded (``[B, C, W']``), each shard
    takes its exact top-k and one exact top-k over the ``[B, C * k]``
    lists (lowest position first among ties) merges them: the shards are
    id-disjoint, so that is the global top-k."""
    bsz = ids.shape[0]
    sorted_ids, totals = _segment_sum_runs(ids, w)
    k_eff = min(k, ids.shape[-1])
    v, pos = stable_topk(totals, k_eff)
    i = torch.gather(sorted_ids, -1, pos)
    if ids.dim() == 3:
        c = ids.shape[1]
        v, sel = stable_topk(v.reshape(bsz, c * k_eff), min(k, c * k_eff))
        i = torch.gather(i.reshape(bsz, c * k_eff), -1, sel)
    return _final(v, i)
