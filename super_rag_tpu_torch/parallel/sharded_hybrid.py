"""Sharded hybrid search: per-rank dense + BM25 top-k, all_gather merge,
global RRF (port of the JAX package's parallel/sharded_hybrid.py).

Every rank runs the same tiers as the one-device path (ops/hybrid.py)
on its own rows: IVF > the fused ``dense_topk`` kernel > the blocked
exact search for the dense branch; per-shard inverted postings with an
exact rescore of the fused pool against the local doc-major rows, or a
doc-major scan, for the lexical one.  The candidates (``k`` per rank
per branch) cross the link in all_gathers; the fresh-tail scan and the
RRF run replicated, so every rank ends with the same result.  Every
depth of the JAX program is kept, or the results would differ: the
dense merge at ``kc``, the lexical merge at ``n * kc``, the multislice
truncation of the lexical pool to ``kc`` before the slice hop, and the
tail's duplicate drop.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from super_rag_tpu_torch.ops.bm25 import (
    LexicalCorpus, _bm25_block, _idf_table, bm25_search, clamp_avgdl)
from super_rag_tpu_torch.ops.bm25_inverted import (
    InvertedIndex, inverted_bm25_search)
from super_rag_tpu_torch.ops.dense import DenseCorpus, Metric, dense_search
from super_rag_tpu_torch.ops.dense_topk import dense_topk
from super_rag_tpu_torch.ops.hybrid import (
    INT32_MAX, HybridResult, _rescored_lexical_branch, _rrf_on_device)
from super_rag_tpu_torch.ops.ivf import IVFIndex, ivf_search
from super_rag_tpu_torch.ops.ivf_topk import ivf_topk
from super_rag_tpu_torch.ops.topk import NEG_INF, stable_topk
from super_rag_tpu_torch.parallel.mesh import (
    CORPUS_AXIS, SLICE_AXIS, Mesh, row_axes, row_shards)
from super_rag_tpu_torch.parallel.sharded import merge_axis


class FreshTail(NamedTuple):
    """Rows added since lexical compaction, replicated on every rank."""

    terms: torch.Tensor  # [T, L] int32
    tfs: torch.Tensor  # [T, L] f32
    doc_len: torch.Tensor  # [T] f32
    rows: torch.Tensor  # [T] int32 GLOBAL row ids, -1 pad
    keep: torch.Tensor  # [T] bool: validity and filters


def _local_dense(qe, dense: DenseCorpus, keep, kc: int, metric, ivf, nprobe,
                 use_kernel, dense_tile, per_tile_k, int8_queries, block_size):
    if ivf is not None:
        # the IVF kernels on the card, the plain gather tier elsewhere
        if ivf.device.type == "cuda":
            return ivf_topk(qe, ivf, k=kc, nprobe=nprobe, mask=keep,
                            metric=metric, device=ivf.device)
        return ivf_search(qe, ivf, k=kc, nprobe=nprobe, mask=keep,
                          metric=metric)
    if use_kernel:
        return dense_topk(qe, dense, k=kc, metric=metric, mask=keep,
                          tile=dense_tile, int8_queries=int8_queries,
                          per_tile_k=per_tile_k, device=dense.values.device)
    return dense_search(qe, dense, k=kc, metric=metric, mask=keep,
                        block_size=block_size)


def _tail_scan(glv, gli, qt, qi, tail: FreshTail, avgdl, vocab_size: int,
               kc: int, dedup: bool):
    """Score the fresh tail doc-major (exact, replicated) and join it to
    the merged lexical pool; a tail row can enter a rescored pool through
    the dense branch and the tail scan alike (equal exact scores), so
    with ``dedup`` duplicates are dropped by id first."""
    table = _idf_table(qt, qi, vocab_size)
    ts = _bm25_block(table, tail.terms, tail.tfs, tail.doc_len,
                     clamp_avgdl(avgdl, qt.device), 1.2, 0.75)
    ts = torch.where(tail.keep[None, :], ts, NEG_INF)
    tv, tpos = stable_topk(ts, min(kc, ts.shape[1]))
    ti = tail.rows[tpos]
    ti = torch.where(torch.isfinite(tv), ti, -1).to(torch.int32)
    glv = torch.cat([glv, tv], 1)
    gli = torch.cat([gli, ti], 1)
    if dedup:
        key = torch.where(gli >= 0, gli, INT32_MAX)
        order = torch.argsort(key, dim=-1, stable=True)
        gli = torch.gather(gli, -1, order)
        glv = torch.gather(glv, -1, order)
        dup = torch.zeros_like(gli, dtype=torch.bool)
        dup[:, 1:] = (gli[:, 1:] == gli[:, :-1]) & (gli[:, 1:] >= 0)
        glv = torch.where(dup, NEG_INF, glv)
    return glv, gli


def sharded_hybrid_search(
    query_emb: torch.Tensor,  # [B, D] replicated
    query_terms: torch.Tensor,  # [B, Q] int32
    query_idf: torch.Tensor,  # [B, Q] f32
    dense: DenseCorpus,  # this rank's rows
    lexical: LexicalCorpus,  # this rank's rows
    keep: torch.Tensor,  # [N / n] bool: this rank's validity + filters
    avgdl,
    mesh: Mesh,
    *,
    vocab_size: int,
    k: int,
    candidates: int = 100,
    metric: Metric = Metric.COSINE,
    block_size: int = 4096,
    inverted: Optional[InvertedIndex] = None,  # this rank's postings
    postings_per_query_term: Optional[int] = 256,
    use_kernel: bool = False,
    dense_tile: int = 2048,
    per_tile_k: Optional[int] = None,
    int8_queries: bool = False,
    rescore: bool = True,
    ivf: Optional[IVFIndex] = None,  # this rank's IVF tier (local ids)
    nprobe: int = 32,
    tail: Optional[FreshTail] = None,
) -> HybridResult:
    """Hybrid top-k over a row-sharded index: every rank of ``mesh``
    calls it with the same queries and its own block of rows, and gets
    the same ``HybridResult``.  ``candidates`` is the per-branch depth of
    each shard (capped at the shard's rows)."""
    dev = mesh.device
    qe = query_emb.to(dev)
    qt, qi = query_terms.to(dev), query_idf.to(dev)
    shard_rows = dense.size
    n_dev = row_shards(mesh)
    kc = min(candidates, shard_rows)
    base = mesh.row_index * shard_rows
    metric = Metric(metric)

    dv, di = _local_dense(qe, dense, keep, kc, metric, ivf, nprobe,
                          use_kernel, dense_tile, per_tile_k, int8_queries,
                          block_size)
    if inverted is not None:
        kg = min(2 * kc, shard_rows) if rescore else kc
        lv, li = inverted_bm25_search(
            qt, qi, inverted, k=kg, mask=keep, has_mask=True,
            postings_per_query_term=postings_per_query_term)
        if rescore:
            # exact rescoring against the LOCAL doc-major rows: the merge
            # of exact per-shard scores is then the exact ranking of the
            # pooled candidates
            lv, li = _rescored_lexical_branch(
                dv, di.to(torch.int32), lv, li.to(torch.int32), qt, qi,
                lexical, avgdl, kc, 1.2, 0.75)
    else:
        lv, li = bm25_search(qt, qi, lexical, avgdl, vocab_size=vocab_size,
                             k=kc, mask=keep, block_size=block_size)
    di = torch.where(di >= 0, di + base, -1).to(torch.int32)
    li = torch.where(li >= 0, li + base, -1).to(torch.int32)

    # global per-branch candidates, then RRF on the global ranks: the
    # corpus axis first, then only the slice winners across the slices
    corpus_g = mesh.group(CORPUS_AXIS)
    gdv, gdi = merge_axis(dv, di, corpus_g, kc)
    glv, gli = merge_axis(lv, li, corpus_g, n_dev * kc)
    if SLICE_AXIS in row_axes(mesh):
        # each slice's lexical pool cut to its top kc before the hop: the
        # global top kc lies in the union of the slices' (disjoint ids)
        glv, pos = stable_topk(glv, min(kc, glv.shape[-1]))
        gli = torch.gather(gli, -1, pos)
        slice_g = mesh.group(SLICE_AXIS)
        gdv, gdi = merge_axis(gdv, gdi, slice_g, kc)
        glv, gli = merge_axis(glv, gli, slice_g, glv.shape[-1])
    if tail is not None:
        glv, gli = _tail_scan(glv, gli, qt, qi, tail, avgdl, vocab_size, kc,
                              dedup=rescore and inverted is not None)
    glv, pos = stable_topk(glv, min(kc, glv.shape[-1]))
    gli = torch.gather(gli, -1, pos)
    return _rrf_on_device(gdv, gdi, glv, gli, k, 60.0)
