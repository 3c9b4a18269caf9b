"""Sharded dense search: per-rank top-k + all_gather merge (port of the
JAX package's parallel/sharded.py).

Every rank holds ``N / n`` corpus rows, scores them with the same search
as the one-device path (the blocked exact search, or the fused
``dense_topk`` kernel on the card), and only the ``[n, B, k]``
candidates cross the link; each rank then merges them to the same,
replicated ``[B, k]`` result.
"""

from __future__ import annotations

from typing import Optional

import torch

from super_rag_tpu_torch.ops.dense import DenseCorpus, Metric, dense_search
from super_rag_tpu_torch.ops.dense_topk import dense_topk
from super_rag_tpu_torch.ops.topk import stable_topk
from super_rag_tpu_torch.parallel.mesh import (
    CORPUS_AXIS, SLICE_AXIS, Mesh, all_gather, row_axes)


def gather_candidates(vals: torch.Tensor, ids: torch.Tensor, group
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every rank's ``[B, kc]`` candidates along ``group`` as ``[B, n * kc]``,
    ordered by rank, then by each rank's own order."""
    b = vals.shape[0]
    av = torch.stack(all_gather(vals, group), 1).reshape(b, -1)
    ai = torch.stack(all_gather(ids, group), 1).reshape(b, -1)
    return av, ai


def merge_axis(vals: torch.Tensor, ids: torch.Tensor, group, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` of every rank's candidates along one axis; ties keep the
    lower rank first, then local order (``jax.lax.top_k``'s rule over the
    gathered ``[B, n * kc]``)."""
    av, ai = gather_candidates(vals, ids, group)
    mv, pos = stable_topk(av, min(k, av.shape[-1]))
    return mv, torch.gather(ai, -1, pos)


def merge_rows(vals: torch.Tensor, ids: torch.Tensor, mesh: Mesh, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The hierarchical merge: the corpus axis first, then only the k
    winners of each slice across the slice axis."""
    fv, fi = merge_axis(vals, ids, mesh.group(CORPUS_AXIS), k)
    if SLICE_AXIS in row_axes(mesh):
        fv, fi = merge_axis(fv, fi, mesh.group(SLICE_AXIS), k)
    return fv, fi


def sharded_dense_search(
    queries: torch.Tensor,
    corpus: DenseCorpus,
    k: int,
    mesh: Mesh,
    metric: Metric = Metric.COSINE,
    mask: Optional[torch.Tensor] = None,
    block_size: int = 8192,
    use_kernel: bool = False,
    int8_queries: bool = False,
    per_tile_k: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Search a row-sharded corpus; returns the replicated ``[B, k]``
    result.  Every rank of the mesh calls it with the same queries and
    its own block of rows (``parallel.mesh.shard_corpus``); ``mask`` is
    this rank's block of the keep-mask and also covers padding rows.
    ``use_kernel`` runs each shard through ``dense_topk`` (the CUDA
    kernel on the card; 2,048-row tiles, as the index's) with
    ``int8_queries`` and ``per_tile_k``; else the blocked exact search."""
    queries = queries.to(mesh.device)
    if use_kernel:
        lv, li = dense_topk(queries, corpus, k=k, metric=metric, mask=mask,
                            tile=2048, int8_queries=int8_queries,
                            per_tile_k=per_tile_k, device=mesh.device)
    else:
        lv, li = dense_search(queries, corpus, k=k, metric=metric, mask=mask,
                              block_size=block_size)
    li = li + mesh.row_index * corpus.size
    return merge_rows(lv, li, mesh, k)
