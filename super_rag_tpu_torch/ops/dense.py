"""Flat exact dense search: blocked matmul + hierarchical top-k
(port of the JAX package's ops/dense.py).

    scores[B, N] = transform(Q @ C.T)   computed in corpus blocks
    top-k per block, then one merge of the block candidates

The corpus is bf16/f32 embeddings or int8 codes with per-row scales.
Masked rows score -inf; the ``[B, N]`` matrix is never materialised.
The fused kernel path is ``ops/dense_topk.py``.
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Optional

import torch

from super_rag_tpu_torch.ops.quant import quantize_int8
from super_rag_tpu_torch.ops.topk import NEG_INF, stable_topk


class Metric(str, enum.Enum):
    COSINE = "cosine"
    DOT = "ip"
    L2 = "l2"


class DenseCorpus(NamedTuple):
    """Device-resident corpus.

    values     [N, D]  bf16/f32 embeddings, or int8 codes
    scales     [N]     f32 per-row dequant scales (int8 only; else None)
    norms_sq   [N]     f32 squared L2 norms (L2 metric only; else None)
    live_rows  rows at and past it are padding that no mask keeps (an
               index's rows past its write cursor); the fused top-k
               does not read them.  None: every row may be live.
    """

    values: torch.Tensor
    scales: Optional[torch.Tensor] = None
    norms_sq: Optional[torch.Tensor] = None
    live_rows: Optional[int] = None

    @property
    def size(self) -> int:
        return self.values.shape[0]

    @property
    def dim(self) -> int:
        return self.values.shape[1]

    @property
    def is_quantized(self) -> bool:
        return self.values.dtype == torch.int8


def row_norm(x: torch.Tensor) -> torch.Tensor:
    """L2 norm of each row, ``[..., D] -> [..., 1]``, summed by a fixed
    pairwise tree of elementwise adds.  A reduction kernel picks its
    summation order from the tensor's shape, so a query would normalise
    to different last bits in a batch of 1 and a batch of 64; the tree
    makes every row's result independent of the batch and of the device.
    Meant for query batches (it pads D up to a power of two)."""
    sq = x * x
    w = sq.shape[-1]
    p = 1 << max(w - 1, 0).bit_length()
    if p != w:
        sq = torch.nn.functional.pad(sq, (0, p - w))
    while sq.shape[-1] > 1:
        h = sq.shape[-1] // 2
        sq = sq[..., :h] + sq[..., h:]
    return sq.sqrt()


def normalize_queries(queries: torch.Tensor, metric: Metric) -> torch.Tensor:
    """f32 queries; cosine queries L2-normalised with the zero-norm guard."""
    q = queries.to(torch.float32)
    if Metric(metric) == Metric.COSINE:
        n = row_norm(q)
        q = q / torch.where(n > 0, n, torch.ones_like(n))
    return q


def build_corpus(
    embeddings: torch.Tensor,
    metric: Metric = Metric.COSINE,
    dtype: torch.dtype = torch.bfloat16,
) -> DenseCorpus:
    """Prepare embeddings for device residence: cosine rows are
    L2-normalised once; ``dtype=torch.int8`` quantizes per row."""
    x = embeddings.to(torch.float32)
    if Metric(metric) == Metric.COSINE:
        n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        x = x / torch.where(n > 0, n, torch.ones_like(n))
    norms_sq = (x * x).sum(-1) if Metric(metric) == Metric.L2 else None
    if dtype == torch.int8:
        q, scales = quantize_int8(x)
        return DenseCorpus(values=q, scales=scales, norms_sq=norms_sq)
    return DenseCorpus(values=x.to(dtype), scales=None, norms_sq=norms_sq)


def _block_scores(
    q: torch.Tensor,  # [B, D] f32
    values: torch.Tensor,  # [T, D] storage dtype
    scales: Optional[torch.Tensor],
    norms_sq: Optional[torch.Tensor],
    metric: Metric,
) -> torch.Tensor:
    """Scores of one corpus block; higher is better for every metric.
    int8 codes and bf16 corpora meet a bf16-rounded query, as in the
    reference; the products are exact in f32 and summed in f32."""
    if values.dtype == torch.float32:
        qv, v = q, values
    else:
        qv = q.to(torch.bfloat16).to(torch.float32)
        v = values.to(torch.float32)
    dots = qv @ v.T
    if scales is not None:
        dots = dots * scales[None, :]
    if metric == Metric.L2:
        return 2.0 * dots - norms_sq[None, :]
    return dots


def dense_search(
    queries: torch.Tensor,
    corpus: DenseCorpus,
    k: int,
    metric: Metric = Metric.COSINE,
    mask: Optional[torch.Tensor] = None,
    block_size: int = 8192,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of ``queries [B, D]``: ``(scores [B, k], int32 ids)``.
    ``mask`` is an optional ``[N]`` keep-mask (False rows score -inf)."""
    metric = Metric(metric)
    q = normalize_queries(queries, metric)
    n = corpus.size
    k_eff = min(k, n)
    if n <= block_size:
        s = _block_scores(q, corpus.values, corpus.scales, corpus.norms_sq,
                          metric)
        if mask is not None:
            s = torch.where(mask[None, :], s, NEG_INF)
        v, i = stable_topk(s, k_eff)
        return v, i.to(torch.int32)
    kb = min(k_eff, block_size)
    vals, idxs = [], []
    for lo in range(0, n, block_size):
        hi = min(lo + block_size, n)
        s = _block_scores(
            q, corpus.values[lo:hi],
            corpus.scales[lo:hi] if corpus.scales is not None else None,
            corpus.norms_sq[lo:hi] if corpus.norms_sq is not None else None,
            metric,
        )
        if mask is not None:
            s = torch.where(mask[None, lo:hi], s, NEG_INF)
        if hi - lo < block_size:  # the reference pads the last block
            s = torch.nn.functional.pad(s, (0, block_size - (hi - lo)),
                                        value=NEG_INF)
        v, i = stable_topk(s, kb)
        vals.append(v)
        idxs.append(i + lo)
    vals = torch.cat(vals, dim=1)
    idxs = torch.cat(idxs, dim=1)
    fv, pos = stable_topk(vals, k_eff)
    return fv, torch.gather(idxs, -1, pos).to(torch.int32)


def exact_scores(
    queries: torch.Tensor, corpus: DenseCorpus, metric: Metric = Metric.COSINE
) -> torch.Tensor:
    """Full [B, N] score matrix — test/gold path only (O(B*N) memory)."""
    metric = Metric(metric)
    q = normalize_queries(queries, metric)
    return _block_scores(q, corpus.values, corpus.scales, corpus.norms_sq,
                         metric)
