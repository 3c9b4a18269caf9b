"""Reciprocal rank fusion of two id lists (port of ops/fusion.py:21)."""

from __future__ import annotations

import torch

from super_rag_tpu_torch.ops.topk import NEG_INF, stable_topk


def rrf_fuse(
    idx_a: torch.Tensor,  # [B, Ka] int, -1 = empty slot
    idx_b: torch.Tensor,  # [B, Kb] int, -1 = empty slot
    k: int,
    rrf_k: int = 60,
    weight_a: float = 1.0,
    weight_b: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fuse two ranked id lists with RRF; returns ``(scores, ids)`` top-k.

    score(d) = weight_a / (rrf_k + rank_a(d) + 1)
             + weight_b / (rrf_k + rank_b(d) + 1)

    An id in both lists is scored once, at its list-a slot.  The match
    sum adds at most one nonzero term per slot, so it is exact in any
    order.
    """
    dev = idx_a.device
    ka, kb = idx_a.shape[1], idx_b.shape[1]
    contrib_a = weight_a / (rrf_k + torch.arange(ka, device=dev, dtype=torch.float32) + 1.0)
    contrib_b = weight_b / (rrf_k + torch.arange(kb, device=dev, dtype=torch.float32) + 1.0)
    valid_a = idx_a >= 0
    valid_b = idx_b >= 0
    match = ((idx_a[:, :, None] == idx_b[:, None, :])
             & valid_a[:, :, None] & valid_b[:, None, :])
    score_a = torch.where(
        valid_a,
        contrib_a[None, :] + (match.to(torch.float32) * contrib_b).sum(-1),
        NEG_INF,
    )
    dup_b = match.any(dim=1)
    score_b = torch.where(valid_b & ~dup_b, contrib_b[None, :], NEG_INF)
    scores = torch.cat([score_a, score_b], dim=1)
    ids = torch.cat([idx_a, idx_b], dim=1)
    fv, pos = stable_topk(scores, min(k, ka + kb))
    fi = torch.gather(ids, -1, pos)
    fi = torch.where(fv > NEG_INF, fi, torch.full_like(fi, -1))
    return fv, fi
