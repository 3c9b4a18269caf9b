"""Top-k selection with the JAX package's tie order.

``jax.lax.top_k`` puts the lowest index first among equal values;
``torch.topk`` gives no such promise (``topk([1,3,3,3,0,3], 3)`` returns
``[3, 5, 2]`` on the CPU).  ``stable_topk`` sorts stably instead, so every
selection below ranks ties by position as the reference does.
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")


def stable_topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` over the last axis: value descending, lowest index first
    among ties.  Returns ``(values, int64 positions)``."""
    v, pos = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], pos[..., :k]


def blockwise_topk(
    scores: torch.Tensor, k: int, block_size: int = 2048
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis via per-block selection and a merge
    (port of ops/topk.py:33).  Returns ``(values, int32 indices)``."""
    *lead, n = scores.shape
    if n <= block_size or n <= 4 * k:
        v, i = stable_topk(scores, min(k, n))
        return v, i.to(torch.int32)
    kb = min(k, block_size)
    pad = (-n) % block_size
    s = torch.nn.functional.pad(scores, (0, pad), value=NEG_INF)
    num_blocks = s.shape[-1] // block_size
    s = s.reshape(*lead, num_blocks, block_size)
    v, i = stable_topk(s, kb)
    base = (torch.arange(num_blocks, device=s.device) * block_size)[:, None]
    gi = (i + base).reshape(*lead, num_blocks * kb)
    v = v.reshape(*lead, num_blocks * kb)
    fv, fi = stable_topk(v, k)
    return fv, torch.gather(gi, -1, fi).to(torch.int32)


def merge_topk(
    values: torch.Tensor, indices: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge concatenated candidate lists ``[..., m]`` down to top-k."""
    v, pos = stable_topk(values, k)
    return v, torch.gather(indices, -1, pos)
