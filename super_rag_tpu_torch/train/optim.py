"""The trainers' optimizer: optax's ``chain(clip_by_global_norm(clip),
adamw(schedule, weight_decay))`` in PyTorch, number for number.

The JAX package's two trainers build it in ``_optimizer``
(``train/contrastive.py``, ``train/rerank.py``).  What optax does, and so
what this does:

- the global norm is ``sqrt(sum of every leaf's sum of squares)``; at or
  above ``clip`` every gradient is scaled by ``clip / norm`` (no epsilon,
  unlike ``torch.nn.utils.clip_grad_norm_``);
- Adam moments in f32 with b1 0.9, b2 0.999, bias correction by the
  incremented count (``b ** count`` rounded once to f32), and eps 1e-8
  outside the square root;
- decoupled weight decay on every parameter (biases, LayerNorm and
  embeddings too), added to the Adam direction before the step size;
- the step size is the schedule at the count *before* the update, so a
  schedule that warms up from 0 moves no parameter on the first update,
  and ``linear_schedule(0, lr, 0)`` (``warmup_steps=0`` with no
  ``total_steps``) stays 0 for ever.

Every scalar is an f32 tensor, as optax's are.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence

import torch

B1 = 0.9
B2 = 0.999
EPS = 1e-8


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _pow_f32(base: float, n: int) -> torch.Tensor:
    """``f32(base) ** n`` rounded once to f32, as optax's bias correction
    comes out (torch's f32 pow can land one ulp away).  Adam's ``1 - b2 **
    n`` cancels to a few bits, so that ulp matters."""
    return _f32(float(torch.tensor(base, dtype=torch.float32)) ** n)


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Callable[[int], torch.Tensor]:
    """optax ``linear_schedule``: ``init_value`` held fixed when
    ``transition_steps <= 0``."""
    if transition_steps <= 0:
        return lambda count: _f32(init_value)

    def schedule(count: int) -> torch.Tensor:
        c = _f32(min(max(count, 0), transition_steps))
        frac = 1 - c / transition_steps
        return _f32(init_value - end_value) * frac + _f32(end_value)

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], torch.Tensor]:
    """optax ``cosine_decay_schedule`` (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> torch.Tensor:
        c = torch.minimum(_f32(count), _f32(decay_steps))
        cosine = 0.5 * (1 + torch.cos(_f32(math.pi) * c / _f32(decay_steps)))
        return _f32(init_value) * ((1 - _f32(alpha)) * cosine + _f32(alpha))

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Callable[[int], torch.Tensor]:
    """optax ``warmup_cosine_decay_schedule``: linear warmup, then cosine
    decay to ``end_value`` at ``decay_steps``."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)
    return lambda count: warm(count) if count < warmup_steps else decay(count - warmup_steps)


def trainer_schedule(learning_rate: float, warmup_steps: int,
                     total_steps: Optional[int]) -> Callable[[int], torch.Tensor]:
    """The trainers' schedule: warmup to ``learning_rate``, then cosine to
    2 % of it at ``total_steps`` when that is set, else constant."""
    if total_steps:
        return warmup_cosine_decay_schedule(
            0.0, learning_rate, warmup_steps, max(total_steps, warmup_steps + 1),
            end_value=learning_rate * 0.02)
    return linear_schedule(0.0, learning_rate, warmup_steps)


class AdamWState(NamedTuple):
    count: int  # updates applied so far
    mu: list  # first moments, f32, one per parameter
    nu: list  # second moments


class ClippedAdamW:
    """``chain(clip_by_global_norm(grad_clip), adamw(schedule,
    weight_decay))`` over a list of f32 parameter tensors, updated in
    place."""

    def __init__(self, schedule: Callable[[int], torch.Tensor],
                 weight_decay: float, grad_clip: float):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip

    def init(self, params: Sequence[torch.Tensor]) -> AdamWState:
        return AdamWState(0, [torch.zeros_like(p, dtype=torch.float32) for p in params],
                          [torch.zeros_like(p, dtype=torch.float32) for p in params])

    @torch.no_grad()
    def update(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
               state: AdamWState, g_norm: Optional[torch.Tensor] = None
               ) -> tuple[AdamWState, torch.Tensor]:
        """Apply one update to ``params`` in place; returns the new state
        and the gradients' global norm before clipping (an f32 scalar on
        the parameters' device).  ``g_norm`` is that norm when the caller
        holds only part of the gradients (a tensor-parallel rank's
        shards), so it must come from every rank's."""
        dev = params[0].device
        if g_norm is None:
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = g_norm < self.grad_clip  # on the device: no host sync
        grads = [torch.where(keep, g, (g / g_norm) * self.grad_clip) for g in grads]
        count = state.count + 1
        bc1 = (1 - _pow_f32(B1, count)).to(dev)
        bc2 = (1 - _pow_f32(B2, count)).to(dev)
        step_size = (-self.schedule(state.count)).to(dev)
        mu, nu = [], []
        for p, g, m, v in zip(params, grads, state.mu, state.nu):
            m = (1 - B1) * g + B1 * m
            v = (1 - B2) * (g * g) + B2 * v
            u = (m / bc1) / (torch.sqrt(v / bc2) + EPS)
            u = u + self.weight_decay * p
            p.add_(step_size * u)
            mu.append(m)
            nu.append(v)
        return AdamWState(count, mu, nu), g_norm


def trainer_optimizer(learning_rate: float, weight_decay: float, warmup_steps: int,
                      grad_clip: float, total_steps: Optional[int]) -> ClippedAdamW:
    """The JAX trainers' ``_optimizer(cfg)``."""
    return ClippedAdamW(trainer_schedule(learning_rate, warmup_steps, total_steps),
                        weight_decay, grad_clip)
