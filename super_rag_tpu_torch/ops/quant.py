"""Int8 vector quantization (port of the JAX package's ops/quant.py).

Per-row symmetric quantization: ``row_int8 = round(row / scale)`` with
``scale = max|row| / 127``; rounding is half to even (``torch.round``),
and all-zero rows get scale 0.
"""

from __future__ import annotations

import torch


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``[N, D]`` float rows to int8 with per-row scales.

    Returns ``(values_int8 [N, D], scales_f32 [N])``.  The divisors are
    device tensors, not Python scalars: CUDA turns division by a host
    scalar into a multiply by its reciprocal, which can differ in the
    last bit from the true quotient the CPU and the JAX package compute.
    """
    x = x.to(torch.float32)
    absmax = x.abs().amax(dim=-1)
    scale = absmax / absmax.new_tensor(127.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x / safe[..., None]), -127, 127).to(torch.int8)
    return q, scale
