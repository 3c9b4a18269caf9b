"""Device resolution for the port's entry points.

Every entry point takes ``device``; ``None`` means the CUDA card.  With no
card present that raises instead of falling back to the CPU in silence:
a CPU run must be asked for by name.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raises if the resolved device is CUDA and no
    CUDA device is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return dev


def check_device(t: torch.Tensor, device: DeviceLike) -> torch.device:
    """Resolve ``device`` and require ``t`` to live there."""
    dev = resolve_device(device)
    if t.device.type != dev.type or (dev.index is not None
                                     and t.device.index != dev.index):
        raise ValueError(f"tensor on {t.device}, call asked for {dev}")
    return dev
