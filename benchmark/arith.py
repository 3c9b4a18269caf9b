"""The yardstick's arithmetic: the card's published peaks, the least time a
piece of work can take on them, operation counts of the models' forwards
and of the dense scan, and the statistics the end-to-end metrics use.

Frozen copies, kept here so that a change to the program cannot move the
yardstick: ``bound_s`` is ``chip_smoke.py:485 bound_ms`` in seconds, the
peaks are ``chip_smoke.py:442-446`` (NVIDIA's H100 SXM data sheet, dense
rates), and ``encoder_flops`` is ``chip_smoke.py:1835`` at one sequence
length per row.
"""

from __future__ import annotations

import math
from typing import Iterable, Sequence

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {
    "int8": 1979e12,
    "float8": 1979e12,
    "bfloat16": 989e12,
    "float16": 989e12,
    "tf32": 495e12,
    "float32": 67e12,
}


def bound_s(nbytes: float, ops: float, ops_per_s: float) -> tuple[float, str]:
    """The least time for ``ops`` operations and ``nbytes`` bytes of HBM
    traffic: the larger of the two times, and which of them it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def encoder_flops(lengths: Iterable[int], hidden: int, mlp: int, layers: int,
                  pooler: bool = False) -> float:
    """Multiply-adds x 2 of BERT forwards over rows of the given token
    counts, each at its own length (no padding): the Q, K, V and output
    products, the two attention products and the MLP of every layer, and
    with ``pooler`` the cross-encoder's pooler and one-logit head."""
    total = 0.0
    for s in lengths:
        per_layer = 2.0 * s * (4 * hidden * hidden + 2 * hidden * mlp) + 4.0 * s * s * hidden
        total += layers * per_layer
        if pooler:
            total += 2.0 * (hidden * hidden + hidden)
    return total


ELEM_BYTES = {"int8": 1, "bfloat16": 2, "float16": 2, "float32": 4}


def dense_topk_work(b: int, n: int, d: int, num_tiles: int, kt: int,
                    storage: str, query: str) -> tuple[float, float]:
    """(operations, bytes) of one per-tile top-k launch over ``n`` rows:
    2 B N D for the products; each input byte read once (the rows, their
    int8 scales, the one-byte row mask, the queries and their int8
    scales) and the per-tile lists written once (f32 score + i32 row)."""
    ops = 2.0 * b * n * d
    nbytes = n * d * ELEM_BYTES[storage] + n  # rows, mask
    if storage == "int8":
        nbytes += n * 4  # row scales
    nbytes += b * d * ELEM_BYTES[query]
    if query == "int8":
        nbytes += b * 4
    nbytes += num_tiles * b * kt * 8
    return ops, nbytes


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least ``q`` %
    of the values at or below it (a missing answer is ``inf``)."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]
