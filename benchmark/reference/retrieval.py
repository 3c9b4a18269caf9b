"""Plain retrieval arithmetic of the reference: stored rows, cosine
scores, Okapi BM25 with Lucene's idf, reciprocal rank fusion and the
z-scored rerank fusion.  Float32 or float64; ``bfloat16`` and the lower
storage types only where a control asks for them.  Imports nothing of
the program.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

K1, B = 1.2, 0.75
LEVELS = {"int8": 127.0, "int4": 7.0}


def unit_rows(x: torch.Tensor) -> torch.Tensor:
    n = x.norm(dim=-1, keepdim=True)
    return x / torch.where(n > 0, n, torch.ones_like(n))


def stored_rows(x: torch.Tensor, storage: str) -> torch.Tensor:
    """Unit rows as stored in ``storage``, back in f32: per-row symmetric
    integer codes times their scale (max |x| / levels, round half to
    even), float8 e4m3 with a per-row scale, the row rounded to bfloat16,
    or as it is in float32."""
    if storage in LEVELS:
        scale = x.abs().amax(-1, keepdim=True) / LEVELS[storage]
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        q = torch.clamp(torch.round(x / safe), -LEVELS[storage], LEVELS[storage])
        return q * scale
    if storage == "float8":
        scale = x.abs().amax(-1, keepdim=True).clamp(min=1e-30) / 448.0
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    if storage == "bfloat16":
        return x.to(torch.bfloat16).float()
    if storage == "float32":
        return x
    raise ValueError(f"no stored form for {storage!r}")


def idf(df: np.ndarray, n: int) -> np.ndarray:
    """Robertson-Sparck-Jones idf with +1 inside the log (Lucene)."""
    df = df.astype(np.float64)
    return np.log(1.0 + (n - df + 0.5) / (df + 0.5))


def saturation(tfs: torch.Tensor, doc_len: torch.Tensor, avgdl: float,
               dtype=torch.float64) -> torch.Tensor:
    """``[rows, slots]`` tf (k1 + 1) / (tf + k1 (1 - b + b dl / avgdl)),
    computed in ``dtype``."""
    tf = tfs.to(dtype)
    norm = K1 * (1.0 - B + B * doc_len.to(dtype)[:, None] / avgdl)
    return tf * (K1 + 1.0) / (tf + norm.to(dtype))


def bm25_rows(idf_table: torch.Tensor, terms: torch.Tensor, sat: torch.Tensor) -> torch.Tensor:
    """BM25 of each row ``[rows]`` for one query: over the row's slots (a
    term held in two slots counts twice), the slot's term's idf
    (``idf_table`` [vocab + 1], 0 for a term not in the query and for the
    pad) times its ``saturation``."""
    return (idf_table[terms.long()] * sat).sum(-1)


def rrf(dense_ids: Sequence[int], lex_ids: Sequence[int], rrf_k: float = 60.0,
        dtype=np.float64) -> dict:
    """Row -> fused score: the sum over the two ranked lists of
    1 / (rrf_k + rank), rank counted from 1 (rows < 0 are empty slots)."""
    out: dict = {}
    for ids in (dense_ids, lex_ids):
        for r, row in enumerate(ids):
            if row >= 0:
                out[row] = dtype(out.get(row, 0.0) + dtype(1.0) / dtype(rrf_k + r + 1))
    return out


def zscore(x: np.ndarray) -> np.ndarray:
    s = float(x.std())
    return (x - x.mean()) / (s if s > 1e-6 else 1.0)


def rerank_fuse(ce: np.ndarray, base: np.ndarray) -> np.ndarray:
    """The cross-encoder's and the retrieval's scores, each z-scored over
    the query's candidates, summed."""
    return zscore(np.asarray(ce, np.float64)) + zscore(np.asarray(base, np.float64))


def widest_gap(best: Sequence[float], got: Sequence[float]) -> float:
    """The largest amount by which the j-th best of ``got`` lies below the
    j-th best of ``best`` (both in the reference's scores); inf when
    ``got`` has fewer entries."""
    b = sorted(best, reverse=True)
    g = sorted(got, reverse=True)
    if len(g) < len(b):
        return math.inf
    return max((bj - gj for bj, gj in zip(b, g)), default=0.0)
