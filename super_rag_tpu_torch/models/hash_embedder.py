"""Deterministic hash embedder — the engine's weight-free default encoder
(port of the JAX package's models/hash_embedder.py).

Terms hash to buckets; each bucket owns a fixed random projection row
(the same numpy draw as the JAX package, so both packages embed alike);
a text embeds as the L2-normalised mean of its term rows.  The sum over
terms is a fixed loop of elementwise adds in term order and the norm a
fixed tree (``row_norm``), so a text embeds to the same bits in any batch
and on any device.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from super_rag_tpu_torch.device import DeviceLike, resolve_device
from super_rag_tpu_torch.ops.dense import row_norm
from super_rag_tpu_torch.tokenize.analyzer import Analyzer


@functools.lru_cache(maxsize=8)
def _projection(buckets: int, dim: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((buckets + 1, dim), dtype=np.float32)
    table[buckets] = 0.0  # pad bucket row is zero
    table.setflags(write=False)
    return table


@dataclass
class HashEmbedder:
    dim: int = 256
    buckets: int = 1 << 14
    seed: int = 7
    max_terms: int = 64
    analyzer: Analyzer = field(default_factory=lambda: Analyzer(vocab_size=1 << 14))
    device: DeviceLike = None
    _table: Optional[torch.Tensor] = field(default=None, init=False, repr=False)

    def __post_init__(self):
        if self.analyzer.vocab_size != self.buckets:
            self.analyzer = Analyzer(vocab_size=self.buckets)
        self.device = resolve_device(self.device)

    def _ids(self, texts: list[str]) -> np.ndarray:
        out = np.full((len(texts), self.max_terms), self.buckets, np.int32)
        for i, t in enumerate(texts):
            ids = self.analyzer.term_ids(t)[: self.max_terms]
            out[i, : len(ids)] = ids
        return out

    def embed(self, texts: list[str]) -> torch.Tensor:
        """[len(texts), dim] f32 L2-normalised embeddings on the
        embedder's device."""
        if self._table is None:
            self._table = torch.tensor(
                _projection(self.buckets, self.dim, self.seed),
                device=self.device)
        ids = self._ids(texts)
        count = (ids != self.buckets).sum(1, keepdims=True)
        width = int(count.max()) if len(texts) else 0  # terms fill from 0
        ids_d = torch.from_numpy(ids[:, :width]).to(self.device)
        # pad rows are zero and x + 0.0 == x, so the width of the batch
        # does not change a row's bits
        acc = torch.zeros((len(texts), self.dim), dtype=torch.float32,
                          device=self.device)
        for j in range(width):
            acc = acc + self._table[ids_d[:, j]]
        cnt = torch.from_numpy(np.maximum(count, 1).astype(np.float32))
        mean = acc / cnt.to(self.device)
        norm = row_norm(mean)
        return mean / torch.where(norm > 0, norm, torch.ones_like(norm))
