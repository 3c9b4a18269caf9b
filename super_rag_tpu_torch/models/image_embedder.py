"""Offline image embedder: perceptual-DCT features -> index-dim vectors
(port of the JAX package's models/image_embedder.py; the same seeded
projection, so both packages embed an image alike).

The reference's vision index embeds page images through a remote
multimodal model (super_rag/index/vision_index.py:33-39).  This image
has no multimodal checkpoint, so the offline tier is a perceptual
embedding — a real (if shallow) visual signature, not a placeholder:

  decode (``image_decode``: PNG, BMP, baseline JPEG; Pillow's pixels bit
  for bit, without Pillow) -> grayscale 64x64 -> 2D DCT -> low-frequency 12x12 block
  (DC dropped) -> per-feature sign-log scaling -> fixed seeded random
  projection to the index dim -> L2 normalize.

Nearby crops/rescales/compressions of the same image land close in this
space (the classic pHash property), so image->image retrieval works with
zero trained weights.  Cross-modal text->image retrieval rides the
caption text through the BM25 branch instead (index/vision.py ladder).
A trained vision tower can replace this via the same ``embed`` contract.
"""

from __future__ import annotations

import numpy as np

from .image_decode import ImageDecodeError, gray64

_BLOCK = 12  # low-frequency DCT block kept (144 features minus DC)
_SIZE = 64


def _dct_matrix(n: int) -> np.ndarray:
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.cos(np.pi * (2 * i + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    m[0] *= 1.0 / np.sqrt(2.0)
    return m.astype(np.float32)


_DCT = _dct_matrix(_SIZE)


class ImageEmbedder:
    """``embed(list[bytes]) -> [B, dim] float32`` (unit-norm rows)."""

    def __init__(self, dim: int, seed: int = 7):
        self.dim = dim
        n_feat = _BLOCK * _BLOCK - 1
        rng = np.random.default_rng(seed)
        # fixed projection: same seed -> same space across processes
        self._proj = (rng.standard_normal((n_feat, dim)) /
                      np.sqrt(n_feat)).astype(np.float32)

    def _features(self, data: bytes) -> np.ndarray:
        px = gray64(data, _SIZE).astype(np.float32) / 255.0
        coeffs = _DCT @ px @ _DCT.T
        block = coeffs[:_BLOCK, :_BLOCK].reshape(-1)[1:]  # drop DC
        # sign-log scaling tames the 1/f energy falloff so no single
        # coefficient dominates the projection
        return np.sign(block) * np.log1p(np.abs(block))

    def embed(self, images: list[bytes]) -> np.ndarray:
        out = np.zeros((len(images), self.dim), np.float32)
        for j, data in enumerate(images):
            try:
                f = self._features(data)
            except ImageDecodeError:  # no image, or corrupt data -> zeros
                continue
            v = f @ self._proj
            n = np.linalg.norm(v)
            if n > 0:
                out[j] = v / n
        return out


def embed_image(data: bytes, dim: int) -> np.ndarray:
    """``[1, dim]``: one image's embedding.  Module-level and host-only,
    so a worker process can run it (``AppContext.host_pool``)."""
    return ImageEmbedder(dim=dim).embed([data])
