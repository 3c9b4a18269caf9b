"""Cross-encoder rerank service (port of the JAX package's
service/rerank_service.py).

Pairs ``(query, doc)`` are tokenized on the host, padded to a fixed batch
of pairs and scored by ``models/cross_encoder.CrossEncoder`` on the
service's device.  At most ``MAX_RERANK_DOCS`` documents are scored per
call, as the reference's rerank API caps them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from super_rag_tpu_torch.device import DeviceLike, resolve_device
from super_rag_tpu_torch.models.cross_encoder import CrossEncoder, rerank_scores
from super_rag_tpu_torch.models.encoder import EncoderConfig
from super_rag_tpu_torch.models.encoder_service import (
    DEFAULT_CONFIG, build_model, hf_checkpoint, load_params, pad_batch,
    tokenizer_sidecar)
from super_rag_tpu_torch.models.tokenization import HashTokenizer

MAX_RERANK_DOCS = 1000


class RerankService:
    """Callable ``(query, texts) -> np.ndarray`` scores, usable directly
    as ``CollectionEngine``'s ``reranker``.  ``device`` None means the
    CUDA card (raises without one)."""

    def __init__(
        self,
        config: Optional[EncoderConfig] = None,
        params=None,
        tokenizer=None,
        max_len: int = 256,
        batch_size: int = 32,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.cfg = config or DEFAULT_CONFIG
        self.model = build_model(CrossEncoder, self.cfg, params, seed, self.device)
        self.tokenizer = tokenizer or HashTokenizer(vocab_size=self.cfg.vocab_size)
        # never tokenize past the position table: tokens beyond it have no
        # position embedding
        self.max_len = min(max_len, self.cfg.max_len)
        self.batch_size = batch_size

    @classmethod
    def from_checkpoint(cls, path: str, **kw) -> "RerankService":
        """A trained cross-encoder checkpoint (npz + json), with the BPE
        tokenizer saved next to it."""
        params, cfg = load_params(path)
        if "tokenizer" not in kw:
            kw["tokenizer"] = tokenizer_sidecar(path)
        return cls(config=cfg, params=params, **kw)

    @classmethod
    def from_hf_checkpoint(cls, path: str, **kw) -> "RerankService":
        """A local BertForSequenceClassification checkpoint."""
        from super_rag_tpu_torch.models.hf_loader import cross_encoder_params_from_bert

        cfg, params, tok = hf_checkpoint(path, cross_encoder_params_from_bert)
        return cls(config=cfg, params=params, tokenizer=tok, **kw)

    def __call__(self, query: str, texts: Sequence[str]) -> np.ndarray:
        texts = list(texts)[:MAX_RERANK_DOCS]
        if not texts:
            return np.zeros(0, np.float32)
        ids, mask, tt = self.tokenizer.encode_pairs(
            [query] * len(texts), texts, max_len=self.max_len)
        # pad the pair count to a multiple of the fixed batch size
        bs = self.batch_size
        ids, mask, tt = pad_batch((ids, mask, tt), -(-len(texts) // bs) * bs)
        ids, mask, tt = (torch.from_numpy(a).to(self.device) for a in (ids, mask, tt))
        scores = [rerank_scores(self.model, ids[i : i + bs], mask[i : i + bs],
                                tt[i : i + bs])
                  for i in range(0, len(ids), bs)]
        return torch.cat(scores)[: len(texts)].cpu().numpy()
