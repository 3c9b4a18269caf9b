"""Cross-encoder reranker (port of the JAX package's
models/cross_encoder.py).

Top-K candidates of a hybrid search are tokenized as
``[CLS] query [SEP] doc [SEP]`` pairs and scored in batched forwards
(BASELINE.md config #4: top-100 -> top-5).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from super_rag_tpu_torch.models.encoder import Backbone, Dense, EncoderConfig


class CrossEncoder(nn.Module):
    """CLS-pooled pair scorer; higher = more relevant.  ``(ids, mask,
    type ids) -> [B]`` f32."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = Backbone(cfg)
        self.pooler = Dense(cfg.hidden_dim, cfg.hidden_dim, cfg.dtype)
        self.classifier = Dense(cfg.hidden_dim, 1, torch.float32)

    def forward(self, token_ids, mask, token_type_ids=None) -> torch.Tensor:
        x = self.backbone(token_ids, mask.bool(), token_type_ids)
        # BERT pooler: tanh(dense(CLS)), then an f32 1-dim head
        pooled = torch.tanh(self.pooler(x[:, 0, :]))
        return self.classifier(pooled.float())[..., 0]


def rerank_scores(model: CrossEncoder, token_ids: torch.Tensor,
                  mask: torch.Tensor,
                  token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scores of packed pairs ``[B*K, S]`` -> ``[B*K]``."""
    with torch.inference_mode():
        return model(token_ids, mask, token_type_ids)
