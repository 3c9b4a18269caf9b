"""EncoderService: the batch embedder behind the engine (port of the JAX
package's models/encoder_service.py).

Wraps ``TextEncoder`` with tokenization, sequence-length bucketing and a
fixed batch size, and satisfies the engine's embedder protocol
(``.embed(texts) -> [B, dim]``, ``.dim``).  Parameters load from the npz
+ json checkpoint the JAX package writes (``save_params`` /
``load_params`` read and write the same format, so a checkpoint moves
between the two packages both ways), from a local HF BERT checkpoint, or
are drawn from flax's initialisers with a seed.
"""

from __future__ import annotations

import json
import os
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from super_rag_tpu_torch.device import DeviceLike, resolve_device
from super_rag_tpu_torch.models.encoder import (
    EncoderConfig, TextEncoder, dtype_from_name, dtype_name, flatten_tree,
    init_params, load_flax_params)
from super_rag_tpu_torch.models.tokenization import HashTokenizer

# the JAX package's services default to this shape when given no config
DEFAULT_CONFIG = EncoderConfig(vocab_size=30522, hidden_dim=256, num_layers=4,
                               num_heads=8, mlp_dim=1024, max_len=512)


def save_params(params, path: str, cfg: EncoderConfig) -> None:
    """Write a flax parameter tree (nested or flat keys; a module's is
    ``models/encoder.flax_params(module)``) as ``path.npz`` + the config
    sidecar ``path.json``."""
    flat = {k: np.asarray(v) for k, v in flatten_tree(params).items()}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path + ".npz", **flat)
    cfg_dict = dict(cfg.__dict__)
    cfg_dict["dtype"] = dtype_name(cfg.dtype)
    with open(path + ".json", "w") as f:
        json.dump(cfg_dict, f)


def load_config(path: str) -> EncoderConfig:
    with open(path + ".json") as f:
        cfg_dict = json.load(f)
    cfg_dict["dtype"] = dtype_from_name(cfg_dict["dtype"])
    if cfg_dict.get("embed_dim") is not None:
        cfg_dict["embed_dim"] = int(cfg_dict["embed_dim"])
    return EncoderConfig(**cfg_dict)


def load_params(path: str) -> tuple[dict, EncoderConfig]:
    """(nested flax parameter tree of numpy arrays, config)."""
    cfg = load_config(path)
    tree: dict = {}
    with np.load(path + ".npz") as z:
        for key in z.files:
            parts = key.split("/")
            cur = tree
            for p in parts[:-1]:
                cur = cur.setdefault(p, {})
            cur[parts[-1]] = z[key]
    return tree, cfg


def tokenizer_sidecar(path: str):
    """The BPE tokenizer saved next to a checkpoint, or None: serving must
    tokenize exactly as training did."""
    tok_path = path + ".tokenizer.json"
    if not os.path.exists(tok_path):
        return None
    from super_rag_tpu_torch.models.subword import BPETokenizer

    return BPETokenizer.load(tok_path)


def build_model(model_cls, cfg: EncoderConfig, params: Optional[Mapping],
                seed: int, device: torch.device) -> torch.nn.Module:
    """``model_cls(cfg)`` on ``device`` in eval mode, with ``params`` (a
    flax tree) or weights drawn from the flax initialisers with ``seed``."""
    model = model_cls(cfg)
    if params is not None:
        load_flax_params(model, params)
    else:
        init_params(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def hf_checkpoint(path: str, to_params):
    """(config, flax tree, HFTokenizer) of a local HF BERT checkpoint."""
    from transformers import AutoConfig

    from super_rag_tpu_torch.models.hf_loader import config_from_hf
    from super_rag_tpu_torch.models.tokenization import HFTokenizer

    cfg = config_from_hf(AutoConfig.from_pretrained(path, local_files_only=True))
    sd = torch.load(os.path.join(path, "pytorch_model.bin"), map_location="cpu")
    return cfg, to_params(sd, cfg), HFTokenizer(path)


def pad_batch(arrays: Sequence[np.ndarray], rows: int) -> list[np.ndarray]:
    """Pad each array's batch dim to ``rows`` with zeros."""
    return [np.pad(a, ((0, rows - len(a)), (0, 0))) for a in arrays]


class EncoderService:
    """Batch embedder over TextEncoder with bucketed fixed shapes.
    ``device`` None means the CUDA card (raises without one)."""

    def __init__(self, cfg: Optional[EncoderConfig] = None, params=None,
                 tokenizer=None, batch_size: int = 128, max_len: int = 256,
                 seed: int = 0, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg = cfg or DEFAULT_CONFIG
        self.model = build_model(TextEncoder, self.cfg, params, seed, self.device)
        self.tokenizer = tokenizer or HashTokenizer(vocab_size=self.cfg.vocab_size)
        self.batch_size = batch_size
        # never tokenize past the position table
        self.max_len = min(max_len, self.cfg.max_len)

    @classmethod
    def from_checkpoint(cls, path: str, **kw) -> "EncoderService":
        params, cfg = load_params(path)
        if "tokenizer" not in kw:
            kw["tokenizer"] = tokenizer_sidecar(path)
        return cls(cfg=cfg, params=params, **kw)

    @classmethod
    def from_hf_checkpoint(cls, path: str, **kw) -> "EncoderService":
        from super_rag_tpu_torch.models.hf_loader import encoder_params_from_bert

        cfg, params, tok = hf_checkpoint(path, encoder_params_from_bert)
        return cls(cfg=cfg, params=params, tokenizer=tok, **kw)

    @property
    def dim(self) -> int:
        return self.cfg.out_dim

    def _forward(self, block: list[str]) -> torch.Tensor:
        ids, mask = self.tokenizer.encode_batch(block, max_len=self.max_len)
        # pad the batch dim to the fixed size: one shape per sequence bucket
        ids, mask = pad_batch((ids, mask), self.batch_size)
        with torch.inference_mode():
            return self.model(torch.from_numpy(ids).to(self.device),
                              torch.from_numpy(mask).to(self.device))

    def embed_device(self, texts: Sequence[str]) -> torch.Tensor:
        """``[len(texts), dim]`` f32 embeddings, left on the service's
        device (no host sync)."""
        texts = list(texts)
        if not texts:
            return torch.zeros((0, self.dim), dtype=torch.float32,
                               device=self.device)
        bs = self.batch_size
        outs = [self._forward(texts[i : i + bs])[: len(texts[i : i + bs])]
                for i in range(0, len(texts), bs)]
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        """``[len(texts), dim]`` f32 embeddings as a numpy array."""
        return self.embed_device(texts).cpu().numpy()
