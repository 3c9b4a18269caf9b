"""BERT-style dual encoder: batch embedding of chunks and queries (port of
the JAX package's models/encoder.py).

A post-LN transformer encoder with mean pooling and L2 normalisation.
The modules are named as the flax modules are (``backbone.layer_0.
attention.query`` ...), so a flax parameter tree maps onto them by name
(``load_flax_params`` / ``flax_params``), and the numerics follow flax's
op by op:

- ``Dense``: inputs, kernel and bias cast to the activation dtype; the
  product is rounded to it, then the bias is added (no fused addmm);
- ``Embed``: the table cast to the activation dtype, then gathered;
- ``LayerNorm``: mean and E[x^2] in f32 (flax's fast variance), output
  cast to the activation dtype;
- attention scores divided by sqrt(head dim) in the activation dtype,
  masked with -1e9, softmax in f32, cast back;
- exact (erfc) GELU; mean pool in the activation dtype, then f32 and the
  L2 norm with a zero-norm guard.

Parameters are stored in f32 (flax's ``param_dtype``) and cast at each
call.  The products and the attention are plain PyTorch ops: the JAX
package computes them as XLA ops, outside any Pallas kernel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

# Sequence-length buckets: pad each batch to the smallest bucket that fits,
# so a model sees few distinct shapes.
SEQ_BUCKETS = (64, 128, 256, 512)

MASK_VALUE = -1e9


def bucket_length(n: int) -> int:
    for b in SEQ_BUCKETS:
        if n <= b:
            return b
    return SEQ_BUCKETS[-1]


@dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 30522
    hidden_dim: int = 384
    num_layers: int = 6
    num_heads: int = 12
    mlp_dim: int = 1536
    max_len: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    embed_dim: Optional[int] = None  # projection dim; None = hidden_dim
    dtype: torch.dtype = torch.bfloat16  # activation dtype

    @property
    def out_dim(self) -> int:
        return self.embed_dim or self.hidden_dim


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"`` (the name numpy and JAX use)."""
    return str(dtype).removeprefix("torch.")


def dtype_from_name(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"unknown activation dtype {name!r}")
    return dtype


class Dense(nn.Module):
    """flax ``nn.Dense``: ``weight`` is the flax kernel transposed."""

    def __init__(self, din: int, dout: int, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(dout, din))
        self.bias = nn.Parameter(torch.zeros(dout))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x.to(self.dtype), self.weight.to(self.dtype).T)
        return y + self.bias.to(self.dtype)


class Embed(nn.Module):
    """flax ``nn.Embed``."""

    def __init__(self, num: int, features: int, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(num, features))
        self.dtype = dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.weight.to(self.dtype)[ids.long()]


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: statistics in f32 with the fast variance
    ``max(E[x^2] - E[x]^2, 0)``, scale and bias applied in f32."""

    def __init__(self, features: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mu) * mul + self.bias).to(self.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU as JAX writes it: 0.5 x erfc(-x sqrt(1/2))."""
    sqrt_half = torch.tensor(np.sqrt(0.5), dtype=x.dtype, device=x.device)
    return 0.5 * x * torch.erfc(-x * sqrt_half)


class SelfAttention(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        h = cfg.hidden_dim
        self.cfg = cfg
        self.query = Dense(h, h, cfg.dtype)
        self.key = Dense(h, h, cfg.dtype)
        self.value = Dense(h, h, cfg.dtype)
        self.out = Dense(h, h, cfg.dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, s, h = x.shape
        hd = h // cfg.num_heads
        # the heads this module holds: all of them, or a tensor-parallel
        # rank's share (train/contrastive.py shard_params)
        q = self.query(x).view(b, s, -1, hd)
        k = self.key(x).view(b, s, -1, hd)
        v = self.value(x).view(b, s, -1, hd)
        # sqrt is taken in f32 and rounded to the activation dtype
        scale = torch.tensor(math.sqrt(hd), dtype=torch.float32,
                             device=x.device).to(cfg.dtype)
        att = torch.einsum("bqhd,bkhd->bhqk", q, k) / scale
        att = att.masked_fill(~mask[:, None, None, :], MASK_VALUE)
        att = torch.softmax(att.float(), dim=-1).to(cfg.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(b, s, -1)
        return self.out(out)


class Block(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.attention = SelfAttention(cfg)
        self.attention_ln = LayerNorm(cfg.hidden_dim, cfg.layer_norm_eps, cfg.dtype)
        self.mlp_in = Dense(cfg.hidden_dim, cfg.mlp_dim, cfg.dtype)
        self.mlp_out = Dense(cfg.mlp_dim, cfg.hidden_dim, cfg.dtype)
        self.mlp_ln = LayerNorm(cfg.hidden_dim, cfg.layer_norm_eps, cfg.dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        # post-LN (BERT): residual, then LayerNorm
        x = self.attention_ln(x + self.attention(x, mask))
        m = self.mlp_out(gelu(self.mlp_in(x)))
        return self.mlp_ln(x + m)


class Backbone(nn.Module):
    """Token embeddings + transformer stack; returns per-token states."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.token_embed = Embed(cfg.vocab_size, cfg.hidden_dim, cfg.dtype)
        self.position_embed = Embed(cfg.max_len, cfg.hidden_dim, cfg.dtype)
        if cfg.type_vocab_size:
            self.type_embed = Embed(cfg.type_vocab_size, cfg.hidden_dim, cfg.dtype)
        self.embed_ln = LayerNorm(cfg.hidden_dim, cfg.layer_norm_eps, cfg.dtype)
        for li in range(cfg.num_layers):
            self.add_module(f"layer_{li}", Block(cfg))

    def forward(self, token_ids, mask, token_type_ids=None) -> torch.Tensor:
        cfg = self.cfg
        s = token_ids.shape[1]
        if s > cfg.max_len:
            raise ValueError(f"sequence of {s} tokens exceeds the position "
                             f"table ({cfg.max_len})")
        pos = torch.arange(s, device=token_ids.device)
        x = self.token_embed(token_ids) + self.position_embed(pos)[None]
        if cfg.type_vocab_size:
            tt = (token_type_ids if token_type_ids is not None
                  else torch.zeros_like(token_ids))
            x = x + self.type_embed(tt)
        x = self.embed_ln(x)
        for li in range(cfg.num_layers):
            x = getattr(self, f"layer_{li}")(x, mask)
        return x


class TextEncoder(nn.Module):
    """Mean-pooled, L2-normalised sentence encoder: ``(ids, mask) ->
    [B, out_dim]`` f32."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = Backbone(cfg)
        if cfg.embed_dim and cfg.embed_dim != cfg.hidden_dim:
            self.proj = Dense(cfg.hidden_dim, cfg.embed_dim, cfg.dtype)

    def forward(self, token_ids, mask, token_type_ids=None) -> torch.Tensor:
        mask = mask.bool()
        x = self.backbone(token_ids, mask, token_type_ids)
        m = mask[..., None].to(x.dtype)
        # sums taken in f32 and rounded to the activation dtype
        pooled = (x * m).float().sum(1).to(x.dtype) / torch.clamp(
            m.float().sum(1).to(x.dtype), min=1.0)
        if hasattr(self, "proj"):
            pooled = self.proj(pooled)
        pooled = pooled.float()
        norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
        return pooled / torch.where(norm > 0, norm, torch.ones_like(norm))


# -- parameters: flax initialisers and the flax tree <-> module mapping -------

_LEAF = {"kernel": "weight", "embedding": "weight", "scale": "weight",
         "bias": "bias"}


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter from the distribution of the flax initialiser
    the JAX modules use: Dense kernels lecun-normal (truncated at two
    standard deviations), biases zero, embeddings N(0, 1/features),
    LayerNorm scale one and bias zero.  ``generator`` lives on the
    parameters' device."""
    for m in module.modules():
        if isinstance(m, Dense):
            std = math.sqrt(1.0 / m.weight.shape[1]) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
            m.weight.mul_(std)
            m.bias.zero_()
        elif isinstance(m, Embed):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.weight.shape[1]),
                             generator=generator)
        elif isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return module


def flatten_tree(tree: Mapping, prefix: str = "") -> dict:
    """Nested flax parameter tree -> ``{"a/b/kernel": array}`` (flat keys
    pass through)."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            flat.update(flatten_tree(v, key))
        else:
            flat[key] = v
    return flat


def load_flax_params(module: nn.Module, params: Mapping) -> nn.Module:
    """Copy a flax parameter tree (nested, or flat ``"a/b/kernel"`` keys;
    numpy arrays or anything ``np.asarray`` takes) into ``module``.
    Raises on a missing or an extra key and on a shape mismatch."""
    flat = flatten_tree(params)
    state = module.state_dict()
    got = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        if leaf not in _LEAF:
            raise ValueError(f"unexpected parameter {key!r}")
        name = ".".join(path + [_LEAF[leaf]])
        arr = np.asarray(value, np.float32)
        if leaf == "kernel":
            arr = arr.T
        if name not in state:
            raise ValueError(f"parameter {key!r} has no place in "
                             f"{type(module).__name__}")
        if tuple(arr.shape) != tuple(state[name].shape):
            raise ValueError(f"parameter {key!r} has shape {arr.shape}, "
                             f"expected {tuple(state[name].shape)}")
        got[name] = torch.tensor(arr)
    missing = sorted(set(state) - set(got))
    if missing:
        raise ValueError(f"parameters missing: {missing}")
    module.load_state_dict(got)
    return module


def flax_params(module: nn.Module) -> dict:
    """``module``'s parameters as the nested flax tree of f32 numpy arrays
    (Dense kernels ``[in, out]``), the layout the JAX package saves."""
    kinds = {}
    for mname, m in module.named_modules():
        if isinstance(m, Dense):
            kinds[mname] = ("kernel", "bias")
        elif isinstance(m, Embed):
            kinds[mname] = ("embedding",)
        elif isinstance(m, LayerNorm):
            kinds[mname] = ("scale", "bias")
    tree: dict = {}
    for mname, leaves in kinds.items():
        m = module.get_submodule(mname)
        node = tree
        for part in mname.split("."):
            node = node.setdefault(part, {})
        for leaf in leaves:
            arr = getattr(m, _LEAF[leaf]).detach().float().cpu().numpy()
            node[leaf] = arr.T.copy() if leaf == "kernel" else arr.copy()
    return tree
