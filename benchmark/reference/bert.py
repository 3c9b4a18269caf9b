"""Plain BERT forwards from a HuggingFace state dict: the sentence encoder
(mean pooling, L2 normalised) and the cross-encoder (tanh pooler on
[CLS], one-logit head).

Written from the published architecture (Devlin et al., 2019; HF
``BertModel``): post-LayerNorm blocks, exact erf GELU, softmax over
keys with padding masked out.  Float32 with TF32 off, unless
``precision="float8"``, the control's precision: then every product's two
operands and every activation are rounded to float8 e4m3 (a per-tensor
scale), the normalisations and the softmax computed from those in f32.
Imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

FP8_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.abs().amax().clamp(min=1e-12)
    s = FP8_MAX / amax
    return (x * s).to(torch.float8_e4m3fn).to(torch.float32) / s


def _act(x: torch.Tensor, precision: str) -> torch.Tensor:
    return _fp8(x) if precision == "float8" else x


def _mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """``x @ w.T`` (w in HF's ``[out, in]`` layout)."""
    if precision == "float8":
        x, w = _fp8(x), _fp8(w)
    return x @ w.T


def _linear(sd: dict, name: str, x: torch.Tensor, precision: str) -> torch.Tensor:
    return _act(_mm(x, sd[name + ".weight"].float(), precision)
                + sd[name + ".bias"].float(), precision)


def _layer_norm(sd: dict, name: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * sd[name + ".weight"].float() \
        + sd[name + ".bias"].float()


def hidden_states(sd: dict, m: dict, ids: torch.Tensor, mask: torch.Tensor,
                  types: Optional[torch.Tensor] = None, prefix: str = "",
                  precision: str = "float32") -> torch.Tensor:
    """``[B, S, H]`` last hidden states of ``ids`` (padding where
    ``mask`` is False)."""
    h, heads, eps = m["hidden_size"], m["num_attention_heads"], m["layer_norm_eps"]
    b, s = ids.shape
    pos = torch.arange(s, device=ids.device)
    types = torch.zeros_like(ids) if types is None else types
    x = (sd[prefix + "embeddings.word_embeddings.weight"].float()[ids]
         + sd[prefix + "embeddings.position_embeddings.weight"].float()[pos][None]
         + sd[prefix + "embeddings.token_type_embeddings.weight"].float()[types])
    x = _act(_layer_norm(sd, prefix + "embeddings.LayerNorm", _act(x, precision), eps),
             precision)
    hd = h // heads
    keep = mask[:, None, None, :]
    for i in range(m["num_hidden_layers"]):
        p = f"{prefix}encoder.layer.{i}."

        def split(t):
            return t.view(b, s, heads, hd).transpose(1, 2)

        q = split(_linear(sd, p + "attention.self.query", x, precision))
        k = split(_linear(sd, p + "attention.self.key", x, precision))
        v = split(_linear(sd, p + "attention.self.value", x, precision))
        if precision == "float8":
            q, k, v = _fp8(q), _fp8(k), _fp8(v)
        att = _act((q @ k.transpose(-1, -2)) / math.sqrt(hd), precision)
        att = torch.softmax(att.masked_fill(~keep, float("-inf")), dim=-1)
        if precision == "float8":
            att = _fp8(att)
        ctx = _act((att @ v).transpose(1, 2).reshape(b, s, h), precision)
        x = _act(_layer_norm(sd, p + "attention.output.LayerNorm", _act(
            x + _linear(sd, p + "attention.output.dense", ctx, precision), precision), eps),
            precision)
        inner = _linear(sd, p + "intermediate.dense", x, precision)
        inner = _act(0.5 * inner * (1.0 + torch.erf(inner / math.sqrt(2.0))), precision)
        x = _act(_layer_norm(sd, p + "output.LayerNorm", _act(
            x + _linear(sd, p + "output.dense", inner, precision), precision), eps), precision)
    return x


def _batch(rows: list[list[int]], device, types: Optional[list[list[int]]] = None):
    s = max(len(r) for r in rows)
    ids = torch.zeros((len(rows), s), dtype=torch.long)
    mask = torch.zeros((len(rows), s), dtype=torch.bool)
    tt = torch.zeros((len(rows), s), dtype=torch.long)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = torch.tensor(r)
        mask[i, :len(r)] = True
        if types is not None:
            tt[i, :len(r)] = torch.tensor(types[i])
    return ids.to(device), mask.to(device), tt.to(device)


def embed(sd: dict, m: dict, rows: list[list[int]], device,
          precision: str = "float32", block: int = 64) -> torch.Tensor:
    """``[len(rows), H]`` mean-pooled, L2-normalised embeddings of token
    rows (``[CLS] ... [SEP]``, no padding)."""
    out = []
    for lo in range(0, len(rows), block):
        ids, mask, _ = _batch(rows[lo:lo + block], device)
        x = hidden_states(sd, m, ids, mask, precision=precision)
        w = mask[..., None].float()
        pooled = (x * w).sum(1) / w.sum(1)
        out.append(pooled / pooled.norm(dim=-1, keepdim=True).clamp(min=1e-12))
    return torch.cat(out)


def cross_scores(sd: dict, m: dict, pairs: list[tuple[list[int], list[int]]], device,
                 precision: str = "float32", block: int = 64) -> torch.Tensor:
    """``[len(pairs)]`` relevance logits of ``(ids, token types)`` pairs."""
    out = []
    for lo in range(0, len(pairs), block):
        part = pairs[lo:lo + block]
        ids, mask, tt = _batch([p[0] for p in part], device, [p[1] for p in part])
        x = hidden_states(sd, m, ids, mask, tt, prefix="bert.", precision=precision)
        pooled = torch.tanh(_linear(sd, "bert.pooler.dense", x[:, 0], precision))
        out.append(_linear(sd, "classifier", pooled, "float32")[:, 0])
    return torch.cat(out)
