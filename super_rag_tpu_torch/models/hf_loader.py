"""Map HuggingFace BERT checkpoints onto the port's encoder modules
(port of the JAX package's models/hf_loader.py).

A BERT state dict becomes the flax-layout parameter tree the JAX package
uses (Dense kernels ``[in, out]``); ``models/encoder.load_flax_params``
(or ``convert.encoder_from_jax``) puts it into a ``TextEncoder`` /
``CrossEncoder``.  Loading is name-mapped: any dict of numpy arrays or
tensors with HF BERT key names works.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from super_rag_tpu_torch.models.encoder import EncoderConfig


def _np(x) -> np.ndarray:
    if isinstance(x, np.ndarray):
        return x
    return x.detach().cpu().float().numpy()


def _dense(sd: Mapping, prefix: str) -> dict:
    return {
        "kernel": _np(sd[f"{prefix}.weight"]).T,
        "bias": _np(sd[f"{prefix}.bias"]),
    }


def _ln(sd: Mapping, prefix: str) -> dict:
    return {
        "scale": _np(sd[f"{prefix}.weight"]),
        "bias": _np(sd[f"{prefix}.bias"]),
    }


def backbone_params_from_bert(
    state_dict: Mapping, cfg: EncoderConfig, prefix: str = ""
) -> dict:
    """Convert a HF `BertModel` state_dict to the Backbone param tree."""
    sd = state_dict
    p = prefix
    out = {
        "token_embed": {
            "embedding": _np(sd[f"{p}embeddings.word_embeddings.weight"])
        },
        "position_embed": {
            "embedding": _np(sd[f"{p}embeddings.position_embeddings.weight"])
        },
        "embed_ln": _ln(sd, f"{p}embeddings.LayerNorm"),
    }
    if cfg.type_vocab_size:
        out["type_embed"] = {
            "embedding": _np(sd[f"{p}embeddings.token_type_embeddings.weight"])
        }
    for i in range(cfg.num_layers):
        lp = f"{p}encoder.layer.{i}."
        out[f"layer_{i}"] = {
            "attention": {
                "query": _dense(sd, f"{lp}attention.self.query"),
                "key": _dense(sd, f"{lp}attention.self.key"),
                "value": _dense(sd, f"{lp}attention.self.value"),
                "out": _dense(sd, f"{lp}attention.output.dense"),
            },
            "attention_ln": _ln(sd, f"{lp}attention.output.LayerNorm"),
            "mlp_in": _dense(sd, f"{lp}intermediate.dense"),
            "mlp_out": _dense(sd, f"{lp}output.dense"),
            "mlp_ln": _ln(sd, f"{lp}output.LayerNorm"),
        }
    return out


def encoder_params_from_bert(state_dict: Mapping, cfg: EncoderConfig) -> dict:
    """Params for TextEncoder (mean-pooled; no projection by default)."""
    prefix = "bert." if any(k.startswith("bert.") for k in state_dict) else ""
    return {"backbone": backbone_params_from_bert(state_dict, cfg, prefix)}


def cross_encoder_params_from_bert(
    state_dict: Mapping, cfg: EncoderConfig
) -> dict:
    """Params for CrossEncoder from a BertForSequenceClassification dict."""
    prefix = "bert." if any(k.startswith("bert.") for k in state_dict) else ""
    params = {
        "backbone": backbone_params_from_bert(state_dict, cfg, prefix),
        "pooler": _dense(state_dict, f"{prefix}pooler.dense"),
    }
    if "classifier.weight" in state_dict:
        params["classifier"] = _dense(state_dict, "classifier")
    return params


def config_from_hf(hf_config) -> EncoderConfig:
    return EncoderConfig(
        vocab_size=hf_config.vocab_size,
        hidden_dim=hf_config.hidden_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        mlp_dim=hf_config.intermediate_size,
        max_len=hf_config.max_position_embeddings,
        type_vocab_size=hf_config.type_vocab_size,
        layer_norm_eps=hf_config.layer_norm_eps,
    )
