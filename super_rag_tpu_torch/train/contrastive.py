"""Contrastive fine-tuning of the dual encoder on one card (port of the JAX
package's train/contrastive.py).

InfoNCE with in-batch negatives, the standard dense-retrieval recipe:
query i's positive is doc i, its negatives are the other docs of the
batch.  The JAX package compiles the step with ``jax.jit``, optionally
sharded over a (dp, tp) mesh; here it is eager PyTorch on one device:
the encoder is an ``nn.Module``, autograd gives the gradients, and the
optimizer is the JAX package's optax chain number for number
(``train/optim.py``).  The mesh (``train_mesh``, ``param_shardings``,
``mesh=``) waits for the multi-device slice.

The state's parameters are the module's own tensors, updated in place:
after a step the module holds the trained weights, and
``models/encoder.py flax_params`` + ``models/encoder_service.py
save_params`` write a checkpoint both packages load.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from super_rag_tpu_torch.models.encoder import TextEncoder, init_params
from super_rag_tpu_torch.train.optim import trainer_optimizer


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 2e-5
    weight_decay: float = 0.01
    temperature: float = 0.05
    warmup_steps: int = 100
    grad_clip: float = 1.0
    # when set, the LR follows warmup -> cosine decay to ~0 over this many
    # steps (the standard dense-retrieval schedule); None = warmup -> const
    total_steps: Optional[int] = None


class TrainState(NamedTuple):
    params: dict  # name -> the module's parameter tensor (trained in place)
    opt_state: Any  # train/optim.py AdamWState
    step: int


def _optimizer(cfg):
    return trainer_optimizer(cfg.learning_rate, cfg.weight_decay, cfg.warmup_steps,
                             cfg.grad_clip, cfg.total_steps)


def create_train_state(model: torch.nn.Module,
                       generator: Optional[torch.Generator] = None,
                       cfg: TrainConfig = TrainConfig()) -> TrainState:
    """The state of ``model``'s parameters.  With ``generator`` (on the
    parameters' device) they are first drawn from flax's initialisers
    (``models/encoder.py init_params``); without it the module's current
    weights are trained (a loaded checkpoint, ``convert.encoder_from_jax``)."""
    if generator is not None:
        init_params(model, generator)
    params = dict(model.named_parameters())
    return TrainState(params=params, opt_state=_optimizer(cfg).init(list(params.values())),
                      step=0)


def info_nce_loss(q_emb: torch.Tensor, d_emb: torch.Tensor,
                  temperature: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric InfoNCE over the batch (in-batch negatives): ``(loss,
    accuracy)``, f32 scalars."""
    logits = q_emb @ d_emb.T / temperature  # [B, B]
    labels = torch.arange(logits.shape[0], device=logits.device)
    loss = 0.5 * (_softmax_xent(logits, labels).mean()
                  + _softmax_xent(logits.T, labels).mean())
    # the mean as XLA takes it: the sum times the f32 reciprocal
    acc = (torch.argmax(logits, dim=-1) == labels).float().sum() * (1.0 / logits.shape[0])
    return loss, acc


def _softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax ``softmax_cross_entropy_with_integer_labels``: log-sum-exp
    less the label's logit, per row."""
    label_logits = torch.gather(logits, -1, labels[:, None])[:, 0]
    return torch.logsumexp(logits, dim=-1) - label_logits


def to_device(x, device: torch.device) -> torch.Tensor:
    """A batch array (numpy or tensor) on ``device``."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(device)


def apply_gradients(opt, state, loss: torch.Tensor) -> tuple[Any, torch.Tensor]:
    """Backpropagate ``loss`` to ``state.params`` and take one optimizer
    update: ``(new opt state, global gradient norm)``.  A parameter the
    loss does not reach gets a zero gradient, as in JAX."""
    tensors = list(state.params.values())
    grads = torch.autograd.grad(loss, tensors, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(tensors, grads)]
    return opt.update(tensors, grads, state.opt_state)


def make_train_step(model: TextEncoder, cfg: TrainConfig = TrainConfig()):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch = dict(q_ids, q_mask, d_ids, d_mask)``: ``[B, S]`` int32 / bool
    arrays or tensors, moved to the parameters' device.  ``metrics`` holds
    ``loss`` and ``accuracy``, and ``grad_norm``, the global norm of the
    gradients before clipping (f32 scalars on the device; no host sync).
    """
    opt = _optimizer(cfg)

    def step_fn(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        dev = next(iter(state.params.values())).device
        b = {k: to_device(batch[k], dev) for k in ("q_ids", "q_mask", "d_ids", "d_mask")}
        with torch.enable_grad():
            q = model(b["q_ids"], b["q_mask"])
            d = model(b["d_ids"], b["d_mask"])
            loss, acc = info_nce_loss(q, d, cfg.temperature)
            opt_state, g_norm = apply_gradients(opt, state, loss)
        return (TrainState(params=state.params, opt_state=opt_state, step=state.step + 1),
                {"loss": loss.detach(), "accuracy": acc, "grad_norm": g_norm})

    return step_fn

