"""Contrastive fine-tuning of the dual encoder, on one card or over a
(dp, tp) mesh of ranks (port of the JAX package's train/contrastive.py).

InfoNCE with in-batch negatives, the standard dense-retrieval recipe:
query i's positive is doc i, its negatives are the other docs of the
global batch.  The JAX package compiles the step with ``jax.jit`` and
lets GSPMD place the collectives of its (dp, tp) shardings; here the
step is eager PyTorch: the encoder is an ``nn.Module``, autograd gives
the gradients, the optimizer is the JAX package's optax chain number for
number (``train/optim.py``), and over a mesh the collectives are written
out:

  * tp (``shard_params``, the JAX ``_spec_for`` rule): the query, key,
    value and mlp_in projections are column-parallel (weight dim 0 and
    bias split: the port's ``Dense.weight`` is ``[out, in]``), with an
    all-reduce of the input's gradient in backward; attention/out and
    mlp_out are row-parallel (weight dim 1 split), with an all-reduce of
    the output in forward and the bias added once after it; embeddings
    and norms are replicated;
  * dp: each dp rank embeds its slice of the global batch, the slices
    are all-gathered so the in-batch negatives span the global batch
    (the rank's own slice keeps its gradient), every rank backpropagates
    the global loss through its own slice, and the dp gradients are
    summed;
  * the global-norm clip sees the global gradient: the split parameters'
    squares summed over tp, the replicated ones counted once.  Adam's
    moments of a split parameter are split alike.

The state's parameters are the module's own tensors (a rank's shards on
a mesh), updated in place: after a step the module holds the trained
weights, and ``models/encoder.py flax_params`` (``gather_params`` on a
mesh) + ``models/encoder_service.py save_params`` write a checkpoint both
packages load.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from super_rag_tpu_torch.device import DeviceLike
from super_rag_tpu_torch.models.encoder import (
    Dense, TextEncoder, flax_params, init_params)
from super_rag_tpu_torch.parallel.mesh import (
    Mesh, all_gather, all_reduce_sum, make_mesh)
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


# -- the (dp, tp) mesh -------------------------------------------------------------

def train_mesh(ranks: Optional[Sequence[int]] = None, tp: int = 1,
               device: DeviceLike = None) -> Mesh:
    """``("dp", "tp")`` mesh over the world (or ``ranks``), tp the fast
    axis as in the JAX package: rank = dp_index * tp + tp_index.  Every
    rank of the world calls it (the axis groups are collective)."""
    n = len(ranks) if ranks is not None else dist.get_world_size()
    if tp < 1 or n % tp:
        raise ValueError(f"{n} ranks not divisible by tp={tp}")
    group = dist.new_group(list(ranks)) if ranks is not None else None
    return make_mesh(("dp", "tp"), (n // tp, tp), group, device)


_COLUMN = ("attention.query", "attention.key", "attention.value", "mlp_in")
_ROW = ("attention.out", "mlp_out")


def _tp_kind(module_name: str) -> Optional[str]:
    """The JAX ``_spec_for`` rule by module name: "column", "row" or None
    (replicated)."""
    if module_name.endswith(_COLUMN):
        return "column"
    if module_name.endswith(_ROW):
        return "row"
    return None


def param_shardings(model: torch.nn.Module, mesh: Optional[Mesh] = None) -> dict:
    """Parameter name -> its split, one entry a dimension of the port's
    layout (``"tp"`` or None): column-parallel weights ``("tp", None)`` and
    biases ``("tp",)``, row-parallel weights ``(None, "tp")``, the rest
    replicated.  With ``mesh`` the encoder's widths are checked against
    its tp size."""
    if mesh is not None:
        _check_tp(model.cfg, mesh.shape["tp"])
    specs = {}
    for name, p in model.named_parameters():
        module, leaf = name.rsplit(".", 1)
        kind = _tp_kind(module)
        spec = [None] * p.dim()
        if kind == "column":
            spec[0] = "tp"
        elif kind == "row" and leaf == "weight":
            spec[1] = "tp"
        specs[name] = tuple(spec)
    return specs


def _check_tp(cfg, tp: int) -> None:
    if cfg.num_heads % tp or cfg.mlp_dim % tp:
        raise ValueError(f"tp={tp} must divide num_heads ({cfg.num_heads}) "
                         f"and mlp_dim ({cfg.mlp_dim})")


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the gradient summed over the tp group (the input
    of a column-parallel layer reaches every rank's shard)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    """The partial products of a row-parallel layer summed over the tp
    group; the gradient passes through."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class ColumnDense(Dense):
    """A rank's rows of a ``Dense`` weight (and bias): its share of the
    output features."""

    def __init__(self, full: Dense, tp: int, index: int, group):
        dout, din = full.weight.shape
        super().__init__(din, dout // tp, full.dtype)
        rows = slice(index * (dout // tp), (index + 1) * (dout // tp))
        with torch.no_grad():
            self.weight.copy_(full.weight[rows])
            self.bias.copy_(full.bias[rows])
        self.group = group
        self.to(full.weight.device)

    def forward(self, x):
        return super().forward(_CopyToTP.apply(x, self.group))


class RowDense(Dense):
    """A rank's columns of a ``Dense`` weight: its share of the input
    features; the outputs summed over tp, then the (replicated) bias
    added once."""

    def __init__(self, full: Dense, tp: int, index: int, group):
        dout, din = full.weight.shape
        super().__init__(din // tp, dout, full.dtype)
        cols = slice(index * (din // tp), (index + 1) * (din // tp))
        with torch.no_grad():
            self.weight.copy_(full.weight[:, cols])
            self.bias.copy_(full.bias)
        self.group = group
        self.to(full.weight.device)

    def forward(self, x):
        y = torch.matmul(x.to(self.dtype), self.weight.to(self.dtype).T)
        return _ReduceFromTP.apply(y, self.group) + self.bias.to(self.dtype)


def _is_sharded(model: torch.nn.Module) -> bool:
    return any(isinstance(m, (ColumnDense, RowDense)) for m in model.modules())


def shard_params(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Cut a one-device encoder (flax-init weights, or
    ``convert.encoder_from_jax``) into this rank's tp shards, in place:
    column- and row-parallel ``Dense`` layers replace the full ones."""
    tp, index, group = mesh.shape["tp"], mesh.axis_index("tp"), mesh.group("tp")
    _check_tp(model.cfg, tp)
    for name, m in list(model.named_modules()):
        kind = _tp_kind(name)
        if kind is None or type(m) is not Dense:
            continue
        parent, attr = name.rsplit(".", 1)
        cls = ColumnDense if kind == "column" else RowDense
        setattr(model.get_submodule(parent), attr, cls(m, tp, index, group))
    return model


def gather_params(model: torch.nn.Module, mesh: Mesh) -> dict:
    """The whole encoder's parameters from every tp rank's shards, as the
    flax tree of f32 numpy arrays (``models/encoder.py flax_params``): a
    checkpoint both packages load.  Every rank of the tp group calls it."""
    group = mesh.group("tp")
    specs = param_shardings(model)
    full = {}
    for name, p in model.named_parameters():
        spec = specs[name]
        t = p.detach()
        if "tp" in spec:
            t = torch.cat(all_gather(t.contiguous(), group), dim=spec.index("tp"))
        full[name] = t.cpu()
    whole = type(model)(model.cfg)
    whole.load_state_dict(full)
    return flax_params(whole)


def create_train_state(model: torch.nn.Module,
                       generator: Optional[torch.Generator] = None,
                       cfg: TrainConfig = TrainConfig(),
                       mesh: Optional[Mesh] = None) -> TrainState:
    """The state of ``model``'s parameters.  With ``generator`` (on the
    parameters' device) they are first drawn from flax's initialisers
    (``models/encoder.py init_params``); without it the module's current
    weights are trained (a loaded checkpoint, ``convert.encoder_from_jax``).
    With ``mesh`` the whole module is then cut into this rank's tp shards
    (``shard_params``; every rank draws the same weights from the same
    seed)."""
    if generator is not None:
        if _is_sharded(model):
            raise ValueError("initialise the whole encoder before sharding it")
        init_params(model, generator)
    if mesh is not None and not _is_sharded(model):
        shard_params(model, mesh)
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


def _grads(state, loss: torch.Tensor) -> list[torch.Tensor]:
    """Gradients of ``loss`` for ``state.params``; a parameter the loss
    does not reach gets a zero gradient, as in JAX."""
    tensors = list(state.params.values())
    grads = torch.autograd.grad(loss, tensors, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(tensors, grads)]


def apply_gradients(opt, state, loss: torch.Tensor) -> tuple[Any, torch.Tensor]:
    """Backpropagate ``loss`` to ``state.params`` and take one optimizer
    update: ``(new opt state, global gradient norm)``."""
    return opt.update(list(state.params.values()), _grads(state, loss), state.opt_state)


def _gather_batch(x: torch.Tensor, group, index: int) -> torch.Tensor:
    """Every dp rank's rows of ``x`` in dp order; this rank's own slice
    keeps its gradient."""
    parts = all_gather(x.detach().contiguous(), group)
    parts[index] = x
    return torch.cat(parts)


def make_train_step(model: TextEncoder, cfg: TrainConfig = TrainConfig(),
                    mesh: Optional[Mesh] = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch = dict(q_ids, q_mask, d_ids, d_mask)``: ``[B, S]`` int32 / bool
    arrays or tensors, moved to the parameters' device.  ``metrics`` holds
    ``loss`` and ``accuracy``, and ``grad_norm``, the global norm of the
    gradients before clipping (f32 scalars on the device; no host sync).

    With ``mesh`` (``train_mesh``; the state from ``create_train_state``
    with the same mesh) every rank passes the same global batch and
    embeds its dp slice of it; B must divide by the dp size.
    """
    opt = _optimizer(cfg)
    keys = ("q_ids", "q_mask", "d_ids", "d_mask")

    if mesh is None:
        def step_fn(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
            dev = next(iter(state.params.values())).device
            b = {k: to_device(batch[k], dev) for k in keys}
            with torch.enable_grad():
                q = model(b["q_ids"], b["q_mask"])
                d = model(b["d_ids"], b["d_mask"])
                loss, acc = info_nce_loss(q, d, cfg.temperature)
                opt_state, g_norm = apply_gradients(opt, state, loss)
            return (TrainState(params=state.params, opt_state=opt_state,
                               step=state.step + 1),
                    {"loss": loss.detach(), "accuracy": acc, "grad_norm": g_norm})

        return step_fn

    dp, dp_index = mesh.shape["dp"], mesh.axis_index("dp")
    dp_group, tp_group = mesh.group("dp"), mesh.group("tp")

    def mesh_step_fn(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        dev = next(iter(state.params.values())).device
        total = batch["q_ids"].shape[0]
        if total % dp:
            raise ValueError(f"global batch {total} does not divide over dp={dp}")
        rows = slice(dp_index * total // dp, (dp_index + 1) * total // dp)
        b = {k: to_device(batch[k], dev)[rows] for k in keys}
        split = [("tp" in spec) for spec in param_shardings(model).values()]
        with torch.enable_grad():
            q = _gather_batch(model(b["q_ids"], b["q_mask"]), dp_group, dp_index)
            d = _gather_batch(model(b["d_ids"], b["d_mask"]), dp_group, dp_index)
            loss, acc = info_nce_loss(q, d, cfg.temperature)
            grads = _grads(state, loss)
        # each dp rank's share of the global loss's gradient, summed
        flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), dp_group)
        grads = list(torch.split(flat, [g.numel() for g in grads]))
        grads = [g.view_as(p) for g, p in zip(grads, state.params.values())]
        sq_split = sum((torch.sum(g * g) for g, s in zip(grads, split) if s),
                       torch.zeros((), device=dev))
        sq_repl = sum((torch.sum(g * g) for g, s in zip(grads, split) if not s),
                      torch.zeros((), device=dev))
        g_norm = torch.sqrt(all_reduce_sum(sq_split, tp_group) + sq_repl)
        opt_state, g_norm = opt.update(list(state.params.values()), grads,
                                       state.opt_state, g_norm=g_norm)
        return (TrainState(params=state.params, opt_state=opt_state, step=state.step + 1),
                {"loss": loss.detach(), "accuracy": acc, "grad_norm": g_norm})

    return mesh_step_fn
