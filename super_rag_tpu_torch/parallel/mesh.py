"""Meshes over a ``torch.distributed`` process group (port of the JAX
package's parallel/mesh.py).

The JAX package runs one ``shard_map`` program over a device mesh from a
single controller.  Here the same program is SPMD over a process group:
every rank calls the same function with the same (replicated) arguments,
holds only its own block of the corpus rows, and the collectives run
through ``torch.distributed`` (NCCL between cards, gloo on the CPU or
when ranks share one card).

Rows shard over one axis named ``corpus``; scale-out past one node adds a
leading ``slice`` axis, and ranks are laid out as the JAX code lays out
devices: rank = slice * per_slice + corpus.  The merge then runs
corpus-axis first, so only k candidates per slice cross the slow links.
The trainer's ``("dp", "tp")`` mesh (``train/contrastive.py train_mesh``)
is built by the same ``make_mesh``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from super_rag_tpu_torch.device import DeviceLike, resolve_device

CORPUS_AXIS = "corpus"
SLICE_AXIS = "slice"


@dataclass(frozen=True)
class Mesh:
    """This rank's view of a mesh: the axes, its coordinate on each, the
    process group of its peers along each, and its device."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    coords: tuple[int, ...]
    groups: tuple  # one process group per axis (None = the world group)
    device: torch.device
    root: object = None  # the group the mesh spans (None = the world)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    def axis_index(self, name: str) -> int:
        return self.coords[self.axis_names.index(name)]

    def group(self, name: str):
        return self.groups[self.axis_names.index(name)]

    @property
    def row_index(self) -> int:
        """This rank's block of rows: its position in the row-major
        layout of the row axes (``row_axes``)."""
        idx = 0
        for name in row_axes(self):
            idx = idx * self.shape[name] + self.axis_index(name)
        return idx


def rank_device(device: DeviceLike = None) -> torch.device:
    """This rank's device: ``None`` or ``"cuda"`` -> the card of index
    rank % cards (one rank per card under NCCL; ranks that share a card
    under gloo); raises without a card, as every entry point does."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def make_mesh(names: Sequence[str], sizes: Sequence[int], group=None,
              device: DeviceLike = None) -> Mesh:
    """A mesh of ``sizes`` over the ranks of ``group`` (default: the
    world) in row-major order.  Every rank of the world must call it, in
    the same order as its other ``make_mesh`` / ``new_group`` calls: the
    axis groups are made with ``dist.new_group``, which is collective."""
    ranks = (dist.get_process_group_ranks(group) if group is not None
             else list(range(dist.get_world_size())))
    sizes = tuple(int(s) for s in sizes)
    if int(np.prod(sizes)) != len(ranks):
        raise ValueError(f"{len(ranks)} ranks do not fill a {sizes} mesh")
    me = dist.get_rank()
    grid = np.asarray(ranks).reshape(sizes)
    member = me in ranks
    coords = (tuple(int(c) for c in np.unravel_index(ranks.index(me), sizes))
              if member else ())
    groups = []
    for ax in range(len(sizes)):
        if len(sizes) == 1:
            groups.append(group)
            continue
        mine = None
        moved = np.moveaxis(grid, ax, -1).reshape(-1, sizes[ax])
        for line in moved.tolist():
            g = dist.new_group(line)
            if me in line:
                mine = g
        groups.append(mine)
    if not member:
        raise ValueError(f"rank {me} is not in the mesh's group")
    return Mesh(tuple(names), sizes, coords, tuple(groups), rank_device(device),
                group)


def corpus_mesh(group=None, device: DeviceLike = None) -> Mesh:
    """1-D mesh over all (or the given group's) ranks for corpus
    sharding."""
    n = (dist.get_world_size(group) if group is not None
         else dist.get_world_size())
    return make_mesh((CORPUS_AXIS,), (n,), group, device)


def multislice_mesh(n_slices: int, group=None,
                    device: DeviceLike = None) -> Mesh:
    """2-D ``(slice, corpus)`` mesh: rank = slice * per + corpus."""
    n = (dist.get_world_size(group) if group is not None
         else dist.get_world_size())
    if n % n_slices:
        raise ValueError(f"{n} ranks not divisible by {n_slices} slices")
    return make_mesh((SLICE_AXIS, CORPUS_AXIS), (n_slices, n // n_slices),
                     group, device)


def row_axes(mesh: Mesh) -> tuple[str, ...]:
    """Mesh axes the corpus row dimension shards over."""
    if SLICE_AXIS in mesh.axis_names:
        return (SLICE_AXIS, CORPUS_AXIS)
    return (CORPUS_AXIS,)


def row_shards(mesh: Mesh) -> int:
    """Blocks the rows split into (the product of the row axes)."""
    return int(np.prod([mesh.shape[a] for a in row_axes(mesh)]))


def pad_rows_to_multiple(x, multiple: int, fill=0):
    """Rows padded with ``fill`` to a multiple of ``multiple`` (numpy
    array or tensor)."""
    n = x.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return x
    if isinstance(x, torch.Tensor):
        pad = torch.full((rem, *x.shape[1:]), fill, dtype=x.dtype,
                         device=x.device)
        return torch.cat([x, pad])
    pad = [(0, rem)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad, constant_values=fill)


def shard_corpus(mesh: Mesh, *arrays):
    """This rank's block of each row-aligned array (numpy or tensor),
    rows padded to a multiple of the row shards first (callers carry a
    validity mask so padding rows never score), on the mesh's device.
    ``None`` passes through; one array comes back bare."""
    n_dev = row_shards(mesh)
    out = []
    for a in arrays:
        if a is None:
            out.append(None)
            continue
        a = pad_rows_to_multiple(a, n_dev)
        rows = a.shape[0] // n_dev
        block = a[mesh.row_index * rows:(mesh.row_index + 1) * rows]
        if not isinstance(block, torch.Tensor):
            block = torch.from_numpy(np.ascontiguousarray(block))
        out.append(block.to(mesh.device).clone())
    return tuple(out) if len(out) != 1 else out[0]


# -- collectives -----------------------------------------------------------------

def _wire(t: torch.Tensor, stage: bool) -> torch.Tensor:
    """``t`` as the collective moves it: bool as uint8, bf16 as f32 (exact
    both ways; gloo takes neither), on the host when gloo carries a
    card's tensor."""
    if stage:
        t = t.cpu()
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    elif t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.contiguous()


def _unwire(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return t.to(like.device, like.dtype)


def _stages(t: torch.Tensor, group) -> bool:
    """gloo carries a card's tensor through the host: the port stages it
    there explicitly (one [B, k] copy each way) rather than rely on the
    backend's CUDA support, which differs between torch versions."""
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def all_gather(t: torch.Tensor, group=None) -> list[torch.Tensor]:
    """Every rank's ``t`` (same shape on each) along ``group``, in group
    rank order, on ``t``'s device."""
    n = dist.get_world_size(group)
    if n == 1:
        return [t]
    w = _wire(t, _stages(t, group))
    out = [torch.empty_like(w) for _ in range(n)]
    dist.all_gather(out, w, group=group)
    return [_unwire(o, t) for o in out]


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``t`` along ``group`` (a new tensor; a
    bf16 tensor is summed in f32 and rounded once)."""
    if dist.get_world_size(group) == 1:
        return t.clone()
    w = t.cpu() if _stages(t, group) else t
    w = w.to(torch.float32 if t.dtype == torch.bfloat16 else t.dtype).clone()
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=group)
    return w.to(t.device, t.dtype)
