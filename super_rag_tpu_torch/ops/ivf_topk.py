"""Probe-driven IVF top-k over the cluster tiles (port of the JAX
package's ops/pallas_ivf.py).

Two kernels score queries against cluster tiles, both in
``csrc/ivf_scan.cu`` (CUDA C++ for sm_90a, built by ``_build.py``), each
with its plain PyTorch version and a launch counter beside it:

  * ``union_scores`` (TPU kernel: pallas_ivf.py:93 ``_make_union_kernel``)
    scores the whole query block against every tile of the batch's probe
    union: ``[B, U, C]``;
  * ``probe_scores`` (TPU kernel: pallas_ivf.py:48 ``_make_kernel``)
    scores each query against its own probed tiles: ``[B, nprobe, C]``.

Both fuse the epilogue the reference ran outside its kernels (dequant
scale, residual add-back of the probe score, the empty-slot and keep-mask
-inf), in the reference's order.  A wrapper launches its kernel for CUDA
tensors and runs the plain version only for CPU tensors.  ``ivf_topk`` is
the glue of ``pallas_ivf_topk``: probe selection, the union-or-per-query
choice, the exact top-k of the candidates and the shared overflow +
sign-plane tail.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from super_rag_tpu_torch.device import DeviceLike, check_device
from super_rag_tpu_torch.ops.dense import Metric, normalize_queries
from super_rag_tpu_torch.ops.ivf import IVFIndex, attach_overflow_and_refine
from super_rag_tpu_torch.ops.topk import NEG_INF, stable_topk

# the union route materialises a [B, U, C] f32 score array; above this
# many bytes the per-query route runs instead (the reference's cap)
UNION_OUT_BYTES_MAX = 400 << 20

# kernel modes (csrc/ivf_scan.cu): values dtype, with bf16 or f32 queries
MODES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
PROBE_MAX_D = 1024  # the per-query kernel keeps a lane's query slice in registers
MAX_GRID_YZ = 65535
# tiles (union) or queries (per-query) scored per plain-version chunk:
# bounds its f32 gather
PLAIN_CHUNK_ELEMS = 1 << 27


class _Launches:
    """Plain launch counter: the wrapper adds one per kernel launch."""

    def __init__(self):
        self.count = 0


union_launches = _Launches()
probe_launches = _Launches()


@functools.cache
def _lib() -> ctypes.CDLL:
    from super_rag_tpu_torch import _build

    lib = _build.load("ivf_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.ivf_union_launch, lib.ivf_probe_launch):
        fn.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i, i, p, p]
        fn.restype = i
    return lib


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check(q, ids, values, scales, cs, row_ids, mask, max_d=None) -> int:
    """Validate the kernel operands; returns the kernel mode."""
    b, d = q.shape
    nlist, cap, dv = values.shape
    mode = MODES.get(values.dtype)
    want_q = torch.float32 if values.dtype == torch.float32 else torch.bfloat16
    if mode is None or q.dtype != want_q:
        raise ValueError(f"no kernel mode for queries {q.dtype} x values "
                         f"{values.dtype}")
    if dv != d or d % 16:
        raise ValueError(f"kernel needs matching D % 16 == 0, got {d}, {dv}")
    if max_d is not None and d > max_d:
        raise ValueError(f"per-query kernel takes D <= {max_d}, got {d}")
    dev = values.device
    for name, t in (("queries", q), ("values", values)):
        if not t.is_contiguous() or t.data_ptr() % 16 or t.device != dev:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned, on "
                             f"{dev}")
    shapes = [("ids", ids, None, torch.int32), ("row_ids", row_ids,
                                                (nlist, cap), torch.int32),
              ("scales", scales, (nlist, cap), torch.float32),
              ("cs", cs, (b, nlist), torch.float32),
              ("mask", mask, None, torch.bool)]
    for name, t, shape, dtype in shapes:
        if t is None:
            continue
        if (t.device != dev or not t.is_contiguous() or t.dtype != dtype
                or (shape is not None and tuple(t.shape) != shape)):
            raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                             f"shape {shape} on {dev}")
    return mode


def _epilogue_plain(s, tiles, b_cs, scales, row_ids, mask):
    """The kernels' epilogue on raw scores ``s [B, T, C]`` of tiles
    ``tiles`` (``[T]`` shared, or ``[B, T]`` per query): ``* scales``,
    then ``+ cs`` (``b_cs``: the probe scores of those tiles, ``[B, T]``),
    then -inf on empty slots and masked rows."""
    if scales is not None:
        s = s * scales[tiles]
    if b_cs is not None:
        s = s + b_cs[:, :, None]
    rid = row_ids[tiles]
    keep = rid >= 0
    if mask is not None:
        keep = keep & mask[rid.clamp(min=0).long()]
    return torch.where(keep, s, NEG_INF)


def union_scores_plain(q, union, values, scales, cs, row_ids,
                       mask) -> torch.Tensor:
    """Plain PyTorch version of ``union_scores``: ``[B, U, C]``.  The
    bf16 queries are exact in f32, so with int8 / bf16 values both
    versions sum exact products; only the summation order differs."""
    b, d = q.shape
    _, cap, _ = values.shape
    u = union.long()
    qf = q.to(torch.float32)
    step = max(1, PLAIN_CHUNK_ELEMS // (cap * d))
    parts = []
    for lo in range(0, u.shape[0], step):
        tiles = u[lo:lo + step]
        raw = torch.einsum("bd,tcd->btc", qf,
                           values[tiles].to(torch.float32))
        b_cs = cs[:, tiles] if cs is not None else None
        parts.append(_epilogue_plain(raw, tiles, b_cs, scales, row_ids, mask))
    if not parts:
        return q.new_empty((b, 0, cap), dtype=torch.float32)
    return torch.cat(parts, 1)


def probe_scores_plain(q, probes, values, scales, cs, row_ids,
                       mask) -> torch.Tensor:
    """Plain PyTorch version of ``probe_scores``: ``[B, nprobe, C]``,
    gathering the probed tiles for a chunk of queries at a time."""
    b, d = q.shape
    nprobe = probes.shape[1]
    _, cap, _ = values.shape
    p = probes.long()
    qf = q.to(torch.float32)
    step = max(1, PLAIN_CHUNK_ELEMS // (nprobe * cap * d))
    parts = []
    for lo in range(0, b, step):
        tiles = p[lo:lo + step]
        raw = torch.einsum("bd,bpcd->bpc", qf[lo:lo + step],
                           values[tiles].to(torch.float32))
        b_cs = (torch.gather(cs[lo:lo + step], 1, tiles)
                if cs is not None else None)
        parts.append(_epilogue_plain(raw, tiles, b_cs, scales, row_ids, mask))
    if not parts:
        return q.new_empty((0, nprobe, cap), dtype=torch.float32)
    return torch.cat(parts, 0)


def union_scores(q, union, values, scales, cs, row_ids,
                 mask) -> torch.Tensor:
    """Scores of every query against every tile in ``union``:
    ``[B, U, C]`` f32, epilogue fused.

    q [B, D] bf16 (f32 for f32 values); union [U] int32 tile ids; values
    [nlist, C, D]; scales [nlist, C] f32 or None; cs [B, nlist] f32 probe
    scores to add back (residual coding) or None; row_ids [nlist, C]
    int32; mask [N] bool keep-mask over row ids or None.  The CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if values.device.type == "cpu":
        return union_scores_plain(q, union, values, scales, cs, row_ids, mask)
    if values.device.type != "cuda":
        raise ValueError(f"no ivf_scan path for device {values.device}")
    mode = _check(q, union, values, scales, cs, row_ids, mask)
    b, d = q.shape
    nlist, cap, _ = values.shape
    n_union = union.shape[0]
    grid_yz = max(-(-cap // 128), -(-b // 32))
    if grid_yz > MAX_GRID_YZ:
        raise ValueError(f"union grid {grid_yz} exceeds {MAX_GRID_YZ}")
    out = torch.empty((b, n_union, cap), dtype=torch.float32,
                      device=values.device)
    if b == 0 or n_union == 0 or cap == 0:
        return out
    err = _lib().ivf_union_launch(
        mode, q.data_ptr(), union.data_ptr(), values.data_ptr(), _ptr(scales),
        _ptr(cs), row_ids.data_ptr(),
        _ptr(None if mask is None else mask.view(torch.uint8)),
        b, n_union, cap, d, nlist, out.data_ptr(),
        torch.cuda.current_stream(values.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ivf_union kernel launch failed: cudaError {err}")
    union_launches.count += 1
    return out


def probe_scores(q, probes, values, scales, cs, row_ids,
                 mask) -> torch.Tensor:
    """Scores of each query against its own probed tiles ``probes
    [B, nprobe]`` int32: ``[B, nprobe, C]`` f32, epilogue fused (same
    operands as ``union_scores``).  The CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if values.device.type == "cpu":
        return probe_scores_plain(q, probes, values, scales, cs, row_ids, mask)
    if values.device.type != "cuda":
        raise ValueError(f"no ivf_scan path for device {values.device}")
    mode = _check(q, probes, values, scales, cs, row_ids, mask,
                  max_d=PROBE_MAX_D)
    b, d = q.shape
    nlist, cap, _ = values.shape
    nprobe = probes.shape[1]
    if tuple(probes.shape) != (b, nprobe) or nprobe > MAX_GRID_YZ:
        raise ValueError(f"probes must be [B, nprobe <= {MAX_GRID_YZ}]")
    out = torch.empty((b, nprobe, cap), dtype=torch.float32,
                      device=values.device)
    if b == 0 or nprobe == 0 or cap == 0:
        return out
    err = _lib().ivf_probe_launch(
        mode, q.data_ptr(), probes.data_ptr(), values.data_ptr(),
        _ptr(scales), _ptr(cs), row_ids.data_ptr(),
        _ptr(None if mask is None else mask.view(torch.uint8)),
        b, nprobe, cap, d, nlist, out.data_ptr(),
        torch.cuda.current_stream(values.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ivf_probe kernel launch failed: cudaError {err}")
    probe_launches.count += 1
    return out


def probe_union(probes: torch.Tensor, nlist: int) -> torch.Tensor:
    """The batch's probe union as ``[min(nlist, B * nprobe)]`` int32 tile
    ids: probed tiles first in ascending id, then unprobed ones in
    ascending id (the reference's ``top_k`` over 0/1 flags)."""
    n_union = min(nlist, probes.numel())
    flags = torch.zeros((nlist,), dtype=torch.float32, device=probes.device)
    flags[probes.reshape(-1).long()] = 1.0
    _, union = stable_topk(flags, n_union)
    return union.to(torch.int32)


def ivf_topk(
    queries: torch.Tensor,  # [B, D] f32
    index: IVFIndex,
    k: int,
    nprobe: int = 32,
    metric: Metric = Metric.COSINE,
    mask: Optional[torch.Tensor] = None,  # [N] bool over global rows
    device: DeviceLike = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Approximate top-k by probe-driven cluster streaming:
    ``(scores [B, k], int32 ids)``.

    When the batch's probe lists union into few enough tiles that the
    ``[B, U, C]`` score array fits ``UNION_OUT_BYTES_MAX``, every query
    scores every union tile (a superset of its own probes, so recall only
    rises); otherwise each query scores its own probes.  The mask applies
    to the whole candidate set.  ``device`` (default CUDA) is where it
    runs; the index must already live there."""
    check_device(index.values, device)
    metric = Metric(metric)
    q = normalize_queries(queries.to(index.device), metric)
    b = q.shape[0]
    nlist, cap, _ = index.values.shape
    nprobe = min(nprobe, nlist)
    cs = q @ index.centroids.T  # [B, nlist]
    _, probes = stable_topk(cs, nprobe)
    probes = probes.to(torch.int32)
    compute = (torch.float32 if index.values.dtype == torch.float32
               else torch.bfloat16)
    q_in = q.to(compute).contiguous()
    cs_in = cs.contiguous() if index.residual else None
    n_union = min(nlist, b * nprobe)
    use_union = n_union * b * cap * 4 <= UNION_OUT_BYTES_MAX
    if use_union:
        tiles = probe_union(probes, nlist)
        cv = union_scores(q_in, tiles, index.values, index.scales, cs_in,
                          index.row_ids, mask)
        tile_ids = tiles.long()[None, :].expand(b, -1)
        width = n_union
    else:
        cv = probe_scores(q_in, probes.contiguous(), index.values,
                          index.scales, cs_in, index.row_ids, mask)
        tile_ids = probes.long()
        width = nprobe
    cv = cv.reshape(b, width * cap)
    k_eff = min(k, width * cap)
    fv, pos = stable_topk(cv, k_eff)
    # candidate location (cluster * cap + slot) for the refine stage
    floc = torch.gather(tile_ids, 1, pos // cap) * cap + pos % cap
    fi = index.row_ids.reshape(-1)[floc]
    fi = torch.where(torch.isfinite(fv), fi, -1)
    return attach_overflow_and_refine(q, cs, index, fv, fi, floc, k_eff,
                                      mask=mask)
