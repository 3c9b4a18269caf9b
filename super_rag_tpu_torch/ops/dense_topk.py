"""Fused dense top-k: scoring + tile-local top-kt, then one merge.

Port of the TPU kernel in the JAX package's ``ops/pallas_topk.py``
(``_make_kernel`` :36, driven by ``pallas_dense_topk`` :106).  The kernel
is ``csrc/dense_topk.cu`` (CUDA C++ for sm_90a, built by ``_build.py``)
in two variants, chosen by shape (``kernel_variant``): the int8 tensor-
core kernel for int8 x int8 at kt <= 8 and D <= 1024 (the flat
search_hybrid's call), the SIMT kernel for every other mode and kt.  Each
has its own launch counter (``tc_launches``, ``simt_launches``).
``tile_topk_plain`` beside them is the plain PyTorch version with the same
per-tile semantics.  ``tile_topk`` launches a kernel for CUDA tensors and
runs the plain version only for CPU tensors.

The logical tile is part of the result: with ``per_tile_k < k`` the
candidates depend on which rows share a tile, so both versions extract
the top-kt of each ``tile``-row block (value descending, lowest column
first, as kt rounds of max / first-argmax / suppress do).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from super_rag_tpu_torch.device import DeviceLike, check_device
from super_rag_tpu_torch.ops.dense import DenseCorpus, Metric, normalize_queries
from super_rag_tpu_torch.ops.quant import quantize_int8
from super_rag_tpu_torch.ops.topk import NEG_INF, stable_topk

# kernel modes (csrc/dense_topk.cu dense_topk_launch)
MODE_INT8 = 0  # int8 x int8 -> int32, x qscale
MODE_INT8_BF16 = 1  # int8 codes, bf16 queries
MODE_BF16 = 2
MODE_F32 = 3

# the tensor-core variant's shapes: int8 x int8, register lists of up to
# TC_MAX_KT, the block's [queries, D] int8 block in shared memory
TC_MAX_KT = 8
TC_MAX_D = 1024
# rows of one plain-version chunk: bounds its [B, rows] f32 score block
PLAIN_CHUNK_ROWS = 32768
MAX_GRID_Y = 65535


class _Launches:
    """Plain launch counter: the wrapper adds one per kernel launch."""

    def __init__(self):
        self.count = 0


tc_launches = _Launches()  # the int8 tensor-core variant
simt_launches = _Launches()  # the SIMT variant (every other mode and kt)


@functools.cache
def _lib() -> ctypes.CDLL:
    from super_rag_tpu_torch import _build

    lib = _build.load("dense_topk")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dense_topk_launch.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, i,
                                      p, p, p]
    lib.dense_topk_launch.restype = i
    lib.dense_topk_tc_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                         p, p, p]
    lib.dense_topk_tc_launch.restype = i
    return lib


def _mode(q: torch.Tensor, values: torch.Tensor) -> int:
    if q.dtype == torch.int8 and values.dtype == torch.int8:
        return MODE_INT8
    if q.dtype == torch.bfloat16 and values.dtype == torch.int8:
        return MODE_INT8_BF16
    if q.dtype == torch.bfloat16 and values.dtype == torch.bfloat16:
        return MODE_BF16
    if q.dtype == torch.float32 and values.dtype == torch.float32:
        return MODE_F32
    raise ValueError(f"no kernel mode for queries {q.dtype} x corpus "
                     f"{values.dtype}")


def kernel_variant(mode: int, kt: int, d: int) -> str:
    """Which kernel takes a call: ``"tc"`` (int8 tensor cores) for the
    int8 x int8 mode at ``kt <= TC_MAX_KT`` and ``d <= TC_MAX_D``, else
    ``"simt"``."""
    if mode == MODE_INT8 and 1 <= kt <= TC_MAX_KT and d <= TC_MAX_D:
        return "tc"
    return "simt"


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _launch_kernel(q, qscale, values, scales, norms, mask, n, tile, kt):
    b, d = q.shape
    mode = _mode(q, values)
    num_tiles = -(-n // tile)
    dev = values.device
    if d % 16:
        raise ValueError(f"kernel needs D % 16 == 0, got D={d}")
    if num_tiles > MAX_GRID_Y:
        raise ValueError(f"{num_tiles} tiles exceed the grid; raise tile")
    for name, t in (("queries", q), ("corpus", values)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, corpus on {dev}")
    rows = [("qscale", qscale, b), ("scales", scales, n),
            ("norms_sq", norms, n), ("mask", mask, n)]
    for name, t, size in rows:
        if t is None:
            continue
        if t.device != dev or not t.is_contiguous() or t.shape[0] < size:
            raise ValueError(f"{name} must be a contiguous [{size}] tensor "
                             f"on {dev}")
    if mode == MODE_INT8 and qscale is None:
        raise ValueError("int8 x int8 mode needs qscale")
    lib = _lib()
    out_v = torch.empty((num_tiles, b, kt), dtype=torch.float32, device=dev)
    out_i = torch.empty((num_tiles, b, kt), dtype=torch.int32, device=dev)
    if b == 0 or num_tiles == 0:
        return out_v, out_i
    mask_u8 = None if mask is None else mask.view(torch.uint8)
    stream = torch.cuda.current_stream(dev).cuda_stream
    operands = (q.data_ptr(), _ptr(qscale), values.data_ptr(), _ptr(scales),
                _ptr(norms), _ptr(mask_u8), b, n, d, tile, num_tiles, kt,
                out_v.data_ptr(), out_i.data_ptr(), stream)
    variant = kernel_variant(mode, kt, d)
    if variant == "tc":
        err = lib.dense_topk_tc_launch(*operands)
    else:
        err = lib.dense_topk_launch(mode, *operands)
    if err != 0:
        # e.g. a tile whose score block exceeds the card's shared memory
        raise RuntimeError(f"dense_topk {variant} kernel launch failed: "
                           f"cudaError {err}")
    (tc_launches if variant == "tc" else simt_launches).count += 1
    return out_v, out_i


def plain_scores(q, qscale, values, scales, norms, mask, r0: int, r1: int
                 ) -> torch.Tensor:
    """``[B, r1 - r0]`` f32 scores of corpus rows ``[r0, r1)`` as the
    kernel's epilogue forms them: ``s * qscale``, then ``* scales``, then
    ``2s - norms``; masked rows -inf."""
    s = q.to(torch.float32) @ values[r0:r1].to(torch.float32).T
    if q.dtype == torch.int8:
        s = s * qscale[:, None]
    if scales is not None:
        s = s * scales[None, r0:r1]
    if norms is not None:
        s = 2.0 * s - norms[None, r0:r1]
    if mask is not None:
        s = torch.where(mask[None, r0:r1], s, NEG_INF)
    return s


def tile_topk_plain(
    q: torch.Tensor,  # [B, D] int8 | bf16 | f32
    qscale: Optional[torch.Tensor],  # [B] f32 (int8 x int8 only)
    values: torch.Tensor,  # [N, D] int8 | bf16 | f32
    scales: Optional[torch.Tensor],  # [N] f32
    norms: Optional[torch.Tensor],  # [N] f32 (L2)
    mask: Optional[torch.Tensor],  # [N] bool keep-mask
    n: int,
    tile: int,
    kt: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``[num_tiles, B, kt]`` values and int32 ids.

    Scores are taken in f32 chunks of whole tiles, never ``[B, N]``.  In
    the int8 x int8 mode the f32 product sums integers below 2^24
    (D * 127^2 < 2^24 for D <= 1040), so it reproduces the kernel's int32
    sums exactly; the epilogue then applies the same f32 operations in the
    same order, so kernel and plain version agree bit for bit."""
    b = q.shape[0]
    num_tiles = -(-n // tile)
    dev = values.device
    out_v = torch.empty((num_tiles, b, kt), dtype=torch.float32, device=dev)
    out_i = torch.empty((num_tiles, b, kt), dtype=torch.int32, device=dev)
    tiles_per_chunk = max(1, PLAIN_CHUNK_ROWS // tile)
    for t0 in range(0, num_tiles, tiles_per_chunk):
        t1 = min(num_tiles, t0 + tiles_per_chunk)
        r0, r1 = t0 * tile, min(n, t1 * tile)
        s = plain_scores(q, qscale, values, scales, norms, mask, r0, r1)
        s = torch.nn.functional.pad(s, (0, (t1 - t0) * tile - (r1 - r0)),
                                    value=NEG_INF)
        work = s.reshape(b, t1 - t0, tile).transpose(0, 1).contiguous()
        base = (torch.arange(t0, t1, device=dev, dtype=torch.int64)
                * tile)[:, None]
        for j in range(kt):
            am = torch.argmax(work, dim=-1, keepdim=True)  # first max
            out_v[t0:t1, :, j] = torch.gather(work, -1, am)[..., 0]
            out_i[t0:t1, :, j] = (am[..., 0] + base).to(torch.int32)
            work.scatter_(-1, am, NEG_INF)
    return out_v, out_i


def tile_topk(q, qscale, values, scales, norms, mask, n, tile, kt):
    """Per-tile top-kt: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (same arguments as ``tile_topk_plain``)."""
    if values.device.type == "cuda":
        return _launch_kernel(q, qscale, values, scales, norms, mask, n, tile,
                              kt)
    if values.device.type != "cpu":
        raise ValueError(f"no dense_topk path for device {values.device}")
    return tile_topk_plain(q, qscale, values, scales, norms, mask, n, tile,
                           kt)


def prepare(
    queries: torch.Tensor,
    corpus: DenseCorpus,
    k: int,
    metric: Metric = Metric.COSINE,
    tile: int = 1024,
    int8_queries: bool = False,
    per_tile_k: Optional[int] = None,
) -> tuple[torch.Tensor, Optional[torch.Tensor], int, int]:
    """Query operands and sizes of one call: ``(q, qscale, kt, k_eff)``.

    Cosine queries are normalised; ``int8_queries`` (int8 corpora only)
    quantizes them per row, else they are rounded to bf16 unless the
    corpus is f32.  ``kt`` is the per-tile extraction depth, raised so the
    tiles together can always cover ``k_eff``."""
    metric = Metric(metric)
    q = normalize_queries(queries.to(corpus.values.device), metric)
    n = corpus.size
    k_eff = min(k, n)
    kt = min(k_eff, per_tile_k) if per_tile_k is not None else k_eff
    num_tiles = -(-n // tile)
    kt = max(kt, -(-k_eff // max(num_tiles, 1)))
    qscale = None
    if int8_queries and corpus.values.dtype == torch.int8:
        q, qscale = quantize_int8(q)
    elif corpus.values.dtype != torch.float32:
        q = q.to(torch.bfloat16)
    return q.contiguous(), qscale, kt, k_eff


def dense_topk(
    queries: torch.Tensor,
    corpus: DenseCorpus,
    k: int,
    metric: Metric = Metric.COSINE,
    mask: Optional[torch.Tensor] = None,
    tile: int = 1024,
    int8_queries: bool = False,
    per_tile_k: Optional[int] = None,
    device: DeviceLike = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused top-k search; same contract as ``ops.dense.dense_search``:
    ``(scores [B, k], int32 ids [B, k])``.  Rows past N and masked rows
    score -inf.  ``device`` (default CUDA) is where it runs; the corpus
    must already live there."""
    check_device(corpus.values, device)
    metric = Metric(metric)
    q, qscale, kt, k_eff = prepare(queries, corpus, k, metric, tile,
                                   int8_queries, per_tile_k)
    n = corpus.size
    norms = corpus.norms_sq if metric == Metric.L2 else None
    # rows past corpus.live_rows are padding: the scan stops there, and
    # the tiles it skips are filled as a scan of all -inf rows fills them
    # (kt rounds over an all -inf tile each pick its column 0)
    scan = n if corpus.live_rows is None else min(n, corpus.live_rows)
    vals, idxs = tile_topk(q, qscale, corpus.values, corpus.scales, norms,
                           mask, scan, tile, kt)
    b = q.shape[0]
    skipped = -(-n // tile) - vals.shape[0]
    if skipped > 0:
        base = torch.arange(vals.shape[0], vals.shape[0] + skipped,
                            dtype=torch.int32, device=vals.device) * tile
        vals = torch.cat([vals, vals.new_full((skipped, b, kt), NEG_INF)])
        idxs = torch.cat([idxs, base[:, None, None].expand(skipped, b, kt)])
    cv = vals.transpose(0, 1).reshape(b, -1)
    ci = idxs.transpose(0, 1).reshape(b, -1)
    fv, pos = stable_topk(cv, k_eff)
    return fv, torch.gather(ci, -1, pos)
