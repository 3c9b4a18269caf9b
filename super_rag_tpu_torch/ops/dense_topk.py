"""Fused dense top-k: scoring + tile-local top-kt, then one merge.

Port of the TPU kernel in the JAX package's ``ops/pallas_topk.py``
(``_make_kernel`` :36, driven by ``pallas_dense_topk`` :106).  The kernel
is ``csrc/dense_topk.cu`` (CUDA C++ for sm_90a, built by ``_build.py``)
in two variants, both on the tensor cores, chosen by shape
(``kernel_variant``):

* ``"tcs"``, every mode (int8 x int8, int8 codes with bf16 queries, bf16
  x bf16, and f32 x f32 as three TF32 products on round-to-nearest
  planes, ``tf32_planes``) at every kt and any D to ``TCS_MAX_D``, in one
  form: a block of 16, 64 or 128 queries
  (``tcs_geometry``: by the batch, then the shared-memory budget) against a
  slice of a tile in chunks of ``TCS_RC`` rows, a TMA ring of 128-byte
  k-slices of the rows and the queries, ``wgmma`` with the rows as M and
  the queries as N, the epilogued scores in a buffer of their own, from
  which each query's kt best are kept in register lists (kt <= 8) or, by
  twelve warps, in sorted lists the few scores above the kt-th merge into
  by rank (kt <= ``TC_MAX_KT``); deeper, the block keeps its slice's
  scores whole and a warp a query selects its kt best at the end (the
  deep selection, ``tcs_deep_geometry``); each tile's rows split over the
  blocks of a cluster (``tcs_split``) where the tiles alone would leave
  the card idle.  What
  bounds it: at scale the L2 stream of the k-slices and the epilogue and
  selection, which the products do not overlap (f32: the three products'
  tensor work, six times bf16's an element); at the served shapes the launch,
  the ring's latency and a slice's first selection.  An f32 call launches
  the queries' planes kernel first (``dense_topk_tf32_planes``: ``[2B,
  D]``, counted with the call's one "tcs" launch);
* ``"tc"``, the int8 x int8 kernel with register lists (``kt <=
  LIST_MAX_KT``, any D up to ``LIST_MAX_D``), taken where its work items
  (a tile against a block of ``LIST_QB`` queries) fill the card: a
  persistent grid of one block an SM, a TMA ring of 128-byte k-slices of
  the queries and of ``LIST_RC`` corpus rows, ``wgmma`` s8 from shared
  memory in two consumer warpgroups, each chunk's epilogue during the
  next chunk's products.  Both tensor-core launches take TMA maps
  (``list_tensor_maps``, ``tcs_tensor_maps``), encoded by the library and
  cached (``_tensor_map``): a served call encodes only its new queries'
  map, and takes the rest of its launch from its shape's plan
  (``_tcs_plan``).

``tc_launches`` counts every launch (``tc_mode_launches`` splits them by
mode, ``list_launches`` counts the register-list kernel's alone:
``count_launch``).  ``tile_topk_plain``
beside them is the plain PyTorch version with the same per-tile
semantics.  ``tile_topk`` launches a kernel for CUDA tensors and runs the
plain version only for CPU tensors.

The logical tile is part of the result: with ``per_tile_k < k`` the
candidates depend on which rows share a tile, so both versions extract
the top-kt of each ``tile``-row block (value descending, lowest column
first, as kt rounds of max / first-argmax / suppress do), whatever rows
of it a block of the kernel scans.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import threading
from typing import Optional

import torch

from super_rag_tpu_torch.device import DeviceLike, check_device
from super_rag_tpu_torch.ops.dense import DenseCorpus, Metric, normalize_queries
from super_rag_tpu_torch.ops.quant import quantize_int8
from super_rag_tpu_torch.ops.topk import NEG_INF, stable_topk

# kernel modes (csrc/dense_topk.cu dense_topk_tcs_launch)
MODE_INT8 = 0  # int8 x int8 -> int32, x qscale
MODE_INT8_BF16 = 1  # int8 codes, bf16 queries
MODE_BF16 = 2
MODE_F32 = 3

# "tcs" keeps sorted lists at kt <= TC_MAX_KT, and above it the slice's
# scores whole (the deep selection); the register lists of "tc" hold up to
# LIST_MAX_KT
TC_MAX_KT = 128
LIST_MAX_KT = 8
# "tcs": corpus rows a chunk (the wgmma's M, 64 a consumer warpgroup),
# bytes of a row a k-slice, the block's query counts (the wgmma's N),
# selecting warps, ring stages at most, at most a cluster's blocks a
# tile; int32 sums of any int8 codes are exact to TCS_MAX_D
TCS_RC = 128
TCS_KS = 128
TCS_QN = (16, 64, 128)
TCS_DEEP_QN = (16, 64)  # the deep selection's forms (kt above TC_MAX_KT)
TCS_WORKERS = 12  # warps that select (the 8 consumers and 4 more)
TCS_LIST_KT = 8  # kt <= this: register lists in the consumers, no selection scratch
TCS_MAX_STAGES = 4
TCS_MAX_SLICES = 8
TCS_MAX_D = 65536
TCS_SR = TCS_RC + 4  # the score buffer's row stride (floats)
TCS_WIDE = 4 * 64 * TCS_KS  # mode 1: both consumer warpgroups' widened codes
# "tc": queries a work item (two consumer warpgroups of 64), corpus rows a
# chunk (the wgmma's N), bytes of a row a ring stage (one 128-byte swizzle
# row), ring stages, slots of a chunk's row data; int32 sums of any int8
# codes are exact to LIST_MAX_D
LIST_QB = 128
LIST_RC = 128
LIST_KS = 128
LIST_STAGES = 6
LIST_ROW_SLOTS = 3
LIST_MAX_D = 65536
SMEM_MAX = 232448  # an H100 block's dynamic shared memory
H100_SMS = 132
# rows of one plain-version chunk: bounds its [B, rows] f32 score block
PLAIN_CHUNK_ROWS = 32768
MAX_GRID_Y = 65535


class _Launches:
    """Plain launch counter: the wrapper adds one per kernel launch."""

    def __init__(self):
        self.count = 0


tc_launches = _Launches()  # every launch ("tc" and "tcs")
list_launches = _Launches()  # the register-list kernel ("tc") alone
# tc_launches by mode
tc_mode_launches = {m: _Launches() for m in (MODE_INT8, MODE_INT8_BF16,
                                         MODE_BF16, MODE_F32)}


def count_launch(variant: str, mode: int) -> None:
    """Add one launch of ``variant`` in ``mode`` to its counters."""
    tc_launches.count += 1
    tc_mode_launches[mode].count += 1
    if variant == "tc":
        list_launches.count += 1


@functools.cache
def _lib() -> ctypes.CDLL:
    from super_rag_tpu_torch import _build

    lib = _build.load("dense_topk")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dense_topk_tc_map.argtypes = [p, p, ctypes.c_longlong, i, i, i]
    lib.dense_topk_tc_map.restype = i
    lib.dense_topk_tc_launch.argtypes = [p, p, p, p, p, i, i, p, i, i, i, i,
                                         i, i, i, p, p, p]
    lib.dense_topk_tc_launch.restype = i
    lib.dense_topk_tcs_launch.argtypes = [i, p, p, p, p, p, p, p, p, p, p]
    lib.dense_topk_tcs_launch.restype = i
    lib.dense_topk_tf32_planes.argtypes = [p, p, ctypes.c_longlong, p]
    lib.dense_topk_tf32_planes.restype = i
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _mode(q: torch.Tensor, values: torch.Tensor) -> int:
    return _dtype_mode(q.dtype, values.dtype)


def _dtype_mode(q_dtype: torch.dtype, c_dtype: torch.dtype) -> int:
    if q_dtype == torch.int8 and c_dtype == torch.int8:
        return MODE_INT8
    if q_dtype == torch.bfloat16 and c_dtype == torch.int8:
        return MODE_INT8_BF16
    if q_dtype == torch.bfloat16 and c_dtype == torch.bfloat16:
        return MODE_BF16
    if q_dtype == torch.float32 and c_dtype == torch.float32:
        return MODE_F32
    raise ValueError(f"no kernel mode for queries {q_dtype} x corpus {c_dtype}")


def kernel_variant(mode: int, kt: int, d: int, b: int, num_tiles: int,
                   sms: int = H100_SMS) -> str:
    """Which kernel takes a call of ``b`` queries over ``num_tiles`` tiles:
    ``"tc"`` (int8 x int8 register lists, at any ``d``) where ``kt <=
    LIST_MAX_KT`` and its work items (``list_work_items``: a tile against
    a block of ``LIST_QB`` queries) give each of ``sms`` SMs at least one;
    ``"tcs"`` for every other call, at every kt (f32 too), whatever ``d``.
    Every variant of a mode gives the same bits for a query whatever the
    batch (int8 x int8: all equal the plain version), so the choice by
    ``b`` changes no answer."""
    if mode == MODE_INT8 and kt <= LIST_MAX_KT and \
            list_work_items(b, num_tiles) >= sms:
        return "tc"
    return "tcs"


def list_work_items(b: int, num_tiles: int) -> int:
    """Work items of a "tc" launch: each tile against each block of
    ``LIST_QB`` queries, walked tile-major so that the blocks of a tile run
    together and read it from HBM once."""
    return -(-b // LIST_QB) * num_tiles


def list_grid(b: int, num_tiles: int, sms: int = H100_SMS) -> int:
    """Blocks of a "tc" launch: one an SM (its ring takes most of an SM's
    shared memory), fewer where there are fewer work items."""
    return max(1, min(list_work_items(b, num_tiles), sms))


def list_smem_bytes() -> int:
    """Dynamic shared memory of a "tc" block: 1,024 bytes of slack to put
    the ring on the 128-byte swizzle's 1,024-byte period, ``LIST_STAGES``
    stages of a k-slice of ``LIST_QB`` query rows and ``LIST_RC`` corpus
    rows, a warpgroup's 64-row k-slice of zeros (the A operand of a phase
    with no k-slice), ``LIST_ROW_SLOTS`` slots of a chunk's row data (a
    mask byte, a scale and a norm a row, two boxes of ``LIST_RC`` rows from
    its first row rounded down to 16: a TMA box starts on 16 bytes) and of
    its folded form (``LIST_RC`` scales with the mask folded in, and
    norms), and 8-byte barriers: a full and an empty one a stage, a full, a
    folded and an empty one a slot."""
    return (1024 + LIST_STAGES * LIST_KS * (LIST_QB + LIST_RC)
            + 64 * LIST_KS + LIST_ROW_SLOTS * (2 * LIST_RC * 9 + 2 * LIST_RC * 4)
            + (2 * LIST_STAGES + 3 * LIST_ROW_SLOTS) * 8)


def list_tensor_maps(b: int, n: int, d: int, scales: bool = True,
                     norms: bool = False, mask: bool = False) -> dict:
    """The TMA maps of a "tc" launch, in the launch's order.  ``queries``
    and ``corpus``: row-major int8 ``[rows, d]`` arrays in boxes of
    ``LIST_KS`` bytes x ``box_rows`` rows (128-byte swizzle; a box reads
    zeros past d and past the last row, so the ragged ends add zeros to
    exact sums): the ``[b, d]`` queries a work item's ``LIST_QB`` rows at a
    time, the first ``n`` rows (the scanned ones) a chunk at a time.
    ``scales``, ``norms`` (f32) and ``mask`` (bytes), where present: the
    chunk's row data, vectors of ``n`` elements of ``elem_bytes`` in boxes
    of a chunk's rows (``d`` 0)."""
    geo = {"queries": {"rows": b, "d": d, "elem_bytes": 1, "box_rows": LIST_QB},
           "corpus": {"rows": n, "d": d, "elem_bytes": 1, "box_rows": LIST_RC}}
    for name, present, size in (("scales", scales, 4), ("norms", norms, 4),
                                ("mask", mask, 1)):
        if present:
            geo[name] = {"rows": n, "d": 0, "elem_bytes": size,
                         "box_rows": LIST_RC}
    return geo


def tcs_stage_bytes(mode: int, qn: int) -> int:
    """A "tcs" ring stage: one 128-byte k-slice of the chunk's ``TCS_RC``
    rows (128 int8 codes, 64 bf16 or 32 f32) and of the block's ``qn``
    queries (two boxes: the int8-codes mode's 128 bf16 query elements in
    64-element halves; the f32 mode's 32 elements of each tf32 plane)."""
    two = mode in (MODE_INT8_BF16, MODE_F32)
    return TCS_RC * TCS_KS + (2 if two else 1) * qn * TCS_KS


def tcs_kp(kt: int) -> int:
    """The sorted lists' length: kt rounded up to a power of two, >= 8."""
    return max(8, 1 << (kt - 1).bit_length())


def tcs_smem_bytes(mode: int, qn: int, kt: int, nst: int,
                   slice_rows: int = TCS_RC) -> int:
    """Dynamic shared memory of a "tcs" block: 1,024 bytes of slack for
    the 128-byte swizzle's 1,024-byte period, ``nst`` ring stages, the
    int8-codes mode's widened codes (two warpgroups x 64 rows x 128 bf16),
    the scores (``qn`` x ``TCS_SR`` f32 of a chunk; in the deep selection,
    kt above ``TC_MAX_KT``, ``qn`` x ``slice_rows + 4`` of the whole
    slice), the sorted lists (``qn`` x kp keys of 8 bytes; none in the deep
    selection), 128 keys of scratch for each of the ``TCS_WORKERS``
    selecting warps (only where sorted lists above ``TCS_LIST_KT`` merge
    through it), the queries' thresholds, scales and flags, and 8-byte
    barriers (a full and an empty one a stage).  It does not depend on D:
    the queries stream through the ring like the rows."""
    deep = kt > TC_MAX_KT
    scratch = TCS_WORKERS * TCS_RC * 8 if TCS_LIST_KT < kt <= TC_MAX_KT else 0
    stride = slice_rows + 4 if deep else TCS_SR
    return (1024 + nst * tcs_stage_bytes(mode, qn)
            + (TCS_WIDE if mode == MODE_INT8_BF16 else 0)
            + qn * stride * 4 + (0 if deep else qn * tcs_kp(kt) * 8) + scratch
            + qn * 12 + nst * 16)


def tcs_merge_fits(mode: int, qn: int, kt: int, nst: int) -> bool:
    """Whether the cluster merge's copies (the lists of a block's queries
    from every block of its cluster: at most ``qn + TCS_MAX_SLICES`` lists
    of kp keys) fit over the ring, the widened codes and the scores, where
    they go once the scan is done."""
    return (qn + TCS_MAX_SLICES) * tcs_kp(kt) * 8 <= (
        nst * tcs_stage_bytes(mode, qn) + (TCS_WIDE if mode == MODE_INT8_BF16 else 0)
        + qn * TCS_SR * 4)


def tcs_deep_kp(kt: int, tile: int) -> int:
    """The deep selection's sort buffer: ``min(kt, tile)`` keys (a tile has
    no more) rounded up to a power of two, at least 256 (a warp sorts 256
    keys in its registers, 8 a lane)."""
    return max(256, tcs_kp(min(kt, tile)))


def tcs_deep_fits(mode: int, qn: int, kt: int, tile: int, nst: int,
                  slices: int, slice_rows: int) -> bool:
    """Whether the deep selection finds its room once the scan is done.
    Split (``slices > 1``), a block first copies the scores of the queries
    it owns (``ceil(qn / slices)``) from every block of its cluster, a row
    of ``slices * slice_rows`` f32 each, over its ring and widened codes;
    then each selecting warp takes a sort buffer of ``tcs_deep_kp`` keys
    (its radix histogram over the buffer's start) after the copies, in the
    ring, the widened codes and (split) the block's own scores.  At least
    one warp must fit."""
    ring = nst * tcs_stage_bytes(mode, qn) + (TCS_WIDE if mode == MODE_INT8_BF16 else 0)
    gather = -(-qn // slices) * slices * slice_rows * 4 if slices > 1 else 0
    region = ring + (qn * (slice_rows + 4) * 4 if slices > 1 else 0)
    return gather <= ring and gather + tcs_deep_kp(kt, tile) * 8 <= region


def tcs_deep_geometry(mode: int, b: int, num_tiles: int, tile: int, kt: int,
                      sms: int = H100_SMS) -> tuple[int, int, int, int]:
    """``(qn, nst, slices, slice_rows)`` of a deep-selection "tcs" launch
    (kt above ``TC_MAX_KT``): the smallest query block of ``TCS_DEEP_QN``
    that holds the batch (64 above 16) and the sorted lists' split
    (``tcs_split``) where ``tcs_deep_fits`` with as many ring stages as fit
    (2 to ``TCS_MAX_STAGES``); else slices of fewer chunks (to a cluster
    of 8), then of more (to one slice a tile), then a smaller query
    block."""
    first = next((qn for qn in TCS_DEEP_QN if b <= qn), TCS_DEEP_QN[-1])
    chunks = -(-tile // TCS_RC)
    for qn in reversed(TCS_DEEP_QN):
        if qn > first:
            continue
        per0 = tcs_split(b, num_tiles, tile, qn, sms)[1] // TCS_RC
        for per in (per0, *range(per0 - 1, 0, -1), *range(per0 + 1, chunks + 1)):
            slices, rows = -(-tile // (per * TCS_RC)), per * TCS_RC
            if slices > TCS_MAX_SLICES:
                continue
            nst = min(TCS_MAX_STAGES, (SMEM_MAX - tcs_smem_bytes(mode, qn, kt, 0, rows))
                      // (tcs_stage_bytes(mode, qn) + 16))
            if nst >= 2 and tcs_deep_fits(mode, qn, kt, tile, nst, slices, rows):
                return qn, nst, slices, rows
    raise ValueError(f"no deep-selection geometry fits kt={kt}, tile={tile} in mode {mode}")


def tcs_geometry(mode: int, b: int, kt: int) -> tuple[int, int]:
    """``(qn, nst)`` of a sorted-lists "tcs" launch (kt <= ``TC_MAX_KT``):
    ``qn`` queries a block, the smallest of ``TCS_QN`` that holds the batch
    (128 above 64), or a smaller one where 2 ring stages do not fit beside
    its lists in ``SMEM_MAX``; ``nst`` as many stages as fit, up to
    ``TCS_MAX_STAGES``."""
    if not 1 <= kt <= TC_MAX_KT:
        raise ValueError(f"the sorted lists take 1 <= kt <= {TC_MAX_KT}, got {kt}; "
                         f"deeper kt: tcs_deep_geometry")
    first = next((qn for qn in TCS_QN if b <= qn), TCS_QN[-1])
    for qn in reversed(TCS_QN):
        if qn > first:
            continue
        nst = min(TCS_MAX_STAGES, (SMEM_MAX - tcs_smem_bytes(mode, qn, kt, 0))
                  // (tcs_stage_bytes(mode, qn) + 16))
        if nst >= 2 and tcs_merge_fits(mode, qn, kt, nst):
            return qn, nst
    raise ValueError(f"no sorted-selection geometry fits kt={kt} in mode {mode}")


def tcs_tensor_maps(mode: int, b: int, n: int, d: int, qn: int) -> dict:
    """The TMA maps of a "tcs" launch: the ``[b, d]`` queries (int8 in the
    int8 x int8 mode, bf16 in the bf16-query modes; in the f32 mode their
    ``[2b, d]`` f32 planes, ``tf32_planes``) in boxes of 128 bytes x ``qn``
    rows, and the first ``n`` rows (the scanned ones; int8 codes, bf16 or
    f32) in boxes of 128 bytes x ``TCS_RC`` rows; 128-byte swizzle, zeros
    past d and past the last row."""
    q_bytes = {MODE_INT8: 1, MODE_F32: 4}.get(mode, 2)
    c_bytes = {MODE_BF16: 2, MODE_F32: 4}.get(mode, 1)
    return {"queries": {"rows": 2 * b if mode == MODE_F32 else b, "d": d,
                        "elem_bytes": q_bytes, "box_rows": qn},
            "corpus": {"rows": n, "d": d, "elem_bytes": c_bytes, "box_rows": TCS_RC}}


def tcs_split(b: int, num_tiles: int, tile: int, qn: int,
              sms: int = H100_SMS) -> tuple[int, int]:
    """``(slices, slice_rows)`` of a "tcs" launch whose blocks take ``qn``
    queries: each tile's rows in ``slices`` slices of ``slice_rows`` (whole
    ``TCS_RC``-row chunks), at least as many as it takes to give each of
    ``sms`` SMs a block where the tiles alone do not, at most a portable
    cluster of 8."""
    blocks = -(-b // qn) * num_tiles
    chunks = -(-tile // TCS_RC)
    want = max(1, -(-sms // max(blocks, 1)))
    per = max(1, chunks // want, -(-chunks // TCS_MAX_SLICES))
    rows = per * TCS_RC
    return -(-tile // rows), rows


MAP_CACHE_SIZE = 64
_maps: "collections.OrderedDict[tuple, ctypes.Array]" = collections.OrderedDict()
_maps_lock = threading.Lock()


def _tensor_map(lib, ptr: int, rows: int, d: int, elem_bytes: int,
                box_rows: int) -> ctypes.Array:
    """The ``CUtensorMap`` (128 bytes) of one array, from a cache of the
    last ``MAP_CACHE_SIZE`` maps used: a map is a pure function of the
    address, the shape, the element size and the box, so an index's corpus
    map is encoded once and a served call encodes only its new queries'
    map.  A hit takes no lock; an encoding failure raises."""
    key = (ptr, rows, d, elem_bytes, box_rows)
    buf = _maps.get(key)
    if buf is not None:
        try:
            _maps.move_to_end(key)
        except KeyError:  # evicted meanwhile by another thread: still valid
            pass
        return buf
    buf = ctypes.create_string_buffer(128)
    err = lib.dense_topk_tc_map(buf, ptr, rows, d, elem_bytes, box_rows)
    if err != 0:
        raise RuntimeError(f"dense_topk: a tensor map failed (code {err}) for "
                           f"{rows} x {d} elements of {elem_bytes} bytes")
    with _maps_lock:
        _maps[key] = buf
        while len(_maps) > MAP_CACHE_SIZE:
            _maps.popitem(last=False)
    return buf


def _encode_maps(lib, arrays: dict, geo: dict) -> tuple[list, list]:
    """The maps of ``geo`` over ``arrays``, in ``geo``'s order, and the
    arrays they address: one whose address is not 16-byte aligned (a map's
    base must be) is copied first, and the copy is held until the launch is
    queued."""
    maps, held = [], []
    for name, g in geo.items():
        t = arrays[name]
        if t.data_ptr() % 16:
            t = t.clone()
        held.append(t)
        maps.append(_tensor_map(lib, t.data_ptr(), g["rows"], g["d"],
                                g["elem_bytes"], g["box_rows"]))
    return maps, held


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
    if b == 0 or num_tiles == 0 or kt == 0:
        return out_v, out_i
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = _sm_count(dev.index if dev.index is not None else
                    torch.cuda.current_device())
    variant = kernel_variant(mode, kt, d, b, num_tiles, sms)
    launch = _launch_list if variant == "tc" else _launch_tcs
    err = launch(lib, q, qscale, values, scales, norms, mask, n, tile, kt, out_v, out_i,
                 stream, sms)
    if err != 0:
        raise RuntimeError(f"dense_topk {variant} kernel launch failed: "
                           f"cudaError {err}")
    count_launch(variant, mode)
    return out_v, out_i


def _launch_list(lib, q, qscale, values, scales, norms, mask, n, tile, kt,
                 out_v, out_i, stream, sms: int) -> int:
    """The "tc" launch: its tensor maps (cached), then the kernel over
    ``list_grid`` blocks.  Returns the launch's cudaError (an encoding
    failure raises)."""
    b, d = q.shape
    num_tiles = -(-n // tile)
    if kt > LIST_MAX_KT or d > LIST_MAX_D:
        raise ValueError(f"the register-list kernel takes kt <= {LIST_MAX_KT} "
                         f"and D <= {LIST_MAX_D}, got kt={kt}, D={d}")
    arrays = {"queries": q, "corpus": values, "scales": scales, "norms": norms,
              "mask": mask}
    geo = list_tensor_maps(b, n, d, scales is not None, norms is not None,
                           mask is not None)
    maps, _held = _encode_maps(lib, arrays, geo)
    by_name = dict(zip(geo, maps))  # an absent row map is null
    return lib.dense_topk_tc_launch(
        *(by_name.get(k) for k in arrays), geo["queries"]["box_rows"],
        geo["corpus"]["box_rows"], _ptr(qscale), b, n, d, tile, num_tiles, kt,
        list_grid(b, num_tiles, sms), out_v.data_ptr(), out_i.data_ptr(), stream)


@functools.lru_cache(maxsize=256)
def _tcs_plan(q_dtype: torch.dtype, c_dtype: torch.dtype, b: int, n: int, d: int,
              tile: int, kt: int, sms: int) -> tuple:
    """What a "tcs" launch derives from its shape alone: ``(mode, shape,
    query map geometry, corpus map geometry)``, ``shape`` the launch's
    twelve ints (q_box, c_box, B, N, D, tile, num_tiles, kt, qn, nst,
    slices, slice_rows) as one C array, the geometries ``_tensor_map``'s
    arguments after the address.  Computed once a shape (a served
    collection repeats a few; at most 256 are kept), so a call pays neither
    ``tcs_geometry`` and ``tcs_split`` nor a conversion of each int."""
    mode = _dtype_mode(q_dtype, c_dtype)
    if kt < 1 or d > TCS_MAX_D:
        raise ValueError(f"the sorted-selection kernel takes kt >= 1 and D <= "
                         f"{TCS_MAX_D}, got mode {mode}, kt={kt}, D={d}")
    num_tiles = -(-n // tile)
    if kt > TC_MAX_KT:
        qn, nst, slices, rows = tcs_deep_geometry(mode, b, num_tiles, tile, kt, sms)
    else:
        qn, nst = tcs_geometry(mode, b, kt)
        slices, rows = tcs_split(b, num_tiles, tile, qn, sms)
    geo = tcs_tensor_maps(mode, b, n, d, qn)
    shape = (ctypes.c_int * 12)(qn, TCS_RC, b, n, d, tile, num_tiles, kt, qn, nst,
                                slices, rows)
    return (mode, shape, tuple(geo["queries"].values()),
            tuple(geo["corpus"].values()))


def _launch_tcs(lib, q, qscale, values, scales, norms, mask, n, tile, kt,
                out_v, out_i, stream, sms: int) -> int:
    """The "tcs" launch: the plan of its shape (``_tcs_plan``), in the f32
    mode the queries' tf32 planes (``dense_topk_tf32_planes``, a kernel of
    its own on the same stream), the queries' and rows' tensor maps
    (cached; both arrays are 16-byte aligned, as ``_launch_kernel``
    checks), then the kernel.  Returns the first failed launch's cudaError,
    else 0 (an encoding failure raises)."""
    b, d = q.shape
    mode, shape, qgeo, cgeo = _tcs_plan(q.dtype, values.dtype, b, n, d, tile, kt, sms)
    if mode == MODE_F32:
        planes = torch.empty((2 * b, d), dtype=torch.float32, device=q.device)
        err = lib.dense_topk_tf32_planes(q.data_ptr(), planes.data_ptr(), b * d, stream)
        if err != 0:
            return err
        q = planes  # freed after the launch is queued: the stream orders reuse
    return lib.dense_topk_tcs_launch(
        mode, _tensor_map(lib, q.data_ptr(), *qgeo),
        _tensor_map(lib, values.data_ptr(), *cgeo), shape, _ptr(qscale), _ptr(scales),
        _ptr(norms), _ptr(mask), out_v.data_ptr(), out_i.data_ptr(), stream)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to tf32 (10 mantissa bits), to nearest with ties
    away from zero, as f32 with the 13 low bits cleared: the kernel's
    ``cvt.rna.tf32.f32``."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_planes(q: torch.Tensor) -> torch.Tensor:
    """Plain version of ``dense_topk_tf32_planes`` (the f32 mode's query
    planes): ``[2B, D]``, ``hi = tf32_rna(q)`` then ``lo = tf32_rna(q -
    hi)`` (``q - hi`` is exact), so that ``hi x hi + hi x lo + lo x hi``
    leaves out only ~3 * 2^-22 |x||y| of a product."""
    hi = tf32_rna(q.to(torch.float32))
    return torch.cat([hi, tf32_rna(q - hi)])


def plain_scores(q, qscale, values, scales, norms, mask, r0: int, r1: int
                 ) -> torch.Tensor:
    """``[B, r1 - r0]`` f32 scores of corpus rows ``[r0, r1)`` as the
    kernel's epilogue forms them: ``s * qscale``, then ``* scales``, then
    ``2s - norms``; masked rows -inf.  int8 x int8 sums are taken in
    float64 (exact below 2^53) and rounded once to f32, as the kernel's
    exact int32 sums are, at any D."""
    if q.dtype == torch.int8:
        s = q.to(torch.float64) @ values[r0:r1].to(torch.float64).T
        s = s.to(torch.float32) * qscale[:, None]
    else:
        s = q.to(torch.float32) @ values[r0:r1].to(torch.float32).T
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
    the int8 x int8 mode the float64 product reproduces the kernel's exact
    int32 sums at any D (an f32 one only while D * 127^2 < 2^24, D <=
    1040); the epilogue then applies the same f32 operations in the same
    order, so kernel and plain version agree bit for bit."""
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
