"""IVF (inverted-file) index: k-means + nprobe search (port of the JAX
package's ops/ivf.py).

Clusters are FIXED-CAPACITY tiles, the reference's layout, so an index
built by either package loads in the other:

    centroids [nlist, D] f32
    values    [nlist, C, D] int8/bf16/f32   (C = capacity, a multiple of 128)
    scales    [nlist, C] f32                (int8 rows)
    row_ids   [nlist, C] int32              (-1 = empty slot)

Rows that overflow a full cluster go to a flat overflow segment that every
search scans exactly.  k-means runs on the tensors' device: assignment is
a blocked matmul argmax, the centroid update a blocked one-hot matmul
(never ``index_add_``: atomics would make the build differ run to run).
Placement, quantization and sign packing run on the host in numpy, as in
the reference, so both packages place and quantize the same rows alike.

The probe-streaming search tier with the CUDA kernels is
``ops/ivf_topk.py``; this module holds the build, the plain gather tier
``ivf_search``, the large-batch tier ``ivf_flat_topk`` and the shared
overflow + sign-plane refine tail.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from super_rag_tpu_torch.device import DeviceLike, resolve_device
from super_rag_tpu_torch.ops.dense import (
    DenseCorpus, Metric, dense_search, normalize_queries)
from super_rag_tpu_torch.ops.topk import NEG_INF, stable_topk


@dataclasses.dataclass
class IVFIndex:
    centroids: torch.Tensor  # [nlist, D] f32 (unit-norm for cosine)
    values: torch.Tensor  # [nlist, C, D] storage dtype
    scales: Optional[torch.Tensor]  # [nlist, C] f32 for int8
    row_ids: torch.Tensor  # [nlist, C] int32, -1 empty
    overflow: Optional[DenseCorpus]  # flat remainder, always scanned
    overflow_rows: Optional[torch.Tensor]  # [M] int32 global ids
    # residual coding: values store x - centroid[cluster]; the search adds
    # the probe score q @ centroid back
    residual: bool = False
    # 1-bit error-refinement plane: sign of the int8 quantization error,
    # bit-packed [nlist, C, D//8] uint8 (little bit order)
    sign_plane: Optional[torch.Tensor] = None
    of_sign_plane: Optional[torch.Tensor] = None  # [M, D//8] uint8
    # residual-coded overflow: the centroid each overflow row is coded
    # against ([M] int32)
    of_assign: Optional[torch.Tensor] = None

    @property
    def nlist(self) -> int:
        return self.centroids.shape[0]

    @property
    def capacity(self) -> int:
        return self.values.shape[1]

    @property
    def device(self) -> torch.device:
        return self.values.device


def _normalize(x: torch.Tensor, metric: Metric) -> torch.Tensor:
    x = x.to(torch.float32)
    if Metric(metric) == Metric.COSINE:
        nrm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        x = x / torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    return x


def _rows(x: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    return x[torch.from_numpy(np.asarray(idx, np.int64)).to(x.device)]


def capacity_for(n: int, nlist: int, capacity_factor: float) -> int:
    """Slots per cluster: ``n / nlist * factor``, at least 8, rounded up to
    a multiple of 128 (the reference's layout, so IVF arrays load in both
    packages)."""
    capacity = max(8, int(np.ceil(n / nlist * capacity_factor)))
    return -(-capacity // 128) * 128


# -- k-means --------------------------------------------------------------------


def _assign(x: torch.Tensor, centroids: torch.Tensor,
            block: int = 65536) -> torch.Tensor:
    """Nearest-centroid assignment by dot product (unit-norm data); int32.
    ``argmax`` takes the first maximum, as the reference's does."""
    out = [torch.argmax(x[lo:lo + block] @ centroids.T, dim=1)
           for lo in range(0, x.shape[0], block)]
    return torch.cat(out).to(torch.int32)


def _update(x: torch.Tensor, assign: torch.Tensor, nlist: int,
            block: int = 65536) -> tuple[torch.Tensor, torch.Tensor]:
    """Centroid sums + counts via blocked one-hot matmuls."""
    n, d = x.shape
    sums = torch.zeros((nlist, d), dtype=torch.float32, device=x.device)
    counts = torch.zeros((nlist,), dtype=torch.float32, device=x.device)
    for lo in range(0, n, block):
        onehot = torch.nn.functional.one_hot(
            assign[lo:lo + block].long(), nlist).to(torch.float32)
        sums = sums + onehot.T @ x[lo:lo + block]
        counts = counts + onehot.sum(0)
    return sums, counts


def _assign_topc(x: torch.Tensor, centroids: torch.Tensor, c: int,
                 block: int = 16384) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-c nearest centroids per row: ``(ids [n, c] int32, scores)``."""
    ids, vals = [], []
    for lo in range(0, x.shape[0], block):
        v, i = stable_topk(x[lo:lo + block] @ centroids.T, c)
        ids.append(i.to(torch.int32))
        vals.append(v)
    return torch.cat(ids), torch.cat(vals)


def kmeans(x: torch.Tensor, nlist: int, iters: int = 10, seed: int = 0,
           metric: Metric = Metric.COSINE) -> torch.Tensor:
    """Lloyd's k-means on the tensor's device; returns [nlist, D].

    Cosine uses spherical k-means (centroids re-normalised each
    iteration).  Init rows and the reseeds of empty clusters come from
    ``np.random.default_rng(seed)``, as in the reference."""
    x = _normalize(x, metric)
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    centroids = _rows(x, rng.choice(n, size=nlist, replace=False))
    for _ in range(iters):
        a = _assign(x, centroids)
        sums, counts = _update(x, a, nlist)
        new = sums / torch.clamp(counts[:, None], min=1.0)
        empty = counts < 0.5
        reseed = _rows(x, rng.choice(n, size=nlist, replace=False))
        new = torch.where(empty[:, None], reseed, new)
        centroids = _normalize(new, metric)
    return centroids


def kmeans_twolevel(
    x: torch.Tensor, nlist: int, coarse: int, iters: int = 10, seed: int = 0,
    metric: Metric = Metric.COSINE, coarse_train: int = 32768,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Hierarchical spherical k-means: ``coarse`` top-level clusters, then
    ``nlist // coarse`` fine centroids per coarse group (coarse-major:
    fine centroid ``g * fpb + j`` belongs to group ``g``).  Returns
    ``(centroids [nlist, D], coarse_centroids [coarse, D])``."""
    fpb, rem = divmod(nlist, coarse)
    if rem:
        raise ValueError(f"nlist {nlist} must be a multiple of coarse {coarse}")
    x = _normalize(x, metric)
    n, d = x.shape
    rng = np.random.default_rng(seed)
    sub = x if n <= coarse_train else _rows(
        x, rng.choice(n, size=coarse_train, replace=False))
    cen_c = kmeans(sub, coarse, iters=iters, seed=seed, metric=metric)
    a = _assign(x, cen_c).cpu().numpy()
    x_np = x.cpu().numpy()
    centroids = np.empty((nlist, d), np.float32)
    order = np.argsort(a, kind="stable")
    bounds = np.searchsorted(a[order], np.arange(coarse + 1))
    for g in range(coarse):
        rows = order[bounds[g]:bounds[g + 1]]
        if rows.size == 0:
            # empty coarse group: reseed its fine block from random rows
            rows = rng.choice(n, size=min(n, 4 * fpb), replace=False)
        if rows.size <= fpb:
            # fewer members than fine slots: members + random fill
            fill = x_np[rng.choice(n, size=fpb - rows.size, replace=True)]
            block = np.concatenate([x_np[rows], fill]) if rows.size else fill
            centroids[g * fpb:(g + 1) * fpb] = block
        else:
            members = torch.from_numpy(x_np[rows]).to(x.device)
            centroids[g * fpb:(g + 1) * fpb] = kmeans(
                members, fpb, iters=iters, seed=seed + 1 + g,
                metric=metric).cpu().numpy()
    return torch.from_numpy(centroids).to(x.device), cen_c


def _assign_topc_grouped(
    chunk: np.ndarray,  # [m, D] unit-norm float32 (host)
    centroids: np.ndarray,  # [nlist, D] coarse-major fine centroids (host)
    coarse: np.ndarray,  # [kc, D] coarse centroids (host)
    c: int,
    p: int = 2,
) -> tuple[np.ndarray, np.ndarray]:
    """Two-level top-c assignment on host numpy: the ``kc`` coarse
    centroids, then only the fine centroids of each row's top-``p``
    coarse groups.  Returns ``(cand [m, c], cscore [m, c])``, best first.

    The reference returns ``min(c, p * fpb)`` columns; here ``p`` grows
    to ``ceil(c / fpb)`` groups where ``p * fpb < c``, so the documented
    ``[m, c]`` contract holds whenever ``c <= nlist``.  Where
    ``p * fpb >= c`` both packages score the same groups."""
    kc, d = coarse.shape
    nlist = centroids.shape[0]
    fpb = nlist // kc
    p = min(max(p, -(-c // fpb)), kc)
    m = chunk.shape[0]
    s_c = chunk @ coarse.T  # [m, kc]
    topp = np.argpartition(-s_c, p - 1, axis=1)[:, :p]  # [m, p]
    cand = np.empty((m, p * fpb), np.int32)
    score = np.full((m, p * fpb), -np.inf, np.float32)
    base = np.arange(fpb, dtype=np.int32)
    for j in range(p):
        g = topp[:, j]
        order = np.argsort(g, kind="stable")
        bounds = np.searchsorted(g[order], np.arange(kc + 1))
        col = slice(j * fpb, (j + 1) * fpb)
        for gi in range(kc):
            rows = order[bounds[gi]:bounds[gi + 1]]
            if rows.size == 0:
                continue
            blk = centroids[gi * fpb:(gi + 1) * fpb]
            score[rows, col] = chunk[rows] @ blk.T
            cand[rows, col] = gi * fpb + base
    c_eff = min(c, p * fpb)
    top = np.argpartition(-score, c_eff - 1, axis=1)[:, :c_eff]
    sv = np.take_along_axis(score, top, axis=1)
    order = np.argsort(-sv, axis=1, kind="stable")
    sv = np.take_along_axis(sv, order, axis=1)
    ci = np.take_along_axis(np.take_along_axis(cand, top, axis=1),
                            order, axis=1)
    return ci, sv


# -- build ------------------------------------------------------------------------


def _quant_rows(stored: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    absmax = np.abs(stored).max(axis=1)
    s = np.where(absmax > 0, absmax, 1.0) / 127.0
    q = np.clip(np.rint(stored / s[:, None]), -127, 127).astype(np.int8)
    return q, s.astype(np.float32)


def pack_error_signs(stored: np.ndarray, q: np.ndarray,
                     s: np.ndarray) -> np.ndarray:
    """Bit-pack the sign of the quantization error (host build step):
    dequantizing as ``s * (q + 0.25 * sign)`` halves the error std.
    Little bit order: bit b of byte j is element 8j + b."""
    e = stored / s[:, None] - q
    return np.packbits(e > 0, axis=-1, bitorder="little")


def unpack_signs(codes: torch.Tensor) -> torch.Tensor:
    """``[..., D//8]`` uint8 -> ``[..., D]`` float32 in {-1, +1}."""
    shifts = torch.arange(8, dtype=torch.uint8, device=codes.device)
    bits = (codes[..., None] >> shifts) & 1
    signs = bits.to(torch.float32) * 2.0 - 1.0
    return signs.reshape(*codes.shape[:-1], codes.shape[-1] * 8)


def _balanced_place(
    cand: np.ndarray,  # [m, c] candidate clusters, best first
    counts: np.ndarray,  # [nlist] running fill counts (mutated)
    capacity: int,
    allowed: Optional[np.ndarray] = None,  # [m, c] bool: candidate usable
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Greedy balanced placement: each row goes to its best candidate
    cluster with a free slot.  Returns (cluster, slot, unplaced_rows)."""
    m, c = cand.shape
    placed_cl = np.full(m, -1, np.int64)
    placed_slot = np.full(m, -1, np.int64)
    todo = np.arange(m)
    for j in range(c):
        if todo.size == 0:
            break
        if allowed is not None:
            # a row whose j-th candidate is out of margin spills: later
            # candidates score even lower, so none qualify
            todo = todo[allowed[todo, j]]
            if todo.size == 0:
                break
        cl = cand[todo, j].astype(np.int64)
        order = np.argsort(cl, kind="stable")
        scl = cl[order]
        idx = np.arange(scl.size, dtype=np.int64)
        is_start = np.empty(scl.size, bool)
        is_start[0] = True
        is_start[1:] = scl[1:] != scl[:-1]
        run_start = np.maximum.accumulate(np.where(is_start, idx, 0))
        rank = idx - run_start
        ok = rank < (capacity - counts[scl])
        rows = todo[order[ok]]
        placed_cl[rows] = scl[ok]
        placed_slot[rows] = counts[scl[ok]] + rank[ok]
        np.add.at(counts, scl[ok], 1)
        todo = todo[order[~ok]]
    return placed_cl, placed_slot, np.flatnonzero(placed_cl < 0)


def _storage(values: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """Host f32 values -> a CPU tensor of the storage dtype (bf16 rounds
    to nearest even, as the reference's cast does)."""
    return torch.from_numpy(values).to(dtype)


def build_ivf(
    embeddings: torch.Tensor,  # [N, D] f32 (raw; normalised here for cosine)
    nlist: int,
    capacity_factor: float = 1.5,
    dtype: torch.dtype = torch.int8,
    metric: Metric = Metric.COSINE,
    kmeans_iters: int = 10,
    seed: int = 0,
    sample: Optional[int] = 200_000,
    residual: Optional[bool] = None,  # default: on for int8
    ids: Optional[np.ndarray] = None,  # original row id per input row
) -> IVFIndex:
    """Build over rows that fit the device as f32; runs where
    ``embeddings`` lives.  ``ids`` maps input positions to the caller's
    row ids (default arange), so an engine can build over live rows."""
    x = _normalize(embeddings, metric)
    dev = x.device
    n, d = x.shape
    ids_arr = (np.arange(n, dtype=np.int32) if ids is None
               else np.asarray(ids, np.int32))
    if ids_arr.shape != (n,):
        raise ValueError("ids must map every input row")
    train = x
    if sample is not None and n > sample:
        rng = np.random.default_rng(seed)
        train = _rows(x, rng.choice(n, size=sample, replace=False))
    centroids = kmeans(train, nlist, iters=kmeans_iters, seed=seed,
                       metric=metric)
    assign = _assign(x, centroids).cpu().numpy()
    cen_np = centroids.cpu().numpy()

    capacity = capacity_for(n, nlist, capacity_factor)
    x_np = x.cpu().numpy()
    values = np.zeros((nlist, capacity, d), np.float32)
    row_ids = np.full((nlist, capacity), -1, np.int32)
    # sort rows by cluster, rank within each run, place rank < capacity,
    # spill the rest to overflow
    order = np.argsort(assign, kind="stable")
    sorted_assign = assign[order]
    idx = np.arange(n, dtype=np.int64)
    is_start = np.empty(n, bool)
    if n:
        is_start[0] = True
        is_start[1:] = sorted_assign[1:] != sorted_assign[:-1]
    run_start = np.maximum.accumulate(np.where(is_start, idx, 0))
    rank = idx - run_start
    keep = rank < capacity
    if residual is None:
        residual = dtype == torch.int8
    stored = x_np[order[keep]]
    if residual:
        stored = stored - cen_np[sorted_assign[keep]]
    values[sorted_assign[keep], rank[keep]] = stored
    row_ids[sorted_assign[keep], rank[keep]] = ids_arr[order[keep]]
    of_idx = order[~keep]

    scales = sign_plane = None
    use_signs = dtype == torch.int8 and d % 8 == 0
    if dtype == torch.int8:
        flat = values.reshape(-1, d)
        q_np, s_np = _quant_rows(flat)
        if use_signs:
            sign_plane = torch.from_numpy(pack_error_signs(
                flat, q_np, s_np).reshape(nlist, capacity, d // 8)).to(dev)
        vals = torch.from_numpy(q_np.reshape(nlist, capacity, d)).to(dev)
        scales = torch.from_numpy(s_np.reshape(nlist, capacity)).to(dev)
    else:
        vals = _storage(values, dtype).to(dev)

    overflow = overflow_ids = of_sign = of_assign = None
    if of_idx.size:
        of = x_np[of_idx]
        if dtype == torch.int8:
            if residual:
                # residual-code overflow against the row's own cluster
                of_assign_np = assign[of_idx].astype(np.int32)
                of = of - cen_np[of_assign_np]
                of_assign = torch.from_numpy(of_assign_np).to(dev)
            oq_np, os_np = _quant_rows(of)
            if use_signs:
                of_sign = torch.from_numpy(
                    pack_error_signs(of, oq_np, os_np)).to(dev)
            overflow = DenseCorpus(values=torch.from_numpy(oq_np).to(dev),
                                   scales=torch.from_numpy(os_np).to(dev))
        else:
            overflow = DenseCorpus(values=_storage(of, dtype).to(dev))
        overflow_ids = torch.from_numpy(ids_arr[of_idx]).to(dev)

    return IVFIndex(
        centroids=centroids, values=vals, scales=scales,
        row_ids=torch.from_numpy(row_ids).to(dev), overflow=overflow,
        overflow_rows=overflow_ids, residual=residual, sign_plane=sign_plane,
        of_sign_plane=of_sign, of_assign=of_assign,
    )


def build_ivf_streaming(
    chunks: Callable[[], Iterable[np.ndarray]],  # -> fresh [m, D] f32 chunks
    nlist: int,
    capacity_factor: float = 1.2,
    dtype: torch.dtype = torch.int8,
    metric: Metric = Metric.COSINE,
    kmeans_iters: int = 10,
    seed: int = 0,
    train_sample: int = 200_000,
    residual: Optional[bool] = None,
    assign_candidates: int = 4,
    spill_margin: float = 0.15,
    host_arrays: bool = False,
    ids: Optional[np.ndarray] = None,  # original row id per streamed row
    coarse: Optional[int] = None,
    device: DeviceLike = None,
) -> IVFIndex:
    """Corpus-scale build that never holds the f32 matrix on the device.

    Three passes over host chunks: (1) reservoir-sample a k-means
    training set, (2) top-c centroid assignment on ``device`` (default
    CUDA), (3) BALANCED placement: a row whose nearest cluster is full
    goes to its next-nearest cluster with a free slot (within
    ``spill_margin`` of its best score), else to the exactly-scanned
    overflow.  ``chunks`` is called twice.  ``coarse`` switches training
    and assignment to the two-level path.  ``host_arrays`` leaves the
    arrays on the CPU."""
    dev = resolve_device(device)
    if residual is None:
        residual = dtype == torch.int8

    def norm(a: np.ndarray) -> np.ndarray:
        if Metric(metric) == Metric.COSINE:
            nrm = np.linalg.norm(a, axis=1, keepdims=True)
            return a / np.where(nrm > 0, nrm, 1.0)
        return a

    # pass 1: count + reservoir sample for k-means training
    rng = np.random.default_rng(seed)
    reservoir: Optional[np.ndarray] = None
    filled = n = 0
    for chunk in chunks():
        chunk = norm(np.asarray(chunk, np.float32))
        m, d = chunk.shape
        if reservoir is None:
            reservoir = np.empty((train_sample, d), np.float32)
        take = min(train_sample - filled, m)
        start = 0
        if take > 0:
            reservoir[filled:filled + take] = chunk[:take]
            filled += take
            start = take
        if start < m:
            pos = rng.integers(0, n + start + np.arange(m - start) + 1)
            repl = pos < train_sample
            reservoir[pos[repl]] = chunk[start:][repl]
        n += m
    if n == 0 or reservoir is None:
        raise ValueError("empty corpus stream")
    train = torch.from_numpy(reservoir[:filled]).to(dev)

    coarse_np = None
    if coarse is not None and coarse > 1:
        centroids, cen_coarse = kmeans_twolevel(
            train, nlist, coarse, iters=kmeans_iters, seed=seed,
            metric=metric)
        coarse_np = cen_coarse.cpu().numpy()
    else:
        centroids = kmeans(train, nlist, iters=kmeans_iters, seed=seed,
                           metric=metric)
    del train
    cen_np = centroids.cpu().numpy()
    d = cen_np.shape[1]

    capacity = capacity_for(n, nlist, capacity_factor)
    store_int8 = dtype == torch.int8
    use_signs = store_int8 and d % 8 == 0
    if store_int8:
        values = np.zeros((nlist, capacity, d), np.int8)
        scales = np.zeros((nlist, capacity), np.float32)
        signs = (np.zeros((nlist, capacity, d // 8), np.uint8)
                 if use_signs else None)
    else:
        values = np.zeros((nlist, capacity, d), np.float32)
        scales = signs = None
    row_ids = np.full((nlist, capacity), -1, np.int32)
    counts = np.zeros(nlist, np.int64)
    of_vals, of_scales, of_rows, of_signs, of_assign_l = [], [], [], [], []

    # pass 2: assign + balanced fill
    ids_arr = None if ids is None else np.asarray(ids, np.int32)
    if ids_arr is not None and ids_arr.shape != (n,):
        raise ValueError("ids must map every streamed row")
    base = 0
    cand_c = min(assign_candidates, nlist)
    for chunk in chunks():
        chunk = norm(np.asarray(chunk, np.float32))
        m = chunk.shape[0]
        if coarse_np is not None:
            cand, cscore = _assign_topc_grouped(chunk, cen_np, coarse_np,
                                                cand_c)
        else:
            cand_t, cscore_t = _assign_topc(
                torch.from_numpy(chunk).to(dev), centroids, cand_c)
            cand, cscore = cand_t.cpu().numpy(), cscore_t.cpu().numpy()
        allowed = cscore >= (cscore[:, :1] - spill_margin)
        cl, slot, spill = _balanced_place(cand, counts, capacity, allowed)
        ok = cl >= 0
        stored = chunk[ok]
        if residual:
            stored = stored - cen_np[cl[ok]]
        if store_int8:
            q, s = _quant_rows(stored)
            values[cl[ok], slot[ok]] = q
            scales[cl[ok], slot[ok]] = s
            if use_signs:
                signs[cl[ok], slot[ok]] = pack_error_signs(stored, q, s)
        else:
            values[cl[ok], slot[ok]] = stored
        pos = base + np.flatnonzero(ok)
        row_ids[cl[ok], slot[ok]] = (ids_arr[pos] if ids_arr is not None
                                     else pos.astype(np.int32))
        if spill.size:
            sv = chunk[spill]
            if store_int8 and residual:
                # residual-code spilled rows against their BEST centroid
                sv = sv - cen_np[cand[spill, 0]]
                of_assign_l.append(cand[spill, 0].astype(np.int32))
            if store_int8:
                q, s = _quant_rows(sv)
                of_vals.append(q)
                of_scales.append(s)
                if use_signs:
                    of_signs.append(pack_error_signs(sv, q, s))
            else:
                of_vals.append(sv)
            sp = base + spill
            of_rows.append(ids_arr[sp] if ids_arr is not None
                           else sp.astype(np.int32))
        base += m

    out = torch.device("cpu") if host_arrays else dev

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(out)

    def put_values(a: np.ndarray) -> torch.Tensor:
        # bf16 / f32 values were gathered as f32 on the host
        return put(a) if store_int8 else _storage(a, dtype).to(out)

    overflow = overflow_ids = of_sign = of_assign = None
    if of_vals:
        overflow = DenseCorpus(
            values=put_values(np.concatenate(of_vals)),
            scales=put(np.concatenate(of_scales)) if store_int8 else None)
        if use_signs:
            of_sign = put(np.concatenate(of_signs))
        if of_assign_l:
            of_assign = put(np.concatenate(of_assign_l))
        overflow_ids = put(np.concatenate(of_rows))

    return IVFIndex(
        centroids=centroids.to(out), values=put_values(values),
        scales=put(scales) if scales is not None else None,
        row_ids=put(row_ids), overflow=overflow, overflow_rows=overflow_ids,
        residual=residual, sign_plane=put(signs) if use_signs else None,
        of_sign_plane=of_sign, of_assign=of_assign,
    )


# -- shared search tail -------------------------------------------------------------


def _dot_scores(q: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """f32 scores ``q @ values.T`` as the reference forms them: int8 codes
    and bf16 values meet a bf16-rounded query (exact products, f32 sums);
    f32 values meet the f32 query."""
    if values.dtype == torch.float32:
        return q @ values.T
    return q.to(torch.bfloat16).to(torch.float32) @ values.to(torch.float32).T


def refine_candidates(
    q: torch.Tensor,  # [B, D] f32 (unit-norm already for cosine)
    cs: Optional[torch.Tensor],  # [B, nlist] probe scores q @ centroids.T
    index: IVFIndex,
    fv: torch.Tensor,  # [B, K] phase-1 scores (sorted desc, -inf pad)
    fi: torch.Tensor,  # [B, K] global row ids (-1 invalid)
    loc: torch.Tensor,  # [B, K] location codes: cluster*cap + slot, or
                        # nlist*cap + overflow index
) -> tuple[torch.Tensor, torch.Tensor]:
    """Re-score the candidate pool from its codes + error signs + exact
    centroid correction, then re-sort: two [B, K, D] gathers."""
    nlist, cap, d = index.values.shape
    split = nlist * cap
    loc = loc.long()
    in_cl = loc < split
    lc = loc.clamp(0, split - 1)
    vals = index.values.reshape(split, d)[lc]
    scl = index.scales.reshape(split)[lc]
    sgn = unpack_signs(index.sign_plane.reshape(split, d // 8)[lc])
    cl_of_loc = lc // cap
    if index.overflow is not None:
        m = index.overflow.size
        oc = (loc - split).clamp(0, m - 1)
        vals = torch.where(in_cl[..., None], vals, index.overflow.values[oc])
        scl = torch.where(in_cl, scl, index.overflow.scales[oc])
        if index.of_sign_plane is not None:
            sgn = torch.where(in_cl[..., None], sgn,
                              unpack_signs(index.of_sign_plane[oc]))
        if index.of_assign is not None:
            cl_of_loc = torch.where(in_cl, cl_of_loc,
                                    index.of_assign[oc].long())
    qf = q.to(torch.float32)
    dots = torch.einsum("bkd,bd->bk", vals.to(torch.float32), qf)
    dots = dots + 0.25 * torch.einsum("bkd,bd->bk", sgn, qf)
    scores = dots * scl
    if index.residual:
        corr = torch.gather(cs, 1, cl_of_loc)
        if index.of_assign is None and index.overflow is not None:
            # overflow rows store FULL vectors (legacy layout): no add-back
            corr = torch.where(in_cl, corr, 0.0)
        scores = scores + corr
    scores = torch.where(fi >= 0, scores, NEG_INF)
    rv, pos = stable_topk(scores, fv.shape[1])
    ri = torch.gather(fi, -1, pos)
    return rv, torch.where(torch.isfinite(rv), ri, -1)


def overflow_topk(
    q: torch.Tensor,  # [B, D] f32
    cs: Optional[torch.Tensor],  # [B, nlist] probe scores (residual add-back)
    index: IVFIndex,
    k: int,
    mask: Optional[torch.Tensor] = None,  # [N] bool over GLOBAL rows
    block_size: int = 65536,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k over the overflow segment; returns (scores, global ids, LOCAL
    overflow indices).  Residual-coded overflow (``of_assign``) adds the
    stored centroid's probe score back block by block.  The last block is
    padded to ``block_size`` with -inf slots, as in the reference."""
    of = index.overflow
    m = of.size
    k_eff = min(k, m)
    use_bias = index.of_assign is not None and cs is not None
    keep = None if mask is None else mask[index.overflow_rows.long()]
    kb = min(k_eff, block_size)
    vals, idxs = [], []
    for lo in range(0, m, block_size):
        hi = min(m, lo + block_size)
        s = _dot_scores(q, of.values[lo:hi])
        if of.scales is not None:
            s = s * of.scales[None, lo:hi]
        if use_bias:
            s = s + cs[:, index.of_assign[lo:hi].long()]
        if keep is not None:
            s = torch.where(keep[None, lo:hi], s, NEG_INF)
        s = torch.nn.functional.pad(s, (0, block_size - (hi - lo)),
                                    value=NEG_INF)
        v, i = stable_topk(s, kb)
        vals.append(v)
        idxs.append(i + lo)
    ov, pos = stable_topk(torch.cat(vals, 1), k_eff)
    oi_local = torch.gather(torch.cat(idxs, 1), -1, pos)
    # a padding slot (-inf) may name a position past the segment: its id
    # is read from the clamped position and is never a finite candidate
    oi = index.overflow_rows[oi_local.clamp(max=m - 1)]
    return ov, oi, oi_local


def attach_overflow_and_refine(
    q: torch.Tensor,
    cs: Optional[torch.Tensor],
    index: IVFIndex,
    fv: torch.Tensor,  # [B, K] in-cluster phase scores
    fi: torch.Tensor,  # [B, K] global row ids
    floc: torch.Tensor,  # [B, K] location codes (cluster*cap + slot)
    k: int,
    mask: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Shared tail of every IVF search: merge the overflow segment's exact
    top-k into the in-cluster candidates, then re-score the pool with the
    1-bit sign plane."""
    split = index.nlist * index.capacity
    fi = fi.to(torch.int32)
    floc = floc.to(torch.int64)
    if index.overflow is not None:
        if index.of_assign is not None:
            ov, oi, oi_local = overflow_topk(q, cs, index, k, mask=mask)
        else:
            ov, oi_local = dense_search(
                q, index.overflow, k=min(k, index.overflow.size),
                metric=Metric.DOT,  # rows already unit-norm
                mask=(mask[index.overflow_rows.long()]
                      if mask is not None else None))
            oi = index.overflow_rows[oi_local.long()]
        fv = torch.cat([fv, ov], 1)
        fi = torch.cat([fi, oi.to(torch.int32)], 1)
        floc = torch.cat([floc, split + oi_local.to(torch.int64)], 1)
        fv, pos = stable_topk(fv, k)
        fi = torch.gather(fi, -1, pos)
        floc = torch.gather(floc, -1, pos)
    if index.sign_plane is not None:
        fv, fi = refine_candidates(q, cs, index, fv, fi, floc)
    return fv, fi


# -- search tiers -------------------------------------------------------------------


def _ivf_search_core(q, centroids, values, scales, row_ids, mask, k: int,
                     nprobe: int, query_block: int, residual: bool = False):
    """Plain gather tier: per block of queries, gather the probed tiles
    ``[QB, nprobe, C, D]`` and score them.  Returns (values, ids, loc)."""
    nlist, cap, _ = values.shape
    outs = []
    for lo in range(0, q.shape[0], query_block):
        qb = q[lo:lo + query_block]
        cs = qb @ centroids.T  # [QB, nlist]
        _, probes = stable_topk(cs, nprobe)  # [QB, nprobe]
        v = values[probes]  # [QB, nprobe, C, D]
        ids = row_ids[probes]  # [QB, nprobe, C]
        if values.dtype == torch.float32:
            qv, vf = qb, v
        else:
            qv = qb.to(torch.bfloat16).to(torch.float32)
            vf = v.to(torch.float32)
        s = torch.einsum("qd,qpcd->qpc", qv, vf)
        if scales is not None:
            s = s * scales[probes]
        if residual:
            s = s + torch.gather(cs, 1, probes)[:, :, None]
        valid = ids >= 0
        if mask is not None:
            valid = valid & mask[ids.clamp(min=0).long()]
        s = torch.where(valid, s, NEG_INF)
        nq = qb.shape[0]
        s = s.reshape(nq, nprobe * cap)
        ids = ids.reshape(nq, nprobe * cap)
        v_top, pos = stable_topk(s, min(k, nprobe * cap))
        i_top = torch.gather(ids, -1, pos)
        cl_top = torch.gather(probes, 1, pos // cap)
        outs.append((v_top, i_top, cl_top * cap + pos % cap))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def ivf_search(
    queries: torch.Tensor,
    index: IVFIndex,
    k: int,
    nprobe: int = 16,
    mask: Optional[torch.Tensor] = None,
    metric: Metric = Metric.COSINE,
    query_block: int = 32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Approximate top-k; returns (scores [B, k], int32 global row ids)."""
    q = normalize_queries(queries.to(index.device), metric)
    nprobe = min(nprobe, index.nlist)
    v, i, loc = _ivf_search_core(
        q, index.centroids, index.values, index.scales, index.row_ids, mask,
        k=k, nprobe=nprobe, query_block=min(query_block, q.shape[0]),
        residual=index.residual)
    cs = None
    if index.residual or index.sign_plane is not None:
        cs = q @ index.centroids.T
    return attach_overflow_and_refine(q, cs, index, v, i, loc, k, mask=mask)


def _int8_scores(q_i8: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Exact int32 sums of int8 x int8 products, as f32.  On the card
    ``torch._int_mm`` where its shape rules allow; elsewhere an f32
    matmul, exact too (|sum| <= D * 127^2 < 2^24 for D <= 1040)."""
    b, d = q_i8.shape
    if (q_i8.is_cuda and b > 16 and d % 8 == 0 and v.shape[0] % 8 == 0):
        return torch._int_mm(q_i8, v.T).to(torch.float32)
    return q_i8.to(torch.float32) @ v.to(torch.float32).T


def ivf_flat_topk(
    queries: torch.Tensor,
    index: IVFIndex,
    k: int,
    metric: Metric = Metric.COSINE,
    mask: Optional[torch.Tensor] = None,
    block_clusters: Optional[int] = None,
    int8_queries: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Large-batch tier: when B * nprobe reaches nlist the probe union
    covers the index, so every cluster tile is scanned once per batch as
    big matmuls over blocks of whole tiles (residual add-back broadcast
    over the [B, clusters, C] view), then the shared overflow + refine
    tail.  Exact top-k where the reference may take ``approx_max_k``."""
    q = normalize_queries(queries.to(index.device), metric)
    b = q.shape[0]
    nlist, cap, d = index.values.shape
    cs = q @ index.centroids.T  # [B, nlist]
    if block_clusters is None:
        # largest divisor of nlist whose block stays near 512k rows
        target = max(1, (1 << 19) // cap)
        block_clusters = max(c for c in range(1, nlist + 1)
                             if nlist % c == 0 and c <= target)
    cpb = block_clusters
    nb = nlist // cpb
    blk = cpb * cap
    k_blk = min(k, blk)
    use_int8 = int8_queries and index.values.dtype == torch.int8
    if use_int8:
        # phase-1 ranking with int8 queries; the refine stage re-scores
        # the pool against the f32 queries
        q_abs = q.abs().amax(dim=-1)
        sq = (torch.where(q_abs > 0, q_abs, torch.ones_like(q_abs))
              / q_abs.new_tensor(127.0))
        q_i8 = torch.clamp(torch.round(q / sq[:, None]), -127, 127).to(
            torch.int8)
    vs, locs = [], []
    for j in range(nb):
        c0, c1 = j * cpb, (j + 1) * cpb
        v2 = index.values[c0:c1].reshape(blk, d)
        if use_int8:
            sc = _int8_scores(q_i8, v2) * sq[:, None]
        else:
            sc = _dot_scores(q, v2)
        if index.scales is not None:
            sc = sc * index.scales[c0:c1].reshape(blk)[None, :]
        if index.residual:
            sc = (sc.reshape(b, cpb, cap) + cs[:, c0:c1, None]).reshape(b, blk)
        rows = index.row_ids[c0:c1].reshape(blk)
        keep = rows >= 0
        if mask is not None:
            keep = keep & mask[rows.clamp(min=0).long()]
        sc = torch.where(keep[None, :], sc, NEG_INF)
        v_, p_ = stable_topk(sc, k_blk)
        vs.append(v_)
        locs.append(p_ + j * blk)
    vs = torch.cat(vs, 1)
    locs = torch.cat(locs, 1)
    k_eff = min(k, nb * k_blk)
    fv, pos = stable_topk(vs, k_eff)
    floc = torch.gather(locs, -1, pos)
    fi = index.row_ids.reshape(nlist * cap)[floc]
    fi = torch.where(torch.isfinite(fv), fi, -1)
    return attach_overflow_and_refine(q, cs, index, fv, fi, floc, k_eff,
                                      mask=mask)
