"""Card-only tests of the PyTorch port: the CUDA kernels against their
plain PyTorch versions, and the engine on the card (flat and IVF tiers)
against the same engine on the CPU.  They skip without a CUDA card.  This file imports no JAX, so it runs
on a machine that has none:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from super_rag_tpu_torch.engine.collection import CollectionEngine
from super_rag_tpu_torch.engine.index import IndexSpec
from super_rag_tpu_torch.models.hash_embedder import HashEmbedder
from super_rag_tpu_torch.ops import dense_topk as dt
from super_rag_tpu_torch.ops.dense import build_corpus
from torch_parity import all_scores, assert_topk_match

MODES = {"int8xint8": (torch.int8, True), "int8+bf16q": (torch.int8, False),
         "bf16": (torch.bfloat16, False), "f32": (torch.float32, False)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
def test_kernel_matches_plain_version(card, mode):
    """int8 x int8 bit-equal; the float modes within D * 2^-23 *
    (max|score| + 1): sums of exact products in different orders."""
    dtype, i8q = MODES[mode]
    gen = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(5000, 96, device=card, generator=gen)
    q = torch.randn(20, 96, device=card, generator=gen)
    keep = torch.rand(5000, device=card, generator=gen) < 0.6
    for metric in ("cosine", "ip", "l2"):
        corpus = build_corpus(x, metric=metric, dtype=dtype)
        for tile in (200, 2048):
            qq, qs, kt, _ = dt.prepare(q, corpus, 10, metric, tile, i8q, 2)
            norms = corpus.norms_sq if metric == "l2" else None
            args = (qq, qs, corpus.values, corpus.scales, norms, keep, 5000,
                    tile, kt)
            variant = dt.kernel_variant(dt._mode(qq, corpus.values), kt, 96, 20,
                                        -(-5000 // tile))
            assert variant == "tcs"  # f32 too: three TF32 products
            before = dt.tc_launches.count
            kv, ki = dt.tile_topk(*args)
            assert dt.tc_launches.count == before + 1
            pv, pi = dt.tile_topk_plain(*args)
            fin = torch.isfinite(pv)
            if i8q:
                assert torch.equal(kv, pv) and torch.equal(ki[fin], pi[fin])
            else:
                tol = 96 * 2.0 ** -23 * (float(pv[fin].abs().max()) + 1.0)
                assert_topk_match(pv.cpu(), pi.cpu(), kv.cpu(), ki.cpu(),
                                  rtol=0.0, atol=tol,
                                  scores=dt.plain_scores(*args[:6], 0, 5000))


def _int8_operands(card, b, n, d, seed, masked, l2):
    """int8 x int8 operands made on the card: codes, per-row scales, int8
    queries with their scales; a keep-mask whose second tile is all
    masked; rows 64.. repeating rows 0.. (ties inside and across tiles)."""
    gen = torch.Generator(device=card).manual_seed(seed)
    values = torch.randint(-127, 128, (n, d), device=card, generator=gen,
                           dtype=torch.int8)
    values[64:96] = values[0:32]
    values[2048 + 5:2048 + 37] = values[0:32]
    scales = torch.rand(n, device=card, generator=gen) * 0.01 + 0.001
    scales[64:96] = scales[0:32]
    scales[2048 + 5:2048 + 37] = scales[0:32]
    q = torch.randint(-127, 128, (b, d), device=card, generator=gen,
                      dtype=torch.int8)
    qscale = torch.rand(b, device=card, generator=gen) * 0.01 + 0.001
    mask = None
    if masked:
        mask = torch.rand(n, device=card, generator=gen) < 0.7
        mask[2048:4096] = False
    norms = (torch.rand(n, device=card, generator=gen) if l2 else None)
    return q, qscale, values, scales, norms, mask


@pytest.fixture
def force_variant(monkeypatch):
    """Make the wrapper take the named kernel variant whatever the shape."""
    def force(name):
        monkeypatch.setattr(dt, "kernel_variant", lambda *a, **kw: name)
        return name
    return force


def _launched(variant, mode, before):
    """One launch of ``variant`` (and of no other) since the counts
    ``before`` (``_counts()``)."""
    after = _counts(mode)
    moved = tuple(a - b for a, b in zip(after, before))
    return moved == {"tc": (1, 1, 1)}.get(variant, (1, 1, 0))


def _counts(mode):
    per_mode = dt.tc_mode_launches.get(mode)
    return (dt.tc_launches.count, per_mode.count if per_mode is not None else 0,
            dt.list_launches.count)


@pytest.mark.cuda
@pytest.mark.parametrize("kt", [1, 2, 3, 8, 9, 32, 100, 128, 129, 256, 2048])
@pytest.mark.parametrize("d", [16, 48, 768])
@pytest.mark.parametrize("b", [1, 17, 130])
def test_int8_kernel_bit_equal_at_ragged_shapes(card, force_variant, b, d, kt):
    """int8 x int8 at B not a multiple of either query block, n = 5000
    (not a multiple of the 2048-row tile nor of either chunk), D in
    {16, 48, 768}: the register-list kernel (kt <= 8) and the
    sorted-selection kernel (sorted lists at kt <= 128, the deep selection
    at kt 129, 256 and the tile's 2,048; every split of the tile's rows)
    equal tile_topk_plain bit for bit, values and ids, -inf slots
    included; with and without a mask (an all-masked tile), with L2
    norms, with duplicate rows."""
    n, tile = 5000, 2048
    variants = ["tc", "tcs"] if kt <= dt.LIST_MAX_KT else ["tcs"]
    assert dt.kernel_variant(dt.MODE_INT8, kt, d, b, 3) == "tcs"
    for masked, l2 in ((False, False), (True, False), (True, True)):
        q, qs, values, scales, norms, mask = _int8_operands(
            card, b, n, d, seed=b * 1000 + d + kt, masked=masked, l2=l2)
        args = (q, qs, values, scales, norms, mask, n, tile, kt)
        pv, pi = dt.tile_topk_plain(*args)
        for variant in variants:
            force_variant(variant)
            before = _counts(dt.MODE_INT8)
            kv, ki = dt.tile_topk(*args)
            assert _launched(variant, dt.MODE_INT8, before)
            torch.cuda.synchronize()
            assert torch.equal(kv, pv), variant
            assert torch.equal(ki, pi), variant
        if masked:
            assert torch.isinf(kv[1]).all()  # the all-masked tile


@pytest.mark.cuda
@pytest.mark.parametrize("kt", [1, 2, 5])
def test_int8_kernel_bit_equal_at_the_largest_d(card, force_variant, kt):
    """D = 1,024 (the largest D of the sorted-selection kernel's former
    resident form) at B = 130: both tensor-core kernels stream their
    queries through their rings at this D as at every other."""
    n, b, d = 4100, 130, 1024
    q, qs, values, scales, norms, mask = _int8_operands(
        card, b, n, d, seed=kt, masked=True, l2=True)
    args = (q, qs, values, scales, norms, mask, n, 2048, kt)
    pv, pi = dt.tile_topk_plain(*args)
    for variant in ("tc", "tcs"):
        force_variant(variant)
        before = _counts(dt.MODE_INT8)
        kv, ki = dt.tile_topk(*args)
        assert _launched(variant, dt.MODE_INT8, before)
        torch.cuda.synchronize()
        assert torch.equal(kv, pv) and torch.equal(ki, pi), variant


@pytest.mark.cuda
@pytest.mark.parametrize("kt", [1, 2, 3, 8])
@pytest.mark.parametrize("d", [16, 48, 768, 1040, 1536, 4096])
def test_register_list_kernel_bit_equal_at_every_d(card, force_variant, d, kt):
    """The register-list kernel (a TMA ring of 128-byte k-slices, wgmma
    s8) at D from 16 (one k-slice, mostly zeros) to 4,096 (32 k-slices),
    B 1, 17, 130 and 512 (a block of padding rows, ragged query blocks,
    four blocks), kt 1 to 8: equal to tile_topk_plain bit for bit, values
    and ids.  5,000 of 5,200 rows scanned (live_rows below N: the map stops
    at row 5,000), so the last 2048-row tile is ragged; duplicate rows
    (ties inside and across tiles); with and without a mask whose second
    tile is all masked; L2 norms at B = 17."""
    rows, n, tile = 5200, 5000, 2048
    force_variant("tc")
    for b in (1, 17, 130, 512):
        for masked in (False, True):
            q, qs, values, scales, norms, mask = _int8_operands(
                card, b, rows, d, seed=b * 7 + d + kt, masked=masked, l2=b == 17)
            args = (q, qs, values, scales, norms, mask, n, tile, kt)
            pv, pi = dt.tile_topk_plain(*args)
            before = _counts(dt.MODE_INT8)
            kv, ki = dt.tile_topk(*args)
            assert _launched("tc", dt.MODE_INT8, before)
            torch.cuda.synchronize()
            assert torch.equal(kv, pv) and torch.equal(ki, pi), (b, masked)
            if masked:
                assert torch.isinf(kv[1]).all() and (ki[1] == tile).all()


@pytest.mark.cuda
@pytest.mark.parametrize("sms", [1, 7, 132])
def test_register_list_kernel_persistent_grid(card, monkeypatch, sms):
    """The persistent grid: 300,000 rows of D = 256 at B = 512 (147 tiles x
    4 query blocks = 588 work items) walked by 1, 7 or 132 blocks, each
    taking every grid-th item through one ring: the same bits as the plain
    version whatever the grid, and the route the shape picks on its own."""
    n, d, b, tile = 300_000, 256, 512, 2048
    monkeypatch.setattr(dt, "_sm_count", lambda i: sms)
    q, qs, values, scales, norms, mask = _int8_operands(
        card, b, n, d, seed=sms, masked=True, l2=False)
    assert dt.list_grid(b, -(-n // tile), sms) == sms
    for kt in (2, 5):
        args = (q, qs, values, scales, None, mask, n, tile, kt)
        assert dt.kernel_variant(dt.MODE_INT8, kt, d, b, -(-n // tile), sms) == "tc"
        before = _counts(dt.MODE_INT8)
        kv, ki = dt.tile_topk(*args)
        assert _launched("tc", dt.MODE_INT8, before)
        pv, pi = dt.tile_topk_plain(*args)
        assert torch.equal(kv, pv) and torch.equal(ki, pi), kt


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [200, 1000])
def test_int8_kernel_bit_equal_at_small_tiles(card, force_variant, tile):
    """Tiles that are not a multiple of either chunk."""
    n, b = 5000, 70
    q, qs, values, scales, norms, mask = _int8_operands(
        card, b, n, 96, seed=tile, masked=True, l2=False)
    for kt in (1, 4, 8, 40):
        args = (q, qs, values, scales, None, mask, n, tile, kt)
        pv, pi = dt.tile_topk_plain(*args)
        for variant in (("tc", "tcs") if kt <= dt.LIST_MAX_KT else ("tcs",)):
            force_variant(variant)
            before = _counts(dt.MODE_INT8)
            kv, ki = dt.tile_topk(*args)
            assert _launched(variant, dt.MODE_INT8, before)
            torch.cuda.synchronize()
            assert torch.equal(kv, pv) and torch.equal(ki, pi), variant


def _bf16q_operands(card, mode, b, n, d, seed):
    """bf16 queries on bf16 rows or on int8 codes with row scales; rows
    64.. repeat rows 0.. (ties); a keep-mask whose second tile is all
    masked."""
    gen = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn(n, d, device=card, generator=gen)
    x[64:96] = x[0:32]
    if mode == dt.MODE_BF16:
        values, scales = x.to(torch.bfloat16), None
    else:
        values = torch.clamp(torch.round(x * 40), -127, 127).to(torch.int8)
        scales = torch.rand(n, device=card, generator=gen) * 0.01 + 0.001
        scales[64:96] = scales[0:32]
    q = torch.randn(b, d, device=card, generator=gen).to(torch.bfloat16)
    mask = torch.rand(n, device=card, generator=gen) < 0.7
    mask[2048:4096] = False
    return q, values, scales, mask


BF16Q_MODES = {"bf16": dt.MODE_BF16, "int8+bf16q": dt.MODE_INT8_BF16}


@pytest.mark.cuda
@pytest.mark.parametrize("kt", [1, 2, 3, 8, 9, 32, 100, 128])
@pytest.mark.parametrize("mode", list(BF16Q_MODES))
def test_bf16_tensor_core_kernel_within_tolerance(card, mode, kt):
    """bf16 queries on the tensor cores at ragged B (1, 17, 64, 130), D
    (16, 96, 256, 768) and tile (200, 1024, 2048), masked (an all-masked
    tile) and not, with duplicate rows: -inf slots equal, values within
    D * 2^-23 * (max|score| + 1) of tile_topk_plain (exact products
    summed in f32 in another order), ids equal but at near-ties."""
    m = BF16Q_MODES[mode]
    n = 5000
    for b in (1, 17, 64, 130):
        for d in (16, 96, 256, 768):
            q, values, scales, mask = _bf16q_operands(card, m, b, n, d, seed=b + d + kt)
            for tile in (200, 1024, 2048):
                for msk in (None, mask):
                    args = (q, None, values, scales, None, msk, n, tile, kt)
                    assert dt.kernel_variant(m, kt, d, b, -(-n // tile)) == "tcs"
                    before = _counts(m)
                    kv, ki = dt.tile_topk(*args)
                    assert _launched("tcs", m, before)
                    pv, pi = dt.tile_topk_plain(*args)
                    fin = torch.isfinite(pv)
                    tol = d * 2.0 ** -23 * (float(pv[fin].abs().max()) + 1.0)
                    assert_topk_match(pv.cpu(), pi.cpu(), kv.cpu(), ki.cpu(),
                                      rtol=0.0, atol=tol,
                                      scores=dt.plain_scores(*args[:6], 0, n))
                    if msk is not None and tile == 2048:
                        assert torch.isinf(kv[1]).all()
                        assert (ki[1] == 2048).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1040, 1536, 3072, 4096])
@pytest.mark.parametrize("mode", [dt.MODE_INT8, dt.MODE_INT8_BF16, dt.MODE_BF16])
def test_tensor_core_kernel_above_the_resident_block(card, mode, d):
    """D above 1,024 (the remote embeddings' 1,536, 3,072 and 4,096): the
    sorted-selection kernel in its one form (the queries stream through
    the ring like the rows), at B 1, 17 and 130, kt 1 to 128, tiles of 200
    and 2048 rows, with a mask (an all-masked tile) and duplicate rows:
    int8 x int8 equals the plain version bit for bit, the bf16 modes are
    within D * 2^-23 * (max|score| + 1) with ids equal but at near-ties."""
    n = 5000
    for b in (1, 17, 130):
        if mode == dt.MODE_INT8:
            q, qs, values, scales, norms, mask = _int8_operands(
                card, b, n, d, seed=b + d, masked=True, l2=b == 17)
        else:
            q, values, scales, mask = _bf16q_operands(card, mode, b, n, d, seed=b + d)
            qs, norms = None, None
        for kt in (1, 5, 32, 128):
            for tile in (200, 2048):
                args = (q, qs, values, scales, norms, mask, n, tile, kt)
                assert dt.kernel_variant(mode, kt, d, b, -(-n // tile)) == "tcs"
                before = _counts(mode)
                kv, ki = dt.tile_topk(*args)
                assert _launched("tcs", mode, before)
                pv, pi = dt.tile_topk_plain(*args)
                if mode == dt.MODE_INT8:
                    assert torch.equal(kv, pv) and torch.equal(ki, pi), (b, kt, tile)
                else:
                    fin = torch.isfinite(pv)
                    tol = d * 2.0 ** -23 * (float(pv[fin].abs().max()) + 1.0)
                    assert_topk_match(pv.cpu(), pi.cpu(), kv.cpu(), ki.cpu(), rtol=0.0,
                                      atol=tol, scores=dt.plain_scores(*args[:6], 0, n))
                if tile == 2048:
                    assert torch.isinf(kv[1]).all() and (ki[1] == 2048).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1024, 1040])
@pytest.mark.parametrize("mode", [dt.MODE_INT8, dt.MODE_INT8_BF16, dt.MODE_BF16])
def test_streamed_queries_give_the_resident_bits(card, monkeypatch, mode, d):
    """At D = 1,024 and 1,040 (either side of the former forms' border)
    the one form's bits agree with the plain version (int8 x int8 bit for
    bit, the bf16 modes within D * 2^-23 * (max|score| + 1)), and a query's
    lists are the same bits alone and in a batch of 64 (B 1 and 64, kt 5
    and 32, 16,384 rows: eight tiles split over clusters)."""
    n, tile = 16384, 2048
    if mode == dt.MODE_INT8:
        q, qs, values, scales, norms, mask = _int8_operands(
            card, 64, n, d, seed=d, masked=True, l2=False)
    else:
        q, values, scales, mask = _bf16q_operands(card, mode, 64, n, d, seed=d)
        qs = None
    for kt in (5, 32):
        args = (q, qs, values, scales, None, mask, n, tile, kt)
        before = _counts(mode)
        kv, ki = dt.tile_topk(*args)
        assert _launched("tcs", mode, before)
        pv, pi = dt.tile_topk_plain(*args)
        if mode == dt.MODE_INT8:
            assert torch.equal(kv, pv) and torch.equal(ki, pi)
        else:
            fin = torch.isfinite(pv)
            tol = d * 2.0 ** -23 * (float(pv[fin].abs().max()) + 1.0)
            assert_topk_match(pv.cpu(), pi.cpu(), kv.cpu(), ki.cpu(), rtol=0.0, atol=tol,
                              scores=dt.plain_scores(*args[:6], 0, n))
        one = dt.tile_topk(q[5:6], None if qs is None else qs[5:6], *args[2:])
        assert torch.equal(kv[:, 5:6], one[0]) and torch.equal(ki[:, 5:6], one[1])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [dt.MODE_INT8, dt.MODE_INT8_BF16, dt.MODE_BF16])
@pytest.mark.parametrize("kt", [5, 32])
def test_tensor_core_kernel_is_batch_invariant(card, mode, kt):
    """A query's lists are the same bits alone (B = 1: a block of 16, the
    wgmma's N 16) and at row 37 of batches of 64 and 130 (blocks of 64 and
    128: N 64 and 128; 64 for the int8-codes mode at kt 32, whose stages
    are larger), whatever the split of the tiles' rows each batch takes."""
    n, d, tile = 16384, 256, 2048
    if mode == dt.MODE_INT8:
        q, qs, values, scales, norms, mask = _int8_operands(
            card, 130, n, d, seed=kt, masked=True, l2=False)
    else:
        q, values, scales, mask = _bf16q_operands(card, mode, 130, n, d, seed=kt)
        qs = None
    rows = (values, scales, None, mask, n, tile, kt)
    full = dt.tile_topk(q, qs, *rows)
    mid = dt.tile_topk(q[:64], None if qs is None else qs[:64], *rows)
    one = dt.tile_topk(q[37:38], None if qs is None else qs[37:38], *rows)
    assert [dt.tcs_geometry(mode, b, kt)[0] for b in (64, 1)] == [64, 16]
    assert dt.tcs_geometry(mode, 130, kt)[0] == (
        64 if (mode, kt) == (dt.MODE_INT8_BF16, 32) else 128)
    assert dt.tcs_split(64, 8, tile, 64) == dt.tcs_split(1, 8, tile, 16) == (8, 256)
    for got in (full, mid):
        assert torch.equal(got[0][:, 37:38], one[0])
        assert torch.equal(got[1][:, 37:38], one[1])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [dt.MODE_INT8, dt.MODE_INT8_BF16, dt.MODE_BF16])
@pytest.mark.parametrize("kt", [5, 32])
def test_served_shape_takes_the_split_grid(card, mode, kt):
    """16,384 rows of D = 256 at B = 64 (the served default collection,
    unreranked kt 5 and reranked kt 32): the sorted-selection kernel with
    each 2048-row tile split over a cluster of 8, equal to the plain
    version (int8 x int8 bit for bit)."""
    n, d, tile, b = 16384, 256, 2048, 64
    if mode == dt.MODE_INT8:
        q, qs, values, scales, norms, mask = _int8_operands(
            card, b, n, d, seed=3, masked=True, l2=False)
    else:
        q, values, scales, mask = _bf16q_operands(card, mode, b, n, d, seed=3)
        qs = None
    assert dt.kernel_variant(mode, kt, d, b, n // tile, dt._sm_count(0)) == "tcs"
    qn, _ = dt.tcs_geometry(mode, b, kt)
    assert dt.tcs_split(b, n // tile, tile, qn, dt._sm_count(0)) == (8, 256)
    args = (q, qs, values, scales, None, mask, n, tile, kt)
    before = _counts(mode)
    kv, ki = dt.tile_topk(*args)
    assert _launched("tcs", mode, before)
    pv, pi = dt.tile_topk_plain(*args)
    if mode == dt.MODE_INT8:
        assert torch.equal(kv, pv) and torch.equal(ki, pi)
    else:
        fin = torch.isfinite(pv)
        tol = d * 2.0 ** -23 * (float(pv[fin].abs().max()) + 1.0)
        assert_topk_match(pv.cpu(), pi.cpu(), kv.cpu(), ki.cpu(), rtol=0.0, atol=tol,
                          scores=dt.plain_scores(*args[:6], 0, n))


def _f32_operands(card, b, n, d, seed, metric="ip"):
    """f32 rows built as an index builds them (cosine rows normalised, L2
    norms kept), f32 queries as ``prepare`` leaves them; rows 64.. repeat
    rows 0.. (ties); a keep-mask whose second tile is all masked."""
    gen = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn(n, d, device=card, generator=gen)
    x[64:96] = x[0:32]
    corpus = build_corpus(x, metric=metric, dtype=torch.float32)
    q, _, _, _ = dt.prepare(torch.randn(b, d, device=card, generator=gen), corpus, 1, metric)
    mask = torch.rand(n, device=card, generator=gen) < 0.7
    mask[2048:4096] = False
    return q, corpus.values, corpus.norms_sq if metric == "l2" else None, mask


def _f32_check(args, n):
    """One f32 call on the tensor cores (one launch of mode 3, nothing
    else), against the plain version: -inf slots equal, values within
    D * 2^-23 * (max|score| + 1), ids equal but at near-ties."""
    q, d = args[0], args[0].shape[1]
    before = _counts(dt.MODE_F32)
    kv, ki = dt.tile_topk(*args)
    assert _launched("tcs", dt.MODE_F32, before)
    pv, pi = dt.tile_topk_plain(*args)
    fin = torch.isfinite(pv)
    tol = d * 2.0 ** -23 * (float(pv[fin].abs().max()) + 1.0)
    assert_topk_match(pv.cpu(), pi.cpu(), kv.cpu(), ki.cpu(), rtol=0.0, atol=tol,
                      scores=dt.plain_scores(*args[:6], 0, n))
    return kv, ki


@pytest.mark.cuda
@pytest.mark.parametrize("kt", [1, 2, 3, 8, 9, 32, 100, 128])
@pytest.mark.parametrize("metric", ["cosine", "ip", "l2"])
def test_f32_tensor_core_kernel_within_tolerance(card, metric, kt):
    """f32 collections on the tensor cores (three TF32 products on
    round-to-nearest planes) at ragged B (1, 17, 64, 130) and D (16 to
    4,096), tiles of 200 and 2048 rows, masked (an all-masked tile) and
    not, duplicate rows, every metric: within D * 2^-23 * (max|score| + 1)
    of tile_topk_plain, ids equal but at near-ties; the route is "tcs" at
    every kt <= 128 (and in the deep selection, test_deep_selection_*)."""
    n = 5000
    for b, d in ((1, 16), (17, 48), (64, 96), (130, 768), (17, 1040), (1, 1536),
                 (130, 4096)):
        q, values, norms, mask = _f32_operands(card, b, n, d, seed=b + d + kt, metric=metric)
        for tile in (200, 2048):
            for msk in (None, mask):
                assert dt.kernel_variant(dt.MODE_F32, kt, d, b, -(-n // tile)) == "tcs"
                args = (q, None, values, None, norms, msk, n, tile, kt)
                kv, ki = _f32_check(args, n)
                if msk is not None and tile == 2048:
                    assert torch.isinf(kv[1]).all() and (ki[1] == 2048).all()


@pytest.mark.cuda
@pytest.mark.parametrize("sms,slices", [(1, 1), (20, 4), (132, 8)])
@pytest.mark.parametrize("kt", [5, 32, 128])
def test_f32_tensor_core_kernel_in_every_split(card, monkeypatch, sms, slices, kt):
    """16,384 rows of D = 256 at B = 64 (the served shape) with the tiles'
    rows split for 1, 20 or 132 SMs (1, 4 or 8 blocks a cluster): within
    the tolerance of the plain version, and the same bits whatever the
    split."""
    n, d, b, tile = 16384, 256, 64, 2048
    q, values, norms, mask = _f32_operands(card, b, n, d, seed=kt)
    monkeypatch.setattr(dt, "_sm_count", lambda i: sms)
    args = (q, None, values, None, None, mask, n, tile, kt)
    qn, _ = dt.tcs_geometry(dt.MODE_F32, b, kt)
    assert dt.tcs_split(b, n // tile, tile, qn, sms)[0] == slices
    got = _f32_check(args, n)
    monkeypatch.setattr(dt, "_sm_count", lambda i: 1)
    one = dt.tile_topk(*args)  # one block a tile
    assert torch.equal(got[0], one[0]) and torch.equal(got[1], one[1])


@pytest.mark.cuda
@pytest.mark.parametrize("kt", [5, 32, 129])
def test_f32_kernel_is_batch_invariant(card, kt):
    """A query's f32 lists are the same bits alone (B = 1: a block of 16)
    and at row 37 of batches of 64 and 130 (blocks of 64 and 128, 2 ring
    stages at 128), whatever the split each batch takes; kt 129 takes the
    deep selection of the same kernel."""
    n, d, tile = 16384, 256, 2048
    q, values, norms, mask = _f32_operands(card, 130, n, d, seed=kt)
    rows = (values, None, None, mask, n, tile, kt)
    for b in (1, 64, 130):
        assert dt.kernel_variant(dt.MODE_F32, kt, d, b, n // tile) == "tcs"
    before = _counts(dt.MODE_F32)
    full = dt.tile_topk(q, None, *rows)
    assert _launched("tcs", dt.MODE_F32, before)
    mid = dt.tile_topk(q[:64], None, *rows)
    one = dt.tile_topk(q[37:38], None, *rows)
    if kt <= dt.TC_MAX_KT:
        assert [dt.tcs_geometry(dt.MODE_F32, b, kt)[0] for b in (1, 64, 130)] == [16, 64, 128]
    for got in (full, mid):
        assert torch.equal(got[0][:, 37:38], one[0])
        assert torch.equal(got[1][:, 37:38], one[1])


@pytest.mark.cuda
def test_f32_query_planes_kernel_equals_its_plain_version(card):
    """dense_topk_tf32_planes (the f32 mode's query planes, [2B, D]) equals
    tf32_planes bit for bit: round-to-nearest tf32 with ties away from
    zero, ties, signs, subnormals and zeros included."""
    gen = torch.Generator(device=card).manual_seed(5)
    q = torch.randn(130, 768, device=card, generator=gen)
    q[0, :8] = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 3 * 2.0 ** -11,
                             0.0, -0.0, 1e-40, -3e-39, 2.0 ** -149], device=card)
    out = torch.empty((260, 768), device=card)
    err = dt._lib().dense_topk_tf32_planes(q.data_ptr(), out.data_ptr(), q.numel(),
                                           torch.cuda.current_stream().cuda_stream)
    assert err == 0
    want = dt.tf32_planes(q)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_engine_on_card_answers_as_on_cpu(card):
    """int8 storage: the kernel's int32 sums are exact and every other
    stage is batch- and device-invariant, so the card's hybrid answers
    equal the CPU's (plain version) bit for bit."""
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(400)]
    texts = [" ".join(rng.choice(words, rng.integers(4, 14))) for _ in range(3000)]
    queries = [" ".join(t.split()[:3]) for t in texts[::150]]
    out = {}
    # one set of embeddings: both indexes normalise and quantize the same bits
    emb = HashEmbedder(dim=64, device="cpu").embed(texts)
    for dev in ("cpu", "cuda"):
        eng = CollectionEngine(IndexSpec(dim=64, dtype=torch.int8,
                                         vocab_size=1 << 12, min_capacity=256),
                               device=dev)
        eng.ingest(texts, embeddings=emb)
        eng.index.compact_lexical()
        eng.index._per_tile_k = 2  # the card calibrates at compaction
        res = eng.index.search_hybrid(eng._embed(queries), queries, k=10,
                                      candidates=40, use_kernel=True)
        out[dev] = (res.indices.cpu(), res.scores.cpu())
    assert torch.equal(out["cpu"][0], out["cuda"][0])
    assert torch.equal(out["cpu"][1], out["cuda"][1])


@pytest.mark.cuda
def test_hash_embedder_on_card_equals_cpu(card):
    """Elementwise adds in term order, correctly rounded division and
    square root: the card embeds to the CPU's bits."""
    texts = ["alpha beta gamma", "", " ".join(f"w{i}" for i in range(90))]
    cpu = HashEmbedder(dim=768, device="cpu").embed(texts)
    gpu = HashEmbedder(dim=768, device=card).embed(texts)
    assert torch.equal(cpu, gpu.cpu())


IVF_MODES = {"int8": torch.int8, "bf16": torch.bfloat16, "f32": torch.float32}


def _ivf_operands(card, dtype, residual, masked, seed=0):
    """A ragged tile layout (C = 200, not a multiple of 128), empty slots,
    a keep-mask and probe scores to add back."""
    gen = torch.Generator(device=card).manual_seed(seed)
    nlist, cap, d, b = 12, 200, 96, 20
    x = torch.randn(nlist, cap, d, device=card, generator=gen)
    if dtype == torch.int8:
        values = torch.clamp(torch.round(x * 40), -127, 127).to(torch.int8)
        scales = torch.rand(nlist, cap, device=card, generator=gen) * 0.01
    else:
        values, scales = x.to(dtype), None
    row_ids = torch.randperm(nlist * cap, device=card, generator=gen).to(
        torch.int32).reshape(nlist, cap)
    row_ids[torch.rand(nlist, cap, device=card, generator=gen) < 0.2] = -1
    q = torch.randn(b, d, device=card, generator=gen)
    q = q.to(torch.float32 if dtype == torch.float32 else torch.bfloat16)
    cs = (torch.randn(b, nlist, device=card, generator=gen) if residual
          else None)
    mask = (torch.rand(nlist * cap, device=card, generator=gen) < 0.7
            if masked else None)
    return q, values, scales, cs, row_ids, mask


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(IVF_MODES))
@pytest.mark.parametrize("route", ["union", "probe"])
def test_ivf_kernels_match_plain_versions(card, mode, route):
    """Both IVF kernels against their plain versions, residual on and off,
    with and without a mask: -inf slots equal, values within
    D * 2^-23 * (max|score| + 1) (sums of exact products, or of f32
    products, in other orders); nprobe >= nlist is one of the cases.  Each
    call launches the variant its mode picks once, and no other kernel:
    the union the tensor cores in every mode (f32 as three TF32
    products), the per-query route likewise over its work list."""
    from super_rag_tpu_torch.ops import ivf_topk as it

    for residual in (False, True):
        for masked in (False, True):
            q, values, scales, cs, row_ids, mask = _ivf_operands(
                card, IVF_MODES[mode], residual, masked)
            b = q.shape[0]
            if route == "union":
                ids = torch.tensor([3, 0, 11, 7, 5], dtype=torch.int32,
                                   device=card)
                fn = it.union_scores
                counter = it.union_tc_launches
                plain = it.union_scores_plain
            else:
                ids = torch.randint(0, 12, (b, 14), device=card,
                                    dtype=torch.int32)
                fn = it.probe_scores
                counter = it.probe_tc_launches
                plain = it.probe_scores_plain
            counters = (it.union_tc_launches, it.probe_tc_launches)
            before = [c.count for c in counters]
            got = fn(q, ids, values, scales, cs, row_ids, mask)
            moved = [c.count - n for c, n in zip(counters, before)]
            assert moved == [int(c is counter) for c in counters]
            ref = plain(q, ids, values, scales, cs, row_ids, mask)
            torch.cuda.synchronize()
            fin = torch.isfinite(ref)
            assert torch.equal(fin, torch.isfinite(got))
            tol = 96 * 2.0 ** -23 * (float(ref[fin].abs().max()) + 1.0)
            assert float((got - ref)[fin].abs().max()) <= tol


def _union_operands(card, dtype, b, nlist, cap, d, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn(nlist, cap, d, device=card, generator=gen)
    if dtype == torch.int8:
        values = torch.clamp(torch.round(x * 40), -127, 127).to(torch.int8)
        scales = torch.rand(nlist, cap, device=card, generator=gen) * 0.01
    else:
        values, scales = x.to(dtype), None
    row_ids = torch.randperm(nlist * cap, device=card, generator=gen).to(
        torch.int32).reshape(nlist, cap)
    row_ids[torch.rand(nlist, cap, device=card, generator=gen) < 0.2] = -1
    q = torch.randn(b, d, device=card, generator=gen)
    q = q if dtype == torch.float32 else q.to(torch.bfloat16)
    cs = torch.randn(b, nlist, device=card, generator=gen)
    mask = torch.rand(nlist * cap, device=card, generator=gen) < 0.7
    return q, values, scales, cs, row_ids, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,u,cap,d", [(1, 3, 200, 96), (20, 5, 257, 16),
                                       (33, 7, 1280, 768), (70, 2, 300, 48),
                                       (5, 3, 130, 1536)])
def test_union_tc_kernel_within_tolerance_at_ragged_shapes(card, dtype, b, u,
                                                           cap, d):
    """The tensor-core union kernel against union_scores_plain at B, U and
    C off the 32-query block and the 256-row (f32: 128-row) block, D off
    the stage: the same -inf slots, values within D * 2^-23 * (max|s| +
    1) (f32 values: three TF32 products on round-to-nearest planes)."""
    from super_rag_tpu_torch.ops import ivf_topk as it

    nlist = 9
    q, values, scales, cs, row_ids, mask = _union_operands(card, dtype, b,
                                                           nlist, cap, d)
    union = torch.randperm(nlist, device=card)[:u].to(torch.int32)
    for residual, masked in ((False, False), (True, True)):
        args = (q, union, values, scales, cs if residual else None, row_ids,
                mask if masked else None)
        before = (it.union_tc_launches.count, it.probe_tc_launches.count)
        got = it.union_scores(*args)
        assert (it.union_tc_launches.count, it.probe_tc_launches.count) == (
            before[0] + 1, before[1])
        ref = it.union_scores_plain(*args)
        torch.cuda.synchronize()
        assert got.shape == (b, u, cap)
        fin = torch.isfinite(ref)
        assert torch.equal(fin, torch.isfinite(got))
        tol = d * 2.0 ** -23 * (float(ref[fin].abs().max()) + 1.0)
        assert float((got - ref)[fin].abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
def test_union_tc_kernel_is_batch_invariant(card, dtype):
    """A query scores bit-alike alone and inside a batch of 32 (and of
    40, a second query block): the MMA's order is fixed by D alone (f32:
    the queries' planes are made a row at a time, so alike too)."""
    from super_rag_tpu_torch.ops import ivf_topk as it

    q, values, scales, cs, row_ids, mask = _union_operands(card, dtype, 40, 12,
                                                           1280, 768, seed=3)
    union = torch.tensor([7, 0, 11, 3], dtype=torch.int32, device=card)
    full = it.union_scores(q, union, values, scales, cs, row_ids, mask)
    b32 = it.union_scores(q[:32].contiguous(), union, values, scales,
                          cs[:32].contiguous(), row_ids, mask)
    for i in (0, 17, 31, 35):
        alone = it.union_scores(q[i:i + 1].contiguous(), union, values, scales,
                                cs[i:i + 1].contiguous(), row_ids, mask)
        assert torch.equal(alone[0], full[i])
        if i < 32:
            assert torch.equal(alone[0], b32[i])


def _probe_sets(card, kind, b, nlist, nprobe, gen):
    """Probe lists [B, nprobe] int32 of a kind: random (repeats allowed),
    repeated (every query lists a tile twice), every tile (nprobe =
    nlist), skewed (every query on the same two tiles, so each of them
    spans several groups of the work list)."""
    if kind == "random":
        return torch.randint(0, nlist, (b, nprobe), device=card, generator=gen,
                             dtype=torch.int32)
    if kind == "repeated":
        p = torch.randint(0, nlist, (b, nprobe), device=card, generator=gen,
                          dtype=torch.int32)
        p[:, 1] = p[:, 0]
        return p
    if kind == "every_tile":
        return torch.stack([torch.randperm(nlist, device=card, generator=gen)
                            for _ in range(b)]).to(torch.int32)
    if kind == "skewed":
        pair = torch.tensor([nlist - 1, 1], dtype=torch.int32, device=card)
        return pair.repeat(b, nprobe // 2 + 1)[:, :nprobe].contiguous()
    raise ValueError(kind)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,nlist,nprobe,cap,d,kind", [
    (20, 12, 5, 200, 96, "random"), (33, 9, 4, 257, 16, "repeated"),
    (7, 6, 6, 300, 48, "every_tile"), (70, 8, 3, 200, 96, "skewed"),
    (40, 10, 4, 1280, 768, "random"), (45, 5, 2, 200, 1536, "skewed"),
    (3, 4, 4, 129, 1536, "every_tile")])
def test_probe_tc_kernel_within_tolerance_at_ragged_shapes(
        card, dtype, b, nlist, nprobe, cap, d, kind):
    """The tensor-core per-query kernel against probe_scores_plain in every
    mode (f32 values: three TF32 products): ragged C, D from 16 to 1536
    (above the retired f32 SIMT kernel's 1024), B * nprobe off the
    16-pair group, repeated and skewed probe lists, nprobe = nlist;
    residual and mask on and off.  The same -inf slots, values within
    D * 2^-23 * (max|s| + 1), top-10 ids equal up to near-ties; one
    launch a call."""
    from super_rag_tpu_torch.ops import ivf_topk as it
    from super_rag_tpu_torch.ops.topk import stable_topk

    q, values, scales, cs, row_ids, mask = _union_operands(card, dtype, b,
                                                           nlist, cap, d)
    gen = torch.Generator(device=card).manual_seed(b + d)
    probes = _probe_sets(card, kind, b, nlist, nprobe, gen)
    for residual, masked in ((False, False), (True, True), (True, False),
                             (False, True)):
        args = (q, probes, values, scales, cs if residual else None, row_ids,
                mask if masked else None)
        before = (it.probe_tc_launches.count, it.union_tc_launches.count)
        got = it.probe_scores(*args)
        assert (it.probe_tc_launches.count, it.union_tc_launches.count) == (
            before[0] + 1, before[1])
        ref = it.probe_scores_plain(*args)
        torch.cuda.synchronize()
        assert got.shape == (b, nprobe, cap)
        fin = torch.isfinite(ref)
        assert torch.equal(fin, torch.isfinite(got))
        tol = d * 2.0 ** -23 * (float(ref[fin].abs().max()) + 1.0)
        assert float((got - ref)[fin].abs().max()) <= tol
        k = min(10, nprobe * cap)
        gv, gi = stable_topk(got.reshape(b, -1), k)
        rv, ri = stable_topk(ref.reshape(b, -1), k)
        assert_topk_match(rv.cpu(), ri.cpu(), gv.cpu(), gi.cpu(), rtol=0.0,
                          atol=tol, scores=ref.reshape(b, -1).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
def test_probe_tc_kernel_is_batch_invariant(card, dtype):
    """A query scores bit-alike alone and inside a batch of 512 (where
    its tiles' groups hold other queries): a column's MMA sums depend on
    D alone (f32: its query planes are made a row at a time)."""
    from super_rag_tpu_torch.ops import ivf_topk as it

    b, nlist, nprobe = 512, 64, 16
    q, values, scales, cs, row_ids, mask = _union_operands(card, dtype, b,
                                                           nlist, 1280, 768,
                                                           seed=5)
    gen = torch.Generator(device=card).manual_seed(6)
    probes = _probe_sets(card, "random", b, nlist, nprobe, gen)
    full = it.probe_scores(q, probes, values, scales, cs, row_ids, mask)
    for i in (0, 17, 255, 511):
        alone = it.probe_scores(q[i:i + 1].contiguous(),
                                probes[i:i + 1].contiguous(), values, scales,
                                cs[i:i + 1].contiguous(), row_ids, mask)
        assert torch.equal(alone[0], full[i])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["random", "skewed", "every_tile"])
def test_probe_tc_kernel_equals_union_kernel_gathered(card, dtype, kind):
    """Both routes run one kernel body with one MMA order, so a query's
    scores against a tile are the same bits on either: the per-query
    kernel equals the union kernel over every tile, gathered at each
    query's probes."""
    from super_rag_tpu_torch.ops import ivf_topk as it

    b, nlist, nprobe = 70, 12, 12 if kind == "every_tile" else 5
    q, values, scales, cs, row_ids, mask = _union_operands(card, dtype, b,
                                                           nlist, 300, 768,
                                                           seed=7)
    gen = torch.Generator(device=card).manual_seed(8)
    probes = _probe_sets(card, kind, b, nlist, nprobe, gen)
    every = torch.arange(nlist, dtype=torch.int32, device=card)
    for residual in (False, True):
        c = cs if residual else None
        got = it.probe_scores(q, probes, values, scales, c, row_ids, mask)
        union = it.union_scores(q, every, values, scales, c, row_ids, mask)
        want = torch.gather(union, 1, probes.long()[:, :, None].expand(
            -1, -1, union.shape[2]))
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_f32_union_within_tolerance_of_the_per_query_route(card):
    """f32 values: the union kernel and the per-query kernel run one body
    with one MMA order (three TF32 products a k8 step), so over a fully
    probed batch (every query probes every tile, so both score the same
    pairs) they agree within any tolerance: the per-query scores equal
    the union's gathered bit for bit, residual and mask included; each
    launches its own kernel once."""
    from super_rag_tpu_torch.ops import ivf_topk as it

    b, nlist, cap, d = 40, 10, 300, 768
    q, values, scales, cs, row_ids, mask = _union_operands(card, torch.float32, b, nlist,
                                                           cap, d, seed=9)
    gen = torch.Generator(device=card).manual_seed(10)
    probes = _probe_sets(card, "every_tile", b, nlist, nlist, gen)
    every = torch.arange(nlist, dtype=torch.int32, device=card)
    for residual in (False, True):
        c = cs if residual else None
        before = (it.union_tc_launches.count, it.probe_tc_launches.count)
        union = it.union_scores(q, every, values, scales, c, row_ids, mask)
        got = it.probe_scores(q, probes, values, scales, c, row_ids, mask)
        assert (it.union_tc_launches.count, it.probe_tc_launches.count) == (
            before[0] + 1, before[1] + 1)
        want = torch.gather(union, 1, probes.long()[:, :, None].expand(-1, -1, cap))
        assert torch.isfinite(want).any()
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_f32_union_query_planes_equal_their_plain_version(card):
    """ivf_tf32_planes (the f32 union's query planes, [2B, D]) equals the
    plain tf32_planes bit for bit, as dense_topk's planes kernel does."""
    from super_rag_tpu_torch.ops import ivf_topk as it

    gen = torch.Generator(device=card).manual_seed(11)
    q = torch.randn(33, 768, device=card, generator=gen)
    q[0, :4] = torch.tensor([1.0 + 2.0 ** -11, -0.0, 1e-40, 2.0 ** -149], device=card)
    out = torch.empty((66, 768), device=card)
    assert it._lib().ivf_tf32_planes(q.data_ptr(), out.data_ptr(), q.numel(),
                                     torch.cuda.current_stream().cuda_stream) == 0
    assert torch.equal(out.view(torch.int32), dt.tf32_planes(q).view(torch.int32))


def _deep_operands(card, mode, b, n, d, seed):
    """Operands of a mode at the served shape, in tile_topk's order up to
    the row data: int8 codes with scales and int8 queries, bf16 queries
    on int8 codes or bf16 rows, or f32 rows and queries; duplicate rows
    (ties) and a keep-mask whose second tile is all masked."""
    if mode == dt.MODE_INT8:
        q, qs, values, scales, norms, mask = _int8_operands(card, b, n, d, seed=seed,
                                                           masked=True, l2=False)
        return q, qs, values, scales, mask
    if mode == dt.MODE_F32:
        q, values, _, mask = _f32_operands(card, b, n, d, seed=seed)
        return q, None, values, None, mask
    q, values, scales, mask = _bf16q_operands(card, mode, b, n, d, seed=seed)
    return q, None, values, scales, mask


DEEP_MODES = {"int8xint8": dt.MODE_INT8, "int8+bf16q": dt.MODE_INT8_BF16,
              "bf16": dt.MODE_BF16, "f32": dt.MODE_F32}


@pytest.mark.cuda
@pytest.mark.parametrize("kt", [129, 256, 2048])
@pytest.mark.parametrize("mode", list(DEEP_MODES))
def test_deep_selection_in_every_split(card, monkeypatch, mode, kt):
    """The deep selection (kt above the sorted lists' 128, to the tile) at
    the served shape, 16,384 rows of D = 256 at B = 64, with the tiles'
    rows split as the geometry takes them for 1, 20 and 132 SMs: one
    sorted-selection launch of the mode each; int8 x int8 equal to
    tile_topk_plain bit for bit, the float modes within D * 2^-23 *
    (max|score| + 1) with ids equal but at near-ties; an all-masked tile
    all (-inf, its first row); the same bits whatever the split."""
    m = DEEP_MODES[mode]
    n, d, b, tile = 16384, 256, 64, 2048
    q, qs, values, scales, mask = _deep_operands(card, m, b, n, d, seed=kt)
    args = (q, qs, values, scales, None, mask, n, tile, kt)
    pv, pi = dt.tile_topk_plain(*args)
    first = None
    for sms in (132, 20, 1):
        monkeypatch.setattr(dt, "_sm_count", lambda i, sms=sms: sms)
        assert dt.kernel_variant(m, kt, d, b, n // tile, sms) == "tcs"
        before = _counts(m)
        kv, ki = dt.tile_topk(*args)
        assert _launched("tcs", m, before)
        torch.cuda.synchronize()
        if m == dt.MODE_INT8:
            assert torch.equal(kv, pv) and torch.equal(ki, pi), sms
        else:
            fin = torch.isfinite(pv)
            tol = d * 2.0 ** -23 * (float(pv[fin].abs().max()) + 1.0)
            assert_topk_match(pv.cpu(), pi.cpu(), kv.cpu(), ki.cpu(), rtol=0.0, atol=tol,
                              scores=dt.plain_scores(*args[:6], 0, n))
        assert torch.isinf(kv[1]).all() and (ki[1] == tile).all()
        if first is None:
            first = (kv, ki)
        assert torch.equal(kv, first[0]) and torch.equal(ki, first[1]), sms


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(DEEP_MODES))
def test_deep_list_begins_with_the_sorted_list(card, mode):
    """A query's kt-129 list (the deep selection) begins with its kt-128
    list (the sorted lists) bit for bit, values and ids: the same products
    and epilogue, selected under the same order; and the kt-2048 list
    (the whole tile) with its kt-256 one."""
    m = DEEP_MODES[mode]
    n, d, b, tile = 16384, 256, 64, 2048
    q, qs, values, scales, mask = _deep_operands(card, m, b, n, d, seed=77)
    rows = (q, qs, values, scales, None, mask, n, tile)
    v128, i128 = dt.tile_topk(*rows, 128)
    v129, i129 = dt.tile_topk(*rows, 129)
    assert torch.equal(v129[..., :128], v128) and torch.equal(i129[..., :128], i128)
    v256, i256 = dt.tile_topk(*rows, 256)
    v2048, i2048 = dt.tile_topk(*rows, 2048)
    assert torch.equal(v2048[..., :256], v256) and torch.equal(i2048[..., :256], i256)
    assert torch.equal(v256[..., :129], v129) and torch.equal(i256[..., :129], i129)


@pytest.mark.cuda
@pytest.mark.parametrize("kt", [129, 2048, 5000])
@pytest.mark.parametrize("mode", list(DEEP_MODES))
def test_deep_selection_is_batch_invariant(card, mode, kt):
    """A query's deep lists are the same bits alone (B = 1) and at row 37
    of batches of 64 and 130, whatever the query block and split each
    batch takes; kt 5,000 (past the tile: search_dense at k 5,000 over
    2,048-row tiles) pads each list past the tile's rows with (-inf, its
    first row)."""
    m = DEEP_MODES[mode]
    n, d, tile = 16384, 256, 2048
    q, qs, values, scales, mask = _deep_operands(card, m, 130, n, d, seed=kt)
    rows = (values, scales, None, mask, n, tile, kt)
    full = dt.tile_topk(q, qs, *rows)
    mid = dt.tile_topk(q[:64], None if qs is None else qs[:64], *rows)
    one = dt.tile_topk(q[37:38], None if qs is None else qs[37:38], *rows)
    for got in (full, mid):
        assert torch.equal(got[0][:, 37:38], one[0])
        assert torch.equal(got[1][:, 37:38], one[1])
    if kt > tile:
        assert torch.isinf(full[0][:, :, tile:]).all()
        assert (full[1][:, :, tile:] == torch.arange(0, n, tile, device=card)[:, None, None]).all()


def _ivf_to(ivf, device):
    """A copy of an IVFIndex with every tensor on ``device``."""
    def mv(t):
        return None if t is None else t.to(device)

    of = ivf.overflow
    return dataclasses.replace(
        ivf, centroids=mv(ivf.centroids), values=mv(ivf.values),
        scales=mv(ivf.scales), row_ids=mv(ivf.row_ids),
        overflow=None if of is None else of._replace(
            values=mv(of.values), scales=mv(of.scales)),
        overflow_rows=mv(ivf.overflow_rows), sign_plane=mv(ivf.sign_plane),
        of_sign_plane=mv(ivf.of_sign_plane), of_assign=mv(ivf.of_assign))


@pytest.mark.cuda
@pytest.mark.parametrize("nprobe", [2, 4])  # union route; whole-index scan
def test_ivf_engine_on_card_answers_as_on_cpu(card, nprobe):
    """A small engine's IVF hybrid query: the card (the union kernel, or
    the whole-index scan) ranks as the CPU (plain versions) does; scores
    within 1e-5 (the kernels sum in another order)."""
    from super_rag_tpu_torch.ops import ivf_topk as it

    rng = np.random.default_rng(1)
    words = [f"w{i}" for i in range(400)]
    texts = [" ".join(rng.choice(words, rng.integers(4, 14))) for _ in range(3000)]
    queries = [" ".join(t.split()[:3]) for t in texts[::375]]  # 8 queries
    emb = HashEmbedder(dim=64, device="cpu").embed(texts)
    out = {}
    ivf = None
    for dev in ("cpu", "cuda"):
        eng = CollectionEngine(IndexSpec(dim=64, dtype=torch.int8,
                                         vocab_size=1 << 12, min_capacity=256),
                               device=dev)
        eng.ingest(texts, embeddings=emb)
        eng.index.compact_lexical()
        eng.index.compact_dense(nlist=32, nprobe=nprobe)
        # one snapshot for both: k-means on the card sums in another order
        ivf = eng.index._ivf if ivf is None else ivf
        eng.index._ivf = _ivf_to(ivf, dev)
        before = it.union_tc_launches.count
        res = eng.index.search_hybrid(eng._embed(queries), queries, k=10,
                                      candidates=40, use_kernel=True)
        launched = it.union_tc_launches.count - before
        out[dev] = (res.indices.cpu(), res.dense_scores.cpu(), launched)
    assert out["cuda"][2] == (1 if 8 * nprobe < 32 else 0)
    assert torch.equal(out["cpu"][0], out["cuda"][0])
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
def test_f32_encoder_and_cross_encoder_on_card_equal_their_cpu_run(card):
    """The checkpoint-shaped encoder and cross-encoder in f32 (TF32 off)
    on the card against the same modules and weights on the CPU:
    embeddings within 1e-5, scores within 1e-4 (1 + |s|)."""
    from super_rag_tpu_torch.models.cross_encoder import CrossEncoder
    from super_rag_tpu_torch.models.encoder import (
        EncoderConfig, TextEncoder, init_params)

    cfg = EncoderConfig(vocab_size=30522, hidden_dim=256, num_layers=6, num_heads=8,
                        mlp_dim=1024, max_len=128, dtype=torch.float32)
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(4, 30522, (16, 128)).astype(np.int32))
    mask = torch.arange(128)[None] < torch.from_numpy(rng.integers(1, 129, (16, 1)))
    tt = (torch.arange(128)[None] >= 20).to(torch.int32) * mask
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for cls in (TextEncoder, CrossEncoder):
            model = init_params(cls(cfg), torch.Generator().manual_seed(0)).eval()
            with torch.inference_mode():
                want = model(ids, mask, tt)
                got = model.to(card)(ids.to(card), mask.to(card), tt.to(card)).cpu()
            tol = 1e-5 if cls is TextEncoder else 1e-4 * (1 + want.abs())
            assert ((got - want).abs() <= tol).all()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _csr_corpus(rows=20000, slots=24, vocab=1 << 12, seed=5):
    """Zipfian doc-term table (duplicates in a row kept, pads, a dead
    row), as the CSR tier's CPU parity tests draw it."""
    rng = np.random.default_rng(seed)
    terms = ((rng.zipf(1.3, size=(rows, slots)) - 1) % vocab).astype(np.int32)
    tfs = np.minimum(rng.zipf(2.0, size=(rows, slots)), 8).astype(np.float32)
    pad = rng.random((rows, slots)) < 0.2
    terms[pad], tfs[pad] = vocab, 0.0
    terms[3], tfs[3] = vocab, 0.0
    doc_len = (tfs.sum(1) * 2.0 + 1.0).astype(np.float32)
    return terms, tfs, doc_len, vocab


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 16])
def test_csr_build_on_card_equals_the_cpu_build(card, shards):
    """build_inverted_csr on the card: docs, bf16 impact bits and offsets
    equal the CPU build bit for bit (the CPU build equals the JAX
    package's, tests/test_torch_csr.py)."""
    from super_rag_tpu_torch.ops.bm25_inverted import build_inverted_csr

    terms, tfs, dl, vocab = _csr_corpus()
    args = [torch.from_numpy(a) for a in (terms, tfs, dl)]
    cpu = build_inverted_csr(*args, vocab, shards=shards)
    gpu = build_inverted_csr(*[a.to(card) for a in args], vocab, shards=shards)
    assert gpu.postings_docs.device.type == "cuda"
    assert torch.equal(gpu.postings_docs.cpu(), cpu.postings_docs)
    assert torch.equal(gpu.postings_impact.cpu().view(torch.int16),
                       cpu.postings_impact.view(torch.int16))
    assert torch.equal(gpu.offsets.cpu(), cpu.offsets)


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 16])
@pytest.mark.parametrize("budget", [dict(postings_per_query_term=64),
                                    dict(postings_per_query_term=64, deep_terms=3,
                                         deep_postings=2048)])
def test_csr_search_on_card_equals_cpu(card, shards, budget):
    """The CSR search on the card: the CPU's ids up to near-ties, scores
    within 1e-6 (f64 run sums rounded once on either device)."""
    from super_rag_tpu_torch.ops.bm25_inverted import (
        build_inverted_csr, inverted_bm25_search)

    terms, tfs, dl, vocab = _csr_corpus()
    index = build_inverted_csr(*[torch.from_numpy(a) for a in (terms, tfs, dl)],
                               vocab, shards=shards)
    rng = np.random.default_rng(6)
    qt = np.full((16, 8), vocab, np.int32)
    for i, r in enumerate(rng.integers(0, len(terms), 16)):
        u = [x for x in dict.fromkeys(terms[r].tolist()) if x != vocab][:8]
        qt[i, :len(u)] = u
    qi = np.where(qt < vocab, rng.random(qt.shape) + 0.5, 0.0).astype(np.float32)
    mask = torch.from_numpy(rng.random(len(terms)) < 0.8)
    q = (torch.from_numpy(qt), torch.from_numpy(qi))
    cv, ci = inverted_bm25_search(*q, index, k=50, mask=mask, **budget)
    on_card = type(index)(*(a.to(card) for a in index[:3]), index.num_docs)
    gv, gi = inverted_bm25_search(*(a.to(card) for a in q), on_card, k=50,
                                  mask=mask.to(card), **budget)
    full = inverted_bm25_search(*q, index, k=len(terms), mask=mask, **budget)
    assert_topk_match(cv, ci, gv.cpu(), gi.cpu(), rtol=1e-6, atol=1e-6,
                      scores=all_scores(*full, len(terms)))
