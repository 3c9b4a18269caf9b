"""The fused dense top-k of the PyTorch port against the TPU kernel.

On the CPU the wrapper runs its plain PyTorch version, held here against
``pallas_dense_topk(interpret=True)`` (as tests/test_pallas_topk.py runs
it) over every mode, with and without the per-tile cap and a mask, at a
ragged N.  The CUDA kernel itself is held against the plain version by
tests/test_torch_cuda.py (skips without a card) and by chip_smoke.py.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import super_rag_tpu.ops.pallas_ivf as jpivf
from super_rag_tpu.ops import dense as jdense
from super_rag_tpu.ops.pallas_topk import pallas_dense_topk
from super_rag_tpu_torch.ops import dense_topk as dt
from super_rag_tpu_torch.ops.dense import DenseCorpus, build_corpus
from torch_parity import assert_topk_match, n, t

# (JAX storage dtype, torch storage dtype, int8_queries)
MODES = {
    "int8xint8": (jnp.int8, torch.int8, True),
    "int8+bf16q": (jnp.int8, torch.int8, False),
    "bf16": (jnp.bfloat16, torch.bfloat16, False),
    "f32": (jnp.float32, torch.float32, False),
}
B, N, D, TILE, K = 8, 1000, 64, 256, 10  # N ragged: 4 tiles, 24 padding rows


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("per_tile_k", [None, 2])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("metric", ["cosine", "ip", "l2"])
def test_plain_version_matches_pallas_interpret(metric, mode, per_tile_k, masked):
    """Scores within 1e-5 abs/rel, ids equal up to near-ties.  In the
    int8 x int8 mode the scores are the same f32 operations on exact
    integer sums, so they agree to the last bit of the query norm."""
    jdtype, tdtype, i8q = MODES[mode]
    rng = np.random.default_rng(11)
    x = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((B, D)).astype(np.float32)
    mask = rng.random(N) < 0.6 if masked else None
    jc = jdense.build_corpus(jnp.asarray(x), metric=metric, dtype=jdtype)
    tc = DenseCorpus(
        values=t(np.asarray(jc.values.astype(jnp.float32))).to(tdtype),
        scales=None if jc.scales is None else t(np.asarray(jc.scales)),
        norms_sq=None if jc.norms_sq is None else t(np.asarray(jc.norms_sq)),
    )
    jv, ji = pallas_dense_topk(
        jnp.asarray(q), jc, k=K, metric=metric,
        mask=None if mask is None else jnp.asarray(mask), tile=TILE,
        interpret=True, int8_queries=i8q, per_tile_k=per_tile_k)
    before = (dt.tc_launches.count, dt.list_launches.count)
    tv, ti = dt.dense_topk(t(q), tc, k=K, metric=metric,
                           mask=None if mask is None else t(mask), tile=TILE,
                           int8_queries=i8q, per_tile_k=per_tile_k, device="cpu")
    # the CPU runs the plain version
    assert (dt.tc_launches.count, dt.list_launches.count) == before
    assert ti.dtype == torch.int32
    assert_topk_match(jv, ji, tv, ti)
    if masked:
        got = n(ti)[np.isfinite(n(tv))]
        assert mask[got].all()


def test_tile_semantics_all_masked_tile_and_padding():
    """A tile with fewer finite scores than kt yields (-inf, first column)
    after its finite winners, as kt rounds of max/argmax/suppress do."""
    rng = np.random.default_rng(12)
    x = t(rng.standard_normal((300, 16)).astype(np.float32))
    corpus = build_corpus(x, dtype=torch.float32)
    mask = torch.zeros(300, dtype=torch.bool)
    mask[130] = True  # tile 1 (rows 128..255) keeps one row
    q = t(rng.standard_normal((2, 16)).astype(np.float32))
    v, i = dt.tile_topk_plain(q, None, corpus.values, None, None, mask, 300,
                              128, 3)
    assert v.shape == (3, 2, 3)
    assert torch.isinf(v[0]).all() and (i[0] == 0).all()
    assert torch.isfinite(v[1, :, 0]).all() and (i[1, :, 0] == 130).all()
    assert torch.isinf(v[1, :, 1:]).all() and (i[1, :, 1:] == 128).all()
    assert (i[2] == 256).all()  # the ragged last tile (rows 256..299)


@pytest.mark.parametrize("kt,tile", [(2, 256), (10, 128)])
def test_plain_version_chunking_is_invisible(kt, tile, monkeypatch):
    """Chunking whole tiles bounds memory and changes no bit."""
    rng = np.random.default_rng(13)
    corpus = build_corpus(t(rng.standard_normal((2000, 32)).astype(np.float32)),
                          dtype=torch.int8)
    q, qs, _, _ = dt.prepare(t(rng.standard_normal((5, 32)).astype(np.float32)),
                             corpus, 10, int8_queries=True, tile=tile)
    args = (q, qs, corpus.values, corpus.scales, None, None, 2000, tile, kt)
    whole = dt.tile_topk_plain(*args)
    monkeypatch.setattr(dt, "PLAIN_CHUNK_ROWS", tile)
    chunked = dt.tile_topk_plain(*args)
    assert torch.equal(whole[0], chunked[0]) and torch.equal(whole[1], chunked[1])


@pytest.mark.parametrize("live", [0, 1, 300, 512, 1000])
@pytest.mark.parametrize("per_tile_k", [None, 2])
def test_live_rows_scan_changes_no_bit(live, per_tile_k):
    """A corpus whose rows past ``live_rows`` are padding answers bit for
    bit as the whole corpus with those rows masked, -inf slots' ids too:
    the tiles the scan skips are filled as all -inf tiles extract."""
    rng = np.random.default_rng(14)
    corpus = build_corpus(t(rng.standard_normal((N, D)).astype(np.float32)),
                          dtype=torch.int8)
    q = t(rng.standard_normal((B, D)).astype(np.float32))
    keep = t(rng.random(N) < 0.8) & (torch.arange(N) < live)
    whole = dt.dense_topk(q, corpus, k=K, mask=keep, tile=TILE,
                          int8_queries=True, per_tile_k=per_tile_k,
                          device="cpu")
    cut = dt.dense_topk(q, corpus._replace(live_rows=live), k=K, mask=keep,
                        tile=TILE, int8_queries=True, per_tile_k=per_tile_k,
                        device="cpu")
    assert torch.equal(whole[0], cut[0]) and torch.equal(whole[1], cut[1])


@pytest.mark.parametrize("mode,kt,d,b,tiles,want", [
    # 1M rows, the flat search_hybrid and the encoder's B = 32: a full grid
    (dt.MODE_INT8, 2, 768, 512, 489, "tc"), (dt.MODE_INT8, 1, 256, 32, 489, "tc"),
    (dt.MODE_INT8, 8, 1024, 64, 132, "tc"), (dt.MODE_INT8, 8, 1024, 64, 131, "tcs"),
    # 16,384 rows served at B = 64: 8 tiles, so the rows split
    (dt.MODE_INT8, 5, 256, 64, 8, "tcs"), (dt.MODE_INT8, 32, 256, 64, 8, "tcs"),
    (dt.MODE_BF16, 5, 256, 64, 8, "tcs"), (dt.MODE_BF16, 32, 256, 1, 8, "tcs"),
    (dt.MODE_BF16, 1, 768, 1, 1, "tcs"),
    # deep lists on a full grid; calibration's uncapped gold (kt 100)
    (dt.MODE_INT8, 9, 768, 512, 489, "tcs"), (dt.MODE_INT8, 128, 768, 512, 489, "tcs"),
    (dt.MODE_INT8_BF16, 100, 768, 32, 489, "tcs"), (dt.MODE_INT8_BF16, 2, 768, 32, 489, "tcs"),
    # above the sorted lists (the deep selection), and f32 (three TF32
    # products on the tensor cores)
    (dt.MODE_INT8, 129, 768, 1, 1, "tcs"), (dt.MODE_INT8_BF16, 129, 256, 32, 8, "tcs"),
    (dt.MODE_BF16, 129, 256, 64, 8, "tcs"), (dt.MODE_F32, 2, 96, 20, 3, "tcs"),
    (dt.MODE_F32, 1, 768, 512, 489, "tcs"), (dt.MODE_F32, 8, 768, 512, 489, "tcs"),
    (dt.MODE_F32, 9, 256, 64, 8, "tcs"), (dt.MODE_F32, 128, 256, 1, 8, "tcs"),
    (dt.MODE_F32, 129, 256, 64, 8, "tcs"), (dt.MODE_F32, 2048, 256, 64, 8, "tcs"),
    (dt.MODE_INT8, 200, 768, 512, 489, "tcs"),
    # above D = 1,024: both tensor-core kernels stream their queries at
    # every D
    (dt.MODE_INT8, 2, 1040, 512, 489, "tc"), (dt.MODE_BF16, 5, 1040, 64, 8, "tcs"),
    # the served remote-embedding collection (1,536 wide, 8,224 rows)
    (dt.MODE_BF16, 5, 1536, 1, 5, "tcs"), (dt.MODE_BF16, 32, 1536, 1, 5, "tcs"),
    (dt.MODE_INT8, 2, 1536, 512, 489, "tc"),
    (dt.MODE_INT8_BF16, 5, 3072, 1, 5, "tcs"), (dt.MODE_INT8_BF16, 5, 4096, 1, 5, "tcs"),
    (dt.MODE_BF16, 129, 1536, 1, 5, "tcs"), (dt.MODE_F32, 5, 1536, 1, 5, "tcs")])
def test_kernel_variant_by_shape(mode, kt, d, b, tiles, want):
    """The int8 register-list kernel takes int8 x int8 at kt <= 8, at any
    D, where its work items (a tile against 128 queries) fill the card's
    132 SMs; the sorted-selection tensor-core kernel every other call, at
    every kt (f32 too), whatever D."""
    assert dt.kernel_variant(mode, kt, d, b, tiles) == want


@pytest.mark.parametrize("mode", [dt.MODE_INT8, dt.MODE_INT8_BF16, dt.MODE_BF16, dt.MODE_F32])
def test_kernel_variant_is_a_tensor_core_kernel_at_every_kt(mode):
    """No call leaves the tensor cores: at every kt from 1 to 2,048, every
    batch and grid, the variant is the register-list kernel ("tc", int8 x
    int8 at kt <= 8 on a full grid) or the sorted-selection one ("tcs")."""
    for kt in range(1, 2049):
        for b, tiles in ((1, 1), (64, 8), (512, 489)):
            got = dt.kernel_variant(mode, kt, 768, b, tiles)
            assert got == ("tc" if mode == dt.MODE_INT8 and kt <= dt.LIST_MAX_KT
                           and dt.list_work_items(b, tiles) >= dt.H100_SMS
                           else "tcs"), (kt, b, tiles)


@pytest.mark.parametrize("b,tiles,items,grid", [
    (512, 489, 4 * 489, 132), (32, 489, 489, 132), (128, 132, 132, 132),
    (129, 66, 132, 132), (1, 5, 5, 5), (130, 3, 6, 6), (512, 245, 4 * 245, 132)])
def test_list_work_items_and_grid(b, tiles, items, grid):
    """The register-list kernel's work items are every tile against every
    block of 128 queries; its persistent grid is a block an SM, or one a
    work item where there are fewer."""
    assert dt.list_work_items(b, tiles) == items
    assert dt.list_grid(b, tiles) == grid
    assert dt.list_grid(b, tiles, sms=1000) == min(items, 1000)


@pytest.mark.parametrize("b,tiles,sms,want", [
    (64, 132, 132, "tc"), (64, 131, 132, "tcs"), (128, 132, 132, "tc"), (129, 66, 132, "tc"),
    (129, 65, 132, "tcs"), (256, 66, 132, "tc"), (512, 33, 132, "tc"), (512, 32, 132, "tcs"),
    (32, 489, 1000, "tcs"), (512, 489, 1000, "tc")])
def test_list_kernel_fills_the_card(b, tiles, sms, want):
    """The rule for filling the card: the register lists where their work
    items give every SM one (at any D), the sorted selection, whose tiles
    split over clusters, where they do not."""
    for d in (16, 768, 1536, 4096):
        assert dt.kernel_variant(dt.MODE_INT8, 2, d, b, tiles, sms) == want
        assert dt.kernel_variant(dt.MODE_INT8, 8, d, b, tiles, sms) == want
        assert dt.kernel_variant(dt.MODE_INT8, 9, d, b, tiles, sms) == "tcs"
        assert dt.kernel_variant(dt.MODE_INT8_BF16, 2, d, b, tiles, sms) == "tcs"


def test_list_shared_memory_budget():
    """The ring: 6 stages of one 128-byte k-slice of 128 query rows and
    128 corpus rows (32 KB), a warpgroup's 64-row A operand of zeros (8
    KB), 3 slots of a chunk's row data (two boxes of 128 mask bytes,
    scales and norms: 2,304 bytes) and of its folded form (128 scales and
    norms: 1,024 bytes), 1,024 bytes of slack for the swizzle's alignment
    and 21 barriers: inside an H100 block's 232,448 bytes."""
    assert dt.LIST_KS * (dt.LIST_QB + dt.LIST_RC) == 32 * 1024
    assert dt.list_smem_bytes() == (1024 + 6 * 32 * 1024 + 8 * 1024 + 3 * (2304 + 1024)
                                    + 21 * 8)
    assert dt.list_smem_bytes() == 215_976
    assert dt.list_smem_bytes() <= dt.SMEM_MAX == 232_448


@pytest.mark.parametrize("b,n,d", [(512, 1_000_000, 768), (1, 5000, 16), (17, 4100, 1040),
                                   (130, 10_002_432, 4096)])
def test_list_tensor_map_geometry(b, n, d):
    """The maps: the [b, d] queries in boxes of 128 bytes x 128 rows, the
    scanned [n, d] rows in boxes of 128 bytes x 256 rows (a stage's
    expected bytes are the two boxes whatever the ragged ends: TMA fills
    past d and past the last row with zeros), and the row scales, norms
    and mask that are present, a chunk's 256 rows a box."""
    geo = dt.list_tensor_maps(b, n, d, scales=True, norms=False, mask=True)
    assert list(geo) == ["queries", "corpus", "scales", "mask"]
    assert geo["queries"] == {"rows": b, "d": d, "elem_bytes": 1, "box_rows": dt.LIST_QB}
    assert geo["corpus"] == {"rows": n, "d": d, "elem_bytes": 1, "box_rows": dt.LIST_RC}
    assert geo["scales"] == {"rows": n, "d": 0, "elem_bytes": 4, "box_rows": dt.LIST_RC}
    assert geo["mask"] == {"rows": n, "d": 0, "elem_bytes": 1, "box_rows": dt.LIST_RC}
    stage = sum(geo[k]["box_rows"] * dt.LIST_KS for k in ("queries", "corpus"))
    assert stage == dt.LIST_KS * (dt.LIST_QB + dt.LIST_RC)
    # a chunk's row data fits its slot (a mask byte, a scale, a norm a row),
    # each box a multiple of 16 bytes
    full = dt.list_tensor_maps(b, n, d, scales=True, norms=True, mask=True)
    rows = [full[k] for k in ("scales", "norms", "mask")]
    assert sum(g["box_rows"] * g["elem_bytes"] for g in rows) == dt.LIST_RC * 9
    assert all(g["box_rows"] * g["elem_bytes"] % 16 == 0 for g in rows)
    assert list(dt.list_tensor_maps(b, n, d, scales=False)) == ["queries", "corpus"]
    # the kernel's k-slices: ceil(d / 128) a chunk, the last zero-padded
    assert -(-d // dt.LIST_KS) * dt.LIST_KS >= d > (-(-d // dt.LIST_KS) - 1) * dt.LIST_KS
    assert d % 16 == 0 and d <= dt.LIST_MAX_D


@pytest.mark.parametrize("variant,mode,moved", [
    ("tc", dt.MODE_INT8, (1, 1, 1)), ("tcs", dt.MODE_INT8, (1, 0, 1)),
    ("tcs", dt.MODE_BF16, (1, 0, 1)), ("tcs", dt.MODE_F32, (1, 0, 1)),
    ("tcs", dt.MODE_INT8_BF16, (1, 0, 1))])
def test_count_launch_moves_the_variants_counters(variant, mode, moved):
    """``tc_launches`` counts both tensor-core kernels, ``list_launches``
    the register-list kernel alone, ``tc_mode_launches`` by mode."""
    def snap():
        per = dt.tc_mode_launches.get(mode)
        return (dt.tc_launches.count, dt.list_launches.count,
                per.count if per is not None else 0)
    before = snap()
    dt.count_launch(variant, mode)
    assert tuple(a - b for a, b in zip(snap(), before)) == moved


@pytest.mark.parametrize("d", [16, 768, 1024, 1040, 1536, 4096])
def test_tcs_shared_memory_budget_at_every_d(d):
    """One form at every D: the sorted-selection kernel's shared memory (the
    ring of k-slices, the widened codes, the scores, the sorted lists, the
    selecting warps' scratch, the barriers) does not depend on D, since its
    queries stream through the ring like the rows.  At kp 8 and 128, in
    every mode and at every batch, the geometry it takes fits an H100
    block's 232,448 bytes with 2 to 4 ring stages, the cluster merge's
    copies fit over the ring, and the block's queries shrink as kp grows:
    128 at kp 8, 64 at kp 128 for B = 512."""
    for mode in (dt.MODE_INT8, dt.MODE_INT8_BF16, dt.MODE_BF16):
        for kt in (8, 128):  # kp 8 and 128
            for b in (1, 16, 17, 64, 65, 512):
                qn, nst = dt.tcs_geometry(mode, b, kt)
                assert qn in dt.TCS_QN and 2 <= nst <= dt.TCS_MAX_STAGES
                assert qn >= min(b, 16) and (qn >= b or qn < 128 or b > 128)
                assert dt.tcs_smem_bytes(mode, qn, kt, nst) <= dt.SMEM_MAX == 232_448
                assert dt.tcs_merge_fits(mode, qn, kt, nst)
                # the next stage (if any) does not fit: as many as fit
                assert nst == dt.TCS_MAX_STAGES or \
                    dt.tcs_smem_bytes(mode, qn, kt, nst + 1) > dt.SMEM_MAX
                # a stage's expected bytes are its boxes, whatever d
                geo = dt.tcs_tensor_maps(mode, b, 1000, d, qn)
                boxes = {k: dt.TCS_KS * g["box_rows"] for k, g in geo.items()}
                q_boxes = 2 if mode == dt.MODE_INT8_BF16 else 1
                assert boxes["corpus"] + q_boxes * boxes["queries"] == \
                    dt.tcs_stage_bytes(mode, qn)
                assert geo["queries"]["d"] == geo["corpus"]["d"] == d
        assert dt.tcs_geometry(mode, 512, 128)[0] == 64
    assert dt.tcs_geometry(dt.MODE_BF16, 512, 8) == (128, 4)
    assert dt.tcs_geometry(dt.MODE_INT8, 512, 32) == (128, 3)
    assert dt.tcs_geometry(dt.MODE_BF16, 1, 32) == (16, 4)
    assert d % 16 == 0 and d <= dt.TCS_MAX_D


@pytest.mark.parametrize("d", [1536, 3072])
def test_int8_plain_version_is_exact_above_2_to_the_24(d):
    """int8 x int8 at D = 1,536 and 3,072, whose sums an f32 product may
    round: rows of +-127 codes with a quarter of other codes, queries
    copies of rows, so the self-match sums exceed 2^24 and some are odd
    (no f32 holds them).  The plain version's scores are the exact sums
    rounded once to f32, then scaled, for the batch and for each query
    alone; on the CPU the port's dense_topk equals
    pallas_dense_topk(interpret=True), whose int32 sums are exact, bit for
    bit: values and ids."""
    rng = np.random.default_rng(16)
    rows, b, tile, k = 300, 6, 128, 8
    x = rng.choice([-1.0, 1.0], size=(rows, d)).astype(np.float32)
    odd = rng.random((rows, d)) < 0.25
    x[odd] *= rng.choice(np.arange(1, 127), size=int(odd.sum())) / 127.0
    q = x[rng.choice(rows, size=b, replace=False)].copy()
    jc = jdense.build_corpus(jnp.asarray(x), metric="ip", dtype=jnp.int8)
    codes = np.asarray(jc.values).astype(np.int64)
    tc = DenseCorpus(values=t(codes.astype(np.int8)),
                     scales=t(np.asarray(jc.scales)), norms_sq=None)
    qq, qs, _, _ = dt.prepare(t(q), tc, k, "ip", tile, int8_queries=True)
    exact = n(qq).astype(np.int64) @ codes.T
    self_sums = exact.max(1)
    assert (self_sums > 2 ** 24).all() and (self_sums % 2 == 1).any()
    want = t(exact.astype(np.float32)) * qs[:, None]
    assert torch.equal(dt.plain_scores(qq, qs, tc.values, None, None, None, 0, rows), want)
    for i in range(b):
        got = dt.plain_scores(qq[i:i + 1], qs[i:i + 1], tc.values, None, None, None, 0, rows)
        assert torch.equal(got, want[i:i + 1])
    for per_tile_k in (None, 2):
        jv, ji = pallas_dense_topk(jnp.asarray(q), jc, k=k, metric="ip", tile=tile,
                                   interpret=True, int8_queries=True,
                                   per_tile_k=per_tile_k)
        tv, ti = dt.dense_topk(t(q), tc, k=k, metric="ip", tile=tile,
                               int8_queries=True, per_tile_k=per_tile_k,
                               device="cpu")
        assert np.array_equal(np.asarray(jv), n(tv))
        assert np.array_equal(np.asarray(ji), n(ti))


@pytest.mark.parametrize("b,tiles,tile,want", [
    (64, 8, 2048, (8, 256)), (1, 8, 2048, (8, 256)), (32, 8, 2048, (8, 256)),
    (32, 489, 2048, (1, 2048)), (512, 489, 2048, (1, 2048)),
    (64, 100, 2048, (2, 1024)), (32, 40, 2048, (4, 512)), (32, 30, 2048, (6, 384)),
    (32, 20, 2048, (8, 256)), (1, 1, 200, (2, 128)), (1, 5, 1000, (8, 128)),
    (7, 2, 600, (5, 128))])
def test_tcs_split_fills_the_card(b, tiles, tile, want):
    """Each tile's rows split into whole 128-row chunks over at most 8
    blocks, at least as many as it takes to give the 132 SMs a block
    each, where a block takes the batch's query block (16 queries at B <=
    16, 64 at B <= 64, 128 above)."""
    qn, _ = dt.tcs_geometry(dt.MODE_BF16, b, 5)
    assert qn == (16 if b <= 16 else 64 if b <= 64 else 128)
    slices, rows = dt.tcs_split(b, tiles, tile, qn)
    assert (slices, rows) == want
    assert rows % dt.TCS_RC == 0 and slices * rows >= tile > (slices - 1) * rows


def _value_keys(v):
    """The kernel's value_key: f32 scores as uint32 keys in the reference's
    order (-0 as +0), 0 for -inf and NaN (a dead row)."""
    v = np.ascontiguousarray(v, np.float32)
    u = v.view(np.uint32).copy()
    u[(u & np.uint32(0x7FFFFFFF)) == 0] = 0
    k = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000)).astype(np.uint32)
    k[~(v > -np.inf)] = 0
    return k


def _sort_keys_model(keys):
    """The deep selection's bitonic network (csrc/dense_topk.cu sort_keys)
    on uint64 keys, m a power of two >= 256: each 256-key block through
    levels 2 .. 256 as a warp's registers hold it (element base + 32 j +
    lane), then each level above: its stages of d >= 256 across the
    buffer, its stages of d < 256 block by block.  A stage pairs (i, i ^
    d); the lower keeps the larger key where i & kk == 0."""
    k = np.array(keys, dtype=np.uint64)
    m = len(k)
    idx = np.arange(m)

    def stage(kk, d, lo_blocks):
        lo = idx[(idx & d) == 0]
        lo = lo[np.isin(lo // 256, lo_blocks)] if lo_blocks is not None else lo
        a, b = k[lo].copy(), k[lo + d].copy()
        desc = (lo & kk) == 0
        swap = np.where(desc, a < b, a > b)
        k[lo[swap]], k[lo[swap] + d] = b[swap], a[swap]

    for base in range(0, m, 256):
        for kk in (2, 4, 8, 16, 32, 64, 128, 256):
            d = kk // 2
            while d > 0:
                stage(kk, d, [base // 256])
                d //= 2
    kk = 512
    while kk <= m:
        d = kk // 2
        while d >= 256:
            stage(kk, d, None)
            d //= 2
        for base in range(0, m, 256):
            d = 128
            while d > 0:
                stage(kk, d, [base // 256])
                d //= 2
        kk *= 2
    return k


def _deep_select_model(row, kt):
    """The deep selection (csrc/dense_topk.cu select_deep), step by step, on
    one query's row of a tile's scores (NaN or -inf dead): a radix select
    of the kt-th value key from the top, 8 bits a pass, each pass's 256
    bins held 8 a lane by 32 lanes (the lane whose bins hold the need-th
    key from the top, then its bin); then the keys above that value and
    the first ``need`` equal to it in column order; then sorted, value
    descending, lowest column first; (-inf, column 0) past the live keys.
    At most kt live keys: all of them, no radix pass."""
    vk = _value_keys(row)
    prefix, need = 0, kt
    take_all = int((vk != 0).sum()) <= kt
    for p in range(0 if take_all else 4):
        shift = 24 - 8 * p
        hmask = 0 if p == 0 else (0xFFFFFFFF << (shift + 8)) & 0xFFFFFFFF
        live = (vk != 0) & ((vk & np.uint32(hmask)) == prefix)
        hist = np.bincount(((vk[live] >> np.uint32(shift)) & 255).astype(np.int64),
                           minlength=256)
        lane_sum = hist.reshape(32, 8).sum(1)
        incl = np.cumsum(lane_sum[::-1])[::-1]  # keys in bins 8 lane and up
        above = incl - lane_sum
        src = int(np.flatnonzero((above < need) & (need <= incl))[0])
        acc = above[src]
        for j in range(7, -1, -1):
            if acc + hist[8 * src + j] >= need:
                dg, need = 8 * src + j, need - acc
                break
            acc += hist[8 * src + j]
        prefix |= dg << shift
    cols = np.arange(len(row), dtype=np.uint64)
    if take_all:
        keep = vk != 0
    else:
        eq = vk == prefix
        keep = (vk > prefix) | (eq & (np.cumsum(eq) - 1 < need))
    keys = (vk[keep].astype(np.uint64) << np.uint64(32)) | (~cols[keep] & np.uint64(0xFFFFFFFF))
    assert len(keys) == min(kt, int((vk != 0).sum()))
    m = 256
    while m < len(keys):
        m *= 2
    keys = _sort_keys_model(np.concatenate([keys, np.zeros(m - len(keys), np.uint64)]))
    assert (keys[:-1] >= keys[1:]).all()
    keys = keys[:int(keep.sum())]
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    bits = np.where(hi & np.uint32(0x80000000), hi & np.uint32(0x7FFFFFFF), ~hi)
    vals = np.full(kt, -np.inf, np.float32)
    ids = np.zeros(kt, np.int32)
    vals[:len(keys)] = bits.astype(np.uint32).view(np.float32)
    ids[:len(keys)] = (~keys & np.uint64(0xFFFFFFFF)).astype(np.int64)
    return vals, ids


def _kernel_selection_model(scores, kt, slices, rows, parts):
    """The "tcs" kernel's selection rules, written out, per slice of
    ``rows`` columns in chunks of 128.  Deeper than the sorted lists (kt >
    128): the slices' scores gathered in tile order, whatever the split,
    and ``_deep_select_model``.  kt <= 8: ``parts`` threads a query,
    each taking every parts-th group of four columns of every chunk in
    increasing order, skipping a group none of whose scores beats its
    list's kt-th value, and keeping its L best (2 at kt <= 2, else 8) in a
    list a score enters only by beating an entry strictly by value; the
    parts' lists ranked together.  Deeper lists: a chunk's scores survive only by beating the
    slice's list's kt-th value strictly (while the list holds fewer than
    kt, any but -inf), and the survivors merge into the sorted list, which
    keeps its kt best.  Then the slices' lists merge in slice order.  Keys
    order value descending, lowest column first; -inf is no key; missing
    slots are (-inf, column 0)."""
    b, tile = scores.shape
    out_v = torch.empty((b, kt))
    out_i = torch.empty((b, kt), dtype=torch.int32)
    if kt > dt.TC_MAX_KT:
        for qi in range(b):
            v, i = _deep_select_model(n(scores[qi]), kt)
            out_v[qi], out_i[qi] = t(v), t(i)
        return out_v, out_i
    for qi in range(b):
        lists = []
        for s in range(slices):
            chunks = [(c0, min(tile, (s + 1) * rows, c0 + dt.TCS_RC))
                      for c0 in range(s * rows, min(tile, (s + 1) * rows), dt.TCS_RC)]
            if kt <= 8:
                size = 2 if kt <= 2 else 8
                keys = []
                for part in range(parts):
                    best = []  # (-value, column), sorted, at most size
                    for c0, c1 in chunks:
                        for g0 in range(c0 + 4 * part, c1, 4 * parts):
                            group = [(float(scores[qi, c]), c) for c in range(g0, min(g0 + 4, c1))]
                            thr = -best[kt - 1][0] if len(best) >= kt else float("-inf")
                            if max(v for v, _ in group) <= thr:
                                continue  # the group could only take places past kt
                            for v, c in group:
                                if (len(best) < size and v > float("-inf")
                                        or len(best) == size and v > -best[-1][0]):
                                    best = sorted(best + [(-v, c)])[:size]
                    keys += best
                lists.append(sorted(keys)[:kt])
                continue
            best = []
            for c0, c1 in chunks:
                thr = -best[kt - 1][0] if len(best) >= kt else float("-inf")
                best = sorted(best + [(-float(scores[qi, c]), c) for c in range(c0, c1)
                                      if float(scores[qi, c]) > thr])[:kt]
            lists.append(best)
        merged = sorted(sum(lists, []))[:kt]
        merged = ([(-v, c) for v, c in merged] + [(float("-inf"), 0)] * kt)[:kt]
        out_v[qi] = torch.tensor([v for v, _ in merged])
        out_i[qi] = torch.tensor([c for _, c in merged], dtype=torch.int32)
    return out_v, out_i


@pytest.mark.parametrize("kt", [1, 3, 8, 9, 32, 100, 128])
@pytest.mark.parametrize("b,sms", [(3, 1), (3, dt.H100_SMS)])
def test_sliced_selection_equals_the_plain_version(kt, b, sms):
    """Taking a tile's top-kt by row slices and merging the slices' lists
    in slice order under the tie rule gives tile_topk_plain's values and
    ids exactly: ties (integer scores, -0 beside +0), an all-masked slice,
    padding rows past n, tiles with fewer live rows than kt."""
    rng = np.random.default_rng(15 + kt)
    tile, n = 2048, 2 * 2048 + 700
    num_tiles = -(-n // tile)
    scores = rng.integers(-6, 7, size=(b, n)).astype(np.float32)
    scores[:, 5::97] = -0.0
    keep = rng.random(n) < 0.8
    keep[256:768] = False  # whole chunks: an all-masked slice at 4+ slices
    keep[2048 + 300:2 * 2048] = False  # tile 1 keeps 300 rows
    keep[2 * 2048 + 20:] = False  # the ragged tile keeps 20 rows
    # f32 queries = the identity, so the plain version's scores are these
    q = torch.eye(b, 16)
    values = torch.zeros((n, 16))
    values[:, :b] = t(scores.T.copy())
    pv, pi = dt.tile_topk_plain(q, None, values, None, None, t(keep), n, tile, kt)
    qn, _ = dt.tcs_geometry(dt.MODE_BF16, b, kt)
    slices, rows = dt.tcs_split(b, num_tiles, tile, qn, sms)
    assert (slices > 1) == (sms > 1)
    masked = torch.where(t(keep)[None, :], t(scores), float("-inf"))
    masked = torch.nn.functional.pad(masked, (0, num_tiles * tile - n),
                                     value=float("-inf"))
    for ti in range(num_tiles):
        mv, mi = _kernel_selection_model(masked[:, ti * tile:(ti + 1) * tile], kt,
                                         slices, rows, 256 // qn)
        assert torch.equal(mv, pv[ti]) and torch.equal(mi + ti * tile, pi[ti])


@pytest.mark.parametrize("kt", [129, 256, 320, 700])
def test_deep_selection_equals_the_plain_version_and_pallas(kt):
    """The deep selection (kt above the sorted lists' 128, up to the tile
    and past it), written out as the kernel takes it, on rows whose dead
    slots are NaN (the kernel's epilogue scales a dead row by NaN): each
    tile's list equals tile_topk_plain's values and ids exactly, and the
    tiles' lists merged as dense_topk merges them equal the JAX package's
    pallas_dense_topk (interpret=True, per_tile_k = kt) up to ties.  Ties
    (integer scores, -0 beside +0) at the kt-th value, a tile with fewer
    live rows than kt, an all-masked tile, a ragged last tile (padding)."""
    from super_rag_tpu_torch.ops.topk import stable_topk

    rng = np.random.default_rng(30 + kt)
    b, tile = 3, 320
    rows = 3 * tile + 70
    num_tiles = -(-rows // tile)
    scores = rng.integers(-6, 7, size=(b, rows)).astype(np.float32)
    scores[:, 5::31] = -0.0
    keep = rng.random(rows) < 0.8
    keep[tile:tile + 100] = True
    keep[tile + 100:2 * tile] = False  # tile 1 keeps 100 rows
    keep[2 * tile:3 * tile] = False  # tile 2 all masked
    keep[3 * tile + 20:] = False  # the ragged tile keeps 20 rows
    q = np.eye(b, 16, dtype=np.float32)
    x = np.zeros((rows, 16), np.float32)
    x[:, :b] = scores.T
    pv, pi = dt.tile_topk_plain(t(q), None, t(x), None, None, t(keep), rows, tile, kt)
    dead = np.where(keep[None, :], scores, np.nan).astype(np.float32)
    dead = np.pad(dead, ((0, 0), (0, num_tiles * tile - rows)), constant_values=np.nan)
    lists = []
    for ti in range(num_tiles):
        scanned = min(tile, rows - ti * tile)
        mv, mi = _kernel_selection_model(t(dead[:, ti * tile:ti * tile + scanned]), kt,
                                         1, tile, 16)
        assert torch.equal(mv, pv[ti]) and torch.equal(mi + ti * tile, pi[ti]), ti
        lists.append((mv, mi + ti * tile))
    assert torch.isinf(pv[2]).all() and (pi[2] == 2 * tile).all()
    k = min(kt, 200)
    cv = torch.cat([v for v, _ in lists], 1)
    ci = torch.cat([i for _, i in lists], 1)
    fv, pos = stable_topk(cv, k)
    jc = jdense.build_corpus(jnp.asarray(x), metric="ip", dtype=jnp.float32)
    jv, ji = pallas_dense_topk(jnp.asarray(q), jc, k=k, metric="ip", mask=jnp.asarray(keep),
                               tile=tile, interpret=True, per_tile_k=kt)
    assert_topk_match(jv, ji, fv, torch.gather(ci, 1, pos), rtol=0.0, atol=0.0,
                      scores=np.where(keep[None, :], scores, -np.inf).astype(np.float32))


@pytest.mark.parametrize("kt", [129, 256, 1024, 2047, 2048])
@pytest.mark.parametrize("kind", ["gaussian", "ties", "wide"])
def test_deep_select_model_at_tile_2048(kind, kt):
    """The deep selection's radix select on a 2,048-column row: each of its
    four 8-bit passes (values of every sign and many exponents: the top
    passes split on sign and exponent, the last on the low mantissa bits;
    integer ties at the kt-th value; -0 beside +0; NaN and -inf dead)
    gives the kt best under the reference's order, which an argsort of
    (value descending, column ascending) over the live columns gives."""
    rng = np.random.default_rng(40 + kt)
    row = {"gaussian": lambda: rng.standard_normal(2048),
           "ties": lambda: rng.integers(-3, 4, 2048).astype(np.float64),
           "wide": lambda: rng.standard_normal(2048) * 10.0 ** rng.integers(-30, 30, 2048)}[
        kind]().astype(np.float32)
    row[7::41] = -0.0
    row[3::53] = 0.0
    row[11::67] = np.nan
    row[13::71] = -np.inf
    vals, ids = _deep_select_model(row, kt)
    live = np.flatnonzero(row > -np.inf)
    order = live[np.lexsort((live, -row[live].astype(np.float64)))][:kt]
    assert len(order) < kt or kind != "ties" or (row[order] == row[order[-1]]).sum() > 1
    np.testing.assert_array_equal(ids[:len(order)], order)
    np.testing.assert_array_equal(vals[:len(order)], row[order])
    assert np.isneginf(vals[len(order):]).all() and (ids[len(order):] == 0).all()


class _StubMapLib:
    """The library's map and launch entry points, recording what they are
    asked for (no card needed: nothing is launched)."""

    def __init__(self):
        self.encoded = []
        self.launches = []

    def dense_topk_tc_map(self, buf, ptr, rows, d, elem_bytes, box_rows):
        self.encoded.append((ptr, rows, d, elem_bytes, box_rows))
        return 0

    def dense_topk_tcs_launch(self, *args):
        self.launches.append(("tcs",) + args)
        return 0

    def dense_topk_tc_launch(self, *args):
        self.launches.append(("tc",) + args)
        return 0


def test_tensor_maps_are_cached(monkeypatch):
    """The launches' TMA maps come from a cache keyed by (address, rows, d,
    element bytes, box rows): a second call on the same corpus encodes only
    the new queries' map, the same queries again nothing; a new corpus, a
    new shape (other scanned rows) or a new box (another query block)
    encodes anew; the register-list launch shares the cache; the cache
    keeps the last MAP_CACHE_SIZE maps."""
    monkeypatch.setattr(dt, "_maps", collections.OrderedDict())
    lib = _StubMapLib()
    values = torch.zeros((5000, 256), dtype=torch.bfloat16)

    def call(q, corpus, n=5000, kt=5, route=dt._launch_tcs, qscale=None, scales=None):
        out_v = torch.empty((-(-n // 2048), q.shape[0], kt))
        out_i = torch.empty((-(-n // 2048), q.shape[0], kt), dtype=torch.int32)
        before = len(lib.encoded)
        assert route(lib, q, qscale, corpus, scales, None, None, n, 2048, kt, out_v, out_i,
                     0, dt.H100_SMS) == 0
        return lib.encoded[before:]

    q1 = torch.zeros((64, 256), dtype=torch.bfloat16)
    first = call(q1, values)
    assert first == [(q1.data_ptr(), 64, 256, 2, 64), (values.data_ptr(), 5000, 256, 2, 128)]
    q2 = torch.ones((64, 256), dtype=torch.bfloat16)
    assert call(q2, values) == [(q2.data_ptr(), 64, 256, 2, 64)]
    assert call(q2, values) == [] and call(q1, values) == []
    other = torch.zeros((5000, 256), dtype=torch.bfloat16)
    assert call(q1, other) == [(other.data_ptr(), 5000, 256, 2, 128)]
    assert call(q1, values, n=4000) == [(values.data_ptr(), 4000, 256, 2, 128)]
    q3 = q1[:1].clone()  # one query: a block of 16, its own box
    assert call(q3, values) == [(q3.data_ptr(), 1, 256, 2, 16)]
    # every launch took its geometry: mode bf16, then the shape's twelve
    # ints (the boxes, B, N, D, tile, tiles, kt, (qn, nst), the split)
    qn, nst = dt.tcs_geometry(dt.MODE_BF16, 64, 5)
    assert lib.launches[0][1] == dt.MODE_BF16
    assert list(lib.launches[0][4]) == [qn, dt.TCS_RC, 64, 5000, 256, 2048, 3, 5, qn, nst,
                                        *dt.tcs_split(64, 3, 2048, qn)]
    assert list(lib.launches[-1][4])[2:4] == [1, 5000]  # the one query's launch
    # the register-list launch (int8) through the same cache
    codes = torch.zeros((5000, 256), dtype=torch.int8)
    scales = torch.ones(5000)
    q8 = torch.zeros((64, 256), dtype=torch.int8)
    qs = torch.ones(64)
    got = call(q8, codes, kt=2, route=dt._launch_list, qscale=qs, scales=scales)
    assert [g[3:] for g in got] == [(1, 128), (1, 128), (4, 128)]
    assert call(q8, codes, kt=2, route=dt._launch_list, qscale=qs, scales=scales) == []
    # bounded: the oldest maps go first
    keep = [torch.zeros((16 + i, 256), dtype=torch.bfloat16) for i in range(dt.MAP_CACHE_SIZE)]
    for q in keep:
        call(q, values)
    assert len(dt._maps) == dt.MAP_CACHE_SIZE
    assert call(q1, values) == [(q1.data_ptr(), 64, 256, 2, 64)]


@pytest.mark.parametrize("kt", [5, 32, 128])
@pytest.mark.parametrize("b,qn", [(1, 16), (64, 64), (512, 128)])
def test_tcs_f32_geometry_and_maps(b, qn, kt):
    """The f32 mode (3) on the sorted-selection kernel: its maps hold f32
    (4-byte elements, so a 128-byte box is 32 of them): the queries' [2b,
    d] tf32 planes (hi rows, then lo rows) and the scanned rows; a ring
    stage holds a k-slice of the 128 rows and of both query planes; the
    block takes 16, 64 or 128 queries by the batch (64 at kt 128 for B =
    512, where 128 queries' lists leave no room for 2 stages), with 2 to
    4 stages inside an H100 block's 232,448 bytes (the selecting warps'
    scratch only where kt > 8) and the cluster merge's copies over the
    ring."""
    mode = dt.MODE_F32
    geo = dt.tcs_tensor_maps(mode, b, 1_000_000, 768, qn)
    assert geo["queries"] == {"rows": 2 * b, "d": 768, "elem_bytes": 4, "box_rows": qn}
    assert geo["corpus"] == {"rows": 1_000_000, "d": 768, "elem_bytes": 4,
                             "box_rows": dt.TCS_RC}
    assert dt.TCS_KS // geo["corpus"]["elem_bytes"] == 32
    assert dt.tcs_stage_bytes(mode, qn) == dt.TCS_KS * (dt.TCS_RC + 2 * qn)
    got_qn, nst = dt.tcs_geometry(mode, b, kt)
    assert got_qn == (64 if (b, kt) == (512, 128) else qn)
    assert 2 <= nst <= dt.TCS_MAX_STAGES
    assert dt.tcs_smem_bytes(mode, got_qn, kt, nst) <= dt.SMEM_MAX
    assert nst == dt.TCS_MAX_STAGES or \
        dt.tcs_smem_bytes(mode, got_qn, kt, nst + 1) > dt.SMEM_MAX
    assert dt.tcs_merge_fits(mode, got_qn, kt, nst)
    # no widened-codes buffer: the rows' planes are made in registers
    assert dt.tcs_smem_bytes(mode, got_qn, kt, nst) == dt.tcs_smem_bytes(
        dt.MODE_BF16, got_qn, kt, 0) + nst * (dt.tcs_stage_bytes(mode, got_qn) + 16)
    # 3 stages of 128 queries where the lists are registers (kt <= 8: no
    # selection scratch), 2 where the sorted lists take their room
    assert {(512, 5): (128, 3), (512, 32): (128, 2), (64, 32): (64, 4),
            (1, 128): (16, 4)}.get((b, kt), (got_qn, nst)) == (got_qn, nst)
    scratch = dt.TCS_WORKERS * dt.TCS_RC * 8
    assert dt.tcs_smem_bytes(mode, 128, 8, 3) + scratch + 8 * 128 * 8 == \
        dt.tcs_smem_bytes(mode, 128, 9, 3)  # kp 8 -> 16, and the scratch


@pytest.mark.parametrize("kt", [129, 256, 1024, 2048])
@pytest.mark.parametrize("mode", [dt.MODE_INT8, dt.MODE_INT8_BF16, dt.MODE_BF16, dt.MODE_F32])
def test_tcs_deep_geometry_fits_at_every_d(mode, kt):
    """The deep selection (kt above the sorted lists' 128): at tile 2,048,
    every batch and tile count, D 16 to 4,096, the geometry it takes keeps
    the whole slice's scores ([qn][slice_rows + 4] f32) beside 2 to 4
    ring stages inside an H100 block's 232,448 bytes, whole 128-row chunks
    a slice, at most a portable cluster of 8 slices covering the tile, and
    room after the scan for the cluster's copies (over the ring) and at
    least one warp's sort buffer (kp keys, its radix histogram over it)."""
    tile = 2048
    for b, tiles in ((1, 1), (1, 8), (17, 3), (64, 8), (130, 3), (512, 489), (512, 8)):
        qn, nst, slices, rows = dt.tcs_deep_geometry(mode, b, tiles, tile, kt)
        assert qn == (16 if b <= 16 else 64) and qn in dt.TCS_DEEP_QN
        assert 2 <= nst <= dt.TCS_MAX_STAGES
        assert rows % dt.TCS_RC == 0 and 1 <= slices <= dt.TCS_MAX_SLICES
        assert slices * rows >= tile > (slices - 1) * rows
        used = dt.tcs_smem_bytes(mode, qn, kt, nst, rows)
        assert used <= dt.SMEM_MAX == 232_448
        assert nst == dt.TCS_MAX_STAGES or \
            dt.tcs_smem_bytes(mode, qn, kt, nst + 1, rows) > dt.SMEM_MAX
        assert dt.tcs_deep_fits(mode, qn, kt, tile, nst, slices, rows)
        # the scores of the whole slice, and no sorted lists or scratch
        wide = dt.TCS_WIDE if mode == dt.MODE_INT8_BF16 else 0
        assert used == (1024 + nst * (dt.tcs_stage_bytes(mode, qn) + 16) + wide
                        + qn * (rows + 4) * 4 + qn * 12)
        assert dt.tcs_deep_kp(kt, tile) == 1 << (kt - 1).bit_length()
        # the maps do not depend on kt: D streams through the ring
        for d in (16, 768, 1040, 4096):
            geo = dt.tcs_tensor_maps(mode, b, tiles * tile, d, qn)
            assert geo["queries"]["box_rows"] == qn and geo["corpus"]["d"] == d
    # the served shape: 64 queries a block, split 8 ways like kt <= 128
    assert dt.tcs_deep_geometry(mode, 64, 8, tile, kt)[::2] == (64, 8)
    # past the tile, the sort stops at the tile's 2,048 keys
    assert dt.tcs_deep_kp(5000, tile) == 2048


def test_f32_launch_makes_the_query_planes_first(monkeypatch):
    """An f32 call's launch: the queries' planes (one launch of
    dense_topk_tf32_planes over the B D elements into a [2B, D] array) on
    the call's stream, then the sorted-selection kernel in mode 3 with the
    query map over the planes (2B rows of f32) and the corpus map over the
    f32 rows."""
    monkeypatch.setattr(dt, "_maps", collections.OrderedDict())
    lib = _StubMapLib()
    planes = []
    lib.dense_topk_tf32_planes = lambda q, out, count, stream: planes.append(
        (q, out, count, stream)) or 0
    q = torch.zeros((20, 96))
    values = torch.zeros((5000, 96))
    out_v = torch.empty((3, 20, 5))
    out_i = torch.empty((3, 20, 5), dtype=torch.int32)
    assert dt._launch_tcs(lib, q, None, values, None, None, None, 5000, 2048, 5, out_v,
                          out_i, 7, dt.H100_SMS) == 0
    assert len(planes) == 1 and planes[0][0] == q.data_ptr() and planes[0][2:] == (20 * 96, 7)
    qn, nst = dt.tcs_geometry(dt.MODE_F32, 20, 5)
    assert lib.encoded == [(planes[0][1], 40, 96, 4, qn), (values.data_ptr(), 5000, 96, 4, 128)]
    assert lib.launches[0][1] == dt.MODE_F32
    assert list(lib.launches[0][4])[:10] == [qn, dt.TCS_RC, 20, 5000, 96, 2048, 3, 5, qn, nst]
    # a failed planes launch is the call's error: no kernel after it
    lib.dense_topk_tf32_planes = lambda *a: 700
    assert dt._launch_tcs(lib, q, None, values, None, None, None, 5000, 2048, 5, out_v,
                          out_i, 7, dt.H100_SMS) == 700
    assert len(lib.launches) == 1


def _tf32_rna_np(x):
    """tf32 rounding to nearest, ties away from zero, on the f32 bits."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def test_tf32_rounding_and_planes():
    """tf32_rna rounds an f32 to 10 mantissa bits, to nearest with ties
    away from zero (both signs, subnormals, zeros); tf32_planes stacks hi
    = tf32_rna(q) over lo = tf32_rna(q - hi), and hi + lo is q within
    2^-22 |q|."""
    ulp = 2.0 ** -10
    x = np.array([1.0, 1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -23,
                  1 + 3 * ulp / 2, 0.0, -0.0, 1e-40, -3e-39, 2.0 ** -149,
                  3.0e38], np.float32)
    want = np.array([1.0, 1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 0.0, -0.0],
                    np.float32)
    got = dt.tf32_rna(t(x))
    assert np.array_equal(n(got)[:7].view(np.uint32), want.view(np.uint32))
    assert np.array_equal(n(got).view(np.uint32), _tf32_rna_np(x).view(np.uint32))
    assert (n(got).view(np.uint32) & 0x1FFF == 0).all()
    rng = np.random.default_rng(17)
    q = rng.standard_normal((5, 48)).astype(np.float32)
    planes = n(dt.tf32_planes(t(q)))
    hi = _tf32_rna_np(q)
    assert np.array_equal(planes[:5], hi)
    assert np.array_equal(planes[5:], _tf32_rna_np(q - hi))
    assert (np.abs(planes[:5].astype(np.float64) + planes[5:] - q)
            <= 2.0 ** -22 * np.abs(q)).all()


def _three_pass_scores(q, rows):
    """[B, N] dot products as the f32 mode forms them on the tensor cores:
    both sides split into tf32 planes (x = h + l, h and l' = tf32_rna(l)
    round to nearest), then, a k8 step at a time, hi x hi, hi x lo and lo x
    hi, each step's sum of 8 exact products rounded into an f32 sum."""
    qh = _tf32_rna_np(q)
    ql = _tf32_rna_np(q - qh)
    rh = _tf32_rna_np(rows)
    rl = _tf32_rna_np(rows - rh)
    acc = np.zeros((q.shape[0], rows.shape[0]), np.float32)
    for s0 in range(0, q.shape[1], 8):
        for a, g in ((rh, qh), (rh, ql), (rl, qh)):
            part = g[:, s0:s0 + 8].astype(np.float64) @ a[:, s0:s0 + 8].astype(np.float64).T
            acc = acc + part.astype(np.float32)
    return acc


def _three_pass_union_scores(q, values, union):
    """[B, U, C] raw union scores as the IVF union kernel's f32 mode forms
    them (csrc/ivf_scan.cu, mma.sync m16n8k8 tf32): each union tile's rows
    against the queries, three products a k8 step on round-to-nearest
    planes, as ``_three_pass_scores`` (a step's k order, permuted alike on
    both sides inside the product, does not change its exact sum)."""
    return np.stack([_three_pass_scores(q, values[u]) for u in union], 1)


def _tile_topk_merge_np(scores, tile, kt, k):
    """Per-tile top-kt (value descending, lowest column first), then the
    stable top-k of the tiles' candidates in tile order: dense_topk's
    selection on given [B, N] scores."""
    b, rows = scores.shape
    tiles = -(-rows // tile)
    s = np.full((b, tiles * tile), -np.inf, np.float32)
    s[:, :rows] = scores
    s = s.reshape(b, tiles, tile)
    col = np.argsort(-s, axis=-1, kind="stable")[..., :kt]
    cv = np.take_along_axis(s, col, -1).reshape(b, -1)
    ci = (col + np.arange(tiles)[None, :, None] * tile).reshape(b, -1)
    pos = np.argsort(-cv, axis=-1, kind="stable")[:, :k]
    return np.take_along_axis(cv, pos, -1), np.take_along_axis(ci, pos, -1).astype(np.int32)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("metric", ["cosine", "ip", "l2"])
@pytest.mark.parametrize("d", [16, 96, 768, 1536])
def test_three_pass_tf32_holds_the_f32_tolerance(d, metric, masked):
    """The f32 mode's arithmetic, emulated in numpy (tf32 planes rounded to
    nearest, three products a k8 step, f32 sums, the epilogue, the per-tile
    selection), against the JAX package's f32 pallas_dense_topk
    (interpret=True): values within the float modes' tolerance D * 2^-23 *
    (max|score| + 1), ids equal but at near-ties, at D from 16 to 1,536,
    every metric, with a mask and with duplicate rows (ties); every
    emulated score of every row within that tolerance of the exact
    (float64) score."""
    rng = np.random.default_rng(18 + d)
    rows, b, tile, k = 1000, 8, 256, 10
    x = rng.standard_normal((rows, d)).astype(np.float32)
    x[64:96] = x[:32]
    q = rng.standard_normal((b, d)).astype(np.float32)
    mask = rng.random(rows) < 0.6 if masked else None
    jc = jdense.build_corpus(jnp.asarray(x), metric=metric, dtype=jnp.float32)
    jv, ji = pallas_dense_topk(jnp.asarray(q), jc, k=k, metric=metric,
                               mask=None if mask is None else jnp.asarray(mask),
                               tile=tile, interpret=True, per_tile_k=2)
    tc = build_corpus(t(x), metric=metric, dtype=torch.float32)
    qq, _, kt, _ = dt.prepare(t(q), tc, k, metric, tile, False, 2)
    qf, cf = n(qq), n(tc.values)
    emu = _three_pass_scores(qf, cf)
    exact = qf.astype(np.float64) @ cf.astype(np.float64).T
    if metric == "l2":
        norms = n(tc.norms_sq)
        emu = np.float32(2.0) * emu - norms[None, :]
        exact = 2.0 * exact - norms[None, :]
    if mask is not None:
        emu = np.where(mask[None, :], emu, -np.inf).astype(np.float32)
        exact = np.where(mask[None, :], exact, -np.inf)
    jvn = np.asarray(jv)
    tol = d * 2.0 ** -23 * (float(np.abs(jvn[np.isfinite(jvn)]).max()) + 1.0)
    fin = np.isfinite(exact)
    assert np.abs(emu[fin] - exact[fin]).max() <= tol
    ev, ei = _tile_topk_merge_np(emu, tile, kt, k)
    assert_topk_match(jv, ji, ev, ei, rtol=0.0, atol=tol, scores=exact.astype(np.float32))


@pytest.mark.parametrize("d", [16, 96, 768, 1536])
def test_three_pass_tf32_union_holds_the_f32_tolerance(d):
    """The IVF union kernel's f32 mode, emulated in numpy (tf32 planes
    rounded to nearest, three products a k8 step, f32 sums), against the
    JAX package's union kernel (``pallas_ivf._union_scores``,
    interpret=True) on f32 values: every raw score within the float
    tolerance D * 2^-23 * (max|score| + 1), and within it of the exact
    (float64) score, at D from 16 to 1,536, with duplicate rows and
    queries equal to rows (the self-match's large score)."""
    rng = np.random.default_rng(50 + d)
    nlist, cap, b = 6, 40, 5
    values = rng.standard_normal((nlist, cap, d)).astype(np.float32)
    values[:, 20:25] = values[:, :5]
    q = rng.standard_normal((b, d)).astype(np.float32)
    q[0] = values[3, 7]
    union = np.array([3, 0, 5, 1], np.int32)
    ref = np.moveaxis(np.asarray(jpivf._union_scores(
        jnp.asarray(q), jnp.asarray(union), jnp.asarray(values), interpret=True)), 1, 0)
    emu = _three_pass_union_scores(q, values, union)
    exact = np.einsum("bd,ucd->buc", q.astype(np.float64), values[union].astype(np.float64))
    assert emu.shape == ref.shape == (b, len(union), cap)
    tol = d * 2.0 ** -23 * (float(np.abs(ref).max()) + 1.0)
    assert np.abs(emu - ref).max() <= tol
    assert np.abs(emu - exact).max() <= tol


def _three_pass_per_query_scores(q, probes, values, qg):
    """[B, nprobe, C] raw per-query scores as the IVF per-query kernel's
    f32 mode forms them: the (query, probe) pairs cut into groups of at
    most ``qg`` pairs of one tile (``ivf_topk.probe_groups``), each group's
    queries against its tile's rows, three products a k8 step on
    round-to-nearest planes (``_three_pass_scores``)."""
    from super_rag_tpu_torch.ops import ivf_topk as tit

    b, nprobe = probes.shape
    nlist, cap, _ = values.shape
    groups = tit.probe_groups(t(probes), nlist, qg)
    order, pair_off, group_off = (n(x).astype(np.int64) for x in groups[:3])
    out = np.full((b * nprobe, cap), np.nan, np.float32)
    for tile in range(nlist):
        for g in range(group_off[tile], group_off[tile + 1]):
            first = pair_off[tile] + (g - group_off[tile]) * qg
            pairs = order[first:min(first + qg, pair_off[tile + 1])]
            out[pairs] = _three_pass_scores(q[pairs // nprobe], values[tile])
    return out.reshape(b, nprobe, cap)


@pytest.mark.parametrize("d", [16, 96, 768, 1536])
def test_three_pass_tf32_per_query_holds_the_f32_tolerance(d, monkeypatch):
    """The IVF per-query kernel's f32 mode, emulated in numpy over its
    tile-major work list (groups of ``PROBE_QG`` pairs; tf32 planes
    rounded to nearest, three products a k8 step, f32 sums), on probe
    lists with repeats: every pair scored once, within the float
    tolerance D * 2^-23 * (max|score| + 1) of the exact (float64) score
    and of ``probe_scores_plain``, and the same bits as the union's
    emulation gathered at the probes.  Then against the JAX package's
    per-query kernel (``pallas_ivf_topk`` on its per-query route,
    interpret=True, UNION_OUT_BYTES_MAX 0, k = every candidate, so its
    raw score of each probed row is read by row id): within that
    tolerance, and its top-10 matched by the emulated one, at D from 16
    to 1,536, with duplicate rows and a query equal to a row."""
    from super_rag_tpu.ops import ivf as jivf
    from super_rag_tpu_torch.ops import ivf_topk as tit

    rng = np.random.default_rng(70 + d)
    nlist, cap, b, nprobe = 6, 40, 5, 4
    values = rng.standard_normal((nlist, cap, d)).astype(np.float32)
    values[:, 20:25] = values[:, :5]
    q = rng.standard_normal((b, d)).astype(np.float32)
    q[0] = values[3, 7]
    probes = rng.integers(0, nlist, (b, nprobe)).astype(np.int32)
    probes[:, 1] = probes[:, 0]
    probes[0, 2] = 3
    emu = _three_pass_per_query_scores(q, probes, values, tit.PROBE_QG)
    exact = np.einsum("bd,bpcd->bpc", q.astype(np.float64),
                      values[probes].astype(np.float64))
    tol = d * 2.0 ** -23 * (float(np.abs(exact).max()) + 1.0)
    assert not np.isnan(emu).any()
    assert np.abs(emu - exact).max() <= tol
    row_ids = np.arange(nlist * cap, dtype=np.int32).reshape(nlist, cap)
    plain = n(tit.probe_scores_plain(t(q), t(probes), t(values), None, None, t(row_ids),
                                     None))
    assert np.abs(emu - plain).max() <= tol
    gathered = np.take_along_axis(_three_pass_union_scores(q, values, np.arange(nlist)),
                                  probes[:, :, None].astype(np.int64), 1)
    assert np.array_equal(emu.view(np.uint32), gathered.view(np.uint32))

    # the JAX per-query kernel, every candidate of its own probes
    monkeypatch.setattr(jpivf, "UNION_OUT_BYTES_MAX", 0)
    jpivf.pallas_ivf_topk.clear_cache()
    try:
        centroids = rng.standard_normal((nlist, d)).astype(np.float32)
        j = jivf.IVFIndex(jnp.asarray(centroids), jnp.asarray(values), None,
                          jnp.asarray(row_ids), None, None)
        jv, ji = jpivf.pallas_ivf_topk(jnp.asarray(q), j, k=nprobe * cap, nprobe=nprobe,
                                       metric=jdense.Metric.DOT, interpret=True)
    finally:
        jpivf.pallas_ivf_topk.clear_cache()
    jv, ji = np.asarray(jv), np.asarray(ji).astype(np.int64)
    emu_all = _three_pass_scores(q, values.reshape(nlist * cap, d))
    exact_all = q.astype(np.float64) @ values.reshape(nlist * cap, d).astype(np.float64).T
    tiles = np.argsort(-(q @ centroids.T), axis=1, kind="stable")[:, :nprobe]
    want_rows = np.sort((tiles[:, :, None] * cap + np.arange(cap)).reshape(b, -1), 1)
    assert np.array_equal(np.sort(ji, 1), want_rows)
    assert np.isfinite(jv).all()
    ref_tol = d * 2.0 ** -23 * (float(np.abs(jv).max()) + 1.0)
    emu_at = np.take_along_axis(emu_all, ji, 1)
    assert np.abs(emu_at - jv).max() <= ref_tol
    assert np.abs(emu_at - np.take_along_axis(exact_all, ji, 1)).max() <= ref_tol
    # the emulated per-query top-10 over the same probes against the JAX one
    emu_pq = _three_pass_per_query_scores(q, tiles.astype(np.int32), values, tit.PROBE_QG)
    ev, pos = torch.topk(t(emu_pq.reshape(b, -1)), 10)
    ei = np.take_along_axis(tiles, n(pos) // cap, 1) * cap + n(pos) % cap
    assert_topk_match(jv[:, :10], ji[:, :10], n(ev), ei, rtol=0.0, atol=ref_tol,
                      scores=exact_all.astype(np.float32))
