"""The PyTorch port's IVF build and search (super_rag_tpu_torch/ops/ivf.py)
against the JAX package's ops/ivf.py, on the same numpy inputs.

Build parity: both packages build from the same rows; k-means sums in
another order, so centroids agree to ulps and codes of residual rows may
round the other way at a rounding boundary (tolerances below).  Search
parity: one JAX-built index, converted with ``convert.ivf_from_jax``, is
searched by both packages, so build noise cannot hide a search fault."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_rag_tpu.ops import dense as jdense
from super_rag_tpu.ops import ivf as jivf
from super_rag_tpu_torch import convert
from super_rag_tpu_torch.ops import dense as tdense
from super_rag_tpu_torch.ops import ivf as tivf
from torch_parity import assert_topk_match, ivf_arrays, n, t

DIM = 32
DTYPES = {"int8": (jnp.int8, torch.int8), "bf16": (jnp.bfloat16, torch.bfloat16),
          "f32": (jnp.float32, torch.float32)}
# scores: both packages take the same f32 operations in other summation
# orders (and normalise queries with another reduction), abs and rel
TOL = 1e-5
# build: centroids within 1e-6 abs (ulps of unit vectors).  The stored
# residuals x - centroid then differ by ulps, so a code may round one
# step apart, and a row whose centroid was reseeded from the row itself
# stores a residual of 0 in one package and of ulps (scaled up to full
# codes) in the other: dequantized values (codes x scales) agree within
# one quantization step of their row plus the centroids' 2 * CEN_ATOL,
# at most 1 % of the stored rows carry any other code, and at most 2 %
# of the error-sign bits flip
CEN_ATOL, ROW_FRAC, SIGN_FRAC = 1e-6, 0.01, 0.02


def _clustered(rows, centers=12, seed=0, d=DIM):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, d)).astype(np.float32) * 3.0
    x = c[rng.integers(0, centers, rows)] + rng.standard_normal((rows, d))
    q = c[rng.integers(0, centers, 6)] + rng.standard_normal((6, d))
    return x.astype(np.float32), q.astype(np.float32), rng


def _assert_codes_close(ref_codes, ref_scales, codes, scales):
    """int8 rows ``[..., D]`` with per-row scales, within ROW_FRAC and one
    quantization step (see above)."""
    rc, gc = np.asarray(ref_codes).astype(np.int32), n(codes).astype(np.int32)
    rs, gs = np.asarray(ref_scales)[..., None], n(scales)[..., None]
    step = np.maximum(rs, gs) * 1.0001 + 2 * CEN_ATOL
    assert (np.abs(gc * gs - rc * rs) <= step).all()
    rows = (gc != rc).any(-1)
    assert rows.mean() <= ROW_FRAC


def _assert_build_matches(j, p):
    """Same placement exactly; the stored numbers within the tolerances."""
    np.testing.assert_array_equal(n(p.row_ids), np.asarray(j.row_ids))
    np.testing.assert_allclose(n(p.centroids), np.asarray(j.centroids),
                               atol=CEN_ATOL)
    assert p.residual == j.residual
    if j.scales is None:
        # rows normalised to other ulps: bf16 may round one ulp apart
        rtol = 2.0 ** -7 if p.values.dtype == torch.bfloat16 else 1e-6
        np.testing.assert_allclose(n(p.values), np.asarray(
            j.values.astype(jnp.float32)), rtol=rtol, atol=1e-7)
    else:
        _assert_codes_close(j.values, j.scales, p.values, p.scales)
        bits = np.unpackbits(n(p.sign_plane)) != np.unpackbits(
            np.asarray(j.sign_plane))
        assert bits.mean() <= SIGN_FRAC
    assert (p.overflow is None) == (j.overflow is None)
    if j.overflow is not None:
        np.testing.assert_array_equal(n(p.overflow_rows),
                                      np.asarray(j.overflow_rows))
        if j.of_assign is not None:
            np.testing.assert_array_equal(n(p.of_assign),
                                          np.asarray(j.of_assign))


# -- host steps: identical numpy in both packages -----------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quant_rows_and_error_signs_match(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((300, DIM)).astype(np.float32) * 0.1
    x[7] = 0.0  # an all-zero row keeps scale 1/127
    q, s = tivf._quant_rows(x)
    jq, js = jivf._quant_rows(x)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(tivf.pack_error_signs(x, q, s),
                                  jivf.pack_error_signs(x, jq, js))
    codes = tivf.pack_error_signs(x, q, s)
    np.testing.assert_array_equal(
        n(tivf.unpack_signs(t(codes))),
        np.asarray(jivf.unpack_signs(jnp.asarray(codes))))


@pytest.mark.parametrize("allowed", [False, True])
@pytest.mark.parametrize("seed", [3, 4])
def test_balanced_place_matches(allowed, seed):
    rng = np.random.default_rng(seed)
    cand = rng.integers(0, 10, (500, 4)).astype(np.int32)
    allow = rng.random((500, 4)) < 0.8 if allowed else None
    c1, c2 = np.zeros(10, np.int64), np.zeros(10, np.int64)
    c1[3] = c2[3] = 40
    got = tivf._balanced_place(cand, c1, 64, allow)
    ref = jivf._balanced_place(cand, c2, 64, allow)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(c1, c2)


@pytest.mark.parametrize("metric", ["ip", "cosine"])
def test_error_sign_corpus_matches(metric):
    """Unnormalised rows (ip) give the same codes and signs bit for bit;
    cosine rows are normalised by another reduction, so a code may round
    one apart and an error sign near zero may flip (the build
    tolerances)."""
    x, _, _ = _clustered(200)
    j = jdense.build_corpus(jnp.asarray(x), metric=jdense.Metric(metric),
                            dtype=jnp.int8, error_signs=True)
    p = tdense.build_corpus(t(x), metric=tdense.Metric(metric),
                            dtype=torch.int8, error_signs=True)
    if metric == "ip":
        np.testing.assert_array_equal(n(p.values), np.asarray(j.values))
        np.testing.assert_array_equal(n(p.sign_plane),
                                      np.asarray(j.sign_plane))
    else:
        _assert_codes_close(j.values, j.scales, p.values, p.scales)
        bits = np.unpackbits(n(p.sign_plane)) != np.unpackbits(
            np.asarray(j.sign_plane))
        assert bits.mean() <= SIGN_FRAC


# -- k-means and assignment ---------------------------------------------------------


def test_assign_and_topc_match():
    x, _, _ = _clustered(700, seed=5)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    cen = x[::35]
    np.testing.assert_array_equal(
        n(tivf._assign(t(x), t(cen), block=256)),
        np.asarray(jivf._assign(jnp.asarray(x), jnp.asarray(cen), block=256)))
    ti, tv = tivf._assign_topc(t(x), t(cen), 3, block=256)
    ji, jv = jivf._assign_topc(jnp.asarray(x), jnp.asarray(cen), 3, block=256)
    np.testing.assert_array_equal(n(ti), np.asarray(ji))
    np.testing.assert_allclose(n(tv), np.asarray(jv), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("metric", ["cosine", "ip"])
def test_kmeans_matches(metric):
    """Same init rows and reseeds (numpy seed); the centroids agree within
    CEN_ATOL and assign every row alike."""
    x, _, _ = _clustered(900, seed=6)
    jc = jivf.kmeans(jnp.asarray(x), 16, iters=5, seed=3,
                     metric=jivf.Metric(metric))
    tc = tivf.kmeans(t(x), 16, iters=5, seed=3, metric=tivf.Metric(metric))
    np.testing.assert_allclose(n(tc), np.asarray(jc), atol=CEN_ATOL,
                               rtol=1e-5)
    xn = x / np.linalg.norm(x, axis=1, keepdims=True) if metric == "cosine" else x
    np.testing.assert_array_equal(
        n(tivf._assign(t(xn), tc)),
        np.asarray(jivf._assign(jnp.asarray(xn), jc)))


def test_kmeans_twolevel_matches():
    x, _, _ = _clustered(1200, centers=16, seed=7)
    jc, jcc = jivf.kmeans_twolevel(jnp.asarray(x), 32, 4, iters=4, seed=1,
                                   coarse_train=800)
    tc, tcc = tivf.kmeans_twolevel(t(x), 32, 4, iters=4, seed=1,
                                   coarse_train=800)
    np.testing.assert_allclose(n(tcc), np.asarray(jcc), atol=CEN_ATOL)
    np.testing.assert_allclose(n(tc), np.asarray(jc), atol=CEN_ATOL)


@pytest.mark.parametrize("c", [3, 6])
def test_assign_topc_grouped(c):
    """Where the top-p groups hold c fine centroids both packages return
    the same [m, c]; where they hold fewer (p * fpb < c) the reference
    returns only p * fpb columns, the port widens p and keeps the [m, c]
    contract with the true top-c of the groups it scored."""
    x, _, _ = _clustered(400, centers=8, seed=8)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    cen, cen_c = jivf.kmeans_twolevel(jnp.asarray(x), 16, 4, iters=3, seed=2)
    cen, cen_c = np.asarray(cen), np.asarray(cen_c)  # fpb = 4
    ji, jv = jivf._assign_topc_grouped(x, cen, cen_c, c, p=1)
    ti, tv = tivf._assign_topc_grouped(x, cen, cen_c, c, p=1)
    assert ti.shape == tv.shape == (400, c)
    if c <= 4:
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tv, jv)
    else:
        assert ji.shape == (400, 4)  # the reference's width at this edge
        np.testing.assert_allclose(tv, np.take_along_axis(x @ cen.T, ti, 1),
                                   atol=1e-5)
        assert (np.diff(tv, axis=1) <= 0).all()
        # the port's top-4 can only improve on the reference's
        assert (tv[:, :4] >= jv - 1e-6).all()


# -- builds ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("capacity_factor", [1.5, 0.6])
def test_build_ivf_matches(dtype, capacity_factor):
    """0.6 forces an overflow segment (residual-coded for int8)."""
    x, _, _ = _clustered(1500, seed=9)
    ids = np.arange(1500, dtype=np.int32) * 3 + 1
    j = jivf.build_ivf(jnp.asarray(x), nlist=16, dtype=DTYPES[dtype][0],
                       kmeans_iters=4, capacity_factor=capacity_factor,
                       sample=1000, ids=ids)
    p = tivf.build_ivf(t(x), nlist=16, dtype=DTYPES[dtype][1],
                       kmeans_iters=4, capacity_factor=capacity_factor,
                       sample=1000, ids=ids)
    assert p.capacity % 128 == 0 and p.capacity == j.capacity
    _assert_build_matches(j, p)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("coarse", [None, 4])
def test_build_ivf_streaming_matches(dtype, coarse):
    x, _, _ = _clustered(2000, centers=16, seed=10)
    ids = np.arange(2000, dtype=np.int32)[::-1].copy()

    def chunks():
        for lo in range(0, 2000, 700):
            yield x[lo:lo + 700]

    kw = dict(nlist=32, kmeans_iters=4, train_sample=900, ids=ids,
              coarse=coarse, capacity_factor=1.0, spill_margin=0.05)
    j = jivf.build_ivf_streaming(chunks, dtype=DTYPES[dtype][0], **kw)
    p = tivf.build_ivf_streaming(chunks, dtype=DTYPES[dtype][1],
                                 device="cpu", **kw)
    assert p.capacity == j.capacity == 128
    _assert_build_matches(j, p)


def test_build_ivf_streaming_host_arrays():
    x, _, _ = _clustered(600, seed=11)
    p = tivf.build_ivf_streaming(lambda: iter([x]), nlist=8, kmeans_iters=2,
                                 host_arrays=True, device="cpu")
    assert p.values.device.type == "cpu" and p.values.dtype == torch.int8
    assert sorted(n(p.row_ids)[n(p.row_ids) >= 0].tolist()
                  + ([] if p.overflow_rows is None
                     else n(p.overflow_rows).tolist())) == list(range(600))


# -- search on one JAX-built index -----------------------------------------------


def _index(kind, seed=12):
    """JAX-built index and its port conversion.  kinds: int8 (residual,
    sign plane), int8_plain (no residual), int8_of (residual overflow),
    int8_of_plain (overflow of full vectors), bf16 / f32 (+ _of)."""
    x, q, rng = _clustered(1500, seed=seed)
    dtype = DTYPES[kind.split("_")[0]][0]
    cf = 0.6 if "_of" in kind else 1.5
    j = jivf.build_ivf(jnp.asarray(x), nlist=16, dtype=dtype, kmeans_iters=4,
                       capacity_factor=cf, residual=not kind.endswith("plain")
                       and dtype == jnp.int8)
    p = convert.ivf_from_jax(*ivf_arrays(j), device="cpu")
    mask = rng.random(1500) < 0.8
    return j, p, q, mask


KINDS = ["int8", "int8_plain", "int8_of", "int8_of_plain", "bf16", "bf16_of",
         "f32", "f32_of"]
_INDEXES = {}


def _cached(kind):
    if kind not in _INDEXES:
        _INDEXES[kind] = _index(kind)
    return _INDEXES[kind]


def _masks(mask, masked):
    return ((jnp.asarray(mask), t(mask)) if masked else (None, None))


def test_convert_round_trips_every_field():
    j, p, _, _ = _cached("int8_of")
    arrays, residual, dtype = ivf_arrays(j)
    assert dtype == "int8" and residual and p.overflow is not None
    np.testing.assert_array_equal(n(p.values), np.asarray(j.values))
    np.testing.assert_array_equal(n(p.of_sign_plane),
                                  np.asarray(j.of_sign_plane))
    np.testing.assert_array_equal(n(p.overflow.scales),
                                  np.asarray(j.overflow.scales))
    jb, pb, _, _ = _cached("bf16")
    assert pb.values.dtype == torch.bfloat16
    np.testing.assert_array_equal(n(pb.values), np.asarray(
        jb.values.astype(jnp.float32)))


def test_convert_rejects_a_malformed_index():
    j, _, _, _ = _cached("int8")
    arrays, residual, dtype = ivf_arrays(j)
    with pytest.raises(ValueError, match="row_ids"):
        convert.ivf_from_jax(dict(arrays, row_ids=None), residual, dtype,
                             device="cpu")
    with pytest.raises(ValueError, match="values"):
        convert.ivf_from_jax(arrays, residual, "float32", device="cpu")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("masked", [False, True])
def test_ivf_search_matches(kind, masked):
    j, p, q, mask = _cached(kind)
    jm, tm = _masks(mask, masked)
    for nprobe in (3, 16):
        jv, ji = jivf.ivf_search(jnp.asarray(q), j, k=10, nprobe=nprobe,
                                 mask=jm, query_block=4)
        pv, pi = tivf.ivf_search(t(q), p, k=10, nprobe=nprobe, mask=tm,
                                 query_block=4)
        assert_topk_match(jv, ji, pv, pi, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("int8_queries", [False, True])
def test_ivf_flat_topk_matches(kind, masked, int8_queries):
    """Exact top-k on both sides (``approx_topk=False`` in the
    reference); block_clusters 4 makes four blocks to merge."""
    j, p, q, mask = _cached(kind)
    jm, tm = _masks(mask, masked)
    jv, ji = jivf.ivf_flat_topk(jnp.asarray(q), j, k=10, mask=jm,
                                approx_topk=False, block_clusters=4,
                                int8_queries=int8_queries)
    pv, pi = tivf.ivf_flat_topk(t(q), p, k=10, mask=tm, block_clusters=4,
                                int8_queries=int8_queries)
    assert_topk_match(jv, ji, pv, pi, rtol=TOL, atol=TOL)


def _probe_scores(j, q):
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    return qn, qn @ np.asarray(j.centroids).T


@pytest.mark.parametrize("kind", ["int8_of", "int8_of_plain", "bf16_of",
                                  "f32_of"])
@pytest.mark.parametrize("masked", [False, True])
def test_overflow_topk_matches(kind, masked):
    j, p, q, mask = _cached(kind)
    jm, tm = _masks(mask, masked)
    qn, cs = _probe_scores(j, q)
    ref = jivf.overflow_topk(jnp.asarray(qn), jnp.asarray(cs), j, 12,
                             mask=jm, block_size=64)
    got = tivf.overflow_topk(t(qn), t(cs), p, 12, mask=tm, block_size=64)
    assert_topk_match(ref[0], ref[1], got[0], got[1], rtol=TOL, atol=TOL)
    fin = np.isfinite(np.asarray(ref[0]))
    np.testing.assert_array_equal(n(got[2])[fin], np.asarray(ref[2])[fin])


def _pool(kind, rng_seed=13):
    """A phase-1 candidate pool from the reference's own gather tier, as
    (qn, cs, fv, fi, loc), so refine / attach see real location codes."""
    j, p, q, mask = _cached(kind)
    qn, cs = _probe_scores(j, q)
    fv, fi, loc = jivf._ivf_search_core(
        jnp.asarray(qn), j.centroids, j.values, j.scales, j.row_ids, None,
        k=20, nprobe=4, query_block=6, has_mask=False, residual=j.residual)
    return j, p, mask, qn, cs, fv, fi, loc


@pytest.mark.parametrize("kind", ["int8", "int8_of", "int8_of_plain"])
def test_refine_candidates_matches(kind):
    j, p, _, qn, cs, fv, fi, loc = _pool(kind)
    rv, ri = jivf.refine_candidates(jnp.asarray(qn), jnp.asarray(cs), j, fv,
                                    fi, loc)
    gv, gi = tivf.refine_candidates(t(qn), t(cs), p, t(fv), t(fi), t(loc))
    assert_topk_match(rv, ri, gv, gi, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", ["int8", "int8_of", "int8_of_plain",
                                  "bf16_of", "f32_of"])
@pytest.mark.parametrize("masked", [False, True])
def test_attach_overflow_and_refine_matches(kind, masked):
    j, p, mask, qn, cs, fv, fi, loc = _pool(kind)
    jm, tm = _masks(mask, masked)
    rv, ri = jivf.attach_overflow_and_refine(
        jnp.asarray(qn), jnp.asarray(cs), j, fv, fi, loc, 10, mask=jm)
    gv, gi = tivf.attach_overflow_and_refine(
        t(qn), t(cs), p, t(fv), t(fi), t(loc), 10, mask=tm)
    assert_topk_match(rv, ri, gv, gi, rtol=TOL, atol=TOL)
