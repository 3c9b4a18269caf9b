"""The port's probe-streaming IVF top-k (super_rag_tpu_torch/ops/ivf_topk.py)
on its plain versions against the JAX package's ``pallas_ivf_topk`` run in
interpret mode, on one JAX-built index converted with ``ivf_from_jax``:
both the union route and the per-query route (forced by lowering
``UNION_OUT_BYTES_MAX`` in both modules), the union order, and the raw
union scores against the reference's ``_union_scores``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import super_rag_tpu.ops.pallas_ivf as jpivf
from super_rag_tpu.ops import ivf as jivf
from super_rag_tpu_torch import convert
from super_rag_tpu_torch.ops import ivf_topk as tit
from torch_parity import assert_topk_match, ivf_arrays, n, t

DIM = 32
# scores: the same f32 operations summed in other orders, abs and rel
TOL = 1e-5
KINDS = {"int8": (jnp.int8, 1.5), "int8_of": (jnp.int8, 0.6),
         "bf16": (jnp.bfloat16, 1.5), "f32_of": (jnp.float32, 0.6)}
_INDEXES = {}


def _index(kind):
    """(JAX index, port index, queries, keep-mask), built once per kind."""
    if kind not in _INDEXES:
        rng = np.random.default_rng(20)
        c = rng.standard_normal((12, DIM)).astype(np.float32) * 3.0
        x = (c[rng.integers(0, 12, 1500)]
             + rng.standard_normal((1500, DIM))).astype(np.float32)
        q = (c[rng.integers(0, 12, 5)]
             + rng.standard_normal((5, DIM))).astype(np.float32)
        dtype, cf = KINDS[kind]
        j = jivf.build_ivf(jnp.asarray(x), nlist=16, dtype=dtype,
                           kmeans_iters=4, capacity_factor=cf)
        p = convert.ivf_from_jax(*ivf_arrays(j), device="cpu")
        _INDEXES[kind] = (j, p, q, rng.random(1500) < 0.8)
    return _INDEXES[kind]


@pytest.fixture
def per_query_route(monkeypatch):
    """Both packages take the per-query route (the reference's jitted
    wrapper reads the cap at trace time, so its cache is cleared)."""
    monkeypatch.setattr(jpivf, "UNION_OUT_BYTES_MAX", 0)
    monkeypatch.setattr(tit, "UNION_OUT_BYTES_MAX", 0)
    jpivf.pallas_ivf_topk.clear_cache()
    yield
    jpivf.pallas_ivf_topk.clear_cache()


def _run_both(kind, nprobe, masked, k=10):
    j, p, q, mask = _index(kind)
    jm, tm = (jnp.asarray(mask), t(mask)) if masked else (None, None)
    ref = jpivf.pallas_ivf_topk(jnp.asarray(q), j, k=k, nprobe=nprobe,
                                mask=jm, interpret=True)
    got = tit.ivf_topk(t(q), p, k=k, nprobe=nprobe, mask=tm, device="cpu")
    return ref, got


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("nprobe", [3, 40])  # 40 >= nlist: clamped to 16
def test_union_route_matches(kind, masked, nprobe):
    (rv, ri), (gv, gi) = _run_both(kind, nprobe, masked)
    assert_topk_match(rv, ri, gv, gi, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("masked", [False, True])
def test_per_query_route_matches(kind, masked, per_query_route):
    (rv, ri), (gv, gi) = _run_both(kind, 4, masked)
    assert_topk_match(rv, ri, gv, gi, rtol=TOL, atol=TOL)


def test_routes_agree_when_every_tile_is_probed(monkeypatch):
    """nprobe = nlist: both routes score every tile, so they rank alike."""
    _, p, q, mask = _index("int8")
    a = tit.ivf_topk(t(q), p, k=10, nprobe=16, mask=t(mask), device="cpu")
    monkeypatch.setattr(tit, "UNION_OUT_BYTES_MAX", 0)
    b = tit.ivf_topk(t(q), p, k=10, nprobe=16, mask=t(mask), device="cpu")
    assert_topk_match(*a, *b, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("nprobe", [1, 3, 16])
def test_union_order_matches(nprobe):
    """Probed tiles first in ascending id, then the unprobed ones."""
    j, p, q, _ = _index("int8")
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    cs = qn @ np.asarray(j.centroids).T
    _, probes = torch.sort(t(cs), dim=-1, descending=True, stable=True)
    probes = probes[:, :nprobe].to(torch.int32)
    got = tit.probe_union(probes, 16)
    flags = jnp.zeros((16,), jnp.float32).at[jnp.asarray(n(probes)).reshape(
        -1)].set(1.0)
    _, ref = jax.lax.top_k(flags, min(16, probes.numel()))
    np.testing.assert_array_equal(n(got), np.asarray(ref))


@pytest.mark.parametrize("kind", list(KINDS))
def test_raw_union_scores_match(kind):
    """``union_scores`` with no epilogue operands against the reference's
    raw ``_union_scores`` [U, B, C] (its epilogue ran outside): equal on
    filled slots, -inf on empty ones."""
    j, p, q, _ = _index(kind)
    union = np.array([5, 0, 11, 3], np.int32)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    cdt = jnp.float32 if kind.startswith("f32") else jnp.bfloat16
    ref = np.asarray(jpivf._union_scores(jnp.asarray(qn).astype(cdt),
                                         jnp.asarray(union), j.values,
                                         interpret=True))
    qt = t(qn).to(torch.float32 if cdt == jnp.float32 else torch.bfloat16)
    got = n(tit.union_scores(qt, t(union), p.values, None, None, p.row_ids,
                             None))
    ref = np.moveaxis(ref, 1, 0)  # [B, U, C]
    filled = np.asarray(j.row_ids)[union][None] >= 0
    np.testing.assert_allclose(got[np.broadcast_to(filled, got.shape)],
                               ref[np.broadcast_to(filled, ref.shape)],
                               rtol=TOL, atol=TOL)
    assert np.isneginf(got[np.broadcast_to(~filled, got.shape)]).all()


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_versions_agree_on_shared_tiles(residual, masked):
    """The per-query plain version on probe lists that all equal the
    union gives the union plain version's scores: one epilogue, two
    gathers."""
    _, p, q, mask = _index("int8")
    qb = t(q / np.linalg.norm(q, axis=1, keepdims=True)).to(torch.bfloat16)
    tiles = torch.tensor([2, 7, 9], dtype=torch.int32)
    cs = t(np.random.default_rng(1).standard_normal((5, 16)).astype(
        np.float32)) if residual else None
    m = t(mask) if masked else None
    u = tit.union_scores(qb, tiles, p.values, p.scales, cs, p.row_ids, m)
    pq = tit.probe_scores(qb, tiles[None].expand(5, -1).contiguous(),
                          p.values, p.scales, cs, p.row_ids, m)
    np.testing.assert_allclose(n(pq), n(u), rtol=TOL, atol=TOL)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    _, p, q, _ = _index("int8")
    qb = t(q).to(torch.bfloat16)
    tiles = torch.tensor([1, 4], dtype=torch.int32)
    counters = (tit.union_tc_launches, tit.probe_tc_launches)
    before = [c.count for c in counters]
    tit.union_scores(qb, tiles, p.values, p.scales, None, p.row_ids, None)
    tit.probe_scores(qb, tiles[None].expand(5, -1).contiguous(), p.values,
                     p.scales, None, p.row_ids, None)
    assert [c.count for c in counters] == before
    meta = p.values.to("meta")
    for fn in (tit.union_scores, tit.probe_scores):
        with pytest.raises(ValueError, match="no ivf_scan path"):
            fn(qb, tiles, meta, None, None, p.row_ids, None)


@pytest.mark.parametrize("dtype,want", [(torch.int8, "tc"),
                                        (torch.bfloat16, "tc"),
                                        (torch.float32, "tc")])
def test_union_variant_by_mode(dtype, want):
    """Every values type takes the tensor-core union kernel: int8 / bf16
    values on bf16 products, f32 values on three TF32 products."""
    assert tit.union_variant(tit.MODES[dtype]) == want
