"""Dense primitives of the PyTorch port against the JAX package: quant,
build_corpus, dense_search, top-k helpers (with the tie order) and RRF."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_rag_tpu.ops import dense as jdense
from super_rag_tpu.ops.fusion import rrf_fuse as j_rrf
from super_rag_tpu.ops.quant import quantize_int8 as j_quant
from super_rag_tpu.ops.topk import blockwise_topk as j_blockwise
from super_rag_tpu.ops.topk import merge_topk as j_merge
from super_rag_tpu_torch.ops import dense as tdense
from super_rag_tpu_torch.ops.fusion import rrf_fuse
from super_rag_tpu_torch.ops.quant import quantize_int8
from super_rag_tpu_torch.ops.topk import blockwise_topk, merge_topk, stable_topk
from torch_parity import assert_topk_match, n, t

DTYPES = {"int8": (jnp.int8, torch.int8), "bf16": (jnp.bfloat16, torch.bfloat16),
          "f32": (jnp.float32, torch.float32)}
METRICS = ["cosine", "ip", "l2"]


@pytest.mark.parametrize("shape", [(300, 64), (7, 3), (1, 768)])
def test_quantize_int8_bit_equal(shape):
    """Codes and scales bit-equal (half-to-even rounding, zero rows)."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 50, (shape[0], 1))
         ).astype(np.float32)
    x[0] = 0.0  # all-zero row -> scale 0, codes 0
    if shape[0] > 1 and shape[1] >= 2:
        x[-1, :2] = [127.0, 0.5]  # exact .5 quotient: round half to even
    jq, js = j_quant(jnp.asarray(x))
    tq, ts = quantize_int8(t(x))
    np.testing.assert_array_equal(n(tq), np.asarray(jq))
    np.testing.assert_array_equal(n(ts).view(np.int32), np.asarray(js).view(np.int32))
    assert n(ts)[0] == 0.0


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_build_corpus(metric, dtype):
    """Stored values within one storage step (int8: one code) of the JAX
    build, and nearly all equal; f32 within 1e-6 (the row norms are summed
    in another order); scales and norms within 1e-6 relative."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((200, 32)).astype(np.float32)
    x[3] = 0.0  # zero-norm guard
    jc = jdense.build_corpus(jnp.asarray(x), metric=metric, dtype=DTYPES[dtype][0])
    tc = tdense.build_corpus(t(x), metric=metric, dtype=DTYPES[dtype][1])
    jv = np.asarray(jc.values.astype(jnp.float32))
    tv = n(tc.values).astype(np.float32)
    step = 1.0 if dtype == "int8" else (2.0 ** -7 if dtype == "bf16" else 1e-6)
    assert np.all(np.abs(jv - tv) <= step * np.maximum(1.0, np.abs(jv)))
    if dtype != "f32":  # rounding to storage absorbs the norm's last bits
        assert np.mean(jv == tv) > 0.99
    for a, b in ((jc.scales, tc.scales), (jc.norms_sq, tc.norms_sq)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(n(b), np.asarray(a), rtol=1e-6, atol=1e-7)


def _corpora(x, metric, dtype):
    """One stored corpus, handed to both packages as the same bits."""
    jc = jdense.build_corpus(jnp.asarray(x), metric=metric, dtype=DTYPES[dtype][0])
    tc = tdense.DenseCorpus(
        values=t(np.asarray(jc.values.astype(jnp.float32))).to(DTYPES[dtype][1]),
        scales=None if jc.scales is None else t(np.asarray(jc.scales)),
        norms_sq=None if jc.norms_sq is None else t(np.asarray(jc.norms_sq)),
    )
    return jc, tc


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("blocked", [False, True])
def test_dense_search(metric, dtype, blocked):
    """Top-k scores within 1e-5, ids equal up to near-ties, with a mask
    and (blocked) a ragged last block."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((700, 32)).astype(np.float32)
    q = rng.standard_normal((6, 32)).astype(np.float32)
    q[1] = 0.0
    mask = rng.random(700) < 0.7
    jc, tc = _corpora(x, metric, dtype)
    bs = 256 if blocked else 8192
    jv, ji = jdense.dense_search(jnp.asarray(q), jc, k=12, metric=metric,
                                 mask=jnp.asarray(mask), block_size=bs)
    tv, ti = tdense.dense_search(t(q), tc, k=12, metric=metric, mask=t(mask),
                                 block_size=bs)
    assert ti.dtype == torch.int32
    assert_topk_match(jv, ji, tv, ti)


@pytest.mark.parametrize("metric", METRICS)
def test_exact_scores(metric):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((50, 16)).astype(np.float32)
    q = rng.standard_normal((3, 16)).astype(np.float32)
    jc, tc = _corpora(x, metric, "f32")
    np.testing.assert_allclose(n(tdense.exact_scores(t(q), tc, metric)),
                               np.asarray(jdense.exact_scores(jnp.asarray(q), jc, metric)),
                               rtol=1e-5, atol=1e-5)


def test_stable_topk_tie_order():
    """torch.topk gives [3, 5, 2] here; the reference's order is [1, 2, 3]."""
    x = [1.0, 3.0, 3.0, 3.0, 0.0, 3.0]
    v, i = stable_topk(torch.tensor(x), 3)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 3)
    assert n(i).tolist() == np.asarray(ji).tolist() == [1, 2, 3]
    v, i = stable_topk(torch.full((5,), float("-inf")), 2)
    assert n(i).tolist() == [0, 1]


@pytest.mark.parametrize("n_cols,block", [(50, 2048), (5000, 512), (4099, 1024)])
def test_blockwise_and_merge_topk_exact_with_ties(n_cols, block):
    """Integer-valued scores with many ties: ids bit-equal to the JAX
    package (lowest index first among ties)."""
    rng = np.random.default_rng(5)
    s = rng.integers(0, 20, (4, n_cols)).astype(np.float32)
    jv, ji = j_blockwise(jnp.asarray(s), k=17, block_size=block)
    tv, ti = blockwise_topk(t(s), k=17, block_size=block)
    np.testing.assert_array_equal(n(tv), np.asarray(jv))
    np.testing.assert_array_equal(n(ti), np.asarray(ji))
    ids = rng.permutation(n_cols)[None].repeat(4, 0).astype(np.int32)
    jv, ji = j_merge(jnp.asarray(s), jnp.asarray(ids), 9)
    tv, ti = merge_topk(t(s), t(ids), 9)
    np.testing.assert_array_equal(n(tv), np.asarray(jv))
    np.testing.assert_array_equal(n(ti), np.asarray(ji))


@pytest.mark.parametrize("weights", [(1.0, 1.0), (2.0, 0.5)])
def test_rrf_fuse(weights):
    """Duplicates, -1 padding and equal contributions: bit-equal."""
    a = np.array([[5, 3, 9, -1], [1, 2, 3, 4], [-1, -1, -1, -1]], np.int32)
    b = np.array([[3, 7, -1], [4, 3, 8], [-1, -1, -1]], np.int32)
    jv, ji = j_rrf(jnp.asarray(a), jnp.asarray(b), k=6, weight_a=weights[0],
                   weight_b=weights[1])
    tv, ti = rrf_fuse(t(a), t(b), k=6, weight_a=weights[0], weight_b=weights[1])
    np.testing.assert_array_equal(n(tv), np.asarray(jv))
    np.testing.assert_array_equal(n(ti), np.asarray(ji))
