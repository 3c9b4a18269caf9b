"""The fused dense top-k of the PyTorch port against the TPU kernel.

On the CPU the wrapper runs its plain PyTorch version, held here against
``pallas_dense_topk(interpret=True)`` (as tests/test_pallas_topk.py runs
it) over every mode, with and without the per-tile cap and a mask, at a
ragged N.  The CUDA kernel itself is held against the plain version by
tests/test_torch_cuda.py (skips without a card) and by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    before = (dt.tc_launches.count, dt.simt_launches.count)
    tv, ti = dt.dense_topk(t(q), tc, k=K, metric=metric,
                           mask=None if mask is None else t(mask), tile=TILE,
                           int8_queries=i8q, per_tile_k=per_tile_k, device="cpu")
    # the CPU runs the plain version
    assert (dt.tc_launches.count, dt.simt_launches.count) == before
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


@pytest.mark.parametrize("mode,kt,d,want", [
    (dt.MODE_INT8, 2, 768, "tc"), (dt.MODE_INT8, 1, 16, "tc"),
    (dt.MODE_INT8, 8, 1024, "tc"), (dt.MODE_INT8, 9, 768, "simt"),
    (dt.MODE_INT8, 2, 1040, "simt"), (dt.MODE_INT8_BF16, 2, 768, "simt"),
    (dt.MODE_BF16, 1, 768, "simt"), (dt.MODE_F32, 2, 96, "simt")])
def test_kernel_variant_by_shape(mode, kt, d, want):
    """The int8 tensor-core kernel takes int8 x int8 at kt <= 8 and
    D <= 1024; every other mode and shape takes the SIMT kernel."""
    assert dt.kernel_variant(mode, kt, d) == want
