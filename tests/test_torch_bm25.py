"""Lexical ops of the PyTorch port against the JAX package: doc-major
bm25_search, build_inverted (bit-identical tables) and
inverted_bm25_search with and without df-adaptive budgets and a mask."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_rag_tpu.ops import bm25 as jbm25
from super_rag_tpu.ops import bm25_inverted as jinv
from super_rag_tpu_torch.ops import bm25 as tbm25
from super_rag_tpu_torch.ops import bm25_inverted as tinv
from torch_parity import all_scores, assert_topk_match, n, t

V = 1 << 10


def _corpus(seed, rows=600, slots=12):
    """Zipfian doc-term table with pad slots and per-row duplicate-free
    terms, plus query batches drawn from its rows."""
    rng = np.random.default_rng(seed)
    terms = np.minimum(rng.zipf(1.3, (rows, slots)) - 1, V - 1).astype(np.int32)
    for r in range(rows):  # the analyzer emits each term once per row
        _, first = np.unique(terms[r], return_index=True)
        dup = np.ones(slots, bool)
        dup[first] = False
        terms[r, dup] = V
    tfs = np.minimum(rng.zipf(2.0, (rows, slots)), 8).astype(np.float32)
    tfs[terms == V] = 0.0
    doc_len = (tfs.sum(1) * 2 + 1).astype(np.float32)
    df = np.bincount(terms[terms < V], minlength=V)
    idf = np.log(1 + (rows - df + 0.5) / (df + 0.5)).astype(np.float32)
    q_rows = rng.integers(0, rows, 7)
    qt = np.full((7, 6), V, np.int32)
    for i, r in enumerate(q_rows):
        u = [x for x in dict.fromkeys(terms[r].tolist()) if x != V][:6]
        qt[i, :len(u)] = u
    qi = np.where(qt < V, idf[np.minimum(qt, V - 1)], 0.0).astype(np.float32)
    return terms, tfs, doc_len, qt, qi, rng


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("block_size", [8192, 128])
def test_bm25_search(masked, block_size):
    """Doc-major scores within 1e-5 abs/rel (the slot sum may add in
    another order), ids equal up to near-ties."""
    terms, tfs, dl, qt, qi, rng = _corpus(20)
    mask = rng.random(len(terms)) < 0.7 if masked else None
    jc = jbm25.build_lexical_corpus(jnp.asarray(terms), jnp.asarray(tfs),
                                    jnp.asarray(dl))
    tc = tbm25.build_lexical_corpus(t(terms), t(tfs), t(dl))
    avgdl = float(dl.mean())
    def jax_search(k):
        return jbm25.bm25_search(
            jnp.asarray(qt), jnp.asarray(qi), jc, jnp.float32(avgdl),
            vocab_size=V, k=k,
            mask=None if mask is None else jnp.asarray(mask),
            block_size=block_size)

    jv, ji = jax_search(15)
    tv, ti = tbm25.bm25_search(t(qt), t(qi), tc, avgdl, vocab_size=V, k=15,
                               mask=None if mask is None else t(mask),
                               block_size=block_size)
    assert_topk_match(jv, ji, tv, ti,
                      scores=all_scores(*jax_search(len(terms)), len(terms)))


@pytest.mark.parametrize("postings", [4, 32, 256])
@pytest.mark.parametrize("avgdl", [None, 17.25])
def test_build_inverted_bit_identical(postings, avgdl):
    """Postings ids and bf16 impacts bit-identical to the JAX package's
    numpy build (n * slots < 2^18 keeps it off the native path)."""
    terms, tfs, dl, *_ = _corpus(21)
    assert terms.size < (1 << 18)
    terms[5] = V  # a dead row
    tfs[5] = 0.0
    j = jinv.build_inverted(terms, tfs, dl, V, postings_per_term=postings,
                            avgdl=avgdl)
    p = tinv.build_inverted(t(terms), t(tfs), t(dl), V,
                            postings_per_term=postings, avgdl=avgdl)
    np.testing.assert_array_equal(n(p.postings_ids), np.asarray(j.postings_ids))
    np.testing.assert_array_equal(
        p.postings_impact.view(torch.int16).numpy(),
        np.asarray(j.postings_impact).view(np.int16))
    assert p.num_docs == j.num_docs


def _segment_sum_numpy(ids, w):
    """Exact per-row run sums (f64), the definition _segment_sum_runs meets."""
    out = []
    for r in range(ids.shape[0]):
        s = {}
        for i, x in zip(ids[r], w[r]):
            if i >= 0:
                s[int(i)] = s.get(int(i), 0.0) + float(x)
        out.append(s)
    return out


def test_segment_sum_runs_exact():
    """Run totals equal the f32-rounded exact sums; one total per id, at
    its run end."""
    rng = np.random.default_rng(22)
    ids = rng.integers(-1, 40, (5, 300)).astype(np.int32)
    w = (rng.random((5, 300)) * 10).astype(np.float32)
    sorted_ids, totals = tinv._segment_sum_runs(t(ids), t(w))
    gold = _segment_sum_numpy(ids, w)
    for r in range(5):
        fin = torch.isfinite(totals[r])
        got = dict(zip(n(sorted_ids[r])[n(fin)].tolist(), n(totals[r])[n(fin)].tolist()))
        assert got == {k: float(np.float32(v)) for k, v in gold[r].items()}


def _tol_from_row_sums(w_rows):
    """The JAX package sums a row's weights with an f32 cumsum, so a run
    total carries up to ~4 ulps of the row's whole weight sum."""
    return 4 * 2.0 ** -23 * float(np.max(w_rows))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("deep", [(0, None), (2, 64), (3, None)])
@pytest.mark.parametrize("pq", [None, 8])
def test_inverted_bm25_search(masked, deep, pq):
    """Scores within the f32-cumsum error of the JAX package's run sums
    (its totals are differences of a row-wide f32 prefix sum; the port's
    are exact sums rounded once), ids equal up to near-ties."""
    terms, tfs, dl, qt, qi, rng = _corpus(23)
    mask = rng.random(len(terms)) < 0.7 if masked else None
    j = jinv.build_inverted(terms, tfs, dl, V, postings_per_term=32)
    p = tinv.build_inverted(t(terms), t(tfs), t(dl), V, postings_per_term=32)
    def jax_search(k):
        return jinv.inverted_bm25_search(
            jnp.asarray(qt), jnp.asarray(qi), j, k=k,
            mask=None if mask is None else jnp.asarray(mask),
            postings_per_query_term=pq, deep_terms=deep[0],
            deep_postings=deep[1])

    jv, ji = jax_search(20)
    tv, ti = tinv.inverted_bm25_search(
        t(qt), t(qi), p, k=20, mask=None if mask is None else t(mask),
        postings_per_query_term=pq, deep_terms=deep[0], deep_postings=deep[1])
    assert ti.dtype == torch.int32
    row_sum = (np.asarray(j.postings_impact.astype(jnp.float32))[qt].sum((1, 2))
               * qi.max(1))
    tol = max(1e-5, _tol_from_row_sums(row_sum))
    assert_topk_match(jv, ji, tv, ti, rtol=1e-5, atol=tol,
                      scores=all_scores(*jax_search(len(terms)), len(terms)))
    if masked:
        got = n(ti)[n(ti) >= 0]
        assert mask[got].all()


def test_inverted_no_match_returns_empty():
    terms, tfs, dl, *_ = _corpus(24)
    p = tinv.build_inverted(t(terms), t(tfs), t(dl), V)
    qt = torch.full((2, 4), V, dtype=torch.int32)
    v, i = tinv.inverted_bm25_search(qt, torch.zeros(2, 4), p, k=5)
    assert (n(i) == -1).all() and np.isinf(n(v)).all()
