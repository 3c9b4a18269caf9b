"""The CSR lexical tier of the PyTorch port (ops/bm25_inverted.py
``build_inverted_csr``, ``reshard_csr_host``, the CSR search body, and the
tier behind ``hybrid_search`` and ``DeviceIndex``) against the JAX
package on the same numpy inputs: builds bit-identical, searches equal up
to ties within the stated tolerances."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_rag_tpu.engine import index as jindex
from super_rag_tpu.ops import bm25 as jbm25
from super_rag_tpu.ops import bm25_inverted as jinv
from super_rag_tpu.ops import dense as jdense
from super_rag_tpu.ops.hybrid import hybrid_search as j_hybrid
from super_rag_tpu_torch import convert
from super_rag_tpu_torch.engine import index as tindex
from super_rag_tpu_torch.ops import bm25 as tbm25
from super_rag_tpu_torch.ops import bm25_inverted as tinv
from super_rag_tpu_torch.ops.dense import DenseCorpus
from super_rag_tpu_torch.ops.hybrid import hybrid_search
from torch_parity import all_scores, assert_topk_match, n, t

V = 1 << 11
SHARDS = [1, 2, 4, 16]


def _zipf_corpus(case="zipf", rows=2500, slots=20, seed=3):
    """The reference's CSR test corpus: zipfian terms (duplicates in a
    row kept, as the reference's own CSR tests keep them), zipfian tfs, a
    fifth of the slots padded.  ``ties``: every tf 1 and one doc length,
    so a term's impacts are all equal; ``dead``: dead rows (terms padded,
    tf zeroed, as compaction leaves them), an all-pad row, and live
    slots with tf 0 (impact 0)."""
    rng = np.random.default_rng(seed)
    terms = ((rng.zipf(1.3, size=(rows, slots)) - 1) % V).astype(np.int32)
    tfs = np.minimum(rng.zipf(2.0, size=(rows, slots)), 8).astype(np.float32)
    pad = rng.random((rows, slots)) < 0.2
    terms[pad] = V
    tfs[pad] = 0.0
    if case == "ties":
        tfs[~pad] = 1.0
    doc_len = tfs.sum(1) * 2.0 + 1.0
    if case == "ties":
        doc_len[:] = 9.0
    if case == "dead":
        dead = rng.random(rows) < 0.1
        terms[dead] = V
        tfs[dead] = 0.0
        terms[7], tfs[7] = V, 0.0  # all-pad row
        zero = (rng.random((rows, slots)) < 0.02) & (terms < V)
        tfs[zero] = 0.0
    return terms, tfs, doc_len.astype(np.float32)


def _queries(terms, n_q=10, qn=8, seed=4):
    """Query rows' distinct terms with the corpus's idf (df over each
    row's distinct terms, as the reference's CSR tests count it)."""
    rows = len(terms)
    st = np.sort(terms, axis=1)
    first = np.ones_like(st, bool)
    first[:, 1:] = st[:, 1:] != st[:, :-1]
    uniq = st[first]
    df = np.bincount(uniq[uniq < V].astype(np.int64), minlength=V + 1)
    idf = np.log(1.0 + (rows - df + 0.5) / (df + 0.5)).astype(np.float32)
    pick = np.random.default_rng(seed).integers(0, rows, n_q)
    qt = np.full((n_q, qn), V, np.int32)
    for i, r in enumerate(pick):
        u = [x for x in dict.fromkeys(terms[r].tolist()) if x != V][:qn]
        qt[i, :len(u)] = u
    qi = np.where(qt != V, idf[np.minimum(qt, V)], 0.0).astype(np.float32)
    return qt, qi


def _csr_arrays(j):
    """A JAX ``CSRInvertedIndex`` as ``convert.csr_from_jax`` takes it."""
    return {"docs": np.asarray(j.postings_docs),
            "impacts": np.asarray(j.postings_impact.astype(jnp.float32)),
            "offsets": np.asarray(j.offsets), "num_docs": np.asarray(j.num_docs)}


def _max_run(terms):
    return int(np.max(np.bincount(terms[terms < V].astype(np.int64))))


@pytest.fixture(scope="module")
def corpus():
    terms, tfs, dl = _zipf_corpus()
    qt, qi = _queries(terms)
    return terms, tfs, dl, qt, qi


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("case", ["zipf", "ties", "dead"])
def test_build_inverted_csr_bit_identical(case, shards):
    """Docs, bf16 impact bits and offsets equal the JAX package's numpy
    build, unsharded and doc-sharded."""
    terms, tfs, dl = _zipf_corpus(case)
    j = jinv.build_inverted_csr(terms, tfs, dl, V, shards=shards)
    p = tinv.build_inverted_csr(t(terms), t(tfs), t(dl), V, shards=shards)
    np.testing.assert_array_equal(n(p.postings_docs), np.asarray(j.postings_docs))
    np.testing.assert_array_equal(
        p.postings_impact.view(torch.int16).numpy(),
        np.asarray(j.postings_impact).view(np.int16))
    np.testing.assert_array_equal(n(p.offsets), np.asarray(j.offsets))
    assert p.postings_docs.dtype == torch.int32 and p.offsets.dtype == torch.int32
    assert (p.num_docs, p.vocab_size, p.shards, p.postings_per_term) == (
        j.num_docs, j.vocab_size, j.shards, j.postings_per_term)


@pytest.mark.parametrize("avgdl", [None, 11.5])
def test_build_inverted_csr_takes_the_given_avgdl(avgdl):
    terms, tfs, dl = _zipf_corpus(seed=9)
    j = jinv.build_inverted_csr(terms, tfs, dl, V, avgdl=avgdl, k1=0.9, b=0.4)
    p = tinv.build_inverted_csr(t(terms), t(tfs), t(dl), V, avgdl=avgdl,
                                k1=0.9, b=0.4)
    np.testing.assert_array_equal(
        p.postings_impact.view(torch.int16).numpy(),
        np.asarray(j.postings_impact).view(np.int16))
    np.testing.assert_array_equal(n(p.postings_docs), np.asarray(j.postings_docs))


@pytest.mark.parametrize("shards", [2, 3, 4, 16])
def test_reshard_csr_host_matches(shards):
    """Resharding an unsharded CSR gives the reference's arrays, and the
    same layout as a sharded build."""
    terms, tfs, dl = _zipf_corpus("dead", seed=5)
    flat = jinv.build_inverted_csr(terms, tfs, dl, V)
    a = _csr_arrays(flat)
    jd, jimp, joff = jinv.reshard_csr_host(a["docs"], a["impacts"], a["offsets"],
                                           shards)
    pd, pimp, poff = tinv.reshard_csr_host(a["docs"], a["impacts"], a["offsets"],
                                           shards)
    for got, want in ((pd, jd), (pimp, jimp), (poff, joff)):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    built = tinv.build_inverted_csr(t(terms), t(tfs), t(dl), V, shards=shards)
    np.testing.assert_array_equal(n(built.postings_docs), pd)
    np.testing.assert_array_equal(n(built.offsets), poff)


@pytest.mark.parametrize("shards", [1, 2, 4, 16, 64])
def test_shard_depth_matches(shards):
    for depth in list(range(1, 300)) + [1024, 2048, 4096, 16384, 65536, 200_000]:
        assert tinv._shard_depth(depth, shards) == jinv._shard_depth(depth, shards)


def _jax_tol(j_index, qt, qi, depth_terms):
    """The JAX package's run totals are differences of a row-wide f32
    cumsum, so a total carries the rounding of the row's prefix: up to
    about log2(width) ulps of the row's whole weight sum (bounded here by
    every query term's full run weight)."""
    imp = np.asarray(j_index.postings_impact.astype(jnp.float32), np.float64)
    csum = np.concatenate([[0.0], np.cumsum(imp)])
    off = np.asarray(j_index.offsets).reshape(-1, V + 2)
    run = (csum[off[:, 1:]] - csum[off[:, :-1]]).sum(0)  # [V+1], all shards
    row_sum = (run[qt] * qi).sum(1).max()
    width = max(2, depth_terms)
    return max(1e-5, 2 * np.log2(width) * 2.0 ** -23 * row_sum)


BUDGETS = {
    "shallow": dict(postings_per_query_term=16),
    "deep": dict(postings_per_query_term=16, deep_terms=3, deep_postings=512),
    "defaults": dict(deep_terms=2),  # the CSR body's 4096 / 4 x 4096
    "full": "full",
}


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("budget", list(BUDGETS))
def test_csr_search_matches(corpus, budget, masked, shards):
    """inverted_bm25_search on one JAX-built CSR (converted) in both
    packages: scores within the JAX package's f32-cumsum error, ids equal
    up to near-ties (kept difference "Lexical tie order")."""
    terms, tfs, dl, qt, qi = corpus
    j = jinv.build_inverted_csr(terms, tfs, dl, V, shards=shards)
    p = convert.csr_from_jax(_csr_arrays(j), device="cpu")
    kw = BUDGETS[budget]
    if kw == "full":
        kw = dict(postings_per_query_term=_max_run(terms))
    mask = np.random.default_rng(6).random(len(terms)) < 0.7 if masked else None

    def jax_search(k):
        return jinv.inverted_bm25_search(
            jnp.asarray(qt), jnp.asarray(qi), j, k=k,
            mask=None if mask is None else jnp.asarray(mask), **kw)

    jv, ji = jax_search(25)
    pv, pi = tinv.inverted_bm25_search(t(qt), t(qi), p, k=25,
                                       mask=None if mask is None else t(mask), **kw)
    assert pi.dtype == torch.int32 and tuple(pv.shape) == (len(qt), 25)
    width = qt.shape[1] * max(kw.get("postings_per_query_term") or 4096,
                              kw.get("deep_postings") or 0)
    tol = _jax_tol(j, qt, qi, width)
    assert_topk_match(jv, ji, pv, pi, rtol=1e-5, atol=tol,
                      scores=all_scores(*jax_search(len(terms)), len(terms)))
    if masked:
        assert mask[n(pi)[n(pi) >= 0]].all()


@pytest.mark.parametrize("shards", [1, 4])
def test_csr_search_approx_flag_matches(corpus, shards):
    """``approx_topk`` is taken for the contract (the port is exact;
    the reference is exact on the CPU too)."""
    terms, tfs, dl, qt, qi = corpus
    j = jinv.build_inverted_csr(terms, tfs, dl, V, shards=shards)
    p = convert.csr_from_jax(_csr_arrays(j), device="cpu")
    kw = dict(postings_per_query_term=32, deep_terms=2, deep_postings=256)
    jv, ji = jinv.inverted_bm25_search(jnp.asarray(qt), jnp.asarray(qi), j, k=25,
                                       approx_topk=True, **kw)
    pv, pi = tinv.inverted_bm25_search(t(qt), t(qi), p, k=25, approx_topk=True, **kw)
    ev, ei = tinv.inverted_bm25_search(t(qt), t(qi), p, k=25, **kw)
    assert torch.equal(pv, ev) and torch.equal(pi, ei)
    full = jinv.inverted_bm25_search(jnp.asarray(qt), jnp.asarray(qi), j,
                                     k=len(terms), **kw)
    assert_topk_match(jv, ji, pv, pi, rtol=1e-5,
                      atol=_jax_tol(j, qt, qi, qt.shape[1] * 256),
                      scores=all_scores(*full, len(terms)))


def _doc_major(terms, tfs, dl, qt, qi, k, mask=None):
    corpus = tbm25.build_lexical_corpus(t(terms), t(tfs), t(dl))
    return tbm25.bm25_search(t(qt), t(qi), corpus, float(dl.mean()),
                             vocab_size=V, k=k,
                             mask=None if mask is None else t(mask))


# each impact is rounded to bf16 (relative error <= 2^-9); a run total is
# a sum of nonnegative weights, so it lies within 2^-9 of the f32 doc-major
# score, plus f32 rounding: 2^-8 relative holds both with room
BF16_RTOL = 2.0 ** -8


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("masked", [False, True])
def test_csr_at_full_coverage_is_the_doc_major_scorer(corpus, shards, masked):
    """At a budget >= the longest run the CSR tier is exact BM25: the
    doc-major scorer's ids up to near-ties, scores within bf16 impact
    rounding."""
    terms, tfs, dl, qt, qi = corpus
    mask = np.random.default_rng(8).random(len(terms)) < 0.6 if masked else None
    p = tinv.build_inverted_csr(t(terms), t(tfs), t(dl), V, shards=shards)
    cv, ci = tinv.inverted_bm25_search(
        t(qt), t(qi), p, k=30, mask=None if mask is None else t(mask),
        postings_per_query_term=_max_run(terms))
    gv, gi = _doc_major(terms, tfs, dl, qt, qi, 30, mask)
    # the doc-major scorer scores a doc with no query term 0; the
    # inverted tiers leave it out (-inf, -1)
    gv = torch.where(gv > 0, gv, float("-inf"))
    assert_topk_match(gv, gi, cv, ci, rtol=BF16_RTOL, atol=1e-6,
                      scores=all_scores(*_doc_major(terms, tfs, dl, qt, qi,
                                                    len(terms), mask), len(terms)))


@pytest.mark.parametrize("shards", [2, 4, 16])
@pytest.mark.parametrize("budget", ["full", "deep"])
def test_sharded_equals_unsharded(corpus, shards, budget):
    """Full coverage: the sharded tier's result is the unsharded one (id-
    disjoint shards, exact per-shard sums, exact merge).  A truncating
    deep budget: each shard reads its share plus slack, so every doc the
    unsharded search finds with all its postings is found again."""
    terms, tfs, dl, qt, qi = corpus
    kw = (dict(postings_per_query_term=_max_run(terms)) if budget == "full"
          else dict(postings_per_query_term=16, deep_terms=3, deep_postings=512))
    flat = tinv.build_inverted_csr(t(terms), t(tfs), t(dl), V)
    sh = tinv.build_inverted_csr(t(terms), t(tfs), t(dl), V, shards=shards)
    fv, fi = tinv.inverted_bm25_search(t(qt), t(qi), flat, k=25, **kw)
    sv, si = tinv.inverted_bm25_search(t(qt), t(qi), sh, k=25, **kw)
    if budget == "full":
        full = tinv.inverted_bm25_search(t(qt), t(qi), flat, k=len(terms), **kw)
        assert_topk_match(fv, fi, sv, si, rtol=1e-6, atol=1e-6,
                          scores=all_scores(*full, len(terms)))
    else:
        # a doc's sharded total sums at least the postings the unsharded
        # prefix holds, so its score can only rise
        for b in range(len(qt)):
            got = dict(zip(n(si)[b].tolist(), n(sv)[b].tolist()))
            for d, s in zip(n(fi)[b].tolist(), n(fv)[b].tolist()):
                if d >= 0 and d in got:
                    assert got[d] >= s * (1 - 1e-6)


def _hybrid_setup(seed=30, rows=1500, dim=24):
    rng = np.random.default_rng(seed)
    terms, tfs, dl = _zipf_corpus(rows=rows, slots=12, seed=seed)
    qt, qi = _queries(terms, n_q=6, qn=6, seed=seed + 1)
    emb = rng.standard_normal((rows, dim)).astype(np.float32)
    q = rng.standard_normal((6, dim)).astype(np.float32)
    jd = jdense.build_corpus(jnp.asarray(emb), dtype=jnp.float32)
    td = DenseCorpus(values=t(np.asarray(jd.values)), scales=None)
    jl = jbm25.LexicalCorpus(terms=jnp.asarray(terms),
                             tfs=jnp.asarray(tfs, jnp.bfloat16),
                             doc_len=jnp.asarray(dl))
    tl = tbm25.build_lexical_corpus(t(terms), t(tfs), t(dl))
    mask = rng.random(rows) < 0.8
    return dict(terms=terms, tfs=tfs, dl=dl, qt=qt, qi=qi, q=q, jd=jd, td=td,
                jl=jl, tl=tl, mask=mask, avgdl=float(dl.mean()))


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("opts", [dict(postings_per_query_term=64, lex_gen=40),
                                  dict(postings_per_query_term=16, lex_deep_terms=2,
                                       lex_deep_postings=256)])
def test_hybrid_search_on_csr_matches(shards, masked, opts):
    """hybrid_search(inverted=CSR) in both packages (rescore on, the
    default): fused ids equal, RRF scores within 1e-6, branch scores within
    1e-5."""
    s = _hybrid_setup()
    j = jinv.build_inverted_csr(s["terms"], s["tfs"], s["dl"], V, shards=shards)
    p = convert.csr_from_jax(_csr_arrays(j), device="cpu")
    common = dict(vocab_size=V, k=8, candidates=20, **opts)
    jr = j_hybrid(jnp.asarray(s["q"]), jnp.asarray(s["qt"]), jnp.asarray(s["qi"]),
                  s["jd"], s["jl"], jnp.float32(s["avgdl"]), inverted=j,
                  mask=jnp.asarray(s["mask"]) if masked else None,
                  use_pallas=False, block_size=512, **common)
    tr = hybrid_search(t(s["q"]), t(s["qt"]), t(s["qi"]), s["td"], s["tl"],
                       s["avgdl"], inverted=p, mask=t(s["mask"]) if masked else None,
                       use_kernel=False, block_size=512, device="cpu", **common)
    np.testing.assert_array_equal(n(tr.indices), np.asarray(jr.indices))
    np.testing.assert_allclose(n(tr.scores), np.asarray(jr.scores), rtol=1e-6)
    for a, b in ((jr.dense_scores, tr.dense_scores), (jr.bm25_scores, tr.bm25_scores)):
        np.testing.assert_allclose(n(b), np.asarray(a), rtol=1e-5, atol=1e-5)


def _texts(rng, count, vocab=5000):
    """Zipfian texts of 10-40 words over a wide vocabulary, so that docs
    tied in exact BM25 stay rare."""
    words = [f"w{i}" for i in range(vocab)]
    p = 1.0 / np.arange(1, vocab + 1) ** 0.9
    p /= p.sum()
    return [" ".join(rng.choice(words, rng.integers(10, 40), p=p))
            for _ in range(count)]


def _index_pair(shards, seed=70, dim=16):
    """A JAX and a port DeviceIndex whose lowered ``csr_auto_rows`` makes
    ``lex_tier="auto"`` pick CSR: 480 rows compacted, deletes, then 120
    fresh rows scored doc-major beside the postings."""
    rng = np.random.default_rng(seed)
    kw = dict(dim=dim, bm25_slots=10, vocab_size=V, min_capacity=512,
              csr_auto_rows=300, csr_shards=shards)
    j = jindex.DeviceIndex(jindex.IndexSpec(dtype=jnp.int8, **kw))
    p = tindex.DeviceIndex(tindex.IndexSpec(dtype=torch.int8, **kw), device="cpu")
    texts = _texts(rng, 600)
    emb = rng.standard_normal((600, dim)).astype(np.float32)
    for idx in (j, p):
        idx.auto_compact_rows = 10 ** 6
        idx.add(emb[:480], texts[:480])
        idx.delete([3, 3, 40, 41])
        idx.compact_lexical()
        idx.add(emb[480:], texts[480:], chat_id="c2")
    return j, p, texts, emb, rng


@pytest.mark.parametrize("shards", [1, 4])
def test_device_index_auto_tier_builds_csr_alike(shards):
    j, p, *_ = _index_pair(shards)
    assert isinstance(p._inverted, tinv.CSRInvertedIndex)
    assert isinstance(j._inverted, jinv.CSRInvertedIndex)
    assert p._inverted.shards == shards and p._inverted_upto == j._inverted_upto == 480
    a = _csr_arrays(j._inverted)
    np.testing.assert_array_equal(n(p._inverted.postings_docs), a["docs"])
    np.testing.assert_array_equal(n(p._inverted.offsets), a["offsets"])
    np.testing.assert_array_equal(n(p._inverted.postings_impact), a["impacts"])
    # deleted rows hold no posting
    assert not np.isin(n(p._inverted.postings_docs), [3, 40, 41]).any()


def _exact_ties(p, queries, rtol=1e-6):
    """Per query, the docs that match two or more query terms and whose
    exact BM25 score (the port's doc-major scorer over the live rows) lies
    within ``rtol`` of another doc's.  The exact rescore adds a doc's
    slot products in slot order in f32, and XLA's CPU program rounds that
    sum its own way, so two such docs with equal true scores whose terms
    sit in other slots may differ in the last bit, and either package may
    rank them either way.  (A doc matching one term scores one product,
    the same bits in both.)"""
    qt, qi = p._query_arrays(queries, 16)
    v, i = tbm25.bm25_search(qt, qi, p._lexical(), p.df.avgdl, vocab_size=V,
                             k=p._capacity, mask=p._mask(None))
    terms = n(p.terms)
    tied = []
    for q_terms, vals, ids in zip(n(qt), n(v), n(i)):
        keep = np.isfinite(vals) & (vals > 0)
        vals, ids = vals[keep], ids[keep]
        close = np.abs(vals[:, None] - vals[None, :]) <= rtol * vals[:, None]
        q_set = q_terms[q_terms < V]
        multi = np.isin(terms[ids], q_set).sum(1) >= 2
        tied.append(set(ids[(close.sum(1) > 1) & multi].tolist()))
    return tied


def _assert_same_up_to_ties(jr, tr, tied):
    """Rows with no tied doc among their results are equal (ids, RRF
    scores within 1e-6, BM25 scores within 1e-5); in the others, with the
    tied docs taken out, one fused list is a prefix of the other with
    equal RRF scores (swapping tied docs moves no other doc's ranks)."""
    untouched = 0
    for r, tset in enumerate(tied):
        ja = [(int(i), float(v)) for i, v in zip(np.asarray(jr.indices)[r],
                                                 np.asarray(jr.scores)[r])]
        ta = [(int(i), float(v)) for i, v in zip(n(tr.indices)[r], n(tr.scores)[r])]
        if not tset & {i for i, _ in ja + ta}:
            untouched += 1
            assert [i for i, _ in ja] == [i for i, _ in ta], r
            np.testing.assert_allclose(n(tr.scores)[r], np.asarray(jr.scores)[r],
                                       rtol=1e-6)
            np.testing.assert_allclose(n(tr.bm25_scores)[r],
                                       np.asarray(jr.bm25_scores)[r],
                                       rtol=1e-5, atol=1e-5)
            continue
        ja = [x for x in ja if x[0] not in tset]
        ta = [x for x in ta if x[0] not in tset]
        m = min(len(ja), len(ta))
        assert m > 0 and [i for i, _ in ja[:m]] == [i for i, _ in ta[:m]], r
        np.testing.assert_allclose([v for _, v in ta[:m]], [v for _, v in ja[:m]],
                                   rtol=1e-6)
    assert untouched >= len(tied) // 2  # the exact check saw most rows


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("opts", [{}, dict(postings_per_query_term=8, lex_deep_terms=2,
                                          lex_deep_postings=64)])
def test_device_index_csr_search_hybrid_matches(shards, opts):
    """search_hybrid over the CSR prefix + fresh tail (rescore on): rows
    equal with RRF scores within 1e-6, up to docs tied in exact BM25."""
    j, p, texts, emb, rng = _index_pair(shards)
    queries = [" ".join(x.split()[:3]) for x in texts[::53]]
    q = (emb[::53] + 0.2 * rng.standard_normal((len(queries), emb.shape[1]))).astype(
        np.float32)
    jr = j.search_hybrid(jnp.asarray(q), queries, k=8, candidates=24, **opts)
    tr = p.search_hybrid(torch.from_numpy(q), queries, k=8, candidates=24, **opts)
    _assert_same_up_to_ties(jr, tr, _exact_ties(p, queries))


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("fresh_tail", [True, False])
def test_device_index_csr_search_bm25_matches(shards, fresh_tail):
    """search_bm25 (unrescored CSR postings, plus the fresh tail before
    the second compaction): ids up to near-ties, scores within the JAX
    package's f32-cumsum error."""
    j, p, texts, *_ = _index_pair(shards)
    if not fresh_tail:
        for idx in (j, p):
            idx.compact_lexical()
        assert isinstance(p._inverted, tinv.CSRInvertedIndex)
        assert p._inverted_upto == p.size
    queries = [" ".join(x.split()[:4]) for x in texts[::61]]
    rows = j.size
    jv, ji = j.search_bm25(queries, 10)
    pv, pi = p.search_bm25(queries, 10)
    assert_topk_match(jv, ji, pv, pi, rtol=1e-4, atol=1e-4,
                      scores=all_scores(*j.search_bm25(queries, rows), rows))


def test_csr_from_jax_rejects_malformed_arrays():
    terms, tfs, dl = _zipf_corpus(rows=200)
    a = _csr_arrays(jinv.build_inverted_csr(terms, tfs, dl, V))
    with pytest.raises(ValueError, match="lacks"):
        convert.csr_from_jax({k: v for k, v in a.items() if k != "offsets"},
                             device="cpu")
    with pytest.raises(ValueError, match="expected"):
        convert.csr_from_jax(dict(a, docs=a["docs"].astype(np.int64)), device="cpu")
    with pytest.raises(ValueError, match="last offset"):
        convert.csr_from_jax(dict(a, docs=a["docs"][1:], impacts=a["impacts"][1:]),
                             device="cpu")


@pytest.mark.parametrize("lex_gen", [30, 300])
def test_device_index_search_hybrid_takes_lex_gen(lex_gen):
    """``DeviceIndex.search_hybrid(lex_gen=)`` (the port passes it on; the
    reference's 10M configuration sets it on hybrid_search itself)
    equals the JAX hybrid_search over the JAX index's state with the
    same lex_gen."""
    j, p, texts, emb, rng = _index_pair(1)
    for idx in (j, p):
        idx.compact_lexical()  # no fresh tail: the JAX call below has none
    queries = [" ".join(x.split()[:3]) for x in texts[::53]]
    q = (emb[::53] + 0.2 * rng.standard_normal((len(queries), emb.shape[1]))).astype(
        np.float32)
    qt, qi = j._query_arrays(queries, 16)
    jr = j_hybrid(jnp.asarray(q), qt, qi, j.dense_corpus(),
                  jbm25.LexicalCorpus(terms=j.terms, tfs=j.tfs, doc_len=j.doc_len),
                  jnp.float32(j.df.avgdl), inverted=j._inverted, vocab_size=V, k=8,
                  candidates=24, mask=j._mask(None), use_pallas=False,
                  postings_per_query_term=768, lex_gen=lex_gen)
    tr = p.search_hybrid(torch.from_numpy(q), queries, k=8, candidates=24,
                         lex_gen=lex_gen)
    _assert_same_up_to_ties(jr, tr, _exact_ties(p, queries))
