"""The PyTorch port's hybrid_search against the JAX package's
(``use_pallas=False``: the blocked dense branch, as its own tests run it
on the CPU) over the same corpora: the inverted path with and without
exact rescoring, with a fresh doc-major tail, the doc-major fallback, the
three IVF tiers (the reference's IVF kernel in interpret mode) and the
sign-plane refinement."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import super_rag_tpu.ops.pallas_ivf as jpivf
from super_rag_tpu.ops import bm25 as jbm25
from super_rag_tpu.ops import bm25_inverted as jinv
from super_rag_tpu.ops import dense as jdense
from super_rag_tpu.ops import ivf as jivf
from super_rag_tpu.ops.hybrid import hybrid_search as j_hybrid
from super_rag_tpu_torch import convert
from super_rag_tpu_torch.ops import bm25 as tbm25
from super_rag_tpu_torch.ops import bm25_inverted as tinv
from super_rag_tpu_torch.ops.dense import DenseCorpus
from super_rag_tpu_torch.ops.hybrid import hybrid_search
from torch_parity import ivf_arrays, n, t

V = 1 << 10
ROWS, DIM, SLOTS = 900, 32, 10
DTYPES = {"int8": (jnp.int8, torch.int8), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _setup(dtype, seed=30):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((ROWS, DIM)).astype(np.float32)
    terms = np.minimum(rng.zipf(1.4, (ROWS, SLOTS)) - 1, V - 1).astype(np.int32)
    for r in range(ROWS):
        _, first = np.unique(terms[r], return_index=True)
        dup = np.ones(SLOTS, bool)
        dup[first] = False
        terms[r, dup] = V
    tfs = np.minimum(rng.zipf(2.0, (ROWS, SLOTS)), 8).astype(np.float32)
    tfs[terms == V] = 0.0
    dl = (tfs.sum(1) * 2 + 1).astype(np.float32)
    df = np.bincount(terms[terms < V], minlength=V)
    idf = np.log(1 + (ROWS - df + 0.5) / (df + 0.5)).astype(np.float32)
    q_rows = rng.integers(0, ROWS, 6)
    qt = np.full((6, 5), V, np.int32)
    for i, r in enumerate(q_rows):
        u = [x for x in dict.fromkeys(terms[r].tolist()) if x != V][:5]
        qt[i, :len(u)] = u
    qi = np.where(qt < V, idf[np.minimum(qt, V - 1)], 0.0).astype(np.float32)
    q_emb = (emb[q_rows] + 0.3 * rng.standard_normal((6, DIM))).astype(np.float32)
    jd = jdense.build_corpus(jnp.asarray(emb), dtype=DTYPES[dtype][0])
    td = DenseCorpus(values=t(np.asarray(jd.values.astype(jnp.float32))).to(DTYPES[dtype][1]),
                     scales=None if jd.scales is None else t(np.asarray(jd.scales)))
    jl = jbm25.build_lexical_corpus(jnp.asarray(terms), jnp.asarray(tfs), jnp.asarray(dl))
    tl = tbm25.build_lexical_corpus(t(terms), t(tfs), t(dl))
    mask = rng.random(ROWS) < 0.85
    return dict(terms=terms, tfs=tfs, dl=dl, qt=qt, qi=qi, q=q_emb, jd=jd, td=td,
                jl=jl, tl=tl, mask=mask, avgdl=float(dl.mean()))


def _run_both(s, upto=None, masked=False, **kw):
    """Both packages on the same inputs; ``upto`` < ROWS makes rows
    [upto, ROWS) a fresh tail scanned doc-major beside the postings."""
    jmask = jnp.asarray(s["mask"]) if masked else None
    tmask = t(s["mask"]) if masked else None
    jargs, targs = {}, {}
    if upto is not None:
        jinv_ = jinv.build_inverted(s["terms"][:upto], s["tfs"][:upto], s["dl"][:upto],
                                    V, postings_per_term=16, avgdl=s["avgdl"])
        tinv_ = tinv.build_inverted(t(s["terms"][:upto]), t(s["tfs"][:upto]),
                                    t(s["dl"][:upto]), V, postings_per_term=16,
                                    avgdl=s["avgdl"])
        jargs["inverted"], targs["inverted"] = jinv_, tinv_
        if upto < ROWS:
            start, length = 512, ROWS - 512  # a slice covering the tail
            rows = np.arange(start, start + length)
            keep = (rows >= upto) & (s["mask"][start:] if masked else True)
            jargs.update(tail_lexical=jbm25.LexicalCorpus(
                s["jl"].terms[start:], s["jl"].tfs[start:], s["jl"].doc_len[start:]),
                tail_mask=jnp.asarray(keep), tail_offset=start)
            targs.update(tail_lexical=tbm25.LexicalCorpus(
                s["tl"].terms[start:], s["tl"].tfs[start:], s["tl"].doc_len[start:]),
                tail_mask=t(keep), tail_offset=start)
    common = dict(vocab_size=V, k=8, candidates=20, **kw)
    jr = j_hybrid(jnp.asarray(s["q"]), jnp.asarray(s["qt"]), jnp.asarray(s["qi"]),
                  s["jd"], s["jl"], jnp.float32(s["avgdl"]), mask=jmask,
                  use_pallas=False, block_size=256, **jargs, **common)
    tr = hybrid_search(t(s["q"]), t(s["qt"]), t(s["qi"]), s["td"], s["tl"],
                       s["avgdl"], mask=tmask, use_kernel=False, block_size=256,
                       device="cpu", **targs, **common)
    return jr, tr


def _assert_same(jr, tr):
    """Fused ids equal; RRF scores equal to 1e-6 (rank arithmetic); branch
    scores within 1e-5 abs/rel."""
    np.testing.assert_array_equal(n(tr.indices), np.asarray(jr.indices))
    np.testing.assert_allclose(n(tr.scores), np.asarray(jr.scores), rtol=1e-6)
    for a, b in ((jr.dense_scores, tr.dense_scores), (jr.bm25_scores, tr.bm25_scores)):
        np.testing.assert_allclose(n(b), np.asarray(a), rtol=1e-5, atol=1e-5)


def _tied_lexical_docs(s, upto, rtol=1e-4):
    """Per query, the docs whose unrescored lexical score lies within
    ``rtol`` of another candidate's.  Their relative rank is set by the
    JAX package's f32 cumsum rounding (the port sums each run exactly),
    so either package may order them either way."""
    inv = jinv.build_inverted(s["terms"][:upto], s["tfs"][:upto], s["dl"][:upto],
                              V, postings_per_term=16, avgdl=s["avgdl"])
    lv, li = jinv.inverted_bm25_search(jnp.asarray(s["qt"]), jnp.asarray(s["qi"]),
                                       inv, k=ROWS)
    table = jbm25._idf_table(jnp.asarray(s["qt"]), jnp.asarray(s["qi"]), V)
    full = np.asarray(jbm25._bm25_block(table, s["jl"].terms, s["jl"].tfs,
                                        s["jl"].doc_len, jnp.float32(s["avgdl"]),
                                        1.2, 0.75))
    tied = []
    for r in range(len(s["qt"])):
        cand = {int(i): float(v) for i, v in zip(np.asarray(li)[r], np.asarray(lv)[r])
                if i >= 0}
        cand.update({i: float(full[r, i]) for i in range(upto, ROWS) if full[r, i] > 0})
        ids = np.array(list(cand), np.int64)
        vals = np.array([cand[i] for i in ids])
        close = np.abs(vals[:, None] - vals[None, :]) <= rtol * np.abs(vals)[:, None]
        tied.append(set(ids[close.sum(1) > 1].tolist()))
    return tied


def _assert_same_up_to_lexical_ties(jr, tr, tied):
    """With the tied docs taken out, one fused list is a prefix of the
    other (a tied doc leaving the top-k lets the next one in), and those
    docs carry equal fused scores."""
    compared = 0
    for r, tset in enumerate(tied):
        ja = [(int(i), float(v)) for i, v in zip(np.asarray(jr.indices)[r],
                                                 np.asarray(jr.scores)[r])]
        ta = [(int(i), float(v)) for i, v in zip(n(tr.indices)[r], n(tr.scores)[r])]
        ja = [x for x in ja if x[0] not in tset]
        ta = [x for x in ta if x[0] not in tset]
        m = min(len(ja), len(ta))
        assert [i for i, _ in ja[:m]] == [i for i, _ in ta[:m]], r
        np.testing.assert_allclose([v for _, v in ta[:m]], [v for _, v in ja[:m]],
                                   rtol=1e-6)
        compared += m
    assert compared >= len(tied)  # the check saw real results


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rescore", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_inverted_path(dtype, rescore, masked):
    s = _setup(dtype)
    res = _run_both(s, upto=ROWS, masked=masked, rescore=rescore,
                    postings_per_query_term=12)
    if rescore:  # exact BM25 of the pool: no cumsum rounding left
        _assert_same(*res)
    else:
        _assert_same_up_to_lexical_ties(*res, _tied_lexical_docs(s, ROWS))


@pytest.mark.parametrize("rescore", [True, False])
def test_inverted_with_fresh_tail(rescore):
    s = _setup("int8", seed=31)
    res = _run_both(s, upto=700, masked=True, rescore=rescore)
    if rescore:
        _assert_same(*res)
    else:
        _assert_same_up_to_lexical_ties(*res, _tied_lexical_docs(s, 700))


@pytest.mark.parametrize("opts", [dict(lex_gen=30, dense_gen=40),
                                  dict(lex_deep_terms=2, lex_deep_postings=16)])
def test_inverted_generation_depths(opts):
    s = _setup("int8", seed=32)
    _assert_same(*_run_both(s, upto=ROWS, **opts))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("masked", [False, True])
def test_doc_major_fallback(dtype, masked):
    s = _setup(dtype, seed=33)
    _assert_same(*_run_both(s, masked=masked, bm25_block_size=256))


def test_kernel_path_matches_blocked_path_when_exact():
    """With exact per-tile extraction and bf16 queries the fused path
    ranks as the blocked search does (plain version on the CPU)."""
    s = _setup("bf16", seed=34)
    common = dict(vocab_size=V, k=8, candidates=20, device="cpu")
    args = (t(s["q"]), t(s["qt"]), t(s["qi"]), s["td"], s["tl"], s["avgdl"])
    a = hybrid_search(*args, use_kernel=True, dense_tile=256, **common)
    b = hybrid_search(*args, use_kernel=False, block_size=256, **common)
    np.testing.assert_array_equal(n(a.indices), n(b.indices))
    np.testing.assert_allclose(n(a.dense_scores), n(b.dense_scores), rtol=1e-5,
                               atol=1e-5)


def test_unported_tiers_raise():
    """The IVF tier and dense_refine are ported (the tests below); the CSR
    lexical tier is not yet, and its compaction says so."""
    from super_rag_tpu_torch.engine.index import DeviceIndex, IndexSpec

    idx = DeviceIndex(IndexSpec(dim=DIM, vocab_size=V, lex_tier="csr",
                                min_capacity=256), device="cpu")
    idx.add(np.zeros((3, DIM), np.float32), ["a b", "b c", "c d"])
    with pytest.raises(NotImplementedError, match="A2"):
        idx.compact_lexical()


def _ivf_pair(s, dtype, seed=35):
    """The JAX IVF over the setup's rows and its port conversion."""
    rng = np.random.default_rng(seed)
    emb = np.asarray(s["jd"].values.astype(jnp.float32))
    if s["jd"].scales is not None:
        emb = emb * np.asarray(s["jd"].scales)[:, None]
    j = jivf.build_ivf(jnp.asarray(emb), nlist=16, dtype=DTYPES[dtype][0],
                       kmeans_iters=3, capacity_factor=1.2, seed=seed)
    return j, convert.ivf_from_jax(*ivf_arrays(j), device="cpu"), rng


@pytest.fixture
def interpret_pallas_ivf(monkeypatch):
    """The reference's IVF kernel in interpret mode (its CPU form); its
    hybrid_search imports the function inside its body, so the patch
    takes."""
    monkeypatch.setattr(jpivf, "pallas_ivf_topk",
                        functools.partial(jpivf.pallas_ivf_topk,
                                          interpret=True))


@pytest.mark.parametrize("tier", ["flat_scan", "kernel", "gather"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("masked", [False, True])
def test_ivf_tiers_match(tier, dtype, masked, interpret_pallas_ivf):
    """B = 6 queries, nlist 16: nprobe 3 reaches the whole-index scan
    (ivf_flat_topk, B * nprobe >= nlist); nprobe 2 takes the kernels
    (use_kernel / use_pallas: the plain versions / interpret mode) or the
    plain gather tier."""
    s = _setup(dtype, seed=36)
    j, p, _ = _ivf_pair(s, dtype)
    nprobe = 3 if tier == "flat_scan" else 2
    kernel = tier != "gather"
    jmask, tmask = ((jnp.asarray(s["mask"]), t(s["mask"])) if masked
                    else (None, None))
    jinv_ = jinv.build_inverted(s["terms"], s["tfs"], s["dl"], V,
                                postings_per_term=16, avgdl=s["avgdl"])
    tinv_ = tinv.build_inverted(t(s["terms"]), t(s["tfs"]), t(s["dl"]), V,
                                postings_per_term=16, avgdl=s["avgdl"])
    common = dict(vocab_size=V, k=8, candidates=20, nprobe=nprobe)
    jr = j_hybrid(jnp.asarray(s["q"]), jnp.asarray(s["qt"]), jnp.asarray(s["qi"]),
                  s["jd"], s["jl"], jnp.float32(s["avgdl"]), inverted=jinv_,
                  ivf=j, mask=jmask, use_pallas=kernel, **common)
    tr = hybrid_search(t(s["q"]), t(s["qt"]), t(s["qi"]), s["td"], s["tl"],
                       s["avgdl"], inverted=tinv_, ivf=p, mask=tmask,
                       use_kernel=kernel, device="cpu", **common)
    _assert_same(jr, tr)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kernel", [False, True])
def test_dense_refine_matches(masked, kernel):
    """The flat int8 pool re-scored with the corpus's error sign plane
    (dense_refine deepens the pool to 40)."""
    s = _setup("int8", seed=37)
    emb = np.random.default_rng(37).standard_normal((ROWS, DIM)).astype(
        np.float32)
    jd = jdense.build_corpus(jnp.asarray(emb), metric=jdense.Metric.DOT,
                             dtype=jnp.int8, error_signs=True)
    td = DenseCorpus(values=t(np.asarray(jd.values)),
                     scales=t(np.asarray(jd.scales)),
                     sign_plane=t(np.asarray(jd.sign_plane)))
    jmask, tmask = ((jnp.asarray(s["mask"]), t(s["mask"])) if masked
                    else (None, None))
    common = dict(vocab_size=V, k=8, candidates=20, dense_refine=40,
                  metric="ip")
    jr = j_hybrid(jnp.asarray(s["q"]), jnp.asarray(s["qt"]), jnp.asarray(s["qi"]),
                  jd, s["jl"], jnp.float32(s["avgdl"]), mask=jmask,
                  use_pallas=False, block_size=256, **common)
    tr = hybrid_search(t(s["q"]), t(s["qt"]), t(s["qi"]), td, s["tl"],
                       s["avgdl"], mask=tmask, use_kernel=kernel,
                       dense_tile=256, block_size=256, device="cpu", **common)
    _assert_same(jr, tr)
