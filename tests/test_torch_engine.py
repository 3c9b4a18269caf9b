"""The PyTorch port's DeviceIndex, snapshots and CollectionEngine +
QueryBatcher against the JAX package, on the same texts and embeddings."""

import asyncio
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_rag_tpu.engine import index as jindex
from super_rag_tpu.engine import snapshot as jsnap
from super_rag_tpu.models.hash_embedder import HashEmbedder as JaxHashEmbedder
from super_rag_tpu_torch import convert
from super_rag_tpu_torch.engine import index as tindex
from super_rag_tpu_torch.engine import snapshot as tsnap
from super_rag_tpu_torch.engine.batcher import QueryBatcher
from super_rag_tpu_torch.engine.collection import CollectionEngine
from super_rag_tpu_torch.models.hash_embedder import HashEmbedder
from super_rag_tpu_torch.ops import ivf_topk as tit
from torch_parity import all_scores, assert_topk_match, ivf_arrays, n

V = 1 << 12
DIM = 32


def _texts(rng, count):
    words = [f"w{i}" for i in range(300)]
    p = 1.0 / np.arange(1, 301) ** 1.1
    p /= p.sum()
    return [" ".join(rng.choice(words, rng.integers(4, 14), p=p))
            for _ in range(count)]


def _pair(dtype="int8", metric="cosine", seed=40):
    """A JAX and a port index fed the same adds, deletes and compactions:
    rows [0, 420) compacted into postings, 150 fresh rows after, deletes
    in both (duplicates, a dead row and an out-of-range row included)."""
    rng = np.random.default_rng(seed)
    jdt = {"int8": jnp.int8, "bf16": jnp.bfloat16, "f32": jnp.float32}[dtype]
    tdt = {"int8": torch.int8, "bf16": torch.bfloat16, "f32": torch.float32}[dtype]
    j = jindex.DeviceIndex(jindex.IndexSpec(dim=DIM, dtype=jdt,
                                            metric=jindex.Metric(metric),
                                            bm25_slots=12, vocab_size=V,
                                            min_capacity=512))
    p = tindex.DeviceIndex(tindex.IndexSpec(dim=DIM, dtype=tdt,
                                            metric=tindex.Metric(metric),
                                            bm25_slots=12, vocab_size=V,
                                            min_capacity=512), device="cpu")
    for idx in (j, p):
        idx.auto_compact_rows = 400
    texts = _texts(rng, 570)
    emb = rng.standard_normal((570, DIM)).astype(np.float32)
    for lo, hi, kw in ((0, 300, {}), (300, 420, {"chat_id": "c1"}),
                       (420, 570, {"indexer": "summary"})):
        for idx in (j, p):
            assert idx.add(emb[lo:hi], texts[lo:hi], **kw) == list(range(lo, hi))
        if hi == 420:
            for idx in (j, p):
                idx.compact_lexical()
    for idx in (j, p):
        idx.delete([5, 5, 17, 450, 9999])
        idx.delete([17, 33])  # 17 is dead already
    return j, p, texts, emb, rng


def test_index_state_matches_after_adds_deletes_and_compaction():
    j, p, *_ = _pair()
    assert p._capacity == j._capacity and p.size == j.size
    assert p.df.state() == j.df.state()
    assert p.row_meta == j.row_meta
    ja, jh = j.snapshot_state()
    pa, ph = p.snapshot_state()
    assert set(ja) == set(pa) and jh == ph
    for k in ja:
        np.testing.assert_array_equal(pa[k], ja[k], err_msg=k)
    np.testing.assert_array_equal(n(p._inverted.postings_ids),
                                  np.asarray(j._inverted.postings_ids))
    assert p._inverted_upto == j._inverted_upto == 420


def test_delete_semantics():
    """df drops once per live row; dead and out-of-range rows are ignored.
    Negative ids are ignored too (a kept difference: the reference clears
    the last row's metadata and df entry but leaves its validity bit set,
    half-deleting it)."""
    j, p, texts, emb, _ = _pair(seed=41)
    before = p.df.num_docs
    p.delete([0, 0, 5, 123456])  # 5 is dead already
    assert p.df.num_docs == before - 1
    assert not bool(p.valid[0]) and p.row_meta[0] is None
    j.delete([0, 0, 5, 123456])
    assert p.df.state() == j.df.state()
    last = p.size - 1
    state = p.df.state()
    p.delete([-1, -p.size])
    assert p.df.state() == state and p.live_count == j.live_count
    assert bool(p.valid[last]) and p.row_meta[last] is not None
    j.delete([-1])
    assert j.row_meta[last] is None and bool(np.asarray(j.valid)[last])


def test_live_count_matches():
    """Rows added and not deleted, after adds, deletes (duplicates, dead
    and out-of-range rows included) and more adds."""
    j, p, texts, emb, _ = _pair(seed=45)
    assert p.live_count == j.live_count == 570 - 4
    for idx in (j, p):
        idx.delete([0, 1, 1, 17, 569, 10 ** 6])
    assert p.live_count == j.live_count == 570 - 4 - 3
    for idx in (j, p):
        idx.add(emb[:7], texts[:7])
    assert p.live_count == j.live_count == 570 - 4 - 3 + 7


@pytest.mark.parametrize("dtype,metric", [("int8", "cosine"), ("bf16", "cosine"),
                                          ("f32", "l2"), ("int8", "ip")])
@pytest.mark.parametrize("flt", [None, "chat", "indexer", "rows"])
def test_search_hybrid_matches(dtype, metric, flt):
    """Fused ids equal and RRF scores within 1e-6 (the exact rescore
    leaves no summation noise), with the fresh tail and filters."""
    j, p, texts, emb, rng = _pair(dtype, metric, seed=42)
    queries = [" ".join(t.split()[:3]) for t in texts[::97]]
    q = (emb[::97] + 0.2 * rng.standard_normal((len(queries), DIM))).astype(np.float32)
    jf = pf = None
    if flt == "chat":
        jf = jindex.FilterSpec(chat_hash=jindex._chat_hash("c1"))
        pf = tindex.FilterSpec(chat_hash=tindex._chat_hash("c1"))
    elif flt == "indexer":
        jf = jindex.FilterSpec(indexers=frozenset({1}))
        pf = tindex.FilterSpec(indexers=frozenset({1}))
    elif flt == "rows":
        jf = jindex.FilterSpec(doc_rows=tuple(range(100, 500)))
        pf = tindex.FilterSpec(doc_rows=tuple(range(100, 500)))
    jr = j.search_hybrid(jnp.asarray(q), queries, k=8, candidates=24, flt=jf)
    tr = p.search_hybrid(torch.from_numpy(q), queries, k=8, candidates=24, flt=pf)
    np.testing.assert_array_equal(n(tr.indices), np.asarray(jr.indices))
    np.testing.assert_allclose(n(tr.scores), np.asarray(jr.scores), rtol=1e-6)
    np.testing.assert_allclose(n(tr.bm25_scores), np.asarray(jr.bm25_scores),
                               rtol=1e-5, atol=1e-5)


def test_search_dense_and_bm25_match():
    """search_dense within 1e-5; search_bm25 (unrescored postings + tail)
    within the JAX package's f32 cumsum error, ids up to near-ties."""
    j, p, texts, emb, rng = _pair(seed=43)
    q = emb[:6] + 0.1
    rows = j.size
    assert_topk_match(*j.search_dense(jnp.asarray(q), 10),
                      *p.search_dense(torch.from_numpy(q), 10),
                      scores=all_scores(*j.search_dense(jnp.asarray(q), rows),
                                        rows))
    queries = [" ".join(t.split()[:4]) for t in texts[::91]]
    jv, ji = j.search_bm25(queries, 10)
    pv, pi = p.search_bm25(queries, 10)
    assert_topk_match(jv, ji, pv, pi, rtol=1e-4, atol=1e-4,
                      scores=all_scores(*j.search_bm25(queries, rows), rows))


def test_uncompacted_index_uses_doc_major_fallback():
    rng = np.random.default_rng(44)
    texts = _texts(rng, 100)
    emb = rng.standard_normal((100, DIM)).astype(np.float32)
    j = jindex.DeviceIndex(jindex.IndexSpec(dim=DIM, vocab_size=V, min_capacity=256))
    p = tindex.DeviceIndex(tindex.IndexSpec(dim=DIM, vocab_size=V, min_capacity=256),
                           device="cpu")
    j.add(emb, texts)
    p.add(emb, texts)
    queries = [texts[3][:20], texts[50][:25]]
    jr = j.search_hybrid(jnp.asarray(emb[[3, 50]]), queries, k=5, candidates=10)
    tr = p.search_hybrid(torch.from_numpy(emb[[3, 50]]), queries, k=5, candidates=10)
    assert p._inverted is None
    np.testing.assert_array_equal(n(tr.indices), np.asarray(jr.indices))


def test_calibrate_per_tile_k_matches():
    """The per-tile cap guard picks the same cap as the JAX package (which
    runs its Pallas kernel in interpret mode off the TPU)."""
    rng = np.random.default_rng(45)
    base = rng.standard_normal((8, DIM)).astype(np.float32)
    emb = (base[rng.integers(0, 8, 1500)]
           + 0.05 * rng.standard_normal((1500, DIM))).astype(np.float32)
    texts = ["x"] * 1500
    j = jindex.DeviceIndex(jindex.IndexSpec(dim=DIM, dtype=jnp.int8, vocab_size=V,
                                            min_capacity=256))
    p = tindex.DeviceIndex(tindex.IndexSpec(dim=DIM, dtype=torch.int8, vocab_size=V,
                                            min_capacity=256), device="cpu")
    j.add(emb, texts)
    p.add(emb, texts)
    assert p.calibrate_per_tile_k(sample=8, cand=40) == j.calibrate_per_tile_k(
        sample=8, cand=40)


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_snapshot_from_jax_state_answers_alike(dtype):
    j, _, texts, emb, _ = _pair(dtype, seed=46)
    arrays, host = j.snapshot_state()
    p = convert.index_from_jax_snapshot(arrays, host, device="cpu")
    j2 = jindex.DeviceIndex.from_snapshot(arrays, host)
    for idx in (p, j2):
        idx.compact_lexical()
    queries = [" ".join(t.split()[:3]) for t in texts[::113]]
    q = emb[::113]
    jr = j2.search_hybrid(jnp.asarray(q), queries, k=6, candidates=20)
    tr = p.search_hybrid(torch.from_numpy(q), queries, k=6, candidates=20)
    np.testing.assert_array_equal(n(tr.indices), np.asarray(jr.indices))


def test_convert_rejects_a_malformed_snapshot():
    j, *_ = _pair(seed=47)
    arrays, host = j.snapshot_state()
    bad = dict(arrays, terms=arrays["terms"].astype(np.int64))
    with pytest.raises(ValueError, match="terms"):
        convert.index_from_jax_snapshot(bad, host, device="cpu")
    bad = {k: v for k, v in arrays.items() if k != "scales"}
    with pytest.raises(ValueError, match="scales"):
        convert.index_from_jax_snapshot(bad, host, device="cpu")


def test_snapshot_files_cross_both_ways(tmp_path):
    j, p, *_ = _pair("bf16", seed=48)
    tsnap.save_index(p, str(tmp_path / "port"))
    jsnap.save_index(j, str(tmp_path / "jax"))
    from_port = jsnap.load_index(str(tmp_path / "port"))
    from_jax = tsnap.load_index(str(tmp_path / "jax"), device="cpu")
    for a, b in ((from_port.snapshot_state(), j.snapshot_state()),
                 (from_jax.snapshot_state(), p.snapshot_state())):
        assert a[1] == b[1]
        for k in b[0]:
            np.testing.assert_array_equal(a[0][k], b[0][k], err_msg=k)


def test_engine_and_batcher_answer_concurrent_requests_as_direct_calls():
    rng = np.random.default_rng(49)
    texts = _texts(rng, 300)
    eng = CollectionEngine(tindex.IndexSpec(dim=DIM, dtype=torch.int8,
                                            vocab_size=V, min_capacity=256),
                           device="cpu")
    eng.ingest(texts)
    eng.ingest(texts[:20], chat_id="c9")
    queries = [" ".join(t.split()[:3]) for t in texts[:40]]
    batcher = QueryBatcher(max_batch=16)

    async def many():
        return await asyncio.gather(*(batcher.search(eng, q, top_k=5) for q in queries))

    try:
        got = asyncio.run(many())
        stats = batcher.stats()
    finally:
        batcher.close()
    assert stats["queries"] == 40 and stats["dispatches"] < 40
    for q, hits in zip(queries, got):
        want = eng.search(q, top_k=5)
        assert [(h.row, h.score) for h in hits] == [(h.row, h.score) for h in want]
        assert hits and hits[0].recall_type == "hybrid"
    assert not any(th.name.startswith("batcher") for th in threading.enumerate())


def test_engine_modes_and_rerank():
    rng = np.random.default_rng(50)
    texts = _texts(rng, 120)
    eng = CollectionEngine(tindex.IndexSpec(dim=DIM, vocab_size=V, min_capacity=256),
                           reranker=lambda q, ts: np.array([-len(t) for t in ts]),
                           device="cpu")
    eng.ingest(texts)
    q = texts[7]
    dense = eng.search(q, top_k=3, mode="dense")
    assert dense[0].row == 7 and dense[0].recall_type == "vector_search"
    full = eng.search(q, top_k=3, mode="fulltext")
    assert full and full[0].recall_type == "fulltext_search"
    rr = eng.search(q, top_k=4, rerank=True)
    assert len(rr) == 4 and all(h.recall_type == "reranked" for h in rr)
    eng.delete([7])
    assert all(h.row != 7 for h in eng.search(q, top_k=5, mode="dense"))


class _TableEmbedder:
    """Fixed numpy embeddings by text (zeros for the batch's pad ""), so
    both packages' engines search with the same query bits."""

    def __init__(self, texts, emb):
        self.table = dict(zip(texts, emb))

    def embed(self, texts):
        return np.stack([self.table.get(t, np.zeros(DIM, np.float32))
                         for t in texts])


# the five ``hybrid`` config keys that the reference's EngineManager.get
# forwards to CollectionEngine(hybrid_opts=...)
MANAGER_HYBRID_OPTS = {"rescore": True, "postings_per_query_term": 48,
                       "lex_deep_terms": 2, "lex_deep_postings": 96,
                       "lex_approx_topk": True}


@pytest.mark.parametrize("approx", [False, True])
def test_engine_takes_the_managers_hybrid_opts(approx):
    """A CollectionEngine built with all five of the manager's hybrid keys
    answers as the reference's does, over the indexes of ``_pair`` (the
    port's top-k is exact where the reference may take approx_max_k; on
    the CPU the reference is exact too): the same rows, scores within
    1e-6.  ``rescore`` stays on: unrescored lexical ranks of tied docs
    may differ (the kept difference "Lexical tie order")."""
    from super_rag_tpu.engine.collection import CollectionEngine as JEngine

    j, p, texts, emb, rng = _pair(seed=42)
    queries = [" ".join(t.split()[:3]) for t in texts[::97]]
    qemb = (emb[::97] + 0.2 * rng.standard_normal((len(queries), DIM))).astype(
        np.float32)
    embedder = _TableEmbedder(queries, qemb)
    opts = dict(MANAGER_HYBRID_OPTS, lex_approx_topk=approx)
    jeng = JEngine(j.spec, embedder=embedder, hybrid_opts=opts)
    peng = CollectionEngine(p.spec, embedder=embedder, hybrid_opts=opts,
                            device="cpu")
    jeng.index, peng.index = j, p
    got = peng.search_batch(queries, top_k=8)
    want = jeng.search_batch(queries, top_k=8)
    assert sum(len(g) for g in got) == 8 * len(queries)
    for g, w in zip(got, want):
        assert [h.row for h in g] == [h.row for h in w]
        np.testing.assert_allclose([h.score for h in g], [h.score for h in w],
                                   rtol=1e-6)


EMBED_TEXTS = ["alpha beta gamma", "", "beta beta beta",
               " ".join(f"w{i}" for i in range(90)),  # past max_terms
               "The quick brown fox jumps over the lazy dog"]


def test_hash_embedder_matches_jax():
    """Same projection table and analyzer: embeddings within 1e-6 abs
    (the two packages sum the term rows and the norm in other orders)."""
    got = HashEmbedder(dim=48, device="cpu").embed(EMBED_TEXTS)
    want = np.asarray(JaxHashEmbedder(dim=48).embed(EMBED_TEXTS))
    assert got.dtype == torch.float32 and got.shape == (len(EMBED_TEXTS), 48)
    np.testing.assert_allclose(n(got), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("i", range(len(EMBED_TEXTS)))
def test_hash_embedder_is_batch_invariant(i):
    """A text embeds to the same bits alone and in any batch."""
    emb = HashEmbedder(dim=48, device="cpu")
    batch = emb.embed(EMBED_TEXTS)
    assert torch.equal(emb.embed([EMBED_TEXTS[i]])[0], batch[i])
    assert torch.equal(emb.embed(EMBED_TEXTS[::-1])[len(EMBED_TEXTS) - 1 - i],
                       batch[i])


# -- the IVF tier ------------------------------------------------------------------


def _ivf_pair(dtype="int8", nlist=8, nprobe=1, seed=60, **kw):
    """``_pair`` plus ``compact_dense`` in both packages."""
    j, p, texts, emb, rng = _pair(dtype, seed=seed)
    for idx in (j, p):
        idx.compact_dense(nlist=nlist, nprobe=nprobe, kmeans_iters=4, **kw)
    return j, p, texts, emb, rng


def _use_jax_build(j, p):
    """Search parity on one index: the port's snapshot becomes the JAX
    build, converted (build noise is held by its own test)."""
    p._ivf = convert.ivf_from_jax(*ivf_arrays(j._ivf), device="cpu")


@pytest.mark.parametrize("dtype", ["int8", "bf16", "f32"])
def test_compact_dense_builds_alike(dtype):
    """Live rows only (the deleted ones are left out), the same placement;
    stored numbers within the build tolerances of test_torch_ivf.py."""
    j, p, *_ = _ivf_pair(dtype)
    assert p._ivf_upto == j._ivf_upto == p.size and p._ivf_churn == 0
    placed = n(p._ivf.row_ids)
    np.testing.assert_array_equal(placed, np.asarray(j._ivf.row_ids))
    assert not np.isin([5, 17, 33, 450], placed).any()
    np.testing.assert_allclose(n(p._ivf.centroids),
                               np.asarray(j._ivf.centroids), atol=1e-6)


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("fresh_tail", [False, True])
@pytest.mark.parametrize("flt", [None, "indexer"])
def test_ivf_search_dense_matches(dtype, fresh_tail, flt):
    """search_dense through the IVF (plain gather tier off the card), with
    rows added after the snapshot scanned flat and merged in."""
    j, p, texts, emb, rng = _ivf_pair(dtype, nprobe=2)
    _use_jax_build(j, p)
    if fresh_tail:
        extra = rng.standard_normal((30, DIM)).astype(np.float32)
        for idx in (j, p):
            idx.add(extra, texts[:30], indexer="summary")
        assert p._ivf_upto < p.size
    jf = pf = None
    if flt == "indexer":
        jf = jindex.FilterSpec(indexers=frozenset({1}))
        pf = tindex.FilterSpec(indexers=frozenset({1}))
    q = (emb[::61] + 0.1 * rng.standard_normal((len(emb[::61]), DIM))).astype(
        np.float32)
    assert_topk_match(*j.search_dense(jnp.asarray(q), 10, flt=jf),
                      *p.search_dense(torch.from_numpy(q), 10, flt=pf),
                      rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("nprobe", [1, 2])  # gather tier; whole-index scan
@pytest.mark.parametrize("fresh_tail", [False, True])
def test_ivf_search_hybrid_matches(nprobe, fresh_tail):
    """search_hybrid hands the IVF to the dense branch only while it covers
    every row; fused ids equal, RRF scores within 1e-6."""
    j, p, texts, emb, rng = _ivf_pair("int8", nprobe=nprobe)
    _use_jax_build(j, p)
    if fresh_tail:
        for idx in (j, p):
            idx.add(emb[:20] + 0.01, texts[:20])
    queries = [" ".join(t.split()[:3]) for t in texts[::97]]
    q = (emb[::97] + 0.2 * rng.standard_normal((len(queries), DIM))).astype(
        np.float32)
    jr = j.search_hybrid(jnp.asarray(q), queries, k=8, candidates=24)
    tr = p.search_hybrid(torch.from_numpy(q), queries, k=8, candidates=24)
    np.testing.assert_array_equal(n(tr.indices), np.asarray(jr.indices))
    np.testing.assert_allclose(n(tr.scores), np.asarray(jr.scores), rtol=1e-6)
    np.testing.assert_allclose(n(tr.dense_scores), np.asarray(jr.dense_scores),
                               rtol=1e-5, atol=1e-5)


def test_churn_reclusters_alike():
    """Inserts + deletes past max(auto_compact_rows, 20 % of the snapshot)
    re-cluster at the next query, with the same settings, in both."""
    j, p, texts, emb, rng = _ivf_pair("int8", nprobe=2)
    for idx in (j, p):
        idx.auto_compact_rows = 100
        idx.delete(list(range(40, 100)))
        idx.add(emb[:60] * 1.1, texts[:60])
    assert p._ivf_churn == j._ivf_churn == 120 and p._ivf_upto < p.size
    for idx in (j, p):
        idx.search_bm25(["w1"], 3)
    assert p._ivf_churn == j._ivf_churn == 0
    assert p._ivf_upto == j._ivf_upto == p.size
    assert p._ivf_nlist == j._ivf_nlist == 8
    np.testing.assert_array_equal(n(p._ivf.row_ids),
                                  np.asarray(j._ivf.row_ids))


@pytest.mark.parametrize("target", [0.5, 0.99])
def test_calibrate_nprobe_matches(target):
    """The recall-target search doubles nprobe from 1 to the same choice."""
    j, p, *_ = _ivf_pair("int8", nprobe=1, recall_target=target,
                         calib_sample=16, calib_k=5)
    assert p._ivf_nprobe == j._ivf_nprobe


def test_batcher_on_the_ivf_tier_answers_as_direct_calls_of_its_batches():
    """The union route (``use_kernel``: its plain version on the CPU;
    B * nprobe < nlist) scores each query against its batch's probe union
    (the reference's semantics), so a served answer is compared with a
    direct search_batch of the batch it was dispatched in."""
    rng = np.random.default_rng(61)
    texts = _texts(rng, 400)
    eng = CollectionEngine(tindex.IndexSpec(dim=DIM, dtype=torch.int8,
                                            vocab_size=V, min_capacity=256),
                           hybrid_opts={"use_kernel": True}, device="cpu")
    eng.ingest(texts)
    eng.index.compact_lexical()
    eng.index.compact_dense(nlist=16, nprobe=1)
    batches = []
    direct = eng.search_batch

    def recording(queries, **kw):
        batches.append((list(queries), kw))
        return direct(queries, **kw)

    eng.search_batch = recording
    queries = list(dict.fromkeys(" ".join(t.split()[:3]) for t in texts))[:40]
    batcher = QueryBatcher(max_batch=8)

    async def many():
        return await asyncio.gather(*(batcher.search(eng, q, top_k=5)
                                      for q in queries))

    before = (tit.union_tc_launches.count, tit.union_simt_launches.count)
    try:
        got = dict(zip(queries, asyncio.run(many())))
    finally:
        batcher.close()
    # plain versions on the CPU
    assert (tit.union_tc_launches.count, tit.union_simt_launches.count) == before
    assert 1 < len(batches) < 40 and sum(len(b) for b, _ in batches) == 40
    for qs, kw in batches:
        for q, want in zip(qs, direct(qs, **kw)):
            assert ([(h.row, h.score) for h in got[q]]
                    == [(h.row, h.score) for h in want])
