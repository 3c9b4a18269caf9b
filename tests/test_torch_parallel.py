"""The port's sharded search (``super_rag_tpu_torch/parallel/``) on gloo ranks
against the JAX package's sharded programs on as many CPU devices: the
cases of ``tests/test_sharded.py`` and ``tests/test_multislice.py`` at
world 2, 4 and 2 x 2 (slice x corpus).

Tolerances: dense scores within 1e-5 (abs and rel; both packages take the
same f32 or exact int8 / bf16 products and sum them in another order),
ids equal except at such near-ties (``torch_parity.assert_topk_match``).
Hybrid results: fused ids equal, RRF scores to 1e-6 (rank arithmetic),
branch scores within 1e-5, as ``tests/test_torch_hybrid.py`` holds the
one-device path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_rank_cases as rc
from super_rag_tpu.engine.index import IndexSpec as JSpec
from super_rag_tpu.engine.sharded_index import ShardedDeviceIndex as JSharded
from super_rag_tpu.models.hash_embedder import HashEmbedder as JEmbedder
from super_rag_tpu.ops.dense import DenseCorpus as JCorpus, Metric as JMetric
from super_rag_tpu.ops.dense import build_corpus as jbuild
from super_rag_tpu.parallel.mesh import corpus_mesh as jcorpus_mesh
from super_rag_tpu.parallel.mesh import multislice_mesh as jmultislice_mesh
from super_rag_tpu.parallel.mesh import shard_corpus as jshard
from super_rag_tpu.parallel.sharded import sharded_dense_search as jsharded
from super_rag_tpu_torch.parallel.launch import spawn
from torch_parity import assert_topk_match

# world name -> (ranks, slices)
WORLDS = {"2": (2, 1), "4": (4, 1), "2x2": (4, 2)}


def _dense_cases() -> list:
    rng = np.random.default_rng(0)
    cases = []
    for metric in ("cosine", "ip", "l2"):
        cases.append({"name": f"dense_{metric}", "metric": metric, "dtype": "float32",
                      "corpus": rng.standard_normal((4096, 64)).astype(np.float32),
                      "queries": rng.standard_normal((4, 64)).astype(np.float32),
                      "k": 10, "block_size": 256})
    # 1,000 rows do not divide 8 (or 4 with the padding): padding never wins
    keep = np.zeros(1000, bool)
    keep[100:200] = True
    cases.append({"name": "dense_masked_padded", "metric": "cosine", "dtype": "float32",
                  "corpus": rng.standard_normal((1000, 32)).astype(np.float32),
                  "queries": rng.standard_normal((2, 32)).astype(np.float32),
                  "k": 7, "block_size": 128, "keep": keep})
    keep = np.zeros(1000, bool)
    keep[50:300] = True
    cases.append({"name": "dense_masked_wide", "metric": "cosine", "dtype": "float32",
                  "corpus": rng.standard_normal((1000, 32)).astype(np.float32),
                  "queries": rng.standard_normal((2, 32)).astype(np.float32),
                  "k": 7, "block_size": 128, "keep": keep})
    cases.append({"name": "dense_int8", "metric": "cosine", "dtype": "int8",
                  "corpus": rng.standard_normal((2048, 64)).astype(np.float32),
                  "queries": rng.standard_normal((3, 64)).astype(np.float32),
                  "k": 10, "block_size": 8192})
    cases.append({"name": "dense_bf16", "metric": "cosine", "dtype": "bfloat16",
                  "corpus": rng.standard_normal((2048, 128)).astype(np.float32),
                  "queries": rng.standard_normal((4, 128)).astype(np.float32),
                  "k": 10, "block_size": 256})
    return cases


DENSE = _dense_cases()
DOCS = [f"document {i} about topic{i % 13} and subject{i % 7}" for i in range(300)] + [
    "the quick brown fox jumps over the lazy dog",
    "TPU systolic arrays multiply matrices fast",
]
SPEC = {"dim": 64, "vocab_size": 1 << 14, "min_capacity": 2048}
QUERIES = ["fox jumping", "systolic matrices", "topic7 subject3"]


def _hybrid_scripts() -> list:
    emb = JEmbedder(dim=64)
    vec = np.asarray(emb.embed(DOCS))
    qv = np.asarray(emb.embed(QUERIES))
    ivf_docs = [f"ivf doc {i} about cluster{i % 16}" for i in range(800)]
    emb32 = JEmbedder(dim=32)
    ivf_vec = np.asarray(emb32.embed(ivf_docs))
    ivf_q = ["cluster7 document", "ivf doc 400"]
    ivf_qv = np.asarray(emb32.embed(ivf_q))
    search = {"emb": qv, "texts": QUERIES, "k": 5, "candidates": 20}
    return [
        {"name": "hybrid", "dtype": "float32", "spec": SPEC, "steps": [
            ("add", {"emb": vec, "texts": DOCS}),
            ("search", search),
            ("compact_lexical", {}),
            ("search", search),
            ("search", {"emb": qv[:1], "texts": QUERIES[:1], "k": 3}),
            ("delete_top", {}),
            ("search", {"emb": qv[:1], "texts": QUERIES[:1], "k": 3}),
        ]},
        {"name": "ivf", "dtype": "float32", "spec": dict(SPEC, dim=32), "steps": [
            ("add", {"emb": ivf_vec, "texts": ivf_docs}),
            ("search", {"emb": ivf_qv, "texts": ivf_q, "k": 5, "candidates": 20}),
            ("compact_dense", {"nlist": 4, "nprobe": 4, "kmeans_iters": 3}),
            ("search", {"emb": ivf_qv, "texts": ivf_q, "k": 5, "candidates": 20}),
        ]},
    ]


HYBRID = _hybrid_scripts()


def _jax_mesh(world: str):
    n, slices = WORLDS[world]
    devs = jax.devices()[:n]
    return jcorpus_mesh(devs) if slices == 1 else jmultislice_mesh(slices, devs)


def _jax_script(mesh, script: dict) -> list:
    """The JAX ``ShardedDeviceIndex`` through the same script."""
    spec = JSpec(**script["spec"], dtype=getattr(jnp, script["dtype"]))
    idx = JSharded(spec, mesh)
    out = []
    for op, kw in script["steps"]:
        if op == "add":
            out.append(("rows", idx.add(kw["emb"], kw["texts"])))
        elif op == "delete_top":
            idx.delete([int(np.asarray(out[-1][1].indices)[0, 0])])
        elif op == "compact_lexical":
            idx.compact_lexical(**kw)
        elif op == "compact_dense":
            idx.compact_dense(**kw)
        elif op == "search":
            kw = dict(kw)
            out.append(("search", idx.search_hybrid(kw.pop("emb"), kw.pop("texts"), **kw)))
    return out


@pytest.fixture(scope="module")
def port():
    """Every world's dense cases and hybrid scripts, one spawned group
    each (gloo, on the CPU)."""
    return {w: spawn(rc.parallel_cases, n, device="cpu", timeout_s=rc.SPAWN_TIMEOUT_S,
                     args=(slices, DENSE, HYBRID))
            for w, (n, slices) in WORLDS.items()}


@pytest.mark.parametrize("world", list(WORLDS))
def test_every_rank_returns_the_same_result(port, world):
    first, *rest = port[world]
    for other in rest:
        for case in DENSE:
            for a, b in zip(first[case["name"]], other[case["name"]]):
                assert torch_equal(a, b)
        for script in HYBRID:
            for (_, a), (_, b) in zip(first[script["name"]], other[script["name"]]):
                if isinstance(a, dict):
                    assert all(torch_equal(a[k], b[k]) for k in a)


def torch_equal(a, b) -> bool:
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("world", list(WORLDS))
def test_mesh_layout(port, world):
    n, slices = WORLDS[world]
    got = port[world][0]
    if slices == 1:
        assert got["axes"] == ("corpus",) and got["shape"] == {"corpus": n}
    else:
        assert got["axes"] == ("slice", "corpus")
        assert got["shape"] == {"slice": slices, "corpus": n // slices}
        assert _jax_mesh(world).shape == got["shape"]


@pytest.mark.parametrize("case", DENSE, ids=[c["name"] for c in DENSE])
@pytest.mark.parametrize("world", list(WORLDS))
def test_sharded_dense_matches_jax(port, world, case, eight_devices):
    mesh = _jax_mesh(world)
    corpus = jbuild(jnp.asarray(case["corpus"]), metric=JMetric(case["metric"]),
                    dtype=getattr(jnp, case["dtype"]))
    arrays = [corpus.values, corpus.scales, corpus.norms_sq]
    mask = None
    if case.get("keep") is not None:
        n_dev = mesh.devices.size
        keep = np.zeros(-(-len(case["keep"]) // n_dev) * n_dev, bool)
        keep[:len(case["keep"])] = case["keep"]
        arrays.append(jnp.asarray(keep))
    placed = jshard(mesh, *[a for a in arrays if a is not None])
    placed = list(placed) if isinstance(placed, tuple) else [placed]
    values = placed.pop(0)
    scales = placed.pop(0) if corpus.scales is not None else None
    norms = placed.pop(0) if corpus.norms_sq is not None else None
    mask = placed.pop(0) if case.get("keep") is not None else None
    jv, ji = jsharded(jnp.asarray(case["queries"]),
                      JCorpus(values=values, scales=scales, norms_sq=norms),
                      k=case["k"], mesh=mesh, metric=JMetric(case["metric"]),
                      mask=mask, block_size=case["block_size"])
    tv, ti = port[world][0][case["name"]]
    assert_topk_match(jv, ji, tv, ti, rtol=1e-5, atol=1e-5)
    if case.get("keep") is not None:
        allowed = np.flatnonzero(case["keep"])
        assert np.isin(np.asarray(ti), allowed).all()


def _assert_hybrid_same(jr, tr):
    np.testing.assert_array_equal(np.asarray(tr["indices"]), np.asarray(jr.indices))
    np.testing.assert_allclose(np.asarray(tr["scores"]), np.asarray(jr.scores), rtol=1e-6)
    for a, b in ((jr.dense_scores, tr["dense"]), (jr.bm25_scores, tr["bm25"])):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("world", list(WORLDS))
def test_sharded_hybrid_index_matches_jax(port, world, eight_devices):
    """Flat, after lexical compaction (per-shard postings + exact
    rescore), and after deleting the first hit (gone from the result)."""
    script = HYBRID[0]
    want = _jax_script(_jax_mesh(world), script)
    got = port[world][0][script["name"]]
    assert [op for op, _ in got] == [op for op, _ in want]
    for (op, tr), (_, jr) in zip(got, want):
        if op == "rows":
            assert tr == jr
        else:
            _assert_hybrid_same(jr, tr)
    first, deleted = got[-2][1], got[-1][1]
    assert int(first["indices"][0, 0]) not in np.asarray(deleted["indices"])[0].tolist()


@pytest.mark.parametrize("world", list(WORLDS))
def test_sharded_hybrid_equals_one_device(port, world):
    """The sharded index answers as the port's one-device DeviceIndex
    (before compaction both take the exact doc-major lexical scan)."""
    script = HYBRID[0]
    gold = rc.one_device_script({**script, "steps": script["steps"][:2]})
    tr = port[world][0][script["name"]][1][1]
    np.testing.assert_array_equal(np.asarray(tr["indices"]), np.asarray(gold[0]["indices"]))
    np.testing.assert_allclose(np.asarray(tr["scores"]), np.asarray(gold[0]["scores"]),
                               rtol=1e-6)


@pytest.mark.parametrize("world", list(WORLDS))
def test_sharded_ivf_exact_at_full_nprobe(port, world, eight_devices):
    """Per-shard IVF at nprobe = nlist returns the flat winners, as the
    JAX package's does."""
    script = HYBRID[1]
    got = port[world][0][script["name"]]
    flat, ivf = got[1][1], got[2][1]
    want = _jax_script(_jax_mesh(world), script)
    for r in range(2):
        tset = set(np.asarray(ivf["indices"])[r].tolist())
        assert tset == set(np.asarray(flat["indices"])[r].tolist())
        assert tset == set(np.asarray(want[2][1].indices)[r].tolist())
