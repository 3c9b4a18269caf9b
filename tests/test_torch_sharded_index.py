"""The port's ``ShardedDeviceIndex`` on four gloo ranks: the cases of
``tests/test_sharded_index.py`` (placement, growth, int8, deletes,
filters, ``doc_rows``, lexical compaction, the fresh tail, the IVF tier,
snapshots), each against the JAX package's ``ShardedDeviceIndex`` on four
CPU devices or the port's one-device ``DeviceIndex``, and a JAX snapshot
restored in the port.

Tolerances: fused ids equal and RRF scores to 1e-6 against the JAX
sharded index (rank arithmetic), branch scores within 1e-5; stored rows
equal exactly (the same f32 normalisation and int8 quantization).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_rank_cases as rc
from super_rag_tpu.engine.index import FilterSpec as JFilter
from super_rag_tpu.engine.index import IndexSpec as JSpec
from super_rag_tpu.engine.index import INDEXER_CODES, _chat_hash
from super_rag_tpu.engine.sharded_index import ShardedDeviceIndex as JSharded
from super_rag_tpu.models.hash_embedder import HashEmbedder as JEmbedder
from super_rag_tpu.parallel.mesh import corpus_mesh as jcorpus_mesh
from super_rag_tpu_torch.parallel.launch import spawn

WORLD = 4
DOCS = [f"document {i} about topic{i % 13} and subject{i % 7}" for i in range(200)] + [
    "the quick brown fox jumps over the lazy dog",
    "TPU systolic arrays multiply matrices fast",
]
SPEC64 = {"dim": 64, "vocab_size": 1 << 14, "min_capacity": 2048}
SPEC32 = dict(SPEC64, dim=32)
E64, E32 = JEmbedder(dim=64), JEmbedder(dim=32)


def emb64(texts):
    return np.asarray(E64.embed(texts))


def emb32(texts):
    return np.asarray(E32.embed(texts))


def search(texts, emb=emb64, **kw):
    return ("search", {"emb": emb(texts), "texts": texts, **kw})


Q3 = ["fox jumping", "systolic matrices", "topic7 subject3"]
Q2 = ["fox jumping", "systolic matrices"]
ALLOW = tuple(range(0, len(DOCS), 3))
GROWTH = [[f"growth batch {b} doc {i}" for i in range(1200)] for b in range(3)]
TAIL_DOCS = ["fresh fox tail row", "another fresh fox row"]
IVF_DOCS = [f"ivf doc {i} about cluster{i % 16}" for i in range(800)]
IVF_Q = ["cluster7 document", "ivf doc 400"]
_rng = np.random.default_rng(5)
INT8_ROWS = _rng.standard_normal((4000, 32)).astype(np.float32)
INT8_Q = (INT8_ROWS[_rng.integers(0, 4000, 8)]
          + 0.1 * _rng.standard_normal((8, 32))).astype(np.float32)

SCRIPTS = [
    {"name": "pair", "dtype": "float32", "spec": SPEC64, "steps": [
        ("add", {"emb": emb64(DOCS), "texts": DOCS}),
        ("state", {}),
        search(Q3, k=5, candidates=20),
        ("kernel_vs_plain", {"emb": emb64(Q2 + ["topic7 subject3"]),
                             "texts": Q2 + ["topic7 subject3"], "k": 5, "candidates": 20}),
        ("snapshot", {"emb": emb64(Q2), "texts": Q2, "k": 5, "candidates": 20}),
        search(Q2, k=5, candidates=20),
        ("compact_lexical", {"postings_per_term": 64}),
        ("state", {}),
        search(Q2, k=5, candidates=20),
        search(Q2[:1], k=3),
        ("delete_top", {}),
        search(Q2[:1], k=3),
    ]},
    {"name": "growth", "dtype": "float32", "spec": SPEC32, "steps": [
        *(("add", {"emb": emb32(d), "texts": d}) for d in GROWTH),
        ("state", {}),
        search(["growth batch 2 doc 7"], emb=emb32, k=3),
    ]},
    {"name": "int8", "dtype": "int8", "spec": SPEC32, "steps": [
        ("add", {"emb": emb32([f"int8 sharded doc {i}" for i in range(100)]),
                 "texts": [f"int8 sharded doc {i}" for i in range(100)]}),
        ("state", {}),
        search(["int8 sharded doc 42"], emb=emb32, k=1),
    ]},
    {"name": "filters", "dtype": "float32", "spec": SPEC64, "steps": [
        ("add", {"emb": emb64(DOCS[:50]), "texts": DOCS[:50]}),
        ("add", {"emb": emb64(["summary of everything fox"]),
                 "texts": ["summary of everything fox"], "indexer": "summary"}),
        ("add", {"emb": emb64(["chat scoped fox document"]),
                 "texts": ["chat scoped fox document"], "chat_id": "chat-1"}),
        search(["fox"], k=3, candidates=10,
               flt={"indexers": frozenset({INDEXER_CODES["summary"]})}),
        search(["fox"], k=52, candidates=60, flt={"chat_hash": _chat_hash("chat-2")}),
    ]},
    {"name": "doc_rows", "dtype": "float32", "spec": SPEC64, "steps": [
        ("add", {"emb": emb64(DOCS), "texts": DOCS}),
        search(["fox jumping"], k=5, flt={"doc_rows": ALLOW}),
        ("compact_lexical", {"postings_per_term": 64}),
        ("add", {"emb": emb64(TAIL_DOCS), "texts": TAIL_DOCS}),
        search(["fox jumping"], k=5, flt={"doc_rows": ALLOW}),
        search(["fox jumping"], k=5, flt={"doc_rows": ALLOW + (len(DOCS), len(DOCS) + 1)}),
    ]},
    {"name": "tail", "dtype": "float32", "spec": SPEC32, "steps": [
        ("add", {"emb": emb32([f"base doc {i} about topic{i % 5}" for i in range(100)]),
                 "texts": [f"base doc {i} about topic{i % 5}" for i in range(100)]}),
        ("compact_lexical", {"postings_per_term": 64}),
        ("add", {"emb": emb32(["a rare quokka grazes peacefully"]),
                 "texts": ["a rare quokka grazes peacefully"]}),
        ("state", {}),
        search(["quokka grazing"], emb=emb32, k=3),
        ("search", {"emb": emb32(["topic3 base"]), "texts": ["topic3 base doc"], "k": 3}),
        ("delete", {"rows": [100]}),
        search(["quokka grazing"], emb=emb32, k=3),
    ]},
    {"name": "ivf", "dtype": "float32", "spec": SPEC32, "steps": [
        ("add", {"emb": emb32(IVF_DOCS), "texts": IVF_DOCS}),
        search(IVF_Q, emb=emb32, k=5, candidates=20),
        ("compact_dense", {"nlist": 4, "nprobe": 4, "kmeans_iters": 3}),
        ("state", {}),
        search(IVF_Q, emb=emb32, k=5, candidates=20),
    ]},
    {"name": "ivf_int8", "dtype": "int8", "spec": dict(SPEC32, min_capacity=4096), "steps": [
        ("add", {"emb": INT8_ROWS, "texts": [f"doc {i}" for i in range(4000)]}),
        ("search", {"emb": INT8_Q, "texts": ["x"] * 8, "k": 10, "candidates": 32}),
        ("compact_dense", {"nlist": 16, "nprobe": 8, "kmeans_iters": 4}),
        ("search", {"emb": INT8_Q, "texts": ["x"] * 8, "k": 10, "candidates": 32}),
    ]},
]
BY_NAME = {s["name"]: s for s in SCRIPTS}


def _jax_run(script: dict, mesh) -> tuple:
    """The JAX ShardedDeviceIndex through a script's adds, deletes,
    compactions and searches: ``(search results, the index)``."""
    spec = JSpec(**script["spec"], dtype=getattr(jnp, script["dtype"]))
    idx = JSharded(spec, mesh)
    out = []
    for op, kw in script["steps"]:
        if op == "add":
            idx.add(kw["emb"], kw["texts"], indexer=kw.get("indexer", "vector"),
                    chat_id=kw.get("chat_id"))
        elif op == "delete":
            idx.delete(kw["rows"])
        elif op == "delete_top":
            idx.delete([int(np.asarray(out[-1].indices)[0, 0])])
        elif op == "compact_lexical":
            idx.compact_lexical(**kw)
        elif op == "compact_dense":
            idx.compact_dense(**kw)
        elif op == "search":
            kw = dict(kw)
            flt = kw.pop("flt", None)
            out.append(idx.search_hybrid(kw.pop("emb"), kw.pop("texts"),
                                         flt=JFilter(**flt) if flt else None, **kw))
    return out, idx


@pytest.fixture(scope="module")
def jmesh(eight_devices):
    return jcorpus_mesh(eight_devices[:WORLD])


@pytest.fixture(scope="module")
def jax_snapshot(jmesh):
    """A JAX sharded index's snapshot, for the port to restore."""
    spec = JSpec(**SPEC64, dtype=jnp.float32)
    idx = JSharded(spec, jmesh)
    idx.add(emb64(DOCS), DOCS)
    arrays, host = idx.snapshot_state()
    res = idx.search_hybrid(emb64(Q2), Q2, k=5, candidates=20)
    return {k: np.asarray(v) for k, v in arrays.items()}, host, res


@pytest.fixture(scope="module")
def port(jax_snapshot):
    """Every script on four gloo ranks (one spawned group), plus the JAX
    snapshot restored: ``[rank] -> {name: steps' results}``."""
    arrays, host, _ = jax_snapshot
    restore = {"name": "restore", "dtype": "float32", "spec": SPEC64, "steps": [
        ("restore_jax", {"arrays": arrays, "host": host, "emb": emb64(Q2), "texts": Q2,
                         "k": 5, "candidates": 20})]}
    return spawn(rc.parallel_cases, WORLD, device="cpu", timeout_s=rc.SPAWN_TIMEOUT_S,
                 args=(1, [], SCRIPTS + [restore]))


def results(port, name: str, kind: str, rank: int = 0) -> list:
    return [r for op, r in port[rank][name] if op == kind]


def assert_same(jr, tr):
    np.testing.assert_array_equal(np.asarray(tr["indices"]), np.asarray(jr.indices))
    np.testing.assert_allclose(np.asarray(tr["scores"]), np.asarray(jr.scores), rtol=1e-6)
    for a, b in ((jr.dense_scores, tr["dense"]), (jr.bm25_scores, tr["bm25"])):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-5, atol=1e-5)


def ids(r, row: int = 0) -> list:
    return [i for i in np.asarray(r["indices"])[row].tolist() if i >= 0]


def gathered(port, name: str, key: str, which: int = 0) -> np.ndarray:
    """The ranks' blocks of a column, in row order."""
    return np.concatenate([results(port, name, "state", r)[which][key]
                           for r in range(WORLD)])


@pytest.mark.parametrize("name", [s["name"] for s in SCRIPTS])
def test_searches_match_jax(port, jmesh, name):
    """Every search of every script answers as the JAX sharded index."""
    want, _ = _jax_run(BY_NAME[name], jmesh)
    got = results(port, name, "search")
    if name == "pair":  # its snapshot step adds a restored search
        got = got[:1] + got[2:]
    assert len(got) == len(want)
    for tr, jr in zip(got, want):
        assert_same(jr, tr)


def test_sharded_matches_one_device(port):
    gold = rc.one_device_script({**BY_NAME["pair"], "steps": BY_NAME["pair"]["steps"][:3]})
    tr = results(port, "pair", "search")[0]
    np.testing.assert_array_equal(np.asarray(tr["indices"]), np.asarray(gold[0]["indices"]))
    np.testing.assert_allclose(np.asarray(tr["scores"]), np.asarray(gold[0]["scores"]),
                               rtol=1e-6)


def test_placement(port, jmesh):
    """Each rank holds capacity / 4 contiguous rows: the blocks in rank
    order are the JAX index's rows."""
    states = [results(port, "pair", "state", r)[0] for r in range(WORLD)]
    assert [s["row_index"] for s in states] == list(range(WORLD))
    cap = states[0]["capacity"]
    assert cap % WORLD == 0 and all(s["emb_rows"] == cap // WORLD for s in states)
    _, jidx = _jax_run({**BY_NAME["pair"], "steps": BY_NAME["pair"]["steps"][:1]}, jmesh)
    assert cap == jidx._capacity
    np.testing.assert_array_equal(gathered(port, "pair", "emb"), np.asarray(jidx.emb))
    np.testing.assert_array_equal(gathered(port, "pair", "valid"), np.asarray(jidx.valid))


def test_growth_moves_rows_between_ranks(port, jmesh):
    """Three adds across capacity classes: the capacity is a multiple of
    4 x 256, every rank holds its new block (no stale rows), and the
    first search hit is found."""
    state = results(port, "growth", "state")[0]
    assert state["size"] == 3600 and state["capacity"] % (WORLD * 256) == 0
    _, jidx = _jax_run({**BY_NAME["growth"], "steps": BY_NAME["growth"]["steps"][:3]}, jmesh)
    assert state["capacity"] == jidx._capacity
    np.testing.assert_array_equal(gathered(port, "growth", "emb"), np.asarray(jidx.emb))
    np.testing.assert_array_equal(gathered(port, "growth", "valid"), np.asarray(jidx.valid))
    assert ids(results(port, "growth", "search")[0])[0] >= 0


def test_int8(port, jmesh):
    _, jidx = _jax_run({**BY_NAME["int8"], "steps": BY_NAME["int8"]["steps"][:1]}, jmesh)
    np.testing.assert_array_equal(gathered(port, "int8", "emb"),
                                  np.asarray(jidx.emb).astype(np.float32))
    assert ids(results(port, "int8", "search")[0]) == [42]


def test_delete(port):
    before, after = results(port, "pair", "search")[-2:]
    assert ids(before)[0] not in ids(after)


def test_inverted_compaction_keeps_the_doc_major_results(port):
    """Per-shard postings (each rank's over its own rows) reproduce the
    doc-major results."""
    flat, compacted = results(port, "pair", "search")[2:4]
    np.testing.assert_array_equal(np.asarray(flat["indices"]), np.asarray(compacted["indices"]))
    np.testing.assert_allclose(np.asarray(compacted["scores"]), np.asarray(flat["scores"]),
                               rtol=2e-2, atol=1e-3)
    state = results(port, "pair", "state")[1]
    assert state["inv_rows"] == state["shard_rows"]
    assert state["inverted_upto"] == state["size"]


def test_filters(port):
    summary, chat = results(port, "filters", "search")
    assert ids(summary) == [50]
    assert 51 not in ids(chat)


def test_doc_rows_filter_on_shards_and_tail(port):
    before, tail, allowed = results(port, "doc_rows", "search")
    assert ids(before) and all(i in ALLOW for i in ids(before))
    gold = rc.one_device_script({**BY_NAME["doc_rows"],
                                 "steps": BY_NAME["doc_rows"]["steps"][:2]})
    assert ids(before) == ids(gold[0])
    assert all(i in ALLOW for i in ids(tail)), "tail leaked through doc_rows"
    assert len(DOCS) in ids(allowed) or len(DOCS) + 1 in ids(allowed)


def test_fresh_tail_after_compaction(port):
    state = results(port, "tail", "state")[0]
    assert state["inverted_upto"] < state["size"] and state["tail"] == 1
    quokka, prefix, deleted = results(port, "tail", "search")
    assert ids(quokka)[0] == 100
    assert ids(prefix)[0] >= 0
    assert 100 not in ids(deleted)


def test_ivf_tier_exact_at_full_nprobe(port):
    flat, ivf = results(port, "ivf", "search")
    assert results(port, "ivf", "state")[0]["ivf"]
    for r in range(2):
        assert set(ids(flat, r)) == set(ids(ivf, r))


def test_ivf_int8_recall(port):
    flat, ivf = results(port, "ivf_int8", "search")
    recall = np.mean([len(set(ids(ivf, r)) & set(ids(flat, r))) / 10 for r in range(8)])
    assert recall >= 0.8, recall


def test_kernel_path_matches_plain(port):
    """The dense_topk route (its plain version on the CPU) through the
    whole sharded program answers as the blocked exact search."""
    plain, kernel = results(port, "pair", "pair")[0]
    np.testing.assert_array_equal(np.asarray(kernel["indices"]), np.asarray(plain["indices"]))
    np.testing.assert_allclose(np.asarray(kernel["scores"]), np.asarray(plain["scores"]),
                               rtol=1e-3)


def test_snapshot_roundtrip(port, jax_snapshot):
    """The port's sharded snapshot is the JAX layout (the JAX snapshot of
    the same rows, array for array) and restores to the same answers."""
    (arrays, host), = results(port, "pair", "snapshot")
    jarrays, jhost, _ = jax_snapshot
    assert set(arrays) == set(jarrays) and host["size"] == jhost["size"]
    for k in arrays:
        np.testing.assert_array_equal(np.asarray(arrays[k]), jarrays[k], err_msg=k)
    assert host["spec"] == jhost["spec"] and host["df"] == jhost["df"]
    live, restored = results(port, "pair", "search")[:2]
    np.testing.assert_array_equal(np.asarray(restored["indices"]),
                                  np.asarray(live["indices"])[:2])


def test_jax_snapshot_restored_answers_alike(port, jax_snapshot):
    (got,) = results(port, "restore", "search")
    assert_same(jax_snapshot[2], got)
