"""The engine layer under the serving seam, the port against the JAX
package: Settings, the local object store, object-store snapshots (both
ways across the packages), EngineManager and batched_search."""

import asyncio
import dataclasses
import io

import numpy as np
import pytest
import torch

from super_rag_tpu import config as jconfig
from super_rag_tpu.engine import index as jindex
from super_rag_tpu.engine import manager as jmanager
from super_rag_tpu.engine import snapshot as jsnap
from super_rag_tpu.store import objectstore as jstore
from super_rag_tpu_torch import config as tconfig
from super_rag_tpu_torch.engine import manager as tmanager
from super_rag_tpu_torch.engine import snapshot as tsnap
from super_rag_tpu_torch.engine.batcher import QueryBatcher, batched_search
from super_rag_tpu_torch.engine.index import DTYPE_NAMES
from super_rag_tpu_torch.store import objectstore as tstore

V = 1 << 12
DIM = 32

ENV = {
    "DATA_DIR": "/srv/rag", "DB_PATH": "/srv/db.sqlite", "OBJECT_STORE_TYPE": "s3",
    "S3_BUCKET": "b", "S3_ENDPOINT": "http://localhost:9000", "S3_REGION": "eu-west-1",
    "SNAPSHOT_TO_OBJECT_STORE": "1", "CHUNK_SIZE": "512", "CHUNK_OVERLAP": "32",
    "TOP_K": "9", "SIMILARITY_THRESHOLD": "0.35", "RERANK_CANDIDATES": "64",
    "MAX_RERANK_DOCS": "200", "EMBED_DIM": "768", "ENCODER_CKPT": "ckpt/enc",
    "RERANKER_CKPT": "ckpt/ce", "BATCH_WINDOW_MS": "2.5", "BATCH_MAX": "32",
    "INGEST_HOST_WORKERS": "3", "INGEST_BACKEND": "process",
    "RAY_ADDRESS": "ray://h:1", "INDEX_DTYPE": "int8", "BM25_SLOTS": "48",
    "VOCAB_SIZE": "65536", "EMBED_BATCH": "128", "MAX_DOC_MB": "7",
    "MAX_DOCS_PER_COLLECTION": "11", "MAX_COLLECTIONS_PER_USER": "13",
    "JWT_SECRET": "s", "JWT_TTL_HOURS": "5",
    "OAUTH_PROVIDERS": '{"github": {"client_id": "x"}}', "HOST": "0.0.0.0",
    "PORT": "9999", "RECONCILE_INTERVAL": "60",
}


@pytest.mark.parametrize("env", ["defaults", "set", "bad_oauth"])
def test_settings_equal_the_reference_field_by_field(env, monkeypatch):
    for name in ENV:
        monkeypatch.delenv(f"SUPER_RAG_{name}", raising=False)
    if env == "set":
        for name, value in ENV.items():
            monkeypatch.setenv(f"SUPER_RAG_{name}", value)
    elif env == "bad_oauth":
        monkeypatch.setenv("SUPER_RAG_OAUTH_PROVIDERS", "{not json")
    j, p = jconfig.Settings(), tconfig.Settings()
    jf = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
    pf = {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}
    assert list(pf) == list(jf)
    for name in jf:
        assert type(pf[name]) is type(jf[name]) and pf[name] == jf[name], name
    for helper in ("resolved_db_path", "objects_root", "snapshots_root",
                   "oauth_providers"):
        assert getattr(p, helper)() == getattr(j, helper)(), helper
    if env == "set":
        assert p.embedding_dim == 768 and p.snapshot_to_object_store is True


def _store_ops(store):
    """The same operations on either package's LocalObjectStore; returns
    what they read back."""
    out = {}
    store.put("a/b.bin", b"0123456789")
    store.put("/a/c.bin", io.BytesIO(b"stream body"))  # leading slash, stream
    store.put("top.bin", b"")
    out["get"] = store.get("a/b.bin"), store.get("a/c.bin"), store.get("top.bin")
    out["size"] = store.obj_size("a/b.bin"), store.obj_size("top.bin")
    out["exists"] = (store.exists("a/b.bin"), store.exists("a"),
                     store.exists("nope.bin"))
    out["range"] = (b"".join(store.stream_range("a/b.bin", 2, 7, chunk_size=2)),
                    b"".join(store.stream_range("a/b.bin", 8)),
                    b"".join(store.stream_range("a/b.bin", 3, 100)))
    store.put("a/b.bin", b"new")  # overwrite
    out["overwrite"] = store.get("a/b.bin")
    store.delete("a/b.bin")
    store.delete("never-there.bin")
    out["after_delete"] = store.exists("a/b.bin"), store.exists("a/c.bin")
    store.delete_prefix("a")
    out["after_prefix"] = store.exists("a/c.bin"), store.exists("top.bin")
    out["wire"] = store.wire_config()["store_type"]
    return out


def test_local_object_store_round_trips_as_the_reference(tmp_path):
    got = _store_ops(tstore.LocalObjectStore(str(tmp_path / "port")))
    want = _store_ops(jstore.LocalObjectStore(str(tmp_path / "jax")))
    assert got == want
    assert got["get"] == (b"0123456789", b"stream body", b"")
    assert got["range"] == (b"23456", b"89", b"3456789")


@pytest.mark.parametrize("key", ["../outside.bin", "a/../../outside.bin",
                                 "/../../etc/passwd"])
def test_local_object_store_refuses_a_path_out_of_its_root(tmp_path, key):
    store = tstore.LocalObjectStore(str(tmp_path / "root"))
    with pytest.raises(ValueError, match="escapes"):
        store.put(key, b"x")
    with pytest.raises(ValueError, match="escapes"):
        store.get(key)
    assert not (tmp_path / "outside.bin").exists()


def test_get_object_store(tmp_path):
    store = tstore.get_object_store("local", root=str(tmp_path / "objs"))
    assert isinstance(store, tstore.LocalObjectStore)
    assert store.root == str(tmp_path / "objs")
    assert tstore.get_object_store(**store.wire_config()).root == store.root
    s3 = tstore.get_object_store("s3", bucket="b", root="ignored",
                                 endpoint_url="http://127.0.0.1:9", region="r")
    assert isinstance(s3, tstore.S3ObjectStore)
    assert tstore.get_object_store(**s3.wire_config()).wire_config() == s3.wire_config()
    with pytest.raises(ValueError, match="unknown"):
        tstore.get_object_store("ftp")


def _texts(rng, count):
    words = [f"w{i}" for i in range(300)]
    p = 1.0 / np.arange(1, 301) ** 1.1
    p /= p.sum()
    return [" ".join(rng.choice(words, rng.integers(4, 14), p=p))
            for _ in range(count)]


def _indexes(dtype="int8", seed=80):
    """A JAX and a port index fed the same adds and deletes."""
    rng = np.random.default_rng(seed)
    jd = {"int8": jindex.jnp.int8, "bfloat16": jindex.jnp.bfloat16}[dtype]
    td = {"int8": torch.int8, "bfloat16": torch.bfloat16}[dtype]
    j = jindex.DeviceIndex(jindex.IndexSpec(dim=DIM, dtype=jd, bm25_slots=12,
                                            vocab_size=V, min_capacity=512))
    from super_rag_tpu_torch.engine.index import DeviceIndex, IndexSpec

    p = DeviceIndex(IndexSpec(dim=DIM, dtype=td, bm25_slots=12, vocab_size=V,
                              min_capacity=512), device="cpu")
    texts = _texts(rng, 300)
    emb = rng.standard_normal((300, DIM)).astype(np.float32)
    for idx in (j, p):
        idx.add(emb, texts, chat_id="c1")
        idx.delete([4, 9])
    return j, p


def _same_state(a, b):
    (aa, ah), (ba, bh) = a.snapshot_state(), b.snapshot_state()
    assert ah == bh and set(aa) == set(ba)
    for k in aa:
        np.testing.assert_array_equal(np.asarray(aa[k]), np.asarray(ba[k]), err_msg=k)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_store_snapshots_cross_both_ways(tmp_path, dtype):
    j, p = _indexes(dtype)
    pstore = tstore.LocalObjectStore(str(tmp_path / "port"))
    jstore_ = jstore.LocalObjectStore(str(tmp_path / "jax"))
    tsnap.save_index_to_store(p, pstore, "snapshots/c")
    jsnap.save_index_to_store(j, jstore_, "snapshots/c")
    # the same keys in either store
    assert sorted(f.name for f in (tmp_path / "port" / "snapshots").iterdir()) == \
        sorted(f.name for f in (tmp_path / "jax" / "snapshots").iterdir()) == \
        ["c.json", "c.npz"]
    assert tsnap.store_snapshot_exists(pstore, "snapshots/c")
    assert not tsnap.store_snapshot_exists(pstore, "snapshots/other")
    # the JAX package reads the port's store and the port reads the JAX one
    _same_state(jsnap.load_index_from_store(jstore.LocalObjectStore(
        str(tmp_path / "port")), "snapshots/c"), p)
    from_jax = tsnap.load_index_from_store(
        tstore.LocalObjectStore(str(tmp_path / "jax")), "snapshots/c", device="cpu")
    _same_state(from_jax, j)
    assert DTYPE_NAMES[from_jax.spec.dtype] == dtype


def test_snapshot_exists(tmp_path):
    _, p = _indexes()
    path = str(tmp_path / "snaps" / "c")
    assert not tsnap.snapshot_exists(path)
    tsnap.save_index(p, path)
    assert tsnap.snapshot_exists(path) and jsnap.snapshot_exists(path)


def _settings(tmp_path, name):
    return dataclasses.replace(tconfig.Settings(), data_dir=str(tmp_path / name))


CONFIGS = [
    {},
    {"embedding": {"dim": 48}, "metric": "l2", "index_dtype": "int8",
     "bm25_slots": 24, "vocab_size": 1 << 11},
    {"metric": "ip", "index_dtype": "float32"},
    {"index_dtype": "no-such-dtype"},  # falls back to bfloat16, as the reference
]


@pytest.mark.parametrize("config", CONFIGS)
def test_manager_builds_the_reference_spec(tmp_path, config):
    cfg = _settings(tmp_path, "d")
    jm = jmanager.EngineManager(jconfig.Settings(data_dir=cfg.data_dir))
    pm = tmanager.EngineManager(cfg, device="cpu")
    js, ps = jm._spec(config), pm._spec(config)
    assert (ps.dim, ps.metric.value, DTYPE_NAMES[ps.dtype], ps.bm25_slots,
            ps.vocab_size, ps.min_capacity) == (
        js.dim, js.metric.value, np.dtype(js.dtype).name, js.bm25_slots,
        js.vocab_size, js.min_capacity)
    eng = pm.get("c", config)
    assert eng.index.spec == ps and eng.index.device.type == "cpu"
    assert pm.get("c") is eng


HYBRID = {"rescore": False, "postings_per_query_term": 48, "lex_deep_terms": 2,
          "lex_deep_postings": 96, "lex_approx_topk": True, "not_a_key": 1}


def test_manager_forwards_the_hybrid_keys(tmp_path):
    cfg = _settings(tmp_path, "d")
    jm = jmanager.EngineManager(jconfig.Settings(data_dir=cfg.data_dir))
    pm = tmanager.EngineManager(cfg, device="cpu")
    config = {"embedding": {"dim": DIM}, "hybrid": HYBRID}
    got = pm.get("c", config).hybrid_opts
    assert got == jm.get("c", config).hybrid_opts
    assert set(got) == set(tmanager.HYBRID_KEYS) and "not_a_key" not in got
    assert pm.get("d", {}).hybrid_opts == {}


class _Fixed:
    """An embedder whose dim disagrees with the config's."""
    dim = 24

    def embed(self, texts):
        return np.ones((len(texts), self.dim), np.float32)


def test_the_embedders_dim_wins(tmp_path):
    pm = tmanager.EngineManager(_settings(tmp_path, "d"),
                                embedder_factory=lambda config: _Fixed(),
                                device="cpu")
    eng = pm.get("c", {"embedding": {"dim": 64}, "index_dtype": "int8"})
    assert eng.index.spec.dim == 24 and eng.index.spec.dtype == torch.int8


CONFIG = {"embedding": {"dim": DIM}, "index_dtype": "int8", "vocab_size": V,
          "hybrid": {"postings_per_query_term": 64}}


def _ingested(pm, cid="c"):
    rng = np.random.default_rng(81)
    eng = pm.get(cid, CONFIG)
    texts = _texts(rng, 200)
    eng.ingest(texts)
    eng.delete([3])
    return eng, [" ".join(t.split()[:3]) for t in texts[::23]]


def _answers(eng, queries):
    return [[(h.row, h.score) for h in hits]
            for hits in eng.search_batch(queries, top_k=5)]


@pytest.mark.parametrize("source", ["file", "store", "store_only"])
def test_manager_restores_from_file_and_store(tmp_path, source):
    """snapshot() writes the file snapshot (and the store's copy when a
    store is set); a fresh manager restores from the file, or from the
    store alone on a machine with no file snapshot."""
    store = tstore.LocalObjectStore(str(tmp_path / "objects"))
    pm = tmanager.EngineManager(_settings(tmp_path, "a"), device="cpu")
    if source != "file":
        pm.snapshot_store = store
    eng, queries = _ingested(pm)
    want = _answers(eng, queries)
    pm.snapshot_all()
    assert tsnap.snapshot_exists(pm._snapshot_path("c"))
    assert tsnap.store_snapshot_exists(store, "snapshots/c") == (source != "file")
    fresh = tmanager.EngineManager(
        _settings(tmp_path, "b" if source == "store_only" else "a"), device="cpu")
    if source != "file":
        fresh.snapshot_store = store
    got = fresh.get("c", CONFIG)
    assert got is not eng and got.index.size == eng.index.size
    assert got.hybrid_opts == {"postings_per_query_term": 64}
    _same_state(got.index, eng.index)
    assert _answers(got, queries) == want


def test_store_snapshot_restores_in_the_reference_manager(tmp_path):
    """A snapshot the port's manager puts in a store serves from the JAX
    package's manager on a cold machine, and the other way round."""
    store = str(tmp_path / "objects")
    pm = tmanager.EngineManager(_settings(tmp_path, "a"), device="cpu")
    pm.snapshot_store = tstore.LocalObjectStore(store)
    eng, _ = _ingested(pm)
    pm.snapshot("c")
    jm = jmanager.EngineManager(jconfig.Settings(data_dir=str(tmp_path / "b")))
    jm.snapshot_store = jstore.LocalObjectStore(store)
    _same_state(jm.get("c", CONFIG).index, eng.index)
    jeng = jm.get("j", {"embedding": {"dim": DIM}, "vocab_size": V})
    jeng.ingest(_texts(np.random.default_rng(82), 50))
    jm.snapshot("j")
    back = tmanager.EngineManager(_settings(tmp_path, "c"), device="cpu")
    back.snapshot_store = tstore.LocalObjectStore(store)
    _same_state(back.get("j", CONFIG).index, jeng.index)


def test_drop_removes_the_file_snapshot(tmp_path):
    pm = tmanager.EngineManager(_settings(tmp_path, "a"), device="cpu")
    eng, _ = _ingested(pm)
    pm.snapshot("c")
    path = pm._snapshot_path("c")
    assert tsnap.snapshot_exists(path)
    pm.drop("c")
    assert not tsnap.snapshot_exists(path)
    assert pm.get("c", CONFIG) is not eng and pm.get("c").index.size == 0
    pm.drop("never-made")  # no snapshot, no error


@pytest.mark.parametrize("with_batcher", [False, True])
def test_batched_search_equals_a_direct_search(tmp_path, with_batcher):
    pm = tmanager.EngineManager(_settings(tmp_path, "a"), device="cpu")
    eng, queries = _ingested(pm)
    batcher = QueryBatcher(max_batch=4) if with_batcher else None
    services = {"batcher": batcher} if with_batcher else {}

    async def many():
        return await asyncio.gather(*(batched_search(services, eng, q, top_k=5)
                                      for q in queries))

    try:
        got = asyncio.run(many())
    finally:
        if batcher is not None:
            batcher.close()
    if with_batcher:
        assert batcher.stats()["queries"] == len(queries)
    for q, hits in zip(queries, got):
        assert [(h.row, h.score) for h in hits] == \
            [(h.row, h.score) for h in eng.search(q, top_k=5)]
    assert asyncio.run(batched_search(None, eng, queries[0], top_k=5))
