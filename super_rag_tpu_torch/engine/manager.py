"""EngineManager: one CollectionEngine per collection, with persistence
(port of the JAX package's engine/manager.py).

The manager owns in-process engines keyed by collection id, builds each
one's ``IndexSpec`` from the collection's JSON config, and snapshots /
restores their indexes under the data directory (and, with a
``snapshot_store``, in an object store), so a restart does not rebuild
device state.  Engines are built on ``device`` (default: the CUDA card,
as every entry point of the port).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Optional

import torch

from super_rag_tpu_torch.config import Settings, settings as default_settings
from super_rag_tpu_torch.device import DeviceLike, resolve_device
from super_rag_tpu_torch.engine.collection import CollectionEngine
from super_rag_tpu_torch.engine.index import IndexSpec
from super_rag_tpu_torch.engine.snapshot import (
    load_index, load_index_from_store, save_index, save_index_to_store,
    snapshot_exists, store_snapshot_exists)
from super_rag_tpu_torch.models.hash_embedder import HashEmbedder
from super_rag_tpu_torch.ops.dense import Metric

# the config's storage dtype names (the JAX package's) -> torch dtypes
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}

# the collection config's ``hybrid`` keys forwarded to search_hybrid
HYBRID_KEYS = ("rescore", "postings_per_query_term", "lex_deep_terms",
               "lex_deep_postings", "lex_approx_topk")


class EngineManager:
    def __init__(self, cfg: Optional[Settings] = None,
                 embedder_factory=None, reranker_factory=None,
                 device: DeviceLike = None):
        self.cfg = cfg or default_settings
        self.device = resolve_device(device)
        self._engines: dict[str, CollectionEngine] = {}
        self._lock = threading.RLock()
        self._embedder_factory = embedder_factory or self._default_embedder
        self._reranker_factory = reranker_factory or (lambda config: None)
        # optional durability mirror: snapshots also go to this ObjectStore
        # (store/objectstore.py), and a cold machine restores from it
        self.snapshot_store = None

    def _default_embedder(self, config: dict) -> Any:
        dim = int(config.get("embedding", {}).get("dim", self.cfg.embedding_dim))
        return HashEmbedder(dim=dim, device=self.device)

    def _spec(self, config: dict) -> IndexSpec:
        emb = config.get("embedding", {})
        return IndexSpec(
            dim=int(emb.get("dim", self.cfg.embedding_dim)),
            metric=Metric(config.get("metric", "cosine")),
            dtype=_DTYPES.get(config.get("index_dtype", self.cfg.index_dtype),
                              torch.bfloat16),
            bm25_slots=int(config.get("bm25_slots", self.cfg.bm25_slots)),
            vocab_size=int(config.get("vocab_size", self.cfg.vocab_size)),
        )

    def _snapshot_path(self, collection_id: str) -> str:
        return os.path.join(self.cfg.snapshots_root(), collection_id)

    def _engine(self, spec: IndexSpec, embedder, config: dict,
                hybrid_opts: dict, index=None) -> CollectionEngine:
        eng = CollectionEngine(spec, embedder=embedder,
                               reranker=self._reranker_factory(config),
                               hybrid_opts=hybrid_opts, device=self.device)
        if index is not None:
            eng.index = index
        return eng

    def get(self, collection_id: str,
            config: Optional[dict] = None) -> CollectionEngine:
        """The collection's engine: the live one, else restored from its
        file snapshot, else from the snapshot store, else a new one built
        from ``config`` (the embedder's ``dim`` wins over the config's)."""
        with self._lock:
            eng = self._engines.get(collection_id)
            if eng is not None:
                return eng
            config = config or {}
            embedder = self._embedder_factory(config)
            hybrid = config.get("hybrid", {})
            hybrid_opts = {key: hybrid[key] for key in HYBRID_KEYS if key in hybrid}
            path = self._snapshot_path(collection_id)
            key = f"snapshots/{collection_id}"
            if snapshot_exists(path):
                index = load_index(path, device=self.device)
            elif (self.snapshot_store is not None
                  and store_snapshot_exists(self.snapshot_store, key)):
                # cold machine: restore from the object-store mirror
                index = load_index_from_store(self.snapshot_store, key,
                                              device=self.device)
            else:
                index = None
            if index is not None:
                eng = self._engine(index.spec, embedder, config, hybrid_opts,
                                   index)
            else:
                spec = self._spec(config)
                emb_dim = getattr(embedder, "dim", None)
                if emb_dim is not None and emb_dim != spec.dim:
                    spec = IndexSpec(
                        dim=emb_dim, metric=spec.metric, dtype=spec.dtype,
                        bm25_slots=spec.bm25_slots, vocab_size=spec.vocab_size,
                        min_capacity=spec.min_capacity)
                eng = self._engine(spec, embedder, config, hybrid_opts)
            self._engines[collection_id] = eng
            return eng

    def snapshot(self, collection_id: str) -> None:
        with self._lock:
            eng = self._engines.get(collection_id)
        if eng is not None:
            save_index(eng.index, self._snapshot_path(collection_id))
            if self.snapshot_store is not None:
                save_index_to_store(eng.index, self.snapshot_store,
                                    f"snapshots/{collection_id}")

    def snapshot_all(self) -> None:
        with self._lock:
            ids = list(self._engines)
        for cid in ids:
            self.snapshot(cid)

    def drop(self, collection_id: str) -> None:
        """Forget the engine and remove its file snapshot (the store's
        copy stays, as in the reference)."""
        with self._lock:
            self._engines.pop(collection_id, None)
        path = self._snapshot_path(collection_id)
        for ext in (".npz", ".json"):
            try:
                os.remove(path + ext)
            except FileNotFoundError:
                pass
