"""AppContext: wires the port's subsystems together (port of the JAX
package's service/context.py).

One explicit context object owns the metadata db, object store, engine
manager, task scheduler, reconciler, auth, knowledge graph and query
batcher, constructed once per process (or per test) and handed to
services and routes.
``device`` reaches every model and engine the context builds; ``None``
means the CUDA card, which raises without one unless ``"cpu"`` is named.

Models resolve as the JAX package's do (``llm/resolver.py``): a
collection config's ``embedding`` / ``rerank`` spec, else the model tagged
for the scenario, names a provider row and its key in the db; a remote
provider's client embeds (``RemoteEmbedder``, its probed ``dim`` sizing
the index) and reranks, and the model tagged
``default_for_collection_completion`` at boot is the completion client of
the knowledge graph and the summary index.  With no provider, or one that
cannot be reached, the onboard encoder checkpoint or the hash embedder
serves, and the fallback is logged.  Objects go to the local store or to S3
(``object_store_type="s3"``); ingest runs in process, on host threads
(``thread``), in worker subprocesses (``process``) or on Ray (``ray``,
which falls back to ``process`` where ``ray`` is not installed).
"""

from __future__ import annotations

import base64
import logging
import os
import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from super_rag_tpu_torch.api.auth import Auth
from super_rag_tpu_torch.config import Settings, settings as default_settings
from super_rag_tpu_torch.device import DeviceLike, resolve_device
from super_rag_tpu_torch.engine.batcher import QueryBatcher
from super_rag_tpu_torch.engine.manager import EngineManager
from super_rag_tpu_torch.kg.service import KnowledgeGraphService
from super_rag_tpu_torch.llm.resolver import ModelResolver, RemoteEmbedder
from super_rag_tpu_torch.models.encoder_service import EncoderService
from super_rag_tpu_torch.models.hash_embedder import HashEmbedder
from super_rag_tpu_torch.models.image_decode import UnsupportedImageError
from super_rag_tpu_torch.service.rerank_service import RerankService
from super_rag_tpu_torch.store.db import Database
from super_rag_tpu_torch.store.objectstore import LocalObjectStore, ObjectStore, get_object_store
from super_rag_tpu_torch.tasks.document import DocumentIndexTask
from super_rag_tpu_torch.tasks.reconciler import DocumentIndexReconciler
from super_rag_tpu_torch.tasks.scheduler import (
    InProcessScheduler,
    ProcessScheduler,
    RayTaskScheduler,
    TaskScheduler,
    ThreadScheduler,
    WorkerProcess,
)

logger = logging.getLogger(__name__)


@dataclass
class AppContext:
    cfg: Settings
    db: Database
    objects: ObjectStore
    engines: EngineManager
    reconciler: DocumentIndexReconciler
    scheduler: TaskScheduler
    auth: Auth
    kg: Optional[KnowledgeGraphService] = None
    completion: Optional[object] = None  # callable (**kw) -> text
    reranker: Optional[object] = None  # callable (query, texts) -> scores
    batcher: Optional[QueryBatcher] = None
    reranker_factory_fn: Optional[object] = None
    resolver: Optional[ModelResolver] = None
    _image_worker: Optional[WorkerProcess] = None
    _image_worker_lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def embed_image(self, data: bytes, dim: int) -> np.ndarray:
        """``[1, dim]``: one searched image's embedding, computed in a host
        worker subprocess started at first use, so that the pure-Python
        decode holds neither the event loop nor this process's GIL, which
        every device search needs.  Blocks the calling thread."""
        with self._image_worker_lock:
            if self._image_worker is None:
                self._image_worker = WorkerProcess()
        resp = self._image_worker.call({
            "op": "embed_image", "dim": dim,
            "data_b64": base64.b64encode(data).decode()})
        if not resp.get("ok"):
            if resp.get("unsupported"):
                raise UnsupportedImageError(resp["error"])
            raise RuntimeError(resp.get("error", "image embedding failed"))
        return np.asarray(resp["vector"], np.float32)[None]

    def close(self) -> None:
        """Stop the image worker subprocess, if one was started, and close
        the model providers' connections."""
        if self._image_worker is not None:
            self._image_worker.stop()
            self._image_worker = None
        if self.resolver is not None:
            self.resolver.close()

    def reranker_for(self, config: Optional[dict] = None):
        """Per-collection reranker: the collection config's rerank spec
        (a remote dialect client) wins, then the scenario-tagged default,
        then the cross-encoder checkpoint.  Resolved at search time, so
        that providers registered after startup and a retrained checkpoint
        take effect without a restart."""
        fac = self.reranker_factory_fn
        if fac is None:
            return self.reranker
        try:
            return fac(config or {}) or self.reranker
        except Exception:  # noqa: BLE001 — rerank is optional, never fatal
            logger.exception("reranker resolution failed; rerank disabled")
            return self.reranker

    def services_for_nodeflow(self) -> dict:
        return {
            "engines": self.engines,
            "db": self.db,
            "kg": self.kg,
            "completion": self.completion,
            "reranker": self.reranker_for({}),
            "batcher": self.batcher,
        }


def build_context(
    cfg: Optional[Settings] = None,
    background_tasks: bool = False,
    device: DeviceLike = None,
) -> AppContext:
    cfg = cfg or default_settings
    device = resolve_device(device)
    db = Database(cfg.resolved_db_path())
    if cfg.object_store_type == "s3":
        objects: ObjectStore = get_object_store(
            "s3", bucket=cfg.s3_bucket,
            endpoint_url=cfg.s3_endpoint or None, region=cfg.s3_region,
        )
    else:
        objects = LocalObjectStore(cfg.objects_root())

    # model resolution: collection config -> provider/model from the db
    # (the resolver's clients share one response cache in the data dir)
    os.makedirs(cfg.data_dir, exist_ok=True)
    resolver = ModelResolver(db, cache_path=os.path.join(cfg.data_dir, "llm_cache.db"))

    def embedder_factory(config: dict):
        spec = config.get("embedding", {}) or {}
        if spec.get("provider") == "onboard":
            # the on-device encoder; model = checkpoint path, or empty for
            # a fresh random-init encoder
            ckpt = spec.get("model", "")
            try:
                if ckpt and os.path.exists(ckpt + ".npz"):
                    return EncoderService.from_checkpoint(ckpt, device=device)
                if ckpt and os.path.isdir(ckpt):
                    return EncoderService.from_hf_checkpoint(ckpt, device=device)
                return EncoderService(device=device)
            except Exception:  # noqa: BLE001 — fall through to hash
                logger.exception(
                    "onboard encoder load failed; using hash embedder"
                )
        client = resolver.embedding_client(config)
        if client is not None:
            try:
                resolver.probe_embedding_dim(client)
                return RemoteEmbedder(client)
            except Exception:  # noqa: BLE001 — provider unreachable
                logger.warning(
                    "embedding provider %r (model %r) unreachable; using the "
                    "default embedder", client.provider, client.model,
                    exc_info=True)
        dim = int(spec.get("dim", cfg.embedding_dim))
        # a trained encoder checkpoint (SUPER_RAG_ENCODER_CKPT) beats the
        # hash embedder as the no-provider default
        ckpt = cfg.encoder_checkpoint
        if ckpt and os.path.exists(ckpt + ".npz"):
            try:
                svc = EncoderService.from_checkpoint(ckpt, device=device)
                if svc.cfg.out_dim == dim:
                    return svc
            except Exception:  # noqa: BLE001 — fall through to hash
                logger.exception(
                    "default encoder checkpoint load failed; using hash"
                )
        return HashEmbedder(dim=dim, device=device)

    # reranker_for() resolves at search time, so what it builds is reused
    # across queries: the remote clients live in the resolver; their
    # wrappers, and the cross-encoder keyed on (path, mtime), here, so a
    # retrained checkpoint is picked up without a restart but not
    # reloaded per search
    _ce_cache: dict = {}
    _remote_wrap_cache: dict = {}

    def reranker_factory(config: dict):
        client = resolver.rerank_client(config)
        if client is not None:
            ckey = id(client)  # the resolver caches clients: ids are stable
            wrapped = _remote_wrap_cache.get(ckey)
            if wrapped is not None:
                return wrapped

            def rerank(query: str, texts):
                results = client.rerank(query, list(texts))
                scores = np.zeros(len(texts), np.float32)
                for r in results:
                    scores[r["index"]] = r["relevance_score"]
                return scores

            _remote_wrap_cache[ckey] = rerank
            return rerank
        # no remote provider: a trained cross-encoder checkpoint
        # (SUPER_RAG_RERANKER_CKPT) serves as the default reranker
        ckpt = cfg.reranker_checkpoint
        if ckpt and os.path.exists(ckpt + ".npz"):
            try:
                key = (ckpt, os.path.getmtime(ckpt + ".npz"))
                svc = _ce_cache.get(key)
                if svc is None:
                    _ce_cache.clear()  # at most one live checkpoint
                    svc = RerankService.from_checkpoint(ckpt, device=device)
                    _ce_cache[key] = svc
                return svc
            except Exception:  # noqa: BLE001 — rerank is optional
                logger.exception(
                    "reranker checkpoint load failed; rerank disabled"
                )
        return None

    engines = EngineManager(cfg, embedder_factory=embedder_factory,
                            reranker_factory=reranker_factory, device=device)
    if cfg.snapshot_to_object_store:
        engines.snapshot_store = objects
    task = DocumentIndexTask(db, objects, engines, cfg)
    reconciler = DocumentIndexReconciler(db)
    if not background_tasks:
        scheduler: TaskScheduler = InProcessScheduler(task, reconciler.callbacks)
    elif cfg.ingest_backend == "ray":
        try:
            scheduler = RayTaskScheduler(
                task, reconciler.callbacks,
                ray_workers=cfg.ingest_host_workers,
                ray_address=cfg.ray_address or None,
            )
        except ImportError:
            logger.warning(
                "INGEST_BACKEND=ray but ray is not installed; falling "
                "back to the process scheduler (same wire contract)")
            scheduler = ProcessScheduler(
                task, reconciler.callbacks,
                process_workers=cfg.ingest_host_workers,
            )
    elif cfg.ingest_backend == "process":
        scheduler = ProcessScheduler(
            task, reconciler.callbacks,
            process_workers=cfg.ingest_host_workers,
        )
    else:
        scheduler = ThreadScheduler(task, reconciler.callbacks,
                                    host_workers=cfg.ingest_host_workers)
    reconciler.scheduler = scheduler
    auth = Auth(db, cfg.jwt_secret, cfg.jwt_ttl_hours,
                oauth_providers=cfg.oauth_providers())
    # the completion client is resolved once, at boot, from the model
    # tagged default_for_collection_completion (none: the graph's offline
    # tier and the extractive summary)
    completion = None
    completion_client = resolver.completion_client({})
    if completion_client is not None:
        completion = lambda **kw: completion_client.complete(**kw)  # noqa: E731

    kg = KnowledgeGraphService(db, completion=completion,
                               reranker=reranker_factory({}), device=device)
    batcher = QueryBatcher(max_batch=cfg.batch_max,
                           max_wait_ms=cfg.batch_window_ms)
    ctx = AppContext(
        cfg=cfg, db=db, objects=objects, engines=engines,
        reconciler=reconciler, scheduler=scheduler, auth=auth, kg=kg,
        completion=completion, batcher=batcher,
        reranker_factory_fn=reranker_factory, resolver=resolver,
    )
    task.ctx = ctx  # the index task reaches kg and completion through it
    return ctx
