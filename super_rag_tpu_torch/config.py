"""Framework configuration (env-driven; a copy of the JAX package's
config.py for the PyTorch port).

One ``Settings`` object resolved from ``SUPER_RAG_*`` environment
variables with defaults: the same field names, environment names,
defaults and ``*_root()`` helpers as the JAX package's, so one
environment configures either package.  Per-collection settings live in
the collection's JSON config (``engine/manager.py`` reads them).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


def _env(name: str, default: str) -> str:
    return os.environ.get(f"SUPER_RAG_{name}", default)


def _env_int(name: str, default: int) -> int:
    return int(_env(name, str(default)))


def _env_float(name: str, default: float) -> float:
    return float(_env(name, str(default)))


@dataclass
class Settings:
    # storage
    data_dir: str = field(default_factory=lambda: _env("DATA_DIR", "./data"))
    db_path: str = field(default_factory=lambda: _env("DB_PATH", ""))
    object_store_type: str = field(
        default_factory=lambda: _env("OBJECT_STORE_TYPE", "local")
    )
    # s3 backend (object_store_type=s3): any S3-compatible endpoint
    # (AWS, MinIO, RustFS); credentials fall back to AWS_* env vars
    s3_bucket: str = field(default_factory=lambda: _env("S3_BUCKET", ""))
    s3_endpoint: str = field(default_factory=lambda: _env("S3_ENDPOINT", ""))
    s3_region: str = field(
        default_factory=lambda: _env("S3_REGION", "us-east-1")
    )
    # mirror index snapshots into the object store for durability
    # (SURVEY.md 5.4; needs object_store_type=s3 to leave the machine)
    snapshot_to_object_store: bool = field(
        default_factory=lambda: _env("SNAPSHOT_TO_OBJECT_STORE", "") == "1"
    )

    # chunking (reference defaults: 400/20 — config.py:82-83)
    chunk_size: int = field(default_factory=lambda: _env_int("CHUNK_SIZE", 400))
    chunk_overlap: int = field(
        default_factory=lambda: _env_int("CHUNK_OVERLAP", 20)
    )

    # retrieval defaults (reference: top_k=5, sim>=0.2 —
    # collection_service.py:268-269)
    default_top_k: int = field(default_factory=lambda: _env_int("TOP_K", 5))
    default_similarity_threshold: float = field(
        default_factory=lambda: _env_float("SIMILARITY_THRESHOLD", 0.2)
    )
    rerank_candidates: int = field(
        default_factory=lambda: _env_int("RERANK_CANDIDATES", 100)
    )
    max_rerank_docs: int = field(
        default_factory=lambda: _env_int("MAX_RERANK_DOCS", 1000)
    )

    # engine
    embedding_dim: int = field(default_factory=lambda: _env_int("EMBED_DIM", 256))
    # trained encoder checkpoint (npz + json, WITHOUT the .npz suffix;
    # models/encoder_service.py loads it); when set and present it serves
    # as the default embedder instead of the hash embedder for
    # collections with no explicit embedding provider
    encoder_checkpoint: str = field(
        default_factory=lambda: _env("ENCODER_CKPT", "")
    )
    reranker_checkpoint: str = field(
        default_factory=lambda: _env("RERANKER_CKPT", "")
    )

    # serving micro-batcher: concurrent same-parameter searches coalesce
    # into one device dispatch within this window (engine/batcher.py)
    batch_window_ms: float = field(
        default_factory=lambda: _env_float("BATCH_WINDOW_MS", 0.0)
    )
    batch_max: int = field(default_factory=lambda: _env_int("BATCH_MAX", 64))

    # ingest pipelining: parse/chunk fan out over this many host threads
    # while the single device worker embeds+inserts (tasks/scheduler.py)
    ingest_host_workers: int = field(
        default_factory=lambda: _env_int("INGEST_HOST_WORKERS", 4)
    )
    # 'thread' (default) | 'process' | 'ray': process runs parse/chunk in
    # worker subprocesses over pipes (the Ray-shaped contract,
    # tasks/worker.py); ray runs the same body as Ray remote tasks when
    # ray is installed (falls back to process otherwise — PARITY.md
    # provider boundary)
    ingest_backend: str = field(
        default_factory=lambda: _env("INGEST_BACKEND", "thread")
    )
    ray_address: str = field(default_factory=lambda: _env("RAY_ADDRESS", ""))
    index_dtype: str = field(default_factory=lambda: _env("INDEX_DTYPE", "bfloat16"))
    bm25_slots: int = field(default_factory=lambda: _env_int("BM25_SLOTS", 64))
    vocab_size: int = field(default_factory=lambda: _env_int("VOCAB_SIZE", 1 << 17))
    embed_batch_size: int = field(
        default_factory=lambda: _env_int("EMBED_BATCH", 256)
    )

    # quotas (reference config.py:75-79)
    max_document_size_mb: int = field(
        default_factory=lambda: _env_int("MAX_DOC_MB", 100)
    )
    max_documents_per_collection: int = field(
        default_factory=lambda: _env_int("MAX_DOCS_PER_COLLECTION", 10000)
    )
    max_collections_per_user: int = field(
        default_factory=lambda: _env_int("MAX_COLLECTIONS_PER_USER", 100)
    )

    # auth
    jwt_secret: str = field(
        default_factory=lambda: _env("JWT_SECRET", "dev-secret-change-me")
    )
    jwt_ttl_hours: int = field(default_factory=lambda: _env_int("JWT_TTL_HOURS", 72))
    # OAuth providers as a JSON object: {"github": {"client_id": ...,
    # "client_secret": ..., "authorize_url": ..., "token_url": ...,
    # "userinfo_url": ..., "scope": "user:email"}} (reference:
    # fastapi-users OAuth flows, api/auth.py:121-123)
    oauth_providers_json: str = field(
        default_factory=lambda: _env("OAUTH_PROVIDERS", "")
    )

    def oauth_providers(self) -> dict:
        import json as _json

        if not self.oauth_providers_json:
            return {}
        try:
            return _json.loads(self.oauth_providers_json)
        except ValueError:
            return {}

    # server
    host: str = field(default_factory=lambda: _env("HOST", "127.0.0.1"))
    port: int = field(default_factory=lambda: _env_int("PORT", 8712))

    # reconciler (reference: hourly — config/ray_schedule.py:84-86)
    reconcile_interval_s: float = field(
        default_factory=lambda: _env_float("RECONCILE_INTERVAL", 3600.0)
    )

    def resolved_db_path(self) -> str:
        return self.db_path or os.path.join(self.data_dir, "super_rag.db")

    def objects_root(self) -> str:
        return os.path.join(self.data_dir, "objects")

    def snapshots_root(self) -> str:
        return os.path.join(self.data_dir, "snapshots")


settings = Settings()
