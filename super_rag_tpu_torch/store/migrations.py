"""Schema migrations + provider seed data (port of the JAX package's
store/migrations.py; the same versions, so either package opens the
other's database without re-running one).

Counterpart of the reference's alembic migration chain (migration/
versions/2026*.py) and its model_configs seed (migration/sql/
model_configs_init.sql, loaded by config.py:117-120).  sqlite schema DDL
is idempotent; this module tracks a schema_version so future changes
apply exactly once, and seeds well-known OpenAI-compatible providers.
"""

from __future__ import annotations

import logging
import time
from typing import Callable

logger = logging.getLogger(__name__)

SEED_PROVIDERS = [
    # (name, label, base_url, api_type)
    ("openai", "OpenAI", "https://api.openai.com/v1", "openai"),
    ("anthropic", "Anthropic", "https://api.anthropic.com/v1", "anthropic"),
    ("deepseek", "DeepSeek", "https://api.deepseek.com/v1", "openai"),
    ("dashscope", "Alibaba DashScope",
     "https://dashscope.aliyuncs.com/compatible-mode/v1", "openai"),
    ("jina", "Jina AI", "https://api.jina.ai/v1", "openai"),
    ("openrouter", "OpenRouter", "https://openrouter.ai/api/v1", "openai"),
    ("local", "Local OpenAI-compatible", "http://127.0.0.1:8000/v1", "openai"),
]


def _m001_seed_providers(db) -> None:
    for name, label, base_url, api_type in SEED_PROVIDERS:
        existing = db.get_provider(name)
        if existing is None:
            db.upsert_provider(name, label, base_url, api_type)


def _m002_audit_index(db) -> None:
    db.execute(
        "CREATE INDEX IF NOT EXISTS idx_audit_user_created"
        " ON audit_log(user, created)"
    )


MIGRATIONS: list[tuple[int, str, Callable]] = [
    (1, "seed well-known llm providers", _m001_seed_providers),
    (2, "audit log (user, created) index", _m002_audit_index),
]


def run_migrations(db) -> int:
    """Apply pending migrations; returns how many ran."""
    db.execute(
        "CREATE TABLE IF NOT EXISTS schema_version ("
        " version INTEGER PRIMARY KEY, description TEXT, applied REAL)"
    )
    row = db.query_one("SELECT MAX(version) AS v FROM schema_version")
    current = row["v"] or 0
    ran = 0
    for version, description, fn in MIGRATIONS:
        if version <= current:
            continue
        fn(db)
        db.execute(
            "INSERT INTO schema_version (version, description, applied)"
            " VALUES (?,?,?)",
            (version, description, time.time()),
        )
        logger.info("applied migration %s: %s", version, description)
        ran += 1
    return ran
