"""Per-collection model resolution (port of the JAX package's
llm/resolver.py).

Counterpart of the reference's base_embedding/base_completion resolution
(llm/embed/base_embedding.py:122-215: collection config -> provider/model/
api-key lookup from DB; default_model_service.py scenario tags).  A
collection's JSON config may name models per api; absent that, the
default falls back to the model tagged for the scenario; absent both,
the on-device models serve (hash embedder / extractive answer /
heuristic rerank) — fully offline.

Clients built here share one ``ResponseCache`` at ``cache_path`` (the
App puts it in its data directory), where the JAX package's each open the
default file in /tmp.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

from super_rag_tpu_torch.llm.client import OpenAICompatClient, ResponseCache, make_client
from super_rag_tpu_torch.store.db import Database

logger = logging.getLogger(__name__)

# scenario tags (reference default_model_service.py:22-30)
TAG_COLLECTION_COMPLETION = "default_for_collection_completion"
TAG_AGENT_COMPLETION = "default_for_agent_completion"
TAG_EMBEDDING = "default_for_embedding"
TAG_RERANK = "default_for_rerank"
TAG_BACKGROUND = "default_for_background_task"


class ModelResolver:
    def __init__(self, db: Database, cache_path: str):
        self.db = db
        self._dim_cache: dict[tuple, int] = {}
        self._cache = ResponseCache(cache_path)
        # constructed clients keyed on the RESOLVED identity: resolution
        # (DB lookups) still runs per call so late-registered providers
        # take effect, but the client (and its connections) is reused
        self._client_cache: dict[tuple, OpenAICompatClient] = {}

    def _client_for(self, api: str, spec: Optional[dict], tag: str,
                    user: str) -> Optional[OpenAICompatClient]:
        """spec = {"provider": ..., "model": ...} from collection config."""
        provider_name = model = None
        if spec:
            provider_name = spec.get("provider")
            model = spec.get("model")
        if not provider_name or not model:
            tagged = self.db.list_models(tag=tag)
            if tagged:
                provider_name = tagged[0]["provider"]
                model = tagged[0]["model"]
        if not provider_name or not model:
            return None
        provider = self.db.get_provider(provider_name)
        if provider is None or not provider.get("base_url"):
            logger.warning("provider %r not configured", provider_name)
            return None
        api_key = self.db.get_provider_key(provider_name, user) or \
            self.db.get_provider_key(provider_name, "public") or ""
        # dialect dispatch on the stored provider row's api_type
        # (openai/anthropic/dashscope/gemini/bedrock/vertex)
        api_type = provider.get("api_type") or "openai"
        key = (api_type, provider["base_url"], api_key, model,
               provider_name)
        client = self._client_cache.get(key)
        if client is None:
            client = make_client(
                api_type, base_url=provider["base_url"], api_key=api_key,
                model=model, provider=provider_name, cache=self._cache,
            )
            self._client_cache[key] = client
        return client

    def completion_client(self, config: dict, user: str = "public",
                          scenario: str = TAG_COLLECTION_COMPLETION):
        return self._client_for(
            "completion", config.get("completion"), scenario, user
        )

    def embedding_client(self, config: dict, user: str = "public"):
        return self._client_for(
            "embedding", config.get("embedding"), TAG_EMBEDDING, user
        )

    def rerank_client(self, config: dict, user: str = "public"):
        return self._client_for(
            "rerank", config.get("rerank"), TAG_RERANK, user
        )

    def probe_embedding_dim(self, client: OpenAICompatClient) -> int:
        """Dimension probing with cache (reference base_embedding.py:36-72)."""
        key = (client.base_url, client.model)
        if key not in self._dim_cache:
            self._dim_cache[key] = len(client.embed(["dimension probe"])[0])
        return self._dim_cache[key]

    def close(self) -> None:
        """Close every client's connections."""
        for client in self._client_cache.values():
            client.close()


class RemoteEmbedder:
    """Adapter: OpenAICompatClient -> the engine's embed() protocol.

    ``dim`` is probed at construction so the engine's IndexSpec can size
    its arrays from the model's true output dimension."""

    def __init__(self, client: OpenAICompatClient, batch_size: int = 64,
                 dim: Optional[int] = None):
        self.client = client
        self.batch_size = batch_size
        self.dim = dim if dim is not None else len(
            client.embed(["dimension probe"])[0]
        )

    def embed(self, texts: list[str]) -> np.ndarray:
        out = []
        for i in range(0, len(texts), self.batch_size):
            out.extend(self.client.embed(texts[i : i + self.batch_size]))
        return np.asarray(out, np.float32)
