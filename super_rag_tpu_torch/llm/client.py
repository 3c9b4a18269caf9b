"""OpenAI-compatible provider client: completion / embedding / rerank
(port of the JAX package's llm/client.py).

Counterpart of the reference's LiteLLM indirection (embedding_service.py
:168-175, completion_service.py :82-199, rerank_service.py :95-104 +
DashScope dialect :155-217) plus its disk cache (litellm_cache.py) and
latency/cost callback logging (litellm_track.py).  The JAX package speaks
httpx; the port speaks the standard library's ``http.client`` through
``HTTPTransport``: keep-alive connections, one per thread and origin
(``http.client`` connections are not thread-safe, and one client serves
the batcher's worker, the ingest threads and the event loop), reopened
once when the server has closed an idle one.  Request bodies, headers,
paths, retries and back-off, cache keys and return values are the JAX
package's.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import logging
import os
import sqlite3
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence
from urllib.parse import urlsplit

from super_rag_tpu_torch.llm.errors import (
    BadRequestError,
    ProviderHTTPError,
    is_retryable_error,
    wrap_provider_error,
)

logger = logging.getLogger(__name__)

USER_AGENT = "super-rag-torch"


class ResponseCache:
    """Small sqlite-backed response cache (reference litellm disk cache,
    a temp-dir file + TTL, with hit/miss counters)."""

    def __init__(self, path: Optional[str] = None, ttl_s: float = 3600.0):
        self.ttl_s = ttl_s
        path = path or os.path.join(tempfile.gettempdir(), "super_rag_llm_cache.db")
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS cache (k TEXT PRIMARY KEY,"
            " v TEXT NOT NULL, created REAL NOT NULL)"
        )
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(kind: str, payload: dict) -> str:
        raw = json.dumps({"kind": kind, **payload}, sort_keys=True)
        return hashlib.sha256(raw.encode()).hexdigest()

    def get(self, key: str) -> Optional[Any]:
        with self._lock:
            row = self._conn.execute(
                "SELECT v, created FROM cache WHERE k=?", (key,)
            ).fetchone()
        if row is None or time.time() - row[1] > self.ttl_s:
            self.misses += 1
            return None
        self.hits += 1
        return json.loads(row[0])

    def put(self, key: str, value: Any) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO cache (k, v, created) VALUES (?,?,?)",
                (key, json.dumps(value, default=str), time.time()),
            )
            self._conn.commit()


@dataclass
class CallStats:
    """Latency/usage tracking (reference litellm_track.py:48-62)."""

    calls: int = 0
    errors: int = 0
    total_latency_ms: float = 0.0
    prompt_tokens: int = 0
    completion_tokens: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def record(self, latency_ms: float, usage: Optional[dict] = None,
               error: bool = False) -> None:
        with self._lock:
            self.calls += 1
            self.total_latency_ms += latency_ms
            if error:
                self.errors += 1
            if usage:
                self.prompt_tokens += usage.get("prompt_tokens", 0)
                self.completion_tokens += usage.get("completion_tokens", 0)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "calls": self.calls, "errors": self.errors,
                "avg_latency_ms": (self.total_latency_ms / self.calls
                                   if self.calls else 0.0),
                "prompt_tokens": self.prompt_tokens,
                "completion_tokens": self.completion_tokens,
            }


# the errors of a keep-alive connection that the server closed while idle:
# the request never reached it, so it is sent once more on a new connection
_STALE = (http.client.RemoteDisconnected, ConnectionResetError,
          ConnectionAbortedError, BrokenPipeError)


class HTTPTransport:
    """Keep-alive HTTP/1.1 over ``http.client``: one connection per
    (thread, scheme, host), so that any thread may call."""

    def __init__(self, timeout: float = 60.0):
        self.timeout = timeout
        self._local = threading.local()
        self._lock = threading.Lock()
        self._open: set = set()

    def _connection(self, scheme: str, netloc: str, fresh: bool):
        conns = getattr(self._local, "conns", None)
        if conns is None:
            conns = self._local.conns = {}
        old = conns.get((scheme, netloc))
        if old is not None and not fresh:
            return old
        cls = (http.client.HTTPSConnection if scheme == "https"
               else http.client.HTTPConnection)
        conn = cls(netloc, timeout=self.timeout)
        conns[(scheme, netloc)] = conn
        with self._lock:
            if old is not None:
                old.close()
                self._open.discard(old)
            self._open.add(conn)
        return conn

    def request(self, method: str, url: str, body: bytes,
                headers: dict) -> tuple[int, bytes]:
        """Send one request; returns (status, body).  Transport faults
        raise as the standard library raises them."""
        parts = urlsplit(url)
        target = (parts.path or "/") + (f"?{parts.query}" if parts.query else "")
        hdrs = {"User-Agent": USER_AGENT, "Accept": "*/*", **headers}
        for fresh in (False, True):
            conn = self._connection(parts.scheme, parts.netloc, fresh)
            reused = conn.sock is not None
            try:
                conn.request(method, target, body=body, headers=hdrs)
                resp = conn.getresponse()
                data = resp.read()
            except _STALE:
                conn.close()
                if reused and not fresh:
                    continue
                raise
            except BaseException:
                conn.close()
                raise
            if resp.will_close:
                conn.close()
            return resp.status, data
        raise AssertionError("unreachable")  # pragma: no cover

    def close(self) -> None:
        with self._lock:
            conns, self._open = self._open, set()
        for conn in conns:
            conn.close()


def json_body(payload: Any) -> bytes:
    """A JSON request body as httpx's ``json=`` encodes it."""
    return json.dumps(payload, ensure_ascii=False, separators=(",", ":"),
                      allow_nan=False).encode("utf-8")


def checked_json(status: int, data: bytes, url: str) -> Any:
    """The body of a 2xx reply as JSON; any other status raises."""
    if not 200 <= status < 300:
        raise ProviderHTTPError(status, data.decode("utf-8", "replace"), url)
    return json.loads(data)


class OpenAICompatClient:
    def __init__(self, base_url: str, api_key: str = "", model: str = "",
                 provider: str = "openai", timeout: float = 60.0,
                 max_retries: int = 3, cache: Optional[ResponseCache] = None,
                 cache_enabled: bool = True):
        self.base_url = base_url.rstrip("/")
        self.api_key = api_key
        self.model = model
        self.provider = provider
        self.max_retries = max_retries
        self.cache = cache if cache is not None else (
            ResponseCache() if cache_enabled else None
        )
        self.stats = CallStats()
        self._transport = HTTPTransport(timeout)

    def _headers(self) -> dict:
        h = {"Content-Type": "application/json"}
        if self.api_key:
            h["Authorization"] = f"Bearer {self.api_key}"
        return h

    def _retrying(self, attempt_fn: Callable[[], Any]) -> Any:
        """``attempt_fn()`` under the retry and back-off policy: retryable
        errors are tried again up to ``max_retries`` times in all."""
        last: Optional[Exception] = None
        for attempt in range(self.max_retries):
            t0 = time.perf_counter()
            try:
                data = attempt_fn()
                self.stats.record((time.perf_counter() - t0) * 1000,
                                  data.get("usage"))
                return data
            except Exception as e:  # noqa: BLE001 — classified below
                err = wrap_provider_error(e, self.provider, self.model)
                self.stats.record((time.perf_counter() - t0) * 1000,
                                  error=True)
                last = err
                if not is_retryable_error(err) or attempt == self.max_retries - 1:
                    raise err from e
                time.sleep(min(2.0 ** attempt, 8.0))
        raise last  # pragma: no cover

    def _post(self, path: str, payload: dict) -> dict:
        url = f"{self.base_url}{path}"
        body = json_body(payload)

        def attempt():
            return checked_json(*self._transport.request(
                "POST", url, body, self._headers()), url)

        return self._retrying(attempt)

    # -- apis -----------------------------------------------------------------

    def complete(self, prompt: Optional[str] = None,
                 messages: Optional[list[dict]] = None,
                 temperature: float = 0.1, max_tokens: Optional[int] = None,
                 model: Optional[str] = None, use_cache: bool = True) -> str:
        msgs = messages or [{"role": "user", "content": prompt or ""}]
        payload = {
            "model": model or self.model, "messages": msgs,
            "temperature": temperature,
        }
        if max_tokens:
            payload["max_tokens"] = max_tokens
        if self.cache and use_cache and temperature == 0.0:
            ck = ResponseCache.key("completion", payload)
            hit = self.cache.get(ck)
            if hit is not None:
                return hit
        data = self._post("/chat/completions", payload)
        msg = data["choices"][0]["message"]
        # reasoning-content fallback (reference completion_service.py:75-80)
        text = msg.get("content") or msg.get("reasoning_content") or ""
        if self.cache and use_cache and temperature == 0.0:
            self.cache.put(ck, text)
        return text

    def embed(self, texts: Sequence[str],
              model: Optional[str] = None,
              use_cache: bool = True) -> list[list[float]]:
        payload = {"model": model or self.model, "input": list(texts)}
        if self.cache and use_cache:
            ck = ResponseCache.key("embedding", payload)
            hit = self.cache.get(ck)
            if hit is not None:
                return hit
        data = self._post("/embeddings", payload)
        rows = sorted(data["data"], key=lambda d: d.get("index", 0))
        out = [r["embedding"] for r in rows]
        if self.cache and use_cache:
            self.cache.put(ck, out)
        return out

    def rerank(self, query: str, documents: Sequence[str],
               top_n: Optional[int] = None,
               model: Optional[str] = None) -> list[dict]:
        """OpenAI-compatible /rerank (Cohere/Jina dialect)."""
        payload = {
            "model": model or self.model, "query": query,
            "documents": list(documents),
        }
        if top_n:
            payload["top_n"] = top_n
        data = self._post("/rerank", payload)
        results = data.get("results", data.get("data", []))
        out = []
        for r in results:
            idx = r.get("index")
            if idx is None or not 0 <= idx < len(documents):
                continue  # index validation (reference :114-135)
            out.append({"index": idx,
                        "relevance_score": r.get("relevance_score",
                                                 r.get("score", 0.0))})
        return out

    def close(self) -> None:
        self._transport.close()


class AnthropicClient(OpenAICompatClient):
    """Anthropic Messages dialect (completion only).

    The reference reaches Anthropic through LiteLLM's provider prefix
    (super_rag/llm/completion/completion_service.py:82-199); here it is
    one subclass: `x-api-key` + `anthropic-version` headers, system
    messages hoisted to the top-level `system` field, and text extracted
    from the content-block list.  Anthropic serves no embedding/rerank
    API — those raise rather than silently degrade.
    """

    ANTHROPIC_VERSION = "2023-06-01"
    DEFAULT_MAX_TOKENS = 1024  # the Messages API requires max_tokens

    def _headers(self) -> dict:
        h = {"Content-Type": "application/json",
             "anthropic-version": self.ANTHROPIC_VERSION}
        if self.api_key:
            h["x-api-key"] = self.api_key
        return h

    def complete(self, prompt: Optional[str] = None,
                 messages: Optional[list[dict]] = None,
                 temperature: float = 0.1, max_tokens: Optional[int] = None,
                 model: Optional[str] = None, use_cache: bool = True) -> str:
        msgs = messages or [{"role": "user", "content": prompt or ""}]
        system = "\n".join(m.get("content", "") for m in msgs
                           if m.get("role") == "system")
        turns = [m for m in msgs if m.get("role") != "system"]
        payload: dict = {
            "model": model or self.model,
            "max_tokens": max_tokens or self.DEFAULT_MAX_TOKENS,
            "messages": turns, "temperature": temperature,
        }
        if system:
            payload["system"] = system
        ck = None
        if self.cache and use_cache and temperature == 0.0:
            ck = ResponseCache.key("completion", payload)
            hit = self.cache.get(ck)
            if hit is not None:
                return hit
        data = self._post("/v1/messages", payload)
        text = "".join(b.get("text", "") for b in data.get("content", [])
                       if b.get("type") == "text")
        if ck is not None:
            self.cache.put(ck, text)
        return text

    def embed(self, texts: Sequence[str], model: Optional[str] = None,
              use_cache: bool = True) -> list[list[float]]:
        raise BadRequestError(
            "the anthropic dialect serves no embeddings API", self.provider
        )

    def rerank(self, query: str, documents: Sequence[str],
               top_n: Optional[int] = None,
               model: Optional[str] = None) -> list[dict]:
        raise BadRequestError(
            "the anthropic dialect serves no rerank API", self.provider
        )


class DashScopeClient(OpenAICompatClient):
    """DashScope native dialect: text-generation, text-embedding and the
    HTTP rerank endpoint the reference special-cases outside LiteLLM
    (super_rag/llm/rerank/rerank_service.py:155-217).  ``base_url`` is
    the host root (e.g. https://dashscope.aliyuncs.com)."""

    GEN_PATH = "/api/v1/services/aigc/text-generation/generation"
    EMBED_PATH = "/api/v1/services/embeddings/text-embedding/text-embedding"
    RERANK_PATH = "/api/v1/services/rerank/text-rerank/text-rerank"

    def complete(self, prompt: Optional[str] = None,
                 messages: Optional[list[dict]] = None,
                 temperature: float = 0.1, max_tokens: Optional[int] = None,
                 model: Optional[str] = None, use_cache: bool = True) -> str:
        msgs = messages or [{"role": "user", "content": prompt or ""}]
        params: dict = {"result_format": "message",
                        "temperature": temperature}
        if max_tokens:
            params["max_tokens"] = max_tokens
        payload = {"model": model or self.model,
                   "input": {"messages": msgs}, "parameters": params}
        ck = None
        if self.cache and use_cache and temperature == 0.0:
            ck = ResponseCache.key("completion", payload)
            hit = self.cache.get(ck)
            if hit is not None:
                return hit
        data = self._post(self.GEN_PATH, payload)
        out = data.get("output", {})
        choices = out.get("choices") or []
        text = (choices[0].get("message", {}).get("content", "")
                if choices else out.get("text", ""))
        if ck is not None:
            self.cache.put(ck, text)
        return text

    def embed(self, texts: Sequence[str], model: Optional[str] = None,
              use_cache: bool = True) -> list[list[float]]:
        payload = {"model": model or self.model,
                   "input": {"texts": list(texts)}}
        ck = None
        if self.cache and use_cache:
            ck = ResponseCache.key("embedding", payload)
            hit = self.cache.get(ck)
            if hit is not None:
                return hit
        data = self._post(self.EMBED_PATH, payload)
        rows = sorted(data.get("output", {}).get("embeddings", []),
                      key=lambda d: d.get("text_index", 0))
        out = [r["embedding"] for r in rows]
        if ck is not None:
            self.cache.put(ck, out)
        return out

    def rerank(self, query: str, documents: Sequence[str],
               top_n: Optional[int] = None,
               model: Optional[str] = None) -> list[dict]:
        params: dict = {"return_documents": False}
        if top_n:
            params["top_n"] = top_n
        payload = {
            "model": model or self.model,
            "input": {"query": query, "documents": list(documents)},
            "parameters": params,
        }
        data = self._post(self.RERANK_PATH, payload)
        out = []
        for r in data.get("output", {}).get("results", []):
            idx = r.get("index")
            if idx is None or not 0 <= idx < len(documents):
                continue
            out.append({"index": idx,
                        "relevance_score": r.get("relevance_score", 0.0)})
        return out


class GeminiClient(OpenAICompatClient):
    """Google Gemini generateContent/batchEmbedContents dialect.

    ``base_url`` is the API root (e.g.
    https://generativelanguage.googleapis.com); auth rides the
    `x-goog-api-key` header.  Roles map openai->gemini
    (assistant->model, system->systemInstruction).  No rerank API.
    """

    def _headers(self) -> dict:
        h = {"Content-Type": "application/json"}
        if self.api_key:
            h["x-goog-api-key"] = self.api_key
        return h

    def complete(self, prompt: Optional[str] = None,
                 messages: Optional[list[dict]] = None,
                 temperature: float = 0.1, max_tokens: Optional[int] = None,
                 model: Optional[str] = None, use_cache: bool = True) -> str:
        msgs = messages or [{"role": "user", "content": prompt or ""}]
        system = "\n".join(m.get("content", "") for m in msgs
                           if m.get("role") == "system")
        contents = [
            {"role": "model" if m.get("role") == "assistant" else "user",
             "parts": [{"text": m.get("content", "")}]}
            for m in msgs if m.get("role") != "system"
        ]
        gen_cfg: dict = {"temperature": temperature}
        if max_tokens:
            gen_cfg["maxOutputTokens"] = max_tokens
        payload: dict = {"contents": contents, "generationConfig": gen_cfg}
        if system:
            payload["systemInstruction"] = {"parts": [{"text": system}]}
        ck = None
        if self.cache and use_cache and temperature == 0.0:
            ck = ResponseCache.key("completion", payload)
            hit = self.cache.get(ck)
            if hit is not None:
                return hit
        mdl = model or self.model
        data = self._post(f"/v1beta/models/{mdl}:generateContent", payload)
        cands = data.get("candidates") or []
        parts = (cands[0].get("content", {}).get("parts", [])
                 if cands else [])
        text = "".join(p.get("text", "") for p in parts)
        if ck is not None:
            self.cache.put(ck, text)
        return text

    def embed(self, texts: Sequence[str], model: Optional[str] = None,
              use_cache: bool = True) -> list[list[float]]:
        mdl = model or self.model
        payload = {"requests": [
            {"model": f"models/{mdl}", "content": {"parts": [{"text": t}]}}
            for t in texts
        ]}
        ck = None
        if self.cache and use_cache:
            ck = ResponseCache.key("embedding", payload)
            hit = self.cache.get(ck)
            if hit is not None:
                return hit
        data = self._post(f"/v1beta/models/{mdl}:batchEmbedContents", payload)
        out = [e.get("values", []) for e in data.get("embeddings", [])]
        if ck is not None:
            self.cache.put(ck, out)
        return out

    def rerank(self, query: str, documents: Sequence[str],
               top_n: Optional[int] = None,
               model: Optional[str] = None) -> list[dict]:
        raise BadRequestError(
            "the gemini dialect serves no rerank API", self.provider
        )


# provider.api_type -> client class (reference: LiteLLM's provider-prefix
# routing, e.g. "anthropic/<model>", resolved per call; here the
# dialect is a property of the stored provider row)
DIALECTS: dict[str, type] = {
    "openai": OpenAICompatClient,
    "anthropic": AnthropicClient,
    "dashscope": DashScopeClient,
    "gemini": GeminiClient,
}


def make_client(api_type: str = "openai", **kwargs) -> OpenAICompatClient:
    api = (api_type or "openai").strip().lower()
    if api in ("bedrock", "vertex", "vertex_ai") and api not in DIALECTS:
        # the signed-auth dialects live in llm/signed.py
        from super_rag_tpu_torch.llm.signed import BedrockClient, VertexClient

        DIALECTS["bedrock"] = BedrockClient
        DIALECTS["vertex"] = DIALECTS["vertex_ai"] = VertexClient
    cls = DIALECTS.get(api, OpenAICompatClient)
    return cls(**kwargs)
