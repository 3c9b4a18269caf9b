"""A model provider served over a socket for the provider tests: the
OpenAI-compatible paths (chat/completions, embeddings, rerank) and the
anthropic, dashscope, gemini, bedrock and vertex dialects' paths, on the
standard library's ThreadingHTTPServer (HTTP/1.1 keep-alive).  Every
request is recorded (method, path, headers, body) so that two clients
sent the same calls can be compared request for request; ``plan`` queues
statuses (or ``"sleep"``) to serve before the normal answers.  With
``api_key`` set, a request without ``Authorization: Bearer <api_key>`` is
refused (401).  ``chip_smoke.py``'s ``[providers]`` phase serves its
provider from here too, with the port's ``HashEmbedder`` as ``embed_fn``.

The module imports numpy and the standard library only."""

from __future__ import annotations

import hashlib
import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

import numpy as np

# headers the transport sets for itself (httpx and http.client differ)
TRANSPORT_HEADERS = {"user-agent", "host", "content-length", "connection",
                     "accept-encoding", "transfer-encoding"}


def seeded_vectors(texts, dim: int) -> np.ndarray:
    """A unit vector a text, drawn from a generator seeded by its hash."""
    out = np.empty((len(texts), dim), np.float32)
    for i, t in enumerate(texts):
        seed = int.from_bytes(hashlib.sha256(t.encode()).digest()[:8], "little")
        v = np.random.default_rng(seed).standard_normal(dim)
        out[i] = v / np.linalg.norm(v)
    return out


def overlap_score(query: str, doc: str) -> float:
    """Query-term overlap, with a small tie-break from the document's hash."""
    q = set(query.lower().split())
    d = set(doc.lower().split())
    tie = int.from_bytes(hashlib.sha256(doc.encode()).digest()[:2], "little") / 65536.0
    return float(len(q & d)) + 1e-3 * tie


def lead_words(text: str, n: int = 16) -> str:
    return " ".join(text.split()[:n])


def stub_completion(prompt: str) -> str:
    """The summary map: the lead words of each block; the reduce: the
    partial summaries joined; anything else: an echo."""
    m = re.search(r"Passage:\n(.*)\n\nSummary:", prompt, re.S)
    if m:
        return " ".join(lead_words(b) for b in m.group(1).split("\n\n") if b.strip())
    m = re.search(r"Partial summaries:\n(.*)\n\nDocument summary:", prompt, re.S)
    if m:
        return " ".join(p.strip() for p in m.group(1).split("\n\n") if p.strip())
    return "echo:" + prompt[-200:]


class StubProvider:
    def __init__(self, dim: int = 8, embed_fn=None, complete_fn=None,
                 idle_timeout=None, api_key=None):
        self.dim = dim
        self.embed_fn = embed_fn or (lambda texts: seeded_vectors(texts, dim))
        self.complete_fn = complete_fn or stub_completion
        self.api_key = api_key
        self.seen: list = []
        self.plan: list = []
        self.counts = {"completion": 0, "embedding": 0, "texts": 0, "rerank": 0,
                       "token": 0, "refused": 0}
        self.lock = threading.Lock()
        stub = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True  # headers and body leave at once
            timeout = idle_timeout  # closes a keep-alive connection idle this long

            def log_message(self, *a):  # quiet
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n)
                with stub.lock:
                    stub.seen.append((self.command, self.path,
                                      {k.lower(): v for k, v in self.headers.items()}, body))
                    step = stub.plan.pop(0) if stub.plan else None
                if step == "sleep":
                    threading.Event().wait(1.0)
                    return self._send(200, {})
                if step == "close":
                    self.close_connection = True
                    self.connection.close()
                    return
                if isinstance(step, tuple):
                    return self._send(step[0], step[1])
                if isinstance(step, int):
                    return self._send(step, {"error": {"message": f"status {step}"}})
                if stub.api_key is not None and \
                        self.headers.get("Authorization") != f"Bearer {stub.api_key}":
                    stub._count("refused")
                    return self._send(401, {"error": {"message": "invalid api key"}})
                try:
                    status, out = stub.answer(self.path, self.headers, body)
                except Exception as e:  # noqa: BLE001 — a 500 names it
                    status, out = 500, {"error": repr(e)}
                self._send(status, out)

            def _send(self, status, out):
                data = out if isinstance(out, bytes) else json.dumps(out).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    @property
    def port(self) -> int:
        return self.server.server_address[1]

    @property
    def root(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    @property
    def url(self) -> str:
        return self.root + "/v1"

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(30)

    def snapshot(self) -> dict:
        with self.lock:
            return dict(self.counts)

    def since(self, before: dict) -> dict:
        """The calls counted since ``snapshot()`` returned ``before``."""
        now = self.snapshot()
        return {k: now[k] - before[k] for k in now}

    def _count(self, kind: str, texts: int = 0) -> None:
        with self.lock:
            self.counts[kind] += 1
            self.counts["texts"] += texts

    def _embed(self, texts) -> list:
        self._count("embedding", len(texts))
        return self.embed_fn(list(texts)).tolist()

    def _rank(self, query, docs) -> list:
        self._count("rerank")
        return [overlap_score(query, d) for d in docs]

    def answer(self, path: str, headers, body: bytes):
        if path.endswith("/token"):
            self._count("token")
            form = parse_qs(body.decode())
            return 200, {"access_token": "tok-" + form["assertion"][0][-8:],
                         "expires_in": 3600}
        req = json.loads(body)
        if path.endswith("/chat/completions"):
            self._count("completion")
            prompt = req["messages"][-1]["content"]
            text = self.complete_fn(prompt)
            msg = ({"content": None, "reasoning_content": "reasoned:" + text}
                   if "think it over" in prompt else {"content": text})
            return 200, {"choices": [{"message": msg}],
                         "usage": {"prompt_tokens": len(prompt.split()),
                                   "completion_tokens": len(text.split())}}
        if path.endswith("/embeddings"):
            vecs = self._embed(req["input"])
            rows = [{"object": "embedding", "index": i, "embedding": v}
                    for i, v in enumerate(vecs)]
            return 200, {"object": "list", "data": rows[::-1],
                         "usage": {"prompt_tokens": 1, "total_tokens": 1}}
        if path.endswith("/rerank"):
            scores = self._rank(req["query"], req["documents"])
            results = [{"index": i, "relevance_score": s} for i, s in enumerate(scores)]
            return 200, {"results": results + [{"index": 999, "relevance_score": 9.0}]}
        if path == "/v1/messages":
            self._count("completion")
            sys_part = f"[{req['system']}]" if req.get("system") else ""
            text = self.complete_fn(req["messages"][-1]["content"])
            return 200, {"content": [{"type": "thinking", "thinking": "hmm"},
                                     {"type": "text", "text": sys_part + text}],
                         "usage": {"input_tokens": 3, "output_tokens": 2}}
        if path.endswith("/text-generation/generation"):
            self._count("completion")
            text = self.complete_fn(req["input"]["messages"][-1]["content"])
            return 200, {"output": {"choices": [{"message": {"content": text}}]}}
        if path.endswith("/text-embedding/text-embedding"):
            vecs = self._embed(req["input"]["texts"])
            embs = [{"text_index": i, "embedding": v} for i, v in enumerate(vecs)]
            return 200, {"output": {"embeddings": embs[::-1]}}
        if path.endswith("/text-rerank/text-rerank"):
            scores = self._rank(req["input"]["query"], req["input"]["documents"])
            results = [{"index": i, "relevance_score": s} for i, s in enumerate(scores)]
            return 200, {"output": {"results": results + [{"index": -1,
                                                           "relevance_score": 9.0}]}}
        if path.endswith(":generateContent"):
            self._count("completion")
            text = self.complete_fn(req["contents"][-1]["parts"][0]["text"])
            return 200, {"candidates": [{"content": {"parts": [{"text": "gem:"},
                                                               {"text": text}]}}]}
        if path.endswith(":batchEmbedContents"):
            vecs = self._embed([r["content"]["parts"][0]["text"] for r in req["requests"]])
            return 200, {"embeddings": [{"values": v} for v in vecs]}
        if path.endswith(":predict"):
            vecs = self._embed([r["content"] for r in req["instances"]])
            return 200, {"predictions": [{"embeddings": {"values": v}} for v in vecs]}
        if path.endswith("/invoke"):  # bedrock
            if "messages" in req:
                self._count("completion")
                text = self.complete_fn(req["messages"][-1]["content"])
                return 200, {"content": [{"type": "text", "text": "br:" + text}]}
            if "inputText" in req and "textGenerationConfig" in req:
                self._count("completion")
                return 200, {"results": [{"outputText": self.complete_fn(req["inputText"])}]}
            if "texts" in req:
                return 200, {"embeddings": self._embed(req["texts"])}
            return 200, {"embedding": self._embed([req["inputText"]])[0]}
        return 404, {"error": f"no route {path}"}

    def requests_since(self, n: int) -> list:
        with self.lock:
            return self.seen[n:]


def repoint_jax_cache(tmp_path_factory):
    """The body of a module-scoped fixture: the JAX package's clients open
    ``/tmp/super_rag_llm_cache.db`` by default (whatever TMPDIR says), so
    while a test module runs they get a file of its own instead."""
    from super_rag_tpu.llm import client as jc

    defaults = jc.ResponseCache.__init__.__defaults__
    jc.ResponseCache.__init__.__defaults__ = (
        str(tmp_path_factory.mktemp("jcache") / "cache.db"), defaults[1])
    yield
    jc.ResponseCache.__init__.__defaults__ = defaults


def comparable(headers: dict) -> dict:
    """A request's headers without those the transport sets for itself."""
    return {k: v for k, v in headers.items() if k not in TRANSPORT_HEADERS}
