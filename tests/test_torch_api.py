"""The port's HTTP app against the JAX package's, over real sockets.

Both apps boot on ``port=0`` with the same Settings (the port's on
``device="cpu"``); each test registers, creates collections and uploads
the same documents to both, maps document and collection ids between them
by name, and compares statuses, bodies and search items (ranks, texts,
recall types, metadata, rows, scores within 1e-5).  The client is the
standard library's ``http.client``.
"""

import asyncio
import base64
import http.client
import json
import threading
import uuid

import numpy as np
import pytest
import torch

from super_rag_tpu.app import App as JApp
from super_rag_tpu.config import Settings as JSettings
from super_rag_tpu_torch.app import App as TApp
from super_rag_tpu_torch.config import Settings as TSettings
from super_rag_tpu_torch.models import cross_encoder as tce
from super_rag_tpu_torch.models import encoder as tenc
from super_rag_tpu_torch.models import encoder_service as tsvc

SCORE_TOL = 1e-5
SETTINGS = dict(embedding_dim=64, index_dtype="float32", vocab_size=1 << 14, port=0)

DOCS = {
    "handbook.md": """# Handbook

## Retrieval

the fox jumps over the dog and runs into the forest.
dense retrieval ranks chunks by the cosine of their embeddings.

## Hardware

TPUs multiply matrices using systolic arrays at high throughput.
GPUs run warps of threads over tensor cores.

- lists hold items
- and more items about the forest
""",
    "notes.txt": "plain text notes about the forest and the river. "
                 "the river runs past the mill, and the mill grinds grain.",
    "cooking.md": """# Cooking

## Bread

flour water salt and yeast make bread; knead the dough and let it rise.

## Soup

a soup of river fish, leeks and potatoes.

| dish | time |
|---|---|
| bread | 3 h |
| soup | 1 h |
""",
}
QUERIES = ["forest fox", "river mill grain", "tensor cores warps", "bread dough",
           "cosine embeddings", "forest zyzzyva"]


class ServerThread:
    """Runs one app's asyncio loop in a thread."""

    def __init__(self, make_app):
        self.loop = asyncio.new_event_loop()
        self.app = None
        self.error = None
        self.started = threading.Event()
        self.thread = threading.Thread(target=self._run, args=(make_app,), daemon=True)
        self.thread.start()
        assert self.started.wait(120), "server did not start"
        if self.error is not None:
            raise self.error

    def _run(self, make_app):
        asyncio.set_event_loop(self.loop)

        async def boot():
            try:
                self.app = make_app()
                await self.app.start(port=0)
            except Exception as e:  # noqa: BLE001 — reported by __init__
                self.error = e
            self.started.set()

        self.loop.run_until_complete(boot())
        if self.error is None:
            self.loop.run_forever()

    @property
    def port(self):
        return self.app.port

    def stop(self):
        fut = asyncio.run_coroutine_threadsafe(self.app.stop(), self.loop)
        fut.result(60)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)
        assert not self.thread.is_alive()


class Client:
    def __init__(self, port):
        self.port = port
        self.token = None

    def call(self, method, path, body=None, headers=None, raw=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=120)
        try:
            hdrs = dict(headers or {})
            if self.token:
                hdrs.setdefault("Authorization", f"Bearer {self.token}")
            data = raw
            if body is not None:
                data = json.dumps(body).encode()
                hdrs.setdefault("Content-Type", "application/json")
            conn.request(method, path, body=data, headers=hdrs)
            resp = conn.getresponse()
            payload = resp.read()
        finally:
            conn.close()
        ctype = resp.getheader("Content-Type") or ""
        if ctype.startswith("application/json"):
            return resp.status, json.loads(payload)
        return resp.status, payload.decode()

    def login(self, username="alice", password="secret123"):
        assert self.call("POST", "/api/v1/auth/register",
                         {"username": username, "password": password})[0] == 201
        status, body = self.call("POST", "/api/v1/auth/login",
                                 {"username": username, "password": password})
        assert status == 200
        self.token = body["token"]
        return self


def write_cross_encoder(path):
    cfg = tenc.EncoderConfig(vocab_size=257, hidden_dim=32, num_layers=1, num_heads=4,
                             mlp_dim=64, max_len=64, dtype=torch.float32)
    model = tenc.init_params(tce.CrossEncoder(cfg), torch.Generator().manual_seed(11))
    tsvc.save_params(tenc.flax_params(model), path, cfg)


@pytest.fixture(scope="module")
def ce_checkpoint(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ce") / "ce")
    write_cross_encoder(path)
    return path


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    torch.set_num_threads(2)
    ref = ServerThread(lambda: JApp(JSettings(
        data_dir=str(tmp_path_factory.mktemp("jax")), **SETTINGS),
        background_tasks=False))
    port = ServerThread(lambda: TApp(TSettings(
        data_dir=str(tmp_path_factory.mktemp("torch")), **SETTINGS),
        background_tasks=False, device="cpu"))
    yield ref, port
    ref.stop()
    port.stop()


@pytest.fixture(scope="module")
def clients(apps):
    return Client(apps[0].port).login(), Client(apps[1].port).login()


def both(clients, method, path_fn, body=None, **kw):
    """The same request to both apps; ``path_fn`` maps the app's index
    (0: JAX package, 1: port) to its path."""
    return [c.call(method, path_fn(i) if callable(path_fn) else path_fn, body, **kw)
            for i, c in enumerate(clients)]


def make_collection(clients, title, config=None):
    out = both(clients, "POST", "/api/v1/collections",
               {"title": title, **({"config": config} if config else {})})
    assert [s for s, _ in out] == [201, 201], out
    return [b["id"] for _, b in out]


def upload(clients, cids, name, content):
    out = [c.call("POST", f"/api/v1/collections/{cid}/documents",
                  {"name": name, "content": content})
           for c, cid in zip(clients, cids)]
    assert [s for s, _ in out] == [201, 201], out
    return [b[0]["id"] for _, b in out]


def normal_items(body, ids):
    """Search items with each app's own ids mapped to shared names."""
    out = []
    for it in body["items"]:
        md = {k: ids.get(v, v) if k in ("document_id", "collection_id") else v
              for k, v in it["metadata"].items()}
        out.append({**it, "metadata": md})
    return out


def assert_same_items(ref_body, port_body, ref_ids, port_ids, nonempty=True):
    ref, got = normal_items(ref_body, ref_ids), normal_items(port_body, port_ids)
    assert len(ref) == len(got), (ref, got)
    assert got or not nonempty, "no items to compare"
    for a, b in zip(ref, got):
        assert abs(a["score"] - b["score"]) <= SCORE_TOL, (a, b)
        assert {**a, "score": 0} == {**b, "score": 0}


@pytest.fixture(scope="module")
def corpus(clients):
    """One collection per app with DOCS uploaded; returns the ids and the
    id -> name maps of each app."""
    cids = make_collection(clients, "kb")
    maps = [{cids[0]: "kb"}, {cids[1]: "kb"}]
    dids = {}
    for name, content in DOCS.items():
        ids = upload(clients, cids, name, content)
        dids[name] = ids
        maps[0][ids[0]] = name
        maps[1][ids[1]] = name
    return cids, dids, maps


def test_documents_indexed_alike(clients, corpus):
    cids, dids, maps = corpus
    lists = both(clients, "GET", lambda i: f"/api/v1/collections/{cids[i]}/documents")
    for status, docs in lists:
        assert status == 200
        assert sorted(d["name"] for d in docs) == sorted(DOCS)
        assert {d["status"] for d in docs} == {"COMPLETE"}
    for name in DOCS:
        (s0, c0), (s1, c1) = both(
            clients, "GET", lambda i: f"/api/v1/documents/{dids[name][i]}/chunks")
        assert s0 == s1 == 200
        assert c0 == c1 and c0
        (s0, d0), (s1, d1) = both(
            clients, "GET",
            lambda i: f"/api/v1/collections/{cids[i]}/documents/{dids[name][i]}")
        assert s0 == s1 == 200
        strip = ("id", "collection_id", "created", "updated", "object_path")
        assert ({k: v for k, v in d0.items() if k not in strip}
                == {k: v for k, v in d1.items() if k not in strip})


@pytest.mark.parametrize("use_fulltext", [True, False])
@pytest.mark.parametrize("use_rerank", [True, False])
def test_search_items_match(clients, corpus, use_fulltext, use_rerank):
    cids, _, maps = corpus
    for q in QUERIES:
        body = {"query": q, "top_k": 4, "use_fulltext": use_fulltext,
                "use_rerank": use_rerank}
        (s0, b0), (s1, b1) = both(
            clients, "POST", lambda i: f"/api/v1/collections/{cids[i]}/searches", body)
        assert s0 == s1 == 201, (b0, b1)
        assert_same_items(b0, b1, maps[0], maps[1])


def test_search_with_cross_encoder_matches(apps, clients, corpus, ce_checkpoint):
    """The reranker checkpoint is resolved at search time in both apps."""
    cids, _, maps = corpus
    for srv in apps:
        srv.app.cfg.reranker_checkpoint = ce_checkpoint
    try:
        seen = 0
        for q in QUERIES:
            body = {"query": q, "top_k": 3}
            (s0, b0), (s1, b1) = both(
                clients, "POST", lambda i: f"/api/v1/collections/{cids[i]}/searches",
                body)
            assert s0 == s1 == 201
            assert_same_items(b0, b1, maps[0], maps[1])
            seen += sum(it["recall_type"] == "reranked" for it in b1["items"])
        assert seen > 0
        (s0, b0), (s1, b1) = [
            c.call("POST", "/api/v1/searches",
                   {"query": "forest river", "collection_ids": [cids[i]], "top_k": 3})
            for i, c in enumerate(clients)]
        assert s0 == s1 == 201
        assert_same_items(b0, b1, maps[0], maps[1])
    finally:
        for srv in apps:
            srv.app.cfg.reranker_checkpoint = ""


def test_unreranked_search_runs_no_cross_encoder(apps, clients, corpus, ce_checkpoint):
    """A kept difference (ROADMAP C5): with a cross-encoder configured, a
    ``use_rerank=false`` search in the port calls the reranker zero times
    and keeps the hybrid order, so it answers as both apps do without a
    checkpoint; the JAX app still scores the same items with its default
    reranker and returns them in the cross-encoder's order."""
    cids, _, maps = corpus

    def search(q, path=None):
        if path is None:
            return both(clients, "POST",
                        lambda i: f"/api/v1/collections/{cids[i]}/searches",
                        {"query": q, "top_k": 4, "use_rerank": False})
        return [c.call("POST", path, {"query": q, "collection_ids": [cids[i]],
                                      "top_k": 4, "use_rerank": False})
                for i, c in enumerate(clients)]

    def item_set(body, ids):
        return sorted(json.dumps({k: v for k, v in it.items()
                                  if k not in ("rank", "score", "recall_type")},
                                 sort_keys=True)
                      for it in normal_items(body, ids))

    plain = {}
    for q in QUERIES:
        for path in (None, "/api/v1/searches"):
            (s0, b0), (s1, b1) = search(q, path)
            assert s0 == s1 == 201
            assert_same_items(b0, b1, maps[0], maps[1])
            plain[q, path] = b1
    port_ctx = apps[1].app.ctx
    calls = []
    resolve = port_ctx.reranker_for

    def counted(config):
        reranker = resolve(config)
        if reranker is None:
            return None

        def wrapped(*args):
            calls.append(args[0])
            return reranker(*args)
        return wrapped

    for srv in apps:
        srv.app.cfg.reranker_checkpoint = ce_checkpoint
    port_ctx.reranker_for = counted
    try:
        for q in QUERIES:
            for path in (None, "/api/v1/searches"):
                (s0, b0), (s1, b1) = search(q, path)
                assert s0 == s1 == 201
                assert_same_items(plain[q, path], b1, maps[1], maps[1])
                if b0["items"]:
                    assert {it["recall_type"] for it in b0["items"]} == {"reranked"}
                # the same items, each app in its own order
                assert item_set(b0, maps[0]) == item_set(b1, maps[1])
        assert calls == []
        # the counter does count: a reranked search calls the reranker
        (s0, _), (s1, b1) = both(
            clients, "POST", lambda i: f"/api/v1/collections/{cids[i]}/searches",
            {"query": QUERIES[0], "top_k": 4})
        assert s0 == s1 == 201 and calls
        assert {it["recall_type"] for it in b1["items"]} == {"reranked"}
    finally:
        del port_ctx.reranker_for
        for srv in apps:
            srv.app.cfg.reranker_checkpoint = ""


def test_delete_then_search(clients):
    cids = make_collection(clients, "del")
    maps = [{cids[0]: "del"}, {cids[1]: "del"}]
    ids = {}
    for name in ("a.md", "b.md"):
        ids[name] = upload(clients, cids, name,
                           f"# {name}\n\nshared words about lanterns and {name} lights")
        maps[0][ids[name][0]], maps[1][ids[name][1]] = name, name
    out = both(clients, "DELETE", lambda i: f"/api/v1/documents/{ids['a.md'][i]}")
    assert [s for s, _ in out] == [204, 204]
    (s0, b0), (s1, b1) = both(clients, "POST",
                              lambda i: f"/api/v1/collections/{cids[i]}/searches",
                              {"query": "lanterns lights", "use_rerank": False})
    assert s0 == s1 == 201
    assert_same_items(b0, b1, maps[0], maps[1])
    assert b1["items"] and all(it["metadata"]["document_id"] == ids["b.md"][1]
                               for it in b1["items"])
    # the nested delete, then the document is gone from both
    out = both(clients, "DELETE",
               lambda i: f"/api/v1/collections/{cids[i]}/documents/{ids['b.md'][i]}")
    assert [s for s, _ in out] == [204, 204]
    out = both(clients, "GET", lambda i: f"/api/v1/documents/{ids['b.md'][i]}")
    assert [s for s, _ in out] == [404, 404]


ERROR_CASES = [
    ("no token", "GET", "/api/v1/collections", None, False),
    ("unknown collection", "GET", "/api/v1/collections/nope", None, True),
    ("unknown route", "GET", "/api/v1/nothing-here", None, True),
    ("wrong method", "PATCH", "/api/v1/collections", None, True),
    ("missing title", "POST", "/api/v1/collections", {"description": "x"}, True),
    ("bad vocab", "POST", "/api/v1/collections",
     {"title": "t", "config": {"vocab_size": 3000}}, True),
    ("bad metric", "POST", "/api/v1/collections",
     {"title": "t", "config": {"metric": "hamming"}}, True),
    ("short password", "POST", "/api/v1/auth/register",
     {"username": "bob", "password": "short"}, False),
    ("bad login", "POST", "/api/v1/auth/login",
     {"username": "alice", "password": "wrong-password"}, False),
    ("duplicate user", "POST", "/api/v1/auth/register",
     {"username": "alice", "password": "secret123"}, False),
    ("bad json", "POST", "/api/v1/auth/login", None, False),
]


@pytest.mark.parametrize("case", ERROR_CASES, ids=[c[0] for c in ERROR_CASES])
def test_errors_match(clients, case):
    _, method, path, body, authed = case
    out = []
    for c in clients:
        token, c.token = c.token, (c.token if authed else None)
        try:
            raw = b"{not json" if case[0] == "bad json" else None
            out.append(c.call(method, path, body, raw=raw))
        finally:
            c.token = token
    assert out[0] == out[1], out
    assert out[0][0] >= 400


@pytest.mark.parametrize("body", [{"top_k": 3}, {"query": ""}, {"query": "x", "top_k": 0},
                                  {"query": "x", "top_k": "many"},
                                  {"query": "x", "similarity_threshold": 2},
                                  {"query": "x", "use_rerank": "perhaps"}])
def test_search_422_matches(clients, corpus, body):
    cids = corpus[0]
    out = both(clients, "POST", lambda i: f"/api/v1/collections/{cids[i]}/searches", body)
    assert out[0] == out[1] and out[0][0] == 422, out


def test_duplicate_upload_409(clients, corpus):
    cids, dids, _ = corpus
    out = [c.call("POST", f"/api/v1/collections/{cid}/documents",
                  {"name": "again.txt", "content": DOCS["notes.txt"]})
           for c, cid in zip(clients, cids)]
    assert [s for s, _ in out] == [409, 409]
    assert out[0][1]["error"]["message"].startswith("duplicate of document ")
    assert [b["error"]["message"] for _, b in out] == [
        f"duplicate of document {dids['notes.txt'][i]}" for i in range(2)]


def test_multipart_upload_and_pagination(clients):
    cids = make_collection(clients, "mp")
    boundary = uuid.uuid4().hex
    raw = b""
    for i in range(3):
        raw += (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
                f"filename=\"f{i}.md\"\r\nContent-Type: text/markdown\r\n\r\n"
                f"# file {i}\n\nbody of file number {i} with pebbles\r\n").encode()
    raw += f"--{boundary}--\r\n".encode()
    hdr = {"Content-Type": f"multipart/form-data; boundary={boundary}"}
    out = [c.call("POST", f"/api/v1/collections/{cid}/documents", raw=raw, headers=hdr)
           for c, cid in zip(clients, cids)]
    assert [s for s, _ in out] == [201, 201]
    assert [d["name"] for d in out[0][1]] == [d["name"] for d in out[1][1]]
    strip = ("id", "collection_id", "created", "updated", "object_path")
    for q in ("?page=1&page_size=2&sort_by=name&sort_order=asc",
              "?page=2&page_size=2&sort_by=name&sort_order=asc",
              "?offset=1&limit=1", "?page=x"):
        (s0, b0), (s1, b1) = both(
            clients, "GET", lambda i: f"/api/v1/collections/{cids[i]}/documents{q}")
        assert s0 == s1
        if s0 != 200:
            assert b0 == b1
            continue
        items0 = b0["items"] if isinstance(b0, dict) else b0
        items1 = b1["items"] if isinstance(b1, dict) else b1
        assert ([{k: v for k, v in d.items() if k not in strip} for d in items0]
                == [{k: v for k, v in d.items() if k not in strip} for d in items1])
        if isinstance(b0, dict):
            assert ({k: v for k, v in b0.items() if k != "items"}
                    == {k: v for k, v in b1.items() if k != "items"})
    (s0, l0), (s1, l1) = both(clients, "GET", "/api/v1/collections?page=1&page_size=1")
    assert s0 == s1 == 200
    assert ({k: v for k, v in l0.items() if k != "items"}
            == {k: v for k, v in l1.items() if k != "items"})


def test_collection_update_and_delete(clients):
    cids = make_collection(clients, "upd")
    out = both(clients, "PUT", lambda i: f"/api/v1/collections/{cids[i]}",
               {"description": "changed", "config": {"metric": "ip"}})
    assert [s for s, _ in out] == [200, 200]
    strip = ("id", "created", "updated")
    assert ({k: v for k, v in out[0][1].items() if k not in strip}
            == {k: v for k, v in out[1][1].items() if k not in strip})
    out = both(clients, "DELETE", lambda i: f"/api/v1/collections/{cids[i]}")
    assert [s for s, _ in out] == [204, 204]
    out = both(clients, "GET", lambda i: f"/api/v1/collections/{cids[i]}")
    assert [s for s, _ in out] == [404, 404]


def test_auth_aliases_and_metrics(clients):
    out = both(clients, "GET", "/api/v1/user")
    assert out[0] == out[1] or ({k: v for k, v in out[0][1].items() if k != "id"}
                                == {k: v for k, v in out[1][1].items() if k != "id"})
    assert out[1][1]["username"] == "alice"
    out = both(clients, "POST", "/api/v1/auth/logout", {})
    assert out[0] == out[1] == (200, {"ok": True})
    for status, text in both(clients, "GET", "/metrics"):
        assert status == 200 and "super_rag_batcher_dispatches" in text
        assert "super_rag_documents_total" in text


# -- the route sets, the MCP endpoint and the console -------------------------

def test_waiting_routes_answer_404(clients):
    """The three routes that once waited (the MCP endpoint and the web
    console) now answer as the JAX app does: ``GET /mcp`` 405, a
    ``POST /mcp`` of an empty object the JSON-RPC "method not found", and
    ``GET /`` the console page (tests/test_torch_mcp.py holds the rest)."""
    for method, path in (("GET", "/mcp"), ("POST", "/mcp"), ("GET", "/")):
        out = both(clients, method, path, {} if method == "POST" else None)
        assert out[0] == out[1], (path, out)
        assert out[1][0] == {"/mcp": 405 if method == "GET" else 200, "/": 200}[path]
    assert both(clients, "POST", "/mcp", {})[1][1]["error"]["code"] == -32601


def test_route_sets_equal_apart_from_mcp_and_the_console(apps):
    """Every (method, path) the JAX app serves, the port serves, and the
    port serves nothing the JAX app lacks: the MCP endpoint and the web
    console included, 148 = 148."""
    def routes(app):
        return {(m, rx.pattern) for m, rx, *_ in app.router.routes}

    ref, port = routes(apps[0].app), routes(apps[1].app)
    assert ref == port
    assert len(ref) == len(port) == 148
    assert {("GET", "^/mcp$"), ("POST", "^/mcp$"), ("GET", "^/$")} <= port


def test_port_refuses_what_it_lacks(clients, corpus):
    """What the port once refused now answers as the reference does: a
    collection config naming a model provider (here one that is not
    registered, so both fall back to the default embedder without a
    connection), the summary index type, a graph search and a PDF."""
    cids, _, maps = corpus
    out = both(clients, "POST", lambda i: f"/api/v1/collections/{cids[i]}/searches",
               {"query": "forest", "use_graph": True})
    assert [s for s, _ in out] == [201, 201], out
    assert_same_items(out[0][1], out[1][1], maps[0], maps[1])
    remote = make_collection(clients, "remote", {
        "embedding": {"provider": "unregistered", "model": "m"}})
    upload(clients, remote, "r.md", "# r\n\nthe fox runs into the forest")
    out = both(clients, "POST", lambda i: f"/api/v1/collections/{remote[i]}/searches",
               {"query": "fox forest", "use_rerank": False})
    assert [s for s, _ in out] == [201, 201], out
    assert [it["text"] for it in out[0][1]["items"]] == [it["text"] for it in out[1][1]["items"]]
    assert abs(out[0][1]["items"][0]["score"] - out[1][1]["items"][0]["score"]) <= SCORE_TOL
    summary = make_collection(clients, "summary", {"enable_summary": True})
    (_, ref), (_, docs) = [c.call("POST", f"/api/v1/collections/{cid}/documents",
                                  {"name": "s.md", "content": "# s\n\nsome text. more."})
                           for c, cid in zip(clients, summary)]
    assert ({i["index_type"]: (i["status"], i["error_message"]) for i in docs[0]["indexes"]}
            == {i["index_type"]: (i["status"], i["error_message"]) for i in ref[0]["indexes"]})
    assert {i["index_type"]: i["status"] for i in docs[0]["indexes"]}["summary"] != "FAILED"
    out = both(clients, "POST", lambda i: f"/api/v1/collections/{summary[i]}/searches",
               {"query": "some text", "use_rerank": False})
    assert sorted(it["text"] for it in out[0][1]["items"]) == \
        sorted(it["text"] for it in out[1][1]["items"])
    out = both(clients, "POST", lambda i: f"/api/v1/collections/{cids[i]}/documents",
               {"name": "scan.pdf",
                "content_base64": base64.b64encode(b"%PDF-1.4").decode()})
    assert [s for s, _ in out] == [201, 201], out
    assert out[1][1][0]["status"] == out[0][1][0]["status"] == "FAILED"
    assert ([i["error_message"] for i in out[1][1][0]["indexes"]]
            == [i["error_message"] for i in out[0][1][0]["indexes"]])
    both(clients, "DELETE", lambda i: f"/api/v1/documents/{out[i][1][0]['id']}")


def test_app_refuses_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TApp(TSettings(data_dir=str(tmp_path), **SETTINGS))


def test_thread_scheduler_ingest_races_batched_search(tmp_path):
    """Background ingest (ThreadScheduler: the device worker embeds and
    inserts) while a client searches through the QueryBatcher: every
    search answers 201 with rows of uploaded documents only, and every
    document completes."""
    srv = ServerThread(lambda: TApp(TSettings(
        data_dir=str(tmp_path), ingest_host_workers=2, **SETTINGS),
        background_tasks=True, device="cpu"))
    try:
        c = Client(srv.port).login()
        cid = c.call("POST", "/api/v1/collections", {"title": "race"})[1]["id"]
        rng = np.random.default_rng(0)
        words = [f"w{i}" for i in range(300)]
        errors, uploaded = [], []

        def uploader():
            try:
                for d in range(12):
                    text = "\n\n".join(" ".join(rng.choice(words, 40))
                                       for _ in range(6))
                    s, b = c.call("POST", f"/api/v1/collections/{cid}/documents",
                                  {"name": f"d{d}.md", "content": f"# d{d}\n\n{text}"})
                    if s != 201:
                        errors.append(("upload", s, b))
                    else:
                        uploaded.append(b[0]["id"])
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))

        def searcher(t):
            client = Client(srv.port)
            client.token = c.token
            for i in range(10):
                s, b = client.call("POST", f"/api/v1/collections/{cid}/searches",
                                   {"query": f"w{(t * 10 + i) % 300} w7",
                                    "use_rerank": False})
                if s != 201:
                    errors.append(("search", s, b))

        threads = [threading.Thread(target=uploader)] + [
            threading.Thread(target=searcher, args=(t,)) for t in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors[:3]
        assert srv.app.ctx.scheduler.wait_idle(60)
        docs = c.call("GET", f"/api/v1/collections/{cid}/documents")[1]
        assert len(docs) == 12 and {d["status"] for d in docs} == {"COMPLETE"}
        s, b = c.call("POST", f"/api/v1/collections/{cid}/searches",
                      {"query": "w7 w8", "use_rerank": False, "top_k": 10})
        assert s == 201 and len(b["items"]) == 10
        assert {it["metadata"]["document_id"] for it in b["items"]} <= set(uploaded)
        # a delete that the device worker finishes later leaves the document
        # deleted (the JAX package's callback re-derives it as PENDING:
        # ROADMAP section C)
        gone = b["items"][0]["metadata"]["document_id"]
        assert c.call("DELETE", f"/api/v1/documents/{gone}")[0] == 204
        assert srv.app.ctx.scheduler.wait_idle(60)
        assert c.call("GET", f"/api/v1/documents/{gone}")[0] == 404
        docs = c.call("GET", f"/api/v1/collections/{cid}/documents")[1]
        assert len(docs) == 11 and gone not in {d["id"] for d in docs}
        s, b = c.call("POST", f"/api/v1/collections/{cid}/searches",
                      {"query": "w7 w8", "use_rerank": False, "top_k": 10})
        assert s == 201 and gone not in {it["metadata"]["document_id"] for it in b["items"]}
    finally:
        srv.stop()
