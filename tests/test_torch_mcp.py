"""The port's MCP endpoint and web console against the JAX app's, over real
sockets.

Both apps boot on ``port=0`` (the port's on ``device="cpu"``); one account
per app takes an API key and sends the same JSON-RPC messages to
``POST /mcp``: ``initialize``, ``ping``, the lists, every tool (the web
tools on the stub web of ``test_torch_websearch.py``, so nothing leaves the
machine; and the tool list without them), each error code, notifications
and batches, and ``GET /mcp``.  Replies are compared after mapping each
app's ids to names; the tool replies' JSON text is parsed, every search
score must be a JSON number in both (``json.dumps(..., default=str)``
would turn a numpy or tensor scalar into a string), and scores agree
within ``SCORE_TOL``.  ``GET /`` returns the same bytes and Content-Type.
"""

import http.client
import json
import uuid

import pytest
import torch

from super_rag_tpu.api import webui as jwebui
from super_rag_tpu.app import App as JApp
from super_rag_tpu.config import Settings as JSettings
from super_rag_tpu.mcp import server as jmcp
from super_rag_tpu_torch.api import webui as twebui
from super_rag_tpu_torch.app import App as TApp
from super_rag_tpu_torch.config import Settings as TSettings
from super_rag_tpu_torch.mcp import server as tmcp
from test_torch_api import (DOCS, QUERIES, SCORE_TOL, SETTINGS, Client, ServerThread,
                            make_collection, upload, write_cross_encoder)
from test_torch_websearch import StubWeb


def mcp_server(srv):
    """The McpServer behind an app's ``POST /mcp`` route."""
    for method, rx, handler, _ in srv.app.router.routes:
        if method == "POST" and rx.pattern == "^/mcp$":
            return handler.__self__
    raise AssertionError("no POST /mcp route")


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    torch.set_num_threads(2)
    ref = ServerThread(lambda: JApp(JSettings(
        data_dir=str(tmp_path_factory.mktemp("jax")), **SETTINGS), background_tasks=False))
    port = ServerThread(lambda: TApp(TSettings(
        data_dir=str(tmp_path_factory.mktemp("torch")), **SETTINGS),
        background_tasks=False, device="cpu"))
    webs = [StubWeb(), StubWeb()]
    for srv, svc in zip((ref, port), (webs[0].jax(), webs[1].port())):
        mcp_server(srv).web = svc
    yield ref, port, webs
    ref.stop()
    port.stop()


class Rpc:
    """One account per app, with an API key: the same JSON-RPC message to
    both apps' ``/mcp``."""

    def __init__(self, apps, username: str):
        self.clients = [Client(s.port).login(username) for s in apps[:2]]
        self.keys = []
        for c in self.clients:
            st, body = c.call("POST", "/api/v1/apikeys", {"description": "mcp"})
            assert st in (200, 201), body
            self.keys.append(body["key"])

    def raw(self, i: int, method: str, body: bytes = None, key: bool = True):
        conn = http.client.HTTPConnection("127.0.0.1", self.clients[i].port, timeout=120)
        try:
            headers = {"Content-Type": "application/json"}
            if key:
                headers["Authorization"] = f"Bearer {self.keys[i]}"
            conn.request(method, "/mcp", body=body, headers=headers)
            resp = conn.getresponse()
            return resp.status, resp.getheader("Content-Type") or "", resp.read()
        finally:
            conn.close()

    def post(self, msg, key: bool = True, raw: bytes = None):
        """``msg`` may be a function of the app's index (0 JAX, 1 port);
        returns ``[(status, parsed body or None)] * 2``."""
        out = []
        for i in range(2):
            m = msg(i) if callable(msg) else msg
            data = raw if raw is not None else json.dumps(m).encode()
            status, ctype, payload = self.raw(i, "POST", data, key=key)
            out.append((status, json.loads(payload) if payload else None))
        return out

    def same(self, msg, key: bool = True, raw: bytes = None):
        (s0, b0), (s1, b1) = out = self.post(msg, key=key, raw=raw)
        assert s0 == s1 and b0 == b1, out
        return b1


def call(mid, name, args):
    return {"jsonrpc": "2.0", "id": mid, "method": "tools/call",
            "params": {"name": name, "arguments": args}}


def tool_json(body: dict):
    """The parsed JSON text of a tools/call reply, and the text itself."""
    assert body["result"]["isError"] is False
    text = body["result"]["content"][0]["text"]
    return json.loads(text), text


def renamed(obj, names: dict):
    """``obj`` with every string that is a key of ``names`` replaced."""
    if isinstance(obj, dict):
        return {k: renamed(v, names) for k, v in obj.items()}
    if isinstance(obj, list):
        return [renamed(v, names) for v in obj]
    return names.get(obj, obj) if isinstance(obj, str) else obj


def assert_same_search(r0: dict, r1: dict, names0: dict, names1: dict) -> None:
    (a, _), (b, _) = tool_json(r0), tool_json(r1)
    a, b = renamed(a, names0), renamed(b, names1)
    assert len(a["items"]) == len(b["items"])
    for x, y in zip(a["items"], b["items"]):
        assert type(x["score"]) is float and type(y["score"]) is float, (x, y)
        assert abs(x["score"] - y["score"]) <= SCORE_TOL, (x, y)
        assert {**x, "score": 0} == {**y, "score": 0}
    assert {**a, "items": 0} == {**b, "items": 0}


@pytest.fixture(scope="module")
def world(apps):
    """alice with collection "kb" of DOCS, a chat with one uploaded file,
    and a subscription to bob's published collection "pub"; ids per app
    mapped to names."""
    alice = Rpc(apps, "alice")
    clients = alice.clients
    cids = make_collection(clients, "kb")
    names = [{cids[0]: "kb"}, {cids[1]: "kb"}]
    for name, content in DOCS.items():
        for i, did in enumerate(upload(clients, cids, name, content)):
            names[i][did] = name
    bob = [Client(s.port).login("bob") for s in apps[:2]]
    pub = make_collection(bob, "pub")
    for i, c in enumerate(bob):
        names[i][pub[i]] = "pub"
        assert c.call("POST", f"/api/v1/collections/{pub[i]}/publish")[0] == 200
        assert clients[i].call(
            "POST", f"/api/v1/marketplace/collections/{pub[i]}/subscribe")[0] == 200
    chats, files = [], []
    for i, c in enumerate(clients):
        st, chat = c.call("POST", "/api/v1/chats", {"title": "files"})
        assert st == 201
        chats.append(chat["id"])
        names[i][chat["id"]] = "chat"
        boundary = uuid.uuid4().hex
        raw = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
               f"filename=\"notes.md\"\r\nContent-Type: text/markdown\r\n\r\n").encode() + \
            b"# Notes\n\nquetzal birds nest in the cloud forest of the river valley.\n" + \
            f"\r\n--{boundary}--\r\n".encode()
        st, up = c.call("POST", f"/api/v1/chats/{chat['id']}/documents", raw=raw, headers={
            "Content-Type": f"multipart/form-data; boundary={boundary}"})
        assert st == 201, up
        names[i][up[0]["id"]] = "notes.md"
        st, cols = c.call("GET", "/api/v1/collections")
        files.append(next(x["id"] for x in cols if x["title"].startswith("__chat_files__")))
        names[i][files[-1]] = "chat files"
    return alice, cids, chats, files, names


def test_protocol_messages_match(apps, world):
    """initialize, ping, the tool and prompt lists and the usage guide
    (tests/test_api.py test_mcp_protocol), equal in both apps."""
    alice = world[0]
    init = alice.same({"jsonrpc": "2.0", "id": 1, "method": "initialize", "params": {}})
    assert init["result"]["protocolVersion"] == tmcp.PROTOCOL_VERSION == jmcp.PROTOCOL_VERSION
    assert init["result"]["serverInfo"]["name"] == "super-rag-tpu"
    assert alice.same({"jsonrpc": "2.0", "id": "p", "method": "ping"})["result"] == {}
    tools = alice.same({"jsonrpc": "2.0", "id": 2, "method": "tools/list"})
    assert [t["name"] for t in tools["result"]["tools"]] == [
        "list_collections", "search_collection", "search_chat_files", "web_search", "web_read"]
    prompts = alice.same({"jsonrpc": "2.0", "id": 3, "method": "prompts/list"})
    assert prompts["result"]["prompts"][0]["name"] == "super_rag_usage_guide"
    guide = alice.same({"jsonrpc": "2.0", "id": 4, "method": "prompts/get",
                        "params": {"name": "super_rag_usage_guide"}})
    assert guide["result"]["messages"][0]["content"]["text"] == tmcp.USAGE_GUIDE
    assert tmcp.USAGE_GUIDE == jmcp.USAGE_GUIDE
    for web in (True, False):
        assert tmcp._tool_defs(web) == jmcp._tool_defs(web)


def test_tool_list_without_web_matches(apps, world):
    """Without a web search service (the JAX package leaves it None where
    its service fails to build) the list loses the web tools, and a web
    tool call is an unknown tool, in both apps."""
    alice = world[0]
    servers = [mcp_server(s) for s in apps[:2]]
    kept = [s.web for s in servers]
    try:
        for s in servers:
            s.web = None
        tools = alice.same({"jsonrpc": "2.0", "id": 5, "method": "tools/list"})
        assert [t["name"] for t in tools["result"]["tools"]] == [
            "list_collections", "search_collection", "search_chat_files"]
        err = alice.same(call(6, "web_search", {"query": "x"}))
        assert err["error"] == {"code": -32000, "message": "unknown tool 'web_search'"}
    finally:
        for s, w in zip(servers, kept):
            s.web = w


def test_list_collections_matches(apps, world):
    alice, _, _, _, names = world
    out = alice.post(call(7, "list_collections", {}))
    got = [renamed(tool_json(b)[0], n) for (_, b), n in zip(out, names)]
    assert got[0] == got[1]
    titles = [c["title"] for c in got[1]["collections"]]
    assert "kb" in titles and {"id": "pub", "title": "pub", "shared": True} in \
        got[1]["collections"]


@pytest.mark.parametrize("args", [
    {},
    {"top_k": 3},
    {"use_rerank": False, "top_k": 2},
    {"top_k": None, "use_rerank": None},
])
def test_search_collection_matches(apps, world, args):
    alice, cids, _, _, names = world
    for j, q in enumerate(QUERIES):
        out = alice.post(lambda i: call(10 + j, "search_collection",
                                        {"collection_id": cids[i], "query": q, **args}))
        assert [s for s, _ in out] == [200, 200]
        assert_same_search(out[0][1], out[1][1], names[0], names[1])


def test_search_collection_equals_rest_search(apps, world):
    """The tool's items are the REST search's for the same query."""
    alice, cids, _, _, names = world
    port = alice.clients[1]
    for j, q in enumerate(QUERIES):
        _, body = alice.post(lambda i: call(j, "search_collection",
                                            {"collection_id": cids[i], "query": q,
                                             "top_k": 4}))[1]
        st, rest = port.call("POST", f"/api/v1/collections/{cids[1]}/searches",
                             {"query": q, "top_k": 4})
        assert st == 201
        assert tool_json(body)[0]["items"] == rest["items"]


def test_search_collection_with_cross_encoder_matches(apps, world, tmp_path):
    alice, cids, _, _, names = world
    ckpt = str(tmp_path / "ce")
    write_cross_encoder(ckpt)
    for srv in apps[:2]:
        srv.app.cfg.reranker_checkpoint = ckpt
    try:
        reranked = 0
        for j, q in enumerate(QUERIES):
            out = alice.post(lambda i: call(j, "search_collection",
                                            {"collection_id": cids[i], "query": q}))
            assert_same_search(out[0][1], out[1][1], names[0], names[1])
            reranked += sum(it["recall_type"] == "reranked"
                            for it in tool_json(out[1][1])[0]["items"])
        assert reranked
    finally:
        for srv in apps[:2]:
            srv.app.cfg.reranker_checkpoint = ""


def test_search_chat_files_matches(apps, world):
    alice, _, chats, files, names = world
    for j, q in enumerate(["quetzal cloud forest", "river valley birds", "nothing here"]):
        out = alice.post(lambda i: call(j, "search_chat_files", {
            "collection_id": files[i], "chat_id": chats[i], "query": q, "top_k": 3}))
        assert_same_search(out[0][1], out[1][1], names[0], names[1])
        items = tool_json(out[1][1])[0]["items"]
        if j < 2:
            assert items and all(names[1][it["metadata"]["document_id"]] == "notes.md"
                                 for it in items)
        st, rest = alice.clients[1].call("POST", f"/api/v1/chats/{chats[1]}/files/search",
                                         {"query": q, "top_k": 3})
        assert st == 200 and rest["items"] == items


def test_web_tools_match(apps, world):
    alice = world[0]
    apps_webs = apps[2]
    out = alice.post(call(1, "web_search", {"query": "hybrid retrieval", "max_results": 3}))
    (a, ta), (b, tb) = tool_json(out[0][1]), tool_json(out[1][1])
    assert a == b and a["results"] and ta == tb
    out = alice.post(call(2, "web_read", {"urls": ["https://a.com/1"]}))
    (a, ta), (b, tb) = tool_json(out[0][1]), tool_json(out[1][1])
    assert a == b and a["pages"]
    assert [u for _, u, _ in apps_webs[0].urls] == [u for _, u, _ in apps_webs[1].urls]


@pytest.mark.parametrize("case", [
    "unauthenticated", "parse error", "unknown method", "unknown tool", "empty query",
    "top_k 0", "top_k string", "missing collection", "unknown collection", "missing chat",
    "other user's collection",
])
def test_errors_match(apps, world, case):
    """Each error code: -32700 (parse), -32601 (method), -32001 (tools/call
    without a key), -32000 (a refused tool call, with the REST contract's
    422 messages for bad arguments)."""
    alice, cids, _, _, _ = world
    msgs = {
        "unknown method": {"jsonrpc": "2.0", "id": 9, "method": "nope/nope"},
        "unknown tool": call(9, "drop_tables", {}),
        "empty query": lambda i: call(9, "search_collection",
                                      {"collection_id": cids[i], "query": ""}),
        "top_k 0": lambda i: call(9, "search_collection",
                                  {"collection_id": cids[i], "query": "x", "top_k": 0}),
        "top_k string": lambda i: call(9, "search_collection",
                                       {"collection_id": cids[i], "query": "x",
                                        "top_k": "many"}),
        "missing collection": call(9, "search_collection", {"query": "x"}),
        "unknown collection": call(9, "search_collection",
                                   {"collection_id": "col-nope", "query": "x"}),
        "missing chat": lambda i: call(9, "search_chat_files",
                                       {"collection_id": cids[i], "query": "x"}),
        "unauthenticated": call(9, "list_collections", {}),
    }
    if case == "parse error":
        body = alice.same(None, raw=b"{broken")
        assert body["error"]["code"] == -32700 and body["id"] is None
        return
    if case == "other user's collection":
        carol = Rpc(apps, "carol")
        body = carol.same(lambda i: call(9, "search_collection",
                                         {"collection_id": cids[i], "query": "x"}))
        assert body["error"]["code"] == -32000
        return
    body = alice.same(msgs[case], key=case != "unauthenticated")
    want = {"unauthenticated": -32001, "unknown method": -32601}.get(case, -32000)
    assert body["error"]["code"] == want and body["id"] == 9, body


def test_notifications_and_batches_match(apps, world):
    """A notification answers 202 with no body; a batch answers a list
    without its notifications (tests/test_api.py test_mcp_batch_and_ping)."""
    alice = world[0]
    for method in ("notifications/initialized", "initialized"):
        for i in range(2):
            status, _, payload = alice.raw(i, "POST", json.dumps(
                {"jsonrpc": "2.0", "method": method}).encode())
            assert (status, payload) == (202, b"")
    body = alice.same([{"jsonrpc": "2.0", "id": 1, "method": "ping"},
                       {"jsonrpc": "2.0", "method": "notifications/initialized"},
                       {"jsonrpc": "2.0", "id": 2, "method": "prompts/list"},
                       {"jsonrpc": "2.0", "id": 3, "method": "nope"},
                       {"jsonrpc": "2.0", "id": 4, "method": "tools/list"},
                       call(5, "drop_tables", {})])
    assert [m["id"] for m in body] == [1, 2, 3, 4, 5]
    assert body[2]["error"]["code"] == -32601 and body[4]["error"]["code"] == -32000
    assert alice.same([{"jsonrpc": "2.0", "method": "initialized"}]) == []


def test_get_mcp_answers_405_alike(apps, world):
    alice = world[0]
    out = [alice.raw(i, "GET") for i in range(2)]
    assert out[0] == out[1] and out[1][0] == 405, out


def test_console_page_is_the_same_bytes(apps):
    assert twebui.PAGE == jwebui.PAGE
    got = []
    for srv in apps[:2]:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        try:
            conn.request("GET", "/")
            resp = conn.getresponse()
            got.append((resp.status, resp.getheader("Content-Type"), resp.read()))
        finally:
            conn.close()
    assert got[0] == got[1]
    assert got[1][:2] == (200, "text/html; charset=utf-8")
    assert got[1][2] == twebui.PAGE.encode()
