"""The port's sharing, marketplace, audit, chat, agent and web-search routes
against the JAX package's, over real sockets.

Both apps boot on ``port=0`` with the same Settings (the port's on
``device="cpu"``), and every request goes to both.  Each app's own ids
(``chat-...``, ``msg-...``, ``agt-...``, ``col-...``, ...) are renamed in
order of first appearance, so that two answers compare field for field;
times, latencies and AG-UI ids are taken out, and scores agree within
1e-5.  Completions come from one scripted function installed in both
apps' contexts (or none: the offline answers), and web pages from the
stub web of test_torch_websearch.py behind a middleware that fills
``req.state["web"]``, so nothing leaves the machine.  WebSockets are
driven by ``websockets.sync.client`` (as the JAX tests drive them) and by
chip_smoke.py's stdlib client; every socket read has a timeout."""

import asyncio
import hashlib
import json
import re
import threading
import time
import uuid

import pytest
import torch
import websockets.sync.client as wsc

import chip_smoke
from super_rag_tpu.app import App as JApp
from super_rag_tpu.config import Settings as JSettings
from super_rag_tpu_torch.app import App as TApp
from super_rag_tpu_torch.config import Settings as TSettings
from test_torch_api import SCORE_TOL, SETTINGS, Client, ServerThread
from test_torch_websearch import StubWeb

WS_TIMEOUT = 30
ID = re.compile(r"\b(?:agt|chat|col|doc|key|mkt|msg|oau|ptp|run|shr|sub|usr|wf)-[0-9a-f]{20}\b")
TIMES = {"created", "updated", "published_at", "latency_ms", "gmt_created", "gmt_updated"}

DOCS = {
    "forest.md": "# Forest\n\n## Fox\n\nthe fox jumps over the dog and runs into the forest.\n\n"
                 "## River\n\nthe river runs past the mill, and the mill grinds grain.",
    "hardware.md": "# Hardware\n\nTPUs multiply matrices using systolic arrays at high "
                   "throughput. GPUs run warps of threads over tensor cores.",
    "bread.md": "# Bread\n\nflour water salt and yeast make bread; knead the dough.",
}


class Namer:
    """One app's ids renamed in order of first appearance."""

    def __init__(self):
        self.names = {}

    def __call__(self, value):
        if isinstance(value, dict):
            return {k: self(v) for k, v in value.items() if k not in TIMES}
        if isinstance(value, (list, tuple)):
            return [self(v) for v in value]
        if isinstance(value, str):
            return ID.sub(self._name, value)
        return value

    def _name(self, m):
        key = m.group(0)
        if key not in self.names:
            self.names[key] = f"<{key.split('-')[0]}{len(self.names)}>"
        return self.names[key]


def assert_same(want, got, where="body"):
    """Equal, floats within SCORE_TOL."""
    if isinstance(want, float) or isinstance(got, float):
        assert isinstance(got, (int, float)) and abs(want - got) <= SCORE_TOL, (where, want, got)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), (where, want, got)
        for k in want:
            assert_same(want[k], got[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (where, want, got)
        for i, (a, b) in enumerate(zip(want, got)):
            assert_same(a, b, f"{where}[{i}]")
    else:
        assert got == want, (where, want, got)


def sse(text):
    """(event, data) pairs of an SSE body."""
    return [(name, data) for name, data in chip_smoke._sse_events(text)] if text.strip() else []


class Fake:
    """The completion model of both apps: a pure function of the prompt, so
    equal prompts give equal answers and unequal ones show.  Agent prompts
    get one search_collections call, then an answer; ``gate`` (an async
    completion) holds the answer until the test has sent its stop frame."""

    def __init__(self):
        self.calls = 0
        self.gate = None

    def __call__(self, prompt=None, **kw):
        self.calls += 1
        # each app's ids and the last digits of scores (within SCORE_TOL)
        # are masked: a tool result's JSON carries both into the prompt
        masked = re.sub(r"\d+\.\d{5,}", lambda m: f"{float(m.group(0)):.4f}",
                        ID.sub("<id>", prompt))
        digest = hashlib.sha256(masked.encode()).hexdigest()[:10]
        if "retrieval assistant with tools" in prompt or "Tools:" in prompt:
            if "[tool " not in prompt:
                return json.dumps({"tool": "search_collections",
                                   "arguments": {"query": "fox forest", "top_k": 3}})
            return f"agent answer {digest} from the retrieved facts"
        if self.gate is not None:
            return self._held(digest)
        return f"answer {digest} " + " ".join(["word"] * 12)

    async def _held(self, digest):
        t0 = time.monotonic()
        while not self.gate.is_set() and time.monotonic() - t0 < 10:
            await asyncio.sleep(0.01)
        await asyncio.sleep(0.2)  # the reader takes the stop frame meanwhile
        return f"held answer {digest} " + " ".join(["word"] * 12)


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    torch.set_num_threads(2)
    ref = ServerThread(lambda: JApp(JSettings(
        data_dir=str(tmp_path_factory.mktemp("jax")), **SETTINGS), background_tasks=False))
    port = ServerThread(lambda: TApp(TSettings(
        data_dir=str(tmp_path_factory.mktemp("torch")), **SETTINGS),
        background_tasks=False, device="cpu"))
    webs = [StubWeb(), StubWeb()]
    services = [webs[0].jax(jina_api_key="k"), webs[1].port(jina_api_key="k")]
    for srv, svc in zip((ref, port), services):
        async def web_mw(req, nxt, svc=svc):
            req.state["web"] = svc
            return await nxt(req)

        srv.app.router.use(web_mw)
    yield ref, port, webs
    ref.stop()
    port.stop()


class Pair:
    """The same requests to both apps, answers renamed by each app's Namer."""

    def __init__(self, apps, username):
        self.servers = apps[:2]
        self.clients = [Client(s.port) for s in self.servers]
        self.namers = [Namer(), Namer()]
        self.username = username

    def login(self, password="secret123"):
        for c in self.clients:
            c.login(self.username, password)
        return self

    def call(self, method, path, body=None, **kw):
        """``path`` and ``body`` may be functions of the app's index (0 JAX,
        1 port)."""
        out = []
        for i, c in enumerate(self.clients):
            st, b = c.call(method, path(i) if callable(path) else path,
                           body(i) if callable(body) else body, **kw)
            out.append((st, b))
        return out

    def same(self, method, path, body=None, want=None, **kw):
        """Both answers, equal after renaming; returns the raw answers."""
        out = self.call(method, path, body, **kw)
        (s0, b0), (s1, b1) = out
        assert s0 == s1, (method, path, out)
        if want is not None:
            assert s0 == want, (method, path, out)
        assert_same(self.namers[0](b0), self.namers[1](b1), f"{method} {path}")
        return out

    def ws(self, i, path):
        url = f"ws://127.0.0.1:{self.servers[i].port}{path}"
        return wsc.connect(url, open_timeout=WS_TIMEOUT, close_timeout=5,
                           additional_headers={"Authorization": f"Bearer {self.clients[i].token}"})


def multipart(files):
    boundary = uuid.uuid4().hex
    raw = b""
    for name, data in files:
        raw += (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
                f"filename=\"{name}\"\r\nContent-Type: text/markdown\r\n\r\n").encode()
        raw += data + b"\r\n"
    raw += f"--{boundary}--\r\n".encode()
    return raw, {"Content-Type": f"multipart/form-data; boundary={boundary}"}


@pytest.fixture(scope="module")
def alice(apps):
    return Pair(apps, "alice").login()  # the first account: admin in both apps


@pytest.fixture(scope="module")
def bob(apps, alice):
    return Pair(apps, "bob").login("hunter222")


@pytest.fixture(scope="module")
def kb(alice):
    """One collection of DOCS per app: [jax id, port id]."""
    out = alice.same("POST", "/api/v1/collections", {"title": "kb"}, want=201)
    cids = [b["id"] for _, b in out]
    for name, content in DOCS.items():
        alice.same("POST", lambda i: f"/api/v1/collections/{cids[i]}/documents",
                   {"name": name, "content": content}, want=201)
    return cids


@pytest.fixture
def fake(apps):
    fakes = [Fake(), Fake()]
    for srv, f in zip(apps[:2], fakes):
        srv.app.ctx.completion = f
    yield fakes
    for srv in apps[:2]:
        srv.app.ctx.completion = None
    assert fakes[0].calls == fakes[1].calls


def new_chat(pair, body):
    out = pair.same("POST", "/api/v1/chats", body, want=201)
    return [b["id"] for _, b in out]


# -- chats ----------------------------------------------------------------------


def test_chat_crud_and_pagination(alice, kb):
    ids = new_chat(alice, lambda i: {"title": "t", "collection_ids": [kb[i]]})
    # each app's chat names its own collection
    alice.same("GET", lambda i: f"/api/v1/chats/{ids[i]}", want=200)
    for body in ({"title": "x" * 257}, {"collection_ids": "a"}, {"title": None}):
        alice.same("POST", "/api/v1/chats", body, want=422)
    alice.same("PUT", lambda i: f"/api/v1/chats/{ids[i]}", {"title": "renamed"}, want=200)
    alice.same("PUT", lambda i: f"/api/v1/chats/{ids[i]}", {}, want=200)
    for q in ("", "?page=1&page_size=2", "?offset=1&limit=1",
              "?page=1&page_size=5&sort_by=title&sort_order=asc&search=ren"):
        alice.same("GET", f"/api/v1/chats{q}", want=200)
    alice.same("DELETE", lambda i: f"/api/v1/chats/{ids[i]}", want=204)
    alice.same("GET", lambda i: f"/api/v1/chats/{ids[i]}", want=404)
    alice.same("DELETE", "/api/v1/chats/chat-00000000000000000000", want=404)
    alice.same("PUT", "/api/v1/chats/nope", {"title": "x"}, want=404)


@pytest.mark.parametrize("llm", [False, True])
def test_chat_completions_sse_matches_and_references_are_the_search(alice, kb, apps, llm,
                                                                    request):
    fakes = request.getfixturevalue("fake") if llm else None
    ids = new_chat(alice, lambda i: {"collection_ids": [kb[i]]} if llm else
                   {"title": "t", "collection_ids": [kb[i]]})
    for query in ("tell me about the fox and the forest", "what grinds grain?"):
        out = alice.same("POST", lambda i: f"/api/v1/chats/{ids[i]}/completions",
                         {"message": query}, want=200)
        events = [sse(b) for _, b in out]
        assert_same(alice.namers[0](events[0]), alice.namers[1](events[1]), "events")
        names = [n for n, _ in events[1]]
        assert names[0] == "start" and names[-1] == "done" and "references" in names
        # the references are the collection's search of the same query
        search = alice.same("POST", lambda i: f"/api/v1/collections/{kb[i]}/searches",
                            {"query": query}, want=201)
        refs = dict(events[1])["references"]
        items = search[1][1]["items"]
        assert [(r["rank"], r["score"], r["text"], r["metadata"]) for r in refs] == \
            [(it["rank"], it["score"], it["text"][:300], it["metadata"]) for it in items]
    alice.same("GET", lambda i: f"/api/v1/chats/{ids[i]}", want=200)
    # the body's collection_ids override the chat's; an empty message is refused
    alice.same("POST", lambda i: f"/api/v1/chats/{ids[i]}/completions",
               {"query": "bread dough", "collection_ids": []}, want=200)
    alice.same("POST", lambda i: f"/api/v1/chats/{ids[i]}/completions", {}, want=422)
    alice.same("POST", "/api/v1/chats/nope/completions", {"message": "x"}, want=200)
    if llm:
        assert fakes[1].calls == 4  # a title and three answers


def test_chat_title_and_feedback(alice, kb, fake):
    ids = new_chat(alice, {})
    alice.same("POST", lambda i: f"/api/v1/chats/{ids[i]}/title", want=409)
    alice.same("POST", lambda i: f"/api/v1/chats/{ids[i]}/completions",
               {"message": "what is a systolic array used for"}, want=200)
    alice.same("POST", lambda i: f"/api/v1/chats/{ids[i]}/title", want=200)
    out = alice.same("GET", lambda i: f"/api/v1/chats/{ids[i]}", want=200)
    mids = [b["messages"][1]["id"] for _, b in out]
    for fb in ("good", "bad", None):
        alice.same("POST", lambda i: f"/api/v1/chats/{ids[i]}/messages/{mids[i]}/feedback",
                   {"feedback": fb}, want=200)
    alice.same("GET", lambda i: f"/api/v1/chats/{ids[i]}", want=200)
    alice.same("POST", "/api/v1/chats/nope/title", want=404)


def test_chat_title_offline_is_the_first_message(alice):
    ids = new_chat(alice, {})
    alice.same("POST", lambda i: f"/api/v1/chats/{ids[i]}/completions",
               {"message": "  a question about systolic arrays and their uses  "}, want=200)
    out = alice.same("POST", lambda i: f"/api/v1/chats/{ids[i]}/title", want=200)
    assert out[1][1]["title"] == "a question about systolic arrays and their uses"


@pytest.mark.parametrize("llm", [False, True])
def test_frontend_completions(alice, kb, llm, request):
    if llm:
        request.getfixturevalue("fake")
    ids = new_chat(alice, lambda i: {"title": "f", "collection_ids": [kb[i]]})
    alice.same("POST", lambda i: f"/api/v1/chat/completions/frontend?chat_id={ids[i]}",
               {"message": "what does the fox do?"}, want=200)
    out = alice.same("POST",
                     lambda i: f"/api/v1/chat/completions/frontend?chat_id={ids[i]}&stream=true",
                     {"message": "the river and the mill"}, want=200)
    assert [n for n, _ in sse(out[1][1])][0] == "start"
    # no chat id: a new chat; a raw text body; an empty message
    alice.same("POST", "/api/v1/chat/completions/frontend", {"message": "bread"}, want=200)
    alice.same("POST", "/api/v1/chat/completions/frontend?stream=TRUE",
               raw=b"raw text, not JSON", headers={"Content-Type": "text/plain"}, want=200)
    alice.same("POST", "/api/v1/chat/completions/frontend", raw=b'"a json string"',
               headers={"Content-Type": "application/json"}, want=200)
    alice.same("POST", "/api/v1/chat/completions/frontend", {"message": ""}, want=422)
    alice.same("POST", "/api/v1/chat/completions/frontend?chat_id=nope",
               {"message": "x"}, want=404)


def test_chat_files_upload_search_and_detail(alice):
    ids = new_chat(alice, {"title": "files"})
    raw, hdr = multipart([("notes.md", b"# N\n\nquetzal resplendent bird."),
                          ("more.md", b"# M\n\nzebra quark striped.")])
    out = alice.same("POST", lambda i: f"/api/v1/chats/{ids[i]}/documents", raw=raw,
                     headers=hdr, want=201)
    dids = [b[0]["id"] for _, b in out]
    for path in ("files/search", "search"):
        out = alice.same("POST", lambda i: f"/api/v1/chats/{ids[i]}/{path}",
                         {"query": "quetzal bird", "top_k": 3}, want=200)
        assert "quetzal" in out[1][1]["items"][0]["text"]
    alice.same("POST", lambda i: f"/api/v1/chats/{ids[i]}/files/search", {}, want=422)
    alice.same("GET", lambda i: f"/api/v1/chats/{ids[i]}/documents/{dids[i]}", want=200)
    other = new_chat(alice, {"title": "other"})
    alice.same("GET", lambda i: f"/api/v1/chats/{other[i]}/documents/{dids[i]}", want=404)
    out = alice.same("POST", lambda i: f"/api/v1/chats/{other[i]}/files/search",
                     {"query": "quetzal bird"}, want=200)
    assert not any("quetzal" in it["text"] for it in out[1][1]["items"])
    raw, hdr = multipart([])
    alice.same("POST", lambda i: f"/api/v1/chats/{ids[i]}/documents", raw=raw, headers=hdr,
               want=422)
    raw, hdr = multipart([("x.md", b"x")])
    alice.same("POST", "/api/v1/chats/nope/documents", raw=raw, headers=hdr, want=404)


def _ws_events(ws, until=("done", "stopped", "error")):
    events = []
    while True:
        ev = json.loads(ws.recv(timeout=WS_TIMEOUT))
        events.append(ev)
        if ev["event"] in until:
            return events


def test_chat_websocket_turns_stop_and_next_message(alice, kb, fake):
    ids = new_chat(alice, lambda i: {"title": "ws", "collection_ids": [kb[i]]})
    runs = []
    for i in range(2):
        with alice.ws(i, f"/api/v1/chats/{ids[i]}/connect") as ws:
            turns = []
            ws.send(json.dumps({"message": "what about the fox"}))
            turns.append(_ws_events(ws))
            ws.send(json.dumps({"message": ""}))
            turns.append(_ws_events(ws))
            # a stop frame once the references are out: the answer is held
            # until the frame is on its way, then the turn stops
            fake[i].gate = threading.Event()
            ws.send(json.dumps({"message": "and the river?"}))
            turn = _ws_events(ws, until=("references",))
            ws.send(json.dumps({"type": "stop"}))
            fake[i].gate.set()
            turn += _ws_events(ws)
            turns.append(turn)
            fake[i].gate = None
            # a bare stop outside a turn is ignored; the next message is answered
            ws.send(json.dumps({"type": "cancel"}))
            ws.send(json.dumps({"query": "bread dough",
                                "collection_ids": [kb[i]]}))
            turns.append(_ws_events(ws))
        runs.append(turns)
    assert_same(alice.namers[0](runs[0]), alice.namers[1](runs[1]), "ws turns")
    kinds = [[e["event"] for e in t] for t in runs[1]]
    assert kinds[0][0] == "start" and kinds[0][-1] == "done"
    assert kinds[1] == ["error"]
    assert kinds[2] == ["start", "references", "delta", "stopped"]
    assert kinds[3][-1] == "done"
    alice.same("GET", lambda i: f"/api/v1/chats/{ids[i]}", want=200)


def test_websockets_refuse_without_a_token(apps, alice):
    for i in range(2):
        for path in ("/api/v1/chats/x/connect", "/api/v1/agents/a/chats/x/connect"):
            url = f"ws://127.0.0.1:{apps[i].port}{path}"
            with wsc.connect(url, open_timeout=WS_TIMEOUT, close_timeout=5) as ws:
                assert json.loads(ws.recv(timeout=WS_TIMEOUT)) == {"event": "error",
                                                                   "data": "unauthorized"}


def test_chip_smoke_ws_client_against_the_port(apps, alice, kb):
    """chip_smoke.py's stdlib RFC 6455 client (the card's machine has no
    websockets package) against the port's chat WebSocket: the handshake,
    masked frames, a stop, a client gone mid-stream."""
    port, token = apps[1].port, alice.clients[1].token
    ids = new_chat(alice, lambda i: {"title": "stdlib", "collection_ids": [kb[i]]})
    ws = chip_smoke.WSClient(port, f"/api/v1/chats/{ids[1]}/connect", token, timeout=WS_TIMEOUT)
    try:
        ws.send_json({"message": "x" * 70000})  # a 64-bit length frame
        events = []
        while not events or events[-1]["event"] not in ("done", "error"):
            events.append(ws.recv_json())
        assert events[0]["event"] == "start" and events[-1]["event"] == "done"
        ws.send_json({"type": "stop"})
        ws.send_json({"message": "the mill"})
        events = [ws.recv_json()]
        while events[-1]["event"] != "done":
            events.append(ws.recv_json())
    finally:
        ws.close()
    # a client that goes mid-stream: the server ends the turn, keeps serving
    ws = chip_smoke.WSClient(port, f"/api/v1/chats/{ids[1]}/connect", token, timeout=WS_TIMEOUT)
    ws.send_json({"message": "the fox"})
    assert ws.recv_json()["event"] == "start"
    ws.sock.close()
    with pytest.raises(ConnectionError):
        chip_smoke.WSClient(port, "/api/v1/nope", token, timeout=WS_TIMEOUT)
    st, body = alice.clients[1].call("GET", f"/api/v1/chats/{ids[1]}")
    assert st == 200 and [m["role"] for m in body["messages"]][:4] == [
        "user", "assistant", "user", "assistant"]


# -- agents ---------------------------------------------------------------------


def test_agent_crud(alice, bob, kb):
    out = alice.same("POST", "/api/v1/agents", {"title": "helper", "description": "d",
                                                "config": {"collection_ids": ["c"]}}, want=201)
    aids = [b["id"] for _, b in out]
    for body in ({}, {"title": ""}, {"title": "a", "config": []}, {"title": "x" * 257}):
        alice.same("POST", "/api/v1/agents", body, want=422)
    alice.same("GET", "/api/v1/agents", want=200)
    alice.same("GET", lambda i: f"/api/v1/agents/{aids[i]}", want=200)
    for body in ({"title": "renamed"}, {}, {"config": {"agent": {"language": "zh-CN"}}},
                 {"description": None}):
        alice.same("PUT", lambda i: f"/api/v1/agents/{aids[i]}", body, want=200)
    alice.same("PUT", lambda i: f"/api/v1/agents/{aids[i]}", {"title": ""}, want=422)
    bob.same("GET", lambda i: f"/api/v1/agents/{aids[i]}", want=404)
    bob.same("PUT", lambda i: f"/api/v1/agents/{aids[i]}", {"title": "x"}, want=404)
    bob.same("DELETE", lambda i: f"/api/v1/agents/{aids[i]}", want=404)
    alice.same("DELETE", lambda i: f"/api/v1/agents/{aids[i]}", want=204)
    alice.same("GET", lambda i: f"/api/v1/agents/{aids[i]}", want=404)


def test_agent_chats_crud_feedback_and_title(alice, kb, fake):
    aids = [b["id"] for _, b in alice.same("POST", "/api/v1/agents",
                                           {"title": "helper"}, want=201)]
    other = [b["id"] for _, b in alice.same("POST", "/api/v1/agents", {"title": "x"},
                                            want=201)]
    out = alice.same("POST", lambda i: f"/api/v1/agents/{aids[i]}/chats", {}, want=201)
    cids = [b["id"] for _, b in out]
    assert out[1][1]["peer_type"] == "agent"
    alice.same("POST", lambda i: f"/api/v1/agents/{aids[i]}/chats", {"title": "named"},
               want=201)
    for q in ("", "?page=1&page_size=1"):
        alice.same("GET", lambda i: f"/api/v1/agents/{aids[i]}/chats{q}", want=200)
    alice.same("GET", lambda i: f"/api/v1/agents/{aids[i]}/chats/{cids[i]}", want=200)
    alice.same("PUT", lambda i: f"/api/v1/agents/{aids[i]}/chats/{cids[i]}",
               {"title": "renamed"}, want=200)
    alice.same("GET", lambda i: f"/api/v1/agents/{other[i]}/chats/{cids[i]}", want=404)
    alice.same("POST", lambda i: f"/api/v1/agents/{aids[i]}/chats/{cids[i]}/title", want=409)
    alice.same("POST", lambda i: f"/api/v1/chats/{cids[i]}/completions",
               {"message": "what do foxes do"}, want=200)
    alice.same("POST", lambda i: f"/api/v1/agents/{aids[i]}/chats/{cids[i]}/title", want=200)
    out = alice.same("GET", lambda i: f"/api/v1/agents/{aids[i]}/chats/{cids[i]}", want=200)
    mids = [b["messages"][0]["id"] for _, b in out]
    for body in ({"type": "good"}, {"feedback": "bad"}, {}):
        alice.same("POST", lambda i: f"/api/v1/agents/{aids[i]}/chats/{cids[i]}/messages/"
                                     f"{mids[i]}", body, want=200)
    alice.same("GET", lambda i: f"/api/v1/agents/{aids[i]}/chats/{cids[i]}", want=200)
    alice.same("DELETE", lambda i: f"/api/v1/agents/{aids[i]}/chats/{cids[i]}", want=204)
    alice.same("DELETE", lambda i: f"/api/v1/agents/{aids[i]}/chats/{cids[i]}", want=404)
    alice.same("POST", "/api/v1/agents/agt-00000000000000000000/chats", {}, want=404)


@pytest.mark.parametrize("llm", [False, True])
def test_agent_websocket(alice, kb, llm, request):
    if llm:
        request.getfixturevalue("fake")
    aids = [b["id"] for _, b in alice.same("POST", "/api/v1/agents",
                                           {"title": "h", "config": {}}, want=201)]
    # each app's agent searches its own collection
    for i, aid in enumerate(aids):
        alice.clients[i].call("PUT", f"/api/v1/agents/{aid}",
                              {"config": {"collection_ids": [kb[i]]}})
    chats = new_chat(alice, {"title": "a"})
    runs = []
    for i in range(2):
        with alice.ws(i, f"/api/v1/agents/{aids[i]}/chats/{chats[i]}/connect") as ws:
            turns = []
            for msg in ({"message": "systolic arrays"}, {"message": ""},
                        {"query": "fox forest"}):
                ws.send(json.dumps(msg))
                turns.append(_ws_events(ws))
        runs.append(turns)
    assert_same(alice.namers[0](runs[0]), alice.namers[1](runs[1]), "agent turns")
    kinds = [e["event"] for e in runs[1][0]]
    assert "tool_call" in kinds and "tool_result" in kinds and kinds[-1] == "done"
    alice.same("GET", lambda i: f"/api/v1/chats/{chats[i]}", want=200)
    # an ephemeral chat id (no row) is allowed; an unknown agent is refused
    for i in range(2):
        with alice.ws(i, f"/api/v1/agents/{aids[i]}/chats/ephemeral-{llm}/connect") as ws:
            ws.send(json.dumps({"message": "bread"}))
            assert _ws_events(ws)[-1]["event"] == "done"
        with alice.ws(i, "/api/v1/agents/nope/chats/x/connect") as ws:
            assert json.loads(ws.recv(timeout=WS_TIMEOUT)) == {"event": "error",
                                                               "data": "agent not found"}


def test_agent_ws_cannot_write_other_users_chat(alice, bob):
    alice_chat = new_chat(alice, {"title": "private"})
    aids = [b["id"] for _, b in bob.same("POST", "/api/v1/agents",
                                         {"title": "m", "config": {}}, want=201)]
    for i in range(2):
        with bob.ws(i, f"/api/v1/agents/{aids[i]}/chats/{alice_chat[i]}/connect") as ws:
            assert json.loads(ws.recv(timeout=WS_TIMEOUT)) == {"event": "error",
                                                               "data": "chat not found"}
    bob.same("POST", lambda i: f"/api/v1/agents/{aids[i]}/chats/{alice_chat[i]}/ag-ui",
             {"message": "hi"}, want=404)
    out = alice.same("GET", lambda i: f"/api/v1/chats/{alice_chat[i]}", want=200)
    assert out[1][1]["messages"] == []


def _strip_ag_ui(events):
    return [(n, {k: v for k, v in d.items() if k not in ("runId", "toolCallId", "messageId")})
            for n, d in events]


@pytest.mark.parametrize("llm", [False, True])
def test_ag_ui_sse(alice, kb, llm, request):
    if llm:
        request.getfixturevalue("fake")
    aids = [b["id"] for _, b in alice.call("POST", "/api/v1/agents", {"title": "h2"})]
    for i, aid in enumerate(aids):
        alice.clients[i].call("PUT", f"/api/v1/agents/{aid}",
                              {"config": {"collection_ids": [kb[i]]}})
    out = alice.call("POST", lambda i: f"/api/v1/agents/{aids[i]}/chats/any-{llm}/ag-ui",
                     {"message": "fox"})
    assert [s for s, _ in out] == [200, 200]
    events = [_strip_ag_ui(sse(b)) for _, b in out]
    assert_same(alice.namers[0](events[0]), alice.namers[1](events[1]), "ag-ui")
    assert events[1][0][0] == "RunStarted" and events[1][-1][0] == "RunFinished"
    alice.same("POST", lambda i: f"/api/v1/agents/{aids[i]}/chats/any/ag-ui", {}, want=422)
    alice.same("POST", "/api/v1/agents/nope/chats/any/ag-ui", {"message": "x"}, want=404)


# -- web search -----------------------------------------------------------------


def test_web_search_and_read(apps, alice):
    webs = apps[2]
    for body in ({"query": "q"}, {"query": "q", "providers": ["duckduckgo", "yep"],
                                  "max_results": 3},
                 {"query": "", "source": "docs.example.com"},
                 {"query": "hello", "source": "https://www.x.org/a"}):
        out = alice.same("POST", "/api/v1/web/search", body, want=200)
        assert out[1][1]["results"] and out[1][1]["offline"] is False
    for body in ({}, {"query": " "}, {"max_results": 0, "query": "q"},
                 {"query": "q", "providers": "x"}):
        alice.same("POST", "/api/v1/web/search", body, want=422)
    for body in ({"url": "https://page.test/x"}, {"urls": ["https://missing.test/a",
                                                           "https://page.test/y"]}):
        alice.same("POST", "/api/v1/web/read", body, want=200)
    alice.same("POST", "/api/v1/web/read", {}, want=422)
    assert webs[0].urls == webs[1].urls
    hosts = {"s.jina.ai", "html.duckduckgo.com", "api.yep.com", "r.jina.ai", "page.test"}
    for w in webs:
        w.fail.update(hosts)
    try:
        out = alice.same("POST", "/api/v1/web/search", {"query": "anything"}, want=200)
        assert out[1][1] == {"results": [], "offline": True}
        alice.same("POST", "/api/v1/web/read", {"url": "https://page.test/z"}, want=200)
    finally:
        for w in webs:
            w.fail.difference_update(hosts)
    assert webs[0].urls == webs[1].urls


# -- sharing, the marketplace, the audit log -----------------------------------------


def test_direct_sharing(alice, bob, kb):
    alice.same("POST", lambda i: f"/api/v1/collections/{kb[i]}/shares",
               {"username": "bob"}, want=201)
    alice.same("POST", lambda i: f"/api/v1/collections/{kb[i]}/shares",
               {"username": "bob"}, want=201)  # again: the same row
    for body in ({"username": "nobody"}, {}):
        alice.same("POST", lambda i: f"/api/v1/collections/{kb[i]}/shares", body, want=422)
    alice.same("GET", lambda i: f"/api/v1/collections/{kb[i]}/shares", want=200)
    out = bob.same("GET", "/api/v1/collections/shared-with-me", want=200)
    assert len(out[1][1]) == 1
    for query in ("systolic arrays", "the mill grinds grain"):
        mine = alice.same("POST", lambda i: f"/api/v1/collections/{kb[i]}/searches",
                          {"query": query, "top_k": 3}, want=201)
        theirs = bob.same("POST", lambda i: f"/api/v1/collections/{kb[i]}/searches",
                          {"query": query, "top_k": 3}, want=201)
        assert theirs[1][1]["items"] == mine[1][1]["items"] and mine[1][1]["items"]
    # no mutation rights, no sharing onwards
    bob.same("DELETE", lambda i: f"/api/v1/collections/{kb[i]}", want=403)
    bob.same("POST", lambda i: f"/api/v1/collections/{kb[i]}/shares",
             {"username": "alice"}, want=403)
    bob.same("GET", lambda i: f"/api/v1/collections/{kb[i]}/shares", want=403)
    alice.same("DELETE", lambda i: f"/api/v1/collections/{kb[i]}/shares/bob", want=204)
    bob.same("POST", lambda i: f"/api/v1/collections/{kb[i]}/searches", {"query": "x"},
             want=403)
    bob.same("GET", "/api/v1/collections/shared-with-me", want=200)
    alice.same("DELETE", "/api/v1/collections/nope/shares/bob", want=404)


def test_marketplace_publish_subscribe_search(alice, bob, kb):
    alice.same("POST", lambda i: f"/api/v1/collections/{kb[i]}/publish", want=200)
    bob.same("POST", lambda i: f"/api/v1/collections/{kb[i]}/publish", want=403)
    out = bob.same("GET", "/api/v1/marketplace/collections", want=200)
    assert len(out[1][1]) == 1
    bob.same("POST", lambda i: f"/api/v1/marketplace/collections/{kb[i]}/subscribe", want=200)
    for path in ("/api/v1/marketplace/subscriptions",
                 "/api/v1/marketplace/collections/subscriptions"):
        bob.same("GET", path, want=200)
    mine = alice.same("POST", lambda i: f"/api/v1/collections/{kb[i]}/searches",
                      {"query": "tensor cores", "top_k": 2}, want=201)
    theirs = bob.same("POST", lambda i: f"/api/v1/collections/{kb[i]}/searches",
                      {"query": "tensor cores", "top_k": 2}, want=201)
    assert theirs[1][1]["items"] == mine[1][1]["items"]
    bob.same("GET", lambda i: f"/api/v1/collections/{kb[i]}", want=200)
    bob.same("DELETE", lambda i: f"/api/v1/collections/{kb[i]}", want=403)
    bob.same("DELETE", lambda i: f"/api/v1/marketplace/collections/{kb[i]}/subscribe",
             want=204)
    bob.same("GET", "/api/v1/marketplace/subscriptions", want=200)
    bob.same("POST", lambda i: f"/api/v1/marketplace/collections/{kb[i]}/subscribe", want=200)
    alice.same("POST", lambda i: f"/api/v1/collections/{kb[i]}/unpublish", want=200)
    bob.same("GET", "/api/v1/marketplace/collections", want=200)
    bob.same("POST", lambda i: f"/api/v1/collections/{kb[i]}/searches", {"query": "x"},
             want=403)
    bob.same("DELETE", lambda i: f"/api/v1/marketplace/collections/{kb[i]}/subscribe",
             want=204)


def test_sharing_status_and_browsing(alice, bob, kb):
    alice.same("DELETE", lambda i: f"/api/v1/collections/{kb[i]}/sharing", want=200)
    alice.same("GET", lambda i: f"/api/v1/collections/{kb[i]}/sharing", want=200)
    bob.same("GET", lambda i: f"/api/v1/marketplace/collections/{kb[i]}", want=404)
    out = alice.same("POST", lambda i: f"/api/v1/collections/{kb[i]}/sharing", want=200)
    assert out[1][1]["is_published"] is True
    bob.same("GET", lambda i: f"/api/v1/collections/{kb[i]}/sharing", want=403)
    bob.same("GET", lambda i: f"/api/v1/marketplace/collections/{kb[i]}", want=200)
    for q in ("", "?page=1&page_size=2", "?limit=1"):
        out = bob.same("GET", lambda i: f"/api/v1/marketplace/collections/{kb[i]}/documents{q}",
                       want=200)
    docs = alice.call("GET", lambda i: f"/api/v1/collections/{kb[i]}/documents")
    dids = [b[0]["id"] for _, b in docs]
    objs = [b[0]["object_path"] for _, b in docs]
    base = lambda i: f"/api/v1/marketplace/collections/{kb[i]}/documents/{dids[i]}"  # noqa: E731
    bob.same("GET", lambda i: base(i) + "/preview", want=200)
    bob.same("GET", lambda i: base(i) + "/object", want=200)
    bob.same("GET", lambda i: base(i) + "/object", headers={"Range": "bytes=0-3"}, want=206)
    bob.same("GET", lambda i: base(i) + "/object", headers={"Range": "bytes=-5"}, want=206)
    bob.same("GET", lambda i: base(i) + f"/object?path={objs[i]}", want=200)
    bob.same("GET", lambda i: base(i) + "/object?path=../../etc/passwd", want=403)
    bob.same("GET", lambda i: base(i) + "/object?path=" + objs[i].rsplit("/", 1)[0]
             + "/missing", want=404)
    bob.same("GET", lambda i: f"/api/v1/marketplace/collections/{kb[i]}/documents/nope/preview",
             want=404)
    bob.same("GET", lambda i: f"/api/v1/marketplace/collections/{kb[i]}/graph?limit=5",
             want=200)
    alice.same("DELETE", lambda i: f"/api/v1/collections/{kb[i]}/sharing", want=200)
    bob.same("GET", lambda i: base(i) + "/preview", want=404)
    # a deleted collection is not browsable, even with its row left PUBLISHED
    short = [b["id"] for _, b in alice.same("POST", "/api/v1/collections",
                                            {"title": "shortlived"}, want=201)]
    alice.same("POST", lambda i: f"/api/v1/collections/{short[i]}/sharing", want=200)
    alice.same("DELETE", lambda i: f"/api/v1/collections/{short[i]}", want=204)
    bob.same("GET", lambda i: f"/api/v1/marketplace/collections/{short[i]}", want=404)
    bob.same("GET", lambda i: f"/api/v1/marketplace/collections/{short[i]}/documents",
             want=404)
    bob.same("GET", "/api/v1/marketplace/collections", want=200)


def test_audit_logs(apps, alice, bob):
    bob.same("GET", "/api/v1/collections", want=200)
    bob.same("POST", "/api/v1/collections", {"title": "audited"}, want=201)
    out = bob.call("POST", "/api/v1/auth/login", {"username": "bob", "password": "hunter222"})
    assert [s for s, _ in out] == [200, 200]  # its row's request and response: redacted

    def rows(pair, path):
        out = pair.call("GET", path)
        assert [s for s, _ in out] == [200, 200], out
        return [b for _, b in out]

    def strip(rows_):
        """A row's own id and the times in the bodies it kept taken out."""
        return [{k: re.sub(r'"(created|updated|published_at)": [0-9.]+', r'"\1": 0', v)
                 if isinstance(v, str) else v for k, v in r.items() if k != "id"}
                for r in rows_]

    for path in ("/api/v1/audit_logs?limit=4", "/api/v1/audit-logs?limit=3&offset=1"):
        got = rows(bob, path)
        assert_same(bob.namers[0](strip(got[0])), bob.namers[1](strip(got[1])), path)
        assert {r["user"] for r in got[1]} == {"bob"}
        assert got[1][0]["request"] == "<redacted>" or got[1][0]["path"].startswith("/api/v1")
    # the admin (the first account) sees every user's rows
    admin = rows(alice, "/api/v1/audit_logs?limit=50")
    assert {"alice", "bob"} <= {r["user"] for r in admin[1]}
    assert {r["user"] for r in admin[0]} == {r["user"] for r in admin[1]}
    mine = rows(bob, "/api/v1/audit_logs?limit=1")
    aids = [b[0]["id"] for b in mine]
    for path in ("audit_logs", "audit-logs"):
        out = bob.call("GET", lambda i: f"/api/v1/{path}/{aids[i]}")
        assert [s for s, _ in out] == [200, 200]
        got = [b for _, b in alice.call("GET", lambda i: f"/api/v1/{path}/{aids[i]}")]
        assert_same(alice.namers[0](strip(got[:1])), alice.namers[1](strip(got[1:])), path)
    alice_rows = rows(alice, "/api/v1/audit_logs?limit=200")
    theirs = [[r["id"] for r in b if r["user"] == "alice"][0] for b in alice_rows]
    bob.same("GET", lambda i: f"/api/v1/audit_logs/{theirs[i]}", want=404)
    bob.same("GET", "/api/v1/audit_logs/999999999", want=404)
    for i in range(2):
        st, _ = Client(apps[i].port).call("GET", "/api/v1/audit_logs")
        assert st == 401
