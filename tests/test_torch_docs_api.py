"""The port's account, document and image routes against the JAX app's,
over real sockets.

Both apps boot on ``port=0`` with the same Settings, as in
``test_torch_api.py``; each test sends the same requests to both and
compares statuses and bodies with each app's own ids mapped to shared
names.  The OAuth provider is served in this process.  The JAX app's OCR
is switched off (``default_ocr`` -> None) so both apps index an image by
its caption alone; ``test_ocr_is_the_tesseract_cli_only`` shows the
difference that remains when it is on.
"""

import base64
import http.client
import http.server
import io
import json
import os
import re
import tarfile
import threading
import zipfile
from urllib.parse import parse_qs, urlsplit

import numpy as np
import pytest
import torch

from super_rag_tpu.app import App as JApp
from super_rag_tpu.config import Settings as JSettings
from super_rag_tpu.fileparser import ocr as jocr
from super_rag_tpu.fileparser.parser import DocParser as JDocParser
from super_rag_tpu_torch.app import App as TApp
from super_rag_tpu_torch.config import Settings as TSettings
from super_rag_tpu_torch.fileparser import ocr as tocr
from super_rag_tpu_torch.fileparser.parser import DocParser as TDocParser
from test_torch_api import SCORE_TOL, SETTINGS, Client, ServerThread, both
from test_torch_image_codec import bmp_bytes, png_bytes, smooth_image
from test_torch_ingest_backends import write_7z

PASSWORD = "secret123"
JAX_DEFAULT_OCR = jocr.default_ocr  # the apps fixture switches it off


def _items(body):
    return [_strip({k: v for k, v in it.items() if k != "score"}) for it in body["items"]]


def _same_items(b0, b1):
    assert _items(b0) == _items(b1), (b0, b1)
    for a, b in zip(b0["items"], b1["items"]):
        assert abs(a["score"] - b["score"]) <= SCORE_TOL, (a, b)


class _Provider(http.server.BaseHTTPRequestHandler):
    """A tiny OAuth provider: a token endpoint and a userinfo endpoint."""

    def log_message(self, *args):
        pass

    def _json(self, obj, status=200):
        data = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_POST(self):
        form = parse_qs(self.rfile.read(int(self.headers["Content-Length"])).decode())
        ok = form.get("code") == ["good-code"] and form.get("client_secret") == ["sek"]
        self._json({"access_token": "tok-1"} if ok else {})

    def do_GET(self):
        if self.headers.get("Authorization") != "Bearer tok-1":
            return self._json({}, 401)
        self._json({"id": 4242, "login": "octo", "email": "octo@example.com"})


@pytest.fixture(scope="module")
def provider():
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Provider)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


@pytest.fixture(scope="module")
def apps(tmp_path_factory, provider):
    torch.set_num_threads(2)
    oauth = json.dumps({"gh": {
        "client_id": "cid", "client_secret": "sek",
        "authorize_url": f"{provider}/authorize", "token_url": f"{provider}/token",
        "userinfo_url": f"{provider}/user", "scope": "user:email",
        "username_field": "login"}})
    mp = pytest.MonkeyPatch()
    mp.setattr(jocr, "default_ocr", lambda: None)
    ref = ServerThread(lambda: JApp(JSettings(
        data_dir=str(tmp_path_factory.mktemp("jax")), oauth_providers_json=oauth,
        **SETTINGS), background_tasks=False))
    port = ServerThread(lambda: TApp(TSettings(
        data_dir=str(tmp_path_factory.mktemp("torch")), oauth_providers_json=oauth,
        **SETTINGS), background_tasks=False, device="cpu"))
    yield ref, port
    ref.stop()
    port.stop()
    mp.undo()


@pytest.fixture(scope="module")
def clients(apps):
    # the first user of each app is its admin
    return (Client(apps[0].port).login("admin", PASSWORD),
            Client(apps[1].port).login("admin", PASSWORD))


def _strip(obj, drop=("id", "created", "updated", "collection_id", "object_path",
                      "key", "user", "upload_id", "token", "authorization_url",
                      "state", "last_used", "document_id", "asset_id")):
    """A body with each app's own ids and times dropped."""
    if isinstance(obj, dict):
        return {k: _strip(v, drop) for k, v in obj.items() if k not in drop}
    if isinstance(obj, list):
        return [_strip(v, drop) for v in obj]
    if isinstance(obj, str):  # ids inside messages
        return re.sub(r"\b(\w+-)?[0-9a-f]{16,}\b", "<id>", obj)
    return obj


def _same(out, status):
    (s0, b0), (s1, b1) = out
    assert s0 == s1 == status, out
    assert _strip(b0) == _strip(b1), out
    return b0, b1


def _get_bytes(client, path):
    conn = http.client.HTTPConnection("127.0.0.1", client.port, timeout=60)
    try:
        conn.request("GET", path, headers={"Authorization": f"Bearer {client.token}"})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def _multipart(files):
    boundary = "b0undaryXY"
    raw = b""
    for name, data in files:
        raw += (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
                f"filename=\"{name}\"\r\nContent-Type: application/octet-stream"
                "\r\n\r\n").encode() + data + b"\r\n"
    raw += f"--{boundary}--\r\n".encode()
    return raw, {"Content-Type": f"multipart/form-data; boundary={boundary}"}


def _collection(clients, title, config=None):
    out = both(clients, "POST", "/api/v1/collections",
               {"title": title, **({"config": config} if config else {})})
    assert [s for s, _ in out] == [201, 201], out
    return [b["id"] for _, b in out]


def _upload_files(clients, cids, files):
    raw, headers = _multipart(files)
    out = [c.call("POST", f"/api/v1/collections/{cid}/documents", raw=raw,
                  headers=headers) for c, cid in zip(clients, cids)]
    b0, b1 = _same(out, 201)
    return [{d["name"]: d["id"] for d in b} for b in (b0, b1)]


# -- accounts -------------------------------------------------------------------------


def test_api_keys_match(clients):
    out = both(clients, "POST", "/api/v1/apikeys", {"description": "ci"})
    _same(out, 201)
    keys = [b["key"] for _, b in out]
    assert all(k.startswith("sk-") for k in keys)
    _same(both(clients, "POST", "/api/v1/apikeys", {"description": 5}), 422)
    listed = _same(both(clients, "GET", "/api/v1/apikeys"), 200)
    kids = [[k["id"] for k in b if k["description"] == "ci"][0] for b in listed]
    for i, key in enumerate(keys):
        c = Client(clients[i].port)
        c.token = key
        assert c.call("GET", "/api/v1/users/me")[0] == 200
    _same(both(clients, "DELETE", "/api/v1/apikeys/nope"), 404)
    out = [c.call("DELETE", f"/api/v1/apikeys/{kid}") for c, kid in zip(clients, kids)]
    assert [s for s, _ in out] == [204, 204]
    for i, key in enumerate(keys):
        c = Client(clients[i].port)
        c.token = key
        assert c.call("GET", "/api/v1/users/me")[0] == 401


def test_users_and_change_password_match(apps, clients):
    bobs = [Client(a.port).login("bob", PASSWORD) for a in apps]
    _same(both(bobs, "GET", "/api/v1/users"), 403)
    users = _same(both(clients, "GET", "/api/v1/users"), 200)
    assert sorted(u["username"] for u in users[0]) == ["admin", "bob"]
    _same(both(bobs, "POST", "/api/v1/change-password",
               {"old_password": "wrong-one", "new_password": "n3w-password"}), 400)
    _same(both(bobs, "POST", "/api/v1/change-password",
               {"old_password": PASSWORD, "new_password": "short"}), 422)
    _same(both(bobs, "POST", "/api/v1/change-password",
               {"username": "admin", "old_password": PASSWORD,
                "new_password": "n3w-password"}), 403)
    _same(both(bobs, "POST", "/api/v1/change-password",
               {"old_password": PASSWORD, "new_password": "n3w-password"}), 200)
    for a in apps:
        c = Client(a.port)
        assert c.call("POST", "/api/v1/auth/login",
                      {"username": "bob", "password": PASSWORD})[0] == 401
        assert c.call("POST", "/api/v1/auth/login",
                      {"username": "bob", "password": "n3w-password"})[0] == 200
    me = [c.call("GET", "/api/v1/users/me")[1]["id"] for c in clients]
    _same([c.call("DELETE", f"/api/v1/users/{uid}") for c, uid in zip(clients, me)], 400)
    _same(both(clients, "DELETE", "/api/v1/users/no-such-user"), 404)
    bob_ids = [[u["id"] for u in b if u["username"] == "bob"][0] for b in users]
    out = [c.call("DELETE", f"/api/v1/users/{uid}") for c, uid in zip(clients, bob_ids)]
    assert [s for s, _ in out] == [204, 204]


def test_oauth_routes_match(apps, clients):
    out = both(clients, "GET", "/api/v1/auth/oauth/gh/authorize")
    (s0, b0), (s1, b1) = out
    assert s0 == s1 == 200
    q = [parse_qs(urlsplit(b["authorization_url"]).query) for b in (b0, b1)]
    assert [{k: v for k, v in x.items() if k not in ("state", "redirect_uri")}
            for x in q] == [{"client_id": ["cid"], "response_type": ["code"],
                             "scope": ["user:email"]}] * 2
    _same(both(clients, "GET", "/api/v1/auth/oauth/nope/authorize"), 404)
    _same(both(clients, "GET", "/api/v1/auth/oauth/gh/callback"), 422)
    _same(both(clients, "GET", "/api/v1/auth/oauth/gh/callback?code=x&state=bad"), 401)
    states = [b0["state"], b1["state"]]
    out = [Client(a.port).call("GET", f"/api/v1/auth/oauth/gh/callback?code=bad&state={s}")
           for a, s in zip(apps, states)]
    _same(out, 401)
    out = [Client(a.port).call(
        "GET", f"/api/v1/auth/oauth/gh/callback?code=good-code&state={s}")
        for a, s in zip(apps, states)]
    b0, b1 = _same(out, 200)
    assert b0["user"]["username"] == "octo"
    octos = []
    for a, b in zip(apps, (b0, b1)):
        c = Client(a.port)
        c.token = b["token"]
        octos.append(c)
    accounts = _same(both(octos, "GET", "/api/v1/users/me/oauth_accounts"), 200)
    assert accounts[0] and accounts[0][0]["provider"] == "gh"


# -- documents ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def docs(clients):
    cids = _collection(clients, "docs")
    files = [(f"doc{i}.md", f"# Doc {i}\n\n" .encode()
              + b" ".join(b"word%d" % ((i * 7 + j) % 50) for j in range(300)))
             for i in range(6)]
    return cids, _upload_files(clients, cids, files)


def test_two_phase_upload_matches(clients, docs):
    cids, _ = docs
    raw, headers = _multipart([("staged.md", b"# Staged\n\nstaged body text"),
                               ("other.txt", b"other staged text")])
    out = [c.call("POST", f"/api/v1/collections/{cid}/documents/upload", raw=raw,
                  headers=headers) for c, cid in zip(clients, cids)]
    staged = _same(out, 201)
    raw_empty, h_empty = _multipart([])
    _same([c.call("POST", f"/api/v1/collections/{cid}/documents/upload",
                  raw=raw_empty, headers=h_empty)
           for c, cid in zip(clients, cids)], 422)
    out = [c.call("POST", f"/api/v1/collections/{cid}/documents/confirm", s)
           for c, cid, s in zip(clients, cids, staged)]
    _same(out, 201)
    _same([c.call("POST", f"/api/v1/collections/{cid}/documents/confirm", s[0])
           for c, cid, s in zip(clients, cids, staged)], 404)
    _same([c.call("POST", f"/api/v1/collections/{cid}/documents/confirm",
                  {"upload_id": "nope", "name": "x.md"})
           for c, cid in zip(clients, cids)], 404)


def _tree(root):
    """Every file under ``root`` with its bytes, keyed by relative path."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            full = os.path.join(dirpath, f)
            with open(full, "rb") as fh:
                out[os.path.relpath(full, root)] = fh.read()
    return out


@pytest.mark.parametrize("attack", ["stage_name", "stage_size", "confirm_name",
                                    "confirm_backslash", "confirm_upload_id",
                                    "create_json", "create_multipart"])
def test_port_keeps_upload_keys_inside_the_callers_collection(apps, clients, docs,
                                                              attack):
    """The port refuses a client name or upload id that would carry an
    object key out of the caller's collection (the JAX app builds those
    keys unchecked: a kept difference), and stages nothing over the size
    limit.  No object outside the caller's own collection changes."""
    app, admin = apps[1].app, clients[1]
    victim_cid = docs[0][1]
    victim = admin.call("GET", f"/api/v1/documents/{docs[1][1]['doc0.md']}")[1]
    target = victim["object_path"]  # "{cid}/{hash16}/doc0.md"
    mallory = Client(apps[1].port)
    if mallory.call("POST", "/api/v1/auth/login",
                    {"username": "mallory", "password": PASSWORD})[0] == 200:
        mallory.token = mallory.call("POST", "/api/v1/auth/login", {
            "username": "mallory", "password": PASSWORD})[1]["token"]
    else:
        mallory.login("mallory", PASSWORD)
    status, coll = mallory.call("POST", "/api/v1/collections", {"title": f"m-{attack}"})
    assert status == 201
    cid = coll["id"]
    root = app.ctx.objects.root
    before = _tree(root)
    up = f"/api/v1/collections/{cid}/documents"
    climb = f"../../../{target}"
    if attack == "stage_name":
        raw, h = _multipart([("ok.md", b"fine"), (climb, b"pwned")])
        assert mallory.call("POST", up + "/upload", raw=raw, headers=h)[0] == 422
    elif attack == "stage_size":
        limit = app.ctx.cfg.max_document_size_mb
        app.ctx.cfg.max_document_size_mb = 1
        try:
            raw, h = _multipart([("big.md", b"x" * (1024 * 1024 + 1))])
            assert mallory.call("POST", up + "/upload", raw=raw, headers=h)[0] == 413
        finally:
            app.ctx.cfg.max_document_size_mb = limit
    elif attack.startswith("confirm"):
        raw, h = _multipart([("ok.md", b"staged by mallory")])
        status, staged = mallory.call("POST", up + "/upload", raw=raw, headers=h)
        assert status == 201
        before = _tree(root)  # the staged object is mallory's own
        item = {"confirm_name": {"upload_id": staged[0]["upload_id"], "name": climb},
                "confirm_backslash": {"upload_id": staged[0]["upload_id"],
                                      "name": "..\\ok.md"},
                "confirm_upload_id": {"upload_id": f"../../{target.rsplit('/', 1)[0]}",
                                      "name": "doc0.md"}}[attack]
        want = 404 if attack == "confirm_upload_id" else 422
        assert mallory.call("POST", up + "/confirm", item)[0] == want
    elif attack == "create_json":
        assert mallory.call("POST", up, {"name": f"../../{target}",
                                         "content": "pwned"})[0] == 422
    else:
        raw, h = _multipart([(f"a/../../../../{target}", b"pwned")])
        assert mallory.call("POST", up, raw=raw, headers=h)[0] == 422
    after = _tree(root)
    assert after == before
    assert _get_bytes(admin, f"/api/v1/collections/{victim_cid}/documents/"
                             f"{victim['id']}/object")[2] == before[target]


@pytest.mark.parametrize("route", ["flat", "nested"])
def test_preview_and_object_ranges_match(clients, docs, route):
    cids, dids = docs

    def path(i, suffix="preview"):
        did = dids[i]["doc1.md"]
        if route == "flat":
            return f"/api/v1/documents/{did}/{suffix}"
        return f"/api/v1/collections/{cids[i]}/documents/{did}/{suffix}"

    full = None
    for rng in (None, "bytes=10-99", "bytes=-50", "bytes=abc", "bytes=5-",
                "bytes=100000-200000", "bytes=40-20"):
        headers = {"Range": rng} if rng else None
        (s0, b0), (s1, b1) = [c.call("GET", path(i), headers=headers)
                              for i, c in enumerate(clients)]
        assert s0 == s1 and b0 == b1, (rng, s0, s1)
        if rng is None:
            full = b1
            assert s1 == 200 and full.startswith("# Doc 1")
        elif rng == "bytes=10-99":
            assert s1 == 206 and b1 == full[10:100]
        elif rng == "bytes=-50":
            assert s1 == 206 and b1 == full[-50:]
        elif rng == "bytes=abc":
            assert s1 == 200 and b1 == full
    if route == "nested":
        (s0, b0), (s1, b1) = [c.call("GET", path(i, "object")) for i, c in enumerate(clients)]
        assert s0 == s1 == 200 and b0 == b1 == full
        _same([c.call("GET", path(i, "object") + "?path=../../x")
               for i, c in enumerate(clients)], 403)
        _same([c.call("GET", path(i, "object") + "?path=" + "../" + cids[i] + "/zz")
               for i, c in enumerate(clients)], 403)


def test_rebuild_routes_match(clients, docs):
    cids, dids = docs
    _same([c.call("POST", f"/api/v1/documents/{dids[i]['doc2.md']}/rebuild_indexes")
           for i, c in enumerate(clients)], 200)
    _same([c.call("POST", f"/api/v1/collections/{cids[i]}/documents/"
                  f"{dids[i]['doc3.md']}/rebuild_indexes?only_failed=1")
           for i, c in enumerate(clients)], 200)
    out = _same([c.call("POST", f"/api/v1/collections/{cid}/rebuild_failed_indexes")
                 for c, cid in zip(clients, cids)], 200)
    assert out[0] == {"rebuilt": 0}
    out = _same([c.call("POST", f"/api/v1/collections/{cid}/rebuild_indexes")
                 for c, cid in zip(clients, cids)], 200)
    assert out[0]["rebuilt"] >= 6
    lists = _same([c.call("GET", f"/api/v1/collections/{cid}/documents")
                   for c, cid in zip(clients, cids)], 200)
    assert {d["status"] for d in lists[1]} == {"COMPLETE"}


def test_bulk_delete_matches(clients, docs):
    cids, dids = docs
    out = [c.call("DELETE", f"/api/v1/collections/{cid}/documents",
                  {"document_ids": [dids[i]["doc4.md"], "unknown-doc"]})
           for i, (c, cid) in enumerate(zip(clients, cids))]
    _same(out, 404)
    _same([c.call("GET", f"/api/v1/documents/{dids[i]['doc4.md']}")
           for i, c in enumerate(clients)], 200)
    _same([c.call("DELETE", f"/api/v1/collections/{cid}/documents", {"document_ids": []})
           for c, cid in zip(clients, cids)], 422)
    out = [c.call("DELETE", f"/api/v1/collections/{cid}/documents",
                  [dids[i]["doc4.md"], dids[i]["doc5.md"]])
           for i, (c, cid) in enumerate(zip(clients, cids))]
    (s0, b0), (s1, b1) = out
    assert s0 == s1 == 200
    assert b1 == {"deleted": [dids[1]["doc4.md"], dids[1]["doc5.md"]]}
    _same([c.call("GET", f"/api/v1/documents/{dids[i]['doc5.md']}")
           for i, c in enumerate(clients)], 404)


@pytest.mark.parametrize("kind", ["zip", "tar.gz", "7z"])
def test_archive_upload_matches(clients, kind):
    cids = _collection(clients, f"arch-{kind}")
    members = [("a/one.md", b"# One\n\narchive member one about rivers"),
               ("two.txt", b"archive member two about mills"),
               ("../escape.txt", b"must be skipped")]
    buf = io.BytesIO()
    if kind == "zip":
        with zipfile.ZipFile(buf, "w") as z:
            for n, d in members:
                z.writestr(n, d)
    elif kind == "tar.gz":
        with tarfile.open(fileobj=buf, mode="w:gz") as t:
            for n, d in members:
                info = tarfile.TarInfo(n)
                info.size = len(d)
                t.addfile(info, io.BytesIO(d))
    else:
        buf.write(write_7z(members))
    names = _upload_files(clients, cids, [(f"bundle.{kind}", buf.getvalue())])
    assert sorted(names[1]) == ["a/one.md", "two.txt"]
    _same([c.call("GET", f"/api/v1/documents/{names[i]['two.txt']}/chunks")
           for i, c in enumerate(clients)], 200)


# -- images ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def images():
    out = []
    for i in range(6):
        arr = smooth_image(64 + 16 * i, 96, seed=i)
        out.append((f"img{i}.png", png_bytes(arr)) if i % 2 == 0
                   else (f"img{i}.bmp", bmp_bytes(arr)))
    return out


@pytest.fixture(scope="module")
def vision(clients, images):
    cids = _collection(clients, "pics", {"enable_vision": True})
    return cids, _upload_files(clients, cids, images)


def test_image_documents_index_vision_rows_alike(clients, vision, images):
    cids, dids = vision
    lists = _same([c.call("GET", f"/api/v1/collections/{cid}/documents")
                   for c, cid in zip(clients, cids)], 200)
    assert {d["status"] for d in lists[1]} == {"COMPLETE"}
    assert {i["index_type"] for i in lists[1][0]["indexes"]} == {"vector", "vision"}
    for name, _ in images:
        chunks = _same([c.call("GET", f"/api/v1/documents/{dids[i][name]}/chunks")
                        for i, c in enumerate(clients)], 200)
        assert f"Image in {name}: {name}" in [ch["text"] for ch in chunks[1]]


def test_image_search_matches(apps, clients, vision, images):
    cids, dids = vision
    for name, data in images:
        body = {"image_base64": base64.b64encode(data).decode(), "top_k": 3}
        (s0, b0), (s1, b1) = [c.call("POST", f"/api/v1/collections/{cid}/searches/image",
                                     body) for c, cid in zip(clients, cids)]
        assert s0 == s1 == 201
        assert len(b0["items"]) == len(b1["items"]) == 3
        _same_items(b0, b1)
        assert b1["items"][0]["document_id"] == dids[1][name]
        asset = b1["items"][0]["asset_id"]
        assert b0["items"][0]["asset_id"] == asset
        for c, cid in zip(clients, cids):
            assert _get_bytes(c, f"/api/v1/collections/{cid}/assets/{asset}")[::2] == (
                200, data)
    _same([c.call("GET", f"/api/v1/collections/{cid}/assets/nope")
           for c, cid in zip(clients, cids)], 404)
    _same([c.call("POST", f"/api/v1/collections/{cid}/searches/image",
                  {"image_base64": "abc"}) for c, cid in zip(clients, cids)], 422)
    _same([c.call("POST", f"/api/v1/collections/{cid}/searches/image",
                  {"image_base64": "abcde"}) for c, cid in zip(clients, cids)], 422)
    # bytes that are no image embed to zeros in both: the same answer
    out = [c.call("POST", f"/api/v1/collections/{cid}/searches/image",
                  {"image_base64": base64.b64encode(b"not an image").decode()})
           for c, cid in zip(clients, cids)]
    assert [s for s, _ in out] == [201, 201]


def test_image_search_decodes_in_a_worker_process(monkeypatch, apps, clients, vision,
                                                  images):
    """The port's image route runs the pure-Python decode in a host worker
    subprocess (it holds neither the event loop nor the GIL that device
    searches need) and the dense search on the batcher's worker, in turn
    with the text batches."""
    from super_rag_tpu_torch.engine.collection import CollectionEngine
    from super_rag_tpu_torch.tasks.scheduler import WorkerProcess

    calls = []
    real_call = WorkerProcess.call

    def call(self, req):
        calls.append((self.proc.pid, req["op"], req.get("dim")))
        return real_call(self, req)
    monkeypatch.setattr(WorkerProcess, "call", call)
    seen = {}
    orig = CollectionEngine.search_image_vector

    def spy(self, *a, **kw):
        seen["search"] = threading.current_thread().name
        return orig(self, *a, **kw)
    monkeypatch.setattr(CollectionEngine, "search_image_vector", spy)
    cid = vision[0][1]
    body = {"image_base64": base64.b64encode(images[0][1]).decode(), "top_k": 2}
    status, out = clients[1].call("POST", f"/api/v1/collections/{cid}/searches/image", body)
    assert status == 201 and len(out["items"]) == 2
    dim = apps[1].app.ctx.engines.get(cid).image_query_dim()
    assert [c[1:] for c in calls] == [("embed_image", dim)]
    assert calls[0][0] != os.getpid()
    assert seen["search"].startswith("batcher"), seen
    q = apps[1].app.ctx.embed_image(images[0][1], dim)
    from super_rag_tpu_torch.models.image_embedder import embed_image
    np.testing.assert_array_equal(q, embed_image(images[0][1], dim))  # the same bits


def test_image_search_refuses_formats_it_does_not_decode(clients, vision):
    """A kept difference: a GIF embeds to zeros in the JAX app (Pillow
    decodes it; the port does not) and answers 201; the port answers 415
    and names the format instead of searching with a zero vector."""
    cids, _ = vision
    gif = base64.b64encode(b"GIF89a" + bytes(40)).decode()
    (s0, _), (s1, b1) = [c.call("POST", f"/api/v1/collections/{cid}/searches/image",
                                {"image_base64": gif}) for c, cid in zip(clients, cids)]
    assert s0 == 201 and s1 == 415
    assert "GIF" in b1["error"]["message"]


def test_image_search_finds_its_asset_after_rebuild_and_delete(apps, clients, vision,
                                                                images):
    cids, dids = vision
    name, data = images[0]
    for i, c in enumerate(clients):
        assert c.call("POST", f"/api/v1/documents/{dids[i][name]}/rebuild_indexes")[0] == 200
    body = {"image_base64": base64.b64encode(data).decode(), "top_k": 3}
    (s0, b0), (s1, b1) = [c.call("POST", f"/api/v1/collections/{cid}/searches/image",
                                 body) for c, cid in zip(clients, cids)]
    assert s0 == s1 == 201 and b1["items"][0]["document_id"] == dids[1][name]
    _same_items(b0, b1)
    out = [c.call("DELETE", f"/api/v1/collections/{cid}/documents", [dids[i][name]])
           for i, (c, cid) in enumerate(zip(clients, cids))]
    assert [s for s, _ in out] == [200, 200]
    (s0, b0), (s1, b1) = [c.call("POST", f"/api/v1/collections/{cid}/searches/image",
                                 body) for c, cid in zip(clients, cids)]
    assert s0 == s1 == 201
    assert dids[1][name] not in [it["document_id"] for it in b1["items"]]
    _same_items(b0, b1)


def test_ocr_is_the_tesseract_cli_only(monkeypatch):
    """A kept difference: the JAX package's OCR chain ends in a Pillow
    glyph engine that reads rendered text; the port's is the tesseract
    CLI only, so without it an image indexes only its caption."""
    pytest.importorskip("PIL")
    from PIL import Image, ImageDraw

    img = Image.new("L", (320, 60), 255)
    ImageDraw.Draw(img).text((10, 20), "HELLO WORLD 123", fill=0)
    buf = io.BytesIO()
    img.save(buf, "PNG")
    data = buf.getvalue()
    monkeypatch.setattr(jocr, "default_ocr", JAX_DEFAULT_OCR)
    monkeypatch.setattr(tocr.shutil, "which", lambda name: None)
    assert tocr.default_ocr() is None
    assert jocr.default_ocr() is not None
    ported = TDocParser().parse_file("scan.png", data)
    ref = JDocParser().parse_file("scan.png", data)
    assert [type(p).__name__ for p in ported] == ["AssetBinPart", "ImagePart"]
    assert [type(p).__name__ for p in ref][-2:] == ["AssetBinPart", "ImagePart"]
    assert [p.content for p in ref[-2:]] == [p.content for p in ported]
    # with a tesseract binary on the PATH the port reads the text through it
    calls = []

    class FakeTesseract(tocr.TesseractOCR):
        def image_to_text(self, image_bytes):
            calls.append(len(image_bytes))
            return "HELLO WORLD 123"

    monkeypatch.setattr(tocr, "default_ocr", lambda: FakeTesseract())
    parts = TDocParser().parse_file("scan.png", data)
    assert [type(p).__name__ for p in parts] == ["TextPart", "AssetBinPart", "ImagePart"]
    assert parts[0].content == "HELLO WORLD 123" and calls == [len(data)]
    assert tocr.ocr_images([("image/png", data)], FakeTesseract()) == ["HELLO WORLD 123"]
