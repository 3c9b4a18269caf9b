"""The knowledge-graph routes and the six document formats of the port's
app against the JAX package's, over real sockets.

Both apps (the port's on ``device="cpu"``) get a collection with
``enable_knowledge_graph`` and one document of each of .pdf (with a
FlateDecode RGB image), .docx, .xlsx, .pptx, .doc and .ppt, written by
``chip_smoke``'s stdlib writers from a seed.  The chunks, labels, stats,
subgraph, graph searches and ``use_graph`` searches must agree: ids are
each app's own uuids, so the comparisons go by names, facts and texts,
and searches up to ties.  Community membership is left out: label
propagation visits nodes in the order of their ids.  Neither app OCRs
(the JAX app's ``default_ocr`` is switched off)."""

import base64
import http.client
import io

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from super_rag_tpu.app import App as JApp
from super_rag_tpu.config import Settings as JSettings
from super_rag_tpu.fileparser import ocr as jocr
from super_rag_tpu_torch.app import App as TApp
from super_rag_tpu_torch.config import Settings as TSettings

from test_torch_api import SCORE_TOL, SETTINGS, Client, ServerThread, both

DOCS, ORGS = chip_smoke.graph_corpus(5, per_format=1, sentences=12)
NAMES = [n for n, _, _ in DOCS]


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    torch.set_num_threads(2)
    mp = pytest.MonkeyPatch()
    mp.setattr(jocr, "default_ocr", lambda: None)
    ref = ServerThread(lambda: JApp(JSettings(
        data_dir=str(tmp_path_factory.mktemp("jax")), **SETTINGS), background_tasks=False))
    port = ServerThread(lambda: TApp(TSettings(
        data_dir=str(tmp_path_factory.mktemp("torch")), **SETTINGS),
        background_tasks=False, device="cpu"))
    yield ref, port
    ref.stop()
    port.stop()
    mp.undo()


@pytest.fixture(scope="module")
def clients(apps):
    return Client(apps[0].port).login(), Client(apps[1].port).login()


@pytest.fixture(scope="module")
def graph(clients):
    """A graph collection in each app with the six documents; returns the
    collection ids and each app's document ids by name."""
    out = both(clients, "POST", "/api/v1/collections",
               {"title": "kg", "config": {"enable_knowledge_graph": True}})
    assert [s for s, _ in out] == [201, 201], out
    cids = [b["id"] for _, b in out]
    dids = [{}, {}]
    for name, data, _ in DOCS:
        for i, (c, cid) in enumerate(zip(clients, cids)):
            status, body = c.call("POST", f"/api/v1/collections/{cid}/documents", {
                "name": name, "content_base64": base64.b64encode(data).decode()})
            assert status == 201, body
            assert body[0]["status"] == "COMPLETE", body
            dids[i][name] = body[0]["id"]
    return cids, dids


def _edge(r):
    return (r["fact"], r["source"], r["target"], r["relation"])


def _node(r):
    return (r["name"], r["label"], tuple(r["facts"]))


def _episode(r):
    return (r["preview"],)


def same_up_to_ties(want, got, key):
    assert len(got) == len(want), (got, want)
    ws = np.asarray([r["score"] for r in want], np.float64)
    gs = np.asarray([r["score"] for r in got], np.float64)
    np.testing.assert_allclose(gs, ws, rtol=SCORE_TOL, atol=SCORE_TOL)
    i = 0
    while i < len(want):
        j = i + 1
        while j < len(want) and abs(ws[j] - ws[i]) <= SCORE_TOL:
            j += 1
        if j < len(want):
            assert sorted(map(key, want[i:j])) == sorted(map(key, got[i:j])), (want, got)
        i = j


def test_six_formats_index_alike(clients, graph):
    cids, dids = graph
    for name, _, sents in DOCS:
        (s0, c0), (s1, c1) = both(clients, "GET",
                                  lambda i: f"/api/v1/documents/{dids[i][name]}/chunks")
        assert s0 == s1 == 200
        assert c1 == c0 and c0, name
        text = " ".join(" ".join(ch["text"] for ch in c1).split())
        assert all(s in text for s in sents), name
        (_, d0), (_, d1) = both(clients, "GET", lambda i: f"/api/v1/documents/{dids[i][name]}")
        idx = sorted((x["index_type"], x["status"], x["error_message"]) for x in d1["indexes"])
        assert idx == sorted((x["index_type"], x["status"], x["error_message"])
                             for x in d0["indexes"])
        assert [i[0] for i in idx] == ["graph", "vector"] and d1["status"] == "COMPLETE"


def test_graph_introspection_matches(clients, graph):
    cids, _ = graph
    (s0, st0), (s1, st1) = both(clients, "GET", lambda i: f"/api/v1/collections/{cids[i]}/graph/stats")
    assert s0 == s1 == 200
    assert (st1["nodes"], st1["edges"]) == (st0["nodes"], st0["edges"])
    assert st0["edges"] >= 40
    for path in ("graph/labels", "graphs/labels"):
        (_, l0), (_, l1) = both(clients, "GET", lambda i: f"/api/v1/collections/{cids[i]}/{path}")
        assert sorted(map(str, l1)) == sorted(map(str, l0))

    def sub_key(g):
        names = {n["id"]: (n["name"], n["label"]) for n in g["nodes"]}
        return (sorted(names.values()), sorted(
            (names[e["source"]], e["relation"], names[e["target"]], e["fact"])
            for e in g["edges"]))

    for q in ("", f"?node={ORGS[0].replace(' ', '%20')}", "?limit=5", "?node=nobody"):
        for path in ("graph", "graphs"):
            (s0, g0), (s1, g1) = both(clients, "GET",
                                      lambda i: f"/api/v1/collections/{cids[i]}/{path}{q}")
            assert s0 == s1 == 200
            if q == "?limit=5":  # which 5 edges is sqlite's order of uuids
                assert len(g1["edges"]) == len(g0["edges"]) == 5
            else:
                assert sub_key(g1) == sub_key(g0)


QUERIES = ["acquired", "leads since", "founded by", "develops for", "offices in",
           "supports and", "zzz"]


@pytest.mark.parametrize("extra", [{}, {"rerank": "mmr"}, {"rerank": "node_distance"},
                                   {"bfs_origin_nodes": "org"}, {"as_of": 1.0e9}])
def test_graph_search_matches(clients, graph, extra):
    cids, _ = graph
    for q in QUERIES + ORGS[:2]:
        body = {"query": q, "limit": 4, "scopes": ["edges", "nodes", "episodes"], **extra}
        if extra.get("rerank") == "node_distance":
            body["center_node"] = ORGS[1]
        if "bfs_origin_nodes" in extra:
            body["bfs_origin_nodes"] = [ORGS[0]]
        (s0, b0), (s1, b1) = both(clients, "POST",
                                  lambda i: f"/api/v1/collections/{cids[i]}/graph/search", body)
        assert s0 == s1 == 200
        assert sorted(b1) == sorted(b0)
        same_up_to_ties(b0["edges"], b1["edges"], _edge)
        same_up_to_ties(b0["nodes"], b1["nodes"], _node)
        same_up_to_ties(b0["episodes"], b1["episodes"], _episode)


def test_graph_node_episode_and_expand_routes_match(clients, graph):
    cids, _ = graph
    for q in QUERIES[:4]:
        for path, key in ((f"graph/nodes?q={q.replace(' ', '+')}&limit=4", _node),
                          (f"graph/episodes?q={q.replace(' ', '+')}", _episode)):
            (s0, b0), (s1, b1) = both(clients, "GET",
                                      lambda i: f"/api/v1/collections/{cids[i]}/{path}")
            assert s0 == s1 == 200
            same_up_to_ties(b0, b1, key)
    origins = ",".join(o.replace(" ", "%20") for o in ORGS[:2])
    for depth in (1, 2):
        (s0, b0), (s1, b1) = both(
            clients, "GET",
            lambda i: f"/api/v1/collections/{cids[i]}/graph/expand?node={origins}&depth={depth}")
        assert s0 == s1 == 200
        assert sorted((n["name"], n["label"], n["depth"]) for n in b1["nodes"]) == \
            sorted((n["name"], n["label"], n["depth"]) for n in b0["nodes"])
        assert sorted((e["fact"], e["depth"]) for e in b1["edges"]) == \
            sorted((e["fact"], e["depth"]) for e in b0["edges"])


def test_graph_route_errors_match(clients, graph):
    cids, _ = graph
    for method, path, body in (
            ("POST", "graph/search", {"query": "  "}), ("POST", "graph/search", {}),
            ("GET", "graph/nodes", None), ("GET", "graph/episodes?q=", None),
            ("GET", "graph/expand", None), ("GET", "graph/expand?node=,", None)):
        (s0, b0), (s1, b1) = both(clients, method,
                                  lambda i: f"/api/v1/collections/{cids[i]}/{path}", body)
        assert s0 == s1 == 400, (path, b0, b1)
        assert b1 == b0
    (s0, _), (s1, _) = both(clients, "GET", "/api/v1/collections/nope/graph/stats")
    assert s0 == s1 == 404


def test_use_graph_searches_match(clients, graph):
    cids, dids = graph
    maps = [{cids[i]: "kg", **{v: k for k, v in dids[i].items()}} for i in range(2)]
    for q in QUERIES + ORGS[:3]:
        for use_rerank in (True, False):
            (s0, b0), (s1, b1) = both(
                clients, "POST", lambda i: f"/api/v1/collections/{cids[i]}/searches",
                {"query": q, "use_graph": True, "use_rerank": use_rerank, "top_k": 4})
            assert s0 == s1 == 201
            got, want = b1["items"], b0["items"]
            assert len(got) == len(want)
            for a, b in zip(want, got):
                assert abs(a["score"] - b["score"]) <= SCORE_TOL, (a, b)
                ma = {k: maps[0].get(v, v) for k, v in a["metadata"].items()}
                mb = {k: maps[1].get(v, v) for k, v in b["metadata"].items()}
                assert (a["recall_type"], a["text"], ma) == (b["recall_type"], b["text"], mb)
            assert any(it["recall_type"] == "graph_search" for it in got) or q == "zzz"


def test_delete_removes_episodes_alike(apps, clients, graph):
    cids, dids = graph
    name = NAMES[1]
    out = both(clients, "DELETE", lambda i: f"/api/v1/documents/{dids[i][name]}")
    assert [s for s, _ in out] == [204, 204]
    for i, srv in enumerate(apps):
        db = srv.app.ctx.db
        assert db.query("SELECT id FROM kg_episode WHERE source=?", (dids[i][name],)) == []
    (_, st0), (_, st1) = both(clients, "GET", lambda i: f"/api/v1/collections/{cids[i]}/graph/stats")
    assert (st1["nodes"], st1["edges"]) == (st0["nodes"], st0["edges"])
    for q in QUERIES:
        (_, b0), (_, b1) = both(clients, "POST",
                                lambda i: f"/api/v1/collections/{cids[i]}/graph/search",
                                {"query": q, "scopes": ["edges"]})
        same_up_to_ties(b0["edges"], b1["edges"], _edge)


def test_pdf_flate_image_embeds_alike(clients):
    """A PDF's FlateDecode image becomes a PNG whose pixels are the same
    in both apps (the JAX app writes it with Pillow, the port with zlib),
    so its vision row has the same image embedding: an image search
    scores it alike.  The asset ids differ (they hash the PNG bytes)."""
    out = both(clients, "POST", "/api/v1/collections",
               {"title": "vision", "config": {"enable_vision": True}})
    cids = [b["id"] for _, b in out]
    img = chip_smoke.smooth_images(1, 40, 3)[0]
    pdf = chip_smoke.pdf_file(["Northwind Labs acquired Contoso Inc in 2019."], img)
    for c, cid in zip(clients, cids):
        status, body = c.call("POST", f"/api/v1/collections/{cid}/documents", {
            "name": "scan.pdf", "content_base64": base64.b64encode(pdf).decode()})
        assert status == 201 and body[0]["status"] == "COMPLETE", body
    query = chip_smoke.png_file(img)
    (s0, b0), (s1, b1) = both(clients, "POST",
                              lambda i: f"/api/v1/collections/{cids[i]}/searches/image",
                              {"image_base64": base64.b64encode(query).decode(), "top_k": 3})
    assert s0 == s1 == 201
    assert len(b1["items"]) == len(b0["items"]) == 1
    a, b = b0["items"][0], b1["items"][0]
    assert abs(a["score"] - b["score"]) <= SCORE_TOL and a["score"] > 0.99
    assert a["asset_id"] != b["asset_id"]
    pngs = []
    for c, cid, item in zip(clients, cids, (a, b)):
        conn = http.client.HTTPConnection("127.0.0.1", c.port, timeout=60)
        conn.request("GET", f"/api/v1/collections/{cid}/assets/{item['asset_id']}",
                     headers={"Authorization": f"Bearer {c.token}"})
        resp = conn.getresponse()
        assert resp.status == 200
        pngs.append(resp.read())
        conn.close()
    assert pngs[0] != pngs[1]
    assert [np.asarray(Image.open(io.BytesIO(p))) for p in pngs][1].tolist() == img.tolist()
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(pngs[0]))),
                                  np.asarray(Image.open(io.BytesIO(pngs[1]))))
