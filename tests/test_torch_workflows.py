"""The port's workflow routes against the JAX package's, over real sockets.

Both apps boot on ``port=0`` (the port's on ``device="cpu"``) with the
same small cross-encoder checkpoint as their default reranker; each holds
collection "kb" (the hash embedder) and collection "enc" (a small f32
encoder checkpoint written by the port, loaded by both packages), fed the
same documents.  A saved workflow of the reference's RAG shape (start ->
vector_search + fulltext_search + hybrid_search -> merge -> rerank -> llm)
runs through ``/workflows/{wid}/run``, ``/workflows/run`` (JSON and YAML
text) and ``/workflows/run/stream``; every route's status and body, the
node outputs node for node (ids mapped to names, scores within 1e-5),
the stored run and node-run rows, the SSE events and the node-type
catalog are compared.
"""

import json

import pytest
import torch

from chip_smoke import _sse_events
from super_rag_tpu.app import App as JApp
from super_rag_tpu.config import Settings as JSettings
from super_rag_tpu_torch.app import App as TApp
from super_rag_tpu_torch.config import Settings as TSettings
from super_rag_tpu_torch.models import encoder as tenc
from super_rag_tpu_torch.models import encoder_service as tsvc
from super_rag_tpu_torch.service.rerank_service import RerankService

from test_torch_api import (DOCS, SCORE_TOL, SETTINGS, Client, ServerThread, both,
                            make_collection, upload, write_cross_encoder)

BUILTIN = {"start", "vector_search", "fulltext_search", "hybrid_search", "graph_search",
           "merge", "rerank", "llm"}
QUERIES = ["forest fox", "river mill grain", "bread dough", "tensor cores warps"]
# fields that differ between two runs of the same thing (clocks, row ids)
VOLATILE = {"created", "updated", "started", "finished", "duration_ms"}


def write_encoder(path):
    cfg = tenc.EncoderConfig(vocab_size=257, hidden_dim=32, num_layers=1, num_heads=4,
                             mlp_dim=64, max_len=64, dtype=torch.float32)
    model = tenc.init_params(tenc.TextEncoder(cfg), torch.Generator().manual_seed(12))
    tsvc.save_params(tenc.flax_params(model), path, cfg)


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    torch.set_num_threads(2)
    ckpt = tmp_path_factory.mktemp("ckpt")
    write_cross_encoder(str(ckpt / "ce"))
    write_encoder(str(ckpt / "enc"))
    settings = dict(SETTINGS, reranker_checkpoint=str(ckpt / "ce"))
    ref = ServerThread(lambda: JApp(JSettings(
        data_dir=str(tmp_path_factory.mktemp("jax")), **settings),
        background_tasks=False))
    port = ServerThread(lambda: TApp(TSettings(
        data_dir=str(tmp_path_factory.mktemp("torch")), **settings),
        background_tasks=False, device="cpu"))
    yield ref, port, str(ckpt / "enc")
    ref.stop()
    port.stop()


@pytest.fixture(scope="module")
def clients(apps):
    return Client(apps[0].port).login(), Client(apps[1].port).login()


@pytest.fixture(scope="module")
def corpus(apps, clients):
    """Collections kb (hash embedder) and enc (the encoder checkpoint) in
    each app, DOCS in both (enc also holds one more document); returns each
    app's collection ids by name and its id -> name map."""
    cids = {"kb": make_collection(clients, "kb"),
            "enc": make_collection(clients, "enc", {"embedding": {
                "provider": "onboard", "model": apps[2]}})}
    names = [{}, {}]
    for title, ids in cids.items():
        for i in range(2):
            names[i][ids[i]] = title
        docs = dict(DOCS)
        if title == "enc":
            docs["extra.md"] = "# Extra\n\nthe fox sleeps by the river mill at night."
        for name, content in docs.items():
            for i, did in enumerate(upload(clients, ids, name, content)):
                names[i][did] = f"{title}/{name}"
    return cids, names


def rag_flow(cids, i, strategy="rrf", rerank_top_k=3):
    """The reference's RAG shape over both collections of app ``i``."""
    both_ids = [cids["kb"][i], cids["enc"][i]]
    return {
        "name": "rag",
        "input_schema": {"query": {"type": "string", "default": "forest"}},
        "graph": {
            "nodes": [
                {"id": "start", "type": "start", "data": {}},
                {"id": "vs", "type": "vector_search",
                 "data": {"input_values": {"top_k": 5, "similarity_threshold": -1.0,
                                           "collection_ids": both_ids}}},
                {"id": "fs", "type": "fulltext_search",
                 "data": {"input_values": {"top_k": 5, "collection_ids": both_ids}}},
                {"id": "hs", "type": "hybrid_search",
                 "data": {"input_values": {"top_k": 4, "candidates": 20,
                                           "collection_ids": both_ids}}},
                {"id": "merge", "type": "merge",
                 "data": {"input_values": {
                     "vector_docs": "{{ nodes.vs.output.docs }}",
                     "fulltext_docs": "{{ nodes.fs.output.docs }}",
                     "docs": "{{ nodes.hs.output.docs }}",
                     "strategy": strategy}}},
                {"id": "rerank", "type": "rerank",
                 "data": {"input_values": {"docs": "{{ nodes.merge.output.docs }}",
                                           "top_k": rerank_top_k}}},
                {"id": "llm", "type": "llm",
                 "data": {"input_values": {"docs": "{{ nodes.rerank.output.docs }}"}}},
            ],
            "edges": [
                {"source": "start", "target": "vs", "targetHandle": "query"},
                {"source": "start", "target": "fs", "targetHandle": "query"},
                {"source": "start", "target": "hs", "targetHandle": "query"},
                {"source": "vs", "target": "merge", "targetHandle": "vector_docs"},
                {"source": "fs", "target": "merge", "targetHandle": "fulltext_docs"},
                {"source": "hs", "target": "merge", "targetHandle": "docs"},
                {"source": "merge", "target": "rerank", "targetHandle": "docs"},
                {"source": "rerank", "target": "llm", "targetHandle": "docs"},
            ],
        },
    }


LEVELS = {"start": 0, "vs": 1, "fs": 1, "hs": 1, "merge": 2, "rerank": 3, "llm": 4}


def norm(x, names):
    """Each app's ids as shared names; clocks dropped."""
    if isinstance(x, dict):
        return {norm(k, names): norm(v, names) for k, v in x.items() if k not in VOLATILE}
    if isinstance(x, list):
        return [norm(v, names) for v in x]
    if isinstance(x, str):
        return names.get(x, x)
    return x


def assert_close(a, b, path="$"):
    """Equal trees, floats within SCORE_TOL."""
    if isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)), (path, a, b)
        assert abs(a - b) <= SCORE_TOL, (path, a, b)
    elif isinstance(a, dict):
        # nodes of one level finish in any order: so do their outputs' keys
        assert isinstance(b, dict) and sorted(a) == sorted(b), (path, a, b)
        for k in a:
            assert_close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(b) is type(a) and len(a) == len(b), (path, a, b)
        for k, (x, y) in enumerate(zip(a, b)):
            assert_close(x, y, f"{path}[{k}]")
    else:
        assert a == b, (path, a, b)


def both_normed(clients, names, method, path_fn, body_fn=None):
    out = []
    for i, c in enumerate(clients):
        body = body_fn(i) if callable(body_fn) else body_fn
        status, payload = c.call(method, path_fn(i) if callable(path_fn) else path_fn, body)
        out.append((status, norm(payload, names[i])))
    return out


@pytest.fixture(scope="module")
def saved(clients, corpus):
    """One saved workflow per app; its id joins the name maps as "WF"."""
    cids, names = corpus
    wids = []
    for i, c in enumerate(clients):
        status, body = c.call("POST", "/api/v1/workflows",
                              {"title": "rag", "definition": rag_flow(cids, i)})
        assert status == 201, body
        wids.append(body["id"])
        names[i][body["id"]] = "WF"
    return wids


# -- CRUD, versions and their errors --------------------------------------------------

def test_workflow_crud_and_versions_match(clients, corpus, saved):
    cids, names = corpus
    wids = saved
    calls = [
        ("GET", lambda i: f"/api/v1/workflows/{wids[i]}", None),
        ("GET", lambda i: "/api/v1/workflows", None),
        ("GET", lambda i: f"/api/v1/workflows/{wids[i]}/versions", None),
        ("PUT", lambda i: f"/api/v1/workflows/{wids[i]}",
         lambda i: {"definition": rag_flow(cids, i, rerank_top_k=2)}),
        ("POST", lambda i: f"/api/v1/workflows/{wids[i]}/versions", lambda i: {}),
        ("POST", lambda i: f"/api/v1/workflows/{wids[i]}/versions",
         lambda i: {"definition": rag_flow(cids, i, strategy="union")}),
        ("GET", lambda i: f"/api/v1/workflows/{wids[i]}/versions", None),
        ("GET", lambda i: f"/api/v1/workflows/{wids[i]}/versions/2", None),
        ("GET", lambda i: f"/api/v1/workflows/{wids[i]}", None),
        # back to the first definition for the run tests
        ("POST", lambda i: f"/api/v1/workflows/{wids[i]}/versions",
         lambda i: {"definition": rag_flow(cids, i)}),
    ]
    for method, path, body in calls:
        (s0, b0), (s1, b1) = both_normed(clients, names, method, path, body)
        assert s0 == s1 and s0 in (200, 201), (method, s0, s1, b0, b1)
        assert b1 == b0, (method, path(1))
    (_, listing), _ = both_normed(clients, names, "GET",
                                  lambda i: f"/api/v1/workflows/{wids[i]}/versions")
    assert [v["version"] for v in listing] == [1, 2, 3, 4, 5]


ERRORS = [
    ("unknown workflow", "GET", "/api/v1/workflows/wf_nope", None),
    ("unknown workflow put", "PUT", "/api/v1/workflows/wf_nope", {"definition": {}}),
    ("unknown workflow delete", "DELETE", "/api/v1/workflows/wf_nope", None),
    ("unknown workflow versions", "GET", "/api/v1/workflows/wf_nope/versions", None),
    ("unknown workflow new version", "POST", "/api/v1/workflows/wf_nope/versions", {}),
    ("unknown workflow runs", "GET", "/api/v1/workflows/wf_nope/runs", None),
    ("unknown workflow run", "POST", "/api/v1/workflows/wf_nope/run", {"inputs": {}}),
    ("unknown run", "GET", "/api/v1/workflow-runs/run_nope", None),
    ("unknown version", "GET", "/api/v1/workflows/{wid}/versions/99", None),
    ("non-integer version", "GET", "/api/v1/workflows/{wid}/versions/abc", None),
    ("unknown nested run", "GET", "/api/v1/workflows/{wid}/runs/run_nope", None),
    ("missing graph", "POST", "/api/v1/workflows", {"title": "x", "definition": {}}),
    ("bad node", "POST", "/api/v1/workflows",
     {"title": "x", "definition": {"graph": {"nodes": [{"id": "", "type": "start"}]}}}),
    ("bad edge", "POST", "/api/v1/workflows",
     {"title": "x", "definition": {"graph": {"nodes": [], "edges": [{"source": "a"}]}}}),
    ("bad port", "POST", "/api/v1/workflows",
     {"title": "x", "definition": {"graph": {
         "nodes": [{"id": "a", "type": "start"}, {"id": "b", "type": "rerank"}],
         "edges": [{"source": "a", "target": "b", "targetHandle": "nonexistent"}]}}}),
    ("cycle", "POST", "/api/v1/workflows/run",
     {"definition": {"graph": {
         "nodes": [{"id": "a", "type": "start"}, {"id": "b", "type": "start"}],
         "edges": [{"source": "a", "target": "b"}, {"source": "b", "target": "a"}]}}}),
    ("unknown node type", "POST", "/api/v1/workflows/run",
     {"definition": {"graph": {"nodes": [{"id": "a", "type": "no_such_node"}]}},
      "inputs": {"query": "q"}}),
    ("bad yaml", "POST", "/api/v1/workflows/run",
     {"definition": "graph:\n  nodes: [a: 1]\n"}),
    ("no token", "GET", "/api/v1/workflows", None),
]


@pytest.mark.parametrize("case", ERRORS, ids=[c[0] for c in ERRORS])
def test_workflow_errors_match(clients, corpus, saved, case):
    """Unknown workflow / version / run: 404; a non-integer version and a
    body the models refuse: 422; a run that fails: 422 ``workflow failed:``.
    A definition the parser refuses (a bad port, a cycle, YAML outside the
    subset) fails inside the service, where the reference answers 500 with
    the parser's message: so does the port."""
    name, method, path, body = case
    out = []
    for i, c in enumerate(clients):
        token = c.token
        if name == "no token":
            c.token = None
        try:
            out.append(c.call(method, path.replace("{wid}", saved[i]), body))
        finally:
            c.token = token
    (s0, b0), (s1, b1) = out
    assert s0 == s1 >= 400, out
    if name == "bad yaml":
        # PyYAML's and the subset's messages word the refusal differently
        assert b1["error"]["message"].startswith("internal error: YAML subset: single-pair"), b1
        return
    assert norm(b1, {saved[1]: "WF"}) == norm(b0, {saved[0]: "WF"})


# -- runs -------------------------------------------------------------------------------

def _outputs_close(ref, port):
    assert sorted(ref) == sorted(port) == sorted(LEVELS)
    assert_close(ref, port)


@pytest.mark.parametrize("query", QUERIES)
def test_saved_workflow_runs_match_node_for_node(apps, clients, corpus, saved, query):
    cids, names = corpus
    port_ce = []
    real = RerankService.__call__

    def counted(self, *a, **kw):
        port_ce.append(len(a[1]))
        return real(self, *a, **kw)

    RerankService.__call__ = counted
    try:
        (s0, r0), (s1, r1) = both_normed(clients, names, "POST",
                                         lambda i: f"/api/v1/workflows/{saved[i]}/run",
                                         {"inputs": {"query": query}})
    finally:
        RerankService.__call__ = real
    assert s0 == s1 == 200, (r0, r1)
    assert r0["status"] == r1["status"] == "SUCCESS"
    out0, out1 = r0["outputs"], r1["outputs"]
    _outputs_close(out0, out1)
    for nid in ("vs", "fs", "hs"):
        assert out1[nid]["docs"], nid
    # the saved workflow's rerank node reranks by the cross-encoder in both
    # apps (the search routes' kept difference, C5, does not reach it)
    assert port_ce == [len(out1["merge"]["docs"])]
    assert {d["recall_type"] for d in out1["rerank"]["docs"]} == {"reranked"}
    assert out1["llm"]["text"] == out1["rerank"]["docs"][0]["text"]
    # the stored rows
    runs = []
    for i, c in enumerate(clients):
        status, run = c.call("GET", f"/api/v1/workflow-runs/{[r0, r1][i]['run_id']}")
        assert status == 200
        nested = c.call("GET",
                        f"/api/v1/workflows/{saved[i]}/runs/{[r0, r1][i]['run_id']}")
        assert nested == (200, run)
        run = norm(run, {**names[i], [r0, r1][i]["run_id"]: "RUN"})
        run["node_runs"] = sorted(({k: v for k, v in nr.items() if k != "id"}
                                   for nr in run["node_runs"]),
                                  key=lambda nr: nr["node_id"])
        runs.append(run)
    assert [nr["node_id"] for nr in runs[1]["node_runs"]] == sorted(LEVELS)
    assert {nr["status"] for nr in runs[1]["node_runs"]} == {"SUCCESS"}
    assert runs[1]["status"] == "SUCCESS" and runs[1]["version"] == runs[0]["version"]
    assert_close(runs[0], runs[1])


def test_runs_listing_and_delete(clients, corpus, saved):
    cids, names = corpus
    # a workflow of its own, run twice, then deleted with its runs
    wids = []
    for i, c in enumerate(clients):
        status, body = c.call("POST", "/api/v1/workflows",
                              {"title": "doomed", "definition": rag_flow(cids, i)})
        assert status == 201
        wids.append(body["id"])
        names[i][body["id"]] = "DOOMED"
        for q in ("forest", "bread"):
            assert c.call("POST", f"/api/v1/workflows/{body['id']}/run",
                          {"inputs": {"query": q}})[0] == 200
    listings = []
    for i, c in enumerate(clients):
        status, runs = c.call("GET", f"/api/v1/workflows/{wids[i]}/runs")
        assert status == 200 and len(runs) == 2
        rids = [r["id"] for r in runs]
        listings.append((rids, norm([{k: v for k, v in r.items() if k != "id"}
                                     for r in runs], names[i])))
    assert_close(listings[0][1], listings[1][1])
    out = both(clients, "DELETE", lambda i: f"/api/v1/workflows/{wids[i]}")
    assert out == [(204, ""), (204, "")]
    for i, c in enumerate(clients):
        assert c.call("GET", f"/api/v1/workflows/{wids[i]}")[0] == 404
        for rid in listings[i][0]:
            assert c.call("GET", f"/api/v1/workflow-runs/{rid}")[0] == 404


def _flow_yaml(flow) -> str:
    """The flow as hand-written YAML: block style, flow lists, comments."""
    lines = ["# the RAG flow", f"name: {flow['name']}", "input_schema:",
             "  query: {type: string, default: 'forest'}", "graph:", "  nodes:"]
    for n in flow["graph"]["nodes"]:
        lines += [f"    - id: {n['id']}", f"      type: {n['type']}"]
        iv = n["data"].get("input_values")
        if not iv:
            lines.append("      data: {}")
            continue
        lines += ["      data:", "        input_values:"]
        for k, v in iv.items():
            lines.append(f"          {k}: {json.dumps(v) if not isinstance(v, list) else v}")
    lines.append("  edges:")
    for e in flow["graph"]["edges"]:
        lines += [f"  - source: {e['source']}  # indentless", f"    target: {e['target']}",
                  f"    targetHandle: \"{e['targetHandle']}\""]
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("form", ["json", "yaml"])
def test_one_shot_run_matches(clients, corpus, form):
    cids, names = corpus
    flows = [rag_flow(cids, i, strategy="union") for i in range(2)]
    if form == "yaml":
        import yaml

        texts = [_flow_yaml(f).replace("'", "") for f in flows]
        for f, t in zip(flows, texts):
            assert yaml.safe_load(t) == f
        flows = texts
    (s0, r0), (s1, r1) = both_normed(clients, names, "POST", "/api/v1/workflows/run",
                                     lambda i: {"definition": flows[i],
                                                "inputs": {"query": "river fox"}})
    assert s0 == s1 == 200, (r0, r1)
    _outputs_close(r0["outputs"], r1["outputs"])
    assert r1["outputs"]["merge"]["docs"]


def test_stream_events_match(clients, corpus):
    cids, names = corpus
    seqs = []
    for i, c in enumerate(clients):
        status, text = c.call("POST", "/api/v1/workflows/run/stream",
                              {"definition": rag_flow(cids, i),
                               "inputs": {"query": "forest mill"}})
        assert status == 200
        events = _sse_events(text)
        run_id = events[-1][1]["run_id"]
        seq = [(name, norm(data, {**names[i], run_id: "RUN"})) for name, data in events]
        # nodes of one level run together and may end in any order: each
        # app's events must come level by level, compared in a fixed order
        level = [LEVELS.get(d.get("node_id"), -1 if n == "FLOW_START" else 9)
                 for n, d in seq]
        assert level == sorted(level), seq
        seqs.append(sorted(seq, key=lambda e: (LEVELS.get(e[1].get("node_id"), -1)
                                               if e[0] != "FLOW_END" and e[0] != "RESULT"
                                               else 9, ["FLOW_START", "NODE_START",
                                                        "NODE_END", "FLOW_END",
                                                        "RESULT"].index(e[0]),
                                               e[1].get("node_id", ""))))
    names0 = [(n, d.get("node_id")) for n, d in seqs[0]]
    assert names0 == [(n, d.get("node_id")) for n, d in seqs[1]]
    assert names0[0] == ("FLOW_START", None) and names0[-2:] == [("FLOW_END", None),
                                                                  ("RESULT", None)]
    assert sum(n == "NODE_END" for n, _ in names0) == len(LEVELS)
    assert seqs[1][-1][1]["status"] == "SUCCESS"
    assert_close(seqs[0], seqs[1])


def test_node_types_and_packs_match(clients):
    out = both(clients, "GET", "/api/v1/nodeflow/node-types")
    assert [s for s, _ in out] == [200, 200]
    cats = [{c["type"]: c for c in body if c["type"] in BUILTIN} for _, body in out]
    assert set(cats[1]) == BUILTIN
    assert cats[0] == cats[1]
    out = both(clients, "GET", "/api/v1/nodeflow/packs")
    assert [s for s, _ in out] == [200, 200]
    ref, port = (body for _, body in out)
    assert port["loaded_packs"] == ref["loaded_packs"] == []
    assert ([t for t in port["registered_types"] if t in BUILTIN]
            == [t for t in ref["registered_types"] if t in BUILTIN] == sorted(BUILTIN))
    assert ({c["type"]: c for c in port["node_types"] if c["type"] in BUILTIN}
            == {c["type"]: c for c in ref["node_types"] if c["type"] in BUILTIN})

