"""The model-provider routes and remote-provider collections: the port's
app against the JAX package's, over sockets, both backed by one stub
provider (``tests/llm_stub.py``) that embeds at text-embedding-3-small's
1,536 dimensions, reranks by query-term overlap and completes the summary
map-reduce.

The provider, model, key, configuration, default-model, available-model
and prompt-template routes answer the same JSON (up to ids and clocks); a
collection embedded and reranked by the stub ingests the same rows and
answers the same searches (ids equal under the tie rule, scores within
bf16 tolerance); the ``summary`` index holds the same summaries with and
without a completion model; ``/v1/embeddings`` answers the same.  Each
app's response cache is its own file.  The llm runner gives the same
prompt and references in both packages.
"""

import asyncio
import os

import numpy as np
import pytest
import torch

from llm_stub import StubProvider, repoint_jax_cache
from test_torch_api import SETTINGS, Client, ServerThread, both
from super_rag_tpu.app import App as JApp
from super_rag_tpu.config import Settings as JSettings
from super_rag_tpu.store.db import Database as JDatabase
from super_rag_tpu_torch.app import App as TApp
from super_rag_tpu_torch.config import Settings as TSettings
from super_rag_tpu_torch.engine.index import INDEXER_CODES
from super_rag_tpu_torch.store.db import Database as TDatabase

DIM = 1536  # text-embedding-3-small
BF16_TOL = 2.0 ** -7  # a bf16 index's cosine scores, |s| <= 1
EMBED = {"provider": "stub", "model": "text-embedding-3-small"}
RERANK = {"provider": "stub", "model": "rerank-v1"}

DOCS = {
    "forest.md": "# Forest\n\n## Animals\n\nthe fox jumps over the dog and runs into the "
                 "forest. owls sleep by day.\n\n## Trees\n\noak and birch grow by the river. "
                 "the mill stands under the oaks.",
    "river.txt": "plain text notes about the river and the mill. the river runs past the "
                 "mill, and the mill grinds grain for bread.",
    "kitchen.md": "# Kitchen\n\n## Bread\n\nflour water salt and yeast make bread; knead the "
                  "dough and let it rise.\n\n## Soup\n\na soup of river fish, leeks and "
                  "potatoes.",
    "cores.md": "# Hardware\n\nGPUs run warps of threads over tensor cores. TPUs multiply "
                "matrices using systolic arrays.",
}
QUERIES = ["forest fox", "river mill grain", "tensor cores warps", "bread dough",
           "oak birch", "soup of river fish", "owls by day", "zyzzyva"]


@pytest.fixture(scope="module")
def stub():
    s = StubProvider(dim=DIM)
    yield s
    s.stop()


# the JAX app's clients open a cache file of this module's, not the shared default
jax_cache = pytest.fixture(scope="module", autouse=True)(repoint_jax_cache)


def boot(tmp_path_factory, name, seed=None):
    """Both apps on their own data dirs; ``seed(db)`` runs on each app's
    database before it boots (what a deployment registered before)."""
    dirs = [str(tmp_path_factory.mktemp(f"{name}_jax")),
            str(tmp_path_factory.mktemp(f"{name}_torch"))]
    if seed is not None:
        seed(JDatabase(os.path.join(dirs[0], "super_rag.db")))
        seed(TDatabase(os.path.join(dirs[1], "super_rag.db")))
    return (ServerThread(lambda: JApp(JSettings(data_dir=dirs[0], **SETTINGS),
                                      background_tasks=False)),
            ServerThread(lambda: TApp(TSettings(data_dir=dirs[1], **SETTINGS),
                                      background_tasks=False, device="cpu")))


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    torch.set_num_threads(2)
    pair = boot(tmp_path_factory, "plain")
    yield pair
    for a in pair:
        a.stop()


@pytest.fixture(scope="module")
def clients(apps, stub):
    cs = Client(apps[0].port).login(), Client(apps[1].port).login()
    out = both(cs, "POST", "/api/v1/llm_providers",
               {"name": "stub", "label": "Stub", "base_url": stub.url})
    assert [s for s, _ in out] == [201, 201], out
    out = both(cs, "POST", "/api/v1/llm_providers/stub/key", {"api_key": "sk-stub-0123456789"})
    assert out[0] == out[1] == (200, {"ok": True})
    for api, model in (("embedding", EMBED["model"]), ("rerank", RERANK["model"]),
                       ("completion", "gpt-stub")):
        out = both(cs, "POST", "/api/v1/llm_providers/stub/models",
                   {"api": api, "model": model, "context_window": 8192, "tags": ["recommend"]})
        assert [s for s, _ in out] == [201, 201], out
    return cs


def strip(x):
    """JSON without the keys that hold ids or clocks."""
    if isinstance(x, dict):
        return {k: strip(v) for k, v in x.items()
                if k not in ("id", "created", "updated", "created_at", "updated_at")}
    if isinstance(x, list):
        return [strip(v) for v in x]
    return x


def same(out):
    assert out[0][0] == out[1][0], out
    assert strip(out[0][1]) == strip(out[1][1]), out
    return out[1][1]


# -- provider, model, default-model and template routes ------------------------------


def test_provider_routes_answer_alike(clients, stub):
    rows = same(both(clients, "GET", "/api/v1/llm_providers"))
    assert {r["name"]: r["base_url"] for r in rows}["stub"] == stub.url
    same(both(clients, "GET", "/api/v1/llm_providers/stub"))
    same(both(clients, "GET", "/api/v1/llm_providers/nope"))
    same(both(clients, "PUT", "/api/v1/llm_providers/stub",
              {"label": "Stub provider", "api_key": "sk-updated-987654321"}))
    same(both(clients, "PUT", "/api/v1/llm_providers/nope", {"label": "x"}))
    same(both(clients, "GET", "/api/v1/llm_providers/stub/models"))
    same(both(clients, "GET", "/api/v1/llm_provider_models"))
    same(both(clients, "GET", "/api/v1/llm_provider_models?provider_name=stub"))
    body = same(both(clients, "GET", "/api/v1/llm_configuration"))
    assert {p["name"]: p["api_key"] for p in body["providers"]}["stub"] == "sk-u****4321"
    same(both(clients, "PUT", "/api/v1/llm_providers/stub/models/completion/gpt-stub",
              {"max_tokens": 512}))
    same(both(clients, "PUT", "/api/v1/llm_providers/stub/models/completion/none", {}))
    same(both(clients, "POST", "/api/v1/llm_providers/stub/models", {"api": "chat",
                                                                      "model": "x"}))
    same(both(clients, "POST", "/api/v1/llm_providers", {"name": ""}))
    same(both(clients, "POST", "/api/v1/llm_providers/stub/key", {"api_key": ""}))
    # a second provider: created, listed, its model deleted, then itself
    same(both(clients, "POST", "/api/v1/llm_providers",
              {"name": "other", "base_url": "http://127.0.0.1:9/v1", "api_type": "dashscope"}))
    same(both(clients, "POST", "/api/v1/llm_providers/other/models",
              {"api": "embedding", "model": "org/model:v1"}))
    same(both(clients, "DELETE", "/api/v1/llm_providers/other/models/embedding/org/model:v1"))
    same(both(clients, "DELETE", "/api/v1/llm_providers/other"))
    same(both(clients, "GET", "/api/v1/llm_providers"))
    # no token
    out = [Client(c.port).call("GET", "/api/v1/llm_providers") for c in clients]
    assert out[0][0] == out[1][0] == 401


def test_default_and_available_model_routes_answer_alike(clients):
    try:
        same(both(clients, "GET", "/api/v1/default_models"))
        same(both(clients, "PUT", "/api/v1/default_models", {"defaults": [
            {"scenario": "default_for_embedding", "provider_name": "stub",
             "model": EMBED["model"]},
            {"scenario": "default_for_rerank", "provider_name": "stub",
             "model": RERANK["model"]},
            {"scenario": "default_for_collection_completion", "provider_name": "stub",
             "model": "gpt-stub"}]}))
        same(both(clients, "GET", "/api/v1/llm/default_models"))
        same(both(clients, "GET", "/api/v1/llm/available_models"))
        same(both(clients, "GET", "/api/v1/llm/available_models?tag=default_for_rerank"))
        same(both(clients, "POST", "/api/v1/available_models", {}))
        same(both(clients, "POST", "/api/v1/available_models", {"tag_filters": [
            {"operation": "OR", "tags": ["default_for_rerank", "default_for_embedding"]}]}))
        same(both(clients, "POST", "/api/v1/available_models", {"tag_filters": [
            {"operation": "AND", "tags": ["recommend", "default_for_rerank"]}]}))
        same(both(clients, "PUT", "/api/v1/default_models", {"defaults": [
            {"scenario": "bogus", "provider_name": "stub", "model": "x"}]}))
        same(both(clients, "PUT", "/api/v1/default_models", {"defaults": [
            {"scenario": "default_for_rerank", "provider_name": "stub", "model": "none"}]}))
    finally:
        out = same(both(clients, "PUT", "/api/v1/default_models", {"defaults": [
            {"scenario": s} for s in ("default_for_embedding", "default_for_rerank",
                                      "default_for_collection_completion")]}))
        assert all(it["model"] is None for it in out["items"])


def test_prompt_template_routes_answer_alike(clients):
    same(both(clients, "GET", "/api/v1/prompt-templates"))
    same(both(clients, "GET", "/api/v1/prompt-templates?language=zh-CN"))
    made = both(clients, "POST", "/api/v1/prompt-templates",
                {"name": "terse", "prompt": "Answer in one line: {{ query }}",
                 "description": "one line"})
    same(made)
    same(both(clients, "POST", "/api/v1/prompt-templates", {"name": "terse",
                                                             "prompt": "again"}))
    same(both(clients, "POST", "/api/v1/prompt-templates", {"name": "x"}))
    same(both(clients, "PUT", lambda i: f"/api/v1/prompt-templates/{made[i][1]['id']}",
              {"prompt": "Answer briefly: {{ query }}"}))
    same(both(clients, "GET", "/api/v1/prompt-templates"))
    same(both(clients, "PUT", "/api/v1/prompt-templates/nope", {"prompt": "x"}))
    same(both(clients, "DELETE", lambda i: f"/api/v1/prompt-templates/{made[i][1]['id']}"))
    same(both(clients, "DELETE", "/api/v1/prompt-templates/nope"))


# -- a collection embedded and reranked by the stub at D = 1,536 ---------------------


def make(clients, title, config):
    out = both(clients, "POST", "/api/v1/collections", {"title": title, "config": config})
    same(out)
    return [b["id"] for _, b in out]


def ingest(clients, cids):
    maps = [{cids[0]: "c"}, {cids[1]: "c"}]
    for name, content in DOCS.items():
        out = [c.call("POST", f"/api/v1/collections/{cid}/documents",
                      {"name": name, "content": content})
               for c, cid in zip(clients, cids)]
        assert [s for s, _ in out] == [201, 201], out
        for m, (_, b) in zip(maps, out):
            m[b[0]["id"]] = name
        assert (strip(out[0][1][0]["indexes"]) == strip(out[1][1][0]["indexes"]))
        assert {i["status"] for i in out[1][1][0]["indexes"]} == {"ACTIVE"}, out[1]
    return maps


def items(body, ids):
    out = []
    for it in body["items"]:
        md = {k: ids.get(v, v) if k in ("document_id", "collection_id") else v
              for k, v in it["metadata"].items()}
        out.append({**it, "metadata": md})
    return out


def assert_same_up_to_ties(ref, got, tol):
    """The same items rank for rank, where two items whose scores lie
    within ``tol`` may stand in either order; scores within ``tol``."""
    assert len(ref) == len(got), (ref, got)
    assert got, "no items to compare"
    for a, b in zip(ref, got):
        assert abs(a["score"] - b["score"]) <= tol, (a, b)
        if a["text"] != b["text"]:
            tied = [r for r in ref if abs(r["score"] - b["score"]) <= tol]
            assert any(r["text"] == b["text"] for r in tied), (a, b)
        else:
            assert {**a, "score": 0, "rank": 0} == {**b, "score": 0, "rank": 0}


@pytest.fixture(scope="module")
def remote(apps, clients, stub):
    cids = make(clients, "remote", {"index_dtype": "bfloat16", "embedding": EMBED,
                                    "rerank": RERANK, "enable_summary": True})
    return cids, ingest(clients, cids)


def engine_of(app, cid):
    return app.app.ctx.engines.get(cid)


def test_remote_collection_is_sized_by_the_probed_dim(apps, remote):
    cids, _ = remote
    engines = [engine_of(a, c) for a, c in zip(apps, cids)]
    assert [e.index.spec.dim for e in engines] == [DIM, DIM]
    assert [type(e.embedder).__name__ for e in engines] == ["RemoteEmbedder"] * 2
    assert engines[1].embedder.dim == DIM


def test_remote_collection_ingests_the_same_rows(apps, clients, remote):
    cids, maps = remote
    listing = both(clients, "GET", lambda i: f"/api/v1/collections/{cids[i]}/documents")
    by_name = [{d["name"]: d["id"] for d in body} for _, body in listing]
    for name in DOCS:
        out = both(clients, "GET", lambda i: f"/api/v1/documents/{by_name[i][name]}/chunks")
        assert [c["text"] for c in out[0][1]] == [c["text"] for c in out[1][1]]
    # the stub's vectors, stored in bf16 alike (within one bf16 rounding)
    jidx, tidx = (engine_of(a, c).index for a, c in zip(apps, cids))
    assert jidx.size == tidx.size and tidx.emb.dtype == torch.bfloat16
    jv = torch.tensor(np.asarray(jidx.emb[: jidx.size]).astype("float32"))
    tv = tidx.emb[: tidx.size].float().cpu()
    assert (jv - tv).abs().max() <= 2.0 ** -8 * jv.abs().max()


@pytest.mark.parametrize("rerank", [False, True])
def test_remote_collection_answers_the_same_searches(clients, remote, stub, rerank):
    cids, maps = remote
    for q in QUERIES:
        n0 = stub.counts["rerank"]
        out = both(clients, "POST", lambda i: f"/api/v1/collections/{cids[i]}/searches",
                   {"query": q, "use_rerank": rerank, "top_k": 5})
        assert [s for s, _ in out] == [201, 201], out
        ref, got = items(out[0][1], maps[0]), items(out[1][1], maps[1])
        assert_same_up_to_ties(ref, got, 1e-6 if rerank else BF16_TOL)
        if rerank:
            assert stub.counts["rerank"] == n0 + 2  # each app asked the stub once
            assert all(it["recall_type"] == "reranked" for it in got)
    for use_fulltext in (False,):
        out = both(clients, "POST", lambda i: f"/api/v1/collections/{cids[i]}/searches",
                   {"query": "river mill", "use_rerank": False, "use_fulltext": use_fulltext,
                    "similarity_threshold": -1.0})
        assert_same_up_to_ties(items(out[0][1], maps[0]), items(out[1][1], maps[1]),
                               BF16_TOL)


def summaries(app, cid):
    idx = engine_of(app, cid).index
    codes = idx.indexer_code[: idx.size]
    codes = codes.cpu().numpy() if isinstance(codes, torch.Tensor) else codes
    return sorted(m["text"] for r, m in enumerate(idx.row_meta)
                  if m is not None and int(codes[r]) == INDEXER_CODES["summary"])


def test_summary_index_without_a_completion_model(apps, remote):
    """No model tagged for completion at boot: the extractive summary."""
    cids, _ = remote
    got = [summaries(a, c) for a, c in zip(apps, cids)]
    assert got[0] == got[1] and len(got[1]) == len(DOCS)


def test_v1_embeddings_answers_alike(clients, remote, stub):
    cids, _ = remote
    texts = ["the fox", "a mill by the river", "ünïcode"]
    out = [c.call("POST", "/v1/embeddings", {"input": texts, "model": cid})
           for c, cid in zip(clients, cids)]
    assert out[0][0] == out[1][0] == 200
    assert {**out[0][1], "model": 0} == {**out[1][1], "model": 0}
    assert len(out[1][1]["data"][0]["embedding"]) == DIM
    want = stub.embed_fn(texts)
    assert [d["embedding"] for d in out[1][1]["data"]] == want.tolist()
    # one string; the default embedder (the hash embedder at the apps' dim)
    out = both(clients, "POST", "/v1/embeddings", {"input": "the river"})
    assert out[0][0] == out[1][0] == 200
    a, b = out[0][1], out[1][1]
    assert {**a, "data": 0} == {**b, "data": 0}
    assert torch.allclose(torch.tensor(a["data"][0]["embedding"]),
                          torch.tensor(b["data"][0]["embedding"]), atol=1e-6)
    for body in ({"input": []}, {"input": ["x"] * 2049}):
        same(both(clients, "POST", "/v1/embeddings", body))
    out = [Client(c.port).call("POST", "/v1/embeddings", {"input": ["x"]}) for c in clients]
    assert out[0][0] == out[1][0] == 401


def test_unreachable_provider_falls_back_as_the_reference(clients, stub, caplog):
    """A provider that cannot be reached: the default embedder, as in the
    reference (the port logs it)."""
    same(both(clients, "POST", "/api/v1/llm_providers",
              {"name": "down", "base_url": "http://127.0.0.1:9/v1"}))
    cids = make(clients, "down", {"embedding": {"provider": "down", "model": "m"}})
    out = both(clients, "POST", lambda i: f"/api/v1/collections/{cids[i]}/documents",
               {"name": "d.md", "content": "# d\n\nsome words about the river"})
    assert [s for s, _ in out] == [201, 201]
    out = both(clients, "POST", lambda i: f"/api/v1/collections/{cids[i]}/searches",
               {"query": "river", "use_rerank": False})
    assert [len(b["items"]) for _, b in out] == [1, 1]
    assert abs(out[0][1]["items"][0]["score"] - out[1][1]["items"][0]["score"]) <= 1e-5
    assert any("unreachable" in r.getMessage() for r in caplog.records
               if r.name.startswith("super_rag_tpu_torch"))
    same(both(clients, "DELETE", "/api/v1/llm_providers/down"))


# -- the summary index through a completion model ----------------------------------


@pytest.fixture(scope="module")
def completion_apps(tmp_path_factory, stub):
    """Apps that boot with a model tagged for collection completion (the
    completion client is resolved at boot, as in the reference)."""

    def seed(db):
        db.upsert_provider("stub", base_url=stub.url)
        db.upsert_model("stub", "completion", "gpt-stub",
                        tags=["default_for_collection_completion"])
        db.upsert_model("stub", "embedding", EMBED["model"])
        db.set_provider_key("stub", "public", "sk-public")

    pair = boot(tmp_path_factory, "completion", seed)
    yield pair
    for a in pair:
        a.stop()


def test_summary_index_through_the_completion_model(completion_apps, stub):
    cs = Client(completion_apps[0].port).login(), Client(completion_apps[1].port).login()
    cids = make(cs, "sum", {"index_dtype": "bfloat16", "embedding": EMBED,
                            "enable_summary": True})
    long_doc = "# Long\n\n" + "\n\n".join(
        f"## part {k}\n\n" + " ".join(f"w{(k * 7 + j) % 97}" for j in range(120))
        for k in range(24))
    n0 = stub.counts["completion"]
    maps = ingest(cs, cids)
    out = [c.call("POST", f"/api/v1/collections/{cid}/documents",
                  {"name": "long.md", "content": long_doc}) for c, cid in zip(cs, cids)]
    assert [s for s, _ in out] == [201, 201]
    for m, (_, b) in zip(maps, out):
        m[b[0]["id"]] = "long.md"
    got = [summaries(a, c) for a, c in zip(completion_apps, cids)]
    assert got[0] == got[1] and len(got[1]) == len(DOCS) + 1
    calls = stub.counts["completion"] - n0
    assert calls >= 2 * (len(DOCS) + 3) and calls % 2 == 0  # the map-reduce, in each app
    assert [a.app.ctx.completion is not None for a in completion_apps] == [True, True]
    for q in ("w3 w10", "bread dough"):
        out = both(cs, "POST", lambda i: f"/api/v1/collections/{cids[i]}/searches",
                   {"query": q, "use_rerank": False})
        assert_same_up_to_ties(items(out[0][1], maps[0]), items(out[1][1], maps[1]),
                               BF16_TOL)


# -- the llm runner ------------------------------------------------------------------


def _run_llm(pkg, inputs: dict, query: str, completion):
    if pkg == "jax":
        from super_rag_tpu.nodeflow.models import ExecutionContext, SystemInput
        from super_rag_tpu.nodeflow.runners import llm
        from super_rag_tpu.nodeflow.types import DocumentWithScore
    else:
        from super_rag_tpu_torch.nodeflow.models import ExecutionContext, SystemInput
        from super_rag_tpu_torch.nodeflow.runners import llm
        from super_rag_tpu_torch.nodeflow.types import DocumentWithScore
    docs = [DocumentWithScore(**d) for d in inputs.pop("docs")]
    ctx = ExecutionContext(system_input=SystemInput(query=query),
                           services={"completion": completion})
    out = asyncio.run(llm.run(None, llm.LLMInput(docs=docs, **inputs), ctx))
    return out.model_dump()


@pytest.mark.parametrize("case", ["offline", "sync", "async", "budget", "template"])
def test_llm_runner_gives_the_same_prompt_and_references(case):
    docs = [{"text": f"passage {i} " + "word " * (40 * (i + 1)), "score": 1.0 / (i + 1),
             "metadata": {"document_id": f"d{i}", "chunk_index": i},
             "recall_type": "hybrid_search"} for i in range(6)]
    inputs = {"docs": docs}
    if case == "budget":
        inputs.update(context_window=300, reserve_output_tokens=10)
    if case == "template":
        inputs.update(prompt_template="CTX:{context}\nQ:{query}", temperature=0.0)
    outs, prompts = [], []
    for pkg in ("jax", "torch"):
        seen = []

        def sync(**kw):
            seen.append(kw)
            return "answer to " + kw["prompt"][-20:]

        async def asynchronous(**kw):
            return sync(**kw)

        completion = {"offline": None, "async": asynchronous}.get(case, sync)
        outs.append(_run_llm(pkg, dict(inputs), "what is passage 2", completion))
        prompts.append(seen)
    assert outs[0] == outs[1]
    assert prompts[0] == prompts[1]
    if case == "budget":
        assert 0 < len(outs[1]["references"]) < len(docs)
    if case != "offline":
        assert prompts[1] and "what is passage 2" in prompts[1][0]["prompt"]
