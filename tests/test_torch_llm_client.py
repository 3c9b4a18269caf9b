"""The port's provider clients (``http.client``) against the JAX package's
(httpx), on one stub provider served over a socket (``tests/llm_stub.py``).

For each dialect and each of complete / embed / rerank, both clients make
the same call: the requests must have the same method, path, body bytes
and headers (up to those the transport sets for itself: User-Agent,
Host, Accept-Encoding and framing), and the calls the same return and the
same usage counts.  Statuses and transport faults give the same error
class, after the same number of attempts and back-off sleeps.  Each
client has its own response cache file, so neither is served the other's
hits.  The resolver and the per-collection rerank run through both
packages' ``build_context``.
"""

import asyncio
import http.client
import socket
import threading
import time

import httpx
import numpy as np
import pytest

from llm_stub import StubProvider, comparable, repoint_jax_cache
from super_rag_tpu.llm import client as jc
from super_rag_tpu.llm import errors as je
from super_rag_tpu.llm import resolver as jr
from super_rag_tpu.store.db import Database as JDatabase
from super_rag_tpu_torch.llm import client as tc
from super_rag_tpu_torch.llm import errors as te
from super_rag_tpu_torch.llm import resolver as tr
from super_rag_tpu_torch.store.db import Database as TDatabase


# every JAX client a test builds without a cache of its own (the resolver's,
# build_context's) opens a file of this module's, not the shared default
jax_cache = pytest.fixture(scope="module", autouse=True)(repoint_jax_cache)


@pytest.fixture(scope="module")
def stub():
    s = StubProvider(dim=8)
    yield s
    s.stop()


@pytest.fixture
def sleeps(monkeypatch):
    """Back-off sleeps recorded instead of slept (both clients call
    ``time.sleep``; the stub waits with an Event)."""
    out = []
    monkeypatch.setattr(time, "sleep", out.append)
    return out


def pair(cls_name, base_url, tmp_path, **kw):
    """The JAX and the port client of one dialect, each with its own cache."""
    j = getattr(jc, cls_name)(base_url, cache=jc.ResponseCache(str(tmp_path / "j.db")), **kw)
    t = getattr(tc, cls_name)(base_url, cache=tc.ResponseCache(str(tmp_path / "t.db")), **kw)
    return j, t


def run_recorded(stub, fn):
    n0 = len(stub.seen)
    try:
        out = ("ok", fn())
    except Exception as e:  # noqa: BLE001 — compared by class below
        out = ("error", type(e).__name__, getattr(e, "status_code", None),
               getattr(e, "retryable", None))
    return out, stub.requests_since(n0)


def assert_same_requests(jreq, treq):
    assert len(jreq) == len(treq)
    for (jm, jp, jh, jb), (tm, tp, th, tb) in zip(jreq, treq):
        assert (jm, jp) == (tm, tp)
        assert jb == tb, (jb[:200], tb[:200])
        assert comparable(jh) == comparable(th)


def both_same(stub, j, t, call):
    jout, jreq = run_recorded(stub, lambda: call(j))
    tout, treq = run_recorded(stub, lambda: call(t))
    assert jout == tout
    assert_same_requests(jreq, treq)
    js, ts = j.stats.snapshot(), t.stats.snapshot()
    for k in ("calls", "errors", "prompt_tokens", "completion_tokens"):
        assert js[k] == ts[k], k
    return tout, treq


MSGS = [{"role": "system", "content": "be brief"},
        {"role": "assistant", "content": "earlier"},
        {"role": "user", "content": "how do tensor cores work"}]

# (dialect class, base url: "url" (…/v1) or "root", call)
CASES = {
    "openai_complete_prompt": ("OpenAICompatClient", "url",
                               lambda c: c.complete(prompt="héllo wörld")),
    "openai_complete_messages": ("OpenAICompatClient", "url",
                                 lambda c: c.complete(messages=MSGS, max_tokens=64,
                                                      model="m2")),
    "openai_complete_cached": ("OpenAICompatClient", "url",
                               lambda c: [c.complete(prompt="cached", temperature=0.0)
                                          for _ in range(2)]),
    "openai_complete_reasoning": ("OpenAICompatClient", "url",
                                  lambda c: c.complete(prompt="think it over")),
    "openai_embed": ("OpenAICompatClient", "url",
                     lambda c: c.embed(["a", "bbb", "cc"], use_cache=False)),
    "openai_embed_cached": ("OpenAICompatClient", "url",
                            lambda c: [c.embed(["x y", "z"]) for _ in range(2)]),
    "openai_rerank": ("OpenAICompatClient", "url",
                      lambda c: c.rerank("forest fox", ["the fox", "a forest fox", "nope"],
                                         top_n=2)),
    "anthropic_complete": ("AnthropicClient", "root",
                           lambda c: c.complete(messages=MSGS, temperature=0.0)),
    "anthropic_embed": ("AnthropicClient", "root", lambda c: c.embed(["x"])),
    "anthropic_rerank": ("AnthropicClient", "root", lambda c: c.rerank("q", ["d"])),
    "dashscope_complete": ("DashScopeClient", "root",
                           lambda c: c.complete(prompt="ping", max_tokens=8)),
    "dashscope_embed": ("DashScopeClient", "root", lambda c: c.embed(["ab", "xyz"])),
    "dashscope_rerank": ("DashScopeClient", "root",
                         lambda c: c.rerank("q d1", ["d0", "q d1"], top_n=2)),
    "gemini_complete": ("GeminiClient", "root",
                        lambda c: c.complete(messages=MSGS, max_tokens=16)),
    "gemini_embed": ("GeminiClient", "root", lambda c: c.embed(["abc", "de"])),
    "gemini_rerank": ("GeminiClient", "root", lambda c: c.rerank("q", ["d"])),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dialect_calls_match_the_reference(stub, tmp_path, case):
    cls_name, base, call = CASES[case]
    j, t = pair(cls_name, stub.url if base == "url" else stub.root, tmp_path,
                api_key="sk-test", model="m1")
    out, treq = both_same(stub, j, t, call)
    if case.endswith("_cached"):
        assert len(treq) == 1  # the second call was a cache hit
    if out[0] == "ok" and case.startswith("openai"):
        assert treq[0][2]["authorization"] == "Bearer sk-test"


ERRORS = {
    # plan served before the normal answers, client kwargs
    "401": ([401], {}),
    "403": ([403], {}),
    "404": ([404], {}),
    "429": ([429] * 3, {}),
    "400_context_window": ([(400, b"This model's maximum context length is 8192 tokens")], {}),
    "400_plain": ([(400, b"bad request")], {}),
    "418": ([418], {}),
    "503_then_ok": ([503, 503], {}),
    "500_always": ([500] * 3, {}),
    "not_json": ([(200, b"<html>not json</html>")], {}),
    "timeout": (["sleep"] * 2, {"timeout": 0.3, "max_retries": 2}),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_statuses_and_faults_classify_as_the_reference(stub, tmp_path, sleeps, case):
    plan, kw = ERRORS[case]
    j, t = pair("OpenAICompatClient", stub.url, tmp_path, api_key="k", model="m1", **kw)
    outs = []
    for c in (j, t):
        stub.plan[:] = list(plan)
        n0 = len(sleeps)
        out, req = run_recorded(stub, lambda: c.complete(prompt="p"))
        outs.append((out, len(req), sleeps[n0:]))
    assert outs[0] == outs[1]
    if case == "503_then_ok":
        assert outs[1][0][0] == "ok" and outs[1][1] == 3 and outs[1][2] == [1.0, 2.0]
    if case == "400_context_window":
        assert outs[1][0][1] == "ContextWindowExceededError"
    if case == "timeout":
        assert outs[1][0][1] == "TimeoutError_" and outs[1][1] == 2


def test_refused_connection_classifies_as_the_reference(tmp_path, sleeps):
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()  # nothing listens there now
    outs = []
    for mod, name in ((jc, "j"), (tc, "t")):
        c = mod.OpenAICompatClient(f"http://127.0.0.1:{port}/v1", model="m",
                                   cache=mod.ResponseCache(str(tmp_path / f"{name}.db")))
        n0 = len(sleeps)
        try:
            c.embed(["x"])
            outs.append(None)
        except Exception as e:  # noqa: BLE001 — compared below
            outs.append((type(e).__name__, e.retryable, sleeps[n0:]))
    assert outs[0] == outs[1] == ("ConnectionError_", True, [1.0, 2.0])


@pytest.mark.parametrize("status, text", [
    (400, "context length exceeded"), (400, "bad"), (401, "no"), (403, "no"),
    (404, "gone"), (429, "slow"), (500, "x"), (503, "x"), (302, "moved"), (418, "tea")])
def test_wrap_provider_error_statuses(status, text):
    r = httpx.Response(status, text=text, request=httpx.Request("POST", "http://x"))
    want = je.wrap_provider_error(httpx.HTTPStatusError("", request=r.request, response=r),
                                  "p", "m")
    got = te.wrap_provider_error(te.ProviderHTTPError(status, text), "p", "m")
    assert type(got).__name__ == type(want).__name__
    assert (str(got), got.status_code, got.retryable, got.provider, got.model) == \
        (str(want), want.status_code, want.retryable, want.provider, want.model)


@pytest.mark.parametrize("ours, theirs", [
    (socket.timeout("timed out"), httpx.ReadTimeout("timed out")),
    (TimeoutError("timed out"), httpx.ConnectTimeout("timed out")),
    (ConnectionRefusedError(111, "refused"), httpx.ConnectError("refused")),
    (ConnectionResetError(104, "reset"), httpx.ConnectError("reset")),
    (socket.gaierror(-2, "no such host"), httpx.ConnectError("no such host")),
    (ValueError("odd"), ValueError("odd")),
])
def test_wrap_provider_error_transport_faults(ours, theirs):
    want = je.wrap_provider_error(theirs)
    got = te.wrap_provider_error(ours)
    assert type(got).__name__ == type(want).__name__
    assert got.retryable == want.retryable
    assert te.is_retryable_error(got) == je.is_retryable_error(want)


def test_cache_keys_equal_the_reference(tmp_path):
    payload = {"model": "m", "input": ["a", "ü"], "n": 1}
    assert tc.ResponseCache.key("embedding", payload) == jc.ResponseCache.key("embedding",
                                                                              payload)
    cache = tc.ResponseCache(str(tmp_path / "c.db"), ttl_s=3600)
    cache.put("k", [[1.5, 2.0]])
    assert cache.get("k") == [[1.5, 2.0]] and cache.get("missing") is None
    assert (cache.hits, cache.misses) == (1, 1)


def test_make_client_dispatch():
    kw = dict(base_url="http://x", cache_enabled=False)
    for api in ("openai", "Anthropic", "dashscope", "gemini", "unknown-thing", "",
                "bedrock", "vertex", "vertex_ai"):
        extra = {"api_key": "{}"} if api.startswith("vertex") else {}
        assert (type(tc.make_client(api, **kw, **extra)).__name__
                == type(jc.make_client(api, **kw, **extra)).__name__)


def test_reconnects_after_the_server_closes_an_idle_connection(tmp_path):
    """The stub closes a keep-alive connection idle for 0.2 s: the next
    call on it is sent again on a new connection, as httpx's pool does."""
    s = StubProvider(dim=4, idle_timeout=0.2)
    try:
        j, t = pair("OpenAICompatClient", s.url, tmp_path, model="m")
        outs = []
        for c in (j, t):
            n0 = len(s.seen)
            first = c.embed(["one"], use_cache=False)
            threading.Event().wait(0.5)
            second = c.embed(["two"], use_cache=False)
            outs.append((first, second, len(s.seen) - n0))
        assert outs[0] == outs[1]
        assert outs[1][2] == 2
    finally:
        s.stop()


def test_one_client_serves_many_threads(stub, tmp_path):
    """http.client connections are not thread-safe: the transport keeps
    one a thread, so concurrent callers each get their own answer."""
    c = tc.OpenAICompatClient(stub.url, model="m", cache_enabled=False)
    want = {i: jc.OpenAICompatClient(stub.url, model="m", cache_enabled=False)
            .embed([f"text {i}"])[0] for i in range(8)}
    errors, got = [], {}

    def worker(i):
        try:
            for _ in range(10):
                got.setdefault(i, []).append(c.embed([f"text {i}"])[0])
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    c.close()
    assert not errors
    assert all(v == [want[i]] * 10 for i, v in got.items())
    assert len(c._transport._open) == 0


# -- the resolver (tests/test_llm_client.py's resolver cases, both packages) ----------


def _dbs(tmp_path):
    return JDatabase(str(tmp_path / "j.db")), TDatabase(str(tmp_path / "t.db"))


def _resolver(mod, db, tmp_path):
    """The JAX resolver's clients open the module's cache file; the port's
    resolver is given its cache file, as the App gives it one."""
    if mod is jr:
        return jr.ModelResolver(db)
    return tr.ModelResolver(db, cache_path=str(tmp_path / "tcache.db"))


def test_resolver_and_remote_embedder(stub, tmp_path):
    outs = []
    for db, mod in zip(_dbs(tmp_path), (jr, tr)):
        db.upsert_provider("stub", base_url=stub.url)
        db.upsert_model("stub", "embedding", "m-embed", tags=["default_for_embedding"])
        db.set_provider_key("stub", "public", "ok")
        resolver = _resolver(mod, db, tmp_path)
        client = resolver.embedding_client({})
        dim = resolver.probe_embedding_dim(client)
        emb = mod.RemoteEmbedder(client, batch_size=2)
        out = emb.embed(["xy", "z", "w"])
        outs.append((client.model, client.api_key, dim, emb.dim, out.dtype, out.tolist()))
    assert outs[0] == outs[1]
    assert outs[1][2] == stub.dim


def test_resolver_returns_none_when_unconfigured(tmp_path):
    for db, mod in zip(_dbs(tmp_path), (jr, tr)):
        resolver = _resolver(mod, db, tmp_path)
        assert resolver.completion_client({}) is None
        assert resolver.embedding_client({"embedding": {"provider": "nope",
                                                        "model": "m"}}) is None


def test_resolver_reuses_clients_across_calls(stub, tmp_path):
    """Same resolved identity -> the same client; a re-tagged model or
    another spec -> a new one; a user's own key wins over the public one."""
    outs = []
    for db, mod in zip(_dbs(tmp_path), (jr, tr)):
        db.upsert_provider("stub", base_url=stub.url)
        db.upsert_model("stub", "rerank", "m-rr", tags=["default_for_rerank"])
        db.set_provider_key("stub", "public", "pub")
        db.set_provider_key("stub", "alice", "mine")
        resolver = _resolver(mod, db, tmp_path)
        c1 = resolver.rerank_client({})
        c2 = resolver.rerank_client({})
        db.upsert_model("stub", "rerank", "m-rr2", tags=["default_for_rerank"])
        c3 = resolver.rerank_client({"rerank": {"provider": "stub", "model": "m-rr2"}})
        c4 = resolver.rerank_client({}, user="alice")
        outs.append((c1 is c2, c3 is c1, c3.model, c1.api_key, c4.api_key,
                     c4.model, type(c1).__name__))
    assert outs[0] == outs[1] == (True, False, "m-rr2", "pub", "mine", "m-rr",
                                  "OpenAICompatClient")


def test_resolver_shares_one_cache_in_the_port(stub, tmp_path):
    db = TDatabase(str(tmp_path / "t.db"))
    db.upsert_provider("stub", base_url=stub.url)
    db.upsert_model("stub", "embedding", "e", tags=["default_for_embedding"])
    db.upsert_model("stub", "completion", "c", tags=["default_for_collection_completion"])
    resolver = tr.ModelResolver(db, cache_path=str(tmp_path / "cache.db"))
    e, c = resolver.embedding_client({}), resolver.completion_client({})
    assert e.cache is c.cache and e.cache is not None
    before = stub.counts["embedding"]
    assert e.embed(["shared"]) == e.embed(["shared"])
    assert stub.counts["embedding"] == before + 1


def test_resolver_uses_provider_api_type(stub, tmp_path):
    outs = []
    for db, mod in zip(_dbs(tmp_path), (jr, tr)):
        db.upsert_provider("ds", base_url=stub.root, api_type="dashscope")
        db.upsert_model("ds", "rerank", "qwen-rr", tags=["default_for_rerank"])
        client = _resolver(mod, db, tmp_path).rerank_client({})
        outs.append((type(client).__name__, client.rerank("q", ["a", "q b", "c"])))
    assert outs[0] == outs[1]
    assert outs[1][0] == "DashScopeClient"


def test_per_collection_rerank_reaches_remote_dialect(stub, tmp_path):
    """The search flow's rerank node uses the collection config's rerank
    spec, resolved at search time (a provider registered after the
    context was built), in both packages, with the same answer."""
    from super_rag_tpu.config import Settings as JSettings
    from super_rag_tpu.service.collection_service import CollectionService as JCS
    from super_rag_tpu.service.context import build_context as jbuild
    from super_rag_tpu_torch.config import Settings as TSettings
    from super_rag_tpu_torch.service.collection_service import CollectionService as TCS
    from super_rag_tpu_torch.service.context import build_context as tbuild

    kw = dict(embedding_dim=64, index_dtype="float32", vocab_size=1 << 14)
    items, queries = [], []
    for build, settings, cs, extra in (
            (jbuild, JSettings, JCS, {}), (tbuild, TSettings, TCS, {"device": "cpu"})):
        ctx = build(settings(data_dir=str(tmp_path / build.__module__), **kw), **extra)
        ctx.db.upsert_provider("ds", base_url=stub.root, api_type="dashscope")
        collections = cs(ctx)
        coll = collections.create("u", "kb", config={"rerank": {"provider": "ds",
                                                                "model": "qwen"}})
        eng = ctx.engines.get(coll["id"], coll["config"])
        eng.ingest([f"passage {i} about topic {i}" for i in range(6)])
        n0 = len(stub.seen)
        res = asyncio.run(collections.execute_search("u", coll["id"], "topic 3",
                                                     top_k=3, use_rerank=True))
        items.append([(it["rank"], it["text"], it["recall_type"], round(it["score"], 6))
                      for it in res["items"]])
        queries.append([r[1] for r in stub.requests_since(n0)])
    assert items[0] == items[1]
    assert all(it[2] == "reranked" for it in items[1])
    assert queries[0] == queries[1] == ["/api/v1/services/rerank/text-rerank/text-rerank"]


def test_http_client_is_the_transport():
    """The port's clients import no httpx: requests go through
    http.client connections."""
    c = tc.OpenAICompatClient("http://127.0.0.1:9", cache_enabled=False)
    conn = c._transport._connection("http", "127.0.0.1:9", fresh=False)
    assert isinstance(conn, http.client.HTTPConnection)
    assert np.isfinite(c._transport.timeout)


def test_business_exceptions_match_the_reference():
    """``exceptions.py``: the same error codes, statuses and domain
    exceptions as the JAX package's."""
    import super_rag_tpu.exceptions as jx
    import super_rag_tpu_torch.exceptions as tx

    assert [(c.name, c.value) for c in tx.ErrorCode] == \
        [(c.name, c.value) for c in jx.ErrorCode]
    names = [n for n in dir(jx) if isinstance(getattr(jx, n), type)
             and issubclass(getattr(jx, n), jx.BusinessException)]
    assert names == [n for n in dir(tx) if isinstance(getattr(tx, n), type)
                     and issubclass(getattr(tx, n), tx.BusinessException)]
    for n in names:
        j, t = getattr(jx, n)("boom"), getattr(tx, n)("boom")
        assert (t.code.value, t.status, t.message) == (j.code.value, j.status, j.message)
    assert tx.BusinessException("x", tx.ErrorCode.QUOTA_EXCEEDED).status == 429
