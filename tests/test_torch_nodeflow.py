"""The port's nodeflow (models, engine, the four search-flow runners)
against the JAX package's: the flows of tests/test_nodeflow.py with toy
runners registered in both packages, the same Kahn levels, resolved values
(sandboxed templates included), events and outputs, and the built-in
search flow (start -> hybrid_search / vector_search -> rerank) over both
packages' engines on the same texts."""

import asyncio
import dataclasses
import logging

import numpy as np
import pytest
from pydantic import BaseModel

import super_rag_tpu.nodeflow.runners  # noqa: F401 — registers runners
import super_rag_tpu_torch.nodeflow.runners  # noqa: F401
from super_rag_tpu.config import Settings as JSettings
from super_rag_tpu.engine.batcher import QueryBatcher as JBatcher
from super_rag_tpu.engine.manager import EngineManager as JManager
from super_rag_tpu.nodeflow import engine as jeng
from super_rag_tpu.nodeflow import models as jmod
from super_rag_tpu.service.collection_service import CollectionService as JCollections
from super_rag_tpu_torch.config import Settings as TSettings
from super_rag_tpu_torch.engine.batcher import QueryBatcher as TBatcher
from super_rag_tpu_torch.engine.manager import EngineManager as TManager
from super_rag_tpu_torch.nodeflow import engine as teng
from super_rag_tpu_torch.nodeflow import models as tmod
from super_rag_tpu_torch.schema.model import Model
from super_rag_tpu_torch.service.collection_service import CollectionService as TCollections

PKGS = {"jax": (jmod, jeng, BaseModel), "torch": (tmod, teng, Model)}
ORDER: dict[str, list[str]] = {"jax": [], "torch": []}


def _register(pkg: str):
    mod, _, base = PKGS[pkg]
    ns = {"value": "", "items": [], "meta": {}}
    echo_in = type("EchoIn", (base,), {"__annotations__": {
        "value": str, "items": list, "meta": dict}, **ns})
    echo_out = type("EchoOut", (base,), {"__annotations__": {
        "value": str, "items": list, "meta": dict}, **ns})
    sleep_io = type("SleepIO", (base,), {"__annotations__": {"tag": str}, "tag": ""})

    async def echo(node, inputs, ctx):
        return echo_out(value=inputs.value, items=inputs.items, meta=inputs.meta)

    async def sleep(node, inputs, ctx):
        ORDER[pkg].append("start:" + inputs.tag)
        await asyncio.sleep(0.02)
        ORDER[pkg].append("end:" + inputs.tag)
        return sleep_io(tag=inputs.tag)

    mod.register_node_runner("parity_echo", echo_in, echo_out)(echo)
    mod.register_node_runner("parity_sleep", sleep_io, sleep_io)(sleep)


@pytest.fixture(scope="module", autouse=True)
def toy_runners():
    for pkg in PKGS:
        _register(pkg)
    yield
    for mod, _, _ in PKGS.values():
        for t in ("parity_echo", "parity_sleep"):
            mod.NODE_RUNNER_REGISTRY.pop(t, None)


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def flow(pkg, nodes, edges, name="t"):
    mod = PKGS[pkg][0]
    return mod.NodeflowInstance(
        name=name,
        nodes=[mod.NodeInstance(*n[:2], input_values=n[2] if len(n) > 2 else {})
               for n in nodes],
        edges=[mod.Edge(*e[:2], **(e[2] if len(e) > 2 else {})) for e in edges])


def execute(pkg, nodes, edges, query="hello", globals_=None, services=None,
            events=None):
    mod, eng, _ = PKGS[pkg]
    engine = eng.NodeflowEngine(on_event=events.append if events is not None else None)
    return run(engine.execute_nodeflow(
        flow(pkg, nodes, edges), mod.SystemInput(query=query, user="u", chat_id="c"),
        globals_=globals_, services=services))


def dump(ctx):
    return {k: v.model_dump() for k, v in ctx.outputs.items()}


def plain(x):
    """Either package's models as (type name, dump), recursively."""
    if hasattr(x, "model_dump"):
        return (type(x).__name__, x.model_dump())
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [plain(v) for v in x]
    return x


BAD_FLOWS = [
    ("cycle", [("a", "start"), ("b", "start")], [("a", "b"), ("b", "a")]),
    ("duplicate", [("a", "start"), ("a", "start")], []),
    ("unknown edge", [("a", "start")], [("a", "zzz")]),
]


@pytest.mark.parametrize("case", BAD_FLOWS, ids=[c[0] for c in BAD_FLOWS])
def test_validation_errors_match(case):
    _, nodes, edges = case
    msgs = []
    for pkg in PKGS:
        with pytest.raises(ValueError) as e:
            flow(pkg, nodes, edges).validate()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


LEVEL_FLOWS = [
    ([("s", "start"), ("a", "start"), ("b", "start"), ("c", "start"), ("d", "start")],
     [("s", "a"), ("s", "b"), ("a", "c"), ("b", "c"), ("c", "d"), ("s", "d")]),
    ([("x", "start"), ("y", "start"), ("z", "start")], []),
    ([("z", "start"), ("y", "start"), ("x", "start")], [("z", "x"), ("y", "x")]),
]


@pytest.mark.parametrize("i", range(len(LEVEL_FLOWS)))
def test_kahn_levels_match(i):
    nodes, edges = LEVEL_FLOWS[i]
    levels = [[[n.id for n in level]
               for level in PKGS[pkg][1].NodeflowEngine()._levels(flow(pkg, nodes, edges))]
              for pkg in PKGS]
    assert levels[0] == levels[1]


TEMPLATES = [
    "plain", "{{ sys.query }}", "{{ sys.user }}-{{ sys.chat_id }}",
    "{{ nodes.s.output.query | upper }}!", "q={{ nodes.s.output.query }} n={{ 3 * 7 }}",
    "{{ globals.g.inner }}", "{{ globals.missing }}", "{{ nodes.nope.output.x }}",
    "{% for w in sys.query.split() %}[{{ w }}]{% endfor %}",
    {"k": "{{ sys.query }}", "l": ["{{ sys.user }}", 3, None]},
    ["{{ globals.g }}", {"x": "{{ nodes.s.output }}"}],
    12, None,
]


@pytest.mark.parametrize("i", range(len(TEMPLATES)))
def test_resolve_value_matches(i):
    got = []
    for pkg in PKGS:
        mod, eng, _ = PKGS[pkg]
        ctx = mod.ExecutionContext(
            system_input=mod.SystemInput(query="two words", user="ann", chat_id="c9"),
            globals={"g": {"inner": "deep"}})
        ctx.outputs["s"] = execute(pkg, [("s", "start")], [], query="two words").outputs["s"]
        got.append(plain(eng.NodeflowEngine().resolve_value(TEMPLATES[i], ctx)))
    assert got[0] == got[1]


@pytest.mark.parametrize("expr", ["{{ ''.__class__.__mro__[1].__subclasses__() }}",
                                  "x {{ sys.__class__.__init__.__globals__ }}",
                                  "y {{ cycler.__init__.__globals__.os }}"])
def test_sandbox_handles_unsafe_templates_alike(expr):
    """An unsafe attribute raises SecurityError or renders empty, the same
    in both packages; nothing of the interpreter leaks into the value."""
    outcomes = []
    for pkg in PKGS:
        mod, eng, _ = PKGS[pkg]
        ctx = mod.ExecutionContext(system_input=mod.SystemInput(query="q"))
        try:
            outcomes.append(("ok", eng.NodeflowEngine().resolve_value(expr, ctx)))
        except Exception as e:  # noqa: BLE001 — compared below
            outcomes.append(("error", type(e).__name__))
    assert outcomes[0] == outcomes[1]
    assert outcomes[1][0] == "error" or "module" not in str(outcomes[1][1])


def test_single_expression_names_no_private_attribute():
    """A single ``{{ path }}`` is looked up outside the jinja2 sandbox; the
    port refuses dunder and private segments there (the JAX package's
    lookup follows them: ROADMAP section C)."""
    mod = PKGS["torch"][0]
    ctx = mod.ExecutionContext(system_input=mod.SystemInput(query="q"),
                               globals={"g": {"_x": 1}})
    eng = teng.NodeflowEngine()
    for expr in ("{{ sys.__class__.__init__.__globals__ }}", "{{ globals.g._x }}",
                 "{{ nodes.s.output.__dict__ }}"):
        assert eng.resolve_value(expr, ctx) is None
    assert eng.resolve_value("{{ sys.query }}", ctx) == "q"


def test_templates_and_parallel_levels():
    nodes = [("s", "start"), ("p1", "parity_sleep", {"tag": "a"}),
             ("p2", "parity_sleep", {"tag": "b"}),
             ("e", "parity_echo", {"value": "q={{ nodes.s.output.query }} "
                                            "tags={{ nodes.p1.output.tag }}"
                                            "{{ nodes.p2.output.tag }}"})]
    edges = [("s", "p1", {"target_handle": "tag"}), ("s", "p2", {"target_handle": "tag"}),
             ("p1", "e", {"target_handle": "value"}), ("p2", "e", {"target_handle": "value"})]
    outs = []
    for pkg in PKGS:
        ORDER[pkg].clear()
        outs.append(dump(execute(pkg, nodes, edges)))
        assert sorted(ORDER[pkg][:2]) == ["start:a", "start:b"]
    assert outs[0] == outs[1]
    assert outs[1]["e"]["value"] == "q=hello tags=ab"


EDGE_CASES = [
    # same-named field on the source output binds directly
    ([("s", "start"), ("e", "parity_echo")], [("s", "e", {"target_handle": "query"})]),
    # an explicit source handle picks that field
    ([("s", "start"), ("e", "parity_echo")],
     [("s", "e", {"source_handle": "query", "target_handle": "value"})]),
    # otherwise the whole output binds (a dict, into the dict field)
    ([("s", "start"), ("e", "parity_echo")], [("s", "e", {"target_handle": "meta"})]),
    # a single expression returns the raw object (a list of models)
    ([("s", "start"), ("a", "parity_echo", {"items": [1, 2]}),
      ("e", "parity_echo", {"items": "{{ nodes.a.output.items }}",
                            "value": "{{ sys.query }}"})],
     [("s", "a"), ("a", "e")]),
]


@pytest.mark.parametrize("i", range(len(EDGE_CASES)))
def test_edge_binding_and_events_match(i):
    nodes, edges = EDGE_CASES[i]
    outs, evs = [], []
    for pkg in PKGS:
        events = []
        outs.append(dump(execute(pkg, nodes, edges, events=events)))
        evs.append([{k: v for k, v in e.items() if k != "duration_ms"} for e in events])
        assert all(e["duration_ms"] >= 0 for e in events if "duration_ms" in e)
    assert outs[0] == outs[1]
    assert evs[0] == evs[1]
    assert [e["event"] for e in evs[1]][0] == "FLOW_START"


def test_runner_error_emits_node_error_alike():
    class Boom(Exception):
        pass

    msgs = []
    for pkg in PKGS:
        mod, _, base = PKGS[pkg]
        io = type("IO", (base,), {"__annotations__": {"x": int}, "x": 0})

        async def boom(node, inputs, ctx):
            raise Boom(f"bad x={inputs.x}")

        mod.register_node_runner("parity_boom", io, io)(boom)
        events = []
        try:
            with pytest.raises(Boom):
                execute(pkg, [("b", "parity_boom", {"x": "7"})], [], events=events)
        finally:
            mod.NODE_RUNNER_REGISTRY.pop("parity_boom")
        msgs.append([(e["event"], e.get("error")) for e in events])
    assert msgs[0] == msgs[1] == [("FLOW_START", None), ("NODE_START", None),
                                  ("NODE_ERROR", "bad x=7")]


def test_search_flow_definitions_match():
    for kw in ({"use_fulltext": True, "use_rerank": True},
               {"use_fulltext": False, "use_rerank": False},
               {"use_fulltext": True, "use_graph": True}):
        flows = [svc(None).build_search_flow(["c1"], 5, 0.2, candidates=100, **kw)
                 for svc in (JCollections, TCollections)]
        assert dataclasses.asdict(flows[0]) == dataclasses.asdict(flows[1])


# -- the built-in search flow over both packages' engines -----------------------

TEXTS = [f"{w} document about {t} number {i}" for i, (w, t) in enumerate(
    (w, t) for w in ("alpha", "beta", "gamma", "delta") for t in
    ("rivers", "mountains", "forests", "deserts", "oceans", "cities"))]


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    kw = dict(embedding_dim=32, index_dtype="float32", vocab_size=1 << 12)
    jm = JManager(JSettings(data_dir=str(tmp_path_factory.mktemp("j")), **kw))
    tm = TManager(TSettings(data_dir=str(tmp_path_factory.mktemp("t")), **kw),
                  device="cpu")
    for m in (jm, tm):
        m.get("c1", {}).ingest(TEXTS, metadata=[{"document_id": f"d{i}"}
                                                for i in range(len(TEXTS))])
    return {"jax": jm, "torch": tm}


def toy_reranker(query, texts):
    return np.asarray([(len(t) * 7 + len(query)) % 11 - 0.01 * i
                       for i, t in enumerate(texts)], np.float32)


def search_flow(pkg, engines, reranker, batcher, **kw):
    mod, eng, _ = PKGS[pkg]
    svc = (JCollections if pkg == "jax" else TCollections)(None)
    f = svc.build_search_flow(["c1"], 4, 0.0, candidates=12, **kw)
    services = {"engines": engines[pkg], "db": None, "reranker": reranker,
                "batcher": batcher}
    return run(eng.NodeflowEngine().execute_nodeflow(
        f, mod.SystemInput(query="alpha rivers forests"), services=services))


@pytest.mark.parametrize("use_fulltext", [True, False])
@pytest.mark.parametrize("reranker", [None, toy_reranker])
@pytest.mark.parametrize("batched", [False, True])
def test_search_flow_outputs_match(engines, use_fulltext, reranker, batched):
    outs = []
    for pkg, batcher_cls in (("jax", JBatcher), ("torch", TBatcher)):
        batcher = batcher_cls(max_batch=8) if batched else None
        ctx = search_flow(pkg, engines, reranker, batcher, use_fulltext=use_fulltext,
                          use_rerank=reranker is not None)
        if batched and hasattr(batcher, "close"):
            batcher.close()
        outs.append([d.model_dump() for d in ctx.outputs["rerank"].docs])
    assert len(outs[0]) == len(outs[1]) == 4
    for a, b in zip(*outs):
        assert abs(a["score"] - b["score"]) <= 1e-5, (a, b)
        assert {**a, "score": 0} == {**b, "score": 0}
    if reranker is not None:
        assert {d["recall_type"] for d in outs[1]} == {"reranked"}


def test_failing_reranker_degrades_alike_and_logs(engines, caplog):
    def broken(query, texts):
        raise RuntimeError("reranker down")

    outs = []
    for pkg in PKGS:
        caplog.clear()
        with caplog.at_level(logging.ERROR):
            ctx = search_flow(pkg, engines, broken, None, use_fulltext=True)
        assert [r.levelno for r in caplog.records] == [logging.ERROR]
        assert "rerank degraded" in caplog.records[0].getMessage()
        outs.append([d.model_dump() for d in ctx.outputs["rerank"].docs])
    assert outs[0] == outs[1] and outs[1]


# -- the parser, the YAML subset and the runners' JSON schemas (A6f) ----------------

def _parse(pkg, definition):
    """A package's parser on ``definition``: its flow as plain values and
    its defaults, or the error's type and message."""
    from super_rag_tpu.nodeflow.parser import NodeflowParser as JParser
    from super_rag_tpu_torch.nodeflow.parser import NodeflowParser as TParser

    try:
        flow_, defaults = (JParser if pkg == "jax" else TParser)().parse(definition)
    except Exception as e:  # noqa: BLE001 — compared between the packages
        return type(e).__name__, str(e)
    return (dataclasses.asdict(flow_), defaults)


def _parser_cases():
    import copy

    from test_nodeflow import RAG_FLOW

    rag_yaml = """
name: yflow   # a comment
input_schema:
  greeting:
    type: string
    default: "hello from globals"
  top: {default: 7}
graph:
  nodes:
    - id: s
      type: start
      data: {}
    - id: e
      type: parity_echo
      data:
        input_values:
          value: "{{ globals.greeting }}"
          items: [1, two, 3.5, null, yes]
  edges:
    - source: s
      target: e
      targetHandle: value
"""
    bad_port = {"name": "x", "graph": {
        "nodes": [{"id": "a", "type": "start", "data": {}},
                  {"id": "b", "type": "rerank", "data": {}}],
        "edges": [{"source": "a", "target": "b", "targetHandle": "nonexistent"}]}}
    as_json = __import__("json").dumps(RAG_FLOW)
    handles = copy.deepcopy(RAG_FLOW)
    handles["graph"]["edges"][0].update(sourceHandle=None, targetHandle="")
    return {"rag flow": RAG_FLOW, "rag flow as JSON text": as_json,
            "yaml flow": rag_yaml, "bad port": bad_port, "empty handles": handles,
            "flat graph": {"nodes": [{"id": "n", "data": {"type": "start",
                                                          "input": {"q": 1}}}]},
            "cycle": {"graph": {"nodes": [{"id": "a", "type": "start"},
                                          {"id": "b", "type": "start"}],
                                "edges": [{"source": "a", "target": "b"},
                                          {"source": "b", "target": "a"}]}}}


@pytest.mark.parametrize("case", list(_parser_cases()))
def test_parser_matches(case):
    definition = _parser_cases()[case]
    got, want = _parse("torch", definition), _parse("jax", definition)
    assert got == want
    if case == "bad port":
        assert got[0] == "ValueError" and "no input port" in got[1]


def test_parser_refuses_yaml_outside_the_subset():
    """The reference's PyYAML reads anchors; the port's subset refuses them
    by name instead of reading a different tree (ROADMAP §C)."""
    text = "name: x\ngraph:\n  nodes: &n []\n  edges: *n\n"
    assert _parse("jax", text)[0] == {"name": "x", "nodes": [], "edges": [], "title": ""}
    kind, msg = _parse("torch", text)
    assert kind == "ValueError" and "anchors (&) are not supported" in msg


# the runners' input and output models, whose schemas the node-type catalog serves
RUNNER_MODELS = [("start", "StartInput"), ("vector_search", "VectorSearchInput"),
                 ("fulltext_search", "FulltextSearchInput"),
                 ("hybrid_search", "HybridSearchInput"), ("graph_search", "GraphSearchInput"),
                 ("merge", "MergeInput"), ("rerank", "RerankInput"), ("llm", "LLMInput")]


@pytest.mark.parametrize("runner,model", RUNNER_MODELS)
def test_runner_model_json_schema_matches_pydantic(runner, model):
    import importlib

    mods = [importlib.import_module(f"{p}.nodeflow.runners.{runner}")
            for p in ("super_rag_tpu", "super_rag_tpu_torch")]
    assert (getattr(mods[1], model).model_json_schema()
            == getattr(mods[0], model).model_json_schema())
    jt, tt = (importlib.import_module(f"{p}.nodeflow.types")
              for p in ("super_rag_tpu", "super_rag_tpu_torch"))
    for name in ("DocumentWithScore", "DocsOutput", "StartOutput", "AnswerOutput"):
        assert getattr(tt, name).model_json_schema() == getattr(jt, name).model_json_schema()
    assert (tmod.SystemInput.model_json_schema() == jmod.SystemInput.model_json_schema())


def test_node_type_catalog_matches():
    """Every built-in runner's catalog entry, dict-equal; the toy runners
    this file registers in both packages too."""
    import super_rag_tpu_torch.nodeflow.runners  # noqa: F401

    cats = [{c["type"]: c for c in mod.node_type_catalog()} for mod in (jmod, tmod)]
    port_types = set(cats[1])
    assert {"start", "vector_search", "fulltext_search", "hybrid_search", "graph_search",
            "merge", "rerank", "llm", "parity_echo", "parity_sleep"} <= port_types
    assert {t: cats[0][t] for t in port_types} == cats[1]


# -- the YAML subset against yaml.safe_load ------------------------------------------

def _yaml_trees():
    from hypothesis import strategies as st

    scalars = st.one_of(st.text(), st.integers(), st.floats(allow_nan=False),
                        st.booleans(), st.none())
    trees = st.recursive(scalars, lambda ch: st.one_of(
        st.lists(ch, max_size=5), st.dictionaries(st.text(), ch, max_size=5)),
        max_leaves=30)
    return st.one_of(st.lists(trees, max_size=5), st.dictionaries(st.text(), trees,
                                                                  max_size=5))


@pytest.mark.parametrize("style", ["block", "flow", "mixed"])
def test_yaml_subset_loads_what_safe_dump_writes(style):
    """Nested dicts and lists of str / int / float / bool / None, dumped by
    ``yaml.safe_dump`` (block, flow or PyYAML's mixed style, at the default
    width of 80 and at 20, so that long scalars fold over lines), load to
    the tree ``yaml.safe_load`` gives."""
    import yaml
    from hypothesis import HealthCheck, given, settings, strategies as st

    from super_rag_tpu_torch.nodeflow import yamlsub

    flow_style = {"block": False, "flow": True, "mixed": None}[style]

    @settings(max_examples=150, deadline=None, derandomize=True, database=None,
              suppress_health_check=list(HealthCheck))
    @given(_yaml_trees(), st.sampled_from([80, 20]))
    def check(tree, width):
        text = yaml.safe_dump(tree, default_flow_style=flow_style, width=width)
        assert yamlsub.load(text) == yaml.safe_load(text), text

    check()


YAML_TEXTS = [
    "a: 1\nb: yes\nc: 0x1F\nd: 0o7\ne: 1_000\nf: 1:30\ng: 1e3\nh: 1.0e+3\ni: .inf\n"
    "j: -.INF\nk: ~\nl: null\nm:\nn: 017\no: +12\np: 1:30.5\nq: On\nr: 0b101\ns: 1.\n"
    "t: .5\nu: NO\nv: 0.\nw: -0\n",
    "# comment\n---\nkey: value # trailing\nlist:\n  - a\n  - b   # c\n  -\n"
    "  - - x\n    - y\n  - k: v\n    k2: v2\n...\n",
    "a: this is a long\n  plain scalar\n\n  with a blank line\nb: 'single ''quoted''\n"
    "  folded'\nc: \"double \\\"q\\\" \\x41\\u00e9\\U0001F600 \\\n  continued\\t\"\n",
    "flow: {a: [1, 2, {b: c}], d: 'e', \"f\": g, h: }\nseq: [a, b,\n  c, 'd e']\n",
    "? complex key\n: value\n? another\n",
    "a:b: c\nx: a:b\ny: -1\nz: -x\nw: '#not comment'\nv: a#b\n",
    "", "- a\n- b: c\n  d: e\n-   - f\n    - g\n", "{}", "[]", "key:    \n  value\n",
    "a: \"x\\\n   y\"\nb: \"x\n\n  y\"\n", "a : b\n", "a: b  \n",
    "top:\n  nested:\n    deep: 1\n  other: 2\nback: 3\n", "a:\n- 1\n- 2\nb:\n  - 3\n",
    "{a:1}", "{\"a\":1}", "x: [a, [b, c], {}]\n", "'quoted key': 1\n\"dq key\": 2\n",
    "\ufeffa: 1\r\nb: 2\r\n", "1: one\n2.5: two\nnull: three\ntrue: four\n",
]


@pytest.mark.parametrize("i", range(len(YAML_TEXTS)))
def test_yaml_subset_matches_safe_load_on_hand_written_text(i):
    import yaml

    from super_rag_tpu_torch.nodeflow import yamlsub

    assert yamlsub.load(YAML_TEXTS[i]) == yaml.safe_load(YAML_TEXTS[i])


REFUSED_YAML = [
    ("anchor and alias", "a: &x 1\nb: *x\n", "anchors (&)"),
    ("alias", "a: *x\n", "aliases (*)"),
    ("tag", "a: !!str 1\n", "tags (!)"),
    ("literal block scalar", "a: |\n  text\n", "block scalars (|)"),
    ("folded block scalar", "a: >\n  text\n", "block scalars (>)"),
    ("directive", "%YAML 1.1\n---\na: 1\n", "directives (%)"),
    ("two documents", "a: 1\n---\nb: 2\n", "multiple documents"),
    ("timestamp", "a: 2001-12-14\n", "timestamps"),
    ("merge key", "<<: {a: 1}\n", "merge keys (<<)"),
    ("value key", "a: =\n", "the value key (=)"),
    ("collection key", "[a]: 1\n", "collections as mapping keys"),
    ("flow collection key", "{[a]: 1}\n", "collections as mapping keys"),
    ("single-pair mapping", "[a: 1]\n", "single-pair mappings"),
    ("tab indentation", "a:\n\tb: 1\n", "tabs"),
    ("reserved indicator", "a: `x`\n", "reserved indicator"),
    ("unicode line break", "a: b\u2028c\n", "line break"),
]


@pytest.mark.parametrize("case", REFUSED_YAML, ids=[c[0] for c in REFUSED_YAML])
def test_yaml_subset_refuses_by_name(case):
    from super_rag_tpu_torch.nodeflow import yamlsub

    _, text, what = case
    with pytest.raises(ValueError, match="YAML subset: ") as e:
        yamlsub.load(text)
    assert what in str(e.value)


@pytest.mark.parametrize("text", ["a: b: c\n", "- a\nb: c\n", "a: 'open\n", "a:\n  - b\n c: d\n",
                                  "[a, b\n", "{a: 1\n", "a: b\n  c: d\n"])
def test_yaml_subset_refuses_what_pyyaml_refuses(text):
    import yaml

    from super_rag_tpu_torch.nodeflow import yamlsub

    with pytest.raises(yaml.YAMLError):
        yaml.safe_load(text)
    with pytest.raises(ValueError, match="YAML subset: "):
        yamlsub.load(text)


def test_pack_registry_matches(tmp_path, caplog):
    """``load_pack_module``, ``load_packs`` (no pack is installed under
    either entry-point group), ``registry_index`` and ``registry_summary``
    answer alike; the loaded-pack list is reset by ``load_packs``."""
    import json

    from super_rag_tpu.nodeflow import registry as jreg
    from super_rag_tpu_torch.nodeflow import registry as treg

    index = tmp_path / "index.json"
    index.write_text(json.dumps([{"name": "pack", "module": "m"}]))
    out = []
    try:
        for reg in (jreg, treg):
            with caplog.at_level(logging.ERROR):
                loaded = (reg.load_pack_module("json"),
                          reg.load_pack_module("no_such_pack_module"))
            summary = reg.registry_summary()
            out.append((loaded, summary["loaded_packs"], reg.registry_index(str(index)),
                        reg.registry_index(None), reg.registry_index(str(tmp_path / "x"))))
    finally:
        assert jreg.load_packs() == [] and treg.load_packs() == []
    assert out[0] == out[1]
    assert out[1][:2] == ((True, False), ["json"])
    assert treg.ENTRY_POINT_GROUP == "super_rag_tpu_torch.nodeflow.packs"
    assert treg.registry_summary()["loaded_packs"] == []
