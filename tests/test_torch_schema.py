"""The port's request models (schema/model.py, its stand-in for pydantic)
against the JAX package's pydantic models: the same parsed
``model_dump`` for a valid body, and the same 422 text from
``parse_body`` (first error's location and pydantic's message, letter for
letter) for an invalid one."""

import pytest

from super_rag_tpu.api.http import HttpError as JHttpError
from super_rag_tpu.schema import view_models as jvm
from super_rag_tpu_torch.api.http import HttpError as THttpError
from super_rag_tpu_torch.schema import model as tmodel
from super_rag_tpu_torch.schema import view_models as tvm

CASES = {
    "CollectionConfig": [
        {}, {"metric": "ip", "index_dtype": "int8"}, {"metric": "hamming"},
        {"metric": None}, {"metric": 5}, {"index_dtype": "float16"},
        {"bm25_slots": 4}, {"bm25_slots": 1024}, {"bm25_slots": "16"},
        {"bm25_slots": 16.0}, {"bm25_slots": 16.5}, {"bm25_slots": "x"},
        {"bm25_slots": True}, {"bm25_slots": None}, {"bm25_slots": [8]},
        {"vocab_size": 3000}, {"vocab_size": 512}, {"vocab_size": 4096},
        {"vocab_size": "8192"}, {"vocab_size": "8192.0"}, {"vocab_size": " 2048 "},
        {"vocab_size": "5.5"}, {"vocab_size": float("nan")}, {"vocab_size": 1e30},
        {"vocab_size": "4096."}, {"vocab_size": "4096.00"}, {"vocab_size": "+4096"},
        {"vocab_size": "4_096"}, {"vocab_size": "0x1000"}, {"vocab_size": ""},
        {"enable_summary": "yes"}, {"enable_summary": "off"}, {"enable_summary": 1},
        {"enable_summary": 2}, {"enable_summary": "maybe"}, {"enable_summary": 0.5},
        {"enable_summary": 1.0}, {"enable_summary": None}, {"enable_vision": "T"},
        {"kg_entity_types": [{"name": "Person", "description": "a human"}]},
        {"kg_entity_types": [{"name": ""}]}, {"kg_entity_types": [{"name": "x" * 65}]},
        {"kg_entity_types": [{"name": "a", "pattern": None}, 5]},
        {"kg_entity_types": "Person"}, {"kg_entity_types": None},
        {"kg_entity_types": [{"description": "no name"}]},
        {"embedding": {"provider": "onboard", "model": "/m"}}, {"embedding": 5},
        {"embedding": {"dim": "x"}}, {"embedding": {"dim": "64"}},
        {"embedding": {"provider": 3}}, {"embedding": None},
        {"rerank": {"provider": "onboard"}, "completion": {"model": "m"}},
        {"metric": "x", "bm25_slots": 1}, {"unknown_key": 1, "metric": "l2"},
        {"hybrid": {"rescore": True}},
    ],
    "CollectionCreate": [
        {"title": "kb"}, {}, {"title": ""}, {"title": "x" * 257}, {"title": 5},
        {"title": None}, {"title": b"bytes"}, {"title": "kb", "description": None},
        {"title": "kb", "config": None}, {"title": "kb", "config": 5},
        {"title": "kb", "config": {"metric": "dot"}},
        {"title": "kb", "config": {"embedding": {"provider": "onboard"}}},
        {"title": "kb", "extra": [1, 2]}, {"description": "no title"},
    ],
    "CollectionUpdate": [
        {}, {"title": None, "config": None}, {"title": ""}, {"description": "d"},
        {"config": {"vocab_size": 1000}}, {"config": {"bm25_slots": 9}},
        {"title": "x" * 300, "config": {"metric": "l1"}},
    ],
    "DocumentUpload": [
        {"name": "a.md", "content": "hi"}, {"name": "a.md", "metadata": None},
        {"name": ""}, {"content": "no name"}, {"name": "a", "metadata": []},
        {"name": "a", "metadata": {"k": [1, {"x": None}]}, "chat_id": None},
        {"name": "a", "chat_id": 5}, {"name": "x" * 513},
    ],
    "SearchRequest": [
        {"query": "q"}, {}, {"query": ""}, {"query": 5}, {"query": None},
        {"query": "q", "top_k": 0}, {"query": "q", "top_k": 101},
        {"query": "q", "top_k": "7"}, {"query": "q", "top_k": "many"},
        {"query": "q", "top_k": 2.0}, {"query": "q", "top_k": 2.5},
        {"query": "q", "top_k": True}, {"query": "q", "similarity_threshold": None},
        {"query": "q", "similarity_threshold": -2}, {"query": "q", "similarity_threshold": 2},
        {"query": "q", "similarity_threshold": "0.5"},
        {"query": "q", "similarity_threshold": "high"},
        {"query": "q", "use_rerank": "false"}, {"query": "q", "use_rerank": "perhaps"},
        {"query": "q", "use_rerank": "TRUE"}, {"query": "q", "use_rerank": -1},
        {"query": "q", "use_rerank": "01"}, {"query": "q", "use_rerank": b"no"},
        {"query": "q", "similarity_threshold": " 0.5 "},
        {"query": "q", "similarity_threshold": "1e-1"},
        {"query": "q", "use_fulltext": 0, "use_graph": "on"},
        {"query": "q", "chat_id": 5}, {"query": "q", "chat_id": "c1"},
        {"query": "q", "top_k": 0, "use_rerank": "x"}, {"top_k": 0},
    ],
    "MultiSearchRequest": [
        {"query": "q", "collection_ids": ["a", "b"]}, {"query": "q"},
        {"query": "q", "collection_ids": []}, {"query": "q", "collection_ids": "a"},
        {"query": "q", "collection_ids": [1]}, {"query": "q", "collection_ids": ("a",)},
        {"query": "q", "collection_ids": ["a", None]},
        {"query": "q", "collection_ids": ["a"], "top_k": 500},
        {"collection_ids": ["a"]},
    ],
    "RegisterRequest": [
        {"username": "alice", "password": "secret123"},
        {"username": "alice", "password": "short"}, {"username": "", "password": "x"},
        {"username": "a" * 65, "password": "p" * 8}, {"username": "bob"},
        {"password": "secret123"}, {"username": "bob", "password": "p" * 257},
        {"username": "bob", "password": 12345678}, {"username": "bob",
                                                     "password": "secret123",
                                                     "email": None},
    ],
    "LoginRequest": [
        {"username": "a", "password": "b"}, {}, {"username": 5, "password": "b"},
        {"username": "a"}, {"username": "a", "password": None},
    ],
    "WorkflowDefinition": [
        {"graph": {"nodes": [{"id": "s", "type": "start"}]}}, {}, {"graph": None},
        {"graph": {}}, {"graph": {"nodes": "s"}}, {"graph": {"nodes": [{"id": "s"}]}},
        {"graph": {"nodes": [{"id": "", "type": "start"}]}},
        {"graph": {"nodes": [{"id": "s", "type": "start", "data": []}]}},
        {"graph": {"nodes": [], "edges": [{"source": "a"}]}},
        {"graph": {"nodes": [], "edges": [{"source": "a", "target": "b",
                                           "targetHandle": 5}]}},
        {"name": 3, "graph": {"nodes": []}, "input_schema": []},
        {"name": "x", "graph": {"nodes": [5], "edges": None}},
    ],
    "WorkflowCreate": [
        {"title": "wf", "definition": {"graph": {"nodes": []}}}, {"title": "wf"},
        {"title": "", "definition": {"graph": {"nodes": []}}},
        {"title": "x" * 257, "definition": 5}, {"definition": {}},
    ],
    "WorkflowRunRequest": [{}, {"inputs": {"query": "q"}}, {"inputs": "q"},
                           {"inputs": None}],
    "ChatCreate": [
        {}, {"title": "t", "collection_ids": ["a", "b"]}, {"title": "x" * 257},
        {"title": None}, {"title": 5}, {"collection_ids": "a"}, {"collection_ids": [1]},
        {"collection_ids": None}, {"collection_ids": ("a",)}, {"unknown": 1},
    ],
    "AgentCreate": [
        {"title": "helper"}, {}, {"title": ""}, {"title": "x" * 257},
        {"title": "a", "config": []}, {"title": "a", "config": None},
        {"title": "a", "description": None}, {"title": "a", "config": {"k": [1]}},
        {"description": "no title", "config": 5},
    ],
    "AgentUpdate": [
        {}, {"title": ""}, {"title": None, "config": None}, {"config": 5},
        {"description": 3}, {"title": "x" * 300, "config": []}, {"config": {"a": 1}},
    ],
    "WebSearchRequest": [
        {}, {"query": "q"}, {"query": None}, {"query": 5}, {"max_results": 0},
        {"max_results": 51}, {"max_results": "7"}, {"max_results": 2.5},
        {"providers": "x"}, {"providers": ["a", 1]}, {"providers": None},
        {"source": 5}, {"source": "docs.example.com"}, {"max_results": 0, "source": 1},
    ],
}

PARAMS = [(name, i) for name, bodies in CASES.items() for i in range(len(bodies))]


@pytest.mark.parametrize("name,i", PARAMS, ids=[f"{n}-{i}" for n, i in PARAMS])
def test_parse_body_matches_pydantic(name, i):
    body = CASES[name][i]
    try:
        want = ("ok", jvm.parse_body(getattr(jvm, name), body).model_dump())
    except JHttpError as e:
        want = (e.status, e.message)
    try:
        got = ("ok", tvm.parse_body(getattr(tvm, name), body).model_dump())
    except THttpError as e:
        got = (e.status, e.message)
    assert got == want


@pytest.mark.parametrize("name", list(CASES))
def test_every_error_matches_pydantic(name):
    """Not only the first error: every error's loc, msg and type."""
    for body in CASES[name]:
        try:
            getattr(jvm, name)(**body)
            want = []
        except Exception as e:  # pydantic.ValidationError
            want = [(x["loc"], x["msg"], x["type"]) for x in e.errors()]
        try:
            getattr(tvm, name)(**body)
            got = []
        except tmodel.ValidationError as e:
            got = [(x["loc"], x["msg"], x["type"]) for x in e.errors()]
        assert got == want, body


@pytest.mark.parametrize("exclude_none", [False, True])
def test_model_dump_and_fields(exclude_none):
    body = {"title": "kb", "config": {"metric": "l2", "embedding": {"model": "m"},
                                      "kg_entity_types": [{"name": "P"}]}}
    j, t = jvm.CollectionCreate(**body), tvm.CollectionCreate(**body)
    assert (t.model_dump(exclude_none=exclude_none)
            == j.model_dump(exclude_none=exclude_none))
    assert list(tvm.SearchRequest.model_fields) == list(jvm.SearchRequest.model_fields)
    assert list(tvm.CollectionConfig.model_fields) == list(
        jvm.CollectionConfig.model_fields)


def test_defaults_are_copied_per_instance():
    a, b = tvm.CollectionConfig(), tvm.CollectionConfig()
    a.kg_entity_types.append("x")
    assert b.kg_entity_types == []
    d1, d2 = tvm.DocumentUpload(name="a"), tvm.DocumentUpload(name="b")
    d1.metadata["k"] = 1
    assert d2.metadata == {}


def test_nested_instance_is_kept_and_validator_runs_on_defaults_only_when_given():
    spec = tvm.ModelSpec(provider="onboard")
    cfg = tvm.CollectionConfig(embedding=spec)
    assert cfg.embedding is spec
    with pytest.raises(tmodel.ValidationError) as e:
        tvm.CollectionConfig(embedding=tvm.KGEntityType(name="x"))
    assert e.value.errors()[0]["msg"] == ("Input should be a valid dictionary or "
                                          "instance of ModelSpec")


JSON_SCHEMA_MODELS = ["ModelSpec", "KGEntityType", "CollectionConfig", "CollectionCreate",
                      "CollectionUpdate", "DocumentUpload", "SearchRequest",
                      "MultiSearchRequest", "ImageSearchRequest", "LLMProviderCreate",
                      "LLMProviderModelCreate", "ProviderKeySet", "RegisterRequest",
                      "LoginRequest", "ChangePasswordRequest", "ApiKeyCreate",
                      "WorkflowNode", "WorkflowEdge", "WorkflowGraph",
                      "WorkflowDefinition", "WorkflowCreate", "WorkflowRunRequest"]


def _strip_descriptions(schema):
    if isinstance(schema, dict):
        return {k: _strip_descriptions(v) for k, v in schema.items() if k != "description"}
    return schema


@pytest.mark.parametrize("name", JSON_SCHEMA_MODELS)
def test_model_json_schema_matches_pydantic(name):
    """``model_json_schema`` of every view model the port has, equal to
    pydantic's for the JAX package's class of the same name up to the
    models' descriptions, which are their docstrings and word the two
    packages' classes differently (the runners' models, whose schemas the
    node-type catalog serves, have none and are compared whole in
    test_torch_nodeflow.py)."""
    import inspect

    got = tvm.__dict__[name].model_json_schema()
    assert _strip_descriptions(got) == _strip_descriptions(
        getattr(jvm, name).model_json_schema())
    doc = tvm.__dict__[name].__doc__
    assert got.get("description") == (inspect.cleandoc(doc) if doc else None)
