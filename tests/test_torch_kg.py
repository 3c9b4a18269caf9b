"""The port's knowledge graph (super_rag_tpu_torch/kg/) against the JAX
package's on the same seeded episodes, on the CPU: extraction (the
offline heuristic, and the LLM tier through a deterministic fake
completion with its fallback), every construction function, and
``KnowledgeGraphService(device="cpu")`` — the same nodes, labels, facts
and invalidations, the same introspection, every search recipe, ``as_of``,
BFS origins, episode deletion and a restart over the same database.

Ids are uuids and episodes stamp ``time.time()``, so both services run
with one deterministic id sequence and one fixed clock; results are then
compared row for row, and searches up to ties (items of equal score may
come in either order), with scores within 1e-5 relative.
"""

import dataclasses
import itertools
import json
import types

import numpy as np
import pytest

from super_rag_tpu.kg import construct as jcon
from super_rag_tpu.kg import extract as jext
from super_rag_tpu.kg import service as jsvc
from super_rag_tpu.store.db import Database as JDatabase
from super_rag_tpu_torch.kg import construct as tcon
from super_rag_tpu_torch.kg import extract as text_
from super_rag_tpu_torch.kg import service as tsvc
from super_rag_tpu_torch.store.db import Database as TDatabase

from torch_parity import kg_entities, kg_sentences

CLOCK = 1_750_000_000.0
SCORE_RTOL = 1e-5
SCORE_ATOL = 1e-7


# -- helpers -----------------------------------------------------------------


def fake_completion(prompt: str) -> str:
    """A deterministic stand-in for a completion model: JSON triples for
    the extraction prompts (two per capitalised pair it sees), a 'missed'
    list for the reflexion prompt, verdicts for dedupe / edge prompts and
    summaries, each a function of the prompt's text."""
    words = [w.strip(".,;:()\"'") for w in prompt.split()]
    caps = [w for w in words if w[:1].isupper() and len(w) > 3][:12]
    if "missed" in prompt and "entities were extracted" in prompt:
        return json.dumps({"missed": caps[-2:]})
    if "triples" in prompt.lower():
        triples = [{"source": a, "relation": "related_to", "target": b,
                    "fact": f"{a} relates to {b}.", "source_type": "Organization",
                    "target_type": "Person" if i % 2 else "Concept",
                    "valid_at": "2019-05-01" if i % 3 == 0 else None}
                   for i, (a, b) in enumerate(zip(caps[::2], caps[1::2]))]
        return "Here you go: " + json.dumps({"triples": triples})
    if "duplicate_name" in prompt:
        return json.dumps({"duplicate_name": caps[-1] if caps else ""})
    if "contradictions" in prompt:
        return json.dumps({"duplicates": [0], "contradictions": [1, 7]})
    if "summaries" in prompt:
        return json.dumps({"summaries": {c: f"{c} summary" for c in caps[:3]}})
    return " ".join(caps[:6])


def raising_completion(prompt: str) -> str:
    raise RuntimeError("provider down")


def garbage_completion(prompt: str) -> str:
    return "no json here"


def fake_reranker(query: str, texts):
    """Distinct texts get distinct scores."""
    return np.asarray([(sum(map(ord, query + t)) * 2654435761 % 1000003) / 1000003.0
                       for t in texts], np.float32)


def _triples(ts):
    return [dataclasses.astuple(t) for t in ts]


def same_up_to_ties(ref: list, got: list, key):
    """Equal length; scores within tolerance position by position; each
    group of tied reference scores holds the same items in both (the last
    group may be cut by top_k, so there only the scores must agree)."""
    assert len(got) == len(ref), (len(got), len(ref))
    rs = np.asarray([r["score"] for r in ref], np.float64)
    gs = np.asarray([g["score"] for g in got], np.float64)
    np.testing.assert_allclose(gs, rs, rtol=SCORE_RTOL, atol=SCORE_ATOL)
    i = 0
    while i < len(ref):
        j = i + 1
        while j < len(ref) and abs(rs[j] - rs[i]) <= SCORE_ATOL + SCORE_RTOL * abs(rs[i]):
            j += 1
        if j < len(ref) or i == 0 and j == len(ref) and len(ref) < 3:
            assert sorted(map(key, ref[i:j])) == sorted(map(key, got[i:j])), (ref, got)
        i = j


def _patch_clock_and_ids(monkeypatch):
    for mod in (jsvc, tsvc):
        counter = itertools.count()
        monkeypatch.setattr(mod, "new_id",
                            lambda prefix="", c=counter: f"{prefix}-{next(c):020d}")
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(time=lambda: CLOCK))


def _episodes(seed: int, n_eps: int, per: int):
    rng = np.random.default_rng(seed)
    org, ppl = kg_entities(rng, people=10, orgs=12)
    return [" ".join(kg_sentences(rng, per, org, ppl)) for _ in range(n_eps)], org, ppl


def _fill(svc, texts, ontology_cls):
    onto = ontology_cls.from_config([
        {"name": "Company", "pattern": r"\b(Labs|Inc|Systems)$"},
        {"name": "Person", "pattern": r"^Dr "}, "Place"])
    svc.add_episode("g", texts[0], source="doc0")
    svc.add_episode("g", texts[1], source="doc1", ontology=onto)
    svc.add_episode_bulk("g", texts[2:5], source="doc2")
    svc.add_episode_bulk("g", texts[5:], source="doc3", ontology=onto)


def _tables(db):
    return {t: db.query(f"SELECT * FROM {t} ORDER BY rowid")
            for t in ("kg_node", "kg_edge", "kg_episode", "kg_node_alias")}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    _patch_clock_and_ids(mp)
    tmp = tmp_path_factory.mktemp("kg")
    texts, org, ppl = _episodes(7, 8, 10)
    j = jsvc.KnowledgeGraphService(JDatabase(str(tmp / "j.db")), embed_dim=64,
                                   reranker=fake_reranker)
    t = tsvc.KnowledgeGraphService(TDatabase(str(tmp / "t.db")), embed_dim=64,
                                   reranker=fake_reranker, device="cpu")
    _fill(j, texts, jext.Ontology)
    _fill(t, texts, text_.Ontology)
    yield types.SimpleNamespace(j=j, t=t, org=org, ppl=ppl, tmp=tmp, mp=mp)
    mp.undo()


# -- extraction ----------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_heuristic_extract_matches(seed):
    texts, _, _ = _episodes(seed, 1, 24)
    text = texts[0] + " The Acme Corporation is based in Kent County. Mr Ode" \
        " was employed by Fabrikam Inc on March 3, 2011. It uses 2020-02-30."
    assert _triples(text_.heuristic_extract(text)) == _triples(jext.heuristic_extract(text))
    assert (_triples(text_.heuristic_extract(text, max_triples=5))
            == _triples(jext.heuristic_extract(text, max_triples=5)))
    cfg = [{"name": "Firm", "pattern": r"Inc|Labs"}, {"name": "Bad", "pattern": "("},
           "Person", {"description": "no name"}]
    assert (_triples(text_.heuristic_extract(text, ontology=text_.Ontology.from_config(cfg)))
            == _triples(jext.heuristic_extract(text, ontology=jext.Ontology.from_config(cfg))))


@pytest.mark.parametrize("completion", [fake_completion, raising_completion,
                                        garbage_completion, None])
@pytest.mark.parametrize("reflexion", [True, False])
def test_llm_extract_and_fallback_match(completion, reflexion):
    texts, _, _ = _episodes(3, 1, 12)
    cfg = [{"name": "Organization", "description": "a company"}, "Person"]
    want = jext.extract(texts[0], completion, ontology=jext.Ontology.from_config(cfg))
    got = text_.extract(texts[0], completion, ontology=text_.Ontology.from_config(cfg))
    assert _triples(got) == _triples(want)
    if completion is fake_completion:
        assert (_triples(text_.llm_extract(texts[0], completion, 7, reflexion=reflexion))
                == _triples(jext.llm_extract(texts[0], completion, 7, reflexion=reflexion)))
    assert text_.Ontology.from_config(cfg).prompt_types() == \
        jext.Ontology.from_config(cfg).prompt_types()


# -- construction ----------------------------------------------------------------


NAMES = ["Acme Robotics", "acme robotics", "Acme Robotic", "GPU",
         "Graphics Processing Unit", "G.P.U.", "Zeta Labs", "Zeta Lab Inc", "",
         "a", "International Business Machines", "IBM"]


def test_similarity_and_acronyms_match():
    for a in NAMES:
        assert tcon.norm_name(a) == jcon.norm_name(a)
        for b in NAMES:
            assert tcon.trigram_similarity(a, b) == jcon.trigram_similarity(a, b)
            assert tcon.is_acronym(a, b) == jcon.is_acronym(a, b)


@pytest.mark.parametrize("completion", [None, fake_completion, raising_completion,
                                        garbage_completion])
def test_resolve_node_and_edge_match(completion):
    cands = [{"name": n, "summary": f"about {n}"} for n in NAMES if n]
    for name in ["ACME robotics", "Acme Robotix", "Graphics Processing Unit",
                 "Bolt Dynamics", "ibm", "Zeta"]:
        assert (tcon.resolve_node(name, cands, completion, context="ctx")
                == jcon.resolve_node(name, cands, completion, context="ctx"))
    assert tcon.resolve_node("x", [], completion) == jcon.resolve_node("x", [], completion)
    pair = [(0, "Alice leads Acme."), (1, "Alice leads  acme.")]
    other = [(2, "Alice leads Zeta."), (3, "Alice leads Bolt.")]
    for fact, rel in [("alice leads acme.", "leads"), ("Alice likes Acme.", "likes"),
                      ("Alice leads Acme now.", "LEADS")]:
        for p, o in [(pair, other), ([], other), (pair, []), ([], [])]:
            assert (dataclasses.asdict(tcon.resolve_edge(fact, rel, p, o, completion))
                    == dataclasses.asdict(jcon.resolve_edge(fact, rel, p, o, completion)))


@pytest.mark.parametrize("completion", [None, fake_completion, raising_completion])
def test_summaries_match(completion):
    facts = ["Alice leads Acme.", "Alice leads Acme", "Alice founded Zeta in 2019.",
             "x" * 200]
    assert (tcon.summarize_node("Alice", facts, completion)
            == jcon.summarize_node("Alice", facts, completion))
    assert tcon.summarize_node("Alice", [], completion) == ""
    ents = [("Alice", facts), ("Acme", facts[:1]), ("Nobody", [])]
    assert (tcon.summarize_nodes_batch(ents, completion)
            == jcon.summarize_nodes_batch(ents, completion))
    for a, b in [("", "b"), ("a", ""), ("A; B", "b; C."), ("x" * 300, "y")]:
        assert (tcon.combine_summaries(a, b, completion)
                == jcon.combine_summaries(a, b, completion))


@pytest.mark.parametrize("seed", range(8))
def test_label_propagation_matches(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 40))
    adj: dict = {f"n{i:02d}": set() for i in range(n)}
    for _ in range(int(rng.integers(1, 3 * n))):
        a, b = rng.choice(n, 2, replace=False)
        adj[f"n{a:02d}"].add(f"n{b:02d}")
        adj[f"n{b:02d}"].add(f"n{a:02d}")
    assert tcon.label_propagation(adj) == jcon.label_propagation(adj)
    assert tcon.label_propagation(adj, max_iters=1) == jcon.label_propagation(adj, max_iters=1)


# -- the service ----------------------------------------------------------------


def test_graph_state_matches(pair):
    want, got = _tables(pair.j.db), _tables(pair.t.db)
    assert got == want
    assert len(want["kg_edge"]) >= 40 and len(want["kg_node"]) >= 15
    assert any(e["invalid_at"] is not None for e in want["kg_edge"])
    assert {n["label"] for n in want["kg_node"]} >= {"Company", "Entity"}


def test_introspection_matches(pair):
    j, t = pair.j, pair.t
    assert t.stats("g") == j.stats("g")
    assert t.labels("g") == j.labels("g")
    assert t.communities("g") == j.communities("g")
    assert t.communities("g", max_members=2) == j.communities("g", max_members=2)
    for node, limit in [(None, 200), (None, 5), (pair.org[0], 200), ("nobody", 200)]:
        assert t.subgraph("g", node, limit=limit) == j.subgraph("g", node, limit=limit)
    for depth, as_of in [(1, None), (2, None), (2, 1.2e9)]:
        origins = [pair.org[0], pair.ppl[0], "nobody"]
        assert (t.expand("g", origins, max_depth=depth, as_of=as_of)
                == j.expand("g", origins, max_depth=depth, as_of=as_of))
    assert t.expand("g", ["nobody"]) == j.expand("g", ["nobody"])
    assert t.stats("other") == j.stats("other")


QUERIES = ["acquired", "Northwind Labs", "leads since 2010", "founded by Dr",
           "Warehouse Robots Contoso", "offices in Silicon Valley", "zebra"]


@pytest.mark.parametrize("rerank", [None, "mmr", "cross_encoder", "node_distance"])
def test_search_recipes_match(pair, rerank):
    j, t = pair.j, pair.t
    center = pair.org[1]
    for q in QUERIES:
        for kw in ({}, {"center_node": center}, {"bfs_origin_nodes": [pair.ppl[2]]},
                   {"as_of": 1.3e9}, {"as_of": CLOCK + 1}):
            want = j.search("g", q, top_k=5, rerank=rerank, **kw)
            same_up_to_ties(want, t.search("g", q, top_k=5, rerank=rerank, **kw),
                            key=lambda r: r["edge_id"])
        for kw in ({}, {"center_node": center}, {"bfs_origin_nodes": [pair.ppl[2]]}):
            want = j.search_nodes("g", q, top_k=4, rerank=rerank, **kw)
            same_up_to_ties(want, t.search_nodes("g", q, top_k=4, rerank=rerank, **kw),
                            key=lambda r: r["node_id"])


def test_episode_community_and_combined_search_match(pair):
    j, t = pair.j, pair.t
    for q in QUERIES:
        same_up_to_ties(j.search_episodes("g", q, top_k=3), t.search_episodes("g", q, top_k=3),
                        key=lambda r: r["episode_id"])
        same_up_to_ties(j.search_communities("g", q), t.search_communities("g", q),
                        key=lambda r: r["id"])
        for scopes in (None, ["edges", "episodes"], ["communities"]):
            want = j.search_combined("g", q, limit=3, scopes=scopes, rerank="mmr")
            got = t.search_combined("g", q, limit=3, scopes=scopes, rerank="mmr")
            assert sorted(got) == sorted(want)
            for scope in want:
                same_up_to_ties(want[scope], got[scope], key=lambda r: json.dumps(
                    {k: v for k, v in r.items() if k != "score"}, sort_keys=True))
    assert t.search("empty", "x") == j.search("empty", "x") == []
    assert t.search_nodes("empty", "x") == []


def test_restart_answers_as_the_reference(pair):
    """A fresh service over each database rebuilds its engine from sqlite
    (edges, then nodes, then episodes) and answers as the JAX package's
    fresh service.  In both packages the rebuilt engine's rows lie in
    another order than the live engine's, with other lexical statistics,
    so a restarted service need not answer as the live one did."""
    j, t = pair.j, pair.t
    jr = jsvc.KnowledgeGraphService(JDatabase(j.db.path), embed_dim=64,
                                    reranker=fake_reranker)
    tr = tsvc.KnowledgeGraphService(TDatabase(t.db.path), embed_dim=64,
                                    reranker=fake_reranker, device="cpu")
    for q in QUERIES:
        same_up_to_ties(jr.search("g", q, top_k=6), tr.search("g", q, top_k=6),
                        key=lambda r: r["edge_id"])
        same_up_to_ties(jr.search_nodes("g", q), tr.search_nodes("g", q),
                        key=lambda r: r["node_id"])
        same_up_to_ties(jr.search_episodes("g", q), tr.search_episodes("g", q),
                        key=lambda r: r["episode_id"])
    assert _tables(tr.db) == _tables(jr.db)
    assert tr.stats("g") == jr.stats("g") == t.stats("g")


def test_delete_episode_matches(pair):
    """Delete one episode in both: the same tables, its facts leave every
    search, and the searches agree; then a fresh service over each
    database, and ``delete_group``."""
    j, t = pair.j, pair.t
    eid = j.db.query("SELECT id FROM kg_episode ORDER BY rowid")[2]["id"]
    gone = {e["id"]: e["fact"] for e in j.db.query(
        "SELECT id, fact FROM kg_edge WHERE episode_id=?", (eid,))}
    assert gone
    j.delete_episode("g", eid)
    t.delete_episode("g", eid)
    assert _tables(t.db) == _tables(j.db)
    jr = jsvc.KnowledgeGraphService(JDatabase(j.db.path), embed_dim=64,
                                    reranker=fake_reranker)
    tr = tsvc.KnowledgeGraphService(TDatabase(t.db.path), embed_dim=64,
                                    reranker=fake_reranker, device="cpu")
    for q in QUERIES + list(gone.values())[:3]:
        live = t.search("g", q, top_k=6)
        assert not gone.keys() & {r["edge_id"] for r in live}
        assert eid not in {r["episode_id"] for r in t.search_episodes("g", q)}
        same_up_to_ties(j.search("g", q, top_k=6), live, key=lambda r: r["edge_id"])
        same_up_to_ties(jr.search("g", q, top_k=6), tr.search("g", q, top_k=6),
                        key=lambda r: r["edge_id"])
    assert tr.stats("g") == jr.stats("g") == t.stats("g")
    jr.delete_group("g")
    tr.delete_group("g")
    assert _tables(tr.db) == _tables(jr.db)
    assert tr.search("g", "acquired") == jr.search("g", "acquired") == []


@pytest.mark.parametrize("completion", [fake_completion, garbage_completion])
def test_llm_tier_in_the_service_matches(completion, monkeypatch, tmp_path):
    """The service with a completion client: LLM extraction, dedupe,
    edge resolution and batched summaries, in both packages alike."""
    _patch_clock_and_ids(monkeypatch)
    texts, org, _ = _episodes(11, 4, 6)
    j = jsvc.KnowledgeGraphService(JDatabase(str(tmp_path / "j.db")), completion=completion,
                                   embed_dim=64)
    t = tsvc.KnowledgeGraphService(TDatabase(str(tmp_path / "t.db")), completion=completion,
                                   embed_dim=64, device="cpu")
    for svc in (j, t):
        svc.add_episode("g", texts[0], source="a")
        svc.add_episode_bulk("g", texts[1:], source="b")
    assert _tables(t.db) == _tables(j.db)
    assert t.communities("g") == j.communities("g")
    for q in QUERIES[:3] + org[:2]:
        same_up_to_ties(j.search("g", q), t.search("g", q), key=lambda r: r["edge_id"])


def test_service_runs_on_the_named_device(pair):
    eng = pair.t._engine("g")
    assert eng.index.device.type == "cpu"
    assert eng.index.spec.dim == 64
    assert str(eng.index.spec.dtype) == "torch.bfloat16"
