"""Knowledge-graph construction: node dedupe, edge resolution, summaries
(port of the JAX package's kg/construct.py).

Ports the SEMANTICS of graphiti's construction/maintenance machinery
(reference graphiti_core/prompts/dedupe_nodes.py:1, dedupe_edges.py:1,
summarize_nodes.py:1, utils/maintenance/node_operations.py:384
resolve_extracted_nodes, edge_operations.py:411
resolve_edge_contradictions, community_operations.py:92
label_propagation) with the repo's two-tier design: an LLM tier when a
completion client is configured, and a deterministic offline tier
(string/acronym similarity, functional-relation contradiction) so KG
construction still improves graphs with zero egress.

Every function here is host-side and KG-scale small — the device engine
is only used upstream to retrieve candidate nodes/edges.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from super_rag_tpu_torch.llm.prompts import (
    KG_COMBINE_SUMMARIES,
    KG_DEDUPE_NODE,
    KG_RESOLVE_EDGE,
    KG_SUMMARIZE_NODE,
)

# Relations where a subject has (at most) one object at a time: a new
# target contradicts the old one even without an LLM.  Mirrors the
# invalidation the reference's resolve_edge prompt performs; kept small
# and conservative — non-functional relations never auto-invalidate.
FUNCTIONAL_RELATIONS = frozenset({
    "is", "leads", "heads", "manages", "ceo_of", "located_in", "based_in",
    "married_to", "owns", "reports_to", "works_at", "employed_by",
    "capital_of", "headquartered_in", "president_of", "chairs",
})


def norm_name(name: str) -> str:
    return " ".join(name.lower().split())


_WORD = re.compile(r"[A-Za-z0-9]+")


def trigram_similarity(a: str, b: str) -> float:
    """Char-trigram Jaccard over normalized names — the offline stand-in
    for the LLM duplicate judgment (catches case/punctuation/inflection
    variants without merging genuinely distinct names)."""
    a, b = norm_name(a), norm_name(b)
    if a == b:
        return 1.0
    ta = {a[i : i + 3] for i in range(max(1, len(a) - 2))}
    tb = {b[i : i + 3] for i in range(max(1, len(b) - 2))}
    inter = len(ta & tb)
    union = len(ta | tb) or 1
    return inter / union


def is_acronym(short: str, long: str) -> bool:
    """True when ``short`` is the initialism of ``long`` (GPU ~ Graphics
    Processing Unit)."""
    s = norm_name(short).replace(".", "")
    words = _WORD.findall(norm_name(long))
    if len(words) < 2 or len(s) != len(words):
        return False
    return all(w[0] == c for w, c in zip(words, s))


def _parse_json(raw: str) -> Optional[dict]:
    m = re.search(r"\{.*\}", str(raw), re.S)
    if not m:
        return None
    try:
        return json.loads(m.group(0))
    except json.JSONDecodeError:
        return None


def resolve_node(
    name: str,
    candidates: Sequence[dict],
    completion: Optional[Callable] = None,
    context: str = "",
    sim_threshold: float = 0.78,
) -> Optional[str]:
    """Return the name of the existing entity ``name`` duplicates, or
    None if it is genuinely new.

    ``candidates``: dicts with at least ``name`` (and optionally
    ``summary``) — the caller retrieves them by embedding similarity
    over the group's node rows plus cheap host-side screens.  Two tiers:
    the offline screen accepts only high-confidence string matches
    (trigram / acronym); the LLM tier judges semantic identity the way
    the reference's dedupe_nodes prompt does."""
    if not candidates:
        return None
    # offline tier: high-precision string evidence
    best, best_sim = None, 0.0
    for c in candidates:
        cn = c["name"]
        if norm_name(cn) == norm_name(name):
            return cn
        sim = trigram_similarity(name, cn)
        if sim > best_sim:
            best, best_sim = cn, sim
        if is_acronym(name, cn) or is_acronym(cn, name):
            return cn
    if best is not None and best_sim >= sim_threshold:
        return best
    if completion is None:
        return None
    # LLM tier: semantic identity (descriptive label ~ named entity)
    lines = "\n".join(
        f"- {c['name']}" + (f": {c['summary']}" if c.get("summary") else "")
        for c in candidates[:10]
    )
    try:
        raw = completion(prompt=KG_DEDUPE_NODE.format(
            name=name, context=context[:1000] or "(none)", candidates=lines
        ))
    except Exception:  # noqa: BLE001 — offline verdict stands
        return None
    data = _parse_json(raw)
    if not data:
        return None
    dup = str(data.get("duplicate_name", "")).strip()
    if not dup:
        return None
    wanted = {norm_name(c["name"]): c["name"] for c in candidates}
    return wanted.get(norm_name(dup))


@dataclass
class EdgeResolution:
    """Indices into the candidate list (see :func:`resolve_edge`)."""

    duplicates: list[int] = field(default_factory=list)
    contradictions: list[int] = field(default_factory=list)


def resolve_edge(
    fact: str,
    relation: str,
    same_pair_same_rel: Sequence[tuple[int, str]],
    same_source_same_rel: Sequence[tuple[int, str]],
    completion: Optional[Callable] = None,
) -> EdgeResolution:
    """Decide which existing facts the new one duplicates/contradicts.

    ``same_pair_same_rel``: (idx, fact) of valid edges with the same
    (source, relation, target) — duplicate candidates that are also
    contradiction candidates (the temporal-update case).
    ``same_source_same_rel``: (idx, fact) of valid edges from the same
    source with the same relation but a DIFFERENT target — invalidation
    candidates for functional relations.

    Offline tier: an identical normalized fact is a duplicate (re-adding
    an episode is idempotent); a same-key edge with a different fact is
    contradicted (superseded); a different-target edge is contradicted
    only when the relation is functional.  The LLM tier refines both
    judgments like the reference's resolve_edge prompt."""
    res = EdgeResolution()
    fn = " ".join(fact.lower().split())
    for idx, f in same_pair_same_rel:
        if " ".join(f.lower().split()) == fn:
            res.duplicates.append(idx)
        else:
            res.contradictions.append(idx)
    if relation.lower() in FUNCTIONAL_RELATIONS:
        res.contradictions.extend(idx for idx, _ in same_source_same_rel)
    if completion is None or not (same_pair_same_rel or same_source_same_rel):
        return res
    existing = list(same_pair_same_rel) + list(same_source_same_rel)
    lines = "\n".join(f"{idx}. {f}" for idx, f in existing)
    try:
        raw = completion(prompt=KG_RESOLVE_EDGE.format(
            fact=fact, existing=lines
        ))
    except Exception:  # noqa: BLE001 — offline verdict stands
        return res
    data = _parse_json(raw)
    if not data:
        return res
    valid = {idx for idx, _ in existing}
    dups = [int(i) for i in data.get("duplicates", [])
            if isinstance(i, (int, float)) and int(i) in valid]
    cons = [int(i) for i in data.get("contradictions", [])
            if isinstance(i, (int, float)) and int(i) in valid]
    # LLM verdict REPLACES the heuristic (it saw the actual fact texts);
    # keep the exact-text duplicate — that one is certain.  duplicates
    # and contradictions may OVERLAP: the prompt invites 'duplicate AND
    # contradicted' for restate-and-update facts, and the caller treats
    # that as supersede-then-insert, not skip.
    exact_dups = [i for i in res.duplicates
                  if any(idx == i for idx, f in same_pair_same_rel
                         if " ".join(f.lower().split()) == fn)]
    res.duplicates = sorted(set(dups) | set(exact_dups))
    res.contradictions = sorted(set(cons))
    return res


def summarize_node(
    name: str,
    facts: Sequence[str],
    completion: Optional[Callable] = None,
    max_chars: int = 250,
) -> str:
    """Entity summary from its facts (reference summarize_nodes.py
    summarize_context; offline tier joins the most recent facts)."""
    if not facts:
        return ""
    if completion is not None:
        try:
            raw = str(completion(prompt=KG_SUMMARIZE_NODE.format(
                name=name, facts="\n".join(f"- {f}" for f in facts[:12])
            ))).strip()
            if raw:
                return raw[:max_chars]
        except Exception:  # noqa: BLE001
            pass
    out = "; ".join(dict.fromkeys(f.strip().rstrip(".") for f in facts))
    return out[:max_chars]


def summarize_nodes_batch(
    entities: Sequence[tuple[str, Sequence[str]]],
    completion: Optional[Callable] = None,
    max_chars: int = 250,
) -> dict[str, str]:
    """Summaries for many entities in ONE completion call (reference
    node_operations.py:539 _extract_entity_summaries_batch — per-node
    calls in the ingest path cost a network round-trip per entity).
    Offline tier / parse failures fall back to the deterministic
    per-node join."""
    out: dict[str, str] = {}
    if completion is not None and entities:
        from super_rag_tpu_torch.llm.prompts import KG_SUMMARIZE_NODES_BATCH

        blocks = []
        for name, facts in entities[:32]:
            lines = "\n".join(f"- {f}" for f in list(facts)[:12])
            blocks.append(f"Entity: {name}\nFacts:\n{lines}")
        try:
            raw = completion(prompt=KG_SUMMARIZE_NODES_BATCH.format(
                entities="\n\n".join(blocks)
            ))
            data = _parse_json(raw) or {}
            for k, v in (data.get("summaries") or {}).items():
                if isinstance(v, str) and v.strip():
                    out[str(k)] = v.strip()[:max_chars]
        except Exception:  # noqa: BLE001 — offline tier below
            pass
    for name, facts in entities:
        if name not in out:
            out[name] = summarize_node(name, list(facts), None,
                                       max_chars=max_chars)
    return out


def combine_summaries(a: str, b: str,
                      completion: Optional[Callable] = None,
                      max_chars: int = 250) -> str:
    """Pairwise summary synthesis (reference summarize_pair) — the
    reduce step of community summarization."""
    if not a:
        return b[:max_chars]
    if not b:
        return a[:max_chars]
    if completion is not None:
        try:
            raw = str(completion(prompt=KG_COMBINE_SUMMARIES.format(
                a=a, b=b
            ))).strip()
            if raw:
                return raw[:max_chars]
        except Exception:  # noqa: BLE001
            pass
    # offline reduce: dedupe clauses — two nodes on the same edge carry
    # the same fact in both summaries, and a naive join repeats it
    seen: set[str] = set()
    parts: list[str] = []
    for clause in (a + "; " + b).split("; "):
        key = " ".join(clause.lower().split()).rstrip(".")
        if key and key not in seen:
            seen.add(key)
            parts.append(clause)
    return "; ".join(parts)[:max_chars]


def label_propagation(
    adj: dict[str, set[str]], max_iters: int = 100
) -> list[list[str]]:
    """Community detection: label propagation with the reference's core
    rule (community_operations.py:92 — a plurality needs MORE THAN ONE
    edge of support to move a node, so a single bridge edge cannot drag
    a node across clusters) made order-robust, since the reference's
    max(candidate, current) drift merges bridged cliques under unlucky
    id orderings.  Three deterministic phases:

    1. triangle contraction: endpoints of an edge that share a common
       neighbor start in the same community (dense cores pre-agree);
    2. synchronous propagation: adopt the plurality neighbor label only
       with >=2 edges of support AND strictly more than the current
       label's support;
    3. singleton attachment: nodes still alone join the neighboring
       community with the most edges (sparse graphs — chains, stars —
       degrade to components like the previous union-find instead of
       dissolving into singletons)."""
    order = sorted(adj)
    # phase 1: contract triangles
    parent = {n: n for n in order}

    def find(x: str) -> str:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for n in order:
        for m in adj[n]:
            if m > n and adj[n] & adj[m]:  # edge in a triangle
                parent[find(n)] = find(m)
    labels = {n: find(n) for n in order}

    # phase 2: plurality >= 2 propagation
    for _ in range(max_iters):
        new_labels: dict[str, str] = {}
        changed = False
        for n in order:
            counts: dict[str, int] = {}
            for m in adj[n]:
                lbl = labels[m]
                counts[lbl] = counts.get(lbl, 0) + 1
            cur = labels[n]
            new = cur
            if counts:
                best = min(counts, key=lambda lbl: (-counts[lbl], lbl))
                if counts[best] >= 2 and counts[best] > counts.get(cur, 0):
                    new = best
            new_labels[n] = new
            changed |= new != cur
        labels = new_labels
        if not changed:
            break

    # phase 3: attach singletons to their strongest neighboring community
    sizes: dict[str, int] = {}
    for lbl in labels.values():
        sizes[lbl] = sizes.get(lbl, 0) + 1
    for _ in range(max_iters):
        moved = False
        for n in order:
            if sizes[labels[n]] != 1:
                continue
            counts = {}
            for m in adj[n]:
                lbl = labels[m]
                if lbl != labels[n]:
                    counts[lbl] = counts.get(lbl, 0) + 1
            if not counts:
                continue
            best = min(counts,
                       key=lambda lbl: (-counts[lbl], -sizes[lbl], lbl))
            sizes[labels[n]] -= 1
            sizes[best] = sizes.get(best, 0) + 1
            labels[n] = best
            moved = True
        if not moved:
            break

    groups: dict[str, list[str]] = {}
    for n, lbl in labels.items():
        groups.setdefault(lbl, []).append(n)
    return sorted((sorted(g) for g in groups.values()),
                  key=lambda g: (-len(g), g[0]))
