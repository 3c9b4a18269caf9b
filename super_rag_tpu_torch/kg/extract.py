"""Entity/relation extraction for the knowledge graph (port of the JAX
package's kg/extract.py).

The reference's graphiti drives extraction through LLM prompts
(graphiti/prompts/, SURVEY.md 2.8).  Ours keeps that as the primary
extractor when a completion client is configured, with a deterministic
heuristic fallback (capitalized-span entities, verb-linked pairs within a
sentence) so KG indexing works fully offline — the same degradation
philosophy as the rest of the stack.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from typing import Callable, Optional

_SENT_SPLIT = re.compile(r"(?<=[.!?。！？])\s+")
# Capitalized span: 1-4 words, each starting uppercase (skips sentence
# starts handled below); also CJK runs of 2-6 chars.
_ENTITY = re.compile(
    r"\b([A-Z][A-Za-z0-9_-]+(?:\s+[A-Z][A-Za-z0-9_-]+){0,3})\b"
)
_VERB_HINT = re.compile(
    r"\b(is|are|was|were|has|have|uses|runs|builds|created|founded|owns|"
    r"supports|provides|implements|replaces|extends|contains|employs|"
    r"acquired|launched|develops|leads|wrote|invented)\b",
    re.IGNORECASE,
)

from super_rag_tpu_torch.llm.prompts import (
    KG_EXTRACTION as EXTRACTION_PROMPT,
    KG_EXTRACTION_FOCUSED,
    KG_REFLEXION,
)

# the graphiti-style fixed entity-type set (prompts/extract_nodes.py
# entity_types); anything else the model invents maps to Concept
ENTITY_TYPES = frozenset({
    "Person", "Organization", "Location", "Product", "Technology",
    "Event", "Concept",
})


@dataclass(frozen=True)
class EntityType:
    """One entity type of a deployment ontology.

    ``pattern`` is an optional regex cue for the OFFLINE heuristic
    extractor (the LLM path classifies from name + description alone —
    graphiti gets the same effect from the pydantic model docstrings it
    renders into prompts/extract_nodes.py)."""

    name: str
    description: str = ""
    pattern: Optional[str] = None


@dataclass(frozen=True)
class Ontology:
    """Per-collection custom entity ontology.

    Parity with graphiti's custom entity types: the reference passes a
    per-deployment dict of pydantic entity models into
    Graphiti.add_episode(entity_types=...) and the extraction prompts
    enumerate them (graphiti_core/prompts/extract_nodes.py).  Here the
    ontology comes from the per-collection config
    (CollectionConfig.kg_entity_types) and flows into both the LLM
    prompt and the offline heuristic."""

    entity_types: tuple[EntityType, ...]

    def prompt_types(self) -> str:
        return "\n".join(
            f"  {e.name}" + (f" — {e.description}" if e.description else "")
            for e in self.entity_types
        )

    def canonical(self, raw: object) -> str:
        v = str(raw or "").strip()
        for e in self.entity_types:
            if v.lower() == e.name.lower():
                return e.name
        return "Entity"

    def classify(self, span: str) -> Optional[str]:
        """Offline classification via the types' regex cues."""
        for e in self.entity_types:
            if e.pattern:
                try:
                    if re.search(e.pattern, span):
                        return e.name
                except re.error:
                    continue
        return None

    @staticmethod
    def from_config(cfg: object) -> "Ontology":
        """Build from CollectionConfig.kg_entity_types (list of dicts or
        bare names); empty/None -> the graphiti default set."""
        if not cfg or not isinstance(cfg, (list, tuple)):
            return DEFAULT_ONTOLOGY
        types: list[EntityType] = []
        for item in cfg:
            if isinstance(item, str) and item.strip():
                types.append(EntityType(name=item.strip()[:64]))
            elif isinstance(item, dict) and str(item.get("name", "")).strip():
                types.append(EntityType(
                    name=str(item["name"]).strip()[:64],
                    description=str(item.get("description", ""))[:300],
                    pattern=(str(item["pattern"])[:300]
                             if item.get("pattern") else None),
                ))
        return Ontology(tuple(types)) if types else DEFAULT_ONTOLOGY


DEFAULT_ONTOLOGY = Ontology(tuple(
    EntityType(name=n) for n in (
        "Person", "Organization", "Location", "Product", "Technology",
        "Event", "Concept",
    )
))


@dataclass
class Triple:
    source: str
    relation: str
    target: str
    fact: str
    source_type: str = "Entity"
    target_type: str = "Entity"
    valid_at: Optional[float] = None  # event time (epoch s), if stated


_ORG_SUFFIX = re.compile(
    r"\b(Inc|Corp|Corporation|Ltd|LLC|GmbH|Co|Company|University,?|"
    r"Institute|Labs?|Foundation|Group|Bank|Agency)\.?$"
)
_PERSON_PREFIX = re.compile(
    r"^(Mr|Mrs|Ms|Dr|Prof|Professor|President|CEO|Sir|Dame)\.?\s"
)
_LOCATION_HINT = re.compile(
    r"\b(City|County|Province|Republic|Kingdom|Island|Valley|Bay|"
    r"Mountains?)\b"
)
# event dates: ISO, "Month DD, YYYY", "in/since/on ... 1999"
_ISO_DATE = re.compile(r"\b(\d{4})-(\d{2})-(\d{2})\b")
_MONTH_DATE = re.compile(
    r"\b(January|February|March|April|May|June|July|August|September|"
    r"October|November|December)\s+(\d{1,2}),?\s+(\d{4})\b"
)
_YEAR_HINT = re.compile(r"\b(?:in|since|on|during|by)\s+((?:19|20)\d{2})\b")
_MONTHS = {m: i + 1 for i, m in enumerate(
    ["January", "February", "March", "April", "May", "June", "July",
     "August", "September", "October", "November", "December"])}


def _entity_type(span: str) -> str:
    """Cheap offline type cues; 'Entity' when nothing is clear."""
    if _PERSON_PREFIX.search(span):
        return "Person"
    if _ORG_SUFFIX.search(span):
        return "Organization"
    if _LOCATION_HINT.search(span):
        return "Location"
    return "Entity"


def _event_time(sent: str) -> Optional[float]:
    """Epoch seconds for the first stated event date in the sentence."""
    import calendar

    m = _ISO_DATE.search(sent)
    if m:
        y, mo, d = int(m.group(1)), int(m.group(2)), int(m.group(3))
    else:
        m2 = _MONTH_DATE.search(sent)
        if m2:
            y, mo, d = int(m2.group(3)), _MONTHS[m2.group(1)], int(m2.group(2))
        else:
            m3 = _YEAR_HINT.search(sent)
            if not m3:
                return None
            y, mo, d = int(m3.group(1)), 1, 1
    try:
        return float(calendar.timegm((y, mo, d, 0, 0, 0)))
    except (ValueError, OverflowError):
        return None


_PASSIVE_RE = re.compile(r"\b(?:was|were|is|are|has been|have been)\s+"
                         r"(\w+(?:ed|en|n))\s+by\b", re.IGNORECASE)


def heuristic_extract(text: str, max_triples: int = 50,
                      ontology: Optional[Ontology] = None) -> list[Triple]:
    """Offline extraction: entity pairs linked by the verb BETWEEN them.

    Two refinements over a bare adjacent-pair chain: the relation
    for a pair is the verb hint that lies between the two entity spans
    (not the sentence's first verb), and the passive form
    'B was founded by A' inverts to (A, founded, B)."""
    triples: list[Triple] = []
    for sent in _SENT_SPLIT.split(text):
        if len(sent) < 8:
            continue
        # ignore a capitalized sentence-start word unless multi-word
        ents = []
        for m in _ENTITY.finditer(sent):
            span = m.group(1)
            if m.start() == 0 and " " not in span:
                continue
            if span.lower() in ("the", "a", "an", "this", "that", "it"):
                continue
            ents.append((span, m.start(), m.end()))
        seen: set[str] = set()
        uniq = []
        for e in ents:
            if e[0] not in seen:
                seen.add(e[0])
                uniq.append(e)
        if len(uniq) < 2:
            continue
        verbs = [(v.start(), v.end(), v.group(1).lower())
                 for v in _VERB_HINT.finditer(sent)]
        for (a, _as, a_end), (b_, b_start, _be) in zip(uniq, uniq[1:]):
            between = sent[a_end:b_start]
            relation = next(
                (name for s, e, name in verbs if a_end <= s and e <= b_start),
                verbs[0][2] if verbs else "related_to",
            )
            src, dst = a, b_
            pm = _PASSIVE_RE.search(between)
            if pm:
                # 'B was founded by A' → (A, founded, B)
                src, dst = b_, a
                relation = pm.group(1).lower()
            triples.append(
                Triple(source=src, relation=relation, target=dst,
                       fact=sent.strip()[:500],
                       source_type=(ontology.classify(src)
                                    if ontology else None)
                       or _entity_type(src),
                       target_type=(ontology.classify(dst)
                                    if ontology else None)
                       or _entity_type(dst),
                       valid_at=_event_time(sent))
            )
            if len(triples) >= max_triples:
                return triples
    return triples


def _parse_triples(raw: str, limit: int,
                   ontology: Ontology = DEFAULT_ONTOLOGY) -> list[Triple]:
    m = re.search(r"\{.*\}", str(raw), re.S)
    if not m:
        return []
    try:
        data = json.loads(m.group(0))
    except json.JSONDecodeError:
        return []
    out = []
    for t in data.get("triples", [])[:limit]:
        if not isinstance(t, dict):
            continue
        if not all(t.get(k) for k in ("source", "target")):
            continue
        valid_at = None
        va = t.get("valid_at")
        if va and isinstance(va, str):
            valid_at = _event_time(va) or _event_time(f"in {va[:4]}")

        def typ(key: str) -> str:
            return ontology.canonical(t.get(key, ""))

        out.append(
            Triple(
                source=str(t["source"])[:200],
                relation=str(t.get("relation", "related_to"))[:100],
                target=str(t["target"])[:200],
                fact=str(t.get("fact", ""))[:500]
                or f"{t['source']} {t.get('relation', '')} {t['target']}",
                source_type=typ("source_type"),
                target_type=typ("target_type"),
                valid_at=valid_at,
            )
        )
    return out


def _parse_missed(raw: str) -> list[str]:
    m = re.search(r"\{.*\}", str(raw), re.S)
    if not m:
        return []
    try:
        data = json.loads(m.group(0))
    except json.JSONDecodeError:
        return []
    return [str(e)[:200] for e in data.get("missed", [])
            if isinstance(e, (str, int, float)) and str(e).strip()][:16]


def llm_extract(text: str, completion: Callable, max_triples: int = 50,
                reflexion: bool = True,
                ontology: Ontology = DEFAULT_ONTOLOGY) -> list[Triple]:
    """LLM extraction with one reflexion pass (graphiti
    prompts/extract_nodes.py: extract -> 'which entities did you miss?'
    -> focused re-extraction over the missed entities)."""
    snippet = text[:6000]
    triples = _parse_triples(
        completion(prompt=EXTRACTION_PROMPT.format(
            text=snippet, types=ontology.prompt_types())),
        max_triples, ontology,
    )
    if reflexion and triples:
        found = sorted({t.source for t in triples}
                       | {t.target for t in triples})
        missed = _parse_missed(completion(prompt=KG_REFLEXION.format(
            entities=", ".join(found), text=snippet)))
        missed = [e for e in missed
                  if e.lower() not in {f.lower() for f in found}]
        if missed:
            extra = _parse_triples(
                completion(prompt=KG_EXTRACTION_FOCUSED.format(
                    entities=", ".join(missed), text=snippet,
                    types=ontology.prompt_types())),
                max_triples, ontology,
            )
            seen = {(t.source.lower(), t.relation.lower(), t.target.lower())
                    for t in triples}
            for t in extra:
                key = (t.source.lower(), t.relation.lower(),
                       t.target.lower())
                if key not in seen and len(triples) < max_triples:
                    seen.add(key)
                    triples.append(t)
    return triples


def extract(text: str, completion: Optional[Callable] = None,
            max_triples: int = 50,
            ontology: Optional[Ontology] = None) -> list[Triple]:
    onto = ontology or DEFAULT_ONTOLOGY
    if completion is not None:
        try:
            triples = llm_extract(text, completion, max_triples,
                                  ontology=onto)
            if triples:
                return triples
        except Exception:  # noqa: BLE001 — fall back to the heuristic
            pass
    return heuristic_extract(text, max_triples, ontology=ontology)
