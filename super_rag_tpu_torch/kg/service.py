"""In-process temporal knowledge graph with device-backed fact search
(port of the JAX package's kg/service.py).

Episodes are ingested into (node, edge) tables in sqlite with temporal
validity; hybrid fact search runs on the same device engine as document
retrieval (dense + BM25 + RRF over edge facts), in one
``CollectionEngine`` per group (collection).  Nodes and episode previews
live in the same per-group engine as edge facts, tagged by indexer code,
so every scope is one hybrid search with a mask: on the card, the
masked ``dense_topk`` kernel.

Capabilities mirrored from graphiti: add_episode (extract -> upsert
nodes/edges, invalidate superseded duplicates), hybrid search with
center-node distance boost, label listing, subgraph extraction for viz,
group scoping by collection, delete by episode/group; edge, node,
episode and community searches with the rrf | mmr | cross_encoder |
node_distance rerankers, BFS hop expansion from origin nodes, and
point-in-time queries (``as_of``) over the bi-temporal
valid_at/invalid_at model.

The group engines are not snapshotted: a fresh service rebuilds each
one from sqlite at its first use (``_engine``).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from super_rag_tpu_torch.device import DeviceLike, resolve_device
from super_rag_tpu_torch.engine.collection import CollectionEngine, SearchHit
from super_rag_tpu_torch.engine.index import IndexSpec
from super_rag_tpu_torch.kg.construct import (
    combine_summaries,
    label_propagation,
    resolve_edge,
    resolve_node,
    summarize_nodes_batch,
    trigram_similarity,
)
from super_rag_tpu_torch.kg.extract import Ontology, Triple, extract
from super_rag_tpu_torch.store.db import Database, new_id

_KG_SCHEMA = """
CREATE TABLE IF NOT EXISTS kg_node (
  id TEXT PRIMARY KEY, group_id TEXT NOT NULL, name TEXT NOT NULL,
  name_norm TEXT NOT NULL, label TEXT DEFAULT 'Entity', created REAL NOT NULL,
  UNIQUE(group_id, name_norm)
);
CREATE TABLE IF NOT EXISTS kg_edge (
  id TEXT PRIMARY KEY, group_id TEXT NOT NULL,
  source_id TEXT NOT NULL, target_id TEXT NOT NULL,
  relation TEXT NOT NULL, fact TEXT NOT NULL,
  episode_id TEXT DEFAULT '', row_id INTEGER DEFAULT -1,
  valid_at REAL NOT NULL, invalid_at REAL DEFAULT NULL,
  created REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_kg_edge_group ON kg_edge(group_id);
CREATE TABLE IF NOT EXISTS kg_episode (
  id TEXT PRIMARY KEY, group_id TEXT NOT NULL, source TEXT DEFAULT '',
  content_preview TEXT DEFAULT '', created REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS kg_node_alias (
  group_id TEXT NOT NULL, norm TEXT NOT NULL, node_id TEXT NOT NULL,
  UNIQUE(group_id, norm)
);
"""


# indexer tags scoping rows within the per-group engine: edge facts are
# 'vector' rows, entity nodes 'graph' rows, episode previews 'summary'
# rows — one device index, scope = a filter mask (engine/index.FilterSpec)
_SCOPE_FACT = ["vector"]
_SCOPE_NODE = ["graph"]
_SCOPE_EPISODE = ["summary"]


def _host(x) -> np.ndarray:
    """f32 numpy of an embedder's or reranker's output (a tensor on the
    card, or an array)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


class KnowledgeGraphService:
    def __init__(self, db: Database, completion: Optional[Callable] = None,
                 embed_dim: int = 128,
                 reranker: Optional[Callable] = None,
                 device: DeviceLike = None):
        self.db = db
        self.device = resolve_device(device)
        self.completion = completion
        self.embed_dim = embed_dim
        self.reranker = reranker  # (query, texts) -> scores, for the
        # cross_encoder reranker recipe (graphiti passes its CE client)
        with db._lock:
            db._conn.executescript(_KG_SCHEMA)
        for ddl in (  # columns later than the tables (existing DBs)
            "ALTER TABLE kg_node ADD COLUMN row_id INTEGER DEFAULT -1",
            "ALTER TABLE kg_episode ADD COLUMN row_id INTEGER DEFAULT -1",
            # graphiti-style node summaries (construction depth)
            "ALTER TABLE kg_node ADD COLUMN summary TEXT DEFAULT ''",
        ):
            try:
                db.execute(ddl)
            except Exception:  # noqa: BLE001 — column already exists
                pass
        self._engines: dict[str, CollectionEngine] = {}

    # -- fact index (device) ----------------------------------------------------

    def _engine(self, group_id: str) -> CollectionEngine:
        eng = self._engines.get(group_id)
        if eng is None:
            eng = CollectionEngine(
                IndexSpec(dim=self.embed_dim, vocab_size=1 << 14),
                device=self.device,
            )
            self._engines[group_id] = eng
            # hydrate from persisted rows (restart path).  ALL edges are
            # indexed — including invalidated ones — so point-in-time
            # (as_of) queries can still retrieve superseded facts; live
            # searches exclude them by validity filtering.
            rows = self.db.query(
                "SELECT id, fact FROM kg_edge WHERE group_id=?"
                " ORDER BY created",
                (group_id,),
            )
            if rows:
                ids = eng.ingest([r["fact"] for r in rows],
                                 metadata=[{"edge_id": r["id"]} for r in rows])
                for r, row_id in zip(rows, ids):
                    self.db.execute(
                        "UPDATE kg_edge SET row_id=? WHERE id=?",
                        (row_id, r["id"]),
                    )
            nodes = self.db.query(
                "SELECT id, name, label FROM kg_node WHERE group_id=?"
                " ORDER BY created",
                (group_id,),
            )
            if nodes:
                ids = eng.ingest(
                    [f"{r['name']} ({r['label']})" for r in nodes],
                    metadata=[{"node_id": r["id"]} for r in nodes],
                    indexer="graph",
                )
                for r, row_id in zip(nodes, ids):
                    self.db.execute(
                        "UPDATE kg_node SET row_id=? WHERE id=?",
                        (row_id, r["id"]),
                    )
            eps = self.db.query(
                "SELECT id, content_preview FROM kg_episode WHERE group_id=?"
                " AND content_preview != '' ORDER BY created",
                (group_id,),
            )
            if eps:
                ids = eng.ingest(
                    [r["content_preview"] for r in eps],
                    metadata=[{"episode_id": r["id"]} for r in eps],
                    indexer="summary",
                )
                for r, row_id in zip(eps, ids):
                    self.db.execute(
                        "UPDATE kg_episode SET row_id=? WHERE id=?",
                        (row_id, r["id"]),
                    )
        return eng

    # -- node/edge upserts ----------------------------------------------------------

    def _node_candidates(self, group_id: str, name: str,
                         limit: int = 8) -> list[dict]:
        """Dedupe candidates for a new entity name: the group's most
        string-similar node names (host trigram screen) plus the
        embedding-nearest node rows from the device engine (the
        reference gathers candidates the same two ways —
        node_operations.py:195 _collect_candidate_nodes)."""
        rows = self.db.query(
            "SELECT id, name, label, summary, row_id FROM kg_node"
            " WHERE group_id=?",
            (group_id,),
        )
        if not rows:
            return []
        sims = sorted(((trigram_similarity(name, r["name"]), r)
                       for r in rows), key=lambda sr: -sr[0])
        cands = {r["id"]: r for s, r in sims[:limit] if s > 0.2}
        eng = self._engines.get(group_id)
        if eng is not None and eng.index.size:
            by_id = {r["id"]: r for r in rows}
            for h in eng.search(name, top_k=limit, mode="hybrid",
                                index_types=_SCOPE_NODE):
                nid = h.metadata.get("node_id")
                if nid and nid in by_id:
                    cands.setdefault(nid, by_id[nid])
        return list(cands.values())

    def _upsert_node(self, group_id: str, name: str,
                     label: str = "Entity",
                     context: str = "") -> str:
        norm = " ".join(name.lower().split())
        row = self.db.query_one(
            "SELECT id, label FROM kg_node WHERE group_id=? AND name_norm=?",
            (group_id, norm),
        )
        if row:
            # a typed extraction upgrades an untyped node (never the
            # reverse: 'Entity' is the absence of a type, not a type)
            if label != "Entity" and row.get("label") in ("Entity", "", None):
                self.db.execute("UPDATE kg_node SET label=? WHERE id=?",
                                (label, row["id"]))
            return row["id"]
        alias = self.db.query_one(
            "SELECT node_id FROM kg_node_alias WHERE group_id=? AND norm=?",
            (group_id, norm),
        )
        if alias:
            return alias["node_id"]
        # graphiti-style resolution before creating a node: offline
        # string/acronym tier always, LLM tier when a client exists
        cands = self._node_candidates(group_id, name)
        dup = resolve_node(name, cands, self.completion, context=context)
        if dup is not None:
            match = next(c for c in cands if c["name"] == dup)
            # the new surface form becomes an ALIAS of the canonical node
            # (both norms keep resolving — the merged entity must stay
            # idempotent under either name)
            self.db.execute(
                "INSERT OR IGNORE INTO kg_node_alias (group_id,norm,node_id)"
                " VALUES (?,?,?)",
                (group_id, norm, match["id"]),
            )
            # keep the most complete display name (reference
            # dedupe_nodes: 'most complete and descriptive name') and
            # refresh the device node row so embedding candidates see it
            if len(name) > len(match["name"]) and not name.isupper():
                eng = self._engine(group_id)
                old_row = match.get("row_id")
                if old_row is not None and old_row >= 0:
                    eng.delete([old_row])
                new_row = eng.ingest(
                    [f"{name} ({match.get('label', 'Entity')})"],
                    metadata=[{"node_id": match["id"]}], indexer="graph",
                )[0]
                self.db.execute(
                    "UPDATE kg_node SET name=?, row_id=? WHERE id=?",
                    (name, new_row, match["id"]),
                )
            return match["id"]
        nid = new_id("kgn")
        # node-centric search rows (graphiti node_search parity): the
        # node joins the group engine as a 'graph'-tagged row
        row_id = self._engine(group_id).ingest(
            [f"{name} ({label})"], metadata=[{"node_id": nid}],
            indexer="graph",
        )[0]
        self.db.execute(
            "INSERT INTO kg_node (id,group_id,name,name_norm,label,created,"
            "row_id) VALUES (?,?,?,?,?,?,?)",
            (nid, group_id, name, norm, label, time.time(), row_id),
        )
        return nid

    def _insert_episode(self, eng: CollectionEngine, group_id: str,
                        text: str, source: str, now: float) -> str:
        eid = new_id("kge")
        preview = text[:300]
        row_id = -1
        if preview:
            row_id = eng.ingest([preview], metadata=[{"episode_id": eid}],
                                indexer="summary")[0]
        self.db.execute(
            "INSERT INTO kg_episode (id,group_id,source,content_preview,"
            "created,row_id) VALUES (?,?,?,?,?,?)",
            (eid, group_id, source, preview, now, row_id),
        )
        return eid

    def add_episode(self, group_id: str, text: str, source: str = "",
                    triples: Optional[list[Triple]] = None,
                    ontology: Optional[Ontology] = None) -> dict:
        """Extract triples and upsert them (graphiti add_episode analog).

        A new edge with the same (source, relation, target) invalidates
        the previous one (temporal supersedence).  Superseded facts KEEP
        their device rows: `invalid_at` is recorded, live searches filter
        them out, and point-in-time queries (``as_of``) can still reach
        them — graphiti's bi-temporal model."""
        eng = self._engine(group_id)
        now = time.time()
        eid = self._insert_episode(eng, group_id, text, source, now)
        triples = triples if triples is not None else extract(
            text, self.completion, ontology=ontology
        )
        added = []
        touched: set[str] = set()
        for t in triples:
            sid = self._upsert_node(group_id, t.source,
                                    label=t.source_type, context=text)
            tid = self._upsert_node(group_id, t.target,
                                    label=t.target_type, context=text)
            edge_id = self._resolve_and_insert_edge(
                eng, group_id, sid, tid, t, eid, now
            )
            if edge_id is not None:
                added.append(edge_id)
                touched.update((sid, tid))
        self._refresh_node_summaries(group_id, touched)
        return {"episode_id": eid, "edges": added, "triples": len(added)}

    def _resolve_and_insert_edge(self, eng: CollectionEngine, group_id: str,
                                 sid: str, tid: str, t: Triple,
                                 eid: str, now: float) -> Optional[str]:
        """Edge resolution before insert (reference edge_operations.py:449
        resolve_extracted_edge): an exact duplicate of a live fact is
        dropped (re-indexing an episode is idempotent), contradicted
        facts get ``invalid_at`` stamped — including different-target
        edges of functional relations and whatever the LLM tier flags —
        and only then does the new fact join the device index."""
        pair = self.db.query(
            "SELECT id, fact, valid_at FROM kg_edge WHERE group_id=?"
            " AND source_id=? AND target_id=? AND relation=?"
            " AND invalid_at IS NULL",
            (group_id, sid, tid, t.relation),
        )
        other = self.db.query(
            "SELECT id, fact, valid_at FROM kg_edge WHERE group_id=?"
            " AND source_id=? AND relation=? AND target_id!=?"
            " AND invalid_at IS NULL",
            (group_id, sid, t.relation, tid),
        )
        cand = [(i, r["fact"]) for i, r in enumerate(pair)]
        cand_other = [(len(pair) + i, r["fact"]) for i, r in enumerate(other)]
        by_idx = {i: r for i, r in enumerate(pair)}
        by_idx.update({len(pair) + i: r for i, r in enumerate(other)})
        res = resolve_edge(t.fact, t.relation, cand, cand_other,
                           self.completion)
        # bi-temporal: valid_at is EVENT time when the text states one
        # ("founded in 2019"), transaction time otherwise; created is
        # always transaction time (graphiti extract_edge_dates semantics)
        valid_at = t.valid_at if getattr(t, "valid_at", None) else now
        # EVENT-TIME contradiction order (graphiti edge_operations
        # resolve_edge_contradictions): only facts whose event time is
        # <= the new fact's are superseded BY it; a contradicting fact
        # with a LATER event time instead pre-invalidates the new one —
        # out-of-order ingestion must not resurrect stale facts.
        new_invalid: Optional[float] = None
        for idx in res.contradictions:
            old = by_idx[idx]
            if old["valid_at"] <= valid_at:
                self.db.execute(
                    "UPDATE kg_edge SET invalid_at=? WHERE id=?",
                    (max(valid_at, old["valid_at"]), old["id"]),
                )
            else:
                new_invalid = (old["valid_at"] if new_invalid is None
                               else min(new_invalid, old["valid_at"]))
        # a PURE duplicate (not also contradicted) means the live graph
        # already states this fact — skip the insert (idempotent
        # re-index).  A fact that is duplicate AND contradicted is a
        # restate-and-update (the prompt's own case): the old edge was
        # just superseded, so the new one must land.
        if set(res.duplicates) - set(res.contradictions):
            return None
        edge_id = new_id("kged")
        rows = eng.ingest([t.fact], metadata=[{"edge_id": edge_id}])
        self.db.execute(
            "INSERT INTO kg_edge (id,group_id,source_id,target_id,relation,"
            "fact,episode_id,row_id,valid_at,invalid_at,created)"
            " VALUES (?,?,?,?,?,?,?,?,?,?,?)",
            (edge_id, group_id, sid, tid, t.relation, t.fact, eid,
             rows[0], valid_at, new_invalid, now),
        )
        return edge_id

    def _refresh_node_summaries(self, group_id: str,
                                node_ids: set[str]) -> None:
        """Regenerate entity summaries from live facts — all touched
        nodes in ONE completion call (reference node_operations.py:539
        _extract_entity_summaries_batch; per-node calls would cost a
        network round-trip per entity in the ingest path)."""
        entities: list[tuple[str, list[str]]] = []
        nid_by_name: dict[str, str] = {}
        for nid in node_ids:
            n = self.db.query_one(
                "SELECT name FROM kg_node WHERE id=?", (nid,)
            )
            if n is None:
                continue
            facts = [r["fact"] for r in self.db.query(
                "SELECT fact FROM kg_edge WHERE group_id=? AND invalid_at"
                " IS NULL AND (source_id=? OR target_id=?)"
                " ORDER BY valid_at DESC LIMIT 12",
                (group_id, nid, nid),
            )]
            entities.append((n["name"], facts))
            nid_by_name[n["name"]] = nid
        if not entities:
            return
        summaries = summarize_nodes_batch(entities, self.completion)
        for name, summary in summaries.items():
            nid = nid_by_name.get(name)
            if nid:
                self.db.execute(
                    "UPDATE kg_node SET summary=? WHERE id=?",
                    (summary, nid),
                )

    def add_episode_bulk(self, group_id: str, texts: list[str],
                         source: str = "",
                         ontology: Optional[Ontology] = None) -> dict:
        """Batch episode ingestion (graphiti add_episode_bulk analog,
        graphiti_core/graphiti.py:1023): extract across all chunks first,
        dedup nodes once for the whole batch, then insert every fact with
        ONE batched device write instead of per-triple ingests."""
        eng = self._engine(group_id)
        now = time.time()
        episode_ids = []
        all_triples: list[tuple[str, Triple]] = []
        for text in texts:
            eid = self._insert_episode(eng, group_id, text, source, now)
            episode_ids.append(eid)
            for t in extract(text, self.completion, ontology=ontology):
                all_triples.append((eid, t))

        # one-pass node dedup across the whole batch; an entity keeps the
        # first TYPED label any of its triples assigned (the single-
        # episode path upgrades Entity->typed the same way)
        best_type: dict[str, str] = {}
        for _eid, t in all_triples:
            for name, typ in ((t.source, t.source_type),
                              (t.target, t.target_type)):
                norm = " ".join(name.lower().split())
                if typ != "Entity" and best_type.get(norm, "Entity") == "Entity":
                    best_type[norm] = typ
        node_ids: dict[str, str] = {}
        for _eid, t in all_triples:
            for name in (t.source, t.target):
                norm = " ".join(name.lower().split())
                if norm not in node_ids:
                    node_ids[norm] = self._upsert_node(
                        group_id, name,
                        label=best_type.get(norm, "Entity"),
                    )

        # within-batch + vs-store supersedence, newest wins
        seen_keys: dict[tuple, int] = {}
        kept: list[tuple[str, Triple]] = []
        for eid, t in all_triples:
            key = (" ".join(t.source.lower().split()), t.relation,
                   " ".join(t.target.lower().split()))
            if key in seen_keys:
                kept[seen_keys[key]] = (eid, t)  # later chunk supersedes
            else:
                seen_keys[key] = len(kept)
                kept.append((eid, t))
        # per-edge resolution against the store AND the batch edges kept
        # so far (post node-dedupe keys can collide even after the
        # text-norm pre-pass above) — a later batch fact supersedes an
        # earlier one exactly like a later episode would
        edge_rows: list = []  # (edge_id, sid, tid, Triple, eid, valid_at, invalid_at) | None
        touched: set[str] = set()
        for eid, t in kept:
            sid = node_ids[" ".join(t.source.lower().split())]
            tid = node_ids[" ".join(t.target.lower().split())]
            pair = self.db.query(
                "SELECT id, fact, valid_at FROM kg_edge WHERE group_id=?"
                " AND source_id=? AND target_id=? AND relation=? AND"
                " invalid_at IS NULL",
                (group_id, sid, tid, t.relation),
            )
            other = self.db.query(
                "SELECT id, fact, valid_at FROM kg_edge WHERE group_id=?"
                " AND source_id=? AND relation=? AND target_id!=? AND"
                " invalid_at IS NULL",
                (group_id, sid, t.relation, tid),
            )
            b_pair = [j for j, e in enumerate(edge_rows)
                      if e is not None and e[1] == sid and e[2] == tid
                      and e[3].relation == t.relation]
            b_other = [j for j, e in enumerate(edge_rows)
                       if e is not None and e[1] == sid and e[2] != tid
                       and e[3].relation == t.relation]
            src: dict[int, tuple] = {}
            cand, cand_other = [], []
            for r in pair:
                src[len(src)] = ("db", r["id"], r["valid_at"])
                cand.append((len(src) - 1, r["fact"]))
            for j in b_pair:
                src[len(src)] = ("batch", j, edge_rows[j][5])
                cand.append((len(src) - 1, edge_rows[j][3].fact))
            for r in other:
                src[len(src)] = ("db", r["id"], r["valid_at"])
                cand_other.append((len(src) - 1, r["fact"]))
            for j in b_other:
                src[len(src)] = ("batch", j, edge_rows[j][5])
                cand_other.append((len(src) - 1, edge_rows[j][3].fact))
            res = resolve_edge(t.fact, t.relation, cand, cand_other,
                               self.completion)
            new_valid = t.valid_at if getattr(t, "valid_at", None) else now
            new_invalid = None
            for idx in res.contradictions:
                kind, ref, old_valid = src[idx]
                if old_valid > new_valid:
                    # contradicting fact has a LATER event time: it stays
                    # live; the new (older) fact arrives pre-superseded
                    new_invalid = (old_valid if new_invalid is None
                                   else min(new_invalid, old_valid))
                elif kind == "db":
                    self.db.execute(
                        "UPDATE kg_edge SET invalid_at=? WHERE id=?",
                        (max(new_valid, old_valid), ref),
                    )
                else:  # superseded within the batch: never inserted
                    edge_rows[ref] = None
            if set(res.duplicates) - set(res.contradictions):
                continue  # identical live fact: idempotent re-index
            touched.update((sid, tid))
            edge_rows.append(
                (new_id("kged"), sid, tid, t, eid, new_valid, new_invalid))
        edge_rows = [e for e in edge_rows if e is not None]

        if edge_rows:
            rows = eng.ingest(
                [e[3].fact for e in edge_rows],
                metadata=[{"edge_id": e[0]} for e in edge_rows],
            )
            for (edge_id, sid, tid, t, eid, v_at, inv_at), row_id in zip(
                    edge_rows, rows):
                self.db.execute(
                    "INSERT INTO kg_edge (id,group_id,source_id,target_id,"
                    "relation,fact,episode_id,row_id,valid_at,invalid_at,"
                    "created) VALUES (?,?,?,?,?,?,?,?,?,?,?)",
                    (edge_id, group_id, sid, tid, t.relation, t.fact, eid,
                     row_id, v_at, inv_at, now),
                )
        self._refresh_node_summaries(group_id, touched)
        return {"episode_ids": episode_ids,
                "edges": [e[0] for e in edge_rows],
                "triples": len(edge_rows)}

    def delete_group(self, group_id: str) -> None:
        self.db.execute("DELETE FROM kg_edge WHERE group_id=?", (group_id,))
        self.db.execute("DELETE FROM kg_node WHERE group_id=?", (group_id,))
        self.db.execute("DELETE FROM kg_episode WHERE group_id=?", (group_id,))
        self.db.execute("DELETE FROM kg_node_alias WHERE group_id=?",
                        (group_id,))
        self._engines.pop(group_id, None)

    def delete_episode(self, group_id: str, episode_id: str) -> None:
        eng = self._engine(group_id)
        rows = self.db.query(
            "SELECT row_id FROM kg_edge WHERE group_id=? AND episode_id=?",
            (group_id, episode_id),
        )
        dead = [r["row_id"] for r in rows if r["row_id"] >= 0]
        ep = self.db.query_one(
            "SELECT row_id FROM kg_episode WHERE id=?", (episode_id,)
        )
        if ep and ep.get("row_id", -1) is not None and ep["row_id"] >= 0:
            dead.append(ep["row_id"])
        eng.delete(dead)
        self.db.execute(
            "DELETE FROM kg_edge WHERE group_id=? AND episode_id=?",
            (group_id, episode_id),
        )
        self.db.execute("DELETE FROM kg_episode WHERE id=?", (episode_id,))

    # -- search ----------------------------------------------------------------------

    def _node_id(self, group_id: str, name: str) -> Optional[str]:
        norm = " ".join(name.lower().split())
        row = self.db.query_one(
            "SELECT id FROM kg_node WHERE group_id=? AND name_norm=?",
            (group_id, norm),
        )
        if row:
            return row["id"]
        alias = self.db.query_one(
            "SELECT node_id FROM kg_node_alias WHERE group_id=? AND norm=?",
            (group_id, norm),
        )
        return alias["node_id"] if alias else None

    def _node_distances(self, group_id: str, origin_ids: list[str],
                        max_depth: int = 3) -> dict[str, int]:
        """BFS hop distance from any origin over the valid-edge adjacency
        (graphiti's node_distance reranker uses shortest RELATES_TO path —
        search_utils.py node_distance; done here as one host BFS over the
        sqlite adjacency, KG-scale small)."""
        adj: dict[str, set[str]] = {}
        for e in self.db.query(
            "SELECT source_id, target_id FROM kg_edge WHERE group_id=?"
            " AND invalid_at IS NULL",
            (group_id,),
        ):
            adj.setdefault(e["source_id"], set()).add(e["target_id"])
            adj.setdefault(e["target_id"], set()).add(e["source_id"])
        dist = {o: 0 for o in origin_ids}
        frontier = list(origin_ids)
        for d in range(1, max_depth + 1):
            nxt = []
            for u in frontier:
                for v in adj.get(u, ()):
                    if v not in dist:
                        dist[v] = d
                        nxt.append(v)
            frontier = nxt
        return dist

    def _valid_at(self, edge: dict, as_of: Optional[float]) -> bool:
        if as_of is None:
            return edge["invalid_at"] is None
        return edge["valid_at"] <= as_of and (
            edge["invalid_at"] is None or edge["invalid_at"] > as_of
        )

    def _edge_doc_rows(self, group_id: str,
                       as_of: Optional[float]) -> Optional[list[int]]:
        """Device row allowlist for temporal search: only edges valid at
        ``as_of`` score (a mask, not a gather — shapes static).

        For live searches (``as_of=None``) the allowlist is the
        currently-valid rows — superseded edges keep their device rows
        for as_of queries, so without this a frequently-updated group
        fills the top_k*2 candidate pool with invalidated facts and the
        post-filter returns fewer than top_k results.
        Returns None when nothing is invalidated (common case: no
        allowlist needed, index_types scoping suffices)."""
        if as_of is None:
            n_dead = self.db.query_one(
                "SELECT COUNT(*) AS n FROM kg_edge WHERE group_id=?"
                " AND row_id>=0 AND invalid_at IS NOT NULL",
                (group_id,),
            )
            if not n_dead or not n_dead["n"]:
                return None
            rows = self.db.query(
                "SELECT row_id FROM kg_edge WHERE group_id=? AND row_id>=0"
                " AND invalid_at IS NULL",
                (group_id,),
            )
            return [r["row_id"] for r in rows]
        rows = self.db.query(
            "SELECT row_id FROM kg_edge WHERE group_id=? AND row_id>=0"
            " AND valid_at<=? AND (invalid_at IS NULL OR invalid_at>?)",
            (group_id, as_of, as_of),
        )
        return [r["row_id"] for r in rows]

    def search(self, group_id: str, query: str, top_k: int = 5,
               center_node: Optional[str] = None,
               rerank: Optional[str] = None,
               as_of: Optional[float] = None,
               bfs_origin_nodes: Optional[list[str]] = None) -> list[dict]:
        """Hybrid edge-fact search with graphiti's reranker recipes.

        ``rerank``: None (RRF order as retrieved) | 'mmr' (diversity over
        fact embeddings) | 'cross_encoder' (service reranker refines) |
        'node_distance' (closer to ``center_node`` ranks higher) —
        the EdgeReranker family of search_config_recipes.py.
        ``as_of``: point-in-time query — only facts valid at that
        timestamp score, including since-superseded ones.
        ``bfs_origin_nodes``: facts within one hop of these nodes join
        the candidate pool (edge_bfs_search, search_utils.py:431)."""
        eng = self._engine(group_id)
        if eng.index.size == 0:
            return []
        doc_rows = self._edge_doc_rows(group_id, as_of)
        if doc_rows is not None and not doc_rows:
            return []
        hits = eng.search(query, top_k=top_k * 2, mode="hybrid",
                          index_types=None if doc_rows else _SCOPE_FACT,
                          doc_rows=doc_rows)
        if bfs_origin_nodes:
            hits = self._merge_bfs_edges(group_id, query, hits,
                                         bfs_origin_nodes, as_of)
        if rerank == "mmr" and len(hits) > 1:
            hits = self._mmr(query, hits, top_k * 2)
        elif rerank == "cross_encoder" and self.reranker and hits:
            ce = _host(self.reranker(query, [h.text for h in hits]))
            order = np.argsort(-ce)
            hits = [hits[int(j)] for j in order]
            for h, s in zip(hits, sorted(ce.tolist(), reverse=True)):
                h.score = float(s)
        center_id = self._node_id(group_id, center_node) if center_node \
            else None
        dist = (self._node_distances(group_id, [center_id])
                if center_id else {})
        out = []
        for h in hits:
            edge = self.db.query_one(
                "SELECT e.*, s.name AS source_name, t.name AS target_name"
                " FROM kg_edge e JOIN kg_node s ON s.id=e.source_id"
                " JOIN kg_node t ON t.id=e.target_id WHERE e.id=?",
                (h.metadata.get("edge_id", ""),),
            )
            if edge is None or not self._valid_at(edge, as_of):
                continue
            score = h.score
            if center_id:
                d = min(dist.get(edge["source_id"], 9),
                        dist.get(edge["target_id"], 9))
                if rerank == "node_distance":
                    # graphiti node_distance: rank by 1/(1+hops)
                    score = 1.0 / (1.0 + d)
                elif d <= 1:
                    score = score * 2.0  # legacy adjacency boost
            out.append({
                "fact": edge["fact"], "score": score,
                "source": edge["source_name"], "target": edge["target_name"],
                "relation": edge["relation"], "edge_id": edge["id"],
                "valid_at": edge["valid_at"], "invalid_at": edge["invalid_at"],
            })
        out.sort(key=lambda r: -r["score"])
        return out[:top_k]

    def _merge_bfs_edges(self, group_id: str, query: str, hits,
                         origin_names: list[str],
                         as_of: Optional[float]):
        """Add one-hop-of-origin facts to the candidate pool, RRF-merged
        with the retrieved order (the bfs search method of the recipes)."""
        origin_ids = [i for i in (self._node_id(group_id, n)
                                  for n in origin_names) if i]
        if not origin_ids:
            return hits
        have = {h.metadata.get("edge_id") for h in hits}
        ph = ",".join("?" * len(origin_ids))
        extra = []
        for e in self.db.query(
            f"SELECT * FROM kg_edge WHERE group_id=? AND (source_id IN ({ph})"
            f" OR target_id IN ({ph}))",
            (group_id, *origin_ids, *origin_ids),
        ):
            if e["id"] in have or not self._valid_at(e, as_of):
                continue
            if e["row_id"] is None or e["row_id"] < 0:
                continue
            tail = hits[-1].score if hits else 1.0
            extra.append(SearchHit(
                row=e["row_id"], score=tail * 0.5, text=e["fact"],
                metadata={"edge_id": e["id"]}, recall_type="bfs",
            ))
        return hits + extra

    # -- node / episode / combined search (graphiti recipe parity) ---------

    def search_nodes(self, group_id: str, query: str, top_k: int = 5,
                     center_node: Optional[str] = None,
                     rerank: Optional[str] = None,
                     bfs_origin_nodes: Optional[list[str]] = None
                     ) -> list[dict]:
        """Node-centric search (node_search, search.py:225-330): hybrid
        over node rows ⊕ rank aggregation from matching FACTS (a node
        surfaces when its facts match even if its name doesn't), with the
        NodeReranker family (rrf | mmr | cross_encoder | node_distance
        via center_node) and BFS origin expansion."""
        eng = self._engine(group_id)
        if eng.index.size == 0:
            return []
        # branch 1: direct node-row hits
        direct = eng.search(query, top_k=top_k * 2, mode="hybrid",
                            index_types=_SCOPE_NODE)
        # branch 2: nodes of matching facts (rank-aggregated, RRF-style)
        fact_hits = eng.search(query, top_k=top_k * 4, mode="hybrid",
                               index_types=_SCOPE_FACT)
        node_score: dict[str, float] = {}
        for rank, h in enumerate(direct):
            edge = h.metadata.get("node_id")
            if edge:
                node_score[edge] = node_score.get(edge, 0.0) \
                    + 1.0 / (10 + rank)
        for rank, h in enumerate(fact_hits):
            e = self.db.query_one(
                "SELECT source_id, target_id, invalid_at, valid_at FROM"
                " kg_edge WHERE id=?",
                (h.metadata.get("edge_id", ""),),
            )
            if e is None or e["invalid_at"] is not None:
                continue
            for nid in (e["source_id"], e["target_id"]):
                node_score[nid] = node_score.get(nid, 0.0) + 1.0 / (10 + rank)
        if bfs_origin_nodes:
            origin_ids = [i for i in (self._node_id(group_id, n)
                                      for n in bfs_origin_nodes) if i]
            if origin_ids:
                floor = min(node_score.values(), default=0.02)
                for nid, d in self._node_distances(
                    group_id, origin_ids, max_depth=1
                ).items():
                    if d == 1 and nid not in node_score:
                        node_score[nid] = floor * 0.5
        if not node_score:
            return []
        center_id = self._node_id(group_id, center_node) if center_node \
            else None
        if rerank == "node_distance" and center_id:
            dist = self._node_distances(group_id, [center_id])
            for nid in node_score:
                node_score[nid] = 1.0 / (1.0 + dist.get(nid, 9))
        ranked = sorted(node_score.items(), key=lambda kv: -kv[1])
        out = []
        for nid, score in ranked:
            n = self.db.query_one("SELECT * FROM kg_node WHERE id=?", (nid,))
            if n is None:
                continue
            facts = self.db.query(
                "SELECT fact FROM kg_edge WHERE group_id=? AND invalid_at IS"
                " NULL AND (source_id=? OR target_id=?) LIMIT 3",
                (group_id, nid, nid),
            )
            out.append({
                "node_id": nid, "name": n["name"], "label": n["label"],
                "score": round(score, 5),
                "facts": [f["fact"] for f in facts],
            })
            if len(out) >= top_k * 2:
                break
        if rerank == "mmr" and len(out) > 1:
            texts = [f"{o['name']}: {'; '.join(o['facts'])}" for o in out]
            order = self._mmr_order(query, texts, top_k)
            out = [out[i] for i in order]
        elif rerank == "cross_encoder" and self.reranker and out:
            texts = [f"{o['name']}: {'; '.join(o['facts'])}" for o in out]
            ce = _host(self.reranker(query, texts))
            order = np.argsort(-ce)
            out = [out[int(j)] for j in order]
        return out[:top_k]

    def search_episodes(self, group_id: str, query: str,
                        top_k: int = 5) -> list[dict]:
        """Episode retrieval (episode_search, search.py:332-387; the
        recipes use BM25 only for episodes) over preview rows."""
        eng = self._engine(group_id)
        if eng.index.size == 0:
            return []
        hits = eng.search(query, top_k=top_k, mode="fulltext",
                          index_types=_SCOPE_EPISODE)
        out = []
        for h in hits:
            ep = self.db.query_one(
                "SELECT * FROM kg_episode WHERE id=?",
                (h.metadata.get("episode_id", ""),),
            )
            if ep is None:
                continue
            out.append({
                "episode_id": ep["id"], "score": h.score,
                "source": ep["source"], "preview": ep["content_preview"],
                "created": ep["created"],
            })
        return out

    def search_communities(self, group_id: str, query: str,
                           top_k: int = 3) -> list[dict]:
        """Community search (community recipes): cosine over community
        summary embeddings — communities are few, so this scores host-side
        with the engine's embedder rather than maintaining device rows."""
        comms = self.communities(group_id)
        if not comms:
            return []
        embedder = self._engine(group_id).embedder
        texts = [f"{c['summary']} {' '.join(c['members'])}" for c in comms]
        emb = _host(embedder.embed([query] + texts))
        nrm = np.linalg.norm(emb, axis=1, keepdims=True)
        emb = emb / np.where(nrm > 0, nrm, 1.0)
        scores = emb[1:] @ emb[0]
        order = np.argsort(-scores)[:top_k]
        return [{**comms[int(j)], "score": float(scores[int(j)])}
                for j in order]

    def search_combined(self, group_id: str, query: str, limit: int = 5,
                        center_node: Optional[str] = None,
                        rerank: Optional[str] = None,
                        as_of: Optional[float] = None,
                        bfs_origin_nodes: Optional[list[str]] = None,
                        scopes: Optional[list[str]] = None) -> dict:
        """The COMBINED_HYBRID_SEARCH_* recipe shape (search.py:54-180):
        edge + node + episode + community sub-searches in one call,
        sharing the reranker/center/BFS configuration."""
        scopes = scopes or ["edges", "nodes", "episodes", "communities"]
        out: dict = {}
        if "edges" in scopes:
            out["edges"] = self.search(
                group_id, query, top_k=limit, center_node=center_node,
                rerank=rerank, as_of=as_of,
                bfs_origin_nodes=bfs_origin_nodes,
            )
        if "nodes" in scopes:
            out["nodes"] = self.search_nodes(
                group_id, query, top_k=limit, center_node=center_node,
                rerank=rerank, bfs_origin_nodes=bfs_origin_nodes,
            )
        if "episodes" in scopes:
            out["episodes"] = self.search_episodes(group_id, query,
                                                   top_k=limit)
        if "communities" in scopes:
            out["communities"] = self.search_communities(group_id, query,
                                                         top_k=limit)
        return out

    def expand(self, group_id: str, origin_nodes: list[str],
               max_depth: int = 1,
               as_of: Optional[float] = None) -> dict:
        """BFS hop expansion from origin nodes: nodes + edges within
        ``max_depth`` hops (edge_bfs_search/node_bfs_search parity)."""
        origin_ids = [i for i in (self._node_id(group_id, n)
                                  for n in origin_nodes) if i]
        if not origin_ids:
            return {"nodes": [], "edges": []}
        dist = self._node_distances(group_id, origin_ids,
                                    max_depth=max_depth)
        edges = []
        for e in self.db.query(
            "SELECT e.*, s.name AS source_name, t.name AS target_name"
            " FROM kg_edge e JOIN kg_node s ON s.id=e.source_id"
            " JOIN kg_node t ON t.id=e.target_id WHERE e.group_id=?",
            (group_id,),
        ):
            if not self._valid_at(e, as_of):
                continue
            if e["source_id"] in dist and e["target_id"] in dist:
                edges.append({
                    "id": e["id"], "source": e["source_name"],
                    "target": e["target_name"], "relation": e["relation"],
                    "fact": e["fact"],
                    "depth": min(dist[e["source_id"]], dist[e["target_id"]]),
                })
        nodes = []
        for nid, d in sorted(dist.items(), key=lambda kv: kv[1]):
            n = self.db.query_one("SELECT * FROM kg_node WHERE id=?", (nid,))
            if n:
                nodes.append({"id": nid, "name": n["name"],
                              "label": n["label"], "depth": d})
        return {"nodes": nodes, "edges": edges}

    def _mmr_order(self, query: str, texts: list[str], k: int,
                   lam: float = 0.6) -> list[int]:
        embedder = None
        for e in self._engines.values():
            embedder = e.embedder
            break
        if embedder is None:
            return list(range(len(texts)))
        emb = _host(embedder.embed([query] + texts))
        nrm = np.linalg.norm(emb, axis=1, keepdims=True)
        emb = emb / np.where(nrm > 0, nrm, 1.0)
        qv, dv = emb[0], emb[1:]
        rel = dv @ qv
        picked: list[int] = []
        rest = list(range(len(texts)))
        while rest and len(picked) < k:
            if not picked:
                j = int(np.argmax([rel[i] for i in rest]))
            else:
                pv = dv[picked]
                mmr = [lam * rel[i] - (1 - lam) * float((dv[i] @ pv.T).max())
                       for i in rest]
                j = int(np.argmax(mmr))
            picked.append(rest.pop(j))
        return picked

    def _mmr(self, query: str, hits, k: int, lam: float = 0.6):
        """Maximal marginal relevance over fact embeddings: greedy pick
        balancing query relevance against similarity to already-picked
        facts (diversity)."""
        return [hits[i] for i in self._mmr_order(query, [h.text for h in hits], k, lam)]

    # -- communities ---------------------------------------------------------------------

    def communities(self, group_id: str, max_members: int = 8) -> list[dict]:
        """Label-propagation communities over the valid-edge graph with
        degree-ranked members (reference community_operations.py:92
        label_propagation — unlike connected components it splits big
        weakly-joined components into dense clusters).  The community
        summary is the graphiti map-reduce: member entity summaries
        combined pairwise (summarize_pair semantics), LLM-written when a
        completion client exists, deterministic offline otherwise."""
        edges = self.db.query(
            "SELECT source_id, target_id FROM kg_edge WHERE group_id=?"
            " AND invalid_at IS NULL",
            (group_id,),
        )
        if not edges:
            return []
        adj: dict[str, set[str]] = {}
        degree: dict[str, int] = {}
        for e in edges:
            adj.setdefault(e["source_id"], set()).add(e["target_id"])
            adj.setdefault(e["target_id"], set()).add(e["source_id"])
            degree[e["source_id"]] = degree.get(e["source_id"], 0) + 1
            degree[e["target_id"]] = degree.get(e["target_id"], 0) + 1
        clusters = label_propagation(adj)
        rows = {
            r["id"]: r for r in self.db.query(
                "SELECT id, name, summary FROM kg_node WHERE group_id=?",
                (group_id,),
            )
        }
        out = []
        for j, members in enumerate(clusters):
            members = sorted(members, key=lambda n: -degree.get(n, 0))
            top = [rows[n]["name"] if n in rows else n
                   for n in members[:max_members]]
            # reduce member summaries pairwise into one community summary
            summary = ""
            for n in members[:max_members]:
                s = (rows.get(n) or {}).get("summary") or ""
                if s:
                    summary = combine_summaries(summary, s, self.completion)
            if not summary:
                summary = (f"Community of {len(members)} entities around "
                           f"{', '.join(top[:3])}")
            out.append({
                "id": f"community-{j}", "size": len(members),
                "members": top, "summary": summary,
            })
        return out

    # -- introspection (labels / subgraph for viz) ---------------------------------------

    def labels(self, group_id: str) -> list[dict]:
        return self.db.query(
            "SELECT label, COUNT(*) AS count FROM kg_node WHERE group_id=?"
            " GROUP BY label",
            (group_id,),
        )

    def subgraph(self, group_id: str, node_name: Optional[str] = None,
                 limit: int = 200) -> dict:
        if node_name:
            node = self.db.query_one(
                "SELECT id FROM kg_node WHERE group_id=? AND name_norm=?",
                (group_id, " ".join(node_name.lower().split())),
            )
            if node is None:
                return {"nodes": [], "edges": []}
            edges = self.db.query(
                "SELECT * FROM kg_edge WHERE group_id=? AND invalid_at IS NULL"
                " AND (source_id=? OR target_id=?) LIMIT ?",
                (group_id, node["id"], node["id"], limit),
            )
        else:
            edges = self.db.query(
                "SELECT * FROM kg_edge WHERE group_id=? AND invalid_at IS NULL"
                " LIMIT ?",
                (group_id, limit),
            )
        node_ids = {e["source_id"] for e in edges} | {
            e["target_id"] for e in edges
        }
        nodes = [
            self.db.query_one("SELECT * FROM kg_node WHERE id=?", (nid,))
            for nid in node_ids
        ]
        # community membership for viz coloring
        comm_of: dict[str, str] = {}
        for c in self.communities(group_id, max_members=1 << 30):
            for name in c["members"]:
                comm_of[name] = c["id"]
        return {
            "nodes": [
                {"id": n["id"], "name": n["name"], "label": n["label"],
                 "community": comm_of.get(n["name"])}
                for n in nodes if n
            ],
            "edges": [
                {"id": e["id"], "source": e["source_id"],
                 "target": e["target_id"], "relation": e["relation"],
                 "fact": e["fact"]}
                for e in edges
            ],
        }

    def stats(self, group_id: str) -> dict:
        nodes = self.db.query_one(
            "SELECT COUNT(*) AS c FROM kg_node WHERE group_id=?", (group_id,)
        )["c"]
        edges = self.db.query_one(
            "SELECT COUNT(*) AS c FROM kg_edge WHERE group_id=? AND"
            " invalid_at IS NULL",
            (group_id,),
        )["c"]
        comms = self.communities(group_id)
        return {"nodes": nodes, "edges": edges,
                "communities": len(comms),
                "community_summaries": [
                    {"id": c["id"], "size": c["size"], "summary": c["summary"]}
                    for c in comms[:10]
                ]}
