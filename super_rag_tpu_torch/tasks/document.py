"""Document index tasks: parse -> chunk -> embed -> device insert (port of
the JAX package's tasks/document.py).

The parse step pulls the original from the object store and produces
Parts; create_index chunks, embeds on the card and inserts into the
collection's DeviceIndex, recording the engine row ids in
DocumentIndex.index_data so update and delete are exact.  The port builds
the ``vector`` index type, the one a collection enables by default, the
``vision`` type (one row per image part: its image embedding where the
asset bytes exist, its caption's embedding elsewhere) and the ``graph``
type (the chunks become knowledge-graph episodes, ``kg/service.py``,
under the collection's ``kg_entity_types`` ontology) and the ``summary``
type (one row a document: its map-reduce summary through the context's
completion client, ``index/summary.py``, or the extractive summary where
no completion model is registered).
"""

from __future__ import annotations

import json
import logging

import numpy as np
import torch

from super_rag_tpu_torch.config import Settings
from super_rag_tpu_torch.engine.index import INDEXER_CODES
from super_rag_tpu_torch.engine.manager import EngineManager
from super_rag_tpu_torch.index.summary import summarize_document
from super_rag_tpu_torch.index.vision import vision_rows
from super_rag_tpu_torch.kg.extract import Ontology
from super_rag_tpu_torch.models.image_embedder import ImageEmbedder
from super_rag_tpu_torch.store.db import Database
from super_rag_tpu_torch.store.objectstore import ObjectStore
from super_rag_tpu_torch.tasks.worker import prepare_document

logger = logging.getLogger(__name__)


def _live_engine_rows(engine, document_id: str, index_type: str) -> list[int]:
    """All alive engine rows for (document, index_type) by row metadata.

    The index_data spec row can under-report: if a v1 create commits after
    v2 was claimed, the reconciler's CAS drops v1's completion as stale and
    its engine rows are never recorded.  Scanning live row_meta makes
    create_index idempotent against any orphaned rows of this document.
    """
    idx = engine.index
    code = INDEXER_CODES.get(index_type)
    codes = None
    if code is not None and idx.size:
        codes = idx.indexer_code[: idx.size].cpu().numpy()
    rows = []
    for r, meta in enumerate(idx.row_meta):
        if meta is None or meta.get("document_id") != document_id:
            continue
        if codes is not None and r < len(codes) and int(codes[r]) != code:
            continue
        rows.append(r)
    return rows


class DocumentIndexTask:
    def __init__(self, db: Database, objects: ObjectStore,
                 engines: EngineManager, cfg: Settings):
        self.db = db
        self.objects = objects
        self.engines = engines
        self.cfg = cfg
        self.ctx = None  # backfilled by service.context.build_context

    def prepare(self, document_id: str, index_type: str) -> dict:
        """Host-side stage of create_index — parse + chunk, the CPU-bound
        work safe to run on a worker pool while the device worker embeds
        a previous document (ThreadScheduler host_workers pipelining).
        Returns the payload ``create_index`` accepts as ``prepared``."""
        return prepare_document(self.db, self.objects, document_id, index_type,
                                self.cfg.chunk_size, self.cfg.chunk_overlap)

    def create_index(self, document_id: str, index_type: str,
                     version: int, prepared: dict | None = None) -> dict:
        """Parse + chunk + embed + insert; returns index_data for the spec
        row.  Idempotent per (document, version): any rows from a prior
        version are removed first.  ``prepared`` (from :meth:`prepare`)
        skips the parse/chunk stage when it matches this document."""
        doc = self.db.get_document(document_id)
        if doc is None:
            raise ValueError(f"document {document_id} not found")
        coll = self.db.get_collection(doc["collection_id"])
        engine = self.engines.get(coll["id"], coll["config"])

        # delete rows of the previous version (update = delete + recreate)
        spec_row = self.db.query_one(
            "SELECT * FROM document_index WHERE document_id=? AND index_type=?",
            (document_id, index_type),
        )
        old_rows = []
        if spec_row and spec_row.get("index_data"):
            old_rows = json.loads(spec_row["index_data"]).get("rows", [])
        # union with a live-row scan: rows inserted by a superseded version
        # whose completion lost the CAS race are in the engine but not in
        # index_data — delete them too or they stay searchable
        old_rows = sorted(
            set(old_rows) | set(_live_engine_rows(engine, document_id,
                                                  index_type))
        )
        if old_rows:
            engine.delete(old_rows)

        if (prepared is None
                or prepared.get("document_id") != document_id
                or prepared.get("doc_hash") != doc.get("content_hash")):
            prepared = self.prepare(document_id, index_type)
        parts, chunks = prepared["parts"], prepared["chunks"]
        if index_type == "vision":
            return self._create_vision(doc, coll, engine, parts)
        if not chunks:
            return {"rows": [], "chunks": 0}
        if index_type == "summary":
            return self._create_summary(doc, coll, engine, chunks)
        if index_type == "graph":
            return self._create_graph(doc, coll, chunks)

        rows = engine.ingest(
            [c.padded_text for c in chunks],
            metadata=[
                {**c.metadata, "document_id": document_id,
                 "collection_id": coll["id"], "document_name": doc["name"]}
                for c in chunks
            ],
            indexer="vector",
            chat_id=doc.get("chat_id"),
        )
        return {"rows": rows, "chunks": len(chunks)}

    def _create_summary(self, doc: dict, coll: dict, engine, chunks) -> dict:
        """One row: the document's summary (map-reduce through the
        context's completion client, else extractive)."""
        summary = summarize_document(
            [c.text for c in chunks],
            completion=getattr(self.ctx, "completion", None),
            title=doc["name"],
        )
        rows = engine.ingest(
            [summary],
            metadata=[{"document_id": doc["id"], "collection_id": coll["id"],
                       "document_name": doc["name"], "title_path": "",
                       "chunk_index": 0}],
            indexer="summary",
            chat_id=doc.get("chat_id"),
        )
        return {"rows": rows, "chunks": 1}

    def _create_graph(self, doc: dict, coll: dict, chunks) -> dict:
        """The chunks as episodes of the collection's knowledge graph: one
        extraction pass and one batched device write for the whole
        document (``add_episode_bulk``), under the collection's entity
        ontology (``kg_entity_types``)."""
        kg = getattr(self.ctx, "kg", None)
        if kg is None:
            raise ValueError("graph index requires the kg service")
        config = coll.get("config") or {}
        if isinstance(config, str):
            try:
                config = json.loads(config)
            except ValueError:
                config = {}
        r = kg.add_episode_bulk(
            coll["id"], [c.text for c in chunks], source=doc["id"],
            ontology=Ontology.from_config(config.get("kg_entity_types")),
        )
        return {"rows": [], "episodes": r["episode_ids"], "chunks": len(chunks)}

    def _create_vision(self, doc: dict, coll: dict, engine, parts) -> dict:
        """One row per image part: the image embedding where the asset
        bytes exist (or the caption's embedding where that is all zeros),
        the caption text for BM25; the asset goes to
        ``assets/{document_id}/{asset_id}``."""
        document_id = doc["id"]
        rows_data = vision_rows(
            parts,
            vision_completion=getattr(self.ctx, "completion", None),
            doc_name=doc["name"],
        )
        if not rows_data:
            return {"rows": [], "chunks": 0}
        dim = engine.index.spec.dim
        emb = np.zeros((len(rows_data), dim), np.float32)
        with_data = [j for j, r in enumerate(rows_data) if r["data"]]
        if with_data:
            emb[with_data] = ImageEmbedder(dim=dim).embed(
                [rows_data[j]["data"] for j in with_data])
        text_only = [j for j in range(len(rows_data))
                     if j not in set(with_data) or not emb[j].any()]
        if text_only:
            caption = engine.embedder.embed(
                [rows_data[j]["text"] for j in text_only])
            if isinstance(caption, torch.Tensor):
                caption = caption.float().cpu().numpy()
            emb[text_only] = np.asarray(caption, np.float32)
        for r in rows_data:  # assets retrievable for preview/display
            if r["data"]:
                self.objects.put(f"assets/{document_id}/{r['asset_id']}",
                                 r["data"])
        rows = engine.ingest(
            [r["text"] for r in rows_data],
            metadata=[
                {"document_id": document_id, "collection_id": coll["id"],
                 "document_name": doc["name"], "asset_id": r["asset_id"],
                 "mime_type": r.get("mime_type"), "title_path": "",
                 "chunk_index": j}
                for j, r in enumerate(rows_data)
            ],
            indexer="vision",
            chat_id=doc.get("chat_id"),
            embeddings=emb,
        )
        return {"rows": rows, "chunks": len(rows)}

    def delete_index(self, document_id: str, index_type: str) -> None:
        doc = self.db.get_document(document_id)
        if doc is None:
            return
        spec_row = self.db.query_one(
            "SELECT * FROM document_index WHERE document_id=? AND index_type=?",
            (document_id, index_type),
        )
        data = (
            json.loads(spec_row["index_data"])
            if spec_row and spec_row.get("index_data")
            else {}
        )
        rows = data.get("rows", [])
        if rows:
            coll = self.db.get_collection(doc["collection_id"])
            engine = self.engines.get(coll["id"], coll["config"] if coll else {})
            engine.delete(rows)
        kg = getattr(self.ctx, "kg", None)
        if kg is not None:
            for eid in data.get("episodes", []):
                kg.delete_episode(doc["collection_id"], eid)
