"""Document index tasks: parse -> chunk -> embed -> device insert (port of
the JAX package's tasks/document.py).

The parse step pulls the original from the object store and produces
Parts; create_index chunks, embeds on the card and inserts into the
collection's DeviceIndex, recording the engine row ids in
DocumentIndex.index_data so update and delete are exact.  The port builds
the ``vector`` index type, the one a collection enables by default; the
summary, vision and graph index types are not ported yet (ROADMAP A6).
"""

from __future__ import annotations

import json
import logging

from super_rag_tpu_torch.chunk.chunking import Rechunker
from super_rag_tpu_torch.config import Settings
from super_rag_tpu_torch.engine.index import INDEXER_CODES
from super_rag_tpu_torch.engine.manager import EngineManager
from super_rag_tpu_torch.fileparser.parser import DocParser
from super_rag_tpu_torch.store.db import Database
from super_rag_tpu_torch.store.objectstore import ObjectStore

logger = logging.getLogger(__name__)

UNPORTED_INDEX_TYPES = ("summary", "vision", "graph")


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
        self.parser = DocParser()
        self.ctx = None  # backfilled by service.context.build_context

    def _load_parts(self, document: dict):
        data = self.objects.get(document["object_path"])
        return self.parser.parse_file(document["name"], data)

    def prepare(self, document_id: str, index_type: str) -> dict:
        """Host-side stage of create_index — parse + chunk, the CPU-bound
        work safe to run on a worker pool while the device worker embeds
        a previous document (ThreadScheduler host_workers pipelining).
        Returns the payload ``create_index`` accepts as ``prepared``."""
        doc = self.db.get_document(document_id)
        if doc is None:
            raise ValueError(f"document {document_id} not found")
        parts = self._load_parts(doc)
        chunker = Rechunker(self.cfg.chunk_size, self.cfg.chunk_overlap)
        chunks = chunker.rechunk(parts, metadata={"document_id": document_id})
        return {"document_id": document_id, "index_type": index_type,
                "doc_hash": doc.get("content_hash"), "parts": parts,
                "chunks": chunks}

    def create_index(self, document_id: str, index_type: str,
                     version: int, prepared: dict | None = None) -> dict:
        """Parse + chunk + embed + insert; returns index_data for the spec
        row.  Idempotent per (document, version): any rows from a prior
        version are removed first.  ``prepared`` (from :meth:`prepare`)
        skips the parse/chunk stage when it matches this document."""
        if index_type in UNPORTED_INDEX_TYPES:
            raise NotImplementedError(
                f"the {index_type} index type is not ported to the PyTorch "
                "port yet (ROADMAP A6)")
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

        if (prepared is not None
                and prepared.get("document_id") == document_id
                and prepared.get("doc_hash") == doc.get("content_hash")):
            chunks = prepared["chunks"]
        else:
            parts = self._load_parts(doc)
            chunker = Rechunker(self.cfg.chunk_size, self.cfg.chunk_overlap)
            chunks = chunker.rechunk(parts,
                                     metadata={"document_id": document_id})
        if not chunks:
            return {"rows": [], "chunks": 0}

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
