"""Document lifecycle: upload -> dedup/quota -> index specs -> reconcile
(port of the JAX package's service/document_service.py).

Counterpart of the reference's DocumentService
(service/document_service.py): validate/quota/dedup :76-160, create
record + objectstore upload :179, rebuild :618-723, chunk listing
:725-885, preview + byte-range streaming :886-1029, reconcile trigger on
every mutation :44-60.
"""

from __future__ import annotations

import hashlib
from typing import Iterator, Optional

from super_rag_tpu_torch.api.http import HttpError
from super_rag_tpu_torch.service.collection_service import CollectionService
from super_rag_tpu_torch.service.context import AppContext
from super_rag_tpu_torch.store.models import DocumentStatus
from super_rag_tpu_torch.store.objectstore import safe_object_name


class DocumentService:
    def __init__(self, ctx: AppContext, collections: CollectionService):
        self.ctx = ctx
        self.collections = collections

    def _trigger_reconcile(self) -> None:
        self.ctx.reconciler.reconcile_all()

    def create(self, user: str, collection_id: str, name: str, data: bytes,
               metadata: Optional[dict] = None,
               chat_id: Optional[str] = None) -> dict:
        coll = self.collections.get(user, collection_id, allow_shared=False)
        # the name ends the object key: it must stay inside its directory
        if not safe_object_name(name, nested=True):
            raise HttpError(422, "invalid document name")
        if len(data) > self.ctx.cfg.max_document_size_mb * 1024 * 1024:
            raise HttpError(413, "document exceeds size limit")
        docs = self.ctx.db.list_documents(collection_id)
        if len(docs) >= self.ctx.cfg.max_documents_per_collection:
            raise HttpError(429, "document quota exceeded")
        content_hash = hashlib.sha256(data).hexdigest()
        dup = self.ctx.db.find_document_by_hash(collection_id, content_hash)
        if dup is not None:
            raise HttpError(409, f"duplicate of document {dup['id']}")
        object_path = f"{collection_id}/{content_hash[:16]}/{name}"
        self.ctx.objects.put(object_path, data)
        doc = self.ctx.db.create_document(
            collection_id, name, size=len(data), content_hash=content_hash,
            object_path=object_path, metadata=metadata, chat_id=chat_id,
        )
        enabled = self._enabled_index_types(coll["config"])
        for itype in enabled:
            self.ctx.db.upsert_document_index(doc["id"], itype)
        self._trigger_reconcile()
        return self.get(user, doc["id"])

    @staticmethod
    def _enabled_index_types(config: dict) -> list[str]:
        """Index-type selection from collection config (reference
        document_service.py:162; only vector active by default)."""
        types = ["vector"]
        if config.get("enable_summary"):
            types.append("summary")
        if config.get("enable_vision"):
            types.append("vision")
        if config.get("enable_knowledge_graph"):
            types.append("graph")
        return types

    def get(self, user: str, document_id: str) -> dict:
        doc = self.ctx.db.get_document(document_id)
        if doc is None or doc["status"] == DocumentStatus.DELETED.value:
            raise HttpError(404, f"document {document_id} not found")
        self.collections.get(user, doc["collection_id"])
        doc["indexes"] = [
            {k: r[k] for k in ("index_type", "status", "version",
                               "observed_version", "error_message")}
            for r in self.ctx.db.get_document_indexes(document_id)
        ]
        return doc

    def list(self, user: str, collection_id: str) -> list[dict]:
        self.collections.get(user, collection_id)
        docs = self.ctx.db.list_documents(collection_id)
        for d in docs:
            d["indexes"] = [
                {k: r[k] for k in ("index_type", "status", "version",
                                   "observed_version")}
                for r in self.ctx.db.get_document_indexes(d["id"])
            ]
        return docs

    def delete(self, user: str, document_id: str) -> None:
        self.delete_many(user, [document_id])

    def delete_many(self, user: str, document_ids: list[str]) -> list[str]:
        """Batched delete with ONE reconcile pass.  Order matters: all
        docs are marked DELETING first, the reconciler tears the index
        rows down while they are DELETING, and only then are they
        finalized to DELETED — reconciling after the DELETED mark would
        re-derive document status from the index rows and resurrect the
        document.  Validates the whole batch before mutating anything."""
        docs = []
        for did in document_ids:
            doc = self.get(user, did)
            # destructive: owner only — a marketplace subscriber or share
            # recipient has read access via get() but must not delete
            self.collections.get(user, doc["collection_id"],
                                 allow_shared=False)
            docs.append(doc)
        for doc in docs:
            self.ctx.db.mark_indexes_deleting(doc["id"])
            self.ctx.db.update_document(
                doc["id"], status=DocumentStatus.DELETING.value
            )
        self._trigger_reconcile()
        for doc in docs:
            self.ctx.db.update_document(
                doc["id"], status=DocumentStatus.DELETED.value
            )
            self.ctx.objects.delete(doc["object_path"])
        return [d["id"] for d in docs]

    def rebuild_indexes(self, user: str, document_id: str,
                        only_failed: bool = False,
                        reconcile: bool = True) -> int:
        doc = self.get(user, document_id)
        # rebuild burns compute: owner only (same rule as delete)
        self.collections.get(user, doc["collection_id"], allow_shared=False)
        n = self.ctx.db.rebuild_indexes(document_id, only_failed=only_failed)
        if reconcile:
            self._trigger_reconcile()
        return n

    def chunks(self, user: str, document_id: str) -> list[dict]:
        """Chunk listing straight from the device index rows (the
        reference queries SeekDB by metadata filter — :725-885)."""
        doc = self.get(user, document_id)
        coll = self.ctx.db.get_collection(doc["collection_id"])
        engine = self.ctx.engines.get(coll["id"], coll["config"])
        out = []
        for row, meta in enumerate(engine.index.row_meta):
            if meta is not None and meta.get("document_id") == document_id:
                out.append(
                    {"row": row, "text": meta["text"],
                     "chunk_index": meta.get("chunk_index"),
                     "title_path": meta.get("title_path", "")}
                )
        out.sort(key=lambda c: (c["chunk_index"] is None, c["chunk_index"]))
        return out

    def preview_bytes(self, user: str, document_id: str, start: int = 0,
                      end: Optional[int] = None) -> tuple[dict, Iterator[bytes]]:
        doc = self.get(user, document_id)
        if not self.ctx.objects.exists(doc["object_path"]):
            raise HttpError(404, "original object missing")
        return doc, self.ctx.objects.stream_range(doc["object_path"], start, end)
