"""Level-triggered document-index reconciler (port of the JAX package's
tasks/reconciler.py).

Re-implements the reference's Kubernetes-style reconciliation
(tasks/reconciler.py:27-357): desired state is DocumentIndex(version,
status), observed state is observed_version; reconcile_all claims work
with atomic CAS updates (PENDING -> CREATING, DELETING ->
DELETION_IN_PROGRESS) and hands it to the scheduler; completion callbacks
validate the version before flipping to ACTIVE so stale tasks can never
clobber a newer re-index.  Runs on every mutation and periodically
(reference: hourly — config/ray_schedule.py:84-86).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from super_rag_tpu_torch.store.db import Database
from super_rag_tpu_torch.store.models import DocumentStatus, IndexStatus, derive_document_status

logger = logging.getLogger(__name__)


class IndexTaskCallbacks:
    """Completion callbacks with version-validated CAS updates."""

    def __init__(self, db: Database):
        self.db = db

    def _refresh_document_status(self, index_id: int) -> None:
        row = self.db.query_one(
            "SELECT document_id FROM document_index WHERE id=?", (index_id,)
        )
        if not row:
            return
        doc = self.db.get_document(row["document_id"])
        if doc is None or doc["status"] == DocumentStatus.DELETED.value:
            # a background scheduler finishes an index teardown after
            # delete_many marked the document DELETED: re-deriving its
            # status from the (now DELETED) index rows would resurrect it
            return
        statuses = [
            r["status"]
            for r in self.db.get_document_indexes(row["document_id"])
            if r["status"] != IndexStatus.DELETED.value
        ]
        self.db.update_document(
            row["document_id"], status=derive_document_status(statuses)
        )

    def on_index_created(self, index_id: int, version: int, data: dict) -> None:
        if not self.db.complete_index(index_id, version, data):
            logger.warning(
                "stale create completion ignored (index %s v%s)", index_id, version
            )
        self._refresh_document_status(index_id)

    def on_index_failed(self, index_id: int, version: int, error: str) -> None:
        self.db.fail_index(index_id, version, error)
        self._refresh_document_status(index_id)

    def on_index_deleted(self, index_id: int) -> None:
        self.db.delete_index_done(index_id)
        self._refresh_document_status(index_id)

    def on_index_delete_failed(self, index_id: int, error: str) -> None:
        # leave in DELETION_IN_PROGRESS; the next reconcile pass re-drives
        self.db.execute(
            "UPDATE document_index SET error_message=? WHERE id=?",
            (error[:2000], index_id),
        )


class DocumentIndexReconciler:
    def __init__(self, db: Database, scheduler=None):
        self.db = db
        self.scheduler = scheduler
        self.callbacks = IndexTaskCallbacks(db)
        self._timer: Optional[threading.Timer] = None

    def reconcile_all(self) -> int:
        """One reconciliation pass; returns number of tasks scheduled."""
        if self.scheduler is None:
            return 0
        scheduled = 0
        for row in self.db.indexes_needing_reconciliation():
            rid, ver = row["id"], row["version"]
            if row["status"] == IndexStatus.PENDING.value:
                if self.db.claim_index(
                    rid, IndexStatus.PENDING.value, IndexStatus.CREATING.value, ver
                ):
                    self.scheduler.schedule_create_index(
                        rid, row["document_id"], row["index_type"], ver
                    )
                    scheduled += 1
            elif row["status"] == IndexStatus.DELETING.value:
                if self.db.claim_index(
                    rid, IndexStatus.DELETING.value,
                    IndexStatus.DELETION_IN_PROGRESS.value, ver,
                ):
                    self.scheduler.schedule_delete_index(
                        rid, row["document_id"], row["index_type"]
                    )
                    scheduled += 1
        return scheduled

    # stuck-task re-drive: claims older than this go back to their desired
    # state so a crashed worker cannot orphan an index forever.
    def requeue_stale(self, max_age_s: float = 3600.0) -> int:
        cutoff = time.time() - max_age_s
        n = self.db.execute(
            "UPDATE document_index SET status=? WHERE status=? AND updated<?",
            (IndexStatus.PENDING.value, IndexStatus.CREATING.value, cutoff),
        ).rowcount
        n += self.db.execute(
            "UPDATE document_index SET status=? WHERE status=? AND updated<?",
            (IndexStatus.DELETING.value,
             IndexStatus.DELETION_IN_PROGRESS.value, cutoff),
        ).rowcount
        return n

    def verify_engine_state(self, engines, db=None) -> int:
        """Detect lost device state and re-drive (level-triggered recovery).

        An index row can claim ACTIVE while the engine holds none of its
        rows — e.g. snapshots were deleted or the process restarted before
        a flush.  The desired state (DocumentIndex.version) outlives the
        device, so reconciliation just needs observed_version reset; the
        next pass rebuilds.  Returns the number of indexes requeued.
        """
        db = db or self.db
        import json as _json

        requeued = 0
        by_coll: dict[str, list[dict]] = {}
        rows = db.query(
            "SELECT di.*, d.collection_id FROM document_index di"
            " JOIN document d ON d.id = di.document_id"
            " WHERE di.status='ACTIVE'"
        )
        for r in rows:
            by_coll.setdefault(r["collection_id"], []).append(r)
        for cid, idx_rows in by_coll.items():
            coll = db.get_collection(cid)
            if coll is None or coll["status"] == "DELETED":
                continue
            engine = engines.get(cid, coll["config"])
            for r in idx_rows:
                data = _json.loads(r["index_data"] or "{}")
                claimed = data.get("rows", [])
                if not claimed and not data.get("episodes"):
                    continue
                alive = any(
                    row < len(engine.index.row_meta)
                    and engine.index.row_meta[row] is not None
                    and engine.index.row_meta[row].get("document_id")
                    == r["document_id"]
                    for row in claimed
                )
                if claimed and not alive:
                    db.execute(
                        "UPDATE document_index SET status='PENDING',"
                        " observed_version=0, version=version+1, updated=?"
                        " WHERE id=?",
                        (time.time(), r["id"]),
                    )
                    requeued += 1
        if requeued:
            logger.warning(
                "engine state lost for %d indexes; requeued for rebuild",
                requeued,
            )
            self.reconcile_all()
        return requeued

    def start_periodic(self, interval_s: float) -> None:
        def tick():
            try:
                self.requeue_stale(max_age_s=max(interval_s, 600.0))
                self.reconcile_all()
            except Exception:  # noqa: BLE001
                logger.exception("periodic reconcile failed")
            self._timer = threading.Timer(interval_s, tick)
            self._timer.daemon = True
            self._timer.start()

        self._timer = threading.Timer(interval_s, tick)
        self._timer.daemon = True
        self._timer.start()

    def stop(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
