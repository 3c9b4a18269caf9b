"""Status enums and record constants for the metadata store (port of the
JAX package's store/models.py).

Mirrors the reference's status model (db/models.py:51-87) and the
DocumentIndex desired/observed-version reconciliation state machine
(db/models.py:175-204, tasks/reconciler.py:61-75).
"""

from __future__ import annotations

import enum


class CollectionStatus(str, enum.Enum):
    INACTIVE = "INACTIVE"
    ACTIVE = "ACTIVE"
    DELETED = "DELETED"


class DocumentStatus(str, enum.Enum):
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    COMPLETE = "COMPLETE"
    FAILED = "FAILED"
    DELETING = "DELETING"
    DELETED = "DELETED"


class IndexStatus(str, enum.Enum):
    PENDING = "PENDING"
    CREATING = "CREATING"
    ACTIVE = "ACTIVE"
    FAILED = "FAILED"
    DELETING = "DELETING"
    DELETION_IN_PROGRESS = "DELETION_IN_PROGRESS"
    DELETED = "DELETED"


class IndexType(str, enum.Enum):
    VECTOR = "vector"
    FULLTEXT = "fulltext"
    SUMMARY = "summary"
    VISION = "vision"
    GRAPH = "graph"


class WorkflowRunStatus(str, enum.Enum):
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCESS = "SUCCESS"
    FAILED = "FAILED"


def derive_document_status(index_statuses: list[str]) -> str:
    """Overall document status from its index statuses (reference
    db/models.py:249-258 derivation)."""
    if not index_statuses:
        return DocumentStatus.PENDING.value
    ss = set(index_statuses)
    if ss & {IndexStatus.FAILED.value}:
        return DocumentStatus.FAILED.value
    if ss <= {IndexStatus.ACTIVE.value}:
        return DocumentStatus.COMPLETE.value
    if ss & {
        IndexStatus.CREATING.value,
        IndexStatus.DELETION_IN_PROGRESS.value,
    }:
        return DocumentStatus.RUNNING.value
    return DocumentStatus.PENDING.value
