"""Shared models flowing between nodes (port of the JAX package's
nodeflow/types.py, on the port's own ``Model``).

DocumentWithScore mirrors the reference's result model
(super_rag/models/models.py:263) — the unit passed between
vector_search/fulltext_search/merge/rerank/llm nodes.
"""

from __future__ import annotations


from super_rag_tpu_torch.schema.model import Model


class DocumentWithScore(Model):
    text: str
    score: float = 0.0
    metadata: dict = {}
    recall_type: str = ""


class DocsOutput(Model):
    docs: list[DocumentWithScore] = []


class StartOutput(Model):
    query: str = ""


class AnswerOutput(Model):
    text: str = ""
    docs: list[DocumentWithScore] = []
    references: list[dict] = []
