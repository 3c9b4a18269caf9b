"""Rerank node: on-device cross-encoder with heuristic fallback (port of
the JAX package's runner).

Counterpart of the reference rerank runner (nodeflow/runners/rerank.py):
never fails the flow :90-103; when no reranker is available, falls back
to graph-results-first then score-descending :173-202.  The reranker here
is an in-process callable (the on-device cross-encoder via the service layer)
instead of a remote rerank API."""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
from super_rag_tpu_torch.schema.model import Model

from super_rag_tpu_torch.nodeflow.models import register_node_runner
from super_rag_tpu_torch.nodeflow.types import DocsOutput, DocumentWithScore

logger = logging.getLogger(__name__)

MAX_RERANK_DOCS = 1000  # reference cap (rerank_service.py:37)


class RerankInput(Model):
    query: str = ""
    docs: list[DocumentWithScore] = []
    top_k: Optional[int] = None


def _fallback_order(docs: list[DocumentWithScore]) -> list[DocumentWithScore]:
    graph = [d for d in docs if d.recall_type == "graph_search"]
    rest = sorted(
        (d for d in docs if d.recall_type != "graph_search"),
        key=lambda d: -d.score,
    )
    return graph + rest


@register_node_runner("rerank", RerankInput, DocsOutput, title="Rerank",
                      description="Cross-encoder rerank with fallback")
async def run(node, inputs: RerankInput, ctx) -> DocsOutput:
    docs = inputs.docs[:MAX_RERANK_DOCS]
    query = inputs.query or ctx.system_input.query
    top_k = inputs.top_k or len(docs)
    reranker = ctx.services.get("reranker")
    if not docs:
        return DocsOutput()
    if reranker is None or not query:
        return DocsOutput(docs=_fallback_order(docs)[:top_k])
    try:
        scores = np.asarray(reranker(query, [d.text for d in docs]))
        order = np.argsort(-scores)
        out = [
            DocumentWithScore(
                text=docs[int(i)].text, score=float(scores[int(i)]),
                metadata=docs[int(i)].metadata, recall_type="reranked",
            )
            for i in order[:top_k]
        ]
        return DocsOutput(docs=out)
    except Exception:  # noqa: BLE001 — fall back instead of failing
        logger.exception("rerank degraded to heuristic ordering")
        return DocsOutput(docs=_fallback_order(docs)[:top_k])
