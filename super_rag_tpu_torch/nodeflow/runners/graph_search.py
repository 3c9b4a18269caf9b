"""Knowledge-graph search node (port of the JAX package's runner).

The reference delegates to the vendored graphiti/Neo4j stack
(nodeflow/runners/graph_search.py:66-79).  Our KG subsystem (kg/) is
in-process; this node queries it when the collection has a graph index
and degrades to empty otherwise — the same graceful-degradation contract
as every other recall node.  The search runs inline on the event loop's
thread, as in the reference."""

from __future__ import annotations

import logging

from super_rag_tpu_torch.nodeflow.models import register_node_runner
from super_rag_tpu_torch.nodeflow.types import DocsOutput, DocumentWithScore
from super_rag_tpu_torch.schema.model import Model

logger = logging.getLogger(__name__)


class GraphSearchInput(Model):
    query: str = ""
    top_k: int = 5
    collection_ids: list[str] = []


@register_node_runner("graph_search", GraphSearchInput, DocsOutput,
                      title="Graph Search",
                      description="Knowledge-graph hybrid search")
async def run(node, inputs: GraphSearchInput, ctx) -> DocsOutput:
    kg = ctx.services.get("kg")
    query = inputs.query or ctx.system_input.query
    if kg is None or not query:
        return DocsOutput()
    try:
        docs: list[DocumentWithScore] = []
        for cid in inputs.collection_ids or []:
            results = kg.search(cid, query, top_k=inputs.top_k)
            if not results:
                continue
            # render facts into one context doc, as the reference does
            # (graph results become a single document — :76-79)
            text = "\n".join(r["fact"] for r in results)
            docs.append(
                DocumentWithScore(
                    text=text,
                    score=max(r.get("score", 0.0) for r in results),
                    metadata={"collection_id": cid, "source": "graph"},
                    recall_type="graph_search",
                )
            )
        return DocsOutput(docs=docs)
    except Exception:  # noqa: BLE001
        logger.exception("graph_search degraded to empty result")
        return DocsOutput()
