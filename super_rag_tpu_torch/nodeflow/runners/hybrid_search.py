"""Hybrid-retrieval node: the fused dense ⊕ BM25 ⊕ RRF device program
(port of the JAX package's runner).

The built-in search flow uses this single node (one dispatch per
collection) instead of separate vector_search + fulltext_search branches
+ host merge — the 'nodes become thin wrappers over engine calls' design
stance (SURVEY.md 7.1).  The separate nodes remain available for
user-authored DAGs that want independent branches.
"""

from __future__ import annotations

import logging
from typing import Optional

from super_rag_tpu_torch.schema.model import Model

from super_rag_tpu_torch.engine.batcher import batched_search
from super_rag_tpu_torch.nodeflow.models import register_node_runner
from super_rag_tpu_torch.nodeflow.types import DocsOutput, DocumentWithScore

logger = logging.getLogger(__name__)


class HybridSearchInput(Model):
    query: str = ""
    top_k: int = 5
    candidates: int = 100
    collection_ids: list[str] = []
    chat_id: Optional[str] = None
    rrf_k: int = 60


@register_node_runner("hybrid_search", HybridSearchInput, DocsOutput,
                      title="Hybrid Search",
                      description="Fused dense+BM25+RRF in one device program")
async def run(node, inputs: HybridSearchInput, ctx) -> DocsOutput:
    engines = ctx.services.get("engines")
    db = ctx.services.get("db")
    query = inputs.query or ctx.system_input.query
    if engines is None or not query:
        return DocsOutput()
    docs: list[DocumentWithScore] = []
    try:
        for cid in inputs.collection_ids or []:
            config = {}
            if db is not None:
                coll = db.get_collection(cid)
                if coll is None:
                    continue
                config = coll["config"]
            eng = engines.get(cid, config)
            hits = await batched_search(
                ctx.services, eng, query, top_k=inputs.top_k,
                mode="hybrid", candidates=inputs.candidates,
                chat_id=inputs.chat_id or ctx.system_input.chat_id,
                rrf_k=inputs.rrf_k,
            )
            docs.extend(
                DocumentWithScore(
                    text=h.text, score=h.score,
                    metadata={**h.metadata, "collection_id": cid,
                              "row": h.row},
                    recall_type="hybrid",
                )
                for h in hits
            )
        docs.sort(key=lambda d: -d.score)
        return DocsOutput(docs=docs[: inputs.top_k])
    except Exception:  # noqa: BLE001 — degrade, never fail the flow
        logger.exception("hybrid_search degraded to empty result")
        return DocsOutput()
