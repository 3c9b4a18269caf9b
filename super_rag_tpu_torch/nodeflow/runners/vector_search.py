"""Dense-retrieval node over the device index (port of the JAX
package's runner).

Counterpart of the reference's vector_search runner
(nodeflow/runners/vector_search.py): top_k / similarity_threshold /
collection_ids / chat_id inputs :24-28, recall_type tagging :92, and
graceful degradation to an empty result on any engine error :95-105.
Unlike the reference (which searches only collection_ids[0] — :64), all
requested collections are searched and merged by score.
"""

from __future__ import annotations

import logging
from typing import Optional

from super_rag_tpu_torch.schema.model import Model

from super_rag_tpu_torch.engine.batcher import batched_search
from super_rag_tpu_torch.nodeflow.models import register_node_runner
from super_rag_tpu_torch.nodeflow.types import DocsOutput, DocumentWithScore

logger = logging.getLogger(__name__)


class VectorSearchInput(Model):
    query: str = ""
    top_k: int = 5
    similarity_threshold: Optional[float] = 0.2
    collection_ids: list[str] = []
    chat_id: Optional[str] = None
    index_types: Optional[list[str]] = None


@register_node_runner("vector_search", VectorSearchInput, DocsOutput,
                      title="Vector Search",
                      description="Dense top-k retrieval on the device index")
async def run(node, inputs: VectorSearchInput, ctx) -> DocsOutput:
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
                ctx.services, eng, query, top_k=inputs.top_k, mode="dense",
                similarity_threshold=inputs.similarity_threshold,
                chat_id=inputs.chat_id or ctx.system_input.chat_id,
                index_types=inputs.index_types,
            )
            docs.extend(
                DocumentWithScore(
                    text=h.text, score=h.score,
                    metadata={**h.metadata, "collection_id": cid, "row": h.row},
                    recall_type="vector_search",
                )
                for h in hits
            )
        docs.sort(key=lambda d: -d.score)
        return DocsOutput(docs=docs[: inputs.top_k])
    except Exception:  # noqa: BLE001 — degrade, never fail the flow
        logger.exception("vector_search degraded to empty result")
        return DocsOutput()
