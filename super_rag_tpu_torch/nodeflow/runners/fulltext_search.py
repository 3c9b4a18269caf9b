"""BM25 full-text node (port of the JAX package's runner) — the
standalone lexical node the reference declares but never shipped
(SURVEY.md section 3.1 'no standalone fulltext node'; lexical recall rode
inside SeekDB's hybrid query).  Here it is a first-class node over the
device-resident BM25 index."""

from __future__ import annotations

import logging
from typing import Optional

from super_rag_tpu_torch.engine.batcher import batched_search
from super_rag_tpu_torch.nodeflow.models import register_node_runner
from super_rag_tpu_torch.nodeflow.types import DocsOutput, DocumentWithScore
from super_rag_tpu_torch.schema.model import Model

logger = logging.getLogger(__name__)


class FulltextSearchInput(Model):
    query: str = ""
    top_k: int = 5
    collection_ids: list[str] = []
    chat_id: Optional[str] = None


@register_node_runner("fulltext_search", FulltextSearchInput, DocsOutput,
                      title="Fulltext Search",
                      description="BM25 lexical top-k on the device index")
async def run(node, inputs: FulltextSearchInput, ctx) -> DocsOutput:
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
                mode="fulltext",
                chat_id=inputs.chat_id or ctx.system_input.chat_id,
            )
            docs.extend(
                DocumentWithScore(
                    text=h.text, score=h.score,
                    metadata={**h.metadata, "collection_id": cid, "row": h.row},
                    recall_type="fulltext_search",
                )
                for h in hits
            )
        docs.sort(key=lambda d: -d.score)
        return DocsOutput(docs=docs[: inputs.top_k])
    except Exception:  # noqa: BLE001
        logger.exception("fulltext_search degraded to empty result")
        return DocsOutput()
