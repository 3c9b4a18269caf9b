"""Merge node: union + dedup of recall branches (port of the JAX
package's runner).

Counterpart of the reference merge runner (nodeflow/runners/merge.py:
45-65 — union of vector/fulltext/graph/summary/vision doc lists with
exact-text dedup; 'union' is the only strategy).  Adds an optional 'rrf'
strategy that fuses by reciprocal rank instead of keeping raw scores."""

from __future__ import annotations

from typing import Optional

from super_rag_tpu_torch.nodeflow.models import register_node_runner
from super_rag_tpu_torch.nodeflow.types import DocsOutput, DocumentWithScore
from super_rag_tpu_torch.schema.model import Model


class MergeInput(Model):
    docs: Optional[list[DocumentWithScore]] = None
    vector_docs: Optional[list[DocumentWithScore]] = None
    fulltext_docs: Optional[list[DocumentWithScore]] = None
    graph_docs: Optional[list[DocumentWithScore]] = None
    summary_docs: Optional[list[DocumentWithScore]] = None
    vision_docs: Optional[list[DocumentWithScore]] = None
    strategy: str = "union"  # union | rrf
    rrf_k: int = 60


@register_node_runner("merge", MergeInput, DocsOutput, title="Merge",
                      description="Union + dedup of recall branches")
async def run(node, inputs: MergeInput, ctx) -> DocsOutput:
    branches = [
        b for b in (
            inputs.docs, inputs.vector_docs, inputs.fulltext_docs,
            inputs.graph_docs, inputs.summary_docs, inputs.vision_docs,
        )
        if b
    ]
    if inputs.strategy == "rrf":
        scores: dict[str, float] = {}
        keep: dict[str, DocumentWithScore] = {}
        for branch in branches:
            for rank, d in enumerate(branch):
                s = 1.0 / (inputs.rrf_k + rank + 1)
                scores[d.text] = scores.get(d.text, 0.0) + s
                keep.setdefault(d.text, d)
        out = [
            DocumentWithScore(
                text=t, score=scores[t], metadata=keep[t].metadata,
                recall_type=keep[t].recall_type,
            )
            for t in sorted(scores, key=lambda t: -scores[t])
        ]
        return DocsOutput(docs=out)

    # union with exact-text dedup (first occurrence wins)
    seen: set[str] = set()
    out = []
    for branch in branches:
        for d in branch:
            if d.text in seen:
                continue
            seen.add(d.text)
            out.append(d)
    return DocsOutput(docs=out)
