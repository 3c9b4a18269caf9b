"""LLM answer node: context assembly + completion (port of the JAX
package's runner).

Counterpart of the reference llm runner (nodeflow/runners/llm.py): token
budget from model config :71+, context truncation with a reserve for the
answer :27-33, prompt assembly from docs, reference extraction.  The
completion client is pluggable (ctx.services['completion']), mirroring
the reference's LiteLLM indirection — remote LLMs stay off the hot path
(SURVEY.md section 2.9)."""

from __future__ import annotations

import logging

from super_rag_tpu_torch.chunk.chunking import approx_token_count
from super_rag_tpu_torch.llm.prompts import RAG_ANSWER as DEFAULT_PROMPT
from super_rag_tpu_torch.nodeflow.models import register_node_runner
from super_rag_tpu_torch.nodeflow.types import AnswerOutput, DocumentWithScore
from super_rag_tpu_torch.schema.model import Model

logger = logging.getLogger(__name__)


class LLMInput(Model):
    query: str = ""
    docs: list[DocumentWithScore] = []
    prompt_template: str = ""
    context_window: int = 8192
    reserve_output_tokens: int = 1024
    temperature: float = 0.1


def build_context(docs: list[DocumentWithScore], budget: int) -> tuple[str, list[dict]]:
    """Greedy context packing under a token budget; returns (context,
    references actually included)."""
    pieces: list[str] = []
    refs: list[dict] = []
    used = 0
    for i, d in enumerate(docs):
        n = approx_token_count(d.text) + 8
        if used + n > budget and pieces:
            break
        used += n
        pieces.append(f"[{i + 1}] {d.text}")
        refs.append({"index": i + 1, "score": d.score, **d.metadata})
    return "\n\n".join(pieces), refs


@register_node_runner("llm", LLMInput, AnswerOutput, title="LLM",
                      description="Generate an answer from retrieved context")
async def run(node, inputs: LLMInput, ctx) -> AnswerOutput:
    completion = ctx.services.get("completion")
    query = inputs.query or ctx.system_input.query
    template = inputs.prompt_template or DEFAULT_PROMPT
    budget = max(
        256,
        inputs.context_window
        - inputs.reserve_output_tokens
        - approx_token_count(template)
        - approx_token_count(query),
    )
    context, refs = build_context(inputs.docs, budget)
    prompt = template.format(context=context, query=query)
    if completion is None:
        # no model configured: echo top context (keeps flows runnable in
        # fully offline deployments and tests)
        text = inputs.docs[0].text if inputs.docs else ""
        return AnswerOutput(text=text, docs=inputs.docs, references=refs)
    result = completion(prompt=prompt, temperature=inputs.temperature)
    if hasattr(result, "__await__"):
        result = await result
    return AnswerOutput(text=str(result), docs=inputs.docs, references=refs)
