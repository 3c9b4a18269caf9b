"""Start node: echoes the system query (port of the JAX package's
runner; reference runners/start.py:21-27)."""

from __future__ import annotations

from super_rag_tpu_torch.schema.model import Model

from super_rag_tpu_torch.nodeflow.models import register_node_runner
from super_rag_tpu_torch.nodeflow.types import StartOutput


class StartInput(Model):
    query: str = ""


@register_node_runner("start", StartInput, StartOutput,
                      title="Start", description="Entry point: emits the query")
async def run(node, inputs: StartInput, ctx) -> StartOutput:
    return StartOutput(query=inputs.query or ctx.system_input.query)
