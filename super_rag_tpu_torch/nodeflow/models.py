"""Nodeflow data model: nodes, edges, validation, runner registry and
the node-type catalog (port of the JAX package's nodeflow/models.py, on
the port's own ``Model``).

Re-design of the reference's nodeflow base models
(super_rag/nodeflow/base/models.py: NodeInstance :13, Edge :27,
NodeflowInstance + cycle validation :40-86, ExecutionContext :90-119,
NODE_RUNNER_REGISTRY + @register_node_runner :122-144, SystemInput
:147-168).  Runners are async callables registered per node type with
input/output models; the engine binds resolved inputs to the
input model and stores the output model instance in the context.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Type

from super_rag_tpu_torch.schema.model import Model


class SystemInput(Model):
    query: str = ""
    user: str = ""
    chat_id: Optional[str] = None
    history: list[dict] = []


@dataclass
class NodeInstance:
    id: str
    type: str
    title: str = ""
    input_values: dict = field(default_factory=dict)


@dataclass
class Edge:
    source: str
    target: str
    source_handle: str = "output"
    target_handle: str = "input"


@dataclass
class NodeflowInstance:
    name: str
    nodes: list[NodeInstance]
    edges: list[Edge]
    title: str = ""

    def validate(self) -> None:
        ids = [n.id for n in self.nodes]
        if len(ids) != len(set(ids)):
            raise ValueError("duplicate node ids")
        known = set(ids)
        for e in self.edges:
            if e.source not in known or e.target not in known:
                raise ValueError(
                    f"edge references unknown node: {e.source}->{e.target}"
                )
        self._check_acyclic()

    def _check_acyclic(self) -> None:
        adj: dict[str, list[str]] = {n.id: [] for n in self.nodes}
        indeg: dict[str, int] = {n.id: 0 for n in self.nodes}
        for e in self.edges:
            adj[e.source].append(e.target)
            indeg[e.target] += 1
        frontier = [n for n, d in indeg.items() if d == 0]
        seen = 0
        while frontier:
            cur = frontier.pop()
            seen += 1
            for nxt in adj[cur]:
                indeg[nxt] -= 1
                if indeg[nxt] == 0:
                    frontier.append(nxt)
        if seen != len(self.nodes):
            raise ValueError("workflow graph contains a cycle")

    def upstream(self, node_id: str) -> list[str]:
        return [e.source for e in self.edges if e.target == node_id]


@dataclass
class ExecutionContext:
    system_input: SystemInput
    globals: dict = field(default_factory=dict)
    outputs: dict = field(default_factory=dict)  # node_id -> output model
    system_outputs: dict = field(default_factory=dict)  # node_id -> metadata
    services: dict = field(default_factory=dict)  # engines/db/etc for runners

    def output_of(self, node_id: str) -> Any:
        return self.outputs.get(node_id)


@dataclass
class RunnerEntry:
    fn: Callable  # async (node, inputs: InputModel, ctx) -> OutputModel
    input_model: Type[Model]
    output_model: Type[Model]
    title: str = ""
    description: str = ""


NODE_RUNNER_REGISTRY: dict[str, RunnerEntry] = {}


def register_node_runner(
    node_type: str,
    input_model: Type[Model],
    output_model: Type[Model],
    title: str = "",
    description: str = "",
):
    def deco(fn):
        NODE_RUNNER_REGISTRY[node_type] = RunnerEntry(
            fn=fn, input_model=input_model, output_model=output_model,
            title=title or node_type, description=description,
        )
        return fn

    return deco


def node_type_catalog() -> list[dict]:
    """Metadata for /nodeflow/node-types (reference api/nodeflow.py:12)."""
    out = []
    for t, entry in sorted(NODE_RUNNER_REGISTRY.items()):
        out.append(
            {
                "type": t,
                "title": entry.title,
                "description": entry.description,
                "input_schema": entry.input_model.model_json_schema(),
                "output_schema": entry.output_model.model_json_schema(),
            }
        )
    return out
