"""Workflow graph parser: JSON/YAML React-Flow-like format -> NodeflowInstance
(port of the JAX package's nodeflow/parser.py; YAML text goes through the
port's own subset, ``nodeflow/yamlsub.py``, where the JAX package calls
``yaml.safe_load``).

Re-design of the reference parser (super_rag/nodeflow/parser.py:31-118:
graph.nodes/graph.edges with sourceHandle/targetHandle, data.input_values,
workflow input_schema -> globals mapping; port compatibility check
:195-226)."""

from __future__ import annotations

import json
from typing import Any

from super_rag_tpu_torch.nodeflow import yamlsub
from super_rag_tpu_torch.nodeflow.models import (
    NODE_RUNNER_REGISTRY,
    Edge,
    NodeInstance,
    NodeflowInstance,
)


class NodeflowParser:
    def parse(self, definition: dict | str) -> tuple[NodeflowInstance, dict]:
        """Returns (flow, defaults) where defaults are globals from the
        workflow's input_schema defaults."""
        if isinstance(definition, str):
            definition = (
                json.loads(definition)
                if definition.lstrip().startswith("{")
                else yamlsub.load(definition)
            )
        graph = definition.get("graph", definition)
        nodes = []
        for n in graph.get("nodes", []):
            data = n.get("data", {})
            nodes.append(
                NodeInstance(
                    id=n["id"],
                    type=n.get("type") or data.get("type", ""),
                    title=data.get("title", n.get("id")),
                    input_values=dict(data.get("input_values", data.get("input", {}))),
                )
            )
        edges = [
            Edge(
                source=e["source"],
                target=e["target"],
                source_handle=e.get("sourceHandle", "output") or "output",
                target_handle=e.get("targetHandle", "input") or "input",
            )
            for e in graph.get("edges", [])
        ]
        flow = NodeflowInstance(
            name=definition.get("name", "workflow"),
            title=definition.get("title", ""),
            nodes=nodes,
            edges=edges,
        )
        flow.validate()
        self._check_ports(flow)

        defaults: dict[str, Any] = {}
        for name, schema in (definition.get("input_schema") or {}).items():
            if isinstance(schema, dict) and "default" in schema:
                defaults[name] = schema["default"]
        return flow, defaults

    def _check_ports(self, flow: NodeflowInstance) -> None:
        """Static check: target handles must exist on the target's input
        model (when the runner is known)."""
        for e in flow.edges:
            target = next(n for n in flow.nodes if n.id == e.target)
            entry = NODE_RUNNER_REGISTRY.get(target.type)
            if entry is None:
                continue
            if e.target_handle not in entry.input_model.model_fields:
                raise ValueError(
                    f"edge {e.source}->{e.target}: target node type "
                    f"{target.type!r} has no input port {e.target_handle!r}"
                )
