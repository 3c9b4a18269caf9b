"""The port's nodeflow: the DAG engine, its parser and the runner
registry (port of the JAX package's nodeflow)."""

from super_rag_tpu_torch.nodeflow.models import (
    Edge,
    ExecutionContext,
    NodeInstance,
    NodeflowInstance,
    SystemInput,
    register_node_runner,
    NODE_RUNNER_REGISTRY,
)
from super_rag_tpu_torch.nodeflow.engine import NodeflowEngine
from super_rag_tpu_torch.nodeflow.parser import NodeflowParser

__all__ = [
    "Edge",
    "ExecutionContext",
    "NodeInstance",
    "NodeflowInstance",
    "SystemInput",
    "register_node_runner",
    "NODE_RUNNER_REGISTRY",
    "NodeflowEngine",
    "NodeflowParser",
]
