"""Nodeflow execution engine (port of the JAX package's nodeflow/engine.py).

Re-design of the reference engine (super_rag/nodeflow/engine.py):
topological sort :156-194, level-parallel groups via asyncio.gather
:196-243, {{ nodes.X.output.Y }} / {{ globals.* }} / {{ sys.* }} variable
resolution with Jinja2 for mixed strings :245-324, input-model binding
:384-398, NODE_START/END/ERROR events with duration_ms :408-464.
"""

from __future__ import annotations

import asyncio
import re
import time
from typing import Any, Callable, Optional

import jinja2
import jinja2.sandbox
from super_rag_tpu_torch.schema.model import Model

from super_rag_tpu_torch.nodeflow.models import (
    NODE_RUNNER_REGISTRY,
    ExecutionContext,
    NodeInstance,
    NodeflowInstance,
    SystemInput,
)

# a string that is exactly one template expression returns the raw value
_SINGLE_EXPR = re.compile(r"^\{\{\s*([\w.\[\]]+)\s*\}\}$")

EVENT_FLOW_START = "FLOW_START"
EVENT_FLOW_END = "FLOW_END"
EVENT_NODE_START = "NODE_START"
EVENT_NODE_END = "NODE_END"
EVENT_NODE_ERROR = "NODE_ERROR"


class NodeflowError(Exception):
    pass


class NodeflowEngine:
    def __init__(self, on_event: Optional[Callable[[dict], Any]] = None):
        self.on_event = on_event
        # workflow graphs arrive from the public API, so `{{ }}` exprs are
        # user-controlled — render them only inside the jinja2 sandbox
        self._jinja = jinja2.sandbox.SandboxedEnvironment(
            undefined=jinja2.Undefined
        )

    # -- scheduling --------------------------------------------------------

    def _levels(self, flow: NodeflowInstance) -> list[list[NodeInstance]]:
        """Kahn layering: nodes whose deps are all satisfied run together."""
        by_id = {n.id: n for n in flow.nodes}
        indeg = {n.id: 0 for n in flow.nodes}
        adj: dict[str, list[str]] = {n.id: [] for n in flow.nodes}
        for e in flow.edges:
            adj[e.source].append(e.target)
            indeg[e.target] += 1
        level = [nid for nid, d in indeg.items() if d == 0]
        out: list[list[NodeInstance]] = []
        while level:
            out.append([by_id[n] for n in level])
            nxt: list[str] = []
            for nid in level:
                for t in adj[nid]:
                    indeg[t] -= 1
                    if indeg[t] == 0:
                        nxt.append(t)
            level = nxt
        return out

    # -- variable resolution --------------------------------------------------

    def _lookup(self, path: str, ctx: ExecutionContext) -> Any:
        parts = path.split(".")
        # a single expression bypasses the sandbox, so it may name no
        # private or dunder attribute (``sys.__class__.__init__...``)
        if any(p.startswith("_") for p in parts):
            return None
        if parts[0] == "nodes" and len(parts) >= 3 and parts[2] == "output":
            out = ctx.outputs.get(parts[1])
            cur: Any = out
            for p in parts[3:]:
                if isinstance(cur, Model):
                    cur = getattr(cur, p, None)
                elif isinstance(cur, dict):
                    cur = cur.get(p)
                else:
                    cur = getattr(cur, p, None)
            return cur
        if parts[0] == "globals":
            cur = ctx.globals
            for p in parts[1:]:
                cur = cur.get(p) if isinstance(cur, dict) else getattr(cur, p, None)
            return cur
        if parts[0] == "sys":
            cur = ctx.system_input
            for p in parts[1:]:
                cur = getattr(cur, p, None)
            return cur
        return None

    def resolve_value(self, value: Any, ctx: ExecutionContext) -> Any:
        if isinstance(value, str):
            m = _SINGLE_EXPR.match(value.strip())
            if m:
                return self._lookup(m.group(1), ctx)
            if "{{" in value:
                tmpl = self._jinja.from_string(value)
                return tmpl.render(
                    nodes={
                        nid: {"output": out.model_dump() if isinstance(out, Model) else out}
                        for nid, out in ctx.outputs.items()
                    },
                    globals=ctx.globals,
                    sys=ctx.system_input.model_dump(),
                )
            return value
        if isinstance(value, dict):
            return {k: self.resolve_value(v, ctx) for k, v in value.items()}
        if isinstance(value, list):
            return [self.resolve_value(v, ctx) for v in value]
        return value

    # -- execution ----------------------------------------------------------------

    async def _emit(self, event: dict) -> None:
        if self.on_event is None:
            return
        r = self.on_event(event)
        if asyncio.iscoroutine(r):
            await r

    async def _execute_node(self, node: NodeInstance, flow: NodeflowInstance,
                            ctx: ExecutionContext) -> None:
        entry = NODE_RUNNER_REGISTRY.get(node.type)
        if entry is None:
            raise NodeflowError(f"no runner registered for type {node.type!r}")
        resolved = self.resolve_value(dict(node.input_values), ctx)
        # edges without explicit input_values bind source output wholesale:
        # target_handle <- source's output field (or whole output)
        for e in flow.edges:
            if e.target != node.id or e.target_handle in resolved:
                continue
            src_out = ctx.outputs.get(e.source)
            if src_out is None:
                continue
            if e.source_handle not in ("output", "", None) and isinstance(
                src_out, Model
            ):
                resolved[e.target_handle] = getattr(src_out, e.source_handle, None)
            elif isinstance(src_out, Model) and e.target_handle in type(
                src_out
            ).model_fields:
                # same-named field on the source output binds directly
                # (start.query -> vector_search.query)
                resolved[e.target_handle] = getattr(src_out, e.target_handle)
            else:
                resolved[e.target_handle] = (
                    src_out.model_dump()
                    if isinstance(src_out, Model)
                    else src_out
                )
        # keep only fields the input model knows
        known = set(entry.input_model.model_fields)
        filtered = {k: v for k, v in resolved.items() if k in known and v is not None}
        inputs = entry.input_model(**filtered)

        t0 = time.perf_counter()
        await self._emit(
            {"event": EVENT_NODE_START, "node_id": node.id, "type": node.type,
             "inputs": inputs.model_dump()}
        )
        try:
            out = await entry.fn(node, inputs, ctx)
        except Exception as e:
            await self._emit(
                {"event": EVENT_NODE_ERROR, "node_id": node.id,
                 "type": node.type, "error": str(e),
                 "duration_ms": (time.perf_counter() - t0) * 1000}
            )
            raise
        ctx.outputs[node.id] = out
        await self._emit(
            {"event": EVENT_NODE_END, "node_id": node.id, "type": node.type,
             "duration_ms": (time.perf_counter() - t0) * 1000,
             "outputs": out.model_dump() if isinstance(out, Model) else out}
        )

    async def execute_nodeflow(
        self,
        flow: NodeflowInstance,
        system_input: SystemInput,
        globals_: Optional[dict] = None,
        services: Optional[dict] = None,
    ) -> ExecutionContext:
        flow.validate()
        ctx = ExecutionContext(
            system_input=system_input,
            globals=dict(globals_ or {}),
            services=dict(services or {}),
        )
        await self._emit({"event": EVENT_FLOW_START, "flow": flow.name})
        for group in self._levels(flow):
            if len(group) == 1:
                await self._execute_node(group[0], flow, ctx)
            else:
                await asyncio.gather(
                    *(self._execute_node(n, flow, ctx) for n in group)
                )
        await self._emit({"event": EVENT_FLOW_END, "flow": flow.name})
        return ctx
