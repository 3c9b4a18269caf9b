"""Workflow persistence + execution with per-node run recording (port of
the JAX package's service/workflow_service.py).

Counterpart of the reference's workflow_service (CRUD/versions/run —
service/workflow_service.py), flow_service.run_workflow_once
(flow_service.py:43-82) and WorkflowRunRecorder (workflow_run_recorder.py)
which persists workflow_run / node_run rows from engine events.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from super_rag_tpu_torch.api.http import HttpError
from super_rag_tpu_torch.nodeflow.engine import (
    EVENT_NODE_END,
    EVENT_NODE_ERROR,
    NodeflowEngine,
)
from super_rag_tpu_torch.nodeflow.models import SystemInput
from super_rag_tpu_torch.nodeflow.parser import NodeflowParser
import super_rag_tpu_torch.nodeflow.runners  # noqa: F401
from super_rag_tpu_torch.service.context import AppContext
from super_rag_tpu_torch.store.models import WorkflowRunStatus


class WorkflowRunRecorder:
    def __init__(self, ctx: AppContext, run_id: str):
        self.ctx = ctx
        self.run_id = run_id
        self.events: list[dict] = []

    def __call__(self, event: dict) -> None:
        self.events.append(event)
        if event["event"] == EVENT_NODE_END:
            self.ctx.db.add_node_run(
                self.run_id, event["node_id"], event.get("type", ""),
                "SUCCESS", {}, event.get("outputs") or {},
                duration_ms=event.get("duration_ms", 0),
            )
        elif event["event"] == EVENT_NODE_ERROR:
            self.ctx.db.add_node_run(
                self.run_id, event["node_id"], event.get("type", ""),
                "FAILED", {}, {}, error=event.get("error", ""),
                duration_ms=event.get("duration_ms", 0),
            )


class WorkflowService:
    def __init__(self, ctx: AppContext):
        self.ctx = ctx
        self.parser = NodeflowParser()

    # -- CRUD ----------------------------------------------------------------

    def create(self, user: str, title: str, definition: dict,
               description: str = "") -> dict:
        self.parser.parse(definition)  # validate up front
        return self.ctx.db.create_workflow(user, title, definition, description)

    def get(self, user: str, wid: str) -> dict:
        wf = self.ctx.db.get_workflow(wid)
        if wf is None or wf["user"] != user:
            raise HttpError(404, f"workflow {wid} not found")
        return wf

    def list(self, user: str) -> list[dict]:
        return self.ctx.db.list_workflows(user)

    def update_definition(self, user: str, wid: str, definition: dict) -> dict:
        self.get(user, wid)
        self.parser.parse(definition)
        self.ctx.db.add_workflow_version(wid, definition)
        return self.ctx.db.get_workflow(wid)

    def delete(self, user: str, wid: str) -> None:
        self.get(user, wid)
        self.ctx.db.delete_workflow(wid)

    def versions(self, user: str, wid: str) -> list[dict]:
        self.get(user, wid)
        return self.ctx.db.list_workflow_versions(wid)

    def version_detail(self, user: str, wid: str, version: int) -> dict:
        self.get(user, wid)
        row = self.ctx.db.get_workflow_version(wid, version)
        if row is None:
            raise HttpError(404, f"version {version} not found")
        return row

    def create_version(self, user: str, wid: str,
                       definition: Optional[dict] = None) -> dict:
        """Snapshot a new version; body may carry a fresh definition or
        omit it to snapshot the current one (reference api/workflow.py:63)."""
        wf = self.get(user, wid)
        if definition is None:
            definition = wf["definition"]
        else:
            self.parser.parse(definition)
        nv = self.ctx.db.add_workflow_version(wid, definition)
        return self.ctx.db.get_workflow_version(wid, nv)

    def runs(self, user: str, wid: str) -> list[dict]:
        self.get(user, wid)
        return self.ctx.db.list_workflow_runs(wid)

    def run_detail(self, user: str, run_id: str) -> dict:
        run = self.ctx.db.get_workflow_run(run_id)
        if run is None or (run["user"] and run["user"] != user):
            raise HttpError(404, f"run {run_id} not found")
        run["node_runs"] = self.ctx.db.list_node_runs(run_id)
        return run

    # -- execution -------------------------------------------------------------

    async def run(self, user: str, wid: str, inputs: dict) -> dict:
        wf = self.get(user, wid)
        return await self.run_definition(
            user, wf["definition"], inputs, workflow_id=wid,
            version=wf["version"],
        )

    async def run_definition_streaming(self, user: str, definition: dict,
                                       inputs: dict, workflow_id: str = "",
                                       version: int = 1):
        """Async generator of engine events + a final result event
        (reference flow_service.py:84 SSE streaming)."""
        queue: asyncio.Queue = asyncio.Queue()
        flow, defaults = self.parser.parse(definition)
        run = self.ctx.db.create_workflow_run(workflow_id, user, inputs, version)
        recorder = WorkflowRunRecorder(self.ctx, run["id"])

        def on_event(event: dict) -> None:
            recorder(event)
            queue.put_nowait(event)

        engine = NodeflowEngine(on_event=on_event)
        globals_ = {**defaults, **(inputs or {})}
        sysin = SystemInput(query=str(globals_.get("query", "")), user=user,
                            chat_id=globals_.get("chat_id"))

        async def execute():
            try:
                ctx = await engine.execute_nodeflow(
                    flow, sysin, globals_=globals_,
                    services=self.ctx.services_for_nodeflow(),
                )
                outputs = {
                    nid: (o.model_dump() if hasattr(o, "model_dump") else o)
                    for nid, o in ctx.outputs.items()
                }
                self.ctx.db.finish_workflow_run(
                    run["id"], WorkflowRunStatus.SUCCESS.value, outputs
                )
                queue.put_nowait({"event": "RESULT",
                                  "run_id": run["id"],
                                  "status": "SUCCESS", "outputs": outputs})
            except Exception as e:  # noqa: BLE001
                self.ctx.db.finish_workflow_run(
                    run["id"], WorkflowRunStatus.FAILED.value, {}, error=str(e)
                )
                queue.put_nowait({"event": "RESULT", "run_id": run["id"],
                                  "status": "FAILED", "error": str(e)})
            queue.put_nowait(None)

        task = asyncio.create_task(execute())
        try:
            while True:
                ev = await queue.get()
                if ev is None:
                    break
                yield ev
        finally:
            await task

    async def run_definition(self, user: str, definition: dict, inputs: dict,
                             workflow_id: str = "", version: int = 1) -> dict:
        """One-shot execution (reference api/flow.py:16 + flow_service)."""
        flow, defaults = self.parser.parse(definition)
        run = self.ctx.db.create_workflow_run(workflow_id, user, inputs, version)
        recorder = WorkflowRunRecorder(self.ctx, run["id"])
        engine = NodeflowEngine(on_event=recorder)
        globals_ = {**defaults, **(inputs or {})}
        sysin = SystemInput(
            query=str(globals_.get("query", "")), user=user,
            chat_id=globals_.get("chat_id"),
        )
        try:
            ctx = await engine.execute_nodeflow(
                flow, sysin, globals_=globals_,
                services=self.ctx.services_for_nodeflow(),
            )
        except Exception as e:  # noqa: BLE001
            self.ctx.db.finish_workflow_run(
                run["id"], WorkflowRunStatus.FAILED.value, {}, error=str(e)
            )
            raise HttpError(422, f"workflow failed: {e}") from e
        outputs = {
            nid: (out.model_dump() if hasattr(out, "model_dump") else out)
            for nid, out in ctx.outputs.items()
        }
        self.ctx.db.finish_workflow_run(
            run["id"], WorkflowRunStatus.SUCCESS.value, outputs
        )
        return {"run_id": run["id"], "status": "SUCCESS", "outputs": outputs}
