"""AG-UI protocol adapter: internal agent events -> AG-UI SSE events
(port of the JAX package's agent/ag_ui.py).

Counterpart of the reference's ag_ui/adapter.py (RunStarted /
TextMessageContent / ToolCall* / RunFinished event mapping).
"""

from __future__ import annotations

import json
import uuid
from typing import AsyncIterator


async def to_ag_ui(events: AsyncIterator[dict],
                   run_id: str | None = None) -> AsyncIterator[dict]:
    run_id = run_id or uuid.uuid4().hex
    msg_id = uuid.uuid4().hex
    yield {"event": "RunStarted", "data": {"runId": run_id}}
    started_text = False
    async for ev in events:
        kind = ev.get("event")
        data = ev.get("data", {})
        if kind == "tool_call":
            yield {"event": "ToolCallStart",
                   "data": {"runId": run_id, "toolCallId": uuid.uuid4().hex,
                            "toolName": data.get("tool", "")}}
            yield {"event": "ToolCallArgs",
                   "data": {"runId": run_id,
                            "args": json.dumps(data.get("arguments", {}))}}
        elif kind == "tool_result":
            yield {"event": "ToolCallEnd",
                   "data": {"runId": run_id,
                            "result": json.dumps(data.get("result"),
                                                 default=str)[:4000]}}
        elif kind == "delta":
            if not started_text:
                yield {"event": "TextMessageStart",
                       "data": {"runId": run_id, "messageId": msg_id,
                                "role": "assistant"}}
                started_text = True
            yield {"event": "TextMessageContent",
                   "data": {"runId": run_id, "messageId": msg_id,
                            "delta": data.get("text", "")}}
        elif kind in ("done", "references", "start"):
            if kind == "done" and started_text:
                yield {"event": "TextMessageEnd",
                       "data": {"runId": run_id, "messageId": msg_id}}
    yield {"event": "RunFinished", "data": {"runId": run_id}}
