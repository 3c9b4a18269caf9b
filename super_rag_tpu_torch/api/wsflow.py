"""WebSocket streaming with stop/cancel support (port of the JAX
package's api/wsflow.py).

The reference's chat WebSocket protocol accepts control frames while a
generation is streaming (agent_chat_service.py:112 parses message types;
stop aborts the in-flight turn).  Cancelling a blocked ``receive`` mid-
frame would corrupt RFC6455 framing, so instead each connection runs one
reader task that funnels frames into a queue; the event pump drains the
queue between generation events and aborts on a stop/cancel frame.
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterator, Awaitable, Callable, Optional

STOP_TYPES = ("stop", "cancel")


def start_reader(ws, inbox: asyncio.Queue) -> asyncio.Task:
    """Funnel incoming frames into ``inbox``; None marks connection end."""

    async def reader():
        try:
            while True:
                msg = await ws.receive_json()
                await inbox.put(msg)
                if msg is None:
                    return
        except (ConnectionError, asyncio.IncompleteReadError):
            await inbox.put(None)

    return asyncio.create_task(reader())


async def pump(
    gen: AsyncIterator[dict],
    inbox: asyncio.Queue,
    send: Callable[[dict], Awaitable[None]],
) -> tuple[str, list[dict]]:
    """Stream ``gen``'s events through ``send``; between events, drain
    control frames from ``inbox``.  A stop/cancel frame closes the
    generator and emits a ``stopped`` event.  Returns
    ``(outcome, leftover)`` where outcome is done|stopped|closed and
    leftover holds non-control frames that arrived mid-generation (the
    caller processes them as queued messages)."""
    leftover: list[dict] = []
    outcome = "done"
    agen = gen.__aiter__()
    while True:
        stopped = closed = False
        while True:
            try:
                m = inbox.get_nowait()
            except asyncio.QueueEmpty:
                break
            if m is None:
                closed = True
                break
            if isinstance(m, dict) and m.get("type") in STOP_TYPES:
                stopped = True
                break
            leftover.append(m)
        if closed or stopped:
            await agen.aclose()
            if stopped:
                await send({"event": "stopped", "data": {}})
            outcome = "closed" if closed else "stopped"
            break
        try:
            event = await agen.__anext__()
        except StopAsyncIteration:
            break
        await send(event)
    return outcome, leftover


async def next_message(inbox: asyncio.Queue,
                       leftover: list[dict]) -> Optional[dict]:
    """Next user frame: queued leftovers first, then the reader queue.
    Bare stop/cancel frames outside a generation are ignored."""
    while True:
        msg = leftover.pop(0) if leftover else await inbox.get()
        if msg is None:
            return None
        if isinstance(msg, dict) and msg.get("type") in STOP_TYPES:
            continue
        return msg
