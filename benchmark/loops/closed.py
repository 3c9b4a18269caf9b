"""Closed loop: ``clients`` asyncio clients in the run's process, each
sending its next query as soon as its last answer arrives.

Client i sends the pool's queries i, i + C, i + 2C, ... (C clients).  The
clients start together; the window opens once every client has had an
answer and ``ramp_dispatches`` dispatches have ended, so that the
batches are in their steady pattern.  No query is sent after the window
closes; those in flight are awaited (``drain_s`` at most) and a request
that never answers counts as failed.
"""

from __future__ import annotations

import asyncio
import time


async def drive(submit, queries: list, traffic: dict, seconds: float, hooks) -> dict:
    """``submit(query)`` is the coroutine that serves one query;
    ``hooks.dispatches()`` counts the dispatches so far, ``hooks.opened(t)``
    and ``hooks.closed(t)`` run when the window opens and closes, and
    ``hooks.answered(request, answer)`` sees each answer.  Returns every
    request as a ``(client, query, sent, answered or None)`` tuple (tuples
    of plain values, which the collector stops tracking, so that the log
    does not change how often the program's collections run) and the
    window."""
    clients = traffic["clients"]
    requests: list = []
    answered: set = set()
    opened = asyncio.Event()
    window: list = []
    ramp = traffic["ramp_dispatches"]
    start_dispatches = hooks.dispatches()
    in_flight: dict = {}

    async def client(i: int) -> None:
        j = 0
        while not (window and time.perf_counter() >= window[1]):
            q = queries[(i + j * clients) % len(queries)]
            j += 1
            sent = in_flight[i] = (i, q, time.perf_counter(), None)
            answer = await submit(q)
            done = (i, q, sent[2], time.perf_counter())
            del in_flight[i]
            requests.append(done)
            hooks.answered(done, answer)
            answered.add(i)
            if (not opened.is_set() and len(answered) == clients
                    and hooks.dispatches() - start_dispatches >= ramp):
                opened.set()

    tasks = [asyncio.ensure_future(client(i)) for i in range(clients)]
    try:
        await asyncio.wait_for(opened.wait(), traffic["ramp_timeout_s"])
        t0 = time.perf_counter()
        window[:] = [t0, t0 + seconds]
        hooks.opened(t0)
        await asyncio.sleep(seconds)
        hooks.closed(time.perf_counter())
        await asyncio.wait(tasks, timeout=traffic["drain_s"])
    finally:
        for t in tasks:
            if not t.done():
                t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
    requests.extend(in_flight.values())  # never answered
    return {"requests": requests, "window": tuple(window)}
