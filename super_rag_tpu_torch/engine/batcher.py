"""Dynamic micro-batching for concurrent searches (port of
the JAX package's engine/batcher.py).

Concurrent requests with identical search parameters coalesce into ONE
``search_batch`` device call: while the single worker thread is busy,
arrivals accumulate and go out together as the next batch.  The asyncio
loop stays free while the device computes, and device access stays
serialized.  ``close()`` shuts the worker down, so a process that made a
batcher can exit.
"""

from __future__ import annotations

import asyncio
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Hashable, Optional

from super_rag_tpu_torch.trace.tracing import get_tracer

_TRACE = get_tracer()


def _freeze(v: Any) -> Hashable:
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, set):
        return tuple(sorted(v))
    return v


class QueryBatcher:
    """Coalesces same-parameter engine searches into one device call.

    Dynamic batching: while the (single) device worker is BUSY, arriving
    requests accumulate and the completion callback dispatches them all
    as one batch — so the effective batch size tracks the arrival rate
    times the device latency, not the fixed window.  The window only
    bounds latency when the worker is idle.
    """

    def __init__(self, max_batch: int = 64, max_wait_ms: float = 0.0):
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        # (query, future, enqueue perf_counter while stage spans record)
        self._pending: dict[tuple, list[tuple[str, asyncio.Future, Optional[float]]]] = {}
        self._engines: dict[tuple, tuple[Any, dict]] = {}
        self._executor = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="batcher")
        self._busy = False  # loop-thread-only state
        # observability: how much coalescing actually happens
        self.dispatches = 0
        self.queries = 0

    async def search(self, engine: Any, query: str, **params) -> list:
        """Awaitable single-query search; batches with concurrent peers."""
        loop = asyncio.get_running_loop()
        key = (id(engine), _freeze(params))
        fut: asyncio.Future = loop.create_future()
        bucket = self._pending.setdefault(key, [])
        bucket.append((query, fut, time.perf_counter() if _TRACE.active() else None))
        self._engines[key] = (engine, params)
        if not self._busy:
            if len(bucket) >= self.max_batch or self.max_wait_ms <= 0:
                # continuous batching: an idle worker dispatches NOW —
                # coalescing comes from the busy-drain (arrivals during
                # the device call batch together), not from delaying the
                # first request.  A positive window trades +window p50
                # on cold queries for bigger idle->burst first batches.
                self._fire(key)
            elif len(bucket) == 1:
                # first request while idle opens the latency window
                loop.create_task(self._window(key))
        # while busy: the completion callback drains pending buckets
        return await fut

    async def _window(self, key: tuple) -> None:
        await asyncio.sleep(self.max_wait_ms / 1000.0)
        if not self._busy:
            self._fire(key)

    def _fire(self, key: tuple) -> None:
        bucket = self._pending.get(key)
        if not bucket:
            self._pending.pop(key, None)
            self._engines.pop(key, None)
            return
        take = bucket[: self.max_batch]
        rest = bucket[self.max_batch :]
        engine, params = self._engines[key]
        if rest:
            self._pending[key] = rest
        else:
            self._pending.pop(key, None)
            self._engines.pop(key, None)  # drop the ref so engines GC
        queries = [q for q, _, _ in take]
        futures = [f for _, f, _ in take]
        self.dispatches += 1
        self.queries += len(queries)
        self._busy = True
        loop = asyncio.get_running_loop()

        def run():
            with _TRACE.stage("batcher.dispatch") as span:
                if span is not None:
                    span.attrs = (("queries", len(take)),
                                  ("wait_sum_s", sum(span.t0 - t for _, _, t in take
                                                     if t is not None)))
                return engine.search_batch(queries, **params)

        def done(task):
            self._busy = False
            if task.cancelled():
                # loop shutdown: fail waiters instead of raising
                # CancelledError out of the callback (which would leave
                # _busy stuck and the waiters unresolved)
                for f in futures:
                    if not f.done():
                        f.cancel()
                return
            exc = task.exception()
            for i, f in enumerate(futures):
                if f.done():
                    continue
                if exc is not None:
                    f.set_exception(exc)
                else:
                    f.set_result(task.result()[i])
            # drain: everything that arrived while the device was busy
            # goes out immediately as the next (large) batch
            for k in list(self._pending):
                if self._pending.get(k):
                    self._fire(k)
                    break

        task = loop.run_in_executor(self._executor, run)
        task = asyncio.ensure_future(task)
        task.add_done_callback(done)

    async def run(self, fn: Callable[[], Any]) -> Any:
        """Run ``fn`` on the worker, in turn with the batches: a request
        that decodes or embeds on the host (the image search) keeps the
        event loop free and device access serialized."""
        return await asyncio.get_running_loop().run_in_executor(self._executor, fn)

    def close(self) -> None:
        """Stop the worker thread after the dispatch in flight, if any."""
        self._executor.shutdown(wait=True)

    def stats(self) -> dict:
        return {
            "dispatches": self.dispatches,
            "queries": self.queries,
            "avg_batch": round(self.queries / max(self.dispatches, 1), 2),
        }


async def batched_search(services: dict, engine: Any, query: str,
                         **params) -> list:
    """Search through the services' ``QueryBatcher`` (key ``"batcher"``)
    when there is one, else directly, so every request path coalesces
    through the same batcher without knowing whether one is configured."""
    batcher = services.get("batcher") if services else None
    if batcher is not None:
        return await batcher.search(engine, query, **params)
    return engine.search(query, **params)
