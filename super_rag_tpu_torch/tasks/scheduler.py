"""Task schedulers: the host-side ingestion execution plane (port of the
JAX package's tasks/scheduler.py).

The same ABC fronts two backends: InProcessScheduler (runs the index
task synchronously, the deterministic test path) and ThreadScheduler (a
host worker pool parses and chunks while one device worker serializes
embed + insert on the card).  The JAX package's process and Ray backends
are not ported yet (ROADMAP A6); ``service/context.build_context``
refuses them by name.
"""

from __future__ import annotations

import logging
import queue
import threading
import uuid
from typing import Callable, Optional

logger = logging.getLogger(__name__)


class TaskScheduler:
    """Schedule index workflows; completion is reported via callbacks."""

    def schedule_create_index(self, index_id: int, document_id: str,
                              index_type: str, version: int) -> str:
        raise NotImplementedError

    def schedule_delete_index(self, index_id: int, document_id: str,
                              index_type: str) -> str:
        raise NotImplementedError

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until queued work drains (tests / shutdown)."""
        return True

    def shutdown(self) -> None:
        pass


class CallbackScheduler(TaskScheduler):
    """Shared execution logic; subclasses choose where `_submit` runs."""

    def __init__(self, task, callbacks):
        """``task``: tasks.document.DocumentIndexTask;
        ``callbacks``: reconciler's IndexTaskCallbacks."""
        self.task = task
        self.callbacks = callbacks

    def _run_create(self, index_id: int, document_id: str, index_type: str,
                    version: int, prepare_future=None) -> None:
        prepared = None
        if prepare_future is not None:
            try:
                prepared = prepare_future.result()
            except Exception:  # noqa: BLE001 — create_index re-raises the
                pass  # same parse error and routes it to on_index_failed
        try:
            data = self.task.create_index(document_id, index_type, version,
                                          prepared=prepared)
            self.callbacks.on_index_created(index_id, version, data)
        except Exception as e:  # noqa: BLE001 - failures land in status
            logger.exception("create_index failed")
            self.callbacks.on_index_failed(index_id, version, str(e))

    def _run_delete(self, index_id: int, document_id: str,
                    index_type: str) -> None:
        try:
            self.task.delete_index(document_id, index_type)
            self.callbacks.on_index_deleted(index_id)
        except Exception as e:  # noqa: BLE001
            logger.exception("delete_index failed")
            self.callbacks.on_index_delete_failed(index_id, str(e))


class InProcessScheduler(CallbackScheduler):
    def schedule_create_index(self, index_id, document_id, index_type, version):
        self._run_create(index_id, document_id, index_type, version)
        return uuid.uuid4().hex

    def schedule_delete_index(self, index_id, document_id, index_type):
        self._run_delete(index_id, document_id, index_type)
        return uuid.uuid4().hex


class ThreadScheduler(CallbackScheduler):
    """Pipelined ingest: parse/chunk fan out over a host worker pool
    while a single device worker serializes embed+insert (one card;
    DeviceIndex writes must not interleave).

    Ordering: the device job is enqueued AT SCHEDULE TIME with a future
    for its prepare stage, so commits run strictly FIFO — two versions
    of the same document can prepare concurrently but always commit in
    schedule order (the serial-queue semantics the reconciler's CAS
    state machine assumes)."""

    def __init__(self, task, callbacks, num_workers: int = 1,
                 host_workers: int = 0):
        super().__init__(task, callbacks)
        self._q: "queue.Queue[Optional[Callable[[], None]]]" = queue.Queue()
        self._host = None
        if host_workers > 0:
            from concurrent.futures import ThreadPoolExecutor

            self._host = ThreadPoolExecutor(
                max_workers=host_workers, thread_name_prefix="ingest-prep"
            )
        self._workers = [
            threading.Thread(target=self._loop, daemon=True)
            for _ in range(num_workers)
        ]
        for w in self._workers:
            w.start()

    def _loop(self) -> None:
        while True:
            fn = self._q.get()
            if fn is None:
                self._q.task_done()
                return
            try:
                fn()
            finally:
                self._q.task_done()

    def _submit_prepare(self, document_id: str, index_type: str):
        """Kick off the host-side prepare stage on the host pool."""
        return self._host.submit(self.task.prepare, document_id, index_type)

    def schedule_create_index(self, index_id, document_id, index_type, version):
        fut = None
        if self._host is not None:
            fut = self._submit_prepare(document_id, index_type)
        self._q.put(lambda: self._run_create(index_id, document_id,
                                             index_type, version,
                                             prepare_future=fut))
        return uuid.uuid4().hex

    def schedule_delete_index(self, index_id, document_id, index_type):
        self._q.put(lambda: self._run_delete(index_id, document_id, index_type))
        return uuid.uuid4().hex

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        if timeout is None:
            self._q.join()
            return True
        done = threading.Event()
        threading.Thread(target=lambda: (self._q.join(), done.set()),
                         daemon=True).start()
        return done.wait(timeout)

    def shutdown(self) -> None:
        if self._host is not None:
            self._host.shutdown(wait=False)
        for _ in self._workers:
            self._q.put(None)
