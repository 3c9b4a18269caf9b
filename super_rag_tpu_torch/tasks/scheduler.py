"""Task schedulers: the host-side ingestion execution plane (port of the
JAX package's tasks/scheduler.py).

The same ABC fronts four backends: InProcessScheduler (runs the index
task synchronously, the deterministic test path), ThreadScheduler (a
host worker pool parses and chunks while one device worker serializes
embed + insert on the card), ProcessScheduler (parse and chunk in worker
subprocesses speaking JSON-lines over pipes, ``tasks/worker.py``) and
RayTaskScheduler (the same prepare body as Ray remote tasks, where
``ray`` is installed).
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
        """Kick off the host-side prepare stage; overridden by
        ProcessScheduler to cross a process boundary."""
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


class WorkerProcess:
    """One host worker subprocess (``python -m
    super_rag_tpu_torch.tasks.worker``) with a request/response pipe: the
    ProcessScheduler's prepare stage and the image route's decode."""

    def __init__(self):
        import os
        import subprocess
        import sys

        env = dict(os.environ)
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))
        ))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "super_rag_tpu_torch.tasks.worker"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            bufsize=1, env=env,
        )
        self.lock = threading.Lock()

    def call(self, req: dict) -> dict:
        import json

        with self.lock:
            assert self.proc.stdin and self.proc.stdout
            self.proc.stdin.write(json.dumps(req) + "\n")
            self.proc.stdin.flush()
            line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError("ingest worker died")
        return json.loads(line)

    def stop(self) -> None:
        try:
            if self.proc.stdin:
                self.proc.stdin.close()
            self.proc.terminate()
        except Exception:  # noqa: BLE001 — already gone
            pass


class _RemotePrepareScheduler(ThreadScheduler):
    """A ThreadScheduler whose prepare stage runs out of this process, as
    :func:`tasks.worker.prepare_on_host` on a request built from the
    object store's wire config; the device commit stays FIFO in this
    process.  A store that cannot be put on the wire prepares in a host
    thread instead, as the JAX package does."""

    def _submit_prepare(self, document_id: str, index_type: str):
        return self._host.submit(self._prepare, document_id, index_type)

    def _prepare(self, document_id: str, index_type: str) -> dict:
        from super_rag_tpu_torch.tasks.worker import prepared_from_wire

        store_cfg = self.task.objects.wire_config()
        if store_cfg is None:
            logger.warning(
                "object store %s is not wire-serializable; preparing "
                "in-process", type(self.task.objects).__name__)
            return self.task.prepare(document_id, index_type)
        cfg = self.task.cfg
        return prepared_from_wire(self._remote_prepare({
            "document_id": document_id, "index_type": index_type,
            "db_path": self.task.db.path, "object_store": store_cfg,
            "chunk_size": cfg.chunk_size, "chunk_overlap": cfg.chunk_overlap,
        }))

    def _remote_prepare(self, req: dict) -> dict:
        """``prepare_on_host(**req)`` elsewhere; returns its wire dict."""
        raise NotImplementedError


class RayTaskScheduler(_RemotePrepareScheduler):
    """Ray-backed ingest: the parse/chunk stage runs as Ray remote tasks
    executing :func:`tasks.worker.prepare_on_host` — the same host-only
    body the pipe workers run — while embed + insert stays FIFO on the
    in-process device worker (the card's engine cannot move).

    ``ray`` is imported on construction: without it construction raises
    ImportError, and ``service/context.build_context`` falls back to
    ProcessScheduler with a warning."""

    def __init__(self, task, callbacks, num_workers: int = 1,
                 ray_workers: int = 4, ray_address: Optional[str] = None):
        import ray  # ImportError here = fall back to ProcessScheduler

        super().__init__(task, callbacks, num_workers=num_workers,
                         host_workers=max(ray_workers, 1))
        self._ray = ray
        if ray_address:
            # prepare_on_host opens the sqlite db_path and local object
            # root as filesystem paths inside the Ray task: a multi-node
            # cluster needs them on shared storage (NFS) or an s3 store
            logger.warning(
                "RayTaskScheduler with address=%s: db_path/object paths "
                "must be reachable from every worker node", ray_address)
        if not ray.is_initialized():
            ray.init(address=ray_address, ignore_reinit_error=True,
                     include_dashboard=False)
        from super_rag_tpu_torch.tasks.worker import prepare_on_host

        self._remote_fn = ray.remote(prepare_on_host)

    def _remote_prepare(self, req: dict) -> dict:
        return self._ray.get(self._remote_fn.remote(**req))

    def shutdown(self) -> None:
        super().shutdown()
        # leave ray itself running: other schedulers/process may share it


class ProcessScheduler(_RemotePrepareScheduler):
    """Pipelined ingest with prepare in subprocesses (tasks/worker.py).

    Same FIFO device-commit ordering as ThreadScheduler; the parse/chunk
    stage runs out of process and its Parts/Chunks return over a pipe,
    the pipe standing in for Ray's object store.  The device-side commit
    stays in the parent, where the card's engine lives."""

    def __init__(self, task, callbacks, num_workers: int = 1,
                 process_workers: int = 2):
        super().__init__(task, callbacks, num_workers=num_workers,
                         host_workers=max(process_workers, 1))
        self._procs = [WorkerProcess() for _ in range(max(process_workers, 1))]
        self._idle: "queue.Queue[WorkerProcess]" = queue.Queue()
        for w in self._procs:
            self._idle.put(w)

    def _remote_prepare(self, req: dict) -> dict:
        w = self._idle.get()
        try:
            resp = w.call({"op": "prepare", **req})
        finally:
            self._idle.put(w)
        if not resp.get("ok"):
            raise RuntimeError(resp.get("error", "prepare failed"))
        return resp["prepared"]

    def shutdown(self) -> None:
        super().shutdown()
        for w in self._procs:
            w.stop()
