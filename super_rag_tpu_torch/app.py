"""Application assembly of the port: context + router + HTTP server (port
of the JAX package's app.py).

Serves the routes of ``api/routes.py``, the MCP endpoint (``mcp/server.py``,
``POST /mcp``) and the web console (``api/webui.py``, ``GET /``) on the
CUDA card, starts the periodic reconciler and snapshots the device
indexes on a timer and on a clean stop.  Run with:

    python -m super_rag_tpu_torch.app

configured by the same ``SUPER_RAG_*`` environment variables as the JAX
package (``config.py``).  ``App(device="cpu")`` serves from the CPU, as
the tests do; without a card and without that, the app refuses to start.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from super_rag_tpu_torch.api.http import HttpServer
from super_rag_tpu_torch.api.routes import build_router
from super_rag_tpu_torch.api.webui import register_webui_routes
from super_rag_tpu_torch.config import Settings, settings as default_settings
from super_rag_tpu_torch.device import DeviceLike
from super_rag_tpu_torch.mcp.server import register_mcp_routes
from super_rag_tpu_torch.service.context import AppContext, build_context

logger = logging.getLogger(__name__)


class App:
    def __init__(self, cfg: Optional[Settings] = None,
                 background_tasks: bool = True,
                 device: DeviceLike = None,
                 ctx: Optional[AppContext] = None):
        self.cfg = cfg or default_settings
        self.ctx = ctx or build_context(self.cfg, background_tasks=background_tasks,
                                        device=device)
        self.router = build_router(self.ctx)
        register_mcp_routes(self.router, self.ctx)
        register_webui_routes(self.router)
        self.server = HttpServer(self.router)
        self._snapshot_task: Optional[asyncio.Task] = None

    async def start(self, host: Optional[str] = None,
                    port: Optional[int] = None) -> None:
        await self.server.start(host or self.cfg.host,
                                port if port is not None else self.cfg.port)
        self.ctx.reconciler.start_periodic(self.cfg.reconcile_interval_s)
        # startup recovery: ACTIVE indexes whose device rows were lost
        # (deleted snapshots, crash before flush) are requeued and rebuilt
        await asyncio.to_thread(
            self.ctx.reconciler.verify_engine_state, self.ctx.engines
        )
        self._snapshot_task = asyncio.create_task(self._periodic_snapshots())
        logger.info("super_rag_tpu_torch listening on %s:%s",
                    self.cfg.host, self.server.port)

    async def _periodic_snapshots(self, interval_s: float = 900.0) -> None:
        """Flush device indexes to disk so a crash never rebuilds device
        state from scratch (snapshots also happen on clean stop)."""
        while True:
            await asyncio.sleep(interval_s)
            try:
                await asyncio.to_thread(self.ctx.engines.snapshot_all)
            except Exception:  # noqa: BLE001
                logger.exception("periodic snapshot failed")

    async def stop(self) -> None:
        if self._snapshot_task is not None:
            self._snapshot_task.cancel()
        self.ctx.reconciler.stop()
        self.ctx.scheduler.wait_idle(timeout=30)
        self.ctx.scheduler.shutdown()
        self.ctx.engines.snapshot_all()
        await self.server.stop()
        self.ctx.batcher.close()
        self.ctx.close()

    @property
    def port(self) -> int:
        return self.server.port


async def main() -> None:
    logging.basicConfig(level=logging.INFO)
    app = App()
    await app.start()
    try:
        await self_serve(app)
    finally:
        await app.stop()


async def self_serve(app: App) -> None:
    await app.server.serve_forever()


if __name__ == "__main__":
    asyncio.run(main())
