"""Command-line interface (port of the JAX package's cli.py):

    python -m super_rag_tpu_torch.cli serve [--host H] [--port P]
    python -m super_rag_tpu_torch.cli ingest <collection-title> <files...>
    python -m super_rag_tpu_torch.cli search <collection-id> <query> [--top-k N]
    python -m super_rag_tpu_torch.cli collections
    python -m super_rag_tpu_torch.cli snapshot

Configured by the ``SUPER_RAG_*`` environment variables (``config.py``).
Every command runs on the CUDA card and fails without one, unless
``SUPER_RAG_FORCE_CPU=1`` names the CPU.  A one-shot command closes its
context when it ends (batcher, scheduler, image worker, database), so no
thread keeps the process alive.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import os
import sys
from typing import Iterator


def _device():
    """``"cpu"`` under ``SUPER_RAG_FORCE_CPU=1``, else None: the card."""
    if os.environ.get("SUPER_RAG_FORCE_CPU", "").lower() in ("1", "true"):
        return "cpu"
    return None


@contextlib.contextmanager
def _ctx() -> Iterator:
    from super_rag_tpu_torch.service.context import build_context

    ctx = build_context(device=_device())
    try:
        yield ctx
    finally:
        ctx.batcher.close()
        ctx.scheduler.shutdown()
        ctx.close()
        ctx.db.close()


def cmd_serve(args) -> None:
    from super_rag_tpu_torch.app import App, self_serve

    async def main():
        app = App(device=_device())
        await app.start(host=args.host, port=args.port)
        print(f"listening on {args.host or app.cfg.host}:{app.port}")
        try:
            await self_serve(app)
        finally:
            await app.stop()

    asyncio.run(main())


def cmd_collections(args) -> None:
    with _ctx() as ctx:
        for c in ctx.db.list_collections(None):
            print(f"{c['id']}  {c['status']:8s}  {c['title']}")


def cmd_ingest(args) -> None:
    from super_rag_tpu_torch.service.collection_service import CollectionService
    from super_rag_tpu_torch.service.document_service import DocumentService

    with _ctx() as ctx:
        cs = CollectionService(ctx)
        ds = DocumentService(ctx, cs)
        coll = next(
            (c for c in ctx.db.list_collections("cli") if c["title"] == args.collection),
            None,
        ) or cs.create("cli", args.collection)
        for path in args.files:
            with open(path, "rb") as f:
                doc = ds.create("cli", coll["id"], os.path.basename(path), f.read())
            statuses = {i["index_type"]: i["status"] for i in doc["indexes"]}
            print(f"{doc['id']}  {doc['name']}  {statuses}")
        ctx.engines.snapshot_all()
        print(f"collection: {coll['id']}")


def cmd_search(args) -> None:
    from super_rag_tpu_torch.service.collection_service import CollectionService

    with _ctx() as ctx:
        cs = CollectionService(ctx)
        coll = ctx.db.get_collection(args.collection_id)
        if coll is None:
            sys.exit(f"collection {args.collection_id} not found")
        result = asyncio.run(cs.execute_search(coll["user"], coll["id"], args.query,
                                                top_k=args.top_k))
        for item in result["items"]:
            print(f"#{item['rank']} score={item['score']:.4f} "
                  f"[{item['recall_type']}]")
            print(f"   {item['text'][:200]}")


def cmd_snapshot(args) -> None:
    with _ctx() as ctx:
        # hydrate every active collection's engine, then snapshot
        for c in ctx.db.list_collections(None):
            ctx.engines.get(c["id"], c["config"])
        ctx.engines.snapshot_all()
        print("snapshots written to", ctx.cfg.snapshots_root())


def main() -> None:
    p = argparse.ArgumentParser(prog="super-rag-tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("serve", help="run the HTTP server")
    s.add_argument("--host", default=None)
    s.add_argument("--port", type=int, default=None)
    s.set_defaults(fn=cmd_serve)

    s = sub.add_parser("collections", help="list collections")
    s.set_defaults(fn=cmd_collections)

    s = sub.add_parser("ingest", help="ingest files into a collection")
    s.add_argument("collection")
    s.add_argument("files", nargs="+")
    s.set_defaults(fn=cmd_ingest)

    s = sub.add_parser("search", help="hybrid search a collection")
    s.add_argument("collection_id")
    s.add_argument("query")
    s.add_argument("--top-k", type=int, default=5)
    s.set_defaults(fn=cmd_search)

    s = sub.add_parser("snapshot", help="flush device indexes to disk")
    s.set_defaults(fn=cmd_snapshot)

    args = p.parse_args()
    args.fn(args)


if __name__ == "__main__":
    main()
