"""Out-of-process ingest worker: the cross-process half of
ProcessScheduler (port of the JAX package's tasks/worker.py).

A subprocess that speaks JSON-lines over stdin/stdout — one request per
line, one response per line — and runs the host-side ``prepare`` stage
(object fetch -> parse -> chunk) or embeds a searched image (``embed_image``:
the pure-Python decode, kept out of the serving process's GIL).  The device-side commit stays in the
parent, where the card's engine lives.  Documents go in and Parts/Chunks
come back over a pipe, so a Ray (or any RPC) backend can stand behind the
same TaskScheduler ABC.

Run as ``python -m super_rag_tpu_torch.tasks.worker``.  The worker does
host work only: nothing it imports pulls in torch or touches CUDA.
"""

from __future__ import annotations

import base64
import json
import sys
from typing import Any

from super_rag_tpu_torch.chunk.chunking import Chunk, Rechunker
from super_rag_tpu_torch.fileparser.base import AssetBinPart, CodePart, ImagePart, Part
from super_rag_tpu_torch.fileparser.parser import DocParser
from super_rag_tpu_torch.store.db import Database
from super_rag_tpu_torch.store.objectstore import get_object_store


# -- wire format (JSON-safe Parts/Chunks) ------------------------------------


def part_to_wire(p: Part) -> dict:
    """A JSON-safe dict of a part.  Beyond the JAX package's dicts it
    carries an image part's ``url`` and a code part's ``language``: the
    vision index finds an image's asset by its url."""
    if isinstance(p, AssetBinPart):
        return {"kind": "AssetBinPart", "content": p.content,
                "metadata": p.metadata, "mime_type": p.mime_type,
                "asset_id": p.asset_id,
                "data_b64": base64.b64encode(p.data).decode()}
    d = p.to_dict()
    if isinstance(p, ImagePart):
        d["url"] = p.url
    elif isinstance(p, CodePart):
        d["language"] = p.language
    return d


def part_from_wire(d: dict) -> Part:
    if d.get("kind") == "AssetBinPart":
        return AssetBinPart(
            content=d.get("content", ""), metadata=d.get("metadata", {}),
            mime_type=d.get("mime_type", "application/octet-stream"),
            asset_id=d.get("asset_id", ""),
            data=base64.b64decode(d.get("data_b64", "")),
        )
    p = Part.from_dict(d)
    if isinstance(p, ImagePart):
        p.url = d.get("url", "")
    elif isinstance(p, CodePart):
        p.language = d.get("language", "")
    return p


def chunk_to_wire(c: Chunk) -> dict:
    return {"text": c.text, "title_path": list(c.title_path),
            "metadata": c.metadata}


def chunk_from_wire(d: dict) -> Chunk:
    return Chunk(text=d["text"], title_path=tuple(d.get("title_path", ())),
                 metadata=d.get("metadata", {}))


def prepared_to_wire(prepared: dict) -> dict:
    return {
        "document_id": prepared["document_id"],
        "index_type": prepared["index_type"],
        "doc_hash": prepared.get("doc_hash"),
        "parts": [part_to_wire(p) for p in prepared["parts"]],
        "chunks": [chunk_to_wire(c) for c in prepared["chunks"]],
    }


def prepared_from_wire(d: dict) -> dict:
    return {
        "document_id": d["document_id"],
        "index_type": d["index_type"],
        "doc_hash": d.get("doc_hash"),
        "parts": [part_from_wire(p) for p in d.get("parts", [])],
        "chunks": [chunk_from_wire(c) for c in d.get("chunks", [])],
    }


# -- worker body --------------------------------------------------------------


def prepare_document(db, objects, document_id: str, index_type: str,
                     chunk_size: int, chunk_overlap: int) -> dict:
    """The host stage of indexing a document: object fetch -> parse ->
    chunk.  Returns the payload ``DocumentIndexTask.create_index`` takes
    as ``prepared``.  Every backend runs this one body: the thread
    backend in a host thread, the process and Ray backends through
    :func:`prepare_on_host`."""
    doc = db.get_document(document_id)
    if doc is None:
        raise ValueError(f"document {document_id} not found")
    parts = DocParser().parse_file(doc["name"], objects.get(doc["object_path"]))
    chunks = Rechunker(int(chunk_size), int(chunk_overlap)).rechunk(
        parts, metadata={"document_id": document_id})
    return {"document_id": document_id, "index_type": index_type,
            "doc_hash": doc.get("content_hash"), "parts": parts, "chunks": chunks}


def prepare_on_host(document_id: str, index_type: str, db_path: str,
                    object_store: dict, chunk_size: int = 400,
                    chunk_overlap: int = 20) -> dict:
    """:func:`prepare_document` from paths and a store's wire config,
    returning the JSON-safe wire dict.  Module-level and host-only so any
    execution plane can run it: the pipe worker below, a Ray remote
    (RayTaskScheduler), or an RPC handler."""
    db = Database(db_path)
    try:
        return prepared_to_wire(prepare_document(
            db, get_object_store(**object_store), document_id, index_type,
            chunk_size, chunk_overlap))
    finally:
        db.close()


def handle(req: dict) -> dict:
    op = req.get("op")
    if op == "ping":
        return {"ok": True, "pong": True}
    if op == "prepare":
        return {"ok": True, "prepared": prepare_on_host(
            req["document_id"], req["index_type"], req["db_path"],
            object_store=req["object_store"],
            chunk_size=int(req.get("chunk_size", 400)),
            chunk_overlap=int(req.get("chunk_overlap", 20)),
        )}
    if op == "embed_image":
        from super_rag_tpu_torch.models.image_decode import UnsupportedImageError
        from super_rag_tpu_torch.models.image_embedder import embed_image

        try:
            vec = embed_image(base64.b64decode(req["data_b64"]), int(req["dim"]))
        except UnsupportedImageError as e:
            return {"ok": False, "error": str(e), "unsupported": True}
        return {"ok": True, "vector": vec[0].tolist()}
    return {"ok": False, "error": f"unknown op: {op}"}


def main() -> None:
    out = sys.stdout
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req: Any = json.loads(line)
            resp = handle(req)
        except Exception as e:  # noqa: BLE001 — report, keep serving
            resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        out.write(json.dumps(resp) + "\n")
        out.flush()


if __name__ == "__main__":
    main()
