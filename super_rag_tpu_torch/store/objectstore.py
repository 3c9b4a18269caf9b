"""Object store for original documents and index snapshots (port of the
JAX package's store/objectstore.py, local backend).

The contract of the reference's ObjectStore (put / get / obj_size /
exists / stream_range / delete / delete_prefix, and a factory by type)
with the local filesystem backend.  The S3 backend speaks HTTP through
httpx, which the port's card machine lacks; it waits for the HTTP half of
the serving seam (ROADMAP A6), and ``get_object_store("s3")`` says so.
"""

from __future__ import annotations

import os
import shutil
from typing import BinaryIO, Iterator, Optional


class ObjectStore:
    def wire_config(self) -> Optional[dict]:
        """kwargs for :func:`get_object_store` that rebuild this store in
        another process; None when it cannot be rebuilt."""
        return None

    def put(self, path: str, data: bytes | BinaryIO) -> None:
        raise NotImplementedError

    def get(self, path: str) -> bytes:
        raise NotImplementedError

    def obj_size(self, path: str) -> int:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def stream_range(self, path: str, start: int = 0,
                     end: Optional[int] = None,
                     chunk_size: int = 1 << 20) -> Iterator[bytes]:
        raise NotImplementedError

    def delete(self, path: str) -> None:
        raise NotImplementedError

    def delete_prefix(self, prefix: str) -> None:
        raise NotImplementedError


class LocalObjectStore(ObjectStore):
    """Objects as files under ``root``; a key that would resolve outside
    ``root`` is refused."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def wire_config(self) -> Optional[dict]:
        return {"store_type": "local", "root": self.root}

    def _fs(self, path: str) -> str:
        full = os.path.abspath(os.path.join(self.root, path.lstrip("/")))
        if not full.startswith(self.root + os.sep) and full != self.root:
            raise ValueError(f"path escapes object store root: {path}")
        return full

    def put(self, path: str, data: bytes | BinaryIO) -> None:
        full = self._fs(path)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        tmp = full + ".tmp"
        with open(tmp, "wb") as f:
            if isinstance(data, bytes):
                f.write(data)
            else:
                shutil.copyfileobj(data, f)
        os.replace(tmp, full)

    def get(self, path: str) -> bytes:
        with open(self._fs(path), "rb") as f:
            return f.read()

    def obj_size(self, path: str) -> int:
        return os.path.getsize(self._fs(path))

    def exists(self, path: str) -> bool:
        return os.path.isfile(self._fs(path))

    def stream_range(self, path: str, start: int = 0,
                     end: Optional[int] = None,
                     chunk_size: int = 1 << 20) -> Iterator[bytes]:
        size = self.obj_size(path)
        stop = size if end is None else min(end, size)
        with open(self._fs(path), "rb") as f:
            f.seek(start)
            remaining = stop - start
            while remaining > 0:
                block = f.read(min(chunk_size, remaining))
                if not block:
                    break
                remaining -= len(block)
                yield block

    def delete(self, path: str) -> None:
        full = self._fs(path)
        if os.path.isfile(full):
            os.remove(full)

    def delete_prefix(self, prefix: str) -> None:
        full = self._fs(prefix)
        if os.path.isdir(full):
            shutil.rmtree(full, ignore_errors=True)


def get_object_store(store_type: str = "local", **kwargs) -> ObjectStore:
    if store_type == "local":
        return LocalObjectStore(kwargs.get("root", "./data/objects"))
    if store_type == "s3":
        raise NotImplementedError(
            "the S3 object store is not ported yet (ROADMAP A6: it needs "
            "httpx, with the serving seam's HTTP half)")
    raise ValueError(f"unknown object store type: {store_type}")
