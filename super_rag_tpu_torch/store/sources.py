"""Document sources: where originals come from before ingestion (port of
the JAX package's store/sources.py).

A source yields candidate documents; the document service ingests them.
``get_source`` builds one by type: ``upload`` (or ``system``: the object
store the API uploads into), ``local`` (a host directory) and ``s3`` (a
bucket, through the port's own SigV4 client, ``store/objectstore.py``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Optional

from super_rag_tpu_torch.store.objectstore import ObjectStore, S3ObjectStore


@dataclass
class SourceDocument:
    name: str
    size: int
    ref: str  # source-specific locator

    def read(self, source: "Source") -> bytes:
        return source.fetch(self.ref)


class Source:
    """Scan for candidate documents and fetch their bytes."""

    def scan(self) -> Iterator[SourceDocument]:
        raise NotImplementedError

    def fetch(self, ref: str) -> bytes:
        raise NotImplementedError

    def cleanup(self) -> None:
        pass


class UploadSource(Source):
    """Documents already uploaded to the object store (the API path)."""

    def __init__(self, objects: ObjectStore, prefix: str):
        self.objects = objects
        self.prefix = prefix

    def scan(self) -> Iterator[SourceDocument]:
        return iter(())  # uploads are pushed, not scanned

    def fetch(self, ref: str) -> bytes:
        return self.objects.get(ref)


class LocalDirectorySource(Source):
    """Recursively scan a host directory for supported files."""

    def __init__(self, root: str, extensions: Optional[set[str]] = None,
                 max_size_mb: int = 100):
        self.root = os.path.abspath(root)
        self.extensions = extensions
        self.max_size = max_size_mb * 1024 * 1024

    def scan(self) -> Iterator[SourceDocument]:
        for dirpath, _dirs, files in os.walk(self.root):
            for fn in sorted(files):
                ext = os.path.splitext(fn)[1].lower()
                if self.extensions is not None and ext not in self.extensions:
                    continue
                full = os.path.join(dirpath, fn)
                size = os.path.getsize(full)
                if size > self.max_size:
                    continue
                yield SourceDocument(
                    name=os.path.relpath(full, self.root), size=size, ref=full
                )

    def fetch(self, ref: str) -> bytes:
        full = os.path.abspath(ref)
        if not full.startswith(self.root + os.sep):
            raise ValueError(f"ref escapes source root: {ref}")
        with open(full, "rb") as f:
            return f.read()


class S3Source(Source):
    """Every object under ``prefix`` of a bucket (ListObjectsV2)."""

    def __init__(self, bucket: str, prefix: str = "", **client_kwargs):
        self.store = S3ObjectStore(bucket, **client_kwargs)
        self.prefix = prefix

    def scan(self) -> Iterator[SourceDocument]:
        for key in self.store.list(self.prefix):
            yield SourceDocument(name=key, size=self.store.obj_size(key),
                                 ref=key)

    def fetch(self, ref: str) -> bytes:
        return self.store.get(ref)


def get_source(source_type: str, **kwargs) -> Source:
    if source_type in ("system", "upload"):
        return UploadSource(kwargs["objects"], kwargs.get("prefix", ""))
    if source_type == "local":
        return LocalDirectorySource(
            kwargs["root"], kwargs.get("extensions"),
            kwargs.get("max_size_mb", 100),
        )
    if source_type == "s3":
        return S3Source(**kwargs)
    raise ValueError(f"unknown source type: {source_type}")
