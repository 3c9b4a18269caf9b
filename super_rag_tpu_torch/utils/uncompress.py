"""Archive extraction for uploaded bundles (port of the JAX package's
utils/uncompress.py).

zip and tar are stdlib; 7z is handled by the pure-Python reader in
utils/sevenzip.py (stdlib lzma/bz2/zlib codecs); rar's codecs are
proprietary and answer with a clear error.  Extraction is
traversal-safe: absolute members and members escaping with '..' are
skipped, as are members over the size limit.
"""

from __future__ import annotations

import io
import os
import tarfile
import zipfile
from typing import Iterator

from super_rag_tpu_torch.utils.sevenzip import iter_7z


def supported_archive(name: str) -> bool:
    return name.lower().endswith(
        (".zip", ".tar", ".tar.gz", ".tgz", ".tar.bz2", ".tbz2", ".7z")
    )


def iter_archive(name: str, data: bytes,
                 max_members: int = 1000,
                 max_member_mb: int = 100) -> Iterator[tuple[str, bytes]]:
    """Yield (member_name, member_bytes); skips directories and unsafe
    paths (absolute or escaping '..')."""
    limit = max_member_mb * 1024 * 1024

    def safe(member: str) -> bool:
        norm = os.path.normpath(member)
        return not (norm.startswith("..") or os.path.isabs(norm))

    lower = name.lower()
    if lower.endswith(".zip"):
        with zipfile.ZipFile(io.BytesIO(data)) as z:
            for i, info in enumerate(z.infolist()):
                if i >= max_members:
                    return
                if info.is_dir() or not safe(info.filename):
                    continue
                if info.file_size > limit:
                    continue
                yield info.filename, z.read(info)
        return
    if lower.endswith((".tar", ".tar.gz", ".tgz", ".tar.bz2", ".tbz2")):
        with tarfile.open(fileobj=io.BytesIO(data)) as t:
            count = 0
            for member in t:
                if count >= max_members:
                    return
                if not member.isfile() or not safe(member.name):
                    continue
                if member.size > limit:
                    continue
                f = t.extractfile(member)
                if f is None:
                    continue
                yield member.name, f.read()
                count += 1
        return
    if lower.endswith(".7z"):
        count = 0
        for member, payload in iter_7z(data):
            if count >= max_members:
                return
            if not safe(member) or len(payload) > limit:
                continue
            yield member, payload
            count += 1
        return
    if lower.endswith(".rar"):
        raise ValueError(
            ".rar archives use proprietary codecs unavailable in this "
            "deployment; use zip, tar or 7z"
        )
    raise ValueError(f"not a supported archive: {name}")
