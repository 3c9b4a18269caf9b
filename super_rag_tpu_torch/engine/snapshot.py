"""Index snapshot / restore: device tensors -> host ``.npz`` + ``.json``
(port of the JAX package's engine/snapshot.py).

The array names, the JSON sidecar and the object-store keys
(``<prefix>.npz`` / ``<prefix>.json``) are the JAX package's, so a
snapshot either package writes, to files or to an ``ObjectStore``
(``store/objectstore.py``), loads in the other.  Snapshots carry no
postings: a restored index rebuilds them at its next compaction.
"""

from __future__ import annotations

import io
import json
import os
import tempfile

import numpy as np

from super_rag_tpu_torch.device import DeviceLike
from super_rag_tpu_torch.engine.index import DeviceIndex


def save_index(index: DeviceIndex, path: str) -> None:
    """Write ``path.npz`` (arrays) and ``path.json`` (host state)."""
    arrays, host = index.snapshot_state()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # write temp files, then rename over the targets
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".")
    os.close(fd)
    np.savez_compressed(tmp + ".npz", **arrays)
    os.replace(tmp + ".npz", path + ".npz")
    with open(tmp, "w") as f:
        json.dump(host, f)
    os.replace(tmp, path + ".json")


def load_index(path: str, device: DeviceLike = None) -> DeviceIndex:
    with np.load(path + ".npz") as z:
        arrays = {k: z[k] for k in z.files}
    with open(path + ".json") as f:
        host = json.load(f)
    return DeviceIndex.from_snapshot(arrays, host, device=device)


def snapshot_exists(path: str) -> bool:
    return os.path.exists(path + ".npz") and os.path.exists(path + ".json")


# -- object-store snapshots: index durability off this machine ---------------


def save_index_to_store(index: DeviceIndex, store, key_prefix: str) -> None:
    """Put ``key_prefix.npz`` and ``key_prefix.json`` into ``store``."""
    arrays, host = index.snapshot_state()
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    store.put(key_prefix + ".npz", buf.getvalue())
    store.put(key_prefix + ".json", json.dumps(host).encode())


def load_index_from_store(store, key_prefix: str,
                          device: DeviceLike = None) -> DeviceIndex:
    with np.load(io.BytesIO(store.get(key_prefix + ".npz"))) as z:
        arrays = {k: z[k] for k in z.files}
    host = json.loads(store.get(key_prefix + ".json").decode())
    return DeviceIndex.from_snapshot(arrays, host, device=device)


def store_snapshot_exists(store, key_prefix: str) -> bool:
    return (store.exists(key_prefix + ".npz")
            and store.exists(key_prefix + ".json"))
