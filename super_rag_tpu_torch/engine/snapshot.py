"""Index snapshot / restore: device tensors -> host ``.npz`` + ``.json``
(port of the JAX package's engine/snapshot.py, file form).

The array names and the JSON sidecar are the JAX package's, so a
snapshot written by either package loads in the other.
"""

from __future__ import annotations

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
