"""State carried across from the JAX package.

For this system the index state plays the role of model weights:
``index_from_jax_snapshot`` turns the JAX ``DeviceIndex.snapshot_state()``
output (the JAX package's ``engine/index.py:843``) into the port's
``DeviceIndex``, so both packages can answer over identical state.
"""

from __future__ import annotations

import numpy as np

from super_rag_tpu_torch.device import DeviceLike
from super_rag_tpu_torch.engine.index import DTYPES, DeviceIndex

# array name -> numpy dtype the JAX snapshot writes it in
_ARRAY_DTYPES = {
    "terms": np.int32, "tfs": np.float32, "doc_len": np.float32,
    "valid": np.bool_, "indexer_code": np.int32, "chat_code": np.int32,
    "scales": np.float32, "norms_sq": np.float32,
}


def index_from_jax_snapshot(arrays: dict[str, np.ndarray], host: dict,
                            device: DeviceLike = None) -> DeviceIndex:
    """The port's ``DeviceIndex`` over the JAX snapshot's state.

    Checks that every array the layout needs is present with the dtype
    the JAX package writes (bf16 embeddings arrive as f32, int8 ones as
    int8 codes with ``scales``) before restoring."""
    spec = host["spec"]
    if spec["dtype"] not in DTYPES:
        raise ValueError(f"unsupported storage dtype {spec['dtype']!r}")
    emb_dtype = np.int8 if spec["dtype"] == "int8" else np.float32
    need = dict(_ARRAY_DTYPES, emb=emb_dtype)
    if spec["dtype"] != "int8":
        need.pop("scales")
    if spec["metric"] != "l2":
        need.pop("norms_sq")
    for name, dtype in need.items():
        if name not in arrays:
            raise ValueError(f"JAX snapshot lacks array {name!r}")
        if np.asarray(arrays[name]).dtype != dtype:
            raise ValueError(f"JAX snapshot array {name!r} is "
                             f"{np.asarray(arrays[name]).dtype}, expected "
                             f"{np.dtype(dtype)}")
    return DeviceIndex.from_snapshot(arrays, host, device=device)
