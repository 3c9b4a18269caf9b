"""State carried across from the JAX package.

For this system the index state plays the role of model weights:
``index_from_jax_snapshot`` turns the JAX ``DeviceIndex.snapshot_state()``
output (the JAX package's ``engine/index.py:843``) into the port's
``DeviceIndex``, and ``ivf_from_jax`` turns a JAX ``IVFIndex`` (its
``ops/ivf.py:40``), handed over as numpy arrays, into the port's
``IVFIndex``, so both packages can answer over identical state.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from super_rag_tpu_torch.device import DeviceLike, resolve_device
from super_rag_tpu_torch.engine.index import DTYPES, DeviceIndex
from super_rag_tpu_torch.ops.dense import DenseCorpus
from super_rag_tpu_torch.ops.ivf import IVFIndex

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


# IVFIndex array name -> numpy dtype (None: the storage dtype's)
_IVF_ARRAYS = {
    "centroids": np.float32, "values": None, "scales": np.float32,
    "row_ids": np.int32, "overflow_values": None,
    "overflow_scales": np.float32, "overflow_rows": np.int32,
    "sign_plane": np.uint8, "of_sign_plane": np.uint8, "of_assign": np.int32,
}
_IVF_REQUIRED = ("centroids", "values", "row_ids")


def ivf_from_jax(arrays: dict[str, Optional[np.ndarray]], residual: bool,
                 dtype: str, device: DeviceLike = None) -> IVFIndex:
    """The port's ``IVFIndex`` over a JAX ``IVFIndex``'s arrays.

    ``arrays`` holds the JAX fields by name as numpy arrays (absent or
    None where the JAX field is None), with the overflow segment's
    ``DenseCorpus`` as ``overflow_values`` / ``overflow_scales``.
    ``dtype`` names the value storage ("int8", "bfloat16", "float32");
    bf16 values arrive as f32 (exact) and are cast back."""
    if dtype not in DTYPES:
        raise ValueError(f"unsupported storage dtype {dtype!r}")
    dev = resolve_device(device)
    store = np.int8 if dtype == "int8" else np.float32
    out = {}
    for name, want in _IVF_ARRAYS.items():
        a = arrays.get(name)
        if a is None:
            if name in _IVF_REQUIRED:
                raise ValueError(f"JAX IVFIndex lacks array {name!r}")
            out[name] = None
            continue
        a = np.asarray(a)
        want = store if want is None else want
        if a.dtype != want:
            raise ValueError(f"JAX IVFIndex array {name!r} is {a.dtype}, "
                             f"expected {np.dtype(want)}")
        t = torch.from_numpy(np.array(a))
        if name in ("values", "overflow_values"):
            t = t.to(DTYPES[dtype])
        out[name] = t.to(dev)
    overflow = None
    if out["overflow_values"] is not None:
        overflow = DenseCorpus(values=out["overflow_values"],
                               scales=out["overflow_scales"])
    return IVFIndex(
        centroids=out["centroids"], values=out["values"],
        scales=out["scales"], row_ids=out["row_ids"], overflow=overflow,
        overflow_rows=out["overflow_rows"], residual=bool(residual),
        sign_plane=out["sign_plane"], of_sign_plane=out["of_sign_plane"],
        of_assign=out["of_assign"])
