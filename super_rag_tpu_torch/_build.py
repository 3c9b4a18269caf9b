"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``_build/lib<name>-<hash>.so`` for ``sm_90a`` (no PyTorch headers, so
a build takes seconds).  The hash covers the source, the shared
``csrc/*.cuh`` headers and the flags, so an edited source builds anew.
Building happens at first use, never at import: this module only runs
``nvcc`` when a kernel is asked for.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Iterable

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "csrc")
BUILD = os.path.join(HERE, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# nvcc's ptxas report (registers, shared memory, spills) per kernel source
build_logs: dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC, name + ".cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    return src, os.path.join(BUILD, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names: Iterable[str]) -> dict[str, float]:
    """Compile every named source that is not built yet, one nvcc per
    source, all started together.  Returns seconds per source built."""
    import time

    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for name in names:
        src, out = _target(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        procs[name] = (time.perf_counter(), out, tmp, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    took = {}
    for name, (t0, out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)
        took[name] = time.perf_counter() - t0
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_target(name)[1])
            _libs[name] = lib
        return lib
