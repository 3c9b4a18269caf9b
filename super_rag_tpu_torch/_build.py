"""Build the port's native libraries and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``_build/lib<name>-<hash>.so`` for ``sm_90a`` (no PyTorch headers, so
a build takes seconds).  The hash covers the source, the shared
``csrc/*.cuh`` headers and the flags, so an edited source builds anew.
The host libraries of ``native/*.cpp`` (the analyzer, the BPE encoder)
build with g++ the same way (``gxx_library``).  Building happens at first
use, never at import: this module only runs a compiler when a library is
asked for.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from typing import Iterable, Optional

logger = logging.getLogger(__name__)

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "csrc")
BUILD = os.path.join(HERE, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

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


def _gxx_target(src: str, name: str) -> str:
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(src, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD, f"lib{name}-{digest.hexdigest()[:16]}.so")


def gxx_library(src: str, name: str) -> Optional[str]:
    """Path of the g++-built host library of ``src``
    (``_build/lib<name>-<hash>.so``, the hash over the source and the
    flags), built now if it is not there yet; None where g++ cannot build
    it.  The build writes a temporary file and renames it, so concurrent
    processes never load a half-written library."""
    out = _gxx_target(src, name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *GXX_FLAGS, src, "-o", tmp], check=True,
                       capture_output=True, timeout=300)
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        logger.warning("g++ build of %s failed: %s", os.path.basename(src), e)
        return None
    os.replace(tmp, out)
    return out
