"""ctypes bridge to the native BPE encoder (``native/bpe.cpp``; port of
the JAX package's tokenize/native_bpe.py).

The shared library is built with g++ at first use into
``_build/libbpe-<hash>.so`` (the hash covers the source and the flags, so
an edited source builds anew; the build writes a temporary file and
renames it, so concurrent processes never load a half-written library).
It gives the same ids as ``models/subword.BPETokenizer``'s Python path;
this is host tokenization, so where no compiler is available, or
``SUPER_RAG_NO_NATIVE_BPE=1``, the tokenizer keeps its Python path.
"""

from __future__ import annotations

import ctypes
import logging
import os
import struct
import threading
from typing import Optional, Sequence

import numpy as np

from super_rag_tpu_torch import _build

logger = logging.getLogger(__name__)

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(HERE, "native", "bpe.cpp")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def load() -> Optional[ctypes.CDLL]:
    """The native library, built on first use; None where it cannot be
    built or loaded."""
    global _lib, _load_failed
    if os.environ.get("SUPER_RAG_NO_NATIVE_BPE") == "1":
        return None
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        out = _build.gxx_library(_SRC, "bpe")
        if out is None:
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(out)
        except OSError as e:
            logger.warning("native bpe load failed: %s", e)
            _load_failed = True
            return None
        lib.bpe_create.restype = ctypes.c_void_p
        lib.bpe_create.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.bpe_destroy.restype = None
        lib.bpe_destroy.argtypes = [ctypes.c_void_p]
        lib.bpe_encode.restype = ctypes.c_int64
        lib.bpe_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ]
        _lib = lib
        return _lib


def _pack_vocab(tokens: Sequence[str],
                merges: Sequence[tuple[str, str]]) -> bytes:
    out = [struct.pack("<ii", len(tokens), len(merges))]
    for t in tokens:
        b = t.encode("utf-8")
        out.append(struct.pack("<i", len(b)))
        out.append(b)
    for a, b_ in merges:
        for s in (a, b_):
            e = s.encode("utf-8")
            out.append(struct.pack("<i", len(e)))
            out.append(e)
    return b"".join(out)


class NativeBPE:
    """Owns one native encoder handle for a trained vocabulary."""

    def __init__(self, handle: int, lib: ctypes.CDLL):
        self._handle = handle
        self._lib = lib

    @classmethod
    def create(cls, tokens: Sequence[str],
               merges: Sequence[tuple[str, str]]) -> Optional["NativeBPE"]:
        lib = load()
        if lib is None:
            return None
        blob = _pack_vocab(tokens, merges)
        handle = lib.bpe_create(blob, len(blob))
        if not handle:
            logger.warning("native bpe rejected the vocab blob")
            return None
        return cls(handle, lib)

    def encode(self, text: str) -> np.ndarray:
        data = text.encode("utf-8")
        # a byte yields at most one symbol and each word one more (</w>)
        cap = 2 * len(data) + 8
        out = np.empty(cap, np.int32)
        n = self._lib.bpe_encode(
            self._handle, data, len(data),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap,
        )
        if n < 0:
            raise RuntimeError("native bpe output overflow")
        return out[:n]

    def __del__(self):  # noqa: D105
        lib, handle = getattr(self, "_lib", None), getattr(self, "_handle", 0)
        if lib is not None and handle:
            try:
                lib.bpe_destroy(handle)
            except (AttributeError, TypeError):  # interpreter teardown
                pass
