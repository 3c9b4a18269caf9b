"""ctypes bridge to the native analyzer (``native/analyzer.cpp``; port of
the JAX package's tokenize/native.py).

The shared library is built with g++ at first use into
``_build/libanalyzer-<hash>.so`` (the hash covers the source and the
flags, so an edited source builds anew; the build writes a temporary file
and renames it, so concurrent processes never load a half-written
library).  It gives the same term buckets, tfs and lengths as the Python
``Analyzer`` path; this is host analysis, so where no compiler is
available ``batch_doc_entries`` returns None and the analyzer keeps its
Python loop.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
from typing import Optional, Sequence

import numpy as np

from super_rag_tpu_torch import _build

logger = logging.getLogger(__name__)

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(HERE, "native", "analyzer.cpp")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def load() -> Optional[ctypes.CDLL]:
    """The native library, built on first use; None where it cannot be
    built or loaded."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        out = _build.gxx_library(_SRC, "analyzer")
        if out is None:
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(out)
        except OSError as e:
            logger.warning("native analyzer load failed: %s", e)
            _load_failed = True
            return None
        lib.analyze_docs.restype = ctypes.c_int
        lib.analyze_docs.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int, ctypes.c_uint32, ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def batch_doc_entries(
    texts: Sequence[str], slots: int, vocab_size: int,
    use_stopwords: bool = True,
) -> Optional[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Native ``Analyzer.batch_doc_entries``: ``(terms [n, slots] int32,
    tfs [n, slots] f32, lens [n] f32)``, or None without the library."""
    lib = load()
    if lib is None:
        return None
    n = len(texts)
    encoded = [t.encode("utf-8") for t in texts]
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    blob = b"".join(encoded)
    terms = np.empty((n, slots), np.int32)
    tfs = np.empty((n, slots), np.float32)
    lens = np.empty(n, np.float32)
    rc = lib.analyze_docs(blob, offsets, n, vocab_size, slots,
                          1 if use_stopwords else 0, terms, tfs, lens)
    if rc != 0:
        raise ValueError(f"analyze_docs failed with code {rc}")
    return terms, tfs, lens
