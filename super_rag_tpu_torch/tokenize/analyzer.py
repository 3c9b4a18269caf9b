"""Lexical analysis for the BM25 index (copy of
the JAX package's tokenize/analyzer.py).

Terms hash (FNV-1a 32-bit) into a power-of-two vocabulary of buckets;
each document becomes L (term_id, tf) slots padded with the reserved PAD
bucket ``vocab_size``; CJK runs become character bigrams, Latin text
``[a-z0-9_]+`` words.  ``batch_doc_entries`` takes the native C++
analyzer (``tokenize/native.py``) for 8 or more texts; it is
bit-identical to the Python path here.
"""

from __future__ import annotations

import math
import re
from collections import Counter
from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np

_WORD_RE = re.compile(r"[a-z0-9_]+")
_CJK_RE = re.compile(r"[一-鿿぀-ヿ가-힯]+")

# Small English stopword list: high-df terms that only waste slots.
_STOPWORDS = frozenset(
    """a an and are as at be by for from has have in is it its of on or that
    the this to was were will with not but they you we he she i""".split()
)


def fnv1a32(s: str) -> int:
    h = 0x811C9DC5
    for byte in s.encode("utf-8"):
        h ^= byte
        h = (h * 0x01000193) & 0xFFFFFFFF
    return h


@dataclass
class Analyzer:
    """Tokenize text to hashed term buckets.

    vocab_size must be a power of two; bucket = fnv1a32(term) & (V - 1).
    """

    vocab_size: int = 1 << 17
    use_stopwords: bool = True
    _mask: int = field(init=False)

    def __post_init__(self):
        if self.vocab_size & (self.vocab_size - 1):
            raise ValueError(f"vocab_size must be a power of two, got "
                             f"{self.vocab_size}")
        self._mask = self.vocab_size - 1

    @property
    def pad_id(self) -> int:
        return self.vocab_size

    def tokens(self, text: str) -> list[str]:
        text = text.lower()
        out = _WORD_RE.findall(text)
        if self.use_stopwords:
            out = [t for t in out if t not in _STOPWORDS]
        for run in _CJK_RE.findall(text):
            if len(run) == 1:
                out.append(run)
            else:
                out.extend(run[i : i + 2] for i in range(len(run) - 1))
        return out

    def term_ids(self, text: str) -> list[int]:
        return [fnv1a32(t) & self._mask for t in self.tokens(text)]

    def doc_entry(
        self, text: str, slots: int
    ) -> tuple[np.ndarray, np.ndarray, int]:
        """(terms [slots] int32, tfs [slots] float32, doc_len) for one doc.

        Keeps the ``slots`` highest-tf terms; doc_len is the total token
        count (pre-truncation) so BM25 length normalization stays honest.
        """
        ids = self.term_ids(text)
        counts = Counter(ids)
        top = counts.most_common(slots)
        terms = np.full(slots, self.pad_id, np.int32)
        tfs = np.zeros(slots, np.float32)
        for j, (tid, tf) in enumerate(top):
            terms[j] = tid
            tfs[j] = tf
        return terms, tfs, len(ids)

    def batch_doc_entries(
        self, texts: Sequence[str], slots: int, prefer_native: bool = True
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(terms [n, slots] int32, tfs [n, slots] f32, lens [n] f32)``.
        Eight or more texts take the native analyzer (the ingest path's
        hot loop) where it builds; otherwise, or with ``prefer_native``
        off, the Python loop."""
        if prefer_native and len(texts) >= 8:
            from super_rag_tpu_torch.tokenize import native

            out = native.batch_doc_entries(texts, slots, self.vocab_size,
                                           self.use_stopwords)
            if out is not None:
                return out
        terms = np.full((len(texts), slots), self.pad_id, np.int32)
        tfs = np.zeros((len(texts), slots), np.float32)
        lens = np.zeros(len(texts), np.float32)
        for i, t in enumerate(texts):
            terms[i], tfs[i], lens[i] = self.doc_entry(t, slots)
        return terms, tfs, lens

    def query_entry(
        self,
        text: str,
        doc_freq: "DocFrequency",
        max_terms: int,
    ) -> tuple[np.ndarray, np.ndarray]:
        """(term_ids [max_terms], idf [max_terms]) padded with pad_id/0."""
        ids = list(dict.fromkeys(self.term_ids(text)))[:max_terms]
        terms = np.full(max_terms, self.pad_id, np.int32)
        idf = np.zeros(max_terms, np.float32)
        for j, tid in enumerate(ids):
            terms[j] = tid
            idf[j] = doc_freq.idf(tid)
        return terms, idf


class DocFrequency:
    """Host-side document-frequency table for idf computation.

    Tracks df per hashed bucket.  Robertson-Sparck-Jones idf with +1
    flooring (never negative), as used by Lucene/Elasticsearch.
    """

    def __init__(self):
        self._df: Counter = Counter()
        self.num_docs: int = 0
        self.total_len: float = 0.0

    @property
    def avgdl(self) -> float:
        return self.total_len / self.num_docs if self.num_docs else 1.0

    def add_doc(self, term_ids: Iterable[int], doc_len: int) -> None:
        self._df.update(set(term_ids))
        self.num_docs += 1
        self.total_len += doc_len

    def remove_doc(self, term_ids: Iterable[int], doc_len: int) -> None:
        for t in set(term_ids):
            self._df[t] -= 1
            if self._df[t] <= 0:
                del self._df[t]
        self.num_docs -= 1
        self.total_len -= doc_len

    def idf(self, term_id: int) -> float:
        df = self._df.get(term_id, 0)
        n = max(self.num_docs, 1)
        return math.log(1.0 + (n - df + 0.5) / (df + 0.5))

    def state(self) -> dict:
        return {
            "df": dict(self._df),
            "num_docs": self.num_docs,
            "total_len": self.total_len,
        }

    @classmethod
    def from_state(cls, state: dict) -> "DocFrequency":
        o = cls()
        o._df = Counter({int(k): v for k, v in state["df"].items()})
        o.num_docs = state["num_docs"]
        o.total_len = state["total_len"]
        return o
