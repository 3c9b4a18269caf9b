"""Tokenizers feeding the encoders (port of the JAX package's
models/tokenization.py).

Two implementations behind one protocol:
  * HashTokenizer — offline, weight-free: words hash into the model vocab
    (pairs with random-init encoders and the demo path).
  * HFTokenizer — wraps a local HuggingFace tokenizer when a real
    checkpoint directory is available (no network access assumed).

Both emit (ids, mask[, type_ids]) numpy batches padded to the
sequence-length buckets of models/encoder.py.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Protocol, Sequence

import numpy as np

from super_rag_tpu_torch.models.encoder import bucket_length
from super_rag_tpu_torch.tokenize.analyzer import _CJK_RE, _WORD_RE, fnv1a32


class Tokenizer(Protocol):
    def encode_batch(
        self, texts: Sequence[str], max_len: int = 512
    ) -> tuple[np.ndarray, np.ndarray]: ...

    def encode_pairs(
        self, queries: Sequence[str], docs: Sequence[str], max_len: int = 512
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]: ...


# a word's hash is a pure function of the word; the pure-Python FNV loop
# costs microseconds a word, so repeated words are looked up
_word_hash = functools.lru_cache(maxsize=1 << 20)(fnv1a32)


def pad_rows(rows: list[list[int]], seq: int, pad_id: int):
    ids = np.full((len(rows), seq), pad_id, np.int32)
    mask = np.zeros((len(rows), seq), bool)
    for i, r in enumerate(rows):
        r = r[:seq]
        ids[i, : len(r)] = r
        mask[i, : len(r)] = True
    return ids, mask


def pack_pairs(rows: list[list[int]], types: list[list[int]],
                max_len: int, pad_id: int):
    seq = min(bucket_length(max(len(r) for r in rows)), max_len)
    ids, mask = pad_rows(rows, seq, pad_id)
    tt = np.zeros((len(rows), seq), np.int32)
    for i, t in enumerate(types):
        t = t[:seq]
        tt[i, : len(t)] = t
    return ids, mask, tt


@dataclass
class HashTokenizer:
    """Word-level hashing tokenizer: ids in [num_special, vocab)."""

    vocab_size: int = 30522
    pad_id: int = 0
    cls_id: int = 1
    sep_id: int = 2
    num_special: int = 3

    def _word_ids(self, text: str) -> list[int]:
        text = text.lower()
        words = _WORD_RE.findall(text)
        for run in _CJK_RE.findall(text):
            words.extend(run)
        span = self.vocab_size - self.num_special
        return [self.num_special + (_word_hash(w) % span) for w in words]

    def encode_batch(self, texts, max_len: int = 512):
        rows = [
            [self.cls_id] + self._word_ids(t)[: max_len - 2] + [self.sep_id]
            for t in texts
        ]
        seq = bucket_length(max(len(r) for r in rows)) if rows else 8
        return pad_rows(rows, min(seq, max_len), self.pad_id)

    def encode_pairs(self, queries, docs, max_len: int = 512):
        if len(queries) != len(docs):
            raise ValueError("queries and docs differ in length")
        rows, types = [], []
        for q, d in zip(queries, docs):
            qi = self._word_ids(q)[: max_len // 4]
            di = self._word_ids(d)[: max_len - len(qi) - 3]
            rows.append([self.cls_id] + qi + [self.sep_id] + di + [self.sep_id])
            types.append([0] * (len(qi) + 2) + [1] * (len(di) + 1))
        return pack_pairs(rows, types, max_len, self.pad_id)


class HFTokenizer:
    """Local HuggingFace tokenizer (path-only; never downloads)."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)

    @staticmethod
    def _to_bucket(enc, max_len: int, keys):
        width = enc["input_ids"].shape[1]
        pad = max(min(bucket_length(width), max_len) - width, 0)
        return [np.pad(enc[k], ((0, 0), (0, pad))) for k in keys]

    def encode_batch(self, texts, max_len: int = 512):
        enc = self._tok(
            list(texts), padding=True, truncation=True, max_length=max_len,
            return_tensors="np",
        )
        ids, mask = self._to_bucket(enc, max_len, ("input_ids", "attention_mask"))
        return ids.astype(np.int32), mask.astype(bool)

    def encode_pairs(self, queries, docs, max_len: int = 512):
        enc = self._tok(
            list(queries), list(docs), padding=True, truncation=True,
            max_length=max_len, return_tensors="np",
        )
        ids, mask, tt = self._to_bucket(
            enc, max_len, ("input_ids", "attention_mask", "token_type_ids"))
        return ids.astype(np.int32), mask.astype(bool), tt.astype(np.int32)
