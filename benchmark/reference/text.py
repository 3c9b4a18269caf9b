"""Text rules of the plain reference: frozen copies, so that the
reference derives tokens and term buckets without the program.

- ``fnv1a32`` and ``analyzer_terms``: the lexical analyzer's rule
  (``super_rag_tpu_torch/tokenize/analyzer.py:32,61-74``): lower case,
  ``[a-z0-9_]+`` words less a small stopword list, CJK runs as character
  bigrams, each term's bucket ``fnv1a32(term) & (V - 1)``.
- ``hash_ids``, ``encode`` and ``encode_pair``: the word-hashing model
  tokenizer (``super_rag_tpu_torch/models/tokenization.py:55-94``):
  ``3 + fnv1a32(word) % (V - 3)``, ``[CLS] = 1``, ``[SEP] = 2``, a pair's
  query cut to ``max_len // 4`` words and its document to what is left.
"""

from __future__ import annotations

import functools
import re

WORD_RE = re.compile(r"[a-z0-9_]+")
CJK_RE = re.compile(r"[一-鿿぀-ヿ가-힯]+")
STOPWORDS = frozenset(
    """a an and are as at be by for from has have in is it its of on or that
    the this to was were will with not but they you we he she i""".split()
)
CLS, SEP, NUM_SPECIAL = 1, 2, 3


def fnv1a32(s: str) -> int:
    h = 0x811C9DC5
    for byte in s.encode("utf-8"):
        h ^= byte
        h = (h * 0x01000193) & 0xFFFFFFFF
    return h


def analyzer_terms(text: str, vocab: int) -> list[int]:
    """Term buckets of ``text`` in order, repeats kept."""
    text = text.lower()
    words = [w for w in WORD_RE.findall(text) if w not in STOPWORDS]
    for run in CJK_RE.findall(text):
        words.extend([run] if len(run) == 1
                     else [run[i:i + 2] for i in range(len(run) - 1)])
    return [fnv1a32(w) & (vocab - 1) for w in words]


def query_terms(text: str, vocab: int, max_terms: int = 16) -> list[int]:
    """A query's distinct buckets in order of first appearance, at most
    ``max_terms`` of them."""
    return list(dict.fromkeys(analyzer_terms(text, vocab)))[:max_terms]


_word_hash = functools.lru_cache(maxsize=1 << 20)(fnv1a32)


def model_words(text: str) -> list[str]:
    text = text.lower()
    words = WORD_RE.findall(text)
    for run in CJK_RE.findall(text):
        words.extend(run)
    return words


def hash_ids(text: str, vocab: int) -> list[int]:
    span = vocab - NUM_SPECIAL
    return [NUM_SPECIAL + _word_hash(w) % span for w in model_words(text)]


def text_length(text: str, max_len: int) -> int:
    """Tokens of ``encode(text)``, counted without hashing."""
    return min(len(model_words(text)), max_len - 2) + 2


def pair_length(query: str, doc: str, max_len: int) -> int:
    """Tokens of ``encode_pair(query, doc)``, counted without hashing."""
    nq = min(len(model_words(query)), max_len // 4)
    return nq + min(len(model_words(doc)), max_len - nq - 3) + 3


def encode(text: str, vocab: int, max_len: int) -> list[int]:
    return [CLS] + hash_ids(text, vocab)[:max_len - 2] + [SEP]


def encode_pair(query: str, doc: str, vocab: int,
                max_len: int) -> tuple[list[int], list[int]]:
    """(ids, token types) of ``[CLS] query [SEP] doc [SEP]``."""
    qi = hash_ids(query, vocab)[:max_len // 4]
    di = hash_ids(doc, vocab)[:max_len - len(qi) - 3]
    ids = [CLS] + qi + [SEP] + di + [SEP]
    return ids, [0] * (len(qi) + 2) + [1] * (len(di) + 1)
