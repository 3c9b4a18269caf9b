"""Offline-trainable BPE subword tokenizer for the encoders (port of the
JAX package's models/subword.py).

The reference reaches real subword vocabularies through remote model
APIs (embedding requests are tokenized server-side) and tiktoken —
both need network.  Here the tokenizer itself is trained on the user's
own corpus at checkpoint-training time (zero egress, in-domain
vocabulary) and saved next to the encoder weights, replacing the
word-hashing fallback whose collisions and lack of subword sharing cap
semantic generalization.

Classic byte-pair encoding (Sennrich et al. 2016): words split to
characters plus an end-of-word marker, the most frequent adjacent
symbol pair merges iteratively, and encoding replays merges by rank.
Training uses incremental pair-count updates (only words containing the
merged pair are touched), so a 50k-unique-word corpus trains ~10k
merges in seconds-to-minutes of pure Python — a one-time offline cost.

Implements the models.tokenization.Tokenizer protocol (encode_batch /
encode_pairs with the same special ids and length bucketing), so it is
a drop-in for HashTokenizer in EncoderService and the training stack.
"""

from __future__ import annotations

import json
from collections import Counter
from typing import Iterable, Sequence

from super_rag_tpu_torch.models.encoder import bucket_length
from super_rag_tpu_torch.models.tokenization import pack_pairs, pad_rows
from super_rag_tpu_torch.tokenize.analyzer import _CJK_RE, _WORD_RE

END = "</w>"

PAD_ID, CLS_ID, SEP_ID, UNK_ID = 0, 1, 2, 3
NUM_SPECIAL = 4


def _words(text: str) -> list[str]:
    text = text.lower()
    out = _WORD_RE.findall(text)
    for run in _CJK_RE.findall(text):
        out.extend(run)
    return out


def train_bpe(
    texts: Iterable[str],
    vocab_size: int = 30522,
    min_pair_freq: int = 2,
    max_unique_words: int = 500_000,
) -> "BPETokenizer":
    """Learn a BPE vocabulary from raw texts.

    Stops at ``vocab_size`` total ids (specials + alphabet + merges) or
    when no adjacent pair occurs ``min_pair_freq`` times.
    """
    freqs: Counter[str] = Counter()
    for t in texts:
        freqs.update(_words(t))
    if len(freqs) > max_unique_words:
        freqs = Counter(dict(freqs.most_common(max_unique_words)))

    # symbol sequence per unique word, weighted by word frequency
    seqs: dict[str, list[str]] = {w: list(w) + [END] for w in freqs}
    alphabet = sorted({s for seq in seqs.values() for s in seq})

    pair_counts: Counter[tuple[str, str]] = Counter()
    pair_words: dict[tuple[str, str], set[str]] = {}
    for w, seq in seqs.items():
        f = freqs[w]
        for a, b in zip(seq, seq[1:]):
            pair_counts[(a, b)] += f
            pair_words.setdefault((a, b), set()).add(w)

    merges: list[tuple[str, str]] = []
    budget = vocab_size - NUM_SPECIAL - len(alphabet)
    # lazy max-heap over pair counts: stale entries are re-validated at
    # pop time (a full-dict argmax per merge is O(|pairs|) and makes 30k
    # merges over a real corpus take hours)
    import heapq

    heap = [(-n, p) for p, n in pair_counts.items()]
    heapq.heapify(heap)
    while len(merges) < budget and heap:
        neg_n, best = heapq.heappop(heap)
        cur = pair_counts.get(best, 0)
        if cur != -neg_n:  # stale: re-push with the live count
            if cur >= min_pair_freq:
                heapq.heappush(heap, (-cur, best))
            continue
        if cur < min_pair_freq:
            continue
        merges.append(best)
        merged = best[0] + best[1]
        created: set[tuple[str, str]] = set()
        for w in list(pair_words.get(best, ())):
            seq = seqs[w]
            f = freqs[w]
            i = 0
            while i < len(seq) - 1:
                if seq[i] == best[0] and seq[i + 1] == best[1]:
                    # retire old neighbor pairs, splice, add new ones
                    if i > 0:
                        _dec(pair_counts, pair_words, (seq[i - 1], seq[i]),
                             f, w, seqs)
                    if i + 2 < len(seq):
                        _dec(pair_counts, pair_words,
                             (seq[i + 1], seq[i + 2]), f, w, seqs)
                    seq[i : i + 2] = [merged]
                    if i > 0:
                        _inc(pair_counts, pair_words, (seq[i - 1], merged),
                             f, w)
                        created.add((seq[i - 1], merged))
                    if i + 1 < len(seq):
                        _inc(pair_counts, pair_words, (merged, seq[i + 1]),
                             f, w)
                        created.add((merged, seq[i + 1]))
                else:
                    i += 1
        pair_counts.pop(best, None)
        pair_words.pop(best, None)
        for p in created:
            n = pair_counts.get(p, 0)
            if n >= min_pair_freq:
                heapq.heappush(heap, (-n, p))

    tokens = alphabet + [a + b for a, b in merges]
    return BPETokenizer(tokens, merges)


def _dec(counts, words, pair, f, w, seqs):
    counts[pair] -= f
    if counts[pair] <= 0:
        counts.pop(pair, None)
        words.pop(pair, None)
    elif pair in words and not _contains(seqs[w], pair):
        words[pair].discard(w)


def _inc(counts, words, pair, f, w):
    counts[pair] += f
    words.setdefault(pair, set()).add(w)


def _contains(seq, pair):
    return any(a == pair[0] and b == pair[1] for a, b in zip(seq, seq[1:]))


class BPETokenizer:
    """Greedy rank-ordered BPE encoder over a trained vocabulary."""

    pad_id = PAD_ID
    cls_id = CLS_ID
    sep_id = SEP_ID
    unk_id = UNK_ID
    num_special = NUM_SPECIAL

    def __init__(self, tokens: Sequence[str],
                 merges: Sequence[tuple[str, str]]):
        self.tokens = list(tokens)
        self.merges = [tuple(m) for m in merges]
        self._id = {t: NUM_SPECIAL + i for i, t in enumerate(self.tokens)}
        self._rank = {m: i for i, m in enumerate(self.merges)}
        self._cache: dict[str, list[int]] = {}
        self._native = None  # lazily-created native encoder (or False)

    # the native handle is per-process state: drop it when the tokenizer
    # crosses a pickle boundary (process ingest workers) and rebuild lazily
    def __getstate__(self):
        state = dict(self.__dict__)
        state["_native"] = None
        return state

    def _native_encoder(self):
        if self._native is None:
            from super_rag_tpu_torch.tokenize.native_bpe import NativeBPE

            self._native = NativeBPE.create(self.tokens, self.merges) or False
        return self._native or None

    @property
    def vocab_size(self) -> int:
        return NUM_SPECIAL + len(self.tokens)

    # -- persistence ------------------------------------------------------

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"version": 1, "tokens": self.tokens,
                       "merges": [list(m) for m in self.merges]}, f)

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        with open(path) as f:
            d = json.load(f)
        return cls(d["tokens"], [tuple(m) for m in d["merges"]])

    # -- encoding ---------------------------------------------------------

    def _encode_word(self, w: str) -> list[int]:
        hit = self._cache.get(w)
        if hit is not None:
            return hit
        syms = list(w) + [END]
        while len(syms) > 1:
            best_rank, best_i = None, -1
            for i, pair in enumerate(zip(syms, syms[1:])):
                r = self._rank.get(pair)
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            syms[best_i : best_i + 2] = [syms[best_i] + syms[best_i + 1]]
        ids = [self._id.get(s, UNK_ID) for s in syms]
        if len(self._cache) < 1_000_000:
            self._cache[w] = ids
        return ids

    def _text_ids(self, text: str) -> list[int]:
        native = self._native_encoder()
        if native is not None:
            return native.encode(text).tolist()
        out: list[int] = []
        for w in _words(text):
            out.extend(self._encode_word(w))
        return out

    def encode_batch(self, texts, max_len: int = 512):
        rows = [
            [CLS_ID] + self._text_ids(t)[: max_len - 2] + [SEP_ID]
            for t in texts
        ]
        seq = bucket_length(max(len(r) for r in rows)) if rows else 8
        return pad_rows(rows, min(seq, max_len), PAD_ID)

    def encode_pairs(self, queries, docs, max_len: int = 512):
        if len(queries) != len(docs):
            raise ValueError("queries and docs differ in length")
        rows, types = [], []
        for q, d in zip(queries, docs):
            qi = self._text_ids(q)[: max_len // 4]
            di = self._text_ids(d)[: max_len - len(qi) - 3]
            rows.append([CLS_ID] + qi + [SEP_ID] + di + [SEP_ID])
            types.append([0] * (len(qi) + 2) + [1] * (len(di) + 1))
        return pack_pairs(rows, types, max_len, PAD_ID)
