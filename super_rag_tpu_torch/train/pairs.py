"""Contrastive training pairs from an indexed collection (port of the JAX
package's train/pairs.py).

A self-hosted encoder needs in-domain pairs.  Two generators:

  * ICT (inverse cloze task): a sentence sampled from a chunk becomes the
    query, the chunk with that sentence removed is the positive — the
    standard zero-label pretraining objective for dense retrieval.
  * Title-to-body: the chunk's title path queries its body (cheap, uses
    the chunker's structure metadata).

Outputs feed ``train/contrastive.py make_train_step`` via the model tokenizer.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np

_SENT_SPLIT = re.compile(r"(?<=[.!?。！？])\s+")


@dataclass
class Pair:
    query: str
    positive: str


def ict_pairs(chunks: Sequence[str], rng: np.random.Generator,
              min_sentences: int = 2, samples_per_chunk: int = 1,
              keep_prob: float = 0.0) -> Iterator[Pair]:
    """Inverse cloze task pairs; chunks with < min_sentences are skipped.

    ``samples_per_chunk`` draws that many distinct query sentences per
    chunk; ``keep_prob`` leaves the query sentence inside the positive
    with that probability (the ORQA recipe — a small keep rate teaches
    lexical matching alongside the harder removed-sentence objective).
    """
    for text in chunks:
        sents = [s.strip() for s in _SENT_SPLIT.split(text) if s.strip()]
        if len(sents) < min_sentences:
            continue
        n_draw = min(samples_per_chunk, len(sents))
        for qi in rng.choice(len(sents), size=n_draw, replace=False):
            qi = int(qi)
            query = sents[qi]
            if rng.random() < keep_prob:
                rest = " ".join(sents)
            else:
                rest = " ".join(sents[:qi] + sents[qi + 1 :])
            if query and rest:
                yield Pair(query=query, positive=rest)


def title_pairs(chunks: Sequence[dict]) -> Iterator[Pair]:
    """chunks = [{text, title_path}] (engine row metadata shape)."""
    for c in chunks:
        title = c.get("title_path", "")
        text = c.get("text", "")
        if title and text and len(text.split()) >= 8:
            yield Pair(query=title.replace(" > ", " "), positive=text)


def pairs_from_engine(engine, rng: Optional[np.random.Generator] = None,
                      max_pairs: int = 10_000) -> list[Pair]:
    """Harvest pairs from a CollectionEngine's live rows
    (``engine.index.row_meta``)."""
    rng = rng or np.random.default_rng(0)
    metas = [m for m in engine.index.row_meta if m is not None]
    out: list[Pair] = []
    out.extend(title_pairs(metas))
    out.extend(ict_pairs([m["text"] for m in metas], rng))
    rng.shuffle(out)
    return out[:max_pairs]


def pairs_to_batches(pairs: Sequence[Pair], tokenizer, batch_size: int,
                     max_len: int = 128) -> Iterator[dict]:
    """Tokenize pairs into train-step batches (drops the ragged tail)."""
    for i in range(0, len(pairs) - batch_size + 1, batch_size):
        block = pairs[i : i + batch_size]
        q_ids, q_mask = tokenizer.encode_batch([p.query for p in block],
                                               max_len=max_len)
        d_ids, d_mask = tokenizer.encode_batch([p.positive for p in block],
                                               max_len=max_len)
        # pad q and d to the same bucket: one shape per step
        seq = max(q_ids.shape[1], d_ids.shape[1])

        def pad(a, s):
            return np.pad(a, ((0, 0), (0, s - a.shape[1])))

        yield {
            "q_ids": pad(q_ids, seq), "q_mask": pad(q_mask, seq),
            "d_ids": pad(d_ids, seq), "d_mask": pad(d_mask, seq),
        }
