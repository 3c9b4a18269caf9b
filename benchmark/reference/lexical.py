"""The lexical branch of the reference: exact BM25 of every row, and the
candidate generation under the budgets a configuration states.  A frozen
copy of the rule of the program's inverted tiers, written plainly:

- a term's postings are the rows holding it, one a slot, ordered by
  impact ``tf (k1 + 1) / (tf + k1 (1 - b + b dl / avgdl))`` in float32,
  highest first and the lower row first among equals;
- a query reads the first ``depth`` postings of each of its terms:
  ``lex_deep_postings`` for its ``lex_deep_terms`` lowest-idf terms,
  ``postings_per_query_term`` for the others, and no term past the
  table's ``table_postings`` where the tier keeps a table;
- a row's total is the sum, over the postings read, of the impact as
  stored (bfloat16) times the term's idf (float32);
- the ``lex_gen`` best totals (highest first, lower row first among
  equals), pooled with the dense candidates, are scored by exact BM25, and
  the best ``candidates`` of the pool are the lexical list.

Imports nothing of the program.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from benchmark import data
from benchmark.reference import retrieval, text

IMPACT_BITS = 0x7FFFFFFF


def stats(cfg: dict, seed: int, device) -> tuple[np.ndarray, float]:
    """Document frequencies of every bucket and the sum of the rows'
    lengths, in one pass over the term table."""
    n, vocab = cfg["rows"], cfg["lexical"]["vocab"]
    table = bucket_table(vocab, device)
    df = torch.zeros(vocab, dtype=torch.int64, device=device)
    total_len = 0.0
    for c, lo, hi in data.chunks(n):
        ranks, _, dl = data.lexical_chunk(seed, cfg, c, lo, hi, device)
        df += data.doc_freq(data.terms_of(ranks, table), vocab)
        total_len += float(dl.to(torch.float64).sum())
    return df.cpu().numpy(), total_len


def bucket_table(vocab: int, device) -> torch.Tensor:
    return data.bucket_table(vocab, lambda w: text.fnv1a32(w) & (vocab - 1), device)


def impacts(tfs: torch.Tensor, doc_len: torch.Tensor, avgdl: float) -> torch.Tensor:
    """float32 ``[rows, slots]`` impacts, in the order of float32
    operations the inverted tiers use (0 where tf = 0)."""
    k1, b = retrieval.K1, retrieval.B
    avgdl_t = torch.tensor(max(avgdl, 1e-6), dtype=torch.float32, device=tfs.device)
    tfs = tfs.to(torch.float32)
    norm = k1 * (1.0 - b + b * doc_len.to(torch.float32)[:, None] / avgdl_t)
    return tfs * (k1 + 1.0) / (tfs + norm)


def depths(q_terms: list, q_idf32: np.ndarray, opts: dict, table_postings: Optional[int]) -> list:
    """How many postings the query reads of each of its terms."""
    cap = table_postings or 1 << 62
    deep = opts.get("lex_deep_terms", 0)
    order = sorted(range(len(q_terms)), key=lambda j: (float(q_idf32[j]), j))[:deep]
    out = [min(cap, opts["postings_per_query_term"])] * len(q_terms)
    for j in order:
        out[j] = min(cap, opts["lex_deep_postings"])
    return out


class Postings:
    """The first ``depth[t]`` postings of each asked term ``t``, gathered
    chunk by chunk: ``(term index << 31 | inverted impact bits, row)``
    pairs, kept in posting order."""

    def __init__(self, depth: dict, device):
        self.terms = torch.tensor(sorted(depth), dtype=torch.int64, device=device)
        self.depth = torch.tensor([depth[t] for t in sorted(depth)], dtype=torch.int64,
                                  device=device)
        self.index = {t: j for j, t in enumerate(sorted(depth))}
        self.keys: list = []
        self.rows: list = []

    def _prefix(self, major: torch.Tensor, key: torch.Tensor, rows: torch.Tensor):
        """Sorted by ``key`` (stable), the entries within each major's
        first ``depth``."""
        order = torch.sort(key, stable=True).indices
        major, rows = major[order], rows[order]
        at = torch.arange(major.shape[0], device=major.device)
        start = torch.ones_like(major, dtype=torch.bool)
        start[1:] = major[1:] != major[:-1]
        rank = at - torch.cummax(torch.where(start, at, 0), 0).values
        keep = rank < self.depth[major]
        return order[keep], rows[keep]

    def add(self, terms: torch.Tensor, impact: torch.Tensor, lo: int) -> None:
        flat = terms.reshape(-1).to(torch.int64)
        hit = torch.isin(flat, self.terms).nonzero().squeeze(1)
        if not hit.numel():
            return
        major = torch.searchsorted(self.terms, flat[hit])
        inv = IMPACT_BITS - impact.reshape(-1)[hit].view(torch.int32).to(torch.int64)
        local = torch.div(hit, terms.shape[1], rounding_mode="floor")
        # row within the chunk in the low 20 bits: ties in impact go by row
        key = (major << 51) | (inv << 20) | local
        kept, rows = self._prefix(major, key, local + lo)
        self.keys.append((major[kept] << 31) | inv[kept])
        self.rows.append(rows)

    def finish(self) -> dict:
        """term -> (rows, stored impacts in float32), in posting order."""
        if not self.keys:
            return {}
        key, rows = torch.cat(self.keys), torch.cat(self.rows)
        kept, rows = self._prefix(key >> 31, key, rows)
        key = key[kept]
        major = key >> 31
        imp = (IMPACT_BITS - (key & IMPACT_BITS)).to(torch.int32).view(torch.float32)
        imp = imp.to(torch.bfloat16).to(torch.float32)
        out = {}
        for t, j in self.index.items():
            sel = major == j
            out[t] = (rows[sel], imp[sel])
        return out


def generate(postings: dict, q_terms: list, q_idf32: np.ndarray, depth: list, k: int,
             dtype=torch.float32) -> torch.Tensor:
    """The rows of the ``k`` best totals (positive only), best first: in
    float32 sums of float32 weights, or with ``dtype`` bfloat16 (the
    control) bfloat16 weights and totals."""
    rows, weights = [], []
    for t, w, d in zip(q_terms, q_idf32, depth):
        if t not in postings:
            continue
        r, imp = postings[t]
        rows.append(r[:d])
        weights.append(imp[:d].to(dtype) * torch.tensor(float(w), dtype=torch.float32).to(dtype))
    if not rows:
        return torch.zeros(0, dtype=torch.int64)
    rows, weights = torch.cat(rows), torch.cat(weights)
    uniq, inv = torch.unique(rows, return_inverse=True)
    total = torch.zeros(uniq.shape[0], dtype=torch.float64, device=rows.device)
    total.index_add_(0, inv, weights.to(torch.float64))
    total = total.to(dtype).to(torch.float32)
    keep = total > 0
    uniq, total = uniq[keep], total[keep]
    order = torch.sort(-total, stable=True).indices[:k]  # uniq is ascending: lower row first
    return uniq[order]


def best_of_pool(pool: np.ndarray, scores: torch.Tensor, k: int) -> tuple[np.ndarray, np.ndarray]:
    """The ``k`` best rows of ``pool`` (distinct, >= 0) by ``scores`` (one
    query's row scores), positive only, lower row first among equals."""
    pool = np.unique(pool[pool >= 0])
    if not pool.size:
        return pool.astype(np.int64), np.zeros(0)
    s = scores[torch.from_numpy(pool).to(scores.device)].double().cpu().numpy()
    order = np.lexsort((pool, -s))[:k]
    order = order[s[order] > 0]
    return pool[order].astype(np.int64), s[order]
