"""Doc-major BM25 over a padded doc-term table
(port of the JAX package's ops/bm25.py).

Every document is a fixed row of L (term_id, tf) slots:

    idf_table[B, V+1]  scattered once per query batch (pad bucket idf=0)
    score[b, d] = sum_l idf_table[b, terms[d, l]] * sat(tf[d, l], len[d])

Serves the fresh tail not yet in the inverted snapshot, and small
corpora with no inverted index.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from super_rag_tpu_torch.ops.topk import NEG_INF, stable_topk


class LexicalCorpus(NamedTuple):
    """terms [N, L] int32 (pad = vocab_size), tfs [N, L] bf16 raw term
    frequencies, doc_len [N] f32 token counts."""

    terms: torch.Tensor
    tfs: torch.Tensor
    doc_len: torch.Tensor

    @property
    def size(self) -> int:
        return self.terms.shape[0]

    @property
    def slots(self) -> int:
        return self.terms.shape[1]


def build_lexical_corpus(terms: torch.Tensor, tfs: torch.Tensor,
                         doc_len: torch.Tensor) -> LexicalCorpus:
    return LexicalCorpus(terms=terms.to(torch.int32),
                         tfs=tfs.to(torch.bfloat16),
                         doc_len=doc_len.to(torch.float32))


def _idf_table(query_terms: torch.Tensor, query_idf: torch.Tensor,
               vocab_size: int) -> torch.Tensor:
    """Scatter per-query idf into a dense [B, V+1] lookup (pad col = 0)."""
    b = query_terms.shape[0]
    table = torch.zeros((b, vocab_size + 1), dtype=torch.float32,
                        device=query_terms.device)
    rows = torch.arange(b, device=query_terms.device)[:, None].expand_as(query_terms)
    table[rows, query_terms.long()] = query_idf.to(torch.float32)
    table[:, vocab_size] = 0.0
    return table


def _sat(tf: torch.Tensor, doc_len: torch.Tensor, avgdl: torch.Tensor,
         k1: float, b: float) -> torch.Tensor:
    """BM25 tf saturation ``tf (k1+1) / (tf + k1 (1 - b + b dl/avgdl))``
    (0 where tf = 0), in the reference's order of f32 operations."""
    norm = k1 * (1.0 - b + b * doc_len / avgdl)
    return tf * (k1 + 1.0) / (tf + norm)


def _bm25_block(table: torch.Tensor, terms: torch.Tensor, tfs: torch.Tensor,
                doc_len: torch.Tensor, avgdl: torch.Tensor, k1: float,
                b: float) -> torch.Tensor:
    sat = _sat(tfs.to(torch.float32), doc_len[:, None], avgdl, k1, b)
    qw = table[:, terms.long()]  # [B, T, L]
    return torch.einsum("btl,tl->bt", qw, sat)


def clamp_avgdl(avgdl, device) -> torch.Tensor:
    return torch.clamp(torch.as_tensor(avgdl, dtype=torch.float32,
                                       device=device), min=1e-6)


def bm25_search(
    query_terms: torch.Tensor,
    query_idf: torch.Tensor,
    corpus: LexicalCorpus,
    avgdl,
    *,
    vocab_size: int,
    k: int,
    mask: Optional[torch.Tensor] = None,
    k1: float = 1.2,
    b: float = 0.75,
    block_size: int = 8192,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k BM25 ``(scores [B, k], int32 ids [B, k])``; masked rows
    score -inf."""
    table = _idf_table(query_terms, query_idf, vocab_size)
    avgdl = clamp_avgdl(avgdl, corpus.terms.device)
    return _blocked_topk(table, corpus, avgdl, min(k, corpus.size), mask,
                         k1, b, block_size)


def _blocked_topk(table, corpus, avgdl, k_eff, mask, k1, b, block_size):
    """Doc-major scan in blocks of ``block_size`` rows with a per-block
    top-k and one merge (the [B, block, L] gather bounds peak memory)."""
    n = corpus.size
    if n <= block_size:
        s = _bm25_block(table, corpus.terms, corpus.tfs, corpus.doc_len,
                        avgdl, k1, b)
        if mask is not None:
            s = torch.where(mask[None, :n], s, NEG_INF)
        v, i = stable_topk(s, k_eff)
        return v, i.to(torch.int32)
    kb = min(k_eff, block_size)
    vals, idxs = [], []
    for lo in range(0, n, block_size):
        hi = min(lo + block_size, n)
        s = _bm25_block(table, corpus.terms[lo:hi], corpus.tfs[lo:hi],
                        corpus.doc_len[lo:hi], avgdl, k1, b)
        if mask is not None:
            s = torch.where(mask[None, lo:hi], s, NEG_INF)
        if hi - lo < block_size:  # the reference pads the last block
            s = torch.nn.functional.pad(s, (0, block_size - (hi - lo)),
                                        value=NEG_INF)
        v, i = stable_topk(s, kb)
        vals.append(v)
        idxs.append(i + lo)
    fv, pos = stable_topk(torch.cat(vals, 1), k_eff)
    return fv, torch.gather(torch.cat(idxs, 1), -1, pos).to(torch.int32)
