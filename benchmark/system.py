"""Builds the system under test, the ``super_rag_tpu_torch`` port, from a
configuration and the seed's inputs: the query encoder and the
cross-encoder (seeded HF BERT weights through ``models/hf_loader.py``),
the index (f32 rows through the port's ``build_corpus``, term ranks
through the port's analyzer, loaded by ``DeviceIndex.from_snapshot`` and
compacted by ``compact_lexical``) and the ``CollectionEngine`` that the
window drives.  Also the query pool the traffic draws from.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from benchmark import data

DTYPES = {"int8": torch.int8, "bfloat16": torch.bfloat16, "float32": torch.float32}
TIERS = {"InvertedIndex": "table", "CSRInvertedIndex": "csr"}


@dataclass
class System:
    engine: object
    encoder: object
    reranker: Optional[object]
    queries: list  # the query pool
    rows: int
    marks: dict = field(default_factory=dict)  # set-up step -> seconds


def _services(cfg: dict, seed: int, device):
    from super_rag_tpu_torch.models.encoder_service import EncoderService
    from super_rag_tpu_torch.models.hf_loader import (
        config_from_hf, cross_encoder_params_from_bert, encoder_params_from_bert)
    from super_rag_tpu_torch.service.rerank_service import RerankService

    enc_cfg = cfg["encoder"]
    ecfg = config_from_hf(SimpleNamespace(**enc_cfg["model"]))
    sd = data.model_weights(seed, enc_cfg, "encoder", device)
    encoder = EncoderService(ecfg, params=encoder_params_from_bert(sd, ecfg),
                             batch_size=enc_cfg["batch_size"], max_len=enc_cfg["max_len"],
                             device=device)
    del sd
    reranker = None
    rr_cfg = cfg.get("reranker")
    if rr_cfg:
        rcfg = config_from_hf(SimpleNamespace(**rr_cfg["model"]))
        sd = data.model_weights(seed, rr_cfg, "reranker", device)
        reranker = RerankService(rcfg, params=cross_encoder_params_from_bert(sd, rcfg),
                                 max_len=rr_cfg["max_len"], batch_size=rr_cfg["batch_size"],
                                 device=device)
        del sd
    return encoder, reranker


def build(cfg: dict, traffic: dict, seed: int, device, log=print) -> System:
    from super_rag_tpu_torch.engine.collection import CollectionEngine
    from super_rag_tpu_torch.engine.index import DeviceIndex, IndexSpec
    from super_rag_tpu_torch.ops.dense import Metric, build_corpus
    from super_rag_tpu_torch.tokenize.analyzer import Analyzer

    marks: dict = {}
    t0 = time.perf_counter()

    def mark(name: str) -> None:
        nonlocal t0
        if device != "cpu":
            torch.cuda.synchronize()
        marks[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    encoder, reranker = _services(cfg, seed, device)
    mark("models")

    n, dim, lex = cfg["rows"], cfg["dim"], cfg["lexical"]
    storage = DTYPES[cfg["storage_dtype"]]
    vocab, slots = lex["vocab"], lex["slots"]
    analyzer = Analyzer(vocab_size=vocab)
    table = data.bucket_table(vocab, lambda w: analyzer.term_ids(w)[0], device)
    emb = torch.empty((n, dim), dtype=storage, device=device)
    scales = torch.empty((n,), dtype=torch.float32, device=device) if storage == torch.int8 else None
    terms = torch.empty((n, slots), dtype=torch.int32, device=device)
    tfs = torch.empty((n, slots), dtype=torch.bfloat16, device=device)
    doc_len = torch.empty((n,), dtype=torch.float32, device=device)
    df = torch.zeros(vocab, dtype=torch.int64, device=device)
    words = cfg.get("chunk_words", 0)
    wtable = data.word_table(vocab) if words else None
    texts: list = []
    qrows = data.query_rows(seed, n, traffic["pool"])
    qranks = np.zeros((len(qrows), slots), np.int32)
    for c, lo, hi in data.chunks(n):
        corpus = build_corpus(data.rows_chunk(seed, cfg, c, lo, hi, device),
                              metric=Metric.COSINE, dtype=storage)
        emb[lo:hi] = corpus.values
        if scales is not None:
            scales[lo:hi] = corpus.scales
        del corpus
        ranks, tf, dl = data.lexical_chunk(seed, cfg, c, lo, hi, device)
        t = data.terms_of(ranks, table)
        terms[lo:hi], tfs[lo:hi], doc_len[lo:hi] = t, tf, dl
        df += data.doc_freq(t, vocab)
        if words:
            texts.extend(data.row_texts(ranks, tf, words, wtable))
        sel = np.flatnonzero((qrows >= lo) & (qrows < hi))
        if sel.size:
            qranks[sel] = ranks[torch.from_numpy(qrows[sel] - lo).to(device)].cpu().numpy()
    mark("corpus" if not words else "corpus_and_texts")

    meta = ([{"text": t} for t in texts] if words
            else [{"text": f"chunk {r}"} for r in range(n)])
    del texts
    df_host = df.cpu().numpy()
    host = {
        "spec": {"dim": dim, "metric": "cosine", "dtype": cfg["storage_dtype"],
                 "bm25_slots": slots, "vocab_size": vocab, "min_capacity": 4096},
        "size": n,
        "row_meta": meta,
        "df": {"df": {int(t): int(df_host[t]) for t in np.flatnonzero(df_host)},
               "num_docs": n, "total_len": float(doc_len.to(torch.float64).sum())},
    }
    mark("row_meta")
    arrays = {"emb": emb, "terms": terms, "tfs": tfs, "doc_len": doc_len,
              "valid": torch.ones(n, dtype=torch.bool, device=device)}
    if scales is not None:
        arrays["scales"] = scales
    idx = DeviceIndex.from_snapshot(arrays, host, device=device)
    # the tier the configuration states, not the one the row count picks
    idx.spec = dataclasses.replace(idx.spec, lex_tier=TIERS[lex["index_type"]])
    del arrays, emb, scales, terms, tfs, doc_len, host, meta
    mark("index")
    if lex["index_type"] == "InvertedIndex":
        idx.compact_lexical(postings_per_term=lex["table_postings"])
    else:
        idx.compact_lexical()
    tier = type(idx._inverted).__name__
    if tier != lex["index_type"]:
        raise RuntimeError(f"compact_lexical built {tier}, the configuration states "
                           f"{lex['index_type']}")
    mark("compact_lexical")

    engine = CollectionEngine(IndexSpec(dim=dim, dtype=storage, bm25_slots=slots,
                                        vocab_size=vocab),
                              embedder=encoder, reranker=reranker,
                              hybrid_opts=dict(cfg.get("hybrid_opts", {})), device=device)
    engine.index = idx
    lengths = data.query_lengths(len(qrows), traffic["query_words"]["min"],
                                 traffic["query_words"]["max"],
                                 traffic["query_words"]["zipf"], seed)
    queries = data.query_texts(qranks, lengths, df_host, n, vocab)
    mark("queries")
    log(f"set-up steps (s): " + ", ".join(f"{k} {v:.3f}" for k, v in marks.items()))
    return System(engine=engine, encoder=encoder, reranker=reranker, queries=queries,
                  rows=n, marks=marks)
