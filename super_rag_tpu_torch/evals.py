"""Retrieval evaluation: recall@k, MRR, NDCG over labeled query sets (port
of the JAX package's evals.py).

A self-hosted engine needs retrieval metrics to tune its quantization,
nprobe and candidate knobs.  Works over any engine with
``search(query, top_k=, mode=)``, such as ``engine/collection.py
CollectionEngine``, whose hybrid search runs on ``dense_topk``."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Sequence


@dataclass
class LabeledQuery:
    query: str
    relevant_doc_ids: set[str]  # document_id values expected in results


@dataclass
class EvalReport:
    n_queries: int
    recall_at_k: dict[int, float]
    mrr: float
    ndcg_at_10: float
    per_query: list[dict] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "n_queries": self.n_queries,
            "recall_at_k": self.recall_at_k,
            "mrr": round(self.mrr, 4),
            "ndcg_at_10": round(self.ndcg_at_10, 4),
        }


def evaluate_engine(
    engine,
    labeled: Sequence[LabeledQuery],
    ks: Sequence[int] = (1, 5, 10),
    mode: str = "hybrid",
    doc_id_key: str = "document_id",
) -> EvalReport:
    max_k = max(ks)
    recalls = {k: [] for k in ks}
    rrs = []
    ndcgs = []
    per_query = []
    for lq in labeled:
        hits = engine.search(lq.query, top_k=max_k, mode=mode)
        got = [h.metadata.get(doc_id_key) for h in hits]
        rel = lq.relevant_doc_ids
        for k in ks:
            found = sum(1 for d in got[:k] if d in rel)
            recalls[k].append(found / max(1, min(len(rel), k)))
        rr = 0.0
        for rank, d in enumerate(got):
            if d in rel:
                rr = 1.0 / (rank + 1)
                break
        rrs.append(rr)
        dcg = sum(
            1.0 / math.log2(rank + 2)
            for rank, d in enumerate(got[:10]) if d in rel
        )
        idcg = sum(1.0 / math.log2(r + 2) for r in range(min(len(rel), 10)))
        ndcgs.append(dcg / idcg if idcg > 0 else 0.0)
        per_query.append({"query": lq.query, "rr": rr, "got": got[:5]})
    n = max(1, len(labeled))
    return EvalReport(
        n_queries=len(labeled),
        recall_at_k={k: round(sum(v) / n, 4) for k, v in recalls.items()},
        mrr=sum(rrs) / n,
        ndcg_at_10=sum(ndcgs) / n,
        per_query=per_query,
    )
