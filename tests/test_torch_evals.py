"""The port's retrieval evaluation (``super_rag_tpu_torch/evals.py``) against
the JAX package's: both engines ingest the same texts through their hash
embedders (as tests/test_evals.py), and the same labeled queries give the
same report, per-query lists included."""

import jax.numpy as jnp
import pytest
import torch

from super_rag_tpu.engine.collection import CollectionEngine as JEngine
from super_rag_tpu.engine.index import IndexSpec as JSpec
from super_rag_tpu.evals import LabeledQuery as JLabeled
from super_rag_tpu.evals import evaluate_engine as j_evaluate
from super_rag_tpu_torch.engine.collection import CollectionEngine as TEngine
from super_rag_tpu_torch.engine.index import IndexSpec as TSpec
from super_rag_tpu_torch.evals import EvalReport, LabeledQuery, evaluate_engine

TEXTS = [
    "the fox jumps over the dog",
    "systolic arrays multiply matrices",
    "reciprocal rank fusion merges lists",
    "the river runs past the mill and the mill grinds grain",
    "flour water salt and yeast make bread",
    "tensor cores run warps of threads",
    "dense retrieval ranks chunks by cosine",
    "a soup of river fish leeks and potatoes",
    "the dog sleeps by the fire",
    "bm25 scores terms by frequency and rarity",
]
LABELED = [
    ("fox and dog", {"doc0", "doc8"}),
    ("matrix multiplication hardware", {"doc1", "doc5"}),
    ("rank fusion", {"doc2"}),
    ("river mill", {"doc3", "doc7"}),
    ("bread dough yeast", {"doc4"}),
    ("cosine retrieval of chunks", {"doc6"}),
    ("term frequency scoring", {"doc9"}),
    ("zyzzyva quokka", {"doc5"}),
    ("nothing relevant", set()),
]


@pytest.fixture(scope="module")
def engines():
    torch.set_num_threads(2)
    je = JEngine(JSpec(dim=64, dtype=jnp.float32, vocab_size=1 << 14))
    te = TEngine(TSpec(dim=64, dtype=torch.float32, vocab_size=1 << 14), device="cpu")
    meta = [{"document_id": f"doc{i}", "section": f"s{i % 3}"} for i in range(len(TEXTS))]
    je.ingest(TEXTS, metadata=meta)
    te.ingest(TEXTS, metadata=meta)
    return je, te


@pytest.mark.parametrize("mode", ["hybrid", "dense", "fulltext"])
@pytest.mark.parametrize("ks", [(1, 5, 10), (1, 3), (2,)])
def test_reports_equal(engines, mode, ks):
    je, te = engines
    want = j_evaluate(je, [JLabeled(q, r) for q, r in LABELED], ks=ks, mode=mode)
    got = evaluate_engine(te, [LabeledQuery(q, r) for q, r in LABELED], ks=ks, mode=mode)
    assert isinstance(got, EvalReport)
    assert got.to_dict() == want.to_dict()
    assert got.per_query == want.per_query
    assert (got.mrr, got.ndcg_at_10) == (want.mrr, want.ndcg_at_10)
    assert set(got.to_dict()) == {"n_queries", "recall_at_k", "mrr", "ndcg_at_10"}


def test_other_metadata_key_and_no_queries(engines):
    je, te = engines
    labeled = [("river", {"s0"}), ("bread", {"s1", "s2"})]
    want = j_evaluate(je, [JLabeled(q, r) for q, r in labeled], doc_id_key="section")
    got = evaluate_engine(te, [LabeledQuery(q, r) for q, r in labeled], doc_id_key="section")
    assert got.to_dict() == want.to_dict() and got.per_query == want.per_query
    assert evaluate_engine(te, []).to_dict() == j_evaluate(je, []).to_dict()


def test_hash_embedder_finds_most(engines):
    """tests/test_evals.py's bounds, on the port."""
    _, te = engines
    report = evaluate_engine(te, [LabeledQuery(q, r) for q, r in LABELED[:7]], ks=(1, 3))
    assert report.n_queries == 7
    assert report.recall_at_k[3] >= report.recall_at_k[1] >= 0.5
    assert 0 < report.mrr <= 1 and 0 < report.ndcg_at_10 <= 1
