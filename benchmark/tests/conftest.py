"""Shared pieces of the benchmark's CPU tests: the repository root on the
path, ``BENCHMARK.json`` with the shelved cells added back, and overrides
that shrink a cell to a size a test can hold (the model and corpus widths
cut, the harness, the program and the reference unchanged)."""

import atexit
import functools
import json
import os
import shutil
import sys
import tempfile

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# cells measured on the card but not held to bounds yet (their runs spread
# past what the largest bound allows): their entries, as BENCHMARK.json
# would hold them, so that their pieces stay tested
SHELVED = os.path.join(os.path.dirname(os.path.abspath(__file__)), "shelved_cells.json")


@functools.lru_cache(maxsize=None)
def spec_path() -> str:
    """A copy of ``BENCHMARK.json`` with the entries of ``SHELVED`` added."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    with open(SHELVED) as f:
        for key, entries in json.load(f).items():
            spec[key] = spec[key] + entries
    d = tempfile.mkdtemp(prefix="benchmark-spec-")
    atexit.register(shutil.rmtree, d, True)
    path = os.path.join(d, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    return path

TINY_MODEL = {"vocab_size": 1000, "hidden_size": 32, "num_hidden_layers": 2,
              "num_attention_heads": 2, "intermediate_size": 64,
              "max_position_embeddings": 128, "type_vocab_size": 2, "layer_norm_eps": 1e-12}

# limits for the tiny cells, set from their sound CPU readings (embed_err
# ~2e-5, dense_err ~3e-3, dense_gap ~6e-4, bm25_err ~2e-7, rrf_err ~1e-9,
# ce_err ~1e-4) with room; the tiny cross-encoder's scores spread less than
# bfloat16 rounds them, so rerank_gap is not judged at this size
TINY_LIMITS = {"embed_err": {"limit": 1e-3}, "dense_err": {"limit": 2e-2},
               "dense_gap": {"limit": 2e-2}, "bm25_err": {"limit": 1e-4},
               "lex_gap": {"limit": 1e-4},
               "rrf_err": {"limit": 1e-6}, "missing": {"limit": 0.0}}
RERANK_LIMITS = {"ce_err": {"limit": 1e-2}, "rerank_gap": {"limit": 1e9}}


def tiny(cell: str, rerank: bool = False) -> dict:
    over = {"config": {"rows": 3000, "dim": 32, "dense_tile": 256,
                       "lexical": {"slots": 8, "vocab": 1024, "table_postings": 16},
                       "encoder": {"model": TINY_MODEL, "batch_size": 8, "max_len": 64}},
            "traffic": {"clients": 8, "max_batch": 4, "pool": 64, "check_sample": 8,
                        "candidates": 20},
            "limits": dict(TINY_LIMITS, **(RERANK_LIMITS if rerank else {}))}
    if cell.startswith("a10m"):  # budgets that cut the tiny corpus's postings
        over["config"]["hybrid_opts"] = {"postings_per_query_term": 8, "lex_deep_terms": 2,
                                         "lex_deep_postings": 16, "lex_gen": 30}
    if cell.startswith("b1m"):
        over["config"]["reranker"] = {"model": TINY_MODEL, "batch_size": 8, "max_len": 64}
        over["config"]["chunk_words"] = 12
    return over


@pytest.fixture
def small_chunks(monkeypatch):
    """Draw inputs in chunks of 1,024 rows, so the tiny corpora span
    several chunks as the full-size ones do."""
    from benchmark import data

    monkeypatch.setattr(data, "CHUNK", 1024)
