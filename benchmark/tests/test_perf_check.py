"""The output check at a size a test can hold, on the CPU: a sound run is
correct, and a run with its timed path broken underneath, or the control
in the program's place, is not."""

import os
import sys
import time

import pytest
import torch
from conftest import TINY_LIMITS, spec_path, tiny

from benchmark import harness

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

CELLS = ["a10m.batch512", "b1m.rerank32"]


def _run(cell, seed=11):
    rerank = cell == "b1m.rerank32"
    return harness.run(cell, seed, 3.0 if rerank else 1.0, False, time.perf_counter(),
                       device="cpu", spec_path=spec_path(), overrides=tiny(cell, rerank),
                       log=lambda m: None)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell, small_chunks):
    result, lines = _run(cell)
    assert result["correct"], lines
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "check" and lines[-1].startswith("check failed_requests")


def _shift_first_row(fn, n_rows=3000):
    def broken(*a, **k):
        v, i = fn(*a, **k)
        i = i.clone()
        i[:, 0] = (i[:, 0] + 1) % n_rows
        return v, i
    return broken


def _shift_every_row(fn, n_rows=3000):
    def broken(*a, **k):
        v, i = fn(*a, **k)
        return v, torch.where(i >= 0, (i + 1) % n_rows, i)
    return broken


def _skip_best(fn):
    def broken(*a, k, **kw):
        v, i = fn(*a, k=k + 1, **kw)
        return v[:, 1:], i[:, 1:]
    return broken


def _faults():
    import super_rag_tpu_torch.ops.hybrid as hy
    from super_rag_tpu_torch.engine.batcher import QueryBatcher
    from super_rag_tpu_torch.engine.collection import CollectionEngine, SearchHit
    from super_rag_tpu_torch.models.encoder_service import EncoderService
    from super_rag_tpu_torch.service.rerank_service import RerankService

    embed, hits, rerank = EncoderService.embed_device, CollectionEngine._hits, RerankService.__call__

    def bent_embedding(self, texts):
        e = embed(self, texts)
        e = e + 0.05 * torch.roll(e, 1, dims=1)
        return e / e.norm(dim=1, keepdim=True)

    def altered_answer(self, scores, rows, recall_type, min_score=None):
        out = hits(self, scores, rows, recall_type, min_score)
        if out:
            h = out[0]
            out[0] = SearchHit((h.row + 1) % self.index.size, h.score, h.text, h.metadata,
                               h.recall_type)
        return out

    def rescaled_bm25(*a, **k):
        v, i = lex(*a, **k)
        return v * 1.01, i

    search_batch, search = CollectionEngine.search_batch, QueryBatcher.search
    last: dict = {}

    async def crossed_answers(self, engine, query, **params):
        answer = await search(self, engine, query, **params)
        out, last["answer"] = last.get("answer", answer), answer
        return out

    def half_the_batch(self, queries, **params):
        half = max(1, len(queries) // 2)
        out = search_batch(self, queries[:half], **params)
        return out + out[:len(queries) - half]

    def shifted_fusion(*a, **k):
        out = rrf(*a, **k)
        return out._replace(scores=out.scores + 1e-3)

    def empty_lexical_list(*a, **k):
        v, i = lex(*a, **k)
        return torch.full_like(v, float("-inf")), torch.full_like(i, -1)

    lex, rrf = hy._rescored_lexical_branch, hy._rrf_on_device
    return {
        "embed_err": (EncoderService, "embed_device", bent_embedding, "a10m.batch512"),
        "dense_err": (hy, "dense_search", _shift_first_row(hy.dense_search), "a10m.batch512"),
        "dense_gap": (hy, "dense_search", _skip_best(hy.dense_search), "a10m.batch512"),
        "bm25_err": (hy, "_rescored_lexical_branch", rescaled_bm25, "a10m.batch512"),
        "lex_gap": (hy, "inverted_bm25_search", _shift_every_row(hy.inverted_bm25_search),
                    "a10m.batch512"),
        "empty lexical list": (hy, "_rescored_lexical_branch", empty_lexical_list,
                               "b1m.rerank32"),
        "rrf_err": (hy, "_rrf_on_device", shifted_fusion, "a10m.batch512"),
        "altered answer": (CollectionEngine, "_hits", altered_answer, "a10m.batch512"),
        "missing": (QueryBatcher, "search", crossed_answers, "a10m.batch512"),
        "half the batch": (CollectionEngine, "search_batch", half_the_batch, "a10m.batch512"),
        "ce_err": (RerankService, "__call__",
                   lambda self, q, t: rerank(self, q, t) + 0.1, "b1m.rerank32"),
    }


NUMBER = {"half the batch": "missing", "empty lexical list": "lex_gap",
          "altered answer": "rrf_err"}


@pytest.mark.parametrize("fault", ["embed_err", "dense_err", "dense_gap", "bm25_err", "lex_gap",
                                   "empty lexical list", "rrf_err", "ce_err", "altered answer",
                                   "missing", "half the batch"])
def test_a_fault_where_the_answer_is_made_is_not_correct(fault, monkeypatch, small_chunks):
    """Each fault a serving cell can have (an answer, or a stage's output on
    its way to it, altered where it is made; a stage's selection wrong;
    half of each batch answered with the other half's answers; answers
    handed to the wrong clients) fails the number that watches it."""
    obj, attr, broken, cell = _faults()[fault]
    monkeypatch.setattr(obj, attr, broken)
    result, lines = _run(cell)
    number = NUMBER.get(fault, fault)
    assert not result["correct"]
    assert result["check"][number]["value"] > result["check"][number]["limit"], lines


@pytest.mark.parametrize("cell", ["a10m.batch512", "b1m.rerank32"])
def test_the_control_is_not_correct(cell, small_chunks):
    import control

    ok, numbers, lines = control.control_run(cell, 11, "cpu", tiny(cell, cell == "b1m.rerank32"),
                                             spec_path=spec_path())
    assert not ok, lines
    assert [k for k, v in numbers.items() if k in TINY_LIMITS and v > TINY_LIMITS[k]["limit"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card_is_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, lines = harness.run(cell, 21, 5.0, False, time.perf_counter(), spec_path=spec_path(),
                                log=lambda m: None)
    assert result["correct"], lines
