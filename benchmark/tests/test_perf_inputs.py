"""The inputs repeat exactly for one seed and differ for two."""

import json
import os

import numpy as np
import pytest
import torch
from conftest import ROOT, TINY_MODEL, spec_path, tiny

from benchmark import data, harness, registry, system

CELL = registry.find_cell("b1m.rerank32", spec_path=spec_path())
CFG = harness._merge(CELL.config, tiny("b1m.rerank32", rerank=True)["config"])
TRAFFIC = harness._merge(CELL.traffic, tiny("b1m.rerank32")["traffic"])
SEEDS = (5, 2**31 + 7)


def _inputs(seed):
    out = []
    for c, lo, hi in data.chunks(CFG["rows"]):
        ranks, tfs, dl = data.lexical_chunk(seed, CFG, c, lo, hi, "cpu")
        out.append((data.rows_chunk(seed, CFG, c, lo, hi, "cpu"), ranks, tfs, dl))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_rows_and_terms_repeat_for_one_seed(seed, small_chunks):
    a, b = _inputs(seed), _inputs(seed)
    assert len(a) == 3
    for x, y in zip(a, b):
        for s, t in zip(x, y):
            assert torch.equal(s, t)


def test_rows_and_terms_differ_for_two_seeds(small_chunks):
    a, b = _inputs(SEEDS[0]), _inputs(SEEDS[1])
    for x, y in zip(a, b):
        for s, t in zip(x, y):
            assert not torch.equal(s, t)


@pytest.mark.parametrize("kind", ["encoder", "reranker"])
def test_weights_repeat_for_one_seed_and_differ_for_two(kind):
    a = data.bert_state_dict(SEEDS[0], TINY_MODEL, kind, "cpu")
    b = data.bert_state_dict(SEEDS[0], TINY_MODEL, kind, "cpu")
    c = data.bert_state_dict(SEEDS[1], TINY_MODEL, kind, "cpu")
    assert a.keys() == b.keys() == c.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not any(torch.equal(a[k], c[k]) for k in a)


def test_query_pool_repeats_and_keeps_its_lengths(small_chunks):
    a = data.query_pool(CFG, TRAFFIC, SEEDS[0], "cpu")
    assert a == data.query_pool(CFG, TRAFFIC, SEEDS[0], "cpu")
    b = data.query_pool(CFG, TRAFFIC, SEEDS[1], "cpu")
    assert a != b
    la = data.query_lengths(1000, 2, 16, 1.0, SEEDS[0])
    lb = data.query_lengths(1000, 2, 16, 1.0, SEEDS[1])
    assert la != lb and sorted(la) == sorted(lb)
    assert min(la) == 2 and max(la) == 16 and 5.5 < np.mean(la) < 7.0


def test_the_systems_pool_is_the_inputs_pool(small_chunks):
    sut = system.build(CFG, TRAFFIC, SEEDS[0], "cpu", log=lambda m: None)
    assert sut.queries == data.query_pool(CFG, TRAFFIC, SEEDS[0], "cpu")
    texts = [sut.engine.index.row_meta[r]["text"] for r in (0, 1500, 2999)]
    assert all(len(t.split()) == CFG["chunk_words"] for t in texts)


def test_configs_state_the_published_widths():
    for name in ("msmarco-10m-int8-minilm", "collection-1m-bf16-minilm-ce"):
        cfg = json.load(open(os.path.join(ROOT, "benchmark", "configs", name + ".json")))
        for m in [cfg["encoder"]["model"]] + ([cfg["reranker"]["model"]] if cfg["reranker"] else []):
            assert (m["hidden_size"], m["num_hidden_layers"], m["num_attention_heads"],
                    m["intermediate_size"], m["vocab_size"], m["max_position_embeddings"]) == \
                (384, 6, 12, 1536, 30522, 512)
        assert cfg["dim"] == 384
