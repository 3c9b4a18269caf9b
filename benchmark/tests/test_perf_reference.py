"""The plain reference against HuggingFace's BERT at small widths, its
frozen text rules against the program's tokenizers, and its retrieval
arithmetic on hand-worked cases."""

import math
import os

import numpy as np
import pytest
import torch
from conftest import TINY_MODEL

from benchmark import data
from benchmark.reference import bert, retrieval, text

# HuggingFace's BERT without its JAX and TensorFlow halves: a test process
# that loaded JAX would make the harness's own check refuse later runs
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_TF", "0")

TEXTS = ["t12 t7 the quick fox", "T99 t3 t3", "a", "t1 t2 t3 t4 t5 t6 t7 t8 t9 t10 t11 t12"]


def _hf_config(num_labels=None):
    transformers = pytest.importorskip("transformers")
    kw = dict(TINY_MODEL, hidden_act="gelu", attn_implementation="eager")
    if num_labels:
        kw["num_labels"] = num_labels
    return transformers, transformers.BertConfig(**kw)


def test_encoder_matches_huggingface_bert():
    transformers, cfg = _hf_config()
    sd = data.bert_state_dict(3, TINY_MODEL, "encoder", "cpu")
    hf = transformers.BertModel(cfg, add_pooling_layer=False).eval()
    missing, unexpected = hf.load_state_dict(sd, strict=False)
    assert not unexpected and all("position_ids" in k for k in missing)
    rows = [text.encode(t, TINY_MODEL["vocab_size"], 64) for t in TEXTS]
    got = bert.embed(sd, TINY_MODEL, rows, "cpu")
    for row, g in zip(rows, got):
        with torch.no_grad():
            h = hf(torch.tensor([row])).last_hidden_state[0].mean(0)
        assert torch.allclose(g, h / h.norm(), atol=2e-6)
    low = bert.embed(sd, TINY_MODEL, rows, "cpu", precision="float8")
    assert not torch.allclose(low, got, atol=1e-6)


def test_cross_encoder_matches_huggingface_bert():
    transformers, cfg = _hf_config(num_labels=1)
    sd = data.bert_state_dict(3, TINY_MODEL, "reranker", "cpu")
    hf = transformers.BertForSequenceClassification(cfg).eval()
    missing, unexpected = hf.load_state_dict(sd, strict=False)
    assert not unexpected and all("position_ids" in k for k in missing)
    pairs = [text.encode_pair(TEXTS[0], t, TINY_MODEL["vocab_size"], 64) for t in TEXTS]
    got = bert.cross_scores(sd, TINY_MODEL, pairs, "cpu")
    for (ids, types), g in zip(pairs, got):
        with torch.no_grad():
            want = hf(torch.tensor([ids]), token_type_ids=torch.tensor([types])).logits[0, 0]
        assert abs(float(g) - float(want)) < 2e-6


def test_text_rules_are_the_programs():
    from super_rag_tpu_torch.models.tokenization import HashTokenizer
    from super_rag_tpu_torch.tokenize.analyzer import Analyzer, DocFrequency

    tok = HashTokenizer(vocab_size=1000)
    for t in TEXTS:
        ids, mask = tok.encode_batch([t], max_len=64)
        assert ids[0][mask[0]].tolist() == text.encode(t, 1000, 64)
        assert text.text_length(t, 64) == int(mask[0].sum())
        ids, mask, tt = tok.encode_pairs([TEXTS[3]], [t], max_len=16)
        want_ids, want_tt = text.encode_pair(TEXTS[3], t, 1000, 16)
        assert ids[0][mask[0]].tolist() == want_ids and tt[0][mask[0]].tolist() == want_tt
        assert text.pair_length(TEXTS[3], t, 16) == int(mask[0].sum())
    an = Analyzer(vocab_size=1 << 17)
    for t in TEXTS:
        assert an.term_ids(t) == text.analyzer_terms(t, 1 << 17)
        terms, _ = an.query_entry(t, DocFrequency(), 16)
        assert terms[terms < (1 << 17)].tolist() == text.query_terms(t, 1 << 17)


def test_bm25_by_hand():
    terms = torch.tensor([[5, 7, 5, 9]])
    tfs = torch.tensor([[2.0, 1.0, 1.0, 0.0]])
    dl, avgdl = torch.tensor([10.0]), 8.0
    norm = 1.2 * (1 - 0.75 + 0.75 * 10 / 8)

    def sat(tf):
        return tf * 2.2 / (tf + norm)

    idf = torch.zeros(11, dtype=torch.float64)
    idf[5], idf[9] = 1.5, 0.5
    got = float(retrieval.bm25_rows(idf, terms, retrieval.saturation(tfs, dl, avgdl))[0])
    assert got == pytest.approx(1.5 * (sat(2) + sat(1)))
    assert retrieval.idf(np.array([0, 10]), 10).tolist() == pytest.approx(
        [math.log(1 + 10.5 / 0.5), math.log(1 + 0.5 / 10.5)])


def test_rrf_and_rerank_fusion_by_hand():
    fused = retrieval.rrf([3, 1, -1], [1, 4])
    assert fused == pytest.approx({3: 1 / 61, 1: 1 / 62 + 1 / 61, 4: 1 / 62})
    z = retrieval.rerank_fuse(np.array([1.0, 2.0, 3.0]), np.array([0.0, 0.0, 0.0]))
    assert z.tolist() == pytest.approx([-1.2247449, 0.0, 1.2247449])
    assert retrieval.widest_gap([3.0, 2.0], [2.5, 2.0]) == pytest.approx(0.5)
    assert retrieval.widest_gap([3.0, 2.0], [2.0]) == math.inf


def test_stored_rows_are_the_programs_int8():
    from super_rag_tpu_torch.ops.quant import quantize_int8

    x = retrieval.unit_rows(torch.randn(64, 48, generator=torch.Generator().manual_seed(1)))
    q, s = quantize_int8(x)
    assert torch.equal(retrieval.stored_rows(x, "int8"), q.float() * s[:, None])
    four = retrieval.stored_rows(x, "int4")
    assert (four / (x.abs().amax(-1, keepdim=True) / 7)).round().abs().max() <= 7
    assert torch.equal(retrieval.stored_rows(x, "bfloat16"), x.to(torch.bfloat16).float())


def test_lexical_generation_by_hand():
    """Postings in impact order (the lower row first among equals) across
    chunks, cut at each term's depth; totals of stored impacts times idf."""
    from benchmark.reference import lexical

    terms = torch.tensor([[3, 4], [3, 9], [4, 3], [3, 9]])
    imp = torch.tensor([[0.5, 1.0], [0.75, 2.0], [1.0, 0.5], [0.75, 2.0]])
    post = lexical.Postings({3: 3, 4: 1}, "cpu")
    post.add(terms[:2], imp[:2], 0)
    post.add(terms[2:], imp[2:], 2)
    got = post.finish()
    assert got[3][0].tolist() == [1, 3, 0] and got[3][1].tolist() == [0.75, 0.75, 0.5]
    assert got[4][0].tolist() == [0] and got[4][1].tolist() == [1.0]
    rows = lexical.generate(got, [3, 4], np.array([2.0, 1.0], np.float32), [2, 1], k=5)
    assert rows.tolist() == [1, 3, 0]  # 1.5, 1.5, 1.0
    assert lexical.depths([3, 4, 5], np.array([2.0, 1.0, 1.0], np.float32),
                          {"postings_per_query_term": 8, "lex_deep_terms": 1,
                           "lex_deep_postings": 32}, table_postings=16) == [8, 16, 8]
