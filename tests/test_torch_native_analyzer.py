"""The port's native analyzer (tokenize/native.py over native/analyzer.cpp)
against the port's Python path and the JAX package's native path on the
same texts: term buckets, tfs and lengths equal, not close."""

import os
import re

import numpy as np
import pytest

from super_rag_tpu.tokenize import native as jnative
from super_rag_tpu.tokenize.analyzer import Analyzer as JAnalyzer
from super_rag_tpu_torch.tokenize import native
from super_rag_tpu_torch.tokenize.analyzer import Analyzer

TEXTS = [
    "The quick brown Fox jumps over the lazy dog!",
    "JAX compiles NumPy programs to XLA for TPUs & GPUs...",
    "fox fox fox FOX dog_dog under_score mixed123 numbers 42",
    "信息检索系统使用倒排索引。BM25 scores 文档 relevance.",
    "a an and are as at be by — stopwords only here",
    "",
    "single",
    "ひらがな カタカナ mixed with English words こんにちは",
    "한국어 텍스트 검색 test with Korean",
    "Ünïcödé wörds with àccents should not crash",
    "the the the of of and",  # stopwords alone
    " ".join(f"word{i % 37}" for i in range(300)),  # more terms than slots
] * 2


def _need_native():
    if not native.available():
        pytest.skip("g++ is not available here: the native analyzer cannot build")


def _equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("slots", [4, 16, 64])
@pytest.mark.parametrize("use_stopwords", [True, False])
def test_native_equals_python_and_the_jax_package(use_stopwords, slots):
    _need_native()
    vocab = 1 << 14
    analyzer = Analyzer(vocab_size=vocab, use_stopwords=use_stopwords)
    nat = native.batch_doc_entries(TEXTS, slots, vocab, use_stopwords)
    assert nat is not None
    _equal(nat, analyzer.batch_doc_entries(TEXTS, slots, prefer_native=False))
    ref = jnative.batch_doc_entries(TEXTS, slots, vocab, use_stopwords)
    if ref is None:
        ref = JAnalyzer(vocab_size=vocab, use_stopwords=use_stopwords
                        ).batch_doc_entries(TEXTS, slots, prefer_native=False)
    _equal(nat, ref)


@pytest.mark.parametrize("count", [7, 8, 24])
def test_batch_doc_entries_takes_native_from_eight_texts(count, monkeypatch):
    """As the reference: 8 or more texts take the native analyzer, fewer
    the Python loop; both give the same arrays."""
    _need_native()
    analyzer = Analyzer(vocab_size=1 << 12)
    calls = []
    real = native.batch_doc_entries

    def counting(*args):
        calls.append(len(args[0]))
        return real(*args)

    monkeypatch.setattr(native, "batch_doc_entries", counting)
    got = analyzer.batch_doc_entries(TEXTS[:count], 16)
    assert calls == ([count] if count >= 8 else [])
    _equal(got, analyzer.batch_doc_entries(TEXTS[:count], 16, prefer_native=False))


def test_without_a_compiler_the_python_loop_answers(monkeypatch):
    """Where the library cannot build, the analyzer keeps the Python
    path (the reference's contract for the library)."""
    monkeypatch.setattr(native, "load", lambda: None)
    assert native.batch_doc_entries(TEXTS, 8, 1 << 12) is None
    analyzer = Analyzer(vocab_size=1 << 12)
    _equal(analyzer.batch_doc_entries(TEXTS, 8),
           analyzer.batch_doc_entries(TEXTS, 8, prefer_native=False))


def test_native_refuses_a_vocabulary_that_is_not_a_power_of_two():
    _need_native()
    with pytest.raises(ValueError, match="analyze_docs"):
        native.batch_doc_entries(TEXTS, 8, 1000)


def test_library_name_carries_the_source_hash(tmp_path):
    """The library is _build/libanalyzer-<hash>.so, the hash over the
    source and the flags: an edited source builds anew."""
    from super_rag_tpu_torch import _build

    name = _build._gxx_target(native._SRC, "analyzer")
    assert os.path.dirname(name) == _build.BUILD
    assert re.fullmatch(r"libanalyzer-[0-9a-f]{16}\.so", os.path.basename(name))
    edited = tmp_path / "analyzer.cpp"
    edited.write_bytes(open(native._SRC, "rb").read() + b"// edited\n")
    assert _build._gxx_target(str(edited), "analyzer") != name
