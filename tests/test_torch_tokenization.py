"""The port's tokenizers (models/tokenization.py, models/subword.py and the
native BPE of tokenize/native_bpe.py) against the JAX package's on the
same texts: ids, masks and type ids must be equal, not close."""

import pickle

import numpy as np
import pytest

from super_rag_tpu.models import subword as jsub
from super_rag_tpu.models import tokenization as jtok
from super_rag_tpu_torch.models import subword as tsub
from super_rag_tpu_torch.models import tokenization as ttok
from super_rag_tpu_torch.tokenize import native_bpe

CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "tokenization replays byte pair merges in rank order",
    "retrieval engines embed chunks and queries into one space",
    "知识图谱 constructs entities and 关系 from text",
    "under_scored words and numbers 12345 mix freely",
] * 20

TEXTS = [
    "the quick brown fox",
    "Tokenization Replays MERGES",
    "edge-cases: punct!  multi  spaces\tand\nnewlines",
    "知识图谱是关系的集合",
    "mixed 知识 ascii 图谱 tails",
    "",
    "____",
    "unknown zzzzqqqq sequences survive as unk or splits",
    "ünïcode außerhalb ascii wörter",
    " ".join(["retrieval engines embed chunks"] * 60),  # past 128 tokens
]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def bpe_pair():
    return jsub.train_bpe(CORPUS, vocab_size=400), tsub.train_bpe(CORPUS, vocab_size=400)


@pytest.mark.parametrize("max_len", [16, 128, 512])
def test_hash_tokenizer_matches(max_len):
    j, t = jtok.HashTokenizer(vocab_size=1000), ttok.HashTokenizer(vocab_size=1000)
    _same(t.encode_batch(TEXTS, max_len=max_len), j.encode_batch(TEXTS, max_len=max_len))
    queries = TEXTS[::-1]
    _same(t.encode_pairs(queries, TEXTS, max_len=max_len),
          j.encode_pairs(queries, TEXTS, max_len=max_len))
    assert t.encode_batch([], max_len=max_len)[0].shape == (0, 8)


def test_train_bpe_gives_the_same_vocabulary(bpe_pair):
    j, t = bpe_pair
    assert t.tokens == j.tokens
    assert t.merges == j.merges
    assert t.vocab_size == j.vocab_size


@pytest.mark.parametrize("max_len", [16, 128, 512])
def test_bpe_tokenizer_matches(bpe_pair, max_len):
    j, t = bpe_pair
    _same(t.encode_batch(TEXTS, max_len=max_len), j.encode_batch(TEXTS, max_len=max_len))
    _same(t.encode_pairs(TEXTS[::-1], TEXTS, max_len=max_len),
          j.encode_pairs(TEXTS[::-1], TEXTS, max_len=max_len))


def test_bpe_save_load_across_packages(bpe_pair, tmp_path):
    j, t = bpe_pair
    t.save(str(tmp_path / "t.json"))
    j.save(str(tmp_path / "j.json"))
    back_j = jsub.BPETokenizer.load(str(tmp_path / "t.json"))
    back_t = tsub.BPETokenizer.load(str(tmp_path / "j.json"))
    _same(back_t.encode_batch(TEXTS, max_len=64), back_j.encode_batch(TEXTS, max_len=64))


def test_native_bpe_equals_the_python_path(bpe_pair):
    _, t = bpe_pair
    native = native_bpe.NativeBPE.create(t.tokens, t.merges)
    if native is None:
        pytest.skip("no g++ to build the native BPE encoder")
    assert native_bpe.load() is native_bpe.load()
    py = tsub.BPETokenizer(t.tokens, t.merges)
    py._native = False  # never build: the Python merge replay
    rng = np.random.default_rng(0)
    alphabet = list("abcdefghij _-.,!349ABC知识图")
    randoms = ["".join(rng.choice(alphabet, size=rng.integers(0, 60)).tolist())
               for _ in range(200)]
    for text in TEXTS + randoms:
        assert native.encode(text).tolist() == py._text_ids(text), text
    assert t._native_encoder() is not None  # the tokenizer takes the native path
    _same(t.encode_batch(TEXTS, max_len=64), py.encode_batch(TEXTS, max_len=64))


def test_without_the_native_library_ids_are_unchanged(bpe_pair, monkeypatch):
    _, t = bpe_pair
    monkeypatch.setenv("SUPER_RAG_NO_NATIVE_BPE", "1")
    fresh = tsub.BPETokenizer(t.tokens, t.merges)
    assert fresh._native_encoder() is None
    monkeypatch.delenv("SUPER_RAG_NO_NATIVE_BPE")
    _same(fresh.encode_batch(TEXTS, max_len=64), t.encode_batch(TEXTS, max_len=64))


def test_pickle_drops_the_native_handle(bpe_pair):
    _, t = bpe_pair
    t._native_encoder()
    back = pickle.loads(pickle.dumps(t))
    assert back._native is None
    _same(back.encode_batch(TEXTS, max_len=32), t.encode_batch(TEXTS, max_len=32))


def test_pairs_of_unequal_length_are_refused(bpe_pair):
    for tok in (bpe_pair[1], ttok.HashTokenizer()):
        with pytest.raises(ValueError, match="differ"):
            tok.encode_pairs(["a", "b"], ["c"])
