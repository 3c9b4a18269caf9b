"""The PyTorch port's TextEncoder / CrossEncoder against the JAX package's
flax modules on the same parameters and token ids: a tiny random model,
the in-repo trained checkpoints through both packages' services, and
HF BERT weights through both packages' loaders."""

import dataclasses
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from super_rag_tpu.models import cross_encoder as jce
from super_rag_tpu.models import encoder as jenc
from super_rag_tpu.models import encoder_service as jsvc
from super_rag_tpu.models import hf_loader as jhf
from super_rag_tpu.models import subword as jsub
from super_rag_tpu.service import rerank_service as jrr
from super_rag_tpu_torch import convert
from super_rag_tpu_torch.models import cross_encoder as tce
from super_rag_tpu_torch.models import encoder as tenc
from super_rag_tpu_torch.models import encoder_service as tsvc
from super_rag_tpu_torch.models import hf_loader as thf
from super_rag_tpu_torch.service import rerank_service as trr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "checkpoints", "encoder_semantic")
RERANKER = CKPT + "_reranker"
JDTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

# f32: the two packages take the same f32 operations, sums in other orders
F32_ATOL = 2e-5
# bf16: both round every product and activation to bf16, in places that
# differ (XLA fuses elementwise chains and may keep them in f32)
BF16_MIN_COS = 0.9995
BF16_SCORE_TOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two threads for this file's CPU forwards: the suite runs files in
    parallel workers that share the CPU, and some tests elsewhere time
    their own work."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def tiny_cfg(dtype: str, embed_dim=None):
    kw = dict(vocab_size=97, hidden_dim=64, num_layers=2, num_heads=4,
              mlp_dim=128, max_len=128, type_vocab_size=2, embed_dim=embed_dim)
    return (jenc.EncoderConfig(**kw, dtype=JDTYPES[dtype]),
            tenc.EncoderConfig(**kw, dtype=getattr(torch, dtype)))


def to_numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def port_cfg(jcfg: jenc.EncoderConfig, dtype: str) -> tenc.EncoderConfig:
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    return tenc.EncoderConfig(**{**kw, "dtype": getattr(torch, dtype)})


def token_batch(seed: int, b: int = 6, s: int = 64, vocab: int = 97):
    """ids, a mask of ragged lengths (one row holds [CLS] only) and type
    ids that switch to 1 half-way through each row."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, vocab, (b, s)).astype(np.int32)
    lens = np.array([s, s - 7, 33, 9, 1, 20][:b])
    mask = np.arange(s)[None] < lens[:, None]
    ids[~mask] = 0
    tt = (np.arange(s)[None] >= (lens // 2)[:, None]).astype(np.int32) * mask
    return ids, mask, tt


def min_cos(a, b):
    return float((a * b).sum(-1).min())


def assert_scores_close(got, want, tol):
    np.testing.assert_array_less(np.abs(got - want), tol * (1.0 + np.abs(want)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("embed_dim", [None, 48])
def test_text_encoder_matches_flax(dtype, embed_dim):
    jcfg, tcfg = tiny_cfg(dtype, embed_dim)
    params = to_numpy(jenc.TextEncoder(jcfg).init_params(jax.random.PRNGKey(1)))
    ids, mask, _ = token_batch(3)
    want = np.asarray(jenc.TextEncoder(jcfg).apply({"params": params}, ids, mask))
    model = convert.encoder_from_jax(params, tcfg, device="cpu")
    with torch.inference_mode():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (6, embed_dim or 64)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    else:
        assert min_cos(got, want) >= BF16_MIN_COS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_encoder_matches_flax(dtype):
    jcfg, tcfg = tiny_cfg(dtype)
    params = to_numpy(jce.CrossEncoder(jcfg).init_params(jax.random.PRNGKey(2)))
    ids, mask, tt = token_batch(4)
    want = np.asarray(jce.rerank_scores(jce.CrossEncoder(jcfg), params, ids, mask, tt))
    model = convert.cross_encoder_from_jax(params, tcfg, device="cpu")
    got = tce.rerank_scores(model, *map(torch.from_numpy, (ids, mask, tt))).numpy()
    assert got.shape == want.shape == (6,) and got.dtype == np.float32
    assert_scores_close(got, want, F32_ATOL if dtype == "float32" else BF16_SCORE_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padding_does_not_change_a_row(dtype):
    """A row padded to the next bucket, with garbage ids under its mask,
    embeds and scores as at its own bucket, in both packages."""
    jcfg, tcfg = tiny_cfg(dtype)
    enc = to_numpy(jenc.TextEncoder(jcfg).init_params(jax.random.PRNGKey(5)))
    ce = to_numpy(jce.CrossEncoder(jcfg).init_params(jax.random.PRNGKey(6)))
    ids, mask, tt = token_batch(7)
    wide = [np.pad(a, ((0, 0), (0, 64))) for a in (ids, mask, tt)]
    wide[0][:, 64:] = np.random.default_rng(8).integers(4, 97, (6, 64))
    tenc_m = convert.encoder_from_jax(enc, tcfg, device="cpu")
    tce_m = convert.cross_encoder_from_jax(ce, tcfg, device="cpu")
    tol = 1e-6 if dtype == "float32" else 1e-2
    with torch.inference_mode():
        narrow = tenc_m(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
        padded = tenc_m(torch.from_numpy(wide[0]), torch.from_numpy(wide[1])).numpy()
    np.testing.assert_allclose(padded, narrow, atol=tol, rtol=0)
    s_narrow = tce.rerank_scores(tce_m, *map(torch.from_numpy, (ids, mask, tt))).numpy()
    s_padded = tce.rerank_scores(tce_m, *map(torch.from_numpy, wide)).numpy()
    assert_scores_close(s_padded, s_narrow, tol)
    j_padded = np.asarray(jenc.TextEncoder(jcfg).apply({"params": enc}, *wide[:2]))
    if dtype == "float32":
        np.testing.assert_allclose(padded, j_padded, atol=F32_ATOL, rtol=0)
    else:
        assert min_cos(padded, j_padded) >= BF16_MIN_COS


def test_load_rejects_missing_extra_and_misshapen_keys():
    jcfg, tcfg = tiny_cfg("float32")
    params = to_numpy(jenc.TextEncoder(jcfg).init_params(jax.random.PRNGKey(1)))
    flat = tenc.flatten_tree(params)
    model = convert.encoder_from_jax(flat, tcfg, device="cpu")  # flat keys work
    back = tenc.flatten_tree(tenc.flax_params(model))
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    missing = {k: v for k, v in flat.items() if "layer_1/mlp_in/bias" not in k}
    with pytest.raises(ValueError, match="missing"):
        convert.encoder_from_jax(missing, tcfg, device="cpu")
    with pytest.raises(ValueError, match="no place"):
        convert.encoder_from_jax({**flat, "pooler/kernel": np.zeros((64, 64))},
                                 tcfg, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        convert.encoder_from_jax({**flat, "backbone/layer_0/mlp_in/bias":
                                  np.zeros(3)}, tcfg, device="cpu")


def test_sequence_past_the_position_table_is_refused():
    """Kept difference: the port raises where flax's gather would fill or
    clamp the position embedding; the services clip max_len to the table."""
    _, tcfg = tiny_cfg("float32")
    model = tenc.init_params(tenc.TextEncoder(tcfg), torch.Generator().manual_seed(0))
    ids = torch.ones((1, tcfg.max_len + 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="position table"):
        model(ids, torch.ones_like(ids, dtype=torch.bool))
    svc = tsvc.EncoderService(cfg=tcfg, max_len=512, device="cpu")
    assert svc.max_len == tcfg.max_len
    assert svc.embed([" ".join(["w"] * 400)]).shape == (1, 64)


# -- the in-repo trained checkpoints through both packages' services ---------

def _texts():
    """~32 texts: the checkpoint's own vocabulary, CJK, one past 128
    tokens, an empty one."""
    with open(CKPT + ".tokenizer.json") as f:
        words = [t.replace("</w>", "") for t in json.load(f)["tokens"][200:2200]]
    rng = np.random.default_rng(11)
    texts = [" ".join(rng.choice(words, rng.integers(1, 40))) for _ in range(28)]
    texts += ["检索增强生成 retrieval augmented generation 把文档切块",
              " ".join(rng.choice(words, 300)), "",
              "What is the capital of France?"]
    return texts


def _load(path):
    """Both packages' parameters, configs and BPE tokenizers of one
    checkpoint."""
    params, cfg = jsvc.load_params(path)
    tparams, tcfg = tsvc.load_params(path)
    return SimpleNamespace(params=params, cfg=cfg, tparams=tparams, tcfg=tcfg,
                           jtok=jsub.BPETokenizer.load(path + ".tokenizer.json"),
                           ttok=tsvc.tokenizer_sidecar(path))


@pytest.fixture(scope="module")
def encoder_ckpt():
    return _load(CKPT)


@pytest.fixture(scope="module")
def reranker_ckpt():
    return _load(RERANKER)


def test_checkpoint_config_and_tokenizer_match(encoder_ckpt):
    c = encoder_ckpt
    assert c.tcfg == port_cfg(c.cfg, "bfloat16")
    flat_j, flat_t = tenc.flatten_tree(c.params), tenc.flatten_tree(c.tparams)
    assert set(flat_j) == set(flat_t)
    texts = _texts()
    for max_len in (128, 512):
        jids, jmask = c.jtok.encode_batch(texts, max_len=max_len)
        tids, tmask = c.ttok.encode_batch(texts, max_len=max_len)
        np.testing.assert_array_equal(tids, jids)
        np.testing.assert_array_equal(tmask, jmask)
    assert jids.shape[1] == 512 and tids[-2].tolist()[:3] == [1, 2, 0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_embeddings_match(encoder_ckpt, dtype):
    """f32 override within 1e-5; bf16 as configured by cosine."""
    c = encoder_ckpt
    texts = _texts()
    jsv = jsvc.EncoderService(cfg=dataclasses.replace(c.cfg, dtype=JDTYPES[dtype]),
                              params=c.params, tokenizer=c.jtok, batch_size=32,
                              max_len=128)
    tsv = tsvc.EncoderService(cfg=port_cfg(c.cfg, dtype), params=c.tparams,
                              tokenizer=c.ttok, batch_size=32, max_len=128,
                              device="cpu")
    want, got = jsv.embed(texts), tsv.embed(texts)
    assert got.shape == want.shape == (len(texts), 256)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        assert min_cos(got, want) >= BF16_MIN_COS
    dev = tsv.embed_device(texts[:5])
    assert dev.device.type == "cpu" and torch.equal(dev, torch.from_numpy(got[:5]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reranker_checkpoint_matches(reranker_ckpt, dtype):
    """One query x 40 texts through both packages' RerankService:
    scores within the bounds, top-5 equal up to near-ties."""
    c = reranker_ckpt
    texts = (_texts() * 2)[:40]
    query = texts[3]
    jr = jrr.RerankService(config=dataclasses.replace(c.cfg, dtype=JDTYPES[dtype]),
                           params=c.params, tokenizer=c.jtok, max_len=128)
    tr = trr.RerankService(config=port_cfg(c.cfg, dtype), params=c.tparams,
                           tokenizer=c.ttok, max_len=128, device="cpu")
    want, got = jr(query, texts), tr(query, texts)
    assert got.shape == want.shape == (40,)
    tol = 1e-5 if dtype == "float32" else BF16_SCORE_TOL
    assert_scores_close(got, want, tol)
    top_w, top_g = np.argsort(-want, kind="stable")[:5], np.argsort(-got, kind="stable")[:5]
    for a, b in zip(top_w, top_g):
        assert a == b or abs(want[a] - want[b]) <= 2 * tol * (1 + abs(want[a]))


# -- HF BERT weights ---------------------------------------------------------

def _bert_config():
    from transformers import BertConfig

    return BertConfig(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=64,
                      max_position_embeddings=64, type_vocab_size=2,
                      num_labels=1)


def test_hf_loader_matches_bert_and_the_jax_loader():
    from transformers import BertForSequenceClassification, BertModel

    hf_cfg = _bert_config()
    torch.manual_seed(0)
    bert = BertModel(hf_cfg).eval()
    cfg = dataclasses.replace(thf.config_from_hf(hf_cfg), dtype=torch.float32)
    assert cfg == port_cfg(jhf.config_from_hf(hf_cfg), "float32")
    params = thf.encoder_params_from_bert(bert.state_dict(), cfg)
    jparams = jhf.encoder_params_from_bert(
        bert.state_dict(), dataclasses.replace(jhf.config_from_hf(hf_cfg),
                                               dtype=jnp.float32))
    flat, jflat = tenc.flatten_tree(params), tenc.flatten_tree(jparams)
    assert set(flat) == set(jflat)
    for k in flat:
        np.testing.assert_array_equal(flat[k], jflat[k])

    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, (2, 10))
    mask = np.ones((2, 10), np.int64)
    mask[1, 7:] = 0
    with torch.no_grad():
        hidden = bert(input_ids=torch.tensor(ids),
                      attention_mask=torch.tensor(mask)).last_hidden_state.numpy()
    m = mask[..., None].astype(np.float32)
    gold = (hidden * m).sum(1) / m.sum(1)
    gold /= np.linalg.norm(gold, axis=-1, keepdims=True)
    model = convert.encoder_from_jax(params, cfg, device="cpu")
    with torch.inference_mode():
        got = model(torch.tensor(ids), torch.tensor(mask.astype(bool))).numpy()
    np.testing.assert_allclose(got, gold, atol=2e-5, rtol=0)

    torch.manual_seed(1)
    clf = BertForSequenceClassification(hf_cfg).eval()
    ce = convert.cross_encoder_from_jax(
        thf.cross_encoder_params_from_bert(clf.state_dict(), cfg), cfg, device="cpu")
    tt = (np.arange(10)[None] >= 4).astype(np.int64).repeat(2, 0)
    with torch.no_grad():
        logits = clf(input_ids=torch.tensor(ids), attention_mask=torch.tensor(mask),
                     token_type_ids=torch.tensor(tt)).logits[:, 0].numpy()
    scores = tce.rerank_scores(ce, torch.tensor(ids), torch.tensor(mask),
                               torch.tensor(tt)).numpy()
    np.testing.assert_allclose(scores, logits, atol=2e-5, rtol=0)


def test_services_from_hf_checkpoint(tmp_path):
    """Both packages' services load one local HF checkpoint directory
    (weights + tokenizer) and agree at the configured bf16."""
    from transformers import BertForSequenceClassification, BertModel, BertTokenizerFast

    hf_cfg = _bert_config()
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"w{i}" for i in range(123)]
    (tmp_path / "vocab.txt").write_text("\n".join(vocab))
    tok = BertTokenizerFast(vocab_file=str(tmp_path / "vocab.txt"))
    for name, cls in (("enc", BertModel), ("ce", BertForSequenceClassification)):
        torch.manual_seed(0)
        cls(hf_cfg).eval().save_pretrained(tmp_path / name, safe_serialization=False)
        tok.save_pretrained(tmp_path / name)
    texts = ["w1 w2 w3", "w5 w7", "w100 w3 w9 w11 w12", "w0"]
    enc = str(tmp_path / "enc")
    jsv = jsvc.EncoderService.from_hf_checkpoint(enc, batch_size=4)
    tsv = tsvc.EncoderService.from_hf_checkpoint(enc, batch_size=4, device="cpu")
    assert tsv.max_len == jsv.max_len == 64 and tsv.cfg.dtype == torch.bfloat16
    assert min_cos(tsv.embed(texts), jsv.embed(texts)) >= BF16_MIN_COS
    ce = str(tmp_path / "ce")
    jr = jrr.RerankService.from_hf_checkpoint(ce, batch_size=4)
    tr = trr.RerankService.from_hf_checkpoint(ce, batch_size=4, device="cpu")
    assert_scores_close(tr("w1 w2", texts), jr("w1 w2", texts), BF16_SCORE_TOL)


@pytest.mark.parametrize("name", ["encoder_semantic", "encoder_semantic_reranker"])
def test_smoke_semantic_config_is_the_checkpoints(name):
    with open(os.path.join(ROOT, "checkpoints", name + ".json")) as f:
        assert json.load(f) == chip_smoke.SEMANTIC_CONFIG
    assert tsvc.load_config(os.path.join(ROOT, "checkpoints", name)) == \
        chip_smoke.semantic_config(torch.bfloat16)
