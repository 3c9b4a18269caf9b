"""The port's EncoderService / RerankService / ImageEmbedder against the
JAX package's, and the slice end to end: query texts -> EncoderService ->
CollectionEngine.search_batch(hybrid, rerank) -> RerankService, with the
in-repo encoder_semantic checkpoints behind both packages' engines."""

import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from super_rag_tpu.engine import index as jindex
from super_rag_tpu.engine.collection import CollectionEngine as JEngine
from super_rag_tpu.models import cross_encoder as jce
from super_rag_tpu.models import encoder as jenc
from super_rag_tpu.models import encoder_service as jsvc
from super_rag_tpu.models.image_embedder import ImageEmbedder as JImageEmbedder
from super_rag_tpu.service import rerank_service as jrr
from super_rag_tpu_torch.engine import index as tindex
from super_rag_tpu_torch.engine.collection import CollectionEngine
from super_rag_tpu_torch.models import cross_encoder as tce
from super_rag_tpu_torch.models import encoder as tenc
from super_rag_tpu_torch.models import encoder_service as tsvc
from super_rag_tpu_torch.models.image_embedder import ImageEmbedder
from super_rag_tpu_torch.service import rerank_service as trr
from torch_parity import assert_topk_match

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "checkpoints", "encoder_semantic")
RERANKER = CKPT + "_reranker"

TINY = dict(vocab_size=211, hidden_dim=32, num_layers=1, num_heads=4,
            mlp_dim=64, max_len=64)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two threads for this file's CPU forwards: the suite runs files in
    parallel workers that share the CPU, and some tests elsewhere time
    their own work."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def tiny(dtype="float32"):
    return (jenc.EncoderConfig(**TINY, dtype=jnp.dtype(dtype)),
            tenc.EncoderConfig(**TINY, dtype=getattr(torch, dtype)))


TEXTS = ["alpha beta gamma", "", "delta epsilon zeta eta theta " * 3,
         "知识 graph", "one"]


@pytest.mark.parametrize("model", ["encoder", "cross_encoder"])
def test_checkpoint_moves_between_the_packages(model, tmp_path):
    """Port save -> JAX load and JAX save -> port load give the same
    parameters, config and (f32) outputs."""
    jcfg, tcfg = tiny()
    jcls, tcls = ((jenc.TextEncoder, tenc.TextEncoder) if model == "encoder"
                  else (jce.CrossEncoder, tce.CrossEncoder))
    port = tenc.init_params(tcls(tcfg), torch.Generator().manual_seed(3))
    tsvc.save_params(tenc.flax_params(port), str(tmp_path / "p"), tcfg)
    jparams, jcfg_back = jsvc.load_params(str(tmp_path / "p"))
    assert jcfg_back == jcfg
    ids = np.random.default_rng(0).integers(3, 211, (4, 64)).astype(np.int32)
    mask = np.arange(64)[None] < np.array([64, 10, 1, 33])[:, None]
    want = np.asarray(jcls(jcfg).apply({"params": jparams}, ids, mask))
    with torch.inference_mode():
        got = port(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)

    jsvc.save_params(jparams, str(tmp_path / "j"), jcfg)
    tparams, tcfg_back = tsvc.load_params(str(tmp_path / "j"))
    assert tcfg_back == tcfg
    flat_j, flat_t = tenc.flatten_tree(jparams), tenc.flatten_tree(tparams)
    assert set(flat_t) == set(flat_j)
    for k in flat_j:
        np.testing.assert_array_equal(flat_t[k], np.asarray(flat_j[k]))


def test_encoder_service_matches_and_pads_without_crosstalk():
    jcfg, tcfg = tiny()
    params = jax.tree.map(np.asarray,
                          jenc.TextEncoder(jcfg).init_params(jax.random.PRNGKey(4)))
    jsv = jsvc.EncoderService(cfg=jcfg, params=params, batch_size=4, max_len=64)
    tsv = tsvc.EncoderService(cfg=tcfg, params=params, batch_size=4, max_len=64,
                              device="cpu")
    assert tsv.dim == jsv.dim == 32 and tsv.max_len == 64
    got = tsv.embed(TEXTS)
    np.testing.assert_allclose(got, jsv.embed(TEXTS), atol=2e-5, rtol=0)
    # a text embeds alike alone and inside a padded batch of others
    for i, text in enumerate(TEXTS):
        np.testing.assert_allclose(tsv.embed([text])[0], got[i], atol=1e-6, rtol=0)
    assert tsv.embed([]).shape == (0, 32)
    assert tsv.embed_device([]).shape == (0, 32)


def test_rerank_service_matches_and_caps_at_1000_docs():
    jcfg, tcfg = tiny()
    params = jax.tree.map(np.asarray,
                          jce.CrossEncoder(jcfg).init_params(jax.random.PRNGKey(5)))
    jr = jrr.RerankService(config=jcfg, params=params, batch_size=4)
    tr = trr.RerankService(config=tcfg, params=params, batch_size=4, device="cpu")
    assert tr.max_len == 64  # clipped to the position table
    np.testing.assert_allclose(tr("alpha query", TEXTS), jr("alpha query", TEXTS),
                               atol=2e-5, rtol=0)
    assert tr("q", []).shape == (0,)
    many = [f"document {i} about alpha" for i in range(trr.MAX_RERANK_DOCS + 7)]
    scores = tr("alpha", many)
    assert trr.MAX_RERANK_DOCS == jrr.MAX_RERANK_DOCS == 1000
    assert scores.shape == (1000,) and np.isfinite(scores).all()
    np.testing.assert_allclose(scores[:3], tr("alpha", many[:3]), atol=1e-6, rtol=0)


def _image(color, seed, stripes=8):
    from PIL import Image

    rng = np.random.default_rng(seed)
    arr = np.zeros((64, 96, 3), np.uint8)
    arr[:] = color
    arr = np.clip(arr.astype(int) + rng.integers(-20, 20, arr.shape), 0, 255)
    arr = arr.astype(np.uint8)
    arr[::stripes] = 255 - arr[::stripes]
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


IMAGES = [_image((200, 30, 30), 1), _image((30, 30, 200), 2, 5),
          _image((30, 200, 30), 3, 3), _image((120, 120, 120), 4, 11)]


def test_image_embedder_matches():
    imgs = IMAGES + [b"not an image"]
    for dim in (16, 256):
        got = ImageEmbedder(dim=dim).embed(imgs)
        np.testing.assert_array_equal(got, JImageEmbedder(dim=dim).embed(imgs))
        assert not got[-1].any()


# -- the slice end to end ----------------------------------------------------

def _corpus(rng, n):
    topics = {
        "finance": "revenue quarter profit margin forecast budget invoice tax",
        "medicine": "patient dose clinical trial symptom diagnosis therapy",
        "software": "compiler kernel memory thread cache latency throughput",
        "travel": "flight hotel passport airport luggage itinerary visa",
        "cooking": "recipe oven flour butter simmer garlic onion pepper",
    }
    vocab = {k: v.split() for k, v in topics.items()}
    names = list(vocab)
    out = []
    for i in range(n):
        topic = names[i % len(names)]
        words = rng.choice(vocab[topic], rng.integers(6, 20)).tolist()
        out.append(f"{topic} note {i}: " + " ".join(words))
    return out


@pytest.fixture(scope="module")
def engines():
    rng = np.random.default_rng(21)
    texts = _corpus(rng, 150)
    jspec = jindex.IndexSpec(dim=256, dtype=jnp.float32, bm25_slots=24,
                             vocab_size=1 << 12, min_capacity=512)
    tspec = tindex.IndexSpec(dim=256, dtype=torch.float32, bm25_slots=24,
                             vocab_size=1 << 12, min_capacity=512)
    j = JEngine(jspec,
                embedder=jsvc.EncoderService.from_checkpoint(CKPT, batch_size=32,
                                                             max_len=128),
                reranker=jrr.RerankService.from_checkpoint(RERANKER, max_len=128))
    t = CollectionEngine(
        tspec,
        embedder=tsvc.EncoderService.from_checkpoint(CKPT, batch_size=32, max_len=128,
                                                     device="cpu"),
        reranker=trr.RerankService.from_checkpoint(RERANKER, max_len=128,
                                                   device="cpu"),
        device="cpu")
    img_emb = ImageEmbedder(dim=256).embed(IMAGES)
    for eng in (j, t):
        assert eng.ingest(texts) == list(range(150))
        eng.ingest([f"figure {i}" for i in range(4)], indexer="vision",
                   embeddings=img_emb)
    return j, t, texts


# fused reranked scores are z(CE) + z(RRF): the CE scores carry the bf16
# forwards' rounding (within 2e-2 (1 + |s|), scaled by 1 / std(CE)) and the
# RRF scores move by a rank step where the bf16 embeddings reorder two
# close candidates (largest difference seen on this corpus: 0.091)
FUSED_TOL = 0.15


def test_hybrid_rerank_end_to_end_matches(engines):
    j, t, texts = engines
    queries = ["finance profit forecast", "clinical trial dose",
               "kernel cache latency", "hotel passport",
               "garlic onion recipe", texts[7][-30:], "note 42", "unrelated words"]
    jres = j.search_batch(queries, mode="hybrid", rerank=True, top_k=5)
    tres = t.search_batch(queries, mode="hybrid", rerank=True, top_k=5)
    for hits in tres:
        assert len(hits) == 5 and all(h.recall_type == "reranked" for h in hits)
    ref_v = np.array([[h.score for h in hs] for hs in jres], np.float32)
    ref_i = np.array([[h.row for h in hs] for hs in jres])
    got_v = np.array([[h.score for h in hs] for hs in tres], np.float32)
    got_i = np.array([[h.row for h in hs] for hs in tres])
    assert_topk_match(ref_v, ref_i, got_v, got_i, rtol=0.0, atol=FUSED_TOL)
    # the candidates before rerank: the hybrid top-100 of both packages
    jh = j.search_batch(queries, mode="hybrid", top_k=100)
    th = t.search_batch(queries, mode="hybrid", top_k=100)
    for a, b in zip(jh, th):
        assert len({h.row for h in a} ^ {h.row for h in b}) <= 4
    for hs, cand in zip(tres, th):
        assert {h.row for h in hs} <= {h.row for h in cand}


def test_search_by_image_matches(engines):
    j, t, _ = engines
    for k, img in enumerate(IMAGES):
        jh, th = j.search_by_image(img, top_k=3), t.search_by_image(img, top_k=3)
        assert [h.row for h in th] == [h.row for h in jh]
        assert th[0].row == 150 + k and th[0].recall_type == "vision_search"
        np.testing.assert_allclose([h.score for h in th], [h.score for h in jh],
                                   atol=1e-5, rtol=0)
    assert CollectionEngine(tindex.IndexSpec(dim=8), device="cpu").search_by_image(
        IMAGES[0]) == []
