"""Card-only tests of the PyTorch port: the CUDA kernel against its plain
PyTorch version, and the engine on the card against the same engine on the
CPU.  They skip without a CUDA card.  This file imports no JAX, so it runs
on a machine that has none:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from super_rag_tpu_torch.engine.collection import CollectionEngine
from super_rag_tpu_torch.engine.index import IndexSpec
from super_rag_tpu_torch.models.hash_embedder import HashEmbedder
from super_rag_tpu_torch.ops import dense_topk as dt
from super_rag_tpu_torch.ops.dense import build_corpus
from torch_parity import assert_topk_match

MODES = {"int8xint8": (torch.int8, True), "int8+bf16q": (torch.int8, False),
         "bf16": (torch.bfloat16, False), "f32": (torch.float32, False)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
def test_kernel_matches_plain_version(card, mode):
    """int8 x int8 bit-equal; the float modes within D * 2^-23 *
    (max|score| + 1): sums of exact products in different orders."""
    dtype, i8q = MODES[mode]
    gen = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(5000, 96, device=card, generator=gen)
    q = torch.randn(20, 96, device=card, generator=gen)
    keep = torch.rand(5000, device=card, generator=gen) < 0.6
    for metric in ("cosine", "ip", "l2"):
        corpus = build_corpus(x, metric=metric, dtype=dtype)
        for tile in (200, 2048):
            qq, qs, kt, _ = dt.prepare(q, corpus, 10, metric, tile, i8q, 2)
            norms = corpus.norms_sq if metric == "l2" else None
            args = (qq, qs, corpus.values, corpus.scales, norms, keep, 5000,
                    tile, kt)
            before = dt.launches.count
            kv, ki = dt.tile_topk(*args)
            assert dt.launches.count == before + 1
            pv, pi = dt.tile_topk_plain(*args)
            fin = torch.isfinite(pv)
            if i8q:
                assert torch.equal(kv, pv) and torch.equal(ki[fin], pi[fin])
            else:
                tol = 96 * 2.0 ** -23 * (float(pv[fin].abs().max()) + 1.0)
                assert_topk_match(pv.cpu(), pi.cpu(), kv.cpu(), ki.cpu(),
                                  rtol=0.0, atol=tol,
                                  scores=dt.plain_scores(*args[:6], 0, 5000))


@pytest.mark.cuda
def test_engine_on_card_answers_as_on_cpu(card):
    """int8 storage: the kernel's int32 sums are exact and every other
    stage is batch- and device-invariant, so the card's hybrid answers
    equal the CPU's (plain version) bit for bit."""
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(400)]
    texts = [" ".join(rng.choice(words, rng.integers(4, 14))) for _ in range(3000)]
    queries = [" ".join(t.split()[:3]) for t in texts[::150]]
    out = {}
    # one set of embeddings: both indexes normalise and quantize the same bits
    emb = HashEmbedder(dim=64, device="cpu").embed(texts)
    for dev in ("cpu", "cuda"):
        eng = CollectionEngine(IndexSpec(dim=64, dtype=torch.int8,
                                         vocab_size=1 << 12, min_capacity=256),
                               device=dev)
        eng.ingest(texts, embeddings=emb)
        eng.index.compact_lexical()
        eng.index._per_tile_k = 2  # the card calibrates at compaction
        res = eng.index.search_hybrid(eng._embed(queries), queries, k=10,
                                      candidates=40, use_kernel=True)
        out[dev] = (res.indices.cpu(), res.scores.cpu())
    assert torch.equal(out["cpu"][0], out["cuda"][0])
    assert torch.equal(out["cpu"][1], out["cuda"][1])


@pytest.mark.cuda
def test_hash_embedder_on_card_equals_cpu(card):
    """Elementwise adds in term order, correctly rounded division and
    square root: the card embeds to the CPU's bits."""
    texts = ["alpha beta gamma", "", " ".join(f"w{i}" for i in range(90))]
    cpu = HashEmbedder(dim=768, device="cpu").embed(texts)
    gpu = HashEmbedder(dim=768, device=card).embed(texts)
    assert torch.equal(cpu, gpu.cpu())
