"""Card-only tests of the PyTorch port: the CUDA kernels against their
plain PyTorch versions, and the engine on the card (flat and IVF tiers)
against the same engine on the CPU.  They skip without a CUDA card.  This file imports no JAX, so it runs
on a machine that has none:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py
"""

import dataclasses

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


IVF_MODES = {"int8": torch.int8, "bf16": torch.bfloat16, "f32": torch.float32}


def _ivf_operands(card, dtype, residual, masked, seed=0):
    """A ragged tile layout (C = 200, not a multiple of 128), empty slots,
    a keep-mask and probe scores to add back."""
    gen = torch.Generator(device=card).manual_seed(seed)
    nlist, cap, d, b = 12, 200, 96, 20
    x = torch.randn(nlist, cap, d, device=card, generator=gen)
    if dtype == torch.int8:
        values = torch.clamp(torch.round(x * 40), -127, 127).to(torch.int8)
        scales = torch.rand(nlist, cap, device=card, generator=gen) * 0.01
    else:
        values, scales = x.to(dtype), None
    row_ids = torch.randperm(nlist * cap, device=card, generator=gen).to(
        torch.int32).reshape(nlist, cap)
    row_ids[torch.rand(nlist, cap, device=card, generator=gen) < 0.2] = -1
    q = torch.randn(b, d, device=card, generator=gen)
    q = q.to(torch.float32 if dtype == torch.float32 else torch.bfloat16)
    cs = (torch.randn(b, nlist, device=card, generator=gen) if residual
          else None)
    mask = (torch.rand(nlist * cap, device=card, generator=gen) < 0.7
            if masked else None)
    return q, values, scales, cs, row_ids, mask


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(IVF_MODES))
@pytest.mark.parametrize("route", ["union", "probe"])
def test_ivf_kernels_match_plain_versions(card, mode, route):
    """Both IVF kernels against their plain versions, residual on and off,
    with and without a mask: -inf slots equal, values within
    D * 2^-23 * (max|score| + 1) (sums of exact products, or of f32
    products, in other orders); nprobe >= nlist is one of the cases."""
    from super_rag_tpu_torch.ops import ivf_topk as it

    for residual in (False, True):
        for masked in (False, True):
            q, values, scales, cs, row_ids, mask = _ivf_operands(
                card, IVF_MODES[mode], residual, masked)
            b = q.shape[0]
            if route == "union":
                ids = torch.tensor([3, 0, 11, 7, 5], dtype=torch.int32,
                                   device=card)
                fn, counter = it.union_scores, it.union_launches
                plain = it.union_scores_plain
            else:
                ids = torch.randint(0, 12, (b, 14), device=card,
                                    dtype=torch.int32)
                fn, counter = it.probe_scores, it.probe_launches
                plain = it.probe_scores_plain
            before = counter.count
            got = fn(q, ids, values, scales, cs, row_ids, mask)
            assert counter.count == before + 1
            ref = plain(q, ids, values, scales, cs, row_ids, mask)
            torch.cuda.synchronize()
            fin = torch.isfinite(ref)
            assert torch.equal(fin, torch.isfinite(got))
            tol = 96 * 2.0 ** -23 * (float(ref[fin].abs().max()) + 1.0)
            assert float((got - ref)[fin].abs().max()) <= tol


def _ivf_to(ivf, device):
    """A copy of an IVFIndex with every tensor on ``device``."""
    def mv(t):
        return None if t is None else t.to(device)

    of = ivf.overflow
    return dataclasses.replace(
        ivf, centroids=mv(ivf.centroids), values=mv(ivf.values),
        scales=mv(ivf.scales), row_ids=mv(ivf.row_ids),
        overflow=None if of is None else of._replace(
            values=mv(of.values), scales=mv(of.scales)),
        overflow_rows=mv(ivf.overflow_rows), sign_plane=mv(ivf.sign_plane),
        of_sign_plane=mv(ivf.of_sign_plane), of_assign=mv(ivf.of_assign))


@pytest.mark.cuda
@pytest.mark.parametrize("nprobe", [2, 4])  # union route; whole-index scan
def test_ivf_engine_on_card_answers_as_on_cpu(card, nprobe):
    """A small engine's IVF hybrid query: the card (the union kernel, or
    the whole-index scan) ranks as the CPU (plain versions) does; scores
    within 1e-5 (the kernels sum in another order)."""
    from super_rag_tpu_torch.ops import ivf_topk as it

    rng = np.random.default_rng(1)
    words = [f"w{i}" for i in range(400)]
    texts = [" ".join(rng.choice(words, rng.integers(4, 14))) for _ in range(3000)]
    queries = [" ".join(t.split()[:3]) for t in texts[::375]]  # 8 queries
    emb = HashEmbedder(dim=64, device="cpu").embed(texts)
    out = {}
    ivf = None
    for dev in ("cpu", "cuda"):
        eng = CollectionEngine(IndexSpec(dim=64, dtype=torch.int8,
                                         vocab_size=1 << 12, min_capacity=256),
                               device=dev)
        eng.ingest(texts, embeddings=emb)
        eng.index.compact_lexical()
        eng.index.compact_dense(nlist=32, nprobe=nprobe)
        # one snapshot for both: k-means on the card sums in another order
        ivf = eng.index._ivf if ivf is None else ivf
        eng.index._ivf = _ivf_to(ivf, dev)
        before = it.union_launches.count
        res = eng.index.search_hybrid(eng._embed(queries), queries, k=10,
                                      candidates=40, use_kernel=True)
        launched = it.union_launches.count - before
        out[dev] = (res.indices.cpu(), res.dense_scores.cpu(), launched)
    assert out["cuda"][2] == (1 if 8 * nprobe < 32 else 0)
    assert torch.equal(out["cpu"][0], out["cuda"][0])
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-5,
                               atol=1e-5)
