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
from torch_parity import all_scores, assert_topk_match

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
            variant = dt.kernel_variant(dt._mode(qq, corpus.values), kt, 96)
            counter = dt.tc_launches if variant == "tc" else dt.simt_launches
            assert variant == ("tc" if i8q else "simt")
            before = counter.count
            kv, ki = dt.tile_topk(*args)
            assert counter.count == before + 1
            pv, pi = dt.tile_topk_plain(*args)
            fin = torch.isfinite(pv)
            if i8q:
                assert torch.equal(kv, pv) and torch.equal(ki[fin], pi[fin])
            else:
                tol = 96 * 2.0 ** -23 * (float(pv[fin].abs().max()) + 1.0)
                assert_topk_match(pv.cpu(), pi.cpu(), kv.cpu(), ki.cpu(),
                                  rtol=0.0, atol=tol,
                                  scores=dt.plain_scores(*args[:6], 0, 5000))


def _int8_operands(card, b, n, d, seed, masked, l2):
    """int8 x int8 operands made on the card: codes, per-row scales, int8
    queries with their scales; a keep-mask whose second tile is all
    masked; rows 64.. repeating rows 0.. (ties inside and across tiles)."""
    gen = torch.Generator(device=card).manual_seed(seed)
    values = torch.randint(-127, 128, (n, d), device=card, generator=gen,
                           dtype=torch.int8)
    values[64:96] = values[0:32]
    values[2048 + 5:2048 + 37] = values[0:32]
    scales = torch.rand(n, device=card, generator=gen) * 0.01 + 0.001
    scales[64:96] = scales[0:32]
    scales[2048 + 5:2048 + 37] = scales[0:32]
    q = torch.randint(-127, 128, (b, d), device=card, generator=gen,
                      dtype=torch.int8)
    qscale = torch.rand(b, device=card, generator=gen) * 0.01 + 0.001
    mask = None
    if masked:
        mask = torch.rand(n, device=card, generator=gen) < 0.7
        mask[2048:4096] = False
    norms = (torch.rand(n, device=card, generator=gen) if l2 else None)
    return q, qscale, values, scales, norms, mask


@pytest.mark.cuda
@pytest.mark.parametrize("kt", [1, 2, 3, 8, 9])
@pytest.mark.parametrize("d", [16, 48, 768])
@pytest.mark.parametrize("b", [1, 17, 130])
def test_int8_kernel_bit_equal_at_ragged_shapes(card, b, d, kt):
    """int8 x int8 at B not a multiple of the 64-query block, n = 5000
    (not a multiple of the 2048-row tile nor the 128-row chunk), D in
    {16, 48, 768}: the tensor-core kernel (kt <= 8) and the SIMT one
    (kt = 9, above the register lists' cap) equal tile_topk_plain bit for
    bit, values and ids, -inf slots included; with and without a mask
    (an all-masked tile), with L2 norms, with duplicate rows."""
    n, tile = 5000, 2048
    variant = dt.kernel_variant(dt.MODE_INT8, kt, d)
    assert variant == ("tc" if kt <= 8 else "simt")
    counter = dt.tc_launches if variant == "tc" else dt.simt_launches
    for masked, l2 in ((False, False), (True, False), (True, True)):
        q, qs, values, scales, norms, mask = _int8_operands(
            card, b, n, d, seed=b * 1000 + d + kt, masked=masked, l2=l2)
        args = (q, qs, values, scales, norms, mask, n, tile, kt)
        before = (dt.tc_launches.count, dt.simt_launches.count)
        kv, ki = dt.tile_topk(*args)
        after = (dt.tc_launches.count, dt.simt_launches.count)
        assert sum(after) - sum(before) == 1
        assert counter.count == (before[0] if variant == "tc" else before[1]) + 1
        pv, pi = dt.tile_topk_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(kv, pv)
        assert torch.equal(ki, pi)
        if masked:
            assert torch.isinf(kv[1]).all()  # the all-masked tile


@pytest.mark.cuda
@pytest.mark.parametrize("kt", [1, 2, 5])
def test_int8_kernel_bit_equal_at_the_largest_d(card, kt):
    """D = 1024: the kt <= 2 block's shared memory does not fit there, so
    the tensor-core kernel takes its narrower block for every kt."""
    n, b, d = 4100, 130, dt.TC_MAX_D
    assert dt.kernel_variant(dt.MODE_INT8, kt, d) == "tc"
    q, qs, values, scales, norms, mask = _int8_operands(
        card, b, n, d, seed=kt, masked=True, l2=True)
    args = (q, qs, values, scales, norms, mask, n, 2048, kt)
    before = dt.tc_launches.count
    kv, ki = dt.tile_topk(*args)
    assert dt.tc_launches.count == before + 1
    pv, pi = dt.tile_topk_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(kv, pv) and torch.equal(ki, pi)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [200, 1000])
def test_int8_kernel_bit_equal_at_small_tiles(card, tile):
    """Tiles that are not a multiple of the 128-row chunk."""
    n, b = 5000, 70
    q, qs, values, scales, norms, mask = _int8_operands(
        card, b, n, 96, seed=tile, masked=True, l2=False)
    for kt in (1, 4, 8):
        args = (q, qs, values, scales, None, mask, n, tile, kt)
        before = dt.tc_launches.count
        kv, ki = dt.tile_topk(*args)
        assert dt.tc_launches.count == before + 1
        pv, pi = dt.tile_topk_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(kv, pv) and torch.equal(ki, pi)


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
    products, in other orders); nprobe >= nlist is one of the cases.  Each
    call launches the variant its mode picks (tensor cores for int8 /
    bf16 values, SIMT for f32) once, and no other kernel."""
    from super_rag_tpu_torch.ops import ivf_topk as it

    for residual in (False, True):
        for masked in (False, True):
            q, values, scales, cs, row_ids, mask = _ivf_operands(
                card, IVF_MODES[mode], residual, masked)
            b = q.shape[0]
            if route == "union":
                ids = torch.tensor([3, 0, 11, 7, 5], dtype=torch.int32,
                                   device=card)
                fn = it.union_scores
                counter = (it.union_tc_launches if mode != "f32"
                           else it.union_simt_launches)
                plain = it.union_scores_plain
            else:
                ids = torch.randint(0, 12, (b, 14), device=card,
                                    dtype=torch.int32)
                fn = it.probe_scores
                counter = (it.probe_tc_launches if mode != "f32"
                           else it.probe_simt_launches)
                plain = it.probe_scores_plain
            counters = (it.union_tc_launches, it.union_simt_launches,
                        it.probe_tc_launches, it.probe_simt_launches)
            before = [c.count for c in counters]
            got = fn(q, ids, values, scales, cs, row_ids, mask)
            moved = [c.count - n for c, n in zip(counters, before)]
            assert moved == [int(c is counter) for c in counters]
            ref = plain(q, ids, values, scales, cs, row_ids, mask)
            torch.cuda.synchronize()
            fin = torch.isfinite(ref)
            assert torch.equal(fin, torch.isfinite(got))
            tol = 96 * 2.0 ** -23 * (float(ref[fin].abs().max()) + 1.0)
            assert float((got - ref)[fin].abs().max()) <= tol


def _union_operands(card, dtype, b, nlist, cap, d, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn(nlist, cap, d, device=card, generator=gen)
    if dtype == torch.int8:
        values = torch.clamp(torch.round(x * 40), -127, 127).to(torch.int8)
        scales = torch.rand(nlist, cap, device=card, generator=gen) * 0.01
    else:
        values, scales = x.to(dtype), None
    row_ids = torch.randperm(nlist * cap, device=card, generator=gen).to(
        torch.int32).reshape(nlist, cap)
    row_ids[torch.rand(nlist, cap, device=card, generator=gen) < 0.2] = -1
    q = torch.randn(b, d, device=card, generator=gen).to(torch.bfloat16)
    cs = torch.randn(b, nlist, device=card, generator=gen)
    mask = torch.rand(nlist * cap, device=card, generator=gen) < 0.7
    return q, values, scales, cs, row_ids, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("b,u,cap,d", [(1, 3, 200, 96), (20, 5, 257, 16),
                                       (33, 7, 1280, 768), (70, 2, 300, 48)])
def test_union_tc_kernel_within_tolerance_at_ragged_shapes(card, dtype, b, u,
                                                           cap, d):
    """The tensor-core union kernel against union_scores_plain at B, U and
    C off the 32-query / 256-row blocks and D off the 64-byte stage:
    the same -inf slots, values within D * 2^-23 * (max|s| + 1)."""
    from super_rag_tpu_torch.ops import ivf_topk as it

    nlist = 9
    q, values, scales, cs, row_ids, mask = _union_operands(card, dtype, b,
                                                           nlist, cap, d)
    union = torch.randperm(nlist, device=card)[:u].to(torch.int32)
    for residual, masked in ((False, False), (True, True)):
        args = (q, union, values, scales, cs if residual else None, row_ids,
                mask if masked else None)
        before = (it.union_tc_launches.count, it.union_simt_launches.count)
        got = it.union_scores(*args)
        assert (it.union_tc_launches.count, it.union_simt_launches.count) == (
            before[0] + 1, before[1])
        ref = it.union_scores_plain(*args)
        torch.cuda.synchronize()
        assert got.shape == (b, u, cap)
        fin = torch.isfinite(ref)
        assert torch.equal(fin, torch.isfinite(got))
        tol = d * 2.0 ** -23 * (float(ref[fin].abs().max()) + 1.0)
        assert float((got - ref)[fin].abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_union_tc_kernel_is_batch_invariant(card, dtype):
    """A query scores bit-alike alone and inside a batch of 32 (and of
    40, a second query block): the MMA's order is fixed by D alone."""
    from super_rag_tpu_torch.ops import ivf_topk as it

    q, values, scales, cs, row_ids, mask = _union_operands(card, dtype, 40, 12,
                                                           1280, 768, seed=3)
    union = torch.tensor([7, 0, 11, 3], dtype=torch.int32, device=card)
    full = it.union_scores(q, union, values, scales, cs, row_ids, mask)
    b32 = it.union_scores(q[:32].contiguous(), union, values, scales,
                          cs[:32].contiguous(), row_ids, mask)
    for i in (0, 17, 31, 35):
        alone = it.union_scores(q[i:i + 1].contiguous(), union, values, scales,
                                cs[i:i + 1].contiguous(), row_ids, mask)
        assert torch.equal(alone[0], full[i])
        if i < 32:
            assert torch.equal(alone[0], b32[i])


def _probe_sets(card, kind, b, nlist, nprobe, gen):
    """Probe lists [B, nprobe] int32 of a kind: random (repeats allowed),
    repeated (every query lists a tile twice), every tile (nprobe =
    nlist), skewed (every query on the same two tiles, so each of them
    spans several groups of the work list)."""
    if kind == "random":
        return torch.randint(0, nlist, (b, nprobe), device=card, generator=gen,
                             dtype=torch.int32)
    if kind == "repeated":
        p = torch.randint(0, nlist, (b, nprobe), device=card, generator=gen,
                          dtype=torch.int32)
        p[:, 1] = p[:, 0]
        return p
    if kind == "every_tile":
        return torch.stack([torch.randperm(nlist, device=card, generator=gen)
                            for _ in range(b)]).to(torch.int32)
    if kind == "skewed":
        pair = torch.tensor([nlist - 1, 1], dtype=torch.int32, device=card)
        return pair.repeat(b, nprobe // 2 + 1)[:, :nprobe].contiguous()
    raise ValueError(kind)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("b,nlist,nprobe,cap,d,kind", [
    (20, 12, 5, 200, 96, "random"), (33, 9, 4, 257, 16, "repeated"),
    (7, 6, 6, 300, 48, "every_tile"), (70, 8, 3, 200, 96, "skewed"),
    (40, 10, 4, 1280, 768, "random"), (45, 5, 2, 200, 1536, "skewed"),
    (3, 4, 4, 129, 1536, "every_tile")])
def test_probe_tc_kernel_within_tolerance_at_ragged_shapes(
        card, dtype, b, nlist, nprobe, cap, d, kind):
    """The tensor-core per-query kernel against probe_scores_plain: ragged
    C, D from 16 to 1536 (above the SIMT kernel's 1024), B * nprobe off
    the 32-pair group, repeated and skewed probe lists, nprobe = nlist;
    residual and mask on and off.  The same -inf slots, values within
    D * 2^-23 * (max|s| + 1), top-10 ids equal up to near-ties."""
    from super_rag_tpu_torch.ops import ivf_topk as it
    from super_rag_tpu_torch.ops.topk import stable_topk

    q, values, scales, cs, row_ids, mask = _union_operands(card, dtype, b,
                                                           nlist, cap, d)
    gen = torch.Generator(device=card).manual_seed(b + d)
    probes = _probe_sets(card, kind, b, nlist, nprobe, gen)
    for residual, masked in ((False, False), (True, True), (True, False),
                             (False, True)):
        args = (q, probes, values, scales, cs if residual else None, row_ids,
                mask if masked else None)
        before = (it.probe_tc_launches.count, it.probe_simt_launches.count)
        got = it.probe_scores(*args)
        assert (it.probe_tc_launches.count, it.probe_simt_launches.count) == (
            before[0] + 1, before[1])
        ref = it.probe_scores_plain(*args)
        torch.cuda.synchronize()
        assert got.shape == (b, nprobe, cap)
        fin = torch.isfinite(ref)
        assert torch.equal(fin, torch.isfinite(got))
        tol = d * 2.0 ** -23 * (float(ref[fin].abs().max()) + 1.0)
        assert float((got - ref)[fin].abs().max()) <= tol
        k = min(10, nprobe * cap)
        gv, gi = stable_topk(got.reshape(b, -1), k)
        rv, ri = stable_topk(ref.reshape(b, -1), k)
        assert_topk_match(rv.cpu(), ri.cpu(), gv.cpu(), gi.cpu(), rtol=0.0,
                          atol=tol, scores=ref.reshape(b, -1).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_probe_tc_kernel_is_batch_invariant(card, dtype):
    """A query scores bit-alike alone and inside a batch of 512 (where
    its tiles' groups hold other queries): a column's MMA sums depend on
    D alone."""
    from super_rag_tpu_torch.ops import ivf_topk as it

    b, nlist, nprobe = 512, 64, 16
    q, values, scales, cs, row_ids, mask = _union_operands(card, dtype, b,
                                                           nlist, 1280, 768,
                                                           seed=5)
    gen = torch.Generator(device=card).manual_seed(6)
    probes = _probe_sets(card, "random", b, nlist, nprobe, gen)
    full = it.probe_scores(q, probes, values, scales, cs, row_ids, mask)
    for i in (0, 17, 255, 511):
        alone = it.probe_scores(q[i:i + 1].contiguous(),
                                probes[i:i + 1].contiguous(), values, scales,
                                cs[i:i + 1].contiguous(), row_ids, mask)
        assert torch.equal(alone[0], full[i])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("kind", ["random", "skewed", "every_tile"])
def test_probe_tc_kernel_equals_union_kernel_gathered(card, dtype, kind):
    """Both routes run one kernel body with one MMA order, so a query's
    scores against a tile are the same bits on either: the per-query
    kernel equals the union kernel over every tile, gathered at each
    query's probes."""
    from super_rag_tpu_torch.ops import ivf_topk as it

    b, nlist, nprobe = 70, 12, 12 if kind == "every_tile" else 5
    q, values, scales, cs, row_ids, mask = _union_operands(card, dtype, b,
                                                           nlist, 300, 768,
                                                           seed=7)
    gen = torch.Generator(device=card).manual_seed(8)
    probes = _probe_sets(card, kind, b, nlist, nprobe, gen)
    every = torch.arange(nlist, dtype=torch.int32, device=card)
    for residual in (False, True):
        c = cs if residual else None
        got = it.probe_scores(q, probes, values, scales, c, row_ids, mask)
        union = it.union_scores(q, every, values, scales, c, row_ids, mask)
        want = torch.gather(union, 1, probes.long()[:, :, None].expand(
            -1, -1, union.shape[2]))
        assert torch.equal(got, want)


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
        before = it.union_tc_launches.count
        res = eng.index.search_hybrid(eng._embed(queries), queries, k=10,
                                      candidates=40, use_kernel=True)
        launched = it.union_tc_launches.count - before
        out[dev] = (res.indices.cpu(), res.dense_scores.cpu(), launched)
    assert out["cuda"][2] == (1 if 8 * nprobe < 32 else 0)
    assert torch.equal(out["cpu"][0], out["cuda"][0])
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
def test_f32_encoder_and_cross_encoder_on_card_equal_their_cpu_run(card):
    """The checkpoint-shaped encoder and cross-encoder in f32 (TF32 off)
    on the card against the same modules and weights on the CPU:
    embeddings within 1e-5, scores within 1e-4 (1 + |s|)."""
    from super_rag_tpu_torch.models.cross_encoder import CrossEncoder
    from super_rag_tpu_torch.models.encoder import (
        EncoderConfig, TextEncoder, init_params)

    cfg = EncoderConfig(vocab_size=30522, hidden_dim=256, num_layers=6, num_heads=8,
                        mlp_dim=1024, max_len=128, dtype=torch.float32)
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(4, 30522, (16, 128)).astype(np.int32))
    mask = torch.arange(128)[None] < torch.from_numpy(rng.integers(1, 129, (16, 1)))
    tt = (torch.arange(128)[None] >= 20).to(torch.int32) * mask
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for cls in (TextEncoder, CrossEncoder):
            model = init_params(cls(cfg), torch.Generator().manual_seed(0)).eval()
            with torch.inference_mode():
                want = model(ids, mask, tt)
                got = model.to(card)(ids.to(card), mask.to(card), tt.to(card)).cpu()
            tol = 1e-5 if cls is TextEncoder else 1e-4 * (1 + want.abs())
            assert ((got - want).abs() <= tol).all()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _csr_corpus(rows=20000, slots=24, vocab=1 << 12, seed=5):
    """Zipfian doc-term table (duplicates in a row kept, pads, a dead
    row), as the CSR tier's CPU parity tests draw it."""
    rng = np.random.default_rng(seed)
    terms = ((rng.zipf(1.3, size=(rows, slots)) - 1) % vocab).astype(np.int32)
    tfs = np.minimum(rng.zipf(2.0, size=(rows, slots)), 8).astype(np.float32)
    pad = rng.random((rows, slots)) < 0.2
    terms[pad], tfs[pad] = vocab, 0.0
    terms[3], tfs[3] = vocab, 0.0
    doc_len = (tfs.sum(1) * 2.0 + 1.0).astype(np.float32)
    return terms, tfs, doc_len, vocab


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 16])
def test_csr_build_on_card_equals_the_cpu_build(card, shards):
    """build_inverted_csr on the card: docs, bf16 impact bits and offsets
    equal the CPU build bit for bit (the CPU build equals the JAX
    package's, tests/test_torch_csr.py)."""
    from super_rag_tpu_torch.ops.bm25_inverted import build_inverted_csr

    terms, tfs, dl, vocab = _csr_corpus()
    args = [torch.from_numpy(a) for a in (terms, tfs, dl)]
    cpu = build_inverted_csr(*args, vocab, shards=shards)
    gpu = build_inverted_csr(*[a.to(card) for a in args], vocab, shards=shards)
    assert gpu.postings_docs.device.type == "cuda"
    assert torch.equal(gpu.postings_docs.cpu(), cpu.postings_docs)
    assert torch.equal(gpu.postings_impact.cpu().view(torch.int16),
                       cpu.postings_impact.view(torch.int16))
    assert torch.equal(gpu.offsets.cpu(), cpu.offsets)


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 16])
@pytest.mark.parametrize("budget", [dict(postings_per_query_term=64),
                                    dict(postings_per_query_term=64, deep_terms=3,
                                         deep_postings=2048)])
def test_csr_search_on_card_equals_cpu(card, shards, budget):
    """The CSR search on the card: the CPU's ids up to near-ties, scores
    within 1e-6 (f64 run sums rounded once on either device)."""
    from super_rag_tpu_torch.ops.bm25_inverted import (
        build_inverted_csr, inverted_bm25_search)

    terms, tfs, dl, vocab = _csr_corpus()
    index = build_inverted_csr(*[torch.from_numpy(a) for a in (terms, tfs, dl)],
                               vocab, shards=shards)
    rng = np.random.default_rng(6)
    qt = np.full((16, 8), vocab, np.int32)
    for i, r in enumerate(rng.integers(0, len(terms), 16)):
        u = [x for x in dict.fromkeys(terms[r].tolist()) if x != vocab][:8]
        qt[i, :len(u)] = u
    qi = np.where(qt < vocab, rng.random(qt.shape) + 0.5, 0.0).astype(np.float32)
    mask = torch.from_numpy(rng.random(len(terms)) < 0.8)
    q = (torch.from_numpy(qt), torch.from_numpy(qi))
    cv, ci = inverted_bm25_search(*q, index, k=50, mask=mask, **budget)
    on_card = type(index)(*(a.to(card) for a in index[:3]), index.num_docs)
    gv, gi = inverted_bm25_search(*(a.to(card) for a in q), on_card, k=50,
                                  mask=mask.to(card), **budget)
    full = inverted_bm25_search(*q, index, k=len(terms), mask=mask, **budget)
    assert_topk_match(cv, ci, gv.cpu(), gi.cpu(), rtol=1e-6, atol=1e-6,
                      scores=all_scores(*full, len(terms)))
