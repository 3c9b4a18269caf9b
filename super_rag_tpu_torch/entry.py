"""Entry points (the twins of the JAX package's ``__graft_entry__.py``).

entry(device)             -> (fn, example_args): the forward step of the
                             flagship model, the dual encoder feeding the
                             retrieval engine.
dryrun_multichip(n, ...)  -> the whole multi-device path on ``n`` ranks
                             (``parallel/launch.py``): (a) one dp x tp
                             train step, (b) a sharded dense search, (c)
                             the mutable sharded hybrid index at non-trivial
                             scale asserted equal to a one-rank gold index,
                             (c2) IVF at full probe equal to flat, (d) the
                             multislice mesh equal to the gold.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from super_rag_tpu_torch.device import DeviceLike, resolve_device

# the flagship encoder (the JAX entry's EncoderConfig)
FLAGSHIP = dict(vocab_size=8192, hidden_dim=256, num_layers=4, num_heads=8,
                mlp_dim=1024, max_len=128)
DRYRUN_TIMEOUT_S = 600.0


def entry(device: DeviceLike = None, params: Optional[Mapping] = None):
    """``(fn, (token_ids, mask))``: the flagship encoder's forward at
    ``[16, 128]`` in bf16, weights drawn from flax's initialisers with
    seed 0 (or ``params``, a flax tree such as the JAX entry's), the ids
    the JAX entry draws from ``np.random.default_rng(0)``."""
    from super_rag_tpu_torch.models.encoder import (
        EncoderConfig, TextEncoder, init_params, load_flax_params)

    dev = resolve_device(device)
    model = TextEncoder(EncoderConfig(**FLAGSHIP, dtype=torch.bfloat16))
    if params is None:
        init_params(model, torch.Generator().manual_seed(0))
    else:
        load_flax_params(model, params)
    model.to(dev).eval()
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, 8192, (16, 128)).astype(np.int32)).to(dev)
    mask = torch.ones((16, 128), dtype=torch.bool, device=dev)

    @torch.no_grad()
    def fn(token_ids, attn_mask):
        return model(token_ids, attn_mask)

    return fn, (ids, mask)


def dryrun_multichip(n_devices: int, device: DeviceLike = None,
                     backend: Optional[str] = None,
                     timeout_s: float = DRYRUN_TIMEOUT_S) -> None:
    """Run the multi-device path on ``n_devices`` ranks and raise unless
    every check holds.  ``backend`` defaults to gloo on the CPU and NCCL
    on CUDA (one rank per card); gloo on CUDA lets ranks share a card."""
    from super_rag_tpu_torch.parallel.launch import spawn

    spawn(_dryrun_rank, n_devices, backend=backend, device=device,
          timeout_s=timeout_s)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _toplists(res) -> list[set]:
    return [set(int(x) for x in row if x >= 0) for row in res.indices.cpu().tolist()]


def _dryrun_rank(rank: int, world: int, device: torch.device) -> None:
    from super_rag_tpu_torch.engine.index import DeviceIndex, FilterSpec, IndexSpec
    from super_rag_tpu_torch.engine.sharded_index import ShardedDeviceIndex
    from super_rag_tpu_torch.models.encoder import (
        EncoderConfig, TextEncoder, init_params)
    from super_rag_tpu_torch.models.hash_embedder import HashEmbedder
    from super_rag_tpu_torch.ops.dense import DenseCorpus, build_corpus
    from super_rag_tpu_torch.parallel.mesh import (
        corpus_mesh, multislice_mesh, shard_corpus)
    from super_rag_tpu_torch.parallel.sharded import sharded_dense_search
    from super_rag_tpu_torch.train.contrastive import (
        TrainConfig, create_train_state, make_train_step, train_mesh)

    rng = np.random.default_rng(0)

    # (a) one full training step over a (dp, tp) mesh
    tp = 2 if world % 2 == 0 and world >= 2 else 1
    mesh = train_mesh(tp=tp, device=device)
    model = TextEncoder(EncoderConfig(vocab_size=512, hidden_dim=64, num_layers=2,
                                      num_heads=4, mlp_dim=128, max_len=32,
                                      dtype=torch.float32))
    model = init_params(model, torch.Generator().manual_seed(0)).to(device)
    tcfg = TrainConfig(warmup_steps=1)
    state = create_train_state(model, None, tcfg, mesh=mesh)
    step = make_train_step(model, tcfg, mesh=mesh)
    b = max(16, world * 2)
    batch = {
        "q_ids": rng.integers(3, 512, (b, 16)).astype(np.int32),
        "q_mask": np.ones((b, 16), bool),
        "d_ids": rng.integers(3, 512, (b, 16)).astype(np.int32),
        "d_mask": np.ones((b, 16), bool),
    }
    state, metrics = step(state, batch)
    _check(np.isfinite(float(metrics["loss"])), "train step loss not finite")

    # (b) sharded corpus search with the all_gather top-k merge
    cmesh = corpus_mesh(device=device)
    corpus = build_corpus(torch.from_numpy(
        rng.standard_normal((world * 512, 128)).astype(np.float32)),
        dtype=torch.bfloat16)
    values = shard_corpus(cmesh, corpus.values)
    queries = torch.from_numpy(rng.standard_normal((4, 128)).astype(np.float32))
    v, i = sharded_dense_search(queries, DenseCorpus(values=values), k=10,
                                mesh=cmesh, block_size=256)
    _check(tuple(v.shape) == (4, 10) and tuple(i.shape) == (4, 10),
           "sharded search result has the wrong shape")

    # (c) the mutable sharded hybrid index at non-trivial scale: dim 256,
    # growth across capacity classes, uneven shard fill, a filter that
    # zeroes one whole shard, deletes: all equal to a one-rank gold
    spec = IndexSpec(dim=256, dtype=torch.bfloat16, vocab_size=1 << 14,
                     min_capacity=world * 256)
    sidx = ShardedDeviceIndex(spec, cmesh)
    gold = DeviceIndex(spec, device=device)
    embedder = HashEmbedder(dim=256, device="cpu")
    words = [f"w{j}" for j in range(60)]
    n_docs = world * 512 + 97  # odd tail: uneven per-shard fill
    docs = [" ".join([f"doc{j}", f"topic{j % 7}"]
                     + [words[int(x)] for x in rng.integers(0, 60, size=6)])
            for j in range(n_docs)]
    emb = np.asarray(embedder.embed(docs))
    # two adds: the second grows the capacity past min_capacity
    cut = world * 256 - 11
    for a, b2 in ((0, cut), (cut, n_docs)):
        sidx.add(emb[a:b2], docs[a:b2])
        gold.add(emb[a:b2], docs[a:b2])
    dead = [5, cut - 1, cut, n_docs - 1]
    sidx.delete(dead)
    gold.delete(dead)
    q_texts = ["topic3 w7 w11", "doc42 topic0", "w59 w58 topic6"]
    q_emb = np.asarray(embedder.embed(q_texts))
    gq = torch.from_numpy(q_emb)

    # the gold scores exactly (no per-tile cap): it is the reference
    res = sidx.search_hybrid(q_emb, q_texts, k=10)
    gres = gold.search_hybrid(gq, q_texts, k=10, use_kernel=False)
    _check(_toplists(res) == _toplists(gres), "sharded != one-rank gold")
    for row in _toplists(res):
        _check(not (row & set(dead)), "deleted row surfaced")

    # a filter that zeroes the whole of rank 0's shard
    shard_rows = sidx.shard_rows
    keep = tuple(r for r in range(n_docs) if r >= shard_rows and r not in dead)
    flt = FilterSpec(doc_rows=keep)
    res_f = sidx.search_hybrid(q_emb, q_texts, k=10, flt=flt)
    gres_f = gold.search_hybrid(gq, q_texts, k=10, flt=flt, use_kernel=False)
    _check(_toplists(res_f) == _toplists(gres_f), "filtered sharded != gold")
    for row in _toplists(res_f):
        _check(all(r >= shard_rows for r in row), "masked shard leaked")

    # (c2) the sharded IVF tier at full probe equals the flat result
    sidx.compact_dense(nlist=8, nprobe=8, kmeans_iters=2)
    res_ivf = sidx.search_hybrid(q_emb, q_texts, k=10)
    _check(_toplists(res_ivf) == _toplists(res), "IVF full-probe != flat")

    # (d) multislice: 2 slices x n/2 ranks, the hierarchical merge over
    # the same corpus and deletes, equal to the gold too
    if world % 2 == 0 and world >= 4:
        mmesh = multislice_mesh(2, device=device)
        midx = ShardedDeviceIndex(spec, mmesh)
        for a, b2 in ((0, cut), (cut, n_docs)):
            midx.add(emb[a:b2], docs[a:b2])
        midx.delete(dead)
        mres = midx.search_hybrid(q_emb, q_texts, k=10)
        _check(_toplists(mres) == _toplists(gres), "multislice != gold")
