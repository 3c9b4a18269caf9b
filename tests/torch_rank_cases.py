"""Rank functions of the multi-device parity tests.

The tests spawn gloo ranks on the CPU through
``super_rag_tpu_torch/parallel/launch.py``; a spawned rank imports its
function by module path, so they live here, in a module that imports no
JAX (the test files that hold the JAX side import this one, not the other
way round).  Inputs arrive as numpy arrays made in the test, results go
back as tensors on the host.
"""

import sys

import numpy as np
import torch

from super_rag_tpu_torch.engine.index import DeviceIndex, FilterSpec, IndexSpec
from super_rag_tpu_torch.engine.sharded_index import ShardedDeviceIndex
from super_rag_tpu_torch.ops.dense import DenseCorpus, Metric, build_corpus
from super_rag_tpu_torch.parallel.mesh import (
    corpus_mesh, multislice_mesh, row_axes, shard_corpus)
from super_rag_tpu_torch.parallel.sharded import sharded_dense_search

# seconds a spawned group may take before it is killed and the test fails
SPAWN_TIMEOUT_S = 120.0

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


def _mesh(device, slices: int):
    return (corpus_mesh(device=device) if slices == 1
            else multislice_mesh(slices, device=device))


def _hybrid(res) -> dict:
    return {"indices": res.indices, "scores": res.scores,
            "dense": res.dense_scores, "bm25": res.bm25_scores}


def parallel_cases(rank, world, device, slices: int, dense: list, hybrid: list) -> dict:
    """``sharded_dense_search`` over each dense case and a
    ``ShardedDeviceIndex`` run through each hybrid script; the mesh is 1-D
    or ``slices`` x world / slices."""
    mesh = _mesh(device, slices)
    out = {"axes": row_axes(mesh), "shape": mesh.shape}
    for case in dense:
        corpus = build_corpus(torch.from_numpy(case["corpus"]), metric=case["metric"],
                              dtype=DTYPES[case["dtype"]])
        values, scales, norms = shard_corpus(mesh, corpus.values, corpus.scales,
                                             corpus.norms_sq)
        mask = None
        if case.get("keep") is not None:
            mask = shard_corpus(mesh, torch.from_numpy(case["keep"]))
        v, i = sharded_dense_search(
            torch.from_numpy(case["queries"]),
            DenseCorpus(values=values, scales=scales, norms_sq=norms),
            k=case["k"], mesh=mesh, metric=case["metric"], mask=mask,
            block_size=case["block_size"])
        out[case["name"]] = (v, i)
    for script in hybrid:
        out[script["name"]] = run_index_script(mesh, script)
    return out


def run_index_script(mesh, script: dict) -> list:
    """Drive a ``ShardedDeviceIndex`` through ``script["steps"]``: each step
    ``(op, kwargs)``; the results of the searches, in order."""
    spec = IndexSpec(**script["spec"], dtype=DTYPES[script["dtype"]])
    idx = ShardedDeviceIndex(spec, mesh)
    out = []
    for op, kw in script["steps"]:
        if op == "add":
            out_rows = idx.add(kw["emb"], kw["texts"], indexer=kw.get("indexer", "vector"),
                               chat_id=kw.get("chat_id"))
            out.append(("rows", out_rows))
        elif op == "delete":
            idx.delete(kw["rows"])
        elif op == "delete_top":
            # the first hit of the last search
            idx.delete([int(out[-1][1]["indices"][0, 0])])
        elif op == "compact_lexical":
            idx.compact_lexical(**kw)
        elif op == "compact_dense":
            idx.compact_dense(**kw)
        elif op == "search":
            kw = dict(kw)
            flt = kw.pop("flt", None)
            res = idx.search_hybrid(kw.pop("emb"), kw.pop("texts"),
                                    flt=FilterSpec(**flt) if flt else None, **kw)
            out.append(("search", _hybrid(res)))
        elif op == "state":
            out.append(("state", {
                "size": idx.size, "capacity": idx._capacity, "shard_rows": idx.shard_rows,
                "emb_rows": idx.emb.shape[0], "inverted_upto": idx._inverted_upto,
                "ivf": idx._ivf is not None, "tail": len(idx._tail_rows),
                "inv_rows": None if idx._inv is None else idx._inv.num_docs,
                "valid": idx.valid.clone(), "emb": idx.emb.float().clone(),
                "row_index": mesh.row_index}))
        elif op == "snapshot":
            arrays, host = idx.snapshot_state()
            out.append(("snapshot", (arrays, host)))
            restored = ShardedDeviceIndex.from_snapshot(arrays, host, mesh)
            res = restored.search_hybrid(kw["emb"], kw["texts"], k=kw["k"],
                                         candidates=kw["candidates"])
            out.append(("search", _hybrid(res)))
        elif op == "restore_jax":
            from super_rag_tpu_torch.convert import sharded_index_from_jax_snapshot

            restored = sharded_index_from_jax_snapshot(kw["arrays"], kw["host"], mesh)
            res = restored.search_hybrid(kw["emb"], kw["texts"], k=kw["k"],
                                         candidates=kw["candidates"])
            out.append(("search", _hybrid(res)))
        elif op == "kernel_vs_plain":
            a = idx.search_hybrid(kw["emb"], kw["texts"], k=kw["k"],
                                  candidates=kw["candidates"], use_kernel=False)
            b = idx.search_hybrid(kw["emb"], kw["texts"], k=kw["k"],
                                  candidates=kw["candidates"], use_kernel=True)
            out.append(("pair", (_hybrid(a), _hybrid(b))))
        else:
            raise ValueError(f"unknown step {op!r}")
    return out


def one_device_script(script: dict) -> list:
    """The same script's adds, deletes and searches on a one-device
    ``DeviceIndex`` on the CPU (the gold)."""
    spec = IndexSpec(**script["spec"], dtype=DTYPES[script["dtype"]])
    idx = DeviceIndex(spec, device="cpu")
    out = []
    for op, kw in script["steps"]:
        if op == "add":
            idx.add(kw["emb"], kw["texts"], indexer=kw.get("indexer", "vector"),
                    chat_id=kw.get("chat_id"))
        elif op == "delete":
            idx.delete(kw["rows"])
        elif op == "search":
            kw = dict(kw)
            flt = kw.pop("flt", None)
            res = idx.search_hybrid(torch.tensor(kw.pop("emb")), kw.pop("texts"),
                                    flt=FilterSpec(**flt) if flt else None,
                                    use_kernel=False, **kw)
            out.append(_hybrid(res))
    return out


# -- training ----------------------------------------------------------------------

def mesh_train_steps(rank, world, device, tp: int, cfg: dict, tcfg: dict,
                     params: dict, batches: list) -> dict:
    """``len(batches)`` dp x tp steps of the port's contrastive trainer from
    the flax tree ``params``; the metrics of each step and the gathered
    parameters after the last."""
    from super_rag_tpu_torch import convert
    from super_rag_tpu_torch.models.encoder import EncoderConfig
    from super_rag_tpu_torch.train import contrastive as ttc

    mesh = ttc.train_mesh(tp=tp, device=device)
    model = convert.encoder_from_jax(params, EncoderConfig(**cfg), device=device)
    state = ttc.create_train_state(model, None, ttc.TrainConfig(**tcfg), mesh=mesh)
    step = ttc.make_train_step(model, ttc.TrainConfig(**tcfg), mesh=mesh)
    metrics = []
    for batch in batches:
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    shapes = {name: tuple(p.shape) for name, p in model.named_parameters()}
    return {"metrics": metrics, "params": convert.gather_params(model, mesh),
            "shapes": shapes, "coords": mesh.coords}


# -- imports -------------------------------------------------------------------------

def imported_modules(rank, world, device, modules: list) -> list:
    """Import ``modules`` in a spawned rank; the JAX modules then loaded."""
    for m in modules:
        __import__(m)
    return sorted(m for m in sys.modules
                  if m == "jax" or m.startswith("jax.") or m == "super_rag_tpu"
                  or m.startswith("super_rag_tpu."))


# -- the smoke's [multi] phase on the CPU ------------------------------------------

def stub_card_rank() -> None:
    """In a spawned rank of ``chip_smoke.multi_rank``: the stubs of
    ``tests/test_torch_smoke.py stub_card`` (timers, the card's queries,
    dense_topk's plain version moving the variant's counters)."""
    import chip_smoke as cs
    from super_rag_tpu_torch.ops import dense_topk as dt

    def plain_counting(*args):
        q, _, values, *_, n, tile, kt = args
        mode = dt._mode(q, values)
        dt.count_launch(dt.kernel_variant(mode, kt, q.shape[1], q.shape[0], -(-n // tile), 132),
                        mode)
        return dt.tile_topk_plain(*args)

    def timed(fn, *a, **kw):
        fn()
        return 1.0

    torch.cuda.synchronize = lambda *a: None
    torch.cuda.current_device = lambda: 0
    cs.cuda_ms = cs.host_ms = timed
    dt._sm_count = lambda i: 132
    dt.tile_topk = plain_counting
