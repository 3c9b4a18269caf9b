"""Start an SPMD group of ranks and collect what each returns.

``spawn(fn, world, ...)`` starts ``world`` processes with
``torch.multiprocessing``'s ``spawn`` start method; each joins one
process group (rendezvous through a file in a temporary directory, so
concurrent groups on one machine never collide on a port), runs
``fn(rank, world, device, *args)`` and hands back its return value,
tensors moved to the host.  A rank that raises fails the whole group; a
group still running at ``timeout_s`` is killed and ``spawn`` raises
``TimeoutError``: a hang becomes a failure, never a stuck caller.

``fn`` is pickled by its import path, so it must live in a module that a
fresh interpreter can import without the caller's state (for the port's
own callers, a module that imports no JAX).
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time
from datetime import timedelta
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as torch_mp

from super_rag_tpu_torch.device import DeviceLike, resolve_device

# CPU threads a rank uses when its device is the CPU: ranks share the
# machine's cores
CPU_THREADS_PER_RANK = 2


def _host(x):
    """``x`` with every tensor moved to the host (recursively through
    dicts, lists and tuples), so it pickles without the device."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    return x


def _rank_main(rank: int, fn: Callable, world: int, backend: str,
               device_type: str, workdir: str, timeout_s: float,
               args: tuple) -> None:
    if device_type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(CPU_THREADS_PER_RANK)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(workdir, 'rendezvous')}",
        rank=rank, world_size=world, timeout=timedelta(seconds=timeout_s))
    try:
        out = fn(rank, world, device, *args)
        if device_type == "cuda":
            torch.cuda.synchronize(device)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    path = os.path.join(workdir, f"rank{rank}.pkl")
    with open(path + ".part", "wb") as f:
        pickle.dump(_host(out), f)
    os.replace(path + ".part", path)


def spawn(fn: Callable, world: int, backend: Optional[str] = None,
          device: DeviceLike = None, timeout_s: float = 300.0,
          args: tuple = ()) -> list:
    """Run ``fn(rank, world, device, *args)`` on ``world`` ranks and return
    their results in rank order.

    ``device`` (default the card) is each rank's device type: on CUDA rank
    r takes card r % cards.  ``backend`` defaults to NCCL on CUDA (one
    rank per card) and gloo on the CPU; gloo on CUDA lets ranks share a
    card.  Raises ``RuntimeError`` if a rank fails and ``TimeoutError``
    after ``timeout_s``, with every rank stopped either way."""
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and world > torch.cuda.device_count():
        raise ValueError(f"NCCL takes one rank per card: {world} ranks, "
                         f"{torch.cuda.device_count()} cards")
    workdir = tempfile.mkdtemp(prefix="spmd-")
    ctx = torch_mp.start_processes(
        _rank_main, args=(fn, world, backend, dev.type, workdir, timeout_s, args),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks of {fn.__qualname__} still "
                                   f"running after {timeout_s} s")
    except torch_mp.ProcessRaisedException as e:
        raise RuntimeError(f"a rank of {fn.__qualname__} failed:\n{e}") from None
    except torch_mp.ProcessExitedException as e:
        raise RuntimeError(f"a rank of {fn.__qualname__} exited: {e}") from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
        results = []
        for r in range(world):
            path = os.path.join(workdir, f"rank{r}.pkl")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    results.append(pickle.load(f))
        shutil.rmtree(workdir, ignore_errors=True)
    if len(results) != world:
        raise RuntimeError(f"{world - len(results)} ranks of "
                           f"{fn.__qualname__} returned nothing")
    return results
