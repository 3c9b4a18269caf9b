#!/usr/bin/env python3
"""Time variants of the dense_topk tensor-core kernels (``dense_topk_tc_kernel``, or ``dense_topk_tcs_kernel`` with ``VARIANT=tcs``) on one card.

    python3 scripts/tune_dense_topk.py VARIANTS.json

``VARIANTS.json`` maps a name to a list of ``[old, new]`` text substitutions
applied to ``super_rag_tpu_torch/csrc/dense_topk.cu`` (``[]``: the source as
it is), or to ``{"file": path, "subs": [...], "patch": {...}}`` for another
source file, with ``ops/dense_topk.py`` constants patched while that
variant runs (e.g. ``{"LIST_RC": 256}`` for a source with other boxes).
Every variant builds into ``super_rag_tpu_torch/_build/`` (one nvcc each,
all started together; ptxas's register counts, spills and "Potential
Performance Loss" notes printed).  The first variant is held bit for bit
against ``tile_topk_plain`` at small ragged shapes; then each shape (env
``SHAPES``, a JSON list of ``[rows, D, B, kt]``; default the main path's:
1M x 768 at B = 512, 1M x 256 at B = 32, 1M x 1,536 at B = 512, 10,002,432
x 768 at B = 512) times every variant twice in turns (CUDA events, median
of 10 after 3 warm-ups, and the kernel's own device time a launch from
torch.profiler over 20 calls) beside the sorted-selection kernel on the
same inputs.  ``VARIANT=tcs`` forces the sorted-selection kernel instead
(its variants of ``dense_topk_tcs_kernel`` then; the check and every
timing take it), and ``DTYPE=bf16`` times bf16 rows and queries instead
of int8 codes.  A variant that exports ``prof_read(unsigned long long* out, int
reset)`` (eight counters its kernel adds to: per consumer warp, cycles
waiting on a stage, issuing, in wgmma waits, in the epilogue, waiting on
row data, at the chunk's end, in all, and the warp count) is profiled once
a shape.  Prints the card's name and power limit.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
from unittest import mock

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAIN_SHAPES = [(1_000_000, 768, 512, 2), (1_000_000, 256, 32, 2), (1_000_000, 1536, 512, 2),
               (10_002_432, 768, 512, 2)]
# (B, rows, D, kt, tile, L2 norms): ragged B, D, tiles, masks, ties
CHECKS = [(17, 5000, 48, 2, 2048, False), (1, 5000, 16, 1, 2048, True),
          (130, 5000, 768, 8, 2048, False), (512, 5000, 1536, 2, 2048, False),
          (130, 5000, 4096, 5, 2048, True), (70, 5000, 96, 3, 200, False),
          (512, 300000, 256, 2, 2048, False)]
PROF_NAMES = ("wait full", "issue", "wait<1>", "epilogue", "row wait", "chunk end")


def build(variants: dict, build_dir: str, csrc: str, nvcc: list) -> dict:
    """name -> (library path, constants to patch); builds every variant."""
    src = open(os.path.join(csrc, "dense_topk.cu")).read()
    os.makedirs(build_dir, exist_ok=True)
    procs = {}
    for name, spec in variants.items():
        if isinstance(spec, dict):
            text = open(spec["file"]).read() if "file" in spec else src
            subs, patch = spec.get("subs", []), spec.get("patch", {})
        else:
            text, subs, patch = src, spec, {}
        for old, new in subs:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: substitution found {text.count(old)} times: {old[:80]!r}")
            text = text.replace(old, new)
        path = os.path.join(build_dir, f"tune_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        out = os.path.join(build_dir, f"libtune_{name}.so")
        procs[name] = (out, patch, subprocess.Popen(
            [*nvcc, "-I", csrc, "-o", out, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (out, patch, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log[-4000:]}")
        regs = re.findall(r"Compiling entry function '\S*tc_kernel\S*'.*?Used (\d+) registers",
                          log, re.S)
        spills = [ln.strip() for ln in log.splitlines() if "spill" in ln
                  and "0 bytes spill stores, 0 bytes spill loads" not in ln]
        print(f"{name}: tc kernels' registers {regs}, spills {spills[:2]}", flush=True)
        for ln in log.splitlines():
            if "Performance Loss" in ln:
                print(f"  {name}: {ln.strip()}", flush=True)
        built[name] = (out, patch)
    return built


def load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dense_topk_launch.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, i, p, p, p]
    lib.dense_topk_tc_map.argtypes = [p, p, ctypes.c_longlong, i, i, i]
    lib.dense_topk_tc_launch.argtypes = [p, p, p, p, p, i, i, p, i, i, i, i, i, i, i, p, p, p]
    lib.dense_topk_tcs_launch.argtypes = [i, p, p, p, p, p, p, p, p, p, p]
    for fn in (lib.dense_topk_launch, lib.dense_topk_tc_map, lib.dense_topk_tc_launch,
               lib.dense_topk_tcs_launch):
        fn.restype = i
    return lib


def event_ms(fn, reps: int = 10, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_us(fn, calls: int = 20) -> float:
    """Mean device microseconds a launch of the dense_topk kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if "dense_topk" in ev.key:
            total += getattr(ev, "device_time_total", None) or ev.cuda_time_total
            count += ev.count
    return total / count if count else float("nan")


def bf16_operands(b, n, d, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    values = torch.randn(n, d, device="cuda", generator=gen).to(torch.bfloat16)
    q = torch.randn(b, d, device="cuda", generator=gen).to(torch.bfloat16)
    return q, None, values, None, None, None


def int8_operands(b, n, d, seed, l2, extra=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    values = torch.randint(-127, 128, (n + extra, d), device="cuda", generator=gen,
                           dtype=torch.int8)
    values[64:96] = values[0:32]
    scales = torch.rand(n + extra, device="cuda", generator=gen) * 0.01 + 0.001
    scales[64:96] = scales[0:32]
    q = torch.randint(-127, 128, (b, d), device="cuda", generator=gen, dtype=torch.int8)
    qs = torch.rand(b, device="cuda", generator=gen) * 0.01 + 0.001
    mask = torch.rand(n + extra, device="cuda", generator=gen) < 0.7
    mask[2048:4096] = False
    norms = torch.rand(n + extra, device="cuda", generator=gen) if l2 else None
    return q, qs, values, scales, norms, mask


def main() -> int:
    if not torch.cuda.is_available():
        print("tune_dense_topk: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from super_rag_tpu_torch import _build
    from super_rag_tpu_torch.ops import dense_topk as dt

    with open(sys.argv[1]) as f:
        variants = json.load(f)
    shapes = [tuple(s) for s in json.loads(os.environ.get("SHAPES", "[]"))] or MAIN_SHAPES
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    built = build(variants, _build.BUILD, _build.CSRC, [_build.nvcc_path(), *_build.NVCC_FLAGS])
    libs = {name: (load(path), patch) for name, (path, patch) in built.items()}

    forced = os.environ.get("VARIANT", "tc")
    bf16 = os.environ.get("DTYPE") == "bf16"

    def using(name, variant=forced):
        lib, patch = libs[name]
        stack = contextlib.ExitStack()
        stack.enter_context(mock.patch.object(dt, "_lib", lambda: lib))
        stack.enter_context(mock.patch.object(dt, "kernel_variant", lambda *a, **kw: variant))
        if patch:
            stack.enter_context(mock.patch.multiple(dt, **patch))
        return stack

    first = next(iter(libs))
    for b, n, d, kt, tile, l2 in CHECKS:
        q, qs, values, scales, norms, mask = int8_operands(b, n, d, b + d, l2, extra=100)
        args = (q, qs, values, scales, norms, mask, n, tile, kt)
        with using(first):
            kv, ki = dt.tile_topk(*args)
        pv, pi = dt.tile_topk_plain(*args)
        torch.cuda.synchronize()
        if not (torch.equal(kv, pv) and torch.equal(ki, pi)):
            print(f"{first} differs from the plain version at B={b}, N={n}, D={d}, kt={kt}, "
                  f"tile={tile}", flush=True)
            return 1
    print(f"{first}: bit-equal to the plain version at {len(CHECKS)} shapes", flush=True)

    for n, d, b, kt in shapes:
        if bf16:
            q, qs, values, scales, _, _ = bf16_operands(b, n, d, 1)
        else:
            q, qs, values, scales, _, _ = int8_operands(b, n, d, 1, False)
        mask = torch.rand(n, device="cuda") < 0.99
        args = (q, qs, values, scales, None, mask, n, 2048, kt)
        times = []
        for _ in range(2):
            for name in libs:
                with using(name):
                    times.append((name, event_ms(lambda: dt.tile_topk(*args)),
                                  device_us(lambda: dt.tile_topk(*args))))
        if forced != "tcs":
            with using(first, "tcs"):
                times.append(("tcs", event_ms(lambda: dt.tile_topk(*args)),
                              device_us(lambda: dt.tile_topk(*args))))
        print(f"{n} x {d}, B={b}, kt={kt}{' bf16' if bf16 else ''}: " + ", ".join(
            f"{k} {v:.3f} ms (device {u:.1f} us)" for k, v, u in times) + f" ({card})",
            flush=True)
        for name, (lib, _) in libs.items():
            if not hasattr(lib, "prof_read"):
                continue
            counters = (ctypes.c_ulonglong * 8)()
            lib.prof_read(counters, 1)
            with using(name):
                dt.tile_topk(*args)
            lib.prof_read(counters, 1)
            total = counters[6] or 1
            print(f"  {name}: share of a consumer warp's cycles: "
                  + ", ".join(f"{k} {counters[i] / total:.3f}" for i, k in enumerate(PROF_NAMES))
                  + f"; {total / max(counters[7], 1):.0f} cycles a warp", flush=True)
        del q, qs, values, scales, mask
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
