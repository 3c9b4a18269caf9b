#!/usr/bin/env python3
"""Time block shapes of the IVF union kernel's f32 mode on one CUDA card.

    python3 scripts/tune_ivf_union.py

Makes the union call that ``scripts/ab_dense_topk.py --only ivf`` times
(seeded f32 tiles, 1,024 of 1,024 rows at D = 768; 32 queries, 16 probes
each drawn without repeats, scored against the batch's probe union) and
builds one throwaway library (under super_rag_tpu_torch/_build/) that
includes csrc/ivf_scan.cu and instantiates the union kernel's f32 mode at
every shape of SHAPES (RB rows a block, 32 queries, KSB bytes of a row a
stage, NST stages of the cp.async ring).  Each shape must give the port's
scores bit for bit (a block shape does not change a column's MMA order);
each is timed on CUDA events (median of 20, in two passes: forward, then
backward) beside the port's call, its query planes included.  Prints one
line per shape, the card's name and power limit, and a JSON line.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(128, 32, 64, 4), (128, 32, 128, 2), (128, 32, 128, 3), (128, 32, 128, 4),
          (128, 32, 256, 2), (256, 32, 64, 3), (256, 32, 64, 4), (256, 32, 128, 2),
          (64, 32, 128, 4), (64, 32, 256, 3)]
NLIST, CAP, D, B, NPROBE = 1024, 1024, 768, 32, 16

SOURCE = r'''
#include "ivf_scan.cu"
#define SHAPE(RB, QN, KSB, NST)                                                              \
  extern "C" int tune_##RB##_##QN##_##KSB##_##NST(                                           \
      const void* planes, const int* union_ids, const void* values, const int* row_ids,     \
      int B, int U, int C, int D, int nlist, float* out, void* stream) {                    \
    const utc::Scan a{planes, values, nullptr, nullptr, row_ids, nullptr, B, C, D, nlist, out}; \
    return utc::launch_union<float, utc::Cfg<float, RB, QN, KSB, NST>>(                     \
        a, union_ids, U, static_cast<cudaStream_t>(stream));                                 \
  }
'''


def build_shapes() -> ctypes.CDLL:
    from super_rag_tpu_torch import _build

    os.makedirs(_build.BUILD, exist_ok=True)
    src = os.path.join(_build.BUILD, "tune_ivf_union.cu")
    with open(src, "w") as f:
        f.write(SOURCE + "".join(f"SHAPE({', '.join(map(str, sh))})\n" for sh in SHAPES))
    out = os.path.join(_build.BUILD, "libtune_ivf_union.so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o", out, src],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    p, i = ctypes.c_void_p, ctypes.c_int
    for shape in SHAPES:
        fn = getattr(lib, "tune_" + "_".join(map(str, shape)))
        fn.argtypes = [p, p, p, p, i, i, i, i, i, p, p]
        fn.restype = i
    return lib


def event_ms(fn, reps: int = 20, warmup: int = 3) -> float:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("tune_ivf_union: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from super_rag_tpu_torch.ops import ivf_topk as it

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    lib = build_shapes()
    gen = torch.Generator(device="cuda").manual_seed(5)
    values = torch.randn(NLIST, CAP, D, device="cuda", generator=gen)
    row_ids = torch.arange(NLIST * CAP, device="cuda", dtype=torch.int32).view(NLIST, CAP)
    q = torch.randn(B, D, device="cuda", generator=gen)
    probes = torch.argsort(torch.rand(B, NLIST, device="cuda", generator=gen),
                           dim=1)[:, :NPROBE].to(torch.int32).contiguous()
    union = it.probe_union(probes, NLIST)
    n_union = union.numel()
    args = (q, union, values, None, None, row_ids, None)
    want = it.union_scores(*args)
    planes = torch.empty((2 * B, D), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    if it._lib().ivf_tf32_planes(q.data_ptr(), planes.data_ptr(), B * D, stream) != 0:
        raise RuntimeError("planes launch failed")
    runs = {}
    for shape in SHAPES:
        out = torch.empty_like(want)
        fn = getattr(lib, "tune_" + "_".join(map(str, shape)))

        def run(fn=fn, out=out, shape=shape):
            err = fn(planes.data_ptr(), union.data_ptr(), values.data_ptr(), row_ids.data_ptr(),
                     B, n_union, CAP, D, NLIST, out.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"{shape}: cudaError {err}")

        run()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"{shape} differs from the port's kernel")
        runs[shape] = run
    times = {key: [] for key in list(runs) + ["port"]}
    for order in (list(runs), list(reversed(runs))):
        times["port"].append(event_ms(lambda: it.union_scores(*args)))
        for key in order:
            times[key].append(event_ms(runs[key]))
    print(smi)
    print(f"union f32 at B={B}, U={n_union}, C={CAP}, D={D}; ms forward / backward pass")
    names = {shape: "RB={} QN={} KSB={} NST={}".format(*shape) for shape in runs}
    for shape in runs:
        print(f"{names[shape]}: {times[shape][0]:.4f} / {times[shape][1]:.4f} ms")
    print(f"port (with its planes kernel): {times['port'][0]:.4f} / {times['port'][1]:.4f} ms")
    print(json.dumps({"card": smi, "ms": {names[shape]: times[shape] for shape in runs}
                      | {"port": times["port"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
