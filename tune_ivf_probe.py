#!/usr/bin/env python3
"""Time block shapes of the port's tensor-core per-query IVF kernel on one
CUDA card.

    python3 tune_ivf_probe.py

Makes the IVF index that chip_smoke.py serves (its clustered 1M x 768 int8
corpus from the same seed, compact_dense(nlist 1024, nprobe 16)) and
records the per-query kernel's operands from search_dense at batch 512.
It then builds one throwaway library (under super_rag_tpu_torch/_build/)
that includes csrc/ivf_scan.cu and instantiates the kernel at every
shape of SHAPES (RB rows and QG pairs a block, KSB bytes of a row a
stage, NST stages of the cp.async ring), and times each on those
operands with its own work list (CUDA events, median of 20, in two passes:
forward, then backward), beside the kernel the port runs.  Each shape must
give the port's scores bit for bit: a block shape does not change a
column's MMA order.  Prints one line per shape, the card's name and power
limit, and a JSON line.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from unittest import mock

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPES = ([(rb, qg, 64, 4) for rb in (128, 256) for qg in (8, 16, 32)]
          + [(128, 16, 64, 3), (128, 16, 64, 6), (128, 16, 128, 3), (128, 16, 128, 4)])

SOURCE = r'''
#include "ivf_scan.cu"
#define SHAPE(RB, QG, KSB, NST)                                                             \
  extern "C" int tune_##RB##_##QG##_##KSB##_##NST(                                          \
      const void* q, const int* order, const int* pair_off, const int* group_off,           \
      int max_groups, const void* values, const float* scales, const float* cs,             \
      const int* row_ids, const uint8_t* mask, int B, int nprobe, int C, int D, int nlist,  \
      float* out, void* stream) {                                                           \
    const utc::Scan a{static_cast<const __nv_bfloat16*>(q), values, scales, cs, row_ids,    \
                      mask, B, C, D, nlist, out};                                           \
    return utc::launch_groups<int8_t, utc::Cfg<int8_t, RB, QG, KSB, NST>>(                  \
        a, order, pair_off, group_off, nprobe, max_groups, static_cast<cudaStream_t>(stream)); \
  }
'''


def build_shapes() -> ctypes.CDLL:
    from super_rag_tpu_torch import _build

    os.makedirs(_build.BUILD, exist_ok=True)
    src = os.path.join(_build.BUILD, "tune_ivf_probe.cu")
    with open(src, "w") as f:
        f.write(SOURCE + "".join(f"SHAPE({', '.join(map(str, sh))})\n" for sh in SHAPES))
    out = os.path.join(_build.BUILD, "libtune_ivf_probe.so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o", out, src],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    p, i = ctypes.c_void_p, ctypes.c_int
    for shape in SHAPES:
        fn = getattr(lib, "tune_" + "_".join(map(str, shape)))
        fn.argtypes = [p, p, p, p, i, p, p, p, p, p, i, i, i, i, i, p, p]
        fn.restype = i
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("tune_ivf_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from super_rag_tpu_torch.engine.index import DeviceIndex
    from super_rag_tpu_torch.ops import ivf_topk as it

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    lib = build_shapes()

    # chip_smoke.phase_ivf's index and B = 512 queries, drawn in its order
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 1)
    centers = torch.randn(cs.IVF_CENTERS, cs.DIM, device="cuda", generator=gen) * 3.0
    arrays, host, _, _ = cs.make_corpus(cs.N_ROWS, gen, centers=centers)
    idx = DeviceIndex.from_snapshot(arrays, host, device="cuda")
    del arrays
    idx.compact_dense(nlist=cs.IVF_NLIST, nprobe=cs.IVF_NPROBE)
    qa = centers[torch.randint(0, cs.IVF_CENTERS, (cs.IVF_DENSE_BATCH,), device="cuda",
                               generator=gen)]
    qa = qa + torch.randn(cs.IVF_DENSE_BATCH, cs.DIM, device="cuda", generator=gen)
    calls: dict = {}
    with mock.patch.object(it, "probe_scores",
                           cs._recording(calls, "probe", it.probe_scores)):
        idx.search_dense(qa, k=cs.TOP_K)
    q, probes, values, scales, cs_in, row_ids, mask = calls["probe"]
    b, nprobe = probes.shape
    nlist, cap, d = values.shape
    want = it.probe_scores(*calls["probe"])
    stream = torch.cuda.current_stream().cuda_stream
    mptr = None if mask is None else mask.view(torch.uint8).data_ptr()

    runs = {}
    for shape in SHAPES:
        groups = it.probe_groups(probes, nlist, shape[1])
        out = torch.empty_like(want)
        fn = getattr(lib, "tune_" + "_".join(map(str, shape)))

        def run(fn=fn, groups=groups, out=out, shape=shape):
            err = fn(q.data_ptr(), groups.order.data_ptr(), groups.pair_off.data_ptr(),
                     groups.group_off.data_ptr(), groups.max_groups, values.data_ptr(),
                     scales.data_ptr(), None if cs_in is None else cs_in.data_ptr(),
                     row_ids.data_ptr(), mptr, b, nprobe, cap, d, nlist, out.data_ptr(),
                     stream)
            if err != 0:
                raise RuntimeError(f"{shape}: cudaError {err}")

        run()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"{shape} differs from the port's kernel")
        runs[shape] = (run, int(groups.group_off[-1]))
    groups = it.probe_groups(probes, nlist, it.PROBE_QG)
    out = torch.empty_like(want)
    port = (lambda: it._probe_tc(it.MODES[values.dtype], q, groups, nprobe, values, scales,
                                 cs_in, row_ids, mask, out))
    times = {key: [] for key in list(runs) + ["port"]}
    for order in (list(runs), list(reversed(runs))):
        times["port"].append(cs.cuda_ms(port))
        for key in order:
            times[key].append(cs.cuda_ms(runs[key][0]))
    print(smi)
    print(f"per-query kernel at B={b}, nprobe={nprobe}, C={cap}, D={d}, "
          f"{int(torch.unique(probes).numel())} distinct tiles; ms forward / backward pass")
    names = {shape: "RB={} QG={} KSB={} NST={}".format(*shape) for shape in runs}
    for shape, (_, n_groups) in runs.items():
        fwd, bwd = times[shape]
        print(f"{names[shape]}: {fwd:.3f} / {bwd:.3f} ms ({n_groups} groups)")
    print(f"port (QG={it.PROBE_QG}): {times['port'][0]:.3f} / {times['port'][1]:.3f} ms")
    print(json.dumps({"card": smi, "ms": {names[shape]: times[shape] for shape in runs}
                      | {"port": times["port"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
