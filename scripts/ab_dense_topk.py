#!/usr/bin/env python3
"""Time the port's dense_topk kernel at the main-path and served shapes,
for one checkout.

    python3 scripts/ab_dense_topk.py --root DIR [--only main|served]

Imports ``super_rag_tpu_torch`` from the checkout at ``DIR`` (default: this
one), builds its ``csrc/dense_topk.cu`` there, and times ``tile_topk`` on
seeded operands.  The main-path shapes (``--only main``): int8 codes x
int8 queries at per-tile cap 2 over the flat 1M x 768 search_hybrid at
B = 512, the 10,002,432-row CSR one, the reranked query batch behind the
encoder (1M x 256, B = 32) and the 1M x 1,536 wide corpus at B = 512.  The
served shapes (``--only served``): the default bf16 and int8 collections
(16,384 rows of D = 256 at B = 64, kt 5 and 32), an image search (256
rows, B = 1), a graph search (1,913 masked rows of D = 128, kt 50), and
the remote embeddings (8,224 rows of D = 1,536 and 3,072 at B = 1, kt 5
and 32).  Each shape: CUDA events around one call
(median of 20 after 3 warm-ups) and the time a call in bursts of 50
(median of 5 bursts), the kernel's own device time a launch
(torch.profiler over 50 calls, the kernels whose names hold
``dense_topk``), the variant ``kernel_variant`` picks, the card's name and
power limit.  Prints a line per shape and a JSON line.  To compare two
checkouts on one card, run it in turns in one command: parent, change,
change, parent.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

# the main path's int8 x int8 calls: (name, rows, D, B, kt, keep share);
# codes and row scales are drawn directly (a 10M x 768 f32 draw would not
# fit beside them)
MAIN = [
    ("flat 1M", 1_000_000, 768, 512, 2, 0.99),
    ("csr 10M", 10_002_432, 768, 512, 2, 0.99),
    ("encoder 1M x 256", 1_000_000, 256, 32, 2, 0.99),
    ("wide 1M x 1536", 1_000_000, 1536, 512, 2, 1.0),
]
# the served shapes: (name, storage dtype, int8 queries, rows, D, B, kt, keep share)
SHAPES = [
    ("bf16 kt 5", torch.bfloat16, False, 16384, 256, 64, 5, 0.99),
    ("bf16 kt 32", torch.bfloat16, False, 16384, 256, 64, 32, 0.99),
    ("int8 kt 5", torch.int8, True, 16384, 256, 64, 5, 0.99),
    ("int8 kt 32", torch.int8, True, 16384, 256, 64, 32, 0.99),
    ("image", torch.bfloat16, False, 256, 256, 1, 5, 1.0),
    ("graph", torch.bfloat16, False, 1913, 128, 1, 50, 0.7),
    ("remote kt 5", torch.bfloat16, False, 8224, 1536, 1, 5, 1.0),
    ("remote kt 32", torch.bfloat16, False, 8224, 1536, 1, 32, 1.0),
    ("remote 3072 kt 5", torch.bfloat16, False, 8224, 3072, 1, 5, 1.0),
    ("remote 3072 kt 32", torch.bfloat16, False, 8224, 3072, 1, 32, 1.0),
]
TILE = 2048


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


def burst_ms(fn, calls: int = 50, reps: int = 5) -> float:
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def device_us(fn, calls: int = 50) -> float:
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


def operands(n, d, b, kt, share, dt, build_corpus, DenseCorpus, dtype=None, i8q=True):
    """Seeded operands of one shape on the card: ``tile_topk``'s arguments."""
    gen = torch.Generator(device="cuda").manual_seed(n + d + b + kt)
    if dtype is None:
        corpus = DenseCorpus(
            values=torch.randint(-127, 128, (n, d), device="cuda", generator=gen,
                                 dtype=torch.int8),
            scales=torch.rand(n, device="cuda", generator=gen) * 0.01 + 0.001)
    else:
        corpus = build_corpus(torch.randn(n, d, device="cuda", generator=gen), dtype=dtype)
    keep = torch.rand(n, device="cuda", generator=gen) < share
    q, qs, _, _ = dt.prepare(torch.randn(b, d, device="cuda", generator=gen), corpus, kt,
                             tile=TILE, int8_queries=i8q, per_tile_k=kt)
    return (q, qs, corpus.values, corpus.scales, None, keep, n, TILE, kt)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--only", choices=("main", "served"), default=None)
    opts = ap.parse_args()
    root = os.path.abspath(opts.root)
    if not torch.cuda.is_available():
        print("ab_dense_topk: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    from super_rag_tpu_torch import _build
    from super_rag_tpu_torch.ops import dense_topk as dt
    from super_rag_tpu_torch.ops.dense import DenseCorpus, build_corpus

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    _build.build(["dense_topk"])
    out = {"root": root, "card": card, "shapes": {}}
    todo = [] if opts.only == "served" else [(m[0], None, True, *m[1:]) for m in MAIN]
    todo += [] if opts.only == "main" else SHAPES
    for name, dtype, i8q, n, d, b, kt, share in todo:
        args = operands(n, d, b, kt, share, dt, build_corpus, DenseCorpus, dtype, i8q)
        q, values = args[0], args[2]
        variant = dt.kernel_variant(dt._mode(q, values), kt, d, b, -(-n // TILE),
                                    dt._sm_count(torch.cuda.current_device()))
        row = {"variant": variant, "ms": event_ms(lambda: dt.tile_topk(*args)),
               "burst_ms": burst_ms(lambda: dt.tile_topk(*args)),
               "kernel_us": device_us(lambda: dt.tile_topk(*args))}
        out["shapes"][name] = row
        print(f"{name} [{n} rows, D={d}, B={b}, kt={kt}]: {variant} {row['ms']:.4f} ms, "
              f"{row['burst_ms']:.4f} ms a call in bursts, the kernel {row['kernel_us']:.2f} us "
              f"({root}; {card})", flush=True)
        del args, q, values
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
