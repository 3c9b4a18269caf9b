#!/usr/bin/env python3
"""Time the port's dense_topk kernel at the main-path and served shapes,
for one checkout.

    python3 scripts/ab_dense_topk.py --root DIR [--only main|served|ivf]

Imports ``super_rag_tpu_torch`` from the checkout at ``DIR`` (default: this
one), builds its ``csrc/dense_topk.cu`` there, and times ``tile_topk`` on
seeded operands.  The main-path shapes (``--only main``): int8 codes x
int8 queries at per-tile cap 2 over the flat 1M x 768 search_hybrid at
B = 512, the 10,002,432-row CSR one, the reranked query batch behind the
encoder (1M x 256, B = 32) and the 1M x 1,536 wide corpus at B = 512; a
default (bf16) collection of 1M x 768 at B = 512 and at a served batch
of 64, cap 2, and the int8 1M x 768 at B = 512 with deep lists (kt 32),
the last three through the sorted-selection kernel; an f32 collection of
1M x 768 at B = 512 and 64, cap 2 (the sorted-selection kernel's TF32
mode).  The served shapes (``--only served``): the default bf16, int8
and f32 collections (16,384 rows of D = 256 at B = 64, kt 5 and 32; kt
129 in each mode, and f32 at kt 256 and 2,048 too: the deep selection,
search_dense(k > 128)'s exact per-tile depth),
an image search (256 rows, B = 1), a graph search (1,913 masked rows of
D = 128, kt 50), and the remote embeddings (8,224 rows of D = 1,536 and
3,072 at B = 1, kt 5 and 32).  Each shape: CUDA events around one call
(median of 50 after 3 warm-ups), the time a call in bursts of 50
(median of 5 bursts), the host's own time a call (the wall time of 50
calls issued with no sync between them, the least of 5 such bursts: the
launch path alone, whatever the kernel takes; 10 in place of each 50
where a call takes over 20 ms), the host cost of the
sorted-selection launch's plan (``_tcs_plan``) computed and from its
cache, where the checkout has one, the kernel's own device time a launch
(torch.profiler over 50 calls, the kernels whose names hold
``dense_topk`` or ``tf32_planes``, summed a call: the f32 mode's call is
two kernels, the query planes and the scan), the variant ``kernel_variant`` picks, the
card's name and power limit, and the call's bound (the larger of its
bytes, each input read once and the output written once, over 3.35 TB/s,
and its operations over 1,979 TOP/s in int8, 989 TFLOP/s in bf16, or, in
f32, three TF32 products over 495 TFLOP/s).  Prints a line per shape and
a JSON line.

``--only ivf`` times both IVF kernels at the smoke's [ivf] shapes
(1,024 tiles of 1,024 rows, D = 768, 16 probes a query) with int8, bf16
and f32 values: the union kernel at B = 32 and the per-query kernel at
B = 512 (both on the tensor cores; f32 as three TF32 products on the
queries' planes, whose kernel the device time counts), each beside its
plain version, a library call on the tiles gathered
beforehand (``matmul`` / ``bmm`` in the queries' type, TF32 off) and its
bound, with the launches each call made.  To compare two
checkouts on one card, run it in turns in one command: parent, change,
change, parent.  The host-bound times (one call, bursts, host) vary with
the host's load from minute to minute; ``--against DIR`` compares them
in one process instead: it imports the other checkout's package first
(renamed), then times the two in turns, 30 rounds a shape, and prints
each one's medians and its kernel's device time:

    python3 scripts/ab_dense_topk.py --only served --against PARENT_DIR

``--shape NAME`` times one shape alone; ``--yardsticks`` adds each shape's
plain-version time and, for float queries, the library call's (one
matmul, TF32 off, and a ``torch.topk`` a tile).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import timeit

import torch

# the main path's calls: (name, storage dtype, int8 queries, rows, D, B,
# kt, keep share); int8 codes and row scales are drawn directly (a 10M x
# 768 f32 draw would not fit beside them)
MAIN = [
    ("flat 1M", None, True, 1_000_000, 768, 512, 2, 0.99),
    ("csr 10M", None, True, 10_002_432, 768, 512, 2, 0.99),
    ("encoder 1M x 256", None, True, 1_000_000, 256, 32, 2, 0.99),
    ("wide 1M x 1536", None, True, 1_000_000, 1536, 512, 2, 1.0),
    ("bf16 1M B 512", torch.bfloat16, False, 1_000_000, 768, 512, 2, 0.99),
    ("bf16 1M B 64", torch.bfloat16, False, 1_000_000, 768, 64, 2, 0.99),
    ("int8 1M B 512 kt 32", None, True, 1_000_000, 768, 512, 32, 0.99),
    ("f32 1M B 512", torch.float32, False, 1_000_000, 768, 512, 2, 0.99),
    ("f32 1M B 64", torch.float32, False, 1_000_000, 768, 64, 2, 0.99),
]
# the served shapes: (name, storage dtype, int8 queries, rows, D, B, kt, keep share)
SHAPES = [
    ("bf16 kt 5", torch.bfloat16, False, 16384, 256, 64, 5, 0.99),
    ("bf16 kt 32", torch.bfloat16, False, 16384, 256, 64, 32, 0.99),
    ("int8 kt 5", torch.int8, True, 16384, 256, 64, 5, 0.99),
    ("int8 kt 32", torch.int8, True, 16384, 256, 64, 32, 0.99),
    ("f32 kt 5", torch.float32, False, 16384, 256, 64, 5, 0.99),
    ("f32 kt 32", torch.float32, False, 16384, 256, 64, 32, 0.99),
    ("f32 kt 129", torch.float32, False, 16384, 256, 64, 129, 0.99),
    ("f32 kt 256", torch.float32, False, 16384, 256, 64, 256, 0.99),
    ("f32 kt 2048", torch.float32, False, 16384, 256, 64, 2048, 0.99),
    ("bf16 kt 129", torch.bfloat16, False, 16384, 256, 64, 129, 0.99),
    ("int8 kt 129", torch.int8, True, 16384, 256, 64, 129, 0.99),
    ("image", torch.bfloat16, False, 256, 256, 1, 5, 1.0),
    ("graph", torch.bfloat16, False, 1913, 128, 1, 50, 0.7),
    ("remote kt 5", torch.bfloat16, False, 8224, 1536, 1, 5, 1.0),
    ("remote kt 32", torch.bfloat16, False, 8224, 1536, 1, 32, 1.0),
    ("remote 3072 kt 5", torch.bfloat16, False, 8224, 3072, 1, 5, 1.0),
    ("remote 3072 kt 32", torch.bfloat16, False, 8224, 3072, 1, 32, 1.0),
]
TILE = 2048
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 495e12  # f32: three TF32 products a multiply-add


def bound_ms(args) -> tuple[float, str]:
    """The least time the card could take for one tile_topk call: its
    bytes (each input read once, the output written once) over the HBM
    rate, or its operations over the tensor cores' peak for the type."""
    q, qs, values, scales, norms, keep, n, tile, kt = args
    b, d = q.shape
    tiles = -(-n // tile)
    nbytes = (n * d * values.element_size() + (n * 4 if scales is not None else 0) + n
              + b * d * q.element_size() + (b * 4 if qs is not None else 0)
              + tiles * b * kt * 8)
    ops = 2.0 * b * n * d / (INT8_OPS_PER_S if q.dtype == torch.int8 else
                             TF32_OPS_PER_S / 3 if q.dtype == torch.float32 else BF16_OPS_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (t_bytes * 1e3, "bytes") if t_bytes >= ops else (ops * 1e3, "operations")


def library_topk(args):
    """Yardstick only: one matmul in the queries' type (float: TF32 off;
    int8: ``torch._int_mm``, cuBLASLt's int8 GEMM, then the scales) and a
    ``torch.topk`` a tile, over whole tiles, with the mask applied."""
    q, qs, values, scales, _, keep, n, tile, kt = args
    tiles = -(-n // tile)
    if q.dtype == torch.int8:
        s = torch._int_mm(q, values[:n].T).to(torch.float32) * qs[:, None] * scales[None, :n]
    else:
        s = torch.matmul(q, values[:n].to(q.dtype).T).to(torch.float32)
    s = torch.where(keep[None, :n], s, float("-inf"))
    s = torch.nn.functional.pad(s, (0, tiles * tile - n), value=float("-inf"))
    return torch.topk(s.view(q.shape[0], tiles, tile), kt, dim=-1)


def event_ms(fn, reps: int = 50, warmup: int = 3) -> float:
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


def host_us(fn, calls: int = 50, reps: int = 5) -> float:
    """Host microseconds a call: ``calls`` calls issued with no sync between
    them (the launch queue holds them all), the least of ``reps`` bursts."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return best


def device_us(fn, calls: int = 50, match: tuple = ("dense_topk", "tf32_planes")) -> float:
    """Mean device microseconds a call of the kernels whose names hold one
    of ``match`` (all of a call's launches summed: an f32 call's query
    planes kernel too)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if any(m in ev.key for m in match):
            total += getattr(ev, "device_time_total", None) or ev.cuda_time_total
            count += ev.count
    return total / calls if count else float("nan")


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


def load_other(root: str, alias: str = "ab_other"):
    """Import ``super_rag_tpu_torch`` from the checkout at ``root``, build and
    load its dense_topk library, then rename its modules to ``alias`` so
    that this checkout's package can be imported beside it.  Returns its
    ``ops.dense_topk`` module."""
    sys.path.insert(0, root)
    from super_rag_tpu_torch import _build
    from super_rag_tpu_torch.ops import dense_topk as other

    _build.build(["dense_topk"])
    other._lib()  # loaded while the package's name still points at root
    for key in [k for k in sys.modules
                if k == "super_rag_tpu_torch" or k.startswith("super_rag_tpu_torch.")]:
        sys.modules[alias + key[len("super_rag_tpu_torch"):]] = sys.modules.pop(key)
    sys.path.remove(root)
    return other


def paired(fns, rounds: int = 30) -> list[dict]:
    """The one-call ms, the ms a call in bursts of 20 and the host µs a call
    (20 calls, no sync) of each function, the median of ``rounds`` rounds
    that take the functions in turn (the order reversed every other round),
    so that each sees the same host."""
    res = [{"ms": [], "burst_ms": [], "host_us": []} for _ in fns]
    for f in fns:
        f()
    torch.cuda.synchronize()
    for r in range(rounds):
        order = list(zip(fns, res))
        for f, got in (order if r % 2 == 0 else order[::-1]):
            got["ms"].append(event_ms(f, reps=5, warmup=1))
            got["burst_ms"].append(burst_ms(f, calls=20, reps=1))
            got["host_us"].append(host_us(f, calls=20, reps=1))
    return [{k: statistics.median(v) for k, v in got.items()} for got in res]


IVF_NLIST, IVF_CAP, IVF_D, IVF_NPROBE = 1024, 1024, 768, 16


def ivf_rows(card: str) -> dict:
    """Both IVF kernels at the [ivf] shapes with int8, bf16 and f32 values:
    seeded tiles, each query's 16 probes drawn without repeats; the union
    kernel at B = 32 over the batch's probe union, the per-query kernel at
    B = 512.  The launches are counted over every counter the checkout has
    (a parent's SIMT per-query counter too)."""
    from super_rag_tpu_torch.ops import ivf_topk as it

    torch.backends.cuda.matmul.allow_tf32 = False
    rows = {}
    for dtype, tag in ((torch.int8, "int8"), (torch.bfloat16, "bf16"), (torch.float32, "f32")):
        gen = torch.Generator(device="cuda").manual_seed(5)
        x = torch.randn(IVF_NLIST, IVF_CAP, IVF_D, device="cuda", generator=gen)
        if dtype == torch.int8:
            values = torch.clamp(torch.round(x * 40), -127, 127).to(torch.int8)
            scales = torch.rand(IVF_NLIST, IVF_CAP, device="cuda", generator=gen) * 0.01
        else:
            values, scales = x.to(dtype), None
        del x
        qdt = torch.float32 if dtype == torch.float32 else torch.bfloat16
        row_ids = torch.arange(IVF_NLIST * IVF_CAP, device="cuda", dtype=torch.int32).view(
            IVF_NLIST, IVF_CAP)
        for route, b in (("union", 32), ("probe", 512)):
            name = f"ivf {route} {tag}, B {b}"
            q = torch.randn(b, IVF_D, device="cuda", generator=gen).to(qdt)
            probes = torch.argsort(torch.rand(b, IVF_NLIST, device="cuda", generator=gen),
                                   dim=1)[:, :IVF_NPROBE].to(torch.int32).contiguous()
            if route == "union":
                ids = it.probe_union(probes, IVF_NLIST)
                fn, plain = it.union_scores, it.union_scores_plain
                gathered = values[ids.long()].reshape(-1, IVF_D).to(qdt)
                lib = lambda: torch.matmul(q, gathered.T)  # noqa: E731
                tiles = ids.numel()
                work = b * tiles * IVF_CAP
            else:
                ids = probes
                fn, plain = it.probe_scores, it.probe_scores_plain
                gathered = values[probes.long()].reshape(b, -1, IVF_D).to(qdt)
                lib = lambda: torch.bmm(gathered, q[:, :, None])  # noqa: E731
                tiles = int(torch.unique(probes).numel())
                work = b * IVF_NPROBE * IVF_CAP
            counters = [getattr(it, c) for c in dir(it)
                        if c.startswith(route) and c.endswith("_launches")]
            args = (q, ids, values, scales, None, row_ids, None)
            before = sum(c.count for c in counters)
            got = fn(*args)
            launches = sum(c.count for c in counters) - before
            ref = plain(*args)
            fin = torch.isfinite(ref)
            err = float((got - ref)[fin].abs().max())
            tol = IVF_D * 2.0 ** -23 * (float(ref[fin].abs().max()) + 1.0)
            nbytes = (tiles * IVF_CAP * (IVF_D * values.element_size() + 4
                                         + (4 if scales is not None else 0))
                      + b * IVF_D * q.element_size() + got.numel() * 4)
            rate = TF32_OPS_PER_S / 3 if dtype == torch.float32 else BF16_OPS_PER_S
            ops = 2.0 * work * IVF_D
            row = {"launches": launches, "max_abs_err": err, "tol": tol,
                   "ms": event_ms(lambda: fn(*args), reps=20),
                   "kernel_us": device_us(lambda: fn(*args), calls=20,
                                          match=("ivf", "tf32_planes")),
                   "plain_ms": event_ms(lambda: plain(*args), reps=5, warmup=1),
                   "library_ms": event_ms(lib, reps=10),
                   "bound_ms": max(nbytes / HBM_BYTES_PER_S, ops / rate) * 1e3,
                   "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / rate
                   else "operations"}
            if err > tol or launches != 1:
                raise AssertionError(f"{name}: max |diff| {err} (tolerance {tol}), "
                                     f"{launches} launches")
            rows[name] = row
            print(f"{name} [{tiles} tiles of {IVF_CAP} rows, D={IVF_D}]: {row['ms']:.4f} ms "
                  f"(kernel {row['kernel_us']:.1f} us), plain {row['plain_ms']:.3f} ms, "
                  f"library {row['library_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']}), {launches} launch, max |diff| {err:.3g} within "
                  f"{tol:.3g} ({card})", flush=True)
            del gathered, got, ref
            torch.cuda.empty_cache()
        del values, scales
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--only", choices=("main", "served", "ivf"), default=None)
    ap.add_argument("--shape", default=None, help="time only the shape of this name")
    ap.add_argument("--yardsticks", action="store_true",
                    help="also time the plain version and, for float queries, the library call")
    ap.add_argument("--against", default=None,
                    help="another checkout, timed in the same process in turns with --root")
    opts = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    root = os.path.abspath(opts.root)
    if not torch.cuda.is_available():
        print("ab_dense_topk: no CUDA device", file=sys.stderr)
        return 2
    other = load_other(os.path.abspath(opts.against)) if opts.against else None
    sys.path.insert(0, root)
    from super_rag_tpu_torch import _build
    from super_rag_tpu_torch.ops import dense_topk as dt
    from super_rag_tpu_torch.ops.dense import DenseCorpus, build_corpus

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    _build.build(["dense_topk"])
    out = {"root": root, "card": card, "shapes": {}}
    if opts.only == "ivf":
        out["shapes"] = ivf_rows(card)
        print(json.dumps(out), flush=True)
        return 0
    todo = [] if opts.only == "served" else list(MAIN)
    todo += [] if opts.only == "main" else SHAPES
    if opts.shape is not None:
        todo = [s for s in todo if s[0] == opts.shape]
    for name, dtype, i8q, n, d, b, kt, share in todo:
        args = operands(n, d, b, kt, share, dt, build_corpus, DenseCorpus, dtype, i8q)
        q, values = args[0], args[2]
        variant = dt.kernel_variant(dt._mode(q, values), kt, d, b, -(-n // TILE),
                                    dt._sm_count(torch.cuda.current_device()))
        bound, bound_by = bound_ms(args)
        if other is not None:
            mods = {opts.against: other, root: dt}
            times = paired([lambda m=m: m.tile_topk(*args) for m in mods.values()])
            out["shapes"][name] = {}
            for (which, m), row in zip(mods.items(), times):
                row["kernel_us"] = device_us(lambda: m.tile_topk(*args))
                out["shapes"][name][which] = row
                print(f"{name} [{n} rows, D={d}, B={b}, kt={kt}]: {variant} {row['ms']:.4f} ms "
                      f"a call, {row['burst_ms']:.4f} ms in bursts, host {row['host_us']:.2f} "
                      f"us, the kernel {row['kernel_us']:.2f} us, bound {bound:.4f} ms "
                      f"({which}; {card})", flush=True)
            del args, q, values
            torch.cuda.empty_cache()
            continue
        # a call of tens of ms takes a fifth of the repetitions
        calls = 10 if event_ms(lambda: dt.tile_topk(*args), reps=1, warmup=1) > 20 else 50
        row = {"variant": variant,
               "ms": event_ms(lambda: dt.tile_topk(*args), reps=calls),
               "burst_ms": burst_ms(lambda: dt.tile_topk(*args), calls=calls),
               "host_us": host_us(lambda: dt.tile_topk(*args), calls=calls),
               "kernel_us": device_us(lambda: dt.tile_topk(*args), calls=calls),
               "bound_ms": bound, "bound_by": bound_by}
        if opts.yardsticks:
            row["plain_ms"] = event_ms(lambda: dt.tile_topk_plain(*args), reps=10)
            row["library_ms"] = event_ms(lambda: library_topk(args), reps=10)
        plan = getattr(dt, "_tcs_plan", None)
        if plan is not None and variant == "tcs":
            # the launch plan's host cost: computed (as each call would
            # without its cache) against a cache hit
            key = (q.dtype, values.dtype, b, n, d, TILE, kt, dt._sm_count(0))
            row["plan_us"] = [min(timeit.repeat(lambda: f(*key), number=2000, repeat=5))
                              / 2000 * 1e6 for f in (plan.__wrapped__, plan)]
        out["shapes"][name] = row
        print(f"{name} [{n} rows, D={d}, B={b}, kt={kt}]: {variant} {row['ms']:.4f} ms, "
              f"{row['burst_ms']:.4f} ms a call in bursts, host {row['host_us']:.2f} us a call, "
              f"the kernel {row['kernel_us']:.2f} us, "
              f"bound {bound:.4f} ms ({bound_by})"
              + "".join(f", {k[:-3]} {row[k]:.4f} ms" for k in ("plain_ms", "library_ms")
                        if k in row)
              + (" plan {:.2f} / {:.2f} us computed / cached".format(*row["plan_us"])
                 if "plan_us" in row else "") + f" ({root}; {card})", flush=True)
        del args, q, values
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
