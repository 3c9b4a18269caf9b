"""Runs the control of a cell's output check on the card and prints its
numbers: the plain reference put in the program's place, in the precision
below the one the configuration states (rows: int4 for int8, float8
e4m3 for bfloat16; the encoders in float8 e4m3 for bfloat16; BM25 and
the rank fusion in bfloat16 for float32), judged by the same comparison
and held to the same limits as a run's answers: it has to come out not
correct.

    python3 benchmark/control.py --workload <cell> --seed <n> [--seed <n> ...]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONTROL_STORAGE = {"int8": "int4", "bfloat16": "float8", "float32": "bfloat16"}


def control_run(cell_name: str, seed: int, device: str = "cuda",
                overrides=None, **find) -> tuple[bool, dict, list]:
    """The control's ``(correct, numbers, lines)``: its answers to the
    queries a run's sampler picks from the pool (``trace.Picker``), judged
    and held to the cell's limits as a run's are."""
    from benchmark import check, data, harness, registry, trace

    overrides = overrides or {}
    cell = registry.find_cell(cell_name, **find)
    cfg = harness._merge(cell.config, overrides.get("config"))
    traffic = harness._merge(cell.traffic, overrides.get("traffic"))
    limits = harness._merge(cell.limits, overrides.get("limits"))
    pool = data.query_pool(cfg, traffic, seed, device)
    picker = trace.Picker(traffic["check_sample"], seed)
    for q in pool:
        picker.offer(len(q.split()), lambda q=q: q)
    samples = [check.Sample(query=q) for q in picker.picked()]
    numbers = check.judge(samples, cfg, traffic, seed, device,
                          control={"storage": CONTROL_STORAGE[cfg["storage_dtype"]]})
    ok, lines, _ = check.verdict(numbers, limits, 0)
    return ok, {k: float(v) for k, v in numbers.items()}, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    for seed in args.seed:
        t0 = time.perf_counter()
        ok, numbers, lines = control_run(args.workload, seed)
        for line in lines:
            print(line, file=sys.stderr, flush=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": ok,
                          "control": numbers, "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
