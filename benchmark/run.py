"""Runs one cell of the benchmark once and prints its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is found by name in ``BENCHMARK.json`` (see ``registry.py``).
The last line of standard output is the result's JSON object; the
output check's numbers, each beside its limit, are the last lines of
standard error.  Exits 2 without a result where the card or the cards
the cell asks for are missing.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness, registry

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    cell = registry.find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    log(harness.card_line())
    result, lines = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                                T_START, log=log)
    found = harness.forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {', '.join(found)}")
        return 3
    for line in lines:
        log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
