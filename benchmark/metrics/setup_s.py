"""Process start to the first timed request: imports, the extension
load (and its build in a fresh checkout), data, weights, index,
warm-up and the ramp of the load."""

from benchmark.readers import Run


def read(run: Run):
    return run.setup_s
