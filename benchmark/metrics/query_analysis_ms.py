"""Milliseconds a dispatch in ``index.analyze`` (``DeviceIndex._query_arrays``:
each query's terms and idf weights in Python, and their copies to the
card)."""

from benchmark import program_trace
from benchmark.readers import Run


def read(run: Run):
    return program_trace.per_dispatch_ms(run, "index.analyze")
