"""Milliseconds a request waits in the batcher's queue, from its enqueue in
``QueryBatcher.search`` to the start of the dispatch that serves it: the
``wait_sum_s`` over the ``queries`` of the ``batcher.dispatch`` stages
that start in the window."""

from benchmark import program_trace
from benchmark.readers import Run


def read(run: Run):
    recs = program_trace.records(run)
    if not recs:
        return None
    attrs = [dict(d.attrs) for d in program_trace.dispatches(recs, run)]
    n = sum(a.get("queries", 0) for a in attrs)
    return 1e3 * sum(a.get("wait_sum_s", 0.0) for a in attrs) / n if n else None
