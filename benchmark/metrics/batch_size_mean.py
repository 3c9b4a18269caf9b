"""Queries a dispatch of the QueryBatcher in the window: the change of its
own ``queries`` counter over the change of its ``dispatches`` counter."""

from benchmark.readers import Run


def read(run: Run):
    d = run.counters["dispatches"][1] - run.counters["dispatches"][0]
    q = run.counters["queries"][1] - run.counters["queries"][0]
    return q / d if d else None
