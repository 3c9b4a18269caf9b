"""Queries answered in the window, over the window's seconds: each
dispatch's queries count in the share of its run (from its start to its
answers) that lies inside the window, so that a batch answered across the
window's edge counts for the part of its work done inside it, and a cell
whose answers come 32 at a time reads no step of a whole dispatch."""

from benchmark.readers import Run


def read(run: Run):
    ws, we = run.window
    done = 0.0
    for d in run.dispatches:
        inside = min(d.t1, we) - max(d.t0, ws)
        if inside > 0:
            done += d.size * inside / max(d.t1 - d.t0, 1e-9)
    return done / run.seconds
