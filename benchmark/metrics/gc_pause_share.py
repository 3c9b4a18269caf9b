"""Share of the window the interpreter spent in full (generation 2)
garbage collections, %: every thread waits on them, the batcher's worker
and the clients alike (the host runtime under the serving layer)."""

from benchmark.readers import Run


def read(run: Run):
    ws, we = run.window
    paused = sum(max(0.0, min(s + t, we) - max(s, ws)) for s, t in run.gc_pauses)
    return 100.0 * paused / run.seconds
