"""What the readers of the program's own spans share: the stage records of
the port's tracer (``Tracer.stages`` of ``super_rag_tpu_torch``'s
``get_tracer()``, which a ``torch.profiler`` capture turns on, so the
``--trace 1`` run records them) for a run's window, grouped by dispatch,
and laid over the device trace's kernels.  Both are on the host's
``perf_counter`` seconds.  Where the program records no stages (on the
CPU, or in a program without them) every reader gives None.

The stages of one dispatch share its trace id, the span id of its
``batcher.dispatch`` record.  The leaves are the stages with no stage
inside them: where the worker is in none of them, no collection is
running and the card is idle, the tracing does not cover what the host
is doing (``idle_unattributed``).
"""

from __future__ import annotations

from typing import Optional

from benchmark import trace
from benchmark.readers import Run

LEAVES = frozenset({"embed.tokenize", "embed.forward", "index.analyze", "index.dense",
                    "index.lexical", "index.rescore", "index.rrf", "engine.copy",
                    "engine.hits"})
# a record that starts this long before the window may still be open in it
SLACK_S = 60.0


def fetch(t_from: float, t_to: float) -> Optional[list]:
    """The program's stage records that start in ``[t_from, t_to)``, or
    None where its tracer keeps none."""
    from super_rag_tpu_torch.trace.tracing import get_tracer

    tracer = get_tracer()
    if not hasattr(tracer, "stages"):
        return None
    return tracer.stages(t_from, t_to) or None


def records(run: Run) -> Optional[list]:
    return fetch(run.window[0] - SLACK_S, run.window[1])


def dispatches(recs: list, run: Run, whole: bool = False) -> list:
    """The ``batcher.dispatch`` records that start in the window (``whole``:
    that also end in it, so the device trace holds all of their work)."""
    ws, we = run.window
    return [r for r in recs if r.name == "batcher.dispatch" and ws <= r.t0 < we
            and (not whole or r.t1 <= we)]


def of_dispatches(recs: list, ds: list, name: str) -> list:
    ids = {d.span_id for d in ds}
    return [r for r in recs if r.name == name and r.trace_id in ids]


def per_dispatch_ms(run: Run, name: str) -> Optional[float]:
    """Milliseconds a dispatch in the stage ``name``."""
    recs = records(run)
    ds = dispatches(recs, run) if recs else []
    found = of_dispatches(recs, ds, name) if ds else []
    if not found:
        return None
    return 1e3 * sum(r.t1 - r.t0 for r in found) / len(ds)


def union(intervals) -> list:
    """``(start, end)`` intervals merged and ordered."""
    return trace.busy_intervals([(None, s, t) for s, t in intervals if t > s])


def overlap_s(a: list, b: list) -> float:
    """Seconds that two merged, ordered interval lists share."""
    out, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def clip(intervals: list, window: tuple) -> list:
    ws, we = window
    return [(max(s, ws), min(t, we)) for s, t in intervals if t > ws and s < we]


def gc_intervals(recs: list, window: tuple) -> list:
    return union(clip([(r.t0, r.t1) for r in recs if r.name == "runtime.gc"], window))


def idle_intervals(run: Run) -> Optional[list]:
    """The window's stretches in which no operation runs on the card."""
    if run.device is None or not run.device.kernels:
        return None
    return trace.idle_gaps(trace.busy_intervals(run.device.kernels), run.window)
