"""Share of the traced window in which no operation ran on the card, %."""

from benchmark.readers import Run, busy_s


def read(run: Run):
    busy = busy_s(run)
    return None if busy is None else 100.0 * (1.0 - busy / run.seconds)
