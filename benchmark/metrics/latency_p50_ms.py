"""Median, over every request sent in the window, of the time from send
to answer; one that never answered counts as missing (infinite)."""

from benchmark import arith
from benchmark.readers import Run, latencies_ms


def read(run: Run):
    lat = latencies_ms(run)
    return arith.percentile(lat, 50) if lat else None
