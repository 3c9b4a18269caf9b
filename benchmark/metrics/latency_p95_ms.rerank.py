"""The 95th percentile of every request's latency in a cell whose answers
come back a dispatch at a time, each paced by the host: a per-layer
reading of the serving layer's tail there (same arithmetic as
``latency_p95_ms``)."""

from benchmark import arith
from benchmark.readers import Run, latencies_ms


def read(run: Run):
    lat = latencies_ms(run)
    return arith.percentile(lat, 95) if lat else None
