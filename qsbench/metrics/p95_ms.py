"""p95_ms: the 95th percentile of the latency of every query completed in
the window, from `execute` called to its rows returned (the inclusive
method of statistics.quantiles)."""

import statistics


def read(run):
    lat = run.latencies_ms()
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[18]
