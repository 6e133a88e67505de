"""geomean_ms: the geometric mean of the latency of every query completed
in the window (TPC-H's power metric rests on it: each template weighs
alike)."""

import math


def read(run):
    lat = run.latencies_ms()
    if not lat:
        return None
    return math.exp(sum(math.log(x) for x in lat) / len(lat))
