"""kernel_ms_per_stream: the card's time in kernels, device-to-device
copies and sets for one pass of the session's queries, in ms: each
query's busy time (the union of those operations from its call to the
next query's call, from torch.profiler), averaged over its executions in
the window, summed over the session's order. Every query begun in the
window counts, with all its device work, those that return after the
close included. Copies between the host and the card are left out: their
time is the host's memcpy into staging buffers (upload_share reads it).
A cell of one session only; on the CPU there is no card and nothing to
read."""

import bisect
from collections import defaultdict

from qsbench import trace

HOST_COPIES = ("Memcpy HtoD", "Memcpy DtoH")


def read(run):
    if run.intervals is None or run.device_kind is None \
            or len(run.orders) != 1:
        return None
    ops = [(a, b) for a, b, name in run.intervals
           if not name.startswith(HOST_COPIES)]
    starts = [a for a, _ in ops]
    records = sorted((r for r in run.records if "error" not in r),
                     key=lambda r: r["start"])
    busy = defaultdict(list)
    for r, nxt in zip(records, records[1:] + [None]):
        lo = int(r["start"] * 1e9)
        hi = int(nxt["start"] * 1e9) if nxt else (1 << 62)
        mine = ops[bisect.bisect_left(starts, lo):
                   bisect.bisect_left(starts, hi)]
        busy[r["query"]].append(trace.busy(mine, lo, 1 << 62)[0])
    order = run.orders[0]
    if any(q not in busy for q in order):
        return None
    return 1e3 * sum(sum(busy[q]) / len(busy[q]) for q in order)
