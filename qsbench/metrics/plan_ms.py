"""plan_ms: parse and plan_select (the plan cache's lookup, or planning on
a miss) on the host clock, by the harness's spans in the traced run: their
time over the window divided by the statements planned in it."""


def read(run):
    if run.spans is None:
        return None
    lo, hi = (int(t * 1e9) for t in run.window)
    spans = run.spans.within({"parse", "plan"}, lo, hi)
    planned = sum(name == "plan" for name, _, _ in spans)
    if not planned:
        return None
    return sum(b - a for _, a, b in spans) / 1e6 / planned
