"""upload_share: of the statements that streamed a table (the executor's
last_stream_info), the seconds of their segments' uploads over their
wall time, in %, over the statements begun in the traced window."""


def read(run):
    if run.spans is None:
        return None
    lo, hi = (int(t * 1e9) for t in run.window)
    upload = wall = 0.0
    for e in run.spans.executions:
        if e["stream"] is None or not lo <= e["start"] < hi:
            continue
        upload += sum(s["upload_s"] for s in e["stream"]["per_segment"])
        wall += (e["end"] - e["start"]) / 1e9
    return 100.0 * upload / wall if wall else None
