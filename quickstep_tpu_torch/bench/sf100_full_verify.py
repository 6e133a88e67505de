# Copied from tools/sf100_full_verify.py; norm and row_eq as they are, the engine the port's on the device --device names, the rows of the cold run checked as well as the warm run's, each query's record with its upload, peak device memory and host RSS, and a nonzero exit when a query is not ok.
"""Run TPC-H queries against a fullgen store and verify row-exact vs its
streaming oracle (bench/sf100_fullgen.py). Used both to validate the
generator at small scale and as the SF100 measurement runner.

    python -m quickstep_tpu_torch.bench.sf100_full_verify <storedir>
        [budget_gb] [qlist] [out.json] --device cuda|cpu

budget_gb <= 0 disables streaming (resident execution — small scales).
Results (timings + ok flags + stream info) are written incrementally to
out.json when given, so a timeout never loses completed queries; a rerun
skips the queries it already holds as ok. Each query runs cold, then warm,
and is ok when the rows of both runs match the oracle. Beside the tool's
fields each record holds each run's verdict (ok_cold, ok_warm) and, for
each run, its milliseconds, the bytes streamed and the seconds of their
upload (last_stream_info), the peak device memory
(torch.cuda.max_memory_allocated, reset before the run; null on the CPU)
and the host RSS after it. The process exits with 1 when
any query is not ok.
"""

import argparse
import datetime
import json
import math
import os
import resource
import sys
import time

import torch

DEFAULT_QS = "6,1,12,14,19,4,3,5,7,10,18"


def norm(v):
    if isinstance(v, (datetime.date, datetime.datetime)):
        return v.isoformat()[:10]
    if isinstance(v, float):
        return v
    if isinstance(v, (int,)):
        return v
    return str(v)


def row_eq(a, b):
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        x, y = norm(x), norm(y)
        if isinstance(x, (int, float)) and isinstance(y, (int, float)):
            if not math.isclose(float(x), float(y), rel_tol=1e-9,
                                abs_tol=2e-2):
                return False
        elif str(x) != str(y):
            return False
    return True


def host_rss_bytes():
    """(current, peak) resident set of this process in bytes; current is
    None where /proc/self/statm is missing."""
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    try:
        with open("/proc/self/statm") as f:
            current = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except OSError:
        current = None
    return current, peak


def open_store(store, budget_bytes, device):
    """The port's Database on the catalog store `store`, on `device`, with
    a device memory budget of budget_bytes (0: none)."""
    from quickstep_tpu_torch import Database
    db = Database(storage_path=store, device=device)
    if budget_bytes > 0:
        db.config.hbm_budget_bytes = int(budget_bytes)
    return db


def timed_run(db, sql):
    """One run of sql: (rows, its figures)."""
    on_card = db.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(db.device)
        torch.cuda.reset_peak_memory_stats(db.device)
    t0 = time.perf_counter()
    rows = db.execute(sql).rows
    ms = (time.perf_counter() - t0) * 1000
    stream = db.executor.last_stream_info
    segs = stream["per_segment"] if stream else []
    rss, peak_rss = host_rss_bytes()
    return rows, {
        "ms": ms,
        "segments": stream["segments"] if stream else 0,
        "segments_run": stream["segments_run"] if stream else 0,
        "bytes_streamed": stream["bytes_streamed"] if stream else 0,
        "upload_s": sum(s["upload_s"] for s in segs if s["bytes"]),
        "peak_device_bytes": torch.cuda.max_memory_allocated(db.device)
        if on_card else None,
        "host_rss_bytes": rss, "host_peak_rss_bytes": peak_rss}


def rows_ok(qn, run, rows, want):
    """Whether one run's rows of query qn are the oracle's rows `want`,
    by row_eq; the first difference is printed."""
    got = [list(row) for row in rows]
    if len(got) != len(want):
        print(f"  Q{qn} {run} row count {len(got)} vs {len(want)}",
              flush=True)
        return False
    for g, w in zip(got, want):
        if not row_eq(g, w):
            print(f"  Q{qn} {run} row mismatch:\n   got  {g}\n   want {w}",
                  flush=True)
            return False
    return True


def check_query(db, qn, want):
    """Query qn cold and warm, the rows of each run against the oracle's
    rows `want`: the tool's record of it, ok when both runs are, with
    each run's verdict (ok_cold, ok_warm) and figures (under "runs")."""
    from quickstep_tpu_torch.bench.tpch import TPCH_QUERIES, with_tiebreak
    sql = with_tiebreak(qn, TPCH_QUERIES[qn])
    rows, cold = timed_run(db, sql)
    ok_cold = rows_ok(qn, "cold", rows, want)
    rows, warm = timed_run(db, sql)
    ok_warm = rows_ok(qn, "warm", rows, want)
    rec = {"ok": ok_cold and ok_warm, "ok_cold": ok_cold,
           "ok_warm": ok_warm, "rows": len(rows),
           "wall_cold_s": round(cold["ms"] / 1000, 2),
           "wall_warm_s": round(warm["ms"] / 1000, 2),
           "runs": {"cold": cold, "warm": warm}}
    stream = db.executor.last_stream_info
    if isinstance(stream, dict):
        rec["stream"] = {k: stream[k] for k in
                         ("segments", "mode", "pruned") if k in stream}
    return rec


def _write(out, out_path):
    if out_path:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("store")
    ap.add_argument("budget_gb", nargs="?", type=float, default=10.0)
    ap.add_argument("qlist", nargs="?", default=DEFAULT_QS)
    ap.add_argument("out", nargs="?", default=None)
    ap.add_argument("--device", required=True, choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    store, budget_gb, out_path = args.store, args.budget_gb, args.out
    qs = [int(q) for q in args.qlist.split(",")]

    with open(os.path.join(store, "oracle.json")) as f:
        oracle = json.load(f)
    db = open_store(store, budget_gb * (1 << 30) if budget_gb > 0 else 0,
                    args.device)
    out = {"store": store, "rows": oracle["rows"], "budget_gb": budget_gb,
           "device": args.device, "queries": {}}
    if out_path and os.path.exists(out_path):
        with open(out_path) as f:
            out = json.load(f)

    all_ok = True
    try:
        for qn in qs:
            key = str(qn)
            if out["queries"].get(key, {}).get("ok"):
                print(f"Q{qn}: already ok, skipping", flush=True)
                continue
            want = oracle.get(f"q{qn}")
            if want is None:
                print(f"Q{qn}: no oracle entry, skipping", flush=True)
                continue
            try:
                rec = check_query(db, qn, want)
            except Exception as e:  # noqa: BLE001 — record it and go on
                out["queries"][key] = {
                    "ok": False, "error": f"{type(e).__name__}: {e}"[:300]}
                all_ok = False
                print(f"Q{qn}: ERROR {e}", flush=True)
                _write(out, out_path)
                continue
            out["queries"][key] = rec
            all_ok = all_ok and rec["ok"]
            cold, warm = rec["runs"]["cold"], rec["runs"]["warm"]
            print(f"Q{qn}: ok={rec['ok']} (cold {rec['ok_cold']}, warm "
                  f"{rec['ok_warm']}) cold={cold['ms'] / 1000:.1f}s "
                  f"warm={warm['ms'] / 1000:.1f}s rows={rec['rows']} "
                  f"segments={warm['segments_run']}/{warm['segments']}",
                  flush=True)
            _write(out, out_path)
    finally:
        db.close()

    out["all_ok"] = all_ok
    _write(out, out_path)
    print(json.dumps({k: v.get("ok") for k, v in out["queries"].items()}))
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
