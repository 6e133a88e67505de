"""Run one cell of BENCHMARK.json once, on the card:

    python -m qsbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up: the cell's tables are made on the card from the seed by the
generator its configuration names (qsbench/gen.py), handed to
quickstep_tpu_torch.Database(device="cuda") with exact statistics
(qsbench/load.py), and the cell's queries are run once. The window: each
session of the traffic mix is a closed-loop client that calls
`Database.execute(sql, session=...)` with its next query as soon as the
last one returned, for --seconds seconds. After the window the program is
closed and its device memory freed; then the reference that the
configuration's query set names (qsbench/reference.py) works out every
query's answer again from the same columns, and every answer the window
produced, those still running at its close included, is compared with it
(qsbench/compare.py).

With --trace 0 the last line of standard output holds the cell's
end-to-end metrics, with --trace 1 its per-layer metrics, read under
spans around the program's layers and torch.profiler (qsbench/trace.py).
torch.profiler also runs over a --trace 0 window where one of the cell's
end-to-end metrics is read from the device trace.
Each metric is read by qsbench/metrics/<name>.py. The numbers compared,
each beside its limit, are the last lines of standard error and the
"checks" of the result's line.

Exit codes: 0 with a result; 2 without the CUDA cards the cell asks for;
3 when a JAX module or the JAX package was loaded; 1 on any other error.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
import warnings  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# compared by the part of a module's name before the first dot
FORBIDDEN = {"jax", "jaxlib", "flax", "quickstep_tpu"}
# a query still running at the window's close has this long to return
LATE_S = 120.0


def set_cache_dirs(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program builds its own kernels under build/kernels)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(root / "build" / sub)


set_cache_dirs()

import torch  # noqa: E402

from qsbench import compare, gen, load, registry  # noqa: E402
from qsbench import trace as tr  # noqa: E402


class Run:
    """What one run saw, for the metric readers (qsbench/metrics/)."""

    def __init__(self, config, queries, seconds):
        self.config = config
        self.queries = queries
        self.seconds = seconds
        self.setup_s = None
        self.build_s = None
        self.records: List[dict] = []
        self.window = (0.0, 0.0)          # perf_counter seconds
        self.table_rows: Dict[str, int] = {}
        self.enforcer_ms: List[float] = []
        self.spans: Optional[tr.Spans] = None
        self.busy_s: Optional[float] = None
        self.window_s: Optional[float] = None
        # the device's operations over the window, (start, end, name) in
        # perf_counter_ns, where the device was traced
        self.intervals: Optional[list] = None
        # each session's order of queries
        self.orders: List[List[str]] = []
        self.peaks = json.loads((ROOT / "qsbench" / "peaks.json").read_text())
        self.device_kind = None

    def completed(self) -> List[dict]:
        """The queries that returned their rows within the window."""
        return [r for r in self.records
                if "error" not in r and r["end"] <= self.window[1]]

    def latencies_ms(self) -> List[float]:
        return [(r["end"] - r["start"]) * 1e3 for r in self.completed()]


def _client(db, session, order, sqls, deadline, records, lock):
    """A closed loop: the next query as soon as the last one returned."""
    i = 0
    while True:
        t0 = time.perf_counter()
        if t0 >= deadline:
            return
        q = order[i % len(order)]
        i += 1
        rec = {"session": session, "query": q, "start": t0}
        try:
            rec["rows"] = db.execute(sqls[q], session=session).rows
        except Exception as e:   # a query that raises is counted as failed
            rec["error"] = f"{type(e).__name__}: {e}"
        rec["end"] = time.perf_counter()
        with lock:
            records.append(rec)


def _device_tables(host: Dict[str, Dict], tables: gen.Tables,
                   device) -> gen.Tables:
    """The harness's host columns back on the device for the reference."""
    with warnings.catch_warnings():
        # the arrays are read-only; they are only read
        warnings.simplefilter("ignore", UserWarning)
        cols = {t: {c: torch.from_numpy(a).to(device)
                    for c, a in host[t].items()} for t in host}
    return gen.Tables(tables.scale, tables.seed, cols, tables.vocab)


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def execute_cell(cell_name: str, seed: int, seconds: float, traced: bool,
                 device: str = "cuda", scale: Optional[float] = None,
                 bench: Optional[dict] = None, fault=None,
                 t_start: float = None) -> dict:
    """One run of a cell; returns the result's line as a dict. `scale`
    (a smaller scale factor than the configuration's) and `fault` (a
    callable given the Database before the window, that breaks it) are
    for the tests on the CPU."""
    from quickstep_tpu_torch import Database
    from quickstep_tpu_torch.config import Config
    t_start = _T0 if t_start is None else t_start
    bench = bench or registry.benchmark()
    cell = registry.cell(bench, cell_name)
    config = registry.config(bench, cell["config"])
    traffic = registry.traffic(cell["traffic"])
    query_set = registry.query_set(config["queries"])
    sqls = query_set["queries"]
    generator = registry.module(config["generator"])
    reference = registry.module(query_set["reference"])
    run = Run(config, sqls, seconds)
    run.orders = [s["order"] for s in traffic["sessions"]]
    device_traced = traced or any(
        m["source"] == "device_trace"
        for m in registry.metrics_of(bench, cell_name, "end_to_end"))
    dev = torch.device(device)
    marks = [("start", t_start)]

    def mark(name):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    mark("imports")
    if dev.type == "cuda":
        from quickstep_tpu_torch.ops import cuda as kernels
        kernels.build()
        run.build_s = kernels.BUILD_SECONDS
    mark("kernels")
    tables = generator.generate(scale or config["scale_factor"], seed, dev)
    mark("generate")
    stats = load.statistics(tables)
    host = load.host_columns(tables)
    run.table_rows = {t: tables.rows(t) for t in tables.columns}
    vocab_only = gen.Tables(tables.scale, seed, {}, tables.vocab)
    del tables
    if dev.type == "cuda":
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    mark("handover")

    db = Database(Config(**config["engine"]), device=device)
    db.policy_enforcer.stats.max_entries = 1 << 30
    load.load(db, vocab_only, host, stats, generator.SCHEMAS)
    mark("load")
    warm = []
    for session in traffic["sessions"]:
        warm += [q for q in session["order"] if q not in warm]
    for q in warm:
        db.execute(sqls[q])
    # what set-up made stays out of the collector's full passes
    gc.collect()
    gc.freeze()
    mark("warm")
    if fault is not None:
        fault(db)
    spans = device_trace = None
    if traced:
        spans = run.spans = tr.Spans(sqls)
        spans.instrument(db)
    if device_traced:
        device_trace = tr.DeviceTrace(cpu=dev.type != "cuda")
    n_before = len(db.policy_enforcer.stats._windows.get("query", ()))

    # ---- the window ----
    lock = threading.Lock()
    threads = []
    if device_trace is not None:
        device_trace.start()
    w0 = time.perf_counter()
    run.setup_s = w0 - t_start
    deadline = w0 + seconds
    for session in traffic["sessions"]:
        threads.append(threading.Thread(
            target=_client, daemon=True, name=f"client-{session['name']}",
            args=(db, session["name"], session["order"], sqls, deadline,
                  run.records, lock)))
    for t in threads:
        t.start()
    for t in threads:
        t.join(max(0.0, deadline + LATE_S - time.perf_counter()))
    hung = sum(t.is_alive() for t in threads)
    run.window = (w0, deadline)
    if device_trace is not None:
        device_trace.stop()
        run.intervals = device_trace.intervals
        lo, hi = int(w0 * 1e9), int(deadline * 1e9)
        run.busy_s, gaps = tr.busy(run.intervals, lo, hi)
        run.window_s = seconds
    if traced:
        run.breakdown = tr.breakdown(
            [i for i in run.intervals if lo <= i[0] < hi], gaps, spans)
    entries = list(db.policy_enforcer.stats._windows.get("query", ()))
    run.enforcer_ms = entries[n_before:n_before + len(run.completed())]

    memory_peak = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    if dev.type == "cuda":
        run.device_kind = torch.cuda.get_device_name(dev)
    db.close()
    del db
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # ---- the reference, and the comparison ----
    t_ref = time.perf_counter()
    ref_tables = _device_tables(host, vocab_only, dev)
    names = sorted({r["query"] for r in run.records},
                   key=lambda q: int(q[1:]))
    want = reference.answers(ref_tables, sqls, names)
    del ref_tables
    t_ref = time.perf_counter() - t_ref
    failed = sum("error" in r for r in run.records) + hung
    checks = compare.judge(((r["query"], r.get("rows")) for r in run.records
                            if "error" not in r), want, failed,
                           query_set["nonempty"])

    kind = "per_layer" if traced else "end_to_end"
    metrics = registry.read_metrics(
        registry.metrics_of(bench, cell_name, kind), run)
    result = {"correct": compare.passed(checks),
              "attempted": len(run.records) + hung, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                         "kind": run.device_kind or "cpu", "count": 1,
                         "memory_peak_bytes": memory_peak}}
    if traced:
        result["device"]["busy_s"] = run.busy_s
        result["device"]["window_s"] = run.window_s
        result["breakdown"] = run.breakdown
    if run.build_s is not None:
        result["build_s"] = run.build_s
    result["setup_parts_s"] = {b[0]: b[1] - a[1]
                               for a, b in zip(marks, marks[1:])}
    result["reference_s"] = t_ref
    result["per_query_ms"] = per_query(run)
    # the host clock's readings, beside the cell's metrics in every run
    result["host_clock"] = {n: registry.reader(n)(run)
                            for n in ("qps", "geomean_ms")}
    errors = sorted({r["error"] for r in run.records if "error" in r})
    if errors:
        result["errors"] = errors[:5]
    result["checks"] = checks
    return result


def per_query(run: Run) -> Dict[str, list]:
    """Each query's completions in the window and its median latency."""
    by: Dict[str, List[float]] = {}
    for r in run.completed():
        by.setdefault(r["query"], []).append((r["end"] - r["start"]) * 1e3)
    return {q: [len(v), sorted(v)[len(v) // 2]]
            for q, v in sorted(by.items(), key=lambda x: int(x[0][1:]))}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = registry.benchmark()
    chips = registry.cell(bench, args.workload)["chips"]
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        print(f"qsbench: {args.workload} needs {chips} CUDA card(s); torch "
              f"finds {cards}", file=sys.stderr)
        return 2
    result = execute_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda", bench=bench)
    found = forbidden_modules()
    if found:
        print(f"qsbench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    result["device"]["power_limit"] = _power_limit()
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
