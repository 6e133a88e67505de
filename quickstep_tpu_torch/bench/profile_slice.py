"""Where the time of TPC-H queries, of the window queries and of the
operator queries goes on one CUDA card, with their tables resident in
device memory.

    python -m quickstep_tpu_torch.bench.profile_slice [--scale 10] [--runs 5]
        [--queries 6,1] [--trace-dir DIR] [--mesh-shards N] [--compactions]
        [--shuffle-census] [--members K]

--queries takes TPC-H query numbers and the names of bench/tpch_fullgen.py's
WINDOW_QUERIES (w1 to w6) and OPERATOR_QUERIES (o1 to o5). Q1 and Q6 alone run on lineitem's 7 columns from
bench/lineitem_gen.py; any other query in the list loads all 8 tables from
bench/tpch_fullgen.py.

For each query it prints, on the host clock, the median time of planning
(parse, resolve, optimize), of planning as `Database.execute` does it on a
warm run (parse, then the plan from the executor's logical-plan cache), of
`Executor.run_plan` and of `Database.execute` over `2 * runs` warm runs.
Then it traces `runs` calls of `run_plan` with torch.profiler and prints
the device time per run (the kernels and copies that ran on the card), the
share of run_plan's wall time under the profiler in which the card was
busy, the number of device operations per run, the top of the profiler's
table, and the device time of each of the port's own kernels
(csrc/*.cu). With --trace-dir it also writes a Chrome trace
per query there. With --mesh-shards the tables live on a mesh of N shards of
the card (Config.distributed), where the large joins shuffle.

With --compactions it profiles nothing: it runs each query cold, then once
warm, and prints each call of `PlanRunner._compact_chunk` in the warm run
(the chunk's capacity, the target it was given and the capacity it left).
With --shuffle-census (on a mesh: --mesh-shards) it first runs each query
cold, then once warm, and prints the K14 calls of the warm run
(parallel/shuffle.py partition_dest: the rows of each, its partitions,
salt and side), then the medians over all the queries' calls, which are
K14's and K15's most common shapes; then it profiles as above.

With --members K (and --mesh-shards S) it holds the mesh of K x S shards
in one process against the same mesh over K members of the process on
the card (Database(..., mesh_devices=["cuda:0"] * K),
parallel/local_group.py), one database after the other on the same
generated tables: for each query, the median of `2 * runs` warm
`Database.execute` calls and, under torch.profiler over `runs` more, the
device time per run, the device busy share and the device operations per
run (every member's), and whether both returned the same rows.
"""

from __future__ import annotations

import argparse
import os
import statistics
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from quickstep_tpu_torch import Database
from quickstep_tpu_torch.bench.lineitem_gen import load_lineitem
from quickstep_tpu_torch.bench.tpch_fullgen import (
    OPERATOR_QUERIES, WINDOW_QUERIES, load_tpch_full)
from quickstep_tpu_torch.bench.tpch import TPCH_QUERIES
from quickstep_tpu_torch.config import Config
from quickstep_tpu_torch.optimizer.resolver import Resolver
from quickstep_tpu_torch.optimizer.rules import optimize_plan
from quickstep_tpu_torch.parser import parse_statements

NAMED_QUERIES = {**WINDOW_QUERIES, **OPERATOR_QUERIES}


def _ms(fn, reps):
    """Median wall time of fn over reps calls, in ms (fn syncs itself)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1000)
    return statistics.median(times)


def _plan(db, sql):
    stmt = parse_statements(sql)[0]
    ex = db.executor
    return optimize_plan(Resolver(ex.db).resolve_select(stmt), ex.config,
                         ex.db)


def profile_query(db, q, runs, trace_dir=None):
    sql = NAMED_QUERIES[q] if isinstance(q, str) else TPCH_QUERIES[q]
    label = q.upper() if isinstance(q, str) else f"Q{q}"
    ex = db.executor
    db.execute(sql)                     # cold run: uploads the columns
    plan = _plan(db, sql)
    plan_ms = _ms(lambda: _plan(db, sql), 2 * runs)
    cached_ms = _ms(lambda: ex.plan_select(parse_statements(sql)[0]),
                    2 * runs)
    run_ms = _ms(lambda: ex.run_plan(plan), 2 * runs)
    exec_ms = _ms(lambda: db.execute(sql), 2 * runs)
    print(f"{label}: parse+resolve+optimize median {plan_ms:.3f} ms; "
          f"parse+plan cache {cached_ms:.3f} ms; run_plan "
          f"(enqueue+device+pull) {run_ms:.3f} ms; Database.execute "
          f"{exec_ms:.3f} ms", flush=True)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            ex.run_plan(plan)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000 / runs
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not device:
        raise RuntimeError(f"{label}: the profiler saw no device activity")
    device_ms = sum(e.time_range.elapsed_us() for e in device) / 1000 / runs
    print(f"{label}: run_plan wall {wall_ms:.3f} ms per run; device time "
          f"{device_ms:.3f} ms per run; device busy share "
          f"{device_ms / wall_ms:.3f}; {len(device) / runs:.0f} device ops "
          f"per run", flush=True)
    averages = prof.key_averages()
    print(averages.table(sort_by="self_cuda_time_total", row_limit=25),
          flush=True)
    # the port's own kernels (csrc/*.cu, in anonymous namespaces and the
    # radix sort's namespace radix; torch's name at::), which the table's
    # top rows may leave out
    prefixes = ("(anonymous namespace)::", "radix::")
    own = [e for e in averages
           if e.key.removeprefix("void ").startswith(prefixes)
           and "at::" not in e.key and e.self_device_time_total > 0]
    for e in sorted(own, key=lambda e: -e.self_device_time_total):
        ms = e.self_device_time_total / 1000 / runs
        name = e.key.removeprefix("void ").removeprefix(
            prefixes[0]).split("(")[0]
        print(f"{label}: kernel {name}: {ms:.3f} ms per run, "
              f"{ms / device_ms:.3f} of device time, {e.count / runs:g} "
              "launches per run", flush=True)
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            trace_dir, f"trace_{label.lower()}.json"))


def compaction_census(db, queries):
    """Each query cold, then warm with PlanRunner._compact_chunk
    watched: prints its calls in the warm run."""
    from quickstep_tpu_torch.exec.runner import PlanRunner
    real = PlanRunner._compact_chunk
    calls = []

    def watched(self, chunk, target):
        out = real(self, chunk, target)
        calls.append((chunk.capacity, target, out.capacity))
        return out
    PlanRunner._compact_chunk = watched
    try:
        for q in queries:
            sql = NAMED_QUERIES[q] if isinstance(q, str) else TPCH_QUERIES[q]
            label = q.upper() if isinstance(q, str) else f"Q{q}"
            try:
                db.execute(sql)
                calls.clear()
                db.execute(sql)
            except Exception as e:      # a query the port cannot run here
                print(f"{label}: failed: {type(e).__name__}: {e}", flush=True)
                continue
            done = [c for c in calls if c[2] < c[0]]
            print(f"{label}: _compact_chunk calls {len(calls)}, compacting "
                  f"{len(done)}: " + ", ".join(
                      f"{cap} -> {out} (target {t})" for cap, t, out in calls),
                  flush=True)
    finally:
        PlanRunner._compact_chunk = real


def shuffle_census(db, queries):
    """Each query cold, then warm with shuffle.partition_dest watched:
    prints its calls in the warm run and the medians over all of them."""
    from quickstep_tpu_torch.parallel import shuffle as SH
    real = SH.partition_dest
    calls = []

    def watched(key, alive, n_parts, cap, salt=1, probe_side=True,
                with_counts=False):
        rows = int(alive.shape[0])
        calls.append((rows, n_parts, salt, probe_side,
                      rows * (salt if salt > 1 and not probe_side else 1)))
        return real(key, alive, n_parts, cap, salt, probe_side, with_counts)
    SH.partition_dest = watched
    every = []
    try:
        for q in queries:
            sql = NAMED_QUERIES[q] if isinstance(q, str) else TPCH_QUERIES[q]
            label = q.upper() if isinstance(q, str) else f"Q{q}"
            db.execute(sql)
            calls.clear()
            db.execute(sql)
            every += calls
            probe = [c[0] for c in calls if c[3]]
            build = [c[0] for c in calls if not c[3]]
            print(f"{label}: K14 calls {len(calls)} (probe {len(probe)}, "
                  f"build {len(build)}); partitions "
                  f"{sorted({c[1] for c in calls})}, salts "
                  f"{sorted({c[2] for c in calls})}; probe rows "
                  f"{sorted(probe)}; build rows {sorted(build)}", flush=True)
    finally:
        SH.partition_dest = real
    if not every:
        print("shuffle census: no K14 call (no mesh, or no shuffle join)",
              flush=True)
        return

    def med(xs):
        return statistics.median(xs) if xs else None
    probe = [c[0] for c in every if c[3]]
    build = [c[0] for c in every if not c[3]]
    print(f"shuffle census: {len(every)} K14 calls; median rows "
          f"{med([c[0] for c in every])} (probe {med(probe)} of "
          f"{len(probe)}, build {med(build)} of {len(build)}); median "
          f"destinations (K15's rows) {med([c[4] for c in every])}; median "
          f"partitions {med([c[1] for c in every])}; salts "
          f"{sorted({c[2] for c in every})}; under 1 M rows "
          f"{sum(c[0] < 1_000_000 for c in every)}", flush=True)


def profile_execute(db, q, runs, label):
    """Warm Database.execute medians and device figures of query q on db
    (any database: every member's device work is counted). Returns its
    rows."""
    sql = NAMED_QUERIES[q] if isinstance(q, str) else TPCH_QUERIES[q]
    rows = db.execute(sql).rows         # cold run: uploads the columns
    exec_ms = _ms(lambda: db.execute(sql), 2 * runs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            db.execute(sql)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000 / runs
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not device:
        raise RuntimeError(f"{label}: the profiler saw no device activity")
    device_ms = sum(e.time_range.elapsed_us() for e in device) / 1000 / runs
    print(f"{label}: Database.execute median {exec_ms:.3f} ms; profiled "
          f"{wall_ms:.3f} ms per run, device time {device_ms:.3f} ms per "
          f"run, device busy share {device_ms / wall_ms:.3f}, "
          f"{len(device) / runs:.0f} device ops per run", flush=True)
    return rows


def compare_members(scale, queries, runs, members, shards):
    """The one-process mesh of members x shards shards against the same
    mesh over `members` members of cuda:0 (see the module's docstring)."""
    from quickstep_tpu_torch.bench.tpch_fullgen import generate, load_tables
    t0 = time.perf_counter()
    tables, stats, _oracle = generate(scale, lambda msg: None)
    print(f"all 8 tables SF{scale:g} generated in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    got = {}
    for k in (1, members):
        if k == 1:
            db = Database(config=Config(distributed=True), device="cuda",
                          mesh_shards=members * shards)
            load_tables(db, tables, stats)
            where = f"one process, {members * shards} shards"
        else:
            db = Database(config=Config(distributed=True), device="cuda",
                          mesh_shards=shards,
                          mesh_devices=["cuda:0"] * members)
            db.on_members(lambda m: load_tables(m, tables, stats))
            where = f"{members} members x {shards} shards"
        try:
            for q in queries:
                rows = profile_execute(db, q, runs, f"Q{q} ({where})")
                got.setdefault(q, []).append(rows)
        finally:
            db.close()
    for q, (one, spread) in got.items():
        print(f"Q{q}: the members' rows are the one-process mesh's: "
              f"{one == spread}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=10.0)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--queries", default="6,1",
                    help="comma-separated TPC-H query numbers and "
                         "window and operator query names (w1 to w6, o1 "
                         "to o5)")
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--mesh-shards", type=int, default=None)
    ap.add_argument("--compactions", action="store_true",
                    help="print each query's compactions; no profile")
    ap.add_argument("--shuffle-census", action="store_true",
                    help="print each query's K14 calls before the profile")
    ap.add_argument("--members", type=int, default=None,
                    help="the mesh over this many members of the process "
                         "against the one-process mesh")
    args = ap.parse_args(argv)
    queries = [q if q in NAMED_QUERIES else int(q)
               for q in args.queries.split(",")]
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: torch.cuda.is_available() is false")
    if args.members is not None:
        if args.mesh_shards is None:
            raise SystemExit("--members needs --mesh-shards, each member's")
        compare_members(args.scale, queries, args.runs, args.members,
                        args.mesh_shards)
        return
    cfg = Config(distributed=args.mesh_shards is not None)
    db = Database(config=cfg, device="cuda", mesh_shards=args.mesh_shards)
    try:
        t0 = time.perf_counter()
        if set(queries) <= {1, 6}:
            _rel, oracle = load_lineitem(db, args.scale)
            what = "lineitem"
        else:
            oracle = load_tpch_full(db, args.scale, log=lambda msg: None)
            what = "all 8 tables"
        where = "" if args.mesh_shards is None else \
            f", on {args.mesh_shards} shards"
        print(f"{what} SF{args.scale:g}{where}: {oracle['rows']} rows "
              f"generated in {time.perf_counter() - t0:.1f} s", flush=True)
        if args.compactions:
            compaction_census(db, queries)
            return
        if args.shuffle_census:
            shuffle_census(db, queries)
        for q in queries:
            profile_query(db, q, args.runs, args.trace_dir)
    finally:
        db.close()


if __name__ == "__main__":
    main()
