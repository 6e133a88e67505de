# Twin of tools/sf_verify.py: its comparator (_row_eq, _norm_key,
# _multiset_eq, compare) copied as it is; the engine is quickstep_tpu_torch
# on the device the caller names, with no JAX.
"""Phase B of TPC-H verification at scale: run the port's 22 queries on a
named device and compare them row-exact (float tolerance) with the sqlite
results sf_oracle.py wrote. The comparison rules mirror tests/test_tpch.py.

    python -m quickstep_tpu_torch.bench.sf_verify <sf> --device cuda|cpu
        [--oracle ORACLE.json] [--out VERIFY.json] [--store DIR]
        [--queries 1,2,...]

The tables are those bench/tpch_fullgen.py generates at <sf>, loaded with
its exact statistics, or with --store those of a catalog store. Below
SF0.01 the generator's partsupp repeats (part, supplier) pairs that its
statistics declare unique, so there take a store whose statistics analyze
took. The report (the tool's form: a status, rows and seconds a query, and
the count of queries that match) goes to --out.
"""

from __future__ import annotations

import argparse
import json
import math
import time

from quickstep_tpu_torch.bench.tpch import TPCH_QUERIES, with_tiebreak


def _row_eq(a, b):
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if isinstance(x, float) and isinstance(y, float):
            if not math.isclose(x, y, rel_tol=1e-8, abs_tol=1e-6):
                return False
        elif isinstance(x, float) or isinstance(y, float):
            if x is None or y is None:
                return False
            if not math.isclose(float(x), float(y), rel_tol=1e-9,
                                abs_tol=1e-6):
                return False
        elif x != y:
            return False
    return True


def _norm_key(r):
    """Canonical sort key for multiset matching: floats participate rounded
    to 4dp (bucketing only — equality is decided by _row_eq's isclose, so a
    .xxx5 representation boundary can no longer produce a false MISMATCH the
    way the old round-to-2dp-and-repr comparison did)."""
    return tuple(("f", round(v, 4)) if isinstance(v, float)
                 else ("v", repr(v)) for v in r)


def _multiset_eq(a, b):
    sa = sorted(a, key=_norm_key)
    sb = sorted(b, key=_norm_key)
    return all(_row_eq(x, y) for x, y in zip(sa, sb))


def compare(qnum, ours, oracle, ordered):
    if len(ours) != len(oracle):
        return f"row count {len(ours)} vs {len(oracle)}"
    if ordered:
        for i, (a, b) in enumerate(zip(ours, oracle)):
            if not _row_eq(a, b):
                return f"row {i}: {a!r} != {b!r}"
        return None
    return None if _multiset_eq(ours, oracle) else "multiset mismatch"


def verify(db, oracle, queries=None, log=print):
    """{q: {"status": "ok" | "MISMATCH: ..." | ..., "rows", "wall_s"}}: each
    TPC-H query (all 22 by default) through `db` against the sqlite rows of
    sf_oracle.py's results."""
    report = {}
    for q in queries or sorted(TPCH_QUERIES):
        if str(q) not in oracle or "error" in oracle[str(q)]:
            report[q] = {"status": "no-oracle"}
            continue
        sql = with_tiebreak(q, TPCH_QUERIES[q])
        qs = time.time()
        try:
            ours = db.execute(sql).rows
        except Exception as e:      # reported per query, as the tool does
            report[q] = {"status": "engine-error",
                         "error": f"{type(e).__name__}: {e}"[:300]}
            log(f"# Q{q} ENGINE ERROR: {e}")
            continue
        wall = time.time() - qs
        orows = [tuple(r) for r in oracle[str(q)]["rows"]]
        ordered = "order by" in sql.lower()
        diff = compare(q, [tuple(r) for r in ours], orows, ordered)
        status = "ok" if diff is None else f"MISMATCH: {diff}"
        report[q] = {"status": status, "rows": len(ours),
                     "wall_s": round(wall, 1)}
        log(f"# Q{q}: {status} ({len(ours)} rows, {wall:.1f}s)")
    return report


def open_database(sf, device, store=None):
    """The port's Database on `device` with the 8 TPC-H tables: the catalog
    store at `store`, or bench/tpch_fullgen.py's tables at `sf` with exact
    statistics."""
    from quickstep_tpu_torch import Database
    if store is not None:
        return Database(storage_path=store, device=device)
    from quickstep_tpu_torch.bench.tpch_fullgen import generate, load_tables
    db = Database(device=device)
    tables, stats, _oracle = generate(sf, log=lambda msg: None)
    load_tables(db, tables, stats)
    return db


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sf", type=float)
    ap.add_argument("--device", required=True, choices=("cuda", "cpu"))
    ap.add_argument("--oracle", default=None,
                    help="sf_oracle.py's JSON (default sf<sf>_oracle.json)")
    ap.add_argument("--out", default=None,
                    help="the report (default sf<sf>_verify.json)")
    ap.add_argument("--store", default=None)
    ap.add_argument("--queries", default=None)
    args = ap.parse_args(argv)
    with open(args.oracle or f"sf{args.sf:g}_oracle.json") as f:
        oracle = json.load(f)["results"]
    queries = [int(q) for q in args.queries.split(",")] \
        if args.queries else None
    t0 = time.time()
    db = open_database(args.sf, args.device, args.store)
    try:
        report = verify(db, oracle, queries)
    finally:
        db.close()
    n_ok = sum(v["status"] == "ok" for v in report.values())
    with open(args.out or f"sf{args.sf:g}_verify.json", "w") as f:
        json.dump({"sf": args.sf, "device": args.device, "queries": report,
                   "ok": n_ok, "total_s": round(time.time() - t0, 1)}, f,
                  indent=1)
    print(f"# {n_ok}/{len(report)} row-exact at SF{args.sf:g} on "
          f"{args.device} in {time.time()-t0:.0f}s", flush=True)
    return report


if __name__ == "__main__":
    main()
