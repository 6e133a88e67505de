# Twin of tools/sf_oracle.py: the same sqlite load, indexes and queries,
# with the tables from bench/tpch_fullgen.py's generator or from a store the
# port opens, and no JAX.
"""Phase A of TPC-H verification at scale: load sqlite with the 8 TPC-H
tables and run the 22 queries (bench/tpch.py's text with its tiebreaks and
ORACLE_OVERRIDES), writing their rows to a JSON file that sf_verify.py (phase
B) holds the port against. sqlite runs on the CPU only and is slow at SF10
(hours), so it is never run inside chip_smoke.py.

    python -m quickstep_tpu_torch.bench.sf_oracle <sf> [--out ORACLE.json]
        [--db SQLITE_PATH] [--store DIR] [--queries 1,2,...]

The tables are those bench/tpch_fullgen.py generates at <sf> (in host
memory), or with --store those of a catalog store (Database.save()). --db
puts sqlite on disk (in memory by default); an existing file is reused
without loading.
"""

from __future__ import annotations

import argparse
import json
import os
import sqlite3
import time

import numpy as np

from quickstep_tpu_torch.bench.tpch import (
    TPCH_QUERIES, ORACLE_OVERRIDES, to_sqlite_sql, with_tiebreak)
from quickstep_tpu_torch.bench.tpchgen import TPCH_SCHEMAS
from quickstep_tpu_torch.types import TypeID

CHUNK = 500_000

INDEXES = [
    "CREATE INDEX il_ok ON lineitem(l_orderkey)",
    "CREATE INDEX il_pk ON lineitem(l_partkey)",
    "CREATE INDEX il_ps ON lineitem(l_partkey, l_suppkey)",
    "CREATE INDEX il_sk ON lineitem(l_suppkey)",
    "CREATE INDEX io_ok ON orders(o_orderkey)",
    "CREATE INDEX io_ck ON orders(o_custkey)",
    "CREATE INDEX ic_ck ON customer(c_custkey)",
    "CREATE INDEX ip_pk ON part(p_partkey)",
    "CREATE INDEX ips_pk ON partsupp(ps_partkey)",
    "CREATE INDEX ips_sk ON partsupp(ps_suppkey)",
    "CREATE INDEX is_sk ON supplier(s_suppkey)",
]


def decode_cols(schema, data):
    """Each column of a TableData in schema order as an array of Python
    values sqlite takes: strings, ISO dates, DECIMALs as floats."""
    from quickstep_tpu_torch.types.datetime_util import date_to_str
    cols = []
    for cname, typ in schema:
        c = data.columns[cname]
        arr = np.asarray(c.data)
        tid = typ.type_id
        if typ.is_string:
            vals = np.asarray(c.dictionary.values, dtype=object)[arr]
        elif tid == TypeID.DECIMAL:
            vals = arr.astype(np.float64) / (10 ** typ.scale)
        elif tid == TypeID.DATE:
            # decode distinct codes once, then map
            uniq, inv = np.unique(arr, return_inverse=True)
            strs = np.asarray([date_to_str(int(x)) for x in uniq],
                              dtype=object)
            vals = strs[inv]
        elif typ.is_floating:
            vals = arr.astype(np.float64)
        else:
            vals = arr.astype(np.int64)
        cols.append(vals)
    return cols


def sqlite_from_tables(tables, db_path=":memory:", log=print):
    """A sqlite connection holding the 8 tables ({name: TableData}) with
    the tool's indexes; a db_path that exists is opened as it is, and then
    `tables` is not read."""
    fresh = db_path == ":memory:" or not os.path.exists(db_path)
    conn = sqlite3.connect(db_path)
    conn.execute("PRAGMA journal_mode=OFF")
    conn.execute("PRAGMA synchronous=OFF")
    conn.execute("PRAGMA cache_size=-2000000")   # 2GB page cache
    conn.execute("PRAGMA temp_store=FILE")
    if not fresh:
        return conn
    t0 = time.time()
    for name, schema in TPCH_SCHEMAS.items():
        decls = []
        for cname, typ in schema:
            tid = typ.type_id
            if tid in (TypeID.INT, TypeID.LONG):
                decls.append(f"{cname} INTEGER")
            elif tid in (TypeID.DOUBLE, TypeID.FLOAT, TypeID.DECIMAL):
                decls.append(f"{cname} REAL")
            else:
                decls.append(f"{cname} TEXT")
        conn.execute(f"CREATE TABLE {name} ({', '.join(decls)})")
        data = tables[name]
        cols = decode_cols(schema, data)
        n = data.num_rows
        ph = ", ".join("?" * len(schema))
        for start in range(0, n, CHUNK):
            sl = slice(start, min(start + CHUNK, n))
            # .tolist() yields native python scalars: numpy scalars would be
            # stored as BLOBs by the sqlite3 adapter
            rows = list(zip(*[c[sl].tolist() for c in cols]))
            conn.executemany(f"INSERT INTO {name} VALUES ({ph})", rows)
            conn.commit()
        log(f"# loaded {name}: {n} rows @ {time.time()-t0:.0f}s")
        del cols
    for ix in INDEXES:
        conn.execute(ix)
        conn.commit()
    log(f"# indexes done @ {time.time()-t0:.0f}s")
    return conn


def run_queries(conn, queries=None, log=print):
    """{str(q): {"rows": [...], "s": seconds} or {"error": ...}} for the
    TPC-H queries (all 22 by default) on sqlite."""
    results = {}
    for q in queries or sorted(TPCH_QUERIES):
        qs = time.time()
        oracle_sql = with_tiebreak(q, ORACLE_OVERRIDES.get(q,
                                                           TPCH_QUERIES[q]))
        try:
            rows = conn.execute(to_sqlite_sql(oracle_sql)).fetchall()
            results[str(q)] = {"rows": rows,
                               "s": round(time.time() - qs, 1)}
            log(f"# Q{q}: {len(rows)} rows in {time.time()-qs:.0f}s")
        except sqlite3.Error as e:
            results[str(q)] = {"error": str(e)[:200]}
            log(f"# Q{q} ERROR: {e}")
    return results


def read_tables(sf, store=None, log=print):
    """{name: TableData} of the 8 TPC-H tables: from the catalog store at
    `store`, or generated by bench/tpch_fullgen.py at `sf`."""
    if store is not None:
        from quickstep_tpu_torch.catalog.catalog import Catalog
        dbase = Catalog.load(store).default_database
        return {name: dbase.get_relation(name).data for name in TPCH_SCHEMAS}
    from quickstep_tpu_torch.bench.tpch_fullgen import generate
    tables, _stats, _oracle = generate(sf, log=lambda msg: None)
    log(f"# generated SF{sf:g}")
    return {name: t.table_data() for name, t in tables.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sf", type=float)
    ap.add_argument("--out", default=None,
                    help="the JSON file (default sf<sf>_oracle.json)")
    ap.add_argument("--db", default=":memory:")
    ap.add_argument("--store", default=None)
    ap.add_argument("--queries", default=None)
    args = ap.parse_args(argv)
    out_path = args.out or f"sf{args.sf:g}_oracle.json"
    queries = [int(q) for q in args.queries.split(",")] \
        if args.queries else None
    t0 = time.time()
    reuse = args.db != ":memory:" and os.path.exists(args.db)
    conn = sqlite_from_tables(
        None if reuse else read_tables(args.sf, args.store), args.db)
    results = run_queries(conn, queries)
    with open(out_path, "w") as f:
        json.dump({"sf": args.sf, "results": results,
                   "total_s": round(time.time() - t0, 1)}, f)
    print(f"# oracle done in {time.time()-t0:.0f}s -> {out_path}", flush=True)
    return results


if __name__ == "__main__":
    main()
