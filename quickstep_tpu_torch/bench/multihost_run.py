"""One process of a multi-process run of the port: a rank of a mesh spread
over processes (parallel/multihost.py).

    python quickstep_tpu_torch/bench/multihost_run.py PROC_ID N_PROCS PORT OUT
        --device cpu|cuda[:N] [--backend gloo] [--local-shards 2]
        [--star]
        [--scale SF | --tables DIR] [--queries 3,5,...] [--runs 1]

The port's counterpart of tests/multihost_worker.py. Start N_PROCS of
them, one for each PROC_ID, on one machine: process 0 serves the
coordinator at 127.0.0.1:PORT. Each builds the same database (every
process holds every table on the host) with Config.distributed on a mesh
of --local-shards shards of --device, so the mesh has N_PROCS times as
many, and runs, in this order:

- --star: the mesh's collectives over collective_inputs, the star battery
  (QUERIES over build_db, copies of tests/multihost_worker.py's), then
  RETRY_QUERIES (each raises a runtime flag on one process's shards only,
  and the retry must be taken together), SEMI_QUERIES over SEMI_TABLES
  (the semi, anti and expansion joins on each process's rows) and DML
  (INSERT, DELETE and UPDATE of a sharded table, then DML_QUERIES);
- --scale SF: the 22 TPC-H queries (bench/tpch.py, replicate threshold
  1000 as in tests/multihost_worker.py), or those --queries names; or
  --tables DIR: the tables write_tables wrote (memory-mapped, so that the
  processes share the host pages) at the default replicate threshold,
  --queries with their tiebreaks, each --runs times.

Each process writes OUT.<PROC_ID> (a pickle): "rows", each query's rows of
each run; "figures", this process's: each query's milliseconds, retries,
host syncs, what crossed the processes (Executor.last_mesh_info) and, on
a card, peak device memory; the bytes it uploaded of each table beside
the table's bytes, its peak memory (device, or host on the CPU) and, on a
card, each kernel's launches. A rank that fails exits non-zero;
the caller bounds the run with a timeout.

`run_members` runs the same batteries over members of one process instead
(parallel/local_group.py, Database(..., mesh_devices=...)) and returns
each member's rows and figures in the same form.
"""

from __future__ import annotations

import argparse
import os
import pickle
import resource
import sys
import time

import numpy as np

if __name__ == "__main__" and __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

# the star battery: tests/multihost_worker.py:79-89
QUERIES = {
    "filter_agg": "SELECT COUNT(*), SUM(v), MIN(v), MAX(v) FROM fact "
                  "WHERE v > 100",
    "groupby": "SELECT g, COUNT(*) AS c, SUM(v) AS s FROM fact "
               "GROUP BY g ORDER BY g",
    "join_agg": "SELECT d.name, SUM(f.v) AS s FROM fact f, dim d "
                "WHERE f.k = d.k GROUP BY d.name ORDER BY s DESC",
    "semi": "SELECT COUNT(*) FROM fact WHERE k IN "
            "(SELECT k FROM dim WHERE name <> 'd3')",
    "topn": "SELECT g, v FROM fact ORDER BY v DESC, g LIMIT 5",
}
STAR_THRESHOLD = 64
TPCH_THRESHOLD = 1000
SKEW_ROWS = 4000
DUP_RUN = 20
# each must retry once: a shuffle bucket overflows on process 0's source
# shards only, then an expansion join's run of duplicate keys (longer than
# its 8 slots) on one shard only
RETRY_QUERIES = {
    "retry_shuffle": "SELECT COUNT(*), SUM(p.w) FROM sk_probe p, "
                     "sk_build b WHERE p.k = b.k",
    "retry_join": "SELECT COUNT(*), SUM(a.u), SUM(b.u) FROM sk_dup a, "
                  "sk_dup b WHERE a.k = b.k",
}
# the semi, anti and expansion joins that run on each process's rows
# (exec/runner.py _exec_Join), over two tables made by SQL alone, so that
# quickstep_tpu builds the same: sb, the build side, and sp, the probe side,
# both shard at STAR_THRESHOLD (on 2 processes x 2 shards process 0 holds
# sb's ids 0-99 and sp's ids 0-119). sb.k runs 3-4 rows a value; sb.nk is
# NULL on three rows of process 0's first shard alone, and holds a run of
# 12 rows of SEMI_RUN_KEY, which sp.pk holds on process 0's rows alone, so
# that an expansion join over nk overflows its 8 slots (no statistics) on
# process 0 only; sp.pk is NULL on both processes' rows.
SEMI_RUN_KEY = 200


def _sb_nk(i: int):
    if i in (3, 11, 29):
        return "NULL"
    return SEMI_RUN_KEY if 150 <= i < 162 else 1 + 3 * i % 80


def _sp_pk(i: int):
    if i % 9 == 4:
        return "NULL"
    return SEMI_RUN_KEY if i < 5 else 1 + 5 * i % 90


SEMI_TABLES = (
    "CREATE TABLE sb (id INT NOT NULL, k INT NOT NULL, nk INT, "
    "w INT NOT NULL)",
    "INSERT INTO sb VALUES " + ", ".join(
        f"({i}, {1 + 7 * i % 60}, {_sb_nk(i)}, {13 * i % 17})"
        for i in range(200)),
    "CREATE TABLE sp (id INT NOT NULL, k INT NOT NULL, pk INT, "
    "w INT NOT NULL, v BIGINT NOT NULL)",
    "INSERT INTO sp VALUES " + ", ".join(
        f"({i}, {1 + 11 * i % 70}, {_sp_pk(i)}, {7 * i % 17}, {3 * i % 101})"
        for i in range(240)),
)
SEMI_QUERIES = {
    # the exact filter over a sharded build: presence OR'd (por_filter)
    "semi_filter": "SELECT COUNT(*), SUM(v) FROM sp WHERE k IN "
                   "(SELECT k FROM sb WHERE w > 4)",
    "anti_filter": "SELECT COUNT(*), SUM(v) FROM sp WHERE NOT EXISTS "
                   "(SELECT * FROM sb WHERE sb.k = sp.k AND sb.w > 9)",
    # NOT IN: a NULL in process 0's build rows alone empties the result
    # on both; a build whose live rows are process 0's alone drops the NULL
    # probe keys on both; a build empty everywhere passes them
    "not_in_null_one_side": "SELECT COUNT(*), SUM(v) FROM sp WHERE pk NOT IN "
                            "(SELECT nk FROM sb)",
    "not_in_empty_one_side": "SELECT COUNT(*), SUM(v) FROM sp WHERE pk NOT "
                             "IN (SELECT k FROM sb WHERE id < 90)",
    "not_in_empty": "SELECT COUNT(*), SUM(v) FROM sp WHERE pk NOT IN "
                    "(SELECT k FROM sb WHERE id < 0)",
    # the run statistics (K8) on each process's probe rows
    "semi_stats_ne": "SELECT COUNT(*), SUM(v) FROM sp WHERE EXISTS "
                     "(SELECT * FROM sb WHERE sb.k = sp.k AND sb.w <> sp.w)",
    "anti_stats_lt": "SELECT COUNT(*), SUM(v) FROM sp WHERE NOT EXISTS "
                     "(SELECT * FROM sb WHERE sb.k = sp.k AND sb.w < sp.w)",
    # a residual of another shape: the run statistics decline; over keys
    # without NULLs the shuffle takes the probe as it is, over nullable
    # keys the expansion join does, and overflows on process 0 alone
    "semi_expand_shuffle": "SELECT COUNT(*), SUM(v) FROM sp WHERE EXISTS "
                           "(SELECT * FROM sb WHERE sb.k = sp.k AND "
                           "(sb.w > sp.w OR sb.id < 20))",
    "semi_expand_local": "SELECT COUNT(*), SUM(v) FROM sp WHERE EXISTS "
                         "(SELECT * FROM sb WHERE sb.nk = sp.pk AND "
                         "(sb.w > sp.w OR sb.id < 20))",
    # many-to-many expansion joins over the nullable key: both overflow on
    # process 0 alone
    "inner_expand": "SELECT COUNT(*), SUM(sp.v), SUM(sb.w) FROM sp, sb "
                    "WHERE sp.pk = sb.nk",
    "left_expand": "SELECT COUNT(*), SUM(sp.v), SUM(sb.w) FROM sp LEFT JOIN "
                   "sb ON sp.pk = sb.nk",
}
DML = (
    "CREATE TABLE dm (k INT NOT NULL, v BIGINT NOT NULL)",
    "INSERT INTO dm VALUES " + ", ".join(
        f"({k}, {k * 37 % 101})" for k in range(100)),
    "INSERT INTO dm SELECT k + 1000 * g, v FROM fact",
    "DELETE FROM dm WHERE v % 7 = 0",
    "UPDATE dm SET v = v + 1 WHERE k > 2000",
    # a nullable key of a dense domain: its GROUP BY leaves the dense route
    # once the key is evaluated, and 50 rows a shard are too few for the
    # two-phase route's partials, so it gathers
    "CREATE TABLE nk (g INT, v BIGINT NOT NULL)",
    "INSERT INTO nk VALUES " + ", ".join(
        f"({'NULL' if i % 11 == 0 else i % 97}, {i * 7 % 23})"
        for i in range(200)),
    "\\analyze nk",
)
DML_QUERIES = {
    "dml_count": "SELECT COUNT(*), SUM(v), MIN(k), MAX(k) FROM dm",
    "dml_groups": "SELECT k % 10 AS r, COUNT(*) AS c, SUM(v) AS s FROM dm "
                  "GROUP BY r ORDER BY r",
    "dml_join": "SELECT d.name, COUNT(*) AS c FROM dm, dim d "
                "WHERE dm.k % 32 + 1 = d.k GROUP BY d.name ORDER BY d.name",
    "dml_nullable_groups": "SELECT g, COUNT(*) AS c, SUM(v) AS s FROM nk "
                           "GROUP BY g ORDER BY g",
}


def config(threshold: int):
    from quickstep_tpu_torch.config import Config
    return Config(distributed=True, replicate_threshold_rows=threshold,
                  display_timing=False)


def build_db(cfg, device, mesh_shards, mesh_devices=None):
    """Deterministic two-table star: fact(k, g, v) x dim(k, name)
    (tests/multihost_worker.py's build_db on the port), over members of
    this process where mesh_devices names them."""
    from quickstep_tpu_torch import Database
    return fill_star(Database(config=cfg, device=device,
                              mesh_shards=mesh_shards,
                              mesh_devices=mesh_devices))


def fill_star(db):
    """build_db's tables in db; returns db."""
    db.execute("CREATE TABLE dim (k INT NOT NULL, name VARCHAR(10) NOT NULL)")
    db.execute("INSERT INTO dim VALUES " + ", ".join(
        f"({k}, 'd{k % 7}')" for k in range(1, 33)))
    db.execute("CREATE TABLE fact (k INT NOT NULL, g INT NOT NULL, "
               "v BIGINT NOT NULL)")
    rows = []
    x = 1
    for i in range(600):
        x = (x * 1103515245 + 12345) % (1 << 31)
        rows.append(f"({1 + x % 32}, {x % 5}, {x % 1000})")
    db.execute("INSERT INTO fact VALUES " + ", ".join(rows))
    db.execute("\\analyze")
    return db


def add_skew_tables(db, n_parts: int):
    """The tables of RETRY_QUERIES, not analyzed. sk_build: distinct keys,
    its first half all in shuffle partition 0 of n_parts, its second half
    in the others; sk_probe: keys over both, most of them in the second
    half. The shuffle sizes the build buckets at twice the mean, which the
    first half overflows on the shards that hold it (a multi-process
    mesh's first process), and the retry with four times the buckets fits.
    sk_dup: one key of partition 0 DUP_RUN times, then distinct keys of
    the others: only partition 0's shard finds a run longer than an
    expansion join's 8 slots without statistics, and the retry's 32 fit."""
    import torch
    from quickstep_tpu_torch.parallel.shuffle import partition_of
    half = SKEW_ROWS // 2
    cand = torch.arange(1, 2 * n_parts * SKEW_ROWS, dtype=torch.int64)
    zero = partition_of(cand, n_parts) == 0
    keys = cand[zero][:half].tolist() + cand[~zero][:half].tolist()
    dup = [keys[0]] * DUP_RUN + cand[~zero][:SKEW_ROWS - DUP_RUN].tolist()
    db.execute("CREATE TABLE sk_build (k INT NOT NULL, v INT NOT NULL)")
    db.execute("INSERT INTO sk_build VALUES " + ", ".join(
        f"({k}, {i})" for i, k in enumerate(keys)))
    db.execute("CREATE TABLE sk_probe (k INT NOT NULL, w INT NOT NULL)")
    # a tenth of the probe rows on the first half's keys, the rest spread
    db.execute("INSERT INTO sk_probe VALUES " + ", ".join(
        f"({keys[i % half if i % 10 == 0 else half + i % half] + i % 3}, "
        f"{i % 13})" for i in range(SKEW_ROWS)))
    db.execute("CREATE TABLE sk_dup (k INT NOT NULL, u INT NOT NULL)")
    db.execute("INSERT INTO sk_dup VALUES " + ", ".join(
        f"({k}, {i})" for i, k in enumerate(dup)))


def collective_inputs(n: int, g: int) -> dict:
    """Global shard g's inputs of the collectives check on a mesh of n
    shards: every dtype the engine moves, floats of mixed magnitudes (so a
    sum's order shows in its bits)."""
    rng = np.random.default_rng(1000 + g)
    rows = 4 * n
    return {
        "f64": rng.standard_normal(rows) * 10.0 ** rng.integers(-8, 9, rows),
        "i64": rng.integers(-2 ** 62, 2 ** 62, rows),
        "i32": rng.integers(-2 ** 31, 2 ** 31, rows).astype(np.int32),
        "i8": rng.integers(-128, 128, rows).astype(np.int8),
        "b": rng.random(rows) < 0.5,
        "part": rng.standard_normal(8) * 10.0 ** rng.integers(-8, 9, 8),
        "words": rng.integers(0, 2 ** 31, 16).astype(np.int32),
    }


def run_collectives(mesh) -> dict:
    """The mesh's collectives over this process's shards' inputs: each
    all_to_all's local shards' rows concatenated, and the replicated
    results of psum, pmax, por, all_gather and all_gather_to_host, as
    numpy arrays."""
    import torch
    from quickstep_tpu_torch.parallel.mesh import (
        all_gather, all_to_all, pmax, por, psum)
    from quickstep_tpu_torch.parallel.multihost import all_gather_to_host
    ins = [collective_inputs(mesh.n, g) for g in mesh.local_ids]

    def t(a):
        return torch.from_numpy(a).to(mesh.device)

    def host(ts):
        return np.concatenate([x.cpu().numpy() for x in ts])
    out = {"all_to_all": host(all_to_all(mesh, [t(x["f64"]) for x in ins]))}
    cols = ("i64", "i32", "i8", "b", "f64")
    moved = all_to_all(mesh, [[t(x[c]) for c in cols] for x in ins])
    for i, c in enumerate(cols):
        out[f"all_to_all_{c}"] = host([m[i] for m in moved])
    out["psum"] = psum(mesh, [t(x["part"]) for x in ins]).cpu().numpy()
    out["pmax"] = pmax(mesh, [t(x["part"]) for x in ins]).cpu().numpy()
    out["por"] = por(mesh, [t(x["words"]) for x in ins]).cpu().numpy()
    out["por_b"] = por(mesh, [t(x["b"]) for x in ins]).cpu().numpy()
    gathered = all_gather(mesh, [torch.cat([t(x["i64"]) for x in ins]),
                                 torch.cat([t(x["b"]) for x in ins])])
    out["all_gather"] = gathered[0].cpu().numpy()
    out["all_gather_b"] = gathered[1].cpu().numpy()
    out["all_gather_to_host"] = all_gather_to_host(
        mesh, [torch.cat([t(x["f64"]) for x in ins])])[0]
    return out


def write_tables(path: str, tables, stats) -> None:
    """bench/tpch_fullgen.py generate's tables as one .npy a column under
    path, with their dictionaries and statistics (read_tables)."""
    os.makedirs(path, exist_ok=True)
    meta = {}
    for name, t in tables.items():
        for cname, arr in t.arrays.items():
            np.save(os.path.join(path, f"{name}.{cname}.npy"), arr)
        meta[name] = {"n": t.n, "columns": list(t.arrays), "dicts": t.dicts}
    with open(os.path.join(path, "tables.pickle"), "wb") as f:
        pickle.dump({"tables": meta, "stats": stats}, f)


def read_tables(path: str):
    """(tables, stats) as write_tables left them, each column memory-mapped
    (the processes of one machine share its pages)."""
    from quickstep_tpu_torch.bench.tpch_fullgen import TableOut
    with open(os.path.join(path, "tables.pickle"), "rb") as f:
        saved = pickle.load(f)
    tables = {}
    for name, meta in saved["tables"].items():
        t = TableOut(name, meta["n"])
        for cname in meta["columns"]:
            t.arrays[cname] = np.load(
                os.path.join(path, f"{name}.{cname}.npy"), mmap_mode="r")
        t.dicts = meta["dicts"]
        tables[name] = t
    return tables, saved["stats"]


def uploads(db) -> dict:
    """Each table's device copy on this process: its bytes uploaded, the
    bytes of the same columns over the whole (padded) table, and whether
    it is sharded."""
    out = {}
    for (name, _version), (cols, m) in db.executor._device_cache.items():
        columns = [x for c, x in cols.items() if c != "__num_rows__"]
        whole = sum(m["capacity"] * (d.element_size() + (v is not None))
                    for d, v in columns)
        out[name] = {"bytes": m["bytes"], "table_bytes": whole,
                     "sharded": m["sharded"]}
    return out


def run_queries(db, queries: dict, runs: int, rows: dict, figures: dict,
                reset_peak: bool = True):
    """Each query `runs` times: its rows of each run into rows[name], its
    times, what crossed the processes and, on a card, the peak memory of
    its runs into figures["queries"][name] (since this rank's reset of the
    card's peak before the query, or, without reset_peak, another's: the
    members that share a card share its allocator)."""
    import torch
    card = db.device.type == "cuda"
    for name, sql in queries.items():
        rows[name] = []
        fig = figures["queries"].setdefault(name, {
            "ms": [], "retries": [], "host_syncs": [], "mesh": []})
        if card and reset_peak:
            torch.cuda.reset_peak_memory_stats(db.device)
        for _ in range(runs):
            t0 = time.perf_counter()
            res = db.execute(sql)
            fig["ms"].append((time.perf_counter() - t0) * 1000)
            rows[name].append(list(res.rows))
            fig["retries"].append(db.executor.retries)
            fig["host_syncs"].append(db.executor.host_syncs)
            fig["mesh"].append(db.executor.last_mesh_info)
        if card:
            fig["peak_bytes"] = torch.cuda.max_memory_allocated(db.device)


def batteries(make_db, each, finish, star=False, scale=0.0, tables=None,
              queries=None, runs=1, reset_peak=lambda rank: True) -> None:
    """The runs of --star, then of --scale or of `tables` (a (tables,
    stats) pair of bench/tpch_fullgen.py's generate or read_tables), with
    --queries' numbers, on the ranks of this process: make_db(cfg) makes a
    database; each(db, fn) calls fn(rank, its rows, its figures) for every
    rank this process runs (a process's database itself, or each member
    on its thread), and finish(db) ends each database."""
    def per_rank(db, qs):
        each(db, lambda rank, rows, fig: run_queries(
            rank, qs, runs, rows, fig, reset_peak(rank)))

    if star:
        db = fill_star(make_db(config(STAR_THRESHOLD)))
        each(db, lambda rank, _rows, fig: fig.__setitem__(
            "collectives", run_collectives(rank.executor.mesh)))
        per_rank(db, QUERIES)
        add_skew_tables(db, db.executor.mesh.n)
        per_rank(db, RETRY_QUERIES)
        for stmt in SEMI_TABLES:
            db.execute(stmt)
        per_rank(db, SEMI_QUERIES)
        for stmt in DML:
            db.execute(stmt)
        per_rank(db, DML_QUERIES)
        finish(db)
    if scale or tables is not None:
        from quickstep_tpu_torch.bench.tpch import (
            TPCH_QUERIES, load_tpch, with_tiebreak)
        from quickstep_tpu_torch.config import Config
        numbers = sorted(TPCH_QUERIES) if not queries else list(queries)
        if tables is not None:
            from quickstep_tpu_torch.bench.tpch_fullgen import load_tables
            db = make_db(Config(distributed=True))
            each(db, lambda rank, _rows, _fig: load_tables(rank, *tables))
            qs = {f"Q{q}": with_tiebreak(q, TPCH_QUERIES[q])
                  for q in numbers}
        else:
            db = make_db(config(TPCH_THRESHOLD))
            each(db, lambda rank, _rows, _fig: load_tpch(rank, scale=scale,
                                                         seed=0))
            qs = {f"Q{q}": TPCH_QUERIES[q] for q in numbers}
        per_rank(db, qs)
        finish(db)


def peak_bytes(figures: dict, device) -> int:
    """The most memory a rank held: on a card its queries' peaks and the
    allocator's, else the process's resident peak."""
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        return max([q.get("peak_bytes", 0)
                    for q in figures["queries"].values()] +
                   [torch.cuda.max_memory_allocated(device)])
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def run_members(devices, local_shards: int, star: bool = False,
                scale: float = 0.0, tables=None, queries=None,
                runs: int = 1) -> list:
    """main's runs over members of this process instead of processes
    (Database(..., mesh_devices=devices), one member a device, each with
    local_shards shards; `tables` a (tables, stats) pair that every member
    loads, sharing the host arrays). Returns each member's {"rows",
    "figures"} in member order, as each process writes them
    (figures["process"] the member's index, "launches" its thread's)."""
    import threading
    import torch
    from quickstep_tpu_torch import Database
    card = torch.device(devices[0]).type == "cuda"
    out = [{"rows": {}, "figures": {
        "process": i, "world": len(devices), "local_shards": local_shards,
        "device": str(devices[i]), "backend": "members", "queries": {},
        "uploads": {}}} for i in range(len(devices))]
    if card:
        from quickstep_tpu_torch.ops import cuda
        torch.cuda.init()
        cuda.reset_launches()

    def each(db, fn):
        return db.on_members(lambda m: fn(m, out[m.index]["rows"],
                                          out[m.index]["figures"]))

    def finish(db):
        def counts(m, _rows, fig):
            fig["uploads"].update(uploads(m))
            if card:
                mine = fig.setdefault("launches", dict.fromkeys(
                    cuda.LAUNCHES, 0))
                for name, n in cuda.launches_of(
                        threading.current_thread()).items():
                    mine[name] += n
        each(db, counts)
        db.close()

    batteries(lambda cfg: Database(
        config=cfg, device="cuda" if card else "cpu",
        mesh_shards=local_shards, mesh_devices=devices), each, finish, star,
        scale, tables, queries, runs,
        # the first member on each device resets its peak before a query
        lambda m: list(devices).index(devices[m.index]) == m.index)
    for m in out:
        m["figures"]["peak_bytes"] = peak_bytes(m["figures"],
                                                m["figures"]["device"])
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("proc_id", type=int)
    ap.add_argument("n_procs", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("out")
    # no default, as in the port's other entry points: a rank runs on the
    # CPU only where it was asked to
    ap.add_argument("--device", required=True, help="cpu or cuda[:N]")
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--local-shards", type=int, default=2)
    ap.add_argument("--star", action="store_true")
    ap.add_argument("--scale", type=float, default=0.0)
    ap.add_argument("--tables", default=None)
    ap.add_argument("--queries", default=None)
    ap.add_argument("--runs", type=int, default=1)
    args = ap.parse_args(argv)

    import torch
    from quickstep_tpu_torch.parallel import multihost
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{args.device} was asked for and torch finds no "
                         "card")
    multihost.bootstrap(f"127.0.0.1:{args.port}", args.n_procs, args.proc_id,
                        backend=args.backend, device=device)
    rows: dict = {}
    figures: dict = {"process": args.proc_id, "world": args.n_procs,
                     "local_shards": args.local_shards,
                     "device": str(device), "backend": args.backend,
                     "queries": {}, "uploads": {}}
    if device.type == "cuda":
        from quickstep_tpu_torch.ops import cuda
        cuda.reset_launches()
        torch.cuda.init()       # the allocator's statistics need it

    def finish(db):
        figures["uploads"].update(uploads(db))
        db.close()
    from quickstep_tpu_torch import Database
    batteries(lambda cfg: Database(config=cfg, device=device,
                                   mesh_shards=args.local_shards),
              lambda db, fn: fn(db, rows, figures), finish, args.star,
              args.scale, read_tables(args.tables) if args.tables else None,
              [int(q) for q in args.queries.split(",")] if args.queries
              else None, args.runs)
    figures["peak_bytes"] = peak_bytes(figures, device)
    if device.type == "cuda":
        figures["launches"] = dict(cuda.LAUNCHES)
    multihost.barrier()
    with open(f"{args.out}.{args.proc_id}", "wb") as f:
        pickle.dump({"rows": rows, "figures": figures}, f)
    multihost.shutdown()


if __name__ == "__main__":
    main()
