"""Phase 7's queries in two checkouts, one after the other, on one machine:
what each checkout's multi-process mesh gathers and how long it takes.

    python -m quickstep_tpu_torch.bench.multihost_ab
        --roots build/parent,.,.,build/parent [--scale 10]
        [--queries 4,16,20,21,22] [--runs 2] [--local-shards 4]
        [--device cuda:0 | cpu] [--out DIR]

Generates the TPC-H tables at --scale with bench/tpch_fullgen.py (seeded,
with the exact oracles of the queries asked for) and writes them once as
.npy files (bench/multihost_run.py write_tables) under build/multihost_ab;
meanwhile each checkout builds its kernels. Then, for each root of
--roots in turn, starts two bench/multihost_run.py workers of that
checkout (each root's own worker, so an older checkout is measured as it
was), which memory-map the tables and run --queries --runs times on a mesh
of 2 x --local-shards shards of --device through gloo. Every run's rows
are held to the oracle and to the first root's rows bit for bit. Prints
the card's name and power limit, then one JSON line for each root, process
and query: the cold run's gathered bytes and each gather's reason, the
bytes each collective sent, the ms and retries of every run; writes every
worker's log under --out. Exits non-zero if a worker fails or a row
differs.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import pickle
import shutil
import socket
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
WORKERS = 2
TIMEOUT_S = 900


def card_line() -> str:
    """nvidia-smi's name and power limit of the card, or why there is none."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def build_kernels(roots) -> list:
    """One process a checkout building its kernels (ops/cuda.py build into
    its own build/kernels), started now; the caller waits for them."""
    code = "from quickstep_tpu_torch.ops import cuda; cuda.build()"
    return [subprocess.Popen([sys.executable, "-c", code], cwd=str(r),
                             env=dict(os.environ, PYTHONPATH=str(r)))
            for r in roots]


def run_root(root: pathlib.Path, args, tables: str, out: str):
    """The two workers of the checkout at root; returns their results
    (multihost_run.py's pickles)."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(root),
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    worker = root / "quickstep_tpu_torch" / "bench" / "multihost_run.py"
    procs, logs = [], [f"{out}.{i}.log" for i in range(WORKERS)]
    for i, log in enumerate(logs):
        with open(log, "wb") as f:
            procs.append(subprocess.Popen(
                [sys.executable, str(worker), str(i), str(WORKERS), str(port),
                 out, "--device", args.device, "--backend", "gloo",
                 "--local-shards", str(args.local_shards), "--tables", tables,
                 "--queries", args.queries, "--runs", str(args.runs)],
                cwd=str(root), env=env, stdout=f, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        if p.returncode:
            with open(log, errors="replace") as f:
                raise SystemExit(f"{root}: a worker failed "
                                 f"({p.returncode}):\n{f.read()[-3000:]}")
    results = []
    for i in range(WORKERS):
        with open(f"{out}.{i}", "rb") as f:
            results.append(pickle.load(f))
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", required=True,
                    help="checkouts in the order they run, comma-separated")
    ap.add_argument("--scale", type=float, default=10.0)
    ap.add_argument("--queries", default="4,16,20,21,22")
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--local-shards", type=int, default=4)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "multihost_ab_logs"))
    args = ap.parse_args(argv)
    import torch
    from quickstep_tpu_torch.bench.multihost_run import write_tables
    from quickstep_tpu_torch.bench.tpch_fullgen import (
        check_rows, extra_oracles, generate)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(f"{args.device} was asked for and torch finds no "
                         "card")
    roots = [(ROOT / r).resolve() for r in args.roots.split(",")]
    numbers = [int(q) for q in args.queries.split(",")]
    builds = build_kernels(sorted(set(roots))) \
        if args.device.startswith("cuda") else []
    work = ROOT / "build" / "multihost_ab"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    # the workers run in their own checkouts: every path they get is whole
    args.out = os.path.abspath(args.out)
    os.makedirs(args.out, exist_ok=True)
    try:
        t0 = time.perf_counter()
        tables, stats, oracle = generate(args.scale, log=lambda msg: None)
        oracle.update(extra_oracles(tables))
        write_tables(str(work / "tables"), tables, stats)
        del tables
        print(f"tables and oracles at SF{args.scale:g} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if any(p.wait() for p in builds):
            raise SystemExit("a checkout's kernels did not build")
        print(card_line(), flush=True)
        first = None
        for k, root in enumerate(roots):
            t0 = time.perf_counter()
            results = run_root(root, args, str(work / "tables"),
                               os.path.join(args.out, f"run{k}"))
            for res in results:
                fig = res["figures"]
                for q in numbers:
                    name = f"Q{q}"
                    for rows in res["rows"][name]:
                        check_rows(q, rows, oracle)
                    if first is None:
                        first = res["rows"]
                    if res["rows"][name][0] != first[name][0]:
                        raise SystemExit(f"{root} {name}: its rows differ "
                                         "from the first root's")
                    qf = fig["queries"][name]
                    info = qf["mesh"][0]
                    print(json.dumps({
                        "root": str(root), "order": k,
                        "process": fig["process"], "query": name,
                        "gathered_bytes": sum(g["bytes"]
                                              for g in info["gathers"]),
                        "gathers": [[g["from"], g["into"], g["why"],
                                     g["bytes"]] for g in info["gathers"]],
                        "collectives": {c: v["bytes"] for c, v in
                                        info["collectives"].items()},
                        "ms": qf["ms"], "retries": qf["retries"]}),
                        flush=True)
            print(f"{root}: both workers in {time.perf_counter() - t0:.1f} "
                  "s; every row matches the oracle", flush=True)
    finally:
        for p in builds:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
