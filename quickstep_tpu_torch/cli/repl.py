# Copied from quickstep_tpu/cli/repl.py; only the package name in imports and main differ (it takes the device, a device memory budget, and --initialize_db).
"""Interactive SQL shell.

Capability parity with the reference CLI (cli/QuickstepCli.cpp:159-420): multi-line
statement buffering until ';', backslash commands (\\dt, \\d rel, \\analyze, \\q —
cli/Constants.hpp:30-32), per-query timing (display_timing flag), PrintToScreen-style
result tables, SqlError caret formatting, readline history (linenoise analog).
"""

from __future__ import annotations

import sys
import time

from quickstep_tpu_torch.config import Config
from quickstep_tpu_torch.database import Database
from quickstep_tpu_torch.errors import QuickstepError, SqlError


BANNER = """quickstep-tpu shell. Type SQL terminated by ';', \\q to quit."""


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(prog="quickstep_tpu_torch")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the tables live and the operators run "
                    "(the card unless the CPU is asked for)")
    ap.add_argument("--storage_path", default=None,
                    help="catalog/data directory (persisted on \\q)")
    ap.add_argument("--initialize_db", action="store_true",
                    help="start from an empty catalog, even where the "
                    "storage path holds one")
    ap.add_argument("--display_timing", default=True, type=lambda s: s != "false")
    ap.add_argument("--hbm_budget_bytes", default=0, type=int,
                    help="device memory budget: a larger table streams "
                    "through the device in segments (0: no budget)")
    ap.add_argument("-c", "--command", default=None,
                    help="run statements and exit")
    args = ap.parse_args(argv)

    cfg = Config()
    cfg.display_timing = args.display_timing
    cfg.initialize_db = args.initialize_db
    cfg.hbm_budget_bytes = args.hbm_budget_bytes
    if args.storage_path:
        cfg.storage_path = args.storage_path
    db = Database(config=cfg, device=args.device,
                  storage_path=None if cfg.initialize_db
                  else args.storage_path)

    if args.command:
        _run_buffer(db, args.command)
        if args.storage_path:
            db.save()
        db.close()
        return 0

    try:
        import readline  # noqa: F401  (history/editing, linenoise analog)
    except ImportError:
        pass
    print(BANNER)
    buffer = ""
    while True:
        prompt = "quickstep> " if not buffer else "      ...> "
        try:
            line = input(prompt)
        except EOFError:
            break
        except KeyboardInterrupt:
            buffer = ""
            print()
            continue
        stripped = line.strip()
        if not buffer and stripped.startswith("\\"):
            if stripped in ("\\q", "\\quit"):
                break
            _run_buffer(db, stripped)
            continue
        buffer += line + "\n"
        if ";" in line:
            _run_buffer(db, buffer)
            buffer = ""
    if args.storage_path:
        db.save()
    db.close()
    return 0


def _run_buffer(db: Database, sql: str) -> None:
    from quickstep_tpu_torch.parser import parse_statements
    try:
        stmts = parse_statements(sql)
    except SqlError as e:
        print(e.format(sql))
        return
    for stmt in stmts:
        try:
            t0 = time.perf_counter()
            res = db.executor.execute_statement(stmt)
            dt = time.perf_counter() - t0
        except SqlError as e:
            print(e.format(sql))
            continue
        except QuickstepError as e:
            print(f"ERROR: {e}")
            continue
        if res.message:
            print(res.message)
        elif res.rows_affected is not None:
            print(f"{res.rows_affected} rows affected.")
        elif db.config.printing_enabled:
            print(res.to_table())
            print(f"({res.num_rows} rows)")
        if db.config.display_timing:
            print(f"Time: {dt*1000:.2f} ms")


if __name__ == "__main__":
    sys.exit(main())
