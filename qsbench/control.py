"""The control of the comparison that decides `correct`: the reference put
in the program's place and computed in float32 (qsbench/reference.py with
exact=False), one precision below the float64 of the configuration's
DOUBLE results and the exact integers of its DECIMALs, judged by
qsbench/compare.py against the exact reference. It must come out as not
correct.

    python -m qsbench.control --config tpch-sf10 --seeds 11 12 13

prints, for each seed, one JSON line: each number compared beside its
limit, and whether the control passed (it must not). The tables are made
at the configuration's scale on the card (--device cpu and --scale for a
small rehearsal).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from qsbench import compare, gen, registry


def control_checks(tables: gen.Tables, query_set: dict) -> dict:
    """The numbers compared when the float32 reference answers every query
    of `query_set` (a queries/<name>.json) once."""
    reference = registry.module(query_set["reference"])
    sqls = query_set["queries"]
    want = reference.answers(tables, sqls)
    got = reference.answers(tables, sqls, exact=False)
    return compare.judge(got.items(), want, 0, query_set["nonempty"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--scale", type=float, default=None)
    args = p.parse_args(argv)
    config = registry.config(registry.benchmark(), args.config)
    generator = registry.module(config["generator"])
    query_set = registry.query_set(config["queries"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        tables = generator.generate(args.scale or config["scale_factor"],
                                    seed, args.device)
        checks = control_checks(tables, query_set)
        del tables
        if args.device != "cpu":
            torch.cuda.empty_cache()
        print(json.dumps({"seed": seed, "config": args.config,
                          "control_passed": compare.passed(checks),
                          "seconds": time.perf_counter() - t0,
                          "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
