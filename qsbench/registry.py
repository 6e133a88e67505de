"""What BENCHMARK.json declares, and the files the harness finds by name:
a configuration's file (its `file` entry), which names its generator (a
module of qsbench with `SCHEMAS` and `generate(scale, seed, device)`) and
its query set; a traffic mix in traffic/<name>.json; a query set in
queries/<name>.json, which names its reference (a module of qsbench with
`answers(tables, sqls, names, exact)`); and a metric's reader in
metrics/<name>.py, whose `read(run)` returns the metric's value or None
where the run holds nothing to read.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, here: Path = HERE) -> dict:
    return json.loads((here / "traffic" / f"{name}.json").read_text())


def query_set(name: str, here: Path = HERE) -> dict:
    """queries/<name>.json: `queries` (a name to one SQL text), the
    `reference` module that answers them and the `nonempty` names whose
    answers must have rows."""
    return json.loads((here / "queries" / f"{name}.json").read_text())


def queries(name: str, here: Path = HERE) -> Dict[str, str]:
    return query_set(name, here)["queries"]


def module(name: str):
    """The module qsbench/<name>.py (a generator or a reference)."""
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
        raise ValueError(f"not a module name: {name!r}")
    return importlib.import_module(f"qsbench.{name}")


def metrics_of(bench: dict, cell_name: str, kind: str) -> List[dict]:
    """The metrics of `kind` ("end_to_end" or "per_layer") that the cell
    reports: those without a workloads list, and those that list it."""
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]


def reader(name: str, here: Path = HERE) -> Callable:
    """metrics/<name>.py's `read`."""
    path = here / "metrics" / f"{name}.py"
    module = "qsbench_metric_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(defs: List[dict], run, here: Path = HERE
                 ) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of each metric whose reader finds a
    value in `run`."""
    out = {}
    for m in defs:
        value: Optional[float] = reader(m["name"], here)(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
