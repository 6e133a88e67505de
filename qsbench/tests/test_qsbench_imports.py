"""Nothing under qsbench/ imports JAX or the JAX package, and the
reference's files import nothing of the program either: each module's
top-level name (the part before the first dot) compared whole, since
quickstep_tpu_torch begins with quickstep_tpu. And BENCHMARK.json keeps
to the form the benchmark's contract sets."""

import ast
import json
import re

import pytest

from qsbench import registry

FORBIDDEN = {"jax", "jaxlib", "flax", "quickstep_tpu"}
# the reference and what it reads: the generator, the comparison, the
# control and the registry of names
REFERENCE_FILES = {"gen.py", "reference.py", "compare.py", "control.py",
                   "registry.py"}
SOURCES = sorted(p for p in registry.HERE.rglob("*.py")
                 if "__pycache__" not in p.parts)


def top_level_imports(path):
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(registry.HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", sorted(REFERENCE_FILES))
def test_the_reference_imports_nothing_of_the_program(name):
    assert "quickstep_tpu_torch" not in top_level_imports(
        registry.HERE / name)


def test_whole_names_not_prefixes():
    assert "quickstep_tpu_torch".split(".")[0] not in FORBIDDEN


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_benchmark_json_form():
    bench = registry.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((registry.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert bench["paths"] == ["qsbench"]
    assert all(_line(w) for w in bench["command"])
    assert 1 <= bench["run_seconds"] <= 51
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("qsbench/")
        assert all(NAME.match(k) for k in c["reduced"])
        assert json.loads((registry.ROOT / c["file"]).read_text())[
            "reduced"] == c["reduced"]
        names.add(c["name"])
    cells = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names
        assert _line(w["why"]) and w["chips"] in (1, 4)
        assert (registry.HERE / "traffic" / f"{w['traffic']}.json").exists()
        cells.add(w["name"])
    e2e = {}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        e2e[m["name"]] = set(m.get("workloads", cells))
    assert "setup_s" in e2e
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _line(m["layer"]) and m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= e2e[m["moves"]]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (registry.HERE / "metrics" / f"{m['name']}.py").exists()
    for cell in cells:
        assert len(registry.metrics_of(bench, cell, "end_to_end")) >= 2
        assert registry.metrics_of(bench, cell, "per_layer")
