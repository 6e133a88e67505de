"""A configuration, a traffic mix, a query set, a generator, a reference
and a metric dropped in as new files, with their entries in
BENCHMARK.json, are found by name."""

import json
import shutil
import types

import pytest

from qsbench import registry


def test_new_files_are_found_by_name(tmp_path):
    here = tmp_path / "qsbench"
    shutil.copytree(registry.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = registry.benchmark()
    (here / "configs" / "tpch-sf1.json").write_text(json.dumps(
        dict(registry.config(bench, "tpch-sf10"), name="tpch-sf1",
             scale_factor=1, queries="two")))
    (here / "queries" / "two.json").write_text(json.dumps(
        {"reference": "reference", "nonempty": ["q1"],
         "queries": {"q6": "select 6", "q1": "select 1"}}))
    (here / "traffic" / "pair.json").write_text(json.dumps(
        {"sessions": [{"name": "a", "order": ["q6"]},
                      {"name": "b", "order": ["q1"]}]}))
    (here / "metrics" / "twice.qps.py").write_text(
        "def read(run):\n    return 2 * run.value\n")
    bench["configs"].append({"name": "tpch-sf1", "source": "s",
                             "file": "qsbench/configs/tpch-sf1.json",
                             "reduced": ["scale_factor"], "why": "w"})
    bench["workloads"].append({"name": "sf1.pair", "config": "tpch-sf1",
                               "traffic": "pair", "chips": 1, "why": "w"})
    bench["per_layer"].append({"name": "twice.qps", "unit": "queries/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "qps",
                               "workloads": ["sf1.pair"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    bench = registry.benchmark(tmp_path)
    cell = registry.cell(bench, "sf1.pair")
    config = registry.config(bench, cell["config"], tmp_path)
    assert config["scale_factor"] == 1
    mix = registry.traffic(cell["traffic"], here)
    assert [s["name"] for s in mix["sessions"]] == ["a", "b"]
    assert registry.queries(config["queries"], here)["q1"] == "select 1"
    assert registry.query_set(config["queries"], here)["nonempty"] == ["q1"]
    defs = registry.metrics_of(bench, "sf1.pair", "per_layer")
    assert [m["name"] for m in defs] == ["twice.qps"]
    got = registry.read_metrics(defs, types.SimpleNamespace(value=3),
                                here)
    assert got == {"twice.qps": {"value": 6, "unit": "queries/s"}}
    # the cells already there keep their metrics
    assert "twice.qps" not in {
        m["name"] for m in registry.metrics_of(bench, "tpch10-power",
                                               "per_layer")}


def test_a_metric_with_nothing_to_read_is_left_out():
    defs = [{"name": "upload_share", "unit": "%"}]
    run = types.SimpleNamespace(spans=None)
    assert registry.read_metrics(defs, run) == {}


def test_generator_and_reference_are_found_by_name():
    bench = registry.benchmark()
    for c in bench["configs"]:
        config = registry.config(bench, c["name"])
        gen = registry.module(config["generator"])
        assert callable(gen.generate) and gen.SCHEMAS
        ref = registry.module(registry.query_set(config["queries"])[
            "reference"])
        assert callable(ref.answers)
    with pytest.raises(ValueError):
        registry.module("../run")
