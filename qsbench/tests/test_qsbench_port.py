"""The harness's comparison with the port, run on the CPU at SF0.01: each
of the 22 answers of quickstep_tpu_torch.Database(device="cpu") against
the reference, then whole runs of each cell through qsbench.run."""

import time

import pytest

from qsbench import compare, gen, load, reference, registry, run

SCALE = 0.01


@pytest.fixture(scope="module")
def port():
    from quickstep_tpu_torch import Database
    tables = gen.generate(SCALE, 77)
    db = Database(device="cpu")
    load.load(db, tables, load.host_columns(tables), load.statistics(tables),
              gen.SCHEMAS)
    yield db, reference.answers(tables, registry.queries("tpch-sf10"))
    db.close()


@pytest.mark.parametrize("q", [f"q{i}" for i in range(1, 23)])
def test_port_answer_matches_reference(port, q):
    db, want = port
    rows = db.execute(registry.queries("tpch-sf10")[q]).rows
    wrong, gap = compare.answer_gap(rows, want[q])
    assert not wrong, (rows[:3], want[q][:3])
    assert gap <= compare.LIMITS["max_rel_gap"]


def test_columns_handed_over_are_read_only():
    tables = gen.generate(SCALE, 78)
    host = load.host_columns(tables)
    assert not any(a.flags.writeable for cols in host.values()
                   for a in cols.values())


@pytest.mark.parametrize("cell,traced", [("tpch10-power", False),
                                         ("tpch10-power", True),
                                         ("tpch10-oc", True),
                                         ("tpch10-tput", False),
                                         ("tpch10-tput", True)])
def test_a_whole_run_on_the_cpu(cell, traced):
    bench = registry.benchmark()
    r = run.execute_cell(cell, 2**33 + 5, 1.5, traced, device="cpu",
                         scale=SCALE, t_start=time.perf_counter())
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    assert list(r["checks"]) == list(compare.LIMITS)
    kind = "per_layer" if traced else "end_to_end"
    names = {m["name"] for m in registry.metrics_of(bench, cell, kind)}
    # on the CPU no device metric is read
    device_metrics = {"roofline_share", "roofline_share.tput",
                      "kernel_ms_per_stream"}
    assert set(r["metrics"]) <= names
    assert names - device_metrics - set(r["metrics"]) <= (
        {"upload_share"} if traced else set())
    for m in r["metrics"].values():
        assert m["value"] is not None and m["unit"]
    if traced:
        assert r["device"]["window_s"] == 1.5 and "breakdown" in r
