"""The port's twins of the scale verification tools: the comparator of
quickstep_tpu_torch/bench/sf_verify.py against tests/test_sf_verify.py's
four cases and against tools/sf_verify.py's source, and an SF0.002 run of
bench/sf_oracle.py (sqlite) then bench/sf_verify.py (the port on the CPU),
each through its command line, that finds all 22 queries row-exact.

At SF0.002 the generator makes 20 suppliers, and partsupp repeats some
(part, supplier) pairs, which the generator's statistics (the tool's)
declare unique; load_tables drops that declaration where the pairs repeat,
so the port runs here on the generator's statistics as loaded."""

import ast
import json
import os

import pytest

from quickstep_tpu_torch.bench import sf_oracle, sf_verify as sfv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = 0.002


def test_xx5_boundary_not_a_mismatch():
    # round(2.675, 2) == 2.67 but round(2.6750000000000003, 2) == 2.68: a
    # comparator that rounds to 2dp calls this a multiset mismatch
    ours = [(1, "a", 2.675), (2, "b", 9.995)]
    oracle = [(2, "b", 9.995000000000001), (1, "a", 2.6750000000000003)]
    assert sfv.compare(0, ours, oracle, ordered=False) is None


def test_real_difference_still_detected():
    ours = [(1, 2.675)]
    oracle = [(1, 2.676)]   # |diff| = 1e-3 > abs_tol
    assert sfv.compare(0, ours, oracle, ordered=False) is not None


def test_multiset_permutation_ok():
    ours = [(2, "y"), (1, "x")]
    oracle = [(1, "x"), (2, "y")]
    assert sfv.compare(0, ours, oracle, ordered=False) is None


def test_ordered_compare_unchanged():
    ours = [(1, 1.0), (2, 2.0)]
    oracle = [(2, 2.0), (1, 1.0)]
    assert sfv.compare(0, ours, oracle, ordered=True) is not None
    assert sfv.compare(0, ours, ours, ordered=True) is None


def _functions(path, names):
    tree = ast.parse(open(path).read())
    return {node.name: ast.dump(node) for node in tree.body
            if isinstance(node, ast.FunctionDef) and node.name in names}


def test_comparator_is_the_tools():
    names = ("_row_eq", "_norm_key", "_multiset_eq", "compare")
    tool = _functions(os.path.join(REPO, "tools", "sf_verify.py"), names)
    twin = _functions(os.path.join(REPO, "quickstep_tpu_torch", "bench",
                                   "sf_verify.py"), names)
    assert set(tool) == set(names) and tool == twin


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """bench/tpch_fullgen.py's tables at SCALE with its statistics, saved as
    a catalog store."""
    from quickstep_tpu_torch import Database
    from quickstep_tpu_torch.bench.tpch_fullgen import generate, load_tables
    path = str(tmp_path_factory.mktemp("sf") / "store")
    db = Database(device="cpu")
    tables, stats, _oracle = generate(SCALE, log=lambda msg: None)
    load_tables(db, tables, stats)
    # the pairs repeat at SCALE, and the loaded statistics say so
    ps = db.catalog.default_database.get_relation("partsupp")
    assert ps.statistics.unique_pairs == []
    db.config.storage_path = path
    db.save()
    db.close()
    return path


def test_sf_oracle_then_sf_verify_all_22(tmp_path, capsys):
    """sqlite over the tables the generator makes at SCALE, then the port
    on the CPU over the same tables with the generator's statistics: 22
    ok."""
    oracle_path = str(tmp_path / "oracle.json")
    out_path = str(tmp_path / "verify.json")
    results = sf_oracle.main([str(SCALE), "--out", oracle_path])
    assert sorted(int(q) for q in results) == list(range(1, 23))
    assert not [q for q, r in results.items() if "error" in r]
    report = sfv.main([str(SCALE), "--device", "cpu",
                       "--oracle", oracle_path, "--out", out_path])
    bad = {q: r for q, r in report.items() if r["status"] != "ok"}
    assert not bad
    with open(out_path) as f:
        written = json.load(f)
    assert written["ok"] == 22 and written["device"] == "cpu"
    assert "# 22/22 row-exact at SF0.002 on cpu" in capsys.readouterr().out


def test_sf_verify_reports_a_mismatch(store, tmp_path):
    """A wrong oracle row is reported as a MISMATCH of that query alone;
    sqlite over the store's tables."""
    from quickstep_tpu_torch import Database
    conn = sf_oracle.sqlite_from_tables(sf_oracle.read_tables(SCALE, store),
                                        log=lambda msg: None)
    oracle = sf_oracle.run_queries(conn, [1, 6], log=lambda msg: None)
    first = list(oracle["1"]["rows"][0])
    first[-1] += 1                          # Q1's count_order
    oracle["1"]["rows"][0] = first
    db = Database(storage_path=store, device="cpu")
    report = sfv.verify(db, oracle, [1, 6, 14], log=lambda msg: None)
    db.close()
    assert report[1]["status"].startswith("MISMATCH: row 0")
    assert report[6]["status"] == "ok"
    assert report[14] == {"status": "no-oracle"}
