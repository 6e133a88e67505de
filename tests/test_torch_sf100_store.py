"""The port's on-disk TPC-H store writer and its verifier, against the
reference's tools: bench/sf100_fullgen.py writes tools/sf100_fullgen.py's
store file by file, a run stopped after a completed chunk resumes to the
same store as one that never stopped, and bench/sf100_full_verify.py finds
the eleven oracle queries of a store ok with lineitem streamed in
segments, skips them on a rerun, and exits non-zero on a wrong row."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from test_torch_imports import RUN_FULLGEN_TOOL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# three chunks of orders at each scale: 3,000 orders at SF0.002, 15,000 at
# SF0.01
SCALE, CHUNK_ORDERS = 0.002, 1000
# the verifier's store: at SF0.002 no supplier is French, and the oracle's
# Q7 keeps FRANCE -> GERMANY rows of revenue 0 that no GROUP BY returns
VERIFY_SCALE, VERIFY_CHUNK_ORDERS = 0.01, 5000
# a device memory budget (GiB) under which every query that streams
# lineitem at VERIFY_SCALE runs it in at least 6 segments
VERIFY_BUDGET_GB = 0.0005
QUERIES = (6, 1, 12, 14, 19, 4, 3, 5, 7, 10, 18)
TABLES = ("region", "nation", "supplier", "part", "partsupp", "customer",
          "orders", "lineitem")

# the copy, stopped by the first line that says a chunk is complete (that
# line follows the chunk's flush and its _gen_state.pkl)
STOP_AFTER_FIRST_CHUNK = textwrap.dedent("""
    import builtins, runpy, sys
    real_print = builtins.print
    def print_then_stop(*args, **kwargs):
        real_print(*args, **kwargs)
        if args and " chunk 1/" in str(args[0]):
            raise SystemExit(3)
    builtins.print = print_then_stop
    sys.argv = ["sf100_fullgen", *sys.argv[1:]]
    runpy.run_module("quickstep_tpu_torch.bench.sf100_fullgen",
                     run_name="__main__")
""")


def _start(args, cwd, tmpdir):
    env = dict(os.environ, PYTHONPATH=REPO, TMPDIR=str(tmpdir))
    return subprocess.Popen([sys.executable, *args], cwd=str(cwd), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _finish(proc, want_rc=0):
    out, _ = proc.communicate(timeout=300)
    assert proc.returncode == want_rc, out
    return out


def _copy_args(scale, chunk_orders, outdir):
    return ["-m", "quickstep_tpu_torch.bench.sf100_fullgen", str(scale),
            str(chunk_orders), str(outdir)]


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Directories of: the tool's store and the copy's at SCALE; the
    copy's at VERIFY_SCALE, uninterrupted and stopped after its first
    chunk then run again; and the _gen_state.pkl the stopped run left."""
    root = tmp_path_factory.mktemp("sf100_store")
    tmp = root / "tmp"
    tmp.mkdir()
    d = {name: root / name for name in ("tool", "copy", "whole", "resumed")}
    d["tool"].mkdir()
    first = [
        _start(["-c", RUN_FULLGEN_TOOL,
                os.path.join(REPO, "tools", "sf100_fullgen.py"), str(SCALE),
                str(CHUNK_ORDERS), str(d["tool"])], d["tool"], tmp),
        _start(_copy_args(SCALE, CHUNK_ORDERS, d["copy"]), root, tmp),
        _start(["-c", STOP_AFTER_FIRST_CHUNK, str(VERIFY_SCALE),
                str(VERIFY_CHUNK_ORDERS), str(d["resumed"])], root, tmp)]
    outs = [_finish(p, rc) for p, rc in zip(first, (0, 0, 3))]
    assert " chunk 1/3:" in outs[2] and " chunk 2/3" not in outs[2], outs[2]
    state = (d["resumed"] / "_gen_state.pkl").read_bytes()
    assert not (d["resumed"] / "oracle.json").exists()
    # the copy's second copy of the oracle, in the temporary directory
    oracle_copy = (tmp / "sf100_full_oracle.json").read_bytes()
    second = [
        _start(_copy_args(VERIFY_SCALE, VERIFY_CHUNK_ORDERS, d["whole"]),
               root, tmp),
        _start(_copy_args(VERIFY_SCALE, VERIFY_CHUNK_ORDERS, d["resumed"]),
               root, tmp)]
    outs = [_finish(p) for p in second]
    assert "resuming at chunk 1" in outs[1], outs[1]
    d["state"], d["oracle_copy"] = state, oracle_copy
    return d


def _files(top):
    """{path relative to top: bytes} of every file under top."""
    out = {}
    for dirpath, _dirs, names in os.walk(top):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, top)] = f.read()
    return out


@pytest.mark.parametrize("part", ("catalog.json", "oracle.json") + TABLES)
def test_copy_writes_the_tools_store(stores, part):
    """Each table's .npy and .dict.json files, catalog.json and oracle.json
    of the copy's store are the tool's, byte for byte."""
    if part.endswith(".json"):
        copy = (stores["copy"] / part).read_bytes()
        assert copy == (stores["tool"] / part).read_bytes()
        if part == "oracle.json":
            assert stores["oracle_copy"] == copy
            assert set(json.loads(copy)) >= {f"q{q}" for q in QUERIES}
        return
    tool = _files(stores["tool"] / "default" / part)
    copy = _files(stores["copy"] / "default" / part)
    assert sorted(copy) == sorted(tool)
    assert any(name.endswith(".dict.json") for name in tool)
    for name, data in tool.items():
        assert copy[name] == data, (part, name)


def test_copy_leaves_only_the_store(stores):
    assert sorted(_files(stores["copy"])) == sorted(
        name for name in _files(stores["tool"]) if name != "oracle_copy.json")
    assert not (stores["copy"] / "_gen_state.pkl").exists()


def test_stopped_run_resumes_to_the_same_store(stores):
    """The run stopped after its first chunk, run again with the same
    arguments, writes the store an uninterrupted run writes."""
    import pickle
    assert pickle.loads(stores["state"])["done_chunks"] == 1
    whole, resumed = _files(stores["whole"]), _files(stores["resumed"])
    assert sorted(resumed) == sorted(whole)
    assert len([n for n in whole if n.endswith(".npy")]) == 61
    for name, data in whole.items():
        assert resumed[name] == data, name


def _linked_store(src, dst, oracle=None):
    """A store at dst that reads src's columns through a link, with src's
    catalog.json and its oracle, or `oracle`: what the verifier writes
    beside them (learned overrides) stays out of src."""
    dst.mkdir()
    (dst / "default").symlink_to(src / "default")
    (dst / "catalog.json").write_bytes((src / "catalog.json").read_bytes())
    if oracle is None:
        oracle = json.loads((src / "oracle.json").read_text())
    (dst / "oracle.json").write_text(json.dumps(oracle))
    return dst


def _verify(store, out, *args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", "quickstep_tpu_torch.bench.sf100_full_verify",
         str(store), str(VERIFY_BUDGET_GB), *args, str(out), "--device",
         "cpu"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)


def test_verifier_finds_every_query_ok_streamed_and_skips_on_rerun(
        stores, tmp_path):
    store = _linked_store(stores["whole"], tmp_path / "store")
    out = tmp_path / "verify.json"
    qlist = ",".join(map(str, QUERIES))
    proc = _verify(store, out, qlist)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(out.read_text())
    assert report["all_ok"] is True
    assert sorted(report["queries"]) == sorted(map(str, QUERIES))
    streamed = []
    for q, rec in report["queries"].items():
        assert rec["ok"] is rec["ok_cold"] is rec["ok_warm"] is True, (q, rec)
        for run in ("cold", "warm"):
            figures = rec["runs"][run]
            assert figures["ms"] > 0 and figures["host_rss_bytes"] > 0
            assert figures["peak_device_bytes"] is None   # on the CPU
            if figures["segments"]:
                assert figures["segments_run"] >= 2, (q, figures)
                assert figures["bytes_streamed"] > 0, (q, figures)
        if rec["runs"]["warm"]["segments"]:
            streamed.append(int(q))
    # every query but Q18 (lineitem's two columns fit half the budget)
    # streams lineitem
    assert sorted(streamed) == sorted(q for q in QUERIES if q != 18)
    again = _verify(store, out, qlist)
    assert again.returncode == 0, again.stdout + again.stderr
    assert again.stdout.count("already ok, skipping") == len(QUERIES)
    assert json.loads(out.read_text())["queries"] == report["queries"]


def test_verifier_exits_nonzero_on_a_wrong_oracle_row(stores, tmp_path):
    """A store whose oracle holds a wrong Q6 row: Q6 is not ok, Q1 still
    is, and the process exits with 1."""
    oracle = json.loads((stores["whole"] / "oracle.json").read_text())
    oracle["q6"] = [[oracle["q6"][0][0] + 1.0]]
    store = _linked_store(stores["whole"], tmp_path / "store", oracle)
    out = tmp_path / "verify.json"
    proc = _verify(store, out, "6,1")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    report = json.loads(out.read_text())
    assert report["all_ok"] is False
    assert report["queries"]["6"]["ok"] is False
    assert report["queries"]["6"]["ok_cold"] is False
    assert report["queries"]["6"]["ok_warm"] is False
    assert report["queries"]["1"]["ok"] is True
    assert "Q6 cold row mismatch" in proc.stdout
    assert "Q6 warm row mismatch" in proc.stdout


class _TwoRunDatabase:
    """A stand-in for the port's Database on the CPU whose first execute
    returns `first` and every later one `later`."""

    def __init__(self, first, later):
        import types
        import torch
        self.device = torch.device("cpu")
        self.executor = types.SimpleNamespace(last_stream_info=None)
        self.results = [first, later]

    def execute(self, sql):
        import types
        rows = self.results[0]
        if len(self.results) > 1:
            self.results.pop(0)
        return types.SimpleNamespace(rows=rows)


@pytest.mark.parametrize("wrong", ["cold", "warm", "count"])
def test_check_query_holds_each_run_to_the_oracle(wrong, capsys):
    """A query is ok only when the rows of its cold run and of its warm
    run both match the oracle: a wrong value or a missing row in either
    run makes it not ok, and the record says which run was wrong."""
    from quickstep_tpu_torch.bench import sf100_full_verify as V
    want = [[1.5, "A"], [2.0, "B"]]
    bad = [[1.5, "A"], [2.5, "B"]] if wrong != "count" else want[:1]
    first, later = (want, bad) if wrong == "warm" else (bad, want)
    rec = V.check_query(_TwoRunDatabase(first, later), 6, want)
    assert rec["ok"] is False
    assert rec["ok_cold"] is (wrong == "warm")
    assert rec["ok_warm"] is (wrong != "warm")
    run = "warm" if wrong == "warm" else "cold"
    assert f"Q6 {run} row" in capsys.readouterr().out
    good = V.check_query(_TwoRunDatabase(want, want), 6, want)
    assert good["ok"] is good["ok_cold"] is good["ok_warm"] is True


def test_q1_charge_sum_takes_float64_from_the_store_statistics(stores,
                                                               tmp_path):
    """SF100's Q1 sum_charge passes 2^63 units, so the resolver's guard
    reads the store's exact statistics (catalog.json) and sums it in
    float64. Here l_extendedprice's recorded maximum is raised to 2^40 so
    that VERIFY_SCALE's 60 K rows give the same bound: the guard takes
    float64 for sum_charge alone, and Q1, streamed in segments whose
    partial sums are merged, still matches the oracle by the verifier's
    rule."""
    from quickstep_tpu_torch.bench import sf100_full_verify as V
    from quickstep_tpu_torch.bench.tpch import TPCH_QUERIES, with_tiebreak
    from quickstep_tpu_torch.types import TypeID
    sql = with_tiebreak(1, TPCH_QUERIES[1])
    db = V.open_store(str(_linked_store(stores["whole"], tmp_path / "as_is")),
                      0, "cpu")
    try:
        as_is = db.execute(sql)
    finally:
        db.close()
    # the store as written: every sum fits int64 and stays exact
    assert all(t.type_id == TypeID.DECIMAL for n, t in
               zip(as_is.column_names, as_is.types) if n.startswith("sum_"))
    store = _linked_store(stores["whole"], tmp_path / "store")
    catalog = json.loads((store / "catalog.json").read_text())
    stats = catalog["databases"]["default"]["relations"]["lineitem"]["stats"]
    assert stats["exact"] and stats["max_values"]["l_extendedprice"] < 2**31
    stats["max_values"]["l_extendedprice"] = 2**40
    (store / "catalog.json").write_text(json.dumps(catalog))
    db = V.open_store(str(store), VERIFY_BUDGET_GB * 2**30, "cpu")
    try:
        res = db.execute(sql)
        info = db.executor.last_stream_info
    finally:
        db.close()
    types = dict(zip(res.column_names, res.types))
    assert types["sum_charge"].type_id == TypeID.DOUBLE
    assert all(types[c].type_id == TypeID.DECIMAL for c in
               ("sum_qty", "sum_base_price", "sum_disc_price"))
    assert info["segments_run"] >= 2 and info["mode"] == "merge"
    want = json.loads((store / "oracle.json").read_text())["q1"]
    assert len(res.rows) == len(want)
    for got, row in zip(res.rows, want):
        assert V.row_eq(list(got), row), (got, row)
