"""quickstep_tpu_torch stands alone: it runs without JAX and without
quickstep_tpu, chip_smoke.py refuses to run without a card, and the copied
TPC-H generators make the same data (and oracle) as the reference's."""

import json
import os
import shutil
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

Q6_WITHOUT_JAX = textwrap.dedent("""
    import math, sys
    sys.modules["jax"] = None          # any `import jax` now fails
    from quickstep_tpu_torch import Database
    from quickstep_tpu_torch.bench.lineitem_gen import load_lineitem
    from quickstep_tpu_torch.bench.tpch import TPCH_QUERIES
    db = Database(device="cpu")
    _rel, oracle = load_lineitem(db, 250 / 1_500_000)
    assert 900 <= oracle["rows"] <= 1100, oracle["rows"]
    (got,), = db.execute(TPCH_QUERIES[6]).rows
    assert math.isclose(got, oracle["q6"], rel_tol=1e-12), (got, oracle)
    db.close()
    bad = [m for m, mod in sys.modules.items() if mod is not None and (
           m == "jax" or m.startswith("jax.")
           or m == "quickstep_tpu" or m.startswith("quickstep_tpu."))]
    assert not bad, bad
    print("Q6 OK", oracle["rows"], got)
""")


JOINS_WITHOUT_JAX = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None          # any `import jax` now fails
    from quickstep_tpu_torch import Database
    from quickstep_tpu_torch.bench.tpch import TPCH_QUERIES, load_tpch
    db = Database(device="cpu")
    load_tpch(db, 0.002, 0)
    for q in (3, 4, 5, 10):
        rows = db.execute(TPCH_QUERIES[q]).rows
        assert rows and db.executor.host_syncs == 1, (q, rows)
    # the expansion join, run statistics, DISTINCT, WITH and subqueries
    for q in (9, 11, 15, 16, 18, 20, 21, 22):
        db.execute(TPCH_QUERIES[q])
        db.execute(TPCH_QUERIES[q])
        assert db.executor.host_syncs == 1, q
    db.close()
    bad = [m for m, mod in sys.modules.items() if mod is not None and (
           m == "jax" or m.startswith("jax.")
           or m == "quickstep_tpu" or m.startswith("quickstep_tpu."))]
    assert not bad, bad
    print("JOINS OK")
""")

DML_AND_OPERATORS_WITHOUT_JAX = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None          # any `import jax` now fails
    import quickstep_tpu_torch.bench.golden_corpus
    import quickstep_tpu_torch.bench.zero_rows
    import quickstep_tpu_torch.ops.sort
    import quickstep_tpu_torch.utils.visualize
    from quickstep_tpu_torch import Database
    from quickstep_tpu_torch.utils.golden import run_golden_file
    from quickstep_tpu_torch.utils.testdb import load_test_relation
    for name in ("Insert", "Update", "Delete", "Copy", "Union", "Distinct",
                 "TableGenerator", "LIP"):
        db = Database(device="cpu")
        load_test_relation(db)
        failures = run_golden_file(f"tests/golden/reference/{name}.test", db)
        assert not failures, failures[0]
        db.close()
    # the differential battery's generator, loader and a share of its
    # queries, and the smoke that runs it on the card
    import chip_smoke
    from quickstep_tpu_torch.bench import differential as D
    db = Database(device="cpu")
    D.load_tables(db, D.make_database(6))
    for query in D.rotation(6, D.queries(6))[:4]:
        D.run_query(db, query)
    db.close()
    bad = [m for m, mod in sys.modules.items() if mod is not None and (
           m == "jax" or m.startswith("jax.")
           or m == "quickstep_tpu" or m.startswith("quickstep_tpu."))]
    assert not bad, bad
    print("DML OK")
""")

MESH_WITHOUT_JAX = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None          # any `import jax` now fails
    import quickstep_tpu_torch.parallel.dist
    import quickstep_tpu_torch.parallel.mesh
    import quickstep_tpu_torch.parallel.shuffle
    import quickstep_tpu_torch.storage.native_io
    from quickstep_tpu_torch import Database
    from quickstep_tpu_torch.bench.tpch import TPCH_QUERIES, load_tpch
    from quickstep_tpu_torch.config import Config
    cfg = Config()
    cfg.distributed = True
    cfg.replicate_threshold_rows = 1000
    db = Database(config=cfg, device="cpu", mesh_shards=8)
    load_tpch(db, 0.002, 0)
    for q in (3, 9):
        assert db.execute(TPCH_QUERIES[q]).rows, q
        assert any(k.startswith("shuffle_overflow")
                   for k in db.executor.last_flags), q
    db.close()
    bad = [m for m, mod in sys.modules.items() if mod is not None and (
           m == "jax" or m.startswith("jax.")
           or m == "quickstep_tpu" or m.startswith("quickstep_tpu."))]
    assert not bad, bad
    print("MESH OK")
""")

SF_TWINS_WITHOUT_JAX = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None          # any `import jax` now fails
    from quickstep_tpu_torch import Database
    from quickstep_tpu_torch.bench import sf_oracle, sf_verify
    from quickstep_tpu_torch.bench.tpch import load_tpch
    db = Database(device="cpu")
    data = load_tpch(db, 0.002, 0)
    conn = sf_oracle.sqlite_from_tables(data, log=lambda msg: None)
    oracle = sf_oracle.run_queries(conn, [1, 3, 6, 13], log=lambda msg: None)
    report = sf_verify.verify(db, oracle, log=lambda msg: None)
    db.close()
    assert [q for q, r in report.items() if r["status"] == "ok"] == \
        [1, 3, 6, 13], report
    bad = [m for m, mod in sys.modules.items() if mod is not None and (
           m == "jax" or m.startswith("jax.")
           or m == "quickstep_tpu" or m.startswith("quickstep_tpu."))]
    assert not bad, bad
    print("SF TWINS OK")
""")

OUT_OF_CORE_WITHOUT_JAX = textwrap.dedent("""
    import io, sys
    from contextlib import redirect_stdout
    sys.modules["jax"] = None          # any `import jax` now fails
    import quickstep_tpu_torch.cli
    import quickstep_tpu_torch.cli.network
    import quickstep_tpu_torch.cli.repl
    import quickstep_tpu_torch.exec.streaming
    import quickstep_tpu_torch.storage.eviction
    from quickstep_tpu_torch import Database
    from quickstep_tpu_torch.bench.tpch import TPCH_QUERIES, load_tpch
    from quickstep_tpu_torch.config import Config
    db = Database(config=Config(hbm_budget_bytes=300_000), device="cpu")
    load_tpch(db, 0.002, 0)
    for q in (1, 3, 6):
        assert db.execute(TPCH_QUERIES[q]).rows, q
        assert db.executor.last_stream_info["segments_run"] > 1, q
    db.close()
    out = io.StringIO()
    with redirect_stdout(out):
        quickstep_tpu_torch.cli.repl.main(
            ["--device", "cpu", "-c", "SELECT 6 * 7;"])
    assert "42" in out.getvalue(), out.getvalue()
    bad = [m for m, mod in sys.modules.items() if mod is not None and (
           m == "jax" or m.startswith("jax.")
           or m == "quickstep_tpu" or m.startswith("quickstep_tpu."))]
    assert not bad, bad
    print("OUT OF CORE OK")
""")

MULTIHOST_WITHOUT_JAX = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None          # any `import jax` now fails
    import quickstep_tpu_torch.parallel.multihost
    import quickstep_tpu_torch.transaction
    from quickstep_tpu_torch.bench import multihost_run
    multihost_run.main(sys.argv[1:])
    bad = [m for m, mod in sys.modules.items() if mod is not None and (
           m == "jax" or m.startswith("jax.")
           or m == "quickstep_tpu" or m.startswith("quickstep_tpu."))]
    assert not bad, bad
    print("MULTIHOST OK")
""")

LOCAL_MESH_WITHOUT_JAX = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None          # any `import jax` now fails
    import quickstep_tpu_torch.parallel.local_group
    from quickstep_tpu_torch.bench import multihost_run
    members = multihost_run.run_members(["cpu", "cpu"], 2, star=True)
    assert [m["rows"]["groupby"] for m in members] == \
        [members[0]["rows"]["groupby"]] * 2
    bad = [m for m, mod in sys.modules.items() if mod is not None and (
           m == "jax" or m.startswith("jax.")
           or m == "quickstep_tpu" or m.startswith("quickstep_tpu."))]
    assert not bad, bad
    print("LOCAL MESH OK")
""")

SF100_TOOLS_WITHOUT_JAX = textwrap.dedent("""
    import os, sys
    sys.modules["jax"] = None          # any `import jax` now fails
    from quickstep_tpu_torch.bench import (sf100_campaign, sf100_full_verify,
                                           sf100_fullgen)
    out = sys.argv[1]
    sys.argv = ["sf100_fullgen", "0.002", "1000", out]
    sf100_fullgen.main()
    assert sf100_full_verify.main(
        [out, "0", "6,1,3", os.path.join(out, "verify.json"),
         "--device", "cpu"]) == 0
    bad = [m for m, mod in sys.modules.items() if mod is not None and (
           m == "jax" or m.startswith("jax.")
           or m == "quickstep_tpu" or m.startswith("quickstep_tpu."))]
    assert not bad, bad
    print("SF100 TOOLS OK")
""")

# The host modules the port copies, and the function of each copy that was
# changed for torch (compared without it).
COPIES = {
    "__main__.py": None,
    "cli/__init__.py": None,
    "cli/network.py": "main",
    "cli/repl.py": "main",
    "exec/streaming.py": None,
    "storage/eviction.py": None,
    "storage/csv_io.py": None,
    "storage/native_io.py": "_load_library",
    "utils/testdb.py": None,
    "utils/golden.py": None,
    "utils/reference_plan.py": None,
    "utils/visualize.py": "profile_plan",
    "transaction/__init__.py": None,
    "transaction/lock_manager.py": None,
}

# The tools the port copies into bench/: the copy of sf100_fullgen.py is the
# tool but for these (copy, tool) passages, imports renamed; of
# sf100_full_verify.py's copy the functions named are the tool's.
TOOL_COPIES = {
    "sf100_fullgen.py": [
        ("    python -m quickstep_tpu.bench.sf100_fullgen [scale=100] \\\n"
         "        [chunk_orders=10000000] [outdir]",
         "    python tools/sf100_fullgen.py [scale=100] "
         "[chunk_orders=10000000] [outdir]"),
        ("import tempfile\n", ""),
        ("REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(\n"
         "    os.path.abspath(__file__))))\n",
         "REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath("
         "__file__)))\nsys.path.insert(0, REPO_ROOT)\n"),
        ('    with open(os.path.join(tempfile.gettempdir(), '
         '"sf100_full_oracle.json"),\n              "w") as f:',
         '    with open("/tmp/sf100_full_oracle.json", "w") as f:'),
    ],
    "sf100_full_verify.py": ("DEFAULT_QS", "norm", "row_eq"),
}

# Runs tools/sf100_fullgen.py as its own __main__, with the copy of the
# oracle it writes to a fixed path under /tmp sent into its output directory.
RUN_FULLGEN_TOOL = textwrap.dedent("""
    import builtins, os, runpy, sys
    tool, outdir = sys.argv[1], sys.argv[4]
    real_open = builtins.open
    def redirected_open(path, *args, **kwargs):
        if path == "/tmp/sf100_full_oracle.json":
            path = os.path.join(outdir, "oracle_copy.json")
        return real_open(path, *args, **kwargs)
    builtins.open = redirected_open
    sys.argv = sys.argv[1:]
    runpy.run_path(tool, run_name="__main__")
""")
FULLGEN_SCALE = 0.002


def _run(args, cwd, **env):
    full_env = dict(os.environ, **{"PYTHONPATH": REPO, **env})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=full_env,
                          capture_output=True, text=True, timeout=120)


def test_port_runs_q6_without_jax():
    proc = _run(["-c", Q6_WITHOUT_JAX], REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "Q6 OK" in proc.stdout


def test_port_runs_join_queries_without_jax():
    proc = _run(["-c", JOINS_WITHOUT_JAX], REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "JOINS OK" in proc.stdout


def test_port_runs_dml_and_operators_without_jax():
    proc = _run(["-c", DML_AND_OPERATORS_WITHOUT_JAX], REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "DML OK" in proc.stdout


def test_port_runs_the_mesh_path_without_jax():
    proc = _run(["-c", MESH_WITHOUT_JAX], REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "MESH OK" in proc.stdout


def test_scale_verification_twins_run_without_jax():
    proc = _run(["-c", SF_TWINS_WITHOUT_JAX], REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "SF TWINS OK" in proc.stdout


def test_out_of_core_and_the_cli_run_without_jax():
    proc = _run(["-c", OUT_OF_CORE_WITHOUT_JAX], REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "OUT OF CORE OK" in proc.stdout


def test_sf100_tools_run_without_jax(tmp_path):
    """bench/sf100_fullgen.py writes a store and bench/sf100_full_verify.py
    checks three of its queries, neither loading jax or quickstep_tpu."""
    proc = _run(["-c", SF100_TOOLS_WITHOUT_JAX, str(tmp_path / "store")],
                REPO, TMPDIR=str(tmp_path))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "SF100 TOOLS OK" in proc.stdout


def test_local_mesh_runs_without_jax():
    """A mesh over two members of one process (parallel/local_group.py,
    bench/multihost_run.py run_members, the star battery) loads neither
    jax nor quickstep_tpu."""
    proc = _run(["-c", LOCAL_MESH_WITHOUT_JAX], REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOCAL MESH OK" in proc.stdout


def test_multihost_runs_without_jax(tmp_path):
    """Two processes of bench/multihost_run.py (gloo, the star battery),
    neither loading jax or quickstep_tpu."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = str(s.getsockname()[1])
    s.close()
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-c", MULTIHOST_WITHOUT_JAX, str(rank), "2", port,
         str(tmp_path / "mh"), "--device", "cpu", "--star"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        assert "MULTIHOST OK" in out


def _without_function(text, name):
    """text without the top-level function `name` (its def line up to the
    next top-level statement)."""
    if name is None:
        return text
    lines = text.split("\n")
    start = next(i for i, line in enumerate(lines)
                 if line.startswith(f"def {name}("))
    end = next(i for i in range(start + 1, len(lines))
               if lines[i] and not lines[i][0].isspace())
    return "\n".join(lines[:start] + lines[end:])


@pytest.mark.parametrize("path", sorted(COPIES))
def test_copied_host_modules_equal_their_sources(path):
    """Each copy names its source on its first line and is the source with
    quickstep_tpu renamed, apart from the function COPIES names."""
    with open(os.path.join(REPO, "quickstep_tpu_torch", path)) as f:
        first, copy = f.read().split("\n", 1)
    with open(os.path.join(REPO, "quickstep_tpu", path)) as f:
        source = f.read()
    assert first.startswith(f"# Copied from quickstep_tpu/{path};")
    copy = copy.replace("quickstep_tpu_torch", "quickstep_tpu")
    assert _without_function(copy, COPIES[path]) == \
        _without_function(source, COPIES[path])
    assert "jax" not in copy


def _top_level(text, name):
    """The top-level function or assignment `name` of text: its first line
    up to the next top-level statement."""
    lines = text.split("\n")
    start = next(i for i, line in enumerate(lines)
                 if line.startswith((f"def {name}(", f"{name} = ")))
    end = next(i for i in range(start + 1, len(lines))
               if lines[i] and not lines[i][0].isspace())
    return "\n".join(lines[start:end]).rstrip()


@pytest.mark.parametrize("name", sorted(TOOL_COPIES))
def test_copied_tools_equal_their_sources(name):
    """Each copy of a tool names it on its first line; sf100_fullgen.py's is
    the tool with quickstep_tpu renamed but for TOOL_COPIES' passages,
    sf100_full_verify.py's holds the tool's comparison as it is."""
    with open(os.path.join(REPO, "quickstep_tpu_torch", "bench", name)) as f:
        first, copy = f.read().split("\n", 1)
    with open(os.path.join(REPO, "tools", name)) as f:
        source = f.read()
    assert first.startswith(f"# Copied from tools/{name};")
    assert "jax" not in copy
    copy = copy.replace("quickstep_tpu_torch", "quickstep_tpu")
    if name == "sf100_fullgen.py":
        for mine, theirs in TOOL_COPIES[name]:
            assert copy.count(mine) == 1, mine
            copy = copy.replace(mine, theirs)
        assert copy == source
    else:
        for fn in TOOL_COPIES[name]:
            assert _top_level(copy, fn) == _top_level(source, fn), fn


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, where):
    if where == "alone":
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd, env = str(tmp_path), {"PYTHONPATH": str(tmp_path)}
    else:
        cwd, env = REPO, {}
    proc = _run(["chip_smoke.py"], cwd, CUDA_VISIBLE_DEVICES="", **env)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_copied_generator_matches_reference():
    from quickstep_tpu.bench import tpchgen as J
    from quickstep_tpu_torch.bench import tpchgen as T
    ref = J.generate(0.01, 0)
    port = T.generate(0.01, 0)
    assert list(ref) == list(port)
    for table, rdata in ref.items():
        pdata = port[table]
        assert rdata.names == pdata.names, table
        for name in rdata.names:
            rc, pc = rdata.columns[name], pdata.columns[name]
            assert rc.type.name() == pc.type.name(), (table, name)
            np.testing.assert_array_equal(pc.data, rc.data)
            assert (rc.valid is None) == (pc.valid is None)
            if rc.valid is not None:
                np.testing.assert_array_equal(pc.valid, rc.valid)
            assert (rc.dictionary is None) == (pc.dictionary is None)
            if rc.dictionary is not None:
                assert pc.dictionary.values == rc.dictionary.values


@pytest.fixture(scope="module")
def fullgen_pair(tmp_path_factory):
    """(the tool's store directory, the port's (tables, stats, oracle)) at
    FULLGEN_SCALE: the tool runs in a subprocess while the port generates."""
    from quickstep_tpu_torch.bench.tpch_fullgen import generate
    outdir = tmp_path_factory.mktemp("sf_fullgen")
    env = dict(os.environ, PYTHONPATH=REPO)
    tool = subprocess.Popen(
        [sys.executable, "-c", RUN_FULLGEN_TOOL,
         os.path.join(REPO, "tools", "sf100_fullgen.py"), str(FULLGEN_SCALE),
         "10000000", str(outdir)],
        cwd=str(outdir), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    port = generate(FULLGEN_SCALE, log=lambda msg: None)
    out, _ = tool.communicate(timeout=300)
    assert tool.returncode == 0, out
    return outdir, port


def test_copied_full_generator_matches_reference_columns(fullgen_pair):
    outdir, (tables, _stats, _oracle) = fullgen_pair
    with open(outdir / "catalog.json") as f:
        catalog = json.load(f)["databases"]["default"]["relations"]
    assert sorted(catalog) == sorted(tables)
    for name, rel in catalog.items():
        t = tables[name]
        assert [a["name"] for a in rel["attributes"]] == list(t.arrays)
        for a in rel["attributes"]:
            cname = a["name"]
            ref = np.load(outdir / "default" / name / f"{cname}.npy")
            np.testing.assert_array_equal(t.arrays[cname], ref,
                                          err_msg=f"{name}.{cname}")
            dict_path = outdir / "default" / name / f"{cname}.dict.json"
            if dict_path.exists():
                with open(dict_path) as f:
                    assert t.dicts[cname] == json.load(f), (name, cname)
            else:
                assert cname not in t.dicts, (name, cname)


def test_copied_full_generator_matches_reference_oracle_and_stats(
        fullgen_pair):
    outdir, (_tables, stats, oracle) = fullgen_pair
    with open(outdir / "oracle.json") as f:
        want = json.load(f)
    assert json.loads(json.dumps(oracle)) == want
    assert set(want) >= {"q1", "q3", "q4", "q5", "q6", "q10"}
    assert all(want[q] for q in ("q1", "q3", "q4", "q5", "q6", "q10"))
    with open(outdir / "catalog.json") as f:
        catalog = json.load(f)["databases"]["default"]["relations"]
    for name, rel in catalog.items():
        assert json.loads(json.dumps(stats[name])) == rel["stats"], name
