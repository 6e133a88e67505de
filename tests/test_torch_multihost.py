"""The port's mesh spread over processes (quickstep_tpu_torch/parallel/
multihost.py): 2 processes x 2 local shards, gloo on the CPU, each a
quickstep_tpu_torch/bench/multihost_run.py worker under a timeout. Their
collectives and rows are held bit for bit against the one-process mesh of
4 shards, and the star battery also against the JAX package's
single-process rows (tests/test_multihost.py:55-59); each process uploads
only its shards' rows of a sharded table, a retry is taken by both, and
INSERT, DELETE and UPDATE of a sharded table give the one-process rows.

The scalar aggregates, the dense GROUP BY and the broadcast joins that
keep at most one build row a probe row run on each process's rows, their
partial states folded over the processes, as the GSPMD partitioner splits
them (test_per_shard_operators_gather_nothing). So do the exact filter,
whose presence bits each process builds from its own build rows and ORs
(test_a_filter_build_stays_on_each_process), and the semi-statistics and
expansion joins, whose probe side stays on each process's rows against
one gathered build (test_semi_battery_matches_one_process_mesh,
test_q21_keeps_its_probe_sides). Where the port's multi-process path
deliberately differs from the reference's
(quickstep_tpu/parallel/multihost.py under GSPMD), and the cases here
that show each:
- Sort, Limit, Distinct, window inputs, DISTINCT aggregates, a sort
  GROUP BY outside the two-phase route, the full outer join (both
  sides), and the build side of a unique, semi-statistics or expansion
  join gather their sharded input, where the GSPMD partitioner would
  split some of them over the mesh: the rows are the one-process mesh's
  (the star, battery and TPC-H cases), and each gather is counted with
  its bytes and why it was made (test_gathers_and_exchanges_are_counted);
- psum, pmax and por gather every shard's value and fold in shard order,
  where the reference reduces in XLA's order, so that every process
  returns the one-process mesh's bits, floats included
  (test_collectives_match_the_one_process_mesh);
- the presentation sort is decided from the query's shape (ORDER BY with
  a LIMIT sorts on the device) on every process, where the reference sorts
  on the device only in a single process (its executor.py:825): both
  processes return the one-process rows of the ORDER BY queries (topn and
  the TPC-H cases);
- only process 0 writes learned_overrides.json; every process learns the
  same overrides from the same OR'd flags, and a process that opens the
  conductor's store reads them (test_only_the_conductor_writes_overrides).
"""

import os
import pickle
import socket
import subprocess
import sys
import time
import types

import numpy as np
import pytest

from quickstep_tpu_torch import Database
from quickstep_tpu_torch.bench import multihost_run as MR
from quickstep_tpu_torch.bench.tpch import TPCH_QUERIES, load_tpch
from quickstep_tpu_torch.parallel import multihost
from quickstep_tpu_torch.parallel.mesh import make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "quickstep_tpu_torch", "bench",
                      "multihost_run.py")
N_PROCS, LOCAL = 2, 2
SHARDS = N_PROCS * LOCAL
SF = 0.003
TIMEOUT_S = 240
COLLECTIVES = ("all_to_all", "all_to_all_i64", "all_to_all_i32",
               "all_to_all_i8", "all_to_all_b", "all_to_all_f64", "psum",
               "pmax", "por", "por_b", "all_gather", "all_gather_b",
               "all_gather_to_host")
REPLICATED = ("psum", "pmax", "por", "por_b", "all_gather", "all_gather_b",
              "all_gather_to_host")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# a worker of the collectives alone, which move a few bytes at a time
SMALL_PIECES = """
import pickle, sys
from quickstep_tpu_torch.bench.multihost_run import run_collectives
from quickstep_tpu_torch.parallel import mesh, multihost
mesh.PIECE_BYTES = 24
rank, n, port = (int(a) for a in sys.argv[1:4])
out, opt = sys.argv[4], dict(zip(sys.argv[5::2], sys.argv[6::2]))
multihost.bootstrap(f"127.0.0.1:{port}", n, rank)
got = run_collectives(mesh.make_mesh(int(opt["--local-shards"]),
                                     opt["--device"],
                                     group=multihost.world_group()))
with open(f"{out}.{rank}", "wb") as f:
    pickle.dump(got, f)
multihost.shutdown()
"""

# a worker on a store of its own, out.store<rank>: RETRY_QUERIES learn
# their overrides, which only the conductor writes; after a barrier each
# process runs them again on a database opened on the conductor's store
OVERRIDES = """
import os, pickle, sys
from quickstep_tpu_torch import Database
from quickstep_tpu_torch.bench import multihost_run as MR
from quickstep_tpu_torch.parallel import multihost
rank, n, port = (int(a) for a in sys.argv[1:4])
out, opt = sys.argv[4], dict(zip(sys.argv[5::2], sys.argv[6::2]))
multihost.bootstrap(f"127.0.0.1:{port}", n, rank)
retries = []    # over RETRY_QUERIES, on each store
for store in (f"{out}.store{rank}", f"{out}.store0"):
    os.makedirs(store, exist_ok=True)
    db = Database(config=MR.config(MR.STAR_THRESHOLD), storage_path=store,
                  device=opt["--device"],
                  mesh_shards=int(opt["--local-shards"]))
    MR.add_skew_tables(db, db.executor.mesh.n)
    retries.append(0)
    for sql in MR.RETRY_QUERIES.values():
        db.execute(sql)
        retries[-1] += db.executor.retries
    db.close()
    multihost.barrier()
with open(f"{out}.{rank}", "wb") as f:
    pickle.dump(retries, f)
multihost.shutdown()
"""


def _start(out, args, procs=range(N_PROCS), worker=(WORKER,)):
    """Worker processes `procs` of N_PROCS on the CPU, each writing its
    output to out.<id>.log (a file, so that no worker stalls on a full
    pipe while the caller waits for another)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    port = _free_port()
    started = []
    for i in procs:
        log = f"{out}.{i}.log"
        with open(log, "wb") as f:
            p = subprocess.Popen(
                [sys.executable, *worker, str(i), str(N_PROCS), str(port),
                 out, "--device", "cpu", "--local-shards", str(LOCAL)] + args,
                cwd=REPO, env=env, stdout=f, stderr=subprocess.STDOUT)
        p.log = log
        started.append(p)
    return started


def _finish(procs, timeout):
    """Each worker's output, all within `timeout` seconds of now; a worker
    still running then is killed, with every other, and TimeoutExpired
    raised."""
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for p in procs:
        with open(p.log, errors="replace") as f:
            outs.append(f.read())
        assert p.returncode == 0, f"worker failed:\n{outs[-1][-3000:]}"
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the workers' outputs by process, the one-process 4-shard mesh's):
    the reference runs here while the workers run."""
    out = str(tmp_path_factory.mktemp("multihost") / "mh")
    procs = _start(out, ["--star", "--scale", str(SF)])
    try:
        one = {"collectives": MR.run_collectives(make_mesh(SHARDS, "cpu")),
               "rows": {}, "retries": {}}
        db = MR.build_db(MR.config(MR.STAR_THRESHOLD), "cpu", SHARDS)
        for name, sql in MR.QUERIES.items():
            one["rows"][name] = db.execute(sql).rows
        MR.add_skew_tables(db, SHARDS)
        for name, sql in MR.RETRY_QUERIES.items():
            one["rows"][name] = db.execute(sql).rows
            one["retries"][name] = db.executor.retries
        for stmt in MR.SEMI_TABLES:
            db.execute(stmt)
        for name, sql in MR.SEMI_QUERIES.items():
            one["rows"][name] = db.execute(sql).rows
            one["retries"][name] = db.executor.retries
        for stmt in MR.DML:
            db.execute(stmt)
        for name, sql in MR.DML_QUERIES.items():
            one["rows"][name] = db.execute(sql).rows
        db.close()
        db = Database(config=MR.config(MR.TPCH_THRESHOLD), device="cpu",
                      mesh_shards=SHARDS)
        load_tpch(db, scale=SF, seed=0)
        for q in sorted(TPCH_QUERIES):
            one["rows"][f"Q{q}"] = db.execute(TPCH_QUERIES[q]).rows
            one["retries"][f"Q{q}"] = db.executor.retries
        db.close()
    finally:
        _finish(procs, TIMEOUT_S)
    mh = []
    for i in range(N_PROCS):
        with open(f"{out}.{i}", "rb") as f:
            mh.append(pickle.load(f))
    return mh, one


@pytest.mark.parametrize("name", COLLECTIVES)
def test_collectives_match_the_one_process_mesh(runs, name):
    mh, one = runs
    want = one["collectives"][name]
    for rank, got in enumerate(m["figures"]["collectives"][name]
                               for m in mh):
        if name not in REPLICATED:
            # this process's shards' rows of the one-process result
            per = want.shape[0] // SHARDS
            want_mine = want[rank * LOCAL * per:(rank + 1) * LOCAL * per]
        else:
            want_mine = want
        assert got.dtype == want_mine.dtype
        # bit for bit, floats included
        assert got.tobytes() == want_mine.tobytes(), (name, rank)


def test_collectives_in_small_pieces_match(runs, tmp_path):
    """A collective larger than PIECE_BYTES runs as several: with pieces
    of 24 bytes every result is the same."""
    mh, _one = runs
    out = str(tmp_path / "mh")
    _finish(_start(out, [], worker=("-c", SMALL_PIECES)), TIMEOUT_S)
    for i, m in enumerate(mh):
        with open(f"{out}.{i}", "rb") as f:
            small = pickle.load(f)
        for name in COLLECTIVES:
            got, want = small[name], m["figures"]["collectives"][name]
            assert got.tobytes() == want.tobytes(), (name, i)


@pytest.mark.parametrize("name", sorted(MR.QUERIES))
def test_star_battery_matches_one_process_mesh_and_jax(runs, name):
    mh, one = runs
    from multihost_worker import QUERIES, build_db
    from quickstep_tpu.config import Config
    assert QUERIES == MR.QUERIES
    jax_rows = [list(r) for r in build_db(Config(display_timing=False))
                .execute(QUERIES[name]).rows]
    for m in mh:
        assert m["rows"][name] == [list(one["rows"][name])]
        assert [list(r) for r in m["rows"][name][0]] == jax_rows


@pytest.mark.parametrize("q", sorted(TPCH_QUERIES))
def test_tpch_matches_one_process_mesh_bit_for_bit(runs, q):
    mh, one = runs
    want = one["rows"][f"Q{q}"]
    for m in mh:
        assert m["rows"][f"Q{q}"] == [list(want)], q
        assert m["figures"]["queries"][f"Q{q}"]["retries"] == \
            [one["retries"][f"Q{q}"]]


def test_block_locality(runs):
    """A sharded table's upload on each process is its half; a replicated
    one is whole on each."""
    mh, _one = runs
    sharded = {"fact", "sk_build", "sk_probe", "sk_dup", "sb", "sp", "dm",
               "nk", "lineitem", "orders", "partsupp"}
    for m in mh:
        up = m["figures"]["uploads"]
        assert {t for t, u in up.items() if u["sharded"]} == sharded
        for table, u in up.items():
            want = u["table_bytes"] // N_PROCS if u["sharded"] \
                else u["table_bytes"]
            assert u["bytes"] == want > 0, (table, u)


def test_gathers_and_exchanges_are_counted(runs):
    """last_mesh_info: Q1's aggregate over a sharded table reduces each
    process's rows and gathers nothing; Q16's COUNT(DISTINCT), which has no
    per-shard form, gathers its input (rows of every process) by a
    replicated decision, with its bytes and its reason; a shuffle join
    exchanges by all_to_all."""
    mh, _one = runs
    for m in mh:
        queries = m["figures"]["queries"]
        q1 = queries["Q1"]["mesh"][0]
        assert q1["gathers"] == [] and "gather" not in q1["collectives"]
        q16 = queries["Q16"]["mesh"][0]
        assert [(g["into"], g["why"]) for g in q16["gathers"]] == \
            [("Aggregate", "DISTINCT aggregate")]
        assert q16["gathers"][0]["bytes"] == \
            q16["collectives"]["gather"]["bytes"] > 0
        q3 = queries["Q3"]["mesh"][0]["collectives"]
        assert q3["all_to_all"]["calls"] > 0 and q3["all_to_all"]["bytes"] > 0


# the per-shard operators' queries and the folds each must cross the
# processes by: psum for sums and counts, pmin and pmax for MIN and MAX,
# por for a dense GROUP BY's occupied groups
PER_SHARD = {
    "filter_agg": ("psum", "pmin", "pmax"),
    "groupby": ("psum", "por"),
    "join_agg": ("psum", "por"),
    "semi": ("psum",),
    "Q1": ("psum", "por"),
    "Q5": ("psum", "por"),
    "Q6": ("psum",),
}


@pytest.mark.parametrize("name", sorted(PER_SHARD))
def test_per_shard_operators_gather_nothing(runs, name):
    """The scalar aggregates, the dense GROUP BYs and the broadcast joins
    of these queries run on each process's rows: no input is gathered into
    an Aggregate, no probe side into a Join, their partials fold by the
    collectives named, and the rows are the one-process mesh's bit for
    bit."""
    mh, one = runs
    for m in mh:
        info = m["figures"]["queries"][name]["mesh"][0]
        assert not [g for g in info["gathers"] if g["into"] == "Aggregate"
                    or g["why"].startswith("probe side")], info["gathers"]
        for coll in PER_SHARD[name]:
            moved = info["collectives"].get(coll)
            assert moved and moved["calls"] > 0 and moved["bytes"] > 0, \
                (coll, info["collectives"])
        assert m["rows"][name] == [list(one["rows"][name])]


def test_a_nullable_dense_key_gathers_by_a_replicated_decision(runs):
    """nk's key g spans 97 values (a dense domain) and holds NULLs: its
    GROUP BY leaves the dense route once g is evaluated (a validity tensor
    that every process's scan has alike), and 50 rows a shard are too few
    for the two-phase route, so both processes gather its input and return
    the one-process rows."""
    mh, one = runs
    for m in mh:
        info = m["figures"]["queries"]["dml_nullable_groups"]["mesh"][0]
        assert [(g["into"], g["why"]) for g in info["gathers"]] == \
            [("Aggregate", "nullable keys of a dense domain")]
        assert m["rows"]["dml_nullable_groups"] == \
            [list(one["rows"]["dml_nullable_groups"])]


@pytest.mark.parametrize("name", sorted(MR.RETRY_QUERIES))
def test_a_retry_is_taken_by_both_processes(runs, name):
    """A shuffle bucket's overflow on process 0's source shards only, and a
    run of duplicate build keys on one shard only: both processes retry
    once and return the one-process rows."""
    mh, one = runs
    assert one["retries"][name] == 1
    for m in mh:
        assert m["figures"]["queries"][name]["retries"] == [1]
        assert m["rows"][name] == [list(one["rows"][name])]


# the exact filters over a sharded build: each process's presence bits
# OR'd by por_filter, no build side gathered (TPC-H Q4's lineitem, Q20's
# partsupp, Q22's orders at SF0.003 and a threshold of 1000)
FILTER_BUILD = ("Q4", "Q20", "Q22", "semi_filter", "anti_filter",
                "not_in_null_one_side", "not_in_empty_one_side",
                "not_in_empty")
# NOT IN whose correction reads the whole build: its two facts OR'd
NULL_AWARE = ("not_in_null_one_side", "not_in_empty_one_side",
              "not_in_empty")
# expansion joins that overflow their 8 slots on process 0's rows alone
OVERFLOW_ON_ONE = ("semi_expand_local", "inner_expand", "left_expand")


def _gathered(info, why):
    return [g for g in info["gathers"] if g["why"].startswith(why)]


@pytest.mark.parametrize("name", FILTER_BUILD)
def test_a_filter_build_stays_on_each_process(runs, name):
    """The exact filter's build side is not gathered (neither for the join
    nor for compaction): each process's presence bits cross by por_filter,
    and the rows and retries are the one-process mesh's bit for bit."""
    mh, one = runs
    for m in mh:
        q = m["figures"]["queries"][name]
        info = q["mesh"][0]
        assert not _gathered(info, "build side of the filter") and \
            not _gathered(info, "compaction"), info["gathers"]
        assert info["collectives"]["por_filter"]["bytes"] > 0, \
            info["collectives"]
        assert m["rows"][name] == [list(one["rows"][name])]
        assert q["retries"] == [one["retries"][name]]


@pytest.mark.parametrize("name", sorted(MR.SEMI_QUERIES))
def test_semi_battery_matches_one_process_mesh(runs, name):
    """Every semi, anti and expansion join of the battery keeps its probe
    side on each process's rows, and returns the one-process mesh's rows
    and retries bit for bit: the null-aware NOT IN ORs its two facts about
    the whole build (a NULL on process 0's build rows alone empties the
    result on both; a build live on process 0 alone drops the NULL probe
    keys on both), and an expansion that overflows on process 0's rows
    alone is retried once by both."""
    mh, one = runs
    if name in OVERFLOW_ON_ONE:
        assert one["retries"][name] == 1
    if name == "not_in_null_one_side":
        assert one["rows"][name][0][0] == 0
    for m in mh:
        q = m["figures"]["queries"][name]
        info = q["mesh"][0]
        assert not _gathered(info, "probe side"), info["gathers"]
        if name in NULL_AWARE:
            assert info["collectives"]["por_null_aware"]["bytes"] > 0
        assert m["rows"][name] == [list(one["rows"][name])]
        assert q["retries"] == [one["retries"][name]]


def test_q21_keeps_its_probe_sides(runs):
    """Q21's EXISTS and NOT EXISTS take the run statistics on each
    process's rows of lineitem: only their build sides are gathered, and
    the retries are the one-process mesh's."""
    mh, one = runs
    for m in mh:
        q = m["figures"]["queries"]["Q21"]
        info = q["mesh"][0]
        assert not _gathered(info, "probe side"), info["gathers"]
        assert [g["why"] for g in info["gathers"]] == \
            ["build side of the semi_stats expand join"] * 2
        assert q["retries"] == [one["retries"]["Q21"]]


@pytest.mark.parametrize("name", sorted(MR.DML_QUERIES))
def test_dml_across_processes_matches_one_process(runs, name):
    mh, one = runs
    for m in mh:
        assert m["rows"][name] == [list(one["rows"][name])]


def test_only_the_conductor_writes_overrides(tmp_path):
    """Each process on a store of its own: both retry both RETRY_QUERIES,
    only process 0's store gets learned_overrides.json, and on a database
    opened on that store neither process retries."""
    out = str(tmp_path / "mh")
    _finish(_start(out, [], worker=("-c", OVERRIDES)), TIMEOUT_S)
    for i in range(N_PROCS):
        with open(f"{out}.{i}", "rb") as f:
            assert pickle.load(f) == [len(MR.RETRY_QUERIES), 0], i
    assert os.listdir(f"{out}.store0") == ["learned_overrides.json"]
    assert os.listdir(f"{out}.store1") == []


def test_a_worker_without_its_partner_fails(tmp_path):
    """Process 1 alone waits for process 0 at the store: the harness's
    timeout ends it and fails."""
    procs = _start(str(tmp_path / "mh"), ["--star"], procs=[1])
    with pytest.raises(subprocess.TimeoutExpired):
        _finish(procs, 5)
    assert procs[0].poll() is not None


def test_nccl_needs_a_card_per_rank():
    """No backend is switched behind the caller's back: NCCL without a card
    raises, as does a backend the port does not know."""
    with pytest.raises(ValueError, match="NCCL carries CUDA tensors"):
        multihost.bootstrap("127.0.0.1:1", 2, 0, backend="nccl",
                            device="cpu")
    with pytest.raises(ValueError, match="backend"):
        multihost.bootstrap("127.0.0.1:1", 2, 0, backend="mpi")
    assert not multihost.is_multiprocess() and multihost.is_conductor()


def test_local_rows_pads_the_last_shard():
    """local_rows of 10 rows over 4 shards (3 a shard): process 1 of 2
    holds rows 6..11 of the padded table, the last two zero; one process
    holds them all."""
    arr = np.arange(1, 11)
    for rank, want in ((0, np.arange(1, 7)), (1, [7, 8, 9, 10, 0, 0])):
        mesh = types.SimpleNamespace(n=4, local_n=2,
                                     local_ids=[2 * rank, 2 * rank + 1])
        np.testing.assert_array_equal(multihost.local_rows(mesh, arr), want)
    np.testing.assert_array_equal(
        multihost.local_rows(make_mesh(4, "cpu"), arr), np.pad(arr, (0, 2)))
