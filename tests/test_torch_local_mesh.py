"""The port's mesh spread over members of one process
(quickstep_tpu_torch/parallel/local_group.py, Database(...,
mesh_devices=[...])): 2 members x 2 local shards on the CPU, each a thread
with its own catalog and executor, run by bench/multihost_run.py
run_members. Their collectives and rows are held bit for bit against the
one-process mesh of 4 shards, as tests/test_torch_multihost.py holds the
same runs over 2 processes: the star, retry, semi and DML batteries and
the 22 TPC-H queries at SF0.003; each member uploads only its shards'
rows of a sharded table, gathers and folds as a process does, and a retry
is taken by every member. The star battery on 4 members x 2 shards is
held against quickstep_tpu's mesh over 8 devices within
tests/test_torch_distributed.py's tolerance. A member that raises makes
the statement raise on every member within seconds, and closing the
database leaves no member's thread running.
"""

import json
import os
import threading
import time

import pytest
import torch

from quickstep_tpu_torch import Database
from quickstep_tpu_torch.bench import multihost_run as MR
from quickstep_tpu_torch.bench.tpch import TPCH_QUERIES, load_tpch
from quickstep_tpu_torch.config import Config
from quickstep_tpu_torch.errors import ExecutionError
from quickstep_tpu_torch.exec import executor as EX
from quickstep_tpu_torch.parallel import local_group as LG
from quickstep_tpu_torch.parallel import mesh as TM
from quickstep_tpu_torch.parallel import multihost

MEMBERS, LOCAL = 2, 2
SHARDS = MEMBERS * LOCAL
SF = 0.003
REL_TOL = 1e-6      # tests/test_torch_distributed.py's bound
# a failed member's statement raises on every member within this
FAIL_S = 5.0
COLLECTIVES = ("all_to_all", "all_to_all_i64", "all_to_all_i32",
               "all_to_all_i8", "all_to_all_b", "all_to_all_f64", "psum",
               "pmax", "por", "por_b", "all_gather", "all_gather_b",
               "all_gather_to_host")
REPLICATED = ("psum", "pmax", "por", "por_b", "all_gather", "all_gather_b",
              "all_gather_to_host")


def _one_process_mesh():
    """The one-process 4-shard mesh's collectives, rows and retries over
    the same batteries."""
    one = {"collectives": MR.run_collectives(TM.make_mesh(SHARDS, "cpu")),
           "rows": {}, "retries": {}}
    db = MR.build_db(MR.config(MR.STAR_THRESHOLD), "cpu", SHARDS)

    def run(queries):
        for name, sql in queries.items():
            one["rows"][name] = db.execute(sql).rows
            one["retries"][name] = db.executor.retries
    run(MR.QUERIES)
    MR.add_skew_tables(db, SHARDS)
    run(MR.RETRY_QUERIES)
    for stmt in MR.SEMI_TABLES:
        db.execute(stmt)
    run(MR.SEMI_QUERIES)
    for stmt in MR.DML:
        db.execute(stmt)
    run(MR.DML_QUERIES)
    db.close()
    db = Database(config=MR.config(MR.TPCH_THRESHOLD), device="cpu",
                  mesh_shards=SHARDS)
    load_tpch(db, scale=SF, seed=0)
    run({f"Q{q}": TPCH_QUERIES[q] for q in sorted(TPCH_QUERIES)})
    db.close()
    return one


@pytest.fixture(scope="module")
def runs():
    """(each member's rows and figures, the one-process 4-shard mesh's)."""
    members = MR.run_members(["cpu"] * MEMBERS, LOCAL, star=True, scale=SF)
    return members, _one_process_mesh()


def _member_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("qstpu-member-")]


@pytest.mark.parametrize("name", COLLECTIVES)
def test_collectives_match_the_one_process_mesh(runs, name):
    members, one = runs
    want = one["collectives"][name]
    for rank, got in enumerate(m["figures"]["collectives"][name]
                               for m in members):
        want_mine = want
        if name not in REPLICATED:
            # this member's shards' rows of the one-process result
            per = want.shape[0] // SHARDS
            want_mine = want[rank * LOCAL * per:(rank + 1) * LOCAL * per]
        assert got.dtype == want_mine.dtype
        # bit for bit, floats included
        assert got.tobytes() == want_mine.tobytes(), (name, rank)


def test_collectives_in_small_pieces_match(runs, monkeypatch):
    """Between processes a collective larger than PIECE_BYTES runs as
    several; between members it is one exchange whatever PIECE_BYTES says:
    with pieces of 24 bytes every member's results are the same, from as
    many deposits a member as with the default pieces."""
    members, _one = runs
    deposits = []
    deposit = LG.Member._deposit

    def counted(self, payload):
        deposits.append(self.rank)
        return deposit(self, payload)
    monkeypatch.setattr(LG.Member, "_deposit", counted)

    def collectives():
        group = LG.LocalGroup(["cpu"] * MEMBERS)
        threads = [LG.MemberThread(m) for m in group.members]
        deposits.clear()
        try:
            got = LG.run_on_members(threads, lambda m: MR.run_collectives(
                TM.make_mesh(LOCAL, "cpu", group=m)), group.members)
        finally:
            for t in threads:
                t.stop()
        assert deposits.count(0) == deposits.count(1) > 0
        return got, deposits.count(0)
    _got, whole = collectives()
    monkeypatch.setattr(TM, "PIECE_BYTES", 24)
    small, pieces = collectives()
    assert pieces == whole
    for rank, (m, got) in enumerate(zip(members, small)):
        for name in COLLECTIVES:
            want = m["figures"]["collectives"][name]
            assert got[name].tobytes() == want.tobytes(), (name, rank)


@pytest.mark.parametrize("name", sorted(MR.QUERIES))
def test_star_battery_matches_one_process_mesh(runs, name):
    members, one = runs
    for m in members:
        assert m["rows"][name] == [list(one["rows"][name])]


@pytest.mark.parametrize("q", sorted(TPCH_QUERIES))
def test_tpch_matches_one_process_mesh_bit_for_bit(runs, q):
    members, one = runs
    for m in members:
        assert m["rows"][f"Q{q}"] == [list(one["rows"][f"Q{q}"])], q
        assert m["figures"]["queries"][f"Q{q}"]["retries"] == \
            [one["retries"][f"Q{q}"]]


def test_block_locality(runs):
    """A sharded table's device copy on each member holds its half; a
    replicated one is whole on each."""
    members, _one = runs
    sharded = {"fact", "sk_build", "sk_probe", "sk_dup", "sb", "sp", "dm",
               "nk", "lineitem", "orders", "partsupp"}
    for m in members:
        up = m["figures"]["uploads"]
        assert {t for t, u in up.items() if u["sharded"]} == sharded
        for table, u in up.items():
            want = u["table_bytes"] // MEMBERS if u["sharded"] \
                else u["table_bytes"]
            assert u["bytes"] == want > 0, (table, u)


def test_gathers_and_exchanges_are_counted(runs):
    """last_mesh_info on every member as on every process: Q1 gathers
    nothing; Q16's COUNT(DISTINCT) gathers its input with its bytes and
    reason; Q3's shuffle join exchanges by all_to_all."""
    members, _one = runs
    for m in members:
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


# tests/test_torch_multihost.py's per-shard queries and their folds
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
    """The scalar aggregates, dense GROUP BYs and broadcast joins run on
    each member's rows: no Aggregate input and no probe side gathered, the
    partials folded by the collectives named, the one-process rows."""
    members, one = runs
    for m in members:
        info = m["figures"]["queries"][name]["mesh"][0]
        assert not [g for g in info["gathers"] if g["into"] == "Aggregate"
                    or g["why"].startswith("probe side")], info["gathers"]
        for coll in PER_SHARD[name]:
            moved = info["collectives"].get(coll)
            assert moved and moved["calls"] > 0 and moved["bytes"] > 0, \
                (coll, info["collectives"])
        assert m["rows"][name] == [list(one["rows"][name])]


@pytest.mark.parametrize("name", sorted(MR.RETRY_QUERIES))
def test_a_retry_is_taken_by_every_member(runs, name):
    """A shuffle bucket's overflow on member 0's source shards only, and a
    run of duplicate build keys on one shard only: every member retries
    once and returns the one-process rows."""
    members, one = runs
    assert one["retries"][name] == 1
    for m in members:
        assert m["figures"]["queries"][name]["retries"] == [1]
        assert m["rows"][name] == [list(one["rows"][name])]


@pytest.mark.parametrize("name", sorted(MR.SEMI_QUERIES))
def test_semi_battery_matches_one_process_mesh(runs, name):
    """The semi, anti and expansion joins keep their probe sides on each
    member's rows; the exact filters OR each member's presence bits and
    gather no build side; rows and retries are the one-process mesh's."""
    members, one = runs
    for m in members:
        q = m["figures"]["queries"][name]
        info = q["mesh"][0]
        assert not [g for g in info["gathers"]
                    if g["why"].startswith("probe side")], info["gathers"]
        if name in ("semi_filter", "anti_filter"):
            assert info["collectives"]["por_filter"]["bytes"] > 0
            assert not [g for g in info["gathers"] if g["why"].startswith(
                "build side of the filter")], info["gathers"]
        assert m["rows"][name] == [list(one["rows"][name])]
        assert q["retries"] == [one["retries"][name]]


@pytest.mark.parametrize("name", sorted(MR.DML_QUERIES))
def test_dml_across_members_matches_one_process(runs, name):
    members, one = runs
    for m in members:
        assert m["rows"][name] == [list(one["rows"][name])]


def _assert_rows_close(a, b, what):
    """Row for row: floats within REL_TOL relative, all else equal."""
    a, b = [tuple(r) for r in a], [tuple(r) for r in b]
    assert len(a) == len(b), f"{what}: {len(a)} vs {len(b)} rows"
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb)
        for x, y in zip(ra, rb):
            if isinstance(x, float) and isinstance(y, float):
                assert abs(x - y) <= REL_TOL * max(1.0, abs(x)), what
            else:
                assert x == y, f"{what}: {ra} vs {rb}"


@pytest.fixture(scope="module")
def star_four_members():
    """The star on quickstep_tpu's mesh over 8 devices, and on 4 members x
    2 shards of the port, at the star's replicate threshold."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh of tests/conftest.py")
    from multihost_worker import build_db
    from quickstep_tpu.config import Config as JConfig
    ref = build_db(JConfig(distributed=True, replicate_threshold_rows=64,
                           display_timing=False))
    port = MR.build_db(MR.config(MR.STAR_THRESHOLD), "cpu", 2,
                       mesh_devices=["cpu"] * 4)
    yield ref, port
    port.close()


@pytest.mark.parametrize("name", sorted(MR.QUERIES))
def test_four_members_match_the_reference_mesh(star_four_members, name):
    ref, port = star_four_members
    assert port.executor.mesh.n == 8 and len(port.members) == 4
    _assert_rows_close(ref.execute(MR.QUERIES[name]).rows,
                       port.execute(MR.QUERIES[name]).rows, name)


def test_only_member_zero_writes_overrides(tmp_path, monkeypatch):
    """On a store, RETRY_QUERIES learn their overrides on every member, but
    only member 0 writes learned_overrides.json; members opened on that
    store take the corrected plans in one pass."""
    writers = []
    real = EX.json.dump

    def dump(obj, f, *args, **kwargs):
        writers.append(multihost.process_index())
        return real(obj, f, *args, **kwargs)
    monkeypatch.setattr(EX.json, "dump", dump)
    store = str(tmp_path / "store")
    os.makedirs(store)
    retries = []
    for _ in range(2):
        db = Database(config=MR.config(MR.STAR_THRESHOLD), device="cpu",
                      storage_path=store, mesh_shards=LOCAL,
                      mesh_devices=["cpu"] * MEMBERS)
        MR.add_skew_tables(db, db.executor.mesh.n)
        retries.append(0)
        for sql in MR.RETRY_QUERIES.values():
            db.execute(sql)
            retries[-1] += sum(ex.retries for ex in db.members)
        db.close()
    assert retries == [MEMBERS * len(MR.RETRY_QUERIES), 0]
    assert writers and set(writers) == {0}
    assert os.listdir(store) == ["learned_overrides.json"]
    with open(os.path.join(store, "learned_overrides.json")) as f:
        assert len(json.load(f)) == len(MR.RETRY_QUERIES)


def test_a_failing_member_stops_every_member(monkeypatch):
    """Member 1's plan raises while member 0 runs on into the query's
    exchanges: execute raises member 1's error within seconds, the next
    statement runs on a fresh barrier, and close leaves no member's thread
    running."""
    db = MR.build_db(MR.config(MR.STAR_THRESHOLD), "cpu", LOCAL,
                     mesh_devices=["cpu"] * MEMBERS)
    sql = MR.QUERIES["join_agg"]
    want = db.execute(sql).rows
    victim = db.members[1]
    real = victim.run_plan

    def fail(*args, **kwargs):
        raise RuntimeError("member 1 fails on purpose")
    monkeypatch.setattr(victim, "run_plan", fail)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="on purpose"):
        db.execute(sql)
    assert time.monotonic() - t0 < FAIL_S
    monkeypatch.setattr(victim, "run_plan", real)
    assert db.execute(sql).rows == want
    threads = [t.thread for t in db._threads]
    assert len(threads) == MEMBERS and all(t.is_alive() for t in threads)
    db.close()
    for t in threads:
        t.join(FAIL_S)
    assert not [t for t in threads if t.is_alive()]


def test_a_closed_database_says_so():
    """After close, a statement or a job on the members raises that the
    database is closed, not an error from inside the members' hand-off."""
    db = MR.build_db(MR.config(MR.STAR_THRESHOLD), "cpu", LOCAL,
                     mesh_devices=["cpu"] * MEMBERS)
    db.close()
    with pytest.raises(RuntimeError, match="is closed"):
        db.execute(MR.QUERIES["join_agg"])
    with pytest.raises(RuntimeError, match="is closed"):
        db.on_members(lambda m: m.index)


def test_a_statement_takes_its_executors_card(monkeypatch):
    """A statement runs on any thread (the PolicyEnforcer's, a member's,
    the caller's): the executor makes its card, where it names one, the
    thread's current device before anything launches there, and leaves a
    thread already on it, an unnumbered card and the CPU alone."""
    current = {"index": 0}
    calls = []

    def set_device(device):
        calls.append(torch.device(device))
        current["index"] = torch.device(device).index
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: current["index"])
    monkeypatch.setattr(torch.cuda, "set_device", set_device)
    EX.use_device(torch.device("cuda", 1))
    EX.use_device(torch.device("cuda", 1))
    EX.use_device(torch.device("cuda"))
    EX.use_device(torch.device("cpu"))
    assert calls == [torch.device("cuda", 1)]


def test_a_failing_first_statement_leaves_no_thread():
    """A member group that cannot start (a Config without distributed)
    is refused before any thread starts; a member whose executor refuses
    its config stops every member's thread."""
    before = set(_member_threads())
    with pytest.raises(ValueError, match="Config.distributed"):
        Database(config=Config(), device="cpu", mesh_shards=2,
                 mesh_devices=["cpu", "cpu"])
    cfg = MR.config(MR.STAR_THRESHOLD)
    cfg.eviction_policy = "no such policy"
    with pytest.raises(ValueError, match="unknown eviction policy"):
        Database(config=cfg, device="cpu", mesh_shards=2,
                 mesh_devices=["cpu", "cpu"])
    time.sleep(0.1)
    assert set(_member_threads()) <= before


def test_members_within_a_process_group_are_refused(monkeypatch):
    """processes x members is not ported: a mesh over members in a process
    of a torch.distributed group of 2 is refused."""
    monkeypatch.setattr(multihost, "processes", lambda: 2)
    with pytest.raises(ExecutionError, match="not both"):
        Database(config=MR.config(MR.STAR_THRESHOLD), device="cpu",
                 mesh_shards=2, mesh_devices=["cpu", "cpu"])


def test_a_member_answers_for_its_group():
    """multihost's answers on a member's thread are its group's: its index,
    member 0 the conductor, the member as the world group; off the
    members' threads they are the process's again."""
    group = LG.LocalGroup(["cpu"] * 3)
    threads = [LG.MemberThread(m) for m in group.members]
    try:
        got = LG.run_on_members(threads, lambda m: (
            multihost.process_index(), multihost.is_conductor(),
            multihost.world_group() is m, multihost.is_multiprocess()),
            group.members)
    finally:
        for t in threads:
            t.stop()
    assert got == [(0, True, True, True), (1, False, True, True),
                   (2, False, True, True)]
    assert multihost.world_group() is None and multihost.is_conductor()


def test_a_mesh_needs_its_members_device():
    """A member's mesh holds its shards on the member's device; the local
    shards of one mesh share one device."""
    group = LG.LocalGroup(["cpu", "cpu"])
    with pytest.raises(ValueError, match="holds its shards on"):
        TM.Mesh([torch.device("meta")] * 2, group=group.members[0])
    with pytest.raises(ValueError, match="one member a device"):
        TM.Mesh([torch.device("cpu"), torch.device("meta")])


def test_the_entry_points_default_to_the_card(tmp_path):
    """Database, from_store and the two front ends run on the card unless
    the CPU is asked for: without a card the default refuses, never a
    quiet CPU run; mesh_devices="all" is every card, on a card only."""
    from quickstep_tpu_torch.cli import network, repl
    from quickstep_tpu_torch.database import from_store
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="finds no CUDA device"):
        Database()
    with pytest.raises(RuntimeError, match="finds no CUDA device"):
        from_store(str(tmp_path))
    with pytest.raises(RuntimeError, match="finds no CUDA device"):
        repl.main(["-c", "SELECT 1;"])
    with pytest.raises(RuntimeError, match="finds no CUDA device"):
        network.main(["--port", "0"])
    with pytest.raises(ValueError, match="every card"):
        Database(config=MR.config(MR.STAR_THRESHOLD), device="cpu",
                 mesh_shards=2, mesh_devices="all")


def test_launch_counts_are_thread_safe():
    """Two threads of 1,000 counted launches each give 2,000, and each
    thread's own count is 1,000."""
    from quickstep_tpu_torch.ops import cuda
    saved = dict(cuda.LAUNCHES)
    cuda.reset_launches()
    try:
        threads = [threading.Thread(target=lambda: [
            cuda._launched("scalar_agg") for _ in range(1000)])
            for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert cuda.LAUNCHES["scalar_agg"] == 2000
        assert [cuda.launches_of(t)["scalar_agg"] for t in threads] == \
            [1000, 1000]
    finally:
        cuda.reset_launches()
        cuda.LAUNCHES.update(saved)
