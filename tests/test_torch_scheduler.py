"""The port's scheduler: the copied PolicyEnforcer, ExecutionStats and
ProbabilityStore (tests/test_scheduler.py's cases), the Database's
enforcer on every path (embedded, network), and the segment-granular
interleave: the executor yields to the enforcer between streamed segments,
so a short query from another session finishes while a long streamed one
is under way."""

import threading
import time

import numpy as np
import pytest

from quickstep_tpu_torch import Database
from quickstep_tpu_torch.exec.scheduler import (
    ExecutionStats, PolicyEnforcer, ProbabilityStore)


def test_execution_stats_window():
    s = ExecutionStats(max_entries=3)
    for ms in (10.0, 20.0, 30.0, 40.0):
        s.add_entry("select", ms)
    total, n = s.stats("select")
    assert n == 3 and total == 90.0          # oldest (10.0) evicted
    assert s.average("select") == 30.0
    assert s.stats("missing") == (0.0, 0)
    assert s.average("missing") is None
    assert s.operators() == ["select"]


def test_probability_store():
    ps = ProbabilityStore()
    ps.add_or_update(1, 1.0)
    ps.add_or_update(2, 3.0)
    assert ps.probability(1) == pytest.approx(0.25)
    assert ps.probability(2) == pytest.approx(0.75)
    assert ps.pick_random(0.1) == 1
    assert ps.pick_random(0.9) == 2
    ps.remove(1)
    assert ps.probability(2) == pytest.approx(1.0)
    assert ps.probability(1) == 0.0
    ps.remove(2)
    with pytest.raises(KeyError):
        ps.pick_random(0.5)


def test_policy_enforcer_serializes_and_returns_results():
    log = []

    def exec_fn(sql):
        log.append(sql)
        return f"result:{sql}"

    pe = PolicyEnforcer(exec_fn, max_concurrent_queries=4)
    try:
        results = [None] * 8
        threads = [threading.Thread(
            target=lambda i=i: results.__setitem__(
                i, pe.submit(f"q{i}", session=f"s{i % 2}")))
            for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert sorted(results) == [f"result:q{i}" for i in range(8)]
        assert sorted(log) == [f"q{i}" for i in range(8)]
        assert pe.stats.stats("query")[1] == 8
    finally:
        pe.shutdown()


def test_policy_enforcer_priority_order():
    """While one query occupies the executor, higher-priority later arrivals
    are dispatched before lower-priority earlier ones."""
    started = []
    gate = threading.Event()

    def exec_fn(sql):
        if sql == "blocker":
            gate.wait(5)
        started.append(sql)
        return sql

    pe = PolicyEnforcer(exec_fn, max_concurrent_queries=8)
    try:
        tb = threading.Thread(target=lambda: pe.submit("blocker"))
        tb.start()
        time.sleep(0.15)                     # blocker is now executing
        tlo = threading.Thread(target=lambda: pe.submit("low", priority=0))
        tlo.start()
        time.sleep(0.05)                     # low arrives first
        thi = threading.Thread(target=lambda: pe.submit("high", priority=5))
        thi.start()
        time.sleep(0.05)
        gate.set()
        for t in (tb, tlo, thi):
            t.join()
        assert started == ["blocker", "high", "low"]
    finally:
        pe.shutdown()


def test_policy_enforcer_propagates_errors():
    def exec_fn(sql):
        raise ValueError(f"bad: {sql}")

    pe = PolicyEnforcer(exec_fn)
    try:
        with pytest.raises(ValueError, match="bad: q"):
            pe.submit("q")
    finally:
        pe.shutdown()


def test_network_server_concurrent_clients():
    """Concurrent clients through the network server route via the
    Database's PolicyEnforcer and all get correct results."""
    from quickstep_tpu_torch.cli.network import QueryClient, QueryServer

    db = Database(device="cpu")
    db.execute("CREATE TABLE t (a INT NOT NULL)")
    db.execute("INSERT INTO t VALUES (1), (2), (3), (4)")
    server = QueryServer(db, port=0, max_concurrent_queries=4)
    # the server shares the Database's enforcer, which also saw the two
    # setup statements above
    assert server.enforcer is db.policy_enforcer
    base_n = server.enforcer.stats.stats("query")[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        results = [None] * 6

        def worker(i):
            c = QueryClient("127.0.0.1", server.port)
            resp = c.query(f"SELECT sum(a) + {i} AS s FROM t")
            results[i] = resp["rows"][0][0]
            c.close()

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(6)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert results == [10 + i for i in range(6)]
        assert server.enforcer.stats.stats("query")[1] == base_n + 6
    finally:
        server.shutdown()


def test_embedded_api_routes_through_policy_enforcer():
    """Database.execute goes through the PolicyEnforcer: three sessions'
    queries all succeed, serialized by its one dispatch thread, and its
    stats see every query."""
    db = Database(device="cpu")
    try:
        db.execute("CREATE TABLE pe (a INT)")
        db.execute("INSERT INTO pe VALUES (1), (2), (3)")
        base_queries = db.policy_enforcer.stats.stats("query")[1]
        results = {}

        def run(session):
            rows = []
            for _ in range(5):
                r = db.execute("SELECT count(*) FROM pe", session=session)
                rows.append(r.rows[0][0])
            results[session] = rows

        threads = [threading.Thread(target=run, args=(f"s{i}",))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(v == [3] * 5 for v in results.values())
        assert db.policy_enforcer.stats.stats("query")[1] == \
            base_queries + 15
    finally:
        db.close()


def test_with_priority_clause_feeds_enforcer():
    """A SELECT ... WITH PRIORITY = n statement carries its priority into
    the enforcer (ParsePriority.hpp analog)."""
    from quickstep_tpu_torch.parser import parse_one

    s = parse_one("SELECT a FROM t WITH PRIORITY = 7")
    assert s.priority == 7
    db = Database(device="cpu")
    try:
        db.execute("CREATE TABLE t (a INT)")
        db.execute("INSERT INTO t VALUES (42)")
        assert db.execute("SELECT a FROM t WITH PRIORITY = 7").rows == \
            [(42,)]
    finally:
        db.close()


def test_segment_granular_interleave():
    """A short query from another session completes while a long streamed
    query is mid-flight: the executor yields to the Database's
    PolicyEnforcer between segments, and both answers are right."""
    from quickstep_tpu_torch.storage.column import Column
    from quickstep_tpu_torch.storage.table import TableData
    from quickstep_tpu_torch.types import INT
    db = Database(device="cpu")
    try:
        n = 400_000
        rng = np.random.default_rng(8)
        k = rng.integers(0, 50, n).astype(np.int32)
        v = rng.integers(0, 100, n).astype(np.int32)
        db.execute("CREATE TABLE big3 (k INT NOT NULL, v INT NOT NULL)")
        rel = db.catalog.default_database.get_relation("big3")
        rel.set_data(TableData({"k": Column(INT, k, None, None),
                                "v": Column(INT, v, None, None)}))
        rel.analyze()
        db.execute("CREATE TABLE small (a INT NOT NULL)")
        db.execute("INSERT INTO small VALUES (1), (2), (3)")
        db.config.hbm_budget_bytes = 128 * 1024   # many segments
        finish_times, out = {}, {}
        long_running = threading.Event()

        orig_yield = db.executor.segment_yield
        assert orig_yield == db.policy_enforcer._yield_between_segments

        def traced_yield():
            long_running.set()
            orig_yield()
        db.executor.segment_yield = traced_yield

        def run_long():
            out["long"] = db.execute(
                "SELECT k, sum(v) FROM big3 GROUP BY k ORDER BY k",
                session="long").rows
            out["info"] = db.executor.last_stream_info
            finish_times["long"] = time.perf_counter()

        def run_short():
            long_running.wait(10)   # submit once the long query streams
            out["short"] = db.execute("SELECT count(*) FROM small",
                                      session="short").rows
            finish_times["short"] = time.perf_counter()

        t1 = threading.Thread(target=run_long)
        t2 = threading.Thread(target=run_short)
        t1.start()
        t2.start()
        t1.join(60)
        t2.join(60)
        assert "short" in finish_times and "long" in finish_times
        assert finish_times["short"] < finish_times["long"], finish_times
        assert out["info"]["segments_run"] > 1
        assert out["short"] == [(3,)]
        want = np.bincount(k, weights=v, minlength=50).astype(np.int64)
        assert out["long"] == [(g, int(want[g])) for g in range(50)]
    finally:
        db.close()
