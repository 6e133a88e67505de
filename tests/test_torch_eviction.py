"""Eviction under the device memory budget in the port: the copied
policies of storage/eviction.py (tests/test_eviction.py's cases), the
executor evicting resident tables by them, and a sequence of TPC-H queries
whose resident tables and streamed segments stay within the budget while
it evicts."""

import pytest

from quickstep_tpu_torch import Database
from quickstep_tpu_torch.bench.tpch import (
    TPCH_QUERIES, load_tpch, with_tiebreak)
from quickstep_tpu_torch.config import Config
from quickstep_tpu_torch.storage.eviction import (
    EvictAnyPolicy, LRUKPolicy, UniformRandomPolicy, make_policy)


def test_lru1_is_classic_lru():
    p = LRUKPolicy(1)
    for key in ("a", "b", "c"):
        p.block_referenced(key)
    p.block_referenced("a")          # a is now most recent
    assert p.choose_victim(["a", "b", "c"]) == "b"


def test_lruk_scan_resistance():
    """A hot entry referenced twice survives over a newer one-touch scan."""
    p = LRUKPolicy(2)
    p.block_referenced("hot")
    p.block_referenced("hot")        # 2 references -> finite K-distance
    p.block_referenced("scan")       # 1 reference  -> infinite K-distance
    assert p.choose_victim(["hot", "scan"]) == "scan"
    p.block_referenced("hot")        # hot: ticks (2, 4)
    p.block_referenced("scan")       # scan: ticks (3, 5)
    assert p.choose_victim(["hot", "scan"]) == "hot"


def test_factory():
    assert isinstance(make_policy("lru-k", k=2), LRUKPolicy)
    assert isinstance(make_policy("lru"), LRUKPolicy)
    assert isinstance(make_policy("uniform-random"), UniformRandomPolicy)
    assert isinstance(make_policy("evict-any"), EvictAnyPolicy)
    with pytest.raises(ValueError):
        make_policy("clock")


def test_executor_budget_eviction():
    """Under a tight budget, faulting a second table evicts per policy and
    queries still work (re-fault on next use)."""
    db = Database(config=Config(hbm_budget_bytes=1, display_timing=False),
                  device="cpu")
    try:
        for t in ("t1", "t2"):
            db.execute(f"CREATE TABLE {t} (a INT NOT NULL)")
            db.execute(f"INSERT INTO {t} VALUES (1), (2), (3)")
        assert db.execute("SELECT SUM(a) FROM t1").rows == [(6,)]
        assert db.execute("SELECT SUM(a) FROM t2").rows == [(6,)]
        # budget of 1 byte: at most one resident table at a time
        assert list(db.executor._device_cache) == [("t2", 1)]
        assert db.execute("SELECT SUM(a) FROM t1").rows == [(6,)]
        assert list(db.executor._device_cache) == [("t1", 1)]
    finally:
        db.close()


def test_policy_read_when_a_plan_runs():
    """The budget, the policy and its K are read when a plan runs, not
    only when the executor is made: a live database with no budget takes
    a new policy and then a budget, evicts by them when a table is
    uploaded, and refuses an unknown policy."""
    db = Database(device="cpu")
    try:
        for t in ("t1", "t2", "t3", "t4"):
            db.execute(f"CREATE TABLE {t} (a INT NOT NULL)")
            db.execute(f"INSERT INTO {t} VALUES (1), (2), (3)")
        for t in ("t1", "t2", "t3"):
            db.execute(f"SELECT SUM(a) FROM {t}")
        assert len(db.executor._device_cache) == 3
        db.config.eviction_policy = "lru"
        db.execute("SELECT SUM(a) FROM t1")      # t1 most recent
        assert db.executor._eviction_spec == ("lru", 2)
        db.config.hbm_budget_bytes = 24          # two 12-byte tables
        assert db.execute("SELECT SUM(a) FROM t4").rows == [(6,)]
        # the least recently used went first, t2 then t3
        assert sorted(k[0] for k in db.executor._device_cache) == \
            ["t1", "t4"]
        db.config.eviction_policy = "clock"
        with pytest.raises(ValueError, match="clock"):
            db.execute("SELECT SUM(a) FROM t1")
    finally:
        db.close()


# a sequence at SF0.01 under 10^6 bytes: Q18 reads lineitem over half the
# budget with no streamable shape (strict_hbm_budget is off), so it runs
# resident and evicts the rest; the others stream lineitem
SEQUENCE = (3, 5, 18, 10, 9, 3, 7, 18, 5)
SEQUENCE_BUDGET = 1_000_000


def test_budget_holds_across_an_evicting_sequence():
    """After each query of SEQUENCE the resident tables' bytes (those of
    the tensors held) and the segment cache's stay within the budget, and
    tables are evicted on the way."""
    db = Database(config=Config(hbm_budget_bytes=SEQUENCE_BUDGET),
                  device="cpu")
    try:
        load_tpch(db, scale=0.01, seed=0)
        ex = db.executor
        evictions = []
        real = ex._eviction.block_evicted

        def spy(key):
            evictions.append(key)
            real(key)
        ex._eviction.block_evicted = spy
        streamed = 0
        for q in SEQUENCE:
            db.execute(with_tiebreak(q, TPCH_QUERIES[q]))
            info = ex.last_stream_info
            streamed += info is not None and info["segments_run"] > 1
            held = sum(m["bytes"] for _c, m in ex._device_cache.values())
            tensors = sum(t.numel() * t.element_size()
                          for cols, _m in ex._device_cache.values()
                          for name, pair in cols.items()
                          if name != "__num_rows__"
                          for t in pair if t is not None)
            assert held == tensors, q
            assert held + ex._seg_cache_bytes <= SEQUENCE_BUDGET, \
                (q, held, ex._seg_cache_bytes)
        assert streamed == len(SEQUENCE) - 2
        assert ("lineitem", 1) in evictions
        assert len(set(evictions)) > 1, evictions
    finally:
        db.close()
