"""The scan / filter / aggregate / join slices of the port, end to end on
the CPU: the TPC-H queries the port runs (Q1, Q6, the join queries Q3, Q4,
Q5, Q10 and Q2, Q7, Q8, Q12, Q13, Q14, Q17, Q19), single-table lineitem
queries and join shapes through quickstep_tpu_torch.Database against
quickstep_tpu.Database and sqlite on the same SF0.01 data, the retry after a
compaction under-estimate, the catalog-store carrier, and the errors of what
is not ported yet."""

import dataclasses

import pytest
import torch

from quickstep_tpu import Database as JaxDatabase
from quickstep_tpu.bench.tpch import (
    TPCH_QUERIES, ORACLE_OVERRIDES, load_tpch, load_sqlite, to_sqlite_sql,
    with_tiebreak,
)
from quickstep_tpu_torch import Database, from_store
from quickstep_tpu_torch.bench.tpch import load_tpch as port_load_tpch
from quickstep_tpu_torch.errors import ExecutionError
from test_tpch import _row_eq

SCALE = 0.01

EXTRA = {
    "filtered_scalar_aggs": """
        select min(l_extendedprice), max(l_discount), avg(l_quantity),
               count(*), sum(l_tax)
        from lineitem
        where l_shipdate >= date '1995-01-01' and l_quantity < 10""",
    "char_filter_date_minmax": """
        select count(l_orderkey), min(l_shipdate), max(l_receiptdate),
               avg(l_extendedprice * (1 - l_discount))
        from lineitem where l_returnflag = 'R' and l_linenumber <> 3""",
    "group_by_shipmode": """
        select l_shipmode, min(l_extendedprice), max(l_quantity),
               sum(l_discount), count(*)
        from lineitem where l_tax > 0.02
        group by l_shipmode order by l_shipmode""",
    "filter_rows_sorted": """
        select l_orderkey, l_linenumber, l_extendedprice
        from lineitem where l_quantity > 48 and l_discount = 0.1
        order by l_orderkey, l_linenumber""",
}

# Join shapes beyond the TPC-H queries. TPC-H has no NULLs, so the NOT IN
# and IN cases make some with CASE.
JOIN_SHAPES = {
    "anti_not_exists": """
        select o_orderpriority, count(*) from orders
        where o_orderdate >= date '1995-01-01' and not exists (
            select * from lineitem
            where l_orderkey = o_orderkey and l_shipmode = 'AIR')
        group by o_orderpriority order by o_orderpriority""",
    "not_in_null_probe_keys": """
        select count(*), sum(k) from (
            select case when c_acctbal > 0 then c_custkey end as k
            from customer) t
        where k not in (select o_custkey from orders
                        where o_orderdate < date '1993-01-01')""",
    "not_in_null_build_key": """
        select count(*) from customer where c_custkey not in (
            select case when o_totalprice > 100000 then o_custkey end
            from orders)""",
    "in_null_probe_keys": """
        select count(*) from (
            select case when c_acctbal > 0 then c_custkey end as k
            from customer) t
        where k in (select o_custkey from orders
                    where o_orderdate < date '1993-01-01')""",
    "left_join_unique_key_residual": """
        select o_orderpriority, count(c_name), sum(c_acctbal), count(*)
        from orders left join customer
            on o_custkey = c_custkey and c_acctbal * 10 > o_totalprice
        group by o_orderpriority order by o_orderpriority""",
    "two_column_equi_join": """
        select n_name, count(*), sum(l_quantity), max(s_acctbal)
        from lineitem, orders, customer, supplier, nation
        where l_orderkey = o_orderkey and o_custkey = c_custkey
          and l_suppkey = s_suppkey and c_nationkey = s_nationkey
          and s_nationkey = n_nationkey and o_orderdate < date '1994-01-01'
        group by n_name order by n_name""",
}


@pytest.fixture(scope="module")
def engines():
    jdb = JaxDatabase()
    data = load_tpch(jdb, scale=SCALE, seed=0)
    conn = load_sqlite(data)
    # sqlite plans Q19's OR-ed join and the correlated NOT EXISTS as nested
    # loops; key indexes take them from tens of seconds to milliseconds and
    # change no answer
    for table, col in (("lineitem", "l_orderkey"), ("part", "p_partkey")):
        conn.execute(f"create index {col}_idx on {table}({col})")
    tdb = Database(device="cpu")
    port_load_tpch(tdb, scale=SCALE, seed=0)
    yield jdb, tdb, conn
    tdb.close()


def _assert_rows(ours, want, what):
    assert len(ours) == len(want), f"{what}: {len(ours)} vs {len(want)} rows"
    for i, (a, b) in enumerate(zip(ours, want)):
        assert _row_eq(a, b), f"{what} row {i}: {a} != {b}"


@pytest.mark.parametrize("qnum", [1, 6, 3, 4, 5, 10, 2, 7, 8, 12, 13, 14, 17,
                                  19])
def test_tpch_query_matches_reference_and_sqlite(engines, qnum):
    jdb, tdb, conn = engines
    sql = with_tiebreak(qnum, TPCH_QUERIES[qnum])
    ours = tdb.execute(sql).rows
    assert ours, f"Q{qnum} returned no rows"
    _assert_rows(ours, jdb.execute(sql).rows, f"Q{qnum} vs quickstep_tpu")
    oracle_sql = with_tiebreak(qnum, ORACLE_OVERRIDES.get(qnum,
                                                          TPCH_QUERIES[qnum]))
    _assert_rows(ours, conn.execute(to_sqlite_sql(oracle_sql)).fetchall(),
                 f"Q{qnum} vs sqlite")
    assert tdb.executor.host_syncs == 1
    assert tdb.executor.retries == 0


@pytest.mark.parametrize("name", sorted(JOIN_SHAPES))
def test_join_shape_matches_reference_and_sqlite(engines, name):
    jdb, tdb, conn = engines
    sql = JOIN_SHAPES[name]
    ours = tdb.execute(sql).rows
    assert ours, f"{name} returned no rows"
    _assert_rows(ours, jdb.execute(sql).rows, f"{name} vs quickstep_tpu")
    _assert_rows(ours, conn.execute(to_sqlite_sql(sql)).fetchall(),
                 f"{name} vs sqlite")
    assert tdb.executor.host_syncs == 1


def test_compaction_under_estimate_retries_once(engines):
    """With a tiny join_compact_factor every compaction target is too small:
    the runner's flags fire, the executor re-runs the plan without those
    compactions (one retry for these queries; a query whose second run
    overflows a later compaction retries again), gets the right rows, and
    remembers the override, so the next run takes one pass."""
    _jdb, _tdb, conn = engines
    db = Database(dataclasses.replace(_tdb.config, join_compact_factor=1e-4),
                  device="cpu")
    try:
        port_load_tpch(db, scale=SCALE, seed=0)
        for q in (3, 4, 5):
            sql = with_tiebreak(q, TPCH_QUERIES[q])
            want = conn.execute(to_sqlite_sql(sql)).fetchall()
            _assert_rows(db.execute(sql).rows, want, f"Q{q} compacted")
            assert db.executor.retries == 1
            assert db.executor.host_syncs == 2
            _assert_rows(db.execute(sql).rows, want, f"Q{q} again")
            assert db.executor.retries == 0
            assert db.executor.host_syncs == 1
    finally:
        db.close()


def test_duplicate_build_keys_ask_for_the_expansion_join(engines,
                                                         monkeypatch):
    """Without the exact filter, Q4's EXISTS is a semi join on lineitem's
    repeating l_orderkey through the unique path: its dup flag fires, and
    the retry asks for the expansion join, which raises rather than return
    wrong rows."""
    _jdb, tdb, _conn = engines
    monkeypatch.setattr(tdb.config, "use_filter_joins", False)
    monkeypatch.setattr(tdb.executor, "_learned_overrides", {})
    with pytest.raises(ExecutionError, match="expansion join"):
        tdb.execute(TPCH_QUERIES[4])
    assert tdb.executor.retries == 1


@pytest.mark.parametrize("direction", ["asc", "desc"])
def test_order_by_limit_with_nulls_matches_reference(engines, direction):
    """ORDER BY ... LIMIT sorts on the device; NULL keys (the left join's
    unmatched rows) go where the reference puts them, which is not where
    sqlite does, so this compares with the reference alone."""
    jdb, tdb, _conn = engines
    sql = f"""
        select o_orderkey, c_acctbal, o_orderdate from orders left join customer
            on o_custkey = c_custkey and c_acctbal * 10 > o_totalprice
        order by c_acctbal {direction}, o_orderdate desc, o_orderkey
        limit 40"""
    ours = tdb.execute(sql).rows
    assert len(ours) == 40 and tdb.executor.host_syncs == 1
    assert any(r[1] is None for r in ours) == (direction == "desc")
    _assert_rows(ours, jdb.execute(sql).rows, f"{direction} vs quickstep_tpu")


@pytest.mark.parametrize("name", sorted(EXTRA))
def test_lineitem_query_matches_reference_and_sqlite(engines, name):
    jdb, tdb, conn = engines
    sql = EXTRA[name]
    ours = tdb.execute(sql).rows
    assert ours, f"{name} returned no rows"
    _assert_rows(ours, jdb.execute(sql).rows, f"{name} vs quickstep_tpu")
    _assert_rows(ours, conn.execute(to_sqlite_sql(sql)).fetchall(),
                 f"{name} vs sqlite")


def test_from_store_reads_reference_store(engines, tmp_path):
    jdb, _tdb, _conn = engines
    jdb.config.storage_path = str(tmp_path)
    jdb.save()
    db = from_store(str(tmp_path), device="cpu")
    try:
        for q in (1, 6):
            sql = TPCH_QUERIES[q]
            _assert_rows(db.execute(sql).rows, jdb.execute(sql).rows,
                         f"Q{q} from the store")
    finally:
        db.close()


@pytest.mark.parametrize("qnum, what", [
    (9, "expansion join"),
    (21, "_semi_stats_join"),
    (18, "SharedSubplan"),
])
def test_join_query_is_not_ported(engines, qnum, what):
    _jdb, tdb, _conn = engines
    with pytest.raises(ExecutionError, match="not yet ported") as err:
        tdb.execute(TPCH_QUERIES[qnum])
    assert what in str(err.value)


@pytest.mark.parametrize("kwargs, error", [
    ({}, TypeError),
    ({"device": "mps"}, ValueError),
    ({"device": "cuda"}, RuntimeError),
])
def test_device_must_be_named(kwargs, error):
    if kwargs.get("device") == "cuda" and torch.cuda.is_available():
        pytest.skip("this case is about a machine without CUDA")
    with pytest.raises(error):
        Database(**kwargs)
