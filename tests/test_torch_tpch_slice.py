"""The port end to end on the CPU: all 22 TPC-H queries (and a Q20 whose
p_name prefix has rows at this scale), single-table lineitem queries and
join and aggregate shapes through quickstep_tpu_torch.Database against
quickstep_tpu.Database and sqlite on the same SF0.01 data, with the path
each new shape must take; the retries after a compaction under-estimate and
a duplicate build key; the full generator's oracles (Q2, Q8, Q9, Q11 and
its variant with the specification's fraction, Q13, Q15, Q16, Q17, Q20,
Q21, Q22) against sqlite; the exact window oracles against sqlite and the
port; the catalog-store carrier; and the queries that were once not
ported."""

import dataclasses
import math

import pytest
import torch

from quickstep_tpu import Database as JaxDatabase
from quickstep_tpu.bench.tpch import (
    TPCH_QUERIES, ORACLE_OVERRIDES, load_tpch, load_sqlite, to_sqlite_sql,
    with_tiebreak,
)
from quickstep_tpu_torch import Database, from_store
from quickstep_tpu_torch.bench.tpch import load_tpch as port_load_tpch
from quickstep_tpu_torch.ops import groupby as TG
from quickstep_tpu_torch.ops import join as TJ
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
    "inner_expand_many_to_many": """
        select l_returnflag, count(*), sum(ps_supplycost * l_quantity)
        from lineitem, partsupp
        where ps_partkey = l_partkey and l_shipdate < date '1993-01-01'
        group by l_returnflag order by l_returnflag""",
    "left_expand_residual": """
        select c_mktsegment, count(o_orderkey), count(*), sum(o_totalprice)
        from customer left join orders
            on c_custkey = o_custkey and o_totalprice > 200000
        group by c_mktsegment order by c_mktsegment""",
    "semi_residual_run_stats": """
        select count(*), sum(l_quantity) from lineitem l1 where exists (
            select * from lineitem l2 where l2.l_orderkey = l1.l_orderkey
              and l2.l_suppkey <> l1.l_suppkey)""",
    "anti_residual_run_stats": """
        select count(*) from lineitem l1 where not exists (
            select * from lineitem l2 where l2.l_orderkey = l1.l_orderkey
              and l2.l_linenumber < l1.l_linenumber)""",
    "semi_residual_run_stats_wide": """
        select count(*) from lineitem l1 where exists (
            select * from lineitem l2 where l2.l_orderkey = l1.l_orderkey
              and l2.l_extendedprice * 1.5 < l1.l_extendedprice)""",
    "semi_residual_expand": """
        select count(*) from lineitem l1 where exists (
            select * from lineitem l2 where l2.l_orderkey = l1.l_orderkey
              and l2.l_suppkey + l1.l_suppkey > 150)""",
    "anti_residual_expand": """
        select count(*) from orders where not exists (
            select * from lineitem where l_orderkey = o_orderkey
              and (l_quantity > 45 or l_discount * 100 > o_totalprice / 1000))""",
    "distinct_with_plain_aggregates": """
        select l_returnflag, count(distinct l_suppkey), sum(l_quantity),
               count(distinct l_partkey), max(l_tax)
        from lineitem group by l_returnflag order by l_returnflag""",
    "distinct_sum_and_count": """
        select o_orderpriority, sum(distinct o_shippriority),
               count(distinct o_custkey)
        from orders group by o_orderpriority order by o_orderpriority""",
    "scalar_subquery_in_select_list": """
        select n_name, (select count(*) from region) from nation
        where n_regionkey = 1 order by n_name""",
    "with_clause_read_twice": """
        with big as (select o_custkey, sum(o_totalprice) as t
                     from orders group by o_custkey)
        select count(*), max(t) from big where t > (select avg(t) from big)""",
}

# The join or aggregate function each new shape must reach (through the
# ops module, so on the card its kernel), and those it must not.
SHAPE_PATHS = {
    "inner_expand_many_to_many": ((TJ, "expand_probe"), ()),
    "left_expand_residual": ((TJ, "expand_probe"), ()),
    "semi_residual_run_stats": ((TJ, "merge_cmp_probe"),
                                ((TJ, "expand_probe"),)),
    "anti_residual_run_stats": ((TJ, "merge_cmp_probe"),
                                ((TJ, "expand_probe"),)),
    # float values: per-group min/max by the sort group-by and a unique probe
    "semi_residual_run_stats_wide": ((TJ, "merge_unique_probe"),
                                     ((TJ, "merge_cmp_probe"),
                                      (TJ, "expand_probe"))),
    # residuals that are not one comparison: the expansion join
    "semi_residual_expand": ((TJ, "expand_probe"),
                             ((TJ, "merge_cmp_probe"),)),
    "anti_residual_expand": ((TJ, "expand_probe"),
                             ((TJ, "merge_cmp_probe"),)),
    "distinct_with_plain_aggregates": ((TG, "sort_groupby_compact"), ()),
    "distinct_sum_and_count": ((TG, "sort_groupby_compact"), ()),
}

# Queries whose cold run retries once: Q9's composite-key expansion starts
# at K = 8 without statistics for the pair and overflows (the reference
# does the same); the warm run takes the learned width in one pass.
COLD_RETRY = {9}


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
                                  19, 9, 11, 15, 16, 18, 20, 21, 22])
def test_tpch_query_matches_reference_and_sqlite(engines, qnum):
    jdb, tdb, conn = engines
    sql = with_tiebreak(qnum, TPCH_QUERIES[qnum])
    tdb.executor._learned_overrides.clear()
    ours = tdb.execute(sql).rows
    if qnum in COLD_RETRY:
        assert tdb.executor.retries == 1 and tdb.executor.host_syncs == 2
        assert tdb.execute(sql).rows == ours
    # the spec's Q20 has no rows at SF0.01; test_q20_with_rows has
    assert ours or qnum == 20, f"Q{qnum} returned no rows"
    _assert_rows(ours, jdb.execute(sql).rows, f"Q{qnum} vs quickstep_tpu")
    oracle_sql = with_tiebreak(qnum, ORACLE_OVERRIDES.get(qnum,
                                                          TPCH_QUERIES[qnum]))
    _assert_rows(ours, conn.execute(to_sqlite_sql(oracle_sql)).fetchall(),
                 f"Q{qnum} vs sqlite")
    assert tdb.executor.host_syncs == 1
    assert tdb.executor.retries == 0


@pytest.mark.parametrize("prefix", ["green", "lime"])
def test_q20_with_rows_matches_reference_and_sqlite(engines, prefix):
    """Q20 with a p_name prefix that selects parts whose suppliers qualify
    at SF0.01 (the spec's 'forest' selects none there)."""
    jdb, tdb, conn = engines
    sql = TPCH_QUERIES[20].replace("'forest%'", f"'{prefix}%'")
    ours = tdb.execute(sql).rows
    assert ours, f"Q20 ({prefix}%) returned no rows"
    assert tdb.executor.host_syncs == 1 and tdb.executor.retries == 0
    _assert_rows(ours, jdb.execute(sql).rows, "Q20 vs quickstep_tpu")
    _assert_rows(ours, conn.execute(to_sqlite_sql(sql)).fetchall(),
                 "Q20 vs sqlite")


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


@pytest.mark.parametrize("name", sorted(SHAPE_PATHS))
def test_join_shape_takes_its_path(engines, name, monkeypatch):
    _jdb, tdb, _conn = engines
    (mod, must), never = SHAPE_PATHS[name]
    calls = []
    for m, fn in ((mod, must),) + never:
        real = getattr(m, fn)

        def spy(*args, _fn=fn, _real=real, **kwargs):
            calls.append(_fn)
            return _real(*args, **kwargs)
        monkeypatch.setattr(m, fn, spy)
    tdb.execute(JOIN_SHAPES[name])
    assert must in calls, (name, calls)
    assert not any(fn in calls for _m, fn in never), (name, calls)


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
    repeating l_orderkey through the unique path: its dup flag fires, the
    retry takes the expansion join and returns the right rows, and the next
    run takes it in one pass."""
    _jdb, tdb, conn = engines
    monkeypatch.setattr(tdb.config, "use_filter_joins", False)
    monkeypatch.setattr(tdb.executor, "_learned_overrides", {})
    calls = []
    real = TJ.expand_probe
    monkeypatch.setattr(TJ, "expand_probe",
                        lambda *a: calls.append(1) or real(*a))
    want = conn.execute(to_sqlite_sql(TPCH_QUERIES[4])).fetchall()
    _assert_rows(tdb.execute(TPCH_QUERIES[4]).rows, want, "Q4 retried")
    assert tdb.executor.retries == 1 and tdb.executor.host_syncs == 2
    assert calls == [1]
    _assert_rows(tdb.execute(TPCH_QUERIES[4]).rows, want, "Q4 again")
    assert tdb.executor.retries == 0 and tdb.executor.host_syncs == 1
    assert calls == [1, 1]


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


@pytest.mark.parametrize("sql, what", [
    ("select count(*) from nation full outer join region"
     " on n_regionkey = r_regionkey", "full outer join"),
    ("select count(*) from nation, region", "cross join"),
    ("select n_nationkey from nation intersect"
     " select r_regionkey from region", "operator"),
    ("select count(distinct l_suppkey) from lineitem",
     "scalar DISTINCT aggregate"),
], ids=["full_outer_join", "cross_join", "set_operation",
        "scalar_count_distinct"])
def test_join_query_is_not_ported(engines, sql, what):
    """Queries that the port once refused as not yet ported (`what` named
    the missing piece) now run, with quickstep_tpu's rows."""
    jdb, tdb, _conn = engines
    ours = tdb.execute(sql).rows
    assert ours, what
    _assert_rows(ours, jdb.execute(sql).rows, f"{what} vs quickstep_tpu")


@pytest.fixture(scope="module")
def fullgen_small():
    """The full generator's tables at SF0.01 in the port and in sqlite, with
    its oracle."""
    from quickstep_tpu_torch.bench.tpch import load_sqlite as port_sqlite
    from quickstep_tpu_torch.bench.tpch_fullgen import (
        extra_oracles, generate, load_tables, window_oracles)
    tables, stats, oracle = generate(SCALE, log=lambda msg: None)
    conn = port_sqlite({n: t.table_data() for n, t in tables.items()})
    # sqlite runs the correlated subqueries as nested loops; key indexes
    # make them fast and change no answer
    for table, col in (("lineitem", "l_orderkey"), ("lineitem", "l_partkey"),
                       ("part", "p_partkey"), ("partsupp", "ps_partkey")):
        conn.execute(f"create index {col}_idx on {table}({col})")
    db = Database(device="cpu")
    load_tables(db, tables, stats)
    oracle.update(extra_oracles(tables, q11_fraction=Q11_SPEC_FRACTION))
    oracle.update(window_oracles(tables))
    yield db, conn, oracle
    db.close()


# Q11 with the specification's fraction, 0.0001 / SF, at SF0.01 (the bench
# text keeps 0.0001 at every scale): 3 rows here
Q11_SPEC_FRACTION = "0.01"
# rows of each full-generator oracle at SF0.01
FULLGEN_ROWS = {2: 1, 8: 2, 9: 172, 11: 345, 13: 24, 15: 1, 16: 296, 17: 1,
                20: 2, 21: 6, 22: 7, "q11_spec": 3}


@pytest.mark.parametrize("qnum", [2, 8, 9, 11, 13, 15, 16, 17, 20, 21, 22,
                                  "q11_spec"])
def test_full_generator_oracle_matches_sqlite_and_port(fullgen_small, qnum):
    """The exact oracles of bench/tpch_fullgen.py's extra_oracles (the
    queries its generator's oracle lacks, and Q11 with the specification's
    fraction) against sqlite on the same tables (sqlite sums DECIMALs as
    doubles: rel 1e-9) and the port's rows against the oracle at its own
    tolerance (check_rows)."""
    from quickstep_tpu_torch.bench.tpch import ORACLE_OVERRIDES
    from quickstep_tpu_torch.bench.tpch_fullgen import (
        check_rows, q11_with_fraction)
    db, conn, oracle = fullgen_small
    name = qnum if isinstance(qnum, str) else f"q{qnum}"
    want = oracle[name]
    assert want, f"{name}'s oracle is empty"
    assert len(want) == FULLGEN_ROWS[qnum]
    if qnum == "q11_spec":
        sql = sqlite_sql = q11_with_fraction(Q11_SPEC_FRACTION)
    else:
        sql = with_tiebreak(qnum, TPCH_QUERIES[qnum])
        sqlite_sql = with_tiebreak(qnum, ORACLE_OVERRIDES.get(
            qnum, TPCH_QUERIES[qnum]))
    got = conn.execute(to_sqlite_sql(sqlite_sql)).fetchall()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for x, y in zip(g, w):
            assert (math.isclose(x, y, rel_tol=1e-9, abs_tol=0.0)
                    if isinstance(y, float) else x == y), (g, w)
    check_rows(qnum, db.execute(sql).rows, oracle)


def test_full_generator_oracle_ties(fullgen_small):
    """The oracles that compare with a computed value count the rows whose
    two sides are equal in exact integers (and how many the engine's
    comparison keeps); Q15's two largest revenues differ, so its = with its
    own MAX keeps one supplier."""
    _db, _conn, oracle = fullgen_small
    ties = oracle["ties"]
    print("exact-integer ties:", ties)
    for name in ("q11", "q11_spec", "q17", "q20", "q22"):
        assert 0 <= ties[name]["kept"] <= ties[name]["rows"], name
    # decided by exact decimal > : a tie is never kept
    assert ties["q11"]["kept"] == ties["q11_spec"]["kept"] == \
        ties["q20"]["kept"] == 0
    top, second = ties["q15_top2"]
    assert top > second and len(oracle["q15"]) == 1


def test_full_generator_declares_partsupp_pairs_unique(fullgen_small):
    """At SF0.01 a part's four suppliers differ, and load_tables keeps the
    generator's declaration that (ps_partkey, ps_suppkey) is unique; below
    it they repeat, and it drops it (tests/test_torch_sf_verify.py)."""
    db, conn, _oracle = fullgen_small
    ps = db.catalog.default_database.get_relation("partsupp")
    assert ps.statistics.unique_pairs == [["ps_partkey", "ps_suppkey"]]
    (n,), = conn.execute("select count(*) from partsupp").fetchall()
    (pairs,), = conn.execute("select count(*) from (select distinct "
                             "ps_partkey, ps_suppkey from partsupp)").fetchall()
    assert pairs == n


@pytest.mark.parametrize("name", ["w1", "w2", "w3", "w4", "w5", "w6"])
def test_window_oracle_matches_sqlite_and_port(fullgen_small, name):
    """bench/tpch_fullgen.py's exact window oracles against sqlite on the
    same tables (sqlite sums DECIMALs as doubles: rel 1e-9; W-Q5's RANGE
    over the date's code) and the port's rows against the oracle
    (check_rows at WINDOW_REL_TOL)."""
    from quickstep_tpu_torch.bench.tpch_fullgen import (
        WINDOW_QUERIES, WINDOW_REL_TOL, check_rows)
    from test_torch_window import SQLITE_SQL
    db, conn, oracle = fullgen_small
    want = oracle[name]
    sql = SQLITE_SQL.get(name, WINDOW_QUERIES[name])
    got = conn.execute(to_sqlite_sql(sql)).fetchall()
    assert len(got) == len(want) == 1
    for x, y in zip(got[0], want[0]):
        assert (math.isclose(x, y, rel_tol=1e-9, abs_tol=0.0)
                if isinstance(y, float) else x == y), (got, want)
    check_rows(name, db.execute(WINDOW_QUERIES[name]).rows, oracle,
               WINDOW_REL_TOL)


@pytest.mark.parametrize("kwargs, error", [
    # the default is the card: without one it raises, never a quiet CPU run
    ({}, RuntimeError),
    ({"device": "mps"}, ValueError),
    ({"device": "cuda"}, RuntimeError),
])
def test_device_must_be_named(kwargs, error):
    if kwargs.get("device", "cuda") == "cuda" and torch.cuda.is_available():
        pytest.skip("this case is about a machine without CUDA")
    with pytest.raises(error):
        Database(**kwargs)
