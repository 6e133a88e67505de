"""The cases of tests/test_pushdown.py run against quickstep_tpu_torch
(Database(device="cpu") and the port's copies).

Plan-shape tests for the round-4 semi-join / implied-predicate rewrites.

Covers the plan-level LIP-push analog of the reference's
utility/lip_filter/LIPFilterGenerator.cpp (filters from a selective join side
applied far below the join):
- implied per-relation predicates derived from OR residuals (Q7/Q19 shape)
- semi joins pushed into decorrelated aggregates (Q17/Q2/Q20 shape)
- selective semi/anti builds pushed down to the probe leaf (Q18 shape)
Row correctness for all rewritten queries is covered by tests/test_tpch.py's
sqlite oracle; these tests pin the plan SHAPES so regressions are visible.
"""

import pytest

from quickstep_tpu_torch import Database
from quickstep_tpu_torch.bench.tpch import load_tpch, TPCH_QUERIES


@pytest.fixture(scope="module")
def db():
    d = Database(device="cpu")
    load_tpch(d, scale=0.01, seed=0)
    yield d
    d.close()


def plan_of(db, q):
    sql = " ".join(TPCH_QUERIES[q].split())
    return db.execute("\\explain " + sql).message.split("digraph")[0]


def test_q19_or_implied_filters_on_both_scans(db):
    plan = plan_of(db, 19)
    # both join inputs carry a derived Filter (from the OR residual), so the
    # join runs at filtered size
    assert "Filter\n          TableScan[lineitem]" in plan.replace("  ", "  ")
    assert plan.count("Filter") >= 3  # residual + 2 derived


def test_q7_nation_filters_derived(db):
    plan = plan_of(db, 7)
    # each nation scan gets an implied IN-filter from the OR of nation pairs
    assert plan.count("Filter\n") >= 3
    assert "TableScan[nation AS n1]" in plan
    n1_region = plan.split("TableScan[nation AS n1]")[0]
    assert n1_region.rstrip().endswith("Filter")


def test_q17_semi_into_aggregate(db):
    plan = plan_of(db, 17)
    agg_part = plan.split("Aggregate[group: l_partkey")[1]
    assert "Join[semi; l_partkey=p_partkey]" in agg_part


def test_q18_semi_pushed_to_orders_leaf(db):
    plan = plan_of(db, 18)
    # the sum(qty)>300 orderkey set applies directly to the orders scan
    semi_at = plan.index("Join[semi; o_orderkey=l_orderkey]")
    orders_at = plan.index("TableScan[orders]")
    assert semi_at < orders_at
    # eager aggregation replaced the lineitem⋈orders expansion join with a
    # unique join against the pre-aggregated per-orderkey partials, and CSE
    # shares that aggregate with the HAVING subquery's
    assert plan.index("Join[inner; eagg_k0=o_orderkey]") < semi_at
    assert plan.count("SharedSubplanRef[__cse_0]") == 2


def test_q21_semi_not_pushed(db):
    # Q21's semi/anti builds cover ~every orderkey: pushing them to the l1
    # leaf would probe 25x more rows than at the top. They must stay put.
    plan = plan_of(db, 21)
    anti_at = plan.index("Join[anti; l_orderkey=l_orderkey]")
    inner_at = plan.index("Join[inner; l_orderkey=o_orderkey]")
    assert anti_at < inner_at


def test_q2_semi_into_aggregate_then_leaf(db):
    plan = plan_of(db, 2)
    agg_part = plan.split("Aggregate[group: ps_partkey")[1]
    assert "Join[semi; ps_partkey=p_partkey]" in agg_part


def test_or_derivation_correctness(db):
    # cross-table OR: derived per-table filters must not change results
    rows = db.execute(
        "select count(*) from lineitem, part where l_partkey = p_partkey "
        "and ((p_size = 1 and l_quantity < 10) "
        "  or (p_size = 2 and l_quantity > 40))").rows
    import sqlite3
    from quickstep_tpu_torch.bench.tpch import load_sqlite
    from quickstep_tpu_torch.bench.tpchgen import generate
    conn = load_sqlite(generate(0.01, 0))
    want = conn.execute(
        "select count(*) from lineitem, part where l_partkey = p_partkey "
        "and ((p_size = 1 and l_quantity < 10) "
        "  or (p_size = 2 and l_quantity > 40))").fetchone()[0]
    assert rows[0][0] == want
