"""The port against quickstep_tpu over bench/differential.py's edge-case
databases on the CPU: the full outer join, ORDER BY, expressions and
CAST (each case its family's share of one seed's battery, as
differential_engines.Engines.check runs it); then the
float-to-integer CAST at its edges against quickstep_tpu, value by value,
the battery's other two repairs (a DECIMAL SUM beside infinite float
statistics, COUNT(DISTINCT) over NaN) against sqlite, and a shape where
quickstep_tpu is wrong, held against sqlite."""

import math
import sqlite3

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quickstep_tpu
from differential_engines import (REFERENCE_MODULES, Engines, cases,
                                  mesh_database)
from quickstep_tpu_torch import Database
from quickstep_tpu_torch.bench import differential as D
from quickstep_tpu_torch.expressions.scalar import float_to_int

FAMILIES = ("full_join", "order_by", "expressions", "cast")


@pytest.fixture(scope="module")
def engines():
    e = Engines()
    yield e
    e.close()


@pytest.mark.parametrize("seed,family", cases(FAMILIES))
def test_port_matches_reference(engines, seed, family):
    engines.check(seed, family)


# ---------------------------------------------------------------------
# CAST(DOUBLE or REAL AS INT, BIGINT, DECIMAL(15,2)): saturated at the
# target's bounds, NaN to 0, as quickstep_tpu's astype (XLA's convert)
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def cast_rows():
    tables = D.cast_tables()
    tdb, jdb = Database(device="cpu"), quickstep_tpu.Database()
    D.load_tables(tdb, tables)
    D.load_tables(jdb, tables, REFERENCE_MODULES)
    rows = {key: (D.run_query(tdb, q)[1], D.run_query(jdb, q)[1])
            for key, q in D.CAST_QUERIES.items()}
    tdb.close()
    return rows


@pytest.mark.parametrize("value", range(len(D.CAST_VALUES)),
                         ids=[repr(v) for v in D.CAST_VALUES])
@pytest.mark.parametrize("src,dst", sorted(D.CAST_QUERIES))
def test_float_cast_matches_reference(cast_rows, src, dst, value):
    ours, want = cast_rows[(src, dst)]
    # (id, CAST): the source column itself may be NaN
    assert ours[value][::2] == want[value][::2], (src, dst,
                                                  D.CAST_VALUES[value])
    # the result is the target's own: never past its bounds
    if dst == "INT":
        assert -2**31 <= ours[value][2] < 2**31


@pytest.mark.parametrize("out", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_float_to_int_matches_astype(dtype, out):
    """float_to_int against jnp's astype over the edges and a spread of
    values about each bound."""
    bound = float(2**31 if out == torch.int32 else 2**63)
    x = np.concatenate([
        np.asarray(D.CAST_VALUES), [bound, -bound, bound * 2, -bound * 2],
        np.nextafter(bound, 0) * np.asarray([1, -1]),
        np.random.default_rng(0).normal(size=200) * bound]).astype(dtype)
    want = np.asarray(jnp.asarray(x).astype(
        jnp.int32 if out == torch.int32 else jnp.int64))
    got = float_to_int(torch.from_numpy(x), out).numpy()
    np.testing.assert_array_equal(got, want)


def test_dropped_table_name_reference_fault():
    """quickstep_tpu keys its device copies on (name, version) and keeps
    them across DROP TABLE (exec/executor.py:190-191, :1083), so a new
    table of a dropped one's name reads the dropped rows; the port drops
    the copies with the table. Held against sqlite; the reference's stale
    rows are asserted, so that a repair of it shows here."""
    script = ["CREATE TABLE t (a INT)", "INSERT INTO t VALUES (1), (2)",
              "SELECT count(*), sum(a) FROM t", "DROP TABLE t",
              "CREATE TABLE t (a INT)", "INSERT INTO t VALUES (5), (6), (7)"]
    tdb, jdb = Database(device="cpu"), quickstep_tpu.Database()
    conn = sqlite3.connect(":memory:")
    for stmt in script:
        for db in (tdb, jdb):
            db.execute(stmt)
        conn.execute(stmt)
    sql = "SELECT count(*), sum(a) FROM t"
    assert [tuple(r) for r in tdb.execute(sql).rows] == \
        conn.execute(sql).fetchall() == [(3, 18)]
    assert [tuple(r) for r in jdb.execute(sql).rows] == [(2, 3)]
    tdb.close()


def _one_table(cols):
    return {"t": D.Table("t", [D.Col(name, sql_type, np.asarray(data), valid)
                               for name, sql_type, data, valid in cols])}


def test_decimal_sum_over_infinite_statistics():
    """A DECIMAL SUM over a scan whose DOUBLE column holds +-inf (and no
    NaN): the sum's overflow guard took int() of the column's statistics
    and raised OverflowError, as quickstep_tpu still does
    (optimizer/resolver.py:656-658). Held against sqlite."""
    tables = _one_table([
        ("k", "INT", np.arange(6, dtype=np.int32) % 2, None),
        ("d", "DOUBLE", np.asarray([1.5, math.inf, -2.0, -math.inf, 0.0,
                                    3.0]), None),
        ("m", "DECIMAL(15,2)", np.asarray([125, -300, 10**12, 7, 0, 1],
                                          np.int64), None)])
    sql = "SELECT k, sum(m), max(d), count(*) FROM t GROUP BY k"
    tdb, jdb = Database(device="cpu"), quickstep_tpu.Database()
    D.load_tables(tdb, tables)
    D.load_tables(jdb, tables, REFERENCE_MODULES)
    conn = sqlite3.connect(":memory:")
    D.load_sqlite(conn, tables)
    assert D.same_rows(tdb.execute(sql).rows, conn.execute(sql).fetchall(),
                       D.Query("sum", sql), tables) is None
    with pytest.raises(OverflowError):
        jdb.execute(sql)
    tdb.close()


@pytest.mark.parametrize("sql_type", ["REAL", "DOUBLE"])
def test_count_distinct_counts_no_nan(sql_type):
    """COUNT(DISTINCT x) of a float column with NaN, NULL, both zeros and
    both infinities counts the distinct values that are not NaN, on one
    device and on the mesh, as sqlite does (it stores NaN as NULL). The
    port counted each NaN where it had no padding row, and its mesh one
    NaN; quickstep_tpu's count depends on its padding
    (ops/groupby.py:455-468): at 1,024 rows it has none, and counts each
    NaN."""
    rng = np.random.default_rng(5)
    x = rng.integers(0, 50, 1024).astype(np.float64)
    x[:12] = [math.nan, math.nan, -math.nan, 0.0, -0.0, math.inf, -math.inf,
              math.nan, 1.5, 1.5, -0.0, math.nan]
    x = x.astype(np.float32 if sql_type == "REAL" else np.float64)
    for valid in (None, rng.random(1024) > 0.1):
        tables = _one_table([("x", sql_type, x, valid)])
        live = x if valid is None else x[valid]
        want = len(np.unique(live[~np.isnan(live)]))
        sql = "SELECT count(DISTINCT x) FROM t"
        conn = sqlite3.connect(":memory:")
        D.load_sqlite(conn, tables)
        assert conn.execute(sql).fetchall() == [(want,)]
        for db in (Database(device="cpu"), mesh_database("cpu")):
            D.load_tables(db, tables)
            assert db.execute(sql).rows == [(want,)]
            db.close()
        if valid is None:
            jdb = quickstep_tpu.Database()
            D.load_tables(jdb, tables, REFERENCE_MODULES)
            assert jdb.execute(sql).rows == [(want + int(np.isnan(x).sum()),)]
