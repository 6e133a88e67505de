"""The port's operators beyond TPC-H on the CPU, against quickstep_tpu and
sqlite: the counterparts of tests/test_join_collision.py (the weak-hash
hook), test_full_join.py, test_setops_null.py, test_decorrelation.py and
test_index.py; joins on keys that must be hashed; every operator over inputs
of zero rows; the SF10 operator queries (bench/tpch_fullgen.py
OPERATOR_QUERIES and O-DML) at SF0.01.

Rows are compared as tests/test_tpch.py compares them (floats within rel
1e-9), as multisets where the statement has no ORDER BY."""

import sqlite3

import pytest

import quickstep_tpu
from quickstep_tpu.bench.tpch import load_tpch, load_sqlite, to_sqlite_sql
from quickstep_tpu_torch import Database, from_store
from quickstep_tpu_torch.bench.tpch import load_tpch as port_load_tpch
from quickstep_tpu_torch.bench.zero_rows import (
    ZERO_ROW_QUERIES, ZERO_ROW_SCRIPT)
from quickstep_tpu_torch.bench.tpch_fullgen import (
    OPERATOR_DML, OPERATOR_DML_QUERY, OPERATOR_QUERIES, operator_dml_ddl)
from quickstep_tpu_torch.catalog.catalog import sma_range_for
from quickstep_tpu_torch.errors import ExecutionError, SqlError
from quickstep_tpu_torch.ops import kernels as TK
from quickstep_tpu_torch.ops import sort as TS
from test_tpch import _row_eq


def _key(t):
    return tuple((v is None, v) for v in t)


def _same_rows(ours, want, what, ordered=False):
    ours, want = [tuple(r) for r in ours], [tuple(r) for r in want]
    if not ordered:
        ours, want = sorted(ours, key=_key), sorted(want, key=_key)
    assert len(ours) == len(want), f"{what}: {ours} vs {want}"
    for a, b in zip(ours, want):
        assert _row_eq(a, b), f"{what}: {a} != {b}"


def _engines(script, sqlite_script=None):
    """(port, quickstep_tpu, sqlite) databases after running the script's
    statements (sqlite_script where sqlite needs other DDL)."""
    tdb, jdb = Database(device="cpu"), quickstep_tpu.Database()
    conn = sqlite3.connect(":memory:")
    for stmt in script:
        tdb.execute(stmt)
        jdb.execute(stmt)
    for stmt in sqlite_script or script:
        conn.execute(stmt)
    return tdb, jdb, conn


# ---------------------------------------------------------------------
# tests/test_join_collision.py: the weak-hash hook collides nearly every
# pair, so correct rows prove the key verification
# ---------------------------------------------------------------------

@pytest.fixture
def weak():
    tdb, jdb, _conn = _engines([
        "CREATE TABLE probe (a INT NOT NULL, b INT NOT NULL, pv INT NOT NULL)",
        "CREATE TABLE build (a INT NOT NULL, b INT NOT NULL, bv INT NOT NULL)",
        "INSERT INTO probe VALUES (1, 1, 10), (1, 2, 11), (2, 1, 12), "
        "(4, 7, 13), (5, 0, 14), (9, 9, 15)",
        "INSERT INTO build VALUES (1, 1, 100), (1, 1, 101), (2, 0, 102), "
        "(0, 2, 103), (4, 7, 104), (3, 6, 105), (5, 1, 106)"])
    tdb.config.test_weak_hash_join = True
    jdb.config.test_weak_hash_join = True
    yield tdb, jdb
    tdb.close()


WEAK_CASES = {
    "inner": ("SELECT pv, bv FROM probe, build WHERE probe.a = build.a AND "
              "probe.b = build.b ORDER BY pv, bv",
              [(10, 100), (10, 101), (13, 104)]),
    "semi": ("SELECT pv FROM probe WHERE EXISTS (SELECT * FROM build WHERE "
             "build.a = probe.a AND build.b = probe.b) ORDER BY pv",
             [(10,), (13,)]),
    "anti": ("SELECT pv FROM probe WHERE NOT EXISTS (SELECT * FROM build "
             "WHERE build.a = probe.a AND build.b = probe.b) ORDER BY pv",
             [(11,), (12,), (14,), (15,)]),
    "left": ("SELECT pv, bv FROM probe LEFT OUTER JOIN build ON probe.a = "
             "build.a AND probe.b = build.b AND bv <> 101 ORDER BY pv, bv",
             [(10, 100), (11, None), (12, None), (13, 104), (14, None),
              (15, None)]),
    "full": ("SELECT pv, bv FROM probe FULL OUTER JOIN build ON probe.a = "
             "build.a AND probe.b = build.b AND pv <> 9999",
             [(10, 100), (10, 101), (13, 104), (11, None), (12, None),
              (14, None), (15, None), (None, 102), (None, 103), (None, 105),
              (None, 106)]),
}


@pytest.mark.parametrize("case", sorted(WEAK_CASES))
def test_colliding_hash_join(weak, case):
    tdb, jdb = weak
    sql, want = WEAK_CASES[case]
    ours = tdb.execute(sql).rows
    _same_rows(ours, want, case, ordered=case != "full")
    _same_rows(ours, jdb.execute(sql).rows, f"{case} vs quickstep_tpu",
               ordered=case != "full")


# ---------------------------------------------------------------------
# tests/test_full_join.py and tests/test_setops_null.py
# ---------------------------------------------------------------------

FULL_SCRIPT = [
    "CREATE TABLE a (k INT NOT NULL, x INT NOT NULL)",
    "CREATE TABLE b (k INT NOT NULL, y INT NOT NULL)",
    "CREATE TABLE u (k INT NOT NULL UNIQUE, z INT NOT NULL)",
    "INSERT INTO a VALUES (1, 10), (2, 20), (3, 30), (3, 31)",
    "INSERT INTO b VALUES (2, 200), (3, 300), (4, 400), (4, 401)",
    "INSERT INTO u VALUES (3, 7), (4, 8), (5, 9)",
]
FULL_QUERIES = [
    "SELECT a.k, a.x, b.k, b.y FROM a FULL OUTER JOIN b ON a.k = b.k",
    "SELECT a.k, b.y FROM a FULL JOIN b ON a.k = b.k AND b.y < 350",
    "SELECT a.k, a.x, u.z FROM a FULL JOIN u ON a.k = u.k",
    "SELECT count(*), count(a.k), count(b.k) FROM a FULL JOIN b ON a.k = b.k",
]
SETOP_SCRIPT = [
    "CREATE TABLE p (x INT, s VARCHAR(8))",
    "CREATE TABLE q (x INT, s VARCHAR(8))",
    "CREATE TABLE t (x INT)",
    "CREATE TABLE s (y INT)",
    "CREATE TABLE s2 (y INT)",
    "CREATE TABLE se (y INT)",
    "INSERT INTO p VALUES (1,'a'), (2,'b'), (2,'b'), (NULL,'c'), (3,NULL)",
    "INSERT INTO q VALUES (2,'b'), (NULL,'c'), (9,'z')",
    "INSERT INTO t VALUES (1), (2), (NULL), (4)",
    "INSERT INTO s VALUES (2), (NULL)",
    "INSERT INTO s2 VALUES (2), (3)",
]
SETOP_QUERIES = [
    "SELECT x, s FROM p EXCEPT SELECT x, s FROM q",
    "SELECT x, s FROM p INTERSECT SELECT x, s FROM q",
    "SELECT x, s FROM p UNION SELECT x, s FROM q",
    "SELECT x, s FROM p UNION ALL SELECT x, s FROM q",
    "SELECT x FROM t WHERE x NOT IN (SELECT y FROM s)",
    "SELECT x FROM t WHERE x IN (SELECT y FROM s)",
    "SELECT x FROM t WHERE x NOT IN (SELECT y FROM s2)",
    "SELECT x FROM t WHERE x IN (SELECT y FROM s2)",
    "SELECT x FROM t WHERE x NOT IN (SELECT y FROM se)",
    "SELECT x FROM t WHERE x IN (SELECT y FROM se)",
]


@pytest.fixture(scope="module")
def full_engines():
    tdb, jdb, conn = _engines(FULL_SCRIPT, [
        s.replace(" NOT NULL", "").replace(" UNIQUE", "")
        for s in FULL_SCRIPT])
    yield tdb, jdb, conn
    tdb.close()


@pytest.fixture(scope="module")
def setop_engines():
    tdb, jdb, conn = _engines(SETOP_SCRIPT)
    yield tdb, jdb, conn
    tdb.close()


@pytest.mark.parametrize("sql", FULL_QUERIES)
def test_full_join(full_engines, sql):
    tdb, jdb, conn = full_engines
    ours = tdb.execute(sql).rows
    _same_rows(ours, conn.execute(sql).fetchall(), "vs sqlite")
    _same_rows(ours, jdb.execute(sql).rows, "vs quickstep_tpu")


@pytest.mark.parametrize("sql", SETOP_QUERIES)
def test_set_operations_and_in_with_nulls(setop_engines, sql):
    tdb, jdb, conn = setop_engines
    ours = tdb.execute(sql).rows
    _same_rows(ours, conn.execute(sql).fetchall(), "vs sqlite")
    _same_rows(ours, jdb.execute(sql).rows, "vs quickstep_tpu")


# ---------------------------------------------------------------------
# tests/test_decorrelation.py: theta correlation through RowNumber, the
# nested-loops join and the general decorrelation
# ---------------------------------------------------------------------

DECORRELATION = [
    "SELECT id FROM emp WHERE EXISTS (SELECT 1 FROM cap WHERE cap.lim < "
    "emp.salary) ORDER BY id",
    "SELECT id FROM emp WHERE NOT EXISTS (SELECT 1 FROM cap WHERE cap.lim > "
    "emp.salary) ORDER BY id",
    "SELECT id FROM emp WHERE EXISTS (SELECT 1 FROM cap WHERE lim > 600) "
    "ORDER BY id",
    "SELECT id, salary FROM emp e WHERE salary > (SELECT AVG(salary) FROM "
    "emp e2 WHERE e2.salary < e.salary) ORDER BY id",
    "SELECT id FROM emp e WHERE salary >= (SELECT MAX(salary) FROM emp e2 "
    "WHERE e2.dept = e.dept AND e2.id < e.id) ORDER BY id",
    "SELECT id, (SELECT COUNT(*) FROM cap WHERE cap.lim < emp.salary) FROM "
    "emp ORDER BY id",
    "SELECT id, (SELECT SUM(lim) FROM cap WHERE cap.lim < emp.salary) FROM "
    "emp ORDER BY id",
]


@pytest.fixture(scope="module")
def decorrelation_engines():
    rows = [(i, i % 5, 100 * (i % 13) + i % 7) for i in range(1, 61)]
    caps = [(d, 400 + 100 * d) for d in range(5)] + [(7, 100)]
    script = [
        "CREATE TABLE emp (id INT NOT NULL, dept INT NOT NULL, "
        "salary INT NOT NULL)",
        "CREATE TABLE cap (dept INT NOT NULL, lim INT NOT NULL)",
        "INSERT INTO emp VALUES " + ", ".join(f"({a}, {b}, {c})"
                                              for a, b, c in rows),
        "INSERT INTO cap VALUES " + ", ".join(f"({a}, {b})" for a, b in caps)]
    tdb, jdb, conn = _engines(script, [s.replace(" NOT NULL", "")
                                       for s in script])
    yield tdb, jdb, conn
    tdb.close()


@pytest.mark.parametrize("sql", DECORRELATION)
def test_general_decorrelation(decorrelation_engines, sql):
    tdb, jdb, conn = decorrelation_engines
    ours = tdb.execute(sql).rows
    assert ours
    _same_rows(ours, conn.execute(sql).fetchall(), "vs sqlite", ordered=True)
    _same_rows(ours, jdb.execute(sql).rows, "vs quickstep_tpu", ordered=True)


# ---------------------------------------------------------------------
# tests/test_index.py: CREATE INDEX builds the block summaries, refreshed
# after DML and kept by the catalog store
# ---------------------------------------------------------------------

def _index_db():
    db = Database(device="cpu")
    db.execute("CREATE TABLE t (k INT NOT NULL, v DOUBLE NOT NULL)")
    db.execute("INSERT INTO t VALUES " +
               ", ".join(f"({i}, {i * 0.5})" for i in range(100)))
    return db


def test_create_index_builds_sma():
    db = _index_db()
    assert "created" in db.execute("CREATE INDEX ik ON t (k) USING SMA").message
    rel = db.catalog.default_database.get_relation("t")
    _brows, mins, maxs, ver = rel.sma_blocks["k"]
    assert ver == rel.version and mins[0] == 0 and maxs[-1] == 99
    db.close()


@pytest.mark.parametrize("sql", [
    "CREATE INDEX ik ON t (nope) USING SMA",
    "CREATE INDEX ik2 ON t (k) USING SMA"], ids=["unknown_column",
                                                  "duplicate"])
def test_create_index_rejects(sql):
    db = _index_db()
    db.execute("CREATE INDEX ik ON t (k) USING SMA")
    with pytest.raises((ExecutionError, SqlError)):
        db.execute(sql)
    db.close()


def test_index_refreshes_after_dml_and_persists(tmp_path):
    db = _index_db()
    db.execute("CREATE INDEX ik ON t (k) USING SMA")
    rel = db.catalog.default_database.get_relation("t")
    db.execute("INSERT INTO t VALUES (1000, 1.0)")
    assert sma_range_for(rel, "k", 0, rel.data.num_rows)[1] == 1000
    assert rel.sma_blocks["k"][3] == rel.version
    db.config.storage_path = str(tmp_path / "store")
    db.save()
    db.close()
    db2 = from_store(str(tmp_path / "store"), device="cpu")
    rel2 = db2.catalog.default_database.get_relation("t")
    assert any(ix["name"] == "ik" for ix in rel2.indices)
    assert db2.execute("SELECT count(*), max(k) FROM t").rows == [(101, 1000)]
    db2.close()


# ---------------------------------------------------------------------
# composite keys whose span product reaches 2^62: hashed (K10) and
# verified on every candidate
# ---------------------------------------------------------------------

HASHED_SCRIPT = [
    "CREATE TABLE hp (a BIGINT NOT NULL, b BIGINT NOT NULL, pv INT NOT NULL)",
    "CREATE TABLE hb (a BIGINT NOT NULL, b BIGINT NOT NULL, bv INT NOT NULL)",
    "INSERT INTO hp VALUES " + ", ".join(
        f"({(i % 7) * 10**12 - 3 * 10**12}, {(i % 5) * 10**11}, {i})"
        for i in range(60)),
    "INSERT INTO hb VALUES " + ", ".join(
        f"({(i % 9) * 10**12 - 3 * 10**12}, {(i % 4) * 10**11}, {100 + i})"
        for i in range(30)),
]
HASHED_QUERIES = {
    "inner": "SELECT pv, bv FROM hp, hb WHERE hp.a = hb.a AND hp.b = hb.b",
    "left": "SELECT pv, bv FROM hp LEFT JOIN hb ON hp.a = hb.a "
            "AND hp.b = hb.b",
    "semi": "SELECT pv FROM hp WHERE EXISTS (SELECT * FROM hb WHERE "
            "hb.a = hp.a AND hb.b = hp.b)",
    "anti": "SELECT pv FROM hp WHERE NOT EXISTS (SELECT * FROM hb WHERE "
            "hb.a = hp.a AND hb.b = hp.b)",
    "full": "SELECT pv, bv FROM hp FULL JOIN hb ON hp.a = hb.a "
            "AND hp.b = hb.b",
    "unique_build": "SELECT pv, g.c FROM hp JOIN (SELECT a, b, count(*) c "
                    "FROM hb GROUP BY a, b) g ON hp.a = g.a AND hp.b = g.b",
}


@pytest.fixture(scope="module")
def hashed_engines():
    tdb, jdb, conn = _engines(HASHED_SCRIPT, [
        s.replace(" NOT NULL", "") for s in HASHED_SCRIPT])
    yield tdb, jdb, conn
    tdb.close()


@pytest.mark.parametrize("case", sorted(HASHED_QUERIES))
def test_hashed_composite_keys(hashed_engines, monkeypatch, case):
    tdb, jdb, conn = hashed_engines
    sql = HASHED_QUERIES[case]
    calls = []
    real = TK.hash_keys
    monkeypatch.setattr(TK, "hash_keys",
                        lambda cols: calls.append(len(cols)) or real(cols))
    ours = tdb.execute(sql).rows
    assert calls, "the join keys were not hashed"
    assert ours
    _same_rows(ours, conn.execute(sql).fetchall(), "vs sqlite")
    _same_rows(ours, jdb.execute(sql).rows, "vs quickstep_tpu")


# ---------------------------------------------------------------------
# zero rows: every gather into an empty source gives invalid rows
# ---------------------------------------------------------------------

# the zero-row statements are bench/zero_rows.py's, which chip_smoke.py runs
# on the card
ZERO_SCRIPT, ZERO_QUERIES = ZERO_ROW_SCRIPT, ZERO_ROW_QUERIES


# Zero-row shapes where quickstep_tpu itself raises (a TypeError on an empty
# table's VARCHAR column), so that sqlite alone decides.
REFERENCE_FAULTS = {
    # _remap_for_union indexes the column's empty code remap
    # (quickstep_tpu/exec/runner.py:2053)
    "union_empty", "except_empty", "union_all_varchar_empty",
    "intersect_varchar_empty",
    # DictBitmapProbe indexes an empty LIKE or IN-list bitmap
    # (quickstep_tpu/expressions/scalar.py:521)
    "like_varchar_empty", "in_list_varchar_empty",
    # the string join key's code remap is empty
    # (quickstep_tpu/expressions/scalar.py:651, from exec/runner.py:940)
    "join_varchar_empty", "left_join_varchar_empty", "exists_varchar_empty",
    "not_exists_varchar_empty",
}


@pytest.fixture(scope="module")
def zero_engines():
    tdb, jdb, conn = _engines(ZERO_SCRIPT)
    yield tdb, jdb, conn
    tdb.close()


@pytest.mark.parametrize("case", sorted(ZERO_QUERIES))
def test_zero_row_inputs(zero_engines, case):
    tdb, jdb, conn = zero_engines
    sql = ZERO_QUERIES[case]
    ours = tdb.execute(sql).rows
    _same_rows(ours, conn.execute(sql).fetchall(), f"{case} vs sqlite",
               ordered="ORDER BY" in sql)
    if case in REFERENCE_FAULTS:
        with pytest.raises(Exception):
            jdb.execute(sql)
    else:
        _same_rows(ours, jdb.execute(sql).rows, f"{case} vs quickstep_tpu",
                   ordered="ORDER BY" in sql)


def test_zero_row_gathers_are_invalid():
    """Chunk.ensure over a source of zero rows: rows of the index's length,
    every one NULL."""
    import torch
    from quickstep_tpu_torch.exec.chunk import Chunk, compose_slots
    src = Chunk(attrs=[], slots={1: (torch.zeros(0, dtype=torch.int32), None)},
                alive=torch.zeros(0, dtype=torch.bool), capacity=0)
    idx = torch.zeros(3, dtype=torch.int64)
    out = Chunk(attrs=[], slots=compose_slots(src, idx, None),
                alive=torch.ones(3, dtype=torch.bool), capacity=3)
    d, v = out.get(1)
    assert d.tolist() == [0, 0, 0] and v.tolist() == [False] * 3


# ---------------------------------------------------------------------
# the SF10 operator queries and O-DML at SF0.01
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def tpch_engines():
    jdb = quickstep_tpu.Database()
    data = load_tpch(jdb, scale=0.01, seed=0)
    conn = load_sqlite(data)
    tdb = Database(device="cpu")
    port_load_tpch(tdb, scale=0.01, seed=0)
    yield jdb, tdb, conn
    tdb.close()


@pytest.mark.parametrize("name", sorted(OPERATOR_QUERIES))
def test_operator_query_matches_reference_and_sqlite(tpch_engines, name,
                                                     monkeypatch):
    jdb, tdb, conn = tpch_engines
    sql = OPERATOR_QUERIES[name]
    sorts = []
    real = TS.order_permutation
    monkeypatch.setattr(TS, "order_permutation",
                        lambda *a: sorts.append(1) or real(*a))
    ours = tdb.execute(sql).rows
    assert tdb.executor.host_syncs == 1
    # O-Q5's DOUBLE key cannot be packed: the chained sort (K13) runs
    assert bool(sorts) == (name == "o5")
    _same_rows(ours, jdb.execute(sql).rows, f"{name} vs quickstep_tpu")
    _same_rows(ours, conn.execute(to_sqlite_sql(sql)).fetchall(),
               f"{name} vs sqlite")


def test_operator_dml_matches_sqlite(tpch_engines):
    """O-DML: INSERT ... SELECT, DELETE and UPDATE on a copy of lineitem's
    'R' lines, then the totals, against sqlite; after each statement the
    table has one device copy, of its newest version."""
    _jdb, tdb, conn = tpch_engines
    ddl = operator_dml_ddl()
    tdb.execute(ddl)
    conn.execute(to_sqlite_sql(ddl).replace(" NOT NULL", ""))
    rel = tdb.catalog.default_database.get_relation("li_r")
    for stmt in OPERATOR_DML:
        n = tdb.execute(stmt).rows_affected
        assert n == conn.execute(to_sqlite_sql(stmt)).rowcount and n > 0
        keys = [k for k in tdb.executor._device_cache if k[0] == "li_r"]
        assert keys in ([], [("li_r", rel.version)])
        tdb.execute("select count(*) from li_r")
        assert [k for k in tdb.executor._device_cache if k[0] == "li_r"] == \
            [("li_r", rel.version)]
    ours = tdb.execute(OPERATOR_DML_QUERY).rows
    _same_rows(ours, conn.execute(OPERATOR_DML_QUERY).fetchall(), "vs sqlite")
