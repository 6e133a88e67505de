"""The port's logical-plan cache (Executor._logical_plan_cache), the
counterpart of tests/test_plan_cache.py: a repeated SELECT takes its
optimized plan from the cache; the key is the statement's structure without
positions, the planning config and every relation's version; the cache is
emptied after every statement that is not a SELECT, so that INSERT ...
SELECT's inner plan does not outlive the insert (the reference keeps it and
returns stale rows, held here against sqlite)."""

import sqlite3

import pytest

import quickstep_tpu

from quickstep_tpu_torch import Database

SETUP = ["CREATE TABLE t (a INT, s VARCHAR(20))",
         "INSERT INTO t VALUES (1,'foo'), (2,'foobar'), (3,'bar')"]


def _db():
    db = Database(device="cpu")
    for stmt in SETUP:
        db.execute(stmt)
    return db


def _reference(query, *statements):
    """The reference's rows of `query` after SETUP and `statements`."""
    ref = quickstep_tpu.Database()
    for stmt in SETUP + list(statements):
        ref.execute(stmt)
    return ref.execute(query).rows


def _cached(db):
    return list(db.executor._logical_plan_cache.values())


def test_plan_cache_hit_and_invalidation():
    db = _db()
    q = "SELECT a FROM t WHERE s LIKE '%foo%' ORDER BY a"
    want = _reference(q)
    assert db.execute(q).rows == want
    assert len(_cached(db)) == 1
    cached = _cached(db)[0]
    assert db.execute(q).rows == want
    assert _cached(db) == [cached] and _cached(db)[0] is cached
    # DML empties the cache: the new row appears (a stale LIKE bitmap over
    # the old dictionary would miss 'xfoox')
    insert = "INSERT INTO t VALUES (4,'xfoox')"
    db.execute(insert)
    assert _cached(db) == []
    assert db.execute(q).rows == _reference(q, insert)
    assert _cached(db)[0] is not cached
    db.close()


def test_plan_cache_keyed_by_config():
    db = _db()
    q = "SELECT SUM(a) FROM t"
    want = _reference(q)
    assert db.execute(q).rows == want
    # a knob the port's optimizer reads (optimizer/rules.py); the
    # reference's test uses hbm_budget_bytes
    db.config.reorder_hash_joins = False
    assert db.execute(q).rows == want
    assert len(_cached(db)) == 2
    # profile_device_reps never reaches the planner: no new key
    db.config.profile_device_reps = 3
    assert db.execute(q).rows == want
    assert len(_cached(db)) == 2
    db.close()


def test_plan_cache_ignores_line_breaks_and_spacing():
    db = _db()
    q = "SELECT a, s FROM t WHERE a > 1 ORDER BY a"
    rows = db.execute(q).rows
    assert rows == _reference(q)
    cached = _cached(db)[0]
    for text in ("SELECT a, s\nFROM t\nWHERE a > 1\nORDER BY a",
                 "   SELECT  a ,  s FROM t\n\n   WHERE a > 1 ORDER BY a  "):
        assert db.execute(text).rows == rows
        assert _cached(db) == [cached] and _cached(db)[0] is cached
    # another literal is another statement
    q2 = "SELECT a, s FROM t WHERE a > 2 ORDER BY a"
    assert db.execute(q2).rows == _reference(q2)
    assert len(_cached(db)) == 2
    db.close()


def test_set_data_replans():
    """rel.set_data moves the relation's version without any statement:
    the next SELECT is planned anew (the smoke's stale-partsupp Q9 needs
    this to lose its statistics-proven unique build)."""
    db = _db()
    q = "SELECT count(*) FROM t WHERE s LIKE '%bar%'"
    want = _reference(q)
    assert db.execute(q).rows == want
    cached = _cached(db)[0]
    rel = db.catalog.default_database.get_relation("t")
    rel.set_data(rel.data)
    assert db.execute(q).rows == want
    assert len(_cached(db)) == 2 and _cached(db)[1] is not cached
    db.close()


@pytest.mark.parametrize("stmt", [
    "INSERT INTO t VALUES (5, 'x')",
    "INSERT INTO t SELECT a + 10, s FROM t WHERE a = 1",
    "DELETE FROM t WHERE a = 3",
    "UPDATE t SET a = a + 1 WHERE a = 2",
    "CREATE TABLE u (b INT)",
    "DROP TABLE t2",
    "\\analyze",
    "COPY (SELECT a FROM t) TO stdout",
], ids=["insert_values", "insert_select", "delete", "update",
        "create_table", "drop_table", "analyze", "copy_select_to"])
def test_every_other_statement_empties_the_cache(stmt):
    db = _db()
    db.execute("CREATE TABLE t2 (c INT)")
    q = "SELECT a, s FROM t ORDER BY a"
    before = db.execute(q).rows
    assert len(_cached(db)) == 1
    db.execute(stmt)
    assert _cached(db) == []
    conn = sqlite3.connect(":memory:")
    conn.execute("CREATE TABLE t (a INT, s VARCHAR(20))")
    conn.execute("INSERT INTO t VALUES (1,'foo'), (2,'foobar'), (3,'bar')")
    if not stmt.startswith(("CREATE", "DROP", "\\", "COPY")):
        conn.execute(stmt)
    want = conn.execute(q).fetchall()
    assert db.execute(q).rows == want
    assert len(_cached(db)) == 1
    if stmt.startswith(("CREATE", "DROP", "\\", "COPY")):
        assert want == before
    db.close()


# INSERT ... SELECT over the table it inserts into, with a LIKE whose
# dictionary bitmap the insert makes stale ('aaa' shifts 'bar''s code), then
# the same SELECT at the same line and column (the reference keys its cache
# on positions too)
STALE_SCRIPT = [
    "CREATE TABLE t (a INT NOT NULL, s VARCHAR(10) NOT NULL)",
    "INSERT INTO t VALUES (1, 'foo'), (2, 'bar')",
    "INSERT INTO t SELECT a + 10, 'aaa' FROM t WHERE s LIKE '%foo%'",
]
STALE_QUERY = "              SELECT a + 10, 'aaa' FROM t WHERE s LIKE '%foo%'"


def test_insert_select_then_select_matches_sqlite():
    import quickstep_tpu
    conn = sqlite3.connect(":memory:")
    db, ref = Database(device="cpu"), quickstep_tpu.Database()
    for stmt in STALE_SCRIPT:
        conn.execute(stmt)
        db.execute(stmt)
        ref.execute(stmt)
    want = conn.execute(STALE_QUERY).fetchall()
    assert want == [(11, "aaa")]
    assert db.execute(STALE_QUERY).rows == want
    assert db.execute(STALE_QUERY).rows == want
    # the reference's stale plan matches 'bar' under its new code
    assert ref.execute(STALE_QUERY).rows != want
    db.close()
