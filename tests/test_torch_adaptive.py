"""Adaptive re-optimization in the port, the counterpart of
tests/test_adaptive.py: a runtime correction (an expansion overflow, a
duplicate build key) is learned per plan shape and table versions, so a
repeated query takes the corrected plan in one pass; the learned overrides
are written to the store (learned_overrides.json) and read by a new
Database on the same store. `retries` is the reference's `last_attempts - 1`."""

import json
import os

import quickstep_tpu

from quickstep_tpu_torch import Database
from quickstep_tpu_torch.exec.executor import OVERRIDES_FILE

SQL = ("SELECT p.k, COUNT(*) AS c FROM probe p, build b "
       "WHERE p.k = b.k GROUP BY p.k ORDER BY p.k")
SETUP = [
    "CREATE TABLE probe (k INT NOT NULL, pv INT NOT NULL)",
    # runs longer than the default expansion width on both sides, so either
    # build orientation overflows
    "INSERT INTO probe VALUES " + ", ".join(
        f"({k}, {k * 100 + r})" for k in range(1, 9) for r in range(10)),
    "CREATE TABLE build (k INT NOT NULL, bv INT NOT NULL)",
    # key 3 appears 20 times: past the default width of 8, the overflow flag
    # fires and the retry widens it
    "INSERT INTO build VALUES " + ", ".join(
        [f"(3, {i})" for i in range(20)] + ["(1, 100)", "(2, 200)"]),
]


def _setup(storage_path=None):
    db = Database(storage_path=storage_path, device="cpu")
    for stmt in SETUP:
        db.execute(stmt)
    return db


def _reference(*statements):
    """The reference's rows of SQL after SETUP and `statements`."""
    ref = quickstep_tpu.Database()
    for stmt in SETUP + list(statements):
        ref.execute(stmt)
    return ref.execute(SQL).rows


def test_overflow_retry_is_learned():
    db = _setup()
    r1 = db.execute(SQL)
    assert r1.rows == _reference()
    assert db.executor.retries >= 1      # the overflow forced a retry
    assert db.executor._learned_overrides

    r2 = db.execute(SQL)
    assert r2.rows == r1.rows
    assert db.executor.retries == 0      # the corrected plan in one pass

    # the same plan under other aliases shares what was learned
    sql2 = ("SELECT q.k, COUNT(*) AS c FROM probe q, build bb "
            "WHERE q.k = bb.k GROUP BY q.k ORDER BY q.k")
    assert db.execute(sql2).rows == r1.rows
    assert db.executor.retries == 0
    db.close()


def test_learning_reset_on_data_change():
    db = _setup()
    db.execute(SQL)
    # a new version of build: the learned entry no longer applies (it is
    # keyed on versions), and the rows stay right
    insert = "INSERT INTO build VALUES (4, 1), (4, 2)"
    db.execute(insert)
    r = db.execute(SQL)
    assert r.rows == _reference(insert)
    db.close()


def test_conjunct_ordering_by_selectivity():
    """Plan-time conjunct ordering: the AND's conjuncts sort most selective
    first by the cost model."""
    from quickstep_tpu_torch.expressions.scalar import Cmp, Logical
    from quickstep_tpu_torch.optimizer import logical as L
    from quickstep_tpu_torch.optimizer.resolver import Resolver
    from quickstep_tpu_torch.optimizer.rules import optimize_plan
    from quickstep_tpu_torch.parser import parse_one

    db = Database(device="cpu")
    db.execute("CREATE TABLE t (a INT NOT NULL, b INT NOT NULL)")
    db.execute("INSERT INTO t VALUES " + ", ".join(
        f"({i % 1000}, {i % 3})" for i in range(2000)))
    db.execute("\\analyze")
    # a = 5 (selectivity about 1/1000) before b <> 2 (about 0.9)
    ast = parse_one("SELECT a FROM t WHERE b <> 2 AND a = 5")
    plan = optimize_plan(Resolver(db.catalog.default_database)
                         .resolve_select(ast),
                         db.config, db.catalog.default_database)
    filters = []

    def walk(n):
        if isinstance(n, L.Filter):
            filters.append(n)
        for c in n.children():
            walk(c)
    walk(plan)
    assert filters and isinstance(filters[-1].predicate, Logical)
    first = filters[-1].predicate.operands[0]
    assert isinstance(first, Cmp) and first.op == "="
    q = "SELECT a FROM t WHERE b <> 2 AND a = 5"
    ref = quickstep_tpu.Database()
    ref.execute("CREATE TABLE t (a INT NOT NULL, b INT NOT NULL)")
    ref.execute("INSERT INTO t VALUES " + ", ".join(
        f"({i % 1000}, {i % 3})" for i in range(2000)))
    assert db.execute(q).rows == ref.execute(q).rows
    db.close()


def test_learned_overrides_persist_with_store(tmp_path):
    """The overrides are written to the store, so that a new Database on it
    runs the corrected plan on its first attempt."""
    db = _setup()
    db.config.storage_path = str(tmp_path / "store")
    db.save()
    r1 = db.execute(SQL)
    assert db.executor.retries >= 1
    path = tmp_path / "store" / OVERRIDES_FILE
    assert path.exists() and json.loads(path.read_text())
    db.close()

    db2 = Database(storage_path=str(tmp_path / "store"), device="cpu")
    r2 = db2.execute(SQL)
    assert r2.rows == r1.rows
    assert db2.executor.retries == 0     # learned override loaded cold
    db2.close()


def test_unreadable_overrides_are_learned_again(tmp_path):
    """A learned_overrides.json that cannot be read is ignored: the first
    run retries, as with no file, and writes a good file."""
    db = _setup()
    db.config.storage_path = str(tmp_path / "store")
    db.save()
    db.close()
    path = tmp_path / "store" / OVERRIDES_FILE
    path.write_text("{not json")
    db2 = Database(storage_path=str(tmp_path / "store"), device="cpu")
    assert db2.execute(SQL).rows == _reference()
    assert db2.executor.retries >= 1
    assert json.loads(path.read_text())
    db3 = Database(storage_path=str(tmp_path / "store"), device="cpu")
    assert db3.execute(SQL).rows == _reference() and \
        db3.executor.retries == 0
    db2.close()
    db3.close()


def test_overrides_never_create_a_store(tmp_path):
    """On a store whose directory does not exist, the override is learned
    in memory and nothing is written."""
    store = tmp_path / "absent"
    db = _setup(storage_path=str(store))
    want = _reference()
    assert db.execute(SQL).rows == want
    assert db.executor.retries >= 1
    assert db.execute(SQL).rows == want and db.executor.retries == 0
    assert not os.path.exists(store)
    db.close()


def test_storeless_database_neither_reads_nor_writes_overrides(
        tmp_path, monkeypatch):
    """A Database opened on no store keeps its overrides in memory, even
    where config.storage_path's default directory exists and holds a good
    file: it reads nothing from it and writes nothing to it."""
    db = _setup()
    db.config.storage_path = str(tmp_path / "store")
    db.save()
    db.execute(SQL)
    db.close()
    learned = json.loads((tmp_path / "store" / OVERRIDES_FILE).read_text())
    learned["unused"] = {}          # a rewrite would drop this key
    default = tmp_path / "cwd" / Database(device="cpu").config.storage_path
    default.mkdir(parents=True)
    path = default / OVERRIDES_FILE
    text = json.dumps(learned)
    path.write_text(text)
    # the reference's rows first: its executor would use the directory
    want = _reference()
    monkeypatch.chdir(tmp_path / "cwd")
    db2 = _setup()
    assert db2.execute(SQL).rows == want
    assert db2.executor.retries >= 1     # the file was not read
    assert db2.execute(SQL).rows == want and db2.executor.retries == 0
    assert path.read_text() == text     # nor written
    assert os.listdir(default) == [OVERRIDES_FILE]
    db2.close()
