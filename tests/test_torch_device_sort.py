"""The port's presentation ORDER BY against quickstep_tpu's, on the CPU: the
counterpart of tests/test_device_sort.py, on the same table and SQL.

quickstep_tpu sorts on the device when the result has at least
`device_sort_threshold_rows` rows and on the host otherwise; its test drops
the threshold so that both paths run and must agree. The port decides
before its one host synchronisation, by the query's shape: a root ORDER BY
... LIMIT is sorted on the device (ops/sort.py order_permutation, K13 on
the card) and only the kept rows are pulled; any other root ORDER BY is
sorted by a numpy lexsort after the pull. So the port reads no
`device_sort_threshold_rows` (a deliberate difference, stated below), and
`Executor.last_sort_path` says which path ran. Rows are compared exactly
with the reference's on both of its paths.
"""

import numpy as np
import pytest

from quickstep_tpu import Database as JaxDatabase
from quickstep_tpu.storage.column import Column as JaxColumn
from quickstep_tpu.storage.dictionary import Dictionary as JaxDictionary
from quickstep_tpu.storage.table import TableData as JaxTableData
from quickstep_tpu.types import DOUBLE as JAX_DOUBLE, INT as JAX_INT
from quickstep_tpu.types import Decimal as JaxDecimal, VarChar as JaxVarChar
from quickstep_tpu_torch import Database
from quickstep_tpu_torch.storage.column import Column
from quickstep_tpu_torch.storage.dictionary import Dictionary
from quickstep_tpu_torch.storage.table import TableData
from quickstep_tpu_torch.types import DOUBLE, INT, Decimal, VarChar

SQLS = [
    "SELECT k, x, d, name FROM s ORDER BY x, d DESC, k LIMIT 50",
    "SELECT k, x, d FROM s ORDER BY x DESC NULLS LAST, k LIMIT 25",
    "SELECT k, x FROM s ORDER BY x ASC NULLS FIRST, k LIMIT 25",
    "SELECT k, f, name FROM s ORDER BY name, f DESC, k LIMIT 30",
    "SELECT k, d FROM s ORDER BY d, k",
]
AGG_SQL = ("SELECT x, count(*) AS c, sum(d) AS sd FROM s GROUP BY x "
           "ORDER BY sd DESC, x LIMIT 10")
CREATE = ("CREATE TABLE s (k INT NOT NULL, x INT NULL, "
          "d DECIMAL(9,2) NOT NULL, f DECIMAL NOT NULL, "
          "name VARCHAR(8) NOT NULL)")


def _columns(n=5000, seed=7):
    """tests/test_device_sort.py's table, as numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 50, n)
    xv = rng.random(n) > 0.1
    strs = [f"n{v:03d}" for v in rng.integers(0, 100, n)]
    return {"k": np.arange(n, dtype=np.int32), "x": x.astype(np.int32),
            "xv": xv,
            "d": rng.integers(-10000, 10000, n).astype(np.int32),
            "f": rng.normal(size=n), "name": strs}


def _reference_db(cols):
    db = JaxDatabase()
    db.execute(CREATE)
    rel = db.catalog.default_database.get_relation("s")
    dct, codes = JaxDictionary.build(cols["name"])
    rel.set_data(JaxTableData({
        "k": JaxColumn(JAX_INT, cols["k"]),
        "x": JaxColumn(JAX_INT.with_nullable(), cols["x"], cols["xv"]),
        "d": JaxColumn(JaxDecimal(9, 2), cols["d"]),
        "f": JaxColumn(JAX_DOUBLE, cols["f"]),
        "name": JaxColumn(JaxVarChar(8), codes, None, dct),
    }))
    rel.analyze()
    return db


def _port_db(cols):
    db = Database(device="cpu")
    db.execute(CREATE)
    rel = db.catalog.default_database.get_relation("s")
    dct, codes = Dictionary.build(cols["name"])
    rel.set_data(TableData({
        "k": Column(INT, cols["k"]),
        "x": Column(INT.with_nullable(), cols["x"], cols["xv"]),
        "d": Column(Decimal(9, 2), cols["d"]),
        "f": Column(DOUBLE, cols["f"]),
        "name": Column(VarChar(8), codes, None, dct),
    }))
    rel.analyze()
    return db


@pytest.fixture(scope="module")
def dbs():
    cols = _columns()
    ref, port = _reference_db(cols), _port_db(cols)
    yield ref, port
    port.close()


def _reference_rows(db, sql, path):
    db.config.device_sort_threshold_rows = 1 if path == "device" else 1 << 60
    rows = db.execute(sql).rows
    assert db.executor.last_sort_path == path, sql
    return rows


@pytest.mark.parametrize("sql", SQLS + [AGG_SQL])
def test_port_rows_match_both_reference_paths(dbs, sql):
    ref, port = dbs
    got = port.execute(sql).rows
    assert got == _reference_rows(ref, sql, "host")
    assert got == _reference_rows(ref, sql, "device")


@pytest.mark.parametrize("sql", SQLS + [AGG_SQL])
def test_port_sort_path_follows_the_limit(dbs, sql):
    """A root ORDER BY ... LIMIT is sorted on the device; without a LIMIT
    the rows are sorted on the host after the pull."""
    _ref, port = dbs
    port.execute(sql)
    want = "device" if " LIMIT " in sql else "host"
    assert port.executor.last_sort_path == want


@pytest.mark.parametrize("threshold", (1, 1 << 60))
@pytest.mark.parametrize("sql", (SQLS[0], SQLS[-1]))
def test_port_reads_no_sort_threshold(dbs, sql, threshold):
    """Deliberate difference: the reference picks its path by the result's
    row count against device_sort_threshold_rows, after the pull; the port
    picks it by the LIMIT, before its one host sync, and does not read the
    threshold. Its path and rows stay the same at either setting."""
    _ref, port = dbs
    before = port.config.device_sort_threshold_rows
    try:
        port.config.device_sort_threshold_rows = threshold
        rows = port.execute(sql).rows
        path = port.executor.last_sort_path
    finally:
        port.config.device_sort_threshold_rows = before
    assert path == ("device" if " LIMIT " in sql else "host")
    assert rows == port.execute(sql).rows
