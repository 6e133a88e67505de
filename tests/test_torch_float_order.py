"""The float order of the port's sorts: the root ORDER BY ... LIMIT (sorted
on the device by ops/sort.py order_permutation, K13 on the card), GROUP BY
on a float key and PARTITION BY a float, over columns that hold NaNs of
both signs, -0.0 and +0.0, +-inf and NULLs.

The reference puts every NaN last, whatever its sign, and holds -0.0 equal
to 0.0: its host lexsort does, and lax.sort canonicalises both. On the CPU
the port's rows are held against quickstep_tpu's Database on the same
tables, and the device-sorted root ORDER BY ... LIMIT against the port's
own host lexsort (_host_sort_order, the whole result sorted on the host).
On the card (`cuda`-marked) the same SQL at 1 M rows gives the port's CPU
rows, and the card's own torch.sort is recorded. Rows compare exactly:
float values by their bits, a NaN as NaN of either sign. This file
imports quickstep_tpu only inside the tests that use it, so its card tests
also run where there is no JAX:

    python -m pytest --noconftest tests/test_torch_float_order.py -q -m cuda
"""

import math
import struct

import numpy as np
import pytest
import torch

from quickstep_tpu_torch import Database

NEG_NAN = float(np.copysign(np.nan, -1))
POOL = np.array([np.nan, NEG_NAN, -0.0, 0.0, np.inf, -np.inf, 1.5, -1.5,
                 2.25, -7.0, 1e30, -1e-30])
N_SMALL = 400
N_CARD = 1_000_000


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _columns(n, seed):
    """f DOUBLE, r REAL (a DOUBLE here), g FLOAT (float32), each about 10 %
    NULL, and i INT NOT NULL of few values, so that ties reach every key."""
    rng = np.random.default_rng(seed)
    cols = {}
    for name, dtype in (("f", np.float64), ("r", np.float64),
                        ("g", np.float32)):
        vals = POOL[rng.integers(0, len(POOL), n)].astype(dtype)
        vals[:len(POOL)] = POOL.astype(dtype)
        cols[name] = (vals, rng.random(n) < 0.9)
    cols["i"] = (rng.integers(0, 10, n).astype(np.int32), None)
    assert np.signbit(cols["f"][0][1]) and np.isnan(cols["f"][0][1])
    return cols


def _load(db, cols):
    """CREATE TABLE t and its columns as numpy arrays, through the
    package's own table API (the negative NaNs keep their sign)."""
    db.execute("CREATE TABLE t (f DOUBLE, r REAL, g FLOAT, i INT NOT NULL)")
    rel = db.catalog.default_database.get_relation("t")
    pkg = type(rel).__module__.split(".")[0]
    column = __import__(f"{pkg}.storage.column", fromlist=["Column"]).Column
    table = __import__(f"{pkg}.storage.table", fromlist=["TableData"])
    data = {}
    for a in rel.attributes:
        vals, valid = cols[a.name]
        data[a.name] = column(a.type, vals.astype(a.type.device_dtype),
                              None if valid is None or valid.all() else valid,
                              None)
    rel.set_data(table.TableData(data))
    return db


def _key(v):
    if isinstance(v, float):
        return ("nan",) if math.isnan(v) else struct.pack("<d", v)
    return v


def _rows(rows):
    return [tuple(_key(v) for v in row) for row in rows]


def _bag(rows):
    return sorted(_rows(rows), key=repr)


ORDER_SQL = [
    f"SELECT {c}, i FROM t ORDER BY {c}{d}{nulls}, i LIMIT 37"
    for c in ("f", "r", "g") for d in (" DESC", "")
    for nulls in ("", " NULLS FIRST", " NULLS LAST")
] + ["SELECT f, g, i FROM t ORDER BY g DESC NULLS LAST, f, i DESC LIMIT 50"
   ] + [f"SELECT {c}, i FROM t WHERE i = 0 ORDER BY {c}{d} LIMIT 200000"
        for c in ("f", "g") for d in (" DESC", "")]      # the NaNs too
GROUP_SQL = ["SELECT f, i, COUNT(*) FROM t GROUP BY f, i",
             "SELECT g, i, SUM(i) FROM t GROUP BY g, i"]
WINDOW_SQL = ["SELECT f, i, SUM(i) OVER (PARTITION BY f) FROM t",
              "SELECT g, i, COUNT(*) OVER (PARTITION BY g ORDER BY i) FROM t"]


@pytest.fixture(scope="module")
def engines():
    reference = pytest.importorskip("quickstep_tpu")
    cols = _columns(N_SMALL, 17)
    return (_load(Database(device="cpu"), cols),
            _load(reference.Database(), cols))


@pytest.mark.parametrize("sql", ORDER_SQL)
def test_root_order_by_limit_matches_the_reference(engines, sql):
    port, ref = engines
    got = port.execute(sql).rows
    assert _rows(got) == _rows(ref.execute(sql).rows)
    # the device sort against the port's own host lexsort of the whole
    # result (no LIMIT: _host_sort_order)
    whole = port.execute(sql.rsplit(" LIMIT", 1)[0]).rows
    assert _rows(got) == _rows(whole[:len(got)])
    # every NaN of the first key after every number, whatever its sign
    names = sql.split("SELECT ")[1].split(" FROM")[0].split(", ")
    k = names.index(sql.split("ORDER BY ")[1].split()[0].rstrip(","))
    nan = [isinstance(r[k], float) and math.isnan(r[k]) for r in got]
    if any(nan):
        assert all(nan[j] or got[j][k] is None
                   for j in range(nan.index(True), len(got)))


@pytest.mark.parametrize("sql", GROUP_SQL + WINDOW_SQL)
def test_float_groups_and_partitions_match_the_reference(engines, sql):
    port, ref = engines
    got = port.execute(sql).rows
    assert _bag(got) == _bag(ref.execute(sql).rows)


def test_equal_zeros_share_one_group(engines):
    port, _ = engines
    rows = port.execute("SELECT f, i, COUNT(*) FROM t WHERE f = 0.0 "
                        "GROUP BY f, i").rows
    assert len({r[1] for r in rows}) == len(rows)


@pytest.fixture(scope="module")
def card_engines():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cols = _columns(N_CARD, 23)
    return _load(Database(device="cpu"), cols), _load(
        Database(device="cuda"), cols)


@pytest.mark.cuda
@pytest.mark.parametrize("sql", ORDER_SQL + GROUP_SQL + WINDOW_SQL)
def test_card_rows_equal_cpu_rows_at_1m(card_engines, sql):
    cpu, dev = card_engines
    want, got = cpu.execute(sql).rows, dev.execute(sql).rows
    if "ORDER BY" in sql and "OVER" not in sql:
        assert _rows(got) == _rows(want)
    else:
        assert _bag(got) == _bag(want)


@pytest.mark.cuda
def test_card_torch_sort_float_order(card):
    """What the card's own torch.sort does with equal zeros and NaNs of
    both signs (the port never sorts raw floats with it: K13 encodes them,
    the GROUP BY and PARTITION BY chains sort a canonical copy)."""
    v = torch.tensor([0.0, -0.0, NEG_NAN, -np.inf, 0.0, -0.0, np.nan, 1.0],
                     dtype=torch.float64, device=card)
    order = torch.sort(v, stable=True)[1].cpu().tolist()
    zeros = [i for i in order if i in (0, 1, 4, 5)]
    print(f"card torch.sort order {order}; the zeros in order {zeros}")
    start = order.index(zeros[0])
    assert order[start:start + 4] == zeros
    # at 1 M rows, most of them zeros of either sign
    rng = np.random.default_rng(29)
    big = POOL[rng.integers(0, len(POOL), N_CARD)]
    big[rng.random(N_CARD) < 0.5] = -0.0
    big[rng.random(N_CARD) < 0.25] = 0.0
    order = torch.sort(torch.from_numpy(big).to(card),
                       stable=True)[1].cpu().numpy()
    zero_rows = order[big[order] == 0]
    print(f"card torch.sort at {N_CARD} rows: the zeros in row order "
          f"{bool(np.all(np.diff(zero_rows) > 0))}, a NaN first "
          f"{bool(np.isnan(big[order[0]]))}")
