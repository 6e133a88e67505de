"""The port's window aggregates against quickstep_tpu's, on the CPU.

Module parity: quickstep_tpu_torch.ops.window.window_aggregate (its plain
versions of W1-W4 run on CPU tensors) against
quickstep_tpu.ops.window.window_aggregate on the same seeded numpy inputs,
over every function, frame and value dtype, with NULLs, dead rows and two
partition keys, through the packed sort key and the chained sorts.
Tolerances: integers, counts and MIN/MAX exactly; float sums of bounded
frames (the sliding W4 path) bit for bit; float sums of the prefix and
whole-partition paths (W1) within 8 ulps of the sum of the live values'
magnitudes, since the reference takes differences of whole-array prefix
sums (or scatters) and the port's plain version scatters or takes its own
differences.

SQL parity: the six window queries of bench/tpch_fullgen.py and the 13 frame
shapes of tests/test_window.py, rewritten over TPC-H's lineitem, through the
port, through quickstep_tpu and through sqlite at SF0.01, with
tests/test_tpch.py's row tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickstep_tpu import Database as JaxDatabase
from quickstep_tpu.bench.tpch import load_tpch, load_sqlite, to_sqlite_sql
from quickstep_tpu.ops import window as JW
from quickstep_tpu_torch import Database
from quickstep_tpu_torch.bench.tpch import load_tpch as port_load_tpch
from quickstep_tpu_torch.bench.tpch_fullgen import WINDOW_QUERIES
from quickstep_tpu_torch.ops import window as TW
from test_tpch import _row_eq

FNS = ("sum", "count", "avg", "min", "max")
DTYPES = (np.int32, np.int64, np.float32, np.float64)
N = 400
# name: (order key: None, "int", "float" or "int_desc", frame)
FRAMES = {
    "no_order_by": (None, None),
    "default_range": ("int", None),
    "range_unbounded_current": ("int", ("range", None, 0)),
    "rows_a_b": ("int", ("rows", 2, 1)),
    "rows_a_current": ("int", ("rows", 3, 0)),
    "rows_unbounded": ("int", ("rows", None, None)),
    "rows_unbounded_start": ("int", ("rows", None, 2)),
    "range_int": ("int", ("range", 4, 6)),
    "range_float": ("float", ("range", 3, 2)),
    "range_desc": ("int_desc", ("range", 5, 2)),
    "range_desc_unbounded_end": ("int_desc", ("range", 3, None)),
}
# frames whose float sums slide (W4) and so must be bit-equal
SLIDING = {name for name, (_k, f) in FRAMES.items()
           if f is not None and not (f[0] == "range" and f[1] is None and
                                     f[2] == 0)}


def _inputs(dtype, order, seed=3):
    rng = np.random.default_rng(seed)
    p1 = rng.integers(0, 4, N).astype(np.int32)
    p2 = rng.integers(0, 3, N).astype(np.int64)
    if np.issubdtype(dtype, np.floating):
        vals = rng.normal(300, 100, N).astype(dtype)
    else:
        vals = rng.integers(-10**5, 10**5, N).astype(dtype)
    valid = rng.random(N) < 0.85
    alive = rng.random(N) < 0.8
    okeys, desc, oranges = [], [], []
    if order == "float":
        okeys.append(rng.integers(0, 60, N) / 2.0)
        desc.append(False)
        oranges.append(None)
    elif order is not None:
        okeys.append(rng.integers(0, 60, N).astype(np.int32))
        desc.append(order == "int_desc")
        oranges.append((0, 59))
    return [p1, p2], okeys, desc, vals, valid, alive, [(0, 3), (0, 2)] + \
        oranges


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _check(fn, name, dtype, got, want, vals, valid, alive):
    res, rvalid = got
    wres, wvalid = np.asarray(want[0]), want[1]
    res = res.numpy()
    assert res.dtype == wres.dtype, (res.dtype, wres.dtype)
    assert (rvalid is None) == (wvalid is None)
    keep = alive
    if rvalid is not None:
        np.testing.assert_array_equal(rvalid.numpy()[keep],
                                      np.asarray(wvalid)[keep])
        keep = keep & np.asarray(wvalid)     # NULL results hold anything
    got_k, want_k = res[keep], wres[keep]
    if fn in ("sum", "avg") and np.issubdtype(dtype, np.floating) and \
            name not in SLIDING:
        live = alive & valid
        atol = 8 * float(np.finfo(dtype).eps) * float(
            np.abs(vals[live].astype(np.float64)).sum())
        np.testing.assert_allclose(got_k, want_k, rtol=0, atol=atol)
    else:
        # integers, counts, MIN/MAX, integer averages and every sliding
        # float sum: equal bit for bit
        np.testing.assert_array_equal(got_k.view(np.uint8),
                                      want_k.view(np.uint8))


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("name", sorted(FRAMES))
@pytest.mark.parametrize("fn", FNS)
def test_window_aggregate_matches_reference(fn, name, dtype):
    order, frame = FRAMES[name]
    parts, okeys, desc, vals, valid, alive, ranges = _inputs(dtype, order)
    want = JW.window_aggregate([_j(p) for p in parts],
                               [_j(k) for k in okeys], desc, fn, _j(vals),
                               _j(valid), _j(alive), frame)
    # through the packed sort key where every range is known, and through
    # the chained sorts
    for key_ranges in ((ranges if order != "float" else None), None):
        got = TW.window_aggregate([_t(p) for p in parts],
                                  [_t(k) for k in okeys], desc, fn, _t(vals),
                                  _t(valid), _t(alive), frame, key_ranges)
        _check(fn, name, dtype, got, want, vals, valid, alive)


@pytest.mark.parametrize("fn", FNS)
def test_window_aggregate_count_star_without_values(fn):
    """count(*) passes no values (the reference sums ones); the other
    functions over a partition with no live row come out NULL."""
    parts, okeys, desc, vals, _valid, alive, _r = _inputs(np.int64, "int")
    alive = alive & (parts[0] != 2)
    args = (None, None) if fn == "count" else (vals, None)
    want = JW.window_aggregate([_j(p) for p in parts],
                               [_j(k) for k in okeys], desc, fn,
                               *[None if a is None else _j(a) for a in args],
                               _j(alive), ("rows", 1, 1))
    got = TW.window_aggregate([_t(p) for p in parts], [_t(k) for k in okeys],
                              desc, fn, *[None if a is None else _t(a)
                                          for a in args], _t(alive),
                              ("rows", 1, 1))
    _check(fn, "rows_a_b", np.int64, got, want, vals, np.ones(N, bool), alive)


@pytest.mark.parametrize("packed", (True, False), ids=("packed", "chained"))
def test_range_frame_1m_rows(packed):
    """The port's twin of tests/test_window.py's 1 M-row RANGE +-500 case:
    spot checks against numpy."""
    rng = np.random.default_rng(7)
    n = 1_000_000
    part = rng.integers(0, 50, n).astype(np.int32)
    val = rng.integers(0, 100_000, n).astype(np.int32)
    x = rng.integers(-100, 100, n).astype(np.int64)
    res, _ = TW.window_aggregate(
        [_t(part)], [_t(val)], [False], "sum", _t(x), None,
        torch.ones(n, dtype=torch.bool), ("range", 500, 500),
        [(0, 49), (0, 99_999)] if packed else None)
    res = res.numpy()
    for i in rng.integers(0, n, 12):
        m = (part == part[i]) & (val >= val[i] - 500) & (val <= val[i] + 500)
        assert res[i] == x[m].sum(), i


@pytest.mark.parametrize("dtype", (np.float32, np.float64),
                         ids=lambda d: np.dtype(d).name)
def test_sliding_sums_long_segment_is_bit_equal(dtype):
    """A segment longer than the plain W4's vectorized steps slides in its
    scalar loop; both paths equal the reference bit for bit."""
    rng = np.random.default_rng(11)
    n = TW._PLAIN_SCALAR_SEGMENT + 3000
    part = (np.arange(n) >= n - 500).astype(np.int32)   # 2 segments
    okey = np.arange(n).astype(np.int32)
    vals = rng.normal(300, 100, n).astype(dtype)
    alive = np.ones(n, bool)
    want = JW.window_aggregate([_j(part)], [_j(okey)], [False], "sum",
                               _j(vals), None, _j(alive), ("rows", 3, 1))
    got = TW.window_aggregate([_t(part)], [_t(okey)], [False], "sum",
                              _t(vals), None, _t(alive), ("rows", 3, 1))
    np.testing.assert_array_equal(got[0].numpy().view(np.uint8),
                                  np.asarray(want[0]).view(np.uint8))


# ---------------------------------------------------------------------
# SQL parity at SF0.01
# ---------------------------------------------------------------------

SUB = "from lineitem where l_orderkey < 300"
ORD = "order by l_orderkey, l_linenumber"
# tests/test_window.py's table w(g, o, v) over lineitem: g = l_linenumber,
# o = l_partkey % 10 (peers), v = l_extendedprice; ROWS frames order by
# (o, l_orderkey), unique within a partition
FRAME_SHAPES = {
    "partition_total": "sum(l_extendedprice) over (partition by "
                       "l_linenumber)",
    "running_sum": "sum(l_extendedprice) over (partition by l_linenumber "
                   "order by l_partkey % 10)",
    "running_count_avg": "count(*) over (partition by l_linenumber order by "
                         "l_partkey % 10), avg(l_extendedprice) over "
                         "(partition by l_linenumber order by l_partkey % 10)",
    "rows_frame": "sum(l_extendedprice) over (partition by l_linenumber "
                  "order by l_partkey % 10, l_orderkey rows between 1 "
                  "preceding and current row)",
    "min_max_partition": "min(l_extendedprice) over (partition by "
                         "l_linenumber), max(l_extendedprice) over "
                         "(partition by l_linenumber)",
    "running_min": "min(l_extendedprice) over (partition by l_linenumber "
                   "order by l_partkey % 10)",
    "no_partition": "sum(l_extendedprice) over (order by l_partkey % 10)",
    "range_frame_bounded": "sum(l_extendedprice) over (partition by "
                           "l_linenumber order by l_partkey % 10 range "
                           "between 2 preceding and 2 following)",
    "range_frame_current": "count(l_extendedprice) over (partition by "
                           "l_linenumber order by l_partkey % 10 range "
                           "between 1 preceding and current row)",
    "range_frame_unbounded_start": "avg(l_extendedprice) over (partition by "
                                   "l_linenumber order by l_partkey % 10 "
                                   "range between unbounded preceding and 3 "
                                   "following)",
    "range_frame_min": "min(l_extendedprice) over (partition by "
                       "l_linenumber order by l_partkey % 10 range between "
                       "2 preceding and 2 following)",
    "rows_frame_minmax": "max(l_extendedprice) over (partition by "
                         "l_linenumber order by l_partkey % 10, l_orderkey "
                         "rows between 1 preceding and 1 following), "
                         "min(l_extendedprice) over (partition by "
                         "l_linenumber order by l_partkey % 10, l_orderkey "
                         "rows between 2 preceding and current row)",
    "range_frame_desc": "sum(l_extendedprice) over (partition by "
                        "l_linenumber order by l_partkey % 10 desc range "
                        "between 2 preceding and 1 following), "
                        "max(l_extendedprice) over (partition by "
                        "l_linenumber order by l_partkey % 10 desc range "
                        "between 2 preceding and current row)",
}
SQL = {**{name: f"select l_orderkey, l_linenumber, {w} {SUB} {ORD}"
          for name, w in FRAME_SHAPES.items()},
       **WINDOW_QUERIES}
# sqlite keeps DATEs as ISO text; W-Q5's RANGE runs over the date's code
# (year << 9 | month << 5 | day), as the engines order DATEs
DATE_CODE = ("(cast(substr(l_shipdate, 1, 4) as integer) * 512 + "
             "cast(substr(l_shipdate, 6, 2) as integer) * 32 + "
             "cast(substr(l_shipdate, 9, 2) as integer))")
SQLITE_SQL = {"w5": WINDOW_QUERIES["w5"].replace(
    "order by l_shipdate", f"order by {DATE_CODE}")}


@pytest.fixture(scope="module")
def engines():
    jdb = JaxDatabase()
    data = load_tpch(jdb, scale=0.01, seed=0)
    conn = load_sqlite(data)
    tdb = Database(device="cpu")
    port_load_tpch(tdb, scale=0.01, seed=0)
    yield jdb, tdb, conn
    tdb.close()


def _assert_rows(ours, want, what):
    assert len(ours) == len(want), f"{what}: {len(ours)} vs {len(want)} rows"
    for i, (a, b) in enumerate(zip(ours, want)):
        assert _row_eq(a, b), f"{what} row {i}: {a} != {b}"


@pytest.mark.parametrize("name", list(SQL))
def test_window_sql_matches_reference_and_sqlite(engines, name):
    jdb, tdb, conn = engines
    ours = tdb.execute(SQL[name]).rows
    assert ours, name
    assert tdb.executor.host_syncs == 1 and tdb.executor.retries == 0
    _assert_rows(ours, jdb.execute(SQL[name]).rows, f"{name} vs quickstep_tpu")
    oracle = conn.execute(to_sqlite_sql(SQLITE_SQL.get(name, SQL[name])))
    _assert_rows(ours, oracle.fetchall(), f"{name} vs sqlite")


@pytest.mark.parametrize("name, kernel", [
    ("w1", "_seg_total_plain"), ("w2", "segmented_prefix_plain"),
    ("w3", "segmented_prefix_plain"), ("w4", "sliding_sums_plain"),
    ("w5", "frame_bounds_plain"), ("w5", "frame_minmax_plain"),
    ("w6", "frame_minmax_plain")])
def test_window_query_reaches_its_kernel(engines, name, kernel, monkeypatch):
    """Each SF10 window query reaches the plain twin of the kernel it must
    launch on the card: W1 (_seg_total's and segmented_prefix's), W4, W3
    and W2."""
    _jdb, tdb, _conn = engines
    calls = []
    real = getattr(TW, kernel)
    monkeypatch.setattr(TW, kernel,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tdb.execute(WINDOW_QUERIES[name])
    assert calls, (name, kernel)
