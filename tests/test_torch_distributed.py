"""The port's mesh path end to end on the CPU: the 22 TPC-H queries on an
8-shard mesh against the port on one device (which tests/
test_torch_tpch_slice.py holds against quickstep_tpu and sqlite), with the
tolerance of tests/test_distributed.py, and its DML case; the queries that
chip_smoke.py runs on the card's 8-shard mesh take the shuffle join (with
its LIP filter) and Q9 the two-phase GROUP BY at the SF10 thresholds scaled
to SF0.01; distributed_agg_join_step against quickstep_tpu's on the 8
virtual devices of tests/conftest.py; the queries whose aggregates and
broadcast joins run per shard (TPC-H Q1, Q5, Q6, Q14, Q19 and the star
battery of tests/multihost_worker.py), and bench/multihost_run.py's
SEMI_QUERIES (the semi, anti and expansion joins that run on each
process's rows), against quickstep_tpu's own mesh of those 8 devices;
the per-shard K1 and K2 plain versions, their partial states folded
(parallel/mesh.py fold_partials), against quickstep_tpu's scalar_agg and
dense_groupby over the whole input; and a capacity that does not split
into the shards, which runs the aggregate whole."""

import numpy as np
import pytest
import torch

import jax

from quickstep_tpu.parallel import dist as JD
from quickstep_tpu.parallel import mesh as JM
from quickstep_tpu_torch import Database
from quickstep_tpu_torch.bench import multihost_run as MR
from quickstep_tpu_torch.bench.tpch import TPCH_QUERIES, load_tpch
from quickstep_tpu_torch.config import Config
from quickstep_tpu_torch.exec.runner import PlanRunner
from quickstep_tpu_torch.ops import groupby as G
from quickstep_tpu_torch.parallel import dist as TD
from quickstep_tpu_torch.parallel import mesh as TM

N = 8
# the SF10 queries of chip_smoke.py's mesh phase
SMOKE_QUERIES = (3, 5, 9, 10, 18)
# queries whose aggregates (and Q5's, Q14's, Q19's broadcast joins) run per
# shard, held against quickstep_tpu's mesh
PER_SHARD_QUERIES = (1, 5, 6, 14, 19)
REL_TOL = 1e-6      # tests/test_distributed.py's bound


def _mesh_db(threshold: int) -> Database:
    cfg = Config()
    cfg.distributed = True
    cfg.replicate_threshold_rows = threshold
    return Database(config=cfg, device="cpu", mesh_shards=N)


@pytest.fixture(scope="module")
def pair():
    single = Database(device="cpu")
    load_tpch(single, scale=0.005, seed=0)
    # lineitem and orders shard, the dimension tables replicate
    dist = _mesh_db(2000)
    load_tpch(dist, scale=0.005, seed=0)
    assert dist.executor.mesh is not None
    yield single, dist
    single.close()
    dist.close()


def _assert_rows_close(a, b, what):
    """Row for row: floats within REL_TOL relative, all else equal."""
    a, b = [tuple(r) for r in a], [tuple(r) for r in b]
    assert len(a) == len(b), f"{what}: {len(a)} vs {len(b)} rows"
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb)
        for x, y in zip(ra, rb):
            if isinstance(x, float) and isinstance(y, float):
                assert abs(x - y) <= REL_TOL * max(1.0, abs(x)), what
            else:
                assert x == y, f"{what}: {ra} vs {rb}"


@pytest.mark.parametrize("qnum", list(range(1, 23)))
def test_distributed_matches_single(pair, qnum):
    single, dist = pair
    _assert_rows_close(single.execute(TPCH_QUERIES[qnum]).rows,
                       dist.execute(TPCH_QUERIES[qnum]).rows, f"Q{qnum}")


def test_distributed_dml(pair):
    _, dist = pair
    dist.execute("CREATE TABLE dd (a INT NOT NULL)")
    dist.execute("INSERT INTO dd VALUES (1), (2), (3)")
    assert dist.execute("SELECT sum(a) FROM dd").rows == [(6,)]
    dist.execute("DELETE FROM dd WHERE a = 2")
    assert dist.execute("SELECT sum(a), count(*) FROM dd").rows == [(4, 2)]
    dist.execute("DROP TABLE dd")


@pytest.fixture(scope="module")
def smoke_scaled():
    """SF0.01 on an 8-shard mesh with the default threshold scaled as the
    tables are (65,536 rows at SF10), and the port on one device."""
    dist = _mesh_db(65_536 // 1000)
    load_tpch(dist, scale=0.01, seed=0)
    single = Database(device="cpu")
    load_tpch(single, scale=0.01, seed=0)
    yield dist, single
    dist.close()
    single.close()


@pytest.mark.parametrize("qnum", SMOKE_QUERIES)
def test_smoke_queries_take_the_mesh_paths(smoke_scaled, qnum, monkeypatch):
    dist, single = smoke_scaled
    taken = {"shuffle": [], "dist_groupby": 0}
    real_sj = PlanRunner._shuffle_join
    real_dg = PlanRunner._dist_sort_groupby

    def shuffle_join(self, node, *args, **kwargs):
        out = real_sj(self, node, *args, **kwargs)
        if out is not None:
            taken["shuffle"].append((node.kind, self.last_shuffle_info))
        return out

    def dist_groupby(self, *args, **kwargs):
        out = real_dg(self, *args, **kwargs)
        taken["dist_groupby"] += out is not None
        return out
    monkeypatch.setattr(PlanRunner, "_shuffle_join", shuffle_join)
    monkeypatch.setattr(PlanRunner, "_dist_sort_groupby", dist_groupby)
    rows = dist.execute(TPCH_QUERIES[qnum]).rows
    assert rows == single.execute(TPCH_QUERIES[qnum]).rows or all(
        len(a) == len(b) and all(
            abs(x - y) <= 1e-6 * max(1.0, abs(x))
            if isinstance(x, float) else x == y for x, y in zip(a, b))
        for a, b in zip(rows, single.execute(TPCH_QUERIES[qnum]).rows))
    assert taken["shuffle"], f"Q{qnum} took no shuffle join"
    assert any(kind in ("inner", "semi") and info["lip_bits"] > 0
               for kind, info in taken["shuffle"]), taken["shuffle"]
    if qnum == 9:
        assert taken["dist_groupby"], "Q9 took the one-phase GROUP BY"


def test_distributed_agg_join_step_matches_reference():
    if len(jax.devices()) < N:
        pytest.skip("needs the 8-device virtual mesh of tests/conftest.py")
    jmesh = JM.make_mesh(N)
    want_sums, want_counts = JD.distributed_agg_join_step(jmesh)(
        *JD.make_example_inputs(jmesh))
    tmesh = TM.make_mesh(N, "cpu")
    sums, counts = TD.distributed_agg_join_step(tmesh)(
        *TD.make_example_inputs(tmesh))
    assert sums.dtype == torch.float64 and counts.dtype == torch.int64
    np.testing.assert_allclose(sums.numpy(), np.asarray(want_sums),
                               rtol=1e-12, atol=0)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    assert int(counts.sum()) == N * 256


def test_distributed_agg_join_step_drops_unmatched_rows():
    """Probe keys outside the build side's and dead rows count nowhere."""
    mesh = TM.make_mesh(4, "cpu")
    rng = np.random.default_rng(9)
    n = 4 * 500
    l_key = torch.from_numpy(rng.integers(0, 100, n))
    l_val = torch.from_numpy(rng.uniform(0, 10, n))
    l_grp = torch.from_numpy(rng.integers(0, 8, n))
    l_alive = torch.from_numpy(rng.random(n) < 0.7)
    b_key = torch.arange(0, 100, 2)
    b_alive = torch.ones(50, dtype=torch.bool)
    sums, counts = TD.distributed_agg_join_step(mesh)(
        l_key, l_val, l_grp, l_alive, b_key, b_alive)
    keep = l_alive & (l_key % 2 == 0)
    for g in range(8):
        sel = keep & (l_grp == g)
        assert int(counts[g]) == int(sel.sum())
        assert abs(float(sums[g]) - float(l_val[sel].sum())) <= \
            1e-12 * max(1.0, float(l_val[sel].sum()))


def _needs_reference_mesh():
    if len(jax.devices()) < N:
        pytest.skip("needs the 8-device virtual mesh of tests/conftest.py")


@pytest.fixture(scope="module")
def reference_mesh():
    """quickstep_tpu distributed over the 8 virtual devices, on `pair`'s
    data (SF0.005, seed 0) and replicate threshold."""
    _needs_reference_mesh()
    from quickstep_tpu import Database as JDatabase
    from quickstep_tpu.bench.tpch import load_tpch as jax_load_tpch
    from quickstep_tpu.config import Config as JConfig
    cfg = JConfig()
    cfg.distributed = True
    cfg.replicate_threshold_rows = 2000
    db = JDatabase(config=cfg)
    jax_load_tpch(db, scale=0.005, seed=0)
    assert db.executor.mesh is not None
    return db


@pytest.mark.parametrize("qnum", PER_SHARD_QUERIES)
def test_per_shard_queries_match_the_reference_mesh(pair, reference_mesh,
                                                    qnum, monkeypatch):
    """The port's 8-shard mesh, its aggregates folded from per-shard
    partials, against quickstep_tpu's 8-device mesh."""
    _, dist = pair
    folds = []
    real = PlanRunner._per_shard

    def per_shard(self, chunk, *args):
        folds.append(len(self._shard_slices(chunk)))
        return real(self, chunk, *args)
    monkeypatch.setattr(PlanRunner, "_per_shard", per_shard)
    rows = dist.execute(TPCH_QUERIES[qnum]).rows
    assert folds and set(folds) == {N}, folds
    _assert_rows_close(reference_mesh.execute(TPCH_QUERIES[qnum]).rows, rows,
                       f"Q{qnum}")


@pytest.fixture(scope="module")
def star_pair():
    """tests/multihost_worker.py's star on quickstep_tpu's 8-device mesh
    and on the port's 8-shard mesh, at its replicate threshold."""
    _needs_reference_mesh()
    from multihost_worker import build_db
    from quickstep_tpu.config import Config as JConfig
    ref = build_db(JConfig(distributed=True, replicate_threshold_rows=64,
                           display_timing=False))
    port = MR.build_db(MR.config(MR.STAR_THRESHOLD), "cpu", N)
    yield ref, port
    port.close()


@pytest.mark.parametrize("name", sorted(MR.QUERIES))
def test_star_battery_matches_the_reference_mesh(star_pair, name):
    ref, port = star_pair
    _assert_rows_close(ref.execute(MR.QUERIES[name]).rows,
                       port.execute(MR.QUERIES[name]).rows, name)


@pytest.fixture(scope="module")
def semi_pair(star_pair):
    """star_pair with multihost_run's SEMI_TABLES made by the same SQL in
    both databases."""
    ref, port = star_pair
    for stmt in MR.SEMI_TABLES:
        ref.execute(stmt)
        port.execute(stmt)
    return ref, port


@pytest.mark.parametrize("name", sorted(MR.SEMI_QUERIES))
def test_semi_battery_matches_the_reference_mesh(semi_pair, name):
    """The semi, anti and expansion joins that run on each process's rows
    (NOT IN with a NULL or an empty build on one process's shards, the run
    statistics, expansion overflows) on the port's 8-shard mesh against
    quickstep_tpu's 8-device mesh: integers exact, floats within
    REL_TOL."""
    ref, port = semi_pair
    _assert_rows_close(ref.execute(MR.SEMI_QUERIES[name]).rows,
                       port.execute(MR.SEMI_QUERIES[name]).rows, name)


# ---------------------------------------------------------------------
# the fold: per-shard K1 and K2 plain versions against the whole input
# ---------------------------------------------------------------------
SHARD_ROWS = 16
FOLD_CASES = ("mixed", "empty", "dead_shard", "null_shard", "all_dead",
              "extremes", "nan")
AGG_FNS = ("count", "sum", "avg", "min", "max")
# integers hold no NaN
FOLD_PARAMS = [(case, dtype) for case in FOLD_CASES
               for dtype in ("int64", "float64")
               if not (case == "nan" and dtype == "int64")]


def _fold_inputs(case, dtype):
    """(values, valid, alive, group keys) over N shards of SHARD_ROWS rows
    (none for "empty", and the reference's inputs one dead row, since it
    takes no zero-row input): "dead_shard" has shard 3's rows all dead,
    "null_shard" shard 5's values all NULL (its MIN and MAX partials are
    the sentinels), "all_dead" no live row, "extremes" live values at the
    dtype's largest and smallest (infinities for floats), "nan" one NaN in
    shard 6."""
    rng = np.random.default_rng(FOLD_CASES.index(case))
    n = 0 if case == "empty" else N * SHARD_ROWS
    if np.dtype(dtype).kind == "f":
        vals = rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, n)
    else:
        vals = rng.integers(-10 ** 6, 10 ** 6, n)
    vals = vals.astype(dtype)
    valid = rng.random(n) < 0.8
    alive = rng.random(n) < 0.7
    keys = rng.integers(0, 5, n)
    shard = np.arange(n) // SHARD_ROWS
    if case == "dead_shard":
        alive[shard == 3] = False
    elif case == "null_shard":
        valid[shard == 5] = False
    elif case == "all_dead":
        alive[:] = False
    elif case == "extremes":
        big = np.inf if vals.dtype.kind == "f" else np.iinfo(dtype).max
        small = -np.inf if vals.dtype.kind == "f" else np.iinfo(dtype).min
        vals[shard == 1] = big
        vals[shard == 2] = small
        alive[shard == 1] = True
        valid[shard == 1] = True
    elif case == "nan":
        vals[6 * SHARD_ROWS + 2] = np.nan
        alive[6 * SHARD_ROWS + 2] = valid[6 * SHARD_ROWS + 2] = True
    return vals, valid, alive, keys


def _reference_inputs(vals, valid, alive, keys):
    """jax arrays of the inputs; of zero rows, one dead row instead."""
    import jax.numpy as jnp
    if not len(vals):
        vals, valid, alive, keys = (np.zeros(1, x.dtype)
                                    for x in (vals, valid, alive, keys))
    return tuple(jnp.asarray(x) for x in (vals, valid, alive, keys))


def _folded(agg_specs, reduce, n_rows):
    """reduce(slice, specs) -> (flags, results) on each of N shards,
    folded as the runner's per-shard aggregates fold them."""
    mesh = TM.make_mesh(N, "cpu")
    per = n_rows // N
    parts = []
    for i in range(N):
        sl = slice(i * per, (i + 1) * per)
        specs = [(fn, None if v is None else v[sl],
                  None if vd is None else vd[sl])
                 for fn, v, vd in G.partial_specs(agg_specs)]
        flags, res = reduce(sl, specs)
        parts.append([("or", f) for f in flags] +
                     G.partial_states(agg_specs, res))
    folded = TM.fold_partials(mesh, parts, local=False)
    return folded[:len(flags)], G.merge_partials(agg_specs,
                                                 folded[len(flags):])


def _assert_agg_close(got, nn, want, want_nn, fn, what):
    """Counts exact; where a value counts (a live non-null row), integers,
    MIN and MAX exact, float sums within 1e-12 relative, NaN as NaN."""
    got, nn = np.asarray(got), np.asarray(nn)
    want, want_nn = np.asarray(want), np.asarray(want_nn)
    np.testing.assert_array_equal(nn, want_nn, err_msg=what)
    if fn == "count":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    keep = want_nn > 0
    got, want = got[keep], want[keep]
    if got.dtype.kind == "f" and fn in ("sum", "avg"):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0,
                                   equal_nan=True, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("case,dtype", FOLD_PARAMS)
def test_scalar_agg_fold_matches_reference(case, dtype):
    from quickstep_tpu.ops import groupby as JG
    vals, valid, alive, keys = _fold_inputs(case, dtype)
    jv, jvd, ja, _ = _reference_inputs(vals, valid, alive, keys)
    tv, tvd, ta = (torch.from_numpy(x) for x in (vals, valid, alive))
    specs = [(fn, None if fn == "count" else tv, tvd) for fn in AGG_FNS]
    _, results = _folded(specs, lambda sl, cut: ([], [
        G.scalar_agg_plain(fn, v, vd, ta[sl]) for fn, v, vd in cut]),
        len(vals))
    for fn, (got, nn) in zip(AGG_FNS, results):
        want, want_nn = JG.scalar_agg(fn, None if fn == "count" else jv,
                                      jvd, ja)
        _assert_agg_close(got.reshape(1), nn.reshape(1),
                          np.asarray(want).reshape(1),
                          np.asarray(want_nn).reshape(1), fn, f"{case} {fn}")
        if fn in ("min", "max") and int(want_nn) == 0:
            # no live value anywhere: every shard's sentinel folds to it
            assert float(got) == float(want), (case, fn)


DOMAIN = 5


@pytest.mark.parametrize("case,dtype", FOLD_PARAMS)
def test_dense_groupby_fold_matches_reference(case, dtype):
    from quickstep_tpu.ops import groupby as JG
    vals, valid, alive, keys = _fold_inputs(case, dtype)
    jv, jvd, ja, jk = _reference_inputs(vals, valid, alive, keys)
    tv, tvd, ta, tk = (torch.from_numpy(x)
                       for x in (vals, valid, alive, keys))
    specs = [(fn, None if fn == "count" else tv, tvd) for fn in AGG_FNS]

    def reduce(sl, cut):
        occupied, res = G.dense_aggregate_plain([tk[sl]], [0], [1], DOMAIN,
                                                cut, ta[sl])
        return [occupied], res
    (occupied,), results = _folded(specs, reduce, len(vals))
    idx = JG.pack_dense_index([jk], [0], [1], DOMAIN, ja)
    want_occ, want = JG.dense_groupby(
        idx, DOMAIN, [(fn, None if fn == "count" else jv, jvd)
                      for fn in AGG_FNS], ja)
    np.testing.assert_array_equal(occupied.numpy(), np.asarray(want_occ))
    for fn, (got, nn), (w, w_nn) in zip(AGG_FNS, results, want):
        _assert_agg_close(got.numpy(), nn.numpy(), w, w_nn, fn,
                          f"{case} {fn}")


def test_an_uneven_capacity_runs_the_aggregate_whole(monkeypatch):
    """generate_series(1, 10) on the 8-shard mesh: 10 rows do not split
    into 8 shards, a replicated fact, so the scalar aggregate and the dense
    GROUP BY run once over the whole input; 16 rows split, and run per
    shard. Both give the one-device rows."""
    calls = {"per_shard": 0, "scalar": 0, "dense": 0}
    real = (PlanRunner._per_shard, G.scalar_agg, G.dense_aggregate)

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call
    monkeypatch.setattr(PlanRunner, "_per_shard",
                        counted("per_shard", real[0]))
    monkeypatch.setattr(G, "scalar_agg", counted("scalar", real[1]))
    monkeypatch.setattr(G, "dense_aggregate", counted("dense", real[2]))
    cfg = Config()
    cfg.distributed = True
    mesh = Database(config=cfg, device="cpu", mesh_shards=N)
    one = Database(device="cpu")
    for rows in (10, 16):
        for sql in (
                "SELECT COUNT(*), SUM(g), MIN(g), MAX(g) FROM "
                f"generate_series(1, {rows}) AS t(g)",
                "SELECT g, COUNT(*), SUM(g) FROM "
                f"generate_series(1, {rows}) AS t(g) GROUP BY g ORDER BY g"):
            want = one.execute(sql).rows
            for k in calls:
                calls[k] = 0
            assert mesh.execute(sql).rows == want, sql
            launches = 1 if rows == 10 else N
            assert calls["per_shard"] == (rows == 16), (sql, calls)
            assert calls["scalar" if "GROUP" not in sql else "dense"] == \
                (4 * launches if "GROUP" not in sql else launches), \
                (sql, calls)
    mesh.close()
    one.close()
