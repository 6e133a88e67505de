"""The port's mesh path end to end on the CPU: the 22 TPC-H queries on an
8-shard mesh against the port on one device (which tests/
test_torch_tpch_slice.py holds against quickstep_tpu and sqlite), with the
tolerance of tests/test_distributed.py, and its DML case; the queries that
chip_smoke.py runs on the card's 8-shard mesh take the shuffle join (with
its LIP filter) and Q9 the two-phase GROUP BY at the SF10 thresholds scaled
to SF0.01; and distributed_agg_join_step against quickstep_tpu's on the 8
virtual devices of tests/conftest.py."""

import numpy as np
import pytest
import torch

import jax

from quickstep_tpu.parallel import dist as JD
from quickstep_tpu.parallel import mesh as JM
from quickstep_tpu_torch import Database
from quickstep_tpu_torch.bench.tpch import TPCH_QUERIES, load_tpch
from quickstep_tpu_torch.config import Config
from quickstep_tpu_torch.exec.runner import PlanRunner
from quickstep_tpu_torch.parallel import dist as TD
from quickstep_tpu_torch.parallel import mesh as TM

N = 8
# the SF10 queries of chip_smoke.py's mesh phase
SMOKE_QUERIES = (3, 5, 9, 10, 18)


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


@pytest.mark.parametrize("qnum", list(range(1, 23)))
def test_distributed_matches_single(pair, qnum):
    single, dist = pair
    a = single.execute(TPCH_QUERIES[qnum]).rows
    b = dist.execute(TPCH_QUERIES[qnum]).rows
    assert len(a) == len(b), f"Q{qnum}: {len(a)} vs {len(b)} rows"
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb)
        for x, y in zip(ra, rb):
            if isinstance(x, float) and isinstance(y, float):
                assert abs(x - y) <= 1e-6 * max(1.0, abs(x)), f"Q{qnum}"
            else:
                assert x == y, f"Q{qnum}: {ra} vs {rb}"


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
