"""The port's mesh path against quickstep_tpu's on the CPU: the partition
function, the radix exchange over 8 shards against the reference inside
shard_map over the 8 virtual devices tests/conftest.py forces (buffers,
live masks and overflow bit for bit), scatter_compact and the bloom filter,
and the counterparts of the 8 shuffle-join tests of tests/test_shuffle.py,
each holding the port's 8-shard mesh against the port without a mesh and
against quickstep_tpu on one device, and asserting that the shuffle ran
(its flag in last_flags, and partition_dest, K14's entry point, called once
per shard and exchange). Inputs come from numpy with a seed."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from quickstep_tpu import Database as JaxDatabase
from quickstep_tpu.ops import bloom as JB
from quickstep_tpu.ops import kernels as JK
from quickstep_tpu.parallel import mesh as JM
from quickstep_tpu.parallel import shuffle as JSH
from quickstep_tpu_torch import Database
from quickstep_tpu_torch.config import Config
from quickstep_tpu_torch.exec.runner import PlanRunner
from quickstep_tpu_torch.ops import bloom as TB
from quickstep_tpu_torch.ops import kernels as TK
from quickstep_tpu_torch.parallel import mesh as TM
from quickstep_tpu_torch.parallel import shuffle as TSH

N = 8
L = 1000          # rows per shard in the exchange tests


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < N:
        pytest.skip("needs the 8-device virtual mesh of tests/conftest.py")
    return JM.make_mesh(N)


def _keys(dtype, n, seed):
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    keys = rng.integers(info.min, info.max, n, dtype=np.int64).astype(dtype)
    # repeats, and the small keys a packed join key takes
    keys[::7] = rng.integers(0, 50, len(keys[::7]))
    return keys


@pytest.mark.parametrize("n_parts", (2, 3, 5, 8))
@pytest.mark.parametrize("dtype", (np.int32, np.int64))
def test_partition_of_matches_reference(dtype, n_parts):
    keys = _keys(dtype, 20_000, 1)
    h = np.asarray(JK.hash64(jnp.asarray(keys.astype(np.int64))))
    assert (h >= 2 ** 63).any(), "no hash negative as int64"
    want = np.asarray(JSH._partition_of(jnp.asarray(keys), n_parts))
    got = TSH.partition_of(torch.from_numpy(keys), n_parts)
    np.testing.assert_array_equal(got.numpy(), want)


def _exchange_inputs(seed, hot=0.0):
    rng = np.random.default_rng(seed)
    n = N * L
    key = rng.integers(-10 ** 12, 10 ** 12, n).astype(np.int64)
    key = np.where(rng.random(n) < hot, key[0], key)
    val = rng.normal(0, 1e6, n)
    flag = rng.random(n) < 0.5
    small = rng.integers(-1000, 1000, n).astype(np.int32)
    alive = rng.random(n) < 0.9
    return key, val, flag, small, alive


def _reference_exchange(jmesh, inputs, cap, salt, probe_side):
    def body(k, v, f, c, a):
        ex, al, over = JSH.radix_exchange(k, [k, v, f, c], a, N, "x", cap,
                                          salt=salt, probe_side=probe_side)
        return tuple(ex) + (al, over)
    fn = shard_map(body, mesh=jmesh, in_specs=(P("x"),) * 5,
                   out_specs=(P("x"),) * 5 + (P(),))
    return [np.asarray(o) for o in fn(*[jnp.asarray(a) for a in inputs])]


def _port_exchange(inputs, cap, salt, probe_side):
    mesh = TM.make_mesh(N, "cpu")
    cols = [TM.shard_rows(mesh, torch.from_numpy(a)) for a in inputs]
    ex, alive, over = TSH.radix_exchange(
        mesh, cols[0], [list(c) for c in zip(*cols[:4])], cols[4], cap,
        salt=salt, probe_side=probe_side)
    outs = [torch.cat([e[c] for e in ex]).numpy() for c in range(4)]
    return outs + [torch.cat(alive).numpy(), bool(over)]


@pytest.mark.parametrize("probe_side", (True, False), ids=("probe", "build"))
@pytest.mark.parametrize("salt", (1, 2, 4))
def test_radix_exchange_matches_reference_bit_for_bit(jmesh, salt,
                                                      probe_side):
    inputs = _exchange_inputs(salt)
    rows = L * (1 if probe_side else salt)
    cap = -(-2 * rows // N)
    want = _reference_exchange(jmesh, inputs, cap, salt, probe_side)
    got = _port_exchange(inputs, cap, salt, probe_side)
    assert not bool(want[-1]) and not got[-1]
    for g, w in zip(got[:-1], want[:-1]):
        assert g.dtype == w.dtype and g.shape == w.shape == (N * N * cap,)
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))
    assert got[4].sum() == inputs[4].sum() * (1 if probe_side else salt)


@pytest.mark.parametrize("probe_side", (True, False), ids=("probe", "build"))
def test_radix_exchange_overflow_matches_reference(jmesh, probe_side):
    inputs = _exchange_inputs(7, hot=0.3)
    cap = L // N
    want = _reference_exchange(jmesh, inputs, cap, 2, probe_side)
    got = _port_exchange(inputs, cap, 2, probe_side)
    assert bool(want[-1]) and got[-1]
    for g, w in zip(got[:-1], want[:-1]):
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))


@pytest.mark.parametrize("fill", (0, -1))
@pytest.mark.parametrize("dtype", (np.int32, np.int64, np.float64, np.bool_))
def test_scatter_compact_matches_reference(dtype, fill):
    rng = np.random.default_rng(3)
    n, cap = 5_000, 8_192
    dest = rng.permutation(cap)[:n].astype(np.int32)
    dest[rng.random(n) < 0.2] = cap          # dropped rows
    col = rng.integers(-100, 100, n).astype(dtype)
    f = bool(fill) if dtype == np.bool_ else fill
    want = np.asarray(JK.scatter_compact(jnp.asarray(col), jnp.asarray(dest),
                                         cap, f))
    got = TK.scatter_compact(torch.from_numpy(col), torch.from_numpy(dest),
                             cap, f)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("ncols", (1, 3))
def test_bloom_filter_matches_reference(ncols):
    rng = np.random.default_rng(4)
    dtypes = (np.int64, np.int32, np.int64)[:ncols]
    build = [rng.integers(-10 ** 6, 10 ** 6, 3_000).astype(d) for d in dtypes]
    probe = [rng.integers(-10 ** 6, 10 ** 6, 20_000).astype(d)
             for d in dtypes]
    probe[0][:3_000] = build[0]
    for b, p in zip(build[1:], probe[1:]):
        p[:3_000] = b
    balive = rng.random(3_000) < 0.8
    palive = rng.random(20_000) < 0.9
    for nbits in (1024, 1 << 16):
        want_bits = JB.bloom_build([jnp.asarray(c) for c in build],
                                   jnp.asarray(balive), nbits)
        bits = TB.bloom_build([torch.from_numpy(c) for c in build],
                              torch.from_numpy(balive), nbits)
        np.testing.assert_array_equal(bits.numpy(), np.asarray(want_bits))
        # the table's words (K16's layout on the card) hold the same bits
        assert torch.equal(TB.presence_bits(TB.presence_words(bits), nbits),
                           bits)
        want = JB.bloom_probe(want_bits, [jnp.asarray(c) for c in probe],
                              jnp.asarray(palive))
        got = TB.bloom_probe(bits, [torch.from_numpy(c) for c in probe],
                             torch.from_numpy(palive), nbits)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------
# the shuffle join through SQL (tests/test_shuffle.py's cases)
# ---------------------------------------------------------------------
@pytest.fixture
def k14_calls(monkeypatch):
    """Calls of partition_dest (K14's entry point: on a CPU tensor it
    takes the plain version, on a CUDA tensor it launches K14)."""
    calls = [0]
    real = TSH.partition_dest

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)
    monkeypatch.setattr(TSH, "partition_dest", counted)
    return calls


def _mesh_config(**overrides):
    cfg = Config()
    cfg.distributed = True
    # both sides over the replicate threshold, so that the join shuffles
    cfg.replicate_threshold_rows = 64
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg


def _fill(db, rows_l, rows_r, analyze=True):
    db.execute("CREATE TABLE lt (k INT NOT NULL, v INT NOT NULL)")
    db.execute("CREATE TABLE rt (k INT NOT NULL, w INT NOT NULL)")
    db.execute("INSERT INTO lt VALUES " +
               ", ".join(f"({k}, {v})" for k, v in rows_l))
    db.execute("INSERT INTO rt VALUES " +
               ", ".join(f"({k}, {w})" for k, w in rows_r))
    if analyze:
        db.execute("\\analyze")


def _pairs(seed, n, key_hi, skew_key=None, skew_frac=0.0):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, key_hi, n)
    if skew_key is not None:
        hot = rng.random(n) < skew_frac
        keys = np.where(hot, skew_key, keys)
    vals = rng.integers(0, 1000, n)
    return list(zip(keys.tolist(), vals.tolist()))


def _shuffled(db) -> bool:
    return any(k.startswith("shuffle_overflow")
               for k in db.executor.last_flags)


def _run_three(rows_l, rows_r, sqls, k14_calls, **cfg):
    """Sorted rows of each query on the port's 8-shard mesh, the port on
    one device and quickstep_tpu on one device; each mesh run of a query
    in sqls must take the shuffle, one in sqls' `unshuffled` need not."""
    dist = Database(config=_mesh_config(**cfg), device="cpu", mesh_shards=N)
    single = Database(device="cpu")
    ref = JaxDatabase()
    try:
        for db in (dist, single, ref):
            _fill(db, rows_l, rows_r)
        assert dist.executor.mesh is not None
        out = []
        for sql in sqls:
            k14_calls[0] = 0
            got = sorted(dist.execute(sql).rows)
            if sql not in UNSHUFFLED:
                assert _shuffled(dist) and k14_calls[0] >= 2 * N, sql
            assert sorted(single.execute(sql).rows) == got, sql
            assert sorted(ref.execute(sql).rows) == got, sql
            out.append(got)
        return out
    finally:
        dist.close()
        single.close()


def test_shuffle_unique_join(k14_calls):
    rows_l = _pairs(0, 2000, 500)
    rows_r = [(k, k * 7) for k in range(500)]
    a, = _run_three(rows_l, rows_r,
                    ["SELECT lt.v, rt.w FROM lt, rt WHERE lt.k = rt.k"],
                    k14_calls)
    assert len(a) == 2000


def test_shuffle_manymany_join(k14_calls):
    rows_l = _pairs(1, 1000, 50)
    rows_r = _pairs(2, 600, 50)
    a, = _run_three(rows_l, rows_r,
                    ["SELECT lt.k, lt.v, rt.w FROM lt, rt WHERE lt.k = rt.k"],
                    k14_calls)
    assert len(a) > 1000


def test_shuffle_skewed_join(k14_calls):
    rows_l = _pairs(3, 2000, 400, skew_key=7, skew_frac=0.4)
    rows_r = _pairs(4, 300, 400)
    a, = _run_three(rows_l, rows_r,
                    ["SELECT lt.k, lt.v, rt.w FROM lt, rt WHERE lt.k = rt.k"],
                    k14_calls)
    assert a


# IN and NOT IN are null-aware: their answer needs the whole build side, so
# they keep the one-device join, as in the reference (runner.py:1060)
IN_SQL = "SELECT v FROM lt WHERE k IN (SELECT k FROM rt)"
NOT_IN_SQL = "SELECT v FROM lt WHERE k NOT IN (SELECT k FROM rt)"
UNSHUFFLED = {IN_SQL, NOT_IN_SQL}


def test_shuffle_semi_anti(k14_calls):
    """With the exact-filter strength reduction off, EXISTS and NOT EXISTS
    shuffle and give IN's and NOT IN's rows."""
    rows_l = _pairs(5, 1500, 300)
    rows_r = _pairs(6, 400, 150)
    semi, anti, exists, not_exists = _run_three(
        rows_l, rows_r,
        [IN_SQL, NOT_IN_SQL,
         "SELECT v FROM lt WHERE EXISTS (SELECT * FROM rt WHERE rt.k = lt.k)",
         "SELECT v FROM lt WHERE NOT EXISTS "
         "(SELECT * FROM rt WHERE rt.k = lt.k)"], k14_calls,
        use_filter_joins=False)
    assert semi and anti and len(semi) + len(anti) == 1500
    assert exists == semi and not_exists == anti


def test_shuffle_left_join(k14_calls):
    rows_l = _pairs(7, 1200, 600)
    rows_r = [(k, k + 1) for k in range(0, 600, 3)]
    a, = _run_three(
        rows_l, rows_r,
        ["SELECT lt.k, lt.v, rt.w FROM lt LEFT OUTER JOIN rt "
         "ON lt.k = rt.k"], k14_calls)
    assert len(a) == 1200


def test_shuffle_plans_no_replication(k14_calls):
    """The shuffle path (not broadcast) runs: the radix exchange always
    reports its (possibly False) overflow flag, and K14 runs once per shard
    for the build side and once per shard and probe slice."""
    rows_l = _pairs(8, 1000, 200)
    rows_r = _pairs(9, 500, 200)
    dist = Database(config=_mesh_config(shuffle_overlap_chunks=1),
                    device="cpu", mesh_shards=N)
    try:
        _fill(dist, rows_l, rows_r)
        k14_calls[0] = 0
        dist.execute("SELECT lt.v, rt.w FROM lt, rt WHERE lt.k = rt.k")
        assert _shuffled(dist), dist.executor.last_flags
        assert k14_calls[0] == 2 * N * (1 + dist.executor.retries)
    finally:
        dist.close()


def test_overlap_chunked_matches_sync(k14_calls):
    """Chunked and one-slice shuffles give the same rows; the chunked run
    exchanges each of its probe slices on its own."""
    # a probe capacity whose shards split into 4 equal slices
    rows_l = _pairs(10, 2048, 300)
    rows_r = _pairs(11, 800, 300)
    sql = "SELECT lt.k, lt.v, rt.w FROM lt, rt WHERE lt.k = rt.k"
    out = []
    for chunks in (1, 4):
        db = Database(config=_mesh_config(shuffle_overlap_chunks=chunks),
                      device="cpu", mesh_shards=N)
        try:
            _fill(db, rows_l, rows_r)
            db.execute(sql)                  # learns any override
            k14_calls[0] = 0
            out.append(sorted(db.execute(sql).rows))
            assert _shuffled(db)
            assert db.executor.retries == 0
            assert PlanRunner.trace_shuffle_info["chunks"] == chunks
            assert k14_calls[0] == N * (1 + chunks)
        finally:
            db.close()
    ref = JaxDatabase()
    _fill(ref, rows_l, rows_r)
    assert out[0] == out[1] == sorted(ref.execute(sql).rows)


def test_preshuffle_lip_filter_shrinks_exchange(k14_calls):
    """The build side's bloom filter, probed before the exchange, lets a
    selective join ship smaller probe buckets, with the same rows."""
    # probe keys span 0..9999, the build side only 0..99: the estimated
    # pass rate is ~1 %, floored at 1/8 of the unfiltered buckets
    rows_l = _pairs(12, 4000, 10000)
    rows_r = [(k, k * 2) for k in range(100)]
    sql = "SELECT lt.v, rt.w FROM lt, rt WHERE lt.k = rt.k"
    base = Database(config=_mesh_config(use_lip_filters=False), device="cpu",
                    mesh_shards=N)
    lip = Database(config=_mesh_config(), device="cpu", mesh_shards=N)
    try:
        _fill(base, rows_l, rows_r)
        a = sorted(base.execute(sql).rows)
        rows_nofilter = PlanRunner.trace_shuffle_info["probe_bucket_rows"]
        assert PlanRunner.trace_shuffle_info["lip_bits"] == 0
        _fill(lip, rows_l, rows_r)
        b = sorted(lip.execute(sql).rows)
        info = PlanRunner.trace_shuffle_info
        assert _shuffled(lip)
        assert info["lip_bits"] > 0
        assert info["probe_bucket_rows"] < rows_nofilter, info
    finally:
        base.close()
        lip.close()
    ref = JaxDatabase()
    _fill(ref, rows_l, rows_r)
    assert a == b == sorted(ref.execute(sql).rows)


def test_bucket_overflow_retries_with_larger_buckets(k14_calls):
    """Without statistics the buckets are twice a shard's mean share; a
    key that holds 60 % of the probe rows overflows its bucket, and the
    retry with shuffle_factor x 4 gives the exact rows."""
    rows_l = _pairs(13, 2400, 300, skew_key=11, skew_frac=0.6)
    rows_r = [(k, k * 3) for k in range(300)]
    sql = "SELECT lt.k, lt.v, rt.w FROM lt, rt WHERE lt.k = rt.k"
    dist = Database(config=_mesh_config(shuffle_overlap_chunks=1),
                    device="cpu", mesh_shards=N)
    single = Database(device="cpu")
    try:
        for db in (dist, single):
            _fill(db, rows_l, rows_r, analyze=False)
        got = sorted(dist.execute(sql).rows)
        assert dist.executor.retries >= 1
        assert _shuffled(dist) and not any(dist.executor.last_flags.values())
        runner_key = next(iter(dist.executor._learned_overrides.values()))
        assert any(ov.shuffle_factor >= 4 for ov in runner_key.values())
        assert got == sorted(single.execute(sql).rows)
        assert len(got) == 2400
    finally:
        dist.close()
        single.close()
