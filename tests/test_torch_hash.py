"""K10 and K11 on the CPU: the port's key hashing and open addressing
(their plain versions, which the CUDA kernels are held against on the card)
against the JAX package's hash64/hash_combine and oa_build/oa_probe, on the
same numpy-seeded inputs, and TABLESAMPLE's mask against the reference's.

Tolerance: none. Hashes are compared bit for bit (the port's int64 bits
against the reference's uint64), and open addressing's matched mask
exactly, with the matched build row exactly wherever the build keys are
unique (with duplicate keys, which equal row settles may differ). The dup
flag is held to the truth (two live rows share a key): the reference's
under-reports duplicates that collide in one round."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quickstep_tpu.ops import join as RJ
from quickstep_tpu.ops import kernels as RK
from quickstep_tpu_torch.ops import join as J
from quickstep_tpu_torch.ops import kernels as K

EDGES = np.array([np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1, 0, 1,
                  np.iinfo(np.int32).min, np.iinfo(np.int32).max, -(1 << 62),
                  (1 << 62), 12345678901234], dtype=np.int64)


def _cols(seed, ncols, dtype, n=2000):
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    out = []
    for _ in range(ncols):
        c = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
        c[:len(EDGES)] = EDGES.astype(dtype)   # int32: the wrapped edges
        out.append(c)
    return out


def _reference_hash(cols):
    hs = [RK.hash64(jnp.asarray(c).astype(jnp.int64)) for c in cols]
    return np.asarray(RK.hash_combine(hs)).view(np.int64)


@pytest.mark.parametrize("ncols", [1, 2, 3, 8])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_hash_keys_bit_identical(ncols, dtype):
    cols = _cols(ncols * 7 + dtype().itemsize, ncols, dtype)
    got = K.hash_keys([torch.from_numpy(c) for c in cols]).numpy()
    np.testing.assert_array_equal(got, _reference_hash(cols))


def test_hash64_alone_bit_identical():
    x = np.concatenate([EDGES, np.arange(-500, 500, dtype=np.int64)])
    got = K.hash64(torch.from_numpy(x)).numpy()
    want = np.asarray(RK.hash64(jnp.asarray(x))).view(np.int64)
    np.testing.assert_array_equal(got, want)


def _oa_case(seed, n_build, n_probe, ncols, dup_share, dtype):
    rng = np.random.default_rng(seed)
    domain = max(4, int(n_build * (1 - dup_share)))
    base = rng.integers(0, domain, (n_build, ncols))
    if dtype == np.float64:
        base = base * 0.5 - 3.0
    build = [base[:, j].astype(dtype) for j in range(ncols)]
    pick = rng.integers(0, n_build, n_probe)
    probe = [b[pick].copy() for b in build]
    miss = rng.random(n_probe) < 0.3
    probe[0][miss] = probe[0][miss] + (domain + 7)
    balive = rng.random(n_build) < 0.9
    palive = rng.random(n_probe) < 0.9
    return build, probe, balive, palive


@pytest.mark.parametrize("ncols", [1, 2, 3])
@pytest.mark.parametrize("dup_share", [0.0, 0.5])
@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float64])
def test_open_addressing_matches_reference(ncols, dup_share, dtype):
    build, probe, balive, palive = _oa_case(
        ncols * 31 + int(dup_share * 10), 700, 900, ncols, dup_share, dtype)
    tsize = K.next_pow2(2 * len(balive))
    rtable, rdup = RJ.oa_build([jnp.asarray(c) for c in build],
                               jnp.asarray(balive), tsize)
    ridx, rmatched = RJ.oa_probe(rtable, [jnp.asarray(c) for c in build],
                                 [jnp.asarray(c) for c in probe],
                                 jnp.asarray(palive))
    tb = [torch.from_numpy(c) for c in build]
    table, dup = J.oa_build(tb, torch.from_numpy(balive), tsize)
    idx, matched = J.oa_probe(table, tb, [torch.from_numpy(c) for c in probe],
                              torch.from_numpy(palive))
    np.testing.assert_array_equal(matched.numpy(), np.asarray(rmatched))
    keys = list(zip(*[c.tolist() for c in build]))
    live_count = {}
    for k, a in zip(keys, balive):
        if a:
            live_count[k] = live_count.get(k, 0) + 1
    # the dup flag: set exactly when two live rows share a key; the
    # reference's losers step on without comparing, so it may miss some
    assert bool(dup) == any(c > 1 for c in live_count.values())
    assert bool(dup) or not bool(rdup)
    # the row index wherever the probe key has one live build row
    pkeys = list(zip(*[c.tolist() for c in probe]))
    unique = np.array([live_count.get(k, 0) == 1 for k in pkeys])
    np.testing.assert_array_equal(idx.numpy()[unique],
                                  np.asarray(ridx)[unique])
    # and every matched row holds the probe's key
    m = matched.numpy()
    for b, p in zip(build, probe):
        np.testing.assert_array_equal(b[idx.numpy()[m]], p[m])


def test_open_addressing_reference_kernel_shape():
    """tests/test_kernels.py:41's case: 64 unique composite keys, half of
    the probes matching, rows 0..31 found in order."""
    rng = np.random.default_rng(0)
    rng.integers(0, 1000, 64)
    k2 = rng.integers(0, 1000, 64)
    k1 = np.arange(64) * 3
    bkeys = [torch.from_numpy(k1), torch.from_numpy(k2)]
    table, dup = J.oa_build(bkeys, torch.ones(64, dtype=torch.bool), 256)
    assert not bool(dup)
    pk1 = torch.from_numpy(np.concatenate([k1[:32], k1[:32] + 1]))
    pk2 = torch.from_numpy(np.concatenate([k2[:32], k2[:32]]))
    bidx, matched = J.oa_probe(table, bkeys, [pk1, pk2],
                               torch.ones(64, dtype=torch.bool))
    assert matched[:32].all() and not matched[32:].any()
    assert bidx[:32].tolist() == list(range(32))


@pytest.mark.parametrize("n, tsize", [(100, 128), (120, 128), (64, 128),
                                      (100, 256)])
def test_open_addressing_never_evicts(n, tsize):
    """tests/test_kernels.py:60's load: adversarial keys at a high load
    factor; every build key stays reachable."""
    keys = torch.arange(n, dtype=torch.int64) * 7919 + 13
    table, dup = J.oa_build([keys], torch.ones(n, dtype=torch.bool), tsize)
    assert not bool(dup)
    bidx, matched = J.oa_probe(table, [keys], [keys],
                               torch.ones(n, dtype=torch.bool))
    assert bool(matched.all())
    assert bidx.tolist() == list(range(n))


def test_open_addressing_empty_sides():
    empty = [torch.zeros(0, dtype=torch.int64)]
    table, dup = J.oa_build(empty, torch.zeros(0, dtype=torch.bool), 1)
    assert table.tolist() == [-1] and not bool(dup)
    probe = [torch.arange(5, dtype=torch.int64)]
    idx, matched = J.oa_probe(table, empty, probe,
                              torch.ones(5, dtype=torch.bool))
    assert idx.tolist() == [-1] * 5 and not matched.any()


@pytest.mark.parametrize("percent", [0, 1, 30, 50, 99])
def test_tablesample_mask_matches_reference(percent):
    """The port's TUPLESAMPLE rows are the reference's (the hash of the row
    index against an unsigned threshold)."""
    import quickstep_tpu
    import quickstep_tpu_torch
    sql = f"select x from s tuplesample {percent} percent"
    rows = []
    for db in (quickstep_tpu.Database(),
               quickstep_tpu_torch.Database(device="cpu")):
        db.execute("create table s (x int not null)")
        db.execute("insert into s values " +
                   ", ".join(f"({i})" for i in range(400)))
        rows.append(sorted(db.execute(sql).rows))
    assert rows[0] == rows[1]
    assert 0.5 * percent * 4 - 40 <= len(rows[1]) <= 1.5 * percent * 4 + 40
