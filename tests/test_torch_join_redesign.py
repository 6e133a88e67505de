"""The host-side logic of K3's presence bitmap and K7's fence, as plain
models, against the JAX package on the same numpy-seeded inputs.

K3 (csrc/join_kernels.cu): ops/bloom.py presence_words and presence_bits
(the bitmap's layout, value i at bit i % 32 of word i // 32) against
quickstep_tpu's exact filter; a model of the probe on the row table with
the bitmap in front (test the bit, read the slot only where it is set)
against quickstep_tpu's direct_probe; ops/cuda.py direct_route and the
buffer's length.

K7 (csrc/join_kernels.cu): the fence that ops/cuda.py fence_layout sizes,
built and searched as the kernels do (a binary search of the top level,
then one node of 4 keys a level and one leaf of 4 keys, counting the keys
below the probe's), then the walk of K + 1 keys and the second search for
an overflowing run's length; rows and counts equal quickstep_tpu's
expand_probe.

Tolerance: none anywhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickstep_tpu.ops import bloom as JB
from quickstep_tpu.ops import join as JJ
from quickstep_tpu_torch.ops import bloom as TB
from quickstep_tpu_torch.ops import cuda as TC
from quickstep_tpu_torch.ops import join as TJ

DEAD = np.iinfo(np.int64).max


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(a)


# ---------------------------------------------------------------------
# K3: the presence bitmap
# ---------------------------------------------------------------------

def _direct_inputs(domain, seed, lo=40, n_build=None, n_probe=3000):
    """Build keys over [lo - 3, lo + domain + 3) (some outside the
    domain), repeated; probe keys over a wider range; ~20% dead rows."""
    rng = np.random.default_rng(seed)
    n_build = n_build or max(1, domain // 2)
    bkey = rng.integers(lo - 3, lo + domain + 3, n_build)
    pkey = rng.integers(lo - 10, lo + domain + 10, n_probe)
    return (bkey, rng.random(n_build) < 0.8, pkey,
            rng.random(n_probe) < 0.8, lo)


def _bit_test(words, idx):
    """K3's bitmap read: the bit of each slot (idx in range)."""
    w = words.to(torch.int64)[idx >> 5]
    return ((w >> (idx & 31)) & 1) != 0


@pytest.mark.parametrize("domain", (1, 31, 32, 33, 1000, 4099))
def test_presence_words_hold_the_reference_filter(domain):
    bkey, bmask, pkey, pmask, lo = _direct_inputs(domain, seed=domain)
    want = np.asarray(JB.exact_filter_build(_j(bkey), _j(bmask), lo, domain))
    words = TB.presence_words(_t(want))
    assert words.dtype == torch.int32
    assert words.shape == (TC.bitmap_words(domain),) == (-(-domain // 32),)
    np.testing.assert_array_equal(TB.presence_bits(words, domain).numpy(),
                                  want)
    # bit i % 32 of word i // 32, as the kernels set it
    u = words.numpy().view(np.uint32)
    idx = np.arange(domain)
    np.testing.assert_array_equal((u[idx // 32] >> (idx % 32)) & 1, want)
    # the probe of the bitmap alone (the exact filter's layout)
    idx = _t(pkey) - lo
    ok = _t(pmask) & (idx >= 0) & (idx < 32 * words.shape[0])
    got = ok & _bit_test(words, idx.clamp(0, 32 * words.shape[0] - 1))
    want_probe = JB.exact_filter_probe(_j(want), _j(pkey), _j(pmask), lo)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_probe))


@pytest.mark.parametrize("domain", (1, 33, 5000))
@pytest.mark.parametrize("key_dtype", (np.int32, np.int64),
                         ids=lambda d: np.dtype(d).name)
def test_bitmap_in_front_of_the_table_matches_reference(key_dtype, domain):
    """The table with its bitmap behind it, probed as the kernel probes it:
    the bit first, the slot only where the bit is set."""
    rng = np.random.default_rng(domain + 7)
    lo = 25
    bkey = (rng.permutation(domain + 6)[:max(1, domain // 2)] + lo - 3)
    bmask = rng.random(len(bkey)) < 0.8
    pkey = rng.integers(lo - 10, lo + domain + 10, 4000)
    pmask = rng.random(len(pkey)) < 0.8
    bkey, pkey = bkey.astype(key_dtype), pkey.astype(key_dtype)
    table, dup = JJ.direct_build(_j(bkey), _j(bmask), lo, domain)
    assert not bool(dup)
    slots = _t(np.asarray(table))
    words = TB.presence_words(slots >= 0)
    buf = torch.cat([slots, words])       # the kernel's one buffer
    assert buf.shape[0] == domain + TC.bitmap_words(domain)
    assert torch.equal(TJ.direct_table(buf, domain), slots)
    idx = _t(pkey).to(torch.int64) - lo
    live = _t(pmask) & (idx >= 0) & (idx < domain)
    safe = idx.clamp(0, domain - 1)
    hit = live & _bit_test(buf[domain:], safe)
    b = torch.where(hit, buf[safe], torch.full_like(buf[safe], -1))
    hit = b >= 0
    want_b, want_m = JJ.direct_probe(table, _j(pkey), _j(pmask), lo, domain)
    np.testing.assert_array_equal(b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(want_m))


@pytest.mark.parametrize("domain, route", [
    (1, TC.DIRECT_TABLE), (2_000_000, TC.DIRECT_TABLE),
    (TC.DIRECT_BITMAP_SLOTS, TC.DIRECT_TABLE),
    (TC.DIRECT_BITMAP_SLOTS + 1, TC.DIRECT_TABLE_BITS),
    (60_000_000, TC.DIRECT_TABLE_BITS), (1 << 27, TC.DIRECT_TABLE_BITS)])
def test_direct_route(domain, route):
    """A table in the L2 is read directly; a larger one gets the bitmap,
    which stays in the L2 up to the join's domain limit (2^27 slots: 16.8
    MB)."""
    assert TC.direct_route(domain) == route
    assert 4 * TC.bitmap_words(1 << 27) < 50e6 / 2


def test_direct_table_on_cpu_is_the_plain_table():
    bkey, bmask, pkey, pmask, lo = _direct_inputs(500, seed=3)
    key, alive = _t(bkey), _t(bmask)
    table, _ = TJ.direct_build(key, alive, lo, 500)
    assert table.shape == (500,)
    assert torch.equal(TJ.direct_table(table, 500), table)


# ---------------------------------------------------------------------
# K7: the fence
# ---------------------------------------------------------------------

def fence_model(sorted_key, order):
    """The padded keys and rows and each fence level (padded to a whole
    node of 4), as the pack kernel writes them."""
    nb = len(sorted_key)
    sizes = TC.fence_layout(nb)
    pad = TC.fence_keys(nb)
    keys = np.full(pad, DEAD, np.int64)
    keys[:nb] = sorted_key
    rows = np.full(pad, -1, np.int64)
    rows[:nb] = order
    levels, stride = [], TC.FENCE_LEAF_KEYS
    for s in sizes:
        level = np.full(-(-s // TC.FENCE_FANOUT) * TC.FENCE_FANOUT, DEAD,
                        np.int64)
        level[:s] = keys[:nb:stride]
        levels.append(level)
        stride *= TC.FENCE_FANOUT
    words = pad + -(-pad // 8) * 4 + sum(len(level) for level in levels)
    assert words == TC.fence_scratch_words(nb)
    return keys, rows, levels, sizes


def fence_lower_bound(model, k):
    """The kernel's search: count the top level's keys below k, then, level
    by level, the keys below k in node c - 1 of the level beneath (one
    sector of 4 keys), then in leaf c - 1 of the keys."""
    keys, _rows, levels, sizes = model
    top = levels[-1][:sizes[-1]]
    c = np.searchsorted(top, k, side="left")
    for level in reversed(levels[:-1]):
        base = np.maximum(c - 1, 0) * TC.FENCE_FANOUT
        node = level[base[:, None] + np.arange(TC.FENCE_FANOUT)]
        c = np.where(c == 0, 0, base + (node < k[:, None]).sum(1))
    base = np.maximum(c - 1, 0) * TC.FENCE_LEAF_KEYS
    leaf = keys[base[:, None] + np.arange(TC.FENCE_LEAF_KEYS)]
    return np.where(c == 0, 0, base + (leaf < k[:, None]).sum(1))


def expand_model(sorted_key, order, probe, alive, k):
    """K7's probe: the lower bound, a walk of five keys (K <= 4: the
    kernel's window) or K + 1, and the search for key + 1 where all of
    them are in the run."""
    nb = len(sorted_key)
    model = fence_model(sorted_key, order)
    keys, rows = model[0], model[1]
    live = alive & (probe != DEAD)
    key = np.where(live, probe, 0)
    lb = fence_lower_bound(model, key)
    walk = 5 if k <= 4 else k + 1
    pos = lb[:, None] + np.arange(walk)
    same = (pos < nb) & (keys[np.minimum(pos, len(keys) - 1)]
                         == key[:, None])
    count = np.cumprod(same, axis=1).sum(1)
    full = count == walk
    if full.any():
        count[full] = fence_lower_bound(model, key[full] + 1) - lb[full]
    count = np.where(live, count, 0)
    slot = np.arange(k)[None, :] < count[:, None]
    out = np.where(slot, rows[np.minimum(lb[:, None] + np.arange(k),
                                         len(rows) - 1)], -1)
    return out.reshape(-1).astype(np.int32), count.astype(np.int32)


def _fence_inputs(n_build, seed):
    """Sorted-build inputs whose runs are 1-20 rows long (so that runs
    cross leaves and fence lines), ~10% dead; probe keys on every run and
    between them, below the first and above the last key, and INT64_MAX."""
    rng = np.random.default_rng(seed)
    runs = rng.integers(1, 21, n_build)
    ends = np.cumsum(runs)
    m = int(np.searchsorted(ends, n_build)) + 1
    runs = runs[:m]
    runs[-1] -= ends[m - 1] - n_build
    base = np.cumsum(rng.integers(2, 5, len(runs))) * 1_000_003
    bkey = rng.permutation(np.repeat(base, runs))
    bmask = rng.random(n_build) < 0.9
    pkey = np.concatenate([
        rng.choice(base, 3000), rng.choice(base, 1000) + 1,
        [base[0] - 1, base[-1] + 1, DEAD, int(base[0]), int(base[-1])]])
    pmask = rng.random(len(pkey)) < 0.85
    pmask[-5:] = True
    return bkey.astype(np.int64), bmask, pkey.astype(np.int64), pmask


def test_fence_layout():
    assert TC.fence_layout(1) == [1]
    assert TC.fence_layout(4 * 8192) == [8192]
    assert TC.fence_layout(4 * 8192 + 1) == [8193, 2049]
    assert TC.fence_layout(8_000_000) == [2_000_000, 500_000, 125_000,
                                          31_250, 7_813]
    assert TC.fence_keys(8) == 16 and TC.fence_keys(9) == 20
    for n in (1, 9, 32_769, 600_000, 2 ** 31 - 1):
        sizes = TC.fence_layout(n)
        assert sizes[-1] <= TC.FENCE_TOP_KEYS and len(sizes) <= 16
        assert all(b == -(-a // TC.FENCE_FANOUT)
                   for a, b in zip(sizes, sizes[1:]))


@pytest.mark.parametrize("k", (1, 2, 4, 16))
@pytest.mark.parametrize("n_build", (1, 3, 4, 5, 9, 200, 32_769, 140_000))
def test_fence_model_matches_reference(n_build, k):
    bkey, bmask, pkey, pmask = _fence_inputs(n_build, seed=n_build + k)
    sorted_key, order = JJ.sorted_build(_j(bkey), _j(bmask))
    sorted_key, order = np.asarray(sorted_key), np.asarray(order)
    rows, counts = expand_model(sorted_key, order, pkey, pmask, k)
    # the reference counts an INT64_MAX probe key into the dead build rows'
    # run; the port counts it 0 (ops/join.py expand_probe_plain)
    real = pkey != DEAD
    want_rows, want_counts = JJ.expand_probe(
        _j(sorted_key), _j(order), _j(pkey[real]), _j(pmask[real]), k)
    np.testing.assert_array_equal(rows.reshape(-1, k)[real],
                                  np.asarray(want_rows).reshape(-1, k))
    np.testing.assert_array_equal(counts[real], np.asarray(want_counts))
    plain = TJ.expand_probe_plain(_t(sorted_key), _t(order), _t(pkey),
                                  _t(pmask), k)
    np.testing.assert_array_equal(rows, plain[0].numpy())
    np.testing.assert_array_equal(counts, plain[1].numpy())
    assert counts[-3] == 0 and counts[-5:-3].tolist() == [0, 0]
    if n_build >= 200:
        assert (counts > 0).sum() > 1000
    if n_build >= 32_769:
        assert (counts > k).any()
