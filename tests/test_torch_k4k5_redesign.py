"""K4's fence search and K5's tiled segmented reduce, as numpy models of the
kernels' data flow, against the JAX package on the same numpy-seeded
inputs.

K4 (csrc/join_kernels.cu unique_probe_kernel): the fence that ops/cuda.py
fence_layout sizes (K7's), searched as the kernel searches it: a branchless
lower bound over the top level, then one sector of 4 keys a level and the
leaf, carrying the first key >= the probe key down from the level above
where a sector holds none; a hit reads the row there. The dup flag comes
from adjacent sorted keys, as the pack launch sets it. (row, matched, dup)
equal quickstep_tpu's merge_unique_probe and the port's plain version bit
for bit.

K5 (csrc/agg_kernels.cu segment_tile_kernel, segment_carry_kernel): tiles
of items x threads sorted rows, each thread's rows folded in order, the
block's exclusive scan as seg_device.cuh runs it (Hillis-Steele within
warps of 32 lanes, then over the warp totals), results at each group's
last row, one carry a tile, and the carries scanned by a block of 1024
threads that completes the rows where a group open at a tile's start ends.
At the kernel's tile (cuda.SEGMENT_TILE) and at a tile of 8 rows, so that
groups straddle many tiles. Integers, counts and MIN/MAX exactly; float
sums within 8 eps(dtype) x the sum of the live magnitudes (the rule of
tests/test_torch_groupby.py _sort_tols: the reference takes a float group's
SUM as a difference of prefix sums in the value's own dtype) plus (m - 1)
eps(float64) x a group's sum of magnitudes for a group of m live rows (the
bound on two orders of float64 addition; it matters only for one group of
tens of thousands of rows): _float_atol.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickstep_tpu.ops import groupby as JG
from quickstep_tpu.ops import join as JJ
from quickstep_tpu_torch.ops import cuda as TC
from quickstep_tpu_torch.ops import groupby as TG
from quickstep_tpu_torch.ops import join as TJ

DEAD = np.iinfo(np.int64).max
FNS = ("sum", "count", "min", "max")
DTYPES = (np.int32, np.int64, np.float32, np.float64)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# ---------------------------------------------------------------------
# K4: the fence search
# ---------------------------------------------------------------------

def fence_model(sorted_key, order):
    """The padded keys and rows and each fence level (padded to a whole
    node), as the pack launch writes them."""
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
    return keys, rows, levels, sizes


def _fence_step(level, c, nxt, k):
    """One sector of 4 keys: the count below k, and the first key >= k,
    kept from the level above where the sector holds none."""
    base = np.maximum(c - 1, 0) * TC.FENCE_FANOUT
    node = level[base[:, None] + np.arange(TC.FENCE_FANOUT)]
    below = (node < k[:, None]).sum(1)
    first = node[np.arange(len(k)), np.minimum(below, TC.FENCE_FANOUT - 1)]
    return base + below, np.where(below < TC.FENCE_FANOUT, first, nxt)


def unique_model(sorted_key, order, probe, pmask):
    """K4's two launches: the dup flag; for each probe row the lower bound
    by the fence and the key found there, then the row on a hit."""
    keys, rows, levels, sizes = fence_model(sorted_key, order)
    live_sorted = sorted_key != DEAD
    dup = bool(np.any((sorted_key[1:] == sorted_key[:-1]) & live_sorted[1:]))
    top = levels[-1][:sizes[-1]]
    k = probe
    c = np.zeros(len(k), np.int64)
    length = len(top)
    while length > 1:              # the same steps for every probe row
        half = length // 2
        c = np.where(top[c + half] < k, c + half, c)
        length -= half
    c = c + (top[c] < k)
    nxt = np.where(c < len(top), top[np.minimum(c, len(top) - 1)], DEAD)
    for level in list(reversed(levels[:-1])) + [keys]:
        c, nxt = _fence_step(level, c, nxt, k)
    hit = pmask & (probe != DEAD) & (nxt == k)
    bidx = np.where(hit, rows[np.minimum(c, len(rows) - 1)], -1)
    return bidx.astype(np.int32), hit, dup, c, nxt


def _unique_inputs(n_build, seed, dups):
    """Build keys spread over 2^40, ~15 % dead, in random row order; with
    dups, runs of two and three equal keys (dead rows among them); probe
    keys on the build keys, between them, below the first, above the last,
    and INT64_MAX; ~15 % of probe rows dead."""
    rng = np.random.default_rng(seed)
    base = np.cumsum(rng.integers(1, 6, n_build)) * 1_000_003
    if dups and n_build > 1:
        at = rng.choice(n_build - 1, max(1, n_build // 50), replace=False)
        base[at + 1] = base[at]
        base[-1] = base[0]
    bkey = rng.permutation(base)
    bmask = rng.random(n_build) < 0.85
    pkey = np.concatenate([
        rng.choice(base, 3000), rng.choice(base, 500) + 1,
        [base.min() - 1, base.max() + 1, DEAD, base.min(), base.max()]])
    pmask = rng.random(len(pkey)) < 0.85
    pmask[-5:] = True
    return bkey.astype(np.int64), bmask, pkey.astype(np.int64), pmask


@pytest.mark.parametrize("dups", (False, True), ids=("unique", "dups"))
@pytest.mark.parametrize("n_build", (1, 5, 200, 32_769, 140_000))
def test_fence_search_model_matches_reference(n_build, dups):
    bkey, bmask, pkey, pmask = _unique_inputs(n_build, n_build + dups, dups)
    sorted_key, order = (np.asarray(a) for a in
                         JJ.sorted_build(_j(bkey), _j(bmask)))
    bidx, hit, dup, lb, at = unique_model(sorted_key, order, pkey, pmask)
    # the lower bound is exact, and the key carried down is the key there
    live = pmask & (pkey != DEAD)
    np.testing.assert_array_equal(
        lb[live], np.searchsorted(sorted_key, pkey[live], side="left"))
    padded = np.append(sorted_key, DEAD)
    np.testing.assert_array_equal(at[live], padded[lb[live]])
    # the reference counts an INT64_MAX probe key into the dead build rows'
    # run; the port matches it with nothing (ops/join.py)
    real = pkey != DEAD
    want = JJ.merge_unique_probe(_j(bkey), _j(bmask), _j(pkey[real]),
                                 _j(pmask[real]))
    np.testing.assert_array_equal(bidx[real], np.asarray(want[0]))
    np.testing.assert_array_equal(hit[real], np.asarray(want[1]))
    assert dup == bool(want[2])
    plain = TJ.merge_unique_probe_plain(_t(bkey), _t(bmask), _t(pkey),
                                        _t(pmask))
    np.testing.assert_array_equal(bidx, plain[0].numpy())
    np.testing.assert_array_equal(hit, plain[1].numpy())
    assert dup == bool(plain[2])
    assert not hit[-3]
    if n_build >= 200:
        assert hit.sum() > 1000 and dup == dups
    if n_build > 1:
        assert hit[-2:].any()


def test_fence_levels_at_sf10_shapes():
    """Q5's 100 K keys: a top level of 6,250 keys in shared memory and one
    level under it (two sectors and a row a hit); Q9's 8 M: five levels."""
    assert TC.fence_layout(100_000) == [25_000, 6_250]
    assert len(TC.fence_layout(8_000_000)) == 5
    assert TC.UNIQUE_PROBE_BLOCKS_PER_SM * TC.FENCE_TOP_KEYS * 8 <= 227 * 1024


# ---------------------------------------------------------------------
# K5: the tiled segmented reduce
# ---------------------------------------------------------------------

def _acc(fn, dtype):
    if fn == "count":
        return np.int64
    if fn == "sum":
        return np.float64 if np.issubdtype(dtype, np.floating) else np.int64
    return dtype


def _identity(fn, dtype):
    if fn == "min":
        return np.inf if np.issubdtype(dtype, np.floating) else \
            np.iinfo(dtype).max
    if fn == "max":
        return -np.inf if np.issubdtype(dtype, np.floating) else \
            np.iinfo(dtype).min
    return 0


def _combine(fn, a, b):
    if fn == "min":
        return np.where((b < a) | np.isnan(b), b, a) if a.dtype.kind == "f" \
            else np.minimum(a, b)
    if fn == "max":
        return np.where((b > a) | np.isnan(b), b, a) if a.dtype.kind == "f" \
            else np.maximum(a, b)
    return a + b


def _seg_op(fn, a, b):
    """seg_device.cuh SegOp(earlier, later) on (flag, value, count)."""
    af, av, ac = a
    bf, bv, bc = b
    return (af | bf, np.where(bf, bv, _combine(fn, av, bv)),
            np.where(bf, bc, ac + bc))


def _shift(seg, d, ident):
    """Each lane's element from d lanes before it (the identity before
    lane d), along the last axis."""
    out = []
    for a, fill in zip(seg, ident):
        pad = np.full(a.shape[:-1] + (d,), fill, a.dtype)
        out.append(np.concatenate([pad, a[..., :-d]], axis=-1))
    return tuple(out)


def _hillis_steele(fn, seg, ident):
    """Inclusive scan along the last axis, as __shfl_up_sync rounds run it."""
    lanes = seg[0].shape[-1]
    d = 1
    while d < lanes:
        seg = _seg_op(fn, _shift(seg, d, ident), seg)
        d *= 2
    return seg


def block_exclusive_scan(fn, seg, ident):
    """seg_device.cuh block_exclusive_scan over the last axis (the block's
    threads): warps of 32 lanes, then the warp totals. Returns (the
    exclusive prefix of every thread, the block's total)."""
    nt = seg[0].shape[-1]
    lanes = min(32, nt)
    shp = seg[0].shape[:-1] + (nt // lanes, lanes)
    inc = _hillis_steele(fn, tuple(a.reshape(shp) for a in seg), ident)
    warp = _hillis_steele(fn, tuple(a[..., -1] for a in inc), ident)
    before = _shift(inc, 1, ident)
    prior = tuple(a[..., None] for a in _shift(warp, 1, ident))
    ex = _seg_op(fn, tuple(np.broadcast_to(p, b.shape)
                           for p, b in zip(prior, before)), before)
    return (tuple(a.reshape(seg[0].shape) for a in ex),
            tuple(w[..., -1] for w in warp))


def tile_model(fn, change, s_alive, perm, vals, valid, items=8,
               threads=TC.SEGMENT_TILE // 8, carry_threads=1024):
    """K5's two launches over tiles of items x threads rows. Returns
    (result, count) as cuda.segment_reduce does (for count, the count
    twice)."""
    n = len(s_alive)
    dtype = vals.dtype if vals is not None else np.int64
    acc = _acc(fn, dtype)
    tile = items * threads
    ntiles = -(-n // tile)
    size = ntiles * tile
    live = np.zeros(size, bool)
    live[:n] = s_alive
    head = np.ones(size, bool)
    head[:n] = change | ~s_alive
    p = np.where(live[:n], perm, 0)
    ok = live.copy()
    if valid is not None:
        ok[:n] &= valid[p]
    ident = _identity(fn, acc)
    x = np.full(size, ident, acc)
    if fn != "count":
        x[:n] = np.where(ok[:n], vals[p].astype(acc), ident)
    nxt_head = np.append(head[1:], True)
    shape = (ntiles, threads, items)
    rows = (head.reshape(shape), x.reshape(shape),
            ok.astype(np.int64).reshape(shape))
    zero = (np.zeros((ntiles, threads), bool),
            np.full((ntiles, threads), ident, acc),
            np.zeros((ntiles, threads), np.int64))
    s = zero
    for j in range(items):                 # a thread's rows, in order
        s = _seg_op(fn, s, tuple(r[..., j] for r in rows))
    cur, total = block_exclusive_scan(fn, s, (False, ident, 0))
    res = np.zeros(shape, acc)
    cnt = np.zeros(shape, np.int64)
    fix_at = np.full(ntiles, -1)
    fix_v = np.full(ntiles, ident, acc)
    fix_c = np.zeros(ntiles, np.int64)
    lv, nh = live.reshape(shape), nxt_head.reshape(shape)
    for j in range(items):
        cur = _seg_op(fn, cur, tuple(r[..., j] for r in rows))
        last = lv[..., j] & nh[..., j]
        res[..., j] = np.where(last, cur[1], 0)
        cnt[..., j] = np.where(last, cur[2], 0)
        t, th = np.nonzero(last & ~cur[0])
        fix_at[t] = th * items + j
        fix_v[t] = cur[1][t, th]
        fix_c[t] = cur[2][t, th]
    res, cnt = res.reshape(-1), cnt.reshape(-1)
    # the carry launch: per tiles a thread, then the block's scan
    per = -(-ntiles // carry_threads)
    pad = per * carry_threads - ntiles
    tiles = tuple(np.concatenate([a, np.full(pad, i, a.dtype)]).reshape(
        carry_threads, per) for a, i in zip(total, (False, ident, 0)))
    s = (np.zeros(carry_threads, bool), np.full(carry_threads, ident, acc),
         np.zeros(carry_threads, np.int64))
    for j in range(per):
        s = _seg_op(fn, s, tuple(a[:, j] for a in tiles))
    cur, _ = block_exclusive_scan(fn, s, (False, ident, 0))
    for j in range(per):
        t = np.arange(carry_threads) * per + j
        fix = (t < ntiles) & (fix_at[np.minimum(t, ntiles - 1)] >= 0)
        tt = t[fix]
        e = tt * tile + fix_at[tt]
        res[e] = _combine(fn, cur[1][fix], fix_v[tt])
        cnt[e] = cur[2][fix] + fix_c[tt]
        cur = _seg_op(fn, cur, tuple(a[:, j] for a in tiles))
    cnt = cnt[:n].astype(np.int32)
    if fn == "count":
        return cnt, cnt
    out_dt = np.int64 if fn == "sum" and acc == np.int64 else dtype
    return res[:n].astype(out_dt), cnt


def _group_sizes(shape, n, rng):
    """Group sizes and live rows of the skewed shapes over n rows."""
    if shape == "q9":                       # 175 groups, all rows live
        cuts = np.sort(rng.choice(np.arange(1, n), 174, replace=False))
        return np.diff(np.concatenate([[0], cuts, [n]])), n
    if shape == "one_group":
        return np.array([n]), n
    if shape == "tile_edges":               # every group ends on a tile edge
        return np.full(n // TC.SEGMENT_TILE, TC.SEGMENT_TILE), n
    if shape == "live_1":
        return np.array([1]), 1
    return np.array([], np.int64), 0        # live_0


SHAPES = ("q9", "one_group", "tile_edges", "live_1", "live_0")


def _shape_inputs(shape, dtype, nullable, seed=3, n=60_000):
    """Group keys, values, validity and the live mask over n rows in random
    row order: each group's rows (and the dead rows, ~10 % of all where
    there are live groups) scattered among the others."""
    rng = np.random.default_rng(seed)
    n = n // TC.SEGMENT_TILE * TC.SEGMENT_TILE if shape == "tile_edges" \
        else n
    sizes, n_live = _group_sizes(shape, n, rng)
    key = np.full(n, 10**6, np.int64)
    key[:n_live] = np.repeat(rng.permutation(len(sizes)) * 7 + 3, sizes)
    alive = np.zeros(n, bool)
    alive[:n_live] = True
    if shape in ("q9", "one_group"):
        alive[:n_live] = rng.random(n_live) < 0.9
    order = rng.permutation(n)
    key, alive = key[order], alive[order]
    if np.issubdtype(dtype, np.floating):
        vals = (rng.normal(0, 1000, n) + 3000).astype(dtype)
    else:
        vals = rng.integers(-10**6, 10**6, n).astype(dtype)
    valid = rng.random(n) < 0.7 if nullable else None
    return key, vals, valid, alive


def _sorted_rows(key, alive):
    """change, s_alive, perm and last of ops/groupby.py's packed-key sort."""
    k = np.where(alive, key, DEAD)
    perm = np.argsort(k, kind="stable")
    s_key = k[perm]
    s_alive = s_key != DEAD
    change = s_alive & np.append(True, s_key[1:] != s_key[:-1])
    last = s_alive & np.append(change[1:] | ~s_alive[1:], True)
    return change, s_alive, perm, last


def _float_atol(dtype, vals, live, group_mag, group_rows):
    """The tolerance of a float SUM at a group's last row: 8 eps(dtype) x
    the sum of all live magnitudes (the reference's difference of prefix
    sums in the dtype: tests/test_torch_groupby.py _sort_tols), plus (m - 1)
    eps(float64) x the group's own sum of magnitudes for a group of m live
    rows: two orders of m float64 additions differ by at most that (Higham,
    Accuracy and Stability of Numerical Algorithms, 4.2), which matters only
    where one group holds tens of thousands of rows."""
    return 8 * float(np.finfo(dtype).eps) * float(
        np.abs(vals[live].astype(np.float64)).sum()) + \
        np.maximum(group_rows - 1, 0) * float(np.finfo(np.float64).eps) * \
        group_mag


def _group_mag(change, s_alive, last, perm, vals, valid):
    """Each group's sum of live magnitudes and live rows, at its last row."""
    mag, rows = TG._segment_reduce_plain(
        "sum", *[_t(a) for a in (change, s_alive, last, perm,
                                 np.abs(vals.astype(np.float64)), valid)])
    return mag.numpy(), rows.numpy()


def _check_close(fn, got, want, dtype, vals, live, mag=None):
    """Exactly, but float sums within _float_atol (mag: the group
    magnitudes and row counts at the compared rows)."""
    if fn == "sum" and np.issubdtype(dtype, np.floating):
        err = np.abs(got.astype(np.float64) - want.astype(np.float64))
        atol = _float_atol(dtype, vals, live, *mag)
        assert np.all(err <= atol), float(np.max(err - atol))
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tile", ("kernel", "8"))
@pytest.mark.parametrize("nullable", (False, True), ids=("dense", "nulls"))
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape", SHAPES)
def test_tile_model_matches_reference(shape, dtype, nullable, tile):
    key, vals, valid, alive = _shape_inputs(shape, dtype, nullable)
    change, s_alive, perm, last = _sorted_rows(key, alive)
    live = alive if valid is None else alive & valid
    geometry = {} if tile == "kernel" else {"items": 2, "threads": 4}
    want = JG.sort_groupby([_j(key)], [None],
                           [(fn, _j(vals), _j(valid)) for fn in FNS],
                           _j(alive), _j(key))
    occ = np.asarray(want[2])
    np.testing.assert_array_equal(occ, last)
    plain_args = [_t(a) for a in (change, s_alive, last, perm, vals, valid)]
    mag, rows = _group_mag(change, s_alive, last, perm, vals, valid)
    for fn, (jd, jn) in zip(FNS, want[4]):
        data, nn = tile_model(fn, change, s_alive, perm, vals, valid,
                              **geometry)
        np.testing.assert_array_equal(nn[occ], np.asarray(jn)[occ])
        assert not nn[~occ].any() and not data[~occ].any()
        _check_close(fn, data[occ], np.asarray(jd)[occ].astype(data.dtype),
                     dtype, vals, live, (mag[occ], rows[occ]))
        pd, pn = TG._segment_reduce_plain(fn, *plain_args)
        np.testing.assert_array_equal(nn, pn.numpy())
        assert data.dtype == pd.numpy().dtype
        _check_close(fn, data, pd.numpy(), dtype, vals, live, (mag, rows))


def test_tile_model_straddles_and_fixes_rows():
    """At a tile of 8 rows Q9's groups each cross many tiles and end inside
    a tile other than their first: the carry launch completes those rows;
    a group that ends on a tile's last row needs no fix."""
    key, vals, valid, alive = _shape_inputs("q9", np.int64, False)
    change, s_alive, perm, last = _sorted_rows(key, alive)
    data, nn = tile_model("count", change, s_alive, perm, vals, valid,
                          items=2, threads=4)
    ends = np.nonzero(last)[0]
    starts = np.nonzero(change)[0]
    assert ((ends // 8) > (starts // 8)).sum() > 150
    np.testing.assert_array_equal(nn[ends], ends - starts + 1)
    assert nn.sum() == s_alive.sum()


@pytest.mark.parametrize("nullable", (False, True), ids=("dense", "nulls"))
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape", SHAPES)
def test_sort_groupby_skewed_shapes_match_reference(shape, dtype, nullable):
    """The port's sort GROUP BY (its plain path on the CPU) against the
    reference at the skewed shapes: few large groups, one group, groups
    ending on tile edges, one live row, none."""
    key, vals, valid, alive = _shape_inputs(shape, dtype, nullable, seed=5)
    live = alive if valid is None else alive & valid
    change, s_alive, perm, last = _sorted_rows(key, alive)
    mag, rows = _group_mag(change, s_alive, last, perm, vals, valid)
    specs = [(fn, vals, valid) for fn in FNS]
    got = TG.sort_groupby([_t(key)], [None],
                          [(f, _t(v), _t(vv)) for f, v, vv in specs],
                          _t(alive), _t(key), want_rows=True)
    want = JG.sort_groupby([_j(key)], [None],
                           [(f, _j(v), _j(vv)) for f, v, vv in specs],
                           _j(alive), _j(key), want_rows=True)
    occ = np.asarray(want[2])
    np.testing.assert_array_equal(got[2].numpy(), occ)
    assert int(got[3]) == int(want[3])
    np.testing.assert_array_equal(got[5].numpy()[occ],
                                  np.asarray(want[5])[occ])
    np.testing.assert_array_equal(got[0][0].numpy()[occ],
                                  np.asarray(want[0][0])[occ])
    for fn, (data, nn), w in zip(FNS, got[4], want[4]):
        wd, wn = (np.asarray(a)[occ] for a in w)
        np.testing.assert_array_equal(nn.numpy()[occ], wn)
        _check_close(fn, data.numpy()[occ], wd.astype(data.numpy().dtype),
                     dtype, vals, live, (mag[occ], rows[occ]))
