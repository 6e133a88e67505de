"""The port's aggregates against quickstep_tpu.ops.groupby.

The plain torch versions (the CPU path of scalar_agg, dense_groupby,
sort_groupby, sort_groupby_compact and the stable partition) are
held against the JAX functions on the same seeded inputs: integers exactly,
float64 within rel 1e-12, float32 within rel 1e-5. MIN/MAX over no rows have
no JAX value (a reduction with no identity raises there); the port returns
the reference's sentinels, which the test states directly. The CUDA kernels
are held against these plain versions in test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickstep_tpu.ops import groupby as JG
from quickstep_tpu_torch.ops import groupby as TG
from quickstep_tpu_torch.ops.kernels import max_sentinel, min_sentinel

FNS = ("sum", "count", "min", "max", "avg")
DTYPES = (np.int32, np.int64, np.float32, np.float64)
MODES = ("no_nulls", "nulls", "all_dead", "empty")
N = 1000


def _inputs(dtype, mode, seed=7):
    rng = np.random.default_rng(seed)
    n = 0 if mode == "empty" else N
    if np.issubdtype(dtype, np.floating):
        vals = (rng.normal(0, 1000, n) + 3000).astype(dtype)
    else:
        vals = rng.integers(-10**6, 10**6, n).astype(dtype)
    alive = rng.random(n) < (0.0 if mode == "all_dead" else 0.6)
    valid = rng.random(n) < 0.7 if mode == "nulls" else None
    return vals, valid, alive


def _tol(dtype):
    return {np.dtype(np.float32): 1e-5, np.dtype(np.float64): 1e-12}.get(
        np.dtype(dtype), 0.0)


def _check(got: torch.Tensor, want, rtol):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    if rtol:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _sentinel(fn, dtype):
    return max_sentinel(_t(np.zeros(0, dtype)).dtype) if fn == "min" \
        else min_sentinel(_t(np.zeros(0, dtype)).dtype)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("fn", FNS)
def test_scalar_agg_matches_reference(fn, dtype, mode):
    vals, valid, alive = _inputs(dtype, mode)
    got, got_n = TG.scalar_agg(fn, _t(vals), _t(valid), _t(alive))
    if mode == "empty" and fn in ("min", "max"):
        assert got.item() == _sentinel(fn, dtype) and got_n.item() == 0
        return
    want, want_n = JG.scalar_agg(fn, _j(vals), _j(valid), _j(alive))
    rtol = _tol(dtype) if fn in ("sum", "avg") else 0.0
    if fn == "avg":
        rtol = max(rtol, 1e-12)
    _check(got, want, rtol)
    _check(got_n, want_n, 0.0)


@pytest.mark.parametrize("domain", (1, 6, 128))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_dense_groupby_matches_reference(dtype, mode, domain):
    vals, valid, alive = _inputs(dtype, mode)
    rng = np.random.default_rng(11)
    n = len(vals)
    # keys laid out like runner._dense_layout, some of them out of range;
    # domain 6 is two keys (3 x 2, as Q1's returnflag x linestatus)
    if domain == 6:
        keys = [rng.integers(-1, 4, n).astype(np.int32),
                rng.integers(3, 6, n).astype(np.int64)]
        offs, strs = [0, 3], [2, 1]
    else:
        keys = [rng.integers(-1, domain + 1, n).astype(np.int32)]
        offs, strs = [0], [1]
    specs = [(fn, vals, valid) for fn in FNS]

    j_idx = JG.pack_dense_index([_j(k) for k in keys], offs, strs, domain,
                                _j(alive))
    t_idx = TG.pack_dense_index([_t(k) for k in keys], offs, strs, domain,
                                _t(alive))
    _check(t_idx, j_idx, 0.0)

    t_occ, t_res = TG.dense_groupby(
        t_idx, domain, [(fn, _t(v), _t(vv)) for fn, v, vv in specs], _t(alive))
    if mode == "empty":
        j_specs = [s for s in specs if s[0] not in ("min", "max")]
    else:
        j_specs = specs
    j_occ, j_res = JG.dense_groupby(
        j_idx, domain, [(fn, _j(v), _j(vv)) for fn, v, vv in j_specs], _j(alive))
    _check(t_occ, j_occ, 0.0)
    j_by_fn = dict(zip([s[0] for s in j_specs], j_res))
    for (fn, _v, _vv), (data, nn) in zip(specs, t_res):
        if fn not in j_by_fn:
            assert torch.all(data == _sentinel(fn, dtype))
            assert torch.all(nn == 0)
            continue
        want_d, want_nn = j_by_fn[fn]
        rtol = _tol(dtype) if fn == "sum" else (
            max(_tol(dtype), 1e-12) if fn == "avg" else 0.0)
        _check(data, want_d, rtol)
        _check(nn, want_nn, 0.0)


@pytest.mark.parametrize("kind", ("scalar", "dense"))
@pytest.mark.parametrize("dtype", (np.float32, np.float64),
                         ids=lambda d: np.dtype(d).name)
def test_nan_wins_min_max_like_reference(dtype, kind):
    """A live NaN makes MIN and MAX NaN, in its group only; a dead or NULL
    NaN is skipped. SUM and AVG carry it too."""
    vals, valid, alive = _inputs(dtype, "nulls")
    rng = np.random.default_rng(13)
    keys = rng.integers(0, 6, len(vals)).astype(np.int64)
    vals[(keys == 2) & (np.arange(len(vals)) % 50 == 0)] = np.nan
    vals[(keys == 4) & ~alive] = np.nan
    fns = ("min", "max", "sum", "avg")
    if kind == "scalar":
        got = [TG.scalar_agg(fn, _t(vals), _t(valid), _t(alive))[0]
               for fn in fns]
        want = [JG.scalar_agg(fn, _j(vals), _j(valid), _j(alive))[0]
                for fn in fns]
    else:
        specs = [(fn, vals, valid) for fn in fns]
        t_idx = TG.pack_dense_index([_t(keys)], [0], [1], 6, _t(alive))
        j_idx = JG.pack_dense_index([_j(keys)], [0], [1], 6, _j(alive))
        got = [d for d, _nn in TG.dense_groupby(
            t_idx, 6, [(fn, _t(v), _t(vv)) for fn, v, vv in specs],
            _t(alive))[1]]
        want = [d for d, _nn in JG.dense_groupby(
            j_idx, 6, [(fn, _j(v), _j(vv)) for fn, v, vv in specs],
            _j(alive))[1]]
        assert np.isnan(np.asarray(want[0])[2])
        assert not np.isnan(np.asarray(want[0])[4])
    for fn, g, w in zip(fns, got, want):
        w = np.asarray(w)
        assert np.isnan(w).any(), fn
        assert g.numpy().dtype == w.dtype
        np.testing.assert_allclose(g.numpy(), w, rtol=max(_tol(dtype), 1e-12),
                                   atol=0, equal_nan=True)


# ---------------------------------------------------------------------
# sort group-by
# ---------------------------------------------------------------------

def _sort_tols(fn, dtype, vals, live):
    """(rtol, atol) of the port against the reference. The reference takes a
    float group's SUM as a difference of two prefix sums in the value's own
    dtype, the port sums each group directly in float64: they may differ by
    a few ulps of the largest prefix sum, so float sums and averages are
    held to atol 8 eps(dtype) x sum(|live values|). Counts, integer sums and
    MIN/MAX are exact; an integer AVG divides once, rel 1e-12."""
    if fn not in ("sum", "avg"):
        return 0.0, 0.0
    if not np.issubdtype(dtype, np.floating):
        return (1e-12 if fn == "avg" else 0.0), 0.0
    scale = float(np.abs(vals[live].astype(np.float64)).sum())
    return 0.0, 8 * float(np.finfo(dtype).eps) * scale


def _group_keys(n, seed=17):
    rng = np.random.default_rng(seed)
    k1 = rng.integers(0, 40, n).astype(np.int32)
    k2 = rng.integers(-3, 4, n).astype(np.int64)
    k2_valid = rng.random(n) < 0.85
    return k1, k2, k2_valid


@pytest.mark.parametrize("layout", ("packed", "multikey", "subset"))
@pytest.mark.parametrize("mode", ("no_nulls", "nulls", "all_dead", "empty"))
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_sort_groupby_matches_reference(dtype, mode, layout):
    """Every fn over packed keys (as runner._pack_sort_key makes them),
    unpacked multi-keys with a nullable key, and a sort subset (a key
    functionally determined by the others rides along unsorted); the
    representative rows (want_rows) too. Compared at the occupied rows."""
    vals, valid, alive = _inputs(dtype, mode)
    n = len(vals)
    k1, k2, k2_valid = _group_keys(n)
    keys = [k1, k2]
    kvalids = [None, k2_valid]
    packed, subset = None, None
    if layout == "packed":
        enc = np.where(k2_valid, k2 + 3, 7)
        packed = k1.astype(np.int64) * 8 + enc
    elif layout == "subset":
        keys = [k1, k2, (k1 * 3).astype(np.int32)]
        kvalids = [None, k2_valid, None]
        subset = [0, 1]
    specs = [(fn, vals, valid) for fn in FNS]
    j_specs = [s for s in specs if not (mode == "empty" and
                                        s[0] in ("min", "max"))]
    got = TG.sort_groupby([_t(k) for k in keys], [_t(v) for v in kvalids],
                          [(f, _t(v), _t(vv)) for f, v, vv in specs],
                          _t(alive), _t(packed), subset, want_rows=True)
    want = JG.sort_groupby([_j(k) for k in keys], [_j(v) for v in kvalids],
                           [(f, _j(v), _j(vv)) for f, v, vv in j_specs],
                           _j(alive), _j(packed), subset, want_rows=True)
    occ = np.asarray(want[2])
    _check(got[2], occ, 0.0)
    assert int(got[3]) == int(want[3])
    if mode in ("no_nulls", "nulls"):
        assert occ.sum() > 20
    np.testing.assert_array_equal(got[5].numpy()[occ], np.asarray(want[5])[occ])
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g.numpy()[occ], np.asarray(w)[occ])
    for g, w in zip(got[1], want[1]):
        assert (g is None) == (w is None)
        if w is not None:
            np.testing.assert_array_equal(g.numpy()[occ], np.asarray(w)[occ])
    j_by_fn = dict(zip([s[0] for s in j_specs], want[4]))
    for (fn, _v, _vv), (data, nn) in zip(specs, got[4]):
        if fn not in j_by_fn:
            continue
        want_d, want_nn = (np.asarray(a)[occ] for a in j_by_fn[fn])
        got_d = data.numpy()[occ]
        if fn == "sum" and dtype == np.int32:
            # the reference's segment sums keep int32 (the runner widens
            # integer sums to int64 before either sees them); the port's
            # are int64, as its scalar and dense sums are
            assert got_d.dtype == np.int64
        else:
            assert got_d.dtype == want_d.dtype, (fn, got_d.dtype,
                                                 want_d.dtype)
        rtol, atol = _sort_tols(fn, dtype, vals,
                                alive & (True if valid is None else valid))
        if rtol or atol:
            np.testing.assert_allclose(got_d, want_d, rtol=rtol, atol=atol)
        else:
            np.testing.assert_array_equal(got_d, want_d)
        np.testing.assert_array_equal(nn.numpy()[occ], want_nn)
        # outside the occupied rows the port writes 0
        assert not data.numpy()[~occ].any() and not nn.numpy()[~occ].any()


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_sort_groupby_plain_matches_exact_group_sums(dtype):
    """The port's per-group sums against exact float64/int64 sums computed
    with numpy per group: the port sums each group directly, so here the
    tolerance is the float32 output rounding (rel 1e-6) or rel 1e-12."""
    vals, valid, alive = _inputs(dtype, "nulls")
    k1, _k2, _ = _group_keys(len(vals))
    (keys,), _, occ, _, [(data, nn)] = TG.sort_groupby(
        [_t(k1)], [None], [("sum", _t(vals), _t(valid))], _t(alive),
        packed_key=_t(k1))
    occ = occ.numpy()
    live = alive & valid
    acc = np.float64 if np.issubdtype(dtype, np.floating) else np.int64
    for g, s, c in zip(keys.numpy()[occ], data.numpy()[occ], nn.numpy()[occ]):
        m = live & (k1 == g)
        assert c == m.sum()
        np.testing.assert_allclose(s, vals[m].astype(acc).sum(),
                                   rtol=1e-6 if dtype == np.float32 else 1e-12)


# ---------------------------------------------------------------------
# compacted sort group-by (the DISTINCT aggregate's building block)
# ---------------------------------------------------------------------

@pytest.mark.parametrize("live", (0.0, 0.01, 0.5, 1.0))
def test_stable_partition_matches_reference_compact_order(live):
    from quickstep_tpu.ops import kernels as JK
    from quickstep_tpu_torch.ops import kernels as TK
    mask = np.random.default_rng(19).random(3001) < live
    got = TK.stable_partition(_t(mask))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JK.compact_order(_j(mask))))
    _check(got, TK.compact_order(_t(mask)), 0.0)


@pytest.mark.parametrize("layout", ("packed", "multikey"))
@pytest.mark.parametrize("mode", ("no_nulls", "nulls", "all_dead", "empty"))
@pytest.mark.parametrize("dtype", (np.int64, np.float64),
                         ids=lambda d: np.dtype(d).name)
def test_sort_groupby_compact_matches_reference(dtype, mode, layout):
    """Rows [0, n_groups) hold the groups in key order: keys, key validity
    and every aggregate against the reference's, with _sort_tols'
    tolerances."""
    vals, valid, alive = _inputs(dtype, mode)
    k1, k2, k2_valid = _group_keys(len(vals))
    packed = None
    if layout == "packed":
        packed = k1.astype(np.int64) * 8 + np.where(k2_valid, k2 + 3, 7)
    specs = [(fn, vals, valid) for fn in FNS
             if not (mode == "empty" and fn in ("min", "max"))]
    got = TG.sort_groupby_compact(
        [_t(k1), _t(k2)], [None, _t(k2_valid)],
        [(f, _t(v), _t(vv)) for f, v, vv in specs], _t(alive), _t(packed))
    want = JG.sort_groupby_compact(
        [_j(k1), _j(k2)], [None, _j(k2_valid)],
        [(f, _j(v), _j(vv)) for f, v, vv in specs], _j(alive), _j(packed))
    n = int(want[2])
    assert int(got[2]) == n
    if mode in ("no_nulls", "nulls"):
        assert n > 20
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g.numpy()[:n], np.asarray(w)[:n])
    assert got[1][0] is None and want[1][0] is None
    np.testing.assert_array_equal(got[1][1].numpy()[:n],
                                  np.asarray(want[1][1])[:n])
    live = alive & (True if valid is None else valid)
    for (fn, _v, _vv), (gd, gn), (wd, wn) in zip(specs, got[3], want[3]):
        np.testing.assert_array_equal(gn.numpy()[:n], np.asarray(wn)[:n])
        rtol, atol = _sort_tols(fn, dtype, vals, live)
        np.testing.assert_allclose(gd.numpy()[:n], np.asarray(wd)[:n],
                                   rtol=rtol, atol=atol)
    plain = TG.sort_groupby_compact_plain(
        [_t(k1), _t(k2)], [None, _t(k2_valid)],
        [(f, _t(v), _t(vv)) for f, v, vv in specs], _t(alive), _t(packed))
    for g, p in zip(got[0] + [got[2]] + [t for r in got[3] for t in r],
                    plain[0] + [plain[2]] + [t for r in plain[3] for t in r]):
        _check(g, p.numpy(), 0.0)
