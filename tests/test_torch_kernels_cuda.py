"""The CUDA kernels against their plain torch versions, and the checks their
wrappers make. This file imports neither jax nor quickstep_tpu, so it also
runs on a machine that has a card and no JAX:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

The `cuda`-marked tests skip where torch finds no card. Tolerances: integers
and bools exactly, float64 within rel 1e-12, float32 within rel 1e-5; the
window kernels' float prefix sums within 32 eps x the sum of the live
magnitudes (_prefix_atol), their sliding sums bit for bit; K5's float sums
at the SF10 shapes within (eps(dtype) + (m - 1) eps(float64)) x the sum of
a group's m live magnitudes (_float_sum_atol), and bit for bit where every
partial sum is exact.
"""

import numpy as np
import pytest
import torch

from quickstep_tpu_torch.ops import cuda as TC
from quickstep_tpu_torch.ops import groupby as TG

FNS = ("sum", "count", "min", "max", "avg")
DTYPES = (torch.int32, torch.int64, torch.float32, torch.float64)
MODES = ("no_nulls", "nulls", "all_dead", "empty")
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(dtype, mode, device, n=100_003, seed=5):
    rng = np.random.default_rng(seed)
    n = 0 if mode == "empty" else n
    if dtype.is_floating_point:
        vals = rng.normal(3000, 1000, n)
    else:
        vals = rng.integers(-10**6, 10**6, n)
    vals = torch.from_numpy(vals).to(dtype)
    alive = torch.from_numpy(rng.random(n) < (0.0 if mode == "all_dead"
                                              else 0.6))
    valid = torch.from_numpy(rng.random(n) < 0.7) if mode == "nulls" else None
    keys = torch.from_numpy(rng.integers(-1, 130, n))
    return [None if t is None else t.to(device)
            for t in (vals, valid, alive, keys)]


def _same(got, want, rtol):
    assert got.dtype == want.dtype and got.shape == want.shape
    if rtol and got.dtype.is_floating_point:
        torch.testing.assert_close(got.cpu(), want.cpu(), rtol=rtol, atol=0)
    else:
        assert torch.equal(got.cpu(), want.cpu()), (got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_scalar_kernel_matches_plain(card, dtype, mode):
    vals, valid, alive, _ = _inputs(dtype, mode, card)
    for fn in FNS:
        got = TG.scalar_agg(fn, vals, valid, alive)
        want = TG.scalar_agg_plain(fn, vals, valid, alive)
        for g, w in zip(got, want):
            _same(g, w, RTOL.get(dtype, 0.0) if fn in ("sum", "avg") else 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("domain", (1, 6, 128))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_dense_kernel_matches_plain(card, dtype, mode, domain):
    vals, valid, alive, keys = _inputs(dtype, mode, card)
    idx = TG.pack_dense_index([keys], [0], [1], domain, alive)
    specs = [(fn, vals, valid) for fn in FNS]
    got_occ, got = TG.dense_groupby(idx, domain, specs, alive)
    want_occ, want = TG.dense_groupby_plain(idx, domain, specs, alive)
    _same(got_occ, want_occ, 0.0)
    for fn, (gd, gn), (wd, wn) in zip(FNS, got, want):
        _same(gd, wd, RTOL.get(dtype, 0.0) if fn in ("sum", "avg") else 0.0)
        _same(gn, wn, 0.0)


# K2's one-pass form: key columns of each width packed in the kernel
DENSE_KEY_LAYOUTS = {
    "1 int8": ((torch.int8,), (6,)),
    "2 int32": ((torch.int32, torch.int32), (3, 2)),
    "3 int64 bool int32": ((torch.int64, torch.bool, torch.int32), (4, 2, 16)),
    "4 int8 int32 int64 bool": ((torch.int8, torch.int32, torch.int64,
                                 torch.bool), (2, 4, 2, 2)),
    "2 bool domain 1": ((torch.bool, torch.int16), (1, 1)),
}


def _dense_keys(dtypes, sizes, n, seed, device):
    """Key columns with values a little outside their ranges (negative
    ones too), their offsets and strides, and the domain."""
    rng = np.random.default_rng(seed)
    cols, offs = [], []
    for k, (dt, size) in enumerate(zip(dtypes, sizes)):
        off = 0 if dt == torch.bool else k - 2
        if dt == torch.bool:
            c = rng.random(n) < 0.7
        else:
            c = rng.integers(off - 2, off + size + 2, n)
        cols.append(torch.from_numpy(np.asarray(c)).to(dt).to(device))
        offs.append(off)
    strides, acc = [], 1
    for size in reversed(sizes):
        strides.append(acc)
        acc *= size
    return cols, offs, list(reversed(strides)), acc


def _dense_specs(n, device, seed, nan=False):
    """Every fn over every value dtype, NULLs in half of them, the same
    tensor in two aggregates, counts with and without validity: more
    accumulators than one launch takes."""
    specs = []
    for i, dt in enumerate(DTYPES):
        vals, valid, _, _ = _inputs(dt, "nulls", device, n=n, seed=seed + i)
        if nan and dt.is_floating_point:
            vals[::97] = float("nan")
        v = valid if i % 2 else None
        specs += [("sum", vals, v), ("avg", vals, v), ("min", vals, v),
                  ("max", vals, None), ("count", None, valid)]
    return specs + [("count", None, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("nan", (False, True), ids=("finite", "nan"))
@pytest.mark.parametrize("layout", sorted(DENSE_KEY_LAYOUTS))
def test_dense_aggregate_kernel_matches_plain(card, layout, nan):
    dtypes, sizes = DENSE_KEY_LAYOUTS[layout]
    n = 100_003
    keys, offs, strides, domain = _dense_keys(dtypes, sizes, n, 71, card)
    specs = _dense_specs(n, card, 73, nan)
    _, _, alive, _ = _inputs(torch.int64, "nulls", card, n=n, seed=79)
    TC.reset_launches()
    got_occ, got = TG.dense_aggregate(keys, offs, strides, domain, specs,
                                      alive)
    # 12 accumulators (SUM, MIN and MAX of each dtype; AVG shares its SUM)
    # take two launches of at most 8
    assert TC.LAUNCHES["dense_groupby"] == 2
    cpu = [t.cpu() if isinstance(t, torch.Tensor) else t
           for t in (*keys, alive)]
    want_occ, want = TG.dense_aggregate_plain(
        cpu[:len(keys)], offs, strides, domain,
        [(fn, None if v is None else v.cpu(), None if vv is None else vv.cpu())
         for fn, v, vv in specs], cpu[-1])
    _same(got_occ, want_occ, 0.0)
    for (fn, v, _), (gd, gn), (wd, wn) in zip(specs, got, want):
        dt = None if v is None else v.dtype
        rtol = RTOL.get(dt, 0.0) if fn in ("sum", "avg") else 0.0
        assert gd.dtype == wd.dtype
        torch.testing.assert_close(gd.cpu(), wd, rtol=rtol, atol=0,
                                   equal_nan=True)
        _same(gn, wn, 0.0)


@pytest.mark.cuda
def test_dense_aggregate_at_q1_shape(card):
    """Q1's dense GROUP BY (two int32 keys, domain 6, five int64 SUMs and
    COUNT(*)) in one launch, exactly the plain version."""
    from quickstep_tpu_torch.bench.kernel_ab import k2_inputs
    gen = torch.Generator(device=card)
    gen.manual_seed(83)
    keys, offs, strides, domain, specs, alive = k2_inputs(card, gen,
                                                          n=2_000_000)
    TC.reset_launches()
    got_occ, got = TG.dense_aggregate(keys, offs, strides, domain, specs,
                                      alive)
    assert TC.LAUNCHES["dense_groupby"] == 1
    want_occ, want = TG.dense_aggregate_plain(keys, offs, strides, domain,
                                              specs, alive)
    _same(got_occ, want_occ, 0.0)
    for (gd, gn), (wd, wn) in zip(got, want):
        _same(gd, wd, 0.0)
        _same(gn, wn, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("domain", (1, 6, 128))
@pytest.mark.parametrize("dtype", (torch.float32, torch.float64), ids=str)
def test_dense_float_sums_repeat_bit_for_bit(card, dtype, domain):
    """K2 folds lanes, warps and blocks in a fixed order: the same bits in
    two runs, within the float tolerance of the plain version."""
    vals, valid, alive, keys = _inputs(dtype, "nulls", card, n=1_000_003)
    specs = [("sum", vals, valid), ("avg", vals, None)]
    runs = [TG.dense_aggregate([keys], [0], [1], domain, specs, alive)
            for _ in range(2)]
    bits = torch.int32 if dtype == torch.float32 else torch.int64
    for (d1, _), (d2, _) in zip(runs[0][1], runs[1][1]):
        assert torch.equal(d1.view(torch.int64 if d1.dtype == torch.float64
                                   else bits),
                           d2.view(torch.int64 if d2.dtype == torch.float64
                                   else bits))
    want_occ, want = TG.dense_aggregate_plain([keys], [0], [1], domain,
                                              specs, alive)
    _same(runs[0][0], want_occ, 0.0)
    # the values' tolerance: AVG divides the float32 SUM, as the reference
    # does, where the plain version divides its float64 accumulator
    for (gd, gn), (wd, wn) in zip(runs[0][1], want):
        _same(gd, wd, RTOL[dtype])
        _same(gn, wn, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.float64), ids=str)
def test_kernels_let_nan_win_like_plain(card, dtype):
    """A live NaN makes MIN and MAX NaN, in its group only; a dead or NULL
    NaN is skipped. The kernels are held against the plain versions on the
    CPU, which test_torch_groupby holds against the reference's NaN."""
    vals, valid, alive, keys = _inputs(dtype, "nulls", "cpu")
    row = torch.arange(len(vals))
    vals[(keys == 2) & (row % 50 == 0)] = float("nan")
    vals[(keys == 4) & ~alive] = float("nan")
    idx = TG.pack_dense_index([keys], [0], [1], 6, alive)
    fns = ("min", "max", "sum", "avg")
    specs = [(fn, vals, valid) for fn in fns]
    want = [TG.scalar_agg_plain(fn, vals, valid, alive)[0] for fn in fns]
    want_occ, want_d = TG.dense_groupby_plain(idx, 6, specs, alive)
    c_vals, c_valid, c_alive, c_idx = (t.to(card)
                                       for t in (vals, valid, alive, idx))
    got = [TG.scalar_agg(fn, c_vals, c_valid, c_alive)[0] for fn in fns]
    got_occ, got_d = TG.dense_groupby(
        c_idx, 6, [(fn, c_vals, c_valid) for fn in fns], c_alive)
    assert torch.isnan(want_d[0][0][2]) and not torch.isnan(want_d[0][0][4])
    _same(got_occ, want_occ, 0.0)
    rtol = RTOL[dtype]
    for g, w in zip(got + [d for d, _ in got_d], want + [d for d, _ in want_d]):
        torch.testing.assert_close(g.cpu(), w, rtol=rtol, atol=0,
                                   equal_nan=True)
    for (_, gn), (_, wn) in zip(got_d, want_d):
        _same(gn, wn, 0.0)


@pytest.mark.cuda
def test_launches_are_counted(card):
    vals, valid, alive, keys = _inputs(torch.int64, "nulls", card)
    TC.reset_launches()
    TG.scalar_agg("sum", vals, valid, alive)
    idx = TG.pack_dense_index([keys], [0], [1], 6, alive)
    TG.dense_groupby(idx, 6, [("sum", vals, None), ("count", None, None)],
                     alive)
    TG.scalar_agg_plain("sum", vals, valid, alive)
    # K2 computes both aggregates of one dense GROUP BY in one launch
    assert TC.LAUNCHES == dict(dict.fromkeys(TC.LAUNCHES, 0), scalar_agg=1,
                               dense_groupby=1)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(card):
    vals, _valid, alive, _ = _inputs(torch.int64, "no_nulls", card)
    with pytest.raises(ValueError, match="not contiguous"):
        # a stride-0 broadcast of a literal, as Chunk.broadcast makes
        TC.masked_reduce("sum", torch.broadcast_to(vals[0], vals.shape), None,
                         alive)
    with pytest.raises(TypeError, match="dtype"):
        TC.masked_reduce("sum", vals.to(torch.int16), None, alive)
    with pytest.raises(ValueError, match="shape"):
        TC.masked_reduce("sum", vals[1:], None, alive)
    with pytest.raises(ValueError, match="is on cpu"):
        TC.masked_reduce("sum", vals.cpu(), None, alive)


def test_wrappers_reject_cpu_tensors():
    alive = torch.ones(4, dtype=torch.bool)
    vals = torch.arange(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="needs CUDA"):
        TC.masked_reduce("sum", vals, None, alive)
    with pytest.raises(ValueError, match="needs CUDA"):
        TC.dense_aggregate([vals], [0], [1], 4, [("sum", vals, None)], alive)


def test_dense_wrapper_rejects_large_domain():
    alive = torch.ones(4, dtype=torch.bool)
    idx = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="domain 129"):
        TC.dense_aggregate([idx], [0], [1], 129, [("count", None, None)],
                           alive)
    with pytest.raises(ValueError, match="9 key columns"):
        TC.dense_aggregate([idx] * 9, [0] * 9, [1] * 9, 4,
                           [("count", None, None)], alive)


def test_public_functions_take_plain_versions_on_cpu():
    vals, valid, alive, keys = _inputs(torch.float64, "nulls", "cpu")
    TC.reset_launches()
    for fn in FNS:
        got = TG.scalar_agg(fn, vals, valid, alive)
        want = TG.scalar_agg_plain(fn, vals, valid, alive)
        for g, w in zip(got, want):
            _same(g, w, 0.0)
    idx = TG.pack_dense_index([keys], [0], [1], 6, alive)
    TG.dense_groupby(idx, 6, [("sum", vals, valid)], alive)
    assert set(TC.LAUNCHES) >= {"scalar_agg", "dense_groupby"}
    assert not any(TC.LAUNCHES.values()), TC.LAUNCHES


# ---------------------------------------------------------------------
# K3 direct table, K4 sorted probe, K5 segmented reduce, K6 gather
# ---------------------------------------------------------------------

from quickstep_tpu_torch.ops import bloom as TB  # noqa: E402
from quickstep_tpu_torch.ops import join as TJ  # noqa: E402
from quickstep_tpu_torch.ops import kernels as TK  # noqa: E402


def _join_inputs(key_dtype, dups, device, n_build=20_011, n_probe=100_003,
                 seed=9):
    """Build keys in [lo, lo + domain) plus some outside it, one duplicated
    key when `dups`; probe keys over a wider range; ~20% dead rows."""
    rng = np.random.default_rng(seed)
    lo, domain = 50, 3 * n_build
    bkey = rng.permutation(domain + 40)[:n_build] + lo - 20
    if dups:
        bkey[7] = bkey[3]
    pkey = rng.integers(lo - 100, lo + domain + 100, n_probe)
    balive = rng.random(n_build) < 0.8
    if dups:
        balive[[3, 7]] = True
    palive = rng.random(n_probe) < 0.8
    t = [torch.from_numpy(a) for a in (bkey, balive, pkey, palive)]
    t[0], t[2] = t[0].to(key_dtype), t[2].to(key_dtype)
    return [x.to(device) for x in t] + [lo, domain]


@pytest.mark.cuda
@pytest.mark.parametrize("dups", (False, True), ids=("unique", "dups"))
@pytest.mark.parametrize("key_dtype", (torch.int32, torch.int64), ids=str)
def test_direct_join_kernel_matches_plain(card, key_dtype, dups):
    bkey, balive, pkey, palive, lo, domain = _join_inputs(key_dtype, dups,
                                                          card)
    table, dup = TJ.direct_build(bkey, balive, lo, domain)
    want_table, want_dup = TJ.direct_build_plain(bkey, balive, lo, domain)
    _same(dup, want_dup, 0.0)
    assert bool(dup) == dups
    slots = TJ.direct_table(table, domain)
    if not dups:
        _same(slots, want_table, 0.0)
    else:
        # which duplicate wins may differ; every other slot agrees
        differ = (slots != want_table).nonzero().flatten().tolist()
        assert len(differ) <= 1
    got = TJ.direct_probe(table, pkey, palive, lo, domain)
    want = TJ.direct_probe_plain(table, pkey, palive, lo, domain)
    for g, w in zip(got, want):
        _same(g, w, 0.0)
    assert int(got[1].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("key_dtype", (torch.int32, torch.int64), ids=str)
def test_exact_filter_kernel_matches_plain(card, key_dtype):
    bkey, balive, pkey, palive, lo, domain = _join_inputs(key_dtype, True,
                                                          card)
    # the filter's build side repeats keys by design
    bkey = torch.cat([bkey, bkey[:500]])
    balive = torch.cat([balive, balive[:500]])
    bits = TB.exact_filter_build(bkey, balive, lo, domain)
    want = TB.exact_filter_build_plain(bkey, balive, lo, domain)
    _same(TB.presence_bits(bits, domain), want, 0.0)
    _same(TB.exact_filter_probe(bits, pkey, palive, lo),
          TB.exact_filter_probe_plain(want, pkey, palive, lo), 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dups", (False, True), ids=("unique", "dups"))
def test_sorted_probe_kernel_matches_plain(card, dups):
    bkey, balive, pkey, palive, _lo, _domain = _join_inputs(torch.int64, dups,
                                                            card)
    # packed composite keys are wide: spread them over 2^40
    bkey, pkey = bkey * 1_000_003, pkey * 1_000_003
    got = TJ.merge_unique_probe(bkey, balive, pkey, palive)
    want = TJ.merge_unique_probe_plain(bkey, balive, pkey, palive)
    for g, w in zip(got, want):
        _same(g, w, 0.0)
    assert bool(got[2]) == dups and int(got[1].sum()) > 0


def _group_inputs(device, n=100_003, seed=21):
    rng = np.random.default_rng(seed)
    k1 = torch.from_numpy(rng.integers(0, 3000, n).astype(np.int32))
    k2 = torch.from_numpy(rng.integers(-3, 4, n))
    k2_valid = torch.from_numpy(rng.random(n) < 0.9)
    alive = torch.from_numpy(rng.random(n) < 0.7)
    return [t.to(device) for t in (k1, k2, k2_valid, alive)]


@pytest.mark.cuda
@pytest.mark.parametrize("packed", (True, False), ids=("packed", "multikey"))
@pytest.mark.parametrize("mode", ("no_nulls", "nulls", "all_dead", "empty"))
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_sort_groupby_kernel_matches_plain(card, dtype, mode, packed):
    vals, valid, alive, _ = _inputs(dtype, mode, card)
    n = len(alive)
    k1, k2, k2_valid, _ = (t[:n] for t in _group_inputs(card))
    keys, key_valids = [k1, k2], [None, k2_valid]
    packed_key = None
    if packed:
        enc = torch.where(k2_valid, k2 + 3, torch.full_like(k2, 7))
        packed_key = k1.to(torch.int64) * 8 + enc
    specs = [(fn, vals, valid) for fn in FNS]
    got = TG.sort_groupby(keys, key_valids, specs, alive, packed_key,
                          want_rows=True)
    want = TG.sort_groupby_plain(keys, key_valids, specs, alive, packed_key,
                                 want_rows=True)
    occ = want[2]
    _same(got[2], occ, 0.0)
    _same(got[3], want[3], 0.0)
    _same(got[5], want[5], 0.0)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        if w is None:
            assert g is None
        else:
            _same(g, w, 0.0)
    for fn, (gd, gn), (wd, wn) in zip(FNS, got[4], want[4]):
        _same(gn, wn, 0.0)
        _same(gd, wd, RTOL.get(dtype, 0.0) if fn in ("sum", "avg") else 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("idx_dtype", (torch.int32, torch.int64), ids=str)
def test_multi_gather_kernel_matches_plain(card, idx_dtype):
    rng = np.random.default_rng(31)
    n, m = 50_021, 120_007
    cols = [torch.from_numpy(rng.random(n) < 0.5),
            torch.from_numpy(rng.integers(-9, 9, n).astype(np.int16)),
            torch.from_numpy(rng.integers(-10**9, 10**9, n).astype(np.int32)),
            torch.from_numpy(rng.integers(-10**15, 10**15, n)),
            torch.from_numpy(rng.random(n).astype(np.float32)),
            torch.from_numpy(rng.random(n))]
    cols = [c.to(card) for c in cols] * 3 + [None]     # 18 columns + None
    idx = torch.from_numpy(rng.integers(0, n, m)).to(idx_dtype).to(card)
    TC.reset_launches()
    got = TK.multi_gather(cols, idx)
    assert TC.LAUNCHES["multi_gather"] == 2       # 16 columns per launch
    want = TK.multi_gather_plain(cols, idx)
    assert got[-1] is None
    for g, w in zip(got[:-1], want[:-1]):
        _same(g, w, 0.0)


GATHER_DTYPES = {1: (torch.bool, torch.int8), 2: (torch.int16,),
                 4: (torch.int32, torch.float32),
                 8: (torch.int64, torch.float64)}


@pytest.mark.cuda
@pytest.mark.parametrize("widths", ((2, 1), (8, 4), (1, 4, 4, 8, 4, 8),
                                    (8,) * 8, (8,) * 9, (4,)),
                         ids=lambda w: "-".join(map(str, w)))
@pytest.mark.parametrize("idx_dtype", (torch.int32, torch.int64), ids=str)
def test_multi_gather_routes_match_plain(card, widths, idx_dtype):
    """A random index with random=True: the route gather_route picks (the
    row-packed route for 16-, 32- and 64-byte rows; the direct one for one
    column and for rows past 64 bytes) launches and equals index_select."""
    rng = np.random.default_rng(sum(widths))
    n, m = 50_021, 120_007
    cols = []
    for i, w in enumerate(widths):
        dt = GATHER_DTYPES[w][i % len(GATHER_DTYPES[w])]
        c = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, n))
        cols.append((c > 0 if dt == torch.bool else c.to(dt)).to(card))
    idx = torch.from_numpy(rng.integers(0, n, m)).to(idx_dtype).to(card)
    route = TC.gather_route(n, m, list(widths), True)
    assert route == ("direct" if len(widths) == 1 or sum(widths) > 64
                     else "packed")
    TC.reset_launches()
    got = TK.multi_gather(cols, idx, random=True)
    key = "multi_gather_packed" if route == "packed" else "multi_gather"
    assert TC.LAUNCHES == dict(dict.fromkeys(TC.LAUNCHES, 0), **{key: 1})
    for g, w in zip(got, TK.multi_gather_plain(cols, idx)):
        _same(g, w, 0.0)
    TC.reset_launches()
    TK.multi_gather(cols, idx)
    assert TC.LAUNCHES["multi_gather"] == 1


@pytest.mark.cuda
def test_packed_gather_clamps_indices(card):
    cols = [torch.arange(10, dtype=torch.int64, device=card),
            torch.arange(10, dtype=torch.int32, device=card) * 3]
    idx = torch.tensor([-5, 0, 9, 10, 1 << 40] * 200, device=card)
    TC.reset_launches()
    got = TC.multi_gather(cols, idx, random=True)
    assert TC.LAUNCHES["multi_gather_packed"] == 1
    assert got[0].cpu().tolist() == [0, 0, 9, 9, 9] * 200
    assert got[1].cpu().tolist() == [0, 0, 27, 27, 27] * 200


@pytest.mark.cuda
def test_multi_gather_kernel_clamps_indices(card):
    col = torch.arange(10, dtype=torch.int64, device=card)
    idx = torch.tensor([-5, 0, 9, 10, 1 << 40], device=card)
    (got,) = TC.multi_gather([col], idx)
    assert got.cpu().tolist() == [0, 0, 9, 9, 9]


@pytest.mark.cuda
def test_join_kernel_launches_are_counted(card):
    bkey, balive, pkey, palive, lo, domain = _join_inputs(torch.int32, False,
                                                          card)
    k1, k2, _k2_valid, alive = _group_inputs(card)
    TC.reset_launches()
    table, _ = TJ.direct_build(bkey, balive, lo, domain)
    TJ.direct_probe(table, pkey, palive, lo, domain)
    bits = TB.exact_filter_build(bkey, balive, lo, domain)
    TB.exact_filter_probe(bits, pkey, palive, lo)
    TJ.merge_unique_probe(bkey.long(), balive, pkey.long(), palive)
    TG.sort_groupby([k1, k2], [None, None],
                    [("sum", k2, None), ("count", None, None)], alive)
    TJ.direct_build_plain(bkey, balive, lo, domain)
    TJ.merge_unique_probe_plain(bkey.long(), balive, pkey.long(), palive)
    # the two-key group-by gathers its keys by the sort permutation: K6's
    # row-packed route
    assert TC.LAUNCHES == dict(dict.fromkeys(TC.LAUNCHES, 0), direct_join=4,
                               merge_unique_probe=1, sort_groupby=2,
                               multi_gather_packed=1)


def test_join_wrappers_reject_cpu_tensors():
    key = torch.arange(4, dtype=torch.int32)
    alive = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="needs CUDA"):
        TC.direct_build(key, alive, 0, 4)
    with pytest.raises(ValueError, match="needs CUDA"):
        TC.direct_probe(torch.full((4,), -1, dtype=torch.int32), key, alive,
                        0)
    with pytest.raises(ValueError, match="needs CUDA"):
        TC.sorted_probe(key.long(), key.long(), key.long(), alive)
    with pytest.raises(ValueError, match="needs CUDA"):
        TC.segment_reduce("sum", alive, alive, key.long(), key.long(), None)
    with pytest.raises(ValueError, match="needs CUDA"):
        TC.multi_gather([key], key)


def test_join_public_functions_take_plain_versions_on_cpu():
    bkey, balive, pkey, palive, lo, domain = _join_inputs(torch.int64, False,
                                                          "cpu")
    k1, k2, k2_valid, alive = _group_inputs("cpu")
    TC.reset_launches()
    table, dup = TJ.direct_build(bkey, balive, lo, domain)
    _same(table, TJ.direct_build_plain(bkey, balive, lo, domain)[0], 0.0)
    TJ.direct_probe(table, pkey, palive, lo, domain)
    bits = TB.exact_filter_build(bkey, balive, lo, domain)
    TB.exact_filter_probe(bits, pkey, palive, lo)
    TJ.merge_unique_probe(bkey, balive, pkey, palive)
    TG.sort_groupby([k1, k2], [None, k2_valid], [("max", k2, None)], alive)
    TK.multi_gather([k1, None, k2], pkey.clamp(0, len(k1) - 1))
    assert not any(TC.LAUNCHES.values()), TC.LAUNCHES


# ---------------------------------------------------------------------
# K7 expansion probe, K8 run statistics, K9 stable partition
# ---------------------------------------------------------------------

def _expand_inputs(device, n_keys=5_003, per_key=4, n_probe=100_003, seed=41):
    """A partsupp-like build: per_key rows of each key (one key repeated
    more often), shuffled, ~10% dead; probe keys over a wider range, ~20%
    dead."""
    rng = np.random.default_rng(seed)
    bkey = np.repeat(np.arange(1, n_keys + 1), per_key)
    bkey = np.concatenate([bkey, np.full(9, 17)])
    bkey = rng.permutation(bkey) * 1_000_003
    balive = rng.random(len(bkey)) < 0.9
    pkey = rng.integers(0, n_keys + 200, n_probe) * 1_000_003
    palive = rng.random(n_probe) < 0.8
    return [torch.from_numpy(a).to(device)
            for a in (bkey, balive, pkey, palive)]


@pytest.mark.cuda
@pytest.mark.parametrize("k", (1, 4, 16))
def test_expand_probe_kernel_matches_plain(card, k):
    bkey, balive, pkey, palive = _expand_inputs(card)
    sorted_key, order = TJ.sorted_build(bkey, balive)
    got = TJ.expand_probe(sorted_key, order, pkey, palive, k)
    want = TJ.expand_probe_plain(sorted_key, order, pkey, palive, k)
    for g, w in zip(got, want):
        _same(g, w, 0.0)
    # key 17 has 13 rows, so every width below 13 overflows
    assert bool(got[2]) == (k < 13) and int((got[1] > 0).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("op", ("<>", "<", "<=", ">", ">=", "stats"))
def test_run_stats_probe_kernel_matches_plain(card, op):
    bkey, balive, pkey, palive = _expand_inputs(card, per_key=7)
    rng = np.random.default_rng(43)
    bval = torch.from_numpy(rng.integers(-5, 5, len(bkey)).astype(np.int32))
    pval = torch.from_numpy(rng.integers(-6, 6, len(pkey)).astype(np.int32))
    bval, pval = bval.to(card), pval.to(card)
    if op == "stats":
        got = TJ.merge_stats_probe(bkey, balive, bval, pkey, palive)
        want = TJ.merge_stats_probe_plain(bkey, balive, bval, pkey, palive)
    else:
        got = (TJ.merge_cmp_probe(bkey, balive, bval, pkey, palive, pval,
                                  op),)
        want = (TJ.merge_cmp_probe_plain(bkey, balive, bval, pkey, palive,
                                         pval, op),)
    for g, w in zip(got, want):
        _same(g, w, 0.0)
    assert 0 < int(got[0].sum()) < len(pkey)


@pytest.mark.cuda
@pytest.mark.parametrize("n", (0, 1, 4095, 4096, 100_003))
@pytest.mark.parametrize("live", (0.0, 0.01, 0.5, 1.0))
def test_stable_partition_kernel_matches_plain(card, n, live):
    rng = np.random.default_rng(47)
    mask = torch.from_numpy(rng.random(n) < live).to(card)
    _same(TK.stable_partition(mask), TK.compact_order(mask), 0.0)


def _k9_limits(live: int, n: int):
    return sorted({0, 1, max(live - 1, 0), live, min(live + 1, n), n})


@pytest.mark.cuda
@pytest.mark.parametrize("n", (0, 1, 4095, 4096, 100_003))
@pytest.mark.parametrize("live", (0.0, 0.01, 0.5, 1.0))
def test_stable_partition_limit_matches_plain(card, n, live):
    """K9 with `limit` is the plain order's head, for limits about the
    live count; only that many positions come back, and with_mask the
    mask gathered by them."""
    rng = np.random.default_rng(53)
    mask = torch.from_numpy(rng.random(n) < live).to(card)
    want = TK.compact_order(mask)
    for limit in _k9_limits(int(mask.sum()), n):
        got = TK.stable_partition(mask, limit=limit)
        _same(got, want[:limit], 0.0)
        order, taken = TK.stable_partition(mask, limit=limit, with_mask=True)
        _same(order, want[:limit], 0.0)
        _same(taken, mask[want[:limit]], 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("n, kernels", ((1, 1), (4096, 1), (4097, 2),
                                        (100_003, 2)))
def test_stable_partition_launches_one_kernel_under_one_tile(card, n,
                                                              kernels):
    """At most 4,096 rows K9 is one kernel; past one tile two (the counts
    with their look-back, then the scatter)."""
    from torch.profiler import ProfilerActivity, profile
    mask = torch.arange(n, device=card) % 3 == 0
    TK.stable_partition(mask, limit=n // 2 + 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = TK.stable_partition(mask, limit=n // 2 + 1)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.self_device_time_total > 0 and "emset" not in e.key]
    counts = sum(e.count for e in prof.key_averages()
                 if e.key in names)
    assert counts == kernels, names
    _same(got, TK.compact_order(mask)[:n // 2 + 1], 0.0)


@pytest.mark.cuda
def test_stable_partition_unaligned_view(card):
    """A mask view that does not start on 16 bytes (the kernel's vector
    loads) gives the same order."""
    rng = np.random.default_rng(59)
    base = torch.from_numpy(rng.random(100_013) < 0.3).to(card)
    mask = base[3:]
    for limit in (None, 5_000, int(mask.sum())):
        want = TK.compact_order(mask)
        _same(TK.stable_partition(mask, limit=limit),
              want if limit is None else want[:limit], 0.0)


@pytest.mark.cuda
def test_sort_groupby_compact_kernel_matches_plain(card):
    vals, valid, alive, _ = _inputs(torch.int64, "nulls", card)
    k1, k2, k2_valid, _ = _group_inputs(card)
    specs = [(fn, vals, valid) for fn in FNS]
    got = TG.sort_groupby_compact([k1, k2], [None, k2_valid], specs, alive)
    want = TG.sort_groupby_compact_plain([k1, k2], [None, k2_valid], specs,
                                         alive)
    _same(got[2], want[2], 0.0)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert (g is None) == (w is None)
        if w is not None:
            _same(g, w, 0.0)
    for (gd, gn), (wd, wn) in zip(got[3], want[3]):
        _same(gd, wd, 0.0)
        _same(gn, wn, 0.0)


@pytest.mark.cuda
def test_new_kernel_launches_are_counted(card):
    bkey, balive, pkey, palive = _expand_inputs(card)
    val = (bkey % 7).to(torch.int32)
    pval = (pkey % 5).to(torch.int32)
    sorted_key, order = TJ.sorted_build(bkey, balive)
    TC.reset_launches()
    TJ.expand_probe(sorted_key, order, pkey, palive, 4)
    TJ.merge_cmp_probe(bkey, balive, val, pkey, palive, pval, "<>")
    TJ.merge_stats_probe(bkey, balive, val, pkey, palive)
    TK.stable_partition(palive)
    TK.stable_partition(palive, limit=7)
    TJ.expand_probe_plain(sorted_key, order, pkey, palive, 4)
    TK.compact_order(palive)
    assert TC.LAUNCHES == dict(dict.fromkeys(TC.LAUNCHES, 0), expand_probe=1,
                               merge_cmp_probe=2, sort_groupby_compact=2)


def test_new_wrappers_reject_cpu_tensors():
    key = torch.arange(4, dtype=torch.int64)
    alive = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="needs CUDA"):
        TC.expand_probe(key, key, key, alive, 2)
    with pytest.raises(ValueError, match="needs CUDA"):
        TC.run_stats_probe(key, key, key.int(), key, alive, key.int(), "<>")
    with pytest.raises(ValueError, match="needs CUDA"):
        TC.stable_partition(alive)


def test_new_public_functions_take_plain_versions_on_cpu():
    bkey, balive, pkey, palive = _expand_inputs("cpu", n_probe=1000)
    val = (bkey % 7).to(torch.int32)
    pval = (pkey % 5).to(torch.int32)
    k1, k2, k2_valid, alive = _group_inputs("cpu", n=1000)
    sorted_key, order = TJ.sorted_build(bkey, balive)
    TC.reset_launches()
    TJ.expand_probe(sorted_key, order, pkey, palive, 4)
    TJ.merge_cmp_probe(bkey, balive, val, pkey, palive, pval, "<")
    TJ.merge_stats_probe(bkey, balive, val, pkey, palive)
    TK.stable_partition(palive)
    TG.sort_groupby_compact([k1], [None], [("sum", k2, k2_valid)], alive)
    assert not any(TC.LAUNCHES.values()), TC.LAUNCHES


# ---------------------------------------------------------------------
# W1 segmented prefix, W2 frame MIN/MAX, W3 frame bounds, W4 sliding sums
# ---------------------------------------------------------------------

from quickstep_tpu_torch.ops import window as TW  # noqa: E402

WIN_FNS = ("sum", "count", "min", "max")


def _window_rows(device, n=100_003, seg_len=30, peers=0.5, seed=51):
    """Sorted-row flags: segments of ~seg_len rows (seg_len None: one
    segment), peer groups inside them, ~80% live rows, a sorted int32 key
    per segment (RANGE frames) and values of every dtype."""
    rng = np.random.default_rng(seed)
    seg = rng.random(n) < (0.0 if seg_len is None else 1.0 / seg_len)
    seg[0] = True
    peer = seg | (rng.random(n) < peers)
    live = rng.random(n) < 0.8
    seg_id = np.cumsum(seg) - 1
    key = np.sort(seg_id * 10**6 + rng.integers(0, 100 * (seg_len or n), n))
    key = (key - seg_id * 10**6).astype(np.int32)
    vals = {torch.int32: rng.integers(-10**6, 10**6, n).astype(np.int32),
            torch.int64: rng.integers(-10**12, 10**12, n),
            torch.float32: rng.normal(3000, 1000, n).astype(np.float32),
            torch.float64: rng.normal(3000, 1000, n)}
    t = {k: torch.from_numpy(v).to(device) for k, v in vals.items()}
    return ([torch.from_numpy(a).to(device) for a in (seg, peer, live, key)],
            t)


def _contrib(fn, v, live):
    if fn in ("min", "max"):
        return TW._sentinel_fill(fn, v, live)
    return torch.where(live, v, torch.zeros((), dtype=v.dtype,
                                            device=v.device))


def _prefix_atol(fn, v, live):
    """Float sums: a few ulps of the largest prefix sum, 32 eps x the sum of
    the live magnitudes; everything else exactly. The plain version takes
    differences of a whole-array torch.cumsum, which on the card is not
    deterministic: over one 15 M-row float64 segment six runs put it
    3.9e-3 to 5.9e-3 from the exact prefix (up to 7 eps x the sum), W1
    (each segment summed in float64) 1.95e-3 every time."""
    if fn != "sum" or not v.dtype.is_floating_point:
        return 0.0
    scale = float(torch.where(live, v, 0).abs().double().sum())
    return 32 * torch.finfo(v.dtype).eps * scale


def _close(got, want, atol):
    assert got.dtype == want.dtype and got.shape == want.shape
    if atol:
        torch.testing.assert_close(got.cpu(), want.cpu(), rtol=0, atol=atol)
    else:
        assert torch.equal(got.cpu(), want.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ("segments", "whole_partition",
                                    "one_segment", "whole_mode",
                                    "whole_mode_one_segment"))
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("fn", WIN_FNS)
def test_window_prefix_kernel_matches_plain(card, fn, dtype, layout):
    """The running mode, and the whole-partition mode (segment_totals)
    against the plain version with the peer groups equal to the
    segments."""
    (seg, peer, live, _key), vals = _window_rows(
        card, seg_len=None if layout.endswith("one_segment") else 30)
    if layout.startswith("whole"):
        peer = seg
    v = None if fn == "count" else _contrib(fn, vals[dtype], live)
    if layout.startswith("whole_mode"):
        got = TW.segment_totals(fn, v, live, seg)
    else:
        got = TW.segmented_prefix(fn, v, live, seg, peer)
    want = TW.segmented_prefix_plain(fn, v, live, seg, peer)
    _close(got[1], want[1], 0.0)
    if fn == "count":
        assert got[0] is None and want[0] is None
    else:
        _close(got[0], want[0], _prefix_atol(fn, vals[dtype], live))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ("running", "whole"))
def test_window_prefix_kernel_one_15m_row_segment(card, mode):
    """W-Q3's shape: one segment of 15 M rows in ~2,400 peer groups (in the
    whole-partition mode, every row its total)."""
    n = 15_000_000
    rng = np.random.default_rng(53)
    seg = torch.zeros(n, dtype=torch.bool, device=card)
    seg[0] = True
    peer = torch.from_numpy(rng.random(n) < 1 / 6000).to(card) | seg
    if mode == "whole":
        peer = seg
    live = torch.ones(n, dtype=torch.bool, device=card)
    price = torch.from_numpy(rng.integers(100_000, 50_000_000, n) / 100).to(
        card)
    for fn, v in (("sum", price), ("max", price), ("count", None)):
        got = TW.segmented_prefix(fn, v, live, seg, peer) \
            if mode == "running" else TW.segment_totals(fn, v, live, seg)
        want = TW.segmented_prefix_plain(fn, v, live, seg, peer)
        _close(got[1], want[1], 0.0)
        if v is not None:
            _close(got[0], want[0], _prefix_atol(fn, v, live))


FRAMES = (("rows", 3, 0), ("rows", 1, 1), ("rows", None, 2), ("rows", 5, None),
          ("range", 30, 30), ("range", 0, 40), ("range", None, 7),
          ("range", 25, None))


@pytest.mark.cuda
@pytest.mark.parametrize("key_dtype", DTYPES, ids=str)
@pytest.mark.parametrize("frame", FRAMES, ids=str)
def test_frame_bounds_kernel_matches_plain(card, frame, key_dtype):
    (seg, _peer, _live, key), _ = _window_rows(card)
    mode, start, end = frame
    key = key.to(key_dtype)
    got = TW.frame_bounds(seg, mode, start, end, key)
    want = TW.frame_bounds_plain(seg, mode, start, end, key)
    for g, w in zip(got, want):
        _close(g, w, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("frame", (("rows", 3, 0), ("range", 30, 30),
                                   ("rows", 5000, 3000), ("rows", None, None)),
                         ids=("short", "range", "longer_than_tiles", "whole"))
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("fn", ("min", "max"))
def test_frame_minmax_kernel_matches_plain(card, fn, dtype, frame):
    """Frames of up to 8,001 rows span more than two of W2's 1,024-row
    tiles and go through its tile table."""
    (seg, _peer, live, key), vals = _window_rows(
        card, seg_len=None if frame[1] in (None, 5000) else 30)
    lo, hi = TW.frame_bounds_plain(seg, *frame, key)
    c = _contrib(fn, vals[dtype], live)
    _close(TW.frame_minmax(fn, c, lo, hi), TW.frame_minmax_plain(fn, c, lo, hi),
           0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("frame", (("rows", 3, 0), ("rows", 2, 5),
                                   ("range", 30, 30), ("rows", None, 1)),
                         ids=str)
@pytest.mark.parametrize("dtype", (torch.float32, torch.float64), ids=str)
def test_sliding_sum_kernel_is_bit_equal_to_plain(card, dtype, frame):
    (seg, _peer, live, key), vals = _window_rows(card)
    lo, hi = TW.frame_bounds_plain(seg, *frame, key)
    c = _contrib("sum", vals[dtype], live)
    got = TW.sliding_sums(c, lo, hi, seg)
    assert got.dtype == dtype
    _close(got, TW.sliding_sums_plain(c, lo, hi, seg), 0.0)


@pytest.mark.cuda
def test_sliding_sum_kernel_one_15m_row_segment(card):
    """One thread walks a single 15 M-row segment; the plain version slides
    it in a scalar loop. Bit-equal."""
    n = 15_000_000
    rng = np.random.default_rng(57)
    seg = torch.zeros(n, dtype=torch.bool, device=card)
    seg[0] = True
    lo, hi = TW.frame_bounds_plain(seg, "rows", 3, 0)
    c = torch.from_numpy(rng.integers(100_000, 50_000_000, n) / 100).to(card)
    _close(TW.sliding_sums(c, lo, hi, seg), TW.sliding_sums_plain(c, lo, hi,
                                                                  seg), 0.0)


def _same_bits(got, want):
    """Equal bit for bit, except that any NaN equals any NaN (the card and
    the host make NaNs of other signs and payloads)."""
    g, w = got.cpu(), want.cpu()
    assert g.dtype == w.dtype and g.shape == w.shape
    gn, wn = torch.isnan(g), torch.isnan(w)
    assert torch.equal(gn, wn)
    bits = torch.int32 if g.dtype == torch.float32 else torch.int64
    assert torch.equal(g[~gn].view(bits), w[~wn].view(bits))


def _w4_case(name, dtype, device, seed=61):
    """(values, lo, hi, segment starts) of one of W4's route cases: segments
    of ~30 rows (the short route); segments of 1,023-1,025, 2,047-2,049 and
    4,095-4,097 rows at every offset of the tile (kW4Tile 1,024, staged span
    2,048; W3's tile 4,096);
    one 30,000-row segment that starts mid-tile between short ones (the
    long route); frames that step back (NaN RANGE keys, then dead rows,
    each its own segment, as ops/window.py hands them over); frames that
    cross segments and reach 300 rows back (outside the staged rows);
    segments of 20,000 rows framed 5,000 rows each way (outside the long
    route's ring); and one 200,000-row segment framed from 3 preceding to
    UNBOUNDED FOLLOWING (a first row of 200,000 steps). Values hold NaN and +-inf
    where their name says so."""
    rng = np.random.default_rng(seed)
    if name == "tile_edges":
        lens = rng.choice([1023, 1024, 1025, 2047, 2048, 2049, 4095, 4096,
                           4097, 1, 30], 120)
        n = int(lens.sum())
    elif name == "unbounded_following":
        n = 200_000
    elif name == "outside_span":
        n = 30_011
    else:
        n = 100_003
    seg = np.zeros(n, bool)
    if name == "tile_edges":
        seg[np.cumsum(lens)[:-1]] = True
    elif name.startswith("long_mid_tile"):
        seg[rng.random(n) < 1 / 30] = True
        seg[1_000:31_000] = False
        seg[1_000] = seg[31_000] = True
    elif name == "long_wide_frame":
        seg[::20_000] = True
    elif name != "unbounded_following":
        seg[rng.random(n) < 1 / 30] = True
    seg[0] = True
    seg_t = torch.from_numpy(seg).to(device)
    vals = rng.normal(3000, 1000, n)
    if name.endswith("nan_inf"):
        vals[rng.random(n) < 0.001] = np.nan
        vals[rng.random(n) < 0.001] = np.inf
        vals[rng.random(n) < 0.001] = -np.inf
    c = torch.from_numpy(vals).to(dtype).to(device)
    if name == "steps_back":
        key = np.sort(np.cumsum(seg) * 10**6 + rng.integers(0, 3000, n))
        key = (key - np.cumsum(seg) * 10**6).astype(np.float64)
        key[rng.random(n) < 0.05] = np.nan       # then sorted last below
        order = np.lexsort((np.isnan(key), np.cumsum(seg)))
        key = key[order]
        lo, hi = TW.frame_bounds_plain(seg_t, "range", 40, 10,
                                       torch.from_numpy(key).to(device))
        dead = torch.arange(n, device=device) >= n - 5_000
        pos = torch.arange(n, dtype=torch.int32, device=device)
        lo = torch.where(dead, pos, lo)
        hi = torch.where(dead, pos - 1, hi)
        return c, lo, hi, seg_t | dead
    if name == "outside_span":
        # frames 300 rows back across segments, and one row whose frame
        # jumps 310 rows ahead, so that the reference's bounded step loops
        # (and the plain version's) take every step of a segment's first
        # row
        lo = np.clip(np.arange(n) - 300, 0, None)
        hi = np.clip(np.arange(n) + 7, None, n - 1)
        jump = int(np.flatnonzero(~seg[n // 2:])[0]) + n // 2
        lo[jump] = lo[jump - 1] + 310
        hi[jump] = hi[jump - 1] + 310
        return c, *[torch.from_numpy(t.astype(np.int32)).to(device)
                    for t in (lo, hi)], seg_t
    frame = {"unbounded_following": ("rows", 3, None),
             "long_wide_frame": ("rows", 5000, 5000)}.get(name, ("rows", 3, 1))
    lo, hi = TW.frame_bounds_plain(seg_t, *frame)
    return c, lo, hi, seg_t


W4_CASES = ("short", "short_nan_inf", "tile_edges", "long_mid_tile",
            "long_mid_tile_nan_inf", "steps_back", "outside_span",
            "long_wide_frame", "unbounded_following")


@pytest.mark.cuda
@pytest.mark.parametrize("name", W4_CASES)
@pytest.mark.parametrize("dtype", (torch.float32, torch.float64), ids=str)
def test_sliding_sum_routes_are_bit_equal_to_plain(card, dtype, name):
    c, lo, hi, seg = _w4_case(name, dtype, card)
    _same_bits(TW.sliding_sums(c, lo, hi, seg),
               TW.sliding_sums_plain(c, lo, hi, seg))


@pytest.mark.cuda
@pytest.mark.parametrize("n", (1, 4096, 4097, 60_000_000))
@pytest.mark.parametrize("frame", (("rows", 3, 0), ("rows", None, 2),
                                   ("range", 30, 30), ("range", None, 7)),
                         ids=str)
def test_frame_bounds_look_back_sizes(card, frame, n):
    """W3's two launches at one tile, at a tile's edge and at 60 M rows:
    segments of ~600 rows, and at 60 M one 15 M-row segment among them."""
    gen = torch.Generator(device=card)
    gen.manual_seed(67)
    seg = torch.rand(n, device=card, generator=gen) < 1 / 600
    if n == 60_000_000:
        seg[20_000_001:35_000_001] = False
    seg[0] = True
    seg_id = torch.cumsum(seg.to(torch.int64), 0) - 1
    codes = torch.randint(0, 3_600, (n,), device=card, generator=gen)
    key = (torch.sort(seg_id * 4_096 + codes)[0] - seg_id * 4_096).to(
        torch.int32)
    del codes, seg_id
    got = TW.frame_bounds(seg, *frame, key)
    want = TW.frame_bounds_plain(seg, *frame, key)
    for g, w in zip(got, want):
        _close(g, w, 0.0)


def _edge_keys(dtype, n, seg, rng):
    """Keys sorted within each segment (NaNs last, -0.0 and 0.0 mixed, runs
    of duplicates, +-inf) for float dtypes; for integers values at both
    ends of the type's range."""
    seg_id = np.cumsum(seg) - 1
    if dtype.is_floating_point:
        pool = np.array([-np.inf, -1e30, -3.5, -0.0, 0.0, 0.0, 1.0, 1.0, 1.0,
                         2.5, 7.0, 1e30, np.inf, np.nan])
        k = pool[rng.integers(0, len(pool), n)]
        k = np.where(rng.random(n) < 0.5, k + rng.integers(1, 50, n), k)
        k = k.astype(np.float32 if dtype == torch.float32 else np.float64)
        canon = np.where(np.isnan(k), np.inf, k)
        order = np.lexsort((np.isnan(k), canon, seg_id))
        return torch.from_numpy(k[order])
    info = np.iinfo(np.int32 if dtype == torch.int32 else np.int64)
    k = np.concatenate([rng.integers(info.min, info.min + 100, n // 3),
                        rng.integers(-50, 50, n // 3),
                        rng.integers(info.max - 100, info.max, n - 2 * (n // 3),
                                     endpoint=True)])
    k = k.astype(np.int32 if dtype == torch.int32 else np.int64)
    order = np.lexsort((k, seg_id))
    return torch.from_numpy(k[order])


@pytest.mark.cuda
@pytest.mark.parametrize("frame", (("range", 3, 2), ("range", 0, 0),
                                   ("range", None, 5), ("range", 4, None),
                                   ("range", 2**40, 2**40),
                                   ("range", 2**31, 1)), ids=str)
@pytest.mark.parametrize("key_dtype", DTYPES, ids=str)
def test_frame_bounds_edge_keys_match_plain(card, key_dtype, frame):
    """RANGE bounds over NaN, +-inf, -0.0 against 0.0, duplicate keys and
    offsets past the key type's range, in segments of ~700 rows and one of
    20,000 (a search that starts outside the staged keys)."""
    rng = np.random.default_rng(71)
    n = 50_021
    seg = rng.random(n) < 1 / 700
    seg[10_000:30_000] = False
    seg[0] = seg[10_000] = True
    key = _edge_keys(key_dtype, n, seg, rng).to(card)
    seg_t = torch.from_numpy(seg).to(card)
    got = TW.frame_bounds(seg_t, *frame, key)
    want = TW.frame_bounds_plain(seg_t, *frame, key)
    for g, w in zip(got, want):
        _close(g, w, 0.0)


@pytest.mark.cuda
def test_w3_w4_take_no_host_sync(card):
    """W3 and W4 decide their routes on the device: with PyTorch's sync
    debug mode set to raise, both run (the long route included) and count
    their launches."""
    c, lo, hi, seg = _w4_case("long_mid_tile", torch.float64, card)
    key = torch.arange(len(c), dtype=torch.int32, device=card)
    torch.cuda.synchronize()
    TC.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        TW.frame_bounds(seg, "range", 30, 30, key)
        TW.frame_bounds(seg, "rows", 3, 0)
        TW.sliding_sums(c, lo, hi, seg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert TC.LAUNCHES["frame_bounds"] == 2
    assert TC.LAUNCHES["sliding_sum"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.float64), ids=str)
def test_add_chain_probe(card, dtype):
    """The dependent-add probe adds x[1] to x[0] steps times, rounding each
    time, as the host does."""
    x = torch.tensor([0.1, 0.3], dtype=dtype)
    want = x[0].clone()
    for _ in range(4096):
        want = want + x[1]
    _same_bits(TC.add_chain(x.to(card), 4096), want.reshape(1))


@pytest.mark.cuda
@pytest.mark.parametrize("frame", (None, ("rows", 3, 0), ("range", 2, 2),
                                   ("range", None, 0)), ids=str)
@pytest.mark.parametrize("fn", FNS)
def test_window_aggregate_kernels_match_plain(card, fn, frame):
    """The whole window_aggregate (sort, gathers, W1-W4, scatter back) on
    the card against its plain version, over live rows."""
    rng = np.random.default_rng(59)
    n = 50_021
    part = torch.from_numpy(rng.integers(0, 300, n).astype(np.int32))
    okey = torch.from_numpy(rng.integers(0, 1000, n).astype(np.int32))
    vals = torch.from_numpy(rng.normal(100, 30, n))
    valid = torch.from_numpy(rng.random(n) < 0.9)
    alive = torch.from_numpy(rng.random(n) < 0.8)
    args = [t.to(card) for t in (part, okey, vals, valid, alive)]
    for ranges in (None, [(0, 299), (0, 999)]):
        got = TW.window_aggregate([args[0]], [args[1]], [False], fn, args[2],
                                  args[3], args[4], frame, ranges)
        want = TW.window_aggregate_plain([args[0]], [args[1]], [False], fn,
                                         args[2], args[3], args[4], frame,
                                         ranges)
        keep = args[4]
        atol = _prefix_atol("sum", args[2], args[4]) if fn in (
            "sum", "avg") and frame in (None, ("range", None, 0)) else 0.0
        _close(got[0][keep], want[0][keep], atol)
        assert (got[1] is None) == (want[1] is None)
        if want[1] is not None:
            _close(got[1][keep], want[1][keep], 0.0)


@pytest.mark.cuda
def test_window_kernel_launches_are_counted(card):
    (seg, peer, live, key), vals = _window_rows(card)
    c = vals[torch.float64]
    TC.reset_launches()
    TW.segmented_prefix("sum", c, live, seg, peer)
    lo, hi = TW.frame_bounds(seg, "range", 30, 30, key)
    TW.frame_minmax("max", c, lo, hi)
    TW.sliding_sums(c, lo, hi, seg)
    TW.segmented_prefix_plain("sum", c, live, seg, peer)
    TW.frame_bounds_plain(seg, "range", 30, 30, key)
    TW.sliding_sums_plain(c, lo, hi, seg)
    assert TC.LAUNCHES == dict(dict.fromkeys(TC.LAUNCHES, 0), window_prefix=1,
                               frame_bounds=1, frame_minmax=1, sliding_sum=1)


def test_window_wrappers_reject_cpu_tensors():
    flags = torch.ones(4, dtype=torch.bool)
    c = torch.arange(4, dtype=torch.float64)
    idx = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="needs CUDA"):
        TC.window_prefix("sum", c, flags, flags, flags)
    with pytest.raises(ValueError, match="needs CUDA"):
        TC.frame_bounds(flags, "rows", 1, 1)
    with pytest.raises(ValueError, match="needs CUDA"):
        TC.frame_minmax("min", c, idx, idx)
    with pytest.raises(ValueError, match="needs CUDA"):
        TC.sliding_sum(c, idx, idx, flags)


def test_window_public_functions_take_plain_versions_on_cpu():
    (seg, peer, live, key), vals = _window_rows("cpu", n=2000)
    c = vals[torch.float32]
    TC.reset_launches()
    TW.segmented_prefix("min", c, live, seg, peer)
    lo, hi = TW.frame_bounds(seg, "range", 30, 30, key)
    TW.frame_minmax("max", c, lo, hi)
    TW.sliding_sums(c, lo, hi, seg)
    TW.window_aggregate([key], [key], [True], "avg", c, None, live,
                        ("rows", 2, 2))
    assert not any(TC.LAUNCHES.values()), TC.LAUNCHES


# ---------------------------------------------------------------------
# K10 hashing, K11 open addressing, K12 run starts, K13 sort keys, and
# every kernel at zero rows
# ---------------------------------------------------------------------

from quickstep_tpu_torch.bench.zero_rows import zero_row_cases  # noqa: E402
from quickstep_tpu_torch.ops import sort as TS  # noqa: E402

HASH_EDGES = [-(1 << 63), (1 << 63) - 1, -1, 0, 1, -(1 << 31), (1 << 31) - 1]


def _key_cols(dtype, ncols, n, seed, device, domain=None):
    rng = np.random.default_rng(seed)
    info = torch.iinfo(dtype) if not dtype.is_floating_point else None
    cols = []
    for _ in range(ncols):
        if domain is not None:
            c = rng.integers(0, domain, n)
            c = c * 0.5 if dtype.is_floating_point else c
        else:
            c = rng.integers(info.min, info.max, n, endpoint=True,
                             dtype=np.int64 if dtype == torch.int64
                             else np.int32)
            c[:len(HASH_EDGES)] = np.array(HASH_EDGES).astype(c.dtype)
        cols.append(torch.from_numpy(np.asarray(c)).to(dtype).to(device))
    return cols


@pytest.mark.cuda
@pytest.mark.parametrize("ncols", (1, 2, 3, 8))
@pytest.mark.parametrize("dtype", (torch.int32, torch.int64), ids=str)
def test_hash_keys_kernel_matches_plain(card, dtype, ncols):
    cols = _key_cols(dtype, ncols, 100_003, 61 + ncols, card)
    _same(TK.hash_keys(cols), TK.hash_keys_plain(cols), 0.0)


def _oa_sides(dtype, ncols, dups, device, n_build=20_011, n_probe=50_021,
              seed=67):
    rng = np.random.default_rng(seed)
    domain = n_build * 50
    build = _key_cols(dtype, ncols, n_build, seed, device, domain)
    # a distinct first column: every composite key is unique
    first = rng.choice(domain, n_build, replace=False)
    build[0] = torch.from_numpy(first * 0.5 if dtype.is_floating_point
                                else first).to(dtype).to(device)
    if dups:
        # every row a copy of one of the first half's rows
        rows = torch.from_numpy(rng.integers(0, n_build // 2, n_build))
        build = [c[rows.to(device)] for c in build]
    pick = torch.from_numpy(rng.integers(0, n_build, n_probe)).to(device)
    probe = [c[pick] for c in build]
    miss = torch.from_numpy(rng.random(n_probe) < 0.3).to(device)
    probe[0] = torch.where(miss, probe[0] + domain * 3, probe[0])
    balive = torch.from_numpy(rng.random(n_build) < 0.9).to(device)
    palive = torch.from_numpy(rng.random(n_probe) < 0.9).to(device)
    return build, probe, balive, palive


@pytest.mark.cuda
@pytest.mark.parametrize("dups", (False, True), ids=("unique", "dups"))
@pytest.mark.parametrize("ncols", (1, 2, 3))
@pytest.mark.parametrize("dtype", (torch.int32, torch.int64, torch.float64),
                         ids=str)
def test_open_addressing_kernel_matches_plain(card, dtype, ncols, dups):
    """matched and the dup flag exactly; the build row wherever the probe's
    key has one live build row; every matched row holds the probe's key."""
    build, probe, balive, palive = _oa_sides(dtype, ncols, dups, card)
    size = TK.next_pow2(2 * len(balive))
    table, dup = TJ.oa_build(build, balive, size)
    ptable, pdup = TJ.oa_build_plain(build, balive, size)
    assert bool(dup) == bool(pdup) == dups
    idx, matched = TJ.oa_probe(table, build, probe, palive)
    pidx, pmatched = TJ.oa_probe_plain(ptable, build, probe, palive)
    _same(matched, pmatched, 0.0)
    for b, p in zip(build, probe):
        _same(b[idx.long()[matched]], p[matched], 0.0)
    if not dups:
        _same(idx, pidx, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("n, size", ((100, 128), (120, 128), (100_000,
                                                               131_072)))
def test_open_addressing_kernel_never_evicts(card, n, size):
    keys = torch.arange(n, dtype=torch.int64, device=card) * 7919 + 13
    alive = torch.ones(n, dtype=torch.bool, device=card)
    table, dup = TJ.oa_build([keys], alive, size)
    assert not bool(dup)
    idx, matched = TJ.oa_probe(table, [keys], [keys], alive)
    assert bool(matched.all())
    _same(idx, torch.arange(n, dtype=torch.int32, device=card), 0.0)


def _sort_values(dtype, n, seed, device, domain=40):
    rng = np.random.default_rng(seed)
    if dtype == torch.bool:
        v = rng.random(n) < 0.5
    elif dtype.is_floating_point:
        v = rng.integers(-domain, domain, n) * 0.25
        v[:6] = [0.0, -0.0, np.nan, np.inf, -np.inf, np.nan]
    else:
        v = rng.integers(-domain, domain, n)
    return torch.from_numpy(np.asarray(v)).to(dtype).to(device)


SORT_DTYPES = DTYPES + (torch.bool,)


@pytest.mark.cuda
@pytest.mark.parametrize("nullable", (False, True))
@pytest.mark.parametrize("dtype", SORT_DTYPES, ids=str)
def test_distinct_kernel_matches_plain(card, dtype, nullable):
    rng = np.random.default_rng(71)
    n = 100_003
    vals = _sort_values(dtype, n, 73, card, domain=5_000)
    valid = torch.from_numpy(rng.random(n) < 0.9).to(card) if nullable \
        else None
    alive = torch.from_numpy(rng.random(n) < 0.8).to(card)
    _same(TG.distinct_count(vals, valid, alive),
          TG.distinct_count_plain(vals, valid, alive), 0.0)
    s, mask = TG.dedup_values(vals, valid, alive)
    ps, pmask = TG.dedup_values_plain(vals, valid, alive)
    _same(mask, pmask, 0.0)
    assert torch.equal(s[mask].cpu(), ps[pmask].cpu())


def _bits(t):
    """A tensor's bit patterns on the host, so that NaNs compare by their
    payloads and -0.0 differs from +0.0."""
    view = {torch.float32: torch.int32, torch.float64: torch.int64}
    return (t.view(view[t.dtype]) if t.dtype in view else t).cpu()


# NaNs of both signs with several payloads, as bit patterns
NAN_BITS = {torch.float32: [0x7fc00000, 0xffc00000, 0x7f800001, 0xff800123,
                            0x7fc00abc],
            torch.float64: [0x7ff8000000000000, 0xfff8000000000000,
                            0x7ff0000000000001, 0xfff0000000000123,
                            0x7ff8000000000abc]}


def _radix_values(dtype, n, seed, device, wide=False):
    """Values with every edge of K12's key map: INT_MIN and INT_MAX; -0.0,
    +0.0, -inf, +inf and NaNs of both signs with several payloads; or, wide,
    int64 values of about 33 bits (five of eight digits vary)."""
    rng = np.random.default_rng(seed)
    if dtype == torch.bool:
        return torch.from_numpy(rng.random(n) < 0.5).to(device)
    if wide:
        return torch.from_numpy(rng.integers(0, 1 << 33, n)).to(device)
    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        v = rng.integers(-50, 50, n)
        edges = [info.min, info.max, info.min + 1, info.max - 1, 0, -1]
        pick = rng.random(n) < 0.2
        v[pick] = np.array(edges)[rng.integers(0, len(edges), int(pick.sum()))]
        return torch.from_numpy(v).to(dtype).to(device)
    ibits = torch.int32 if dtype == torch.float32 else torch.int64
    v = torch.from_numpy(rng.integers(-50, 50, n) * 0.25).to(dtype)
    edges = torch.tensor([0.0, -0.0, float("inf"), float("-inf")],
                         dtype=dtype)
    nans = torch.tensor([b - (1 << 32) if dtype == torch.float32 and
                         b >= 1 << 31 else
                         b - (1 << 64) if b >= 1 << 63 else b
                         for b in NAN_BITS[dtype]],
                        dtype=ibits).view(dtype)
    pool = torch.cat([edges, nans])
    pick = torch.from_numpy(rng.random(n) < 0.3)
    which = torch.from_numpy(rng.integers(0, len(pool), n))
    return torch.where(pick, pool[which], v).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("n", (1, 4095, 4096, 4097, 100_003))
@pytest.mark.parametrize("mode", ("mixed", "all_dead", "one_live"))
@pytest.mark.parametrize("dtype", SORT_DTYPES, ids=str)
def test_radix_sort_matches_torch_sort(card, dtype, mode, n):
    """K12's radix sort against the stable torch.sort of its plain version,
    bit for bit: where -0.0, +0.0, +inf and each NaN land, at tile
    boundaries (4,096 rows), with every row dead and with one live row."""
    rng = np.random.default_rng(n + 3)
    vals = _radix_values(dtype, n, n, card)
    valid = None
    if mode == "mixed":
        alive = torch.from_numpy(rng.random(n) < 0.8).to(card)
        valid = torch.from_numpy(rng.random(n) < 0.9).to(card)
    else:
        alive = torch.zeros(n, dtype=torch.bool, device=card)
        if mode == "one_live":
            alive[n // 2] = True
    TC.reset_launches()
    s, n_live = TC.radix_sort_live(vals, valid, alive)
    assert TC.LAUNCHES["distinct_sort"] == 1
    ps, pn = TG._sorted_live_plain(vals, valid, alive)
    assert torch.equal(_bits(s), _bits(ps))
    assert int(n_live) == int(pn)


@pytest.mark.cuda
def test_radix_sort_wide_int64_matches_torch_sort(card):
    """int64 values of about 33 bits: five digit passes run, three are
    skipped on the device."""
    n = 1_000_003
    vals = _radix_values(torch.int64, n, 5, card, wide=True)
    alive = torch.from_numpy(np.random.default_rng(6).random(n) < 0.7).to(card)
    s, n_live = TC.radix_sort_live(vals, None, alive)
    ps, pn = TG._sorted_live_plain(vals, None, alive)
    assert torch.equal(s.cpu(), ps.cpu()) and int(n_live) == int(pn)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", SORT_DTYPES, ids=str)
def test_distinct_on_cuda_calls_no_torch_sort(card, dtype, monkeypatch):
    """distinct_count and dedup_values on CUDA tensors run the K12 radix
    sort and run starts, and neither torch.sort nor torch.unique."""
    n = 50_021
    vals = _radix_values(dtype, n, 9, card)
    alive = torch.from_numpy(np.random.default_rng(10).random(n) < 0.8).to(
        card)

    def refuse(*args, **kwargs):
        raise AssertionError("torch.sort or torch.unique on the CUDA path")
    TC.reset_launches()
    with monkeypatch.context() as mp:
        mp.setattr(torch, "sort", refuse)
        mp.setattr(torch, "unique", refuse)
        count = TG.distinct_count(vals, None, alive)
        s, mask = TG.dedup_values(vals, None, alive)
    assert TC.LAUNCHES == dict(dict.fromkeys(TC.LAUNCHES, 0),
                               distinct_sort=2, distinct_count=2)
    _same(count, TG.distinct_count_plain(vals, None, alive), 0.0)
    ps, pmask = TG.dedup_values_plain(vals, None, alive)
    _same(mask, pmask, 0.0)
    assert torch.equal(_bits(s), _bits(ps))


@pytest.mark.cuda
@pytest.mark.parametrize("nulls_first", (None, True, False), ids=str)
@pytest.mark.parametrize("asc", (True, False), ids=("asc", "desc"))
@pytest.mark.parametrize("dtype", SORT_DTYPES, ids=str)
def test_order_permutation_kernel_matches_plain(card, dtype, asc,
                                                nulls_first):
    rng = np.random.default_rng(79)
    n = 100_003
    keys = [_sort_values(dtype, n, 83, card, domain=30),
            _sort_values(torch.int32, n, 89, card, domain=7)]
    valids = [torch.from_numpy(rng.random(n) < 0.85).to(card), None]
    alive = torch.from_numpy(rng.random(n) < 0.9).to(card)
    args = (keys, valids, [asc, True], [nulls_first, None], alive)
    _same(TS.order_permutation(*args), TS.order_permutation_plain(*args), 0.0)


def _kv_keys(dtype, n, bits, seed, device):
    """Unsigned keys of `bits` random low bits (64: every bit), stored as
    the signed dtype, with many ties."""
    rng = np.random.default_rng(seed)
    width = 32 if dtype == torch.int32 else 64
    if bits >= width:
        u = rng.integers(0, 1 << 62, n, dtype=np.uint64) * 4 + \
            rng.integers(0, 4, n, dtype=np.uint64)
        u = u >> np.uint64(64 - width)
    else:
        u = rng.integers(0, 1 << bits, n, dtype=np.uint64)
    u = u.astype(np.uint32 if width == 32 else np.uint64)
    return torch.from_numpy(u.view(np.int32 if width == 32
                                   else np.int64)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("payload", (False, True))
@pytest.mark.parametrize("bits", (1, 12, 26, 33, 64))
@pytest.mark.parametrize("n", (1, 3071, 3072, 100_003))
@pytest.mark.parametrize("dtype", (torch.int32, torch.int64), ids=str)
def test_kv_sort_matches_torch_sort(card, dtype, n, bits, payload):
    """The key-value radix sort that K8 and K13 share against torch.sort
    (stable) of its unsigned keys: the keys and the payload that travels
    with each, at tile edges (2,048 and 3,072 records) and at every width,
    digits skipped on the device where they do not vary."""
    keys = _kv_keys(dtype, n, bits, n + bits, card)
    vals = torch.from_numpy(np.random.default_rng(bits).integers(
        -2**31, 2**31 - 1, n).astype(np.int32)).to(card) if payload else None
    got_k, got_v = TC.kv_sort(keys, vals)
    sign = -2**31 if dtype == torch.int32 else -2**63
    order = torch.sort(keys ^ sign, stable=True).indices
    assert torch.equal(got_k, keys[order])
    want_v = order.to(torch.int32) if vals is None else vals[order]
    assert torch.equal(got_v, want_v)


@pytest.mark.cuda
def test_kv_sort_at_zero_rows(card):
    for dtype in (torch.int32, torch.int64):
        keys, vals = TC.kv_sort(torch.zeros(0, dtype=dtype, device=card),
                                None)
        assert keys.shape == (0,) and vals.shape == (0,)


def _k8_build(device, n_keys, per_key, skew_rows=0, seed=101):
    """An orderkey-like build (1..2 per_key lines a key, every 4th key) with
    int32 values, 63 % live, the probe drawn from the build's keys and from
    keys below, between and above them; skew_rows more live rows on one
    key."""
    rng = np.random.default_rng(seed)
    lines = rng.integers(1, 2 * per_key, n_keys)
    key = np.repeat(np.arange(1, n_keys + 1) * 4, lines)
    if skew_rows:
        key = np.concatenate([key, np.full(skew_rows, 4 * (n_keys // 2))])
    alive = rng.random(len(key)) < 0.63
    if skew_rows:
        alive[-skew_rows:] = True
    perm = rng.permutation(len(key))
    key, alive = key[perm], alive[perm]
    val = rng.integers(1, 100_001, len(key)).astype(np.int32)
    n_probe = 3 * len(key) // 2
    pkey = key[rng.integers(0, len(key), n_probe)]
    odd = rng.random(n_probe) < 0.2
    pkey[odd] = rng.integers(-10, 4 * n_keys + 10, int(odd.sum()))
    pkey[:4] = [np.iinfo(np.int64).max, np.iinfo(np.int64).min, 0,
                4 * n_keys + 4]
    palive = rng.random(n_probe) < 0.9
    pval = val[rng.integers(0, len(val), n_probe)]
    return [torch.from_numpy(a).to(device)
            for a in (key, alive, val, pkey, palive, pval)]


K8_OPS = ("<>", "<", "<=", ">", ">=", "stats")


def _k8_same(card, op, bkey, balive, bval, pkey, palive, pval):
    if op == "stats":
        got = TJ.merge_stats_probe(bkey, balive, bval, pkey, palive)
        want = TJ.merge_stats_probe_plain(bkey, balive, bval, pkey, palive)
    else:
        got = (TJ.merge_cmp_probe(bkey, balive, bval, pkey, palive, pval,
                                  op),)
        want = (TJ.merge_cmp_probe_plain(bkey, balive, bval, pkey, palive,
                                         pval, op),)
    for g, w in zip(got, want):
        _same(g, w, 0.0)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("op", K8_OPS)
@pytest.mark.parametrize("shape", ("q21", "skewed"))
def test_run_stats_probe_redesign_matches_plain(card, shape, op):
    """K8 exactly as its plain version in both modes: Q21's shape (1-7 rows
    a key, runs across K8's 2,048-row tiles) at 1 M keys, and a build
    where one key holds 2 M live rows (a run across a thousand tiles)."""
    args = _k8_build(card, 1_000_000 if shape == "q21" else 100_000, 4,
                     skew_rows=0 if shape == "q21" else 2_000_000)
    got = _k8_same(card, op, *args)
    assert 0 < int(got[0].sum()) < len(args[3])


@pytest.mark.cuda
@pytest.mark.parametrize("op", K8_OPS)
@pytest.mark.parametrize("case", ("extremes", "no_live_build", "wide",
                                  "one_run", "tiny"))
def test_run_stats_probe_edges_match_plain(card, case, op):
    """K8's range compression at its edges: build keys at INT64_MIN and
    next to INT64_MAX (codes spanning all 64 bits), a live INT64_MAX key
    (which no probe may match), no live build row, one run holding every
    live row, and three rows."""
    rng = np.random.default_rng(7)
    n = 50_000
    big = np.iinfo(np.int64)
    if case == "extremes":
        key = rng.integers(-3, 3, n) + np.where(rng.random(n) < 0.5,
                                                big.min + 3, big.max - 3)
        key[5] = big.max
    elif case == "wide":
        key = rng.integers(big.min, big.max, n) // 1024 * 1024
    else:
        key = rng.integers(0, 300, n) * 7
    alive = rng.random(n) < 0.7
    if case == "no_live_build":
        alive[:] = False
    if case == "one_run":
        key[alive] = 42
    key = key[:3] if case == "tiny" else key
    alive = alive[:3] if case == "tiny" else alive
    val = rng.integers(-5, 5, len(key)).astype(np.int32)
    pkey = np.concatenate([key, rng.integers(-10, 2_200, 1000),
                           [big.max, big.min, 0, 42]])
    pkey = pkey[rng.permutation(len(pkey))]
    palive = rng.random(len(pkey)) < 0.9
    pval = rng.integers(-6, 6, len(pkey)).astype(np.int32)
    _k8_same(card, op, *[torch.from_numpy(np.asarray(a)).to(card)
                         for a in (key, alive, val, pkey, palive, pval)])


@pytest.mark.cuda
def test_run_stats_probe_with_no_probe_rows(card):
    """A build under an empty probe side launches nothing."""
    bkey, balive, bval, pkey, palive, pval = _k8_build(card, 1000, 4)
    TC.reset_launches()
    got = TJ.merge_stats_probe(bkey, balive, bval, pkey[:0], palive[:0])
    want = TJ.merge_stats_probe_plain(bkey, balive, bval, pkey[:0],
                                      palive[:0])
    for g, w in zip(got, want):
        _same(g, w, 0.0)
    assert not any(TC.LAUNCHES.values())


@pytest.mark.cuda
@pytest.mark.parametrize("n_keys", (1, 3, 5))
def test_order_permutation_redesign_matches_plain(card, n_keys):
    """K13 bit for bit at 1 to 5 keys of every dtype, with NaN, -0.0, +inf
    and NULL keys, ASC and DESC, NULLS FIRST and LAST, and dead rows."""
    rng = np.random.default_rng(n_keys)
    n = 200_003
    dtypes = (torch.float64, torch.int32, torch.int64, torch.float32,
              torch.bool)[:n_keys]
    keys = [_radix_values(dt, n, 11 + i, card) for i, dt in
            enumerate(dtypes)]
    valids = [torch.from_numpy(rng.random(n) < 0.8).to(card) if i % 2 == 0
              else None for i in range(n_keys)]
    asc = [bool(i % 2) for i in range(n_keys)]
    nf = [(None, True, False)[i % 3] for i in range(n_keys)]
    alive = torch.from_numpy(rng.random(n) < 0.9).to(card)
    args = (keys, valids, asc, nf, alive)
    _same(TS.order_permutation(*args), TS.order_permutation_plain(*args), 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ("smoke", "wide", "all_null", "all_dead",
                                  "ties"))
def test_order_permutation_chain_cases_match_plain(card, case):
    """K13 at the smoke's three keys (a DOUBLE DESC of 2 decimals, a
    nullable INT of 1..50, an int64 permutation tiebreak; 95 % live), at
    int64 keys spanning all 64 bits beside a double of every bit pattern
    (more than 128 significant bits), with every row NULL, every row dead,
    and one value in every row."""
    gen = torch.Generator(device=card)
    gen.manual_seed(3)
    n = 500_003
    alive = torch.rand(n, device=card, generator=gen) < 0.95
    if case == "smoke":
        keys = [torch.randint(90_000, 10_500_000, (n,), device=card,
                              generator=gen).double() / 100,
                torch.randint(1, 51, (n,), device=card, generator=gen,
                              dtype=torch.int32),
                torch.randperm(n, device=card, generator=gen)]
        valids = [None, torch.rand(n, device=card, generator=gen) < 0.9,
                  None]
        asc, nf = [False, True, True], [None, None, None]
    elif case == "wide":
        bits = torch.randint(-2**63, 2**63 - 1, (n,), device=card,
                             generator=gen)
        keys = [bits.view(torch.float64), bits.flip(0),
                torch.randint(-2**63, 2**63 - 1, (n,), device=card,
                              generator=gen)]
        valids = [None, torch.rand(n, device=card, generator=gen) < 0.9,
                  None]
        asc, nf = [True, False, True], [None, True, False]
    else:
        keys = [torch.full((n,), 7, dtype=torch.int64, device=card),
                torch.zeros(n, dtype=torch.float32, device=card)]
        none = torch.zeros(n, dtype=torch.bool, device=card)
        valids = [none, None] if case == "all_null" else [None, None]
        asc, nf = [True, False], [True, None]
        if case == "all_dead":
            alive = none
    args = (keys, valids, asc, nf, alive)
    _same(TS.order_permutation(*args), TS.order_permutation_plain(*args), 0.0)


@pytest.mark.cuda
def test_k8_k13_on_cuda_call_no_torch_sort(card, monkeypatch):
    """K8 and K13 on CUDA tensors run no torch.sort (nor any sort of the
    library) and no plain version."""
    bkey, balive, bval, pkey, palive, pval = _k8_build(card, 10_000, 4)
    keys = [pkey, pval]

    def refuse(*args, **kwargs):
        raise AssertionError("a library sort or a plain version on the "
                             "CUDA path")
    with monkeypatch.context() as mp:
        for name in ("sort", "argsort", "unique", "searchsorted"):
            mp.setattr(torch, name, refuse)
        for name in ("merge_stats_probe_plain", "merge_cmp_probe_plain",
                     "sorted_build"):
            mp.setattr(TJ, name, refuse)
        mp.setattr(TS, "order_permutation_plain", refuse)
        got = (TJ.merge_cmp_probe(bkey, balive, bval, pkey, palive, pval,
                                  "<>"),
               *TJ.merge_stats_probe(bkey, balive, bval, pkey, palive),
               TS.order_permutation(keys, [None, None], [True, False],
                                    [None, None], palive))
    want = (TJ.merge_cmp_probe_plain(bkey, balive, bval, pkey, palive, pval,
                                     "<>"),
            *TJ.merge_stats_probe_plain(bkey, balive, bval, pkey, palive),
            TS.order_permutation_plain(keys, [None, None], [True, False],
                                       [None, None], palive))
    for g, w in zip(got, want):
        _same(g, w, 0.0)


@pytest.mark.cuda
def test_k10_to_k13_launches_are_counted(card):
    build, probe, balive, palive = _oa_sides(torch.int64, 2, False, card)
    vals = _sort_values(torch.float64, len(palive), 97, card)
    TC.reset_launches()
    TK.hash_keys(build)
    table, _ = TJ.oa_build(build, balive, TK.next_pow2(2 * len(balive)))
    TJ.oa_probe(table, build, probe, palive)
    TG.distinct_count(vals, None, palive)
    TS.order_permutation([vals, probe[0]], [None, None], [False, True],
                         [None, None], palive)
    TK.hash_keys_plain(build)
    TG.distinct_count_plain(vals, None, palive)
    # open addressing hashes its keys inside its own kernels
    assert TC.LAUNCHES == dict(dict.fromkeys(TC.LAUNCHES, 0), hash_keys=1,
                               open_addressing=2, distinct_sort=1,
                               distinct_count=1, order_permutation=1)


def test_k10_to_k13_wrappers_reject_cpu_tensors():
    x = torch.arange(4, dtype=torch.int64)
    flags = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="needs CUDA"):
        TC.hash_keys([x])
    with pytest.raises(ValueError, match="needs CUDA"):
        TC.oa_build([x], flags, 8)
    with pytest.raises(ValueError, match="needs CUDA"):
        TC.run_starts(x, torch.tensor(4), True)
    with pytest.raises(ValueError, match="needs CUDA"):
        TC.order_permutation([x], [None], [True], [None], flags)
    with pytest.raises(ValueError, match="needs CUDA"):
        TC.kv_sort(x, None)


def test_k10_to_k13_public_functions_take_plain_versions_on_cpu():
    build, probe, balive, palive = _oa_sides(torch.int32, 2, True, "cpu",
                                             n_build=500, n_probe=700)
    TC.reset_launches()
    TK.hash_keys(build)
    table, _ = TJ.oa_build(build, balive, 1024)
    TJ.oa_probe(table, build, probe, palive)
    TG.distinct_count(probe[0], None, palive)
    TG.dedup_values(probe[0], None, palive)
    TS.order_permutation([probe[0]], [None], [False], [None], palive)
    assert not any(TC.LAUNCHES.values()), TC.LAUNCHES


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(TC.LAUNCHES))
def test_kernel_at_zero_rows(card, kernel):
    """An empty input (an empty build side under a few probe rows for the
    join kernels) launches nothing and gives the plain version's result."""
    kernel_fn, plain_fn = zero_row_cases(card)[kernel]
    TC.reset_launches()
    got = kernel_fn()
    torch.cuda.synchronize()
    assert not any(TC.LAUNCHES.values()), TC.LAUNCHES
    want = plain_fn()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same(g, w, 0.0)


# ---------------------------------------------------------------------
# K14 radix partition, K15 bucket scatter, K16 bloom filter
# ---------------------------------------------------------------------
from quickstep_tpu_torch.parallel import shuffle as TSH  # noqa: E402


def _part_inputs(dtype, device, n=100_003, seed=61, live=0.95, hot=0.0):
    rng = np.random.default_rng(seed)
    if dtype == torch.int32:
        keys = rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64)
    else:
        keys = rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64)
    keys = np.where(rng.random(n) < hot, keys[0], keys)
    key = torch.from_numpy(keys).to(dtype).to(device)
    alive = torch.from_numpy(rng.random(n) < live).to(device)
    return key, alive


@pytest.mark.cuda
@pytest.mark.parametrize("salt,probe_side", [(1, True), (2, True), (4, True),
                                             (2, False), (4, False)])
@pytest.mark.parametrize("n_parts", (2, 3, 8, 1000))
@pytest.mark.parametrize("dtype", (torch.int32, torch.int64), ids=str)
def test_partition_dest_kernel_matches_plain(card, dtype, n_parts, salt,
                                             probe_side):
    key, alive = _part_inputs(dtype, card)
    n = key.shape[0]
    cap = -(-2 * n * salt // n_parts)
    got = TSH.partition_dest(key, alive, n_parts, cap, salt, probe_side)
    want = TSH.partition_dest_plain(key, alive, n_parts, cap, salt,
                                    probe_side)
    for g, w in zip(got, want):
        _same(g, w, 0.0)
    assert not bool(got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("hot", (0.0, 0.4))
def test_partition_dest_kernel_overflows_like_plain(card, hot):
    key, alive = _part_inputs(torch.int64, card, hot=hot)
    n = key.shape[0]
    cap = n // 8 + (0 if hot else -500)   # a hot key, or too small buckets
    got = TSH.partition_dest(key, alive, 8, cap)
    want = TSH.partition_dest_plain(key, alive, 8, cap)
    for g, w in zip(got, want):
        _same(g, w, 0.0)
    assert bool(got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES + (torch.bool,), ids=str)
def test_scatter_compact_kernel_matches_plain(card, dtype):
    key, alive = _part_inputs(torch.int64, card)
    n = key.shape[0]
    dest, _ = TSH.partition_dest(key, alive, 8, n // 4)
    slots = 8 * (n // 4)          # dropped rows point at slots itself
    col = torch.arange(n, device=card).to(dtype) if dtype != torch.bool \
        else alive
    fill = -1 if dtype != torch.bool else True
    for d in (dest, dest.long()):
        _same(TK.scatter_compact(col, d, slots, fill=fill),
              TK.scatter_compact_plain(col, d, slots, fill=fill), 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("ncols", (1, 3))
def test_bloom_kernels_match_plain(card, ncols):
    rng = np.random.default_rng(71)
    build = [torch.from_numpy(rng.integers(0, 10 ** 6, 50_000)).to(card)
             for _ in range(ncols)]
    probe = [torch.from_numpy(rng.integers(0, 10 ** 6, 200_003)).to(card)
             for _ in range(ncols)]
    if ncols == 3:
        build[1], probe[1] = build[1].int(), probe[1].int()
    balive = torch.from_numpy(rng.random(50_000) < 0.7).to(card)
    palive = torch.from_numpy(rng.random(200_003) < 0.9).to(card)
    for nbits in (1024, 1 << 22):
        # on the card the table is K16's int32 words, a bit a slot
        words = TB.bloom_build(build, balive, nbits)
        bits = TB.bloom_build_plain(build, balive, nbits)
        _same(TB.presence_bits(words, nbits), bits, 0.0)
        _same(TB.bloom_probe(words, probe, palive, nbits),
              TB.bloom_probe_plain(bits, probe, palive), 0.0)


@pytest.mark.cuda
def test_k14_to_k16_launches_are_counted(card):
    key, alive = _part_inputs(torch.int64, card, n=10_000)
    TC.reset_launches()
    dest, _ = TSH.partition_dest(key, alive, 8, 5_000, 2, False)
    TK.scatter_compact(dest, dest, 40_000)
    bits = TB.bloom_build([key], alive, 1024)
    TB.bloom_probe(bits, [key], alive)
    TSH.partition_dest_plain(key, alive, 8, 5_000)
    TK.scatter_compact_plain(dest, dest, 40_000)
    assert TC.LAUNCHES == dict(dict.fromkeys(TC.LAUNCHES, 0),
                               partition_dest=1, scatter_compact=1,
                               bloom_filter=2)


def test_k14_to_k16_wrappers_reject_cpu_tensors():
    key = torch.arange(4, dtype=torch.int64)
    alive = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="needs CUDA"):
        TC.partition_dest(key, alive, 8, 4)
    with pytest.raises(ValueError, match="needs CUDA"):
        TC.scatter_compact(key, key, 8)
    with pytest.raises(ValueError, match="needs CUDA"):
        TC.bloom_build([key], alive, 8)
    with pytest.raises(ValueError, match="needs CUDA"):
        TC.bloom_probe(alive, [key], alive)


def test_k14_to_k16_public_functions_take_plain_versions_on_cpu():
    key, alive = _part_inputs(torch.int64, "cpu", n=1000)
    TC.reset_launches()
    dest, _ = TSH.partition_dest(key, alive, 8, 500, 2, True)
    TK.scatter_compact(dest, dest, 4000)
    TB.bloom_probe(TB.bloom_build([key], alive, 64), [key], alive)
    assert not any(TC.LAUNCHES.values()), TC.LAUNCHES


# ---------------------------------------------------------------------
# K3's bitmap and K7's fence (the redesigned kernels)
# ---------------------------------------------------------------------

@pytest.fixture(params=("table", "bitmap"))
def k3_route(request, monkeypatch):
    """K3's layout forced for every domain: the row table alone, or the row
    table with the presence bitmap behind it."""
    monkeypatch.setattr(TC, "DIRECT_BITMAP_SLOTS",
                        2 ** 62 if request.param == "table" else 0)
    return request.param


def _k3_inputs(key_dtype, domain, dups, device, n_probe=50_003, seed=61):
    """Unique build keys over the domain and 3 slots each side of it (dead
    rows ~20%, the domain's first key live), one live key twice when
    `dups`; probe keys over 10 more slots each side."""
    rng = np.random.default_rng(seed + domain)
    lo = 1_000
    bkey = rng.permutation(domain + 6)[:max(1, (domain + 6) // 2)] + lo - 3
    balive = rng.random(len(bkey)) < 0.8
    if lo not in bkey:            # a live key in a domain of one slot
        bkey[0] = lo
    balive[np.nonzero(bkey == lo)[0][0]] = True
    if dups:
        inside = int(np.nonzero((bkey >= lo) & (bkey < lo + domain))[0][0])
        bkey = np.concatenate([bkey, bkey[inside:inside + 1]])
        balive = np.concatenate([balive, [True]])
        balive[inside] = True
    pkey = rng.integers(lo - 10, lo + domain + 10, n_probe)
    palive = rng.random(n_probe) < 0.8
    t = [torch.from_numpy(a).to(device) for a in (bkey, balive, pkey, palive)]
    t[0], t[2] = t[0].to(key_dtype), t[2].to(key_dtype)
    return t + [lo]


@pytest.mark.cuda
@pytest.mark.parametrize("offset", (0, 1), ids=("aligned", "unaligned"))
@pytest.mark.parametrize("dups", (False, True), ids=("unique", "dups"))
@pytest.mark.parametrize("domain", (1, 31, 32, 33, 100_003))
@pytest.mark.parametrize("key_dtype", (torch.int32, torch.int64), ids=str)
def test_direct_join_layouts_match_plain(card, k3_route, key_dtype, domain,
                                         dups, offset):
    """Both layouts, bit for bit: the decoded table and the dup flag, and
    the probe (by vectors of four rows, or one row at a time where the
    probe's buffers start off a 16-byte boundary)."""
    bkey, balive, pkey, palive, lo = _k3_inputs(key_dtype, domain, dups,
                                                card)
    table, dup = TJ.direct_build(bkey, balive, lo, domain)
    extra = TC.bitmap_words(domain) if k3_route == "bitmap" else 0
    assert table.shape == (domain + extra,)
    want_table, want_dup = TJ.direct_build_plain(bkey, balive, lo, domain)
    assert bool(dup) == bool(want_dup) == dups
    slots = TJ.direct_table(table, domain)
    if not dups:
        _same(slots, want_table, 0.0)
    else:
        assert (slots != want_table).sum() <= 1
    if extra:
        _same(TB.presence_bits(table[domain:], domain), slots >= 0, 0.0)
    pkey, palive = pkey[offset:], palive[offset:]
    got = TJ.direct_probe(table, pkey, palive, lo, domain)
    want = TJ.direct_probe_plain(slots, pkey, palive, lo, domain)
    for g, w in zip(got, want):
        _same(g, w, 0.0)
    assert 0 < int(got[1].sum()) < len(pkey)


@pytest.mark.cuda
def test_direct_join_at_the_domain_limit(card):
    """2^27 slots (config.direct_join_domain_limit): the route rule takes
    the bitmap, 16.8 MB behind a 512 MB table."""
    domain, lo = 1 << 27, 7
    assert TC.direct_route(domain) == TC.DIRECT_TABLE_BITS
    gen = torch.Generator(device=card)
    gen.manual_seed(67)
    bkey = torch.randperm(domain, device=card, generator=gen)[:1_000_000]
    bkey = bkey + lo
    balive = torch.rand(len(bkey), device=card, generator=gen) < 0.8
    pkey = torch.randint(0, domain + 20, (2_000_003,), device=card,
                         generator=gen)
    palive = torch.rand(len(pkey), device=card, generator=gen) < 0.8
    table, dup = TJ.direct_build(bkey, balive, lo, domain)
    assert table.shape == (domain + TC.bitmap_words(domain),) and not dup
    want_table, _ = TJ.direct_build_plain(bkey, balive, lo, domain)
    slots = TJ.direct_table(table, domain)
    _same(slots, want_table, 0.0)
    for g, w in zip(TJ.direct_probe(table, pkey, palive, lo, domain),
                    TJ.direct_probe_plain(slots, pkey, palive, lo, domain)):
        _same(g, w, 0.0)
    words = TB.exact_filter_build(bkey, balive, lo, domain)
    _same(TB.presence_bits(words, domain), want_table >= 0, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_build, n_probe", ((0, 5), (5, 0), (0, 0)))
def test_direct_join_layouts_at_zero_rows(card, k3_route, n_build, n_probe):
    key = torch.arange(n_build, dtype=torch.int32, device=card) + 4
    probe = torch.arange(n_probe, dtype=torch.int32, device=card) + 4
    alive = torch.ones(n_build, dtype=torch.bool, device=card)
    palive = torch.ones(n_probe, dtype=torch.bool, device=card)
    TC.reset_launches()
    table, dup = TJ.direct_build(key, alive, 4, 40)
    got = TJ.direct_probe(table, probe, palive, 4, 40)
    assert TC.LAUNCHES["direct_join"] == (n_build > 0) + (n_probe > 0)
    want_table, want_dup = TJ.direct_build_plain(key, alive, 4, 40)
    _same(TJ.direct_table(table, 40), want_table, 0.0)
    _same(dup, want_dup, 0.0)
    for g, w in zip(got, TJ.direct_probe_plain(want_table, probe, palive, 4,
                                               40)):
        _same(g, w, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("domain", (1, 31, 32, 33, 100_003))
@pytest.mark.parametrize("key_dtype", (torch.int32, torch.int64), ids=str)
def test_exact_filter_bitmap_matches_plain(card, key_dtype, domain):
    """The presence bitmap alone, over a build that repeats every key four
    times (by design: semi-join builds)."""
    bkey, balive, pkey, palive, lo = _k3_inputs(key_dtype, domain, False,
                                                card)
    bkey, balive = bkey.repeat(4), balive.repeat(4)
    words = TB.exact_filter_build(bkey, balive, lo, domain)
    assert words.dtype == torch.int32
    assert words.shape == (TC.bitmap_words(domain),)
    bits = TB.exact_filter_build_plain(bkey, balive, lo, domain)
    _same(TB.presence_bits(words, domain), bits, 0.0)
    _same(words, TB.presence_words(bits), 0.0)
    for offset in (0, 3):
        _same(TB.exact_filter_probe(words, pkey[offset:], palive[offset:],
                                    lo),
              TB.exact_filter_probe_plain(bits, pkey[offset:],
                                          palive[offset:], lo), 0.0)


def test_direct_probe_refuses_a_buffer_of_another_domain():
    key = torch.arange(4, dtype=torch.int32)
    alive = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="needs CUDA"):
        TC.direct_probe(torch.full((4,), -1, dtype=torch.int32), key, alive,
                        0, 4)
    with pytest.raises(ValueError, match="needs CUDA"):
        TC.direct_probe(torch.zeros(1, dtype=torch.int32), key, alive, 0,
                        presence=True)


@pytest.mark.cuda
def test_direct_probe_refuses_a_buffer_of_another_domain_on_card(card):
    key = torch.arange(4, dtype=torch.int32, device=card)
    alive = torch.ones(4, dtype=torch.bool, device=card)
    table, _ = TC.direct_build(key, alive, 0, 64)
    with pytest.raises(ValueError, match="no direct table"):
        TC.direct_probe(table, key, alive, 0, 65)
    with pytest.raises(ValueError, match="no direct table"):
        TC.direct_probe(table, key, alive, 0)


def _fence_inputs(n_build, device, seed=71, n_probe=20_011):
    """Build keys in runs of 1-20 rows (runs cross leaves and fence lines),
    shuffled, ~10% dead; probe keys on the runs, between them, below the
    first and above the last key, and INT64_MAX; ~15% dead."""
    rng = np.random.default_rng(seed + n_build)
    runs = rng.integers(1, 21, n_build)
    ends = np.cumsum(runs)
    m = int(np.searchsorted(ends, n_build)) + 1
    runs = runs[:m]
    runs[-1] -= ends[m - 1] - n_build
    base = np.cumsum(rng.integers(2, 5, m)) * 1_000_003
    bkey = rng.permutation(np.repeat(base, runs))
    balive = rng.random(n_build) < 0.9
    pkey = np.concatenate([rng.choice(base, n_probe), base[:50] + 1,
                           [base[0] - 1, base[-1] + 1,
                            np.iinfo(np.int64).max]])
    palive = rng.random(len(pkey)) < 0.85
    palive[-3:] = True
    return [torch.from_numpy(a.astype(dt)).to(device) for a, dt in
            ((bkey, np.int64), (balive, bool), (pkey, np.int64),
             (palive, bool))]


@pytest.mark.cuda
@pytest.mark.parametrize("k", (1, 2, 4, 16))
@pytest.mark.parametrize("n_build", (1, 3, 4, 5, 7, 8, 9, 300, 32_768,
                                     32_769, 131_073, 2_000_003))
def test_expand_probe_fence_matches_plain(card, n_build, k):
    """Builds of one leaf (4 keys) or less, of whole and partial leaves, of
    a top level that fills the shared memory (4 x 8,192 rows), of one level
    more (32,769 rows), two more (131,073) and four more (2 M); every K the
    executor asks for, with runs longer than K (the overflow flag and an
    exact count)."""
    bkey, balive, pkey, palive = _fence_inputs(n_build, card)
    sorted_key, order = TJ.sorted_build(bkey, balive)
    got = TJ.expand_probe(sorted_key, order, pkey, palive, k)
    want = TJ.expand_probe_plain(sorted_key, order, pkey, palive, k)
    for g, w in zip(got, want):
        _same(g, w, 0.0)
    counts = got[1].cpu()
    assert counts[-3:].tolist() == [0, 0, 0]
    if n_build >= 300:
        assert int((counts > 0).sum()) > 1000
    if n_build >= 32_768:
        assert bool(got[2]) and int(counts.max()) > k


@pytest.mark.cuda
@pytest.mark.parametrize("n_build, n_probe", ((0, 5), (5, 0), (0, 0)))
def test_expand_probe_fence_at_zero_rows(card, n_build, n_probe):
    key = torch.arange(n_build, dtype=torch.int64, device=card)
    probe = torch.arange(n_probe, dtype=torch.int64, device=card)
    sorted_key, order = TJ.sorted_build(
        key, torch.ones(n_build, dtype=torch.bool, device=card))
    palive = torch.ones(n_probe, dtype=torch.bool, device=card)
    TC.reset_launches()
    got = TJ.expand_probe(sorted_key, order, probe, palive, 4)
    assert TC.LAUNCHES["expand_probe"] == int(n_build > 0 and n_probe > 0)
    for g, w in zip(got, TJ.expand_probe_plain(sorted_key, order, probe,
                                               palive, 4)):
        _same(g, w, 0.0)


@pytest.mark.cuda
def test_direct_and_expand_kernels_take_no_torch_search(card, monkeypatch):
    """On CUDA tensors K3 and K7 search, sort and gather in their own
    kernels: torch.searchsorted, torch.sort and index_select raise."""
    bkey, balive, pkey, palive = _fence_inputs(40_000, card)
    sorted_key, order = TJ.sorted_build(bkey, balive)
    want = TJ.expand_probe_plain(sorted_key, order, pkey, palive, 4)
    k3 = _k3_inputs(torch.int32, 100_003, False, card)

    def boom(*args, **kwargs):
        raise AssertionError("a torch search, sort or gather ran")
    for name in ("searchsorted", "sort", "index_select"):
        monkeypatch.setattr(torch, name, boom)
    monkeypatch.setattr(torch.Tensor, "index_select", boom)
    got = TJ.expand_probe(sorted_key, order, pkey, palive, 4)
    bkey3, balive3, pkey3, palive3, lo = k3
    table, _ = TJ.direct_build(bkey3, balive3, lo, 100_003)
    probe3 = TJ.direct_probe(table, pkey3, palive3, lo, 100_003)
    monkeypatch.undo()
    for g, w in zip(got, want):
        _same(g, w, 0.0)
    for g, w in zip(probe3, TJ.direct_probe_plain(
            TJ.direct_table(table, 100_003), pkey3, palive3, lo, 100_003)):
        _same(g, w, 0.0)


# ---------------------------------------------------------------------
# K4 on the fence, K5 by tiles, at the SF10 shapes of
# quickstep_tpu_torch/bench/kernel_ab.py
# ---------------------------------------------------------------------
from quickstep_tpu_torch.bench import kernel_ab as AB  # noqa: E402

N_SF10 = 60_000_000


def _gen(card, seed):
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    return gen


@pytest.mark.cuda
@pytest.mark.parametrize("dups", (False, True), ids=("unique", "dups"))
@pytest.mark.parametrize("shape", ("q5", "q9"))
def test_sorted_probe_fence_at_sf10(card, shape, dups):
    """K4 at 100 K build keys (Q5's) and at 8 M (Q9's partsupp), 60 M probe
    rows; with dups, runs of two and three equal live keys: the matched row
    is the first of the run in stable order. (row, matched, dup) equal the
    plain version's bit for bit."""
    gen = _gen(card, 91)
    bkey, balive, pkey, palive = AB.unique_probe_inputs(shape, N_SF10, card,
                                                        gen)
    if dups:
        bkey = bkey.clone()
        bkey[7], bkey[8] = bkey[3], bkey[3]
        bkey[len(bkey) // 2] = bkey[-1]
        balive = balive.clone()
        balive[[3, 7, 8, len(bkey) // 2, len(bkey) - 1]] = True
        pkey = pkey.clone()
        pkey[:4] = bkey[[3, 3, len(bkey) - 1, 5]]
    got = TJ.merge_unique_probe(bkey, balive, pkey, palive)
    want = TJ.merge_unique_probe_plain(bkey, balive, pkey, palive)
    for g, w in zip(got, want):
        _same(g, w, 0.0)
    assert bool(got[2]) == dups
    assert int(got[1].sum()) > (N_SF10 // 2 if shape == "q9" else 1000)


@pytest.mark.cuda
@pytest.mark.parametrize("n_build, n_probe", ((0, 5), (5, 0), (0, 0)))
def test_sorted_probe_fence_at_zero_rows(card, n_build, n_probe):
    """No launch over an empty build side; an empty probe side runs the
    first launch alone, for the dup flag."""
    key = torch.tensor([3, 1, 3, 2, 9][:n_build], dtype=torch.int64,
                       device=card)
    probe = torch.arange(n_probe, dtype=torch.int64, device=card)
    balive = torch.ones(n_build, dtype=torch.bool, device=card)
    palive = torch.ones(n_probe, dtype=torch.bool, device=card)
    TC.reset_launches()
    got = TJ.merge_unique_probe(key, balive, probe, palive)
    assert TC.LAUNCHES["merge_unique_probe"] == int(n_build > 0)
    for g, w in zip(got, TJ.merge_unique_probe_plain(key, balive, probe,
                                                     palive)):
        _same(g, w, 0.0)
    assert bool(got[2]) == (n_build > 0)


def _segment_values(dtype, n, card, gen, dyadic):
    """Values of one dtype in original row order; floats in [0, 1000), or
    with dyadic multiples of 1/4 (every partial sum exact in float64);
    int32 and float32 nullable (90 % valid)."""
    if dtype.is_floating_point:
        v = torch.rand(n, device=card, generator=gen, dtype=torch.float64)
        v = v * 1000
        if dyadic:
            v = torch.floor(v * 4) / 4
        v = v.to(dtype)
    else:
        v = torch.randint(-10**6, 10**6, (n,), device=card, generator=gen,
                          dtype=dtype)
    valid = None
    if dtype in (torch.int32, torch.float32):
        valid = torch.rand(n, device=card, generator=gen) < 0.9
    return v, valid


def _float_sum_atol(change, s_alive, last, perm, v, valid, count):
    """Per-group tolerance of a float sum over m live rows: (eps(dtype) +
    (m - 1) eps(float64)) x the group's sum of live magnitudes, at its last
    row. Both versions add in float64 and round to the dtype once, the
    kernel in its tile tree, the plain version by atomics in no fixed
    order; two orders of m float64 additions differ by at most (m - 1)
    eps(float64) x the sum of magnitudes (Higham, Accuracy and Stability of
    Numerical Algorithms, 4.2), which for one group of 60 M rows exceeds
    rel 1e-12."""
    mag, _ = TG._segment_reduce_plain("sum", change, s_alive, last, perm,
                                      v.abs(), valid)
    m = torch.clamp(count.double() - 1, min=0)
    return (torch.finfo(v.dtype).eps + m * torch.finfo(torch.float64).eps) \
        * mag.double()


@pytest.fixture(scope="module")
def segment_shapes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card = torch.device("cuda")
    return {shape: AB.segment_inputs(shape, N_SF10, card, _gen(card, i))
            for i, shape in enumerate(AB.SEGMENT_SHAPES)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("fn", ("sum", "count", "min", "max"))
@pytest.mark.parametrize("shape", tuple(AB.SEGMENT_SHAPES))
def test_segment_reduce_tiles_at_sf10(card, segment_shapes, shape, fn,
                                      dtype):
    """K5 over 60 M rows: about 15 M groups, Q9's 175 groups over 5.4 % live
    rows, one group of every row. Counts, integer sums, MIN and MAX equal
    the plain version's exactly; float sums within _float_sum_atol (the
    worst case of two orders of addition); a second run is identical bit
    for bit."""
    change, s_alive, perm, last = segment_shapes[shape]
    v, valid = _segment_values(dtype, N_SF10, card, _gen(card, 7), False)
    got = TC.segment_reduce(fn, change, s_alive, perm, v, valid)
    want = TG._segment_reduce_plain(fn, change, s_alive, last, perm, v,
                                    valid)
    _same(got[1], want[1], 0.0)
    if fn == "sum" and dtype.is_floating_point:
        assert got[0].dtype == want[0].dtype
        err = (got[0].double() - want[0].double()).abs()
        atol = _float_sum_atol(change, s_alive, last, perm, v, valid, got[1])
        assert bool(torch.all(err <= atol)), float((err - atol).max())
    else:
        _same(got[0], want[0], 0.0)
    again = TC.segment_reduce(fn, change, s_alive, perm, v, valid)
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    assert int(torch.count_nonzero(got[1])) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.float64), ids=str)
@pytest.mark.parametrize("shape", tuple(AB.SEGMENT_SHAPES))
def test_segment_reduce_exact_float_sums(card, segment_shapes, shape, dtype):
    """Float values in multiples of 1/4 below 1000: every partial sum is
    exact in float64, so any order of addition gives the same bits, and K5
    equals the plain version bit for bit, a 60 M-row group included."""
    change, s_alive, perm, last = segment_shapes[shape]
    v, valid = _segment_values(dtype, N_SF10, card, _gen(card, 8), True)
    got = TC.segment_reduce("sum", change, s_alive, perm, v, valid)
    want = TG._segment_reduce_plain("sum", change, s_alive, last, perm, v,
                                    valid)
    for g, w in zip(got, want):
        _same(g, w, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", (1, 7, 8, 9, 2047, 2048, 2049, 12_289))
@pytest.mark.parametrize("layout", ("one_group", "tile_edges", "runs"))
def test_segment_reduce_tile_edges(card, layout, n):
    """Groups that end exactly at a thread's and at a tile's last row
    (TC.SEGMENT_TILE rows), one group across several tiles, and short runs,
    each with a dead suffix; every fn against the plain version exactly
    (int64 values)."""
    rng = np.random.default_rng(n)
    pos = np.arange(n)
    if layout == "one_group":
        change = pos == 0
    elif layout == "tile_edges":
        change = (pos % TC.SEGMENT_TILE == 0) | (pos % 8 == 0)
    else:
        change = (pos == 0) | (rng.random(n) < 0.3)
    n_live = n - n // 7
    s_alive = pos < n_live
    change &= s_alive
    last = s_alive & np.append(change[1:] | ~s_alive[1:], True)
    perm = rng.permutation(n)
    v = rng.integers(-10**9, 10**9, n)
    valid = rng.random(n) < 0.8
    t = [torch.from_numpy(a).to(card) for a in (change, s_alive, last, perm,
                                                 v, valid)]
    for fn in ("sum", "count", "min", "max"):
        got = TC.segment_reduce(fn, t[0], t[1], t[3], t[4], t[5])
        want = TG._segment_reduce_plain(fn, t[0], t[1], t[2], t[3], t[4],
                                        t[5])
        for g, w in zip(got, want):
            _same(g, w, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("fn", ("sum", "count", "min", "max"))
def test_segment_reduce_at_zero_rows(card, fn):
    e = torch.zeros(0, dtype=torch.bool, device=card)
    perm = torch.zeros(0, dtype=torch.int64, device=card)
    v = torch.zeros(0, dtype=torch.float64, device=card)
    TC.reset_launches()
    got = TC.segment_reduce(fn, e, e, perm, v, None)
    assert not any(TC.LAUNCHES.values()), TC.LAUNCHES
    want = TG._segment_reduce_plain(fn, e, e, e, perm, v, None)
    for g, w in zip(got, want):
        _same(g, w, 0.0)


@pytest.mark.cuda
def test_segment_reduce_takes_unaligned_inputs(card):
    """change, s_alive and perm that do not start on 16 bytes (views one
    row in) give the same result as aligned copies."""
    change, s_alive, perm, last = AB.segment_inputs(
        "groups_15m", 100_003, card, _gen(card, 3))
    v = torch.arange(100_003, device=card, dtype=torch.int64)
    views = [torch.cat([t[:1], t])[1:] for t in (change, s_alive, perm)]
    assert views[0].data_ptr() % 16 != 0
    got = TC.segment_reduce("sum", *views, v, None)
    want = TC.segment_reduce("sum", change, s_alive, perm, v, None)
    for g, w in zip(got, want):
        _same(g, w, 0.0)


# ---------------------------------------------------------------------
# kernels launched from the threads of a mesh over members
# (parallel/local_group.py)
# ---------------------------------------------------------------------
from quickstep_tpu_torch.parallel import local_group as TLG  # noqa: E402


def _on_members(devices, fn):
    """fn(member) on the thread of each member of a group over devices."""
    group = TLG.LocalGroup(devices)
    threads = [TLG.MemberThread(m) for m in group.members]
    try:
        return TLG.run_on_members(threads, fn, group.members), threads
    finally:
        for t in threads:
            t.stop()


@pytest.mark.cuda
def test_a_member_launches_on_its_own_card(card):
    """K1 from each member's thread of two members on the last card runs
    there, on that thread's current device, and counts in that thread's
    launches; the results are the plain version's."""
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    vals, valid, alive, _keys = _inputs(torch.float64, "nulls", dev)
    TC.reset_launches()

    def run(m):
        assert torch.cuda.current_device() == dev.index
        return TC.masked_reduce("sum", vals, valid, alive)
    got, threads = _on_members([dev, dev], run)
    want = TG.scalar_agg_plain("sum", vals, valid, alive)
    for out in got:
        assert out[0].device == dev
        _same(out[0], want[0], RTOL[torch.float64])
    assert [TC.launches_of(t.thread)["scalar_agg"] for t in threads] == [1, 1]
    assert TC.LAUNCHES["scalar_agg"] == 2


@pytest.mark.cuda
def test_a_tensor_on_another_card_raises(card):
    """A kernel never launches on the wrong card: a member on card 0 given
    tensors on card 1 raises, naming both."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    other = torch.device("cuda", 1)
    vals, valid, alive, _keys = _inputs(torch.float64, "nulls", other)
    with pytest.raises(ValueError, match="cuda:1.*cuda:0"):
        _on_members([torch.device("cuda", 0)], lambda m: TC.masked_reduce(
            "sum", vals, valid, alive))


@pytest.mark.cuda
def test_one_member_a_card_matches_the_one_process_mesh(card):
    """TPC-H Q3 at SF0.01 on one member a card over min(count, 4) cards
    (8 shards in all) returns the rows of the one-process 8-shard mesh of
    one card, bit for bit."""
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip("needs two cards")
    from quickstep_tpu_torch import Database
    from quickstep_tpu_torch.bench.tpch import TPCH_QUERIES, load_tpch
    from quickstep_tpu_torch.config import Config
    k = 4 if count >= 4 else 2
    one = Database(config=Config(distributed=True,
                                 replicate_threshold_rows=2000),
                   device="cuda:0", mesh_shards=8)
    load_tpch(one, scale=0.01, seed=0)
    want = one.execute(TPCH_QUERIES[3]).rows
    one.close()
    db = Database(config=Config(distributed=True,
                                replicate_threshold_rows=2000),
                  device="cuda", mesh_shards=8 // k,
                  mesh_devices=[f"cuda:{i}" for i in range(k)])
    try:
        db.on_members(lambda m: load_tpch(m, scale=0.01, seed=0))
        assert db.execute(TPCH_QUERIES[3]).rows == want
    finally:
        db.close()


@pytest.mark.cuda
def test_a_database_on_another_card_runs_without_members(card):
    """A Database on the second card, without members, runs its statements
    on its PolicyEnforcer's thread there: TPC-H Q3 at SF0.01 returns the
    rows of the same database on the first card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    from quickstep_tpu_torch import Database
    from quickstep_tpu_torch.bench.tpch import TPCH_QUERIES, load_tpch
    rows = []
    for device in ("cuda:0", "cuda:1"):
        db = Database(device=device)
        try:
            load_tpch(db, scale=0.01, seed=0)
            rows.append(db.execute(TPCH_QUERIES[3]).rows)
        finally:
            db.close()
    assert rows[0] == rows[1] and rows[0]
