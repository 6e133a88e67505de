"""The CUDA kernels against their plain torch versions, and the checks their
wrappers make. This file imports neither jax nor quickstep_tpu, so it also
runs on a machine that has a card and no JAX:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

The `cuda`-marked tests skip where torch finds no card. Tolerances: integers
and bools exactly, float64 within rel 1e-12, float32 within rel 1e-5; the
window kernels' float prefix sums within 32 eps x the sum of the live
magnitudes (_prefix_atol), their sliding sums bit for bit.
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
    assert TC.LAUNCHES == dict(dict.fromkeys(TC.LAUNCHES, 0), scalar_agg=1,
                               dense_groupby=2)


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
        TC.dense_group_reduce("sum", vals, vals, None, alive, 4)


def test_dense_wrapper_rejects_large_domain():
    alive = torch.ones(4, dtype=torch.bool)
    idx = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="domain 129"):
        TC.dense_group_reduce("count", idx, None, None, alive, 129)


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
    if not dups:
        _same(table, want_table, 0.0)
    else:
        # which duplicate wins may differ; every other slot agrees
        differ = (table != want_table).nonzero().flatten().tolist()
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
    _same(bits, TB.exact_filter_build_plain(bkey, balive, lo, domain), 0.0)
    _same(TB.exact_filter_probe(bits, pkey, palive, lo),
          TB.exact_filter_probe_plain(bits, pkey, palive, lo), 0.0)


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
    assert TC.LAUNCHES == dict(dict.fromkeys(TC.LAUNCHES, 0), direct_join=4,
                               merge_unique_probe=1, sort_groupby=2,
                               multi_gather=1)


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
    TJ.expand_probe_plain(sorted_key, order, pkey, palive, 4)
    TK.compact_order(palive)
    assert TC.LAUNCHES == dict(dict.fromkeys(TC.LAUNCHES, 0), expand_probe=1,
                               merge_cmp_probe=2, sort_groupby_compact=1)


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
                                    "one_segment"))
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("fn", WIN_FNS)
def test_window_prefix_kernel_matches_plain(card, fn, dtype, layout):
    (seg, peer, live, _key), vals = _window_rows(
        card, seg_len=None if layout == "one_segment" else 30)
    if layout == "whole_partition":
        peer = seg
    v = None if fn == "count" else _contrib(fn, vals[dtype], live)
    got = TW.segmented_prefix(fn, v, live, seg, peer)
    want = TW.segmented_prefix_plain(fn, v, live, seg, peer)
    _close(got[1], want[1], 0.0)
    if fn == "count":
        assert got[0] is None and want[0] is None
    else:
        _close(got[0], want[0], _prefix_atol(fn, vals[dtype], live))


@pytest.mark.cuda
def test_window_prefix_kernel_one_15m_row_segment(card):
    """W-Q3's shape: one segment of 15 M rows in ~2,400 peer groups."""
    n = 15_000_000
    rng = np.random.default_rng(53)
    seg = torch.zeros(n, dtype=torch.bool, device=card)
    seg[0] = True
    peer = torch.from_numpy(rng.random(n) < 1 / 6000).to(card) | seg
    live = torch.ones(n, dtype=torch.bool, device=card)
    price = torch.from_numpy(rng.integers(100_000, 50_000_000, n) / 100).to(
        card)
    for fn, v in (("sum", price), ("max", price), ("count", None)):
        got = TW.segmented_prefix(fn, v, live, seg, peer)
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
                               open_addressing=2, distinct_count=1,
                               order_permutation=2)


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
        TC.sort_key_encode(x, None, True, None, x)


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
        bits = TB.bloom_build(build, balive, nbits)
        _same(bits, TB.bloom_build_plain(build, balive, nbits), 0.0)
        _same(TB.bloom_probe(bits, probe, palive),
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
