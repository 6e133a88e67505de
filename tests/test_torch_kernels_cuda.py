"""The CUDA kernels against their plain torch versions, and the checks their
wrappers make. This file imports neither jax nor quickstep_tpu, so it also
runs on a machine that has a card and no JAX:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

The `cuda`-marked tests skip where torch finds no card. Tolerances: integers
and bools exactly, float64 within rel 1e-12, float32 within rel 1e-5.
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
