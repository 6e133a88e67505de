"""The host-side logic of K12's radix sort and K6's row-packed gather, as
plain models, against the JAX package on the same numpy-seeded inputs.

K12 (csrc/radix_kernels.cu): the order-preserving key map, the digit
histograms, the plan (which passes run, where each reads and writes) and an
LSD sort over the running passes' digits. The model's sorted values equal
torch.sort(k, stable=True) bit for bit (NaN payloads, -0.0 and +0.0
included), and its run starts give quickstep_tpu's distinct_count and the
reference runner's _dedup_values exactly.

K6 (csrc/gather_kernels.cu): ops/cuda.py packed_layout and gather_route,
run as a pack of the columns into rows of bytes, an index_select of rows
and an unpack; equal to numpy's gather and to
quickstep_tpu.ops.kernels.multi_gather bit for bit, except for a 2-byte
column, which the reference truncates to its int8 lane when another 1- or
2-byte column shares the group (a reference fault no SQL type meets). A
source of zero rows, which the reference's gather refuses, is held to the
port's plain version (zeros, which the caller marks invalid).

Tolerance: none anywhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickstep_tpu.exec.runner import PlanRunner as RefRunner
from quickstep_tpu.ops import groupby as RG
from quickstep_tpu.ops import kernels as JK
from quickstep_tpu_torch.ops import cuda as TC
from quickstep_tpu_torch.ops import groupby as G
from quickstep_tpu_torch.ops import kernels as K

# ---------------------------------------------------------------------
# K12: the radix sort's model
# ---------------------------------------------------------------------
SORT_DTYPES = [np.int32, np.int64, np.float32, np.float64, np.bool_]
NAN_BITS = {np.float32: [0x7fc00000, 0xffc00000, 0x7f800001, 0xff800123],
            np.float64: [0x7ff8000000000000, 0xfff8000000000000,
                         0x7ff0000000000001, 0xfff0000000000123]}
INPUT, OUT, TMP = "input", "out", "tmp"


def _top(dtype):
    """The dtype's maximum, which stands for a dead or NULL row."""
    if dtype == np.bool_:
        return np.uint8(1)
    if np.issubdtype(dtype, np.integer):
        return np.iinfo(dtype).max
    return np.array(np.inf, dtype)[()]


def key_map(k: np.ndarray):
    """(the unsigned key of each value, the number of 8-bit digits)."""
    if k.dtype == np.uint8:                       # bools as 0 / 1 bytes
        return k.astype(np.uint64), 1
    if np.issubdtype(k.dtype, np.integer):
        bits = 8 * k.itemsize
        u = k.view(np.uint32 if bits == 32 else np.uint64).astype(np.uint64)
        return u ^ np.uint64(1 << (bits - 1)), bits // 8
    bits = 8 * k.itemsize
    sign = np.uint64(1 << (bits - 1))
    full = np.uint64((1 << bits) - 1)
    b = k.view(np.uint32 if bits == 32 else np.uint64).astype(np.uint64)
    key = np.where(b & sign, ~b & full, b | sign)
    key = np.where(k == 0, sign, key)
    return np.where(np.isnan(k), full, key), bits // 8


def plan(hists, n):
    """The plan kernel: the passes that run (a digit that is the same in
    every row is skipped; the lowest pass runs if none varies) with their
    source and destination, the last running pass writing the output."""
    run = [p for p, h in enumerate(hists) if not np.any(h == n)] or [0]
    steps, src = [], INPUT
    for i, p in enumerate(run):
        dst = OUT if (len(run) - i) % 2 == 1 else TMP
        steps.append((p, src, dst))
        src = dst
    return steps


def radix_model(vals: np.ndarray, valid, alive: np.ndarray):
    """(the sorted values with dead and NULL rows as the maximum, n_live,
    the plan): the histogram pass, the plan and one stable counting pass
    per running digit, over the same value moved from buffer to buffer."""
    live = alive if valid is None else alive & valid
    v = vals.astype(np.uint8) if vals.dtype == np.bool_ else vals
    k = np.where(live, v, _top(vals.dtype)).astype(v.dtype)
    key, passes = key_map(k)
    n = len(k)
    hists = [np.bincount(((key >> np.uint64(8 * p)) & np.uint64(255))
                         .astype(np.int64), minlength=256)
             for p in range(passes)]
    steps = plan(hists, n) if n else []
    bufs = {INPUT: k}
    for p, src, dst in steps:
        x = bufs[src]
        d = (key_map(x)[0] >> np.uint64(8 * p)) & np.uint64(255)
        offsets = np.concatenate([[0], np.cumsum(hists[p])[:-1]])
        out = np.empty_like(x)
        seen = np.zeros(256, np.int64)
        for i, digit in enumerate(d.astype(np.int64)):   # stable scatter
            out[offsets[digit] + seen[digit]] = x[i]
            seen[digit] += 1
        bufs[dst] = out
    s = bufs[OUT] if steps else k
    return s, int(live.sum()), steps


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int32 if a.itemsize == 4 else np.int64) \
        if np.issubdtype(a.dtype, np.floating) else a


def _edge_values(rng, dtype, n):
    """Values with every edge of the key map mixed into a small domain."""
    if dtype == np.bool_:
        return rng.random(n) < 0.5
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        v = rng.integers(-30, 30, n).astype(dtype)
        edges = np.array([info.min, info.max, info.min + 1, 0, -1], dtype)
    else:
        v = (rng.integers(-30, 30, n) * 0.25).astype(dtype)
        ib = np.int32 if dtype == np.float32 else np.int64
        nans = np.array([b - (1 << (8 * np.dtype(ib).itemsize))
                         if b >= 1 << (8 * np.dtype(ib).itemsize - 1) else b
                         for b in NAN_BITS[dtype]], ib).view(dtype)
        edges = np.concatenate([np.array([0.0, -0.0, np.inf, -np.inf],
                                         dtype), nans])
    pick = rng.random(n) < 0.3
    v[pick] = edges[rng.integers(0, len(edges), int(pick.sum()))]
    return v


def _masks(rng, mode, n):
    if mode == "mixed":
        return rng.random(n) < 0.9, rng.random(n) < 0.85
    alive = np.zeros(n, bool)
    if mode == "one_live":
        alive[n // 3] = True
    return None, alive


@pytest.mark.parametrize("mode", ["mixed", "all_dead", "one_live"])
@pytest.mark.parametrize("dtype", SORT_DTYPES, ids=lambda d: np.dtype(d).name)
def test_radix_model_matches_torch_sort_and_reference(dtype, mode):
    rng = np.random.default_rng(
        10 * SORT_DTYPES.index(dtype) + ["mixed", "all_dead",
                                         "one_live"].index(mode))
    n = 1500
    vals = _edge_values(rng, dtype, n)
    valid, alive = _masks(rng, mode, n)
    s, n_live, steps = radix_model(vals, valid, alive)
    tv = None if valid is None else torch.from_numpy(valid)
    ts, tn = G._sorted_live_plain(torch.from_numpy(vals), tv,
                                  torch.from_numpy(alive))
    np.testing.assert_array_equal(_bits(s), _bits(ts.numpy()))
    assert n_live == int(tn)
    # the run starts of the model's order against the reference
    flags = G.run_starts_plain(torch.from_numpy(s), torch.tensor(n_live))
    jv = None if valid is None else jnp.asarray(valid)
    assert int(flags.sum()) == int(RG.distinct_count(
        jnp.asarray(vals), jv, jnp.asarray(alive)))
    s_ref, _, mask_ref = RefRunner._dedup_values(None, jnp.asarray(vals), jv,
                                                 jnp.asarray(alive))
    mask_ref = np.asarray(mask_ref)
    np.testing.assert_array_equal(flags.numpy(), mask_ref)
    got = s.astype(bool) if dtype == np.bool_ else s
    np.testing.assert_array_equal(got[mask_ref], np.asarray(s_ref)[mask_ref])
    assert steps and steps[0][1] == INPUT and steps[-1][2] == OUT


@pytest.mark.parametrize("case,want_run", [
    ("smoke_int32", [0, 1, 2]),        # [1, 2 M]: the top byte is constant
    ("wide_int64", [0, 1, 2, 3, 4]),   # about 33 bits: five digits vary
    ("constant", [0]),                 # nothing varies: the lowest pass runs
    ("bool", [0]),
])
def test_radix_model_skips_constant_digits(case, want_run):
    rng = np.random.default_rng(3)
    n = 5000
    vals = {"smoke_int32": rng.integers(1, 2_000_001, n).astype(np.int32),
            "wide_int64": rng.integers(0, 1 << 33, n),
            "constant": np.full(n, 7.5),
            "bool": rng.random(n) < 0.5}[case]
    alive = np.ones(n, bool)
    s, n_live, steps = radix_model(vals, None, alive)
    assert [p for p, _, _ in steps] == want_run
    # each running pass reads where the last one wrote, and the last
    # writes the output: no pass leaves the result in the scratch buffer
    srcs = [src for _, src, _ in steps]
    dsts = [dst for _, _, dst in steps]
    assert srcs == [INPUT] + dsts[:-1] and dsts[-1] == OUT
    assert all(a != b for a, b in zip(srcs, dsts))
    want = np.sort(vals.astype(np.uint8) if vals.dtype == np.bool_ else vals,
                   kind="stable")
    np.testing.assert_array_equal(s, want)
    assert n_live == n


def test_radix_model_keeps_zero_and_nan_order():
    """-0.0 and +0.0 share a key and NaNs of any sign and payload share the
    key above +inf, so each keeps its input order among its equals."""
    ib = np.int64
    nan_a, nan_b = (np.array([0x7ff8000000000abc, 0xfff0000000000123],
                             np.uint64).view(np.float64))
    vals = np.array([nan_a, 0.0, -0.0, np.inf, nan_b, -0.0, 0.0, -np.inf])
    s, _, _ = radix_model(vals, None, np.ones(len(vals), bool))
    want = np.array([-np.inf, 0.0, -0.0, -0.0, 0.0, np.inf, nan_a, nan_b])
    np.testing.assert_array_equal(s.view(ib), want.view(ib))


def test_radix_model_empty():
    s, n_live, steps = radix_model(np.zeros(0, np.int32), None,
                                   np.zeros(0, bool))
    assert s.shape == (0,) and n_live == 0 and steps == []


# ---------------------------------------------------------------------
# K6: the row-packed route's model
# ---------------------------------------------------------------------

def packed_model(cols, idx):
    """Pack the columns into rows (ops/cuda.py packed_layout), gather rows
    by the clamped index, unpack; None entries pass through."""
    live = [c for c in cols if c is not None]
    widths = [c.itemsize for c in live]
    offsets, row = TC.packed_layout(widths)
    n = len(live[0])
    buf = np.zeros((n, row), np.uint8)
    for c, off in zip(live, offsets):
        buf[:, off:off + c.itemsize] = c.view(np.uint8).reshape(n, c.itemsize)
    rows = buf[np.clip(idx, 0, max(n - 1, 0))] if n else \
        np.zeros((len(idx), row), np.uint8)
    out = iter([rows[:, off:off + c.itemsize].copy().view(c.dtype).ravel()
                for c, off in zip(live, offsets)])
    return [None if c is None else next(out) for c in cols]


def _gather_cols(rng, widths, n):
    kinds = {1: [np.bool_, np.int8], 2: [np.int16],
             4: [np.int32, np.float32], 8: [np.int64, np.float64]}
    cols = []
    for i, w in enumerate(widths):
        dt = kinds[w][i % len(kinds[w])]
        if dt == np.bool_:
            cols.append(rng.random(n) < 0.5)
        elif np.issubdtype(dt, np.floating):
            cols.append(rng.normal(0, 1e6, n).astype(dt))
        else:
            info = np.iinfo(dt)
            cols.append(rng.integers(info.min, info.max, n, endpoint=True,
                                     dtype=np.int64).astype(dt))
    return cols


@pytest.mark.parametrize("widths", [(1, 2), (8, 4), (1, 4, 4, 8, 4, 8),
                                    (2, 2, 1, 8, 8, 4), (8,) * 8],
                         ids=lambda w: "-".join(map(str, w)))
@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64],
                         ids=lambda d: np.dtype(d).name)
def test_packed_model_matches_reference(widths, idx_dtype):
    rng = np.random.default_rng(sum(widths) + np.dtype(idx_dtype).itemsize)
    n, m = 700, 2500
    cols = _gather_cols(rng, widths, n)
    cols = cols[:2] + [None] + cols[2:]
    idx = rng.integers(0, n, m).astype(idx_dtype)
    got = packed_model(cols, idx)
    want = JK.multi_gather([None if c is None else jnp.asarray(c)
                            for c in cols], jnp.asarray(idx))
    for c, g, w in zip(cols, got, want):
        if c is None:
            assert g is None and w is None
            continue
        assert g.dtype == c.dtype
        np.testing.assert_array_equal(_bits(g), _bits(c[idx]))
        # the reference packs 1- and 2-byte columns into int8 lanes, which
        # truncates a 2-byte column that shares its group (no SQL type is
        # 2 bytes wide); every other column is held to it
        if c.itemsize != 2:
            np.testing.assert_array_equal(_bits(g), _bits(np.asarray(w)))
    # and the port's plain version, which the kernel is held to on the card
    plain = K.multi_gather_plain([None if c is None else torch.from_numpy(c)
                                  for c in cols], torch.from_numpy(idx))
    for g, p in zip(got, plain):
        if g is not None:
            np.testing.assert_array_equal(_bits(g), _bits(p.numpy()))


@pytest.mark.parametrize("n_src,m", [(0, 40), (500, 0)])
def test_packed_model_at_zero_rows(n_src, m):
    rng = np.random.default_rng(1)
    cols = _gather_cols(rng, (8, 4, 1), n_src)
    idx = rng.integers(0, max(n_src, 1), m)
    got = packed_model(cols, idx)
    plain = K.multi_gather_plain([torch.from_numpy(c) for c in cols],
                                 torch.from_numpy(idx))
    for g, p in zip(got, plain):
        np.testing.assert_array_equal(g, p.numpy())
    if n_src:          # the reference refuses a gather from no rows
        want = JK.multi_gather([jnp.asarray(c) for c in cols],
                               jnp.asarray(idx))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("widths,want", [
    ([8], None),
    ([1, 2], ([2, 0], 16)),
    ([1, 4, 4, 8, 4, 8], ([28, 16, 20, 0, 24, 8], 32)),
    ([4] * 5 + [8] * 3, ([24, 28, 32, 36, 40, 0, 8, 16], 64)),
    ([8] * 9, "none"),
])
def test_packed_layout(widths, want):
    got = TC.packed_layout(widths)
    if want == "none":
        assert got is None
        return
    if want is None:
        assert got == ([0], 16)
        return
    assert got == want
    offsets, row = got
    spans = sorted((o, o + w) for o, w in zip(offsets, widths))
    assert all(o % w == 0 for o, w in zip(offsets, widths))
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= row


@pytest.mark.parametrize("n_src,m,widths,random,want", [
    (60_000_000, 60_000_000, [1, 4, 4, 8, 4, 8], True, "packed"),
    (60_000_000, 60_000_000, [1, 4, 4, 8, 4, 8], False, "direct"),
    (60_000_000, 60_000_000, [8], True, "direct"),       # one sector either way
    (60_000_000, 60_000_000, [4, 8], True, "packed"),
    (1_500_000, 60_000_000, [4, 8], True, "packed"),
    (60_000_000, 60_000_000, [8] * 9, True, "direct"),   # rows past 64 bytes
    (60_000_000, 1_000, [4, 8], True, "direct"),         # packing costs more
    (0, 1_000, [4, 8], True, "direct"),
])
def test_gather_route(n_src, m, widths, random, want):
    assert TC.gather_route(n_src, m, widths, random) == want


def test_sort_permutation_gathers_declare_random(monkeypatch):
    """The sort group-by's and the window sort's permutation gathers ask
    for the packed route; the compaction after a group-by does not."""
    from quickstep_tpu_torch.ops import groupby as GB, window as W
    seen = []

    def spy(cols, idx, random=False):
        seen.append(random)
        return K.multi_gather_plain(cols, idx)
    monkeypatch.setattr(GB, "multi_gather_plain", spy)
    monkeypatch.setattr(W, "multi_gather_plain", spy)
    rng = np.random.default_rng(2)
    n = 300
    k1 = torch.from_numpy(rng.integers(0, 9, n))
    k2 = torch.from_numpy(rng.integers(0, 5, n).astype(np.int32))
    alive = torch.from_numpy(rng.random(n) < 0.8)
    GB.sort_groupby([k1, k2], [None, None], [("count", None, None)], alive)
    GB.sort_groupby([k1], [None], [("count", None, None)], alive,
                    packed_key=k1)
    assert seen == [True, True]
    seen.clear()
    GB.sort_groupby_compact([k1], [None], [("count", None, None)], alive,
                            packed_key=k1)
    assert seen == [True, False]
    seen.clear()
    vals = torch.from_numpy(rng.random(n))
    W.window_aggregate([k1, k2.long()], [k2], [False], "sum", vals, None,
                       alive, ("range", 2, 2))
    assert seen and all(seen)
