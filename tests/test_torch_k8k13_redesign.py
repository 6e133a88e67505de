"""K8's and K13's redesign, as numpy models of the kernels' data flow,
against the JAX package (and the port's plain versions) on the same
numpy-seeded inputs.

Range compression (csrc/radix_device.cuh reduce_range, span_kernel and the
sources' code()): each value's order-preserving unsigned code in its
dtype's code space, the min and max over the rows that count, lo = min - 1
and hi = max + 1 where the code space has room, a counted row at u - lo and
a NULL or dead row at clamp(sentinel, lo, hi) - lo; the key is 32 bits wide
where hi - lo fits, and the digit plan runs only the 8-bit digits that
vary. Its order equals ops/sort.py encode_key's bit for bit, ties included.

K13 (csrc/sort_kernels.cu qs_order_permutation): the chain of stable LSD
passes over each key's significant digits, last key first, carrying int32
row ids, each later key read at the current permutation, then the one-digit
sort by the dead flag; equal to quickstep_tpu's order_permutation (JAX's
lexsort) and the port's plain version bit for bit, dead rows included.

K8 (csrc/join_kernels.cu qs_run_stats_probe): the build's codes sorted with
the values as the payload, each run's min and max by the tiled reverse
segmented scan with one carry a tile (at the kernel's tile and at 8 rows,
so that runs straddle many tiles), stored at the run's first position, and
the lower bound of each probe key mapped into the code range; equal to
quickstep_tpu's merge_cmp_probe for all five operators and merge_stats_probe
exactly. A probe key of INT64_MAX matches nothing in the port and matches
dead build rows in the reference (ROADMAP queue 3 states the difference):
those rows are held to the port's plain version only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickstep_tpu.ops import join as JJ
from quickstep_tpu.ops import sort as JS
from quickstep_tpu_torch.ops import join as TJ
from quickstep_tpu_torch.ops import sort as TS

I64 = np.iinfo(np.int64)
I32 = np.iinfo(np.int32)
SIGN64 = np.uint64(1 << 63)
STAT_TILE = 256 * 8           # kStatTile in csrc/join_kernels.cu


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# ---------------------------------------------------------------------
# range compression and the digit plan
# ---------------------------------------------------------------------

def code_of(col, desc):
    """(uint64 codes in the dtype's code space, its top code, its digits):
    KeyCode<D>::of of csrc/sort_kernels.cu."""
    col = np.asarray(col)
    if col.dtype == np.bool_:
        return (col != desc).astype(np.uint64), np.uint64(1), 1
    if col.dtype.kind == "f":
        bits, width = (np.uint32, 32) if col.dtype == np.float32 else \
            (np.uint64, 64)
        x = -col if desc else col
        b = x.view(bits).astype(np.uint64)
        sign = np.uint64(1 << (width - 1))
        top = np.uint64((1 << width) - 1)
        u = np.where(b & sign, ~b & top, b | sign)
        u = np.where(x == 0, sign, u)
        u = np.where(np.isnan(x), top, u)
        return u.astype(np.uint64), top, width // 8
    width = col.dtype.itemsize * 8
    x = ~col if desc else col
    u = x.astype(np.int64).view(np.uint64) if width == 64 else \
        x.astype(np.int32).view(np.uint32).astype(np.uint64)
    sign = np.uint64(1 << (width - 1))
    return u ^ sign, np.uint64((1 << width) - 1), width // 8


def null_code(dtype, first):
    """The code of a NULL row: that of the dtype's min or max sentinel."""
    sent = {np.dtype(np.int32): (I32.min, I32.max),
            np.dtype(np.int64): (I64.min, I64.max),
            np.dtype(np.float32): (-np.inf, np.inf),
            np.dtype(np.float64): (-np.inf, np.inf),
            np.dtype(np.bool_): (False, True)}[np.dtype(dtype)]
    v = np.array([sent[0] if first else sent[1]], dtype=dtype)
    return code_of(v, False)[0][0]


def span_of(u, counted, top):
    """(min, max, lo, hi, narrow) of span_kernel."""
    if not counted.any():
        return None, None, np.uint64(0), np.uint64(0), True
    mn, mx = u[counted].min(), u[counted].max()
    lo = mn - np.uint64(1) if mn > 0 else mn
    hi = mx + np.uint64(1) if mx < top else mx
    return mn, mx, lo, hi, bool(hi - lo <= np.uint64(0xFFFFFFFF))


def compress(u, lo, hi):
    """clamp(u, lo, hi) - lo, in unsigned arithmetic."""
    return np.minimum(np.maximum(u, lo), hi) - lo


def key_codes(col, valid, asc, nulls_first, at=None):
    """(the range-compressed codes of the rows at `at`, their width in
    digits): one key of the chain."""
    u, top, digits = code_of(col, not asc)
    counted = np.ones(len(u), bool) if valid is None else valid
    _, _, lo, hi, narrow = span_of(u, counted, top)
    first = nulls_first if nulls_first is not None else (not asc)
    if valid is not None:
        u = np.where(valid, u, null_code(np.asarray(col).dtype, first))
    at = np.arange(len(u)) if at is None else at
    rel = compress(u[at], lo, hi)
    if digits == 8 and narrow:
        digits = 4
    return rel, digits


def digit_plan(rel, digits):
    """The passes the plan runs: the digits that are not the same in every
    row (none vary: the lowest runs anyway)."""
    run = [p for p in range(digits)
           if len(np.unique((rel >> np.uint64(8 * p)) & np.uint64(255))) > 1]
    return run or [0]


def lsd(rel, payload, digits):
    """The stable LSD passes of the plan over (rel, payload)."""
    for p in digit_plan(rel, digits):
        order = np.argsort((rel >> np.uint64(8 * p)) & np.uint64(255),
                           kind="stable")
        rel, payload = rel[order], payload[order]
    return rel, payload


def _edge_values(dtype, n, rng):
    if dtype == np.bool_:
        return rng.random(n) < 0.5
    if np.dtype(dtype).kind == "f":
        v = (rng.integers(-40, 40, n) * 0.25).astype(dtype)
        pool = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan],
                        dtype=dtype)
        pick = rng.random(n) < 0.3
        v[pick] = pool[rng.integers(0, len(pool), int(pick.sum()))]
        return v
    info = np.iinfo(dtype)
    v = rng.integers(-50, 50, n).astype(dtype)
    pick = rng.random(n) < 0.2
    edges = np.array([info.min, info.max, info.min + 1, info.max - 1, 0],
                     dtype=dtype)
    v[pick] = edges[rng.integers(0, len(edges), int(pick.sum()))]
    return v


DTYPES = (np.int32, np.int64, np.float32, np.float64, np.bool_)


@pytest.mark.parametrize("nulls_first", (None, True, False), ids=str)
@pytest.mark.parametrize("asc", (True, False), ids=("asc", "desc"))
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_range_compression_keeps_encode_key_order(dtype, asc, nulls_first):
    """The compressed codes are a strictly monotone image of encode_key's
    int64s: the same stable order and the same ties, with valid values at
    the dtype's extremes beside NULLS FIRST and LAST, NaN, -0.0 and +-inf."""
    rng = np.random.default_rng(5)
    n = 4000
    col = _edge_values(dtype, n, rng)
    valid = rng.random(n) < 0.8
    rel, _ = key_codes(col, valid, asc, nulls_first)
    enc = TS.encode_key(_t(col), _t(valid), asc, nulls_first).numpy()
    order = np.argsort(enc, kind="stable")
    assert np.array_equal(np.argsort(rel, kind="stable"), order)
    e, r = enc[order], rel[order]
    assert np.array_equal(e[1:] == e[:-1], r[1:] == r[:-1])
    assert (r[1:] >= r[:-1]).all()


@pytest.mark.parametrize("case", ("int32_extremes", "int64_extremes",
                                  "all_64_bits", "narrow_int64",
                                  "all_null"))
def test_range_compression_edges_and_digit_plan(case):
    """INT32_MIN and INT32_MAX keys, keys next to INT64_MIN and INT64_MAX,
    a key whose codes span all 64 bits (no digit skipped, the order still
    right), an int64 key of 26 bits (32-bit codes, four digits at most),
    and every row NULL (one code)."""
    rng = np.random.default_rng(9)
    n = 3000
    if case == "int32_extremes":
        col = np.where(rng.random(n) < 0.5, I32.min, I32.max).astype(np.int32)
    elif case == "narrow_int64":
        col = rng.integers(0, 1 << 26, n) * 4
    else:
        col = rng.integers(-3, 3, n) + np.where(rng.random(n) < 0.5,
                                                I64.min + 3, I64.max - 3)
        if case == "all_64_bits":
            col[:2] = [I64.min, I64.max]
    valid = None if case != "all_null" else np.zeros(n, bool)
    for asc in (True, False):
        rel, digits = key_codes(col, valid, asc, None)
        enc = TS.encode_key(_t(col), _t(valid), asc, None).numpy()
        assert np.array_equal(np.argsort(rel, kind="stable"),
                              np.argsort(enc, kind="stable"))
        plan = digit_plan(rel, digits)
        if case == "all_64_bits":
            assert digits == 8 and plan == list(range(8))
        if case == "narrow_int64":
            assert digits == 4 and len(plan) == 4
        if case == "int32_extremes":
            # the codes sit at both ends of the code space: all digits run
            assert digits == 4 and plan == [0, 1, 2, 3]
        if case == "all_null":
            assert not rel.any() and plan == [0]


# ---------------------------------------------------------------------
# K13: the chain
# ---------------------------------------------------------------------

def chain_model(keys, valids, ascending, nulls_first, alive):
    """qs_order_permutation: one key-value LSD sort per key, last first,
    its codes read at the current permutation, carrying int32 row ids;
    then the dead flag; widened to int64."""
    n = len(alive)
    perm = np.arange(n, dtype=np.int32)
    for k, v, asc, nf in reversed(list(zip(keys, valids, ascending,
                                           nulls_first))):
        rel, digits = key_codes(k, v, asc, nf, at=perm)
        _, perm = lsd(rel, perm, digits)
    dead = (~alive[perm]).astype(np.uint64)
    _, perm = lsd(dead, perm, 1)
    return perm.astype(np.int64)


def _chain_inputs(n_keys, rng, n=3000, ties=None):
    dtypes = [DTYPES[(i + n_keys) % len(DTYPES)] for i in range(n_keys)]
    keys = [_edge_values(dt, n, rng) for dt in dtypes]
    if ties is not None:
        keys[0] = np.full(n, ties[1], dtype=ties[0])
    valids = [rng.random(n) < 0.85 if i % 2 == 0 else None
              for i in range(n_keys)]
    asc = [bool(rng.random() < 0.5) for _ in range(n_keys)]
    nf = [(None, True, False)[int(rng.integers(0, 3))] for _ in range(n_keys)]
    alive = rng.random(n) < 0.9
    return keys, valids, asc, nf, alive


def _check_chain(keys, valids, asc, nf, alive):
    got = chain_model(keys, valids, asc, nf, alive)
    want = np.asarray(JS.order_permutation(
        [_j(k) for k in keys], [_j(v) for v in valids], asc, nf, _j(alive)))
    assert np.array_equal(got, want)
    plain = TS.order_permutation_plain(
        [_t(k) for k in keys], [_t(v) for v in valids], asc, nf, _t(alive))
    assert np.array_equal(got, plain.numpy())
    assert np.array_equal(
        TS.order_permutation([_t(k) for k in keys], [_t(v) for v in valids],
                             asc, nf, _t(alive)).numpy(), got)


@pytest.mark.parametrize("seed", (0, 1))
@pytest.mark.parametrize("n_keys", (1, 2, 3, 4, 5))
def test_chain_model_matches_reference(n_keys, seed):
    _check_chain(*_chain_inputs(n_keys, np.random.default_rng(seed)))


@pytest.mark.parametrize("tie", ((np.int32, 7), (np.int64, I64.min),
                                 (np.float32, np.nan), (np.float64, -0.0),
                                 (np.bool_, True)),
                         ids=("int32", "int64_min", "nan", "neg_zero",
                              "bool"))
def test_chain_model_primary_key_ties_everywhere(tie):
    """Every row ties on the primary key: the order is the other keys'."""
    _check_chain(*_chain_inputs(3, np.random.default_rng(11), ties=tie))


def test_chain_model_composite_over_128_bits():
    """Three int64 keys over their whole range and a float64 of every bit
    pattern: more than 128 significant bits, every digit of each runs."""
    rng = np.random.default_rng(13)
    n = 2000
    keys = [rng.integers(I64.min, I64.max, n, dtype=np.int64)
            .view(np.float64),
            rng.integers(I64.min, I64.max, n, dtype=np.int64),
            rng.integers(0, 4, n) * (1 << 61),
            rng.integers(I64.min, I64.max, n, dtype=np.int64)]
    valids = [None, rng.random(n) < 0.9, None, None]
    for k in keys[1:]:
        assert len(digit_plan(key_codes(k, None, True, None)[0], 8)) == 8 \
            or k is keys[2]
    _check_chain(keys, valids, [True, False, True, False],
                 [None, False, None, None], rng.random(n) < 0.9)


# ---------------------------------------------------------------------
# K8: sort with values, tiled run statistics, the probe in code space
# ---------------------------------------------------------------------

def _stat_op(a, b):
    """RunStatOp(earlier, later) in scan order."""
    return (a[0] | b[0], b[1] if b[0] else min(a[1], b[1]),
            b[2] if b[0] else max(a[2], b[2]))


ID = (0, I32.max, I32.min)


def run_stats_model(skeys, svals, tile):
    """run_stats_tile_kernel and run_stats_carry_kernel: each tile scanned
    from its end, a segment starting at each run's last row; the min and max
    at each run's first row, the fix row of the run open at a tile's end
    completed by the carries scanned from the last tile."""
    n = len(skeys)
    tail = np.ones(n, bool)
    tail[:-1] = skeys[:-1] != skeys[1:]
    head = np.ones(n, bool)
    head[1:] = skeys[1:] != skeys[:-1]
    mn = np.full(n, 12345, np.int64)     # rows that are not run starts
    mx = np.full(n, 12345, np.int64)
    totals, fixes = [], []
    for t0 in range(0, n, tile):
        cur, fix = ID, None
        for r in range(min(t0 + tile, n) - 1, t0 - 1, -1):
            cur = _stat_op(cur, (int(tail[r]), int(svals[r]),
                                 int(svals[r])))
            if head[r]:
                if cur[0]:
                    mn[r], mx[r] = cur[1], cur[2]
                else:
                    assert fix is None
                    fix = (r, cur[1], cur[2])
        totals.append(cur)
        fixes.append(fix)
    cur = ID
    for t in range(len(totals) - 1, -1, -1):
        if fixes[t] is not None:
            r, a, b = fixes[t]
            mn[r], mx[r] = min(a, cur[1]), max(b, cur[2])
        cur = _stat_op(cur, totals[t])
    return mn, mx


def k8_model(bkey, bmask, bval, pkey, pmask, pval=None, op=None, tile=8):
    """qs_run_stats_probe: (matched, min, max), or matched with op."""
    live = bmask & (bkey != I64.max)
    u = bkey.view(np.uint64) ^ SIGN64
    mn, mx, lo, hi, narrow = span_of(u, live, np.uint64(~np.uint64(0)))
    rel = np.where(live, u - lo, hi - lo)
    skeys, svals = lsd(rel, bval.astype(np.int32), 4 if narrow else 8)
    if narrow:
        assert (skeys <= np.uint64(0xFFFFFFFF)).all()
    run_mn, run_mx = run_stats_model(skeys, svals, tile)
    up = pkey.view(np.uint64) ^ SIGN64
    inside = np.zeros(len(pkey), bool) if mn is None else \
        (up >= mn) & (up <= mx)
    code = np.where(inside, up - lo, np.uint64(0))
    lb = np.searchsorted(skeys, code)
    at = np.minimum(lb, len(skeys) - 1) if len(skeys) else lb * 0
    has = inside & (lb < len(skeys))
    if len(skeys):
        has &= skeys[at] == code
    lo_v = np.where(has, run_mn[at] if len(skeys) else 0, I32.max)
    hi_v = np.where(has, run_mx[at] if len(skeys) else 0, I32.min)
    lo_v, hi_v = lo_v.astype(np.int32), hi_v.astype(np.int32)
    matched = pmask & has
    if op is None:
        return matched, lo_v, hi_v
    hit = {"<>": (lo_v != pval) | (hi_v != pval), "<": pval < hi_v,
           "<=": pval <= hi_v, ">": pval > lo_v, ">=": pval >= lo_v}[op]
    return matched & hit


def _k8_inputs(case, rng, n=6000):
    key = rng.integers(0, n // 3, n) * 5 + 1_000_000
    alive = rng.random(n) < 0.7
    if case == "one_run":
        key[alive] = 77
    if case == "extremes":
        key = np.where(rng.random(n) < 0.5, I64.min + rng.integers(0, 3, n),
                       I64.max - 1 - rng.integers(0, 3, n))
        key[:3] = [I64.max, I64.min, I64.max - 1]
    if case == "no_live_build":
        alive[:] = False
    if case == "all_live":
        alive[:] = True
    val = rng.integers(-4, 5, n).astype(np.int32)
    live = alive & (key != I64.max)
    hi = key[live].max() if live.any() else 0
    lo = key[live].min() if live.any() else 0
    edges = [max(int(lo) - 1, I64.min), int(lo), int(hi),
             min(int(hi) + 1, I64.max), I64.max, I64.max, I64.min, 0]
    pkey = np.concatenate([key[rng.integers(0, n, n)],
                           rng.integers(-20, n * 2, 500) * 5 + 1_000_000,
                           np.array(edges, np.int64)])
    pkey = pkey[rng.permutation(len(pkey))]
    pmask = rng.random(len(pkey)) < 0.85
    pval = rng.integers(-5, 6, len(pkey)).astype(np.int32)
    return key, alive, val, pkey, pmask, pval


K8_CASES = ("runs", "one_run", "extremes", "no_live_build", "all_live")


def _reference_rows(case, bkey, bmask, pkey):
    """The probe rows on which the reference and the port agree: all but
    INT64_MAX probes where a dead build row (or a live INT64_MAX key)
    exists."""
    if case == "all_live" or not ((~bmask) | (bkey == I64.max)).any():
        return np.ones(len(pkey), bool)
    return pkey != I64.max


@pytest.mark.parametrize("tile", ("kernel", "8"))
@pytest.mark.parametrize("case", K8_CASES)
def test_k8_stats_model_matches_reference(case, tile):
    rng = np.random.default_rng(17)
    bkey, bmask, bval, pkey, pmask, _ = _k8_inputs(case, rng)
    got = k8_model(bkey, bmask, bval, pkey, pmask,
                   tile=STAT_TILE if tile == "kernel" else 8)
    plain = TJ.merge_stats_probe_plain(_t(bkey), _t(bmask), _t(bval),
                                       _t(pkey), _t(pmask))
    for g, p in zip(got, plain):
        assert np.array_equal(g, p.numpy())
    want = JJ.merge_stats_probe(_j(bkey), _j(bmask), _j(bval), _j(pkey),
                                _j(pmask))
    rows = _reference_rows(case, bkey, bmask, pkey)
    for g, w in zip(got, want):
        assert np.array_equal(g[rows], np.asarray(w)[rows])
    if case in ("runs", "one_run", "all_live"):
        assert 0 < got[0].sum() < len(pkey)


@pytest.mark.parametrize("op", ("<>", "<", "<=", ">", ">="))
@pytest.mark.parametrize("case", K8_CASES)
def test_k8_cmp_model_matches_reference(case, op):
    rng = np.random.default_rng(19)
    bkey, bmask, bval, pkey, pmask, pval = _k8_inputs(case, rng)
    got = k8_model(bkey, bmask, bval, pkey, pmask, pval, op)
    plain = TJ.merge_cmp_probe_plain(_t(bkey), _t(bmask), _t(bval),
                                     _t(pkey), _t(pmask), _t(pval), op)
    assert np.array_equal(got, plain.numpy())
    want = np.asarray(JJ.merge_cmp_probe(_j(bkey), _j(bmask), _j(bval),
                                         _j(pkey), _j(pmask), _j(pval), op))
    rows = _reference_rows(case, bkey, bmask, pkey)
    assert np.array_equal(got[rows], want[rows])


def test_k8_runs_straddle_tiles_and_keys_narrow():
    """At a tile of 8 rows most runs of a skewed build cross tiles (one
    holds half the live rows); Q21-shaped keys give 32-bit codes, keys at
    both ends of int64 give 64-bit ones."""
    rng = np.random.default_rng(23)
    n = 5000
    key = rng.integers(0, 400, n) * 4
    key[: n // 2] = 800
    alive = rng.random(n) < 0.9
    val = rng.integers(-100, 100, n).astype(np.int32)
    live = alive & (key != I64.max)
    u = key.view(np.uint64) ^ SIGN64
    assert span_of(u, live, ~np.uint64(0))[4]
    skeys, svals = lsd(np.where(live, u - (u[live].min() - np.uint64(1)),
                                u[live].max() - u[live].min() + np.uint64(2)),
                       val, 4)
    by_tile = run_stats_model(skeys, svals, 8)
    whole = run_stats_model(skeys, svals, len(skeys))
    heads = np.ones(n, bool)
    heads[1:] = skeys[1:] != skeys[:-1]
    assert np.array_equal(by_tile[0][heads], whole[0][heads])
    assert np.array_equal(by_tile[1][heads], whole[1][heads])
    ext = np.array([I64.min, I64.max - 1], np.int64).view(np.uint64) ^ SIGN64
    assert not span_of(ext, np.ones(2, bool), ~np.uint64(0))[4]
