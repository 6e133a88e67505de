"""W3 (frame bounds) and W4 (sliding float sums) at the shapes their
hand-written routes see, on the CPU.

Module parity: the port's window_aggregate (its plain W3 and W4 on CPU
tensors), frame_bounds_plain and sliding_sums_plain against
quickstep_tpu/ops/window.py's window_aggregate, _lex_searchsorted and
_sliding_float_sums on JAX's CPU backend, on seeded numpy inputs: segments
shorter than, as long as and one row longer than a tile (W4's 1,024 rows and
its 2,048-row staged span; W3's 4,096), many segments inside one tile, one
of 5,000 rows (past the plain W4's vectorised steps), ROWS frames wider than
a tile and UNBOUNDED on either side, RANGE frames over float keys holding
NaN, +-inf, -0.0 with 0.0 and runs of duplicates and over integer keys with
offsets past the key type's range, a dead tail, and values holding NaN and
+-inf.

Models of the kernels: numpy copies of W3's search-then-step (segment bounds
from the tile summaries as its look-backs give them, a thread's first row's
bounds searched out from the row, steps after, a new search at a segment
start or where q falls) and of W4's two routes (segments
staged by the tile that holds their start; a long one walked as a stream
of steps with subtracted values negated and padding of -0.0, chunk by
chunk and piece by piece) against the plain versions, at the kernels'
sizes and at small ones that cross every edge.

Float sums compare bit for bit, a NaN as a NaN of either sign; integers and
bounds exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickstep_tpu.ops import window as JW
from quickstep_tpu_torch.ops import window as TW

# the kernels' sizes (csrc/window_kernels.cu)
W3_TILE, W3_ITEMS = 4096, 16
W4_TILE, W4_SPAN, CHUNK, CAP = 1024, 2048, 1024, 3072


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same_bits(got, want):
    """Equal bit for bit, a NaN equal to any NaN."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    gn, wn = np.isnan(got), np.isnan(want)
    np.testing.assert_array_equal(gn, wn)
    np.testing.assert_array_equal(got[~gn].view(np.uint8),
                                  want[~wn].view(np.uint8))


# ---------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------

def _lens(name, rng):
    """Segment lengths of each shape."""
    if name == "tile_edges":
        return [1023, 1024, 1025, 2047, 2048, 2049, 4095, 4096, 4097, 1, 3,
                30, 30, 5]
    if name == "many_in_tile":
        return list(rng.integers(1, 8, 400))
    if name == "one_5000":
        return [5000, 7, 12]
    if name == "wide":
        return [5000, 6000]
    return list(rng.integers(1, 40, 120))


FLOAT_KEYS = np.array([np.nan, -np.inf, -3.5, -0.0, 0.0, 1.0, 1.0, 1.0, 2.5,
                       7.0, 1e30, np.inf])


def _window_inputs(name, vdtype=np.float64, key="int", dead=0.0,
                   special=False, seed=5):
    """(partition key, order key, values, valid, alive) of a shape: rows of
    segments _lens(name) in random input order, an order key per row
    (int: distinct row numbers; float32 / float64: FLOAT_KEYS plus small
    integers; int32_edge / int64_edge: values at the int32 range's ends),
    values holding NaN and +-inf where special, a dead share of rows."""
    rng = np.random.default_rng(seed)
    lens = _lens(name, rng)
    part = np.repeat(np.arange(len(lens)), lens).astype(np.int32)
    n = len(part)
    if key == "int":
        okey = rng.permutation(n).astype(np.int32)
    elif key in ("float32", "float64"):
        k = FLOAT_KEYS[rng.integers(0, len(FLOAT_KEYS), n)]
        k = np.where(rng.random(n) < 0.5, k + rng.integers(1, 20, n), k)
        okey = k.astype(key)
    else:
        info = np.iinfo(np.int32)
        okey = np.where(rng.random(n) < 0.5,
                        rng.integers(info.min, info.min + 60, n),
                        rng.integers(info.max - 60, info.max, n,
                                     endpoint=True))
        okey = okey.astype(np.int32 if key == "int32_edge" else np.int64)
    vals = rng.normal(300, 100, n).astype(vdtype)
    if special:
        for v, share in ((np.nan, 0.01), (np.inf, 0.01), (-np.inf, 0.01)):
            vals[rng.random(n) < share] = v
    valid = rng.random(n) < 0.9
    alive = rng.random(n) >= dead
    perm = rng.permutation(n)
    return part[perm], okey[perm], vals[perm], valid[perm], alive[perm]


def _check_aggregate(fn, frame, part, okey, vals, valid, alive):
    want = JW.window_aggregate([jnp.asarray(part)], [jnp.asarray(okey)],
                               [False], fn, jnp.asarray(vals),
                               jnp.asarray(valid), jnp.asarray(alive), frame)
    got = TW.window_aggregate([_t(part)], [_t(okey)], [False], fn, _t(vals),
                              _t(valid), _t(alive), frame)
    res, wres = got[0].numpy(), np.asarray(want[0])
    keep = alive.copy()
    if want[1] is not None:
        np.testing.assert_array_equal(got[1].numpy()[keep],
                                      np.asarray(want[1])[keep])
        keep &= np.asarray(want[1])
    _same_bits(res[keep], wres[keep])


# (shape, frame, functions, value dtypes, order key, dead share, special)
AGGREGATE_CASES = {
    "tile_edges_rows": ("tile_edges", ("rows", 3, 0), ("sum", "count", "min"),
                        (np.float64, np.float32), "int", 0.0, False),
    "many_in_tile_rows": ("many_in_tile", ("rows", 1, 1),
                          ("sum", "avg", "max"), (np.float64, np.float32),
                          "int", 0.0, False),
    "many_in_tile_unbounded_preceding": (
        "many_in_tile", ("rows", None, 2), ("sum",), (np.float64,), "int",
        0.0, False),
    "small_unbounded_following": ("small", ("rows", 3, None), ("sum", "min"),
                                  (np.float64, np.float32), "int", 0.0,
                                  False),
    "small_unbounded_both": ("small", ("rows", None, None), ("sum",),
                             (np.float32,), "int", 0.0, False),
    "one_5000_rows": ("one_5000", ("rows", 2, 5), ("sum",),
                      (np.float64, np.float32), "int", 0.0, False),
    "wide_rows": ("wide", ("rows", 5000, 3000), ("sum", "count", "min"),
                  (np.float64,), "int", 0.0, False),
    "tile_edges_wide_minmax": ("tile_edges", ("rows", 5000, 3000),
                               ("count", "max"), (np.float64,), "int", 0.0,
                               False),
    "range_float64_keys": ("small", ("range", 3, 2), ("sum", "count", "max"),
                           (np.float64, np.float32), "float64", 0.0, False),
    "range_float32_keys": ("small", ("range", 0, 0), ("sum", "count"),
                           (np.float64,), "float32", 0.0, False),
    "range_float_unbounded_start": ("small", ("range", None, 5),
                                    ("sum", "min"), (np.float64,),
                                    "float64", 0.0, False),
    "range_float_unbounded_end": ("small", ("range", 4, None),
                                  ("count", "max"), (np.float64,),
                                  "float32", 0.0, False),
    "range_int32_past_range": ("small", ("range", 3 * 2**31, 2**31 + 5),
                               ("sum", "count", "min"), (np.float64,),
                               "int32_edge", 0.0, False),
    "range_int64_keys": ("small", ("range", 2**32 + 7, 40), ("sum", "count"),
                         (np.float64,), "int64_edge", 0.0, False),
    "dead_tail_rows": ("small", ("rows", 2, 1), ("sum", "count"),
                       (np.float64, np.float32), "int", 0.3, False),
    "dead_tail_range": ("small", ("range", 3, 3), ("sum", "max"),
                        (np.float64,), "float64", 0.3, False),
    "nan_inf_values_rows": ("small", ("rows", 3, 0), ("sum", "avg"),
                            (np.float64, np.float32), "int", 0.1, True),
    "nan_inf_values_range": ("small", ("range", 5, 5), ("sum",),
                             (np.float64, np.float32), "float64", 0.0, True),
}


def _aggregate_params():
    for name, (shape, frame, fns, vdtypes, key, dead, special) in \
            AGGREGATE_CASES.items():
        for fn in fns:
            for vd in vdtypes:
                yield pytest.param(shape, frame, fn, vd, key, dead, special,
                                   id=f"{name}-{fn}-{np.dtype(vd).name}")


@pytest.mark.parametrize("shape, frame, fn, vdtype, key, dead, special",
                         list(_aggregate_params()))
def test_window_aggregate_matches_reference(shape, frame, fn, vdtype, key,
                                            dead, special):
    part, okey, vals, valid, alive = _window_inputs(
        shape, vdtype, key, dead, special)
    _check_aggregate(fn, frame, part, okey, vals, valid, alive)


# ---------------------------------------------------------------------
# frame_bounds_plain and sliding_sums_plain against the reference's parts
# ---------------------------------------------------------------------

def _sorted_rows(shape, key, seed=9):
    """Segment starts and an order key sorted within each segment (NaNs
    last, -0.0 equal to 0.0), as ops/window.py's sort leaves them."""
    part, okey, _v, _valid, _alive = _window_inputs(shape, key=key, seed=seed)
    canon = np.where(np.isnan(okey), np.inf, okey) \
        if okey.dtype.kind == "f" else okey
    nan = np.isnan(okey) if okey.dtype.kind == "f" else np.zeros(len(okey))
    order = np.lexsort((nan, canon, part))
    part, okey = part[order], okey[order]
    seg = np.r_[True, part[1:] != part[:-1]]
    return seg, okey


def _reference_bounds(seg, mode, start, end, key):
    """window.py:146-204 on JAX: seg_first/seg_last and, for RANGE, the
    lexicographic search (its step past n clamped, as the port does)."""
    n = len(seg)
    seg_ids = np.cumsum(seg) - 1
    first = np.flatnonzero(seg)
    sf = first[seg_ids]
    sl = np.r_[first[1:], n][seg_ids] - 1
    idx = np.arange(n)
    if mode == "rows":
        lo = sf if start is None else np.maximum(sf, idx - start)
        hi = sl if end is None else np.minimum(sl, idx + end)
    else:
        sv = key if key.dtype.kind == "f" else key.astype(np.int64)
        sid = jnp.asarray(seg_ids.astype(np.int32))
        lo = sf if start is None else np.minimum(np.asarray(
            JW._lex_searchsorted(sid, jnp.asarray(sv), sid,
                                 jnp.asarray(sv - sv.dtype.type(start)),
                                 "left")), n)
        hi = sl if end is None else np.minimum(np.asarray(
            JW._lex_searchsorted(sid, jnp.asarray(sv), sid,
                                 jnp.asarray(sv + sv.dtype.type(end)),
                                 "right")), n) - 1
    hi = np.maximum(hi, lo - 1)
    return lo.astype(np.int32), hi.astype(np.int32)


BOUNDS_CASES = {
    "tile_edges_rows_3_0": ("tile_edges", "int", ("rows", 3, 0)),
    "tile_edges_rows_wide": ("tile_edges", "int", ("rows", 5000, 3000)),
    "tile_edges_unbounded_start": ("tile_edges", "int", ("rows", None, 2)),
    "many_in_tile_unbounded_end": ("many_in_tile", "int", ("rows", 4, None)),
    "float64_keys": ("small", "float64", ("range", 3, 2)),
    "float32_keys": ("small", "float32", ("range", 0, 0)),
    "float_keys_unbounded_start": ("small", "float64", ("range", None, 5)),
    "int32_past_range": ("small", "int32_edge", ("range", 3 * 2**31, 2**31)),
    "int64_keys": ("small", "int64_edge", ("range", 2**32 + 7, 40)),
    "one_5000_range": ("one_5000", "int", ("range", 40, 10)),
}


@pytest.mark.parametrize("name", sorted(BOUNDS_CASES))
def test_frame_bounds_plain_matches_reference(name):
    shape, key, (mode, start, end) = BOUNDS_CASES[name]
    seg, okey = _sorted_rows(shape, key)
    got = TW.frame_bounds_plain(_t(seg), mode, start, end, _t(okey))
    want = _reference_bounds(seg, mode, start, end, okey)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("vdtype", (np.float64, np.float32),
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("name", ("tile_edges_rows_3_0", "float64_keys",
                                  "many_in_tile_unbounded_end",
                                  "one_5000_range"))
def test_sliding_sums_plain_matches_reference(name, vdtype):
    """With NaN keys' frames stepping back, and a dead tail whose rows are
    each their own segment with an empty frame (as window_aggregate hands
    them over)."""
    shape, key, (mode, start, end) = BOUNDS_CASES[name]
    seg, okey = _sorted_rows(shape, key)
    lo, hi = _reference_bounds(seg, mode, start, end, okey)
    n = len(seg)
    rng = np.random.default_rng(13)
    vals = rng.normal(300, 100, n).astype(vdtype)
    vals[rng.random(n) < 0.01] = np.nan
    dead = np.arange(n) >= n - n // 10
    pos = np.arange(n, dtype=np.int32)
    lo, hi = np.where(dead, pos, lo), np.where(dead, pos - 1, hi)
    starts = seg | dead
    want = JW._sliding_float_sums(jnp.asarray(vals), jnp.asarray(lo),
                                  jnp.asarray(hi), jnp.asarray(starts))
    got = TW.sliding_sums_plain(_t(vals), _t(lo), _t(hi), _t(starts))
    _same_bits(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------
# a model of W3's launches
# ---------------------------------------------------------------------

def _w3_model(seg, mode, start, end, key, tile=W3_TILE, items=W3_ITEMS):
    """W3 as the kernel computes it. Launch 1's look-back gives each tile
    the last start before it, launch 2's the first start after it; each
    thread of `items` rows takes its rows' segment bounds from its own
    flags and those; RANGE: the thread's first row's bounds searched out
    from the row itself (lo galloping back from r, hi forward from r + 1),
    the next rows' stepped forward (four rows read at once, then
    galloping), a new search at a segment start or where q is not at least
    the previous row's, and a binary search of the whole segment where q
    is not on the row's side (a NaN, a wrapped sum)."""
    n = len(seg)
    seg = seg.copy()
    seg[0] = True
    ntiles = -(-n // tile)
    starts = np.flatnonzero(seg)
    tile_last = np.full(ntiles, -1)
    tile_first = np.full(ntiles, n)
    for s in starts:
        tile_last[s // tile] = s
        tile_first[s // tile] = min(tile_first[s // tile], s)
    prev = np.r_[-1, np.maximum.accumulate(tile_last)[:-1]]
    nxt = np.r_[np.minimum.accumulate(tile_first[::-1])[::-1][1:], n]
    lo = np.empty(n, np.int64)
    hi = np.empty(n, np.int64)
    q_of = (lambda v, d: v + v.dtype.type(d)) if key is not None and \
        key.dtype.kind == "f" else (lambda v, d: int(v) + d)

    def search(f, e, q, upper):
        a, b = f, e
        while a < b:
            mid = (a + b) // 2
            below = key[mid] <= q if upper else key[mid] < q
            a, b = (mid + 1, b) if below else (a, mid)
        return a

    def below(j, q, upper):
        return key[j] <= q if upper else key[j] < q

    def forward(p, e, q, upper):
        # the number of the next four rows below q, then (all four below)
        # steps of 1, 2, 4, ... and a binary search
        run = sum(p + k < e and bool(below(min(p + k, e - 1), q, upper))
                  for k in range(4))
        if run < 4:
            return p + run
        a, step = p + 4, 1
        while True:
            probe = a - 1 + step
            if probe >= e:
                return search(a, e, q, upper)
            if not below(probe, q, upper):
                return search(a, probe, q, upper)
            a, step = probe + 1, step * 2

    def backward(f, hi_, q, upper):
        # the answer in [f, hi_], hi_ not below q
        step = 1
        while True:
            probe = hi_ - step
            if probe < f:
                return search(f, hi_, q, upper)
            if below(probe, q, upper):
                return search(probe + 1, hi_, q, upper)
            hi_, step = probe, step * 2

    for t0 in range(0, n, items):
        rows = range(t0, min(n, t0 + items))
        tile_i = t0 // tile
        in_tile = [s for s in starts if tile_i * tile <= s < t0]
        f = max([prev[tile_i]] + in_tile)
        fresh, ql, qh, pl, ph = True, None, None, 0, 0
        for r in rows:
            if seg[r]:
                f = r
                fresh = True
            later = starts[starts > r]
            e = int(later[0]) if len(later) and later[0] < (tile_i + 1) * \
                tile else int(nxt[tile_i])
            if mode == "rows":
                lo[r] = f if start is None else max(f, r - start)
                hi[r] = e - 1 if end is None else min(e - 1, r + end)
            else:
                lo[r], hi[r] = f, e - 1
                if start is not None:
                    q = q_of(key[r], -start)
                    if not q <= key[r]:
                        pl = search(f, e, q, False)
                    elif fresh or not q >= ql:
                        pl = backward(f, r, q, False)
                    else:
                        pl = forward(pl, e, q, False)
                    ql, lo[r] = q, pl
                if end is not None:
                    q = q_of(key[r], end)
                    if not q >= key[r]:
                        ph = search(f, e, q, True)
                    else:
                        ph = forward(r + 1 if fresh or not q >= qh else ph,
                                     e, q, True)
                    qh, hi[r] = q, ph - 1
                fresh = False
            hi[r] = max(hi[r], lo[r] - 1)
    return lo.astype(np.int32), hi.astype(np.int32)


W3_MODEL_CASES = [
    ("tile_edges", "int", ("rows", 3, 0), W3_TILE),
    ("tile_edges", "int", ("rows", None, 7), W3_TILE),
    ("small", "int", ("range", 30, 30), 64),
    ("small", "float64", ("range", 3, 2), 64),
    ("small", "float32", ("range", None, 4), 32),
    ("small", "float64", ("range", 5, None), 32),
    ("small", "int32_edge", ("range", 3 * 2**31, 2**31), 64),
    ("small", "int64_edge", ("range", 2**32 + 7, 40), 64),
    ("one_5000", "int", ("range", 400, 300), 256),
    ("many_in_tile", "int", ("range", 2, 2), 16),
]


@pytest.mark.parametrize("shape, key, frame, tile", W3_MODEL_CASES,
                         ids=lambda v: str(v))
def test_w3_model_matches_plain(shape, key, frame, tile):
    seg, okey = _sorted_rows(shape, key)
    got = _w3_model(seg, *frame, okey, tile=tile)
    want = TW.frame_bounds_plain(_t(seg), *frame, _t(okey))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


def test_w3_model_unsorted_dead_rows_stay_in_their_segment():
    """Keys of dead rows are not sorted: the model's steps never leave a
    row's segment, so every live row's bounds are the plain version's."""
    seg, okey = _sorted_rows("small", "float64")
    n = len(seg)
    rng = np.random.default_rng(17)
    tail = n - 300
    okey = okey.copy()
    okey[tail:] = rng.permutation(okey[tail:])
    seg = seg.copy()
    seg[tail] = True
    got = _w3_model(seg, "range", 3, 2, okey, tile=64)
    want = TW.frame_bounds_plain(_t(seg), "range", 3, 2, _t(okey))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[:tail], w.numpy()[:tail])
        assert np.all((g[tail:] >= tail) & (g[tail:] < n + 1))


# ---------------------------------------------------------------------
# a model of W4's routes
# ---------------------------------------------------------------------

def _w4_walk_direct(c, lo, hi, s0, e0, out):
    """The reference's step over rows [s0, e0) of one segment."""
    s = c.dtype.type(0)
    plo = pend = int(lo[s0])
    for r in range(s0, e0):
        lr, er = int(lo[r]), int(hi[r]) + 1
        for j in range(plo, lr):
            s = s - c[j]
        for j in range(max(pend, lr), er):
            s = s + c[j]
        out[r] = s
        plo, pend = lr, er


def _w4_walk_stream(c, lo, hi, s0, e0, out, chunk, cap):
    """The long route: rows chunk by chunk (chunks aligned to `chunk` rows
    from s0's), each row's steps counted and laid out in order as one
    stream (a subtracted value negated), walked piece by piece of at most
    `cap` steps padded to 8 with -0.0, and each row read back at its last
    step (the chunk's running sum where it has none)."""
    s = c.dtype.type(0)
    neg_zero = -c.dtype.type(0)
    p_lo = p_end = int(lo[s0])
    c0 = s0 - s0 % chunk
    for cb in range(c0, e0, chunk):
        rows = range(max(s0, cb), min(e0, cb + chunk))
        ends, frames = [], []
        run = 0
        for i, r in enumerate(rows):
            pl = p_lo if i == 0 else int(lo[r - 1])
            pe = p_end if i == 0 else int(hi[r - 1]) + 1
            lr, er = int(lo[r]), int(hi[r]) + 1
            subs = max(lr - pl, 0)
            start_add = max(pe, lr)
            run += subs + max(er - start_add, 0)
            ends.append(run)
            frames.append((lr, subs, start_add))
        carry = s
        stream = []
        for (lr, subs, start_add), end, prev_end in zip(
                frames, ends, [0] + ends[:-1]):
            for o in range(end - prev_end):
                stream.append(-c[lr - subs + o] if o < subs
                              else c[start_add + o - subs])
        sums = []
        for p0 in range(0, max(len(stream), 1), cap):
            piece = stream[p0:p0 + cap]
            piece += [neg_zero] * (-len(piece) % 8)
            for v in piece:
                s = s + v
                sums.append(s)
        for r, end in zip(rows, ends):
            out[r] = sums[end - 1] if end else carry
        p_lo, p_end = int(lo[rows[-1]]), int(hi[rows[-1]]) + 1


def _w4_model(c, lo, hi, is_start, tile=W4_TILE, span=W4_SPAN, chunk=CHUNK,
              cap=CAP):
    """W4's two launches: each tile's segments that end within `span` rows
    of its start walked directly (the short route), its last one otherwise
    put on the long list and walked as a stream (the long route). Returns
    (sums, the long segments' starts)."""
    n = len(c)
    starts = np.flatnonzero(is_start | (np.arange(n) == 0))
    ends = np.r_[starts[1:], n]
    out = np.empty_like(c)
    long_starts = []
    for s0, e0 in zip(starts, ends):
        base = s0 - s0 % tile
        if e0 <= base + span or base + span >= n:
            _w4_walk_direct(c, lo, hi, s0, e0, out)
        else:
            long_starts.append(int(s0))
            _w4_walk_stream(c, lo, hi, s0, e0, out, chunk, cap)
    return out, long_starts


def _w4_inputs(name, dtype, seed=19):
    """(values, lo, hi, segment starts) of W4's model cases."""
    rng = np.random.default_rng(seed)
    lens = {"tile_edges": [1023, 1024, 1025, 2047, 2048, 2049, 4097, 1, 30],
            "long_mid_tile": [1000, 9000, 30, 31, 7],
            "unbounded_following": [6000], "wide": [4200, 4500]}.get(name)
    if lens is None:
        lens = list(rng.integers(1, 60, 200))
    seg = np.zeros(sum(lens), bool)
    seg[np.cumsum([0] + lens[:-1])] = True
    n = len(seg)
    c = rng.normal(300, 100, n).astype(dtype)
    c[rng.random(n) < 0.002] = np.nan
    c[rng.random(n) < 0.002] = np.inf
    frame = {"unbounded_following": ("rows", 3, None),
             "wide": ("rows", 700, 300)}.get(name, ("rows", 3, 1))
    if name == "steps_back":
        key = np.sort(rng.integers(0, 500, n) + np.cumsum(seg) * 1000)
        key = (key - np.cumsum(seg) * 1000).astype(np.float64)
        key[rng.random(n) < 0.05] = np.nan
        key = key[np.lexsort((np.isnan(key), np.cumsum(seg)))]
        lo, hi = TW.frame_bounds_plain(_t(seg), "range", 40, 10, _t(key))
    else:
        lo, hi = TW.frame_bounds_plain(_t(seg), *frame)
    lo, hi = lo.numpy(), hi.numpy()
    if name == "steps_back":
        dead = np.arange(n) >= n - 400
        pos = np.arange(n, dtype=np.int32)
        lo, hi = np.where(dead, pos, lo), np.where(dead, pos - 1, hi)
        seg = seg | dead
    return c, lo, hi, seg


# (case, tile, span, chunk, cap, long segments expected)
W4_MODEL_CASES = [
    ("tile_edges", W4_TILE, W4_SPAN, CHUNK, CAP, True),
    ("long_mid_tile", W4_TILE, W4_SPAN, CHUNK, CAP, True),
    ("unbounded_following", W4_TILE, W4_SPAN, CHUNK, CAP, True),
    ("short", 32, 64, 16, 24, True),
    ("steps_back", 32, 64, 16, 24, True),
    ("wide", 256, 512, 64, 136, True),
    ("short", W4_TILE, W4_SPAN, CHUNK, CAP, False),
]


@pytest.mark.parametrize("dtype", (np.float64, np.float32),
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("name, tile, span, chunk, cap, has_long",
                         W4_MODEL_CASES, ids=lambda v: str(v))
def test_w4_model_matches_plain(name, tile, span, chunk, cap, has_long,
                                dtype):
    c, lo, hi, seg = _w4_inputs(name, dtype)
    got, long_starts = _w4_model(c, lo, hi, seg, tile, span, chunk, cap)
    assert bool(long_starts) == has_long
    want = TW.sliding_sums_plain(_t(c), _t(lo), _t(hi), _t(seg))
    _same_bits(got, want.numpy())


@pytest.mark.parametrize("dtype", (np.float64, np.float32),
                         ids=lambda d: np.dtype(d).name)
def test_negated_step_and_padding_are_exact(dtype):
    """The long route's two identities, over every pair of a value pool
    with both zeros, infinities, subnormals and NaN: s + (-x) is s - x, and
    s + (-0.0) is s."""
    t = np.dtype(dtype).type
    pool = np.array([0.0, -0.0, 1.0, -1.0, 1e-300 if dtype == np.float64
                     else 1e-40, np.inf, -np.inf, np.nan, 3.141592653589793,
                     -2.5e10, 7e-5], dtype=dtype)
    s, x = np.meshgrid(pool, pool)
    _same_bits(s + (-x), s - x)
    _same_bits(s + t(-0.0), s)
