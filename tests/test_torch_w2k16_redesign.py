"""W2's and K16's redesign: the plain versions and numpy models of the
kernels on the CPU, and the kernels against their plain versions on the
card. The module imports neither jax nor quickstep_tpu; the cases that
hold the port against quickstep_tpu import it themselves and skip where it
cannot be imported, so the file also runs on a machine that has a card and
no JAX:

    python -m pytest --noconftest tests/test_torch_w2k16_redesign.py -q

W2 (csrc/window_kernels.cu, frame MIN/MAX): the plain version against
quickstep_tpu's _range_query_minmax for every dtype, MIN and MAX, over
frames inside one 32-row block, across blocks, across 1,024-row tiles,
past 8 tiles, and empty ones (at a segment's first row, and at the dead
rows that sort last), over values with NaN, -0.0, +0.0 and the sentinels.
A numpy model of the kernel's data flow (each tile's frames staged in a
window with 32-row blocks' prefix and suffix and a sparse table over the
blocks; tiles whose frames leave the window answered from the table of
block, tile and superblock aggregates) is held against the plain version,
at the kernel's sizes and at a radix of 4, and counts the values each row
reads. On the card: the kernel against the plain version on each route.

K16 (csrc/shuffle_kernels.cu, the shuffle join's bloom filter): on the card
its table is one bit a slot in presence_words' int32 words. presence_words
of quickstep_tpu's bloom_build table round-trips through presence_bits,
and the OR of shards' words is the words of the OR. On the card: build and
probe against the plain versions at 2^10 to 2^22 slots, at 1, 15, 16, 17
and 1 M + 3 rows, on slices at an odd offset and on a table ORed over 8
shards.

Integers and bools compare exactly; floats with rtol = atol = 0 and NaN
equal to NaN (torch.equal would fail on NaN; -0.0 equals +0.0, whose order
MIN/MAX leaves open).
"""

import numpy as np
import pytest
import torch

from quickstep_tpu_torch.ops import bloom as TB
from quickstep_tpu_torch.ops import cuda as TC
from quickstep_tpu_torch.ops import window as TW

DTYPES = (torch.int32, torch.int64, torch.float32, torch.float64)
NP = {torch.int32: np.int32, torch.int64: np.int64,
      torch.float32: np.float32, torch.float64: np.float64}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.cpu(), want.cpu()
    if g.dtype.is_floating_point:
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    else:
        assert torch.equal(g, w)


# ---------------------------------------------------------------------
# W2 inputs: frames of every kind
# ---------------------------------------------------------------------

def _sentinel(fn, dtype):
    return TW.max_sentinel(dtype) if fn == "min" else TW.min_sentinel(dtype)


def _values(dtype, n, rng, fn):
    """Values with the sentinels, and for floats NaN, -0.0 and +0.0."""
    if dtype.is_floating_point:
        v = rng.normal(0, 100, n).astype(NP[dtype])
        pick = rng.random(n)
        v[pick < 0.02] = np.nan
        v[(pick >= 0.02) & (pick < 0.06)] = -0.0
        v[(pick >= 0.06) & (pick < 0.10)] = 0.0
        v[(pick >= 0.10) & (pick < 0.12)] = np.inf
        v[(pick >= 0.12) & (pick < 0.14)] = -np.inf
    else:
        info = np.iinfo(NP[dtype])
        v = rng.integers(-10 ** 6, 10 ** 6, n).astype(NP[dtype])
        pick = rng.random(n)
        v[pick < 0.03] = info.max
        v[(pick >= 0.03) & (pick < 0.06)] = info.min
    return v


# name: (rows, mean segment length or None for one segment, ROWS frame
# (preceding, following); following -1 leaves a segment's first row empty)
FRAMES = {
    "in_block": (5_000, 40, (2, 3)),
    "cross_block": (5_000, 300, (20, 25)),
    "cross_tile": (9_000, None, (700, 600)),
    "past_8_tiles": (40_000, None, (9_000, 0)),
    "empty_first_row": (5_000, 12, (3, -1)),
    "far_from_row": (20_000, None, (5_000, -3_000)),
}


def _frames(name, rng):
    """(lo, hi) int32 of a ROWS frame over sorted segments, the last tenth
    of the rows dead (sorted last, empty frames hi = lo - 1)."""
    n, seg_len, (pre, post) = FRAMES[name]
    seg = rng.random(n) < (0.0 if seg_len is None else 1.0 / seg_len)
    seg[0] = True
    dead = n - n // 10
    seg[dead] = True
    idx = np.arange(n)
    first = np.maximum.accumulate(np.where(seg, idx, 0))
    starts = np.flatnonzero(seg)
    last = np.repeat(np.append(starts[1:], n) - 1, np.diff(np.append(
        starts, n)))
    lo = np.maximum(first, idx - pre)
    hi = np.minimum(last, idx + post)
    hi = np.maximum(hi, lo - 1)
    hi[dead:] = lo[dead:] - 1
    return lo.astype(np.int32), hi.astype(np.int32)


def _w2_case(name, dtype, fn, seed=14):
    rng = np.random.default_rng(seed)
    lo, hi = _frames(name, rng)
    c = _values(dtype, len(lo), rng, fn)
    return c, lo, hi


@pytest.mark.parametrize("name", sorted(FRAMES))
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("fn", ("min", "max"))
def test_w2_plain_matches_reference(fn, dtype, name):
    jnp = pytest.importorskip("jax.numpy")
    JW = pytest.importorskip("quickstep_tpu.ops.window")
    c, lo, hi = _w2_case(name, dtype, fn)
    want = np.asarray(JW._range_query_minmax(
        jnp.asarray(c), jnp.asarray(lo), jnp.asarray(hi), fn == "min"))
    got = TW.frame_minmax(fn, torch.from_numpy(c), torch.from_numpy(lo),
                          torch.from_numpy(hi))
    _same(got, torch.from_numpy(want))


def test_w2_frames_cover_every_kind():
    """The cases do reach what their names say."""
    lens = {}
    for name in FRAMES:
        lo, hi = _frames(name, np.random.default_rng(14))
        ne = hi >= lo
        lens[name] = (int((hi - lo + 1)[ne].max()), int((~ne).sum()),
                      bool(((lo >> 5) == (hi >> 5))[ne].all()),
                      bool((lo[ne] > np.arange(len(lo))[ne]).any()
                           or (hi[ne] < np.arange(len(lo))[ne]).any()))
    assert lens["in_block"][0] <= 6
    assert 32 < lens["cross_block"][0] < 1024
    assert 1024 < lens["cross_tile"][0] < 2048
    assert lens["past_8_tiles"][0] > 8 * 1024
    # the segment's first rows are empty beside the dead rows
    assert lens["empty_first_row"][1] > 500 + 100
    # frames that hold no row of their own
    assert lens["far_from_row"][3]


# ---------------------------------------------------------------------
# W2's data flow, modelled in numpy
# ---------------------------------------------------------------------

class W2Model:
    """csrc/window_kernels.cu's W2 at radix r: 32-row blocks, tiles of r
    blocks and superblocks of r tiles become r, r * r and r ** 3 rows; a
    tile is staged with `halo` rows on each side in blocks of `span` rows,
    and its frames answered there where they lie inside and span fewer
    than 2 ** levels whole blocks (walked where none is longer than
    `span` rows). Counts the values each row reads."""

    def __init__(self, fn, c, r=32, halo=64, span=8, levels=3):
        self.fn, self.c, self.r, self.halo = fn, c, r, halo
        self.span, self.levels = span, levels
        self.op = np.minimum if fn == "min" else np.maximum
        self.none = np.array(_sentinel(fn, torch.from_numpy(c[:1]).dtype),
                             dtype=c.dtype)
        self.reads = np.zeros(len(c), dtype=np.int64)
        self.deferred = []

    def _pre_suf(self, x, r=None):
        b = x.reshape(-1, r or self.r)
        pre = self.op.accumulate(b, axis=1)
        suf = self.op.accumulate(b[:, ::-1], axis=1)[:, ::-1]
        return pre.reshape(-1), suf.reshape(-1)

    def _walk(self, p, a, b, row, r=None):
        assert b - a < (r or self.r)
        self.reads[row] += b - a + 1
        return self.op.reduce(p[a:b + 1])

    def _sparse(self, agg, levels):
        sp = {0: agg}
        for k in range(1, levels):
            half = 1 << (k - 1)
            prev = sp[k - 1]
            m = len(agg) - (1 << k) + 1
            if m <= 0:
                break
            sp[k] = self.op(prev[:m], prev[half:half + m])
        return sp

    def run(self, lo, hi):
        n, r = len(self.c), self.r
        tile = r * r
        out = np.full(n, self.none, dtype=self.c.dtype)
        for t0 in range(0, n, tile):
            ll, hh = lo[t0:t0 + tile], hi[t0:t0 + tile]
            ne = hh >= ll
            if not ne.any():
                continue
            ws, wr = t0 - self.halo, tile + 2 * self.halo
            mn, mx = int(ll[ne].min()), int(hh[ne].max())
            q = self.span
            spans = int(((hh[ne] - ws) // q - (ll[ne] - ws) // q).max())
            if mn < ws or mx >= ws + wr or spans > 1 << self.levels:
                self.deferred.append(t0)
                continue
            sc = np.full(wr, self.none, dtype=self.c.dtype)
            a, b = max(ws, 0), min(ws + wr, n)
            sc[a - ws:b - ws] = self.c[a:b]
            if int((hh - ll + 1)[ne].max()) <= q:     # short frames: walks
                for i in np.flatnonzero(ne):
                    out[t0 + i] = self._walk(sc, int(ll[i]) - ws,
                                             int(hh[i]) - ws, t0 + i, q + 1)
                continue
            pre, suf = self._pre_suf(sc, q)
            b0, b1 = (mn - ws) // q, (mx - ws) // q
            levels = 1
            while (1 << levels) < spans:
                levels += 1
            agg = suf[::q].copy()
            agg[:b0] = agg[b1 + 1:] = self.none     # blocks never scanned
            sp = self._sparse(agg, levels)
            for i in np.flatnonzero(ne):
                out[t0 + i] = self._staged(sc, pre, suf, sp,
                                           int(ll[i]) - ws, int(hh[i]) - ws,
                                           t0 + i)
        if self.deferred:
            self._table()
            for t0 in self.deferred:
                for row in range(t0, min(t0 + tile, n)):
                    if hi[row] >= lo[row]:
                        out[row] = self._global(int(lo[row]), int(hi[row]),
                                                row)
        return out

    def _staged(self, sc, pre, suf, sp, j, k, row):
        q = self.span
        bl, bh = j // q, k // q
        if bl == bh:
            if j % q == 0:
                self.reads[row] += 1
                return pre[k]
            if k % q == q - 1:
                self.reads[row] += 1
                return suf[j]
            return self._walk(sc, j, k, row, q)
        acc = self.op(suf[j], pre[k])
        self.reads[row] += 2
        mid = bh - bl - 1
        if mid > 0:
            lev = mid.bit_length() - 1
            acc = self.op(acc, self.op(sp[lev][bl + 1],
                                       sp[lev][bh - (1 << lev)]))
            self.reads[row] += 2
        return acc

    def _table(self):
        r, n = self.r, len(self.c)
        nsuper = -(-n // r ** 3)
        cp = np.full(nsuper * r ** 3, self.none, dtype=self.c.dtype)
        cp[:n] = self.c
        self.agg = self.op.reduce(cp.reshape(-1, r), axis=1)
        self.pre, self.suf = self._pre_suf(self.agg)
        self.tagg = self.op.reduce(self.agg.reshape(-1, r), axis=1)
        self.tpre, self.tsuf = self._pre_suf(self.tagg)
        sagg = self.op.reduce(self.tagg.reshape(-1, r), axis=1)
        self.sp = self._sparse(sagg, nsuper.bit_length())

    def _global(self, l, h, row):
        r = self.r
        bl, bh = l // r, h // r
        if bl == bh:
            return self._walk(self.c, l, h, row)
        acc = self.op(self._walk(self.c, l, bl * r + r - 1, row),
                      self._walk(self.c, bh * r, h, row))
        b1, b2 = bl + 1, bh - 1
        if b1 > b2:
            return acc
        if b1 // r == b2 // r:
            return self.op(acc, self._walk(self.agg, b1, b2, row))
        acc = self.op(acc, self.op(self.suf[b1], self.pre[b2]))
        self.reads[row] += 2
        t1, t2 = b1 // r + 1, b2 // r - 1
        if t1 > t2:
            return acc
        if t1 // r == t2 // r:
            return self.op(acc, self._walk(self.tagg, t1, t2, row))
        acc = self.op(acc, self.op(self.tsuf[t1], self.tpre[t2]))
        self.reads[row] += 2
        s1, s2 = t1 // r + 1, t2 // r - 1
        if s1 > s2:
            return acc
        k = (s2 - s1 + 1).bit_length() - 1
        self.reads[row] += 2
        return self.op(acc, self.op(self.sp[k][s1],
                                    self.sp[k][s2 - (1 << k) + 1]))


# (radix, halo rows, staged block rows): the kernel's, and a radix of 4
# (16-row tiles, 64-row superblocks) whose frames reach every level of the
# global table
MODELS = {"r32_h64": (32, 64, 8), "r4_h4": (4, 4, 2)}


@pytest.mark.parametrize("name", sorted(FRAMES))
@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("fn", ("min", "max"))
def test_w2_model_matches_plain(fn, model, name):
    r, halo, span = MODELS[model]
    c, lo, hi = _w2_case(name, torch.float64, fn)
    m = W2Model(fn, c, r, halo, span)
    got = m.run(lo, hi)
    want = TW.frame_minmax_plain(fn, torch.from_numpy(c),
                                 torch.from_numpy(lo), torch.from_numpy(hi))
    _same(torch.from_numpy(got), want)
    # a bounded number of reads a row, whatever the frame's length: two
    # partial blocks and one walk of block or tile aggregates, or a suffix
    # and a prefix at each level and the sparse table
    assert int(m.reads.max()) <= 3 * r + 2


def test_w2_model_routes():
    """At the kernel's radix, W-Q5-like frames and frames of up to 65 rows
    stay staged; ROWS 100 PRECEDING (more than 8 whole 8-row blocks) and
    ROWS 1,500 PRECEDING defer every tile."""
    rng = np.random.default_rng(3)
    n = 20 * 1024
    idx = np.arange(n)
    c = rng.normal(size=n)
    lo = np.maximum(idx - 15, 0).astype(np.int32)
    hi = np.minimum(idx + 15, n - 1).astype(np.int32)
    m = W2Model("max", c)
    m.run(lo, hi)
    assert not m.deferred and int(m.reads.max()) <= 7
    hi = idx.astype(np.int32)
    every = list(range(0, n, 1024))
    for back, deferred in ((64, []), (100, every), (1_500, every)):
        lo = np.maximum(idx - back, 0).astype(np.int32)
        m = W2Model("max", c)
        m.run(lo, hi)
        assert m.deferred == deferred, back


def test_w2_table_size_matches_the_kernel():
    """ops/cuda.py frame_minmax's table: 32-row blocks, tiles and the
    sparse table, whole superblocks of 32 tiles."""
    for n in (1, 1024, 32_768, 32_769, 60_000_000):
        nsuper = -(-n // 32_768)
        assert nsuper * 32 * 32 >= -(-n // 32)
        assert (1 << (nsuper.bit_length() - 1)) <= nsuper


def test_w2_wrapper_rejects_cpu_tensors():
    c = torch.zeros(4, dtype=torch.float64)
    lo = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="needs CUDA"):
        TC.frame_minmax("max", c, lo, lo)


# ---------------------------------------------------------------------
# K16 on the CPU: the table of words
# ---------------------------------------------------------------------

def _jax_bloom(keys, alive, nbits):
    jnp = pytest.importorskip("jax.numpy")
    JB = pytest.importorskip("quickstep_tpu.ops.bloom")
    return torch.from_numpy(np.asarray(JB.bloom_build(
        [jnp.asarray(keys)], jnp.asarray(alive), nbits)))


@pytest.mark.parametrize("nbits", (1 << 10, 1 << 22))
def test_bloom_words_round_trip(nbits):
    rng = np.random.default_rng(16)
    keys = rng.integers(1, 4 * 10 ** 6, 100_000)
    alive = rng.random(100_000) < 0.5
    bits = _jax_bloom(keys, alive, nbits)
    words = TB.presence_words(bits)
    assert words.dtype == torch.int32 and words.shape == (nbits // 32,)
    assert words.shape[0] == TC.bloom_words(nbits)
    assert torch.equal(TB.presence_bits(words, nbits), bits)
    # the plain build is the reference's table
    assert torch.equal(TB.bloom_build([torch.from_numpy(keys)],
                                      torch.from_numpy(alive), nbits), bits)


@pytest.mark.parametrize("nbits", (1 << 10, 1 << 22))
def test_bloom_words_or_over_shards(nbits):
    """The mesh ORs each shard's table (exec/runner.py): the OR of the
    shards' words is the words of the OR of their bools."""
    rng = np.random.default_rng(17)
    shards = [_jax_bloom(rng.integers(1, 10 ** 7, 20_000),
                         rng.random(20_000) < 0.7, nbits) for _ in range(8)]
    words = TB.presence_words(shards[0])
    bits = shards[0]
    for s in shards[1:]:
        words = words | TB.presence_words(s)
        bits = bits | s
    assert torch.equal(words, TB.presence_words(bits))


def test_bloom_words_count():
    assert TC.bloom_words(16) == 1 and TC.bloom_words(1 << 22) == 1 << 17
    assert TC.bloom_words(32) == 1 and TC.bloom_words(33) == 2


def test_bloom_probe_refuses_cpu_tensors():
    keys = torch.arange(4, dtype=torch.int64)
    alive = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="needs CUDA"):
        TC.bloom_probe(torch.zeros(1, dtype=torch.int32), [keys], alive)


def test_bloom_probe_checks_the_table_size_on_cpu():
    keys = torch.arange(10, dtype=torch.int64)
    alive = torch.ones(10, dtype=torch.bool)
    bits = TB.bloom_build([keys], alive, 64)
    assert torch.equal(TB.bloom_probe(bits, [keys], alive, 64), alive)
    with pytest.raises(ValueError, match="64 slots, not 128"):
        TB.bloom_probe(bits, [keys], alive, 128)


# ---------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------

# rows of each W2 route: tiles staged (W-Q5's and W-Q6's frames, ROWS 60
# PRECEDING, which reaches the halo), tiles deferred to the table (ROWS 100
# PRECEDING, past the staged sparse table; ROWS 1,500 PRECEDING,
# 5,000/3,000, the whole segment), tiles whose frames are all empty, and n
# off the tile
W2_ROUTES = {
    "staged_range": 300_007, "staged_rows_1_1": 300_007,
    "rows_60_preceding": 100_003, "rows_100_preceding": 100_003,
    "rows_1500_preceding": 200_003,
    "rows_5000_3000": 200_003, "whole_segment": 100_000,
    "all_empty_tiles": 5_000, "in_block": 1_003,
}


def _w2_route_inputs(name, dtype, fn, dev):
    rng = np.random.default_rng(41)
    n = W2_ROUTES[name]
    idx = np.arange(n)
    if name == "staged_range":
        seg = rng.random(n) < 1 / 600
    elif name == "staged_rows_1_1":
        seg = rng.random(n) < 1 / 4
    else:
        seg = np.zeros(n, dtype=bool)
    seg[0] = True
    first = np.maximum.accumulate(np.where(seg, idx, 0))
    starts = np.flatnonzero(seg)
    last = np.repeat(np.append(starts[1:], n) - 1,
                     np.diff(np.append(starts, n)))
    pre, post = {"staged_range": (15, 15), "staged_rows_1_1": (1, 1),
                 "rows_60_preceding": (60, 0),
                 "rows_100_preceding": (100, 0),
                 "rows_1500_preceding": (1_500, 0),
                 "rows_5000_3000": (5_000, -3_000),
                 "whole_segment": (n, n), "all_empty_tiles": (2, -3),
                 "in_block": (2, 2)}[name]
    lo = np.maximum(first, idx - pre)
    hi = np.maximum(np.minimum(last, idx + post), lo - 1)
    if name == "all_empty_tiles":
        hi = lo - 1
    dead = n - n // 20
    hi[dead:] = lo[dead:] - 1
    c = _values(dtype, n, rng, fn)
    return [torch.from_numpy(a).to(dev) for a in (
        c, lo.astype(np.int32), hi.astype(np.int32))]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(W2_ROUTES))
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("fn", ("min", "max"))
def test_w2_kernel_matches_plain(card, fn, dtype, name):
    c, lo, hi = _w2_route_inputs(name, dtype, fn, card)
    TC.reset_launches()
    got = TW.frame_minmax(fn, c, lo, hi)
    assert TC.LAUNCHES["frame_minmax"] == 1
    _same(got, TW.frame_minmax_plain(fn, c, lo, hi))


@pytest.mark.cuda
def test_w2_kernel_on_unaligned_views(card):
    c, lo, hi = _w2_route_inputs("rows_1500_preceding", torch.float32,
                                 "min", card)
    # frames over rows 1.. of c, each input a view at an odd offset
    lo1 = torch.clamp(lo[1:] - 1, min=0)
    hi1 = torch.maximum(hi[1:] - 1, lo1 - 1)
    pad = torch.zeros(1, dtype=torch.int32, device=card)
    lo1, hi1 = torch.cat([pad, lo1])[1:], torch.cat([pad, hi1])[1:]
    got = TW.frame_minmax("min", c[1:], lo1, hi1)
    want = TW.frame_minmax_plain("min", c[1:], lo1, hi1)
    _same(got, want)


def _shard_keys(rng, n):
    return rng.integers(1, 4 * 10 ** 6, n)


@pytest.mark.cuda
@pytest.mark.parametrize("nbits", (1 << 10, 1 << 20, 1 << 21, 1 << 22))
def test_k16_probe_matches_plain(card, nbits):
    rng = np.random.default_rng(18)
    shards = [(_shard_keys(rng, 30_000), rng.random(30_000) < 0.6)
              for _ in range(8)]
    words, bits = None, None
    for k, a in shards:
        kt, at = torch.from_numpy(k).to(card), torch.from_numpy(a).to(card)
        w = TB.bloom_build([kt], at, nbits)
        b = TB.bloom_build_plain([kt], at, nbits)
        _same(TB.presence_bits(w, nbits), b)
        words = w if words is None else words | w
        bits = b if bits is None else bits | b
    _same(TB.presence_bits(words, nbits), bits)
    big = (1 << 20) + 3
    keys = torch.from_numpy(_shard_keys(rng, big + 1)).to(card)
    keys32 = keys.to(torch.int32)
    alive = torch.from_numpy(rng.random(big + 1) < 0.9).to(card)
    for n in (1, 15, 16, 17, big):
        for off in (0, 1):        # a slice at an odd element offset
            for k in (keys, keys32):
                kk, aa = k[off:off + n], alive[off:off + n]
                got = TC.bloom_probe(words, [kk], aa, nbits)
                _same(got, TB.bloom_probe_plain(bits, [kk], aa))
    # two key columns
    kk, aa = [keys[:big], keys32[:big]], alive[:big]
    w2 = TB.bloom_build(kk, aa, nbits)
    b2 = TB.bloom_build_plain(kk, aa, nbits)
    _same(TB.presence_bits(w2, nbits), b2)
    _same(TC.bloom_probe(w2, kk, aa, nbits),
          TB.bloom_probe_plain(b2, kk, aa))


@pytest.mark.cuda
def test_k16_refuses_wrong_tables(card):
    keys = torch.arange(64, device=card)
    alive = torch.ones(64, dtype=torch.bool, device=card)
    words = TB.bloom_build([keys], alive, 1 << 10)
    with pytest.raises(ValueError):
        TC.bloom_probe(words, [keys], alive, 1 << 11)
    big = torch.zeros(TC.bloom_words(1 << 24), dtype=torch.int32,
                      device=card)
    _same(TC.bloom_probe(big, [keys], alive, 1 << 24),
          torch.zeros(64, dtype=torch.bool, device=card))


@pytest.mark.cuda
def test_w2_and_k16_take_no_host_sync(card):
    c, lo, hi = _w2_route_inputs("rows_1500_preceding", torch.float64,
                                 "max", card)
    keys = torch.arange(1 << 21, device=card)
    alive = keys % 3 == 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        TW.frame_minmax("max", c, lo, hi)
        for slots in (1 << 22, 1 << 20):
            words = TB.bloom_build([keys], alive, slots)
            TC.bloom_probe(words, [keys], alive, slots)
    finally:
        torch.cuda.set_sync_debug_mode("default")
