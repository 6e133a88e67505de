"""K11's and W1's redesign: the parts that run on the CPU as models of the
kernels' data flow, and the kernels against their plain versions on the
card. The module imports neither jax nor quickstep_tpu; the cases that hold
the models against quickstep_tpu import it themselves and skip where it
cannot be imported, so the file also runs on a machine that has a card and
no JAX:

    python -m pytest --noconftest tests/test_torch_k11w1_redesign.py -q

K11 (csrc/hash_kernels.cu): keys made of integer columns of at most 64
bits in all take the key-in-slot route, whose slot holds the columns'
bits concatenated into one word; the packing (pack_words, the model of the
kernel's pack_word) is held against numpy and held injective on random
keys and on each column's edge values. A model of the route's build and
probe, one row at a time (read the slot, claim it if empty, a duplicate on
its own word, the all-ones key kept apart), is held against
quickstep_tpu's oa_build/oa_probe: matched exactly, every matched row
holding the probe's key, the rows themselves where the probe's key has one
live build row, and the dup flag held to the truth (the reference's may
miss duplicates, as tests/test_torch_hash.py states). On the card, each route against the plain version
exactly in the same terms.

W1 (csrc/window_kernels.cu): a numpy model of its three passes (tile
summaries and heads, the one-block scan with each tile's close and open
results, the rows resolved in their tile) at small tiles, in the running
and the whole-partition mode, against the plain version and against
quickstep_tpu's _segmented_scan, _prefix_to_peers and _seg_total exactly
on integers and MIN/MAX. On the card both modes against the plain version
(float sums within 32 eps x the live magnitudes, the plain's whole-array
cumsum being no closer; everything else exactly) and against themselves
bit for bit across two runs.
"""

import zlib

import numpy as np
import pytest
import torch

from quickstep_tpu_torch.ops import cuda as TC
from quickstep_tpu_torch.ops import join as TJ
from quickstep_tpu_torch.ops import kernels as TK
from quickstep_tpu_torch.ops import window as TW

I32 = np.iinfo(np.int32)
I64 = np.iinfo(np.int64)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# ---------------------------------------------------------------------
# K11 on the CPU: the route and the packed word
# ---------------------------------------------------------------------

@pytest.mark.parametrize("dtypes, word", [
    ((torch.int32,), True), ((torch.int32, torch.int32), True),
    ((torch.int64,), True), ((torch.bool, torch.int32), True),
    ((torch.uint8,) * 8, True), ((torch.int32, torch.int32, torch.int32),
                                 False),
    ((torch.int64, torch.int32), False), ((torch.uint8,) * 9, False),
    ((torch.float64,), False), ((torch.float32,), False),
    ((torch.int32, torch.float32), False)], ids=str)
def test_k11_route_by_dtypes(dtypes, word):
    assert TC.oa_word_route(dtypes) == word


def pack_words(cols):
    """The key-in-slot route's packed word of each row (int64 bits), as
    csrc/hash_kernels.cu pack_word makes it: the columns' bits
    concatenated, the first column highest; all ones marks an empty slot.
    Plain torch, on any device."""
    word = torch.zeros(cols[0].shape, dtype=torch.int64,
                       device=cols[0].device)
    for c in cols:
        bits = TC.OA_WORD_BITS[c.dtype]
        v = c.to(torch.int64)
        word = v if bits == 64 else (word << bits) | (v & ((1 << bits) - 1))
    return word


def _np_words(cols):
    """numpy's packing: each column's bits, the first column highest."""
    word = np.zeros(len(cols[0]), dtype=np.uint64)
    for c in cols:
        bits = 64 if c.dtype == np.int64 else 32 if c.dtype == np.int32 \
            else 8
        v = c.astype(np.int64).view(np.uint64) if bits == 64 else (
            c.astype(np.int64) & ((1 << bits) - 1)).astype(np.uint64)
        word = v if bits == 64 else (word << np.uint64(bits)) | v
    return word.view(np.int64)


LAYOUTS = {"i32": (np.int32,), "i32x2": (np.int32, np.int32),
           "i64": (np.int64,), "bool_i32": (np.bool_, np.int32),
           "u8_i32_u8": (np.uint8, np.int32, np.uint8)}


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("seed", range(3))
def test_k11_packed_words_match_numpy_and_are_injective(layout, seed):
    rng = np.random.default_rng(seed)
    n = 5000
    cols = []
    for dt in LAYOUTS[layout]:
        if dt == np.bool_:
            c = rng.random(n) < 0.5
        elif dt == np.uint8:
            c = rng.integers(0, 256, n).astype(np.uint8)
        else:
            info = np.iinfo(dt)
            c = rng.integers(-50, 50, n).astype(dt)
            edges = np.array([info.min, -1, 0, info.max], dtype=dt)
            c[:len(edges) ** 2] = np.tile(edges, len(edges)) if not cols \
                else np.repeat(edges, len(edges))
            c[rng.random(n) < 0.1] = edges[rng.integers(0, 4)]
        cols.append(c)
    got = pack_words([torch.from_numpy(c) for c in cols]).numpy()
    np.testing.assert_array_equal(got, _np_words(cols))
    keys = np.stack([c.astype(np.int64) for c in cols], axis=1)
    assert len(np.unique(keys, axis=0)) == len(np.unique(got))


def test_k11_empty_marker_is_one_key():
    """All ones marks an empty slot: exactly one key of each layout packs
    to it, and the kernel keeps that key apart."""
    ones = pack_words([torch.tensor([-1], dtype=torch.int32),
                             torch.tensor([-1], dtype=torch.int32)])
    assert int(ones) == -1
    assert int(pack_words([torch.tensor([-1])])) == -1
    assert int(pack_words([torch.tensor([-1], dtype=torch.int32)])) \
        == (1 << 32) - 1


def _mix64(w):
    """qs_mix64 of csrc/hash_device.cuh over uint64 words."""
    w = w ^ (w >> np.uint64(30))
    w = w * np.uint64(0xBF58476D1CE4E5B9)
    w = w ^ (w >> np.uint64(27))
    w = w * np.uint64(0x94D049BB133111EB)
    return w ^ (w >> np.uint64(31))


def k11_word_model(bwords, balive, pwords, palive, size):
    """oa_word_build_kernel then oa_word_probe_kernel, one build row at a
    time in row order: a row reads its slot, claims it if empty, is a
    duplicate if it holds its own word and else steps on; the all-ones key
    is held apart in `special`. Returns (dup, probe rows, matched)."""
    empty = np.uint64((1 << 64) - 1)
    bw, pw = bwords.view(np.uint64), pwords.view(np.uint64)
    slots = np.full(size, empty, dtype=np.uint64)
    rows = np.full(size, -1, dtype=np.int64)
    special, dup, mask = -1, False, size - 1
    home = (_mix64(bw) & np.uint64(mask)).astype(np.int64)
    for i in np.flatnonzero(balive):
        if bw[i] == empty:
            dup |= special != -1
            special = i if special == -1 else special
            continue
        s = home[i]
        while slots[s] != empty and slots[s] != bw[i]:
            s = (s + 1) & mask
        if slots[s] == bw[i]:
            dup = True
        else:
            slots[s], rows[s] = bw[i], i
    out = np.full(len(pw), -1, dtype=np.int64)
    phome = (_mix64(pw) & np.uint64(mask)).astype(np.int64)
    for i in np.flatnonzero(palive):
        if pw[i] == empty:
            out[i] = special
            continue
        s = phome[i]
        while slots[s] != empty and slots[s] != pw[i]:
            s = (s + 1) & mask
        out[i] = rows[s] if slots[s] == pw[i] else -1
    return dup, out, out >= 0


def _k11_keys(rng, layout, n, dups):
    """Key columns of one LAYOUTS entry, each integer column with its edge
    values, and the key that packs to all ones at row 5; with dups a third
    of the rows copy another row's key, and row 6 holds the all-ones key
    too."""
    cols = []
    for dt in LAYOUTS[layout]:
        if dt == np.bool_:
            c = rng.random(n) < 0.5
        elif dt == np.uint8:
            c = rng.integers(0, 256, n).astype(np.uint8)
        else:
            info = np.iinfo(dt)
            c = rng.integers(-2**19, 2**19, n).astype(dt)
            edges = np.array([info.min, -1, 0, info.max], dtype=dt)
            c[rng.random(n) < 0.05] = edges[rng.integers(0, 4)]
        cols.append(c)
    if dups:
        dst = rng.choice(n, n // 3, replace=False)
        src = rng.integers(0, n, n // 3)
        for c in cols:
            c[dst] = c[src]
    for c in cols:
        c[5:7 if dups else 6] = True if c.dtype == np.bool_ else \
            255 if c.dtype == np.uint8 else -1
    return cols


@pytest.mark.parametrize("load", (0.5, 0.94))
@pytest.mark.parametrize("dups", (False, True))
@pytest.mark.parametrize("layout", ("i32", "i32x2", "i64", "u8_i32_u8"))
def test_k11_word_model_matches_reference(layout, dups, load):
    """The key-in-slot route's model against quickstep_tpu's oa_build and
    oa_probe on the same keys, the all-ones key and the columns' edges
    among them, on both sides."""
    jnp = pytest.importorskip("jax.numpy")
    JJ = pytest.importorskip("quickstep_tpu.ops.join")
    rng = np.random.default_rng(zlib.crc32(f"{layout} {dups} {load}"
                                           .encode()))
    size = 2048
    n = int(size * load)
    cols = _k11_keys(rng, layout, n, dups)
    if dups:
        balive = rng.random(n) < 0.9
    else:                            # every live key once: load is exact
        keys = np.stack([c.astype(np.int64) for c in cols], axis=1)
        _, first = np.unique(keys, axis=0, return_index=True)
        balive = np.zeros(n, dtype=bool)
        balive[first] = True
        balive[(keys == keys[5]).all(axis=1)] = False
    balive[5:7 if dups else 6] = True
    pick = rng.integers(0, n, 3000)
    probe = [c[pick] for c in cols]
    for p in probe:                  # keys the build side does not hold
        p[:200] = rng.integers(0, 256, 200).astype(p.dtype) if \
            p.dtype == np.uint8 else (rng.random(200) < 0.5) if \
            p.dtype == np.bool_ else rng.integers(2**20, 2**21, 200)
    palive = rng.random(len(pick)) < 0.9
    palive[:3] = True
    for p in probe:
        p[1] = True if p.dtype == np.bool_ else -1 if p.dtype != np.uint8 \
            else 255
    tb = [torch.from_numpy(c) for c in cols]
    tp = [torch.from_numpy(p) for p in probe]
    dup, rows, matched = k11_word_model(
        pack_words(tb).numpy(), balive, pack_words(tp).numpy(), palive, size)
    rtable, rdup = JJ.oa_build([jnp.asarray(c) for c in cols],
                               jnp.asarray(balive), size)
    rrows, rmatched = JJ.oa_probe(rtable, [jnp.asarray(c) for c in cols],
                                  [jnp.asarray(p) for p in probe],
                                  jnp.asarray(palive))
    # the dup flag is held to the truth; the reference's losers step on
    # without comparing, so it may miss duplicates (tests/test_torch_hash.py)
    assert dup == dups
    assert dup or not bool(rdup)
    np.testing.assert_array_equal(matched, np.asarray(rmatched))
    assert matched[1] and matched.sum() > 100 and (~matched[palive]).sum()
    for c, p in zip(cols, probe):
        np.testing.assert_array_equal(c[rows[matched]], p[matched])
    # the row itself wherever the probe's key has one live build row
    bkeys = np.stack([c.astype(np.int64) for c in cols], axis=1)[balive]
    uniq, counts = np.unique(bkeys, axis=0, return_counts=True)
    once = {tuple(k) for k in uniq[counts == 1]}
    pkeys = np.stack([p.astype(np.int64) for p in probe], axis=1)
    single = np.array([tuple(k) in once for k in pkeys])
    assert single.sum() > 100
    np.testing.assert_array_equal(rows[single], np.asarray(rrows)[single])


# ---------------------------------------------------------------------
# W1 on the CPU: a model of the three passes
# ---------------------------------------------------------------------

def _combine(fn, a, b):
    if fn == "sum":
        return a + b
    if fn == "min":
        return min(a, b)
    if fn == "max":
        return max(a, b)
    return a


def _op(fn, a, b):
    """SegOp of csrc/seg_device.cuh over (f, v, c)."""
    return (a[0] | b[0], b[1] if b[0] else _combine(fn, a[1], b[1]),
            b[2] if b[0] else a[2] + b[2])


def w1_model(fn, vals, live, seg, peer, tile):
    """w1_tiles, w1_scan and w1_rows of csrc/window_kernels.cu over tiles of
    `tile` rows; peer None is the whole-partition mode."""
    n = len(live)
    ident = {"sum": 0, "count": 0, "min": I64.max, "max": I64.min}[fn]
    idn = (0, ident, 0)
    x = [(int(seg[r] or r == 0), 0 if vals is None else int(vals[r]),
          int(live[r])) for r in range(n)]
    bnd = [bool(seg[r] or r == 0 or (peer is not None and peer[r]))
           for r in range(n)]
    ntiles = -(-n // tile)
    tiles = [range(t * tile, min(n, (t + 1) * tile)) for t in range(ntiles)]
    summary, head, has_b = [], [], []
    for rows in tiles:
        s, h, seen = idn, idn, False
        for r in rows:
            s = _op(fn, s, x[r])
            seen = seen or bnd[r]
            if not seen:
                h = _op(fn, h, x[r])
        summary.append(s)
        head.append(h)
        has_b.append(seen)
    carry, carry_in, close = idn, [], {}
    for t in range(ntiles):
        carry_in.append(carry)
        if has_b[t]:
            close[t] = _op(fn, carry, (0, head[t][1], head[t][2]))
        carry = _op(fn, carry, summary[t])
    opened = []
    for t in range(ntiles):
        nxt = next((u for u in range(t + 1, ntiles) if has_b[u]), None)
        opened.append(carry if nxt is None else close[nxt])
    out_v, out_c = np.zeros(n, dtype=np.int64), np.zeros(n, dtype=np.int64)
    for t, rows in enumerate(tiles):
        cur, pref = (0, carry_in[t][1], carry_in[t][2]), {}
        for r in rows:
            cur = _op(fn, cur, x[r])
            pref[r] = cur
        first = next((r for r in rows if bnd[r]), None)
        for r in rows:
            end = next((e for e in range(r + 1, rows.stop) if bnd[e]), None)
            if first is None or r < first:
                res = opened[t - 1]
            elif end is None:
                res = opened[t]
            else:
                res = pref[end - 1]
            out_v[r], out_c[r] = res[1], res[2]
    return out_v, out_c


def _w1_rows(rng, n, seg_p, peer_p):
    seg = rng.random(n) < seg_p
    seg[0] = True
    peer = seg | (rng.random(n) < peer_p)
    live = rng.random(n) < 0.8
    return seg, peer, live


W1_LAYOUTS = {"short": (1 / 5, 0.3), "long": (1 / 300, 0.01),
              "one": (0.0, 0.002), "peers_every_row": (1 / 40, 1.0)}


@pytest.mark.parametrize("tile", (1, 3, 8, 64))
@pytest.mark.parametrize("layout", W1_LAYOUTS)
@pytest.mark.parametrize("mode", ("running", "whole"))
@pytest.mark.parametrize("fn", ("sum", "count", "min", "max"))
def test_w1_model_matches_plain(fn, mode, layout, tile):
    rng = np.random.default_rng(zlib.crc32(f"{fn} {mode} {layout} {tile}"
                                           .encode()))
    n = 700
    seg, peer, live = _w1_rows(rng, n, *W1_LAYOUTS[layout])
    vals = None if fn == "count" else rng.integers(-1000, 1000, n)
    if fn in ("min", "max"):
        sent = I64.max if fn == "min" else I64.min
        vals = np.where(live, vals, sent)
    elif vals is not None:
        vals = np.where(live, vals, 0)
    t = [torch.from_numpy(a) for a in (seg, peer, live)]
    tv = None if vals is None else torch.from_numpy(vals)
    if mode == "running":
        want = TW.segmented_prefix_plain(fn, tv, t[2], t[0], t[1])
    else:
        want = TW.segment_totals(fn, tv, t[2], t[0])
    got_v, got_c = w1_model(fn, vals, live, seg,
                            peer if mode == "running" else None, tile)
    np.testing.assert_array_equal(got_c, want[1].numpy())
    if fn != "count":
        np.testing.assert_array_equal(got_v, want[0].numpy())


@pytest.mark.parametrize("layout", W1_LAYOUTS)
@pytest.mark.parametrize("mode", ("running", "whole"))
@pytest.mark.parametrize("fn", ("sum", "count", "min", "max"))
def test_w1_model_matches_reference(fn, mode, layout):
    """The model at tiles of 8 and 64 rows against quickstep_tpu: the
    running mode against _prefix_to_peers (peer groups given as one order
    key that changes at each peer start) and, where every row starts a
    peer group, against _segmented_scan itself; the whole-partition mode
    against _seg_total."""
    jnp = pytest.importorskip("jax.numpy")
    JW = pytest.importorskip("quickstep_tpu.ops.window")
    rng = np.random.default_rng(zlib.crc32(f"ref {fn} {mode} {layout}"
                                           .encode()))
    n = 900
    seg, peer, live = _w1_rows(rng, n, *W1_LAYOUTS[layout])
    raw = rng.integers(-1000, 1000, n)
    contrib = np.where(live, raw, 0)
    cnt = live.astype(np.int64)
    vals = None if fn == "count" else contrib if fn == "sum" else \
        np.where(live, raw, I64.max if fn == "min" else I64.min)
    j = jnp.asarray
    if mode == "running":
        order_key = np.cumsum(peer)
        want = JW._prefix_to_peers(fn, j(contrib), j(cnt), j(raw), j(live),
                                   j(seg), jnp.arange(n), [j(order_key)], n)
    else:
        want = JW._seg_total(fn, j(contrib), j(cnt), j(raw), j(live),
                             j(np.cumsum(seg) - 1), n)
    for tile in (8, 64):
        got_v, got_c = w1_model(fn, vals, live, seg,
                                peer if mode == "running" else None, tile)
        np.testing.assert_array_equal(got_c, np.asarray(want[1]))
        if fn != "count":
            np.testing.assert_array_equal(got_v, np.asarray(want[0]))
    if mode == "running" and layout == "peers_every_row":
        combine = {"sum": jnp.add, "count": jnp.add, "min": jnp.minimum,
                   "max": jnp.maximum}[fn]
        scan = JW._segmented_scan(j(cnt if fn == "count" else vals), j(seg),
                                  combine)
        np.testing.assert_array_equal(
            got_c if fn == "count" else got_v, np.asarray(scan))


# ---------------------------------------------------------------------
# K11 on the card
# ---------------------------------------------------------------------

def _oa_check(card, build, balive, probe, palive, size, unique=None):
    """The kernel against the plain version: matched and dup exactly, every
    matched row holding the probe's key; the rows themselves where the
    build keys are unique."""
    table, dup = TJ.oa_build(build, balive, size)
    ptable, pdup = TJ.oa_build_plain(build, balive, size)
    assert bool(dup) == bool(pdup)
    idx, matched = TJ.oa_probe(table, build, probe, palive)
    pidx, pmatched = TJ.oa_probe_plain(ptable, build, probe, palive)
    assert torch.equal(matched.cpu(), pmatched.cpu())
    rows = idx.long()[matched]
    for b, p in zip(build, probe):
        held = b[rows] == p[matched].to(b.dtype)
        assert bool(held.all())
    if unique if unique is not None else not bool(pdup):
        assert torch.equal(idx.cpu(), pidx.cpu())
    return table, bool(dup)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ("i64", "i32x2"))
def test_k11_empty_marker_key_builds_and_probes(card, layout):
    rng = np.random.default_rng(3)
    n = 200_000
    if layout == "i64":
        keys = [torch.from_numpy(rng.integers(-10**9, 10**9, n)).to(card)]
    else:
        keys = [torch.from_numpy(rng.integers(-10**6, 10**6, n).astype(
            np.int32)).to(card) for _ in range(2)]
    for k in keys:
        k[7] = -1                      # all ones, the empty marker's word
    alive = torch.ones(n, dtype=torch.bool, device=card)
    size = TK.next_pow2(2 * n)
    probe = [k[torch.from_numpy(rng.integers(0, n, 50_000)).to(card)]
             for k in keys]
    for p in probe:
        p[:3] = -1
    table, dup = _oa_check(card, keys, alive, probe, alive[:50_000], size)
    assert isinstance(table, TC.OATable)
    assert int(table.special) == 7
    # a second row on the marker's key is a duplicate
    again = [torch.cat([k, k[7:8]]) for k in keys]
    _, dup = _oa_check(card, again, torch.ones(n + 1, dtype=torch.bool,
                                               device=card),
                       probe, alive[:50_000], size)
    assert dup


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ("i32", "i32x2", "i64", "u8_i32_u8"))
def test_k11_table_holds_the_packed_words(card, layout):
    """The kernel's slots hold pack_words' word of each distinct live
    key but the empty marker's, beside a row that carries that key."""
    rng = np.random.default_rng(7)
    n = 100_000
    cols = [torch.from_numpy(rng.integers(0, 256, n).astype(dt) if dt ==
                             np.uint8 else rng.integers(-300, 300, n).astype(
                                 dt)).to(card) for dt in LAYOUTS[layout]]
    alive = torch.from_numpy(rng.random(n) < 0.7).to(card)
    table, _ = TJ.oa_build(cols, alive, TK.next_pow2(2 * n))
    slots = table.slots.view(-1, 2)
    full = slots[:, 0] != -1
    words = pack_words(cols)
    assert torch.equal(torch.sort(slots[full, 0])[0].cpu(),
                       torch.unique(words[alive & (words != -1)]).cpu())
    rows = slots[full, 1].to(torch.int32).long()
    assert bool(alive[rows].all())
    assert torch.equal(words[rows].cpu(), slots[full, 0].cpu())


@pytest.mark.cuda
def test_k11_ten_million_rows_on_one_key(card):
    rng = np.random.default_rng(5)
    n = 20_000_000
    part = torch.from_numpy(rng.integers(1, 2_000_001, n).astype(
        np.int32)).to(card)
    supp = torch.from_numpy(rng.integers(1, 100_001, n).astype(
        np.int32)).to(card)
    hot = torch.from_numpy(rng.permutation(n)[:10_000_000]).to(card)
    part[hot], supp[hot] = 77, 4
    alive = torch.from_numpy(rng.random(n) < 0.95).to(card)
    pick = torch.from_numpy(rng.integers(0, n, 4_000_000)).to(card)
    probe = [part[pick], supp[pick]]
    _, dup = _oa_check(card, [part, supp], alive, probe,
                       torch.ones(4_000_000, dtype=torch.bool, device=card),
                       TK.next_pow2(2 * n))
    assert dup


@pytest.mark.cuda
@pytest.mark.parametrize("load", (0.5, 0.94))
@pytest.mark.parametrize("layout", ("word", "row_ids"))
def test_k11_load_factors_terminate_and_never_evict(card, load, layout):
    size = 1 << 20
    n = int(size * load)
    keys = torch.arange(n, dtype=torch.int64, device=card) * 7919 + 13
    cols = [keys] if layout == "word" else [keys.double()]
    alive = torch.ones(n, dtype=torch.bool, device=card)
    table, dup = TJ.oa_build(cols, alive, size)
    assert isinstance(table, TC.OATable) == (layout == "word")
    assert not bool(dup)
    idx, matched = TJ.oa_probe(table, cols, cols, alive)
    assert bool(matched.all())
    assert torch.equal(idx.cpu(), torch.arange(n, dtype=torch.int32))


@pytest.mark.cuda
def test_k11_float_keys_keep_the_row_id_route(card):
    """-0.0 equals 0.0 and NaN equals nothing, so float keys are compared
    by value, never by bits."""
    build = [torch.tensor([0.0, 1.5, float("nan"), -2.0, float("inf")],
                          dtype=torch.float64, device=card)]
    probe = [torch.tensor([-0.0, float("nan"), 1.5, 2.0, float("inf"),
                           -float("nan")], dtype=torch.float64, device=card)]
    alive = torch.ones(5, dtype=torch.bool, device=card)
    palive = torch.ones(6, dtype=torch.bool, device=card)
    table, _ = _oa_check(card, build, alive, probe, palive, 16)
    assert not isinstance(table, TC.OATable)
    _, matched = TJ.oa_probe(table, build, probe, palive)
    assert matched.cpu().tolist() == [True, False, True, False, True, False]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ("three_int32", "nullable_pair"))
def test_k11_wide_and_nullable_keys_keep_the_row_id_route(card, layout):
    rng = np.random.default_rng(11)
    n = 300_000
    a, b = (torch.from_numpy(rng.integers(0, 400, n).astype(np.int32)).to(
        card) for _ in range(2))
    if layout == "three_int32":
        build = [a, b, (a + b) % 7]
    else:                          # (validity, value) a column, as runner
        va, vb = (torch.from_numpy(rng.random(n) < 0.9).to(card)
                  for _ in range(2))
        build = [va.to(torch.int32), torch.where(va, a, 0),
                 vb.to(torch.int32), torch.where(vb, b, 0)]
    pick = torch.from_numpy(rng.integers(0, n, 100_000)).to(card)
    probe = [c[pick] for c in build]
    probe[1] = torch.where(pick % 5 == 0, probe[1] + 1000, probe[1])
    alive = torch.from_numpy(rng.random(n) < 0.9).to(card)
    table, dup = _oa_check(card, build, alive, probe,
                           torch.ones(100_000, dtype=torch.bool, device=card),
                           TK.next_pow2(2 * n))
    assert not isinstance(table, TC.OATable) and dup


@pytest.mark.cuda
@pytest.mark.parametrize("side", ("empty_build", "empty_probe"))
def test_k11_empty_sides(card, side):
    keys = torch.arange(1000, dtype=torch.int32, device=card)
    none = keys[:0]
    build, probe = (none, keys) if side == "empty_build" else (keys, none)
    TC.reset_launches()
    table, dup = TJ.oa_build([build], torch.ones(len(build), dtype=torch.bool,
                                                 device=card), 2048)
    idx, matched = TJ.oa_probe(table, [build], [probe],
                               torch.ones(len(probe), dtype=torch.bool,
                                          device=card))
    assert not bool(dup) and not bool(matched.any())
    assert torch.equal(idx.cpu(), torch.full((len(probe),), -1,
                                             dtype=torch.int32))
    assert TC.LAUNCHES["open_addressing"] == (1 if side == "empty_probe"
                                              else 0)


@pytest.mark.cuda
def test_k11_probe_dtypes_other_than_the_build(card):
    """The probe cast to the build's dtypes: values the cast does not keep
    match nothing, as a comparison at the promoted dtype gives."""
    build = [torch.tensor([3, -1, 7, 2**31 - 1], dtype=torch.int32,
                          device=card)]
    alive = torch.ones(4, dtype=torch.bool, device=card)
    probes = [torch.tensor([3, 2**32 + 3, -1, 2**31 - 1, 2**31 + 7],
                           dtype=torch.int64, device=card),
              torch.tensor([3.0, 3.5, -1.0, float("nan"), 7.0, 2.0**40],
                           dtype=torch.float64, device=card)]
    for probe in probes:
        _oa_check(card, build, alive, [probe],
                  torch.ones(len(probe), dtype=torch.bool, device=card), 8,
                  unique=True)


# ---------------------------------------------------------------------
# W1 on the card
# ---------------------------------------------------------------------

def _w1_inputs(card, n, seg_p, peer_p, dtype, fn, seed=9):
    rng = np.random.default_rng(seed)
    seg, peer, live = (torch.from_numpy(a).to(card)
                       for a in _w1_rows(rng, n, seg_p, peer_p))
    if fn == "count":
        return None, live, seg, peer, None
    v = rng.normal(3000, 1000, n) if dtype.is_floating_point else \
        rng.integers(-10**6, 10**6, n)
    v = torch.from_numpy(v).to(dtype).to(card)
    c = TW._sentinel_fill(fn, v, live) if fn in ("min", "max") else \
        torch.where(live, v, torch.zeros((), dtype=dtype, device=card))
    atol = 0.0
    if fn == "sum" and dtype.is_floating_point:
        atol = 32 * torch.finfo(dtype).eps * float(c.abs().double().sum())
    return c, live, seg, peer, atol


def _w1_same(got, want, atol):
    assert torch.equal(got[1].cpu(), want[1].cpu())
    if want[0] is None:
        assert got[0] is None
    elif atol:
        torch.testing.assert_close(got[0].cpu(), want[0].cpu(), rtol=0,
                                   atol=atol)
    else:
        assert torch.equal(got[0].cpu(), want[0].cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ("running", "whole"))
@pytest.mark.parametrize("dtype", (torch.int32, torch.int64, torch.float32,
                                   torch.float64), ids=str)
@pytest.mark.parametrize("fn", ("sum", "count", "min", "max"))
def test_w1_segments_spanning_many_tiles(card, fn, dtype, mode):
    """Segments of ~20 K rows (about ten tiles each) with peer groups of
    ~2 K rows, so that heads, closes and open results all carry; run twice
    to the same bits."""
    c, live, seg, peer, atol = _w1_inputs(card, 1_000_003, 1 / 20_000,
                                          1 / 2_000, dtype, fn)
    if mode == "running":
        got = TW.segmented_prefix(fn, c, live, seg, peer)
        again = TW.segmented_prefix(fn, c, live, seg, peer)
        want = TW.segmented_prefix_plain(fn, c, live, seg, peer)
    else:
        got = TW.segment_totals(fn, c, live, seg)
        again = TW.segment_totals(fn, c, live, seg)
        want = TW.segmented_prefix_plain(fn, c, live, seg, seg)
    _w1_same(got, want, atol)
    _w1_same(again, got, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", (0, 1, 3))
def test_w1_unaligned_views_and_ragged_tail(card, offset):
    """Inputs that do not start on 16 bytes (copied by the wrapper) and a
    length that is no multiple of the tile or of 16."""
    c, live, seg, peer, atol = _w1_inputs(card, 70_001, 1 / 300, 0.1,
                                          torch.float32, "sum")
    seg = seg.clone()
    seg[offset] = True                 # the view's first row starts a
    peer = peer | seg                  # segment, each segment start a peer
    views = [t[offset:] for t in (c, live, seg, peer)]
    got = TW.segmented_prefix("sum", *views)
    want = TW.segmented_prefix_plain("sum", *views)
    _w1_same(got, want, atol)
    got = TW.segment_totals("max", views[0], views[1], views[2])
    want = TW.segmented_prefix_plain("max", views[0], views[1], views[2],
                                     views[2])
    _w1_same(got, want, 0.0)
