"""K14's and K15's redesign: models of the kernels on the CPU, and the
kernels against their plain versions on the card. The module imports
neither jax nor quickstep_tpu; the cases that hold the port against
quickstep_tpu import it themselves and skip where it cannot be imported
(or where tests/conftest.py's 8 virtual devices are missing), so the file
also runs on a machine that has a card and no JAX:

    python -m pytest --noconftest tests/test_torch_k14k15_redesign.py -q

K14 (csrc/shuffle_kernels.cu, the radix partition). On the CPU: a
pure-Python model of its division-free arithmetic, from the host's
constants (ops/cuda.py mod_constants and reciprocal): (h + s) mod n by one
multiply-high for every n in 1..1024 over the extreme hashes and 10^4
seeded ones, and the row walk's quotient and remainder by L or the salt.
A numpy model of its one-launch data flow (each thread's rows walked from
one multiply-high, each warp's stable ranks, the tile's warps' prefix, and
each bin's rows in the earlier tiles found by the decoupled look-back over
status words published as a tile's own count or as its inclusive prefix)
is held against partition_dest_plain at the kernel's 4,096-row tiles and at
64-row ones, for 1, 2, 3, 8 and 255 partitions, salts 1, 2 and 4 on both
sides (salted tiles that straddle s * L), L of 0, 1, 4,095, 4,096, 4,097
and 10^5 + 3, and a hot key that overflows. The occupied counts equal
numpy's count of quickstep_tpu's _partition_of over the live rows, capped.

K15 (the bucket route, shuffle.py bucket_rows): its plain twin, through
radix_bucket, gives quickstep_tpu's radix_exchange buffers bit for bit,
and a numpy model of the kernel (the slots' mask and empty tails from the
counts; each tile's rows staged by slot) equals the plain twin.

On the card: K14 against the plain version on all of the above, also at
256 and 1,000 partitions (the two-launch route), int32 and int64 keys, on
slices at an odd offset; the K15 route against its plain twin; no host
sync in either; the launch counts.
"""

import numpy as np
import pytest
import torch

from quickstep_tpu_torch.ops import cuda as TC
from quickstep_tpu_torch.parallel import shuffle as TSH

TILE = 4096                 # kTile in csrc/shuffle_kernels.cu
WARP_ROWS = 512             # kWarpRows: a warp's rows of a tile
LOOK_BACK = 16              # radix_device.cuh kLookBack
M64 = (1 << 64) - 1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.cpu(), w.cpu())


# ---------------------------------------------------------------------
# the division-free arithmetic (Divisor, part_of, RowWalk)
# ---------------------------------------------------------------------

def _part_of_model(h: int, s: int, n: int) -> int:
    """part_of: (h + s) mod n from mod_constants(n), as the kernel takes
    it (64-bit wrapping products, one multiply-high)."""
    m, c = TC.mod_constants(n)
    if m == 0:
        return (h + s) & M64 & (n - 1)
    x = (h >> 32) * c + (h & 0xFFFFFFFF) + s
    assert x < 1 << 43
    return (((m * x) & M64) * n) >> 64


def _div_model(x: int, d: int) -> int:
    """div_by: x // d for x < 2^32 from reciprocal(d)."""
    return x if d == 1 else (TC.reciprocal(d) * x) >> 64


@pytest.mark.parametrize("first", range(1, 1025, 128))
def test_reciprocal_modulo_is_exact(first):
    rng = np.random.default_rng(first)
    seeded = [int(v) for v in rng.integers(0, 2 ** 63, 10_000,
                                           dtype=np.uint64)]
    seeded = [v | (int(b) << 63) for v, b in
              zip(seeded, rng.integers(0, 2, 10_000))]
    for n in range(first, first + 128):
        hashes = [0, 1, n - 1, n, 2 ** 63 - 1, 2 ** 63, 2 ** 64 - 1]
        for h in hashes + seeded:
            assert _part_of_model(h, 0, n) == h % n, (h, n)
        for h in hashes:
            for s in (1, 3, 2 ** 31 - 1):
                assert _part_of_model(h, s, n) == (h + s) % n, (h, s, n)


@pytest.mark.parametrize("d", (1, 2, 3, 4, 7, 31, 32, 33, 4095, 4096, 4097,
                               100_003, 2 ** 31 - 1))
def test_reciprocal_division_is_exact(d):
    rng = np.random.default_rng(d)
    xs = [0, 1, d - 1, d, d + 1, 2 ** 31 - 1, 2 ** 32 - 1] + \
        [int(v) for v in rng.integers(0, 2 ** 32, 10_000, dtype=np.uint64)]
    for x in xs:
        assert _div_model(x, d) == x // d, (x, d)


def test_constants_are_what_the_kernel_takes():
    for n in (1, 2, 8, 256, 1024):
        assert TC.mod_constants(n) == (0, 0)       # masked
    for n in (3, 5, 255, 1000):
        m, c = TC.mod_constants(n)
        assert m == TC.reciprocal(n) and 0 < m < 2 ** 64 and c < n
    assert TC.reciprocal(1) == 0


# ---------------------------------------------------------------------
# a numpy model of K14's one-launch data flow
# ---------------------------------------------------------------------

def _hash64(k: np.ndarray) -> np.ndarray:
    h = k.astype(np.int64).view(np.uint64)
    with np.errstate(over="ignore"):
        h = (h ^ (h >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        h = (h ^ (h >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return h ^ (h >> np.uint64(31))


def _walk(lx, tile, warp_rows, d):
    """The RowWalk of every thread: rows r (tile, warp, round, lane order)
    with their (r // d, r % d) from one division at the thread's first row
    and increments of (32 // d, 32 % d) after it."""
    n_tiles = -(-lx // tile)
    warps = tile // warp_rows
    rounds = warp_rows // 32
    r0 = (np.arange(n_tiles)[:, None, None] * tile
          + np.arange(warps)[None, :, None] * warp_rows
          + np.arange(32)[None, None, :]).reshape(-1)
    q, m = r0 // d, r0 % d
    dq, dm = 32 // d, 32 % d
    rs, qs, ms = [], [], []
    for _ in range(rounds):
        rs.append(r0.copy())
        qs.append(q.copy())
        ms.append(m.copy())
        r0 = r0 + 32
        q, m = q + dq, m + dm
        wrap = m >= d
        m = np.where(wrap, m - d, m)
        q = np.where(wrap, q + 1, q)
    # thread-major, then round: row order within each warp
    shape = (n_tiles, warps, rounds, 32)
    r = np.stack(rs, 1).reshape(n_tiles, warps, 32, rounds)
    r = r.transpose(0, 1, 3, 2).reshape(shape)
    q = np.stack(qs, 1).reshape(n_tiles, warps, 32, rounds) \
        .transpose(0, 1, 3, 2).reshape(shape)
    m = np.stack(ms, 1).reshape(n_tiles, warps, 32, rounds) \
        .transpose(0, 1, 3, 2).reshape(shape)
    return r, q, m


def _ranks(key):
    """Each element's rank among the equal keys before it."""
    order = np.argsort(key, kind="stable")
    start = np.searchsorted(key[order], key[order], side="left")
    rank = np.empty_like(key)
    rank[order] = np.arange(key.shape[0]) - start
    return rank


def _look_back(status, tile, b):
    """radix_device.cuh look_back over status words (kind, count): from
    the nearest tile back, LOOK_BACK words a window, summing own counts
    ("agg") up to and including the nearest inclusive prefix ("pre")."""
    before, t = 0, tile - 1
    while True:
        window = [(status[x][b] if x >= 0 else ("pre", 0))
                  for x in range(t, t - LOOK_BACK, -1)]
        for kind, count in window:
            before += count
            if kind == "pre":
                return before
        t -= LOOK_BACK


def _k14_model(key, alive, n_parts, cap, salt, probe_side, tile,
               warp_rows, seed=0):
    """K14's data flow at the given tile: (dest, overflow, counts)."""
    rng = np.random.default_rng(seed)
    L = key.shape[0]
    tiled = salt > 1 and not probe_side
    lx = L * salt if tiled else L
    if lx == 0:
        return (np.zeros(0, np.int32), False, np.zeros(n_parts, np.int32))
    d = L if tiled else salt
    r, q, m = _walk(lx, tile, warp_rows, d)
    assert np.array_equal(q, r // d) and np.array_equal(m, r % d)
    inside = r < lx
    i = np.where(tiled, m, r)
    s = np.where(tiled, q, m)
    i = np.where(inside, i, 0)
    live = inside & alive[i]
    h = _hash64(key[i])
    p = ((h % np.uint64(n_parts)).astype(np.int64) + s) % n_parts
    b = np.where(live, p, n_parts)            # the dead rows' bin
    n_tiles, warps = b.shape[:2]
    nb = n_parts + 1
    flat = b.reshape(n_tiles, warps, -1)              # row order in a warp
    group = (np.arange(n_tiles)[:, None, None] * warps
             + np.arange(warps)[None, :, None])
    # each warp's stable ranks (warp_ranks) and its count of each bin
    rank_in_warp = _ranks((group * nb + flat).reshape(-1)).reshape(flat.shape)
    warp_count = np.bincount((group * nb + flat).reshape(-1),
                             minlength=n_tiles * warps * nb) \
        .reshape(n_tiles, warps, nb)
    warp_before = np.cumsum(warp_count, 1) - warp_count
    tile_count = warp_count.sum(1)                    # tile, bin
    # publish: each tile's own count, or (once its look-back is done, by
    # chance here) its inclusive prefix; the first tile's is inclusive
    inclusive = np.cumsum(tile_count, 0)
    status = [[("pre", int(inclusive[t][x])) if t == 0 or rng.random() < 0.3
               else ("agg", int(tile_count[t][x]))
               for x in range(n_parts)] for t in range(n_tiles)]
    before = np.zeros((n_tiles, nb), np.int64)
    for t in range(1, n_tiles):
        for x in range(n_parts):
            before[t, x] = _look_back(status, t, x)
    assert np.array_equal(before[:, :n_parts],
                          (inclusive - tile_count)[:, :n_parts])
    tt = np.arange(n_tiles)[:, None, None]
    ww = np.arange(warps)[None, :, None]
    rank = before[tt, flat] + warp_before[tt, ww, flat] + rank_in_warp
    keep = (flat < n_parts) & (rank < cap)
    dest = np.where(keep, flat * cap + rank, n_parts * cap).reshape(-1)
    rows = r.reshape(-1)
    out = np.empty(lx, np.int32)
    out[rows[rows < lx]] = dest[rows < lx]
    totals = inclusive[-1][:n_parts]
    return out, bool((totals > cap).any()), \
        np.minimum(totals, cap).astype(np.int32)


def _inputs(L, seed, hot=0.0, dtype=np.int64):
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    key = rng.integers(info.min, info.max, L, dtype=np.int64).astype(dtype)
    if L:
        key = np.where(rng.random(L) < hot, key[0], key).astype(dtype)
    alive = rng.random(L) < 0.9
    return key, alive


def _cap(L, n_parts, salt, probe_side):
    rows = L * (1 if probe_side or salt == 1 else salt)
    return max(1, -(-2 * rows // n_parts))


MODEL_CASES = [
    # (L, n_parts, salt, probe_side)
    *[(10_003, np_, 1, True) for np_ in (1, 2, 3, 8, 255)],
    *[(L, 8, salt, side) for L in (0, 1, 4_095, 4_096, 4_097)
      for salt in (1, 2, 4) for side in (True, False)],
    (100_003, 3, 4, False), (100_003, 8, 2, True),
]


@pytest.mark.parametrize("tile,warp_rows", ((TILE, WARP_ROWS), (64, 32)),
                         ids=("tile4096", "tile64"))
@pytest.mark.parametrize("L,n_parts,salt,probe_side", MODEL_CASES)
def test_k14_model_matches_plain(L, n_parts, salt, probe_side, tile,
                                 warp_rows):
    key, alive = _inputs(L, L + n_parts + salt)
    cap = _cap(L, n_parts, salt, probe_side)
    want = TSH.partition_dest_plain(torch.from_numpy(key),
                                    torch.from_numpy(alive), n_parts, cap,
                                    salt, probe_side, with_counts=True)
    got = _k14_model(key, alive, n_parts, cap, salt, probe_side, tile,
                     warp_rows)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    assert got[1] == bool(want[1])
    np.testing.assert_array_equal(got[2], want[2].numpy())


@pytest.mark.parametrize("tile,warp_rows", ((TILE, WARP_ROWS), (64, 32)),
                         ids=("tile4096", "tile64"))
@pytest.mark.parametrize("salt,probe_side", ((1, True), (2, False)))
def test_k14_model_overflows_like_plain(tile, warp_rows, salt, probe_side):
    key, alive = _inputs(20_011, 5, hot=0.3)
    cap = 20_011 // 8
    want = TSH.partition_dest_plain(torch.from_numpy(key),
                                    torch.from_numpy(alive), 8, cap, salt,
                                    probe_side, with_counts=True)
    got = _k14_model(key, alive, 8, cap, salt, probe_side, tile, warp_rows)
    assert got[1] and bool(want[1])
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[2], want[2].numpy())


# ---------------------------------------------------------------------
# against quickstep_tpu
# ---------------------------------------------------------------------

def _reference():
    jax = pytest.importorskip("jax")
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh of tests/conftest.py")
    from quickstep_tpu.parallel import shuffle as JSH
    return jax, JSH


@pytest.mark.parametrize("n_parts", (2, 3, 8, 255))
@pytest.mark.parametrize("salt,probe_side", ((1, True), (4, True),
                                             (4, False)))
def test_occupied_counts_match_reference_partition(n_parts, salt,
                                                   probe_side):
    jax, JSH = _reference()
    import jax.numpy as jnp
    L = 30_011
    key, alive = _inputs(L, n_parts, hot=0.05)
    p0 = np.asarray(JSH._partition_of(jnp.asarray(key), n_parts))
    if salt > 1 and not probe_side:
        p = np.concatenate([(p0 + s) % n_parts for s in range(salt)])
        live = np.tile(alive, salt)
    else:
        p = (p0 + np.arange(L) % salt) % n_parts
        live = alive
    cap = L // n_parts
    want = np.minimum(np.bincount(p[live], minlength=n_parts), cap)
    got = TSH.partition_dest(torch.from_numpy(key), torch.from_numpy(alive),
                             n_parts, cap, salt, probe_side,
                             with_counts=True)
    np.testing.assert_array_equal(got[2].numpy(), want.astype(np.int32))
    assert bool(got[1]) == bool((np.bincount(p[live], minlength=n_parts)
                                 > cap).any())


@pytest.mark.parametrize("L", (1, 4_097))
@pytest.mark.parametrize("salt,probe_side", ((1, True), (2, True),
                                             (4, False)))
def test_radix_bucket_matches_reference_exchange(L, salt, probe_side):
    jax, JSH = _reference()
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from quickstep_tpu.parallel import mesh as JM
    n = 8
    rng = np.random.default_rng(L + salt)
    key = rng.integers(-10 ** 12, 10 ** 12, n * L).astype(np.int64)
    val = rng.normal(0, 1e6, n * L)
    small = rng.integers(-1000, 1000, n * L).astype(np.int32)
    alive = rng.random(n * L) < 0.9
    cap = -(-2 * L * (1 if probe_side else salt) // n)

    def body(k, v, c, a):
        ex, al, over = JSH.radix_exchange(k, [k, v, c], a, n, "x", cap,
                                          salt=salt, probe_side=probe_side)
        return tuple(ex) + (al, over)
    fn = shard_map(body, mesh=JM.make_mesh(n), in_specs=(P("x"),) * 4,
                   out_specs=(P("x"),) * 4 + (P(),))
    want = [np.asarray(o) for o in fn(*[jnp.asarray(a) for a in
                                        (key, val, small, alive)])]
    # the port's shards through radix_bucket, exchanged by hand: bucket j
    # of shard i becomes segment i of shard j
    local = [TSH.radix_bucket(torch.from_numpy(key[i * L:(i + 1) * L]),
                              [torch.from_numpy(a[i * L:(i + 1) * L])
                               for a in (key, val, small)],
                              torch.from_numpy(alive[i * L:(i + 1) * L]),
                              n, cap, salt, probe_side) for i in range(n)]
    for c in range(4):
        got = np.concatenate([
            (local[i][0][c] if c < 3 else local[i][1])[j * cap:(j + 1) * cap]
            .numpy() for j in range(n) for i in range(n)])
        assert got.dtype == want[c].dtype
        np.testing.assert_array_equal(got.view(np.uint8),
                                      want[c].view(np.uint8))
    assert any(bool(b[2]) for b in local) == bool(want[4])


# ---------------------------------------------------------------------
# K15's bucket route
# ---------------------------------------------------------------------

def _bucket_model(dest, counts, rows, cap, tile, warp_rows):
    """qs_bucket_rows: the mask and the empty tails from the counts alone;
    each tile's kept rows staged at (their bucket's place in the tile) +
    (slot - the bucket's first slot in the tile), then stored in slot
    order."""
    n_parts = counts.shape[0]
    slots = n_parts * cap
    k = np.arange(slots)
    occ = (k % cap) < counts[k // cap]
    idx = np.full(slots, -7, np.int32)
    idx[~occ] = 0
    lx = dest.shape[0]
    for t0 in range(0, lx, tile):
        r = np.arange(t0, min(t0 + tile, lx))
        d = dest[r].astype(np.int64)
        kept = (d >= 0) & (d < slots)
        r, d = r[kept], d[kept]
        p = d // cap
        first = np.full(n_parts, np.iinfo(np.int64).max)
        np.minimum.at(first, p, d)
        cnt = np.bincount(p, minlength=n_parts)
        place = np.cumsum(cnt) - cnt
        at = place[p] + d - first[p]
        stage_slot = np.empty(len(d), np.int64)
        stage_row = np.empty(len(d), np.int64)
        stage_slot[at] = d
        stage_row[at] = r % rows if lx > rows else r
        assert np.all(np.diff(stage_slot) > 0)     # runs in slot order
        idx[stage_slot] = stage_row
    assert (idx >= 0).all()
    return idx, occ


@pytest.mark.parametrize("tile,warp_rows", ((TILE, WARP_ROWS), (64, 32)),
                         ids=("tile4096", "tile64"))
@pytest.mark.parametrize("L,n_parts,salt,probe_side", MODEL_CASES[:7] + [
    (4_097, 8, 4, False), (100_003, 8, 2, True), (20_011, 8, 1, True)])
def test_bucket_route_model_matches_plain_twin(L, n_parts, salt, probe_side,
                                               tile, warp_rows):
    key, alive = _inputs(L, 11, hot=0.3 if L == 20_011 else 0.0)
    cap = _cap(L, n_parts, salt, probe_side)
    if L == 20_011:
        cap = L // 8                                   # overflowing
    dest, _, counts = TSH.partition_dest_plain(
        torch.from_numpy(key), torch.from_numpy(alive), n_parts, cap, salt,
        probe_side, with_counts=True)
    want = TSH.bucket_rows_plain(dest, counts, L, cap)
    got = _bucket_model(dest.numpy(), counts.numpy(), L, cap, tile,
                        warp_rows)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())


def test_plain_versions_give_counts_and_the_twin_on_cpu():
    key, alive = _inputs(5_000, 3)
    TC.reset_launches()
    dest, over, counts = TSH.partition_dest(
        torch.from_numpy(key), torch.from_numpy(alive), 8, 1_250,
        with_counts=True)
    idx, occ = TSH.bucket_rows(dest, counts, 5_000, 1_250)
    assert not any(TC.LAUNCHES.values()), TC.LAUNCHES
    assert idx.dtype == torch.int32 and occ.dtype == torch.bool
    assert int(occ.sum()) == int(counts.sum()) == int(alive.sum())
    assert len(TSH.partition_dest(torch.from_numpy(key),
                                  torch.from_numpy(alive), 8, 1_250)) == 2


def test_bucket_rows_wrapper_rejects_cpu_tensors():
    dest = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="needs CUDA"):
        TC.bucket_rows(dest, torch.zeros(2, dtype=torch.int32), 4, 2)


# ---------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------

def _card_inputs(n, dtype, card, seed, hot=0.0, offset=1):
    key, alive = _inputs(n + offset, seed, hot, dtype)
    return (torch.from_numpy(key).to(card)[offset:],
            torch.from_numpy(alive).to(card)[offset:])


CARD_CASES = MODEL_CASES + [
    (100_003, np_, salt, side) for np_ in (256, 1000)
    for salt, side in ((1, True), (2, True), (4, False))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (np.int32, np.int64), ids=str)
@pytest.mark.parametrize("L,n_parts,salt,probe_side", CARD_CASES)
def test_k14_kernel_matches_plain(card, dtype, L, n_parts, salt,
                                  probe_side):
    key, alive = _card_inputs(L, dtype, card, L + n_parts)
    cap = _cap(L, n_parts, salt, probe_side)
    got = TSH.partition_dest(key, alive, n_parts, cap, salt, probe_side,
                             with_counts=True)
    _same(got, TSH.partition_dest_plain(key, alive, n_parts, cap, salt,
                                        probe_side, with_counts=True))
    _same(TSH.bucket_rows(got[0], got[2], L, cap),
          TSH.bucket_rows_plain(got[0], got[2], L, cap))


@pytest.mark.cuda
@pytest.mark.parametrize("n_parts", (8, 255, 1000))
@pytest.mark.parametrize("salt,probe_side", ((1, True), (2, False)))
def test_k14_kernel_overflows_like_plain(card, n_parts, salt, probe_side):
    key, alive = _card_inputs(100_003, np.int64, card, 9, hot=0.3)
    cap = 100_003 // n_parts
    got = TSH.partition_dest(key, alive, n_parts, cap, salt, probe_side,
                             with_counts=True)
    _same(got, TSH.partition_dest_plain(key, alive, n_parts, cap, salt,
                                        probe_side, with_counts=True))
    assert bool(got[1])
    _same(TSH.bucket_rows(got[0], got[2], 100_003, cap),
          TSH.bucket_rows_plain(got[0], got[2], 100_003, cap))


@pytest.mark.cuda
@pytest.mark.parametrize("salt,probe_side", ((1, True), (4, False)))
def test_radix_bucket_on_card_matches_cpu(card, salt, probe_side):
    key, alive = _card_inputs(1_000_003, np.int64, card, 21)
    vals = torch.rand(key.shape[0], device=card, dtype=torch.float64)
    cap = _cap(1_000_003, 8, salt, probe_side)
    got = TSH.radix_bucket(key, [key, vals], alive, 8, cap, salt,
                           probe_side)
    want = TSH.radix_bucket(key.cpu(), [key.cpu(), vals.cpu()], alive.cpu(),
                            8, cap, salt, probe_side)
    _same(got[0] + [got[1], got[2]], want[0] + [want[1], want[2]])


@pytest.mark.cuda
def test_k14_k15_make_no_host_sync(card):
    key, alive = _card_inputs(1_000_003, np.int64, card, 23)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for np_, salt, side in ((8, 1, True), (8, 4, False), (1000, 2, True)):
            cap = _cap(1_000_003, np_, salt, side)
            dest, _, counts = TSH.partition_dest(key, alive, np_, cap, salt,
                                                 side, with_counts=True)
            TSH.bucket_rows(dest, counts, 1_000_003, cap)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_k14_k15_launches_are_counted(card):
    key, alive = _card_inputs(10_000, np.int64, card, 25)
    TC.reset_launches()
    TSH.radix_bucket(key, [key], alive, 8, 2_500)
    TSH.radix_bucket(key, [key], alive, 8, 10_000, 4, False)
    TSH.partition_dest(key, alive, 1000, 20)         # two-launch route
    empty = key[:0]
    TSH.radix_bucket(empty, [empty], alive[:0], 8, 4)
    want = dict.fromkeys(TC.LAUNCHES, 0)
    want.update(partition_dest=3, scatter_compact=2, multi_gather=2)
    assert TC.LAUNCHES == want, TC.LAUNCHES


@pytest.mark.cuda
def test_k14_state_survives_streams_and_many_calls(card):
    """The look-back state is never cleared: calls on two streams and
    more calls than tags in one word's upper half would hold stay
    right."""
    key, alive = _card_inputs(50_000, np.int64, card, 27)
    want = TSH.partition_dest_plain(key, alive, 8, 12_500, with_counts=True)
    side = torch.cuda.Stream(card)
    for _ in range(3):
        _same(TSH.partition_dest(key, alive, 8, 12_500, with_counts=True),
              want)
        with torch.cuda.stream(side):
            got = TSH.partition_dest(key, alive, 8, 12_500, with_counts=True)
        side.synchronize()
        _same(got, want)
    # a larger call grows the state
    big_key, big_alive = _card_inputs(3_000_001, np.int64, card, 29)
    _same(TSH.partition_dest(big_key, big_alive, 255, 30_000,
                             with_counts=True),
          TSH.partition_dest_plain(big_key, big_alive, 255, 30_000,
                                   with_counts=True))
