"""K9's and K2's redesign: the parts that run on the CPU as models of the
kernels' data flow, the join compaction through K9, and the kernels
against their plain versions on the card. The module imports neither jax
nor quickstep_tpu; the cases that hold the port against quickstep_tpu
import it themselves and skip where it cannot be imported, so the file also
runs on a machine that has a card and no JAX:

    python -m pytest --noconftest tests/test_torch_k2k9_redesign.py -q

K9 (csrc/compact_kernels.cu): `stable_partition(mask, limit)` is
quickstep_tpu's `compact_order(mask)[:limit]`, for limits about the live
count, over masks all dead, all live, 1 % and 50 % live. A numpy model of
the kernel (the live count of each count block's tiles published and the
rows before them found by the look-back of 32 status words under a random
schedule of the blocks' steps; each tile's rows ranked by thread counts, a warp scan and the warp
totals, staged live then dead, and written below `limit`) is held against
the same function at tiles of 8 and 4,096 rows. `_compact_chunk` and
`_squeeze` reach K9 with their target; joins that compact at SF0.01 match
quickstep_tpu and sqlite.

K2 (csrc/agg_kernels.cu): `dense_aggregate_plain` is quickstep_tpu's
`pack_dense_index` followed by its `dense_groupby`, over 1-4 key columns of
int8, int32, int64 and bool with negative and out-of-range keys, domains 1,
6 and 128, every fn, nullable values, the same tensor in two aggregates,
NaNs; integers exactly, float64 within rel 1e-12, float32 within rel 1e-5.
The kernel's plan (shared accumulators and counts, launches of at most 8
accumulators) is held against the specs. A numpy model of its fixed fold
order (on its lane path each thread's rows in order, then the threads; on
its warp path the rank-order shuffle tree of each warp step, then the
warps; then the blocks) is held to the plain version within rel 1e-12 on
float64 sums, and on the card to the kernel bit for bit (domain 6 takes
the lane path, 128 the warp path).
"""

import math

import numpy as np
import pytest
import torch

from quickstep_tpu_torch.ops import cuda as TC
from quickstep_tpu_torch.ops import groupby as TG
from quickstep_tpu_torch.ops import kernels as TK

WARP = 32
K9_SIZES = (0, 1, 4095, 4096, 100_003)
K9_LIVE = {"all_dead": 0.0, "one_percent": 0.01, "half": 0.5,
           "all_live": 1.0}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _mask(n, live, seed=3):
    return np.random.default_rng(seed).random(n) < live


def _limits(live: int, n: int):
    return sorted({0, min(1, n), max(live - 1, 0), live, min(live + 1, n),
                   n})


# ---------------------------------------------------------------------
# K9 on the CPU
# ---------------------------------------------------------------------

@pytest.mark.parametrize("live", sorted(K9_LIVE))
@pytest.mark.parametrize("n", K9_SIZES)
def test_stable_partition_limit_matches_reference(n, live):
    JK = pytest.importorskip("quickstep_tpu.ops.kernels")
    jnp = pytest.importorskip("jax.numpy")
    mask = _mask(n, K9_LIVE[live])
    want = np.asarray(JK.compact_order(jnp.asarray(mask))).astype(np.int64)
    for limit in _limits(int(mask.sum()), n):
        got = TK.stable_partition(torch.from_numpy(mask), limit=limit)
        assert got.dtype == torch.int64 and got.shape == (limit,)
        np.testing.assert_array_equal(got.numpy(), want[:limit])
        order, taken = TK.stable_partition(torch.from_numpy(mask),
                                           limit=limit, with_mask=True)
        np.testing.assert_array_equal(order.numpy(), want[:limit])
        np.testing.assert_array_equal(taken.numpy(), mask[want[:limit]])
    np.testing.assert_array_equal(
        TK.stable_partition(torch.from_numpy(mask)).numpy(), want)


AGG, PRE = 1, 2


def k9_look_back(counts, rng):
    """The count launch's tiles under a random schedule: a tile starts (and
    publishes its count) only after every tile of a lower ticket started;
    a started tile's warp reads 32 status words at a time, nearest first,
    as csrc/compact_kernels.cu look_back does. Returns the live rows
    before each tile and the live total."""
    t_n = len(counts)
    flag, value = [0] * t_n, [0] * t_n
    window, acc, before = [t - 1 for t in range(t_n)], [0] * t_n, [0] * t_n
    started, done, ticket = [False] * t_n, [False] * t_n, 0
    while not all(done):
        steps = [("start", ticket)] if ticket < t_n else []
        steps += [("look", t) for t in range(t_n) if started[t] and
                  not done[t]]
        kind, t = steps[rng.integers(len(steps))]
        if kind == "start":
            flag[t], value[t] = (PRE if t == 0 else AGG), counts[t]
            started[t], ticket = True, ticket + 1
            done[t] = t == 0
            continue
        words = [(flag[w], value[w]) if w >= 0 else (PRE, 0)
                 for w in range(window[t], window[t] - WARP, -1)]
        first_pre = next((i for i, w in enumerate(words) if w[0] == PRE),
                         WARP)
        first_unpub = next((i for i, w in enumerate(words) if w[0] == 0),
                           WARP)
        end = first_pre < first_unpub
        take = first_pre + 1 if end else first_unpub
        acc[t] += sum(v for _, v in words[:take])
        if end:
            before[t], done[t] = acc[t], True
            flag[t], value[t] = PRE, acc[t] + counts[t]
        else:
            window[t] -= take
    return before, before[-1] + counts[-1] if t_n else 0


def k9_model(mask, limit, tile, items, count_tiles, rng):
    """K9's two launches in numpy (one tile: the scatter alone, its own
    live count placing the dead rows): the count launch's blocks of
    count_tiles tiles look back once each and hand each of their tiles its
    live rows before."""
    n = len(mask)
    t_n = -(-n // tile)
    counts = [int(mask[t * tile:(t + 1) * tile].sum()) for t in range(t_n)]
    blocks = [sum(counts[b:b + count_tiles])
              for b in range(0, t_n, count_tiles)]
    block_before, total = k9_look_back(blocks, rng)
    before = [block_before[t // count_tiles] +
              sum(counts[t - t % count_tiles:t]) for t in range(t_n)]
    threads = tile // items
    out = np.full(limit, -1, dtype=np.int64)
    for t in range(t_n):
        start = t * tile
        live_base, dead_base = before[t], total + start - before[t]
        if live_base >= limit and dead_base >= limit:
            continue
        rows = min(tile, n - start)
        m = np.zeros(tile, dtype=np.int64)
        m[:rows] = mask[start:start + rows]
        c = m.reshape(threads, items).sum(axis=1)
        rank = np.empty(threads, dtype=np.int64)
        warp_before = 0
        for w in range(0, threads, WARP):
            x = np.cumsum(c[w:w + WARP])         # the warp's inclusive scan
            rank[w:w + WARP] = warp_before + x - c[w:w + WARP]
            warp_before += int(x[-1])
        tile_live = warp_before
        pos = np.empty(tile, dtype=np.int64)
        for th in range(threads):
            lr, dr = rank[th], tile_live + th * items - rank[th]
            for k in range(items):
                local = th * items + k
                if local < rows:
                    if m[local]:
                        pos[lr], lr = local, lr + 1
                    else:
                        pos[dr], dr = local, dr + 1
        for j in range(rows):
            to = live_base + j if j < tile_live else \
                dead_base + j - tile_live
            if to < limit:
                out[to] = start + pos[j]
    assert (out >= 0).all()
    return out


@pytest.mark.parametrize("tile, items, count_tiles",
                         ((8, 4, 2), (8, 1, 8), (4096, 16, 16)))
@pytest.mark.parametrize("live", sorted(K9_LIVE))
def test_k9_model_matches_reference(tile, items, count_tiles, live):
    """The model at small tiles (many tiles, many look-back windows) and at
    the kernel's tile, over the limits about the live count."""
    JK = pytest.importorskip("quickstep_tpu.ops.kernels")
    jnp = pytest.importorskip("jax.numpy")
    rng = np.random.default_rng(17)
    sizes = (1, 7, 8, 9, 777, 4097) if tile == 8 else K9_SIZES
    for n in sizes:
        mask = _mask(n, K9_LIVE[live], seed=n)
        want = np.asarray(JK.compact_order(jnp.asarray(mask)))
        for limit in _limits(int(mask.sum()), n):
            np.testing.assert_array_equal(
                k9_model(mask, limit, tile, items, count_tiles, rng),
                want[:limit])


class _Runner:
    """What PlanRunner._compact_chunk and _squeeze read of their runner."""
    mesh = None


def _spy(monkeypatch):
    from quickstep_tpu_torch.exec import runner as R
    calls = []
    real = R.K.stable_partition

    def watched(mask, limit=None, with_mask=False):
        calls.append((mask.shape[0], limit))
        return real(mask, limit, with_mask)
    monkeypatch.setattr(R.K, "stable_partition", watched)
    return calls


def test_compact_chunk_and_squeeze_go_through_k9(monkeypatch):
    from quickstep_tpu_torch.exec.chunk import Chunk
    from quickstep_tpu_torch.exec.runner import PlanRunner
    calls = _spy(monkeypatch)
    _Runner._compact_chunk = PlanRunner._compact_chunk
    mask = torch.from_numpy(_mask(10_000, 0.05))
    vals = torch.arange(10_000)
    chunk = Chunk(attrs=[], slots={7: (vals, None)}, alive=mask,
                  capacity=10_000)
    got = PlanRunner._compact_chunk(_Runner(), chunk, 1000)
    assert calls == [(10_000, 1000)]
    order = TK.compact_order(mask)[:1000]
    assert got.capacity == 1000 and torch.equal(got.alive, mask[order])
    squeezed = PlanRunner._squeeze(_Runner(), Chunk(
        attrs=[], slots={}, alive=mask, capacity=10_000, bound=4000))
    assert calls[1:] == [(10_000, 4000)]
    assert squeezed.capacity == 4000
    assert torch.equal(squeezed.alive, mask[TK.compact_order(mask)[:4000]])


@pytest.fixture(scope="module")
def engines():
    JQ = pytest.importorskip("quickstep_tpu")
    JT = pytest.importorskip("quickstep_tpu.bench.tpch")
    from quickstep_tpu_torch import Database
    from quickstep_tpu_torch.bench.tpch import load_tpch
    jdb = JQ.Database()
    conn = JT.load_sqlite(JT.load_tpch(jdb, scale=0.01, seed=0))
    tdb = Database(device="cpu")
    load_tpch(tdb, scale=0.01, seed=0)
    yield jdb, tdb, conn, JT
    tdb.close()


def _rows_close(a, b):
    return len(a) == len(b) and all(
        math.isclose(float(x), float(y), rel_tol=1e-9, abs_tol=1e-6)
        if isinstance(x, float) or isinstance(y, float) else x == y
        for x, y in zip(a, b))


@pytest.mark.parametrize("qnum", (3, 5, 10, 12, 14))
def test_compacting_join_matches_reference_and_sqlite(engines, qnum,
                                                      monkeypatch):
    jdb, tdb, conn, JT = engines
    calls = _spy(monkeypatch)
    sql = JT.with_tiebreak(qnum, JT.TPCH_QUERIES[qnum])
    ours = tdb.execute(sql).rows
    # the runner's compactions pass their target; the executor's pull of
    # the result keeps the whole order
    assert any(limit is not None and limit < n for n, limit in calls), calls
    want = conn.execute(JT.to_sqlite_sql(JT.with_tiebreak(
        qnum, JT.ORACLE_OVERRIDES.get(qnum, JT.TPCH_QUERIES[qnum])))
    ).fetchall()
    for other in (jdb.execute(sql).rows, want):
        assert len(ours) == len(other)
        assert all(_rows_close(a, b) for a, b in zip(ours, other))


# ---------------------------------------------------------------------
# K2 on the CPU
# ---------------------------------------------------------------------

KEY_LAYOUTS = {   # the key columns' dtypes
    "int8": (np.int8,),
    "int32 x2": (np.int32, np.int32),
    "int64 bool int32": (np.int64, np.bool_, np.int32),
    "int8 int32 int64 bool": (np.int8, np.int32, np.int64, np.bool_),
}
VAL_DTYPES = (np.int32, np.int64, np.float32, np.float64)
N_DENSE = 20_000


def key_sizes(dtypes, domain):
    """Each key's range size, multiplying to domain (1, 6 or 128): a bool
    key takes 2 where it can, the first other key the rest."""
    sizes = [1] * len(dtypes)
    left = domain
    for k, dt in enumerate(dtypes):
        if dt == np.bool_ and left % 2 == 0 and k > 0:
            sizes[k], left = 2, left // 2
    first = next(k for k, dt in enumerate(dtypes) if dt != np.bool_)
    sizes[first] = left
    return sizes


def dense_keys(dtypes, domain, n, seed):
    """Key columns some of whose values lie outside their ranges (negative
    ones too; int8 ones past 127 wrap), with offsets and strides as
    runner._dense_layout makes them."""
    rng = np.random.default_rng(seed)
    sizes = key_sizes(dtypes, domain)
    cols, offs = [], []
    for k, (dt, size) in enumerate(zip(dtypes, sizes)):
        off = 0 if dt == np.bool_ else k - 2
        c = rng.random(n) < 0.6 if dt == np.bool_ else \
            rng.integers(off - 2, off + size + 2, n).astype(dt)
        cols.append(c)
        offs.append(off)
    strides, acc = [], 1
    for size in reversed(sizes):
        strides.append(acc)
        acc *= size
    assert acc == domain
    return cols, offs, list(reversed(strides)), acc


def dense_specs(n, seed):
    """Every fn over every value dtype, NULLs in half of them, NaNs in the
    floats, the same tensor under two aggregates, counts with and without
    validity: 12 accumulators, more than one launch takes."""
    rng = np.random.default_rng(seed)
    specs = []
    for i, dt in enumerate(VAL_DTYPES):
        if np.issubdtype(dt, np.floating):
            v = (rng.normal(0, 1000, n) + 3000).astype(dt)
            v[::211] = np.nan
        else:
            v = rng.integers(-10**6, 10**6, n).astype(dt)
        valid = rng.random(n) < 0.7 if i % 2 else None
        specs += [("sum", v, valid), ("avg", v, valid), ("min", v, valid),
                  ("max", v, None), ("count", None, valid)]
    return specs + [("count", None, None)]


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("domain", (1, 6, 128))
@pytest.mark.parametrize("layout", sorted(KEY_LAYOUTS))
def test_dense_aggregate_plain_matches_reference(layout, domain):
    JG = pytest.importorskip("quickstep_tpu.ops.groupby")
    jnp = pytest.importorskip("jax.numpy")
    keys, offs, strides, dom = dense_keys(KEY_LAYOUTS[layout], domain,
                                          N_DENSE, 5)
    alive = np.random.default_rng(9).random(N_DENSE) < 0.8
    specs = dense_specs(N_DENSE, 11)
    occ, got = TG.dense_aggregate_plain(
        [_t(k) for k in keys], offs, strides, dom,
        [(fn, _t(v), _t(vv)) for fn, v, vv in specs], _t(alive))
    jidx = JG.pack_dense_index([jnp.asarray(k) for k in keys], offs,
                               strides, dom, jnp.asarray(alive))
    jocc, want = JG.dense_groupby(
        jidx, dom, [(fn, None if v is None else jnp.asarray(v),
                     None if vv is None else jnp.asarray(vv))
                    for fn, v, vv in specs], jnp.asarray(alive))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    for (fn, v, _), (d, nn), (wd, wnn) in zip(specs, got, want):
        np.testing.assert_array_equal(nn.numpy(), np.asarray(wnn))
        wd = np.asarray(wd)
        if fn in ("min", "max"):
            # groups with no live non-NULL row hold the sentinel on both
            np.testing.assert_array_equal(d.numpy(), wd)
            continue
        rtol = 1e-5 if v is not None and v.dtype == np.float32 else 1e-12
        np.testing.assert_allclose(d.numpy(), wd, rtol=0 if fn == "count"
                                   or not np.issubdtype(wd.dtype,
                                                        np.floating)
                                   else rtol, atol=0)


def test_dense_plan_shares_work_and_splits_launches():
    cache = {}

    def t(a):
        return None if a is None else cache.setdefault(id(a), _t(a))
    specs = [("sum" if fn == "avg" else fn, t(v), t(vv))
             for fn, v, vv in dense_specs(16, 13)]
    plan = TC.dense_plan(specs)
    # SUM and AVG of one column share an accumulator: 3 a dtype, 12 in all
    assert len(plan.accs) == 12 and len(plan.valids) == 3
    assert [len(a) for a, _ in plan.launches] == [8, 4]
    assert [c for _, c in plan.launches] == [[0, 1, 2], [0]]
    assert sorted(a for chunk, _ in plan.launches for a in chunk) == \
        list(range(12))
    for (fn, v, vv), (a, c) in zip(specs, plan.slots):
        assert plan.valids[c] is vv
        assert (a is None) == (fn == "count")
        if a is not None:
            assert plan.accs[a][0] == fn and plan.accs[a][1] is v and \
                plan.accs[a][2] is vv
    assert plan.slots[0][0] == plan.slots[1][0]       # sum and avg


def test_dense_plan_splits_many_validities():
    valids = [torch.zeros(4, dtype=torch.bool) for _ in range(20)]
    plan = TC.dense_plan([("count", None, v) for v in valids])
    assert plan.accs == [] and len(plan.valids) == 21
    assert [c for _, c in plan.launches] == [
        [0] + list(range(1, 9)), [0] + list(range(9, 17)),
        [0, 17, 18, 19, 20]]


def tree_step(g, v):
    """One warp step of K2: each group's lanes folded by the rank-order
    shuffle tree with pointer jumping; returns {group: its fold} for the
    kept groups (g >= 0), as the group's lowest lane holds it."""
    lanes = range(WARP)
    peers = [sum(1 << m for m in lanes if g[m] == g[lane]) for lane in lanes]
    rank = [bin(peers[lane] & ((1 << lane) - 1)).count("1") for lane in lanes]
    partner = []
    for lane in lanes:
        above = peers[lane] & ~((2 << lane) - 1) & 0xffffffff
        partner.append((above & -above).bit_length() - 1 if above else -1)
    most = max(bin(p).count("1") for p in peers)
    v = list(v)
    s = 1
    while s < most:
        src = [p if p >= 0 else lane for lane, p in enumerate(partner)]
        x = [v[q] for q in src]
        v = [v[lane] + x[lane] if partner[lane] >= 0 and
             rank[lane] % (2 * s) == 0 else v[lane] for lane in lanes]
        nxt = [partner[q] for q in src]
        partner = [nxt[lane] if partner[lane] >= 0 else -1 for lane in lanes]
        s *= 2
    return {g[lane]: v[lane] for lane in lanes if rank[lane] == 0 and
            g[lane] >= 0}


def k2_sum_model(groups, contrib, domain, blocks, lane, warps=8, rows=8,
                 threads=256):
    """K2's float64 SUM in the kernel's order. The rows go a tile of
    threads * rows at a time, block b taking tiles b, b + blocks, ...;
    thread t's rows of a tile are base + k * threads + t for k < rows. The
    lane path: each thread adds its rows in that order into its own slots,
    and the block folds its threads' slots in thread order. The warp path:
    for each k, the 32 rows of a warp's lanes are folded by group by the
    shuffle tree into the warp's slots; the warps folded in order. Then
    each group's block partials: thread t over blocks t, t + threads, ...,
    a shuffle tree in each warp and the warps in order."""
    n = len(groups)
    tile = threads * rows
    owners = threads if lane else warps
    table = np.zeros((blocks, owners, domain))
    for b in range(blocks):
        for base in range(b * tile, n, blocks * tile):
            for k in range(rows):
                for w in range(warps):
                    i = base + k * threads + w * WARP + np.arange(WARP)
                    ok = i < n
                    g = np.where(ok, groups[np.minimum(i, n - 1)], -1)
                    c = np.where(ok, contrib[np.minimum(i, n - 1)], 0.0)
                    if lane:
                        for m in range(WARP):
                            if g[m] >= 0:
                                o = w * WARP + m
                                table[b, o, g[m]] = table[b, o, g[m]] + c[m]
                        continue
                    for grp, x in tree_step(g.tolist(), c.tolist()).items():
                        table[b, w, grp] = table[b, w, grp] + x
    partial = np.zeros((blocks, domain))
    for b in range(blocks):
        for grp in range(domain):
            x = table[b, 0, grp]
            for o in range(1, owners):
                x = x + table[b, o, grp]
            partial[b, grp] = x
    out = np.zeros(domain)
    for grp in range(domain):
        lane_v = []
        for t in range(threads):
            x = 0.0
            for b in range(t, blocks, threads):
                x = x + partial[b, grp]
            lane_v.append(x)
        warp_v = []
        for w in range(0, threads, WARP):
            vals = lane_v[w:w + WARP]
            off = 1
            while off < WARP:
                vals = [vals[m] + vals[m + off] if m % (2 * off) == 0 and
                        m + off < WARP else vals[m] for m in range(WARP)]
                off *= 2
            warp_v.append(vals[0])
        x = warp_v[0]
        for y in warp_v[1:]:
            x = x + y
        out[grp] = x
    return out


def _model_inputs(n, domain, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(-1, domain + 2, n)
    alive = rng.random(n) < 0.8
    valid = rng.random(n) < 0.9
    vals = rng.normal(3000, 1000, n)
    groups = np.where(alive & (keys >= 0) & (keys < domain), keys, -1)
    contrib = np.where((groups >= 0) & valid, vals, 0.0)
    return keys, alive, valid, vals, groups, contrib


@pytest.mark.parametrize("lane", (True, False), ids=("lane", "warp"))
@pytest.mark.parametrize("domain", (1, 6, 128))
def test_k2_fold_model_matches_plain(domain, lane):
    n = 9_001
    keys, alive, valid, vals, groups, contrib = _model_inputs(n, domain, 19)
    got = k2_sum_model(groups, contrib, domain, blocks=3, lane=lane)
    _, [(want, _)] = TG.dense_aggregate_plain(
        [_t(keys)], [0], [1], domain, [("sum", _t(vals), _t(valid))],
        _t(alive))
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-12, atol=0)


# ---------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("domain", (6, 128))
def test_k2_kernel_is_the_fold_model_bit_for_bit(card, domain):
    n = 300_001
    keys, alive, valid, vals, groups, contrib = _model_inputs(n, domain, 23)
    lane, _smem, blocks = TC.dense_grid(n, domain, 1, 2, card)
    want = k2_sum_model(groups, contrib, domain, blocks, lane)
    _, [(got, _)] = TG.dense_aggregate(
        [_t(keys).to(card)], [0], [1], domain,
        [("sum", _t(vals).to(card), _t(valid).to(card))], _t(alive).to(card))
    np.testing.assert_array_equal(got.cpu().numpy().view(np.int64),
                                  want.view(np.int64))


@pytest.mark.cuda
def test_compacting_query_runs_no_library_sort_on_the_card(card,
                                                           monkeypatch):
    """Q3, Q5 and Q12 at SF0.01 on the card compact their join inputs
    through K9 with a limit, and no torch.sort or torch.argsort runs inside
    _compact_chunk; the rows equal the port's on the CPU."""
    from quickstep_tpu_torch import Database
    from quickstep_tpu_torch.bench.tpch import (
        TPCH_QUERIES, load_tpch, with_tiebreak)
    from quickstep_tpu_torch.exec import runner as R
    calls = _spy(monkeypatch)
    real = R.PlanRunner._compact_chunk
    inside = [False]
    refused = []

    def compact(self, chunk, target):
        inside[0] = chunk.alive.is_cuda      # the CPU database sorts
        try:
            return real(self, chunk, target)
        finally:
            inside[0] = False

    def refuse(name, fn):
        def call(*args, **kwargs):
            if inside[0]:
                refused.append(name)
            return fn(*args, **kwargs)
        return call
    monkeypatch.setattr(R.PlanRunner, "_compact_chunk", compact)
    for name in ("sort", "argsort"):
        monkeypatch.setattr(torch, name, refuse(name, getattr(torch, name)))
    dbs = [Database(device=d) for d in ("cpu", "cuda")]
    try:
        for db in dbs:
            load_tpch(db, scale=0.01, seed=0)
        for q in (3, 5, 12):
            sql = with_tiebreak(q, TPCH_QUERIES[q])
            want = dbs[0].execute(sql).rows
            TC.reset_launches()
            del calls[:]
            got = dbs[1].execute(sql).rows
            assert len(got) == len(want)
            assert all(_rows_close(a, b) for a, b in zip(got, want))
            assert calls and TC.LAUNCHES["sort_groupby_compact"] >= len(
                [c for c in calls if c[1] is not None])
    finally:
        for db in dbs:
            db.close()
    assert not refused, refused
