"""The port's join building blocks against quickstep_tpu's.

The plain torch versions (the CPU path of the direct-address table, the
exact filter, the sorted-build unique probe, the expansion probe, the
run-statistics probes and the many-column gather) are held against the JAX
functions on the same seeded numpy inputs, and the lazy gather maps
(RowIds chains, the expansion's repeated maps) against direct gathers and
the reference's chains. Everything compared here is integer or bool, or a gathered copy of
a value, so every comparison is exact. The CUDA kernels are held against
these plain versions in test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickstep_tpu.exec import chunk as JC
from quickstep_tpu.ops import bloom as JB
from quickstep_tpu.ops import join as JJ
from quickstep_tpu.ops import kernels as JK
from quickstep_tpu_torch.exec import chunk as TC
from quickstep_tpu_torch.ops import bloom as TB
from quickstep_tpu_torch.ops import join as TJ
from quickstep_tpu_torch.ops import kernels as TK

LO, DOMAIN = 100, 5000


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _eq(got, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _build_side(key_dtype, case, seed=3, n=1500):
    """Build keys mostly in [LO, LO + DOMAIN), some outside it; dead rows;
    NULL-key rows (alive, but the key is NULL: the runner masks them out of
    the build, as it does here); one live duplicate key when case == dups."""
    rng = np.random.default_rng(seed)
    key = (rng.permutation(DOMAIN + 200)[:n] + LO - 100).astype(key_dtype)
    alive = rng.random(n) < 0.8
    key_valid = rng.random(n) < 0.9
    if case == "dups":
        key[11] = key[5]
        alive[[5, 11]] = True
        key_valid[[5, 11]] = True
        key[[5, 11]] = LO + 7
    elif case == "all_dead":
        alive[:] = False
    return key, alive & key_valid


def _probe_side(key_dtype, seed=4, n=4000):
    rng = np.random.default_rng(seed)
    key = rng.integers(LO - 300, LO + DOMAIN + 300, n).astype(key_dtype)
    alive = rng.random(n) < 0.8
    key_valid = rng.random(n) < 0.95
    return key, alive & key_valid


@pytest.mark.parametrize("case", ("unique", "dups", "all_dead"))
@pytest.mark.parametrize("key_dtype", (np.int32, np.int64),
                         ids=lambda d: np.dtype(d).name)
def test_direct_join_matches_reference(key_dtype, case):
    bkey, bmask = _build_side(key_dtype, case)
    pkey, pmask = _probe_side(key_dtype)
    t_table, t_dup = TJ.direct_build(_t(bkey), _t(bmask), LO, DOMAIN)
    j_table, j_dup = JJ.direct_build(_j(bkey), _j(bmask), LO, DOMAIN)
    assert bool(t_dup) == bool(j_dup) == (case == "dups")
    if case == "dups":
        # which duplicate wins may differ, and only at the duplicate's slot:
        # the executor discards the table when the flag is set
        differ = np.nonzero(t_table.numpy() != np.asarray(j_table))[0]
        assert set(differ.tolist()) <= {7}
    else:
        _eq(t_table, j_table)
    # probe the same table with both
    got = TJ.direct_probe(t_table, _t(pkey), _t(pmask), LO, DOMAIN)
    want = JJ.direct_probe(_j(t_table.numpy()), _j(pkey), _j(pmask), LO,
                           DOMAIN)
    for g, w in zip(got, want):
        _eq(g, w)
    if case != "all_dead":
        assert int(got[1].sum()) > 100


@pytest.mark.parametrize("key_dtype", (np.int32, np.int64),
                         ids=lambda d: np.dtype(d).name)
def test_exact_filter_matches_reference(key_dtype):
    # a semi join's build side: many repeated keys, some out of the domain
    pkey, pmask = _probe_side(key_dtype, seed=8)
    bkey, bmask = _build_side(key_dtype, "unique", seed=9)
    t_bits = TB.exact_filter_build(_t(pkey), _t(pmask), LO, DOMAIN)
    j_bits = JB.exact_filter_build(_j(pkey), _j(pmask), LO, DOMAIN)
    _eq(t_bits, j_bits)
    _eq(TB.exact_filter_probe(t_bits, _t(bkey), _t(bmask), LO),
        JB.exact_filter_probe(j_bits, _j(bkey), _j(bmask), LO))


@pytest.mark.parametrize("case", ("unique", "dups", "all_dead", "empty"))
def test_merge_unique_probe_matches_reference(case):
    """Range-packed composite keys, as runner._pack_keys makes them."""
    bkey, bmask = _build_side(np.int64, "all_dead" if case == "all_dead"
                              else case)
    pkey, pmask = _probe_side(np.int64)
    span = 31
    packed_b = bkey * span + bkey % span
    packed_p = pkey * span + pkey % span
    packed_p[::7] += 1                       # misses on the second key
    if case == "empty":
        packed_b, bmask = packed_b[:0], bmask[:0]
    t_sorted, t_order = TJ.sorted_build(_t(packed_b), _t(bmask))
    j_sorted, j_order = JJ.sorted_build(_j(packed_b), _j(bmask))
    _eq(t_sorted, j_sorted)
    np.testing.assert_array_equal(t_order.numpy(), np.asarray(j_order))
    got = TJ.merge_unique_probe(_t(packed_b), _t(bmask), _t(packed_p),
                                _t(pmask))
    if case == "empty":
        # the reference cannot probe an empty build side (its merge indexes
        # row 0); nothing matches
        assert not got[1].any() and not bool(got[2])
        assert (got[0] == -1).all()
        return
    want = JJ.merge_unique_probe(_j(packed_b), _j(bmask), _j(packed_p),
                                 _j(pmask))
    for g, w in zip(got, want):
        _eq(g, w)
    assert bool(got[2]) == (case == "dups")
    if case in ("unique", "dups"):
        assert 100 < int(got[1].sum()) < len(pkey)


@pytest.mark.parametrize("idx_dtype", (np.int32, np.int64),
                         ids=lambda d: np.dtype(d).name)
def test_multi_gather_matches_reference(idx_dtype):
    rng = np.random.default_rng(12)
    n, m = 700, 2000
    cols = [rng.random(n) < 0.5, None,
            rng.integers(-10**9, 10**9, n).astype(np.int32),
            rng.integers(-10**15, 10**15, n), None,
            rng.random(n).astype(np.float32), rng.random(n),
            rng.integers(0, 9, n).astype(np.int32)]
    idx = rng.integers(0, n, m).astype(idx_dtype)
    got = TK.multi_gather([_t(c) for c in cols], _t(idx))
    want = JK.multi_gather([_j(c) for c in cols], _j(idx))
    assert len(got) == len(cols)
    for c, g, w in zip(cols, got, want):
        if c is None:
            assert g is None and w is None
        else:
            _eq(g, w)
            np.testing.assert_array_equal(g.numpy(), c[idx])


def _two_level_chain(rng, n=600):
    """A base chunk of three columns, a left join's map over it (idx1, ok1:
    unmatched rows NULL) and a compaction's map over that (idx2)."""
    a = rng.integers(-1000, 1000, n).astype(np.int32)
    b = rng.random(n)
    b_valid = rng.random(n) < 0.8
    c = rng.integers(0, 10**12, n)
    idx1 = rng.integers(0, n, 900).astype(np.int32)
    ok1 = rng.random(900) < 0.7
    idx2 = rng.permutation(900)[:400].astype(np.int64)
    return (a, b, b_valid, c), (idx1, ok1), idx2


def test_rowids_chain_matches_direct_gathers_and_reference():
    rng = np.random.default_rng(21)
    (a, b, b_valid, c), (idx1, ok1), idx2 = _two_level_chain(rng)
    base = TC.Chunk(attrs=[], slots={1: (_t(a), None), 2: (_t(b), _t(b_valid)),
                                     3: (_t(c), None)},
                    alive=torch.ones(len(a), dtype=torch.bool),
                    capacity=len(a))
    level1 = TC.Chunk(attrs=[], slots=TC.compose_slots(base, _t(idx1),
                                                       _t(ok1)),
                      alive=torch.ones(len(idx1), dtype=torch.bool),
                      capacity=len(idx1))
    level2 = TC.Chunk(attrs=[], slots=TC.compose_slots(level1, _t(idx2), None),
                      alive=torch.ones(len(idx2), dtype=torch.bool),
                      capacity=len(idx2))
    rid = level2.slots[1].rid
    assert rid.depth == 2 and rid.parent is level1.slots[1].rid
    assert all(level2.slots[e].rid is rid for e in (1, 2, 3))

    # the reference's chain over the same maps resolves to the same map
    j_rid = JC.RowIds(_j(idx2), None, parent=JC.RowIds(_j(idx1), _j(ok1)))
    j_rid.resolve()
    level2.ensure([1, 2, 3])
    assert rid.parent is None and rid.depth == 1
    np.testing.assert_array_equal(rid.idx.numpy(), np.asarray(j_rid.idx))
    np.testing.assert_array_equal(rid.ok.numpy(), np.asarray(j_rid.ok))

    # and the columns are the direct gathers
    eff, ok = idx1[idx2], ok1[idx2]
    d, v = level2.slots[1]
    np.testing.assert_array_equal(d.numpy(), a[eff])
    np.testing.assert_array_equal(v.numpy(), ok)
    d, v = level2.slots[2]
    np.testing.assert_array_equal(d.numpy(), b[eff])
    np.testing.assert_array_equal(v.numpy(), ok & b_valid[eff])
    d, v = level2.slots[3]
    np.testing.assert_array_equal(d.numpy(), c[eff])
    np.testing.assert_array_equal(v.numpy(), ok)


def test_restrict_valid_leaves_shared_rowids_alone():
    """A left join's residual narrows the build side's validity; the map it
    shares with another chunk must not change (the reference asserts that
    the map has no parent and mutates it in place)."""
    rng = np.random.default_rng(23)
    (a, b, b_valid, c), (idx1, ok1), idx2 = _two_level_chain(rng)
    base = TC.Chunk(attrs=[], slots={1: (_t(a), None), 2: (_t(b), None)},
                    alive=torch.ones(len(a), dtype=torch.bool),
                    capacity=len(a))
    level1 = TC.Chunk(attrs=[], slots=TC.compose_slots(base, _t(idx1),
                                                       _t(ok1)),
                      alive=torch.ones(len(idx1), dtype=torch.bool),
                      capacity=len(idx1))
    chained = TC.compose_slots(level1, _t(idx2), None)
    other = TC.Chunk(attrs=[], slots=dict(chained),
                     alive=torch.ones(len(idx2), dtype=torch.bool),
                     capacity=len(idx2))
    mine = TC.Chunk(attrs=[], slots=dict(chained),
                    alive=torch.ones(len(idx2), dtype=torch.bool),
                    capacity=len(idx2))
    keep = rng.random(len(idx2)) < 0.5
    mine.restrict_valid([1, 2], _t(keep))
    assert mine.slots[1].rid is mine.slots[2].rid
    assert mine.slots[1].rid is not other.slots[1].rid
    assert other.slots[1].rid.ok is None
    mine.ensure([1, 2])
    other.ensure([1, 2])
    eff, ok = idx1[idx2], ok1[idx2]
    for eid, col in ((1, a), (2, b)):
        d, v = mine.slots[eid]
        np.testing.assert_array_equal(d.numpy(), col[eff])
        np.testing.assert_array_equal(v.numpy(), ok & keep)
        d, v = other.slots[eid]
        np.testing.assert_array_equal(d.numpy(), col[eff])
        np.testing.assert_array_equal(v.numpy(), ok)


def test_take_columns_composes_with_pending_maps():
    rng = np.random.default_rng(24)
    (a, b, b_valid, c), (idx1, ok1), idx2 = _two_level_chain(rng)
    base = TC.Chunk(attrs=[], slots={1: (_t(a), None),
                                     2: (_t(b), _t(b_valid))},
                    alive=torch.ones(len(a), dtype=torch.bool),
                    capacity=len(a))
    level1 = TC.Chunk(attrs=[], slots=TC.compose_slots(base, _t(idx1),
                                                       _t(ok1)),
                      alive=torch.ones(len(idx1), dtype=torch.bool),
                      capacity=len(idx1))
    (da, db), (va, vb) = level1.take_columns(_t(idx2), [1, 2])
    eff, ok = idx1[idx2], ok1[idx2]
    np.testing.assert_array_equal(da.numpy(), a[eff])
    np.testing.assert_array_equal(db.numpy(), b[eff])
    np.testing.assert_array_equal(va.numpy(), ok)
    np.testing.assert_array_equal(vb.numpy(), ok & b_valid[eff])


def _runs_build(seed=31, n_keys=300, case="runs"):
    """Packed build keys in runs of 1-6 equal keys (one run of 11), shuffled,
    ~15% dead; int32 values. case == "all_dead" kills every row."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 7, n_keys)
    lens[17] = 11
    key = np.repeat(np.arange(n_keys, dtype=np.int64) * 1_000_003 + 5, lens)
    perm = rng.permutation(len(key))
    key = key[perm]
    alive = rng.random(len(key)) < (0.0 if case == "all_dead" else 0.85)
    val = rng.integers(-8, 8, len(key)).astype(np.int32)
    return key, alive, val


def _runs_probe(seed=32, n=3000, n_keys=300):
    """Probe keys over the build's keys and 20% more (empty runs), ~20%
    dead; int32 values."""
    rng = np.random.default_rng(seed)
    key = rng.integers(0, n_keys * 6 // 5, n).astype(np.int64) * 1_000_003 + 5
    alive = rng.random(n) < 0.8
    val = rng.integers(-9, 9, n).astype(np.int32)
    return key, alive, val


@pytest.mark.parametrize("k", (1, 4, 11, 16))
@pytest.mark.parametrize("case", ("runs", "all_dead"))
def test_expand_probe_matches_reference(case, k):
    """Rows (row-major, -1 pads) and run lengths exactly; the overflow flag
    is the runner's `any(counts > K)`. Dead probe rows count 0; probe keys
    with no build row (empty runs) count 0."""
    bkey, bmask, _ = _runs_build(case=case)
    pkey, pmask, _ = _runs_probe()
    t_sorted, t_order = TJ.sorted_build(_t(bkey), _t(bmask))
    j_sorted, j_order = JJ.sorted_build(_j(bkey), _j(bmask))
    rows, counts, overflow = TJ.expand_probe(t_sorted, t_order, _t(pkey),
                                             _t(pmask), k)
    j_rows, j_counts = JJ.expand_probe(j_sorted, j_order, _j(pkey),
                                       _j(pmask), k)
    _eq(rows, j_rows)
    _eq(counts, j_counts)
    assert bool(overflow) == bool(np.any(np.asarray(j_counts) > k))
    if case == "runs":
        assert bool(overflow) == (k < 11)
        c = counts.numpy()
        assert (c[~pmask] == 0).all() and (c == 0).sum() > 100
        assert 0 < int((c > 0).sum()) < len(pkey)
    else:
        assert not counts.any() and (rows == -1).all()


def test_expand_probe_empty_build():
    pkey, pmask, _ = _runs_probe()
    sorted_key, order = TJ.sorted_build(_t(np.zeros(0, np.int64)),
                                        _t(np.zeros(0, bool)))
    rows, counts, overflow = TJ.expand_probe(sorted_key, order, _t(pkey),
                                             _t(pmask), 3)
    assert rows.shape == (3 * len(pkey),) and (rows == -1).all()
    assert not counts.any() and not bool(overflow)


@pytest.mark.parametrize("case", ("runs", "all_dead"))
def test_merge_stats_probe_matches_reference(case):
    bkey, bmask, bval = _runs_build(case=case)
    pkey, pmask, _ = _runs_probe()
    got = TJ.merge_stats_probe(_t(bkey), _t(bmask), _t(bval), _t(pkey),
                               _t(pmask))
    want = JJ.merge_stats_probe(_j(bkey), _j(bmask), _j(bval), _j(pkey),
                                _j(pmask))
    for g, w in zip(got, want):
        _eq(g, w)
    if case == "runs":
        assert 100 < int(got[0].sum()) < len(pkey)


@pytest.mark.parametrize("op", ("<>", "<", "<=", ">", ">="))
@pytest.mark.parametrize("case", ("runs", "all_dead"))
def test_merge_cmp_probe_matches_reference(case, op):
    bkey, bmask, bval = _runs_build(case=case)
    pkey, pmask, pval = _runs_probe()
    got = TJ.merge_cmp_probe(_t(bkey), _t(bmask), _t(bval), _t(pkey),
                             _t(pmask), _t(pval), op)
    want = JJ.merge_cmp_probe(_j(bkey), _j(bmask), _j(bval), _j(pkey),
                              _j(pmask), _j(pval), op)
    _eq(got, want)
    if case == "runs":
        assert 50 < int(got.sum()) < len(pkey)
    else:
        assert not got.any()


def test_repeat_slots_matches_reference():
    """The expansion's k-fold repeat of a chunk: a materialized column and a
    chained lazy one, against the reference's repeat and direct gathers."""
    rng = np.random.default_rng(25)
    (a, b, b_valid, c), (idx1, ok1), idx2 = _two_level_chain(rng)
    base = TC.Chunk(attrs=[], slots={1: (_t(a), None),
                                     2: (_t(b), _t(b_valid))},
                    alive=torch.ones(len(a), dtype=torch.bool),
                    capacity=len(a))
    level1 = TC.Chunk(attrs=[], slots=TC.compose_slots(base, _t(idx1),
                                                       _t(ok1)),
                      alive=torch.ones(len(idx1), dtype=torch.bool),
                      capacity=len(idx1))
    level2 = TC.Chunk(attrs=[], slots={**TC.compose_slots(level1, _t(idx2),
                                                          None),
                                       3: (_t(c[:len(idx2)]), None)},
                      alive=torch.ones(len(idx2), dtype=torch.bool),
                      capacity=len(idx2))
    k = 3
    rep = TC.Chunk(attrs=[], slots=TC.repeat_slots(level2, k),
                   alive=torch.ones(k * len(idx2), dtype=torch.bool),
                   capacity=k * len(idx2))
    j_chunk = JC.Chunk(attrs=[], slots={3: (_j(c[:len(idx2)]), None)},
                       alive=_j(np.ones(len(idx2), bool)),
                       capacity=len(idx2))
    j_rep = JC.repeat_slots(j_chunk, k)
    np.testing.assert_array_equal(rep.slots[3].rid.idx.numpy(),
                                  np.asarray(j_rep[3].rid.idx))
    rep.ensure([1, 2, 3])
    eff = np.repeat(idx1[idx2], k)
    ok = np.repeat(ok1[idx2], k)
    np.testing.assert_array_equal(rep.slots[1][0].numpy(), a[eff])
    np.testing.assert_array_equal(rep.slots[1][1].numpy(), ok)
    np.testing.assert_array_equal(rep.slots[2][0].numpy(), b[eff])
    np.testing.assert_array_equal(rep.slots[2][1].numpy(), ok & b_valid[eff])
    np.testing.assert_array_equal(rep.slots[3][0].numpy(),
                                  np.repeat(c[:len(idx2)], k))
