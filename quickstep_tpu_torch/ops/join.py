"""Join kernels: the direct-address table, open addressing, the
sorted-build unique probe, the expansion probe and the run-statistics
probes.

Counterparts of quickstep_tpu/ops/join.py `direct_build` (:43),
`direct_probe` (:63), `oa_build` (:83), `oa_probe` (:135), `sorted_build`
(:181), `expand_probe` (:228, with :189 `merge_starts`),
`merge_stats_probe` (:247), `merge_cmp_probe` (:317) and
`merge_unique_probe` (:382). Each has a plain torch version (`*_plain`)
and a hand-written CUDA kernel (ops/cuda.py; csrc/join_kernels.cu: K3 for
the direct table, K4 for the sorted probe, K7 for the expansion probe, K8 for
the run statistics, which sorts its build side with the key-value radix sort
of csrc/radix_device.cuh, not with sorted_build; csrc/hash_kernels.cu: K11
for open addressing). The
public function takes the plain version for tensors that lie on the CPU and
launches the kernel for CUDA tensors.

Uniqueness violations and expansion overflows are detected on the device
(0-d bool flags) so the executor can retry on the expansion path or with a
wider expansion, the analog of the reference's
HashTablePutResult::kOutOfSpace resize.
"""

from __future__ import annotations

from typing import List

import torch

from quickstep_tpu_torch.ops.kernels import hash_keys_plain, max_sentinel


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


# ---------------------------------------------------------------------
# direct-address table (dense integer keys)
# ---------------------------------------------------------------------

def direct_build(key: torch.Tensor, alive: torch.Tensor, lo: int,
                 domain: int):
    """Returns (int32 table of build row or -1, 0-d bool dup flag). When
    keys repeat, which row wins differs between the two versions; the dup
    flag is set then and the executor discards the table. The plain table
    is [domain]; the kernel's may carry a presence bitmap behind its
    `domain` slots (ops/cuda.py direct_build), so only direct_probe reads
    it, and direct_table gives its slots."""
    if _on_cpu(key):
        return direct_build_plain(key, alive, lo, domain)
    from quickstep_tpu_torch.ops import cuda
    return cuda.direct_build(key.contiguous(), alive.contiguous(), lo, domain)


def direct_build_plain(key: torch.Tensor, alive: torch.Tensor, lo: int,
                       domain: int):
    """Plain torch version of direct_build: one scatter, then a read-back
    that finds the rows which lost their slot."""
    idx = key.to(torch.int64) - lo
    in_dom = alive & (idx >= 0) & (idx < domain)
    rows = torch.arange(key.shape[0], dtype=torch.int32, device=key.device)
    slot = torch.where(in_dom, idx, torch.full_like(idx, domain))
    table = torch.full((domain + 1,), -1, dtype=torch.int32,
                       device=key.device).scatter_(0, slot, rows)[:domain]
    read_back = table[torch.clamp(idx, 0, domain - 1)]
    dup = torch.any(in_dom & (read_back != rows))
    return table, dup


def direct_probe(table: torch.Tensor, key: torch.Tensor, alive: torch.Tensor,
                 lo: int, domain: int):
    """Returns (int32 build row idx, -1 if none; bool matched)."""
    if _on_cpu(key):
        return direct_probe_plain(table, key, alive, lo, domain)
    from quickstep_tpu_torch.ops import cuda
    return cuda.direct_probe(table, key.contiguous(), alive.contiguous(), lo,
                             domain)


def direct_table(table: torch.Tensor, domain: int) -> torch.Tensor:
    """The int32 row table[domain] of either version's direct_build."""
    return table[:domain]


def direct_probe_plain(table: torch.Tensor, key: torch.Tensor,
                       alive: torch.Tensor, lo: int, domain: int):
    idx = key.to(torch.int64) - lo
    in_range = (idx >= 0) & (idx < domain) & alive
    b = table[torch.clamp(idx, 0, domain - 1)]
    matched = in_range & (b >= 0)
    return torch.where(matched, b, torch.full_like(b, -1)), matched


# ---------------------------------------------------------------------
# sorted build, unique probe (composite / sparse keys)
# ---------------------------------------------------------------------

def sorted_build(key: torch.Tensor, alive: torch.Tensor):
    """Single packed int64 key; dead rows sort last as the dtype's max.
    Returns (sorted_key, order) from one stable sort."""
    sent = max_sentinel(key.dtype)
    k = torch.where(alive, key, torch.full_like(key, sent))
    return torch.sort(k, stable=True)


def expand_probe(sorted_key: torch.Tensor, order: torch.Tensor,
                 probe_key: torch.Tensor, alive: torch.Tensor,
                 max_matches: int):
    """For each probe row, the run of equal keys in sorted_key (from
    sorted_build, int64). Returns (int32 build rows [n * K], row-major, the
    run's first K rows in stable sort order and -1 pads; int32 run lengths
    [n], 0 on dead rows; 0-d bool overflow flag: a run is longer than K)."""
    if _on_cpu(probe_key):
        return expand_probe_plain(sorted_key, order, probe_key, alive,
                                  max_matches)
    from quickstep_tpu_torch.ops import cuda
    return cuda.expand_probe(sorted_key.contiguous(), order.contiguous(),
                             probe_key.to(torch.int64).contiguous(),
                             alive.contiguous(), max_matches)


def expand_probe_plain(sorted_key: torch.Tensor, order: torch.Tensor,
                       probe_key: torch.Tensor, alive: torch.Tensor,
                       max_matches: int):
    """Plain torch version of expand_probe: the run's (start, count) from a
    left and a right searchsorted, then an [n, K] gather of the order."""
    probe = probe_key.to(torch.int64)
    n, nb, k = probe.shape[0], sorted_key.shape[0], max_matches
    dev = probe.device
    left = torch.searchsorted(sorted_key, probe)
    right = torch.searchsorted(sorted_key, probe, right=True)
    live = alive & (probe != max_sentinel(torch.int64))
    count = torch.where(live, right - left,
                        torch.zeros((), dtype=left.dtype, device=dev))
    slot = torch.arange(k, device=dev)
    ok = slot[None, :] < count[:, None]
    if nb == 0:
        rows = torch.full((n, k), -1, dtype=torch.int32, device=dev)
    else:
        pos = torch.clamp(left[:, None] + slot[None, :], 0, nb - 1)
        rows = torch.where(ok, order[pos].to(torch.int32),
                           torch.full((), -1, dtype=torch.int32, device=dev))
    count = count.to(torch.int32)
    return rows.reshape(-1), count, torch.any(count > k)


def merge_stats_probe(packed_build: torch.Tensor, bmask: torch.Tensor,
                      bval: torch.Tensor, packed_probe: torch.Tensor,
                      pmask: torch.Tensor):
    """For every probe row: (matched, min, max) of the live build rows'
    int32 `bval` within its equal-key run; (INT32_MAX, INT32_MIN) where no
    live build row has the key. `bval` must be int32-safe (the caller
    checks)."""
    if _on_cpu(packed_probe):
        return merge_stats_probe_plain(packed_build, bmask, bval,
                                       packed_probe, pmask)
    from quickstep_tpu_torch.ops import cuda
    return cuda.run_stats_probe(packed_build.to(torch.int64).contiguous(),
                                bmask.contiguous(),
                                bval.to(torch.int32).contiguous(),
                                packed_probe.to(torch.int64).contiguous(),
                                pmask.contiguous())


def merge_stats_probe_plain(packed_build: torch.Tensor, bmask: torch.Tensor,
                            bval: torch.Tensor, packed_probe: torch.Tensor,
                            pmask: torch.Tensor):
    """Plain torch version of merge_stats_probe: scatter_reduce_ of the
    sorted values by run, then a lower-bound searchsorted per probe row."""
    i32 = torch.iinfo(torch.int32)
    sorted_key, order = sorted_build(packed_build.to(torch.int64), bmask)
    probe = packed_probe.to(torch.int64)
    dev = probe.device
    nb = sorted_key.shape[0]
    lo_t = torch.full(probe.shape, i32.max, dtype=torch.int32, device=dev)
    hi_t = torch.full(probe.shape, i32.min, dtype=torch.int32, device=dev)
    if nb == 0:
        return torch.zeros_like(pmask), lo_t, hi_t
    sv = bval.to(torch.int32)[order]
    change = torch.ones(nb, dtype=torch.bool, device=dev)
    change[1:] = sorted_key[1:] != sorted_key[:-1]
    run = torch.cumsum(change.to(torch.int64), 0) - 1
    run_min = torch.full((nb,), i32.max, dtype=torch.int32,
                         device=dev).scatter_reduce_(0, run, sv, "amin")
    run_max = torch.full((nb,), i32.min, dtype=torch.int32,
                         device=dev).scatter_reduce_(0, run, sv, "amax")
    pos = torch.clamp(torch.searchsorted(sorted_key, probe), 0, nb - 1)
    has = (sorted_key[pos] == probe) & (probe != max_sentinel(torch.int64))
    r = run[pos]
    return (pmask & has, torch.where(has, run_min[r], lo_t),
            torch.where(has, run_max[r], hi_t))


def merge_cmp_probe(packed_build: torch.Tensor, bmask: torch.Tensor,
                    bval: torch.Tensor, packed_probe: torch.Tensor,
                    pmask: torch.Tensor, pval: torch.Tensor, op: str):
    """The EXISTS-with-comparison semi join: for every probe row, does its
    equal-key run hold a live build row x with (pval OP x)? Decided from the
    run's min and max of the int32 values. Returns bool in probe order."""
    if op not in CMP_HIT:
        raise ValueError(op)
    if _on_cpu(packed_probe):
        return merge_cmp_probe_plain(packed_build, bmask, bval, packed_probe,
                                     pmask, pval, op)
    from quickstep_tpu_torch.ops import cuda
    return cuda.run_stats_probe(packed_build.to(torch.int64).contiguous(),
                                bmask.contiguous(),
                                bval.to(torch.int32).contiguous(),
                                packed_probe.to(torch.int64).contiguous(),
                                pmask.contiguous(),
                                pval.to(torch.int32).contiguous(), op)


# (v OP x for some x of a run) from the run's min and max of x
CMP_HIT = {
    "<>": lambda v, mn, mx: (mn != v) | (mx != v),
    "<": lambda v, mn, mx: v < mx,
    "<=": lambda v, mn, mx: v <= mx,
    ">": lambda v, mn, mx: v > mn,
    ">=": lambda v, mn, mx: v >= mn,
}


def merge_cmp_probe_plain(packed_build: torch.Tensor, bmask: torch.Tensor,
                          bval: torch.Tensor, packed_probe: torch.Tensor,
                          pmask: torch.Tensor, pval: torch.Tensor, op: str):
    """Plain torch version of merge_cmp_probe, over merge_stats_probe_plain."""
    matched, mn, mx = merge_stats_probe_plain(packed_build, bmask, bval,
                                              packed_probe, pmask)
    return matched & CMP_HIT[op](pval.to(torch.int32), mn, mx)


def merge_unique_probe(packed_build: torch.Tensor, bmask: torch.Tensor,
                       packed_probe: torch.Tensor, pmask: torch.Tensor):
    """Probe against a (nominally unique-key) build side. Returns (int32
    build row idx, -1 if none; bool matched; 0-d bool dup flag: two live
    build rows share a key). The matched row is the first equal key in the
    stable sort order, as in the reference."""
    if _on_cpu(packed_probe):
        return merge_unique_probe_plain(packed_build, bmask, packed_probe,
                                        pmask)
    from quickstep_tpu_torch.ops import cuda
    sorted_key, order = sorted_build(packed_build.to(torch.int64), bmask)
    return cuda.sorted_probe(sorted_key, order,
                             packed_probe.to(torch.int64).contiguous(),
                             pmask.contiguous())


def merge_unique_probe_plain(packed_build: torch.Tensor, bmask: torch.Tensor,
                             packed_probe: torch.Tensor, pmask: torch.Tensor):
    """Plain torch version of merge_unique_probe: a lower-bound
    searchsorted into the sorted build keys."""
    sorted_key, order = sorted_build(packed_build.to(torch.int64), bmask)
    probe = packed_probe.to(torch.int64)
    sent = max_sentinel(torch.int64)
    live_sorted = sorted_key != sent
    dup = torch.any((sorted_key[1:] == sorted_key[:-1]) & live_sorted[1:])
    n = sorted_key.shape[0]
    if n == 0:
        none = torch.zeros_like(pmask)
        return torch.full(probe.shape, -1, dtype=torch.int32,
                          device=probe.device), none, dup
    pos = torch.searchsorted(sorted_key, probe)
    safe = torch.clamp(pos, 0, n - 1)
    matched = pmask & (probe != sent) & (pos < n) & (sorted_key[safe] == probe)
    bidx = torch.where(matched, order[safe].to(torch.int32),
                       torch.full(probe.shape, -1, dtype=torch.int32,
                                  device=probe.device))
    return bidx, matched, dup


# ---------------------------------------------------------------------
# open addressing (composite keys of any type: set operations, unpackable
# semi-join keys)
# ---------------------------------------------------------------------

def _oa_slots(cols: List[torch.Tensor], table_size: int) -> torch.Tensor:
    # (float keys hash by their int64 truncation; equality compares values)
    return hash_keys_plain(cols) & (table_size - 1)


def oa_build(key_cols: List[torch.Tensor], alive: torch.Tensor,
             table_size: int):
    """Insert the live build rows into a linear-probing table. table_size
    is a power of two above the number of live rows. Returns (table, 0-d
    bool dup flag: two live rows share a key). No row evicts one that has
    settled; which of two equal keys settles may differ between the two
    versions. The table is opaque to the callers, who hand it to oa_probe:
    on the CPU an int32 table[table_size] of build rows or -1; on CUDA one
    K11 launch, whose table holds the packed key beside the row id where
    the key columns are integers of at most 64 bits in all
    (cuda.oa_word_route, cuda.OATable), else the int32 row table."""
    if alive.device.type == "cpu":
        return oa_build_plain(key_cols, alive, table_size)
    from quickstep_tpu_torch.ops import cuda
    return cuda.oa_build([c.contiguous() for c in key_cols],
                         alive.contiguous(), table_size)


def oa_build_plain(key_cols: List[torch.Tensor], alive: torch.Tensor,
                   table_size: int):
    """Plain torch version of oa_build, in the reference's rounds: every
    pending row reads its slot; an empty slot takes one scattered
    contender, an equal occupant (or an equal winner of the slot it lost)
    marks the row a duplicate, any other occupant sends it to the next
    slot. Only pending rows are touched. Unlike the reference, whose
    losers step on without comparing, the dup flag is set exactly when two
    live rows share a key, as in the kernel."""
    dev = alive.device
    mask = table_size - 1
    table = torch.full((table_size,), -1, dtype=torch.int32, device=dev)
    rows = torch.nonzero(alive).flatten()
    slots = _oa_slots(key_cols, table_size)[rows] if rows.numel() else \
        rows
    dup = torch.zeros((), dtype=torch.bool, device=dev)
    while rows.numel():
        cur = table[slots].to(torch.int64)
        occupied = cur >= 0
        same = occupied.clone()
        safe = torch.where(occupied, cur, rows)
        for c in key_cols:
            same &= c[safe] == c[rows]
        dup = dup | torch.any(same)
        attempt = ~occupied
        table[slots[attempt]] = rows[attempt].to(torch.int32)
        winner = table[slots].to(torch.int64)
        won = attempt & (winner == rows)
        lost = attempt & ~won
        for c in key_cols:
            lost &= c[winner] == c[rows]
        dup = dup | torch.any(lost)
        still = ~won & ~same & ~lost
        rows = rows[still]
        slots = (slots[still] + 1) & mask
    return table, dup


def oa_probe(table, build_key_cols: List[torch.Tensor],
             probe_key_cols: List[torch.Tensor], alive: torch.Tensor):
    """Walk from each live probe row's slot to an equal key or an empty
    slot. Returns (int32 build row or -1, bool matched). On CUDA one K11
    launch (none over an empty build side): a key-in-slot table compares
    packed words, the probe columns cast to the build's dtypes; an int32
    table hashes the keys in the kernel and compares key columns."""
    if alive.device.type == "cpu":
        return oa_probe_plain(table, build_key_cols, probe_key_cols, alive)
    from quickstep_tpu_torch.ops import cuda
    if isinstance(table, cuda.OATable):
        return cuda.oa_probe(table, list(build_key_cols),
                             list(probe_key_cols),
                             alive.contiguous())
    # the kernel compares like dtypes: each pair at its promoted dtype (the
    # hash reads both as int64, so equal values hash alike)
    pairs = [(b, p) if b.dtype == p.dtype else
             (b.to(torch.promote_types(b.dtype, p.dtype)),
              p.to(torch.promote_types(b.dtype, p.dtype)))
             for b, p in zip(build_key_cols, probe_key_cols)]
    return cuda.oa_probe(table, [b.contiguous() for b, _ in pairs],
                         [p.contiguous() for _, p in pairs],
                         alive.contiguous())


def oa_probe_plain(table: torch.Tensor, build_key_cols: List[torch.Tensor],
                   probe_key_cols: List[torch.Tensor], alive: torch.Tensor):
    """Plain torch version of oa_probe: the active rows advance together,
    one slot a round."""
    dev = alive.device
    table_size = table.shape[0]
    mask = table_size - 1
    n = alive.shape[0]
    result = torch.full((n,), -1, dtype=torch.int32, device=dev)
    if build_key_cols[0].shape[0] == 0:
        return result, result >= 0
    rows = torch.nonzero(alive).flatten()
    slots = _oa_slots(probe_key_cols, table_size)[rows] if rows.numel() \
        else rows
    steps = 0
    while rows.numel() and steps < table_size:
        occ = table[slots].to(torch.int64)
        filled = occ >= 0
        match = filled.clone()
        safe = torch.where(filled, occ, torch.zeros_like(occ))
        for bk, pk in zip(build_key_cols, probe_key_cols):
            match &= bk[safe] == pk[rows]
        result[rows[match]] = occ[match].to(torch.int32)
        go = filled & ~match
        rows = rows[go]
        slots = (slots[go] + 1) & mask
        steps += 1
    return result, result >= 0
