"""Aggregation: the scalar (no GROUP BY) reduce, the dense group-by, the
sort group-by and its compacted form, and scalar DISTINCT.

Counterparts of quickstep_tpu/ops/groupby.py `scalar_agg` (:435),
`pack_dense_index` (:39) and `dense_groupby` (:56), which `dense_aggregate`
composes, `sort_groupby` (:204),
`sort_groupby_compact` (:405) and `distinct_count` (:455), with the
reference runner's `_dedup_values` (quickstep_tpu/exec/runner.py:837).
Each aggregate has a plain torch version (`*_plain`) and a hand-written CUDA
kernel (ops/cuda.py, csrc/agg_kernels.cu). The public function takes the
plain version for tensors that lie on the CPU and launches the kernel for
CUDA tensors; a CUDA tensor never reaches the plain version here.

All inputs are (values, valid, live-mask); aggregates skip dead rows and NULLs.
Every aggregate returns (data, non_null_count): count 0 means the SQL result is
NULL (except COUNT itself). Output dtypes are the reference's: SUM of an integer
type is int64, SUM of a float keeps its type, MIN/MAX keep the input's type,
AVG is float64, scalar counts are int64 and per-group counts int32.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from quickstep_tpu_torch.ops.cuda import MAX_DENSE_KEYS  # noqa: F401
from quickstep_tpu_torch.ops.kernels import (
    canonical_sort_key, compact_order, max_sentinel, min_sentinel,
    multi_gather, multi_gather_plain, stable_partition)

AggIn = Tuple[str, Optional[torch.Tensor], Optional[torch.Tensor]]  # (fn, vals, valid)

# The runner routes larger dense domains, and more key columns than the
# dense kernel packs, to the sort path (runner._dense_ok).
BROADCAST_DOMAIN_LIMIT = 128


def _sum_dtype(dt: torch.dtype) -> torch.dtype:
    return dt if dt.is_floating_point else torch.int64


def _acc_dtype(dt: torch.dtype) -> torch.dtype:
    """Sums accumulate in int64 or float64 (float32 sums are rounded to
    float32 once, at the end), as the kernels do."""
    return torch.float64 if dt.is_floating_point else torch.int64


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


# ---------------------------------------------------------------------
# dense (collision-free) path
# ---------------------------------------------------------------------

def pack_dense_index(key_cols: List[torch.Tensor], key_offsets: List[int],
                     key_strides: List[int], domain: int,
                     alive: torch.Tensor) -> torch.Tensor:
    """Radix-pack composite keys into [0, domain); dead/out-of-range rows ->
    domain (dropped by the group-by)."""
    idx = torch.zeros(alive.shape, dtype=torch.int64, device=alive.device)
    for col, off, stride in zip(key_cols, key_offsets, key_strides):
        idx = idx + (col.to(torch.int64) - off) * stride
    keep = alive & (idx >= 0) & (idx < domain)
    return torch.where(keep, idx, torch.full_like(idx, domain))


def dense_aggregate(key_cols: List[torch.Tensor], key_offsets: List[int],
                    key_strides: List[int], domain: int,
                    agg_specs: List[AggIn], alive: torch.Tensor):
    """One dense GROUP BY: exactly dense_groupby(pack_dense_index(key_cols,
    key_offsets, key_strides, domain, alive), domain, agg_specs, alive).
    Returns (occupied bool[domain], [(data[domain], nn_count
    int32[domain])...]). On CUDA one K2 launch packs the keys in registers
    and computes every aggregate (ops/cuda.py dense_aggregate); on the CPU
    the plain version."""
    if _on_cpu(alive):
        return dense_aggregate_plain(key_cols, key_offsets, key_strides,
                                     domain, agg_specs, alive)
    return _dense_kernel([k.contiguous() for k in key_cols], key_offsets,
                         key_strides, domain, agg_specs, alive)


def dense_aggregate_plain(key_cols: List[torch.Tensor],
                          key_offsets: List[int], key_strides: List[int],
                          domain: int, agg_specs: List[AggIn],
                          alive: torch.Tensor):
    """Plain torch version of dense_aggregate: the composition it names."""
    idx = pack_dense_index(key_cols, key_offsets, key_strides, domain, alive)
    return dense_groupby_plain(idx, domain, agg_specs, alive)


def dense_groupby(idx: torch.Tensor, domain: int, agg_specs: List[AggIn],
                  alive: torch.Tensor):
    """Collision-free aggregation: idx from pack_dense_index. Returns
    (occupied bool[domain], [(data[domain], nn_count int32[domain])...]).
    On CUDA the K2 kernel of dense_aggregate with idx as its one key column
    (offset 0, stride 1); on the CPU the plain version."""
    if _on_cpu(idx):
        return dense_groupby_plain(idx, domain, agg_specs, alive)
    return _dense_kernel([idx.contiguous()], [0], [1], domain, agg_specs,
                         alive)


def _dense_kernel(key_cols, key_offsets, key_strides, domain, agg_specs,
                  alive):
    """K2 on CUDA tensors: AVG is its SUM and count, divided here."""
    from quickstep_tpu_torch.ops import cuda
    specs = [("sum" if fn == "avg" else fn,
              None if vals is None else vals.contiguous(),
              None if valid is None else valid.contiguous())
             for fn, vals, valid in agg_specs]
    occupied, res = cuda.dense_aggregate(key_cols, key_offsets, key_strides,
                                         domain, specs, alive.contiguous())
    results = []
    for (fn, _v, _vv), (data, nn) in zip(agg_specs, res):
        if fn == "avg":
            data = data.to(torch.float64) / torch.clamp(nn, min=1)
        results.append((data, nn))
    return occupied, results


def dense_groupby_plain(idx: torch.Tensor, domain: int,
                        agg_specs: List[AggIn], alive: torch.Tensor):
    """Plain torch version of dense_groupby: one scatter per aggregate into
    domain + 1 slots, the last of which takes the dead rows."""
    in_dom = idx < domain
    slot = torch.where(in_dom, idx, torch.full_like(idx, domain))
    dev = idx.device
    results = []
    for fn, vals, valid in agg_specs:
        live = alive & in_dom if valid is None else (alive & in_dom & valid)
        nn = torch.zeros(domain + 1, dtype=torch.int32, device=dev).index_add_(
            0, slot, live.to(torch.int32))[:domain]
        if fn == "count":
            data = nn
        elif fn in ("sum", "avg"):
            adt = _acc_dtype(vals.dtype)
            contrib = torch.where(live, vals.to(adt), torch.zeros((), dtype=adt,
                                                                  device=dev))
            acc = torch.zeros(domain + 1, dtype=adt, device=dev).index_add_(
                0, slot, contrib)[:domain]
            data = acc.to(_sum_dtype(vals.dtype)) if fn == "sum" else \
                acc.to(torch.float64) / torch.clamp(nn, min=1)
        elif fn in ("min", "max"):
            fill = max_sentinel(vals.dtype) if fn == "min" else \
                min_sentinel(vals.dtype)
            contrib = torch.where(live, vals, torch.full(
                (), fill, dtype=vals.dtype, device=dev))
            data = torch.full((domain + 1,), fill, dtype=vals.dtype,
                              device=dev).scatter_reduce_(
                0, slot, contrib, reduce="amin" if fn == "min" else "amax")
            data = data[:domain]
        else:
            raise ValueError(fn)
        results.append((data, nn))
    occupied = torch.zeros(domain + 1, dtype=torch.int32, device=dev).index_add_(
        0, slot, (alive & in_dom).to(torch.int32))[:domain] > 0
    return occupied, results


# ---------------------------------------------------------------------
# sort-based path
# ---------------------------------------------------------------------

def sort_groupby(key_cols: List[torch.Tensor],
                 key_valids: List[Optional[torch.Tensor]],
                 agg_specs: List[AggIn], alive: torch.Tensor,
                 packed_key: Optional[torch.Tensor] = None,
                 sort_subset: Optional[List[int]] = None,
                 want_rows: bool = False):
    """Sort-based group-by: one stable torch.sort of the packed key (or one
    stable sort per key, last key first, when the key is not packed), then
    per-group reductions over the sorted rows.

    Returns (out_key_cols, out_key_valids, occupied, n_groups,
    [(data, nn_count)...]) and, with want_rows, the sort permutation: each
    output row's input row, the representative row of its group at the
    occupied rows. Outputs have input capacity and key-sorted order; a
    group's results sit at its last sorted row, which `occupied` marks.
    Other rows hold 0. Rows whose group key is NULL group together (the
    dtype's max stands for NULL in the sort). On CUDA the reductions are K5
    and the key gathers K6; on the CPU their plain versions run.
    """
    return _sort_groupby(key_cols, key_valids, agg_specs, alive, packed_key,
                         sort_subset, want_rows, plain=_on_cpu(alive))


def sort_groupby_plain(key_cols, key_valids, agg_specs, alive,
                       packed_key=None, sort_subset=None, want_rows=False):
    """Plain torch version of sort_groupby: the same sort, then cumsum,
    index_add_ and scatter_reduce_ per aggregate."""
    return _sort_groupby(key_cols, key_valids, agg_specs, alive, packed_key,
                         sort_subset, want_rows, plain=True)


def _sortable(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.uint8) if t.dtype == torch.bool else t


def _sort_groupby(key_cols, key_valids, agg_specs, alive, packed_key,
                  sort_subset, want_rows, plain):
    gather = multi_gather_plain if plain else multi_gather
    n = alive.shape[0]
    dev = alive.device
    pos = torch.arange(n, device=dev)
    if packed_key is not None:
        sent = max_sentinel(packed_key.dtype)
        k = torch.where(alive, packed_key,
                        torch.full((), sent, dtype=packed_key.dtype,
                                   device=dev))
        s_key, perm = torch.sort(k, stable=True)
        s_alive = s_key != sent
        change = pos == 0
        change = change | (s_key != torch.roll(s_key, 1))
        sorted_keys = gather(list(key_cols) + list(key_valids), perm,
                             random=True)
    else:
        subset = list(sort_subset) if sort_subset is not None \
            else list(range(len(key_cols)))
        sort_keys = []
        for i in subset:
            col, valid = _sortable(key_cols[i]), key_valids[i]
            if valid is not None:
                top = float("inf") if col.dtype.is_floating_point else \
                    torch.iinfo(col.dtype).max
                col = torch.where(valid, col, torch.full(
                    (), top, dtype=col.dtype, device=dev))
            # a canonical copy of a float key: equal zeros stay one group
            # and NaNs sort last on the card as well; the keys returned
            # are gathered from key_cols and keep their own bits
            sort_keys.append(canonical_sort_key(col))
        # least significant key first; the live mask last, so dead rows
        # sort after every live row
        perm = pos
        for k in reversed([(~alive).to(torch.uint8)] + sort_keys):
            _, p = torch.sort(k.index_select(0, perm), stable=True)
            perm = perm.index_select(0, p)
        g = gather([alive] + sort_keys + list(key_cols) + list(key_valids),
                   perm, random=True)
        s_alive = g[0]
        change = pos == 0
        for sk in g[1:1 + len(sort_keys)]:
            change = change | (sk != torch.roll(sk, 1))
        sorted_keys = g[1 + len(sort_keys):]
    change = change & s_alive
    n_groups = torch.sum(change, dtype=torch.int64)
    last = s_alive & ((pos == n - 1) | torch.roll(change, -1) |
                      ~torch.roll(s_alive, -1))
    out_keys = sorted_keys[:len(key_cols)]
    out_valids = sorted_keys[len(key_cols):]

    results = []
    cache = {}
    for fn, vals, valid in agg_specs:
        kfn = "sum" if fn == "avg" else fn
        key = (kfn, id(vals) if kfn != "count" else None, id(valid))
        if key not in cache:
            if plain:
                cache[key] = _segment_reduce_plain(kfn, change, s_alive, last,
                                                   perm, vals, valid)
            else:
                from quickstep_tpu_torch.ops import cuda
                cache[key] = cuda.segment_reduce(
                    kfn, change, s_alive, perm,
                    None if vals is None else vals.contiguous(),
                    None if valid is None else valid.contiguous())
        data, nn = cache[key]
        if fn == "avg":
            data = data.to(torch.float64) / torch.clamp(nn, min=1)
        results.append((data, nn))
    if want_rows:
        return out_keys, out_valids, last, n_groups, results, perm
    return out_keys, out_valids, last, n_groups, results


def sort_groupby_compact(key_cols, key_valids, agg_specs, alive,
                         packed_key=None, sort_subset=None):
    """sort_groupby, then the group rows compacted to the front in key-sorted
    order: rows [0, n_groups) are the groups. Key-sorted placement makes the
    outputs of different calls over the same key set line up row for row
    (the DISTINCT aggregate's merge relies on it). Returns (out_key_cols,
    out_key_valids, n_groups, [(data, nn_count)...]). On CUDA the compaction
    is K9 and the gather K6; on the CPU their plain versions run."""
    return _sort_groupby_compact(key_cols, key_valids, agg_specs, alive,
                                 packed_key, sort_subset,
                                 plain=_on_cpu(alive))


def sort_groupby_compact_plain(key_cols, key_valids, agg_specs, alive,
                               packed_key=None, sort_subset=None):
    """Plain torch version of sort_groupby_compact (plain group-by, stable
    argsort, index_select)."""
    return _sort_groupby_compact(key_cols, key_valids, agg_specs, alive,
                                 packed_key, sort_subset, plain=True)


def _sort_groupby_compact(key_cols, key_valids, agg_specs, alive, packed_key,
                          sort_subset, plain):
    out_keys, out_valids, mask, n_groups, results = _sort_groupby(
        key_cols, key_valids, agg_specs, alive, packed_key, sort_subset,
        False, plain=plain)
    order = (compact_order if plain else stable_partition)(mask)
    flat = list(out_keys) + list(out_valids) + \
        [d for d, _ in results] + [nn for _, nn in results]
    g = (multi_gather_plain if plain else multi_gather)(flat, order)
    k, r = len(out_keys), len(results)
    return g[:k], g[k:2 * k], n_groups, \
        list(zip(g[2 * k:2 * k + r], g[2 * k + r:]))


def _segment_reduce_plain(fn, change, s_alive, last, perm, vals, valid):
    """Per-group fn over key-sorted rows, at each group's last row; 0
    elsewhere (K5's layout)."""
    n = s_alive.shape[0]
    dev = s_alive.device
    sid = torch.clamp(torch.cumsum(change.to(torch.int64), 0) - 1, 0,
                      max(n - 1, 0))
    live = s_alive if valid is None else (s_alive & valid.index_select(0, perm))
    nn = torch.zeros(n, dtype=torch.int32, device=dev).index_add_(
        0, sid, live.to(torch.int32))
    nn = torch.where(last, nn.index_select(0, sid),
                     torch.zeros((), dtype=torch.int32, device=dev))
    if fn == "count":
        return nn, nn
    sv = vals.index_select(0, perm)
    if fn == "sum":
        adt = _acc_dtype(sv.dtype)
        contrib = torch.where(live, sv.to(adt), torch.zeros((), dtype=adt,
                                                            device=dev))
        acc = torch.zeros(n, dtype=adt, device=dev).index_add_(0, sid, contrib)
        acc = acc.to(_sum_dtype(sv.dtype))
    elif fn in ("min", "max"):
        fill = max_sentinel(sv.dtype) if fn == "min" else \
            min_sentinel(sv.dtype)
        fill_t = torch.full((), fill, dtype=sv.dtype, device=dev)
        acc = torch.full((n,), fill, dtype=sv.dtype, device=dev).scatter_reduce_(
            0, sid, torch.where(live, sv, fill_t),
            reduce="amin" if fn == "min" else "amax")
    else:
        raise ValueError(fn)
    data = torch.where(last, acc.index_select(0, sid),
                       torch.zeros((), dtype=acc.dtype, device=dev))
    return data, nn


# ---------------------------------------------------------------------
# scalar (no group-by) aggregation — reference's single-state path
# (AggregationOperationState.hpp:223 aggregateBlockSingleState)
# ---------------------------------------------------------------------

def scalar_agg(fn: str, vals: Optional[torch.Tensor],
               valid: Optional[torch.Tensor], alive: torch.Tensor):
    """Returns (result 0-d tensor, non_null_count 0-d int64 tensor)."""
    if _on_cpu(alive):
        return scalar_agg_plain(fn, vals, valid, alive)
    from quickstep_tpu_torch.ops import cuda
    if fn == "count":
        _, count = cuda.masked_reduce("count", None, valid, alive)
        return count, count
    res, count = cuda.masked_reduce("sum" if fn == "avg" else fn, vals, valid,
                                    alive)
    if fn == "avg":
        return res.to(torch.float64) / torch.clamp(count, min=1), count
    return res, count


def scalar_agg_plain(fn: str, vals: Optional[torch.Tensor],
                     valid: Optional[torch.Tensor], alive: torch.Tensor):
    """Plain torch version of scalar_agg."""
    live = alive if valid is None else (alive & valid)
    count = torch.sum(live, dtype=torch.int64)
    if fn == "count":
        return count, count
    dev = vals.device
    if fn in ("sum", "avg"):
        adt = _acc_dtype(vals.dtype)
        s = torch.sum(torch.where(live, vals.to(adt),
                                  torch.zeros((), dtype=adt, device=dev)))
        if fn == "sum":
            return s.to(_sum_dtype(vals.dtype)), count
        return s.to(torch.float64) / torch.clamp(count, min=1), count
    if fn in ("min", "max"):
        fill = max_sentinel(vals.dtype) if fn == "min" else \
            min_sentinel(vals.dtype)
        fill_t = torch.full((), fill, dtype=vals.dtype, device=dev)
        if vals.numel() == 0:
            return fill_t, count
        contrib = torch.where(live, vals, fill_t)
        return (contrib.min() if fn == "min" else contrib.max()), count
    raise ValueError(fn)


# ---------------------------------------------------------------------
# scalar DISTINCT: one sort, then the live run starts (K12)
# ---------------------------------------------------------------------

def _sorted_live(vals: torch.Tensor, valid: Optional[torch.Tensor],
                 alive: torch.Tensor):
    """(the values sorted with the dead and NULL rows as the dtype's max,
    the number of live values): the first n_live sorted entries are the
    live values, as in the reference. On CUDA one K12 radix sort
    (ops/cuda.py radix_sort_live); on the CPU the plain version."""
    if _on_cpu(alive):
        return _sorted_live_plain(vals, valid, alive)
    from quickstep_tpu_torch.ops import cuda
    return cuda.radix_sort_live(
        vals.contiguous(), None if valid is None else valid.contiguous(),
        alive.contiguous())


def _sorted_live_plain(vals: torch.Tensor, valid: Optional[torch.Tensor],
                       alive: torch.Tensor):
    """Plain torch version of _sorted_live: one stable torch.sort. Floats
    sort by a copy in which -0.0 is +0.0 and every NaN the one positive
    NaN, then the values are gathered in that order: the reference's order
    (equal zeros and all NaNs last, each in input order) on any device. On
    the card, torch.sort of the values themselves would put negative NaNs
    before -inf."""
    live = alive if valid is None else (alive & valid)
    v = vals.to(torch.uint8) if vals.dtype == torch.bool else vals
    k = torch.where(live, v, torch.full((), max_sentinel(vals.dtype),
                                        dtype=v.dtype, device=v.device))
    if not k.dtype.is_floating_point:
        return torch.sort(k, stable=True)[0], torch.sum(live,
                                                        dtype=torch.int64)
    order = torch.sort(canonical_sort_key(k), stable=True)[1]
    return k.index_select(0, order), torch.sum(live, dtype=torch.int64)


def distinct_count(vals: torch.Tensor, valid: Optional[torch.Tensor],
                   alive: torch.Tensor) -> torch.Tensor:
    """COUNT(DISTINCT vals) over the live non-NULL rows: a 0-d int64
    tensor. The stable sort of _sorted_live, then the run starts among the
    first n_live sorted values are counted: on CUDA the K12 radix sort and
    one K12 run-start launch, no torch.sort; on the CPU the plain
    version."""
    if _on_cpu(alive):
        return distinct_count_plain(vals, valid, alive)
    from quickstep_tpu_torch.ops import cuda
    s, n_live = _sorted_live(vals, valid, alive)
    return cuda.run_starts(s, n_live, count=True)


def distinct_count_plain(vals: torch.Tensor, valid: Optional[torch.Tensor],
                         alive: torch.Tensor) -> torch.Tensor:
    """Plain torch version of distinct_count."""
    s, n_live = _sorted_live_plain(vals, valid, alive)
    return run_starts_plain(s, n_live).sum(dtype=torch.int64)


def dedup_values(vals: torch.Tensor, valid: Optional[torch.Tensor],
                 alive: torch.Tensor):
    """SUM/AVG/MIN/MAX DISTINCT without GROUP BY: (the sorted values, the
    bool mask of each distinct live value's first sorted row), to be
    aggregated as (values, None, mask). On CUDA the sort is K12's radix
    sort and the mask one K12 launch in its flag mode."""
    if _on_cpu(alive):
        return dedup_values_plain(vals, valid, alive)
    from quickstep_tpu_torch.ops import cuda
    s, n_live = _sorted_live(vals, valid, alive)
    mask = cuda.run_starts(s, n_live, count=False)
    return (s.view(torch.bool) if vals.dtype == torch.bool else s), mask


def dedup_values_plain(vals: torch.Tensor, valid: Optional[torch.Tensor],
                       alive: torch.Tensor):
    """Plain torch version of dedup_values."""
    s, n_live = _sorted_live_plain(vals, valid, alive)
    if vals.dtype == torch.bool:
        s = s.to(torch.bool)
    return s, run_starts_plain(s, n_live)


def run_starts_plain(s: torch.Tensor, n_live: torch.Tensor) -> torch.Tensor:
    """The bool mask i < n_live & (i == 0 | s[i] != s[i - 1])."""
    idx = torch.arange(s.shape[0], device=s.device)
    return ((idx == 0) | (s != torch.roll(s, 1))) & (idx < n_live)
