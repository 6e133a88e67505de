"""Window aggregates: the counterpart of quickstep_tpu/ops/window.py.

`window_aggregate` sorts the rows by (live first, partition keys, order
keys): one stable torch.sort of a packed int64 key where the keys' ranges
fit, as PlanRunner._pack_sort_key packs group keys, else one stable sort per
key, last key first. Segment and peer starts are compares of neighbours.
The per-row work then runs in four hand-written CUDA kernels on CUDA tensors
(ops/cuda.py, csrc/window_kernels.cu) and in their plain torch versions on
CPU tensors:

- W1 `segmented_prefix`: the inclusive SUM/MIN/MAX and COUNT of each
  segment read at the last row of each peer group (the reference's
  `_segmented_scan` :75 and `_prefix_to_peers` :239), and in its
  whole-partition mode `segment_totals`, each segment's total
  (`_seg_total` :220);
- W3 `frame_bounds`: each row's ROWS or RANGE frame inside its segment
  (`_lex_searchsorted` :30, the `merge_starts` path :166-196 and
  seg_first/seg_last :147-150);
- W2 `frame_minmax`: MIN/MAX over each row's frame (`_range_query_minmax`
  :50);
- W4 `sliding_sums`: float frame sums in the reference's sliding order, bit
  for bit (`_sliding_float_sums` :273), in the values' own dtype: float32
  is never widened here.

Integer frame sums and frame counts stay prefix differences (a torch.cumsum
and two gathers), exactly as the reference computes them. The plain
versions follow the reference's arithmetic step by step; the tests hold them
against quickstep_tpu, and the kernels against them on the card.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from quickstep_tpu_torch.ops.kernels import (
    canonical_sort_key, max_sentinel, min_sentinel, multi_gather,
    multi_gather_plain)

_DEAD = torch.iinfo(torch.int64).max   # the dead rows' packed sort key
# segments longer than this slide in a scalar loop in the plain W4
_PLAIN_SCALAR_SEGMENT = 4096


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def _roll_ne(t: torch.Tensor) -> torch.Tensor:
    """t[i] != t[i - 1] (row 0 against the last row, as jnp.roll)."""
    return t != torch.roll(t, 1)


# ---------------------------------------------------------------------
# the sort
# ---------------------------------------------------------------------

def _flip(k: torch.Tensor) -> torch.Tensor:
    """A DESC key made ascending: bitwise not for integers and bools,
    negation for floats (window.py:112-115)."""
    return -k if k.dtype.is_floating_point else torch.bitwise_not(k)


def _flip_range(r, k: torch.Tensor):
    if r is None or k.dtype == torch.bool:
        return None
    return (~r[1], ~r[0])


def _pack(keys: Sequence[torch.Tensor], ranges) -> Optional[Tuple]:
    """(packed int64 key, span of each key) when every key is an integer
    with a known range and the spans' product stays below 2^62."""
    if not keys or ranges is None:
        return None
    spans = []
    for k, r in zip(keys, ranges):
        if r is None or k.dtype.is_floating_point or k.dtype == torch.bool:
            return None
        spans.append(r[1] - r[0] + 1)
    if math.prod(spans) >= 2 ** 62:
        return None
    packed = torch.zeros(keys[0].shape, dtype=torch.int64,
                         device=keys[0].device)
    for k, r, span in zip(keys, ranges, spans):
        packed = packed * span + (k.to(torch.int64) - r[0])
    return packed, spans


def _sort_rows(part_keys, okeys, alive, ranges, plain):
    """(perm, s_alive, seg_start, peer_start): the stable permutation that
    puts live rows first, then sorts by partition and order keys; the first
    row of each segment (partition, and the first dead row) and of each peer
    group (equal order keys)."""
    n = alive.shape[0]
    dev = alive.device
    pos = torch.arange(n, device=dev)
    first = pos == 0
    packed = _pack(list(part_keys) + list(okeys), ranges)
    if packed is not None:
        key, spans = packed
        s_key, perm = torch.sort(
            torch.where(alive, key, torch.full((), _DEAD, device=dev)),
            stable=True)
        s_alive = s_key != _DEAD
        order_span = math.prod(spans[len(part_keys):])
        seg = first | _roll_ne(s_key // order_span) | \
            (~s_alive & torch.roll(s_alive, 1))
        return perm, s_alive, seg, seg | _roll_ne(s_key)
    # float keys sort by a canonical copy (-0.0 is 0.0, every NaN the one
    # positive NaN), so equal zeros share a partition or peer group and
    # NaNs sort last on the card as on the CPU
    keys = [k.to(torch.uint8) if k.dtype == torch.bool else
            canonical_sort_key(k) for k in list(part_keys) + list(okeys)]
    # least significant key first; the dead mask last, so that dead rows
    # sort after every live row
    perm = pos
    for k in reversed([(~alive).to(torch.uint8)] + keys):
        _, p = torch.sort(k.index_select(0, perm), stable=True)
        perm = perm.index_select(0, p)
    g = (multi_gather_plain if plain else multi_gather)([alive] + keys, perm,
                                                        random=True)
    s_alive = g[0]
    seg = first | (~s_alive & torch.roll(s_alive, 1))
    for sk in g[1:1 + len(part_keys)]:
        seg = seg | _roll_ne(sk)
    peer = seg
    for sk in g[1 + len(part_keys):]:
        peer = peer | _roll_ne(sk)
    return perm, s_alive, seg, peer


# ---------------------------------------------------------------------
# window_aggregate
# ---------------------------------------------------------------------

def window_aggregate(part_keys: List[torch.Tensor],
                     order_keys: List[torch.Tensor], order_desc: List[bool],
                     fn: str, vals: Optional[torch.Tensor],
                     valid: Optional[torch.Tensor], alive: torch.Tensor,
                     frame: Optional[Tuple[str, Optional[int], Optional[int]]],
                     key_ranges=None):
    """Returns (result aligned with the input rows, result validity or None).

    frame: None for the default, else (mode, start, end): start None is
    UNBOUNDED PRECEDING, else the PRECEDING offset; end None is UNBOUNDED
    FOLLOWING, else the FOLLOWING offset (0 = CURRENT ROW); mode 'rows' or
    'range'. key_ranges: the (lo, hi) range of each partition key, then of
    each order key (before any DESC flip), or None where unknown; with every
    range known the sort is one packed key. On CUDA the per-row work runs in
    W1-W4; on the CPU their plain versions run."""
    return _window_aggregate(part_keys, order_keys, order_desc, fn, vals,
                             valid, alive, frame, key_ranges,
                             plain=_on_cpu(alive))


def window_aggregate_plain(part_keys, order_keys, order_desc, fn, vals, valid,
                           alive, frame, key_ranges=None):
    """window_aggregate with the plain versions of W1-W4, on any device."""
    return _window_aggregate(part_keys, order_keys, order_desc, fn, vals,
                             valid, alive, frame, key_ranges, plain=True)


def _window_aggregate(part_keys, order_keys, order_desc, fn, vals, valid,
                      alive, frame, key_ranges, plain):
    n = alive.shape[0]
    dev = alive.device
    part_keys = [k.contiguous() for k in part_keys]
    okeys = [(_flip(k) if desc else k).contiguous()
             for k, desc in zip(order_keys, order_desc)]
    ranges = None
    if key_ranges is not None:
        ranges = list(key_ranges[:len(part_keys)]) + [
            _flip_range(r, k) if desc else r for r, k, desc in zip(
                key_ranges[len(part_keys):], order_keys, order_desc)]
    perm, s_alive, seg_start, peer_start = _sort_rows(part_keys, okeys, alive,
                                                      ranges, plain)
    need_key = frame is not None and frame[0] == "range" and \
        (frame[1] is not None or frame[2] is not None) and \
        not (frame[1] is None and frame[2] == 0)
    g = (multi_gather_plain if plain else multi_gather)(
        [vals, valid, okeys[0] if need_key else None], perm, random=True)
    s_vals, s_valid, s_key = g
    if s_vals is None:
        s_vals = torch.ones(n, dtype=torch.int64, device=dev)
    live = s_alive if s_valid is None else (s_alive & s_valid)
    contrib_sum = torch.where(live, s_vals,
                              torch.zeros((), dtype=s_vals.dtype, device=dev))

    if not order_keys and frame is None:
        # whole-partition aggregate broadcast to every row
        res, nn = (_seg_total_plain if plain else _seg_total)(
            fn, contrib_sum, live, s_vals, seg_start)
    elif frame is None or (frame[0] == "range" and frame[1] is None and
                           frame[2] == 0):
        # RANGE UNBOUNDED..CURRENT: the prefix at the last peer row
        res, nn = (_prefix_to_peers_plain if plain else _prefix_to_peers)(
            fn, contrib_sum, live, s_vals, seg_start, peer_start)
    elif frame[0] in ("rows", "range"):
        mode = frame[0] if need_key else "rows"
        lo, hi = (frame_bounds_plain if plain else frame_bounds)(
            seg_start, mode, frame[1], frame[2], s_key)
        # dead rows (sorted last, their keys in any order) get empty frames:
        # no one reads their results, and W2/W4 then do no work for them;
        # each is its own segment for W4, whose walks are then all short
        pos = torch.arange(n, dtype=torch.int32, device=dev)
        lo = torch.where(s_alive, lo, pos)
        hi = torch.where(s_alive, hi, pos - 1)
        res, nn = (_eval_frame_plain if plain else _eval_frame)(
            fn, contrib_sum, live, s_vals, lo, hi, seg_start | ~s_alive)
    else:
        raise NotImplementedError(f"window frame {frame}")

    # scatter back to the input's row order
    res = torch.empty_like(res).index_copy_(0, perm, res)
    if fn == "count":
        return res, None
    nn = torch.empty_like(nn).index_copy_(0, perm, nn)
    return res, nn > 0


# ---------------------------------------------------------------------
# the three evaluation paths (window.py :220, :239, :315)
# ---------------------------------------------------------------------

def _sentinel_fill(fn, s_vals, live):
    sent = max_sentinel(s_vals.dtype) if fn == "min" else \
        min_sentinel(s_vals.dtype)
    return torch.where(live, s_vals, torch.full((), sent, dtype=s_vals.dtype,
                                                device=s_vals.device))


def _finish(fn, res, cnt):
    if fn == "count":
        return cnt, cnt
    if fn == "avg":
        return res.to(torch.float64) / torch.clamp(cnt, min=1), cnt
    return res, cnt


def _seg_total(fn, contrib_sum, live, s_vals, seg_start):
    """Whole-partition aggregates: on CUDA one W1 call in its
    whole-partition mode (segment_totals); on the CPU `_seg_total_plain`."""
    if _on_cpu(live):
        return _seg_total_plain(fn, contrib_sum, live, s_vals, seg_start)
    return _prefix_to_peers_impl(fn, contrib_sum, live, s_vals, seg_start,
                                 None, plain=False)


def _seg_total_plain(fn, contrib_sum, live, s_vals, seg_start):
    """window.py:220: segment sums, counts, minima and maxima by scatter
    (index_add_, scatter_reduce_), gathered back to every row."""
    n = live.shape[0]
    dev = live.device
    seg_ids = torch.cumsum(seg_start.to(torch.int64), 0) - 1
    cnts = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
        0, seg_ids, live.to(torch.int64)).index_select(0, seg_ids)
    if fn == "count":
        return cnts, cnts
    if fn in ("sum", "avg"):
        sums = torch.zeros(n, dtype=contrib_sum.dtype, device=dev).index_add_(
            0, seg_ids, contrib_sum).index_select(0, seg_ids)
        return _finish(fn, sums, cnts)
    c = _sentinel_fill(fn, s_vals, live)
    m = torch.full((n,), max_sentinel(c.dtype) if fn == "min" else
                   min_sentinel(c.dtype), dtype=c.dtype,
                   device=dev).scatter_reduce_(
        0, seg_ids, c, reduce="amin" if fn == "min" else "amax")
    return m.index_select(0, seg_ids), cnts


def _prefix_to_peers(fn, contrib_sum, live, s_vals, seg_start, peer_start):
    """RANGE UNBOUNDED PRECEDING..CURRENT ROW: W1 on CUDA, its plain
    version (`_prefix_to_peers_plain`) on the CPU."""
    return _prefix_to_peers_impl(fn, contrib_sum, live, s_vals, seg_start,
                                 peer_start, plain=_on_cpu(live))


def _prefix_to_peers_plain(fn, contrib_sum, live, s_vals, seg_start,
                           peer_start):
    return _prefix_to_peers_impl(fn, contrib_sum, live, s_vals, seg_start,
                                 peer_start, plain=True)


def _prefix_to_peers_impl(fn, contrib_sum, live, s_vals, seg_start,
                          peer_start, plain):
    """peer_start None is the whole-partition mode (segment_totals)."""
    kfn = "sum" if fn == "avg" else fn
    vals = None if fn == "count" else (
        contrib_sum if kfn == "sum" else _sentinel_fill(kfn, s_vals, live))
    if peer_start is None:
        res, cnt = segment_totals(kfn, vals, live, seg_start)
    else:
        res, cnt = (segmented_prefix_plain if plain else segmented_prefix)(
            kfn, vals, live, seg_start, peer_start)
    return _finish(fn, res, cnt)


def _rangesum(p: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    """p[hi] - p[lo - 1] (0 below row 0, and 0 for an empty frame), from an
    inclusive prefix p."""
    lo64, hi64 = lo.to(torch.int64), hi.to(torch.int64)
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    total = p.index_select(0, torch.clamp(hi64, min=0))
    below = torch.where(lo64 > 0,
                        p.index_select(0, torch.clamp(lo64 - 1, min=0)), zero)
    return torch.where(hi64 < lo64, zero, total - below)


def _eval_frame(fn, contrib_sum, live, s_vals, lo, hi, is_start):
    """Aggregates over each row's frame [lo, hi] (inside its segment): W2
    for MIN/MAX and W4 for float sums on CUDA; integer sums and counts are
    prefix differences. `_eval_frame_plain` on the CPU."""
    return _eval_frame_impl(fn, contrib_sum, live, s_vals, lo, hi, is_start,
                            plain=_on_cpu(live))


def _eval_frame_plain(fn, contrib_sum, live, s_vals, lo, hi, is_start):
    return _eval_frame_impl(fn, contrib_sum, live, s_vals, lo, hi, is_start,
                            plain=True)


def _eval_frame_impl(fn, contrib_sum, live, s_vals, lo, hi, is_start, plain):
    cnt = _rangesum(torch.cumsum(live.to(torch.int64), 0), lo, hi)
    if fn in ("min", "max"):
        c = _sentinel_fill(fn, s_vals, live)
        return (frame_minmax_plain if plain else frame_minmax)(
            fn, c, lo, hi), cnt
    if fn == "count":
        return cnt, cnt
    if contrib_sum.dtype.is_floating_point:
        s = (sliding_sums_plain if plain else sliding_sums)(
            contrib_sum, lo, hi, is_start)
    else:
        s = _rangesum(torch.cumsum(contrib_sum, 0), lo, hi).to(
            contrib_sum.dtype)
    return _finish(fn, s, cnt)


# ---------------------------------------------------------------------
# W1: segmented prefix read at the end of each peer group
# ---------------------------------------------------------------------

def segmented_prefix(fn: str, vals: Optional[torch.Tensor],
                     live: torch.Tensor, seg_start: torch.Tensor,
                     peer_start: torch.Tensor):
    """Each sorted row's inclusive fn (sum, min or max of the contributions
    vals; None for count) and count of live rows within its segment, at the
    last row of its peer group. Returns (values in vals' dtype or None,
    int64 counts). W1 on CUDA, its plain version on the CPU."""
    if _on_cpu(live):
        return segmented_prefix_plain(fn, vals, live, seg_start, peer_start)
    from quickstep_tpu_torch.ops import cuda
    return cuda.window_prefix(fn, None if vals is None else vals.contiguous(),
                              live.contiguous(), seg_start.contiguous(),
                              peer_start.contiguous())


def segment_totals(fn: str, vals: Optional[torch.Tensor],
                   live: torch.Tensor, seg_start: torch.Tensor):
    """Each sorted row's segment total: fn (sum, min or max of the
    contributions vals; None for count) and the count of live rows over its
    whole segment. Returns (values in vals' dtype or None, int64 counts).
    On CUDA W1 in its whole-partition mode; on the CPU segmented_prefix's
    plain version with the peer groups equal to the segments."""
    if _on_cpu(live):
        return segmented_prefix_plain(fn, vals, live, seg_start, seg_start)
    from quickstep_tpu_torch.ops import cuda
    return cuda.window_prefix(fn, None if vals is None else vals.contiguous(),
                              live.contiguous(), seg_start.contiguous(), None)


def _segmented_scan_plain(vals, seg_start, fn):
    """window.py:75: inclusive segmented scan. Sums are the whole-array
    cumsum minus the prefix at each segment's start row; MIN/MAX a doubling
    (Hillis-Steele) segmented scan, exact like the reference's sparse
    table."""
    n = vals.shape[0]
    dev = vals.device
    if fn == "sum":
        idx = torch.arange(n, device=dev)
        start_row = torch.cummax(torch.where(seg_start, idx,
                                             torch.full_like(idx, -1)), 0)[0]
        S = torch.cumsum(vals, 0)
        base = torch.where(start_row <= 0,
                           torch.zeros((), dtype=S.dtype, device=dev),
                           S.index_select(0, torch.clamp(start_row - 1,
                                                         min=0)))
        return (S - base).to(vals.dtype)
    op = torch.minimum if fn == "min" else torch.maximum
    ident = max_sentinel(vals.dtype) if fn == "min" else \
        min_sentinel(vals.dtype)
    v, f = vals, seg_start
    d = 1
    while d < n:
        pv = torch.cat([torch.full((d,), ident, dtype=v.dtype, device=dev),
                        v[:-d]])
        pf = torch.cat([torch.zeros(d, dtype=torch.bool, device=dev), f[:-d]])
        v = torch.where(f, v, op(pv, v))
        f = f | pf
        d *= 2
    return v


def segmented_prefix_plain(fn, vals, live, seg_start, peer_start):
    """window.py:239 _prefix_to_peers: the segmented scans, then each peer
    group's last row (a scatter max of the row index) read by every row."""
    n = live.shape[0]
    dev = live.device
    idx = torch.arange(n, device=dev)
    pcnt = _segmented_scan_plain(live.to(torch.int64), seg_start, "sum")
    psum = None if fn == "count" else _segmented_scan_plain(vals, seg_start,
                                                            fn)
    peer_ids = torch.cumsum(peer_start.to(torch.int64), 0) - 1
    last = torch.zeros(n, dtype=torch.int64, device=dev).scatter_reduce_(
        0, peer_ids, idx, reduce="amax")
    take = last.index_select(0, peer_ids)
    return (None if psum is None else psum.index_select(0, take),
            pcnt.index_select(0, take))


# ---------------------------------------------------------------------
# W3: frame bounds
# ---------------------------------------------------------------------

def frame_bounds(seg_start: torch.Tensor, mode: str, start: Optional[int],
                 end: Optional[int], keys: Optional[torch.Tensor] = None):
    """(lo, hi), int32: each sorted row's ROWS or RANGE frame inside its
    segment (see ops/cuda.py frame_bounds). W3 on CUDA, its plain version on
    the CPU."""
    if _on_cpu(seg_start):
        return frame_bounds_plain(seg_start, mode, start, end, keys)
    from quickstep_tpu_torch.ops import cuda
    return cuda.frame_bounds(seg_start.contiguous(), mode, start, end,
                             None if keys is None else keys.contiguous())


def _lex_searchsorted(seg, val, qseg, qval, side: str):
    """window.py:30: binary search for (qseg, qval) in rows sorted by
    (segment, value). Its fixed number of rounds can step past n once lo
    has reached n (the last row matches, mid = n reads row n - 1); the
    reference's later gathers clamp that index, and the result is clamped
    to n here, where W2 and W4 read rows up to hi."""
    n = seg.shape[0]
    lo = torch.zeros(qseg.shape, dtype=torch.int64, device=seg.device)
    hi = torch.full(qseg.shape, n, dtype=torch.int64, device=seg.device)
    for _ in range(max(1, math.ceil(math.log2(max(n, 2))) + 1)):
        mid = (lo + hi) // 2
        safe = torch.clamp(mid, max=n - 1)
        ms = seg.index_select(0, safe)
        mv = val.index_select(0, safe)
        if side == "left":
            go_right = (ms < qseg) | ((ms == qseg) & (mv < qval))
        else:
            go_right = (ms < qseg) | ((ms == qseg) & (mv <= qval))
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    return torch.clamp(lo, max=n)


def frame_bounds_plain(seg_start, mode, start, end, keys=None):
    """window.py:146-204: seg_first/seg_last by scatter min/max, ROWS
    clamps, RANGE bounds by the lexicographic binary search (integer keys
    compared in int64, float keys offset in their own dtype)."""
    n = seg_start.shape[0]
    dev = seg_start.device
    idx = torch.arange(n, device=dev)
    seg_ids = torch.cumsum(seg_start.to(torch.int64), 0) - 1
    seg_first = torch.full((n,), n, dtype=torch.int64,
                           device=dev).scatter_reduce_(
        0, seg_ids, idx, reduce="amin").index_select(0, seg_ids)
    seg_last = torch.zeros(n, dtype=torch.int64, device=dev).scatter_reduce_(
        0, seg_ids, idx, reduce="amax").index_select(0, seg_ids)
    if mode == "rows":
        lo = seg_first if start is None else torch.maximum(seg_first,
                                                           idx - start)
        hi = seg_last if end is None else torch.minimum(seg_last, idx + end)
    else:
        sv = keys if keys.dtype.is_floating_point else keys.to(torch.int64)
        lo = seg_first if start is None else _lex_searchsorted(
            seg_ids, sv, seg_ids, sv - start, "left")
        hi = seg_last if end is None else _lex_searchsorted(
            seg_ids, sv, seg_ids, sv + end, "right") - 1
    hi = torch.maximum(hi, lo - 1)                 # empty window
    return lo.to(torch.int32), hi.to(torch.int32)


# ---------------------------------------------------------------------
# W2: MIN/MAX over [lo, hi]
# ---------------------------------------------------------------------

def frame_minmax(fn: str, c: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor) -> torch.Tensor:
    """MIN or MAX of c over each row's [lo, hi], the sentinel where empty.
    W2 on CUDA, its plain version on the CPU."""
    if _on_cpu(c):
        return frame_minmax_plain(fn, c, lo, hi)
    from quickstep_tpu_torch.ops import cuda
    return cuda.frame_minmax(fn, c.contiguous(), lo.contiguous(),
                             hi.contiguous())


def frame_minmax_plain(fn, c, lo, hi):
    """window.py:50 _range_query_minmax: the doubling sparse table, with
    only the levels that the longest frame reads (the reference builds
    ceil(log2 n) + 1 of them; the answers are the same)."""
    n = c.shape[0]
    dev = c.device
    is_min = fn == "min"
    sent = max_sentinel(c.dtype) if is_min else min_sentinel(c.dtype)
    op = torch.minimum if is_min else torch.maximum
    if n == 0:
        return c.clone()
    lo64, hi64 = lo.to(torch.int64), hi.to(torch.int64)
    length = torch.clamp(hi64 - lo64 + 1, min=1)
    longest = int(length.max())
    levels = [c]
    k = 1
    while 2 * k <= longest:
        prev = levels[-1]
        pad = torch.full((min(k, n),), sent, dtype=c.dtype, device=dev)
        levels.append(op(prev, torch.cat([prev[k:], pad])[:n]))
        k *= 2
    table = torch.stack(levels)
    j = torch.floor(torch.log2(length.to(torch.float64))).to(torch.int64)
    a = table[j, torch.clamp(lo64, 0, n - 1)]
    b = table[j, torch.clamp(hi64 - (1 << j) + 1, 0, n - 1)]
    return torch.where(hi64 < lo64, torch.full((), sent, dtype=c.dtype,
                                               device=dev), op(a, b))


# ---------------------------------------------------------------------
# W4: sliding float frame sums
# ---------------------------------------------------------------------

def sliding_sums(contrib: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                 is_start: torch.Tensor) -> torch.Tensor:
    """Float frame sums with the reference's exact rounding, in contrib's
    dtype. W4 on CUDA, its plain version on the CPU."""
    if _on_cpu(contrib):
        return sliding_sums_plain(contrib, lo, hi, is_start)
    from quickstep_tpu_torch.ops import cuda
    return cuda.sliding_sum(contrib.contiguous(), lo.contiguous(),
                            hi.contiguous(), is_start.contiguous())


def sliding_sums_plain(contrib, lo, hi, is_start):
    """window.py:273 _sliding_float_sums, step for step: on each row of a
    segment the running sum (0 at the segment's first row) first loses the
    rows from the previous lo to this lo - 1, then gains those from
    max(previous end, lo) to this end - 1, one rounding per row in index
    order. Segments advance together, one row position per step (masked
    vector ops); segments longer than _PLAIN_SCALAR_SEGMENT rows slide in a
    scalar loop with the dtype's own arithmetic."""
    n = contrib.shape[0]
    dev = contrib.device
    out = torch.empty_like(contrib)
    if n == 0:
        return out
    lo64, end64 = lo.to(torch.int64), hi.to(torch.int64) + 1
    starts = torch.nonzero(is_start | (torch.arange(n, device=dev) == 0)
                           ).flatten()
    lens = torch.diff(starts, append=torch.tensor([n], device=dev))
    long_seg = lens > _PLAIN_SCALAR_SEGMENT
    prev_lo = torch.cat([lo64[:1], lo64[:-1]])
    prev_end = torch.cat([lo64[:1], end64[:-1]])
    max_sub = int(torch.clamp(lo64 - prev_lo, min=0).max())
    max_add = int(torch.clamp(end64 - torch.minimum(prev_end, end64),
                              min=0).max())
    st, ln = starts[~long_seg], lens[~long_seg]
    if len(st):
        s = torch.zeros(len(st), dtype=contrib.dtype, device=dev)
        for k in range(int(ln.max())):
            act = ln > k
            r = torch.clamp(st + k, max=n - 1)
            lo_r, end_r = lo64[r], end64[r]
            plo = lo_r if k == 0 else prev_lo[r]
            pend = lo_r if k == 0 else prev_end[r]
            for kk in range(max_sub):
                j = plo + kk
                v = contrib[torch.clamp(j, 0, n - 1)]
                s = torch.where(act & (j < lo_r), s - v, s)
            for kk in range(max_add):
                j = pend + kk
                v = contrib[torch.clamp(j, 0, n - 1)]
                s = torch.where(act & (j >= lo_r) & (j < end_r), s + v, s)
            out[r[act]] = s[act]
    if bool(long_seg.any()):
        c = contrib.cpu().numpy()
        los, ends = lo64.cpu().tolist(), end64.cpu().tolist()
        host = out.cpu().numpy()
        if c.dtype == np.float64:
            c = c.tolist()          # Python floats: IEEE double arithmetic
        zero = contrib.new_zeros(()).cpu().numpy()[()]
        for s0, m in zip(starts[long_seg].tolist(), lens[long_seg].tolist()):
            s, plo, pend = zero, los[s0], los[s0]
            for r in range(s0, s0 + m):
                lo_r, end_r = los[r], ends[r]
                for j in range(plo, lo_r):
                    s = s - c[j]
                for j in range(max(pend, lo_r), end_r):
                    s = s + c[j]
                host[r] = s
                plo, pend = lo_r, end_r
        out = torch.from_numpy(host).to(dev)
    return out
