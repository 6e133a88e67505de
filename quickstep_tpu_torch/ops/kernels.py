"""Core vectorized building blocks: row masks, compaction order, sentinels,
the stable partition, the bucket scatter, the many-column gather and key
hashing.

The subset of quickstep_tpu/ops/kernels.py that the port needs.
`multi_gather` launches the hand-written K6 kernel, `stable_partition` the
K9 kernel, `hash_keys` the K10 kernel and `scatter_compact` the K15 kernel
on CUDA tensors, and each takes its plain version on CPU tensors; the other
functions are single torch ops on whatever device their input lies on. The
reference's TPU lane packing (`_lane_dtype`, `PACK_PAD_LIMIT`) is not
carried over: a Hopper gather reads each column at its own width.

Hashes are uint64 bit patterns held in int64 tensors (torch has no uint64
arithmetic): products wrap modulo 2^64, right shifts are logical (an
arithmetic shift, masked), and constants at or above 2^63 are written as
the negative int64 with the same bits.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype(dt) -> torch.dtype:
    """The torch dtype of a numpy dtype (the SQL types' `device_dtype`)."""
    if isinstance(dt, torch.dtype):
        return dt
    return _TORCH_DTYPES[np.dtype(dt)]


def alive_mask(capacity: int, count: int, device) -> torch.Tensor:
    """Rows [0, count) of a padded array are live."""
    if count >= capacity:
        # unpadded (a table scan): a fill, not an int64 arange to compare
        return torch.ones(capacity, dtype=torch.bool, device=device)
    return torch.arange(capacity, device=device) < count


def compact_order(alive: torch.Tensor) -> torch.Tensor:
    """Stable permutation putting live rows first."""
    return torch.argsort((~alive).to(torch.int8), stable=True)


def stable_partition(mask: torch.Tensor, limit: Optional[int] = None,
                     with_mask: bool = False):
    """compact_order's function (quickstep_tpu/ops/kernels.py:132, with the
    destinations of :35 compact_indices): the int64 positions of the rows
    where mask holds, in order, then the others, in order; with `limit`,
    only the first `limit` of them (compact_order(mask)[:limit]). with_mask
    returns (that order, mask[order]). On CUDA one K9 call (ops/cuda.py
    stable_partition), which writes only those; compact_order, a stable
    sort, is its plain version and runs on the CPU."""
    if mask.device.type == "cpu":
        order = compact_order(mask)
        if limit is not None:
            order = order[:limit]
        return (order, mask[order]) if with_mask else order
    from quickstep_tpu_torch.ops import cuda
    return cuda.stable_partition(mask.contiguous(), limit, with_mask)


def scatter_compact(col: torch.Tensor, dest: torch.Tensor, capacity: int,
                    fill=0) -> torch.Tensor:
    """quickstep_tpu/ops/kernels.py:44: out[dest[i]] = col[i] into a
    tensor of `capacity` filled with `fill`; a dest outside [0, capacity)
    (the callers use capacity) drops its row. Destinations are unique. On
    CUDA one K15 call (ops/cuda.py scatter_compact); on the CPU the plain
    version."""
    if dest.device.type == "cpu":
        return scatter_compact_plain(col, dest, capacity, fill)
    from quickstep_tpu_torch.ops import cuda
    return cuda.scatter_compact(col.contiguous(), dest.contiguous(),
                                capacity, fill)


def scatter_compact_plain(col: torch.Tensor, dest: torch.Tensor,
                          capacity: int, fill=0) -> torch.Tensor:
    """Plain torch version of scatter_compact: one index_put into
    capacity + 1 slots, the last of which takes the dropped rows."""
    d = dest.to(torch.int64)
    slot = torch.where((d >= 0) & (d < capacity), d,
                       torch.full_like(d, capacity))
    out = torch.full((capacity + 1,), fill, dtype=col.dtype,
                     device=col.device)
    out[slot] = col
    return out[:capacity]


def to_device(arr: np.ndarray, device) -> torch.Tensor:
    """A host array on `device`. A CUDA copy goes through pinned memory
    without blocking, so a query's literal tables (LIKE bitmaps, remaps)
    cost no host synchronisation."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    device = torch.device(device)
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def multi_gather(cols: List[Optional[torch.Tensor]], idx: torch.Tensor,
                 random: bool = False):
    """Gather many equal-length columns by one index vector (int32 or int64,
    in range: callers clip). None entries pass through. On CUDA one K6
    launch gathers every column (ops/cuda.py multi_gather); on the CPU the
    plain version runs. A caller whose index is a permutation or random (a
    sort permutation, not a nearly ascending compaction) says so with
    random, which lets K6 take its row-packed route where its cost model
    favours it."""
    if idx.device.type == "cpu":
        return multi_gather_plain(cols, idx)
    from quickstep_tpu_torch.ops import cuda
    out = list(cols)
    todo = []
    for i, c in enumerate(cols):
        if c is None:
            continue
        if c.dim() == 1 and c.shape[0] > 0 and c.stride(0) == 0:
            # a broadcast literal gathers to itself
            out[i] = c[:1].expand(idx.shape[0])
        else:
            todo.append(i)
    if todo:
        got = cuda.multi_gather([cols[i].contiguous() for i in todo],
                                idx.contiguous(), random)
        for i, g in zip(todo, got):
            out[i] = g
    return out


def multi_gather_plain(cols: List[Optional[torch.Tensor]], idx: torch.Tensor,
                       random: bool = False):
    """Plain torch version of multi_gather (both of K6's routes): one
    index_select per column. A column of zero rows gathers to zeros of the
    index's length (the caller marks those rows invalid)."""
    return [None if c is None else
            torch.zeros(idx.shape[0], dtype=c.dtype, device=c.device)
            if c.shape[0] == 0 else c.index_select(0, idx) for c in cols]


# SplitMix64's constants (quickstep_tpu/ops/kernels.py:143-160), as int64
_MIX1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_MIX2 = 0x94D049BB133111EB - (1 << 64)
_GOLDEN = 0x9E3779B97F4A7C15 - (1 << 64)


def _shr(h: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (h >> s) & ((1 << (64 - s)) - 1)


def hash64(x: torch.Tensor) -> torch.Tensor:
    """The SplitMix64 finalizer of quickstep_tpu/ops/kernels.py:143 over
    x's int64 value, as int64 bits."""
    h = x.to(torch.int64)
    h = (h ^ _shr(h, 30)) * _MIX1
    h = (h ^ _shr(h, 27)) * _MIX2
    return h ^ _shr(h, 31)


def hash_combine(hs: List[torch.Tensor]) -> torch.Tensor:
    """quickstep_tpu/ops/kernels.py:154 over int64 bits (out << 6 as a
    wrapping product by 64)."""
    out = hs[0]
    for h in hs[1:]:
        out = out ^ (h + _GOLDEN + out * 64 + _shr(out, 2))
    return out


def hash_keys(cols: List[torch.Tensor]) -> torch.Tensor:
    """hash_combine of hash64 of each key column's int64 value (other
    dtypes than int32 and int64 are cast first, floats truncating, as the
    reference's astype(int64)): one int64 per row. On CUDA one K10 launch
    (ops/cuda.py hash_keys, at most 16 columns); on the CPU the plain
    version runs."""
    if cols[0].device.type == "cpu":
        return hash_keys_plain(cols)
    from quickstep_tpu_torch.ops import cuda
    return cuda.hash_keys([
        (c if c.dtype in (torch.int32, torch.int64)
         else c.to(torch.int64)).contiguous() for c in cols])


def hash_keys_plain(cols: List[torch.Tensor]) -> torch.Tensor:
    """Plain torch version of hash_keys."""
    return hash_combine([hash64(c) for c in cols])


def next_pow2(n: int) -> int:
    n = max(int(n), 1)
    p = 1
    while p < n:
        p <<= 1
    return p


def round_up(n: int, m: int) -> int:
    return ((int(n) + m - 1) // m) * m


_MAX_SENTINELS = {
    torch.int32: int(np.iinfo(np.int32).max),
    torch.int64: int(np.iinfo(np.int64).max),
    torch.float32: float("inf"),
    torch.float64: float("inf"),
    torch.bool: True,
}
_MIN_SENTINELS = {
    torch.int32: int(np.iinfo(np.int32).min),
    torch.int64: int(np.iinfo(np.int64).min),
    torch.float32: float("-inf"),
    torch.float64: float("-inf"),
    torch.bool: False,
}


def max_sentinel(dtype) -> object:
    return _MAX_SENTINELS[torch_dtype(dtype)]


def min_sentinel(dtype) -> object:
    return _MIN_SENTINELS[torch_dtype(dtype)]


def canonical_sort_key(t: torch.Tensor) -> torch.Tensor:
    """A float sort key as lax.sort compares it: a copy in which -0.0 is
    +0.0 and every NaN the one positive NaN, so that a stable torch.sort
    keeps equal zeros in row order and puts every NaN last on any device
    (the card's torch.sort orders floats by their bits: a negative NaN
    before -inf). Only the sort key is canonical; other dtypes are returned
    as they are."""
    if not t.dtype.is_floating_point:
        return t
    nan = torch.full((), float("nan"), dtype=t.dtype, device=t.device)
    return torch.where(torch.isnan(t), nan, t + 0.0)
