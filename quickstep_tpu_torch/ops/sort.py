"""ORDER BY below the root: the stable permutation of a sort.

Counterpart of quickstep_tpu/ops/sort.py `order_permutation` (:21). The
plain version maps each key to an order-preserving int64 (DESC by negation
or bitwise not, NULLs to the sentinel NULLS FIRST/LAST asks, floats through
the sign-flip bit trick with -0.0 equal to 0.0 and NaN after +inf, as
jnp.lexsort orders them), then runs one stable torch.sort per key, last key
first, and the dead rows sort after every live row. On CUDA the whole chain
is one K13 call (ops/cuda.py order_permutation): hand-written key-value
radix sorts over each key's range-compressed codes carrying int32 row ids,
with no library sort; on the CPU the plain version runs.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from quickstep_tpu_torch.ops.kernels import max_sentinel, min_sentinel

_INT64_MAX = (1 << 63) - 1


def _float_bits(col: torch.Tensor) -> torch.Tensor:
    """An int64 whose order is the float order of col: -0.0 and 0.0 map to
    0, every NaN to INT64_MAX, negative floats to their bits with the
    magnitude bits flipped."""
    if col.dtype == torch.float32:
        bits = col.view(torch.int32).to(torch.int64)
        flip = (1 << 31) - 1
    else:
        bits = col.view(torch.int64)
        flip = _INT64_MAX
    enc = torch.where(bits < 0, bits ^ flip, bits)
    enc = torch.where(col == 0, torch.zeros_like(enc), enc)
    return torch.where(torch.isnan(col), torch.full_like(enc, _INT64_MAX),
                       enc)


def encode_key(col: torch.Tensor, valid: Optional[torch.Tensor], asc: bool,
               nulls_first: Optional[bool]) -> torch.Tensor:
    """One key of the plain version: the reference's DESC and NULL
    transforms, then an order-preserving int64."""
    if not asc:
        if col.dtype.is_floating_point:
            col = -col
        elif col.dtype == torch.bool:
            col = ~col
        else:
            # bitwise not decreases monotonically and has no overflow at
            # the minimum, unlike negation
            col = ~col
    if valid is not None:
        # SQL default: NULLS LAST for ASC, NULLS FIRST for DESC
        first = nulls_first if nulls_first is not None else (not asc)
        sent = min_sentinel(col.dtype) if first else max_sentinel(col.dtype)
        col = torch.where(valid, col, torch.full((), sent, dtype=col.dtype,
                                                 device=col.device))
    if col.dtype.is_floating_point:
        return _float_bits(col)
    return col.to(torch.int64)


def order_permutation(keys: List[torch.Tensor],
                      valids: List[Optional[torch.Tensor]],
                      ascending: List[bool],
                      nulls_first: List[Optional[bool]],
                      alive: torch.Tensor) -> torch.Tensor:
    """Stable int64 permutation sorting the live rows by the keys (keys[0]
    primary), the dead rows after them; ties keep row order."""
    if alive.device.type == "cpu":
        return order_permutation_plain(keys, valids, ascending, nulls_first,
                                       alive)
    from quickstep_tpu_torch.ops import cuda
    return cuda.order_permutation(
        [k.contiguous() for k in keys],
        [None if v is None else v.contiguous() for v in valids],
        list(ascending), list(nulls_first), alive.contiguous())


def order_permutation_plain(keys, valids, ascending, nulls_first, alive):
    """Plain torch version of order_permutation: one stable sort per key,
    least significant first, each key encoded at the current permutation;
    the live mask last."""
    perm = torch.arange(alive.shape[0], device=alive.device)
    for k, v, asc, nf in reversed(list(zip(keys, valids, ascending,
                                           nulls_first))):
        enc = encode_key(k, v, asc, nf).index_select(0, perm)
        _, p = torch.sort(enc, stable=True)
        perm = perm.index_select(0, p)
    _, p = torch.sort((~alive).index_select(0, perm).to(torch.uint8),
                      stable=True)
    return perm.index_select(0, p)
