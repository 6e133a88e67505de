"""ORDER BY below the root: the stable permutation of a sort.

Counterpart of quickstep_tpu/ops/sort.py `order_permutation` (:21). Each
key is mapped to an order-preserving int64 (DESC by negation or bitwise
not, NULLs to the sentinel NULLS FIRST/LAST asks for, floats through the
sign-flip bit trick with -0.0 equal to 0.0 and NaN after +inf, as
jnp.lexsort orders them), then one stable torch.sort per key, last key
first, and the dead rows sort after every live row. On CUDA each key's
encoding, read at the current permutation, is one K13 launch (ops/cuda.py
sort_key_encode); on the CPU the plain version runs. The sorts stay torch
ops, as in the sort group-by.
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
    """Plain torch version of one key's K13 encoding: the reference's DESC
    and NULL transforms, then an order-preserving int64."""
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

    def encode(k, v, asc, nf, perm):
        return cuda.sort_key_encode(k.contiguous(), None if v is None
                                    else v.contiguous(), asc, nf, perm)
    return _chained_sort(keys, valids, ascending, nulls_first, alive, encode)


def order_permutation_plain(keys, valids, ascending, nulls_first, alive):
    """Plain torch version of order_permutation."""
    def encode(k, v, asc, nf, perm):
        return encode_key(k, v, asc, nf).index_select(0, perm)
    return _chained_sort(keys, valids, ascending, nulls_first, alive, encode)


def _chained_sort(keys, valids, ascending, nulls_first, alive, encode):
    """One stable sort per key, least significant first, each key encoded
    at the current permutation; the live mask last."""
    perm = torch.arange(alive.shape[0], device=alive.device)
    for k, v, asc, nf in reversed(list(zip(keys, valids, ascending,
                                           nulls_first))):
        _, p = torch.sort(encode(k, v, asc, nf, perm), stable=True)
        perm = perm.index_select(0, p)
    _, p = torch.sort((~alive).index_select(0, perm).to(torch.uint8),
                      stable=True)
    return perm.index_select(0, p)
