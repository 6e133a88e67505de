"""LIP filters: the exact bit-vector filter for semi and anti joins and
the one-hash bloom filter of the shuffle join.

Counterparts of quickstep_tpu/ops/bloom.py `exact_filter_build` (:24) and
`exact_filter_probe` (:33), the BitVectorExactFilter analog: one presence
byte per key value in [lo, lo + domain). On CUDA tensors they run K3 in its
presence mode (ops/cuda.py direct_build/direct_probe, csrc/join_kernels.cu);
on CPU tensors the plain versions. `bloom_build` (:41) and `bloom_probe`
(:52), the SingleIdentityHashFilter analog over composite keys: one byte
per slot of a power-of-two table, the slot the low bits of K10's hash. On
CUDA tensors they run K16 (ops/cuda.py bloom_build/bloom_probe,
csrc/shuffle_kernels.cu); on CPU tensors the plain versions.
"""

from __future__ import annotations

from typing import List

import torch

from quickstep_tpu_torch.ops.kernels import hash_keys_plain


def exact_filter_build(key: torch.Tensor, alive: torch.Tensor, lo: int,
                       domain: int) -> torch.Tensor:
    """Presence per key value in [lo, lo + domain): bool[domain]."""
    if key.device.type == "cpu":
        return exact_filter_build_plain(key, alive, lo, domain)
    from quickstep_tpu_torch.ops import cuda
    bits, _ = cuda.direct_build(key.contiguous(), alive.contiguous(), lo,
                                domain, presence=True)
    return bits


def exact_filter_build_plain(key: torch.Tensor, alive: torch.Tensor, lo: int,
                             domain: int) -> torch.Tensor:
    idx = key.to(torch.int64) - lo
    ok = alive & (idx >= 0) & (idx < domain)
    slot = torch.where(ok, idx, torch.full_like(idx, domain))
    bits = torch.zeros(domain + 1, dtype=torch.bool, device=key.device)
    bits[slot] = True
    return bits[:domain]


def exact_filter_probe(bits: torch.Tensor, key: torch.Tensor,
                       alive: torch.Tensor, lo: int) -> torch.Tensor:
    if key.device.type == "cpu":
        return exact_filter_probe_plain(bits, key, alive, lo)
    from quickstep_tpu_torch.ops import cuda
    return cuda.direct_probe(bits, key.contiguous(), alive.contiguous(), lo)


def exact_filter_probe_plain(bits: torch.Tensor, key: torch.Tensor,
                             alive: torch.Tensor, lo: int) -> torch.Tensor:
    domain = bits.shape[0]
    idx = key.to(torch.int64) - lo
    ok = alive & (idx >= 0) & (idx < domain)
    return ok & bits[torch.clamp(idx, 0, domain - 1)]


def bloom_build(key_cols: List[torch.Tensor], alive: torch.Tensor,
                nbits: int) -> torch.Tensor:
    """One-hash bloom over (composite) keys; nbits a power of two:
    bool[nbits], set at the slot of each live row."""
    if alive.device.type == "cpu":
        return bloom_build_plain(key_cols, alive, nbits)
    from quickstep_tpu_torch.ops import cuda
    return cuda.bloom_build([c.contiguous() for c in key_cols],
                            alive.contiguous(), nbits)


def _bloom_slots(key_cols: List[torch.Tensor], nbits: int) -> torch.Tensor:
    return hash_keys_plain(key_cols) & (nbits - 1)


def bloom_build_plain(key_cols: List[torch.Tensor], alive: torch.Tensor,
                      nbits: int) -> torch.Tensor:
    slot = torch.where(alive, _bloom_slots(key_cols, nbits),
                       torch.full((), nbits, dtype=torch.int64,
                                  device=alive.device))
    bits = torch.zeros(nbits + 1, dtype=torch.bool, device=alive.device)
    bits[slot] = True
    return bits[:nbits]


def bloom_probe(bits: torch.Tensor, key_cols: List[torch.Tensor],
                alive: torch.Tensor) -> torch.Tensor:
    """alive & the bit at each row's slot."""
    if alive.device.type == "cpu":
        return bloom_probe_plain(bits, key_cols, alive)
    from quickstep_tpu_torch.ops import cuda
    return cuda.bloom_probe(bits, [c.contiguous() for c in key_cols],
                            alive.contiguous())


def bloom_probe_plain(bits: torch.Tensor, key_cols: List[torch.Tensor],
                      alive: torch.Tensor) -> torch.Tensor:
    return alive & bits[_bloom_slots(key_cols, int(bits.shape[0]))]
