"""LIP filters: the exact bit-vector filter for semi and anti joins.

Counterparts of quickstep_tpu/ops/bloom.py `exact_filter_build` (:24) and
`exact_filter_probe` (:33), the BitVectorExactFilter analog: one presence
byte per key value in [lo, lo + domain). On CUDA tensors they run K3 in its
presence mode (ops/cuda.py direct_build/direct_probe, csrc/join_kernels.cu);
on CPU tensors the plain versions. The hashed bloom filters wait for the
hashed joins.
"""

from __future__ import annotations

import torch


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
