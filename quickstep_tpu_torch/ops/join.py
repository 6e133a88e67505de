"""Join kernels: the direct-address table and the sorted-build unique probe.

Counterparts of quickstep_tpu/ops/join.py `direct_build` (:43),
`direct_probe` (:63), `sorted_build` (:181) and `merge_unique_probe` (:382).
Each has a plain torch version (`*_plain`) and a hand-written CUDA kernel
(ops/cuda.py, csrc/join_kernels.cu: K3 for the direct table, K4 for the
sorted probe). The public function takes the plain version for tensors that
lie on the CPU and launches the kernel for CUDA tensors.

Uniqueness violations are detected on the device (a 0-d bool dup flag) so
the executor can retry on the expansion path, the analog of the reference's
HashTablePutResult::kOutOfSpace resize. The expansion join, open addressing
and the run-statistics probes wait for later slices.
"""

from __future__ import annotations

import torch

from quickstep_tpu_torch.ops.kernels import max_sentinel


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


# ---------------------------------------------------------------------
# direct-address table (dense integer keys)
# ---------------------------------------------------------------------

def direct_build(key: torch.Tensor, alive: torch.Tensor, lo: int,
                 domain: int):
    """Returns (int32 table[domain] of build row or -1, 0-d bool dup flag).
    When keys repeat, which row wins differs between the two versions; the
    dup flag is set then and the executor discards the table."""
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
    return cuda.direct_probe(table, key.contiguous(), alive.contiguous(), lo)


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
