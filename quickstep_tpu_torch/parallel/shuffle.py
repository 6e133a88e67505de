"""Key-partitioned (radix) shuffle over the mesh.

The counterpart of quickstep_tpu/parallel/shuffle.py: each shard buckets
its rows by the hash partition of their key, and the buckets are exchanged
with the mesh's `all_to_all`, so that afterwards every shard holds exactly
the rows whose keys hash to it. Every shard sends `n_parts` buckets of
`bucket_cap` rows; a bucket that overflows raises a flag, OR'd over the
shards, that the executor answers by re-running with larger buckets, and
heavy build keys can be salted (`salt > 1`): build rows go to `salt`
consecutive partitions and each probe row picks one.

Per shard (`radix_bucket`): K14 (ops/cuda.py partition_dest) gives each row
its slot, K15 (scatter_compact) scatters the row ids into the buckets, K6
(multi_gather) gathers the payload into them, on CUDA tensors; on CPU
tensors their plain versions run, which repeat the reference's stable
argsort. The buffers are those of the reference bit for bit.
"""

from __future__ import annotations

from typing import List

import torch

from quickstep_tpu_torch.ops.kernels import (
    _shr, hash64, multi_gather, scatter_compact)
from quickstep_tpu_torch.parallel.mesh import Mesh, all_to_all, pmax


def partition_of(packed_key: torch.Tensor, n_parts: int) -> torch.Tensor:
    """quickstep_tpu/parallel/shuffle.py:36: hash64 of the int64 key, mod
    n_parts unsigned, as int64 in [0, n_parts). torch has no uint64: the
    hash is split as 2 * (h >>> 1) + (h & 1)."""
    h = hash64(packed_key)
    if n_parts & (n_parts - 1) == 0:
        return h & (n_parts - 1)
    return ((_shr(h, 1) % n_parts) * 2 + (h & 1)) % n_parts


def partition_dest(key: torch.Tensor, alive: torch.Tensor, n_parts: int,
                   cap: int, salt: int = 1, probe_side: bool = True):
    """Each row's slot in n_parts buckets of cap rows (shuffle.py:57-91):
    p * cap + its stable rank among the live rows of its partition p, or
    n_parts * cap for a dead row and for a live row past cap. A salted build
    side (salt > 1, probe_side False) has salt * L rows, row s * L + i being
    row i sent to partition (p + s) mod n_parts; a salted probe row i goes
    to (p + i mod salt) mod n_parts. Returns (int32 dest, 0-d bool
    overflow). On CUDA one K14 call; on the CPU the plain version."""
    if alive.device.type == "cpu":
        return partition_dest_plain(key, alive, n_parts, cap, salt,
                                    probe_side)
    from quickstep_tpu_torch.ops import cuda
    return cuda.partition_dest(key.contiguous(), alive.contiguous(), n_parts,
                               cap, salt, probe_side)


def partition_dest_plain(key: torch.Tensor, alive: torch.Tensor,
                         n_parts: int, cap: int, salt: int = 1,
                         probe_side: bool = True):
    """Plain torch version of partition_dest: the reference's stable
    argsort of the partition ids and each row's distance from its run's
    start."""
    dev = alive.device
    L = alive.shape[0]
    p0 = partition_of(key, n_parts)
    if salt > 1 and not probe_side:
        p = torch.cat([(p0 + s) % n_parts for s in range(salt)])
        alive_x = alive.repeat(salt)
    else:
        p = p0
        if salt > 1:
            p = (p0 + torch.arange(L, device=dev) % salt) % n_parts
        alive_x = alive
    p = torch.where(alive_x, p, torch.full_like(p, n_parts))
    order = torch.argsort(p, stable=True)
    counts = torch.bincount(p, minlength=n_parts + 1)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(p)
    rank[order] = torch.arange(p.shape[0], device=dev) - starts[p[order]]
    live = p < n_parts
    overflow = torch.any(live & (rank >= cap))
    dest = torch.where(live & (rank < cap), p * cap + rank,
                       torch.full_like(p, n_parts * cap))
    return dest.to(torch.int32), overflow


def radix_bucket(packed_key: torch.Tensor, payload: List[torch.Tensor],
                 alive: torch.Tensor, n_parts: int, bucket_cap: int,
                 salt: int = 1, probe_side: bool = True):
    """One shard's side of radix_exchange (shuffle.py:57-103 up to the
    all_to_all): (the payload in n_parts buckets of bucket_cap rows, zero
    in the empty slots, the occupied mask, 0-d bool overflow)."""
    L = alive.shape[0]
    dest, overflow = partition_dest(packed_key, alive, n_parts, bucket_cap,
                                    salt, probe_side)
    slots = n_parts * bucket_cap
    rows = torch.arange(dest.shape[0], dtype=torch.int32, device=dest.device)
    buf_idx = scatter_compact(rows, dest, slots, fill=-1)
    occupied = buf_idx >= 0
    # a salted build side's row s * L + i is row i: no tiled copy
    safe = torch.clamp(buf_idx, min=0)
    if dest.shape[0] > L:
        safe = safe % max(L, 1)
    bufs = multi_gather(list(payload), safe)
    bufs = [b & occupied if b.dtype == torch.bool else
            torch.where(occupied, b, torch.zeros((), dtype=b.dtype,
                                                 device=b.device))
            for b in bufs]
    return bufs, occupied, overflow


def radix_exchange(mesh: Mesh, packed_keys: List[torch.Tensor],
                   payloads: List[List[torch.Tensor]],
                   alives: List[torch.Tensor], bucket_cap: int,
                   salt: int = 1, probe_side: bool = True):
    """quickstep_tpu/parallel/shuffle.py:43 over the mesh: per shard i,
    packed_keys[i] (int64), payloads[i] (1-D columns) and alives[i]. Every
    shard buckets its rows (radix_bucket) and bucket j of shard i becomes
    segment i of shard j. Returns (per shard the exchanged payload, per
    shard the exchanged live mask, 0-d bool overflow OR'd over the shards),
    each shard holding mesh.n * bucket_cap rows."""
    n = mesh.n
    local = [radix_bucket(k, p, a, n, bucket_cap, salt, probe_side)
             for k, p, a in zip(packed_keys, payloads, alives)]
    ncols = len(payloads[0])
    cols = [all_to_all(mesh, [b[0][c] for b in local]) for c in range(ncols)]
    exch = [[cols[c][j] for c in range(ncols)] for j in range(n)]
    alive_out = all_to_all(mesh, [b[1] for b in local])
    return exch, alive_out, pmax([b[2] for b in local])
