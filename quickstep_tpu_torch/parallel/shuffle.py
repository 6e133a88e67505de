"""Key-partitioned (radix) shuffle over the mesh.

The counterpart of quickstep_tpu/parallel/shuffle.py: each shard buckets
its rows by the hash partition of their key, and the buckets are exchanged
with the mesh's `all_to_all`, so that afterwards every shard holds exactly
the rows whose keys hash to it. A process runs its local shards' sides,
and the exchange crosses the processes of a multi-process mesh. Every
shard sends `n_parts` buckets of `bucket_cap` rows; a bucket that
overflows raises a flag, OR'd over the shards, that the executor answers
by re-running with larger buckets, and heavy build keys can be salted
(`salt > 1`): build rows go to `salt` consecutive partitions and each
probe row picks one.

Per shard (`radix_bucket`), on CUDA tensors: K14 (ops/cuda.py
partition_dest) gives each row its slot and each bucket its occupied count
in one launch, K15's bucket route (ops/cuda.py bucket_rows) turns them into
every slot's gather index and the occupied mask in one launch, each slot
written once, and K6 (multi_gather) gathers the payload into the buckets.
On CPU tensors their plain versions run, which repeat the reference's
stable argsort and scatter. The buffers are those of the reference bit for
bit.
"""

from __future__ import annotations

from typing import List

import torch

from quickstep_tpu_torch.ops.kernels import (
    _shr, hash64, multi_gather, scatter_compact_plain)
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
                   cap: int, salt: int = 1, probe_side: bool = True,
                   with_counts: bool = False):
    """Each row's slot in n_parts buckets of cap rows (shuffle.py:57-91):
    p * cap + its stable rank among the live rows of its partition p, or
    n_parts * cap for a dead row and for a live row past cap. A salted build
    side (salt > 1, probe_side False) has salt * L rows, row s * L + i being
    row i sent to partition (p + s) mod n_parts; a salted probe row i goes
    to (p + i mod salt) mod n_parts. Returns (int32 dest, 0-d bool
    overflow), and with with_counts each bucket's occupied count
    min(its live rows, cap) as int32[n_parts]. On CUDA one K14 call; on the
    CPU the plain version."""
    if alive.device.type == "cpu":
        return partition_dest_plain(key, alive, n_parts, cap, salt,
                                    probe_side, with_counts)
    from quickstep_tpu_torch.ops import cuda
    return cuda.partition_dest(key.contiguous(), alive.contiguous(), n_parts,
                               cap, salt, probe_side, with_counts)


def partition_dest_plain(key: torch.Tensor, alive: torch.Tensor,
                         n_parts: int, cap: int, salt: int = 1,
                         probe_side: bool = True, with_counts: bool = False):
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
    if not with_counts:
        return dest.to(torch.int32), overflow
    occupied = torch.clamp(counts[:n_parts], max=cap).to(torch.int32)
    return dest.to(torch.int32), overflow, occupied


def bucket_rows(dest: torch.Tensor, counts: torch.Tensor, rows: int,
                cap: int):
    """K15's route for partition_dest's dest and counts over an input of
    `rows` rows: (the int32 gather index of each of the len(counts) * cap
    slots, the id mod rows of the row that lands there and 0 in an empty
    slot; the bool occupied mask). On CUDA one K15 launch (ops/cuda.py
    bucket_rows); on the CPU the plain version."""
    if dest.device.type == "cpu":
        return bucket_rows_plain(dest, counts, rows, cap)
    from quickstep_tpu_torch.ops import cuda
    return cuda.bucket_rows(dest.contiguous(), counts.contiguous(), rows,
                            cap)


def bucket_rows_plain(dest: torch.Tensor, counts: torch.Tensor, rows: int,
                      cap: int):
    """Plain torch version of bucket_rows: two scatter_compact_plain calls,
    of the row ids mod rows (fill 0) and of the occupied flags (fill False);
    the counts are not read."""
    slots = counts.shape[0] * cap
    ids = torch.arange(dest.shape[0], dtype=torch.int32, device=dest.device)
    if dest.shape[0] > rows:
        ids = ids % rows        # a salted build side's row s * L + i is row i
    return (scatter_compact_plain(ids, dest, slots, fill=0),
            scatter_compact_plain(torch.ones_like(ids, dtype=torch.bool),
                                  dest, slots, fill=False))


def radix_bucket(packed_key: torch.Tensor, payload: List[torch.Tensor],
                 alive: torch.Tensor, n_parts: int, bucket_cap: int,
                 salt: int = 1, probe_side: bool = True):
    """One shard's side of radix_exchange (shuffle.py:57-103 up to the
    all_to_all): (the payload in n_parts buckets of bucket_cap rows, zero
    in the empty slots, the occupied mask, 0-d bool overflow)."""
    dest, overflow, counts = partition_dest(
        packed_key, alive, n_parts, bucket_cap, salt, probe_side,
        with_counts=True)
    idx, occupied = bucket_rows(dest, counts, alive.shape[0], bucket_cap)
    bufs = multi_gather(list(payload), idx)
    bufs = [b & occupied if b.dtype == torch.bool else
            torch.where(occupied, b, torch.zeros((), dtype=b.dtype,
                                                 device=b.device))
            for b in bufs]
    return bufs, occupied, overflow


def radix_exchange(mesh: Mesh, packed_keys: List[torch.Tensor],
                   payloads: List[List[torch.Tensor]],
                   alives: List[torch.Tensor], bucket_cap: int,
                   salt: int = 1, probe_side: bool = True):
    """quickstep_tpu/parallel/shuffle.py:43 over the mesh: per local shard
    i, packed_keys[i] (int64), payloads[i] (1-D columns) and alives[i].
    Every local shard buckets its rows (radix_bucket) and bucket j of
    global shard i becomes segment i of global shard j, every column and
    the live mask in one all_to_all. Returns (per local shard the exchanged
    payload, per local shard the exchanged live mask, 0-d bool overflow
    OR'd over every shard of the mesh by pmax), each shard holding mesh.n
    * bucket_cap rows."""
    local = [radix_bucket(k, p, a, mesh.n, bucket_cap, salt, probe_side)
             for k, p, a in zip(packed_keys, payloads, alives)]
    moved = all_to_all(mesh, [list(b[0]) + [b[1]] for b in local])
    return ([m[:-1] for m in moved], [m[-1] for m in moved],
            pmax(mesh, [b[2] for b in local]))
