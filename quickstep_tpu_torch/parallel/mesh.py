"""A mesh of n row shards on one device, and its collectives.

The counterpart of quickstep_tpu/parallel/mesh.py. The reference's mesh is a
1-D `jax.sharding.Mesh` over chips, driven by one process (JAX is single
controller), and its tests run it over 8 virtual CPU devices in one process.
Here a mesh is n shards of one torch device, driven by the one process that
runs the query: a sharded column is n equal row ranges (views) of one
tensor, a per-shard body runs as a Python loop over the shards in shard
order (the order of `shard_map`'s outputs), and the collectives are tensor
operations over the list of per-shard tensors, named after `jax.lax`'s:
`all_to_all` (one permutation on the device), `psum` and `pmax`.

A mesh over distinct devices (peer copies or NCCL between cards) is not
ported: asking for one raises NotImplementedError.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

DISTINCT_DEVICES = ("a mesh over distinct devices is not ported; ROADMAP "
                    "queue 1 item 5 (distinct cards, by peer copies or "
                    "NCCL) comes next")


class Mesh:
    """n shards along one axis. `devices` holds each shard's device; every
    shard must lie on the same one."""

    def __init__(self, devices: Sequence, axis: str = "x"):
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("a mesh needs at least one shard")
        if len(set(devs)) > 1:
            raise NotImplementedError(DISTINCT_DEVICES)
        self.device = devs[0]
        self.n = len(devs)
        self.axis = axis

    def __repr__(self) -> str:
        return f"Mesh({self.n} shards on {self.device}, axis {self.axis!r})"


def make_mesh(n_shards: int, device, axis: str = "x") -> Mesh:
    """n_shards shards of one device (make_mesh:20's counterpart: the
    shard count is given, nothing probes the hardware)."""
    if n_shards < 1:
        raise ValueError(f"mesh of {n_shards} shards")
    return Mesh([device] * n_shards, axis)


def shard_rows(mesh: Mesh, t: torch.Tensor) -> List[torch.Tensor]:
    """t's rows cut into mesh.n equal ranges (views); the length must be a
    multiple of the shard count (pad_to_multiple)."""
    n = t.shape[0]
    if n % mesh.n:
        raise ValueError(f"{n} rows do not split into {mesh.n} shards")
    return list(t.view(mesh.n, n // mesh.n, *t.shape[1:]).unbind(0)) \
        if n else [t[:0]] * mesh.n


def replicate(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """A replicated value: every shard reads the whole tensor."""
    return t


def pad_to_multiple(arr: np.ndarray, m: int) -> np.ndarray:
    n = arr.shape[0]
    target = ((n + m - 1) // m) * m
    if target == n:
        return arr
    return np.pad(arr, [(0, target - n)] + [(0, 0)] * (arr.ndim - 1))


def all_to_all(mesh: Mesh, parts: List[torch.Tensor]) -> List[torch.Tensor]:
    """jax.lax.all_to_all(split_axis=0, concat_axis=0, tiled=True): shard i
    holds n equal buckets; bucket j of shard i becomes segment i of shard
    j. One transposing copy on the device."""
    n = mesh.n
    if len(parts) != n:
        raise ValueError(f"{len(parts)} parts for {n} shards")
    m = parts[0].shape[0]
    if m % n:
        raise ValueError(f"{m} rows do not split into {n} buckets")
    stacked = torch.stack(parts).view(n, n, m // n)
    return list(stacked.transpose(0, 1).reshape(n, m).unbind(0))


def psum(parts: List[torch.Tensor]) -> torch.Tensor:
    """jax.lax.psum: the sum over the shards, which every shard reads."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def pmax(parts: List[torch.Tensor]) -> torch.Tensor:
    """jax.lax.pmax: the maximum over the shards."""
    out = parts[0]
    for p in parts[1:]:
        out = torch.maximum(out, p)
    return out
