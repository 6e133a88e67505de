"""The distributed aggregate-join step over the mesh.

The counterpart of quickstep_tpu/parallel/dist.py: filter, broadcast-join
probe and dense group-by on each row shard, then the partial states summed
over the mesh (psum, the pipeline breaker, which crosses the processes of
a multi-process mesh). Each local shard runs K3 (the direct build of the
replicated build side and the probe) and K2 (the dense group-by) on CUDA
tensors, their plain versions on CPU tensors; the step has no kernel of
its own.
"""

from __future__ import annotations

import numpy as np
import torch

from quickstep_tpu_torch.ops import groupby as G
from quickstep_tpu_torch.ops import join as J
from quickstep_tpu_torch.parallel.mesh import (
    Mesh, psum, replicate, shard_rows)

N_GROUPS = 8
DOMAIN = 1 << 12


def distributed_agg_join_step(mesh: Mesh, axis: str = "x"):
    """fn(l_key, l_val, l_grp, l_alive, b_key, b_alive) -> (group sums
    float64[N_GROUPS], group counts int64[N_GROUPS]): the l_* columns are
    row-sharded over the mesh, each process passing the rows of its own
    shards (multihost.local_rows; one process passes them all, their
    length a multiple of its shards), b_key (unique keys in [0, DOMAIN))
    and b_alive replicated. Every process gets the same sums, bit for bit
    those of the one-process mesh of as many shards."""
    if axis != mesh.axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")

    def local_step(l_key, l_val, l_grp, l_alive, b_key, b_alive):
        # broadcast join: every shard builds the same direct-address table
        table, _ = J.direct_build(b_key, b_alive, 0, DOMAIN)
        _bidx, matched = J.direct_probe(table, l_key, l_alive, 0, DOMAIN)
        alive = l_alive & matched
        _, results = G.dense_aggregate(
            [l_grp], [0], [1], N_GROUPS,
            [("sum", l_val, None), ("count", None, None)], alive)
        (sums, _), (counts, _) = results
        return sums, counts.to(torch.int64)

    def fn(l_key, l_val, l_grp, l_alive, b_key, b_alive):
        shards = zip(*(shard_rows(mesh, t, local=True)
                       for t in (l_key, l_val, l_grp, l_alive)))
        parts = [local_step(*s, b_key, b_alive) for s in shards]
        # pipeline breaker: combine the partial states over the mesh
        return (psum(mesh, [p[0] for p in parts]),
                psum(mesh, [p[1] for p in parts]))

    return fn


def make_example_inputs(mesh: Mesh, rows_per_chip: int = 256,
                        build_rows: int = 64):
    """The reference's inputs (quickstep_tpu/parallel/dist.py:67), from the
    same numpy generator, on the mesh's device: of the l_* columns this
    process's rows."""
    from quickstep_tpu_torch.parallel.multihost import local_rows
    n = mesh.n * rows_per_chip
    rng = np.random.default_rng(0)
    l_key = rng.integers(0, build_rows, n).astype(np.int64)
    l_val = rng.uniform(0, 100, n)
    l_grp = rng.integers(0, 8, n).astype(np.int64)
    l_alive = np.ones(n, bool)
    b_key = np.arange(build_rows, dtype=np.int64)
    b_alive = np.ones(build_rows, bool)

    def on(a):
        return torch.from_numpy(a).to(mesh.device)
    return (on(local_rows(mesh, l_key)), on(local_rows(mesh, l_val)),
            on(local_rows(mesh, l_grp)), on(local_rows(mesh, l_alive)),
            replicate(mesh, on(b_key)), replicate(mesh, on(b_alive)))
