"""Multi-process execution: the Conductor/Executor analog.

The counterpart of quickstep_tpu/parallel/multihost.py. The reference's
distributed mode runs one Conductor and N Executor processes that pull
blocks from each other (cli/distributed/Conductor.hpp:47,
Executor.hpp:46); quickstep_tpu replaces them with SPMD over processes,
and so does this port:

- every process runs the same statements (parse -> optimize -> run) on the
  same catalog (the CatalogDatabaseCache analog: every process holds every
  table on the host), so every process takes the same plan;
- the mesh (parallel/mesh.py) spans the processes: process r holds global
  shards r * s .. r * s + s - 1 of its s local shards, and a table at or
  above Config.replicate_threshold_rows is row-sharded over the global
  mesh with each process uploading only the rows of its own shards
  (local_rows, the block-locality analog); a smaller table is replicated;
- rows cross processes only through the mesh's collectives
  (torch.distributed: gloo on the CPU, and for CUDA tensors staged through
  host memory; NCCL between distinct cards);
- results, runtime flags and every host decision are replicated
  (all_gather_to_host), so every process can print or serve them: process
  0 is the conventional conductor, which owns user-facing IO, and DDL and
  DML run on every process's catalog and end in a barrier (commit
  ordering).

The same mesh over members of one process (parallel/local_group.py,
Database(..., mesh_devices=[...])) runs on these functions too: where the
calling thread runs a member, world_group, is_multiprocess, process_index,
is_conductor and barrier answer for its group (member 0 the conductor),
and the processes' group is not consulted.

Bootstrap: call `bootstrap(coordinator, num_processes, process_id,
backend)` before creating the Database (whose mesh_shards then counts the
local shards), or let it read QSTPU_COORDINATOR, QSTPU_NUM_PROCS and
QSTPU_PROC_ID. The backend is never switched behind the caller's back:
NCCL needs a card per rank, and asking for it with two ranks on one card
raises.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import List, Optional

import numpy as np
import torch

from quickstep_tpu_torch.parallel import local_group

BACKENDS = ("gloo", "nccl")
# how long a rank waits for the others at the store and in a collective
TIMEOUT = datetime.timedelta(minutes=10)


def bootstrap(coordinator_address: Optional[str] = None,
              num_processes: Optional[int] = None,
              process_id: Optional[int] = None,
              backend: str = "gloo", device=None) -> None:
    """Join this process to the group of num_processes ranks that meets at
    coordinator_address ("host:port", served by process 0), from the
    arguments or the QSTPU_* variables. Once a process, before any
    Database is made. backend "nccl" needs `device`, this rank's card, and
    a distinct card for every rank; "gloo" carries any device's tensors."""
    import torch.distributed as dist
    coordinator_address = coordinator_address or os.environ.get(
        "QSTPU_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("QSTPU_NUM_PROCS", "0")) or None
    if process_id is None:
        pid = os.environ.get("QSTPU_PROC_ID")
        process_id = int(pid) if pid is not None else None
    if not coordinator_address or num_processes is None or \
            process_id is None:
        raise ValueError("bootstrap needs the coordinator's address, the "
                         "process count and this process's id (arguments "
                         "or QSTPU_COORDINATOR, QSTPU_NUM_PROCS, "
                         "QSTPU_PROC_ID)")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not "
                         f"{backend!r}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} of {num_processes}")
    if dist.is_initialized():
        raise RuntimeError("this process has already joined a group")
    if backend == "nccl":
        dev = torch.device(device) if device is not None else None
        if dev is None or dev.type != "cuda":
            raise ValueError("NCCL carries CUDA tensors: bootstrap needs "
                             "this rank's card as `device`")
        torch.cuda.set_device(dev)
    host, port = coordinator_address.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=process_id == 0, timeout=TIMEOUT)
    if backend == "nccl":
        _check_card_per_rank(store, num_processes, process_id, dev)
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, timeout=TIMEOUT)


def _check_card_per_rank(store, world: int, rank: int, dev) -> None:
    """NCCL refuses two ranks on one card; say so before it is asked."""
    props = torch.cuda.get_device_properties(dev)
    card = f"{socket.gethostname()}/{getattr(props, 'uuid', dev.index)}"
    store.set(f"qstpu_card_{rank}", card)
    cards = [store.get(f"qstpu_card_{r}").decode() for r in range(world)]
    for r in range(world):
        if r != rank and cards[r] == card:
            raise RuntimeError(
                f"NCCL needs a card per rank: ranks {min(r, rank)} and "
                f"{max(r, rank)} are both on {card}; give each rank its "
                "own card, or ask for gloo")


def world_group():
    """The calling thread's member, where it runs one; else the group of
    every process once bootstrap has run, else None (one process: a mesh
    without a group)."""
    member = local_group.current()
    if member is not None:
        return member
    return torch.distributed.group.WORLD if processes() > 1 else None


def processes() -> int:
    """The torch.distributed group's size (1 before bootstrap)."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


def is_multiprocess() -> bool:
    """Whether the mesh spans more than one rank: the calling thread's
    member's group, else the processes."""
    member = local_group.current()
    return member.world > 1 if member is not None else processes() > 1


def process_index() -> int:
    member = local_group.current()
    if member is not None:
        return member.rank
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def is_conductor() -> bool:
    """Process (or member) 0 owns user-facing IO (REPL, network CLI, result
    printing) and the learned overrides' file."""
    return process_index() == 0


def local_rows(mesh, arr: np.ndarray) -> np.ndarray:
    """The rows of the host array `arr` (every row of a table) that this
    process's shards own, once the table is padded with zero rows to a
    multiple of mesh.n (make_global_array's counterpart): global shard i
    holds rows i * c .. i * c + c - 1, c = ceil(len / n). Only this
    process's rows are copied."""
    n_rows = arr.shape[0]
    per = -(-n_rows // mesh.n)
    lo = mesh.local_ids[0] * per
    hi = lo + mesh.local_n * per
    part = np.asarray(arr[min(lo, n_rows):min(hi, n_rows)])
    short = (hi - lo) - part.shape[0]
    if short:
        part = np.concatenate([part, np.zeros(
            (short,) + part.shape[1:], dtype=part.dtype)])
    return part


def all_gather_to_host(mesh, tensors: List[Optional[torch.Tensor]]
                       ) -> List[Optional[np.ndarray]]:
    """Every process's rows of each tensor, in rank order, as host arrays
    on every process (mesh.all_gather, then a host copy of each)."""
    from quickstep_tpu_torch.parallel.mesh import all_gather
    return [None if t is None else t.cpu().numpy()
            for t in all_gather(mesh, list(tensors), "all_gather_to_host")]


def barrier() -> None:
    """Cross-process (or cross-member) sync point (DDL/DML commit
    ordering)."""
    member = local_group.current()
    if member is not None:
        member.barrier()
    elif processes() > 1:
        torch.distributed.barrier()


def shutdown() -> None:
    """Leave the group (a process's last call)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
