"""A mesh of row shards over one or more processes or members, and its
collectives.

The counterpart of quickstep_tpu/parallel/mesh.py. The reference's mesh is a
1-D `jax.sharding.Mesh` over chips, driven by one process per host; its
tests run it over 8 virtual CPU devices in one process, and over 2
processes in tests/test_multihost.py. Here a mesh is n = world x local
shards: each of `world` processes (ranks of a torch.distributed group,
parallel/multihost.py), or of `world` members of one process (threads
each driving its own device, parallel/local_group.py), holds `local_n`
shards on its one torch device, and rank r holds the global shards
r * local_n .. r * local_n + local_n - 1. One process (no group) holds all
n shards on one device, as before.

A sharded column on a rank is its local shards' rows, local_n equal
row ranges (views) of one tensor; a per-shard body runs as a Python loop
over the local shards in shard order (the order of `shard_map`'s
outputs). The collectives are named after `jax.lax`'s and cross the
ranks through torch.distributed, or between members by device copies:
`all_to_all` (all_to_all_single of equal buckets), `all_gather` (rows in
rank order), and `psum`, `pmin`, `pmax` and `por`, which gather every
shard's value and fold them in shard order, so that their results are bit
for bit those of the one-process mesh with the same global shard count,
floats included (all_reduce's ring order would not be); `fold_partials`
folds a list of partial states with them, one call for each kind. Every
tensor crosses as its bytes (uint8), so no backend's dtype limits apply;
under gloo a CUDA tensor is staged through host memory, under NCCL and
between members it crosses from the card. Each collective adds the bytes
this rank sends to the others to `Mesh.moved`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from quickstep_tpu_torch.parallel.local_group import Member

_ALIGN = 8          # bytes: each column of an exchange starts at a multiple
# a collective moves at most this many bytes from each process at once (a
# larger one runs as several): bounded messages for the backend and bounded
# host buffers where gloo stages a card's tensors
PIECE_BYTES = 1 << 28


class Mesh:
    """n shards along one axis: `devices` holds each local shard's device
    (every one the same: over several devices each is a member's, and the
    member its group), `group` the torch.distributed group whose ranks, or
    the parallel/local_group.py Member whose group's members, each hold as
    many (None: this process holds them all)."""

    def __init__(self, devices: Sequence, axis: str = "x", group=None):
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("a mesh needs at least one shard")
        if len(set(devs)) > 1:
            raise ValueError(
                f"the local shards of a mesh share one device, not "
                f"{sorted({str(d) for d in devs})}: a mesh over several "
                "devices in one process has one member a device "
                "(Database(config, mesh_shards=s, mesh_devices=[...]), "
                "parallel/local_group.py)")
        self.device = devs[0]
        self.local_n = len(devs)
        self.axis = axis
        self.group = group
        self.world, self.rank = 1, 0
        self._member = isinstance(group, Member)
        if self._member:
            if group.device != self.device:
                raise ValueError(f"{group} holds its shards on "
                                 f"{group.device}, not {self.device}")
            self.world, self.rank = group.world, group.rank
        elif group is not None:
            import torch.distributed as dist
            self.world = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
        self.n = self.world * self.local_n
        first = self.rank * self.local_n
        self.local_ids = list(range(first, first + self.local_n))
        # gloo carries host tensors: a CUDA tensor is staged through host
        # memory (never by a silent switch of backend); members copy from
        # card to card
        self._stage = group is not None and not self._member and \
            self.device.type == "cuda" and _backend(group) == "gloo"
        # collective name -> {"calls", "bytes"}: bytes this process sent to
        # the others; gathers: one entry per operator input gathered
        self.moved: Dict[str, Dict[str, int]] = {}
        self.gathers: List[dict] = []
        if self.world > 1:
            counts = all_gather(self, [torch.tensor(
                [self.local_n], dtype=torch.int64, device=self.device)],
                "setup")[0].tolist()
            if len(set(counts)) > 1:
                raise ValueError(f"every process of a mesh holds as many "
                                 f"shards; these hold {counts}")

    def __repr__(self) -> str:
        who = "member" if self._member else "process"
        where = "" if self.world == 1 else \
            f", {who} {self.rank} of {self.world}"
        return (f"Mesh({self.n} shards, {self.local_n} on {self.device}"
                f"{where}, axis {self.axis!r})")

    def reset_counts(self) -> None:
        self.moved = {}
        self.gathers = []

    def counts(self) -> dict:
        """What crossed the processes since reset_counts: each collective's
        calls and bytes sent, and the operator inputs gathered."""
        return {"collectives": {k: dict(v) for k, v in self.moved.items()},
                "gathers": [dict(g) for g in self.gathers]}

    def _count(self, name: str, nbytes: int) -> None:
        entry = self.moved.setdefault(name, {"calls": 0, "bytes": 0})
        entry["calls"] += 1
        entry["bytes"] += int(nbytes)


def _backend(group) -> str:
    import torch.distributed as dist
    return str(dist.get_backend(group)).lower()


def make_mesh(n_shards: int, device, axis: str = "x", group=None) -> Mesh:
    """n_shards shards of one device in this process (make_mesh:20's
    counterpart: the shard count is given, nothing probes the hardware);
    with a group, each of its ranks holds n_shards of the mesh: a
    torch.distributed group's processes, or a LocalGroup's members (group
    the Member, device its device)."""
    if n_shards < 1:
        raise ValueError(f"mesh of {n_shards} shards")
    return Mesh([device] * n_shards, axis, group)


def shard_rows(mesh: Mesh, t: torch.Tensor,
               local: bool = False) -> List[torch.Tensor]:
    """The local shards' row ranges (views) of t: with local, t holds this
    process's rows of a sharded column, cut into mesh.local_n ranges; else
    t holds every row (a replicated value), cut into mesh.n ranges of which
    the local ones are kept. The length must split evenly
    (pad_to_multiple)."""
    parts = mesh.local_n if local else mesh.n
    n = t.shape[0]
    if n % parts:
        raise ValueError(f"{n} rows do not split into {parts} shards")
    rows = list(t.view(parts, n // parts, *t.shape[1:]).unbind(0)) \
        if n else [t[:0]] * parts
    return rows if local else [rows[i] for i in mesh.local_ids]


def replicate(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """A replicated value: every shard reads the whole tensor."""
    return t


def pad_to_multiple(arr: np.ndarray, m: int) -> np.ndarray:
    n = arr.shape[0]
    target = ((n + m - 1) // m) * m
    if target == n:
        return arr
    return np.pad(arr, [(0, target - n)] + [(0, 0)] * (arr.ndim - 1))


# ----------------------------------------------------------------------
# tensors as bytes
# ----------------------------------------------------------------------
def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """t's elements as a 1-D uint8 tensor (a view where t is contiguous)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


# ----------------------------------------------------------------------
# collectives
# ----------------------------------------------------------------------
def all_gather(mesh: Mesh, tensors: List[Optional[torch.Tensor]],
               name: str = "all_gather") -> List[Optional[torch.Tensor]]:
    """Each tensor's rows from every process, concatenated in rank order
    (so, for sharded rows, in shard order; a 0-d tensor gives one value a
    process), each received straight into its result. Every process passes
    tensors of the same shapes and dtypes (None where the others pass
    None). One process returns them as they are."""
    if mesh.world == 1:
        return list(tensors)
    out, sent = [], 0
    for t in tensors:
        if t is None:
            out.append(None)
            continue
        src = _as_bytes(t)
        res = torch.empty((mesh.world * t.shape[0], *t.shape[1:]) if t.dim()
                          else (mesh.world,), dtype=t.dtype,
                          device=mesh.device)
        _all_gather_bytes(mesh, src, _as_bytes(res).view(mesh.world, -1))
        sent += src.numel() * (mesh.world - 1)
        out.append(res)
    mesh._count(name, sent)
    return out


def _pieces(nbytes: int):
    """[a, b) byte ranges of at most PIECE_BYTES covering nbytes (none for
    no bytes: every process skips the collective alike)."""
    return [(a, min(a + PIECE_BYTES, nbytes))
            for a in range(0, nbytes, PIECE_BYTES)]


def _all_gather_bytes(mesh: Mesh, src: torch.Tensor,
                      dst: torch.Tensor) -> None:
    """Row r of dst [world, len(src)] (uint8, on the mesh's device) gets
    rank r's src: between processes PIECE_BYTES at a time, between members
    in one exchange (device copies need no bounded messages)."""
    import torch.distributed as dist
    if mesh._member:
        if src.numel():
            mesh.group.all_gather(dst, src)
        return
    for a, b in _pieces(src.numel()):
        if mesh._stage:
            piece = src[a:b].cpu()
            recv = [torch.empty_like(piece) for _ in range(mesh.world)]
            dist.all_gather(recv, piece, group=mesh.group)
            for r, got in enumerate(recv):
                dst[r, a:b].copy_(got)
        else:
            dist.all_gather(list(dst[:, a:b].unbind(0)), src[a:b],
                            group=mesh.group)


def _all_to_all_rows(mesh: Mesh, send: torch.Tensor) -> torch.Tensor:
    """all_to_all_single of send [world, R] uint8 (row q goes to rank q;
    row q of the result came from rank q): between processes PIECE_BYTES
    of each row at a time, between members in one exchange."""
    import torch.distributed as dist
    out = torch.empty_like(send)
    if mesh._member:
        if send.shape[1]:
            mesh.group.all_to_all(out, send)
        return out
    for a, b in _pieces(send.shape[1]):
        piece = send[:, a:b].contiguous()
        src = piece.cpu() if mesh._stage else piece
        recv = torch.empty_like(src)
        dist.all_to_all_single(recv, src, group=mesh.group)
        out[:, a:b].copy_(recv)
    return out


def all_to_all(mesh: Mesh, parts: list) -> list:
    """jax.lax.all_to_all(split_axis=0, concat_axis=0, tiled=True): every
    local shard holds n equal buckets; bucket j of global shard i becomes
    segment i of global shard j. parts holds each local shard's tensor, or
    each local shard's list of columns (all moved by one collective).
    Returns the local shards' results in the same form."""
    single = isinstance(parts[0], torch.Tensor)
    cols = [[p] for p in parts] if single else [list(p) for p in parts]
    n, s = mesh.n, mesh.local_n
    if len(cols) != s:
        raise ValueError(f"{len(cols)} parts for {s} local shards")
    ms = [c.shape[0] for c in cols[0]]
    for m in ms:
        if m % n:
            raise ValueError(f"{m} rows do not split into {n} buckets")
    if mesh.world == 1:
        # one transposing copy a column on the device
        out = [[None] * len(ms) for _ in range(s)]
        for c, m in enumerate(ms):
            stacked = torch.stack([p[c] for p in cols]).view(n, n, m // n)
            for j, t in enumerate(stacked.transpose(0, 1).reshape(n, m)
                                  .unbind(0)):
                out[j][c] = t
    else:
        out = _all_to_all_bytes(mesh, cols, ms)
    return [o[0] for o in out] if single else out


def _all_to_all_bytes(mesh: Mesh, cols, ms) -> list:
    """all_to_all across processes: every local shard's buckets written as
    bytes into one send buffer, row q for process q (each column's bucket
    at its own aligned offset), dist.all_to_all_single of equal splits,
    then each column cut out for each local destination shard."""
    n, s, w = mesh.n, mesh.local_n, mesh.world
    widths, width = [], 0       # per column: (offset, bytes of a bucket)
    for c, m in enumerate(ms):
        nb = (m // n) * cols[0][c].element_size()
        widths.append((width, nb))
        width += nb + (-nb % _ALIGN)
    # [destination process q, source shard i, destination shard j', B]
    send = torch.empty((w, s, s, width), dtype=torch.uint8,
                       device=mesh.device)
    for i, p in enumerate(cols):
        for c, (off, nb) in enumerate(widths):
            send[:, i, :, off:off + nb].copy_(
                p[c].contiguous().view(torch.uint8).view(w, s, nb))
    recv = _all_to_all_rows(mesh, send.view(w, -1)).view(w, s, s, width)
    mesh._count("all_to_all", send.numel() * (w - 1) // w)
    del send
    # [source process q, its shard i', ...]: global source shard q * s + i'
    return [[recv[:, :, j, off:off + nb].contiguous()
             .view(cols[0][c].dtype).reshape(ms[c])
             for c, (off, nb) in enumerate(widths)] for j in range(s)]


def _fold(mesh: Mesh, parts: List[torch.Tensor], op, name: str,
          local: bool = True):
    """Every shard's value folded left in shard order: parts holds the
    local shards' values, gathered from every process first; with local
    False, every shard's of the mesh, folded here."""
    if local and mesh.world > 1:
        parts = list(all_gather(mesh, [torch.stack(parts)], name)[0]
                     .unbind(0))
    out = parts[0]
    for p in parts[1:]:
        out = op(out, p)
    return out


def psum(mesh: Mesh, parts: List[torch.Tensor]) -> torch.Tensor:
    """jax.lax.psum: the sum over the shards, which every shard reads;
    parts holds each local shard's value."""
    return _fold(mesh, parts, torch.add, "psum")


def pmax(mesh: Mesh, parts: List[torch.Tensor]) -> torch.Tensor:
    """jax.lax.pmax: the maximum over the shards."""
    return _fold(mesh, parts, torch.maximum, "pmax")


def pmin(mesh: Mesh, parts: List[torch.Tensor]) -> torch.Tensor:
    """jax.lax.pmin: the minimum over the shards."""
    return _fold(mesh, parts, torch.minimum, "pmin")


def por(mesh: Mesh, parts: List[torch.Tensor],
        name: str = "por") -> torch.Tensor:
    """The bitwise OR over the shards (bool flags, bit words), its bytes
    counted in Mesh.moved under name."""
    return _fold(mesh, parts, torch.bitwise_or, name)


_FOLDS = {"sum": (torch.add, "psum"), "min": (torch.minimum, "pmin"),
          "max": (torch.maximum, "pmax"), "or": (torch.bitwise_or, "por")}


def fold_partials(mesh: Mesh, parts: List[list], local: bool) -> list:
    """Per-shard partial states folded left in shard order. parts holds a
    list a shard of (op, tensor) pairs, op one of "sum", "min", "max" and
    "or", every shard's pairs alike; returns the folded tensors in their
    order. With local, parts are this process's local shards' and cross
    the processes as psum, pmin, pmax and por do, one call for each (op,
    dtype, shape); else they are every shard's of the mesh and fold here,
    with the same torch ops in the same order, so both give the
    one-process mesh's bits."""
    groups: Dict[tuple, List[int]] = {}
    for j, (op, t) in enumerate(parts[0]):
        groups.setdefault((op, t.dtype, tuple(t.shape)), []).append(j)
    out: list = [None] * len(parts[0])
    for (op, _dtype, _shape), idx in groups.items():
        stacked = [torch.stack([p[j][1] for j in idx]) for p in parts]
        acc = _fold(mesh, stacked, *_FOLDS[op], local=local)
        for k, j in enumerate(idx):
            out[j] = acc[k]
    return out
