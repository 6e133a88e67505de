"""Chunk: the in-flight columnar batch flowing between operators.

The counterpart of quickstep_tpu/exec/chunk.py (:30-320): a dict of
equal-length device columns keyed by ExprId, plus a live-row bool mask.

Late materialization: a slot may hold a `LazyCol`, a base column plus a
shared `RowIds` gather map, instead of a materialized (data, valid) pair.
Joins and compactions then move one row-id array per upstream source instead
of gathering every payload column at every operator; payload bytes are
gathered once, at the point of use (expression evaluation or the output
pull), usually after the row set has been filtered and compacted. Each
gather is one `multi_gather` (K6 on CUDA) per shared RowIds.

A chunk may hold only one process's rows of a multi-process mesh
(`sharded`); exec/runner.py gathers it before an operator that has no
per-shard form.

Unlike the reference, gather chains have no depth cap (the reference's
module-global cap works around the TPU compiler), and `restrict_valid` never
mutates a RowIds that another chunk may hold.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from quickstep_tpu_torch.optimizer.logical import OutAttr
from quickstep_tpu_torch.expressions.scalar import EvalContext


class RowIds:
    """Shared gather map: `idx[capacity]` row indices plus an optional `ok`
    mask (rows with ok False materialize as NULL). All LazyCols made from
    one source chunk by one operator share one RowIds, so composing the map
    costs one gather for the whole column group.

    `parent`: lazy composition chain. A chained map means
    effective_idx[i] = parent.effective_idx[idx[i]]; composition happens
    only at materialization (resolve), from the outermost map inward, so
    every gather's output has the final (usually post-compaction) size."""

    __slots__ = ("idx", "ok", "parent", "depth")

    def __init__(self, idx, ok=None, parent: "RowIds" = None):
        self.idx = idx
        self.ok = ok
        self.parent = parent
        self.depth = 1 + (parent.depth if parent is not None else 0)

    def chain_ok_none(self) -> bool:
        """True when no level of the chain carries a NULLing mask."""
        r = self
        while r is not None:
            if r.ok is not None:
                return False
            r = r.parent
        return True

    def resolve(self):
        """Flatten the chain in place: one gather per level, each with output
        size len(self.idx). Idempotent, and it keeps the map's meaning, so a
        shared instance may resolve for all its holders."""
        if self.parent is None:
            return
        from quickstep_tpu_torch.ops import kernels as K
        acc, ok = self.idx, self.ok
        p = self.parent
        while p is not None:
            safe = torch.clamp(acc, 0, max(int(p.idx.shape[0]) - 1, 0))
            if p.idx.shape[0] == 0:
                # a map of zero rows: every row it yields is invalid
                acc = torch.zeros_like(safe)
                ok = torch.zeros(safe.shape, dtype=torch.bool,
                                 device=safe.device)
            elif p.ok is not None:
                g = K.multi_gather([p.idx, p.ok], safe)
                ok = g[1] if ok is None else (ok & g[1])
                acc = g[0]
            else:
                acc = K.multi_gather([p.idx], safe)[0]
            p = p.parent
        self.idx, self.ok, self.parent = acc, ok, None
        self.depth = 1


class LazyCol:
    """A deferred column: base[rid.idx] with validity
    (base_valid[rid.idx] AND rid.ok)."""

    __slots__ = ("base", "base_valid", "rid")
    lazy = True

    def __init__(self, base, base_valid, rid: RowIds):
        self.base = base
        self.base_valid = base_valid
        self.rid = rid


def _is_lazy(v) -> bool:
    return isinstance(v, LazyCol)


def _full(d: torch.Tensor, capacity: int) -> torch.Tensor:
    if d.dim() == 0:
        d = torch.broadcast_to(d, (capacity,))
    return d


def compose_slots(src: "Chunk", take_idx, take_ok) -> Dict[int, LazyCol]:
    """New slots referencing src rows at `take_idx` (with optional validity
    mask `take_ok`). Existing lazy cols chain their gather maps (composition
    deferred to RowIds.resolve); materialized cols become lazy against one
    shared fresh RowIds. No payload bytes and no row-id bytes move here. A
    chain resolves when a column is materialized."""
    base_rid = RowIds(take_idx, take_ok)
    comp: Dict[int, RowIds] = {}
    out: Dict[int, LazyCol] = {}
    for eid, v in src.slots.items():
        if _is_lazy(v):
            r = comp.get(id(v.rid))
            if r is None:
                r = RowIds(take_idx, take_ok, parent=v.rid)
                comp[id(v.rid)] = r
            out[eid] = LazyCol(v.base, v.base_valid, r)
        else:
            d, val = v
            out[eid] = LazyCol(_full(d, src.capacity),
                               None if val is None else _full(val,
                                                              src.capacity),
                               base_rid)
    return out


def repeat_slots(src: "Chunk", k: int) -> Dict[int, LazyCol]:
    """Slots for the k-fold row-repeated view of src (expansion joins): only
    the outer level of each gather map is repeated (its parent chain
    resolves later, at the final row count); materialized columns share one
    repeated row-id map. No payload bytes move here."""
    base_rid: Optional[RowIds] = None
    comp: Dict[int, RowIds] = {}
    out: Dict[int, LazyCol] = {}
    for eid, v in src.slots.items():
        if _is_lazy(v):
            r = comp.get(id(v.rid))
            if r is None:
                r = RowIds(torch.repeat_interleave(v.rid.idx, k),
                           None if v.rid.ok is None
                           else torch.repeat_interleave(v.rid.ok, k),
                           parent=v.rid.parent)
                comp[id(v.rid)] = r
            out[eid] = LazyCol(v.base, v.base_valid, r)
        else:
            if base_rid is None:
                base_rid = RowIds(torch.repeat_interleave(torch.arange(
                    src.capacity, dtype=torch.int32, device=src.device), k))
            d, val = v
            out[eid] = LazyCol(_full(d, src.capacity),
                               None if val is None else _full(val,
                                                              src.capacity),
                               base_rid)
    return out


@dataclasses.dataclass
class Chunk:
    attrs: List[OutAttr]
    # expr_id -> (data, valid) pair of tensors (valid None = all valid), or
    # a LazyCol
    slots: Dict[int, object]
    alive: torch.Tensor                                # bool[capacity]
    capacity: int
    # static (host-known) upper bound on live rows, when tighter than capacity
    bound: Optional[int] = None
    # host-side (static, per-plan) metadata for physical decisions:
    ranges: Dict[int, Optional[Tuple[int, int]]] = dataclasses.field(
        default_factory=dict)
    unique_sets: List[frozenset] = dataclasses.field(default_factory=list)
    # per-attr upper bound on duplicate count (heaviest value)
    max_counts: Dict[int, int] = dataclasses.field(default_factory=dict)
    # row-wise functional dependencies (determinant ids -> dependent ids)
    fds: List[Tuple[frozenset, frozenset]] = dataclasses.field(
        default_factory=list)
    # under a multi-process mesh: the chunk holds only this process's rows
    # (its local shards'), `capacity` of them; the other processes hold the
    # rest, and `bound` counts the live rows of them all
    sharded: bool = False

    @property
    def device(self) -> torch.device:
        return self.alive.device

    def ctx(self, extra: Optional[dict] = None) -> EvalContext:
        """The evaluation context; `extra` adds bound values (scalar
        subqueries) beside the columns."""
        slots = self.slots if not extra else {**self.slots, **extra}
        return EvalContext(slots, fetch=self.get, device=self.device)

    # ------------------------------------------------------------------
    # lazy materialization
    # ------------------------------------------------------------------
    def get(self, expr_id: int):
        v = self.slots[expr_id]
        if _is_lazy(v):
            self.ensure([expr_id])
            v = self.slots[expr_id]
        return v

    def ensure(self, eids: Iterable[int]):
        """Materialize the given columns: one multi_gather per shared
        RowIds for every LazyCol that shares it."""
        from quickstep_tpu_torch.ops import kernels as K
        groups: Dict[int, List[int]] = {}
        for eid in eids:
            v = self.slots.get(eid)
            if _is_lazy(v):
                groups.setdefault(id(v.rid), []).append(eid)
        for ids in groups.values():
            first: LazyCol = self.slots[ids[0]]
            rid = first.rid
            rid.resolve()   # flatten any composition chain (outside-in)
            n_base = int(first.base.shape[0])
            safe = torch.clamp(rid.idx, 0, max(n_base - 1, 0))
            cols = []
            for eid in ids:
                lc: LazyCol = self.slots[eid]
                cols.append(lc.base)
                cols.append(lc.base_valid)
            g = K.multi_gather(cols, safe)
            ok = rid.ok
            if n_base == 0:
                # a source of zero rows: the gathered rows are invalid
                ok = torch.zeros(safe.shape, dtype=torch.bool,
                                 device=safe.device)
            for j, eid in enumerate(ids):
                d, v = g[2 * j], g[2 * j + 1]
                if ok is not None:
                    v = ok if v is None else (v & ok)
                self.slots[eid] = (d, v)

    def materialize_all(self) -> "Chunk":
        """Materialize every slot (a shared subplan's chunk, so that its
        consumers share the gathered columns)."""
        self.ensure(list(self.slots))
        return self

    def restrict_valid(self, eids: Iterable[int], keep):
        """AND `keep` into the valid mask of the given columns. Lazy columns
        get a new RowIds per shared map, with the same indices and parent and
        the restricted mask: a RowIds that another chunk or chain holds is
        never changed."""
        fresh: Dict[int, RowIds] = {}
        for eid in eids:
            v = self.slots[eid]
            if _is_lazy(v):
                r = fresh.get(id(v.rid))
                if r is None:
                    old = v.rid
                    r = RowIds(old.idx,
                               keep if old.ok is None else (old.ok & keep),
                               parent=old.parent)
                    fresh[id(old)] = r
                self.slots[eid] = LazyCol(v.base, v.base_valid, r)
            else:
                d, val = v
                self.slots[eid] = (d, keep if val is None else (keep & val))

    def take_columns(self, order: torch.Tensor, eids) -> Tuple[list, list]:
        """The given columns at positions `order`, composing the permutation
        with pending gather maps (payload bytes are gathered once, at the
        final size)."""
        tmp = Chunk(attrs=[], slots=compose_slots(self, order, None),
                    alive=self.alive, capacity=int(order.shape[0]))
        tmp.ensure(eids)
        datas, valids = [], []
        for eid in eids:
            d, v = tmp.slots[eid]
            datas.append(d)
            valids.append(v)
        return datas, valids

    def broadcast(self, data, valid):
        """Ensure (data, valid) are full-capacity tensors (literals evaluate to
        0-d tensors). The result may be a stride-0 view."""
        data = torch.broadcast_to(data, (self.capacity,))
        if valid is not None:
            valid = torch.broadcast_to(valid, (self.capacity,))
        return data, valid

    def is_unique(self, ids: List[int]) -> bool:
        s = frozenset(ids)
        return any(u <= s for u in self.unique_sets)

    def fd_closure(self, ids: set) -> set:
        out = set(ids)
        changed = True
        while changed:
            changed = False
            for det, dep in self.fds:
                if det <= out and not dep <= out:
                    out |= dep
                    changed = True
        return out


def concat_chunks(chs: List[Chunk]) -> Chunk:
    """Row-concatenate materialized chunks of the same attrs (the shuffle
    join's per-shard and per-slice outputs; the reference's
    exec/runner.py:2104 _concat_join_chunks). A valid mask is kept where
    any part has one."""
    base = chs[0]
    slots = {}
    for a in base.attrs:
        parts = [c.slots[a.expr_id] for c in chs]
        any_v = any(v is not None for _d, v in parts)
        data = torch.cat([_full(d, c.capacity)
                          for (d, _v), c in zip(parts, chs)])
        valid = None
        if any_v:
            valid = torch.cat([
                _full(v, c.capacity) if v is not None else
                torch.ones(c.capacity, dtype=torch.bool, device=c.device)
                for (_d, v), c in zip(parts, chs)])
        slots[a.expr_id] = (data, valid)
    return Chunk(attrs=list(base.attrs), slots=slots,
                 alive=torch.cat([c.alive for c in chs]),
                 capacity=sum(c.capacity for c in chs),
                 ranges=dict(base.ranges))
