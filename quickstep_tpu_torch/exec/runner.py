"""PlanRunner: runs a logical plan eagerly, operator by operator, on torch.

The counterpart of quickstep_tpu/exec/runner.py: TableScan (with
TABLESAMPLE), Generator, Filter, Project, Aggregate down the scalar
(DISTINCT included), dense, sort and DISTINCT branches, equi-joins down the
FilterJoin (exact filter), direct-address, sorted-probe unique,
run-statistics semi, expansion and full outer paths, with hashed composite
keys verified on every candidate, nested-loops and cross joins, Sort and
Limit, Distinct, set operations, RowNumber, shared subplans (WITH),
uncorrelated scalar subqueries and window aggregates (ops/window.py).
Physical choices are made on the host from plan-time ranges, as in the
reference. Runtime fallbacks (duplicate build keys, expansion overflow,
compaction under-estimates) surface as 0-d device flags in `self.flags`
that the executor reads with the result and answers with a retry. A scalar
subquery is evaluated inside the plan, its value and presence kept as 0-d
device tensors, so the query keeps its one host sync.

Under a mesh (Config.distributed, parallel/mesh.py) these operators run
per shard, as the reference's shard_map bodies and its GSPMD partitioner
split them: the shuffle join (_shuffle_join: radix exchange of both sides
by join key, then the join core on each shard), the two-phase sort GROUP
BY (_dist_sort_groupby), the scalar aggregates without DISTINCT and the
dense GROUP BY (K1 and K2 on each shard's rows, the partial states folded
in shard order: _per_shard, the pattern of the reference's
parallel/dist.py distributed_agg_join_step), and the broadcast joins that
keep at most one build row a probe row (the exact filter, the unique
join: the probe side's rows as they are against the whole build side).
Their per-shard bodies run as a Python loop over the shards in shard
order; every other operator runs over the whole tensors, which on a
one-process mesh gives the rows the reference's GSPMD partitioning gives.
Over several processes (parallel/multihost.py) a chunk may hold only this
process's rows (Chunk.sharded): a table scan of a sharded table, Filter
and Project over such a chunk, the shuffle join's and a broadcast join's
output. The per-shard operators take it as it is and cross the processes
through the mesh's collectives; any other operator gets it gathered first
(`exec` without local=True, _whole: every process's rows in rank order,
which is the one-process mesh's chunk), as the GSPMD partitioner gathers
where it cannot partition (its sort GROUP BY over a wide key span:
quickstep_tpu/exec/runner.py:661-664), and each such gather is recorded
with its bytes and why it was made (Mesh.gathers). So every process
computes the one-process mesh's rows bit for bit, and takes every
decision that steers a collective from replicated values only: the plan,
the statistics, the capacities over every process (_gcap), and whether a
column has a validity tensor, which a sharded scan gives or omits alike
on every process (the host catalog's column decides it), so the dense
route's test for NULL keys needs no collective.

Capacities are row counts, not padded buckets, so any operator may meet an
input of zero rows: a gather into a source of zero rows yields invalid rows
of the index's length (exec/chunk.py, ops/kernels.py multi_gather).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from quickstep_tpu_torch.config import Config
from quickstep_tpu_torch.errors import ExecutionError
from quickstep_tpu_torch.expressions.scalar import Expr, Attr, Cmp
from quickstep_tpu_torch.optimizer import logical as L
from quickstep_tpu_torch.optimizer.logical import OutAttr
from quickstep_tpu_torch.optimizer.stats import infer_range
from quickstep_tpu_torch.exec.chunk import (
    Chunk, _full, compose_slots, concat_chunks, repeat_slots)
from quickstep_tpu_torch.ops import kernels as K
from quickstep_tpu_torch.ops import groupby as G
from quickstep_tpu_torch.ops import join as J
from quickstep_tpu_torch.ops import sort as S

# cross products above this many rows are refused (reference runner.py:1887)
CROSS_JOIN_LIMIT = 1 << 26
_SIGN = -(1 << 63)          # the int64 with only its sign bit set


def _gcap(chunk: Chunk, mesh) -> int:
    """The chunk's capacity over every process: the one-process mesh's
    capacity, which every capacity-driven decision reads."""
    return chunk.capacity * mesh.world if chunk.sharded else chunk.capacity


def _flip_cmp(op: str) -> str:
    return {"<": ">", "<=": ">=", ">": "<", ">=": "<=",
            "=": "=", "<>": "<>"}[op]


@dataclasses.dataclass
class JoinOverride:
    """Executor-supplied retry directives keyed by plan-node index."""
    strategy: Optional[str] = None    # 'expand' after a duplicate build key
    max_matches: Optional[int] = None  # expansion width after an overflow
    no_compact_probe: bool = False    # estimate-driven compaction overflowed
    no_compact_build: bool = False
    shuffle_factor: int = 1           # bucket-capacity escalation on shuffle overflow


class PlanRunner:
    # the most recent shuffle join's configuration (chunking, LIP filter
    # size, bucket rows), for tests and profiles: see _shuffle_join
    trace_shuffle_info: Optional[dict] = None

    def __init__(self, plan: L.LogicalNode,
                 inputs: Dict[str, Dict[str, object]],
                 input_meta: Dict[str, dict], config: Config,
                 device: torch.device,
                 overrides: Optional[Dict[int, JoinOverride]] = None,
                 mesh=None, subqueries: Optional[Dict[tuple, tuple]] = None):
        """inputs: relation name -> {attr name -> (data, valid), "__num_rows__"}.
        input_meta: relation name -> {capacity, ranges, unique_cols, ...}.
        overrides are keyed by structural (preorder) node indices so they
        survive re-resolution of the same query. mesh: the
        parallel/mesh.py Mesh that a distributed run shards over, or
        None. subqueries: scalar subqueries the executor already ran,
        ("subquery", id(plan)) -> (value, present), which are not run
        again."""
        self.mesh = mesh
        # a mesh over several processes: chunks may hold local rows
        self._per_process = mesh is not None and mesh.world > 1
        # the nodes being run, innermost last (a gather's consumer)
        self._running: List[L.LogicalNode] = []
        self.last_shuffle_info: Optional[dict] = None
        self.inputs = inputs
        self.input_meta = input_meta
        self.config = config
        self.device = device
        self.overrides = overrides or {}
        self.flags: Dict[str, torch.Tensor] = {}   # runtime check flags
        # shared subplans and scalar subqueries, run once per plan object
        self._memo: Dict[int, Chunk] = {}
        # ("subquery", id(plan)) -> (value, present): 0-d device tensors
        self._subquery_slots: Dict[tuple, tuple] = dict(subqueries or {})
        self.node_index: Dict[int, int] = {}
        self._assign_indices(plan, [0])

    def _assign_indices(self, node: L.LogicalNode, counter: List[int]):
        from quickstep_tpu_torch.exec.executor import _node_exprs
        from quickstep_tpu_torch.expressions.subquery import SubqueryScalar
        self.node_index[id(node)] = counter[0]
        counter[0] += 1
        for c in node.children():
            self._assign_indices(c, counter)
        # subquery plans embedded in expressions
        for e in _node_exprs(node):
            stack = [e]
            while stack:
                x = stack.pop()
                if isinstance(x, SubqueryScalar):
                    self._assign_indices(x.plan, counter)
                stack.extend(x.children())

    def exec(self, node: L.LogicalNode, local: bool = False) -> Chunk:
        """Run node. With local=True (a caller that runs per shard) its
        chunk may hold only this process's rows; otherwise such a chunk is
        gathered first (_whole)."""
        m = getattr(self, f"_exec_{type(node).__name__}", None)
        if m is None:
            raise ExecutionError(f"no executor for {type(node).__name__}")
        self._running.append(node)
        try:
            chunk = m(node)
        finally:
            self._running.pop()
        return chunk if local else self._whole(chunk, node)

    def result(self, node: L.LogicalNode) -> Chunk:
        """The plan's result, on every process: a sharded root chunk is
        gathered as its live rows alone, in rank order, which is their
        order on the one-process mesh (the executor's pull reads nothing
        else)."""
        return self._whole(self.exec(node, local=True), node, "result",
                           live_only=True)

    def _exec_memo(self, plan: L.LogicalNode) -> Chunk:
        """plan's chunk, run once per plan object (possibly sharded)."""
        key = id(plan)
        if key not in self._memo:
            self._memo[key] = self.exec(plan, local=True)
        return self._memo[key]

    def _whole(self, chunk: Chunk, src: Optional[L.LogicalNode] = None,
               why: str = "no per-shard form",
               live_only: bool = False) -> Chunk:
        """A sharded chunk's rows from every process, in rank order (one
        all_gather of its live mask and every attribute's data and
        validity), on every process; a chunk that is not sharded as it is.
        Each gather is recorded in mesh.gathers: the operator it feeds
        ("result" for the executor's pull), the one that made it, why, its
        rows and the bytes this process sent. With live_only, each process
        sends its live rows alone, in order, padded with dead rows to the
        most any process has (their counts cross first, and are read on
        the host)."""
        if not chunk.sharded:
            return chunk
        from quickstep_tpu_torch.parallel.mesh import all_gather
        mesh = self.mesh
        eids = [a.expr_id for a in chunk.attrs]
        sent = mesh.moved.get("gather", {}).get("bytes", 0)
        if live_only:
            count = chunk.alive.sum(dtype=torch.int64).reshape(1)
            counts = all_gather(mesh, [count], "gather")[0].tolist()
            rows, mine = max(counts), counts[mesh.rank]
            take = torch.zeros(rows, dtype=torch.int64, device=self.device)
            take[:mine] = K.stable_partition(chunk.alive, limit=mine)
            datas, valids = chunk.take_columns(take, eids)
            alive = torch.arange(rows, device=self.device) < mine
        else:
            rows = chunk.capacity
            chunk.ensure(eids)
            datas = [_full(chunk.slots[eid][0], rows) for eid in eids]
            valids = [chunk.slots[eid][1] for eid in eids]
            alive = chunk.alive
        tensors = [alive]
        for d, v in zip(datas, valids):
            tensors += [d, None if v is None else _full(v, rows)]
        g = all_gather(mesh, tensors, "gather")
        slots = {eid: (g[1 + 2 * i], g[2 + 2 * i])
                 for i, eid in enumerate(eids)}
        out = dataclasses.replace(chunk, slots=slots, alive=g[0],
                                  capacity=rows * mesh.world, sharded=False)
        into = self._running[-1] if self._running else None
        mesh.gathers.append({
            "into": type(into).__name__ if into is not None else "result",
            "from": type(src).__name__ if src is not None else "",
            "why": why,
            "rows": out.capacity,
            "bytes": mesh.moved["gather"]["bytes"] - sent})
        return out

    # ----------------------------------------------------------------
    # scan, shared subplans
    # ----------------------------------------------------------------
    def _exec_TableScan(self, node: L.TableScan) -> Chunk:
        cols = self.inputs[node.relation_name]
        meta = self.input_meta[node.relation_name]
        # a sharded table: this process's rows, from row `offset` on
        capacity = meta.get("local_capacity", meta["capacity"])
        offset = meta.get("offset", 0)
        slots = {}
        ranges = {}
        unique_sets = []
        max_counts = {}
        for a in node.attrs:
            slots[a.expr_id] = cols[a.name]
            ranges[a.expr_id] = meta["ranges"].get(a.name)
            mc = meta.get("max_counts", {}).get(a.name)
            if mc is not None:
                max_counts[a.expr_id] = mc
            if a.name in meta.get("unique_cols", ()):
                unique_sets.append(frozenset([a.expr_id]))
        by_name = {a.name: a.expr_id for a in node.attrs}
        for pair in meta.get("unique_pairs", ()):
            if all(p in by_name for p in pair):
                unique_sets.append(frozenset(by_name[p] for p in pair))
        alive = K.alive_mask(capacity, cols["__num_rows__"] - offset,
                             self.device)
        if node.sample_kind:
            # TUPLESAMPLE / BLOCKSAMPLE n PERCENT (SampleOperator.hpp:60): a
            # Bernoulli sample by the hash of the row index. The compare is
            # unsigned: both sides get their sign bit flipped.
            r = K.hash_keys([torch.arange(offset, offset + capacity,
                                          dtype=torch.int64,
                                          device=self.device)])
            thresh = min(int((node.sample_percent / 100.0) * (2 ** 64 - 1)),
                         2 ** 64 - 1)
            alive = alive & ((r ^ _SIGN) < thresh - 2 ** 63)
        all_ids = frozenset(a.expr_id for a in node.attrs)
        fds = [(u, all_ids) for u in unique_sets]
        return Chunk(attrs=list(node.attrs), slots=slots, alive=alive,
                     capacity=capacity, ranges=ranges, unique_sets=unique_sets,
                     fds=fds, max_counts=max_counts, bound=meta.get("rows"),
                     sharded=meta.get("sharded", False))

    def _exec_Generator(self, node: L.Generator) -> Chunk:
        """generate_series(start, end[, step]), integer or DOUBLE."""
        a = node.attrs[0]
        if a.type.is_floating or isinstance(node.step, float) or \
                isinstance(node.start, float) or isinstance(node.end, float):
            # DOUBLE series (generate_series(1, 3, 0.5)): the count takes a
            # small epsilon so that end lands inside despite rounding
            import math
            n = max(0, int(math.floor((node.end - node.start) / node.step
                                      + 1e-9)) + 1) if node.step else 0
            data = torch.arange(n, dtype=torch.float64,
                                device=self.device) * node.step + node.start
        else:
            n = max(0, (node.end - node.start) // node.step + 1) \
                if node.step != 0 else 0
            data = torch.arange(n, dtype=torch.int64,
                                device=self.device) * node.step + node.start
        return Chunk(attrs=list(node.attrs),
                     slots={a.expr_id: (data, None)},
                     alive=K.alive_mask(n, n, self.device), capacity=n,
                     ranges={a.expr_id: (min(node.start, node.end),
                                         max(node.start, node.end))})

    def _exec_SharedSubplan(self, node: L.SharedSubplan) -> Chunk:
        # materialized once, in the memoized chunk, so that every consumer
        # shares the gathered columns instead of gathering its own
        inner = self._exec_memo(node.plan).materialize_all()
        slots = {}
        ranges = {}
        for fresh, orig in zip(node.attrs, inner.attrs):
            slots[fresh.expr_id] = inner.slots[orig.expr_id]
            ranges[fresh.expr_id] = inner.ranges.get(orig.expr_id)
        remap = {o.expr_id: f.expr_id for f, o in zip(node.attrs, inner.attrs)}
        uniq = [frozenset(remap[i] for i in s) for s in inner.unique_sets
                if all(i in remap for i in s)]
        fds = [(frozenset(remap[i] for i in det),
                frozenset(remap[i] for i in dep if i in remap))
               for det, dep in inner.fds if all(i in remap for i in det)]
        return Chunk(attrs=list(node.attrs), slots=slots, alive=inner.alive,
                     capacity=inner.capacity, ranges=ranges, unique_sets=uniq,
                     fds=fds, max_counts={remap[i]: v for i, v in
                                          inner.max_counts.items()
                                          if i in remap},
                     sharded=inner.sharded)

    # ----------------------------------------------------------------
    # filter / project
    # ----------------------------------------------------------------
    def _eval(self, chunk: Chunk, e: Expr):
        self._bind_subqueries(e)
        # one gather per shared RowIds for every lazy column e reads
        chunk.ensure(e.referenced_attrs() & set(chunk.slots))
        return e.eval(chunk.ctx(extra=self._subquery_slots))

    def _bind_subqueries(self, e: Expr):
        """Run the uncorrelated scalar subqueries e reads (once per plan
        object) and bind (value, present) for SubqueryScalar.eval: the
        value of the first live row and whether any row is live, both 0-d
        device tensors that nothing reads on the host."""
        from quickstep_tpu_torch.expressions.subquery import SubqueryScalar
        stack = [e]
        while stack:
            x = stack.pop()
            if isinstance(x, SubqueryScalar):
                key = ("subquery", id(x.plan))
                if key not in self._subquery_slots:
                    sub = self._whole(self._exec_memo(x.plan), x.plan,
                                      "scalar subquery")
                    if sub.capacity == 0:
                        # no row: a NULL of the column's dtype
                        dt = K.torch_dtype(sub.attrs[0].type.device_dtype)
                        self._subquery_slots[key] = (
                            torch.zeros((), dtype=dt, device=self.device),
                            torch.zeros((), dtype=torch.bool,
                                        device=self.device))
                        stack.extend(x.children())
                        continue
                    data, valid = sub.broadcast(*sub.get(sub.attrs[0].expr_id))
                    first = torch.argmax(sub.alive.to(torch.uint8))
                    present = torch.any(sub.alive)
                    ok = present if valid is None else (present & valid[first])
                    self._subquery_slots[key] = (data[first], ok)
            stack.extend(x.children())

    def _eval_pred(self, chunk: Chunk, e: Expr):
        d, v = self._eval(chunk, e)
        d = torch.broadcast_to(d.to(torch.bool), (chunk.capacity,))
        if v is not None:
            d = d & torch.broadcast_to(v, (chunk.capacity,))
        return d

    def _exec_Filter(self, node: L.Filter) -> Chunk:
        chunk = self.exec(node.input, local=True)
        passed = self._eval_pred(chunk, node.predicate)
        return dataclasses.replace(chunk, alive=chunk.alive & passed)

    def _exec_Project(self, node: L.Project) -> Chunk:
        chunk = self.exec(node.input, local=True)
        slots = {}
        ranges = {}
        for e, a in zip(node.exprs, node.attrs):
            if isinstance(e, Attr) and e.expr_id in chunk.slots:
                cur = chunk.slots[e.expr_id]
                if getattr(cur, "lazy", False) and cur.base.dtype == \
                        K.torch_dtype(a.type.device_dtype):
                    # pass-through attr: the gather map stays lazy
                    slots[a.expr_id] = cur
                    ranges[a.expr_id] = infer_range(e, chunk.ranges)
                    continue
            d, v = self._eval(chunk, e)
            d, v = chunk.broadcast(d.to(K.torch_dtype(a.type.device_dtype)), v)
            slots[a.expr_id] = (d, v)
            ranges[a.expr_id] = infer_range(e, chunk.ranges)
        # uniqueness/FDs survive for pass-through attrs
        passthru = {e.expr_id: a.expr_id for e, a in zip(node.exprs, node.attrs)
                    if isinstance(e, Attr)}
        uniq = [frozenset(passthru[i] for i in s)
                for s in chunk.unique_sets if all(i in passthru for i in s)]
        fds = [(frozenset(passthru[i] for i in det),
                frozenset(passthru[i] for i in dep if i in passthru))
               for det, dep in chunk.fds if all(i in passthru for i in det)]
        mcs = {a: chunk.max_counts[i] for i, a in passthru.items()
               if i in chunk.max_counts}
        return Chunk(attrs=list(node.attrs), slots=slots, alive=chunk.alive,
                     capacity=chunk.capacity, bound=chunk.bound, ranges=ranges,
                     unique_sets=uniq, fds=fds, max_counts=mcs,
                     sharded=chunk.sharded)

    # ----------------------------------------------------------------
    # aggregate
    # ----------------------------------------------------------------
    def _agg_input(self, chunk: Chunk, spec):
        """(fn, values, valid) of one aggregate, as the kernels take them:
        full-capacity contiguous tensors, integer and DECIMAL sums in int64."""
        if spec.arg is None:
            return spec.fn, None, None
        d, v = self._eval(chunk, spec.arg)
        d, v = chunk.broadcast(d, v)
        if spec.fn in ("sum", "avg") and (spec.arg.type.is_integral or
                                          spec.arg.type.is_decimal):
            d = d.to(torch.int64)
        return (spec.fn, d.contiguous(),
                None if v is None else v.contiguous())

    def _exec_Aggregate(self, node: L.Aggregate) -> Chunk:
        """GROUP BY and scalar aggregates. A sharded input is gathered
        first where _agg_route gives a reason."""
        chunk = self.exec(node.input, local=True)
        if chunk.sharded:
            why = self._agg_route(node, chunk)
            if why is not None:
                chunk = self._whole(chunk, node.input, why)
        return self._aggregate(node, chunk)

    def _agg_route(self, node: L.Aggregate, chunk: Chunk) -> Optional[str]:
        """Why a sharded chunk is gathered before the aggregate, or None
        where it is reduced as it is: a scalar aggregate or a dense GROUP
        BY (a domain _dense_ok takes) per shard, or the two-phase sort
        GROUP BY. Decided before any key is evaluated, from the plan, the
        ranges and the capacity over every process. A dense domain whose
        keys turn out nullable leaves the dense route once they are
        evaluated (_aggregate): that chunk takes the two-phase GROUP BY, or
        is gathered then."""
        if any(s.distinct for s in node.aggregates):
            return "DISTINCT aggregate"
        if not self._splits(chunk):
            return "capacity does not split into the shards"
        if not node.group_by:
            return None
        key_ranges = [infer_range(ge, chunk.ranges) for ge in node.group_by]
        if self._dense_ok(key_ranges, [None] * len(key_ranges)) or \
                self._two_phase_sort(node, chunk):
            return None
        return "sort GROUP BY outside the two-phase route"

    def _two_phase_sort(self, node: L.Aggregate, chunk: Chunk) -> bool:
        """Whether the sort GROUP BY of node over chunk takes the two-phase
        route (_dist_sort_groupby): no DISTINCT aggregate, no key deferred
        to a representative row, sort keys of known integer ranges, and a
        domain _two_phase_ok takes."""
        if not node.group_by or any(s.distinct for s in node.aggregates):
            return False
        keep = self._reduce_group_keys(node.group_by, chunk)
        if self._deferred_keys(node, chunk, keep):
            return False
        span_total = 1
        for i in keep:
            r = infer_range(node.group_by[i], chunk.ranges)
            dt = K.torch_dtype(node.group_by[i].type.device_dtype)
            if r is None or dt.is_floating_point:
                return False
            span_total *= r[1] - r[0] + 2
        return self._two_phase_ok(_gcap(chunk, self.mesh), span_total)

    def _splits(self, chunk: Chunk) -> bool:
        """Whether a per-shard aggregate takes chunk: a mesh of several
        shards and a capacity over every process that splits into equal
        shard row ranges (replicated facts: every process decides alike)."""
        mesh = self.mesh
        return mesh is not None and mesh.n > 1 and \
            _gcap(chunk, mesh) % mesh.n == 0

    def _shard_slices(self, chunk: Chunk) -> List[slice]:
        """The row ranges of chunk that this process reduces, in shard
        order: its local shards' of a sharded chunk; every shard's of a
        whole one, which each process folds itself, with no collective."""
        parts = self.mesh.local_n if chunk.sharded else self.mesh.n
        per = chunk.capacity // parts
        return [slice(i * per, (i + 1) * per) for i in range(parts)]

    def _per_shard(self, chunk: Chunk, reduce, agg_inputs):
        """reduce(slice, specs) -> (flags, results) on each shard's rows
        (_shard_slices), with the aggregates' specs cut to the shard
        (ops/groupby.py partial_specs); the flags are OR'd and the partial
        states folded in shard order (parallel/mesh.py fold_partials: over
        the processes for a sharded chunk). Returns (the folded flags, the
        merged results)."""
        from quickstep_tpu_torch.parallel.mesh import fold_partials
        parts = []
        for sl in self._shard_slices(chunk):
            specs = [(fn, None if v is None else _full(v, chunk.capacity)[sl],
                      None if vd is None else _full(vd, chunk.capacity)[sl])
                     for fn, v, vd in G.partial_specs(agg_inputs)]
            flags, res = reduce(sl, specs)
            parts.append([("or", f) for f in flags] +
                         G.partial_states(agg_inputs, res))
        folded = fold_partials(self.mesh, parts, local=chunk.sharded)
        return folded[:len(flags)], G.merge_partials(agg_inputs,
                                                     folded[len(flags):])

    def _deferred_keys(self, node: L.Aggregate, chunk: Chunk,
                       keep: List[int]) -> set:
        """The group keys deferred to each group's representative row:
        outside the minimal sort cover `keep`, a plain Attr over a non-null
        slot with the output dtype (none with a DISTINCT aggregate)."""
        defer = set()
        if any(s.distinct for s in node.aggregates):
            return defer
        for i, ge in enumerate(node.group_by):
            if i in keep or not isinstance(ge, Attr):
                continue
            src = chunk.slots.get(ge.expr_id)
            if src is None:
                continue
            if getattr(src, "lazy", False):
                nonnull = src.base_valid is None and src.rid.chain_ok_none()
                base = src.base
            else:
                nonnull = src[1] is None
                base = src[0]
            if nonnull and base.dim() != 0 and base.dtype == K.torch_dtype(
                    node.group_attrs[i].type.device_dtype):
                defer.add(i)
        return defer

    def _aggregate(self, node: L.Aggregate, chunk: Chunk) -> Chunk:
        """The aggregate over chunk; a sharded chunk is one that _agg_route
        reduces as it is."""
        distinct_flags = [s.distinct for s in node.aggregates]
        if not node.group_by:
            return self._scalar_aggregate(node, chunk)

        # Estimate-driven compaction of the aggregate input (same protocol
        # and retry flag as pre-join compaction): the sort runs at its input
        # capacity, so a selective upstream pays off only when the live rows
        # are compacted first.
        idx0 = self.node_index[id(node)]
        chunk = self._est_compact(chunk, node.est_input_rows,
                                  self._no_compact(idx0, "probe"),
                                  f"compact_probe_{idx0}")

        # snapshot slots BEFORE key evaluation: evaluation materializes lazy
        # columns, and the sort path fetches FD-determined group keys lazily
        # (per group, from a representative row)
        pre_slots = dict(chunk.slots)

        # Decide FD-deferral before evaluating any key, so that a deferred
        # key is never gathered at input capacity.
        keep = self._reduce_group_keys(node.group_by, chunk)
        defer = self._deferred_keys(node, chunk, keep)

        key_ranges = [infer_range(ge, chunk.ranges) for ge in node.group_by]

        def eval_keys(skip: set):
            # one gather per shared RowIds for everything the evaluated keys
            # and the aggregate inputs read, then evaluate
            need = set()
            for i, ge in enumerate(node.group_by):
                if i not in skip:
                    need |= ge.referenced_attrs()
            for spec in node.aggregates:
                if spec.arg is not None:
                    need |= spec.arg.referenced_attrs()
            chunk.ensure([e for e in need if e in chunk.slots])
            kd, kv = [], []
            for i, ge in enumerate(node.group_by):
                if i in skip:
                    kd.append(None)
                    kv.append(None)
                    continue
                d, v = chunk.broadcast(*self._eval(chunk, ge))
                kd.append(d)
                kv.append(v)
            return kd, kv

        key_data, key_valid = eval_keys(defer)
        use_dense = self._dense_ok(key_ranges, key_valid)
        if chunk.sharded and not use_dense and \
                not self._two_phase_sort(node, chunk):
            # nullable keys left the dense route, and the sort route has no
            # per-shard form here: whether a key has a validity tensor is
            # replicated, so every process gathers
            return self._aggregate(node, self._whole(
                chunk, node.input, "nullable keys of a dense domain"))
        if use_dense and defer:
            # dense needs every key materialized (tiny domains only)
            defer = set()
            key_data, key_valid = eval_keys(defer)

        # Rows with a NULL group key are skipped, as the reference's hash
        # tables never insert NULL keys. Deferred keys are non-null.
        alive = chunk.alive
        for v in key_valid:
            if v is not None:
                alive = alive & v
        if alive is not chunk.alive:
            chunk = dataclasses.replace(chunk, alive=alive)

        agg_inputs = [self._agg_input(chunk, spec) for spec in node.aggregates]
        if any(distinct_flags):
            return self._distinct_aggregate(node, chunk, key_data, key_valid,
                                            agg_inputs, distinct_flags)
        if use_dense:
            return self._dense_aggregate(node, chunk, key_data, key_ranges,
                                         agg_inputs)
        return self._sort_aggregate(node, chunk, key_data, key_valid,
                                    agg_inputs, key_ranges, pre_slots, keep,
                                    defer)

    def _dense_ok(self, key_ranges, key_valid) -> bool:
        if self.config.aggregate_hashtable_type == "sort":
            return False
        if any(v is not None for v in key_valid):
            return False   # nullable keys: use sort path (null group)
        if len(key_ranges) > G.MAX_DENSE_KEYS:
            return False   # more key columns than the dense kernel packs
        domain = 1
        for r in key_ranges:
            if r is None:
                return False
            domain *= (r[1] - r[0] + 1)
            if domain > self.config.collision_free_domain_limit:
                return False
        return domain <= G.BROADCAST_DOMAIN_LIMIT

    def _dense_layout(self, key_ranges):
        offsets = [r[0] for r in key_ranges]
        sizes = [r[1] - r[0] + 1 for r in key_ranges]
        strides = []
        acc = 1
        for s in reversed(sizes):
            strides.append(acc)
            acc *= s
        strides = list(reversed(strides))
        return offsets, sizes, strides, acc

    def _dense_aggregate(self, node, chunk, key_data, key_ranges, agg_inputs):
        """The dense GROUP BY (K2). Under a mesh whose shards split the
        chunk, K2 runs on each shard's rows into the domain-sized table and
        the tables fold in shard order (occupied by por, sums and counts by
        psum, MIN and MAX by pmin and pmax); the output step runs once, on
        the folded table."""
        offsets, sizes, strides, domain = self._dense_layout(key_ranges)
        if self._splits(chunk):
            def reduce(sl, specs):
                occ, res = G.dense_aggregate(
                    [_full(k, chunk.capacity)[sl] for k in key_data],
                    offsets, strides, domain, specs, chunk.alive[sl])
                return [occ], res
            (occupied,), results = self._per_shard(chunk, reduce, agg_inputs)
        else:
            occupied, results = G.dense_aggregate(
                key_data, offsets, strides, domain, agg_inputs, chunk.alive)
        # reconstruct group keys by unpacking the dense index
        gidx = torch.arange(domain, dtype=torch.int64, device=chunk.device)
        slots = {}
        ranges = {}
        for a, off, size, stride, r in zip(node.group_attrs, offsets, sizes,
                                           strides, key_ranges):
            vals = (gidx // stride) % size + off
            slots[a.expr_id] = (vals.to(K.torch_dtype(a.type.device_dtype)),
                                None)
            ranges[a.expr_id] = r
        self._fill_agg_slots(node, results, slots)
        uniq = [frozenset(a.expr_id for a in node.group_attrs)]
        fds = [(uniq[0], frozenset(a.expr_id for a in node.output))]
        return Chunk(attrs=list(node.output), slots=slots, alive=occupied,
                     capacity=domain, ranges=ranges, unique_sets=uniq, fds=fds)

    def _pack_sort_key(self, key_data, key_valid, key_ranges,
                       descending=None, nulls_first=None):
        """Pack integer composite keys into one int32/int64 sort key when
        their ranges fit. For a group-by (descending None) NULLs take the
        last slot of their key's span; for ORDER BY a DESC key counts down
        and NULLs take the first or last slot (SQL default: last for ASC,
        first for DESC). Returns None when not packable (unknown range,
        float keys)."""
        spans = []
        for d, r in zip(key_data, key_ranges):
            if r is None or d.dtype.is_floating_point:
                return None
            spans.append(r[1] - r[0] + 2)  # +1 slot for NULL
        total = 1
        for span in spans:
            total *= span
        if total >= 2 ** 62:
            return None
        packed = torch.zeros(key_data[0].shape, dtype=torch.int64,
                             device=self.device)
        for i, (d, v, r, span) in enumerate(zip(key_data, key_valid,
                                                key_ranges, spans)):
            lo, hi = r
            enc = d.to(torch.int64) - lo
            if descending is not None and descending[i]:
                enc = (hi - lo) - enc
            if v is not None:
                first = False     # group-by: the NULL group last
                if descending is not None:
                    nf = nulls_first[i] if nulls_first is not None else None
                    first = nf if nf is not None else descending[i]
                if first:
                    enc = torch.where(v, enc + 1, torch.zeros_like(enc))
                else:
                    enc = torch.where(v, enc, torch.full_like(enc, span - 1))
            packed = packed * span + enc
        if total < 2 ** 31:
            packed = packed.to(torch.int32)
        return packed

    def _reduce_group_keys(self, group_by, chunk: Chunk) -> List[int]:
        """Minimal sort-key cover: drop group keys functionally determined by
        the remaining ones (reference ReduceGroupByAttributes rule)."""
        ids = [e.expr_id if isinstance(e, Attr) else None for e in group_by]
        keep = list(range(len(group_by)))
        changed = True
        while changed:
            changed = False
            for i in list(keep):
                if ids[i] is None:
                    continue
                others = {ids[j] for j in keep if j != i and ids[j] is not None}
                if ids[i] in chunk.fd_closure(others):
                    keep.remove(i)
                    changed = True
        return keep

    def _sort_aggregate(self, node, chunk, key_data, key_valid, agg_inputs,
                        key_ranges, pre_slots, keep, defer):
        """Sort GROUP BY over the minimal key cover `keep`. FD-determined
        keys in `defer` ride neither the sort nor a full-capacity gather:
        each group's value is a LazyCol over its representative row."""
        defer = sorted(defer)
        carried = [i for i in range(len(key_data)) if i not in defer]
        sub_positions = [carried.index(i) for i in keep if i in carried]
        packed = self._pack_sort_key([key_data[i] for i in keep],
                                     [key_valid[i] for i in keep],
                                     [key_ranges[i] for i in keep])
        dist = None
        if not defer and packed is not None:
            span_total = 1
            for i in keep:
                span_total *= key_ranges[i][1] - key_ranges[i][0] + 2
            dist = self._dist_sort_groupby(
                [key_data[i] for i in carried],
                [key_valid[i] for i in carried], agg_inputs, chunk.alive,
                packed, sub_positions, span_total,
                [key_ranges[i] for i in keep], chunk.sharded)
        assert dist is not None or not chunk.sharded, \
            "a sharded chunk reached the one-phase sort GROUP BY"
        capacity = chunk.capacity
        if dist is not None:
            out_keys, out_valids, occupied, results, capacity = dist
        else:
            out_keys, out_valids, occupied, _n_groups, results, rep_rows = \
                G.sort_groupby([key_data[i] for i in carried],
                               [key_valid[i] for i in carried],
                               agg_inputs, chunk.alive, packed_key=packed,
                               sort_subset=sub_positions, want_rows=True)
        slots = {}
        ranges = {}
        for pos, i in enumerate(carried):
            a, ge = node.group_attrs[i], node.group_by[i]
            slots[a.expr_id] = (
                out_keys[pos].to(K.torch_dtype(a.type.device_dtype)),
                out_valids[pos])
            ranges[a.expr_id] = infer_range(ge, chunk.ranges)
        if defer:
            tmp = dataclasses.replace(chunk, slots={
                node.group_by[i].expr_id: pre_slots[node.group_by[i].expr_id]
                for i in defer})
            lazy_src = compose_slots(tmp, rep_rows, None)
            for i in defer:
                a, ge = node.group_attrs[i], node.group_by[i]
                slots[a.expr_id] = lazy_src[ge.expr_id]
                ranges[a.expr_id] = infer_range(ge, chunk.ranges)
        self._fill_agg_slots(node, results, slots)
        uniq = [frozenset(a.expr_id for a in node.group_attrs)]
        fds = [(uniq[0], frozenset(a.expr_id for a in node.output))]
        return Chunk(attrs=list(node.output), slots=slots, alive=occupied,
                     capacity=capacity, ranges=ranges,
                     unique_sets=uniq, fds=fds)

    def _dist_sort_groupby(self, key_data, key_valid, agg_inputs, alive,
                           packed, sort_subset, span_total, keep_ranges,
                           sharded=False):
        """Two-phase sort GROUP BY over the mesh (quickstep_tpu/exec/
        runner.py:656, the reference's per-partition AggregationOperator
        and FinalizeAggregationOperator split). Phase 1, per shard: the sort
        group-by of its row range, its groups compacted to a prefix of
        cap_p >= the key domain's span rows (so no shard's groups can
        overflow it). Phase 2: one sort group-by over the n * cap_p partial
        rows with merge aggregates (count -> sum, sum -> sum, min/max ->
        min/max, avg -> sum / count). Phase 1 runs on this process's
        shards, of its rows where the input is sharded, else of the whole
        input; the partial rows are gathered to every process in shard order
        (all_gather) and phase 2 runs on each. Returns (out_keys,
        out_valids, occupied, results, capacity) in sort_groupby's shape,
        or None where it does not apply (unknown key domain, or
        _two_phase_ok refuses it)."""
        from quickstep_tpu_torch.parallel.mesh import all_gather
        held = alive.shape[0]
        cap = held * self.mesh.world if sharded else held
        if packed is None or not self._two_phase_ok(cap, span_total):
            return None
        mesh = self.mesh
        n = mesh.n
        lc = cap // n
        cap_p = K.next_pow2(max(8, span_total))
        # phase-1 aggregates: avg splits into its mergeable sum and count
        p_specs = [("sum" if fn == "avg" else fn, v, vd)
                   for fn, v, vd in agg_inputs]
        nk = len(key_data)

        def cut(t, sl):
            return None if t is None else _full(t, held)[sl]

        parts = []
        for i in (range(mesh.local_n) if sharded else mesh.local_ids):
            sl = slice(i * lc, (i + 1) * lc)
            out_k, out_v, occ, ng, res = G.sort_groupby(
                [cut(d, sl) for d in key_data],
                [cut(v, sl) for v in key_valid],
                [(fn, cut(v, sl), cut(vd, sl)) for fn, v, vd in p_specs],
                alive[sl], packed_key=packed[sl], sort_subset=sort_subset)
            order = K.stable_partition(occ, limit=cap_p)
            # re-pack the sorted key columns (out_k and out_v line up with
            # occ; the input's packed key does not)
            pk_sorted = self._pack_sort_key(
                [out_k[p] for p in sort_subset],
                [out_v[p] for p in sort_subset], keep_ranges)
            sent = torch.full((), torch.iinfo(pk_sorted.dtype).max,
                              dtype=pk_sorted.dtype, device=self.device)
            flat = [torch.where(occ, pk_sorted, sent)] + list(out_k) + \
                list(out_v) + [d for d, _nn in res] + [nn for _d, nn in res]
            g = K.multi_gather(flat, order)
            row_ok = torch.arange(cap_p, device=self.device) < ng
            parts.append(g + [row_ok])
        merged = all_gather(mesh, [
            None if parts[0][j] is None else torch.cat([p[j] for p in parts])
            for j in range(len(parts[0]))])
        pk_m = merged[0]
        kd_m = merged[1:1 + nk]
        kv_m = merged[1 + nk:1 + 2 * nk]
        r = len(p_specs)
        datas_m = merged[1 + 2 * nk:1 + 2 * nk + r]
        nns_m = merged[1 + 2 * nk + r:1 + 2 * nk + 2 * r]
        row_ok = merged[-1]

        # phase 2: merge the partial states (n * cap_p rows)
        m_specs = []
        layout = []   # per aggregate: (kind, data index, count index)
        for i, (fn, _v, _vd) in enumerate(agg_inputs):
            if fn == "count":
                layout.append(("count", len(m_specs), None))
                m_specs.append(("sum", nns_m[i].to(torch.int64), None))
            else:
                di = len(m_specs)
                m_specs.append((fn if fn in ("min", "max") else "sum",
                                datas_m[i],
                                (nns_m[i] > 0) if fn in ("min", "max")
                                else None))
                ni = len(m_specs)
                m_specs.append(("sum", nns_m[i].to(torch.int64), None))
                layout.append((fn, di, ni))
        out_keys, out_valids, occupied, _ng, m_res = G.sort_groupby(
            kd_m, kv_m, m_specs, row_ok, packed_key=pk_m,
            sort_subset=sort_subset)
        results = []
        for kind, di, ni in layout:
            if kind == "count":
                cnt = m_res[di][0]
                results.append((cnt, cnt))
            else:
                data, nn = m_res[di][0], m_res[ni][0]
                if kind == "avg":
                    data = data.to(torch.float64) / torch.clamp(nn, min=1)
                results.append((data, nn))
        return out_keys, out_valids, occupied, results, n * cap_p

    def _two_phase_ok(self, cap: int, span_total: int) -> bool:
        """Whether the two-phase GROUP BY takes an input of cap rows over
        every process whose packed key spans span_total values: a mesh of
        several shards that divide cap, and partials (each shard's groups,
        in the span rounded up to a power of two) at most half a shard."""
        mesh = self.mesh
        if mesh is None or not self.config.use_partition_rule or \
                mesh.n <= 1 or cap % mesh.n or span_total >= 2 ** 31:
            return False
        return K.next_pow2(max(8, span_total)) <= cap // mesh.n // 2

    def _fill_agg_slots(self, node, results, slots):
        for spec, a, (data, nn) in zip(node.aggregates, node.agg_attrs, results):
            data = data.to(K.torch_dtype(a.type.device_dtype))
            if spec.fn == "count":
                slots[a.expr_id] = (data, None)
            else:
                slots[a.expr_id] = (data, nn > 0)

    def _scalar_aggregate(self, node: L.Aggregate, chunk: Chunk) -> Chunk:
        """One output row, capacity 8 as in the reference. Without DISTINCT
        under a mesh whose shards split the chunk, K1 runs on each shard's
        rows and each value and its non-null count fold in shard order
        (sums and counts by psum, MIN and MAX by pmin and pmax, AVG their
        folded sum over the folded count)."""
        capacity = 8
        alive = K.alive_mask(capacity, 1, chunk.device)
        agg_inputs = [self._agg_input(chunk, spec) for spec in node.aggregates]
        if self._splits(chunk) and \
                not any(s.distinct for s in node.aggregates):
            def reduce(sl, specs):
                return [], [G.scalar_agg(fn, v, vd, chunk.alive[sl])
                            for fn, v, vd in specs]
            _, results = self._per_shard(chunk, reduce, agg_inputs)
        else:
            results = [self._scalar_whole(spec, inp, chunk.alive)
                       for spec, inp in zip(node.aggregates, agg_inputs)]
        slots = {}
        for spec, a, (val, nn) in zip(node.aggregates, node.agg_attrs,
                                      results):
            data = torch.broadcast_to(
                val.to(K.torch_dtype(a.type.device_dtype)), (capacity,))
            if spec.fn == "count":
                slots[a.expr_id] = (data, None)
            else:
                slots[a.expr_id] = (data, alive & (nn > 0))
        return Chunk(attrs=list(node.output), slots=slots, alive=alive,
                     capacity=capacity, ranges={})

    @staticmethod
    def _scalar_whole(spec, agg_input, live):
        """(value, non-null count) of one scalar aggregate over every row."""
        fn, vals, valid = agg_input
        if spec.distinct and fn == "count":
            return (G.distinct_count(vals, valid, live),
                    torch.ones((), dtype=torch.int64, device=live.device))
        if spec.distinct:
            # SUM/AVG/MIN/MAX DISTINCT: each distinct live value once
            s, starts = G.dedup_values(vals, valid, live)
            return G.scalar_agg(fn, s, None, starts)
        return G.scalar_agg(fn, vals, valid, live)

    def _distinct_aggregate(self, node, chunk, key_data, key_valid,
                            agg_inputs, distinct_flags):
        """DISTINCT aggregates: each distinct argument is deduplicated with
        its group keys by one sort group-by (no aggregates), then aggregated
        per group; the other aggregates run on the raw input. Every result
        comes from sort_groupby_compact, whose groups sit at rows
        [0, n_groups) in key order, so the results line up row for row (the
        reference's distinctify tables,
        storage/AggregationOperationState.cpp)."""
        results = [None] * len(agg_inputs)
        base = None                  # (keys, key valids, n_groups)
        plain = [ai for ai, f in zip(agg_inputs, distinct_flags) if not f]
        if plain:
            keys, valids, n_groups, res = G.sort_groupby_compact(
                key_data, key_valid, plain, chunk.alive)
            base = (keys, valids, n_groups)
            it = iter(res)
            for i, f in enumerate(distinct_flags):
                if not f:
                    results[i] = next(it)
        for i, ((fn, vals, valid), f) in enumerate(zip(agg_inputs,
                                                       distinct_flags)):
            if not f:
                continue
            dk, dv, d_alive, _n, _ = G.sort_groupby(
                key_data + [vals], key_valid + [valid], [], chunk.alive)
            keys, valids, n_groups, res = G.sort_groupby_compact(
                dk[:-1], dv[:-1], [(fn, dk[-1], dv[-1])], d_alive)
            results[i] = res[0]
            if base is None:
                base = (keys, valids, n_groups)
        keys, valids, n_groups = base
        slots = {}
        ranges = {}
        for a, kd, kv, ge in zip(node.group_attrs, keys, valids,
                                 node.group_by):
            slots[a.expr_id] = (kd.to(K.torch_dtype(a.type.device_dtype)), kv)
            ranges[a.expr_id] = infer_range(ge, chunk.ranges)
        self._fill_agg_slots(node, results, slots)
        alive = torch.arange(chunk.capacity, device=chunk.device) < n_groups
        return Chunk(attrs=list(node.output), slots=slots, alive=alive,
                     capacity=chunk.capacity, ranges=ranges,
                     unique_sets=[frozenset(a.expr_id
                                            for a in node.group_attrs)])

    # ----------------------------------------------------------------
    # joins
    # ----------------------------------------------------------------
    def _no_compact(self, idx: int, side: str) -> bool:
        attr = f"no_compact_{side}"
        return any(ov is not None and getattr(ov, attr)
                   for ov in (self.overrides.get(idx), self.overrides.get(-1)))

    def _exec_Join(self, node: L.Join) -> Chunk:
        if node.kind == "cross":
            return self._cross_join(node)
        if not node.left_keys:
            return self._nested_loops_join(node)
        # A side may hold only this process's rows (a multi-process mesh):
        # the shuffle join runs per shard; the exact filter and the unique
        # join, whose output rows are probe rows, run on the probe's rows
        # as they are against the whole build side; the other routes gather
        # both sides. The keys are evaluated before the route is decided,
        # since the shuffle reads whether a key has NULLs; a gathered side's
        # keys are evaluated again (a lookup for a plain column).
        probe = self._squeeze(self.exec(node.left, local=True))
        build = self._squeeze(self.exec(node.right, local=True))
        # Estimate-driven dynamic compaction: compact each side to ~4x its
        # cost-model estimate before any join gather; an under-estimate
        # raises a flag and the executor re-runs without it.
        idx0 = self.node_index[id(node)]
        probe = self._est_compact(probe, node.est_left_rows,
                                  self._no_compact(idx0, "probe"),
                                  f"compact_probe_{idx0}")
        build = self._est_compact(build, node.est_right_rows,
                                  self._no_compact(idx0, "build"),
                                  f"compact_build_{idx0}")
        keys = self._join_keys(node, probe, build)
        ov = self.overrides.get(idx0)
        route, strategy, build_unique = self._join_route(node, probe, build,
                                                         keys, ov)
        per_probe = route == "filter" or (route == "local" and
                                          strategy == "unique")
        if route != "shuffle" and (build.sharded or (
                probe.sharded and not per_probe)):
            how = route if strategy is None else f"{route} {strategy}"
            probe = probe if per_probe else self._whole(
                probe, node.left, f"probe side of the {how} join")
            build = self._whole(build, node.right,
                                f"build side of the {how} join")
            keys = self._join_keys(node, probe, build)
        pk_data, pk_valid0, pk_valid, bk_data, bk_valid0, bk_valid = keys
        # SQL equality never matches NULL keys: rows whose key is NULL are
        # excluded from matching (but still surface as unmatched rows in
        # left and anti joins).
        pmask = probe.alive if pk_valid is None else (probe.alive & pk_valid)
        bmask = build.alive if bk_valid is None else (build.alive & bk_valid)

        def na_correct(out):
            """[NOT] IN three-valued logic: a NULL operand never passes
            against a non-empty inner side; NOT IN passes nothing when the
            inner side holds a NULL. Device tensors throughout: no sync."""
            if not node.null_aware or node.kind not in ("semi", "anti"):
                return out
            alive = out.alive
            if pk_valid0 is not None:
                if node.kind == "semi":
                    alive = alive & pk_valid0
                else:
                    alive = alive & (pk_valid0 | ~torch.any(build.alive))
            if node.kind == "anti" and bk_valid0 is not None:
                alive = alive & ~torch.any(build.alive & ~bk_valid0)
            return dataclasses.replace(out, alive=alive)

        if route == "filter":
            # FilterJoin strength reduction: semi/anti joins over one
            # ranged integer key need only the exact presence filter.
            from quickstep_tpu_torch.ops import bloom as B
            r = self._key_ranges(node.right_keys, build)[0]
            lo, domain = r[0], r[1] - r[0] + 1
            bits = B.exact_filter_build(bk_data[0], bmask, lo, domain)
            matched = B.exact_filter_probe(bits, pk_data[0], pmask, lo)
            if node.kind == "anti":
                matched = probe.alive & ~matched
            return na_correct(dataclasses.replace(
                probe, alive=probe.alive & matched))
        if route == "full":
            return self._full_join(node, probe, build, pk_data, bk_data, ov,
                                   build_unique, pmask, bmask)
        if route == "semi_stats":
            out = self._semi_stats_join(node, probe, build, pk_data, bk_data,
                                        pmask, bmask)
            if out is not None:
                return na_correct(out)
            route = "shuffle" if self._shuffles(node, probe, build, keys) \
                else "local"
        if route == "shuffle":
            return na_correct(self._shuffle_join(
                node, probe, build, pk_data, bk_data, ov, strategy,
                build_unique))
        return na_correct(self._join_local(
            node, probe, build, pk_data, bk_data, strategy, build_unique,
            pmask, bmask))

    def _join_keys(self, node, probe, build):
        """Each side's join key columns at its capacity, the first key's
        validity and the AND of every key's: (pk_data, pk_valid0, pk_valid,
        bk_data, bk_valid0, bk_valid), validities None where no key has
        NULLs."""
        out = []
        for chunk, exprs in ((probe, node.left_keys),
                             (build, node.right_keys)):
            data, valid0, valid = [], None, None
            for i, e in enumerate(exprs):
                d, v = chunk.broadcast(*self._eval(chunk, e))
                if i == 0:
                    valid0 = v
                if v is not None:
                    valid = v if valid is None else (valid & v)
                data.append(d)
            out += [data, valid0, valid]
        return tuple(out)

    def _join_route(self, node, probe, build, keys, ov):
        """(route, strategy, build_unique) of an equi-join, decided from
        the plan, the statistics and the capacities over every process
        alone: "filter" (the FilterJoin's exact presence filter), "full",
        "semi_stats" (which may fall back to the next two), "shuffle" or
        "local" (the join core on the whole sides)."""
        bk_data = keys[3]
        # FilterJoin strength reduction: semi/anti joins over one ranged
        # integer key need only the exact presence filter.
        if node.kind in ("semi", "anti") and node.residual is None and \
                len(bk_data) == 1 and self.config.use_filter_joins:
            r = self._key_ranges(node.right_keys, build)[0]
            bcap, pcap = _gcap(build, self.mesh), _gcap(probe, self.mesh)
            if r is not None and (r[1] - r[0] + 1) <= \
                    self.config.direct_join_domain_limit and \
                    (r[1] - r[0] + 1) <= max(
                        int(self.config.direct_join_density * bcap),
                        4 * pcap):
                return "filter", None, None
        build_key_ids = [e.expr_id for e in node.right_keys
                         if isinstance(e, Attr)]
        build_unique = (len(build_key_ids) == len(node.right_keys)) and \
            build.is_unique(build_key_ids)
        if node.kind == "full":
            return "full", None, build_unique
        if ov and ov.strategy:
            strategy = ov.strategy
        elif build_unique or node.kind in ("semi", "anti"):
            # semi/anti need only existence: duplicates in build are
            # harmless for the pure-key case; residuals need the expansion
            strategy = "expand" if node.kind in ("semi", "anti") and \
                node.residual is not None else "unique"
        else:
            strategy = "expand"
        if node.kind in ("semi", "anti") and strategy == "expand" and \
                (ov is None or ov.strategy is None):
            # a compaction override (no_compact_*) keeps the join on the
            # run-statistics path; only a strategy override leaves it
            return "semi_stats", strategy, build_unique
        if self._shuffles(node, probe, build, keys):
            return "shuffle", strategy, build_unique
        return "local", strategy, build_unique

    def _shuffles(self, node, probe, build, keys) -> bool:
        """Whether the key-partitioned join over the mesh applies: a mesh of
        several shards, an inner, left, semi or anti join that is not
        null-aware, keys without NULLs, a build side at or above
        replicate_threshold_rows (a broadcast build is cheaper for a
        smaller one), and both sides' capacities multiples of the shard
        count."""
        mesh = self.mesh
        if mesh is None or not self.config.use_partition_rule:
            return False
        n = mesh.n
        if n <= 1 or node.kind not in ("inner", "left", "semi", "anti") or \
                node.null_aware or keys[2] is not None or keys[5] is not None:
            return False
        pcap, bcap = _gcap(probe, self.mesh), _gcap(build, self.mesh)
        return bcap >= self.config.replicate_threshold_rows and \
            not pcap % n and not bcap % n

    def _join_local(self, node, probe, build, pk_data, bk_data, strategy,
                    build_unique, pmask, bmask):
        """The join core. pmask/bmask = alive AND key validity."""
        if strategy == "unique":
            return self._unique_join(node, probe, build, pk_data, bk_data,
                                     check_dups=not build_unique,
                                     pmask=pmask, bmask=bmask)
        return self._expand_join(node, probe, build, pk_data, bk_data,
                                 pmask, bmask)

    def _shuffle_join(self, node, probe, build, pk_data, bk_data, ov,
                      strategy, build_unique) -> Optional[Chunk]:
        """Key-partitioned join over the mesh (quickstep_tpu/exec/
        runner.py:1042, the Partition rule, PartitionAwareInsertDestination
        and PartitionedHashTablePool analog), where _shuffles says it
        applies: both sides are radix-exchanged by join key
        (parallel/shuffle.py), then the join core runs on each shard. Each
        process runs its local shards, of its rows of a sharded side or of
        the whole of a replicated one, and its output holds their rows
        (sharded over several processes). Bucket sizes, salting, probe
        slices and the LIP filter follow the reference and are sized from
        the capacities over every process, so overflow and retry behave as
        there; each shard's flags and each slice's are OR'd, the LIP's
        words over every shard (por), and nothing is read on the host."""
        from quickstep_tpu_torch.ops import bloom as B
        from quickstep_tpu_torch.parallel import shuffle as SH
        from quickstep_tpu_torch.parallel.mesh import por, shard_rows
        mesh = self.mesh
        n = mesh.n
        pcap, bcap = _gcap(probe, self.mesh), _gcap(build, self.mesh)

        # the exchange moves whole columns: gather pending row-id maps
        probe.materialize_all()
        build.materialize_all()
        # routing key only: colliding hashes merely co-locate distinct keys;
        # the join core re-packs from the real key columns
        packed_b, packed_p, _hashed = self._pack_keys(node, build, probe,
                                                      bk_data, pk_data)

        def flatten_side(chunk, key_cols):
            arrays = [_full(c, chunk.capacity).contiguous() for c in key_cols]
            layout = []   # (expr_id, has_valid)
            for a in chunk.attrs:
                d, v = chunk.slots[a.expr_id]
                arrays.append(_full(d, chunk.capacity).contiguous())
                if v is not None:
                    arrays.append(_full(v, chunk.capacity).contiguous())
                layout.append((a.expr_id, v is not None))
            return arrays, layout

        p_arrays, p_layout = flatten_side(probe, [packed_p] + list(pk_data))
        b_arrays, b_layout = flatten_side(build, [packed_b] + list(bk_data))
        nkeys = len(pk_data)

        factor = ov.shuffle_factor if ov else 1
        lp, lb = pcap // n, bcap // n
        # heavy-hitter salting: when the hottest build key exceeds one
        # shard's average build share, split its probe stream over salt
        # partitions
        salt = 1
        key_ids = [e.expr_id for e in node.right_keys if isinstance(e, Attr)]
        if len(key_ids) == len(node.right_keys) and key_ids:
            mc = min((build.max_counts[i] for i in key_ids
                      if i in build.max_counts), default=None)
            if mc is not None and mc > lb:
                salt = min(n, K.next_pow2(-(-mc * n // bcap)))
        # receive buckets sized from the estimated live rows (4x cushion);
        # the shuffle_factor retry backs up an under-estimate
        est_p, est_b = node.est_left_rows, node.est_right_rows
        live_p = min(1.0, 4.0 * est_p / max(pcap, 1)) if est_p else 1.0
        live_b = min(1.0, 4.0 * est_b / max(bcap, 1)) if est_b else 1.0
        # skew cushion: 1.25x the mean plus the heaviest probe key where
        # the statistics know it, else 2x
        pk_ids = [e.expr_id for e in node.left_keys if isinstance(e, Attr)]
        mc_p = min((probe.max_counts[i] for i in pk_ids
                    if i in probe.max_counts), default=None) \
            if len(pk_ids) == len(node.left_keys) and pk_ids else None

        def psize(rows_per_shard):
            if mc_p is None:
                return -(-int(2 * rows_per_shard) // n)
            return -(-int(1.25 * rows_per_shard) // n) + int(mc_p)
        bb = factor * max(8, -(-int(2 * lb * live_b) * salt // n))
        recv_b = n * bb
        # the probe side runs in `chunks` slices, each its own exchange and
        # join (the reference's exchange/compute overlap)
        chunks = max(1, int(self.config.shuffle_overlap_chunks))
        if chunks > 1 and lp % chunks != 0:
            chunks = 1
        lc = lp // chunks

        # pre-shuffle LIP filter (AttachLIPFilters analog): a one-hash bloom
        # over the build keys, OR'd over the shards, drops probe rows that
        # cannot match before the exchange, and the probe buckets shrink
        # with the estimated pass rate. Only inner and semi joins may drop
        # probe rows.
        use_lip = self.config.use_lip_filters and node.kind in ("inner",
                                                                "semi")
        lip_bits = 0
        sel = 1.0
        if use_lip:
            lip_bits = K.next_pow2(int(min(max(4 * bcap, 1024), 1 << 22)))
            branges = self._key_ranges(node.right_keys, build)
            pranges = self._key_ranges(node.left_keys, probe)
            if len(branges) == 1 and branges[0] is not None and \
                    pranges[0] is not None:
                blo, bhi = branges[0]
                plo, phi = pranges[0]
                olo, ohi = max(blo, plo), min(bhi, phi)
                if ohi < olo:
                    sel = 0.0
                else:
                    inside = (ohi - olo + 1) / max(phi - plo + 1, 1)
                    hit = min(1.0, bcap / max(bhi - blo + 1, 1))
                    sel = inside * hit
            # never below 1/8 of the unfiltered buckets: a wrong estimate
            # costs a retry
            sel = max(min(sel, 1.0), 0.125)
        bp_c = factor * max(8, psize(lc * sel * live_p))
        recv_p_c = n * bp_c
        # every exchanged column crosses the mesh once, at bucket size
        probe_row_bytes = sum(a.element_size() for a in p_arrays) + 1
        build_row_bytes = sum(a.element_size() for a in b_arrays) + 1
        self.last_shuffle_info = {
            "chunks": chunks, "lip_bits": lip_bits,
            "probe_bucket_rows": chunks * recv_p_c,
            "build_bucket_rows": recv_b, "sel_est": round(sel, 4),
            "salt": salt,
            "exchange_bytes": int(n * (chunks * recv_p_c * probe_row_bytes +
                                       recv_b * build_row_bytes))}
        type(self).trace_shuffle_info = dict(self.last_shuffle_info)

        idx = self.node_index[id(node)]
        pre_flags = set(self.flags)
        p_sh = [shard_rows(mesh, a, probe.sharded)
                for a in p_arrays + [probe.alive]]
        b_sh = [shard_rows(mesh, a, build.sharded)
                for a in b_arrays + [build.alive]]
        local = range(mesh.local_n)

        def rebuild(chunk, layout, ex, alive, cap):
            pos = 1 + nkeys   # the packed key and the key columns lead
            keys = list(ex[1:pos])
            slots = {}
            for expr_id, has_valid in layout:
                d = ex[pos]
                pos += 1
                v = None
                if has_valid:
                    v = ex[pos] & alive
                    pos += 1
                slots[expr_id] = (d, v)
            return keys, Chunk(
                attrs=list(chunk.attrs), slots=slots, alive=alive,
                capacity=cap, ranges=dict(chunk.ranges),
                unique_sets=list(chunk.unique_sets),
                max_counts=dict(chunk.max_counts), fds=list(chunk.fds))

        b_ex, b_alive, over = SH.radix_exchange(
            mesh, b_sh[0], [list(cols) for cols in zip(*b_sh[:-1])],
            b_sh[-1], bb, salt=salt, probe_side=False)
        build_loc = [rebuild(build, b_layout, b_ex[j], b_alive[j], recv_b)
                     for j in local]
        lip = None
        if use_lip:
            lip = por(mesh, [B.bloom_build([b_sh[0][i]], b_sh[-1][i],
                                           lip_bits) for i in local])

        new_flags: Dict[str, torch.Tensor] = {}
        outs = [[] for _ in local]
        for ci in range(chunks):
            sl = slice(ci * lc, (ci + 1) * lc)
            keys_c = [p_sh[0][i][sl] for i in local]
            alive_c = [p_sh[-1][i][sl] for i in local]
            if lip is not None:
                alive_c = [B.bloom_probe(lip, [k], a, lip_bits)
                           for k, a in zip(keys_c, alive_c)]
            pays = [[col[i][sl] for col in p_sh[:-1]] for i in local]
            p_ex, p_alive, p_over = SH.radix_exchange(
                mesh, keys_c, pays, alive_c, bp_c, salt=salt,
                probe_side=True)
            over = over | p_over
            for j in local:
                pk_loc, probe_loc = rebuild(probe, p_layout, p_ex[j],
                                            p_alive[j], recv_p_c)
                bk_loc, b_loc = build_loc[j]
                out = self._join_local(node, probe_loc, b_loc, pk_loc, bk_loc,
                                       strategy, build_unique,
                                       probe_loc.alive, b_loc.alive)
                outs[j].append(out.materialize_all())
                # each shard's and slice's runtime flags OR together
                for k in [k for k in self.flags if k not in pre_flags]:
                    v = self.flags.pop(k)
                    new_flags[k] = (new_flags[k] | v) if k in new_flags else v
        new_flags[f"shuffle_overflow_{idx}"] = over
        for k, v in new_flags.items():
            self.flags[k] = (self.flags[k] | v) if k in self.flags else v
        # shard-major, as shard_map concatenates its outputs
        out = concat_chunks([o for shard in outs for o in shard])
        out.sharded = self._per_process
        return out

    def _key_ranges(self, keys, chunk):
        return [infer_range(e, chunk.ranges) for e in keys]

    def _unique_join(self, node, probe, build, pk_data, bk_data, check_dups,
                     pmask, bmask):
        """Build once, probe with at most one match per probe row: inner,
        left, semi and anti joins against unique (PK-style) build sides.
        The probe may hold one process's rows (sharded; the build is
        whole): each row's match reads the build alone, the dup flag too,
        and the route reads the capacity over every process."""
        ranges = self._key_ranges(node.right_keys, build)
        use_direct = False
        if len(bk_data) == 1 and ranges[0] is not None:
            domain = ranges[0][1] - ranges[0][0] + 1
            # a direct table is one domain-sized fill and scatter: worth it
            # when the domain is dense next to the build side, or small next
            # to the probe side
            use_direct = (domain <= self.config.direct_join_domain_limit and
                          (domain <= self.config.direct_join_density *
                           build.capacity or
                           domain <= 4 * _gcap(probe, self.mesh)))
        if use_direct:
            lo, hi = ranges[0]
            domain = hi - lo + 1
            table, dup = J.direct_build(bk_data[0], bmask, lo, domain)
            bidx, matched = J.direct_probe(table, pk_data[0], pmask, lo,
                                           domain)
        else:
            packed_b, packed_p, hashed = self._pack_keys(node, build, probe,
                                                         bk_data, pk_data)
            bidx, matched, dup = J.merge_unique_probe(packed_b, bmask,
                                                      packed_p, pmask)
            if hashed:
                # hashed keys can collide: verify the real key columns. Two
                # real keys may share a hash run and hide a true match
                # behind the run's first row, so the dup flag counts even
                # for a build side declared unique.
                matched = self._verify_keys(bidx, matched, pk_data, bk_data)
                bidx = torch.where(matched, bidx, torch.full_like(bidx, -1))
                check_dups = True
        if check_dups:
            self.flags[f"join_dup_{self.node_index[id(node)]}"] = dup

        if node.kind == "semi":
            return dataclasses.replace(probe, alive=probe.alive & matched)
        if node.kind == "anti":
            return dataclasses.replace(probe, alive=probe.alive & ~matched)

        # inner/left: late materialization. Build columns become LazyCols
        # sharing one row-id map; payload bytes are gathered only when, and
        # if, a later operator reads them.
        safe = torch.clamp(bidx, 0, max(build.capacity - 1, 0))
        slots = dict(probe.slots)
        ranges_out = dict(probe.ranges)
        build_lazy = compose_slots(
            build, safe, matched if node.kind == "left" else None)
        for a in build.attrs:
            slots[a.expr_id] = build_lazy[a.expr_id]
            ranges_out[a.expr_id] = build.ranges.get(a.expr_id)
        alive = probe.alive if node.kind == "left" else (probe.alive & matched)
        # FDs: both sides' row-wise FDs survive; the probe-side join keys
        # determine the matched build row (unique build), hence all build
        # attrs; joined key pairs determine each other (equal values).
        fds = list(probe.fds) + list(build.fds)
        probe_key_ids = frozenset(
            e.expr_id for e in node.left_keys if isinstance(e, Attr))
        build_key_ids = frozenset(
            e.expr_id for e in node.right_keys if isinstance(e, Attr))
        if len(probe_key_ids) == len(node.left_keys):
            fds.append((probe_key_ids,
                        frozenset(a.expr_id for a in build.attrs)))
            if len(build_key_ids) == len(node.right_keys):
                fds.append((build_key_ids, probe_key_ids))
        out = Chunk(attrs=list(node.output), slots=slots, alive=alive,
                    capacity=probe.capacity, bound=probe.bound,
                    ranges=ranges_out,
                    unique_sets=list(probe.unique_sets), fds=fds,
                    sharded=probe.sharded)
        if node.residual is not None:
            passed = self._eval_pred(out, node.residual)
            if node.kind == "left":
                # the residual takes part in the match: an unmatched or
                # residual-failed row keeps a NULL build side
                out.restrict_valid([a.expr_id for a in build.attrs],
                                   matched & passed)
            else:
                out.alive = out.alive & passed
        return out

    def _semi_stats_join(self, node, probe, build, pk_data, bk_data, pmask,
                         bmask) -> Optional[Chunk]:
        """Semi/anti join whose residual is one comparison between a build
        and a probe expression, without expansion: EXISTS (x in run(k) with
        v OP x) is decided by the run's min and max of x (Q21's correlated
        <> EXISTS). Returns None when the residual has another shape; the
        caller then takes the expansion join."""
        res = node.residual
        if not (isinstance(res, Cmp) and res.op in ("<>", "<", ">", "<=",
                                                    ">=")):
            return None
        build_ids = {a.expr_id for a in build.attrs}
        probe_ids = {a.expr_id for a in probe.attrs}
        lref = res.lhs.referenced_attrs()
        rref = res.rhs.referenced_attrs()
        if lref and lref <= build_ids and rref and rref <= probe_ids:
            build_expr, probe_expr, op = res.lhs, res.rhs, _flip_cmp(res.op)
        elif rref and rref <= build_ids and lref and lref <= probe_ids:
            build_expr, probe_expr, op = res.rhs, res.lhs, res.op
        else:
            return None
        bx, bxv = build.broadcast(*self._eval(build, build_expr))
        if bxv is not None:
            return None   # NULLs in the min/max statistics: expand instead
        # the packing must be injective over BOTH sides: pack over the union
        # of the build and probe key ranges
        key_ranges = self._key_ranges(node.right_keys, build)
        pranges = self._key_ranges(node.left_keys, probe)
        merged = None
        if all(r is not None for r in key_ranges + pranges):
            merged = [(min(a[0], b[0]), max(a[1], b[1]))
                      for a, b in zip(key_ranges, pranges)]
        packed_b = packed_p = None
        if merged is not None:
            packed_b = self._pack_sort_key(bk_data, [None] * len(bk_data),
                                           merged)
            packed_p = self._pack_sort_key(pk_data, [None] * len(pk_data),
                                           merged)
        px, pxv = probe.broadcast(*self._eval(probe, probe_expr))

        def int32_safe(t):
            return not t.dtype.is_floating_point and t.dtype != torch.bool \
                and t.element_size() <= 4
        if packed_b is not None and packed_p is not None and \
                int32_safe(bx) and int32_safe(px):
            # fused: one K8 call decides the comparison per probe row
            matched = J.merge_cmp_probe(packed_b, bmask, bx, packed_p, pmask,
                                        px, op)
        else:
            # wide values or unpackable keys: per-group min/max by the sort
            # group-by, a unique probe into the groups (by the packed key,
            # else by open addressing), a gather of the group's stats
            out_keys, _, galive, _n, results = G.sort_groupby(
                bk_data, [None] * len(bk_data),
                [("min", bx, None), ("max", bx, None)], bmask,
                packed_key=packed_b)
            if packed_b is not None and packed_p is not None:
                packed_g = self._pack_sort_key(
                    out_keys, [None] * len(out_keys), merged)
                gidx, matched, _dup = J.merge_unique_probe(
                    packed_g.to(torch.int64), galive,
                    packed_p.to(torch.int64), pmask)
            else:
                table, _ = J.oa_build(out_keys, galive,
                                      K.next_pow2(2 * build.capacity))
                gidx, matched = J.oa_probe(table, out_keys, pk_data, pmask)
            safe = torch.clamp(gidx, 0, max(build.capacity - 1, 0))
            gmin, gmax = K.multi_gather([results[0][0], results[1][0]], safe)
            cmp_t = torch.promote_types(px.dtype, gmin.dtype)
            matched = matched & J.CMP_HIT[op](px.to(cmp_t), gmin.to(cmp_t),
                                              gmax.to(cmp_t))
        if pxv is not None:
            matched = matched & pxv
        if node.kind == "anti":
            matched = ~matched
        return dataclasses.replace(probe, alive=probe.alive & matched)

    def _expand_join(self, node, probe, build, pk_data, bk_data, pmask,
                     bmask) -> Chunk:
        """Sort-based expansion join: duplicate build keys, semi/anti joins
        with a residual, many-to-many inner and left joins. Each probe row
        gets K candidate slots (K7); a longer run raises join_overflow_<idx>
        and the executor re-runs with 4 K."""
        ov = self.overrides.get(self.node_index[id(node)])
        packed_b, packed_p, hashed = self._pack_keys(node, build, probe,
                                                     bk_data, pk_data)
        sorted_key, order = J.sorted_build(packed_b, bmask)
        k = ov.max_matches if ov and ov.max_matches else \
            self._default_k(build, node.right_keys)
        rows, counts, overflow = J.expand_probe(sorted_key, order, packed_p,
                                                pmask, k)
        self.flags[f"join_overflow_{self.node_index[id(node)]}"] = overflow

        if node.kind in ("semi", "anti"):
            if node.residual is None and not hashed:
                matched = counts > 0
            else:
                if node.residual is not None:
                    # the probe columns the residual reads, gathered once
                    probe.ensure(node.residual.referenced_attrs() &
                                 set(probe.slots))
                matched = torch.zeros_like(probe.alive)
                for j in range(k):
                    bidx = rows[j::k]          # row-major [n * K]
                    ok = bidx >= 0
                    if hashed:
                        ok = self._verify_keys(bidx, ok, pk_data, bk_data)
                    if node.residual is not None:
                        pair = self._pair_chunk(node, probe, build, bidx, ok)
                        ok = ok & self._eval_pred(pair, node.residual)
                    matched = matched | ok
            if node.kind == "anti":
                matched = ~matched
            return dataclasses.replace(probe, alive=probe.alive & matched)

        # inner/left: capacity probe.capacity * K. Probe rows repeat K times
        # as repeated row-id maps only; the build columns share one map of
        # candidate rows. No payload column moves at expansion width.
        cap = probe.capacity * k
        ok = rows >= 0
        if hashed:
            ok = self._verify_keys(rows, ok, pk_data, bk_data, repeat=k)
        safe_b = torch.clamp(rows, 0, max(build.capacity - 1, 0))
        slots = repeat_slots(probe, k)
        build_lazy = compose_slots(build, safe_b, None)
        for a in build.attrs:
            slots[a.expr_id] = build_lazy[a.expr_id]
        alive = torch.repeat_interleave(probe.alive, k) & ok
        pb = probe.bound if probe.bound is not None else probe.capacity
        out = Chunk(attrs=list(node.output), slots=slots, alive=alive,
                    capacity=cap, bound=min(pb * k, cap),
                    ranges={**{a.expr_id: probe.ranges.get(a.expr_id)
                               for a in probe.attrs},
                            **{a.expr_id: build.ranges.get(a.expr_id)
                               for a in build.attrs}},
                    fds=list(probe.fds) + list(build.fds))
        if node.residual is not None:
            out.alive = out.alive & self._eval_pred(out, node.residual)
        if node.kind == "left":
            # ON-clause semantics: a probe row none of whose candidates
            # passes keeps one row, in slot 0, with a NULL build side
            has_match = out.alive.view(probe.capacity, k).any(dim=1)
            first_slot = (torch.arange(cap, device=out.device) % k) == 0
            unmatched = torch.repeat_interleave(probe.alive & ~has_match,
                                                k) & first_slot
            out.alive = out.alive | unmatched
            out.restrict_valid([a.expr_id for a in build.attrs], ~unmatched)
        return out

    def _pair_chunk(self, node, probe, build, bidx, ok) -> Chunk:
        """Probe-aligned chunk with one candidate build row per probe row,
        for a semi/anti join's residual. The build columns stay lazy: only
        those the residual reads are gathered."""
        safe = torch.clamp(bidx, 0, max(build.capacity - 1, 0))
        slots = dict(probe.slots)
        build_lazy = compose_slots(build, safe, None)
        for a in build.attrs:
            slots[a.expr_id] = build_lazy[a.expr_id]
        return Chunk(attrs=list(probe.attrs) + list(build.attrs), slots=slots,
                     alive=probe.alive & ok, capacity=probe.capacity)

    def _default_k(self, build: Chunk, keys) -> int:
        """Expansion width K: the heaviest build key's count from exact
        statistics (a composite key's runs are no longer than its tightest
        column's), capped at 256; without statistics 8, and the overflow
        retry widens it."""
        bounds = [build.max_counts[e.expr_id] for e in keys
                  if isinstance(e, Attr) and e.expr_id in build.max_counts]
        if bounds:
            return max(1, min(min(bounds), 256))
        return 8

    def _pack_keys(self, node, build, probe, bk_data, pk_data):
        """(packed_build, packed_probe, hashed): one int64 key per row.
        Range-packed keys are injective; where the ranges are unknown or
        their span product reaches 2^62 the keys are hashed (K10), and
        hashed is True: every consumer then verifies the real key columns
        of each candidate pair (_verify_keys), as the reference's hash
        tables compare keys on every probe."""
        if self.config.test_weak_hash_join:
            # test hook: a deliberately colliding "hash" (mod 3), so that
            # adversarial tests exercise the verification
            hb = torch.zeros(bk_data[0].shape, dtype=torch.int64,
                             device=self.device)
            hp = torch.zeros(pk_data[0].shape, dtype=torch.int64,
                             device=self.device)
            for b, p in zip(bk_data, pk_data):
                hb = hb + b.to(torch.int64)
                hp = hp + p.to(torch.int64)
            return hb % 3, hp % 3, True
        if len(bk_data) == 1:
            return bk_data[0].to(torch.int64), pk_data[0].to(torch.int64), \
                False
        ranges = self._key_ranges(node.right_keys, build)
        pranges = self._key_ranges(node.left_keys, probe)
        merged = []
        for rb, rp in zip(ranges, pranges):
            if rb is None or rp is None:
                merged = None
                break
            merged.append((min(rb[0], rp[0]), max(rb[1], rp[1])))
        if merged is not None:
            total = 1
            for lo, hi in merged:
                total *= (hi - lo + 1)
            if total < 2 ** 62:
                def pack(cols):
                    acc = torch.zeros(cols[0].shape, dtype=torch.int64,
                                      device=self.device)
                    for c, (lo, hi) in zip(cols, merged):
                        acc = acc * (hi - lo + 1) + (c.to(torch.int64) - lo)
                    return acc
                return pack(bk_data), pack(pk_data), False
        return K.hash_keys(bk_data), K.hash_keys(pk_data), True

    def _verify_keys(self, idx, ok, src_keys, dst_keys, repeat=1):
        """Collision guard for hashed keys: ok & (the dst side's key
        columns at rows idx equal the src side's, src repeated `repeat`
        times for the expansion layout)."""
        n_dst = int(dst_keys[0].shape[0])
        safe = torch.clamp(idx, 0, max(n_dst - 1, 0))
        gathered = K.multi_gather(list(dst_keys), safe)
        good = ok
        for g, s in zip(gathered, src_keys):
            if repeat > 1:
                s = torch.repeat_interleave(s, repeat)
            good = good & (g == s.to(g.dtype))
        return good

    def _est_compact(self, chunk: Chunk, est, disabled: bool,
                     flag_key: str) -> Chunk:
        """Compact a join or aggregate input to ~join_compact_factor x its
        cost-model estimate. Sound through the retry protocol: when the live
        count exceeds the target, rows would be dropped, so the flag (a
        device tensor, never read here) makes the executor re-run with
        compaction disabled for this node. Skipped under a mesh (rows are
        sharded)."""
        if disabled or est is None or self.mesh is not None or \
                not self.config.join_compaction:
            return chunk
        if chunk.capacity <= 4096:
            return chunk
        target = max(K.next_pow2(int(self.config.join_compact_factor * est)
                                 + 1), 1024)
        if chunk.bound is not None:
            target = min(target, K.next_pow2(chunk.bound))
        if target >= chunk.capacity:
            return chunk
        if target * 2 >= chunk.capacity and chunk.capacity <= (1 << 20):
            # a bare 2x shrink pays for its sort only at multi-million-row
            # capacities
            return chunk
        live = torch.sum(chunk.alive, dtype=torch.int64)
        self.flags[flag_key] = live > target
        return self._compact_chunk(chunk, target)

    def _compact_chunk(self, chunk: Chunk, target: int) -> Chunk:
        """Gather live rows into a smaller capacity (sound only when `target`
        is at least the live row count). Only the row-id maps move; payload
        columns stay LazyCols against their bases. Under a mesh the
        capacity stays a multiple of its shards."""
        quantum = 8 if self.mesh is None else max(8, self.mesh.n)
        target = max(K.round_up(target, quantum), quantum)
        if target >= chunk.capacity:
            return chunk
        # K9 on the card writes only the target's head of the order, and
        # the mask gathered by it
        order, alive = K.stable_partition(chunk.alive, limit=target,
                                          with_mask=True)
        slots = compose_slots(chunk, order, None)
        return dataclasses.replace(chunk, slots=slots, alive=alive,
                                   capacity=target, bound=target)

    # ----------------------------------------------------------------
    # full outer, nested-loops and cross joins
    # ----------------------------------------------------------------
    def _full_join(self, node, probe, build, pk_data, bk_data, ov,
                   build_unique, pmask, bmask) -> Chunk:
        """FULL OUTER JOIN: the left outer join, then the build rows that
        no probe row matched with a NULL probe side, concatenated (the
        reference's kLeftOuterJoin plus existence-bitmap pattern; the
        existence mask comes from a reverse probe)."""
        left_node = dataclasses.replace(node, kind="left")
        idx = self.node_index[id(node)]
        self.node_index[id(left_node)] = idx
        if build_unique and not (ov and ov.strategy == "expand"):
            out = self._unique_join(left_node, probe, build, pk_data, bk_data,
                                    check_dups=False, pmask=pmask,
                                    bmask=bmask)
        else:
            out = self._expand_join(left_node, probe, build, pk_data, bk_data,
                                    pmask, bmask)
        okey = f"join_overflow_{idx}"
        packed_b, packed_p, hashed = self._pack_keys(node, build, probe,
                                                     bk_data, pk_data)
        if node.residual is None and not hashed:
            # which build rows have a partner: the reverse merge probe
            _pidx, bmatched, _dup = J.merge_unique_probe(packed_p, pmask,
                                                         packed_b, bmask)
        else:
            # expand from the build side into the sorted probe keys; hashed
            # candidates are verified, a residual is tested per pair, and a
            # run longer than K raises the overflow retry
            sorted_p, order_p = J.sorted_build(packed_p, pmask)
            if node.residual is None:
                kmax = ov.max_matches if ov and ov.max_matches else 8
            else:
                kmax = ov.max_matches if ov and ov.max_matches else \
                    self._default_k(probe, node.left_keys)
            rows, _counts, over = J.expand_probe(sorted_p, order_p, packed_b,
                                                 bmask, kmax)
            self.flags[okey] = (self.flags[okey] | over) \
                if okey in self.flags else over
            bmatched = torch.zeros_like(build.alive)
            for j in range(kmax):
                pidx = rows[j::kmax]       # row-major [n * K]
                okj = pidx >= 0
                if hashed:
                    okj = self._verify_keys(pidx, okj, bk_data, pk_data)
                if node.residual is not None:
                    pair = self._pair_chunk(node, build, probe, pidx, okj)
                    okj = okj & self._eval_pred(pair, node.residual)
                bmatched = bmatched | okj
        tail_alive = build.alive & ~bmatched

        # the left join's rows on top, the unmatched build rows below
        out.materialize_all()
        build.materialize_all()
        build_ids = {a.expr_id for a in build.attrs}
        slots = {}
        for a in node.output:
            d, v = out.slots[a.expr_id]
            d = _full(d, out.capacity)
            if a.expr_id in build_ids:
                td, tail_v = build.slots[a.expr_id]
                td = _full(td, build.capacity).to(d.dtype)
                if tail_v is not None:
                    tail_v = _full(tail_v, build.capacity)
            else:
                td = torch.zeros(build.capacity, dtype=d.dtype,
                                 device=self.device)
                tail_v = torch.zeros(build.capacity, dtype=torch.bool,
                                     device=self.device)
            data = torch.cat([d, td])
            valid = None
            if v is not None or tail_v is not None:
                valid = torch.cat([
                    _full(v, out.capacity) if v is not None else
                    torch.ones(out.capacity, dtype=torch.bool,
                               device=self.device),
                    tail_v if tail_v is not None else
                    torch.ones(build.capacity, dtype=torch.bool,
                               device=self.device)])
            slots[a.expr_id] = (data, valid)
        ranges = {a.expr_id: (build.ranges.get(a.expr_id)
                              if a.expr_id in build_ids
                              else out.ranges.get(a.expr_id))
                  for a in node.output}
        return Chunk(attrs=list(node.output), slots=slots,
                     alive=torch.cat([out.alive, tail_alive]),
                     capacity=out.capacity + build.capacity, ranges=ranges)

    def _nested_loops_join(self, node: L.Join) -> Chunk:
        """Block nested-loops theta join (NestedLoopsJoinOperator.hpp:65):
        the cross product, then the ON predicate; inner, left, semi and
        anti kinds."""
        left = self._squeeze(self.exec(node.left))
        right = self._squeeze(self.exec(node.right))
        if node.kind == "left" and right.capacity == 0:
            # a left row needs one slot to surface with a NULL right side
            right = _one_dead_row(right)
        cross = self._cross_pair(node, left, right)
        passed = cross.alive
        if node.residual is not None:
            passed = passed & self._eval_pred(cross, node.residual)
        if node.kind == "inner":
            return dataclasses.replace(cross, alive=passed)
        matched = passed.view(left.capacity, right.capacity).any(dim=1)
        if node.kind == "semi":
            return dataclasses.replace(left, alive=left.alive & matched)
        if node.kind == "anti":
            return dataclasses.replace(left, alive=left.alive & ~matched)
        # left outer: the matched pairs, and one NULL-extended row per
        # unmatched left row
        first_slot = (torch.arange(cross.capacity, device=self.device)
                      % right.capacity) == 0
        unmatched = torch.repeat_interleave(left.alive & ~matched,
                                            right.capacity) & first_slot
        cross.restrict_valid([a.expr_id for a in right.attrs], ~unmatched)
        return dataclasses.replace(cross, alive=passed | unmatched)

    def _cross_join(self, node: L.Join) -> Chunk:
        left = self._squeeze(self.exec(node.left))
        right = self._squeeze(self.exec(node.right))
        return self._cross_pair(node, left, right)

    def _cross_pair(self, node: L.Join, left: Chunk, right: Chunk) -> Chunk:
        """Every (left, right) row pair, left-major."""
        cap = left.capacity * right.capacity
        if cap > CROSS_JOIN_LIMIT:
            raise ExecutionError(
                f"cross join too large ({left.capacity} x {right.capacity})")
        left.materialize_all()
        right.materialize_all()
        lidx = torch.repeat_interleave(
            torch.arange(left.capacity, device=self.device), right.capacity)
        ridx = torch.arange(right.capacity,
                            device=self.device).repeat(left.capacity)
        slots = {}
        for side, idx in ((left, lidx), (right, ridx)):
            cols = []
            for a in side.attrs:
                d, v = side.slots[a.expr_id]
                cols += [_full(d, side.capacity),
                         None if v is None else _full(v, side.capacity)]
            g = K.multi_gather(cols, idx)
            for i, a in enumerate(side.attrs):
                slots[a.expr_id] = (g[2 * i], g[2 * i + 1])
        alive = K.multi_gather([left.alive], lidx)[0] & \
            K.multi_gather([right.alive], ridx)[0]
        lb = left.bound if left.bound is not None else left.capacity
        rb = right.bound if right.bound is not None else right.capacity
        return Chunk(attrs=list(node.output), slots=slots, alive=alive,
                     capacity=cap, bound=min(lb * rb, cap),
                     ranges={**left.ranges, **right.ranges})

    # ----------------------------------------------------------------
    # sort / limit / distinct / set operations / row numbers
    # ----------------------------------------------------------------
    def _exec_Sort(self, node: L.Sort) -> Chunk:
        """ORDER BY below the root: one stable sort of the packed key where
        the keys' ranges fit, else the chained sort of ops/sort.py (K13).
        LIMIT keeps the first rows of the sorted order."""
        chunk = self.exec(node.input)
        need = set()
        for e in node.keys:
            need |= e.referenced_attrs()
        chunk.ensure([e for e in need if e in chunk.slots])
        keys, valids = [], []
        for e in node.keys:
            d, v = chunk.broadcast(*self._eval(chunk, e))
            keys.append(d)
            valids.append(v)
        key_ranges = [infer_range(e, chunk.ranges) for e in node.keys]
        packed = self._pack_sort_key(keys, valids, key_ranges,
                                     descending=[not a for a in
                                                 node.ascending],
                                     nulls_first=node.nulls_first)
        if packed is not None:
            # dead rows last: the dtype's max is above every packed key
            top = torch.full((), K.max_sentinel(packed.dtype),
                             dtype=packed.dtype, device=self.device)
            _, order = torch.sort(torch.where(chunk.alive, packed, top),
                                  stable=True)
        else:
            order = S.order_permutation(keys, valids, node.ascending,
                                        node.nulls_first, chunk.alive)
        out = Chunk(attrs=list(chunk.attrs),
                    slots=compose_slots(chunk, order, None),
                    alive=chunk.alive.index_select(0, order),
                    capacity=chunk.capacity, ranges=dict(chunk.ranges),
                    unique_sets=list(chunk.unique_sets))
        if node.limit is not None:
            out.alive = out.alive & (torch.arange(
                out.capacity, device=self.device) < node.limit)
        return out

    def _exec_Limit(self, node: L.Limit) -> Chunk:
        chunk = self.exec(node.input)
        pos = torch.cumsum(chunk.alive, 0)
        return dataclasses.replace(chunk,
                                   alive=chunk.alive & (pos <= node.limit))

    def _exec_Distinct(self, node: L.Distinct) -> Chunk:
        """SELECT DISTINCT: the sort group-by over every column with no
        aggregates, so its sort and K6 gathers and no K5 reduction."""
        chunk = self.exec(node.input)
        chunk.ensure([a.expr_id for a in chunk.attrs])
        key_data, key_valid = [], []
        for a in chunk.attrs:
            d, v = chunk.broadcast(*chunk.slots[a.expr_id])
            key_data.append(d)
            key_valid.append(v)
        key_ranges = [chunk.ranges.get(a.expr_id) for a in chunk.attrs]
        packed = self._pack_sort_key(key_data, key_valid, key_ranges)
        out_keys, out_valids, occupied, _n, _ = G.sort_groupby(
            key_data, key_valid, [], chunk.alive, packed_key=packed)
        slots = {}
        for a, kd, kv in zip(chunk.attrs, out_keys, out_valids):
            slots[a.expr_id] = (kd.to(K.torch_dtype(a.type.device_dtype)), kv)
        return Chunk(attrs=list(chunk.attrs), slots=slots, alive=occupied,
                     capacity=chunk.capacity, ranges=dict(chunk.ranges),
                     unique_sets=[frozenset(a.expr_id for a in chunk.attrs)])

    def _exec_SetOperation(self, node: L.SetOperation) -> Chunk:
        """UNION [ALL] by concatenation (dictionary codes moved into the
        output's merged dictionary); INTERSECT and EXCEPT as a semi or anti
        join of the left input against the right on every column by open
        addressing (K11), then DISTINCT. NULLs are equal here, so each
        nullable column's validity joins the key."""
        chunks = [self.exec(c).materialize_all() for c in node.inputs]
        if node.kind in ("union", "union_all"):
            slots = {}
            for i, a in enumerate(node.attrs):
                parts_d, parts_v = [], []
                for c in chunks:
                    ca = c.attrs[i]
                    d, v = c.slots[ca.expr_id]
                    d, v = self._remap_for_union(a, ca, _full(d, c.capacity),
                                                 v)
                    parts_d.append(d.to(K.torch_dtype(a.type.device_dtype)))
                    parts_v.append(v)
                valid = None
                if any(v is not None for v in parts_v):
                    valid = torch.cat([
                        torch.ones(c.capacity, dtype=torch.bool,
                                   device=self.device) if v is None
                        else _full(v, c.capacity)
                        for v, c in zip(parts_v, chunks)])
                slots[a.expr_id] = (torch.cat(parts_d), valid)
            return Chunk(attrs=list(node.attrs), slots=slots,
                         alive=torch.cat([c.alive for c in chunks]),
                         capacity=sum(c.capacity for c in chunks), ranges={})
        if node.kind in ("intersect", "except"):
            left, right = chunks
            nullable = [left.slots[la.expr_id][1] is not None or
                        right.slots[ra.expr_id][1] is not None
                        for la, ra in zip(left.attrs, right.attrs)]

            def keys_of(c):
                ks = []
                for a, oa, null in zip(c.attrs, node.attrs, nullable):
                    d, v = c.broadcast(*c.slots[a.expr_id])
                    # codes of different inputs compare in the merged
                    # output dictionary
                    d, v = self._remap_for_union(oa, a, d, v)
                    if null:
                        if v is None:
                            v = torch.ones(c.capacity, dtype=torch.bool,
                                           device=self.device)
                        d = torch.where(v, d, torch.zeros((), dtype=d.dtype,
                                                          device=d.device))
                        ks.append(v.to(torch.int32))
                    ks.append(d.contiguous())
                return ks

            lk, rk = keys_of(left), keys_of(right)
            table, _ = J.oa_build(rk, right.alive,
                                  K.next_pow2(2 * right.capacity))
            _, matched = J.oa_probe(table, rk, lk, left.alive)
            if node.kind == "except":
                matched = ~matched
            slots = {a.expr_id: left.slots[la.expr_id]
                     for a, la in zip(node.attrs, left.attrs)}
            renamed = Chunk(attrs=list(node.attrs), slots=slots,
                            alive=left.alive & matched,
                            capacity=left.capacity)
            return self._exec_Distinct(L.Distinct(input=_Const(renamed)))
        raise ExecutionError(f"unknown set op {node.kind}")

    def _remap_for_union(self, out_attr: OutAttr, in_attr: OutAttr, d, v):
        """An input's dictionary codes moved into the output attribute's
        dictionary (which the planner makes the union of the inputs')."""
        if out_attr.dictionary is not None and in_attr.dictionary is not None \
                and out_attr.dictionary is not in_attr.dictionary:
            from quickstep_tpu_torch.storage.dictionary import Dictionary
            _merged, _ra, rb = Dictionary.merge(out_attr.dictionary,
                                                in_attr.dictionary)
            rm = K.to_device(rb, self.device)
            safe = torch.clamp(d, 0, max(rm.shape[0] - 1, 0))
            d = K.multi_gather([rm], safe.contiguous())[0]
        return d, v

    def _exec_RowNumber(self, node: L.RowNumber) -> Chunk:
        """A unique id per row position: the outer row's identity in
        general decorrelation. Dead rows get ids too and stay dead."""
        chunk = self.exec(node.input)
        a = node.out_attr
        slots = dict(chunk.slots)
        slots[a.expr_id] = (torch.arange(chunk.capacity, dtype=torch.int64,
                                         device=self.device), None)
        rid_set = frozenset([a.expr_id])
        return Chunk(
            attrs=list(node.output), slots=slots, alive=chunk.alive,
            capacity=chunk.capacity, bound=chunk.bound,
            ranges={**chunk.ranges,
                    a.expr_id: (0, max(chunk.capacity - 1, 0))},
            unique_sets=list(chunk.unique_sets) + [rid_set],
            fds=list(chunk.fds) + [
                (rid_set, frozenset(x.expr_id for x in chunk.attrs))],
            max_counts={**chunk.max_counts, a.expr_id: 1})

    def _exec__Const(self, node: "_Const") -> Chunk:
        return node.chunk

    # ----------------------------------------------------------------
    # window aggregates
    # ----------------------------------------------------------------
    def _exec_WindowAggregate(self, node: L.WindowAggregate) -> Chunk:
        """One window function over the input (reference runner.py:2074).
        Keys and the argument are evaluated at input capacity; a key's
        range reaches the sort (a packed key) only when the key has no
        NULLs, since the sort reads the data of NULL rows as it is."""
        from quickstep_tpu_torch.ops.window import window_aggregate
        chunk = self.exec(node.input)
        spec = node.spec
        exprs = list(node.partition_by) + list(node.order_by) + (
            [spec.arg] if spec.arg is not None else [])
        need = set()
        for e in exprs:
            need |= e.referenced_attrs()
        # one gather per shared RowIds for every lazy column read
        chunk.ensure([e for e in need if e in chunk.slots])
        keys, ranges = [], []
        for e in list(node.partition_by) + list(node.order_by):
            d, v = chunk.broadcast(*self._eval(chunk, e))
            keys.append(d)
            ranges.append(infer_range(e, chunk.ranges) if v is None else None)
        n_part = len(node.partition_by)
        vals, valid = None, None
        if spec.arg is not None:
            vals, valid = chunk.broadcast(*self._eval(chunk, spec.arg))
            if spec.fn in ("sum", "avg") and (spec.arg.type.is_integral or
                                              spec.arg.type.is_decimal):
                vals = vals.to(torch.int64)
        res, rvalid = window_aggregate(
            keys[:n_part], keys[n_part:], [not a for a in
                                           node.order_ascending],
            spec.fn, vals, valid, chunk.alive, node.frame, key_ranges=ranges)
        slots = dict(chunk.slots)
        slots[node.out_attr.expr_id] = (
            res.to(K.torch_dtype(node.out_attr.type.device_dtype)), rvalid)
        return Chunk(attrs=list(node.output), slots=slots, alive=chunk.alive,
                     capacity=chunk.capacity, ranges=dict(chunk.ranges),
                     unique_sets=list(chunk.unique_sets), fds=list(chunk.fds))

    def _squeeze(self, chunk: Chunk) -> Chunk:
        """Compact when the static bound is much smaller than capacity (the
        capacity over every process: a sharded chunk is gathered first)."""
        if chunk.bound is not None and \
                chunk.bound * 2 <= _gcap(chunk, self.mesh):
            if chunk.sharded:
                chunk = self._whole(chunk, why="compaction")
            return self._compact_chunk(chunk, chunk.bound)
        return chunk



class _Const(L.LogicalNode):
    """An already computed chunk as a plan node (runner-internal)."""

    def __init__(self, chunk: Chunk):
        self.chunk = chunk

    @property
    def output(self):
        return self.chunk.attrs


def _one_dead_row(chunk: Chunk) -> Chunk:
    """A chunk of one dead row with the attributes of an empty chunk."""
    dev = chunk.device
    slots = {a.expr_id: (torch.zeros(1, dtype=K.torch_dtype(
        a.type.device_dtype), device=dev), torch.zeros(1, dtype=torch.bool,
                                                       device=dev))
        for a in chunk.attrs}
    return Chunk(attrs=list(chunk.attrs), slots=slots,
                 alive=torch.zeros(1, dtype=torch.bool, device=dev),
                 capacity=1, ranges=dict(chunk.ranges))
