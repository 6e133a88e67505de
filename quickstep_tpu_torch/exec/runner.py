"""PlanRunner: runs a logical plan eagerly, operator by operator, on torch.

The counterpart of quickstep_tpu/exec/runner.py: TableScan, Filter,
Project, Aggregate down the scalar, dense, sort and DISTINCT branches,
equi-joins down the FilterJoin (exact filter), direct-address,
sorted-probe unique, run-statistics semi and expansion paths, shared
subplans (WITH), uncorrelated scalar subqueries and window aggregates
(ops/window.py). Physical choices are
made on the host from plan-time ranges, as in the reference. Runtime
fallbacks (duplicate build keys, expansion overflow, compaction
under-estimates) surface as 0-d device flags in `self.flags` that the
executor reads with the result and answers with a retry. A scalar subquery
is evaluated inside the plan, its value and presence kept as 0-d device
tensors, so the query keeps its one host sync. Every other operator (full
outer, nested-loops and cross joins, RowNumber, Sort and Limit below the
root, Distinct, set operations), hashed join keys and scalar DISTINCT
aggregates raise an
ExecutionError that says they are not yet ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from quickstep_tpu_torch.config import Config
from quickstep_tpu_torch.errors import ExecutionError
from quickstep_tpu_torch.expressions.scalar import Expr, Attr, Cmp
from quickstep_tpu_torch.optimizer import logical as L
from quickstep_tpu_torch.optimizer.stats import infer_range
from quickstep_tpu_torch.exec.chunk import Chunk, compose_slots, repeat_slots
from quickstep_tpu_torch.ops import kernels as K
from quickstep_tpu_torch.ops import groupby as G
from quickstep_tpu_torch.ops import join as J


def not_ported(what: str) -> ExecutionError:
    return ExecutionError(f"{what} not yet ported to quickstep_tpu_torch")


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


class PlanRunner:
    def __init__(self, plan: L.LogicalNode,
                 inputs: Dict[str, Dict[str, object]],
                 input_meta: Dict[str, dict], config: Config,
                 device: torch.device,
                 overrides: Optional[Dict[int, JoinOverride]] = None):
        """inputs: relation name -> {attr name -> (data, valid), "__num_rows__"}.
        input_meta: relation name -> {capacity, ranges, unique_cols, ...}.
        overrides are keyed by structural (preorder) node indices so they
        survive re-resolution of the same query."""
        self.inputs = inputs
        self.input_meta = input_meta
        self.config = config
        self.device = device
        self.overrides = overrides or {}
        self.flags: Dict[str, torch.Tensor] = {}   # runtime check flags
        # shared subplans and scalar subqueries, run once per plan object
        self._memo: Dict[int, Chunk] = {}
        # ("subquery", id(plan)) -> (value, present): 0-d device tensors
        self._subquery_slots: Dict[tuple, tuple] = {}
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

    def exec(self, node: L.LogicalNode) -> Chunk:
        m = getattr(self, f"_exec_{type(node).__name__}", None)
        if m is None:
            raise not_ported(f"operator {type(node).__name__}")
        return m(node)

    def _exec_memo(self, plan: L.LogicalNode) -> Chunk:
        key = id(plan)
        if key not in self._memo:
            self._memo[key] = self.exec(plan)
        return self._memo[key]

    # ----------------------------------------------------------------
    # scan, shared subplans
    # ----------------------------------------------------------------
    def _exec_TableScan(self, node: L.TableScan) -> Chunk:
        if node.sample_kind:
            raise not_ported("TABLESAMPLE")
        cols = self.inputs[node.relation_name]
        meta = self.input_meta[node.relation_name]
        capacity = meta["capacity"]
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
        alive = K.alive_mask(capacity, cols["__num_rows__"], self.device)
        all_ids = frozenset(a.expr_id for a in node.attrs)
        fds = [(u, all_ids) for u in unique_sets]
        return Chunk(attrs=list(node.attrs), slots=slots, alive=alive,
                     capacity=capacity, ranges=ranges, unique_sets=unique_sets,
                     fds=fds, max_counts=max_counts, bound=meta.get("rows"))

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
                                          if i in remap})

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
                    sub = self._exec_memo(x.plan)
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
        chunk = self.exec(node.input)
        passed = self._eval_pred(chunk, node.predicate)
        return dataclasses.replace(chunk, alive=chunk.alive & passed)

    def _exec_Project(self, node: L.Project) -> Chunk:
        chunk = self.exec(node.input)
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
                     unique_sets=uniq, fds=fds, max_counts=mcs)

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
        chunk = self.exec(node.input)
        distinct_flags = [s.distinct for s in node.aggregates]
        if not node.group_by:
            if any(distinct_flags):
                raise not_ported("scalar DISTINCT aggregate (distinct_count)")
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
        # key is never gathered at input capacity. Deferral needs: outside
        # the minimal sort cover, a plain Attr over a non-null slot with the
        # output dtype.
        keep = self._reduce_group_keys(node.group_by, chunk)
        defer = set()
        for i, ge in enumerate(node.group_by):
            if any(distinct_flags) or i in keep or not isinstance(ge, Attr):
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
        offsets, sizes, strides, domain = self._dense_layout(key_ranges)
        idx = G.pack_dense_index(key_data, offsets, strides, domain,
                                 chunk.alive)
        occupied, results = G.dense_groupby(idx, domain, agg_inputs,
                                            chunk.alive)
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

    def _pack_sort_key(self, key_data, key_valid, key_ranges):
        """Pack integer composite group keys into one int32/int64 sort key
        when their ranges fit; NULLs take the last slot of their key's span.
        Returns None when not packable (unknown range, float keys)."""
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
        for d, v, r, span in zip(key_data, key_valid, key_ranges, spans):
            enc = d.to(torch.int64) - r[0]
            if v is not None:
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
                     capacity=chunk.capacity, ranges=ranges,
                     unique_sets=uniq, fds=fds)

    def _fill_agg_slots(self, node, results, slots):
        for spec, a, (data, nn) in zip(node.aggregates, node.agg_attrs, results):
            data = data.to(K.torch_dtype(a.type.device_dtype))
            if spec.fn == "count":
                slots[a.expr_id] = (data, None)
            else:
                slots[a.expr_id] = (data, nn > 0)

    def _scalar_aggregate(self, node: L.Aggregate, chunk: Chunk) -> Chunk:
        # One output row, capacity 8 as in the reference.
        capacity = 8
        alive = K.alive_mask(capacity, 1, chunk.device)
        slots = {}
        for spec, a in zip(node.aggregates, node.agg_attrs):
            fn, vals, valid = self._agg_input(chunk, spec)
            val, nn = G.scalar_agg(fn, vals, valid, chunk.alive)
            data = torch.broadcast_to(
                val.to(K.torch_dtype(a.type.device_dtype)), (capacity,))
            if spec.fn == "count":
                slots[a.expr_id] = (data, None)
            else:
                slots[a.expr_id] = (data, alive & (nn > 0))
        return Chunk(attrs=list(node.output), slots=slots, alive=alive,
                     capacity=capacity, ranges={})

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
            raise not_ported("cross join")
        if not node.left_keys:
            raise not_ported("nested-loops join")
        probe = self._squeeze(self.exec(node.left))
        build = self._squeeze(self.exec(node.right))
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

        pk_data = []
        pk_valid0 = bk_valid0 = None
        pk_valid = bk_valid = None   # AND of all key validity masks
        for i, e in enumerate(node.left_keys):
            d, v = probe.broadcast(*self._eval(probe, e))
            if i == 0:
                pk_valid0 = v
            if v is not None:
                pk_valid = v if pk_valid is None else (pk_valid & v)
            pk_data.append(d)
        bk_data = []
        for i, e in enumerate(node.right_keys):
            d, v = build.broadcast(*self._eval(build, e))
            if i == 0:
                bk_valid0 = v
            if v is not None:
                bk_valid = v if bk_valid is None else (bk_valid & v)
            bk_data.append(d)
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

        # FilterJoin strength reduction: semi/anti joins over one ranged
        # integer key need only the exact presence filter.
        if node.kind in ("semi", "anti") and node.residual is None and \
                len(bk_data) == 1 and self.config.use_filter_joins:
            r = self._key_ranges(node.right_keys, build)[0]
            if r is not None and (r[1] - r[0] + 1) <= \
                    self.config.direct_join_domain_limit and \
                    (r[1] - r[0] + 1) <= max(
                        int(self.config.direct_join_density * build.capacity),
                        4 * probe.capacity):
                from quickstep_tpu_torch.ops import bloom as B
                lo, domain = r[0], r[1] - r[0] + 1
                bits = B.exact_filter_build(bk_data[0], bmask, lo, domain)
                matched = B.exact_filter_probe(bits, pk_data[0], pmask, lo)
                if node.kind == "anti":
                    matched = probe.alive & ~matched
                return na_correct(dataclasses.replace(
                    probe, alive=probe.alive & matched))

        build_key_ids = [e.expr_id for e in node.right_keys
                         if isinstance(e, Attr)]
        build_unique = (len(build_key_ids) == len(node.right_keys)) and \
            build.is_unique(build_key_ids)
        ov = self.overrides.get(idx0)
        if node.kind == "full":
            raise not_ported("full outer join (_full_join)")
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
            out = self._semi_stats_join(node, probe, build, pk_data, bk_data,
                                        pmask, bmask)
            if out is not None:
                return na_correct(out)
        return na_correct(self._join_local(
            node, probe, build, pk_data, bk_data, strategy, build_unique,
            pmask, bmask))

    def _join_local(self, node, probe, build, pk_data, bk_data, strategy,
                    build_unique, pmask, bmask):
        """The join core. pmask/bmask = alive AND key validity."""
        if strategy == "unique":
            return self._unique_join(node, probe, build, pk_data, bk_data,
                                     check_dups=not build_unique,
                                     pmask=pmask, bmask=bmask)
        return self._expand_join(node, probe, build, pk_data, bk_data,
                                 pmask, bmask)

    def _key_ranges(self, keys, chunk):
        return [infer_range(e, chunk.ranges) for e in keys]

    def _unique_join(self, node, probe, build, pk_data, bk_data, check_dups,
                     pmask, bmask):
        """Build once, probe with at most one match per probe row: inner,
        left, semi and anti joins against unique (PK-style) build sides."""
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
                           domain <= 4 * probe.capacity))
        if use_direct:
            lo, hi = ranges[0]
            domain = hi - lo + 1
            table, dup = J.direct_build(bk_data[0], bmask, lo, domain)
            bidx, matched = J.direct_probe(table, pk_data[0], pmask, lo,
                                           domain)
        else:
            packed_b, packed_p = self._pack_keys(node, build, probe, bk_data,
                                                 pk_data)
            bidx, matched, dup = J.merge_unique_probe(packed_b, bmask,
                                                      packed_p, pmask)
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
                    unique_sets=list(probe.unique_sets), fds=fds)
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
            if packed_b is None or packed_p is None:
                raise not_ported("hashed semi join keys (oa_build)")
            # wide values: per-group min/max by the sort group-by, a unique
            # probe into the groups, a gather of the group's stats
            out_keys, _, galive, _n, results = G.sort_groupby(
                bk_data, [None] * len(bk_data),
                [("min", bx, None), ("max", bx, None)], bmask,
                packed_key=packed_b)
            packed_g = self._pack_sort_key(out_keys, [None] * len(out_keys),
                                           merged)
            gidx, matched, _dup = J.merge_unique_probe(
                packed_g.to(torch.int64), galive, packed_p.to(torch.int64),
                pmask)
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
        packed_b, packed_p = self._pack_keys(node, build, probe, bk_data,
                                             pk_data)
        sorted_key, order = J.sorted_build(packed_b, bmask)
        k = ov.max_matches if ov and ov.max_matches else \
            self._default_k(build, node.right_keys)
        rows, counts, overflow = J.expand_probe(sorted_key, order, packed_p,
                                                pmask, k)
        self.flags[f"join_overflow_{self.node_index[id(node)]}"] = overflow

        if node.kind in ("semi", "anti"):
            if node.residual is None:
                matched = counts > 0
            else:
                # the probe columns the residual reads, gathered once
                probe.ensure(node.residual.referenced_attrs() &
                             set(probe.slots))
                matched = torch.zeros_like(probe.alive)
                for j in range(k):
                    bidx = rows[j::k]          # row-major [n * K]
                    ok = bidx >= 0
                    pair = self._pair_chunk(node, probe, build, bidx, ok)
                    matched = matched | (ok & self._eval_pred(pair,
                                                              node.residual))
            if node.kind == "anti":
                matched = ~matched
            return dataclasses.replace(probe, alive=probe.alive & matched)

        # inner/left: capacity probe.capacity * K. Probe rows repeat K times
        # as repeated row-id maps only; the build columns share one map of
        # candidate rows. No payload column moves at expansion width.
        cap = probe.capacity * k
        safe_b = torch.clamp(rows, 0, max(build.capacity - 1, 0))
        slots = repeat_slots(probe, k)
        build_lazy = compose_slots(build, safe_b, None)
        for a in build.attrs:
            slots[a.expr_id] = build_lazy[a.expr_id]
        alive = torch.repeat_interleave(probe.alive, k) & (rows >= 0)
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
        """(packed_build, packed_probe): one int64 key per row, range-packed
        and so injective. Keys that would need hashing (no range, or a span
        product of 2^62 or more) are not ported."""
        if self.config.test_weak_hash_join:
            raise not_ported("hashed join keys (_pack_keys)")
        if len(bk_data) == 1:
            return bk_data[0].to(torch.int64), pk_data[0].to(torch.int64)
        ranges = self._key_ranges(node.right_keys, build)
        pranges = self._key_ranges(node.left_keys, probe)
        merged = []
        for rb, rp in zip(ranges, pranges):
            if rb is None or rp is None:
                raise not_ported("hashed composite join keys (_pack_keys)")
            merged.append((min(rb[0], rp[0]), max(rb[1], rp[1])))
        total = 1
        for lo, hi in merged:
            total *= (hi - lo + 1)
        if total >= 2 ** 62:
            raise not_ported("hashed composite join keys (_pack_keys)")

        def pack(cols):
            acc = torch.zeros(cols[0].shape, dtype=torch.int64,
                              device=self.device)
            for c, (lo, hi) in zip(cols, merged):
                acc = acc * (hi - lo + 1) + (c.to(torch.int64) - lo)
            return acc
        return pack(bk_data), pack(pk_data)

    def _est_compact(self, chunk: Chunk, est, disabled: bool,
                     flag_key: str) -> Chunk:
        """Compact a join or aggregate input to ~join_compact_factor x its
        cost-model estimate. Sound through the retry protocol: when the live
        count exceeds the target, rows would be dropped, so the flag (a
        device tensor, never read here) makes the executor re-run with
        compaction disabled for this node."""
        if disabled or est is None or not self.config.join_compaction:
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
        columns stay LazyCols against their bases."""
        target = max(K.round_up(target, 8), 8)
        if target >= chunk.capacity:
            return chunk
        order = K.compact_order(chunk.alive)[:target]
        slots = compose_slots(chunk, order, None)
        return dataclasses.replace(chunk, slots=slots,
                                   alive=chunk.alive[order],
                                   capacity=target, bound=target)

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
        """Compact when the static bound is much smaller than capacity."""
        if chunk.bound is not None and chunk.bound * 2 <= chunk.capacity:
            return self._compact_chunk(chunk, chunk.bound)
        return chunk

