# Copied from quickstep_tpu/exec/streaming.py; only the package name in imports differs.
"""Out-of-core streamed execution: working sets larger than the HBM budget.

The reference runs data bigger than RAM through its buffer pool — blocks fault
in and evict on demand (storage/StorageManager.hpp:84, EvictionPolicy.hpp:43,
README.md:8 "data sets larger than RAM"). A TPU cannot fault mid-kernel, so the
TPU-native equivalent is *segment streaming*: when a query's dominant table
exceeds the HBM budget, the plan's scan->filter->probe->aggregate prefix runs
once per row-segment (host->HBM transfer per segment, same compiled program),
partial aggregates merge on a final small pass, and everything above the
aggregation runs unchanged. Join build sides stay resident; only the probe
side streams — the HashJoinOperator work-order-per-block pattern
(relational_operators/HashJoinOperator.hpp:157-169) at segment granularity.

Segment skipping: per-segment min/max (the SMA index analog,
storage/SMAIndexSubBlock.hpp:181) prunes segments whose value ranges cannot
satisfy the scan predicate — bytes never leave the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from quickstep_tpu_torch.expressions.aggregate import AggregateSpec
from quickstep_tpu_torch.expressions.scalar import (
    Arith, Attr, Cmp, DecimalToDouble, Expr, Lit, split_conjuncts,
)
from quickstep_tpu_torch.optimizer import logical as L
from quickstep_tpu_torch.optimizer.logical import OutAttr, next_expr_id
from quickstep_tpu_torch.types import DOUBLE, LONG

PARTIALS_REL = "__stream_partials__"


@dataclasses.dataclass
class StreamPlan:
    big_table: str                   # relation being streamed
    partial_plan: L.LogicalNode      # per-segment program (ends in Aggregate)
    merge_plan: L.LogicalNode        # full plan with the Aggregate subtree
    #                                  replaced by merge-over-partials
    partial_attrs: List[OutAttr]     # output schema of partial_plan
    scan_filters: List[Expr]         # conjuncts usable for SMA pruning
    scan_attr_cols: Dict[int, str]   # big-scan expr_id -> column name
    seg_rows: int
    n_segments: int


# ---------------------------------------------------------------------
# plan analysis
# ---------------------------------------------------------------------

def _table_bytes(rel, colnames) -> int:
    total = 0
    for c in colnames:
        col = rel.data.columns[c]
        total += np.asarray(col.data).nbytes
        if col.valid is not None:
            total += np.asarray(col.valid).nbytes
    return total


def _needed_columns(plan) -> Dict[str, set]:
    needed: Dict[str, set] = {}

    def walk(node):
        if isinstance(node, L.TableScan):
            needed.setdefault(node.relation_name, set()).update(
                a.name for a in node.attrs)
        for c in node.children():
            walk(c)
    walk(plan)
    return needed


def _has_subquery(node) -> bool:
    from quickstep_tpu_torch.expressions.subquery import SubqueryScalar
    from quickstep_tpu_torch.exec.executor import _node_exprs
    stack = [node]
    while stack:
        n = stack.pop()
        for e in _node_exprs(n):
            es = [e]
            while es:
                x = es.pop()
                if isinstance(x, SubqueryScalar):
                    return True
                es.extend(x.children())
        stack.extend(n.children())
    return False


def _scan_path(node, big: str) -> Optional[List[L.LogicalNode]]:
    """Path from `node` down to TableScan(big) through stream-safe edges:
    Filter/Project inputs and the PROBE (left) side of joins. Returns the node
    list root-first, or None if big is unreachable that way."""
    if isinstance(node, L.TableScan):
        return [node] if node.relation_name == big else None
    if isinstance(node, (L.Filter, L.Project)):
        sub = _scan_path(node.input, big)
        return [node] + sub if sub else None
    if isinstance(node, L.Join):
        if _contains_scan(node.right, big):
            return None          # big on the build side: not streamable
        sub = _scan_path(node.left, big)
        return [node] + sub if sub else None
    return None


def _contains_scan(node, name: str) -> bool:
    if isinstance(node, L.TableScan):
        return node.relation_name == name
    return any(_contains_scan(c, name) for c in node.children())


def _lowest_aggregate_over(plan, big: str) -> Optional[L.Aggregate]:
    """The lowest Aggregate node whose subtree contains TableScan(big)."""
    found: List[L.Aggregate] = []

    def walk(node):
        for c in node.children():
            walk(c)
        if isinstance(node, L.Aggregate) and _contains_scan(node, big) and \
                not found:
            found.append(node)
    walk(plan)
    return found[0] if found else None


def _replace_node(plan, old, new):
    """Structural copy of `plan` with `old` (by identity) replaced by `new`."""
    if plan is old:
        return new
    if not plan.children():
        return plan
    changes = {}
    for f in dataclasses.fields(plan):
        v = getattr(plan, f.name)
        if isinstance(v, L.LogicalNode):
            nv = _replace_node(v, old, new)
            if nv is not v:
                changes[f.name] = nv
        elif isinstance(v, list) and v and isinstance(v[0], L.LogicalNode):
            nl = [_replace_node(x, old, new) for x in v]
            if any(a is not b for a, b in zip(nl, v)):
                changes[f.name] = nl
    return dataclasses.replace(plan, **changes) if changes else plan


# ---------------------------------------------------------------------
# aggregate decomposition (partial / merge / finalize)
# ---------------------------------------------------------------------

def _decompose(agg: L.Aggregate):
    """Rewrite the Aggregate for two-phase execution. Returns
    (partial_specs, partial_attrs, merge_specs, merge_attrs, final_exprs)
    where final_exprs reproduce the ORIGINAL output attrs (ids preserved) from
    the merge output. None if not decomposable (DISTINCT aggregates)."""
    partial_specs: List[AggregateSpec] = []
    partial_attrs: List[OutAttr] = []
    merge_specs: List[AggregateSpec] = []
    merge_attrs: List[OutAttr] = []
    final_exprs: List[Expr] = []

    def add_partial(spec, name, rtype, dictionary=None):
        attr = OutAttr(next_expr_id(), name, rtype, dictionary)
        partial_specs.append(spec)
        partial_attrs.append(attr)
        return attr

    def add_merge(fn, src_attr, rtype):
        spec = AggregateSpec(fn=fn, arg=Attr(expr_id=src_attr.expr_id,
                                             type=src_attr.type),
                             result_type=rtype)
        attr = OutAttr(next_expr_id(), f"m_{src_attr.name}", rtype)
        merge_specs.append(spec)
        merge_attrs.append(attr)
        return attr

    for i, (spec, attr) in enumerate(zip(agg.aggregates, agg.agg_attrs)):
        if spec.distinct:
            return None
        if spec.fn == "count":
            p = add_partial(AggregateSpec(fn="count", arg=spec.arg,
                                          result_type=LONG),
                            f"__pc{i}", LONG)
            m = add_merge("sum", p, LONG)
            # COUNT is never NULL: merge-sum over counts is non-null
            final_exprs.append(Attr(expr_id=m.expr_id,
                                    type=attr.type))
        elif spec.fn in ("sum", "min", "max"):
            p = add_partial(AggregateSpec(fn=spec.fn, arg=spec.arg,
                                          result_type=spec.result_type),
                            f"__p{spec.fn}{i}", spec.result_type,
                            attr.dictionary)
            m = add_merge("sum" if spec.fn == "sum" else spec.fn, p,
                          spec.result_type)
            final_exprs.append(Attr(expr_id=m.expr_id, type=attr.type))
        elif spec.fn == "avg":
            sum_t = AggregateSpec.result_type_for("sum", spec.arg)
            ps = add_partial(AggregateSpec(fn="sum", arg=spec.arg,
                                           result_type=sum_t),
                             f"__pas{i}", sum_t)
            pc = add_partial(AggregateSpec(fn="count", arg=spec.arg,
                                           result_type=LONG),
                             f"__pac{i}", LONG)
            ms = add_merge("sum", ps, sum_t)
            mc = add_merge("sum", pc, LONG)
            num = Attr(expr_id=ms.expr_id, type=DOUBLE)
            if sum_t.is_decimal:  # decode units before the f64 divide
                num = DecimalToDouble(
                    operand=Attr(expr_id=ms.expr_id, type=sum_t), type=DOUBLE)
            final_exprs.append(Arith(
                op="/", lhs=num,
                rhs=Attr(expr_id=mc.expr_id, type=DOUBLE),
                type=attr.type))
        else:
            return None
    return partial_specs, partial_attrs, merge_specs, merge_attrs, final_exprs


# ---------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------

def plan_streaming(plan, db, config, mesh=None) -> Optional[StreamPlan]:
    budget = config.hbm_budget_bytes
    if budget <= 0 or mesh is not None:
        return None
    needed = _needed_columns(plan)
    if not needed:
        return None
    sizes = {}
    for name, cols in needed.items():
        rel = db.get_relation(name)
        if rel is None or rel.data is None:
            return None
        sizes[name] = _table_bytes(rel, cols)
    big = [n for n, b in sizes.items() if b > budget // 2]
    if len(big) != 1:
        return None
    big = big[0]
    if sum(b for n, b in sizes.items() if n != big) > budget // 2:
        return None   # resident side alone blows the budget
    if _count_scans(plan, big) != 1:
        return None   # a second resident scan of big would blow the budget

    agg = _lowest_aggregate_over(plan, big)
    if agg is not None and not _has_subquery(agg):
        path = _scan_path(agg.input, big)
        if path is not None:
            sp = _agg_stream_plan(plan, db, big, agg, path, sizes, budget)
            if sp is not None:
                return sp
    # No decomposable aggregate prefix: stream the scan->filter->probe chain
    # itself and materialize its (usually filtered-down) rows per segment;
    # everything above the chain runs once over the concatenated rows.
    return _row_stream_plan(plan, db, big, sizes, budget)


def _count_scans(plan, name: str) -> int:
    n = 1 if isinstance(plan, L.TableScan) and plan.relation_name == name \
        else 0
    return n + sum(_count_scans(c, name) for c in plan.children())


def _finish_stream_plan(plan, db, big, partial_plan, partial_attrs,
                        merge_plan, path, sizes, budget):
    """Shared tail: SMA-prunable conjuncts + segment sizing."""
    scan = path[-1]
    scan_ids = {a.expr_id: a.name for a in scan.attrs}
    filters: List[Expr] = []
    for node in path:
        if isinstance(node, L.Filter):
            for c in split_conjuncts(node.predicate):
                if c.referenced_attrs() <= set(scan_ids):
                    filters.append(c)

    # segment sizing: ~quarter of the budget per segment transfer
    rel = db.get_relation(big)
    n = rel.data.num_rows
    row_bytes = max(1, sizes[big] // max(n, 1))
    seg_rows = max(8, (budget // 4) // row_bytes)
    seg_rows = min(seg_rows, n)
    seg_rows = max(8, (seg_rows // 8) * 8)
    n_segments = -(-n // seg_rows)
    if n_segments <= 1:
        return None
    return StreamPlan(big_table=big, partial_plan=partial_plan,
                      merge_plan=merge_plan, partial_attrs=partial_attrs,
                      scan_filters=filters, scan_attr_cols=scan_ids,
                      seg_rows=seg_rows, n_segments=n_segments)


def _agg_stream_plan(plan, db, big, agg, path, sizes, budget):
    dec = _decompose(agg)
    if dec is None:
        return _distinct_agg_stream_plan(plan, db, big, agg, path, sizes,
                                         budget)
    partial_specs, pagg_attrs, merge_specs, merge_attrs, final_exprs = dec

    # partial plan: same subtree, decomposed aggregates; group keys keep
    # fresh ids in the partial output (merged + remapped at the end)
    pgroup_attrs = [OutAttr(next_expr_id(), f"__g{i}", a.type, a.dictionary)
                    for i, a in enumerate(agg.group_attrs)]
    partial_plan = L.Aggregate(input=agg.input, group_by=list(agg.group_by),
                               group_attrs=pgroup_attrs,
                               aggregates=partial_specs,
                               agg_attrs=pagg_attrs)
    partial_attrs = list(pgroup_attrs) + list(pagg_attrs)

    # merge plan: scan the concatenated partials, re-aggregate by the group
    # keys, then Project back onto the ORIGINAL output attr ids so everything
    # above the original Aggregate runs unchanged
    pscan = L.TableScan(relation_name=PARTIALS_REL,
                        attrs=[dataclasses.replace(a) for a in partial_attrs])
    mgroup_attrs = [OutAttr(next_expr_id(), a.name, a.type, a.dictionary)
                    for a in pgroup_attrs]
    magg = L.Aggregate(
        input=pscan,
        group_by=[Attr(expr_id=g.expr_id, type=g.type) for g in pgroup_attrs],
        group_attrs=mgroup_attrs,
        aggregates=merge_specs, agg_attrs=merge_attrs)
    proj_exprs: List[Expr] = [
        Attr(expr_id=g.expr_id, type=g.type) for g in mgroup_attrs
    ] + final_exprs
    proj_attrs = [dataclasses.replace(a)
                  for a in list(agg.group_attrs) + list(agg.agg_attrs)]
    merge_top = L.Project(input=magg, exprs=proj_exprs, attrs=proj_attrs)
    merge_plan = _replace_node(plan, agg, merge_top)
    return _finish_stream_plan(plan, db, big, partial_plan, partial_attrs,
                               merge_plan, path, sizes, budget)


def _distinct_agg_stream_plan(plan, db, big, agg, path, sizes, budget):
    """DISTINCT-aggregate decomposition (the reference's distinctify tables,
    storage/AggregationOperationState.cpp): per segment emit the DISTINCT
    (group keys, arg) tuples; the merge phase re-runs the original DISTINCT
    aggregate over their union — dedup across segments happens there, so the
    per-segment dedup only shrinks the partials."""
    if not agg.aggregates or not all(s.distinct for s in agg.aggregates):
        return None
    args = [s.arg for s in agg.aggregates]
    if any(a is None for a in args):
        return None
    # all distinct aggs must share one argument (one distinctify table)
    if len({a.key() for a in args}) != 1:
        return None
    arg = args[0]

    pgroup_attrs = [OutAttr(next_expr_id(), f"__g{i}", a.type, a.dictionary)
                    for i, a in enumerate(agg.group_attrs)]
    arg_attr = OutAttr(next_expr_id(), "__darg", arg.type,
                       _attr_dictionary(arg))
    partial_plan = L.Distinct(input=L.Project(
        input=agg.input,
        exprs=list(agg.group_by) + [arg],
        attrs=pgroup_attrs + [arg_attr]))
    partial_attrs = pgroup_attrs + [arg_attr]

    pscan = L.TableScan(relation_name=PARTIALS_REL,
                        attrs=[dataclasses.replace(a) for a in partial_attrs])
    mgroup_attrs = [OutAttr(next_expr_id(), a.name, a.type, a.dictionary)
                    for a in pgroup_attrs]
    arg_ref = Attr(expr_id=arg_attr.expr_id, type=arg_attr.type)
    if arg_attr.dictionary is not None:
        arg_ref._dictionary = arg_attr.dictionary
    magg = L.Aggregate(
        input=pscan,
        group_by=[Attr(expr_id=g.expr_id, type=g.type) for g in pgroup_attrs],
        group_attrs=mgroup_attrs,
        aggregates=[dataclasses.replace(s, arg=arg_ref)
                    for s in agg.aggregates],
        agg_attrs=[OutAttr(next_expr_id(), a.name, a.type, a.dictionary)
                   for a in agg.agg_attrs])
    proj_exprs: List[Expr] = [
        Attr(expr_id=g.expr_id, type=g.type) for g in mgroup_attrs
    ] + [Attr(expr_id=a.expr_id, type=a.type) for a in magg.agg_attrs]
    proj_attrs = [dataclasses.replace(a)
                  for a in list(agg.group_attrs) + list(agg.agg_attrs)]
    merge_top = L.Project(input=magg, exprs=proj_exprs, attrs=proj_attrs)
    merge_plan = _replace_node(plan, agg, merge_top)
    return _finish_stream_plan(plan, db, big, partial_plan, partial_attrs,
                               merge_plan, path, sizes, budget)


def _attr_dictionary(e):
    return getattr(e, "_dictionary", None)


def _root_path(plan, big) -> Optional[List[L.LogicalNode]]:
    """Root-first node path from `plan` to the unique TableScan(big)."""
    if isinstance(plan, L.TableScan):
        return [plan] if plan.relation_name == big else None
    for c in plan.children():
        sub = _root_path(c, big)
        if sub is not None:
            return [plan] + sub
    return None


def _row_stream_plan(plan, db, big, sizes, budget):
    """Row streaming for plans with no decomposable aggregate prefix
    (join-only plans, DISTINCT over joins, non-decomposable aggregates):
    the longest scan->Filter/Project/probe-Join/Distinct chain above the big
    scan runs per segment; its materialized rows replace the chain in the
    full plan. Per-segment Distinct is kept in the chain (idempotent — the
    merge phase re-deduplicates across segments)."""
    path = _root_path(plan, big)
    if path is None:
        return None
    top = len(path) - 1
    for i in range(len(path) - 2, -1, -1):
        parent, child = path[i], path[i + 1]
        if isinstance(parent, (L.Filter, L.Project)) and \
                parent.input is child:
            top = i
            continue
        if isinstance(parent, L.Distinct) and parent.input is child:
            # per-segment dedup is sound only if the merge re-deduplicates:
            # the Distinct becomes the chain root (merge wraps pscan in a
            # fresh Distinct), so stop extending here
            top = i
            break
        if isinstance(parent, L.Join) and parent.left is child and \
                parent.kind in ("inner", "left", "semi", "anti") and \
                not _contains_scan(parent.right, big):
            # probe side streams; build side stays resident (the
            # HashJoinOperator block-at-a-time probe at segment granularity)
            top = i
            continue
        break
    root = path[top]
    if root is path[-1]:
        return None   # nothing streamable above the scan itself
    if _has_subquery(root):
        return None
    chain = path[top:]

    out_attrs = list(root.output)
    if len({a.expr_id for a in out_attrs}) != len(out_attrs):
        return None
    # partials keep the ORIGINAL expr_ids (the plan above is reused as-is);
    # names are uniquified for the temp-relation columns
    partial_attrs = [dataclasses.replace(a, name=f"__r{i}")
                     for i, a in enumerate(out_attrs)]
    pscan = L.TableScan(relation_name=PARTIALS_REL,
                        attrs=[dataclasses.replace(a)
                               for a in partial_attrs])
    merge_core: L.LogicalNode = pscan
    if isinstance(root, L.Distinct):
        merge_core = L.Distinct(input=pscan)
    # identity Project restores the original display names (ids unchanged)
    restore = L.Project(
        input=merge_core,
        exprs=[Attr(expr_id=a.expr_id, type=a.type) for a in out_attrs],
        attrs=[dataclasses.replace(a) for a in out_attrs])
    merge_plan = _replace_node(plan, root, restore)
    if merge_plan is plan and root is not plan:
        return None
    return _finish_stream_plan(plan, db, big, root, partial_attrs,
                               merge_plan, chain, sizes, budget)


# ---------------------------------------------------------------------
# SMA pruning
# ---------------------------------------------------------------------

def segment_minmax(rel, col: str, seg_rows: int, n_segments: int):
    """Per-segment (min, max) for one column, cached per table version — the
    SMAIndexSubBlock analog, built lazily on first streamed scan. When a
    CREATE INDEX block summary exists (catalog.build_sma_blocks), segment
    ranges are aggregated from it without touching the column."""
    cache = rel.__dict__.setdefault("_sma_cache", {})
    key = (col, seg_rows, rel.version)
    hit = cache.get(key)
    if hit is not None:
        return hit
    if col in rel.sma_blocks:
        from quickstep_tpu_torch.catalog.catalog import sma_range_for
        n = rel.data.num_rows
        out = [sma_range_for(rel, col, s * seg_rows,
                             min((s + 1) * seg_rows, n))
               for s in range(n_segments)]
        if all(r is not None for r in out):
            cache.clear()
            cache[key] = out
            return out
    arr = np.asarray(rel.data.columns[col].data)
    out = []
    for s in range(n_segments):
        seg = arr[s * seg_rows:(s + 1) * seg_rows]
        out.append((seg.min(), seg.max()) if seg.size else (0, 0))
    cache.clear()   # one version at a time
    cache[key] = out
    return out


class AdaptiveProber:
    """Runtime-adaptive filter probe ordering — the TPU-native analog of the
    reference's LIPFilterAdaptiveProber (utility/lip_filter/
    LIPFilterAdaptiveProber.hpp:51,89). On TPU the device predicate is one
    fused vector program (no short-circuit to reorder), so the adaptive
    surface is the HOST side of streamed scans: SMA segment-pruning conjuncts
    are probed in decreasing OBSERVED reject rate, re-estimated as segments
    stream. A conjunct whose plan-time selectivity estimate was misleading
    sinks within a few segments, and later conjuncts are never evaluated for
    a segment the first conjunct already rejected."""

    def __init__(self, n: int):
        self.checks = [0] * n
        self.rejects = [0] * n
        self.evaluations = 0   # total conjunct probes across all segments

    def order(self) -> List[int]:
        # Laplace-smoothed reject rate, stable order for ties
        return sorted(range(len(self.checks)),
                      key=lambda i: (-(self.rejects[i] + 1.0) /
                                     (self.checks[i] + 2.0), i))


def segment_survives(filters: List[Expr], scan_cols: Dict[int, str], rel,
                     seg: int, seg_rows: int, n_segments: int,
                     prober: Optional[AdaptiveProber] = None) -> bool:
    """False only when some conjunct provably rejects every row of the
    segment (conservative: unknown shapes keep the segment). With a prober,
    conjuncts are evaluated in observed-reject-rate order and stop at the
    first rejection."""
    idxs = prober.order() if prober is not None else range(len(filters))
    for i in idxs:
        f = filters[i]
        iv = _conjunct_interval(f)
        if iv is None:
            continue
        attr_id, op, val = iv
        col = scan_cols.get(attr_id)
        if col is None:
            continue
        mn, mx = segment_minmax(rel, col, seg_rows, n_segments)[seg]
        rejected = ((op == "<" and not (mn < val)) or
                    (op == "<=" and not (mn <= val)) or
                    (op == ">" and not (mx > val)) or
                    (op == ">=" and not (mx >= val)) or
                    (op == "=" and not (mn <= val <= mx)))
        if prober is not None:
            prober.checks[i] += 1
            prober.evaluations += 1
            if rejected:
                prober.rejects[i] += 1
        if rejected:
            return False
    return True


_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "="}


def _conjunct_interval(f) -> Optional[Tuple[int, str, object]]:
    """(attr_id, op, literal) for simple comparisons, else None."""
    if not isinstance(f, Cmp) or f.op == "<>":
        return None
    lhs, rhs, op = f.lhs, f.rhs, f.op
    if isinstance(lhs, Lit) and isinstance(rhs, Attr):
        lhs, rhs, op = rhs, lhs, _FLIP[op]
    if isinstance(lhs, Attr) and isinstance(rhs, Lit) and \
            isinstance(rhs.value, (int, float)):
        return lhs.expr_id, op, rhs.value
    return None
