# Copied from quickstep_tpu/optimizer/resolver.py; only the package name in imports differs.
"""The resolver: AST -> typed logical plan.

Capability parity with the reference's query_optimizer/resolver/Resolver.{hpp,cpp}
(3.5k LoC semantic analyzer: name/type resolution, implicit casts, aggregate checks,
star expansion, subquery representation) PLUS the UnnestSubqueries logical rule
(query_optimizer/rules/UnnestSubqueries.cpp): correlated scalar-aggregate subqueries are
decorrelated into group-by + left-join, and [NOT] IN / [NOT] EXISTS become semi/anti
joins, during resolution.

String lowering happens here too (this engine's ordered-dictionary design): comparisons
against string literals become code comparisons via Dictionary.lower_bound/upper_bound,
LIKE/REGEXP/IN become DictBitmapProbe, SUBSTRING becomes a code remap.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from quickstep_tpu_torch.errors import ResolutionError
from quickstep_tpu_torch.catalog import CatalogDatabase
from quickstep_tpu_torch.parser import ast_nodes as A
from quickstep_tpu_torch.types import (
    Type, TypeID, TypeFactory, INT, LONG, FLOAT, DOUBLE, DATE, DATETIME,
)
from quickstep_tpu_torch.types.datetime_util import date_add_months, date_add_days, US_PER_DAY
from quickstep_tpu_torch.expressions.scalar import (
    Expr, Attr, Lit, Arith, Cmp, Logical, Not, IsNull, Case, Cast, ExtractDate,
    InSet, DictBitmapProbe, Substr, DateArith, DecimalToDouble, make_and,
    split_conjuncts,
)
from quickstep_tpu_torch.expressions.aggregate import AggregateSpec
from quickstep_tpu_torch.optimizer import logical as L
from quickstep_tpu_torch.optimizer.logical import OutAttr, next_expr_id
from quickstep_tpu_torch.storage.dictionary import Dictionary


# =====================================================================
# scope machinery
# =====================================================================


def _attr_of(a: OutAttr) -> Attr:
    """Attr reference to an OutAttr, carrying its dictionary."""
    node = Attr(expr_id=a.expr_id, name=a.name, type=a.type)
    if a.dictionary is not None:
        node._dictionary = a.dictionary
    return node

class Scope:
    """Name -> attribute resolution frames, with an outer link for correlation."""

    def __init__(self, parent: Optional["Scope"] = None):
        self.parent = parent
        self.qualified: Dict[Tuple[str, str], OutAttr] = {}
        self.unqualified: Dict[str, List[OutAttr]] = {}
        self.local_ids: set = set()

    def add(self, qualifier: Optional[str], attr: OutAttr):
        if qualifier:
            self.qualified[(qualifier.lower(), attr.name.lower())] = attr
        self.unqualified.setdefault(attr.name.lower(), []).append(attr)
        self.local_ids.add(attr.expr_id)

    def add_all(self, qualifier: Optional[str], attrs: List[OutAttr]):
        for a in attrs:
            self.add(qualifier, a)

    def lookup(self, name: str, table: Optional[str], node: A.Node
               ) -> Tuple[OutAttr, bool]:
        """Returns (attr, is_outer)."""
        scope, depth = self, 0
        while scope is not None:
            if table:
                hit = scope.qualified.get((table.lower(), name.lower()))
                if hit is not None:
                    return hit, depth > 0
            else:
                hits = scope.unqualified.get(name.lower(), [])
                if len(hits) == 1:
                    return hits[0], depth > 0
                if len(hits) > 1:
                    raise ResolutionError(f"ambiguous column {name}",
                                          node.line, node.column)
            scope = scope.parent
            depth += 1
        qual = f"{table}." if table else ""
        raise ResolutionError(f"unknown column {qual}{name}", node.line, node.column)


@dataclasses.dataclass
class PendingJoin:
    """A join obligation produced while resolving a WHERE conjunct containing a
    subquery: attached to the outer join tree after it is built."""
    kind: str                    # 'semi' | 'anti' | 'scalar_agg' (left join)
    #                              | 'scalar_agg_general' (theta decorrelation)
    plan: L.LogicalNode
    outer_keys: List[Expr]
    inner_keys: List[Expr]       # attrs of plan.output
    residual: Optional[Expr] = None
    post_predicate: Optional[Expr] = None  # for scalar_agg comparisons
    null_aware: bool = False     # [NOT] IN three-valued semantics on key 0
    # scalar_agg_general only: the aggregate specs/attrs computed per outer row
    agg_specs: Optional[List[AggregateSpec]] = None
    agg_attrs: Optional[List[OutAttr]] = None


class ResolveState:
    def __init__(self):
        self.pending_joins: List[PendingJoin] = []
        self.uncorrelated_scalar_subplans: List[L.LogicalNode] = []


# =====================================================================
# resolver
# =====================================================================

class Resolver:
    def __init__(self, database: CatalogDatabase):
        self.db = database
        self.cte_registry: Dict[str, L.LogicalNode] = {}

    # ----------------------------------------------------------------
    def resolve_select(self, stmt: A.SelectStmt,
                       outer_scope: Optional[Scope] = None) -> L.LogicalNode:
        # WITH entries visible to this select and its subqueries.
        saved_ctes = dict(self.cte_registry)
        try:
            for entry in stmt.with_entries:
                plan = self.resolve_select(entry.query, outer_scope=None)
                if entry.column_aliases:
                    if len(entry.column_aliases) != len(plan.output):
                        raise ResolutionError(
                            f"WITH {entry.name}: {len(entry.column_aliases)} column "
                            f"aliases for {len(plan.output)} columns",
                            entry.line, entry.column)
                    plan = _rename(plan, entry.column_aliases)
                self.cte_registry[entry.name.lower()] = plan
            plan = self._resolve_select_core(stmt, outer_scope)
            # set-operation chain
            for op, rhs_ast in stmt.set_ops:
                rhs = self.resolve_select(rhs_ast, outer_scope)
                plan = self._make_set_op(op, plan, rhs, stmt)
            if stmt.set_ops:
                if stmt.set_order_by:
                    plan = self._attach_order_limit_post(plan, stmt)
                elif stmt.set_limit is not None:
                    plan = L.Limit(input=plan, limit=stmt.set_limit)
            return plan
        finally:
            self.cte_registry = saved_ctes

    # ----------------------------------------------------------------
    def _resolve_select_core(self, stmt: A.SelectStmt,
                             outer_scope: Optional[Scope]) -> L.LogicalNode:
        scope = Scope(parent=outer_scope)
        state = ResolveState()

        # ---- FROM ----
        from_plans: List[L.LogicalNode] = []
        for tref in stmt.from_tables:
            plan = self._resolve_table_ref(tref, scope)
            from_plans.append(plan)
        if not from_plans:
            # SELECT without FROM: single-row dummy
            from_plans = [L.Generator(start=1, end=1, step=1, attrs=[
                OutAttr(next_expr_id(), "dummy", INT)])]

        # ---- WHERE ----
        filters: List[Expr] = []
        if stmt.where is not None:
            for conj in _ast_conjuncts(stmt.where):
                e = self._resolve_conjunct(conj, scope, state)
                if e is not None:
                    filters.append(e)

        # ---- join tree ----
        plan = self._build_join_tree(from_plans, filters, state)

        # ---- aggregation detection ----
        has_agg = any(_contains_aggregate(it.expr) for it in stmt.select_list) or \
            (stmt.having is not None) or bool(stmt.group_by)

        select_items = self._expand_stars(stmt.select_list, scope)

        # ---- window aggregates (evaluated over the joined/filtered input) ----
        plan = self._plan_window_aggregates(stmt, select_items, plan, scope,
                                            state)

        if has_agg:
            plan, proj_exprs, proj_names = self._resolve_aggregate_select(
                stmt, select_items, plan, scope, state)
        else:
            proj_exprs = []
            proj_names = []
            for item in select_items:
                e = self._resolve_expr(item.expr, scope, state)
                proj_exprs.append(e)
                proj_names.append(item.alias or _default_name(item.expr))
            # pending joins introduced by subqueries in the select list
            plan = self._attach_pending_joins(plan, state)

        distinct_map = None
        if stmt.distinct:
            # project then dedup
            pre_exprs = list(proj_exprs)
            plan = self._make_project(plan, proj_exprs, proj_names)
            plan = L.Distinct(input=plan)
            # ORDER BY expressions must land on the distinct OUTPUT columns
            # (pre-projection attrs are gone after dedup): map the original
            # select expressions' fingerprints to the output attrs
            distinct_map = {e.key(): a
                            for e, a in zip(pre_exprs, plan.output)}
            proj_exprs = [_attr_of(a) for a in plan.output]
            proj_names = [a.name for a in plan.output]

        # ---- ORDER BY / LIMIT (branch-local even under a set operation) ----
        if stmt.order_by:
            plan = self._resolve_order_by(stmt, plan, proj_exprs, proj_names,
                                          scope, state,
                                          distinct_map=distinct_map)
        else:
            plan = self._make_project(plan, proj_exprs, proj_names)
            if stmt.limit is not None:
                plan = L.Limit(input=plan, limit=stmt.limit)
        return plan

    # ----------------------------------------------------------------
    def _resolve_table_ref(self, tref: A.TableRef, scope: Scope) -> L.LogicalNode:
        if isinstance(tref, A.BaseTableRef):
            qualifier = tref.alias or tref.name
            cte = self.cte_registry.get(tref.name.lower())
            if cte is not None:
                node = _reref(cte, tref.name)
                scope.add_all(qualifier, node.output)
                return node
            rel = self.db.get_relation(tref.name)
            if rel is None:
                raise ResolutionError(f"Unrecognized relation {tref.name}",
                                      tref.line, tref.column)
            attrs = []
            for a in rel.attributes:
                col = rel.data.columns[a.name]
                attrs.append(OutAttr(next_expr_id(), a.name, a.type, col.dictionary))
            node = L.TableScan(relation_name=rel.name, attrs=attrs, alias=tref.alias,
                               sample_kind=tref.sample_kind,
                               sample_percent=tref.sample_percent)
            scope.add_all(qualifier, attrs)
            return node
        if isinstance(tref, A.SubqueryTableRef):
            sub = self.resolve_select(tref.subquery, outer_scope=None)
            if tref.column_aliases:
                if len(tref.column_aliases) != len(sub.output):
                    raise ResolutionError(
                        "column alias count mismatch", tref.line, tref.column)
                sub = _rename(sub, tref.column_aliases)
            scope.add_all(tref.alias, sub.output)
            return sub
        if isinstance(tref, A.JoinRef):
            return self._resolve_join_ref(tref, scope)
        if isinstance(tref, A.GeneratorTableRef):
            if tref.name.lower() != "generate_series":
                raise ResolutionError(f"unknown table function {tref.name}",
                                      tref.line, tref.column)
            # arg checks: message parity with expressions/table_generator/
            # GenerateSeries.hpp:88 (concretize) error strings
            if len(tref.args) not in (2, 3):
                raise ResolutionError("Invalid number of arguments",
                                      tref.line, tref.column)
            args = [self._resolve_expr(a, scope, ResolveState()) for a in tref.args]
            vals = []
            for a in args:
                if not isinstance(a, Lit) or isinstance(a.value, str) or \
                        a.value is None:
                    raise ResolutionError("Invalid argument types",
                                          tref.line, tref.column)
                vals.append(a.value)
            start = vals[0]
            end = vals[1]
            step = vals[2] if len(vals) > 2 else 1
            if step == 0 or (end - start) * step < 0:
                raise ResolutionError("Invalid step width",
                                      tref.line, tref.column)
            col_name = (tref.column_aliases[0] if tref.column_aliases
                        else "generate_series")
            # output type = unified type of the arguments (GenerateSeries.hpp:88)
            gen_t = args[0].type
            for a in args[1:]:
                gen_t = TypeFactory.unify(gen_t, a.type) or LONG
            if gen_t.is_floating:
                from quickstep_tpu_torch.types import DOUBLE as _D
                gen_t = _D
                start, end, step = float(start), float(end), float(step)
            attr = OutAttr(next_expr_id(), col_name, gen_t)
            node = L.Generator(start=start, end=end, step=step, attrs=[attr])
            scope.add_all(tref.alias or "generate_series", node.output)
            return node
        raise ResolutionError(f"unsupported table reference {type(tref).__name__}")

    def _resolve_join_ref(self, tref: A.JoinRef, scope: Scope) -> L.LogicalNode:
        left = self._resolve_table_ref(tref.left, scope)
        right = self._resolve_table_ref(tref.right, scope)
        state = ResolveState()
        cond = self._resolve_expr(tref.condition, scope, state) \
            if tref.condition is not None else None
        left_ids = {a.expr_id for a in left.output}
        right_ids = {a.expr_id for a in right.output}
        lkeys, rkeys, residual = _extract_equi_keys(cond, left_ids, right_ids)
        kind = tref.kind
        if kind in ("inner", "cross"):
            return L.Join(left=left, right=right, kind="inner" if cond else "cross",
                          left_keys=lkeys, right_keys=rkeys, residual=residual)
        if kind == "right":
            return L.Join(left=right, right=left, kind="left",
                          left_keys=rkeys, right_keys=lkeys, residual=residual)
        return L.Join(left=left, right=right, kind=kind,
                      left_keys=lkeys, right_keys=rkeys, residual=residual)

    # ----------------------------------------------------------------
    def _build_join_tree(self, from_plans: List[L.LogicalNode],
                         filters: List[Expr], state: ResolveState) -> L.LogicalNode:
        """Combine the FROM-list + WHERE conjuncts into a join tree.

        Construction-time equivalents of the reference's PushDownFilter and
        GenerateJoins rules: single-relation conjuncts become Filters on their
        relation; two-sided equality conjuncts become equi-join edges; the rest
        become residuals above the join of the involved relations. Join ORDER is
        chosen later by the physical planner (rules.py).
        """
        comp_ids: List[set] = [{a.expr_id for a in p.output} for p in from_plans]
        comps: List[L.LogicalNode] = list(from_plans)
        local_filters: List[List[Expr]] = [[] for _ in comps]
        join_edges: List[Tuple[int, int, Expr, Expr]] = []
        residuals: List[Expr] = []

        # Factor conjuncts common to every OR branch (the reference's
        # disjunctive-predicate handling): turns Q19-style
        # (p=l AND a1) OR (p=l AND a2) into p=l AND (a1 OR a2), so the equality
        # becomes a join edge instead of forcing a cross join.
        expanded: List[Expr] = []
        for f in filters:
            expanded.extend(_factor_common_disjuncts(f))
        filters = expanded

        # Implied-predicate derivation from disjunctions (Q7/Q19 shape): for
        # OR(AND(...), AND(...), ...) spanning several relations, each single
        # relation R for which EVERY branch carries at least one R-only
        # conjunct implies the pushable filter OR(AND(R-only conjs of b) for
        # each branch b). The original residual stays; the derived filter
        # lands on R's scan, so joins above run at filtered size instead of
        # filtering only at the top. Sound under 3VL: a row passing the OR
        # has a TRUE branch, whose R-only conjuncts are TRUE, making the
        # derived OR TRUE. (The reference has no analog; its Q7/Q19 pay the
        # full-size joins. This is the classic magic "implied local
        # predicate" rewrite, here feeding the estimate-driven pre-join
        # compaction so the derived selectivity shrinks every downstream
        # join input.)
        derived: List[Expr] = []
        for f in filters:
            if not (isinstance(f, Logical) and f.op == "OR"):
                continue
            branches = _split_disjuncts(f)
            if len(branches) < 2:
                continue
            branch_conjs = [split_conjuncts(b) for b in branches]
            for cid in comp_ids:
                per_branch = []
                for bc in branch_conjs:
                    local = [c for c in bc
                             if c.referenced_attrs()
                             and c.referenced_attrs() <= cid]
                    if not local:
                        per_branch = None
                        break
                    per_branch.append(make_and(local))
                if per_branch is not None:
                    derived.append(Logical(op="OR", operands=per_branch,
                                           type=INT))
        filters = filters + derived

        def comp_of(ids: set) -> Optional[int]:
            for i, cid in enumerate(comp_ids):
                if ids <= cid:
                    return i
            return None

        for f in filters:
            ids = f.referenced_attrs()
            target = comp_of(ids)
            if target is not None:
                local_filters[target].append(f)
                continue
            if isinstance(f, Cmp) and f.op == "=":
                lids = f.lhs.referenced_attrs()
                rids = f.rhs.referenced_attrs()
                li = comp_of(lids) if lids else None
                ri = comp_of(rids) if rids else None
                if li is not None and ri is not None and li != ri:
                    if f.lhs.type.type_id != f.rhs.type.type_id:
                        # parity with ExecutionGenerator::convertHashJoin
                        # (query_optimizer/ExecutionGenerator.cpp) — hash keys
                        # must be of one type
                        raise ResolutionError(
                            "Equality join predicate between two attributes of "
                            "different types is not allowed in HashJoin")
                    join_edges.append((li, ri, f.lhs, f.rhs))
                    continue
            residuals.append(f)

        for i, fs in enumerate(local_filters):
            if fs:
                comps[i] = L.Filter(input=comps[i], predicate=make_and(fs))

        # Connect components along equi-join edges (smallest-first order is decided by
        # the physical join-ordering rule; here keep edge discovery order).
        alive = list(range(len(comps)))
        while join_edges:
            li, ri, lk, rk = join_edges[0]
            # gather all edges between the same pair
            same, rest = [], []
            for e in join_edges:
                if (e[0] == li and e[1] == ri) or (e[0] == ri and e[1] == li):
                    same.append(e)
                else:
                    rest.append(e)
            lkeys = [e[2] if e[0] == li else e[3] for e in same]
            rkeys = [e[3] if e[0] == li else e[2] for e in same]
            new_node = L.Join(left=comps[li], right=comps[ri], kind="inner",
                              left_keys=lkeys, right_keys=rkeys)
            new_ids = comp_ids[li] | comp_ids[ri]
            comps[li] = new_node
            comp_ids[li] = new_ids
            comps[ri] = None
            comp_ids[ri] = set()
            # remap rest edges from ri -> li
            join_edges = [
                (li if e[0] == ri else e[0], li if e[1] == ri else e[1], e[2], e[3])
                for e in rest]
            # collapse self-edges into residuals (same component now)
            nxt = []
            for e in join_edges:
                if e[0] == e[1]:
                    residuals.append(Cmp(op="=", lhs=e[2], rhs=e[3], type=INT))
                else:
                    nxt.append(e)
            join_edges = nxt
            alive = [i for i in alive if comps[i] is not None]
            # attach residuals that are now fully contained
            still = []
            for r in residuals:
                ids = r.referenced_attrs()
                t = comp_of(ids)
                if t is not None:
                    comps[t] = L.Filter(input=comps[t], predicate=r)
                else:
                    still.append(r)
            residuals = still

        alive = [i for i in range(len(comps)) if comps[i] is not None]
        plan = comps[alive[0]]
        ids = comp_ids[alive[0]]
        for i in alive[1:]:
            plan = L.Join(left=plan, right=comps[i], kind="cross")
            ids |= comp_ids[i]
        # Residuals may reference attrs produced by pending subquery joins
        # (e.g. Q2's "ps_supplycost = <decorrelated min>"), so attach those first.
        plan = self._attach_pending_joins(plan, state)
        if residuals:
            plan = L.Filter(input=plan, predicate=make_and(residuals))
        return plan

    def _attach_pending_joins(self, plan: L.LogicalNode,
                              state: ResolveState) -> L.LogicalNode:
        post_filters = []
        for pj in state.pending_joins:
            if pj.kind in ("semi", "anti"):
                plan = L.Join(left=plan, right=pj.plan, kind=pj.kind,
                              left_keys=pj.outer_keys, right_keys=pj.inner_keys,
                              residual=pj.residual, null_aware=pj.null_aware)
            elif pj.kind == "scalar_agg_general":
                # Aggregate-over-theta-join decorrelation: the outer rows get a
                # synthetic unique id; a LEFT join with equality keys + theta
                # residual produces one row per (outer row, matching inner
                # row); the aggregate groups by the id; a final join by id
                # attaches each outer row's aggregate. The outer subtree is
                # referenced twice and re-executed — acceptable for this
                # (reference-parity) fallback path, which TPC-H never takes.
                rid = OutAttr(next_expr_id(), "__rid", LONG)
                base = L.RowNumber(input=plan, out_attr=rid)
                joined = L.Join(left=base, right=pj.plan, kind="left",
                                left_keys=pj.outer_keys,
                                right_keys=pj.inner_keys,
                                residual=pj.residual)
                rid2 = OutAttr(next_expr_id(), "__rid_g", LONG)
                agg = L.Aggregate(input=joined,
                                  group_by=[_attr_of(rid)],
                                  group_attrs=[rid2],
                                  aggregates=list(pj.agg_specs),
                                  agg_attrs=list(pj.agg_attrs))
                plan = L.Join(left=base, right=agg, kind="left",
                              left_keys=[_attr_of(rid)],
                              right_keys=[_attr_of(rid2)])
                if pj.post_predicate is not None:
                    post_filters.append(pj.post_predicate)
            else:  # scalar_agg: left join, comparison applied as a filter above
                plan = L.Join(left=plan, right=pj.plan, kind="left",
                              left_keys=pj.outer_keys, right_keys=pj.inner_keys,
                              residual=pj.residual)
                if pj.post_predicate is not None:
                    post_filters.append(pj.post_predicate)
        state.pending_joins = []
        if post_filters:
            plan = L.Filter(input=plan, predicate=make_and(post_filters))
        return plan

    # ----------------------------------------------------------------
    # window aggregates
    # ----------------------------------------------------------------
    def _plan_window_aggregates(self, stmt: A.SelectStmt,
                                select_items: List[A.SelectItem],
                                plan: L.LogicalNode, scope: Scope,
                                state: ResolveState) -> L.LogicalNode:
        calls: List[A.FunctionCall] = []

        def walk(e):
            if isinstance(e, A.FunctionCall) and e.window is not None:
                calls.append(e)
                return
            if dataclasses.is_dataclass(e):
                for f in dataclasses.fields(e):
                    v = getattr(e, f.name)
                    if isinstance(v, A.Expr):
                        walk(v)
                    elif isinstance(v, list):
                        for item in v:
                            if isinstance(item, A.Expr):
                                walk(item)
                            elif isinstance(item, tuple):
                                for x in item:
                                    if isinstance(x, A.Expr):
                                        walk(x)
        for it in select_items:
            walk(it.expr)
        if not calls:
            return plan
        self._window_map = getattr(self, "_window_map", {})
        named = dict(stmt.windows)
        for fc in calls:
            spec = fc.window
            if spec.name and not spec.partition_by and not spec.order_by:
                if spec.name not in named:
                    raise ResolutionError(f"unknown window {spec.name}",
                                          fc.line, fc.column)
                spec = named[spec.name]
            if fc.name not in ("sum", "count", "avg", "min", "max"):
                raise ResolutionError(
                    f"unsupported window function {fc.name}", fc.line, fc.column)
            arg = None
            if not fc.is_star and fc.args:
                arg = self._resolve_expr(fc.args[0], scope, state)
                if arg.type.is_decimal and fc.name in ("sum", "avg"):
                    # window frames accumulate in f64 (reference float
                    # sliding-sum parity); decode decimal args up front
                    arg = _decode_decimal(arg)
            part = [self._resolve_expr(p, scope, state)
                    for p in spec.partition_by]
            okeys = [self._resolve_expr(oi.expr, scope, state)
                     for oi in spec.order_by]
            oasc = [oi.ascending for oi in spec.order_by]
            frame = None
            if spec.frame is not None:
                f = spec.frame
                frame = (f.mode,
                         None if f.start_unbounded else f.start_offset,
                         None if f.end_unbounded else f.end_offset)
            rtype = AggregateSpec.result_type_for(fc.name, arg)
            attr = OutAttr(next_expr_id(), f"w_{fc.name}", rtype,
                           _expr_dictionary(arg) if fc.name in ("min", "max")
                           else None)
            plan = L.WindowAggregate(
                input=plan,
                spec=AggregateSpec(fn=fc.name, arg=arg, distinct=fc.distinct,
                                   result_type=rtype),
                partition_by=part, order_by=okeys, order_ascending=oasc,
                frame=frame, out_attr=attr)
            self._window_map[id(fc)] = attr
        return plan

    # ----------------------------------------------------------------
    # aggregation
    # ----------------------------------------------------------------
    def _resolve_aggregate_select(self, stmt: A.SelectStmt,
                                  select_items: List[A.SelectItem],
                                  plan: L.LogicalNode, scope: Scope,
                                  state: ResolveState):
        # group-by expressions (may reference select aliases)
        alias_map = {
            (it.alias or "").lower(): it.expr for it in select_items if it.alias}
        group_exprs: List[Expr] = []
        group_names: List[str] = []
        for g in stmt.group_by:
            gast = g
            if isinstance(g, A.ColumnRef) and g.table is None and \
                    g.name.lower() in alias_map and not _scope_has(scope, g.name):
                gast = alias_map[g.name.lower()]
            ge = self._resolve_expr(gast, scope, state)
            group_exprs.append(ge)
            group_names.append(_default_name(gast))

        group_map: Dict[tuple, int] = {}
        group_attrs: List[OutAttr] = []
        for ge, gn in zip(group_exprs, group_names):
            attr = OutAttr(next_expr_id(), gn, ge.type, _expr_dictionary(ge))
            group_map[ge.key()] = attr.expr_id
            group_attrs.append(attr)
        id_by_key = {k: i for i, (k, v) in enumerate(group_map.items())}

        aggs: List[AggregateSpec] = []
        agg_attrs: List[OutAttr] = []
        agg_index: Dict[tuple, int] = {}

        def _decimal_sum_guard(arg: Expr) -> Expr:
            """SF100-scale overflow guard (ROUND3_NOTES hazard: Q1 sum_charge
            units ~1.6e18 at SF10 but ~1.6e19 > 2^63 at SF100). Exact int64
            unit accumulation is kept only when max|units| x an upper bound
            on input rows provably fits int64; otherwise the sum falls back
            to f64 accumulation of decoded values — still >= reference
            precision (the reference's TPC-H DECIMALs are DOUBLE columns
            throughout). Row bound: exact per-scan num_tuples; plans with
            joins use 4x the scan-row sum (covers FK-shaped joins; a
            pathological many-many expansion can exceed it, accepted and
            documented — parity is f64 there anyway)."""
            if not arg.type.is_decimal:
                return arg
            env: Dict[int, tuple] = {}
            rows = 0
            n_scans = 0
            have_stats = True

            def walk(n):
                nonlocal rows, n_scans, have_stats
                if isinstance(n, L.TableScan):
                    n_scans += 1
                    rel = self.db.get_relation(n.relation_name)
                    if rel is None or rel.data is None:
                        have_stats = False
                        return
                    rows += max(rel.num_tuples, 1)
                    st = rel.statistics
                    for a in n.attrs:
                        if st.exact and a.name in st.min_values and \
                                not a.type.is_string:
                            try:
                                env[a.expr_id] = (int(st.min_values[a.name]),
                                                  int(st.max_values[a.name]))
                            except (TypeError, ValueError, OverflowError):
                                # no range: a float column's statistics
                                # may be NaN (ValueError) or +-inf
                                pass
                for c in n.children():
                    walk(c)
            walk(plan)
            from quickstep_tpu_torch.optimizer.stats import infer_range
            r = infer_range(arg, env)
            if r is None or not have_stats or rows == 0:
                return arg   # no information: keep the exact path (status quo)
            if n_scans > 1:
                rows *= 4
            bound = max(abs(r[0]), abs(r[1])) * rows
            if bound < (1 << 63):
                return arg
            return DecimalToDouble(operand=arg, type=DOUBLE.with_nullable(
                arg.type.nullable))

        def make_agg(fc: A.FunctionCall) -> Attr:
            fn = fc.name
            if fc.is_star or (fn == "count" and not fc.args):
                spec_key = ("count_star", fc.distinct)
                arg = None
            else:
                if len(fc.args) != 1:
                    raise ResolutionError(f"{fn} takes one argument",
                                          fc.line, fc.column)
                arg = self._resolve_expr(fc.args[0], scope, state)
                if fn in ("sum", "avg"):
                    arg = _decimal_sum_guard(arg)
                spec_key = (fn, fc.distinct, arg.key())
            if spec_key in agg_index:
                i = agg_index[spec_key]
                return _attr_of(agg_attrs[i])
            if fn == "avg" and not fc.distinct and \
                    (("sum", False, arg.key()) in agg_index or
                     arg.type.is_decimal):
                # ReuseAggregateExpressions analog (query_optimizer/rules/
                # ReuseAggregateExpressions.hpp): AVG(e) reuses an existing
                # SUM(e) as SUM(e)/COUNT(e) — note the SQL divide typing
                # (LONG/LONG is integer division, as the reference prints).
                # AVG over DECIMAL always decomposes: the sum stays an exact
                # integer accumulation and only the final divide is f64.
                sum_key = ("sum", False, arg.key())
                if sum_key not in agg_index:
                    st = AggregateSpec.result_type_for("sum", arg)
                    agg_index[sum_key] = len(aggs)
                    aggs.append(AggregateSpec(fn="sum", arg=arg,
                                              distinct=False, result_type=st))
                    agg_attrs.append(OutAttr(next_expr_id(),
                                             f"sum_{len(aggs) - 1}", st))
                sum_attr = _attr_of(agg_attrs[agg_index[sum_key]])
                if arg.type.nullable:
                    cnt_key = ("count", False, arg.key())
                    cnt_spec = AggregateSpec(fn="count", arg=arg, distinct=False,
                                             result_type=LONG)
                else:
                    cnt_key = ("count_star", False)
                    cnt_spec = AggregateSpec(fn="count", arg=None, distinct=False,
                                             result_type=LONG)
                if cnt_key not in agg_index:
                    cattr = OutAttr(next_expr_id(), f"count_{len(aggs)}", LONG)
                    agg_index[cnt_key] = len(aggs)
                    aggs.append(cnt_spec)
                    agg_attrs.append(cattr)
                cnt_attr = _attr_of(agg_attrs[agg_index[cnt_key]])
                return self._make_binary("/", sum_attr, cnt_attr, fc)
            rtype = AggregateSpec.result_type_for(fn, arg)
            spec = AggregateSpec(fn=fn, arg=arg, distinct=fc.distinct,
                                 result_type=rtype)
            attr = OutAttr(next_expr_id(), f"{fn}_{len(aggs)}", rtype,
                           _expr_dictionary(arg) if fn in ("min", "max") and arg is not
                           None else None)
            agg_index[spec_key] = len(aggs)
            aggs.append(spec)
            agg_attrs.append(attr)
            return _attr_of(attr)

        def rewrite(ast_e: A.Expr) -> Expr:
            """Resolve a post-aggregation expression: aggregate calls -> agg attrs;
            subtrees structurally equal to a group-by expr -> group attrs."""
            if isinstance(ast_e, A.FunctionCall) and ast_e.name in (
                    "sum", "count", "avg", "min", "max") and ast_e.window is None:
                return make_agg(ast_e)
            # select-list alias (HAVING group_alias > 5)
            if isinstance(ast_e, A.ColumnRef) and ast_e.table is None and \
                    ast_e.name.lower() in alias_map and \
                    not _scope_has(scope, ast_e.name):
                return rewrite(alias_map[ast_e.name.lower()])
            # try as group expression
            try:
                e = self._resolve_expr(ast_e, scope, state)
                k = e.key()
                if k in group_map:
                    ga = group_attrs[id_by_key[k]]
                    return _attr_of(ga)
                if not e.referenced_attrs() and not _contains_aggregate(ast_e):
                    return e  # constant
            except ResolutionError:
                pass
            # recurse
            if isinstance(ast_e, A.BinaryExpr):
                le = rewrite(ast_e.left)
                re_ = rewrite(ast_e.right)
                if ast_e.op in ("AND", "OR"):
                    return Logical(op=ast_e.op, operands=[le, re_], type=INT)
                return self._make_binary(ast_e.op, le, re_, ast_e)
            if isinstance(ast_e, A.UnaryExpr):
                oe = rewrite(ast_e.operand)
                if ast_e.op == "-":
                    return Arith(op="-", lhs=Lit(value=0, type=oe.type), rhs=oe,
                                 type=oe.type)
                return Not(operand=oe, type=INT)
            if isinstance(ast_e, A.CaseExpr):
                return self._resolve_case(ast_e, scope, state, rewriter=rewrite)
            if isinstance(ast_e, A.CastExpr):
                t = TypeFactory.from_name(ast_e.target_type_name,
                                          ast_e.target_length,
                                          scale=ast_e.target_scale)
                return Cast(operand=rewrite(ast_e.operand), type=t)
            raise ResolutionError(
                "expression must appear in GROUP BY or be inside an aggregate",
                ast_e.line, ast_e.column)

        # Pre-register SUM aggregates so AVG over the same argument reuses
        # them regardless of select-list order (ReuseAggregateExpressions).
        def _prereg_sums(ast_e):
            if ast_e is None or not dataclasses.is_dataclass(ast_e):
                return
            if isinstance(ast_e, A.FunctionCall):
                if ast_e.name == "sum" and ast_e.window is None and \
                        not ast_e.distinct and ast_e.args:
                    try:
                        make_agg(ast_e)
                    except ResolutionError:
                        pass
                    return
                if ast_e.name in ("count", "avg", "min", "max") and \
                        ast_e.window is None:
                    return
            for f in dataclasses.fields(ast_e):
                v = getattr(ast_e, f.name)
                if isinstance(v, A.Expr):
                    _prereg_sums(v)
                elif isinstance(v, list):
                    for x in v:
                        if isinstance(x, A.Expr):
                            _prereg_sums(x)
                        elif isinstance(x, tuple):
                            for y in x:
                                if isinstance(y, A.Expr):
                                    _prereg_sums(y)

        def _contains_avg(ast_e):
            if not dataclasses.is_dataclass(ast_e):
                return False
            if isinstance(ast_e, A.FunctionCall) and ast_e.name == "avg" and \
                    ast_e.window is None:
                return True
            for f in dataclasses.fields(ast_e):
                v = getattr(ast_e, f.name)
                vs = v if isinstance(v, list) else [v]
                for x in vs:
                    xs = x if isinstance(x, tuple) else (x,)
                    if any(isinstance(y, A.Expr) and _contains_avg(y)
                           for y in xs):
                        return True
            return False

        if any(_contains_avg(it.expr) for it in select_items):
            for item in select_items:
                _prereg_sums(item.expr)

        proj_exprs: List[Expr] = []
        proj_names: List[str] = []
        for item in select_items:
            proj_exprs.append(rewrite(item.expr))
            proj_names.append(item.alias or _default_name(item.expr))

        having_expr = rewrite(stmt.having) if stmt.having is not None else None

        plan = self._attach_pending_joins(plan, state)
        plan = L.Aggregate(input=plan, group_by=group_exprs,
                           group_attrs=group_attrs, aggregates=aggs,
                           agg_attrs=agg_attrs)
        if having_expr is not None:
            plan = L.Filter(input=plan, predicate=having_expr)
        # Stash the rewriter so ORDER BY can resolve aggregate expressions too.
        self._last_agg_rewriter = rewrite
        return plan, proj_exprs, proj_names

    # ----------------------------------------------------------------
    # ORDER BY
    # ----------------------------------------------------------------
    def _resolve_order_by(self, stmt: A.SelectStmt, plan: L.LogicalNode,
                          proj_exprs: List[Expr], proj_names: List[str],
                          scope: Scope, state: ResolveState,
                          distinct_map=None) -> L.LogicalNode:
        """Project (select items + hidden sort keys) -> Sort -> trim Project."""
        alias_to_idx = {n.lower(): i for i, n in enumerate(proj_names)}
        sort_exprs: List[Expr] = []
        ascending: List[bool] = []
        nulls_first: List[Optional[bool]] = []
        key_slots: List[int] = []

        all_exprs = list(proj_exprs)
        all_names = list(proj_names)
        expr_key_to_idx = {}
        for i, e in enumerate(proj_exprs):
            expr_key_to_idx.setdefault(e.key(), i)

        has_agg_scope = hasattr(self, "_last_agg_rewriter") and (
            bool(stmt.group_by) or stmt.having is not None or
            any(_contains_aggregate(it.expr) for it in stmt.select_list))

        for item in stmt.order_by:
            ast_e = item.expr
            idx = None
            if isinstance(ast_e, A.ColumnRef) and ast_e.table is None and \
                    ast_e.name.lower() in alias_to_idx:
                idx = alias_to_idx[ast_e.name.lower()]
            elif isinstance(ast_e, A.Literal) and isinstance(ast_e.value, int):
                pos = int(ast_e.value) - 1
                if not (0 <= pos < len(proj_exprs)):
                    raise ResolutionError("ORDER BY position out of range",
                                          ast_e.line, ast_e.column)
                idx = pos
            if idx is None:
                if has_agg_scope:
                    e = self._last_agg_rewriter(ast_e)
                else:
                    e = self._resolve_expr(ast_e, scope, state)
                if distinct_map is not None:
                    hit = distinct_map.get(e.key())
                    if hit is None and e.key() not in expr_key_to_idx:
                        raise ResolutionError(
                            "for SELECT DISTINCT, ORDER BY expressions must "
                            "appear in the select list",
                            ast_e.line, ast_e.column)
                    if hit is not None:
                        e = _attr_of(hit)
                k = e.key()
                if k in expr_key_to_idx:
                    idx = expr_key_to_idx[k]
                else:
                    idx = len(all_exprs)
                    expr_key_to_idx[k] = idx
                    all_exprs.append(e)
                    all_names.append(f"__sort_{len(key_slots)}")
            key_slots.append(idx)
            ascending.append(item.ascending)
            nulls_first.append(item.nulls_first)

        proj = self._make_project(plan, all_exprs, all_names)
        keys = [_attr_of(proj.output[i]) for i in key_slots]
        sort = L.Sort(input=proj, keys=keys, ascending=ascending,
                      nulls_first=nulls_first, limit=stmt.limit)
        if len(all_exprs) > len(proj_exprs):
            trim = [_attr_of(a) for a in proj.output[:len(proj_exprs)]]
            return self._make_project(sort, trim, proj_names)
        return sort

    def _attach_order_limit_post(self, plan: L.LogicalNode,
                                 stmt: A.SelectStmt) -> L.LogicalNode:
        """ORDER BY/LIMIT applied to a set-operation result: resolve keys against the
        set-op output schema by name/position."""
        name_to_idx = {a.name.lower(): i for i, a in enumerate(plan.output)}
        keys, asc, nf = [], [], []
        for item in stmt.set_order_by:
            if isinstance(item.expr, A.ColumnRef) and \
                    item.expr.name.lower() in name_to_idx:
                a = plan.output[name_to_idx[item.expr.name.lower()]]
            elif isinstance(item.expr, A.Literal):
                a = plan.output[int(item.expr.value) - 1]
            else:
                raise ResolutionError("ORDER BY over a set operation must reference "
                                      "output columns", item.line, item.column)
            keys.append(_attr_of(a))
            asc.append(item.ascending)
            nf.append(item.nulls_first)
        return L.Sort(input=plan, keys=keys, ascending=asc, nulls_first=nf,
                      limit=stmt.set_limit)

    # ----------------------------------------------------------------
    # helpers for plan construction
    # ----------------------------------------------------------------
    def _make_project(self, plan: L.LogicalNode, exprs: List[Expr],
                      names: List[str]) -> L.LogicalNode:
        attrs = []
        new_exprs = []
        for e, n in zip(exprs, names):
            e = _encode_string_lit(e)
            attrs.append(OutAttr(next_expr_id(), n, e.type, _expr_dictionary(e)))
            new_exprs.append(e)
        return L.Project(input=plan, exprs=new_exprs, attrs=attrs)

    def _make_set_op(self, op: str, left: L.LogicalNode, right: L.LogicalNode,
                     stmt: A.SelectStmt) -> L.LogicalNode:
        if len(left.output) != len(right.output):
            raise ResolutionError("set operation inputs must have the same number of "
                                  "columns", stmt.line, stmt.column)
        attrs = []
        for la, ra in zip(left.output, right.output):
            t = TypeFactory.unify(la.type, ra.type)
            if t is None:
                raise ResolutionError(
                    f"set operation type mismatch: {la.type} vs {ra.type}",
                    stmt.line, stmt.column)
            d = la.dictionary
            if la.dictionary is not None and ra.dictionary is not None and \
                    la.dictionary is not ra.dictionary:
                # Output dictionary = union, so the executor can remap each input's
                # codes into it (merge(out, in) is then a no-op on `out`).
                d, _, _ = Dictionary.merge(la.dictionary, ra.dictionary)
            attrs.append(OutAttr(next_expr_id(), la.name, t, d))
        node = L.SetOperation(kind=op, inputs=[left, right], attrs=attrs)
        if op in ("union", "intersect"):
            # dedup semantics; intersect handled in executor
            if op == "union":
                return L.Distinct(input=node)
        return node

    # ================================================================
    # expression resolution
    # ================================================================
    def _resolve_conjunct(self, conj: A.Expr, scope: Scope,
                          state: ResolveState) -> Optional[Expr]:
        """Resolve one top-level WHERE conjunct; subquery predicates turn into
        pending joins and return None."""
        if isinstance(conj, A.ExistsExpr):
            self._resolve_exists(conj.subquery, conj.negated, scope, state)
            return None
        if isinstance(conj, A.UnaryExpr) and conj.op == "NOT" and \
                isinstance(conj.operand, A.ExistsExpr):
            self._resolve_exists(conj.operand.subquery,
                                 not conj.operand.negated, scope, state)
            return None
        if isinstance(conj, A.UnaryExpr) and conj.op == "NOT" and \
                isinstance(conj.operand, A.InSubqueryExpr):
            inner = conj.operand
            self._resolve_in_subquery(
                A.InSubqueryExpr(operand=inner.operand, subquery=inner.subquery,
                                 negated=not inner.negated,
                                 line=inner.line, column=inner.column), scope, state)
            return None
        if isinstance(conj, A.InSubqueryExpr):
            self._resolve_in_subquery(conj, scope, state)
            return None
        return self._resolve_expr(conj, scope, state)

    def _resolve_expr(self, e: A.Expr, scope: Scope, state: ResolveState) -> Expr:
        if isinstance(e, A.Literal):
            return _literal_to_expr(e)
        if isinstance(e, A.IntervalLiteral):
            t = Type(TypeID.DATETIME_INTERVAL) if e.kind == "datetime_interval" \
                else Type(TypeID.YEARMONTH_INTERVAL)
            return Lit(value=e.amount, type=t)
        if isinstance(e, A.ColumnRef):
            attr, _ = scope.lookup(e.name, e.table, e)
            node = Attr(expr_id=attr.expr_id, name=attr.name, type=attr.type)
            if attr.dictionary is not None:
                node._dictionary = attr.dictionary
            return node
        if isinstance(e, A.BinaryExpr):
            if e.op in ("AND", "OR"):
                return Logical(op=e.op,
                               operands=[self._resolve_expr(e.left, scope, state),
                                         self._resolve_expr(e.right, scope, state)],
                               type=INT)
            if e.op in ("LIKE", "NOT_LIKE", "REGEXP", "NOT_REGEXP"):
                return self._resolve_like(e, scope, state)
            lhs = self._resolve_expr(e.left, scope, state)
            rhs = self._resolve_expr(e.right, scope, state)
            return self._make_binary(e.op, lhs, rhs, e)
        if isinstance(e, A.UnaryExpr):
            if e.op == "NOT":
                return Not(operand=self._resolve_expr(e.operand, scope, state),
                           type=INT)
            operand = self._resolve_expr(e.operand, scope, state)
            if isinstance(operand, Lit):
                # -NULL stays NULL (NullType negation is identity)
                val = None if operand.value is None else -operand.value
                return Lit(value=val, type=operand.type)
            return Arith(op="-", lhs=Lit(value=0, type=operand.type), rhs=operand,
                         type=operand.type)
        if isinstance(e, A.IsNullExpr):
            return IsNull(operand=self._resolve_expr(e.operand, scope, state),
                          negated=e.negated, type=INT)
        if isinstance(e, A.BetweenExpr):
            operand = self._resolve_expr(e.operand, scope, state)
            low = self._resolve_expr(e.low, scope, state)
            high = self._resolve_expr(e.high, scope, state)
            lo_cmp = self._make_binary(">=", operand, low, e)
            hi_cmp = self._make_binary("<=", operand, high, e)
            node = Logical(op="AND", operands=[lo_cmp, hi_cmp], type=INT)
            if e.negated:
                return Not(operand=node, type=INT)
            return node
        if isinstance(e, A.InListExpr):
            return self._resolve_in_list(e, scope, state)
        if isinstance(e, A.CaseExpr):
            return self._resolve_case(e, scope, state)
        if isinstance(e, A.CastExpr):
            t = TypeFactory.from_name(e.target_type_name, e.target_length,
                                      scale=e.target_scale)
            return Cast(operand=self._resolve_expr(e.operand, scope, state), type=t)
        if isinstance(e, A.ExtractExpr):
            operand = self._resolve_expr(e.operand, scope, state)
            if operand.type.type_id not in (TypeID.DATE, TypeID.DATETIME):
                raise ResolutionError("EXTRACT requires a DATE or DATETIME argument",
                                      e.line, e.column)
            # DateExtractOperation returns LONG
            # (types/operations/unary_operations/DateExtractOperation.cpp)
            return ExtractDate(field=e.field, operand=operand, type=LONG)
        if isinstance(e, A.SubstringExpr):
            return self._resolve_substring(e, scope, state)
        if isinstance(e, A.ScalarSubqueryExpr):
            return self._resolve_scalar_subquery(e, scope, state)
        if isinstance(e, A.FunctionCall):
            if e.window is not None:
                attr = getattr(self, "_window_map", {}).get(id(e))
                if attr is not None:
                    return _attr_of(attr)
                raise ResolutionError("window function not allowed here",
                                      e.line, e.column)
            if e.name in ("sum", "count", "avg", "min", "max"):
                raise ResolutionError(
                    f"aggregate {e.name} not allowed here", e.line, e.column)
            raise ResolutionError(f"unknown function {e.name}", e.line, e.column)
        if isinstance(e, A.ExistsExpr) or isinstance(e, A.InSubqueryExpr):
            raise ResolutionError(
                "subquery predicates are only supported as top-level WHERE "
                "conjuncts", e.line, e.column)
        if isinstance(e, A.Star):
            raise ResolutionError("* not allowed here", e.line, e.column)
        raise ResolutionError(f"unsupported expression {type(e).__name__}",
                              e.line, e.column)

    # ---- binary op construction with typing + string/date lowering ----
    def _make_binary(self, op: str, lhs: Expr, rhs: Expr, node: A.Node) -> Expr:
        if op in ("=", "<>", "<", "<=", ">", ">="):
            return self._make_comparison(op, lhs, rhs, node)
        # arithmetic
        lt, rt = lhs.type, rhs.type
        # date/datetime +- interval
        if lt.type_id in (TypeID.DATE, TypeID.DATETIME) and rt.type_id in (
                TypeID.DATETIME_INTERVAL, TypeID.YEARMONTH_INTERVAL):
            return self._fold_date_arith(op, lhs, rhs, node)
        if rt.type_id in (TypeID.DATE, TypeID.DATETIME) and lt.type_id in (
                TypeID.DATETIME_INTERVAL, TypeID.YEARMONTH_INTERVAL) and op == "+":
            return self._fold_date_arith(op, rhs, lhs, node)
        # DATETIME - DATETIME -> DatetimeInterval
        # (types/operations/binary_operations/SubtractBinaryOperation)
        if lt.type_id == rt.type_id == TypeID.DATETIME and op == "-":
            t = Type(TypeID.DATETIME_INTERVAL)
            if isinstance(lhs, Lit) and isinstance(rhs, Lit):
                return Lit(value=lhs.value - rhs.value, type=t)
            return Arith(op="-", lhs=lhs, rhs=rhs, type=t)
        # interval +- interval (same kind)
        if lt.type_id == rt.type_id and lt.type_id in (
                TypeID.DATETIME_INTERVAL, TypeID.YEARMONTH_INTERVAL) and \
                op in ("+", "-"):
            if isinstance(lhs, Lit) and isinstance(rhs, Lit):
                v = lhs.value + rhs.value if op == "+" else lhs.value - rhs.value
                return Lit(value=v, type=lt)
            return Arith(op=op, lhs=lhs, rhs=rhs, type=lt)
        # interval * integer (either order)
        if op == "*" and lt.type_id in (TypeID.DATETIME_INTERVAL,
                                        TypeID.YEARMONTH_INTERVAL) and \
                rt.is_integral:
            if isinstance(lhs, Lit) and isinstance(rhs, Lit):
                return Lit(value=lhs.value * rhs.value, type=lt)
            return Arith(op="*", lhs=lhs, rhs=rhs, type=lt)
        if op == "*" and rt.type_id in (TypeID.DATETIME_INTERVAL,
                                        TypeID.YEARMONTH_INTERVAL) and \
                lt.is_integral:
            return self._make_binary("*", rhs, lhs, node)
        # arithmetic with a NULL literal is constantly NULL, typed by the other
        # side (reference NullCoercibilityCoreCheck: NullType coerces to any)
        if lt.type_id == TypeID.NULLTYPE or rt.type_id == TypeID.NULLTYPE:
            from quickstep_tpu_torch.types import NULL_TYPE
            return Lit(value=None, type=NULL_TYPE)
        if not (lt.is_numeric and rt.is_numeric):
            raise ResolutionError(
                f"cannot apply {op} to {lt} and {rt}", node.line, node.column)
        if lt.is_decimal or rt.is_decimal:
            return self._make_decimal_arith(op, lhs, rhs, node)
        t = TypeFactory.unify(lt, rt)
        if op == "/" and t.is_integral:
            pass  # SQL integer division keeps integral type
        result = Arith(op=op, lhs=lhs, rhs=rhs, type=t)
        if isinstance(lhs, Lit) and isinstance(rhs, Lit) and \
                lhs.value is not None and rhs.value is not None:
            return _fold_numeric(result)
        return result

    def _make_decimal_arith(self, op: str, lhs: Expr, rhs: Expr,
                            node: A.Node) -> Expr:
        """Arithmetic involving a DECIMAL operand. Stay in the exact integer
        units domain when possible (+/- at one scale; * sums the scales);
        decode to DOUBLE otherwise (division, inexact literals, scale
        overflow). This is the TPU replacement for f64 decimal math — v5e
        emulates f64, so every op kept integer runs at native VPU speed."""
        lt, rt = lhs.type, rhs.type
        nullable = lt.nullable or rt.nullable
        if op in ("+", "-"):
            l2, r2 = _align_decimal_pair(lhs, rhs)
            if l2.type.is_decimal and r2.type.is_decimal:
                t = Type(TypeID.DECIMAL, nullable=nullable,
                         precision=min(18, max(l2.type.precision,
                                               r2.type.precision) + 1),
                         scale=l2.type.scale)
                result = Arith(op=op, lhs=l2, rhs=r2, type=t)
                if isinstance(l2, Lit) and isinstance(r2, Lit) and \
                        l2.value is not None and r2.value is not None:
                    return _fold_numeric(result)
                return result
            return self._make_binary(op, l2, r2, node)
        if op == "*":
            # try to express both sides as decimals whose scales sum <= 6
            pairs = [(lhs, rhs)]
            if not (lt.is_decimal and rt.is_decimal):
                dec, other = (lhs, rhs) if lt.is_decimal else (rhs, lhs)
                o2 = None
                if isinstance(other, Lit) and other.value is not None:
                    o2 = _lit_as_decimal(other, max_scale=6 - dec.type.scale)
                elif other.type.is_integral:
                    o2 = _integral_to_decimal(other, 0)
                if o2 is not None:
                    pairs = [(dec, o2) if lt.is_decimal else (o2, dec)]
                else:
                    pairs = []
            for l2, r2 in pairs:
                s = l2.type.scale + r2.type.scale
                if s > 6:
                    break
                t = Type(TypeID.DECIMAL, nullable=nullable,
                         precision=min(18, l2.type.precision +
                                       r2.type.precision),
                         scale=s)
                result = Arith(op="*", lhs=l2, rhs=r2, type=t)
                if isinstance(l2, Lit) and isinstance(r2, Lit) and \
                        l2.value is not None and r2.value is not None:
                    return _fold_numeric(result)
                return result
        # division / modulo / anything inexact: decode to DOUBLE
        return self._make_binary(op, _decode_decimal(lhs),
                                 _decode_decimal(rhs), node)

    def _make_comparison(self, op: str, lhs: Expr, rhs: Expr, node: A.Node) -> Expr:
        lt, rt = lhs.type, rhs.type
        # string vs string-literal -> ordered-code comparison
        if lt.is_string or rt.is_string:
            return self._make_string_comparison(op, lhs, rhs, node)
        if lt.is_decimal or rt.is_decimal:
            # keep decimal comparisons in the integer units domain when exact
            # (the compressed-code comparison analog); decode to f64 otherwise
            lhs, rhs = _align_decimal_pair(lhs, rhs)
            return Cmp(op=op, lhs=lhs, rhs=rhs, type=INT)
        if lt.is_numeric != rt.is_numeric and not (
                lt.type_id == rt.type_id):
            if {lt.type_id, rt.type_id} <= {TypeID.DATE, TypeID.DATETIME} or \
                    lt.type_id == rt.type_id:
                pass
            else:
                raise ResolutionError(f"cannot compare {lt} and {rt}",
                                      node.line, node.column)
        return Cmp(op=op, lhs=lhs, rhs=rhs, type=INT)

    def _make_string_comparison(self, op: str, lhs: Expr, rhs: Expr,
                                node: A.Node) -> Expr:
        ldict = _expr_dictionary(lhs)
        rdict = _expr_dictionary(rhs)
        # literal side?
        if isinstance(rhs, Lit) and isinstance(rhs.value, str):
            if ldict is None:
                raise ResolutionError("string column lacks dictionary",
                                      node.line, node.column)
            return _dict_literal_cmp(op, lhs, ldict, rhs.value)
        if isinstance(lhs, Lit) and isinstance(lhs.value, str):
            flipped = {"<": ">", "<=": ">=", ">": "<", ">=": "<=",
                       "=": "=", "<>": "<>"}[op]
            return _dict_literal_cmp(flipped, rhs, rdict, lhs.value)
        # column vs column: remap through merged dictionary
        if ldict is None or rdict is None:
            raise ResolutionError("string comparison requires dictionaries",
                                  node.line, node.column)
        if ldict is rdict:
            return Cmp(op=op, lhs=lhs, rhs=rhs, type=INT)
        merged, ra, rb = Dictionary.merge(ldict, rdict)
        lhs2 = Substr(operand=lhs, remap=ra,
                      type=lhs.type)  # remap node reuses Substr (code remap)
        rhs2 = Substr(operand=rhs, remap=rb, type=rhs.type)
        return Cmp(op=op, lhs=lhs2, rhs=rhs2, type=INT)

    def _resolve_like(self, e: A.BinaryExpr, scope: Scope,
                      state: ResolveState) -> Expr:
        operand = self._resolve_expr(e.left, scope, state)
        pat = self._resolve_expr(e.right, scope, state)
        d = _expr_dictionary(operand)
        if d is None:
            raise ResolutionError("LIKE requires a string operand",
                                  e.line, e.column)
        negated = e.op.startswith("NOT_")
        if not (isinstance(pat, Lit) and isinstance(pat.value, str)):
            # column pattern (email LIKE pattern): precompute the full
            # value x pattern match matrix over the two dictionaries
            pd = _expr_dictionary(pat)
            if pd is None:
                raise ResolutionError("LIKE pattern must be a string expression",
                                      e.line, e.column)
            if len(d) * len(pd) > (1 << 24):
                raise ResolutionError(
                    "LIKE over two columns exceeds the dictionary-product limit",
                    e.line, e.column)
            from quickstep_tpu_torch.expressions.scalar import DictMatrixProbe
            if e.op.endswith("REGEXP"):
                mat = np.stack([d.match_regex(p) for p in pd.values], axis=1)
            else:
                mat = np.stack([d.match_like(p) for p in pd.values], axis=1)
            return DictMatrixProbe(lhs=operand, rhs=pat, matrix=mat,
                                   negated=negated, type=INT)
        if e.op.endswith("REGEXP"):
            bitmap = d.match_regex(pat.value)
        else:
            bitmap = d.match_like(pat.value)
        return DictBitmapProbe(operand=operand, bitmap=bitmap, negated=negated,
                               type=INT)

    def _resolve_in_list(self, e: A.InListExpr, scope: Scope,
                         state: ResolveState) -> Expr:
        operand = self._resolve_expr(e.operand, scope, state)
        items = [self._resolve_expr(i, scope, state) for i in e.items]
        if operand.type.is_string:
            d = _expr_dictionary(operand)
            strs = []
            for it in items:
                if not (isinstance(it, Lit) and isinstance(it.value, str)):
                    raise ResolutionError("IN list over strings must be literals",
                                          e.line, e.column)
                strs.append(it.value)
            return DictBitmapProbe(operand=operand, bitmap=d.match_in(strs),
                                   negated=e.negated, type=INT)
        if all(isinstance(it, Lit) for it in items):
            vals = [it.value for it in items]
            if operand.type.is_decimal:
                units = [_dec_lit_units(it, operand.type.scale)
                         for it in items]
                if all(u is not None for u in units):
                    return InSet(operand=operand, values=tuple(units),
                                 negated=e.negated, type=INT)
                return InSet(operand=_decode_decimal(operand),
                             values=tuple(float(v) for v in vals),
                             negated=e.negated, type=INT)
            return InSet(operand=operand, values=tuple(vals), negated=e.negated,
                         type=INT)
        # general expressions in the IN list: expand to an OR of equalities
        # (x IN (a, b) == x=a OR x=b; NOT IN negates the disjunction)
        disj = None
        for it in items:
            cmp = self._make_binary("=", operand, it, e)
            disj = cmp if disj is None else Logical(op="OR",
                                                    operands=[disj, cmp], type=INT)
        if e.negated:
            from quickstep_tpu_torch.expressions.scalar import Not
            return Not(operand=disj, type=INT)
        return disj

    def _resolve_case(self, e: A.CaseExpr, scope: Scope, state: ResolveState,
                      rewriter=None) -> Expr:
        res = rewriter if rewriter is not None else (
            lambda ast: self._resolve_expr(ast, scope, state))
        whens = []
        result_type = None
        for cond_ast, res_ast in e.when_clauses:
            if e.operand is not None:
                cond = self._make_binary(
                    "=", res(e.operand), res(cond_ast), e)
            else:
                cond = res(cond_ast)
            r = res(res_ast)
            result_type = r.type if result_type is None else \
                TypeFactory.unify(result_type, r.type)
            whens.append((cond, r))
        else_r = res(e.else_result) if e.else_result is not None else None
        if else_r is not None:
            result_type = TypeFactory.unify(result_type, else_r.type)
        else:
            result_type = result_type.with_nullable(True)
        if result_type is not None and result_type.is_string:
            # all branches must share one dictionary code space
            results = [r for _, r in whens] + (
                [else_r] if else_r is not None else [])
            merged, wrapped = _unify_string_exprs(results, e.line, e.column)
            whens = [(c, w) for (c, _), w in zip(whens, wrapped)]
            else_r = wrapped[-1] if else_r is not None else None
            out = Case(when_clauses=whens, else_result=else_r, type=result_type)
            out._dictionary = merged
            return out
        results = [r for _, r in whens] + (
            [else_r] if else_r is not None else [])
        if any(r.type.is_decimal for r in results):
            aligned, result_type2 = _align_decimal_branches(
                results, nullable=result_type.nullable
                if result_type is not None else True)
            whens = [(c, w) for (c, _), w in zip(whens, aligned)]
            else_r = aligned[-1] if else_r is not None else None
            result_type = result_type2
        return Case(when_clauses=whens, else_result=else_r, type=result_type)

    def _resolve_substring(self, e: A.SubstringExpr, scope: Scope,
                           state: ResolveState) -> Expr:
        operand = self._resolve_expr(e.operand, scope, state)
        d = _expr_dictionary(operand)
        if d is None:
            raise ResolutionError("SUBSTRING requires a string operand",
                                  e.line, e.column)
        start_e = self._resolve_expr(e.start, scope, state)
        if not isinstance(start_e, Lit):
            raise ResolutionError("SUBSTRING start must be a literal",
                                  e.line, e.column)
        start = int(start_e.value) - 1
        length = None
        if e.length is not None:
            len_e = self._resolve_expr(e.length, scope, state)
            length = int(len_e.value)
        if length is None:
            fn = lambda s: s[start:]
        else:
            fn = lambda s: s[start:start + length]
        newd, remap = d.map_values(fn)
        out = Substr(operand=operand, remap=remap,
                     type=Type(TypeID.VARCHAR, operand.type.nullable,
                               length or operand.type.length))
        out._dictionary = newd
        return out

    # ---- subqueries ----
    def _resolve_subplan(self, stmt: A.SelectStmt, scope: Scope):
        """Resolve a subquery allowing correlation to `scope`. Returns
        (plan, correlated_conjuncts). The subquery is resolved with scope as parent;
        correlated WHERE conjuncts (those referencing outer attrs) are extracted
        rather than planned inside."""
        sub_resolver = _CorrelatedSelectResolver(self, scope)
        return sub_resolver.resolve(stmt)

    def _resolve_exists(self, sub: A.SelectStmt, negated: bool, scope: Scope,
                        state: ResolveState):
        plan, correlated, _ = self._resolve_subplan(sub, scope)
        outer_keys, inner_keys, residual = _split_correlation(
            correlated, {a.expr_id for a in plan.output})
        # No equality correlation (pure theta, e.g. EXISTS(... WHERE x < outer.y),
        # or uncorrelated EXISTS): the executor's nested-loops semi/anti join
        # handles keyless [NOT] EXISTS (reference UnnestSubqueries general path).
        state.pending_joins.append(PendingJoin(
            kind="anti" if negated else "semi", plan=plan,
            outer_keys=outer_keys, inner_keys=inner_keys, residual=residual))

    def _resolve_in_subquery(self, e: A.InSubqueryExpr, scope: Scope,
                             state: ResolveState):
        operand = self._resolve_expr(e.operand, scope, state)
        plan, correlated, _ = self._resolve_subplan(e.subquery, scope)
        out0 = plan.output[0]
        inner_attr = _attr_of(out0)
        outer_keys, inner_keys, residual = _split_correlation(
            correlated, {a.expr_id for a in plan.output})
        outer_keys = [operand] + outer_keys
        inner_keys = [inner_attr] + inner_keys
        # [NOT] IN three-valued semantics are always requested; the runtime
        # validity masks decide whether they bite (declared NOT NULL columns
        # carry no masks, so the correction is free — and columns that were
        # declared NOT NULL but hold NULLs anyway still behave per SQL)
        state.pending_joins.append(PendingJoin(
            kind="anti" if e.negated else "semi", plan=plan,
            outer_keys=outer_keys, inner_keys=inner_keys, residual=residual,
            null_aware=True))

    def _resolve_scalar_subquery(self, e: A.ScalarSubqueryExpr, scope: Scope,
                                 state: ResolveState) -> Expr:
        plan, correlated, result_expr = self._resolve_subplan(e.subquery, scope)
        if not correlated:
            # Uncorrelated scalar subquery: evaluated once; represented as a
            # SubqueryScalar expression the executor resolves before/inside the stage.
            from quickstep_tpu_torch.expressions.subquery import SubqueryScalar
            out0 = plan.output[0]
            return SubqueryScalar(plan=plan, type=out0.type.with_nullable(True))
        # Correlated: must be a bare Aggregate — decorrelate into group-by +
        # left join (reference UnnestSubqueries one-row check analog).
        agg_plan, agg_attr = _find_single_agg(plan)
        if agg_plan is None:
            raise ResolutionError(
                "correlated scalar subquery must be a single aggregate",
                e.line, e.column)
        outer_keys, inner_keys_exprs, residual = _split_correlation(
            correlated, set())
        if residual is not None:
            # General (non-equality) correlation: aggregate-over-theta-join
            # keyed by a synthetic outer-row id (the UnnestSubqueries general
            # path, query_optimizer/rules/UnnestSubqueries.cpp). Planned at
            # attach time: RowNumber(outer) LEFT-theta-JOIN inner, aggregate
            # grouped by the row id, then join the aggregates back.
            inner_input = agg_plan.input
            specs = list(agg_plan.aggregates)
            if any(s.arg is None for s in specs):
                # COUNT(*) over the correlated set: count a non-null marker
                # column instead, so unmatched outer rows count 0
                marker = OutAttr(next_expr_id(), "__one", LONG)
                inner_input = L.Project(
                    input=inner_input,
                    exprs=[_attr_of(a) for a in inner_input.output] +
                          [Lit(value=1, type=LONG)],
                    attrs=[dataclasses.replace(a)
                           for a in inner_input.output] + [marker])
                specs = [dataclasses.replace(
                             s, arg=_attr_of(marker)) if s.arg is None else s
                         for s in specs]
            state.pending_joins.append(PendingJoin(
                kind="scalar_agg_general", plan=inner_input,
                outer_keys=outer_keys, inner_keys=inner_keys_exprs,
                residual=residual, agg_specs=specs,
                agg_attrs=list(agg_plan.agg_attrs)))
            if result_expr is not None:
                return result_expr
            out_ref = _attr_of(agg_attr)
            out_ref.type = agg_attr.type.with_nullable(True)
            return out_ref
        # inner side of each correlated equality joins the aggregate's group-by
        new_group_exprs = inner_keys_exprs
        group_attrs = []
        inner_key_attrs = []
        for ge in new_group_exprs:
            attr = OutAttr(next_expr_id(), _expr_name(ge), ge.type,
                           _expr_dictionary(ge))
            group_attrs.append(attr)
            inner_key_attrs.append(_attr_of(attr))
        agg_plan.group_by = agg_plan.group_by + new_group_exprs
        agg_plan.group_attrs = agg_plan.group_attrs + group_attrs
        state.pending_joins.append(PendingJoin(
            kind="scalar_agg", plan=agg_plan, outer_keys=outer_keys,
            inner_keys=inner_key_attrs))
        if result_expr is not None:
            # e.g. "select 0.5 * sum(x)": result references the agg attr (Q20 shape)
            return result_expr
        out_ref = _attr_of(agg_attr)
        out_ref.type = agg_attr.type.with_nullable(True)
        return out_ref

    def _fold_date_arith(self, op: str, date_e: Expr, interval_e: Expr,
                         node: A.Node) -> Expr:
        if not isinstance(interval_e, Lit):
            raise ResolutionError(
                "date arithmetic requires a literal interval",
                node.line, node.column)
        if not isinstance(date_e, Lit):
            # column ± literal interval: evaluate on device
            if interval_e.type.type_id == TypeID.YEARMONTH_INTERVAL:
                if date_e.type.type_id == TypeID.DATETIME:
                    raise ResolutionError(
                        "DATETIME +- month interval not supported",
                        node.line, node.column)
                return DateArith(op=op, operand=date_e,
                                 months=int(interval_e.value),
                                 type=date_e.type)
            if date_e.type.type_id == TypeID.DATE and \
                    interval_e.value % US_PER_DAY != 0:
                raise ResolutionError("DATE +- sub-day interval not supported",
                                      node.line, node.column)
            return DateArith(op=op, operand=date_e,
                             us=int(interval_e.value), type=date_e.type)
        sign = 1 if op == "+" else -1
        if date_e.type.type_id == TypeID.DATE:
            if interval_e.type.type_id == TypeID.YEARMONTH_INTERVAL:
                val = date_add_months(date_e.value, sign * interval_e.value)
            else:
                days = interval_e.value // US_PER_DAY
                if interval_e.value % US_PER_DAY != 0:
                    raise ResolutionError("DATE +- sub-day interval not supported",
                                          node.line, node.column)
                val = date_add_days(date_e.value, sign * days)
            return Lit(value=val, type=DATE)
        # DATETIME
        if interval_e.type.type_id == TypeID.YEARMONTH_INTERVAL:
            raise ResolutionError("DATETIME +- month interval not supported",
                                  node.line, node.column)
        return Lit(value=date_e.value + sign * interval_e.value, type=DATETIME)

    # ----------------------------------------------------------------
    def _expand_stars(self, items: List[A.SelectItem],
                      scope: Scope) -> List[A.SelectItem]:
        out = []
        for item in items:
            if isinstance(item.expr, A.Star):
                star = item.expr
                attrs = _ordered_attrs(scope, star.table)
                for a in attrs:
                    out.append(A.SelectItem(
                        expr=_attr_ref_ast(a), alias=a.name,
                        line=item.line, column=item.column))
            else:
                out.append(item)
        return out


class _CorrelatedSelectResolver:
    """Resolves a subquery SELECT whose WHERE may reference the outer scope,
    extracting correlated conjuncts instead of planning them."""

    def __init__(self, resolver: Resolver, outer_scope: Scope):
        self.resolver = resolver
        self.outer_scope = outer_scope

    def resolve(self, stmt: A.SelectStmt):
        r = self.resolver
        outer_ids = _all_scope_ids(self.outer_scope)
        # Resolve with outer scope linked; then split the WHERE conjuncts.
        scope = Scope(parent=self.outer_scope)
        state = ResolveState()

        from_plans = [r._resolve_table_ref(t, scope) for t in stmt.from_tables]
        local_filters: List[Expr] = []
        correlated: List[Expr] = []
        if stmt.where is not None:
            for conj in _ast_conjuncts(stmt.where):
                e = r._resolve_conjunct(conj, scope, state)
                if e is None:
                    continue
                if e.referenced_attrs() & outer_ids:
                    correlated.append(e)
                else:
                    local_filters.append(e)

        plan = r._build_join_tree(from_plans, local_filters, state)

        select_items = r._expand_stars(stmt.select_list, scope)
        has_agg = any(_contains_aggregate(it.expr) for it in select_items) or \
            bool(stmt.group_by) or stmt.having is not None
        result_expr = None
        if has_agg:
            plan, proj_exprs, proj_names = r._resolve_aggregate_select(
                stmt, select_items, plan, scope, state)
            if correlated:
                # Keep the Aggregate un-projected so the parent can extend its
                # group-by (decorrelation); hand back the single result expression,
                # which references agg/group attrs (e.g. "0.5 * sum(x)", Q20 shape).
                if len(proj_exprs) == 1:
                    result_expr = proj_exprs[0]
            elif not _is_trivial_projection(proj_exprs, plan):
                plan = r._make_project(plan, proj_exprs, proj_names)
        else:
            proj_exprs, proj_names = [], []
            for item in select_items:
                proj_exprs.append(r._resolve_expr(item.expr, scope, state))
                proj_names.append(item.alias or _default_name(item.expr))
            plan = r._attach_pending_joins(plan, state)
            # In a correlated subquery the projection is only load-bearing for
            # IN/scalar forms; for an attr-free list (EXISTS (SELECT 1 ...))
            # keep the plan un-projected so correlation keys stay resolvable.
            attr_free = not any(e.referenced_attrs() for e in proj_exprs)
            if not correlated or not (
                    _is_trivial_projection(proj_exprs, plan) or attr_free):
                plan = r._make_project(plan, proj_exprs, proj_names)
        if stmt.order_by or stmt.limit is not None:
            if correlated:
                raise ResolutionError("ORDER BY/LIMIT in correlated subquery",
                                      stmt.line, stmt.column)
            if stmt.order_by:
                plan = r._resolve_order_by(stmt, plan,
                                           [_attr_of(a) for a in plan.output],
                                           [a.name for a in plan.output],
                                           scope, state)
            elif stmt.limit is not None:
                plan = L.Limit(input=plan, limit=stmt.limit)
        return plan, correlated, result_expr


# =====================================================================
# module-level helpers
# =====================================================================

def _split_disjuncts(e: Expr) -> List[Expr]:
    if isinstance(e, Logical) and e.op == "OR":
        out = []
        for o in e.operands:
            out.extend(_split_disjuncts(o))
        return out
    return [e]


def _factor_common_disjuncts(f: Expr) -> List[Expr]:
    """OR(AND(a, x...), AND(a, y...)) -> [a, OR(AND(x...), AND(y...))]."""
    if not (isinstance(f, Logical) and f.op == "OR"):
        return [f]
    branches = _split_disjuncts(f)
    if len(branches) < 2:
        return [f]
    branch_conjs = [split_conjuncts(b) for b in branches]
    first_keys = {c.key(): c for c in branch_conjs[0]}
    common_keys = set(first_keys)
    for bc in branch_conjs[1:]:
        common_keys &= {c.key() for c in bc}
    if not common_keys:
        return [f]
    out = [first_keys[k] for k in common_keys]
    rest_branches = []
    for bc in branch_conjs:
        rest = [c for c in bc if c.key() not in common_keys]
        rest_branches.append(make_and(rest) if rest else
                             Lit(value=1, type=INT))
    out.append(Logical(op="OR", operands=rest_branches, type=INT))
    return out


def _ast_conjuncts(e: A.Expr) -> List[A.Expr]:
    if isinstance(e, A.BinaryExpr) and e.op == "AND":
        return _ast_conjuncts(e.left) + _ast_conjuncts(e.right)
    return [e]


def _contains_aggregate(e: A.Expr) -> bool:
    if e is None:
        return False
    if isinstance(e, A.FunctionCall) and e.name in (
            "sum", "count", "avg", "min", "max") and e.window is None:
        return True
    for f in dataclasses.fields(e) if dataclasses.is_dataclass(e) else []:
        v = getattr(e, f.name)
        if isinstance(v, A.Expr) and _contains_aggregate(v):
            return True
        if isinstance(v, list):
            for item in v:
                if isinstance(item, A.Expr) and _contains_aggregate(item):
                    return True
                if isinstance(item, tuple):
                    for x in item:
                        if isinstance(x, A.Expr) and _contains_aggregate(x):
                            return True
    return False


def _literal_to_expr(e: A.Literal) -> Lit:
    v = e.value
    if e.type_hint == "date":
        return Lit(value=v, type=DATE)
    if e.type_hint == "datetime":
        return Lit(value=v, type=DATETIME)
    if v is None:
        from quickstep_tpu_torch.types import NULL_TYPE
        return Lit(value=None, type=NULL_TYPE)
    if isinstance(v, bool):
        return Lit(value=int(v), type=INT)
    if isinstance(v, int):
        t = INT if -2**31 <= v < 2**31 else LONG
        return Lit(value=v, type=t)
    if isinstance(v, float):
        return Lit(value=v, type=DOUBLE)
    if isinstance(v, str):
        from quickstep_tpu_torch.types import VarChar
        return Lit(value=v, type=VarChar(len(v)))
    raise ResolutionError(f"bad literal {v!r}", e.line, e.column)


def _units_precision(u: int) -> int:
    return 9 if -2**31 < u < 2**31 else 18


def _dec_lit_units(lit: Lit, scale: int):
    """Exact scaled-integer value of a numeric literal at `scale`, or None if
    the literal is not exactly representable there (e.g. 0.001 at scale 2)."""
    v = lit.value
    if v is None or isinstance(v, str):
        return None
    u = float(v) * (10 ** scale)
    r = round(u)
    if abs(u - r) <= 1e-9 * max(1.0, abs(u)):
        return int(r)
    return None


def _lit_as_decimal(lit: Lit, max_scale: int) -> Optional[Lit]:
    """Smallest-scale exact decimal form of a numeric literal (scale <=
    max_scale), or None."""
    for s in range(0, max(0, max_scale) + 1):
        u = _dec_lit_units(lit, s)
        if u is not None and abs(float(lit.value) - u * 10.0 ** -s) <= \
                1e-12 * max(1.0, abs(float(lit.value))):
            return Lit(value=u, type=Type(TypeID.DECIMAL,
                                          nullable=lit.type.nullable,
                                          precision=_units_precision(u),
                                          scale=s))
    return None


def _decode_decimal(e: Expr) -> Expr:
    """DECIMAL expr -> its DOUBLE value (units * 10^-scale)."""
    if not e.type.is_decimal:
        return e
    s = e.type.scale
    if isinstance(e, Lit):
        val = None if e.value is None else e.value / (10 ** s)
        return Lit(value=val, type=DOUBLE.with_nullable(e.type.nullable))
    return DecimalToDouble(operand=e,
                           type=DOUBLE.with_nullable(e.type.nullable))


def _rescale_decimal(e: Expr, new_scale: int) -> Expr:
    """DECIMAL(s) -> DECIMAL(new_scale >= s); exact (multiply by 10^delta)."""
    t = e.type
    if t.scale == new_scale:
        return e
    newt = Type(TypeID.DECIMAL, nullable=t.nullable,
                precision=min(18, t.precision + new_scale - t.scale),
                scale=new_scale)
    if isinstance(e, Lit):
        val = None if e.value is None else \
            int(e.value) * 10 ** (new_scale - t.scale)
        return Lit(value=val, type=newt)
    return Cast(operand=e, type=newt)


def _integral_to_decimal(e: Expr, scale: int) -> Expr:
    """INT/LONG expr -> DECIMAL(scale) units; exact."""
    p = min(18, (9 if e.type.type_id == TypeID.INT else 18) + scale)
    newt = Type(TypeID.DECIMAL, nullable=e.type.nullable,
                precision=p, scale=scale)
    if isinstance(e, Lit):
        val = None if e.value is None else int(e.value) * 10 ** scale
        return Lit(value=val, type=newt)
    return Cast(operand=e, type=newt)


def _align_decimal_branches(results: List[Expr], nullable: bool):
    """Bring CASE branches that mix DECIMAL with other numerics onto one
    representation: all at the max decimal scale when every branch converts
    exactly (decimal rescale / scaled integer literal / integral expr),
    otherwise all decoded to DOUBLE. Returns (new_branches, result_type)."""
    smax = max(r.type.scale for r in results if r.type.is_decimal)
    aligned = []
    for r in results:
        if r.type.is_decimal:
            aligned.append(_rescale_decimal(r, smax))
        elif r.type.type_id == TypeID.NULLTYPE:
            aligned.append(r)
        elif isinstance(r, Lit):
            u = _dec_lit_units(r, smax)
            if u is None:
                aligned = None
                break
            aligned.append(Lit(value=u, type=Type(
                TypeID.DECIMAL, nullable=r.type.nullable,
                precision=_units_precision(u), scale=smax)))
        elif r.type.is_integral:
            aligned.append(_integral_to_decimal(r, smax))
        else:
            aligned = None
            break
    if aligned is None:
        return [_decode_decimal(r) for r in results], \
            DOUBLE.with_nullable(nullable)
    p = max((a.type.precision for a in aligned if a.type.is_decimal),
            default=18)
    return aligned, Type(TypeID.DECIMAL, nullable=nullable,
                         precision=p, scale=smax)


def _align_decimal_pair(lhs: Expr, rhs: Expr) -> Tuple[Expr, Expr]:
    """Bring a (decimal, any-numeric) operand pair into one comparison domain:
    both decimal at a common scale (exact integer compare) when possible,
    otherwise both decoded to DOUBLE."""
    lt, rt = lhs.type, rhs.type
    if lt.is_decimal and rt.is_decimal:
        smax = max(lt.scale, rt.scale)
        return _rescale_decimal(lhs, smax), _rescale_decimal(rhs, smax)
    dec_is_left = lt.is_decimal
    dec, other = (lhs, rhs) if dec_is_left else (rhs, lhs)
    s = dec.type.scale
    o2 = None
    if isinstance(other, Lit):
        u = _dec_lit_units(other, s)
        if u is not None:
            o2 = Lit(value=u, type=Type(TypeID.DECIMAL,
                                        nullable=other.type.nullable,
                                        precision=_units_precision(u),
                                        scale=s))
    elif other.type.is_integral:
        o2 = _integral_to_decimal(other, s)
    if o2 is None:
        return _decode_decimal(lhs), _decode_decimal(rhs)
    return (dec, o2) if dec_is_left else (o2, dec)


def _fold_numeric(a: Arith) -> Lit:
    x, y = a.lhs.value, a.rhs.value
    op = a.op
    if op == "+":
        r = x + y
    elif op == "-":
        r = x - y
    elif op == "*":
        r = x * y
    elif op == "/":
        if a.type.is_integral:
            r = int(x / y) if y != 0 else None
        else:
            r = x / y if y != 0 else None
    else:
        r = x % y if y != 0 else None
    if a.type.is_floating and r is not None:
        r = float(r)
    return Lit(value=r, type=a.type if r is not None
               else a.type.with_nullable(True))


def _default_name(e: A.Expr) -> str:
    """Display name for an unaliased select item: the reference resolver uses
    ParseExpression::generateName() (parser/ParseBasicExpressions.cpp:45-214),
    except bare column references keep just the column name."""
    if isinstance(e, A.ColumnRef):
        return e.name
    return A.generate_name(e)


def _expr_name(e: Expr) -> str:
    return getattr(e, "name", "expr")


def _encode_string_lit(e: Expr) -> Expr:
    """Raw string literals carry their python str until consumed; when one
    becomes an output column it is dictionary-coded (singleton dictionary,
    code 0) so the device only ever sees int32 codes."""
    if isinstance(e, Lit) and isinstance(e.value, str):
        d = Dictionary([e.value])
        out = Lit(value=0, type=e.type)
        out._dictionary = d
        return out
    return e


def _unify_string_exprs(exprs: List[Expr], line=None, column=None):
    """Re-encode string expressions onto one merged dictionary (for CASE
    branches / value lists that must share a code space). Returns
    (merged_dict, wrapped_exprs)."""
    from quickstep_tpu_torch.expressions.scalar import Substr
    dicts = []
    for e in exprs:
        if isinstance(e, Lit) and isinstance(e.value, str):
            dicts.append(Dictionary([e.value]))
        else:
            d = _expr_dictionary(e)
            if d is None:
                raise ResolutionError("cannot mix string and non-string values",
                                      line, column)
            dicts.append(d)
    merged = dicts[0]
    for d in dicts[1:]:
        merged, _, _ = Dictionary.merge(merged, d)
    wrapped = []
    for e, d in zip(exprs, dicts):
        if isinstance(e, Lit) and isinstance(e.value, str):
            ne = Lit(value=merged.code_of(e.value), type=e.type)
        elif d.values == merged.values:
            ne = e
        else:
            remap = np.asarray([merged._index[v] for v in d.values],
                               dtype=np.int32)
            ne = Substr(operand=e, remap=remap, type=e.type)
        ne._dictionary = merged
        wrapped.append(ne)
    return merged, wrapped


def _expr_dictionary(e: Optional[Expr]) -> Optional[Dictionary]:
    if e is None:
        return None
    d = getattr(e, "_dictionary", None)
    if d is not None:
        return d
    if isinstance(e, Attr):
        return getattr(e, "_attr_dictionary", None)
    return None


def _dict_literal_cmp(op: str, col: Expr, d: Dictionary, s: str) -> Expr:
    if op == "=":
        c = d.code_of(s)
        if c < 0:
            return Lit(value=0, type=INT)  # FALSE for all rows
        return Cmp(op="=", lhs=col, rhs=Lit(value=c, type=INT), type=INT)
    if op == "<>":
        c = d.code_of(s)
        if c < 0:
            return Lit(value=1, type=INT)
        return Cmp(op="<>", lhs=col, rhs=Lit(value=c, type=INT), type=INT)
    if op == "<":
        return Cmp(op="<", lhs=col, rhs=Lit(value=d.lower_bound(s), type=INT),
                   type=INT)
    if op == ">=":
        return Cmp(op=">=", lhs=col, rhs=Lit(value=d.lower_bound(s), type=INT),
                   type=INT)
    if op == "<=":
        return Cmp(op="<", lhs=col, rhs=Lit(value=d.upper_bound(s), type=INT),
                   type=INT)
    if op == ">":
        return Cmp(op=">=", lhs=col, rhs=Lit(value=d.upper_bound(s), type=INT),
                   type=INT)
    raise ValueError(op)


def _extract_equi_keys(cond: Optional[Expr], left_ids: set, right_ids: set):
    lkeys, rkeys, residual = [], [], []
    for c in split_conjuncts(cond):
        if isinstance(c, Cmp) and c.op == "=":
            lref = c.lhs.referenced_attrs()
            rref = c.rhs.referenced_attrs()
            if lref and rref:
                if lref <= left_ids and rref <= right_ids:
                    lkeys.append(c.lhs)
                    rkeys.append(c.rhs)
                    continue
                if lref <= right_ids and rref <= left_ids:
                    lkeys.append(c.rhs)
                    rkeys.append(c.lhs)
                    continue
        residual.append(c)
    return lkeys, rkeys, make_and(residual)


def _split_correlation(correlated: List[Expr], inner_ids: set):
    """Split correlated conjuncts into equality key pairs (outer expr, inner expr)
    plus a residual predicate. `inner_ids` may be empty, in which case sides are
    classified by which half references attrs NOT in the conjunct's own inner plan —
    we use: the side whose attrs are all produced by the inner plan is inner; with
    empty inner_ids, the side with no outer-marking falls back to structural order."""
    outer_keys, inner_keys, residual = [], [], []
    for c in correlated:
        if isinstance(c, Cmp) and c.op == "=":
            lref = c.lhs.referenced_attrs()
            rref = c.rhs.referenced_attrs()
            if inner_ids:
                if lref <= inner_ids and not (rref <= inner_ids):
                    inner_keys.append(c.lhs)
                    outer_keys.append(c.rhs)
                    continue
                if rref <= inner_ids and not (lref <= inner_ids):
                    inner_keys.append(c.rhs)
                    outer_keys.append(c.lhs)
                    continue
            else:
                # classification by outer marking: resolver tagged outer attrs
                louter = getattr(c.lhs, "_is_outer", None)
                # fall back: treat lhs as inner if it references newer ids
                if _max_id(lref) < _max_id(rref):
                    inner_keys.append(c.rhs)
                    outer_keys.append(c.lhs)
                else:
                    inner_keys.append(c.lhs)
                    outer_keys.append(c.rhs)
                continue
        residual.append(c)
    return outer_keys, inner_keys, make_and(residual)


def _max_id(ids: set) -> int:
    return max(ids) if ids else -1


def _find_single_agg(plan: L.LogicalNode):
    """Locate the Aggregate node of a correlated scalar subquery plan and its
    first aggregate output attr. Multiple aggregates arise when AVG over a
    DECIMAL argument decomposes into SUM/COUNT — fine, because the subquery's
    select expression (result_expr) references them explicitly."""
    node = plan
    while isinstance(node, (L.Project,)):
        node = node.input
    if isinstance(node, L.Aggregate) and len(node.aggregates) >= 1 and \
            not node.group_by:
        return node, node.agg_attrs[0]
    return None, None


def _is_trivial_projection(exprs: List[Expr], plan: L.LogicalNode) -> bool:
    out_ids = [a.expr_id for a in plan.output]
    if len(exprs) != len(out_ids):
        return False
    for e, oid in zip(exprs, out_ids):
        if not (isinstance(e, Attr) and e.expr_id == oid):
            return False
    return True


def _rename(plan: L.LogicalNode, names: List[str]) -> L.LogicalNode:
    exprs = [_attr_of(a) for a in plan.output]
    attrs = [OutAttr(next_expr_id(), n, a.type, a.dictionary)
             for n, a in zip(names, plan.output)]
    return L.Project(input=plan, exprs=exprs, attrs=attrs)


def _reref(plan: L.LogicalNode, name: str) -> L.LogicalNode:
    """Reference a CTE plan with fresh expr ids (SharedSubplan semantics: the plan
    executes once; each reference aliases its columns under fresh ids)."""
    attrs = [OutAttr(next_expr_id(), a.name, a.type, a.dictionary)
             for a in plan.output]
    return L.SharedSubplan(name=name, plan=plan, attrs=attrs)


def _scope_has(scope: Scope, name: str) -> bool:
    s = scope
    while s is not None:
        if name.lower() in s.unqualified:
            return True
        s = s.parent
    return False


def _all_scope_ids(scope: Optional[Scope]) -> set:
    out = set()
    s = scope
    while s is not None:
        out |= s.local_ids
        s = s.parent
    return out


def _ordered_attrs(scope: Scope, table: Optional[str]) -> List[OutAttr]:
    seen = set()
    out = []
    if table:
        for (q, n), a in scope.qualified.items():
            if q == table.lower() and a.expr_id not in seen:
                seen.add(a.expr_id)
                out.append(a)
        out.sort(key=lambda a: a.expr_id)
        return out
    for lst in scope.unqualified.values():
        for a in lst:
            if a.expr_id not in seen:
                seen.add(a.expr_id)
                out.append(a)
    out.sort(key=lambda a: a.expr_id)
    return out


def _attr_ref_ast(attr: OutAttr) -> A.ColumnRef:
    return A.ColumnRef(name=attr.name)
