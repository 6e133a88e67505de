# Copied from quickstep_tpu/utils/reference_plan.py; only the package name in imports differs.
"""Reference-format physical plan printing.

Reproduces the reference optimizer's TreeStringSerializable output
(utility/TreeStringSerializable.hpp; printed by OptimizerTextTestRunner and
the execution_generator golden files with [print_physical_plan]): node heads
with bracketed inline fields, `+-field=` children with `| ` continuation
prefixes, 80-column comma wrapping, and first-encounter AttributeReference
ids. Conversion covers the physical shapes our optimizer produces for the
corpus (Selection / FilterJoin / Aggregate / UnionAll / TableReference);
unsupported shapes return None and callers fall back to tree_string().
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

from quickstep_tpu_torch.expressions.scalar import (
    Arith, Attr, Cmp, Expr, Lit, Logical, Not, split_conjuncts,
)
from quickstep_tpu_torch.optimizer import logical as L

MAX_WIDTH = 80


@dataclasses.dataclass
class RefNode:
    head: str
    fields: List[str] = dataclasses.field(default_factory=list)
    # children: (label or "", RefNode) for single named/bare children, or
    # (label, [RefNode, ...]) for named lists (printed as `label=` + items)
    children: List[Tuple[str, Union["RefNode", List["RefNode"]]]] = \
        dataclasses.field(default_factory=list)

    def headline(self) -> str:
        if self.fields:
            return f"{self.head}[{','.join(self.fields)}]"
        return self.head


def render(root: RefNode) -> str:
    lines: List[str] = []
    _emit_head(root.headline(), "", "", lines)
    _emit_children(root, "", lines)
    return "\n".join(lines)


def _emit_head(text: str, branch: str, cont_prefix: str,
               lines: List[str]) -> None:
    """One header line with 80-col comma wrapping; continuation lines align
    under the first char after the +- branch."""
    line = branch + text
    if len(line) <= MAX_WIDTH:
        lines.append(line)
        return
    avail_first = MAX_WIDTH
    out = line
    while len(out) > avail_first:
        cut = out.rfind(",", 0, avail_first + 1)
        if cut <= len(cont_prefix):
            break
        lines.append(out[:cut + 1])
        out = cont_prefix + out[cut + 1:]
    lines.append(out)


def _emit_children(node: RefNode, prefix: str, lines: List[str]) -> None:
    n = len(node.children)
    for i, (label, val) in enumerate(node.children):
        last = i == n - 1
        branch = prefix + "+-"
        child_prefix = prefix + ("  " if last else "| ")
        if isinstance(val, RefNode):
            lab = f"{label}=" if label else ""
            # wrap continuation aligns under the first char after "+-"
            _emit_head(f"{branch}{lab}{val.headline()}", "",
                       prefix + "  ", lines)
            _emit_children(val, child_prefix, lines)
        else:
            lines.append(f"{branch}{label}=")
            items = val if val else [RefNode(head="[]")]
            m = len(items)
            for j, item in enumerate(items):
                jlast = j == m - 1
                _emit_head(f"{child_prefix}+-{item.headline()}", "",
                           child_prefix + "  ", lines)
                _emit_children(item,
                               child_prefix + ("  " if jlast else "| "),
                               lines)


# ---------------------------------------------------------------------
# conversion
# ---------------------------------------------------------------------

class _Registry:
    """First-encounter AttributeReference numbering + display info."""

    def __init__(self):
        self.info: Dict[int, dict] = {}   # our expr_id -> {id,name,alias,rel,type}
        self._next = 0

    def register(self, expr_id: int, name: str, relation: str, type_str: str,
                 alias: str = "") -> dict:
        e = self.info.get(expr_id)
        if e is None:
            e = {"id": self._next, "name": name, "alias": alias,
                 "rel": relation, "type": type_str}
            self._next += 1
            self.info[expr_id] = e
        return e

    def ref(self, expr_id: int) -> Optional[RefNode]:
        e = self.info.get(expr_id)
        if e is None:
            return None
        fields = [f"id={e['id']}", f"name={e['name']}"]
        if e["alias"]:
            fields.append(f"alias={e['alias']}")
        fields += [f"relation={e['rel']}", f"type={e['type']}"]
        return RefNode(head="AttributeReference", fields=fields)


class _Unsupported(Exception):
    pass


def reference_plan_string(plan: L.LogicalNode) -> Optional[str]:
    try:
        reg = _Registry()
        body = _convert(plan, reg)
        out_attrs = [_out_ref(a, reg) for a in plan.output]
        top = RefNode(head="TopLevelPlan",
                      children=[("plan", body),
                                ("output_attributes", out_attrs)])
        return render(top)
    except _Unsupported:
        return None


def _out_ref(a, reg: _Registry) -> RefNode:
    r = reg.ref(a.expr_id)
    if r is None:
        raise _Unsupported()
    return r


def _type_str(t) -> str:
    return t.name()


def _convert(node: L.LogicalNode, reg: _Registry) -> RefNode:
    if isinstance(node, L.Project):
        return _convert_selection(node, reg)
    raise _Unsupported()


def _convert_selection(node: L.Project, reg: _Registry) -> RefNode:
    """Project[ (Filter?) input ] -> Selection; a probe-side Filter under a
    semi/anti join is hoisted into the Selection's filter_predicate (the
    reference fuses it the same way: CollapseSelection + FilterJoin)."""
    inner = node.input
    filter_pred = None
    if isinstance(inner, L.Join) and inner.kind in ("semi", "anti"):
        sel_input, filter_pred = _convert_filter_join(inner, node, reg)
    elif isinstance(inner, L.Aggregate):
        sel_input = _convert_aggregate(inner, reg)
    elif isinstance(inner, L.Filter) and isinstance(inner.input, L.TableScan):
        sel_input = _convert_table_ref(inner.input, reg)
        filter_pred = inner.predicate
    elif isinstance(inner, L.TableScan):
        sel_input = _convert_table_ref(inner, reg)
    else:
        raise _Unsupported()

    children: List[Tuple[str, Union[RefNode, List[RefNode]]]] = [
        ("input", sel_input)]
    if filter_pred is not None:
        children.append(("filter_predicate", _convert_expr(filter_pred, reg)))
    proj: List[RefNode] = []
    for e, a in zip(node.exprs, node.attrs):
        proj.append(_convert_project_item(e, a, reg))
    children.append(("project_expressions", proj))
    return RefNode(head="Selection", fields=["has_repartition=false"],
                   children=children)


def _convert_project_item(e: Expr, a, reg: _Registry) -> RefNode:
    if isinstance(e, Attr):
        cur = reg.info.get(e.expr_id)
        if cur is None:
            raise _Unsupported()
        if cur["name"] == a.name or cur["alias"] == a.name:
            reg.info[a.expr_id] = cur    # pass-through keeps identity
            return reg.ref(e.expr_id)
        # renamed pass-through: Alias[id,...,alias=<new name>] over the ref
        inner = reg.ref(e.expr_id)
        alias = RefNode(head="Alias",
                        fields=[f"id={cur['id']}", "name=",
                                f"alias={a.name}", "relation=",
                                f"type={cur['type']}"],
                        children=[("", inner)])
        # downstream references (output_attributes) see the new alias
        reg.info[a.expr_id] = {"id": cur["id"], "name": "",
                               "alias": a.name, "rel": "",
                               "type": cur["type"]}
        return alias
    raise _Unsupported()


def _convert_filter_join(join: L.Join, parent_proj: L.Project,
                         reg: _Registry):
    probe = join.left
    build = join.right
    probe_filter = None
    if isinstance(probe, L.Filter) and isinstance(probe.input, L.TableScan):
        probe_filter = probe.predicate
        probe = probe.input
    if not isinstance(probe, L.TableScan):
        raise _Unsupported()
    build_proj = None
    if isinstance(build, L.Project) and isinstance(build.input, L.TableScan) \
            and all(isinstance(e, Attr) for e in build.exprs):
        build_proj = build
        build = build.input
    if not isinstance(build, L.TableScan):
        raise _Unsupported()
    if join.residual is not None or len(join.left_keys) != 1:
        raise _Unsupported()

    left_ref = _convert_table_ref(probe, reg)
    right_ref = _convert_table_ref(build, reg)
    if build_proj is not None:
        # the join keys reference the collapsed Project's output ids: alias
        # them to the underlying scan attrs
        for e, a in zip(build_proj.exprs, build_proj.attrs):
            if e.expr_id in reg.info:
                reg.info[a.expr_id] = reg.info[e.expr_id]
    proj = [reg.ref(e.expr_id) if isinstance(e, Attr) else None
            for e in parent_proj.exprs]
    if any(p is None for p in proj):
        raise _Unsupported()
    probe_keys = [_convert_expr(k, reg) for k in join.left_keys]
    build_keys = [_convert_expr(k, reg) for k in join.right_keys]
    fj = RefNode(
        head="FilterJoin",
        fields=["has_repartition=false",
                f"is_anti_join={'true' if join.kind == 'anti' else 'false'}"],
        children=[("left", left_ref), ("right", right_ref),
                  ("project_expressions", proj),
                  ("probe_attributes", probe_keys),
                  ("build_attributes", build_keys)])
    return fj, probe_filter


def _convert_table_ref(scan: L.TableScan, reg: _Registry) -> RefNode:
    rel = scan.alias or scan.relation_name
    children = []
    for a in scan.attrs:
        reg.register(a.expr_id, a.name, rel, _type_str(a.type))
        children.append(("", reg.ref(a.expr_id)))
    return RefNode(head="TableReference", fields=[f"relation={rel}"],
                   children=children)


def _convert_aggregate(agg: L.Aggregate, reg: _Registry) -> RefNode:
    if isinstance(agg.input, L.SetOperation):
        inner = _convert_union_all(agg.input, reg)
    else:
        raise _Unsupported()
    groups = [_convert_expr(g, reg) for g in agg.group_by]
    aggs: List[RefNode] = []
    for i, (spec, a) in enumerate(zip(agg.aggregates, agg.agg_attrs)):
        if spec.arg is None or not isinstance(spec.arg, Attr):
            raise _Unsupported()
        arg_ref = reg.ref(spec.arg.expr_id)
        if arg_ref is None:
            raise _Unsupported()
        fn = RefNode(head="AggregateFunction",
                     fields=[f"function={spec.fn.upper()}"],
                     children=[("", arg_ref)])
        e = reg.register(a.expr_id, "", "$aggregate",
                         _type_str(spec.result_type), alias=f"$aggregate{i}")
        alias = RefNode(head="Alias",
                        fields=[f"id={e['id']}", "name=",
                                f"alias=$aggregate{i}", "relation=$aggregate",
                                f"type={e['type']}"],
                        children=[("", fn)])
        aggs.append(alias)
    return RefNode(head="Aggregate", fields=["has_repartition=false"],
                   children=[("input", inner),
                             ("grouping_expressions", groups),
                             ("aggregate_expressions", aggs)])


def _convert_union_all(u: L.SetOperation, reg: _Registry) -> RefNode:
    if u.kind != "union_all":
        raise _Unsupported()
    ops = []
    for op in u.inputs:
        if not isinstance(op, L.Project):
            raise _Unsupported()
        ops.append(_convert_selection(op, reg))
    outs = []
    for a in u.attrs:
        reg.register(a.expr_id, a.name, "", _type_str(a.type))
        outs.append(reg.ref(a.expr_id))
    return RefNode(head="UnionAll",
                   children=[("operands", ops),
                             ("project_attributes", outs)])


_CMP_NAMES = {"=": "Equal", "<>": "NotEqual", "<": "Less",
              "<=": "LessOrEqual", ">": "Greater", ">=": "GreaterOrEqual"}
_ARITH_NAMES = {"+": "Add", "-": "Subtract", "*": "Multiply",
                "/": "Divide", "%": "Modulo"}


def _convert_expr(e: Expr, reg: _Registry) -> RefNode:
    if isinstance(e, Attr):
        r = reg.ref(e.expr_id)
        if r is None:
            raise _Unsupported()
        return r
    if isinstance(e, Lit):
        return RefNode(head="Literal",
                       fields=[f"value={e.value}",
                               f"type={_type_str(e.type)}"])
    if isinstance(e, Cmp):
        return RefNode(head=_CMP_NAMES[e.op],
                       children=[("", _convert_expr(e.lhs, reg)),
                                 ("", _convert_expr(e.rhs, reg))])
    if isinstance(e, Arith):
        return RefNode(head=_ARITH_NAMES[e.op],
                       children=[("", _convert_expr(e.lhs, reg)),
                                 ("", _convert_expr(e.rhs, reg))])
    if isinstance(e, Logical):
        head = "And" if e.op == "AND" else "Or"
        return RefNode(head=head,
                       children=[("", _convert_expr(o, reg))
                                 for o in e.operands])
    if isinstance(e, Not):
        return RefNode(head="Not",
                       children=[("", _convert_expr(e.operand, reg))])
    raise _Unsupported()
