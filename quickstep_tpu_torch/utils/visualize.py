# Copied from quickstep_tpu/utils/visualize.py; package name renamed, and profile_plan waits on torch instead of jax.
"""Plan visualizers: DOT output + per-operator profiling.

Parity with the reference's PlanVisualizer (utility/PlanVisualizer.cpp, flag
visualize_plan) and ExecutionDAGVisualizer (utility/ExecutionDAGVisualizer.hpp:45 —
executed DAG as DOT with per-operator timing overlays via bindProfilingStats). With
whole-query XLA compilation there are no WorkOrder timings, so profile mode steps the
plan operator-by-operator eagerly (block_until_ready between nodes) to attribute
wall-clock — the profile_and_report_workorder_perf analog.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from quickstep_tpu_torch.optimizer import logical as L


def plan_to_dot(plan: L.LogicalNode, cards: Optional[Dict[int, float]] = None,
                times: Optional[Dict[int, float]] = None) -> str:
    """Render a plan tree as graphviz DOT (edges point data-flow upward)."""
    lines = ["digraph g {", "  rankdir=BT;", "  node [shape=box, fontsize=10];"]
    counter = [0]
    ids: Dict[int, int] = {}

    def visit(node: L.LogicalNode) -> int:
        nid = counter[0]
        counter[0] += 1
        ids[id(node)] = nid
        label = node._label().replace('"', "'")
        extra = []
        if cards and id(node) in cards:
            extra.append(f"~{cards[id(node)]:.0f} rows")
        if times and id(node) in times:
            extra.append(f"{times[id(node)]*1000:.1f} ms")
        if extra:
            label += "\\n" + ", ".join(extra)
        lines.append(f'  n{nid} [label="{label}"];')
        for c in node.children():
            cid = visit(c)
            lines.append(f"  n{cid} -> n{nid};")
        return nid

    visit(plan)
    lines.append("}")
    return "\n".join(lines)


def profile_plan(executor, plan: L.LogicalNode, runs: int = 2) -> Dict[int, float]:
    """Execute the plan node-by-node eagerly, timing each operator (the
    WorkOrder-timing analog). Eager dispatch compiles every op on first touch,
    so by default the plan is stepped twice and the LAST pass reported — warm
    numbers, like the reference skipping the cold first query
    (cli/QuickstepCli.cpp:143-145). Returns {id(node): seconds}."""
    import torch
    from quickstep_tpu_torch.exec.runner import PlanRunner

    inputs, meta = executor._collect_inputs(plan)
    times: Dict[int, float] = {}
    for _ in range(max(1, runs)):
        runner = PlanRunner(plan, inputs, meta, executor.config,
                            executor.device, {})
        times = {}
        orig_exec = runner.exec

        def timed_exec(node):
            t0 = time.perf_counter()
            chunk = orig_exec(node)
            if chunk.alive.device.type == "cuda":
                torch.cuda.synchronize(chunk.alive.device)
            times[id(node)] = time.perf_counter() - t0 - sum(
                times.get(id(c), 0.0) for c in node.children())
            return chunk

        runner.exec = timed_exec
        timed_exec(plan)
    return times


def explain(db, sql: str, analyze: bool = False) -> str:
    """Plan tree (+ DOT + per-op times when analyze=True) for a SQL string."""
    from quickstep_tpu_torch.parser import parse_one
    from quickstep_tpu_torch.optimizer.resolver import Resolver
    from quickstep_tpu_torch.optimizer.rules import (
        optimize_plan, collect_attr_stats, estimate_cardinality,
    )
    dbase = db.catalog.default_database
    plan = Resolver(dbase).resolve_select(parse_one(sql))
    plan = optimize_plan(plan, db.config, dbase)
    env = collect_attr_stats(plan, dbase)

    cards = {}

    def walk(n):
        cards[id(n)] = estimate_cardinality(n, dbase, env)
        for c in n.children():
            walk(c)
    walk(plan)

    out = [plan.tree_string()]
    times = None
    if analyze:
        times = profile_plan(db.executor, plan)
        out.append("")
        out.append("-- per-operator times --")

        def twalk(n, depth=0):
            t = times.get(id(n), 0.0)
            out.append(f"{'  '*depth}{n._label()}: {t*1000:.2f} ms")
            for c in n.children():
                twalk(c, depth + 1)
        twalk(plan)
        prof = getattr(db.executor, "last_profile", None) or {}
        ops = prof.get("op_stats")
        if ops:
            out.append("-- op counts (traced program) --")
            out.append(f"gathers: {ops['gathers']}  "
                       f"gathered rows: {ops['gather_rows']}")
    out.append("")
    out.append(plan_to_dot(plan, cards, times))
    return "\n".join(out)
