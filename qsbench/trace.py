"""The traced run's instruments: spans around the program's layers, taken
by the harness's own wrappers (nothing inside the program changes), and
the device's activity from torch.profiler.

Spans are kept in memory as (thread id, name, start, end) on the host's
perf_counter_ns clock. The profiler's clock is another: a mark made when
the trace starts (DeviceTrace.start) gives the offset between the two,
within the few microseconds a launch takes, and every device interval is
moved onto the host clock by it.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

# the executor's methods that the traced run wraps, by span name
EXECUTOR_SPANS = {"plan_select": "plan", "run_plan": "run_plan",
                  "_segment_inputs": "upload", "_device_table": "upload",
                  "_pull_outputs": "materialise", "_to_host": "materialise"}


class Spans:
    def __init__(self, queries: Dict[str, str] = None):
        self.items: List[Tuple[int, str, int, int]] = []
        self.executions: List[dict] = []
        # the query of each statement parsed, by the statement's id
        self._sql_of: Dict[int, str] = {}
        self._name_of = {sql: q for q, sql in (queries or {}).items()}
        self._lock = threading.Lock()

    def wrap(self, fn, name: str):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                t1 = time.perf_counter_ns()
                with self._lock:
                    self.items.append((threading.get_ident(), name, t0, t1))
        return wrapped

    def instrument(self, db) -> None:
        """Wrap the parser, the executor's layers and each statement the
        PolicyEnforcer runs (with the executor's stream record of it)."""
        import quickstep_tpu_torch.parser as parser
        parse = self.wrap(parser.parse_statements, "parse")

        def parse_statements(sql, *args, **kwargs):
            stmts = parse(sql, *args, **kwargs)
            for s in stmts:
                self._sql_of[id(s)] = self._name_of.get(sql, "statement")
            return stmts
        parser.parse_statements = parse_statements
        ex = db.executor
        for method, name in EXECUTOR_SPANS.items():
            setattr(ex, method, self.wrap(getattr(ex, method), name))
        enforcer = db.policy_enforcer
        execute = enforcer._execute

        def statement(stmt):
            t0 = time.perf_counter_ns()
            try:
                return execute(stmt)
            finally:
                t1 = time.perf_counter_ns()
                with self._lock:
                    self.items.append((threading.get_ident(), "statement",
                                       t0, t1))
                    self.executions.append(
                        {"start": t0, "end": t1,
                         "query": self._sql_of.get(id(stmt), "statement"),
                         "stream": ex.last_stream_info})
        enforcer._execute = statement

    def within(self, names, lo: int, hi: int) -> List[Tuple[str, int, int]]:
        return [(n, a, b) for _, n, a, b in self.items
                if n in names and lo <= a < hi]

    def label_at(self, t: int, thread: Optional[int]) -> str:
        """The query that the dispatcher thread ran at t and the innermost
        of its spans open then."""
        best = None
        for tid, name, a, b in self.items:
            if tid == thread and a <= t < b and (best is None or a > best[0]):
                best = (a, name)
        if best is None:
            return "no statement"
        query = next((e["query"] for e in self.executions
                      if e["start"] <= t < e["end"]), "statement")
        return f"{query} {best[1]}"


def dispatcher_thread(spans: Spans) -> Optional[int]:
    for tid, name, _, _ in spans.items:
        if name == "statement":
            return tid
    return None


MARKER = "qsbench.trace_mark"


class DeviceTrace:
    """torch.profiler over the card's activity (kernels, copies, sets);
    cpu=True reads the host's operators instead, for rehearsals without a
    card."""

    def __init__(self, cpu: bool = False):
        from torch.profiler import ProfilerActivity, profile
        self.cpu = cpu
        self.prof = profile(activities=[
            ProfilerActivity.CPU if cpu else ProfilerActivity.CUDA])
        self.offset = 0
        self.intervals: List[Tuple[int, int, str]] = []

    def start(self) -> None:
        """Start tracing, then mark the trace: a record_function span on
        the host, or one small kernel on the idle card, whose start is
        taken to be the host clock's reading just before it."""
        import torch
        self.prof.start()
        if self.cpu:
            self._mark = time.perf_counter_ns()
            with torch.profiler.record_function(MARKER):
                pass
        else:
            x = torch.empty(1, device="cuda")
            torch.cuda.synchronize()
            self._mark = time.perf_counter_ns()
            x.fill_(1.0)
            torch.cuda.synchronize()

    def stop(self) -> None:
        from torch.autograd import DeviceType
        self.prof.stop()
        kind = DeviceType.CPU if self.cpu else DeviceType.CUDA
        events = [e for e in self.prof.profiler.kineto_results.events()
                  if e.device_type() == kind]
        if self.cpu:
            mark = min(e.start_ns() for e in events if e.name() == MARKER)
        else:
            mark = min(e.start_ns() for e in events)
        self.offset = self._mark - mark
        self.intervals = sorted(
            (e.start_ns() + self.offset,
             e.start_ns() + self.offset + e.duration_ns(), e.name())
            for e in events)


def busy(intervals, lo: int, hi: int) -> Tuple[float, List[Tuple[int, int]]]:
    """(seconds in [lo, hi) covered by any interval, the idle gaps)."""
    covered, gaps, at = 0, [], lo
    for a, b, *_ in intervals:
        a, b = max(a, lo), min(b, hi)
        if b <= a or b <= at:
            continue
        if a > at:
            gaps.append((at, a))
            at = a
        covered += b - at
        at = b
    if at < hi:
        gaps.append((at, hi))
    return covered / 1e9, gaps


def breakdown(intervals, gaps, spans: Spans, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle
    gaps, each labelled with what the dispatcher thread was doing."""
    by_name: Dict[str, int] = defaultdict(int)
    for a, b, name in intervals:
        by_name[name] += b - a
    ops = sorted(by_name.items(), key=lambda x: -x[1])[:top]
    thread = dispatcher_thread(spans)
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n[:120], v / 1e9] for n, v in ops],
            "idle_gaps": [[spans.label_at((a + b) // 2, thread),
                           (b - a) / 1e9] for a, b in longest]}
