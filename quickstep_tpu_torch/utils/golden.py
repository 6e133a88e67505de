# Copied from quickstep_tpu/utils/golden.py; only the package name in imports differs.
"""Text-based golden-test driver.

Format parity with the reference's TextBasedTestDriver
(utility/textbased_test/TextBasedTestDriver.{hpp,cpp}; example
query_optimizer/tests/execution_generator/Select.test:18-33):

    # comment lines (ignored)
    [options]           (optional; "[default opt]" persists for later cases)
    <input SQL>
    --
    <expected output>
    ==
    <next case...>

"[same as above]" as the whole expected section re-uses the previous case's
expectation (TextBasedTestDriver.cpp:41,216).

Execution semantics mirror ExecutionGeneratorTestRunner::runTestCase
(query_optimizer/tests/ExecutionGeneratorTestRunner.cpp:133-215): statements
run in order against a database that persists across cases; SELECT results
print as PrintToScreen tables; DDL/DML print nothing; a SqlError prints its
caret-formatted message and aborts the rest of the case.

`update=True` rewrites expected sections from actual output (the reference's
--update_golden workflow).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Set

from quickstep_tpu_torch.database import Database
from quickstep_tpu_torch.errors import QuickstepError, SqlError


@dataclasses.dataclass
class GoldenCase:
    sql: str
    expected: str
    line: int
    options: Set[str] = dataclasses.field(default_factory=set)


def parse_golden_file(text: str) -> List[GoldenCase]:
    chunks = []
    cur: List[str] = []
    start_line = 0
    for i, line in enumerate(text.split("\n")):
        if line.strip() == "==":
            chunks.append((start_line, cur))
            cur = []
            start_line = i + 1
        else:
            cur.append(line)
    if any(l.strip() for l in cur):
        chunks.append((start_line, cur))
    cases: List[GoldenCase] = []
    default_options: Set[str] = set()
    for start, lines in chunks:
        sql_lines: List[str] = []
        exp_lines: List[str] = []
        options: Set[str] = set()
        in_expected = False
        for line in lines:
            if not in_expected and line.strip() == "--":
                in_expected = True
                continue
            if in_expected:
                exp_lines.append(line)
                continue
            s = line.strip()
            if not sql_lines or not any(l.strip() for l in sql_lines):
                # leading comment / option lines (before input text)
                if s.startswith("#"):
                    continue
                if s.startswith("[") and s.endswith("]") and \
                        s != "[same as above]":
                    opts = s[1:-1].split()
                    if opts and opts[0] == "default":
                        default_options = set(opts[1:])
                    else:
                        options.update(opts)
                    continue
            sql_lines.append(line)
        sql = "\n".join(sql_lines).strip()
        if not sql:
            continue
        expected = "\n".join(exp_lines).strip()
        if expected == "[same as above]":
            expected = cases[-1].expected if cases else ""
        cases.append(GoldenCase(sql=sql, expected=expected, line=start,
                                options=options | default_options))
    return cases


def _has_toplevel_order_by(sql: str) -> bool:
    """True if the statement has an ORDER BY at paren depth 0 (i.e. one that
    determines final output row order). ORDER BY inside subqueries or window
    specs does not constrain the printed order."""
    depth = 0
    i = 0
    n = len(sql)
    low = sql.lower()
    has_order = False
    while i < n:
        c = sql[i]
        if c == "'":
            i += 1
            while i < n and sql[i] != "'":
                i += 1
        elif c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
        elif depth == 0 and (i == 0 or not low[i - 1].isalnum()):
            if low.startswith("order", i):
                j = i + 5
                while j < n and low[j].isspace():
                    j += 1
                if low.startswith("by", j):
                    has_order = True
            # a depth-0 set operation interleaves its operands in engine-
            # specific order, so no single ORDER BY governs the output
            for kw in ("union", "intersect", "except"):
                if low.startswith(kw, i) and \
                        not (i + len(kw) < n and low[i + len(kw)].isalnum()):
                    return False
        i += 1
    return has_order


def _sort_table_bodies(text: str) -> str:
    """Canonicalize printed output: sort the data rows of each PrintToScreen
    table block (rows between the header rule and the final rule)."""
    lines = text.split("\n")
    out: List[str] = []
    i = 0
    n = len(lines)
    while i < n:
        line = lines[i]
        if line.startswith("+-") and i + 2 < n and \
                lines[i + 1].startswith("|") and lines[i + 2].startswith("+-"):
            # table header: rule, header, rule; then data rows until rule
            out.extend(lines[i:i + 3])
            i += 3
            body = []
            while i < n and lines[i].startswith("|"):
                body.append(lines[i])
                i += 1
            out.extend(sorted(body))
            continue
        out.append(line)
        i += 1
    return "\n".join(out)


def outputs_match(actual: str, expected: str, sql: str) -> bool:
    """Byte-exact comparison, except that when the statement has no top-level
    ORDER BY the data rows of each printed table are compared as multisets
    (the reference prints rows in its own hash-table/block order, which no
    other engine can reproduce; cell formatting is still byte-exact)."""
    a, e = actual.strip(), expected.strip()
    if a == e:
        return True
    if _has_toplevel_order_by(sql):
        return False
    return _sort_table_bodies(a) == _sort_table_bodies(e)


def run_case(db: Database, case: GoldenCase, mode: str = "execute") -> str:
    """Actual output for one case (ExecutionGeneratorTestRunner semantics)."""
    if mode == "plan":
        try:
            from quickstep_tpu_torch.parser import parse_one
            from quickstep_tpu_torch.optimizer.resolver import Resolver
            from quickstep_tpu_torch.optimizer.rules import optimize_plan
            plan = Resolver(db.catalog.default_database).resolve_select(
                parse_one(case.sql))
            plan = optimize_plan(plan, db.config,
                                 db.catalog.default_database)
            return plan.tree_string()
        except SqlError as e:
            return e.format(case.sql)
        except QuickstepError as e:
            return f"ERROR: {e}"
    out = []
    try:
        from quickstep_tpu_torch.parser import parse_statements
        stmts = parse_statements(case.sql)
    except SqlError as e:
        return e.format(case.sql)
    for stmt in stmts:
        try:
            if "print_physical_plan" in case.options:
                from quickstep_tpu_torch.parser import ast_nodes as A
                if isinstance(stmt, A.SelectStmt):
                    from quickstep_tpu_torch.optimizer.resolver import Resolver
                    from quickstep_tpu_torch.optimizer.rules import optimize_plan
                    from quickstep_tpu_torch.utils.reference_plan import (
                        reference_plan_string)
                    plan = optimize_plan(
                        Resolver(db.catalog.default_database)
                        .resolve_select(stmt),
                        db.config, db.catalog.default_database)
                    ref = reference_plan_string(plan)
                    out.append(ref if ref is not None
                               else plan.tree_string())
                    out.append("--")
            res = db.executor.execute_statement(stmt)
        except SqlError as e:
            out.append(e.format(case.sql))
            break
        except Exception as e:   # engine errors abort the case, not the file
            out.append(f"ERROR: {e}")
            break
        from quickstep_tpu_torch.parser import ast_nodes as A
        if res.column_names:      # SELECT (or command with tabular output)
            out.append(res.to_table())
        elif res.message is not None and (
                getattr(stmt, "command", None) or
                (isinstance(stmt, A.CopyStmt) and
                 stmt.path in ("stdout", "stderr"))):
            out.append(res.message)
    return "\n".join(out)


def run_golden_file(path: str, db: Database, mode: str = "execute",
                    update: bool = False) -> List[str]:
    """Run all cases; returns list of failure descriptions (empty = pass).
    update=True rewrites the file with actual outputs."""
    with open(path) as f:
        text = f.read()
    cases = parse_golden_file(text)
    failures = []
    actuals = []
    for case in cases:
        actual = run_case(db, case, mode)
        actuals.append(actual)
        if not outputs_match(actual, case.expected, case.sql):
            failures.append(
                f"{path}:{case.line}: mismatch\n--- expected ---\n"
                f"{case.expected}\n--- actual ---\n{actual}")
    if update:
        parts = []
        for case, actual in zip(cases, actuals):
            parts.append(f"{case.sql}\n--\n{actual}\n")
        with open(path, "w") as f:
            f.write("==\n".join(parts))
        return []
    return failures
