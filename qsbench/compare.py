"""The comparison that decides `correct`: the rows the program returned
against the reference's rows, exactly for integers, strings, dates and
NULLs and in row order, and by the relative gap for floats.

Each number compared has its limit here (PERF.md gives the readings each
was set from):

- failed_queries: statements that raised (an answer that never came);
- wrong_answers: answers with another row count or any non-float value
  that differs, or a float where the reference has none;
- max_rel_gap: the largest |got - want| / |want| of a float value over
  every answer compared (|got| where want is 0);
- empty_answers: queries the query set names as `nonempty` whose
  reference answer has no rows, so that no comparison of theirs is
  vacuous (an empty answer that the program also gives would pass).

This module imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

LIMITS = {"failed_queries": 0, "wrong_answers": 0, "max_rel_gap": 1e-9,
          "empty_answers": 0}


def answer_gap(got, want) -> Tuple[bool, float]:
    """(whether the answer is wrong other than in float digits, the
    largest relative gap of its floats)."""
    if got is None or len(got) != len(want):
        return True, 0.0
    gap = 0.0
    for g_row, w_row in zip(got, want):
        if len(g_row) != len(w_row):
            return True, gap
        for g, w in zip(g_row, w_row):
            if isinstance(w, float):
                if isinstance(g, bool) or not isinstance(g, (int, float)):
                    return True, gap
                d = abs(g - w)
                rel = d / abs(w) if w != 0 else d
                if math.isnan(rel):
                    return True, gap
                gap = max(gap, rel)
            elif g != w:
                return True, gap
    return False, gap


def judge(results: Iterable[Tuple[str, object]], want: Dict[str, list],
          failed: int, nonempty: Iterable[str] = ()
          ) -> Dict[str, Dict[str, float]]:
    """The numbers compared over `results`, (query name, rows) pairs, with
    each number's limit, in the order they are printed. `nonempty` names
    the queries whose answers must have rows."""
    wrong, gap = 0, 0.0
    for name, rows in results:
        bad, g = answer_gap(rows, want[name])
        wrong += bad
        gap = max(gap, g)
    return {"failed_queries": {"value": failed,
                               "limit": LIMITS["failed_queries"]},
            "wrong_answers": {"value": wrong,
                              "limit": LIMITS["wrong_answers"]},
            "max_rel_gap": {"value": gap, "limit": LIMITS["max_rel_gap"]},
            "empty_answers": {
                "value": sum(not want[q] for q in set(nonempty) & set(want)),
                "limit": LIMITS["empty_answers"]}}


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
