"""The reference's golden corpus on the port: the 16 files of
tests/golden/reference (the reference engine's own ExecutionGenerator cases
over TestDatabaseLoader's 25-row `test` relation) and the 3 of
tests/golden/execute (over tests/test_golden.py's 25-row fixture), run
through the port's copy of the golden harness on a Database on the given
device. tests/test_torch_golden.py runs it on the CPU and chip_smoke.py on
the card.

    failures = run_file("tests/golden/reference/Join.test", "cuda")
"""

from __future__ import annotations

import glob
import os
from typing import List

from quickstep_tpu_torch.database import Database
from quickstep_tpu_torch.utils.golden import (
    outputs_match, parse_golden_file, run_case)
from quickstep_tpu_torch.utils.testdb import load_test_relation


def corpus_files(root: str) -> List[str]:
    """The corpus's files under the checkout's root: reference, then
    execute, each sorted."""
    golden = os.path.join(root, "tests", "golden")
    return sorted(glob.glob(os.path.join(golden, "reference", "*.test"))) + \
        sorted(glob.glob(os.path.join(golden, "execute", "*.test")))


def fixture_db(path: str, device) -> Database:
    """A fresh database with the file's fixture: the reference files'
    `test` relation, or the execute files' table with NULLs in every
    other type."""
    db = Database(device=device)
    if os.path.basename(os.path.dirname(path)) == "reference":
        load_test_relation(db)
        return db
    db.execute("""CREATE TABLE test (int_col INT, long_col BIGINT,
                  float_col FLOAT, double_col DOUBLE,
                  char_col CHAR(4), vchar_col VARCHAR(8))""")
    words = ["alpha", "beta", "gamma", "delta", "eps"]
    rows = []
    for i in range(25):
        rows.append((
            "NULL" if i % 5 == 0 else str(i - 12),
            str(i * 100),
            "NULL" if i % 7 == 0 else f"{i * 0.5}",
            f"{i * 0.25}",
            f"'c{i % 3}'",
            "NULL" if i % 11 == 0 else f"'{words[i % 5]}'",
        ))
    db.execute("INSERT INTO test VALUES " +
               ", ".join(f"({', '.join(r)})" for r in rows))
    return db


def run_file(path: str, device) -> List[str]:
    """The mismatches of one golden file's cases (empty: all pass), each
    with its SQL, the expected output and the port's."""
    with open(path) as f:
        cases = parse_golden_file(f.read())
    db = fixture_db(path, device)
    try:
        failures = []
        for i, case in enumerate(cases):
            actual = run_case(db, case)
            if not outputs_match(actual, case.expected, case.sql):
                failures.append(
                    f"{os.path.basename(path)} case {i} (line {case.line}):"
                    f"\n--- sql ---\n{case.sql}\n--- expected ---\n"
                    f"{case.expected}\n--- actual ---\n{actual}")
        return failures
    finally:
        db.close()


def count_cases(path: str) -> int:
    with open(path) as f:
        return len(parse_golden_file(f.read()))
