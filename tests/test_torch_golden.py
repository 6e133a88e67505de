"""The reference's golden corpus on the port, on the CPU: the 16 files of
tests/golden/reference and the 3 of tests/golden/execute through the port's
copy of the golden harness (bench/golden_corpus.py). The comparison is the
harness's own: byte for byte, and the rows of a table as a multiset where
the statement has no top-level ORDER BY. No case is skipped. The one plan
file, tests/golden/plan/plans.test, runs apart (mode "plan": the optimized
plan's text) over the execute files' fixture."""

import os

import pytest

from quickstep_tpu_torch.bench.golden_corpus import (
    corpus_files, fixture_db, run_file)
from quickstep_tpu_torch.utils.golden import run_golden_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = corpus_files(REPO)


def test_corpus_is_whole():
    assert [os.path.basename(os.path.dirname(p)) for p in FILES].count(
        "reference") == 16
    assert len(FILES) == 19


@pytest.mark.parametrize("path", FILES, ids=lambda p: "/".join(
    p.split(os.sep)[-2:]))
def test_golden_file_on_port(path):
    failures = run_file(path, "cpu")
    assert not failures, f"{len(failures)} mismatches\n" + "\n\n".join(
        failures)


def test_golden_plan_file_on_port():
    path = os.path.join(REPO, "tests", "golden", "plan", "plans.test")
    db = fixture_db(path, "cpu")
    try:
        failures = run_golden_file(path, db, mode="plan")
    finally:
        db.close()
    assert not failures, f"{len(failures)} mismatches\n" + "\n\n".join(
        failures)
