"""The reference against sqlite on the 22 queries at SF0.01, over the same
generated tables (sqlite sums DECIMALs as doubles: floats within 1e-9);
Q11 at two fractions, read from its SQL; texts the reference was not
written for refused; an answer that must have rows and has none refused."""

import math

import pytest

from qsbench import compare, gen, reference, registry
from qsbench.tests import sqlite_ref

SCALE = 0.01
SQLS = registry.queries("tpch-sf10")


@pytest.fixture(scope="module")
def both():
    tables = gen.generate(SCALE, 20241)
    return (reference.answers(tables, SQLS), sqlite_ref.connect(tables),
            tables)


@pytest.mark.parametrize("q", [f"q{i}" for i in range(1, 23)])
def test_reference_matches_sqlite(both, q):
    want, conn, _ = both
    sql = SQLS[q]
    if q == "q13":
        sql = sqlite_ref.Q13
    _same_as_sqlite(conn, sql, want[q])


def _same_as_sqlite(conn, sql, rows):
    got = conn.execute(sqlite_ref.to_sqlite_sql(sql)).fetchall()
    assert len(got) == len(rows), (len(got), len(rows))
    for g, w in zip(got, rows):
        assert len(g) == len(w)
        for x, y in zip(g, w):
            if isinstance(y, float):
                assert math.isclose(x, y, rel_tol=1e-9, abs_tol=0.0), (g, w)
            else:
                assert x == y, (g, w)


def test_answers_have_rows(both):
    """Every answer but Q17's, Q18's and Q20's (too rare a match at
    SF0.01) has rows, and no scalar answer is NULL."""
    want, _, _ = both
    assert all(want[q] and want[q] != [[None]] for q in want
               if q not in ("q17", "q18", "q20"))
    assert set(registry.query_set("tpch-sf10")["nonempty"]) == set(
        want) - {"q17", "q18", "q20"}


@pytest.mark.parametrize("fraction", ["0.0001", "0.001"])
def test_q11_reads_its_fraction_from_the_sql(both, fraction):
    """At SF0.01 the specification's fraction is 0.01; the query set's
    0.00001 (SF10's) keeps more parts than 0.0001, which keeps more than
    0.001, and each matches sqlite."""
    want, conn, tables = both
    sql = SQLS["q11"].replace("* 0.00001", f"* {fraction}")
    assert sql != SQLS["q11"]
    rows = reference.answers(tables, {"q11": sql})["q11"]
    _same_as_sqlite(conn, sql, rows)
    assert 0 < len(rows) < len(want["q11"])


def test_a_text_it_was_not_written_for_is_refused(both):
    _, _, tables = both
    for q, sql in (("q6", SQLS["q6"].replace("< 24", "< 25")),
                   ("q11", SQLS["q11"].replace("GERMANY", "FRANCE")),
                   ("q1", SQLS["q6"])):
        with pytest.raises(ValueError, match=q):
            reference.answers(tables, {q: sql})


def test_an_empty_answer_that_must_have_rows_is_refused():
    want = {"q11": [], "q18": []}
    checks = compare.judge(want.items(), want, 0, ["q11"])
    assert checks["empty_answers"]["value"] == 1
    assert not compare.passed(checks)
    checks = compare.judge(want.items(), want, 0, ["q2"])
    assert compare.passed(checks)
