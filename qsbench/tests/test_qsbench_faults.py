"""A run with the timed path broken underneath comes out not correct: the
run on the CPU at SF0.01, the look for a card skipped, each fault planted
in the program's executor after the set-up."""

import time

import numpy as np
import pytest

from qsbench import run

SCALE = 0.01


def _altered(db):
    """An answer altered where it is produced: the first value of the
    first row of each SELECT's rows, one more (or a letter more)."""
    ex = db.executor
    run_plan = ex.run_plan

    def altered(plan, *args, **kwargs):
        out = run_plan(plan, *args, **kwargs)
        rows = out[0]
        if rows and not kwargs.get("columns") and not args:
            v = rows[0][0]
            v = v + "x" if isinstance(v, str) else (v or 0) + 1
            rows = [(v,) + tuple(rows[0][1:])] + list(rows[1:])
            return (rows,) + tuple(out[1:])
        return out
    ex.run_plan = altered


def _half_the_rows(db):
    """Half of lineitem left out: the program's table holds its first
    half, what it answers is taken over the rest."""
    from quickstep_tpu_torch.storage.table import TableData
    rel = db.catalog.default_database.get_relation("lineitem")
    half = rel.data.num_rows // 2
    stats = rel.statistics
    rel.set_data(TableData({
        c: type(col)(col.type, np.asarray(col.data)[:half], None,
                     col.dictionary)
        for c, col in rel.data.columns.items()}))
    rel.statistics = stats


def _unchanged(db):
    """A step that returns its state unchanged: every SELECT answers with
    the rows of the statement before it."""
    ex = db.executor
    run_plan = ex.run_plan
    last = {}

    def stale(plan, *args, **kwargs):
        out = run_plan(plan, *args, **kwargs)
        if args or kwargs:
            return out
        before = last.get("out", out)
        last["out"] = out
        return before
    ex.run_plan = stale


@pytest.mark.parametrize("fault", [_altered, _half_the_rows, _unchanged])
def test_a_broken_path_is_not_correct(fault):
    r = run.execute_cell("tpch10-power", 4242, 1.5, False, device="cpu",
                         scale=SCALE, fault=fault,
                         t_start=time.perf_counter())
    assert r["attempted"] > 0
    assert r["correct"] is False
    assert r["checks"]["wrong_answers"]["value"] > 0


def test_the_same_run_unbroken_is_correct():
    r = run.execute_cell("tpch10-power", 4242, 1.5, False, device="cpu",
                         scale=SCALE, t_start=time.perf_counter())
    assert r["correct"] is True
