"""The engines that tests/test_torch_differential_*.py hold against each
other over bench/differential.py's databases on the CPU: the port and
quickstep_tpu (one database each, reloaded when the seed changes), and
sqlite for the shapes where quickstep_tpu raises or errs."""

import re
import sqlite3

import numpy as np

import quickstep_tpu
from quickstep_tpu import catalog as jcatalog, types as jtypes
from quickstep_tpu.storage import column as jcolumn, table as jtable
from quickstep_tpu_torch import Database
from quickstep_tpu_torch.bench import differential as D
from quickstep_tpu_torch.config import Config

REFERENCE_MODULES = (jcatalog, jtable, jcolumn, jtypes)
STRING_COLUMNS = {"c", "c_n", "v", "v_n"}


def _words(query):
    return set(re.findall(r"\w+", query.sql))


def _float_columns(query, tables):
    """The live values of each REAL or DOUBLE column the query names."""
    words = _words(query)
    for name, t in tables.items():
        if name not in words:
            continue
        for c in t.columns:
            if c.sql_type in ("REAL", "DOUBLE") and c.name in words:
                x = np.asarray(c.data, np.float64)
                yield x if c.valid is None else x[c.valid]


def reads_empty_string_column(query, tables):
    """quickstep_tpu raises a TypeError where the query reads a CHAR or
    VARCHAR column and one of the tables it names has no rows: it indexes
    the empty column's code remap or LIKE bitmap (exec/runner.py:2053,
    expressions/scalar.py:521 and :651)."""
    words = _words(query)
    return bool(words & STRING_COLUMNS) and any(
        t.rows == 0 and name in words for name, t in tables.items())


def reads_infinite_statistics(query, tables):
    """quickstep_tpu raises an OverflowError where the query sums a
    DECIMAL and a float column it scans has +-inf and no NaN among its
    values: the sum's overflow guard takes int() of the column's min and
    max statistics (optimizer/resolver.py:656, which catches the
    ValueError of a NaN but not this)."""
    return any(np.isinf(x).any() and not np.isnan(x).any()
               for x in _float_columns(query, tables))


def counts_distinct_nan(query, tables):
    """quickstep_tpu's COUNT(DISTINCT x) of a float column holding NaN
    depends on its padding: NaNs sort after the padding rows' +inf
    sentinels, so they are counted only where no dead or NULL row comes
    first, and a sentinel in their stead counts as one more value
    (ops/groupby.py:455-468). The port counts no NaN, as sqlite, which
    stores NaN as NULL."""
    return "DISTINCT" in query.sql and any(
        np.isnan(x).any() for x in _float_columns(query, tables))


INTEGER_COLUMNS = "id|uk|kd|kw|kb|ks|kx|i|i_n|l|l_n"


def sqlite_sql(sql):
    """The statement as sqlite reads it the engines' way: AVG of an integer
    column is SUM / COUNT in integers (the engines' integer division), and
    a GROUP BY has no group of NULL keys (the engines drop such rows)."""
    sql = re.sub(rf"\bavg\(((?:\w+\.)?(?:{INTEGER_COLUMNS}))\)",
                 r"(sum(\1) / count(\1))", sql)
    m = re.search(r" GROUP BY (.+?)(?: HAVING (.+))?$", sql)
    if m:
        keys = " AND ".join(f"({k.strip()}) IS NOT NULL"
                            for k in m.group(1).split(","))
        having = keys if m.group(2) is None else f"{keys} AND ({m.group(2)})"
        sql = f"{sql[:m.start()]} GROUP BY {m.group(1)} HAVING {having}"
    return sql


def mesh_database(device, shards=4):
    """A port database on a mesh of `shards` row shards of `device` whose
    replicate threshold shards every table of more than 8 rows."""
    cfg = Config()
    cfg.distributed = True
    cfg.replicate_threshold_rows = 8
    return Database(config=cfg, device=device, mesh_shards=shards)


def cases(families):
    """(seed, family) parameters with readable ids, seed-major so that a
    file loads each seed's tables once."""
    import pytest
    return [pytest.param(seed, family, id=f"seed{seed}-{family}")
            for seed in D.SEEDS for family in families]


class Engines:
    def __init__(self):
        self.port = Database(device="cpu")
        self.reference = quickstep_tpu.Database()
        self.seed = self.tables = self.conn = None

    def load(self, seed):
        if seed != self.seed:
            self.tables = D.make_database(seed)
            D.load_tables(self.port, self.tables)
            D.load_tables(self.reference, self.tables, REFERENCE_MODULES)
            # quickstep_tpu keys its logical plans on the statement alone
            # (exec/executor.py:216-217) and empties them only after a
            # DDL or DML statement: a plan of the last seed's tables would
            # decode strings through their dictionaries
            self.reference.executor._logical_plan_cache.clear()
            self.seed, self.conn = seed, None
        return self.tables

    def sqlite_rows(self, query):
        if self.conn is None:
            self.conn = sqlite3.connect(":memory:")
            D.load_sqlite(self.conn, self.tables)
        return [tuple(r) for r in
                self.conn.execute(sqlite_sql(query.sql)).fetchall()]

    def check(self, seed, family):
        """The family's share of the seed's battery (D.rotation) through
        the port and quickstep_tpu. Where quickstep_tpu raises or differs
        on the shape of a known reference fault (ROADMAP), the query is
        held against sqlite instead, and the reference must still raise
        or differ."""
        tables = self.load(seed)
        run = [q for q in D.rotation(seed, D.queries(seed))
               if q.family == family]
        assert run, family
        for query in run:
            ours = D.run_query(self.port, query)
            try:
                want = D.run_query(self.reference, query)
                raised = None
            except (TypeError, OverflowError) as e:
                want, raised = None, e
            why = None if want is None else (
                f"setup counts {ours[0]} against {want[0]}"
                if ours[0] != want[0] else
                D.same_rows(ours[1], want[1], query, tables))
            fault = (isinstance(raised, TypeError) and
                     reads_empty_string_column(query, tables)) or (
                isinstance(raised, OverflowError) and
                reads_infinite_statistics(query, tables)) or (
                why is not None and counts_distinct_nan(query, tables))
            if raised is not None and not fault:
                raise raised
            if fault:
                why = D.same_rows(ours[1], self.sqlite_rows(query), query,
                                  tables, accumulate="DOUBLE")
            assert why is None, f"seed {seed} {query.sql}: {why}"

    def close(self):
        self.port.close()
