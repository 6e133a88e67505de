# Copied from quickstep_tpu/utils/testdb.py; only the package name in imports differs.
"""The golden-test sample database.

Parity with the reference's TestDatabaseLoader
(query_optimizer/tests/TestDatabaseLoader.cpp:49-170): a 25-row `test` relation

    int_col    INT NULL      (-1)^x * x, NULL when x % 10 == 0
    long_col   LONG          x^2
    float_col  FLOAT         sqrt(x)
    double_col DOUBLE NULL   (-1)^x * x * sqrt(x), NULL when x % 10 == 0
    char_col   CHAR(20)      str(int_col) + " " + str(float_col)  (<=19 chars)

used by every execution_generator golden file.
"""

from __future__ import annotations

import math

from quickstep_tpu_torch.catalog import CatalogAttribute, CatalogRelation
from quickstep_tpu_torch.storage.table import TableData
from quickstep_tpu_torch.types import Char, DOUBLE, FLOAT, INT, LONG


def load_test_relation(db) -> None:
    """Create and populate the `test` relation in a Database."""
    attrs = [
        CatalogAttribute("int_col", INT.with_nullable(True)),
        CatalogAttribute("long_col", LONG),
        CatalogAttribute("float_col", FLOAT),
        CatalogAttribute("double_col", DOUBLE.with_nullable(True)),
        CatalogAttribute("char_col", Char(20)),
    ]
    rel = CatalogRelation("Test", attrs)
    rows = []
    for x in range(25):
        sign = 1 if x % 2 == 0 else -1
        rt = math.sqrt(x)
        int_col = None if x % 10 == 0 else sign * x
        double_col = None if x % 10 == 0 else sign * rt * x
        char_col = f"{sign * x} {rt:.6f}"
        if len(char_col) >= 20:
            char_col = char_col[:19]
        rows.append((int_col, x * x, rt, double_col, char_col))
    rel.set_data(TableData.from_rows(
        [(a.name, a.type) for a in attrs], rows))
    rel.analyze()
    db.catalog.default_database.add_relation(rel)
