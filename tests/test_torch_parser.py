"""The cases of tests/test_parser.py run against quickstep_tpu_torch
(Database(device="cpu") and the port's copies).

Unit tests: lexer + parser (reference parser golden-test analog)."""

import pytest

from quickstep_tpu_torch.errors import ParseError
from quickstep_tpu_torch.parser import parse_one, parse_statements
from quickstep_tpu_torch.parser import ast_nodes as A


def test_select_basic():
    s = parse_one("SELECT a, b AS bb FROM t WHERE a > 1 ORDER BY b DESC LIMIT 5")
    assert isinstance(s, A.SelectStmt)
    assert len(s.select_list) == 2
    assert s.select_list[1].alias == "bb"
    assert s.limit == 5
    assert not s.order_by[0].ascending


def test_joins():
    s = parse_one("SELECT * FROM a JOIN b ON a.x = b.y LEFT OUTER JOIN c ON b.z = c.z")
    j = s.from_tables[0]
    assert isinstance(j, A.JoinRef) and j.kind == "left"
    assert isinstance(j.left, A.JoinRef) and j.left.kind == "inner"


def test_subqueries():
    s = parse_one("""SELECT a FROM t WHERE x IN (SELECT y FROM u)
                     AND EXISTS (SELECT * FROM v) AND b = (SELECT max(c) FROM w)""")
    assert s.where is not None


def test_case_extract_substring():
    s = parse_one("""SELECT CASE WHEN a = 1 THEN 'x' ELSE 'y' END,
                     EXTRACT(YEAR FROM d), SUBSTRING(s FROM 1 FOR 2) FROM t""")
    assert isinstance(s.select_list[0].expr, A.CaseExpr)
    assert isinstance(s.select_list[1].expr, A.ExtractExpr)
    assert isinstance(s.select_list[2].expr, A.SubstringExpr)


def test_typed_literals():
    s = parse_one("SELECT * FROM t WHERE d >= DATE '1994-01-01' + INTERVAL '3' MONTH")
    cmp = s.where
    assert isinstance(cmp, A.BinaryExpr)
    assert isinstance(cmp.right, A.BinaryExpr)
    assert isinstance(cmp.right.right, A.IntervalLiteral)
    assert cmp.right.right.kind == "yearmonth_interval"


def test_create_table_blockproperties():
    s = parse_one("""CREATE TABLE r (a INT NOT NULL, b VARCHAR(10), c DECIMAL)
                     WITH BLOCKPROPERTIES (TYPE columnstore, SORT a, BLOCKSIZEMB 4)""")
    assert isinstance(s, A.CreateTableStmt)
    assert s.columns[0].not_null
    assert s.columns[1].type_length == 10
    assert s.block_properties["type"] == "columnstore"


def test_partition_by():
    s = parse_one("""CREATE TABLE p (k INT NOT NULL) PARTITION BY HASH(k) PARTITIONS 4""")
    assert s.partition_kind == "hash"
    assert s.partition_attrs == ["k"]
    assert s.partition_count == 4


def test_dml():
    stmts = parse_statements("""
        INSERT INTO t VALUES (1, 'x'), (2, 'y');
        UPDATE t SET a = a + 1 WHERE b = 'x';
        DELETE FROM t WHERE a > 10;
        DROP TABLE t;
        COPY t FROM 'data.csv' WITH (DELIMITER '|');
    """)
    kinds = [type(s).__name__ for s in stmts]
    assert kinds == ["InsertStmt", "UpdateStmt", "DeleteStmt", "DropTableStmt",
                     "CopyStmt"]


def test_set_ops():
    # reference grammar: each set-op operand carries its own ORDER BY/LIMIT
    # (a trailing ORDER BY binds to the LAST operand, not the whole union)
    s = parse_one("SELECT a FROM t UNION ALL SELECT b FROM u ORDER BY a LIMIT 3")
    assert s.set_ops[0][0] == "union_all"
    assert s.set_ops[0][1].limit == 3
    assert s.limit is None
    # a parenthesized last operand leaves the trailing clause to the whole op
    s2 = parse_one("SELECT a FROM t UNION ALL (SELECT b FROM u) ORDER BY a LIMIT 3")
    assert s2.set_limit == 3 and len(s2.set_order_by) == 1


def test_window_over():
    s = parse_one("""SELECT sum(a) OVER (PARTITION BY b ORDER BY c
                     ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) FROM t""")
    fc = s.select_list[0].expr
    assert isinstance(fc, A.FunctionCall) and fc.window is not None
    assert fc.window.frame.mode == "rows"


def test_error_position():
    with pytest.raises(ParseError) as ei:
        parse_one("SELECT a FROM\nWHERE x")
    assert ei.value.line == 1


def test_commands():
    stmts = parse_statements("\\dt\n\\analyze foo")
    assert stmts[0].command == "\\dt"
    assert stmts[1].args == ["foo"]


def test_tpch_all_parse():
    from quickstep_tpu_torch.bench.tpch import TPCH_QUERIES
    for q, sql in TPCH_QUERIES.items():
        parse_one(sql)
