"""The cases of tests/test_types.py run against quickstep_tpu_torch
(Database(device="cpu") and the port's copies).

Unit tests: type system + date encodings (reference types/tests analog)."""

import pytest

from quickstep_tpu_torch.types import (
    TypeID, TypeFactory, INT, LONG, FLOAT, DOUBLE, DATE, Char, VarChar,
)
from quickstep_tpu_torch.types.datetime_util import (
    date_encode, date_decode, date_to_str, parse_date_literal,
    parse_datetime_literal, parse_interval_literal, date_add_months,
    date_add_days,
)


def test_numeric_unify():
    assert TypeFactory.unify(INT, LONG).type_id == TypeID.LONG
    assert TypeFactory.unify(INT, DOUBLE).type_id == TypeID.DOUBLE
    assert TypeFactory.unify(FLOAT, LONG).type_id == TypeID.FLOAT
    assert TypeFactory.unify(INT, INT).type_id == TypeID.INT
    assert TypeFactory.unify(Char(5), VarChar(9)).length == 9
    assert TypeFactory.unify(INT, Char(3)) is None


def test_nullability_propagates():
    t = TypeFactory.unify(INT.with_nullable(True), LONG)
    assert t.nullable


def test_date_encoding_order_preserving():
    d1 = parse_date_literal("1994-01-01")
    d2 = parse_date_literal("1994-01-02")
    d3 = parse_date_literal("1994-02-01")
    d4 = parse_date_literal("1995-01-01")
    assert d1 < d2 < d3 < d4
    assert date_to_str(d1) == "1994-01-01"
    assert date_decode(d3) == (1994, 2, 1)


def test_date_arithmetic():
    d = parse_date_literal("1994-01-31")
    assert date_to_str(date_add_months(d, 1)) == "1994-02-28"
    assert date_to_str(date_add_months(d, 12)) == "1995-01-31"
    assert date_to_str(date_add_days(parse_date_literal("1994-12-31"), 1)) == \
        "1995-01-01"


def test_interval_parse():
    assert parse_interval_literal("3 month") == ("yearmonth_interval", 3)
    assert parse_interval_literal("1 year") == ("yearmonth_interval", 12)
    assert parse_interval_literal("90 day")[0] == "datetime_interval"
    assert parse_interval_literal("90 day")[1] == 90 * 86_400_000_000


def test_bad_date():
    with pytest.raises(ValueError):
        parse_date_literal("1994-13-01")
    with pytest.raises(ValueError):
        parse_date_literal("1994-02-30")


def test_datetime_parse():
    us = parse_datetime_literal("1970-01-01 00:00:01")
    assert us == 1_000_000
