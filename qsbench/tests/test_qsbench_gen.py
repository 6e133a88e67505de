"""The generator: one seed, one set of tables; another seed, others; the
schema, the row counts and the vocabularies at SF0.01."""

import pytest
import torch

from qsbench import gen

SCALE = 0.01
ROWS = {"region": 5, "nation": 25, "supplier": 100, "part": 2000,
        "partsupp": 8000, "customer": 1500, "orders": 15000}


@pytest.fixture(scope="module")
def tables():
    return gen.generate(SCALE, 2**40 + 7)


def _same(a, b):
    return all(torch.equal(a.columns[t][c], b.columns[t][c])
               for t in a.columns for c in a.columns[t]) and a.vocab == b.vocab


def test_same_seed_same_tables(tables):
    assert _same(tables, gen.generate(SCALE, 2**40 + 7))


def test_other_seed_other_tables(tables):
    other = gen.generate(SCALE, 2**40 + 8)
    assert not _same(tables, other)
    assert not torch.equal(tables.columns["lineitem"]["l_partkey"][:1000],
                           other.columns["lineitem"]["l_partkey"][:1000])


def test_schema_and_row_counts(tables):
    assert list(tables.columns) == list(gen.SCHEMAS)
    for t, schema in gen.SCHEMAS.items():
        assert list(tables.columns[t]) == [c for c, _ in schema]
        n = tables.rows(t)
        for c, typ in schema:
            x = tables.columns[t][c]
            # DECIMAL(15,2) as the specification's dss.ddl: int64 cents
            assert len(x) == n and x.dtype == (
                torch.int64 if typ == "DECIMAL(15,2)" else torch.int32)
        if t in ROWS:
            assert n == ROWS[t]
    # 1 to 7 lines an order, 4 a line on average
    assert 15000 <= tables.rows("lineitem") <= 7 * 15000
    assert abs(tables.rows("lineitem") / 15000 - 4) < 0.1


def test_vocabularies_sorted_distinct_and_in_range(tables):
    for t, vocab in tables.vocab.items():
        for c, words in vocab.items():
            assert words == sorted(set(words)), (t, c)
            x = tables.columns[t][c]
            assert int(x.min()) >= 0 and int(x.max()) < len(words)
    assert sum("special of requests" in v
               for v in tables.vocab["orders"]["o_comment"]) > 1000
    assert len(tables.vocab["part"]["p_name"]) > 1_900_000


def test_value_domains(tables):
    li, o = tables.columns["lineitem"], tables.columns["orders"]
    assert int(li["l_quantity"].min()) == 100
    assert int(li["l_quantity"].max()) == 5000
    assert 0 <= int(li["l_discount"].min()) and int(li["l_discount"].max()) <= 10
    assert bool((li["l_receiptdate"] > li["l_shipdate"]).all())
    assert int(o["o_orderdate"].min()) >= gen.date_code("1992-01-01")
    assert int(o["o_orderdate"].max()) <= gen.date_code("1998-08-02")
    # one order's lines carry its key, lines numbered from 1
    assert torch.equal(torch.unique(li["l_orderkey"]),
                       torch.sort(o["o_orderkey"]).values)
    assert int(li["l_linenumber"].min()) == 1
    assert int(li["l_linenumber"].max()) <= 7
    # a third of the customers place no order
    assert not bool((o["o_custkey"] % 3 == 0).any())


def test_iso_and_codes_round_trip():
    for iso in ("1992-01-01", "1995-06-17", "1998-12-31"):
        assert gen.iso_of_code(gen.date_code(iso)) == iso
    assert gen.date_code("1995-03-15") < gen.date_code("1995-03-16")


@pytest.mark.cuda
def test_same_seed_same_tables_on_the_card(card):
    a = gen.generate(SCALE, 3**30, card)
    assert _same(a, gen.generate(SCALE, 3**30, card))
