"""Seeded edge-case databases and the queries that hold one engine to
another over them.

make_database(seed) gives three tables (two fact-like, fa and fb, and a
dimension-like dm) as numpy columns with their validity: a unique `id`
and `uk` per table, keys of the distributions the kernels route on, and
every SQL type the port supports (INT, BIGINT, REAL, DOUBLE,
DECIMAL(15,2), DATE, CHAR(6), VARCHAR(10)) both NOT NULL and nullable,
with NULLs at 0 %, 15 % or 100 % of a column, +-0.0, NaN, +-inf, 1e10 and
3e9, BIGINTs at +-2^40 and INT64_MAX - 1, empty and duplicate strings.
Row counts come from SIZES, which straddle the card's tile edges
(ops/cuda.py). load_tables puts them into a database of either package
through its catalog, column by column, so NaN, -0.0 and exact BIGINTs
arrive as bits, not through SQL literals.

queries(seed) gives Query records: a family (named for the route or
kernel it aims at), the statements, and how each result column is
compared. same_rows compares two results. tests/test_torch_differential_*.py
hold the port on the CPU to quickstep_tpu and the port's 4-shard mesh to
its one device; chip_smoke.py's phase 2d holds the card to the port's CPU
path and the card's mesh to its one device.

Replay one seed and family by hand:

    from quickstep_tpu_torch import Database
    from quickstep_tpu_torch.bench import differential as D
    tables = D.make_database(3)
    db = Database(device="cpu")
    D.load_tables(db, tables)
    for q in D.queries(3):
        if q.family == "sort_groupby":
            print(q.sql, D.run_query(db, q)[:5])

Seeds are fixed as range(N); none is chosen.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SEEDS = range(16)
# rows of (fa, fb, dm) for seed % len(SIZES): 0, 1 and 7; the 1,024-row
# tiles of W2 and W4 (1,023, 1,024, 1,025); the 2,048-row tiles of K5 and
# W1 (2,047, 2,049); the 4,096-row tiles of K9, W3 and K14 and K9's
# one-launch limit (4,095, 4,096, 4,097); and fa above the mesh's
# replicate_threshold_rows (65,536) once
SIZES = ((1023, 1025, 7), (1024, 2047, 1), (4095, 2049, 1023),
         (4097, 4096, 0), (70_001, 1024, 1024), (0, 7, 1023),
         (1, 4095, 7), (2049, 4097, 1024))
TABLES = ("fa", "fb", "dm")
INT64_MAX = 2 ** 63 - 1
# (column, SQL type); each also comes nullable as <column>_n
VALUE_COLUMNS = (("i", "INT"), ("l", "BIGINT"), ("r", "REAL"),
                 ("d", "DOUBLE"), ("m", "DECIMAL(15,2)"), ("t", "DATE"),
                 ("c", "CHAR(6)"), ("v", "VARCHAR(10)"))
# id: unique, dense (the direct join); uk: unique over a span past 2^31
# with INT64_MAX - 1; kd: a dense domain of at most 128 (K2); kw: a span
# past 2^31 with duplicates (the sort GROUP BY, the hashed routes); kb: a
# span just past 2^22; ks: one key on half the rows (K8, K11 skew); kx:
# id // 3, each key on at most three rows (the expansion join, whose
# output stays near the probe's rows)
STRINGS = ("", "a", "ab", "abc", "b", "ba", "zz", "a%b", "a_b", "x y", "Ab",
           "abcdef")
LONG_STRINGS = ("abcdefghij", "", "zzzzzzzzzz", "q")
FLOAT_EDGES = (0.0, -0.0, 1e10, 3e9, -3e9)
NAN_EDGES = (math.nan, math.inf, -math.inf)
# the values of the CAST cases: the integer targets' edges, both zeros,
# both infinities and NaN
CAST_VALUES = (1e10, 3e9, -3e9, 1e20, -1e20, math.inf, -math.inf, math.nan,
               2147483647.9, -0.0, 2147483647.0, -2147483648.9, 9.2e18,
               -9.3e18, 2.0 ** 63, 1.5, -1.5, 2.5)


@dataclasses.dataclass
class Col:
    name: str
    sql_type: str          # INT, BIGINT, REAL, DOUBLE, DECIMAL(15,2), DATE,
    #                        CHAR(6), VARCHAR(10)
    data: np.ndarray       # device encoding; strings as an object array
    valid: Optional[np.ndarray] = None    # None: NOT NULL


@dataclasses.dataclass
class Table:
    name: str
    columns: List[Col]

    @property
    def rows(self) -> int:
        return len(self.columns[0].data)

    def column(self, name: str) -> Col:
        return next(c for c in self.columns if c.name == name)


def _date(y, m, d):
    # types/datetime_util.py date_encode
    return (y << 9) | (m << 5) | d


def _nulls(rng, n):
    """A validity mask with NULLs at 0 %, 15 % or 100 % of the rows."""
    frac = rng.choice([0.0, 0.15, 1.0], p=[0.3, 0.55, 0.15])
    return rng.random(n) >= frac


def _floats(rng, n, edges):
    x = rng.normal(size=n) * 10.0 ** rng.integers(0, 4, size=n)
    hit = rng.random(n) < 0.04
    x[hit] = rng.choice(np.asarray(edges, np.float64), size=int(hit.sum()))
    return x


def _values(rng, name, sql_type, n, nullable):
    if sql_type == "INT":
        x = rng.integers(-1000, 1000, size=n).astype(np.int32)
        hit = rng.random(n) < 0.02
        x[hit] = rng.choice(np.asarray([2**31 - 1, -2**31 + 1, 0], np.int32),
                            size=int(hit.sum()))
    elif sql_type == "BIGINT":
        x = rng.integers(-2**40, 2**40, size=n, dtype=np.int64)
        hit = rng.random(n) < 0.05
        x[hit] = rng.choice(np.asarray([2**40, -2**40], np.int64),
                            size=int(hit.sum()))
    elif sql_type in ("REAL", "DOUBLE"):
        # the NOT NULL column stays finite: sums read it
        x = _floats(rng, n, FLOAT_EDGES + (NAN_EDGES if nullable else ()))
        if sql_type == "REAL":
            x = x.astype(np.float32)
    elif sql_type == "DECIMAL(15,2)":
        x = rng.integers(-10**9, 10**9, size=n, dtype=np.int64)
        hit = rng.random(n) < 0.02
        x[hit] = rng.choice(np.asarray([10**12, -10**12, 0], np.int64),
                            size=int(hit.sum()))
    elif sql_type == "DATE":
        x = _date(rng.integers(1992, 1999, n), rng.integers(1, 13, n),
                  rng.integers(1, 29, n)).astype(np.int32)
    else:
        pool = STRINGS + (LONG_STRINGS if sql_type.startswith("VARCHAR")
                          else ())
        x = np.asarray(pool, dtype=object)[rng.integers(0, len(pool), n)]
    return Col(name + ("_n" if nullable else ""), sql_type, x,
               _nulls(rng, n) if nullable else None)


def _keys(rng, n, dense_lo, dense_domain):
    ids = rng.permutation(n).astype(np.int64)
    uk = np.cumsum(rng.integers(1, 2**22, size=n, dtype=np.int64)) - 2**31
    uk = rng.permutation(uk)
    if n:
        uk[rng.integers(0, n)] = INT64_MAX - 1
    kd = (dense_lo + rng.integers(0, dense_domain, n)).astype(np.int32)
    pool = rng.integers(-2**33, 2**33, size=max(1, n // 4), dtype=np.int64)
    kw = pool[rng.integers(0, len(pool), n)]
    kb = rng.integers(0, 2**22 + 5, size=n).astype(np.int32)
    if n >= 2:
        kb[:2] = (0, 2**22 + 4)
    ks = rng.integers(0, 1000, n).astype(np.int32)
    ks[rng.random(n) < 0.5] = 7
    return [Col("id", "BIGINT", ids), Col("uk", "BIGINT", uk),
            Col("kd", "INT", kd, rng.random(n) >= 0.15),
            Col("kw", "BIGINT", kw), Col("kb", "INT", kb),
            Col("ks", "INT", ks, rng.random(n) >= 0.1),
            Col("kx", "INT", (ids // 3).astype(np.int32))]


def sizes(seed: int) -> Tuple[int, int, int]:
    """The rows of (fa, fb, dm) for a seed. The 70,001-row class runs on
    its first seed only; a later seed of that class takes fa at 8,193 rows
    (past two 4,096-row tiles), which keeps the CPU tests' time in bounds."""
    fa, fb, dm = SIZES[seed % len(SIZES)]
    if fa > 65_536 and seed >= len(SIZES):
        fa = 8193
    return fa, fb, dm


def make_database(seed: int) -> Dict[str, Table]:
    """The three tables of one seed: {name: Table}."""
    rng = np.random.default_rng([seed, 20261018])
    dense_domain = 1 + (seed * 37) % 128
    out = {}
    for name, n in zip(TABLES, sizes(seed)):
        cols = _keys(rng, n, -3 + seed % 5, dense_domain)
        for vname, vtype in VALUE_COLUMNS:
            for nullable in (False, True):
                cols.append(_values(rng, vname, vtype, n, nullable))
        out[name] = Table(name, cols)
    return out


# ---------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------

def port_modules():
    """The port's (catalog, table, column, types) modules, as load_tables
    takes them; a caller passes quickstep_tpu's to load the reference."""
    from quickstep_tpu_torch import catalog, types
    from quickstep_tpu_torch.storage import column, table
    return catalog, table, column, types


def _type(types, sql_type, nullable):
    t = {"INT": types.INT, "BIGINT": types.LONG, "REAL": types.FLOAT,
         "DOUBLE": types.DOUBLE, "DATE": types.DATE}.get(sql_type)
    if t is None:
        if sql_type.startswith("DECIMAL"):
            t = types.Decimal(15, 2)
        elif sql_type.startswith("CHAR"):
            t = types.Char(6)
        else:
            t = types.VarChar(10)
    return t.with_nullable(nullable)


def load_tables(db, tables: Dict[str, Table], modules=None) -> None:
    """Each table into db's catalog and analyzed (exact statistics), as
    utils/testdb.py loads its relation. A relation of that name (the last
    seed's: the schema is the same) takes the new data as a new version,
    so no device copy keyed on (name, version) can serve the old rows:
    quickstep_tpu keeps its copies across DROP TABLE. modules: (catalog,
    table, column, types) of the database's package, the port's by
    default."""
    catalog, table, column, types = modules or port_modules()
    cat = db.catalog.default_database
    for t in tables.values():
        attrs, cols = [], {}
        for c in t.columns:
            typ = _type(types, c.sql_type, c.valid is not None)
            attrs.append(catalog.CatalogAttribute(c.name, typ))
            if typ.is_string:
                vals = list(c.data) if c.valid is None else [
                    s if ok else None for s, ok in zip(c.data, c.valid)]
                cols[c.name] = column.Column.from_values(typ, vals)
            else:
                cols[c.name] = column.Column(
                    typ, np.ascontiguousarray(c.data, typ.device_dtype),
                    None if c.valid is None else c.valid.copy(), None)
        rel = cat.get_relation(t.name)
        if rel is None:
            rel = catalog.CatalogRelation(t.name, attrs)
            cat.add_relation(rel)
        rel.set_data(table.TableData(cols))
        rel.analyze()


# ---------------------------------------------------------------------
# queries
# ---------------------------------------------------------------------

@dataclasses.dataclass
class Query:
    family: str
    sql: str
    # statements run first on both sides (DML), their row counts compared
    setup: Tuple[str, ...] = ()
    ordered: bool = False
    # {result column: (table, column)}: a float SUM or AVG of that
    # column, compared within its sum_bound
    sums: Dict[int, Tuple[str, str]] = dataclasses.field(default_factory=dict)
    # statements run after, to restore the tables
    teardown: Tuple[str, ...] = ()


FAMILIES = ("scalar_agg", "dense_groupby", "sort_groupby", "count_distinct",
            "unique_join", "expansion_join", "semi_anti", "q21_semi",
            "setops", "full_join", "order_by", "window", "expressions",
            "cast", "scalar_subquery", "dml")


def _sum_cols(first, cols, table):
    """sums for SUM/AVG columns starting at result column `first`, over
    `cols` of `table`, each column giving sum then avg."""
    out = {}
    for j, c in enumerate(cols):
        if c.split("_")[0] in ("r", "d"):
            out[first + 2 * j] = out[first + 2 * j + 1] = (table, c)
    return out


def queries(seed: int) -> List[Query]:
    """Every family's queries for one seed's database (the seed picks
    constants only: every family runs on every seed)."""
    rng = np.random.default_rng([seed, 7])
    q: List[Query] = []
    cut = int(rng.integers(-500, 500))
    # a query that returns fa's rows returns every 16th of its 70,001 (the
    # kernels still read them all), else all of them
    big = sizes(seed)[0] > 65_536

    def thin(alias="fa"):
        return f"{alias}.id % 16 = 0" if big else f"{alias}.id >= 0"

    def add(family, sql, **kw):
        q.append(Query(family, " ".join(sql.split()), **kw))

    # -- K1: scalar aggregates, over all rows and over a filter that may
    # keep none
    for where in ("", f" WHERE i < {cut}", " WHERE kd > 1000"):
        cols = ["i", "l_n", "r", "d", "m_n", "i_n", "d_n"]
        body = ", ".join(f"sum({c}), avg({c})" for c in cols
                         if c not in ("d_n",))
        sums = _sum_cols(2, [c for c in cols if c != "d_n"], "fa")
        add("scalar_agg", f"SELECT count(*), count(d_n), {body}, "
            f"min(i), max(l), min(r_n), max(d_n), min(m), max(t_n), "
            f"min(c), max(v_n), min(d), max(r) FROM fa{where}", sums=sums)
    # -- K2: dense GROUP BY over the nullable dense key
    add("dense_groupby", "SELECT kd, count(*), count(i_n), "
        "sum(i), avg(i), sum(l), avg(l), sum(m_n), avg(m_n), sum(d), avg(d), "
        "sum(r), avg(r), min(d_n), max(r_n), min(t), max(m) FROM fa "
        "GROUP BY kd", sums={9: ("fa", "d"), 10: ("fa", "d"),
                             11: ("fa", "r"), 12: ("fa", "r")})
    add("dense_groupby", f"SELECT kd, count(*), sum(l_n), min(i_n), "
        f"max(i_n), sum(d), min(c_n) FROM fb WHERE i > {cut} GROUP BY kd",
        sums={5: ("fb", "d")})
    add("dense_groupby", "SELECT kd, i % 3, count(*), sum(m), max(d) FROM fa "
        "GROUP BY kd, i % 3")
    # -- K5, K9: sort GROUP BY over wide, skewed, string and float keys,
    # every numeric type
    for key, table in (("kw", "fa"), ("ks", "fa"), ("v_n", "fb"),
                       ("d_n", "fa"), ("kw", "fb")):
        add("sort_groupby", f"SELECT {key}, count(*), sum(i), avg(i), "
            f"sum(l), avg(l), sum(m), avg(m), sum(d), avg(d), sum(r), "
            f"avg(r), min(i_n), max(l_n), min(r_n), max(d_n), min(m_n), "
            f"max(t) FROM {table} GROUP BY {key}",
            sums={8: (table, "d"), 9: (table, "d"), 10: (table, "r"),
                  11: (table, "r")})
    add("sort_groupby", "SELECT kw, ks, count(*), sum(l_n), max(c) FROM fa "
        "GROUP BY kw, ks HAVING count(*) > 1")
    # -- K12: COUNT(DISTINCT) of every type, scalar and grouped
    add("count_distinct", "SELECT count(DISTINCT i), count(DISTINCT l_n), "
        "count(DISTINCT r_n), count(DISTINCT d_n), count(DISTINCT m), "
        "count(DISTINCT t_n), count(DISTINCT c), count(DISTINCT v_n), "
        "count(DISTINCT kw) FROM fa")
    add("count_distinct", "SELECT kd, count(DISTINCT d), "
        "count(DISTINCT r_n) FROM fa GROUP BY kd")
    add("count_distinct", "SELECT ks, count(DISTINCT kd) FROM fb "
        "GROUP BY ks")
    # -- K3, K4: unique joins (dm.id dense: the direct table; dm.uk wide:
    # the merge), inner and LEFT with an ON residual
    add("unique_join", "SELECT fa.id, dm.i, dm.v_n, fa.d_n FROM fa JOIN dm "
        f"ON fa.kd = dm.id WHERE {thin()}")
    add("unique_join", "SELECT fa.id, dm.id, dm.c_n FROM fa LEFT JOIN dm "
        f"ON fa.ks = dm.id AND dm.i > fa.i WHERE {thin()}")
    add("unique_join", "SELECT fb.id, dm.l, dm.t_n FROM fb JOIN dm "
        "ON fb.uk = dm.uk")
    add("unique_join", "SELECT fa.id, fb.id, fb.m_n FROM fa LEFT JOIN fb "
        f"ON fa.uk = fb.uk AND fb.d_n <> fa.d WHERE {thin()}")
    add("unique_join", "SELECT dm.kd, count(*), sum(fa.l), max(fa.v) "
        "FROM fa JOIN dm ON fa.id = dm.id GROUP BY dm.kd")
    # -- K7: expansion joins on duplicate build keys (kx repeats)
    add("expansion_join", "SELECT fa.kd, count(*), sum(dm.i), min(dm.v), "
        "max(fa.l_n) FROM fa JOIN dm ON fa.kx = dm.kx GROUP BY fa.kd")
    add("expansion_join", "SELECT fb.id, dm.id, dm.d_n FROM fb LEFT JOIN dm "
        "ON fb.kx = dm.kx AND dm.i < fb.i WHERE fb.id < 300")
    add("expansion_join", "SELECT fa.ks, count(*), count(dm.id), "
        "sum(dm.l) FROM fa LEFT JOIN dm ON fa.kx = dm.kx AND dm.m > fa.m "
        "GROUP BY fa.ks")
    add("expansion_join", "SELECT fb.kx, fa.id, fa.v_n FROM fb JOIN fa "
        "ON fa.kx = fb.kx WHERE fb.kd < 3")
    # two keys whose spans multiply past 2^62: hashed (K10), each
    # candidate verified
    add("expansion_join", "SELECT fb.kd, count(*), sum(f2.i), max(f2.v) "
        "FROM fb JOIN fb AS f2 ON fb.l = f2.l AND fb.kw = f2.kw "
        "GROUP BY fb.kd")
    # -- the exact filter: IN, EXISTS, NOT IN with NULLs on both sides,
    # NOT EXISTS
    add("semi_anti", "SELECT id, kd FROM fa WHERE kd IN (SELECT kd FROM dm) "
        f"AND {thin()}")
    add("semi_anti", "SELECT id FROM fb WHERE kd NOT IN (SELECT kd FROM dm)")
    add("semi_anti", "SELECT id FROM fb WHERE ks NOT IN (SELECT ks FROM dm "
        f"WHERE i > {cut})")
    add("semi_anti", "SELECT id, v_n FROM fa WHERE EXISTS (SELECT * FROM dm "
        "WHERE dm.kb = fa.kb)")
    add("semi_anti", "SELECT count(*), sum(l) FROM fa WHERE NOT EXISTS "
        "(SELECT * FROM fb WHERE fb.kw = fa.kw)")
    add("semi_anti", "SELECT id FROM dm WHERE v NOT IN (SELECT v_n FROM fb)")
    # -- K8: correlated <> and < semi joins of Q21's shape
    add("q21_semi", "SELECT id, ks FROM fa WHERE EXISTS (SELECT * FROM fb "
        f"WHERE fb.ks = fa.ks AND fb.id <> fa.id) AND {thin()}")
    add("q21_semi", "SELECT count(*), sum(i) FROM fa WHERE NOT EXISTS "
        "(SELECT * FROM fb WHERE fb.kd = fa.kd AND fb.id <> fa.id)")
    add("q21_semi", "SELECT id FROM fb WHERE EXISTS (SELECT * FROM fa "
        "WHERE fa.ks = fb.ks AND fa.i < fb.i) AND NOT EXISTS (SELECT * "
        "FROM dm WHERE dm.ks = fb.ks AND dm.id <> fb.id)")
    # -- K10, K11: set operations
    for op in ("UNION", "INTERSECT", "EXCEPT", "UNION ALL"):
        add("setops", f"SELECT kd, v_n FROM fa {op} SELECT kd, v FROM fb")
    add("setops", "SELECT i_n, c FROM fb INTERSECT SELECT i, c_n FROM dm")
    add("setops", f"SELECT kw FROM fa WHERE {thin()} EXCEPT SELECT kw "
        "FROM fb")
    add("setops", f"SELECT d_n FROM fa WHERE {thin()} UNION SELECT d FROM dm")
    # -- the full outer join
    add("full_join", "SELECT fb.id, dm.id, dm.i FROM fb FULL JOIN dm "
        "ON fb.kd = dm.id")
    add("full_join", "SELECT count(*), count(fb.id), count(dm.id) FROM fb "
        "FULL JOIN dm ON fb.kx = dm.kx AND dm.i > fb.i")
    add("full_join", "SELECT fa.id, fb.id, fa.v, fb.d_n FROM fa FULL JOIN "
        f"fb ON fa.uk = fb.uk WHERE {thin()} OR fa.id IS NULL")
    # -- K13 and the host sort: ORDER BY nullable floats with NaN, both
    # directions and NULL placements, with LIMIT (K13) and without (the
    # host sort); id breaks ties, so the order is total
    lim = int(rng.integers(1, 40))
    for (col, table), (first, second) in zip(
            (("d_n", "fa"), ("r_n", "fb"), ("d_n", "dm")),
            ((("ASC", "FIRST"), ("DESC", "LAST")),
             (("DESC", "FIRST"), ("ASC", "LAST")),
             (("ASC", "LAST"), ("DESC", "FIRST")))):
        add("order_by", f"SELECT {col}, id FROM {table} ORDER BY {col} "
            f"{first[0]} NULLS {first[1]}, id LIMIT {lim}", ordered=True)
        add("order_by", f"SELECT id, {col}, kd FROM {table} WHERE "
            f"{thin(table)} ORDER BY {col} {second[0]} NULLS {second[1]}, "
            "kd, id", ordered=True)
    add("order_by", "SELECT v_n, t, id FROM fa ORDER BY v_n, t DESC, id "
        f"LIMIT {3 * lim}", ordered=True)
    add("order_by", "SELECT m_n, c, id FROM fb ORDER BY m_n DESC NULLS "
        "FIRST, c, id", ordered=True)
    # -- W1-W4: window functions, ROWS and RANGE frames
    add("window", "SELECT id, sum(d) OVER (PARTITION BY kd ORDER BY id), "
        "count(*) OVER (PARTITION BY kd ORDER BY id), "
        "avg(r) OVER (PARTITION BY kd ORDER BY id) FROM fb",
        sums={1: ("fb", "d"), 3: ("fb", "r")})
    # (fa's windows read every row; the outer filter thins what returns)
    add("window", "SELECT * FROM (SELECT id, sum(l) OVER (PARTITION BY ks) "
        "AS s, min(d_n) OVER (PARTITION BY ks) AS lo, max(i_n) OVER "
        f"(PARTITION BY ks) AS hi FROM fa) t WHERE {thin('t')}")
    add("window", "SELECT id, sum(d) OVER (PARTITION BY kd ORDER BY id "
        "ROWS BETWEEN 3 PRECEDING AND 1 FOLLOWING), max(r_n) OVER "
        "(PARTITION BY kd ORDER BY id ROWS BETWEEN 2 PRECEDING AND CURRENT "
        "ROW), min(i) OVER (PARTITION BY kd ORDER BY id ROWS BETWEEN 1 "
        "PRECEDING AND 4 FOLLOWING), avg(m) OVER (PARTITION BY kd ORDER BY "
        "id ROWS BETWEEN 5 PRECEDING AND CURRENT ROW) FROM fb",
        sums={1: ("fb", "d")})
    add("window", "SELECT * FROM (SELECT id, count(l_n) OVER (PARTITION BY "
        "ks ORDER BY i RANGE BETWEEN 50 PRECEDING AND 50 FOLLOWING) AS n, "
        "min(d) OVER (PARTITION BY ks ORDER BY i RANGE BETWEEN 10 PRECEDING "
        "AND CURRENT ROW) AS lo, sum(l) OVER (PARTITION BY ks ORDER BY i "
        "DESC RANGE BETWEEN 20 PRECEDING AND 5 FOLLOWING) AS s FROM fa) t "
        f"WHERE {thin('t')}")
    add("window", "SELECT id, max(m) OVER (ORDER BY t RANGE BETWEEN 40 "
        "PRECEDING AND 40 FOLLOWING), sum(i) OVER (ORDER BY id ROWS BETWEEN "
        "UNBOUNDED PRECEDING AND CURRENT ROW) FROM dm")
    # -- expressions: CASE, LIKE, IN lists, dates, EXTRACT, DECIMAL
    # arithmetic
    add("expressions", "SELECT id, CASE WHEN i < 0 THEN 'neg' WHEN i = 0 "
        "THEN 'zero' ELSE 'pos' END, CASE WHEN d_n > 0 THEN d_n ELSE -1.5 "
        "END, CASE kd WHEN 1 THEN l ELSE l_n END FROM fb")
    add("expressions", "SELECT id, v, c_n FROM fa WHERE (v LIKE 'a%' OR "
        f"c_n LIKE '%b_' OR v_n LIKE '') AND {thin()}")
    add("expressions", "SELECT id FROM fb WHERE v_n IN ('a', 'zz', '') OR "
        "i IN (0, 1, -1, 2147483647) OR c NOT IN ('ab', 'x y')")
    add("expressions", "SELECT id, t + INTERVAL '3' MONTH, t_n - INTERVAL "
        "'10' DAY, EXTRACT(YEAR FROM t), EXTRACT(MONTH FROM t_n), "
        "EXTRACT(DAY FROM t) FROM dm WHERE t < DATE '1995-06-01'")
    add("expressions", "SELECT id, m + m_n, m - 1.25, m * 3, m_n / 7, "
        "m * m_n, -m FROM fb WHERE id < 500", sums={})
    add("expressions", "SELECT id, i + l, i * 3 - l_n, l / 7, i % 5, "
        "r * 2 + d, d_n / 3, -r_n FROM dm")
    # -- CAST between every pair of numeric types, and the float ->
    # integer edges
    for src in ("i", "l_n", "r_n", "d_n", "m"):
        casts = ", ".join(f"CAST({src} AS {t})" for t in
                          ("INT", "BIGINT", "REAL", "DOUBLE", "DECIMAL(15,2)"))
        add("cast", f"SELECT id, {casts} FROM fa WHERE {thin()}")
    add("cast", "SELECT id, CAST(d AS INT), CAST(r AS BIGINT), "
        "CAST(d * 1e10 AS BIGINT), CAST(d * 1e10 AS DECIMAL(15,2)) FROM dm")
    # -- scalar subqueries
    add("scalar_subquery", "SELECT id FROM fa WHERE i > (SELECT avg(i) "
        f"FROM fb) AND {thin()}")
    add("scalar_subquery", "SELECT id, (SELECT max(l) FROM dm) FROM fb "
        f"WHERE kd < 5")
    add("scalar_subquery", "SELECT count(*) FROM fb WHERE d_n < (SELECT "
        "min(d) FROM dm)")
    # -- DML: INSERT ... SELECT, UPDATE and DELETE on a copy, then SELECT
    # (a name of its own each: quickstep_tpu would serve a dropped
    # table's device copy to a new table of the same name)
    w1, w2 = f"w{seed}_1", f"w{seed}_2"
    add("dml", f"SELECT count(*), sum(i), sum(l_n), min(v), max(c_n), "
        f"count(d_n), sum(m) FROM {w1}", setup=(
            f"CREATE TABLE {w1} (id BIGINT, i INT, l_n BIGINT, d_n DOUBLE, "
            "m DECIMAL(15,2), c_n CHAR(6), v VARCHAR(10))",
            f"INSERT INTO {w1} SELECT id, i, l_n, d_n, m, c_n, v FROM fb",
            f"UPDATE {w1} SET i = i + 1, d_n = -d_n WHERE i < {cut}",
            f"DELETE FROM {w1} WHERE l_n > 0 OR id = 3"),
        teardown=(f"DROP TABLE {w1}",))
    add("dml", f"SELECT id, i, v, d_n FROM {w2}", setup=(
        f"CREATE TABLE {w2} (id BIGINT, i INT, v VARCHAR(10), d_n DOUBLE)",
        f"INSERT INTO {w2} SELECT id, i, v, d_n FROM dm WHERE kd IS NULL "
        "OR id < 900",
        f"UPDATE {w2} SET d_n = d_n * 2 WHERE v LIKE 'a%'",
        f"DELETE FROM {w2} WHERE i > 0"), teardown=(f"DROP TABLE {w2}",))
    return q


def cast_tables() -> Dict[str, Table]:
    """One table, casts: id, and CAST_VALUES as DOUBLE b and as REAL r."""
    x = np.asarray(CAST_VALUES, np.float64)
    return {"casts": Table("casts", [
        Col("id", "INT", np.arange(len(x), dtype=np.int32)),
        Col("b", "DOUBLE", x), Col("r", "REAL", x.astype(np.float32))])}


# CAST of each float column to each integer target, a row a value
CAST_QUERIES = {(src, dst): Query(
    "cast_edges", f"SELECT id, {src}, CAST({src} AS {dst}) FROM casts "
    f"ORDER BY id", ordered=True)
    for src in ("b", "r") for dst in ("INT", "BIGINT", "DECIMAL(15,2)")}


def rotation(seed: int, battery: Sequence[Query]) -> List[Query]:
    """One query of each family: the query at (seed + 3 * (seed //
    len(SIZES))) modulo the family's count, so that over SEEDS each query
    runs on two size classes. The CPU tests run this share (each of
    quickstep_tpu's queries compiles anew, about 0.7 s); chip_smoke.py's
    phase 2d runs every query."""
    by_family: Dict[str, List[Query]] = {}
    for query in battery:
        by_family.setdefault(query.family, []).append(query)
    turn = seed + 3 * (seed // len(SIZES))
    return [qs[turn % len(qs)] for qs in by_family.values()]


def load_sqlite(conn, tables: Dict[str, Table]) -> None:
    """The tables into a sqlite connection, for the shapes where
    quickstep_tpu raises or errs: DATE as its ISO text, DECIMAL as its value, NaN
    as NULL (sqlite has no NaN); LIKE made case-sensitive."""
    conn.execute("PRAGMA case_sensitive_like = ON")
    for t in tables.values():
        conn.execute(f"DROP TABLE IF EXISTS {t.name}")
        conn.execute(f"CREATE TABLE {t.name} (" + ", ".join(
            f"{c.name} {c.sql_type}" for c in t.columns) + ")")
        cols = []
        for c in t.columns:
            if c.sql_type == "DATE":
                vals = [f"{x >> 9:04d}-{(x >> 5) & 15:02d}-{x & 31:02d}"
                        for x in c.data.tolist()]
            elif c.sql_type.startswith("DECIMAL"):
                vals = [x / 100 for x in c.data.tolist()]
            else:
                vals = [None if isinstance(x, float) and x != x else x
                        for x in c.data.tolist()]
            if c.valid is not None:
                vals = [x if ok else None
                        for x, ok in zip(vals, c.valid.tolist())]
            cols.append(vals)
        conn.executemany(
            f"INSERT INTO {t.name} VALUES ({', '.join('?' * len(cols))})",
            list(zip(*cols)))


# ---------------------------------------------------------------------
# running and comparing
# ---------------------------------------------------------------------

def run_query(db, query: Query):
    """(row counts of the setup statements, result rows as tuples); the
    teardown runs whatever happens."""
    try:
        counts = [db.execute(s).rows_affected for s in query.setup]
        return counts, [tuple(r) for r in db.execute(query.sql).rows]
    finally:
        for s in query.teardown:
            db.execute(s)


def _sort_key(row):
    return tuple((v is None, isinstance(v, float) and v != v,
                  0 if v is None or (isinstance(v, float) and v != v)
                  else v) for v in row)


EPS = {"REAL": 2.0 ** -24, "DOUBLE": 2.0 ** -53}


def sum_bound(tables: Dict[str, Table], table: str, column: str,
              accumulate: Optional[str] = None) -> float:
    """A float SUM's worst case over a column of m live values whose
    magnitudes sum to S, in any order of association and as a difference
    of two prefix sums, against another such sum: (2 eps + 2 (m - 1)
    eps_acc) * S, eps the column type's unit roundoff (two roundings to
    it) and eps_acc that of the type it accumulates in (accumulate:
    "DOUBLE", or the column's own type where None, as quickstep_tpu's
    float32 sums do)."""
    col = tables[table].column(column)
    x = np.asarray(col.data, np.float64)
    if col.valid is not None:
        x = x[col.valid]
    x = x[np.isfinite(x)]
    s = float(np.abs(x).sum())
    acc = EPS[accumulate or col.sql_type]
    return 2 * (EPS[col.sql_type] + max(len(x) - 1, 0) * acc) * s


def same_rows(ours, want, query: Query, tables: Dict[str, Table],
              rel=1e-8, abs_tol=1e-6, accumulate=None) -> Optional[str]:
    """None where the two results agree, else what differs. Rows compare
    as multisets (as sequences under `ordered`); integers, strings, dates
    and NULL exactly, floats within rel (and abs_tol), a column of
    query.sums also within its sum_bound (accumulate as there), NaN equal
    to NaN."""
    ours, want = list(ours), list(want)
    if len(ours) != len(want):
        return f"{len(ours)} rows against {len(want)}"
    if not query.ordered:
        ours, want = sorted(ours, key=_sort_key), sorted(want, key=_sort_key)
    bounds = {j: sum_bound(tables, *tc, accumulate)
              for j, tc in query.sums.items()}
    for n, (a, b) in enumerate(zip(ours, want)):
        if len(a) != len(b):
            return f"row {n}: {a} against {b}"
        for j, (x, y) in enumerate(zip(a, b)):
            if not _value_eq(x, y, rel, abs_tol + bounds.get(j, 0.0)):
                return f"row {n} column {j}: {a} against {b}"
    return None


def _value_eq(x, y, rel, abs_tol):
    if isinstance(x, float) or isinstance(y, float):
        if x is None or y is None:
            return False
        x, y = float(x), float(y)
        if math.isnan(x) or math.isnan(y):
            return math.isnan(x) and math.isnan(y)
        if math.isinf(x) or math.isinf(y):
            return x == y
        return math.isclose(x, y, rel_tol=rel, abs_tol=abs_tol)
    return x == y


def identical_rows(ours, want) -> Optional[str]:
    """None where the two results are the same rows in the same order, bit
    for bit (NaN equal to NaN, -0.0 apart from 0.0), else the first
    difference."""
    if len(ours) != len(want):
        return f"{len(ours)} rows against {len(want)}"
    for n, (a, b) in enumerate(zip(ours, want)):
        if not _same_bits(a, b):
            return f"row {n}: {a} against {b}"
    return None


def _same_bits(a, b):
    a, b = tuple(a), tuple(b)
    if a == b:
        # == holds -0.0 equal to 0.0
        return all(not isinstance(x, float) or x != 0.0 or
                   math.copysign(1.0, x) == math.copysign(1.0, y)
                   for x, y in zip(a, b))
    return len(a) == len(b) and all(_bits(x) == _bits(y)
                                    for x, y in zip(a, b))


def mesh_difference(ours, want, query: Query,
                    tables: Dict[str, Table]) -> Optional[str]:
    """None where a mesh's (setup counts, rows) are one device's: counts
    equal, rows identical_rows (sorted first where the query does not
    order) but in query.sums' columns, which same_rows holds within their
    sum_bound with float64 accumulation (the mesh folds each shard's
    partial sum in shard order); else what differs."""
    (ca, ra), (cb, rb) = ours, want
    if ca != cb:
        return f"setup counts {ca} against {cb}"
    if not query.ordered:
        ra, rb = sorted(ra, key=_sort_key), sorted(rb, key=_sort_key)
    keep = [j for j in range(len(ra[0]) if ra else 0)
            if j not in query.sums]
    why = identical_rows([[r[j] for j in keep] for r in ra],
                         [[r[j] for j in keep] for r in rb])
    return why or same_rows(ra, rb, dataclasses.replace(query, ordered=True),
                            tables, accumulate="DOUBLE")


def _bits(v):
    if isinstance(v, float):
        return ("f", np.float64(v).view(np.int64).item()
                if v == v else "nan")
    return (type(v).__name__, v)
