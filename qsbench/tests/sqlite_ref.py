"""The generated tables in sqlite, and the 22 queries in its dialect: the
reference's second witness in the tests. A copy of quickstep_tpu_torch/
bench/tpch.py's `to_sqlite_sql` and of its Q13 override (sqlite takes no
column list on a derived table)."""

import re
import sqlite3

from qsbench.gen import SCHEMAS, Tables, iso_of_code

Q13 = """
select c_count, count(*) as custdist
from (
  select c_custkey, count(o_orderkey) as c_count
  from customer left outer join orders on c_custkey = o_custkey
    and o_comment not like '%special%requests%'
  group by c_custkey
) as c_orders
group by c_count
order by custdist desc, c_count desc
"""


def connect(tables: Tables) -> sqlite3.Connection:
    conn = sqlite3.connect(":memory:")
    for name, schema in SCHEMAS.items():
        cols, values = [], []
        for c, typ in schema:
            x = tables.columns[name][c].tolist()
            words = tables.vocab[name].get(c)
            if words:
                cols.append(f"{c} TEXT")
                values.append([words[i] for i in x])
            elif typ == "DATE":
                cols.append(f"{c} TEXT")
                values.append([iso_of_code(i) for i in x])
            elif typ.startswith("DECIMAL"):
                cols.append(f"{c} REAL")
                values.append([i / 100 for i in x])
            else:
                cols.append(f"{c} INTEGER")
                values.append(x)
        conn.execute(f"CREATE TABLE {name} ({', '.join(cols)})")
        conn.executemany(
            f"INSERT INTO {name} VALUES ({', '.join('?' * len(cols))})",
            list(zip(*values)))
    # correlated subqueries run as nested loops in sqlite: key indexes make
    # them fast and change no answer
    for table, col in (("lineitem", "l_orderkey"), ("lineitem", "l_partkey"),
                       ("part", "p_partkey"), ("partsupp", "ps_partkey"),
                       ("orders", "o_custkey")):
        conn.execute(f"create index {col}_idx on {table}({col})")
    conn.commit()
    return conn


def _days_in_month(y, m):
    import calendar
    return calendar.monthrange(y, m)[1]


def _add(iso, sign, qty, unit):
    import datetime as dt
    y, m, d = map(int, iso.split("-"))
    if unit.startswith("year") or unit.startswith("month"):
        months = qty * (12 if unit.startswith("year") else 1) * sign
        t = y * 12 + (m - 1) + months
        y, m = divmod(t, 12)
        m += 1
        d = min(d, _days_in_month(y, m))
        return f"{y:04d}-{m:02d}-{d:02d}"
    return (dt.date(y, m, d) + dt.timedelta(days=sign * qty)).isoformat()


def to_sqlite_sql(sql: str) -> str:
    """Date literals and intervals folded to ISO strings, extract(year) to
    strftime, substring to substr."""
    out = re.sub(
        r"date\s+'(\d{4}-\d{2}-\d{2})'\s*([+-])\s*interval\s+'(\d+)'\s+(\w+)",
        lambda m: "'" + _add(m.group(1), 1 if m.group(2) == "+" else -1,
                             int(m.group(3)), m.group(4).lower()) + "'",
        sql, flags=re.IGNORECASE)
    out = re.sub(r"date\s+'(\d{4}-\d{2}-\d{2})'", r"'\1'", out,
                 flags=re.IGNORECASE)
    out = re.sub(r"extract\s*\(\s*year\s+from\s+([a-z_0-9.]+)\s*\)",
                 r"CAST(strftime('%Y', \1) AS INTEGER)", out,
                 flags=re.IGNORECASE)
    out = re.sub(
        r"substring\s*\(\s*([a-z_0-9.]+)\s+from\s+(\d+)\s+for\s+(\d+)\s*\)",
        r"substr(\1, \2, \3)", out, flags=re.IGNORECASE)
    return out
