"""The plain reference: the answers of TPC-H's 22 queries (as frozen in
qsbench/queries/tpch-sf10.json) worked out again from the generated columns and
their vocabularies with plain PyTorch on any device.

A frozen copy of the exact oracles of quickstep_tpu_torch/bench/
tpch_fullgen.py (`generate`'s and `extra_oracles`), rewritten over the
columns alone: no generator state, keys looked up through maps built from
the key columns. DECIMAL values stay in their scaled integers and every
sum is exact (split into 30-bit halves, summed as Python integers), so a
float in an answer is an exact quotient rounded once. Where the engine
compares a computed DOUBLE (Q17, Q22) the same float64 operations decide
here. Answers have the engine's row form: dates as ISO strings, DECIMAL
and DOUBLE results as floats.

With `exact=False` the same arithmetic runs in float32 (values, products,
sums and the comparisons made of them): the control, one precision below
the float64 of the configuration's DOUBLE results, which the comparison
must refuse.

It answers only the texts it was written for: each query's SQL is held to
the SHA-256 of its frozen text (`TEXTS`), where Q11's FRACTION, the one
substitution parameter that the specification sets by the scale factor,
stands as a placeholder and is read from the SQL. Any other text raises.

This module imports neither jax, quickstep_tpu nor quickstep_tpu_torch.
"""

from __future__ import annotations

import hashlib
import re
from typing import Dict, List

import torch

from qsbench.gen import Tables, date_code, iso_of_code

INT64_MAX = torch.iinfo(torch.int64).max


class _Arith:
    """Exact integer arithmetic, or float32 for the control."""

    def __init__(self, exact: bool):
        self.exact = exact

    def val(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.int64 if self.exact else torch.float32)

    def sum(self, x: torch.Tensor):
        """The sum of x: a Python int (exact), or the float32 sum."""
        if not self.exact:
            return float(x.to(torch.float32).sum())
        x = x.to(torch.int64)
        lo = int((x % (1 << 30)).sum())
        hi = int((x // (1 << 30)).sum())
        return hi * (1 << 30) + lo

    def group_sum(self, idx: torch.Tensor, x: torch.Tensor,
                  n: int) -> torch.Tensor:
        """Sums of x by group idx in [0, n): int64 (every group's sum in
        these queries is far below 2^63 at SF10) or float32."""
        x = self.val(x)
        out = torch.zeros(n, dtype=x.dtype, device=x.device)
        return out.index_add_(0, idx, x)

    def num(self, v):
        return v if isinstance(v, (int, float)) else v.item()


class _Ref:
    """The tables on one device, with key maps and vocabulary helpers."""

    def __init__(self, tables: Tables, exact: bool):
        self.c = tables.columns
        self.v = tables.vocab
        self.a = _Arith(exact)
        self.dev = next(iter(self.c["lineitem"].values())).device
        self._maps = {}
        li = self.c["lineitem"]
        self.orow = self.index("orders", "o_orderkey")[li["l_orderkey"]]
        self.srow = self.index("supplier", "s_suppkey")[li["l_suppkey"]]
        self.prow = self.index("part", "p_partkey")[li["l_partkey"]]
        self.crow_o = self.index("customer", "c_custkey")[
            self.c["orders"]["o_custkey"]]
        self.rev4 = self.a.val(li["l_extendedprice"]) * (
            100 - self.a.val(li["l_discount"]))

    def index(self, table: str, key: str) -> torch.Tensor:
        """map[k] = the row of `table` whose `key` is k (-1 where none)."""
        if (table, key) not in self._maps:
            k = self.c[table][key].to(torch.int64)
            m = torch.full((int(k.max()) + 1,), -1, dtype=torch.int64,
                           device=self.dev)
            m[k] = torch.arange(len(k), device=self.dev)
            self._maps[table, key] = m
        return self._maps[table, key]

    def code(self, table: str, col: str, value: str) -> int:
        return self.v[table][col].index(value)

    def mask(self, table: str, col: str, pred) -> torch.Tensor:
        """bool per code of a string column: pred(string)."""
        return torch.tensor([bool(pred(s)) for s in self.v[table][col]],
                            dtype=torch.bool, device=self.dev)

    def word(self, table: str, col: str, row: int) -> str:
        return self.v[table][col][int(self.c[table][col][row])]

    def nation_key(self, name: str) -> int:
        n = self.c["nation"]
        row = int(torch.nonzero(n["n_name"] == self.code(
            "nation", "n_name", name))[0])
        return int(n["n_nationkey"][row])

    def nation_name(self, key: int) -> str:
        return self.word("nation", "n_name",
                         int(self.index("nation", "n_nationkey")[key]))

    def region_nations(self, region: str) -> torch.Tensor:
        """bool per nation key: the nation lies in `region`."""
        r = self.c["region"]
        rk = int(r["r_regionkey"][int(torch.nonzero(
            r["r_name"] == self.code("region", "r_name", region))[0])])
        n = self.c["nation"]
        out = torch.zeros(int(n["n_nationkey"].max()) + 1, dtype=torch.bool,
                          device=self.dev)
        out[n["n_nationkey"].to(torch.int64)] = n["n_regionkey"] == rk
        return out

    def supp_nation(self) -> torch.Tensor:
        """The nation key of each line's supplier."""
        return self.c["supplier"]["s_nationkey"][self.srow].to(torch.int64)

    def cust_nation(self) -> torch.Tensor:
        """The nation key of each line's order's customer."""
        return self.c["customer"]["c_nationkey"][
            self.crow_o[self.orow]].to(torch.int64)

    def ps_rows(self, lines: torch.Tensor):
        """For lines (indices into lineitem), [(line positions, partsupp
        rows)] of every partsupp row with the line's (partkey, suppkey)."""
        ps, li = self.c["partsupp"], self.c["lineitem"]
        span = int(max(ps["ps_suppkey"].max(), li["l_suppkey"].max())) + 1
        key = ps["ps_partkey"].to(torch.int64) * span + ps["ps_suppkey"]
        skey, order = torch.sort(key)
        lk = li["l_partkey"][lines].to(torch.int64) * span + \
            li["l_suppkey"][lines]
        left = torch.searchsorted(skey, lk, side="left")
        count = torch.searchsorted(skey, lk, side="right") - left
        out = []
        for j in range(int(count.max()) if len(count) else 0):
            at = torch.nonzero(count > j).flatten()
            out.append((at, order[left[at] + j]))
        return out

    def top(self, values: torch.Tensor, k: int, largest=True):
        """Indices whose value ties or beats the k-th best (a superset of
        the top k, to be ordered in full by the caller)."""
        if len(values) <= k:
            return torch.arange(len(values), device=self.dev)
        kth = torch.topk(values, k, largest=largest).values[-1]
        return torch.nonzero(values >= kth if largest
                             else values <= kth).flatten()


def _between(x, lo, hi):
    """lo <= x < hi for ISO dates lo and hi."""
    return (x >= date_code(lo)) & (x < date_code(hi))


def q1(r: _Ref):
    li, a = r.c["lineitem"], r.a
    m = li["l_shipdate"] <= date_code("1998-09-02")
    grp = li["l_returnflag"].to(torch.int64) * 2 + li["l_linestatus"]
    extp, disc = a.val(li["l_extendedprice"]), a.val(li["l_discount"])
    charge = r.rev4 * (100 + a.val(li["l_tax"]))
    rows = []
    for g in torch.unique(grp[m]).tolist():
        mm = m & (grp == g)
        n = int(mm.sum())
        sq, sp = a.sum(li["l_quantity"][mm]), a.sum(extp[mm])
        sd4, sc6 = a.sum(r.rev4[mm]), a.sum(charge[mm])
        sdisc = a.sum(disc[mm])
        rows.append([r.v["lineitem"]["l_returnflag"][g // 2],
                     r.v["lineitem"]["l_linestatus"][g % 2],
                     sq / 100, sp / 100, sd4 / 10000, sc6 / 1000000,
                     sq / 100 / n, sp / 100 / n, sdisc / 100 / n, n])
    return rows


def q2(r: _Ref):
    part, ps, supp = r.c["part"], r.c["partsupp"], r.c["supplier"]
    europe = r.region_nations("EUROPE")
    s_eu = europe[supp["s_nationkey"].to(torch.int64)]
    sk_row = r.index("supplier", "s_suppkey")[ps["ps_suppkey"]]
    pk_row = r.index("part", "p_partkey")[ps["ps_partkey"]]
    eu = s_eu[sk_row]
    cost = r.a.val(ps["ps_supplycost"])
    big = INT64_MAX if r.a.exact else float("inf")
    min_cost = torch.full((len(part["p_partkey"]),), big, dtype=cost.dtype,
                          device=r.dev)
    min_cost.scatter_reduce_(0, pk_row[eu], cost[eu], "amin")
    brass = r.mask("part", "p_type", lambda s: s.endswith("BRASS"))
    part_ok = (part["p_size"] == 15) & brass[part["p_type"]]
    hit = torch.nonzero(part_ok[pk_row] & eu &
                        (cost == min_cost[pk_row])).flatten().tolist()
    rows = []
    for i in hit:
        s, p = int(sk_row[i]), int(pk_row[i])
        rows.append([r.a.num(r.a.val(supp["s_acctbal"][s])),
                     r.word("supplier", "s_name", s),
                     r.nation_name(int(supp["s_nationkey"][s])),
                     int(part["p_partkey"][p]),
                     r.word("part", "p_mfgr", p),
                     r.word("supplier", "s_address", s),
                     r.word("supplier", "s_phone", s),
                     r.word("supplier", "s_comment", s)])
    rows.sort(key=lambda x: (-x[0], x[2], x[1], x[3], x[5], x[6]))
    return [[x[0] / 100] + x[1:] for x in rows[:100]]


def q3(r: _Ref):
    li, o, c = r.c["lineitem"], r.c["orders"], r.c["customer"]
    building = r.code("customer", "c_mktsegment", "BUILDING")
    d = date_code("1995-03-15")
    o_ok = (c["c_mktsegment"][r.crow_o] == building) & (o["o_orderdate"] < d)
    ml = o_ok[r.orow] & (li["l_shipdate"] > d)
    n_o = len(o["o_orderkey"])
    rev = r.a.group_sum(r.orow[ml], r.rev4[ml], n_o)
    has = torch.bincount(r.orow[ml], minlength=n_o) > 0
    cand = torch.nonzero(has).flatten()
    cand = cand[r.top(rev[cand], 10)].tolist()
    rows = [(r.a.num(rev[i]), int(o["o_orderdate"][i]),
             int(o["o_orderkey"][i]), int(o["o_shippriority"][i]))
            for i in cand]
    rows.sort(key=lambda x: (-x[0], x[1], x[2]))
    return [[k, v / 10000, iso_of_code(dd), sp] for v, dd, k, sp in rows[:10]]


def q4(r: _Ref):
    li, o = r.c["lineitem"], r.c["orders"]
    late = li["l_commitdate"] < li["l_receiptdate"]
    has = torch.zeros(len(o["o_orderkey"]), dtype=torch.bool, device=r.dev)
    has[r.orow[late]] = True
    m = _between(o["o_orderdate"], "1993-07-01", "1993-10-01") & has
    counts = torch.bincount(o["o_orderpriority"][m].to(torch.int64),
                            minlength=len(r.v["orders"]["o_orderpriority"]))
    return [[r.v["orders"]["o_orderpriority"][i], n]
            for i, n in enumerate(counts.tolist()) if n > 0]


def q5(r: _Ref):
    o = r.c["orders"]
    s_nat, c_nat = r.supp_nation(), r.cust_nation()
    asia = r.region_nations("ASIA")
    m = _between(o["o_orderdate"], "1994-01-01", "1995-01-01")[r.orow] & \
        (c_nat == s_nat) & asia[s_nat]
    n = len(asia)
    rev = r.a.group_sum(s_nat[m], r.rev4[m], n)
    count = torch.bincount(s_nat[m], minlength=n)
    rows = [(r.nation_name(k), r.a.num(rev[k])) for k in range(n)
            if count[k] > 0]
    rows.sort(key=lambda x: (-x[1], x[0]))
    return [[name, v / 10000] for name, v in rows]


def q6(r: _Ref):
    li = r.c["lineitem"]
    disc, qty = li["l_discount"], li["l_quantity"]
    m = _between(li["l_shipdate"], "1994-01-01", "1995-01-01") & \
        (disc >= 5) & (disc <= 7) & (qty < 2400)
    if not bool(m.any()):
        return [[None]]
    return [[r.a.sum(r.a.val(li["l_extendedprice"][m]) *
                     r.a.val(disc[m])) / 10000]]


def q7(r: _Ref):
    li = r.c["lineitem"]
    ship = li["l_shipdate"]
    s_nat, c_nat = r.supp_nation(), r.cust_nation()
    fr, de = r.nation_key("FRANCE"), r.nation_key("GERMANY")
    m7 = (ship >= date_code("1995-01-01")) & (ship <= date_code("1996-12-31"))
    year = ship.to(torch.int64) >> 9
    rows = []
    for sn, cn in ((fr, de), (de, fr)):
        for y in (1995, 1996):
            m = m7 & (s_nat == sn) & (c_nat == cn) & (year == y)
            if bool(m.any()):
                rows.append([r.nation_name(sn), r.nation_name(cn), y,
                             r.a.sum(r.rev4[m]) / 10000])
    rows.sort(key=lambda x: (x[0], x[1], x[2]))
    return rows


def q8(r: _Ref):
    li, o, part = r.c["lineitem"], r.c["orders"], r.c["part"]
    steel = r.code("part", "p_type", "ECONOMY ANODIZED STEEL")
    america = r.region_nations("AMERICA")
    brazil = r.nation_key("BRAZIL")
    odate = o["o_orderdate"][r.orow]
    m = (part["p_type"][r.prow] == steel) & \
        (odate >= date_code("1995-01-01")) & \
        (odate <= date_code("1996-12-31")) & america[r.cust_nation()]
    year = odate.to(torch.int64) >> 9
    s_nat = r.supp_nation()
    rows = []
    for y in torch.unique(year[m]).tolist():
        my = m & (year == y)
        rows.append([y, r.a.sum(r.rev4[my & (s_nat == brazil)]) /
                     r.a.sum(r.rev4[my])])
    return rows


def q9(r: _Ref):
    li, ps, o = r.c["lineitem"], r.c["partsupp"], r.c["orders"]
    green = r.mask("part", "p_name", lambda s: "green" in s)
    lines = torch.nonzero(
        green[r.c["part"]["p_name"][r.prow]]).flatten()
    nat = r.supp_nation()[lines]
    year = o["o_orderdate"][r.orow[lines]].to(torch.int64) >> 9
    group = nat * 10_000 + year
    qty = r.a.val(li["l_quantity"][lines])
    totals: Dict[int, object] = {}
    for at, psr in r.ps_rows(lines):
        amount = r.rev4[lines[at]] - r.a.val(ps["ps_supplycost"][psr]) * \
            qty[at]
        g, inv = torch.unique(group[at], return_inverse=True)
        sums = r.a.group_sum(inv, amount, len(g))
        for gi, v in zip(g.tolist(), sums.tolist()):
            totals[gi] = totals.get(gi, 0) + v
    rows = [[r.nation_name(g // 10_000), g % 10_000, v / 10000]
            for g, v in totals.items()]
    rows.sort(key=lambda x: (x[0], -x[1]))
    return rows


def q10(r: _Ref):
    li, o, c = r.c["lineitem"], r.c["orders"], r.c["customer"]
    m = _between(o["o_orderdate"], "1993-10-01", "1994-01-01")[r.orow] & \
        (li["l_returnflag"] == r.code("lineitem", "l_returnflag", "R"))
    crow = r.crow_o[r.orow[m]]
    n_c = len(c["c_custkey"])
    rev = r.a.group_sum(crow, r.rev4[m], n_c)
    cand = torch.nonzero(torch.bincount(crow, minlength=n_c) > 0).flatten()
    cand = cand[r.top(rev[cand], 20)].tolist()
    keyed = sorted(((r.a.num(rev[i]), int(c["c_custkey"][i]), i)
                    for i in cand), key=lambda x: (-x[0], x[1]))[:20]
    return [[k, r.word("customer", "c_name", i), v / 10000,
             r.a.num(r.a.val(c["c_acctbal"][i])) / 100,
             r.nation_name(int(c["c_nationkey"][i])),
             r.word("customer", "c_address", i),
             r.word("customer", "c_phone", i),
             r.word("customer", "c_comment", i)] for v, k, i in keyed]


def q11(r: _Ref, fraction: str):
    ps, supp = r.c["partsupp"], r.c["supplier"]
    germany = r.nation_key("GERMANY")
    srow = r.index("supplier", "s_suppkey")[ps["ps_suppkey"]]
    ok = supp["s_nationkey"][srow] == germany
    value = r.a.val(ps["ps_supplycost"][ok]) * r.a.val(ps["ps_availqty"][ok])
    keys, inv = torch.unique(ps["ps_partkey"][ok], return_inverse=True)
    per_part = r.a.group_sum(inv, value, len(keys))
    total = r.a.sum(value)
    # value > total * fraction, in the engine's exact decimals: the
    # value's cents times 10^digits against the total's cents times the
    # literal's units
    if r.a.exact:
        digits = len(fraction.split(".")[1]) if "." in fraction else 0
        hit = per_part * 10 ** digits > total * int(fraction.replace(".", ""))
    else:
        hit = per_part > total * float(fraction)
    rows = sorted(((r.a.num(v), int(k)) for v, k in
                   zip(per_part[hit], keys[hit])), key=lambda x: (-x[0], x[1]))
    return [[k, v / 100] for v, k in rows]


def q12(r: _Ref):
    li, o = r.c["lineitem"], r.c["orders"]
    mode = li["l_shipmode"]
    commit, receipt = li["l_commitdate"], li["l_receiptdate"]
    picked = [r.code("lineitem", "l_shipmode", x) for x in ("MAIL", "SHIP")]
    m = ((mode == picked[0]) | (mode == picked[1])) & (commit < receipt) & \
        (li["l_shipdate"] < commit) & \
        _between(receipt, "1994-01-01", "1995-01-01")
    prio = o["o_orderpriority"][r.orow]
    high = (prio == r.code("orders", "o_orderpriority", "1-URGENT")) | \
        (prio == r.code("orders", "o_orderpriority", "2-HIGH"))
    rows = []
    for code in sorted(picked):
        mm = m & (mode == code)
        if bool(mm.any()):
            rows.append([r.v["lineitem"]["l_shipmode"][code],
                         int((mm & high).sum()), int((mm & ~high).sum())])
    return rows


def _special_requests(s: str) -> bool:
    i = s.find("special")
    return i >= 0 and s.find("requests", i + len("special")) >= 0


def q13(r: _Ref):
    o = r.c["orders"]
    special = r.mask("orders", "o_comment", _special_requests)
    ok = ~special[o["o_comment"]]
    n_c = len(r.c["customer"]["c_custkey"])
    per_cust = torch.bincount(r.crow_o[ok], minlength=n_c)
    dist = torch.bincount(per_cust)
    rows = [(n, k) for k, n in enumerate(dist.tolist()) if n > 0]
    rows.sort(key=lambda x: (-x[0], -x[1]))
    return [[k, n] for n, k in rows]


def q14(r: _Ref):
    li = r.c["lineitem"]
    m = _between(li["l_shipdate"], "1995-09-01", "1995-10-01")
    promo = r.mask("part", "p_type", lambda s: s.startswith("PROMO"))
    promo_l = promo[r.c["part"]["p_type"][r.prow]]
    total = r.a.sum(r.rev4[m])
    return [[100.0 * (r.a.sum(r.rev4[m & promo_l]) / 10000) /
             (total / 10000)]]


def q15(r: _Ref):
    li, supp = r.c["lineitem"], r.c["supplier"]
    m = _between(li["l_shipdate"], "1996-01-01", "1996-04-01")
    n_s = len(supp["s_suppkey"])
    rev = r.a.group_sum(r.srow[m], r.rev4[m], n_s)
    present = torch.bincount(r.srow[m], minlength=n_s) > 0
    top = rev[present].max()
    hit = torch.nonzero(present & (rev == top)).flatten().tolist()
    rows = sorted((int(supp["s_suppkey"][i]), i) for i in hit)
    return [[k, r.word("supplier", "s_name", i),
             r.word("supplier", "s_address", i),
             r.word("supplier", "s_phone", i), r.a.num(rev[i]) / 10000]
            for k, i in rows]


def _customer_complaints(s: str) -> bool:
    i = s.find("Customer")
    return i >= 0 and s.find("Complaints", i + len("Customer")) >= 0


def q16(r: _Ref):
    ps, part, supp = r.c["partsupp"], r.c["part"], r.c["supplier"]
    brand = part["p_brand"].to(torch.int64)
    ptype = part["p_type"].to(torch.int64)
    size = part["p_size"].to(torch.int64)
    sizes = torch.tensor([49, 14, 23, 45, 19, 3, 36, 9], device=r.dev)
    polished = r.mask("part", "p_type",
                      lambda s: s.startswith("MEDIUM POLISHED"))
    part_ok = (brand != r.code("part", "p_brand", "Brand#45")) & \
        ~polished[ptype] & torch.isin(size, sizes)
    bad = r.mask("supplier", "s_comment", _customer_complaints)[
        supp["s_comment"]]
    prow = r.index("part", "p_partkey")[ps["ps_partkey"]]
    srow = r.index("supplier", "s_suppkey")[ps["ps_suppkey"]]
    ok = part_ok[prow] & ~bad[srow]
    n_types = len(r.v["part"]["p_type"])
    group = (brand[prow[ok]] * n_types + ptype[prow[ok]]) * 51 + \
        size[prow[ok]]
    span = int(ps["ps_suppkey"].max()) + 1
    pairs = torch.unique(group * span + ps["ps_suppkey"][ok])
    g, cnt = torch.unique(pairs // span, return_counts=True)
    rows = [(-n, gg // 51 // n_types, gg // 51 % n_types, gg % 51)
            for gg, n in zip(g.tolist(), cnt.tolist())]
    rows.sort()
    return [[r.v["part"]["p_brand"][b], r.v["part"]["p_type"][t], sz, -n]
            for n, b, t, sz in rows]


def q17(r: _Ref):
    li, part = r.c["lineitem"], r.c["part"]
    part_ok = (part["p_brand"] == r.code("part", "p_brand", "Brand#23")) & \
        (part["p_container"] == r.code("part", "p_container", "MED BOX"))
    m = part_ok[r.prow]
    keys, inv = torch.unique(li["l_partkey"][m], return_inverse=True)
    qty, price = li["l_quantity"][m], li["l_extendedprice"][m]
    n = torch.bincount(inv, minlength=len(keys))
    s = r.a.group_sum(inv, qty, len(keys))
    # the engine compares DOUBLEs: DecimalToDouble(l_quantity) <
    # 0.2 * (DecimalToDouble(sum) / count), DecimalToDouble(u) = u * 0.01
    f = torch.float64 if r.a.exact else torch.float32
    threshold = 0.2 * ((s.to(f) * 0.01) / n.to(f))
    keep = qty.to(f) * 0.01 < threshold[inv]
    if not bool(keep.any()):
        return [[None]]
    total = r.a.sum(price[keep])
    return [[float(torch.tensor(total, dtype=f) * 0.01) / 7.0]]


def q18(r: _Ref):
    li, o, c = r.c["lineitem"], r.c["orders"], r.c["customer"]
    n_o = len(o["o_orderkey"])
    qsum = r.a.group_sum(r.orow, li["l_quantity"], n_o)
    cand = torch.nonzero(qsum > 30_000).flatten()
    price = r.a.val(o["o_totalprice"])
    cand = cand[r.top(price[cand], 100)].tolist()
    rows = sorted(((r.a.num(price[i]), int(o["o_orderdate"][i]),
                    int(o["o_orderkey"][i]), i) for i in cand),
                  key=lambda x: (-x[0], x[1], x[2]))[:100]
    out = []
    for p, d, k, i in rows:
        crow = int(r.crow_o[i])
        out.append([r.word("customer", "c_name", crow),
                    int(c["c_custkey"][crow]), k, iso_of_code(d), p / 100,
                    r.a.num(qsum[i]) / 100])
    return out


def q19(r: _Ref):
    li, part = r.c["lineitem"], r.c["part"]
    qty = li["l_quantity"]
    base = (li["l_shipmode"] == r.code("lineitem", "l_shipmode", "AIR")) & \
        (li["l_shipinstruct"] == r.code("lineitem", "l_shipinstruct",
                                        "DELIVER IN PERSON"))
    pb = part["p_brand"][r.prow]
    pc = part["p_container"][r.prow]
    psz = part["p_size"][r.prow]

    def cont(*names):
        codes = torch.tensor([r.code("part", "p_container", x)
                              for x in names], device=r.dev)
        return torch.isin(pc, codes)

    def brand(name):
        return pb == r.code("part", "p_brand", name)

    m = base & (
        (brand("Brand#12") & cont("SM CASE", "SM BOX", "SM PACK", "SM PKG") &
         (qty >= 100) & (qty <= 1100) & (psz >= 1) & (psz <= 5)) |
        (brand("Brand#23") &
         cont("MED BAG", "MED BOX", "MED PKG", "MED PACK") &
         (qty >= 1000) & (qty <= 2000) & (psz >= 1) & (psz <= 10)) |
        (brand("Brand#34") & cont("LG CASE", "LG BOX", "LG PACK", "LG PKG") &
         (qty >= 2000) & (qty <= 3000) & (psz >= 1) & (psz <= 15)))
    if not bool(m.any()):
        return [[None]]
    return [[r.a.sum(r.rev4[m]) / 10000]]


def q20(r: _Ref):
    li, ps, supp = r.c["lineitem"], r.c["partsupp"], r.c["supplier"]
    forest = r.mask("part", "p_name", lambda s: s.startswith("forest"))
    lines = torch.nonzero(
        forest[r.c["part"]["p_name"][r.prow]] &
        _between(li["l_shipdate"], "1994-01-01", "1995-01-01")).flatten()
    n_ps = len(ps["ps_partkey"])
    qsum = torch.zeros(n_ps, dtype=r.a.val(li["l_quantity"][:1]).dtype,
                       device=r.dev)
    seen = torch.zeros(n_ps, dtype=torch.bool, device=r.dev)
    qty = r.a.val(li["l_quantity"][lines])
    for at, psr in r.ps_rows(lines):
        qsum.index_add_(0, psr, qty[at])
        seen[psr] = True
    # availqty > 0.5 * sum(quantity), in the engine's exact decimals at
    # scale 3: availqty * 1000 > 5 * the sum's cents
    ok = seen & (r.a.val(ps["ps_availqty"]) * 1000 > 5 * qsum)
    canada = r.nation_key("CANADA")
    srow = torch.unique(r.index("supplier", "s_suppkey")[ps["ps_suppkey"][ok]])
    srow = srow[supp["s_nationkey"][srow] == canada].tolist()
    rows = [[r.word("supplier", "s_name", i),
             r.word("supplier", "s_address", i)] for i in srow]
    rows.sort(key=lambda x: x[0])
    return rows


def q21(r: _Ref):
    li, o, supp = r.c["lineitem"], r.c["orders"], r.c["supplier"]
    sk = li["l_suppkey"].to(torch.int64)
    n_o = len(o["o_orderkey"])
    late = li["l_receiptdate"] > li["l_commitdate"]

    def per_order(values, how, init):
        out = torch.full((n_o,), init, dtype=torch.int64, device=r.dev)
        return out.scatter_reduce_(0, r.orow, values, how)[r.orow]

    smin = per_order(sk, "amin", INT64_MAX)
    smax = per_order(sk, "amax", -1)
    lmin = per_order(torch.where(late, sk, INT64_MAX), "amin", INT64_MAX)
    lmax = per_order(torch.where(late, sk, -1), "amax", -1)
    other = (smin != sk) | (smax != sk)
    late_other = (lmax >= 0) & ((lmin != sk) | (lmax != sk))
    finished = o["o_orderstatus"][r.orow] == r.code("orders",
                                                     "o_orderstatus", "F")
    saudi = r.supp_nation() == r.nation_key("SAUDI ARABIA")
    m = late & finished & other & ~late_other & saudi
    counts = torch.bincount(r.srow[m], minlength=len(supp["s_suppkey"]))
    rows = [(-n, r.word("supplier", "s_name", i))
            for i, n in enumerate(counts.tolist()) if n > 0]
    rows.sort()
    return [[name, -n] for n, name in rows[:100]]


Q22_CODES = ("13", "31", "23", "29", "30", "18", "17")


def q22(r: _Ref):
    c = r.c["customer"]
    code_of = [s[:2] for s in r.v["customer"]["c_phone"]]
    in_codes = r.mask("customer", "c_phone",
                      lambda s: s[:2] in Q22_CODES)[c["c_phone"]]
    bal = c["c_acctbal"]
    pos = in_codes & (bal > 0)
    # the engine compares DOUBLEs: DecimalToDouble(c_acctbal) >
    # DecimalToDouble(sum) / count
    f = torch.float64 if r.a.exact else torch.float32
    s, n = r.a.sum(bal[pos]), int(pos.sum())
    avg = (torch.tensor(s, dtype=f) * 0.01) / torch.tensor(n, dtype=f)
    above = bal.to(f) * 0.01 > avg
    has_order = torch.zeros(len(bal), dtype=torch.bool, device=r.dev)
    has_order[r.crow_o] = True
    keep = in_codes & above & ~has_order
    codes = [code_of[i] for i in c["c_phone"][keep].tolist()]
    kept = bal[keep]
    rows = []
    for cc in sorted(set(codes)):
        sel = torch.tensor([x == cc for x in codes], dtype=torch.bool,
                           device=r.dev)
        rows.append([cc, int(sel.sum()), r.a.sum(kept[sel]) / 100])
    return rows


QUERIES = {f"q{i}": globals()[f"q{i}"] for i in range(1, 23)}

# Q11's "* FRACTION" in its HAVING subquery
_FRACTION = re.compile(
    r"(sum\(ps_supplycost \* ps_availqty\) \* )(\d+(?:\.\d+)?)")
# SHA-256 of each text this reference answers, Q11's FRACTION a placeholder
TEXTS = {
    "q1": "4a3c26c40e4b68801b1a7bf0c40f8ca0ec44d726edc32edac81db28aaf9c559a",
    "q2": "c2a21693645016a4f77973d42ba874033bb209517d844ba5c31a8524a1186256",
    "q3": "271e6d56c52f341a76b61504a4c3309c40a1d210648a462a6ad181924b72c9cb",
    "q4": "af07aec063ab532bf177c94b01f3bd969dd9da3bafc140ded28eb4bf41f6f1d3",
    "q5": "209478a80104f6edf8a78888580aedfc06bf40c900089cbcc1160817fdf2c732",
    "q6": "a40cdce8f00b3721faac782abfcd20c5bbc85aa307017d662a1955c6eee70489",
    "q7": "c61a61bc6bbb632c992a1231326ad69a75349c9ac6b27276cd6a24380b1e69f2",
    "q8": "be7ccb49afde3972d92d06c100d90ec7ce7be4e4522fb2cbcc6a75c2dcac84e8",
    "q9": "4b7177da29b86e8152b12ae8cb84ebe9d11faa67577a002e8b22f346c53b1e75",
    "q10": "ae648411444377253afd8f8bee46162fdbf7e5e9e5a33bc35335164af438a9e8",
    "q11": "75422f3b2987015ad159b086375998bf8e88d75978aee30de9f6451a0c0abf2b",
    "q12": "323ff931588d899e61eac8cb2e55322a836a11271be59c45417702a5c1419b9e",
    "q13": "075bede4bad54b86290be0343af649b6ec9bb02324b847810e550af2d84ad11e",
    "q14": "a7620c284f08b42b3a1010c0abb6ae2a412a734b82330d2a82aa34ceb7f5eb03",
    "q15": "db8d140c5a8940b098a9118a0803b6c6eb0ed4d8aae6ee12805ab890fed898d0",
    "q16": "098999889f5486f1f0d2fd76534285ff2d944c359929e0902f34616b656a86c1",
    "q17": "e3c5e3031f4dabc48927dfcb93e85eaff6fec28e62c9f915267020db578c0790",
    "q18": "059900301e40b47200c39bace7472fab16dc2f113586c0505f323cff7e0a5550",
    "q19": "f8565b8f17505f09bfd876c80888e6f8794a743032a95aa48a2f07123cff7585",
    "q20": "2dd84ce93ab783501d8fb1e7cd4c7eab9205df801a747ad27e293d36fe32253b",
    "q21": "3c40fe61024270473570109de82da9078396f8ffe85a6d7f65d59f8befbe2d2c",
    "q22": "0f12dc49545b143eafc81bcdd2b211bfc4da914a228da94cb9f3bad14b9abfb9",
}


def _normal(name: str, sql: str) -> str:
    return _FRACTION.sub(r"\1FRACTION", sql) if name == "q11" else sql


def answers(tables: Tables, sqls: Dict[str, str], names: List[str] = None,
            exact: bool = True) -> Dict[str, list]:
    """The answer of each query in `names` (every one of `sqls` by
    default), whose text `sqls` gives: a list of rows, each a list of
    values. A text that is not the one a query was written for raises."""
    names = list(names or sqls)
    for q in names:
        digest = hashlib.sha256(_normal(q, sqls[q]).encode()).hexdigest()
        if TEXTS.get(q) != digest:
            raise ValueError(f"the reference does not answer this {q}: its "
                             f"text differs from the one it was written for")
    r = _Ref(tables, exact)
    out = {}
    for q in names:
        if q == "q11":
            out[q] = q11(r, _FRACTION.search(sqls[q]).group(2))
        else:
            out[q] = QUERIES[q](r)
    return out
