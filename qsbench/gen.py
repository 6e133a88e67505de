"""The 8 TPC-H tables at a scale factor, made from a seed on one device.

A frozen copy of quickstep_tpu_torch/bench/tpch_fullgen.py's `generate`
(the same schema, distributions, dictionaries and value domains: per-row
identity strings such as c_name are real, free text is drawn from bounded
pools of distinct strings, the LIKE patterns of Q9, Q13, Q16 and Q20 are
injected at the same rates, partsupp's and lineitem's supplier formula is
the specification's), rewritten in plain PyTorch: every column is drawn by
a `torch.Generator` seeded with `seed` on `device`, in a few large calls,
and the text pools are sorted as token tuples on the device, so no string
is sorted on the host. The same (scale, seed, device type) gives the same
tables.

Every DECIMAL is the specification's DECIMAL(15,2) (dss.ddl; a Decimal
holds +-9,999,999,999.99, TPC-H 1.3.1), an int64 of cents. Every other
column is int32: INT as is, DATE as the packed code (year << 9 | month
<< 5 | day, whose order is the dates'), CHAR and VARCHAR as codes into a
sorted vocabulary. This module imports
nothing of the program: the harness hands its tables to the program
(qsbench/load.py) and, after the window, to the reference.
"""

from __future__ import annotations

import dataclasses
import datetime as dt
from typing import Dict, List

import numpy as np
import torch

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
INSTRUCTS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
MODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINER_S1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINER_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
COLORS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished",
    "chartreuse", "chiffon", "chocolate", "coral", "cornflower", "cornsilk",
    "cream", "cyan", "dark", "deep", "dim", "dodger", "drab", "firebrick",
    "floral", "forest", "frosted", "gainsboro", "ghost", "goldenrod", "green",
    "grey", "honeydew", "hot", "hazelnut", "indian", "ivory", "khaki", "lace",
    "lavender", "lawn", "lemon", "light", "lime", "linen", "magenta",
    "maroon", "medium", "metallic", "midnight", "mint", "misty", "moccasin",
    "navajo", "navy", "olive", "orange", "orchid", "pale", "papaya", "peach",
    "peru", "pink", "plum", "powder", "puff", "purple", "red", "rose", "rosy",
    "royal", "saddle", "salmon", "sandy", "seashell", "sienna", "sky",
    "slate", "smoke", "snow", "spring", "steel", "tan", "thistle", "tomato",
    "turquoise", "violet", "wheat", "white", "yellow",
]
WORDS = COLORS + [
    "the", "quick", "ironic", "final", "bold", "furious", "slyly",
    "carefully", "blithely", "express", "regular", "pending", "deposits",
    "foxes", "pinto", "beans", "accounts", "packages", "theodolites",
    "instructions", "dependencies", "requests", "platelets", "ideas",
    "asymptotes", "somas", "dugouts"]
# the words an injected pattern adds ("<w1> of <w2>" at a comment's end)
_INJECTED = ["of", "special", "Customer", "Complaints"]

# (column, SQL type) of each table, in the order of the CREATE TABLE
SCHEMAS = {
    "region": [("r_regionkey", "INT"), ("r_name", "CHAR(25)"),
               ("r_comment", "VARCHAR(152)")],
    "nation": [("n_nationkey", "INT"), ("n_name", "CHAR(25)"),
               ("n_regionkey", "INT"), ("n_comment", "VARCHAR(152)")],
    "supplier": [("s_suppkey", "INT"), ("s_name", "CHAR(25)"),
                 ("s_address", "VARCHAR(40)"), ("s_nationkey", "INT"),
                 ("s_phone", "CHAR(15)"), ("s_acctbal", "DECIMAL(15,2)"),
                 ("s_comment", "VARCHAR(101)")],
    "part": [("p_partkey", "INT"), ("p_name", "VARCHAR(55)"),
             ("p_mfgr", "CHAR(25)"), ("p_brand", "CHAR(10)"),
             ("p_type", "VARCHAR(25)"), ("p_size", "INT"),
             ("p_container", "CHAR(10)"), ("p_retailprice", "DECIMAL(15,2)"),
             ("p_comment", "VARCHAR(23)")],
    "partsupp": [("ps_partkey", "INT"), ("ps_suppkey", "INT"),
                 ("ps_availqty", "INT"), ("ps_supplycost", "DECIMAL(15,2)"),
                 ("ps_comment", "VARCHAR(199)")],
    "customer": [("c_custkey", "INT"), ("c_name", "VARCHAR(25)"),
                 ("c_address", "VARCHAR(40)"), ("c_nationkey", "INT"),
                 ("c_phone", "CHAR(15)"), ("c_acctbal", "DECIMAL(15,2)"),
                 ("c_mktsegment", "CHAR(10)"), ("c_comment", "VARCHAR(117)")],
    "orders": [("o_orderkey", "INT"), ("o_custkey", "INT"),
               ("o_orderstatus", "CHAR(1)"), ("o_totalprice", "DECIMAL(15,2)"),
               ("o_orderdate", "DATE"), ("o_orderpriority", "CHAR(15)"),
               ("o_clerk", "CHAR(15)"), ("o_shippriority", "INT"),
               ("o_comment", "VARCHAR(79)")],
    "lineitem": [("l_orderkey", "INT"), ("l_partkey", "INT"),
                 ("l_suppkey", "INT"), ("l_linenumber", "INT"),
                 ("l_quantity", "DECIMAL(15,2)"),
                 ("l_extendedprice", "DECIMAL(15,2)"),
                 ("l_discount", "DECIMAL(15,2)"), ("l_tax", "DECIMAL(15,2)"),
                 ("l_returnflag", "CHAR(1)"), ("l_linestatus", "CHAR(1)"),
                 ("l_shipdate", "DATE"), ("l_commitdate", "DATE"),
                 ("l_receiptdate", "DATE"), ("l_shipinstruct", "CHAR(25)"),
                 ("l_shipmode", "CHAR(10)"), ("l_comment", "VARCHAR(44)")],
}

EPOCH = dt.date(1992, 1, 1)
# orders are dated in [EPOCH, EPOCH + ORDER_DAYS); lines ship up to 151
# days later
ORDER_DAYS = 2406


def date_code(iso: str) -> int:
    """The DATE column code of an ISO date."""
    y, m, d = map(int, iso.split("-"))
    return (y << 9) | (m << 5) | d


def iso_of_code(code: int) -> str:
    code = int(code)
    return f"{code >> 9:04d}-{(code >> 5) & 15:02d}-{code & 31:02d}"


def _day_codes(n_days: int) -> List[int]:
    out = []
    for i in range(n_days):
        d = EPOCH + dt.timedelta(days=i)
        out.append((d.year << 9) | (d.month << 5) | d.day)
    return out


@dataclasses.dataclass
class Tables:
    """The generated tables: `columns[table][column]` an int32 tensor
    (int64 for a DECIMAL), `vocab[table][column]` the sorted strings of a
    CHAR or VARCHAR column."""
    scale: float
    seed: int
    columns: Dict[str, Dict[str, torch.Tensor]]
    vocab: Dict[str, Dict[str, List[str]]]

    def rows(self, table: str) -> int:
        return int(next(iter(self.columns[table].values())).shape[0])


class _Draw:
    """Uniform draws from one torch.Generator on one device."""

    def __init__(self, seed: int, device: torch.device):
        self.device = device
        self.gen = torch.Generator(device=device)
        # a seed of any size: the generator takes 64 bits
        self.gen.manual_seed(int(seed) % (1 << 64))

    def ints(self, lo: int, hi: int, n) -> torch.Tensor:
        """int64 integers in [lo, hi] (both ends included)."""
        shape = n if isinstance(n, tuple) else (n,)
        return torch.randint(lo, hi + 1, shape, generator=self.gen,
                             device=self.device, dtype=torch.int64)

    def unit(self, n: int) -> torch.Tensor:
        return torch.rand(n, generator=self.gen, device=self.device,
                          dtype=torch.float64)


def _rank(vocab: List[str]):
    """(sorted vocab, rank) where rank[i] is the code of vocab[i]."""
    order = sorted(range(len(vocab)), key=lambda i: vocab[i])
    rank = [0] * len(vocab)
    for code, i in enumerate(order):
        rank[i] = code
    return [vocab[i] for i in order], rank


def _unique_rows(tok: torch.Tensor) -> torch.Tensor:
    """The distinct rows of an int64 matrix in lexicographic order (a
    stable sort by each column from the last)."""
    order = torch.arange(tok.shape[0], device=tok.device)
    for j in range(tok.shape[1] - 1, -1, -1):
        order = order[torch.sort(tok[order, j], stable=True).indices]
    s = tok[order]
    keep = torch.ones(s.shape[0], dtype=torch.bool, device=s.device)
    keep[1:] = (s[1:] != s[:-1]).any(dim=1)
    return s[keep]


def _join_tokens(tok: np.ndarray, words: List[str]) -> List[str]:
    """The strings of token rows (word ids, -1 past a row's end) joined by
    single spaces, built as one byte buffer."""
    wb = [w.encode("ascii") for w in words]
    width = max(len(b) for b in wb) + 1
    table = np.zeros((len(wb), width), np.uint8)
    wlen = np.array([len(b) for b in wb], np.int64)
    for i, b in enumerate(wb):
        table[i, :len(b)] = np.frombuffer(b, np.uint8)
    live = tok >= 0
    flat = tok[live]
    last = np.zeros_like(live)
    n_words = live.sum(axis=1)
    last[np.arange(tok.shape[0]), n_words - 1] = True
    sep = np.where(last[live], ord("\n"), ord(" ")).astype(np.uint8)
    m = table[flat]
    m[np.arange(len(flat)), wlen[flat]] = sep
    keep = np.arange(width)[None, :] <= wlen[flat][:, None]
    return m[keep].tobytes().decode("ascii").split("\n")[:-1]


def _text_pool(draw: _Draw, n: int, min_w: int, max_w: int,
               inject: str = None, prob: float = 0.0) -> List[str]:
    """The sorted distinct strings of n random texts of min_w to max_w
    words, a share `prob` of them ending in "<w1> of <w2>" (inject =
    "w1 w2"). Token tuples in word-string order sort as the strings do,
    since the separator sorts below every letter."""
    words = WORDS + _INJECTED
    sorted_words, rank = _rank(words)
    rank_t = torch.tensor(rank, device=draw.device)
    counts = draw.ints(min_w, max_w, n)
    idx = draw.ints(0, len(WORDS) - 1, (n, max_w))
    pos = torch.arange(max_w + 3, device=draw.device)[None, :]
    tok = torch.full((n, max_w + 3), -1, dtype=torch.int64,
                     device=draw.device)
    tok[:, :max_w] = torch.where(pos[:, :max_w] < counts[:, None],
                                 rank_t[idx], -1)
    if inject:
        w1, w2 = inject.split()
        hit = draw.unit(n) < prob
        rows = torch.nonzero(hit).flatten()
        c = counts[rows]
        for k, w in enumerate((w1, "of", w2)):
            tok[rows, c + k] = rank[words.index(w)]
    uniq = _unique_rows(tok)
    return _join_tokens(uniq.cpu().numpy(), sorted_words)


def _phone_pool(draw: _Draw, n: int) -> List[str]:
    """The sorted distinct phones "NN-DDD-DDD-DDDD" of n draws (country
    code 10 + a nation): fixed widths, so their numbers sort as the
    strings do."""
    a = draw.ints(10, 34, n)
    b = draw.ints(100, 999, n)
    c = draw.ints(100, 999, n)
    d = draw.ints(1000, 9999, n)
    key = torch.unique(((a * 1000 + b) * 1000 + c) * 10000 + d).cpu()
    return [f"{k // 10**10}-{k // 10**7 % 1000}-{k // 10**4 % 1000}-"
            f"{k % 10000}" for k in key.tolist()]


def _name_pool(draw: _Draw, n: int) -> List[str]:
    """The sorted distinct p_names of n draws of 5 colours."""
    sorted_colors, rank = _rank(COLORS)
    rank_t = torch.tensor(rank, device=draw.device)
    digits = rank_t[draw.ints(0, len(COLORS) - 1, (n, 5))]
    base = len(COLORS)
    key = digits[:, 0]
    for j in range(1, 5):
        key = key * base + digits[:, j]
    key = torch.unique(key)
    tok = torch.stack([key // base ** (4 - j) % base for j in range(5)],
                      dim=1)
    return _join_tokens(tok.cpu().numpy(), sorted_colors)


def _numbered(prefix: str, n: int) -> List[str]:
    """prefix + 9-digit zero-padded 1..n: sorted as the numbers."""
    return [f"{prefix}{i:09d}" for i in range(1, n + 1)]


def generate(scale: float, seed: int, device="cpu") -> Tables:
    """All 8 tables at `scale` from `seed`, made on `device`."""
    device = torch.device(device)
    draw = _Draw(seed, device)
    i32 = torch.int32
    S = max(int(10_000 * scale), 10)
    P = max(int(200_000 * scale), 200)
    C = max(int(150_000 * scale), 150)
    O = max(int(1_500_000 * scale), 1500)
    n_clerks = max(int(1000 * scale), 10)
    decimals = {c for schema in SCHEMAS.values() for c, typ in schema
                if typ.startswith("DECIMAL")}
    cols: Dict[str, Dict[str, torch.Tensor]] = {t: {} for t in SCHEMAS}
    vocab: Dict[str, Dict[str, List[str]]] = {t: {} for t in SCHEMAS}

    def put(table, name, values, words=None):
        cols[table][name] = values.to(
            torch.int64 if name in decimals else i32)
        if words is not None:
            vocab[table][name] = words

    def arange(lo, hi):
        return torch.arange(lo, hi, device=device, dtype=torch.int64)

    # ---- text pools (bounded dictionaries) ----
    addr = _text_pool(draw, 100_000, 2, 4)
    ocom = _text_pool(draw, 200_000, 5, 12, "special requests", 0.01)
    lcom = _text_pool(draw, 200_000, 2, 5)
    pscom = _text_pool(draw, 200_000, 4, 10)
    ccom = _text_pool(draw, 100_000, 5, 12, "special requests", 0.01)
    scom = _text_pool(draw, 50_000, 5, 12, "Customer Complaints", 0.0005)
    pcom = _text_pool(draw, 50_000, 2, 5)
    phones = _phone_pool(draw, 100_000)
    pnames = _name_pool(draw, 2_000_000)

    def pick(pool, n):
        return draw.ints(0, len(pool) - 1, n)

    # ---- region, nation ----
    rname, rrank = _rank(REGIONS)
    put("region", "r_regionkey", arange(0, 5))
    put("region", "r_name", torch.tensor(rrank, device=device), rname)
    rcom = _text_pool(draw, 5, 4, 10)
    put("region", "r_comment", pick(rcom, 5), rcom)
    nname, nrank = _rank([n for n, _ in NATIONS])
    put("nation", "n_nationkey", arange(0, 25))
    put("nation", "n_name", torch.tensor(nrank, device=device), nname)
    put("nation", "n_regionkey",
        torch.tensor([r for _, r in NATIONS], device=device))
    ncom = _text_pool(draw, 25, 4, 10)
    put("nation", "n_comment", pick(ncom, 25), ncom)

    # ---- supplier ----
    put("supplier", "s_suppkey", arange(1, S + 1))
    put("supplier", "s_name", arange(0, S), _numbered("Supplier#", S))
    put("supplier", "s_address", pick(addr, S), addr)
    put("supplier", "s_nationkey", draw.ints(0, 24, S))
    put("supplier", "s_phone", pick(phones, S), phones)
    put("supplier", "s_acctbal", draw.ints(-99_999, 999_999, S))
    put("supplier", "s_comment", pick(scom, S), scom)

    # ---- part ----
    pk = arange(1, P + 1)
    put("part", "p_partkey", pk)
    put("part", "p_name", pick(pnames, P), pnames)
    mfgr = draw.ints(1, 5, P)
    put("part", "p_mfgr", mfgr - 1,
        [f"Manufacturer#{i}" for i in range(1, 6)])
    brand_y = draw.ints(1, 5, P)
    put("part", "p_brand", (mfgr - 1) * 5 + (brand_y - 1),
        [f"Brand#{m}{y}" for m in range(1, 6) for y in range(1, 6)])
    types, trank = _rank([f"{a} {b} {c}" for a in TYPE_S1 for b in TYPE_S2
                          for c in TYPE_S3])
    t1, t2, t3 = draw.ints(0, 5, P), draw.ints(0, 4, P), draw.ints(0, 4, P)
    put("part", "p_type",
        torch.tensor(trank, device=device)[t1 * 25 + t2 * 5 + t3], types)
    put("part", "p_size", draw.ints(1, 50, P))
    conts, crank = _rank([f"{a} {b}" for a in CONTAINER_S1
                          for b in CONTAINER_S2])
    c1, c2 = draw.ints(0, 4, P), draw.ints(0, 7, P)
    put("part", "p_container",
        torch.tensor(crank, device=device)[c1 * 8 + c2], conts)
    put("part", "p_retailprice",
        90_000 + (pk // 10) % 20_001 + 100 * (pk % 1000))
    put("part", "p_comment", pick(pcom, P), pcom)

    # ---- partsupp: 4 suppliers a part, the specification's formula ----
    ps_part = pk.repeat_interleave(4)
    i4 = arange(0, 4).repeat(P)
    put("partsupp", "ps_partkey", ps_part)
    put("partsupp", "ps_suppkey",
        (ps_part + i4 * (S // 4 + (ps_part - 1) // S)) % S + 1)
    put("partsupp", "ps_availqty", draw.ints(1, 9_999, P * 4))
    put("partsupp", "ps_supplycost", draw.ints(100, 100_000, P * 4))
    put("partsupp", "ps_comment", pick(pscom, P * 4), pscom)

    # ---- customer ----
    ck = arange(1, C + 1)
    put("customer", "c_custkey", ck)
    put("customer", "c_name", arange(0, C), _numbered("Customer#", C))
    put("customer", "c_address", pick(addr, C), addr)
    put("customer", "c_nationkey", draw.ints(0, 24, C))
    put("customer", "c_phone", pick(phones, C), phones)
    put("customer", "c_acctbal", draw.ints(-99_999, 999_999, C))
    segs, srank = _rank(SEGMENTS)
    put("customer", "c_mktsegment",
        torch.tensor(srank, device=device)[draw.ints(0, 4, C)], segs)
    put("customer", "c_comment", pick(ccom, C), ccom)

    # ---- orders and lineitem ----
    days = torch.tensor(_day_codes(ORDER_DAYS + 160), device=device)
    cutoff = (dt.date(1995, 6, 17) - EPOCH).days
    lines = draw.ints(1, 7, O)
    L = int(lines.sum())
    eligible = ck[ck % 3 != 0]
    o_cust = eligible[draw.ints(0, len(eligible) - 1, O)]
    o_day = draw.ints(0, ORDER_DAYS - 1, O)
    prios, prank = _rank(PRIORITIES)
    o_prio = torch.tensor(prank, device=device)[draw.ints(0, 4, O)]
    o_clerk = draw.ints(0, n_clerks - 1, O)
    o_com = pick(ocom, O)

    order_of = arange(0, O).repeat_interleave(lines)
    starts = torch.cumsum(lines, 0) - lines
    l_part = draw.ints(1, P, L)
    li4 = draw.ints(0, 3, L)
    qty = draw.ints(1, 50, L)
    disc = draw.ints(0, 10, L)
    tax = draw.ints(0, 8, L)
    l_day = o_day[order_of]
    ship = l_day + draw.ints(1, 121, L)
    commit = l_day + draw.ints(30, 90, L)
    receipt = ship + draw.ints(1, 30, L)
    rf_rand = draw.unit(L)
    instrs, irank = _rank(INSTRUCTS)
    instr = torch.tensor(irank, device=device)[draw.ints(0, 3, L)]
    modes, mrank = _rank(MODES)
    mode = torch.tensor(mrank, device=device)[draw.ints(0, 6, L)]
    l_com = pick(lcom, L)
    del l_day

    okey = arange(1, O + 1) * 4
    l_supp = (l_part + li4 * (S // 4 + (l_part - 1) // S)) % S + 1
    del li4
    retail = 90_000 + (l_part // 10) % 20_001 + 100 * (l_part % 1000)
    extp = qty * retail
    del retail
    # returnflag: A or R (even odds) for lines received by the cutoff, else
    # N; codes into ["A", "N", "R"]
    rf = torch.where(receipt <= cutoff,
                     torch.where(rf_rand < 0.5, 0, 2), 1)
    del rf_rand
    open_line = ship > cutoff                  # linestatus O, else F
    totals = torch.zeros(O, dtype=torch.int64, device=device)
    totals.index_add_(0, order_of, extp * (100 + tax) * (100 - disc))
    n_f = torch.zeros(O, dtype=torch.int64, device=device)
    n_f.index_add_(0, order_of, (~open_line).to(torch.int64))
    status = torch.where(n_f == lines, 0, torch.where(n_f == 0, 1, 2))

    put("orders", "o_orderkey", okey)
    put("orders", "o_custkey", o_cust)
    put("orders", "o_orderstatus", status, ["F", "O", "P"])
    put("orders", "o_totalprice", (totals + 5000) // 10_000)
    put("orders", "o_orderdate", days[o_day])
    put("orders", "o_orderpriority", o_prio, prios)
    put("orders", "o_clerk", o_clerk, _numbered("Clerk#", n_clerks))
    put("orders", "o_shippriority", torch.zeros_like(o_day))
    put("orders", "o_comment", o_com, ocom)
    del totals, n_f, status, o_cust, o_prio, o_clerk, o_com

    put("lineitem", "l_orderkey", okey[order_of])
    put("lineitem", "l_partkey", l_part)
    put("lineitem", "l_suppkey", l_supp)
    put("lineitem", "l_linenumber",
        arange(0, L) - starts[order_of] + 1)
    put("lineitem", "l_quantity", qty * 100)
    put("lineitem", "l_extendedprice", extp)
    put("lineitem", "l_discount", disc)
    put("lineitem", "l_tax", tax)
    put("lineitem", "l_returnflag", rf, ["A", "N", "R"])
    put("lineitem", "l_linestatus", open_line.to(torch.int64), ["F", "O"])
    put("lineitem", "l_shipdate", days[ship])
    put("lineitem", "l_commitdate", days[commit])
    put("lineitem", "l_receiptdate", days[receipt])
    put("lineitem", "l_shipinstruct", instr, instrs)
    put("lineitem", "l_shipmode", mode, modes)
    put("lineitem", "l_comment", l_com, lcom)
    # columns in the schema's order
    cols = {t: {c: cols[t][c] for c, _ in SCHEMAS[t]} for t in SCHEMAS}
    return Tables(scale, seed, cols, vocab)
