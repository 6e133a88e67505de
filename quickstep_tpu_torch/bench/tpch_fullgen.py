# Copied from tools/sf100_fullgen.py; imports renamed, tables built in host memory instead of an on-disk store, oracles of Q9, Q16 and Q21 added.
"""All 8 TPC-H tables at a given scale, in host memory, with an exact
integer oracle for Q1, Q3, Q4, Q5, Q6, Q7, Q10, Q12, Q14, Q18 and Q19, and
for Q9, Q16 and Q21 (`extra_oracles`, computed from the generated columns).

The same distributions, formulas, seeds and text-pool policy as
tools/sf100_fullgen.py: per-row-identity strings (c_name, s_name, o_clerk)
are real, free text (comments, addresses, phones, p_name) is drawn from
bounded pools of distinct strings, and LIKE-pattern injection rates match
bench/tpchgen.py. orders and lineitem are generated in chunks of whole
orders, each from its own `default_rng(41000 + chunk)` stream, so the oracle
accumulates chunk by chunk while the columns fill preallocated int32 arrays.

Instead of writing a store, `load_tpch_full` loads the tables into a
Database with exact statistics (the tool's catalog.json statistics) and
returns the tool's oracle together with `extra_oracles`.

    python -m quickstep_tpu_torch.bench.tpch_fullgen [scale]
"""

import datetime as dt
import math
import sys
import time

import numpy as np

from quickstep_tpu_torch.bench.tpchgen import (
    _dates_from_daynum, _text_column, _phone, _EPOCH, TPCH_SCHEMAS,
    REGIONS, NATIONS, SEGMENTS, PRIORITIES, INSTRUCTS, MODES,
    TYPE_S1, TYPE_S2, TYPE_S3, CONTAINER_S1, CONTAINER_S2, COLORS)
from quickstep_tpu_torch.catalog.catalog import _stats_from_json
from quickstep_tpu_torch.storage.column import Column
from quickstep_tpu_torch.storage.dictionary import Dictionary
from quickstep_tpu_torch.storage.table import TableData

INT32_MAX = 2**31 - 1

# Orders per generated chunk. Chunk i draws from default_rng(41000 + i), so
# the tables and the oracle depend on this number: changing it changes the
# data. It is the tool's default.
_CHUNK_ORDERS = 10_000_000


def day(s):
    y, m, d = map(int, s.split("-"))
    return (dt.date(y, m, d) - _EPOCH).days


def iso_of_daynum(n):
    return (_EPOCH + dt.timedelta(days=int(n))).isoformat()


def exact_sum(a):
    """Exact big-int sum of an int64 array (split so chunks can't overflow)."""
    a = a.astype(np.int64)
    lo = int((a % (1 << 30)).sum(dtype=np.int64))
    hi = int((a // (1 << 30)).sum(dtype=np.int64))
    return hi * (1 << 30) + lo


def rank_map(vocab):
    """(sorted_vocab, rank) where rank[i] = code of vocab[i] in sorted order."""
    order = np.argsort(np.asarray(vocab, dtype=object), kind="stable")
    rank = np.empty(len(vocab), np.int32)
    rank[order] = np.arange(len(vocab), dtype=np.int32)
    return [str(vocab[i]) for i in order], rank


class TableOut:
    """One table's int32 columns in host memory (the tool writes the same
    arrays as .npy files); types come from TPCH_SCHEMAS."""

    def __init__(self, name, n_rows):
        self.name = name
        self.n = n_rows
        self.types = dict(TPCH_SCHEMAS[name])
        self.arrays = {}         # col -> int32[n]
        self.dicts = {}          # col -> sorted values list

    def col(self, cname, dict_values=None):
        self.arrays[cname] = np.empty(self.n, np.int32)
        if dict_values is not None:
            self.dicts[cname] = dict_values
        return self.arrays[cname]

    def table_data(self):
        return TableData({
            cname: Column(self.types[cname], arr, None,
                          Dictionary(self.dicts[cname])
                          if cname in self.dicts else None)
            for cname, arr in self.arrays.items()})


def chunked_bincount(arr, lo, span, step=50_000_000):
    counts = np.zeros(span, np.int64)
    for s in range(0, len(arr), step):
        seg = np.asarray(arr[s:s + step], dtype=np.int64)
        counts += np.bincount(seg - lo, minlength=span)
    return counts


def column_stats(t, known):
    """Exact per-column stats in catalog JSON form (_stats_to_json shape)."""
    st = {"exact": True, "num_tuples": t.n, "min_values": {}, "max_values": {},
          "num_distinct": {}, "max_counts": {},
          "unique_pairs": known.get("__unique_pairs__", [])}
    for cname, arr in t.arrays.items():
        mn = mx = None
        for s in range(0, t.n, 100_000_000):
            seg = arr[s:s + 100_000_000]
            mn = int(seg.min()) if mn is None else min(mn, int(seg.min()))
            mx = int(seg.max()) if mx is None else max(mx, int(seg.max()))
        if cname in t.dicts:
            st["min_values"][cname] = t.dicts[cname][mn]
            st["max_values"][cname] = t.dicts[cname][mx]
        else:
            st["min_values"][cname] = mn
            st["max_values"][cname] = mx
        if cname in known:
            nd, mc = known[cname]
        else:
            span = mx - mn + 1
            if span <= 33_000_000:
                counts = chunked_bincount(arr, mn, span)
                nd = int((counts > 0).sum())
                mc = int(counts.max())
            else:
                _, counts = np.unique(np.asarray(arr), return_counts=True)
                nd = int(counts.size)
                mc = int(counts.max())
        st["num_distinct"][cname] = nd
        st["max_counts"][cname] = mc
    return st


def generate(scale, log=None):
    """(tables {name: TableOut}, stats {name: catalog-JSON stats}, oracle).

    The oracle is the tool's oracle.json: `rows` per table, and per query
    the expected rows in output order (dates as ISO strings, DECIMAL and
    float results as Python floats)."""
    t0 = time.time()
    S = max(int(10_000 * scale), 10)
    P = max(int(200_000 * scale), 200)
    C = max(int(150_000 * scale), 150)
    O = max(int(1_500_000 * scale), 1500)
    n_clerks = max(int(1000 * scale), 10)
    chunk_orders = _CHUNK_ORDERS

    if log is None:
        def log(msg):
            print(f"[{time.time()-t0:7.0f}s] {msg}", flush=True)

    # ---------------- text pools (bounded dictionaries) ----------------
    rng = np.random.default_rng(4100)

    def pool(k, min_w, max_w, inject=None, prob=0.0):
        vals = _text_column(rng, k, min_w, max_w, inject=inject,
                            inject_prob=prob)
        uniq, codes = np.unique(np.asarray(vals, dtype=object),
                                return_inverse=True)
        return [str(u) for u in uniq], codes.astype(np.int32)

    log("building text pools")
    pool_addr_v, _ = pool(100_000, 2, 4)
    pool_ocom_v, _ = pool(200_000, 5, 12, inject="special requests", prob=0.01)
    pool_lcom_v, _ = pool(200_000, 2, 5)
    pool_pscom_v, _ = pool(200_000, 4, 10)
    pool_ccom_v, _ = pool(100_000, 5, 12, inject="special requests", prob=0.01)
    pool_scom_v, _ = pool(50_000, 5, 12, inject="Customer Complaints",
                          prob=0.0005)
    pool_pcom_v, _ = pool(50_000, 2, 5)
    phone_nat = rng.integers(0, 25, 100_000)
    pool_phone_v = [str(u) for u in np.unique(_phone(rng, phone_nat))]
    # p_name pool: 2M 5-color names (spec formula, bounded distinct set)
    cw = np.array(COLORS)
    pidx = rng.integers(0, len(COLORS), (2_000_000, 5))
    pn = cw[pidx[:, 0]].astype(object)
    for j in range(1, 5):
        pn = np.char.add(np.char.add(pn.astype(str), " "), cw[pidx[:, j]])
    pool_pname_v = [str(u) for u in np.unique(pn)]
    del pn, pidx

    nation_names = [n for n, _ in NATIONS]
    nation_region = np.asarray([r for _, r in NATIONS])

    # ---------------- small tables ----------------
    rng = np.random.default_rng(4200)

    # region
    t_region = TableOut("region", 5)
    rname_v, rname_rank = rank_map(REGIONS)
    t_region.col("r_regionkey")[:] = np.arange(5)
    t_region.col("r_name", dict_values=rname_v)[:] = rname_rank[np.arange(5)]
    rcom_v, rcom_c = pool(5, 4, 10)
    t_region.col("r_comment", dict_values=rcom_v)[:] = rcom_c

    # nation
    t_nation = TableOut("nation", 25)
    nname_v, nname_rank = rank_map(nation_names)
    t_nation.col("n_nationkey")[:] = np.arange(25)
    t_nation.col("n_name", dict_values=nname_v)[:] = nname_rank[np.arange(25)]
    t_nation.col("n_regionkey")[:] = nation_region
    ncom_v, ncom_c = pool(25, 4, 10)
    t_nation.col("n_comment", dict_values=ncom_v)[:] = ncom_c

    # supplier
    log(f"supplier ({S} rows)")
    t_supp = TableOut("supplier", S)
    sk = np.arange(1, S + 1)
    s_nation = rng.integers(0, 25, S)
    s_names = list(np.char.add("Supplier#", np.char.zfill(sk.astype(str), 9)))
    t_supp.col("s_suppkey")[:] = sk
    t_supp.col("s_name", dict_values=s_names)[:] = np.arange(S)  # zfill => sorted
    t_supp.col("s_address", dict_values=pool_addr_v)[:] = rng.integers(
        0, len(pool_addr_v), S)
    t_supp.col("s_nationkey")[:] = s_nation
    s_phone_codes = rng.integers(0, len(pool_phone_v), S).astype(np.int32)
    t_supp.col("s_phone", dict_values=pool_phone_v)[:] = s_phone_codes
    t_supp.col("s_acctbal")[:] = rng.integers(-99999, 1000000, S)
    t_supp.col("s_comment", dict_values=pool_scom_v)[:] = rng.integers(
        0, len(pool_scom_v), S)

    # part
    log(f"part ({P} rows)")
    t_part = TableOut("part", P)
    pk = np.arange(1, P + 1)
    t_part.col("p_partkey")[:] = pk
    pname_codes = rng.integers(0, len(pool_pname_v), P).astype(np.int32)
    t_part.col("p_name", dict_values=pool_pname_v)[:] = pname_codes
    p_mfgr_i = rng.integers(1, 6, P)
    mfgr_v = [f"Manufacturer#{i}" for i in range(1, 6)]
    t_part.col("p_mfgr", dict_values=mfgr_v)[:] = p_mfgr_i - 1
    p_brand_y = rng.integers(1, 6, P)
    brand_v = [f"Brand#{m}{y}" for m in range(1, 6) for y in range(1, 6)]
    p_brand_code = ((p_mfgr_i - 1) * 5 + (p_brand_y - 1)).astype(np.int32)
    t_part.col("p_brand", dict_values=brand_v)[:] = p_brand_code
    type_vocab = [f"{a} {b} {c}" for a in TYPE_S1 for b in TYPE_S2
                  for c in TYPE_S3]
    tv_sorted, tv_rank = rank_map(type_vocab)
    i1 = rng.integers(0, 6, P)
    i2 = rng.integers(0, 5, P)
    i3 = rng.integers(0, 5, P)
    p_type_code = tv_rank[i1 * 25 + i2 * 5 + i3]
    t_part.col("p_type", dict_values=tv_sorted)[:] = p_type_code
    p_size = rng.integers(1, 51, P)
    t_part.col("p_size")[:] = p_size
    cont_vocab = [f"{a} {b}" for a in CONTAINER_S1 for b in CONTAINER_S2]
    cv_sorted, cv_rank = rank_map(cont_vocab)
    c1 = rng.integers(0, 5, P)
    c2 = rng.integers(0, 8, P)
    p_cont_code = cv_rank[c1 * 8 + c2]
    t_part.col("p_container", dict_values=cv_sorted)[:] = p_cont_code
    p_retail = (90000 + ((pk // 10) % 20001) + 100 * (pk % 1000)).astype(
        np.int64)
    t_part.col("p_retailprice")[:] = p_retail
    t_part.col("p_comment", dict_values=pool_pcom_v)[:] = rng.integers(
        0, len(pool_pcom_v), P)
    p_promo = (i1 == TYPE_S1.index("PROMO"))  # Q14 flag (by partkey-1)

    # partsupp
    log(f"partsupp ({P*4} rows)")
    t_ps = TableOut("partsupp", P * 4)
    ps_part = np.repeat(pk, 4)
    i4 = np.tile(np.arange(4), P)
    ps_supp = ((ps_part + i4 * (S // 4 + (ps_part - 1) // S)) % S) + 1
    t_ps.col("ps_partkey")[:] = ps_part
    t_ps.col("ps_suppkey")[:] = ps_supp
    t_ps.col("ps_availqty")[:] = rng.integers(1, 10_000, P * 4)
    t_ps.col("ps_supplycost")[:] = rng.integers(100, 100001, P * 4)
    t_ps.col("ps_comment", dict_values=pool_pscom_v)[:] = rng.integers(
        0, len(pool_pscom_v), P * 4)

    # customer
    log(f"customer ({C} rows)")
    t_cust = TableOut("customer", C)
    ck = np.arange(1, C + 1)
    c_nation = rng.integers(0, 25, C)
    t_cust.col("c_custkey")[:] = ck
    c_names = list(np.char.add("Customer#", np.char.zfill(ck.astype(str), 9)))
    t_cust.col("c_name", dict_values=c_names)[:] = np.arange(C)
    c_addr_codes = rng.integers(0, len(pool_addr_v), C).astype(np.int32)
    t_cust.col("c_address", dict_values=pool_addr_v)[:] = c_addr_codes
    t_cust.col("c_nationkey")[:] = c_nation
    c_phone_codes = rng.integers(0, len(pool_phone_v), C).astype(np.int32)
    t_cust.col("c_phone", dict_values=pool_phone_v)[:] = c_phone_codes
    c_acctbal = rng.integers(-99999, 1000000, C)
    t_cust.col("c_acctbal")[:] = c_acctbal
    seg_v, seg_rank = rank_map(SEGMENTS)
    c_seg_code = seg_rank[rng.integers(0, 5, C)]
    t_cust.col("c_mktsegment", dict_values=seg_v)[:] = c_seg_code
    c_com_codes = rng.integers(0, len(pool_ccom_v), C).astype(np.int32)
    t_cust.col("c_comment", dict_values=pool_ccom_v)[:] = c_com_codes

    log("small tables written")

    # ---------------- orders + lineitem (chunked) ----------------
    prio_v, prio_rank = rank_map(PRIORITIES)
    instr_v, instr_rank = rank_map(INSTRUCTS)
    mode_v, mode_rank = rank_map(MODES)
    clerk_v = [f"Clerk#{str(i).zfill(9)}" for i in range(1, n_clerks + 1)]
    status_v = ["F", "O", "P"]
    rf_v = ["A", "N", "R"]
    rf_map = np.array([0, 2, 1], np.int32)      # gen 0=A,1=R,2=N -> sorted
    ls_v = ["F", "O"]
    eligible = ck[ck % 3 != 0].astype(np.int64)

    # pass 1: chunk layout (lines_per is each chunk-rng's first draw)
    n_chunks = -(-O // chunk_orders)
    chunk_O = []
    chunk_L = []
    for ci in range(n_chunks):
        n_ord = min(chunk_orders, O - ci * chunk_orders)
        crng = np.random.default_rng(41000 + ci)
        chunk_O.append(n_ord)
        chunk_L.append(int(crng.integers(1, 8, n_ord).sum()))
    L_total = sum(chunk_L)
    log(f"pass1: {n_chunks} chunks, {O} orders, {L_total} lines")
    assert O * 4 <= INT32_MAX

    t_ord = TableOut("orders", O)
    for cname, dv in [("o_orderkey", None), ("o_custkey", None),
                      ("o_orderstatus", status_v), ("o_totalprice", None),
                      ("o_orderdate", None), ("o_orderpriority", prio_v),
                      ("o_clerk", clerk_v), ("o_shippriority", None),
                      ("o_comment", pool_ocom_v)]:
        t_ord.col(cname, dict_values=dv)

    t_li = TableOut("lineitem", L_total)
    for cname, dv in [("l_orderkey", None), ("l_partkey", None),
                      ("l_suppkey", None), ("l_linenumber", None),
                      ("l_quantity", None), ("l_extendedprice", None),
                      ("l_discount", None), ("l_tax", None),
                      ("l_returnflag", rf_v), ("l_linestatus", ls_v),
                      ("l_shipdate", None), ("l_commitdate", None),
                      ("l_receiptdate", None), ("l_shipinstruct", instr_v),
                      ("l_shipmode", mode_v), ("l_comment", pool_lcom_v)]:
        t_li.col(cname, dict_values=dv)

    # oracle state
    oc = {
        "q1": {}, "q6_rev": 0,
        "q3_ord": [], "q3_rev": [], "q3_date": [],
        "q4": np.zeros(5, np.int64),
        "q5": np.zeros(25, np.int64),
        "q7": np.zeros((2, 2), np.int64),       # (dir, year-1995)
        "q10_rev": np.zeros(C + 1, np.int64),
        "q12": np.zeros((len(mode_v), 2), np.int64),
        "q14_promo": 0, "q14_all": 0,
        "q18_ord": [], "q18_qty": [],
        "q19_rev": 0,
        "max_lines": 0,
    }

    # date cutoffs
    d_q1 = day("1998-12-01") - 90
    d_9401, d_9501 = day("1994-01-01"), day("1995-01-01")
    d_930701, d_931001 = day("1993-07-01"), day("1993-10-01")
    d_950315 = day("1995-03-15")
    d_9301001, d_940101 = day("1993-10-01"), day("1994-01-01")
    d_950101, d_961231 = day("1995-01-01"), day("1996-12-31")
    d_950901, d_951001 = day("1995-09-01"), day("1995-10-01")
    cutoff_rf = day("1995-06-17")
    seg_building = seg_v.index("BUILDING")
    asia = set(np.where(nation_region == REGIONS.index("ASIA"))[0].tolist())
    asia_mask = np.isin(np.arange(25), list(asia))
    i_fr = nation_names.index("FRANCE")
    i_de = nation_names.index("GERMANY")
    mode_mail, mode_ship = mode_v.index("MAIL"), mode_v.index("SHIP")
    mode_air = mode_v.index("AIR")
    prio_hi = {prio_v.index("1-URGENT"), prio_v.index("2-HIGH")}
    instr_dip = instr_v.index("DELIVER IN PERSON")
    b12 = brand_v.index("Brand#12")
    b23 = brand_v.index("Brand#23")
    b34 = brand_v.index("Brand#34")
    cont_sets = [
        {cv_sorted.index(x) for x in
         ("SM CASE", "SM BOX", "SM PACK", "SM PKG")},
        {cv_sorted.index(x) for x in
         ("MED BAG", "MED BOX", "MED PKG", "MED PACK")},
        {cv_sorted.index(x) for x in
         ("LG CASE", "LG BOX", "LG PACK", "LG PKG")},
    ]

    ord_base = 0
    li_base = 0
    for ci in range(n_chunks):
        n_ord, n_li = chunk_O[ci], chunk_L[ci]
        crng = np.random.default_rng(41000 + ci)
        lines_per = crng.integers(1, 8, n_ord)
        L = int(lines_per.sum())
        assert L == n_li
        o_cust = eligible[crng.integers(0, len(eligible), n_ord)]
        o_daynum = crng.integers(0, 2406, n_ord)
        o_prio = prio_rank[crng.integers(0, 5, n_ord)]
        o_clerk = crng.integers(1, n_clerks + 1, n_ord) - 1
        o_com = crng.integers(0, len(pool_ocom_v), n_ord)
        l_part = crng.integers(1, P + 1, L)
        li4 = crng.integers(0, 4, L)
        l_qty = crng.integers(1, 51, L).astype(np.int64)
        l_disc = crng.integers(0, 11, L).astype(np.int64)
        l_tax = crng.integers(0, 9, L).astype(np.int64)
        l_odate = np.repeat(o_daynum, lines_per)
        ship = l_odate + crng.integers(1, 122, L)
        commit = l_odate + crng.integers(30, 91, L)
        receipt = ship + crng.integers(1, 31, L)
        rf_rand = crng.random(L)
        instr = instr_rank[crng.integers(0, 4, L)]
        mode = mode_rank[crng.integers(0, 7, L)]
        l_com = crng.integers(0, len(pool_lcom_v), L)

        ok = (np.arange(ord_base + 1, ord_base + n_ord + 1,
                        dtype=np.int64) * 4)
        l_order = np.repeat(ok, lines_per)
        order_idx = np.repeat(np.arange(n_ord), lines_per)
        ends = np.cumsum(lines_per)
        l_lineno = np.arange(L) - np.repeat(ends - lines_per, lines_per) + 1
        l_supp = ((l_part + li4 * (S // 4 + (l_part - 1) // S)) % S) + 1
        retail = (90000 + ((l_part // 10) % 20001) +
                  100 * (l_part % 1000)).astype(np.int64)
        l_extp = l_qty * retail
        returnable = receipt <= cutoff_rf
        rf = np.where(returnable, np.where(rf_rand < 0.5, 0, 1), 2)
        ls_o = (ship > cutoff_rf)                    # False=F True=O

        # orders derived
        totals6 = np.zeros(n_ord, np.int64)
        np.add.at(totals6, order_idx, l_extp * (100 + l_tax) * (100 - l_disc))
        f_cnt = np.zeros(n_ord, np.int64)
        np.add.at(f_cnt, order_idx, (~ls_o).astype(np.int64))
        status = np.where(f_cnt == lines_per, 0,
                          np.where(f_cnt == 0, 1, 2))
        o_total = (totals6 + 5000) // 10000

        # ---- write slices ----
        osl = slice(ord_base, ord_base + n_ord)
        t_ord.arrays["o_orderkey"][osl] = ok
        t_ord.arrays["o_custkey"][osl] = o_cust
        t_ord.arrays["o_orderstatus"][osl] = status
        t_ord.arrays["o_totalprice"][osl] = o_total
        t_ord.arrays["o_orderdate"][osl] = _dates_from_daynum(o_daynum)
        t_ord.arrays["o_orderpriority"][osl] = o_prio
        t_ord.arrays["o_clerk"][osl] = o_clerk
        t_ord.arrays["o_shippriority"][osl] = 0
        t_ord.arrays["o_comment"][osl] = o_com
        lsl = slice(li_base, li_base + L)
        t_li.arrays["l_orderkey"][lsl] = l_order
        t_li.arrays["l_partkey"][lsl] = l_part
        t_li.arrays["l_suppkey"][lsl] = l_supp
        t_li.arrays["l_linenumber"][lsl] = l_lineno
        t_li.arrays["l_quantity"][lsl] = l_qty * 100
        t_li.arrays["l_extendedprice"][lsl] = l_extp
        t_li.arrays["l_discount"][lsl] = l_disc
        t_li.arrays["l_tax"][lsl] = l_tax
        t_li.arrays["l_returnflag"][lsl] = rf_map[rf]
        t_li.arrays["l_linestatus"][lsl] = ls_o.astype(np.int32)
        t_li.arrays["l_shipdate"][lsl] = _dates_from_daynum(ship)
        t_li.arrays["l_commitdate"][lsl] = _dates_from_daynum(commit)
        t_li.arrays["l_receiptdate"][lsl] = _dates_from_daynum(receipt)
        t_li.arrays["l_shipinstruct"][lsl] = instr
        t_li.arrays["l_shipmode"][lsl] = mode
        t_li.arrays["l_comment"][lsl] = l_com

        # ---- oracle ----
        rev4 = l_extp * (100 - l_disc)               # scale-4
        # Q1
        in1 = ship <= d_q1
        for rv, rs in ((0, "A"), (1, "R"), (2, "N")):
            for lv, lss in ((False, "F"), (True, "O")):
                m = in1 & (rf == rv) & (ls_o == lv)
                if not m.any():
                    continue
                g = oc["q1"].setdefault((rs, lss), [0, 0, 0, 0, 0, 0])
                g[0] += int(m.sum())
                g[1] += exact_sum(l_qty[m] * 100)
                g[2] += exact_sum(l_extp[m])
                g[3] += exact_sum(rev4[m])
                g[4] += exact_sum(rev4[m] * (100 + l_tax[m]))
                g[5] += exact_sum(l_disc[m])
        # Q6
        m6 = ((ship >= d_9401) & (ship < d_9501) & (l_disc >= 5) &
              (l_disc <= 7) & (l_qty < 24))
        oc["q6_rev"] += exact_sum(l_extp[m6] * l_disc[m6])
        # Q3: BUILDING customers, orderdate<3/15, shipdate>3/15
        o_bldg = (c_seg_code[o_cust - 1] == seg_building) & \
            (o_daynum < d_950315)
        ml = o_bldg[order_idx] & (ship > d_950315)
        if ml.any():
            r3 = np.zeros(n_ord, np.int64)
            np.add.at(r3, order_idx[ml], rev4[ml])
            hit = r3 > 0
            oc["q3_ord"].append(ok[hit].astype(np.int64))
            oc["q3_rev"].append(r3[hit])
            oc["q3_date"].append(o_daynum[hit].astype(np.int32))
        # Q4: orders in window with any commit<receipt line
        m4o = (o_daynum >= d_930701) & (o_daynum < d_931001)
        late = np.zeros(n_ord, np.int64)
        np.add.at(late, order_idx, (commit < receipt).astype(np.int64))
        m4 = m4o & (late > 0)
        oc["q4"] += np.bincount(o_prio[m4], minlength=5)
        # Q5: asia, c_nat == s_nat, orderdate in 1994
        c_nat_l = c_nation[o_cust - 1][order_idx]
        s_nat_l = s_nation[l_supp - 1]
        m5 = ((o_daynum >= d_9401) & (o_daynum < d_9501))[order_idx] & \
            (c_nat_l == s_nat_l) & asia_mask[s_nat_l]
        np.add.at(oc["q5"], s_nat_l[m5], rev4[m5])
        # Q7: FR<->DE pairs, shipdate 1995..1996
        m7s = (ship >= d_950101) & (ship <= d_961231)
        year1 = ship >= day("1996-01-01")
        d0 = m7s & (s_nat_l == i_fr) & (c_nat_l == i_de)
        d1 = m7s & (s_nat_l == i_de) & (c_nat_l == i_fr)
        for di, m in ((0, d0), (1, d1)):
            oc["q7"][di, 0] += exact_sum(rev4[m & ~year1])
            oc["q7"][di, 1] += exact_sum(rev4[m & year1])
        # Q10: returnflag R, orderdate in [1993-10-01, 1994-01-01)
        m10 = ((o_daynum >= d_9301001) & (o_daynum < d_940101))[order_idx] & \
            (rf == 1)
        np.add.at(oc["q10_rev"], np.repeat(o_cust, lines_per)[m10], rev4[m10])
        # Q12
        m12 = (np.isin(mode, [mode_mail, mode_ship]) & (commit < receipt) &
               (ship < commit) & (receipt >= d_9401) & (receipt < d_9501))
        hi12 = np.isin(o_prio, list(prio_hi))[order_idx]
        np.add.at(oc["q12"], (mode[m12], (~hi12[m12]).astype(np.int64)), 1)
        # Q14
        m14 = (ship >= d_950901) & (ship < d_951001)
        promo_l = p_promo[l_part - 1]
        oc["q14_promo"] += exact_sum(rev4[m14 & promo_l])
        oc["q14_all"] += exact_sum(rev4[m14])
        # Q18: orders with sum(qty) > 300
        q18s = np.zeros(n_ord, np.int64)
        np.add.at(q18s, order_idx, l_qty)
        m18 = q18s > 300
        if m18.any():
            oc["q18_ord"].append(
                np.stack([ok[m18], o_cust[m18], o_daynum[m18],
                          o_total[m18]], axis=1))
            oc["q18_qty"].append(q18s[m18])
        # Q19
        base19 = (mode == mode_air) & (instr == instr_dip)
        pb = p_brand_code[l_part - 1]
        pc = p_cont_code[l_part - 1]
        psz = p_size[l_part - 1]
        m19 = base19 & (
            ((pb == b12) & np.isin(pc, list(cont_sets[0])) & (l_qty >= 1) &
             (l_qty <= 11) & (psz >= 1) & (psz <= 5)) |
            ((pb == b23) & np.isin(pc, list(cont_sets[1])) & (l_qty >= 10) &
             (l_qty <= 20) & (psz >= 1) & (psz <= 10)) |
            ((pb == b34) & np.isin(pc, list(cont_sets[2])) & (l_qty >= 20) &
             (l_qty <= 30) & (psz >= 1) & (psz <= 15)))
        oc["q19_rev"] += exact_sum(rev4[m19])

        oc["max_lines"] = max(oc["max_lines"], int(lines_per.max()))
        ord_base += n_ord
        li_base += L
        log(f"chunk {ci+1}/{n_chunks}: {ord_base}/{O} orders, {L} lines")

    # ---------------- finalize oracle ----------------
    log("finalizing oracle")
    oracle = {"rows": {"lineitem": L_total, "orders": O, "customer": C,
                       "part": P, "partsupp": P * 4, "supplier": S,
                       "nation": 25, "region": 5}}
    q1rows = []
    for (rs, lss) in sorted(oc["q1"]):
        n, sq, sp, sd4, sc6, sdisc = oc["q1"][(rs, lss)]
        q1rows.append([rs, lss, sq / 100, sp / 100, sd4 / 10000,
                       sc6 / 1000000, sq / 100 / n, sp / 100 / n,
                       sdisc / 100 / n, n])
    oracle["q1"] = q1rows
    oracle["q6"] = [[oc["q6_rev"] / 10000]]
    # Q3 top10 by revenue desc, date asc, orderkey asc
    if oc["q3_ord"]:
        o3 = np.concatenate(oc["q3_ord"])
        r3 = np.concatenate(oc["q3_rev"])
        dt3 = np.concatenate(oc["q3_date"])
        idx = np.lexsort((o3, dt3, -r3))[:10]
        oracle["q3"] = [[int(o3[i]), r3[i] / 10000, iso_of_daynum(dt3[i]), 0]
                        for i in idx]
    else:
        oracle["q3"] = []
    oracle["q4"] = [[prio_v[i], int(oc["q4"][i])] for i in range(5)
                    if oc["q4"][i] > 0]
    n5 = [(nation_names[i], int(oc["q5"][i])) for i in range(25)
          if oc["q5"][i] > 0]
    n5.sort(key=lambda x: -x[1])
    oracle["q5"] = [[n, v / 10000] for n, v in n5]
    q7rows = []
    for di, (sn, cn) in enumerate(((i_fr, i_de), (i_de, i_fr))):
        for yi, yr in enumerate((1995, 1996)):
            q7rows.append([nation_names[sn], nation_names[cn], yr,
                           int(oc["q7"][di, yi]) / 10000])
    q7rows.sort(key=lambda r: (r[0], r[1], r[2]))
    oracle["q7"] = q7rows
    # Q10 top20 by revenue desc, custkey asc
    rev10 = oc["q10_rev"]
    nz = np.nonzero(rev10)[0]
    top = nz[np.lexsort((nz, -rev10[nz]))[:20]]
    oracle["q10"] = [
        [int(cki), c_names[cki - 1], int(rev10[cki]) / 10000,
         int(c_acctbal[cki - 1]) / 100, nation_names[c_nation[cki - 1]],
         pool_addr_v[c_addr_codes[cki - 1]],
         pool_phone_v[c_phone_codes[cki - 1]],
         pool_ccom_v[c_com_codes[cki - 1]]]
        for cki in top]
    oracle["q12"] = [[mode_v[m], int(oc["q12"][m, 0]), int(oc["q12"][m, 1])]
                     for m in sorted((mode_mail, mode_ship))]
    oracle["q14"] = [[100.0 * (oc["q14_promo"] / 10000) /
                      (oc["q14_all"] / 10000)]]
    # Q18 top100 by totalprice desc, orderdate asc, orderkey asc
    if oc["q18_ord"]:
        a18 = np.concatenate(oc["q18_ord"])       # ok, cust, daynum, total
        q18 = np.concatenate(oc["q18_qty"])
        idx = np.lexsort((a18[:, 0], a18[:, 2], -a18[:, 3]))[:100]
        oracle["q18"] = [
            [c_names[int(a18[i, 1]) - 1], int(a18[i, 1]), int(a18[i, 0]),
             iso_of_daynum(a18[i, 2]), int(a18[i, 3]) / 100, int(q18[i])]
            for i in idx]
    else:
        oracle["q18"] = []
    oracle["q19"] = [[oc["q19_rev"] / 10000]]

    # ---------------- stats ----------------
    log("computing stats")
    known = {
        "region": {}, "nation": {},
        "supplier": {"s_suppkey": (S, 1), "s_name": (S, 1)},
        "part": {"p_partkey": (P, 1)},
        "partsupp": {"__unique_pairs__": [["ps_partkey", "ps_suppkey"]]},
        "customer": {"c_custkey": (C, 1), "c_name": (C, 1)},
        "orders": {"o_orderkey": (O, 1)},
        "lineitem": {"l_orderkey": (O, oc["max_lines"])},
    }
    tables = {}
    stats = {}
    for t in (t_region, t_nation, t_supp, t_part, t_ps, t_cust, t_ord, t_li):
        tables[t.name] = t
        stats[t.name] = column_stats(t, known.get(t.name, {}))
    log("tables complete")
    return tables, stats, oracle


def load_tables(db, tables, stats):
    """Create the 8 TPC-H tables in `db` and load `generate`'s tables into
    them with its exact statistics."""
    from quickstep_tpu_torch.bench.tpch import _ddl_type
    for name, schema in TPCH_SCHEMAS.items():
        cols = ", ".join(
            f"{cname} {_ddl_type(t)} NOT NULL" for cname, t in schema)
        db.execute(f"CREATE TABLE {name} ({cols})")
        rel = db.catalog.default_database.get_relation(name)
        rel.set_data(tables[name].table_data())
        rel.statistics = _stats_from_json(stats[name])


def extra_oracles(tables):
    """Exact oracles of Q9, Q16 and Q21 (the tool's oracle has none), from
    the columns of `generate`'s tables with numpy integer arithmetic, in
    the form of `generate`'s oracle."""
    nat = tables["nation"]
    nation_of_key = [nat.dicts["n_name"][c] for c in nat.arrays["n_name"]]
    return {"q9": _oracle_q9(tables, nation_of_key),
            "q16": _oracle_q16(tables),
            "q21": _oracle_q21(tables, nation_of_key)}


def _oracle_q9(tables, nation_of_key):
    """Profit per (supplier nation, order year) of the lines of parts whose
    name holds 'green', in scale-4 units: l_extendedprice * (1 - l_discount)
    - ps_supplycost * l_quantity, summed over every partsupp row of the
    line's (partkey, suppkey)."""
    li, ps, part = tables["lineitem"], tables["partsupp"], tables["part"]
    green = np.array(["green" in v for v in part.dicts["p_name"]])
    # p_partkey is 1..P in row order
    m = green[part.arrays["p_name"]][li.arrays["l_partkey"] - 1]
    pk = li.arrays["l_partkey"][m].astype(np.int64)
    sk = li.arrays["l_suppkey"][m]
    rev4 = li.arrays["l_extendedprice"][m].astype(np.int64) * (
        100 - li.arrays["l_discount"][m].astype(np.int64))
    qty = li.arrays["l_quantity"][m].astype(np.int64)
    year = (tables["orders"].arrays["o_orderdate"][
        li.arrays["l_orderkey"][m] // 4 - 1] >> 9).astype(np.int64)
    nation = tables["supplier"].arrays["s_nationkey"][sk - 1].astype(np.int64)
    group = nation * 10_000 + year
    totals = {}
    # partsupp holds 4 rows per part, rows 4 (partkey - 1) + j
    for j in range(4):
        row = (pk - 1) * 4 + j
        hit = ps.arrays["ps_suppkey"][row] == sk
        amount = rev4[hit] - ps.arrays["ps_supplycost"][row][hit].astype(
            np.int64) * qty[hit]
        g, inv = np.unique(group[hit], return_inverse=True)
        sums = np.zeros(len(g), np.int64)
        np.add.at(sums, inv, amount)
        for gi, v in zip(g.tolist(), sums.tolist()):
            totals[gi] = totals.get(gi, 0) + v
    rows = [[nation_of_key[g // 10_000], g % 10_000, v / 10000]
            for g, v in totals.items()]
    rows.sort(key=lambda r: (r[0], -r[1]))
    return rows


def _oracle_q16(tables):
    """Distinct suppliers per (brand, type, size) of the parts not of
    Brand#45, not of a MEDIUM POLISHED type and of one of 8 sizes, over the
    suppliers without a Customer...Complaints comment."""
    ps, part, supp = tables["partsupp"], tables["part"], tables["supplier"]
    brands, types = part.dicts["p_brand"], part.dicts["p_type"]
    brand = part.arrays["p_brand"].astype(np.int64)
    ptype = part.arrays["p_type"].astype(np.int64)
    size = part.arrays["p_size"].astype(np.int64)
    part_ok = ((brand != brands.index("Brand#45")) &
               ~np.array([t.startswith("MEDIUM POLISHED")
                          for t in types])[ptype] &
               np.isin(size, [49, 14, 23, 45, 19, 3, 36, 9]))
    complaint = np.array(["Customer" in c and
                          "Complaints" in c[c.index("Customer") + 8:]
                          for c in supp.dicts["s_comment"]])
    bad_supp = complaint[supp.arrays["s_comment"]]    # by suppkey - 1
    pk = ps.arrays["ps_partkey"] - 1
    sk = ps.arrays["ps_suppkey"].astype(np.int64)
    ok = part_ok[pk] & ~bad_supp[sk - 1]
    group = (brand[pk[ok]] * len(types) + ptype[pk[ok]]) * 51 + size[pk[ok]]
    n_supp = len(supp.arrays["s_suppkey"]) + 1
    pairs = np.unique(group * n_supp + sk[ok])
    g, cnt = np.unique(pairs // n_supp, return_counts=True)
    b, t, sz = g // 51 // len(types), g // 51 % len(types), g % 51
    order = np.lexsort((sz, t, b, -cnt))
    return [[brands[b[i]], types[t[i]], int(sz[i]), int(cnt[i])]
            for i in order]


def _oracle_q21(tables, nation_of_key):
    """Suppliers of SAUDI ARABIA with the number of their late lines in
    finished orders where another supplier shipped a line and no other
    supplier was late; the first 100 by count descending, then name."""
    li, ords, supp = tables["lineitem"], tables["orders"], tables["supplier"]
    okey = li.arrays["l_orderkey"]
    sk = li.arrays["l_suppkey"]
    late = li.arrays["l_receiptdate"] > li.arrays["l_commitdate"]
    # lines of one order are contiguous
    start = np.flatnonzero(np.r_[True, okey[1:] != okey[:-1]])
    runs = np.diff(np.r_[start, len(okey)])
    smin = np.repeat(np.minimum.reduceat(sk, start), runs)
    smax = np.repeat(np.maximum.reduceat(sk, start), runs)
    other = (smin != sk) | (smax != sk)
    lmin = np.repeat(np.minimum.reduceat(
        np.where(late, sk, INT32_MAX), start), runs)
    lmax = np.repeat(np.maximum.reduceat(np.where(late, sk, -1), start), runs)
    late_other = (lmax >= 0) & ((lmin != sk) | (lmax != sk))
    finished = ords.arrays["o_orderstatus"][okey // 4 - 1] == \
        ords.dicts["o_orderstatus"].index("F")
    saudi = np.array([nation_of_key[n] == "SAUDI ARABIA"
                      for n in range(len(nation_of_key))])
    m = late & finished & other & ~late_other & \
        saudi[supp.arrays["s_nationkey"][sk - 1]]
    counts = np.bincount(sk[m], minlength=len(supp.arrays["s_suppkey"]) + 1)
    names = supp.dicts["s_name"]
    keys = np.flatnonzero(counts)
    name_codes = supp.arrays["s_name"][keys - 1]
    order = np.lexsort((name_codes, -counts[keys]))[:100]
    return [[str(names[name_codes[i]]), int(counts[keys[i]])] for i in order]


def load_tpch_full(db, scale, log=None, windows=False):
    """Create the 8 TPC-H tables in `db` and load them at `scale` with exact
    statistics; returns the oracle (see `generate`) with `extra_oracles`,
    and with `window_oracles` when `windows`."""
    tables, stats, oracle = generate(scale, log)
    load_tables(db, tables, stats)
    oracle.update(extra_oracles(tables))
    if windows:
        oracle.update(window_oracles(tables))
    return oracle


# Window queries over lineitem and orders in the shapes of TPC-DS's window
# queries (partition totals, running totals and counts, moving averages,
# RANGE frames over dates, ROWS minima). Each is wrapped in a scalar
# aggregate, so that one row comes back.
WINDOW_QUERIES = {
    # share of partition: 100 K partitions of ~600 rows at SF10
    "w1": """select count(*), sum(s), min(s) from (
               select l_suppkey, sum(l_quantity) over (partition by l_suppkey)
                 as s from lineitem) t""",
    # running count with peers: 15 M partitions of 1-7 rows
    "w2": """select count(*), sum(c), max(c) from (
               select count(*) over (partition by l_orderkey
                                     order by l_linenumber) as c
               from lineitem) t""",
    # running total, no partition: one segment of 15 M rows
    "w3": """select count(*), max(r), min(r) from (
               select sum(o_totalprice) over (order by o_orderdate) as r
               from orders) t""",
    # moving average, ROWS: 2 M partitions of ~30 rows
    "w4": """select count(*), sum(a), max(a) from (
               select avg(l_extendedprice) over (
                 partition by l_partkey
                 order by l_shipdate, l_orderkey, l_linenumber
                 rows between 3 preceding and current row) as a
               from lineitem) t""",
    # RANGE over the date's code, MAX and COUNT: 100 K partitions
    "w5": """select count(*), sum(m), sum(c) from (
               select max(l_quantity) over (
                        partition by l_suppkey order by l_shipdate
                        range between 30 preceding and 30 following) as m,
                      count(*) over (
                        partition by l_suppkey order by l_shipdate
                        range between 30 preceding and 30 following) as c
               from lineitem) t""",
    # ROWS MIN: 15 M partitions
    "w6": """select count(*), sum(m) from (
               select min(l_extendedprice) over (
                 partition by l_orderkey order by l_linenumber
                 rows between 1 preceding and 1 following) as m
               from lineitem) t""",
}
# The window queries' float results: sums of many float64 terms in another
# order than the oracle's exact integer arithmetic.
WINDOW_REL_TOL = 1e-9


def _range_max(vals, lo, hi):
    """max(vals[lo[i]:hi[i] + 1]) for every i with hi >= lo: a sparse table
    with the levels the longest range needs."""
    length = hi - lo + 1
    levels = [vals]
    while 2 ** len(levels) <= length.max():
        prev, k = levels[-1], 2 ** (len(levels) - 1)
        levels.append(np.maximum(prev, np.concatenate([prev[k:], prev[-k:]])))
    j = np.floor(np.log2(length)).astype(np.int64)
    out = np.empty(len(vals), vals.dtype)
    for k, level in enumerate(levels):
        m = j == k
        out[m] = np.maximum(level[lo[m]], level[hi[m] - 2 ** k + 1])
    return out


def window_oracles(tables):
    """Exact oracles of WINDOW_QUERIES from the generator's columns, with
    numpy integer arithmetic (DECIMALs in their scaled integers, DATEs in
    their codes): one sort of a packed int64 key where a query needs one.
    The lines of an order are contiguous and in line-number order."""
    li, ords = tables["lineitem"], tables["orders"]
    okey = li.arrays["l_orderkey"]
    lineno = li.arrays["l_linenumber"].astype(np.int64)
    n = len(okey)
    first = np.r_[True, okey[1:] != okey[:-1]]
    last = np.r_[okey[1:] != okey[:-1], True]
    qty = li.arrays["l_quantity"].astype(np.int64)
    price = li.arrays["l_extendedprice"].astype(np.int64)
    supp = li.arrays["l_suppkey"].astype(np.int64)
    out = {}
    # w1: each line reads its supplier's quantity total
    cnt = np.bincount(supp)
    qsum = np.rint(np.bincount(supp, weights=qty)).astype(np.int64)
    has = cnt > 0
    out["w1"] = [[n, int((cnt[has] * qsum[has]).sum()) / 100,
                  int(qsum[has].min()) / 100]]
    # w2: line numbers are distinct within an order, so the running count
    # with peers is the line number
    out["w2"] = [[n, int(lineno.sum()), int(lineno.max())]]
    # w3: each order reads the total of the orders on or before its date
    odate = ords.arrays["o_orderdate"].astype(np.int64)
    total = ords.arrays["o_totalprice"].astype(np.int64)
    dates, inv = np.unique(odate, return_inverse=True)
    upto = np.cumsum(np.rint(np.bincount(inv, weights=total)).astype(
        np.int64))
    out["w3"] = [[len(odate), int(upto[-1]) / 100, int(upto[0]) / 100]]
    # w4: rows sorted by (partkey, shipdate code, row): the row order is
    # (orderkey, linenumber) order
    ship = li.arrays["l_shipdate"].astype(np.int64)
    d0, span = int(ship.min()), int(ship.max() - ship.min()) + 1
    part = li.arrays["l_partkey"].astype(np.int64)
    rows = np.sort((part * span + (ship - d0)) * n + np.arange(n)) % n
    seg_first = np.maximum.accumulate(np.where(
        np.r_[True, part[rows][1:] != part[rows][:-1]], np.arange(n), 0))
    lo = np.maximum(seg_first, np.arange(n) - 3)
    csum = np.r_[0, np.cumsum(price[rows])]
    avg = (csum[np.arange(n) + 1] - csum[lo]) / (
        100.0 * (np.arange(n) - lo + 1))
    out["w4"] = [[n, float(np.sum(avg)), float(avg.max())]]
    del rows, seg_first, lo, csum, avg
    # w5: rows sorted by (suppkey, shipdate code); frames of +-30 codes
    span5 = span + 64
    key = supp * span5 + (ship - d0)
    order = np.argsort(key)
    skey = key[order]
    lo = np.searchsorted(skey, skey - 30, "left")
    hi = np.searchsorted(skey, skey + 30, "right") - 1
    m = _range_max(qty[order], lo, hi)
    out["w5"] = [[n, int(m.sum()) / 100, int((hi - lo + 1).sum())]]
    del key, order, skey, lo, hi, m
    # w6: ROWS 1 PRECEDING .. 1 FOLLOWING inside each order
    prev = np.where(first, price, np.r_[price[:1], price[:-1]])
    nxt = np.where(last, price, np.r_[price[1:], price[-1:]])
    out["w6"] = [[n, int(np.minimum(np.minimum(prev, price), nxt).sum())
                  / 100]]
    return out


# Relative tolerance of a float result against the oracle, which divides
# exact integer sums once; integers, strings and dates must be equal.
ORACLE_REL_TOL = 1e-12


def check_rows(q, rows, oracle, rel_tol=ORACLE_REL_TOL) -> None:
    """Raise AssertionError unless `rows`, the result of TPC-H query `q`
    (with bench/tpch.py's tiebreaks) or of WINDOW_QUERIES[q] (a name), are
    the oracle's rows, floats within rel_tol."""
    name = q if isinstance(q, str) else f"q{q}"
    want = oracle[name]
    if len(rows) != len(want):
        raise AssertionError(f"{name}: {len(rows)} rows, oracle {len(want)}")
    for i, (got_row, want_row) in enumerate(zip(rows, want)):
        ok = len(got_row) == len(want_row)
        for g, w in zip(got_row, want_row):
            if isinstance(w, float):
                ok = ok and isinstance(g, (int, float)) and math.isclose(
                    g, w, rel_tol=rel_tol, abs_tol=0.0)
            else:
                ok = ok and g == w
        if not ok:
            raise AssertionError(f"{name} row {i}: {tuple(got_row)} != "
                                 f"oracle {tuple(want_row)}")


if __name__ == "__main__":
    _t0 = time.perf_counter()
    _tables, _stats, _oracle = generate(
        float(sys.argv[1]) if len(sys.argv) > 1 else 1.0)
    print(f"{_oracle['rows']} in {time.perf_counter() - _t0:.1f} s")
