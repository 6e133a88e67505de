# Copied from tools/sf100_fullgen.py; imports renamed, REPO_ROOT one level up, the oracle's second copy written to the temporary directory (TMPDIR).
"""Full 8-table SF100 TPC-H store + streaming exact oracle (VERDICT r5 #5).

Extends tools/sf100_gen.py (lineitem-only) to the complete schema so
join-bearing queries run at SF100. Same distributions/formulas as
quickstep_tpu_torch.bench.tpchgen, generated in bounded-RAM chunks directly into
the catalog's on-disk layout (catalog.json + per-column .npy + .dict.json,
mirroring quickstep_tpu/catalog/catalog.py save()) via preallocated
np.lib.format.open_memmap columns — nothing is ever held whole in RAM and a
crash resumes at the last completed chunk.

SF100-specific text policy (documented deviation, like the reference's
dbgen -T options trade fidelity for time): per-row-identity strings
(c_name, s_name, o_clerk) are real, everything free-text (comments,
addresses, phones, p_name) is drawn from a bounded pool of distinct strings
so ordered dictionaries stay loadable; LIKE-pattern injection rates match
tpchgen so pattern predicates keep their selectivity.

While generating, an EXACT integer oracle is accumulated with numpy int64 +
big-int splitting for Q1,3,4,5,6,7,10,12,14,18,19 — every one of these is
computable streamingly because a chunk holds whole orders (lineitem rows
only join orders in their own chunk) and all dimension tables fit in RAM.
Written to <outdir>/oracle.json (+ /tmp/sf100_full_oracle.json).

    python -m quickstep_tpu_torch.bench.sf100_fullgen [scale=100] \
        [chunk_orders=10000000] [outdir]
"""

import datetime as dt
import json
import os
import pickle
import sys
import tempfile
import time

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from quickstep_tpu_torch.bench.tpchgen import (  # noqa: E402
    _dates_from_daynum, _text_column, _phone, _EPOCH,
    REGIONS, NATIONS, SEGMENTS, PRIORITIES, INSTRUCTS, MODES,
    TYPE_S1, TYPE_S2, TYPE_S3, CONTAINER_S1, CONTAINER_S2, COLORS)
from quickstep_tpu_torch.types import TypeID  # noqa: E402
from quickstep_tpu_torch.types.datetime_util import date_encode  # noqa: E402

INT32_MAX = 2**31 - 1


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
    """One table's on-disk columns in the catalog layout."""

    def __init__(self, outdir, name, n_rows):
        self.dir = os.path.join(outdir, "default", name)
        os.makedirs(self.dir, exist_ok=True)
        self.name = name
        self.n = n_rows
        self.attrs = []          # catalog.json attribute entries
        self.dicts = {}          # col -> sorted values list
        self.mmaps = {}

    def col(self, cname, tid, length=0, precision=0, scale=0, dict_values=None):
        self.attrs.append({"name": cname, "type_id": int(tid),
                           "nullable": False, "length": length,
                           "precision": precision, "scale": scale})
        p = os.path.join(self.dir, f"{cname}.npy")
        if os.path.exists(p):
            # resume: reopen in place (w+ would zero completed chunks)
            m = np.load(p, mmap_mode="r+")
            if m.shape == (self.n,) and m.dtype == np.int32:
                self.mmaps[cname] = m
            else:
                self.mmaps[cname] = np.lib.format.open_memmap(
                    p, mode="w+", dtype=np.int32, shape=(self.n,))
        else:
            self.mmaps[cname] = np.lib.format.open_memmap(
                p, mode="w+", dtype=np.int32, shape=(self.n,))
        if dict_values is not None:
            self.dicts[cname] = dict_values
            with open(os.path.join(self.dir, f"{cname}.dict.json"), "w") as f:
                json.dump(dict_values, f)
        return self.mmaps[cname]

    def reopen(self):
        for a in self.attrs:
            cname = a["name"]
            self.mmaps[cname] = np.load(
                os.path.join(self.dir, f"{cname}.npy"), mmap_mode="r+")


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
    for a in t.attrs:
        cname = a["name"]
        arr = t.mmaps[cname]
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


def main():
    scale = float(sys.argv[1]) if len(sys.argv) > 1 else 100.0
    chunk_orders = int(sys.argv[2]) if len(sys.argv) > 2 else 10_000_000
    outdir = sys.argv[3] if len(sys.argv) > 3 else os.path.join(
        REPO_ROOT, "data/tpch_sf100")
    t0 = time.time()
    S = max(int(10_000 * scale), 10)
    P = max(int(200_000 * scale), 200)
    C = max(int(150_000 * scale), 150)
    O = max(int(1_500_000 * scale), 1500)
    n_clerks = max(int(1000 * scale), 10)
    MONEY = dict(tid=TypeID.DECIMAL, precision=9, scale=2)

    def log(msg):
        print(f"[{time.time()-t0:7.0f}s] {msg}", flush=True)

    state_path = os.path.join(outdir, "_gen_state.pkl")
    os.makedirs(outdir, exist_ok=True)

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
    marker = os.path.join(outdir, "_small_done")
    small_stats = {}
    rng = np.random.default_rng(4200)

    # region
    t_region = TableOut(outdir, "region", 5)
    rname_v, rname_rank = rank_map(REGIONS)
    t_region.col("r_regionkey", TypeID.INT)[:] = np.arange(5)
    t_region.col("r_name", TypeID.CHAR, length=25,
                 dict_values=rname_v)[:] = rname_rank[np.arange(5)]
    rcom_v, rcom_c = pool(5, 4, 10)
    t_region.col("r_comment", TypeID.VARCHAR, length=152,
                 dict_values=rcom_v)[:] = rcom_c

    # nation
    t_nation = TableOut(outdir, "nation", 25)
    nname_v, nname_rank = rank_map(nation_names)
    t_nation.col("n_nationkey", TypeID.INT)[:] = np.arange(25)
    t_nation.col("n_name", TypeID.CHAR, length=25,
                 dict_values=nname_v)[:] = nname_rank[np.arange(25)]
    t_nation.col("n_regionkey", TypeID.INT)[:] = nation_region
    ncom_v, ncom_c = pool(25, 4, 10)
    t_nation.col("n_comment", TypeID.VARCHAR, length=152,
                 dict_values=ncom_v)[:] = ncom_c

    # supplier
    log(f"supplier ({S} rows)")
    t_supp = TableOut(outdir, "supplier", S)
    sk = np.arange(1, S + 1)
    s_nation = rng.integers(0, 25, S)
    s_names = list(np.char.add("Supplier#", np.char.zfill(sk.astype(str), 9)))
    t_supp.col("s_suppkey", TypeID.INT)[:] = sk
    t_supp.col("s_name", TypeID.CHAR, length=25,
               dict_values=s_names)[:] = np.arange(S)   # zfill => sorted
    t_supp.col("s_address", TypeID.VARCHAR, length=40,
               dict_values=pool_addr_v)[:] = rng.integers(
        0, len(pool_addr_v), S)
    t_supp.col("s_nationkey", TypeID.INT)[:] = s_nation
    s_phone_codes = rng.integers(0, len(pool_phone_v), S).astype(np.int32)
    t_supp.col("s_phone", TypeID.CHAR, length=15,
               dict_values=pool_phone_v)[:] = s_phone_codes
    t_supp.col("s_acctbal", **MONEY)[:] = rng.integers(-99999, 1000000, S)
    t_supp.col("s_comment", TypeID.VARCHAR, length=101,
               dict_values=pool_scom_v)[:] = rng.integers(
        0, len(pool_scom_v), S)

    # part
    log(f"part ({P} rows)")
    t_part = TableOut(outdir, "part", P)
    pk = np.arange(1, P + 1)
    t_part.col("p_partkey", TypeID.INT)[:] = pk
    pname_codes = rng.integers(0, len(pool_pname_v), P).astype(np.int32)
    t_part.col("p_name", TypeID.VARCHAR, length=55,
               dict_values=pool_pname_v)[:] = pname_codes
    p_mfgr_i = rng.integers(1, 6, P)
    mfgr_v = [f"Manufacturer#{i}" for i in range(1, 6)]
    t_part.col("p_mfgr", TypeID.CHAR, length=25,
               dict_values=mfgr_v)[:] = p_mfgr_i - 1
    p_brand_y = rng.integers(1, 6, P)
    brand_v = [f"Brand#{m}{y}" for m in range(1, 6) for y in range(1, 6)]
    p_brand_code = ((p_mfgr_i - 1) * 5 + (p_brand_y - 1)).astype(np.int32)
    t_part.col("p_brand", TypeID.CHAR, length=10,
               dict_values=brand_v)[:] = p_brand_code
    type_vocab = [f"{a} {b} {c}" for a in TYPE_S1 for b in TYPE_S2
                  for c in TYPE_S3]
    tv_sorted, tv_rank = rank_map(type_vocab)
    i1 = rng.integers(0, 6, P)
    i2 = rng.integers(0, 5, P)
    i3 = rng.integers(0, 5, P)
    p_type_code = tv_rank[i1 * 25 + i2 * 5 + i3]
    t_part.col("p_type", TypeID.VARCHAR, length=25,
               dict_values=tv_sorted)[:] = p_type_code
    p_size = rng.integers(1, 51, P)
    t_part.col("p_size", TypeID.INT)[:] = p_size
    cont_vocab = [f"{a} {b}" for a in CONTAINER_S1 for b in CONTAINER_S2]
    cv_sorted, cv_rank = rank_map(cont_vocab)
    c1 = rng.integers(0, 5, P)
    c2 = rng.integers(0, 8, P)
    p_cont_code = cv_rank[c1 * 8 + c2]
    t_part.col("p_container", TypeID.CHAR, length=10,
               dict_values=cv_sorted)[:] = p_cont_code
    p_retail = (90000 + ((pk // 10) % 20001) + 100 * (pk % 1000)).astype(
        np.int64)
    t_part.col("p_retailprice", **MONEY)[:] = p_retail
    t_part.col("p_comment", TypeID.VARCHAR, length=23,
               dict_values=pool_pcom_v)[:] = rng.integers(
        0, len(pool_pcom_v), P)
    p_promo = (i1 == TYPE_S1.index("PROMO"))  # Q14 flag (by partkey-1)

    # partsupp
    log(f"partsupp ({P*4} rows)")
    t_ps = TableOut(outdir, "partsupp", P * 4)
    ps_part = np.repeat(pk, 4)
    i4 = np.tile(np.arange(4), P)
    ps_supp = ((ps_part + i4 * (S // 4 + (ps_part - 1) // S)) % S) + 1
    t_ps.col("ps_partkey", TypeID.INT)[:] = ps_part
    t_ps.col("ps_suppkey", TypeID.INT)[:] = ps_supp
    t_ps.col("ps_availqty", TypeID.INT)[:] = rng.integers(1, 10_000, P * 4)
    t_ps.col("ps_supplycost", **MONEY)[:] = rng.integers(100, 100001, P * 4)
    t_ps.col("ps_comment", TypeID.VARCHAR, length=199,
             dict_values=pool_pscom_v)[:] = rng.integers(
        0, len(pool_pscom_v), P * 4)

    # customer
    log(f"customer ({C} rows)")
    t_cust = TableOut(outdir, "customer", C)
    ck = np.arange(1, C + 1)
    c_nation = rng.integers(0, 25, C)
    t_cust.col("c_custkey", TypeID.INT)[:] = ck
    c_names = list(np.char.add("Customer#", np.char.zfill(ck.astype(str), 9)))
    t_cust.col("c_name", TypeID.VARCHAR, length=25,
               dict_values=c_names)[:] = np.arange(C)
    c_addr_codes = rng.integers(0, len(pool_addr_v), C).astype(np.int32)
    t_cust.col("c_address", TypeID.VARCHAR, length=40,
               dict_values=pool_addr_v)[:] = c_addr_codes
    t_cust.col("c_nationkey", TypeID.INT)[:] = c_nation
    c_phone_codes = rng.integers(0, len(pool_phone_v), C).astype(np.int32)
    t_cust.col("c_phone", TypeID.CHAR, length=15,
               dict_values=pool_phone_v)[:] = c_phone_codes
    c_acctbal = rng.integers(-99999, 1000000, C)
    t_cust.col("c_acctbal", **MONEY)[:] = c_acctbal
    seg_v, seg_rank = rank_map(SEGMENTS)
    c_seg_code = seg_rank[rng.integers(0, 5, C)]
    t_cust.col("c_mktsegment", TypeID.CHAR, length=10,
               dict_values=seg_v)[:] = c_seg_code
    c_com_codes = rng.integers(0, len(pool_ccom_v), C).astype(np.int32)
    t_cust.col("c_comment", TypeID.VARCHAR, length=117,
               dict_values=pool_ccom_v)[:] = c_com_codes

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

    t_ord = TableOut(outdir, "orders", O)
    for cname, kw in [("o_orderkey", {}), ("o_custkey", {}),
                      ("o_orderstatus", dict(tid=TypeID.CHAR, length=1,
                                             dict_values=status_v)),
                      ("o_totalprice", MONEY),
                      ("o_orderdate", dict(tid=TypeID.DATE)),
                      ("o_orderpriority", dict(tid=TypeID.CHAR, length=15,
                                               dict_values=prio_v)),
                      ("o_clerk", dict(tid=TypeID.CHAR, length=15,
                                       dict_values=clerk_v)),
                      ("o_shippriority", {}),
                      ("o_comment", dict(tid=TypeID.VARCHAR, length=79,
                                         dict_values=pool_ocom_v))]:
        kw = dict(kw)
        tid = kw.pop("tid", TypeID.INT)
        t_ord.col(cname, tid, **kw)

    t_li = TableOut(outdir, "lineitem", L_total)
    for cname, kw in [("l_orderkey", {}), ("l_partkey", {}),
                      ("l_suppkey", {}), ("l_linenumber", {}),
                      ("l_quantity", MONEY), ("l_extendedprice", MONEY),
                      ("l_discount", MONEY), ("l_tax", MONEY),
                      ("l_returnflag", dict(tid=TypeID.CHAR, length=1,
                                            dict_values=rf_v)),
                      ("l_linestatus", dict(tid=TypeID.CHAR, length=1,
                                            dict_values=ls_v)),
                      ("l_shipdate", dict(tid=TypeID.DATE)),
                      ("l_commitdate", dict(tid=TypeID.DATE)),
                      ("l_receiptdate", dict(tid=TypeID.DATE)),
                      ("l_shipinstruct", dict(tid=TypeID.CHAR, length=25,
                                              dict_values=instr_v)),
                      ("l_shipmode", dict(tid=TypeID.CHAR, length=10,
                                          dict_values=mode_v)),
                      ("l_comment", dict(tid=TypeID.VARCHAR, length=44,
                                         dict_values=pool_lcom_v))]:
        kw = dict(kw)
        tid = kw.pop("tid", TypeID.INT)
        t_li.col(cname, tid, **kw)

    # oracle state
    def fresh_oracle():
        return {
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
            "max_lines": 0, "done_chunks": 0,
        }

    if os.path.exists(state_path):
        with open(state_path, "rb") as f:
            oc = pickle.load(f)
        t_ord.reopen()
        t_li.reopen()
        log(f"resuming at chunk {oc['done_chunks']}")
    else:
        oc = fresh_oracle()

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

    ord_base = int(np.sum(chunk_O[:oc["done_chunks"]], dtype=np.int64))
    li_base = int(np.sum(chunk_L[:oc["done_chunks"]], dtype=np.int64))
    for ci in range(oc["done_chunks"], n_chunks):
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
        t_ord.mmaps["o_orderkey"][osl] = ok
        t_ord.mmaps["o_custkey"][osl] = o_cust
        t_ord.mmaps["o_orderstatus"][osl] = status
        t_ord.mmaps["o_totalprice"][osl] = o_total
        t_ord.mmaps["o_orderdate"][osl] = _dates_from_daynum(o_daynum)
        t_ord.mmaps["o_orderpriority"][osl] = o_prio
        t_ord.mmaps["o_clerk"][osl] = o_clerk
        t_ord.mmaps["o_shippriority"][osl] = 0
        t_ord.mmaps["o_comment"][osl] = o_com
        lsl = slice(li_base, li_base + L)
        t_li.mmaps["l_orderkey"][lsl] = l_order
        t_li.mmaps["l_partkey"][lsl] = l_part
        t_li.mmaps["l_suppkey"][lsl] = l_supp
        t_li.mmaps["l_linenumber"][lsl] = l_lineno
        t_li.mmaps["l_quantity"][lsl] = l_qty * 100
        t_li.mmaps["l_extendedprice"][lsl] = l_extp
        t_li.mmaps["l_discount"][lsl] = l_disc
        t_li.mmaps["l_tax"][lsl] = l_tax
        t_li.mmaps["l_returnflag"][lsl] = rf_map[rf]
        t_li.mmaps["l_linestatus"][lsl] = ls_o.astype(np.int32)
        t_li.mmaps["l_shipdate"][lsl] = _dates_from_daynum(ship)
        t_li.mmaps["l_commitdate"][lsl] = _dates_from_daynum(commit)
        t_li.mmaps["l_receiptdate"][lsl] = _dates_from_daynum(receipt)
        t_li.mmaps["l_shipinstruct"][lsl] = instr
        t_li.mmaps["l_shipmode"][lsl] = mode
        t_li.mmaps["l_comment"][lsl] = l_com

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
        oc["done_chunks"] = ci + 1
        ord_base += n_ord
        li_base += L
        for m in t_ord.mmaps.values():
            m.flush()
        for m in t_li.mmaps.values():
            m.flush()
        with open(state_path + ".tmp", "wb") as f:
            pickle.dump(oc, f)
        os.replace(state_path + ".tmp", state_path)
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
    with open(os.path.join(outdir, "oracle.json"), "w") as f:
        json.dump(oracle, f)
    with open(os.path.join(tempfile.gettempdir(), "sf100_full_oracle.json"),
              "w") as f:
        json.dump(oracle, f)

    # ---------------- stats + catalog.json ----------------
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
    meta = {"databases": {"default": {"relations": {}}}}
    for t in (t_region, t_nation, t_supp, t_part, t_ps, t_cust, t_ord, t_li):
        st = column_stats(t, known.get(t.name, {}))
        meta["databases"]["default"]["relations"][t.name] = {
            "attributes": t.attrs, "num_rows": t.n, "version": 1,
            "stats": st, "partition": None, "indices": [],
        }
        log(f"stats {t.name} done")
    with open(os.path.join(outdir, "catalog.json"), "w") as f:
        json.dump(meta, f)
    os.remove(state_path)
    log(f"store complete -> {outdir}")


if __name__ == "__main__":
    main()
