"""Smoke run of quickstep_tpu_torch on one CUDA card: builds the kernels,
holds each against its plain torch version at SF10 shapes, checks all 22
TPC-H queries (and a Q20 variant that returns rows) at SF0.01 against
sqlite, and runs Q1, Q6, Q3, Q4, Q5, Q10, Q7, Q12, Q14, Q19, Q9, Q16, Q18
and Q21 at SF10 with all 8 tables generated in the process and resident on
the card, against the generator's exact oracle, and then Q9 once more after
partsupp is reloaded without statistics, which takes the expansion join.

    python3 chip_smoke.py

It needs one CUDA card, nvcc and the checkout; it exits non-zero without
them, or when any phase fails. The last line of its output is one JSON
object, {"ok": true, "device": {...}}; the line before it names the card and
its power limit, and the one before that holds the kernels' numbers.
"""

import json
import math
import re
import resource
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
N_KERNEL_ROWS = 60_000_000      # ~ lineitem rows at SF10
SF_SMALL = 0.01
SF_LARGE = 10.0
WARM_RUNS = 3
REPS = 10
REL_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
N_BUILD_ROWS = 15_000_000      # ~ orders rows at SF10
N_PACKED_KEYS = 100_000         # ~ supplier rows at SF10 (Q5's composite key)
N_SEGMENTS = 15_000_000
N_PARTS = 2_000_000             # part rows at SF10; partsupp has 4 per part
N_SEMI_PROBE = 38_000_000       # ~ Q21's late lineitem rows at SF10
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet, at 700 W
# a Q20 whose p_name prefix has rows at SF0.01 (the spec's 'forest%' has none)
Q20_ROWS_PREFIX = "green"
# SF10 queries and the kernels each must launch
LARGE_QUERIES = {
    1: ("dense_groupby",),
    6: ("scalar_agg",),
    3: ("direct_join", "sort_groupby", "multi_gather"),
    4: ("direct_join", "dense_groupby", "multi_gather"),
    5: ("direct_join", "merge_unique_probe", "dense_groupby", "multi_gather"),
    10: ("direct_join", "sort_groupby", "multi_gather"),
    7: ("direct_join", "sort_groupby", "multi_gather"),
    12: ("direct_join", "dense_groupby", "multi_gather"),
    14: ("direct_join", "scalar_agg", "multi_gather"),
    19: ("direct_join", "scalar_agg", "multi_gather"),
    # exact statistics prove (ps_partkey, ps_suppkey) unique: a K4 probe
    9: ("direct_join", "merge_unique_probe", "sort_groupby", "multi_gather"),
    16: ("direct_join", "sort_groupby", "sort_groupby_compact",
         "multi_gather"),
    18: ("direct_join", "sort_groupby", "multi_gather"),
    21: ("direct_join", "merge_cmp_probe", "multi_gather"),
}
# Q9 after partsupp is reloaded without statistics: its build side can no
# longer be proven unique, and the join expands
STALE_PARTSUPP_Q9 = ("direct_join", "expand_probe", "sort_groupby",
                     "multi_gather")
KERNELS = {   # name: (source, the reference function it replaces)
    "scalar_agg": ("quickstep_tpu_torch/csrc/agg_kernels.cu",
                   "quickstep_tpu/ops/groupby.py:435"),
    "dense_groupby": ("quickstep_tpu_torch/csrc/agg_kernels.cu",
                      "quickstep_tpu/ops/groupby.py:56"),
    "direct_join": ("quickstep_tpu_torch/csrc/join_kernels.cu",
                    "quickstep_tpu/ops/join.py:43"),
    "merge_unique_probe": ("quickstep_tpu_torch/csrc/join_kernels.cu",
                           "quickstep_tpu/ops/join.py:382"),
    "sort_groupby": ("quickstep_tpu_torch/csrc/agg_kernels.cu",
                     "quickstep_tpu/ops/groupby.py:204"),
    "multi_gather": ("quickstep_tpu_torch/csrc/gather_kernels.cu",
                     "quickstep_tpu/ops/kernels.py:88"),
    "expand_probe": ("quickstep_tpu_torch/csrc/join_kernels.cu",
                     "quickstep_tpu/ops/join.py:228"),
    "merge_cmp_probe": ("quickstep_tpu_torch/csrc/join_kernels.cu",
                        "quickstep_tpu/ops/join.py:317"),
    "sort_groupby_compact": ("quickstep_tpu_torch/csrc/compact_kernels.cu",
                             "quickstep_tpu/ops/groupby.py:405"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn) -> float:
    """Median device time of fn over REPS runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(name, got, want):
    """Max abs error of got vs want; raises beyond the dtype's tolerance
    (integers and bools exactly)."""
    worst = 0.0
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{name}: {g.dtype}{tuple(g.shape)} vs "
                                 f"{w.dtype}{tuple(w.shape)}")
        g64 = g.double().cpu()
        w64 = w.double().cpu()
        err = (g64 - w64).abs()
        worst = max(worst, float(err.max()) if err.numel() else 0.0)
        if g.dtype in REL_TOL:
            ok = torch.all(err <= REL_TOL[g.dtype] * w64.abs())
        else:
            ok = torch.equal(g.cpu(), w.cpu())
        if not ok:
            raise AssertionError(f"{name}: kernel {g.cpu()} != plain {w.cpu()}")
    return worst


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def phase_kernels(G):
    """Each kernel against its plain version on the card at SF10 shapes.
    The main case of each kernel also gets its bound (the bytes of its
    inputs, each read once, and of its outputs, each written once, over the
    card's memory rate) and, where one PyTorch call computes the same
    function, that call's time."""
    rng = np.random.default_rng(SEED)
    n = N_KERNEL_ROWS
    dev = torch.device("cuda")
    vals = {
        torch.int32: rng.integers(-10**6, 10**6, n, dtype=np.int32),
        torch.int64: rng.integers(0, 6 * 10**9, n, dtype=np.int64),
        torch.float32: (rng.random(n, dtype=np.float32) * 1000),
        torch.float64: rng.random(n) * 1000,
    }
    vals = {dt: torch.from_numpy(v).to(dev) for dt, v in vals.items()}
    alive = torch.from_numpy(rng.random(n) < 0.5).to(dev)
    valid = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    keys = torch.from_numpy(rng.integers(0, 128, n)).to(dev)
    rows = []

    def case(kernel, label, k_fn, p_fn, main=False, inputs=(),
             library=None):
        got, want = k_fn(), p_fn()
        torch.cuda.synchronize()
        err = compare(f"{kernel} {label}", got, want)
        ms, plain_ms = cuda_ms(k_fn), cuda_ms(p_fn)
        row = {"kernel": kernel, "case": label, "max_abs_err": err,
               "ms": ms, "plain_ms": plain_ms, "main": main}
        extra = ""
        if main:
            row["bound_ms"] = (nbytes(inputs) + nbytes(got)) / \
                HBM_BYTES_PER_S * 1e3
            row["library_ms"] = None if library is None else cuda_ms(library)
            extra = f"  bound {row['bound_ms']:.3f} ms" + (
                "" if library is None else
                f"  library {row['library_ms']:.3f} ms")
        rows.append(row)
        log(f"  {kernel:13s} {label:28s} err {err:.3e}  kernel {ms:8.3f} ms"
            f"  plain {plain_ms:8.3f} ms{extra}")
        del got, want

    log(f"phase 1: kernels vs plain versions, {n} rows")
    for dt, v in vals.items():
        for fn in ("sum", "min", "max"):
            case("scalar_agg", f"{fn} {str(dt)[6:]}",
                 lambda fn=fn, v=v: G.scalar_agg(fn, v, None, alive),
                 lambda fn=fn, v=v: G.scalar_agg_plain(fn, v, None, alive),
                 main=(fn == "sum" and dt == torch.int64), inputs=(v, alive))
    case("scalar_agg", "count", lambda: G.scalar_agg("count", None, None, alive),
         lambda: G.scalar_agg_plain("count", None, None, alive))
    case("scalar_agg", "sum float64 nullable",
         lambda: G.scalar_agg("sum", vals[torch.float64], valid, alive),
         lambda: G.scalar_agg_plain("sum", vals[torch.float64], valid, alive))
    case("scalar_agg", "avg int64 nullable",
         lambda: G.scalar_agg("avg", vals[torch.int64], valid, alive),
         lambda: G.scalar_agg_plain("avg", vals[torch.int64], valid, alive))

    for domain in (6, 128):
        idx = G.pack_dense_index([keys % domain], [0], [1], domain, alive)
        specs = [("sum", vals[torch.int64], None, True),
                 ("count", None, None, False),
                 ("sum", vals[torch.float64], None, False),
                 ("sum", vals[torch.float32], valid, False),
                 ("avg", vals[torch.int64], None, False),
                 ("min", vals[torch.int32], valid, False),
                 ("max", vals[torch.int64], None, False),
                 ("min", vals[torch.float64], None, False),
                 ("max", vals[torch.float32], None, False)]
        for fn, v, vv, main in specs:
            label = f"d{domain} {fn} " + ("" if v is None else str(v.dtype)[6:]) \
                + (" nullable" if vv is not None else "")

            def k(fn=fn, v=v, vv=vv, idx=idx, domain=domain):
                occ, [(d, nn)] = G.dense_groupby(idx, domain, [(fn, v, vv)],
                                                 alive)
                return occ, d, nn

            def p(fn=fn, v=v, vv=vv, idx=idx, domain=domain):
                occ, [(d, nn)] = G.dense_groupby_plain(idx, domain,
                                                       [(fn, v, vv)], alive)
                return occ, d, nn
            case("dense_groupby", label, k, p, main=(main and domain == 6),
                 inputs=(idx, v, alive),
                 library=lambda idx=idx, v=v, domain=domain: torch.zeros(
                     domain + 1, dtype=v.dtype, device=dev).index_add_(
                         0, idx, v))
    del vals, alive, valid, keys
    torch.cuda.empty_cache()
    phase_join_kernels(case, rng, dev)
    return rows


def phase_join_kernels(case, rng, dev):
    """K3-K6 against their plain versions at SF10 shapes: a probe of
    N_KERNEL_ROWS rows against an orders-sized build (orderkey-like keys,
    domain 4x the build rows), Q5's composite-key probe, the segmented
    reduce over ~N_SEGMENTS groups, and a six-column gather."""
    from quickstep_tpu_torch.ops import bloom as B, cuda, groupby as G
    from quickstep_tpu_torch.ops import join as J, kernels as K
    n, nb = N_KERNEL_ROWS, N_BUILD_ROWS
    lo, domain = 4, 4 * nb
    bkey = (torch.arange(1, nb + 1, device=dev, dtype=torch.int32) * 4)
    balive = torch.from_numpy(rng.random(nb) < 0.5).to(dev)
    pkey = torch.from_numpy(rng.integers(1, domain + 4, n)
                            .astype(np.int32)).to(dev)
    palive = torch.from_numpy(rng.random(n) < 0.8).to(dev)
    table, _ = J.direct_build(bkey, balive, lo, domain)
    case("direct_join", "build 15M, domain 60M",
         lambda: J.direct_build(bkey, balive, lo, domain),
         lambda: J.direct_build_plain(bkey, balive, lo, domain))
    case("direct_join", "probe 60M int32",
         lambda: J.direct_probe(table, pkey, palive, lo, domain),
         lambda: J.direct_probe_plain(table, pkey, palive, lo, domain),
         main=True, inputs=(table, pkey, palive))
    case("direct_join", "probe 60M int64",
         lambda: J.direct_probe(table, pkey.long(), palive, lo, domain),
         lambda: J.direct_probe_plain(table, pkey.long(), palive, lo, domain))
    del table
    case("direct_join", "filter build 60M (presence)",
         lambda: (B.exact_filter_build(pkey, palive, lo, domain),),
         lambda: (B.exact_filter_build_plain(pkey, palive, lo, domain),))
    bits = B.exact_filter_build(pkey, palive, lo, domain)
    case("direct_join", "filter probe 15M (presence)",
         lambda: (B.exact_filter_probe(bits, bkey, balive, lo),),
         lambda: (B.exact_filter_probe_plain(bits, bkey, balive, lo),))
    del bits, bkey, balive
    torch.cuda.empty_cache()

    # Q5's (suppkey, nationkey) key range-packed into int64
    nk = N_PACKED_KEYS
    supp = torch.arange(1, nk + 1, device=dev, dtype=torch.int64)
    packed_b = supp * 25 + torch.from_numpy(rng.integers(0, 25, nk)).to(dev)
    b_alive = torch.from_numpy(rng.random(nk) < 0.9).to(dev)
    packed_p = torch.from_numpy(rng.integers(0, 25 * (nk + 1), n)).to(dev)
    sorted_b, _ = J.sorted_build(packed_b, b_alive)
    case("merge_unique_probe", "60M probes, 100K keys",
         lambda: J.merge_unique_probe(packed_b, b_alive, packed_p, palive),
         lambda: J.merge_unique_probe_plain(packed_b, b_alive, packed_p,
                                            palive), main=True,
         inputs=(packed_b, b_alive, packed_p, palive),
         library=lambda: torch.searchsorted(sorted_b, packed_p))
    del sorted_b
    del packed_p

    # the sort group-by: ~N_SEGMENTS groups over N_KERNEL_ROWS rows
    gkey = torch.from_numpy(rng.integers(0, N_SEGMENTS, n)).to(dev)
    money = torch.from_numpy(rng.integers(0, 10**7, n)).to(dev)
    price = torch.from_numpy(rng.random(n) * 1000).to(dev)
    sent = torch.iinfo(torch.int64).max
    s_key, perm = torch.sort(torch.where(palive, gkey, sent), stable=True)
    s_alive = s_key != sent
    change = s_alive & torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                                  s_key[1:] != s_key[:-1]])
    last = s_alive & torch.cat([change[1:] | ~s_alive[1:],
                                torch.ones(1, dtype=torch.bool, device=dev)])
    for fn, v, main in (("sum", money, True), ("max", price, False),
                        ("count", None, False)):
        case("sort_groupby", f"segment {fn} 60M rows, 15M groups",
             lambda fn=fn, v=v: cuda.segment_reduce(fn, change, s_alive,
                                                    perm, v, None),
             lambda fn=fn, v=v: G._segment_reduce_plain(
                 fn, change, s_alive, last, perm, v, None), main=main,
             inputs=(change, s_alive, perm, v))
    del s_key, perm, s_alive, change, last
    specs = [("sum", money, None), ("avg", price, None), ("min", money, None),
             ("count", None, None)]

    def flat(out):
        keys, valids, occ, n_groups, results, rep = out
        return [*keys, occ, n_groups, *[t for r in results for t in r], rep]
    case("sort_groupby", "sort_groupby 60M rows, 4 aggregates",
         lambda: flat(G.sort_groupby([gkey], [None], specs, palive,
                                     packed_key=gkey, want_rows=True)),
         lambda: flat(G.sort_groupby_plain([gkey], [None], specs, palive,
                                           packed_key=gkey, want_rows=True)))
    del specs

    # six lineitem-like columns gathered by one 60M-row index
    cols = [palive, pkey, pkey + 1, money, price.float(), price]
    idx = torch.from_numpy(rng.integers(0, n, n)).to(dev)
    case("multi_gather", "6 columns by a 60M index",
         lambda: K.multi_gather(cols, idx),
         lambda: K.multi_gather_plain(cols, idx), main=True,
         inputs=(*cols, idx))
    case("multi_gather", "6 columns by a 60M int32 index",
         lambda: K.multi_gather(cols, idx.int()),
         lambda: K.multi_gather_plain(cols, idx.int()))
    del cols, idx, gkey, money, price, pkey, palive
    torch.cuda.empty_cache()
    phase_new_kernels(case, rng, dev)


def phase_new_kernels(case, rng, dev):
    """K7-K9 against their plain versions at SF10 shapes: Q9's partsupp-like
    build (N_PARTS keys, 4 rows each) probed by N_KERNEL_ROWS rows; Q21's
    lineitem-like build (orderkeys with 1-7 lines, suppkey values) probed
    by N_SEMI_PROBE of its rows; the stable partition of a N_KERNEL_ROWS
    mask at 50 % and 1 % live."""
    from quickstep_tpu_torch.ops import groupby as G
    from quickstep_tpu_torch.ops import join as J, kernels as K
    n = N_KERNEL_ROWS
    bkey = torch.arange(1, N_PARTS + 1, device=dev).repeat_interleave(4)
    balive = torch.from_numpy(rng.random(len(bkey)) < 0.95).to(dev)
    pkey = torch.from_numpy(rng.integers(1, N_PARTS * 11 // 10, n)).to(dev)
    palive = torch.from_numpy(rng.random(n) < 0.8).to(dev)
    sorted_key, order = J.sorted_build(bkey, balive)
    for k, main in ((4, True), (2, False)):
        case("expand_probe", f"60M probes, 8M-row build, K={k}",
             lambda k=k: J.expand_probe(sorted_key, order, pkey, palive, k),
             lambda k=k: J.expand_probe_plain(sorted_key, order, pkey,
                                              palive, k),
             main=main, inputs=(sorted_key, order, pkey, palive))
    del bkey, balive, pkey, palive, sorted_key, order
    torch.cuda.empty_cache()

    lines = torch.from_numpy(rng.integers(1, 8, N_BUILD_ROWS)).to(dev)
    okey = (torch.arange(1, N_BUILD_ROWS + 1, device=dev) * 4
            ).repeat_interleave(lines)
    supp = torch.from_numpy(rng.integers(1, 100_001, len(okey))
                            .astype(np.int32)).to(dev)
    late = torch.from_numpy(rng.random(len(okey)) < 0.63).to(dev)
    pick = torch.from_numpy(rng.integers(0, len(okey), N_SEMI_PROBE)).to(dev)
    p_okey, p_supp = okey[pick], supp[pick]
    p_alive = torch.from_numpy(rng.random(N_SEMI_PROBE) < 0.9).to(dev)
    for op, main in (("<>", True), ("<", False)):
        case("merge_cmp_probe", f"{op} 60M build, 38M probes",
             lambda op=op: (J.merge_cmp_probe(okey, late, supp, p_okey,
                                              p_alive, p_supp, op),),
             lambda op=op: (J.merge_cmp_probe_plain(okey, late, supp, p_okey,
                                                    p_alive, p_supp, op),),
             main=main, inputs=(okey, late, supp, p_okey, p_alive, p_supp))
    case("merge_cmp_probe", "stats 60M build, 38M probes",
         lambda: J.merge_stats_probe(okey, late, supp, p_okey, p_alive),
         lambda: J.merge_stats_probe_plain(okey, late, supp, p_okey, p_alive))
    del lines, okey, supp, late, pick, p_okey, p_supp, p_alive
    torch.cuda.empty_cache()

    for live, main in ((0.5, True), (0.01, False)):
        mask = torch.from_numpy(rng.random(n) < live).to(dev)
        case("sort_groupby_compact", f"partition 60M, {live:.0%} live",
             lambda mask=mask: (K.stable_partition(mask),),
             lambda mask=mask: (K.compact_order(mask),),
             main=main, inputs=(mask,),
             library=lambda mask=mask: torch.argsort(~mask, stable=True))
    del mask
    # the whole compacted group-by: 60M rows into ~15M groups
    gkey = torch.from_numpy(rng.integers(0, N_SEGMENTS, n)).to(dev)
    alive = torch.from_numpy(rng.random(n) < 0.5).to(dev)
    specs = [("sum", gkey, None), ("count", None, None)]

    def flat(out):
        keys, valids, n_groups, results = out
        return [*keys, n_groups, *[t for r in results for t in r]]
    case("sort_groupby_compact", "sort_groupby_compact 60M rows",
         lambda: flat(G.sort_groupby_compact([gkey], [None], specs, alive,
                                             packed_key=gkey)),
         lambda: flat(G.sort_groupby_compact_plain([gkey], [None], specs,
                                                   alive, packed_key=gkey)))
    del gkey, alive, specs
    torch.cuda.empty_cache()


def row_eq(a, b):
    """tests/test_tpch.py's row comparison."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if isinstance(x, float) and isinstance(y, float):
            if not math.isclose(x, y, rel_tol=1e-8, abs_tol=1e-6):
                return False
        elif isinstance(x, float) or isinstance(y, float):
            if x is None or y is None:
                return False
            if not math.isclose(float(x), float(y), rel_tol=1e-9,
                                abs_tol=1e-6):
                return False
        elif x != y:
            return False
    return True


def small_queries():
    """{label: (query, sqlite query)}: the 22 TPC-H queries with their
    tiebreaks, and Q20 with a p_name prefix that has rows at SF0.01."""
    from quickstep_tpu_torch.bench.tpch import (
        TPCH_QUERIES, ORACLE_OVERRIDES, with_tiebreak)
    out = {}
    for q in range(1, 23):
        out[f"Q{q}"] = (with_tiebreak(q, TPCH_QUERIES[q]), with_tiebreak(
            q, ORACLE_OVERRIDES.get(q, TPCH_QUERIES[q])))
    q20 = re.sub(r"'forest%'", f"'{Q20_ROWS_PREFIX}%'", TPCH_QUERIES[20])
    out[f"Q20 ({Q20_ROWS_PREFIX}%)"] = (q20, q20)
    return out


def phase_small(cuda):
    from quickstep_tpu_torch import Database
    from quickstep_tpu_torch.bench.tpch import (
        load_tpch, load_sqlite, to_sqlite_sql)
    log(f"phase 2: TPC-H SF{SF_SMALL} against sqlite")
    db = Database(device="cuda")
    try:
        data = load_tpch(db, scale=SF_SMALL, seed=SEED)
        conn = load_sqlite(data)
        # sqlite runs the correlated subqueries as nested loops; key
        # indexes make them fast and change no answer
        for table, col in (("lineitem", "l_orderkey"),
                           ("lineitem", "l_partkey"), ("part", "p_partkey")):
            conn.execute(f"create index {col}_idx on {table}({col})")
        for label, (sql, oracle_sql) in small_queries().items():
            cuda.reset_launches()
            ours = db.execute(sql).rows
            launched = sorted(k for k, v in cuda.LAUNCHES.items() if v)
            oracle = conn.execute(to_sqlite_sql(oracle_sql)).fetchall()
            # the spec's Q20 has no rows at this scale; its variant has
            if (not ours and label != "Q20") or len(ours) != len(oracle) or \
                    not all(row_eq(a, b) for a, b in zip(ours, oracle)):
                raise AssertionError(f"{label} SF{SF_SMALL}: {ours} != "
                                     f"{oracle}")
            log(f"  {label}: {len(ours)} rows match sqlite; host syncs "
                f"{db.executor.host_syncs}, retries {db.executor.retries}; "
                f"launched {', '.join(launched)}")
    finally:
        db.close()


def phase_large(cuda):
    """All 8 tables at SF_LARGE, each query cold and WARM_RUNS warm against
    the exact oracle. Each query's launches are counted from 0 and must
    include the kernels LARGE_QUERIES names; returns their sum."""
    from quickstep_tpu_torch import Database
    from quickstep_tpu_torch.bench.tpch import TPCH_QUERIES, with_tiebreak
    from quickstep_tpu_torch.bench.tpch_fullgen import (
        check_rows, load_tpch_full)
    log(f"phase 3: all 8 TPC-H tables at SF{SF_LARGE:g} on the card")
    db = Database(device="cuda")
    try:
        t0 = time.perf_counter()
        oracle = load_tpch_full(db, SF_LARGE, log=lambda msg: None)
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
        log(f"  generated {oracle['rows']} in {time.perf_counter() - t0:.1f}"
            f" s; peak host RSS {rss:.2f} GiB")
        total = dict.fromkeys(cuda.LAUNCHES, 0)

        def run(label, q, must):
            sql = with_tiebreak(q, TPCH_QUERIES[q])
            times, syncs, retries = [], [], []
            torch.cuda.reset_peak_memory_stats()
            cuda.reset_launches()
            for _ in range(1 + WARM_RUNS):
                t0 = time.perf_counter()
                rows = db.execute(sql).rows
                times.append((time.perf_counter() - t0) * 1000)
                syncs.append(db.executor.host_syncs)
                retries.append(db.executor.retries)
                check_rows(q, rows, oracle)
            launches = dict(cuda.LAUNCHES)
            missing = [k for k in must if not launches[k]]
            if missing:
                raise AssertionError(f"{label} never launched {missing}")
            if any(r != 0 or s != 1 for r, s in zip(retries[1:], syncs[1:])):
                raise AssertionError(f"{label} warm runs: host syncs "
                                     f"{syncs[1:]}, retries {retries[1:]}")
            for k, v in launches.items():
                total[k] += v
            log(f"  {label}: cold {times[0]:.1f} ms, warm "
                + ", ".join(f"{t:.1f}" for t in times[1:])
                + f" ms; {len(rows)} rows match the exact oracle; host syncs"
                f" {syncs}, retries {retries}; peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
                "launches " + ", ".join(f"{k} {v}" for k, v in
                                         launches.items() if v))

        for q, must in LARGE_QUERIES.items():
            run(f"Q{q}", q, must)
        cols = [t for key, (cs, _m) in db.executor._device_cache.items()
                for name, pair in cs.items()
                if name != "__num_rows__" for t in pair if t is not None]
        tables = sorted({key[0] for key in db.executor._device_cache})
        if set(tables) != set(oracle["rows"]) or any(
                t.device.type != "cuda" for t in cols):
            raise AssertionError(f"not every table is resident: {tables}")
        log(f"  {len(cols)} columns of {len(tables)} tables resident on "
            f"{sorted({str(t.device) for t in cols})}, "
            f"{sum(t.numel() * t.element_size() for t in cols) / 2**30:.2f}"
            " GiB")
        # partsupp reloaded and not analyzed: its statistics are gone, so
        # Q9 can no longer prove its build side unique
        rel = db.catalog.default_database.get_relation("partsupp")
        rel.set_data(rel.data)
        run("Q9, partsupp without statistics", 9, STALE_PARTSUPP_Q9)
        return total
    finally:
        db.close()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    card = gpu_name_and_power()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    from quickstep_tpu_torch.ops import cuda, groupby as G
    t0 = time.perf_counter()
    cuda.build()
    log(f"phase 0: kernels built in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {cuda.BUILD_SECONDS:.1f} s)" if cuda.BUILD_SECONDS is not None
        else f"phase 0: kernels loaded from an earlier build")

    rows = phase_kernels(G)
    torch.cuda.empty_cache()
    phase_small(cuda)
    launches = phase_large(cuda)

    bad = [m for m in sys.modules
           if m == "jax" or m.startswith("jax.") or m == "quickstep_tpu"
           or m.startswith("quickstep_tpu.")]
    if bad:
        raise AssertionError(f"imported {bad}")
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        main_case = next(r for r in mine if r["main"])
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"], "bound_by": "bytes",
            "library_ms": main_case["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
