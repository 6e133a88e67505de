"""Smoke run of quickstep_tpu_torch on one CUDA card: builds the kernels,
holds each against its plain torch version at SF10 shapes and at zero rows,
checks all 22 TPC-H queries (and a Q20 variant that returns rows) at SF0.01
against sqlite, on one device and on an 8-shard mesh of the card, runs the
reference's golden corpus (16 reference and 3
execute files) on the card, and runs all 22 TPC-H queries, and Q11 with the
specification's fraction (0.0001 / SF), at SF10 with all 8 tables generated
in the process and resident on the card, against the generator's exact
oracles, with their row counts beside the reference's SF10 run against
sqlite (SF10_VERIFY.json), then Q9 once more after partsupp is reloaded
without statistics, which
takes the expansion join, the six window queries of bench/tpch_fullgen.py
(W-Q1 to W-Q6) and its five operator queries (O-Q1 to O-Q5: scalar
DISTINCT, EXCEPT, INTERSECT, a join on hashed keys, ORDER BY ... LIMIT
below the root) on the same resident tables against their exact oracles,
and a DML sequence (O-DML: INSERT ... SELECT, DELETE, UPDATE) whose totals
are checked against the oracle. Then the same tables go to a database with
a device memory budget of 10^9 bytes: the 14 queries that stream lineitem
through the card in segments run cold and warm against the oracles (each
in more than one segment, with its kernels and its peak memory), the six
whose tables fit run resident with tables evicted, Q17 and Q21 raise
under strict_hbm_budget and match resident without it, a scan skips
segments by l_orderkey's min/max, and two clients of a network server on
that database get Q6's answer. Then the same generated tables go to a
second database on an 8-shard mesh of the card (Config.distributed), where
Q3, Q5, Q9, Q10 and Q18 take the shuffle join (K14-K16) and Q9 the
two-phase GROUP BY, against the same oracle, with a census of K16's
launches on both meshes (rows and slots of each build and probe). Then
the same mesh is spread over two processes on the card
(parallel/multihost.py, gloo: NCCL refuses two ranks on one card, which is
checked too), each holding four shards and uploading only their rows of
the sharded tables, which the processes memory-map from .npy files: the
same five queries cold and warm against the oracle and bit for bit
against the one-process mesh's rows, each process launching K14-K16; and
the distributed aggregate-join step runs at 7.5 M rows per shard over 8
shards against a plain computation. W2, K14, K15 and K16 are also checked
to make no host sync (the card's sync debug mode set to raise), and every
operator over inputs of zero rows in SQL against sqlite
(bench/zero_rows.py). Last (phase 9), bench/sf100_fullgen.py's on-disk
store of SF10, written in three chunks by its own process during phase 0
(phase 1 waits for it), is opened memory-mapped in a database with the
budget of 10^9 bytes, and the eleven queries of its oracle.json run cold
and warm through bench/sf100_full_verify.py's comparison, the rows of
both runs held to the oracle, each streamed query in at least two
segments; the store is removed after. Each SF10 query runs cold and then warm, and each warm
run of the resident phases takes its plan from the executor's
logical-plan cache.

    python3 chip_smoke.py

It needs one CUDA card, nvcc and the checkout; it exits non-zero without
them, or when any phase fails. The last line of its output is one JSON
object, {"ok": true, "device": {...}}; the line before it names the card and
its power limit, and the one before that holds the kernels' numbers.
"""

import gc
import json
import math
import os
import re
import resource
import statistics
import subprocess
import sys
import threading
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
N_SKEW_ROWS = 10_000_000        # K8's skewed build: rows on one key
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet, at 700 W
N_SHARD_ROWS = 7_500_000       # one of 8 row shards of lineitem at SF10
# K16's probe of one lineitem shard's slice on the SF10 mesh (two slices
# a shard, Config.shuffle_overlap_chunks)
N_K16_SLICE = N_SHARD_ROWS // 2
# the shuffle census's median probe slice on the SF10 mesh (profile_slice
# --shuffle-census): K14's and K15's most common size
N_MEDIAN_SLICE = 1_584_384
MESH_SHARDS = 8
# the SF0.01 mesh's replicate threshold: lineitem, orders, partsupp and
# part shard, the other tables replicate (tests/test_distributed.py:22)
SMALL_MESH_THRESHOLD = 2000
# SF10 queries on the 8-shard mesh (default replicate threshold) and the
# kernels each must launch: every one shuffles inner joins with the LIP on
SHUFFLE_KERNELS = ("partition_dest", "scatter_compact", "bloom_filter")
MESH_QUERIES = (3, 5, 9, 10, 18)
# SF10 queries on the same mesh that shuffle nothing: their aggregate runs
# on each shard's rows (K2 for Q1, K1 for Q6, once a shard a run) and the
# partials fold over the mesh
MESH_AGG_QUERIES = (1, 6)
# the gathers into an Aggregate that phase 7 may meet (runner.py _agg_route:
# no per-shard form), and the queries that must gather into no Aggregate
# and no probe side of a Join
GATHERED_AGGREGATES = ("sort GROUP BY outside the two-phase route",
                       "DISTINCT aggregate")
NO_AGGREGATE_GATHER = (1, 5, 6)
NO_PROBE_GATHER = (5, 9, 10, 18)
# phase 7: the SF10 mesh of MESH_SHARDS shards spread over this many
# processes on the one card, each a bench/multihost_run.py worker; NCCL
# refuses two ranks on one card, so they meet through gloo, which carries
# the card's tensors through host memory
MULTIHOST_PROCS = 2
MULTIHOST_BACKEND = "gloo"
MULTIHOST_RUNS = 2              # cold and warm
MULTIHOST_TIMEOUT_S = 600
NCCL_REFUSAL_TIMEOUT_S = 120
# a Q20 whose p_name prefix has rows at SF0.01 (the spec's 'forest%' has none)
Q20_ROWS_PREFIX = "green"
# Q11's HAVING fraction as the specification sets it, 0.0001 / SF, at SF10:
# the bench text keeps 0.0001, which no part passes at SF10
Q11_SPEC_FRACTION = "0.00001"
# SF10 queries and the kernels each must launch
LARGE_QUERIES = {
    1: ("dense_groupby",),
    6: ("scalar_agg",),
    3: ("direct_join", "sort_groupby", "multi_gather", "sort_groupby_compact"),
    4: ("direct_join", "dense_groupby", "multi_gather",
        "sort_groupby_compact"),
    5: ("direct_join", "merge_unique_probe", "dense_groupby", "multi_gather",
        "sort_groupby_compact"),
    10: ("direct_join", "sort_groupby", "multi_gather",
         "sort_groupby_compact"),
    # a two-key group-by: its key gathers take K6's row-packed route
    7: ("direct_join", "sort_groupby", "multi_gather", "multi_gather_packed",
        "sort_groupby_compact"),
    12: ("direct_join", "dense_groupby", "multi_gather",
         "sort_groupby_compact"),
    14: ("direct_join", "scalar_agg", "multi_gather", "sort_groupby_compact"),
    19: ("direct_join", "scalar_agg", "multi_gather", "sort_groupby_compact"),
    # exact statistics prove (ps_partkey, ps_suppkey) unique: a K4 probe
    9: ("direct_join", "merge_unique_probe", "sort_groupby", "multi_gather",
        "multi_gather_packed", "sort_groupby_compact"),
    16: ("direct_join", "sort_groupby", "sort_groupby_compact",
         "multi_gather", "multi_gather_packed"),
    18: ("direct_join", "sort_groupby", "multi_gather",
         "sort_groupby_compact"),
    21: ("direct_join", "merge_cmp_probe", "multi_gather",
         "sort_groupby_compact"),
    # the correlated MIN per part, then ORDER BY ... LIMIT 100 on the root
    2: ("direct_join", "merge_unique_probe", "sort_groupby", "multi_gather",
        "sort_groupby_compact", "order_permutation"),
    8: ("direct_join", "dense_groupby", "multi_gather",
        "sort_groupby_compact"),
    # HAVING against a scalar subquery: K1 for the total
    11: ("direct_join", "scalar_agg", "sort_groupby", "multi_gather",
         "sort_groupby_compact"),
    # the left outer join's counts per customer, then per count
    13: ("direct_join", "sort_groupby", "multi_gather", "multi_gather_packed",
         "sort_groupby_compact"),
    15: ("direct_join", "scalar_agg", "sort_groupby", "multi_gather",
         "sort_groupby_compact"),
    17: ("direct_join", "scalar_agg", "sort_groupby", "multi_gather",
         "sort_groupby_compact"),
    # the (partkey, suppkey) pairs of 1994's lines against partsupp's: K4
    20: ("direct_join", "merge_unique_probe", "sort_groupby", "multi_gather",
         "multi_gather_packed", "sort_groupby_compact"),
    22: ("direct_join", "scalar_agg", "dense_groupby", "multi_gather",
         "sort_groupby_compact"),
}
# the device memory budget of the streamed phase: lineitem's columns that
# each of STREAMED_QUERIES reads at SF_LARGE are about 1 to 1.7 times it,
# all of lineitem about 5 times
STREAM_BUDGET = 10**9
STREAM_WARM_RUNS = 1
# the queries that stream lineitem under it; those whose tables are all
# under half of it (resident); those that read lineitem over half of it
# twice (no streamable shape)
STREAMED_QUERIES = (1, 6, 3, 4, 5, 7, 8, 9, 10, 12, 14, 15, 19, 20)
RESIDENT_UNDER_BUDGET = (2, 11, 13, 16, 18, 22)
UNSTREAMABLE = (17, 21)
# Q11 with Q11_SPEC_FRACTION: Q11's kernels
Q11_SPEC_KERNELS = LARGE_QUERIES[11]
# the SF10 queries whose joins compact their inputs (PlanRunner._compact_chunk,
# K9 with a limit; every query of LARGE_QUERIES but Q1 and Q6): no library
# sort may run inside a compaction
COMPACTING = (3, 4, 5, 10, 7, 12, 14, 19, 9, 16, 18, 21, 2, 8, 11, 13, 15,
              17, 20, 22, "q11_spec")
# Q1's dense GROUP BY: one K2 launch a run
Q1_PER_RUN = {"dense_groupby": 1}
# Q9 after partsupp is reloaded without statistics: its build side can no
# longer be proven unique, and the join expands
STALE_PARTSUPP_Q9 = ("direct_join", "expand_probe", "sort_groupby",
                     "multi_gather", "multi_gather_packed")
# SF10 window queries (bench/tpch_fullgen.py WINDOW_QUERIES) and the window
# kernels each must launch
WINDOW_RUNS = {
    "w1": ("window_prefix",),
    "w2": ("window_prefix",),
    "w3": ("window_prefix",),
    "w4": ("frame_bounds", "sliding_sum"),
    # a RANGE frame: the values and the order key gathered by the sort
    # permutation together, on K6's row-packed route
    "w5": ("frame_bounds", "frame_minmax", "multi_gather_packed"),
    "w6": ("frame_bounds", "frame_minmax"),
}
N_SUPPLIERS = 100_000           # W-Q1's and W-Q5's partitions at SF10
N_WINDOW_ONE_SEGMENT = 15_000_000   # W-Q3's single segment (orders)
N_W4_CHECKED_ROWS = 1_000_000   # W4's long route against the plain walk
ADD_CHAIN_STEPS = 1 << 24       # the dependent-add probe's chain
N_W3_FLOAT_ROWS = 6_000_000     # W3's float-key RANGE case
N_PARTSUPP = 8_000_000          # partsupp rows at SF10
SECTOR_BYTES = 32               # one random DRAM access on an H100
N_L2_ROWS = 1_500_000           # a gather source whose packed rows fit the L2
# SF10 operator queries (bench/tpch_fullgen.py OPERATOR_QUERIES) and the
# kernels each must launch
OPERATOR_RUNS = {
    "o1": ("distinct_sort", "distinct_count"),
    # EXCEPT and INTERSECT: K11 (which runs K10's hash in its own kernels)
    # and the DISTINCT after it, which has no aggregate and so is the sort
    # group-by's torch.sort and its key gathers by the sort permutation (K6's
    # row-packed route), with no K5 reduction
    "o2": ("open_addressing", "multi_gather_packed"),
    "o3": ("open_addressing", "multi_gather_packed"),
    "o4": ("hash_keys", "merge_unique_probe", "multi_gather"),
    "o5": ("order_permutation",),
}
# phase 9: bench/sf100_fullgen.py's on-disk store of SF_LARGE in chunks of
# this many orders (three chunks of SF10's 15 M), written under build/ by
# its own process during phase 0 (phase 1 waits for it), then the eleven
# queries of its oracle.json through bench/sf100_full_verify.py's
# comparison on the card under STREAM_BUDGET, the columns memory-mapped
# from the store
STORE_CHUNK_ORDERS = 5_000_000
# seconds the writer may take in all (it took 93 s on an H100 host)
STORE_WRITER_TIMEOUT = 400

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
    "multi_gather_packed": ("quickstep_tpu_torch/csrc/gather_kernels.cu",
                            "quickstep_tpu/ops/kernels.py:88"),
    "expand_probe": ("quickstep_tpu_torch/csrc/join_kernels.cu",
                     "quickstep_tpu/ops/join.py:228"),
    "merge_cmp_probe": ("quickstep_tpu_torch/csrc/join_kernels.cu",
                        "quickstep_tpu/ops/join.py:317"),
    "sort_groupby_compact": ("quickstep_tpu_torch/csrc/compact_kernels.cu",
                             "quickstep_tpu/ops/groupby.py:405"),
    "window_prefix": ("quickstep_tpu_torch/csrc/window_kernels.cu",
                      "quickstep_tpu/ops/window.py:75"),
    "frame_minmax": ("quickstep_tpu_torch/csrc/window_kernels.cu",
                     "quickstep_tpu/ops/window.py:50"),
    "frame_bounds": ("quickstep_tpu_torch/csrc/window_kernels.cu",
                     "quickstep_tpu/ops/window.py:30"),
    "sliding_sum": ("quickstep_tpu_torch/csrc/window_kernels.cu",
                    "quickstep_tpu/ops/window.py:273"),
    "hash_keys": ("quickstep_tpu_torch/csrc/hash_kernels.cu",
                  "quickstep_tpu/ops/kernels.py:143"),
    "open_addressing": ("quickstep_tpu_torch/csrc/hash_kernels.cu",
                        "quickstep_tpu/ops/join.py:83"),
    "distinct_sort": ("quickstep_tpu_torch/csrc/radix_kernels.cu",
                      "quickstep_tpu/ops/groupby.py:455"),
    "distinct_count": ("quickstep_tpu_torch/csrc/sort_kernels.cu",
                       "quickstep_tpu/ops/groupby.py:455"),
    "order_permutation": ("quickstep_tpu_torch/csrc/sort_kernels.cu",
                          "quickstep_tpu/ops/sort.py:21"),
    "partition_dest": ("quickstep_tpu_torch/csrc/shuffle_kernels.cu",
                       "quickstep_tpu/parallel/shuffle.py:36"),
    "scatter_compact": ("quickstep_tpu_torch/csrc/shuffle_kernels.cu",
                        "quickstep_tpu/ops/kernels.py:44"),
    "bloom_filter": ("quickstep_tpu_torch/csrc/shuffle_kernels.cu",
                     "quickstep_tpu/ops/bloom.py:41"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=REPS) -> float:
    """Median device time of fn over reps runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(name, got, want, atol=None, nan_equal=False):
    """Max abs error of got vs want; raises beyond the tolerance: integers
    and bools exactly, floats within the dtype's relative tolerance, or
    within atol where given (atol 0: bit for bit; with nan_equal, a NaN
    equals a NaN whatever its bits)."""
    worst = 0.0
    for g, w in zip(got, want):
        if g is None and w is None:
            continue
        if g is None or w is None or g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{name}: {g.dtype}{tuple(g.shape)} vs "
                                 f"{w.dtype}{tuple(w.shape)}")
        g64 = g.double().cpu()
        w64 = w.double().cpu()
        err = (g64 - w64).abs()
        worst = max(worst, float(err.max()) if err.numel() else 0.0)
        if atol == 0 and nan_equal and g.dtype.is_floating_point:
            g, w = g.cpu(), w.cpu()
            ok = bool(((g == w) | (torch.isnan(g) & torch.isnan(w))).all())
        elif atol == 0:
            ok = torch.equal(g.cpu(), w.cpu())
        elif atol is not None and g.dtype.is_floating_point:
            ok = torch.all(err <= atol)
        elif g.dtype in REL_TOL:
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
             library=None, atol=None, plain_reps=REPS, bound_bytes=None,
             decode=None, check=None, nan_equal=False):
        """bound_bytes (or, for the main case, the bytes of inputs and
        outputs) gives the case its bound; library its PyTorch call's time
        (the main case's goes into the JSON line).
        check maps both outputs to what is compared, outside the times;
        nan_equal as compare takes it."""
        got, want = k_fn(), p_fn()
        if decode is not None:     # the kernel's layout, read as the plain
            got = decode(got)
        if check is not None:
            got, want = check(got), check(want)
        torch.cuda.synchronize()
        err = compare(f"{kernel} {label}", got, want, atol, nan_equal)
        ms, plain_ms = cuda_ms(k_fn), cuda_ms(p_fn, plain_reps)
        row = {"kernel": kernel, "case": label, "max_abs_err": err,
               "ms": ms, "plain_ms": plain_ms, "main": main}
        extra = ""
        if main and bound_bytes is None:
            bound_bytes = nbytes(inputs) + nbytes(got)
        if bound_bytes is not None:
            row["bound_ms"] = bound_bytes / HBM_BYTES_PER_S * 1e3
            extra = f"  bound {row['bound_ms']:.3f} ms"
        if main or library is not None:
            row["library_ms"] = None if library is None else cuda_ms(library)
            extra += "" if library is None else \
                f"  library {row['library_ms']:.3f} ms"
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
        specs = [("sum", vals[torch.int64], None),
                 ("count", None, None),
                 ("sum", vals[torch.float64], None),
                 ("sum", vals[torch.float32], valid),
                 ("avg", vals[torch.int64], None),
                 ("min", vals[torch.int32], valid),
                 ("max", vals[torch.int64], None),
                 ("min", vals[torch.float64], None),
                 ("max", vals[torch.float32], None)]
        for fn, v, vv in specs:
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
            # the single int64 SUM of the kernel table's K2 rows, with its
            # bound; at domain 128 also one index_add_ of it
            single = fn == "sum" and v is not None and \
                v.dtype == torch.int64 and vv is None
            case("dense_groupby", label, k, p,
                 bound_bytes=(nbytes((idx, v, alive)) + 13 * domain)
                 if single else None,
                 library=(lambda idx=idx, v=v, domain=domain: torch.zeros(
                     domain + 1, dtype=torch.int64, device=dev).index_add_(
                         0, idx, v)) if single and domain == 128 else None)
        for dt in (torch.float64, torch.float32):
            runs = [G.dense_groupby(idx, domain, [("sum", vals[dt], valid)],
                                    alive)[1][0][0] for _ in range(2)]
            if not torch.equal(runs[0], runs[1]):
                raise AssertionError(f"dense_groupby d{domain} float SUM "
                                     f"of {dt}: two runs differ")
        log(f"  dense_groupby d{domain} float64 and float32 SUM: two runs "
            "give the same bits")
    phase_dense_q1(case, dev)
    del vals, alive, valid, keys
    torch.cuda.empty_cache()
    phase_join_kernels(case, rng, dev)
    phase_zero_rows()
    return rows


def phase_dense_q1(case, dev):
    """K2's main case: Q1's dense GROUP BY as the runner hands it over (two
    int32 keys, domain 6, five int64 SUMs and COUNT(*), 98 % live; inputs
    from bench/kernel_ab.py k2_inputs) in one launch, the packing inside;
    its bound from the bytes read (the keys, the mask, each distinct value
    column once) and written. No single PyTorch call computes it."""
    from quickstep_tpu_torch.bench.kernel_ab import k2_inputs
    from quickstep_tpu_torch.ops import cuda, groupby as G
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 12)
    keys, offs, strides, domain, specs, alive = k2_inputs(dev, gen,
                                                          N_KERNEL_ROWS)

    def flat(out):
        occ, res = out
        return [occ] + [t for r in res for t in r]
    cuda.reset_launches()
    G.dense_aggregate(keys, offs, strides, domain, specs, alive)
    if cuda.LAUNCHES["dense_groupby"] != 1:
        raise AssertionError(f"Q1's dense GROUP BY launched "
                             f"{cuda.LAUNCHES['dense_groupby']} times")
    values = list({id(v): v for _, v, _ in specs if v is not None}.values())
    case("dense_groupby", "Q1: 2 int32 keys, 5 SUM int64 + COUNT",
         lambda: flat(G.dense_aggregate(keys, offs, strides, domain, specs,
                                        alive)),
         lambda: flat(G.dense_aggregate_plain(keys, offs, strides, domain,
                                              specs, alive)),
         main=True, inputs=(*keys, alive, *values), plain_reps=3)
    del keys, specs, alive, values
    torch.cuda.empty_cache()


def phase_join_kernels(case, rng, dev):
    """K3-K6 against their plain versions at SF10 shapes: a probe of
    N_KERNEL_ROWS rows against an orders-sized build (orderkey-like keys,
    domain 4x the build rows) by random keys and by ascending lineitem-like
    ones (1-7 an order), and by random keys against a part-sized table;
    K3's build with and without its probe; its presence mode; each with
    its random-sector limits, and the other K3 layout timed beside the one
    the route rule takes. Then Q5's composite-key probe, the segmented
    reduce over ~N_SEGMENTS groups, then K6's routes on lineitem-like
    columns (phase_gather_kernels)."""
    from quickstep_tpu_torch.ops import bloom as B, cuda, groupby as G
    from quickstep_tpu_torch.ops import join as J
    n, nb = N_KERNEL_ROWS, N_BUILD_ROWS
    lo, domain = 4, 4 * nb
    bkey = (torch.arange(1, nb + 1, device=dev, dtype=torch.int32) * 4)
    balive = torch.from_numpy(rng.random(nb) < 0.5).to(dev)
    pkey = torch.from_numpy(rng.integers(1, domain + 4, n)
                            .astype(np.int32)).to(dev)
    palive = torch.from_numpy(rng.random(n) < 0.8).to(dev)

    def slots(out, domain=domain):
        return J.direct_table(out[0], domain), out[1]
    case("direct_join", "build 15M, domain 60M",
         lambda: J.direct_build(bkey, balive, lo, domain),
         lambda: J.direct_build_plain(bkey, balive, lo, domain),
         decode=slots)
    table, _ = J.direct_build(bkey, balive, lo, domain)
    plain = J.direct_table(table, domain)
    case("direct_join", "probe 60M int32",
         lambda: J.direct_probe(table, pkey, palive, lo, domain),
         lambda: J.direct_probe_plain(plain, pkey, palive, lo, domain),
         main=True, inputs=(plain, pkey, palive))
    k3_limits("probe 60M int32", plain, pkey, palive, lo)
    k3_other_route("probe 60M int32", bkey, balive, pkey, palive, lo, domain)
    case("direct_join", "build + probe 60M int32",
         lambda: J.direct_probe(J.direct_build(bkey, balive, lo, domain)[0],
                                pkey, palive, lo, domain),
         lambda: J.direct_probe_plain(
             J.direct_build_plain(bkey, balive, lo, domain)[0], pkey, palive,
             lo, domain))
    case("direct_join", "probe 60M int64",
         lambda: J.direct_probe(table, pkey.long(), palive, lo, domain),
         lambda: J.direct_probe_plain(plain, pkey.long(), palive, lo, domain))
    # lineitem's orderkeys into orders' table: 1-7 lines an order, ascending
    lines = torch.from_numpy(rng.integers(1, 8, nb)).to(dev)
    akey = bkey.repeat_interleave(lines)
    aalive = torch.from_numpy(rng.random(len(akey)) < 0.8).to(dev)
    label = f"ascending probe {len(akey) / 1e6:.0f}M int32"
    case("direct_join", label,
         lambda: J.direct_probe(table, akey, aalive, lo, domain),
         lambda: J.direct_probe_plain(plain, akey, aalive, lo, domain))
    k3_limits(label, plain, akey, aalive, lo)
    k3_other_route(label, bkey, balive, akey, aalive, lo, domain)

    def bits(out, domain=domain):
        return (B.presence_bits(out[0], domain),)
    # Q4's semi-join build: lineitem's orderkeys, ascending, repeated
    case("direct_join",
         f"filter build {len(akey) / 1e6:.0f}M ascending (presence)",
         lambda: (B.exact_filter_build(akey, aalive, lo, domain),),
         lambda: (B.exact_filter_build_plain(akey, aalive, lo, domain),),
         decode=bits)
    del table, plain, lines, akey, aalive
    # lineitem's partkeys into part's table (2 M slots: it fits the L2)
    part = torch.arange(1, N_PARTS + 1, device=dev, dtype=torch.int32)
    part_alive = torch.from_numpy(rng.random(N_PARTS) < 0.5).to(dev)
    lkey = torch.from_numpy(rng.integers(1, N_PARTS + 1, n)
                            .astype(np.int32)).to(dev)
    small, _ = J.direct_build(part, part_alive, 1, N_PARTS)
    small_plain = J.direct_table(small, N_PARTS)
    case("direct_join", "probe 60M int32, 2M slots",
         lambda: J.direct_probe(small, lkey, palive, 1, N_PARTS),
         lambda: J.direct_probe_plain(small_plain, lkey, palive, 1, N_PARTS))
    k3_other_route("probe 60M int32, 2M slots", part, part_alive, lkey,
                   palive, 1, N_PARTS)
    del part, part_alive, lkey, small, small_plain
    case("direct_join", "filter build 60M (presence)",
         lambda: (B.exact_filter_build(pkey, palive, lo, domain),),
         lambda: (B.exact_filter_build_plain(pkey, palive, lo, domain),),
         decode=bits)
    words = B.exact_filter_build(pkey, palive, lo, domain)
    case("direct_join", "filter probe 15M (presence)",
         lambda: (B.exact_filter_probe(words, bkey, balive, lo),),
         lambda: (B.exact_filter_probe_plain(bits((words,))[0], bkey, balive,
                                             lo),))
    del words, bkey, balive
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
    k4_limit("60M probes, 100K keys", packed_b, b_alive, packed_p, palive)
    del sorted_b
    del packed_p
    k4_partsupp(case, dev)

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
    k5_shapes(case, dev, money, price)
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

    del gkey
    phase_gather_kernels(case, rng, dev, [palive, pkey, pkey + 1, money,
                                          price.float(), price])
    del money, price, pkey, palive
    torch.cuda.empty_cache()
    phase_new_kernels(case, rng, dev)


def k9_limits(case, n, dev):
    """K9 with `limit`: the head of a half-live mask's order as long as its
    live rows (the bytes: the mask, then 8 a position written); the join
    compaction's shape (n rows, 3.5 M live at random, the target 2^22, with
    the mask gathered: 9 bytes a position); one tile of 4,096 rows, which
    is one launch."""
    from quickstep_tpu_torch.bench.kernel_ab import (
        COMPACT_TARGET, N_COMPACT_LIVE, k9_inputs)
    from quickstep_tpu_torch.ops import kernels as K
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 9)
    mask, sparse = k9_inputs(dev, gen, n)
    live = int(mask.sum())
    case("sort_groupby_compact", f"limit = the {live} live rows",
         lambda: (K.stable_partition(mask, limit=live),),
         lambda: (K.compact_order(mask)[:live],),
         bound_bytes=n + 8 * live)
    def plain_head():
        order = K.compact_order(sparse)[:COMPACT_TARGET]
        return order, sparse[order]
    case("sort_groupby_compact",
         f"compaction: {N_COMPACT_LIVE} live to 2^22, with the mask",
         lambda: K.stable_partition(sparse, limit=COMPACT_TARGET,
                                    with_mask=True),
         plain_head, bound_bytes=n + 9 * COMPACT_TARGET)
    small = mask[:4096].clone()
    case("sort_groupby_compact", "4,096 rows: one launch",
         lambda: (K.stable_partition(small),),
         lambda: (K.compact_order(small),), bound_bytes=9 * 4096)
    del mask, sparse, small


def k4_limit(label, bkey, balive, pkey, palive):
    """K4's random-sector limit: a live probe row reads one sector of each
    fence level under the top (which is in shared memory) and of its leaf,
    and a hit one more for its row; and the bytes those sectors lie in (the
    fence under its top, the padded keys, the int32 rows), against the
    card's 50 MB L2."""
    from quickstep_tpu_torch.ops import cuda, join as J
    nb = int(bkey.shape[0])
    levels = len(cuda.fence_layout(nb))
    matched = J.merge_unique_probe(bkey, balive, pkey, palive)[1]
    live = palive & (pkey != torch.iinfo(torch.int64).max)
    sector_limit("merge_unique_probe", label,
                 int(live.sum()) * levels + int(matched.sum()))
    top = cuda.fence_layout(nb)[-1]
    mb = (cuda.fence_scratch_words(nb) - top) * 8 / 1e6
    log(f"  {'merge_unique_probe':13s} {label}: those sectors lie in "
        f"{mb:.1f} MB (the L2 holds 50 MB)")


def k4_partsupp(case, dev):
    """K4 at Q9's partsupp: 60 M live probes, each naming one of 8 M
    range-packed (partkey, suppkey) keys; the fence has five levels. Bytes:
    the build's keys and mask and the probe's, the outputs."""
    from quickstep_tpu_torch.bench.kernel_ab import unique_probe_inputs
    from quickstep_tpu_torch.ops import join as J
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    b, ba, p, pa = unique_probe_inputs("q9", N_KERNEL_ROWS, dev, gen)
    label = "60M live probes, 8M keys (Q9)"
    got = J.merge_unique_probe(b, ba, p, pa)
    case("merge_unique_probe", label,
         lambda: J.merge_unique_probe(b, ba, p, pa),
         lambda: J.merge_unique_probe_plain(b, ba, p, pa),
         bound_bytes=nbytes((b, ba, p, pa)) + nbytes(got))
    k4_limit(label, b, ba, p, pa)


def k5_shapes(case, dev, money, price):
    """K5 at Q9's shape (175 groups over the 5.4 % of 60 M rows that are
    live: float64 SUM, int64 MIN) and over one live group of 60 M rows
    (SUM of float64 multiples of 1/4, whose partial sums are all exact, so
    the kernel equals the plain version bit for bit; COUNT), twice each
    for the bits. Bytes: s_alive and the outputs of every row, change, perm
    and the value of each live row; the random-sector limit: a sector a
    live row for its value through perm."""
    from quickstep_tpu_torch.bench.kernel_ab import segment_inputs
    from quickstep_tpu_torch.ops import cuda, groupby as G
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    exact = torch.floor(price * 4) / 4
    for shape, cases in (("q9", (("sum", price), ("min", money))),
                         ("one_group", (("sum", exact), ("count", None)))):
        change, s_alive, perm, last = segment_inputs(shape, N_KERNEL_ROWS,
                                                     dev, gen)
        n, live = N_KERNEL_ROWS, int(s_alive.sum())
        for fn, v in cases:
            width = 0 if v is None else v.element_size()
            label = f"segment {fn} {'Q9 shape' if shape == 'q9' else '1 group'}"

            def k(fn=fn, v=v):
                return cuda.segment_reduce(fn, change, s_alive, perm, v, None)
            again = k()
            compare(f"sort_groupby {label}, twice", again, k(), atol=0)
            case("sort_groupby", label, k,
                 lambda fn=fn, v=v: G._segment_reduce_plain(
                     fn, change, s_alive, last, perm, v, None),
                 atol=0 if shape == "one_group" else None, plain_reps=3,
                 bound_bytes=n * (1 + width + 4) + live * (1 + 8 + width))
            if v is not None and shape == "q9":
                sector_limit("sort_groupby", label, live)
        del change, s_alive, perm, last
    del exact


def k8_limit(label, okey, late, supp, p_okey, p_alive):
    """K8's random-sector limit: a live probe row whose key lies in the
    build's range reads one sector of each fence level under the top (in
    shared memory) and of its leaf, and a hit one more for its run's
    stats."""
    from quickstep_tpu_torch.ops import cuda, join as J
    nb = int(okey.shape[0])
    live_keys = okey[late]
    inside = p_alive & (p_okey >= live_keys.min()) & \
        (p_okey <= live_keys.max())
    hits = J.merge_stats_probe(okey, late, supp, p_okey, p_alive)[0]
    sector_limit("merge_cmp_probe", label,
                 int(inside.sum()) * len(cuda.fence_layout(nb)) +
                 int(hits.sum()))


def k13_limit(label, args):
    """K13's random-sector limit: every key but the last (the first
    sorted) and its validity, and the dead flag, are read at the current
    permutation: one sector a row each."""
    keys, valids, _asc, _nf, alive = args
    gathered = len(keys) - 1 + sum(v is not None for v in valids[:-1]) + 1
    sector_limit("order_permutation", label, gathered * int(alive.shape[0]))


def sector_limit(kernel, label, sectors):
    """Logs a case's random-sector limit: its random sectors at 32 bytes
    each over the card's memory rate, and at the random-sector rate of
    quickstep_tpu_torch/bench/gather_rates.py (ops/cuda.py
    RANDOM_SECTORS_PER_S)."""
    from quickstep_tpu_torch.ops import cuda
    log(f"  {kernel:13s} {label}: random-sector limit {sectors} sectors, "
        f"{sectors * SECTOR_BYTES / HBM_BYTES_PER_S * 1e3:.3f} ms at "
        f"{SECTOR_BYTES} B each, "
        f"{sectors / cuda.RANDOM_SECTORS_PER_S * 1e3:.3f} ms at "
        f"{cuda.RANDOM_SECTORS_PER_S:.3e} sectors/s")


def k3_limits(label, plain, key, alive, lo):
    """K3's random-sector limits on a probe: one table sector per live
    in-range row (a probe that reads the table for every row), and one per
    row whose key is present (a probe that reads it only on a hit)."""
    idx = key.long() - lo
    live = alive & (idx >= 0) & (idx < plain.shape[0])
    hits = live & (plain[idx.clamp(0, plain.shape[0] - 1)] >= 0)
    sector_limit("direct_join", f"{label}, every live row",
                 int(live.sum()))
    sector_limit("direct_join", f"{label}, present keys only",
                 int(hits.sum()))


def k3_other_route(label, bkey, balive, pkey, palive, lo, domain):
    """K3's probe on the layout its route rule (ops/cuda.py direct_route)
    does not take for this domain, held to the plain version and timed."""
    from quickstep_tpu_torch.ops import cuda
    from quickstep_tpu_torch.ops import join as J
    names = {cuda.DIRECT_TABLE: "the row table alone",
             cuda.DIRECT_TABLE_BITS: "the bitmap in front"}
    taken = cuda.direct_route(domain)
    saved = cuda.DIRECT_BITMAP_SLOTS
    cuda.DIRECT_BITMAP_SLOTS = 0 if taken == cuda.DIRECT_TABLE else 2 ** 62
    try:
        table, _ = J.direct_build(bkey, balive, lo, domain)
        compare(f"direct_join {label}, other route",
                J.direct_probe(table, pkey, palive, lo, domain),
                J.direct_probe_plain(J.direct_table(table, domain), pkey,
                                     palive, lo, domain))
        ms = cuda_ms(lambda: J.direct_probe(table, pkey, palive, lo, domain))
    finally:
        cuda.DIRECT_BITMAP_SLOTS = saved
    other = [v for k, v in names.items() if k != taken][0]
    log(f"  direct_join   {label}: the route rule takes {names[taken]}; "
        f"{other} {ms:.3f} ms")


def gather_sectors(m, widths, route):
    """32-byte sectors a gather of m random rows reads: one per row and
    column on the direct route, the packed row's on the other."""
    from quickstep_tpu_torch.ops import cuda
    if route == "direct":
        return m * len(widths)
    return m * -(-cuda.packed_layout(widths)[1] // SECTOR_BYTES)


def phase_gather_kernels(case, rng, dev, cols):
    """K6's two routes against the plain version (one index_select per
    column), bit for bit, on six lineitem-like columns of N_KERNEL_ROWS
    rows: by an ascending half-live index (a compaction, the direct
    route's case; the packed route on it is timed beside it), by a uniform
    random 60 M-row index (the row-packed route's case; the direct route on
    it too), with an int32 index, from a 1.5 M-row source that sits in the
    L2, and two columns. Each case's bound counts the gathered rows' bytes,
    the index and the outputs; the random-sector limit (one sector per row
    and column direct, per packed row packed, at the card's memory rate)
    is logged beside the random cases. Both routes must launch as
    gather_route says."""
    from quickstep_tpu_torch.ops import cuda, kernels as K
    n = N_KERNEL_ROWS
    widths = [c.element_size() for c in cols]
    row = sum(widths)

    def launched(fn, key):
        cuda.reset_launches()
        fn()
        torch.cuda.synchronize()
        if cuda.LAUNCHES[key] != 1:
            raise AssertionError(f"{key} not launched: {cuda.LAUNCHES}")

    def limit(label, m, ws, route):
        sector_limit("multi_gather", label, gather_sectors(m, ws, route))

    asc = torch.nonzero(torch.from_numpy(rng.random(n) < 0.5).to(dev)
                        ).flatten()
    m = asc.shape[0]
    launched(lambda: K.multi_gather(cols, asc), "multi_gather")
    case("multi_gather", "6 columns, ascending half-live",
         lambda: K.multi_gather(cols, asc),
         lambda: K.multi_gather_plain(cols, asc), main=True, atol=0,
         bound_bytes=m * (2 * row + 8),
         library=lambda: [c.index_select(0, asc) for c in cols])
    ms = cuda_ms(lambda: K.multi_gather(cols, asc, random=True))
    log(f"  multi_gather  the packed route on that index: {ms:.3f} ms")
    del asc

    idx = torch.from_numpy(rng.integers(0, n, n)).to(dev)
    launched(lambda: K.multi_gather(cols, idx, random=True),
             "multi_gather_packed")
    case("multi_gather_packed", "6 columns by a 60M index",
         lambda: K.multi_gather(cols, idx, random=True),
         lambda: K.multi_gather_plain(cols, idx), main=True, atol=0,
         bound_bytes=n * (2 * row + 8),
         library=lambda: [c.index_select(0, idx) for c in cols])
    limit("6 columns by a 60M index, packed", n, widths, "packed")
    case("multi_gather", "6 columns by a 60M index",
         lambda: K.multi_gather(cols, idx),
         lambda: K.multi_gather_plain(cols, idx), atol=0)
    limit("6 columns by a 60M index, direct", n, widths, "direct")
    case("multi_gather_packed", "6 columns by a 60M int32 index",
         lambda: K.multi_gather(cols, idx.int(), random=True),
         lambda: K.multi_gather_plain(cols, idx.int()), atol=0)
    two = [cols[3], cols[1]]
    launched(lambda: K.multi_gather(two, idx, random=True),
             "multi_gather_packed")
    case("multi_gather_packed", "2 columns by a 60M index",
         lambda: K.multi_gather(two, idx, random=True),
         lambda: K.multi_gather_plain(two, idx), atol=0)
    limit("2 columns by a 60M index, packed", n, [8, 4], "packed")
    small = [c[:N_L2_ROWS].contiguous() for c in cols]
    sidx = idx % N_L2_ROWS
    launched(lambda: K.multi_gather(small, sidx, random=True),
             "multi_gather_packed")
    case("multi_gather_packed", "6 columns of 1.5M rows, 60M index",
         lambda: K.multi_gather(small, sidx, random=True),
         lambda: K.multi_gather_plain(small, sidx), atol=0)
    case("multi_gather", "6 columns of 1.5M rows, 60M index",
         lambda: K.multi_gather(small, sidx),
         lambda: K.multi_gather_plain(small, sidx), atol=0)
    del cols, idx, two, small, sidx
    torch.cuda.empty_cache()


def phase_new_kernels(case, rng, dev):
    """K7-K9 against their plain versions at SF10 shapes: Q9's partsupp-like
    build (N_PARTS keys, 4 rows each) probed by N_KERNEL_ROWS rows, on part
    keys and on range-packed (partkey, suppkey) keys (the stale Q9); Q21's
    lineitem-like build (orderkeys with 1-7 lines, suppkey values) probed
    by N_SEMI_PROBE of its rows under each of the five comparisons and in
    stats mode, then with N_SKEW_ROWS of the build on one key; the stable
    partition of a N_KERNEL_ROWS mask at 50 % and 1 % live."""
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
    sector_limit("expand_probe", "60M probes, one sector a live row",
                 int((palive & (pkey <= N_PARTS)).sum()))
    # the stale Q9's key: partsupp's (ps_partkey, ps_suppkey), its suppkeys
    # by the TPC-H rule, range-packed into int64 (range ~2e11), probed by
    # lineitem-like rows that each name one partsupp row
    s = N_SUPPLIERS
    part = torch.arange(1, N_PARTS + 1, device=dev).repeat_interleave(4)
    supp = (part + torch.arange(4, device=dev).repeat(N_PARTS)
            * (s // 4 + (part - 1) // s)) % s + 1
    ckey = part * (s + 1) + supp
    calive = torch.ones(len(ckey), dtype=torch.bool, device=dev)
    cprobe = ckey[torch.from_numpy(rng.integers(0, len(ckey), n)).to(dev)]
    sorted_key, order = J.sorted_build(ckey, calive)
    case("expand_probe", "60M (partkey, suppkey) probes, 8M rows, K=4",
         lambda: J.expand_probe(sorted_key, order, cprobe, palive, 4),
         lambda: J.expand_probe_plain(sorted_key, order, cprobe, palive, 4))
    sector_limit("expand_probe", "(partkey, suppkey), one sector a live row",
                 int(palive.sum()))
    del bkey, balive, pkey, palive, sorted_key, order, part, supp, ckey
    del calive, cprobe
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
    k8_bytes = nbytes((okey, late, supp, p_okey, p_alive, p_supp)) + \
        N_SEMI_PROBE
    for op in ("<>", "<", "<=", ">", ">="):
        case("merge_cmp_probe", f"{op} 60M build, 38M probes",
             lambda op=op: (J.merge_cmp_probe(okey, late, supp, p_okey,
                                              p_alive, p_supp, op),),
             lambda op=op: (J.merge_cmp_probe_plain(okey, late, supp, p_okey,
                                                    p_alive, p_supp, op),),
             main=op == "<>", inputs=(okey, late, supp, p_okey, p_alive,
                                      p_supp),
             plain_reps=REPS if op == "<>" else 3)
    k8_limit("<> 60M build, 38M probes", okey, late, supp, p_okey, p_alive)
    case("merge_cmp_probe", "stats 60M build, 38M probes",
         lambda: J.merge_stats_probe(okey, late, supp, p_okey, p_alive),
         lambda: J.merge_stats_probe_plain(okey, late, supp, p_okey, p_alive),
         plain_reps=3)
    # the skewed build: 10 M of the build rows moved onto one key, live
    # (the parent's one thread a run would walk that run serially)
    rows = torch.from_numpy(rng.permutation(len(okey))[:N_SKEW_ROWS]).to(dev)
    okey[rows] = int(okey[len(okey) // 2])
    late[rows] = True
    case("merge_cmp_probe", "<> skewed: 10M rows on one key",
         lambda: (J.merge_cmp_probe(okey, late, supp, p_okey, p_alive,
                                    p_supp, "<>"),),
         lambda: (J.merge_cmp_probe_plain(okey, late, supp, p_okey, p_alive,
                                          p_supp, "<>"),),
         plain_reps=3, bound_bytes=k8_bytes)
    k8_limit("<> skewed", okey, late, supp, p_okey, p_alive)
    del lines, okey, supp, late, pick, p_okey, p_supp, p_alive, rows
    torch.cuda.empty_cache()

    for live, main in ((0.5, True), (0.01, False)):
        mask = torch.from_numpy(rng.random(n) < live).to(dev)
        case("sort_groupby_compact", f"partition 60M, {live:.0%} live",
             lambda mask=mask: (K.stable_partition(mask),),
             lambda mask=mask: (K.compact_order(mask),),
             main=main, inputs=(mask,),
             library=lambda mask=mask: torch.argsort(~mask, stable=True))
    del mask
    k9_limits(case, n, dev)
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
    phase_window_kernels(case, dev)


def phase_window_kernels(case, dev):
    """W1-W4 against their plain versions at the SF10 window queries'
    shapes: N_KERNEL_ROWS lineitem-like rows in N_SUPPLIERS partitions
    (W-Q1, W-Q5), in N_PARTS partitions of ~30 rows (W-Q4) and in
    N_SEGMENTS orders of 1-7 lines (W-Q2, W-Q6), and W-Q3's single segment
    of N_WINDOW_ONE_SEGMENT orders; W3 also over float keys with NaNs, and
    W4's long route (one segment) checked at N_W4_CHECKED_ROWS rows and
    timed at W-Q3's against its chain bound, which the dependent-add probe
    (cuda.add_chain) measures. Float sums of W1 are held within 32 eps
    x the sum of the values' magnitudes (the plain version takes
    differences of a whole-array torch.cumsum, which on the card is not
    deterministic and has measured up to 7 eps x that sum from the exact
    prefix); W2, W3 and W4 bit for bit."""
    from quickstep_tpu_torch.bench.kernel_ab import sorted_segments
    from quickstep_tpu_torch.ops import window as W
    n = N_KERNEL_ROWS
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    price = torch.randint(90_000, 10_500_000, (n,), device=dev,
                          generator=gen).double() / 100
    live = torch.rand(n, device=dev, generator=gen) < 0.9

    def contrib(v, fn="sum", lv=None):
        lv = live[:len(v)] if lv is None else lv
        return W._sentinel_fill(fn, v, lv) if fn in ("min", "max") else \
            torch.where(lv, v, torch.zeros((), dtype=v.dtype, device=dev))

    def w1_atol(v, lv=None):
        return 32 * torch.finfo(v.dtype).eps * float(
            contrib(v, lv=lv).abs().sum())

    # W-Q1: whole-partition sums over the suppliers' partitions (W1's
    # whole-partition mode), twice to the same bits
    seg, seg_id = sorted_segments(n, N_SUPPLIERS, dev, gen)
    c = contrib(price)
    case("window_prefix", "whole-partition sum f64, 60M, 100K parts",
         lambda: W.segment_totals("sum", c, live, seg),
         lambda: W.segmented_prefix_plain("sum", c, live, seg, seg),
         main=True, inputs=(c, live, seg), atol=w1_atol(price))
    case("window_prefix", "whole-partition sum f64, run twice",
         lambda: W.segment_totals("sum", c, live, seg),
         lambda: W.segment_totals("sum", c, live, seg), atol=0, plain_reps=1)
    qty = torch.randint(100, 5_001, (n,), device=dev, generator=gen)
    cq = contrib(qty, "max")
    case("window_prefix", "whole-partition max i64, 100K parts",
         lambda: W.segment_totals("max", cq, live, seg),
         lambda: W.segmented_prefix_plain("max", cq, live, seg, seg),
         bound_bytes=nbytes((cq, live, seg)) + 16 * n)
    peer = seg | (torch.rand(n, device=dev, generator=gen) < 0.2)
    case("window_prefix", "running max i64, 100K partitions",
         lambda: W.segmented_prefix("max", cq, live, seg, peer),
         lambda: W.segmented_prefix_plain("max", cq, live, seg, peer),
         bound_bytes=nbytes((cq, live, seg, peer)) + 16 * n)
    # W-Q5: RANGE +-30 over int32 date codes sorted inside each partition
    codes = torch.randint(0, 3_600, (n,), device=dev, generator=gen)
    key = (torch.sort(seg_id * 4_096 + codes)[0] - seg_id * 4_096).to(
        torch.int32)
    del codes
    case("frame_bounds", "RANGE +-30, int32 keys, 100K partitions",
         lambda: W.frame_bounds(seg, "range", 30, 30, key),
         lambda: W.frame_bounds_plain(seg, "range", 30, 30, key),
         main=True, inputs=(seg, key))
    lo, hi = W.frame_bounds(seg, "range", 30, 30, key)
    case("frame_minmax", "MAX i64 over RANGE +-30 frames",
         lambda: (W.frame_minmax("max", cq, lo, hi),),
         lambda: (W.frame_minmax_plain("max", cq, lo, hi),),
         main=True, inputs=(cq, lo, hi), atol=0)
    del seg, seg_id, cq, peer, key, lo, hi, qty
    torch.cuda.empty_cache()

    # W-Q5's partitions, RANGE +-3 over float64 keys a twentieth NaN
    # (sorted last in each partition): a NaN row's frame is empty at its
    # partition's first row, and the row after it searches afresh
    m = N_W3_FLOAT_ROWS
    seg, seg_id = sorted_segments(m, N_SUPPLIERS * m // n, dev, gen)
    fkey = torch.randint(0, 3_600, (m,), device=dev, generator=gen).double()
    fkey[torch.rand(m, device=dev, generator=gen) < 0.05] = math.nan
    nan = torch.isnan(fkey)
    fkey = fkey[torch.sort(seg_id * 8_192 + torch.where(
        nan, 4_096, fkey.nan_to_num().long()))[1]]
    case("frame_bounds", "RANGE +-3, f64 keys with NaN",
         lambda: W.frame_bounds(seg, "range", 3, 3, fkey),
         lambda: W.frame_bounds_plain(seg, "range", 3, 3, fkey), plain_reps=2)
    del seg, seg_id, fkey, nan
    torch.cuda.empty_cache()

    # W-Q4: ROWS 3 PRECEDING .. CURRENT ROW over ~30-row partitions; W3
    # reads the flags and writes lo and hi
    seg, _ = sorted_segments(n, N_PARTS, dev, gen)
    case("frame_bounds", "ROWS 3 preceding, 2M partitions",
         lambda: W.frame_bounds(seg, "rows", 3, 0),
         lambda: W.frame_bounds_plain(seg, "rows", 3, 0),
         bound_bytes=nbytes((seg,)) + 8 * n)
    lo, hi = W.frame_bounds(seg, "rows", 3, 0)
    case("sliding_sum", "f64, ROWS 3 preceding, 2M partitions",
         lambda: (W.sliding_sums(c, lo, hi, seg),),
         lambda: (W.sliding_sums_plain(c, lo, hi, seg),), main=True,
         inputs=(c, lo, hi, seg), atol=0)
    c32 = contrib(price.float())
    case("sliding_sum", "f32, ROWS 3 preceding, 2M partitions",
         lambda: (W.sliding_sums(c32, lo, hi, seg),),
         lambda: (W.sliding_sums_plain(c32, lo, hi, seg),), atol=0)
    del c32, lo, hi, seg
    torch.cuda.empty_cache()

    # W-Q2 and W-Q6: orders of 1-7 lines
    lines = torch.randint(1, 8, (N_SEGMENTS,), device=dev, generator=gen)
    seg = torch.zeros(int(lines.sum()), dtype=torch.bool, device=dev)
    seg[torch.cumsum(lines, 0)[:-1]] = True
    seg[0] = True
    m = len(seg)
    every = torch.ones(m, dtype=torch.bool, device=dev)
    lm = torch.rand(m, device=dev, generator=gen) < 0.9
    case("window_prefix", "running count, 15M orders of 1-7 lines",
         lambda: W.segmented_prefix("count", None, lm, seg, every),
         lambda: W.segmented_prefix_plain("count", None, lm, seg, every),
         bound_bytes=nbytes((lm, seg, every)) + 8 * m)
    lo, hi = W.frame_bounds(seg, "rows", 1, 1)
    cmin = contrib(torch.randint(90_000, 10_500_000, (m,), device=dev,
                                 generator=gen).double() / 100, "min", lm)
    case("frame_minmax", "MIN f64, ROWS 1/1, 15M orders",
         lambda: (W.frame_minmax("min", cmin, lo, hi),),
         lambda: (W.frame_minmax_plain("min", cmin, lo, hi),),
         atol=0, nan_equal=True,
         bound_bytes=nbytes((cmin, lo, hi)) + 8 * m)
    del lines, seg, every, lm, lo, hi, cmin
    torch.cuda.empty_cache()

    # W-Q3: one segment of N_WINDOW_ONE_SEGMENT rows, ~2,400 peer groups
    m = N_WINDOW_ONE_SEGMENT
    seg = torch.zeros(m, dtype=torch.bool, device=dev)
    seg[0] = True
    peer = seg | (torch.rand(m, device=dev, generator=gen) < 1 / 6_000)
    c1 = price[:m].contiguous()
    every = torch.ones(m, dtype=torch.bool, device=dev)
    case("window_prefix", "running sum f64, one 15M-row segment",
         lambda: W.segmented_prefix("sum", c1, every, seg, peer),
         lambda: W.segmented_prefix_plain("sum", c1, every, seg, peer),
         atol=w1_atol(c1, every),
         bound_bytes=nbytes((c1, every, seg, peer)) + 16 * m)
    # W4's long route: one segment walked by one thread, its values
    # streamed ahead of it. Bit for bit against the plain version's scalar
    # walk at N_W4_CHECKED_ROWS rows, timed at 15 M rows against its chain
    # bound: the walk's subtract and add steps x the latency of one
    # dependent add, measured here
    w4_long_route(case, c1, seg, dev)
    # W2's long frames: ROWS 1,500 PRECEDING over W-Q3's single segment,
    # in float64 and in float32: in both, the tiles' frames leave the
    # staged window, which holds the same rows for every dtype, and take
    # the table's route
    lo, hi = W.frame_bounds(seg, "rows", 1_500, 0)
    cmax = contrib(c1, "max", every)
    case("frame_minmax", "MAX f64, ROWS 1500 preceding, 15M",
         lambda: (W.frame_minmax("max", cmax, lo, hi),),
         lambda: (W.frame_minmax_plain("max", cmax, lo, hi),),
         atol=0, nan_equal=True,
         bound_bytes=nbytes((cmax, lo, hi)) + 8 * m)
    c32 = cmax.float()
    case("frame_minmax", "MAX f32, ROWS 1500 preceding, 15M",
         lambda: (W.frame_minmax("max", c32, lo, hi),),
         lambda: (W.frame_minmax_plain("max", c32, lo, hi),),
         atol=0, nan_equal=True,
         bound_bytes=nbytes((c32, lo, hi)) + 4 * m)
    no_host_sync("W2", lambda: (W.frame_minmax("max", cmax, lo, hi),
                                W.frame_minmax("max", c32, lo, hi)))
    del lo, hi, cmax, c32
    # frames longer than two of W2's 1,024-row tiles, not holding their row
    m = 6_000_000
    seg, _ = sorted_segments(m, 300, dev, gen)
    lo, hi = W.frame_bounds(seg, "rows", 5_000, 3_000)
    cmax = contrib(price[:m], "max")
    case("frame_minmax", "MAX f64, ROWS 5000/3000, 6M rows",
         lambda: (W.frame_minmax("max", cmax, lo, hi),),
         lambda: (W.frame_minmax_plain("max", cmax, lo, hi),),
         atol=0, nan_equal=True)
    del seg, peer, c1, every, lo, hi, cmax, price, live, c
    torch.cuda.empty_cache()
    phase_operator_kernels(case, dev)


def w4_long_route(case, c1, seg, dev):
    from quickstep_tpu_torch.bench.kernel_ab import w4_steps
    from quickstep_tpu_torch.ops import cuda, window as W
    k = N_W4_CHECKED_ROWS
    lo, hi = W.frame_bounds(seg[:k], "rows", 3, 0)
    for c in (c1[:k], c1[:k].float()):
        case("sliding_sum", f"{str(c.dtype)[6:]}, one {k // 10**6}M-row "
             "segment (long route)",
             lambda c=c: (W.sliding_sums(c, lo, hi, seg[:k]),),
             lambda c=c: (W.sliding_sums_plain(c, lo, hi, seg[:k]),),
             atol=0, plain_reps=1)
    lo, hi = W.frame_bounds(seg, "rows", 3, 0)
    ns = {}
    for dt in (torch.float64, torch.float32):
        x = torch.tensor([0.1, 1e-9], dtype=dt, device=dev)
        ns[dt] = cuda_ms(lambda: cuda.add_chain(x, ADD_CHAIN_STEPS),
                         reps=3) * 1e6 / ADD_CHAIN_STEPS
    log(f"  dependent add latency (one thread, {ADD_CHAIN_STEPS} adds): "
        f"f64 {ns[torch.float64]:.3f} ns, f32 {ns[torch.float32]:.3f} ns")
    steps = w4_steps(lo, hi, seg)
    ms = cuda_ms(lambda: W.sliding_sums(c1, lo, hi, seg), reps=2)
    bound = steps * ns[torch.float64] / 1e6
    log(f"  sliding_sum   f64, ROWS 3 preceding, one {len(seg) // 10**6}M-row "
        f"segment: kernel {ms:8.3f} ms  chain bound {bound:8.3f} ms "
        f"({steps} steps)  bytes bound "
        f"{(nbytes((c1, lo, hi, seg)) + 8 * len(seg)) / HBM_BYTES_PER_S * 1e3:.3f} ms")


def phase_operator_kernels(case, dev):
    """K10-K13 against their plain versions at SF10 shapes: three 60 M
    int32 key columns hashed; open addressing built over 60 M lineitem-like
    (part, supplier) pairs, full of duplicates, and probed by partsupp's
    8 M pairs, the other way round, and with 10 M rows on one key;
    COUNT(DISTINCT) over 60 M int32 values; and ORDER BY over
    60 M rows by a DOUBLE DESC key, a nullable int key and an int
    tiebreak, by five keys (a nullable bool and a float32 before those),
    and by three 64-bit keys over their whole range (more than 128
    significant bits), each with its random-sector limit. K11 runs at
    O-Q2's and O-Q3's shapes and with a skewed build (k11_case)."""
    from quickstep_tpu_torch.ops import cuda, groupby as G
    from quickstep_tpu_torch.ops import kernels as K
    from quickstep_tpu_torch.ops import sort as S
    n = N_KERNEL_ROWS
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    cols = [torch.randint(1, hi, (n,), device=dev, generator=gen,
                          dtype=torch.int32)
            for hi in (60_000_000, 2_000_000, 100_000)]
    case("hash_keys", "3 int32 columns, 60M rows",
         lambda: (K.hash_keys(cols),), lambda: (K.hash_keys_plain(cols),),
         main=True, inputs=cols, atol=0)
    del cols

    for shape, label in K11_CASES:
        k11_case(case, dev, gen, shape, label)
        torch.cuda.empty_cache()

    vals = torch.randint(1, 2_000_001, (n,), device=dev, generator=gen,
                         dtype=torch.int32)
    every = torch.ones(n, dtype=torch.bool, device=dev)
    case("distinct_count", "COUNT(DISTINCT) 60M int32",
         lambda: (G.distinct_count(vals, None, every),),
         lambda: (G.distinct_count_plain(vals, None, every),), main=True,
         inputs=(vals, every), atol=0,
         library=lambda: torch.unique(vals).numel())
    case("distinct_sort", "radix sort 60M int32",
         lambda: G._sorted_live(vals, None, every),
         lambda: G._sorted_live_plain(vals, None, every), main=True,
         inputs=(vals, every), atol=0,
         library=lambda: torch.sort(vals, stable=True)[0])
    log(f"  distinct_sort passes skipped: {skipped_passes(vals)} of 4")
    half = torch.rand(n, device=dev, generator=gen) < 0.5
    case("distinct_count", "SUM(DISTINCT) mask, 60M, half live",
         lambda: G.dedup_values(vals, None, half),
         lambda: G.dedup_values_plain(vals, None, half), atol=0)
    wide = torch.randint(0, 1 << 33, (n,), device=dev, generator=gen)
    case("distinct_count", "DISTINCT mask, 60M int64 of 33 bits",
         lambda: G.dedup_values(wide, None, half),
         lambda: G.dedup_values_plain(wide, None, half), atol=0)
    log(f"  distinct_sort passes skipped: {skipped_passes(wide)} of 8")
    del wide
    edges = float_edges(n, dev, gen)

    def bits(out):
        s, mask = out
        return s.view(torch.int64), mask
    case("distinct_count", "DISTINCT mask, 60M float64 edges",
         lambda: bits(G.dedup_values(edges, None, half)),
         lambda: bits(G.dedup_values_plain(edges, None, half)), atol=0)
    del edges
    no_torch_sort(dev, gen)
    s_vals, n_live = G._sorted_live(vals, None, half)
    case("distinct_count", "run starts alone, 60M sorted",
         lambda: (cuda.run_starts(s_vals, n_live, count=True),),
         lambda: (G.run_starts_plain(s_vals, n_live).sum(
             dtype=torch.int64),), atol=0)
    del vals, every, half, s_vals, n_live
    torch.cuda.empty_cache()

    price = torch.randint(90_000, 10_500_000, (n,), device=dev,
                          generator=gen).double() / 100
    qty = torch.randint(1, 51, (n,), device=dev, generator=gen,
                        dtype=torch.int32)
    qvalid = torch.rand(n, device=dev, generator=gen) < 0.9
    tie = torch.randperm(n, device=dev, generator=gen)
    alive = torch.rand(n, device=dev, generator=gen) < 0.95
    args = ([price, qty, tie], [None, qvalid, None], [False, True, True],
            [None, None, None], alive)
    case("order_permutation", "3 keys, 60M rows",
         lambda: (S.order_permutation(*args),),
         lambda: (S.order_permutation_plain(*args),), main=True,
         inputs=(price, qty, qvalid, tie, alive), atol=0)
    k13_limit("3 keys, 60M rows", args)
    # five keys: the same three after a nullable bool DESC and a float32
    flag = torch.rand(n, device=dev, generator=gen) < 0.3
    disc = (torch.randint(0, 11, (n,), device=dev, generator=gen) / 100
            ).float()
    five = ([flag, disc, price, qty, tie], [qvalid, None, None, qvalid, None],
            [False, True, False, True, True], [True, None, None, False, None],
            alive)
    case("order_permutation", "5 keys, 60M rows",
         lambda: (S.order_permutation(*five),),
         lambda: (S.order_permutation_plain(*five),), atol=0, plain_reps=3,
         bound_bytes=nbytes((flag, disc, price, qty, qvalid, tie, alive)) +
         8 * n)
    k13_limit("5 keys, 60M rows", five)
    # more than 128 significant bits: a float64 of every bit pattern and
    # two int64 keys over their whole range
    wide = [torch.randint(-2**63, 2**63 - 1, (n,), device=dev, generator=gen)
            for _ in range(3)]
    wide[0] = wide[0].view(torch.float64)
    over = (wide, [None, qvalid, None], [True, False, True],
            [None, None, None], alive)
    case("order_permutation", "3 keys of 64 bits, 60M rows",
         lambda: (S.order_permutation(*over),),
         lambda: (S.order_permutation_plain(*over),), atol=0, plain_reps=3,
         bound_bytes=nbytes((*wide, qvalid, alive)) + 8 * n)
    k13_limit("3 keys of 64 bits", over)
    del price, qty, qvalid, tie, alive, args, flag, disc, five, wide, over
    torch.cuda.empty_cache()
    phase_shuffle_kernels(case, dev)


K11_CASES = (("oq2", "O-Q2: build 60M pairs, probe 8M"),
             ("oq3", "O-Q3: build 8M pairs, probe 60M"),
             ("skewed", "O-Q2, 10M rows on one key"))


def k11_case(case, dev, gen, shape, label):
    """K11 at one of kernel_ab's k11_inputs shapes (O-Q2's is the main
    case), its build and probe timed together; the check that every matched
    row holds the probe's key runs outside the time. Its bound counts what
    the function needs, whatever the layout: its key columns and masks read
    once, a table of 4-byte row ids (the plain version's) filled once and
    its outputs written once. The fill of the key-in-slot route's own
    16-byte slots is logged beside it, as is the random-sector limit: one
    32-byte sector for each live build row (the slot it reads or claims)
    and each live probe row (the slot it compares)."""
    from quickstep_tpu_torch.bench.kernel_ab import k11_inputs
    from quickstep_tpu_torch.ops import join as J
    build, balive, probe, palive, size = k11_inputs(shape, dev, gen)

    def run(oa_build, oa_probe):
        table, dup = oa_build(build, balive, size)
        return (dup,) + tuple(oa_probe(table, build, probe, palive))

    def check(out):
        dup, idx, matched = out
        held = torch.ones((), dtype=torch.bool, device=dev)
        for b, p in zip(build, probe):
            held = held & torch.all(b[idx.long()[matched]] == p[matched])
        return dup, matched, held

    n_probe = len(palive)
    case("open_addressing", f"{label} (check untimed)",
         lambda: run(J.oa_build, J.oa_probe),
         lambda: run(J.oa_build_plain, J.oa_probe_plain),
         main=shape == "oq2", plain_reps=2, check=check,
         bound_bytes=nbytes(build + probe + [balive, palive]) + 4 * size +
         5 * n_probe)
    log(f"  open_addressing {label}: the key-in-slot table's fill, 16 B a "
        f"slot x {size} slots, {16 * size / HBM_BYTES_PER_S * 1e3:.3f} ms at"
        " the memory rate")
    sectors = int(balive.sum()) + int(palive.sum())
    log(f"  open_addressing {label}: random-sector limit {sectors} sectors,"
        f" {sectors * SECTOR_BYTES / HBM_BYTES_PER_S * 1e3:.3f} ms at 32 B,"
        f" {sectors / 3.128e10 * 1e3:.3f} ms at 3.128e10 sectors/s")


def skipped_passes(v):
    """K12's passes over integers that its plan skips: the 8-bit digits
    of the values' bits that are the same in every row (the key is the
    bits with the sign flipped, so its digits vary where the bits' do)."""
    x = v.view(torch.int32 if v.element_size() == 4 else torch.int64)
    return sum(int(((x >> (8 * p)) & 255).min()) ==
               int(((x >> (8 * p)) & 255).max())
               for p in range(v.element_size()))


def float_edges(n, dev, gen):
    """n float64 values from a small domain, a third of them -0.0, +0.0,
    -inf, +inf or NaNs of both signs with several payloads."""
    v = torch.randint(-500, 500, (n,), device=dev, generator=gen) / 4
    nan_bits = [0x7ff8000000000000, 0xfff8000000000000 - (1 << 64),
                0x7ff0000000000001, 0xfff0000000000123 - (1 << 64)]
    pool = torch.cat([torch.tensor([0.0, -0.0, math.inf, -math.inf],
                                   dtype=torch.float64),
                      torch.tensor(nan_bits).view(torch.float64)]).to(dev)
    pick = torch.randint(0, len(pool), (n,), device=dev, generator=gen)
    edge = torch.rand(n, device=dev, generator=gen) < 1 / 3
    return torch.where(edge, pool[pick], v)


def no_torch_sort(dev, gen):
    """distinct_count and dedup_values on the card, for every dtype the
    sort takes, with torch.sort and torch.unique made to raise: the K12
    radix sort and run starts launch, and the results equal the plain
    versions'."""
    from quickstep_tpu_torch.ops import cuda, groupby as G
    n = 1_000_003
    alive = torch.rand(n, device=dev, generator=gen) < 0.8
    cols = {torch.int32: torch.randint(-99, 99, (n,), device=dev,
                                       generator=gen, dtype=torch.int32),
            torch.int64: torch.randint(-99, 99, (n,), device=dev,
                                       generator=gen),
            torch.float32: float_edges(n, dev, gen).float(),
            torch.float64: float_edges(n, dev, gen),
            torch.bool: alive.roll(1)}
    sort, unique = torch.sort, torch.unique

    def refuse(*args, **kwargs):
        raise AssertionError("torch.sort or torch.unique on the CUDA path")
    for dt, v in cols.items():
        cuda.reset_launches()
        torch.sort = torch.unique = refuse
        try:
            got = (G.distinct_count(v, None, alive),
                   *G.dedup_values(v, None, alive))
        finally:
            torch.sort, torch.unique = sort, unique
        if cuda.LAUNCHES["distinct_sort"] != 2 or \
                cuda.LAUNCHES["distinct_count"] != 2:
            raise AssertionError(f"DISTINCT over {dt}: {cuda.LAUNCHES}")
        want = (G.distinct_count_plain(v, None, alive),
                *G.dedup_values_plain(v, None, alive))
        as_bits = {torch.float32: torch.int32, torch.float64: torch.int64}
        compare(f"DISTINCT over {dt}",
                [t.view(as_bits.get(t.dtype, t.dtype)) for t in got],
                [t.view(as_bits.get(t.dtype, t.dtype)) for t in want], atol=0)
    log(f"  distinct_count and dedup_values over {len(cols)} dtypes: no "
        "torch.sort or torch.unique, equal to the plain versions")


def phase_shuffle_kernels(case, dev):
    """K14-K16 against their plain versions at the mesh path's SF10 shapes:
    the radix partition of one lineitem shard (N_SHARD_ROWS int64 keys, 95 %
    live) into MESH_SHARDS buckets of twice the mean share, a salted build
    side, buckets that overflow and the shuffle census's median probe
    slice; K15's bucket route on those destinations and counts (the main
    case: the gather index and occupied mask of every slot) and its
    generic scatter of row ids into the buckets; a bloom filter of 2^22
    slots built over N_BUILD_ROWS orders keys and probed by N_KERNEL_ROWS
    lineitem keys."""
    from quickstep_tpu_torch.ops import bloom as B, kernels as K
    from quickstep_tpu_torch.parallel import shuffle as SH
    n, parts = N_SHARD_ROWS, MESH_SHARDS
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    key = torch.randint(1, 4 * N_BUILD_ROWS, (n,), device=dev, generator=gen)
    alive = torch.rand(n, device=dev, generator=gen) < 0.95
    cap = 2 * n // parts
    case("partition_dest", "7.5M int64 keys, 8 buckets",
         lambda: SH.partition_dest(key, alive, parts, cap),
         lambda: SH.partition_dest_plain(key, alive, parts, cap), main=True,
         inputs=(key, alive), plain_reps=3)
    case("partition_dest", "build side, salt 4",
         lambda: SH.partition_dest(key, alive, parts, 4 * cap, 4, False),
         lambda: SH.partition_dest_plain(key, alive, parts, 4 * cap, 4,
                                         False), plain_reps=2,
         bound_bytes=nbytes((key, alive)) + 4 * 4 * n)
    small = n // parts * 9 // 10
    case("partition_dest", "buckets that overflow",
         lambda: SH.partition_dest(key, alive, parts, small, with_counts=True),
         lambda: SH.partition_dest_plain(key, alive, parts, small,
                                         with_counts=True), plain_reps=2)
    if not bool(SH.partition_dest(key, alive, parts, small)[1]):
        raise AssertionError("partition_dest: no overflow past the buckets")
    # the shuffle census's median probe slice, at an odd offset
    m = N_MEDIAN_SLICE
    k, a = key[1:m + 1], alive[1:m + 1]
    case("partition_dest", "census median slice",
         lambda: SH.partition_dest(k, a, parts, 2 * m // parts,
                                   with_counts=True),
         lambda: SH.partition_dest_plain(k, a, parts, 2 * m // parts,
                                         with_counts=True), plain_reps=3,
         bound_bytes=nbytes((k, a)) + 4 * m)
    dest, _, counts = SH.partition_dest(key, alive, parts, cap,
                                        with_counts=True)
    slots = parts * cap
    # K15's route: dest read once, each slot's index and flag written once
    case("scatter_compact", "bucket route, 8 buckets",
         lambda: SH.bucket_rows(dest, counts, n, cap),
         lambda: SH.bucket_rows_plain(dest, counts, n, cap), main=True,
         bound_bytes=nbytes((dest, counts)) + 5 * slots)
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    case("scatter_compact", "generic, 7.5M row ids",
         lambda: (K.scatter_compact(rows, dest, slots, fill=-1),),
         lambda: (K.scatter_compact_plain(rows, dest, slots, fill=-1),),
         bound_bytes=nbytes((rows, dest)) + 4 * slots)
    no_host_sync("K14, K15", lambda: [
        SH.bucket_rows(*SH.partition_dest(key, alive, parts, c, salt, side,
                                          with_counts=True)[::2], n, c)
        for c, salt, side in ((cap, 1, True), (4 * cap, 4, False))])
    del key, alive, dest, counts, rows, k, a

    # K16: the table is one bit a slot in int32 words on the card, read
    # back as the plain version's bools
    nbits = 1 << 22
    okey = torch.arange(1, N_BUILD_ROWS + 1, device=dev) * 4
    oalive = torch.rand(N_BUILD_ROWS, device=dev, generator=gen) < 0.5
    case("bloom_filter", "build 15M keys, 2^22 slots",
         lambda: (B.bloom_build([okey], oalive, nbits),),
         lambda: (B.bloom_build_plain([okey], oalive, nbits),),
         decode=lambda got: (B.presence_bits(got[0], nbits),),
         bound_bytes=nbytes((okey, oalive)) + nbits // 8)
    words = B.bloom_build([okey], oalive, nbits)
    bits = B.bloom_build_plain([okey], oalive, nbits)
    lkey = torch.randint(1, 4 * N_BUILD_ROWS + 4, (N_KERNEL_ROWS,),
                         device=dev, generator=gen)
    lalive = torch.rand(N_KERNEL_ROWS, device=dev, generator=gen) < 0.9
    case("bloom_filter", "probe 60M keys, 2^22 slots",
         lambda: (B.bloom_probe(words, [lkey], lalive, nbits),),
         lambda: (B.bloom_probe_plain(bits, [lkey], lalive),), main=True,
         inputs=(words, lkey, lalive))
    # a mesh shard's slice, at an odd offset
    k, a = lkey[1:N_K16_SLICE + 1], lalive[1:N_K16_SLICE + 1]
    case("bloom_filter", "probe shard slice",
         lambda: (B.bloom_probe(words, [k], a, nbits),),
         lambda: (B.bloom_probe_plain(bits, [k], a),),
         bound_bytes=nbytes((words, k, a)) + N_K16_SLICE)
    # a table that L1 mostly holds
    small = 1 << 20
    swords = B.bloom_build([okey], oalive, small)
    sbits = B.bloom_build_plain([okey], oalive, small)
    case("bloom_filter", "probe 60M keys, 2^20 slots",
         lambda: (B.bloom_probe(swords, [lkey], lalive, small),),
         lambda: (B.bloom_probe_plain(sbits, [lkey], lalive),),
         bound_bytes=nbytes((swords, lkey, lalive)) + N_KERNEL_ROWS)
    no_host_sync("K16", lambda: [
        B.bloom_probe(B.bloom_build([okey], oalive, slots), [lkey], lalive,
                      slots)
        for slots in (nbits, small)])
    del okey, oalive, bits, words, lkey, lalive, swords, sbits
    torch.cuda.empty_cache()


def no_host_sync(what, fn):
    """fn's kernels run with no host sync: the card's sync debug mode
    raises on one."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"  {what}: no host sync")


def phase_zero_rows():
    """Every kernel's public function on an empty input (an empty build
    side under a few probe rows for the join kernels): no launch, and the
    plain version's result. Then every operator over inputs of zero rows in
    SQL on the card (bench/zero_rows.py, an empty table's VARCHAR column
    among them) against sqlite."""
    from quickstep_tpu_torch.bench.zero_rows import (
        ZERO_ROW_QUERIES, zero_row_cases, zero_row_sql_mismatches)
    from quickstep_tpu_torch.ops import cuda
    cases = zero_row_cases(torch.device("cuda"))
    if set(cases) != set(KERNELS):
        raise AssertionError(f"zero-row cases {sorted(cases)}")
    for name, (k_fn, p_fn) in cases.items():
        cuda.reset_launches()
        got = k_fn()
        torch.cuda.synchronize()
        launched = {k: v for k, v in cuda.LAUNCHES.items() if v}
        if launched:
            raise AssertionError(f"{name} at zero rows launched {launched}")
        compare(f"{name} n = 0", got, p_fn(), atol=0)
    log(f"  n = 0: all {len(cases)} kernels launch nothing and agree")
    bad = zero_row_sql_mismatches("cuda")
    if bad:
        raise AssertionError("zero-row SQL on the card: " + "; ".join(bad))
    log(f"  zero-row SQL: {len(ZERO_ROW_QUERIES)} statements match sqlite")


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


def phase_small(cuda, mesh_shards=None):
    """The 22 TPC-H queries and the Q20 variant at SF_SMALL against sqlite,
    on one device or, with mesh_shards, on a mesh of that many shards of
    the card with the large tables sharded (SMALL_MESH_THRESHOLD); the
    mesh's shuffle joins must launch K14 and K15."""
    from quickstep_tpu_torch import Database
    from quickstep_tpu_torch.bench.tpch import (
        load_tpch, load_sqlite, to_sqlite_sql)
    from quickstep_tpu_torch.config import Config
    where = "one device" if mesh_shards is None else \
        f"an {mesh_shards}-shard mesh"
    log(f"phase 2{'' if mesh_shards is None else 'c'}: TPC-H SF{SF_SMALL} "
        f"on {where} against sqlite")
    cfg = Config()
    if mesh_shards is not None:
        cfg.distributed = True
        cfg.replicate_threshold_rows = SMALL_MESH_THRESHOLD
    db = Database(config=cfg, device="cuda", mesh_shards=mesh_shards)
    total = dict.fromkeys(cuda.LAUNCHES, 0)
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
            for k, v in cuda.LAUNCHES.items():
                total[k] += v
    finally:
        db.close()
    if mesh_shards is not None and not (total["partition_dest"] and
                                        total["scatter_compact"]):
        raise AssertionError(f"the SF{SF_SMALL} mesh never shuffled: {total}")
    return total


def phase_golden(cuda):
    """The reference's golden corpus through the port's harness on the card:
    tiny tables and empty relations on the real kernels. Returns the
    kernels' launches."""
    import pathlib
    from quickstep_tpu_torch.bench.golden_corpus import (
        corpus_files, count_cases, run_file)
    root = pathlib.Path(__file__).resolve().parent
    files = corpus_files(str(root))
    if len(files) != 19:
        raise AssertionError(f"golden corpus: {len(files)} files, not 19")
    log(f"phase 2b: the golden corpus on the card, {len(files)} files")
    t0 = time.perf_counter()
    failures = []
    cuda.reset_launches()
    for path in files:
        failures += run_file(path, "cuda")
    launches = dict(cuda.LAUNCHES)
    if failures:
        raise AssertionError(f"{len(failures)} golden mismatches\n"
                             + "\n\n".join(failures[:5]))
    log(f"  {sum(count_cases(p) for p in files)} cases match in "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


def run_query(db, cuda, oracle, total, label, q, must, sql=None,
              rel_tol=None, warm=WARM_RUNS, per_run=None, rows_out=None):
    """One query cold and `warm` times warm against the exact oracle, its
    launches counted from 0 (they must include `must`, and per_run's
    kernels exactly that many times a run) and added to total; warm runs
    must take one host sync and no retry, and their plans from the
    logical-plan cache (the cold run's entries, unchanged). Each run's rows
    go to the list rows_out when one is given. Returns (times in ms, peak
    device memory in GiB)."""
    from quickstep_tpu_torch.bench.tpch import TPCH_QUERIES, with_tiebreak
    from quickstep_tpu_torch.bench.tpch_fullgen import (
        ORACLE_REL_TOL, check_rows)
    sql = sql or with_tiebreak(q, TPCH_QUERIES[q])
    rel_tol = ORACLE_REL_TOL if rel_tol is None else rel_tol
    times, syncs, retries = [], [], []
    plans = db.executor._logical_plan_cache
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launches()
    for run in range(1 + warm):
        t0 = time.perf_counter()
        rows = db.execute(sql).rows
        times.append((time.perf_counter() - t0) * 1000)
        if rows_out is not None:
            rows_out.append(rows)
        syncs.append(db.executor.host_syncs)
        retries.append(db.executor.retries)
        check_rows(q, rows, oracle, rel_tol)
        if run == 0:
            cached = dict(plans)
            if not cached:
                raise AssertionError(f"{label}: no plan cached")
        elif plans.keys() != cached.keys() or \
                any(plans[k] is not v for k, v in cached.items()):
            raise AssertionError(f"{label} warm run {run} planned anew: "
                                 "its plan was not taken from the cache")
    launches = dict(cuda.LAUNCHES)
    missing = [k for k in must if not launches[k]]
    if missing:
        raise AssertionError(f"{label} never launched {missing}")
    for k, v in (per_run or {}).items():
        if launches[k] != v * (1 + warm):
            raise AssertionError(f"{label} launched {k} {launches[k]} times "
                                 f"in {1 + warm} runs, not {v} a run")
    if any(r != 0 or s != 1 for r, s in zip(retries[1:], syncs[1:])):
        raise AssertionError(f"{label} warm runs: host syncs "
                             f"{syncs[1:]}, retries {retries[1:]}")
    for k, v in launches.items():
        total[k] += v
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  {label}: cold {times[0]:.1f} ms, warm "
        + ", ".join(f"{t:.1f}" for t in times[1:])
        + f" ms; {len(rows)} rows match the exact oracle; host syncs"
        f" {syncs}, retries {retries}; peak device memory "
        f"{peak:.2f} GiB; "
        "launches " + ", ".join(f"{k} {v}" for k, v in
                                 launches.items() if v))
    return times, peak


class bloom_census:
    """Records the rows and slots of every K16 launch made while it is
    entered (calls of ops/cuda.py bloom_build and bloom_probe with rows),
    in .calls: (kind, rows, slots)."""

    def __enter__(self):
        from quickstep_tpu_torch.ops import cuda
        self.cuda, self.calls = cuda, []
        self.real = real_build, real_probe = cuda.bloom_build, cuda.bloom_probe

        def build(cols, alive, nbits):
            if alive.shape[0]:
                self.calls.append(("build", int(alive.shape[0]), nbits))
            return real_build(cols, alive, nbits)

        def probe(words, cols, alive, nbits=None):
            n = int(alive.shape[0])
            slots = 32 * int(words.shape[0]) if nbits is None else nbits
            if n:
                self.calls.append(("probe", n, slots))
            return real_probe(words, cols, alive, nbits)
        cuda.bloom_build, cuda.bloom_probe = build, probe
        return self

    def __exit__(self, *exc):
        self.cuda.bloom_build, self.cuda.bloom_probe = self.real

    def report(self, label):
        """Logs, for builds and probes: launches, median and largest rows,
        the share under 1 M rows and the slots."""
        for kind in ("build", "probe"):
            mine = [c for c in self.calls if c[0] == kind]
            if not mine:
                log(f"  K16 census, {label}: no {kind}")
                continue
            rows = sorted(c[1] for c in mine)
            slots = {b: sum(c[2] == b for c in mine)
                     for b in sorted({c[2] for c in mine})}
            log(f"  K16 census, {label}: {len(mine)} {kind} launches, rows "
                f"median {statistics.median(rows)}, largest {rows[-1]}, "
                f"{sum(r < 1_000_000 for r in rows) / len(rows):.3f} under "
                f"1 M; slots {slots}")


class watch_compactions:
    """Counts the calls of PlanRunner._compact_chunk on the card and the
    torch.sort and torch.argsort calls made inside them (into the dict it
    yields: calls, sorts)."""

    def __enter__(self):
        from quickstep_tpu_torch.exec.runner import PlanRunner
        self.seen = {"calls": 0, "sorts": []}
        self.real = (PlanRunner._compact_chunk, torch.sort, torch.argsort)
        inside = [False]
        seen, (compact, sort, argsort) = self.seen, self.real

        def watched(runner, chunk, target):
            if chunk.alive.is_cuda:
                seen["calls"] += 1
            inside[0] = True
            try:
                return compact(runner, chunk, target)
            finally:
                inside[0] = False

        def spy(name, fn):
            def call(*args, **kwargs):
                if inside[0]:
                    seen["sorts"].append(name)
                return fn(*args, **kwargs)
            return call
        PlanRunner._compact_chunk = watched
        torch.sort, torch.argsort = spy("sort", sort), spy("argsort", argsort)
        return self.seen

    def __exit__(self, *exc):
        from quickstep_tpu_torch.exec.runner import PlanRunner
        PlanRunner._compact_chunk, torch.sort, torch.argsort = self.real
        return False


def generate_large():
    """All 8 TPC-H tables at SF_LARGE in host memory with every exact
    oracle the SF_LARGE phases check: (tables, stats, oracle, a line that
    says what it took)."""
    from quickstep_tpu_torch.bench.tpch_fullgen import (
        extra_oracles, generate, operator_oracles, window_oracles)
    t0 = time.perf_counter()
    tables, stats, oracle = generate(SF_LARGE, log=lambda msg: None)
    t1 = time.perf_counter()
    oracle.update(extra_oracles(tables, Q11_SPEC_FRACTION))
    for more in (window_oracles, operator_oracles):
        oracle.update(more(tables))
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    return tables, stats, oracle, (
        f"generated {oracle['rows']} in {t1 - t0:.1f} s, the oracles in "
        f"{time.perf_counter() - t1:.1f} s; peak host RSS {rss:.2f} GiB")


def build_while(work):
    """ops/cuda.py build() in a thread while work() runs in this one (nvcc's
    processes and the host generator share the machine's cores); returns
    work()'s result, or raises the build's error."""
    from quickstep_tpu_torch.ops import cuda
    failed = []

    def build():
        try:
            cuda.build()
        except BaseException as e:     # raised again below, in this thread
            failed.append(e)
    thread = threading.Thread(target=build)
    thread.start()
    try:
        out = work()
    finally:
        thread.join()
    if failed:
        raise failed[0]
    return out


def phase_large(cuda, generated):
    """The generated tables (generate_large) in a database on the card,
    each query cold and WARM_RUNS warm against the exact oracle: the 22
    TPC-H queries and the Q11 variant, then the window queries. Each
    query's launches are counted from 0 and must include the kernels
    LARGE_QUERIES, Q11_SPEC_KERNELS, STALE_PARTSUPP_Q9 or WINDOW_RUNS
    names. Returns their sum and the times and peak memory of the
    MESH_QUERIES; the database's device copies are dropped before it
    returns."""
    import pathlib
    from quickstep_tpu_torch import Database
    from quickstep_tpu_torch.bench.tpch_fullgen import (
        OPERATOR_QUERIES, WINDOW_QUERIES, WINDOW_REL_TOL, load_tables,
        q11_with_fraction)
    log(f"phase 3: all 8 TPC-H tables at SF{SF_LARGE:g} on the card")
    tables, stats, oracle, made = generated
    log(f"  {made} (while nvcc built the kernels)")
    db = Database(device="cuda")
    try:
        load_tables(db, tables, stats)
        ties = oracle["ties"]
        log("  rows whose comparison with a computed value ties in exact "
            "integers (kept by the engine's comparison): " + ", ".join(
                f"{name} {t['rows']} ({t['kept']})" for name, t in
                ties.items() if name != "q15_top2"))
        top, second = ties["q15_top2"]
        if top == second:
            raise AssertionError(f"Q15's two largest revenues tie: {top}")
        log(f"  Q15's two largest revenues (scale 4): {top}, {second}")
        total = dict.fromkeys(cuda.LAUNCHES, 0)
        single = {}

        def run(label, q, must, sql=None, rel_tol=None, per_run=None):
            return run_query(db, cuda, oracle, total, label, q, must, sql,
                             rel_tol, per_run=per_run)

        runs = [(f"Q{q}", q, must, None) for q, must in LARGE_QUERIES.items()]
        runs.append((f"Q11, fraction {Q11_SPEC_FRACTION}", "q11_spec",
                     Q11_SPEC_KERNELS, q11_with_fraction(Q11_SPEC_FRACTION)))
        with watch_compactions() as seen:
            for label, q, must, sql in runs:
                seen.update(calls=0, sorts=[])
                times = run(label, q, must, sql,
                            per_run=Q1_PER_RUN if q == 1 else None)
                if q in MESH_QUERIES + MESH_AGG_QUERIES:
                    single[q] = times
                if seen["sorts"] or (q in COMPACTING) != (seen["calls"] > 0):
                    raise AssertionError(
                        f"{label}: {seen['calls']} compactions, library "
                        f"sorts inside them {seen['sorts']}")
                log(f"    {seen['calls']} compactions through K9, no "
                    "library sort inside")
        root = pathlib.Path(__file__).resolve().parent
        with open(root / "SF10_VERIFY.json") as f:
            reference = json.load(f)["queries"]
        log("  rows of each query, beside the reference's SF10 run against "
            "sqlite (SF10_VERIFY.json): " + ", ".join(
                f"Q{q} {len(oracle[f'q{q}'])}/{reference[str(q)]['rows']}"
                for q in range(1, 23)) +
            f"; Q11 at {Q11_SPEC_FRACTION} {len(oracle['q11_spec'])}")
        cols = [t for key, (cs, _m) in db.executor._device_cache.items()
                for name, pair in cs.items()
                if name != "__num_rows__" for t in pair if t is not None]
        resident = sorted({key[0] for key in db.executor._device_cache})
        if set(resident) != set(oracle["rows"]) or any(
                t.device.type != "cuda" for t in cols):
            raise AssertionError(f"not every table is resident: {resident}")
        log(f"  {len(cols)} columns of {len(resident)} tables resident on "
            f"{sorted({str(t.device) for t in cols})}, "
            f"{sum(t.numel() * t.element_size() for t in cols) / 2**30:.2f}"
            " GiB")
        # partsupp reloaded and not analyzed: its statistics are gone, so
        # Q9 can no longer prove its build side unique
        rel = db.catalog.default_database.get_relation("partsupp")
        rel.set_data(rel.data)
        run("Q9, partsupp without statistics", 9, STALE_PARTSUPP_Q9)
        log(f"phase 4: window queries at SF{SF_LARGE:g} on the same tables")
        for name, must in WINDOW_RUNS.items():
            run(f"W-Q{name[1:]}", name, must, sql=WINDOW_QUERIES[name],
                rel_tol=WINDOW_REL_TOL)
        log(f"phase 5: operator queries at SF{SF_LARGE:g} on the same "
            "tables")
        for name, must in OPERATOR_RUNS.items():
            run(f"O-Q{name[1:]}", name, must, sql=OPERATOR_QUERIES[name],
                rel_tol=WINDOW_REL_TOL)
        launches = phase_dml(db, oracle, cuda)
        for k, v in launches.items():
            total[k] += v
        return total, single
    finally:
        db.executor._device_cache.clear()
        db.close()
        del db
        gc.collect()
        torch.cuda.empty_cache()


def stream_line(label, info, times, peak, start):
    """One streamed query's line: segments run of all, bytes uploaded and
    upload rate per run, seconds per segment, times, peak memory."""
    segs = info["per_segment"]
    up = sum(s["bytes"] for s in segs)
    up_s = sum(s["upload_s"] for s in segs if s["bytes"])
    rate = f"{up / up_s / 1e9:.2f} GB/s" if up_s > 0 else "no upload"
    cached = sum(1 for s in segs if not s["bytes"])
    return (f"  {label}: segments {info['segments_run']}/{info['segments']} "
            f"of {info['seg_rows']} rows; last run uploaded {up / 2**20:.1f}"
            f" MiB ({rate}; {cached} segments from the segment cache); "
            f"{statistics.mean(s['seconds'] for s in segs) * 1000:.1f} ms a "
            f"segment; cold {times[0]:.1f} ms, warm "
            + ", ".join(f"{t:.1f}" for t in times[1:]) +
            f" ms; peak device memory {peak / 2**30:.3f} GiB "
            f"({start / 2**30:.3f} held at its start) under a budget of "
            f"{STREAM_BUDGET / 2**30:.3f} GiB")


def phase_streamed(cuda, generated):
    """The generated tables in a database with a device memory budget of
    STREAM_BUDGET bytes (lineitem's columns at SF_LARGE are many times
    it): STREAMED_QUERIES cold and STREAM_WARM_RUNS warm against the exact
    oracles, each streaming lineitem in more than one segment and launching
    the kernels LARGE_QUERIES names for it, with the peak device memory of
    each beside the budget (Q1's and Q6's, above what they found held,
    below the bytes of lineitem's columns they read); RESIDENT_UNDER_BUDGET
    resident under the budget;
    every query leaving at most the budget plus one segment allocated,
    with tables evicted on the way; Q17 and Q21 refused under
    strict_hbm_budget, and right resident without it; a scan whose
    segments SMA skips on lineitem's ordered l_orderkey against numpy; and
    a network server on the same database, two of whose clients get Q6's
    answer. Returns the kernels' launches."""
    from quickstep_tpu_torch import Database
    from quickstep_tpu_torch.bench.tpch import TPCH_QUERIES, with_tiebreak
    from quickstep_tpu_torch.bench.tpch_fullgen import (
        check_rows, load_tables)
    from quickstep_tpu_torch.cli.network import QueryClient, QueryServer
    from quickstep_tpu_torch.config import Config
    from quickstep_tpu_torch.errors import ExecutionError
    from quickstep_tpu_torch.exec import streaming as S
    from quickstep_tpu_torch.parser import parse_one
    log(f"phase 3s: TPC-H SF{SF_LARGE:g} under a device memory budget of "
        f"{STREAM_BUDGET} bytes, lineitem streamed")
    tables, stats, oracle, _made = generated
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    db = Database(config=Config(hbm_budget_bytes=STREAM_BUDGET),
                  device="cuda")
    ex = db.executor
    total = dict.fromkeys(cuda.LAUNCHES, 0)
    try:
        load_tables(db, tables, stats)
        lineitem = db.catalog.default_database.get_relation("lineitem")
        evicted = []
        policy = ex._policy()
        real_evicted = policy.block_evicted

        def count_evictions(key):
            evicted.append(key)
            real_evicted(key)
        policy.block_evicted = count_evictions
        largest_segment = [0]

        def after(label):
            """memory_allocated after a query: within the budget plus one
            segment."""
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated() - base
            if held > STREAM_BUDGET + largest_segment[0]:
                raise AssertionError(
                    f"{label}: {held} bytes allocated after it, more than "
                    f"the budget {STREAM_BUDGET} plus a segment "
                    f"{largest_segment[0]}")
            return held

        for q in STREAMED_QUERIES:
            sql = with_tiebreak(q, TPCH_QUERIES[q])
            plan = ex.plan_select(parse_one(sql))
            needed = S._table_bytes(lineitem,
                                    S._needed_columns(plan)["lineitem"])
            torch.cuda.synchronize()
            start = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            cuda.reset_launches()
            times = []
            for run in range(1 + STREAM_WARM_RUNS):
                t0 = time.perf_counter()
                rows = db.execute(sql).rows
                times.append((time.perf_counter() - t0) * 1000)
                check_rows(q, rows, oracle)
                info = ex.last_stream_info
                if info is None or info["segments_run"] < 2:
                    raise AssertionError(f"Q{q} under the budget did not "
                                         f"stream: {info}")
                largest_segment[0] = max(
                    [largest_segment[0]] + [s["bytes"] for s in
                                            info["per_segment"]])
            peak = torch.cuda.max_memory_allocated()
            launches = dict(cuda.LAUNCHES)
            missing = [k for k in LARGE_QUERIES[q] if not launches[k]]
            if missing:
                raise AssertionError(f"streamed Q{q} never launched "
                                     f"{missing}: {launches}")
            for k, v in launches.items():
                total[k] += v
            log(stream_line(f"Q{q}", info, times, peak, start))
            if q in (1, 6):
                # what the query itself allocated at its peak, above what it
                # found held (the segment cache and resident tables of the
                # queries before it, within the budget)
                if peak - start >= needed:
                    raise AssertionError(
                        f"streamed Q{q}'s peak {peak - start} bytes above "
                        f"its start is not below the {needed} bytes of the "
                        "lineitem columns it reads")
                log(f"    {(peak - start) / 2**30:.3f} GiB above its start, "
                    f"below the {needed / 2**30:.3f} GiB of lineitem's "
                    "columns it reads")
            held = after(f"Q{q}")
            log(f"    then {held / 2**30:.3f} GiB allocated: resident "
                f"{ex._resident_bytes() / 2**30:.3f} GiB "
                f"({len(ex._device_cache)} tables), segment cache "
                f"{ex._seg_cache_bytes / 2**30:.3f} GiB; launches "
                + ", ".join(f"{k} {v}" for k, v in launches.items() if v))
        for q in RESIDENT_UNDER_BUDGET:
            torch.cuda.reset_peak_memory_stats()
            cuda.reset_launches()
            t0 = time.perf_counter()
            rows = db.execute(with_tiebreak(q, TPCH_QUERIES[q])).rows
            ms = (time.perf_counter() - t0) * 1000
            check_rows(q, rows, oracle)
            if ex.last_stream_info is not None:
                raise AssertionError(f"Q{q} streamed under the budget")
            for k, v in cuda.LAUNCHES.items():
                total[k] += v
            held = after(f"Q{q}")
            log(f"  Q{q} resident under the budget: {ms:.1f} ms, peak "
                f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, then "
                f"{held / 2**30:.3f} GiB allocated")
        log(f"  {len(evicted)} evictions so far, of "
            f"{len(set(evicted))} table versions; memory after every query "
            "within the budget plus one segment "
            f"({largest_segment[0] / 2**20:.1f} MiB)")
        if not evicted:
            raise AssertionError("the budget never evicted a table")

        db.config.strict_hbm_budget = True
        for q in UNSTREAMABLE:
            sql = with_tiebreak(q, TPCH_QUERIES[q])
            try:
                db.execute(sql)
            except ExecutionError as e:
                if "streamable" not in str(e):
                    raise
                log(f"  Q{q} under strict_hbm_budget: ExecutionError "
                    f"({str(e)[:60]}...)")
            else:
                raise AssertionError(f"Q{q} ran under strict_hbm_budget")
        db.config.strict_hbm_budget = False
        for q in UNSTREAMABLE:
            torch.cuda.reset_peak_memory_stats()
            cuda.reset_launches()
            t0 = time.perf_counter()
            rows = db.execute(with_tiebreak(q, TPCH_QUERIES[q])).rows
            ms = (time.perf_counter() - t0) * 1000
            check_rows(q, rows, oracle)
            if ex.last_stream_info is not None:
                raise AssertionError(f"Q{q} streamed")
            launches = dict(cuda.LAUNCHES)
            missing = [k for k in LARGE_QUERIES[q] if not launches[k]]
            if missing:
                raise AssertionError(f"Q{q} never launched {missing}")
            for k, v in launches.items():
                total[k] += v
            log(f"  Q{q} without strict_hbm_budget: resident, {ms:.1f} ms, "
                f"{len(rows)} rows match the exact oracle; peak "
                f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

        # segment skipping on l_orderkey, whose segments' ranges are ordered
        sql = ("SELECT COUNT(*), MIN(l_orderkey), MAX(l_orderkey), "
               "MAX(l_partkey), MIN(l_suppkey) FROM lineitem "
               "WHERE l_orderkey < {}")
        sp = S.plan_streaming(ex.plan_select(parse_one(sql.format(0))),
                              db.catalog.default_database, db.config)
        ranges = S.segment_minmax(lineitem, "l_orderkey", sp.seg_rows,
                                  sp.n_segments)
        if any(hi > lo for (_a, hi), (lo, _b) in zip(ranges, ranges[1:])):
            raise AssertionError(f"l_orderkey's segments overlap: {ranges}")
        # segments 0 and 1 hold keys below it, the rest none
        bound = int(ranges[1][0]) + 1
        cols = {c: np.asarray(lineitem.data.columns[c].data)
                for c in ("l_orderkey", "l_partkey", "l_suppkey")}
        keep = cols["l_orderkey"] < bound
        want = [(int(keep.sum()), int(cols["l_orderkey"][keep].min()),
                 int(cols["l_orderkey"][keep].max()),
                 int(cols["l_partkey"][keep].max()),
                 int(cols["l_suppkey"][keep].min()))]
        cuda.reset_launches()
        rows = db.execute(sql.format(bound)).rows
        for k, v in cuda.LAUNCHES.items():
            total[k] += v
        info = ex.last_stream_info
        if rows != want or info is None or \
                not 1 < info["segments_run"] < info["segments"]:
            raise AssertionError(f"SMA skip: {rows} != {want}, {info}")
        log(f"  l_orderkey < {bound}: segments {info['segments_run']}/"
            f"{info['segments']} run (SMA skipped the rest, ranges ordered), "
            f"{rows[0][0]} rows match numpy")
        after("the SMA scan")

        server = QueryServer(db, port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        answers = [None, None]
        try:
            def client(i):
                c = QueryClient("127.0.0.1", server.port)
                try:
                    answers[i] = c.query(with_tiebreak(6, TPCH_QUERIES[6]))
                finally:
                    c.close()
            clients = [threading.Thread(target=client, args=(i,))
                       for i in range(2)]
            for c in clients:
                c.start()
            for c in clients:
                c.join(120)
        finally:
            server.shutdown()
            thread.join(10)
        for a in answers:
            if a is None or a["stderr"]:
                raise AssertionError(f"network client: {a}")
            check_rows(6, [tuple(r) for r in a["rows"]], oracle)
        log(f"  network server on 127.0.0.1:{server.port} (device cuda): two "
            f"clients got Q6's answer {answers[0]['rows'][0]} in "
            + ", ".join(f"{a['time_ms']:.1f}" for a in answers) + " ms, "
            f"streamed ({ex.last_stream_info['segments_run']} segments)")
        return total
    finally:
        ex._device_cache.clear()
        ex._seg_cache.clear()
        db.close()
        del db
        gc.collect()
        torch.cuda.empty_cache()


def phase_large_mesh(cuda, generated, single, total):
    """The generated SF_LARGE tables in a second database, on a mesh of
    MESH_SHARDS shards of the card at the default replicate threshold
    (every table but nation and region shards): MESH_QUERIES cold and warm
    against the exact oracle, each launching K14-K16, Q9 through the
    two-phase GROUP BY, then MESH_AGG_QUERIES, each launching its aggregate
    kernel once a shard a run; times and peak memory beside the one-device
    run's. Adds the launches to total. Returns, for each query, (its rows
    of each run, its times in ms, its peak device memory in GiB)."""
    from quickstep_tpu_torch import Database
    from quickstep_tpu_torch.bench.tpch_fullgen import load_tables
    from quickstep_tpu_torch.config import Config
    from quickstep_tpu_torch.exec.runner import PlanRunner
    tables, stats, oracle, _made = generated
    log(f"phase 6: TPC-H SF{SF_LARGE:g} on an {MESH_SHARDS}-shard mesh of "
        "the card")
    cfg = Config()
    cfg.distributed = True
    db = Database(config=cfg, device="cuda", mesh_shards=MESH_SHARDS)
    two_phase = [0]
    real = PlanRunner._dist_sort_groupby

    def counted(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        two_phase[0] += out is not None
        return out
    PlanRunner._dist_sort_groupby = counted
    out = {}
    try:
        load_tables(db, tables, stats)
        for q in MESH_QUERIES + MESH_AGG_QUERIES:
            two_phase[0] = 0
            rows = []
            must = SHUFFLE_KERNELS if q in MESH_QUERIES else LARGE_QUERIES[q]
            per_run = None if q in MESH_QUERIES else \
                dict.fromkeys(LARGE_QUERIES[q], MESH_SHARDS)
            times, peak = run_query(db, cuda, oracle, total,
                                    f"Q{q} ({MESH_SHARDS} shards)", q,
                                    must, per_run=per_run, rows_out=rows)
            out[q] = (rows, times, peak)
            info = PlanRunner.trace_shuffle_info if q in MESH_QUERIES \
                else "none"
            one = single[q]
            log(f"    one device: cold {one[0][0]:.1f} ms, warm "
                + ", ".join(f"{t:.1f}" for t in one[0][1:])
                + f" ms, peak {one[1]:.2f} GiB; last shuffle {info}; "
                f"two-phase GROUP BYs {two_phase[0]}")
            if q == 9 and not two_phase[0]:
                raise AssertionError("Q9 on the mesh took the one-phase "
                                     "GROUP BY")
        return out
    finally:
        PlanRunner._dist_sort_groupby = real
        db.executor._device_cache.clear()
        db.close()
        del db
        gc.collect()
        torch.cuda.empty_cache()


def spawn_workers(args, out, timeout):
    """MULTIHOST_PROCS bench/multihost_run.py processes (fresh interpreters,
    never a fork of this one) meeting at a free local port, each writing
    out.<its id> and its output to out.<its id>.log (a file, so that no
    worker stalls on a full pipe while this process waits for another);
    returns (their exit codes, their outputs). A worker still running at
    the timeout is killed, with every other, and the timeout raised."""
    import pathlib
    import socket
    root = pathlib.Path(__file__).resolve().parent
    worker = root / "quickstep_tpu_torch" / "bench" / "multihost_run.py"
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    # the processes share the card: segments that grow keep its memory
    # from fragmenting into each one's cache
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    procs, logs = [], [f"{out}.{i}.log" for i in range(MULTIHOST_PROCS)]
    for i, log in enumerate(logs):
        with open(log, "wb") as f:
            procs.append(subprocess.Popen(
                [sys.executable, str(worker), str(i), str(MULTIHOST_PROCS),
                 str(port), out] + args, cwd=str(root), env=env, stdout=f,
                stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for log in logs:
        with open(log, errors="replace") as f:
            outs.append(f.read())
    return [p.returncode for p in procs], outs


def phase_multihost(cuda, generated, mesh):
    """The SF_LARGE tables on the MESH_SHARDS-shard mesh spread over
    MULTIHOST_PROCS processes on the card (parallel/multihost.py), each
    holding MESH_SHARDS / MULTIHOST_PROCS local shards and uploading only
    their rows of a sharded table; the tables are written once as .npy
    files, which each process memory-maps. First two ranks asking for NCCL
    on the one card must both refuse. Then MESH_QUERIES and
    MESH_AGG_QUERIES cold and warm on every process: each run against the
    exact oracle and bit for bit against phase 6's rows (`mesh`,
    phase_large_mesh's result), each process launching K1, K2, K14, K15
    and K16 and uploading half of each sharded table, and gathering no
    input of an operator that runs per shard (no Aggregate input but of
    the GATHERED_AGGREGATES kinds, none for NO_AGGREGATE_GATHER, and no
    probe side of a Join for NO_PROBE_GATHER); its times beside phase 6's,
    what crossed the processes, each query's gathered bytes and its peak
    memory are logged. Returns the workers' launches, summed."""
    import pathlib
    import pickle
    import shutil
    from quickstep_tpu_torch.bench.multihost_run import write_tables
    from quickstep_tpu_torch.bench.tpch_fullgen import check_rows
    from quickstep_tpu_torch.config import Config
    tables, stats, oracle, _made = generated
    local = MESH_SHARDS // MULTIHOST_PROCS
    # the workers' threshold, the default: tables at or above it shard
    threshold = Config().replicate_threshold_rows
    log(f"phase 7: TPC-H SF{SF_LARGE:g} on an {MESH_SHARDS}-shard mesh over "
        f"{MULTIHOST_PROCS} processes on the card ({local} shards each, "
        f"{MULTIHOST_BACKEND})")
    gc.collect()
    torch.cuda.empty_cache()
    free, total_bytes = torch.cuda.mem_get_info()
    log(f"  this process holds {torch.cuda.memory_reserved() / 2**30:.2f} "
        f"GiB of the card's memory; {free / 2**30:.2f} of "
        f"{total_bytes / 2**30:.2f} GiB free")
    work = pathlib.Path(__file__).resolve().parent / "build" / "multihost"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        t0 = time.perf_counter()
        rcs, outs = spawn_workers(["--backend", "nccl", "--device", "cuda:0",
                                   "--star"], str(work / "nccl"),
                                  NCCL_REFUSAL_TIMEOUT_S)
        refused = [rc != 0 and "NCCL needs a card per rank" in out
                   for rc, out in zip(rcs, outs)]
        if not all(refused):
            raise AssertionError("two NCCL ranks on one card did not both "
                                 f"refuse: exit codes {rcs}\n" +
                                 "\n".join(o[-2000:] for o in outs))
        log(f"  two ranks asking for NCCL on cuda:0 both refuse (exit codes "
            f"{rcs}, {time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        write_tables(str(work / "tables"), tables, stats)
        log(f"  tables written as .npy in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        rcs, outs = spawn_workers(
            ["--device", "cuda:0", "--backend", MULTIHOST_BACKEND,
             "--local-shards", str(local), "--tables", str(work / "tables"),
             "--queries", ",".join(str(q) for q in MESH_QUERIES +
                                   MESH_AGG_QUERIES),
             "--runs", str(MULTIHOST_RUNS)],
            str(work / "out"), MULTIHOST_TIMEOUT_S)
        if any(rcs):
            raise AssertionError(f"a worker failed: exit codes {rcs}\n" +
                                 "\n".join(o[-3000:] for o in outs))
        results = []
        for i in range(MULTIHOST_PROCS):
            with open(work / f"out.{i}", "rb") as f:
                results.append(pickle.load(f))
        log(f"  {MULTIHOST_PROCS} workers ran in "
            f"{time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    total = dict.fromkeys(cuda.LAUNCHES, 0)
    for res in results:
        fig = res["figures"]
        who = f"process {fig['process']}"
        for q in MESH_QUERIES + MESH_AGG_QUERIES:
            runs = res["rows"][f"Q{q}"]
            want = mesh[q][0][0]
            for rows in runs:
                check_rows(q, rows, oracle)
                if rows != want:
                    raise AssertionError(f"{who} Q{q}: its rows differ from "
                                         "phase 6's")
            qf = fig["queries"][f"Q{q}"]
            one = mesh[q][1]
            moved = qf["mesh"][0]["collectives"]
            gathers = qf["mesh"][0]["gathers"]
            split = [g for g in gathers if (
                g["into"] == "Aggregate" and (
                    q in NO_AGGREGATE_GATHER or
                    g["why"] not in GATHERED_AGGREGATES)) or (
                q in NO_PROBE_GATHER and g["why"].startswith("probe side"))]
            if split:
                raise AssertionError(f"{who} Q{q} gathered the input of an "
                                     f"operator that runs per shard: {split}")
            log(f"  {who} Q{q}: peak device memory "
                f"{qf['peak_bytes'] / 2**30:.2f} GiB (phase 6: "
                f"{mesh[q][2]:.2f}); cold {qf['ms'][0]:.1f} ms, warm "
                + ", ".join(f"{t:.1f}" for t in qf["ms"][1:])
                + f" (phase 6: cold {one[0]:.1f}, warm "
                + ", ".join(f"{t:.1f}" for t in one[1:])
                + f"); {len(runs[0])} rows match the oracle and phase 6 bit "
                f"for bit; retries {qf['retries']}; sent (cold run) "
                + ", ".join(f"{k} {v['calls']} calls {v['bytes']} B"
                            for k, v in sorted(moved.items()))
                + f"; gathered {sum(g['bytes'] for g in gathers)} B: "
                + (", ".join(f"{g['from']}->{g['into']} ({g['why']}) "
                             f"{g['rows']} rows {g['bytes']} B"
                             for g in gathers) or "none"))
        idle = [k for k in SHUFFLE_KERNELS + ("scalar_agg", "dense_groupby")
                if not fig["launches"][k]]
        if idle:
            raise AssertionError(f"{who} never launched {idle}")
        for table, up in sorted(fig["uploads"].items()):
            share = up["bytes"] / up["table_bytes"]
            want_share = 1 / MULTIHOST_PROCS if up["sharded"] else 1.0
            if up["sharded"] != (tables[table].n >= threshold) or \
                    share != want_share:
                raise AssertionError(f"{who} uploaded {up} of {table}")
        log(f"  {who}: uploaded " + ", ".join(
            f"{t} {u['bytes'] / 2**20:.1f} of {u['table_bytes'] / 2**20:.1f}"
            " MiB" for t, u in sorted(fig["uploads"].items()))
            + f"; peak device memory {fig['peak_bytes'] / 2**30:.2f} GiB; "
            "launches " + ", ".join(f"{k} {v}" for k, v in
                                    fig["launches"].items() if v))
        for k, v in fig["launches"].items():
            total[k] += v
    return total


def phase_dist_step(cuda):
    """distributed_agg_join_step over MESH_SHARDS shards of N_SHARD_ROWS
    rows each (keys in the step's 4,096-key domain, half of them in the
    build side) against a plain computation: exact counts, float64 sums
    within rel 1e-9 (each shard's K2 sums and their psum add in another
    order than one index_add_)."""
    from quickstep_tpu_torch.parallel.dist import (
        DOMAIN, N_GROUPS, distributed_agg_join_step)
    from quickstep_tpu_torch.parallel.mesh import make_mesh
    dev = torch.device("cuda")
    mesh = make_mesh(MESH_SHARDS, dev)
    n = MESH_SHARDS * N_SHARD_ROWS
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    l_key = torch.randint(0, DOMAIN, (n,), device=dev, generator=gen)
    l_val = torch.rand(n, device=dev, generator=gen, dtype=torch.float64) * 100
    l_grp = torch.randint(0, N_GROUPS, (n,), device=dev, generator=gen)
    l_alive = torch.rand(n, device=dev, generator=gen) < 0.95
    b_key = torch.arange(0, DOMAIN, 2, device=dev)
    b_alive = torch.ones(b_key.shape[0], dtype=torch.bool, device=dev)
    step = distributed_agg_join_step(mesh)
    args = (l_key, l_val, l_grp, l_alive, b_key, b_alive)

    def plain():
        present = torch.zeros(DOMAIN, dtype=torch.bool, device=dev)
        present[b_key[b_alive]] = True
        m = l_alive & present[l_key]
        sums = torch.zeros(N_GROUPS, dtype=torch.float64,
                           device=dev).index_add_(0, l_grp[m], l_val[m])
        return sums, torch.bincount(l_grp[m], minlength=N_GROUPS)
    cuda.reset_launches()
    sums, counts = step(*args)
    torch.cuda.synchronize()
    launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
    want_sums, want_counts = plain()
    if not torch.equal(counts, want_counts) or not torch.all(
            (sums - want_sums).abs() <= 1e-9 * want_sums.abs()):
        raise AssertionError(f"distributed_agg_join_step: {sums} {counts} "
                             f"!= {want_sums} {want_counts}")
    if set(launches) != {"direct_join", "dense_groupby"}:
        raise AssertionError(f"distributed_agg_join_step launched {launches}")
    ms, plain_ms = cuda_ms(lambda: step(*args)), cuda_ms(plain)
    bound = sum(t.numel() * t.element_size() for t in args[:4]) \
        / HBM_BYTES_PER_S * 1e3
    err = float((sums - want_sums).abs().max())
    log(f"phase 8: distributed_agg_join_step, {MESH_SHARDS} shards x "
        f"{N_SHARD_ROWS} rows: matches the plain computation (max abs err "
        f"{err:.3e}); {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bound:.3f} ms; launches {launches}")
    return launches


def phase_dml(db, oracle, cuda):
    """O-DML once on the resident tables: CREATE TABLE, INSERT ... SELECT of
    lineitem's 'R' lines, DELETE, UPDATE, then the totals against the
    oracle. Each statement leaves no device copy of the table (the copy of
    the version it changed is dropped, not kept beside the new one); a
    query that reads the table then leaves exactly one, of its newest
    version, and counts the host's rows. The peak device memory of the
    whole sequence
    exceeds what was allocated before it, with every lineitem column
    resident (the SELECT * reads them all), by no more than the new
    table's bytes."""
    from quickstep_tpu_torch.bench.tpch_fullgen import (
        OPERATOR_DML, OPERATOR_DML_QUERY, check_rows, operator_dml_ddl)
    db.executor._device_table(
        db.catalog.default_database.get_relation("lineitem"), None)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launches()
    db.execute(operator_dml_ddl())
    rel = db.catalog.default_database.get_relation("li_r")
    table_bytes = 0
    for stmt, want in zip(OPERATOR_DML, oracle["odml_rows"]):
        t0 = time.perf_counter()
        n = db.execute(stmt).rows_affected
        ms = (time.perf_counter() - t0) * 1000
        if n != want:
            raise AssertionError(f"O-DML {stmt!r}: {n} rows, oracle {want}")
        copies = [k for k in db.executor._device_cache if k[0] == "li_r"]
        if copies:
            raise AssertionError(f"O-DML {stmt!r} kept device copies "
                                 f"{copies}")
        counted = db.execute("select count(*), sum(l_quantity) "
                             "from li_r").rows[0][0]
        copies = [k for k in db.executor._device_cache if k[0] == "li_r"]
        if copies != [("li_r", rel.version)] or \
                counted != rel.data.num_rows:
            raise AssertionError(f"O-DML {stmt!r}: device copies {copies}, "
                                 f"{counted} rows counted of "
                                 f"{rel.data.num_rows}")
        table_bytes = max(table_bytes, sum(
            c.data.nbytes + (0 if c.valid is None else c.valid.nbytes)
            for c in rel.data.columns.values()))
        log(f"  O-DML {stmt.split()[0]}: {n} rows in {ms:.1f} ms; then "
            f"{counted} rows read from device copies {copies}")
    t0 = time.perf_counter()
    rows = db.execute(OPERATOR_DML_QUERY).rows
    ms = (time.perf_counter() - t0) * 1000
    check_rows("odml", rows, oracle)
    copies = [k for k in db.executor._device_cache if k[0] == "li_r"]
    if copies != [("li_r", rel.version)]:
        raise AssertionError(f"O-DML: device copies {copies}")
    peak = torch.cuda.max_memory_allocated() - base
    log(f"  O-DML totals {rows[0]} match the oracle in {ms:.1f} ms, host "
        f"syncs {db.executor.host_syncs}; peak device memory {peak / 2**30:.3f}"
        f" GiB above the {base / 2**30:.2f} GiB before, table "
        f"{table_bytes / 2**30:.3f} GiB")
    if peak > table_bytes:
        raise AssertionError(f"O-DML peak device memory grew by {peak} "
                             f"bytes, more than the table's {table_bytes}")
    return dict(cuda.LAUNCHES)


class StoreWriter:
    """bench/sf100_fullgen.py writing the SF_LARGE store under build/ in its
    own process (its log and the temporary directory it writes the oracle's
    second copy to beside the store), started at once through
    bench/sf100_campaign.py's run_child on a thread of its own; finish()
    waits for it and returns (its exit code, seconds, peak RSS in bytes),
    stop() kills it if it still runs and removes the store."""

    def __init__(self):
        import pathlib
        from quickstep_tpu_torch.bench.sf100_campaign import run_child
        root = pathlib.Path(__file__).resolve().parent
        self.store = root / "build" / "sf10_store"
        self.tmp = root / "build" / "sf10_store_tmp"
        self.remove()
        self.tmp.mkdir(parents=True)
        self.log_path = root / "build" / "sf10_store.log"
        env = dict(os.environ, TMPDIR=str(self.tmp), PYTHONPATH=str(root))
        self.stopping = threading.Event()
        self.done = None          # (exit code, seconds, peak RSS bytes)
        self.t0 = time.perf_counter()

        def write():
            self.done = run_child(
                [sys.executable, "-m",
                 "quickstep_tpu_torch.bench.sf100_fullgen", f"{SF_LARGE:g}",
                 str(STORE_CHUNK_ORDERS), str(self.store)], self.log_path,
                timeout=STORE_WRITER_TIMEOUT, stop=self.stopping,
                cwd=str(root), env=env)
        self.thread = threading.Thread(target=write, daemon=True)
        self.thread.start()

    def finish(self):
        self.thread.join()
        return self.done

    def remove(self):
        import shutil
        for d in (self.store, self.tmp):
            shutil.rmtree(d, ignore_errors=True)

    def stop(self):
        self.stopping.set()
        self.thread.join()
        self.remove()


def phase_store(cuda, writer, written):
    """Phase 9: the SF_LARGE store that `writer` wrote, `written` being its
    (exit code, seconds, peak RSS in bytes), opened memory-mapped in a
    database on the card under STREAM_BUDGET: the eleven queries of its
    oracle.json cold and warm through bench/sf100_full_verify.py's check,
    each ok in both runs, each that streams (STREAMED_QUERIES) in at least
    two segments and launching the kernels LARGE_QUERIES names for it, the
    others resident; the store is removed after. Returns the kernels'
    launches."""
    from quickstep_tpu_torch.bench import sf100_full_verify as V
    _rc, secs, rss = written
    store = writer.store
    size = sum(os.path.getsize(os.path.join(d, n))
               for d, _sub, names in os.walk(store) for n in names)
    log(f"phase 9: the SF{SF_LARGE:g} store of bench/sf100_fullgen.py "
        f"({STORE_CHUNK_ORDERS} orders a chunk), {size} bytes written in "
        f"{secs:.1f} s by its own process (peak RSS {rss / 2**30:.2f} "
        f"GiB) during phase 0; its eleven oracle queries "
        f"under a budget of {STREAM_BUDGET} bytes, memory-mapped")
    with open(store / "oracle.json") as f:
        oracle = json.load(f)
    queries = [int(q) for q in V.DEFAULT_QS.split(",")]
    if sorted(k for k in oracle if k != "rows") != \
            sorted(f"q{q}" for q in queries):
        raise AssertionError(f"oracle.json holds {sorted(oracle)}")
    total = dict.fromkeys(cuda.LAUNCHES, 0)
    gc.collect()
    torch.cuda.empty_cache()
    db = V.open_store(str(store), STREAM_BUDGET, "cuda")
    try:
        lineitem = db.catalog.default_database.get_relation("lineitem")
        if not isinstance(lineitem.data.columns["l_orderkey"].data,
                          np.memmap):
            raise AssertionError("lineitem's columns are not memory-mapped")
        for q in queries:
            cuda.reset_launches()
            rec = V.check_query(db, q, oracle[f"q{q}"])
            launches = dict(cuda.LAUNCHES)
            for k, v in launches.items():
                total[k] += v
            cold, warm = rec["runs"]["cold"], rec["runs"]["warm"]
            if not (rec["ok"] and rec["ok_cold"] and rec["ok_warm"]):
                raise AssertionError(f"store Q{q}: not ok against the "
                                     f"oracle: {rec}")
            for run in (cold, warm):
                streamed = run["segments"] > 0
                if streamed != (q in STREAMED_QUERIES) or (
                        streamed and run["segments_run"] < 2):
                    raise AssertionError(f"store Q{q}: {run}")
            missing = [k for k in LARGE_QUERIES[q] if not launches[k]]
            if missing:
                raise AssertionError(f"store Q{q} never launched {missing}: "
                                     f"{launches}")
            log(f"  store Q{q}: {rec['rows']} rows ok cold and warm; " + "; ".join(
                f"{name} {run['ms']:.1f} ms, segments "
                f"{run['segments_run']}/{run['segments']}, uploaded "
                f"{run['bytes_streamed']} B" + (
                    f" at {run['bytes_streamed'] / run['upload_s'] / 1e9:.2f}"
                    " GB/s" if run["upload_s"] > 0 else "") +
                f", peak device memory "
                f"{run['peak_device_bytes'] / 2**30:.3f} GiB"
                for name, run in (("cold", cold), ("warm", warm))) +
                f"; host RSS {warm['host_rss_bytes'] / 2**30:.2f} GiB")
        return total
    finally:
        db.executor._device_cache.clear()
        db.executor._seg_cache.clear()
        db.close()
        del db
        gc.collect()
        torch.cuda.empty_cache()
        writer.remove()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    t_start = time.perf_counter()
    card = gpu_name_and_power()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    from quickstep_tpu_torch.ops import cuda, groupby as G
    writer = StoreWriter()
    try:
        run_phases(card, cuda, G, t_start, writer)
    finally:
        writer.stop()


def run_phases(card, cuda, G, t_start, writer):
    t0 = time.perf_counter()
    generated = build_while(generate_large)
    log(f"phase 0: kernels built (nvcc {cuda.BUILD_SECONDS:.1f} s)"
        if cuda.BUILD_SECONDS is not None
        else "phase 0: kernels loaded from an earlier build")
    log(f"  and the SF{SF_LARGE:g} tables and oracles made meanwhile, "
        f"{time.perf_counter() - t0:.1f} s in all")
    # the store writer ends before the timed phases begin
    running = writer.done is None
    written = writer.finish()
    log(f"  the store writer ended at "
        f"{writer.t0 + written[1] - t_start:.1f} s of the smoke with exit "
        f"code {written[0]}" + (
            ", phase 1 having waited for it" if running else ""))
    if written[0] != 0:
        with open(writer.log_path, errors="replace") as f:
            raise AssertionError(f"the store writer exited with "
                                 f"{written[0]}: {f.read()[-2000:]}")

    rows = phase_kernels(G)
    torch.cuda.empty_cache()
    # launches over every phase that drives the engine (not phase 1's
    # comparisons): each phase counts from 0 and hands its counts on
    launches = dict.fromkeys(cuda.LAUNCHES, 0)

    def add(counts):
        for k, v in counts.items():
            launches[k] += v
    # the one-device phases alone as well: the main path
    one_device = dict.fromkeys(cuda.LAUNCHES, 0)
    small = phase_small(cuda)
    add(small)
    with bloom_census() as small_census:
        add(phase_small(cuda, mesh_shards=MESH_SHARDS))
    small_census.report(f"SF{SF_SMALL} mesh")
    golden = phase_golden(cuda)
    add(golden)
    large, single = phase_large(cuda, generated)
    add(large)
    streamed = phase_streamed(cuda, generated)
    add(streamed)
    for counts in (small, golden, large, streamed):
        for k, v in counts.items():
            one_device[k] += v
    with bloom_census() as large_census:
        mesh = phase_large_mesh(cuda, generated, single, launches)
    large_census.report(f"SF{SF_LARGE:g} mesh")
    large_census.calls += small_census.calls
    large_census.report("both meshes")
    add(phase_multihost(cuda, generated, mesh))
    del generated
    add(phase_dist_step(cuda))
    stored = phase_store(cuda, writer, written)
    add(stored)
    for k, v in stored.items():
        one_device[k] += v
    log("launches over the run: " + ", ".join(
        f"{k} {v}" for k, v in launches.items()))
    log("launches on one device: " + ", ".join(
        f"{k} {v}" for k, v in one_device.items()))
    idle = [k for k in KERNELS if not launches[k]]
    if idle:
        raise AssertionError(f"the engine never launched {idle}")

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
            "launches_one_device": one_device[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"], "bound_by": "bytes",
            "library_ms": main_case["library_ms"]})
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
