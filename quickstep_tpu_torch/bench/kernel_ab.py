"""K2-K16, W1-W4 at chip_smoke.py's SF10 shapes, timed in the
checkout it runs from, so that two checkouts can be compared on one card in
one call: run this file from each checkout's root in turn, parent, change,
change, parent, parent, change. It uses only the public functions both
sides have: ops/join.py direct_build and direct_probe, sorted_build,
merge_unique_probe, expand_probe and merge_cmp_probe, ops/cuda.py
sorted_probe and segment_reduce, ops/bloom.py exact_filter_build,
ops/kernels.py multi_gather (with random=True where the checkout takes
it), ops/groupby.py distinct_count, ops/sort.py order_permutation and
ops/window.py frame_bounds and sliding_sums, parallel/shuffle.py
partition_dest and radix_bucket. Its
input makers, segment_inputs and unique_probe_inputs, also feed
chip_smoke.py and the card tests.

    python -m quickstep_tpu_torch.bench.kernel_ab

Cases, each timed by CUDA events (median of 10 runs after one warm-up):
- k3_random: 60 M int32 probe keys, uniform over a 60 M-slot domain, 80 %
  live, into an orders-like table (15 M keys, every 4th slot, half live);
- k3_ascending: the same table probed by ascending lineitem-like orderkeys
  (1-7 lines an order, about 60 M rows, 80 % live);
- k3_build_probe: k3_random's build and probe together;
- k3_filter_random, k3_filter_ascending: the exact filter's build (K3's
  presence mode) over k3_random's and k3_ascending's probe keys;
- k6_ascending: six lineitem-like columns (1-, 4-, 4-, 8-, 4- and 8-byte)
  of 60 M rows gathered by the ascending positions of a random half-live
  mask (a compaction index, about 30 M rows);
- k6_random: the same columns by a uniformly random 60 M-row int64 index;
- k7: 60 M probes (80 % live) into a partsupp-like build of 8 M rows (4 a
  part key over 2 M keys, 95 % live), K = 4, sorted_build outside the time;
- k7_packed: the same on range-packed (partkey, suppkey) keys, each probe
  naming one partsupp row (the stale Q9's shape);
- k7_k16: k7 at K = 16 (the executor's width after one overflow retry);
- k12: COUNT(DISTINCT) of 60 M int32 values in [1, 2 M], all live;
- k4_q5: merge_unique_probe of 60 M probes (80 % live) into Q5's 100 K
  range-packed (suppkey, nationkey) keys (90 % live), the build sort
  included;
- k4_q9: cuda.sorted_probe alone of 60 M live probes, each naming one row,
  into 8 M range-packed (partkey, suppkey) keys (Q9's partsupp), sorted
  outside the time;
- k5_groups_15m: cuda.segment_reduce, SUM of int64 over 60 M rows in about
  15 M groups (80 % live);
- k5_q9: the same, SUM of float64 over Q9's shape: 175 groups, 5.4 % of
  60 M rows live;
- k8: merge_cmp_probe `<>` of 38 M probes (90 % live) into a Q21-like
  build of about 60 M lineitem orderkeys (1-7 lines an order over 15 M
  orders, 63 % live) with int32 suppkey values, the build's sort included
  (k8_inputs); k8_split: the device ms of each kernel of one such call, by
  torch.profiler; k8_skewed (where the checkout's K8 takes the build keys
  themselves, PR 10 on): the same with 10 M of the build rows moved onto
  one key and made live;
- k13: order_permutation of 60 M rows by a DOUBLE DESC of two decimals, a
  nullable INT of 1..50 and an int64 permutation tiebreak, 95 % live
  (k13_inputs, the smoke's case); k13_split its kernels as for k8;
- k11_oq2: ops/join.py oa_build then oa_probe at O-Q2's shape: lineitem's
  60 M (partkey, suppkey) int32 pairs, 95 % live, over partsupp's 8 M
  pairs, into next_pow2(2 x 60 M) slots, probed by partsupp's 8 M pairs
  (k11_inputs); k11_oq3 at O-Q3's: partsupp's 8 M unique pairs built,
  lineitem's 60 M probed, every one matching; k11_skewed: k11_oq2 with 10 M
  of the build rows on one key, live; k11_split: the device ms of each
  kernel (the table's fill, the build, the probe) of one call at O-Q2's
  and O-Q3's shapes;
- w1_whole: ops/window.py _seg_total, SUM of float64 over 60 M rows in
  100 K partitions, 90 % live (W-Q1's whole-partition sum); w1_running_max:
  segmented_prefix MAX of int64 over the same partitions, a peer start at
  a fifth of the rows; w1_count_15m: running COUNT over 15 M orders of 1-7
  lines, every row its own peer group (W-Q2); w1_one_segment: running SUM
  of float64 over one 15 M-row segment in ~2,400 peer groups (W-Q3)
  (w1_inputs); w1_split: the device ms of each kernel of w1_whole;
- k9: ops/kernels.py stable_partition of a 60 M-row mask, 50 % live, the
  whole permutation; k9_limit (where the checkout's K9 takes `limit`):
  the same with limit = the live count; k9_4096: one tile of 4,096 rows,
  half live; k9_split, k9_limit_split: the device ms of each kernel of k9
  and k9_limit;
- compact_60m: exec/runner.py PlanRunner._compact_chunk of a 60 M-row chunk
  with 3.5 M live rows (a selective filter over lineitem) to a target of
  2^22 rows, the order and the live mask's gather (k9_inputs); its split
  compact_60m_split (the events also time the host's work between the
  kernels, which a call this short exposes);
- k2_q1: Q1's dense GROUP BY as the runner hands it over: two int32 key
  columns (l_returnflag's 3 codes, l_linestatus's 2; offsets 0, strides
  2 and 1, domain 6), 60 M rows, 98 % live, SUM over its 5 distinct int64
  value columns and COUNT(*) (the planner folds Q1's AVGs into them),
  packing included: ops/groupby.py dense_aggregate where the checkout has
  it, else pack_dense_index then dense_groupby (k2_inputs);
  k2_split: its kernels as for k8 (the launches of one kernel summed, their
  number after the name); k2_single: dense_groupby of one int64 SUM over a
  packed index of domain 6, 60 M rows, half live (the smoke's single-SUM
  case), with its split k2_single_split; k2_d128: the same SUM over an
  index of domain 128; k2_q1_warp_path (where the checkout has it): k2_q1
  on K2's path of a table a warp, which larger domains take.
- w3w4 (PR 13): w4_wq4_f64 and w4_wq4_f32: ops/window.py sliding_sums
  of a ROWS 3 PRECEDING .. CURRENT ROW frame over 60 M rows in 2 M
  partitions (W-Q4's shape, float64 and float32, 90 % live); w4_one_segment:
  the same frame over one 15 M-row segment, float64 (two timed runs: the
  parent takes seconds), with w4_one_segment_steps, its subtract and add
  steps, and, where the checkout has cuda.add_chain (the dependent-add
  probe), w4_add_ns_f64 and w4_add_ns_f32, the latency of one add in a
  chain, and w4_chain_bound_ms, steps x that latency; w3_range_wq5:
  frame_bounds of RANGE +-30 over int32 date codes, 60 M rows in 100 K
  partitions (W-Q5's shape); w3_rows_wq4: frame_bounds of ROWS 3 PRECEDING
  over W-Q4's partitions; w4_split and w3_split: the device ms of each
  kernel of w4_wq4_f64 and of w3_range_wq5 (w3w4_inputs).
- w2 and k16: w2_wq5, w2_wq6 and w2_long: ops/window.py frame_minmax
  at W-Q5's shape (MAX int64 over RANGE +-30 frames, 60 M rows in 100 K
  partitions), W-Q6's (MIN float64 over ROWS 1/1 in 15 M orders of 1-7
  lines) and over ROWS 1,500 PRECEDING in one 15 M-row segment (MAX
  float64), each with its split (w2_inputs); k16_build: ops/bloom.py
  bloom_build of 15 M orders keys (every 4th, half live) into 2^22 slots;
  k16_probe: bloom_probe of 60 M lineitem-like keys (90 % live) into that
  table; k16_mesh_<rows>: the same at the mesh's probe sizes
  (K16_MESH_ROWS), each a slice at an odd offset, by events and by the
  profiler's device time (_device_ms); the same into 2^20 and 2^19 slots
  (_2e20, _2e19: tables that L1 mostly holds), with splits.
- k14 and k15 (PR 15): k14_<shape>: parallel/shuffle.py partition_dest at
  k14_inputs' shapes (the smoke's: 7.5 M int64 keys, 95 % live, 8 buckets
  of twice the mean share, "main"; its salt-4 build side, "salt4"; buckets
  that overflow; the shuffle census's median slice of 1,584,384 rows, at
  an odd offset, "median"); k15_bucket_<shape>: radix_bucket (K14, K15's
  scatter, K6's gather of the key, an int32 and a float64 column, the
  masking) at the same shapes; each by events, with its split and its
  device ms (the split's sum).
Prints one JSON object with the times, the checkout's root and the card's
name and power limit. It needs a CUDA card.

    python -m quickstep_tpu_torch.bench.kernel_ab --cases k9,k2,compact

runs the cases whose names start with one of the given prefixes (every
case by default).
"""

from __future__ import annotations

import argparse
import inspect
import json
import pathlib
import statistics
import subprocess

import torch

N = 60_000_000


def _ms(fn, reps: int = 10) -> float:
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


INT64_MAX = 2 ** 63 - 1
# K5's shapes: (groups, live share) over n sorted rows
SEGMENT_SHAPES = {"groups_15m": (15_000_000, 0.8), "q9": (175, 0.054),
                  "one_group": (1, 1.0)}


def segment_inputs(shape: str, n: int, dev, gen):
    """(change, s_alive, perm, last) of a sort GROUP BY over n rows of
    SEGMENT_SHAPES[shape], as ops/groupby.py makes them: random group keys,
    dead rows sorted last (one_group: every row live, in one group)."""
    groups, live = SEGMENT_SHAPES[shape]
    key = torch.randint(0, groups, (n,), device=dev, generator=gen)
    alive = torch.rand(n, device=dev, generator=gen) < live
    s_key, perm = torch.sort(torch.where(alive, key, INT64_MAX), stable=True)
    s_alive = s_key != INT64_MAX
    one = torch.ones(1, dtype=torch.bool, device=dev)
    change = s_alive & torch.cat([one, s_key[1:] != s_key[:-1]])
    last = s_alive & torch.cat([change[1:] | ~s_alive[1:], one])
    return change, s_alive, perm, last


def unique_probe_inputs(shape: str, n: int, dev, gen):
    """(build keys, build mask, probe keys, probe mask) of K4. q5: Q5's 100 K
    (suppkey, nationkey) keys range-packed into int64, 90 % live, and n
    random probe keys over their range, 80 % live. q9: partsupp's 8 M
    (partkey, suppkey) keys packed, all live, and n live probes that each
    name one of them."""
    if shape == "q5":
        nk = 100_000
        bkey = torch.arange(1, nk + 1, device=dev) * 25 + torch.randint(
            0, 25, (nk,), device=dev, generator=gen)
        balive = torch.rand(nk, device=dev, generator=gen) < 0.9
        pkey = torch.randint(0, 25 * (nk + 1), (n,), device=dev,
                             generator=gen)
        palive = torch.rand(n, device=dev, generator=gen) < 0.8
        return bkey, balive, pkey, palive
    parts = torch.arange(1, 2_000_001, device=dev).repeat_interleave(4)
    supp = (parts + torch.arange(4, device=dev).repeat(2_000_000)
            * (25_000 + (parts - 1) // 100_000)) % 100_000 + 1
    bkey = parts * 100_001 + supp
    balive = torch.ones(len(bkey), dtype=torch.bool, device=dev)
    pkey = bkey[torch.randint(0, len(bkey), (n,), device=dev, generator=gen)]
    return bkey, balive, pkey, torch.ones(n, dtype=torch.bool, device=dev)


def k8_inputs(dev, gen, skew_rows: int = 0):
    """(build keys, build mask, int32 build values, probe keys, probe mask,
    int32 probe values) of Q21's EXISTS with `<>` at SF10: lineitem's
    orderkeys (1-7 lines for each of 15 M orders, every 4th key), 63 % of
    the rows live (the late lines), suppkeys in [1, 100 K], and 38 M probe
    rows drawn from the build rows, 90 % live. skew_rows: that many build
    rows moved onto one key and made live."""
    nb = 15_000_000
    lines = torch.randint(1, 8, (nb,), device=dev, generator=gen)
    okey = (torch.arange(1, nb + 1, device=dev) * 4).repeat_interleave(lines)
    n = len(okey)
    supp = torch.randint(1, 100_001, (n,), device=dev, generator=gen,
                         dtype=torch.int32)
    late = torch.rand(n, device=dev, generator=gen) < 0.63
    pick = torch.randint(0, n, (38_000_000,), device=dev, generator=gen)
    p_okey, p_supp = okey[pick], supp[pick]
    p_alive = torch.rand(len(pick), device=dev, generator=gen) < 0.9
    if skew_rows:
        rows = torch.randperm(n, device=dev, generator=gen)[:skew_rows]
        okey = okey.clone()
        okey[rows] = int(okey[n // 2])
        late = late.clone()
        late[rows] = True
    return okey, late, supp, p_okey, p_alive, p_supp


def k13_inputs(n: int, dev, gen):
    """(keys, valids, ascending, nulls_first, alive) of ORDER BY a DOUBLE
    DESC of two decimals in [900, 105 000], a nullable INT of 1..50 (10 %
    NULL) and an int64 permutation tiebreak, 95 % of the rows live."""
    price = torch.randint(90_000, 10_500_000, (n,), device=dev,
                          generator=gen).double() / 100
    qty = torch.randint(1, 51, (n,), device=dev, generator=gen,
                        dtype=torch.int32)
    qvalid = torch.rand(n, device=dev, generator=gen) < 0.9
    tie = torch.randperm(n, device=dev, generator=gen)
    alive = torch.rand(n, device=dev, generator=gen) < 0.95
    return ([price, qty, tie], [None, qvalid, None], [False, True, True],
            [None, None, None], alive)


N_PARTS = 2_000_000            # part rows at SF10; partsupp has 4 a part
N_SUPPLIERS = 100_000
N_SKEW_ROWS = 10_000_000


def _partsupp_pairs(part, i):
    """TPC-H's rule for a part's i-th supplier: (partkey, suppkey) int32."""
    s = N_SUPPLIERS
    supp = (part + i * (s // 4 + (part - 1) // s)) % s + 1
    return [part.to(torch.int32), supp.to(torch.int32)]


def k11_inputs(shape: str, dev, gen):
    """(build key columns, build mask, probe key columns, probe mask, table
    size) of K11. oq2: lineitem's N (partkey, suppkey) pairs (each line one
    of its part's 4 suppliers), 95 % live, probed by partsupp's 8 M pairs;
    skewed: the same with N_SKEW_ROWS build rows on one pair, live; oq3:
    partsupp's 8 M pairs built, all live, and lineitem's N pairs probed,
    all live."""
    from quickstep_tpu_torch.ops import kernels as K
    part = torch.randint(1, N_PARTS + 1, (N,), device=dev, generator=gen)
    i = torch.randint(0, 4, (N,), device=dev, generator=gen)
    lineitem = _partsupp_pairs(part, i)
    del part, i
    ps_part = torch.arange(1, N_PARTS + 1, device=dev).repeat_interleave(4)
    partsupp = _partsupp_pairs(ps_part, torch.arange(4, device=dev).repeat(
        N_PARTS))
    n_ps = len(ps_part)
    if shape == "oq3":
        return (partsupp, torch.ones(n_ps, dtype=torch.bool, device=dev),
                lineitem, torch.ones(N, dtype=torch.bool, device=dev),
                K.next_pow2(2 * n_ps))
    balive = torch.rand(N, device=dev, generator=gen) < 0.95
    if shape == "skewed":
        rows = torch.randperm(N, device=dev, generator=gen)[:N_SKEW_ROWS]
        for c, p in zip(lineitem, partsupp):
            c[rows] = p[n_ps // 2]
        balive[rows] = True
    return (lineitem, balive, partsupp,
            torch.ones(n_ps, dtype=torch.bool, device=dev),
            K.next_pow2(2 * N))


def sorted_segments(n: int, n_segments: int, dev, gen):
    """Flags of n sorted rows in ~n_segments random segments: (segment
    start, the segment id of each row)."""
    seg_id, _ = torch.sort(torch.randint(0, n_segments, (n,), device=dev,
                                         generator=gen))
    start = torch.ones(n, dtype=torch.bool, device=dev)
    start[1:] = seg_id[1:] != seg_id[:-1]
    return start, seg_id


def w1_inputs(shape: str, dev, gen):
    """(fn, contributions or None, live, segment starts, peer starts or
    None for the whole-partition mode, the values before the live mask) of
    W1 at the SF10 window queries' shapes (see the module's docstring)."""
    if shape in ("whole", "running_max"):
        seg, _ = sorted_segments(N, N_SUPPLIERS, dev, gen)
        live = torch.rand(N, device=dev, generator=gen) < 0.9
        if shape == "whole":
            price = torch.randint(90_000, 10_500_000, (N,), device=dev,
                                  generator=gen).double() / 100
            return ("sum", torch.where(live, price, 0.0), live, seg, None,
                    price)
        qty = torch.randint(100, 5_001, (N,), device=dev, generator=gen)
        peer = seg | (torch.rand(N, device=dev, generator=gen) < 0.2)
        return ("max", torch.where(live, qty, torch.iinfo(torch.int64).min),
                live, seg, peer, qty)
    if shape == "count_15m":
        lines = torch.randint(1, 8, (15_000_000,), device=dev, generator=gen)
        seg = torch.zeros(int(lines.sum()), dtype=torch.bool, device=dev)
        seg[torch.cumsum(lines, 0)[:-1]] = True
        seg[0] = True
        live = torch.rand(len(seg), device=dev, generator=gen) < 0.9
        return ("count", None, live, seg, torch.ones_like(seg), None)
    m = 15_000_000
    seg = torch.zeros(m, dtype=torch.bool, device=dev)
    seg[0] = True
    peer = seg | (torch.rand(m, device=dev, generator=gen) < 1 / 6_000)
    price = torch.randint(90_000, 10_500_000, (m,), device=dev,
                          generator=gen).double() / 100
    return ("sum", price, torch.ones(m, dtype=torch.bool, device=dev), seg,
            peer, price)


def kernel_split(fn) -> dict:
    """The device ms of each kernel of one call of fn (after a warm-up), by
    torch.profiler, summed by kernel name; a name that launched more than
    once carries its count (" x3")."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            key = e.key.removeprefix("void ").replace(
                "(anonymous namespace)::", "")
            name = key.split("(")[0]
            if "<" in name:
                head, args = name.split("<", 1)
                name = f"{head.split('::')[-1]}<{args[:30]}"
            if e.count > 1:
                name = f"{name} x{e.count}"
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1000
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def k11_cases(dev, gen) -> dict:
    from quickstep_tpu_torch.ops import join as J

    def both(b, ba, p, pa, size):
        return J.oa_probe(J.oa_build(b, ba, size)[0], b, p, pa)

    out = {}
    for shape in ("oq2", "oq3", "skewed"):
        args = k11_inputs(shape, dev, gen)
        out[f"k11_{shape}_ms"] = _ms(lambda: both(*args))
        if shape != "skewed":
            out[f"k11_split_{shape}"] = kernel_split(lambda: both(*args))
        del args
        torch.cuda.empty_cache()
    return out


def w1_cases(dev, gen) -> dict:
    from quickstep_tpu_torch.ops import window as W
    out = {}
    for shape in ("whole", "running_max", "count_15m", "one_segment"):
        fn, c, live, seg, peer, v = w1_inputs(shape, dev, gen)
        if peer is None:
            def call():
                return W._seg_total(fn, c, live, v, seg)
        else:
            def call():
                return W.segmented_prefix(fn, c, live, seg, peer)
        out[f"w1_{shape}_ms"] = _ms(call)
        if shape == "whole":
            out["w1_split"] = kernel_split(call)
        del fn, c, live, seg, peer, v, call
        torch.cuda.empty_cache()
    return out


N_ONE_SEGMENT = 15_000_000      # W-Q3's single segment (orders at SF10)


def w3w4_inputs(shape: str, dev, gen):
    """(segment starts, frame_bounds' arguments after the flags, and for
    W4 the float64 contributions) at the window queries' shapes: "wq4",
    N rows in ~N_PARTS partitions, ROWS 3 PRECEDING; "wq5", N rows in
    ~N_SUPPLIERS partitions, RANGE +-30 over int32 date codes (0 to 3,599)
    sorted within each; "one_segment", N_ONE_SEGMENT rows in one segment,
    ROWS 3 PRECEDING. Values are DECIMAL(15,2) prices, 90 % live."""
    if shape == "one_segment":
        seg = torch.zeros(N_ONE_SEGMENT, dtype=torch.bool, device=dev)
        seg[0] = True
        args = ("rows", 3, 0)
    elif shape == "wq4":
        seg, _ = sorted_segments(N, N_PARTS, dev, gen)
        args = ("rows", 3, 0)
    else:
        seg, seg_id = sorted_segments(N, N_SUPPLIERS, dev, gen)
        codes = torch.randint(0, 3_600, (N,), device=dev, generator=gen)
        key = (torch.sort(seg_id * 4_096 + codes)[0] - seg_id * 4_096).to(
            torch.int32)
        return seg, ("range", 30, 30, key), None
    n = len(seg)
    price = torch.randint(90_000, 10_500_000, (n,), device=dev,
                          generator=gen).double() / 100
    live = torch.rand(n, device=dev, generator=gen) < 0.9
    return seg, args, torch.where(live, price, 0.0)


def w4_steps(lo, hi, is_start) -> int:
    """The subtract and add steps of W4's walks over these frames (the
    reference's step: subtract from the previous lo to this lo - 1, then
    add from max(previous end, lo) to this end - 1)."""
    lo64, end = lo.long(), hi.long() + 1
    plo = torch.cat([lo64[:1], lo64[:-1]])
    pend = torch.cat([lo64[:1], end[:-1]])
    plo = torch.where(is_start, lo64, plo)
    pend = torch.where(is_start, lo64, pend)
    subs = torch.clamp(lo64 - plo, min=0)
    adds = torch.clamp(end - torch.maximum(pend, lo64), min=0)
    return int((subs + adds).sum())


def w3w4_cases(dev, gen) -> dict:
    """The cases of W3 and W4 (PR 13)."""
    from quickstep_tpu_torch.ops import cuda, window as W
    out = {}
    seg, args, c = w3w4_inputs("wq4", dev, gen)
    lo, hi = W.frame_bounds(seg, *args)
    out["w3_rows_wq4_ms"] = _ms(lambda: W.frame_bounds(seg, *args))
    c32 = c.float()
    out["w4_wq4_f64_ms"] = _ms(lambda: W.sliding_sums(c, lo, hi, seg))
    out["w4_wq4_f32_ms"] = _ms(lambda: W.sliding_sums(c32, lo, hi, seg))
    out["w4_split"] = kernel_split(lambda: W.sliding_sums(c, lo, hi, seg))
    del seg, c, c32, lo, hi
    torch.cuda.empty_cache()
    seg, args, _ = w3w4_inputs("wq5", dev, gen)
    out["w3_range_wq5_ms"] = _ms(lambda: W.frame_bounds(seg, *args))
    out["w3_split"] = kernel_split(lambda: W.frame_bounds(seg, *args))
    del seg, args
    torch.cuda.empty_cache()
    seg, args, c = w3w4_inputs("one_segment", dev, gen)
    lo, hi = W.frame_bounds(seg, *args)
    out["w4_one_segment_ms"] = _ms(lambda: W.sliding_sums(c, lo, hi, seg),
                                   reps=2)
    steps = w4_steps(lo, hi, seg)
    out["w4_one_segment_steps"] = steps
    if hasattr(cuda, "add_chain"):
        chain = 1 << 24
        for dt, name in ((torch.float64, "f64"), (torch.float32, "f32")):
            x = torch.tensor([0.1, 1e-9], dtype=dt, device=dev)
            out[f"w4_add_ns_{name}"] = _ms(lambda: cuda.add_chain(x, chain),
                                           reps=3) * 1e6 / chain
        out["w4_chain_bound_ms"] = steps * out["w4_add_ns_f64"] / 1e6
    return out


N_ORDERS = 15_000_000           # orders rows at SF10
K16_SLOTS = 1 << 22             # the shuffle join's largest LIP table
# K16 probes of the mesh's sizes (chip_smoke.py's census, PERF.md)
K16_MESH_ROWS = (4_096, 65_536, 937_500, 1_584_384, 3_750_000, 15_000_000,
                 29_131_264)


def w2_inputs(shape: str, dev, gen):
    """(fn, c, lo, hi) of W2 at the SF10 window queries' shapes: "wq5",
    MAX of int64 quantities over RANGE +-30 frames of int32 date codes,
    60 M rows in ~N_SUPPLIERS partitions; "wq6", MIN of float64 prices over
    ROWS 1 PRECEDING .. 1 FOLLOWING in N_ORDERS orders of 1-7 lines;
    "long", MAX of float64 prices over ROWS 1,500 PRECEDING in one
    N_ONE_SEGMENT-row segment. 90 % live; dead rows hold the sentinel."""
    from quickstep_tpu_torch.ops import window as W
    if shape == "wq5":
        seg, args, _ = w3w4_inputs("wq5", dev, gen)
        fn = "max"
        vals = torch.randint(100, 5_001, (N,), device=dev, generator=gen)
    elif shape == "wq6":
        lines = torch.randint(1, 8, (N_ORDERS,), device=dev, generator=gen)
        seg = torch.zeros(int(lines.sum()), dtype=torch.bool, device=dev)
        seg[torch.cumsum(lines, 0)[:-1]] = True
        seg[0] = True
        args, fn = ("rows", 1, 1), "min"
    else:
        seg = torch.zeros(N_ONE_SEGMENT, dtype=torch.bool, device=dev)
        seg[0] = True
        args, fn = ("rows", 1_500, 0), "max"
    n = len(seg)
    if shape != "wq5":
        vals = torch.randint(90_000, 10_500_000, (n,), device=dev,
                             generator=gen).double() / 100
    live = torch.rand(n, device=dev, generator=gen) < 0.9
    lo, hi = W.frame_bounds(seg, *args)
    return fn, W._sentinel_fill(fn, vals, live), lo, hi


def w2_cases(dev, gen) -> dict:
    """The cases of W2."""
    from quickstep_tpu_torch.ops import window as W
    out = {}
    for shape in ("wq5", "wq6", "long"):
        fn, c, lo, hi = w2_inputs(shape, dev, gen)
        out[f"w2_{shape}_ms"] = _ms(lambda: W.frame_minmax(fn, c, lo, hi))
        out[f"w2_{shape}_split"] = kernel_split(
            lambda: W.frame_minmax(fn, c, lo, hi))
        del c, lo, hi
        torch.cuda.empty_cache()
    return out


def k16_cases(dev, gen) -> dict:
    """The cases of K16."""
    from quickstep_tpu_torch.ops import bloom as B
    out = {}
    okey = torch.arange(1, N_ORDERS + 1, device=dev) * 4
    oalive = torch.rand(N_ORDERS, device=dev, generator=gen) < 0.5
    out["k16_build_ms"] = _ms(lambda: B.bloom_build([okey], oalive,
                                                     K16_SLOTS))
    out["k16_build_split"] = kernel_split(
        lambda: B.bloom_build([okey], oalive, K16_SLOTS))
    table = B.bloom_build([okey], oalive, K16_SLOTS)
    lkey = torch.randint(1, 4 * N_ORDERS + 4, (N,), device=dev,
                         generator=gen)
    lalive = torch.rand(N, device=dev, generator=gen) < 0.9
    # at 2^22 slots, and at 2^20 and 2^19 (tables that L1 mostly holds)
    for slots in (K16_SLOTS, 1 << 20, 1 << 19):
        tag = "" if slots == K16_SLOTS else f"_2e{slots.bit_length() - 1}"
        words = table if slots == K16_SLOTS else \
            B.bloom_build([okey], oalive, slots)
        out[f"k16_probe{tag}_ms"] = _ms(
            lambda: B.bloom_probe(words, [lkey], lalive))
        out[f"k16_probe{tag}_split"] = kernel_split(
            lambda: B.bloom_probe(words, [lkey], lalive))
        for m in K16_MESH_ROWS:
            k, a = lkey[1:m + 1], lalive[1:m + 1]    # a shard's slice
            out[f"k16_mesh_{m}{tag}_ms"] = _ms(
                lambda: B.bloom_probe(words, [k], a))
            out[f"k16_mesh_{m}{tag}_device_ms"] = sum(
                kernel_split(lambda: B.bloom_probe(words, [k], a)).values())
    return out


N_SHARD_ROWS = 7_500_000       # one of 8 row shards of lineitem at SF10
MESH_SHARDS = 8
# the shuffle census's median probe slice (profile_slice --shuffle-census)
N_MEDIAN_SLICE = 1_584_384


def k14_inputs(dev, gen):
    """The smoke's mesh shard: (N_SHARD_ROWS int64 keys, 95 % live; the
    shapes as (name, n rows of them, n_parts, cap, salt, probe_side)):
    "main" into MESH_SHARDS buckets of twice the mean share, "salt4" the
    salt-4 build side, "overflow" buckets a tenth short of the mean
    share, "median" the census's median slice (at an odd offset)."""
    n, parts = N_SHARD_ROWS, MESH_SHARDS
    key = torch.randint(1, 4 * N_ORDERS, (n + 1,), device=dev, generator=gen)
    alive = torch.rand(n + 1, device=dev, generator=gen) < 0.95
    cap = 2 * n // parts
    m = N_MEDIAN_SLICE
    return key, alive, (("main", n, parts, cap, 1, True),
                        ("salt4", n, parts, 4 * cap, 4, False),
                        ("overflow", n, parts, n // parts * 9 // 10, 1, True),
                        ("median", m, parts, 2 * m // parts, 1, True))


def k14k15_cases(dev, gen) -> dict:
    """K14 (shuffle.py partition_dest) and the shuffle's bucket step
    (shuffle.py radix_bucket: K14, K15's scatter, K6's gather) at each of
    k14_inputs' shapes, by events and by device time with its split; K15's
    own kernels are in the radix_bucket splits. The payload is the key, an
    int32 and a float64 column."""
    from quickstep_tpu_torch.parallel import shuffle as SH
    out = {}
    key, alive, shapes = k14_inputs(dev, gen)
    i32 = torch.randint(0, 2 ** 31 - 1, key.shape, device=dev, generator=gen,
                        dtype=torch.int32)
    f64 = torch.rand(key.shape, device=dev, generator=gen,
                     dtype=torch.float64)
    for name, n, parts, cap, salt, probe in shapes:
        off = 1 if name == "median" else 0
        k, a = key[off:off + n], alive[off:off + n]
        cols = [k, i32[off:off + n], f64[off:off + n]]

        def k14(k=k, a=a, parts=parts, cap=cap, salt=salt, probe=probe):
            return SH.partition_dest(k, a, parts, cap, salt, probe)

        def bucket(k=k, a=a, cols=cols, parts=parts, cap=cap, salt=salt,
                   probe=probe):
            return SH.radix_bucket(k, cols, a, parts, cap, salt, probe)
        for tag, fn in (("k14", k14), ("k15_bucket", bucket)):
            out[f"{tag}_{name}_ms"] = _ms(fn)
            split = kernel_split(fn)
            out[f"{tag}_{name}_split"] = split
            out[f"{tag}_{name}_device_ms"] = sum(split.values())
    return out


N_COMPACT_LIVE = 3_500_000     # compact_60m's live rows
COMPACT_TARGET = 1 << 22


def k9_inputs(dev, gen, n: int = N):
    """(a mask of n rows, 50 % live; compact_60m's mask, N_COMPACT_LIVE
    rows live at random)."""
    half = torch.rand(n, device=dev, generator=gen) < 0.5
    sparse = torch.zeros(n, dtype=torch.bool, device=dev)
    sparse[torch.randperm(n, device=dev, generator=gen)[:N_COMPACT_LIVE]] = True
    return half, sparse


def k2_inputs(dev, gen, n: int = N):
    """(key columns, offsets, strides, domain, aggregate specs, alive) of
    Q1's dense GROUP BY at n rows (see the module's docstring): int64
    values of DECIMAL(15,2) magnitudes."""
    flag = torch.randint(0, 3, (n,), device=dev, generator=gen,
                         dtype=torch.int32)
    status = torch.randint(0, 2, (n,), device=dev, generator=gen,
                           dtype=torch.int32)
    qty = torch.randint(100, 5_001, (n,), device=dev, generator=gen)
    price = torch.randint(90_000, 10_500_000, (n,), device=dev,
                          generator=gen)
    disc = torch.randint(0, 11, (n,), device=dev, generator=gen)
    disc_price = price * (100 - disc)
    charge = disc_price * torch.randint(100, 109, (n,), device=dev,
                                        generator=gen)
    alive = torch.rand(n, device=dev, generator=gen) < 0.98
    specs = [("sum", qty, None), ("sum", price, None),
             ("sum", disc_price, None), ("sum", charge, None),
             ("count", None, None), ("sum", disc, None)]
    return [flag, status], [0, 0], [2, 1], 6, specs, alive


def k9k2_cases(dev, gen) -> dict:
    """The cases of K9, the runner's compaction and K2."""
    from quickstep_tpu_torch.exec.chunk import Chunk
    from quickstep_tpu_torch.exec.runner import PlanRunner
    from quickstep_tpu_torch.ops import groupby as G, kernels as K
    half, sparse = k9_inputs(dev, gen)
    small = half[:4096].clone()
    out = {"k9_ms": _ms(lambda: K.stable_partition(half)),
           "k9_4096_ms": _ms(lambda: K.stable_partition(small)),
           "k9_split": kernel_split(lambda: K.stable_partition(half)),
           "k9_limit_ms": None}
    if "limit" in inspect.signature(K.stable_partition).parameters:
        live = int(half.sum())
        out["k9_limit_ms"] = _ms(lambda: K.stable_partition(half,
                                                            limit=live))
        out["k9_limit_split"] = kernel_split(
            lambda: K.stable_partition(half, limit=live))

    class Runner:               # what _compact_chunk reads of its runner
        mesh = None
    chunk = Chunk(attrs=[], slots={}, alive=sparse, capacity=N)
    out["compact_60m_ms"] = _ms(lambda: PlanRunner._compact_chunk(
        Runner(), chunk, COMPACT_TARGET))
    out["compact_60m_split"] = kernel_split(lambda: PlanRunner._compact_chunk(
        Runner(), chunk, COMPACT_TARGET))
    del half, sparse, small, chunk
    torch.cuda.empty_cache()
    keys, offs, strides, domain, specs, alive = k2_inputs(dev, gen)
    if hasattr(G, "dense_aggregate"):
        def q1():
            return G.dense_aggregate(keys, offs, strides, domain, specs,
                                     alive)
    else:
        def q1():
            idx = G.pack_dense_index(keys, offs, strides, domain, alive)
            return G.dense_groupby(idx, domain, specs, alive)
    out["k2_q1_ms"] = _ms(q1)
    out["k2_split"] = kernel_split(q1)
    from quickstep_tpu_torch.ops import cuda
    if hasattr(cuda, "DENSE_LANE_BYTES"):     # K2's warp path at Q1's shape
        lane_bytes = cuda.DENSE_LANE_BYTES
        cuda.DENSE_LANE_BYTES = 0
        try:
            out["k2_q1_warp_path_ms"] = _ms(q1)
        finally:
            cuda.DENSE_LANE_BYTES = lane_bytes
    half = alive & (torch.rand(N, device=dev, generator=gen) < 0.51)
    idx = G.pack_dense_index([keys[0] * 2 + keys[1]], [0], [1], domain, half)
    money = specs[1][1]
    out["k2_single_ms"] = _ms(lambda: G.dense_groupby(
        idx, domain, [("sum", money, None)], half))
    out["k2_single_split"] = kernel_split(lambda: G.dense_groupby(
        idx, domain, [("sum", money, None)], half))
    wide = torch.randint(0, 128, (N,), device=dev, generator=gen)
    out["k2_d128_ms"] = _ms(lambda: G.dense_groupby(
        wide, 128, [("sum", money, None)], half))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default="",
                    help="comma-separated prefixes of the cases to run")
    prefixes = [p for p in ap.parse_args().cases.split(",") if p]
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: torch.cuda.is_available() is false")
    from quickstep_tpu_torch.ops import cuda, kernels as K
    cuda.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {"root": str(pathlib.Path(K.__file__).resolve().parents[2]),
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               check=True, timeout=60).stdout.strip().splitlines()[0]}
    groups = ((("k9", "k2", "compact"), k9k2_cases),
              (("k11",), k11_cases), (("w1",), w1_cases),
              (("w3", "w4"), w3w4_cases), (("w2",), w2_cases),
              (("k16",), k16_cases), (("k14", "k15"), k14k15_cases),
              (("k3", "k4", "k5", "k6", "k7", "k8", "k12", "k13"),
               earlier_cases))
    for names, cases in groups:
        if not prefixes or any(g.startswith(p) or p.startswith(g)
                               for g in names for p in prefixes):
            out.update({k: v for k, v in cases(dev, gen).items()
                        if not prefixes or any(k.startswith(p)
                                               for p in prefixes)})
            torch.cuda.empty_cache()
    print(json.dumps(out))


def earlier_cases(dev, gen) -> dict:
    """The cases of K3-K8, K12 and K13 (PRs 7-10)."""
    from quickstep_tpu_torch.ops import cuda, groupby as G, kernels as K
    from quickstep_tpu_torch.ops import bloom as B, join as J
    live = torch.rand(N, device=dev, generator=gen) < 0.5
    pkey = torch.randint(1, 1 << 30, (N,), device=dev, generator=gen,
                         dtype=torch.int32)
    money = torch.randint(0, 10**7, (N,), device=dev, generator=gen)
    price = torch.rand(N, device=dev, generator=gen, dtype=torch.float64)
    cols = [live, pkey, pkey + 1, money, price.float(), price]
    asc = torch.nonzero(torch.rand(N, device=dev, generator=gen) < 0.5
                        ).flatten()
    rnd = torch.randint(0, N, (N,), device=dev, generator=gen)
    random_kw = {"random": True} if "random" in inspect.signature(
        K.multi_gather).parameters else {}
    vals = torch.randint(1, 2_000_001, (N,), device=dev, generator=gen,
                         dtype=torch.int32)
    every = torch.ones(N, dtype=torch.bool, device=dev)
    nb, domain = 15_000_000, 60_000_000
    bkey = torch.arange(1, nb + 1, device=dev, dtype=torch.int32) * 4
    balive = torch.rand(nb, device=dev, generator=gen) < 0.5
    rkey = torch.randint(1, domain + 4, (N,), device=dev, generator=gen,
                         dtype=torch.int32)
    palive = torch.rand(N, device=dev, generator=gen) < 0.8
    lines = torch.randint(1, 8, (nb,), device=dev, generator=gen)
    akey = bkey.repeat_interleave(lines)
    aalive = torch.rand(len(akey), device=dev, generator=gen) < 0.8
    table, _ = J.direct_build(bkey, balive, 4, domain)
    parts = torch.arange(1, 2_000_001, device=dev).repeat_interleave(4)
    sk, order = J.sorted_build(
        parts, torch.rand(len(parts), device=dev, generator=gen) < 0.95)
    probe = torch.randint(1, 2_200_000, (N,), device=dev, generator=gen)
    supp = (parts + torch.arange(4, device=dev).repeat(2_000_000)
            * (25_000 + (parts - 1) // 100_000)) % 100_000 + 1
    packed = parts * 100_001 + supp
    psk, porder = J.sorted_build(
        packed, torch.ones(len(packed), dtype=torch.bool, device=dev))
    pprobe = packed[torch.randint(0, len(packed), (N,), device=dev,
                                  generator=gen)]
    q5 = unique_probe_inputs("q5", N, dev, gen)
    q9b, q9ba, q9p, q9pa = unique_probe_inputs("q9", N, dev, gen)
    q9sk, q9order = J.sorted_build(q9b, q9ba)
    seg15 = segment_inputs("groups_15m", N, dev, gen)
    seg9 = segment_inputs("q9", N, dev, gen)
    k8 = k8_inputs(dev, gen)
    k13 = k13_inputs(N, dev, gen)
    from quickstep_tpu_torch.ops import sort as S
    out = {
        "k8_ms": _ms(lambda: J.merge_cmp_probe(*k8, "<>")),
        "k8_split": kernel_split(lambda: J.merge_cmp_probe(*k8, "<>")),
        "k13_ms": _ms(lambda: S.order_permutation(*k13)),
        "k13_split": kernel_split(lambda: S.order_permutation(*k13)),
        "k4_q5_ms": _ms(lambda: J.merge_unique_probe(*q5)),
        "k4_q9_ms": _ms(lambda: cuda.sorted_probe(q9sk, q9order, q9p, q9pa)),
        "k5_groups_15m_ms": _ms(lambda: cuda.segment_reduce(
            "sum", *seg15[:3], money, None)),
        "k5_q9_ms": _ms(lambda: cuda.segment_reduce("sum", *seg9[:3], price,
                                                    None)),
        "k3_random_ms": _ms(lambda: J.direct_probe(table, rkey, palive,
                                                   4, domain)),
        "k3_ascending_ms": _ms(lambda: J.direct_probe(table, akey, aalive, 4,
                                                      domain)),
        "k3_build_probe_ms": _ms(lambda: J.direct_probe(
            J.direct_build(bkey, balive, 4, domain)[0], rkey, palive, 4,
            domain)),
        "k7_ms": _ms(lambda: J.expand_probe(sk, order, probe, palive, 4)),
        "k7_packed_ms": _ms(lambda: J.expand_probe(psk, porder, pprobe,
                                                   palive, 4)),
        "k7_k16_ms": _ms(lambda: J.expand_probe(sk, order, probe, palive,
                                                16)),
        "k3_filter_random_ms": _ms(lambda: B.exact_filter_build(
            rkey, palive, 4, domain)),
        "k3_filter_ascending_ms": _ms(lambda: B.exact_filter_build(
            akey, aalive, 4, domain)),
        "k6_ascending_ms": _ms(lambda: K.multi_gather(cols, asc)),
        "k6_ascending_rows": int(asc.shape[0]),
        "k6_random_ms": _ms(lambda: K.multi_gather(cols, rnd, **random_kw)),
        "k6_random_packed": bool(random_kw),
        "k12_ms": _ms(lambda: G.distinct_count(vals, None, every)),
        "k8_skewed_ms": None,
    }
    if "build_key" in inspect.signature(cuda.run_stats_probe).parameters:
        # the parent's one thread a run would walk the 10 M-row run
        del k8, k13
        skewed = k8_inputs(dev, gen, skew_rows=10_000_000)
        out["k8_skewed_ms"] = _ms(lambda: J.merge_cmp_probe(*skewed, "<>"))
    return out


if __name__ == "__main__":
    main()
