"""K3-K8, K12 and K13 at chip_smoke.py's SF10 shapes, timed in the
checkout it runs from, so that two checkouts can be compared on one card in
one call: run this file from each checkout's root in turn, parent, change,
change, parent, parent, change. It uses only the public functions both
sides have: ops/join.py direct_build and direct_probe, sorted_build,
merge_unique_probe, expand_probe and merge_cmp_probe, ops/cuda.py
sorted_probe and segment_reduce, ops/bloom.py exact_filter_build,
ops/kernels.py multi_gather (with random=True where the checkout takes
it), ops/groupby.py distinct_count and ops/sort.py order_permutation. Its
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
  (k13_inputs, the smoke's case); k13_split its kernels as for k8.
Prints one JSON object with the times, the checkout's root and the card's
name and power limit. It needs a CUDA card.
"""

from __future__ import annotations

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


def kernel_split(fn) -> dict:
    """The device ms of each kernel of one call of fn (after a warm-up), by
    torch.profiler, summed by kernel name."""
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
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1000
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: torch.cuda.is_available() is false")
    from quickstep_tpu_torch.ops import cuda, groupby as G, kernels as K
    from quickstep_tpu_torch.ops import bloom as B, join as J
    cuda.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
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
        "root": str(pathlib.Path(K.__file__).resolve().parents[2]),
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
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0],
    }
    if "build_key" in inspect.signature(cuda.run_stats_probe).parameters:
        # the parent's one thread a run would walk the 10 M-row run
        del k8, k13
        skewed = k8_inputs(dev, gen, skew_rows=10_000_000)
        out["k8_skewed_ms"] = _ms(lambda: J.merge_cmp_probe(*skewed, "<>"))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
