"""K6 and K12 at chip_smoke.py's SF10 shapes, timed in the checkout it runs
from, so that two checkouts can be compared on one card in one call (run
this file from each checkout's root in turn: parent, change, change,
parent). It uses only the public functions both sides have:
ops/kernels.py multi_gather (with random=True where the checkout takes it)
and ops/groupby.py distinct_count.

    python -m quickstep_tpu_torch.bench.kernel_ab

Cases, each timed by CUDA events (median of 10 runs after one warm-up):
- k6_ascending: six lineitem-like columns (1-, 4-, 4-, 8-, 4- and 8-byte)
  of 60 M rows gathered by the ascending positions of a random half-live
  mask (a compaction index, about 30 M rows);
- k6_random: the same columns by a uniformly random 60 M-row int64 index;
- k12: COUNT(DISTINCT) of 60 M int32 values in [1, 2 M], all live.
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: torch.cuda.is_available() is false")
    from quickstep_tpu_torch.ops import cuda, groupby as G, kernels as K
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
    out = {
        "root": str(pathlib.Path(K.__file__).resolve().parents[2]),
        "k6_ascending_ms": _ms(lambda: K.multi_gather(cols, asc)),
        "k6_ascending_rows": int(asc.shape[0]),
        "k6_random_ms": _ms(lambda: K.multi_gather(cols, rnd, **random_kw)),
        "k6_random_packed": bool(random_kw),
        "k12_ms": _ms(lambda: G.distinct_count(vals, None, every)),
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0],
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
