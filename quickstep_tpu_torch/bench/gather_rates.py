"""The two rates of K6's cost model (ops/cuda.py COALESCED_BYTES_PER_S and
RANDOM_SECTORS_PER_S), measured on the card by CUDA events:

- coalesced bytes per second: a copy of a 1 GiB int64 tensor, read plus
  written bytes over its time;
- random 32-byte sectors per second: K6's direct route gathering one int64
  column of N rows (a source far larger than the 50 MB L2) by a uniformly
  random index of N rows, one sector per row, after its coalesced part (the
  index read and the output written, at the coalesced rate) is taken off;
- the same rate from sources that sit in the L2: int64 columns of 4 MiB
  and 512 KiB (the sizes of K16's byte table and bit table at 2^22 slots)
  gathered by N random indices, one L2 sector per row.

    python -m quickstep_tpu_torch.bench.gather_rates [--rows N]

Prints one JSON object with the rates, the times behind them and the card's
name and power limit. It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

L2_SOURCES = (4 << 20, 512 << 10)     # bytes of the L2-resident sources


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


def measure(rows: int) -> dict:
    from quickstep_tpu_torch.ops import cuda
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    x = torch.randint(0, 1 << 40, (1 << 27,), device=dev, generator=gen)
    y = torch.empty_like(x)
    copy_ms = _ms(lambda: y.copy_(x))
    coalesced = 2 * x.numel() * 8 / (copy_ms / 1e3)
    del x, y
    col = torch.randint(0, 1 << 40, (rows,), device=dev, generator=gen)
    idx = torch.randint(0, rows, (rows,), device=dev, generator=gen)
    gather_ms = _ms(lambda: cuda.multi_gather([col], idx))
    stream_ms = 2 * rows * 8 / coalesced * 1e3
    sectors = rows / ((gather_ms - stream_ms) / 1e3)
    l2 = {}
    for size in L2_SOURCES:
        src = col[:size // 8].clone()
        sidx = torch.randint(0, size // 8, (rows,), device=dev, generator=gen)
        ms = _ms(lambda: cuda.multi_gather([src], sidx))
        l2[f"l2_{size >> 10}k_gather_ms"] = ms
        l2[f"l2_{size >> 10}k_sectors_per_s"] = rows / ((ms - stream_ms) / 1e3)
        del src, sidx
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    return {"card": card, "copy_ms": copy_ms,
            "coalesced_bytes_per_s": coalesced, "rows": rows,
            "gather_ms": gather_ms, "random_sectors_per_s": sectors, **l2}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=60_000_000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gather_rates: torch.cuda.is_available() is false")
    print(json.dumps(measure(args.rows)))


if __name__ == "__main__":
    main()
