"""The SF100 campaign in one command: write the on-disk TPC-H store with
bench/sf100_fullgen.py, then run bench/sf100_full_verify.py on it under a
device memory budget, each in its own process, and keep what each took.

    python -m quickstep_tpu_torch.bench.sf100_campaign --device cuda
        [--scale 100] [--store data/tpch_sf100] [--out DIR]

Before it writes, it prints the card's name and power limit (nvidia-smi),
the free disk under the store's directory and the host's memory, and
refuses a scale whose store would not fit on the disk. The store is
written in chunks of CHUNK_ORDERS orders and verified under BUDGET_GB. On
the card the kernels are built while the store is written. DIR receives nvcc's log
(build.log), the generator's log (gen.log), the verifier's log and report
(verify.log, verify.json: cold and warm ms, segments, bytes and seconds of
the upload, peak device memory and host RSS of each query) and
campaign.json: the machine, the scale, the generator's seconds and peak
RSS, the store's bytes, and the verifier's seconds, peak RSS and exit
code, which is this command's.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

from quickstep_tpu_torch.bench.sf100_full_verify import DEFAULT_QS

# tools/sf100_fullgen.py's default chunk of orders
CHUNK_ORDERS = 10_000_000
# the device memory budget of the reference's SF100 record (SF100_r05.json's
# budget_gb)
BUDGET_GB = 10.0

# Bytes of the store a unit of scale: every column is one int32 .npy
# (lineitem 16 columns of 6 M rows, orders 9 of 1.5 M, partsupp 5 of
# 800 K, part 9 of 200 K, customer 8 of 150 K, supplier 7 of 10 K),
# plus a tenth for the dictionaries and the slack of the file system.
STORE_BYTES_PER_SF = 4 * (16 * 6_000_000 + 9 * 1_500_000 + 5 * 800_000 +
                          9 * 200_000 + 8 * 150_000 + 7 * 10_000) * 1.1


def card_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def host_memory():
    """(total, available) bytes of host memory from /proc/meminfo."""
    fields = {}
    with open("/proc/meminfo") as f:
        for line in f:
            name, value = line.split(":", 1)
            fields[name] = int(value.split()[0]) * 1024
    return fields["MemTotal"], fields["MemAvailable"]


def run_child(args, log_path, timeout=None, stop=None, **popen):
    """Run args (Popen's other arguments in popen) with its output in
    log_path: (exit code, seconds, the child's peak RSS in bytes, which
    Linux reports as at least this process's peak RSS when it spawned the
    child). The child is killed once it has run `timeout` seconds or the
    threading.Event `stop` is set, and its exit code is then -SIGKILL."""
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(args, stdout=log, stderr=subprocess.STDOUT,
                                **popen)
    while True:
        # the child's own resource use, which only wait4 returns
        pid, status, usage = os.wait4(proc.pid, os.WNOHANG)
        if pid:
            break
        if (timeout is not None and time.perf_counter() - t0 > timeout) \
                or (stop is not None and stop.is_set()):
            proc.kill()        # not reaped yet, so the pid is still its own
            _pid, status, usage = os.wait4(proc.pid, 0)
            break
        time.sleep(0.2)
    proc.returncode = os.waitstatus_to_exitcode(status)
    return (proc.returncode, time.perf_counter() - t0,
            usage.ru_maxrss * 1024)


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(root, name))
               for root, _dirs, names in os.walk(path) for name in names)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", required=True, choices=("cuda", "cpu"))
    ap.add_argument("--scale", type=float, default=100.0)
    ap.add_argument("--store", default=os.path.join("data", "tpch_sf100"))
    ap.add_argument("--out", default=os.path.join("chiprun_out", "sf100"))
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    parent = os.path.dirname(os.path.abspath(args.store))
    os.makedirs(parent, exist_ok=True)
    free_disk = shutil.disk_usage(parent).free
    mem_total, mem_avail = host_memory()
    card = card_line() if args.device == "cuda" else None
    report = {"card": card, "disk_free_bytes": free_disk,
              "host_memory_bytes": mem_total,
              "host_available_bytes": mem_avail, "cpus": os.cpu_count(),
              "scale": args.scale}
    print(f"card: {card}; disk free under {parent}: {free_disk / 1e9:.1f} "
          f"GB; host memory {mem_total / 2**30:.1f} GiB "
          f"({mem_avail / 2**30:.1f} available); {os.cpu_count()} cpus",
          flush=True)
    need = STORE_BYTES_PER_SF * args.scale
    if need > free_disk:
        raise SystemExit(f"SF{args.scale:g}'s store needs about "
                         f"{need / 1e9:.1f} GB, the disk has "
                         f"{free_disk / 1e9:.1f} GB: take a --scale below "
                         f"{free_disk / STORE_BYTES_PER_SF:.0f}")

    with open(os.path.join(args.out, "build.log"), "w") as build_log:
        # on the card, nvcc builds the kernels while the store is written
        build = subprocess.Popen(
            [sys.executable, "-c", "from quickstep_tpu_torch.ops import cuda;"
             " cuda.build(); print('nvcc', cuda.BUILD_SECONDS)"],
            stdout=build_log, stderr=subprocess.STDOUT) \
            if args.device == "cuda" else None
        rc, secs, rss = run_child(
            [sys.executable, "-m", "quickstep_tpu_torch.bench.sf100_fullgen",
             f"{args.scale:g}", str(CHUNK_ORDERS), args.store],
            os.path.join(args.out, "gen.log"))
        built = build is None or build.wait() == 0
    report.update(gen_rc=rc, gen_seconds=secs, gen_peak_rss_bytes=rss)
    if not built:
        raise SystemExit(f"the kernels did not build: see {args.out}/"
                         "build.log")
    if rc != 0:
        raise SystemExit(f"the generator failed ({rc}): see {args.out}/"
                         "gen.log")
    report["store_bytes"] = dir_bytes(args.store)
    print(f"store SF{args.scale:g}: {report['store_bytes']} bytes in "
          f"{secs:.1f} s,"
          f" generator peak RSS {rss / 2**30:.2f} GiB", flush=True)
    verify = [sys.executable, "-m",
              "quickstep_tpu_torch.bench.sf100_full_verify", args.store,
              str(BUDGET_GB), DEFAULT_QS,
              os.path.join(args.out, "verify.json"), "--device", args.device]
    rc, secs, rss = run_child(verify, os.path.join(args.out, "verify.log"))
    report.update(verify_rc=rc, verify_seconds=secs,
                  verify_peak_rss_bytes=rss, budget_gb=BUDGET_GB)
    with open(os.path.join(args.out, "campaign.json"), "w") as f:
        json.dump(report, f, indent=1)
    with open(os.path.join(args.out, "verify.log")) as f:
        print(f.read(), flush=True)
    print(json.dumps(report), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
