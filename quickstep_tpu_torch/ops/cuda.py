"""Build, load and call the hand-written CUDA kernels (csrc/*.cu).

The sources are compiled at first use with nvcc for sm_90a, one nvcc process
per source, all started together, and linked into one shared library with a
plain C interface (build/kernels/libqstorch_kernels.so at the root of the
checkout), which is loaded with ctypes. The library is rebuilt whenever a
hash of the sources and flags changes. Nothing is compiled or loaded when
this module is imported.

Every wrapper checks device, dtype, shape and contiguity, allocates the
kernel's outputs and scratch with torch, launches on torch's current CUDA
stream, raises when the launch reports an error, and adds one to its entry in
LAUNCHES for each kernel launch it makes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libqstorch_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

# Kernel launches by kernel, counted where each wrapper launches its kernel:
# K1 scalar_agg, K2 dense_groupby, K3 direct_join (the direct-address build
# and probe, and their presence mode for the exact filter), K4
# merge_unique_probe, K5 sort_groupby, K6 multi_gather, K7 expand_probe, K8
# merge_cmp_probe (its compare and stats modes), K9 sort_groupby_compact (the
# stable live-first partition), and the window kernels: W1 window_prefix, W2
# frame_minmax, W3 frame_bounds, W4 sliding_sum.
LAUNCHES = {"scalar_agg": 0, "dense_groupby": 0, "direct_join": 0,
            "merge_unique_probe": 0, "sort_groupby": 0, "multi_gather": 0,
            "expand_probe": 0, "merge_cmp_probe": 0,
            "sort_groupby_compact": 0, "window_prefix": 0,
            "frame_minmax": 0, "frame_bounds": 0, "sliding_sum": 0}
# Seconds the last build took in this process (None: the library was loaded
# from an earlier build with the same source hash).
BUILD_SECONDS: Optional[float] = None

_FN = {"sum": 0, "count": 1, "min": 2, "max": 3}
_DTYPE = {torch.int32: 0, torch.int64: 1, torch.float32: 2, torch.float64: 3}
_KEY = {torch.int32: 0, torch.int64: 1}
MAX_DOMAIN = 128
MAX_GATHER_COLS = 16          # kMaxCols in csrc/gather_kernels.cu
_THREADS = 256
_BLOCKS_PER_SM = 8

_lib = None
_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _source_hash(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()


def _compile(sources, lib_path: Path) -> None:
    """One nvcc per source, all running at once, then one link."""
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in sources]
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                         for s, o in zip(sources, objs))]
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}\n{err}")
    if not failed:
        tmp = BUILD_DIR / (LIB_NAME + f".{tag}")
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *[str(o) for o in objs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            failed.append(f"nvcc link failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
        else:
            os.replace(tmp, lib_path)
    for o in objs:
        if o.exists():
            o.unlink()
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> ctypes.CDLL:
    """Compile (when the sources changed) and load the kernel library."""
    global _lib, BUILD_SECONDS
    with _lock:
        if _lib is not None:
            return _lib
        sources = sorted(CSRC.glob("*.cu"))
        digest = _source_hash(sources)
        lib_path = BUILD_DIR / LIB_NAME
        stamp = BUILD_DIR / (LIB_NAME + ".sha256")
        if not (lib_path.exists() and stamp.exists()
                and stamp.read_text() == digest):
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            _compile(sources, lib_path)
            stamp.write_text(digest)
            BUILD_SECONDS = time.perf_counter() - t0
        lib = ctypes.CDLL(str(lib_path))
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        signatures = {
            "qs_masked_reduce": [i32, i32, p, p, p, i64, p, p, i32, p, p, p],
            "qs_dense_group_reduce": [i32, i32, p, p, p, p, i64, i32, p, p, p,
                                      i32, p, p, p, p],
            "qs_segment_reduce": [i32, i32, p, p, p, i64, p, p, p, p, i32, p],
            "qs_direct_build": [i32, i32, p, p, i64, i64, i64, p, p, i32, p],
            "qs_direct_probe": [i32, i32, p, p, i64, i64, i64, p, p, p, i32,
                                p],
            "qs_sorted_probe": [p, p, i64, p, p, i64, p, p, p, i32, p],
            "qs_multi_gather": [i32, p, p, p, i64, p, i32, i64, i32, p],
            "qs_expand_probe": [p, p, i64, p, p, i64, i32, p, p, p, i32, p],
            "qs_run_stats_probe": [p, p, i64, p, p, p, p, p, p, i64, i32, p,
                                   p, p, i32, i32, p],
            "qs_stable_partition": [p, i64, p, p, p, p],
            "qs_window_prefix": [i32, i32, p, p, p, p, i64, *[p] * 11],
            "qs_frame_bounds": [i32, i32, p, p, i64, i64, i64, i32, i32,
                                *[p] * 7],
            "qs_frame_minmax": [i32, i32, p, p, p, i64, p, i64, i32, p, p],
            "qs_sliding_sum": [i32, p, p, p, p, i64, p, p],
        }
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = i32
        lib.qs_error_string.argtypes = [i32]
        lib.qs_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.qs_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def _require(t: Optional[torch.Tensor], name: str, device: torch.device,
             n: int, dtypes) -> None:
    if t is None:
        return
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of "
                        f"{sorted(str(d) for d in dtypes)}")
    if t.dim() != 1 or t.shape[0] != n:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected ({n},)")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _blocks(n: int, device: torch.device) -> int:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min((n + _THREADS - 1) // _THREADS, _BLOCKS_PER_SM * sms))


def _acc_out_dtypes(fn: str, dtype: torch.dtype):
    """(accumulator dtype, output dtype) of a (fn, input dtype) pair; must
    match the table above QS_DISPATCH in csrc/agg_kernels.cu."""
    if fn == "count":
        return torch.int64, torch.int64
    if fn == "sum":
        if dtype.is_floating_point:
            return torch.float64, dtype
        return torch.int64, torch.int64
    return dtype, dtype


def _check_inputs(fn: str, vals, valid, alive) -> torch.device:
    if fn not in _FN:
        raise ValueError(f"unknown aggregate {fn!r}")
    if alive.device.type != "cuda":
        raise ValueError(f"alive is on {alive.device}: the kernel needs CUDA")
    n = int(alive.shape[0]) if alive.dim() == 1 else -1
    _require(alive, "alive", alive.device, n, (torch.bool,))
    _require(valid, "valid", alive.device, n, (torch.bool,))
    if fn != "count":
        if vals is None:
            raise ValueError(f"{fn} needs values")
        _require(vals, "vals", alive.device, n, tuple(_DTYPE))
    return alive.device


def masked_reduce(fn: str, vals: Optional[torch.Tensor],
                  valid: Optional[torch.Tensor], alive: torch.Tensor):
    """K1: (result 0-d tensor, live non-null count 0-d int64 tensor) of
    fn in {sum, count, min, max} over the rows where alive (and valid)."""
    device = _check_inputs(fn, vals, valid, alive)
    lib = build()
    n = int(alive.shape[0])
    dtype = vals.dtype if fn != "count" else torch.int64
    acc_dt, out_dt = _acc_out_dtypes(fn, dtype)
    blocks = _blocks(n, device)
    part_val = torch.empty(blocks, dtype=acc_dt, device=device)
    part_cnt = torch.empty(blocks, dtype=torch.int64, device=device)
    out_val = torch.empty((), dtype=out_dt, device=device)
    out_cnt = torch.empty((), dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.qs_masked_reduce(
        _FN[fn], _DTYPE[dtype], _ptr(vals if fn != "count" else None),
        _ptr(valid), _ptr(alive), n, _ptr(part_val), _ptr(part_cnt), blocks,
        _ptr(out_val), _ptr(out_cnt), stream)
    _check(lib, err, "masked_reduce")
    LAUNCHES["scalar_agg"] += 1
    if fn == "count":
        return out_cnt, out_cnt
    return out_val, out_cnt


def dense_group_reduce(fn: str, idx: torch.Tensor,
                       vals: Optional[torch.Tensor],
                       valid: Optional[torch.Tensor], alive: torch.Tensor,
                       domain: int):
    """K2: per group g in [0, domain) of the rows with alive and idx == g:
    (fn's result [domain], live non-null count int32 [domain], occupied
    bool [domain]). For fn == count the result is the count itself."""
    if not 1 <= domain <= MAX_DOMAIN:
        raise ValueError(f"dense group-by domain {domain} is outside "
                         f"[1, {MAX_DOMAIN}]")
    device = _check_inputs(fn, vals, valid, alive)
    n = int(alive.shape[0])
    _require(idx, "idx", device, n, (torch.int64,))
    if n >= 2 ** 31:
        raise ValueError(f"{n} rows overflow the int32 group counts")
    lib = build()
    dtype = vals.dtype if fn != "count" else torch.int64
    acc_dt, out_dt = _acc_out_dtypes(fn, dtype)
    blocks = _blocks(n, device)
    part_val = torch.empty((blocks, domain), dtype=acc_dt, device=device)
    part_nn = torch.empty((blocks, domain), dtype=torch.int32, device=device)
    part_occ = torch.empty((blocks, domain), dtype=torch.int32, device=device)
    out_val = torch.empty(domain, dtype=out_dt, device=device)
    out_nn = torch.empty(domain, dtype=torch.int32, device=device)
    out_occ = torch.empty(domain, dtype=torch.bool, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.qs_dense_group_reduce(
        _FN[fn], _DTYPE[dtype], _ptr(idx),
        _ptr(vals if fn != "count" else None), _ptr(valid), _ptr(alive), n,
        domain, _ptr(part_val), _ptr(part_nn), _ptr(part_occ), blocks,
        _ptr(out_val), _ptr(out_nn), _ptr(out_occ), stream)
    _check(lib, err, "dense_group_reduce")
    LAUNCHES["dense_groupby"] += 1
    if fn == "count":
        return out_nn, out_nn, out_occ
    return out_val, out_nn, out_occ


def _cuda_device(t: torch.Tensor, name: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}: the kernel needs CUDA")
    return t.device


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _rows(n: int, what: str) -> None:
    if n >= 2 ** 31:
        raise ValueError(f"{what}: {n} rows overflow the kernel's int32 row ids")


def segment_reduce(fn: str, change: torch.Tensor, s_alive: torch.Tensor,
                   perm: torch.Tensor, vals: Optional[torch.Tensor],
                   valid: Optional[torch.Tensor]):
    """K5: fn in {sum, count, min, max} over each group of key-sorted rows.
    Sorted row i is input row perm[i]; s_alive marks the live prefix and
    change the first row of each group. Returns (result [n], live non-null
    count int32 [n]), set at each group's last sorted row and 0 elsewhere;
    for fn == count the result is the count itself."""
    if fn not in _FN:
        raise ValueError(f"unknown aggregate {fn!r}")
    device = _cuda_device(s_alive, "s_alive")
    n = int(s_alive.shape[0]) if s_alive.dim() == 1 else -1
    _require(s_alive, "s_alive", device, n, (torch.bool,))
    _require(change, "change", device, n, (torch.bool,))
    _require(perm, "perm", device, n, (torch.int64,))
    _require(valid, "valid", device, n, (torch.bool,))
    if fn != "count":
        if vals is None:
            raise ValueError(f"{fn} needs values")
        _require(vals, "vals", device, n, tuple(_DTYPE))
    _rows(n, "segment_reduce")
    lib = build()
    dtype = vals.dtype if fn != "count" else torch.int64
    _acc, out_dt = _acc_out_dtypes(fn, dtype)
    out_val = None if fn == "count" else torch.empty(n, dtype=out_dt,
                                                     device=device)
    out_nn = torch.empty(n, dtype=torch.int32, device=device)
    if n == 0:
        return (out_nn if fn == "count" else out_val), out_nn
    err = lib.qs_segment_reduce(
        _FN[fn], _DTYPE[dtype], _ptr(change), _ptr(s_alive), _ptr(perm), n,
        _ptr(vals if fn != "count" else None), _ptr(valid), _ptr(out_val),
        _ptr(out_nn), _blocks(n, device), _stream(device))
    _check(lib, err, "segment_reduce")
    LAUNCHES["sort_groupby"] += 1
    return (out_nn if fn == "count" else out_val), out_nn


def direct_build(key: torch.Tensor, alive: torch.Tensor, lo: int, domain: int,
                 presence: bool = False):
    """K3 build over the live rows with key - lo in [0, domain). Table mode:
    (int32 table [domain] of build row or -1, 0-d bool dup flag). Presence
    mode (the exact filter): (bool table [domain], None)."""
    device = _cuda_device(alive, "alive")
    n = int(alive.shape[0]) if alive.dim() == 1 else -1
    _require(alive, "alive", device, n, (torch.bool,))
    _require(key, "key", device, n, tuple(_KEY))
    _rows(n, "direct_build")
    if not 1 <= domain < 2 ** 40:
        raise ValueError(f"direct-address domain {domain} is out of range")
    lib = build()
    if presence:
        table = torch.zeros(domain, dtype=torch.bool, device=device)
    else:
        table = torch.full((domain,), -1, dtype=torch.int32, device=device)
    dup = torch.zeros((), dtype=torch.int32, device=device)
    if n == 0:
        return table, (None if presence else dup != 0)
    err = lib.qs_direct_build(
        _KEY[key.dtype], int(presence), _ptr(key), _ptr(alive), n, int(lo),
        int(domain), _ptr(table), _ptr(dup), _blocks(n, device),
        _stream(device))
    _check(lib, err, "direct_build")
    LAUNCHES["direct_join"] += 1
    return table, (None if presence else dup != 0)


def direct_probe(table: torch.Tensor, key: torch.Tensor, alive: torch.Tensor,
                 lo: int):
    """K3 probe. Table mode (int32 table): (int32 build row or -1, bool
    matched). Presence mode (bool table): bool matched."""
    device = _cuda_device(alive, "alive")
    n = int(alive.shape[0]) if alive.dim() == 1 else -1
    _require(alive, "alive", device, n, (torch.bool,))
    _require(key, "key", device, n, tuple(_KEY))
    domain = int(table.shape[0]) if table.dim() == 1 else -1
    _require(table, "table", device, domain, (torch.int32, torch.bool))
    presence = table.dtype == torch.bool
    lib = build()
    matched = torch.empty(n, dtype=torch.bool, device=device)
    bidx = None if presence else torch.empty(n, dtype=torch.int32,
                                             device=device)
    if n == 0:
        return matched if presence else (bidx, matched)
    err = lib.qs_direct_probe(
        _KEY[key.dtype], int(presence), _ptr(key), _ptr(alive), n, int(lo),
        domain, _ptr(table), _ptr(bidx), _ptr(matched), _blocks(n, device),
        _stream(device))
    _check(lib, err, "direct_probe")
    LAUNCHES["direct_join"] += 1
    return matched if presence else (bidx, matched)


def sorted_probe(sorted_key: torch.Tensor, order: torch.Tensor,
                 probe: torch.Tensor, pmask: torch.Tensor):
    """K4: for each live probe row, the first build row (in the stable sort
    order) with an equal key. sorted_key holds the build keys sorted, dead
    rows as INT64_MAX; order is the sort permutation. Returns (int32 build
    row or -1, bool matched, 0-d bool dup flag: two equal live build keys)."""
    device = _cuda_device(pmask, "pmask")
    n_build = int(sorted_key.shape[0]) if sorted_key.dim() == 1 else -1
    n_probe = int(pmask.shape[0]) if pmask.dim() == 1 else -1
    _require(sorted_key, "sorted_key", device, n_build, (torch.int64,))
    _require(order, "order", device, n_build, (torch.int64,))
    _require(probe, "probe", device, n_probe, (torch.int64,))
    _require(pmask, "pmask", device, n_probe, (torch.bool,))
    _rows(n_build, "sorted_probe")
    lib = build()
    bidx = torch.empty(n_probe, dtype=torch.int32, device=device)
    matched = torch.empty(n_probe, dtype=torch.bool, device=device)
    dup = torch.zeros((), dtype=torch.int32, device=device)
    if n_build == 0 and n_probe == 0:
        return bidx, matched, dup != 0
    err = lib.qs_sorted_probe(
        _ptr(sorted_key), _ptr(order), n_build, _ptr(probe), _ptr(pmask),
        n_probe, _ptr(bidx), _ptr(matched), _ptr(dup),
        _blocks(max(n_probe, n_build), device), _stream(device))
    _check(lib, err, "sorted_probe")
    LAUNCHES["merge_unique_probe"] += 1
    return bidx, matched, dup != 0


def multi_gather(cols: List[torch.Tensor], idx: torch.Tensor):
    """K6: every column at rows idx (int32 or int64), MAX_GATHER_COLS
    columns per launch. Columns are 1-D, contiguous, of one length, with
    1-, 2-, 4- or 8-byte elements; an index outside the columns is
    clamped."""
    device = _cuda_device(idx, "idx")
    m = int(idx.shape[0]) if idx.dim() == 1 else -1
    _require(idx, "idx", device, m, (torch.int32, torch.int64))
    if not cols:
        return []
    n_src = int(cols[0].shape[0]) if cols[0].dim() == 1 else -1
    for i, c in enumerate(cols):
        _require(c, f"cols[{i}]", device, n_src, (c.dtype,))
        if c.element_size() not in (1, 2, 4, 8):
            raise TypeError(f"cols[{i}] has {c.element_size()}-byte elements")
    if m > 0 and n_src < 1:
        raise ValueError("multi_gather from empty columns")
    lib = build()
    outs = [torch.empty(m, dtype=c.dtype, device=device) for c in cols]
    if m == 0:
        return outs
    for s in range(0, len(cols), MAX_GATHER_COLS):
        part = range(s, min(s + MAX_GATHER_COLS, len(cols)))
        k = len(part)
        srcs = (ctypes.c_void_p * k)(*[cols[i].data_ptr() for i in part])
        dsts = (ctypes.c_void_p * k)(*[outs[i].data_ptr() for i in part])
        widths = (ctypes.c_int * k)(*[cols[i].element_size() for i in part])
        err = lib.qs_multi_gather(
            k, ctypes.cast(srcs, ctypes.c_void_p),
            ctypes.cast(dsts, ctypes.c_void_p),
            ctypes.cast(widths, ctypes.c_void_p), n_src, _ptr(idx),
            int(idx.dtype == torch.int64), m, _blocks(m, device),
            _stream(device))
        _check(lib, err, "multi_gather")
        LAUNCHES["multi_gather"] += 1
    return outs


def expand_probe(sorted_key: torch.Tensor, order: torch.Tensor,
                 probe: torch.Tensor, alive: torch.Tensor, k: int):
    """K7: for each live probe row, the first k build rows (in the stable
    sort order) whose key equals the probe key. sorted_key holds the build
    keys sorted, dead rows as INT64_MAX; order is the sort permutation.
    Returns (int32 rows [n * k], row-major, -1 pads; int32 run length [n],
    0 on dead rows; 0-d bool overflow flag: some live run is longer than
    k)."""
    device = _cuda_device(alive, "alive")
    n_build = int(sorted_key.shape[0]) if sorted_key.dim() == 1 else -1
    n_probe = int(alive.shape[0]) if alive.dim() == 1 else -1
    _require(sorted_key, "sorted_key", device, n_build, (torch.int64,))
    _require(order, "order", device, n_build, (torch.int64,))
    _require(probe, "probe", device, n_probe, (torch.int64,))
    _require(alive, "alive", device, n_probe, (torch.bool,))
    _rows(n_build, "expand_probe")
    if not 1 <= k < 2 ** 16:
        raise ValueError(f"expansion width {k} is out of range")
    lib = build()
    rows = torch.empty(n_probe * k, dtype=torch.int32, device=device)
    counts = torch.empty(n_probe, dtype=torch.int32, device=device)
    overflow = torch.zeros((), dtype=torch.int32, device=device)
    if n_probe == 0:
        return rows, counts, overflow != 0
    err = lib.qs_expand_probe(
        _ptr(sorted_key), _ptr(order), n_build, _ptr(probe), _ptr(alive),
        n_probe, k, _ptr(rows), _ptr(counts), _ptr(overflow),
        _blocks(n_probe, device), _stream(device))
    _check(lib, err, "expand_probe")
    LAUNCHES["expand_probe"] += 1
    return rows, counts, overflow != 0


CMP_OPS = {"<>": 0, "<": 1, "<=": 2, ">": 3, ">=": 4}


def run_stats_probe(sorted_key: torch.Tensor, order: torch.Tensor,
                    bval: torch.Tensor, probe: torch.Tensor,
                    pmask: torch.Tensor, pval: Optional[torch.Tensor] = None,
                    op: Optional[str] = None):
    """K8: the min and max of the int32 build values bval over each run of
    equal live build keys (sorted_key and order as for expand_probe; bval in
    the build's own row order), read by every probe row at its key. With op
    (one of <>, <, <=, >, >=) and the probe's int32 pval: the bool matched
    = pmask & (a live build row has the key) & (pval OP the run's min or
    max, as ops/join.py merge_cmp_probe decides). Without op: (matched,
    int32 min, int32 max), with (INT32_MAX, INT32_MIN) where the key has no
    live build row."""
    device = _cuda_device(pmask, "pmask")
    n_build = int(sorted_key.shape[0]) if sorted_key.dim() == 1 else -1
    n_probe = int(pmask.shape[0]) if pmask.dim() == 1 else -1
    _require(sorted_key, "sorted_key", device, n_build, (torch.int64,))
    _require(order, "order", device, n_build, (torch.int64,))
    _require(bval, "bval", device, n_build, (torch.int32,))
    _require(probe, "probe", device, n_probe, (torch.int64,))
    _require(pmask, "pmask", device, n_probe, (torch.bool,))
    if op is not None:
        if op not in CMP_OPS:
            raise ValueError(f"unknown comparison {op!r}")
        if pval is None:
            raise ValueError(f"comparison {op} needs probe values")
        _require(pval, "pval", device, n_probe, (torch.int32,))
    _rows(n_build, "run_stats_probe")
    lib = build()
    run_min = torch.empty(n_build, dtype=torch.int32, device=device)
    run_max = torch.empty(n_build, dtype=torch.int32, device=device)
    matched = torch.empty(n_probe, dtype=torch.bool, device=device)
    out_min = out_max = None
    if op is None:
        out_min = torch.empty(n_probe, dtype=torch.int32, device=device)
        out_max = torch.empty(n_probe, dtype=torch.int32, device=device)
    if n_build or n_probe:
        err = lib.qs_run_stats_probe(
            _ptr(sorted_key), _ptr(order), n_build, _ptr(bval), _ptr(run_min),
            _ptr(run_max), _ptr(probe), _ptr(pmask), _ptr(pval), n_probe,
            -1 if op is None else CMP_OPS[op], _ptr(matched), _ptr(out_min),
            _ptr(out_max), _blocks(n_build, device), _blocks(n_probe, device),
            _stream(device))
        _check(lib, err, "run_stats_probe")
        LAUNCHES["merge_cmp_probe"] += 1
    if op is None:
        return matched, out_min, out_max
    return matched


_TILE = 256 * 16                # kTile in csrc/compact_kernels.cu


def stable_partition(mask: torch.Tensor) -> torch.Tensor:
    """K9: the int64 permutation that puts the positions of the live rows
    first and the dead rows after them, each in order; equal to
    torch.argsort(~mask, stable=True)."""
    device = _cuda_device(mask, "mask")
    n = int(mask.shape[0]) if mask.dim() == 1 else -1
    _require(mask, "mask", device, n, (torch.bool,))
    lib = build()
    out = torch.empty(n, dtype=torch.int64, device=device)
    if n == 0:
        return out
    ntiles = (n + _TILE - 1) // _TILE
    tile_counts = torch.empty(ntiles, dtype=torch.int32, device=device)
    tile_offsets = torch.empty(ntiles + 1, dtype=torch.int64, device=device)
    err = lib.qs_stable_partition(_ptr(mask), n, _ptr(tile_counts),
                                  _ptr(tile_offsets), _ptr(out),
                                  _stream(device))
    _check(lib, err, "stable_partition")
    LAUNCHES["sort_groupby_compact"] += 1
    return out


# ---------------------------------------------------------------------
# W1-W4: the window kernels (csrc/window_kernels.cu)
# ---------------------------------------------------------------------
_WIN_TILE = 256 * 16            # kTile in csrc/window_kernels.cu
_WIN_SPAN = 1024                # kSpan in csrc/window_kernels.cu


def _flags(device, n: int, **flags) -> None:
    for name, t in flags.items():
        _require(t, name, device, n, (torch.bool,))


def window_prefix(fn: str, vals: Optional[torch.Tensor], live: torch.Tensor,
                  seg_start: torch.Tensor, peer_start: torch.Tensor):
    """W1: over rows sorted by (segment, order keys), each row's inclusive
    fn in {sum, min, max} of vals and count of live rows within its segment,
    read at the last row of its peer group (peer_start marks the first row
    of each; peer groups never cross a segment start). vals holds each row's
    contribution (0, or the MIN/MAX sentinel, at dead and NULL rows) and may
    be None for fn == count. Returns (values in vals' dtype or None, int64
    counts)."""
    if fn not in _FN:
        raise ValueError(f"unknown aggregate {fn!r}")
    device = _cuda_device(live, "live")
    n = int(live.shape[0]) if live.dim() == 1 else -1
    _flags(device, n, live=live, seg_start=seg_start, peer_start=peer_start)
    if fn != "count":
        if vals is None:
            raise ValueError(f"{fn} needs values")
        _require(vals, "vals", device, n, tuple(_DTYPE))
    _rows(n, "window_prefix")
    lib = build()
    ntiles = -(-n // _WIN_TILE)
    out_val = None if fn == "count" else torch.empty(n, dtype=vals.dtype,
                                                     device=device)
    out_cnt = torch.empty(n, dtype=torch.int64, device=device)
    if n == 0:
        return out_val, out_cnt

    # tile_f, tile_v, tile_c, tile_peer, carry_v, carry_c, next_peer (the
    # 8-byte ones hold any value type), then peer_last
    scratch = [torch.empty(m, dtype=dt, device=device) for dt, m in (
        (torch.int32, ntiles), (torch.int64, ntiles), (torch.int64, ntiles),
        (torch.int32, ntiles), (torch.int64, ntiles), (torch.int64, ntiles),
        (torch.int32, ntiles), (torch.int32, n))]
    err = lib.qs_window_prefix(
        _FN[fn], _DTYPE[vals.dtype] if fn != "count" else 0,
        _ptr(vals if fn != "count" else None), _ptr(live), _ptr(seg_start),
        _ptr(peer_start), n, *[_ptr(t) for t in scratch], _ptr(out_val),
        _ptr(out_cnt), _stream(device))
    _check(lib, err, "window_prefix")
    LAUNCHES["window_prefix"] += 1
    return out_val, out_cnt


_FRAME_MODE = {"rows": 0, "range": 1}


def frame_bounds(seg_start: torch.Tensor, mode: str, start: Optional[int],
                 end: Optional[int], keys: Optional[torch.Tensor] = None):
    """W3: each sorted row's frame [lo, hi] (int32 row indices) inside its
    segment (seg_start marks each segment's first row). ROWS: lo = max(first
    row, i - start), hi = min(last row, i + end). RANGE: lo is the first row
    of the segment whose key is >= key[i] - start, hi the last whose key is
    <= key[i] + end (keys sorted within each segment). start / end None is
    UNBOUNDED; hi = lo - 1 where the frame is empty."""
    if mode not in _FRAME_MODE:
        raise ValueError(f"unknown frame mode {mode!r}")
    device = _cuda_device(seg_start, "seg_start")
    n = int(seg_start.shape[0]) if seg_start.dim() == 1 else -1
    _flags(device, n, seg_start=seg_start)
    if mode == "range":
        if keys is None:
            raise ValueError("a RANGE frame needs its order key")
        _require(keys, "keys", device, n, tuple(_DTYPE))
    _rows(n, "frame_bounds")
    lib = build()
    lo = torch.empty(n, dtype=torch.int32, device=device)
    hi = torch.empty(n, dtype=torch.int32, device=device)
    if n == 0:
        return lo, hi
    ntiles = max(1, -(-n // _WIN_TILE))
    scratch = [torch.empty(ntiles, dtype=torch.int32, device=device)
               for _ in range(4)]
    err = lib.qs_frame_bounds(
        _FRAME_MODE[mode], _DTYPE[keys.dtype] if mode == "range" else 0,
        _ptr(seg_start), _ptr(keys if mode == "range" else None), n,
        0 if start is None else int(start), 0 if end is None else int(end),
        int(start is None), int(end is None), *[_ptr(t) for t in scratch],
        _ptr(lo), _ptr(hi), _stream(device))
    _check(lib, err, "frame_bounds")
    LAUNCHES["frame_bounds"] += 1
    return lo, hi


def frame_minmax(fn: str, c: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor) -> torch.Tensor:
    """W2: for each row i the MIN (fn == min) or MAX of c over rows
    [lo[i], hi[i]], and the sentinel (the dtype's max for MIN, its min for
    MAX) where hi < lo. c holds the sentinel at dead and NULL rows."""
    if fn not in ("min", "max"):
        raise ValueError(f"frame_minmax takes min or max, not {fn!r}")
    device = _cuda_device(c, "c")
    n = int(c.shape[0]) if c.dim() == 1 else -1
    _require(c, "c", device, n, tuple(_DTYPE))
    _require(lo, "lo", device, n, (torch.int32,))
    _require(hi, "hi", device, n, (torch.int32,))
    _rows(n, "frame_minmax")
    lib = build()
    out = torch.empty(n, dtype=c.dtype, device=device)
    if n == 0:
        return out
    ntiles = -(-n // _WIN_SPAN)
    levels = ntiles.bit_length()
    table = torch.empty(levels * ntiles, dtype=c.dtype, device=device)
    err = lib.qs_frame_minmax(_FN[fn], _DTYPE[c.dtype], _ptr(c), _ptr(lo),
                              _ptr(hi), n, _ptr(table), ntiles, levels,
                              _ptr(out), _stream(device))
    _check(lib, err, "frame_minmax")
    LAUNCHES["frame_minmax"] += 1
    return out


def sliding_sum(c: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                is_start: torch.Tensor) -> torch.Tensor:
    """W4: each row's float sum of c over [lo, hi], in c's own dtype, slid
    over each segment (is_start marks its first row) in the reference's
    order: equal bit for bit to quickstep_tpu/ops/window.py:273."""
    device = _cuda_device(c, "c")
    n = int(c.shape[0]) if c.dim() == 1 else -1
    _require(c, "c", device, n, (torch.float32, torch.float64))
    _require(lo, "lo", device, n, (torch.int32,))
    _require(hi, "hi", device, n, (torch.int32,))
    _flags(device, n, is_start=is_start)
    _rows(n, "sliding_sum")
    lib = build()
    out = torch.empty(n, dtype=c.dtype, device=device)
    if n == 0:
        return out
    err = lib.qs_sliding_sum(_DTYPE[c.dtype], _ptr(c), _ptr(lo), _ptr(hi),
                             _ptr(is_start), n, _ptr(out), _stream(device))
    _check(lib, err, "sliding_sum")
    LAUNCHES["sliding_sum"] += 1
    return out
