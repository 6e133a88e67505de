"""Build, load and call the hand-written CUDA kernels (csrc/*.cu).

The sources are compiled at first use with nvcc for sm_90a, one nvcc process
per source, all started together, and linked into one shared library with a
plain C interface (build/kernels/libqstorch_kernels.so at the root of the
checkout), which is loaded with ctypes. The library is rebuilt whenever a
hash of the sources and flags changes. Nothing is compiled or loaded when
this module is imported.

Every wrapper checks device, dtype, shape and contiguity (its tensors on the
calling thread's current device: _stream), allocates the kernel's outputs
and scratch with torch, launches on torch's current CUDA stream, raises
when the launch reports an error, and adds one to its entry in LAUNCHES
(and in its thread's THREAD_LAUNCHES, under a lock) for each kernel launch
it makes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

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
# merge_cmp_probe (one call of its compare or stats mode: the build's sort,
# its run statistics and the probe), K9 sort_groupby_compact (the
# stable live-first partition), the window kernels (W1 window_prefix, W2
# frame_minmax, W3 frame_bounds, W4 sliding_sum), K10 hash_keys, K11
# open_addressing (its build and probe), K12 distinct_count (the run starts,
# counted or flagged), K13 order_permutation (one call: the whole chain of
# key-value sorts), and
# the mesh path's K14 partition_dest (the radix partition), K15
# scatter_compact (the bucket scatter: its generic route and the shuffle's
# bucket_rows) and K16 bloom_filter (its build and
# probe). K6's two routes count apart: multi_gather is the direct route,
# multi_gather_packed the row-packed one; and K12's radix sort counts as
# distinct_sort. K8 and K13 run the key-value radix sort inside their one
# call; kv_sort runs that sort alone (for the card tests and benchmarks)
# and counts nothing. A wrapper given an empty input launches nothing and
# returns the empty or neutral result of its plain version.
LAUNCHES = {"scalar_agg": 0, "dense_groupby": 0, "direct_join": 0,
            "merge_unique_probe": 0, "sort_groupby": 0, "multi_gather": 0,
            "multi_gather_packed": 0, "expand_probe": 0,
            "merge_cmp_probe": 0, "sort_groupby_compact": 0,
            "window_prefix": 0, "frame_minmax": 0, "frame_bounds": 0,
            "sliding_sum": 0, "hash_keys": 0, "open_addressing": 0,
            "distinct_sort": 0, "distinct_count": 0,
            "order_permutation": 0, "partition_dest": 0,
            "scatter_compact": 0, "bloom_filter": 0}
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
# LAUNCHES again, by the thread that launched: a member of a mesh over
# members launches from its own thread
THREAD_LAUNCHES: Dict[threading.Thread, Dict[str, int]] = {}
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        THREAD_LAUNCHES.clear()


def _launched(name: str) -> None:
    """One launch of kernel `name`, in LAUNCHES and in the calling thread's
    THREAD_LAUNCHES (threads launch at once: counted under a lock)."""
    with _count_lock:
        LAUNCHES[name] += 1
        mine = THREAD_LAUNCHES.setdefault(threading.current_thread(),
                                          dict.fromkeys(LAUNCHES, 0))
        mine[name] += 1


def launches_of(thread: threading.Thread) -> Dict[str, int]:
    """The launches made from `thread` since reset_launches."""
    with _count_lock:
        return dict(THREAD_LAUNCHES.get(thread, dict.fromkeys(LAUNCHES, 0)))


def _nvcc() -> str:
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _source_hash(sources) -> str:
    """A hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in [*sources, *sorted(CSRC.glob("*.cuh"))]:
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
        u64, u32 = ctypes.c_uint64, ctypes.c_uint
        signatures = {
            "qs_masked_reduce": [i32, i32, p, p, p, i64, p, p, i32, p, p, p],
            "qs_dense_aggregate": [p, i32, i32, i32, p],
            "qs_segment_reduce": [i32, i32, p, p, p, i64, p, p, p, p, p, p],
            "qs_direct_build": [i32, i32, p, p, i64, i64, i64, p, p, p, i32,
                                p],
            "qs_direct_probe": [i32, i32, p, p, i64, i64, i64, p, p, p, p,
                                i32, p],
            "qs_sorted_probe": [p, p, i64, p, p, i64, p, p, i32, p, p, p, i32,
                                i32, p],
            "qs_multi_gather": [i32, p, p, p, i64, p, i32, i64, i32, p],
            "qs_packed_gather": [i32, p, p, p, p, i32, i64, p, p, i32, i64,
                                 i32, p],
            "qs_expand_probe": [p, p, i64, p, p, i64, i32, p, p, i32, p, p,
                                p, i32, i32, p],
            "qs_run_stats_probe": [p, p, p, i64, p, p, p, i64, i32, p, p, p,
                                   p, p, p, p, p, p, p, i32, i32, i32, i32,
                                   p],
            "qs_stable_partition": [p, i64, i64, p, p, p, i32, p],
            "qs_window_prefix": [i32, i32, i32, p, p, p, p, i64, p, p, p, p],
            "qs_frame_bounds": [i32, i32, p, p, i64, i64, i64, i32, i32,
                                p, p, p, p],
            "qs_frame_minmax": [i32, i32, p, p, p, i64, p, p, i64, i32, p,
                                p],
            "qs_sliding_sum": [i32, p, p, p, p, i64, p, p, p],
            "qs_add_chain": [i32, p, i64, p, p],
            "qs_hash_keys": [i32, p, p, i64, p, i32, p],
            "qs_oa_build": [i32, p, p, p, i64, p, i64, p, i32, p],
            "qs_oa_probe": [p, i64, i32, p, p, p, p, i64, p, p, i32, p],
            "qs_oa_word_build": [i32, p, p, p, i64, p, i64, p, p, i32, p],
            "qs_oa_word_probe": [p, i64, p, i32, p, p, p, i64, p, p, i32,
                                 p],
            "qs_run_starts": [i32, p, i64, p, p, p, i32, p],
            "qs_radix_sort_live": [i32, p, p, p, i64, p, p, p, p, i32, i32,
                                   p],
            "qs_kv_sort": [i32, p, p, i64, p, p, p, p, p, i32, i32, p],
            "qs_order_permutation": [i32, p, p, p, p, p, p, i64, p, p, p, p,
                                     p, i32, i32, p],
            "qs_partition_sweep": [p, i32, p, i32, i32, u64, u32, u32, u64,
                                   i64, i32, p, p, p, p, u64, u32, p],
            "qs_partition_count": [p, i32, p, i32, i32, u64, u32, u32, u64,
                                   i64, i32, p, p],
            "qs_partition_dest": [p, i32, p, i32, i32, u64, u32, u32, u64,
                                  i64, i32, p, i32, p, p, p, p],
            "qs_bucket_rows": [p, i64, i32, u32, u64, i32, i32, u64, p, p,
                               p, i32, p],
            "qs_scatter_compact": [i32, p, p, i32, i64, i64, u64, p, i32,
                                   p],
            "qs_bloom_build": [i32, p, p, p, i64, p, i64, i32, p],
            "qs_bloom_probe": [i32, p, p, p, i64, p, i64, p, i32, p],
        }
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = i32
        for name in ("qs_radix_scratch_words", "qs_kv_scratch_words",
                     "qs_run_stats_carry_words"):
            getattr(lib, name).argtypes = [i64]
            getattr(lib, name).restype = i64
        lib.qs_span_words.argtypes = []
        lib.qs_span_words.restype = i64
        lib.qs_dense_args_bytes.argtypes = []
        lib.qs_dense_args_bytes.restype = i64
        lib.qs_dense_blocks_per_sm.argtypes = [i32, i32]
        lib.qs_dense_blocks_per_sm.restype = i32
        if lib.qs_dense_args_bytes() != ctypes.sizeof(_DenseArgs):
            raise RuntimeError("_DenseArgs does not match the kernel's "
                               "DenseArgs")
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


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _blocks(n: int, device: torch.device) -> int:
    return max(1, min((n + _THREADS - 1) // _THREADS,
                      _BLOCKS_PER_SM * _sms(device)))


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


def _neutral(fn: str, dtype: torch.dtype):
    """fn's result over no rows, as the plain versions give it."""
    from quickstep_tpu_torch.ops.kernels import max_sentinel, min_sentinel
    if fn == "min":
        return max_sentinel(dtype)
    if fn == "max":
        return min_sentinel(dtype)
    return 0


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
    if n == 0:
        out_cnt = torch.zeros((), dtype=torch.int64, device=device)
        if fn == "count":
            return out_cnt, out_cnt
        return torch.full((), _neutral(fn, dtype), dtype=out_dt,
                          device=device), out_cnt
    blocks = _blocks(n, device)
    part_val = torch.empty(blocks, dtype=acc_dt, device=device)
    part_cnt = torch.empty(blocks, dtype=torch.int64, device=device)
    out_val = torch.empty((), dtype=out_dt, device=device)
    out_cnt = torch.empty((), dtype=torch.int64, device=device)
    stream = _stream(device)
    err = lib.qs_masked_reduce(
        _FN[fn], _DTYPE[dtype], _ptr(vals if fn != "count" else None),
        _ptr(valid), _ptr(alive), n, _ptr(part_val), _ptr(part_cnt), blocks,
        _ptr(out_val), _ptr(out_cnt), stream)
    _check(lib, err, "masked_reduce")
    _launched("scalar_agg")
    if fn == "count":
        return out_cnt, out_cnt
    return out_val, out_cnt


# K2's limits (csrc/agg_kernels.cu kMaxKeys, kMaxAccs, kMaxCounts): key
# columns, accumulators and non-null counts a launch
MAX_DENSE_KEYS = 8
DENSE_ACCS = 8
DENSE_COUNTS = DENSE_ACCS + 1
_DENSE_ROWS = 8                 # kDenseRows: rows a thread a tile
_KEY_TYPES = {torch.bool: 0, torch.uint8: 0, torch.int8: 1, torch.int16: 2,
              torch.int32: 3, torch.int64: 4}


class _DenseKey(ctypes.Structure):
    _fields_ = [("col", ctypes.c_void_p), ("offset", ctypes.c_int64),
                ("stride", ctypes.c_int64), ("type", ctypes.c_int)]


class _DenseAcc(ctypes.Structure):
    _fields_ = [("vals", ctypes.c_void_p), ("valid", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("init", ctypes.c_int64),
                ("kind", ctypes.c_int), ("type", ctypes.c_int),
                ("out_type", ctypes.c_int)]


class _DenseArgs(ctypes.Structure):
    """csrc/agg_kernels.cu DenseArgs, field for field."""
    _fields_ = [("keys", _DenseKey * MAX_DENSE_KEYS),
                ("accs", _DenseAcc * DENSE_ACCS),
                ("valids", ctypes.c_void_p * DENSE_COUNTS),
                ("counts", ctypes.c_void_p * DENSE_COUNTS),
                ("occupied", ctypes.c_void_p), ("alive", ctypes.c_void_p),
                ("part_acc", ctypes.c_void_p), ("part_cnt", ctypes.c_void_p),
                ("n", ctypes.c_int64), ("domain", ctypes.c_int),
                ("n_keys", ctypes.c_int), ("n_accs", ctypes.c_int),
                ("n_counts", ctypes.c_int)]


# K2 takes its lane path (a table for each thread) where the block's
# tables take at most this many bytes of shared memory, else one table a
# warp
DENSE_LANE_BYTES = 80 * 1024


def dense_smem_bytes(domain: int, n_accs: int,
                     n_counts: int) -> Tuple[bool, int]:
    """(whether K2 takes its lane path, its shared memory a block): the
    tables of 8-byte accumulators and 4-byte counts of each of its 256
    threads where they fit in DENSE_LANE_BYTES, else of each of its 8
    warps."""
    per_owner = domain * (8 * n_accs + 4 * n_counts)
    lane = _THREADS * per_owner <= DENSE_LANE_BYTES
    return lane, (_THREADS if lane else 8) * per_owner


_dense_per_sm = {}


def dense_grid(n: int, domain: int, n_accs: int, n_counts: int,
               device: torch.device) -> Tuple[bool, int, int]:
    """(lane path, shared memory a block, blocks) of one K2 launch: as many
    blocks as fit on the card at once (the kernel's occupancy), fewer where
    the rows do not fill them."""
    lane, smem = dense_smem_bytes(domain, n_accs, n_counts)
    key = (lane, smem)
    if key not in _dense_per_sm:
        per_sm = build().qs_dense_blocks_per_sm(int(lane), smem)
        if per_sm < 1:
            raise RuntimeError(f"dense_aggregate: no block of {smem} bytes "
                               "of shared memory fits an SM")
        _dense_per_sm[key] = per_sm
    return lane, smem, max(1, min(-(-n // (_THREADS * _DENSE_ROWS)),
                                  _dense_per_sm[key] * _sms(device)))


def _acc_kind(fn: str, dtype: torch.dtype) -> int:
    """csrc/agg_kernels.cu AccKind of (fn, the values' dtype)."""
    flt = dtype.is_floating_point
    return {"sum": 1 if flt else 0, "min": 4 if flt else 2,
            "max": 5 if flt else 3}[fn]


def _acc_init(fn: str, dtype: torch.dtype) -> int:
    """The bits of fn's identity as its accumulator holds it: an int64, or
    a float64's bits."""
    v = _neutral(fn, dtype)
    if dtype.is_floating_point:
        return struct.unpack("<q", struct.pack("<d", float(v)))[0]
    return int(v)


def dense_aggregate(key_cols: List[torch.Tensor], key_offsets: List[int],
                    key_strides: List[int], domain: int, specs,
                    alive: torch.Tensor):
    """K2: one dense GROUP BY. Each row's group is the sum over the key
    columns of (key - offset) * stride in int64; a row is kept where alive
    and 0 <= group < domain. specs are (fn in {sum, count, min, max},
    vals, valid). Returns (occupied bool [domain], [(fn's result [domain],
    live non-null count int32 [domain]) for each spec]); for fn == count
    the result is the count itself. Specs over the same (fn, vals, valid)
    tensors share one accumulator, and each distinct validity one count.
    One launch (its row pass, then the fold of the blocks' partials) takes
    up to DENSE_ACCS accumulators and DENSE_COUNTS - 1 validities; more
    are split over several launches, each counted."""
    if not 1 <= domain <= MAX_DOMAIN:
        raise ValueError(f"dense group-by domain {domain} is outside "
                         f"[1, {MAX_DOMAIN}]")
    if not 1 <= len(key_cols) <= MAX_DENSE_KEYS:
        raise ValueError(f"dense group-by of {len(key_cols)} key columns: "
                         f"the kernel takes 1 to {MAX_DENSE_KEYS}")
    device = _cuda_device(alive, "alive")
    n = int(alive.shape[0]) if alive.dim() == 1 else -1
    _require(alive, "alive", device, n, (torch.bool,))
    for k in key_cols:
        _require(k, "key", device, n, tuple(_KEY_TYPES))
    for fn, vals, valid in specs:
        if fn not in _FN:
            raise ValueError(f"unknown aggregate {fn!r}")
        _require(valid, "valid", device, n, (torch.bool,))
        if fn != "count":
            if vals is None:
                raise ValueError(f"{fn} needs values")
            _require(vals, "vals", device, n, tuple(_DTYPE))
    if n >= 2 ** 31:
        raise ValueError(f"{n} rows overflow the int32 group counts")
    lib = build()
    plan = dense_plan(specs)
    valids, accs = plan.valids, plan.accs
    if n == 0:
        counts = [torch.zeros(domain, dtype=torch.int32, device=device)
                  for _ in valids]
        occupied = torch.zeros(domain, dtype=torch.bool, device=device)
        outs = [torch.full((domain,), _neutral(fn, v.dtype),
                           dtype=_acc_out_dtypes(fn, v.dtype)[1],
                           device=device) for fn, v, _ in accs]
    else:
        counts = [torch.empty(domain, dtype=torch.int32, device=device)
                  for _ in valids]
        occupied = torch.empty(domain, dtype=torch.bool, device=device)
        outs = [torch.empty(domain, dtype=_acc_out_dtypes(fn, v.dtype)[1],
                            device=device) for fn, v, _ in accs]
        _dense_launches(lib, key_cols, key_offsets, key_strides, domain,
                        alive, n, plan, outs, counts, occupied)
    results = [(counts[c] if a is None else outs[a], counts[c])
               for a, c in plan.slots]
    return occupied, results


class DensePlan(NamedTuple):
    """How K2 computes a list of specs: the distinct validities (None, the
    kept rows, first) and the distinct (fn, vals, valid) accumulators; for
    each spec its accumulator (None for a count) and its count; for each
    launch its accumulators (at most DENSE_ACCS) and its counts (the kept
    rows' and at most DENSE_COUNTS - 1 validities)."""
    valids: list
    accs: list
    slots: List[Tuple[Optional[int], int]]
    launches: List[Tuple[List[int], List[int]]]


def dense_plan(specs) -> DensePlan:
    """K2's plan of specs (fn, vals, valid): tensors are told apart by
    identity, so specs over the same tensors share their work."""
    valids, vslot, accs, aslot, slots = [None], {None: 0}, [], {}, []
    for fn, vals, valid in specs:
        vk = None if valid is None else id(valid)
        if vk not in vslot:
            vslot[vk] = len(valids)
            valids.append(valid)
        if fn == "count":
            slots.append((None, vslot[vk]))
            continue
        ak = (fn, id(vals), vk)
        if ak not in aslot:
            aslot[ak] = len(accs)
            accs.append((fn, vals, valid))
        slots.append((aslot[ak], vslot[vk]))
    rest = list(range(1, len(valids)))
    per = DENSE_COUNTS - 1
    n_launches = max(-(-len(accs) // DENSE_ACCS), -(-len(rest) // per), 1)
    launches = [(list(range(i * DENSE_ACCS,
                            min(len(accs), (i + 1) * DENSE_ACCS))),
                 [0] + rest[i * per:(i + 1) * per])
                for i in range(n_launches)]
    return DensePlan(valids, accs, slots, launches)


def _dense_launches(lib, key_cols, key_offsets, key_strides, domain, alive,
                    n, plan: DensePlan, outs, counts, occupied) -> None:
    """K2's launches, as the plan cuts them; every launch also counts the
    kept rows (into counts[0] and occupied, the same values each time)."""
    device = alive.device
    accs, valids = plan.accs, plan.valids
    args = _DenseArgs()
    for i, (k, off, stride) in enumerate(zip(key_cols, key_offsets,
                                             key_strides)):
        args.keys[i] = _DenseKey(k.data_ptr(), int(off), int(stride),
                                 _KEY_TYPES[k.dtype])
    args.n_keys = len(key_cols)
    args.alive = alive.data_ptr()
    args.occupied = occupied.data_ptr()
    args.n = n
    args.domain = domain
    stream = _stream(device)
    for chunk, slots in plan.launches:
        for j, a in enumerate(chunk):
            fn, vals, valid = accs[a]
            args.accs[j] = _DenseAcc(
                vals.data_ptr(), _ptr(valid), outs[a].data_ptr(),
                _acc_init(fn, vals.dtype), _acc_kind(fn, vals.dtype),
                _DTYPE[vals.dtype], _DTYPE[outs[a].dtype])
        for j, c in enumerate(slots):
            args.valids[j] = _ptr(valids[c])
            args.counts[j] = counts[c].data_ptr()
        args.n_accs, args.n_counts = len(chunk), len(slots)
        lane, smem, blocks = dense_grid(n, domain, len(chunk), len(slots),
                                        device)
        part_acc = torch.empty(blocks * len(chunk) * domain,
                               dtype=torch.int64, device=device)
        part_cnt = torch.empty(blocks * len(slots) * domain,
                               dtype=torch.int32, device=device)
        args.part_acc = part_acc.data_ptr()
        args.part_cnt = part_cnt.data_ptr()
        err = lib.qs_dense_aggregate(ctypes.byref(args), blocks, smem,
                                     int(lane), stream)
        _check(lib, err, "dense_aggregate")
        _launched("dense_groupby")


def _cuda_device(t: torch.Tensor, name: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}: the kernel needs CUDA")
    return t.device


def _stream(device: torch.device) -> int:
    """The current stream of `device`, on which a kernel for tensors there
    launches. The kernels launch on the CUDA runtime's current device (and
    some read its SM count), so a tensor on another card raises: a member
    of a mesh over cards launches only on its own (torch.cuda.set_device
    on its thread)."""
    here = torch.cuda.current_device()
    if device.index is not None and device.index != here:
        raise ValueError(f"a kernel's tensors are on {device} while this "
                         f"thread's current device is cuda:{here}: set the "
                         "device first (torch.cuda.set_device)")
    return torch.cuda.current_stream(device).cuda_stream


def _rows(n: int, what: str) -> None:
    if n >= 2 ** 31:
        raise ValueError(f"{what}: {n} rows overflow the kernel's int32 row ids")


# K5's tile (kSegTile in csrc/agg_kernels.cu): each block reduces this many
# sorted rows and leaves one carry; a one-block launch combines the carries.
SEGMENT_TILE = 256 * 8


def segment_scratch_words(n: int) -> int:
    """int64 words of K5's scratch: five a tile (the carry's value and
    count, the fix row's value and count, two int32 flags)."""
    return 5 * -(-n // SEGMENT_TILE)


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """t, or a fresh copy of it where its data does not start on 16 bytes
    (the kernel reads it by 16-byte vector loads)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def segment_reduce(fn: str, change: torch.Tensor, s_alive: torch.Tensor,
                   perm: torch.Tensor, vals: Optional[torch.Tensor],
                   valid: Optional[torch.Tensor]):
    """K5: fn in {sum, count, min, max} over each group of key-sorted rows.
    Sorted row i is input row perm[i]; s_alive marks the live prefix and
    change the first row of each group. Returns (result [n], live non-null
    count int32 [n]), set at each group's last sorted row and 0 elsewhere;
    for fn == count the result is the count itself. Two launches: the tiles
    of SEGMENT_TILE rows, then their carries in tile order."""
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
    scratch = torch.empty(segment_scratch_words(n), dtype=torch.int64,
                          device=device)
    change, s_alive, perm = (_aligned16(t) for t in (change, s_alive, perm))
    err = lib.qs_segment_reduce(
        _FN[fn], _DTYPE[dtype], _ptr(change), _ptr(s_alive), _ptr(perm), n,
        _ptr(vals if fn != "count" else None), _ptr(valid), _ptr(out_val),
        _ptr(out_nn), _ptr(scratch), _stream(device))
    _check(lib, err, "segment_reduce")
    _launched("sort_groupby")
    return (out_nn if fn == "count" else out_val), out_nn


# K3's layouts (csrc/join_kernels.cu DirectMode) and the route between the
# first two: a row table of more than DIRECT_BITMAP_SLOTS slots does not sit
# in the L2 of an NVIDIA H100 (50 MB), so it carries a presence bitmap behind
# it that does, and the probe reads the table only where a bit is set.
DIRECT_TABLE, DIRECT_TABLE_BITS, DIRECT_BITS = 0, 1, 2
DIRECT_BITMAP_SLOTS = 1 << 22


def direct_route(domain: int) -> int:
    """DIRECT_TABLE_BITS for a row table of more than DIRECT_BITMAP_SLOTS
    slots, else DIRECT_TABLE."""
    return DIRECT_TABLE_BITS if domain > DIRECT_BITMAP_SLOTS else DIRECT_TABLE


def bitmap_words(domain: int) -> int:
    return -(-domain // 32)


def direct_build(key: torch.Tensor, alive: torch.Tensor, lo: int, domain: int,
                 presence: bool = False):
    """K3 build over the live rows with key - lo in [0, domain). Table mode:
    (int32 buffer, 0-d bool dup flag); the buffer's first `domain` entries
    are the row table (build row or -1), and past DIRECT_BITMAP_SLOTS slots
    the presence bitmap's bitmap_words(domain) words follow. Presence mode
    (the exact filter): (the int32 bitmap words, None)."""
    device = _cuda_device(alive, "alive")
    n = int(alive.shape[0]) if alive.dim() == 1 else -1
    _require(alive, "alive", device, n, (torch.bool,))
    _require(key, "key", device, n, tuple(_KEY))
    _rows(n, "direct_build")
    if not 1 <= domain < 2 ** 40:
        raise ValueError(f"direct-address domain {domain} is out of range")
    lib = build()
    words = bitmap_words(domain)
    mode = DIRECT_BITS if presence else direct_route(domain)
    if mode == DIRECT_BITS:
        buf = torch.zeros(words, dtype=torch.int32, device=device)
        table, bits = None, buf
    else:
        extra = words if mode == DIRECT_TABLE_BITS else 0
        buf = torch.empty(domain + extra, dtype=torch.int32, device=device)
        table = buf[:domain].fill_(-1)
        bits = buf[domain:].zero_() if extra else None
    dup = torch.zeros((), dtype=torch.int32, device=device)
    if n == 0:
        return buf, (None if presence else dup != 0)
    err = lib.qs_direct_build(
        _KEY[key.dtype], mode, _ptr(key), _ptr(alive), n, int(lo),
        int(domain), _ptr(table), _ptr(bits), _ptr(dup), _blocks(n, device),
        _stream(device))
    _check(lib, err, "direct_build")
    _launched("direct_join")
    return buf, (None if presence else dup != 0)


def direct_probe(table: torch.Tensor, key: torch.Tensor, alive: torch.Tensor,
                 lo: int, domain: Optional[int] = None,
                 presence: bool = False):
    """K3 probe of direct_build's buffer. Table mode (domain given): (int32
    build row or -1, bool matched). Presence mode (the bitmap words):
    bool matched."""
    device = _cuda_device(alive, "alive")
    n = int(alive.shape[0]) if alive.dim() == 1 else -1
    _require(alive, "alive", device, n, (torch.bool,))
    _require(key, "key", device, n, tuple(_KEY))
    size = int(table.shape[0]) if table.dim() == 1 else -1
    _require(table, "table", device, size, (torch.int32,))
    if presence:
        # no bit past the build's domain is set
        mode, domain = DIRECT_BITS, 32 * size
    else:
        if domain is None or size not in (domain, domain + bitmap_words(domain)):
            raise ValueError(f"a table of {size} entries is no direct table "
                             f"of domain {domain}")
        mode = DIRECT_TABLE if size == domain else DIRECT_TABLE_BITS
    lib = build()
    matched = torch.empty(n, dtype=torch.bool, device=device)
    bidx = None if presence else torch.empty(n, dtype=torch.int32,
                                             device=device)
    if n == 0:
        return matched if presence else (bidx, matched)
    bits = table if presence else (
        table[domain:] if mode == DIRECT_TABLE_BITS else None)
    err = lib.qs_direct_probe(
        _KEY[key.dtype], mode, _ptr(key), _ptr(alive), n, int(lo),
        int(domain), None if presence else _ptr(table), _ptr(bits),
        _ptr(bidx), _ptr(matched), _blocks(-(-n // 4), device),
        _stream(device))
    _check(lib, err, "direct_probe")
    _launched("direct_join")
    return matched if presence else (bidx, matched)


def sorted_probe(sorted_key: torch.Tensor, order: torch.Tensor,
                 probe: torch.Tensor, pmask: torch.Tensor):
    """K4: for each live probe row, the first build row (in the stable sort
    order) with an equal key. sorted_key holds the build keys sorted, dead
    rows as INT64_MAX; order is the sort permutation. Returns (int32 build
    row or -1, bool matched, 0-d bool dup flag: two equal live build keys).
    One call copies the keys and rows, builds K7's fence over them and
    sets the dup flag, then searches the fence for the probe rows (with no
    probe rows only the first launch runs)."""
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
    if n_build == 0:
        return bidx.fill_(-1), matched.fill_(False), dup != 0
    sizes = fence_layout(n_build)
    scratch = torch.empty(fence_scratch_words(n_build), dtype=torch.int64,
                          device=device)
    c_sizes = (ctypes.c_int64 * len(sizes))(*sizes)
    err = lib.qs_sorted_probe(
        _ptr(sorted_key), _ptr(order), n_build, _ptr(probe), _ptr(pmask),
        n_probe, _ptr(scratch), ctypes.cast(c_sizes, ctypes.c_void_p),
        len(sizes), _ptr(bidx), _ptr(matched), _ptr(dup),
        _blocks(fence_keys(n_build), device),
        max(1, min(-(-n_probe // (FENCE_THREADS * UNIQUE_PROBE_ROWS)),
                   UNIQUE_PROBE_BLOCKS_PER_SM * _sms(device))),
        _stream(device))
    _check(lib, err, "sorted_probe")
    _launched("merge_unique_probe")
    return bidx, matched, dup != 0


# K6's cost model (gather_route): the two rates of an NVIDIA H100 80GB HBM3
# at a 700.00 W power limit, measured by python -m
# quickstep_tpu_torch.bench.gather_rates: bytes per second of a coalesced
# copy (read plus write), and 32-byte sectors per second of a one-column
# int64 gather by a uniformly random index over a 480 MB source.
COALESCED_BYTES_PER_S = 2.955e12
RANDOM_SECTORS_PER_S = 3.128e10
SECTOR_BYTES = 32
PACKED_ROW_BYTES = (16, 32, 64)  # kMaxRowBytes in csrc/gather_kernels.cu


def packed_layout(widths: List[int]):
    """(the byte offset of each column in a packed row, the row's bytes)
    of K6's row-packed route: the columns widest first, so that each field
    sits at a multiple of its width, the row rounded up to 16, 32 or 64
    bytes; None where the columns take more than 64 bytes."""
    offsets = [0] * len(widths)
    at = 0
    for i in sorted(range(len(widths)), key=lambda i: -widths[i]):
        offsets[i] = at
        at += widths[i]
    row = next((b for b in PACKED_ROW_BYTES if at <= b), None)
    return None if row is None else (offsets, row)


def gather_route(n_src: int, m: int, widths: List[int], random: bool) -> str:
    """'packed' or 'direct': K6's route for m rows of columns of these
    widths out of n_src rows. Only an index its caller calls random (a
    sort permutation) may take the packed route, and only where the cost
    model says packing the source (read and written once, coalesced) plus
    one random row of sectors per output row costs less than a random
    sector per output row and column. The index read and the output writes
    are the same on both routes and are left out."""
    layout = packed_layout(widths) if random and n_src and m else None
    if layout is None:
        return "direct"
    row = layout[1]
    direct = m * len(widths) / RANDOM_SECTORS_PER_S
    packed = n_src * (sum(widths) + row) / COALESCED_BYTES_PER_S + \
        m * -(-row // SECTOR_BYTES) / RANDOM_SECTORS_PER_S
    return "packed" if packed < direct else "direct"


def multi_gather(cols: List[torch.Tensor], idx: torch.Tensor,
                 random: bool = False):
    """K6: every column at rows idx (int32 or int64), MAX_GATHER_COLS
    columns per launch. Columns are 1-D, contiguous, of one length, with
    1-, 2-, 4- or 8-byte elements; an index outside the columns is
    clamped. random says the index is a permutation or random (not nearly
    ascending); gather_route then picks the direct or the row-packed route
    for each group of columns."""
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
    lib = build()
    if n_src == 0:
        # nothing to read: zeros, which the caller marks invalid
        return [torch.zeros(m, dtype=c.dtype, device=device) for c in cols]
    outs = [torch.empty(m, dtype=c.dtype, device=device) for c in cols]
    if m == 0:
        return outs
    for s in range(0, len(cols), MAX_GATHER_COLS):
        part = range(s, min(s + MAX_GATHER_COLS, len(cols)))
        k = len(part)
        widths = [cols[i].element_size() for i in part]
        srcs = (ctypes.c_void_p * k)(*[cols[i].data_ptr() for i in part])
        dsts = (ctypes.c_void_p * k)(*[outs[i].data_ptr() for i in part])
        c_widths = (ctypes.c_int * k)(*widths)
        head = (k, ctypes.cast(srcs, ctypes.c_void_p),
                ctypes.cast(dsts, ctypes.c_void_p),
                ctypes.cast(c_widths, ctypes.c_void_p))
        tail = (_ptr(idx), int(idx.dtype == torch.int64), m)
        if gather_route(n_src, m, widths, random) == "packed":
            offsets, row = packed_layout(widths)
            packed = torch.empty(n_src * row // 16, 2, dtype=torch.int64,
                                 device=device)
            c_offsets = (ctypes.c_int * k)(*offsets)
            err = lib.qs_packed_gather(
                *head, ctypes.cast(c_offsets, ctypes.c_void_p), row, n_src,
                _ptr(packed), *tail, _blocks(n_src, device), _stream(device))
            _check(lib, err, "multi_gather (packed)")
            _launched("multi_gather_packed")
        else:
            err = lib.qs_multi_gather(*head, n_src, *tail,
                                      _blocks(m, device), _stream(device))
            _check(lib, err, "multi_gather")
            _launched("multi_gather")
    return outs


# K7's fence (csrc/join_kernels.cu): every 4th sorted key, then every 4th
# key of the level below (each node and leaf one 32-byte sector), up to a
# top level of at most FENCE_TOP_KEYS keys, which each block of the probe
# stages in shared memory; the probe's blocks of FENCE_THREADS threads,
# FENCE_BLOCKS_PER_SM an SM.
FENCE_LEAF_KEYS, FENCE_FANOUT, FENCE_TOP_KEYS = 4, 4, 8192
FENCE_THREADS, FENCE_BLOCKS_PER_SM = 512, 3
# K4's probe over the same fence: four probe rows a thread, and blocks of
# FENCE_THREADS that its launch bounds let two share an SM
UNIQUE_PROBE_ROWS, UNIQUE_PROBE_BLOCKS_PER_SM = 4, 2


def fence_layout(n_build: int) -> List[int]:
    """The keys of each level of K7's fence over n_build >= 1 sorted keys,
    the finest level first."""
    sizes = [-(-n_build // FENCE_LEAF_KEYS)]
    while sizes[-1] > FENCE_TOP_KEYS:
        sizes.append(-(-sizes[-1] // FENCE_FANOUT))
    return sizes


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def fence_keys(n_build: int) -> int:
    """The keys K7 copies: n_build, padded with dead keys to a whole leaf
    and two leaves more."""
    return _up(n_build, FENCE_LEAF_KEYS) + 2 * FENCE_LEAF_KEYS


def fence_scratch_words(n_build: int) -> int:
    """int64 words of K7's scratch: the padded keys, as many int32 rows
    (rounded up to whole sectors), then each fence level padded to a whole
    node."""
    padded = fence_keys(n_build)
    return padded + _up(padded, 2 * FENCE_LEAF_KEYS) // 2 + sum(
        _up(s, FENCE_FANOUT) for s in fence_layout(n_build))


def expand_probe(sorted_key: torch.Tensor, order: torch.Tensor,
                 probe: torch.Tensor, alive: torch.Tensor, k: int):
    """K7: for each live probe row, the first k build rows (in the stable
    sort order) whose key equals the probe key. sorted_key holds the build
    keys sorted, dead rows as INT64_MAX; order is the sort permutation.
    Returns (int32 rows [n * k], row-major, -1 pads; int32 run length [n],
    0 on dead rows; 0-d bool overflow flag: some live run is longer than
    k). One call copies the keys and rows and builds their fence, then
    probes."""
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
    if n_probe == 0 or n_build == 0:
        return rows.fill_(-1), counts.zero_(), overflow != 0
    sizes = fence_layout(n_build)
    scratch = torch.empty(fence_scratch_words(n_build), dtype=torch.int64,
                          device=device)
    c_sizes = (ctypes.c_int64 * len(sizes))(*sizes)
    err = lib.qs_expand_probe(
        _ptr(sorted_key), _ptr(order), n_build, _ptr(probe), _ptr(alive),
        n_probe, k, _ptr(scratch), ctypes.cast(c_sizes, ctypes.c_void_p),
        len(sizes), _ptr(rows), _ptr(counts), _ptr(overflow),
        _blocks(fence_keys(n_build), device),
        max(1, min(-(-n_probe // FENCE_THREADS),
                   FENCE_BLOCKS_PER_SM * _sms(device))),
        _stream(device))
    _check(lib, err, "expand_probe")
    _launched("expand_probe")
    return rows, counts, overflow != 0


CMP_OPS = {"<>": 0, "<": 1, "<=": 2, ">": 3, ">=": 4}


def run_stats_probe(build_key: torch.Tensor, bmask: torch.Tensor,
                    bval: torch.Tensor, probe: torch.Tensor,
                    pmask: torch.Tensor, pval: Optional[torch.Tensor] = None,
                    op: Optional[str] = None):
    """K8: the min and max of the int32 build values bval over the live
    build rows of each int64 key (a key of INT64_MAX counts as dead), read
    by every probe row at its key. With op (one of <>, <, <=, >, >=) and the
    probe's int32 pval: the bool matched = pmask & (a live build row has the
    key) & (pval OP the run's min or max, as ops/join.py merge_cmp_probe
    decides). Without op: (matched, int32 min, int32 max), with (INT32_MAX,
    INT32_MIN) where the key has no live build row. One call: the build's
    range and key-value radix sort carrying bval, the run statistics in
    tiles, K4's fence over the sorted codes, and the probe."""
    device = _cuda_device(pmask, "pmask")
    n_build = int(build_key.shape[0]) if build_key.dim() == 1 else -1
    n_probe = int(pmask.shape[0]) if pmask.dim() == 1 else -1
    _require(build_key, "build_key", device, n_build, (torch.int64,))
    _require(bmask, "bmask", device, n_build, (torch.bool,))
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
    matched = torch.empty(n_probe, dtype=torch.bool, device=device)
    out_min = out_max = None
    if op is None:
        out_min = torch.empty(n_probe, dtype=torch.int32, device=device)
        out_max = torch.empty(n_probe, dtype=torch.int32, device=device)
    if n_build == 0:
        matched.fill_(False)
        if op is None:
            out_min.fill_(torch.iinfo(torch.int32).max)
            out_max.fill_(torch.iinfo(torch.int32).min)
    elif n_probe:
        codes = torch.empty(3 * n_build, dtype=torch.int64, device=device)
        vals = torch.empty(2 * n_build, dtype=torch.int32, device=device)
        span = torch.empty(lib.qs_span_words(), dtype=torch.int64,
                           device=device)
        sort_scratch = torch.empty(lib.qs_kv_scratch_words(n_build),
                                   dtype=torch.int64, device=device)
        carry = torch.empty(lib.qs_run_stats_carry_words(n_build),
                            dtype=torch.int32, device=device)
        sizes = fence_layout(n_build)
        fence = torch.empty(fence_scratch_words(n_build), dtype=torch.int64,
                            device=device)
        c_sizes = (ctypes.c_int64 * len(sizes))(*sizes)
        err = lib.qs_run_stats_probe(
            _ptr(build_key), _ptr(bmask), _ptr(bval), n_build, _ptr(probe),
            _ptr(pmask), _ptr(pval), n_probe,
            -1 if op is None else CMP_OPS[op], _ptr(matched), _ptr(out_min),
            _ptr(out_max), _ptr(codes), _ptr(vals), _ptr(span),
            _ptr(sort_scratch), _ptr(carry), _ptr(fence),
            ctypes.cast(c_sizes, ctypes.c_void_p), len(sizes),
            _blocks(n_build, device), 4 * _sms(device),
            max(1, min(-(-n_probe // (FENCE_THREADS * UNIQUE_PROBE_ROWS)),
                       UNIQUE_PROBE_BLOCKS_PER_SM * _sms(device))),
            _stream(device))
        _check(lib, err, "run_stats_probe")
        _launched("merge_cmp_probe")
    if op is None:
        return matched, out_min, out_max
    return matched


_TILE = 256 * 16                # kTile in csrc/compact_kernels.cu
_COUNT_TILES = 16               # kCountTiles: tiles a count block


def partition_scratch_words(n: int) -> int:
    """int64 words of K9's scratch: its ticket, a status word a count
    block, the live rows before each tile and the live total."""
    tiles = -(-n // _TILE)
    return tiles + -(-tiles // _COUNT_TILES) + 2


_SCATTER_BLOCKS_PER_SM = 8


def stable_partition(mask: torch.Tensor, limit: Optional[int] = None,
                     with_mask: bool = False):
    """K9: the first `limit` entries (all n where None) of the int64
    permutation that puts the positions of the live rows first and the dead
    rows after them, each in order; equal to torch.argsort(~mask,
    stable=True)[:limit]. Only those entries are allocated and written.
    with_mask: (the permutation, mask[permutation]), both written by the
    kernel. Two launches (the tile counts with their look-back, then the
    scatter), one where n fits one tile of 4,096 rows; counted as one."""
    device = _cuda_device(mask, "mask")
    n = int(mask.shape[0]) if mask.dim() == 1 else -1
    _require(mask, "mask", device, n, (torch.bool,))
    if limit is not None and limit < 0:
        raise ValueError(f"stable_partition: limit {limit} is negative")
    m = n if limit is None else min(int(limit), n)
    lib = build()
    out = torch.empty(m, dtype=torch.int64, device=device)
    out_mask = torch.empty(m, dtype=torch.bool, device=device) \
        if with_mask else None
    if m:
        src = _aligned16(mask)
        scratch = torch.empty(partition_scratch_words(n) if n > _TILE else 0,
                              dtype=torch.int64, device=device)
        err = lib.qs_stable_partition(
            _ptr(src), n, m, _ptr(scratch), _ptr(out), _ptr(out_mask),
            _SCATTER_BLOCKS_PER_SM * _sms(device), _stream(device))
        _check(lib, err, "stable_partition")
        _launched("sort_groupby_compact")
    return (out, out_mask) if with_mask else out


# ---------------------------------------------------------------------
# W1-W4: the window kernels (csrc/window_kernels.cu)
# ---------------------------------------------------------------------
_WIN_TILE = 256 * 16            # kTile in csrc/window_kernels.cu (W3)
_W1_TILE = 256 * 8              # kW1Tile in csrc/window_kernels.cu
_W2_TILE = 1024                 # kW2Tile in csrc/window_kernels.cu
_W2_SUPER = 32                  # kW2Super: tiles a superblock
_W4_TILE = 1024                 # kW4Tile in csrc/window_kernels.cu


def _flags(device, n: int, **flags) -> None:
    for name, t in flags.items():
        _require(t, name, device, n, (torch.bool,))


def window_prefix(fn: str, vals: Optional[torch.Tensor], live: torch.Tensor,
                  seg_start: torch.Tensor,
                  peer_start: Optional[torch.Tensor]):
    """W1: over rows sorted by (segment, order keys), each row's inclusive
    fn in {sum, min, max} of vals and count of live rows within its segment,
    read at the last row of its peer group (peer_start marks the first row
    of each; peer groups never cross a segment start). peer_start None is
    the whole-partition mode: each row's segment total. vals holds each
    row's contribution (0, or the MIN/MAX sentinel, at dead and NULL rows)
    and may be None for fn == count. Returns (values in vals' dtype or
    None, int64 counts). Three launches, counted as one."""
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
    out_val = None if fn == "count" else torch.empty(n, dtype=vals.dtype,
                                                     device=device)
    out_cnt = torch.empty(n, dtype=torch.int64, device=device)
    if n == 0:
        return out_val, out_cnt
    # the kernel reads by 16-byte vectors; copies stay referenced here
    # until the launch is queued
    ins = [None if t is None else _aligned16(t) for t in (
        None if fn == "count" else vals, live, seg_start, peer_start)]
    scratch = torch.empty(7 * -(-n // _W1_TILE), dtype=torch.int64,
                          device=device)
    err = lib.qs_window_prefix(
        _FN[fn], _DTYPE[vals.dtype] if fn != "count" else 0,
        int(peer_start is None), *[_ptr(t) for t in ins], n, _ptr(scratch),
        _ptr(out_val), _ptr(out_cnt), _stream(device))
    _check(lib, err, "window_prefix")
    _launched("window_prefix")
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
    ntiles = -(-n // _WIN_TILE)
    scratch = torch.empty(1 + 2 * ntiles + -(-ntiles // 2), dtype=torch.int64,
                          device=device)
    # the kernel reads flags and keys by 16-byte vectors; copies stay
    # referenced here until the launch is queued
    seg_start = _aligned16(seg_start)
    keys = _aligned16(keys) if mode == "range" else None
    err = lib.qs_frame_bounds(
        _FRAME_MODE[mode], _DTYPE[keys.dtype] if mode == "range" else 0,
        _ptr(seg_start), _ptr(keys), n,
        0 if start is None else int(start), 0 if end is None else int(end),
        int(start is None), int(end is None), _ptr(scratch), _ptr(lo),
        _ptr(hi), _stream(device))
    _check(lib, err, "frame_bounds")
    _launched("frame_bounds")
    return lo, hi


def frame_minmax(fn: str, c: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor) -> torch.Tensor:
    """W2: for each row i the MIN (fn == min) or MAX of c over rows
    [lo[i], hi[i]], and the sentinel (the dtype's max for MIN, its min for
    MAX) where hi < lo. c holds the sentinel at dead and NULL rows. Three
    launches, counted as one: the tiles whose frames fit their staged
    window, then (only where some tile's do not, decided on the device) the
    table of 32-row, tile and superblock aggregates and those tiles."""
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
    ntiles = -(-n // _W2_TILE)
    nsuper = -(-ntiles // _W2_SUPER)
    levels = nsuper.bit_length()
    scratch = torch.empty(2 + ntiles, dtype=torch.int32, device=device)
    per_super = 3 * _W2_SUPER * 32 + 3 * _W2_SUPER + levels
    table = torch.empty(nsuper * per_super, dtype=c.dtype, device=device)
    # the kernel reads by 16-byte vectors; copies stay referenced here
    # until the launch is queued
    ins = [_aligned16(t) for t in (c, lo, hi)]
    err = lib.qs_frame_minmax(_FN[fn], _DTYPE[c.dtype],
                              *[_ptr(t) for t in ins], n, _ptr(scratch),
                              _ptr(table), nsuper, levels, _ptr(out),
                              _stream(device))
    _check(lib, err, "frame_minmax")
    _launched("frame_minmax")
    return out


def sliding_sum(c: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                is_start: torch.Tensor) -> torch.Tensor:
    """W4: each row's float sum of c over [lo, hi], in c's own dtype, slid
    over each segment (is_start marks its first row) in the reference's
    order: equal bit for bit to quickstep_tpu/ops/window.py:273. Two
    launches, counted as one: the short route (segments that fit a tile's
    staged rows, a thread each), then the long route (a block each, over
    the list the first launch wrote on the device)."""
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
    ins = [_aligned16(t) for t in (c, lo, hi, is_start)]
    scratch = torch.empty(1 + -(-n // _W4_TILE), dtype=torch.int32,
                          device=device)
    err = lib.qs_sliding_sum(_DTYPE[c.dtype], *[_ptr(t) for t in ins], n,
                             _ptr(scratch), _ptr(out), _stream(device))
    _check(lib, err, "sliding_sum")
    _launched("sliding_sum")
    return out


def add_chain(x: torch.Tensor, steps: int) -> torch.Tensor:
    """x[0] plus x[1], steps times, each add rounded and dependent on the
    one before, by one thread on the card (steps a multiple of 16): timed,
    steps x the latency of one add, the bound of a W4 walk. Counts
    nothing."""
    device = _cuda_device(x, "x")
    _require(x, "x", device, 2, (torch.float32, torch.float64))
    if steps < 0 or steps % 16:
        raise ValueError(f"steps = {steps}: a multiple of 16 is needed")
    lib = build()
    out = torch.empty(1, dtype=x.dtype, device=device)
    err = lib.qs_add_chain(_DTYPE[x.dtype], _ptr(x), steps, _ptr(out),
                           _stream(device))
    _check(lib, err, "add_chain")
    return out


# ---------------------------------------------------------------------
# K10-K13: hashing, open addressing, K12's radix sort and run starts, the
# key-value sort of K13 (csrc/hash_kernels.cu, csrc/radix_kernels.cu,
# csrc/sort_kernels.cu)
# ---------------------------------------------------------------------
_KEY_DTYPE = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
              torch.float64: 3, torch.bool: 4, torch.uint8: 4}
MAX_HASH_KEYS = 16            # kMaxKeys in csrc/hash_kernels.cu


def _key_arrays(cols: List[torch.Tensor], device, n: int, dtypes):
    """Host arrays of the columns' pointers and dtype codes."""
    if not 1 <= len(cols) <= MAX_HASH_KEYS:
        raise ValueError(f"{len(cols)} key columns; the kernels take 1 to "
                         f"{MAX_HASH_KEYS}")
    for i, c in enumerate(cols):
        _require(c, f"cols[{i}]", device, n, dtypes)
    k = len(cols)
    ptrs = (ctypes.c_void_p * k)(*[c.data_ptr() for c in cols])
    codes = (ctypes.c_int * k)(*[_KEY_DTYPE[c.dtype] for c in cols])
    return ptrs, codes


def hash_keys(cols: List[torch.Tensor]) -> torch.Tensor:
    """K10: hash_combine of hash64 of each int32 or int64 key column (cast
    to int64), as int64 bits [n]."""
    device = _cuda_device(cols[0], "cols[0]")
    n = int(cols[0].shape[0]) if cols[0].dim() == 1 else -1
    ptrs, codes = _key_arrays(cols, device, n, (torch.int32, torch.int64))
    lib = build()
    out = torch.empty(n, dtype=torch.int64, device=device)
    if n == 0:
        return out
    err = lib.qs_hash_keys(len(cols), ctypes.cast(ptrs, ctypes.c_void_p),
                           ctypes.cast(codes, ctypes.c_void_p), n, _ptr(out),
                           _blocks(n, device), _stream(device))
    _check(lib, err, "hash_keys")
    _launched("hash_keys")
    return out


# K11's key-in-slot route: the bits each integer key dtype takes in the
# packed word (csrc/hash_kernels.cu pack_word); keys of at most 64 bits in
# all take it, every other key the row-id route
OA_WORD_BITS = {torch.int32: 32, torch.int64: 64, torch.uint8: 8,
                torch.bool: 8}


class OATable(NamedTuple):
    """K11's key-in-slot table: slots holds two int64 words a slot (the
    packed key, all ones where empty; the row id in the low 32 bits of the
    second), special the row of the one key that packs to all ones (-1 for
    none), and dtypes the build key columns' dtypes, which fix the
    packing."""
    slots: torch.Tensor
    special: torch.Tensor
    dtypes: Tuple[torch.dtype, ...]


def oa_word_route(dtypes) -> bool:
    """Whether key columns of these dtypes take K11's key-in-slot route:
    integer columns of at most 64 bits in all."""
    return all(d in OA_WORD_BITS for d in dtypes) and \
        sum(OA_WORD_BITS[d] for d in dtypes) <= 64


def oa_build(cols: List[torch.Tensor], alive: torch.Tensor,
             table_size: int):
    """K11 build of the live rows into a linear-probing table of table_size
    slots (a power of two above the live rows). Returns (table, 0-d bool
    dup flag: two live rows share a key). Keys that oa_word_route takes
    give an OATable (one fill of the slots, one launch); any other key an
    int32 table of row ids, -1 where empty, hashed with K10's device
    functions and compared on the key columns."""
    device = _cuda_device(alive, "alive")
    n = int(alive.shape[0]) if alive.dim() == 1 else -1
    _require(alive, "alive", device, n, (torch.bool,))
    cols = [c.view(torch.uint8) if c.dtype == torch.bool else c
            for c in cols]
    ptrs, codes = _key_arrays(cols, device, n, tuple(_KEY_DTYPE))
    if table_size < 1 or table_size & (table_size - 1) or \
            table_size > 2 ** 40:
        raise ValueError(f"table size {table_size} is not a power of two")
    _rows(n, "oa_build")
    lib = build()
    dup = torch.zeros((), dtype=torch.int32, device=device)
    if oa_word_route([c.dtype for c in cols]):
        table = OATable(
            torch.full((2 * table_size,), -1, dtype=torch.int64,
                       device=device),
            torch.full((1,), -1, dtype=torch.int32, device=device),
            tuple(c.dtype for c in cols))
        if n == 0:
            return table, dup != 0
        err = lib.qs_oa_word_build(
            len(cols), ctypes.cast(ptrs, ctypes.c_void_p),
            ctypes.cast(codes, ctypes.c_void_p), _ptr(alive), n,
            _ptr(table.slots), table_size, _ptr(table.special), _ptr(dup),
            _blocks(n, device), _stream(device))
    else:
        table = torch.full((table_size,), -1, dtype=torch.int32,
                           device=device)
        if n == 0:
            return table, dup != 0
        err = lib.qs_oa_build(len(cols), ctypes.cast(ptrs, ctypes.c_void_p),
                              ctypes.cast(codes, ctypes.c_void_p),
                              _ptr(alive), n, _ptr(table), table_size,
                              _ptr(dup), _blocks(n, device), _stream(device))
    _check(lib, err, "oa_build")
    _launched("open_addressing")
    return table, dup != 0


def oa_table_rows(table) -> torch.Tensor:
    """The build row of each slot, -1 where empty: an int32 table as it is,
    an OATable's row ids (its special key's row is not in a slot)."""
    if not isinstance(table, OATable):
        return table
    words = table.slots.view(-1, 2)
    return torch.where(words[:, 0] == -1, -1, words[:, 1].to(torch.int32))


def _as_build_dtypes(pcols: List[torch.Tensor], dtypes, alive):
    """The probe key columns cast to the build's dtypes, with the rows whose
    value the cast does not keep (out of range, a fraction, NaN: no build
    key equals them) taken out of alive. The comparison is then exact,
    where one at the promoted dtype rounds an integer that the float type
    cannot hold (beyond 2^24 against float32, 2^53 against float64)."""
    out = []
    for c, d in zip(pcols, dtypes):
        if c.dtype == torch.bool:
            c = c.view(torch.uint8)
        if c.dtype != d:
            cast = c.to(d)
            alive = alive & (cast.to(c.dtype) == c)
            c = cast
        out.append(c.contiguous())
    return out, alive


def oa_probe(table, bcols: List[torch.Tensor], pcols: List[torch.Tensor],
             alive: torch.Tensor):
    """K11 probe: each live probe row's build row (int32, -1 for none) and
    bool matched. An OATable is probed by the packed words alone (the probe
    columns cast to the build's dtypes; bcols give only the build side's
    rows, and are not read); an int32 table
    by walking from the slot of K10's hash, comparing key columns (build and
    probe columns pair up with equal dtypes)."""
    device = _cuda_device(alive, "alive")
    n = int(alive.shape[0]) if alive.dim() == 1 else -1
    _require(alive, "alive", device, n, (torch.bool,))
    if isinstance(table, OATable):
        size = int(table.slots.shape[0]) // 2
        _require(table.slots, "table.slots", device, 2 * size,
                 (torch.int64,))
        if size < 1 or size & (size - 1):
            raise ValueError(f"table size {size} is not a power of two")
        if len(bcols) != len(table.dtypes) or \
                len(pcols) != len(table.dtypes):
            raise TypeError("key columns differ in number from the table's")
        pcols, alive = _as_build_dtypes(pcols, table.dtypes, alive)
        pptrs, codes = _key_arrays(pcols, device, n, tuple(_KEY_DTYPE))
        lib = build()
        out = torch.full((n,), -1, dtype=torch.int32, device=device)
        matched = torch.zeros(n, dtype=torch.bool, device=device)
        if n == 0 or int(bcols[0].shape[0]) == 0:
            return out, matched
        err = lib.qs_oa_word_probe(
            _ptr(table.slots), size, _ptr(table.special), len(pcols),
            ctypes.cast(pptrs, ctypes.c_void_p),
            ctypes.cast(codes, ctypes.c_void_p), _ptr(alive), n, _ptr(out),
            _ptr(matched), _blocks(n, device), _stream(device))
        _check(lib, err, "oa_probe")
        _launched("open_addressing")
        return out, matched
    size = int(table.shape[0]) if table.dim() == 1 else -1
    _require(table, "table", device, size, (torch.int32,))
    if size < 1 or size & (size - 1):
        raise ValueError(f"table size {size} is not a power of two")
    if len(bcols) != len(pcols) or any(
            b.dtype != p.dtype for b, p in zip(bcols, pcols)):
        raise TypeError("build and probe key columns differ in number or "
                        "dtype")
    nb = int(bcols[0].shape[0]) if bcols and bcols[0].dim() == 1 else -1
    bptrs, codes = _key_arrays(bcols, device, nb, tuple(_KEY_DTYPE))
    pptrs, _ = _key_arrays(pcols, device, n, tuple(_KEY_DTYPE))
    lib = build()
    out = torch.full((n,), -1, dtype=torch.int32, device=device)
    matched = torch.zeros(n, dtype=torch.bool, device=device)
    if n == 0 or nb == 0:
        return out, matched
    err = lib.qs_oa_probe(_ptr(table), size, len(bcols),
                          ctypes.cast(bptrs, ctypes.c_void_p),
                          ctypes.cast(pptrs, ctypes.c_void_p),
                          ctypes.cast(codes, ctypes.c_void_p), _ptr(alive), n,
                          _ptr(out), _ptr(matched), _blocks(n, device),
                          _stream(device))
    _check(lib, err, "oa_probe")
    _launched("open_addressing")
    return out, matched


def run_starts(s: torch.Tensor, n_live: torch.Tensor, count: bool):
    """K12 over sorted values s: the mask i < n_live & (i == 0 | s[i] !=
    s[i - 1]), or with count its number of set entries (0-d int64)."""
    device = _cuda_device(s, "s")
    n = int(s.shape[0]) if s.dim() == 1 else -1
    _require(s, "s", device, n, tuple(_KEY_DTYPE))
    if n_live.device != device or n_live.dtype != torch.int64 or \
            n_live.dim() != 0:
        raise ValueError("n_live must be a 0-d int64 tensor on the device")
    lib = build()
    flags = None if count else torch.zeros(n, dtype=torch.bool,
                                           device=device)
    total = torch.zeros((), dtype=torch.int64, device=device) if count \
        else None
    if n == 0:
        return total if count else flags
    err = lib.qs_run_starts(_KEY_DTYPE[s.dtype], _ptr(s), n, _ptr(n_live),
                            _ptr(flags), _ptr(total), _blocks(n, device),
                            _stream(device))
    _check(lib, err, "run_starts")
    _launched("distinct_count")
    return total if count else flags


def radix_sort_live(vals: torch.Tensor, valid: Optional[torch.Tensor],
                    alive: torch.Tensor):
    """K12's sort: (vals with the rows that are not alive & valid as the
    dtype's maximum, sorted stably; the number of live rows, 0-d int64),
    as ops/groupby.py _sorted_live_plain computes them with torch.sort;
    bools come back as 0 / 1 bytes (uint8), as there."""
    device = _cuda_device(alive, "alive")
    n = int(alive.shape[0]) if alive.dim() == 1 else -1
    _require(alive, "alive", device, n, (torch.bool,))
    _require(valid, "valid", device, n, (torch.bool,))
    _require(vals, "vals", device, n, tuple(_KEY_DTYPE))
    _rows(n, "radix_sort_live")
    lib = build()
    v = vals.view(torch.uint8) if vals.dtype == torch.bool else vals
    out = torch.empty_like(v)
    n_live = torch.zeros((), dtype=torch.int64, device=device)
    if n == 0:
        return out, n_live
    tmp = torch.empty_like(v)
    scratch = torch.zeros(lib.qs_radix_scratch_words(n), dtype=torch.int64,
                          device=device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    err = lib.qs_radix_sort_live(_KEY_DTYPE[v.dtype], _ptr(v), _ptr(alive),
                                 _ptr(valid), n, _ptr(out), _ptr(tmp),
                                 _ptr(scratch), _ptr(n_live),
                                 _blocks(n, device), 4 * sms,
                                 _stream(device))
    _check(lib, err, "radix_sort_live")
    _launched("distinct_sort")
    return out, n_live


def kv_sort(keys: torch.Tensor, vals: Optional[torch.Tensor]):
    """The key-value radix sort that K8 and K13 run inside their calls,
    alone: (keys, vals) sorted stably by the keys read as unsigned (int32
    keys as uint32, int64 as uint64), vals int32 or None (then the row ids).
    Counts no launch: it is not a kernel of the engine's path by itself."""
    device = _cuda_device(keys, "keys")
    n = int(keys.shape[0]) if keys.dim() == 1 else -1
    _require(keys, "keys", device, n, (torch.int32, torch.int64))
    _require(vals, "vals", device, n, (torch.int32,))
    _rows(n, "kv_sort")
    lib = build()
    keys_out = torch.empty_like(keys)
    vals_out = torch.empty(n, dtype=torch.int32, device=device)
    if n == 0:
        return keys_out, vals_out
    keys_tmp, vals_tmp = torch.empty_like(keys), torch.empty_like(vals_out)
    scratch = torch.empty(lib.qs_kv_scratch_words(n), dtype=torch.int64,
                          device=device)
    err = lib.qs_kv_sort(keys.element_size(), _ptr(keys), _ptr(vals), n,
                         _ptr(keys_out), _ptr(vals_out), _ptr(keys_tmp),
                         _ptr(vals_tmp), _ptr(scratch), _blocks(n, device),
                         4 * _sms(device), _stream(device))
    _check(lib, err, "kv_sort")
    return keys_out, vals_out


def order_permutation(keys: List[torch.Tensor],
                      valids: List[Optional[torch.Tensor]],
                      ascending: List[bool], nulls_first: List[Optional[bool]],
                      alive: torch.Tensor) -> torch.Tensor:
    """K13: the stable int64 permutation that sorts the live rows by the
    keys (keys[0] most significant; DESC, NULLS FIRST / LAST as the SQL
    default or as asked), the dead rows after them in key order: what
    ops/sort.py order_permutation_plain gives. One call: a chain of
    key-value radix sorts over each key's range-compressed codes, last key
    first, carrying int32 row ids, then the dead flag."""
    device = _cuda_device(alive, "alive")
    n = int(alive.shape[0]) if alive.dim() == 1 else -1
    _require(alive, "alive", device, n, (torch.bool,))
    cols = [k.view(torch.uint8) if k.dtype == torch.bool else k for k in keys]
    for i, (c, v) in enumerate(zip(cols, valids)):
        _require(c, f"keys[{i}]", device, n, tuple(_KEY_DTYPE))
        _require(v, f"valids[{i}]", device, n, (torch.bool,))
    _rows(n, "order_permutation")
    lib = build()
    out = torch.empty(n, dtype=torch.int64, device=device)
    if n == 0:
        return out
    k = len(cols)
    firsts = [nf if nf is not None else (not asc)
              for asc, nf in zip(ascending, nulls_first)]
    codes = torch.empty(3 * n, dtype=torch.int64, device=device)
    vals = torch.empty(3 * n, dtype=torch.int32, device=device)
    spans = torch.empty(max(1, k) * lib.qs_span_words(), dtype=torch.int64,
                        device=device)
    scratch = torch.empty(lib.qs_kv_scratch_words(n), dtype=torch.int64,
                          device=device)
    c_dtypes = (ctypes.c_int * max(1, k))(*[_KEY_DTYPE[c.dtype] for c in cols])
    c_keys = (ctypes.c_void_p * max(1, k))(*[c.data_ptr() for c in cols])
    c_valids = (ctypes.c_void_p * max(1, k))(*[_ptr(v) for v in valids])
    c_desc = (ctypes.c_int * max(1, k))(*[int(not a) for a in ascending])
    c_first = (ctypes.c_int * max(1, k))(*[int(f) for f in firsts])
    err = lib.qs_order_permutation(
        k, ctypes.cast(c_dtypes, ctypes.c_void_p),
        ctypes.cast(c_keys, ctypes.c_void_p),
        ctypes.cast(c_valids, ctypes.c_void_p),
        ctypes.cast(c_desc, ctypes.c_void_p),
        ctypes.cast(c_first, ctypes.c_void_p), _ptr(alive), n, _ptr(out),
        _ptr(codes), _ptr(vals), _ptr(spans), _ptr(scratch),
        _blocks(n, device), 4 * _sms(device), _stream(device))
    _check(lib, err, "order_permutation")
    _launched("order_permutation")
    return out


# ---------------------------------------------------------------------
# K14-K16: the mesh path's radix partition, bucket scatter and bloom
# filter (csrc/shuffle_kernels.cu)
# ---------------------------------------------------------------------
_PART_TILE = 256 * 16           # kTile in csrc/shuffle_kernels.cu
MAX_PARTS = 1024                # kMaxParts in csrc/shuffle_kernels.cu
SWEEP_PARTS = 255               # kSweepParts: K14's one-launch route


def reciprocal(d: int) -> int:
    """ceil(2^64 / d), with which csrc/shuffle_kernels.cu divides by d
    with no divide instruction (its Divisor); 0 for d = 1, which the
    kernels take apart."""
    return 0 if d == 1 else -(-(1 << 64) // d)


def mod_constants(n_parts: int) -> Tuple[int, int]:
    """(m, c) with which K14 takes (h + s) mod n_parts of a 64-bit hash h
    and a salt s < 2^31 by one multiply-high (part_of in
    csrc/shuffle_kernels.cu): m = reciprocal(n_parts), c = 2^32 mod
    n_parts, x = (h >> 32) * c + (h mod 2^32) + s and (h + s) mod n_parts
    = ((m * x mod 2^64) * n_parts) >> 64. (0, 0) for a power of two,
    which the kernel masks."""
    if n_parts & (n_parts - 1) == 0:
        return 0, 0
    return reciprocal(n_parts), (1 << 32) % n_parts


class _Sweep:
    """K14's one-launch look-back state on one stream: a 64-bit ticket,
    then the status words. It is never cleared: `tag` names the call
    (its words read as unpublished to later calls) and `base` is the
    ticket's count before the next launch. A larger buffer, or a tag near
    the kernel's limit, starts a new zeroed state."""

    def __init__(self, words: int, device: torch.device):
        self.buf = torch.zeros(1 + words, dtype=torch.int64, device=device)
        self.base = 0
        self.tag = 0


_SWEEPS = {}
_SWEEP_MIN_WORDS = 1 << 16
_SWEEP_MAX_TAG = 1 << 30
_sweep_lock = threading.Lock()


def _sweep_state(device: torch.device, words: int) -> _Sweep:
    """The state of the current stream, with room for `words` status words
    and the next call's tag (called under _sweep_lock)."""
    key = (device.index if device.index is not None
           else torch.cuda.current_device(), _stream(device))
    st = _SWEEPS.get(key)
    if st is None or st.buf.shape[0] - 1 < words or \
            st.tag >= _SWEEP_MAX_TAG:
        room = max(words, _SWEEP_MIN_WORDS,
                   0 if st is None else 2 * (st.buf.shape[0] - 1))
        st = _SWEEPS[key] = _Sweep(room, device)
    st.tag += 1
    return st


def partition_dest(key: torch.Tensor, alive: torch.Tensor, n_parts: int,
                   cap: int, salt: int = 1, probe_side: bool = True,
                   with_counts: bool = False):
    """K14: each row's slot in n_parts buckets of cap rows: p * cap + its
    stable rank among the live rows of partition p, where p is the hash
    partition of its key (int32 or int64) plus its salt; n_parts * cap for
    a dead row and for a live row past its bucket's capacity. A salted build
    side (salt > 1, probe_side False) has salt * L rows, row s * L + i being
    row i with salt s. Returns (int32 dest, 0-d bool overflow), and with
    with_counts each bucket's occupied count min(its live rows, cap) as
    int32[n_parts] (K15's bucket_rows reads it).

    Up to SWEEP_PARTS partitions one launch (a onesweep pass whose tiles
    rank their rows and find each bucket's rows in the earlier tiles by a
    decoupled look-back; the last tile writes the counts and the flag);
    beyond, a count launch, one torch.cumsum over the tiles' counts and a
    rank launch. No division per row: the modulo is a mask or a
    multiply-high by mod_constants, a salted row's salt and source row an
    increment. The key bytes and the mask are read once, dest written once:
    those bytes bound it."""
    device = _cuda_device(alive, "alive")
    n = int(alive.shape[0]) if alive.dim() == 1 else -1
    _require(alive, "alive", device, n, (torch.bool,))
    _require(key, "key", device, n, tuple(_KEY))
    if not 1 <= n_parts <= MAX_PARTS:
        raise ValueError(f"{n_parts} partitions; the kernel takes 1 to "
                         f"{MAX_PARTS}")
    if salt < 1 or cap < 1 or n_parts * cap >= 2 ** 31:
        raise ValueError(f"salt {salt}, bucket capacity {cap}: out of range")
    tiled = salt > 1 and not probe_side
    lx = n * salt if tiled else n
    _rows(lx, "partition_dest")
    lib = build()
    dest = torch.empty(lx, dtype=torch.int32, device=device)
    if lx == 0:
        overflow = torch.zeros((), dtype=torch.bool, device=device)
        counts = torch.zeros(n_parts, dtype=torch.int32, device=device)
        return (dest, overflow, counts) if with_counts else (dest, overflow)
    overflow = torch.empty((), dtype=torch.bool, device=device)
    counts = torch.empty(n_parts, dtype=torch.int32, device=device)
    walk = n if tiled else salt
    args = (_ptr(key), int(key.dtype == torch.int64), _ptr(alive),
            int(tiled), n_parts, *mod_constants(n_parts), walk,
            reciprocal(walk), lx)
    n_tiles = -(-lx // _PART_TILE)
    stream = _stream(device)
    if n_parts <= SWEEP_PARTS:
        with _sweep_lock:
            st = _sweep_state(device, n_tiles * n_parts)
            err = lib.qs_partition_sweep(
                *args, cap, _ptr(dest), _ptr(counts), _ptr(overflow),
                _ptr(st.buf), st.base, st.tag, stream)
            st.base += n_tiles
            if err != 0:
                _SWEEPS.clear()
        _check(lib, err, "partition_dest")
    else:
        tile_counts = torch.empty((n_parts + 1, n_tiles), dtype=torch.int32,
                                  device=device)
        _check(lib, lib.qs_partition_count(*args, n_tiles, _ptr(tile_counts),
                                           stream), "partition_dest")
        # each bin's ranks in the earlier tiles
        first = (torch.cumsum(tile_counts, dim=1, dtype=torch.int32)
                 - tile_counts).contiguous()
        _check(lib, lib.qs_partition_dest(*args, n_tiles, _ptr(first), cap,
                                          _ptr(dest), _ptr(counts),
                                          _ptr(overflow), stream),
               "partition_dest")
    _launched("partition_dest")
    return (dest, overflow, counts) if with_counts else (dest, overflow)


def bucket_rows(dest: torch.Tensor, counts: torch.Tensor, rows: int,
                cap: int):
    """K15's route for K14's destinations: from partition_dest's int32
    dest and counts (n_parts buckets of cap slots) over an input of `rows`
    rows (dest has rows, or rows * salt on a salted build side), the int32
    gather index of every slot, the id mod rows of the row in an occupied
    slot and 0 in an empty one, and the bool occupied mask. One launch,
    each slot written once: the mask and the empty tails' zeros from the
    counts, each tile's rows staged by slot in shared memory and stored a
    bucket's run at a time. Counted as scatter_compact."""
    device = _cuda_device(dest, "dest")
    lx = int(dest.shape[0]) if dest.dim() == 1 else -1
    _require(dest, "dest", device, lx, (torch.int32,))
    n_parts = int(counts.shape[0]) if counts.dim() == 1 else -1
    _require(counts, "counts", device, n_parts, (torch.int32,))
    if not 1 <= n_parts <= MAX_PARTS or cap < 1 or n_parts * cap >= 2 ** 31:
        raise ValueError(f"{n_parts} buckets of {cap} slots: out of range")
    if lx and (rows < 1 or lx % rows):
        raise ValueError(f"{lx} destinations over {rows} rows")
    _rows(lx, "bucket_rows")
    lib = build()
    slots = n_parts * cap
    if lx == 0:
        # no row: every slot empty, as the plain version gives it
        return (torch.zeros(slots, dtype=torch.int32, device=device),
                torch.zeros(slots, dtype=torch.bool, device=device))
    idx = torch.empty(slots, dtype=torch.int32, device=device)
    occ = torch.empty(slots, dtype=torch.bool, device=device)
    n_tiles = -(-lx // _PART_TILE)
    grid = max(n_tiles, min(-(-slots // (4 * _THREADS)),
                            _BLOCKS_PER_SM * _sms(device)))
    err = lib.qs_bucket_rows(_ptr(dest), lx, int(lx > rows), rows,
                             reciprocal(rows), n_parts, cap,
                             reciprocal(cap), _ptr(counts), _ptr(idx),
                             _ptr(occ), grid, _stream(device))
    _check(lib, err, "bucket_rows")
    _launched("scatter_compact")
    return idx, occ


def _fill_bits(fill, dtype: torch.dtype) -> int:
    """The bit pattern of fill in dtype, as an unsigned 64-bit int."""
    t = torch.tensor([fill], dtype=dtype)
    width = t.element_size()
    as_int = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
              8: torch.int64}[width]
    return int(t.view(as_int).item()) & ((1 << (8 * width)) - 1)


def scatter_compact(col: torch.Tensor, dest: torch.Tensor, capacity: int,
                    fill=0) -> torch.Tensor:
    """K15: out[capacity] with out[dest[i]] = col[i] where dest[i] lies in
    [0, capacity) (other rows are dropped) and fill elsewhere. Destinations
    are unique; col is 1-D with 1-, 2-, 4- or 8-byte elements, dest int32
    or int64."""
    device = _cuda_device(dest, "dest")
    n = int(dest.shape[0]) if dest.dim() == 1 else -1
    _require(dest, "dest", device, n, (torch.int32, torch.int64))
    _require(col, "col", device, n, (col.dtype,))
    if col.element_size() not in (1, 2, 4, 8):
        raise TypeError(f"col has {col.element_size()}-byte elements")
    if capacity < 0:
        raise ValueError(f"capacity {capacity} is negative")
    lib = build()
    if n == 0 or capacity == 0:
        # nothing to scatter: the fill alone, as the plain version gives it
        return torch.full((capacity,), fill, dtype=col.dtype, device=device)
    out = torch.empty(capacity, dtype=col.dtype, device=device)
    err = lib.qs_scatter_compact(
        col.element_size(), _ptr(col), _ptr(dest),
        int(dest.dtype == torch.int64), n, capacity,
        _fill_bits(fill, col.dtype), _ptr(out),
        _blocks(max(n, capacity), device), _stream(device))
    _check(lib, err, "scatter_compact")
    _launched("scatter_compact")
    return out


def _check_nbits(nbits: int) -> None:
    if nbits < 1 or nbits & (nbits - 1) or nbits > 2 ** 40:
        raise ValueError(f"bloom filter of {nbits} slots: not a power of two")


def bloom_words(nbits: int) -> int:
    """int32 words of a K16 table of nbits slots: a bit a slot."""
    return -(-nbits // 32)


def bloom_build(cols: List[torch.Tensor], alive: torch.Tensor,
                nbits: int) -> torch.Tensor:
    """K16 build: the int32 words of an nbits-slot table (slot s at bit
    s % 32 of word s // 32, ops/bloom.py presence_words), with a 1 at the
    slot of each live row, the hash of its key columns (K10's) &
    (nbits - 1)."""
    device = _cuda_device(alive, "alive")
    n = int(alive.shape[0]) if alive.dim() == 1 else -1
    _require(alive, "alive", device, n, (torch.bool,))
    ptrs, codes = _key_arrays(cols, device, n, tuple(_KEY_DTYPE))
    _check_nbits(nbits)
    lib = build()
    if n == 0:
        return torch.zeros(bloom_words(nbits), dtype=torch.int32,
                           device=device)
    words = torch.empty(bloom_words(nbits), dtype=torch.int32, device=device)
    err = lib.qs_bloom_build(len(cols), ctypes.cast(ptrs, ctypes.c_void_p),
                             ctypes.cast(codes, ctypes.c_void_p), _ptr(alive),
                             n, _ptr(words), nbits, _blocks(n, device),
                             _stream(device))
    _check(lib, err, "bloom_build")
    _launched("bloom_filter")
    return words


def bloom_probe(words: torch.Tensor, cols: List[torch.Tensor],
                alive: torch.Tensor, nbits: Optional[int] = None
                ) -> torch.Tensor:
    """K16 probe: alive & the bit of each row's slot in the words of an
    nbits-slot table (32 x its words where None)."""
    device = _cuda_device(alive, "alive")
    n = int(alive.shape[0]) if alive.dim() == 1 else -1
    _require(alive, "alive", device, n, (torch.bool,))
    if nbits is None:
        nbits = 32 * int(words.shape[0]) if words.dim() == 1 else -1
    _check_nbits(nbits)
    _require(words, "words", device, bloom_words(nbits), (torch.int32,))
    ptrs, codes = _key_arrays(cols, device, n, tuple(_KEY_DTYPE))
    lib = build()
    out = torch.empty(n, dtype=torch.bool, device=device)
    if n == 0:
        return out
    err = lib.qs_bloom_probe(len(cols), ctypes.cast(ptrs, ctypes.c_void_p),
                             ctypes.cast(codes, ctypes.c_void_p), _ptr(alive),
                             n, _ptr(words), nbits, _ptr(out),
                             _blocks(n, device), _stream(device))
    _check(lib, err, "bloom_probe")
    _launched("bloom_filter")
    return out
