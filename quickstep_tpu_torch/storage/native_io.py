# Copied from quickstep_tpu/storage/native_io.py; only the package name in imports and _load_library differ (it builds the scanner into build/native/ and never loads the tracked native/libqstpu_io.so).
"""ctypes bindings for the native C++ bulk text scanner (native/csv_scanner.cpp).

The reference's TextScanOperator runs C++ field parsing across WorkOrder threads;
this binding gives the same native parallel parse, writing directly into numpy
buffers. Falls back silently (returns None) if the shared library is missing and
cannot be built — callers then use the pure-Python csv path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Tuple

import numpy as np

from quickstep_tpu_torch.types import Type, TypeID

_LIB = None
_LIB_TRIED = False

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")


def _load_library():
    """Build native/csv_scanner.cpp into build/native/libqstpu_io.so at the
    root of the checkout and load it; the build is redone when a hash of the
    source and the compiler flags changes. Unlike the reference, this never
    loads the tracked native/libqstpu_io.so and builds without
    -march=native: a library built for another machine's CPU can die on an
    illegal instruction, which no exception catches."""
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    import hashlib
    src = os.path.join(_NATIVE_DIR, "csv_scanner.cpp")
    build_dir = os.path.join(os.path.dirname(_NATIVE_DIR), "build", "native")
    so = os.path.join(build_dir, "libqstpu_io.so")
    stamp = so + ".sha256"
    flags = ["-O3", "-shared", "-fPIC", "-pthread"]
    try:
        with open(src, "rb") as f:
            digest = hashlib.sha256(
                " ".join(flags).encode() + f.read()).hexdigest()
        with open(stamp) as f:
            built = f.read() == digest and os.path.exists(so)
    except OSError:
        built = False
    if not built:
        try:
            os.makedirs(build_dir, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            subprocess.run(["g++", *flags, "-o", tmp, src],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
            with open(stamp, "w") as f:
                f.write(digest)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(so)
        lib.qs_count_rows.restype = ctypes.c_int64
        lib.qs_count_rows.argtypes = [ctypes.c_char_p]
        lib.qs_parse_csv.restype = ctypes.c_int64
        lib.qs_parse_csv.argtypes = [
            ctypes.c_char_p, ctypes.c_char, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
        ]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def native_available() -> bool:
    return _load_library() is not None


_TYPE_CODE = {
    TypeID.INT: 0, TypeID.LONG: 0,
    TypeID.FLOAT: 1, TypeID.DOUBLE: 1,
    TypeID.DECIMAL: 1,  # float parse, scaled to integer units host-side
    TypeID.DATE: 2,
    TypeID.DATETIME: 3,  # parsed as string, converted host-side (rare)
    TypeID.CHAR: 3, TypeID.VARCHAR: 3,
}


def parse_csv_native(path: str, schema: List[Tuple[str, Type]],
                     delimiter: str = "|"):
    """Returns {name: (np data in device encoding — strings as python lists,
    np nulls)} or None if native lib unavailable."""
    lib = _load_library()
    if lib is None:
        return None
    nrows = lib.qs_count_rows(path.encode())
    if nrows < 0:
        raise OSError(f"cannot open {path}")
    ncols = len(schema)
    file_size = os.path.getsize(path)

    col_arrays = []
    data_ptrs = (ctypes.c_void_p * ncols)()
    null_ptrs = (ctypes.POINTER(ctypes.c_uint8) * ncols)()
    type_codes = (ctypes.c_int * ncols)()
    nulls = []
    for i, (_, t) in enumerate(schema):
        code = _TYPE_CODE[t.type_id]
        type_codes[i] = code
        if code == 0:
            arr = np.zeros(nrows, np.int64)
        elif code == 1:
            arr = np.zeros(nrows, np.float64)
        elif code == 2:
            arr = np.zeros(nrows, np.int32)
        else:
            arr = np.zeros(nrows, np.int64)  # packed (offset<<16 | len)
        nl = np.zeros(nrows, np.uint8)
        col_arrays.append(arr)
        nulls.append(nl)
        data_ptrs[i] = arr.ctypes.data_as(ctypes.c_void_p)
        null_ptrs[i] = nl.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    arena = ctypes.create_string_buffer(max(file_size, 1))
    seg_starts = (ctypes.c_int64 * 257)()
    got = lib.qs_parse_csv(path.encode(), delimiter.encode(), ncols,
                           type_codes, data_ptrs, null_ptrs, arena, seg_starts)
    if got < 0:
        raise ValueError(f"native parse failed for {path} ({got})")
    if got != nrows:
        raise ValueError(f"row count mismatch in {path}: {got} != {nrows}")

    arena_bytes = arena.raw
    out = {}
    for (name, t), arr, nl in zip(schema, col_arrays, nulls):
        code = _TYPE_CODE[t.type_id]
        null_mask = nl.astype(bool)
        if code == 3:
            offs = (arr >> 16).astype(np.int64)
            lens = (arr & 0xFFFF).astype(np.int64)
            vals = [arena_bytes[o:o + l].decode("utf-8", "replace")
                    for o, l in zip(offs, lens)]
            out[name] = (vals, null_mask)
        elif t.type_id == TypeID.INT:
            out[name] = (arr.astype(np.int32), null_mask)
        elif t.type_id == TypeID.FLOAT:
            out[name] = (arr.astype(np.float32), null_mask)
        elif t.type_id == TypeID.DECIMAL:
            out[name] = (np.round(arr * (10 ** t.scale)).astype(
                t.device_dtype), null_mask)
        else:
            out[name] = (arr, null_mask)
    return out, nrows
