# Copied from quickstep_tpu/storage/csv_io.py; only the package name in imports differs.
"""Bulk CSV/text load and export.

Capability parity with the reference's TextScanOperator (parallel CSV bulk load,
relational_operators/TextScanOperator.hpp:105 — 256KB file segments, one WorkOrder
each) and TableExportOperator (COPY TO). Here parsing is host-side numpy/pandas-free
vectorized Python; parallelism over file segments is unnecessary because the device,
not the host scan, is the bottleneck — but the loader still streams in chunks to bound
memory.
"""

from __future__ import annotations

import csv as _csv
from typing import List, Optional

import numpy as np

from quickstep_tpu_torch.errors import ExecutionError
from quickstep_tpu_torch.types import Type, TypeID
from quickstep_tpu_torch.types.datetime_util import (
    parse_date_literal, parse_datetime_literal, date_to_str, datetime_to_str,
)
from quickstep_tpu_torch.storage.column import Column
from quickstep_tpu_torch.storage.dictionary import Dictionary
from quickstep_tpu_torch.storage.table import TableData


def load_csv(path: str, schema: List[tuple], delimiter: str = "|",
             header: bool = False) -> TableData:
    """schema: [(name, Type)]. Accepts trailing delimiter lines (dbgen .tbl style).
    Empty field or \\N -> NULL (only allowed for nullable columns).

    Uses the native parallel scanner (native/csv_scanner.cpp) when available;
    falls back to the pure-Python parser (also used for header/odd formats)."""
    if not header and len(delimiter) == 1:
        native = _try_native(path, schema, delimiter)
        if native is not None:
            return native
    ncols = len(schema)
    raw_cols: List[List[str]] = [[] for _ in range(ncols)]
    with open(path, "r", newline="") as f:
        reader = _csv.reader(f, delimiter=delimiter)
        first = True
        for row in reader:
            if first and header:
                first = False
                continue
            first = False
            if not row:
                continue
            if len(row) == ncols + 1 and row[-1] == "":
                row = row[:-1]  # trailing delimiter
            if len(row) != ncols:
                raise ExecutionError(
                    f"bad row in {path}: expected {ncols} fields, got {len(row)}")
            for i, v in enumerate(row):
                raw_cols[i].append(v)
    cols = {}
    for (name, typ), raw in zip(schema, raw_cols):
        cols[name] = _parse_column(typ, raw)
    return TableData(cols)


def _try_native(path: str, schema: List[tuple], delimiter: str):
    try:
        from quickstep_tpu_torch.storage.native_io import parse_csv_native
        res = parse_csv_native(path, schema, delimiter)
    except Exception:
        return None
    if res is None:
        return None
    parsed, nrows = res
    cols = {}
    for name, typ in schema:
        vals, null_mask = parsed[name]
        has_null = bool(null_mask.any())
        valid = ~null_mask if has_null else None
        if typ.is_string:
            d, codes = Dictionary.build(vals)
            cols[name] = Column(typ, codes, valid, d)
        elif typ.type_id == TypeID.DATETIME:
            import numpy as _np
            data = _np.asarray(
                [parse_datetime_literal(v) if v else 0 for v in vals],
                dtype=_np.int64)
            cols[name] = Column(typ, data, valid, None)
        else:
            # dbgen .tbl trailing delimiter yields a phantom empty last field
            # only in the python path; native parser indexes real columns
            cols[name] = Column(typ, vals, valid, None)
    return TableData(cols)


def _parse_column(typ: Type, raw: List[str]) -> Column:
    n = len(raw)
    null_mask = np.asarray([(v == "" or v == "\\N") for v in raw], dtype=bool)
    has_null = bool(null_mask.any())
    valid = ~null_mask if has_null else None
    tid = typ.type_id
    if typ.is_string:
        d, codes = Dictionary.build(["" if m else v
                                     for v, m in zip(raw, null_mask)])
        return Column(typ, codes, valid, d)
    if tid == TypeID.DATE:
        vals = np.asarray([parse_date_literal(v) if not m else 0
                           for v, m in zip(raw, null_mask)], dtype=np.int32)
        return Column(typ, vals, valid, None)
    if tid == TypeID.DATETIME:
        vals = np.asarray([parse_datetime_literal(v) if not m else 0
                           for v, m in zip(raw, null_mask)], dtype=np.int64)
        return Column(typ, vals, valid, None)
    arr = np.asarray(["0" if m else v for v, m in zip(raw, null_mask)])
    if tid == TypeID.DECIMAL:
        vals = np.round(arr.astype(np.float64) *
                        (10 ** typ.scale)).astype(typ.device_dtype)
    elif typ.is_floating:
        vals = arr.astype(np.float64).astype(typ.device_dtype)
    else:
        vals = arr.astype(np.int64).astype(typ.device_dtype)
    return Column(typ, vals, valid, None)


def format_export(names: List[str], types: List[Type], rows,
                  options: Optional[dict] = None) -> str:
    """COPY TO text, reference TableExportOperator semantics
    (relational_operators/TableExportOperator.hpp:61; options parsed in
    ParseStatement.hpp COPY WITH clause):

    - FORMAT 'TEXT' (default): delimiter '\\t', no header, NULL printed as
      the NULL_STRING option (default '\\N'), special chars backslash-escaped
    - FORMAT 'CSV': delimiter ',', HEADER TRUE by default, NULL as '' unless
      NULL_STRING given; fields containing delimiter/quote/newline are
      double-quote quoted with embedded quotes doubled

    Values render in the width-0 PrintToScreen form (dates as 2000-01-01 etc).
    """
    options = options or {}
    fmt = str(options.get("format", "text")).lower()
    is_csv = fmt == "csv"
    delim = str(options.get("delimiter", "," if is_csv else "\t"))
    header = bool(options.get("header", is_csv))
    null_str = str(options.get("null_string", "" if is_csv else "\\N"))
    from quickstep_tpu_torch.exec.result import _format_cell

    def field(v, t) -> str:
        if v is None:
            return null_str
        s = _format_cell(v, t)
        if is_csv:
            if ('"' in s) or (delim in s) or ("\n" in s) or ("\r" in s):
                return '"' + s.replace('"', '""') + '"'
            return s
        s = s.replace("\\", "\\\\")
        for ch, esc in (("\n", "\\n"), ("\r", "\\r"), ("\t", "\\t")):
            s = s.replace(ch, esc)
        if delim not in "\t\n\r":
            s = s.replace(delim, "\\" + delim)
        return s

    out_lines = []
    if header:
        out_lines.append(delim.join(names))
    for r in rows:
        out_lines.append(delim.join(field(v, t) for v, t in zip(r, types)))
    return "\n".join(out_lines) + ("\n" if out_lines else "")


def export_csv(path: str, names: List[str], types: List[Type], rows,
               options: Optional[dict] = None) -> str:
    """Write/emit COPY TO output; returns the text for stdout/stderr targets
    (the CLI/golden runner prints it), else writes the file and returns ''."""
    text = format_export(names, types, rows, options)
    if path in ("stdout", "stderr", "$stdout", "$stderr"):
        return text
    with open(path, "w") as f:
        f.write(text)
    return ""
