"""Hand generated tables to the program: CREATE TABLE, the columns as host
arrays with their dictionaries, and exact statistics that the harness works
out from the data (as bench/tpch_fullgen.py's `load_tables` does).

The host arrays are made read-only before the program sees them, so the
reference, which reads the same arrays after the window, reads what the
generator made.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from qsbench.gen import Tables

# at most this span of values is counted by bincount, above it by unique
_BINCOUNT_SPAN = 33_000_000


def host_columns(tables: Tables) -> Dict[str, Dict[str, np.ndarray]]:
    """Read-only host copies of every column."""
    out = {}
    for t, cols in tables.columns.items():
        out[t] = {}
        for c, x in cols.items():
            arr = x.cpu().numpy()
            arr.flags.writeable = False
            out[t][c] = arr
    return out


def statistics(tables: Tables) -> Dict[str, dict]:
    """Exact statistics of each table in the catalog's JSON form (number
    of rows, each column's min, max, distinct values and largest count;
    partsupp's (partkey, suppkey) declared unique where it is), computed
    on the tables' device."""
    out = {}
    for t, cols in tables.columns.items():
        st = {"exact": True, "num_tuples": tables.rows(t), "min_values": {},
              "max_values": {}, "num_distinct": {}, "max_counts": {},
              "unique_pairs": []}
        for c, x in cols.items():
            lo, hi = int(x.min()), int(x.max())
            if hi - lo < _BINCOUNT_SPAN:
                counts = torch.bincount((x - lo).to(torch.int64))
                counts = counts[counts > 0]
            else:
                counts = torch.unique(x, return_counts=True)[1]
            words = tables.vocab[t].get(c)
            st["min_values"][c] = words[lo] if words else lo
            st["max_values"][c] = words[hi] if words else hi
            st["num_distinct"][c] = int(counts.numel())
            st["max_counts"][c] = int(counts.max())
        out[t] = st
    ps = tables.columns["partsupp"]
    pair = ps["ps_partkey"].to(torch.int64) * (1 << 32) + ps["ps_suppkey"]
    if torch.unique(pair).numel() == pair.numel():
        out["partsupp"]["unique_pairs"] = [["ps_partkey", "ps_suppkey"]]
    return out


def load(db, tables: Tables, host: Dict[str, Dict[str, np.ndarray]],
         stats: Dict[str, dict], schemas: Dict[str, list]) -> None:
    """Create the tables of `schemas` (the generator's (column, SQL type)
    lists) in `db` (a quickstep_tpu_torch.Database) and give them the host
    columns and the statistics."""
    from quickstep_tpu_torch.catalog.catalog import _stats_from_json
    from quickstep_tpu_torch.storage.column import Column
    from quickstep_tpu_torch.storage.dictionary import Dictionary
    from quickstep_tpu_torch.storage.table import TableData
    for name, schema in schemas.items():
        cols = ", ".join(f"{c} {typ} NOT NULL" for c, typ in schema)
        db.execute(f"CREATE TABLE {name} ({cols})")
        rel = db.catalog.default_database.get_relation(name)
        types = {a.name: a.type for a in rel.attributes}
        words = tables.vocab[name]
        rel.set_data(TableData({
            c: Column(types[c], host[name][c], None,
                      Dictionary(words[c]) if c in words else None)
            for c, _ in schema}))
        rel.statistics = _stats_from_json(stats[name])
