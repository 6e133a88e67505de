"""roofline_share: the least bytes the queries completed in the window
must read, over the card's memory rate, as a share of the device's busy
time in the traced window, in %. A query's least bytes are each base-table
column its SQL names, read once, at the width the configuration's file
gives (column_bytes) times the table's rows: counted from the SQL, so a
kernel that is replaced reads the same work."""

import re


def query_bytes(sql, column_bytes, table_rows):
    names = set(re.findall(r"[a-z_][a-z0-9_]*", sql.lower()))
    return sum(width * table_rows[t]
               for t, cols in column_bytes.items()
               for c, width in cols.items() if c in names)


def read(run):
    peak = next((d["hbm_bytes_per_s"]
                 for k, d in run.peaks["devices"].items()
                 if run.device_kind and k in run.device_kind), None)
    if not run.busy_s or peak is None:
        return None
    total = sum(query_bytes(run.queries[r["query"]],
                            run.config["column_bytes"], run.table_rows)
                for r in run.completed())
    return 100.0 * total / peak / run.busy_s
