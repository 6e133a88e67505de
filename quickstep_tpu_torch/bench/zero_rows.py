"""Every kernel at zero rows: for each of the 22 kernels of ops/cuda.py, a
call of its public function on an empty input (for the join kernels that
read a build side, an empty build side under a probe of a few rows)
beside the same call of the plain version. On the card the kernel call
must launch nothing and return what the plain version returns;
chip_smoke.py and tests/test_torch_kernels_cuda.py hold them so.

    cases = zero_row_cases(torch.device("cuda"))
    kernel_fn, plain_fn = cases["multi_gather"]

And every operator over an input of zero rows in SQL (ZERO_ROW_SCRIPT, then
each of ZERO_ROW_QUERIES), which tests/test_torch_operators.py holds
against sqlite and quickstep_tpu on the CPU and chip_smoke.py against
sqlite on the card (zero_row_sql_mismatches).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from quickstep_tpu_torch.ops import bloom as B
from quickstep_tpu_torch.ops import cuda
from quickstep_tpu_torch.ops import groupby as G
from quickstep_tpu_torch.ops import join as J
from quickstep_tpu_torch.ops import kernels as K
from quickstep_tpu_torch.ops import sort as S
from quickstep_tpu_torch.ops import window as W
from quickstep_tpu_torch.parallel import shuffle as SH

Case = Tuple[Callable[[], tuple], Callable[[], tuple]]

ZERO_ROW_SCRIPT = [
    "CREATE TABLE full_t (id INT, score DOUBLE, tag VARCHAR(4))",
    "CREATE TABLE empty_t (id INT, score DOUBLE, tag VARCHAR(4))",
    "INSERT INTO full_t VALUES (1, 1.5, 'a'), (2, NULL, 'b'), (NULL, 3.5, "
    "'c'), (4, 4.5, NULL)",
]
ZERO_ROW_QUERIES = {
    # the statement that crashed the port before the repair
    "inner_empty_build_or_filter":
        "SELECT e.id, f.tag FROM full_t f JOIN empty_t e ON f.id = e.id "
        "WHERE f.id > 0 OR f.id < 0",
    "inner_empty_probe": "SELECT f.id FROM empty_t e JOIN full_t f "
                         "ON e.id = f.id",
    "left_empty_build": "SELECT f.id, e.score, e.tag FROM full_t f LEFT JOIN "
                        "empty_t e ON f.id = e.id",
    "left_empty_build_residual": "SELECT f.id, e.tag FROM full_t f LEFT JOIN "
                                 "empty_t e ON f.id = e.id AND e.score > 1",
    "full_empty_side": "SELECT f.id, e.id FROM full_t f FULL JOIN empty_t e "
                       "ON f.id = e.id",
    "semi_empty": "SELECT id FROM full_t WHERE EXISTS (SELECT * FROM empty_t "
                  "WHERE empty_t.id = full_t.id)",
    "anti_empty": "SELECT id FROM full_t WHERE NOT EXISTS (SELECT * FROM "
                  "empty_t WHERE empty_t.id = full_t.id)",
    "not_in_empty": "SELECT id FROM full_t WHERE id NOT IN (SELECT id FROM "
                    "empty_t)",
    "in_empty": "SELECT id FROM full_t WHERE id IN (SELECT id FROM empty_t)",
    "anti_residual_empty": "SELECT id FROM full_t WHERE NOT EXISTS (SELECT * "
                           "FROM empty_t WHERE empty_t.id = full_t.id AND "
                           "empty_t.score <> full_t.score)",
    "nested_loops_left_empty": "SELECT f.id, e.id FROM full_t f LEFT JOIN "
                               "empty_t e ON f.score < e.score",
    "cross_empty": "SELECT count(*) FROM full_t, empty_t",
    "scalar_aggs_empty": "SELECT count(*), sum(score), min(id), max(tag), "
                         "avg(score), count(distinct id), sum(distinct score) "
                         "FROM empty_t",
    "group_by_empty": "SELECT tag, count(*), sum(score) FROM empty_t "
                      "GROUP BY tag",
    "distinct_empty": "SELECT DISTINCT tag FROM empty_t",
    "window_empty": "SELECT id, sum(score) OVER (PARTITION BY tag ORDER BY "
                    "id) FROM empty_t",
    "order_limit_empty": "SELECT id, score FROM empty_t ORDER BY score DESC, "
                         "id LIMIT 3",
    "subquery_sort_limit_empty": "SELECT count(*) FROM (SELECT id FROM "
                                 "empty_t ORDER BY score LIMIT 2) t",
    "union_empty": "SELECT id, tag FROM full_t UNION SELECT id, tag "
                   "FROM empty_t",
    "intersect_empty": "SELECT id FROM full_t INTERSECT SELECT id FROM "
                       "empty_t",
    "except_empty": "SELECT id, tag FROM full_t EXCEPT SELECT id, tag "
                    "FROM empty_t",
    "scalar_subquery_empty": "SELECT id FROM full_t WHERE id > (SELECT "
                             "max(id) FROM empty_t)",
    "join_after_empty_filter": "SELECT f.id, g.tag FROM full_t f JOIN "
                               "full_t g ON f.id = g.id WHERE g.id > 100",
    # the empty table's VARCHAR column as a LIKE operand, in an IN list, a
    # join key, a subquery's key and a set operation's column
    "like_varchar_empty": "SELECT id FROM empty_t WHERE tag LIKE '%a%'",
    "in_list_varchar_empty": "SELECT id FROM empty_t WHERE tag IN ('a', "
                             "'zz', '')",
    "join_varchar_empty": "SELECT f.id, e.id FROM full_t f JOIN empty_t e "
                          "ON f.tag = e.tag",
    "exists_varchar_empty": "SELECT id FROM full_t WHERE EXISTS (SELECT * "
                            "FROM empty_t WHERE empty_t.tag = full_t.tag)",
    "not_exists_varchar_empty": "SELECT id FROM full_t WHERE NOT EXISTS "
                                "(SELECT * FROM empty_t WHERE empty_t.tag = "
                                "full_t.tag)",
    "not_in_varchar_empty": "SELECT id FROM full_t WHERE tag NOT IN (SELECT "
                            "tag FROM empty_t)",
    "left_join_varchar_empty": "SELECT f.id, e.tag FROM full_t f LEFT JOIN "
                               "empty_t e ON f.tag = e.tag",
    "union_all_varchar_empty": "SELECT id, tag FROM full_t UNION ALL SELECT "
                               "id, tag FROM empty_t",
    "intersect_varchar_empty": "SELECT tag FROM full_t INTERSECT SELECT tag "
                               "FROM empty_t",
}


def zero_row_sql_mismatches(device) -> List[str]:
    """Each of ZERO_ROW_QUERIES through the port on `device` after
    ZERO_ROW_SCRIPT, against sqlite after the same script: the cases whose
    rows differ (as multisets, in order under an ORDER BY; floats within
    rel 1e-9)."""
    import math
    import sqlite3
    from quickstep_tpu_torch import Database

    def same(a, b):
        return len(a) == len(b) and all(
            x == y or (isinstance(x, float) and isinstance(y, float) and
                       math.isclose(x, y, rel_tol=1e-9))
            for ra, rb in zip(a, b) for x, y in zip(ra, rb))

    def key(row):
        return tuple((v is None, v) for v in row)
    db, conn = Database(device=device), sqlite3.connect(":memory:")
    bad = []
    try:
        for stmt in ZERO_ROW_SCRIPT:
            db.execute(stmt)
            conn.execute(stmt)
        for name, sql in ZERO_ROW_QUERIES.items():
            ours = [tuple(r) for r in db.execute(sql).rows]
            want = [tuple(r) for r in conn.execute(sql).fetchall()]
            if "ORDER BY" not in sql:
                ours, want = sorted(ours, key=key), sorted(want, key=key)
            if not same(ours, want):
                bad.append(f"{name}: {ours} != sqlite {want}")
    finally:
        db.close()
    return bad


def zero_row_cases(dev) -> Dict[str, Case]:
    """{kernel name: (kernel call, plain call)}; each call returns a tuple
    of tensors."""
    def e(dtype):
        return torch.zeros(0, dtype=dtype, device=dev)

    i32, i64, f64, b = (e(torch.int32), e(torch.int64), e(torch.float64),
                        e(torch.bool))
    probe = torch.arange(5, dtype=torch.int64, device=dev)
    probe32 = probe.to(torch.int32)
    pmask = torch.ones(5, dtype=torch.bool, device=dev)
    skey, order = J.sorted_build(i64, b)

    def scalar(agg):
        return tuple(t for fn in ("sum", "count", "min", "max", "avg")
                     for t in agg(fn, f64, None, b))

    def dense(agg, packed):
        specs = [("sum", f64, None), ("min", i64, None), ("avg", i32, b),
                 ("count", None, None)]
        occ, res = agg(i64, 6, specs, b)
        occ2, res2 = packed([i32, b, e(torch.int8)], [1, 0, -2], [2, 1, 1],
                            6, specs, b)
        return (occ, occ2) + tuple(t for r in res + res2 for t in r)

    def direct(build, probe_fn):
        # the table of an empty build is not empty: the probe side is
        table, dup = build(i32, b, 4, 16)
        return (J.direct_table(table, 16), dup) + tuple(
            probe_fn(table, i32, b, 4, 16))

    def sort_gb(fn):
        keys, valids, last, n_groups, res = fn([i64], [None],
                                               [("sum", f64, None)], b,
                                               packed_key=i64)
        return (*keys, last, n_groups, *res[0])

    seg_lo, seg_hi = i32, i32
    return {
        "scalar_agg": (lambda: scalar(G.scalar_agg),
                       lambda: scalar(G.scalar_agg_plain)),
        "dense_groupby": (lambda: dense(G.dense_groupby, G.dense_aggregate),
                          lambda: dense(G.dense_groupby_plain,
                                        G.dense_aggregate_plain)),
        "direct_join": (lambda: direct(J.direct_build, J.direct_probe),
                        lambda: direct(J.direct_build_plain,
                                       J.direct_probe_plain)),
        "merge_unique_probe": (
            lambda: J.merge_unique_probe(i64, b, probe, pmask),
            lambda: J.merge_unique_probe_plain(i64, b, probe, pmask)),
        "sort_groupby": (lambda: sort_gb(G.sort_groupby),
                         lambda: sort_gb(G.sort_groupby_plain)),
        "multi_gather": (lambda: tuple(K.multi_gather([f64, i32], probe)),
                         lambda: tuple(K.multi_gather_plain([f64, i32],
                                                            probe))),
        "multi_gather_packed": (
            lambda: tuple(K.multi_gather([f64, i32], probe, random=True)),
            lambda: tuple(K.multi_gather_plain([f64, i32], probe))),
        "expand_probe": (
            lambda: J.expand_probe(skey, order, probe, pmask, 4),
            lambda: J.expand_probe_plain(skey, order, probe, pmask, 4)),
        # an empty build under the probe rows, then the probe rows as the
        # build over an empty probe side
        "merge_cmp_probe": (
            lambda: (J.merge_cmp_probe(i64, b, i32, probe, pmask, probe32,
                                       "<>"),
                     *J.merge_stats_probe(i64, b, i32, probe, pmask),
                     *J.merge_stats_probe(probe, pmask, probe32, i64, b)),
            lambda: (J.merge_cmp_probe_plain(i64, b, i32, probe, pmask,
                                             probe32, "<>"),
                     *J.merge_stats_probe_plain(i64, b, i32, probe, pmask),
                     *J.merge_stats_probe_plain(probe, pmask, probe32, i64,
                                                b))),
        # and a head of no rows of a mask that has some
        "sort_groupby_compact": (
            lambda: (K.stable_partition(b), K.stable_partition(b, limit=3),
                     K.stable_partition(pmask, limit=0)),
            lambda: (K.compact_order(b), K.compact_order(b)[:3],
                     K.compact_order(pmask)[:0])),
        "window_prefix": (
            lambda: W.segmented_prefix("sum", f64, b, b, b) +
            W.segment_totals("max", f64, b, b),
            lambda: W.segmented_prefix_plain("sum", f64, b, b, b) +
            W.segmented_prefix_plain("max", f64, b, b, b)),
        "frame_minmax": (
            lambda: (W.frame_minmax("max", f64, seg_lo, seg_hi),),
            lambda: (W.frame_minmax_plain("max", f64, seg_lo, seg_hi),)),
        "frame_bounds": (
            lambda: W.frame_bounds(b, "range", 3, 3, f64),
            lambda: W.frame_bounds_plain(b, "range", 3, 3, f64)),
        "sliding_sum": (
            lambda: (W.sliding_sums(f64, seg_lo, seg_hi, b),),
            lambda: (W.sliding_sums_plain(f64, seg_lo, seg_hi, b),)),
        "hash_keys": (lambda: (K.hash_keys([i64, i32]),),
                      lambda: (K.hash_keys_plain([i64, i32]),)),
        # an int64 key takes the key-in-slot route, a float64 key the
        # row-id route
        "open_addressing": (
            lambda: _oa(J.oa_build, J.oa_probe, i64, b, probe, pmask) +
            _oa(J.oa_build, J.oa_probe, f64, b, probe.double(), pmask),
            lambda: _oa(J.oa_build_plain, J.oa_probe_plain, i64, b, probe,
                        pmask) +
            _oa(J.oa_build_plain, J.oa_probe_plain, f64, b, probe.double(),
                pmask)),
        "distinct_sort": (lambda: G._sorted_live(i64, i64 > 0, b),
                          lambda: G._sorted_live_plain(i64, i64 > 0, b)),
        "distinct_count": (
            lambda: (G.distinct_count(f64, None, b),
                     *G.dedup_values(i32, None, b)),
            lambda: (G.distinct_count_plain(f64, None, b),
                     *G.dedup_values_plain(i32, None, b))),
        "order_permutation": (
            lambda: (S.order_permutation([f64, i32], [None, b], [False, True],
                                         [None, True], b),),
            lambda: (S.order_permutation_plain([f64, i32], [None, b],
                                               [False, True], [None, True],
                                               b),)),
        "partition_dest": (
            lambda: (*SH.partition_dest(i64, b, 8, 4),
                     *SH.partition_dest(i32, b, 8, 4, 2, False,
                                        with_counts=True)),
            lambda: (*SH.partition_dest_plain(i64, b, 8, 4),
                     *SH.partition_dest_plain(i32, b, 8, 4, 2, False,
                                              with_counts=True))),
        # the generic route and the shuffle's bucket route
        "scatter_compact": (
            lambda: (K.scatter_compact(f64, i32, 6, fill=-1),
                     K.scatter_compact(b, i64, 3),
                     *SH.bucket_rows(i32, i32[:0].new_zeros(8), 0, 4)),
            lambda: (K.scatter_compact_plain(f64, i32, 6, fill=-1),
                     K.scatter_compact_plain(b, i64, 3),
                     *SH.bucket_rows_plain(i32, i32[:0].new_zeros(8), 0,
                                           4))),
        "bloom_filter": (
            lambda: _bloom(B.bloom_build, B.bloom_probe, i64, i32, b,
                           sized=True),
            lambda: _bloom(B.bloom_build_plain, B.bloom_probe_plain, i64, i32,
                           b)),
    }


def _bloom(build, probe_fn, keys, keys32, alive, sized=False):
    """A 16-slot table and its probe. sized: the probe is told the table's
    slots, and K16's int32 words (its table on the card) are read back as
    the plain version's bools."""
    bits = build([keys, keys32], alive, 16)
    if not sized:
        return bits, probe_fn(bits, [keys, keys32], alive)
    hits = probe_fn(bits, [keys, keys32], alive, 16)
    if bits.dtype == torch.int32:
        bits = B.presence_bits(bits, 16)
    return bits, hits


def _oa(build, probe_fn, keys, alive, probe, pmask):
    table, dup = build([keys], alive, 1)
    return (cuda.oa_table_rows(table), dup) + tuple(
        probe_fn(table, [keys], [probe], pmask))
