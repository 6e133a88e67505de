"""The Executor: statement dispatch, eager plan execution, materialization.

The counterpart of quickstep_tpu/exec/executor.py. A SELECT is resolved and
optimized by the same host layers as the reference, run operator by
operator on torch tensors by PlanRunner, and pulled to the host with one
synchronisation for the live count, the runner's flags and the result. A
set flag (a duplicate build key, an expansion overflow, a compaction
under-estimate) re-runs the plan with an override, which is remembered per
plan shape and table versions (the kOutOfSpace retry of the reference)
and written to the store as learned_overrides.json, so that a new process
takes the corrected plan in one pass. Scalar subqueries run inside the
plan, not as programs of their own as the reference's XLA split has them,
except one over a table larger than half the device memory budget, which
runs first as a plan of its own (and streams).
There is no compile cache: torch runs eagerly. The optimized plan of a
SELECT is kept in _logical_plan_cache, keyed by the statement's structure
without positions, the planning config and every relation's version, and
the cache is emptied after every statement that is not a SELECT.

Under a device memory budget (Config.hbm_budget_bytes) the resident tables
are evicted by the configured policy (storage/eviction.py) to keep them and
the segment cache within the budget, and a plan whose one large table is
over half the budget streams it through the device in row segments
(exec/streaming.py plan_streaming, _run_streamed): each segment's slice of
the host columns is uploaded and runs the plan's partial program on the
same kernels as a resident run, and the partial rows merge on the host or
in one resident run over them. Segments whose min/max rule out a scan
predicate never leave the host.

Over several processes (Config.distributed after parallel/multihost.py's
bootstrap), or several members of one process (parallel/local_group.py,
one Executor a member on the member's thread and device), every process
runs the same statements on the same catalog. A
table at or above replicate_threshold_rows is uploaded as this process's
shards' rows only (multihost.local_rows), a smaller one whole; the plan's
result is gathered to every process, its runtime flags are OR'd over the
processes before the host reads them, so every process retries together,
and every other host decision (the presentation sort, the overrides) is
taken from replicated values. Only process 0 writes the learned
overrides. A statement other than a SELECT ends in a barrier.

DDL, DML and commands run against the catalog on the host, as in the
reference. INSERT ... SELECT runs its SELECT through run_plan and appends
its columns without decoding them where the types match; the predicates and
SET expressions of DELETE and UPDATE are evaluated on the device over the
relation's resident columns. A mutation bumps the relation's version and
drops its device copy, so the next query uploads the new data once.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import os
import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from quickstep_tpu_torch.config import Config
from quickstep_tpu_torch.errors import ExecutionError, ResolutionError
from quickstep_tpu_torch.catalog import (
    Catalog, CatalogAttribute, CatalogRelation, PartitionScheme,
)
from quickstep_tpu_torch.parser import ast_nodes as A
from quickstep_tpu_torch.types import Type, TypeID, TypeFactory
from quickstep_tpu_torch.storage import csv_io
from quickstep_tpu_torch.storage.column import Column, _decode_scalar
from quickstep_tpu_torch.storage.table import TableData
from quickstep_tpu_torch.optimizer import logical as L
from quickstep_tpu_torch.optimizer.resolver import Resolver, Scope
from quickstep_tpu_torch.optimizer.rules import optimize_plan
from quickstep_tpu_torch.exec.runner import JoinOverride, PlanRunner
from quickstep_tpu_torch.exec.result import QueryResult
from quickstep_tpu_torch.expressions.scalar import EvalContext, Lit
from quickstep_tpu_torch.ops import kernels as K
from quickstep_tpu_torch.ops.sort import order_permutation
from quickstep_tpu_torch.parallel import local_group, multihost
from quickstep_tpu_torch.parallel.mesh import (
    all_gather, make_mesh, pad_to_multiple, por)
from quickstep_tpu_torch.storage.eviction import make_policy

# Plan runs per statement before the retry gives up (each run installs at
# least one override, and there are few of them per plan).
MAX_ATTEMPTS = 8
# Plan shapes whose learned overrides are kept (oldest dropped first).
LEARNED_LIMIT = 256
# Optimized plans kept in the logical-plan cache (oldest dropped first).
PLAN_CACHE_LIMIT = 256
# The learned overrides' file in the store directory (Executor.store).
OVERRIDES_FILE = "learned_overrides.json"


class Executor:
    def __init__(self, catalog: Catalog, config: Config, device: torch.device,
                 mesh_shards: Optional[int] = None,
                 store: Optional[str] = None):
        self.catalog = catalog
        self.config = config
        self.device = device
        # the catalog store's directory, where the learned overrides are
        # kept; None for a database on no store
        self.store = store
        # Config.distributed: a mesh of mesh_shards row shards on the device
        # of each process (exec/executor.py:80-87 of the reference, whose
        # mesh is every device JAX sees); nothing probes the hardware for
        # the count
        self.mesh = None
        # the member of a mesh over members that this executor runs (its
        # thread's, parallel/local_group.py), else None
        self.member = local_group.current()
        if self.member is not None and self.member.device != device:
            raise ExecutionError(f"{self.member} runs an executor on "
                                 f"{device}")
        if config.distributed and mesh_shards is not None:
            self.mesh = make_mesh(mesh_shards, device,
                                  config.default_mesh_axis,
                                  group=multihost.world_group())
        # what crossed the processes in the last statement (Mesh.counts:
        # each collective's calls and bytes sent, each gathered operator
        # input); None without a mesh
        self.last_mesh_info: Optional[dict] = None
        # the runtime flags the last plan run produced, by name, with their
        # values (the reference's last_flags)
        self.last_flags: Dict[str, bool] = {}
        # (relation, version) -> (columns on the device, metadata); the
        # metadata's "bytes" are those of the columns uploaded
        self._device_cache: Dict[Tuple[str, int], Tuple[dict, dict]] = {}
        # the eviction policy over _device_cache and the (policy, K) of the
        # config it was made for: _policy makes it anew when they change
        self._eviction = None
        self._eviction_spec: Optional[tuple] = None
        # streamed segments kept on the device under half the budget, the
        # first that fit (the reference's _seg_cache):
        # (relation, version, column, segment, segment rows) ->
        # (data, valid, bytes)
        self._seg_cache: "collections.OrderedDict[tuple, tuple]" = \
            collections.OrderedDict()
        self._seg_cache_bytes = 0
        self._seg_cache_hits = 0
        self._seg_cache_misses = 0
        # the last streamed plan's segments, bytes and times (None when the
        # last plan ran resident), and the bytes of the columns it read
        self.last_stream_info: Optional[dict] = None
        self.last_scan_bytes = 0
        # called between streamed segments (the PolicyEnforcer's
        # _yield_between_segments), so that other sessions' queries run
        self.segment_yield = None
        self._check_config()
        # device->host synchronisations of the last statement
        self.host_syncs = 0
        # plan re-runs of the last statement, after a runtime flag fired
        self.retries = 0
        # where the last SELECT's rows were put in ORDER BY order: "device"
        # (ops/sort.py order_permutation, K13 on the card, under a root
        # ORDER BY ... LIMIT) or "host" (a numpy lexsort after the pull, or
        # no root ORDER BY); the reference's attribute of the same name.
        # The port decides by the LIMIT, before its one host sync, and reads
        # no device_sort_threshold_rows: the reference decides by the
        # pulled row count.
        self.last_sort_path: Optional[str] = None
        # digest of (plan fingerprint, table versions) -> {node index:
        # JoinOverride}; loaded from the store and written back to it
        self._learned_overrides: Dict[str, Dict[int, JoinOverride]] = {}
        # (config, statement structure, relation versions) -> optimized
        # plan: a repeated SELECT skips resolve and optimize. The reference
        # (exec/executor.py:211-227) clears its cache before a mutating
        # statement, so the plan of INSERT ... SELECT's inner SELECT
        # outlives the insert, and keys it on the statement's repr, line
        # and column positions included; this one is cleared after the
        # statement and keys on the structure alone.
        self._logical_plan_cache: Dict[tuple, L.LogicalNode] = {}
        self._load_overrides()

    def preload(self) -> None:
        """Upload every relation to the device (PreloaderThread analog,
        flag preload_buffer_pool)."""
        use_device(self.device)
        for rel in self.db.relations.values():
            self._device_table(rel, None)

    @property
    def db(self):
        return self.catalog.default_database

    # ================================================================
    # statement dispatch
    # ================================================================
    def _check_config(self) -> None:
        """Refuse a distributed run without its shard count, a mesh over
        members without Config.distributed or within a torch.distributed
        group (processes x members is not ported), and take the eviction
        policy the config names now (an unknown one raises)."""
        self._policy()
        if self.member is not None:
            if not self.config.distributed:
                raise ExecutionError(
                    "a mesh over members (mesh_devices) needs "
                    "Config.distributed = True")
            if multihost.processes() > 1:
                raise ExecutionError(
                    "mesh_devices in a process of a torch.distributed group: "
                    "a mesh spans either the processes (one device each) "
                    "or the members of one process, not both")
        if self.config.distributed and self.mesh is None:
            raise ExecutionError(
                "distributed = True needs the mesh's shard count: "
                "Database(config, device=..., mesh_shards=n), n shards of "
                "this process's device (after multihost.bootstrap, of each "
                "process's)")

    def execute_statement(self, stmt: A.Statement) -> QueryResult:
        t0 = time.perf_counter()
        self._check_config()
        use_device(self.device)
        self.host_syncs = 0
        self.retries = 0
        if self.mesh is not None:
            self.mesh.reset_counts()
        if isinstance(stmt, A.SelectStmt):
            res = self._run_select(stmt)
        else:
            try:
                res = self._run_statement(stmt)
            finally:
                # plans embed data-derived state (dictionary bitmaps,
                # statistics-chosen joins, constant folds): drop them all,
                # those made while this statement ran included
                self._logical_plan_cache.clear()
            # every process's catalog has taken the statement (the
            # reference's commit ordering)
            multihost.barrier()
        if self.mesh is not None:
            self.last_mesh_info = self.mesh.counts()
        res.execution_time = time.perf_counter() - t0
        return res

    def _run_statement(self, stmt: A.Statement) -> QueryResult:
        """A statement that is not a SELECT: DDL, DML, COPY or a command."""
        if isinstance(stmt, A.CreateTableStmt):
            res = self._create_table(stmt)
        elif isinstance(stmt, A.CreateIndexStmt):
            res = self._create_index(stmt)
        elif isinstance(stmt, A.DropTableStmt):
            rel = self.db.get_relation(stmt.name)
            self.db.drop_relation(stmt.name)
            if rel is not None:
                self._drop_device_copy(rel.name)
            res = QueryResult([], [], [], message=f"Table {stmt.name} dropped.")
        elif isinstance(stmt, A.InsertStmt):
            res = self._insert(stmt)
        elif isinstance(stmt, A.UpdateStmt):
            res = self._update(stmt)
        elif isinstance(stmt, A.DeleteStmt):
            res = self._delete(stmt)
        elif isinstance(stmt, A.CopyStmt):
            res = self._copy(stmt)
        elif isinstance(stmt, A.CommandStmt):
            res = self._command(stmt)
        else:
            raise ExecutionError(f"unsupported statement {type(stmt).__name__}")
        return res

    # ================================================================
    # SELECT
    # ================================================================
    def _run_select(self, stmt: A.SelectStmt) -> QueryResult:
        rows, names, types = self.run_plan(self.plan_select(stmt))
        return QueryResult(names, types, rows)

    def plan_select(self, stmt: A.SelectStmt) -> L.LogicalNode:
        """The optimized plan of a SELECT: from _logical_plan_cache when an
        earlier SELECT had the same structure under the same planning
        config (profile_device_reps left out: nothing plans with it) and
        every relation the same version, else resolved and optimized and
        kept there."""
        cfg = dataclasses.replace(self.config, profile_device_reps=0)
        key = (repr(cfg), _statement_key(stmt),
               tuple(sorted((name, rel.version)
                            for name, rel in self.db.relations.items())))
        plan = self._logical_plan_cache.get(key)
        if plan is None:
            plan = optimize_plan(Resolver(self.db).resolve_select(stmt),
                                 self.config, self.db)
            while len(self._logical_plan_cache) >= PLAN_CACHE_LIMIT:
                self._logical_plan_cache.pop(
                    next(iter(self._logical_plan_cache)))
            self._logical_plan_cache[key] = plan
        return plan

    # ----------------------------------------------------------------
    # learned overrides in the store
    # ----------------------------------------------------------------
    def _overrides_path(self) -> Optional[str]:
        return os.path.join(self.store, OVERRIDES_FILE) if self.store else None

    def _load_overrides(self) -> None:
        """Read the store's learned overrides (the reference's
        _load_overrides); a file that cannot be read is ignored, and its
        overrides are learned again."""
        path = self._overrides_path()
        if path is None or not os.path.exists(path):
            return
        try:
            with open(path) as f:
                raw = json.load(f)
            loaded = {str(key): {int(nid): JoinOverride(**fields)
                                 for nid, fields in ovs.items()}
                      for key, ovs in raw.items()}
        except (OSError, ValueError, TypeError, AttributeError):
            return
        self._learned_overrides.update(loaded)

    def _save_overrides(self) -> None:
        """Write the learned overrides into the store directory, which must
        exist: none is created (the reference's open fails without one).
        Over several processes only the conductor writes; every process
        learns the same overrides, from the same flags."""
        path = self._overrides_path()
        if path is None or not os.path.isdir(os.path.dirname(path) or ".") \
                or not multihost.is_conductor():
            return
        raw = {key: {str(nid): dataclasses.asdict(ov)
                     for nid, ov in ovs.items()}
               for key, ovs in self._learned_overrides.items()}
        try:
            with open(path + ".tmp", "w") as f:
                json.dump(raw, f)
            os.replace(path + ".tmp", path)
        except OSError:
            pass

    def run_plan(self, plan: L.LogicalNode, columns: bool = False):
        """Execute a logical plan; returns (rows, names, types), or with
        columns=True (host columns, names, types): one (attr, data, valid)
        numpy triple per output column, in output order, undecoded. Under a
        device memory budget a plan whose one large table is over half the
        budget streams it (_run_streamed); a plan with such a table and no
        streamable shape raises under strict_hbm_budget, mesh or not, and
        otherwise runs resident."""
        from quickstep_tpu_torch.exec import streaming as S
        self.last_stream_info = None
        sp = S.plan_streaming(plan, self.db, self.config, self.mesh)
        if sp is not None:
            return self._run_streamed(sp, columns)
        budget = self.config.hbm_budget_bytes
        if budget > 0 and self.config.strict_hbm_budget:
            over = [name for name, cols in S._needed_columns(plan).items()
                    if self._over_half_budget(name, cols)]
            if over:
                raise ExecutionError(
                    f"table(s) {', '.join(sorted(over))} exceed half the "
                    f"device memory budget ({budget} bytes) and the plan has "
                    "no streamable shape (the big table must be reachable "
                    "through Filter/Project/Distinct/probe-side join edges "
                    "and be scanned exactly once); raise hbm_budget_bytes, "
                    "set strict_hbm_budget=False to attempt resident "
                    "execution, or restructure the query")
        return self._run_plan_resident(plan, columns)

    def _over_half_budget(self, name: str, cols) -> bool:
        from quickstep_tpu_torch.exec import streaming as S
        rel = self.db.get_relation(name)
        return rel is not None and rel.data is not None and \
            S._table_bytes(rel, cols) > self.config.hbm_budget_bytes // 2

    def _run_plan_resident(self, plan: L.LogicalNode, columns: bool = False,
                           subqueries: Optional[dict] = None,
                           learn: bool = True):
        """Run a plan with its tables resident. subqueries: the values of
        scalar subqueries already run (_stream_subqueries; found here when
        None). learn=False neither reads nor writes learned overrides (a
        merge plan over the temporary partials relation)."""
        # Peel a root-level presentation Sort off the device plan: encoded
        # column values (dict codes, packed dates) are order-preserving, so a
        # stable sort of the codes is exact. Under ORDER BY ... LIMIT it runs
        # on the device and only the kept rows are pulled; otherwise the
        # result is pulled whole and sorted by a numpy lexsort on the host.
        from quickstep_tpu_torch.expressions.scalar import Attr
        host_sort: Optional[L.Sort] = None
        device_plan = plan
        if isinstance(device_plan, L.Project) and \
                isinstance(device_plan.input, L.Sort) and \
                all(isinstance(e, Attr) for e in device_plan.exprs):
            # trim-Project over Sort (hidden sort keys below)
            host_sort = device_plan.input
            final_attrs = device_plan.attrs
            trim_ids = [e.expr_id for e in device_plan.exprs]
            device_plan = device_plan.input.input
        elif isinstance(device_plan, L.Sort):
            host_sort = device_plan
            final_attrs = list(device_plan.output)
            trim_ids = [a.expr_id for a in final_attrs]
            device_plan = device_plan.input

        if subqueries is None:
            subqueries = self._stream_subqueries(device_plan)
        inputs, meta = self._collect_inputs(device_plan, subqueries)
        # Runtime corrections (duplicate build keys, expansion overflows,
        # compaction under-estimates) are remembered per plan shape and table versions,
        # so a warm re-run takes the corrected plan in one pass; the key is
        # a digest of the two, the same in every process (versions persist
        # with the catalog), so that the store can keep it.
        learn_key = hashlib.sha256(repr((
            _fingerprint(device_plan),
            tuple(sorted((k, m["version"]) for k, m in meta.items()))
        )).encode()).hexdigest() if learn else None
        overrides = {k: dataclasses.replace(v) for k, v in
                     self._learned_overrides.get(learn_key, {}).items()}
        datas, valids, n, sorted_on_device = self._run_attempts(
            device_plan, inputs, meta, overrides, host_sort, learn_key,
            subqueries)
        self.last_sort_path = "device" if sorted_on_device else "host"
        out_attrs = device_plan.output
        by_id = {a.expr_id: (a, d, v)
                 for a, d, v in zip(out_attrs, datas, valids)}
        if host_sort is None:
            order, final_attrs = np.arange(n), out_attrs
            trim_ids = [a.expr_id for a in out_attrs]
        elif sorted_on_device:
            order = np.arange(n)
        else:
            order = _host_sort_order(host_sort, by_id, n)
        return self._finish(by_id, order, final_attrs, trim_ids, columns)

    def _run_attempts(self, device_plan, inputs, meta, overrides,
                      host_sort=None, learn_key=None, subqueries=None):
        """Run the plan and pull its result, re-running it with the
        overrides that answer each runtime flag that fired (they stay in
        `overrides`, so the next segment of a stream starts with them);
        with a learn_key they are also learned, and written to the store.
        Returns _pull_outputs' (datas, valids, n, sorted_on_device)."""
        out_attrs = device_plan.output
        for _attempt in range(MAX_ATTEMPTS):
            runner = PlanRunner(device_plan, inputs, meta, self.config,
                                self.device, overrides, mesh=self.mesh,
                                subqueries=subqueries)
            chunk = runner.result(device_plan)
            fired, pulled = self._pull_outputs(device_plan, chunk, out_attrs,
                                               runner.flags, host_sort)
            if not fired:
                return pulled
            self.retries += 1
            self._install_overrides(fired, overrides)
            if learn_key is None:
                continue
            while len(self._learned_overrides) >= LEARNED_LIMIT:
                self._learned_overrides.pop(next(iter(self._learned_overrides)))
            self._learned_overrides[learn_key] = {
                k: dataclasses.replace(v) for k, v in overrides.items()}
            self._save_overrides()
        raise ExecutionError("join fallback did not converge")

    def _finish(self, by_id, order, final_attrs, trim_ids, columns):
        """The result in `order`: decoded rows (_trim_rows), or with
        columns=True the undecoded host columns."""
        if columns:
            cols = []
            for fa, tid in zip(final_attrs, trim_ids):
                _a, d, v = by_id[tid]
                cols.append((fa, d[order], None if v is None else v[order]))
            return cols, [a.name for a in final_attrs], \
                [a.type for a in final_attrs]
        return self._trim_rows(by_id, order, final_attrs, trim_ids)

    def _stream_subqueries(self, plan, streams: Optional[list] = None
                           ) -> Dict[tuple, tuple]:
        """Run first, as plans of their own, the uncorrelated scalar
        subqueries under `plan` that read a table over half the device
        memory budget, so that run_plan streams them (or refuses them)
        instead of the runner uploading that table whole. Returns the
        runner's subquery slots for them: ("subquery", id(subplan)) ->
        (value, present), 0-d device tensors of the raw encoding. Their
        last_stream_info go to `streams`."""
        from quickstep_tpu_torch.expressions.subquery import SubqueryScalar
        bound: Dict[tuple, tuple] = {}
        if self.config.hbm_budget_bytes <= 0:
            return bound
        stack = [plan]
        while stack:
            node = stack.pop()
            stack.extend(node.children())
            exprs = list(_node_exprs(node))
            while exprs:
                x = exprs.pop()
                exprs.extend(x.children())
                if not isinstance(x, SubqueryScalar) or \
                        ("subquery", id(x.plan)) in bound:
                    continue
                if not any(self._over_half_budget(name, cols) for name, cols
                           in _tables_read(x.plan).items()):
                    stack.append(x.plan)
                    continue
                saved = self.last_stream_info
                cols, _names, _types = self.run_plan(x.plan, columns=True)
                if streams is not None and self.last_stream_info is not None:
                    streams.append(self.last_stream_info)
                self.last_stream_info = saved
                attr, d, v = cols[0]
                dtype = K.torch_dtype(attr.type.device_dtype)
                if len(d):
                    value = torch.from_numpy(np.asarray(d[:1])).to(
                        self.device)[0]
                    present = v is None or bool(v[0])
                else:
                    value = torch.zeros((), dtype=dtype, device=self.device)
                    present = False
                bound[("subquery", id(x.plan))] = (value, torch.tensor(
                    present, dtype=torch.bool, device=self.device))
        return bound

    # ----------------------------------------------------------------
    # out-of-core segment streaming (see exec/streaming.py)
    # ----------------------------------------------------------------
    def _run_streamed(self, sp, columns: bool = False):
        """Stream sp.big_table through the device in segments of sp.seg_rows
        rows: its build sides resident, each segment's columns uploaded (or
        taken from the segment cache) and run through sp.partial_plan with
        one pull; the overrides a segment's flags install carry to the next.
        The partial rows are then sorted on the host (_try_stream_sort) or
        become the temporary relation PARTIALS_REL, which sp.merge_plan
        reads in one resident run and which is dropped with its device copy
        after it. The relation is read as it stood when the stream began,
        whatever a statement run between segments (segment_yield) does."""
        from quickstep_tpu_torch.exec import streaming as S
        rel = self.db.get_relation(sp.big_table)
        snap = _Snapshot(rel)
        needed = S._needed_columns(sp.partial_plan)
        big_cols = sorted(needed[sp.big_table])

        # resident (build-side) tables: the normal cached path
        res_inputs, res_meta = {}, {}
        for name, cols in needed.items():
            if name == sp.big_table:
                continue
            c, m = self._device_table(self.db.get_relation(name), cols)
            sub = {x: c[x] for x in cols}
            sub["__num_rows__"] = c["__num_rows__"]
            res_inputs[name], res_meta[name] = sub, m

        seg_meta = self._segment_meta(rel, big_cols)
        overrides: Dict[int, JoinOverride] = {}
        nattrs = len(sp.partial_attrs)
        partial_np: List[List[np.ndarray]] = [[] for _ in range(nattrs)]
        partial_valid: List[List[Optional[np.ndarray]]] = \
            [[] for _ in range(nattrs)]
        segments: List[dict] = []
        prober = S.AdaptiveProber(len(sp.scan_filters))
        for seg in range(sp.n_segments):
            if self.segment_yield is not None:
                # other sessions' queries run here; this statement's counts
                # are its own
                counts = (self.host_syncs, self.retries)
                self.segment_yield()
                self.host_syncs, self.retries = counts
            if not S.segment_survives(sp.scan_filters, sp.scan_attr_cols,
                                      snap, seg, sp.seg_rows, sp.n_segments,
                                      prober=prober):
                continue   # SMA skip: bytes never leave the host
            t0 = time.perf_counter()
            seg_inputs, seg_bytes, upload_s = self._segment_inputs(
                snap, big_cols, seg, sp.seg_rows)
            rows = seg_inputs["__num_rows__"]
            inputs = dict(res_inputs)
            inputs[sp.big_table] = seg_inputs
            meta = dict(res_meta)
            meta[sp.big_table] = dict(seg_meta, capacity=rows, rows=rows)
            datas, valids, n, _ = self._run_attempts(
                sp.partial_plan, inputs, meta, overrides)
            # free this segment's columns before the next one is uploaded
            del inputs, seg_inputs
            for i in range(nattrs):
                partial_np[i].append(datas[i])
                partial_valid[i].append(valids[i])
            segments.append({"segment": seg, "rows": rows, "bytes": seg_bytes,
                             "upload_s": upload_s, "partial_rows": n,
                             "seconds": time.perf_counter() - t0})

        bytes_streamed = sum(s["bytes"] for s in segments)
        info = {"segments": sp.n_segments, "segments_run": len(segments),
                "seg_rows": sp.seg_rows, "bytes_streamed": bytes_streamed,
                "seg_cache_hits": self._seg_cache_hits,
                "seg_cache_misses": self._seg_cache_misses,
                "probe_order": prober.order(),
                "probe_evaluations": prober.evaluations,
                "probe_rejects": list(prober.rejects),
                "per_segment": segments}
        # sort-only merge: a host merge of the streamed runs (the external
        # sort: no device run at the whole table's size)
        sorted_out = self._try_stream_sort(sp, partial_np, partial_valid,
                                           columns)
        if sorted_out is not None:
            self.last_scan_bytes = bytes_streamed
            self.last_stream_info = dict(info, mode="stream_sort")
            return sorted_out

        # the scalar subqueries over a large table run before the partials
        # relation exists (they may stream too, through their own)
        subquery_streams: List[dict] = []
        bound = self._stream_subqueries(sp.merge_plan, subquery_streams)
        cols = {}
        for a, segs, vsegs in zip(sp.partial_attrs, partial_np,
                                  partial_valid):
            data, valid = _concat_segments(a, segs, vsegs)
            cols[a.name] = Column(a.type, data, valid, a.dictionary)
        del partial_np, partial_valid
        tmp = CatalogRelation(S.PARTIALS_REL, [
            CatalogAttribute(a.name, a.type) for a in sp.partial_attrs])
        tmp.set_data(TableData(cols))
        if self.db.get_relation(S.PARTIALS_REL) is not None:
            self.db.drop_relation(S.PARTIALS_REL)
        self.db.add_relation(tmp)
        try:
            result = self._run_plan_resident(sp.merge_plan, columns,
                                             subqueries=bound, learn=False)
        finally:
            self.db.drop_relation(S.PARTIALS_REL)
            self._drop_device_copy(S.PARTIALS_REL)
        # bytes actually streamed + the resident tables
        self.last_scan_bytes = bytes_streamed + sum(
            S._table_bytes(self.db.get_relation(nm), cs)
            for nm, cs in needed.items() if nm != sp.big_table)
        self.last_stream_info = dict(info, mode="merge",
                                     subqueries=subquery_streams)
        return result

    def _column_meta(self, rel, cname: str, ranges: dict,
                     unique_cols: set) -> None:
        """Add column cname's value range (integer columns: from exact
        statistics, a dictionary's code range, else the whole column's live
        values) and uniqueness to ranges and unique_cols."""
        st = rel.statistics
        attr = rel.attribute_by_name(cname)
        col = rel.data.columns[cname]
        arr = np.asarray(col.data)
        if np.issubdtype(arr.dtype, np.integer):
            if st.exact and cname in st.min_values and \
                    not col.type.is_string:
                ranges[cname] = (int(st.min_values[cname]),
                                 int(st.max_values[cname]))
            elif col.type.is_string and col.dictionary is not None:
                # dict codes live in [0, |dict|): a conservative range
                ranges[cname] = (0, max(len(col.dictionary) - 1, 0))
            elif arr.size:
                lv = arr if col.valid is None else arr[np.asarray(col.valid)]
                if lv.size:
                    ranges[cname] = (int(lv.min()), int(lv.max()))
        if attr.unique or (st.exact and st.num_tuples and
                           st.num_distinct.get(cname) == st.num_tuples):
            unique_cols.add(cname)

    def _segment_meta(self, rel, colnames) -> dict:
        """The metadata every segment shares (the caller adds each one's
        capacity and rows): the whole relation's ranges, uniqueness, unique
        pairs and heaviest-value counts, which hold for any subset of its
        rows, so that every segment takes the same join and GROUP BY
        routes."""
        st = rel.statistics
        ranges: dict = {}
        unique_cols: set = set()
        for cname in colnames:
            self._column_meta(rel, cname, ranges, unique_cols)
        return {"ranges": ranges, "unique_cols": unique_cols,
                "version": rel.version, "bytes": 0,
                "unique_pairs": [tuple(p) for p in st.unique_pairs]
                if st.exact else [],
                "max_counts": dict(st.max_counts) if st.exact else {}}

    def _segment_inputs(self, snap, colnames, seg: int, seg_rows: int):
        """Host-to-device upload of one row segment, a slice of each host
        column (no padded copy). Segments are kept on the device under half
        the budget, less what the resident tables hold, the first that fit
        (streamed access is cyclic, where LRU would evict each segment just
        before its next use), so a warm run starts with cache hits; only a
        snapshot of the relation's current version is kept. Returns (the
        segment's inputs, bytes uploaded, seconds of the upload)."""
        start = seg * seg_rows
        end = min(start + seg_rows, snap.data.num_rows)
        budget = self.config.hbm_budget_bytes
        current = snap.version == snap.rel.version
        dev = {}
        nbytes = 0
        t0 = time.perf_counter()
        for c in colnames:
            key = (snap.name, snap.version, c, seg, seg_rows)
            hit = self._seg_cache.get(key)
            if hit is not None:
                self._seg_cache.move_to_end(key)
                dev[c] = hit[:2]
                self._seg_cache_hits += 1
                continue
            col = snap.data.columns[c]
            data = _upload(np.asarray(col.data)[start:end], self.device)
            valid = None if col.valid is None else _upload(
                np.asarray(col.valid, dtype=bool)[start:end], self.device)
            entry = _nbytes(data) + _nbytes(valid)
            nbytes += entry
            dev[c] = (data, valid)
            self._seg_cache_misses += 1
            if not budget or not current:
                continue
            for k in [k for k in self._seg_cache if k[0] == snap.name and
                      k[2] == c and k[1] != snap.version]:
                self._seg_cache_bytes -= self._seg_cache.pop(k)[2]
            room = min(budget // 2, budget - self._resident_bytes())
            if self._seg_cache_bytes + entry <= room:
                self._seg_cache[key] = (data, valid, entry)
                self._seg_cache_bytes += entry
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        dev["__num_rows__"] = end - start
        return dev, nbytes, time.perf_counter() - t0

    def _try_stream_sort(self, sp, partial_np, partial_valid,
                         columns: bool = False):
        """Out-of-core ORDER BY (the reference's _try_stream_sort,
        SortMergeRunOperator analog): when a row-streamed plan's merge is
        nothing but Sort (and a trim Project) over the streamed partials,
        the host lexsort of the partial rows replaces a temporary relation
        and a device run at the whole result's size. Returns run_plan's
        result, or None when the merge is not sort-only."""
        from quickstep_tpu_torch.exec import streaming as S
        from quickstep_tpu_torch.expressions.scalar import Attr
        plan = sp.merge_plan
        trim = None
        if isinstance(plan, L.Project) and isinstance(plan.input, L.Sort) \
                and all(isinstance(e, Attr) for e in plan.exprs):
            trim = plan
            plan = plan.input
        if not isinstance(plan, L.Sort):
            return None
        restore = plan.input
        if not (isinstance(restore, L.Project) and
                isinstance(restore.input, L.TableScan) and
                restore.input.relation_name == S.PARTIALS_REL and
                all(isinstance(e, Attr) for e in restore.exprs)):
            return None
        if not all(isinstance(k, Attr) for k in plan.keys):
            return None
        by_id = {}
        for a, segs, vsegs in zip(sp.partial_attrs, partial_np,
                                  partial_valid):
            data, valid = _concat_segments(a, segs, vsegs)
            by_id[a.expr_id] = (a, data, valid)
        # restore's attrs carry the display names/dictionaries under the
        # same expr_ids as the partials
        for ra, re in zip(restore.attrs, restore.exprs):
            if re.expr_id in by_id:
                _, d, v = by_id[re.expr_id]
                by_id[ra.expr_id] = (ra, d, v)
        n = next((len(d) for _, d, _ in by_id.values()), 0)
        order = _host_sort_order(plan, by_id, n)
        self.last_sort_path = "host"
        if trim is not None:
            final_attrs = trim.attrs
            trim_ids = [e.expr_id for e in trim.exprs]
        else:
            final_attrs = list(plan.output)
            trim_ids = [a.expr_id for a in final_attrs]
        return self._finish(by_id, order, final_attrs, trim_ids, columns)

    @staticmethod
    def _install_overrides(fired: List[str], overrides) -> None:
        """Answer the flags that fired with overrides for the re-run (the
        reference's _check_flags)."""
        for key in fired:
            kind, node_id = key.rsplit("_", 1)
            node_id = int(node_id)
            prev = overrides.get(node_id) or JoinOverride()
            if kind == "join_dup":
                # duplicate build keys: the expansion join
                prev.strategy = "expand"
            elif kind == "join_overflow":
                # a run of equal build keys is longer than the expansion
                # width: re-run with four times the width
                prev.strategy = "expand"
                prev.max_matches = (prev.max_matches or 8) * 4
            elif kind == "shuffle_overflow":
                # a radix-exchange bucket overflowed (a skewed partition):
                # re-run with four times the bucket capacity
                prev.shuffle_factor = max(prev.shuffle_factor, 1) * 4
            elif kind in ("compact_probe", "compact_build"):
                # the estimate was short: re-run this node uncompacted; a
                # second such node disables compaction for the whole plan
                already = any(v.no_compact_probe or v.no_compact_build
                              for v in overrides.values())
                if kind == "compact_probe":
                    prev.no_compact_probe = True
                else:
                    prev.no_compact_build = True
                if already:
                    overrides[-1] = JoinOverride(no_compact_probe=True,
                                                 no_compact_build=True)
            else:
                raise ExecutionError(f"unknown runtime flag {key}")
            overrides[node_id] = prev

    def _result_prefix(self, plan, capacity: int) -> int:
        """Rows of the compacted result pulled together with the live count,
        sized from the cost model with headroom; a larger result costs a
        second pull."""
        try:
            from quickstep_tpu_torch.optimizer.rules import (
                collect_attr_stats, estimate_cardinality)
            env = collect_attr_stats(plan, self.db)
            est = estimate_cardinality(plan, self.db, env)
        except Exception:
            # the estimate only sizes the first pull; any size is handled
            est = float("inf")
        want = K.next_pow2(int(min(max(8 * est, 4096), 1 << 17)))
        return min(capacity, want)

    def _pull_outputs(self, plan, chunk, out_attrs, flags, host_sort):
        """Pull the live count, the runner's flags and a result prefix to the
        host in one synchronisation. Under a root ORDER BY ... LIMIT the
        prefix is the kept rows, sorted on the device; otherwise the live
        rows are compacted to the front (stable) and the prefix is their
        head, and a longer result costs a second pull. Returns (names of the
        flags that fired, and when none did (datas, valids, n,
        sorted_on_device))."""
        eids = [a.expr_id for a in out_attrs]
        count = chunk.alive.sum(dtype=torch.int64)
        names = list(flags)
        flag_t = torch.stack([flags[k] for k in names]) if names else None
        if flag_t is not None and self.mesh is not None and \
                self.mesh.world > 1:
            # a flag fired on any process fires on every one: they retry
            # together (the chunk itself was gathered to every process)
            flag_t = por(self.mesh, [flag_t])
        on_device = host_sort is not None and host_sort.limit is not None
        if on_device:
            order = self._device_sort_order(host_sort, chunk)
            prefix = min(chunk.capacity, host_sort.limit)
        else:
            # K9 on the card: its int64 output is the only full-capacity
            # buffer it needs, which bounds the pull of a large result
            order = K.stable_partition(chunk.alive)
            prefix = self._result_prefix(plan, chunk.capacity)
        ds, vs = chunk.take_columns(order[:prefix], eids)
        host = self._to_host([count, flag_t] + ds + vs)
        self.last_flags = {} if flag_t is None else {
            k: bool(f) for k, f in zip(names, host[1])}
        if flag_t is not None:
            fired = [k for k, f in zip(names, host[1]) if f]
            if fired:
                return fired, None
        n = int(host[0])
        k = len(eids)
        host_d, host_v = host[2:2 + k], host[2 + k:]
        if on_device:
            n = min(n, prefix)
        elif n > prefix:
            # one column at a time: each gathered column is released once
            # its copy is queued, so the pull holds one column on the device
            self.host_syncs += 1
            pulls = []
            for eid in eids:
                (d,), (v,) = chunk.take_columns(order[:n], [eid])
                pulls.append((self._queue_copy(d), self._queue_copy(v)))
                del d, v
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            host_d = [d.numpy() for d, _ in pulls]
            host_v = [None if v is None else v.numpy() for _, v in pulls]
        return [], ([d[:n] for d in host_d],
                    [None if v is None else v[:n] for v in host_v], n,
                    on_device)

    @staticmethod
    def _device_sort_order(sort_node: L.Sort, chunk) -> torch.Tensor:
        """The chunk's live rows in ORDER BY order, then its dead rows; ties
        keep row order: ops/sort.py order_permutation (K13 on the card),
        whose keys are encoded as in _host_sort_order, with -0.0 equal to
        0.0 and every NaN after +inf whatever its sign."""
        chunk.ensure([key.expr_id for key in sort_node.keys])
        keys, valids = [], []
        for key in sort_node.keys:
            d, v = chunk.broadcast(*chunk.slots[key.expr_id])
            keys.append(d)
            valids.append(v)
        return order_permutation(keys, valids, list(sort_node.ascending),
                                 list(sort_node.nulls_first), chunk.alive)

    def _queue_copy(self, t: Optional[torch.Tensor]):
        """A host copy of t, queued on the current stream (CPU tensors are
        returned as they are); valid once the stream is synchronised."""
        if t is None or self.device.type == "cpu":
            return t
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        return h

    def _to_host(self, tensors: List[Optional[torch.Tensor]]):
        """numpy copies of the given tensors, with one synchronisation."""
        self.host_syncs += 1
        hosts = [self._queue_copy(t) for t in tensors]
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return [None if h is None else h.numpy() for h in hosts]

    def _trim_rows(self, by_id, order, final_attrs, trim_ids):
        names = [a.name for a in final_attrs]
        types = [a.type for a in final_attrs]
        cols = []
        for fa, tid in zip(final_attrs, trim_ids):
            a, d, v = by_id[tid]
            cols.append(_decode_column(fa, d[order],
                                       None if v is None else v[order]))
        rows = list(zip(*cols)) if cols else []
        return rows, names, types

    # ----------------------------------------------------------------
    # input preparation (StorageManager role: host -> device memory)
    # ----------------------------------------------------------------
    def _collect_inputs(self, plan: L.LogicalNode, subqueries=()):
        """The device columns and metadata of every table the plan reads,
        in its scalar subqueries too, but for those already run (the keys
        of `subqueries`). Sets last_scan_bytes to the host bytes of those
        columns."""
        skip = {key[1] for key in subqueries}
        inputs = {}
        meta = {}
        scan_bytes = 0
        for name, colnames in _tables_read(plan, skip).items():
            rel = self.db.get_relation(name)
            cols, m = self._device_table(rel, colnames)
            sub = {c: cols[c] for c in colnames}
            sub["__num_rows__"] = cols["__num_rows__"]
            inputs[name] = sub
            meta[name] = m
            for c in colnames:
                col = rel.data.columns[c]
                scan_bytes += _nbytes(col.data) + _nbytes(col.valid)
        self.last_scan_bytes = scan_bytes
        return inputs, meta

    def _device_table(self, rel: CatalogRelation, needed):
        """Column-granular device residency: the plan-referenced columns are
        uploaded once per (relation, version) and kept; later queries upload
        only their missing columns. needed=None means all columns. Rows are
        not padded: capacity is the row count, rounded up under a mesh to a
        multiple of its shards with dead rows (the reference's _bucket,
        executor.py:1188), so that each shard holds an equal row range.
        Over several processes a table at or above replicate_threshold_rows
        is uploaded as this process's shards' rows only (the metadata's
        "sharded", "local_capacity" and "offset", its first row), a smaller
        one whole (the reference's executor.py:1146-1156). Under a device
        memory budget the eviction policy makes room first (_evict_for),
        and the entry's "bytes" count what was uploaded."""
        key = (rel.name, rel.version)
        names = [a.name for a in rel.attributes
                 if needed is None or a.name in needed]
        policy = self._policy()
        hit = self._device_cache.get(key)
        if hit is not None:
            cols, m = hit
            missing = [c for c in names if c not in cols]
            if not missing:
                policy.block_referenced(key)
                return cols, m
        else:
            # drop stale versions of this relation
            self._drop_device_copy(rel.name)
            cols, m = None, None
            missing = names

        n = rel.data.num_rows
        mesh = self.mesh
        shards = 1 if mesh is None else mesh.n
        cap = K.round_up(n, shards)
        sharded = mesh is not None and mesh.world > 1 and \
            n >= self.config.replicate_threshold_rows

        def held(arr):
            # the rows this process holds, dead rows padding the last shard
            return multihost.local_rows(mesh, arr) if sharded \
                else pad_to_multiple(arr, shards)
        st = rel.statistics
        ranges = dict(m["ranges"]) if m is not None else {}
        unique_cols = set(m["unique_cols"]) if m is not None else set()
        host_cols = {}
        for cname in missing:
            col = rel.data.columns[cname]
            valid = None if col.valid is None else held(
                np.asarray(col.valid, dtype=bool))
            host_cols[cname] = (held(np.asarray(col.data)), valid)
            self._column_meta(rel, cname, ranges, unique_cols)
        new_bytes = sum(_nbytes(d) + _nbytes(v) for d, v in host_cols.values())
        self._evict_for(key, new_bytes)
        new_cols = {
            cname: (torch.tensor(d, device=self.device),
                    None if v is None else torch.tensor(v, device=self.device))
            for cname, (d, v) in host_cols.items()}
        del host_cols

        if cols is None:
            cols = {"__num_rows__": n}
            m = {"capacity": cap, "rows": n, "ranges": ranges,
                 "unique_cols": unique_cols, "version": rel.version,
                 "bytes": 0, "sharded": sharded,
                 "unique_pairs": [tuple(p) for p in st.unique_pairs]
                 if st.exact else [],
                 "max_counts": dict(st.max_counts) if st.exact else {}}
            if sharded:
                per = cap // mesh.n
                m["local_capacity"] = per * mesh.local_n
                m["offset"] = per * mesh.local_ids[0]
            self._device_cache[key] = (cols, m)
        cols.update(new_cols)
        m["ranges"] = ranges
        m["unique_cols"] = unique_cols
        m["bytes"] += new_bytes
        policy.block_referenced(key)
        return cols, m

    def _drop_device_copy(self, name: str) -> None:
        """Forget every device copy of a relation (after a mutation, its
        version moved on and the next query uploads the new data). Its
        streamed segments stay until a newer version's are kept: a stream
        under way may still read them."""
        for k in [k for k in self._device_cache if k[0] == name]:
            del self._device_cache[k]
            self._policy().block_evicted(k)

    # ----------------------------------------------------------------
    # the device memory budget (Config.hbm_budget_bytes)
    # ----------------------------------------------------------------
    def _policy(self):
        """The eviction policy the config names (eviction_policy,
        eviction_lru_k), made anew when they change; the resident tables
        count as referenced once by a new one."""
        spec = (self.config.eviction_policy, self.config.eviction_lru_k)
        if spec != self._eviction_spec:
            self._eviction = make_policy(spec[0], k=spec[1])
            self._eviction_spec = spec
            for key in self._device_cache:
                self._eviction.block_referenced(key)
        return self._eviction

    def _resident_bytes(self) -> int:
        return sum(m["bytes"] for _c, m in self._device_cache.values())

    def _evict_for(self, incoming_key, need: int) -> None:
        """Make room for `need` more bytes of table incoming_key (the
        reference's _evict_for, StorageManager::makeRoomForBlock): evict
        other resident tables, the victims the policy chooses, and then
        cached segments, the last kept first, until the resident tables and
        the segment cache fit the budget; they are uploaded again on their
        next use. The incoming table itself is never evicted."""
        budget = self.config.hbm_budget_bytes
        if not budget:
            return
        policy = self._policy()
        resident = {k: m["bytes"] for k, (_c, m) in self._device_cache.items()
                    if k != incoming_key}
        held = self._device_cache.get(incoming_key)
        fixed = need + (held[1]["bytes"] if held else 0)
        while resident and sum(resident.values()) + fixed + \
                self._seg_cache_bytes > budget:
            victim = policy.choose_victim(resident)
            del self._device_cache[victim]
            policy.block_evicted(victim)
            del resident[victim]
        while self._seg_cache and sum(resident.values()) + fixed + \
                self._seg_cache_bytes > budget:
            self._seg_cache_bytes -= self._seg_cache.popitem()[1][2]

    # ================================================================
    # DDL
    # ================================================================
    def _create_table(self, stmt: A.CreateTableStmt) -> QueryResult:
        attrs = []
        for cd in stmt.columns:
            t = TypeFactory.from_name(cd.type_name, cd.type_length,
                                      nullable=cd.nullable and not cd.not_null,
                                      scale=cd.type_scale)
            attrs.append(CatalogAttribute(cd.name, t, unique=cd.unique))
        rel = CatalogRelation(stmt.name, attrs)
        if stmt.partition_kind:
            seen = set()
            for i, pa in enumerate(stmt.partition_attrs):
                if pa.lower() in seen:
                    pos = (stmt.partition_attr_pos[i]
                           if i < len(stmt.partition_attr_pos) else (None, None))
                    raise ResolutionError(
                        "A duplicate partition attribute was found.",
                        pos[0], pos[1])
                seen.add(pa.lower())
            rel.partition_scheme = PartitionScheme(
                kind=stmt.partition_kind, attributes=stmt.partition_attrs,
                num_partitions=stmt.partition_count)
        # BLOCKPROPERTIES validated for parity (StorageBlockLayout::
        # DescriptionIsValid); columns are always struct-of-arrays on device.
        bp = stmt.block_properties
        if bp:
            btype = str(bp.get("type", "split_rowstore")).lower()
            known = {"rowstore", "split_rowstore", "columnstore",
                     "compressed_rowstore", "compressed_columnstore"}
            valid = btype in known
            if btype in ("columnstore", "compressed_columnstore"):
                # BasicColumnStore requires all-fixed-width attributes
                # (storage/BasicColumnStoreTupleStorageSubBlock.cpp
                # DescriptionIsValid)
                if any(a.type.type_id == TypeID.VARCHAR for a in attrs):
                    valid = False
                sort_col = bp.get("sort")
                if sort_col is not None and not any(
                        a.name.lower() == str(sort_col).lower() for a in attrs):
                    valid = False
            if not valid:
                raise ExecutionError("BLOCKPROPERTIES is invalid.")
        self.db.add_relation(rel)
        return QueryResult([], [], [], message=f"Table {stmt.name} created.")

    def _create_index(self, stmt: A.CreateIndexStmt) -> QueryResult:
        rel = self._rel(stmt.table_name)
        for idx in rel.indices:
            if idx["attrs"] == stmt.attrs and idx["type"] == stmt.index_type:
                raise ExecutionError(
                    f"The relation {rel.name} already defines this index on "
                    f"the given attribute(s).")
        for aname in stmt.attrs:
            if rel.attribute_by_name(aname) is None:
                raise ExecutionError(
                    f"no attribute {aname} in relation {rel.name}")
        rel.indices.append({"name": stmt.index_name, "attrs": stmt.attrs,
                            "type": stmt.index_type})
        # the block min/max summary (SMAIndexSubBlock analog), built eagerly
        # and refreshed on use after DML bumps rel.version
        from quickstep_tpu_torch.catalog.catalog import build_sma_blocks
        for aname in stmt.attrs:
            build_sma_blocks(rel, rel.attribute_by_name(aname).name)
        return QueryResult([], [], [],
                           message=f"Index {stmt.index_name} created.")

    def _rel(self, name: str) -> CatalogRelation:
        rel = self.db.get_relation(name)
        if rel is None:
            raise ExecutionError(f"Unrecognized relation {name}")
        return rel

    # ================================================================
    # DML
    # ================================================================
    def _insert(self, stmt: A.InsertStmt) -> QueryResult:
        rel = self._rel(stmt.table_name)
        schema = [(a.name, a.type) for a in rel.attributes]
        if stmt.select is not None:
            cols, _names, _types = self.run_plan(
                self.plan_select(stmt.select), columns=True)
            data = TableData({
                name: _column_for(typ, attr, d, v)
                for (name, typ), (attr, d, v) in zip(schema, cols)})
            n = data.num_rows
        else:
            resolver = Resolver(self.db)
            rows = []
            for row_exprs in stmt.rows:
                vals = []
                for ast_e, attr in zip(row_exprs, rel.attributes):
                    e = resolver._resolve_expr(ast_e, Scope(), _EMPTY_STATE)
                    if not isinstance(e, Lit):
                        raise ExecutionError("INSERT VALUES must be literals")
                    vals.append(self._literal_for(attr.type, e))
                rows.append(tuple(vals))
            data = TableData.from_rows(schema, rows)
            n = len(rows)
        rel.append_data(data)
        self._drop_device_copy(rel.name)
        return QueryResult([], [], [], rows_affected=n)

    def _literal_for(self, t: Type, e: Lit):
        if e.value is None:
            return None
        if t.is_string:
            return str(e.value)
        if t.type_id in (TypeID.DATE, TypeID.DATETIME):
            # bare strings are parsed here; typed literals arrive encoded
            if isinstance(e.value, str):
                from quickstep_tpu_torch.types.datetime_util import (
                    parse_date_literal, parse_datetime_literal)
                return (parse_date_literal(e.value)
                        if t.type_id == TypeID.DATE
                        else parse_datetime_literal(e.value))
            return int(e.value)
        if t.is_floating or t.is_decimal:
            # decimal values encode to scaled units in Column.from_values
            return float(e.value)
        return int(e.value)

    def _eval_on_relation(self, rel: CatalogRelation, expr_ast: A.Expr):
        """An expression over a whole relation (the UpdateOperator /
        DeleteOperator per-block predicate path): evaluated on the device
        over the relation's resident columns, pulled to the host with one
        synchronisation. Returns (resolved expr, data, valid or None)."""
        from quickstep_tpu_torch.optimizer.logical import OutAttr, next_expr_id
        scope = Scope()
        attrs = []
        for a in rel.attributes:
            col = rel.data.columns[a.name]
            oa = OutAttr(next_expr_id(), a.name, a.type, col.dictionary)
            scope.add(rel.name, oa)
            attrs.append(oa)
        e = Resolver(self.db)._resolve_expr(expr_ast, scope, _EMPTY_STATE)
        used = e.referenced_attrs()
        cols, meta = self._device_table(
            rel, {oa.name for oa in attrs if oa.expr_id in used})
        slots = {oa.expr_id: cols[oa.name] for oa in attrs
                 if oa.expr_id in used}
        d, v = e.eval(EvalContext(slots, device=self.device))
        n, cap = rel.data.num_rows, meta["capacity"]
        if meta["sharded"]:
            # this process's rows: every process's, in rank order
            held = meta["local_capacity"]
            d, v = all_gather(self.mesh, [
                torch.broadcast_to(d, (held,)),
                None if v is None else torch.broadcast_to(v, (held,))])
        d = torch.broadcast_to(d, (cap,))[:n]
        v = None if v is None else torch.broadcast_to(v, (cap,))[:n]
        d, v = self._to_host([d, v])
        return e, d, v

    def _where_mask(self, rel: CatalogRelation, where) -> np.ndarray:
        if where is None:
            return np.ones(rel.data.num_rows, dtype=bool)
        _, d, v = self._eval_on_relation(rel, where)
        mask = d.astype(bool)
        if v is not None:
            mask &= v
        return mask

    def _delete(self, stmt: A.DeleteStmt) -> QueryResult:
        rel = self._rel(stmt.table_name)
        n = rel.data.num_rows
        if stmt.where is None:
            rel.set_data(TableData.empty(
                [(a.name, a.type) for a in rel.attributes]))
            self._drop_device_copy(rel.name)
            return QueryResult([], [], [], rows_affected=n)
        mask = self._where_mask(rel, stmt.where)
        rel.set_data(rel.data.select_rows(np.nonzero(~mask)[0]))
        self._drop_device_copy(rel.name)
        return QueryResult([], [], [], rows_affected=int(mask.sum()))

    def _update(self, stmt: A.UpdateStmt) -> QueryResult:
        rel = self._rel(stmt.table_name)
        n = rel.data.num_rows
        mask = self._where_mask(rel, stmt.where)
        new_cols = dict(rel.data.columns)
        for col_name, expr_ast in stmt.assignments:
            attr = rel.attribute_by_name(col_name)
            if attr is None:
                raise ExecutionError(f"unknown column {col_name}")
            e, d, v = self._eval_on_relation(rel, expr_ast)
            old = rel.data.columns[attr.name]
            if attr.type.is_string:
                # decode the new values through the expression's dictionary,
                # then rebuild the column's dictionary over the updated data
                from quickstep_tpu_torch.optimizer.resolver import (
                    _expr_dictionary)
                ed = _expr_dictionary(e)
                vals = old.to_pylist()
                new_vals = ed.decode(d) if ed is not None else \
                    [str(x) for x in d]
                for i in np.nonzero(mask)[0]:
                    vals[int(i)] = new_vals[int(i)]
                new_cols[attr.name] = Column.from_values(attr.type, vals)
            else:
                data = np.asarray(old.data).copy()
                data[mask] = d[mask].astype(data.dtype)
                valid = old.valid
                if v is not None:
                    valid = (np.ones(n, bool) if valid is None
                             else np.asarray(valid).copy())
                    valid[mask] = v[mask]
                new_cols[attr.name] = Column(attr.type, data, valid, None)
        rel.set_data(TableData(new_cols))
        self._drop_device_copy(rel.name)
        return QueryResult([], [], [], rows_affected=int(mask.sum()))

    def _copy(self, stmt: A.CopyStmt) -> QueryResult:
        if stmt.direction == "from":
            rel = self._rel(stmt.table_name)
            delim = str(stmt.options.get("delimiter", "\t"))
            header = bool(stmt.options.get("header", False))
            schema = [(a.name, a.type) for a in rel.attributes]
            data = csv_io.load_csv(stmt.path, schema, delimiter=delim,
                                   header=header)
            rel.append_data(data)
            rel.analyze()
            self._drop_device_copy(rel.name)
            return QueryResult([], [], [], rows_affected=data.num_rows)
        # COPY {table | <query>} TO {path | stdout | stderr} WITH (...)
        # (relational_operators/TableExportOperator.hpp:61)
        if stmt.select is not None:
            sel = self._run_select(stmt.select)
            names, types, rows = sel.column_names, sel.types, sel.rows
        else:
            rel = self._rel(stmt.table_name)
            names = [a.name for a in rel.attributes]
            types = [a.type for a in rel.attributes]
            rows = rel.data.to_rows()
        text = csv_io.export_csv(stmt.path, names, types, rows, stmt.options)
        return QueryResult([], [], [], rows_affected=len(rows),
                           message=text.rstrip("\n") if text else None)

    # ================================================================
    # CLI commands (reference cli/CommandExecutor.cpp)
    # ================================================================
    def _command(self, stmt: A.CommandStmt) -> QueryResult:
        from quickstep_tpu_torch.types import VarChar
        cmd = stmt.command
        if cmd == "\\dt":
            rows = [(r.name,) for r in self.db.relations.values()]
            return QueryResult(["Table"], [VarChar(64)], rows)
        if cmd == "\\d":
            if not stmt.args:
                return self._command(A.CommandStmt(command="\\dt"))
            rel = self._rel(stmt.args[0])
            rows = [(a.name, a.type.name()) for a in rel.attributes]
            return QueryResult(["Column", "Type"], [VarChar(64), VarChar(64)],
                               rows)
        if cmd == "\\analyze":
            # one "Analyzing <rel> ... done" line per relation
            # (cli/CommandExecutor.cpp:218-310)
            targets = stmt.args or list(self.db.relations.keys())
            lines = []
            for t in targets:
                rel = self._rel(t)
                rel.analyze()
                self._drop_device_copy(rel.name)
                lines.append(f"Analyzing {rel.name} ... done")
            return QueryResult([], [], [], message="\n".join(lines))
        if cmd in ("\\explain", "\\viz", "\\explain_analyze"):
            # plan tree and DOT, with per-operator times for
            # \explain_analyze (visualize_plan / visualize_execution_dag)
            from quickstep_tpu_torch.utils.visualize import explain
            from quickstep_tpu_torch.database import Database
            sql = " ".join(stmt.args).rstrip(";")
            shim = Database.__new__(Database)
            shim.catalog = self.catalog
            shim.config = self.config
            shim._executor = self
            text = explain(shim, sql, analyze=cmd == "\\explain_analyze")
            return QueryResult([], [], [], message=text)
        raise ExecutionError(f"unknown command {cmd}")


class _EmptyState:
    def __init__(self):
        self.pending_joins = []
        self.uncorrelated_scalar_subplans = []


_EMPTY_STATE = _EmptyState()


def _decode_column(attr, data: np.ndarray, valid: Optional[np.ndarray]):
    """Python values of one pulled column (dictionary strings, decoded
    dates and decimals, None for NULL)."""
    if attr.dictionary is not None:
        vals = attr.dictionary.decode(data)
    else:
        vals = [_decode_scalar(attr.type, x) for x in data]
    if valid is not None:
        vals = [x if ok else None for x, ok in zip(vals, valid)]
    return vals


def _column_for(typ: Type, attr, data: np.ndarray,
                valid: Optional[np.ndarray]) -> Column:
    """A pulled SELECT column as a column of type typ (INSERT ... SELECT).
    Where the encodings agree (same type id and scale; strings with their
    dictionary) the arrays are kept as they are; otherwise the values are
    decoded and encoded again, as the reference's row path does."""
    same = attr.type.type_id == typ.type_id and \
        getattr(attr.type, "scale", None) == getattr(typ, "scale", None)
    if same and typ.is_string and attr.dictionary is not None and \
            (valid is None or valid.all()):
        # (a NULL row's code is arbitrary: such columns are decoded)
        return Column(typ, data.astype(typ.device_dtype, copy=False), None,
                      attr.dictionary)
    if same and not typ.is_string:
        return Column(typ, data.astype(typ.device_dtype, copy=False),
                      None if valid is None or valid.all() else valid, None)
    return Column.from_values(typ, _decode_column(attr, data, valid))


class _SmaCache(dict):
    """streaming.segment_minmax's cache of each segment's (min, max), keyed
    (column, segment rows, version), holding every column and segment size
    of one version. The copied segment_minmax clears the whole cache before
    each entry it adds ("one version at a time"), so a scan filtered on
    several columns would compute each column's ranges again for every
    segment of every run; here clear() keeps them, and an entry of another
    version drops the old version's."""

    def clear(self):
        pass

    def __setitem__(self, key, value):
        for k in [k for k in self if k[2] != key[2]]:
            del self[k]
        super().__setitem__(key, value)


class _Snapshot:
    """A streamed relation as it stood when its stream began: what
    streaming.segment_survives and _segment_inputs read (name, data,
    version, sma_blocks, and the relation's own _sma_cache), so that a
    statement run between segments that changes the relation changes no
    segment of the stream."""

    def __init__(self, rel: CatalogRelation):
        self.rel = rel
        self.name = rel.name
        self.data = rel.data
        self.version = rel.version
        self.sma_blocks = rel.sma_blocks
        cache = rel.__dict__.get("_sma_cache")
        if not isinstance(cache, _SmaCache):
            cache = rel.__dict__["_sma_cache"] = _SmaCache(cache or {})
        self._sma_cache = cache


def _nbytes(x) -> int:
    """Bytes of a numpy array or tensor; 0 for None."""
    if x is None:
        return 0
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return np.asarray(x).nbytes


def use_device(device: torch.device) -> None:
    """Make a card with an index the calling thread's current device, where
    it is not yet: the kernels launch on the current device (ops/cuda.py
    _stream), and a statement may run on any thread (the PolicyEnforcer's,
    a member's, the caller's)."""
    if device.type == "cuda" and device.index is not None and \
            torch.cuda.current_device() != device.index:
        torch.cuda.set_device(device)


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A device copy of a host slice: straight from the host column's
    memory, with no padded or pinned copy (a copy on the CPU, whose tensor
    must not share the column's memory)."""
    if device.type == "cpu":
        return torch.tensor(arr)
    with warnings.catch_warnings():
        # a store's memory-mapped column is read-only; it is only read
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(arr).to(device)


def _concat_segments(attr, segs, vsegs):
    """One partial column from its segments' pulls: (data, valid or
    None)."""
    if not segs:
        return np.zeros((0,), attr.type.device_dtype), None
    data = np.concatenate(segs)
    if all(v is None for v in vsegs):
        return data, None
    return data, np.concatenate([
        v if v is not None else np.ones(len(d), bool)
        for d, v in zip(segs, vsegs)])


def _tables_read(plan: L.LogicalNode, skip=()) -> Dict[str, set]:
    """relation name -> the columns the plan reads of it, in the plans of
    its scalar subqueries too, but those whose id is in skip."""
    from quickstep_tpu_torch.expressions.subquery import SubqueryScalar
    needed: Dict[str, set] = {}

    def walk(node):
        if isinstance(node, L.TableScan):
            needed.setdefault(node.relation_name, set()).update(
                a.name for a in node.attrs)
        for c in node.children():
            walk(c)
        # subplans hold nested plans in expressions too
        for e in _node_exprs(node):
            stack = [e]
            while stack:
                x = stack.pop()
                if isinstance(x, SubqueryScalar) and id(x.plan) not in skip:
                    walk(x.plan)
                stack.extend(x.children())
    walk(plan)
    return needed


# =====================================================================
# Host helpers, copied from quickstep_tpu/exec/executor.py (:1463-1614).
# =====================================================================

def _host_sort_order(sort_node: L.Sort, by_id, n: int) -> np.ndarray:
    """Stable host lexsort order for a presentation Sort over host arrays
    keyed by expr_id (encoded values are order-preserving)."""
    sort_cols = []
    for key, asc, nf in zip(sort_node.keys, sort_node.ascending,
                            sort_node.nulls_first):
        # _resolve_order_by guarantees keys are Attr refs into the pre-sort
        # projection (hidden keys included)
        a, d, v = by_id[key.expr_id]
        col = d.copy()
        if not asc:
            if np.issubdtype(col.dtype, np.floating):
                col = -col
            else:
                col = ~col
        if v is not None:
            first = nf if nf is not None else (not asc)
            if np.issubdtype(col.dtype, np.floating):
                sentinel = -np.inf if first else np.inf
            else:
                info = np.iinfo(col.dtype)
                sentinel = info.min if first else info.max
            col = np.where(v, col, sentinel)
        sort_cols.append(col)
    if sort_cols:
        order = np.lexsort(tuple(reversed(sort_cols)))
    else:
        order = np.arange(n)
    if sort_node.limit is not None:
        order = order[:sort_node.limit]
    return order


# plan fingerprinting: ExprIds are fresh on every resolve, so fingerprints
# canonicalize them by first-encounter order (the optimizer's rules use them
# to recognize common subplans)

def _node_exprs(node: L.LogicalNode):
    out = []
    if isinstance(node, L.Filter):
        out.append(node.predicate)
    elif isinstance(node, L.Project):
        out.extend(node.exprs)
    elif isinstance(node, L.Join):
        out.extend(node.left_keys + node.right_keys)
        if node.residual is not None:
            out.append(node.residual)
    elif isinstance(node, L.Aggregate):
        out.extend(node.group_by)
        for s in node.aggregates:
            if s.arg is not None:
                out.append(s.arg)
    elif isinstance(node, L.Sort):
        out.extend(node.keys)
    elif isinstance(node, L.WindowAggregate):
        out.extend(node.partition_by)
        out.extend(node.order_by)
        if node.spec is not None and node.spec.arg is not None:
            out.append(node.spec.arg)
    return out


def _fingerprint(node: L.LogicalNode, canon: Optional[dict] = None) -> tuple:
    if canon is None:
        canon = {}

    def cid(expr_id: int) -> int:
        if expr_id not in canon:
            canon[expr_id] = len(canon)
        return canon[expr_id]

    parts = [type(node).__name__]
    if isinstance(node, L.TableScan):
        parts.append(node.relation_name)
        parts.append(tuple((a.name, cid(a.expr_id)) for a in node.attrs))
    if isinstance(node, L.Generator):
        parts.append((node.start, node.end, node.step))
        parts.append(tuple(cid(a.expr_id) for a in node.attrs))
    if isinstance(node, L.SharedSubplan):
        parts.append(tuple(cid(a.expr_id) for a in node.attrs))
    if isinstance(node, L.Join):
        parts.append(node.kind)
    if isinstance(node, L.Aggregate):
        parts.append(tuple((s.fn, s.distinct) for s in node.aggregates))
    if isinstance(node, L.Sort):
        parts.append((tuple(node.ascending), tuple(node.nulls_first),
                      node.limit))
    if isinstance(node, L.Limit):
        parts.append(node.limit)
    if isinstance(node, L.SetOperation):
        parts.append(node.kind)
    if isinstance(node, L.WindowAggregate):
        parts.append((node.spec.fn, tuple(node.order_ascending), node.frame))
    for e in _node_exprs(node):
        parts.append(_expr_fp(e, canon, cid))
    for c in node.children():
        parts.append(_fingerprint(c, canon))
    # output ids last (Aggregate/Project attr ids referenced above)
    if isinstance(node, (L.Project, L.Aggregate, L.WindowAggregate,
                         L.RowNumber)):
        parts.append(tuple(cid(a.expr_id) for a in node.output))
    return tuple(parts)


def _array_digest(e, field: str) -> str:
    """A digest of the array in expression e's `field` (its dtype, shape
    and bytes) that every process computes alike, where Python's hash of
    bytes is salted per process. It is kept on e, so that the runs of a
    cached plan hash a LIKE bitmap over a 2 M-string dictionary once."""
    memo = e.__dict__.setdefault("_digests", {})
    if field not in memo:
        a = np.ascontiguousarray(np.asarray(getattr(e, field)))
        h = hashlib.sha256(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.tobytes())
        memo[field] = h.hexdigest()
    return memo[field]


def _statement_key(node):
    """An AST node's structure as nested tuples of field names and the
    reprs of their values, without the (line, column) positions that only
    error messages read: the same statement written with other spacing or
    line breaks has the same key."""
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return (type(node).__name__,) + tuple(
            (f.name, _statement_key(getattr(node, f.name)))
            for f in dataclasses.fields(node)
            if f.name not in ("line", "column"))
    if isinstance(node, (list, tuple)):
        return (type(node).__name__,) + tuple(_statement_key(x) for x in node)
    if isinstance(node, dict):
        return ("dict",) + tuple(sorted(
            (repr(k), _statement_key(v)) for k, v in node.items()))
    return repr(node)


def _expr_fp(e, canon: dict, cid) -> tuple:
    from quickstep_tpu_torch.expressions.subquery import SubqueryScalar
    from quickstep_tpu_torch.expressions import scalar as E
    if e is None:
        return ("none",)
    if isinstance(e, E.Attr):
        return ("attr", cid(e.expr_id))
    if isinstance(e, SubqueryScalar):
        return ("subquery", _fingerprint(e.plan, canon))
    if isinstance(e, E.Lit):
        return ("lit", e.value, int(e.type.type_id))
    if isinstance(e, E.Arith):
        return ("arith", e.op, _expr_fp(e.lhs, canon, cid),
                _expr_fp(e.rhs, canon, cid))
    if isinstance(e, E.Cmp):
        return ("cmp", e.op, _expr_fp(e.lhs, canon, cid),
                _expr_fp(e.rhs, canon, cid))
    if isinstance(e, E.Logical):
        return ("logical", e.op) + tuple(_expr_fp(o, canon, cid)
                                         for o in e.operands)
    if isinstance(e, E.Not):
        return ("not", _expr_fp(e.operand, canon, cid))
    if isinstance(e, E.IsNull):
        return ("isnull", e.negated, _expr_fp(e.operand, canon, cid))
    if isinstance(e, E.Case):
        return ("case",) + tuple(
            (_expr_fp(c, canon, cid), _expr_fp(r, canon, cid))
            for c, r in e.when_clauses) + (
            _expr_fp(e.else_result, canon, cid),)
    if isinstance(e, E.Cast):
        return ("cast", int(e.type.type_id), _expr_fp(e.operand, canon, cid))
    if isinstance(e, E.ExtractDate):
        return ("extract", e.field, _expr_fp(e.operand, canon, cid))
    if isinstance(e, E.InSet):
        return ("inset", e.values, e.negated, _expr_fp(e.operand, canon, cid))
    if isinstance(e, E.DictBitmapProbe):
        return ("dictbitmap", _array_digest(e, "bitmap"), e.negated,
                _expr_fp(e.operand, canon, cid))
    if isinstance(e, E.Substr):
        return ("substr", _array_digest(e, "remap"),
                _expr_fp(e.operand, canon, cid))
    return (type(e).__name__,)
