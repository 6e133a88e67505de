"""Top-level Database facade: the embedded-engine public API.

The counterpart of quickstep_tpu/database.py with two additions: the device
that holds the tables and runs the operators is named explicitly ("cuda" or
"cpu"), and so is the shard count of the mesh that `Config.distributed`
runs on (`mesh_shards`, n row shards of that device, the counterpart of the
reference's mesh over the devices JAX sees); nothing probes the hardware to
choose either. Once parallel/multihost.py's `bootstrap` has run, every
process makes its own Database with the same config and catalog, and
`mesh_shards` counts its local shards: the mesh has that many times the
process count.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from quickstep_tpu_torch.config import Config, DEFAULT
from quickstep_tpu_torch.catalog import Catalog


def _check_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} was asked for, but torch "
                           "finds no CUDA device")
    return dev


class Database:
    def __init__(self, config: Optional[Config] = None,
                 storage_path: Optional[str] = None, *, device,
                 mesh_shards: Optional[int] = None):
        # Per-instance copy of the defaults: callers tune db.config after
        # construction, and a shared DEFAULT would leak one instance's knobs
        # into every other Database in the process.
        self.config = config if config is not None \
            else dataclasses.replace(DEFAULT)
        if storage_path is not None:
            self.config.storage_path = storage_path
        self.device = _check_device(device)
        self.mesh_shards = mesh_shards
        self.catalog = Catalog.load(self.config.storage_path) \
            if storage_path else Catalog()
        # the store this database was opened on or saved to: the executor
        # keeps its learned overrides there, and a database on no store
        # reads and writes none (config.storage_path has a default)
        self.store: Optional[str] = storage_path or None
        self._executor = None
        if self.config.distributed:
            # the executor refuses a mesh without its shard count: say so now
            self.executor
        if self.config.preload_buffer_pool:
            self.executor.preload()

    @property
    def executor(self):
        if self._executor is None:
            from quickstep_tpu_torch.exec.executor import Executor
            self._executor = Executor(self.catalog, self.config, self.device,
                                      self.mesh_shards, store=self.store)
        return self._executor

    @property
    def policy_enforcer(self):
        """Admission/fair-dispatch layer. Every query routes through it,
        matching the reference where the Foreman/PolicyEnforcer sees every
        AdmitRequestMessage (query_execution/PolicyEnforcerSingleNode.cpp:42-56).
        Queries run on its dispatcher thread, on that thread's current CUDA
        stream; a streamed query lets the others run between its segments
        (the executor's segment_yield)."""
        if getattr(self, "_enforcer", None) is None:
            from quickstep_tpu_torch.exec.scheduler import PolicyEnforcer
            self._enforcer = PolicyEnforcer(
                self._execute_one,
                max_concurrent_queries=self.config.max_concurrent_queries,
                executor=self.executor)
        return self._enforcer

    def _execute_one(self, stmt):
        return self.executor.execute_statement(stmt)

    # ---- public API ----
    def execute(self, sql: str, session: str = "default",
                priority: Optional[int] = None):
        """Execute one or more SQL statements; returns the last statement's
        result. Statements are admitted through the PolicyEnforcer (a WITH
        PRIORITY clause on a SELECT overrides the call-level priority)."""
        from quickstep_tpu_torch.parser import parse_statements
        result = None
        for stmt in parse_statements(sql):
            prio = getattr(stmt, "priority", None)
            if prio is None:
                prio = priority if priority is not None else 0
            result = self.policy_enforcer.submit(stmt, session=session,
                                                 priority=prio)
        return result

    def query(self, sql: str) -> List[tuple]:
        """Execute a single query and return rows as Python tuples."""
        res = self.execute(sql)
        return res.rows if res is not None and hasattr(res, "rows") else []

    def save(self) -> None:
        self.catalog.save(self.config.storage_path)
        self.store = self.config.storage_path
        if self._executor is not None:
            self._executor.store = self.store

    def close(self) -> None:
        """Stop the PolicyEnforcer's dispatcher thread."""
        enforcer = getattr(self, "_enforcer", None)
        if enforcer is not None:
            enforcer.shutdown()
            self._enforcer = None


def from_store(path: str, device, config: Optional[Config] = None) -> Database:
    """Open a catalog store (the .npy columns, JSON dictionaries and metadata
    that quickstep_tpu.Database.save() or this package's save() writes) with
    its tables on `device`, under `config` (a device memory budget, say)."""
    return Database(config=config, storage_path=path, device=device)
