"""Top-level Database facade: the embedded-engine public API.

The counterpart of quickstep_tpu/database.py with two additions: the device
that holds the tables and runs the operators ("cuda", the default, or
"cpu", which the caller asks for) and the shard count of the mesh that
`Config.distributed` runs on (`mesh_shards`) are named explicitly; nothing
probes the hardware to choose the shard count. Once
parallel/multihost.py's `bootstrap` has run, every process makes its own
Database with the same config and catalog, and `mesh_shards` counts its
local shards: the mesh has that many times the process count.

With `mesh_devices`, a list of k devices (repeats allowed) or "all" (every
card torch sees, the reference's mesh over every device JAX sees), the
mesh spreads over k members of this process (parallel/local_group.py):
member i runs on a thread of its own, kept for the Database's life, with
its own catalog and Executor on `mesh_devices[i]`, holding `mesh_shards`
local shards (global shards i * s .. i * s + s - 1), and reaches the other
members only through the mesh's collectives, as a process reaches the
other ranks. Every statement runs on every member; `execute` returns
member 0's result (results are replicated), `executor` is member 0's and
`members` each member's. Anything that fills the catalog directly, as the
bench loaders do, runs on every member through `on_members`.
"""

from __future__ import annotations

import copy
import dataclasses
import threading
from typing import Callable, List, Optional, Sequence, Union

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


def _member_devices(devices, device: torch.device) -> List[torch.device]:
    """The members' devices: "all" is every card torch sees (on a card
    only); each is of `device`'s kind, a card with its index."""
    if isinstance(devices, str) and devices == "all":
        if device.type != "cuda":
            raise ValueError('mesh_devices="all" is every card torch sees: '
                             f'it needs device "cuda", not {str(device)!r}')
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        dev = _check_device(d)
        if dev.type != device.type:
            raise ValueError(f"mesh_devices holds {str(dev)!r}, not a "
                             f"device of {str(device)!r}'s kind")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        out.append(dev)
    if not out:
        raise ValueError("mesh_devices names no device")
    return out


class MemberDatabase:
    """One member of a Database over mesh_devices: its own catalog and
    Executor on its own device, driven from its member's thread
    (Database.on_members). `execute` runs statements on this member alone,
    so every member must run the same ones (they meet in the mesh's
    collectives and in the barrier that ends a statement that is not a
    SELECT)."""

    def __init__(self, index: int, device: torch.device, catalog: Catalog):
        self.index = index
        self.device = device
        self.catalog = catalog
        self.executor = None        # made on the member's thread

    def execute(self, sql: str):
        from quickstep_tpu_torch.parser import parse_statements
        result = None
        for stmt in parse_statements(sql):
            result = self.executor.execute_statement(stmt)
        return result


class Database:
    def __init__(self, config: Optional[Config] = None,
                 storage_path: Optional[str] = None, *, device="cuda",
                 mesh_shards: Optional[int] = None,
                 mesh_devices: Union[None, str, Sequence] = None):
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
        # a mesh over members: each member's MemberDatabase and thread
        self._members: Optional[List[MemberDatabase]] = None
        self._threads = None
        if mesh_devices is not None:
            self._start_members(_member_devices(mesh_devices, self.device))
        if self.config.distributed:
            # the executor refuses a mesh without its shard count: say so now
            self.executor
        if self.config.preload_buffer_pool:
            if self._members is None:
                self.executor.preload()
            else:
                self.on_members(lambda m: m.executor.preload())

    def _start_members(self, devices: List[torch.device]) -> None:
        """A thread for each member, and on it the member's Executor (the
        members meet in their meshes' setup)."""
        from quickstep_tpu_torch.exec.executor import Executor
        from quickstep_tpu_torch.parallel.local_group import (
            LocalGroup, MemberThread)
        if not self.config.distributed or self.mesh_shards is None:
            raise ValueError("mesh_devices spreads the mesh of "
                             "Config.distributed = True over members: it "
                             "needs that config and mesh_shards, each "
                             "member's shard count")
        self.device = devices[0]
        # one hand-off at a time: every member takes the jobs in one order
        self._members_lock = threading.Lock()
        group = LocalGroup(devices)
        self._threads = [MemberThread(m) for m in group.members]
        self._members = [MemberDatabase(
            i, d, self.catalog if i == 0 else
            Catalog.load(self.config.storage_path) if self.store
            else Catalog()) for i, d in enumerate(devices)]
        self.catalog = self._members[0].catalog

        def start(m: MemberDatabase):
            m.executor = Executor(m.catalog, self.config, m.device,
                                  self.mesh_shards, store=self.store)
        try:
            self.on_members(start)
        except BaseException:
            self._stop_members()
            raise
        self._executor = self._members[0].executor

    def on_members(self, fn: Callable[[MemberDatabase], object]) -> list:
        """fn(member) on every member's thread at once, for what fills or
        reads each member's catalog and executor (a loader, figures):
        returns the results in member order. If any member raises, every
        member stops and the first member's error is raised."""
        from quickstep_tpu_torch.parallel.local_group import run_on_members
        if self._members is None:
            raise ValueError("this Database has no members (mesh_devices)")
        if self._threads is None:
            raise RuntimeError("this Database is closed: its members' "
                               "threads have stopped")
        with self._members_lock:
            return run_on_members(self._threads, fn, self._members)

    @property
    def members(self) -> list:
        """Each member's Executor, in member order (this Database's alone
        where it has no members)."""
        if self._members is None:
            return [self.executor]
        return [m.executor for m in self._members]

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
            # over members a streamed query does not yield to another
            # between its segments: every member runs the same statements
            # in the same order
            self._enforcer = PolicyEnforcer(
                self._execute_one,
                max_concurrent_queries=self.config.max_concurrent_queries,
                executor=self.executor if self._members is None else None)
        return self._enforcer

    def _execute_one(self, stmt):
        if self._members is None:
            return self.executor.execute_statement(stmt)
        # every member a statement of its own: the executors annotate them
        stmts = [stmt] + [copy.deepcopy(stmt) for _ in self._members[1:]]
        return self.on_members(
            lambda m: m.executor.execute_statement(stmts[m.index]))[0]

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
        for ex in self.members if self._executor is not None else []:
            ex.store = self.store

    def close(self) -> None:
        """Stop the PolicyEnforcer's dispatcher thread and the members'
        threads."""
        enforcer = getattr(self, "_enforcer", None)
        if enforcer is not None:
            enforcer.shutdown()
            self._enforcer = None
        self._stop_members()

    def _stop_members(self) -> None:
        for t in self._threads or []:
            t.stop()
        self._threads = None


def from_store(path: str, device="cuda", config: Optional[Config] = None,
               mesh_shards: Optional[int] = None,
               mesh_devices: Union[None, str, Sequence] = None) -> Database:
    """Open a catalog store (the .npy columns, JSON dictionaries and metadata
    that quickstep_tpu.Database.save() or this package's save() writes) with
    its tables on `device`, under `config` (a device memory budget, say),
    on a mesh of mesh_shards shards a member of mesh_devices where given."""
    return Database(config=config, storage_path=path, device=device,
                    mesh_shards=mesh_shards, mesh_devices=mesh_devices)
