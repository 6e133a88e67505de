# Copied from quickstep_tpu/transaction/lock_manager.py; only the package name in imports differs.
"""Two-phase-locking concurrency-control infrastructure.

Component parity with the reference's transaction/ module (transaction/
LockManager.hpp:52, LockTable, AccessMode IS/IX/S/SIX/X compatibility,
TransactionTable, DeadLockDetector building a waits-for DirectedGraph and finding
cycles via strongly-connected components). Like the reference, this module is
**standalone**: the reference never wires transaction:: into query execution
(SURVEY.md §2.13), and the same holds here — it exists for capability parity and is
exercised by its own unit tests.

Differences from the reference's shape: the LockManager here is a passive object
(acquire/release methods + an explicit run_deadlock_detection()) rather than a
dedicated thread consuming ThreadSafeQueues — idiomatic for a Python host runtime
where the engine's control plane is single-threaded.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
from collections import defaultdict, deque
from typing import Dict, List, Optional, Set, Tuple


class AccessMode(enum.IntEnum):
    """Hierarchical lock modes (transaction/AccessMode.hpp)."""
    NO_LOCK = 0
    IS = 1
    IX = 2
    S = 3
    SIX = 4
    X = 5


# Compatibility matrix (row = held, col = requested); True = compatible.
_COMPAT = {
    AccessMode.IS:  {AccessMode.IS: True,  AccessMode.IX: True,
                     AccessMode.S: True,   AccessMode.SIX: True,
                     AccessMode.X: False},
    AccessMode.IX:  {AccessMode.IS: True,  AccessMode.IX: True,
                     AccessMode.S: False,  AccessMode.SIX: False,
                     AccessMode.X: False},
    AccessMode.S:   {AccessMode.IS: True,  AccessMode.IX: False,
                     AccessMode.S: True,   AccessMode.SIX: False,
                     AccessMode.X: False},
    AccessMode.SIX: {AccessMode.IS: True,  AccessMode.IX: False,
                     AccessMode.S: False,  AccessMode.SIX: False,
                     AccessMode.X: False},
    AccessMode.X:   {AccessMode.IS: False, AccessMode.IX: False,
                     AccessMode.S: False,  AccessMode.SIX: False,
                     AccessMode.X: False},
}


def compatible(held: AccessMode, requested: AccessMode) -> bool:
    return _COMPAT[held][requested]


@dataclasses.dataclass(frozen=True)
class ResourceId:
    """Hierarchical resource: database -> relation -> block -> tuple
    (transaction/ResourceId.hpp)."""
    db: int = 0
    relation: int = -1
    block: int = -1
    tuple_id: int = -1

    def parent(self) -> Optional["ResourceId"]:
        if self.tuple_id >= 0:
            return ResourceId(self.db, self.relation, self.block)
        if self.block >= 0:
            return ResourceId(self.db, self.relation)
        if self.relation >= 0:
            return ResourceId(self.db)
        return None


class TransactionStatus(enum.Enum):
    RUNNING = "running"
    ABORTED = "aborted"
    COMMITTED = "committed"


class LockTable:
    """Per-resource owned/pending lists (transaction/LockTable.hpp)."""

    def __init__(self):
        self.owned: Dict[ResourceId, List[Tuple[int, AccessMode]]] = \
            defaultdict(list)
        self.pending: Dict[ResourceId, deque] = defaultdict(deque)

    def can_grant(self, rid: ResourceId, tid: int, mode: AccessMode) -> bool:
        for owner_tid, held in self.owned[rid]:
            if owner_tid != tid and not compatible(held, mode):
                return False
        return True

    def grant(self, rid: ResourceId, tid: int, mode: AccessMode) -> None:
        entries = self.owned[rid]
        for i, (t, held) in enumerate(entries):
            if t == tid:
                if held < mode:
                    entries[i] = (tid, mode)  # upgrade
                return
        entries.append((tid, mode))

    def release_all(self, tid: int) -> List[ResourceId]:
        touched = []
        for rid, entries in list(self.owned.items()):
            kept = [(t, m) for t, m in entries if t != tid]
            if len(kept) != len(entries):
                touched.append(rid)
                if kept:
                    self.owned[rid] = kept
                else:
                    del self.owned[rid]
        for rid, q in list(self.pending.items()):
            self.pending[rid] = deque((t, m) for t, m in q if t != tid)
            if rid not in [r for r in touched] and \
                    len(self.pending[rid]) != len(q):
                touched.append(rid)
        return touched


class TransactionTable:
    """Per-transaction owned/pending lock lists (transaction/TransactionTable.hpp)."""

    def __init__(self):
        self.status: Dict[int, TransactionStatus] = {}
        self.owned: Dict[int, Set[Tuple[ResourceId, AccessMode]]] = \
            defaultdict(set)

    def begin(self, tid: int) -> None:
        self.status[tid] = TransactionStatus.RUNNING

    def finish(self, tid: int, status: TransactionStatus) -> None:
        self.status[tid] = status
        self.owned.pop(tid, None)


class DeadLockDetector:
    """Waits-for graph cycle detection via Tarjan SCC
    (transaction/DeadLockDetector.hpp:54, StronglyConnectedComponents.hpp)."""

    @staticmethod
    def find_victims(waits_for: Dict[int, Set[int]]) -> List[int]:
        """Returns one victim per cycle (the youngest = largest tid, matching the
        reference's pick of the highest transaction id in each SCC)."""
        index = {}
        low = {}
        on_stack = set()
        stack: List[int] = []
        counter = [0]
        victims: List[int] = []
        nodes = set(waits_for) | {w for s in waits_for.values() for w in s}

        def strongconnect(v):
            # iterative Tarjan
            work = [(v, iter(sorted(waits_for.get(v, ()))))]
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            on_stack.add(v)
            while work:
                node, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        on_stack.add(w)
                        work.append((w, iter(sorted(waits_for.get(w, ())))))
                        advanced = True
                        break
                    elif w in on_stack:
                        low[node] = min(low[node], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    low[work[-1][0]] = min(low[work[-1][0]], low[node])
                if low[node] == index[node]:
                    scc = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        scc.append(w)
                        if w == node:
                            break
                    has_cycle = len(scc) > 1 or (
                        node in waits_for.get(node, ()))
                    if has_cycle:
                        victims.append(max(scc))

        for v in sorted(nodes):
            if v not in index:
                strongconnect(v)
        return victims


class LockManager:
    """2PL lock acquisition with queuing and deadlock resolution
    (transaction/LockManager.hpp:52)."""

    def __init__(self):
        self._mutex = threading.Lock()
        self.lock_table = LockTable()
        self.txn_table = TransactionTable()
        self.waits_for: Dict[int, Set[int]] = defaultdict(set)

    def begin(self, tid: int) -> None:
        with self._mutex:
            self.txn_table.begin(tid)

    def acquire(self, tid: int, rid: ResourceId, mode: AccessMode) -> bool:
        """True = granted; False = queued (caller waits and retries after a
        release or deadlock resolution). Intention locks are taken on ancestors
        automatically (hierarchical locking)."""
        with self._mutex:
            # ancestors get intention locks
            chain = []
            p = rid.parent()
            while p is not None:
                chain.append(p)
                p = p.parent()
            imode = AccessMode.IS if mode in (AccessMode.IS, AccessMode.S) \
                else AccessMode.IX
            for anc in reversed(chain):
                if self.lock_table.can_grant(anc, tid, imode):
                    self.lock_table.grant(anc, tid, imode)
                    self.txn_table.owned[tid].add((anc, imode))
                else:
                    self._enqueue(tid, anc, imode)
                    return False
            if self.lock_table.can_grant(rid, tid, mode):
                self.lock_table.grant(rid, tid, mode)
                self.txn_table.owned[tid].add((rid, mode))
                return True
            self._enqueue(tid, rid, mode)
            return False

    def _enqueue(self, tid: int, rid: ResourceId, mode: AccessMode) -> None:
        self.lock_table.pending[rid].append((tid, mode))
        for owner_tid, held in self.lock_table.owned[rid]:
            if owner_tid != tid and not compatible(held, mode):
                self.waits_for[tid].add(owner_tid)

    def release_all(self, tid: int,
                    status: TransactionStatus = TransactionStatus.COMMITTED
                    ) -> List[Tuple[int, ResourceId, AccessMode]]:
        """Release tid's locks; grant newly-compatible pending requests.
        Returns the granted (tid, rid, mode) list."""
        with self._mutex:
            self.lock_table.release_all(tid)
            self.txn_table.finish(tid, status)
            self.waits_for.pop(tid, None)
            for waiters in self.waits_for.values():
                waiters.discard(tid)
            granted = []
            for rid, q in self.lock_table.pending.items():
                still = deque()
                for wtid, wmode in q:
                    if self.lock_table.can_grant(rid, wtid, wmode):
                        self.lock_table.grant(rid, wtid, wmode)
                        self.txn_table.owned[wtid].add((rid, wmode))
                        self.waits_for.pop(wtid, None)
                        granted.append((wtid, rid, wmode))
                    else:
                        still.append((wtid, wmode))
                self.lock_table.pending[rid] = still
            return granted

    def run_deadlock_detection(self) -> List[int]:
        """Abort victims of any waits-for cycle; returns aborted tids
        (the LockManager thread's periodic kill-victims pass)."""
        with self._mutex:
            victims = DeadLockDetector.find_victims(dict(self.waits_for))
        for v in victims:
            self.release_all(v, TransactionStatus.ABORTED)
        return victims
