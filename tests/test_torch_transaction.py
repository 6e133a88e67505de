"""The 6 cases of tests/test_transaction.py against the port's copy of the
2PL lock manager and deadlock detector (quickstep_tpu_torch/transaction/,
a copy of quickstep_tpu/transaction/)."""

from quickstep_tpu_torch.transaction import (
    AccessMode, DeadLockDetector, LockManager, ResourceId, TransactionStatus,
)
from quickstep_tpu_torch.transaction.lock_manager import compatible


def test_compatibility_matrix():
    assert compatible(AccessMode.IS, AccessMode.IX)
    assert compatible(AccessMode.S, AccessMode.S)
    assert not compatible(AccessMode.S, AccessMode.X)
    assert not compatible(AccessMode.X, AccessMode.IS)
    assert not compatible(AccessMode.IX, AccessMode.S)
    assert compatible(AccessMode.SIX, AccessMode.IS)
    assert not compatible(AccessMode.SIX, AccessMode.SIX)


def test_shared_then_exclusive_queues():
    lm = LockManager()
    rel = ResourceId(0, 1)
    lm.begin(1)
    lm.begin(2)
    assert lm.acquire(1, rel, AccessMode.S)
    assert lm.acquire(2, rel, AccessMode.S)      # shared is compatible
    lm.begin(3)
    assert not lm.acquire(3, rel, AccessMode.X)  # queued
    granted = lm.release_all(1)
    assert granted == []                          # txn 2 still holds S
    granted = lm.release_all(2)
    assert (3, rel, AccessMode.X) in granted


def test_hierarchical_intention_locks():
    lm = LockManager()
    block = ResourceId(0, 1, 5)
    lm.begin(1)
    assert lm.acquire(1, block, AccessMode.X)
    # relation ancestor now holds IX for txn 1 -> S on relation conflicts
    lm.begin(2)
    assert not lm.acquire(2, ResourceId(0, 1), AccessMode.S)


def test_upgrade():
    lm = LockManager()
    rel = ResourceId(0, 1)
    lm.begin(1)
    assert lm.acquire(1, rel, AccessMode.S)
    assert lm.acquire(1, rel, AccessMode.X)   # self-upgrade allowed when alone


def test_deadlock_detection():
    # 1 -> 2 -> 3 -> 1 cycle plus an innocent 4 -> 1 edge
    waits = {1: {2}, 2: {3}, 3: {1}, 4: {1}}
    victims = DeadLockDetector.find_victims(waits)
    assert victims == [3]  # youngest in the cycle


def test_deadlock_resolution_unblocks():
    lm = LockManager()
    a, b = ResourceId(0, 1), ResourceId(0, 2)
    lm.begin(1)
    lm.begin(2)
    assert lm.acquire(1, a, AccessMode.X)
    assert lm.acquire(2, b, AccessMode.X)
    assert not lm.acquire(1, b, AccessMode.X)   # 1 waits on 2
    assert not lm.acquire(2, a, AccessMode.X)   # 2 waits on 1 -> deadlock
    victims = lm.run_deadlock_detection()
    assert victims == [2]
    assert lm.txn_table.status[2] == TransactionStatus.ABORTED
    # txn 1's pending request for b was granted during victim release
    assert (b, AccessMode.X) in lm.txn_table.owned[1]
