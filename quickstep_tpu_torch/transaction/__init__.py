# Copied from quickstep_tpu/transaction/__init__.py; only the package name in imports differs.
from quickstep_tpu_torch.transaction.lock_manager import (  # noqa: F401
    AccessMode, LockManager, LockTable, TransactionTable, DeadLockDetector,
    ResourceId, TransactionStatus,
)
