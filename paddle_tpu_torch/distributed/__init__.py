"""Distributed runtime pieces of the port (counterpart of
``paddle_tpu/distributed``): the serving fleet's resilience layer
(``resilience``: deadlines, the retry policy, the guarded store, the
collective watchdog), progress-judged liveness (``liveness``) and
replica membership (``membership``)."""

from paddle_tpu_torch.distributed import liveness, membership, resilience
from paddle_tpu_torch.distributed.liveness import ProgressJudge
from paddle_tpu_torch.distributed.membership import ReplicaDirectory
from paddle_tpu_torch.distributed.resilience import (
    CollectiveStallError, CollectiveWatchdog, Deadline, DeadlineExceeded,
    GuardedStore, RetryPolicy, StorePartitioned, store_get, store_retry_s,
    store_set, with_deadline)

__all__ = ["resilience", "liveness", "membership", "RetryPolicy",
           "Deadline", "DeadlineExceeded", "CollectiveStallError",
           "CollectiveWatchdog", "with_deadline", "store_get", "store_set",
           "GuardedStore", "StorePartitioned", "store_retry_s",
           "ProgressJudge", "ReplicaDirectory"]
