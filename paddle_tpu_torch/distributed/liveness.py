"""Progress-judged liveness (a copy of
``paddle_tpu/distributed/liveness.py``): the one counter-vs-local-clock
core.

A peer publishes a monotonically increasing counter (``store.add``),
and an observer judges it dead when the counter stops *progressing*
against the OBSERVER's own monotonic clock. Wall clocks never cross the
wire, so cross-host clock skew cannot fabricate a death.
:class:`ProgressJudge` is that bookkeeping, once:
``membership.ReplicaDirectory`` and the router's ``RouterLink`` delegate
to it.
"""

import time
from typing import Dict, Optional, Tuple

__all__ = ["ProgressJudge"]


class ProgressJudge:
    """Observer-local progress state: key -> (last counter, local
    monotonic time that counter last ADVANCED).

    The contract, shared by every caller:

    - :meth:`update` folds one observation in and reports whether the
      counter progressed. The FIRST observation of a key always counts
      as progress (the key just became visible); afterwards only a
      changed non-None counter does. A ``None`` counter (transient
      store-read failure) never counts as progress but also never
      *resets* the progress clock — only elapsed time without observed
      progress kills a peer.
    - :meth:`stalled_for` is how long the key has gone without
      progress on THIS observer's clock; the caller compares it to its
      own TTL / dead-after horizon.
    """

    def __init__(self):
        self._seen: Dict[object, Tuple[Optional[int], float]] = {}

    def has(self, key) -> bool:
        """True once the key has been observed at least once."""
        return key in self._seen

    def update(self, key, counter: Optional[int],
               now: Optional[float] = None) -> bool:
        """Fold one counter observation; True iff it PROGRESSED."""
        now = time.monotonic() if now is None else now
        prev = self._seen.get(key)
        if prev is None or (counter is not None and counter != prev[0]):
            self._seen[key] = (counter, now)
            return True
        return False

    def stalled_for(self, key,
                    now: Optional[float] = None) -> Optional[float]:
        """Seconds since the key last progressed (None = never seen)."""
        prev = self._seen.get(key)
        if prev is None:
            return None
        return (time.monotonic() if now is None else now) - prev[1]

    def alive(self, key, ttl: float,
              now: Optional[float] = None) -> bool:
        """True while the key's last progress is within ``ttl``."""
        stalled = self.stalled_for(key, now=now)
        return stalled is not None and stalled <= ttl

    def forget(self, key):
        self._seen.pop(key, None)
