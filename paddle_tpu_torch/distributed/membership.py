"""Serving-replica membership over a store (a copy of
``paddle_tpu/distributed/membership.py``).

The serving router (``serving/router.py``) needs replicas to be
*discoverable* (the router learns who exists), *describable* (slots,
pid, endpoint) and *judgeable* (alive or dead, so queued work can be
redistributed). Replicas never form a collective.

The store has no key-listing op, so announcements go through a counter
index: ``announce`` bumps ``<ns>/n`` and writes ``<ns>/idx/<i>`` ->
replica id, plus ``<ns>/meta/<rid>`` with the JSON metadata. Liveness
is the shared progress-judged core (``distributed/liveness.py``):
heartbeats are monotonically increasing counters (``store.add``), and a
peer is dead when its counter stops *progressing* against the
OBSERVER's local clock.

Replicas also carry a LIFECYCLE STATE (``<ns>/state/<rid>``) for the
drain protocol: ``up`` (default, routable), ``draining`` (the router
stops placing new work; the replica finishes or hands back its
in-flight requests), ``drained`` (the replica finished its drain and is
about to exit).
"""

import json
import time
from typing import Dict, Optional

from paddle_tpu_torch import native
from paddle_tpu_torch.distributed import resilience
from paddle_tpu_torch.distributed.liveness import ProgressJudge

__all__ = ["ReplicaDirectory"]


class ReplicaDirectory:
    """Announce/discover/judge serving replicas on a shared TCPStore.

    One instance per process; the router polls :meth:`members` +
    :meth:`alive`, each replica calls :meth:`announce` once and
    :meth:`heartbeat` from its serve loop.
    """

    def __init__(self, store, namespace: str = "serve"):
        self.store = store
        self.ns = namespace
        # observer-local liveness state: the shared progress-judged
        # core (one bookkeeping implementation for elastic + serving)
        self._judge = ProgressJudge()

    # -- replica side -------------------------------------------------------

    def announce(self, rid: str, meta: Optional[dict] = None,
                 retry: Optional[resilience.RetryPolicy] = None,
                 deadline: float = 15.0):
        """Register ``rid`` (idempotent for re-announce: metadata is
        overwritten, the index gains at most one extra pointer).

        At fleet spawn a worker can reach this before the router's
        store has finished binding, so the whole registration runs
        under a `resilience.RetryPolicy` — a slow bind costs backoff,
        not a dead-on-arrival worker (which the controller would then
        heal-loop on). ``state`` is re-seeded ``up`` only when absent,
        so a re-announce after a router failover cannot resurrect a
        draining replica into the routable pool.

        ``meta`` carries the replica's STATIC description — the router
        reads it once per membership refresh. The serving fields the
        disaggregated router places by: ``role`` (``prefill`` /
        ``decode`` / ``both``), ``page`` (KV page size), ``max_bucket``
        (largest prefill bucket — the router's bucket-fit screen),
        ``slots``."""
        def register():
            self.store.set(f"{self.ns}/meta/{rid}",
                           json.dumps(meta or {}))
            # seed the lifecycle state so state() hits on the first
            # read — a missing key costs the full store get-with-wait
            # timeout — but never clobber an existing (draining) state
            try:
                self.store.get(f"{self.ns}/state/{rid}", timeout=0.02)
            except (TimeoutError, ValueError):
                self.store.set(f"{self.ns}/state/{rid}", "up")
            i = self.store.add(f"{self.ns}/n", 1)
            self.store.set(f"{self.ns}/idx/{i}", rid)
            self.heartbeat(rid)

        pol = retry or resilience.RetryPolicy(
            max_attempts=16, base_delay=0.05, max_delay=1.0,
            deadline=deadline)
        pol.run(register, op="membership.announce",
                retry_on=(ConnectionError, OSError, RuntimeError,
                          resilience.StorePartitioned),
                deadline=resilience.Deadline(deadline))

    def heartbeat(self, rid: str, load: Optional[dict] = None,
                  stats: Optional[dict] = None) -> int:
        """Bump the liveness counter; when ``load`` is given, refresh
        the replica's gauge-style load fields FIRST (so an observer
        that sees the new counter sees load at least that fresh).
        Routing state therefore costs the router ONE store read per
        replica per poll (:meth:`load`) — no per-request round trips.
        The disaggregated router's fields: ``queued`` (admission queue
        depth), ``free_slots``, ``free_pages``, ``kv_bytes``
        (outstanding KV bytes across live slots).

        ``stats`` attaches a full ``paddle_tpu_torch.stats.export()``
        snapshot the same way — the fleet telemetry plane
        (``observability/fleet.FleetStats``) merges the latest export
        per replica into the fleet-level /statsz, at the cost of one
        more store write per refresh beat (never per request)."""
        if load is not None:
            self.store.set(f"{self.ns}/load/{rid}", json.dumps(load))
        if stats is not None:
            self.store.set(f"{self.ns}/stats/{rid}", json.dumps(stats))
        return self.store.add(f"{self.ns}/hb/{rid}", 1)

    # -- observer side ------------------------------------------------------

    def members(self) -> Dict[str, dict]:
        """Every replica ever announced (dead ones included — liveness
        is :meth:`alive`'s call), rid -> metadata."""
        try:
            n = native.decode_counter(
                self.store.get(f"{self.ns}/n", timeout=0.05))
        except (TimeoutError, ValueError):
            return {}
        out: Dict[str, dict] = {}
        for i in range(1, n + 1):
            try:
                rid = self.store.get(f"{self.ns}/idx/{i}",
                                     timeout=0.2).decode()
                out[rid] = json.loads(
                    self.store.get(f"{self.ns}/meta/{rid}", timeout=0.2))
            except (TimeoutError, ValueError):
                continue
        return out

    def load(self, rid: str) -> Optional[dict]:
        """The replica's last heartbeat-refreshed load gauges (one
        store read), or None when it has never published any."""
        try:
            return json.loads(
                self.store.get(f"{self.ns}/load/{rid}", timeout=0.05))
        except (TimeoutError, ValueError):
            return None

    def stats_export(self, rid: str) -> Optional[dict]:
        """The replica's last heartbeat-attached ``stats.export()``
        snapshot (one store read), or None when it never attached
        one."""
        try:
            return json.loads(
                self.store.get(f"{self.ns}/stats/{rid}", timeout=0.05))
        except (TimeoutError, ValueError):
            return None

    def _counter(self, rid: str) -> Optional[int]:
        try:
            return native.decode_counter(
                self.store.get(f"{self.ns}/hb/{rid}", timeout=0.2))
        except (TimeoutError, ValueError):
            return None

    def alive(self, rid: str, dead_after: float = 2.0) -> bool:
        """True while ``rid``'s heartbeat counter keeps advancing;
        False once it stalls for ``dead_after`` seconds of THIS
        process's monotonic clock. A transient store-read failure never
        flips a previously-progressing replica dead by itself — only
        ``dead_after`` seconds without observed progress does."""
        now = time.monotonic()
        c = self._counter(rid)
        if c is None and not self._judge.has(rid):
            return False            # never seen a heartbeat at all
        if self._judge.update(rid, c, now=now):
            return True
        return self._judge.stalled_for(rid, now=now) <= dead_after

    # -- lifecycle state (drain protocol) -----------------------------------

    def set_state(self, rid: str, state: str):
        """Publish ``rid``'s lifecycle state: ``up`` (routable,
        implicit default), ``draining`` (controller asked it to retire
        — the router stops placing on it), ``drained`` (the replica
        finished every in-flight request and is exiting)."""
        if state not in ("up", "draining", "drained"):
            raise ValueError(f"replica state must be up|draining|"
                             f"drained, got {state!r}")
        self.store.set(f"{self.ns}/state/{rid}", state)

    def state(self, rid: str) -> str:
        """``rid``'s last published lifecycle state (announce seeds
        ``up``, so a registered replica's read always hits; ``up``
        is also the fallback for a never-registered rid)."""
        try:
            return self.store.get(f"{self.ns}/state/{rid}",
                                  timeout=0.02).decode()
        except (TimeoutError, ValueError):
            return "up"
