"""Disaggregated prefill/decode serving (counterpart of
``paddle_tpu/serving/disagg.py``): roles, the fleet-wide prefix
directory, and the replica serve loops.

- **prefill replicas** (``PagedDecodeEngine(prefill_only=True)``) run
  bucketed prefill only; the finished pages leave over the KV wire
  (``serving/kv_transfer.py``) as a per-request handoff blob
  (:func:`serve_prefill_replica`).
- **decode replicas** install handoff pages (``engine.submit_handoff``)
  and run the normal harvest pipeline — on the fp32 wire the token
  stream is that of same-replica serving (:func:`serve_decode_replica`).
- the **fleet prefix directory** (:class:`FleetPrefixDirectory`) layers
  ``inference/prefix_cache.py``'s page-aligned sha1 chain digests over a
  store: a replica publishes every newly-canonical prefix page
  (content-addressed — racing replicas converge), any replica's
  admission extends a local miss through the fleet (suffix-only prefill
  on a hit: ``serve/fleet_prefix_hit_tokens``), and local invalidation
  (poison) or reclaim (eviction) WITHDRAWS the digest fleet-wide through
  the prefix cache's ``on_drop`` hook before the page can be remapped. A
  fetch re-validates the directory entry's generation after reading the
  payload, so a withdraw racing a fetch makes the fetch a miss.

Placement lives in ``serving/router.py`` (role- and KV-bytes-aware);
this module owns the per-replica halves. ``replica_load`` and
``queue_age_s`` are the gauges a replica's heartbeat carries.
"""

import json
import os
import time
from typing import Dict, Optional

from paddle_tpu_torch import stats
from paddle_tpu_torch.distributed import resilience
from paddle_tpu_torch.serving import kv_transfer

__all__ = ["FleetPrefixDirectory", "serve_prefill_replica",
           "serve_decode_replica", "serve_role", "replica_load",
           "fleet_enabled", "queue_age_s"]


def serve_role() -> str:
    """This replica's serving role (``PT_SERVE_ROLE``):
    ``both`` (default — symmetric serving),
    ``prefill``, or ``decode``."""
    role = os.environ.get("PT_SERVE_ROLE", "both").strip().lower()
    if role not in ("both", "prefill", "decode"):
        raise ValueError(
            f"PT_SERVE_ROLE must be both|prefill|decode, got {role!r}")
    return role


def fleet_enabled() -> bool:
    """``PT_FLEET_PREFIX`` (default on): 0 disables fleet prefix
    directory publication and lookup — replicas fall back to their
    local radix caches only."""
    return os.environ.get("PT_FLEET_PREFIX", "1") != "0"


def queue_age_s(frontend=None, engine=None) -> float:
    """Age (seconds) of the OLDEST waiting request — the runaway-queue
    detector's per-replica gauge. Looks at the front-end admission
    queue and/or the engine's own waiting deque (whichever the caller
    has); 0.0 when nothing waits."""
    now = time.perf_counter()
    ages = [0.0]
    if frontend is not None and frontend._queue:
        ages.append(now - min(r.t_submit for r in frontend._queue))
    eng = engine if engine is not None else (
        frontend.engine if frontend is not None else None)
    if eng is not None and eng._waiting:
        ages.append(now - min(r.t_submit for r in eng._waiting))
    return max(ages)


def replica_load(engine, role: str, queued: int = 0,
                 queue_age_s: float = 0.0) -> dict:
    """The gauge-style load fields a replica refreshes with its
    heartbeat (one store write per beat, one read per router poll):
    role-aware routing places prefill by ``queued`` + bucket fit and
    decode by ``kv_bytes`` + ``free_pages``; the fleet anomaly watch
    (``observability/fleet``) reads ``tokens`` (progress — a busy replica
    whose counter freezes is stalled), ``busy_slots``, ``queue_age_s``
    and ``total_pages``/``free_pages`` (pool exhaustion)."""
    return {
        "role": role,
        "queued": int(queued),
        "free_slots": int(engine.free_slots),
        "busy_slots": int(engine.S - engine.free_slots),
        "free_pages": int(getattr(engine, "free_pages", 0)),
        "total_pages": int(getattr(engine, "P", 0)),
        "kv_bytes": int(getattr(engine, "kv_bytes", 0)),
        "tokens": int(engine.tokens_emitted),
        "queue_age_s": round(float(queue_age_s), 3),
        # process-local fleet counters ride the heartbeat so the
        # router/CI can assert cross-replica hits without scraping
        # replica processes
        "fleet_hit_tokens": int(stats.get(
            "serve/fleet_prefix_hit_tokens", 0)),
        "kv_transfer_bytes_wire": int(stats.get(
            "serve/kv_transfer_bytes_wire", 0)),
    }


class FleetPrefixDirectory:
    """Fleet-wide radix-digest directory over a store (``native.TCPStore``
    or anything with its ``set``/``get``/``add``/``delete_key``).

    One instance per replica (``rid`` identifies the owner for withdraw
    bookkeeping). Content-addressed entries::

        fleetpfx/e/<digest-hex>        -> JSON {rid, gen}   (written LAST)
        fleetpfx/pg/<digest-hex>/<gen> -> KV-wire blob (chunked)
        fleetpfx/g/<digest-hex>        -> generation counter
        fleetpfx/l/<digest-hex>        -> fetch lease counter

    The **refcount lease** protocol: a fetcher bumps the lease before
    reading the payload and drops it after; a withdraw deletes the ENTRY
    first (no new fetchers) and the payload chunks only at lease zero (an
    in-flight fetch finishes its read, then discards when the entry
    re-check fails)."""

    def __init__(self, store, rid: str, wire: Optional[str] = None,
                 namespace: str = "fleetpfx"):
        self.store = store
        self.rid = rid
        self.ns = namespace
        self.wire = kv_transfer.wire_format(wire)
        self._published: Dict[bytes, int] = {}   # digest -> gen (owner)

    # -- keys ---------------------------------------------------------------

    def _ekey(self, digest: bytes) -> str:
        return f"{self.ns}/e/{digest.hex()}"

    def _pkey(self, digest: bytes, gen: int) -> str:
        return f"{self.ns}/pg/{digest.hex()}/{gen}"

    # -- owner side ---------------------------------------------------------

    def publish(self, digest: bytes, k, v):
        """Publish one page's KV under its chain digest (k/v:
        (L, 1, Hkv, page, D) host tensors). Racing publishers write
        identical content (pages are deterministic in the weights, and
        lossy-wire copies are never re-published), each under its own
        generation: the last entry write wins, fetchers re-validate the
        generation, and each publisher deletes only its own generation's
        chunks on withdraw."""
        if digest in self._published:
            return
        try:
            gen = self.store.add(f"{self.ns}/g/{digest.hex()}", 1)
            page = k.shape[3]
            header, blob = kv_transfer.encode_kv_pages(
                k, v, n_tokens=page, wire=self.wire)
            kv_transfer.publish_blob(self.store, self._pkey(digest, gen),
                                     header, blob)
            # entry LAST: a reader that sees it can fetch the payload
            self.store.set(self._ekey(digest),
                           json.dumps({"rid": self.rid, "gen": gen}))
        except resilience.StorePartitioned:
            # publication is warmth, not correctness: skipped, and NOT
            # marked published (a later registration retries)
            stats.add("serve/fleet_prefix_publish_skipped")
            return
        self._published[digest] = gen
        stats.add("serve/fleet_prefix_published")

    def reset_published(self):
        """Forget what this replica has published (a new store generation
        starts empty); the engine's ``fleet_republish`` then walks the
        live radix cache and publishes again."""
        self._published.clear()

    def withdraw(self, digest: bytes, force: bool = False):
        """Invalidate a digest fleet-wide (eviction or poison on the
        owning replica; the prefix cache's ``on_drop`` hook lands here).
        Non-owners no-op unless ``force`` — a replica dropping its
        private ADOPTED copy must not remove the owner's entry. The entry
        key is deleted only while it still carries THIS replica's (rid,
        gen); our own generation's payload chunks are deleted at lease
        zero, else by the discarding fetcher (:meth:`fetch`)."""
        gen = self._published.pop(digest, None)
        if gen is None and not force:
            return
        try:
            ent = None
            try:
                ent = json.loads(self.store.get(self._ekey(digest),
                                                timeout=0.05))
            except (TimeoutError, ValueError):
                pass
            if gen is None and ent is not None:   # force: current gen
                gen = int(ent["gen"])
            if ent is not None and (force or (
                    ent.get("rid") == self.rid
                    and int(ent.get("gen", -1)) == gen)):
                self.store.delete_key(self._ekey(digest))
            if gen is not None:
                leases = int(self.store.add(f"{self.ns}/l/{digest.hex()}",
                                            0))
                if leases <= 0:
                    kv_transfer.delete_blob(self.store,
                                            self._pkey(digest, gen))
            stats.add("serve/fleet_prefix_withdrawn")
        except (RuntimeError, ConnectionError):
            pass                        # withdraw is best-effort

    # -- fetcher side -------------------------------------------------------

    def lookup(self, digest: bytes) -> bool:
        """Directory-only probe (no payload): is the digest published?"""
        try:
            self.store.get(self._ekey(digest), timeout=0.02)
            return True
        except (TimeoutError, resilience.StorePartitioned):
            return False

    def covered(self, chain) -> int:
        """How many LEADING digests of ``chain`` the fleet covers."""
        n = 0
        for digest in chain:
            if not self.lookup(digest):
                break
            n += 1
        return n

    def fetch(self, digest: bytes):
        """Fetch one page's KV as (k, v) CPU tensors, or None on a miss.
        The entry is re-read AFTER the payload: if it vanished or changed
        generation mid-fetch (a racing withdraw), the payload is
        DISCARDED — the invalidation wins. A payload that fails the wire
        guard raises RuntimeError."""
        key = self._ekey(digest)
        try:
            ent = json.loads(self.store.get(key, timeout=0.02))
        except (TimeoutError, ValueError, resilience.StorePartitioned):
            return None
        gen = int(ent["gen"])
        lease = f"{self.ns}/l/{digest.hex()}"
        try:
            self.store.add(lease, 1)
            t0 = time.perf_counter()
            try:
                header, blob = kv_transfer.fetch_blob(
                    self.store, self._pkey(digest, gen), timeout=2.0)
            except TimeoutError:
                self.store.add(lease, -1)
                return None             # withdrawn mid-fetch
            leases = self.store.add(lease, -1)
        except resilience.StorePartitioned:
            return None                 # partition mid-fetch: a miss
        try:
            ent2 = json.loads(self.store.get(key, timeout=0.02))
            stale = int(ent2["gen"]) != gen
        except (TimeoutError, ValueError, resilience.StorePartitioned):
            stale = True                # withdrawn mid-fetch: discard
        if stale:
            # the owner's withdraw skipped chunk deletion while our lease
            # was out: the discarding fetcher cleans up
            if leases <= 0:
                kv_transfer.delete_blob(self.store,
                                        self._pkey(digest, gen),
                                        nchunks=int(header["nchunks"]))
            return None
        k, v = kv_transfer.decode_kv_pages(header, blob)
        stats.observe("serve/kv_transfer_s", time.perf_counter() - t0)
        return k, v


# ---------------------------------------------------------------------------
# Replica serve loops (the role-split halves of router.serve_replica)
# ---------------------------------------------------------------------------

def serve_prefill_replica(store, rid: str, engine, poll_s: float = 0.02,
                          max_idle_s: Optional[float] = None,
                          load_refresh_s: float = 0.25):
    """One prefill replica's loop: consume the mailbox, run big-bucket
    prefill only, and for each finished prefill publish the KV handoff
    blob (``serve/kv/<req_id>``) plus a ``prefill-done`` result — the
    router then places the decode phase on a decode replica. Requests
    whose whole budget was the first token (or that failed) publish
    their terminal result directly.

    ``engine`` must be a ``PagedDecodeEngine(prefill_only=True)``;
    attach a :class:`FleetPrefixDirectory` first so every prefix this
    replica prefills becomes a fleet-wide hit."""
    from paddle_tpu_torch.observability import flight, runtime, trace
    from paddle_tpu_torch.serving.router import ReplicaSession
    if not getattr(engine, "prefill_only", False):
        raise ValueError("serve_prefill_replica needs a "
                         "prefill_only=True engine")
    sess = ReplicaSession(
        store, rid,
        meta={"pid": os.getpid(), "slots": engine.S, "role": "prefill",
              "page": engine.page, "max_bucket": engine.buckets[-1]},
        transport=kv_transfer.maybe_transport(),
        engine=engine, fleet=getattr(engine, "fleet", None))
    sess.announce()
    open_reqs: Dict[str, object] = {}
    idle_since = time.monotonic()
    last_load = 0.0
    draining = False
    while True:
        sess.maintain()
        sess.pump_transport()
        now = time.monotonic()
        if now - last_load >= load_refresh_s:
            runtime.hbm_gauges()
            sess.heartbeat(load=replica_load(
                engine, "prefill", queued=engine.queued,
                queue_age_s=queue_age_s(engine=engine)),
                stats_export=stats.export())
            last_load = now
            draining = draining or sess.lifecycle() == "draining"
        else:
            sess.heartbeat()
        # mailbox BEFORE the drain/shutdown exit checks: a request
        # placed just before the drain decision must be consumed and
        # finished here, not stranded for the death sweep
        for msg in sess.pump_mailbox():
            if msg.get("id") in open_reqs:
                continue        # duplicate re-place of in-flight work
            try:
                req = engine.submit(
                    msg["prompt"],
                    max_new_tokens=msg["max_new_tokens"],
                    eos_id=msg["eos_id"],
                    deadline_s=msg.get("deadline_s"),
                    req_id=msg["id"])
            except ValueError as e:
                # infeasible request: fail AS A RESULT (router.serve_
                # replica's cascade rationale)
                sess.publish(msg["id"], {
                    "id": msg["id"], "tokens": [],
                    "status": "rejected-invalid", "error": str(e),
                    "replica": rid})
                continue
            open_reqs[msg["id"]] = req
        if draining and not open_reqs:
            # drain protocol: every accepted prefill finished (handed
            # off or terminal) — publish drained and exit
            sess.set_state("drained")
            sess.close()
            return
        if sess.shutdown_requested() and not open_reqs:
            sess.close()
            return
        if open_reqs:
            # in-flight prefill keeps computing through a partition —
            # degrade, never die
            engine.step()
            idle_since = time.monotonic()
        else:
            if sess.partitioned:
                # never idle-exit into a partition: the router may be
                # mid-failover and about to re-place work here
                idle_since = time.monotonic()
            if (max_idle_s is not None
                    and time.monotonic() - idle_since > max_idle_s):
                sess.close()
                return
            time.sleep(poll_s)
        for req_id, req in list(open_reqs.items()):
            if req.failed or req.done:
                # deadline/poison eviction, or a budget-1 request that
                # retired at harvest: terminal here, no decode phase
                sess.publish(req_id, {
                    "id": req_id, "tokens": list(req.tokens),
                    "status": ("failed" if req.failed else "done"),
                    "error": req.error, "replica": rid})
                del open_reqs[req_id]
            elif req.tokens:
                # prefill harvested: hand off to a decode replica
                t0 = time.perf_counter()
                meta, k, v = engine.detach_handoff(req)
                header, blob = kv_transfer.encode_kv_pages(
                    k, v, n_tokens=meta["n_tokens"], rid=req_id)
                # stamp the wire into the handoff meta: the decode
                # replica refuses to re-publish lossy-wire pages under
                # the original content digest (quantization error must
                # not compound across hops)
                header["handoff"] = dict(meta, wire=header["wire"])
                try:
                    kv_ep = kv_transfer.send_handoff(
                        sess.store, sess.transport, f"serve/kv/{req_id}",
                        header, blob)
                except resilience.StorePartitioned as e:
                    # blob publication lost to the partition: still
                    # emit prefill-done (buffered) — the decode fetch
                    # misses, handoff-failed re-places from scratch
                    sess.link.note_partition(e)
                    kv_ep = None
                trace.complete("serve/kv_publish", t0, rid=req_id,
                               bytes=len(blob))
                flight.record(req_id, "handoff-publish",
                              bytes=len(blob), wire=header["wire"],
                              plane=("socket" if kv_ep else "store"))
                sess.publish(req_id, {
                    "id": req_id, "tokens": [],
                    "status": "prefill-done", "error": None,
                    "kv_ep": kv_ep, "replica": rid},
                    terminal=False)
                del open_reqs[req_id]


def serve_decode_replica(store, rid: str, frontend,
                         fleet: Optional[FleetPrefixDirectory] = None,
                         poll_s: float = 0.02,
                         max_idle_s: Optional[float] = None,
                         load_refresh_s: float = 0.25):
    """One decode replica's loop: ``router.serve_replica``'s loop plus two
    disaggregation duties — ``handoff`` mailbox messages install
    transferred KV pages (``frontend.submit_handoff``), and the
    engine's fleet directory (attach before calling) turns any
    replica's warm prefix into a local suffix-only prefill. Plain
    ``req`` messages serve end-to-end exactly as symmetric replicas
    (the router's fallback when no prefill replica is alive)."""
    from paddle_tpu_torch.observability import flight, runtime, trace
    from paddle_tpu_torch.serving.router import (ReplicaSession,
                                           _migrate_open_requests,
                                           drain_migrate_enabled)
    engine = frontend.engine
    sess = ReplicaSession(
        store, rid,
        meta={"pid": os.getpid(), "slots": engine.S, "role": "decode",
              "page": getattr(engine, "page", 0),
              "max_bucket": engine.buckets[-1]},
        transport=kv_transfer.maybe_transport(),
        engine=engine,
        fleet=fleet if fleet is not None
        else getattr(engine, "fleet", None))
    sess.announce()
    open_reqs: Dict[str, object] = {}
    idle_since = time.monotonic()
    last_load = 0.0
    draining = False
    while True:
        sess.maintain()
        sess.pump_transport()
        now = time.monotonic()
        if now - last_load >= load_refresh_s:
            runtime.hbm_gauges()
            sess.heartbeat(load=replica_load(
                engine, "decode",
                queued=len(frontend._queue) + engine.queued,
                queue_age_s=queue_age_s(frontend=frontend)),
                stats_export=stats.export())
            last_load = now
            draining = draining or sess.lifecycle() == "draining"
        else:
            sess.heartbeat()
        # mailbox BEFORE the drain/shutdown exit checks (rationale in
        # serve_prefill_replica above)
        for msg in sess.pump_mailbox():
            if msg.get("id") in open_reqs:
                continue        # duplicate re-place of in-flight work
            try:
                if msg.get("kind") == "handoff":
                    t0 = time.perf_counter()
                    kv_ep = msg.get("kv_ep")
                    try:
                        # bounded below dead_after-scale stalls, and
                        # heartbeat immediately after either way — a
                        # slow fetch must not get this healthy replica
                        # death-swept
                        header, blob = kv_transfer.fetch_handoff(
                            sess.store, sess.transport,
                            f"serve/kv/{msg['id']}", kv_ep=kv_ep,
                            timeout=2.0)
                    finally:
                        sess.heartbeat()
                    k, v = kv_transfer.decode_kv_pages(header, blob)
                    stats.observe("serve/kv_transfer_s",
                                  time.perf_counter() - t0)
                    trace.complete("serve/kv_transfer", t0,
                                   rid=msg["id"], bytes=len(blob))
                    flight.record(msg["id"], "handoff-fetch",
                                  bytes=len(blob),
                                  wire=header.get("wire"),
                                  plane=("socket" if kv_ep
                                         else "store"))
                    req = frontend.submit_handoff(
                        header["handoff"], k, v,
                        deadline_s=msg.get("deadline_s"),
                        req_id=msg["id"])
                    # sole consumer: reclaim the blob's memory
                    # (a redelivered handoff after this point fails
                    # the fetch -> handoff-failed -> router re-places
                    # from scratch; at-least-once keeps it safe)
                    kv_transfer.delete_handoff(
                        sess.store, sess.transport,
                        f"serve/kv/{msg['id']}", kv_ep=kv_ep,
                        nchunks=int(header.get("nchunks", 0)))
                else:
                    req = frontend.submit(
                        msg["prompt"],
                        max_new_tokens=msg["max_new_tokens"],
                        eos_id=msg.get("eos_id"),
                        deadline_s=msg.get("deadline_s"),
                        priority=msg.get("priority", 0),
                        req_id=msg["id"])
            except (TimeoutError, RuntimeError,
                    resilience.StorePartitioned) as e:
                # the handoff blob is missing/incomplete (prefill
                # replica died mid-transfer, store hiccup, partition
                # mid-fetch) or failed the wire integrity guards
                # (in-transit corruption — digest/scale-envelope
                # mismatch): publish the RETRYABLE status — the router
                # re-places the request from scratch (re-prefill /
                # re-decode), never surfaces this as a client-visible
                # rejection and never installs corrupted pages
                flight.record(msg["id"], "handoff-failed",
                              error=str(e))
                flight.dump(msg["id"], "handoff-failed")
                sess.publish(msg["id"], {
                    "id": msg["id"], "tokens": [],
                    "status": "handoff-failed", "error": str(e),
                    "replica": rid}, terminal=False)
                continue
            except ValueError as e:
                # infeasible request (bad geometry, over-budget):
                # terminal, but AS A RESULT, never the replica
                # (fail-loud per request, fleet stays up)
                if msg.get("kind") == "handoff":
                    # terminal failure consumes the blob too
                    kv_transfer.delete_handoff(
                        sess.store, sess.transport,
                        f"serve/kv/{msg['id']}",
                        kv_ep=msg.get("kv_ep"))
                sess.publish(msg["id"], {
                    "id": msg["id"], "tokens": [],
                    "status": "rejected-invalid", "error": str(e),
                    "replica": rid})
                continue
            open_reqs[msg["id"]] = req
        if draining and open_reqs and drain_migrate_enabled():
            # migrate in-flight decodes to surviving decode replicas
            # (mid-decode KV handoff, fp32 wire — byte-identical
            # streams) instead of finishing them here
            _migrate_open_requests(sess.store, rid, frontend, open_reqs,
                                   sess=sess)
        if draining and not open_reqs and not frontend.busy:
            # drain protocol: in-flight decodes finished, nothing
            # queued — publish drained and exit
            sess.set_state("drained")
            sess.close()
            return
        if sess.shutdown_requested() and not open_reqs \
                and not frontend.busy:
            sess.close()
            return
        if frontend.busy:
            # in-flight decode continues straight through a partition —
            # degrade, never die
            frontend.step()
            idle_since = time.monotonic()
        else:
            if sess.partitioned:
                # never idle-exit into a partition: the router may be
                # mid-failover and about to re-place work here
                idle_since = time.monotonic()
            if (max_idle_s is not None
                    and time.monotonic() - idle_since > max_idle_s):
                sess.close()
                return
            time.sleep(poll_s)
        for req_id, req in list(open_reqs.items()):
            if req.done:
                sess.publish(req_id, {
                    "id": req_id, "tokens": list(req.tokens),
                    "status": req.status, "error": req.error,
                    "replica": rid})
                del open_reqs[req_id]
