"""Disaggregated prefill/decode serving, its one-host half (counterpart
of ``paddle_tpu/serving/disagg.py``): the fleet-wide prefix directory.

- **prefill replicas** (``PagedDecodeEngine(prefill_only=True)``) run
  bucketed prefill only; the finished pages leave over the KV wire
  (``serving/kv_transfer.py``) as a per-request handoff blob.
- **decode replicas** install handoff pages (``engine.submit_handoff``)
  and run the normal harvest pipeline — on the fp32 wire the token
  stream is that of same-replica serving.
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

The replica serve loops (``serve_prefill_replica``,
``serve_decode_replica``), ``replica_load``, ``queue_age_s``, the
router, membership and liveness need processes and land with ROADMAP
item 7b (S4b-2).
"""

import json
import time
from typing import Dict, Optional

from paddle_tpu_torch import stats
from paddle_tpu_torch.distributed import resilience
from paddle_tpu_torch.serving import kv_transfer

__all__ = ["FleetPrefixDirectory"]


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
