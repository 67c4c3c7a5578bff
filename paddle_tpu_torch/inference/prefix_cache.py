"""Prefix (radix) caching over the paged KV pool: identical prompt
prefixes are prefilled once and their pages shared read-only across
requests. A near-copy of ``paddle_tpu/inference/prefix_cache.py`` (which
imports no JAX), fleet-directory hooks included (``on_drop``,
``reclaimable_pages``, ``revive``, ``adopt``, ``last_registered``: the
``serving/disagg.FleetPrefixDirectory`` side of them).

- **Page-aligned token-hash chains.** The unit of sharing is one FULL
  page of prompt tokens. Node ``i`` of a prompt's chain is keyed by
  ``sha1(parent_digest + tokens[i*page:(i+1)*page])``, so the digest
  encodes the page's tokens and its whole left context, which is what
  fixes the page's KV content.
- **Refcounts, not ownership.** ``refs[pid]`` counts the slot tables a
  cached page is mapped into. ``unref`` at slot retirement moves a
  count-zero page to an LRU of reclaimable pages (its KV stays warm for
  the next hit); ``reclaim`` frees LRU-oldest count-zero pages under
  pool pressure.
- **Fleet hooks.** ``on_drop(digest, pid)`` runs whenever a trie node
  is removed (invalidate or reclaim), so a fleet directory withdraws the
  digest before the freed page can be remapped; ``adopt`` makes a page
  fetched from the fleet canonical locally, ``revive`` re-refs a stale
  descendant instead of refetching it, and ``last_registered`` lists the
  pages the last ``register`` made canonical (the ones to publish).
- **Read-only mapping + copy-on-write.** Matched pages enter a slot's
  table read-only: suffix prefill and decode only write positions at or
  past the match boundary, which live in private pages. The exception
  is a prompt that is an exact multiple of the page size and matches in
  full: its last token must re-run for first-token logits and its KV
  row lands INSIDE the last matched page, so the engine copies that
  page to a private one first (``PagedDecodeEngine._admit``).

Host-side bookkeeping only: no tensors.
"""

import collections
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["PrefixCache", "chain_digests"]


def chain_digests(tokens, page: int) -> List[bytes]:
    """Cumulative digests of ``tokens``' FULL pages (one per page; the
    trailing partial page has none — it is not shareable). Byte-for-byte
    the JAX package's definition."""
    toks = np.asarray(tokens, np.int32)
    out, digest = [], b"paged-prefix-v1"
    for i in range(len(toks) // page):
        h = hashlib.sha1(digest)
        h.update(toks[i * page:(i + 1) * page].tobytes())
        digest = h.digest()
        out.append(digest)
    return out


class PrefixCache:
    """Refcounted prefix trie over a ``PageAllocator``'s page ids. Pages
    the trie holds at refcount zero are NOT on the allocator's free list
    (they are warm cache); ``reclaim`` is the only way back to it."""

    def __init__(self, allocator, page_size: int):
        self._alloc = allocator
        self.page = int(page_size)
        self._nodes: Dict[bytes, int] = {}       # chain digest -> pid
        self._bypid: Dict[int, bytes] = {}       # pid -> chain digest
        self._refs: Dict[int, int] = {}          # pid -> live mappings
        # refcount-zero cached pages, oldest first (LRU reclaim order)
        self._zero: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        self._n_shared = 0                       # pages with refs > 0
        # invalidated (poisoned-KV) pages still mapped by live sharers:
        # their last unref frees them instead of warming the LRU
        self._dead: set = set()
        # fleet hook: called with (digest, pid) whenever a trie node is
        # REMOVED (invalidate / reclaim), before the page can be remapped
        self.on_drop = None
        # the (index, digest, pid) triples the last register made
        # canonical: the fleet publication hook publishes exactly these
        self.last_registered: List[Tuple[int, bytes, int]] = []

    def chain(self, tokens) -> List[bytes]:
        return chain_digests(tokens, self.page)

    def owns(self, pid: int) -> bool:
        """True iff ``pid`` is a cached (trie-held) page — released via
        ``unref``, never via the allocator free list."""
        return pid in self._bypid

    @property
    def cached_pages(self) -> int:
        return len(self._bypid)

    @property
    def shared_pages(self) -> int:
        """Cached pages currently mapped into at least one slot."""
        return self._n_shared

    @property
    def reclaimable_pages(self) -> int:
        return len(self._zero)

    def ref(self, pid: int):
        if pid not in self._bypid:
            raise KeyError(f"page {pid} is not cached")
        before = self._refs.get(pid, 0)
        if before == 0:
            self._n_shared += 1
        self._refs[pid] = before + 1
        self._zero.pop(pid, None)

    def unref(self, pid: int) -> Optional[int]:
        """Drop one mapping. Returns ``pid`` when this was the last ref
        of an INVALIDATED page and it went back to the allocator (the
        caller must scrub its rows before reuse), else None."""
        n = self._refs.get(pid, 0) - 1
        if n < 0:
            raise ValueError(f"unref of unmapped cached page {pid}")
        self._refs[pid] = n
        if n == 0:
            self._n_shared -= 1
            if pid in self._dead:
                self._dead.discard(pid)
                self._bypid.pop(pid, None)
                self._refs.pop(pid, None)
                self._alloc.release([pid])
                return pid
            self._zero[pid] = None
            self._zero.move_to_end(pid)
        return None

    def invalidate(self, pid: int) -> Optional[int]:
        """Drop ``pid``'s trie node so no future lookup maps it (a
        request evicted for non-finite logits must not leave its prefix
        canonical). Current sharers keep their mapping; the page returns
        to the allocator at the last unref. Returns ``pid`` when it was
        unmapped and went straight back (the caller scrubs it)."""
        digest = self._bypid.get(pid)
        if digest is None:
            return None
        if self._nodes.get(digest) == pid:
            # a stale invalidation (digest since re-registered with a
            # healthy page) leaves the new copy canonical
            self._nodes.pop(digest)
            if self.on_drop is not None:
                self.on_drop(digest, pid)
        if self._refs.get(pid, 0) == 0:
            self._zero.pop(pid, None)
            self._bypid.pop(pid)
            self._refs.pop(pid, None)
            self._alloc.release([pid])
            return pid
        self._dead.add(pid)
        return None

    def lookup(self, tokens, chain: Optional[List[bytes]] = None
               ) -> List[int]:
        """Longest cached prefix of ``tokens``: page ids of the leading
        full pages whose chain digests are all present, each ref'd for
        the caller (who must ``unref`` any it does not keep)."""
        pids: List[int] = []
        for digest in (self.chain(tokens) if chain is None else chain):
            pid = self._nodes.get(digest)
            if pid is None:
                break
            self.ref(pid)
            pids.append(pid)
        return pids

    def revive(self, digest: bytes) -> Optional[int]:
        """Ref-and-return the page canonical under ``digest``, or None.
        The fleet-extend path uses it for STALE DESCENDANTS: reclaim
        drops one node and leaves its children canonical but unreachable
        (lookup breaks at the hole); once the missing parents are
        refetched, the surviving child pages serve again (their KV is
        valid: the chain digest encodes the whole left context)."""
        pid = self._nodes.get(digest)
        if pid is None:
            return None
        self.ref(pid)
        return pid

    def adopt(self, digest: bytes, pid: int):
        """Insert ONE already-populated page under ``digest`` with the
        caller's mapping as its first ref — the fleet-fetch install path.
        Refuses an occupied digest or an already-cached pid."""
        if digest in self._nodes:
            raise KeyError("digest already canonical")
        if pid in self._bypid:
            raise KeyError(f"page {pid} already cached")
        self._nodes[digest] = pid
        self._bypid[pid] = digest
        self._refs[pid] = 1
        self._n_shared += 1

    def register(self, tokens, table: List[int],
                 chain: Optional[List[bytes]] = None) -> int:
        """Insert ``tokens``' full pages (backed by ``table``'s leading
        page ids) into the trie; already-present digests are skipped.
        Returns the number of pages newly registered (each gains the
        caller's mapping as its first ref); their ``(index, digest, pid)``
        triples land in ``last_registered``."""
        added = 0
        self.last_registered = []
        for i, digest in enumerate(self.chain(tokens)
                                   if chain is None else chain):
            if digest in self._nodes:
                continue
            pid = table[i]
            if pid in self._bypid:       # already canonical elsewhere
                continue
            self._nodes[digest] = pid
            self._bypid[pid] = digest
            self._refs[pid] = 1
            self._n_shared += 1
            self.last_registered.append((i, digest, pid))
            added += 1
        return added

    def reclaim(self, n_pages: int) -> int:
        """Free up to ``n_pages`` refcount-zero cached pages back to the
        allocator, LRU-oldest first. Returns the number freed."""
        freed = 0
        while freed < n_pages and self._zero:
            pid, _ = self._zero.popitem(last=False)
            digest = self._bypid.pop(pid)
            if self._nodes.get(digest) == pid:
                del self._nodes[digest]
                if self.on_drop is not None:
                    self.on_drop(digest, pid)
            self._refs.pop(pid, None)
            self._alloc.release([pid])
            freed += 1
        return freed
