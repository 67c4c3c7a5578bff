"""Per-request flight recorder (a copy of
``paddle_tpu/observability/flight.py``): a bounded ring of request event
timelines, dumped on terminal failures.

Tracing must be switched on before the interesting request arrives; the
flight recorder answers "what happened to THIS request" afterwards. The
engines append cheap host-side events keyed by request id (``admit``,
``prefill-chunk``, ``evicted``); on a terminal failure (deadline
eviction, non-finite logits) the request's whole timeline is dumped as
JSON.

Bounds: at most ``PT_FLIGHT_RING`` requests are tracked (FIFO; 0
disables recording) and at most ``MAX_EVENTS`` events per request.
Recording is one short lock around a deque append.

Dumps land as ``flight_<rid>.<pid>.json`` under ``PT_FLIGHT_DIR``
(falling back to ``PT_TRACE_DIR``); with neither set, the record is
one structured stderr line. Every dump ticks ``serve/flight_dumps``.
The pid is in the file name because processes that share a dump
directory may dump the same rid."""

import collections
import json
import os
import sys
import threading
import time
from typing import Optional

__all__ = ["FlightRecorder", "default_recorder", "record", "events",
           "dump", "forget", "reset", "MAX_EVENTS"]

_DEFAULT_RING = 256
MAX_EVENTS = 64


def _ring_from_env() -> int:
    try:
        return int(os.environ.get("PT_FLIGHT_RING", str(_DEFAULT_RING)))
    except ValueError:
        return _DEFAULT_RING


def _dump_dir() -> Optional[str]:
    return (os.environ.get("PT_FLIGHT_DIR")
            or os.environ.get("PT_TRACE_DIR"))


class FlightRecorder:
    """Bounded per-request event ring. One module-level instance per
    process (``default_recorder()``); tests may build their own."""

    def __init__(self, capacity: Optional[int] = None,
                 max_events: int = MAX_EVENTS):
        self.capacity = (_ring_from_env() if capacity is None
                         else int(capacity))
        self.max_events = int(max_events)
        self._lock = threading.Lock()
        # rid -> deque[(wall_s, event, attrs)] — insertion order IS the
        # FIFO eviction order (requests are tracked from first event)
        self._reqs = collections.OrderedDict()
        self._pinned: set = set()
        self.dropped = 0

    def pin(self, rid):
        """Exempt ``rid`` from FIFO eviction. The fleet controller's
        synthetic ``"fleet"`` timeline must survive request churn (a
        postmortem needs the scale/drain history however many requests
        came after it); per-rid events still cap at ``max_events``."""
        with self._lock:
            self._pinned.add(rid)

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    def record(self, rid, event: str, **attrs):
        """Append one event to ``rid``'s timeline (no-op for rid=None
        or a disabled recorder)."""
        if rid is None or self.capacity <= 0:
            return
        t = time.time()
        with self._lock:
            dq = self._reqs.get(rid)
            if dq is None:
                while len(self._reqs) >= self.capacity:
                    victim = next((r for r in self._reqs
                                   if r not in self._pinned), None)
                    if victim is None:
                        break
                    del self._reqs[victim]
                    self.dropped += 1
                dq = self._reqs[rid] = collections.deque(
                    maxlen=self.max_events)
            dq.append((t, event, attrs or None))

    def events(self, rid):
        """``rid``'s recorded timeline, oldest first, as JSON-able
        dicts."""
        with self._lock:
            dq = self._reqs.get(rid)
            rows = list(dq) if dq is not None else []
        out = []
        for t, event, attrs in rows:
            row = {"t": t, "event": event}
            if attrs:
                row.update(attrs)
            out.append(row)
        return out

    def forget(self, rid):
        with self._lock:
            self._reqs.pop(rid, None)

    def reset(self, capacity: Optional[int] = None):
        with self._lock:
            self._reqs.clear()
            self.dropped = 0
            if capacity is not None:
                self.capacity = int(capacity)

    def dump(self, rid, reason: str) -> Optional[dict]:
        """Serialize ``rid``'s timeline on a terminal failure. Returns
        the record dict (None when nothing was tracked). Best-effort by
        contract: a failing dump must never take the serving loop down
        with it."""
        evs = self.events(rid)
        if not evs:
            return None
        rec = {"rid": rid, "reason": reason, "dumped_at": time.time(),
               "pid": os.getpid(),
               "rank": os.environ.get("PT_PROCESS_ID", "0"),
               "events": evs}
        from paddle_tpu_torch import stats
        stats.add("serve/flight_dumps")
        try:
            d = _dump_dir()
            if d:
                os.makedirs(d, exist_ok=True)
                safe = "".join(c if c.isalnum() or c in "-_" else "_"
                               for c in str(rid))
                # pid-suffixed: router and replicas share the dump dir
                # (one PT_TRACE_DIR per launch) and each holds a
                # DIFFERENT view of the same request — a bare
                # flight_<rid>.json would let whichever process dumps
                # last destroy the other's postmortem
                path = os.path.join(
                    d, f"flight_{safe}.{os.getpid()}.json")
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(rec, f)
                os.replace(tmp, path)
                rec["path"] = path
            else:
                print("[flight] " + json.dumps(rec), file=sys.stderr,
                      flush=True)
        except Exception:
            pass
        return rec


_DEFAULT = FlightRecorder()


def default_recorder() -> FlightRecorder:
    return _DEFAULT


def pin(rid):
    _DEFAULT.pin(rid)


def record(rid, event: str, **attrs):
    _DEFAULT.record(rid, event, **attrs)


def events(rid):
    return _DEFAULT.events(rid)


def dump(rid, reason: str) -> Optional[dict]:
    return _DEFAULT.dump(rid, reason)


def forget(rid):
    _DEFAULT.forget(rid)


def reset(capacity: Optional[int] = None):
    _DEFAULT.reset(capacity)
