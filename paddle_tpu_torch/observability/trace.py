"""Process-wide structured tracer: ring-buffered spans with Chrome-trace /
Perfetto export (a copy of ``paddle_tpu/observability/trace.py``).

The spans cover the host's orchestration: engine steps, dispatches,
harvests, prefills, request lifetimes. Device time lives in the
``torch.profiler`` trace; a ``serve/dispatch`` span marks when the host
enqueued the kernels, not how long the card ran them.

Design:

- **Lock-cheap ring buffer**: finished spans land in a preallocated
  ring (default 65536 events, ``PT_TRACE_RING`` overrides); recording is
  one short lock around an index bump and a slot write. When the ring
  wraps, the oldest events are overwritten and ``trace/dropped`` counts
  them at export.
- **Disabled = one flag check**: ``span()`` checks one module-level
  flag and returns without touching clocks or locks. Enable with
  ``PT_TRACE_DIR`` (the atexit hook then exports ``trace_rank{N}.json``
  there), ``PT_TRACE_FILE`` (exact path, wins over the dir), or
  ``enable()``.
- **Nesting**: a thread-local stack gives every span its parent id.
  Work that crosses threads uses explicit ``begin()``/``end()`` tokens;
  intervals known only afterwards (a request's lifetime) use
  ``complete()``.
- **Clocks**: spans time with ``perf_counter_ns``; export rebases onto
  the wall clock via a process-start offset, so processes on one host
  share a timeline.
- **Rank lanes**: exported events use pid = rank (``PT_PROCESS_ID``),
  tid = OS thread id, plus ``process_name`` metadata (see
  ``observability.merge``).
- **Periodic flush** (``PT_TRACE_FLUSH_S``, default 5 s): a daemon
  thread rewrites the partial trace file, so a killed process loses at
  most one interval of spans.
"""

import functools
import json
import os
import threading
import time
from typing import Optional

__all__ = ["span", "begin", "end", "complete", "instant", "enable",
           "disable", "enabled", "export", "events", "clear",
           "trace_file_from_env", "start_flush"]

_DEFAULT_RING = 65536

# perf_counter epoch → wall-clock epoch, fixed at import: every rank
# exports timestamps on the shared wall timeline
_WALL_OFFSET_NS = time.time_ns() - time.perf_counter_ns()


def _rank() -> int:
    try:
        return int(os.environ.get("PT_PROCESS_ID", 0))
    except ValueError:
        return 0


class _Tracer:
    """The process-wide recorder. One instance; tests may swap capacity
    via clear(capacity=...)."""

    def __init__(self, capacity: int = _DEFAULT_RING):
        self.enabled = False
        self.capacity = int(capacity)
        self._ring = [None] * self.capacity
        self._n = 0                      # monotonic event count
        self._next_id = 0
        self._lock = threading.Lock()
        self._tls = threading.local()
        self.out_path: Optional[str] = None
        self._dropped_reported = 0

    # -- ids / stacks -------------------------------------------------------
    def new_id(self) -> int:
        with self._lock:
            self._next_id += 1
            return self._next_id

    def stack(self):
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    # -- recording ----------------------------------------------------------
    def record(self, name, t0_ns, dur_ns, sid, parent, attrs):
        ev = (name, t0_ns, dur_ns, threading.get_native_id(), sid,
              parent, attrs)
        with self._lock:
            self._ring[self._n % self.capacity] = ev
            self._n += 1

    def events(self):
        with self._lock:
            n, cap = self._n, self.capacity
            if n <= cap:
                out = [e for e in self._ring[:n]]
            else:
                i = n % cap
                out = self._ring[i:] + self._ring[:i]
            return out, max(0, n - cap)

    def clear(self, capacity: Optional[int] = None):
        with self._lock:
            if capacity is not None:
                self.capacity = int(capacity)
            self._ring = [None] * self.capacity
            self._n = 0
            self._dropped_reported = 0


_TRACER = _Tracer()


class _Span:
    """Context manager + decorator for one named range. Mutate ``attrs``
    inside the ``with`` block to attach values only known mid-span
    (payload bytes, token counts)."""

    __slots__ = ("name", "attrs", "_t0", "_sid", "_parent", "_live")

    def __init__(self, name, attrs):
        self.name = name
        self.attrs = attrs
        self._live = False

    def __enter__(self):
        tr = _TRACER
        if not tr.enabled:
            return self
        self._live = True
        self._sid = tr.new_id()
        st = tr.stack()
        self._parent = st[-1] if st else 0
        st.append(self._sid)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if not self._live:
            return False
        t1 = time.perf_counter_ns()
        tr = _TRACER
        st = tr.stack()
        if st and st[-1] == self._sid:
            st.pop()
        tr.record(self.name, self._t0, t1 - self._t0, self._sid,
                  self._parent, self.attrs or None)
        self._live = False
        return False

    def __call__(self, fn):
        name, attrs = self.name, self.attrs

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with _Span(name, dict(attrs) if attrs else {}):
                return fn(*a, **kw)

        return wrapper


def span(name: str, **attrs) -> _Span:
    """``with span("p2p/send", dst=3) as sp: ... sp.attrs["bytes"] = n``
    — or ``@span("ckpt/save")`` as a decorator. Disabled tracing makes
    __enter__/__exit__ no-ops (one flag check)."""
    return _Span(name, attrs)


def begin(name: str, **attrs):
    """Explicit async begin: returns a token for ``end()``. The span is
    parentless unless ``parent=`` (a token/sid) is passed in attrs —
    async work crosses threads, so the thread-local stack is not used."""
    tr = _TRACER
    if not tr.enabled:
        return None
    parent = attrs.pop("parent", None)
    return (name, time.perf_counter_ns(), tr.new_id(),
            parent[2] if isinstance(parent, tuple) else (parent or 0),
            attrs)


def end(token, **extra_attrs):
    """Close a ``begin()`` token (no-op for None tokens)."""
    tr = _TRACER
    if token is None or not tr.enabled:
        return
    name, t0, sid, parent, attrs = token
    if extra_attrs:
        attrs = {**attrs, **extra_attrs}
    tr.record(name, t0, time.perf_counter_ns() - t0, sid, parent,
              attrs or None)


def complete(name: str, t0_s: float, t1_s: Optional[float] = None,
             **attrs):
    """Record an interval after the fact from ``time.perf_counter()``
    endpoints (seconds) — e.g. a serving request's submit→done lifetime,
    only known at completion."""
    tr = _TRACER
    if not tr.enabled:
        return
    t1_s = time.perf_counter() if t1_s is None else t1_s
    tr.record(name, int(t0_s * 1e9), int((t1_s - t0_s) * 1e9),
              tr.new_id(), 0, attrs or None)


def instant(name: str, **attrs):
    """Zero-duration marker event."""
    tr = _TRACER
    if not tr.enabled:
        return
    tr.record(name, time.perf_counter_ns(), 0, tr.new_id(), 0,
              attrs or None)


# -- lifecycle ---------------------------------------------------------------

def enable(out_path: Optional[str] = None,
           capacity: Optional[int] = None):
    """Turn recording on. ``out_path``: where the atexit/``export()``
    default write goes (a .json file path, or a directory that gets
    ``trace_rank{N}.json``)."""
    if capacity is not None:
        _TRACER.clear(capacity)
    if out_path is not None:
        _TRACER.out_path = out_path
    _TRACER.enabled = True


def disable():
    _TRACER.enabled = False


def enabled() -> bool:
    return _TRACER.enabled


def clear(capacity: Optional[int] = None):
    _TRACER.clear(capacity)


def events():
    """(recorded event tuples oldest→newest, dropped count)."""
    return _TRACER.events()


def trace_file_from_env() -> Optional[str]:
    """Resolve the per-rank output path from the env contract:
    PT_TRACE_FILE (exact, set per worker by the launcher) beats
    PT_TRACE_DIR/trace_rank{N}.json."""
    f = os.environ.get("PT_TRACE_FILE")
    if f:
        return f
    d = os.environ.get("PT_TRACE_DIR")
    if d:
        return os.path.join(d, f"trace_rank{_rank()}.json")
    return None


_EXPORT_LOCK = threading.Lock()


def export(path: Optional[str] = None) -> Optional[str]:
    """Write the ring as Chrome-trace JSON (``{"traceEvents": [...]}``)
    that loads in Perfetto / chrome://tracing. Returns the path written
    (None when there is nowhere to write). pid = rank, tid = OS thread;
    span/parent ids ride in ``args`` so tooling can rebuild the tree.
    Serialized by a module lock: the periodic flush thread and the
    atexit/explicit export would otherwise truncate each other's
    ``.tmp`` mid-write and rename interleaved bytes into the published
    file — the atomic-rewrite guarantee holds only with one writer."""
    path = path or _TRACER.out_path or trace_file_from_env()
    if path is None:
        return None
    if os.path.isdir(path):
        path = os.path.join(path, f"trace_rank{_rank()}.json")
    evs, dropped = _TRACER.events()
    rank = _rank()
    out = [{
        "name": "process_name", "ph": "M", "pid": rank, "tid": 0,
        "args": {"name": f"rank{rank}"},
    }, {
        "name": "process_sort_index", "ph": "M", "pid": rank, "tid": 0,
        "args": {"sort_index": rank},
    }]
    for name, t0, dur, tid, sid, parent, attrs in evs:
        args = {"span_id": sid, "parent_id": parent}
        if attrs:
            args.update(attrs)
        out.append({
            "name": name, "ph": "X", "cat": "host",
            "ts": (t0 + _WALL_OFFSET_NS) / 1e3,       # microseconds
            "dur": dur / 1e3,
            "pid": rank, "tid": tid, "args": args,
        })
    if dropped > _TRACER._dropped_reported:
        from paddle_tpu_torch import stats
        stats.add("trace/dropped", dropped - _TRACER._dropped_reported)
        _TRACER._dropped_reported = dropped
    doc = {"traceEvents": out, "displayTimeUnit": "ms",
           "otherData": {"rank": rank, "dropped": dropped}}
    with _EXPORT_LOCK:
        os.makedirs(os.path.dirname(os.path.abspath(path)),
                    exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
    return path


_FLUSH_THREAD = None


def _flush_interval_from_env() -> float:
    """Unset / empty / malformed all mean the documented DEFAULT (5s)
    — only an explicit '0' (or negative) disables the flush. An empty
    template variable must not silently switch off the hard-kill
    trace-loss fix this knob exists for."""
    raw = os.environ.get("PT_TRACE_FLUSH_S")
    if raw is None or raw.strip() == "":
        return 5.0
    try:
        return float(raw)
    except ValueError:
        return 5.0


def start_flush(interval_s: Optional[float] = None):
    """Periodic atomic rewrite of the (partial) trace file — the
    trace-loss-on-hard-kill fix: the ring otherwise exports only via
    atexit, so a SIGKILLed replica (exactly the interesting one) left
    no trace at all. Every ``interval_s`` seconds (default
    ``PT_TRACE_FLUSH_S``, 5s; <= 0 disables) the ring is exported via
    the tmp-file + rename path, so readers always see a complete JSON
    document and a hard kill loses at most one interval of spans.
    Idempotent; the thread is a daemon and re-checks ``enabled`` every
    tick, so ``disable()`` quiesces it."""
    global _FLUSH_THREAD
    iv = _flush_interval_from_env() if interval_s is None \
        else float(interval_s)
    if iv <= 0 or _FLUSH_THREAD is not None:
        return None

    def _loop():
        while True:
            time.sleep(iv)
            if not _TRACER.enabled:
                continue
            try:
                export()
            except Exception:
                pass

    t = threading.Thread(target=_loop, name="pt-trace-flush",
                         daemon=True)
    t.start()
    _FLUSH_THREAD = t
    return t


def _init_from_env():
    """PT_TRACE_DIR / PT_TRACE_FILE switch tracing on for this process;
    the atexit hook exports what the ring holds and the periodic flush
    (PT_TRACE_FLUSH_S) keeps a partial export on disk between
    harvests. The output path is NOT latched here: PT_PROCESS_ID may
    only be published after import (env.init_parallel_env with an
    explicit process_id), so export() re-resolves trace_file_from_env()
    at write time — every rank lands on its own trace_rank{N}.json."""
    if trace_file_from_env() is None:
        return
    try:
        capacity = int(os.environ.get("PT_TRACE_RING", _DEFAULT_RING))
    except ValueError:
        capacity = _DEFAULT_RING
    enable(capacity=capacity)
    start_flush()
    import atexit

    def _dump():
        try:
            export()
        except Exception:
            pass

    atexit.register(_dump)
