"""Named-metric registry (a copy of ``paddle_tpu/stats.py``): one
process-wide registry of counters, gauges, timers and log-bucketed
histograms that the serving engines, the tracer and the device-time
meters (``observability/devprof.py``) record into.

    from paddle_tpu_torch import stats
    stats.add("serve/dispatch_launches")       # counter
    stats.set_value("serve/inflight", 2)       # gauge
    with stats.timer("my/io"):                 # timer
        ...
    stats.observe("serve/ttft_s", 0.012)       # histogram sample
    stats.snapshot("serve/")                   # incl. .p50/.p90/.p99
    print(stats.table("prof/"))

Derived names: a timer ``t`` exports ``t.total_s/.count/.mean_s/.max_s``;
a histogram ``h`` exports ``h.p50/.p90/.p99/.count/.sum/.max``. These
exist only in ``snapshot()``/``table()``: the registry stores the base
name, and ``reset(prefix)`` matches prefixes against both the base name
and its derived names.

Cross-rank aggregation: ``export(rank=...)`` returns a JSON-able
snapshot tagged with the rank (default ``PT_PROCESS_ID``);
``merge(exports)`` folds many into one registry (counters sum, timers
and histograms merge, gauges get a ``rank{r}/`` prefix).
``snapshot(tag_rank=True)`` applies the same prefix to a flat snapshot.
The JAX module's flag-gated exit dump has no counterpart here.
"""

import math
import os
import threading
import time
from typing import Dict, List, Optional

__all__ = ["StatRegistry", "default_registry", "add", "set_value", "get",
           "timer", "observe", "snapshot", "table", "reset", "export",
           "merge"]

_TIMER_SUFFIXES = (".total_s", ".count", ".mean_s", ".max_s")
_HIST_SUFFIXES = (".p50", ".p90", ".p99", ".count", ".sum", ".max")


def _env_rank() -> int:
    try:
        return int(os.environ.get("PT_PROCESS_ID", 0))
    except ValueError:
        return 0


class _Timer:
    __slots__ = ("total_s", "count", "max_s")

    def __init__(self):
        self.total_s = 0.0
        self.count = 0
        self.max_s = 0.0

    def record(self, seconds: float):
        self.total_s += seconds
        self.count += 1
        self.max_s = max(self.max_s, seconds)

    @property
    def mean_s(self):
        return self.total_s / self.count if self.count else 0.0

    def merge(self, other: "_Timer"):
        self.total_s += other.total_s
        self.count += other.count
        self.max_s = max(self.max_s, other.max_s)


class _Histogram:
    """Log-bucketed histogram (DDSketch-style): bucket i covers
    [MIN·G^i, MIN·G^(i+1)) with growth G = 2^(1/4) — ≤ ~9% relative
    error on any quantile estimate (half a bucket), over 1e-9..1e12
    with ~175 sparse buckets. Sparse dict storage: only touched buckets
    cost memory, and two histograms merge bucket-wise exactly."""

    __slots__ = ("count", "sum", "min", "max", "buckets")

    GROWTH = 2.0 ** 0.25
    _LOG_G = math.log(GROWTH)
    MIN = 1e-9

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.buckets: Dict[int, int] = {}

    def record(self, value: float):
        v = float(value)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v <= self.MIN:
            i = 0
        else:
            i = int(math.log(v / self.MIN) / self._LOG_G) + 1
        self.buckets[i] = self.buckets.get(i, 0) + 1

    def percentile(self, q: float) -> float:
        """q in [0, 100]. Bucket-representative = geometric midpoint of
        the bucket's edges, clamped into the exact [min, max] seen."""
        if not self.count:
            return 0.0
        target = max(1, math.ceil(self.count * q / 100.0))
        cum = 0
        for i in sorted(self.buckets):
            cum += self.buckets[i]
            if cum >= target:
                if i == 0:
                    rep = self.MIN
                else:
                    rep = self.MIN * self.GROWTH ** (i - 0.5)
                return min(max(rep, self.min), self.max)
        return self.max

    def merge(self, other: "_Histogram"):
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        for i, c in other.buckets.items():
            self.buckets[i] = self.buckets.get(i, 0) + c

    def to_dict(self):
        return {"count": self.count, "sum": self.sum,
                "min": (None if self.count == 0 else self.min),
                "max": (None if self.count == 0 else self.max),
                "buckets": {str(i): c for i, c in self.buckets.items()}}

    @classmethod
    def from_dict(cls, d):
        h = cls()
        h.count = int(d.get("count", 0))
        h.sum = float(d.get("sum", 0.0))
        h.min = math.inf if d.get("min") is None else float(d["min"])
        h.max = -math.inf if d.get("max") is None else float(d["max"])
        h.buckets = {int(i): int(c)
                     for i, c in d.get("buckets", {}).items()}
        return h


def _prefix_hits(base: str, suffixes, prefix: str) -> bool:
    """Does ``prefix`` select metric ``base``? Matches the base name OR
    any of its derived export names (reset("p2p/send.") must clear the
    p2p/send timer even though only p2p/send.total_s appears in
    snapshot())."""
    if base.startswith(prefix):
        return True
    return any((base + s).startswith(prefix) for s in suffixes)


class StatRegistry:
    """Thread-safe named counters/gauges/timers/histograms (≙ monitor.h
    StatRegistry::Instance)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._timers: Dict[str, _Timer] = {}
        self._hists: Dict[str, _Histogram] = {}

    # -- counters (monotonic; STAT_ADD) -------------------------------------
    def add(self, name: str, value: float = 1) -> float:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value
            return self._counters[name]

    # -- gauges (last-value-wins) --------------------------------------------
    def set_value(self, name: str, value: float):
        with self._lock:
            self._gauges[name] = value

    # compat alias (≙ monitor.h int64 set; profiler.stat_registry.set)
    def set(self, name: str, value):  # noqa: A003 (reference name)
        self.set_value(name, value)

    def get(self, name: str, default=0):
        with self._lock:
            if name in self._counters:
                return self._counters[name]
            if name in self._gauges:
                return self._gauges[name]
            if name in self._timers:
                return self._timers[name].total_s
            if name in self._hists:
                return self._hists[name].count
            return default

    def stats(self) -> Dict[str, float]:
        """Counters + gauges as one flat dict (the monitor.h scrape
        shape the profiler's stat_registry historically returned)."""
        with self._lock:
            return {**self._counters, **self._gauges}

    # -- timers ---------------------------------------------------------------
    def record_time(self, name: str, seconds: float):
        with self._lock:
            self._timers.setdefault(name, _Timer()).record(seconds)

    def timer(self, name: str):
        """Context manager accumulating wall time under ``name``."""
        registry = self

        class _Ctx:
            def __enter__(self):
                self._t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                registry.record_time(name,
                                     time.perf_counter() - self._t0)
                return False

        return _Ctx()

    # -- histograms -----------------------------------------------------------
    def observe(self, name: str, value: float):
        """Record one sample into the log-bucketed histogram ``name``
        (p50/p90/p99 + count/sum surface in snapshot()/table())."""
        with self._lock:
            self._hists.setdefault(name, _Histogram()).record(value)

    def histogram(self, name: str) -> Optional[_Histogram]:
        with self._lock:
            return self._hists.get(name)

    # -- export ---------------------------------------------------------------
    def snapshot(self, prefix: Optional[str] = None,
                 tag_rank: bool = False) -> Dict[str, float]:
        with self._lock:
            out = dict(self._counters)
            out.update(self._gauges)
            for name, t in self._timers.items():
                out[f"{name}.total_s"] = t.total_s
                out[f"{name}.count"] = t.count
                out[f"{name}.mean_s"] = t.mean_s
                out[f"{name}.max_s"] = t.max_s
            for name, h in self._hists.items():
                out[f"{name}.p50"] = h.percentile(50)
                out[f"{name}.p90"] = h.percentile(90)
                out[f"{name}.p99"] = h.percentile(99)
                out[f"{name}.count"] = h.count
                out[f"{name}.sum"] = h.sum
                out[f"{name}.max"] = (0.0 if h.count == 0 else h.max)
        if prefix is not None:
            out = {k: v for k, v in out.items() if k.startswith(prefix)}
        if tag_rank:
            r = _env_rank()
            out = {f"rank{r}/{k}": v for k, v in out.items()}
        return out

    def table(self, prefix: Optional[str] = None) -> str:
        snap = self.snapshot(prefix)
        if not snap:
            return "(no stats recorded)"
        width = max(len(k) for k in snap)
        lines = [f"{'stat':<{width}}  value", "-" * (width + 12)]
        for k in sorted(snap):
            v = snap[k]
            vs = f"{v:.6g}" if isinstance(v, float) else str(v)
            lines.append(f"{k:<{width}}  {vs}")
        return "\n".join(lines)

    def reset(self, prefix: Optional[str] = None):
        """Clear everything, or every metric selected by ``prefix``.
        Matching runs on BASE metric names and their derived export
        names alike — ``reset("p2p/send.")`` clears the ``p2p/send``
        timer/histogram even though only derived dotted names appear in
        ``snapshot()``."""
        with self._lock:
            for d, suffixes in ((self._counters, ()), (self._gauges, ()),
                                (self._timers, _TIMER_SUFFIXES),
                                (self._hists, _HIST_SUFFIXES)):
                if prefix is None:
                    d.clear()
                else:
                    for k in [k for k in d
                              if _prefix_hits(k, suffixes, prefix)]:
                        del d[k]

    # -- structured export / cross-rank merge --------------------------------
    def export(self, rank: Optional[int] = None) -> dict:
        """JSON-able structured snapshot tagged with ``rank`` (default:
        PT_PROCESS_ID). The statsz endpoint serves this form; launch-side
        aggregation feeds a list of them to ``merge()``."""
        with self._lock:
            return {
                "rank": _env_rank() if rank is None else int(rank),
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "timers": {k: {"total_s": t.total_s, "count": t.count,
                               "max_s": t.max_s}
                           for k, t in self._timers.items()},
                "histograms": {k: h.to_dict()
                               for k, h in self._hists.items()},
            }

    def load_export(self, exp: dict, gauge_prefix: str = ""):
        """Fold one ``export()`` dict into this registry: counters sum,
        timers/histograms merge, gauges land under ``gauge_prefix``."""
        with self._lock:
            for k, v in exp.get("counters", {}).items():
                self._counters[k] = self._counters.get(k, 0) + v
            for k, v in exp.get("gauges", {}).items():
                self._gauges[gauge_prefix + k] = v
            for k, d in exp.get("timers", {}).items():
                t = self._timers.setdefault(k, _Timer())
                t.total_s += float(d.get("total_s", 0.0))
                t.count += int(d.get("count", 0))
                t.max_s = max(t.max_s, float(d.get("max_s", 0.0)))
            for k, d in exp.get("histograms", {}).items():
                h = self._hists.setdefault(k, _Histogram())
                h.merge(_Histogram.from_dict(d))


def merge(exports: List[dict]) -> StatRegistry:
    """Aggregate worker ``export()`` snapshots into one registry:
    counters sum across ranks, timers and histograms merge exactly
    (bucket-wise), and gauges — per-worker values with no meaningful
    cross-rank sum — are namespaced ``rank{r}/name`` so nothing
    collides. ``merge(...).table()`` is the multi-host job view."""
    out = StatRegistry()
    for exp in exports:
        out.load_export(exp, gauge_prefix=f"rank{exp.get('rank', 0)}/")
    return out


_DEFAULT = StatRegistry()


def default_registry() -> StatRegistry:
    return _DEFAULT


def add(name: str, value: float = 1) -> float:
    return _DEFAULT.add(name, value)


def set_value(name: str, value: float):
    _DEFAULT.set_value(name, value)


def get(name: str, default=0):
    return _DEFAULT.get(name, default)


def timer(name: str):
    return _DEFAULT.timer(name)


def observe(name: str, value: float):
    _DEFAULT.observe(name, value)


def snapshot(prefix: Optional[str] = None,
             tag_rank: bool = False) -> Dict[str, float]:
    return _DEFAULT.snapshot(prefix, tag_rank=tag_rank)


def table(prefix: Optional[str] = None) -> str:
    return _DEFAULT.table(prefix)


def reset(prefix: Optional[str] = None):
    _DEFAULT.reset(prefix)


def export(rank: Optional[int] = None) -> dict:
    return _DEFAULT.export(rank)
