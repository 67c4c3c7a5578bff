"""Exposed-time accounting over span streams (a copy of
``paddle_tpu/observability/comm.py``).

- :func:`exposed_time` — exact interval algebra: the measure of
  ``union(comm)`` minus its intersection with ``union(compute)``.
  Nested, overlapping and back-to-back spans reduce to their union
  first, so a span inside another counts once.
- :func:`span_intervals` — ``(t0_s, t1_s)`` intervals of the tracer's
  spans by name prefix, optionally clipped to a window.
- :func:`step_overlap` / :func:`record_step_overlap` — the same over
  ``collective/*`` and ``compute/*`` spans from the tracer's ring,
  recorded as ``comm/exposed_s`` (histogram) and ``comm/overlap_frac``
  (gauge).

The spans are host intervals; ``observability/devprof.step_fractions``
runs the same algebra over the serving engines' dispatch and harvest
spans.
"""

from typing import Iterable, List, Optional, Tuple

__all__ = ["exposed_time", "overlap_fraction", "span_intervals",
           "step_overlap", "record_step_overlap"]

Interval = Tuple[float, float]


def _union(intervals: Iterable[Interval]) -> List[Interval]:
    """Sorted disjoint union; empty/negative intervals drop out."""
    ivs = sorted((float(a), float(b)) for a, b in intervals if b > a)
    out: List[Interval] = []
    for a, b in ivs:
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def exposed_time(comm: Iterable[Interval],
                 compute: Iterable[Interval]) -> float:
    """Total measure of ``union(comm)`` not covered by any compute
    interval. Intervals are ``(start, end)`` in any consistent unit;
    nested / overlapping / back-to-back intervals are handled exactly
    via the disjoint unions."""
    cu = _union(comm)
    ku = _union(compute)
    exposed = sum(b - a for a, b in cu)
    i = j = 0
    while i < len(cu) and j < len(ku):
        a = max(cu[i][0], ku[j][0])
        b = min(cu[i][1], ku[j][1])
        if b > a:
            exposed -= b - a
        if cu[i][1] < ku[j][1]:
            i += 1
        else:
            j += 1
    return exposed


def _overlap_triple(comm: Iterable[Interval],
                    compute: Iterable[Interval]):
    """(exposed_s, overlap_frac, comm_busy_s) — the one place the
    busy/exposed/fraction arithmetic lives (frac = 1 when there is no
    comm at all: nothing was exposed)."""
    cu = _union(comm)
    busy = sum(b - a for a, b in cu)
    e = exposed_time(cu, compute)
    frac = 1.0 if busy <= 0.0 else 1.0 - e / busy
    return e, frac, busy


def overlap_fraction(comm: Iterable[Interval],
                     compute: Iterable[Interval]) -> float:
    """1 − exposed/comm_busy: the fraction of collective wall time some
    compute span covers. 1.0 when there is no comm at all (nothing was
    exposed)."""
    return _overlap_triple(comm, compute)[1]


def span_intervals(events, prefix: str,
                   window: Optional[Interval] = None) -> List[Interval]:
    """``(t0_s, t1_s)`` intervals of every recorded span whose name
    starts with ``prefix``, from trace-event tuples (see
    ``trace.events()``), optionally clipped to ``window`` (seconds)."""
    out: List[Interval] = []
    for ev in events:
        if ev is None or not ev[0].startswith(prefix):
            continue
        a = ev[1] / 1e9
        b = (ev[1] + ev[2]) / 1e9
        if window is not None:
            a, b = max(a, window[0]), min(b, window[1])
        if b > a:
            out.append((a, b))
    return out


def step_overlap(events=None, comm_prefix: str = "collective/",
                 compute_prefix: str = "compute/",
                 window: Optional[Interval] = None):
    """``(exposed_s, overlap_frac, comm_busy_s)`` from the span tracer:
    comm spans = ``comm_prefix``-named, compute spans =
    ``compute_prefix``-named, optionally clipped to a step ``window``
    (seconds on the trace clock)."""
    if events is None:
        from paddle_tpu_torch.observability import trace
        events, _ = trace.events()
    return _overlap_triple(span_intervals(events, comm_prefix, window),
                           span_intervals(events, compute_prefix, window))


def record_step_overlap(events=None, comm_prefix: str = "collective/",
                        compute_prefix: str = "compute/",
                        window: Optional[Interval] = None):
    """Compute :func:`step_overlap` and record it: ``comm/exposed_s``
    observes into the histogram (per-step distribution), the
    ``comm/overlap_frac`` gauge holds the latest step. Returns the
    triple so callers can report it directly (bench rows)."""
    from paddle_tpu_torch import stats
    e, frac, busy = step_overlap(events, comm_prefix, compute_prefix,
                                 window)
    stats.observe("comm/exposed_s", e)
    stats.set_value("comm/overlap_frac", frac)
    return e, frac, busy
