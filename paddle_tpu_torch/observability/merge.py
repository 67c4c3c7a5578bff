"""Merge per-rank Chrome-trace files into one Perfetto timeline, and
stitch per-process traces into per-request lanes (a copy of
``paddle_tpu/observability/merge.py``).

Each rank exports ``trace_rank{N}.json`` with pid = rank (trace.py), so
merging concatenates every rank's ``traceEvents`` and keeps one
``process_name``/``process_sort_index`` pair per rank.

**Stitch mode**: the engines tag request-scoped spans with the request
id (``args.rid``, ``submit(req_id=...)``), and every process exports on
the same wall-clock-rebased timeline, so joining trace files recovers
each request's story. :func:`stitch_trace_files` merges the files (one
lane per file) and adds a synthetic ``requests`` process with one lane
per request showing the phase segments::

    queue-wait -> prefill -> kv-transfer -> decode -> stream

derived from span boundaries (:func:`request_segments`): queue-wait is
submission (``serve/route``, else ``serve/queue``) to prefill start
(``serve/admit``), kv-transfer the gap from prefill end to decode start
when pages crossed a wire, stream is decode end to the route's end.
"""

import glob
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["merge_trace_files", "merge_rank_traces",
           "stitch_trace_files", "stitch_rank_traces",
           "discover_trace_files", "request_segments", "MERGED_NAME",
           "STITCHED_NAME", "REQUEST_SEGMENTS"]

MERGED_NAME = "trace_merged.json"
STITCHED_NAME = "trace_stitched.json"
REQUEST_SEGMENTS = ("queue-wait", "prefill", "kv-transfer", "decode",
                    "stream")
_RANK_RE = re.compile(r"trace_rank(\d+)\.json$")


def _load_events(path: str):
    with open(path) as f:
        doc = json.load(f)
    evs = doc.get("traceEvents", doc if isinstance(doc, list) else [])
    if not isinstance(evs, list):
        raise ValueError(f"{path}: no traceEvents array")
    return evs


def merge_trace_files(paths: Sequence[str], out_path: str) -> str:
    """Merge explicit per-rank trace files. A file whose events carry no
    pid (hand-rolled traces) gets its pid inferred from the
    ``trace_rank{N}`` filename, default 0."""
    events = []
    seen_meta = set()
    for path in sorted(paths):
        m = _RANK_RE.search(os.path.basename(path))
        fallback_pid = int(m.group(1)) if m else 0
        for ev in _load_events(path):
            pid = ev.get("pid", fallback_pid)
            ev["pid"] = pid
            if ev.get("ph") == "M":
                key = (pid, ev.get("name"))
                if key in seen_meta:
                    continue
                seen_meta.add(key)
            events.append(ev)
    # guarantee a named lane per rank even for hand-rolled inputs
    for pid in sorted({e["pid"] for e in events}):
        if (pid, "process_name") not in seen_meta:
            events.insert(0, {"name": "process_name", "ph": "M",
                              "pid": pid, "tid": 0,
                              "args": {"name": f"rank{pid}"}})
    doc = {"traceEvents": events, "displayTimeUnit": "ms",
           "otherData": {"merged_from": [os.path.basename(p)
                                         for p in sorted(paths)]}}
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, out_path)
    return out_path


def _rid_spans(events):
    """rid -> [span events], spans sorted by start within each rid."""
    by_rid: Dict[str, list] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        rid = (ev.get("args") or {}).get("rid")
        if rid:
            by_rid.setdefault(str(rid), []).append(ev)
    for evs in by_rid.values():
        evs.sort(key=lambda e: e.get("ts", 0.0))
    return by_rid


def request_segments(events) -> Dict[str, dict]:
    """Derive each request's phase segments (µs timestamps/durations,
    the Chrome-trace unit) from its rid-tagged spans:

    - ``serve/route`` (router: submit → result pickup) anchors the
      client-observed window;
    - the EARLIEST ``serve/admit`` is the prefill phase (redistributed
      re-executions keep their later admits on the raw lanes);
    - the LATEST ``serve/decode`` is the decode phase (the one that
      produced the final result);
    - ``kv-transfer`` is the prefill-end → decode-start boundary gap,
      emitted only when a ``serve/kv_transfer`` (or ``serve/kv_publish``)
      span proves pages actually crossed the wire;
    - ``stream`` is decode end → route end (result transit + pickup).

    Returns ``{rid: {"segments": {name: (ts, dur)}, "client_us": dur
    or None, "pids": [...]}}``. Segments whose boundaries invert under
    cross-host clock skew clamp to zero duration rather than lie."""
    out: Dict[str, dict] = {}
    for rid, evs in sorted(_rid_spans(events).items()):
        def first(name):
            return next((e for e in evs if e["name"] == name), None)

        def last(name):
            hit = None
            for e in evs:
                if e["name"] == name:
                    hit = e
            return hit

        route = first("serve/route")
        admit = first("serve/admit")
        decode = last("serve/decode")
        moved_kv = any(e["name"] in ("serve/kv_transfer",
                                     "serve/kv_publish") for e in evs)
        segs: Dict[str, Tuple[float, float]] = {}
        t0 = route["ts"] if route else None
        if t0 is None:
            q = first("serve/queue")
            t0 = q["ts"] if q else (admit["ts"] if admit else None)
        p_end = None
        if admit is not None:
            if t0 is not None:
                segs["queue-wait"] = (t0, max(0.0, admit["ts"] - t0))
            segs["prefill"] = (admit["ts"], admit.get("dur", 0.0))
            p_end = admit["ts"] + admit.get("dur", 0.0)
        d_end = p_end
        if decode is not None:
            d0 = decode["ts"]
            if moved_kv and p_end is not None:
                segs["kv-transfer"] = (p_end, max(0.0, d0 - p_end))
            segs["decode"] = (d0, decode.get("dur", 0.0))
            d_end = d0 + decode.get("dur", 0.0)
        if route is not None and d_end is not None:
            r_end = route["ts"] + route.get("dur", 0.0)
            segs["stream"] = (d_end, max(0.0, r_end - d_end))
        out[rid] = {"segments": segs,
                    "client_us": route.get("dur") if route else None,
                    "pids": sorted({e.get("pid", 0) for e in evs})}
    return out


def stitch_trace_files(paths: Sequence[str], out_path: str,
                       requests_pid: int = 9999):
    """Join per-replica trace files into ONE Perfetto timeline with a
    per-request lane. Each input FILE becomes one process lane named
    after the file (``trace_pf0.json`` → lane ``pf0``) — replica
    processes launched with nproc_per_node=1 are all rank 0, so the
    exported pids would collide. A synthetic ``requests`` process gets
    one thread per stitched request carrying its phase segments
    (:func:`request_segments`). Returns ``(out_path, summary)`` where
    ``summary`` is the request_segments dict (durations in µs) for
    programmatic assertions (the fleetobs smoke's 10% latency-sum
    check)."""
    events: List[dict] = []
    meta: List[dict] = []
    for i, path in enumerate(sorted(paths)):
        stem = os.path.splitext(os.path.basename(path))[0]
        if stem.startswith("trace_"):
            stem = stem[len("trace_"):]
        pid = 1000 + i
        meta.extend([
            {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": stem}},
            {"name": "process_sort_index", "ph": "M", "pid": pid,
             "tid": 0, "args": {"sort_index": i + 1}},
        ])
        for ev in _load_events(path):
            if ev.get("ph") == "M":
                continue            # lanes are renamed per file
            ev = dict(ev)
            ev["pid"] = pid
            events.append(ev)
    summary = request_segments(events)
    meta.append({"name": "process_name", "ph": "M", "pid": requests_pid,
                 "tid": 0, "args": {"name": "requests"}})
    meta.append({"name": "process_sort_index", "ph": "M",
                 "pid": requests_pid, "tid": 0,
                 "args": {"sort_index": 0}})
    for idx, (rid, info) in enumerate(summary.items()):
        tid = idx + 1
        meta.append({"name": "thread_name", "ph": "M",
                     "pid": requests_pid, "tid": tid,
                     "args": {"name": rid}})
        for seg, (ts, dur) in info["segments"].items():
            events.append({"name": seg, "ph": "X", "cat": "request",
                           "ts": ts, "dur": dur, "pid": requests_pid,
                           "tid": tid, "args": {"rid": rid}})
    doc = {"traceEvents": meta + events, "displayTimeUnit": "ms",
           "otherData": {
               "stitched_from": [os.path.basename(p)
                                 for p in sorted(paths)],
               "requests": len(summary)}}
    os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                exist_ok=True)
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, out_path)
    return out_path, summary


def merge_rank_traces(trace_dir: str,
                      out_path: Optional[str] = None) -> Optional[str]:
    """Merge every ``trace_rank*.json`` under ``trace_dir`` into
    ``trace_merged.json`` (or ``out_path``). Returns None when the dir
    holds no rank traces (nothing to merge is not an error — a worker
    may have died before exporting)."""
    paths: List[str] = sorted(
        glob.glob(os.path.join(trace_dir, "trace_rank*.json")))
    if not paths:
        return None
    return merge_trace_files(
        paths, out_path or os.path.join(trace_dir, MERGED_NAME))


def discover_trace_files(trace_dir: str) -> List[str]:
    """Every stitchable ``trace_*.json`` under ``trace_dir`` — rank
    files, replica files, the launcher lane — excluding previous
    merge/stitch OUTPUTS (the one discovery rule every caller uses)."""
    skip = {MERGED_NAME, STITCHED_NAME}
    return [p for p in sorted(
                glob.glob(os.path.join(trace_dir, "trace_*.json")))
            if os.path.basename(p) not in skip]


def stitch_rank_traces(trace_dir: str,
                       out_path: Optional[str] = None) -> Optional[str]:
    """Stitch every ``trace_*.json`` under ``trace_dir`` (rank files,
    replica files, the launcher lane — but not a previous merge/stitch
    output) into ``trace_stitched.json``. Returns None — and leaves no
    file — when no request-tagged spans exist to stitch (a training
    job's trace dir, say): a cheap raw-text probe for the ``"rid"``
    attr key skips the parse + renumber + write entirely for the
    common rid-less case."""
    paths = discover_trace_files(trace_dir)
    if not paths:
        return None

    def _maybe_rid(path):
        try:
            with open(path) as f:
                return '"rid"' in f.read()
        except OSError:
            return False

    if not any(_maybe_rid(p) for p in paths):
        return None
    out = out_path or os.path.join(trace_dir, STITCHED_NAME)
    out, summary = stitch_trace_files(paths, out)
    if not summary:
        try:
            os.remove(out)
        except OSError:
            pass
        return None
    return out
