"""Fleet-wide metrics aggregation and the SLO/anomaly watch (a copy of
``paddle_tpu/observability/fleet.py``), router side.

Replicas attach ``stats.export()`` snapshots to their membership
heartbeats (``ReplicaDirectory.heartbeat(stats=...)``; the load gauges
ride the same beat); a router-side :class:`FleetStats` keeps the LATEST
export per replica and merges them on demand with ``stats.merge``'s
semantics: counters sum across replicas, histograms merge bucket-wise
exactly, and gauges namespace per replica so nothing collides. The
merged registry serves a fleet-level ``/statsz``
(:meth:`FleetStats.serve_statsz`), appends periodic JSONL telemetry, and
feeds the **SLO/anomaly watch**:

- **SLO burn** — merged ``serve/ttft_s`` p99 against
  ``PT_SLO_TTFT_P99_MS`` (gauge ``fleet/slo_ttft_burn`` = p99/target;
  alert while > 1) and fleet goodput (token progress per second summed
  over replicas, gauge ``fleet/goodput_tokens_per_s``) against
  ``PT_SLO_GOODPUT``.
- **Stalled replica** — heartbeat still alive but ZERO token progress
  for ``stall_after_s`` while the replica shows work (busy slots or a
  non-empty queue).
- **Runaway queue age** — a replica's oldest queued request older than
  ``PT_SLO_QUEUE_AGE_S``.
- **Pool-page exhaustion** — a paged replica with zero free pages and
  work waiting.

Every detector is EDGE-TRIGGERED: one ``fleet/alert_*`` counter tick
plus one structured log line per incident, cleared when the condition
resolves (so a re-stall alerts again). ``Router.enable_fleet_stats``
pumps :meth:`poll` from the router's own poll loop.
"""

import json
import os
import sys
import threading
import time
from typing import Collection, Dict, List, Optional

from paddle_tpu_torch import stats as stats_lib

__all__ = ["FleetStats", "slo_targets"]


def slo_targets() -> dict:
    """The SLO targets from the env contract (None = unset/disabled):
    ``PT_SLO_TTFT_P99_MS`` (ms), ``PT_SLO_GOODPUT`` (tokens/s floor),
    ``PT_SLO_QUEUE_AGE_S`` (seconds, default 30)."""
    def _f(name, default=None):
        raw = os.environ.get(name)
        if raw is None or raw.strip() == "":
            return default
        try:
            return float(raw)
        except ValueError:
            return default
    return {"ttft_p99_ms": _f("PT_SLO_TTFT_P99_MS"),
            "goodput": _f("PT_SLO_GOODPUT"),
            "queue_age_s": _f("PT_SLO_QUEUE_AGE_S", 30.0)}


class FleetStats:
    """Merge replica stat exports and watch the fleet's health.

        fleet = FleetStats(router.directory)
        fleet.poll()                  # refresh + watch + jsonl
        fleet.merged().snapshot()     # the fleet-level scrape
        fleet.serve_statsz(port)      # live fleet /statsz

    ``directory`` may be None for in-process aggregation via
    :meth:`ingest` (tests, the bench)."""

    def __init__(self, directory=None, dead_after: float = 2.0,
                 stall_after_s: float = 5.0,
                 jsonl_path: Optional[str] = None,
                 jsonl_interval_s: float = 5.0,
                 slo: Optional[dict] = None):
        self.directory = directory
        self.dead_after = float(dead_after)
        self.stall_after_s = float(stall_after_s)
        # the stalled detector must be able to OUTLAST the membership
        # liveness horizon: a SIGSTOP'd replica stops heartbeating too,
        # and with a tight dead_after (Router's default is 2s) it would
        # go "dead" before a longer stall window could ever elapse —
        # the headline alert would be unfireable. Presence for the
        # stall check therefore uses its own horizon covering the full
        # stall window (+margin); the death sweep keeps dead_after.
        self._stall_horizon = max(self.dead_after,
                                  self.stall_after_s + 2.0)
        self.jsonl_path = jsonl_path
        self.jsonl_interval_s = float(jsonl_interval_s)
        self.slo = dict(slo_targets(), **(slo or {}))
        # minimum fresh samples before a TTFT window is judged against
        # the SLO — a 2-sample "window" p99 is noise, not a burn
        self.slo_window_min = 20
        # guards _exports (and _loads) against the fleet /statsz
        # handler threads: merged() runs per scrape on an HTTP thread
        # while the router thread ingests — an unlocked dict would
        # throw mid-iteration the moment a new replica joins
        self._lock = threading.Lock()
        self._exports: Dict[str, dict] = {}   # rid -> latest export
        self._loads: Dict[str, dict] = {}     # rid -> latest load
        self._alive: Dict[str, bool] = {}
        self._present: Dict[str, bool] = {}   # stall-horizon liveness
        self._busy: Dict[str, bool] = {}      # last load's busy state
        # rid -> (last tokens counter, monotonic time it last ADVANCED)
        self._progress: Dict[str, tuple] = {}
        # TTFT SLO window anchor: (merged hist count, merged buckets)
        # at the last judged window — the burn is computed over the
        # DELTA, so a late-onset regression alerts within one window
        # instead of waiting for the lifetime-cumulative p99 to drift,
        # and a recovered fleet re-arms the edge trigger
        self._ttft_window: tuple = (0, {})
        # per-replica goodput anchors: (monotonic t, {rid: tokens}) —
        # per-replica deltas clamp a RESTARTED replica (counter reset)
        # to zero contribution instead of negating the whole fleet's
        self._tokens_window: Optional[tuple] = None
        self._active: set = set()             # edge-trigger state
        self.alerts: List[dict] = []          # every alert ever fired
        self._jsonl_at = 0.0
        self._statsz = None

    # -- ingestion ----------------------------------------------------------

    def ingest(self, rid: str, export: Optional[dict] = None,
               load: Optional[dict] = None, alive: bool = True,
               now: Optional[float] = None,
               present: Optional[bool] = None):
        """Fold one replica's latest snapshot in (the refresh path and
        the in-process test hook). ``export`` REPLACES the replica's
        previous export — exports are cumulative, so keeping only the
        latest makes the merge exact. ``present`` is the stall-horizon
        liveness (defaults to ``alive``; refresh judges it with the
        longer ``_stall_horizon``)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._ingest_locked(rid, export, load, alive, now, present)

    def _ingest_locked(self, rid, export, load, alive, now, present):
        # the lock covers every map signals() snapshots — a controller
        # stepping on its own thread iterates them concurrently with
        # the router-thread ingest
        if export is not None:
            self._exports[rid] = export
        if load is not None:
            self._loads[rid] = load
            busy_now = (load.get("queued", 0) > 0
                        or load.get("busy_slots", 0) > 0)
            toks = load.get("tokens")
            if toks is not None:
                prev = self._progress.get(rid)
                # re-anchor on the idle→busy EDGE too: an idle replica's
                # token counter is legitimately frozen, and judging the
                # first busy beat against that minutes-old anchor would
                # fire a stall alert the instant traffic arrives
                if (prev is None or toks != prev[0]
                        or (busy_now and not self._busy.get(rid))):
                    self._progress[rid] = (toks, now)
            self._busy[rid] = busy_now
        self._alive[rid] = bool(alive)
        self._present[rid] = bool(alive if present is None else present)

    def refresh(self, now: Optional[float] = None):
        """Pull every member's heartbeat-attached export + load gauges
        from the directory (one store read per replica per field)."""
        if self.directory is None:
            return
        for rid in self.directory.members():
            self.ingest(
                rid,
                export=self.directory.stats_export(rid),
                load=self.directory.load(rid),
                alive=self.directory.alive(rid, self.dead_after),
                present=self.directory.alive(rid, self._stall_horizon),
                now=now)
        stats_lib.set_value("fleet/replicas_alive",
                            sum(1 for a in self._alive.values() if a))

    # -- aggregation --------------------------------------------------------

    def merged(self) -> stats_lib.StatRegistry:
        """One registry over the fleet's LATEST exports: counters sum,
        timers/histograms merge bucket-wise, gauges namespace
        ``<rid>/`` (replica ids beat rank numbers here — a fleet of
        nproc=1 launches is all rank 0)."""
        with self._lock:
            exports = dict(self._exports)
        out = stats_lib.StatRegistry()
        for rid in sorted(exports):
            out.load_export(exports[rid], gauge_prefix=f"{rid}/")
        return out

    def export(self) -> dict:
        return self.merged().export(rank=-1)

    def signals(self, role: Optional[str] = None,
                exclude: Collection[str] = ()) -> dict:
        """The fleet controller's condensed input (JAX
        ``fleet/controller.py``; the port's controller is still to come):
        one dict summarizing the PRESENT replicas' heartbeat load
        gauges plus the watch's fleet-level SLO gauges. ``role``
        restricts the view to one serving tier (``prefill`` /
        ``decode`` / ``both``) so a disaggregated fleet's tiers scale
        independently; None aggregates every present replica.
        ``exclude`` drops named rids from the view (the controller
        passes its draining set — those replicas still heartbeat but
        take no new placements, so their slots are not capacity).

        Keys: ``replicas`` (present rids, sorted), ``n_alive``,
        ``queued``, ``busy_slots``/``total_slots``/``occupancy``,
        ``queue_age_s`` (max over replicas), ``free_pages``/
        ``total_pages``, ``ttft_burn`` (fleet/slo_ttft_burn gauge — 0
        until a window is judged), ``goodput`` (fleet/
        goodput_tokens_per_s gauge)."""
        with self._lock:
            loads = {rid: dict(l) for rid, l in self._loads.items()}
            present = dict(self._present)
        rids = sorted(
            rid for rid, l in loads.items()
            if present.get(rid)
            and rid not in exclude
            and (role is None or l.get("role", "both") == role))
        busy = sum(loads[r].get("busy_slots", 0) for r in rids)
        total = sum(loads[r].get("busy_slots", 0)
                    + loads[r].get("free_slots", 0) for r in rids)
        return {
            "replicas": rids,
            "n_alive": len(rids),
            "queued": sum(loads[r].get("queued", 0) for r in rids),
            "busy_slots": busy,
            "total_slots": total,
            "occupancy": (busy / total) if total else 0.0,
            "queue_age_s": max(
                [float(loads[r].get("queue_age_s", 0.0) or 0.0)
                 for r in rids], default=0.0),
            "free_pages": sum(loads[r].get("free_pages", 0)
                              for r in rids),
            "total_pages": sum(loads[r].get("total_pages", 0)
                               for r in rids),
            "ttft_burn": float(stats_lib.get("fleet/slo_ttft_burn", 0.0)),
            "goodput": float(
                stats_lib.get("fleet/goodput_tokens_per_s", 0.0)),
        }

    def serve_statsz(self, port: int = 0, host: str = "0.0.0.0"):
        """Fleet-level /statsz: every scrape serves a freshly merged
        registry. Returns the server (read ``.port``)."""
        from paddle_tpu_torch.observability.statsz import StatszServer
        if self._statsz is None:
            self._statsz = StatszServer(port, host, registry=self.merged)
        return self._statsz

    # -- alerts -------------------------------------------------------------

    def _fire(self, kind: str, key, msg: str) -> bool:
        """Edge-triggered alert: one counter tick + one log line per
        incident; returns True when this call fired it."""
        if key in self._active:
            return False
        self._active.add(key)
        stats_lib.add(f"fleet/alert_{kind}")
        rec = {"t": time.time(), "kind": kind, "msg": msg}
        self.alerts.append(rec)
        print(f"[fleet] ALERT {kind}: {msg}", file=sys.stderr,
              flush=True)
        return True

    def _clear(self, key):
        self._active.discard(key)

    def watch(self, now: Optional[float] = None,
              merged: Optional[stats_lib.StatRegistry] = None
              ) -> List[str]:
        """Run every detector over the current state; returns the alert
        kinds that fired ON THIS CALL (edge transitions only).
        ``merged`` lets :meth:`poll` reuse one merge for watch + jsonl
        instead of rebuilding the full fleet registry per consumer."""
        now = time.monotonic() if now is None else now
        fired: List[str] = []

        # per-replica detectors — PRESENT replicas only: a dead
        # replica's last load is frozen (busy_slots / queue_age /
        # free_pages stuck at whatever it died with) and must neither
        # alert forever nor hold an incident active forever — death is
        # the membership sweep's story, not an anomaly
        for rid, load in self._loads.items():
            if not self._present.get(rid):
                for key in (("stalled", rid), ("queue_age", rid),
                            ("pool", rid)):
                    self._clear(key)
                continue
            busy = (load.get("queued", 0) > 0
                    or load.get("busy_slots", 0) > 0)
            # stalled: recently-heartbeating replica (the stall-horizon
            # presence — see __init__), work on board, tokens frozen
            prog = self._progress.get(rid)
            key = ("stalled", rid)
            if (busy and prog is not None
                    and now - prog[1] > self.stall_after_s):
                if self._fire("stalled_replica", key,
                              f"replica {rid} alive but zero token "
                              f"progress for {now - prog[1]:.1f}s "
                              f"(queued={load.get('queued', 0)}, "
                              f"busy_slots={load.get('busy_slots', 0)})"):
                    fired.append("stalled_replica")
            else:
                self._clear(key)
            # runaway queue age
            age = float(load.get("queue_age_s", 0.0) or 0.0)
            key = ("queue_age", rid)
            limit = self.slo.get("queue_age_s") or 30.0
            if age > limit:
                if self._fire("queue_age", key,
                              f"replica {rid} oldest queued request "
                              f"{age:.1f}s old (limit {limit:.0f}s)"):
                    fired.append("queue_age")
            else:
                self._clear(key)
            # pool-page exhaustion (paged replicas only)
            key = ("pool", rid)
            if (load.get("total_pages", 0) > 0
                    and load.get("free_pages", 0) <= 0
                    and load.get("queued", 0) > 0):
                if self._fire("pool_exhausted", key,
                              f"replica {rid} page pool exhausted with "
                              f"{load.get('queued', 0)} queued"):
                    fired.append("pool_exhausted")
            else:
                self._clear(key)

        # fleet-level SLO burn over a WINDOW of fresh samples: the
        # lifetime-cumulative p99 would both lag a late-onset
        # regression by however much healthy history preceded it AND
        # never recover below target after one incident (permanently
        # disarming the edge trigger). The window is the bucket-wise
        # DELTA of the merged histogram since the last judged window,
        # advanced only once it holds >= slo_window_min samples.
        target = self.slo.get("ttft_p99_ms")
        if target:
            if merged is None:
                merged = self.merged()
            hist = merged.histogram("serve/ttft_s")
            if hist is not None and hist.count:
                prev_n, prev_b = self._ttft_window
                if hist.count < prev_n:
                    # a replica restart REPLACED its cumulative export
                    # with a near-empty one, shrinking the merged
                    # census below the window anchor — re-anchor, or
                    # dn stays negative and the burn gauge/alert is
                    # disarmed until the whole fleet re-serves past
                    # the stale anchor (exactly when a post-restart
                    # regression is likeliest)
                    self._ttft_window = (hist.count,
                                         dict(hist.buckets))
                    prev_n, prev_b = self._ttft_window
                dn = hist.count - prev_n
                if dn >= self.slo_window_min:
                    dh = stats_lib._Histogram()
                    dh.buckets = {
                        i: c - prev_b.get(i, 0)
                        for i, c in hist.buckets.items()
                        if c - prev_b.get(i, 0) > 0}
                    # count from the surviving positive deltas: a
                    # restart landing mid-window can shrink individual
                    # buckets without shrinking the total
                    dh.count = sum(dh.buckets.values())
                    # clamp bounds from the cumulative hist (cosmetic
                    # only — the representative is the bucket midpoint)
                    dh.min, dh.max = hist.min, hist.max
                    if dh.count:
                        p99_ms = dh.percentile(99) * 1e3
                        burn = p99_ms / target
                        stats_lib.set_value("fleet/slo_ttft_burn",
                                            burn)
                        if burn > 1.0:
                            if self._fire(
                                    "slo_ttft", ("slo_ttft",),
                                    f"fleet p99 TTFT {p99_ms:.0f}ms "
                                    f"over the {target:.0f}ms SLO "
                                    f"over the last {dh.count} "
                                    f"requests (burn {burn:.2f})"):
                                fired.append("slo_ttft")
                        else:
                            self._clear(("slo_ttft",))
                    self._ttft_window = (hist.count,
                                         dict(hist.buckets))

        # fleet goodput: PER-REPLICA token deltas over the refresh
        # window (load-gauge counters, so it works even when a wedged
        # replica stops exporting; a restarted replica's reset counter
        # clamps to zero contribution instead of negating the fleet's)
        cur = {rid: int(l.get("tokens", 0))
               for rid, l in self._loads.items()
               if self._present.get(rid)}
        if self._tokens_window is not None:
            t0, prev = self._tokens_window
            dt = now - t0
            if dt > 0.5:
                rate = sum(max(0, c - prev.get(rid, c))
                           for rid, c in cur.items()) / dt
                stats_lib.set_value("fleet/goodput_tokens_per_s", rate)
                floor = self.slo.get("goodput")
                # a dead replica's frozen busy_slots must not keep the
                # fleet "busy" (and the goodput alert armed) forever
                busy = any((l.get("queued", 0) > 0
                            or l.get("busy_slots", 0) > 0)
                           and self._present.get(rid)
                           for rid, l in self._loads.items())
                if floor and busy and rate < floor:
                    if self._fire("slo_goodput", ("slo_goodput",),
                                  f"fleet goodput {rate:.1f} tok/s "
                                  f"under the {floor:.1f} floor"):
                        fired.append("slo_goodput")
                else:
                    self._clear(("slo_goodput",))
                self._tokens_window = (now, cur)
        else:
            self._tokens_window = (now, cur)
        return fired

    # -- telemetry ----------------------------------------------------------

    def append_jsonl(self, path: Optional[str] = None,
                     merged: Optional[stats_lib.StatRegistry] = None):
        """Append one telemetry line: wall time, per-replica load
        gauges, active alerts, and the merged serve/fleet snapshot."""
        path = path or self.jsonl_path
        if not path:
            return None
        if merged is None:
            merged = self.merged()
        snap = merged.snapshot("serve/")
        snap.update(stats_lib.snapshot("fleet/"))
        line = {"t": time.time(),
                "alive": sorted(r for r, a in self._alive.items() if a),
                "loads": self._loads,
                "alerts_active": sorted(str(k) for k in self._active),
                "stats": snap}
        with open(path, "a") as f:
            f.write(json.dumps(line) + "\n")
        return path

    def poll(self, now: Optional[float] = None) -> List[str]:
        """One pump: refresh from the directory, run the watch, append
        JSONL at its own cadence. The router calls this from its poll
        loop (throttling is the caller's business — Router throttles to
        its fleet-stats refresh interval)."""
        self.refresh(now=now)
        # ONE merge per pump, shared by the watch and the telemetry
        # line — merged() deserializes every replica's full export
        merged = self.merged()
        fired = self.watch(now=now, merged=merged)
        t = time.monotonic() if now is None else now
        if self.jsonl_path and t - self._jsonl_at >= self.jsonl_interval_s:
            self._jsonl_at = t
            try:
                self.append_jsonl(merged=merged)
            except OSError:
                pass
        return fired
