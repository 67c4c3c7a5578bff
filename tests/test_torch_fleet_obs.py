"""The fleet telemetry plane on the CPU: the port's
``observability/fleet.FleetStats`` against the JAX module's, fed the
same exports, load gauges and clock readings. Each scenario runs once
per package (each with its own ``stats`` registry and ``StatRegistry``)
and returns what a user sees: the merged snapshot, ``signals``, the
alert kinds each ``watch`` fired, the alert messages and the
``fleet/*`` stats. Tolerance: equal.

Covered: the merged snapshot over three replicas (counters sum,
histograms bucket-wise, gauges under ``<rid>/``, latest export wins),
``signals`` by role and with exclusions, the edge-triggered stall alert
(re-arm, idle, the stall horizon, the idle->busy re-anchor, a dead
replica's frozen load), the queue-age and pool alerts, the windowed
TTFT burn and goodput (recovery, a restart's census re-anchor), the
served fleet ``/statsz``, the JSONL line, and ``refresh`` from a
``ReplicaDirectory`` on a store."""

import json
import threading
import urllib.request

import numpy as np
import pytest

from paddle_tpu import stats as jstats
from paddle_tpu.distributed.membership import (
    ReplicaDirectory as JaxDirectory)
from paddle_tpu.observability import fleet as jfleet
from paddle_tpu_torch import stats as pstats
from paddle_tpu_torch.distributed.membership import ReplicaDirectory
from paddle_tpu_torch.observability import fleet as pfleet

PACKAGES = {"jax": (jfleet, jstats), "port": (pfleet, pstats)}


@pytest.fixture(autouse=True)
def _clean():
    for _, st in PACKAGES.values():
        st.reset()
    yield
    for _, st in PACKAGES.values():
        st.reset()


def _both(scenario):
    """Run ``scenario(fleet_module, stats_module)`` for each package and
    return the two records, after asserting they are equal."""
    got = {}
    for name, (fl, st) in PACKAGES.items():
        got[name] = scenario(fl, st)
    assert got["port"] == got["jax"]
    return got["port"]


def _alerts(fleet):
    return [(a["kind"], a["msg"]) for a in fleet.alerts]


def test_merged_snapshot_and_signals_equal():
    def scenario(fl, st):
        rs = np.random.RandomState(0)
        regs = [st.StatRegistry() for _ in range(3)]
        for i, reg in enumerate(regs):
            for v in rs.lognormal(mean=-3.0 + i * 0.5, sigma=0.7,
                                  size=200):
                reg.observe("serve/ttft_s", float(v))
            reg.add("serve/queue_backfill", 10 * (i + 1))
            reg.set_value("mem/hbm_bytes_in_use", 1000 * i)
            with reg.timer("serve/dispatch"):
                pass
        fleet = fl.FleetStats()
        roles = ("prefill", "decode", "both")
        for i, reg in enumerate(regs):
            fleet.ingest(f"r{i}", export=reg.export(rank=0),
                         load={"role": roles[i], "queued": i,
                               "busy_slots": i, "free_slots": 4 - i,
                               "free_pages": 10 * i, "total_pages": 32,
                               "queue_age_s": 0.5 * i, "tokens": 7 * i},
                         now=1.0)
        snap = fleet.merged().snapshot()
        snap = {k: v for k, v in snap.items() if "dispatch" not in k
                or k.endswith(".count")}
        regs[0].add("serve/queue_backfill", 5)
        fleet.ingest("r0", export=regs[0].export(rank=0))
        return {"snapshot": snap,
                "after_reingest": fleet.merged().get(
                    "serve/queue_backfill"),
                "signals": fleet.signals(),
                "decode": fleet.signals(role="decode"),
                "excluded": fleet.signals(exclude=("r1",)),
                "export_keys": sorted(fleet.export())}
    rec = _both(scenario)
    assert rec["after_reingest"] == 65
    assert rec["signals"]["n_alive"] == 3
    assert "r1/mem/hbm_bytes_in_use" in rec["snapshot"]


def test_stall_alert_edge_triggered_equal():
    def scenario(fl, st):
        out = []
        fleet = fl.FleetStats(stall_after_s=5.0)
        busy = {"queued": 1, "busy_slots": 1, "tokens": 100}
        fleet.ingest("r0", load=dict(busy), alive=True, now=0.0)
        out.append(fleet.watch(now=1.0))
        fleet.ingest("r0", load=dict(busy), alive=True, now=6.0)
        out.append(fleet.watch(now=6.0))
        out.append(fleet.watch(now=8.0))
        fleet.ingest("r0", load=dict(busy, tokens=150), now=9.0)
        out.append(fleet.watch(now=9.0))
        fleet.ingest("r0", load=dict(busy, tokens=150), now=20.0)
        out.append(fleet.watch(now=20.0))
        idle = {"queued": 0, "busy_slots": 0, "tokens": 7}
        f2 = fl.FleetStats(stall_after_s=1.0)
        f2.ingest("r1", load=dict(idle), now=0.0)
        f2.ingest("r1", load=dict(idle), now=10.0)
        out.append(f2.watch(now=10.0))
        f3 = fl.FleetStats(dead_after=2.0, stall_after_s=5.0)
        f3.ingest("r9", load=dict(busy), alive=False, present=False,
                  now=0.0)
        f3.ingest("r9", load=dict(busy), alive=False, present=False,
                  now=10.0)
        out.append(f3.watch(now=10.0))
        f4 = fl.FleetStats(stall_after_s=5.0)
        idle = {"queued": 0, "busy_slots": 0, "tokens": 42}
        f4.ingest("r0", load=dict(idle), now=0.0)
        f4.ingest("r0", load=dict(idle, queued=1, busy_slots=1), now=60.0)
        out += [f4.watch(now=60.0), f4.watch(now=64.0)]
        f4.ingest("r0", load=dict(idle, queued=1, busy_slots=1), now=66.0)
        out.append(f4.watch(now=66.0))
        f5 = fl.FleetStats(slo={"queue_age_s": 1.0})
        hot = {"queued": 3, "busy_slots": 1, "tokens": 1,
               "queue_age_s": 9.0}
        f5.ingest("rX", load=dict(hot), now=0.0)
        out.append(f5.watch(now=0.0))
        f5.ingest("rX", load=dict(hot), alive=False, present=False,
                  now=5.0)
        out.append(f5.watch(now=5.0))
        return {"fired": out, "alerts": _alerts(fleet) + _alerts(f4),
                "horizon": f3._stall_horizon, "active": sorted(f5._active),
                "count": st.get("fleet/alert_stalled_replica")}
    rec = _both(scenario)
    assert rec["fired"][1] == ["stalled_replica"] and rec["count"] == 3
    assert rec["fired"][2] == [] and rec["fired"][4] == ["stalled_replica"]


def test_queue_age_pool_slo_burn_and_goodput_equal():
    def scenario(fl, st):
        out = []
        fleet = fl.FleetStats(slo={"queue_age_s": 2.0})
        fleet.ingest("r0", load={"queued": 3, "busy_slots": 1,
                                 "tokens": 1, "queue_age_s": 5.0},
                     now=0.0)
        out.append(fleet.watch(now=0.0))
        fleet.ingest("r1", load={"queued": 2, "busy_slots": 1,
                                 "tokens": 1, "total_pages": 16,
                                 "free_pages": 0}, now=0.1)
        out.append(fleet.watch(now=0.2))
        fleet.ingest("r2", load={"queued": 2, "busy_slots": 1,
                                 "tokens": 1, "total_pages": 0,
                                 "free_pages": 0}, now=0.3)
        out.append(fleet.watch(now=0.4))
        slo = fl.FleetStats(slo={"ttft_p99_ms": 10.0, "goodput": 100.0})
        reg = st.StatRegistry()
        for _ in range(50):
            reg.observe("serve/ttft_s", 0.05)
        busy = {"queued": 1, "busy_slots": 1}
        gauges = []
        slo.ingest("r0", export=reg.export(rank=0),
                   load=dict(busy, tokens=0), now=0.0)
        out += [slo.watch(now=0.0), slo.watch(now=0.5)]
        slo.ingest("r0", load=dict(busy, tokens=10), now=2.0)
        out.append(slo.watch(now=2.0))
        gauges.append(st.get("fleet/goodput_tokens_per_s"))
        for _ in range(30):
            reg.observe("serve/ttft_s", 0.001)
        slo.ingest("r0", export=reg.export(rank=0), now=3.0)
        out.append(slo.watch(now=3.0))
        gauges.append(st.get("fleet/slo_ttft_burn"))
        for _ in range(25):
            reg.observe("serve/ttft_s", 0.08)
        slo.ingest("r0", export=reg.export(rank=0), now=4.0)
        out.append(slo.watch(now=4.0))
        slo.ingest("r0", load=dict(busy, tokens=2), now=6.0)
        out.append(slo.watch(now=6.0))
        fresh = st.StatRegistry()
        for _ in range(2):
            fresh.observe("serve/ttft_s", 0.09)
        slo.ingest("r0", export=fresh.export(rank=0), now=7.0)
        out.append(slo.watch(now=7.0))
        anchors = [slo._ttft_window[0]]
        for _ in range(25):
            fresh.observe("serve/ttft_s", 0.09)
        slo.ingest("r0", export=fresh.export(rank=0), now=8.0)
        out.append(slo.watch(now=8.0))
        anchors.append(slo._ttft_window[0])
        gauges += [st.get("fleet/slo_ttft_burn"),
                   st.get("fleet/goodput_tokens_per_s")]
        return {"fired": out, "alerts": _alerts(fleet) + _alerts(slo),
                "gauges": gauges, "anchors": anchors,
                "counts": st.snapshot("fleet/alert_")}
    rec = _both(scenario)
    assert "queue_age" in rec["fired"][0]
    assert "pool_exhausted" in rec["fired"][1] and rec["fired"][2] == []
    assert rec["counts"]["fleet/alert_slo_ttft"] == 2
    assert rec["anchors"] == [2, 27] and rec["gauges"][2] > 1.0


def test_statsz_and_jsonl_equal(tmp_path):
    def scenario(fl, st):
        reg = st.StatRegistry()
        reg.add("serve/queue_backfill", 3)
        reg.observe("serve/ttft_s", 0.02)
        path = str(tmp_path / f"{fl.__name__}.jsonl")
        fleet = fl.FleetStats(jsonl_path=path)
        fleet.ingest("r0", export=reg.export(rank=0),
                     load={"queued": 0, "busy_slots": 0, "tokens": 5})
        srv = fleet.serve_statsz(0, host="127.0.0.1")
        try:
            docs = []
            for q in ("/statsz", "/statsz?flat=1", "/metricsz"):
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{srv.port}{q}",
                        timeout=5) as r:
                    docs.append(r.read().decode())
        finally:
            fleet._statsz = None
            srv.stop()
        fleet.append_jsonl()
        fleet.append_jsonl()
        lines = [json.loads(ln) for ln in open(path)]
        for ln in lines:
            ln.pop("t")
        docs[0] = json.loads(docs[0])
        docs[0].pop("t", None)
        return {"docs": docs, "lines": lines}
    rec = _both(scenario)
    assert rec["docs"][0]["counters"]["serve/queue_backfill"] == 3
    assert len(rec["lines"]) == 2
    assert rec["lines"][0]["loads"]["r0"]["tokens"] == 5


class _Store:
    """The store protocol on a locked dict (counters in ASCII)."""

    def __init__(self):
        self.kv = {}
        self.lock = threading.Lock()

    def set(self, key, value):
        with self.lock:
            self.kv[key] = (value.encode() if isinstance(value, str)
                            else bytes(value))

    def get(self, key, timeout=30.0):
        with self.lock:
            if key not in self.kv:
                raise TimeoutError(key)
            return self.kv[key]

    def add(self, key, amount=1):
        with self.lock:
            v = int(self.kv.get(key, b"0")) + int(amount)
            self.kv[key] = str(v).encode()
            return v


def test_refresh_from_directory_equal():
    """Replicas heartbeat load gauges and stat exports into a store
    through ``ReplicaDirectory``; ``FleetStats(directory).poll`` of both
    packages reads the same merged registry and the same signals."""
    def scenario(fl, st):
        store = _Store()
        directory = (ReplicaDirectory if fl is pfleet
                     else JaxDirectory)(store)
        for i in range(2):
            directory.announce(f"r{i}", {"role": "both", "slots": 4})
            reg = st.StatRegistry()
            reg.add("serve/tokens", 10 * (i + 1))
            directory.heartbeat(f"r{i}", load={
                "role": "both", "queued": 0, "busy_slots": 1,
                "free_slots": 3, "tokens": 10 * (i + 1)},
                stats=reg.export(rank=0))
        fleet = fl.FleetStats(directory, dead_after=5.0)
        fired = fleet.poll(now=100.0)
        return {"fired": fired,
                "tokens": fleet.merged().get("serve/tokens"),
                "alive": st.get("fleet/replicas_alive"),
                "signals": fleet.signals(), "store": dict(store.kv)}
    rec = _both(scenario)
    assert rec["tokens"] == 30 and rec["alive"] == 2
