"""The serving fleet's resilience layer on the CPU: the port's
``native.decode_counter``, ``distributed/{resilience,liveness,
membership}.py`` against the JAX modules. Each case feeds both packages
the same calls, on a dict store each (or one shared store), under one
fake clock where time matters, and compares what comes out: store
contents byte for byte, decisions, exception kinds and messages, and the
names and values of the ``resilience/*`` / ``serve/*`` stats.

``decode_counter``: the JAX decoder reads any 8-byte value as a
little-endian int64; the port's store (``torch.distributed.TCPStore``)
keeps counters as ASCII decimal, so the port parses ASCII first. The
8-digit case is where the two differ, by design."""

import random
import threading
import time

import pytest

from paddle_tpu import native as jnative
from paddle_tpu import stats as jstats
from paddle_tpu.distributed import liveness as jlive
from paddle_tpu.distributed import membership as jmem
from paddle_tpu.distributed import resilience as jres
from paddle_tpu.testing import faults as jfaults
from paddle_tpu_torch import native as pnative
from paddle_tpu_torch import stats as pstats
from paddle_tpu_torch.distributed import liveness as plive
from paddle_tpu_torch.distributed import membership as pmem
from paddle_tpu_torch.distributed import resilience as pres
from paddle_tpu_torch.testing import faults as pfaults

PKGS = {"jax": (jres, jstats, jfaults), "port": (pres, pstats, pfaults)}


@pytest.fixture(autouse=True)
def _clean():
    for _, st, fa in PKGS.values():
        st.reset()
        fa.clear()
    yield
    for _, st, fa in PKGS.values():
        st.reset()
        fa.clear()


class _Store:
    """The store protocol on a locked dict: ``get`` raises TimeoutError
    for an absent key, counters are ASCII (as torch's store keeps them),
    every op raises ConnectionError while ``fail`` is set."""

    def __init__(self):
        self.kv = {}
        self.fail = False
        self.lock = threading.Lock()

    def _check(self):
        if self.fail:
            raise ConnectionError("store unreachable")

    def get(self, key, timeout=30.0):
        self._check()
        with self.lock:
            if key not in self.kv:
                raise TimeoutError(f"get({key!r}) timed out")
            return self.kv[key]

    def set(self, key, value):
        self._check()
        with self.lock:
            self.kv[key] = (value.encode() if isinstance(value, str)
                            else bytes(value))

    def add(self, key, amount=1):
        self._check()
        with self.lock:
            v = int(self.kv.get(key, b"0")) + int(amount)
            self.kv[key] = str(v).encode()
            return v

    def delete_key(self, key):
        self._check()
        with self.lock:
            return self.kv.pop(key, None) is not None

    def wait(self, keys, timeout=30.0):
        self._check()

    def close(self):
        pass


class _Clock:
    """A fake ``time`` module for one package's resilience module:
    ``monotonic`` reads the clock, ``sleep`` advances it and records the
    delay."""

    def __init__(self, t=1000.0):
        self.t = t
        self.sleeps = []

    def monotonic(self):
        return self.t

    def sleep(self, s):
        self.sleeps.append(s)
        self.t += s


def _stats(st, prefix="resilience/"):
    return st.snapshot(prefix)


def _both(fn):
    got = {name: fn(*mods) for name, mods in PKGS.items()}
    assert got["port"] == got["jax"]
    return got["port"]


def test_decode_counter():
    le = (12345678).to_bytes(8, "little", signed=True)
    neg = (-5).to_bytes(8, "little", signed=True)
    for raw in (b"0", b"7", b"-3", "42", 9, le, neg, bytearray(b"99")):
        assert pnative.decode_counter(raw) == jnative.decode_counter(raw)
    # an 8-digit ASCII counter (torch's add past 10,000,000): the JAX
    # decoder reads it as little-endian bytes, the port as the number
    assert pnative.decode_counter(b"12345678") == 12345678
    assert jnative.decode_counter(b"12345678") == int.from_bytes(
        b"12345678", "little", signed=True)
    assert pnative.decode_counter(b"99999999") == 99999999
    with pytest.raises(ValueError):
        pnative.decode_counter(b"abc")


def test_deadline_and_retry_policy(monkeypatch):
    def run(res, st, fa):
        clock = _Clock()
        monkeypatch.setattr(res, "time", clock)
        out = {}
        dl = res.Deadline(2.0)
        clock.t += 0.5
        out["dl"] = (dl.elapsed(), dl.remaining(), dl.expired,
                     dl.budget(5.0), dl.budget(1.0), dl.budget(0.0, 0.01))
        clock.t += 2.0
        with pytest.raises(res.DeadlineExceeded) as e:
            dl.check("op")
        out["dl_msg"] = str(e.value)
        free = res.Deadline(None)
        out["free"] = (free.remaining(), free.expired, free.budget(3.0))
        random.seed(7)
        pol = res.RetryPolicy(max_attempts=6, base_delay=0.1, deadline=5.0)
        out["delays"] = [pol.delay_for(a) for a in range(1, 8)]
        # transient failures, then a value: the same sleeps and stats
        random.seed(11)
        calls = []

        def flaky():
            calls.append(clock.t)
            if len(calls) < 4:
                raise ConnectionError("blip")
            return "v"
        out["ok"] = pol.run(flaky, op="probe")
        out["sleeps"] = list(clock.sleeps)
        # exhausted attempts re-raise the last error
        with pytest.raises(OSError):
            res.RetryPolicy(max_attempts=2, deadline=None).run(
                lambda: (_ for _ in ()).throw(OSError("down")), op="x")
        # the deadline bounds the whole call
        random.seed(3)
        with pytest.raises(res.DeadlineExceeded) as e:
            res.RetryPolicy(max_attempts=100, base_delay=0.5,
                            deadline=1.0).run(
                lambda: (_ for _ in ()).throw(TimeoutError("t")), op="y")
        out["deadline_msg"] = str(e.value)
        # an inner DeadlineExceeded is final
        n = []

        def inner():
            n.append(1)
            raise res.DeadlineExceeded("inner")
        with pytest.raises(res.DeadlineExceeded):
            pol.run(inner)
        out["inner_calls"] = len(n)
        # with_deadline: a fresh deadline each call, retries inside
        random.seed(5)
        k = []

        def twice(x):
            k.append(x)
            if len(k) % 2:
                raise ConnectionError("c")
            return x * 2
        g = res.with_deadline(twice, seconds=3.0, op="wd")
        out["wd"] = (g.__name__, g(4), g(5))
        out["stats"] = _stats(st)
        out["sleeps_all"] = list(clock.sleeps)
        return out
    rec = _both(run)
    assert rec["ok"] == "v" and rec["stats"]["resilience/retries"] > 3


def test_store_get_set(monkeypatch):
    def run(res, st, fa):
        store = _Store()
        res.store_set(store, "k", "v")
        out = {"get": res.store_get(store, "k", deadline=1.0)}
        clock = _Clock()
        monkeypatch.setattr(res, "time", clock)

        class Slow(_Store):
            def get(self, key, timeout=30.0):
                clock.t += timeout
                raise TimeoutError("absent")
        with pytest.raises(res.DeadlineExceeded) as e:
            res.store_get(Slow(), "absent", deadline=0.5)
        out["absent"] = str(e.value)
        with fa.inject("store.get", "raise", exc="ConnectionError",
                       count=2):
            out["faulted"] = res.store_get(store, "k", deadline=5.0)
        out["kv"] = store.kv
        out["stats"] = _stats(st)
        return out
    rec = _both(run)
    assert rec["get"] == b"v" and rec["faulted"] == b"v"


def test_collective_watchdog():
    """Two ranks on one store per package: both arrive (a sync); rank 1
    never arrives at the second guard (rank 0 raises naming it); a
    straggler delayed at ``watchdog.enter`` still syncs."""
    def run(res, st, fa):
        store = _Store()
        wds = [res.CollectiveWatchdog(store, r, 2, group="g",
                                      deadline=2.0, poll=0.005)
               for r in range(2)]
        out = {}
        errs = []

        def barrier(wd):
            try:
                wd.barrier("sync")
            except Exception as e:          # noqa: BLE001 — relayed
                errs.append(e)
        ts = [threading.Thread(target=barrier, args=(w,)) for w in wds]
        for t in ts:
            t.start()
        for t in ts:
            t.join(10)
        out["sync_errs"] = errs
        out["progress"] = wds[0].progress()
        wds[0].deadline = 0.1
        with pytest.raises(res.CollectiveStallError) as e:
            wds[0].barrier("lonely")
        out["stalled"] = (e.value.stalled_ranks, "[1]" in str(e.value))
        wds[1].barrier("catch-up")          # rank 0 is already at #2
        # the straggler: rank 1 (the second to fire the site) sleeps
        # 0.2 s at entry; rank 0 waits for it within its deadline
        wds[0].deadline = 2.0
        with fa.inject("watchdog.enter", "delay", seconds=0.2, after=1):
            ts = [threading.Thread(target=barrier, args=(w,))
                  for w in wds]
            for t in ts:
                t.start()
            for t in ts:
                t.join(10)
        out["straggler_errs"] = errs
        out["kv"] = dict(store.kv)
        out["stats"] = _stats(st)
        return out
    rec = _both(run)
    assert rec["stalled"] == ((1,), True)
    assert rec["kv"]["resilience/wd/g/0"] == b"3" == \
        rec["kv"]["resilience/wd/g/1"]
    assert rec["stats"]["resilience/watchdog_stalls"] == 1


def test_guarded_store():
    """Round trip and key absence (never retried), a transient failure
    retried away, a partition after the budget, the grace re-check, the
    single-attempt probe, ``swap`` and the ``store.partition`` drop."""
    def run(res, st, fa):
        out = {}
        fake = _Store()
        gs = res.GuardedStore(fake, retry_s=0.3)
        gs.set("k", "v")
        out["rt"] = (gs.get("k"), gs.add("n", 3))
        t0 = time.monotonic()
        with pytest.raises(TimeoutError) as e:
            gs.get("absent", timeout=0.01)
        out["absent"] = (type(e.value).__name__,
                         time.monotonic() - t0 < 0.25)
        fake.fail = True
        heal = threading.Timer(0.1, lambda: setattr(fake, "fail", False))
        gs2 = res.GuardedStore(fake, retry_s=2.0)
        heal.start()
        gs2.set("k2", "w")
        heal.join()
        out["healed"] = fake.kv["k2"]
        fake.fail = True
        t0 = time.monotonic()
        with pytest.raises(res.StorePartitioned):
            gs.set("k", "x")
        out["partition_s"] = 0.2 < time.monotonic() - t0 < 3.0
        fake.fail = False
        gate = threading.Event()

        def lands_late():
            gate.wait(0.15)
            return 7
        out["grace"] = gs._run_async(lands_late, wait=0.1)
        t0 = time.monotonic()
        with pytest.raises(res._OpStuck):
            gs._run_async(lambda: time.sleep(1.0), wait=0.1)
        out["stuck_s"] = time.monotonic() - t0 < 1.0
        out["probe"] = [gs.probe("c")]
        gs.add("c", 5)
        out["probe"].append(gs.probe("c"))
        fake.fail = True
        out["probe"].append(gs.probe("c"))
        fake.fail = False
        with fa.inject("store.partition", "drop"):
            with pytest.raises(res.StorePartitioned):
                gs.get("k", timeout=0.01)
            out["probe"].append(gs.probe("serve/router_hb"))
        out["probe"].append(gs.probe("serve/router_hb"))
        new = _Store()
        gs.swap(new)
        gs.set("k", "new")
        out["swap"] = (new.kv, fake.kv.get("k"))
        # retries inside a wall-clock budget: the names and the verdict
        # counts are the packages' to agree on, not how many retries fit
        snap = _stats(st)
        out["stats"] = (sorted(snap), {k: snap[k] for k in (
            "resilience/store_partitions", "resilience/store_swaps")})
        out["bytes"] = _stats(st, "serve/store_bytes")
        gs.close()
        return out
    rec = _both(run)
    assert rec["rt"] == (b"v", 3) and rec["probe"] == [0, 5, None, None,
                                                        0]
    assert rec["grace"] == 7 and rec["stats"][1] == {
        "resilience/store_partitions": 2, "resilience/store_swaps": 1}


def test_progress_judge():
    def run(live):
        j = live.ProgressJudge()
        seq = [("a", 1, 0.0), ("a", 1, 1.0), ("a", None, 2.0),
               ("a", 2, 3.0), ("b", None, 3.5), ("a", 2, 9.0)]
        out = [(j.update(k, c, now=t), j.stalled_for(k, now=t),
                j.alive(k, 2.0, now=t), j.has(k)) for k, c, t in seq]
        j.forget("a")
        out.append((j.has("a"), j.stalled_for("a", now=10.0)))
        return out
    assert run(plive) == run(jlive)


def test_replica_directory(monkeypatch):
    """The same announce / heartbeat / state calls on a store per
    package leave byte-equal store contents and the same members, loads,
    exports, states and liveness (judged under one fake clock)."""
    got = {}
    for name, mem in (("jax", jmem), ("port", pmem)):
        clock = _Clock()
        monkeypatch.setattr(mem, "time", clock)
        store = _Store()
        rep, obs = mem.ReplicaDirectory(store), mem.ReplicaDirectory(store)
        out = {"empty": (obs.members(), obs.alive("ghost", 0.1),
                         obs.load("r0"), obs.stats_export("r0"),
                         obs.state("ghost"))}
        rep.announce("r0", {"slots": 2, "role": "decode"})
        rep.announce("r1", {"slots": 4})
        rep.set_state("r1", "draining")
        rep.announce("r1", {"slots": 4})      # keeps draining
        out["beat"] = rep.heartbeat("r0", load={"queued": 1},
                                    stats={"counters": {"a": 1}})
        out["alive"] = [obs.alive("r0", 0.2)]
        clock.t += 0.1
        rep.heartbeat("r0")
        out["alive"].append(obs.alive("r0", 0.2))
        clock.t += 0.3
        out["alive"].append(obs.alive("r0", 0.2))
        rep.heartbeat("r0")
        out["alive"].append(obs.alive("r0", 0.2))
        with pytest.raises(ValueError):
            rep.set_state("r0", "gone")
        out["view"] = (obs.members(), obs.load("r0"),
                       obs.stats_export("r0"), obs.state("r0"),
                       obs.state("r1"))
        out["kv"] = dict(store.kv)
        got[name] = out
    assert got["port"] == got["jax"]
    assert got["port"]["alive"] == [True, True, False, True]
    assert got["port"]["view"][4] == "draining"
