"""Serving past one engine on the CPU: the port's ``serving/router.py``
(``Router``, ``RouterLink``, ``ReplicaSession``, ``serve_replica``) and
``serving/disagg.py``'s role loops, against the JAX modules, with a tiny
fp32 GPT (2 layers, d 32, vocab 96, weights at std 0.5 from a numpy
seed) carried into the JAX package by the converter.

- placement by a script: both packages' routers, each on its own dict
  store, fed the same announcements, heartbeats and results, leave
  byte-equal stores (mailbox keys and messages) and equal assignments:
  least-outstanding, role-aware with the handoff phase, the
  handoff-failed re-placement;
- across packages on one store, replicas in threads: a JAX ``Router``
  drives port replicas, and a port ``Router`` drives JAX replicas
  (``PagedDecodeEngine(mega=False)``); every stream equals direct
  single-engine serving;
- a replica thread's death (a ``raise`` at ``serve.loop``, caught by
  the thread's wrapper: it stops heartbeating) redistributes its
  requests, no id lost; a drain with migration keeps every stream;
- ``RouterLink`` / ``ReplicaSession`` partition, heal, buffered and
  duplicate results, the new-generation republish, and journal
  ``recover``;
- the disaggregated round trip (prefill replica -> handoff -> decode
  replica) and a fleet hit that skips the prefill tier;
- one cross-process case: two port replica processes (this file run as
  a script) on a ``native.TCPStore``, one SIGKILLed, zero loss.

Every wait is bounded (``WAIT_S``). Streams are compared token for
token, stores byte for byte."""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import torch

FIELDS = dict(vocab_size=96, max_seq_len=512, d_model=32, n_layers=2,
              n_heads=4)
SLOTS, PAGES, NEW = 4, 16, 8
WAIT_S = 30.0
HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(HERE))


class _Store:
    """The store protocol on a locked dict: ``set``, ``get(key,
    timeout)`` (TimeoutError when absent), ``add`` (ASCII counters, as
    torch's store keeps them), ``delete_key``, ``wait``; every op raises
    ConnectionError while ``fail`` is set."""

    def __init__(self):
        self.kv = {}
        self.fail = False
        self.lock = threading.Lock()

    def _check(self):
        if self.fail:
            raise ConnectionError("store unreachable")

    def set(self, key, value):
        self._check()
        with self.lock:
            self.kv[key] = (value.encode() if isinstance(value, str)
                            else bytes(value))

    def get(self, key, timeout=30.0):
        self._check()
        with self.lock:
            if key in self.kv:
                return self.kv[key]
        raise TimeoutError(f"get({key!r}) timed out")

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


def port_model(seed=0):
    """The tiny GPT in the port, every parameter redrawn from a numpy
    seed (std 0.5, LayerNorm scales near 1), and its state under the JAX
    names."""
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.models.convert import (gpt_from_jax_state,
                                                 gpt_to_jax_state)
    cfg = gpt.GPTConfig(dtype=torch.float32, **FIELDS)
    shapes = {k: v.shape for k, v in gpt_to_jax_state(
        gpt.GPT(cfg, device="cpu")).items()}
    rs = np.random.RandomState(seed)
    state = {}
    for k in sorted(shapes):
        noise = rs.randn(*shapes[k]).astype(np.float32)
        state[k] = (1.0 + 0.1 * noise) if "scale" in k else 0.5 * noise
    return gpt_from_jax_state(cfg, state, device="cpu"), state


def port_engine(model, **kw):
    from paddle_tpu_torch.inference.paged_engine import PagedDecodeEngine
    return PagedDecodeEngine(model, n_pages=PAGES, max_slots=SLOTS,
                             device="cpu", **kw)


def prompts(seed=1, lengths=(5, 40, 130, 170)):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 96, size=n).tolist() for n in lengths]


def direct(model, ps, new=NEW):
    """Direct single-engine serving: the reference streams (``new``: one
    budget, or one a prompt)."""
    eng = port_engine(model)
    news = new if isinstance(new, (list, tuple)) else [new] * len(ps)
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(ps, news)]
    eng.run()
    out = [list(r.tokens) for r in reqs]
    assert all(len(set(t)) > 1 for t in out), out
    return out


def _thread(fn, *args, **kw):
    """Run a serve loop in a daemon thread; an exception out of it (a
    replica's death) is kept on ``t.err``."""
    err = []

    def run():
        try:
            fn(*args, **kw)
        except BaseException as e:          # noqa: BLE001 — kept
            err.append(e)
    t = threading.Thread(target=run, daemon=True)
    t.err = err
    t.start()
    return t


def _drain(router, n, timeout=WAIT_S):
    """Poll and sweep until ``n`` results landed (bounded)."""
    t_end = time.monotonic() + timeout
    while len(router.results) < n:
        assert time.monotonic() < t_end, (
            f"{len(router.results)}/{n} results after {timeout}s")
        router.poll()
        router.check_replicas()
        time.sleep(0.005)
    return dict(router.results)


def _until(cond, timeout=WAIT_S, what="condition"):
    t_end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < t_end, f"{what} not met in {timeout}s"
        time.sleep(0.01)


def _stop(router, threads):
    router.shutdown()
    for t in threads:
        t.join(WAIT_S)
        assert not t.is_alive(), "a replica loop did not exit"


# ---------------------------------------------------------------------------
# the CPU tests (the module imports JAX only inside them: the worker
# processes run this file without it)
# ---------------------------------------------------------------------------

def _pkgs():
    from paddle_tpu import native as jnative
    from paddle_tpu import stats as jstats
    from paddle_tpu.serving import router as jrouter
    from paddle_tpu_torch import native as pnative
    from paddle_tpu_torch import stats as pstats
    from paddle_tpu_torch.serving import router as prouter
    return {"jax": (jrouter, jstats, jnative),
            "port": (prouter, pstats, pnative)}


def test_placement_script_equal():
    """The JAX tests' placement scripts (least-outstanding, role-aware
    with the handoff phase, handoff-failed re-placement) through both
    routers: the same assignments and byte-equal stores."""
    got = {}
    for name, (rt, st, nat) in _pkgs().items():
        st.reset("serve/")
        out = {}
        store = _Store()
        router = rt.Router(store=store)
        router.directory.announce("a", {})
        router.directory.announce("b", {})
        router.directory.alive = lambda rid, dead_after=0: True
        ids = [router.submit([1, 2, 3], max_new_tokens=2)
               for _ in range(4)]
        out["first"] = [router._assigned[q] for q in ids]
        for q in ids[::2]:
            rt._publish(store, "a", q, {"id": q, "tokens": [],
                                        "status": "done", "error": None,
                                        "replica": "a"})
        out["fresh"] = sorted(router.poll())
        more = [router.submit([1, 2, 3], max_new_tokens=2)
                for _ in range(2)]
        out["more"] = [router._assigned[q] for q in more]
        out["kv1"] = dict(store.kv)
        # role-aware placement and the handoff phase
        store = _Store()
        router = rt.Router(store=store)
        d = router.directory
        for rid, role, mb in (("p0", "prefill", 512), ("p1", "prefill", 128),
                              ("d0", "decode", 512), ("d1", "decode", 512)):
            d.announce(rid, {"role": role, "page": 128, "max_bucket": mb})
        router.directory.alive = lambda rid, dead_after=0: True
        d.heartbeat("p0", load={"role": "prefill", "queued": 5})
        d.heartbeat("p1", load={"role": "prefill", "queued": 0})
        d.heartbeat("d0", load={"role": "decode", "kv_bytes": 999,
                                "free_pages": 10})
        d.heartbeat("d1", load={"role": "decode", "kv_bytes": 1,
                                "free_pages": 40})
        q_short = router.submit([1] * 50, max_new_tokens=4)
        q_long = router.submit([1] * 200, max_new_tokens=4)
        out["roles"] = [router._assigned[q_short], router._assigned[q_long],
                        router._phase[q_short]]
        rt._publish(store, "p1", q_short, {
            "id": q_short, "tokens": [], "status": "prefill-done",
            "error": None, "replica": "p1"})
        router.poll()
        out["handoff"] = [router._phase[q_short], router._assigned[q_short]]
        # the decode replica cannot fetch: re-placed, not terminal
        rt._publish(store, "d1", q_short, {
            "id": q_short, "tokens": [], "status": "handoff-failed",
            "error": "meta timed out", "replica": "d1"})
        router.poll()
        out["retry"] = [q_short in router.results,
                        router._assigned[q_short]]
        router.directory.alive = \
            lambda rid, dead_after=0: rid.startswith("d")
        q_fb = router.submit([1] * 50, max_new_tokens=4)
        out["fallback"] = [router._assigned[q_fb], router._phase[q_fb]]
        n = nat.decode_counter(store.get("serve/mbox_n/d0"))
        out["msg"] = json.loads(store.get(f"serve/mbox/d0/{n}"))
        out["kv2"] = dict(store.kv)
        out["stats"] = st.snapshot("serve/router")
        got[name] = out
    assert got["port"] == got["jax"]
    rec = got["port"]
    assert rec["first"] == ["a", "b", "a", "b"] and rec["more"] == ["a", "a"]
    assert rec["roles"] == ["p1", "p0", "prefill"]
    assert rec["handoff"] == ["decode", "d1"]
    assert rec["retry"] == [False, "p1"]
    assert rec["fallback"] == ["d0", "serve"]


def _jax_model(state):
    import jax.numpy as jnp
    from paddle_tpu.models import gpt as jgpt
    jm = jgpt.GPT(jgpt.GPTConfig(dtype=jnp.float32, **FIELDS), seed=0)
    jm.set_state_dict({k: jnp.asarray(v) for k, v in state.items()})
    return jm


def test_jax_router_drives_port_replicas(monkeypatch):
    """A JAX ``Router`` places on two port ``serve_replica`` threads
    (single-dispatch paged engines behind ``FrontEnd``): both serve, and
    every stream equals direct serving."""
    from paddle_tpu.serving.router import Router as JaxRouter
    from paddle_tpu_torch.serving import FrontEnd, serve_replica
    monkeypatch.setenv("PT_KV_TRANSPORT", "store")
    model, _ = port_model()
    ps = prompts()
    ref = direct(model, ps)
    store = _Store()
    router = JaxRouter(store=store, dead_after=WAIT_S)
    ts = [_thread(serve_replica, store, f"rep{i}",
                  FrontEnd(port_engine(model)), max_idle_s=WAIT_S)
          for i in range(2)]
    try:
        router.wait_replicas(2, timeout=WAIT_S)
        ids = [router.submit(p, max_new_tokens=NEW) for p in ps]
        res = _drain(router, len(ids))
    finally:
        _stop(router, ts)
    assert [res[q]["tokens"] for q in ids] == ref
    assert {res[q]["status"] for q in ids} == {"done"}
    assert {res[q]["replica"] for q in ids} == {"rep0", "rep1"}
    assert not any(t.err for t in ts)


def test_port_router_drives_jax_replicas(monkeypatch):
    """A port ``Router`` places on two JAX ``serve_replica`` threads
    (``PagedDecodeEngine(mega=False)`` behind the JAX ``FrontEnd``): every
    stream equals the port's direct serving, the same weights."""
    from paddle_tpu.inference.paged_engine import PagedDecodeEngine
    from paddle_tpu.serving import FrontEnd as JaxFrontEnd
    from paddle_tpu.serving.router import serve_replica as jax_serve
    from paddle_tpu_torch.serving import Router
    monkeypatch.setenv("PT_KV_TRANSPORT", "store")
    model, state = port_model()
    jm = _jax_model(state)
    ps = prompts(lengths=(5, 40, 9, 30))
    ref = direct(model, ps)
    store = _Store()
    router = Router(store=store, dead_after=WAIT_S)
    ts = [_thread(jax_serve, store, f"jrep{i}", JaxFrontEnd(
              PagedDecodeEngine(jm, n_pages=PAGES, max_slots=SLOTS,
                                mega=False)), max_idle_s=WAIT_S)
          for i in range(2)]
    try:
        router.wait_replicas(2, timeout=WAIT_S)
        ids = [router.submit(p, max_new_tokens=NEW) for p in ps]
        res = _drain(router, len(ids))
    finally:
        _stop(router, ts)
    assert [res[q]["tokens"] for q in ids] == ref
    assert {res[q]["replica"] for q in ids} == {"jrep0", "jrep1"}
    assert not any(t.err for t in ts)


def test_replica_thread_death_redistributes(monkeypatch):
    """The victim serves alone until it holds every request mid-decode,
    then a ``raise`` at ``serve.loop`` ends its loop (it stops
    heartbeating). The survivor, started after, gets every request
    through the death sweep: each id once, streams equal direct."""
    from paddle_tpu_torch import stats
    from paddle_tpu_torch.serving import FrontEnd, Router, serve_replica
    from paddle_tpu_torch.testing import faults
    monkeypatch.setenv("PT_KV_TRANSPORT", "store")
    model, _ = port_model()
    ps = prompts()
    ref = direct(model, ps)
    stats.reset("serve/router")
    store = _Store()
    router = Router(store=store, dead_after=0.5)
    fe = FrontEnd(port_engine(model))
    victim = _thread(serve_replica, store, "victim", fe,
                     max_idle_s=WAIT_S)
    survivor = None
    try:
        router.wait_replicas(1, timeout=WAIT_S)
        ids = [router.submit(p, max_new_tokens=NEW) for p in ps]
        _until(lambda: len(fe._all) == len(ps), what="victim admission")
        with faults.inject("serve.loop", "raise", exc="RuntimeError",
                           count=1):
            victim.join(WAIT_S)
        assert isinstance(victim.err[0], RuntimeError)
        assert router.poll() == {}          # nothing published
        survivor = _thread(serve_replica, store, "survivor",
                           FrontEnd(port_engine(model)),
                           max_idle_s=WAIT_S)
        res = _drain(router, len(ids))
    finally:
        _stop(router, [survivor] if survivor else [])
    assert sorted(res) == sorted(ids)
    assert [res[q]["tokens"] for q in ids] == ref
    assert {res[q]["replica"] for q in ids} == {"survivor"}
    # at least the victim's four (a loaded host may also stall the
    # survivor's heartbeat past dead_after: at-least-once re-places)
    assert stats.get("serve/router_redistributed") >= len(ids)


def test_drain_migration_keeps_streams(monkeypatch):
    """A replica marked draining mid-decode migrates its open requests
    (KV rows and token history over the fp32 wire) to the survivor:
    every stream equals uninterrupted serving, the victim ends
    ``drained``."""
    from paddle_tpu_torch import stats
    from paddle_tpu_torch.serving import FrontEnd, Router, serve_replica
    monkeypatch.setenv("PT_KV_TRANSPORT", "store")
    model, _ = port_model()
    ps = prompts(seed=3)
    new = 24
    ref = direct(model, ps, new=new)
    stats.reset("serve/")
    store = _Store()
    router = Router(store=store, dead_after=WAIT_S)
    slow = FrontEnd(port_engine(model))
    step = slow.step

    def slow_step():                        # keep the victim mid-decode
        time.sleep(0.03)
        return step()
    slow.step = slow_step
    ts = [_thread(serve_replica, store, "victim", slow, max_idle_s=WAIT_S,
                  load_refresh_s=0.05)]
    try:
        router.wait_replicas(1, timeout=WAIT_S)
        ids = [router.submit(p, max_new_tokens=new) for p in ps]
        ts.append(_thread(serve_replica, store, "survivor",
                          FrontEnd(port_engine(model)), max_idle_s=WAIT_S))
        router.wait_replicas(2, timeout=WAIT_S)
        _until(lambda: any(r.tokens for r in slow._all), what="decode")
        router.mark_draining("victim")
        res = _drain(router, len(ids))
        _until(lambda: router.directory.state("victim") == "drained",
               what="drained")
    finally:
        _stop(router, ts)
    assert [res[q]["tokens"] for q in ids] == ref
    assert stats.get("serve/drain_migrated") >= 1
    assert stats.get("serve/router_migrated") >= 1
    assert "survivor" in {res[q]["replica"] for q in ids}


def test_link_session_and_journal_equal(tmp_path):
    """``RouterLink`` partition -> heal, ``ReplicaSession`` buffering
    through a partition, duplicate replays answered from retained
    results, a partition that cannot un-drain, and a journal-recovered
    router generation: the same states, stores and journals in both."""
    got = {}
    for name, (rt, st, nat) in _pkgs().items():
        res = rt.resilience
        st.reset()
        out = {}
        fake = _Store()
        link = rt.RouterLink(res.GuardedStore(fake, retry_s=0.2),
                             endpoint_file=None)
        states = [link.check(min_interval_s=0.0)]
        fake.fail = True
        states += [link.check(min_interval_s=0.0),
                   link.check(min_interval_s=0.0)]
        fake.fail = False
        states += [link.check(min_interval_s=0.0),
                   link.check(min_interval_s=0.0)]
        assert link.check(min_interval_s=10.0) == "ok"
        out["link"] = states
        fake = _Store()
        sess = rt.ReplicaSession(res.GuardedStore(fake, retry_s=0.2),
                                 "rep0", {"dc": "dc0"})
        sess.announce()
        fake.fail = True
        sess.publish("rq-1", {"status": "ok", "tokens": [1]})
        sess.publish("rq-2", {"status": "ok", "tokens": [2]})
        out["pending"] = sorted(sess._pending)
        sess.heartbeat(load={"outstanding": 0})
        out["mbox_partitioned"] = sess.pump_mailbox()
        fake.fail = False
        out["heal"] = [sess.maintain(), sorted(sess._pending)]
        fake.kv["serve/mbox/rep0/1"] = json.dumps({"id": "rq-1"}).encode()
        fake.kv["serve/mbox/rep0/2"] = json.dumps({"id": "rq-9"}).encode()
        fake.kv["serve/mbox_n/rep0"] = b"2"
        out["mbox"] = [m["id"] for m in sess.pump_mailbox()]
        sess.set_state("draining")
        fake.fail = True
        sess.link.note_partition()
        out["lifecycle"] = sess.lifecycle()
        fake.fail = False
        out["kv"] = dict(fake.kv)
        # journal: three submits, one result, then a fresh generation
        path = str(tmp_path / f"{name}.jsonl")
        store = _Store()
        r1 = rt.Router(store=store, journal=path)
        r1.directory.announce("a", {})
        r1.directory.alive = lambda rid, dead_after=0: True
        ids = [r1.submit([1, 2, i], max_new_tokens=2) for i in range(3)]
        rt._publish(store, "a", ids[1], {"id": ids[1], "tokens": [5],
                                         "status": "done", "error": None,
                                         "replica": "a"})
        r1.poll()
        r1.close()
        r2 = rt.Router(store=_Store(), journal=path)
        out["recover"] = [r2.recover(), sorted(r2._unplaced),
                          sorted(r2.results), r2._seq]
        r2.close()
        out["journal"] = open(path).read()
        out["stats"] = sorted(st.snapshot("serve/"))
        got[name] = out
    assert got["port"] == got["jax"]
    rec = got["port"]
    assert rec["link"] == ["ok", "partitioned", "partitioned", "healed",
                           "ok"]
    assert rec["heal"] == ["healed", []] and rec["mbox"] == ["rq-9"]
    assert rec["lifecycle"] == "draining"
    assert rec["recover"][0] == 2 and rec["recover"][3] == 3


def test_new_generation_republish(tmp_path):
    """Router failover at the session layer (port; the successor is a
    ``native.TCPStore``): a new endpoint-file generation re-announces,
    resets the mailbox cursor and republishes every retained result on
    the successor."""
    from paddle_tpu_torch import native
    from paddle_tpu_torch.distributed import resilience
    from paddle_tpu_torch.serving import router as rt
    ep = str(tmp_path / "router.ep")
    assert rt.read_endpoint_file(ep) is None
    fake = _Store()
    sess = rt.ReplicaSession(resilience.GuardedStore(fake), "rep0",
                             {"role": "decode"}, endpoint_file=ep)
    sess.announce()
    sess.publish("rq-1", {"status": "ok", "tokens": [5]})
    fake.kv["serve/mbox/rep0/1"] = json.dumps({"id": "rq-1"}).encode()
    fake.kv["serve/mbox_n/rep0"] = b"1"
    sess.pump_mailbox()
    assert sess.seen == 1
    successor = native.TCPStore("127.0.0.1", 0, is_master=True)
    try:
        rt.write_endpoint_file(ep, "127.0.0.1", successor.port, gen=1)
        assert rt.read_endpoint_file(ep)["gen"] == 1
        assert sess.maintain() == "reconnected"
        assert sess.seen == 0 and sess.link.generation == 1
        assert json.loads(successor.get("serve/meta/rep0", timeout=2.0)) \
            == {"role": "decode"}
        assert json.loads(successor.get("serve/done/rq-1", timeout=2.0)) \
            == {"status": "ok", "tokens": [5]}
    finally:
        successor.close()


def test_disaggregated_round_trip_and_fleet_hit(monkeypatch):
    """One ``serve_prefill_replica`` (prefill-only engine) and one
    ``serve_decode_replica`` (``FrontEnd`` over a paged engine with a
    ``FleetPrefixDirectory``), fp32 wire: every request goes prefill ->
    handoff -> decode with its stream equal to direct serving. Then a
    prompt sharing the first two full pages of a served one: the pages
    the decode replica published make the router's fleet consult skip
    the prefill tier, and the decode replica prefills only the suffix."""
    from paddle_tpu_torch import stats
    from paddle_tpu_torch.serving import (FrontEnd, Router,
                                          serve_decode_replica,
                                          serve_prefill_replica)
    from paddle_tpu_torch.serving.disagg import FleetPrefixDirectory
    monkeypatch.setenv("PT_KV_TRANSPORT", "store")
    monkeypatch.setenv("PT_KV_WIRE", "fp32")
    model, _ = port_model()
    ps = prompts(lengths=(9, 40, 140, 300))
    hit = ps[3][:256] + prompts(seed=9, lengths=(40,))[0]
    ref = direct(model, ps + [hit])
    stats.reset("serve/")
    store = _Store()
    router = Router(store=store, dead_after=WAIT_S)
    pf = port_engine(model, prefill_only=True)
    dec = port_engine(model)
    dec.attach_fleet(FleetPrefixDirectory(store, "dc0", wire="fp32"))
    ts = [_thread(serve_prefill_replica, store, "pf0", pf,
                  max_idle_s=WAIT_S),
          _thread(serve_decode_replica, store, "dc0", FrontEnd(dec),
                  max_idle_s=WAIT_S)]
    try:
        router.wait_replicas(2, timeout=WAIT_S)
        ids = [router.submit(p, max_new_tokens=NEW) for p in ps]
        res = _drain(router, len(ids))
        handoffs = stats.get("serve/router_prefill_handoffs")
        q = router.submit(hit, max_new_tokens=NEW)
        res = _drain(router, len(ids) + 1)
    finally:
        _stop(router, ts)
    assert [res[i]["tokens"] for i in ids + [q]] == ref
    assert {res[i]["replica"] for i in ids + [q]} == {"dc0"}
    assert handoffs == len(ids)
    assert stats.get("serve/router_prefill_skipped") == 1
    assert stats.get("serve/router_prefill_handoffs") == len(ids)
    assert stats.get("serve/dispatches/prefill_suffix") == 1
    assert stats.get("serve/prefix_hit_tokens") == 256
    assert not any(t.err for t in ts)


def test_replica_processes_sigkill_zero_loss():
    """Two port replica processes (this file as a script) on a
    ``native.TCPStore`` the router hosts; one is SIGKILLed once it has
    published a result. Every id comes back once, done, its stream equal
    to direct serving; the death sweep redistributed at least one."""
    from paddle_tpu_torch import stats
    from paddle_tpu_torch.serving import Router
    model, _ = port_model()
    ps = prompts(seed=5, lengths=(5, 40, 130, 170, 20, 60))
    # placement alternates proc0, proc1: each gets one short request
    # (its first result) and two long ones, still decoding at the kill
    news = [8, 8, 64, 64, 64, 64]
    ref = direct(model, ps, new=news)
    stats.reset("serve/router")
    router = Router(port=0, dead_after=2.0)
    env = dict(os.environ, PYTHONPATH=ROOT, PT_KV_TRANSPORT="store")
    procs = [subprocess.Popen(
        [sys.executable, HERE, str(router.store.port), f"proc{i}"],
        env=env, cwd=ROOT, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE) for i in range(2)]
    try:
        router.wait_replicas(2, timeout=WAIT_S)
        ids = [router.submit(p, max_new_tokens=n)
               for p, n in zip(ps, news)]
        victim = "proc0"
        assert [router._assigned[q] for q in ids[:2]] == ["proc0", "proc1"]

        def victim_published():
            router.poll()
            return any(r.get("replica") == victim
                       for r in router.results.values())
        _until(victim_published, what="the victim's first result")
        os.kill(router.directory.members()[victim]["pid"], signal.SIGKILL)
        res = router.drain(timeout=WAIT_S)
    finally:
        router.shutdown()
        for p in procs:
            try:
                p.wait(timeout=WAIT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)
        router.close()
    assert sorted(res) == sorted(ids)
    assert [res[q]["tokens"] for q in ids] == ref
    assert {res[q]["status"] for q in ids} == {"done"}
    assert stats.get("serve/router_redistributed") >= 1
    assert procs[0].returncode == -signal.SIGKILL


def _replica_main(port, rid):
    """A replica process: the tiny model from seed 0, one paged engine
    behind ``FrontEnd``, ``serve_replica`` until the router's shutdown
    (or WAIT_S idle)."""
    torch.set_num_threads(1)
    from paddle_tpu_torch import native
    from paddle_tpu_torch.serving import FrontEnd, serve_replica
    model, _ = port_model()
    store = native.TCPStore("127.0.0.1", port)
    serve_replica(store, rid, FrontEnd(port_engine(model)),
                  max_idle_s=WAIT_S)


if __name__ == "__main__":
    _replica_main(int(sys.argv[1]), sys.argv[2])
