"""Multi-replica request router over store membership (counterpart of
``paddle_tpu/serving/router.py``).

One serving *replica* = one process (spawned by any orchestrator; the
port has no launch CLI yet, so ``subprocess.Popen([sys.executable,
...])``) running a decode engine behind a
:class:`~paddle_tpu_torch.serving.scheduler.FrontEnd` and
:func:`serve_replica` (or the role loops of ``serving/disagg.py``). The
:class:`Router` lives in the API-facing process, hosts the store control
plane (``PT_SERVE_ROUTER_PORT``), and places requests **role- and
load-aware**: a symmetric fleet keeps least-outstanding-requests
placement; a disaggregated fleet (replicas announcing ``role``
prefill/decode) places the prefill phase by queue depth + bucket fit,
moves each ``prefill-done`` handoff to the decode replica with the least
outstanding KV bytes / most free pages, consults the fleet prefix
directory BEFORE placement (full coverage skips the prefill tier
entirely), and degrades to symmetric placement when a role tier dies.
Load gauges ride the replicas' heartbeats — one store read per replica
per poll, never a per-request round trip.

Wire protocol (all JSON on the shared store; the store lives in the
router process, so results survive any replica's death), key for key
the JAX module's, so a router of either package drives replicas of the
other:

- mailbox: router bumps ``serve/mbox_n/<rid>`` and writes
  ``serve/mbox/<rid>/<i>``; the replica consumes indices it hasn't
  seen. Append-only + monotonic counters — no delete/list ops needed.
- results: replica writes ``serve/done/<req_id>`` once the request is
  terminal (tokens or error) and appends it to its done index; the
  router polls one counter per replica.
- membership: ``distributed/membership.ReplicaDirectory`` (announce +
  counter heartbeats). A replica whose heartbeat stalls is dead; every
  outstanding request assigned to it is **redistributed** to the
  least-loaded survivor (``serve/router_redistributed``). A request the
  dead replica already finished is not re-sent (its done key persists);
  a request it was mid-decode on re-executes elsewhere — at-least-once,
  first result wins, so no request id is ever lost.
"""

import json
import os
import time
from collections import OrderedDict
from typing import Dict, List, Optional

from paddle_tpu_torch.distributed import resilience
from paddle_tpu_torch.distributed.liveness import ProgressJudge
from paddle_tpu_torch.distributed.membership import ReplicaDirectory

__all__ = ["Router", "serve_replica", "router_port", "RouterLink",
           "ReplicaSession", "write_endpoint_file", "read_endpoint_file"]


def router_port() -> int:
    """The router control-plane TCPStore port
    (``PT_SERVE_ROUTER_PORT``)."""
    return int(os.environ.get("PT_SERVE_ROUTER_PORT", "8997"))


# ---------------------------------------------------------------------------
# Router failover plumbing
# ---------------------------------------------------------------------------

_ROUTER_HB_KEY = "serve/router_hb"


def write_endpoint_file(path: str, host: str, port: int, gen: int,
                        pid: Optional[int] = None):
    """Atomically publish a router generation's store endpoint:
    ``{"host", "port", "gen", "pid"}`` via tmp-file + rename, so a
    replica polling the file never reads a torn record. Each new
    router generation writes ``gen = prior + 1``."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({"host": host, "port": int(port), "gen": int(gen),
                   "pid": int(pid if pid is not None else os.getpid())},
                  f)
    os.replace(tmp, path)


def read_endpoint_file(path: Optional[str]) -> Optional[dict]:
    """The current endpoint record, or None (absent / torn / no path)."""
    if not path:
        return None
    try:
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


class RouterLink:
    """A replica's view of the control plane ACROSS router generations.

    Wraps the store connection in a `resilience.GuardedStore` and runs
    the reconnect state machine:

    - router liveness is judged on the ``serve/router_hb`` counter the
      router bumps every poll, through the shared
      `liveness.ProgressJudge` — counter progress vs THIS process's
      monotonic clock, never a wall clock;
    - a failed/stuck store op flips the link ``partitioned``
      (`note_partition`); while partitioned the serve loops skip
      control-plane IO, buffer results, and keep decoding;
    - :meth:`check` (throttled) watches the endpoint file for a new
      router generation — on one it dials the fresh store and swaps it
      into the GuardedStore (``reconnected``); otherwise it probes the
      current store (``healed`` when a same-generation partition
      clears).
    """

    def __init__(self, store, endpoint_file: Optional[str] = None,
                 router_dead_after: float = 5.0):
        self.store = store if isinstance(store, resilience.GuardedStore) \
            else resilience.GuardedStore(store)
        self.endpoint_file = endpoint_file if endpoint_file is not None \
            else (os.environ.get("PT_ROUTER_ENDPOINT_FILE") or None)
        ep = read_endpoint_file(self.endpoint_file)
        self.generation = int(ep["gen"]) if ep else 0
        self.router_dead_after = float(router_dead_after)
        self.partitioned = False
        self._judge = ProgressJudge()
        self._last_check = 0.0

    def note_partition(self, err=None):
        """A store op just failed its whole retry budget: enter
        partition mode (flight-recorded once per transition)."""
        if not self.partitioned:
            from paddle_tpu_torch import stats
            from paddle_tpu_torch.observability import flight
            stats.add("serve/link_partitions")
            flight.record("link", "partition",
                          gen=self.generation,
                          error=(str(err) if err else None))
        self.partitioned = True

    def router_alive(self) -> bool:
        """True while the router's liveness counter keeps progressing
        (fed by :meth:`check`'s probes)."""
        if not self._judge.has("router"):
            return False
        stalled = self._judge.stalled_for("router")
        return stalled is not None and stalled <= self.router_dead_after

    def _fresh_endpoint(self) -> Optional[dict]:
        ep = read_endpoint_file(self.endpoint_file)
        if ep and int(ep.get("gen", 0)) > self.generation:
            return ep
        return None

    def _reconnect(self, ep: dict) -> str:
        from paddle_tpu_torch import native, stats
        from paddle_tpu_torch.observability import flight
        try:
            raw = native.TCPStore(ep["host"], int(ep["port"]),
                                  is_master=False)
        except (ConnectionError, OSError, RuntimeError):
            # endpoint published but not accepting yet (standby still
            # binding): stay in the current state, retry next check
            return "partitioned" if self.partitioned else "ok"
        self.store.swap(raw)
        self.generation = int(ep["gen"])
        self.partitioned = False
        self._judge.forget("router")
        stats.add("serve/link_reconnects")
        flight.record("link", "reconnect", gen=self.generation)
        return "reconnected"

    def check(self, min_interval_s: float = 0.25) -> str:
        """Advance the state machine (call once per loop iteration;
        internally throttled). Returns ``ok`` | ``partitioned`` |
        ``healed`` | ``reconnected`` — the two transition states fire
        exactly once so the caller can run its recovery actions."""
        now = time.monotonic()
        if now - self._last_check < min_interval_s:
            return "partitioned" if self.partitioned else "ok"
        self._last_check = now
        ep = self._fresh_endpoint()
        if ep is not None:
            st = self._reconnect(ep)
            if st == "reconnected":
                return st
        val = self.store.probe(_ROUTER_HB_KEY)
        if val is None:
            self.note_partition()
            return "partitioned"
        self._judge.update("router", val, now=now)
        if self.partitioned:
            from paddle_tpu_torch import stats
            from paddle_tpu_torch.observability import flight
            self.partitioned = False
            stats.add("serve/link_heals")
            flight.record("link", "heal", gen=self.generation)
            return "healed"
        return "ok"


class ReplicaSession:
    """Shared replica-side control-plane state for the three serve
    loops (`serve_replica` + the disagg role loops): guarded store IO
    that degrades instead of raising, the reconnect recovery actions,
    a bounded flight-recorded result buffer, and (optionally) this
    replica's socket KV transport endpoint.

    Partition contract: every method that touches the
    store catches `resilience.StorePartitioned`, flips the link into
    partition mode, and returns something inert — a store blip costs
    missed heartbeats and buffered results, never replica suicide, and
    in-flight decode keeps stepping.

    Reconnect contract: on a new router generation the
    session re-announces membership + lifecycle state, restarts the
    mailbox cursor at zero, re-publishes every RETAINED terminal result
    (the new router answers journal-recovered ids from them —
    first-result-wins), and re-publishes fleet prefix pages via the
    engine's ``fleet_republish`` hook.
    """

    RESULT_RETAIN = 256

    def __init__(self, store, rid: str, meta: dict, transport=None,
                 endpoint_file: Optional[str] = None, engine=None,
                 fleet=None):
        self.link = store if isinstance(store, RouterLink) \
            else RouterLink(store, endpoint_file=endpoint_file)
        self.store = self.link.store
        self.rid = rid
        self.meta = dict(meta)
        self.transport = transport
        if transport is not None:
            self.meta["kv_ep"] = list(transport.locator())
        self.engine = engine
        self.fleet = fleet
        if fleet is not None:
            # route the prefix directory through the SAME guarded store
            # client: its ops degrade on partition and automatically
            # follow swap() to the next router generation's endpoint
            fleet.store = self.store
        self.directory = ReplicaDirectory(self.store)
        self.seen = 0
        self.state = "up"               # local lifecycle mirror
        self._results: "OrderedDict[str, dict]" = OrderedDict()
        self._pending: Dict[str, dict] = {}   # buffered during partition

    @property
    def partitioned(self) -> bool:
        return self.link.partitioned

    def close(self):
        if self.transport is not None:
            self.transport.close()

    # -- control-plane IO (degrading) -----------------------------------

    def announce(self):
        self.directory.announce(self.rid, self.meta)

    def heartbeat(self, load: Optional[dict] = None,
                  stats_export: Optional[dict] = None):
        if self.link.partitioned:
            return
        try:
            self.directory.heartbeat(self.rid, load=load,
                                     stats=stats_export)
        except resilience.StorePartitioned as e:
            self.link.note_partition(e)

    def lifecycle(self) -> str:
        """The directory's lifecycle state for this replica (the local
        mirror while partitioned — a partition must not un-drain)."""
        if self.link.partitioned:
            return self.state
        try:
            s = self.directory.state(self.rid)
        except resilience.StorePartitioned as e:
            self.link.note_partition(e)
            return self.state
        if s != "up" or self.state == "up":
            self.state = s
        return self.state

    def set_state(self, state: str):
        self.state = state
        if self.link.partitioned:
            return
        try:
            self.directory.set_state(self.rid, state)
        except resilience.StorePartitioned as e:
            self.link.note_partition(e)

    def shutdown_requested(self) -> bool:
        if self.link.partitioned:
            return False
        try:
            return _shutdown_requested(self.store)
        except resilience.StorePartitioned as e:
            self.link.note_partition(e)
            return False

    def pump_mailbox(self) -> List[dict]:
        """Drain new mailbox messages. Duplicates of already-finished
        requests (a journal-recovered router re-placing at-least-once)
        are answered from the retained results instead of re-serving."""
        if self.link.partitioned:
            return []
        try:
            self.seen, msgs = _mailbox_pump(self.store, self.rid,
                                            self.seen)
        except resilience.StorePartitioned as e:
            self.link.note_partition(e)
            return []
        out = []
        for msg in msgs:
            req_id = msg.get("id")
            if req_id is not None and req_id in self._results:
                from paddle_tpu_torch import stats
                stats.add("serve/dup_replays_answered")
                self.publish(req_id, self._results[req_id])
                continue
            out.append(msg)
        return out

    def pump_transport(self, budget: int = 8):
        if self.transport is not None:
            self.transport.pump(budget)

    # -- results (buffered through partitions) --------------------------

    def publish(self, req_id: str, result: dict, terminal: bool = True):
        """Publish a result; a partition buffers it (bounded,
        flight-recorded) for the flush on heal/reconnect. ``terminal``
        results are additionally RETAINED for duplicate-replay answers
        and re-publication to a new router generation."""
        if terminal:
            self._results[req_id] = result
            self._results.move_to_end(req_id)
            while len(self._results) > self.RESULT_RETAIN:
                old, _ = self._results.popitem(last=False)
                self._pending.pop(old, None)
        if self.link.partitioned:
            self._buffer(req_id, result)
            return
        try:
            _publish(self.store, self.rid, req_id, result)
            self._pending.pop(req_id, None)
        except resilience.StorePartitioned as e:
            self.link.note_partition(e)
            self._buffer(req_id, result)

    def _buffer(self, req_id: str, result: dict):
        from paddle_tpu_torch import stats
        from paddle_tpu_torch.observability import flight
        self._pending[req_id] = result
        stats.add("serve/results_buffered")
        flight.record(req_id, "result-buffered", replica=self.rid,
                      pending=len(self._pending))

    # -- the per-iteration state pump -----------------------------------

    def maintain(self) -> str:
        """Advance the link state machine and run the matching recovery
        actions; returns the link status for the loop's bookkeeping."""
        st = self.link.check()
        if st == "reconnected":
            self._recover(new_generation=True)
        elif st == "healed":
            self._recover(new_generation=False)
        return st

    def _recover(self, new_generation: bool):
        from paddle_tpu_torch import stats
        from paddle_tpu_torch.observability import flight
        try:
            if new_generation:
                # fresh store: re-announce membership + lifecycle,
                # restart the mailbox cursor, drop stale TRANSIENT
                # buffered statuses (the new router re-places journaled
                # outstanding work from scratch anyway), and republish
                # every retained terminal result + the prefix pages
                self.seen = 0
                self.directory.announce(self.rid, self.meta)
                if self.state != "up":
                    self.directory.set_state(self.rid, self.state)
                self._pending = {q: r for q, r in self._pending.items()
                                 if q in self._results}
                republish = dict(self._results)
                republish.update(self._pending)
                if self.fleet is not None:
                    try:
                        self.fleet.reset_published()
                    except Exception:
                        pass
                if self.engine is not None and hasattr(
                        self.engine, "fleet_republish"):
                    try:
                        self.engine.fleet_republish()
                    except Exception:
                        pass
            else:
                republish = dict(self._pending)
            n = 0
            for req_id, res in republish.items():
                _publish(self.store, self.rid, req_id, res)
                self._pending.pop(req_id, None)
                n += 1
            if n:
                stats.add("serve/results_republished", n)
            flight.record(self.rid, "link-recovered",
                          new_generation=new_generation, republished=n,
                          gen=self.link.generation)
        except resilience.StorePartitioned as e:
            self.link.note_partition(e)


class Router:
    """Client-side router: owns the store, places requests, accounts
    for every request id until a result lands.

        router = Router()                  # hosts the store
        ... spawn replica processes (they connect back) ...
        rid = router.wait_replicas(2)
        req_id = router.submit(prompt, max_new_tokens=16)
        results = router.drain(timeout=60)  # req_id -> result dict
    """

    def __init__(self, store=None, host: str = "127.0.0.1",
                 port: Optional[int] = None, dead_after: float = 2.0,
                 endpoint_file: Optional[str] = None,
                 journal=None):
        if store is None:
            from paddle_tpu_torch import native
            store = native.TCPStore(
                host, port if port is not None else router_port(),
                is_master=True)
            self._owns_store = True
        else:
            self._owns_store = False
        # every router store op rides the ONE shared deadline-guarded
        # helper (GuardedStore): transient transport errors retry with
        # backoff, a dead store surfaces as StorePartitioned instead of
        # a raw socket error deep inside poll()
        self.store = resilience.GuardedStore(store)
        # failover plumbing: the endpoint file
        # advertises THIS generation's store to reconnecting replicas;
        # the journal makes the intake reconstructible (recover())
        self.endpoint_file = endpoint_file if endpoint_file is not None \
            else (os.environ.get("PT_ROUTER_ENDPOINT_FILE") or None)
        self.generation = 1
        if self.endpoint_file and self._owns_store:
            prior = read_endpoint_file(self.endpoint_file)
            self.generation = (int(prior["gen"]) if prior else 0) + 1
            write_endpoint_file(self.endpoint_file, host=host,
                                port=self.store.port,
                                gen=self.generation)
        self.journal = None
        if journal is not None:
            from paddle_tpu_torch.serving.scheduler import RequestJournal
            self.journal = journal if isinstance(journal, RequestJournal) \
                else RequestJournal(journal)
        self.directory = ReplicaDirectory(self.store)
        self.dead_after = float(dead_after)
        self._seq = 0
        self._payload: Dict[str, dict] = {}      # req_id -> request json
        self._assigned: Dict[str, str] = {}      # req_id -> replica id
        self._outstanding: Dict[str, int] = {}   # rid -> open requests
        self.results: Dict[str, dict] = {}       # req_id -> result json
        self._done_cursor: Dict[str, int] = {}   # rid -> done idx read
        # replicas whose current death has already been swept — NOT a
        # permanent blacklist: a false-positive death (heartbeat stalled
        # by host load, then resumed) re-earns routing eligibility the
        # moment the counter progresses again; the extra redistribution
        # is harmless (at-least-once, first result wins)
        self._swept = set()
        # disaggregated serving state: which phase each request is in
        # ('serve' = whole request on one replica; 'prefill' = awaiting
        # a prefill replica's handoff; 'decode' = handoff placed on a
        # decode replica), plus the heartbeat-refreshed load gauges
        # (one store read per replica per poll — never per request)
        self._phase: Dict[str, str] = {}
        self._loads: Dict[str, dict] = {}
        self._loads_at = 0.0
        self._t_submit: Dict[str, float] = {}    # req_id -> submit time
        # perf_counter twin of _t_submit: the serve/route span (the
        # request's client-observed window on the stitched timeline)
        # needs the tracer's clock, monotonic deadline math keeps its own
        self._t_submit_pc: Dict[str, float] = {}
        # fleet telemetry plane (observability/fleet.FleetStats):
        # enable_fleet_stats attaches it; poll() pumps it at its own
        # refresh cadence
        self.fleet_stats = None
        self._fleet_refresh_s = 1.0
        self._fleet_at = 0.0
        # requests whose RE-placement failed transiently (no capable
        # replica alive at that instant): retried on every poll —
        # a liveness blip must degrade to a delay, never crash poll()
        self._unplaced: set = set()
        self._fleet = None                       # lazy directory client
        # drain protocol (the fleet controller's): lifecycle
        # states read at most every _state_ttl_s per replica — a
        # submission burst reuses the cache instead of one store read
        # per replica per placement. mark_draining() updates the cache
        # in-process, so a controller sharing this router never races
        # its own drain decision against a stale cache entry.
        self._state_cache: Dict[str, tuple] = {}  # rid -> (state, t)
        self._state_ttl_s = 0.25
        # socket-plane handoff locators: req_id -> [host, port] of the
        # replica whose outbox holds the blob (None = store plane)
        self._kv_src: Dict[str, Optional[list]] = {}

    # -- membership ---------------------------------------------------------

    def _replica_state(self, rid: str) -> str:
        """Cached lifecycle state (drain protocol): ``up`` replicas are
        routable, ``draining``/``drained`` ones never receive a NEW
        placement (their in-flight work finishes where it is, or the
        death sweep redistributes it once they exit)."""
        now = time.monotonic()
        ent = self._state_cache.get(rid)
        if ent is None or now - ent[1] > self._state_ttl_s:
            ent = (self.directory.state(rid), now)
            self._state_cache[rid] = ent
        return ent[0]

    def mark_draining(self, rid: str):
        """Start draining ``rid``: publish the state AND update the
        local cache, so the very next placement in this process already
        excludes it (the fleet controller shares the router process —
        its drain decision must not race the cache TTL)."""
        self.directory.set_state(rid, "draining")
        self._state_cache[rid] = ("draining", time.monotonic())

    def replicas(self) -> List[str]:
        """Alive ROUTABLE replicas (draining ones excluded),
        least-outstanding first."""
        alive = [rid for rid in self.directory.members()
                 if self.directory.alive(rid, self.dead_after)
                 and self._replica_state(rid) == "up"]
        return sorted(alive,
                      key=lambda r: (self._outstanding.get(r, 0), r))

    def wait_replicas(self, n: int, timeout: float = 60.0) -> List[str]:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            got = self.replicas()
            if len(got) >= n:
                return got
            time.sleep(0.05)
        raise TimeoutError(
            f"only {len(self.replicas())}/{n} replicas announced "
            f"within {timeout}s")

    # -- failover recovery --------------------------------------------------

    def recover(self) -> int:
        """Rebuild this (fresh) router generation's state from the
        request journal: journaled submits without a terminal result
        re-enter placement (parked in ``_unplaced`` until replicas
        reconnect — poll() retries them every call); journaled results
        are final (first-result-wins across generations — a replica
        re-publishing the same id later is deduped exactly like a
        same-generation duplicate). Returns the number of outstanding
        requests re-queued. Deadline budgets restart at recovery time:
        the journal records no clocks, and a stricter restart would
        time out work the failover itself delayed."""
        from paddle_tpu_torch import stats
        from paddle_tpu_torch.observability import flight
        from paddle_tpu_torch.serving.scheduler import RequestJournal
        if self.journal is None:
            return 0
        payloads, results = RequestJournal.replay(self.journal.path)
        now = time.monotonic()
        pc = time.perf_counter()
        n_out = 0
        for req_id, payload in payloads.items():
            self._payload.setdefault(req_id, payload)
            try:
                self._seq = max(self._seq,
                                int(req_id.rsplit("-", 1)[1]))
            except (ValueError, IndexError):
                pass
            if req_id in results or req_id in self.results:
                continue
            n_out += 1
            self._t_submit.setdefault(req_id, now)
            self._t_submit_pc.setdefault(req_id, pc)
            self._phase[req_id] = "serve"   # re-place from scratch
            self._unplaced.add(req_id)
            flight.record(req_id, "journal-recover",
                          gen=self.generation)
        for req_id, res in results.items():
            self.results.setdefault(req_id, res)
        stats.add("serve/router_recovered", n_out)
        return n_out

    # -- placement ----------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int = 32,
               eos_id: Optional[int] = None,
               deadline_s: Optional[float] = None,
               priority: int = 0) -> str:
        from paddle_tpu_torch import stats
        self._seq += 1
        req_id = f"rq-{self._seq:06d}"
        self._payload[req_id] = {
            "id": req_id, "prompt": [int(t) for t in prompt],
            "max_new_tokens": int(max_new_tokens), "eos_id": eos_id,
            "deadline_s": deadline_s, "priority": int(priority)}
        # router-local submit time: every (re-)placement charges the
        # time already spent (queueing, prefill, transfer, re-routes)
        # against the request's deadline budget, matching same-replica
        # semantics where the clock starts once at submission
        self._t_submit[req_id] = time.monotonic()
        self._t_submit_pc[req_id] = time.perf_counter()
        from paddle_tpu_torch.observability import flight
        flight.record(req_id, "submit", prompt=len(prompt),
                      budget=int(max_new_tokens), deadline_s=deadline_s)
        if self.journal is not None:
            # journal BEFORE placement: an accepted id must survive a
            # router SIGKILL even if the placement write never lands
            self.journal.append_submit(self._payload[req_id])
        self._place(req_id)
        stats.add("serve/router_requests")
        return req_id

    def _remaining_deadline(self, req_id: str):
        d = self._payload[req_id].get("deadline_s")
        if d is None:
            return None
        t0 = getattr(self, "_t_submit", {}).get(req_id)
        return d if t0 is None else d - (time.monotonic() - t0)

    def _request_msg(self, req_id: str) -> dict:
        return dict(self._payload[req_id], kind="req",
                    deadline_s=self._remaining_deadline(req_id))

    def _try_place(self, req_id: str):
        """RE-placement that survives a transient no-capable-replica
        window (poll's prefill-done/handoff-failed progression and the
        death sweep land here): on failure the request parks in
        ``_unplaced`` and every subsequent poll retries, so a
        heartbeat blip delays the request instead of crashing the
        router. ``submit()`` keeps the raising ``_place`` — the API
        edge should fail loudly when there is truly no fleet."""
        try:
            self._place(req_id, wait_s=0.0)
            self._unplaced.discard(req_id)
        except RuntimeError:
            self._unplaced.add(req_id)

    # -- role-aware placement ------------------------------------------------

    def _refresh_loads(self, min_interval_s: float = 0.2):
        """One load read per known replica (the gauges ride the
        heartbeat — membership.heartbeat(load=...)), throttled to the
        replicas' own refresh cadence: a burst of submissions reuses
        the cached gauges plus this router's in-flight counts —
        requests never trigger their own store round trips."""
        now = time.monotonic()
        if now - self._loads_at < min_interval_s and self._loads:
            return
        self._loads_at = now
        for rid in self.directory.members():
            load = self.directory.load(rid)
            if load is not None:
                self._loads[rid] = load

    def _alive_meta(self) -> Dict[str, dict]:
        return {rid: m for rid, m in self.directory.members().items()
                if self.directory.alive(rid, self.dead_after)
                and self._replica_state(rid) == "up"}

    def _fleet_covered(self, prompt, page: int) -> int:
        """Pre-placement directory consult: how many leading FULL pages
        of ``prompt`` the fleet prefix directory already holds."""
        if not page:
            return 0
        from paddle_tpu_torch.inference.prefix_cache import chain_digests
        from paddle_tpu_torch.serving.disagg import (FleetPrefixDirectory,
                                               fleet_enabled)
        if not fleet_enabled():
            return 0
        if self._fleet is None:
            self._fleet = FleetPrefixDirectory(self.store, "router")
        chain = chain_digests(prompt, page)
        return self._fleet.covered(chain) * page

    def _pick_prefill(self, alive: Dict[str, dict], prompt_len: int):
        """Prefill placement: bucket fit first (the replica's largest
        bucket must cover the prompt), then least queue depth (the
        heartbeat gauge plus this router's own in-flight count)."""
        fits = [rid for rid, m in alive.items()
                if m.get("role") == "prefill"
                and prompt_len <= m.get("max_bucket", 0)]
        return min(fits, key=lambda r: (
            self._loads.get(r, {}).get("queued", 0)
            + self._outstanding.get(r, 0), r), default=None)

    def _pick_decode(self, alive: Dict[str, dict]):
        """Decode placement: least outstanding KV bytes, most free
        pages (the memory-bound axis), router in-flight as tiebreak.
        ``both``-role replicas qualify — a symmetric fleet must be
        able to receive a draining peer's mid-decode handoffs."""
        ds = [rid for rid, m in alive.items()
              if m.get("role", "both") in ("decode", "both")]
        return min(ds, key=lambda r: (
            self._loads.get(r, {}).get("kv_bytes", 0),
            -self._loads.get(r, {}).get("free_pages", 0),
            self._outstanding.get(r, 0), r), default=None)

    def _send(self, rid: str, req_id: str, msg: dict):
        from paddle_tpu_torch import stats
        from paddle_tpu_torch.observability import flight
        i = self.store.add(f"serve/mbox_n/{rid}", 1)
        self.store.set(f"serve/mbox/{rid}/{i}", json.dumps(msg))
        self._assigned[req_id] = rid
        self._outstanding[rid] = self._outstanding.get(rid, 0) + 1
        flight.record(req_id, "place", replica=rid,
                      phase=self._phase.get(req_id, "serve"),
                      kind=msg.get("kind", "req"))
        stats.set_value("serve/router_outstanding",
                        sum(self._outstanding.values()))

    def _place(self, req_id: str, wait_s: float = 2.0):
        """Phase-aware placement. A symmetric fleet (no prefill-role
        replicas) keeps the least-outstanding policy. A
        disaggregated fleet places the prefill phase on a prefill
        replica by queue depth + bucket fit, UNLESS the fleet prefix
        directory already covers the prompt's full pages — then
        prefill is skipped fleet-wide and the request goes straight to
        a decode replica (which suffix-prefills locally from fleet
        pages). Decode-phase placement (after ``prefill-done``) goes by
        outstanding KV bytes + free pages. When a needed role has no
        alive replica, the request falls back to whole-request serving
        on whatever is alive — a dead prefill tier degrades to
        symmetric serving, never to an outage."""
        deadline = time.monotonic() + wait_s
        alive = self._alive_meta()
        while not alive and time.monotonic() < deadline:
            # a transient liveness blip (or replicas still announcing)
            # must not fail a submit outright
            time.sleep(0.05)
            alive = self._alive_meta()
        if not alive:
            raise RuntimeError("no alive replicas to route to")
        payload = self._payload[req_id]
        phase = self._phase.get(req_id)
        if phase in ("prefill", "serve"):
            # re-placement (death sweep): a not-yet-handed-off request
            # restarts from scratch wherever capacity is — a dead
            # prefill replica's work re-enters the prefill pool, or
            # degrades to whole-request serving below
            phase = None
        roles = {m.get("role", "both") for m in alive.values()}
        if phase == "decode":
            rid = self._pick_decode(alive)
            if rid is not None:
                self._send(rid, req_id, {
                    "kind": "handoff", "id": req_id,
                    "deadline_s": self._remaining_deadline(req_id),
                    # socket-plane locator: where the sender's outbox
                    # holds the blob (None = chunked store fetch)
                    "kv_ep": self._kv_src.get(req_id)})
                return
            # no decode replica alive: fall through to whole-request
            # placement (the handoff blob is abandoned; at-least-once)
            phase = None
        if phase is None and "prefill" in roles and "decode" in roles:
            self._refresh_loads()
            page = max((m.get("page", 0) for m in alive.values()
                        if m.get("role") == "decode"), default=0)
            covered = self._fleet_covered(payload["prompt"], page)
            n = len(payload["prompt"])
            if covered and n - covered < (page or n):
                # every full page is fleet-warm: skip prefill entirely
                rid = self._pick_decode(alive)
                if rid is not None:
                    from paddle_tpu_torch import stats
                    stats.add("serve/router_prefill_skipped")
                    self._phase[req_id] = "serve"
                    self._send(rid, req_id, self._request_msg(req_id))
                    return
            rid = self._pick_prefill(alive, n)
            if rid is not None:
                self._phase[req_id] = "prefill"
                self._send(rid, req_id, self._request_msg(req_id))
                return
            # no fitting/alive prefill replica: serve whole on decode
            rid = self._pick_decode(alive)
            if rid is not None:
                self._phase[req_id] = "serve"
                self._send(rid, req_id, self._request_msg(req_id))
                return
        # symmetric fleet (or role fallback): least outstanding among
        # replicas that can actually SERVE a whole request — a
        # prefill-only replica would prefill and publish another
        # handoff forever (livelock) if the decode tier is down
        servers = [r for r in alive
                   if alive[r].get("role", "both") != "prefill"]
        if not servers:
            raise RuntimeError(
                "no decode-capable replica alive (prefill-only fleet)")
        self._phase[req_id] = "serve"
        rid = min(servers,
                  key=lambda r: (self._outstanding.get(r, 0), r))
        self._send(rid, req_id, self._request_msg(req_id))

    # -- completion / fault handling ----------------------------------------

    def poll(self) -> Dict[str, dict]:
        """Collect newly landed results; returns the new ones. Cost is
        one counter read per KNOWN replica (not one blocking probe per
        outstanding request): each replica appends completions to its
        done index (see ``_publish``), and the router fetches only the
        entries beyond its per-replica cursor."""
        from paddle_tpu_torch import native, stats
        from paddle_tpu_torch.observability import flight, trace
        from paddle_tpu_torch.testing import faults
        # chaos hook: PT_FAULTS="router.die:kill:after=N" drops the
        # coordinator mid-traffic — failover (endpoint file + journal
        # recovery) must preserve every request id
        faults.fire("router.die")
        # router-liveness counter: replicas' RouterLinks judge progress
        # on this (ProgressJudge) to tell a dead router from a slow one
        self.store.add(_ROUTER_HB_KEY, 1)
        fresh = {}
        for req_id in list(self._unplaced):
            if req_id not in self.results:
                self._try_place(req_id)
        for rid in self.directory.members():
            try:
                n = native.decode_counter(
                    self.store.get(f"serve/done_n/{rid}", timeout=0.02))
            except (TimeoutError, ValueError):
                continue
            cursor = self._done_cursor.get(rid, 0)
            while cursor < n:
                cursor += 1
                try:
                    req_id = self.store.get(
                        f"serve/done_idx/{rid}/{cursor}",
                        timeout=1.0).decode()
                    raw = self.store.get(f"serve/done/{req_id}",
                                         timeout=1.0)
                except TimeoutError:
                    cursor -= 1    # index mid-write; retry next poll
                    break
                if req_id in self.results or req_id not in self._payload:
                    continue       # duplicate completion / foreign key
                res = json.loads(raw)
                if res.get("status") == "handoff-failed":
                    # retryable: the decode replica could not fetch the
                    # handoff blob (prefill replica died mid-transfer).
                    # Re-place from scratch — the request re-enters the
                    # prefill pool (or whole-request serving)
                    owner = self._assigned.get(req_id)
                    if owner is not None:
                        self._outstanding[owner] = max(
                            0, self._outstanding.get(owner, 0) - 1)
                    flight.record(req_id, "handoff-failed",
                                  replica=res.get("replica"),
                                  error=res.get("error"))
                    flight.dump(req_id, "handoff-failed")
                    self._phase[req_id] = "serve"
                    self._kv_src.pop(req_id, None)   # blob unusable
                    self._try_place(req_id)
                    stats.add("serve/router_handoff_retries")
                    continue
                if res.get("status") == "migrated":
                    # NOT terminal: a draining replica handed this
                    # request off mid-flight. kv=True carries device
                    # state (place the handoff blob on a decode-capable
                    # survivor); kv=False was still queued there
                    # (re-place from scratch). Either way the id stays
                    # accounted until a real result lands.
                    owner = self._assigned.get(req_id)
                    if owner is not None:
                        self._outstanding[owner] = max(
                            0, self._outstanding.get(owner, 0) - 1)
                    flight.record(req_id, "migrate",
                                  replica=res.get("replica"),
                                  kv=bool(res.get("kv")))
                    self._phase[req_id] = (
                        "decode" if res.get("kv") else "serve")
                    if res.get("kv"):
                        self._kv_src[req_id] = res.get("kv_ep")
                    self._refresh_loads()
                    self._try_place(req_id)
                    stats.add("serve/router_migrated")
                    continue
                if res.get("status") == "prefill-done":
                    # NOT terminal: the prefill replica published the
                    # KV handoff blob — place the decode phase on a
                    # decode replica (by outstanding KV bytes + free
                    # pages). Duplicate prefill-done entries (a death
                    # sweep re-ran the prefill elsewhere) re-place the
                    # decode phase; at-least-once, first final result
                    # wins.
                    owner = self._assigned.get(req_id)
                    if owner is not None:
                        self._outstanding[owner] = max(
                            0, self._outstanding.get(owner, 0) - 1)
                    self._phase[req_id] = "decode"
                    self._kv_src[req_id] = res.get("kv_ep")
                    flight.record(req_id, "prefill-done",
                                  replica=res.get("replica"))
                    self._refresh_loads()
                    self._try_place(req_id)
                    stats.add("serve/router_prefill_handoffs")
                    continue
                self.results[req_id] = res
                fresh[req_id] = res
                self._kv_src.pop(req_id, None)
                if self.journal is not None:
                    self.journal.append_result(req_id, res)
                # close the request's client-observed window on the
                # stitched timeline (submit → result pickup)
                t0 = self._t_submit_pc.pop(req_id, None)
                if t0 is not None:
                    trace.complete("serve/route", t0, rid=req_id,
                                   status=res.get("status"),
                                   replica=res.get("replica"))
                flight.record(req_id, "result",
                              status=res.get("status"),
                              replica=res.get("replica"))
                owner = self._assigned.get(req_id)
                if owner is not None:
                    self._outstanding[owner] = max(
                        0, self._outstanding.get(owner, 0) - 1)
            self._done_cursor[rid] = cursor
        if fresh:
            stats.set_value("serve/router_outstanding",
                            sum(self._outstanding.values()))
        if self.fleet_stats is not None:
            now = time.monotonic()
            if now - self._fleet_at >= self._fleet_refresh_s:
                self._fleet_at = now
                self.fleet_stats.poll()
        return fresh

    def enable_fleet_stats(self, refresh_s: float = 1.0,
                           stall_after_s: float = 5.0,
                           jsonl_path: Optional[str] = None,
                           statsz_port: Optional[int] = None):
        """Attach the fleet telemetry plane (observability/fleet):
        :meth:`poll` then refreshes per-replica exports, runs the
        SLO/anomaly watch, and appends JSONL telemetry every
        ``refresh_s``. ``statsz_port`` additionally serves the merged
        fleet /statsz (0 = ephemeral; read ``.port`` off the returned
        FleetStats' server). Returns the FleetStats."""
        from paddle_tpu_torch.observability.fleet import FleetStats
        self.fleet_stats = FleetStats(
            self.directory, dead_after=self.dead_after,
            stall_after_s=stall_after_s, jsonl_path=jsonl_path)
        self._fleet_refresh_s = float(refresh_s)
        if statsz_port is not None:
            self.fleet_stats.serve_statsz(statsz_port)
        return self.fleet_stats

    def check_replicas(self):
        """Death sweep: redistribute every unfinished request assigned
        to a replica whose heartbeat stalled. Each death is swept once;
        a replica whose heartbeat resumes becomes routable again."""
        from paddle_tpu_torch import stats
        from paddle_tpu_torch.observability import flight
        for rid in list(self.directory.members()):
            if self.directory.alive(rid, self.dead_after):
                self._swept.discard(rid)
                continue
            if rid in self._swept:
                continue
            self._swept.add(rid)
            self._outstanding.pop(rid, None)
            # a controller-churned fleet mints a fresh rid per spawn:
            # drop the dead replica's lifecycle-cache entry with the
            # other per-rid state or the cache grows forever
            self._state_cache.pop(rid, None)
            orphans = [q for q, r in self._assigned.items()
                       if r == rid and q not in self.results]
            for req_id in orphans:
                flight.record(req_id, "redistribute", dead=rid)
                self._try_place(req_id)
            if orphans:
                stats.add("serve/router_redistributed", len(orphans))

    def drain(self, timeout: float = 120.0) -> Dict[str, dict]:
        """Block until every submitted request has a result (or
        ``timeout``); death sweeps run throughout, so replicas may die
        mid-drain and the work still completes elsewhere."""
        deadline = time.monotonic() + timeout
        while len(self.results) < len(self._payload):
            if time.monotonic() > deadline:
                missing = sorted(set(self._payload) - set(self.results))
                raise TimeoutError(
                    f"{len(missing)} requests unfinished after "
                    f"{timeout}s: {missing[:8]}")
            self.poll()
            self.check_replicas()
        return dict(self.results)

    def shutdown(self):
        """Ask every replica loop to exit (they finish in-flight work
        first), then release the store if this router owns it."""
        try:
            self.store.set("serve/shutdown", "1")
        except Exception:
            pass

    def close(self):
        if self.journal is not None:
            self.journal.close()
        if self._owns_store:
            self.store.close()


def _mailbox_pump(store, rid: str, seen: int):
    """Drain new mailbox indices for ``rid`` (counter + indexed keys —
    the ONE mailbox idiom every serve loop shares, including the
    role-split loops in serving/disagg.py). Returns
    ``(new_seen, [message dicts])``."""
    from paddle_tpu_torch import native
    try:
        n = native.decode_counter(
            store.get(f"serve/mbox_n/{rid}", timeout=0.001))
    except (TimeoutError, ValueError):
        n = seen
    out = []
    while seen < n:
        seen += 1
        out.append(json.loads(store.get(f"serve/mbox/{rid}/{seen}",
                                        timeout=5.0)))
    return seen, out


def _shutdown_requested(store) -> bool:
    try:
        store.get("serve/shutdown", timeout=0.001)
        return True
    except TimeoutError:
        return False


def _publish(store, rid: str, req_id: str, result: dict):
    """Write one terminal result AND append it to the replica's done
    index (``serve/done_n/<rid>`` counter + ``serve/done_idx/<rid>/<i>``
    -> req_id) — the same counter idiom as the mailbox, so the router
    learns of completions from one counter read per replica instead of
    one blocking probe per outstanding request."""
    store.set(f"serve/done/{req_id}", json.dumps(result))
    i = store.add(f"serve/done_n/{rid}", 1)
    store.set(f"serve/done_idx/{rid}/{i}", req_id)


def drain_migrate_enabled() -> bool:
    """``PT_DRAIN_MIGRATE`` (default on): a draining replica migrates
    its in-flight decode requests to survivors mid-decode instead of
    finishing them in place — drain latency drops from longest-request
    to migration time. 0 restores the finish-in-place drain."""
    return os.environ.get("PT_DRAIN_MIGRATE", "1") != "0"


def _migrate_open_requests(store, rid: str, frontend, open_reqs,
                           sess: Optional[ReplicaSession] = None):
    """Drain migration, sending half: try to move
    every open request off this draining replica. Slot-holding
    requests leave with their KV rows + token history over the fp32
    wire (the ``serve/kv/<req_id>`` blob on the configured data plane —
    the survivor continues bit-for-bit); still-queued ones leave as
    bare ids (the router re-places them from scratch). Either way the
    sender publishes a NON-terminal ``migrated`` result the router
    turns into the next placement, so no request id is ever lost.

    With a `ReplicaSession` the blob rides the socket KV plane (the
    ``migrated`` result carries the sender's ``kv_ep`` locator) and
    the result publication degrades through partitions; without one
    (in-process tests) the blob goes over the store.

    Per-request fallback: any failure — the ``drain.migrate`` chaos
    site firing, detach refusing (mid-prefill, completed during the
    pipeline drain), blob publication dying — leaves THAT request
    finishing in place (``serve/drain_migrate_failed``) while the rest
    still migrate. Requests that could not move yet are retried every
    loop iteration until the replica is empty."""
    import time as _time
    from paddle_tpu_torch import stats
    from paddle_tpu_torch.observability import flight, trace
    from paddle_tpu_torch.serving import kv_transfer
    from paddle_tpu_torch.testing import faults
    transport = sess.transport if sess is not None else None
    for req_id, sreq in list(open_reqs.items()):
        if sreq.done:
            continue                 # the generic publisher owns it
        try:
            faults.fire("drain.migrate")
            got = frontend.detach_migrate(sreq)
        except Exception as e:
            # injected fault / detach failure: this request finishes
            # in place — loudly, never silently corrupted
            stats.add("serve/drain_migrate_failed")
            flight.record(req_id, "migrate-failed", replica=rid,
                          error=str(e))
            continue
        if got is None:
            continue                 # can't move yet; retried next loop
        kv_ep = None
        try:
            if got["kv"]:
                meta = got["meta"]
                t0 = _time.perf_counter()
                # fp32 wire: migration must be bit-identical — a lossy
                # wire would fork the stream at the migration boundary
                header, blob = kv_transfer.encode_kv_pages(
                    got["k"], got["v"], n_tokens=meta["n_tokens"],
                    wire="fp32", rid=req_id)
                header["handoff"] = dict(meta, wire=header["wire"])
                if faults.enabled():
                    # in-transit corruption point (chaos: bitflip /
                    # truncate) — the receiver's digest check must turn
                    # it into handoff-failed, never installed state
                    blob = faults.transform("drain.migrate", blob)
                kv_ep = kv_transfer.send_handoff(
                    store, transport, f"serve/kv/{req_id}", header, blob)
                trace.complete("serve/kv_publish", t0, rid=req_id,
                               bytes=len(blob))
                flight.record(req_id, "migrate-publish",
                              bytes=len(blob),
                              generated=len(meta["tokens"]),
                              plane=("socket" if kv_ep else "store"))
        except Exception as e:
            # the request is already detached; a publish failure is
            # still safe — the router's handoff-failed / re-place path
            # re-executes it from scratch once the fetch times out
            stats.add("serve/drain_migrate_failed")
            flight.record(req_id, "migrate-failed", replica=rid,
                          error=str(e))
        stats.add("serve/drain_migrated")
        flight.record("fleet", "migrate", request=req_id, replica=rid,
                      kv=bool(got["kv"]))
        result = {"id": req_id, "tokens": [], "status": "migrated",
                  "kv": bool(got["kv"]), "kv_ep": kv_ep,
                  "error": None, "replica": rid}
        if sess is not None:
            sess.publish(req_id, result, terminal=False)
        else:
            _publish(store, rid, req_id, result)
        del open_reqs[req_id]


def _install_handoff(store, rid: str, directory, frontend, msg,
                     sess: Optional[ReplicaSession] = None):
    """Receiving half of a KV handoff on a symmetric replica (the
    disagg decode loop keeps its own copy): fetch the blob from
    whichever data plane the message's ``kv_ep`` locator names (socket
    outbox / chunked store), decode the pages, admit via
    ``frontend.submit_handoff``. Publishes ``handoff-failed``
    (retryable — the router re-places from scratch) on a
    missing/corrupt blob, ``rejected-invalid`` (terminal) on an
    infeasible request. Returns the admitted request or None."""
    import time as _time
    from paddle_tpu_torch import stats
    from paddle_tpu_torch.observability import flight, trace
    from paddle_tpu_torch.serving import kv_transfer
    req_id = msg["id"]
    kv_ep = msg.get("kv_ep")
    transport = sess.transport if sess is not None else None
    try:
        t0 = _time.perf_counter()
        try:
            # bounded below dead_after-scale stalls, heartbeat after
            # either way — a slow fetch must not get this healthy
            # replica death-swept
            header, blob = kv_transfer.fetch_handoff(
                store, transport, f"serve/kv/{req_id}", kv_ep=kv_ep,
                timeout=2.0)
        finally:
            if sess is not None:
                sess.heartbeat()
            else:
                directory.heartbeat(rid)
        k, v = kv_transfer.decode_kv_pages(header, blob)
        stats.observe("serve/kv_transfer_s",
                      _time.perf_counter() - t0)
        trace.complete("serve/kv_transfer", t0, rid=req_id,
                       bytes=len(blob))
        flight.record(req_id, "handoff-fetch", bytes=len(blob),
                      wire=header.get("wire"),
                      plane=("socket" if kv_ep else "store"))
        req = frontend.submit_handoff(
            header["handoff"], k, v, deadline_s=msg.get("deadline_s"),
            req_id=req_id)
        kv_transfer.delete_handoff(store, transport,
                                   f"serve/kv/{req_id}", kv_ep=kv_ep,
                                   nchunks=int(header.get("nchunks", 0)))
        return req
    except (TimeoutError, ValueError, RuntimeError,
            resilience.StorePartitioned) as e:
        # missing blob, digest mismatch (in-transit corruption), a
        # partitioned store mid-fetch, or an infeasible install:
        # RETRYABLE — the router re-places the request from scratch;
        # at-least-once keeps the id accounted
        flight.record(req_id, "handoff-failed", error=str(e))
        flight.dump(req_id, "handoff-failed")
        result = {"id": req_id, "tokens": [], "status": "handoff-failed",
                  "error": str(e), "replica": rid}
        if sess is not None:
            sess.publish(req_id, result, terminal=False)
        else:
            _publish(store, rid, req_id, result)
        return None


def serve_replica(store, rid: str, frontend, poll_s: float = 0.02,
                  max_idle_s: Optional[float] = None,
                  load_refresh_s: float = 0.25):
    """One replica's serve loop: announce, then consume the mailbox,
    pump the front-end, publish terminal results, heartbeat — until
    the shutdown key appears (or ``max_idle_s`` with nothing to do).

    ``frontend`` is a :class:`~paddle_tpu_torch.serving.scheduler.FrontEnd`;
    all admission policy (deadline rejection, backfill, streaming)
    applies per-replica exactly as single-process serving. Every
    ``load_refresh_s`` the heartbeat also carries the load gauges AND
    a full ``stats.export()`` snapshot — the fleet telemetry plane's
    feed (observability/fleet.FleetStats) — plus the live/peak HBM
    gauges on backends that expose them.

    Drain protocol: once the directory state flips
    to ``draining`` (the fleet controller retiring this replica), the
    router has already stopped placing new work here — this loop keeps
    consuming any mailbox entries placed BEFORE the drain, then (with
    ``PT_DRAIN_MIGRATE``, default on) MIGRATES its in-flight requests
    to survivors mid-decode (:func:`_migrate_open_requests` — KV rows
    + token history over the fp32 wire, streams byte-identical),
    finishes in place whatever could not move, publishes ``drained``,
    and exits — drain latency is bounded by migration time, not the
    longest in-flight request.
    """
    from paddle_tpu_torch import stats
    from paddle_tpu_torch.observability import runtime
    from paddle_tpu_torch.serving import kv_transfer
    from paddle_tpu_torch.serving.disagg import queue_age_s, replica_load
    from paddle_tpu_torch.testing import faults
    sess = ReplicaSession(
        store, rid,
        meta={"pid": os.getpid(), "slots": frontend.engine.S},
        transport=kv_transfer.maybe_transport(),
        engine=frontend.engine,
        fleet=getattr(frontend.engine, "fleet", None))
    sess.announce()
    open_reqs: Dict[str, object] = {}
    idle_since = time.monotonic()
    last_load = 0.0
    draining = False
    while True:
        # chaos hook (testing/faults.py): PT_FAULTS="serve.loop:kill:
        # after=N" SIGKILL-equivalently drops this replica mid-serve —
        # the fleet controller must heal it with zero request-id loss
        faults.fire("serve.loop")
        # partition / failover state machine: probes the router's
        # liveness counter, watches the endpoint file, and on a new
        # router generation re-announces + republishes buffered results
        sess.maintain()
        sess.pump_transport()
        now = time.monotonic()
        if now - last_load >= load_refresh_s:
            runtime.hbm_gauges()
            sess.heartbeat(load=replica_load(
                frontend.engine, "both",
                queued=len(frontend._queue) + frontend.engine.queued,
                queue_age_s=queue_age_s(frontend=frontend)),
                stats_export=stats.export())
            last_load = now
            draining = draining or sess.lifecycle() == "draining"
        else:
            sess.heartbeat()
        # mailbox BEFORE the drain/shutdown exit checks: a request the
        # router placed just before the drain decision may still sit
        # unconsumed here — exiting first would strand it until the
        # death sweep, a dead_after-sized latency cliff on a request
        # the drain protocol promises to finish
        for msg in sess.pump_mailbox():
            if msg.get("id") in open_reqs:
                continue        # duplicate re-place of in-flight work
            if msg.get("kind") == "handoff":
                # a draining peer's mid-decode migration landing here
                # (the router picked this replica as the survivor)
                req = _install_handoff(sess.store, rid, sess.directory,
                                       frontend, msg, sess=sess)
                if req is not None:
                    open_reqs[msg["id"]] = req
                continue
            try:
                req = frontend.submit(
                    msg["prompt"], max_new_tokens=msg["max_new_tokens"],
                    eos_id=msg["eos_id"], deadline_s=msg["deadline_s"],
                    priority=msg["priority"], req_id=msg["id"])
            except ValueError as e:
                # an infeasible request (too long for this engine's
                # cache, empty prompt) must fail AS A RESULT, never
                # kill the replica: an uncaught raise here would die,
                # the router would redistribute the same poison payload
                # to the next replica, and one bad client request would
                # cascade through the whole fleet
                sess.publish(msg["id"], {
                    "id": msg["id"], "tokens": [],
                    "status": "rejected-invalid", "error": str(e),
                    "replica": rid})
                continue
            open_reqs[msg["id"]] = req
        if draining and open_reqs and drain_migrate_enabled():
            # migrate in-flight work to survivors instead of finishing
            # it here: drain latency becomes migration time, not
            # longest-request time (per-request fallback inside)
            _migrate_open_requests(sess.store, rid, frontend, open_reqs,
                                   sess=sess)
        if draining and not open_reqs and not frontend.busy:
            sess.set_state("drained")
            sess.close()
            return
        if sess.shutdown_requested() and not open_reqs \
                and not frontend.busy:
            sess.close()
            return
        if frontend.busy:
            # in-flight decode continues straight through a partition —
            # the whole point of degrading instead of dying
            frontend.step()
            idle_since = time.monotonic()
        else:
            if sess.partitioned:
                # never idle-exit into a partition: the router may be
                # mid-failover and about to re-place work here
                idle_since = time.monotonic()
            if (max_idle_s is not None
                    and time.monotonic() - idle_since > max_idle_s):
                sess.close()
                return
            time.sleep(poll_s)
        for req_id, req in list(open_reqs.items()):
            if req.done:
                sess.publish(req_id, {
                    "id": req_id, "tokens": list(req.tokens),
                    "status": req.status, "error": req.error,
                    "replica": rid})
                del open_reqs[req_id]
