"""Continuous-batching serving front end (counterpart of
``paddle_tpu/serving/scheduler.py``): the service layer over the decode
engines.

The engines (``inference/decode_engine.py``, ``paged_engine.py``) are
mechanisms: slot-based continuous batching, pipelined dispatch,
deadline and poison eviction. Their admission queue is an unbounded
FIFO, so the card's occupancy under live traffic is whatever order the
callers ``submit()`` in. ``FrontEnd`` adds the policy:

- **Admission control.** A bounded queue (``PT_SERVE_QUEUE_DEPTH``)
  ordered by a policy (``PT_SERVE_ADMISSION``: ``fifo``, ``priority``
  or ``edf``, earliest deadline first). Queue wait counts against the
  request's ``deadline_s``; a request that expires while queued, or
  whose remaining headroom is already below the engine's observed
  time to first token, is rejected at admission (``rejected-deadline``;
  ``serve/queue_deadline_rejects``, ``serve/queue_hopeless_rejects``)
  instead of taking a slot it could only be evicted from mid-decode. A
  rejection costs no device work.
- **Slot backfill.** The engine's ``on_retire`` hook fires from inside
  the harvest the moment a slot frees; the front end moves the best
  queued request into the engine at once (``serve/queue_backfill``).
- **Dynamic bucket selection.** The front end overrides the contiguous
  engine's prefill bucket with :func:`dynamic_bucket`: the bucket that
  minimises the admission's projected TTFT at the current occupancy.
  The paged engine prefills in one pass and never consults it.
- **Streaming.** ``submit(...).stream()`` iterates tokens as harvests
  apply them (fed from the engine's ``on_token`` hook). The front end
  only orders admissions and never touches per-slot math, so on the
  paged engine a greedy stream equals a direct ``engine.submit()`` +
  ``run()`` of the same prompt.

Single-threaded, like the engines: callers pump ``step()`` (or
``run()``, or iterate a stream, which pumps). The tensors stay on the
engine's device; the front end holds host lists of token ids only.
``submit_handoff`` and ``detach_migrate`` carry requests between engines
(KV handoff, drain migration; ``serving/kv_transfer.py`` is the wire).
The multi-process layer is ``serving/router.py`` (the router and
``serve_replica``) and ``serving/disagg.py`` (the role loops).
"""

import json
import math
import os
import time
from typing import Iterator, List, Optional

from paddle_tpu_torch import stats
from paddle_tpu_torch.observability import flight

__all__ = ["FrontEnd", "ServeRequest", "dynamic_bucket",
           "projected_ttft", "RequestJournal"]

# terminal statuses a ServeRequest can reach
_TERMINAL = ("done", "failed", "rejected-queue-full",
             "rejected-deadline", "migrated")


class ServeRequest:
    """One request's front-end lifecycle. Status transitions::

        queued -> admitted -> done | failed
        queued -> rejected-queue-full | rejected-deadline
        queued | admitted -> migrated          (drain migration)

    ``rejected-*`` means the request never reached a prefill (no device
    work); ``failed`` means the engine evicted it after admission
    (deadline mid-decode, non-finite logits), and ``error`` says which.
    ``migrated`` is terminal only locally: a draining replica handed the
    request to another one (``detach_migrate``).
    """

    __slots__ = ("id", "prompt", "max_new_tokens", "eos_id", "priority",
                 "deadline", "t_submit", "seq", "status", "error",
                 "engine_req", "_buf", "_fe")

    def __init__(self, req_id, prompt, max_new_tokens, eos_id, priority,
                 deadline, seq, fe):
        self.id = req_id
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.priority = priority
        self.deadline = deadline          # absolute time.monotonic()
        self.t_submit = time.perf_counter()
        self.seq = seq
        self.status = "queued"
        self.error: Optional[str] = None
        self.engine_req = None            # the engine's Request once admitted
        self._buf: List[int] = []         # stream buffer (harvest order)
        self._fe = fe

    @property
    def tokens(self) -> List[int]:
        return self._buf

    @property
    def done(self) -> bool:
        return self.status in _TERMINAL

    @property
    def failed(self) -> bool:
        return self.done and self.status != "done"

    @property
    def ttft_s(self) -> Optional[float]:
        r = self.engine_req
        return None if r is None else r.ttft_s

    @property
    def tpot_s(self) -> Optional[float]:
        r = self.engine_req
        return None if r is None else r.tpot_s

    def stream(self) -> Iterator[int]:
        """Iterate generated tokens in harvest order, pumping the front
        end while waiting. Ends when the request is terminal (check
        ``failed`` / ``error`` afterwards)."""
        i = 0
        while True:
            while i < len(self._buf):
                yield self._buf[i]
                i += 1
            if self.done:
                # a terminal request's tokens are all applied (it retires
                # in the harvest, after the replay), but the buffer may
                # have grown between the check and now
                while i < len(self._buf):
                    yield self._buf[i]
                    i += 1
                return
            self._fe.step()


def projected_ttft(engine, remaining: int, bucket: int,
                   alpha: float = 2e-3, beta: float = 2e-5) -> float:
    """Analytic TTFT projection for prefilling ``remaining`` prompt
    tokens in ``bucket``-sized chunks on ``engine`` at its current
    occupancy. ``alpha`` is the per-dispatch overhead, ``beta`` the
    per-token cost; only their ratio shapes the argmin, so the defaults
    need no per-card calibration.

    cost = chunks * (alpha + bucket * beta)            # padded prefill
         + steps  * (alpha + live * chunk * beta)      # interleaved
                                                       # decode (if any)

    where ``steps`` is how many engine steps the chunks spread over
    under the per-step prefill token budget: each step of a live engine
    also dispatches one decode chunk into the TTFT path.
    """
    chunks = max(1, math.ceil(remaining / bucket))
    # the paged engine has no chunked-prefill budget (its prefill is one
    # dispatch and it never consults bucket_policy): one bucket a step
    budget = getattr(engine, "_prefill_budget", engine.buckets[-1])
    per_step = max(1, budget // bucket)
    steps = math.ceil(chunks / per_step)
    live = engine.S - engine.free_slots
    cost = chunks * (alpha + bucket * beta)
    if live > 0:
        cost += steps * (alpha + live * engine.chunk * beta)
    return cost


def dynamic_bucket(engine, remaining: int) -> int:
    """``engine.bucket_policy`` minimising :func:`projected_ttft` over
    the engine's buckets (ties to the smaller bucket: less padding, a
    shorter stall of the other slots)."""
    return min(engine.buckets,
               key=lambda b: (projected_ttft(engine, remaining, b), b))


def _queue_depth_default() -> int:
    return int(os.environ.get("PT_SERVE_QUEUE_DEPTH", "256"))


def _admission_default() -> str:
    return os.environ.get("PT_SERVE_ADMISSION", "priority")


class FrontEnd:
    """Admission control, backfill and streaming over ONE engine.

        fe = FrontEnd(make_engine(model))
        r = fe.submit(prompt, max_new_tokens=64, deadline_s=2.0)
        for tok in r.stream():
            ...

    ``admission``: ``fifo`` (arrival order), ``priority`` (higher
    ``priority=`` first, then arrival), ``edf`` (earliest absolute
    deadline first, no deadline last). ``hopeless_factor`` scales the
    TTFT bar a deadline must clear at admission (0 turns hopeless
    rejection off; expiry rejection always applies). ``admit_ahead``
    extra requests are staged into the engine's own queue beyond its
    free slots, so an admission never waits a step.
    """

    def __init__(self, engine, queue_depth: Optional[int] = None,
                 admission: Optional[str] = None,
                 hopeless_factor: float = 1.0, admit_ahead: int = 1,
                 dynamic_buckets: bool = True):
        self.engine = engine
        self.queue_depth = (queue_depth if queue_depth is not None
                            else _queue_depth_default())
        self.admission = admission or _admission_default()
        if self.admission not in ("fifo", "priority", "edf"):
            raise ValueError(
                f"admission policy must be fifo|priority|edf, "
                f"got {self.admission!r}")
        self.hopeless_factor = float(hopeless_factor)
        self.admit_ahead = int(admit_ahead)
        self._queue: List[ServeRequest] = []
        self._all: List[ServeRequest] = []
        self._by_engine_req = {}        # id(engine Request) -> ServeRequest
        self._seq = 0
        self._ttft_ema: Optional[float] = None
        engine.on_token = self._on_token
        engine.on_retire = self._on_retire
        if dynamic_buckets and engine.bucket_policy is None:
            engine.bucket_policy = dynamic_bucket

    # -- submission ---------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int = 32,
               eos_id: Optional[int] = None,
               deadline_s: Optional[float] = None, priority: int = 0,
               req_id: Optional[str] = None) -> ServeRequest:
        prompt = [int(t) for t in prompt]
        # an infeasible request fails here, not from a later pump
        self.engine.check_request(len(prompt), int(max_new_tokens))
        self._seq += 1
        req = ServeRequest(
            req_id or f"req-{self._seq:06d}", prompt,
            int(max_new_tokens), eos_id, int(priority),
            (None if deadline_s is None
             else time.monotonic() + float(deadline_s)),
            self._seq, self)
        self._all.append(req)
        if len(self._queue) >= self.queue_depth:
            req.status = "rejected-queue-full"
            req.error = (f"admission queue full "
                         f"({self.queue_depth} waiting)")
            stats.add("serve/queue_rejects")
            flight.record(req.id, "reject", reason="queue-full",
                          depth=self.queue_depth)
            return req
        self._queue.append(req)
        flight.record(req.id, "submit", prompt=len(prompt),
                      budget=int(max_new_tokens), priority=int(priority),
                      deadline_s=deadline_s)
        stats.set_value("serve/queue_len", len(self._queue))
        return req

    def submit_handoff(self, meta: dict, k, v,
                       deadline_s: Optional[float] = None,
                       req_id: Optional[str] = None,
                       t_submit: Optional[float] = None) -> ServeRequest:
        """Admit a request whose KV state was built on another replica,
        after its prefill (disaggregated serving) or mid-decode (a drain
        migration): the engine installs the transferred KV pages when a
        slot frees and decode continues from the handed-off state. It
        bypasses the admission queue (admission ran where the request
        entered the fleet); the stream and retire hooks apply as for a
        local request. A mid-decode handoff's final tokens
        (``meta["tokens"][:-1]``) pre-fill the stream buffer."""
        eng = self.engine
        if not hasattr(eng, "submit_handoff"):
            raise ValueError("engine has no KV-handoff support")
        ereq = eng.submit_handoff(meta, k, v, deadline_s=deadline_s)
        self._seq += 1
        sreq = ServeRequest(
            req_id or f"req-{self._seq:06d}", list(meta["prompt"]),
            int(meta["max_new_tokens"]), meta["eos_id"], 0,
            (None if deadline_s is None
             else time.monotonic() + float(deadline_s)),
            self._seq, self)
        sreq.status = "admitted"
        sreq.engine_req = ereq
        # the sender's history: tokens[:-1] are final (the engine emits
        # tokens[-1] again through the harvest, into _buf by _on_token)
        sreq._buf = [int(t) for t in
                     meta.get("tokens", [meta["first"]])[:-1]]
        if ereq.rid is None:
            ereq.rid = sreq.id
        flight.record(sreq.id, "handoff-admitted",
                      n_tokens=int(meta["n_tokens"]),
                      generated=len(sreq._buf) + 1)
        if t_submit is not None:
            # same-process disaggregation: TTFT counts from the original
            # arrival (perf_counter compares only within one process)
            sreq.t_submit = t_submit
        ereq.t_submit = sreq.t_submit
        self._all.append(sreq)
        self._by_engine_req[id(ereq)] = sreq
        return sreq

    def detach_migrate(self, sreq: ServeRequest):
        """Extract one open request for a drain migration (the sending
        half). Returns

        - ``None``: the request cannot move now (mid-prefill, no token
          yet, or it completed while the pipeline drained);
        - ``{"kv": False}``: it was still queued (in the front end's
          queue or the engine's), with no device state to carry;
        - ``{"kv": True, "meta":, "k":, "v":}``: it held a slot
          mid-decode, and the engine detached its KV rows and token
          history (``engine.detach_handoff``).

        On the non-None paths the request is locally terminal
        (``migrated``) and off every queue and slot."""
        if sreq.done:
            return None
        if sreq.status == "queued":
            try:
                self._queue.remove(sreq)
            except ValueError:
                return None
            sreq.status = "migrated"
            stats.set_value("serve/queue_len", len(self._queue))
            return {"kv": False}
        ereq = sreq.engine_req
        eng = self.engine
        if ereq is None or not hasattr(eng, "detach_handoff"):
            return None
        if ereq in eng._waiting:
            # staged ahead into the engine's queue: no prefill ran
            eng._waiting.remove(ereq)
            self._by_engine_req.pop(id(ereq), None)
            sreq.status = "migrated"
            return {"kv": False}
        # harvest the pipeline first, with the hooks still wired: tokens
        # landing now must reach sreq._buf, and a request that completes
        # during the drain must retire normally
        eng._drain()
        if ereq.done or not ereq.tokens:
            return None
        # the detach ends the request in the engine (its retire hook):
        # unhook it first so the migrating request is not marked done
        self._by_engine_req.pop(id(ereq), None)
        try:
            meta, k, v = eng.detach_handoff(ereq)
        except ValueError:
            self._by_engine_req[id(ereq)] = sreq
            return None
        sreq.status = "migrated"
        return {"kv": True, "meta": meta, "k": k, "v": v}

    # -- engine hooks -------------------------------------------------------

    def _on_token(self, ereq, token: int):
        sreq = self._by_engine_req.get(id(ereq))
        if sreq is not None:
            sreq._buf.append(token)

    def _on_retire(self, ereq):
        """The engine ended a request (from inside the harvest): finish
        the front-end record, fold its TTFT into the hopeless-rejection
        estimate, and backfill the freed slot from the queue at once."""
        sreq = self._by_engine_req.pop(id(ereq), None)
        if sreq is not None:
            if ereq.error is None:
                sreq.status = "done"
            else:
                # a request staged ahead into the engine's queue that
                # expired there is still a queue reject (the engine
                # counted it as one)
                sreq.status = ("rejected-deadline"
                               if "while queued" in ereq.error
                               else "failed")
                sreq.error = ereq.error
            if ereq.ttft_s is not None:
                self._ttft_ema = (
                    ereq.ttft_s if self._ttft_ema is None
                    else 0.8 * self._ttft_ema + 0.2 * ereq.ttft_s)
        if self._queue and self._feed() > 0:
            stats.add("serve/queue_backfill")

    # -- admission ----------------------------------------------------------

    def _order_key(self, r: ServeRequest):
        if self.admission == "priority":
            return (-r.priority, r.seq)
        if self.admission == "edf":
            return (r.deadline if r.deadline is not None else math.inf,
                    r.seq)
        return (r.seq,)

    def _reject(self, req: ServeRequest, reason: str, stat: str):
        req.status = "rejected-deadline"
        req.error = reason
        stats.add(stat)
        flight.record(req.id, "reject", reason=reason, stat=stat)

    def _ttft_estimate(self, req: ServeRequest) -> float:
        """The TTFT bar the hopeless screen holds ``req`` to: the EMA of
        observed TTFTs, or before any observation the
        :func:`projected_ttft` of the smallest covering bucket (the
        model the bucket policy trusts), so a cold engine neither waves
        a 1 ms deadline through to a prefill nor rejects a reasonable
        one."""
        if self._ttft_ema is not None:
            return self._ttft_ema
        eng = self.engine
        n = len(req.prompt)
        bucket = next((b for b in eng.buckets if b >= n),
                      eng.buckets[-1])
        return projected_ttft(eng, n, bucket)

    def _admissible(self, req: ServeRequest) -> bool:
        """Deadline screen at the queue-to-engine boundary: the queue
        wait counts against the budget, and a budget below the TTFT
        estimate (``_ttft_estimate``) is hopeless: rejected here, for
        free, instead of evicted mid-decode."""
        if req.deadline is None:
            return True
        headroom = req.deadline - time.monotonic()
        if headroom <= 0:
            self._reject(req, "deadline exceeded while queued",
                         "serve/queue_deadline_rejects")
            return False
        est = self._ttft_estimate(req)
        if (self.hopeless_factor > 0
                and headroom < self.hopeless_factor * est):
            self._reject(
                req, f"deadline hopeless at admission: "
                     f"{headroom * 1e3:.0f}ms budget vs "
                     f"~{est * 1e3:.0f}ms "
                     f"{'observed' if self._ttft_ema is not None else 'projected'} TTFT",
                "serve/queue_hopeless_rejects")
            return False
        return True

    def _feed(self, capacity: Optional[int] = None) -> int:
        """Move the best queued requests into the engine while it has
        room (free slots plus ``admit_ahead`` staged). Returns how many
        were admitted."""
        eng = self.engine
        if capacity is None:
            capacity = (eng.free_slots + self.admit_ahead - eng.queued)
        admitted = 0
        # one sort a feed: the keys (priority, absolute deadline,
        # arrival) do not change while a request is queued
        self._queue.sort(key=self._order_key)
        while capacity > 0 and self._queue:
            req = self._queue.pop(0)
            if not self._admissible(req):
                continue
            ereq = eng.submit(
                req.prompt, max_new_tokens=req.max_new_tokens,
                eos_id=req.eos_id,
                deadline_s=(None if req.deadline is None
                            else req.deadline - time.monotonic()),
                req_id=req.id)
            # TTFT counts the front-end queue wait: re-anchor the engine
            # request's clock to the front-end submission
            ereq.t_submit = req.t_submit
            req.engine_req = ereq
            req.status = "admitted"
            self._by_engine_req[id(ereq)] = req
            stats.observe("serve/queue_wait_s",
                          time.perf_counter() - req.t_submit)
            capacity -= 1
            admitted += 1
        stats.set_value("serve/queue_len", len(self._queue))
        return admitted

    def _sweep_expired(self):
        """Reject queued requests whose deadline passed: they never
        reach a prefill."""
        now = time.monotonic()
        expired = [r for r in self._queue
                   if r.deadline is not None and now > r.deadline]
        for req in expired:
            self._queue.remove(req)
            self._reject(req, "deadline exceeded while queued",
                         "serve/queue_deadline_rejects")

    # -- pump ---------------------------------------------------------------

    def step(self) -> int:
        """One service iteration: reject expired queue entries, feed the
        free capacity, advance the engine one step (which may backfill
        more through ``on_retire``). Returns the tokens applied.

        ``serve/fed_occupancy`` samples the batch occupancy only on
        steps whose demand exceeded the free slots: the steps where a
        scheduler that trickles requests in diverges from one that keeps
        the pipeline fed."""
        self._sweep_expired()
        self._feed()
        eng = self.engine
        backlogged = (len(self._queue) + eng.queued) > eng.free_slots
        n = eng.step()
        if backlogged:
            stats.observe("serve/fed_occupancy",
                          (eng.S - eng.free_slots) / eng.S)
        return n

    @property
    def busy(self) -> bool:
        eng = self.engine
        return bool(self._queue or eng.queued
                    or eng.free_slots < eng.S or eng._pending)

    def run(self) -> None:
        """Serve until every submitted request is terminal."""
        while self.busy:
            self.step()
        self.engine.drain()

    def results(self) -> List[ServeRequest]:
        return list(self._all)


class RequestJournal:
    """Front-end request journal: an append-only JSONL file the
    submitting side writes before placement and after every terminal
    result::

        {"kind": "submit", "id": "rq-000007", "prompt": [...], ...}
        {"kind": "result", "id": "rq-000007", "result": {...}}

    A restarted router replays it (:meth:`replay`): payloads without a
    result are placed again (at least once; the first result wins), the
    others are answered. ``flush()`` after every append puts the record
    in the OS page cache, which survives the writer's SIGKILL.
    """

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a", encoding="utf-8")

    def append_submit(self, payload: dict) -> None:
        rec = {"kind": "submit"}
        rec.update(payload)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def append_result(self, req_id: str, result: dict) -> None:
        self._f.write(json.dumps(
            {"kind": "result", "id": req_id, "result": result}) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    @staticmethod
    def replay(path: str):
        """Parse a journal into ``(payloads, results)``: ``payloads``
        maps req_id to the original submit payload (the ``kind`` key
        stripped), ``results`` maps req_id to its terminal result. A
        torn last line (a kill mid-append) is skipped; every complete
        record before it is intact."""
        payloads, results = {}, {}
        try:
            f = open(path, "r", encoding="utf-8")
        except OSError:
            return payloads, results
        with f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue        # torn tail record
                if rec.get("kind") == "submit" and "id" in rec:
                    p = {k: v for k, v in rec.items() if k != "kind"}
                    payloads[rec["id"]] = p
                elif rec.get("kind") == "result" and "id" in rec:
                    results[rec["id"]] = rec.get("result") or {}
        return payloads, results
