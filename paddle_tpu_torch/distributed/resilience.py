"""Resilient distributed runtime (a copy of
``paddle_tpu/distributed/resilience.py``): retry/backoff/deadline
policies, the deadline-guarded store helper and a collective watchdog.

There is ONE policy object (`RetryPolicy`: exponential backoff + jitter
+ an absolute deadline), one deadline primitive (`Deadline`), guarded
wrappers for the store and control-plane ops (`store_get`, `store_set`,
`with_deadline`, `GuardedStore`), and a `CollectiveWatchdog` that turns
"a rank hung inside a barrier" into an exception naming the stalled
rank(s).

Watchdog design: the counter-not-clock trick of the membership
heartbeats. Each rank bumps a per-rank progress counter in the store
when it *enters* guarded collective #k, then waits (bounded by the
deadline) for every peer's counter to reach k. A peer that never
arrives leaves its counter behind, so the waiting ranks raise
`CollectiveStallError` naming exactly the laggards. Only counter
*progress* is judged, against the local monotonic clock.

Every retry / timeout / stall / partition increments a ``resilience/*``
counter in ``paddle_tpu_torch.stats``, under the JAX module's names.
Fault sites: ``store.get``, ``watchdog.enter``, ``store.partition``.
"""

import dataclasses
import os
import queue as _queue
import random as _random
import threading
import time
from typing import Callable, Optional, Tuple

__all__ = ["Deadline", "DeadlineExceeded", "CollectiveStallError",
           "RetryPolicy", "with_deadline", "store_get", "store_set",
           "CollectiveWatchdog", "DEFAULT_POLICY",
           "GuardedStore", "StorePartitioned", "store_retry_s"]


class DeadlineExceeded(TimeoutError):
    """An operation (including all its retries) overran its absolute
    deadline. Subclasses TimeoutError so existing timeout handlers
    treat it uniformly."""


class StorePartitioned(ConnectionError):
    """The control-plane store stopped answering for a whole retry
    budget (router death, network partition, frozen server). Callers
    in the serve loops treat this as "degrade, don't die": skip the
    beat, buffer the result, keep decoding."""


class CollectiveStallError(RuntimeError):
    """A guarded collective was entered by this rank but one or more
    peers never arrived within the deadline. ``stalled_ranks`` names
    them; the message includes each laggard's last observed progress."""

    def __init__(self, message: str, stalled_ranks=()):
        super().__init__(message)
        self.stalled_ranks = tuple(stalled_ranks)


class Deadline:
    """Absolute time budget, measured on the local monotonic clock.

    ``seconds=None`` means unbounded (remaining() == None, never
    expired) so call sites can thread one object through both bounded
    and unbounded paths.
    """

    __slots__ = ("seconds", "_t0")

    def __init__(self, seconds: Optional[float]):
        self.seconds = None if seconds is None else float(seconds)
        self._t0 = time.monotonic()

    def elapsed(self) -> float:
        return time.monotonic() - self._t0

    def remaining(self) -> Optional[float]:
        if self.seconds is None:
            return None
        return self.seconds - self.elapsed()

    @property
    def expired(self) -> bool:
        r = self.remaining()
        return r is not None and r <= 0

    def budget(self, want: float, floor: float = 0.001) -> float:
        """Clamp a per-attempt timeout to what's left of the deadline
        (never below ``floor`` — native calls reject non-positive
        timeouts)."""
        r = self.remaining()
        return max(floor, want if r is None else min(want, r))

    def check(self, op: str = "operation"):
        if self.expired:
            raise DeadlineExceeded(
                f"{op} exceeded its {self.seconds}s deadline "
                f"(elapsed {self.elapsed():.2f}s)")


@dataclasses.dataclass
class RetryPolicy:
    """Exponential backoff + jitter + absolute deadline.

        policy = RetryPolicy(max_attempts=5, deadline=30.0)
        value = policy.run(lambda: store.get(key), op="rendezvous_get")

    The deadline bounds the WHOLE call including every backoff sleep —
    a caller holding a peer at a barrier must fail within a known
    budget, not after max_attempts of unbounded waits. Retries and
    deadline overruns surface as ``resilience/retries`` /
    ``resilience/deadline_exceeded`` (plus per-op variants) in
    `paddle_tpu_torch.stats`.
    """

    max_attempts: int = 5
    base_delay: float = 0.05
    max_delay: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.25          # +- fraction of the computed delay
    deadline: Optional[float] = 30.0

    def delay_for(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based)."""
        d = min(self.base_delay * self.multiplier ** (attempt - 1),
                self.max_delay)
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * _random.random() - 1.0)
        return max(0.0, d)

    def run(self, fn: Callable, *, op: str = "op",
            retry_on: Tuple = (TimeoutError, ConnectionError, OSError),
            deadline: Optional["Deadline"] = None):
        from paddle_tpu_torch import stats
        dl = deadline or Deadline(self.deadline)
        attempt = 0
        while True:
            try:
                return fn()
            except DeadlineExceeded:
                raise           # an inner deadline is final, never retried
            except retry_on as e:
                attempt += 1
                stats.add("resilience/retries")
                stats.add(f"resilience/{op}/retries")
                if attempt >= self.max_attempts:
                    stats.add("resilience/retries_exhausted")
                    raise
                if dl.expired:
                    stats.add("resilience/deadline_exceeded")
                    raise DeadlineExceeded(
                        f"{op} failed after {attempt} attempts over "
                        f"{dl.elapsed():.2f}s (deadline {dl.seconds}s): "
                        f"{e!r}") from e
                time.sleep(dl.budget(self.delay_for(attempt), floor=0.0))


DEFAULT_POLICY = RetryPolicy()


def with_deadline(fn: Callable, seconds: Optional[float],
                  op: Optional[str] = None,
                  policy: Optional[RetryPolicy] = None,
                  retry_on: Tuple = (TimeoutError, ConnectionError,
                                     OSError)) -> Callable:
    """Wrap a zero-arg-compatible callable so every invocation runs
    under a fresh ``seconds`` deadline with retry/backoff on transient
    errors (``retry_on``, default TimeoutError / ConnectionError /
    OSError — widen it for libraries that wrap transport failures in
    RuntimeError).

        guarded = with_deadline(lambda: dist.init_process_group(...),
                                seconds=120.0, op="collective_init")
        guarded()
    """
    name = op or getattr(fn, "__name__", "op")
    pol = policy or DEFAULT_POLICY

    def wrapped(*args, **kwargs):
        return pol.run(lambda: fn(*args, **kwargs), op=name,
                       retry_on=retry_on, deadline=Deadline(seconds))

    wrapped.__name__ = f"with_deadline[{name}]"
    return wrapped


def store_get(store, key: str, *, deadline: float = 30.0,
              policy: Optional[RetryPolicy] = None, op: str = "store_get"):
    """Deadline-guarded TCPStore get: each attempt's native timeout is
    the deadline *remainder* (so retries after transient connection
    errors cannot extend the total budget), and the whole call fails
    with `DeadlineExceeded` naming the key. Fault site: ``store.get``."""
    from paddle_tpu_torch import stats
    from paddle_tpu_torch.testing import faults

    pol = policy or DEFAULT_POLICY
    dl = Deadline(deadline)

    def attempt():
        faults.fire("store.get")
        dl.check(f"store.get({key!r})")
        return store.get(key, timeout=dl.budget(deadline))

    try:
        return pol.run(attempt, op=op, deadline=dl)
    except TimeoutError as e:
        if isinstance(e, DeadlineExceeded):
            raise
        stats.add("resilience/deadline_exceeded")
        raise DeadlineExceeded(
            f"store.get({key!r}) exceeded its {deadline}s deadline") from e


def store_set(store, key: str, value, *,
              policy: Optional[RetryPolicy] = None, op: str = "store_set"):
    """Retried TCPStore set (transient connection errors only — set has
    no wait semantics, so no deadline remainder to thread)."""
    pol = policy or DEFAULT_POLICY
    return pol.run(lambda: store.set(key, value), op=op)


class CollectiveWatchdog:
    """Progress-counter watchdog for host-level collectives.

        wd = CollectiveWatchdog(store, rank=r, world_size=n,
                                deadline=30.0)
        with wd.guard("allreduce"):        # raises CollectiveStallError
            ...run the real collective...  # if a peer never arrives

    Each ``guard`` entry bumps this rank's counter
    (``resilience/wd/{group}/{rank}``) in the store and then waits —
    bounded by ``deadline`` — for every peer's counter to reach the
    same height. Because the counter only moves when a rank reaches the
    guard, a hung/dead peer is distinguishable from a slow one by lack
    of progress, and the error names exactly the ranks that never
    arrived (with their last observed progress), turning an infinite
    hang into a diagnosable failure. Fault site: ``watchdog.enter``
    (delay a rank to simulate a straggler)."""

    def __init__(self, store, rank: int, world_size: int,
                 group: str = "default", deadline: float = 30.0,
                 poll: float = 0.05):
        self.store = store
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.group = group
        self.deadline = float(deadline)
        self.poll = float(poll)

    def _key(self, rank: int) -> str:
        return f"resilience/wd/{self.group}/{rank}"

    def _progress(self, rank: int) -> int:
        from paddle_tpu_torch.native import decode_counter
        try:
            return decode_counter(
                self.store.get(self._key(rank), timeout=self.poll))
        except (TimeoutError, ValueError):
            return 0            # not yet registered → no progress

    def progress(self) -> dict:
        """Last observed per-rank progress counters (diagnostics)."""
        return {r: self._progress(r) for r in range(self.world_size)}

    def guard(self, op: str = "collective"):
        wd = self

        class _Guard:
            def __enter__(self):
                from paddle_tpu_torch import stats
                from paddle_tpu_torch.testing import faults
                faults.fire("watchdog.enter")
                seq = wd.store.add(wd._key(wd.rank), 1)
                dl = Deadline(wd.deadline)
                behind = {}
                while True:
                    behind = {r: c for r, c in
                              ((r, wd._progress(r))
                               for r in range(wd.world_size))
                              if c < seq and r != wd.rank}
                    if not behind:
                        break
                    if dl.expired:
                        stats.add("resilience/watchdog_stalls")
                        ranks = sorted(behind)
                        raise CollectiveStallError(
                            f"collective {op!r} #{seq}: rank(s) {ranks} "
                            f"stalled — progress "
                            f"{ {r: behind[r] for r in ranks} } after "
                            f"{wd.deadline}s (this rank={wd.rank}, "
                            f"world={wd.world_size})",
                            stalled_ranks=ranks)
                    time.sleep(wd.poll)
                stats.add("resilience/watchdog_syncs")
                return self

            def __exit__(self, *exc):
                return False

        return _Guard()

    def barrier(self, op: str = "barrier"):
        """A guarded no-op collective: returns once every rank arrives,
        raises `CollectiveStallError` otherwise."""
        with self.guard(op):
            pass


def store_retry_s(default: float = 2.0) -> float:
    """Per-op retry budget (seconds) for `GuardedStore` — how long a
    single store operation keeps retrying transport errors before the
    caller sees `StorePartitioned` and degrades to partition mode."""
    try:
        return max(0.1, float(os.environ.get("PT_STORE_RETRY_S", default)))
    except ValueError:
        return default


class _OpStuck(Exception):
    """Internal: the store op thread did not answer within the wait —
    the server is frozen (SIGSTOP) or the network is black-holing.
    Deliberately NOT in any retry_on tuple: retrying would just queue
    more ops behind the stuck one."""


class _KeyAbsent(Exception):
    """Internal: wraps the native TimeoutError for a key that simply
    isn't there yet. Builtin TimeoutError is an OSError subclass (3.10+)
    so it would match the transport retry_on tuple — but key-absence is
    normal control flow all over the serving protocol and must pass
    through UNRETRIED, not burn the whole partition budget."""

    def __init__(self, err: BaseException):
        super().__init__(str(err))
        self.err = err


class GuardedStore:
    """The one shared deadline-guarded store helper: every serving and
    fleet store call site routes through here.

    Wraps a raw `native.TCPStore` client (or any store with its
    ``get``/``set``/``add``/``delete_key``/``wait``) so that:

    - transient transport failures (ConnectionError / RuntimeError /
      OSError / BrokenPipeError) are retried with backoff, bounded by
      `PT_STORE_RETRY_S`; exhaustion raises `StorePartitioned`, which
      serve loops treat as "degrade, don't die";
    - `TimeoutError` from ``get``/``wait`` passes through UNRETRIED —
      across the codebase it is the normal "key absent yet" signal, not
      a failure;
    - every op executes on a background pump thread with a caller-side
      timed wait, so a *frozen* store server (SIGSTOP partition) cannot
      wedge a serve loop inside a native call that has no timeout
      (torch's ``add`` in particular) — the caller gets `StorePartitioned`
      while the thread parks on the dead socket;
    - the ``store.partition`` fault site is consulted once per attempt
      (actions: ``drop``/``raise``/``delay`` — a ``count=N`` rule
      partitions exactly N ops then heals);
    - bytes moved through the store are metered
      (``serve/store_bytes_in``/``_out``) so tests can assert the
      socket KV transport keeps the store byte curve ~flat;
    - `swap(new_raw)` atomically redirects to a different store
      endpoint (router failover): a fresh pump thread is spun up so a
      thread parked on the dead endpoint is simply abandoned.

    Attribute reads not defined here (``host``, ``port``) fall through
    to the raw store.
    """

    SITE = "store.partition"
    _MAX_BACKLOG = 64       # refuse new ops when this many are queued

    def __init__(self, raw, retry_s: Optional[float] = None,
                 policy: Optional[RetryPolicy] = None):
        if isinstance(raw, GuardedStore):      # idempotent wrap
            raw = raw.raw
        self.raw = raw
        self.retry_s = store_retry_s() if retry_s is None else float(retry_s)
        self.policy = policy or RetryPolicy(
            max_attempts=64, base_delay=0.02, max_delay=0.25,
            deadline=self.retry_s)
        self._lock = threading.Lock()
        self._gen = 0
        self._spawn_pump()

    # -- pump thread ----------------------------------------------------
    def _spawn_pump(self):
        self._queue = _queue.Queue()
        self._gen += 1
        t = threading.Thread(target=self._pump, args=(self._queue, self._gen),
                             name=f"guarded-store-{self._gen}", daemon=True)
        t.start()

    def _pump(self, q, gen):
        while True:
            item = q.get()
            if item is None:
                return
            fn, box, done = item
            try:
                box.append(("ok", fn()))
            except BaseException as e:          # noqa: BLE001 — relayed
                box.append(("err", e))
            done.set()
            if gen != self._gen:                # abandoned after swap()
                return

    _GRACE_S = 0.3          # post-deadline re-check window (see below)

    def _run_async(self, fn, wait: float):
        with self._lock:
            if self._queue.qsize() > self._MAX_BACKLOG:
                raise StorePartitioned(
                    f"store op backlog > {self._MAX_BACKLOG} "
                    f"(server unresponsive)")
            q, box, done = self._queue, [], threading.Event()
            q.put((fn, box, done))
        if not done.wait(wait):
            # The deadline is wall-clock, so a process-wide freeze
            # (SIGSTOP of a router that hosts its OWN store) ages the
            # op while neither the pump nor the server ran a single
            # instruction; on resume the op lands within milliseconds.
            # One short grace re-check separates "we were suspended"
            # from "the server is black-holing" — a real partition
            # just reaches its verdict _GRACE_S later.
            if not done.wait(self._GRACE_S):
                raise _OpStuck(f"store op unanswered after {wait:.2f}s")
        kind, val = box[0]
        if kind == "err":
            raise val
        return val

    # -- guarded op core ------------------------------------------------
    def _guarded(self, fn, op: str, wait: float):
        from paddle_tpu_torch import stats
        from paddle_tpu_torch.testing import faults

        def attempt():
            if faults.fire(self.SITE) == "drop":
                raise ConnectionError(
                    f"store partitioned (injected) at {op}")
            try:
                return self._run_async(fn, wait)
            except DeadlineExceeded:
                raise
            except TimeoutError as e:
                # key-absent (get/wait): builtin TimeoutError ⊂ OSError,
                # so without the wrapper it would be retried as a
                # transport error for the whole partition budget
                raise _KeyAbsent(e) from e

        try:
            return self.policy.run(
                attempt, op=op,
                retry_on=(ConnectionError, OSError, RuntimeError,
                          BrokenPipeError),
                deadline=Deadline(self.retry_s))
        except _KeyAbsent as e:
            raise e.err         # key-absent — normal control flow
        except DeadlineExceeded as e:       # retry budget burned by failures
            stats.add("resilience/store_partitions")
            raise StorePartitioned(f"store unreachable at {op}: {e}") from e
        except (_OpStuck, ConnectionError, OSError, RuntimeError) as e:
            stats.add("resilience/store_partitions")
            raise StorePartitioned(f"store unreachable at {op}: {e}") from e

    # -- TCPStore surface ----------------------------------------------
    def get(self, key: str, timeout: float = 30.0) -> bytes:
        from paddle_tpu_torch import stats
        out = self._guarded(
            lambda: self.raw.get(key, timeout=timeout),
            f"store.get({key})", wait=timeout + max(1.0, self.retry_s))
        stats.add("serve/store_bytes_in", len(out))
        return out

    def set(self, key: str, value) -> None:
        from paddle_tpu_torch import stats
        v = value.encode() if isinstance(value, str) else bytes(value)
        stats.add("serve/store_bytes_out", len(v))
        self._guarded(lambda: self.raw.set(key, v),
                      f"store.set({key})", wait=max(1.0, self.retry_s))

    def add(self, key: str, amount: int) -> int:
        # the store's add has NO per-call timeout — the pump thread is
        # what makes this safe to call against a frozen server.
        return self._guarded(lambda: self.raw.add(key, amount),
                             f"store.add({key})", wait=max(1.0, self.retry_s))

    def probe(self, key: str, wait: float = 0.3):
        """Single-attempt liveness read of a counter key: ``add(key, 0)``
        returns the current counter without bumping it. NEVER retried —
        this is the router-liveness probe (`RouterLink`) and its whole
        job is to answer "is the store reachable RIGHT NOW" in bounded
        time; backoff belongs to the caller's state machine. Returns the
        counter int, or None on any failure (unreachable, stuck, fault
        injection)."""
        from paddle_tpu_torch.testing import faults
        if faults.fire(self.SITE) == "drop":
            return None
        try:
            return self._run_async(lambda: self.raw.add(key, 0), wait)
        except BaseException:       # noqa: BLE001 — probe is best-effort
            return None

    def delete_key(self, key: str) -> bool:
        return self._guarded(lambda: self.raw.delete_key(key),
                             f"store.delete({key})",
                             wait=max(1.0, self.retry_s))

    def wait(self, keys, timeout: float = 30.0) -> None:
        self._guarded(lambda: self.raw.wait(keys, timeout=timeout),
                      "store.wait", wait=timeout + max(1.0, self.retry_s))

    def close(self) -> None:
        try:
            self._queue.put(None)
        except Exception:
            pass
        self.raw.close()

    # -- failover -------------------------------------------------------
    def swap(self, new_raw) -> None:
        """Redirect every future op to ``new_raw`` (a fresh TCPStore
        client on the new router generation's endpoint). The old pump
        thread — possibly parked on the dead endpoint — is abandoned."""
        from paddle_tpu_torch import stats
        if isinstance(new_raw, GuardedStore):
            new_raw = new_raw.raw
        with self._lock:
            old = self.raw
            self.raw = new_raw
            self._spawn_pump()
        stats.add("resilience/store_swaps")
        try:
            old.close()
        except Exception:
            pass

    def __getattr__(self, name):
        if name == "raw":
            raise AttributeError(name)
        return getattr(self.raw, name)
