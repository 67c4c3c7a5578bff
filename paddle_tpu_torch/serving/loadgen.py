"""Deterministic load generation for the serving front end (counterpart
of ``paddle_tpu/serving/loadgen.py``; numpy only, and the same arrivals
as the JAX package's for a given seed).

Two sources, one shape: a list of :class:`Arrival` records (arrival
offset in seconds, prompt, decode budget, optional deadline and
priority).

- :func:`poisson_trace`: open-loop Poisson traffic at an offered QPS:
  exponential gaps, uniform prompt and decode lengths, all drawn from
  ONE seeded ``RandomState``, so a (seed, qps, n) triple gives the same
  workload in every process.
- :func:`from_trace`: recorded traffic (dicts with ``t``, ``prompt``,
  ``max_new_tokens``, ...), for replaying request logs.

:func:`replay` paces the arrivals against the wall clock, open loop (a
late server does not slow the generator down, which would hide the
queueing collapse a load test exists to show), and pumps the front end
while it waits. :func:`replay_ticks` paces them by pump calls instead,
for checks that must hold under any host load.
"""

import os
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np

__all__ = ["Arrival", "poisson_trace", "from_trace", "replay",
           "replay_ticks", "default_seed"]


def default_seed() -> int:
    """The load generator's seed (``PT_SERVE_LOADGEN_SEED``)."""
    return int(os.environ.get("PT_SERVE_LOADGEN_SEED", "0"))


@dataclass
class Arrival:
    t: float                    # seconds after replay start
    prompt: List[int]
    max_new_tokens: int
    deadline_s: Optional[float] = None
    priority: int = 0


def poisson_trace(n: int, qps: float, seed: Optional[int] = None,
                  vocab: int = 96, prompt_len=(4, 48),
                  new_tokens=(4, 24),
                  deadline_s: Optional[float] = None) -> List[Arrival]:
    """``n`` arrivals at offered rate ``qps`` (exponential gaps, the
    first at t = 0), prompt lengths and budgets uniform over the given
    ``[lo, hi]`` ranges. Deterministic in (seed, n, qps, ranges)."""
    if n < 1 or qps <= 0:
        raise ValueError(f"need n >= 1 arrivals at qps > 0, "
                         f"got n={n} qps={qps}")
    rs = np.random.RandomState(default_seed() if seed is None else seed)
    gaps = rs.exponential(1.0 / qps, size=n)
    gaps[0] = 0.0
    times = np.cumsum(gaps)
    out = []
    for i in range(n):
        plen = int(rs.randint(prompt_len[0], prompt_len[1] + 1))
        out.append(Arrival(
            t=float(times[i]),
            prompt=[int(x) for x in rs.randint(0, vocab, size=plen)],
            max_new_tokens=int(rs.randint(new_tokens[0],
                                          new_tokens[1] + 1)),
            deadline_s=deadline_s))
    return out


def from_trace(rows: Sequence[dict]) -> List[Arrival]:
    """Arrivals from recorded rows (``t`` seconds, ``prompt``,
    ``max_new_tokens``, optional ``deadline_s`` / ``priority``), sorted
    by arrival time."""
    out = [Arrival(t=float(r["t"]), prompt=list(r["prompt"]),
                   max_new_tokens=int(r["max_new_tokens"]),
                   deadline_s=r.get("deadline_s"),
                   priority=int(r.get("priority", 0)))
           for r in rows]
    return sorted(out, key=lambda a: a.t)


def replay(arrivals: Sequence[Arrival], submit: Callable,
           pump: Optional[Callable] = None, speed: float = 1.0) -> list:
    """Open-loop replay: submit each arrival at its wall-clock offset
    (divided by ``speed``), calling ``pump()`` (typically
    ``frontend.step``) while waiting. Returns the ``submit`` results in
    arrival order; draining after the last arrival is the caller's
    job."""
    handles = []
    t0 = time.perf_counter()
    for a in arrivals:
        due = a.t / speed
        while time.perf_counter() - t0 < due:
            if pump is not None:
                pump()
            else:
                time.sleep(0.001)
        handles.append(submit(a))
    return handles


def replay_ticks(arrivals: Sequence[Arrival], submit: Callable,
                 pump: Callable, tick_s: float = 1.0) -> list:
    """Closed-clock replay: the clock advances ``tick_s`` virtual
    seconds a ``pump()`` call instead of reading the wall clock, so the
    interleaving of arrivals and serving steps is a function of the
    trace alone, whatever the host's load. A trace generated at
    ``qps=q`` and replayed at ``tick_s=1.0`` offers ``q`` arrivals a
    pump call."""
    handles = []
    vt = 0.0
    for a in arrivals:
        while vt < a.t:
            pump()
            vt += tick_s
        handles.append(submit(a))
    return handles
