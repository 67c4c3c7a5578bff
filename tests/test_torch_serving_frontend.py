"""The port's serving front end (``paddle_tpu_torch.serving``) against the
JAX package's, on the CPU, with a tiny fp32 GPT (2 layers, d 32, vocab
96, weights at std 0.5 from a numpy seed):

- the engines' service hooks: ``on_token`` in stream order (speculative
  emits included), ``on_retire`` once per request (evictions included),
  ``free_slots``, ``queued``, and ``bucket_policy`` (validated, and
  never consulted by the paged engine);
- one tick-paced trace (``replay_ticks``) with priorities and decidable
  deadlines (none, 1e-6 s, or far in the future) through JAX
  ``FrontEnd`` and the port's, on the plain, chunked
  (``steps_per_call=4``), speculative (``speculative_k=3``) and paged
  engines (JAX paged with ``mega=False``; the port's default
  single-dispatch engine): every request's status, error and stream,
  and the engine's submission order, equal under ``fifo``, ``priority``
  and ``edf``; the port's front-end streams equal its direct-submit
  streams;
- the admission rules: queue-full, expiry while queued and hopeless
  rejection (the EMA and the cold-start projection, under a frozen
  clock) as JAX decides them, and no prefill for a rejected request
  (the paged engine's K1 plain-version calls counted);
- ``projected_ttft`` / ``dynamic_bucket`` equal to JAX's over a grid of
  (remaining, occupancy); ``loadgen`` traces equal to JAX's for three
  seeds; ``RequestJournal`` round-trips; the handoff paths run.

The JAX runs are shared per engine kind (module-level cache): building
and compiling a JAX engine takes seconds."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference.decode_engine import DecodeEngine as JaxEngine
from paddle_tpu.inference.paged_engine import (
    PagedDecodeEngine as JaxPagedEngine)
from paddle_tpu.models import gpt as jax_gpt
from paddle_tpu.serving import loadgen as jax_loadgen
from paddle_tpu.serving import scheduler as jax_sched
from paddle_tpu_torch import stats
from paddle_tpu_torch.inference import paged_engine as pe
from paddle_tpu_torch.inference.decode_engine import DecodeEngine
from paddle_tpu_torch.inference.paged_engine import PagedDecodeEngine
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.models.convert import gpt_from_jax_state
from paddle_tpu_torch.serving import (FrontEnd, RequestJournal,
                                      dynamic_bucket, loadgen,
                                      projected_ttft)
from paddle_tpu_torch.serving import scheduler as sched
from paddle_tpu_torch.testing import faults
from torch_reference_compile import fast_reference_compiles  # noqa: F401

FIELDS = dict(vocab_size=96, max_seq_len=256, d_model=32, n_layers=2,
              n_heads=4)
SLOTS = 4
QUEUE_DEPTH = 6
FAR = 1e5           # a deadline no run reaches (seconds)
# engine kind -> the keyword arguments of both packages' engines
KINDS = {
    "plain": {},
    "chunked": {"steps_per_call": 4},
    "speculative": {"speculative_k": 3},
    "paged": {},
}
POLICIES = ("fifo", "priority", "edf")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    faults.clear()
    yield
    faults.clear()


def _models():
    jmodel = jax_gpt.GPT(jax_gpt.GPTConfig(dtype=jnp.float32, **FIELDS),
                         seed=0)
    rs = np.random.RandomState(0)
    state = {}
    for k, v in sorted(jmodel.state_dict().items()):
        noise = rs.randn(*v.shape).astype(np.float32)
        state[k] = (1.0 + 0.1 * noise) if "scale" in k else 0.5 * noise
    jmodel.set_state_dict({k: jnp.asarray(v) for k, v in state.items()})
    model = gpt_from_jax_state(gpt.GPTConfig(dtype=torch.float32, **FIELDS),
                               state, device="cpu")
    return jmodel, model


@pytest.fixture(scope="module")
def models():
    return _models()


def _port_engine(model, kind):
    if kind == "paged":
        return PagedDecodeEngine(model, n_pages=8, max_slots=SLOTS,
                                 device="cpu")
    return DecodeEngine(model, max_slots=SLOTS, max_len=256, device="cpu",
                        **KINDS[kind])


def _jax_engine(jmodel, kind):
    if kind == "paged":
        return JaxPagedEngine(jmodel, n_pages=8, max_slots=SLOTS,
                              mega=False)
    return JaxEngine(jmodel, max_slots=SLOTS, max_len=256, **KINDS[kind])


def _deadline(i):
    """Decidable deadlines: none, always expired (1e-6 s), or far in the
    future in an order that is not arrival order (edf reorders)."""
    if i % 5 == 1:
        return None
    if i % 5 == 3:
        return 1e-6
    return FAR * (1 + (7 * i) % 4)


def _trace(module):
    """16 arrivals at 4 a pump (queue-full rejections on every engine),
    priorities 0..2 out of arrival order."""
    arr = module.poisson_trace(16, 4.0, seed=3, vocab=96,
                               prompt_len=(4, 40), new_tokens=(3, 10))
    for i, a in enumerate(arr):
        a.priority = (2 * i) % 3
        a.deadline_s = _deadline(i)
    return arr


def _serve(front_end_cls, eng, arrivals, admission):
    """The trace through a front end over ``eng`` (tick-paced), recording
    the engine's submission order by request id."""
    order = []
    inner = eng.submit

    def submit_in_order(*args, **kw):
        order.append(kw["req_id"])
        return inner(*args, **kw)

    eng.submit = submit_in_order
    fe = front_end_cls(eng, queue_depth=QUEUE_DEPTH, admission=admission)
    handles = jax_loadgen.replay_ticks(
        arrivals, lambda a: fe.submit(a.prompt,
                                      max_new_tokens=a.max_new_tokens,
                                      deadline_s=a.deadline_s,
                                      priority=a.priority), fe.step)
    fe.run()
    eng.submit = inner
    return {"status": [h.status for h in handles],
            "error": [h.error for h in handles],
            "tokens": [[int(t) for t in h.tokens] for h in handles],
            "order": order, "handles": handles}


# one engine per (package, kind), reused by the three policies in turn
# (prompts under a page: no prefix-cache hit carries over)
_RUNS = {}


def _runs(models, kind, package):
    key = (kind, package)
    if key not in _RUNS:
        jmodel, model = models
        if package == "jax":
            eng, cls, arr = (_jax_engine(jmodel, kind), jax_sched.FrontEnd,
                             _trace(jax_loadgen))
        else:
            eng, cls, arr = (_port_engine(model, kind), FrontEnd,
                             _trace(loadgen))
        _RUNS[key] = {p: _serve(cls, eng, arr, p) for p in POLICIES}
    return _RUNS[key]


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_frontend_matches_jax_frontend(models, kind):
    want, got = _runs(models, kind, "jax"), _runs(models, kind, "port")
    for policy in POLICIES:
        w, g = want[policy], got[policy]
        for field in ("status", "error", "tokens", "order"):
            assert g[field] == w[field], (policy, field)
        # the trace exercises every outcome
        assert set(g["status"]) == {"done", "rejected-deadline",
                                    "rejected-queue-full"}, policy
    # the policies admit in different orders
    orders = {tuple(got[p]["order"]) for p in POLICIES}
    assert len(orders) == 3


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_frontend_streams_equal_direct_submission(models, kind):
    """Every done request's front-end stream equals a direct
    ``engine.submit`` + ``run`` of its prompt, token for token."""
    _, model = models
    run = _runs(models, kind, "port")["priority"]
    done = [h for h in run["handles"] if h.status == "done"]
    eng = _port_engine(model, kind)
    reqs = [eng.submit(h.prompt, max_new_tokens=h.max_new_tokens)
            for h in done]
    eng.run()
    assert [h.tokens for h in done] == [r.tokens for r in reqs]
    assert all(len(h.tokens) == h.max_new_tokens for h in done)


def test_stream_pumps_and_yields_in_harvest_order(models):
    _, model = models
    fe = FrontEnd(_port_engine(model, "speculative"))
    reqs = [fe.submit(p, max_new_tokens=9)
            for p in ([5, 6, 7, 5, 6, 7, 5, 6], [1, 2, 3])]
    got = list(reqs[1].stream())
    assert got == reqs[1].tokens and len(got) == 9
    assert reqs[1].status == "done"
    fe.run()
    assert not fe.busy and [r.status for r in fe.results()] == ["done"] * 2


# -- the engines' hooks ---------------------------------------------------

@pytest.mark.parametrize("kind", sorted(KINDS))
def test_hooks_fire_in_stream_order_and_retire_once(models, kind):
    """``on_token`` sees each request's stream in order (speculative
    emits included) and ``on_retire`` fires once per request, an
    evicted one included; ``free_slots`` and ``queued`` track the
    engine."""
    _, model = models
    eng = _port_engine(model, kind)
    seen, retired = {}, []
    eng.on_token = lambda r, t: seen.setdefault(id(r), []).append(t)
    eng.on_retire = retired.append
    assert eng.free_slots == SLOTS and eng.queued == 0
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in
            (([5, 6, 7, 5, 6, 7, 5, 6], 11), ([1, 2, 3], 12), ([9] * 7, 6),
             ([3, 1, 4, 1, 5], 7), ([2, 7, 1, 8], 5))]
    assert eng.queued == 5
    eng.step()
    assert eng.free_slots == 0 and eng.queued == 1
    # the slot-1 request (12 new tokens) is live in the second dispatch
    with faults.inject("engine.poison_logits", "nan", slot=1, count=1):
        eng.step()
    eng.run()
    assert eng.free_slots == SLOTS and eng.queued == 0
    assert [r.error for r in reqs] == [None, "non-finite logits", None,
                                       None, None]
    for r in reqs:
        assert seen.get(id(r), []) == r.tokens
        assert sum(x is r for x in retired) == 1


def test_retire_fires_for_a_request_expired_in_the_engine_queue(models):
    _, model = models
    eng = _port_engine(model, "plain")
    retired = []
    eng.on_retire = retired.append
    r = eng.submit([1, 2, 3], max_new_tokens=3, deadline_s=1e-6)
    eng.run()
    assert retired == [r] and r.error == "deadline exceeded while queued"


def test_bucket_policy_is_validated_and_paged_never_consults_it(models):
    _, model = models
    eng = _port_engine(model, "plain")
    eng.bucket_policy = lambda e, remaining: 48
    eng.submit([1] * 20, max_new_tokens=2)
    with pytest.raises(ValueError, match="bucket_policy returned 48"):
        eng.run()
    # a valid override takes effect: 40 prompt tokens in 16-token chunks
    stats.reset()
    eng = _port_engine(model, "plain")
    calls = []
    eng.bucket_policy = lambda e, remaining: calls.append(remaining) or 16
    r = eng.submit(list(range(40)), max_new_tokens=3)
    eng.run()
    assert calls == [40, 24, 8] and r.done and not r.failed
    assert stats.get("serve/dispatches/prefill") == 3
    paged = _port_engine(model, "paged")

    def refuse(e, remaining):
        raise AssertionError("the paged engine consulted bucket_policy")

    paged.bucket_policy = refuse
    paged.submit(list(range(40)), max_new_tokens=3)
    paged.run()


# -- admission rules ------------------------------------------------------

class _Clock:
    """``time`` for the scheduler module: a frozen monotonic clock (the
    wall clock's perf_counter stays real)."""

    def __init__(self, now):
        self.now = now

    def monotonic(self):
        return self.now

    def perf_counter(self):
        import time
        return time.perf_counter()


def _hopeless_case(module, eng, monkeypatch):
    """Under a frozen clock: a cold-start request judged against the
    projection, then against a held EMA of observed TTFTs."""
    monkeypatch.setattr(module, "time", _Clock(1000.0))
    fe = module.FrontEnd(eng, queue_depth=8, admission="fifo")
    est = module.projected_ttft(eng, 20, 32)
    cold = [fe.submit([1] * 20, max_new_tokens=2, deadline_s=d)
            for d in (0.5 * est, 2.0 * est)]
    fe._feed()
    fe._ttft_ema = 0.5
    held = [fe.submit([2] * 20, max_new_tokens=2, deadline_s=d)
            for d in (0.4, 0.6, None)]
    fe._feed()
    return [(r.status, r.error) for r in cold + held], fe


def test_hopeless_rejection_matches_jax(models, monkeypatch):
    jmodel, model = models
    stats.reset()
    got, fe = _hopeless_case(sched, _port_engine(model, "plain"),
                             monkeypatch)
    want, _ = _hopeless_case(jax_sched, _jax_engine(jmodel, "plain"),
                             monkeypatch)
    assert got == want
    assert [s for s, _ in got] == ["rejected-deadline", "admitted",
                                   "rejected-deadline", "admitted",
                                   "admitted"]
    assert "projected TTFT" in got[0][1] and "observed TTFT" in got[2][1]
    assert stats.get("serve/queue_hopeless_rejects") == 2
    assert fe.engine.queued == 3


def test_rejections_cost_no_prefill(models, monkeypatch):
    """Queue-full, expiry while queued and hopeless rejections reach no
    prefill: the paged engine's K1 call site (plain version on the CPU)
    runs L times for each admitted request only."""
    _, model = models
    calls = []
    k1 = pe.scaled_dot_product_attention

    def counted(*args, **kw):
        calls.append(1)
        return k1(*args, **kw)

    monkeypatch.setattr(pe, "scaled_dot_product_attention", counted)
    stats.reset()
    fe = FrontEnd(_port_engine(model, "paged"), queue_depth=5,
                  admission="priority", hopeless_factor=1e9)
    prompts = [[i + 1] * (4 + i) for i in range(7)]
    reqs = [fe.submit(p, max_new_tokens=3,
                      deadline_s=(1e-6 if i == 1 else
                                  30.0 if i == 2 else None),
                      priority=i)
            for i, p in enumerate(prompts)]
    fe.run()
    assert [r.status for r in reqs] == [
        "done", "rejected-deadline", "rejected-deadline", "done", "done",
        "rejected-queue-full", "rejected-queue-full"]
    assert reqs[1].error == "deadline exceeded while queued"
    assert reqs[2].error.startswith("deadline hopeless at admission")
    assert all(r.engine_req is None for r in reqs if r.failed)
    assert len(calls) == FIELDS["n_layers"] * 3
    assert stats.get("serve/queue_rejects") == 2
    assert stats.get("serve/queue_deadline_rejects") == 1
    assert stats.get("serve/queue_hopeless_rejects") == 1


def test_frontend_options_are_checked(models, monkeypatch):
    _, model = models
    with pytest.raises(ValueError, match="fifo|priority|edf"):
        FrontEnd(_port_engine(model, "plain"), admission="lifo")
    monkeypatch.setenv("PT_SERVE_QUEUE_DEPTH", "3")
    monkeypatch.setenv("PT_SERVE_ADMISSION", "edf")
    fe = FrontEnd(_port_engine(model, "plain"))
    assert (fe.queue_depth, fe.admission) == (3, "edf")
    assert fe.engine.bucket_policy is dynamic_bucket
    with pytest.raises(ValueError, match="exceed cache length"):
        fe.submit([1] * 250, max_new_tokens=10)


# -- the bucket policy ----------------------------------------------------

def test_projected_ttft_and_dynamic_bucket_match_jax(models):
    """On the port's own engines, slots bound by hand: the port's
    functions and the JAX package's (plain Python over the same engine
    attributes) agree over (remaining, occupancy)."""
    _, model = models
    for eng in (_port_engine(model, "chunked"),
                DecodeEngine(model, max_slots=SLOTS, max_len=256,
                             prefill_tokens=64, device="cpu"),
                _port_engine(model, "paged")):
        for live in range(SLOTS + 1):
            eng._slot_req[:] = [object()] * live + [None] * (SLOTS - live)
            for remaining in (1, 15, 16, 17, 40, 64, 100, 129, 250):
                assert dynamic_bucket(eng, remaining) == (
                    jax_sched.dynamic_bucket(eng, remaining))
                for b in eng.buckets:
                    assert projected_ttft(eng, remaining, b) == (
                        jax_sched.projected_ttft(eng, remaining, b))
        eng._slot_req[:] = [None] * SLOTS


# -- the load generator, the journal, the handoff paths --------------------

@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_loadgen_traces_match_jax(seed, monkeypatch):
    kw = dict(vocab=500, prompt_len=(16, 192), new_tokens=(16, 96),
              deadline_s=2.5)
    got = loadgen.poisson_trace(32, 3.7, seed=seed, **kw)
    want = jax_loadgen.poisson_trace(32, 3.7, seed=seed, **kw)
    assert [vars(a) for a in got] == [vars(a) for a in want]
    monkeypatch.setenv("PT_SERVE_LOADGEN_SEED", str(seed))
    assert loadgen.default_seed() == seed
    assert ([vars(a) for a in loadgen.poisson_trace(5, 1.0)]
            == [vars(a) for a in jax_loadgen.poisson_trace(5, 1.0)])
    rows = [{"t": a.t, "prompt": a.prompt, "max_new_tokens": a.max_new_tokens,
             "priority": i % 3, **({"deadline_s": 1.0} if i % 2 else {})}
            for i, a in enumerate(reversed(got))]
    assert ([vars(a) for a in loadgen.from_trace(rows)]
            == [vars(a) for a in jax_loadgen.from_trace(rows)])
    with pytest.raises(ValueError, match="qps > 0"):
        loadgen.poisson_trace(3, 0.0)


def test_replay_paces_arrivals():
    arr = loadgen.poisson_trace(6, 2.0, seed=1)
    pumps = []
    got = loadgen.replay_ticks(arr, lambda a: a.t,
                               lambda: pumps.append(1), tick_s=0.5)
    want_pumps = []
    jax_loadgen.replay_ticks(arr, lambda a: a.t,
                             lambda: want_pumps.append(1), tick_s=0.5)
    assert got == [a.t for a in arr] and len(pumps) == len(want_pumps)
    fast = loadgen.poisson_trace(3, 1e6, seed=1)
    assert loadgen.replay(fast, lambda a: a.max_new_tokens) == [
        a.max_new_tokens for a in fast]


def test_request_journal_round_trips(tmp_path):
    path = str(tmp_path / "journal.jsonl")
    j = RequestJournal(path)
    j.append_submit({"id": "rq-1", "prompt": [1, 2], "max_new_tokens": 4})
    j.append_submit({"id": "rq-2", "prompt": [3], "max_new_tokens": 2})
    j.append_result("rq-1", {"status": "done", "tokens": [5, 6, 7, 8]})
    j.close()
    with open(path, "a") as f:
        f.write('{"kind": "result", "id": "rq-2", "res')   # a torn tail
    got = RequestJournal.replay(path)
    assert got == jax_sched.RequestJournal.replay(path)
    payloads, results = got
    assert payloads == {"rq-1": {"id": "rq-1", "prompt": [1, 2],
                                 "max_new_tokens": 4},
                        "rq-2": {"id": "rq-2", "prompt": [3],
                                 "max_new_tokens": 2}}
    assert results == {"rq-1": {"status": "done", "tokens": [5, 6, 7, 8]}}
    assert RequestJournal.replay(str(tmp_path / "none")) == ({}, {})


@pytest.mark.parametrize("kind", ["plain", "paged"])
def test_handoff_paths_raise_until_ported(models, kind):
    """Ported since: the handoff paths run through the engines. A queued
    request migrates without KV; a live one detaches with its KV
    (``{"kv": True, ...}``) and, handed to a second front end, finishes
    the stream it had (held against JAX in test_torch_handoff.py)."""
    _, model = models
    direct = _port_engine(model, kind)
    ref = direct.submit([1] * 5, max_new_tokens=8)
    direct.run()
    fe = FrontEnd(_port_engine(model, kind), admit_ahead=0)
    reqs = [fe.submit([i + 1] * 5, max_new_tokens=8)
            for i in range(SLOTS + 1)]
    fe.step()
    fe.step()
    queued = reqs[-1]
    assert queued.status == "queued"
    assert fe.detach_migrate(queued) == {"kv": False}
    assert queued.status == "migrated" and queued.done
    live = reqs[0]
    assert live.status == "admitted"
    got = fe.detach_migrate(live)
    assert got["kv"] is True and live.status == "migrated" and live.done
    dst = FrontEnd(_port_engine(model, kind))
    moved = dst.submit_handoff(got["meta"], got["k"], got["v"])
    assert list(moved.stream()) == ref.tokens and moved.status == "done"
    fe.run()
    assert [r.status for r in reqs[1:]] == ["done"] * (SLOTS - 1) + [
        "migrated"]


def test_frontend_installs_hooks_and_keeps_a_set_policy():
    def policy(engine, remaining):
        return 16

    for dynamic, set_policy, want in ((False, None, None),
                                      (True, None, dynamic_bucket),
                                      (True, policy, policy)):
        eng = types.SimpleNamespace(on_token=None, on_retire=None,
                                    bucket_policy=set_policy)
        fe = FrontEnd(eng, queue_depth=1, admission="fifo",
                      dynamic_buckets=dynamic)
        assert eng.on_token == fe._on_token
        assert eng.on_retire == fe._on_retire
        assert eng.bucket_policy is want
