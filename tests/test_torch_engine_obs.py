"""The serving engines' own instrumentation against the JAX engines, on
the CPU, with weights at std 0.5 (as the engine parity tests draw them)
from numpy seeds: the multiset of trace spans (name and non-time
attributes) and each request's flight events equal JAX's for the
contiguous engine and the paged engine (JAX ``mega=False``; the port's
single-dispatch default too, which has no JAX counterpart here); a
poisoned slot evicted alone with the same reason, stat and streams, by
``faults.inject`` and by ``PT_FAULTS``; ``warmup()`` leaving the streams
as an unwarmed engine's; ``dispatch_cost`` equal to a hand count
(printed beside JAX's one-step capture, within a factor 4 of it);
``dispatch_fn_args``; and ``paddle_tpu_torch.tools.profile_decode``'s
sections at ``PD_SIZE=tiny`` on ``--device cpu``."""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import stats as jstats
from paddle_tpu.inference.decode_engine import DecodeEngine as JaxEngine
from paddle_tpu.inference.paged_engine import (
    PagedDecodeEngine as JaxPagedEngine)
from paddle_tpu.models import gpt as jax_gpt
from paddle_tpu.observability import flight as jflight
from paddle_tpu.observability import trace as jtrace
from paddle_tpu.testing import faults as jfaults
from paddle_tpu_torch import stats
from paddle_tpu_torch.inference.decode_engine import DecodeEngine, Request
from paddle_tpu_torch.inference.paged_engine import PagedDecodeEngine
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.models.convert import gpt_from_jax_state
from paddle_tpu_torch.observability import devprof, flight, trace
from paddle_tpu_torch.testing import faults

WEIGHT_STD = 0.5
FIELDS = dict(vocab_size=96, max_seq_len=256, d_model=32, n_layers=2,
              n_heads=4)
# the port's capture is the whole steps_per_call-step dispatch, JAX's
# one scan step of XLA's cost analysis, which also counts the elementwise
# work: within this factor of each other at steps_per_call 2
JAX_FLOPS_FACTOR = 4.0


# the tracers' default ring: a test elsewhere in the process may leave a
# smaller one (test_observability.py's overflow test keeps the JAX
# tracer at 8 events), which would drop the spans compared here
TRACE_RING = 65536


@pytest.fixture(autouse=True)
def _clean():
    torch.set_num_threads(1)
    for mod in (trace, jtrace):
        mod.disable()
        mod.clear(capacity=TRACE_RING)
    for mod in (faults, jfaults):
        mod.clear()
    for mod in (stats, jstats):
        mod.reset()
    for mod in (flight, jflight):
        mod.reset()
    yield
    for mod in (trace, jtrace):
        mod.disable()
        mod.clear()
    for mod in (faults, jfaults):
        mod.clear()
    for mod in (flight, jflight):
        mod.reset()


@pytest.fixture(scope="module")
def models():
    jmodel = jax_gpt.GPT(jax_gpt.GPTConfig(dtype=jnp.float32, **FIELDS),
                         seed=0)
    rs = np.random.RandomState(0)
    state = {}
    for k, v in sorted(jmodel.state_dict().items()):
        noise = rs.randn(*v.shape).astype(np.float32)
        state[k] = (1.0 + 0.1 * noise) if "scale" in k else (
            WEIGHT_STD * noise)
    jmodel.set_state_dict({k: jnp.asarray(v) for k, v in state.items()})
    model = gpt_from_jax_state(gpt.GPTConfig(dtype=torch.float32, **FIELDS),
                               state, device="cpu")
    return jmodel, model


def _prompts(seed=3, sizes=(5, 23, 40, 9)):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 96, size=n).tolist() for n in sizes]


# the engines under test: name -> (JAX engine, port engine) factories
ENGINES = {
    "contiguous": (
        lambda m: JaxEngine(m, max_slots=2, max_len=128, buckets=(16, 32),
                            steps_per_call=2),
        lambda m, **kw: DecodeEngine(m, max_slots=2, max_len=128,
                                     buckets=(16, 32), steps_per_call=2,
                                     device="cpu", **kw)),
    "paged": (
        lambda m: JaxPagedEngine(m, n_pages=8, max_slots=2,
                                 steps_per_call=2, mega=False),
        lambda m, **kw: PagedDecodeEngine(m, n_pages=8, max_slots=2,
                                          steps_per_call=2, mega=False,
                                          device="cpu", **kw)),
    "paged_mega": (
        lambda m: JaxPagedEngine(m, n_pages=8, max_slots=2,
                                 steps_per_call=2, mega=False),
        lambda m, **kw: PagedDecodeEngine(m, n_pages=8, max_slots=2,
                                          steps_per_call=2, mega=True,
                                          device="cpu", **kw)),
}


def _serve(eng, prompts, n_new=7):
    """Two requests, two steps, two more: staggered admissions."""
    reqs = [eng.submit(p, n_new, req_id=f"req-{i}")
            for i, p in enumerate(prompts[:2])]
    eng.step()
    eng.step()
    reqs += [eng.submit(p, n_new, req_id=f"req-{i + 2}")
             for i, p in enumerate(prompts[2:])]
    eng.run()
    return reqs


def _span_multiset(events):
    return collections.Counter(
        (e[0], tuple(sorted((e[6] or {}).items()))) for e in events)


def _flight_events(mod, rid):
    return [{k: v for k, v in e.items() if k != "t"}
            for e in mod.events(rid)]


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_spans_and_flight_equal_jax(models, kind):
    jmodel, model = models
    make_j, make_p = ENGINES[kind]
    prompts = _prompts()
    jtrace.enable()
    jreqs = _serve(make_j(jmodel), prompts)
    jtrace.disable()
    trace.enable()
    reqs = _serve(make_p(model), prompts)
    trace.disable()
    for r, jr in zip(reqs, jreqs):
        assert r.tokens == [int(t) for t in jr.tokens]
        assert r.rid == jr.rid and len(set(r.tokens)) > 1
    got = _span_multiset(trace.events()[0])
    ref = _span_multiset(jtrace.events()[0])
    assert got == ref
    names = {n for n, _ in got}
    assert {"serve/step", "serve/dispatch", "serve/harvest", "serve/queue",
            "serve/admit", "serve/request", "serve/decode"} <= names
    for r in reqs:
        assert _flight_events(flight, r.rid) == _flight_events(jflight,
                                                                r.rid)
        assert _flight_events(flight, r.rid)[0]["event"] == "admit"


def _poison_run(eng, mod, st, inject):
    rs = np.random.RandomState(11)
    p0, p1 = rs.randint(0, 96, size=5), rs.randint(0, 96, size=6)
    st.reset("serve/")
    r0 = eng.submit(p0, max_new_tokens=8, req_id="ok")
    r1 = eng.submit(p1, max_new_tokens=8, req_id="bad")
    if inject:
        with mod.inject("engine.poison_logits", "nan", slot=1, after=1,
                        count=1):
            eng.run()
    else:
        eng.run()
    return (r1.error, int(st.get("serve/nonfinite_evictions")),
            [int(t) for t in r0.tokens], [int(t) for t in r1.tokens],
            r0.failed)


@pytest.mark.parametrize("way", ["inject", "env"])
@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_poisoned_slot_evicted_as_in_jax(models, kind, way, monkeypatch,
                                         capsys):
    jmodel, model = models
    make_j, make_p = ENGINES[kind]
    if way == "env":
        monkeypatch.setenv(
            "PT_FAULTS", "engine.poison_logits:nan:slot=1,after=1,count=1")
        assert jfaults.install_from_env() == 1
        assert faults.install_from_env() == 1
    ref = _poison_run(make_j(jmodel), jfaults, jstats, way == "inject")
    got = _poison_run(make_p(model), faults, stats, way == "inject")
    assert got == ref
    assert got[0] == "non-finite logits" and got[1] == 1
    assert len(got[2]) == 8 and not got[4]
    events = [e["event"] for e in flight.events("bad")]
    assert events[0] == "admit" and events[-1] == "evicted"
    assert stats.get("serve/flight_dumps") == 1
    assert '"rid": "bad"' in capsys.readouterr().err


def test_no_fault_plan_is_one_cached_mask(models):
    _, model = models
    eng = ENGINES["paged_mega"][1](model)
    mask = eng._poison_mask()
    assert mask is eng._poison_mask() and mask.dtype == torch.int32
    assert not mask.any()
    logits = torch.randn(2, 96)
    assert eng._poison(logits, mask) is logits
    with faults.inject("engine.poison_logits", "nan", slot=0):
        poisoned = eng._poison_mask()
    assert poisoned is not mask and poisoned.tolist() == [1, 0]
    out = eng._poison(logits, poisoned)
    assert torch.isnan(out[0]).all() and torch.equal(out[1], logits[1])


@pytest.mark.parametrize("kind, kw", [
    ("contiguous", {}),
    ("contiguous", dict(temperature=0.8, top_k=20, seed=3)),
    ("paged", {}),
    ("paged_mega", {}),
])
def test_warmup_leaves_streams_unchanged(models, kind, kw):
    _, model = models
    make = ENGINES[kind][1]
    streams = []
    for warm in (False, True):
        stats.reset("serve/")
        eng = make(model, warmup=warm, **kw)
        assert stats.get("serve/warmup_s") == int(warm)
        streams.append([r.tokens for r in _serve(eng, _prompts())])
        if warm:
            eng.warmup()        # again, on a used engine
            streams.append([r.tokens for r in _serve(eng, _prompts(4))])
        else:
            streams.append([r.tokens for r in _serve(eng, _prompts(4))])
    assert streams[0] == streams[2] and streams[1] == streams[3]


# -- dispatch_cost: a hand count ----------------------------------------------

def _hand_block_step(S, keys, d, H, hkv, hd, V, L, e=4):
    """One decode step's flops and bytes over S slots attending ``keys``
    keys each: per layer the four dense products (2 M N K flops; both
    operands and the output moved once) and the attention (4 flops per
    head dim per (query head, key); K and V of every key, q and o, the
    lengths), then the LM head."""
    flops = nbytes = 0
    for k, n in ((d, d + 2 * hkv * hd), (d, d), (d, 4 * d), (4 * d, d)):
        flops += L * 2 * S * k * n
        nbytes += L * (k * n + S * k + S * n) * e
    flops += L * 4 * sum(keys) * H * hd
    nbytes += L * (2 * sum(keys) * hkv * hd * e + 2 * S * H * hd * e
                   + S * 4)
    flops += 2 * S * d * V
    nbytes += (d * V + S * d + S * V) * e
    return flops, nbytes


def _cost_engines(model, jmodel, kind):
    cfg = dict(max_slots=2, steps_per_call=2)
    if kind == "contiguous":
        return (DecodeEngine(model, max_len=64, device="cpu", **cfg),
                JaxEngine(jmodel, max_len=64, **cfg))
    return (PagedDecodeEngine(model, n_pages=8, mega=kind == "paged_mega",
                              device="cpu", **cfg),
            JaxPagedEngine(jmodel, n_pages=8, mega=False, **cfg))


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_dispatch_cost_equals_hand_count(models, kind):
    jmodel, model = models
    eng, jeng = _cost_engines(model, jmodel, kind)
    for e in (eng, jeng):
        e.submit([1, 2, 3, 4, 5], max_new_tokens=12)
        e.submit([7, 8, 9], max_new_tokens=3)
        e.step()
        e.step()
        e.drain()
    S, d, H, hkv, hd, V, L = 2, 32, 4, 4, 8, 96, 2
    lens, act = eng.lengths.tolist(), eng.active.tolist()
    assert act.count(True) == 1             # one live, one retired slot
    flops = nbytes = 0
    for j in range(2):
        pos = [n + j * a for n, a in zip(lens, act)]
        if kind == "contiguous":
            f, b = _hand_block_step(S, [p + 1 for p in pos], d, H, hkv,
                                    hd, V, L)
            b += L * 2 * S * hkv * hd * 4        # the fresh rows written
        elif kind == "paged":
            # K2 attends the cached keys and the fresh row (flops as
            # over pos + 1 keys) but reads K/V only of the cached ones,
            # 8 int32 words per row (table and length) in place of one,
            # and reads the fresh row and writes it into its page
            f, b = _hand_block_step(S, [p + 1 for p in pos], d, H, hkv,
                                    hd, V, L)
            b += L * (-2 * S * hkv * hd * 4 + (8 - 1) * S * 4
                      + 4 * S * hkv * hd * 4)
        else:
            slab = L * (2 * d + d * 3 * d + 3 * d + d * d + d + 2 * d
                        + d * 4 * d + 4 * d + 4 * d * d + d) * 4
            keys = [p + 1 for p in pos]
            f = (2 * S * L * 12 * d * d + 4 * sum(keys) * H * hd * L
                 + 2 * S * d * V)
            b = (slab + 2 * sum(keys) * hkv * hd * 4 * L
                 + 2 * S * hkv * hd * 4 * L + 2 * S * d * 4 + 16 * S
                 + V * d * 4 + S * d * 4 + 2 * d * 4 + 3 * S * 4)
        flops += f
        nbytes += b
    cap = eng.dispatch_cost()
    assert cap.name == ("decode" if kind == "contiguous" else "paged")
    assert (cap.flops, cap.hbm_bytes) == (flops, nbytes)
    assert stats.get(f"prof/flops/{cap.name}") == flops
    assert cap.memory["argument_size_in_bytes"] > 0
    assert cap.memory["output_size_in_bytes"] == (3 * 2 + 4) * S * 4
    jcap = jeng.dispatch_cost()
    print(f"{kind}: port dispatch flops {cap.flops:.0f} (2 steps), JAX "
          f"one-step capture {jcap.flops:.0f}")
    assert (jcap.flops / JAX_FLOPS_FACTOR <= cap.flops
            <= jcap.flops * JAX_FLOPS_FACTOR)
    # nothing ran: the engine still serves its live request to the end
    before = [r.tokens[:] for r in eng._slot_req if r is not None]
    eng.run()
    assert before and all(len(t) > 0 for t in before)


def test_dispatch_fn_args_runs_one_dispatch(models):
    _, model = models
    for eng in (ENGINES["contiguous"][1](model),
                ENGINES["paged_mega"][1](model)):
        eng.submit([1, 2, 3], max_new_tokens=2)
        eng.run()
        fn, args = eng.dispatch_fn_args()
        assert devprof.count_kernel_launches(fn, *args) == 0   # CPU
        packed = fn(*args)[-1]
        assert tuple(packed.shape) == (3, eng.chunk, eng.S)
        assert not packed[1].any()             # no live slot emits
        r = eng.submit([4, 5, 6], max_new_tokens=3, req_id="after")
        eng.run()
        assert len(r.tokens) == 3 and r.rid == "after"


def test_request_carries_its_trace_context():
    assert Request([1], 2, None).rid is None
    assert Request([1], 2, None, rid="x").rid == "x"


# -- profile_decode on the CPU ------------------------------------------------

@pytest.mark.parametrize("section, needles", [
    ("engine", ("slots=8 ctx=128+128:", "pipeline: depth=2")),
    ("paged", ("paged slots=4 ctx=128+16:", "prefix: hit_rate",
               "warm:")),
    ("prof", ("launch tax: torch x+1", "prof contiguous len=32:",
              "prof paged len=128:", "step split:")),
    ("mega", ("mega mega: launches/step=0", "mega per_layer:",
              "mega gate: skipped on the CPU")),
])
def test_profile_decode_sections_on_cpu(section, needles, monkeypatch,
                                        capsys):
    from paddle_tpu_torch.tools import profile_decode
    monkeypatch.setenv("PD_SIZE", "tiny")
    monkeypatch.setenv("PD_SECTIONS", section)
    monkeypatch.setenv("PD_PREFIX", "1")
    monkeypatch.setenv("PT_PROF_PEAK_FLOPS", "989.4e12")
    monkeypatch.setenv("PT_PROF_PEAK_HBM_GBPS", "3350")
    profile_decode.main(["--device", "cpu"])
    out = capsys.readouterr().out
    for needle in needles:
        assert needle in out, out
    assert not trace.enabled()


def test_profile_decode_spec_rows_raise(monkeypatch, capsys):
    """Ported since (the name is the one the rows had while they raised):
    ``PD_SPEC=1`` runs the mega section's ``mega_spec`` row and the
    engine section's speculative run, on a tiny model on the CPU."""
    from paddle_tpu_torch.tools import profile_decode
    monkeypatch.setenv("PD_SPEC", "1")
    model = gpt.GPT(gpt.gpt_tiny(max_seq_len=512), device="cpu")
    counts = profile_decode.mega_section(model, "tiny")
    assert set(counts) == {"mega", "per_layer", "mega_spec"}
    assert counts["mega_spec"] == 0          # the CPU counts no launch
    tps, disp, rep = profile_decode.run_engine(model, slots=2, s_pf=16,
                                               n_new=8, chunk=2, spec_k=4)
    assert tps > 0 and disp > 0 and rep["depth"] == 2
    out = capsys.readouterr().out
    assert "mega mega_spec: launches/step=0" in out
