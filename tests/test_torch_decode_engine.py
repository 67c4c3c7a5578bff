"""The port's slot-contiguous ``DecodeEngine`` against the JAX package's
``DecodeEngine`` on the same numpy weights, on the CPU: greedy streams
and cache rows with staggered admissions, ``steps_per_call`` 1 and 4,
eos inside a chunk, a chunked long prompt and a 1024 cache (the K10
route); interleaved prefill; the cache bound. The int8 engine: exact
on a grid-snapped model in both packages, the donor's weights untouched,
and built by ``make_engine(engine="contiguous")``. Both engines serve
``quantize_for_inference`` of an untied model as its ``generate``
does."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference.decode_engine import DecodeEngine as JaxEngine
from paddle_tpu.models import gpt as jax_gpt
from paddle_tpu.quantization import quantize_tensor as jax_quantize
from paddle_tpu_torch import quantization as quant
from paddle_tpu_torch import stats
from paddle_tpu_torch.inference.decode_engine import DecodeEngine
from paddle_tpu_torch.inference.factory import make_engine
from paddle_tpu_torch.inference.paged_engine import PagedDecodeEngine
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.models.convert import gpt_from_jax_state
from torch_reference_compile import fast_reference_compiles  # noqa: F401

# fp32 caches: the same K/V rows up to summation order over 2 layers
ATOL = RTOL = 1e-4
# weights at std 0.5: at the JAX init (std 0.02) every greedy stream of
# this fixture repeats one token, and stream equality would prove little
WEIGHT_STD = 0.5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _state(jmodel, seed=0):
    rs = np.random.RandomState(seed)
    state = {}
    for k, v in sorted(jmodel.state_dict().items()):
        noise = rs.randn(*v.shape).astype(np.float32)
        state[k] = (1.0 + 0.1 * noise) if "scale" in k else (
            WEIGHT_STD * noise)
    return state


def _models(max_seq=256, state_fn=None, **kw):
    fields = dict(dict(vocab_size=96, max_seq_len=max_seq, d_model=32,
                       n_layers=2, n_heads=4), **kw)
    jmodel = jax_gpt.GPT(jax_gpt.GPTConfig(dtype=jnp.float32, **fields),
                         seed=0)
    state = (state_fn or _state)(jmodel)
    jmodel.set_state_dict({k: jnp.asarray(v) for k, v in state.items()})
    model = gpt_from_jax_state(gpt.GPTConfig(dtype=torch.float32, **fields),
                               state, device="cpu")
    return jmodel, model


@pytest.fixture(scope="module")
def models():
    return _models()


def _prompts(seed=0, sizes=(3, 9, 17, 70)):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 96, size=n).tolist() for n in sizes]


def _serve(eng, prompts, n_new, eos=None):
    """Two requests up front, two more after two steps (staggered)."""
    eos = eos or [None] * len(prompts)
    reqs = [eng.submit(p, n_new, eos_id=e)
            for p, e in zip(prompts[:2], eos[:2])]
    eng.step()
    eng.step()
    reqs += [eng.submit(p, n_new, eos_id=e)
             for p, e in zip(prompts[2:], eos[2:])]
    eng.run()
    return reqs


@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("max_seq", [256, 1024])
def test_engine_matches_jax_engine(models, chunk, max_seq):
    """Staggered admissions into 2 slots, the 70-token prompt chunked
    over buckets of 16 and 32, eos hit inside a chunk by one request;
    streams equal JAX's and every cache row agrees. At 1024 the decode
    steps take the K10 route in both packages."""
    jmodel, model = models if max_seq == 256 else _models(max_seq)
    prompts = _prompts()
    kw = dict(max_slots=2, buckets=(16, 32), steps_per_call=chunk)
    free = _serve(DecodeEngine(model, device="cpu", **kw), prompts, 9)
    eos = [None, free[1].tokens[5], None, None]
    jeng = JaxEngine(jmodel, **kw)
    eng = DecodeEngine(model, device="cpu", **kw)
    jreqs = _serve(jeng, prompts, 9, eos)
    reqs = _serve(eng, prompts, 9, eos)
    for r, jr in zip(reqs, jreqs):
        assert r.tokens == [int(t) for t in jr.tokens]
        assert r.done and not r.failed
    assert reqs[1].tokens == free[1].tokens[:free[1].tokens.index(
        eos[1]) + 1] and len(reqs[1].tokens) < 9
    assert all(len(set(r.tokens)) > 1 for r in reqs if len(r.tokens) > 3)
    assert eng.T == jeng.T == max_seq and eng.num_active == 0
    np.testing.assert_allclose(eng.kc.numpy(), np.asarray(jeng.kc),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(eng.vc.numpy(), np.asarray(jeng.vc),
                               atol=ATOL, rtol=RTOL)


def test_gqa_rope_untied_engine_matches_jax_engine():
    """A llama-shaped stack (rope, 2 kv heads for 4 query heads, no
    biases, untied head) over a 1024 cache: rope positions in prefill
    chunks and decode, GQA in the dense and K10 routes."""
    jmodel, model = _models(1024, n_kv_heads=2, rope=True, use_bias=False,
                            tie_embeddings=False)
    prompts = _prompts(5, sizes=(7, 40))
    kw = dict(max_slots=2, buckets=(16, 32), steps_per_call=4)
    streams = []
    for make, mod, extra in ((JaxEngine, jmodel, {}),
                             (DecodeEngine, model, dict(device="cpu"))):
        eng = make(mod, **kw, **extra)
        reqs = [eng.submit(p, max_new_tokens=9) for p in prompts]
        eng.run()
        streams.append([[int(t) for t in r.tokens] for r in reqs])
    assert streams[0] == streams[1]
    assert all(len(set(t)) > 1 for t in streams[1])


def test_tail_chunk_slides_back_and_matches_generate():
    """A 276-token prompt over buckets (16, 256) in a 384 cache slides
    its tail chunk back instead of overrunning: its stream equals the
    port's ``generate`` (held against JAX's in test_torch_generate.py)."""
    _, model = _models(512)
    prompt = np.random.RandomState(7).randint(0, 96, size=276).tolist()
    eng = DecodeEngine(model, max_slots=1, max_len=384, buckets=(16, 256),
                       device="cpu")
    req = eng.submit(prompt, max_new_tokens=5)
    eng.run()
    want = model.generate([prompt], max_new_tokens=5, max_len=384)
    assert req.tokens == want[0, 276:].tolist()


def test_interleaved_prefill_matches_jax_and_keeps_prompt_rows(models):
    """A long prompt's prefill chunks interleave with the live request's
    decode dispatches under a 16-token budget; both streams equal JAX's
    and the admitted slot's prompt rows equal a solo admission's."""
    jmodel, model = models
    rs = np.random.RandomState(12)
    long_prompt = rs.randint(0, 96, size=100).tolist()
    short = rs.randint(0, 96, size=4).tolist()
    out = []
    for make, kw in ((JaxEngine, {}), (DecodeEngine, dict(device="cpu"))):
        eng = make(jmodel if make is JaxEngine else model, max_slots=2,
                   max_len=128, buckets=(16,), prefill_tokens=16,
                   inflight=2, **kw)
        r0 = eng.submit(short, max_new_tokens=12)
        eng.step()
        r1 = eng.submit(long_prompt, max_new_tokens=4)
        decoded = []                # one decode dispatch in this step?
        while eng._waiting or eng.num_active:
            steps = eng.steps
            eng.step()
            decoded.append(eng.steps - steps)
        eng.run()
        out.append((eng, [int(t) for t in r0.tokens],
                    [int(t) for t in r1.tokens], decoded))
    (jeng, j0, j1, _), (eng, t0, t1, decoded) = out
    assert (t0, t1) == (j0, j1)
    assert len(t0) == 12 and len(t1) == 4
    # the short request decoded in the steps that ran the long prompt's
    # 7 prefill chunks
    assert sum(decoded[:7]) >= 5
    solo = DecodeEngine(model, max_slots=1, max_len=128, buckets=(16,),
                        device="cpu")
    solo.submit(long_prompt, max_new_tokens=4)
    solo.run()
    n = len(long_prompt)
    torch.testing.assert_close(eng.kc[:, 1, :, :n], solo.kc[:, 0, :, :n],
                               atol=0, rtol=0)
    np.testing.assert_allclose(eng.kc[:, 1, :, :n].numpy(),
                               np.asarray(jeng.kc)[:, 1, :, :n],
                               atol=ATOL, rtol=RTOL)


def test_bf16_cache_of_an_fp32_model_matches_jax(models):
    """``cache_dtype``: the rows round-trip through a bf16 cache in both
    packages (the dense route: promoted einsums over the bf16 cache)."""
    jmodel, model = models
    prompts = _prompts(4, sizes=(5, 21))
    streams = []
    for make, mod, kw in ((JaxEngine, jmodel, dict(cache_dtype=jnp.bfloat16)),
                          (DecodeEngine, model,
                           dict(cache_dtype=torch.bfloat16, device="cpu"))):
        eng = make(mod, max_slots=2, **kw)
        reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
        eng.run()
        streams.append([[int(t) for t in r.tokens] for r in reqs])
    assert eng.kc.dtype == torch.bfloat16
    assert streams[0] == streams[1]


def test_cache_bound_and_position_table():
    """T caps at max_seq_len when that is not a 128-multiple; requests
    past the cache raise at submit."""
    _, model = _models(200)
    eng = DecodeEngine(model, max_slots=1, device="cpu")
    assert eng.T == 200
    prompt = np.random.RandomState(8).randint(0, 96, size=150).tolist()
    req = eng.submit(prompt, max_new_tokens=5)
    eng.run()
    assert req.tokens == model.generate([prompt], max_new_tokens=5,
                                        max_len=200)[0, 150:].tolist()
    with pytest.raises(ValueError, match="exceed cache length"):
        eng.submit(prompt, max_new_tokens=51)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit([], max_new_tokens=1)
    eng2 = DecodeEngine(model, max_slots=1, max_len=128, device="cpu")
    assert eng2.T == 128
    with pytest.raises(ValueError, match="exceed cache length"):
        eng2.submit(list(range(100)), max_new_tokens=100)


def _grid_state(jmodel):
    """Matmul weights snapped to the int8 grid (quantize-dequantize per
    output column), so the int8 copy represents them exactly."""
    state = _state(jmodel)
    for k, v in state.items():
        if k.split(".")[-1] in ("wqkv", "wo", "wup", "wdown"):
            state[k] = np.asarray(jax_quantize(
                jnp.asarray(v), axis=-1).dequantize())
    return state


def test_int8_weight_engine_exact_on_grid_model():
    """weight_dtype='int8' on a grid-snapped model emits exactly the fp
    engine's stream, in the port and in JAX, and the two packages agree;
    the int8 engine shares (and never mutates) the donor's weights."""
    jmodel, model = _models(state_fn=_grid_state)
    prompts = _prompts(1, sizes=(6, 14))
    streams = {}
    for name, make, mod, kw in (
            ("jax", JaxEngine, jmodel, {}),
            ("port", DecodeEngine, model, dict(device="cpu"))):
        fp = make(mod, max_slots=2, max_len=64, **kw)
        r_fp = [fp.submit(p, max_new_tokens=8) for p in prompts]
        fp.run()
        donor = [{n: t.clone() for n, t in w.items()}
                 for w in fp._layers] if make is DecodeEngine else None
        q8 = make(None, max_slots=2, max_len=64, share_weights_with=fp,
                  weight_dtype="int8", **kw)
        r_q8 = [q8.submit(p, max_new_tokens=8) for p in prompts]
        q8.run()
        streams[name] = ([[int(t) for t in r.tokens] for r in r_fp],
                         [[int(t) for t in r.tokens] for r in r_q8])
        if donor is not None:
            for w, w0 in zip(fp._layers, donor):
                assert all(isinstance(t, torch.Tensor) for t in w.values())
                for n, t in w.items():
                    torch.testing.assert_close(t, w0[n], atol=0, rtol=0)
            for w in q8._layers:
                assert isinstance(w["wqkv"], quant.QuantTensor)
                assert isinstance(w["wdown"], quant.QuantTensor)
                assert isinstance(w["ln1_scale"], torch.Tensor)
            assert q8._head is fp._head
    assert streams["port"][0] == streams["port"][1]
    assert streams["jax"][0] == streams["jax"][1]
    assert streams["port"] == streams["jax"]


def test_int8_engine_runs_k12_wrapper_and_matches_quantized_model(
        models, monkeypatch):
    """Every block matmul of the int8 engine goes through K12's wrapper
    (4 per layer per decode step and per prefill chunk), and its greedy
    streams equal ``generate`` on ``quantize_for_inference`` of the same
    weights with the float LM head kept (the engine quantizes the four
    block slabs only)."""
    _, model = models
    calls = []
    orig = quant.int8_matmul
    monkeypatch.setattr(quant, "int8_matmul",
                        lambda *a: calls.append(a[0].shape) or orig(*a))
    eng = make_engine(model, engine="contiguous", max_slots=2,
                      weight_dtype="int8", device="cpu")
    assert isinstance(eng, DecodeEngine)
    prompts = _prompts(2, sizes=(5, 11))
    reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    eng.run()
    L = model.cfg.n_layers
    chunks = len(prompts)
    assert len(calls) == 4 * L * (chunks + eng.steps * eng.chunk)
    qmodel = quant.quantize_for_inference(model)
    assert "lm_head" not in qmodel.quantized
    calls.clear()
    for p, r in zip(prompts, reqs):
        want = qmodel.generate([p], max_new_tokens=6, max_len=eng.T)
        assert r.tokens == want[0, len(p):].tolist()
    assert calls


def test_sampling_engine_is_seeded(models):
    _, model = models
    prompts = _prompts(3, sizes=(4, 7))

    def run(seed, **kw):
        eng = DecodeEngine(model, max_slots=2, seed=seed, device="cpu",
                           **kw)
        reqs = [eng.submit(p, max_new_tokens=10) for p in prompts]
        eng.run()
        return [r.tokens for r in reqs]

    greedy = run(0)
    a = run(5, temperature=1.0, top_k=30, top_p=0.95)
    assert a == run(5, temperature=1.0, top_k=30, top_p=0.95)
    assert a != run(6, temperature=1.0, top_k=30, top_p=0.95)
    assert a != greedy
    assert run(9, temperature=0.7, top_k=1) == greedy


def test_factory_default_and_env(models, monkeypatch):
    """The paged engine unless the caller names the contiguous one; no
    environment variable changes that, and the contiguous engine takes
    no page sizing."""
    _, model = models
    monkeypatch.setenv("PT_SERVE_ENGINE", "contiguous")
    assert isinstance(make_engine(model, max_slots=2, device="cpu"),
                      PagedDecodeEngine)
    eng = make_engine(model, engine="contiguous", max_slots=3,
                      steps_per_call=2, device="cpu")
    assert isinstance(eng, DecodeEngine)
    assert (eng.S, eng.chunk, eng.T) == (3, 2, 256)
    for kw in (dict(n_pages=8), dict(page_size=128)):
        with pytest.raises(ValueError, match="takes neither"):
            make_engine(model, engine="contiguous", device="cpu", **kw)


@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("engine", ["contiguous", "paged"])
def test_engines_serve_an_int8_untied_model(engine, chunk):
    """An engine built from ``quantize_for_inference`` of an untied
    model projects through the int8 LM head (not the tied ``wte``) and
    emits ``generate``'s greedy stream of that model; at T 1024 decode
    takes the K10 route."""
    # vocab 160: the 32 x 160 head passes the size floor
    _, model = _models(1024, vocab_size=160, n_kv_heads=2, rope=True,
                       use_bias=False, tie_embeddings=False)
    qmodel = quant.quantize_for_inference(model)
    assert isinstance(qmodel.quantized["lm_head"], quant.QuantTensor)
    eng = make_engine(qmodel, engine=engine, max_slots=2,
                      steps_per_call=chunk, device="cpu")
    assert eng._head["proj"] is qmodel.quantized["lm_head"]
    prompts = _prompts(13, sizes=(6, 19))
    reqs = [eng.submit(p, max_new_tokens=7) for p in prompts]
    eng.run()
    for p, r in zip(prompts, reqs):
        want = qmodel.generate([p], max_new_tokens=7)
        assert r.tokens == want[0, len(p):].tolist()
    assert all(len(set(r.tokens)) > 1 for r in reqs)


@pytest.mark.parametrize("kwargs, match", [
    (dict(speculative_k=3), "speculative"),
    (dict(warmup=True), "warmup"),
    (dict(mesh=object()), "mesh"),
    (dict(weight_dtype="int4"), "weight_dtype"),
    (dict(steps_per_call=0), "steps_per_call"),
])
def test_unported_and_bad_options_raise(models, kwargs, match):
    _, model = models
    if match == "speculative":
        # ported since: a speculative engine serves generate's greedy
        # stream (held against JAX in test_torch_speculative.py)
        eng = DecodeEngine(model, device="cpu", **kwargs)
        prompt = _prompts()[1]
        req = eng.submit(prompt, max_new_tokens=8)
        eng.run()
        want = model.generate([prompt], max_new_tokens=8, max_len=eng.T)
        assert req.tokens == want[0, len(prompt):].tolist()
        assert eng.spec_k == 3 and stats.get("serve/dispatches/spec") > 0
        return
    if match == "warmup":
        # ported since: warmup=True builds a warmed engine
        stats.reset("serve/")
        DecodeEngine(model, device="cpu", **kwargs)
        assert stats.get("serve/warmup_s") == 1
        return
    with pytest.raises((NotImplementedError, ValueError), match=match):
        DecodeEngine(model, device="cpu", **kwargs)


def test_unported_methods_raise(models):
    _, model = models
    eng = DecodeEngine(model, device="cpu")
    # ported since: a request detached mid-decode (one wire page of n
    # rows) resubmits and finishes its stream (held against JAX in
    # test_torch_handoff.py)
    prompt = list(range(1, 12))
    ref = eng.submit(prompt, max_new_tokens=6)
    eng.run()
    req = eng.submit(prompt, max_new_tokens=6)
    eng.step()
    eng.step()
    meta, k, v = eng.detach_handoff(req)
    assert k.shape[1] == 1 and k.shape[3] == meta["n_tokens"]
    assert eng.kv_bytes == 0
    moved = eng.submit_handoff(meta, k, v)
    eng.run()
    assert moved.tokens == ref.tokens
    # ported since: the speculative verify and chunk run on a
    # speculative engine (no live slot: nothing is emitted)
    spec = DecodeEngine(model, device="cpu", speculative_k=2)
    cand = torch.zeros((spec.S, 2), dtype=torch.int32)
    pred, bad = spec._verify_impl(spec.lengths, cand, spec.active,
                                  spec._poison_mask())
    assert pred.shape == (spec.S, 2) and pred.dtype == torch.int32
    assert bad.shape == (spec.S,) and not bad.any()
    packed = spec._spec_multi_impl(spec.toks, spec.lengths, spec.last,
                                   spec.active, spec.remaining,
                                   spec.eos_ids, spec._poison_mask())[-1]
    assert tuple(packed.shape) == (1, spec.S, 4)
    assert not packed[..., 2].any()

