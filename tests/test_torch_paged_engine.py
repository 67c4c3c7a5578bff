"""The port's paged serving engine against the JAX package's
``PagedDecodeEngine(mega=False)`` (its documented bit-parity path) on the
same numpy weights, on the CPU: token streams, and the K/V rows the page
tables map, for mixed prompt lengths and one page-aligned prefix hit.
The single-dispatch decode (``mega``, the default: K8 + K9's plain
versions on the CPU) emits the JAX ``mega=False`` streams too, and the
port's own per-layer path's and ``generate``'s. Plus the engine's own
contracts: eos and budget retirement, deadline and non-finite eviction,
the mega default, and the options ported since the first slice."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference.paged_engine import (
    PagedDecodeEngine as JaxPagedEngine)
from paddle_tpu.models import gpt as jax_gpt
from paddle_tpu_torch import stats
from paddle_tpu_torch.inference.decode_engine import DecodeEngine
from paddle_tpu_torch.inference.factory import make_engine
from paddle_tpu_torch.inference.paged_engine import PagedDecodeEngine
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.models.convert import gpt_from_jax_state
from torch_reference_compile import fast_reference_compiles  # noqa: F401

# fp32 pools: the same K/V rows up to summation order over 2 layers
ATOL = RTOL = 1e-4
PAGE = 128
JAX_CFG = jax_gpt.GPTConfig(vocab_size=96, max_seq_len=256, d_model=32,
                            n_layers=2, n_heads=4, dtype=jnp.float32)
# weights at std 0.5: at the JAX init (std 0.02) every greedy stream of
# this fixture repeats one token, and stream equality would prove little
WEIGHT_STD = 0.5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _state(seed=0, cfg=JAX_CFG):
    jmodel = jax_gpt.GPT(cfg, seed=0)
    rs = np.random.RandomState(seed)
    state = {}
    for k, v in sorted(jmodel.state_dict().items()):
        noise = rs.randn(*v.shape).astype(np.float32)
        state[k] = (1.0 + 0.1 * noise) if "scale" in k else (
            WEIGHT_STD * noise)
    jmodel.set_state_dict({k: jnp.asarray(v) for k, v in state.items()})
    return jmodel, state


def _port_model(state, **kw):
    cfg = gpt.GPTConfig(vocab_size=96, max_seq_len=256, d_model=32,
                        n_layers=2, n_heads=4, dtype=torch.float32, **kw)
    return gpt_from_jax_state(cfg, state, device="cpu")


def _prompts(seed=1):
    rs = np.random.RandomState(seed)
    prompts = [rs.randint(0, 96, size=n).tolist() for n in (5, 23, 170)]
    # shares the 170-token prompt's first page: a page-aligned prefix hit
    prompts.append(prompts[2][:PAGE] + rs.randint(0, 96, size=9).tolist())
    return prompts


def _mapped_rows(eng, pool):
    """{(slot, layer, position): row} for every row [0, length) each
    slot's table maps (the engine's pipeline must be drained)."""
    out = {}
    for s, req in enumerate(eng._slot_req):
        if req is None:
            continue
        tab = eng._tables[s]
        for t in range(int(eng._host_len[s])):
            for layer in range(eng.cfg.n_layers):
                out[s, layer, t] = pool[layer * eng.P + tab[t // PAGE], :,
                                        t % PAGE]
    return out


def test_engine_matches_jax_engine_streams_and_pool_rows():
    jmodel, state = _state()
    model = _port_model(state)
    prompts = _prompts()
    stats.reset()
    jeng = JaxPagedEngine(jmodel, n_pages=12, max_slots=4,
                          steps_per_call=4, mega=False)
    eng = make_engine(model, n_pages=12, max_slots=4, steps_per_call=4,
                      device="cpu")
    jreqs = [jeng.submit(p, max_new_tokens=12) for p in prompts]
    reqs = [eng.submit(p, max_new_tokens=12) for p in prompts]
    # mid-run: admit + one decode dispatch, then drain both pipelines
    for e in (jeng, eng):
        e.step()
        e.drain()
    assert eng._tables == jeng._tables
    assert list(eng._host_len) == list(jeng._host_len)
    want = _mapped_rows(jeng, np.asarray(jeng.kp))
    got = _mapped_rows(eng, eng.kp.numpy())
    assert want.keys() == got.keys() and len(got) > 2 * (5 + 23 + 170)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=ATOL,
                                   rtol=RTOL, err_msg=str(key))
    jeng.run()
    eng.run()
    for r, jr in zip(reqs, jreqs):
        assert r.tokens == jr.tokens
        assert len(r.tokens) == 12 and not r.failed
        assert len(set(r.tokens)) > 1          # not a degenerate stream
    # the fourth prompt took the suffix path over one cached page
    assert stats.get("serve/prefix_hit_tokens") == PAGE
    assert stats.get("serve/dispatches/prefill_suffix") == 1
    # every pool row but the scratch page (idle-slot garbage) agrees
    for pool, jpool in ((eng.kp, jeng.kp), (eng.vp, jeng.vp)):
        np.testing.assert_allclose(pool.numpy()[:-1],
                                   np.asarray(jpool)[:-1], atol=ATOL,
                                   rtol=RTOL)
    # all retired: every page free or warm in the prefix cache
    assert eng.free_pages + eng._prefix.cached_pages == 12
    assert eng._prefix.shared_pages == 0


@pytest.fixture(scope="module")
def port_model():
    return _port_model(_state()[1])


def test_eos_and_budget_retire(port_model):
    prompt = _prompts()[1]
    eng = PagedDecodeEngine(port_model, n_pages=8, max_slots=2,
                            steps_per_call=3, device="cpu")
    full = eng.submit(prompt, max_new_tokens=10)
    eng.run()
    eos = full.tokens[4]
    cut = full.tokens[:full.tokens.index(eos) + 1]
    eng2 = PagedDecodeEngine(port_model, n_pages=8, max_slots=2,
                             steps_per_call=3, inflight=1, device="cpu")
    r1 = eng2.submit(prompt, max_new_tokens=10, eos_id=eos)
    r2 = eng2.submit(prompt, max_new_tokens=1)
    eng2.run()
    assert r1.tokens == cut and r1.done
    assert r2.tokens == full.tokens[:1] and r2.done
    assert eng2.free_pages + eng2._prefix.cached_pages == 8


def test_suffix_prefill_matches_full_prefill_and_donor_weights(port_model):
    """Prefix cache on (the fourth prompt prefills only its suffix over
    a cached page) and off (every prompt prefilled in full) emit the
    same greedy streams; the second engine serves the first's weights
    (``share_weights_with``, no model)."""
    streams, donor = [], None
    for prefix in (True, False):
        eng = PagedDecodeEngine(None if donor else port_model, n_pages=12,
                                max_slots=4, steps_per_call=4,
                                prefix=prefix, share_weights_with=donor,
                                device="cpu")
        reqs = [eng.submit(p, max_new_tokens=8) for p in _prompts()]
        eng.run()
        streams.append([r.tokens for r in reqs])
        donor = eng
    assert eng._layers is donor._layers and eng._prefix is None
    assert streams[0] == streams[1]


def test_exact_page_prompt_full_match_copies_on_write(port_model):
    """A prompt of exactly one page matching in full re-runs its last
    token in a private copy of the cached page, which stays unchanged."""
    prompt = _prompts()[2][:PAGE]
    stats.reset()
    eng = PagedDecodeEngine(port_model, n_pages=8, max_slots=2,
                            steps_per_call=4, device="cpu")
    first = eng.submit(prompt, max_new_tokens=6)
    eng.run()
    cached = eng._prefix._nodes[eng._prefix.chain(prompt)[0]]
    ids = [layer * eng.P + cached for layer in range(eng.cfg.n_layers)]
    rows = eng.kp[ids].clone()                      # every layer's view
    again = eng.submit(prompt, max_new_tokens=6)
    eng.run()
    assert again.tokens == first.tokens
    assert stats.get("serve/prefix_hit_tokens") == PAGE - 1
    assert torch.equal(eng.kp[ids], rows)


def test_deadline_eviction(port_model):
    eng = PagedDecodeEngine(port_model, n_pages=8, max_slots=1,
                            device="cpu")
    live = eng.submit(_prompts()[0], max_new_tokens=4)
    queued = eng.submit(_prompts()[1], max_new_tokens=4, deadline_s=-1.0)
    eng.run()
    assert live.tokens and not live.failed
    assert queued.failed and "deadline" in queued.error


def test_nonfinite_logits_evict_and_scrub():
    _, state = _state()
    state = dict(state)
    state["blocks.item_0.wdown"] = np.full_like(
        state["blocks.item_0.wdown"], np.nan)
    model = _port_model(state)
    eng = PagedDecodeEngine(model, n_pages=8, max_slots=2, device="cpu")
    reqs = [eng.submit(p, max_new_tokens=5) for p in _prompts()[:2]]
    eng.run()
    for r in reqs:
        # the first token comes from the prefill's argmax; the first
        # decode dispatch sees the non-finite logits and evicts
        assert r.failed and r.error == "non-finite logits"
    assert eng.free_pages == 8
    # layer 1's K/V rows were NaN; the evicted slots' pages are scrubbed
    assert not torch.isnan(eng.kp[:-1]).any()


@pytest.mark.parametrize("kwargs, match", [
    (dict(speculative_k=3), "speculative"),
    (dict(prefill_only=True), "prefill-only"),
    (dict(warmup=True), "warmup"),
])
def test_unported_options_raise(port_model, kwargs, match):
    if match == "speculative":
        # ported since: a speculative engine (single-dispatch, the
        # default) serves the plain engine's greedy stream (held against
        # JAX in test_torch_speculative.py)
        prompt = _prompts()[1]
        streams = []
        for kw in ({}, kwargs):
            eng = PagedDecodeEngine(port_model, n_pages=4, device="cpu",
                                    **kw)
            req = eng.submit(prompt, max_new_tokens=8)
            eng.run()
            streams.append(req.tokens)
        assert eng.mega and eng.spec_k == 3
        assert streams[0] == streams[1] and len(streams[1]) == 8
        return
    if match == "warmup":
        # ported since: warmup=True builds a warmed engine
        stats.reset("serve/")
        PagedDecodeEngine(port_model, n_pages=4, device="cpu", **kwargs)
        assert stats.get("serve/warmup_s") == 1
        return
    # ported since: a prefill-only engine prefills, never decodes, and
    # holds the request's pages until detach_handoff (handoffs are held
    # against JAX in test_torch_handoff.py)
    assert match == "prefill-only"
    eng = PagedDecodeEngine(port_model, n_pages=4, device="cpu", **kwargs)
    req = eng.submit(_prompts()[1], max_new_tokens=8)
    for _ in range(3):
        eng.step()
    assert eng.prefill_only and eng.steps == 0 and len(req.tokens) == 1
    meta, k, v = eng.detach_handoff(req)
    assert meta["n_tokens"] == len(_prompts()[1]) and req.done
    assert tuple(k.shape) == tuple(v.shape) == (2, 1, 4, PAGE, 8)


def test_unported_methods_and_engines_raise(port_model):
    eng = make_engine(port_model, n_pages=4, device="cpu")
    # autotune is ported since (tests/test_torch_autotune.py), and so are
    # the handoff methods and attach_fleet (test_torch_handoff.py): a
    # request detached mid-decode resubmits and finishes its stream
    ref = eng.submit(_prompts()[1], max_new_tokens=6)
    eng.run()
    req = eng.submit(_prompts()[1], max_new_tokens=6)
    eng.step()
    eng.step()
    meta, k, v = eng.detach_handoff(req)
    moved = eng.submit_handoff(meta, k, v)
    eng.run()
    assert moved.tokens == ref.tokens
    with pytest.raises(ValueError, match="prefix cache"):
        make_engine(port_model, n_pages=4, prefix=False,
                    device="cpu").attach_fleet(object())
    eng.attach_fleet(object())
    assert eng._prefix.on_drop is not None
    # the contiguous engine is ported now: the factory builds it
    assert isinstance(make_engine(port_model, engine="contiguous",
                                  device="cpu"), DecodeEngine)
    with pytest.raises(ValueError, match="'paged' or 'contiguous'"):
        make_engine(port_model, engine="ragged", device="cpu")
    with pytest.raises(ValueError, match="in-flight depth"):
        make_engine(port_model, inflight=0, device="cpu")


def test_request_timestamps_give_ttft_and_tpot(port_model):
    """TTFT and TPOT come exactly from each request's own timestamps;
    the histogram holds the same per-request TPOT samples."""
    stats.reset()
    eng = make_engine(port_model, n_pages=8, max_slots=2, device="cpu")
    reqs = [eng.submit(p, max_new_tokens=n)
            for p, n in zip(_prompts()[:2], (4, 1))]
    assert all(r.ttft_s is None and r.tpot_s is None for r in reqs)
    eng.run()
    many, one = reqs
    assert many.t_submit <= many.t_first <= many.t_end
    assert many.tpot_s == (many.t_end - many.t_first) / 3
    assert one.t_end is not None and one.tpot_s is None
    snap = stats.snapshot("serve/tpot_s")
    assert snap["serve/tpot_s.count"] == 1
    assert snap["serve/tpot_s.sum"] == many.tpot_s


def test_request_checks(port_model):
    eng = make_engine(port_model, n_pages=4, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        eng.submit([], max_new_tokens=2)
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.submit([1] * 250, max_new_tokens=10)
    with pytest.raises(ValueError, match="caps prompts"):
        PagedDecodeEngine(port_model, n_pages=4, buckets=(16, 32),
                          device="cpu").submit([1] * 40, max_new_tokens=2)


ROPE_GQA = dict(n_kv_heads=2, rope=True)


@pytest.mark.parametrize("kw, chunk", [({}, 1), ({}, 3), (ROPE_GQA, 1),
                                       (ROPE_GQA, 3)],
                         ids=["mha-1", "mha-3", "rope-gqa-1", "rope-gqa-3"])
def test_mega_streams_match_jax_per_layer_and_generate(kw, chunk):
    """Prompts of 5, 23 and 170 tokens and a page-aligned prefix hit:
    the port's mega engine, the JAX per-layer engine, the port's
    per-layer engine and ``generate`` emit the same greedy streams."""
    jcfg = jax_gpt.GPTConfig(vocab_size=96, max_seq_len=256, d_model=32,
                             n_layers=2, n_heads=4, dtype=jnp.float32,
                             **kw)
    jmodel, state = _state(cfg=jcfg)
    model = _port_model(state, **kw)
    prompts = _prompts()
    n_new = 9
    jeng = JaxPagedEngine(jmodel, n_pages=12, max_slots=4,
                          steps_per_call=chunk, mega=False)
    jreqs = [jeng.submit(p, max_new_tokens=n_new) for p in prompts]
    jeng.run()
    want = [r.tokens for r in jreqs]
    for mega in (True, False):
        stats.reset()
        eng = PagedDecodeEngine(model, n_pages=12, max_slots=4,
                                steps_per_call=chunk, mega=mega,
                                device="cpu")
        assert eng.mega is mega
        reqs = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
        eng.run()
        assert [r.tokens for r in reqs] == want, mega
        assert stats.get("serve/prefix_hit_tokens") == PAGE
    for p, toks in zip(prompts, want):
        out = model.generate(torch.tensor([p]), max_new_tokens=n_new)
        assert out[0, len(p):].tolist() == toks
        assert len(set(toks)) > 1              # not a degenerate stream


def test_mega_eos_inside_a_chunk_matches_jax():
    jmodel, state = _state()
    model = _port_model(state)
    prompt = _prompts()[1]
    full = PagedDecodeEngine(model, n_pages=8, max_slots=2,
                             steps_per_call=4, device="cpu")
    r = full.submit(prompt, max_new_tokens=12)
    full.run()
    # an eos whose first occurrence lands mid-chunk: token i > 0 comes
    # from step (i - 1) % 4 of a 4-step dispatch
    i = next(i for i in range(2, 12) if r.tokens[i] not in r.tokens[:i]
             and (i - 1) % 4 not in (0, 3))
    eos = r.tokens[i]
    jeng = JaxPagedEngine(jmodel, n_pages=8, max_slots=2, steps_per_call=4,
                          mega=False)
    jr = jeng.submit(prompt, max_new_tokens=12, eos_id=eos)
    jeng.run()
    eng = PagedDecodeEngine(model, n_pages=8, max_slots=2,
                            steps_per_call=4, device="cpu")
    got = eng.submit(prompt, max_new_tokens=12, eos_id=eos)
    eng.run()
    assert got.tokens == jr.tokens == r.tokens[:i + 1] and got.done


def test_mega_step_layer0_pool_rows_equal_per_layer_path():
    """After admission and one decode dispatch, the layer-0 pool slab of
    the mega engine equals the per-layer engine's bit for bit (the same
    K/V rows from the same inputs); deeper layers within fp32 order."""
    model = _port_model(_state()[1])
    engs = []
    for mega in (True, False):
        eng = PagedDecodeEngine(model, n_pages=12, max_slots=4,
                                steps_per_call=2, mega=mega, device="cpu")
        for p in _prompts():
            eng.submit(p, max_new_tokens=6)
        eng.step()
        eng.drain()
        engs.append(eng)
    mega, plain = engs
    P = mega.P
    assert mega._tables == plain._tables
    for a, b in ((mega.kp, plain.kp), (mega.vp, plain.vp)):
        assert torch.equal(a[:P], b[:P])
        torch.testing.assert_close(a[:-1], b[:-1], atol=ATOL, rtol=RTOL)


def test_mega_default_and_quantized_models(port_model):
    from paddle_tpu_torch.quantization import quantize_for_inference
    assert make_engine(port_model, n_pages=4, device="cpu").mega
    qmodel = quantize_for_inference(port_model)
    eng = make_engine(qmodel, n_pages=4, device="cpu")
    assert not eng.mega
    with pytest.raises(ValueError, match="int8 weight stream"):
        make_engine(qmodel, n_pages=4, mega=True, device="cpu")
    # an engine serving an int8 engine's weights is per-layer too
    q8 = make_engine(port_model, engine="contiguous", weight_dtype="int8",
                     device="cpu")
    shared = PagedDecodeEngine(None, n_pages=4, share_weights_with=q8,
                               device="cpu")
    assert not shared.mega
    # and a dense donor's slabs are shared, not copied
    dense = PagedDecodeEngine(None, n_pages=4, device="cpu",
                              share_weights_with=make_engine(
                                  port_model, n_pages=4, device="cpu"))
    assert dense.mega
    assert (dense._stacked["wqkv"].data_ptr()
            == port_model.stacked["wqkv"].data_ptr())
