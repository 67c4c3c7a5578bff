"""The port's MoE (``paddle_tpu_torch.incubate.moe`` and the MoE GPT)
against the JAX package's, on the CPU in fp32 with the same numpy
inputs:

- ``top_k_gating`` for k = 1 and 2 with capacity overflow (dispatch
  equal, combine and aux within 1e-6), groups routed apart, and the
  Switch jitter drawn bit for bit;
- ``MoELayer`` output, aux and input gradient for both gates, routed in
  groups of 16 over 40 tokens (three groups, the last padded);
- the MoE GPT: parameter names equal to JAX ``split_params()``, logits
  and ``return_aux`` for ``moe_every`` 1 and 2, the converter's round
  trip, greedy ``generate`` at a 1024 cache (K10's route), three train
  steps against JAX ``build_train_step`` (both gates, dropout, two
  routing groups), the numerics layout of the per-layer state;
- the refusals: remat, ``moe_every`` < 1, an unknown gate, int8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jax_optim
from paddle_tpu.incubate import moe as jax_moe
from paddle_tpu.models import gpt as jax_gpt
from paddle_tpu_torch import random as prng
from paddle_tpu_torch.incubate import moe
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.models.convert import (gpt_from_jax_state,
                                             gpt_to_jax_state)
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.quantization import quantize_for_inference

from test_torch_train_step import NOISE_ATOL, _rel_l2
from torch_reference_compile import fast_reference_compiles  # noqa: F401

# fp32 both sides: the gating's arithmetic is the same op for op (its
# combine entries are gate probabilities, softmax sums in another
# order); the layer and the GPT add products in another order
GATE_TOL = 1e-6
LAYER_TOL = 1e-5
LOGITS_TOL = 1e-4
AUX_TOL = 1e-5
# test_torch_train_step.py's fp32 tolerances
LOSS_TOL, GRAD_TOL, PARAM_ATOL = 1e-5, 1e-4, 2e-5
NOISE = 1e-4

_CFG_FIELDS = ("vocab_size", "max_seq_len", "d_model", "n_layers",
               "n_heads", "ffn_mult", "dropout", "use_bias",
               "tie_embeddings", "moe_experts", "moe_every",
               "moe_aux_weight", "moe_gate")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(t):
    return t.detach().numpy()


# ---------------------------------------------------------------------------
# Gating and the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2])
def test_top_k_gating_matches_jax(k):
    # 64 tokens over 4 experts at capacity 12 k: 16 k choices an expert
    # on average, so some overflow
    logits = np.random.RandomState(k).randn(64, 4).astype(np.float32)
    jc, jd, ja = jax_moe.top_k_gating(jnp.asarray(logits), k, 12 * k)
    tc, td, ta = moe.top_k_gating(torch.from_numpy(logits), k, 12 * k)
    np.testing.assert_array_equal(_np(td), np.asarray(jd))
    np.testing.assert_allclose(_np(tc), np.asarray(jc), atol=GATE_TOL)
    np.testing.assert_allclose(float(ta), float(ja), atol=GATE_TOL)
    kept = _np(td).any(-1).sum(-1)
    assert (kept < k).any() and (kept == k).any()
    if k == 2:
        # the kept gates of a token renormalised to sum to 1
        full = _np(tc).sum((-1, -2))[kept == 2]
        np.testing.assert_allclose(full, 1.0, atol=GATE_TOL)


def test_grouped_gating_and_jitter_match_jax():
    """(G, N, E) logits route each group apart, as the JAX vmap does,
    and the Switch jitter of group g is drawn from ``split(key, G)[g]``
    bit for bit."""
    G, N, E, cap = 3, 32, 4, 10
    logits = np.random.RandomState(5).randn(G, N, E).astype(np.float32)
    key = jax.random.PRNGKey(7)
    keys = jax.random.split(key, G)
    want = jax.vmap(lambda kk: jax.random.uniform(
        kk, (N, E), jnp.float32, -1.0, 1.0))(keys)
    tkeys = prng.split(prng.PRNGKey(7), G)
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(keys,
                                                            np.int64))
    got = moe._jitter(tkeys, torch.zeros(G, N, E))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    jc, jd, ja = jax.vmap(lambda lg, kk: jax_moe.top_k_gating(
        lg, 1, cap, rng_key=kk, jitter_eps=0.3))(jnp.asarray(logits), keys)
    tc, td, ta = moe.top_k_gating(torch.from_numpy(logits), 1, cap,
                                  rng_key=tkeys, jitter_eps=0.3)
    np.testing.assert_array_equal(_np(td), np.asarray(jd))
    np.testing.assert_allclose(_np(tc), np.asarray(jc), atol=GATE_TOL)
    np.testing.assert_allclose(_np(ta), np.asarray(ja), atol=GATE_TOL)


@pytest.mark.parametrize("gate", ["gshard", "switch"])
def test_moe_layer_matches_jax(gate):
    d, h, E = 16, 32, 4
    jl = jax_moe.MoELayer(d, h, E, gate=gate, tokens_per_group=16, seed=1)
    rs = np.random.RandomState(2)
    # non-zero biases, so their broadcasts are held too
    state = {n: np.asarray(v) + (0.1 * rs.randn(*v.shape).astype(
        np.float32) if "_b" in n else 0.0)
        for n, v in jl.state_dict().items()}
    jl.set_state_dict({n: jnp.asarray(v) for n, v in state.items()})
    tl = moe.MoELayer(d, h, E, gate=gate, tokens_per_group=16,
                      device="cpu", weights={
                          n: torch.from_numpy(np.array(v))
                          for n, v in state.items()})
    assert tl.capacity(16) == jl.capacity(16) and tl.k == jl.k
    x = rs.randn(2, 20, d).astype(np.float32)
    cot = rs.randn(2, 20, d).astype(np.float32)
    key = jax.random.PRNGKey(5)

    def jloss(xx):
        y, aux = jl(xx, key)
        return jnp.sum(y * cot) + aux, (y, aux)

    (_, (jy, ja)), jgx = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    ty, ta = tl(tx, prng.PRNGKey(5))
    ((ty * torch.from_numpy(cot)).sum() + ta).backward()
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=LAYER_TOL)
    np.testing.assert_allclose(_np(ta), np.asarray(ja), atol=AUX_TOL)
    np.testing.assert_allclose(_np(tx.grad), np.asarray(jgx),
                               atol=LAYER_TOL)


def test_unknown_gate_raises():
    with pytest.raises(ValueError, match="unknown gate"):
        moe.MoELayer(8, 16, 2, gate="topk", device="cpu")
    cfg = gpt.gpt_tiny(moe_experts=2, moe_gate="topk")
    with pytest.raises(ValueError, match="unknown gate"):
        gpt.GPT(cfg, device="cpu")


def test_seeded_layer_init():
    a = moe.MoELayer(8, 16, 2, seed=3, dtype="bfloat16", device="cpu")
    b = moe.MoELayer(8, 16, 2, seed=3, dtype="bfloat16", device="cpu")
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))
    shapes = {n: (tuple(p.shape), p.dtype) for n, p in a.named_parameters()}
    assert shapes == {"gate_w": ((8, 2), torch.float32),
                      "moe_w1": ((2, 8, 16), torch.bfloat16),
                      "moe_b1": ((2, 1, 16), torch.bfloat16),
                      "moe_w2": ((2, 16, 8), torch.bfloat16),
                      "moe_b2": ((2, 1, 8), torch.bfloat16)}
    assert not a.moe_b1.any()


# ---------------------------------------------------------------------------
# The MoE GPT
# ---------------------------------------------------------------------------

def _port_config(jcfg):
    return gpt.GPTConfig(**{f: getattr(jcfg, f) for f in _CFG_FIELDS},
                         dtype=torch.float32)


def _models(std=0.1, seed=1, **kw):
    """A JAX MoE GPT with seeded random weights (LN scales near 1, every
    other parameter N(0, std)) and the port's from the same numpy
    arrays."""
    fields = dict(vocab_size=128, max_seq_len=64, d_model=32, n_layers=2,
                  n_heads=4, moe_experts=4, moe_every=2)
    fields.update(kw)
    jcfg = jax_gpt.GPTConfig(dtype=jnp.float32, **fields)
    jmodel = jax_gpt.GPT(jcfg, seed=0)
    rs = np.random.RandomState(seed)
    state = {}
    for k, v in sorted(jmodel.state_dict().items()):
        noise = rs.randn(*v.shape).astype(np.float32)
        state[k] = (1.0 + 0.1 * noise) if "scale" in k else std * noise
    jmodel.set_state_dict({k: jnp.asarray(v) for k, v in state.items()})
    return jcfg, jmodel, gpt_from_jax_state(_port_config(jcfg), state,
                                            device="cpu"), state


@pytest.mark.parametrize("every", [1, 2])
def test_moe_gpt_logits_and_aux_match_jax(every):
    jcfg, jmodel, model, _ = _models(n_layers=3, moe_every=every)
    names = dict(model.named_parameters())
    assert set(names) == set(jmodel.split_params()[0])
    assert model.slab_entries() == []
    assert [("moe" in w) for w in model.layer_weights()] == [
        (i + 1) % every == 0 for i in range(3)]
    toks = np.random.RandomState(2).randint(0, 128, size=(2, 40))
    jlog, jaux = jax.jit(lambda t: jmodel(t, return_aux=True))(
        jnp.asarray(toks))
    tlog, taux = model(torch.from_numpy(toks), return_aux=True)
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), atol=LOGITS_TOL,
                               rtol=LOGITS_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), atol=AUX_TOL)
    torch.testing.assert_close(model(torch.from_numpy(toks)), tlog)
    assert _port_config(jcfg).num_params() == jcfg.num_params()
    assert _port_config(jcfg).flops_per_token() == jcfg.flops_per_token()


def test_convert_round_trip_and_errors():
    jcfg, _, model, state = _models()
    back = gpt_to_jax_state(model)
    assert sorted(back) == sorted(state)
    for n, v in state.items():
        np.testing.assert_array_equal(back[n], v, err_msg=n)
    cfg = _port_config(jcfg)
    missing = dict(state)
    del missing["blocks.item_1.moe.moe_w2"]
    with pytest.raises(KeyError, match="moe_w2"):
        gpt_from_jax_state(cfg, missing, device="cpu")
    extra = dict(state, **{"blocks.item_1.wup": np.zeros((32, 128),
                                                         np.float32)})
    with pytest.raises(KeyError, match="item_1.wup"):
        gpt_from_jax_state(cfg, extra, device="cpu")
    bad = dict(state, **{"blocks.item_1.moe.gate_w": np.zeros(
        (32, 3), np.float32)})
    with pytest.raises(ValueError, match="gate_w"):
        gpt_from_jax_state(cfg, bad, device="cpu")
    with pytest.raises(ValueError, match="no gradient"):
        gpt_to_jax_state(model, grads=True)


def test_seeded_moe_init_per_layer():
    cfg = gpt.gpt_tiny(moe_experts=4, dtype=torch.bfloat16)
    a = gpt.GPT(cfg, seed=5, device="cpu")
    b = gpt.GPT(cfg, seed=5, device="cpu")
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    assert all(torch.equal(pa[n], pb[n]) for n in pa)
    w1 = pa["blocks.item_1.moe.moe_w1"]
    assert w1.shape == (4, 64, 256) and w1.dtype == torch.bfloat16
    assert pa["blocks.item_1.moe.gate_w"].dtype == torch.float32
    assert abs(float(w1.detach().float().std()) - 0.02) < 2e-3
    assert "blocks.item_0.wup" in pa and "blocks.item_1.wup" not in pa
    w = a.layer_weights()[1]
    assert w["moe"]["moe_w1"] is w1 and w["wqkv"] is pa[
        "blocks.item_1.wqkv"]


def test_moe_config_errors():
    with pytest.raises(ValueError, match="remat"):
        gpt.GPT(gpt.gpt_tiny(moe_experts=2, remat=True), device="cpu")
    with pytest.raises(ValueError, match="moe_every"):
        gpt.GPT(gpt.gpt_tiny(moe_experts=2, moe_every=0), device="cpu")


def test_int8_refuses_moe():
    model = gpt.GPT(gpt.gpt_tiny(moe_experts=2), device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        quantize_for_inference(model)


def test_greedy_generate_matches_jax():
    """Both generate through the cached route (the prompt routes B x S0
    tokens, each decode step B) over a 1024 cache, so one-token steps
    take the flash-decode route on both sides; weights at std 0.5, where
    greedy streams do not repeat one token."""
    _, jmodel, model, _ = _models(std=0.5, max_seq_len=1024, n_layers=2,
                                  moe_every=1)
    toks = np.random.RandomState(3).randint(0, 128, size=(2, 9))
    want = np.asarray(jmodel.generate(jnp.asarray(toks, jnp.int32),
                                      max_new_tokens=12))
    got = model.generate(toks, max_new_tokens=12).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(set(got[:, 9:].ravel().tolist())) > 2


# (gate, dropout, batch, seq): gshard at 64 tokens; switch with dropout
# 0.1 and 1,120 tokens, routed in two groups of 1024 (the second padded)
STEP_CASES = {
    "gshard": ("gshard", 0.0, 2, 32),
    "switch_dropout_two_groups": ("switch", 0.1, 2, 560),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_moe_train_step_matches_jax(case):
    gate, p, B, S = STEP_CASES[case]
    jcfg, jmodel, model, _ = _models(moe_gate=gate, dropout=p,
                                     max_seq_len=max(64, S))
    tokens = np.random.RandomState(2).randint(
        0, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    jtok, rng = jnp.asarray(tokens), jax.random.PRNGKey(0)

    def jloss(m):
        logits, aux = m(jtok, rng_key=rng, return_aux=True)
        return jax_gpt.lm_loss(logits, jtok) + jcfg.moe_aux_weight * aux

    jopt = jax_optim.AdamW(learning_rate=1e-3, weight_decay=0.01,
                           moment_dtype=jnp.bfloat16)
    jparams, jstate = jax_gpt.init_train_state(jmodel, jopt)
    # jitted: op by op the MoE's gradient takes many seconds
    jgrads = jax.jit(jax.grad(lambda q: jloss(jmodel.merge_params(q))))(
        jparams)
    jstep = jax_gpt.build_train_step(jmodel, jopt, donate=False)

    topt = AdamW(learning_rate=1e-3, weight_decay=0.01,
                 moment_dtype=torch.bfloat16)
    params, state = gpt.init_train_state(model, topt)
    assert sorted(params) == sorted(jparams)
    step = gpt.build_train_step(model, topt)
    ttok, key = torch.from_numpy(tokens), prng.PRNGKey(0)
    for i in range(3):
        jparams, jstate, jl = jstep(jparams, jstate, jtok, rng)
        params, state, loss = step(params, state, ttok, key)
        np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_TOL,
                                   err_msg=f"loss of step {i + 1}")
        if i == 0:
            got = gpt_to_jax_state(model, grads=True)
            assert sorted(got) == sorted(jgrads)
            for n, g in got.items():
                assert _rel_l2(g, np.asarray(jgrads[n])) <= GRAD_TOL, n
    got = gpt_to_jax_state(model)
    for n, v in got.items():
        want = np.asarray(jparams[n], np.float32)
        g = np.abs(np.asarray(jgrads[n], np.float32))
        atol = np.where(g > NOISE * g.max(), PARAM_ATOL, NOISE_ATOL)
        excess = np.abs(v - want) - atol
        assert excess.max() <= 0, (n, float(excess.max()))


def test_moe_step_decay_by_name_and_numerics_layout(monkeypatch):
    """A name-keyed decay fn needs no mask on the per-layer state (the
    optimizer resolves it per entry), and the numerics vector pools every
    entry into ``(rest)``, the JAX layout of a per-layer state."""
    monkeypatch.setenv("PT_NUMERICS_EVERY", "1")
    jcfg, jmodel, model, _ = _models()

    def decay(name):
        return not (name.endswith("bias") or "scale" in name)

    jopt = jax_optim.AdamW(learning_rate=1e-3, apply_decay_param_fun=decay)
    topt = AdamW(learning_rate=1e-3, apply_decay_param_fun=decay)
    jparams, jstate = jax_gpt.init_train_state(jmodel, jopt)
    jstep = jax_gpt.build_train_step(jmodel, jopt, donate=False)
    params, state = gpt.init_train_state(model, topt)
    assert topt._decay_masks == {}
    step = gpt.build_train_step(model, topt)
    tok = np.random.RandomState(3).randint(0, 128, size=(2, 16)).astype(
        np.int32)
    jparams, _, jl, jpacked = jstep(jparams, jstate, jnp.asarray(tok),
                                    jax.random.PRNGKey(0))
    params, _, loss, packed = step(params, state, torch.from_numpy(tok))
    lay, jlay = step.numerics_layout.layout, jstep.numerics_layout.layout
    assert lay.families == jlay.families
    assert [f[0] for f in lay.families] == ["grad/(rest)", "upd/(rest)"]
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_TOL)
    np.testing.assert_allclose(packed.numpy(), np.asarray(jpacked),
                               rtol=1e-3, atol=1e-6)
    got = gpt_to_jax_state(model)
    for n in ("blocks.item_1.moe.moe_w1", "blocks.item_1.ln2_scale"):
        np.testing.assert_allclose(got[n], np.asarray(jparams[n]),
                                   atol=PARAM_ATOL)
