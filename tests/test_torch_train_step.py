"""The port's train step against the JAX package's, on the CPU.

- AdamW: the port's update against ``paddle_tpu.optimizer.AdamW`` over
  the same params and grads, fp32 and bf16 moments, with and without
  ``apply_decay_param_fun``.
- The GPT train step: 3 steps of ``build_train_step`` from the same
  ``gpt_from_jax_state`` weights on a fixed batch, the losses of every
  step, the first step's gradients and the final parameters compared
  through ``gpt_to_jax_state``. The JAX step takes the fused CE in
  interpret mode and the attention reference; the port takes the plain
  versions of its kernels (what CPU tensors run).
- remat on gives the same loss and gradients as remat off.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jax_optim
from paddle_tpu.models import gpt as jax_gpt
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.models.convert import (gpt_from_jax_state,
                                             gpt_to_jax_state)
from paddle_tpu_torch.nn.functional import scaled_dot_product_attention
from paddle_tpu_torch.ops.flash_attention import flash_attention
from paddle_tpu_torch.optimizer import Adam, AdamW

from test_torch_gpt import JAX_CONFIGS, port_config, random_state
from torch_reference_compile import fast_reference_compiles  # noqa: F401


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _decay_fn(name):
    return not (name.endswith("bias") or "scale" in name)


def _adam_tree(rs, dtype_p):
    return {"blocks.item_0.wqkv": rs.randn(16, 24).astype(np.float32),
            "blocks.item_0.ln1_scale": 1 + 0.1 * rs.randn(16).astype(
                np.float32),
            "blocks.item_0.bqkv": 0.1 * rs.randn(24).astype(np.float32),
            "wte": rs.randn(32, 16).astype(np.float32)}, dtype_p


# params fp32 or bf16, moments fp32 or bf16: the same fp32 arithmetic on
# both sides, so fp32 params agree to a few fp32 ulps and bf16 ones
# (rounded the same way) to one bf16 ulp at most
@pytest.mark.parametrize("moment", ["float32", "bfloat16"])
@pytest.mark.parametrize("param", ["float32", "bfloat16"])
@pytest.mark.parametrize("decay_fn", [None, _decay_fn],
                         ids=["decay_all", "decay_by_name"])
def test_adamw_matches_jax(moment, param, decay_fn):
    rs = np.random.RandomState(0)
    raw, _ = _adam_tree(rs, param)
    jdt, tdt = jnp.dtype(param), getattr(torch, param)
    jp = {n: jnp.asarray(v).astype(jdt) for n, v in raw.items()}
    tp = {n: torch.from_numpy(v).to(tdt) for n, v in raw.items()}
    jopt = jax_optim.AdamW(learning_rate=1e-2, weight_decay=0.1,
                           apply_decay_param_fun=decay_fn,
                           moment_dtype=jnp.dtype(moment))
    topt = AdamW(learning_rate=1e-2, weight_decay=0.1,
                 apply_decay_param_fun=decay_fn, moment_dtype=moment)
    js, ts = jopt.init(jp), topt.init(tp)
    tol = 1e-6 if param == "float32" else 2.0 ** -7
    for _ in range(3):
        grads = {n: rs.randn(*v.shape).astype(np.float32)
                 for n, v in raw.items()}
        jp, js = jopt.update({n: jnp.asarray(g).astype(jdt)
                              for n, g in grads.items()}, js, jp)
        tp, ts = topt.update({n: torch.from_numpy(g).to(tdt)
                              for n, g in grads.items()}, ts, tp)
        assert ts["step"] == int(js["step"])
        for n in raw:
            np.testing.assert_allclose(
                tp[n].float().numpy(), np.asarray(jp[n], np.float32),
                rtol=tol, atol=tol, err_msg=n)
            for tm, jm in zip(ts["slots"][n], js["slots"][n]):
                assert str(tm.dtype).endswith(moment)
                np.testing.assert_allclose(
                    tm.float().numpy(), np.asarray(jm, np.float32),
                    rtol=1e-5 if moment == "float32" else 2.0 ** -7,
                    atol=1e-7, err_msg=n)


def test_adam_l2_decay_matches_jax():
    rs = np.random.RandomState(1)
    raw, _ = _adam_tree(rs, "float32")
    jopt = jax_optim.Adam(learning_rate=1e-2, weight_decay=0.1)
    topt = Adam(learning_rate=1e-2, weight_decay=0.1)
    jp = {n: jnp.asarray(v) for n, v in raw.items()}
    tp = {n: torch.from_numpy(v.copy()) for n, v in raw.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    grads = {n: rs.randn(*v.shape).astype(np.float32)
             for n, v in raw.items()}
    jp, js = jopt.update({n: jnp.asarray(g) for n, g in grads.items()}, js,
                         jp)
    tp, ts = topt.update({n: torch.from_numpy(g) for n, g in grads.items()},
                         ts, tp)
    for n in raw:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                   rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# GPT train step
# ---------------------------------------------------------------------------

# (JAX config, dtype, loss rtol, grad relative-L2 tol, param atol and
# rtol, noise floor). fp32: the two packages differ only in summation order, so
# losses agree to ~1e-6 and parameters after 3 Adam steps (updates of
# ~lr = 1e-3) to 2e-5. bf16: activations round to bf16 at other places
# in the two frameworks (XLA fuses, torch rounds every op), so the loss
# agrees to a few 1e-3, gradients to a few percent in relative L2, and a
# parameter to about one update step plus two bf16 ulps of itself (each
# step rounds the updated value back to bf16).
# Adam divides by |g|: where a gradient entry is at the level of the
# two packages' rounding noise (the key bias's true gradient is 0: the
# softmax ignores a shift of every key's score), both step by about
# +-lr with signs that need not agree. Such entries — |g| below a noise
# floor relative to the parameter's largest, in the JAX step-1 gradient
# (1e-4 in fp32, 1e-2 in bf16, whose gradients agree to a few percent) —
# may differ by two opposite steps of lr for each of the three steps.
NOISE_ATOL = 6.1e-3
STEP_CASES = {
    "gpt_tiny_fp32": ("gpt_tiny", "float32", 1e-5, 1e-4, 2e-5, 0.0, 1e-4),
    "gqa_rope_untied_fp32": ("gqa_rope_untied", "float32", 1e-5, 1e-4,
                             2e-5, 0.0, 1e-4),
    "gpt_tiny_bf16": ("gpt_tiny", "bfloat16", 1e-2, 5e-2, 3e-3, 2 ** -7,
                      1e-2),
}


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _both_models(name, dtype, seed=1):
    jcfg = dataclasses.replace(JAX_CONFIGS[name], dtype=jnp.dtype(dtype))
    jmodel = jax_gpt.GPT(jcfg, seed=0)
    state = random_state(jmodel, seed=seed)
    jmodel.set_state_dict({k: jnp.asarray(v).astype(
        jmodel.state_dict()[k].dtype) for k, v in state.items()})
    # the port starts from the JAX model's own (dtype-rounded) weights
    state = {k: np.asarray(v, np.float32)
             for k, v in jmodel.state_dict().items()}
    model = gpt_from_jax_state(port_config(jcfg, getattr(torch, dtype)),
                               state, device="cpu")
    return jcfg, jmodel, model


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_matches_jax(case):
    (name, dtype, loss_tol, grad_tol, p_atol, p_rtol,
     noise) = STEP_CASES[case]
    jcfg, jmodel, model = _both_models(name, dtype)
    tokens = np.random.RandomState(2).randint(0, jcfg.vocab_size,
                                              size=(2, 32)).astype(np.int32)
    jtok = jnp.asarray(tokens)

    jopt = jax_optim.AdamW(learning_rate=1e-3, weight_decay=0.01,
                           moment_dtype=jnp.bfloat16)
    jparams, jstate = jax_gpt.init_train_state(jmodel, jopt)
    # jitted (op by op it takes several times longer)
    jgrads = jax.jit(jax.grad(lambda p: jax_gpt.fused_lm_loss(
        jmodel.merge_params(p), jtok)))(jparams)
    jstep = jax_gpt.build_train_step(jmodel, jopt, donate=False)

    topt = AdamW(learning_rate=1e-3, weight_decay=0.01,
                 moment_dtype=torch.bfloat16)
    params, state = gpt.init_train_state(model, topt)
    step = gpt.build_train_step(model, topt)
    ttok = torch.from_numpy(tokens)

    rng = jax.random.PRNGKey(0)
    for i in range(3):
        jparams, jstate, jloss = jstep(jparams, jstate, jtok, rng)
        params, state, loss = step(params, state, ttok)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=loss_tol,
                                   err_msg=f"loss of step {i + 1}")
        if i == 0:
            got = gpt_to_jax_state(model, grads=True)
            assert sorted(got) == sorted(jgrads)
            for n, g in got.items():
                want = np.asarray(jgrads[n], np.float32)
                assert _rel_l2(g, want) <= grad_tol, n
    assert state["step"] == 3 == int(jstate["step"])
    got = gpt_to_jax_state(model)
    for n, p in got.items():
        want = np.asarray(jparams[n], np.float32)
        g = np.abs(np.asarray(jgrads[n], np.float32))
        atol = np.where(g > noise * g.max(), p_atol, NOISE_ATOL)
        excess = np.abs(p - want) - (atol + p_rtol * np.abs(want))
        assert excess.max() <= 0, (n, float(excess.max()),
                                   int((excess > 0).sum()))


def _loss_and_grads(remat, attn=None):
    cfg = dataclasses.replace(gpt.gpt_tiny(), remat=remat)
    model = gpt.GPT(cfg, seed=3, device="cpu")
    tokens = torch.from_numpy(np.random.RandomState(4).randint(
        0, cfg.vocab_size, size=(2, 24)).astype(np.int32))
    loss = gpt.fused_lm_loss(model, tokens, attn=attn)
    loss.backward()
    return loss.detach(), gpt_to_jax_state(model, grads=True)


def _flash(q, k, v, is_causal=False):
    """The differentiable flash path under the sdpa hook's signature."""
    return flash_attention(q, k, v, causal=is_causal)


@pytest.mark.parametrize("attn", [None, _flash], ids=["sdpa", "flash"])
def test_remat_gives_identical_loss_and_grads(attn):
    l0, g0 = _loss_and_grads(False, attn)
    l1, g1 = _loss_and_grads(True, attn)
    assert torch.equal(l0, l1)
    for n in g0:
        np.testing.assert_array_equal(g1[n], g0[n], err_msg=n)


def test_flash_path_matches_sdpa_path():
    """The differentiable flash path (what CUDA runs) and the CPU sdpa
    reference give the same loss and gradients (fp32, summation order)."""
    l0, g0 = _loss_and_grads(False, scaled_dot_product_attention)
    l1, g1 = _loss_and_grads(False, _flash)
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
    for n in g0:
        assert _rel_l2(g1[n], g0[n]) <= 1e-5, n


def test_unfused_vocab_takes_lm_loss_like_jax():
    """A vocab with no 128-multiple divisor: the JAX package falls back to
    forward + lm_loss, and so does the port."""
    jcfg = jax_gpt.gpt_tiny(vocab_size=100)
    assert not jax_gpt._use_fused_ce(jcfg)
    assert not gpt._use_fused_ce(port_config(jcfg))
    jmodel = jax_gpt.GPT(jcfg, seed=0)
    state = random_state(jmodel, seed=5)
    jmodel.set_state_dict({k: jnp.asarray(v) for k, v in state.items()})
    model = gpt_from_jax_state(port_config(jcfg), state, device="cpu")
    tokens = np.random.RandomState(6).randint(0, 100, size=(2, 20))
    want = float(jax.jit(lambda t: jax_gpt.fused_lm_loss(jmodel, t))(
        jnp.asarray(tokens)))
    with torch.no_grad():
        got = float(gpt.fused_lm_loss(model, torch.from_numpy(tokens)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_train_state_structure_and_errors():
    model = gpt.GPT(gpt.gpt_tiny(), seed=0, device="cpu")
    opt = AdamW(learning_rate=1e-3)
    params, state = gpt.init_train_state(model, opt)
    assert set(state) == {"step", "slots"} and state["step"] == 0
    assert set(params) == set(state["slots"])
    assert params["stacked.wqkv"] is model.stacked["wqkv"]
    assert all(p.requires_grad for p in params.values())
    step = gpt.build_train_step(model, opt)
    with pytest.raises(ValueError, match="own parameter dict"):
        step({n: p.detach().clone() for n, p in params.items()}, state,
             torch.zeros((1, 8), dtype=torch.int32))
    # a name-keyed decay fn is resolved into a mask per slab, and a
    # dropout config builds (its masks come from the step's key)
    masked = AdamW(apply_decay_param_fun=_decay_fn)
    gpt.init_train_state(model, masked)
    assert set(masked._decay_masks) == {n for n in params
                                        if n.startswith("stacked.")}
    assert masked._decay_masks["stacked.wqkv"].flatten().tolist() == [
        1.0, 1.0]
    assert masked._decay_masks["stacked.ln1_bias"].flatten().tolist() == [
        0.0, 0.0]
    assert gpt.GPT(gpt.gpt_tiny(dropout=0.1),
                   device="cpu").block.dropout == 0.1
