"""The port's full-option GPT train step against the JAX package's, on
the CPU: dropout from a JAX key, a schedule, the global-norm clip and a
layer-varying decay mask, against JAX ``init_train_state(stacked=True)``
and ``build_train_step``.

fp32 throughout. The dropout masks are the same bits (``jax.random``'s
Threefry), so the zero pattern is equal exactly and the two steps differ
only in summation order: losses agree to 1e-5, parameters after 3 steps
to 2e-5 (the tolerances ``test_torch_train_step.py`` holds the plain
step to, with its noise floor for the entries whose gradient is at the
rounding level).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jax_optim
from paddle_tpu.models import gpt as jax_gpt
from paddle_tpu.optimizer import lr as jax_lr
from paddle_tpu_torch import random as prng
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.models.convert import (gpt_from_jax_state,
                                             gpt_to_jax_state)
from paddle_tpu_torch import optimizer as optim
from paddle_tpu_torch.optimizer import lr

from test_torch_gpt import JAX_CONFIGS, port_config, random_state
from test_torch_train_step import NOISE_ATOL
from torch_reference_compile import fast_reference_compiles  # noqa: F401

P = 0.1


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _decay_fn(name):
    """Exempt LayerNorm scales and biases, and layer 1's wqkv (a
    decision that varies by layer)."""
    if name == "blocks.item_1.wqkv":
        return False
    return not (name.endswith("bias") or "scale" in name)


def _models(name="gpt_tiny", remat=False, seed=1):
    jcfg = dataclasses.replace(JAX_CONFIGS[name], dropout=P, remat=remat)
    jmodel = jax_gpt.GPT(jcfg, seed=0)
    state = random_state(jmodel, seed=seed)
    jmodel.set_state_dict({k: jnp.asarray(v) for k, v in state.items()})
    cfg = dataclasses.replace(port_config(jcfg), dropout=P, remat=remat)
    model = gpt_from_jax_state(cfg, state, device="cpu")
    return jcfg, jmodel, model


def _tokens(jcfg, seed=2):
    return np.random.RandomState(seed).randint(
        0, jcfg.vocab_size, size=(2, 32)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 32, 64), (3, 7, 5)])
def test_dropout_mask_equals_jax(shape, dtype):
    """The residual dropout of one layer, salts 1 and 2: the same zeros
    and the same kept values (x / (1 - p) in x's dtype) as the JAX
    ``_maybe_dropout``."""
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    for layer, salt in ((0, 1), (1, 2), (5, 1)):
        jk = jax.random.fold_in(jax.random.PRNGKey(0), layer)
        tk = prng.fold_in(prng.PRNGKey(0), layer)
        want = np.asarray(jax_gpt._maybe_dropout(jx, P, jk, salt),
                          np.float32)
        got = gpt._maybe_dropout(tx, P, tk, salt).float().numpy()
        np.testing.assert_array_equal(got == 0, want == 0)
        np.testing.assert_array_equal(got, want)


def test_dropout_off_without_key_or_rate():
    x = torch.randn(2, 3)
    assert gpt._maybe_dropout(x, P, None, 1) is x
    assert gpt._maybe_dropout(x, 0.0, prng.PRNGKey(0), 1) is x


@pytest.mark.parametrize("remat", [False, True])
def test_dropout_loss_matches_jax(remat):
    """The fused-CE loss at dropout 0.1 with a key, and without one."""
    jcfg, jmodel, model = _models(remat=remat)
    tok = _tokens(jcfg)
    # jitted (op by op the loss takes several times longer)
    jloss = jax.jit(lambda t, key: jax_gpt.fused_lm_loss(jmodel, t,
                                                         rng_key=key))
    for seed in (0, 7):
        want = float(jloss(jnp.asarray(tok), jax.random.PRNGKey(seed)))
        with torch.no_grad():
            got = float(gpt.fused_lm_loss(model, torch.from_numpy(tok),
                                          rng_key=prng.PRNGKey(seed)))
        np.testing.assert_allclose(got, want, rtol=1e-5)
    with torch.no_grad():
        plain = float(gpt.fused_lm_loss(model, torch.from_numpy(tok)))
    np.testing.assert_allclose(
        plain, float(jax.jit(lambda t: jax_gpt.fused_lm_loss(jmodel, t))(
            jnp.asarray(tok))), rtol=1e-5)
    assert abs(plain - got) > 1e-3     # the key did drop entries


def _optimizers():
    def sched(mod):
        return mod.LinearWarmup(mod.CosineAnnealingDecay(1e-3, T_max=6),
                                warmup_steps=2, start_lr=0.0, end_lr=1e-3)
    jopt = jax_optim.AdamW(learning_rate=sched(jax_lr), weight_decay=0.01,
                           apply_decay_param_fun=_decay_fn,
                           grad_clip=jax_optim.ClipGradByGlobalNorm(1.0))
    topt = optim.AdamW(learning_rate=sched(lr), weight_decay=0.01,
                       apply_decay_param_fun=_decay_fn,
                       grad_clip=optim.ClipGradByGlobalNorm(1.0))
    return jopt, topt


def _jax_flat(jmodel, jparams):
    """The JAX stacked state as ``blocks.item_<i>.<name>`` + head names."""
    out = {n: np.asarray(v, np.float32) for n, v in jparams.items()
           if n != "_stacked_blocks"}
    blk = jparams["_stacked_blocks"]
    for n, _ in jmodel.blocks[0].named_parameters():
        slab = np.asarray(getattr(blk, n), np.float32)
        for i in range(slab.shape[0]):
            out[f"blocks.item_{i}.{n}"] = slab[i]
    return out


def _jax_grads(jmodel, jparams, jtok, jkey):
    """The JAX loss's gradients at ``jparams``, jitted (op by op they
    take several times longer)."""
    return jax.jit(jax.grad(lambda p: jax_gpt.fused_lm_loss(
        jmodel.merge_params(p), jtok, rng_key=jkey)))(jparams)


@pytest.mark.parametrize("remat", [False, True])
def test_full_option_train_step_matches_jax(remat):
    jcfg, jmodel, model = _models(remat=remat)
    tok = _tokens(jcfg)
    jtok = jnp.asarray(tok)
    jopt, topt = _optimizers()
    jparams, jstate = jax_gpt.init_train_state(jmodel, jopt, stacked=True)
    jkey = jax.random.PRNGKey(0)
    jgrads = _jax_flat(jmodel, _jax_grads(jmodel, jparams, jtok, jkey))
    jstep = jax_gpt.build_train_step(jmodel, jopt, donate=False)
    params, state = gpt.init_train_state(model, topt)
    step = gpt.build_train_step(model, topt)
    ttok = torch.from_numpy(tok)
    key = prng.PRNGKey(0)
    for i in range(3):
        jparams, jstate, jloss = jstep(jparams, jstate, jtok, jkey)
        params, state, loss = step(params, state, ttok, key)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                                   err_msg=f"loss of step {i + 1}")
        assert topt.last_lr == float(topt.learning_rate.value_at(i + 1))
        if i == 0:
            got = gpt_to_jax_state(model, grads=True)
            for n, g in got.items():
                want = jgrads[n]
                err = np.linalg.norm(g - want) / max(
                    np.linalg.norm(want), 1e-30)
                assert err <= 1e-4, n
    want = _jax_flat(jmodel, jparams)
    got = gpt_to_jax_state(model)
    assert sorted(got) == sorted(want)
    for n, p in got.items():
        g = np.abs(jgrads[n])
        atol = np.where(g > 1e-4 * g.max(), 2e-5, NOISE_ATOL)
        excess = np.abs(p - want[n]) - atol
        assert excess.max() <= 0, (n, float(excess.max()))


def test_decay_masks_registered_per_layer():
    """``init_train_state`` resolves the fn under the JAX per-layer
    names into (L, 1, ...) masks on the slabs, layer 1's wqkv exempt."""
    model = gpt.GPT(gpt.gpt_tiny(), seed=0, device="cpu")
    opt = optim.AdamW(apply_decay_param_fun=_decay_fn)
    gpt.init_train_state(model, opt)
    masks = opt._decay_masks
    assert sorted(masks) == sorted(f"stacked.{n}" for n in model.stacked)
    assert masks["stacked.wqkv"].shape == (2, 1, 1)
    assert masks["stacked.wqkv"].flatten().tolist() == [1.0, 0.0]
    assert masks["stacked.ln1_scale"].flatten().tolist() == [0.0, 0.0]
    assert masks["stacked.wup"].flatten().tolist() == [1.0, 1.0]
    with pytest.raises(ValueError, match="set_decay_mask"):
        sgd = optim.SGD()
        sgd.apply_decay_param_fun = _decay_fn
        gpt.init_train_state(model, sgd)


def test_three_argument_step_and_dropout_train():
    """The old three-argument call still trains (no key: no dropout), and
    a dropout model's loss falls over a few keyed steps."""
    model = gpt.GPT(gpt.gpt_tiny(dropout=P), seed=3, device="cpu")
    opt = optim.AdamW(learning_rate=1e-2)
    params, state = gpt.init_train_state(model, opt)
    step = gpt.build_train_step(model, opt)
    tok = torch.from_numpy(np.random.RandomState(4).randint(
        0, 256, size=(2, 24)).astype(np.int32))
    params, state, l0 = step(params, state, tok)
    losses = [float(step(params, state, tok, prng.PRNGKey(i))[2])
              for i in range(6)]
    assert np.isfinite(losses).all() and losses[-1] < float(l0)


def _other_optimizers(mod, reg_mod):
    """Other optimizers of the step, each with a clip or a regularizer."""
    return {
        "momentum_l2": lambda: mod.Momentum(
            learning_rate=1e-2, use_nesterov=True,
            weight_decay=reg_mod.L2Decay(0.01),
            grad_clip=mod.ClipGradByNorm(1.0)),
        "lamb": lambda: mod.Lamb(learning_rate=1e-3),
        "lars_l1": lambda: mod.Lars(learning_rate=0.1,
                                    weight_decay=reg_mod.L1Decay(1e-3)),
        "adamw_l1_value_clip": lambda: mod.AdamW(
            learning_rate=1e-3, weight_decay=reg_mod.L1Decay(0.01),
            grad_clip=mod.ClipGradByValue(0.05)),
    }


@pytest.mark.parametrize("case", ["momentum_l2", "lamb", "lars_l1",
                                  "adamw_l1_value_clip"])
def test_other_optimizers_train_like_jax(case):
    """Two dropout steps through each package's train step with another
    optimizer: the same losses and parameters (the tolerances above)."""
    from paddle_tpu import regularizer as jax_reg
    from paddle_tpu_torch import regularizer
    jcfg, jmodel, model = _models()
    tok = _tokens(jcfg)
    jtok = jnp.asarray(tok)
    jopt = _other_optimizers(jax_optim, jax_reg)[case]()
    topt = _other_optimizers(optim, regularizer)[case]()
    jparams, jstate = jax_gpt.init_train_state(jmodel, jopt, stacked=True)
    jkey = jax.random.PRNGKey(3)
    jgrads = _jax_flat(jmodel, _jax_grads(jmodel, jparams, jtok, jkey))
    jstep = jax_gpt.build_train_step(jmodel, jopt, donate=False)
    params, state = gpt.init_train_state(model, topt)
    step = gpt.build_train_step(model, topt)
    for i in range(2):
        jparams, jstate, jloss = jstep(jparams, jstate, jtok, jkey)
        params, state, loss = step(params, state, torch.from_numpy(tok),
                                   prng.PRNGKey(3))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                                   err_msg=f"loss of step {i + 1}")
    want = _jax_flat(jmodel, jparams)
    for n, p in gpt_to_jax_state(model).items():
        g = np.abs(jgrads[n])
        atol = np.where(g > 1e-4 * g.max(), 2e-5, NOISE_ATOL)
        excess = np.abs(p - want[n]) - atol
        assert excess.max() <= 0, (n, float(excess.max()))
