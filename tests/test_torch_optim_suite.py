"""The port's optimizers, clips and regularizers against the JAX
package's, on the CPU, over gpt_tiny's stacked parameters.

The JAX side holds the stacked layout as ``init_train_state(stacked=
True)`` does: the head entries by name and one nested entry
``_stacked_blocks`` of (L, ...) leaves; the port holds the same tensors
as ``wte``, ``lnf_scale``, ... and ``stacked.<name>``. Both take the
same numpy gradients for 3 steps. fp32 throughout: the two packages run
the same fp32 operations (norms and sums in another order), so the
parameters and every slot agree to 1e-6, as the AdamW tests of
``test_torch_train_step.py`` hold them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jax_optim
from paddle_tpu import regularizer as jax_reg
from paddle_tpu.incubate import optimizer as jax_incubate
from paddle_tpu.optimizer import lr as jax_lr
from paddle_tpu_torch import regularizer
from paddle_tpu_torch.incubate import LookAhead, ModelAverage
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch import optimizer as optim
from paddle_tpu_torch.optimizer import lr
from torch_reference_compile import fast_reference_compiles  # noqa: F401

TOL = 1e-6
STACKED = "_stacked_blocks"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _tiny_params(seed=0):
    """gpt_tiny's parameters as port names -> fp32 numpy arrays (LN
    scales near 1, everything else random)."""
    model = gpt.GPT(gpt.gpt_tiny(), seed=seed, device="cpu")
    rs = np.random.RandomState(seed)
    out = {}
    for n, p in model.named_parameters():
        a = 0.1 * rs.randn(*p.shape).astype(np.float32)
        out[n] = a + 1 if "scale" in n else a
    return out


def _to_jax(tree):
    """port names -> the JAX stacked layout."""
    out = {n: jnp.asarray(v) for n, v in tree.items()
           if not n.startswith("stacked.")}
    out[STACKED] = {n[len("stacked."):]: jnp.asarray(v)
                    for n, v in tree.items() if n.startswith("stacked.")}
    return out


def _from_jax(tree):
    out = {n: np.asarray(v, np.float32) for n, v in tree.items()
           if n != STACKED}
    out.update({f"stacked.{n}": np.asarray(v, np.float32)
                for n, v in tree[STACKED].items()})
    return out


def _slot_leaves(slot):
    if isinstance(slot, (tuple, list)):
        return [np.asarray(s, np.float32) if not isinstance(s, torch.Tensor)
                else s.float().numpy() for s in slot]
    if isinstance(slot, torch.Tensor):
        return [slot.float().numpy()]
    return [np.asarray(slot, np.float32)]


def _jax_slots(state):
    """port name -> list of slot arrays of the JAX state."""
    slots = state["slots"]
    out = {n: _slot_leaves(s) for n, s in slots.items() if n != STACKED}
    for n, s in slots[STACKED].items():
        out[f"stacked.{n}"] = _slot_leaves(s)
    return out


def _decay_fn(name):
    """Decay every matrix; exempt LayerNorm scales and biases; and, so
    that a per-layer decision shows, layer 1's wqkv."""
    if name.endswith("item_1.wqkv"):
        return False
    return not (name.endswith("bias") or "scale" in name)


def _stacked_masks(raw, fn, L):
    """(L, 1, ...) masks per slab from the JAX per-layer names."""
    return {n: np.asarray([float(bool(fn(f"blocks.item_{i}.{n[8:]}")))
                           for i in range(L)], np.float32).reshape(
                               (L,) + (1,) * (v.ndim - 1))
            for n, v in raw.items() if n.startswith("stacked.")}


def _run(make_jax, make_port, steps=3, seed=0, decay_fn=None,
         grad_scale=1.0):
    raw = _tiny_params(seed)
    L = gpt.gpt_tiny().n_layers
    jopt, topt = make_jax(), make_port()
    jp = _to_jax(raw)
    tp = {n: torch.from_numpy(v.copy()) for n, v in raw.items()}
    if decay_fn is not None:
        masks = _stacked_masks(raw, decay_fn, L)
        jopt.set_decay_mask(STACKED, {n[8:]: jnp.asarray(m)
                                      for n, m in masks.items()})
        for n, m in masks.items():
            topt.set_decay_mask(n, torch.from_numpy(m))
    js, ts = jopt.init(jp), topt.init(tp)
    rs = np.random.RandomState(seed + 100)
    for _ in range(steps):
        grads = {n: grad_scale * rs.randn(*v.shape).astype(np.float32)
                 for n, v in raw.items()}
        jp, js = jopt.update(_to_jax(grads), js, jp)
        tp, ts = topt.update({n: torch.from_numpy(g)
                              for n, g in grads.items()}, ts, tp)
    return jp, js, tp, ts, jopt, topt


def _assert_match(jp, js, tp, ts, tol=TOL, slots=True):
    got = {n: t.numpy() for n, t in tp.items()}
    want = _from_jax(jp)
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=tol, atol=tol,
                                   err_msg=n)
    if not slots:
        return
    jslots = _jax_slots(js)
    for n, slot in ts["slots"].items():
        for a, b in zip(_slot_leaves(slot), jslots[n]):
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol,
                                       err_msg=n)


# name -> (JAX kwargs, port kwargs); weight_decay adds the L2 term
OPTIMIZERS = {
    "SGD": dict(learning_rate=0.1, weight_decay=0.01),
    "Momentum": dict(learning_rate=0.05, momentum=0.9),
    "Momentum_nesterov": dict(learning_rate=0.05, momentum=0.8,
                              use_nesterov=True, weight_decay=0.02),
    "Adam": dict(learning_rate=1e-2, weight_decay=0.05),
    "AdamW": dict(learning_rate=1e-2, weight_decay=0.1),
    "Adamax": dict(learning_rate=1e-2, weight_decay=0.01),
    "Adagrad": dict(learning_rate=0.1, initial_accumulator_value=0.1),
    "Adadelta": dict(learning_rate=1.0, rho=0.9),
    "RMSProp": dict(learning_rate=1e-2),
    "RMSProp_centered": dict(learning_rate=1e-2, momentum=0.5,
                             centered=True),
    "Lamb": dict(learning_rate=1e-2, lamb_weight_decay=0.02),
    "Lars": dict(learning_rate=0.1, lars_coeff=0.01),
}


@pytest.mark.parametrize("case", sorted(OPTIMIZERS))
def test_optimizer_matches_jax(case):
    cls = case.split("_")[0]
    kw = OPTIMIZERS[case]
    out = _run(lambda: getattr(jax_optim, cls)(**kw),
               lambda: getattr(optim, cls)(**kw))
    _assert_match(*out[:4])
    assert out[3]["step"] == 3 == int(out[1]["step"])


CLIPS = {
    "value": (lambda: jax_optim.ClipGradByValue(0.5),
              lambda: optim.ClipGradByValue(0.5)),
    "value_min": (lambda: jax_optim.ClipGradByValue(0.7, min=-0.2),
                  lambda: optim.ClipGradByValue(0.7, min=-0.2)),
    # per entry: the slab is one entry, as the JAX stacked leaf
    "norm": (lambda: jax_optim.ClipGradByNorm(1.0),
             lambda: optim.ClipGradByNorm(1.0)),
    "global_norm": (lambda: jax_optim.ClipGradByGlobalNorm(1.0),
                    lambda: optim.ClipGradByGlobalNorm(1.0)),
}


@pytest.mark.parametrize("clip", sorted(CLIPS))
@pytest.mark.parametrize("cls", ["Adam", "SGD", "Momentum"])
def test_clip_matches_jax(clip, cls):
    jclip, tclip = CLIPS[clip]
    out = _run(lambda: getattr(jax_optim, cls)(learning_rate=1e-2,
                                               grad_clip=jclip()),
               lambda: getattr(optim, cls)(learning_rate=1e-2,
                                           grad_clip=tclip()))
    _assert_match(*out[:4])


def test_clip_functions_match_jax():
    """The clipped gradients themselves (the global norm's fp32 sum in
    another order: 1e-6 relative), and ``last_norm``."""
    raw = _tiny_params(3)
    grads = {n: 3 * v for n, v in raw.items()}
    for name, (jclip, tclip) in CLIPS.items():
        t = tclip()
        got = t({n: torch.from_numpy(v) for n, v in grads.items()})
        want = _from_jax(jclip()(_to_jax(grads)))
        for n in want:
            np.testing.assert_allclose(got[n].numpy(), want[n], rtol=TOL,
                                       atol=1e-7, err_msg=(name, n))
    t = optim.ClipGradByGlobalNorm(1.0)
    t({n: torch.from_numpy(v) for n, v in grads.items()})
    want = float(jax_optim.ClipGradByGlobalNorm(1.0).global_norm(
        _to_jax(grads)))
    np.testing.assert_allclose(float(t.last_norm), want, rtol=TOL)


REGULARIZERS = {"L1": ("L1Decay", 0.01), "L2": ("L2Decay", 0.02)}


@pytest.mark.parametrize("reg", sorted(REGULARIZERS))
@pytest.mark.parametrize("cls", ["Adam", "AdamW", "Momentum", "Lamb"])
def test_regularizer_matches_jax(reg, cls):
    """Adam, Momentum and Lamb add ``reg(g, p)`` to the gradient; AdamW
    subtracts ``lr * reg(0, p)`` from the parameter."""
    name, coeff = REGULARIZERS[reg]
    out = _run(lambda: getattr(jax_optim, cls)(
                   learning_rate=1e-2,
                   weight_decay=getattr(jax_reg, name)(coeff)),
               lambda: getattr(optim, cls)(
                   learning_rate=1e-2,
                   weight_decay=getattr(regularizer, name)(coeff)))
    _assert_match(*out[:4])


def _warmup_cosine(mod):
    return mod.LinearWarmup(mod.CosineAnnealingDecay(1e-2, T_max=6),
                            warmup_steps=2, start_lr=0.0, end_lr=1e-2)


@pytest.mark.parametrize("moment", ["float32", "bfloat16"])
def test_adamw_full_options_match_jax(moment):
    """A schedule, the global-norm clip and a layer-varying decay mask
    over the slabs (layer 1's wqkv exempt), 5 steps: the schedule runs
    through its warmup into the cosine."""
    mt = 1e-6 if moment == "float32" else 2.0 ** -7

    def make(mod, clip_mod, dt):
        return lambda: clip_mod.AdamW(
            learning_rate=_warmup_cosine(mod), weight_decay=0.1,
            apply_decay_param_fun=_decay_fn, moment_dtype=dt,
            grad_clip=clip_mod.ClipGradByGlobalNorm(1.0))

    jp, js, tp, ts, jopt, topt = _run(
        make(jax_lr, jax_optim, jnp.dtype(moment)),
        make(lr, optim, moment), steps=5, decay_fn=_decay_fn)
    _assert_match(jp, js, tp, ts, slots=moment == "float32")
    if moment == "bfloat16":
        jslots = _jax_slots(js)
        for n, slot in ts["slots"].items():
            for a, b in zip(_slot_leaves(slot), jslots[n]):
                np.testing.assert_allclose(a, b, rtol=mt, atol=1e-7)
    assert topt.last_lr == float(topt.learning_rate.value_at(5))


def test_decay_mask_honours_each_layer():
    """Layer 1's wqkv is exempt and layer 0's decays: with zero
    gradients the Adam step is 0, so only the decay moves a parameter."""
    raw = _tiny_params(5)
    opt = optim.AdamW(learning_rate=0.1, weight_decay=0.5,
                      apply_decay_param_fun=_decay_fn)
    for n, m in _stacked_masks(raw, _decay_fn, 2).items():
        opt.set_decay_mask(n, torch.from_numpy(m))
    tp = {n: torch.from_numpy(v.copy()) for n, v in raw.items()}
    st = opt.init(tp)
    opt.update({n: torch.zeros_like(p) for n, p in tp.items()}, st, tp)
    w = tp["stacked.wqkv"].numpy()
    np.testing.assert_array_equal(w[1], raw["stacked.wqkv"][1])
    np.testing.assert_allclose(w[0], raw["stacked.wqkv"][0] * (1 - 0.05),
                               rtol=1e-6)
    np.testing.assert_array_equal(tp["stacked.ln1_scale"].numpy(),
                                  raw["stacked.ln1_scale"])
    np.testing.assert_allclose(tp["wte"].numpy(), raw["wte"] * (1 - 0.05),
                               rtol=1e-6)


def test_slab_without_mask_raises():
    """The GPT step refuses a slab with no registered mask when the
    name fn is set (the fn cannot see into a slab); ``init_train_state``
    registers them, and AdamW itself decays an entry without a mask by
    its name."""
    model = gpt.GPT(gpt.gpt_tiny(), seed=0, device="cpu")
    opt = optim.AdamW(apply_decay_param_fun=_decay_fn)
    params = dict(model.named_parameters())
    step = gpt.build_train_step(model, opt)
    tok = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="no registered decay mask"):
        step(params, opt.init(params), tok)
    params, state = gpt.init_train_state(model, opt)
    assert all(opt.decay_mask(n) is not None for n in model.slab_entries())
    step(params, state, tok)
    raw = _tiny_params(0)
    tp = {n: torch.from_numpy(v.copy()) for n, v in raw.items()}
    opt = optim.AdamW(learning_rate=0.5, weight_decay=0.1,
                      apply_decay_param_fun=lambda n: n == "stacked.wqkv")
    opt.update({n: torch.zeros_like(p) for n, p in tp.items()},
               opt.init(tp), tp)
    np.testing.assert_allclose(tp["stacked.wqkv"].numpy(),
                               raw["stacked.wqkv"] * (1 - 0.05), rtol=1e-6)
    np.testing.assert_array_equal(tp["stacked.wup"].numpy(),
                                  raw["stacked.wup"])


def test_stateful_api_matches_jax():
    """bind / step / get_lr / state_dict / set_state_dict with a
    schedule, against the JAX stateful wrapper."""
    raw = _tiny_params(1)
    jopt = jax_optim.Momentum(learning_rate=_warmup_cosine(jax_lr))
    topt = optim.Momentum(learning_rate=_warmup_cosine(lr))
    jopt.bind(_to_jax(raw))
    topt.bind({n: torch.from_numpy(v.copy()) for n, v in raw.items()})
    rs = np.random.RandomState(7)
    for _ in range(3):
        g = {n: rs.randn(*v.shape).astype(np.float32)
             for n, v in raw.items()}
        jopt.step(_to_jax(g))
        topt.step({n: torch.from_numpy(x) for n, x in g.items()})
        assert topt.get_lr() == pytest.approx(jopt.get_lr(), rel=1e-6)
    _assert_match(jopt.params, jopt._state, topt.params, topt._state)
    d = topt.state_dict()
    assert d["state"]["step"] == 3 and "lr" in d
    fresh = optim.Momentum(learning_rate=_warmup_cosine(lr))
    fresh.set_state_dict(d)
    assert fresh.learning_rate.last_epoch == d["lr"]["last_epoch"]
    p = {n: torch.zeros(1, requires_grad=True) for n in ("a", "b")}
    for t in p.values():
        t.grad = torch.ones(1)
    optim.SGD(parameters=p).clear_grad()
    assert all(t.grad is None for t in p.values())


# ---------------------------------------------------------------------------
# incubate: LookAhead and ModelAverage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2])
def test_lookahead_matches_jax(k):
    out = _run(lambda: jax_incubate.LookAhead(
                   jax_optim.Adam(learning_rate=1e-2), alpha=0.4, k=k),
               lambda: LookAhead(optim.Adam(learning_rate=1e-2), alpha=0.4,
                                 k=k), steps=5)
    jp, js, tp, ts = out[:4]
    _assert_match(jp, js["inner"], tp, ts["inner"])
    slow = _from_jax(js["slow"])
    for n, v in ts["slow"].items():
        np.testing.assert_allclose(v.numpy(), slow[n], rtol=TOL, atol=TOL)
    assert ts["step"] == 5 == int(js["step"])
    # attributes reach the inner optimizer
    assert out[5].beta1 == 0.9


def test_model_average_matches_jax():
    raw = _tiny_params(2)
    jma = jax_incubate.ModelAverage(average_window_rate=0.3,
                                    min_average_window=2,
                                    max_average_window=4)
    tma = ModelAverage(average_window_rate=0.3, min_average_window=2,
                       max_average_window=4)
    js = jma.init(_to_jax(raw))
    ts = tma.init({n: torch.from_numpy(v) for n, v in raw.items()})
    rs = np.random.RandomState(3)
    for i in range(9):
        p = {n: rs.randn(*v.shape).astype(np.float32)
             for n, v in raw.items()}
        js = jma.accumulate(js, _to_jax(p))
        ts = tma.accumulate(ts, {n: torch.from_numpy(v)
                                 for n, v in p.items()})
        for key in ("n_cur", "n_prev", "total"):
            assert ts[key] == int(js[key]), (i, key)
        want = _from_jax(jma.apply(js, None))
        got = tma.apply(ts, None)
        for n in want:
            np.testing.assert_allclose(got[n].numpy(), want[n], rtol=TOL,
                                       atol=TOL, err_msg=(i, n))
    live = {"w": torch.ones(2)}
    assert tma.restore(live) is live
