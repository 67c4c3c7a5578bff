"""The port's 16 learning-rate schedules against the JAX package's, on
the CPU: ``value_at`` over steps 0-50 within 1e-6 relative (fp32 pow,
exp and cos of two libraries differ by an ulp or two), and the stateful
API (``step``, ``get_lr``, ``state_dict``, ``set_state_dict``), the
host-side schedules included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.optimizer import lr as jax_lr
from paddle_tpu_torch.optimizer import lr
from torch_reference_compile import fast_reference_compiles  # noqa: F401

TOL = 1e-6


def _lambda(s):
    return 0.95 ** s


# (class, args, kwargs): every schedule, some twice in another mode
CASES = {
    "noam": ("NoamDecay", (64, 10), {"learning_rate": 2.0}),
    "exponential": ("ExponentialDecay", (0.1, 0.93), {}),
    "natural_exp": ("NaturalExpDecay", (0.1, 0.07), {}),
    "inverse_time": ("InverseTimeDecay", (0.1, 0.3), {}),
    "polynomial": ("PolynomialDecay", (0.1, 20),
                   {"end_lr": 0.001, "power": 2.0}),
    "polynomial_cycle": ("PolynomialDecay", (0.1, 7), {"cycle": True}),
    "linear_warmup_float": ("LinearWarmup", (0.05, 10, 0.0, 0.1), {}),
    "piecewise": ("PiecewiseDecay", ([5, 17, 30],
                                     [0.1, 0.05, 0.01, 0.001]), {}),
    "cosine": ("CosineAnnealingDecay", (0.1, 30), {"eta_min": 0.001}),
    "cosine_restarts": ("CosineAnnealingWarmRestarts", (0.1, 9),
                        {"eta_min": 0.002}),
    "multistep": ("MultiStepDecay", (0.1, [4, 11, 40]), {"gamma": 0.5}),
    "step": ("StepDecay", (0.1, 7), {"gamma": 0.7}),
    "lambda": ("LambdaDecay", (0.1, _lambda), {}),
    "one_cycle": ("OneCycleLR", (0.1, 40), {}),
    "cyclic": ("CyclicLR", (0.001, 0.1),
               {"step_size_up": 6, "step_size_down": 4}),
    "cyclic_triangular2": ("CyclicLR", (0.001, 0.1),
                           {"step_size_up": 5, "mode": "triangular2"}),
    "cyclic_exp_range": ("CyclicLR", (0.001, 0.1),
                         {"step_size_up": 5, "mode": "exp_range",
                          "exp_gamma": 0.97}),
    "multiplicative": ("MultiplicativeDecay", (0.1, lambda e: 0.9), {}),
    "plateau": ("ReduceOnPlateau", (0.1,), {"patience": 2}),
}


def _pair(case):
    name, args, kw = CASES[case]
    return getattr(jax_lr, name)(*args, **kw), getattr(lr, name)(*args, **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_value_at_matches_jax(case):
    j, t = _pair(case)
    for s in range(51):
        want = float(j.value_at(jnp.asarray(s, jnp.int32)))
        got = t.value_at(s)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=TOL,
                                   err_msg=f"step {s}")


def test_linear_warmup_wraps_a_schedule():
    """The phase-19 schedule: a 2-step ramp into a cosine over 6."""
    def make(mod):
        return mod.LinearWarmup(mod.CosineAnnealingDecay(1e-4, T_max=6),
                                warmup_steps=2, start_lr=0.0, end_lr=1e-4)
    j, t = make(jax_lr), make(lr)
    for s in range(12):
        np.testing.assert_allclose(
            float(t.value_at(s)), float(j.value_at(jnp.asarray(s))),
            rtol=TOL)
    assert float(t.value_at(0)) == 0.0
    assert float(t.value_at(2)) == pytest.approx(1e-4, rel=1e-6)


@pytest.mark.parametrize("case", ["cosine", "multiplicative", "plateau",
                                  "step"])
def test_stateful_api_matches_jax(case):
    j, t = _pair(case)
    metrics = [5.0, 4.0, 4.0, 4.0, 4.0, 3.0, 3.0, 3.0, 3.0, 3.0]
    for i in range(10):
        if case == "plateau":
            j.step(metrics[i])
            t.step(metrics[i])
        else:
            j.step()
            t.step()
        assert t.last_epoch == j.last_epoch
        np.testing.assert_allclose(t.get_lr(), j.get_lr(), rtol=TOL)
    assert t.state_dict() == j.state_dict()
    d = t.state_dict()
    fresh = _pair(case)[1]
    fresh.set_state_dict(d)
    assert fresh.last_epoch == t.last_epoch
    if case != "plateau":
        # ReduceOnPlateau's state_dict keeps only the epoch, as in JAX
        np.testing.assert_allclose(fresh.get_lr(), t.get_lr(), rtol=TOL)


def test_warm_restarts_reject_t_mult():
    with pytest.raises(ValueError, match="T_mult"):
        lr.CosineAnnealingWarmRestarts(0.1, 5, T_mult=2)
