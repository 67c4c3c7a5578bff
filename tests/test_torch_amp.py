"""The port's amp against the JAX package's, on the CPU: the O1 region
(``auto_cast``, ``amp_cast``, the lists, ``nn.functional.linear``), the
O2 cast (``decorate``) and ``GradScaler``'s functional state, whose
sequence under injected infs must equal the JAX one exactly."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.amp.grad_scaler import GradScaler as JaxScaler
from paddle_tpu.nn import functional as jax_F
from paddle_tpu_torch import amp
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.amp.auto_cast import amp_cast
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.nn import functional as F
from torch_reference_compile import fast_reference_compiles  # noqa: F401

# the module (the package re-exports its function under the same name)
jax_ac = importlib.import_module("paddle_tpu.amp.auto_cast")


def test_lists_match_jax():
    assert amp.white_list() == jax_ac.white_list()
    assert amp.black_list() == jax_ac.black_list()


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_o1_region_casts_like_jax(dtype):
    x = np.random.RandomState(0).randn(3, 8).astype(np.float32)
    w = np.random.RandomState(1).randn(8, 4).astype(np.float32)
    b = np.random.RandomState(2).randn(4).astype(np.float32)
    with amp.auto_cast(dtype=dtype), jax_ac.auto_cast(dtype=dtype):
        assert amp.get_amp_dtype() == getattr(torch, dtype)
        assert amp_cast(torch.ones(2)).dtype == getattr(torch, dtype)
        assert amp_cast(torch.ones(2), op_class="black").dtype == \
            torch.float32
        assert amp_cast(torch.ones(2, dtype=torch.int32)).dtype == \
            torch.int32
        got = F.linear(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(b))
        want = jax_F.linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    assert str(got.dtype).endswith(dtype) and str(want.dtype) == dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2 ** -7, atol=2 ** -6)
    # outside the region nothing is cast
    assert amp.get_amp_dtype() is None
    assert F.linear(torch.from_numpy(x), torch.from_numpy(w)).dtype == \
        torch.float32
    with amp.auto_cast(enable=False):
        assert amp_cast(torch.ones(2)).dtype == torch.float32


def test_o2_decorate_casts_every_floating_param():
    model = gpt.GPT(gpt.gpt_tiny(), seed=0, device="cpu")
    opt = object()
    m, o = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    assert m is model and o is opt
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    assert amp.decorate(model, level="O1") is model
    ms = amp.decorate([gpt.GPT(gpt.gpt_tiny(), seed=0, device="cpu")],
                      level="O2", dtype="float16")
    assert all(p.dtype == torch.float16 for p in ms[0].parameters())


def _state_tuple(s):
    return (float(s["scale"]), int(s["good"]), int(s["bad"]))


@pytest.mark.parametrize("kw", [
    dict(init_loss_scaling=2.0 ** 4, decr_every_n_nan_or_inf=1,
         incr_every_n_steps=3),
    dict(init_loss_scaling=2.0, decr_every_n_nan_or_inf=2,
         incr_every_n_steps=2, decr_ratio=0.25),
    dict(use_dynamic_loss_scaling=False),
])
def test_scaler_state_sequence_equals_jax(kw):
    """Steps with an inf or a NaN planted in some: the found flags, the
    unscaled gradients and every (scale, good, bad) equal exactly."""
    jsc, tsc = JaxScaler(**kw), GradScaler(**kw)
    js, ts = jsc.init_state(), tsc.init_state()
    rs = np.random.RandomState(0)
    plant = {2: np.inf, 3: np.nan, 4: np.inf, 9: -np.inf}
    for i in range(12):
        g = {"w": rs.randn(3, 4).astype(np.float32),
             "b": rs.randn(4).astype(np.float32)}
        if i in plant:
            g["w"][1, 2] = plant[i]
        jg, jfound = jsc.unscale_and_check(
            {n: jnp.asarray(v) for n, v in g.items()}, js)
        tg, tfound = tsc.unscale_and_check(
            {n: torch.from_numpy(v) for n, v in g.items()}, ts)
        assert bool(tfound) == bool(jfound) == (i in plant)
        for n in g:
            np.testing.assert_array_equal(tg[n].numpy(), np.asarray(jg[n]))
        js, ts = jsc.update_state(js, jfound), tsc.update_state(ts, tfound)
        assert _state_tuple(ts) == _state_tuple(js), i
    loss = torch.tensor(1.5)
    assert float(tsc.scale_loss(loss, ts)) == float(
        jsc.scale_loss(jnp.float32(1.5), js))


def test_scaler_apply_or_skip_and_eager_api():
    sc = GradScaler(init_loss_scaling=2.0 ** 4, decr_every_n_nan_or_inf=1)
    params = {"w": torch.ones(3)}
    new = {"w": torch.zeros(3)}
    _, found = sc.unscale_and_check({"w": torch.tensor([1.0, np.inf, 0])},
                                    sc.init_state())
    kept, _ = sc.apply_or_skip(new, {"step": torch.tensor(1)}, params,
                               {"step": torch.tensor(0)}, found)
    assert torch.equal(kept["w"], params["w"])
    sc.unscale_({"w": torch.tensor([np.nan])})
    sc.update()
    assert sc.get_loss_scaling() == 8.0
    assert float(sc.scale(torch.tensor(2.0))) == 16.0
    d = sc.state_dict()
    other = GradScaler()
    other.load_state_dict(d)
    assert other.get_loss_scaling() == 8.0 and other.is_enable()
    off = GradScaler(enable=False)
    g, f = off.unscale_and_check({"w": torch.tensor([np.inf])},
                                 off.init_state())
    assert not bool(f) and float(off.scale_loss(torch.tensor(3.0),
                                                None)) == 3.0
