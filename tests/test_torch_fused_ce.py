"""Port kernels K5/K6/K7 (fused softmax cross-entropy): the plain
versions ``fused_ce_reference`` and ``fused_ce_bwd_reference``, which CPU
tensors take through the differentiable ``fused_softmax_cross_entropy``,
against the JAX package's ``fused_softmax_cross_entropy`` (Pallas,
interpret mode on the CPU) and its ``jax.grad``, in fp32. The CUDA
kernels are held against the same plain versions on the GPU
(tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.fused_ce import _pick_block_v
from paddle_tpu.ops.pallas.fused_ce import (
    fused_softmax_cross_entropy as jax_fused_ce)
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.ops.fused_ce import (
    fused_ce_bwd_reference, fused_ce_dw, fused_ce_dx, fused_ce_fwd,
    fused_ce_plain, fused_ce_reference, fused_softmax_cross_entropy)

# fp32 on both sides; the logsumexp runs online over 128-512-wide vocab
# blocks in JAX and in one pass here, and dx/dw sum over the vocab or
# the rows in another order
ATOL = RTOL = 2e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


CASES = {
    # name: (n, d, V, ignored-label stride); n ragged against JAX's
    # 128-row block and the kernels' 64-row tile
    "v512": (200, 32, 512, 5),
    "v1152_block_v384": (130, 64, 1152, 3),
    "v256_all_valid": (64, 16, 256, 0),
}


def _inputs(name):
    n, d, V, stride = CASES[name]
    rs = np.random.RandomState(sorted(CASES).index(name))
    x = rs.randn(n, d).astype(np.float32)
    w = (0.5 * rs.randn(V, d)).astype(np.float32)
    labels = rs.randint(0, V, size=n).astype(np.int32)
    if stride:
        labels[::stride] = -1
    g = rs.randn(n).astype(np.float32)
    return x, w, labels, g


def test_fused_loss_vocab_rule_matches_jax():
    """The GPT loss takes the fused CE for exactly the vocabularies whose
    JAX vocab tile rule finds a block (a 128-multiple divisor)."""
    for V in (50304, 1152, 512, 256, 128, 100, 32000, 50257):
        try:
            _pick_block_v(V, 512)
            want = True
        except ValueError:
            want = False
        assert gpt._use_fused_ce(gpt.gpt_tiny(vocab_size=V)) == want, V


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax(name):
    x, w, labels, _ = _inputs(name)
    want = np.asarray(jax_fused_ce(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(labels), interpret=True))
    got = fused_softmax_cross_entropy(torch.from_numpy(x),
                                      torch.from_numpy(w),
                                      torch.from_numpy(labels))
    assert got.dtype == torch.float32 and got.shape == (x.shape[0],)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    assert np.all(got.numpy()[labels < 0] == 0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_matches_jax_grad(name):
    x, w, labels, g = _inputs(name)

    def loss(x, w):
        per = jax_fused_ce(x, w, jnp.asarray(labels), interpret=True)
        return jnp.sum(per * jnp.asarray(g))

    want_dx, want_dw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x),
                                                      jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    per = fused_softmax_cross_entropy(xt, wt, torch.from_numpy(labels))
    dx, dw = torch.autograd.grad(per, (xt, wt), torch.from_numpy(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw), atol=ATOL,
                               rtol=RTOL)
    # ignored rows get exactly zero gradient
    assert np.all(dx.numpy()[labels < 0] == 0)


def test_plain_functions_agree_with_torch_cross_entropy():
    x, w, labels, g = _inputs("v512")
    xt, wt, lt = (torch.from_numpy(a) for a in (x, w, labels))
    loss, lse = fused_ce_reference(xt, wt, lt)
    logits = xt @ wt.t()
    want = torch.nn.functional.cross_entropy(
        logits, lt.long(), ignore_index=-1, reduction="none")
    torch.testing.assert_close(loss, want, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1))
    gt = torch.from_numpy(g)
    dx, dw = fused_ce_bwd_reference(xt, wt, lt, lse, gt)
    xg, wg = xt.clone().requires_grad_(), wt.clone().requires_grad_()
    ce = torch.nn.functional.cross_entropy(
        xg @ wg.t(), lt.long(), ignore_index=-1, reduction="none")
    want_dx, want_dw = torch.autograd.grad(ce, (xg, wg), gt)
    torch.testing.assert_close(dx, want_dx, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(dw, want_dw, atol=ATOL, rtol=RTOL)


def test_cpu_path_is_the_plain_path_and_counts_no_launch():
    x, w, labels, g = _inputs("v256_all_valid")
    fns = (fused_ce_fwd, fused_ce_dx, fused_ce_dw)
    before = [f.launches for f in fns]
    out = []
    for fn in (fused_softmax_cross_entropy, fused_ce_plain):
        xt = torch.from_numpy(x).requires_grad_()
        wt = torch.from_numpy(w).requires_grad_()
        per = fn(xt, wt, torch.from_numpy(labels))
        out.append((per,) + torch.autograd.grad(per, (xt, wt),
                                                torch.from_numpy(g)))
    for a, b in zip(*out):
        assert torch.equal(a, b)
    assert [f.launches for f in fns] == before


def test_shape_errors_raise():
    x = torch.zeros(4, 16)
    with pytest.raises(ValueError, match="w \\(V, d\\)"):
        fused_softmax_cross_entropy(x, torch.zeros(8, 12),
                                    torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="labels"):
        fused_softmax_cross_entropy(x, torch.zeros(8, 16),
                                    torch.zeros(3, dtype=torch.int32))
