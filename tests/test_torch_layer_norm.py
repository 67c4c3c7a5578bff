"""Port kernel K11 (fused bias + dropout + residual + LayerNorm): the
plain version ``fused_layer_norm_reference`` and the differentiable
``fused_layer_norm`` (CPU tensors take the plain version; the backward
is plain PyTorch on every device, as in JAX) against the JAX package's
``fused_layer_norm``: its Pallas kernel in interpret mode at N 128 and
its XLA path at N 96 (the Pallas path needs N % 128 == 0), in fp32 on
the CPU. The dropout mask must equal JAX's ``dropout_keep_mask`` bit for
bit. The CUDA kernel is held against the same plain version on the GPU
(tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import layer_norm as jax_ln
from paddle_tpu_torch.ops import _hash
from paddle_tpu_torch.ops import layer_norm as ln
from paddle_tpu_torch.ops.layer_norm import (fused_layer_norm,
                                             fused_layer_norm_plain,
                                             fused_layer_norm_fwd,
                                             fused_layer_norm_reference)
from torch_reference_compile import fast_reference_compiles  # noqa: F401

FWD_TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.mark.parametrize("seed, rate, row0", list(itertools.product(
    [0, 1, -1, -2 ** 31, 2 ** 31 - 1], [0.1, 0.5, 0.9], [0, 37])))
def test_keep_mask_matches_jax_bit_for_bit(seed, rate, row0):
    want = np.asarray(jax_ln.dropout_keep_mask(
        jnp.int32(seed), row0, 96, (24, 96), rate))
    got = _hash.layer_norm_keep(seed, (24, 96), rate, row0=row0).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1


def _inputs(n, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(3, 20, n).astype(np.float32)
    res = rs.randn(3, 20, n).astype(np.float32)
    gamma = (1 + 0.3 * rs.randn(n)).astype(np.float32)
    beta = rs.randn(n).astype(np.float32)
    bias = rs.randn(n).astype(np.float32)
    dy = rs.randn(3, 20, n).astype(np.float32)
    dpre = rs.randn(3, 20, n).astype(np.float32)
    return x, res, gamma, beta, bias, dy, dpre


@pytest.mark.parametrize("n", [128, 96])
@pytest.mark.parametrize("rate, seed", [(0.0, 0), (0.25, -7), (0.5, 99)])
def test_plain_forward_matches_jax(n, rate, seed):
    """y, pre, mean and rstd of the plain version against the JAX
    forward (Pallas interpret at N 128, XLA at N 96)."""
    x, res, gamma, beta, bias, _, _ = _inputs(n)
    x2, r2 = x.reshape(-1, n), res.reshape(-1, n)
    (y, pre), (_, mean, rstd, *_) = jax_ln._fused_ln_fwd(
        jnp.asarray(x2), jnp.asarray(gamma), jnp.asarray(beta),
        jnp.asarray(bias), jnp.asarray(r2),
        jnp.asarray([seed], jnp.int32), 1e-5, rate, True)
    got = fused_layer_norm_reference(
        torch.from_numpy(x2), torch.from_numpy(gamma),
        torch.from_numpy(beta), torch.from_numpy(bias),
        torch.from_numpy(r2), seed, 1e-5, rate)
    for g, w, what in zip(got, (y, pre, mean, rstd),
                          ("y", "pre", "mean", "rstd")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=FWD_TOL,
                                   rtol=FWD_TOL, err_msg=what)


@pytest.mark.parametrize("n", [128, 96])
@pytest.mark.parametrize("dropout, has_bias, has_res",
                         list(itertools.product([False, True], repeat=3)))
def test_grads_match_jax(n, dropout, has_bias, has_res):
    """All five gradients (x, gamma, beta, bias, residual) of
    sum(y * dy) + sum(pre * dpre), each input on and off."""
    x, res, gamma, beta, bias, dy, dpre = _inputs(n, seed=n)
    rate, seed = (0.3, -123) if dropout else (0.0, None)
    bias = bias if has_bias else None
    res = res if has_res else None

    def jloss(x, gamma, beta, bias, res):
        y, pre = jax_ln.fused_layer_norm(
            x, gamma, beta, residual=res, bias=bias, dropout_p=rate,
            dropout_seed=seed)
        return jnp.sum(y * dy) + jnp.sum(pre * dpre)

    argnums = (0, 1, 2) + ((3,) if has_bias else ()) + \
        ((4,) if has_res else ())
    want = jax.jit(jax.grad(jloss, argnums=argnums))(
        *(None if a is None else jnp.asarray(a)
          for a in (x, gamma, beta, bias, res)))
    ts = [None if a is None else torch.from_numpy(a).requires_grad_()
          for a in (x, gamma, beta, bias, res)]
    y, pre = fused_layer_norm(ts[0], ts[1], ts[2], residual=ts[4],
                              bias=ts[3], dropout_p=rate,
                              dropout_seed=seed)
    (y * torch.from_numpy(dy) + pre * torch.from_numpy(dpre)).sum() \
        .backward()
    got = [ts[i].grad for i in argnums]
    for g, w, i in zip(got, want, argnums):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=f"grad {i}")


def test_dropout_zeroes_the_masked_cells_and_scales_the_rest():
    x = torch.ones(16, 96)
    y, pre = fused_layer_norm(x, torch.ones(96), torch.zeros(96),
                              dropout_p=0.25, dropout_seed=3)
    keep = _hash.layer_norm_keep(3, (16, 96), 0.25)
    assert torch.equal(pre != 0, keep)
    torch.testing.assert_close(pre[keep], torch.full_like(pre[keep],
                                                          1 / 0.75))


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    x, res, gamma, beta, bias, _, _ = _inputs(96)
    args = [torch.from_numpy(a) for a in (x, gamma, beta)]
    kw = dict(residual=torch.from_numpy(res), bias=torch.from_numpy(bias),
              dropout_p=0.1, dropout_seed=5)
    before = fused_layer_norm_fwd.launches
    a = fused_layer_norm(*args, **kw)
    b = fused_layer_norm_plain(*args, **kw)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert fused_layer_norm_fwd.launches == before


def test_bf16_rounds_y_and_pre_and_keeps_fp32_stats():
    x, res, gamma, beta, bias, _, _ = _inputs(96)
    x2 = torch.from_numpy(x.reshape(-1, 96)).bfloat16()
    y, pre, mean, rstd = fused_layer_norm_reference(
        x2, torch.from_numpy(gamma), torch.from_numpy(beta),
        torch.from_numpy(bias), None, 0, 1e-5, 0.0)
    assert y.dtype == pre.dtype == torch.bfloat16
    assert mean.dtype == rstd.dtype == torch.float32
    assert mean.shape == rstd.shape == (60, 1)


def test_argument_errors():
    x = torch.zeros(2, 8)
    g = torch.ones(8)
    with pytest.raises(ValueError, match="dropout_seed"):
        fused_layer_norm(x, g, g, dropout_p=0.1)
    with pytest.raises(ValueError, match="dropout_p"):
        fused_layer_norm(x, g, g, dropout_p=1.0, dropout_seed=0)


def test_tensor_seed_equals_int_seed_forward_and_backward():
    """K11 seeded by a tensor made from a key (``key_seed``) drops what
    its int value drops, in the forward and in the backward's replay."""
    from paddle_tpu_torch import random as prng
    from paddle_tpu_torch.nn.functional.attention import key_seed
    x, res, gamma, beta, bias, dy, _ = _inputs(96)
    seed = key_seed(prng.PRNGKey(9), "cpu")
    out = []
    for s in (seed, int(seed)):
        ts = [torch.from_numpy(a).requires_grad_()
              for a in (x, gamma, beta, bias, res)]
        y, pre = fused_layer_norm(ts[0], ts[1], ts[2], residual=ts[4],
                                  bias=ts[3], dropout_p=0.3,
                                  dropout_seed=s)
        (y * torch.from_numpy(dy)).sum().backward()
        out.append([y.detach(), pre.detach()] + [t.grad for t in ts])
    for a, b in zip(*out):
        assert torch.equal(a, b)


# ---- the kernel's launch plan and its vectors (pure Python) ------------

H100_SMS = 132


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 7, 33, 768, 1000, 1024, 1025, 4096,
                               16384])
def test_plan_covers_the_row_with_a_shape_the_kernel_takes(n, dtype,
                                                            aligned):
    """``_plan``: a warp per row up to WARP_MAX_N, else a block; 16-byte
    accesses only when aligned and N is a multiple of their width; every
    element of the row held by one thread; the limits the C entry checks
    (csrc/layer_norm.cu: elems 8/16/24/32 for a warp, 32 for a block,
    threads a multiple of 32 up to 256 / 512)."""
    m = 8192
    plan = ln._plan(m, n, dtype, aligned, H100_SMS)
    width = 16 // dtype.itemsize
    assert plan.vec == (width if aligned and n % width == 0 else 1)
    assert plan.elems % plan.vec == 0 and plan.threads % 32 == 0
    if n <= ln.WARP_MAX_N:
        assert plan.variant == "warp" and plan.threads == 256
        assert plan.elems in (8, 16, 24, 32) and 32 * plan.elems >= n
        assert 32 * (plan.elems - 8) < n       # no whole idle access
        assert plan.grid == min(m // 8, H100_SMS * ln._WARP_BLOCKS_PER_SM)
    else:
        assert plan.variant == "block" and plan.elems == 32
        assert plan.threads * 32 >= n > (plan.threads - 32) * 32
        assert plan.threads <= 512
        assert H100_SMS <= plan.grid <= min(m, H100_SMS * 64)


def test_plan_at_the_encoders_rows_and_for_few_rows():
    """The encoder's K11 (M 8192, N 768, bf16, aligned): 24 values a lane
    in 16-byte accesses, 8 rows a block, a persistent grid; one row
    launches one block; the widest row fits the shared memory of its
    staged fp32 vectors at one block an SM."""
    plan = ln._plan(8192, 768, torch.bfloat16, True, 132)
    assert plan == ln.Plan("warp", 8, 24, 256, 264)
    assert ln._plan(1, 768, torch.bfloat16, True, 132).grid == 1
    wide = ln._plan(8192, 16384, torch.float32, True, 132)
    assert wide == ln.Plan("block", 4, 32, 512, 132)
    assert ln._plan(3, 2048, torch.bfloat16, False, 132) == \
        ln.Plan("block", 1, 32, 64, 3)


@pytest.mark.parametrize("n", [0, ln.MAX_N + 1])
def test_plan_refuses_a_row_the_kernel_does_not_take(n):
    with pytest.raises(ValueError, match="N <="):
        ln._plan(4, n, torch.float32, True, 132)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_vec_returns_the_vector_itself_without_a_cast(dtype):
    """``_vec`` checks shape and device and hands the kernel the vector
    in its own dtype: the same storage, nothing launched for it."""
    t = torch.randn(96).to(dtype).requires_grad_()
    got = ln._vec(t, 96, "gamma", t.device)
    assert got.dtype == dtype and got.data_ptr() == t.data_ptr()
    assert ln._vec(None, 96, "bias", t.device) is None
    with pytest.raises(ValueError, match="gamma"):
        ln._vec(t, 95, "gamma", t.device)


def test_vectors_of_one_dtype_stay_and_mixed_dtypes_are_cast_to_fp32():
    """Three bf16 (or fp32) vectors go to the kernel as they are, with
    their dtype code; vectors of different dtypes (or of a dtype the
    kernel does not read) are all cast to fp32, the one case with extra
    launches."""
    g, b, bb = (torch.randn(64).bfloat16() for _ in range(3))
    *vs, code = ln._vectors(g, b, bb, 64, g.device)
    assert code == 1 and [v.data_ptr() for v in vs] == \
        [t.data_ptr() for t in (g, b, bb)]
    *vs, code = ln._vectors(g, b, None, 64, g.device)
    assert code == 1 and vs[2] is None and vs[0].data_ptr() == g.data_ptr()
    *vs, code = ln._vectors(g, b.float(), bb, 64, g.device)
    assert code == 0 and all(v.dtype == torch.float32 for v in vs)
    torch.testing.assert_close(vs[0], g.float(), rtol=0, atol=0)
    *vs, code = ln._vectors(g.half(), b.half(), None, 64, g.device)
    assert code == 0 and vs[0].dtype == torch.float32
