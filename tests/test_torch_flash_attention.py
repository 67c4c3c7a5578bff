"""Port kernel K1 (flash attention forward): its plain PyTorch version
against the JAX package's Pallas flash kernel run in interpret mode, in
fp32 on the CPU. The CUDA kernel itself is held against the same plain
version on the GPU (tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.flash_attention import _fa_forward
from paddle_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash_attention)
from paddle_tpu_torch.ops.flash_attention import (flash_attention,
                                                  flash_attention_reference)
from torch_reference_compile import fast_reference_compiles  # noqa: F401

# fp32 on both sides; only the summation order differs (online softmax
# over 128-key blocks vs one dense softmax)
ATOL = RTOL = 2e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(rs, b, sq, sk, hq, hkv, d):
    q = rs.randn(b, sq, hq, d).astype(np.float32)
    k = rs.randn(b, sk, hkv, d).astype(np.float32)
    v = rs.randn(b, sk, hkv, d).astype(np.float32)
    return q, k, v


CASES = {
    # name: (b, sq, sk, hq, hkv, d, causal, kv_lens)
    "causal": (2, 128, 128, 2, 2, 32, True, None),
    "noncausal_sk_gt_sq": (1, 128, 256, 2, 2, 32, False, None),
    "gqa_causal": (1, 128, 128, 4, 2, 32, True, None),
    "kv_lens_incl_zero": (3, 128, 200, 2, 2, 16, False, [0, 77, 200]),
    "kv_lens_causal": (2, 128, 128, 2, 1, 32, True, [0, 100]),
    "ragged_sq": (1, 100, 100, 2, 2, 32, True, None),
    "ragged_noncausal": (2, 70, 190, 2, 2, 16, False, None),
}
# the edges of the CUDA kernel's tiles (128 query rows by 128 keys, head
# dims run on a 64- or 128-wide instance): a ragged causal tile, kv_len
# inside a key tile, GQA 8:2, D 64 and D 96
EDGE_CASES = {
    "edge_ragged_causal_s200": (1, 200, 200, 2, 2, 32, True, None),
    "edge_kv_lens_130_of_256": (1, 256, 256, 2, 2, 32, False, [130]),
    "edge_gqa_8_2": (1, 128, 128, 8, 2, 16, True, None),
    "edge_d64": (1, 128, 128, 2, 2, 64, True, None),
    "edge_d96": (1, 160, 160, 2, 1, 96, False, [100]),
}
NAMES = sorted(CASES) + sorted(EDGE_CASES)


@pytest.mark.parametrize("name", NAMES)
def test_reference_matches_jax_flash_kernel(name):
    b, sq, sk, hq, hkv, d, causal, kv_lens = {**CASES, **EDGE_CASES}[name]
    # CASES keep their seeds; EDGE_CASES follow them
    rs = np.random.RandomState(NAMES.index(name))
    q, k, v = _inputs(rs, b, sq, sk, hq, hkv, d)
    lens = None if kv_lens is None else np.asarray(kv_lens, np.int32)
    # jitted: op by op the interpret-mode kernel takes about twice as long
    want = np.asarray(jax.jit(lambda q, k, v, lens: jax_flash_attention(
        q, k, v, causal=causal, kv_lens=lens, interpret=True))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            None if lens is None else jnp.asarray(lens)))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal,
                          kv_lens=None if lens is None
                          else torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    if lens is not None and 0 in kv_lens:
        # a row with no visible key is exactly 0, not NaN
        assert np.all(got.numpy()[kv_lens.index(0)] == 0)


def test_lse_matches_jax_forward():
    """The LSE the kernel keeps for the training slice: JAX's (B*H, S,
    128) lane-broadcast layout, column 0, against the port's (B*H, S)."""
    rs = np.random.RandomState(7)
    b, s, h, d = 2, 128, 2, 32
    q, k, v = _inputs(rs, b, s, s, h, h, d)
    lens = np.asarray([0, 90], np.int32)

    def to3(x):
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))

    _, lse = _fa_forward(to3(q), to3(k), to3(v),
                         jnp.asarray(np.repeat(lens, h)),
                         jnp.zeros((1,), jnp.int32), None, True,
                         1.0 / np.sqrt(d), 128, 128, 1, "one", False, h,
                         0.0, True)
    _, got = flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, kv_lens=torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(lse)[:, :, 0],
                               atol=ATOL, rtol=RTOL)


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    rs = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(x) for x in _inputs(rs, 1, 64, 64, 2, 2,
                                                     16))
    before = flash_attention.launches
    o, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    ro, rlse = flash_attention_reference(q, k, v, causal=True)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    assert flash_attention.launches == before


@pytest.mark.parametrize("kwargs, exc", [
    (dict(bias=torch.zeros(1, 1, 32, 64)), ValueError),
    (dict(dropout_p=0.1), ValueError),
])
def test_unported_options_raise(kwargs, exc):
    """The bias and dropout are ported (tests/test_torch_attention_bias_
    dropout.py); what the kernels still refuse raises: a bias whose Sq
    dim is neither 1 nor Sq, and dropout without a seed."""
    q = torch.zeros(1, 64, 2, 16)
    with pytest.raises(exc):
        flash_attention(q, q, q, causal=True, **kwargs)


def test_shape_errors_raise():
    q = torch.zeros(1, 64, 3, 16)
    kv = torch.zeros(1, 64, 2, 16)
    with pytest.raises(ValueError, match="GQA"):
        flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="Sq == Sk"):
        flash_attention(torch.zeros(1, 32, 2, 16), torch.zeros(1, 64, 2, 16),
                        torch.zeros(1, 64, 2, 16), causal=True)
