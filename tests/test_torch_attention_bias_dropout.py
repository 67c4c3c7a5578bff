"""The attention bias and hash dropout of the port's flash kernels (K1,
K3, K4): the plain versions (``flash_attention_reference``,
``flash_attention_bwd_reference``, which CPU tensors take through the
differentiable ``flash_attention``) against the JAX package's Pallas
flash kernel in interpret mode, in fp32 on the CPU. The dropout mask is
observed through outputs: with Sk = D and V the identity, o[b, q, h, :]
is the dropped probability row over its normaliser, so its zero
pattern is the keep mask, which must equal JAX's exactly, also where
JAX's padded key length (the mask's row stride) differs from Sk. The
CUDA kernels are held against the same plain versions on the GPU
(tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional.attention import (
    scaled_dot_product_attention as jax_sdpa)
from paddle_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash_attention)
from paddle_tpu_torch.nn.functional.attention import (
    mask_to_bias, scaled_dot_product_attention)
from paddle_tpu_torch.ops import _hash
from paddle_tpu_torch.ops.flash_attention import (
    attention_bias, flash_attention, flash_attention_plain)
from torch_reference_compile import fast_reference_compiles  # noqa: F401

# fp32 on both sides: outputs within 1e-5, gradients (sums over up to
# 256 keys or queries in another order) within 1e-4
OUT_TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("sk, want", [(512, 512), (200, 256), (600, 1024),
                                      (128, 128), (1, 128), (513, 1024)])
def test_jax_key_stride(sk, want):
    assert _hash.jax_key_stride(sk) == want


def _identity_case(b, sq, sk, h, seed):
    """q, k random; v the identity over keys (D = Sk)."""
    rs = np.random.RandomState(seed)
    q = rs.randn(b, sq, h, sk).astype(np.float32) * 0.3
    k = rs.randn(b, sk, h, sk).astype(np.float32) * 0.3
    v = np.broadcast_to(np.eye(sk, dtype=np.float32)[None, :, None, :],
                        (b, sk, h, sk)).copy()
    return q, k, v


@pytest.mark.parametrize("b, sq, sk, h, rate, seed", [
    (2, 40, 200, 2, 0.3, -3),          # stride 256 != Sk
    (1, 300, 600, 2, 0.5, 2 ** 31 - 1),  # crosses a JAX block: stride 1024
    (1, 64, 128, 3, 0.1, 0),
])
def test_dropout_mask_matches_jax_bit_for_bit(b, sq, sk, h, rate, seed):
    q, k, v = _identity_case(b, sq, sk, h, 11)
    want = np.asarray(jax.jit(lambda q, k, v: jax_flash_attention(
        q, k, v, dropout_p=rate, dropout_seed=seed, interpret=True))(
            q, k, v))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), dropout_p=rate,
                          dropout_seed=seed).numpy()
    np.testing.assert_array_equal(got == 0, want == 0)
    # the zero pattern is the port's own mask, not an accident of values
    keep = _hash.attention_keep(seed, b, h, sq, sk, rate,
                                _hash.jax_key_stride(sk)).numpy()
    np.testing.assert_array_equal(got != 0, keep.transpose(0, 2, 1, 3))
    assert 0 < keep.mean() < 1
    np.testing.assert_allclose(got, want, atol=OUT_TOL, rtol=OUT_TOL)


CASES = {
    # name: (b, sq, sk, hq, hkv, d, causal, bias shape, kv_lens, rate)
    "one": (2, 128, 128, 2, 2, 16, False, (1, 1, 128, 128), None, 0.2),
    "batch": (2, 128, 200, 2, 2, 16, False, (2, 1, 128, 200), None, 0.2),
    "head": (1, 96, 96, 3, 3, 16, True, (1, 3, 96, 96), None, 0.1),
    "bh": (2, 64, 64, 2, 2, 8, False, (2, 2, 64, 64), None, 0.3),
    "sq1_padding": (2, 128, 128, 2, 2, 16, False, (2, 1, 1, 128), None,
                    0.1),
    "kv_lens_bias": (2, 128, 160, 2, 2, 16, False, (2, 1, 1, 160),
                     [100, 160], 0.2),
    "gqa_bias": (1, 128, 128, 4, 2, 16, True, (1, 4, 128, 128), None, 0.2),
    "no_dropout_bias": (2, 64, 64, 2, 1, 16, False, (2, 2, 64, 64), [0, 40],
                        0.0),
}
# the CUDA kernels' D 64 instance at a ragged causal tile, with kv_len,
# GQA, a per-row bias and dropout
EDGE_CASES = {
    "edge_d64": (1, 200, 200, 4, 2, 64, True, (1, 1, 200, 200), [150], 0.2),
}
NAMES = sorted(CASES) + sorted(EDGE_CASES)


def _inputs(name):
    b, sq, sk, hq, hkv, d, causal, bshape, lens, rate = {
        **CASES, **EDGE_CASES}[name]
    # CASES keep their seeds; EDGE_CASES follow them
    rs = np.random.RandomState(NAMES.index(name))
    q = rs.randn(b, sq, hq, d).astype(np.float32)
    k = rs.randn(b, sk, hkv, d).astype(np.float32)
    v = rs.randn(b, sk, hkv, d).astype(np.float32)
    do = rs.randn(b, sq, hq, d).astype(np.float32)
    bias = rs.randn(*bshape).astype(np.float32)
    # a -inf mask value: the clamp keeps it finite, as in JAX
    bias[..., -5:] = -np.inf
    lens = None if lens is None else np.asarray(lens, np.int32)
    return q, k, v, do, bias, causal, lens, rate


@pytest.mark.parametrize("name", NAMES)
def test_plain_forward_and_grads_match_jax(name):
    q, k, v, do, bias, causal, lens, rate = _inputs(name)
    seed = 1234

    def jax_o(q, k, v):
        return jax_flash_attention(
            q, k, v, causal=causal, bias=jnp.asarray(bias),
            kv_lens=None if lens is None else jnp.asarray(lens),
            dropout_p=rate, dropout_seed=seed, interpret=True)

    def jax_o_and_grads(q, k, v, do):
        o, pull = jax.vjp(jax_o, q, k, v)
        return o, pull(do)

    # one compiled program: the forward once, then its vjp (op by op,
    # the interpret-mode kernels take several times longer)
    want_o, want = jax.jit(jax_o_and_grads)(q, k, v, do)
    want_o = np.asarray(want_o)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    bt = torch.from_numpy(bias).requires_grad_()
    o = flash_attention(qt, kt, vt, causal=causal, bias=bt,
                        kv_lens=None if lens is None
                        else torch.from_numpy(lens),
                        dropout_p=rate, dropout_seed=seed)
    np.testing.assert_allclose(o.detach().numpy(), want_o, atol=OUT_TOL,
                               rtol=OUT_TOL)
    o.backward(torch.from_numpy(do))
    for t, w, what in zip((qt, kt, vt), want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=what)
    # the bias is a constant, as JAX's zero cotangent
    assert bt.grad is None


def test_fully_masked_rows_match_jax():
    """A row whose every key carries the -1e30 bias averages V (every
    logit equal); a row with kv_lens 0 gives 0."""
    q, k, v, do, _, _, _, _ = _inputs("kv_lens_bias")
    bias = np.zeros((2, 1, 1, 160), np.float32)
    bias[0] = -1e30
    lens = np.asarray([160, 0], np.int32)
    want = np.asarray(jax_flash_attention(
        q, k, v, bias=jnp.asarray(bias), kv_lens=jnp.asarray(lens),
        dropout_p=0.2, dropout_seed=5, interpret=True))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), bias=torch.from_numpy(bias),
                          kv_lens=torch.from_numpy(lens), dropout_p=0.2,
                          dropout_seed=5).numpy()
    np.testing.assert_allclose(got, want, atol=OUT_TOL, rtol=OUT_TOL)
    assert np.all(got[1] == 0)


def test_plain_version_matches_cpu_wrapper():
    q, k, v, _, bias, causal, lens, rate = _inputs("head")
    args = [torch.from_numpy(x) for x in (q, k, v)]
    kw = dict(causal=causal, bias=torch.from_numpy(bias), dropout_p=rate,
              dropout_seed=-9)
    before = flash_attention.launches
    o, lse = flash_attention(*args, return_lse=True, **kw)
    po, plse = flash_attention_plain(*args, return_lse=True, **kw)
    assert torch.equal(o, po) and torch.equal(lse, plse)
    assert flash_attention.launches == before


def test_bias_shape_errors():
    q = torch.zeros(2, 32, 2, 16)
    with pytest.raises(ValueError, match="Sq dim"):
        flash_attention(q, q, q, bias=torch.zeros(1, 1, 16, 32))
    with pytest.raises(ValueError, match="Hq dim"):
        flash_attention(q, q, q, bias=torch.zeros(1, 3, 32, 32))
    with pytest.raises(ValueError, match="4-D"):
        flash_attention(q, q, q, bias=torch.zeros(1, 1, 1, 1, 32))
    with pytest.raises(ValueError, match="dropout_seed"):
        flash_attention(q, q, q, dropout_p=0.1)
    with pytest.raises(ValueError, match="dropout_p"):
        flash_attention(q, q, q, dropout_p=1.0, dropout_seed=0)
    b = attention_bias(torch.full((32,), -np.inf), 2, 2, 32, 32)
    assert b.shape == (1, 1, 1, 32) and torch.all(b == -1e30)


@pytest.mark.parametrize("mask_kind", ["bool_2d", "float_4d", "bool_key"])
def test_sdpa_mask_matches_jax(mask_kind):
    """``attn_mask`` without dropout: the CPU reference, as JAX's CPU
    path; the bias the kernels get is JAX's conversion of the mask."""
    rs = np.random.RandomState(3)
    q = rs.randn(2, 24, 2, 8).astype(np.float32)
    k = rs.randn(2, 24, 2, 8).astype(np.float32)
    v = rs.randn(2, 24, 2, 8).astype(np.float32)
    if mask_kind == "bool_2d":
        mask = np.tril(np.ones((24, 24), bool))
    elif mask_kind == "float_4d":
        mask = rs.randn(2, 2, 24, 24).astype(np.float32)
    else:
        mask = np.ones((2, 1, 1, 24), bool)
        mask[1, ..., 10:] = False
    want = np.asarray(jax_sdpa(q, k, v, attn_mask=jnp.asarray(mask)))
    tm = torch.from_numpy(mask)
    got = scaled_dot_product_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), attn_mask=tm).numpy()
    np.testing.assert_allclose(got, want, atol=OUT_TOL, rtol=OUT_TOL)
    # through the kernels' plain version with the converted bias
    kern = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                           bias=mask_to_bias(tm)).numpy()
    np.testing.assert_allclose(kern, want, atol=OUT_TOL, rtol=OUT_TOL)
    bias = mask_to_bias(tm)
    assert bias.dim() == 4 and bias.dtype == torch.float32


def test_sdpa_dropout_takes_the_hash_path_on_cpu():
    """With dropout the CPU call runs the kernels' plain version seeded
    by the key's bits as int32, as JAX seeds its kernel
    (``jax.random.bits(key, (), uint32).astype(int32)``): the same key
    gives the same output, equal to ``flash_attention_plain`` at that
    seed. Without a key or a seed nothing drops, as in JAX."""
    from paddle_tpu_torch import random as prng
    rs = np.random.RandomState(8)
    q, k, v = (torch.from_numpy(rs.randn(1, 32, 2, 8).astype(np.float32))
               for _ in range(3))
    key = prng.PRNGKey(4)
    a = scaled_dot_product_attention(q, k, v, dropout_p=0.25, rng_key=key)
    b = scaled_dot_product_attention(q, k, v, dropout_p=0.25,
                                     rng_key=prng.PRNGKey(4))
    assert torch.equal(a, b)
    want_seed = int(np.asarray(jax.random.bits(
        jax.random.PRNGKey(4), (), jnp.uint32)).astype(np.int32))
    assert torch.equal(a, flash_attention_plain(
        q, k, v, dropout_p=0.25, dropout_seed=want_seed))
    c = scaled_dot_product_attention(q, k, v, dropout_p=0.25,
                                     dropout_seed=77)
    want = flash_attention_plain(q, k, v, dropout_p=0.25, dropout_seed=77)
    assert torch.equal(c, want)
    assert not torch.equal(a, c)
    for ev in (scaled_dot_product_attention(q, k, v, dropout_p=0.25,
                                            training=False),
               scaled_dot_product_attention(q, k, v, dropout_p=0.25)):
        torch.testing.assert_close(
            ev, flash_attention_plain(q, k, v), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("seed, want", [(0, 0), (-1, -1), (2 ** 31 - 1,
                                                           2 ** 31 - 1),
                                        (2 ** 31, -2 ** 31),
                                        (2 ** 32 + 5, 5)])
def test_seed_tensor_is_the_int32_the_kernels_read(seed, want):
    """An int seed's low 32 bits as int32, and a tensor seed cast: both
    hash as the same uint32."""
    t = _hash.seed_tensor(seed, "cpu")
    assert t.dtype == torch.int32 and t.dim() == 0 and int(t) == want
    u = _hash.seed_tensor(torch.tensor(want, dtype=torch.int64), "cpu")
    assert u.dtype == torch.int32 and int(u) == want
    assert torch.equal(_hash.attention_keep(t, 1, 2, 8, 8, 0.5, 128),
                       _hash.attention_keep(seed, 1, 2, 8, 8, 0.5, 128))
    with pytest.raises(ValueError, match="one integer"):
        _hash.seed_tensor(torch.zeros(()), "cpu")


def test_tensor_seed_equals_int_seed_forward_and_backward():
    """A seed made as a tensor from a key (``key_seed``) drops what its
    int value drops, in the forward and in the backward's replay."""
    from paddle_tpu_torch import random as prng
    from paddle_tpu_torch.nn.functional.attention import key_seed
    q, k, v, _, bias, causal, lens, rate = _inputs("bh")
    seed = key_seed(prng.PRNGKey(21), "cpu")
    assert seed.dtype == torch.int32 and seed.dim() == 0
    assert int(seed) == int(np.asarray(jax.random.bits(
        jax.random.PRNGKey(21), (), jnp.uint32)).astype(np.int32))
    res = []
    for s in (seed, int(seed)):
        ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        o = flash_attention(*ts, causal=causal, bias=torch.from_numpy(bias),
                            dropout_p=rate, dropout_seed=s)
        o.sum().backward()
        res.append([o.detach()] + [t.grad for t in ts])
    for a, b in zip(*res):
        assert torch.equal(a, b)
