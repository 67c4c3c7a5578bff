"""Port kernels K3/K4 (flash attention backward): the plain backward
``flash_attention_bwd_reference``, which CPU tensors take through the
differentiable ``flash_attention``, against ``jax.grad`` of the JAX
package's Pallas flash kernel run in interpret mode, and against torch
autograd of the plain forward, in fp32 on the CPU. The CUDA kernels are
held against the same plain version on the GPU
(tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash_attention)
from paddle_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_bwd_dkdv, flash_attention_bwd_dq,
    flash_attention_bwd_reference, flash_attention_plain,
    flash_attention_reference)
from torch_reference_compile import fast_reference_compiles  # noqa: F401

# fp32 on both sides; the gradients sum over up to 256 keys or queries
# in another order (128- and 256-wide blocks vs one dense einsum)
ATOL = RTOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


CASES = {
    # name: (b, s, hq, hkv, d, causal, kv_lens)
    "causal_s128": (2, 128, 2, 2, 32, True, None),
    "noncausal_s128": (1, 128, 2, 2, 32, False, None),
    "causal_s256": (1, 256, 2, 2, 32, True, None),
    "gqa_causal_s256": (1, 256, 4, 2, 16, True, None),
    "kv_lens_noncausal": (2, 128, 2, 1, 32, False, [0, 77]),
    "kv_lens_causal_s256": (2, 256, 2, 2, 16, True, [200, 256]),
}
# the edges of the CUDA K3's tiles (128 keys by 64 query rows, head dims
# on a 64- or 128-wide instance): a ragged causal tile, kv_len inside a
# key tile, GQA 8:2, D 64 and D 96
EDGE_CASES = {
    "edge_causal_s200": (1, 200, 2, 2, 32, True, None),
    "edge_kv_lens_130_of_256": (1, 256, 2, 2, 32, False, [130]),
    "edge_gqa_8_2": (1, 128, 8, 2, 16, True, None),
    "edge_d64": (1, 128, 2, 2, 64, True, None),
    "edge_d96": (1, 128, 2, 1, 96, False, [100]),
}
NAMES = sorted(CASES) + sorted(EDGE_CASES)


def _inputs(name):
    b, s, hq, hkv, d, causal, lens = {**CASES, **EDGE_CASES}[name]
    # CASES keep their seeds; EDGE_CASES follow them
    rs = np.random.RandomState(NAMES.index(name))
    q = rs.randn(b, s, hq, d).astype(np.float32)
    k = rs.randn(b, s, hkv, d).astype(np.float32)
    v = rs.randn(b, s, hkv, d).astype(np.float32)
    do = rs.randn(b, s, hq, d).astype(np.float32)
    lens = None if lens is None else np.asarray(lens, np.int32)
    return q, k, v, do, causal, lens


def _port_grads(fn, q, k, v, do, causal, lens):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = fn(qt, kt, vt, causal=causal,
           kv_lens=None if lens is None else torch.from_numpy(lens))
    if isinstance(o, tuple):
        o = o[0]
    return torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(do))


@pytest.mark.parametrize("name", NAMES)
def test_plain_backward_matches_jax_grad(name):
    q, k, v, do, causal, lens = _inputs(name)

    def loss(q, k, v):
        o = jax_flash_attention(q, k, v, causal=causal,
                                kv_lens=None if lens is None
                                else jnp.asarray(lens), interpret=True)
        return jnp.sum(o * jnp.asarray(do))

    # jitted: op by op, the interpret-mode kernels take several times
    # longer
    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = _port_grads(flash_attention, q, k, v, do, causal, lens)
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=RTOL, err_msg=what)


@pytest.mark.parametrize("name", NAMES)
def test_plain_backward_matches_autograd_of_plain_forward(name):
    q, k, v, do, causal, lens = _inputs(name)
    got = _port_grads(flash_attention_plain, q, k, v, do, causal, lens)
    want = _port_grads(flash_attention_reference, q, k, v, do, causal, lens)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=RTOL)


def test_bwd_reference_gives_zero_grads_for_rows_without_keys():
    """kv_lens 0: the forward gives 0 and LSE 0, the backward exact 0
    (p is 0 everywhere), never NaN."""
    q, k, v, do, _, _ = _inputs("kv_lens_noncausal")
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    lens = torch.tensor([0, 77], dtype=torch.int32)
    o, lse = flash_attention_reference(qt, kt, vt, kv_lens=lens)
    dq, dk, dv = flash_attention_bwd_reference(qt, kt, vt, o, lse, dot,
                                               kv_lens=lens)
    assert torch.equal(dq[0], torch.zeros_like(dq[0]))
    assert torch.equal(dk[0], torch.zeros_like(dk[0]))
    assert torch.equal(dk[1, 77:], torch.zeros_like(dk[1, 77:]))
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))


def test_cpu_backward_counts_no_launch():
    q, k, v, do, causal, lens = _inputs("causal_s128")
    fns = (flash_attention, flash_attention_bwd_dkdv, flash_attention_bwd_dq)
    before = [f.launches for f in fns]
    _port_grads(flash_attention, q, k, v, do, causal, lens)
    assert [f.launches for f in fns] == before
