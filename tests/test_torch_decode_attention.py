"""The port's flash-decode attention (K10's plain version, the CPU route
of ``decode_attention``) against the JAX package's Pallas kernel in
interpret mode, on the same numpy inputs: outputs and (m, l) stats,
GQA, ragged lengths with a zero-length row, fp32 and bf16."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import decode_attention as jax_da
from paddle_tpu_torch.ops.decode_attention import (
    decode_attention, decode_attention_reference)

# fp32: the same sums in another order (the TPU kernel rescales per
# 128-key block); bf16 outputs: within 2^-7 relative L2 per (row, head),
# the chip's rule (p rounds to bf16 against another running max)
F32_TOL = 1e-5
BF16_REL_L2 = 2.0 ** -7
LENGTHS = [0, 17, 128, 256]
T = 256


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(seed, hq, hkv, d=32, lengths=LENGTHS):
    rs = np.random.RandomState(seed)
    b = len(lengths)
    q = rs.randn(b, hq, d).astype(np.float32)
    k = rs.randn(b, hkv, T, d).astype(np.float32)
    v = rs.randn(b, hkv, T, d).astype(np.float32)
    return q, k, v, np.asarray(lengths, np.int32)


def _rel_l2_rows(got, want):
    err = np.linalg.norm(got - want, axis=-1)
    return err / np.maximum(np.linalg.norm(want, axis=-1), 1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq, hkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("stats", [False, True])
def test_plain_matches_jax_kernel(dtype, hq, hkv, stats):
    q, k, v, lens = _inputs(0, hq, hkv)
    jdt = getattr(jnp, dtype)
    want = jax_da.decode_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(lens), block_k=128, interpret=True, return_stats=stats)
    tdt = getattr(torch, dtype)
    got = decode_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                           torch.from_numpy(lens), return_stats=stats)
    if not stats:
        want, got = (want,), (got,)
    o_want = np.asarray(want[0], np.float32)
    o_got = got[0].float().numpy()
    assert np.isfinite(o_got).all()
    np.testing.assert_array_equal(o_got[0], 0.0)        # empty row
    if dtype == "float32":
        np.testing.assert_allclose(o_got, o_want, atol=F32_TOL,
                                   rtol=F32_TOL)
    else:
        assert _rel_l2_rows(o_got[1:], o_want[1:]).max() <= BF16_REL_L2
    if stats:
        m_want, l_want = (np.asarray(x) for x in want[1:])
        m_got, l_got = got[1].numpy(), got[2].numpy()
        np.testing.assert_array_equal(np.isneginf(m_got),
                                      np.isneginf(m_want))
        assert np.isneginf(m_got[0]).all() and (l_got[0] == 0).all()
        np.testing.assert_allclose(m_got[1:], m_want[1:], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(l_got, l_want, rtol=1e-4, atol=1e-5)


def test_zero_length_row_is_finite():
    """An empty slot (length 0) gives o = 0, m = -inf, l = 0; a slot of
    length 1 gives its one value row, with m its score and l = 1."""
    q, k, v, lens = _inputs(1, 2, 2, lengths=[0, 1, 128])
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    o, m, l = decode_attention(qt, kt, vt, torch.from_numpy(lens),
                               return_stats=True)
    assert torch.isfinite(o).all() and (o[0] == 0).all()
    assert torch.isneginf(m[0]).all() and (l[0] == 0).all()
    torch.testing.assert_close(o[1], vt[1, :, 0], atol=0, rtol=0)
    s1 = (qt[1] * kt[1, :, 0]).sum(-1) * 32 ** -0.5
    torch.testing.assert_close(m[1], s1, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(l[1], torch.ones(2), atol=0, rtol=0)


def test_cpu_tensors_count_no_launch():
    q, k, v, lens = _inputs(7, 4, 4)
    before = decode_attention.launches
    got = decode_attention(*(torch.from_numpy(x) for x in (q, k, v, lens)))
    want = decode_attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v, lens)))
    assert decode_attention.launches == before
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_operand_errors():
    q, k, v, lens = (torch.from_numpy(x) for x in _inputs(8, 4, 4))
    with pytest.raises(ValueError, match="multiple of 128"):
        decode_attention(q, k[:, :, :200], v[:, :, :200], lens)
    with pytest.raises(ValueError, match="GQA"):
        decode_attention(q[:, :3].contiguous(), k, v, lens)
    with pytest.raises(ValueError, match="lengths"):
        decode_attention(q, k, v, lens[:2])
    with pytest.raises(ValueError, match="disagree"):
        decode_attention(q[:, :, :16].contiguous(), k, v, lens)
