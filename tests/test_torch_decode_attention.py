"""The port's flash-decode attention (K10's plain version, the CPU route
of ``decode_attention``) against the JAX package's Pallas kernel in
interpret mode, on the same numpy inputs: outputs and (m, l) stats,
GQA, ragged lengths with a zero-length row, fp32 and bf16; the fresh
row written inside (``k_new``, ``v_new``, ``write``) against the JAX
package's write then its kernel, and ``GPTBlock.decode_step`` against
the JAX block's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import gpt as jax_gpt
from paddle_tpu.ops.pallas import decode_attention as jax_da
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.models.convert import gpt_from_jax_state
from paddle_tpu_torch.ops.decode_attention import (
    decode_attention, decode_attention_reference)
from torch_reference_compile import fast_reference_compiles  # noqa: F401

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


# -- the fresh row written inside (K10's k_new / v_new / write) ------------

def _fresh_inputs(seed, hq, hkv, positions, d=32):
    rs = np.random.RandomState(seed)
    b = len(positions)
    q = rs.randn(b, hq, d).astype(np.float32)
    k = rs.randn(b, hkv, T, d).astype(np.float32)
    v = rs.randn(b, hkv, T, d).astype(np.float32)
    k_new = rs.randn(b, hkv, d).astype(np.float32)
    v_new = rs.randn(b, hkv, d).astype(np.float32)
    return q, k, v, k_new, v_new


# a row at position 0, ragged rows, the last cache row, a position past
# the cache (the write clamps to row T - 1, attention reads all T rows)
# and a row not written (it attends to its cache entry)
FRESH_POSITIONS = [0, 17, 128, T - 1, T + 44, 64]
FRESH_WRITE = [True, True, True, True, True, False]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq, hkv", [(4, 4), (4, 2), (8, 2), (8, 1)])
def test_fresh_row_matches_jax_write_then_kernel(dtype, hq, hkv):
    """The plain ``decode_attention(..., k_new, v_new, write)`` against
    the JAX package's own sequence, its ``GPTBlock._write_kv_rows`` (a
    row marked False put back as it was) then the Pallas kernel in
    interpret mode over ``positions + 1``: GQA groups 1, 2, 4 and 8; the
    caches bit for bit, the outputs and (m, l) within the tolerances
    above."""
    q, k, v, k_new, v_new = _fresh_inputs(3, hq, hkv, FRESH_POSITIONS)
    pos = np.asarray(FRESH_POSITIONS, np.int32)
    jdt = getattr(jnp, dtype)
    kj, vj = jnp.asarray(k, jdt), jnp.asarray(v, jdt)
    kw, vw = jax_gpt.GPTBlock._write_kv_rows(
        None, (kj, vj), jnp.asarray(k_new[:, None], jdt),
        jnp.asarray(v_new[:, None], jdt), jnp.asarray(pos))
    for b, w in enumerate(FRESH_WRITE):
        if not w:
            kw, vw = kw.at[b].set(kj[b]), vw.at[b].set(vj[b])
    o_want, m_want, l_want = (np.asarray(x, np.float32) for x in
                              jax_da.decode_attention(
        jnp.asarray(q, jdt), kw, vw, jnp.asarray(pos + 1), block_k=128,
        interpret=True, return_stats=True))

    tdt = getattr(torch, dtype)
    qt, kc, vc, kn, vn = (torch.from_numpy(x).to(tdt)
                          for x in (q, k, v, k_new, v_new))
    lens = torch.from_numpy(np.minimum(pos + 1, T).astype(np.int32))
    o, m, l = decode_attention(qt, kc, vc, lens, return_stats=True,
                               k_new=kn, v_new=vn,
                               write=torch.tensor(FRESH_WRITE))
    np.testing.assert_array_equal(kc.float().numpy(),
                                  np.asarray(kw, np.float32))
    np.testing.assert_array_equal(vc.float().numpy(),
                                  np.asarray(vw, np.float32))
    o = o.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(o, o_want, atol=F32_TOL, rtol=F32_TOL)
    else:
        assert _rel_l2_rows(o, o_want).max() <= BF16_REL_L2
    np.testing.assert_allclose(m.numpy(), m_want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l.numpy(), l_want, rtol=1e-4, atol=1e-5)


def test_fresh_row_of_an_empty_row_writes_nothing():
    """A row of length 0 stores nothing (even marked to write) and gives
    o = 0, m = -inf, l = 0; without a mask every other row is written."""
    q, k, v, k_new, v_new = (torch.from_numpy(x) for x in
                             _fresh_inputs(4, 4, 2, [0, 0, 0]))
    kc, vc = k.clone(), v.clone()
    lens = torch.tensor([0, 1, T], dtype=torch.int32)
    o, m, l = decode_attention(q, kc, vc, lens, return_stats=True,
                               k_new=k_new, v_new=v_new)
    assert torch.equal(kc[0], k[0]) and torch.equal(vc[0], v[0])
    assert (o[0] == 0).all() and torch.isneginf(m[0]).all()
    assert (l[0] == 0).all()
    for b, row in ((1, 0), (2, T - 1)):
        assert torch.equal(kc[b, :, row], k_new[b])
        assert torch.equal(vc[b, :, row], v_new[b])
        kc[b, :, row], vc[b, :, row] = k[b, :, row], v[b, :, row]
    assert torch.equal(kc, k) and torch.equal(vc, v)


def test_fresh_row_operand_errors():
    q, k, v, k_new, v_new = (torch.from_numpy(x) for x in
                             _fresh_inputs(5, 4, 2, [0, 3]))
    lens = torch.tensor([1, 4], dtype=torch.int32)
    with pytest.raises(ValueError, match="go together"):
        decode_attention(q, k, v, lens, k_new=k_new)
    with pytest.raises(ValueError, match="write needs"):
        decode_attention(q, k, v, lens, write=torch.tensor([True, True]))
    with pytest.raises(ValueError, match="k_new must be"):
        decode_attention(q, k, v, lens, k_new=k_new[:, :1],
                         v_new=v_new[:, :1])
    with pytest.raises(ValueError, match="write must be"):
        decode_attention(q, k, v, lens, k_new=k_new, v_new=v_new,
                         write=torch.tensor([1, 1]))


def _block_models(**kw):
    fields = dict(vocab_size=96, max_seq_len=1024, d_model=32, n_layers=1,
                  n_heads=4, **kw)
    jmodel = jax_gpt.GPT(jax_gpt.GPTConfig(dtype=jnp.float32, **fields),
                         seed=0)
    rs = np.random.RandomState(6)
    state = {}
    for name, val in sorted(jmodel.state_dict().items()):
        noise = rs.randn(*val.shape).astype(np.float32)
        state[name] = (1.0 + 0.1 * noise) if "scale" in name else (
            0.5 * noise)
    jmodel.set_state_dict({n: jnp.asarray(x) for n, x in state.items()})
    cfg = gpt.GPTConfig(dtype=torch.float32, **fields)
    return jmodel, gpt_from_jax_state(cfg, state, device="cpu")


@pytest.mark.parametrize("kw", [{}, dict(n_kv_heads=2, rope=True,
                                         use_bias=False)])
def test_block_decode_step_matches_jax(monkeypatch, kw):
    """``GPTBlock.decode_step`` at a 1024 cache (K10's route, the fresh
    row handed to ``decode_attention``) against the JAX block's
    ``decode_step`` (its write, then the Pallas kernel in interpret
    mode), with a row at position 0, ragged rows, the last row and a
    position past the cache; it no longer calls ``_write_kv_rows``."""
    jmodel, model = _block_models(**kw)
    cfg = model.cfg
    hkv, d = cfg.kv_heads, cfg.head_dim
    rs = np.random.RandomState(7)
    pos = np.asarray([0, 7, 1000, 1023, 1500], np.int32)
    b = len(pos)
    x = rs.randn(b, 1, 32).astype(np.float32)
    k = rs.randn(b, hkv, 1024, d).astype(np.float32)
    v = rs.randn(b, hkv, 1024, d).astype(np.float32)
    y_want, (k_want, v_want) = jmodel.blocks[0].decode_step(
        jnp.asarray(x), (jnp.asarray(k), jnp.asarray(v)), jnp.asarray(pos))

    def no_write(*args, **kwargs):
        raise AssertionError("decode_step wrote the rows itself")

    monkeypatch.setattr(gpt.GPTBlock, "_write_kv_rows", no_write)
    kc, vc = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    rows = gpt.cache_rows(torch.from_numpy(pos), 1, 1024)
    with torch.no_grad():
        y, (kc2, vc2) = model.block.decode_step(
            torch.from_numpy(x), model.layer_weights()[0], (kc, vc), rows)
    assert kc2 is kc and vc2 is vc
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), atol=1e-4,
                               rtol=1e-4)
    for got, want, old in ((kc, k_want, k), (vc, v_want, v)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
        # the rows not written are untouched
        written = np.zeros((b, 1024), bool)
        written[np.arange(b), np.minimum(pos, 1023)] = True
        np.testing.assert_array_equal(
            got.numpy().transpose(0, 2, 1, 3)[~written],
            old.transpose(0, 2, 1, 3)[~written])
