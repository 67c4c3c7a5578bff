"""The port's incubate fused-transformer path (``incubate.nn.functional``,
``incubate.nn``, the ``nn`` transformer layers under them and
``models.convert.load_jax_state``) against the JAX package's, in fp32 on
the CPU at small widths. Dropout is 0 in the whole-block comparisons
(the JAX ``MultiHeadAttention`` never drops; the masks themselves are
held against JAX bit for bit in ``test_torch_nn_dropout.py``); the K11
functional and layer take an explicit seed on both sides, so they run
with dropout on and must match mask and all. The key-drawn dropouts are
also checked by their statistics."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.incubate import nn as jax_inn
from paddle_tpu.incubate.nn import functional as jax_IF
from paddle_tpu.nn.layer.transformer import (
    TransformerEncoder as JaxTransformerEncoder,
    TransformerEncoderLayer as JaxTransformerEncoderLayer)
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import quantization as quant
from paddle_tpu_torch import random as prng
from paddle_tpu_torch.incubate import nn as inn
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.models.convert import load_jax_state
from paddle_tpu_torch.nn.functional import common as F_common
from paddle_tpu_torch.ops.quant_matmul import int8_matmul_reference
from torch_reference_compile import fast_reference_compiles  # noqa: F401

TOL = 2e-5
B, S, D, H, FF = 2, 12, 32, 4, 64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


def _mha_weights(seed):
    rs = np.random.RandomState(seed)
    dh = D // H
    w = dict(qkv_weight=rs.randn(3, H, dh, D) * D ** -0.5,
             qkv_bias=rs.randn(3, H, dh) * 0.1,
             linear_weight=rs.randn(D, D) * D ** -0.5,
             linear_bias=rs.randn(D) * 0.1,
             pre_ln_scale=1 + 0.1 * rs.randn(D), pre_ln_bias=rs.randn(D),
             ln_scale=1 + 0.1 * rs.randn(D), ln_bias=rs.randn(D))
    w = {k: v.astype(np.float32) for k, v in w.items()}
    x = rs.randn(B, S, D).astype(np.float32)
    mask = np.zeros((B, 1, 1, S), np.float32)
    mask[1, ..., 7:] = -1e30
    return x, w, mask


@pytest.mark.parametrize("pre_layer_norm", [False, True])
@pytest.mark.parametrize("add_residual", [True, False])
def test_fused_multi_head_attention_matches_jax(pre_layer_norm,
                                                add_residual):
    x, w, mask = _mha_weights(1)
    kw = dict(pre_layer_norm=pre_layer_norm, dropout_rate=0.0,
              attn_dropout_rate=0.0, add_residual=add_residual)
    want = jax_IF.fused_multi_head_attention(
        jnp.asarray(x), **{k: jnp.asarray(v) for k, v in w.items()},
        attn_mask=jnp.asarray(mask), **kw)
    got = IF.fused_multi_head_attention(
        _t(x), **{k: _t(v) for k, v in w.items()}, attn_mask=_t(mask),
        **kw)
    _close(got, want)


@pytest.mark.parametrize("with_mask", [False, True])
def test_fused_multi_head_attention_cache_kv_matches_jax(with_mask):
    """The incremental form: 3 new tokens over a 5-token cache, causal
    within the new block, plus an additive mask."""
    x, w, _ = _mha_weights(2)
    x = x[:, :3]
    rs = np.random.RandomState(9)
    cache = rs.randn(2, B, H, 5, D // H).astype(np.float32)
    mask = rs.randn(B, 1, 3, 8).astype(np.float32) if with_mask else None
    kw = dict(dropout_rate=0.0, attn_dropout_rate=0.0)
    want, want_cache = jax_IF.fused_multi_head_attention(
        jnp.asarray(x), **{k: jnp.asarray(v) for k, v in w.items()},
        cache_kv=jnp.asarray(cache),
        attn_mask=None if mask is None else jnp.asarray(mask), **kw)
    got, got_cache = IF.fused_multi_head_attention(
        _t(x), **{k: _t(v) for k, v in w.items()}, cache_kv=_t(cache),
        attn_mask=_t(mask), **kw)
    _close(got, want)
    _close(got_cache, want_cache)


@pytest.mark.parametrize("pre_layer_norm", [False, True])
@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_fused_feedforward_matches_jax(pre_layer_norm, activation):
    rs = np.random.RandomState(3)
    x = rs.randn(B, S, D).astype(np.float32)
    w = dict(linear1_weight=rs.randn(D, FF) * D ** -0.5,
             linear2_weight=rs.randn(FF, D) * FF ** -0.5,
             linear1_bias=rs.randn(FF) * 0.1, linear2_bias=rs.randn(D) * 0.1,
             ln1_scale=1 + 0.1 * rs.randn(D), ln1_bias=rs.randn(D),
             ln2_scale=1 + 0.1 * rs.randn(D), ln2_bias=rs.randn(D))
    w = {k: v.astype(np.float32) for k, v in w.items()}
    kw = dict(dropout1_rate=0.0, dropout2_rate=0.0, activation=activation,
              pre_layer_norm=pre_layer_norm)
    want = jax_IF.fused_feedforward(
        jnp.asarray(x), **{k: jnp.asarray(v) for k, v in w.items()}, **kw)
    got = IF.fused_feedforward(_t(x), **{k: _t(v) for k, v in w.items()},
                               **kw)
    _close(got, want)


@pytest.mark.parametrize("n", [128, 96])
@pytest.mark.parametrize("rate, seed", [(0.0, None), (0.3, -4), (0.5, 17)])
def test_fused_bias_dropout_residual_layer_norm_matches_jax(n, rate, seed):
    """K11's functional with dropout on: both take the seed, so the
    masks agree bit for bit."""
    rs = np.random.RandomState(n)
    x, res = (rs.randn(B, S, n).astype(np.float32) for _ in range(2))
    bias, scale, lnb = (rs.randn(n).astype(np.float32) for _ in range(3))
    kw = dict(dropout_rate=rate, dropout_seed=seed)
    want = jax_IF.fused_bias_dropout_residual_layer_norm(
        jnp.asarray(x), jnp.asarray(res), bias=jnp.asarray(bias),
        ln_scale=jnp.asarray(scale), ln_bias=jnp.asarray(lnb), **kw)
    got = IF.fused_bias_dropout_residual_layer_norm(
        _t(x), _t(res), bias=_t(bias), ln_scale=_t(scale),
        ln_bias=_t(lnb), **kw)
    _close(got, want)


def _state(mod):
    return {k: np.asarray(v) for k, v in mod.state_dict().items()}


def _randomize(jax_mod, seed):
    """Give every parameter of a JAX module random values (its init
    leaves biases and norms at constants, which would hide a mix-up)."""
    rs = np.random.RandomState(seed)
    st = {k: (rs.randn(*v.shape) * 0.3).astype(np.float32)
          for k, v in _state(jax_mod).items()}
    jax_mod.set_state_dict({k: jnp.asarray(v) for k, v in st.items()})
    return st


def test_fused_bias_dropout_residual_layer_norm_layer_matches_jax():
    jm = jax_inn.FusedBiasDropoutResidualLayerNorm(D, dropout_rate=0.3)
    st = _randomize(jm, 4)
    pm = load_jax_state(inn.FusedBiasDropoutResidualLayerNorm(
        D, dropout_rate=0.3, device="cpu"), st)
    rs = np.random.RandomState(5)
    x, res = (rs.randn(B, S, D).astype(np.float32) for _ in range(2))
    # training (JAX's layer reads the process default: set it explicitly)
    jm.train()
    want = jm(jnp.asarray(x), jnp.asarray(res), dropout_seed=2 ** 31 - 1)
    got = pm(_t(x), _t(res), dropout_seed=2 ** 31 - 1)
    _close(got, want)
    jm.eval()
    pm.eval()
    _close(pm(_t(x), _t(res)), jm(jnp.asarray(x), jnp.asarray(res)))
    # eval is the plain LN of residual + x + bias
    pre = torch.from_numpy(x + res + st["bias"])
    ln = torch.nn.functional.layer_norm(
        pre, (D,), torch.from_numpy(st["weight"]),
        torch.from_numpy(st["norm_bias"]))
    torch.testing.assert_close(pm(_t(x), _t(res)), ln, atol=TOL, rtol=TOL)


def _layer_pairs():
    return {
        "FusedMultiHeadAttention": (
            lambda: jax_inn.FusedMultiHeadAttention(D, H, 0.0, 0.0),
            lambda: inn.FusedMultiHeadAttention(D, H, 0.0, 0.0,
                                                device="cpu")),
        "FusedFeedForward_post": (
            lambda: jax_inn.FusedFeedForward(D, FF, 0.0, "gelu"),
            lambda: inn.FusedFeedForward(D, FF, 0.0, "gelu", device="cpu")),
        "FusedFeedForward_pre": (
            lambda: jax_inn.FusedFeedForward(D, FF, 0.0,
                                             normalize_before=True),
            lambda: inn.FusedFeedForward(D, FF, 0.0, normalize_before=True,
                                         device="cpu")),
        "FusedTransformerEncoderLayer": (
            lambda: jax_inn.FusedTransformerEncoderLayer(D, H, FF, 0.0),
            lambda: inn.FusedTransformerEncoderLayer(D, H, FF, 0.0,
                                                     device="cpu")),
        "TransformerEncoder_pre": (
            lambda: JaxTransformerEncoder(
                lambda: JaxTransformerEncoderLayer(
                    D, H, FF, 0.0, "gelu", normalize_before=True), 2),
            lambda: pnn.TransformerEncoder(
                lambda: pnn.TransformerEncoderLayer(
                    D, H, FF, 0.0, "gelu", normalize_before=True,
                    device="cpu"), 2)),
    }


@pytest.mark.parametrize("name", sorted(_layer_pairs()))
def test_layers_loaded_through_convert_match_jax(name):
    make_jax, make_port = _layer_pairs()[name]
    jm = make_jax()
    st = _randomize(jm, 6)
    pm = load_jax_state(make_port(), st)
    rs = np.random.RandomState(7)
    x = rs.randn(B, S, D).astype(np.float32)
    if name.startswith("FusedFeedForward"):
        want, got = jm(jnp.asarray(x)), pm(_t(x))
    else:
        mask = np.ones((B, 1, 1, S), bool)
        mask[0, ..., 9:] = False
        if name == "FusedMultiHeadAttention":
            want = jm(jnp.asarray(x), attn_mask=jnp.asarray(mask))
            got = pm(_t(x), attn_mask=_t(mask))
        else:
            want = jm(jnp.asarray(x), src_mask=jnp.asarray(mask))
            got = pm(_t(x), src_mask=_t(mask))
    _close(got, want)


def test_fused_multi_transformer_cached_decode_matches_jax_and_full():
    jm = jax_inn.FusedMultiTransformer(D, H, FF, num_layers=2)
    st = _randomize(jm, 8)
    pm = load_jax_state(inn.FusedMultiTransformer(D, H, FF, num_layers=2,
                                                  device="cpu"), st)
    rs = np.random.RandomState(9)
    x = rs.randn(B, 7, D).astype(np.float32)
    causal = np.tril(np.ones((5, 5), bool))
    jc = jm.gen_cache(jnp.asarray(x))
    pc = pm.gen_cache(_t(x))
    want, jc = jm(jnp.asarray(x[:, :5]), attn_mask=jnp.asarray(causal),
                  caches=jc)
    got, pc = pm(_t(x[:, :5]), attn_mask=_t(causal), caches=pc)
    _close(got, want)
    steps = []
    for t in (5, 6):
        want, jc = jm(jnp.asarray(x[:, t:t + 1]), caches=jc)
        got, pc = pm(_t(x[:, t:t + 1]), caches=pc)
        _close(got, want)
        steps.append(got)
    for (k, v), (jk, jv) in zip(pc, jc):
        _close(k, jk)
        _close(v, jv)
    full = pm(_t(x), attn_mask=_t(np.tril(np.ones((7, 7), bool))))
    torch.testing.assert_close(torch.cat(steps, 1), full[:, 5:],
                               atol=TOL, rtol=TOL)


def test_convert_rejects_mismatched_state():
    jm = jax_inn.FusedFeedForward(D, FF, 0.0)
    st = _state(jm)
    pm = inn.FusedFeedForward(D, FF, 0.0, device="cpu")
    with pytest.raises(KeyError, match="missing"):
        load_jax_state(pm, {k: v for k, v in st.items()
                            if k != "linear1.bias"})
    with pytest.raises(KeyError, match="unexpected"):
        load_jax_state(pm, {**st, "extra.weight": st["linear1.bias"]})
    with pytest.raises(ValueError, match="shape"):
        load_jax_state(pm, {**st, "linear1.weight": st["linear2.weight"]})


def test_fused_linear_routes_quant_tensor_to_k12_plain():
    rs = np.random.RandomState(10)
    x = torch.from_numpy(rs.randn(4, D).astype(np.float32))
    w = torch.from_numpy(rs.randn(D, FF).astype(np.float32))
    qt = quant.quantize_tensor(w)
    bias = torch.from_numpy(rs.randn(FF).astype(np.float32))
    got = IF.fused_linear(x, qt, bias)
    want = int8_matmul_reference(x, qt.q, qt.scale) + bias
    torch.testing.assert_close(got, want)
    torch.testing.assert_close(IF.fused_matmul_bias(x, w, bias),
                               x @ w + bias)


def _kept_share_ok(out, x, p):
    """The kept share within 3 sigma of 1 - p; kept cells scaled by
    1 / (1 - p)."""
    keep = out != 0
    n = keep.numel()
    share = keep.float().mean().item()
    sigma = (p * (1 - p) / n) ** 0.5
    assert abs(share - (1 - p)) <= 3 * sigma, (share, 1 - p, sigma)
    torch.testing.assert_close(out[keep], (x / (1 - p))[keep])


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_generator_dropout_statistics(p):
    """The key-drawn dropout's statistics: the kept share and scale; one
    key repeats its mask, another changes it; the modes; ``axis``; the
    layer under a context."""
    x = torch.rand(64, 257) + 0.5
    out = F_common.dropout(x, p, training=True, key=prng.PRNGKey(0))
    _kept_share_ok(out, x, p)
    assert torch.equal(out, F_common.dropout(x, p, training=True,
                                             key=prng.PRNGKey(0)))
    assert not torch.equal(out != 0, F_common.dropout(
        x, p, training=True, key=prng.PRNGKey(1)) != 0)
    # downscale_in_infer: kept cells unscaled in training, x * (1 - p) in
    # eval
    down = F_common.dropout(x, p, training=True, mode="downscale_in_infer",
                            key=prng.PRNGKey(2))
    assert torch.equal(down[down != 0], x[down != 0])
    torch.testing.assert_close(
        F_common.dropout(x, p, training=False, mode="downscale_in_infer"),
        x * (1 - p))
    assert torch.equal(F_common.dropout(x, p, training=False), x)
    # axis: one draw per row, broadcast along the columns
    rows = F_common.dropout(x, p, axis=0, training=True,
                            key=prng.PRNGKey(3))
    assert torch.equal((rows != 0).all(1), (rows != 0).any(1))
    layer = pnn.Dropout(p)
    with pnn.stateful(training=True, rng=prng.PRNGKey(4)):
        _kept_share_ok(layer(x), x, p)
    assert torch.equal(layer.eval()(x), x)


def test_fused_feedforward_generator_dropout():
    """Both FFN dropouts draw from the halves of the call's key: the
    same key repeats the output, another changes it; the output of the
    second linear is dropped with its kept share near 1 - p."""
    rs = np.random.RandomState(11)
    x = torch.from_numpy(rs.randn(8, 64, D).astype(np.float32))
    w1 = torch.from_numpy((rs.randn(D, FF) * 0.2).astype(np.float32))
    w2 = torch.from_numpy((rs.randn(FF, D) * 0.2).astype(np.float32))

    def run(seed, **kw):
        return IF.fused_feedforward(x, w1, w2, dropout1_rate=0.2,
                                    dropout2_rate=0.3,
                                    rng_key=prng.PRNGKey(seed),
                                    pre_layer_norm=True, **kw)

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    h = run(0, add_residual=False)
    share = (h != 0).float().mean().item()
    n = h.numel()
    assert abs(share - 0.7) <= 3 * (0.21 / n) ** 0.5
    ev = IF.fused_feedforward(x, w1, w2, dropout1_rate=0.2,
                              dropout2_rate=0.3, training=False,
                              pre_layer_norm=True)
    nodrop = IF.fused_feedforward(x, w1, w2, dropout1_rate=0.0,
                                  dropout2_rate=0.0, pre_layer_norm=True)
    assert torch.equal(ev, nodrop)


def test_fused_multi_head_attention_draws_attention_then_k11_seed():
    """The attention takes the first half of ``split(rng_key)`` and K11
    the second, each as ``bits(k) -> int32``: replaying both by hand
    gives the same output."""
    from paddle_tpu_torch.nn.functional.attention import key_seed
    x, w, mask = _mha_weights(12)
    tw = {k: _t(v) for k, v in w.items()}
    key = prng.PRNGKey(3)
    got = IF.fused_multi_head_attention(
        _t(x), **tw, attn_mask=_t(mask), dropout_rate=0.2,
        attn_dropout_rate=0.1, rng_key=key)
    k1, k2 = prng.split(key)
    s_attn, s_ln = key_seed(k1, "cpu"), key_seed(k2, "cpu")
    x_t = _t(x)
    dh = D // H
    qkv = (x_t @ tw["qkv_weight"].reshape(3 * D, D).t()).reshape(
        B, S, 3, H, dh) + tw["qkv_bias"]
    from paddle_tpu_torch.ops.flash_attention import flash_attention_plain
    from paddle_tpu_torch.ops.layer_norm import fused_layer_norm_plain
    attn = flash_attention_plain(
        *(qkv[:, :, i].contiguous() for i in range(3)), bias=_t(mask),
        dropout_p=0.1, dropout_seed=s_attn)
    out = attn.reshape(B, S, D) @ tw["linear_weight"]
    want, _ = fused_layer_norm_plain(
        out, tw["ln_scale"], tw["ln_bias"], residual=x_t,
        bias=tw["linear_bias"], dropout_p=0.2, dropout_seed=s_ln)
    assert torch.equal(got, want)


def test_modules_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU behaviour; a GPU is present")
    for make in (lambda: inn.FusedBiasDropoutResidualLayerNorm(D),
                 lambda: inn.FusedMultiHeadAttention(D, H),
                 lambda: inn.FusedFeedForward(D, FF),
                 lambda: inn.FusedTransformerEncoderLayer(D, H, FF),
                 lambda: inn.FusedMultiTransformer(D, H, FF),
                 lambda: pnn.Linear(D, D), lambda: pnn.LayerNorm(D)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
