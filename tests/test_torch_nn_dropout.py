"""Dropout from JAX keys in the port's ``nn`` against the JAX package's,
on the CPU: the masks of ``F.dropout`` (``axis``, both modes, eval),
``dropout2d`` / ``dropout3d`` (both data formats) and the values of
``alpha_dropout`` at a given key; the key sequence of ``fold_ctx_key``
under ``nn.stateful`` and the global stream's after ``random.seed``; the
``nn.Dropout*`` layers and ``TransformerEncoderLayer`` under a context;
and the incubate functionals under one context: their seeds are JAX's
``bits`` of the same keys, and their outputs, at attention dropout 0
with the plain dropouts and K11 at 0.1, match JAX's within the incubate
tests' tolerance.

``paddle_tpu_torch.random`` reproduces ``jax.random`` bit for bit, so
every mask is compared exactly; values through a division or SELU's
affine map to a few fp32 ulps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jax_nn
from paddle_tpu import random as jax_random
from paddle_tpu.incubate import nn as jax_inn
from paddle_tpu.incubate.nn import functional as jax_IF
from paddle_tpu.nn import functional as jax_F
from paddle_tpu.nn.layer.transformer import (
    TransformerEncoderLayer as JaxTransformerEncoderLayer)
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import random as prng
from paddle_tpu_torch.incubate import nn as inn
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.models.convert import load_jax_state
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional.attention import key_seed
from torch_reference_compile import fast_reference_compiles  # noqa: F401

TOL = 2e-5          # the incubate tests' tolerance (fp32)
B, S, D, H, FF = 2, 12, 32, 4, 64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _x(shape, seed=0):
    rs = np.random.RandomState(seed)
    # no zeros: a zero marks a dropped cell
    return (np.abs(rs.randn(*shape)) + 0.5).astype(np.float32)


def _key_words(k):
    return [int(w) for w in np.asarray(jax.random.key_data(k)
                                       if jnp.issubdtype(
                                           k.dtype, jax.dtypes.prng_key)
                                       else k).astype(np.uint32)]


def _same_key(port_key, jax_key):
    assert [int(w) & 0xFFFFFFFF for w in port_key.tolist()] == \
        _key_words(jax_key)


@pytest.mark.parametrize("axis", [None, 0, 1, (0, 2)],
                         ids=["all", "axis0", "axis1", "axis02"])
@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_mask_matches_jax(axis, mode, p):
    x = _x((4, 6, 40), seed=1)
    got = F.dropout(torch.from_numpy(x), p, axis=axis, training=True,
                    mode=mode, key=prng.PRNGKey(7)).numpy()
    want = np.asarray(jax_F.dropout(jnp.asarray(x), p, axis=axis,
                                    training=True, mode=mode,
                                    key=jax.random.PRNGKey(7)))
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert 0 < (got == 0).mean() < 1


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_eval_matches_jax(mode):
    x = _x((3, 50), seed=2)
    got = F.dropout(torch.from_numpy(x), 0.3, training=False,
                    mode=mode).numpy()
    want = np.asarray(jax_F.dropout(jnp.asarray(x), 0.3, training=False,
                                    mode=mode))
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)


def test_dropout_bf16_matches_jax():
    """bf16: JAX divides by the weakly typed 1 - p rounded to bf16."""
    x = _x((8, 64), seed=3)
    got = F.dropout(torch.from_numpy(x).to(torch.bfloat16), 0.1,
                    training=True, key=prng.PRNGKey(3))
    want = jax_F.dropout(jnp.asarray(x, jnp.bfloat16), 0.1, training=True,
                         key=jax.random.PRNGKey(3))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_dropout2d_matches_jax(fmt):
    x = _x((3, 5, 4, 6), seed=4)
    got = F.dropout2d(torch.from_numpy(x), 0.4, training=True,
                      data_format=fmt, key=prng.PRNGKey(11)).numpy()
    want = np.asarray(jax_F.dropout2d(jnp.asarray(x), 0.4, training=True,
                                      data_format=fmt,
                                      key=jax.random.PRNGKey(11)))
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # one draw per (N, C): whole channels kept or dropped
    ch = (got != 0).reshape(3, 5, -1) if fmt == "NCHW" else \
        (got != 0).transpose(0, 3, 1, 2).reshape(3, 6, -1)
    assert (ch.all(-1) == ch.any(-1)).all()


@pytest.mark.parametrize("fmt", ["NCDHW", "NDHWC"])
def test_dropout3d_matches_jax(fmt):
    x = _x((2, 4, 3, 3, 5), seed=5)
    got = F.dropout3d(torch.from_numpy(x), 0.5, training=True,
                      data_format=fmt, key=prng.PRNGKey(12)).numpy()
    want = np.asarray(jax_F.dropout3d(jnp.asarray(x), 0.5, training=True,
                                      data_format=fmt,
                                      key=jax.random.PRNGKey(12)))
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("p", [0.05, 0.3])
def test_alpha_dropout_matches_jax(p):
    x = np.random.RandomState(6).randn(16, 33).astype(np.float32)
    got = F.alpha_dropout(torch.from_numpy(x), p, training=True,
                          key=prng.PRNGKey(13)).numpy()
    want = np.asarray(jax_F.alpha_dropout(jnp.asarray(x), p, training=True,
                                          key=jax.random.PRNGKey(13)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.array_equal(F.alpha_dropout(torch.from_numpy(x), p,
                                          training=False).numpy(), x)


@pytest.mark.parametrize("salts", [(0,), (0, 0, 5), (101, 102, 0, 7)],
                         ids=["one", "repeat", "mixed"])
def test_fold_ctx_key_sequence_matches_jax(salts):
    with pnn.stateful(training=True, rng=prng.PRNGKey(42)):
        got = [F.fold_ctx_key(salt=s) for s in salts]
    with jax_nn.stateful(training=True, rng=jax.random.PRNGKey(42)):
        want = [jax_F.fold_ctx_key(salt=s) for s in salts]
    for g, w in zip(got, want):
        _same_key(g, w)
    # a given key passes through
    k = prng.PRNGKey(3)
    assert F.fold_ctx_key(key=k) is k


def test_context_counter_past_2_31_matches_jax():
    """``next_key`` folds ``counter * 1000003 + salt``: at counter 2200
    the data passes 2^31, and ``random.fold_in`` reads it as uint32, as
    ``jax.random.fold_in`` does; at 4295 it passes 2^32, and both refuse
    the Python int. An int32 tensor wraps, as a JAX int32 array does."""
    for data in (2 ** 31 - 1, 2 ** 31, 2200 * 1000003 + 5, 2 ** 32 - 1):
        _same_key(prng.fold_in(prng.PRNGKey(9), data),
                  jax.random.fold_in(jax.random.PRNGKey(9), data))
    _same_key(prng.fold_in(prng.PRNGKey(9), torch.tensor(-1)),
              jax.random.fold_in(jax.random.PRNGKey(9), jnp.int32(-1)))
    for data in (-1, 2 ** 32):
        with pytest.raises(OverflowError):
            jax.random.fold_in(jax.random.PRNGKey(9), data)
        with pytest.raises(OverflowError):
            prng.fold_in(prng.PRNGKey(9), data)
    ctx, jctx = pnn.Context(True, prng.PRNGKey(1)), \
        jax_nn.Context(True, jax.random.PRNGKey(1))
    ctx._rng_counter = jctx._rng_counter = 2199
    _same_key(ctx.next_key(5), jctx.next_key(5))
    ctx._rng_counter = jctx._rng_counter = 4294
    with pytest.raises(OverflowError):
        jctx.next_key(5)
    with pytest.raises(OverflowError):
        ctx.next_key(5)


def test_global_stream_fallback_matches_jax():
    """Without a context the keys are the global stream's, after
    ``random.seed`` as in JAX; the training flag defaults to False. Both
    global streams are restored afterwards for the worker's later
    tests."""
    saved = prng.get_rng_state(), jax_random.get_rng_state()
    prng.seed(5)
    jax_random.seed(5)
    try:
        for _ in range(3):
            _same_key(F.fold_ctx_key(), jax_F.fold_ctx_key())
        x = _x((4, 32), seed=7)
        assert torch.equal(F.dropout(torch.from_numpy(x), 0.5),
                           torch.from_numpy(x))
        got = F.dropout(torch.from_numpy(x), 0.5, training=True).numpy()
        want = np.asarray(jax_F.dropout(jnp.asarray(x), 0.5,
                                        training=True))
        np.testing.assert_array_equal(got != 0, want != 0)
    finally:
        prng.set_rng_state(saved[0])
        jax_random.set_rng_state(saved[1])
    assert not pnn.is_training() and pnn.is_training(True)
    with pnn.stateful(training=False):
        assert not pnn.is_training(True)


_LAYERS = {
    "Dropout": (lambda: pnn.Dropout(0.3), lambda: jax_nn.Dropout(0.3),
                (4, 40)),
    "Dropout_axis": (lambda: pnn.Dropout(0.3, axis=1),
                     lambda: jax_nn.Dropout(0.3, axis=1), (4, 6, 8)),
    "Dropout2D": (lambda: pnn.Dropout2D(0.5),
                  lambda: jax_nn.Dropout2D(0.5), (2, 6, 3, 3)),
    "Dropout3D": (lambda: pnn.Dropout3D(0.5, data_format="NDHWC"),
                  lambda: jax_nn.Dropout3D(0.5, data_format="NDHWC"),
                  (2, 3, 3, 3, 6)),
    "AlphaDropout": (lambda: pnn.AlphaDropout(0.2),
                     lambda: jax_nn.AlphaDropout(0.2), (5, 30)),
}


@pytest.mark.parametrize("name", sorted(_LAYERS))
def test_dropout_layers_match_jax_under_a_context(name):
    make, make_jax, shape = _LAYERS[name]
    x = _x(shape, seed=8)
    layer, jlayer = make(), make_jax()
    with pnn.stateful(training=True, rng=prng.PRNGKey(21)):
        got = [layer(torch.from_numpy(x)).numpy() for _ in range(2)]
    with jax_nn.stateful(training=True, rng=jax.random.PRNGKey(21)):
        want = [np.asarray(jlayer(jnp.asarray(x))) for _ in range(2)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    assert not np.array_equal(got[0], got[1])  # two keys, two masks
    # eval: the layer's own mode, unless a context says otherwise
    assert np.array_equal(layer.eval()(torch.from_numpy(x)).numpy(), x)
    with pnn.stateful(training=True, rng=prng.PRNGKey(21)):
        np.testing.assert_allclose(layer(torch.from_numpy(x)).numpy(),
                                   want[0], rtol=1e-6, atol=1e-6)


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


def _ffn_weights(seed):
    rs = np.random.RandomState(seed)
    w = dict(linear1_weight=rs.randn(D, FF) * D ** -0.5,
             linear2_weight=rs.randn(FF, D) * FF ** -0.5,
             linear1_bias=rs.randn(FF) * 0.1,
             linear2_bias=rs.randn(D) * 0.1,
             ln1_scale=1 + 0.1 * rs.randn(D), ln1_bias=rs.randn(D),
             ln2_scale=1 + 0.1 * rs.randn(D), ln2_bias=rs.randn(D))
    return {k: v.astype(np.float32) for k, v in w.items()}


def test_incubate_seeds_are_jax_bits_of_the_context_keys():
    """Under one context: the attention's default key (salt 101), the
    FFN's (salt 102) and K11's (salt 0) are JAX's, and each kernel seed
    is ``bits(key, (), uint32)`` as int32 of the same key."""
    def bits32(k):
        return int(np.asarray(jax.random.bits(k, (), jnp.uint32)).astype(
            np.int32))

    with pnn.stateful(training=True, rng=prng.PRNGKey(5)):
        attn_key = F.fold_ctx_key(salt=101)
        ffn_key = F.fold_ctx_key(salt=102)
        ln_key = F.fold_ctx_key()
    with jax_nn.stateful(training=True, rng=jax.random.PRNGKey(5)):
        jattn = jax_F.fold_ctx_key(salt=101)
        jffn = jax_F.fold_ctx_key(salt=102)
        jln = jax_F.fold_ctx_key()
    for got, want in ((attn_key, jattn), (ffn_key, jffn), (ln_key, jln)):
        _same_key(got, want)
    for got, want in zip(prng.split(attn_key), jax.random.split(jattn)):
        _same_key(got, want)
        assert int(key_seed(got, "cpu")) == bits32(want)
    assert int(key_seed(ln_key, "cpu")) == bits32(jln)


def _ctx_run(fn_port, fn_jax, seed=9):
    with pnn.stateful(training=True, rng=prng.PRNGKey(seed)):
        got = fn_port()
    with jax_nn.stateful(training=True, rng=jax.random.PRNGKey(seed)):
        want = fn_jax()
    return got, want


@pytest.mark.parametrize("pre_layer_norm", [False, True],
                         ids=["k11_tail", "pre_ln"])
def test_fused_multi_head_attention_under_a_context_matches_jax(
        pre_layer_norm):
    """Attention dropout 0, the tail's dropout 0.1: K11's hash of k2's
    bits (post-LN) or the plain mask of k2 (pre-LN), twice in one
    context (two keys)."""
    x, w, mask = _mha_weights(3)
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    kw = dict(pre_layer_norm=pre_layer_norm, dropout_rate=0.1,
              attn_dropout_rate=0.0)

    def port():
        return [IF.fused_multi_head_attention(
            torch.from_numpy(x), **tw, attn_mask=torch.from_numpy(mask),
            **kw) for _ in range(2)]

    def jax_side():
        return [jax_IF.fused_multi_head_attention(
            jnp.asarray(x), **{k: jnp.asarray(v) for k, v in w.items()},
            attn_mask=jnp.asarray(mask), **kw) for _ in range(2)]

    got, want = _ctx_run(port, jax_side)
    for g, wt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wt), atol=TOL,
                                   rtol=TOL)
    assert not torch.equal(got[0], got[1])


@pytest.mark.parametrize("pre_layer_norm", [False, True])
def test_fused_feedforward_under_a_context_matches_jax(pre_layer_norm):
    x = np.random.RandomState(4).randn(B, S, D).astype(np.float32)
    w = _ffn_weights(5)
    kw = dict(pre_layer_norm=pre_layer_norm, dropout1_rate=0.1,
              dropout2_rate=0.1, activation="gelu")
    got, want = _ctx_run(
        lambda: IF.fused_feedforward(
            torch.from_numpy(x), **{k: torch.from_numpy(v)
                                    for k, v in w.items()}, **kw),
        lambda: jax_IF.fused_feedforward(
            jnp.asarray(x), **{k: jnp.asarray(v) for k, v in w.items()},
            **kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_fused_bias_dropout_residual_layer_norm_under_a_context():
    """The functional and the layer seed K11 from the context's key."""
    rs = np.random.RandomState(6)
    x, res = (rs.randn(B, S, D).astype(np.float32) for _ in range(2))
    bias = (0.1 * rs.randn(D)).astype(np.float32)
    got, want = _ctx_run(
        lambda: IF.fused_bias_dropout_residual_layer_norm(
            torch.from_numpy(x), torch.from_numpy(res),
            bias=torch.from_numpy(bias), dropout_rate=0.2),
        lambda: jax_IF.fused_bias_dropout_residual_layer_norm(
            jnp.asarray(x), jnp.asarray(res), bias=jnp.asarray(bias),
            dropout_rate=0.2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    layer = inn.FusedBiasDropoutResidualLayerNorm(D, dropout_rate=0.2,
                                                  device="cpu")
    jlayer = jax_inn.FusedBiasDropoutResidualLayerNorm(D, dropout_rate=0.2)
    load_jax_state(layer, {k: np.asarray(v)
                           for k, v in jlayer.state_dict().items()})
    got, want = _ctx_run(
        lambda: layer(torch.from_numpy(x), torch.from_numpy(res)),
        lambda: jlayer(jnp.asarray(x), jnp.asarray(res)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)


def test_encoder_layer_dropouts_follow_the_jax_key_sequence():
    """``TransformerEncoderLayer`` at attention dropout 0: dropout1,
    act_dropout and dropout2 take the context's keys 1, 2 and 3, as in
    JAX (the attention draws none when it does not drop)."""
    jl = JaxTransformerEncoderLayer(D, H, FF, dropout=0.1, attn_dropout=0.0,
                                    activation="gelu")
    rs = np.random.RandomState(7)
    state = {k: (np.asarray(v) + 0.05 * rs.randn(*np.shape(v))).astype(
        np.float32) for k, v in jl.state_dict().items()}
    jl.set_state_dict({k: jnp.asarray(v) for k, v in state.items()})
    layer = load_jax_state(pnn.TransformerEncoderLayer(
        D, H, FF, dropout=0.1, attn_dropout=0.0, activation="gelu",
        device="cpu"), state)
    x = rs.randn(B, S, D).astype(np.float32)
    got, want = _ctx_run(lambda: layer(torch.from_numpy(x)),
                         lambda: jl(jnp.asarray(x)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)


def test_no_generator_on_the_dropout_paths():
    """No dropout entry point of ``nn`` or ``incubate`` takes a
    ``generator`` any more (``Linear`` keeps one for its weights)."""
    import inspect
    fns = [F.dropout, F.dropout2d, F.dropout3d, F.alpha_dropout,
           F.scaled_dot_product_attention, IF.fused_multi_head_attention,
           IF.fused_feedforward, IF.fused_bias_dropout_residual_layer_norm,
           pnn.Dropout, pnn.Dropout2D, pnn.Dropout3D, pnn.AlphaDropout,
           inn.FusedBiasDropoutResidualLayerNorm]
    for fn in fns:
        assert "generator" not in inspect.signature(fn).parameters, fn
