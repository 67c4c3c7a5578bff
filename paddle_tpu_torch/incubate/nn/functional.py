"""incubate.nn.functional: the fused-transformer functionals Paddle users
build BERT/ERNIE encoders from (counterpart of
``paddle_tpu/incubate/nn/functional.py``).

- ``fused_matmul_bias`` / ``fused_linear``: ``x @ w + b``; an int8
  ``QuantTensor`` weight runs K12 (``quantization/``).
- ``fused_bias_dropout_residual_layer_norm``: ``LN(residual +
  dropout(x + bias))`` through K11 (``ops/layer_norm.py``).
- ``fused_multi_head_attention``: [pre-LN ->] packed QKV projection,
  qkv_weight (3, H, dh, D) -> attention (the flash kernels K1/K3/K4 with
  ``attn_mask`` as their bias and their hash dropout) -> out-projection
  -> post-LN tail through K11 (``add_residual``), or bias, dropout and
  residual in plain torch (pre-LN); with ``cache_kv`` (2, B, H, T, dh)
  the incremental form: the step's K/V are appended, the query attends
  causally within the new block plus ``attn_mask``, and the grown cache
  is returned beside the output.
- ``fused_feedforward``: [pre-LN ->] linear1 -> activation -> dropout ->
  linear2 -> dropout -> residual [-> post-LN].

Seeds and masks come from the keys the JAX functions use
(``paddle_tpu_torch.random``, the bits of ``jax.random``):
``fused_bias_dropout_residual_layer_norm`` seeds K11 with
``bits(fold_ctx_key())`` as int32 when no ``dropout_seed`` is given;
``fused_multi_head_attention`` splits ``rng_key`` (default
``fold_ctx_key(salt=101)``) into k1, the attention's hash seed
(``key_seed``), and k2, K11's seed or the pre-LN path's dropout mask;
``fused_feedforward`` splits ``rng_key`` (default
``fold_ctx_key(salt=102)``) into the keys of its two dropouts. The
default keys are drawn on every call, training or not, as in JAX, so a
context's key sequence stays the JAX one. ``ring_id`` (tensor
parallelism) is ignored, as in JAX.
"""

import torch

from paddle_tpu_torch import random as prng
from paddle_tpu_torch.nn.functional import activation as activations
from paddle_tpu_torch.nn.functional import common as F_common
from paddle_tpu_torch.nn.functional.attention import (
    key_seed, scaled_dot_product_attention)
from paddle_tpu_torch.ops import layer_norm as ln_ops

__all__ = ["fused_matmul_bias", "fused_linear",
           "fused_bias_dropout_residual_layer_norm",
           "fused_multi_head_attention", "fused_feedforward"]


def _is_quant(w):
    return hasattr(w, "dequantize")


def fused_matmul_bias(x, y, bias=None, transpose_x: bool = False,
                      transpose_y: bool = False, name=None):
    """``x @ y (+ bias)``; an int8 ``QuantTensor`` ``y`` runs K12 through
    its ``__rmatmul__`` (transposed, it is dequantized, as in JAX)."""
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.T if _is_quant(y) else y.transpose(-1, -2)
    out = x @ y
    if bias is not None:
        out = out + bias
    return out


def fused_linear(x, weight, bias=None, transpose_weight: bool = False,
                 name=None):
    return fused_matmul_bias(x, weight, bias, transpose_y=transpose_weight)


def fused_bias_dropout_residual_layer_norm(
        x, residual, bias=None, ln_scale=None, ln_bias=None,
        dropout_rate: float = 0.5, ln_epsilon: float = 1e-5,
        training: bool = True, dropout_seed=None, name=None):
    """``LN(residual + dropout(x + bias))`` over the last dim through K11
    (its plain version on the CPU); ``ln_scale`` / ``ln_bias`` default
    to ones / zeros. The mask is K11's hash of ``dropout_seed``, or of
    ``key_seed(fold_ctx_key())`` when none is given."""
    d = x.shape[-1]
    gamma = (torch.ones(d, dtype=x.dtype, device=x.device)
             if ln_scale is None else ln_scale)
    beta = (torch.zeros(d, dtype=x.dtype, device=x.device)
            if ln_bias is None else ln_bias)
    p = dropout_rate if training else 0.0
    if p > 0.0 and dropout_seed is None:
        dropout_seed = key_seed(F_common.fold_ctx_key(), x.device)
    y, _ = ln_ops.fused_layer_norm(x, gamma, beta, residual=residual,
                                   bias=bias, dropout_p=p,
                                   dropout_seed=dropout_seed,
                                   epsilon=ln_epsilon)
    return y


def _ln(x, scale, bias, eps):
    """LayerNorm in fp32, output in x's dtype (JAX ``_ln``)."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = torch.square(x32 - mu).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale
    if bias is not None:
        y = y + bias
    return y.to(x.dtype)


def fused_multi_head_attention(
        x, qkv_weight, linear_weight, pre_layer_norm: bool = False,
        pre_ln_scale=None, pre_ln_bias=None, ln_scale=None, ln_bias=None,
        pre_ln_epsilon: float = 1e-5, qkv_bias=None, linear_bias=None,
        cache_kv=None, attn_mask=None, dropout_rate: float = 0.5,
        attn_dropout_rate: float = 0.5, ln_epsilon: float = 1e-5,
        training: bool = True, mode: str = "upscale_in_train",
        ring_id: int = -1, add_residual: bool = True, rng_key=None,
        name=None):
    """The whole attention block of a fused encoder; x (B, S, D),
    qkv_weight (3, H, dh, D), qkv_bias (3, H, dh), linear_weight
    (H dh, D). Returns the output, or ``(out, cache_kv_out)`` with
    ``cache_kv``."""
    if qkv_weight.dim() != 4 or qkv_weight.shape[0] != 3:
        raise ValueError(f"qkv_weight must be (3, H, dh, D), got "
                         f"{tuple(qkv_weight.shape)}")
    _, h, dh, d = qkv_weight.shape
    if d != x.shape[-1]:
        raise ValueError(f"qkv_weight {tuple(qkv_weight.shape)} does not "
                         f"match x {tuple(x.shape)}")
    residual = x
    if pre_layer_norm:
        x = _ln(x, pre_ln_scale, pre_ln_bias, pre_ln_epsilon)
    b, sq = x.shape[0], x.shape[1]
    qkv = (x @ qkv_weight.reshape(3 * h * dh, d).t()).reshape(
        b, sq, 3, h, dh)
    if qkv_bias is not None:
        qkv = qkv + qkv_bias
    q, k, v = (qkv[:, :, i].contiguous() for i in range(3))
    if rng_key is None:
        rng_key = F_common.fold_ctx_key(salt=101)
    k1, k2 = prng.split(rng_key)
    attn_p = attn_dropout_rate if training else 0.0
    cache_out = None
    if cache_kv is not None:
        if cache_kv.dim() != 5 or cache_kv.shape[0] != 2:
            raise ValueError(f"cache_kv must be (2, B, H, T, dh), got "
                             f"{tuple(cache_kv.shape)}")
        t_past = cache_kv.shape[3]
        k_full = torch.cat([cache_kv[0],
                            k.transpose(1, 2).to(cache_kv.dtype)], 2)
        v_full = torch.cat([cache_kv[1],
                            v.transpose(1, 2).to(cache_kv.dtype)], 2)
        cache_out = torch.stack([k_full, v_full])
        causal = (t_past + torch.arange(sq, device=x.device)[:, None]
                  >= torch.arange(t_past + sq, device=x.device)[None, :])
        bias = torch.where(causal, 0.0, float("-inf"))[None, None]
        if attn_mask is not None:
            bias = bias + attn_mask
        k, v = (t.transpose(1, 2).to(q.dtype).contiguous()
                for t in (k_full, v_full))
        attn_mask = bias
    attn = scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask, dropout_p=attn_p, training=training,
        rng_key=k1)
    out = attn.reshape(b, sq, h * dh) @ linear_weight
    if not pre_layer_norm and add_residual:
        # the whole tail is the sibling fused op: K11
        out = fused_bias_dropout_residual_layer_norm(
            out, residual, bias=linear_bias, ln_scale=ln_scale,
            ln_bias=ln_bias, dropout_rate=dropout_rate,
            ln_epsilon=ln_epsilon, training=training,
            dropout_seed=key_seed(k2, x.device))
    else:
        if linear_bias is not None:
            out = out + linear_bias
        out = F_common.dropout(out, dropout_rate, training=training,
                               mode=mode, key=k2)
        if add_residual:
            out = residual + out
        if not pre_layer_norm:
            out = _ln(out, ln_scale, ln_bias, ln_epsilon)
    return out if cache_out is None else (out, cache_out)


def fused_feedforward(
        x, linear1_weight, linear2_weight, linear1_bias=None,
        linear2_bias=None, ln1_scale=None, ln1_bias=None, ln2_scale=None,
        ln2_bias=None, dropout1_rate: float = 0.5,
        dropout2_rate: float = 0.5, activation: str = "relu",
        ln1_epsilon: float = 1e-5, ln2_epsilon: float = 1e-5,
        pre_layer_norm: bool = False, training: bool = True,
        mode: str = "upscale_in_train", ring_id: int = -1,
        add_residual: bool = True, rng_key=None, name=None):
    """[pre-LN (ln1) ->] linear1 -> activation -> dropout1 -> linear2 ->
    dropout2 -> residual [-> post-LN (ln2)]; the two masks from the two
    halves of ``split(rng_key)``."""
    residual = x
    if pre_layer_norm:
        x = _ln(x, ln1_scale, ln1_bias, ln1_epsilon)
    if rng_key is None:
        rng_key = F_common.fold_ctx_key(salt=102)
    k1, k2 = prng.split(rng_key)
    h = fused_matmul_bias(x, linear1_weight, linear1_bias)
    h = activations.get(activation)(h)
    h = F_common.dropout(h, dropout1_rate, training=training, mode=mode,
                         key=k1)
    h = fused_matmul_bias(h, linear2_weight, linear2_bias)
    h = F_common.dropout(h, dropout2_rate, training=training, mode=mode,
                         key=k2)
    out = residual + h if add_residual else h
    if not pre_layer_norm:
        out = _ln(out, ln2_scale, ln2_bias, ln2_epsilon)
    return out
