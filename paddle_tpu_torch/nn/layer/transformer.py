"""Transformer encoder layers (counterpart of
``paddle_tpu/nn/layer/transformer.py``: ``MultiHeadAttention`` (:19),
``TransformerEncoderLayer`` (:67) and ``TransformerEncoder`` (:112); the
decoder classes are not ported).

Same structure, parameter names and (in, out) layouts as the JAX layers
(``LayerList`` items become ``nn.ModuleList`` indices: JAX
``layers.item_0.linear1.weight`` is ``layers.0.linear1.weight`` here,
which ``models/convert.py`` maps). The attention core is
``F.scaled_dot_product_attention``: the flash kernels on CUDA, with
``attn_mask`` as their bias. Attention dropout applies in training (the
context's flag, else ``self.training``) and is the kernels' hash
dropout, seeded from a context key (``F.fold_ctx_key``) drawn only when
it drops (the JAX layer passes no key, so its attention never drops, and
draws none); the other dropouts are the JAX ``nn.Dropout``, masks from
the context's keys. Every layer takes an explicit ``device`` (None:
CUDA, raising without one), ``dtype`` and ``generator`` (the initial
weights).
"""

import copy
from typing import Optional

import torch
from torch import nn

from paddle_tpu_torch.nn.functional import activation as activations
from paddle_tpu_torch.nn.functional.attention import (
    scaled_dot_product_attention)
from paddle_tpu_torch.nn.functional.common import fold_ctx_key
from paddle_tpu_torch.nn.layer.common import Dropout, Linear
from paddle_tpu_torch.nn.layer.norm import LayerNorm
from paddle_tpu_torch.nn.module import is_training

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder"]


class MultiHeadAttention(nn.Module):
    """q/k/v/out projections around the attention core; activations
    (B, S, D), heads split as (B, S, H, D / H)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 kdim=None, vdim=None, need_weights: bool = False,
                 weight_attr=None, bias_attr=None, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.need_weights = need_weights
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        kw = dict(weight_attr=weight_attr, bias_attr=bias_attr,
                  device=device, dtype=dtype, generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(kdim, embed_dim, **kw)
        self.v_proj = Linear(vdim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def _split(self, x):
        b, s, _ = x.shape
        return x.reshape(b, s, self.num_heads, self.head_dim)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        """Attention of ``query`` over ``key``/``value`` (default: the
        query). ``cache`` (k, v), each (B, T, H, D / H), is prepended to
        this call's keys and values, and the result is then ``(out,
        (k, v))`` with the grown cache."""
        key = query if key is None else key
        value = query if value is None else value
        q = self._split(self.q_proj(query))
        k = self._split(self.k_proj(key))
        v = self._split(self.v_proj(value))
        if cache is not None:
            k = torch.cat([cache[0], k], dim=1)
            v = torch.cat([cache[1], v], dim=1)
        training = is_training(self.training)
        key = (fold_ctx_key() if training and self.dropout > 0.0
               else None)
        out = scaled_dot_product_attention(
            q.contiguous(), k.contiguous(), v.contiguous(),
            attn_mask=attn_mask, dropout_p=self.dropout,
            training=training, rng_key=key)
        b, s = out.shape[:2]
        out = self.out_proj(out.reshape(b, s, self.embed_dim))
        if cache is not None:
            return out, (k, v)
        return out

    def gen_cache(self, key, value=None, type=None):  # noqa: A002
        """(k, v) of ``key`` / ``value``: a cache to pass to forward."""
        k = self._split(self.k_proj(key))
        v = self._split(self.v_proj(value if value is not None else key))
        return (k, v)


class TransformerEncoderLayer(nn.Module):
    """Self-attention then the feed-forward, each with dropout and a
    residual, post-LN (or pre-LN with ``normalize_before``)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "relu",
                 attn_dropout=None, act_dropout=None,
                 normalize_before: bool = False, weight_attr=None,
                 bias_attr=None, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.normalize_before = normalize_before
        kw = dict(weight_attr=weight_attr, bias_attr=bias_attr,
                  device=device, dtype=dtype, generator=generator)
        self.self_attn = MultiHeadAttention(
            d_model, nhead,
            attn_dropout if attn_dropout is not None else dropout, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, device=device, dtype=dtype)
        self.norm2 = LayerNorm(d_model, device=device, dtype=dtype)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.act_dropout = Dropout(
            act_dropout if act_dropout is not None else dropout)
        self.activation = activation
        self._act = activations.get(activation)

    def forward(self, src, src_mask=None, cache=None):
        """(B, S, D) -> (B, S, D); with ``cache`` (the attention's (k, v))
        returns ``(out, cache)`` with the grown cache."""
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, attn_mask=src_mask)
        else:
            src, cache = self.self_attn(src, attn_mask=src_mask,
                                        cache=cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.act_dropout(self._act(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)


class TransformerEncoder(nn.Module):
    """``num_layers`` encoder layers: copies of a prototype layer, or the
    results of a factory called ``num_layers`` times; then ``norm``."""

    def __init__(self, encoder_layer_fn, num_layers: int, norm=None):
        super().__init__()
        if isinstance(encoder_layer_fn, nn.Module):
            layers = [encoder_layer_fn] + [
                copy.deepcopy(encoder_layer_fn)
                for _ in range(num_layers - 1)]
        else:
            layers = [encoder_layer_fn() for _ in range(num_layers)]
        self.layers = nn.ModuleList(layers)
        self.norm = norm

    def forward(self, src, src_mask=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask=src_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out
