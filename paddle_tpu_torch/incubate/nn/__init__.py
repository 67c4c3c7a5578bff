"""Fused transformer layers (counterpart of
``paddle_tpu/incubate/nn/__init__.py``): ``FusedBiasDropoutResidualLayerNorm``
(:16), which runs K11, and the API shells ``FusedMultiHeadAttention``,
``FusedFeedForward``, ``FusedTransformerEncoderLayer`` and
``FusedMultiTransformer``, whose attention core is the flash kernels
(K1/K3/K4) inside ``F.scaled_dot_product_attention``.

Same structure and parameter names as the JAX layers; ``nn.Module``s on
an explicit ``device`` (None: CUDA, raising without one), ``dtype`` and
``generator`` (the source of the initial weights). Dropout masks and
hash-dropout seeds come from the context's keys, as in JAX
(``F.fold_ctx_key``; ``nn.stateful``).
"""

from typing import Optional

import torch
from torch import nn

from paddle_tpu_torch import device as device_lib
from paddle_tpu_torch import dtypes
from paddle_tpu_torch.nn.functional import activation as activations
from paddle_tpu_torch.nn.functional.attention import key_seed
from paddle_tpu_torch.nn.functional.common import fold_ctx_key
from paddle_tpu_torch.nn.layer.common import Dropout, Linear
from paddle_tpu_torch.nn.layer.norm import LayerNorm
from paddle_tpu_torch.nn.layer.transformer import (MultiHeadAttention,
                                                   TransformerEncoderLayer)
from paddle_tpu_torch.ops import layer_norm as ln_ops

__all__ = ["FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer", "FusedMultiTransformer",
           "FusedBiasDropoutResidualLayerNorm"]


class FusedBiasDropoutResidualLayerNorm(nn.Module):
    """``LN(residual + dropout(x + bias))`` in one K11 launch on CUDA
    (its plain version on the CPU): ``weight`` and ``norm_bias`` the
    LayerNorm's, ``bias`` the pre-dropout bias (``bias_attr=False`` drops
    it). In training the mask is K11's hash of ``dropout_seed`` or of
    ``key_seed(fold_ctx_key())``, as the JAX layer seeds it."""

    def __init__(self, embed_dim: int, dropout_rate: float = 0.5,
                 bias_attr=None, epsilon: float = 1e-5, device=None,
                 dtype=torch.float32):
        super().__init__()
        dev = device_lib.resolve(device)
        dt = dtypes.to_dtype(dtype)
        self.embed_dim = embed_dim
        self.dropout_rate = dropout_rate
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(embed_dim, device=dev,
                                              dtype=dt))
        self.norm_bias = nn.Parameter(torch.zeros(embed_dim, device=dev,
                                                  dtype=dt))
        self.bias = (None if bias_attr is False else nn.Parameter(
            torch.zeros(embed_dim, device=dev, dtype=dt)))

    def forward(self, x, residual, dropout_seed=None):
        p = self.dropout_rate if self.training else 0.0
        if p > 0.0 and dropout_seed is None:
            dropout_seed = key_seed(fold_ctx_key(), x.device)
        y, _ = ln_ops.fused_layer_norm(
            x, self.weight, self.norm_bias, residual=residual,
            bias=self.bias, dropout_p=p, dropout_seed=dropout_seed,
            epsilon=self.epsilon)
        return y


class FusedMultiHeadAttention(MultiHeadAttention):
    """``MultiHeadAttention`` under the incubate signature, as in JAX
    (the fusion is the flash kernels inside the attention core)."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__(embed_dim, num_heads, dropout=attn_dropout_rate,
                         kdim=kdim, vdim=vdim, need_weights=need_weights,
                         device=device, dtype=dtype, generator=generator)


class FusedFeedForward(nn.Module):
    """[LN ->] linear1 -> activation -> dropout -> linear2 -> dropout ->
    residual [-> LN], with one LayerNorm ``norm`` as in JAX."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 activation="relu", act_dropout_rate=None,
                 normalize_before=False, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.normalize_before = normalize_before
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm = LayerNorm(d_model, device=device, dtype=dtype)
        self.dropout = Dropout(dropout_rate)
        self.act_dropout = Dropout(act_dropout_rate if act_dropout_rate
                                   is not None else dropout_rate)
        self.activation = activation
        self._act = activations.get(activation)

    def forward(self, src):
        residual = src
        if self.normalize_before:
            src = self.norm(src)
        out = self.linear2(self.act_dropout(self._act(self.linear1(src))))
        out = residual + self.dropout(out)
        if not self.normalize_before:
            out = self.norm(out)
        return out


class FusedTransformerEncoderLayer(TransformerEncoderLayer):
    """``TransformerEncoderLayer`` under its incubate name, as in JAX."""


class FusedMultiTransformer(nn.Module):
    """Stacked encoder-style blocks (pre-LN by default) sharing one
    layout, with the CacheKV incremental form: pass
    ``caches=self.gen_cache(x)`` and feed the prompt, then one token at
    a time; each call returns ``(out, caches)``."""

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, activation="gelu", normalize_before=True,
                 num_layers=1, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__()
        self.blocks = nn.ModuleList([
            TransformerEncoderLayer(embed_dim, num_heads, dim_feedforward,
                                    dropout_rate, activation,
                                    normalize_before=normalize_before,
                                    device=device, dtype=dtype,
                                    generator=generator)
            for _ in range(num_layers)])

    def gen_cache(self, x):
        """Per-layer empty (k, v) caches, (B, 0, H, dh) each, for a
        (B, *, D) prototype ``x``: the prompt's forward fills them."""
        b = x.shape[0]
        out = []
        for blk in self.blocks:
            a = blk.self_attn
            shape = (b, 0, a.num_heads, a.head_dim)
            out.append((torch.zeros(shape, dtype=x.dtype, device=x.device),
                        torch.zeros(shape, dtype=x.dtype, device=x.device)))
        return out

    def forward(self, src, attn_mask=None, caches=None):
        out = src
        if caches is None:
            for blk in self.blocks:
                out = blk(out, src_mask=attn_mask)
            return out
        if len(caches) != len(self.blocks):
            raise ValueError(
                f"caches has {len(caches)} entries for "
                f"{len(self.blocks)} layers (build with gen_cache)")
        new_caches = []
        for blk, cache in zip(self.blocks, caches):
            out, cache = blk(out, src_mask=attn_mask, cache=cache)
            new_caches.append(cache)
        return out, new_caches
