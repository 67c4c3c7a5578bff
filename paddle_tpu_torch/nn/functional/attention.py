"""Attention functionals (counterpart of
``paddle_tpu/nn/functional/attention.py``).

``scaled_dot_product_attention`` runs the differentiable flash path
(``ops/flash_attention.py``) for CUDA tensors, whatever the sequence
length (the JAX package's ``q.shape[1] >= 128`` gate was a TPU tiling
limit, not a semantic one): the hand-written forward K1 and, under
autograd, the backward kernels K3 and K4, with ``attn_mask`` as their
additive bias and their hash dropout. The hash's seed is the JAX one,
``bits(rng_key, ())`` as int32 (``key_seed``), or a given
``dropout_seed``; with neither, nothing is dropped, as the JAX function
drops nothing without a key. CPU tensors run ``attention_reference``,
as the JAX package's CPU path runs its XLA reference, except with
dropout: the JAX CPU path draws its mask from ``jax.random.bernoulli``
of the key, the TPU kernels from the hash of the key's bits, and the
port keeps the kernels' semantics on both devices, so its CPU call
takes the kernels' plain versions and drops the cells the card drops.
Layout (B, S, H, D); k/v may carry fewer heads (GQA). No amp casting in
this slice.
"""

import math
from typing import Optional

import torch

from paddle_tpu_torch import random as prng
from paddle_tpu_torch.ops import _hash
from paddle_tpu_torch.ops.flash_attention import (flash_attention,
                                                  flash_attention_plain)

__all__ = ["scaled_dot_product_attention", "attention_reference",
           "mask_to_bias", "key_seed"]


def attention_reference(q, k, v, mask=None, is_causal: bool = False,
                        scale: Optional[float] = None):
    """Plain attention in fp32, output in q's dtype. q (B, Sq, H, D),
    k/v (B, Sk, Hkv, D). ``mask``: bool (True = visible) or additive,
    broadcastable to (B, H, Sq, Sk). Masked logits take the finite
    -1e30 of the JAX reference, so a row with no visible key averages
    v rather than giving NaN."""
    if k.shape[2] != q.shape[2]:
        group = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if is_causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        causal = torch.ones((sq, sk), dtype=torch.bool,
                            device=q.device).tril(diagonal=sk - sq)
        logits = logits.masked_fill(~causal, -1e30)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, -1e30)
        else:
            logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


def key_seed(rng_key, device) -> torch.Tensor:
    """The kernels' hash-dropout seed of ``rng_key``: ``bits(rng_key,
    ())`` as int32 (JAX ``jax.random.bits(key, (), uint32)
    .astype(int32)``), the 0-dim int32 tensor on ``device`` that the
    kernels read. A host key's word is computed on the host and reaches
    the card as a fill; a card key's stays on the card. Nothing waits
    for the card."""
    key = torch.as_tensor(rng_key)
    if key.device.type == "cpu":
        return _hash.seed_tensor(int(prng.bits(key, (), device="cpu")),
                                 device)
    return _hash.seed_tensor(prng.bits(key, ()), device)


def mask_to_bias(attn_mask):
    """The flash kernels' additive bias for ``attn_mask``: a bool mask
    (True = visible) becomes 0 / -1e30 in fp32, a float mask is the bias
    itself; leading dims of 1 pad it to 4-D (JAX attention.py:92-100)."""
    if attn_mask.dtype == torch.bool:
        bias = torch.where(attn_mask, 0.0, -1e30).to(torch.float32)
    else:
        bias = attn_mask
    while bias.dim() < 4:
        bias = bias[None]
    return bias


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True,
                                 scale: Optional[float] = None,
                                 rng_key: Optional[torch.Tensor] = None,
                                 kv_lens: Optional[torch.Tensor] = None,
                                 dropout_seed=None):
    """Attention over (B, S, H, D): the flash kernels (K1 forward, K3/K4
    backward) on CUDA, the plain versions on the CPU. ``kv_lens`` (B,)
    int32 masks keys at or past kv_lens[b]; ``attn_mask`` (bool, True =
    visible, or additive, broadcastable to (B, H, Sq, Sk)) is the
    kernels' bias (``mask_to_bias``). Dropout (``dropout_p`` while
    ``training``) is the kernels' hash dropout, seeded by
    ``dropout_seed`` or by ``key_seed(rng_key)``; with neither it drops
    nothing (the JAX function needs a key to drop). On the CPU a
    dropping call runs ``flash_attention_plain``, so both devices drop
    the same cells. A CPU call without dropout runs
    ``attention_reference``."""
    eff_dropout = dropout_p if training else 0.0
    seed = dropout_seed
    if eff_dropout > 0.0 and seed is None:
        if rng_key is None:
            eff_dropout = 0.0
        else:
            seed = key_seed(rng_key, query.device)
    if query.device.type == "cuda" or eff_dropout > 0.0:
        attend = (flash_attention if query.device.type == "cuda"
                  else flash_attention_plain)
        bias = None if attn_mask is None else mask_to_bias(attn_mask)
        return attend(query, key, value, causal=is_causal, scale=scale,
                      kv_lens=kv_lens, bias=bias, dropout_p=eff_dropout,
                      dropout_seed=seed)
    if attn_mask is None and kv_lens is not None:
        sk = key.shape[1]
        keep = (torch.arange(sk, device=key.device)[None, :]
                < kv_lens.to(key.device).long()[:, None])
        attn_mask = torch.where(keep, 0.0, -1e30)[:, None, None, :]
    return attention_reference(query, key, value, mask=attn_mask,
                               is_causal=is_causal, scale=scale)
