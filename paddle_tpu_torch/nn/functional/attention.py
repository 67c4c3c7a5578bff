"""Attention functionals (counterpart of
``paddle_tpu/nn/functional/attention.py``).

``scaled_dot_product_attention`` runs the differentiable flash path
(``ops/flash_attention.py``) for CUDA tensors, whatever the sequence
length (the JAX package's ``q.shape[1] >= 128`` gate was a TPU tiling
limit, not a semantic one): the hand-written forward K1 and, under
autograd, the backward kernels K3 and K4. CPU tensors run
``attention_reference``, as the JAX package's CPU path runs its XLA
reference. Nothing else chooses between the two. Layout (B, S, H, D);
k/v may carry fewer heads (GQA). No amp casting in this slice.
"""

import math
from typing import Optional

import torch

from paddle_tpu_torch.ops.flash_attention import flash_attention

__all__ = ["scaled_dot_product_attention", "attention_reference"]


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


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True,
                                 scale: Optional[float] = None,
                                 kv_lens: Optional[torch.Tensor] = None):
    """Attention over (B, S, H, D): the flash kernels (K1 forward, K3/K4
    backward) on CUDA, the plain reference on the CPU. ``kv_lens`` (B,)
    int32 masks keys at or past kv_lens[b]. Dropout raises (ROADMAP T1),
    and so does ``attn_mask`` on CUDA (the flash bias, ROADMAP T1)."""
    eff_dropout = dropout_p if training else 0.0
    if eff_dropout > 0.0:
        raise NotImplementedError("attention dropout is not ported yet "
                                  "(ROADMAP T1)")
    if query.device.type == "cuda":
        if attn_mask is not None:
            raise NotImplementedError("attn_mask on CUDA is not ported yet "
                                      "(the flash kernel's bias, ROADMAP "
                                      "T1)")
        return flash_attention(query, key, value, causal=is_causal,
                               scale=scale, kv_lens=kv_lens)
    if attn_mask is None and kv_lens is not None:
        sk = key.shape[1]
        keep = (torch.arange(sk, device=key.device)[None, :]
                < kv_lens.to(key.device).long()[:, None])
        attn_mask = torch.where(keep, 0.0, -1e30)[:, None, None, :]
    return attention_reference(query, key, value, mask=attn_mask,
                               is_causal=is_causal, scale=scale)
