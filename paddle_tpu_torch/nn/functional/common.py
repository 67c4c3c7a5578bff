"""Common functionals: ``linear`` and ``dropout`` (counterpart of
``paddle_tpu/nn/functional/common.py``, cut to what the incubate
encoder path uses).

``linear`` keeps the JAX (in, out) weight layout (``x @ w + b``); an int8
``QuantTensor`` weight runs the int8 matmul (K12 on the card) through
its ``__rmatmul__``. ``dropout`` draws its Bernoulli mask from an
explicit ``torch.Generator`` where the JAX package folds a context key
(``fold_ctx_key``): no context RNG is ported, so the masks differ from
the JAX function's (``paddle_tpu_torch.random`` reproduces
``jax.random``'s bits for a given key; the GPT's residual dropout draws
from it).
"""

from typing import Optional

import torch

from paddle_tpu_torch.amp.auto_cast import amp_cast

__all__ = ["linear", "dropout"]


def linear(x, weight, bias=None):
    """``x @ weight (+ bias)`` with ``weight`` (in, out), as the JAX
    ``linear``; an int8 ``QuantTensor`` weight takes K12's wrapper.
    Inside an ``amp.auto_cast`` region (O1) the floating operands are
    cast to the amp dtype (``linear`` is on the white list)."""
    # a QuantTensor is no torch.Tensor: amp_cast leaves it to K12
    out = amp_cast(x) @ amp_cast(weight)
    if bias is not None:
        out = out + amp_cast(bias)
    return out


def dropout(x, p: float = 0.5, axis=None, training: bool = True,
            mode: str = "upscale_in_train",
            generator: Optional[torch.Generator] = None):
    """Paddle's dropout: in training, zero each element with probability
    ``p`` (one draw per index of ``axis`` when given, broadcast over the
    other dims) and, with ``upscale_in_train``, divide the kept ones by
    1 - p; ``downscale_in_infer`` keeps them as they are in training and
    multiplies by 1 - p in eval. The mask comes from ``generator`` (on
    x's device; None is torch's default generator)."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"unknown dropout mode {mode!r}")
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"dropout p must be in [0, 1], got {p}")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    shape = list(x.shape)
    if axis is not None:
        axes = {a % x.dim() for a in ((axis,) if isinstance(axis, int)
                                      else axis)}
        shape = [s if i in axes else 1 for i, s in enumerate(x.shape)]
    keep = torch.rand(shape, generator=generator, device=x.device) >= p
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
    return torch.where(keep, x, 0.0).to(x.dtype)
