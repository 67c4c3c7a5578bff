"""Common functionals: ``linear``, ``fold_ctx_key`` and the dropouts
(counterpart of ``paddle_tpu/nn/functional/common.py``, cut to these).

``linear`` keeps the JAX (in, out) weight layout (``x @ w + b``); an int8
``QuantTensor`` weight runs the int8 matmul (K12 on the card) through
its ``__rmatmul__``. The dropouts draw their masks as the JAX ones do:
``bernoulli(fold_ctx_key(key=key), 1 - p, shape)`` through
``paddle_tpu_torch.random``, the same bits as ``jax.random``, on x's
device. ``fold_ctx_key`` takes the given key, else the active
``nn.stateful`` context's next key, else the global stream's next key.
``training=None`` resolves through ``nn.module.is_training``.
"""

import torch

from paddle_tpu_torch import random as prng
from paddle_tpu_torch.amp.auto_cast import amp_cast
from paddle_tpu_torch.nn.module import current_context, is_training

__all__ = ["linear", "fold_ctx_key", "dropout", "dropout2d", "dropout3d",
           "alpha_dropout"]

# SELU's constants (JAX common.py:80-82)
_SELU_ALPHA = 1.6732632423543772
_SELU_SCALE = 1.0507009873554805


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


def fold_ctx_key(salt: int = 0, key=None) -> torch.Tensor:
    """``key`` when given; else the context's ``next_key(salt)``; else
    the global stream's next key."""
    if key is not None:
        return key
    ctx = current_context()
    if ctx is not None:
        return ctx.next_key(salt)
    return prng.next_key()


def dropout(x, p: float = 0.5, axis=None, training=None,
            mode: str = "upscale_in_train", key=None):
    """Paddle's dropout: in training, zero each element with probability
    ``p`` (one draw per index of ``axis`` when given, broadcast over the
    other dims) and, with ``upscale_in_train``, divide the kept ones by
    1 - p; ``downscale_in_infer`` keeps them as they are in training and
    multiplies by 1 - p in eval."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"unknown dropout mode {mode!r}")
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"dropout p must be in [0, 1], got {p}")
    if training is None:
        training = is_training()
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    k = fold_ctx_key(key=key)
    shape = list(x.shape)
    if axis is not None:
        axes = {a % x.dim() for a in ((axis,) if isinstance(axis, int)
                                      else axis)}
        shape = [s if i in axes else 1 for i, s in enumerate(x.shape)]
    keep = prng.bernoulli(k, 1.0 - p, shape, device=x.device)
    if mode == "upscale_in_train":
        # JAX divides by the weakly typed 1 - p in x's dtype
        scale = torch.tensor(1.0 - p, dtype=x.dtype, device=x.device)
        return torch.where(keep, x / scale, 0.0).to(x.dtype)
    return torch.where(keep, x, 0.0).to(x.dtype)


def dropout2d(x, p: float = 0.5, training=None, data_format: str = "NCHW",
              key=None):
    """Whole channels dropped: one draw per (N, C)."""
    axis = (0, 1) if data_format == "NCHW" else (0, 3)
    return dropout(x, p, axis=axis, training=training, key=key)


def dropout3d(x, p: float = 0.5, training=None,
              data_format: str = "NCDHW", key=None):
    """Whole channels dropped: one draw per (N, C)."""
    axis = (0, 1) if data_format == "NCDHW" else (0, 4)
    return dropout(x, p, axis=axis, training=training, key=key)


def alpha_dropout(x, p: float = 0.5, training=None, key=None):
    """SELU-preserving dropout: dropped cells take SELU's negative
    saturation, then an affine map keeps the mean and variance."""
    if training is None:
        training = is_training()
    if not training or p == 0.0:
        return x
    alpha_p = -_SELU_ALPHA * _SELU_SCALE
    keep = prng.bernoulli(fold_ctx_key(key=key), 1.0 - p, x.shape,
                          device=x.device)
    a = (1.0 - p + p * alpha_p ** 2) ** -0.5
    b = -a * alpha_p * p
    return a * torch.where(keep, x, alpha_p) + b
