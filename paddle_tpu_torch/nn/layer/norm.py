"""``LayerNorm`` (counterpart of ``paddle_tpu/nn/layer/norm.py``, cut to
what the transformer layers use). The JAX functional's arithmetic:
mean and population variance over the normalized dims, in x's dtype."""

import torch
from torch import nn

from paddle_tpu_torch import device as device_lib
from paddle_tpu_torch import dtypes

__all__ = ["LayerNorm", "layer_norm"]


def layer_norm(x, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5):
    """The JAX ``F.layer_norm``: statistics over the last
    ``len(normalized_shape)`` dims, in x's dtype."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    dims = tuple(range(x.dim() - len(normalized_shape), x.dim()))
    mean = x.mean(dim=dims, keepdim=True)
    var = torch.square(x - mean).mean(dim=dims, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


class LayerNorm(nn.Module):
    """weight ones, bias zeros (``weight_attr`` / ``bias_attr`` False
    drops them), on an explicit ``device`` (None: CUDA, raising without
    one)."""

    def __init__(self, normalized_shape, epsilon: float = 1e-5,
                 weight_attr=None, bias_attr=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        dev = device_lib.resolve(device)
        dt = dtypes.to_dtype(dtype)
        self.weight = (None if weight_attr is False else nn.Parameter(
            torch.ones(self.normalized_shape, device=dev, dtype=dt)))
        self.bias = (None if bias_attr is False else nn.Parameter(
            torch.zeros(self.normalized_shape, device=dev, dtype=dt)))

    def forward(self, x):
        return layer_norm(x, self.normalized_shape, self.weight, self.bias,
                          self.epsilon)
