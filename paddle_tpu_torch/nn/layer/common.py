"""``Linear`` and ``Dropout`` (counterpart of
``paddle_tpu/nn/layer/common.py``, cut to what the transformer layers
use).

Every layer of the port is a ``torch.nn.Module`` built on an explicit
``device`` (None: the current CUDA device, which raises without one, as
the port's other entry points do) and ``dtype``, and draws from an
explicit ``generator`` (None: torch's default generator of that device
type): ``Linear`` its initial weights, ``Dropout`` its masks. The
weights keep the JAX layout, (in, out), so the JAX ``state_dict`` loads
without transposes (``models/convert.py``). Initializer objects
(``weight_attr``) are not ported; ``bias_attr=False`` drops the bias.
"""

import math
from typing import Optional

import torch
from torch import nn

from paddle_tpu_torch import device as device_lib
from paddle_tpu_torch import dtypes
from paddle_tpu_torch.nn.functional import common as F

__all__ = ["Linear", "Dropout"]


def _check_weight_attr(weight_attr):
    if weight_attr is not None:
        raise NotImplementedError("initializer objects (weight_attr) are "
                                  "not ported; load weights instead")


class Linear(nn.Module):
    """``x @ weight + bias``, weight (in_features, out_features), drawn
    Xavier-uniform (the JAX default initializer's law), bias zeros."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, bias_attr=None, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_weight_attr(weight_attr)
        dev = device_lib.resolve(device)
        dt = dtypes.to_dtype(dtype)
        self.in_features, self.out_features = in_features, out_features
        limit = math.sqrt(6.0 / (in_features + out_features))
        w = (torch.rand((in_features, out_features), generator=generator,
                        device=dev) * 2 - 1) * limit
        self.weight = nn.Parameter(w.to(dt))
        self.bias = (None if bias_attr is False else nn.Parameter(
            torch.zeros(out_features, device=dev, dtype=dt)))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Dropout(nn.Module):
    """``F.dropout`` in training mode (``self.training``), with masks
    from ``generator``."""

    def __init__(self, p: float = 0.5, axis=None,
                 mode: str = "upscale_in_train",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode, generator=self.generator)
