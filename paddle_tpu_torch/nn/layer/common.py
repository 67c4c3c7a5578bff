"""``Linear`` and the dropout layers (counterpart of
``paddle_tpu/nn/layer/common.py``, cut to these).

Every layer of the port is a ``torch.nn.Module`` built on an explicit
``device`` (None: the current CUDA device, which raises without one, as
the port's other entry points do) and ``dtype``. ``Linear`` draws its
initial weights from an explicit ``generator`` (None: torch's default
generator of that device type). ``Dropout``, ``Dropout2D``,
``Dropout3D`` and ``AlphaDropout`` are the JAX layers: in training (an
active ``nn.stateful`` context's flag, else ``self.training``) their
masks come from the context's keys (``F.fold_ctx_key``), the bits the
JAX layers draw. The weights keep the JAX layout, (in, out), so the JAX
``state_dict`` loads without transposes (``models/convert.py``).
Initializer objects (``weight_attr``) are not ported; ``bias_attr=False``
drops the bias.
"""

import math
from typing import Optional

import torch
from torch import nn

from paddle_tpu_torch import device as device_lib
from paddle_tpu_torch import dtypes
from paddle_tpu_torch.nn.functional import common as F
from paddle_tpu_torch.nn.module import is_training

__all__ = ["Linear", "Dropout", "Dropout2D", "Dropout3D",
           "AlphaDropout"]


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
    """``F.dropout`` with ``p``, ``axis`` and ``mode``; training as the
    context says, else ``self.training``; the mask from the context's
    key (``F.fold_ctx_key``)."""

    def __init__(self, p: float = 0.5, axis=None,
                 mode: str = "upscale_in_train", name=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis,
                         training=is_training(self.training),
                         mode=self.mode)


class Dropout2D(nn.Module):
    """``F.dropout2d``: one draw per (N, C)."""

    def __init__(self, p: float = 0.5, data_format: str = "NCHW",
                 name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, training=is_training(self.training),
                           data_format=self.data_format)


class Dropout3D(nn.Module):
    """``F.dropout3d``: one draw per (N, C)."""

    def __init__(self, p: float = 0.5, data_format: str = "NCDHW",
                 name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, training=is_training(self.training),
                           data_format=self.data_format)


class AlphaDropout(nn.Module):
    """``F.alpha_dropout``."""

    def __init__(self, p: float = 0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p,
                               training=is_training(self.training))
