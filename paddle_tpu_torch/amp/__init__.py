"""Automatic mixed precision (counterpart of ``paddle_tpu/amp``): the O1
region (``auto_cast``), the O2 cast (``decorate``) and the functional
loss scaler (``GradScaler``)."""

from paddle_tpu_torch.amp.auto_cast import (  # noqa: F401
    amp_cast, amp_guard, auto_cast, autocast, black_list, cast_model_to,
    decorate, get_amp_dtype, white_list)
from paddle_tpu_torch.amp.grad_scaler import GradScaler  # noqa: F401

__all__ = ["auto_cast", "autocast", "decorate", "GradScaler", "amp_guard",
           "amp_cast", "white_list", "black_list", "get_amp_dtype",
           "cast_model_to"]
