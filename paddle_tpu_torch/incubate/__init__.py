"""incubate (counterpart of ``paddle_tpu/incubate``): the fused
transformer layers and functionals of ``incubate.nn``, the MoE FFN of
``incubate.moe``, and ``LookAhead`` / ``ModelAverage`` of
``incubate.optimizer``."""

from paddle_tpu_torch.incubate import moe  # noqa: F401
from paddle_tpu_torch.incubate.moe import MoELayer  # noqa: F401
from paddle_tpu_torch.incubate import optimizer  # noqa: F401
from paddle_tpu_torch.incubate.optimizer import (  # noqa: F401
    LookAhead, ModelAverage)

__all__ = ["moe", "MoELayer", "optimizer", "LookAhead", "ModelAverage"]
