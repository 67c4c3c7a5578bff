"""Optimizers of the port (counterpart of ``paddle_tpu/optimizer``): the
ten optimizers, the learning-rate schedules (``lr``) and the gradient
clips."""

from paddle_tpu_torch.optimizer import lr  # noqa: F401
from paddle_tpu_torch.optimizer.clip import (  # noqa: F401
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue)
from paddle_tpu_torch.optimizer.optimizer import (  # noqa: F401
    SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb, Lars, Momentum,
    Optimizer, RMSProp)

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "Lars", "lr",
           "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]
