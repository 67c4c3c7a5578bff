"""Layers and functionals of the port (counterpart of
``paddle_tpu/nn``): the attention, dropout, linear, activation and loss
functionals, the execution context (``stateful``, ``is_training``,
``nn.module``), and the layers the encoder paths use (``Linear``, the
dropouts, ``LayerNorm``, ``MultiHeadAttention``,
``TransformerEncoderLayer``, ``TransformerEncoder``)."""

from paddle_tpu_torch.nn.layer.common import (  # noqa: F401
    AlphaDropout, Dropout, Dropout2D, Dropout3D, Linear)
from paddle_tpu_torch.nn.layer.norm import LayerNorm  # noqa: F401
from paddle_tpu_torch.nn.layer.transformer import (  # noqa: F401
    MultiHeadAttention, TransformerEncoder, TransformerEncoderLayer)
from paddle_tpu_torch.nn.module import (  # noqa: F401
    Context, current_context, is_training, stateful)

__all__ = ["Linear", "Dropout", "Dropout2D", "Dropout3D", "AlphaDropout",
           "LayerNorm", "MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "Context", "current_context",
           "is_training", "stateful"]
