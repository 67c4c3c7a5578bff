"""Layers and functionals of the port (counterpart of
``paddle_tpu/nn``): the attention, dropout, linear and activation
functionals, and the layers the incubate encoder path uses
(``Linear``, ``Dropout``, ``LayerNorm``, ``MultiHeadAttention``,
``TransformerEncoderLayer``, ``TransformerEncoder``)."""

from paddle_tpu_torch.nn.layer.common import Dropout, Linear  # noqa: F401
from paddle_tpu_torch.nn.layer.norm import LayerNorm  # noqa: F401
from paddle_tpu_torch.nn.layer.transformer import (  # noqa: F401
    MultiHeadAttention, TransformerEncoder, TransformerEncoderLayer)

__all__ = ["Linear", "Dropout", "LayerNorm", "MultiHeadAttention",
           "TransformerEncoderLayer", "TransformerEncoder"]
