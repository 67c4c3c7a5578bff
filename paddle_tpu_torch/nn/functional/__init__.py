"""Functionals of the port (counterpart of ``paddle_tpu/nn/functional``)."""

from paddle_tpu_torch.nn.functional.activation import gelu, relu  # noqa: F401
from paddle_tpu_torch.nn.functional.attention import (  # noqa: F401
    attention_reference, scaled_dot_product_attention)
from paddle_tpu_torch.nn.functional.common import dropout, linear  # noqa: F401

__all__ = ["attention_reference", "scaled_dot_product_attention",
           "dropout", "linear", "relu", "gelu"]
