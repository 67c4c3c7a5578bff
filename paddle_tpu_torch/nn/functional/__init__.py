"""Functionals of the port (counterpart of ``paddle_tpu/nn/functional``)."""

from paddle_tpu_torch.nn.functional.activation import gelu, relu  # noqa: F401
from paddle_tpu_torch.nn.functional.attention import (  # noqa: F401
    attention_reference, scaled_dot_product_attention)
from paddle_tpu_torch.nn.functional.common import (  # noqa: F401
    alpha_dropout, dropout, dropout2d, dropout3d, fold_ctx_key, linear)
from paddle_tpu_torch.nn.functional.loss import cross_entropy  # noqa: F401

__all__ = ["attention_reference", "scaled_dot_product_attention",
           "dropout", "dropout2d", "dropout3d", "alpha_dropout",
           "fold_ctx_key", "linear", "relu", "gelu", "cross_entropy"]
