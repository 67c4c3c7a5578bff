"""Models of the port (counterpart of ``paddle_tpu/models``): the GPT
(``gpt``), the BERT encoder family (``bert``) and ERNIE 3.0
(``ernie``), and the weight conversion to and from the JAX package
(``convert``)."""

from paddle_tpu_torch.models import bert, convert, ernie, gpt  # noqa: F401

__all__ = ["bert", "convert", "ernie", "gpt"]
