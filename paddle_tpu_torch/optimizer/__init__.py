"""Optimizers of the port (counterpart of ``paddle_tpu/optimizer``, cut
to the Adam family the GPT train step uses)."""

from paddle_tpu_torch.optimizer.optimizer import Adam, AdamW  # noqa: F401

__all__ = ["Adam", "AdamW"]
