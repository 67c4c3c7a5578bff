"""Weight-decay regularizers (counterpart of ``paddle_tpu/regularizer.py``).

A regularizer is ``grad' = grad + d(penalty)/d(param)``: pass one as
``weight_decay=`` to an optimizer. Adam and the others add it to the
gradient (in the parameter's dtype) before the update; AdamW subtracts
``lr * reg(0, p)`` from the parameter (decoupled). A float keeps
meaning plain L2.
"""

import torch

__all__ = ["L1Decay", "L2Decay"]


class _Regularizer:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __call__(self, grad, param):
        raise NotImplementedError


class L1Decay(_Regularizer):
    """grad + coeff * sign(param)."""

    def __call__(self, grad, param):
        return grad + self.coeff * torch.sign(param)


class L2Decay(_Regularizer):
    """grad + coeff * param."""

    def __call__(self, grad, param):
        return grad + self.coeff * param
