"""Loss functionals (counterpart of ``cross_entropy`` in
``paddle_tpu/nn/functional/loss.py``).

Plain torch, as XLA does this work in the JAX package: the same
operations in the same order (log-softmax over ``axis``, the picked or
soft-label sum, label smoothing, the class weights, the valid-count
mean), in the input's dtype.
"""

import torch

__all__ = ["cross_entropy"]


def _reduce(loss, reduction: str):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def cross_entropy(input, label, weight=None,  # noqa: A002
                  ignore_index: int = -100, reduction: str = "mean",
                  soft_label: bool = False, axis: int = -1,
                  use_softmax: bool = True,
                  label_smoothing: float = 0.0):
    """Softmax cross-entropy of ``input`` (logits, or probabilities with
    ``use_softmax=False``) against hard labels (int, ``ignore_index``
    entries count nothing; a trailing size-1 ``axis`` is squeezed) or
    ``soft_label`` distributions. ``weight`` (C,) weighs each label's
    loss, and the mean is then over the valid labels' weights; without
    it the mean is over the valid labels (at least 1)."""
    x = input
    axis = axis % x.dim()
    logp = (torch.log_softmax(x, dim=axis) if use_softmax
            else torch.log(x))
    if soft_label:
        target = label
        if label_smoothing > 0:
            n = x.shape[axis]
            target = (1 - label_smoothing) * target + label_smoothing / n
        return _reduce(-(target * logp).sum(axis), reduction)
    lab = label
    if lab.dim() == x.dim():
        lab = lab.squeeze(axis)
    lab = lab.to(torch.int64)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, 0)
    picked = logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    if label_smoothing > 0:
        smooth = logp.mean(axis)
        loss = -((1 - label_smoothing) * picked + label_smoothing * smooth)
    else:
        loss = -picked
    zero = torch.zeros((), dtype=loss.dtype, device=loss.device)
    if weight is not None:
        w = weight.to(loss.device)[safe]
        loss = torch.where(valid, loss * w, zero)
        if reduction == "mean":
            return loss.sum() / torch.clamp(
                torch.where(valid, w, 0.0).sum(), min=1e-12)
    else:
        loss = torch.where(valid, loss, zero)
        if reduction == "mean":
            return loss.sum() / torch.clamp(valid.to(loss.dtype).sum(),
                                            min=1.0)
    return _reduce(loss, reduction)
