"""Gradient clipping (counterpart of ``paddle_tpu/optimizer/clip.py``):
functions of a name -> gradient dict that return a new dict (the
gradients themselves are not changed).

- ``ClipGradByValue``: each entry clamped to [min, max];
- ``ClipGradByNorm``: each entry scaled to an L2 norm of at most
  ``clip_norm`` (a stacked (L, ...) slab is one entry, as the JAX
  stacked leaf is);
- ``ClipGradByGlobalNorm``: every entry scaled by
  ``min(1, clip_norm / max(norm, 1e-12))``, the norm taken over all of
  them with an fp32 sum of squares. ``last_norm`` keeps the norm of the
  latest call (a 0-dim fp32 tensor on the gradients' device: reading it
  is the caller's choice, the clip never waits for the device).
"""

from typing import Dict

import torch

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]


class ClipGradByValue:
    def __init__(self, max, min=None):  # noqa: A002
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, grads: Dict[str, torch.Tensor]):
        return {n: torch.clamp(g, self.min, self.max)
                for n, g in grads.items()}


class ClipGradByNorm:
    """Per-entry norm clip."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, grads: Dict[str, torch.Tensor]):
        def clip(g):
            n = torch.sqrt(torch.sum(torch.square(g)))
            return g * torch.clamp(self.clip_norm / torch.clamp(n, min=1e-12),
                                   max=1.0)
        return {n: clip(g) for n, g in grads.items()}


class ClipGradByGlobalNorm:
    """Global-norm clip over every entry."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = clip_norm
        self.last_norm = None

    def global_norm(self, grads: Dict[str, torch.Tensor]):
        total = 0
        for g in grads.values():
            total = total + torch.sum(torch.square(g.float()))
        return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))

    def __call__(self, grads: Dict[str, torch.Tensor]):
        norm = self.global_norm(grads)
        self.last_norm = norm
        scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                            max=1.0)
        return {n: (g * scale).to(g.dtype) for n, g in grads.items()}
