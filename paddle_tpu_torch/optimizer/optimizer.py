"""Adam and AdamW over a flat name -> tensor dict (counterpart of
``paddle_tpu/optimizer/optimizer.py``, cut to what the GPT train step
uses).

The update is the JAX package's, operation for operation, in fp32:

    m = b1 * m + (1 - b1) * g            v = b2 * v + (1 - b2) * g**2
    m_hat = m / (1 - b1**t)              v_hat = v / (1 - b2**t)
    p' = p - lr * m_hat / (sqrt(v_hat) + eps)
    p' = p' - lr * (wd * p)              (AdamW; p is the OLD fp32 param)

then p' is cast back to the parameter's dtype and m, v to
``moment_dtype``. There is no fp32 master copy: a bf16 parameter is
read, updated in fp32 and rounded back each step, as in the JAX package.
With no ``apply_decay_param_fun`` AdamW decays every parameter, LayerNorm
scales and biases included; with one, only the names it accepts.

``torch.optim.AdamW`` is a different function (it decays before the Adam
step and keeps bf16 moments in bf16 arithmetic), so it is not used.

State has the JAX structure, ``{"step": int, "slots": {name: (m, v)}}``.
``update`` works in place: it writes the new values into the given
parameter and moment tensors and returns the same dict objects. Only a
constant float learning rate is ported; a schedule and ``grad_clip``
raise ``NotImplementedError`` (ROADMAP T3).
"""

from typing import Callable, Dict, Optional

import torch

from paddle_tpu_torch import dtypes

__all__ = ["Adam", "AdamW"]


def _f32(x: float) -> float:
    """``x`` rounded to float32 (the JAX package's scalars are fp32)."""
    return torch.tensor(x, dtype=torch.float32).item()


class Adam:
    """Adam with fp32 update arithmetic and ``moment_dtype`` storage for
    the m/v slots (bf16 halves the optimizer memory)."""

    # AdamW decays the parameter; Adam adds an L2 term to the gradient
    _decoupled_wd = False

    def __init__(self, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 moment_dtype=torch.float32, weight_decay: float = 0.0,
                 grad_clip=None):
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "learning-rate schedules are not ported yet (ROADMAP T3); "
                "pass a constant float")
        if grad_clip is not None:
            raise NotImplementedError("grad_clip is not ported yet "
                                      "(ROADMAP T3)")
        if not isinstance(weight_decay, (int, float)):
            raise NotImplementedError("regularizer objects as weight_decay "
                                      "are not ported yet (ROADMAP T3)")
        self.learning_rate = float(learning_rate)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.moment_dtype = dtypes.to_dtype(moment_dtype)
        self.weight_decay = float(weight_decay or 0.0)

    def init(self, params: Dict[str, torch.Tensor]):
        slots = {n: (torch.zeros_like(p, dtype=self.moment_dtype),
                     torch.zeros_like(p, dtype=self.moment_dtype))
                 for n, p in params.items()}
        return {"step": 0, "slots": slots}

    def _decays(self, name: str) -> bool:
        """Whether the decoupled (AdamW) decay applies to ``name``."""
        return False

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state,
               params: Dict[str, torch.Tensor]):
        """One step over every entry of ``params``; returns
        ``(params, state)`` (the same tensors, updated in place)."""
        missing = sorted(set(params) - set(grads))
        if missing:
            raise KeyError(f"no gradient for {missing}")
        step = state["step"] + 1
        t = torch.tensor(float(step), dtype=torch.float32)
        bc1 = (1 - torch.tensor(self.beta1, dtype=torch.float32) ** t).item()
        bc2 = (1 - torch.tensor(self.beta2, dtype=torch.float32) ** t).item()
        lr = _f32(self.learning_rate)
        for name, p in params.items():
            m, v = state["slots"][name]
            g = grads[name]
            if self.weight_decay and not self._decoupled_wd:
                # L2 term in the parameter dtype, as the JAX package adds it
                g = g + self.weight_decay * p
            g = g.float()
            self._update_one(p, g, m, v, lr, bc1, bc2, self._decays(name))
        state = {"step": step, "slots": state["slots"]}
        return params, state

    def _update_one(self, p, g, m, v, lr, bc1, bc2, decay):
        b1, b2 = self.beta1, self.beta2
        p32 = p.float()
        m32 = b1 * m.float() + (1 - b1) * g
        v32 = b2 * v.float() + (1 - b2) * torch.square(g)
        m_hat = m32 / bc1
        v_hat = v32 / bc2
        new = p32 - lr * m_hat / (torch.sqrt(v_hat) + self.epsilon)
        if decay:
            new = new - lr * (self.weight_decay * p32)
        p.copy_(new)
        m.copy_(m32)
        v.copy_(v32)


class AdamW(Adam):
    """Adam with decoupled weight decay (paddle.optimizer.AdamW):
    ``apply_decay_param_fun(name) -> bool`` picks the decayed entries;
    None decays them all."""

    _decoupled_wd = True

    def __init__(self, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 weight_decay: float = 0.01,
                 apply_decay_param_fun: Optional[Callable[[str], bool]] =
                 None, moment_dtype=torch.float32, grad_clip=None):
        super().__init__(learning_rate, beta1, beta2, epsilon,
                         moment_dtype=moment_dtype,
                         weight_decay=weight_decay, grad_clip=grad_clip)
        self.apply_decay_param_fun = apply_decay_param_fun

    def _decays(self, name: str) -> bool:
        if not self.weight_decay:
            return False
        fn = self.apply_decay_param_fun
        return fn is None or bool(fn(name))
