"""incubate.optimizer (counterpart of ``paddle_tpu/incubate/optimizer.py``):
``LookAhead`` and ``ModelAverage``.

The state is explicit, as in the JAX package; the step counters are
Python ints, so each decision (sync, rotate) is taken on the host and
the tensors are written in place (``LookAhead``) or built anew
(``ModelAverage``), never selected on the device.
"""

from typing import Dict

import torch

__all__ = ["LookAhead", "ModelAverage"]


class LookAhead:
    """Slow/fast two-timescale wrapper: every ``k`` inner steps, slow +=
    alpha * (fast - slow) and fast = slow. Other attributes are the
    inner optimizer's."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        self.inner = inner_optimizer
        self.alpha = alpha
        self.k = k

    def init(self, params: Dict[str, torch.Tensor]):
        return {"inner": self.inner.init(params),
                "slow": {n: p.detach().clone() for n, p in params.items()},
                "step": 0}

    @torch.no_grad()
    def update(self, grads, state, params):
        fast, inner_state = self.inner.update(grads, state["inner"], params)
        step = state["step"] + 1
        if step % self.k == 0:
            for n, slow in state["slow"].items():
                slow.copy_(slow + self.alpha * (fast[n] - slow))
                fast[n].copy_(slow)
        return fast, {"inner": inner_state, "slow": state["slow"],
                      "step": step}

    def __getattr__(self, name):
        return getattr(self.inner, name)


class ModelAverage:
    """Parameter averaging over a sliding window: ``accumulate`` sums the
    parameters each step into a current block and rotates it into the
    previous block when it fills (the window is ``clip(rate * updates,
    min_average_window, max_average_window)``); ``apply`` returns the
    average over both blocks (between W and 2W recent steps),
    ``restore`` hands back the live weights."""

    def __init__(self, average_window_rate=0.15, parameters=None,
                 min_average_window=2, max_average_window=10000):
        self.rate = average_window_rate
        self.min_w = min_average_window
        self.max_w = max_average_window

    def init(self, params: Dict[str, torch.Tensor]):
        return {"sum_cur": {n: torch.zeros_like(p)
                            for n, p in params.items()},
                "sum_prev": {n: torch.zeros_like(p)
                             for n, p in params.items()},
                "n_cur": 0, "n_prev": 0, "total": 0}

    def _window(self, total: int) -> int:
        # fp32 product truncated to int32, as the JAX state computes it
        w = int((torch.tensor(self.rate, dtype=torch.float32)
                 * float(total)).to(torch.int32))
        return min(max(w, self.min_w), self.max_w)

    @torch.no_grad()
    def accumulate(self, state, params):
        total = state["total"] + 1
        rotate = state["n_cur"] >= self._window(total)
        if rotate:
            return {"sum_cur": {n: p.detach().clone()
                                for n, p in params.items()},
                    "sum_prev": state["sum_cur"], "n_cur": 1,
                    "n_prev": state["n_cur"], "total": total}
        return {"sum_cur": {n: s + params[n]
                            for n, s in state["sum_cur"].items()},
                "sum_prev": state["sum_prev"],
                "n_cur": state["n_cur"] + 1, "n_prev": state["n_prev"],
                "total": total}

    def apply(self, state, params):
        """The averaged parameters (the live ones come back from
        ``restore``)."""
        n = float(max(state["n_cur"] + state["n_prev"], 1))
        return {k: (a + state["sum_prev"][k]) / n
                for k, a in state["sum_cur"].items()}

    def restore(self, params):
        return params
