"""Dynamic loss scaling (counterpart of ``paddle_tpu/amp/grad_scaler.py``;
not ``torch.cuda.amp.GradScaler``).

Functional: ``init_state`` -> ``{"scale", "good", "bad"}`` (0-dim fp32
and int32 tensors), ``scale_loss``, ``unscale_and_check`` -> (grads /
scale, found_inf) and ``update_state`` compose into a train step without
a host round trip; ``apply_or_skip`` keeps the old values where a step
found an inf. The eager API (``scale``, ``unscale_``, ``update``) keeps
the same state on the object.
"""

from typing import Dict

import torch

__all__ = ["GradScaler"]


def _state(scale, good, bad, device=None):
    return {"scale": torch.as_tensor(scale, dtype=torch.float32,
                                     device=device),
            "good": torch.as_tensor(good, dtype=torch.int32, device=device),
            "bad": torch.as_tensor(bad, dtype=torch.int32, device=device)}


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self.enable = enable
        self.init_loss_scaling = init_loss_scaling
        self.incr_ratio = incr_ratio
        self.decr_ratio = decr_ratio
        self.incr_every_n_steps = incr_every_n_steps
        self.decr_every_n = decr_every_n_nan_or_inf
        self.use_dynamic = use_dynamic_loss_scaling
        self._eager = self.init_state()
        self._found = torch.zeros((), dtype=torch.bool)

    # -- functional API ----------------------------------------------------
    def init_state(self, device=None):
        return _state(self.init_loss_scaling, 0, 0, device)

    def scale_loss(self, loss, state):
        if not self.enable:
            return loss
        return loss * state["scale"].to(loss.device)

    def unscale_and_check(self, grads: Dict[str, torch.Tensor], state):
        """Returns (unscaled grads, found_inf: a 0-dim bool tensor)."""
        if not self.enable:
            return grads, torch.zeros((), dtype=torch.bool)
        inv = 1.0 / state["scale"]
        grads = {n: g * inv.to(g.device) for n, g in grads.items()}
        found = None
        for g in grads.values():
            bad = ~torch.isfinite(g).all()
            found = bad if found is None else found | bad.to(found.device)
        if found is None:
            found = torch.zeros((), dtype=torch.bool)
        return grads, found

    def update_state(self, state, found_inf):
        if not self.enable or not self.use_dynamic:
            return state
        dev = found_inf.device
        scale, good, bad = (state[k].to(dev) for k in ("scale", "good",
                                                       "bad"))
        good = torch.where(found_inf, torch.zeros_like(good), good + 1)
        bad = torch.where(found_inf, bad + 1, torch.zeros_like(bad))
        scale = torch.where(found_inf & (bad >= self.decr_every_n),
                            torch.clamp(scale * self.decr_ratio, min=1.0),
                            scale)
        bad = torch.where(bad >= self.decr_every_n, torch.zeros_like(bad),
                          bad)
        scale = torch.where(~found_inf & (good >= self.incr_every_n_steps),
                            scale * self.incr_ratio, scale)
        good = torch.where(good >= self.incr_every_n_steps,
                           torch.zeros_like(good), good)
        return {"scale": scale, "good": good, "bad": bad}

    def apply_or_skip(self, new_params, new_opt_state, params, opt_state,
                      found_inf):
        """The new values, or the old ones where ``found_inf``: every
        tensor leaf of the two trees selected on the device."""
        def sel(new, old):
            if isinstance(new, torch.Tensor):
                return torch.where(found_inf.to(new.device), old, new)
            if isinstance(new, dict):
                return {k: sel(new[k], old[k]) for k in new}
            if isinstance(new, (tuple, list)):
                return type(new)(sel(a, b) for a, b in zip(new, old))
            return new
        return sel(new_params, params), sel(new_opt_state, opt_state)

    # -- eager-style parity API --------------------------------------------
    def scale(self, loss):
        return self.scale_loss(loss, self._eager)

    def unscale_(self, grads):
        grads, self._found = self.unscale_and_check(grads, self._eager)
        return grads

    def update(self):
        self._eager = self.update_state(self._eager, self._found)

    def is_enable(self):
        return self.enable

    def get_loss_scaling(self):
        return float(self._eager["scale"])

    def state_dict(self):
        return dict(self._eager)

    def load_state_dict(self, d):
        self._eager = _state(d["scale"], d["good"], d["bad"])
