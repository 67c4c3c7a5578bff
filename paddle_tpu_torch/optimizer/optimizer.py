"""The optimizers (counterpart of ``paddle_tpu/optimizer/optimizer.py``):
the ``Optimizer`` base and SGD, Momentum, Adam, AdamW, Adamax, Adagrad,
Adadelta, RMSProp, Lamb and Lars, over a flat name -> tensor dict.

Each update is the JAX package's, operation for operation:

- the step counter goes up by one and the learning rate is the
  schedule's ``value_at(step + 1)`` (or the float, in fp32);
- ``grad_clip`` (``optimizer.clip``) maps the gradients;
- an L2 term (a float ``weight_decay``: ``g + wd * p``; a regularizer:
  ``wd(g, p)``) joins them in the parameter's dtype, except for AdamW,
  whose decay is decoupled;
- ``update_param`` runs in fp32 on the parameter and gradient
  (``multi_precision``, the default; else in the parameter's dtype)
  and the results are rounded back into the parameter and the slots.

There is no fp32 master copy: a bf16 parameter is read, updated in fp32
and rounded back each step, as in the JAX package. Adam's update is

    m = b1 * m + (1 - b1) * g            v = b2 * v + (1 - b2) * g**2
    m_hat = m / (1 - b1**t)              v_hat = v / (1 - b2**t)
    p' = p - lr * m_hat / (sqrt(v_hat) + eps)

and AdamW's then subtracts ``lr * (wd * p)`` (p the old fp32 value),
or ``lr * wd(0, p)`` for a regularizer. With ``apply_decay_param_fun``
only the accepted names decay. An entry that folds several named
parameters into one tensor, such as a stacked (L, ...) slab, takes a
0/1 mask registered by ``set_decay_mask`` instead of the name
(``models.gpt.init_train_state`` resolves one per slab, and the GPT
step refuses a slab without one). Lamb's and Lars's norms are taken
over a whole entry, a slab included, as over the JAX stacked leaf.

``torch.optim`` is a different function (``AdamW`` decays before the
Adam step and keeps bf16 moments in bf16 arithmetic), so it is not used.

State has the JAX structure, ``{"step": int, "slots": {name: slot}}``,
a slot being ``()``, a tensor or a tuple of tensors as the JAX
``init_param`` returns. ``update`` works in place: it writes the new
values into the given parameter and slot tensors and returns the same
dicts. ``last_lr`` holds the learning rate of the latest update.
"""

import functools
from typing import Callable, Dict, Optional

import torch

from paddle_tpu_torch import dtypes
from paddle_tpu_torch.optimizer.lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "Lars"]


def _lr_value(lr, step) -> float:
    """The learning rate at ``step``, an fp32 value as a Python float."""
    if isinstance(lr, LRScheduler):
        return float(lr.value_at(step))
    return torch.tensor(lr, dtype=torch.float32).item()


@functools.lru_cache(maxsize=64)
def _bias_correction(beta: float, step: int) -> float:
    """``1 - beta ** step`` in fp32 (the JAX ``1 - b ** t``)."""
    return (1 - torch.tensor(beta, dtype=torch.float32)
            ** torch.tensor(float(step), dtype=torch.float32)).item()


def _slots_of(s):
    """A slot's tensors in order: () -> [], a tensor -> [it], a tuple ->
    its entries."""
    if isinstance(s, torch.Tensor):
        return [s]
    return list(s)


class Optimizer:
    """Functional optimizer base. Subclasses implement ``init_param``
    (the slot of one parameter) and ``update_param(p, g, s, lr, step)``
    -> (new p, new slot) on fp32 values."""

    # AdamW decays the parameter; the others add an L2 term to the
    # gradient
    _decoupled_wd = False

    def __init__(self, learning_rate=0.001, weight_decay=0.0,
                 grad_clip=None, parameters=None, multi_precision=True):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay or 0.0
        self.grad_clip = grad_clip
        self.multi_precision = multi_precision
        self.last_lr = None
        self._params = None
        self._state = None
        # bound on first use: a subclass's slots may need attributes its
        # __init__ sets after this one
        self._deferred_params = parameters

    def _ensure_bound(self):
        if self._deferred_params is not None:
            if self._params is None:
                self._params = self._deferred_params
            if self._state is None:
                # set_state_dict (a resume) may have run first: keep it
                self._state = self.init(self._params)
            self._deferred_params = None

    # -- functional API ----------------------------------------------------
    def init_param(self, p):
        return ()

    def update_param(self, p, g, s, lr, step):
        raise NotImplementedError

    def init(self, params: Dict[str, torch.Tensor]):
        return {"step": 0,
                "slots": {n: self.init_param(p) for n, p in params.items()}}

    def _prepare(self, grads, state, params):
        """The step, its learning rate and the clipped gradients."""
        missing = sorted(set(params) - set(grads))
        if missing:
            raise KeyError(f"no gradient for {missing}")
        step = state["step"] + 1
        lr = _lr_value(self.learning_rate, step)
        self.last_lr = lr
        if self.grad_clip is not None:
            grads = self.grad_clip({n: grads[n] for n in params})
        return step, lr, grads

    def _write(self, p, s, new_p, new_s):
        """The new values into the parameter and slot tensors."""
        p.copy_(new_p)
        for old, new in zip(_slots_of(s), _slots_of(new_s)):
            old.copy_(new)

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state,
               params: Dict[str, torch.Tensor]):
        """One step over every entry of ``params``; returns ``(params,
        state)`` (the same tensors, updated in place)."""
        step, lr, grads = self._prepare(grads, state, params)
        wd = self.weight_decay
        for name, p in params.items():
            g = grads[name]
            if wd and not self._decoupled_wd:
                # the L2 term in the parameter dtype, as the JAX package
                # adds it
                g = wd(g, p) if callable(wd) else g + wd * p
            s = state["slots"][name]
            if self.multi_precision:
                new_p, new_s = self.update_param(p.float(), g.float(), s,
                                                 lr, step)
            else:
                new_p, new_s = self.update_param(p, g, s, lr, step)
            self._write(p, s, new_p, new_s)
        return params, {"step": step, "slots": state["slots"]}

    # -- stateful convenience ----------------------------------------------
    def bind(self, params: Dict[str, torch.Tensor]):
        """Attach a parameter dict for paddle-style ``step()`` loops."""
        self._params = params
        self._state = self.init(params)
        return self

    def step(self, grads):
        self._ensure_bound()
        self._params, self._state = self.update(grads, self._state,
                                                self._params)
        return self._params

    @property
    def params(self):
        return self._params

    def clear_grad(self):
        """Drop the bound parameters' ``.grad`` (paddle's clear_grad)."""
        for p in (self._params or self._deferred_params or {}).values():
            p.grad = None

    def state_dict(self):
        self._ensure_bound()
        d = {"state": self._state} if self._state is not None else {}
        if isinstance(self.learning_rate, LRScheduler):
            d["lr"] = self.learning_rate.state_dict()
        return d

    def set_state_dict(self, d):
        if "state" in d:
            self._state = d["state"]
        if "lr" in d and isinstance(self.learning_rate, LRScheduler):
            self.learning_rate.set_state_dict(d["lr"])

    def get_lr(self):
        step = self._state["step"] if self._state is not None else 0
        return _lr_value(self.learning_rate, step)


def _zeros(p):
    return torch.zeros_like(p, dtype=torch.float32)


class SGD(Optimizer):
    def update_param(self, p, g, s, lr, step):
        return p - lr * g, s


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9,
                 use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self.momentum = momentum
        self.use_nesterov = use_nesterov

    def init_param(self, p):
        return _zeros(p)

    def update_param(self, p, g, v, lr, step):
        v = self.momentum * v + g
        if self.use_nesterov:
            return p - lr * (g + self.momentum * v), v
        return p - lr * v, v


class Adam(Optimizer):
    """Adam with fp32 update arithmetic and ``moment_dtype`` storage for
    the m/v slots (bf16 halves the optimizer memory)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, moment_dtype=torch.float32,
                 **kw):
        super().__init__(learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.moment_dtype = dtypes.to_dtype(moment_dtype)

    def init_param(self, p):
        return (torch.zeros_like(p, dtype=self.moment_dtype),
                torch.zeros_like(p, dtype=self.moment_dtype))

    def update_param(self, p, g, s, lr, step):
        m, v = s
        b1, b2 = self.beta1, self.beta2
        m32 = b1 * m.float() + (1 - b1) * g
        v32 = b2 * v.float() + (1 - b2) * torch.square(g)
        m_hat = m32 / _bias_correction(b1, step)
        v_hat = v32 / _bias_correction(b2, step)
        new = p - lr * m_hat / (torch.sqrt(v_hat) + self.epsilon)
        return new, (m32, v32)


class AdamW(Adam):
    """Adam with decoupled weight decay: ``apply_decay_param_fun(name) ->
    bool`` picks the decayed entries (None decays them all); an entry
    with a registered mask decays by the mask instead."""

    _decoupled_wd = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, weight_decay=0.01,
                 apply_decay_param_fun: Optional[Callable[[str], bool]] =
                 None, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon,
                         weight_decay=weight_decay, **kw)
        self.apply_decay_param_fun = apply_decay_param_fun
        self._decay_masks: Dict[str, torch.Tensor] = {}

    def set_decay_mask(self, entry: str, mask: torch.Tensor):
        """Register the 0/1 fp32 decay mask of ``params[entry]``, a
        (L, 1, ...) tensor broadcastable to the slab: row l says whether
        layer l's parameter decays."""
        self._decay_masks[entry] = mask

    def decay_mask(self, entry: str) -> Optional[torch.Tensor]:
        """The mask registered for ``entry``, or None."""
        return self._decay_masks.get(entry)

    def _decay_term(self, p32):
        wd = self.weight_decay
        if callable(wd):
            return wd(torch.zeros_like(p32), p32)
        return wd * p32

    @torch.no_grad()
    def update(self, grads, state, params):
        step, lr, grads = self._prepare(grads, state, params)
        fn = self.apply_decay_param_fun
        for name, p in params.items():
            s = state["slots"][name]
            p32 = p.float()
            new_p, new_s = Adam.update_param(self, p32, grads[name].float(),
                                             s, lr, step)
            if not self.weight_decay:
                pass
            elif fn is None:
                new_p = new_p - lr * self._decay_term(p32)
            elif name in self._decay_masks:
                new_p = new_p - lr * self._decay_term(p32) \
                    * self._decay_masks[name]
            elif fn(name):
                new_p = new_p - lr * self._decay_term(p32)
            self._write(p, s, new_p, new_s)
        return params, {"step": step, "slots": state["slots"]}


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_param(self, p):
        return (_zeros(p), _zeros(p))

    def update_param(self, p, g, s, lr, step):
        m, u = s
        b1 = self.beta1
        m = b1 * m + (1 - b1) * g
        u = torch.maximum(self.beta2 * u, torch.abs(g))
        # lr / (1 - b1 ** t) in fp32, as the JAX scalars divide
        rate = (torch.tensor(lr, dtype=torch.float32)
                / _bias_correction(b1, step)).item()
        return p - rate * m / (u + self.epsilon), (m, u)


class Adagrad(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6,
                 initial_accumulator_value=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self.epsilon = epsilon
        self.initial_accumulator_value = initial_accumulator_value

    def init_param(self, p):
        return torch.full_like(p, self.initial_accumulator_value,
                               dtype=torch.float32)

    def update_param(self, p, g, acc, lr, step):
        acc = acc + torch.square(g)
        return p - lr * g / (torch.sqrt(acc) + self.epsilon), acc


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95, **kw):
        super().__init__(learning_rate, **kw)
        self.epsilon, self.rho = epsilon, rho

    def init_param(self, p):
        return (_zeros(p), _zeros(p))

    def update_param(self, p, g, s, lr, step):
        acc_g, acc_dx = s
        rho, eps = self.rho, self.epsilon
        acc_g = rho * acc_g + (1 - rho) * torch.square(g)
        dx = torch.sqrt(acc_dx + eps) / torch.sqrt(acc_g + eps) * g
        acc_dx = rho * acc_dx + (1 - rho) * torch.square(dx)
        return p - lr * dx, (acc_g, acc_dx)


class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, rho=0.95, epsilon=1e-6,
                 momentum=0.0, centered=False, **kw):
        super().__init__(learning_rate, **kw)
        self.rho, self.epsilon = rho, epsilon
        self.momentum, self.centered = momentum, centered

    def init_param(self, p):
        return (_zeros(p), _zeros(p), _zeros(p))

    def update_param(self, p, g, s, lr, step):
        mean_sq, mean_g, mom = s
        rho = self.rho
        mean_sq = rho * mean_sq + (1 - rho) * torch.square(g)
        if self.centered:
            mean_g = rho * mean_g + (1 - rho) * g
            denom = torch.sqrt(mean_sq - torch.square(mean_g)
                               + self.epsilon)
        else:
            denom = torch.sqrt(mean_sq + self.epsilon)
        mom = self.momentum * mom + lr * g / denom
        return p - mom, (mean_sq, mean_g, mom)


def _trust(num, den, value):
    """``value`` where both norms are positive, else 1 (on the device)."""
    return torch.where((num > 0) & (den > 0), value,
                       torch.ones_like(value))


class Lamb(Optimizer):
    """Layer-adaptive Adam: the step scaled by ||p|| / ||r|| over each
    entry (a whole slab for a stacked entry)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6,
                 exclude_from_weight_decay_fn=None, **kw):
        super().__init__(learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lamb_weight_decay = lamb_weight_decay
        # kept for API parity; the JAX update does not read it either
        self.exclude_fn = exclude_from_weight_decay_fn

    def init_param(self, p):
        return (_zeros(p), _zeros(p))

    def update_param(self, p, g, s, lr, step):
        m, v = s
        b1, b2 = self.beta1, self.beta2
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        m_hat = m / _bias_correction(b1, step)
        v_hat = v / _bias_correction(b2, step)
        r = m_hat / (torch.sqrt(v_hat) + self.epsilon) \
            + self.lamb_weight_decay * p
        p_norm = torch.linalg.vector_norm(p)
        r_norm = torch.linalg.vector_norm(r)
        trust = _trust(p_norm, r_norm, p_norm / r_norm)
        return p - lr * trust * r, (m, v)


class Lars(Optimizer):
    """Layer-wise adaptive rate scaling with momentum, the local rate
    from the norms of each entry (a whole slab for a stacked entry)."""

    def __init__(self, learning_rate=0.001, momentum=0.9,
                 lars_coeff=0.001, lars_weight_decay=0.0005, **kw):
        super().__init__(learning_rate, **kw)
        self.momentum = momentum
        self.lars_coeff = lars_coeff
        self.lars_weight_decay = lars_weight_decay

    def init_param(self, p):
        return _zeros(p)

    def update_param(self, p, g, v, lr, step):
        p_norm = torch.linalg.vector_norm(p)
        g_norm = torch.linalg.vector_norm(g)
        local_lr = _trust(p_norm, g_norm, self.lars_coeff * p_norm / (
            g_norm + self.lars_weight_decay * p_norm))
        v = self.momentum * v + lr * local_lr * (
            g + self.lars_weight_decay * p)
        return p - v, v
