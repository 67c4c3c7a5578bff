"""Learning-rate schedules (counterpart of ``paddle_tpu/optimizer/lr.py``,
all 16 classes).

``value_at(step)`` takes an int (or an integer tensor) and returns the
rate as a 0-dim fp32 tensor on the CPU, computed as the JAX package
computes it: fp32 arithmetic on the step, the same order of operations,
and a Python float's constant folded in double before it meets the
fp32 step (as a weak-typed JAX scalar is). The optimizers call it at
their state's step + 1 and read the value once a step, on the host, so
a schedule never waits for the device.

``MultiplicativeDecay`` and ``ReduceOnPlateau`` keep their value on the
host and move with ``step()``, as in the JAX package. The paddle-style
stateful API (``step``, ``get_lr``, ``state_dict``, ``set_state_dict``)
is kept.
"""

import math

import torch

__all__ = ["LRScheduler", "NoamDecay", "ExponentialDecay", "NaturalExpDecay",
           "InverseTimeDecay", "PolynomialDecay", "LinearWarmup",
           "PiecewiseDecay", "CosineAnnealingDecay", "MultiStepDecay",
           "StepDecay", "LambdaDecay", "ReduceOnPlateau",
           "MultiplicativeDecay", "OneCycleLR", "CyclicLR",
           "CosineAnnealingWarmRestarts"]


def _step(step) -> torch.Tensor:
    """The step as a 0-dim int64 CPU tensor."""
    return torch.as_tensor(step).to(device="cpu", dtype=torch.int64)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(device="cpu", dtype=torch.float32)


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = learning_rate
        self.last_epoch = last_epoch
        self.step()  # initialize

    # -- functional --------------------------------------------------------
    def value_at(self, step) -> torch.Tensor:
        raise NotImplementedError

    # -- stateful parity API -----------------------------------------------
    def step(self, epoch=None):
        self.last_epoch = epoch if epoch is not None else self.last_epoch + 1

    def get_lr(self):
        return float(self.value_at(max(self.last_epoch, 0)))

    def state_dict(self):
        return {"last_epoch": self.last_epoch}

    def set_state_dict(self, d):
        self.last_epoch = d["last_epoch"]


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0,
                 last_epoch=-1, verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def value_at(self, step):
        s = torch.clamp(_f32(_step(step)), min=1.0)
        return self.base_lr * self.d_model ** -0.5 * torch.minimum(
            s ** -0.5, s * self.warmup_steps ** -1.5)


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def value_at(self, step):
        return self.base_lr * torch.pow(_f32(self.gamma), _f32(_step(step)))


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def value_at(self, step):
        return self.base_lr * torch.exp(-self.gamma * _f32(_step(step)))


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def value_at(self, step):
        return self.base_lr / (1 + self.gamma * _f32(_step(step)))


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def value_at(self, step):
        s = _f32(_step(step))
        if self.cycle:
            div = torch.ceil(torch.clamp(s / self.decay_steps, min=1.0))
            decay_steps = self.decay_steps * div
        else:
            decay_steps = self.decay_steps
            s = torch.clamp(s, max=decay_steps)
        return (self.base_lr - self.end_lr) * torch.pow(
            1 - s / decay_steps, _f32(self.power)) + self.end_lr


class LinearWarmup(LRScheduler):
    """A linear ramp from ``start_lr`` to ``end_lr`` over
    ``warmup_steps``, then ``learning_rate`` (a schedule, started at 0
    when the ramp ends, or a float)."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        self.lr_after = learning_rate
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(end_lr, last_epoch, verbose)

    def value_at(self, step):
        step = _step(step)
        s = _f32(step)
        warm = self.start_lr + (self.end_lr - self.start_lr) * torch.clamp(
            s / self.warmup_steps, max=1.0)
        if isinstance(self.lr_after, LRScheduler):
            after = self.lr_after.value_at(
                torch.clamp(step - self.warmup_steps, min=0))
        else:
            after = _f32(self.lr_after)
        return torch.where(s < self.warmup_steps, warm, after)


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, last_epoch=-1, verbose=False):
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch, verbose)

    def value_at(self, step):
        idx = (_step(step) >= torch.tensor(self.boundaries)).sum()
        return _f32(self.values)[idx]


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0.0, last_epoch=-1,
                 verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def value_at(self, step):
        s = _f32(_step(step))
        return self.eta_min + (self.base_lr - self.eta_min) * 0.5 * (
            1 + torch.cos(math.pi * torch.clamp(s, max=self.T_max)
                          / self.T_max))


class CosineAnnealingWarmRestarts(LRScheduler):
    def __init__(self, learning_rate, T_0, T_mult=1, eta_min=0.0,
                 last_epoch=-1, verbose=False):
        if T_mult != 1:
            raise ValueError("T_mult != 1 is not supported (the JAX "
                             "package's compiled form has none)")
        self.T_0 = T_0
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def value_at(self, step):
        s = torch.remainder(_f32(_step(step)), self.T_0)
        return self.eta_min + (self.base_lr - self.eta_min) * 0.5 * (
            1 + torch.cos(math.pi * s / self.T_0))


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def value_at(self, step):
        n = _f32((_step(step) >= torch.tensor(self.milestones)).sum())
        return self.base_lr * torch.pow(_f32(self.gamma), n)


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def value_at(self, step):
        n = _f32(torch.div(_step(step), self.step_size,
                           rounding_mode="floor"))
        return self.base_lr * torch.pow(_f32(self.gamma), n)


class LambdaDecay(LRScheduler):
    """``base_lr * lr_lambda(step)``; the lambda gets the step as a 0-dim
    integer tensor."""

    def __init__(self, learning_rate, lr_lambda, last_epoch=-1,
                 verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def value_at(self, step):
        return _f32(self.base_lr * self.lr_lambda(_step(step)))


class MultiplicativeDecay(LRScheduler):
    """lr = base_lr * prod_{i=1..step} lambda(i), tracked on the host by
    ``step()``; ``value_at`` returns the current value."""

    def __init__(self, learning_rate, lr_lambda, last_epoch=-1,
                 verbose=False):
        self.lr_lambda = lr_lambda
        self.current_factor = 1.0
        super().__init__(learning_rate, last_epoch, verbose)

    def value_at(self, step):
        return _f32(self.base_lr * self.current_factor)

    def step(self, epoch=None):
        prev = getattr(self, "last_epoch", -1)
        self.last_epoch = epoch if epoch is not None else prev + 1
        if self.last_epoch > 0:
            self.current_factor *= float(self.lr_lambda(self.last_epoch))

    def state_dict(self):
        return {"last_epoch": self.last_epoch,
                "current_factor": self.current_factor}

    def set_state_dict(self, d):
        self.last_epoch = d["last_epoch"]
        self.current_factor = d.get("current_factor", 1.0)


class ReduceOnPlateau(LRScheduler):
    """Metric-driven, on the host: ``step(metrics)`` lowers the rate by
    ``factor`` after ``patience`` steps without improvement;
    ``value_at`` returns the current value."""

    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0
        self.current_lr = learning_rate
        super().__init__(learning_rate, -1, verbose)

    def value_at(self, step):
        return _f32(self.current_lr)

    def step(self, metrics=None, epoch=None):
        self.last_epoch += 1
        if metrics is None:
            return
        m = float(metrics)
        better = (self.best is None or
                  (self.mode == "min" and m < self.best - self.threshold) or
                  (self.mode == "max" and m > self.best + self.threshold))
        if better:
            self.best = m
            self.num_bad = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.current_lr = max(self.current_lr * self.factor,
                                      self.min_lr)
                self.cooldown_counter = self.cooldown
                self.num_bad = 0


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3,
                 anneal_strategy="cos", three_phase=False, last_epoch=-1,
                 verbose=False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.phase_pct = phase_pct
        super().__init__(max_learning_rate, last_epoch, verbose)

    def value_at(self, step):
        s = _f32(_step(step))
        up = self.phase_pct * self.total_steps
        down = self.total_steps - up

        def cos_interp(a, b, pct):
            return b + (a - b) * 0.5 * (1 + torch.cos(math.pi * pct))

        pct_up = torch.clamp(s / _f32(max(up, 1.0)), 0.0, 1.0)
        pct_down = torch.clamp((s - up) / _f32(max(down, 1.0)), 0.0, 1.0)
        lr_up = cos_interp(self.initial_lr, self.max_lr, pct_up)
        lr_down = cos_interp(self.max_lr, self.end_lr, pct_down)
        return torch.where(s < up, lr_up, lr_down)


class CyclicLR(LRScheduler):
    def __init__(self, base_learning_rate, max_learning_rate,
                 step_size_up=2000, step_size_down=None, mode="triangular",
                 exp_gamma=1.0, scale_fn=None, scale_mode="cycle",
                 last_epoch=-1, verbose=False):
        self.max_lr = max_learning_rate
        self.step_up = step_size_up
        self.step_down = step_size_down or step_size_up
        self.mode = mode
        self.exp_gamma = exp_gamma
        super().__init__(base_learning_rate, last_epoch, verbose)

    def value_at(self, step):
        s = _f32(_step(step))
        total = self.step_up + self.step_down
        cycle = torch.floor(1 + s / total)
        pos = s - (cycle - 1) * total
        frac = torch.where(pos < self.step_up, pos / self.step_up,
                           1 - (pos - self.step_up) / self.step_down)
        amp = self.max_lr - self.base_lr
        if self.mode == "triangular2":
            amp = amp / torch.pow(_f32(2.0), cycle - 1)
        elif self.mode == "exp_range":
            amp = amp * torch.pow(_f32(self.exp_gamma), s)
        return self.base_lr + amp * frac
