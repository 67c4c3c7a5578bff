"""Test-support runtime: deterministic fault injection
(``paddle_tpu_torch.testing.faults``). The serving engines consult the
``engine.poison_logits`` site, a no-op unless a fault plan is
installed."""

from paddle_tpu_torch.testing import faults

__all__ = ["faults"]
