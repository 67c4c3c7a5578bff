"""The execution context of a forward pass (counterpart of the context
part of ``paddle_tpu/nn/module.py``: ``Context``, ``current_context``,
``is_training`` and ``stateful``).

A ``Context`` carries the training flag and the RNG key of one pass.
Its ``next_key(salt)`` is the JAX one: the counter goes up by one and
the key is ``fold_in(rng, counter * 1000003 + salt)``, so every dropout
of a pass draws a key of its own, in call order, the same keys as the
JAX package's. Without an rng it returns the global stream's
``random.next_key()``.

The JAX ``Module`` pytree machinery is not ported: the port's layers are
``torch.nn.Module``s, and a layer passes its own ``self.training`` where
the JAX ``Module.__call__`` scopes its mode over the call
(``is_training(module_mode)``). Functional buffer updates
(``Context.updates``) have no producer in the port (no BatchNorm), so
they are not ported either.
"""

import contextlib
import threading
from typing import Optional

import torch

from paddle_tpu_torch import random as prng

__all__ = ["Context", "current_context", "is_training", "stateful"]

# the salt stride of ``Context.next_key`` (JAX module.py:443)
KEY_STRIDE = 1000003


_ctx_stack = threading.local()


class Context:
    """Threaded execution state for one forward pass: ``training`` and
    the pass's RNG key ``rng`` (a ``paddle_tpu_torch.random`` key)."""

    def __init__(self, training: bool = False,
                 rng: Optional[torch.Tensor] = None):
        self.training = training
        self._rng = rng
        self._rng_counter = 0

    def next_key(self, salt: int = 0) -> torch.Tensor:
        if self._rng is None:
            return prng.next_key()
        self._rng_counter += 1
        return prng.fold_in(self._rng,
                            self._rng_counter * KEY_STRIDE + salt)


def current_context() -> Optional[Context]:
    return getattr(_ctx_stack, "ctx", None)


def is_training(module_mode: Optional[bool] = None) -> bool:
    """The active ``stateful`` context's flag, else ``module_mode`` (a
    layer's ``self.training``, where the JAX package reads the calling
    module's train()/eval() mode), else False (the JAX process
    default, which nothing in the port sets)."""
    ctx = current_context()
    if ctx is not None:
        return ctx.training
    if module_mode is not None:
        return bool(module_mode)
    return False


@contextlib.contextmanager
def stateful(training: bool = False, rng: Optional[torch.Tensor] = None):
    """Enter an execution context::

        with nn.stateful(training=True, rng=random.PRNGKey(0)):
            loss = loss_fn(model(x), y)
    """
    ctx = Context(training=training, rng=rng)
    prev = getattr(_ctx_stack, "ctx", None)
    _ctx_stack.ctx = ctx
    try:
        yield ctx
    finally:
        _ctx_stack.ctx = prev
