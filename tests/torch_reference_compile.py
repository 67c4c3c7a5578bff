"""A module-scoped autouse fixture for the port's parity tests: the JAX
reference compiles with XLA's optimizations mostly off
(``jax_disable_most_optimizations``: backend optimization level 0).

Nearly all the time of these tests goes to compiling the JAX reference
(train steps, engines, interpret-mode kernels) for tiny shapes, where
compiling is the cost and running is not. The reference still computes
JAX's function: the same operations, in fp32 or bf16 as the test asks,
and the tolerances are unchanged. The flag is restored and JAX's caches
cleared when the module's tests end, so no executable compiled under it
serves a later test of another module.

A test module opts in by importing the fixture::

    from torch_reference_compile import fast_reference_compiles  # noqa
"""

import jax
import pytest

_FLAG = "jax_disable_most_optimizations"


@pytest.fixture(scope="module", autouse=True)
def fast_reference_compiles():
    before = jax.config.read(_FLAG)
    jax.config.update(_FLAG, True)
    try:
        yield
    finally:
        jax.config.update(_FLAG, before)
        jax.clear_caches()
