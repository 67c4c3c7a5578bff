"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` stays the reference; this package mirrors
its module paths (``models/gpt.py``, ``nn/functional/attention.py``,
``inference/paged_engine.py``, ...) and replaces each Pallas TPU kernel
on a ported path with a hand-written CUDA kernel for Hopper (sources in
``csrc/``, built by ``ops/_build.py``). It imports ``torch`` and never
``jax`` or ``paddle_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU and without an explicit device they raise (see
``device.resolve``). Importing this package imports only torch, and
starts a thread or opens a socket only where the environment asks for
tracing (``PT_TRACE_DIR``, ``PT_TRACE_FILE``) or the statsz endpoint
(``PT_STATSZ_PORT``): see ``observability.init_from_env``.
"""

from paddle_tpu_torch import observability as _observability

__version__ = "0.1.0"

_observability.init_from_env()
