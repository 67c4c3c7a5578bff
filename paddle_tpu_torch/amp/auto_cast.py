"""AMP autocast (counterpart of ``paddle_tpu/amp/auto_cast.py``).

- O1, ``auto_cast(dtype="bfloat16")``: a thread-local region flag that
  the matmul-class functionals consult (``nn.functional.linear`` casts
  its inputs through ``amp_cast``); reductions, norms and softmax-CE
  stay fp32 (the black list).
- O2, ``decorate(model, level="O2")``: every floating parameter and
  buffer cast to the amp dtype; the optimizers update in fp32 and round
  back (``multi_precision``).

This is the JAX package's policy, not ``torch.autocast``: only the
functionals that ask are cast.
"""

import contextlib
import threading

import torch

__all__ = ["auto_cast", "autocast", "amp_guard", "amp_cast", "decorate",
           "cast_model_to", "white_list", "black_list", "get_amp_dtype",
           "amp_enabled", "WHITE_LIST", "BLACK_LIST"]

_state = threading.local()

# the reference's O1 lists, by the names of the functionals
WHITE_LIST = {"matmul", "mm", "bmm", "einsum", "conv1d", "conv2d", "conv3d",
              "linear", "attention"}
BLACK_LIST = {"log", "exp", "mean", "sum", "cross_entropy", "softmax",
              "layer_norm", "batch_norm", "cosine_similarity", "norm"}


def _to_dtype(dtype) -> torch.dtype:
    return torch.bfloat16 if dtype in ("bfloat16", torch.bfloat16) \
        else torch.float16


def white_list():
    return set(WHITE_LIST)


def black_list():
    return set(BLACK_LIST)


def get_amp_dtype():
    return getattr(_state, "dtype", None)


def amp_enabled():
    return getattr(_state, "enabled", False)


def amp_cast(x, op_class="white"):
    """A floating tensor cast to the amp dtype inside an ``auto_cast``
    region when its op is on the white list; anything else as given."""
    dt = get_amp_dtype()
    if dt is None or op_class != "white":
        return x
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x.to(dt)
    return x


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """The O1 region: white-listed functionals compute in ``dtype``."""
    prev_dtype = getattr(_state, "dtype", None)
    prev_enabled = getattr(_state, "enabled", False)
    if enable:
        _state.dtype = _to_dtype(dtype)
        _state.enabled = True
    try:
        yield
    finally:
        _state.dtype = prev_dtype
        _state.enabled = prev_enabled


autocast = auto_cast
amp_guard = auto_cast


def cast_model_to(model, dtype="bfloat16"):
    """Cast every floating parameter and buffer of a module (O2), in
    place; returns the module."""
    dt = _to_dtype(dtype)
    for t in list(model.parameters()) + list(model.buffers()):
        if t.is_floating_point():
            t.data = t.data.to(dt)
    return model


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2 casts the model(s); O1 leaves them. Returns the models, or
    ``(models, optimizers)`` when optimizers are given."""
    if level == "O2":
        if isinstance(models, (list, tuple)):
            models = type(models)(cast_model_to(m, dtype) for m in models)
        else:
            models = cast_model_to(models, dtype)
    if optimizers is None:
        return models
    return models, optimizers
