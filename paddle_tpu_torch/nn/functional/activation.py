"""Activations the transformer layers name (counterpart of
``paddle_tpu/nn/functional/activation.py``, cut to ``relu`` and
``gelu``). ``gelu`` is the exact erf form, ``jax.nn.gelu``'s default
with ``approximate=False`` as the JAX functional passes it."""

import torch.nn.functional as torch_F

__all__ = ["relu", "gelu", "get"]


def relu(x):
    return torch_F.relu(x)


def gelu(x, approximate: bool = False):
    return torch_F.gelu(x, approximate="tanh" if approximate else "none")


_BY_NAME = {"relu": relu, "gelu": gelu}


def get(name: str):
    """The activation a layer names (``activation="gelu"``)."""
    try:
        return _BY_NAME[name]
    except KeyError:
        raise NotImplementedError(
            f"activation {name!r} is not ported; ported: "
            f"{sorted(_BY_NAME)}") from None
