"""Carry GPT weights between the JAX package's names and the port.

``gpt_from_jax_state`` takes the flat name -> array dict of
``paddle_tpu`` ``GPT.state_dict()`` as numpy arrays (``wte``, ``wpe``,
``lnf_scale``, ``lnf_bias``, ``lm_head`` and ``blocks.item_<i>.<name>``,
an MoE layer's experts under ``blocks.item_<i>.moe.<name>``) and
returns the port's ``GPT`` with the same weights. Layouts stay as in
JAX ((in, out) for every projection), so nothing is transposed. It
fails on a missing or unexpected key and on a shape mismatch.

``gpt_to_jax_state`` goes the other way: the port's parameters (or,
with ``grads=True``, their gradients) as a flat name -> fp32 numpy dict
in the JAX names, a dense stack's slabs split into
``blocks.item_<i>.<name>`` (an MoE stack has its parameters under
those names already) — the keys of ``GPT.split_params()`` and of
``jax.grad`` over them.

``load_jax_state`` fills any port ``nn.Module`` whose JAX counterpart
has the same structure (the ``nn`` and ``incubate.nn`` layers) from
that module's ``state_dict()``: JAX names (``weight``, ``norm_bias``,
``linear1.weight``, ...; a ``LayerList`` item ``item_<i>`` is the
port's ``ModuleList`` index ``<i>``) and JAX layouts ((in, out), and
(3, H, dh, D) for a packed QKV), nothing transposed. It fails on a
missing or unexpected key and on a shape mismatch.

``bert_from_jax_state`` fills a BERT-family model of the port
(``models/bert.py``, ``models/ernie.py``: any head, either layout) in
place from the JAX parameters as numpy arrays, in the JAX per-layer
names (``bert.layers.item_<i>.<name>``, ``ernie.bert...``) or the JAX
stacked entry's (``bert._stacked_layers.<name>``, (L, ...) arrays); a
slab takes the per-layer arrays stacked. It fails on a missing or
unexpected key and on a shape mismatch. ``bert_to_jax_state`` goes the
other way, parameters or (``grads=True``) gradients, in the per-layer
names or, with ``stacked=True``, the stacked entry's, whatever the
model's own layout.
"""

import re
from typing import Dict

import numpy as np
import torch

from paddle_tpu_torch import device as device_lib
from paddle_tpu_torch.models.gpt import (GPT, GPTConfig, block_param_specs,
                                         head_param_specs,
                                         layer_param_specs)

__all__ = ["gpt_from_jax_state", "gpt_to_jax_state", "load_jax_state",
           "bert_from_jax_state", "bert_to_jax_state"]


def _tensor(arr, shape, dtype, dev, name):
    # a fresh copy (bf16 arrays pass through fp32): the model trains in
    # place and must never write into the caller's arrays
    a = np.array(arr, dtype=np.float32, order="C", copy=True)
    if a.shape != tuple(shape):
        raise ValueError(f"{name}: shape {a.shape}, expected "
                         f"{tuple(shape)}")
    return torch.from_numpy(a).to(device=dev, dtype=dtype)


def gpt_from_jax_state(cfg: GPTConfig, state: Dict[str, np.ndarray],
                       device=None) -> GPT:
    dev = device_lib.resolve(device)
    specs = {**head_param_specs(cfg), **layer_param_specs(cfg)}
    missing = sorted(set(specs) - set(state))
    unexpected = sorted(set(state) - set(specs))
    if missing or unexpected:
        raise KeyError(f"state does not match {cfg}: missing={missing}, "
                       f"unexpected={unexpected}")
    weights = {n: _tensor(state[n], s, dt, dev, n)
               for n, (s, dt, _) in specs.items()}
    if cfg.moe_experts == 0:
        # a dense stack's layers go into (L, ...) slabs
        for n in block_param_specs(cfg):
            weights[n] = torch.stack([weights.pop(f"blocks.item_{i}.{n}")
                                      for i in range(cfg.n_layers)])
    return GPT(cfg, device=dev, weights=weights)


def _numpy(t, name, grads):
    if grads:
        t = t.grad
        if t is None:
            raise ValueError(f"{name} has no gradient (run a backward "
                             f"or a train step first)")
    return t.detach().float().cpu().numpy()


def gpt_to_jax_state(model: GPT, grads: bool = False
                     ) -> Dict[str, np.ndarray]:
    cfg = model.cfg
    out = {n: _numpy(getattr(model, n), n, grads)
           for n in head_param_specs(cfg)}
    if model.blocks is not None:
        for n, p in model.blocks.named_parameters():
            out[f"blocks.{n}"] = _numpy(p, f"blocks.{n}", grads)
        return out
    for n in block_param_specs(cfg):
        slab = _numpy(model.stacked[n], f"stacked.{n}", grads)
        for i in range(cfg.n_layers):
            out[f"blocks.item_{i}.{n}"] = slab[i]
    return out


_ITEM = re.compile(r"(^|\.)item_(\d+)(?=\.|$)")


def load_jax_state(module: torch.nn.Module, state: Dict[str, np.ndarray]
                   ) -> torch.nn.Module:
    """Copy ``state`` (the JAX module's name -> array dict) into
    ``module``'s parameters in place, each cast to the parameter's dtype
    on its device; returns ``module``."""
    own = dict(module.named_parameters())
    mapped = {_ITEM.sub(r"\1\2", n): n for n in state}
    missing = sorted(set(own) - set(mapped))
    unexpected = sorted(mapped[n] for n in set(mapped) - set(own))
    if missing or unexpected:
        raise KeyError(f"state does not match {type(module).__name__}: "
                       f"missing={missing}, unexpected={unexpected}")
    with torch.no_grad():
        for name, jax_name in mapped.items():
            p = own[name]
            p.copy_(_tensor(state[jax_name], p.shape, p.dtype, p.device,
                            jax_name))
    return module


_LAYER = re.compile(r"^(.*)layers\.item_(\d+)\.([^.]+)$")
_SLAB = re.compile(r"^(.*)_stacked_layers\.([^.]+)$")


def _per_layer(arrays):
    """Name -> array with every stacked entry (``<prefix>_stacked_layers
    .<name>``) split into ``<prefix>layers.item_<i>.<name>``."""
    out = {}
    for n, a in arrays.items():
        m = _SLAB.match(n)
        if m is None:
            out[n] = a
            continue
        for i in range(a.shape[0]):
            out[f"{m[1]}layers.item_{i}.{m[2]}"] = a[i]
    return out


def _stack_layers(arrays):
    """The inverse of ``_per_layer`` over numpy arrays."""
    out, groups = {}, {}
    for n, a in arrays.items():
        m = _LAYER.match(n)
        if m is None:
            out[n] = a
        else:
            groups.setdefault((m[1], m[3]), {})[int(m[2])] = a
    for (prefix, name), items in groups.items():
        out[f"{prefix}_stacked_layers.{name}"] = np.stack(
            [items[i] for i in range(len(items))])
    return out


def bert_to_jax_state(model: torch.nn.Module, grads: bool = False,
                      stacked: bool = False) -> Dict[str, np.ndarray]:
    arrays = _per_layer({n: _numpy(p, n, grads)
                         for n, p in model.named_parameters()})
    return _stack_layers(arrays) if stacked else arrays


def bert_from_jax_state(model: torch.nn.Module,
                        state: Dict[str, np.ndarray]) -> torch.nn.Module:
    own = dict(model.named_parameters())
    targets = {}
    for n, p in own.items():
        m = _SLAB.match(n)
        if m is None:
            targets[n] = (n, None)
            continue
        for i in range(p.shape[0]):
            targets[f"{m[1]}layers.item_{i}.{m[2]}"] = (n, i)
    given = _per_layer(state)
    missing = sorted(set(targets) - set(given))
    unexpected = sorted(set(given) - set(targets))
    if missing or unexpected:
        raise KeyError(f"state does not match {type(model).__name__}: "
                       f"missing={missing}, unexpected={unexpected}")
    with torch.no_grad():
        for name, (n, i) in targets.items():
            dst = own[n] if i is None else own[n][i]
            dst.copy_(_tensor(given[name], dst.shape, dst.dtype,
                              dst.device, name))
    return model
