"""Mixture-of-Experts FFN (counterpart of ``paddle_tpu/incubate/moe.py``).

GShard/Switch top-k routing with capacity, expressed as the JAX package
expresses it: dense dispatch and combine einsums against a (tokens,
experts, capacity) one-hot tensor, tokens routed in fixed-size groups so
the routing memory stays linear in the token count. A token that finds
its expert full is dropped: its combine weight is zero, and the caller's
residual carries it past the layer.

One device: the JAX module's ``_shard`` / ``_shard_groups`` constraints
pin the expert axis to the 'ep' mesh axis and the group axis to the data
axes; with no mesh they are no-ops, and the port leaves them out (the
'ep' axis, with ``EXPERT_PARTITION_RULES``, waits for distributed
training). The expert products, the gate and the einsums are the work
the JAX package leaves to XLA: plain torch ops here, no kernel.

``moe_ffn`` is the routing core, a function over a name -> tensor map of
the five expert parameters; ``MoELayer.forward`` and the GPT block
(``models.gpt``, which holds no weights) both call it. The Switch
gate's jitter is ``random.uniform(key, shape, fp32, -1, 1)`` from
``paddle_tpu_torch.random``, the same bits as ``jax.random``.
"""

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as torch_F
from torch import nn

from paddle_tpu_torch import device as device_lib
from paddle_tpu_torch import dtypes
from paddle_tpu_torch import random as prng

__all__ = ["MoELayer", "Routing", "top_k_gating", "moe_ffn",
           "expert_param_specs", "draw_param"]


def draw_param(shape, dtype, init, gen, dev):
    """A parameter tensor: ``init`` is "ones", "zeros" or a std, drawn in
    fp32 from ``gen`` on ``dev`` and cast to ``dtype``."""
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=dev)
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=dev)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
    return (x * init).to(dtype)


def expert_param_specs(d_model: int, d_hidden: int, num_experts: int,
                       dtype) -> Dict[str, tuple]:
    """name -> (shape, dtype, init) of the expert parameters, the JAX
    names, shapes and dtypes: the gate in fp32, the experts in
    ``dtype``; std 0.02 for the three matrices, zero biases."""
    E, d, h = num_experts, d_model, d_hidden
    return {"gate_w": ((d, E), torch.float32, 0.02),
            "moe_w1": ((E, d, h), dtype, 0.02),
            "moe_b1": ((E, 1, h), dtype, "zeros"),
            "moe_w2": ((E, h, d), dtype, 0.02),
            "moe_b2": ((E, 1, d), dtype, "zeros")}


@dataclasses.dataclass(frozen=True)
class Routing:
    """How tokens reach experts: ``k`` experts a token, each holding
    ``capacity(group)`` tokens of a group of ``tokens_per_group``; the
    Switch gate jitters the logits by ``jitter_eps``."""
    num_experts: int
    k: int
    capacity_factor: float = 1.25
    jitter_eps: float = 0.0
    tokens_per_group: int = 1024

    @classmethod
    def for_gate(cls, num_experts: int, gate: str = "gshard",
                 k: Optional[int] = None, capacity_factor: float = 1.25,
                 jitter_eps: float = 0.01, tokens_per_group: int = 1024):
        """The JAX ``MoELayer``'s settings: "gshard" is top-2 without
        jitter, "switch" top-1 jittered by ``jitter_eps``."""
        if gate not in ("gshard", "switch"):
            raise ValueError(f"unknown gate {gate!r}")
        return cls(num_experts=num_experts,
                   k=k if k is not None else (2 if gate == "gshard" else 1),
                   capacity_factor=capacity_factor,
                   jitter_eps=jitter_eps if gate == "switch" else 0.0,
                   tokens_per_group=tokens_per_group)

    def capacity(self, n_tokens: int) -> int:
        return max(4, int(math.ceil(
            self.k * n_tokens * self.capacity_factor / self.num_experts)))


def _one_hot(x, n):
    # a compare, as jax.nn.one_hot: F.one_hot checks its range on the
    # host, which waits for the device
    return (x[..., None] == torch.arange(n, device=x.device)).float()


def _jitter(rng_key, logits):
    """``uniform(key, shape, dtype, -1, 1)`` over the logits: one key for
    (N, E) logits, or (G, 2) keys, one per group of (G, N, E)."""
    keys = torch.as_tensor(rng_key)
    if keys.dim() == 1:
        return prng.uniform(keys, logits.shape, logits.dtype, -1.0, 1.0,
                            device=logits.device)
    return torch.stack([prng.uniform(kk, logits.shape[1:], logits.dtype,
                                     -1.0, 1.0, device=logits.device)
                        for kk in keys])


def top_k_gating(logits, k: int, capacity: int, rng_key=None,
                 jitter_eps: float = 0.0):
    """GShard top-k gating with capacity. logits: (N, E), or (G, N, E)
    for G groups routed apart (``rng_key`` then holds (G, 2) keys).

    Returns (combine (..., N, E, C) fp32, dispatch bool (..., N, E, C),
    aux (...,)). aux = E * sum_e mean_n(probs_e) * mean_n(top1_mask_e)
    (GShard eq. (4)), from the top-1 round only. Each round takes the
    argmax of the probabilities not yet chosen; a token's position in
    its expert counts every token that chose the expert before it,
    dropped ones included; a position past ``capacity`` drops the
    token. Top-k with k > 1 renormalises the kept gates to sum to 1
    (at least 1e-9); top-1 keeps the raw probability."""
    if jitter_eps > 0.0 and rng_key is not None:
        logits = logits + jitter_eps * _jitter(rng_key, logits)
    return _route(logits, k, capacity, _argmax)


def _argmax(masked_probs, i):
    return torch.argmax(masked_probs, dim=-1)


def _route(logits, k: int, capacity: int, choose):
    """``top_k_gating`` after the jitter: ``choose(masked_probs, i)``
    picks round i's expert of each token ((..., N) indices; the gate
    passes ``_argmax``, a check may pass recorded choices)."""
    n, e = logits.shape[-2:]
    lead = logits.shape[:-2]
    dev = logits.device
    probs = torch.softmax(logits.float(), dim=-1)

    combine = torch.zeros(lead + (n, e, capacity), dtype=torch.float32,
                          device=dev)
    masked_probs = probs
    position_base = torch.zeros(lead + (e,), dtype=torch.int32, device=dev)
    aux = torch.zeros(lead, dtype=torch.float32, device=dev)
    gates_sum = torch.zeros(lead + (n,), dtype=torch.float32, device=dev)
    for i in range(k):
        idx = choose(masked_probs, i)                            # (N,)
        mask = _one_hot(idx, e)                                  # (N,E)
        if i == 0:
            # load-balance aux uses the top-1 assignment only
            aux = e * torch.sum(probs.mean(dim=-2) * mask.mean(dim=-2),
                                dim=-1)
        pos = (torch.cumsum(mask, dim=-2) - 1.0) \
            + position_base[..., None, :]                        # (N,E)
        keep = (pos < capacity) & (mask > 0)
        position_base = position_base + mask.sum(dim=-2).to(torch.int32)
        gate_i = torch.sum(probs * mask, dim=-1)                 # (N,)
        in_cap = keep.any(dim=-1)
        gates_sum = gates_sum + gate_i * in_cap
        slot = torch.where(keep, pos, 0.0).sum(dim=-1).to(
            torch.int32)                                         # (N,)
        oh_slot = _one_hot(slot, capacity)                       # (N,C)
        contrib = (mask * keep.any(dim=-1, keepdim=True))[..., None] \
            * oh_slot[..., None, :] * gate_i[..., None, None]
        combine = combine + contrib
        masked_probs = masked_probs * (1.0 - mask)
    if k > 1:
        # renormalize the selected gates to sum to 1 per token (gshard);
        # top-1 (switch) keeps the raw gate probability as the scale
        combine = combine / torch.clamp(gates_sum, min=1e-9)[
            ..., None, None]
    dispatch = combine > 0.0
    return combine, dispatch, aux


def moe_ffn(w: Dict[str, torch.Tensor], x, routing: Routing, rng_key=None):
    """The MoE FFN of x (..., d) -> (y (..., d), aux scalar), ``w`` the
    expert parameters by their JAX names (``expert_param_specs``).

    Tokens are routed in groups of ``routing.tokens_per_group`` (one
    group when there are fewer): the dispatch tensor is (G, T, E, C)
    with C proportional to T, so the routing memory stays linear in the
    token count. The trailing group is zero-padded; its padded rows
    are sliced off the output. With ``rng_key`` and a jittering gate,
    group g's jitter comes from ``split(rng_key, G)[g]``. aux is the
    mean over groups."""
    orig_shape = x.shape
    d = orig_shape[-1]
    xt = x.reshape(-1, d)
    n = xt.shape[0]
    t = min(routing.tokens_per_group, n)
    g = -(-n // t)
    pad = g * t - n
    if pad:
        xt = torch_F.pad(xt, (0, 0, 0, pad))
    xg = xt.reshape(g, t, d)
    cap = routing.capacity(t)
    logits = xg.float() @ w["gate_w"]                           # (G,T,E)
    gate_keys = (prng.split(rng_key, g)
                 if (rng_key is not None and routing.jitter_eps > 0.0)
                 else None)
    combine, dispatch, aux = top_k_gating(logits, routing.k, cap,
                                          rng_key=gate_keys,
                                          jitter_eps=routing.jitter_eps)
    aux = aux.mean()
    # dispatch: (G,T,E,C) x (G,T,D) -> (G,E,C,D)
    expert_in = torch.einsum("gtec,gtd->gecd", dispatch.to(xt.dtype), xg)
    h = torch.einsum("gecd,edh->gech", expert_in, w["moe_w1"]) \
        + w["moe_b1"][None]
    h = torch_F.gelu(h, approximate="tanh")
    out = torch.einsum("gech,ehd->gecd", h, w["moe_w2"]) \
        + w["moe_b2"][None]
    # combine: back to tokens
    y = torch.einsum("gtec,gecd->gtd", combine.to(xt.dtype), out)
    y = y.reshape(g * t, d)
    if pad:
        y = y[:n]
    return y.reshape(orig_shape), aux


class MoELayer(nn.Module):
    """The MoE FFN as a layer (``MoELayer`` of the JAX package).

    gate: "gshard" (top-2) or "switch" (top-1, jittered). Parameters in
    the JAX names, shapes and dtypes (``expert_param_specs``), drawn
    from ``generator`` (default: a fresh one seeded ``seed``) on
    ``device`` (None means CUDA, and raises without it), or taken from
    ``weights`` (name -> tensor). forward returns (output, aux_loss);
    add ``aux_weight * aux_loss`` to the train loss."""

    def __init__(self, d_model: int, d_hidden: int, num_experts: int,
                 gate: str = "gshard", k: Optional[int] = None,
                 capacity_factor: float = 1.25, jitter_eps: float = 0.01,
                 tokens_per_group: int = 1024, dtype=torch.float32,
                 seed: int = 0, device=None,
                 generator: Optional[torch.Generator] = None,
                 weights: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__()
        self.routing = Routing.for_gate(
            num_experts, gate, k=k, capacity_factor=capacity_factor,
            jitter_eps=jitter_eps, tokens_per_group=tokens_per_group)
        specs = expert_param_specs(d_model, d_hidden, num_experts,
                                   dtypes.to_dtype(dtype))
        if weights is None:
            dev = device_lib.resolve(device)
            if generator is None:
                generator = torch.Generator(device=dev)
                generator.manual_seed(int(seed))
            weights = {n: draw_param(s, dt, init, generator, dev)
                       for n, (s, dt, init) in specs.items()}
        for n in specs:
            self.register_parameter(n, nn.Parameter(weights[n].detach()))

    @property
    def k(self):
        return self.routing.k

    def capacity(self, n_tokens: int) -> int:
        return self.routing.capacity(n_tokens)

    def forward(self, x, rng_key=None):
        return moe_ffn(dict(self.named_parameters()), x, self.routing,
                       rng_key)
