"""Weight-only int8 post-training quantization for serving (counterpart
of ``paddle_tpu/quantization/__init__.py``).

Weights live as int8 plus per-output-channel fp32 scales (half the bytes
of bf16: decode is bound by the weight read) and ``x @ qt`` runs the
int8 matmul (K12 on the card) on the int8 payload:

    from paddle_tpu_torch import quantization as quant
    qmodel = quant.quantize_for_inference(model)
    out = qmodel.generate(tokens, max_new_tokens=64)

``QuantTensor`` has no ``__torch_function__``, so ``torch.Tensor``'s
``@`` returns NotImplemented for it and Python calls
``QuantTensor.__rmatmul__``: model code written against plain weights
(``x @ w["wqkv"]``) runs unmodified. Unlike the JAX package, nothing
falls back to a dequantized float product when the kernel cannot run:
on a CUDA tensor ``x @ qt`` launches K12 or raises; on a CPU tensor it
runs the kernel's plain version. Quantization-aware training (``qat``)
and ``dequantize_params`` are not ported.
"""

import torch

from paddle_tpu_torch.ops.quant_matmul import int8_matmul

__all__ = ["QuantTensor", "quantize_tensor", "quantize_for_inference"]

# the GPT block weights the JAX structural planner classifies as
# column/row-parallel matmul weights (quantization/__init__.py:139-158)
_BLOCK_MATMULS = ("wqkv", "wo", "wup", "wdown")
# the JAX function's default ``min_size``: a selected weight with fewer
# elements (per layer for a block slab) stays float
_MIN_SIZE = 4096


class QuantTensor:
    """An int8 weight ``q`` (K, N) with fp32 scales (1, N) per output
    column, standing in for the float weight of dtype ``dtype``."""

    def __init__(self, q, scale, dtype=torch.bfloat16):
        self.q = q
        self.scale = scale
        self._dtype = dtype

    def dequantize(self):
        return (self.q.float() * self.scale).to(self._dtype)

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return self._dtype

    @property
    def T(self):  # noqa: N802 (tensor-protocol parity)
        return self.dequantize().T

    def __rmatmul__(self, other):
        """``x @ qt``, the serving hot path: K12 on CUDA, its plain
        version on the CPU, in x's dtype."""
        return int8_matmul(other, self.q, self.scale)

    def __repr__(self):
        return (f"QuantTensor(int8{list(self.shape)}, "
                f"dequant={self._dtype})")


def quantize_tensor(w, axis: int = -1) -> QuantTensor:
    """Symmetric per-channel absmax int8 quantization: ``axis`` is the
    channel dim whose scales are kept (the output dim of a weight used
    as ``x @ w``). The same float32 operations as the JAX function, so
    the same q and scale, bit for bit: absmax over the other dims,
    scale = max(absmax, 1e-8) / 127, q = clip(round(w / scale), -127,
    127) with round half to even."""
    w = w.detach()
    wf = w.to(torch.float32)
    ax = axis % w.dim()
    reduce_dims = tuple(i for i in range(w.dim()) if i != ax)
    absmax = wf.abs().amax(dim=reduce_dims, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QuantTensor(q, scale, w.dtype)


def _matmul_weights(model):
    """The port's parameter names of the matmul weights the JAX planner
    selects for a GPT: the stacked block slabs, and an untied LM head
    (the tied head is the ``wte`` lookup table, which stays float, as do
    ``wpe``, the norms and the biases)."""
    names = {f"stacked.{n}" for n in _BLOCK_MATMULS}
    if not model.cfg.tie_embeddings:
        names.add("lm_head")
    return names


def quantize_for_inference(model):
    """A new GPT sharing ``model``'s float weights, with its matmul
    weights replaced by int8 ``QuantTensor``s: the ``_matmul_weights``
    with at least ``_MIN_SIZE`` elements per layer. Block slabs quantize
    per layer (per-(layer, output column) scales). The result serves
    (``generate``, ``make_engine`` and both engines); it does not
    train."""
    from paddle_tpu_torch.models.gpt import GPT

    if model.cfg.moe_experts > 0:
        raise NotImplementedError(
            "quantize_for_inference takes dense stacks: the expert weights "
            "of an MoE model are not among the int8 selections, and the "
            "engines that serve int8 weights refuse MoE")
    selected = _matmul_weights(model)
    weights, n_q = {}, 0
    for name, p in model.named_parameters():
        key = name.split(".", 1)[1] if name.startswith("stacked.") else name
        w = p.detach()
        per_layer = w[0] if name.startswith("stacked.") else w
        if not (name in selected and w.is_floating_point()
                and per_layer.numel() >= _MIN_SIZE):
            weights[key] = w
        elif name.startswith("stacked."):
            weights[key] = [quantize_tensor(wl) for wl in w.unbind(0)]
            n_q += 1
        else:
            weights[key] = quantize_tensor(w)
            n_q += 1
    if n_q == 0:
        raise ValueError(f"quantize_for_inference found no weight to "
                         f"quantize (every matmul weight is under "
                         f"{_MIN_SIZE} elements)")
    return GPT(model.cfg, device=model.wte.device, weights=weights)
