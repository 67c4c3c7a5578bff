"""The port's weight-only int8 path against the JAX package's, on the
same numpy inputs: K12's plain version (the CPU route of
``int8_matmul``) against the Pallas kernel in interpret mode with
ragged M, K and N in fp32 and bf16; ``quantize_tensor`` bit for bit;
``x @ qt`` reaching ``QuantTensor.__rmatmul__`` (and K12's wrapper);
``quantize_for_inference``'s selection and logits against JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import quantization as jax_quant
from paddle_tpu.models import gpt as jax_gpt
from paddle_tpu.ops.pallas.quant_matmul import int8_matmul as jax_int8
from paddle_tpu_torch import quantization as quant
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.models.convert import gpt_from_jax_state
from paddle_tpu_torch.ops.quant_matmul import (int8_matmul,
                                               int8_matmul_reference)
from test_torch_gpt import port_config, random_state
from torch_reference_compile import fast_reference_compiles  # noqa: F401

# fp32: the same fp32 sums in another order, so apart by a few fp32
# ulps of the largest terms (F32_TOL times the largest |out|); bf16: one
# rounding of nearly the same fp32 value, one bf16 ulp (2^-7 relative)
F32_TOL = 1e-5
BF16_RTOL = 2.0 ** -7
SHAPES = [(5, 200, 130), (33, 128, 256), (1, 64, 48), (17, 300, 520)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _operands(seed, m, k, n):
    rs = np.random.RandomState(seed)
    x = rs.randn(m, k).astype(np.float32)
    q = rs.randint(-127, 128, size=(k, n)).astype(np.int8)
    scale = (rs.rand(1, n) * 0.02 + 1e-3).astype(np.float32)
    return x, q, scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m, k, n", SHAPES)
def test_plain_matches_jax_kernel(dtype, m, k, n):
    x, q, scale = _operands(0, m, k, n)
    want = np.asarray(jax_int8(jnp.asarray(x, getattr(jnp, dtype)),
                               jnp.asarray(q), jnp.asarray(scale),
                               interpret=True), np.float32)
    got = int8_matmul(torch.from_numpy(x).to(getattr(torch, dtype)),
                      torch.from_numpy(q), torch.from_numpy(scale))
    assert got.dtype == getattr(torch, dtype) and got.shape == (m, n)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL,
                                   atol=F32_TOL * np.abs(want).max())
    else:
        np.testing.assert_allclose(got.float().numpy(), want,
                                   rtol=BF16_RTOL,
                                   atol=F32_TOL * np.abs(want).max())


def test_leading_dims_and_scale_shapes():
    x, q, scale = _operands(1, 12, 64, 40)
    xt = torch.from_numpy(x).reshape(3, 4, 64)
    a = int8_matmul(xt, torch.from_numpy(q), torch.from_numpy(scale))
    b = int8_matmul(xt, torch.from_numpy(q),
                    torch.from_numpy(scale.reshape(-1)))
    assert a.shape == (3, 4, 40)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    want = (x @ q.astype(np.float32)) * scale
    np.testing.assert_allclose(a.reshape(12, 40).numpy(), want, rtol=1e-5,
                               atol=1e-5)


def test_cpu_tensors_count_no_launch():
    x, q, scale = (torch.from_numpy(a) for a in _operands(2, 4, 64, 32))
    before = int8_matmul.launches
    torch.testing.assert_close(int8_matmul(x, q, scale),
                               int8_matmul_reference(x, q, scale), atol=0,
                               rtol=0)
    assert int8_matmul.launches == before


def test_operand_errors():
    x, q, scale = (torch.from_numpy(a) for a in _operands(3, 4, 64, 32))
    with pytest.raises(ValueError, match="need x"):
        int8_matmul(x[:, :10], q, scale)
    with pytest.raises(TypeError, match="int8"):
        int8_matmul(x, q.float(), scale)
    with pytest.raises(ValueError, match="scale"):
        int8_matmul(x, q, scale[:, :5])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        int8_matmul(x.double(), q, scale)


@pytest.mark.parametrize("shape, dtype", [
    ((64, 128), "float32"), ((96, 40), "bfloat16"), ((3, 16, 24),
                                                     "float32")])
def test_quantize_tensor_bit_identical_to_jax(shape, dtype):
    rs = np.random.RandomState(4)
    w = rs.randn(*shape).astype(np.float32) * 0.05
    w[0, 0] = 0.0
    jw = jnp.asarray(w, getattr(jnp, dtype))
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    for axis in (-1, 0):
        jq = jax_quant.quantize_tensor(jw, axis=axis)
        tq = quant.quantize_tensor(tw, axis=axis)
        np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
        np.testing.assert_array_equal(tq.scale.numpy(),
                                      np.asarray(jq.scale))
        assert tq.dtype == getattr(torch, dtype)


def test_rmatmul_dispatch_not_bypassed(monkeypatch):
    """``x @ qt`` with x a torch.Tensor must reach
    ``QuantTensor.__rmatmul__``, and from there K12's wrapper."""
    rs = np.random.RandomState(5)
    w = torch.from_numpy(rs.randn(32, 16).astype(np.float32))
    x = torch.from_numpy(rs.randn(4, 32).astype(np.float32))
    qt = quant.quantize_tensor(w)
    calls = {"rmatmul": 0, "int8_matmul": 0}
    orig_r = quant.QuantTensor.__rmatmul__
    orig_k = quant.int8_matmul

    def spy_r(self, other):
        calls["rmatmul"] += 1
        return orig_r(self, other)

    def spy_k(*args):
        calls["int8_matmul"] += 1
        return orig_k(*args)

    monkeypatch.setattr(quant.QuantTensor, "__rmatmul__", spy_r)
    monkeypatch.setattr(quant, "int8_matmul", spy_k)
    out = x @ qt
    assert calls == {"rmatmul": 1, "int8_matmul": 1}
    torch.testing.assert_close(
        out, int8_matmul_reference(x, qt.q, qt.scale), atol=0, rtol=0)
    torch.testing.assert_close(out, x @ qt.dequantize(), atol=1e-5,
                               rtol=1e-5)


JAX_CONFIGS = {
    "gpt_tiny": jax_gpt.gpt_tiny(),
    # llama_style_1b's shape at tiny width: rope, GQA, no biases, untied
    "llama_style_tiny": jax_gpt.gpt_tiny(n_heads=4, n_kv_heads=2, rope=True,
                                         use_bias=False,
                                         tie_embeddings=False),
    # d 32: wo (32 x 32) falls under min_size and stays float
    "small_wo": jax_gpt.gpt_tiny(d_model=32),
}


def _models(name):
    jcfg = JAX_CONFIGS[name]
    jmodel = jax_gpt.GPT(jcfg, seed=0)
    state = random_state(jmodel, seed=1)
    jmodel.set_state_dict({k: jnp.asarray(v) for k, v in state.items()})
    return jmodel, gpt_from_jax_state(port_config(jcfg), state,
                                      device="cpu")


def _port_name(jax_name):
    return (f"stacked.{jax_name.split('.')[-1]}"
            if jax_name.startswith("blocks.") else jax_name)


@pytest.mark.parametrize("name", sorted(JAX_CONFIGS))
def test_quantize_for_inference_matches_jax(name, monkeypatch):
    """The same weights are selected (the JAX planner's matmul weights
    at >= min_size elements per layer: block slabs, an untied LM head;
    never wte/wpe), each layer's q and scale are JAX's, the logits agree
    (JAX dequantizes first, the port scales after: fp32 rounding apart),
    and every quantized product goes through K12's wrapper."""
    jmodel, model = _models(name)
    jq = jax_quant.quantize_for_inference(jmodel)
    qp, _ = jq.split_params()
    jax_sel = {_port_name(n) for n, v in qp.items()
               if isinstance(v, jax_quant.QuantTensor)}
    qmodel = quant.quantize_for_inference(model)
    sel = {f"stacked.{n}" if n in gpt.block_param_specs(model.cfg) else n
           for n in qmodel.quantized}
    assert sel == jax_sel
    assert {"wte", "wpe"}.isdisjoint(sel)
    assert ("lm_head" in sel) == (not model.cfg.tie_embeddings)
    for n in qmodel.quantized:
        if n == "lm_head":
            pairs = [(qmodel.quantized[n], qp[n])]
        else:
            pairs = [(qt, qp[f"blocks.item_{i}.{n}"])
                     for i, qt in enumerate(qmodel.quantized[n])]
        for qt, jqt in pairs:
            np.testing.assert_array_equal(qt.q.numpy(), np.asarray(jqt.q))
            np.testing.assert_array_equal(qt.scale.numpy(),
                                          np.asarray(jqt.scale))
    calls = []
    orig = quant.int8_matmul
    monkeypatch.setattr(quant, "int8_matmul",
                        lambda *a: calls.append(1) or orig(*a))
    toks = np.random.RandomState(2).randint(0, 256, size=(2, 24))
    got = qmodel(torch.from_numpy(toks)).numpy()
    # jitted (op by op the forward takes several times longer)
    want = np.asarray(jax.jit(lambda t: jq(t))(jnp.asarray(toks)))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    per_layer = sum(n in gpt.block_param_specs(model.cfg)
                    for n in qmodel.quantized)
    assert len(calls) == (model.cfg.n_layers * per_layer
                          + ("lm_head" in qmodel.quantized))
    # the float model is untouched and still a trainable stack
    assert all(isinstance(p, torch.nn.Parameter)
               for p in model.stacked.values())


def test_quantize_for_inference_include_and_errors():
    """A model whose every matmul weight is under the size floor has
    nothing to quantize; an int8 model does not train."""
    cfg = gpt.GPTConfig(vocab_size=64, max_seq_len=16, d_model=8,
                        n_layers=1, n_heads=2, dtype=torch.float32)
    with pytest.raises(ValueError, match="no weight"):
        quant.quantize_for_inference(gpt.GPT(cfg, device="cpu"))
    _, model = _models("llama_style_tiny")
    qmodel = quant.quantize_for_inference(model)
    with pytest.raises(NotImplementedError, match="does not train"):
        gpt.fused_lm_loss(qmodel, torch.zeros((1, 8), dtype=torch.int64))
