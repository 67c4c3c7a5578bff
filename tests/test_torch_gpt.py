"""The port's GPT against the JAX package's: the same numpy weights
through ``gpt_from_jax_state`` give the same logits (fp32, CPU), for
gpt_tiny and for a tiny GQA + rope + untied + bias-free config; the
converter refuses a missing or unexpected key; the random init is
seeded and the per-layer weights are views of the stacked slabs; an
MoE config builds and the engines refuse it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import gpt as jax_gpt
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.models.convert import gpt_from_jax_state
from torch_reference_compile import fast_reference_compiles  # noqa: F401

# fp32 both sides; 2 layers of matmuls/softmax in a different order
ATOL = RTOL = 1e-4

_CFG_FIELDS = ("vocab_size", "max_seq_len", "d_model", "n_layers",
               "n_heads", "ffn_mult", "use_bias", "tie_embeddings",
               "n_kv_heads", "rope", "rope_theta", "moe_experts",
               "moe_every", "moe_aux_weight", "moe_gate")

JAX_CONFIGS = {
    "gpt_tiny": jax_gpt.gpt_tiny(),
    "gqa_rope_untied": jax_gpt.gpt_tiny(n_heads=4, n_kv_heads=2, rope=True,
                                        use_bias=False,
                                        tie_embeddings=False),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def port_config(jcfg, dtype=torch.float32):
    return gpt.GPTConfig(**{f: getattr(jcfg, f) for f in _CFG_FIELDS},
                         dtype=dtype)


def random_state(jmodel, seed, std=0.1):
    """The JAX model's parameter names with seeded random values (LN
    scales around 1, everything else N(0, std)): zero biases and unit
    scales would leave parts of the mapping untested."""
    rs = np.random.RandomState(seed)
    out = {}
    for k, v in sorted(jmodel.state_dict().items()):
        noise = rs.randn(*v.shape).astype(np.float32)
        out[k] = (1.0 + 0.1 * noise) if "scale" in k else std * noise
    return out


@pytest.mark.parametrize("name", sorted(JAX_CONFIGS))
def test_logits_match_jax(name):
    jcfg = JAX_CONFIGS[name]
    jmodel = jax_gpt.GPT(jcfg, seed=0)
    state = random_state(jmodel, seed=1)
    jmodel.set_state_dict({k: jnp.asarray(v) for k, v in state.items()})
    model = gpt_from_jax_state(port_config(jcfg), state, device="cpu")
    toks = np.random.RandomState(2).randint(0, jcfg.vocab_size,
                                            size=(2, 40))
    # jitted (op by op the forward takes several times longer)
    want = np.asarray(jax.jit(lambda t: jmodel(t))(jnp.asarray(toks)))
    got = model(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert port_config(jcfg).num_params() == jcfg.num_params()


def test_convert_rejects_missing_and_unexpected_keys():
    jcfg = JAX_CONFIGS["gpt_tiny"]
    state = random_state(jax_gpt.GPT(jcfg, seed=0), seed=3)
    cfg = port_config(jcfg)
    missing = dict(state)
    del missing["blocks.item_1.wup"]
    with pytest.raises(KeyError, match="blocks.item_1.wup"):
        gpt_from_jax_state(cfg, missing, device="cpu")
    extra = dict(state, lm_head=np.zeros((64, 256), np.float32))
    with pytest.raises(KeyError, match="lm_head"):
        gpt_from_jax_state(cfg, extra, device="cpu")
    bad = dict(state, wte=np.zeros((255, 64), np.float32))
    with pytest.raises(ValueError, match="wte"):
        gpt_from_jax_state(cfg, bad, device="cpu")


def test_seeded_init_and_stacked_views():
    cfg = gpt.gpt_tiny()
    a = gpt.GPT(cfg, seed=5, device="cpu")
    b = gpt.GPT(cfg, seed=5, device="cpu")
    c = gpt.GPT(cfg, seed=6, device="cpu")
    assert torch.equal(a.stacked["wqkv"], b.stacked["wqkv"])
    assert not torch.equal(a.stacked["wqkv"], c.stacked["wqkv"])
    for i, w in enumerate(a.layer_weights()):
        assert w["wqkv"].data_ptr() == a.stacked["wqkv"][i].data_ptr()
    # the JAX init's shapes and constants
    assert a.stacked["wqkv"].shape == (2, 64, 192)
    assert torch.equal(a.stacked["ln1_scale"], torch.ones(2, 64))
    assert a.lm_head is None and a.wpe.shape == (64, 64)


def test_presets_match_jax_presets():
    for name in ("gpt_tiny", "gpt3_125m", "gpt3_350m", "gpt3_1p3b",
                 "llama_style_1b"):
        jcfg = getattr(jax_gpt, name)()
        cfg = getattr(gpt, name)()
        for f in _CFG_FIELDS:
            assert getattr(cfg, f) == getattr(jcfg, f), (name, f)
        assert cfg.num_params() == jcfg.num_params()
        assert str(cfg.dtype).split(".")[-1] == jnp.dtype(jcfg.dtype).name


def test_moe_config_builds_and_engines_refuse():
    """An MoE config builds a per-layer model; both engines refuse it, as
    the JAX engines do (``inference/decode_engine.py:113-117``)."""
    from paddle_tpu_torch.inference.factory import make_engine
    cfg = dataclasses.replace(gpt.gpt_tiny(), moe_experts=4)
    model = gpt.GPT(cfg, device="cpu")
    assert model.slab_entries() == [] and "moe" in model.layer_weights()[1]
    for engine in ("paged", "contiguous"):
        with pytest.raises(NotImplementedError, match="dense"):
            make_engine(model, engine=engine, device="cpu")
