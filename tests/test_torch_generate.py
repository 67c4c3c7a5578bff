"""The port's cached decode and ``GPT.generate`` against the JAX
package's: incremental decode against the full forward (dense and K10
routes), greedy ``generate`` streams identical to JAX's on a 2-layer
fp32 model at std 0.5 with a 1024 cache (both take the flash-decode
route), eos padding, the top-k/top-p kept set against JAX's on the same
logits, and sampling from an explicit ``torch.Generator``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import gpt as jax_gpt
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.models.convert import gpt_from_jax_state
from torch_reference_compile import fast_reference_compiles  # noqa: F401

# fp32 both sides; 2 layers of matmuls and softmax in another order
ATOL = RTOL = 1e-4
# at the JAX init (std 0.02) greedy streams of a tiny model repeat one
# token; std 0.5 makes stream equality mean something
WEIGHT_STD = 0.5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _models(max_seq, seed=0, **kw):
    fields = dict(vocab_size=96, max_seq_len=max_seq, d_model=32,
                  n_layers=2, n_heads=4, **kw)
    jmodel = jax_gpt.GPT(jax_gpt.GPTConfig(dtype=jnp.float32, **fields),
                         seed=0)
    rs = np.random.RandomState(seed)
    state = {}
    for k, v in sorted(jmodel.state_dict().items()):
        noise = rs.randn(*v.shape).astype(np.float32)
        state[k] = (1.0 + 0.1 * noise) if "scale" in k else (
            WEIGHT_STD * noise)
    jmodel.set_state_dict({k: jnp.asarray(v) for k, v in state.items()})
    cfg = gpt.GPTConfig(dtype=torch.float32, **fields)
    return jmodel, gpt_from_jax_state(cfg, state, device="cpu")


@pytest.fixture(scope="module")
def models_1024():
    return _models(1024)


@pytest.mark.parametrize("max_seq, kw", [
    (128, {}), (1024, {}),
    (1024, dict(n_kv_heads=2, rope=True, use_bias=False,
                tie_embeddings=False))])
def test_incremental_decode_matches_full_forward(max_seq, kw):
    """Prefill + one-token steps through ``forward_cached`` give the
    full forward's logits at every position; at T 1024 the steps go
    through ``decode_step``'s K10 route, with GQA + rope too."""
    _, model = _models(max_seq, **kw)
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, 96, size=(2, 20)))
    want = model(toks)
    cache = model.init_cache(2)
    logits, cache = model.forward_cached(toks[:, :12], cache, 0)
    got = [logits]
    for t in range(12, 20):
        logits, cache = model.forward_cached(toks[:, t:t + 1], cache, t)
        got.append(logits)
    torch.testing.assert_close(torch.cat(got, dim=1), want, atol=ATOL,
                               rtol=RTOL)
    # the caches hold the prompt's K/V rows; the rest stays zero
    assert (cache[0][0][:, :, 20:] == 0).all()
    assert (cache[0][0][:, :, :20].abs().sum(-1) > 0).all()


def test_decode_rows_kernel_route_equals_dense_route(models_1024):
    """One-token decode over a 1024 cache: ``decode_step``'s K10 route
    (row written, then attention over [0, pos + 1)) equals the dense
    route (``verify_step``: the einsum over the prefix and the fresh
    row, then the write), with ragged positions and an empty prefix; a
    row marked not to write keeps its cache entry."""
    _, model = models_1024
    rs = np.random.RandomState(2)
    kc = torch.from_numpy(rs.randn(3, 4, 1024, 8).astype(np.float32))
    vc = torch.from_numpy(rs.randn(3, 4, 1024, 8).astype(np.float32))
    x = torch.from_numpy(rs.randn(3, 1, 32).astype(np.float32))
    pos = torch.tensor([0, 7, 1000], dtype=torch.int32)
    w = model.layer_weights()[0]
    write = torch.tensor([True, False, True])
    kv_k = (kc.clone(), vc.clone())
    kv_d = (kc.clone(), vc.clone())
    rows = gpt.cache_rows(pos, 1, 1024, write)
    y_k, _ = model.block.decode_step(x, w, kv_k, rows)
    y_d, _ = model.block.verify_step(x, w, kv_d, rows)
    for r in (0, 2):
        torch.testing.assert_close(y_k[r], y_d[r], atol=ATOL, rtol=RTOL)
    for got, want, old in zip(kv_k, kv_d, (kc, vc)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
        torch.testing.assert_close(got[1], old[1], atol=0, rtol=0)
        assert not torch.equal(got[0, :, 0], old[0, :, 0])


@pytest.mark.parametrize("positions, K, want_t, want_len", [
    ([0, 5], 1, [[0], [5]], [1, 6]),
    # an idle slot past the cache: its write clamps to the last row and
    # attention reads at most T rows
    ([126, 128], 1, [[126], [127]], [127, 128]),
    # a window that would pass the end slides back over written rows
    ([0, 126], 4, [[0, 1, 2, 3], [124, 125, 126, 127]], [4, 128]),
])
def test_cache_rows_window_and_lengths(positions, K, want_t, want_len):
    rows = gpt.cache_rows(torch.tensor(positions, dtype=torch.int32), K, 128)
    assert rows.t.tolist() == want_t and rows.bi.tolist() == [[0], [1]]
    assert rows.lengths.tolist() == want_len
    assert rows.lengths.dtype == torch.int32 and rows.write is None


def test_verify_step_write_mask_keeps_unmarked_rows(models_1024):
    """A K-row write with a mask writes the marked row's window and
    leaves every entry of the unmarked row as it was."""
    _, model = models_1024
    rs = np.random.RandomState(4)
    kc = torch.from_numpy(rs.randn(2, 4, 128, 8).astype(np.float32))
    vc = torch.from_numpy(rs.randn(2, 4, 128, 8).astype(np.float32))
    x = torch.from_numpy(rs.randn(2, 3, 32).astype(np.float32))
    rows = gpt.cache_rows(torch.tensor([10, 40], dtype=torch.int32), 3, 128,
                          write=torch.tensor([True, False]))
    kv = (kc.clone(), vc.clone())
    model.block.verify_step(x, model.layer_weights()[0], kv, rows)
    for got, old in zip(kv, (kc, vc)):
        torch.testing.assert_close(got[1], old[1], atol=0, rtol=0)
        torch.testing.assert_close(got[0, :, :10], old[0, :, :10], atol=0,
                                   rtol=0)
        assert not torch.equal(got[0, :, 10:13], old[0, :, 10:13])


def test_greedy_generate_matches_jax(models_1024):
    jmodel, model = models_1024
    toks = np.random.RandomState(3).randint(0, 96, size=(2, 9))
    want = np.asarray(jmodel.generate(jnp.asarray(toks, jnp.int32),
                                      max_new_tokens=10))
    got = model.generate(toks, max_new_tokens=10)
    assert got.dtype == torch.int32 and got.shape == (2, 19)
    np.testing.assert_array_equal(got.numpy(), want)
    assert all(len(set(row[9:])) > 1 for row in want.tolist())


def test_eos_padding_matches_jax(models_1024):
    jmodel, model = models_1024
    toks = np.random.RandomState(3).randint(0, 96, size=(2, 9))
    free = model.generate(toks, max_new_tokens=10).numpy()
    eos = int(free[0, 12])
    want = np.asarray(jmodel.generate(jnp.asarray(toks, jnp.int32),
                                      max_new_tokens=10, eos_id=eos))
    got = model.generate(toks, max_new_tokens=10, eos_id=eos).numpy()
    np.testing.assert_array_equal(got, want)
    cut = 9 + list(free[0, 9:]).index(eos)
    assert (got[0, cut:] == eos).all()
    np.testing.assert_array_equal(got[0, :cut], free[0, :cut])


@pytest.mark.parametrize("temperature, top_k, top_p, vocab", [
    pytest.param(1.0, 5, 1.0, 96, id="1.0-5-1.0"),
    pytest.param(0.7, 0, 0.9, 96, id="0.7-0-0.9"),
    pytest.param(1.3, 20, 0.5, 96, id="1.3-20-0.5"),
    pytest.param(1.0, 0, 0.999, 96, id="1.0-0-0.999"),
    # top_k past the vocab: JAX's index clamps and keeps every logit
    pytest.param(1.0, 20, 1.0, 16, id="vocab16-1.0-20-1.0")])
def test_filter_kept_set_matches_jax(temperature, top_k, top_p, vocab,
                                     monkeypatch):
    """The JAX sampler's filtered logits are the ones it hands to
    ``jax.random.categorical``; the port keeps the same set and the same
    filtered values."""
    logits = np.random.RandomState(4).randn(6, vocab).astype(
        np.float32) * 3
    seen = {}

    def categorical(key, lg, axis=-1):
        seen["logits"] = np.asarray(lg)
        return jnp.argmax(lg, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", categorical)
    jax_gpt._sample_token(jnp.asarray(logits), jax.random.PRNGKey(0),
                          temperature, top_p, top_k)
    want = seen["logits"]
    got = gpt._filter_logits(torch.from_numpy(logits), temperature, top_p,
                             top_k).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    kept = ~np.isneginf(want)
    if top_k >= vocab and top_p >= 1.0:
        assert kept.all()
    else:
        assert 0 < kept.sum() < kept.size
    np.testing.assert_allclose(got[kept], want[kept], rtol=1e-6)


def test_sampling_reproducible_with_generator(models_1024):
    _, model = models_1024
    toks = np.random.RandomState(5).randint(0, 96, size=(2, 6))

    def run(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return model.generate(toks, max_new_tokens=12, temperature=1.0,
                              top_k=20, top_p=0.95, generator=g)

    a, b, c = run(11), run(11), run(12)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.equal(a, c)
    greedy = model.generate(toks, max_new_tokens=12)
    assert not torch.equal(a, greedy)


def test_top_k_one_equals_greedy(models_1024):
    _, model = models_1024
    toks = np.random.RandomState(6).randint(0, 96, size=(3, 5))
    greedy = model.generate(toks, max_new_tokens=8)
    g = torch.Generator()
    g.manual_seed(0)
    sampled = model.generate(toks, max_new_tokens=8, temperature=0.8,
                             top_k=1, generator=g)
    torch.testing.assert_close(sampled, greedy, atol=0, rtol=0)


def test_generate_bounds():
    _, model = _models(128)
    toks = np.zeros((1, 100), np.int64)
    with pytest.raises(ValueError, match="exceed cache length"):
        model.generate(toks, max_new_tokens=29)
    with pytest.raises(ValueError, match="position table"):
        model.generate(toks, max_new_tokens=8, max_len=256)
    with pytest.raises(ValueError, match=">= 1"):
        model.generate(toks, max_new_tokens=0)
    assert model.generate(toks, max_new_tokens=1).shape == (1, 101)
