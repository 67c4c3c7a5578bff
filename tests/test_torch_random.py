"""The port's Threefry keys and draws against ``jax.random``, on the CPU,
bit for bit (jax 0.9, ``jax_threefry_partitionable`` on): keys,
``fold_in``, ``split``, ``bits``, ``uniform`` (fp32, bf16, fp16) and
``bernoulli``, at odd sizes and at one of more than 2^16 elements; and
the named-stream tracker against ``paddle_tpu.random``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.random as jax_rng
from paddle_tpu_torch import random as prng

SHAPES = [(), (1,), (7,), (3, 5), (4, 8, 16), (3, 131, 257)]


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1, -1, -7])
def test_keys_and_fold_in(seed):
    k, jk = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    _eq(k, jk)
    for d in (0, 1, 2, 3, 1000, 2 ** 32 - 1):
        _eq(prng.fold_in(k, d), jax.random.fold_in(jk, d))
    _eq(prng.fold_in(prng.fold_in(k, 3), 2),
        jax.random.fold_in(jax.random.fold_in(jk, 3), 2))


def test_seed_past_int32_range():
    """A seed past int32 fills the high word, as JAX does with x64 on."""
    k = prng.PRNGKey(2 ** 40 + 5)
    assert k.tolist() == [2 ** 8, 5]


@pytest.mark.parametrize("num", [1, 2, 3, 64, 65, 1000])
def test_split(num):
    """The partitionable (foldlike) split: key i is threefry2x32(key,
    (0, i)); pinned against jax.random.split."""
    k = prng.fold_in(prng.PRNGKey(0), 9)
    jk = jax.random.fold_in(jax.random.PRNGKey(0), 9)
    got = prng.split(k, num)
    assert got.shape == (num, 2)
    _eq(got, jax.random.split(jk, num))
    w0, w1 = k.tolist()
    assert got[num - 1].tolist() == list(
        prng.threefry2x32(w0, w1, 0, num - 1))


@pytest.mark.parametrize("shape", SHAPES)
def test_bits_uniform_bernoulli(shape):
    k = prng.fold_in(prng.fold_in(prng.PRNGKey(0), 3), 2)
    jk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), 3), 2)
    _eq(prng.bits(k, shape, device="cpu"), jax.random.bits(jk, shape))
    for dt in ("float32", "bfloat16", "float16"):
        got = prng.uniform(k, shape, getattr(torch, dt),
                           device="cpu").float().numpy()
        want = np.asarray(jax.random.uniform(jk, shape, jnp.dtype(dt)),
                          np.float32)
        np.testing.assert_array_equal(got, want, err_msg=dt)
    got = prng.uniform(k, shape, minval=-2.0, maxval=3.0,
                       device="cpu").numpy()
    want = np.asarray(jax.random.uniform(jk, shape, minval=-2.0,
                                         maxval=3.0))
    np.testing.assert_array_equal(got, want)
    for p in (0.1, 0.5, 0.9):
        np.testing.assert_array_equal(
            prng.bernoulli(k, p, shape, device="cpu").numpy(),
            np.asarray(jax.random.bernoulli(jk, p, shape)))


def test_draw_on_another_device_than_a_cpu_key():
    """A CPU key draws on the card unless ``device=`` names another
    device, as every entry point of the port: without CUDA the default
    raises, ``device="cpu"`` draws here."""
    k = prng.PRNGKey(3)
    a = prng.bernoulli(k, 0.9, (5, 6), device="cpu")
    assert a.device.type == "cpu" and a.shape == (5, 6)
    draws = (lambda: prng.bits(k, (5, 6)),
             lambda: prng.uniform(k, (5, 6)),
             lambda: prng.bernoulli(k, 0.9, (5, 6)))
    for draw in draws:
        if torch.cuda.is_available():
            assert draw().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                draw()
    if torch.cuda.is_available():
        assert torch.equal(draws[2]().cpu(), a)


def test_tensor_path_equals_host_path():
    """A key held in tensors (as on a GPU) takes the tensor ops; the CPU
    key the Python ints: the same words. Forced here by hashing tensor
    words directly."""
    w0, w1 = prng.PRNGKey(11).tolist()
    x0 = torch.zeros(4, dtype=torch.int64)
    x1 = torch.arange(4)
    t = prng.threefry2x32(torch.tensor(w0), torch.tensor(w1), x0, x1)
    h = [prng.threefry2x32(w0, w1, 0, i) for i in range(4)]
    assert t[0].tolist() == [a for a, _ in h]
    assert t[1].tolist() == [b for _, b in h]


def test_tracker_matches_jax():
    prng.seed(5)
    jax_rng.seed(5)
    for _ in range(3):
        _eq(prng.next_key(), jax.random.key_data(jax_rng.next_key()))
    prng.add_rng_stream("model_parallel", 77)
    jax_rng.add_rng_stream("model_parallel", 77)
    with prng.rng_state("model_parallel"), \
            jax_rng.rng_state("model_parallel"):
        _eq(prng.next_key(), jax.random.key_data(jax_rng.next_key()))
    assert prng.get_rng_state() == {
        k: tuple(v) for k, v in jax_rng.get_rng_state().items()}
    state = prng.get_rng_state()
    a = prng.next_key()
    prng.set_rng_state(state)
    assert torch.equal(prng.next_key(), a)
    _eq(prng.split_key(prng.PRNGKey(1), 3),
        jax_rng.split_key(jax.random.PRNGKey(1), 3))
    with pytest.raises(KeyError):
        with prng.rng_state("absent"):
            pass
    with pytest.raises(ValueError):
        prng.add_rng_stream("model_parallel", 78)
    prng.seed(0)
