"""Explicit-key RNG with named streams (counterpart of
``paddle_tpu/random.py``), over a torch copy of ``jax.random``'s
default Threefry-2x32 generator.

A key is a (2,) int64 tensor holding two uint32 words, as the raw
``jax.random.PRNGKey`` array holds them. Every function below gives the
JAX function's numbers bit for bit (jax 0.9, ``jax_threefry_partitionable``
on, its default):

- ``PRNGKey(seed)``: ``(0, seed)`` for a seed in int32 range, else
  ``(seed >> 32, seed & 0xFFFFFFFF)``;
- ``fold_in(key, d)``: ``threefry2x32(key, (0, d))`` (a Python int
  ``d`` must fit a uint32, as in JAX);
- ``split(key, n)``: ``threefry2x32(key, (hi, lo))`` over the flat
  indices 0..n-1 split into two 32-bit words; key i is the pair of
  outputs at i;
- ``bits(key, shape)``: the same counters over the flat index of each
  element, the two outputs XORed;
- ``uniform``: ``bitcast((bits >> (rng_bits - nmant)) | bits(1.0)) -
  1`` in the dtype, over the low ``rng_bits`` of each word (32 for
  fp32, 16 for fp16, 8 for bf16), then scaled to [minval, maxval);
- ``bernoulli(key, p, shape)``: ``uniform(key, shape) < p`` in fp32.

torch on the CPU has no uint32 ``>>``, so the words live in int64 and
every sum and left shift is masked with ``& 0xFFFFFFFF`` (as
``ops/_hash.py`` does). The hash takes Python ints as well as tensors:
a key on the CPU is derived in Python ints (``fold_in`` then launches
nothing), a key on another device in tensor ops there.
``bits`` and the draws run on ``device``. Without one they run on a
card key's device, and for a CPU key on the card, as every entry point
of the port does (``device.resolve``: it raises without CUDA; the CPU
parity tests pass ``device="cpu"``). So a host key draws a mask on the
card without a transfer of the mask.

The tracker API (``RNGStatesTracker``, ``seed``, ``next_key``,
``split_key``, ``get_rng_state``, ``set_rng_state``, ``rng_state``,
``add_rng_stream``) keeps named streams of a seed and a draw counter;
``next_key`` is ``fold_in(PRNGKey(seed), counter)``.
"""

import contextlib
import math
from typing import Dict, Optional

import torch

from paddle_tpu_torch import device as device_lib

__all__ = ["PRNGKey", "fold_in", "split", "bits", "uniform",
           "bernoulli", "threefry2x32", "RNGStatesTracker",
           "default_tracker", "seed", "next_key", "split_key",
           "get_rng_state", "set_rng_state", "rng_state",
           "add_rng_stream"]

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rounds(x0, x1, rots):
    for r in rots:
        x0 = (x0 + x1) & _M32
        x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
        x1 = x1 ^ x0
    return x0, x1


def threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1)
    under the key words (k1, k2): uint32 values held in Python ints or
    int64 tensors. Returns the two output words."""
    k3 = k1 ^ k2 ^ 0x1BD11BDA
    ks = (k1, k2, k3)
    x0 = (x0 + k1) & _M32
    x1 = (x1 + k2) & _M32
    for i in range(5):
        x0, x1 = _rounds(x0, x1, _ROT[i % 2])
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _words(key):
    """The key's two words: Python ints for a CPU key, 0-dim tensors
    otherwise (reading them would wait for the device)."""
    key = torch.as_tensor(key)
    if key.shape != (2,):
        raise ValueError(f"a key is a (2,) tensor, got {tuple(key.shape)}")
    if key.device.type == "cpu":
        k1, k2 = (int(v) & _M32 for v in key.tolist())
        return k1, k2
    key = key.to(torch.int64) & _M32
    return key[0], key[1]


def _key(w0, w1, device):
    if isinstance(w0, int):
        return torch.tensor([w0, w1], dtype=torch.int64, device=device)
    return torch.stack([w0, w1]).to(torch.int64)


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """The raw key of ``jax.random.PRNGKey(seed)`` (default on the
    CPU: its words are host ints, so ``fold_in`` launches nothing; the
    draws still go to the card)."""
    seed = int(seed)
    hi = 0 if -2 ** 31 <= seed < 2 ** 31 else (seed >> 32) & _M32
    return torch.tensor([hi, seed & _M32], dtype=torch.int64,
                        device=device)


def fold_in(key, data) -> torch.Tensor:
    """``jax.random.fold_in``: a new key from ``key`` and an integer
    (read as uint32), on the key's device. A Python int must fit a
    uint32 (JAX raises ``OverflowError`` otherwise); an integer tensor
    or numpy integer wraps, as a JAX integer array does."""
    if isinstance(data, int) and not 0 <= data <= _M32:
        raise OverflowError(f"Python integer {data} out of bounds for "
                            f"uint32")
    key = torch.as_tensor(key)
    k1, k2 = _words(key)
    if isinstance(k1, int) or not isinstance(data, torch.Tensor):
        data = int(data) & _M32
    else:
        data = data.to(device=key.device, dtype=torch.int64) & _M32
    return _key(*threefry2x32(k1, k2, 0, data), key.device)


def _iota(n: int, device):
    """The flat indices 0..n-1 as (hi, lo) uint32 words."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    if n <= 2 ** 32:
        return 0, idx
    return idx >> 32, idx & _M32


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (num, 2) keys, on the key's device."""
    key = torch.as_tensor(key)
    k1, k2 = _words(key)
    hi, lo = _iota(num, key.device)
    return torch.stack(threefry2x32(k1, k2, hi, lo), dim=1)


def bits(key, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32): an int64 tensor of
    ``shape`` holding the words, on ``device`` (default: a card key's
    device, else the card)."""
    key = torch.as_tensor(key)
    shape = tuple(int(s) for s in shape)
    if device is None and key.device.type != "cpu":
        dev = key.device
    else:
        dev = device_lib.resolve(device)
    k1, k2 = _words(key)
    if not isinstance(k1, int):
        k1, k2 = k1.to(dev), k2.to(dev)
    hi, lo = _iota(math.prod(shape), dev)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return (b1 ^ b2).reshape(shape)


_UINT_VIEW = {16: torch.int16, 32: torch.int32}


def uniform(key, shape=(), dtype=torch.float32, minval=0.0, maxval=1.0,
            device=None) -> torch.Tensor:
    """``jax.random.uniform`` in fp32, bf16 or fp16, on ``device`` as
    ``bits``."""
    fi = torch.finfo(dtype)
    nbits = fi.bits
    if nbits not in _UINT_VIEW:
        raise TypeError(f"uniform takes a 16- or 32-bit float, not {dtype}")
    nmant = int(round(-math.log2(fi.eps)))
    # the low rng_bits of each word: 8 where the mantissa is shorter
    # (bf16), else the dtype's width
    rng_bits = 8 if nmant < 8 else nbits
    b = bits(key, shape, device)
    if rng_bits < 32:
        b = b & ((1 << rng_bits) - 1)
    # the exponent of 1.0 over random mantissa bits: [1, 2), whose top
    # bit is 0, so the word fits the signed integer of its width
    one = torch.tensor(1.0, dtype=dtype).view(_UINT_VIEW[nbits]).item()
    fb = (b >> (rng_bits - nmant)) | one
    floats = fb.to(_UINT_VIEW[nbits]).view(dtype) - torch.tensor(
        1.0, dtype=dtype, device=fb.device)
    if minval == 0.0 and maxval == 1.0:
        return floats
    lo = torch.tensor(minval, dtype=dtype, device=fb.device)
    hi = torch.tensor(maxval, dtype=dtype, device=fb.device)
    # floats * (hi - lo) + lo rounded once, as XLA fuses it into an FMA:
    # the fp32 product is exact in fp64
    scaled = (floats.double() * (hi - lo).double() + lo.double()).to(dtype)
    return torch.maximum(lo, scaled)


def bernoulli(key, p=0.5, shape=(), device=None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` for a float ``p`` (fp32,
    the JAX dtype of a Python float): a bool tensor, on ``device`` as
    ``bits``."""
    u = uniform(key, shape, torch.float32, device=device)
    return u < torch.tensor(float(p), dtype=torch.float32, device=u.device)


# ---------------------------------------------------------------------------
# Named streams (paddle_tpu/random.py)
# ---------------------------------------------------------------------------

class _Stream:
    __slots__ = ("seed", "counter")

    def __init__(self, seed: int):
        self.seed = seed
        self.counter = 0


class RNGStatesTracker:
    """Named RNG streams: each a seed and a draw counter."""

    def __init__(self):
        self._streams: Dict[str, _Stream] = {"global": _Stream(0)}
        self._current = "global"

    def add(self, name: str, seed: int) -> None:
        if name in self._streams and self._streams[name].seed != seed:
            raise ValueError(f"stream {name!r} already added with a "
                             f"different seed")
        self._streams.setdefault(name, _Stream(seed))

    @contextlib.contextmanager
    def rng_state(self, name: str = "model_parallel"):
        if name not in self._streams:
            raise KeyError(f"unknown rng stream {name!r}; call add() first")
        prev, self._current = self._current, name
        try:
            yield
        finally:
            self._current = prev

    def next_key(self, stream: Optional[str] = None) -> torch.Tensor:
        s = self._streams[stream or self._current]
        s.counter += 1
        return fold_in(PRNGKey(s.seed), s.counter)

    def state_dict(self):
        return {k: (v.seed, v.counter) for k, v in self._streams.items()}

    def load_state_dict(self, state):
        for k, (seed_, counter) in state.items():
            st = self._streams.setdefault(k, _Stream(seed_))
            st.seed, st.counter = seed_, counter


_tracker = RNGStatesTracker()


def default_tracker() -> RNGStatesTracker:
    return _tracker


def seed(s: int) -> None:
    """Set the global stream's seed; every stream's counter restarts."""
    _tracker._streams["global"] = _Stream(int(s))
    for name, st in _tracker._streams.items():
        if name != "global":
            st.counter = 0


def next_key(stream: Optional[str] = None) -> torch.Tensor:
    """The next key of a named stream (default: the current one)."""
    return _tracker.next_key(stream)


def split_key(key=None, num: int = 2) -> torch.Tensor:
    return split(key if key is not None else next_key(), num)


def get_rng_state():
    return _tracker.state_dict()


def set_rng_state(state):
    _tracker.load_state_dict(state)


@contextlib.contextmanager
def rng_state(name: str):
    """Switch the active named stream."""
    with _tracker.rng_state(name):
        yield


def add_rng_stream(name: str, seed_: int) -> None:
    _tracker.add(name, seed_)
