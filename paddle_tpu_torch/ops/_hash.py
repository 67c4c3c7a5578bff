"""The dropout hash the kernels share: the lowbias32 integer PRF.

The port's own copy of the keep masks of the JAX package's Pallas
kernels, bit for bit:

- ``layer_norm_keep`` is ``dropout_keep_mask`` of
  ``paddle_tpu/ops/pallas/layer_norm.py`` (K11): over the flattened
  (M, N) tensor, ``lin = row * N + col`` and the hash
  ``mix(mix(lin ^ seed))``;
- ``attention_keep`` is ``_keep_mask`` of
  ``paddle_tpu/ops/pallas/flash_attention.py`` (K1, K3, K4): ``lin =
  row * stride + col`` with ``stride`` the key length JAX pads to
  (``jax_key_stride``), and the hash ``mix(mix(lin ^ seed) ^ bh)``,
  ``bh = b * Hq + h`` over query heads.

Both keep a cell when its hash is at least ``keep_threshold(rate)``.
Every step is uint32 arithmetic; the int32 seed is read as uint32, so a
negative seed wraps. A seed is a Python int or a 0-dim integer tensor
(``seed_tensor``): the kernels read it from the device, so a seed drawn
on the card never waits for it. torch on the CPU has no uint32 ``>>``
or ``>=``, so the plain versions hash in int64 and mask with
``& 0xFFFFFFFF``; a 32-bit product is formed from two 16-bit halves
of the constant, so no int64 product overflows. The CUDA kernels compute the same hash in
``csrc/common.cuh`` (``pt::mix``, ``pt::AttnExtra``); their wrappers pass
``keep_threshold`` and a pointer to the seed.
"""

import torch

__all__ = ["keep_threshold", "mix", "layer_norm_keep", "attention_keep",
           "jax_key_stride", "seed_tensor"]

_M32 = 0xFFFFFFFF
_C1 = 0x7FEB352D
_C2 = 0x846CA68B


def keep_threshold(rate: float) -> int:
    """The uint32 threshold a cell's hash must reach to be kept, in
    Python floats as the JAX kernels compute it."""
    return min(int(rate * 2.0 ** 32), 2 ** 32 - 1)


def _mul32(x, c):
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a 32-bit c."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def mix(x):
    """lowbias32 on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 15)
    x = _mul32(x, _C2)
    return x ^ (x >> 16)


def seed_tensor(seed, device) -> torch.Tensor:
    """``seed`` as the 0-dim int32 tensor on ``device`` the kernels read:
    an int's low 32 bits (a fill, with no copy from the host that waits
    for the card), or an integer tensor cast and moved."""
    if isinstance(seed, torch.Tensor):
        if seed.numel() != 1 or seed.is_floating_point():
            raise ValueError(f"a seed tensor holds one integer, got "
                             f"{seed.dtype} {tuple(seed.shape)}")
        return seed.reshape(()).to(device=device, dtype=torch.int32)
    s = int(seed) & _M32
    return torch.full((), s - (1 << 32) if s >> 31 else s,
                      dtype=torch.int32, device=device)


def _u32(seed, device):
    """The seed as uint32 in int64: an int, or a 0-dim tensor on
    ``device``."""
    if isinstance(seed, torch.Tensor):
        return seed.reshape(()).to(device=device, dtype=torch.int64) & _M32
    return int(seed) & _M32


def layer_norm_keep(seed, shape, rate: float, device=None,
                    row0: int = 0):
    """(M, N) bool keep mask of K11's dropout for rows ``row0``.. of the
    flattened tensor."""
    m, n = shape
    r = torch.arange(row0, row0 + m, dtype=torch.int64, device=device)
    c = torch.arange(n, dtype=torch.int64, device=device)
    lin = (r[:, None] * n + c[None, :]) & _M32
    h = mix(mix(lin ^ _u32(seed, lin.device)))
    return h >= keep_threshold(rate)


def jax_key_stride(sk: int) -> int:
    """The key length the JAX flash kernel pads Sk to with its default
    blocks, which is the row stride of its dropout mask: block_k =
    min(512, round_up(Sk, 128)), then Sk rounded up to block_k (Sk 512
    -> 512, 200 -> 256, 600 -> 1024)."""
    bk = min(512, -(-sk // 128) * 128)
    return -(-max(sk, bk) // bk) * bk


def attention_keep(seed, b: int, hq: int, sq: int, sk: int,
                   rate: float, stride: int, device=None):
    """(B, Hq, Sq, Sk) bool keep mask of the attention dropout."""
    r = torch.arange(sq, dtype=torch.int64, device=device)
    c = torch.arange(sk, dtype=torch.int64, device=device)
    lin = (r[:, None] * stride + c[None, :]) & _M32
    bh = torch.arange(b * hq, dtype=torch.int64,
                      device=device).reshape(b, hq, 1, 1)
    h = mix(mix(lin ^ _u32(seed, lin.device))[None, None] ^ bh)
    return h >= keep_threshold(rate)
