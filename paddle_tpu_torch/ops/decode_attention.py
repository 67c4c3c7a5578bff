"""Flash-decode attention over a head-major contiguous KV cache (kernel
K10) and its plain PyTorch version.

Counterpart of ``paddle_tpu/ops/pallas/decode_attention.py``: the CUDA
kernel in ``csrc/decode_attention.cu`` replaces the TPU kernel
``_kernel`` (the ``pl.pallas_call`` at decode_attention.py:258); its
source note says what bounds it on the H100 and what the design does
about that. The JAX package's ``fold_fresh_row`` has no counterpart:
the port's one-token decode writes the fresh row before K10 reads it
(``GPTBlock.decode_step``), so nothing folds a row into (m, l).

CUDA tensors launch the kernel; CPU tensors run the plain version. The
TPU kernel's ``block_k`` has no counterpart: the kernel walks the valid
rows in its own steps.
"""

import ctypes
import math

import torch

from paddle_tpu_torch.ops import _build

__all__ = ["decode_attention", "decode_attention_reference",
           "MAX_GROUP", "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 128
MAX_GROUP = 8
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MASK_FLOOR = -1e30
_LANES = 128


def decode_attention_reference(q, k_cache, v_cache, lengths, scale=None,
                               return_stats=False):
    """Plain PyTorch version of K10: scores in fp32, a softmax masked to
    each row's first lengths[b] cache entries, p rounded to the cache
    dtype before the value product (as the kernel and the TPU kernel
    round it). m (the max; -inf for an empty row) and l (the
    denominator) are (B, Hq) fp32; an empty row gives o = 0."""
    b, hq, d = q.shape
    hkv, T = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, hkv, group, d).float()
    s = torch.einsum("bhgd,bhtd->bhgt", qg, k_cache.float()) * scale
    valid = (torch.arange(T, device=q.device)[None, :]
             < lengths.long()[:, None])
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1)
    p = torch.exp(s - m.clamp(min=_MASK_FLOOR)[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhgt,bhtd->bhgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    o = o / torch.where(l == 0, torch.ones_like(l), l)[..., None]
    o = o.reshape(b, hq, d).to(q.dtype)
    if return_stats:
        return o, m.reshape(b, hq), l.reshape(b, hq)
    return o


def _lib():
    lib = _build.load("decode_attention")
    fn = lib.pt_decode_attention
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i,
                       ctypes.c_float, i, vp]
        fn.restype = ctypes.c_int
    return lib


def _check_operands(q, k_cache, v_cache, lengths):
    """Shape checks everywhere; device/dtype/contiguity checks before
    pointers go to C."""
    if (q.dim() != 3 or k_cache.dim() != 4
            or k_cache.shape != v_cache.shape):
        raise ValueError(f"need q (B,Hq,D) and caches (B,Hkv,T,D), got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}")
    b, hq, d = q.shape
    hkv, T = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != b or k_cache.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and caches "
                         f"{tuple(k_cache.shape)} disagree on B or D")
    if hq % hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {hq} vs {hkv}")
    if T % _LANES:
        raise ValueError(f"cache length {T} must be a multiple of "
                         f"{_LANES}")
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be ({b},), got "
                         f"{tuple(lengths.shape)}")
    if q.device.type != "cuda":
        return
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"decode attention kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    if d > MAX_HEAD_DIM or hq // hkv > MAX_GROUP:
        raise ValueError(f"decode attention kernel takes head_dim <= "
                         f"{MAX_HEAD_DIM} and Hq/Hkv <= {MAX_GROUP}, got "
                         f"{d} and {hq // hkv}")
    for name, t, want in (("q", q, q.dtype), ("k_cache", k_cache, q.dtype),
                          ("v_cache", v_cache, q.dtype),
                          ("lengths", lengths, torch.int32)):
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")


def _launch(q, k_cache, v_cache, lengths, scale, stats):
    b, hq, d = q.shape
    hkv, T = k_cache.shape[1], k_cache.shape[2]
    o = torch.empty_like(q)
    m = l = None
    if stats:
        m = torch.empty((b, hq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    if b == 0:
        return o, m, l
    lib = _lib()
    decode_attention.launches += 1
    vec = 16 // q.element_size()
    vec_ok = int(d % vec == 0 and all(
        t.data_ptr() % 16 == 0 for t in (q, k_cache, v_cache, o)))
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.pt_decode_attention(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), lengths.data_ptr(), o.data_ptr(), ptr(m),
            ptr(l), b, hq, hkv, T, d, float(scale), vec_ok, stream)
    _build.check(lib, rc, "decode_attention launch")
    return o, m, l


def decode_attention(q, k_cache, v_cache, lengths, scale=None,
                     return_stats=False):
    """One decode step of cached attention for B sequences at once (K10).

    q (B, Hq, D); k_cache/v_cache (B, Hkv, T, D) head-major, T a
    multiple of 128, Hq % Hkv == 0; lengths (B,) int32: row b attends to
    cache positions [0, lengths[b]). scale defaults to 1/sqrt(D).
    Returns o (B, Hq, D) in q's dtype, and with ``return_stats`` also m,
    l (B, Hq) fp32: the running max (-inf for an empty row) and the
    softmax denominator, as the TPU kernel gives them. On CUDA, q and
    the caches share one dtype."""
    _check_operands(q, k_cache, v_cache, lengths)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, lengths,
                                          scale, return_stats)
    o, m, l = _launch(q, k_cache, v_cache, lengths, scale, return_stats)
    return (o, m, l) if return_stats else o


decode_attention.launches = 0
