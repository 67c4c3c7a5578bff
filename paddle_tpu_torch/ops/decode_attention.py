"""Flash-decode attention over a head-major contiguous KV cache (kernel
K10) and its plain PyTorch version.

Counterpart of ``paddle_tpu/ops/pallas/decode_attention.py``: the CUDA
kernel ``flash_decode_sm90`` in ``csrc/decode_attention.cu`` replaces
the TPU kernel ``_kernel`` (the ``pl.pallas_call`` at
decode_attention.py:258); its source note says what bounds it on the
H100 and what the design does about that. The JAX package's
``fold_fresh_row`` has no counterpart: given the step's fresh rows
(``k_new``, ``v_new``), K10 writes them into the caches itself and
attends over them, so one-token decode needs no separate write.

CUDA tensors launch the kernel; CPU tensors run the plain version. The
TPU kernel's ``block_k`` has no counterpart: the kernel walks the valid
rows in its own tiles, each row split over a cluster of
``cluster_size(T)`` blocks.
"""

import ctypes
import math

import torch

from paddle_tpu_torch.ops import _build

__all__ = ["decode_attention", "decode_attention_reference",
           "write_fresh_rows", "cluster_size", "MAX_GROUP",
           "MAX_HEAD_DIM", "decode_attention_cost"]

MAX_HEAD_DIM = 128
MAX_GROUP = 8
MAX_SPLITS = 8
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MASK_FLOOR = -1e30
_LANES = 128


def cluster_size(T):
    """Blocks of the cluster that walks one (row, kv head) of a cache of
    length T: min(8, T // 256) rounded down to a power of two, at least
    1 (T 2048: 8, each block a share of the row's valid keys)."""
    s = 1
    while s < MAX_SPLITS and 2 * s * 256 <= T:
        s *= 2
    return s


def decode_attention_cost(lengths, n_heads, kv_heads, head_dim, elt=2,
                          return_stats=False, fresh_rows=False):
    """(flops, HBM bytes) of one K10 call: each row's ``lengths[b]`` K
    and V rows read once, q read and o written once, the lengths, and
    (m, l) in fp32 when returned; with ``fresh_rows`` each row's fresh K
    and V row written too (it is read from k_new in place of the cache).
    4 flops per head dim per (query head, key)."""
    rows = len(lengths)
    n_keys = sum(lengths)
    nbytes = (2 * n_keys * kv_heads * head_dim * elt
              + 2 * rows * n_heads * head_dim * elt + rows * 4)
    if return_stats:
        nbytes += 2 * rows * n_heads * 4
    if fresh_rows:
        nbytes += 2 * rows * kv_heads * head_dim * elt + rows
    return 4 * n_keys * n_heads * head_dim, nbytes


def write_fresh_rows(k_cache, v_cache, lengths, k_new, v_new, write=None):
    """Plain PyTorch version of K10's write, in place: row
    ``lengths[b] - 1`` of each cache gets ``k_new[b]`` / ``v_new[b]``
    ((B, Hkv, D)) where ``write[b]`` holds (every row when ``write`` is
    None) and the row is not empty; other rows keep their entries. Index
    ops only, so it stays on the device without a sync."""
    b = k_cache.shape[0]
    bi = torch.arange(b, device=k_cache.device)
    t = (lengths.long() - 1).clamp(min=0)
    keep = lengths > 0
    if write is not None:
        keep = keep & write
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        new = torch.where(keep[:, None, None], new.to(cache.dtype),
                          cache[bi, :, t, :])
        cache[bi, :, t, :] = new


def decode_attention_reference(q, k_cache, v_cache, lengths, scale=None,
                               return_stats=False, k_new=None, v_new=None,
                               write=None):
    """Plain PyTorch version of K10: with ``k_new``/``v_new`` the fresh
    rows are written first (``write_fresh_rows``); then scores in fp32, a
    softmax masked to each row's first lengths[b] cache entries, p
    rounded to the cache dtype before the value product (as the kernel
    and the TPU kernel round it). m (the max; -inf for an empty row) and
    l (the denominator) are (B, Hq) fp32; an empty row gives o = 0."""
    if k_new is not None:
        write_fresh_rows(k_cache, v_cache, lengths, k_new, v_new, write)
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
        fn.argtypes = [i, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, i, i, i,
                       i, i, ctypes.c_float, i, i, vp]
        fn.restype = ctypes.c_int
    return lib


def _check_operands(q, k_cache, v_cache, lengths, k_new, v_new, write):
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
    if (k_new is None) != (v_new is None):
        raise ValueError("k_new and v_new go together")
    if k_new is None and write is not None:
        raise ValueError("write needs k_new and v_new")
    if k_new is not None:
        for name, t in (("k_new", k_new), ("v_new", v_new)):
            if tuple(t.shape) != (b, hkv, d):
                raise ValueError(f"{name} must be ({b}, {hkv}, {d}), got "
                                 f"{tuple(t.shape)}")
        if write is not None and (write.shape != (b,)
                                  or write.dtype != torch.bool):
            raise ValueError(f"write must be ({b},) bool, got "
                             f"{tuple(write.shape)} {write.dtype}")
    if q.device.type != "cuda":
        return
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"decode attention kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    if d > MAX_HEAD_DIM or hq // hkv > MAX_GROUP:
        raise ValueError(f"decode attention kernel takes head_dim <= "
                         f"{MAX_HEAD_DIM} and Hq/Hkv <= {MAX_GROUP}, got "
                         f"{d} and {hq // hkv}")
    named = [("q", q, q.dtype), ("k_cache", k_cache, q.dtype),
             ("v_cache", v_cache, q.dtype),
             ("lengths", lengths, torch.int32)]
    if k_new is not None:
        named += [("k_new", k_new, q.dtype), ("v_new", v_new, q.dtype)]
    if write is not None:
        named.append(("write", write, torch.bool))
    for name, t, want in named:
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")


def _launch(q, k_cache, v_cache, lengths, scale, stats, k_new, v_new,
            write):
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
    # the bulk copies and 16-byte loads: whole 16-byte rows, aligned bases
    ptrs = [t for t in (q, k_cache, v_cache, o, k_new, v_new)
            if t is not None]
    aligned = int((d * q.element_size()) % 16 == 0
                  and all(t.data_ptr() % 16 == 0 for t in ptrs))
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.pt_decode_attention(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), lengths.data_ptr(), ptr(k_new), ptr(v_new),
            ptr(write), o.data_ptr(), ptr(m), ptr(l), b, hq, hkv, T, d,
            float(scale), aligned, cluster_size(T), stream)
    _build.check(lib, rc, "decode_attention launch")
    return o, m, l


def decode_attention(q, k_cache, v_cache, lengths, scale=None,
                     return_stats=False, k_new=None, v_new=None,
                     write=None):
    """One decode step of cached attention for B sequences at once (K10).

    q (B, Hq, D); k_cache/v_cache (B, Hkv, T, D) head-major, T a
    multiple of 128, Hq % Hkv == 0; lengths (B,) int32: row b attends to
    cache positions [0, lengths[b]). scale defaults to 1/sqrt(D).
    ``k_new``/``v_new`` (B, Hkv, D), optional: the step's fresh rows,
    written in place into the caches at row ``lengths[b] - 1`` (the
    clamped position of ``models.gpt.cache_rows``) before they are
    attended; ``write`` (B,) bool limits the write to the rows marked
    True (a row marked False attends to its cache entry). An empty row
    writes nothing. Returns o (B, Hq, D) in q's dtype, and with
    ``return_stats`` also m, l (B, Hq) fp32: the running max (-inf for an
    empty row) and the softmax denominator, as the TPU kernel gives
    them.

    Route: one kernel, ``flash_decode_sm90``, for float32 and bfloat16
    with head_dim <= 128 and Hq / Hkv <= 8 (instances for groups of 1, 2,
    4 and 8), each (row, kv head) split over a cluster of
    ``cluster_size(T)`` blocks. Rows whose bytes are a multiple of 16,
    with 16-byte aligned operands, load by bulk copies, others by
    threads in the same kernel.
    On CUDA, q, the caches and the fresh rows share one dtype."""
    _check_operands(q, k_cache, v_cache, lengths, k_new, v_new, write)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, lengths,
                                          scale, return_stats, k_new, v_new,
                                          write)
    o, m, l = _launch(q, k_cache, v_cache, lengths, scale, return_stats,
                      k_new, v_new, write)
    return (o, m, l) if return_stats else o


decode_attention.launches = 0
