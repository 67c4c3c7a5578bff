"""Flash attention: forward (kernel K1), backward (kernels K3, K4) and
their plain PyTorch versions.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py``. The CUDA
kernels replace its Pallas TPU kernels: K1 (``csrc/flash_attention_fwd.cu``)
``_fwd_kernel`` (the ``pl.pallas_call`` at flash_attention.py:213); K3
(``csrc/flash_attention_bwd.cu``) ``_bwd_dkdv_kernel`` (:395) and K4
``_bwd_dq_kernel`` (:433), both run by ``_fa_backward`` (:359). Their
source notes say what bounds them on the H100 and what the designs do
about that.

``flash_attention`` is differentiable (a ``torch.autograd.Function``, the
counterpart of the JAX ``_flash`` custom_vjp): the forward keeps (o, lse),
the backward computes ``delta = rowsum(dO * O)`` in plain torch and then
dK/dV (K3) and dQ (K4) from the saved LSE. CUDA tensors launch the
kernels; CPU tensors run ``flash_attention_reference`` and
``flash_attention_bwd_reference``; nothing else chooses between them.
``flash_attention_plain`` is the same differentiable function through
the plain versions on any device (what the kernels are held against).
Layout (B, S, H, D) as in the JAX package.

An additive ``bias`` broadcastable to (B, Hq, Sq, Sk) (leading dims full
or 1; a size-1 Sq is read as one row, never materialised) is clamped to
-1e30, added to the scaled scores before the masks and gets no gradient,
as in JAX. Dropout on the probabilities hashes each cell with the seed
(``ops/_hash.py``, the JAX ``_keep_mask``): the row stride of the hash is
the key length JAX pads to (``jax_key_stride`` of Sk), so both packages
drop the same cells. The normaliser sums the un-dropped p; only p . v
and, in the backward, dV and dP see the mask. The seed is an int or a
0-dim integer tensor; the kernels read it from the device.
"""

import ctypes
import math
from typing import Optional

import torch

from paddle_tpu_torch.ops import _build, _hash

__all__ = ["flash_attention", "flash_attention_plain",
           "flash_attention_reference", "flash_attention_bwd_reference",
           "flash_attention_bwd_dkdv", "flash_attention_bwd_dq",
           "attention_bias", "MAX_HEAD_DIM", "flash_attention_cost"]

MAX_HEAD_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MASK_FLOOR = -1e30      # the kernels' floor on the running max


def _visible(b, sq, sk, causal, kv_lens, device):
    """(B, 1, Sq, Sk) bool: keys before kv_lens[b] and, when causal, at
    or before the query row (the kernels' mask)."""
    col = torch.arange(sk, device=device)
    visible = torch.ones((b, 1, sq, sk), dtype=torch.bool, device=device)
    if kv_lens is not None:
        lens = kv_lens.to(device=device, dtype=torch.int64).clamp(max=sk)
        visible = visible & (col[None, None, None, :]
                             < lens[:, None, None, None])
    if causal:
        row = torch.arange(sq, device=device)
        visible = visible & (col[None, :] <= row[:, None])[None, None]
    return visible


def flash_attention_cost(b, sq, sk, n_heads, kv_heads, head_dim,
                         causal=True, elt=2, lse=True):
    """(flops, HBM bytes) of one K1 call: q and o once, k and v once,
    the fp32 LSE when returned; 4 flops per head dim per visible (query,
    key) pair (the causal mask keeps key j <= query row i)."""
    pairs = (sum(min(i + 1, sk) for i in range(sq)) if causal
             else sq * sk)
    nbytes = (2 * b * sq * n_heads + 2 * b * sk * kv_heads) * head_dim * elt
    if lse:
        nbytes += b * n_heads * sq * 4
    return 4 * b * n_heads * head_dim * pairs, nbytes

def _scores(q, k, scale, group, bias=None):
    """(B, Hq, Sq, Sk) fp32 q . k * scale (+ bias), kv heads expanded
    for GQA."""
    kf = k.float().repeat_interleave(group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    return s if bias is None else s + bias


def attention_bias(bias, b, hq, sq, sk):
    """The kernels' bias: ``bias`` as fp32, clamped to -1e30 (a -inf
    mask value stays finite, as in JAX), broadcast over Sk and given
    leading dims of 1 up to 4-D; contiguous (B|1, Hq|1, Sq|1, Sk)."""
    bias = torch.clamp(bias.float(), min=_MASK_FLOOR)
    try:
        shape = torch.broadcast_shapes(bias.shape, (1, 1, 1, sk))
    except RuntimeError:
        raise ValueError(f"bias {tuple(bias.shape)} does not broadcast "
                         f"to (..., {sk})") from None
    if len(shape) != 4:
        raise ValueError(f"bias must be 4-D, got {tuple(bias.shape)}")
    for got, full, what in zip(shape[:3], (b, hq, sq), ("B", "Hq", "Sq")):
        if got not in (1, full):
            raise ValueError(f"bias {what} dim must be 1 or {full}, got "
                             f"{got}")
    return bias.broadcast_to(shape).contiguous()


def _keep(shape, dropout_p, seed, device):
    """The (B, Hq, Sq, Sk) hash keep mask, or None without dropout."""
    if dropout_p <= 0.0:
        return None
    b, hq, sq, sk = shape
    return _hash.attention_keep(seed, b, hq, sq, sk, dropout_p,
                                _hash.jax_key_stride(sk), device=device)


def _dropped(x, keep, dropout_p):
    """keep * x / (1 - dropout_p), or x itself without a mask."""
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - dropout_p), torch.zeros_like(x))


def flash_attention_reference(q, k, v, causal: bool = False,
                              scale: Optional[float] = None,
                              kv_lens: Optional[torch.Tensor] = None,
                              bias: Optional[torch.Tensor] = None,
                              dropout_p: float = 0.0, dropout_seed=0):
    """Plain PyTorch version of K1: ``(o, lse)`` with o (B, Sq, Hq, D)
    in q's dtype and lse (B * Hq, Sq) fp32, computed in fp32. Same
    semantics as the kernel: ``bias`` (``attention_bias``'s form) is
    added to the scaled scores; keys at or past ``kv_lens[b]`` and, when
    causal, keys after the query row are masked; a row with no visible
    key gives 0 and LSE 0; dropout scales the kept p by 1 / (1 - p)
    after the normaliser is summed; p is rounded to v's dtype before
    p . v (a no-op in fp32)."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    vf = v.float().repeat_interleave(group, dim=2)
    s = _scores(q, k, scale, group, bias)
    s = s.masked_fill(~_visible(b, sq, sk, causal, kv_lens, q.device),
                      float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m.clamp(min=_MASK_FLOOR))
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    keep = _keep(p.shape, dropout_p, dropout_seed, p.device)
    p_d = _dropped(p, keep, dropout_p)
    # p is rounded to v's dtype for p . v, as the TPU kernel does
    o = (torch.einsum("bhqk,bkhd->bqhd", p_d.to(v.dtype).float(), vf)
         / l_safe.permute(0, 2, 1, 3))
    lse = torch.where(l == 0, torch.zeros_like(l), m + torch.log(l_safe))
    return o.to(q.dtype), lse.reshape(b * hq, sq)


def _delta(o, do):
    """rowsum(dO * O) in fp32, (B * Hq, Sq) like the LSE."""
    b, sq, hq, _ = o.shape
    dlt = (do.float() * o.float()).sum(-1)            # (B, Sq, Hq)
    return dlt.permute(0, 2, 1).reshape(b * hq, sq).contiguous()


def flash_attention_bwd_reference(q, k, v, o, lse, do, causal: bool = False,
                                  scale: Optional[float] = None,
                                  kv_lens: Optional[torch.Tensor] = None,
                                  bias: Optional[torch.Tensor] = None,
                                  dropout_p: float = 0.0,
                                  dropout_seed=0):
    """Plain PyTorch version of K3 and K4: ``(dq, dk, dv)`` of the
    attention ``o`` (K1's output, with its (B * Hq, Sq) ``lse``) for the
    cotangent ``do``, in fp32, cast to the inputs' dtypes. P is
    recomputed from the LSE (and the bias) as the kernels do, masked
    keys give p = 0, and dk/dv sum the query heads of each GQA group.
    With dropout the mask is replayed twice, as in JAX: dV takes the
    dropped p and dP is masked and scaled, while ds = p (dP - delta)
    takes the un-dropped p. As in the JAX kernels, p and ds are rounded
    to the inputs' dtype before their products (nothing changes in
    fp32)."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    s = _scores(q, k, scale, group, bias)
    s = s.masked_fill(~_visible(b, sq, sk, causal, kv_lens, q.device),
                      float("-inf"))
    p = torch.exp(s - lse.reshape(b, hq, sq, 1))
    dof = do.float()
    vf = v.float().repeat_interleave(group, dim=2)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    keep = _keep(p.shape, dropout_p, dropout_seed, p.device)
    dp = _dropped(dp, keep, dropout_p)
    delta = _delta(o, do).reshape(b, hq, sq, 1)
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    p = _dropped(p, keep, dropout_p)
    p = p.to(do.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds,
                      k.float().repeat_interleave(group, dim=2))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = dk.reshape(b, sk, hkv, group, d).sum(3)
    dv = dv.reshape(b, sk, hkv, group, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# bias pointer, its three strides, seed pointer, threshold, 1 - p, stride
_EXTRA = [_VP, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, _VP,
          ctypes.c_uint, _F, _I]
_ARGTYPES = {
    "pt_flash_attention_fwd": [_I] + [_VP] * 6 + [_I] * 7 + [_F] + _EXTRA
    + [_VP],
    "pt_flash_attention_bwd_dkdv": [_I] + [_VP] * 9 + [_I] * 7 + [_F]
    + _EXTRA + [_VP],
    "pt_flash_attention_bwd_dq": [_I] + [_VP] * 8 + [_I] * 7 + [_F]
    + _EXTRA + [_VP],
}


def _entry(lib_name, fn_name):
    lib = _build.load(lib_name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[fn_name]
        fn.restype = ctypes.c_int
    return lib, fn


def _check_inputs(q, k, v, kv_lens, do=None, bias=None):
    """Raise on what the kernels do not take."""
    b, sq, hq, _ = q.shape
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention kernels take float32 or "
                        f"bfloat16, got {q.dtype}")
    if q.shape[3] > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernels take head_dim <= "
                         f"{MAX_HEAD_DIM}, got {q.shape[3]}")
    others = (("k", k), ("v", v)) + ((("do", do),) if do is not None
                                     else ())
    for name, t in others:
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"{name} must match q's dtype and device")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, *dict(others).values())):
        raise ValueError("flash_attention kernels need contiguous, "
                         "16-byte aligned inputs")
    if kv_lens is not None:
        if (kv_lens.dtype != torch.int32 or kv_lens.device != q.device
                or kv_lens.shape != (b,) or not kv_lens.is_contiguous()):
            raise ValueError("kv_lens must be a contiguous (B,) int32 "
                             "tensor on q's device")
    if bias is not None:
        ok_dims = all(g in (1, f) for g, f in zip(bias.shape[:3],
                                                  (b, hq, sq)))
        if (bias.dtype != torch.float32 or bias.device != q.device
                or bias.dim() != 4 or not ok_dims
                or bias.shape[3] != k.shape[1]
                or not bias.is_contiguous()):
            raise ValueError("bias must be a contiguous float32 (B|1, "
                             "Hq|1, Sq|1, Sk) tensor on q's device "
                             "(attention_bias)")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _extra(bias, dropout_p, seed, sk):
    """The C entries' trailing arguments: the bias and its strides
    (0 along a size-1 dim), then the dropout hash's parameters (a null
    seed pointer without dropout; the mask's row stride from Sk).
    ``seed`` is the device tensor of ``_hash.seed_tensor``."""
    if bias is None:
        strides = (0, 0, 0)
    else:
        strides = tuple(st if n > 1 else 0
                        for st, n in zip(bias.stride()[:3],
                                         bias.shape[:3]))
    if dropout_p <= 0.0:
        return (_ptr(bias), *strides, None, 0, 1.0, 0)
    return (_ptr(bias), *strides, seed.data_ptr(),
            _hash.keep_threshold(dropout_p), float(1.0 - dropout_p),
            _hash.jax_key_stride(sk))


def _device_seed(dropout_p, seed, device):
    """The seed the kernels read, on ``device`` (None without dropout)."""
    return (_hash.seed_tensor(seed, device) if dropout_p > 0.0 else None)


def _launch(q, k, v, causal, scale, kv_lens, bias, dropout_p, dropout_seed):
    """K1: (o, lse) for CUDA tensors."""
    _check_inputs(q, k, v, kv_lens, bias=bias)
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    seed = _device_seed(dropout_p, dropout_seed, q.device)
    o = torch.empty_like(q)
    lse = torch.empty((b * hq, sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    lib, fn = _entry("flash_attention_fwd", "pt_flash_attention_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        flash_attention.launches += 1
        rc = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), _ptr(kv_lens), o.data_ptr(), lse.data_ptr(),
                b, sq, sk, hq, hkv, d, int(bool(causal)), float(scale),
                *_extra(bias, dropout_p, seed, sk), stream)
    _build.check(lib, rc, "flash_attention_fwd launch")
    return o, lse


def _check_residuals(q, lse, delta):
    b, sq, hq, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or t.shape != (b * hq, sq)
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous (B * Hq, Sq) "
                             f"float32 tensor on q's device")


def flash_attention_bwd_dkdv(q, k, v, do, lse, delta, causal: bool,
                             scale: float,
                             kv_lens: Optional[torch.Tensor] = None,
                             bias: Optional[torch.Tensor] = None,
                             dropout_p: float = 0.0, dropout_seed=0):
    """K3: (dk, dv), each like k, for CUDA tensors (q, do (B, Sq, Hq, D),
    k, v (B, Sk, Hkv, D), lse and delta (B * Hq, Sq) fp32; ``bias`` in
    ``attention_bias``'s form; the dropout as in the forward)."""
    _check_inputs(q, k, v, kv_lens, do=do, bias=bias)
    _check_residuals(q, lse, delta)
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    seed = _device_seed(dropout_p, dropout_seed, q.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    lib, fn = _entry("flash_attention_bwd", "pt_flash_attention_bwd_dkdv")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        flash_attention_bwd_dkdv.launches += 1
        rc = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), _ptr(kv_lens), dk.data_ptr(),
                dv.data_ptr(), b, sq, sk, hq, hkv, d, int(bool(causal)),
                float(scale), *_extra(bias, dropout_p, seed, sk), stream)
    _build.check(lib, rc, "flash_attention_bwd_dkdv launch")
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal: bool,
                           scale: float,
                           kv_lens: Optional[torch.Tensor] = None,
                           bias: Optional[torch.Tensor] = None,
                           dropout_p: float = 0.0, dropout_seed=0):
    """K4: dq, like q, for CUDA tensors (arguments as for K3)."""
    _check_inputs(q, k, v, kv_lens, do=do, bias=bias)
    _check_residuals(q, lse, delta)
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    seed = _device_seed(dropout_p, dropout_seed, q.device)
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    lib, fn = _entry("flash_attention_bwd", "pt_flash_attention_bwd_dq")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        flash_attention_bwd_dq.launches += 1
        rc = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), _ptr(kv_lens), dq.data_ptr(), b, sq, sk,
                hq, hkv, d, int(bool(causal)), float(scale),
                *_extra(bias, dropout_p, seed, sk), stream)
    _build.check(lib, rc, "flash_attention_bwd_dq launch")
    return dq


class _Flash(torch.autograd.Function):
    """(o, lse) = attention(q, k, v); the backward recomputes P from the
    saved LSE and replays the dropout mask from the seed. ``plain`` runs
    the plain versions, else the kernels. The bias gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lens, bias, causal, scale, dropout_p,
                seed, plain):
        drop = (dropout_p, seed)
        if plain:
            o, lse = flash_attention_reference(q, k, v, causal, scale,
                                               kv_lens, bias, *drop)
        else:
            o, lse = _launch(q, k, v, causal, scale, kv_lens, bias, *drop)
        ctx.save_for_backward(q, k, v, o, lse, kv_lens, bias)
        ctx.causal, ctx.scale, ctx.plain = causal, scale, plain
        ctx.drop = drop
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse, kv_lens, bias = ctx.saved_tensors
        if ctx.plain:
            dq, dk, dv = flash_attention_bwd_reference(
                q, k, v, o, lse, do, ctx.causal, ctx.scale, kv_lens, bias,
                *ctx.drop)
        else:
            do = do.contiguous()
            delta = _delta(o, do)
            dk, dv = flash_attention_bwd_dkdv(q, k, v, do, lse, delta,
                                              ctx.causal, ctx.scale,
                                              kv_lens, bias, *ctx.drop)
            dq = flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                        ctx.causal, ctx.scale, kv_lens,
                                        bias, *ctx.drop)
        return dq, dk, dv, None, None, None, None, None, None, None


def _attend(q, k, v, causal, scale, kv_lens, bias, dropout_p, dropout_seed,
            return_lse, plain):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B,Sq,Hq,D) and k/v (B,Sk,Hkv,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, hq, d = q.shape
    sk = k.shape[1]
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError("q and k/v disagree on batch or head_dim")
    if hq % k.shape[2]:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {hq} vs "
                         f"{k.shape[2]}")
    if causal and sq != sk:
        raise ValueError(f"causal flash attention needs Sq == Sk, got "
                         f"{sq} vs {sk}")
    if dropout_p >= 1.0 or dropout_p < 0.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
    if dropout_p > 0.0 and dropout_seed is None:
        raise ValueError("dropout_p > 0 requires dropout_seed")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if bias is not None:
        bias = attention_bias(bias, b, hq, sq, sk).detach()
    # the seed goes to q's device once, so the backward replays the
    # forward's mask from the same tensor
    seed = (_hash.seed_tensor(dropout_seed, q.device) if dropout_p > 0.0
            else None)
    o, lse = _Flash.apply(q, k, v, kv_lens, bias, bool(causal),
                          float(scale), float(dropout_p), seed, plain)
    return (o, lse) if return_lse else o


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    kv_lens: Optional[torch.Tensor] = None, bias=None,
                    dropout_p: float = 0.0, dropout_seed=None,
                    return_lse: bool = False):
    """Flash attention over (B, S, H, D) inputs; returns o (B, Sq, Hq, D)
    and, with ``return_lse``, the (B * Hq, Sq) fp32 log-sum-exp.
    Differentiable in q, k and v.

    k/v (B, Sk, Hkv, D) with Hq % Hkv == 0 (GQA: query head h reads kv
    head h // (Hq // Hkv)); ``causal`` needs Sq == Sk; ``kv_lens`` (B,)
    int32 masks keys at or past kv_lens[b]; ``bias`` is additive,
    broadcastable to (B, Hq, Sq, Sk) with leading dims full or 1 (no
    gradient); ``dropout_p`` with ``dropout_seed`` (an int, or a 0-dim
    integer tensor such as ``draw_seed`` gives) drops probabilities by
    the JAX kernels' hash. CUDA tensors launch K1 and,
    in the backward, K3 and K4 (float32 or bfloat16, D <= 128); CPU
    tensors run the plain versions.
    """
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    return _attend(q, k, v, causal, scale, kv_lens, bias, dropout_p,
                   dropout_seed, return_lse, plain=q.device.type == "cpu")


def flash_attention_plain(q, k, v, causal: bool = False,
                          scale: Optional[float] = None,
                          kv_lens: Optional[torch.Tensor] = None, bias=None,
                          dropout_p: float = 0.0, dropout_seed=None,
                          return_lse: bool = False):
    """``flash_attention`` through the plain versions on any device (the
    forward ``flash_attention_reference``, the backward
    ``flash_attention_bwd_reference``): the function the kernels are
    held against on the card. Launches nothing."""
    return _attend(q, k, v, causal, scale, kv_lens, bias, dropout_p,
                   dropout_seed, return_lse, plain=True)


flash_attention.launches = 0
flash_attention_bwd_dkdv.launches = 0
flash_attention_bwd_dq.launches = 0
