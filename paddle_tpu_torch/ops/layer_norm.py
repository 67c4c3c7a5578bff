"""Fused bias + dropout + residual + LayerNorm (kernel K11) and its plain
PyTorch version.

Counterpart of ``paddle_tpu/ops/pallas/layer_norm.py``. The CUDA kernel
(``csrc/layer_norm.cu``) replaces its Pallas TPU kernel ``_fwd_kernel``
(the ``pl.pallas_call`` at layer_norm.py:120); the source note says what
bounds it on the H100 and what its design does about that.

``fused_layer_norm`` returns ``(y, pre)``: ``pre = residual +
dropout(x + bias)`` in fp32, rounded to x's dtype, and ``y`` its
LayerNorm over the last dim. It is differentiable in x, gamma, beta,
bias and residual (a ``torch.autograd.Function``, the counterpart of the
JAX ``_fused_ln`` custom VJP). The backward is plain PyTorch, as in JAX
(``_fused_ln_bwd``, :178): it recomputes xhat from the rounded ``pre``
and the saved fp32 mean and rstd, adds the cotangent of ``pre``, and
replays the dropout mask from the seed; no mask is stored. CUDA tensors
launch the kernel for the forward; CPU tensors run
``fused_layer_norm_reference``; nothing else chooses between them.
``fused_layer_norm_plain`` is the same function through the plain
version on any device (what the kernel is held against).

Unlike the JAX wrapper, any N up to ``MAX_N`` takes the kernel (JAX's
``N % 128`` gate was a TPU tiling limit); a larger N raises on CUDA.
The launch's shape (a warp or a block per row, 16-byte or one-element
accesses, values a thread, block and grid) is ``_plan``'s, a plain
function of the static shapes, the dtype, the pointers' alignment and
the SM count: nothing is timed or tuned at run time.
"""

import ctypes
from typing import NamedTuple

import torch

from paddle_tpu_torch.device import sm_count
from paddle_tpu_torch.ops import _build, _hash

__all__ = ["fused_layer_norm", "fused_layer_norm_plain",
           "fused_layer_norm_reference", "fused_layer_norm_fwd", "MAX_N"]

MAX_N = 16384          # csrc/layer_norm.cu kMaxN
WARP_MAX_N = 1024      # kWarpMaxN: rows up to this take a warp each
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the warp variant's block (kWarpThreads: 8 rows at a time) and its grid,
# blocks an SM (each warp walks rows with a grid stride)
_WARP_THREADS = 256
_WARP_BLOCKS_PER_SM = 2
# the block variant: 32 values a thread (N <= MAX_N: at most 512 threads)
_BLOCK_ELEMS = 32
# shared memory an SM on sm_90, the one architecture the kernels build for
_SMEM_PER_SM = 228 * 1024


def _check_rate(dropout_p, dropout_seed):
    if dropout_p >= 1.0 or dropout_p < 0.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
    if dropout_p > 0.0 and dropout_seed is None:
        raise ValueError("dropout_p > 0 requires dropout_seed")


def fused_layer_norm_reference(x2, gamma, beta, bias=None, residual=None,
                               seed=0, epsilon: float = 1e-5,
                               dropout_p: float = 0.0):
    """Plain PyTorch version of K11 on the flattened (M, N) ``x2``:
    ``(y, pre, mean, rstd)``, y and pre in x's dtype, mean and rstd
    (M, 1) fp32 — the JAX kernel's arithmetic, in fp32. ``seed`` is an
    int or a 0-dim integer tensor."""
    pre = x2.float()
    if bias is not None:
        pre = pre + bias.float()
    if dropout_p > 0.0:
        keep = _hash.layer_norm_keep(seed, pre.shape, dropout_p,
                                     device=pre.device)
        pre = torch.where(keep, pre / (1.0 - dropout_p),
                          torch.zeros_like(pre))
    if residual is not None:
        pre = pre + residual.float()
    mean = pre.mean(dim=-1, keepdim=True)
    var = torch.square(pre - mean).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + epsilon)
    y = (pre - mean) * rstd * gamma.float() + beta.float()
    return y.to(x2.dtype), pre.to(x2.dtype), mean, rstd


class Plan(NamedTuple):
    """K11's launch: ``variant`` "warp" (a warp per row) or "block" (a
    block per row), ``vec`` elements per access (16 bytes' worth, or 1),
    ``elems`` values a thread, ``threads`` a block, ``grid`` blocks."""
    variant: str
    vec: int
    elems: int
    threads: int
    grid: int


def _plan(m, n, dtype, aligned, sms):
    """The launch of K11 for an (m, n) input of ``dtype``. ``aligned``: x,
    residual, y and pre all start on 16-byte boundaries. 16-byte accesses
    when aligned and n is a multiple of their width, else one element
    each. Rows up to ``WARP_MAX_N``: a warp each, 8, 16, 24 or 32 values
    a lane, 8 rows a block, ``_WARP_BLOCKS_PER_SM`` blocks an SM at most.
    Wider rows: a block each, 32 values a thread, as many blocks as fit
    an SM by threads and by the shared memory of the three vectors,
    staged in fp32."""
    if not 0 < n <= MAX_N:
        raise ValueError(f"fused_layer_norm kernel takes 0 < N <= {MAX_N}, "
                         f"got {n}")
    width = 16 // dtype.itemsize
    vec = width if aligned and n % width == 0 else 1
    if n <= WARP_MAX_N:
        rows = _WARP_THREADS // 32
        return Plan("warp", vec, 8 * -(-n // 256), _WARP_THREADS,
                    min(-(-m // rows), sms * _WARP_BLOCKS_PER_SM))
    threads = 32 * -(-n // (32 * _BLOCK_ELEMS))
    staged = 3 * (-(-n * 4 // 64) * 64)
    per_sm = max(1, min(2048 // threads, _SMEM_PER_SM // staged))
    return Plan("block", vec, _BLOCK_ELEMS, threads, min(m, sms * per_sm))


_VP, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_uint
# dtype, vector dtype, 9 pointers, M, N, eps, seed pointer (null: no
# dropout), threshold, 1 - p, the plan (block_row, vec, elems, threads,
# grid), stream
_ARGTYPES = [_I, _I] + [_VP] * 9 + [_I, _I, _F, _VP, _U, _F] + [_I] * 5 + \
    [_VP]


def _entry():
    lib = _build.load("layer_norm")
    fn = lib.pt_fused_layer_norm_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib, fn


def _vec(t, n, name, dev):
    """A parameter vector for the kernel as it is: (N,) on ``dev``,
    contiguous (a contiguous vector is returned itself, in its own
    dtype: no cast, no copy)."""
    if t is None:
        return None
    if t.shape != (n,) or t.device != dev:
        raise ValueError(f"{name} must be ({n},) on {dev}, got "
                         f"{tuple(t.shape)} on {t.device}")
    return t.detach().contiguous()


def _vectors(gamma, beta, bias, n, dev):
    """(gamma, beta, bias or None, vector dtype code): the vectors in
    their own dtype when the three share bf16 or fp32, else all three
    cast to fp32 (extra launches, for mixed or other dtypes only)."""
    vs = [_vec(t, n, nm, dev) for t, nm in
          ((gamma, "gamma"), (beta, "beta"), (bias, "bias"))]
    dtypes = {v.dtype for v in vs if v is not None}
    if len(dtypes) != 1 or next(iter(dtypes)) not in _DTYPE_CODES:
        vs = [None if v is None else v.float() for v in vs]
        dtypes = {torch.float32}
    return (*vs, _DTYPE_CODES[dtypes.pop()])


def fused_layer_norm_fwd(x2, gamma, beta, bias=None, residual=None,
                         seed=0, epsilon: float = 1e-5,
                         dropout_p: float = 0.0):
    """K11 on CUDA tensors: ``(y, pre, mean, rstd)`` as the plain version
    returns them. x2 and residual (M, N) contiguous float32 or bfloat16
    of one dtype, N <= MAX_N; gamma, beta and bias (N,), read in their
    own dtype when the three are all bf16 or all fp32 (one launch);
    ``seed`` an int or a 0-dim integer tensor, which the kernel reads on
    the device."""
    if x2.dim() != 2:
        raise ValueError(f"x2 must be (M, N), got {tuple(x2.shape)}")
    m, n = x2.shape
    dev = x2.device
    if x2.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_layer_norm kernel takes float32 or "
                        f"bfloat16, got {x2.dtype}")
    if not 0 < n <= MAX_N:
        raise ValueError(f"fused_layer_norm kernel takes 0 < N <= {MAX_N}, "
                         f"got {n}")
    if residual is not None and (residual.shape != x2.shape
                                 or residual.dtype != x2.dtype
                                 or residual.device != dev):
        raise ValueError("residual must match x in shape, dtype and "
                         "device")
    x2 = x2.contiguous()
    residual = None if residual is None else residual.contiguous()
    g, b, bb, vcode = _vectors(gamma, beta, bias, n, dev)
    y = torch.empty_like(x2)
    pre = torch.empty_like(x2)
    mean = torch.empty((m, 1), dtype=torch.float32, device=dev)
    rstd = torch.empty((m, 1), dtype=torch.float32, device=dev)
    if m == 0:
        return y, pre, mean, rstd
    aligned = all(t.data_ptr() % 16 == 0 for t in (x2, residual, y, pre)
                  if t is not None)
    plan = _plan(m, n, x2.dtype, aligned, sm_count(dev))
    lib, fn = _entry()
    drop = dropout_p > 0.0
    seed_t = _hash.seed_tensor(seed, dev) if drop else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        fused_layer_norm_fwd.launches += 1
        rc = fn(_DTYPE_CODES[x2.dtype], vcode, x2.data_ptr(), g.data_ptr(),
                b.data_ptr(), None if bb is None else bb.data_ptr(),
                None if residual is None else residual.data_ptr(),
                y.data_ptr(), pre.data_ptr(), mean.data_ptr(),
                rstd.data_ptr(), m, n, float(epsilon),
                None if seed_t is None else seed_t.data_ptr(),
                _hash.keep_threshold(dropout_p) if drop else 0,
                float(1.0 - dropout_p), int(plan.variant == "block"),
                plan.vec, plan.elems, plan.threads, plan.grid, stream)
    _build.check(lib, rc, "fused_layer_norm launch")
    return y, pre, mean, rstd


fused_layer_norm_fwd.launches = 0


class _FusedLN(torch.autograd.Function):
    """(y, pre) of K11; the backward is the JAX ``_fused_ln_bwd`` in
    plain PyTorch. ``plain`` runs the plain forward, else the kernel."""

    @staticmethod
    def forward(ctx, x2, gamma, beta, bias, residual, seed, epsilon,
                dropout_p, plain):
        fwd = fused_layer_norm_reference if plain else fused_layer_norm_fwd
        y, pre, mean, rstd = fwd(x2, gamma, beta, bias, residual, seed,
                                 epsilon, dropout_p)
        ctx.save_for_backward(pre, mean, rstd, gamma)
        ctx.seed, ctx.dropout_p = seed, dropout_p
        ctx.has_bias, ctx.has_residual = bias is not None, \
            residual is not None
        ctx.bias_dtype = None if bias is None else bias.dtype
        return y, pre

    @staticmethod
    def backward(ctx, dy, dpre_out):
        pre, mean, rstd, gamma = ctx.saved_tensors
        pre_f = pre.float()
        dy_f = dy.float()
        xhat = (pre_f - mean) * rstd
        dgamma = (dy_f * xhat).sum(0).to(gamma.dtype)
        dbeta = dy_f.sum(0).to(gamma.dtype)
        # LN input grad: rstd * (dxhat - mean(dxhat) - xhat *
        # mean(dxhat * xhat)); pre is also an output, its cotangent
        # joins at the sum node
        dxhat = dy_f * gamma.float()
        dpre = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                       - xhat * (dxhat * xhat).mean(-1, keepdim=True))
        dpre = dpre + dpre_out.float()
        dresidual = dpre.to(pre.dtype) if ctx.has_residual else None
        dx = dpre
        if ctx.dropout_p > 0.0:
            keep = _hash.layer_norm_keep(ctx.seed, dpre.shape,
                                         ctx.dropout_p, device=dpre.device)
            dx = torch.where(keep, dpre / (1.0 - ctx.dropout_p),
                             torch.zeros_like(dpre))
        dbias = (dx.sum(0).to(ctx.bias_dtype) if ctx.has_bias else None)
        return (dx.to(pre.dtype), dgamma, dbeta, dbias, dresidual, None,
                None, None, None)


def _fused(x, gamma, beta, residual, bias, dropout_p, dropout_seed,
           epsilon, plain):
    _check_rate(dropout_p, dropout_seed)
    shape = x.shape
    n = shape[-1]
    x2 = x.reshape(-1, n)
    res2 = None if residual is None else residual.reshape(-1, n)
    # on x's device once, so the backward replays the forward's mask from
    # the same tensor
    seed = (_hash.seed_tensor(dropout_seed, x.device) if dropout_p > 0.0
            else None)
    y, pre = _FusedLN.apply(x2, gamma, beta, bias, res2, seed,
                            float(epsilon), float(dropout_p), plain)
    return y.reshape(shape), pre.reshape(shape)


def fused_layer_norm(x, gamma, beta, residual=None, bias=None,
                     dropout_p: float = 0.0, dropout_seed=None,
                     epsilon: float = 1e-5):
    """``(y, pre)``: ``y = LayerNorm(pre)`` over the last dim with
    ``pre = residual + dropout(x + bias)``, as the JAX
    ``fused_layer_norm``. Leading dims are flattened; ``dropout_seed``
    (an int, whose low 32 bits are read as int32, or a 0-dim integer
    tensor such as ``key_seed`` gives) replays the mask in the
    backward. CUDA tensors launch K11; CPU tensors run the plain
    version."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return _fused(x, gamma, beta, residual, bias, dropout_p, dropout_seed,
                  epsilon, plain=x.device.type == "cpu")


def fused_layer_norm_plain(x, gamma, beta, residual=None, bias=None,
                           dropout_p: float = 0.0, dropout_seed=None,
                           epsilon: float = 1e-5):
    """``fused_layer_norm`` through the plain version on any device:
    the function K11 is held against on the card. Launches nothing."""
    return _fused(x, gamma, beta, residual, bias, dropout_p, dropout_seed,
                  epsilon, plain=True)
