"""Fused softmax cross-entropy over a projection (kernels K5, K6, K7) and
its plain PyTorch versions.

Counterpart of ``paddle_tpu/ops/pallas/fused_ce.py``. The CUDA kernels
in ``csrc/fused_ce.cu`` replace its Pallas TPU kernels ``_fwd_kernel``
(K5, the ``pl.pallas_call`` at fused_ce.py:153), ``_dx_kernel`` (K6,
:178) and ``_dw_kernel`` (K7, :199); the source note says what bounds
them on the H100 and what the design does about that. The kernels never
write the (N, V) logits to device memory; bf16 inputs run their
products on the tensor cores, fp32 inputs on the FP32 pipes.

``fused_softmax_cross_entropy`` is differentiable in x and w (a
``torch.autograd.Function``, the counterpart of the JAX ``_fused_ce``
custom_vjp): CUDA tensors launch K5 forward and K6, K7 backward; CPU
tensors run ``fused_ce_reference`` and ``fused_ce_bwd_reference``, which
compute the same function through one full (N, V) fp32 logits tensor.
``fused_ce_plain`` is the same differentiable function through the plain
versions on any device. The JAX function pads rows to its row block; the
kernels mask the ragged last tile instead, so no padded copy is made.
"""

import ctypes
import math

import torch

from paddle_tpu_torch.ops import _build

__all__ = ["fused_softmax_cross_entropy", "fused_ce_plain",
           "fused_ce_reference", "fused_ce_bwd_reference", "fused_ce_fwd",
           "fused_ce_dx", "fused_ce_dw"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_BM, _BN = 64, 128          # the kernels' row and vocab tiles


def _logits(x, w):
    return x.float() @ w.float().t()


def fused_ce_reference(x, w, labels):
    """Plain PyTorch version of K5: ``(loss, lse)``, both (N,) fp32, of
    ``softmax(x @ w.T)`` against ``labels``; a negative label gives 0
    loss (its lse is still computed, as on the TPU)."""
    logits = _logits(x, w)
    lse = torch.logsumexp(logits, dim=-1)
    lab = labels.long()
    V = w.shape[0]
    hit = (lab >= 0) & (lab < V)
    picked = logits.gather(1, lab.clamp(0, V - 1)[:, None])[:, 0]
    picked = torch.where(hit, picked, torch.zeros_like(picked))
    loss = torch.where(lab >= 0, lse - picked, torch.zeros_like(lse))
    return loss, lse


def fused_ce_bwd_reference(x, w, labels, lse, g):
    """Plain PyTorch version of K6 and K7: ``(dx, dw)`` in x's and w's
    dtypes for the per-row loss cotangent ``g`` (N,), with
    dl = (exp(logits - lse) - onehot(label)) * g and g taken as 0 on
    ignored rows. As in the JAX kernels, dl is rounded to the inputs'
    dtype before its products (nothing changes in fp32)."""
    logits = _logits(x, w)
    g = torch.where(labels >= 0, g.float(), torch.zeros_like(lse))
    cols = torch.arange(w.shape[0], device=x.device)
    onehot = (cols[None, :] == labels.long()[:, None]).float()
    dl = (torch.exp(logits - lse[:, None]) - onehot) * g[:, None]
    dl = dl.to(x.dtype).float()
    dx = dl @ w.float()
    dw = dl.t() @ x.float()
    return dx.to(x.dtype), dw.to(w.dtype)


_VP, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
_ARGTYPES = {
    "pt_fused_ce_fwd": [_I] + [_VP] * 6 + [_I] * 5 + [_VP],
    "pt_fused_ce_dx": [_I] + [_VP] * 7 + [_I] * 6 + [_L, _VP],
    "pt_fused_ce_dw": [_I] + [_VP] * 7 + [_I] * 6 + [_L, _VP],
}


def _entry(fn_name):
    lib = _build.load("fused_ce")
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[fn_name]
        fn.restype = ctypes.c_int
    return lib, fn


def _check(x, w, labels, *rows):
    """Raise on what the kernels do not take."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"need x (N, d) and w (V, d), got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"fused_ce kernels take one dtype of float32 or "
                        f"bfloat16, got {x.dtype} and {w.dtype}")
    if x.shape[1] % 8:
        raise ValueError(f"fused_ce kernels need d % 8 == 0, got "
                         f"{x.shape[1]}")
    for t in (x, w):
        if t.device != x.device or not t.is_contiguous() or \
                t.data_ptr() % 16:
            raise ValueError("fused_ce kernels need contiguous, 16-byte "
                             "aligned x and w on one device")
    n = x.shape[0]
    if (labels.dtype != torch.int32 or labels.shape != (n,)
            or labels.device != x.device or not labels.is_contiguous()):
        raise ValueError("labels must be a contiguous (N,) int32 tensor "
                         "on x's device")
    for t in rows:
        if (t.dtype != torch.float32 or t.shape != (n,)
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError("lse and g must be contiguous (N,) float32 "
                             "tensors on x's device")


def _ranges(tiles: int, other_tiles: int, device) -> tuple:
    """(nsplit, per): cut ``tiles`` into ranges of ``per`` so that
    other_tiles * nsplit blocks give about three per SM; none empty."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = max(1, min(tiles, math.ceil(3 * sms / max(1, other_tiles))))
    per = math.ceil(tiles / want)
    return math.ceil(tiles / per), per


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _scratch(nsplit, rows, tile, d, device):
    """fp32 range buffers of the backward kernels: rows rounded up to
    the kernels' tile and d to 128 columns (the tensor-core path writes
    whole 16 x 16 fragments)."""
    ld = math.ceil(d / _BN) * _BN
    return torch.empty((nsplit, math.ceil(rows / tile) * tile, ld),
                       dtype=torch.float32, device=device)


def fused_ce_fwd(x, w, labels):
    """K5: ``(loss, lse)``, both (N,) fp32, for CUDA tensors."""
    _check(x, w, labels)
    n, d = x.shape
    V = w.shape[0]
    loss = torch.empty((n,), dtype=torch.float32, device=x.device)
    lse = torch.empty_like(loss)
    if n == 0:
        return loss, lse
    nsplit, per = _ranges(math.ceil(V / _BN), math.ceil(n / _BM), x.device)
    part = torch.empty((nsplit, 3, n), dtype=torch.float32, device=x.device)
    lib, fn = _entry("pt_fused_ce_fwd")
    with torch.cuda.device(x.device):
        fused_ce_fwd.launches += 1
        rc = fn(_DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
                labels.data_ptr(), part.data_ptr(), loss.data_ptr(),
                lse.data_ptr(), n, V, d, nsplit, per, _stream(x))
    _build.check(lib, rc, "fused_ce_fwd launch")
    return loss, lse


def fused_ce_dx(x, w, labels, lse, g):
    """K6: dx (N, d) in x's dtype, for CUDA tensors; ``g`` (N,) fp32 is
    the loss cotangent, already 0 on ignored rows."""
    _check(x, w, labels, lse, g)
    n, d = x.shape
    V = w.shape[0]
    dx = torch.empty_like(x)
    if n == 0:
        return dx
    nsplit, per = _ranges(math.ceil(V / _BN), math.ceil(n / _BM), x.device)
    part = _scratch(nsplit, n, _BM, d, x.device)
    lib, fn = _entry("pt_fused_ce_dx")
    with torch.cuda.device(x.device):
        fused_ce_dx.launches += 1
        rc = fn(_DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
                labels.data_ptr(), lse.data_ptr(), g.data_ptr(),
                part.data_ptr(), dx.data_ptr(), n, V, d, nsplit, per,
                part.shape[2], part[0].numel(), _stream(x))
    _build.check(lib, rc, "fused_ce_dx launch")
    return dx


def fused_ce_dw(x, w, labels, lse, g):
    """K7: dw (V, d) in w's dtype, for CUDA tensors (arguments as K6)."""
    _check(x, w, labels, lse, g)
    n, d = x.shape
    V = w.shape[0]
    dw = torch.empty_like(w)
    if n == 0:
        return dw.zero_()
    nsplit, per = _ranges(math.ceil(n / _BM), math.ceil(V / _BN), x.device)
    part = _scratch(nsplit, V, _BN, d, x.device)
    lib, fn = _entry("pt_fused_ce_dw")
    with torch.cuda.device(x.device):
        fused_ce_dw.launches += 1
        rc = fn(_DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
                labels.data_ptr(), lse.data_ptr(), g.data_ptr(),
                part.data_ptr(), dw.data_ptr(), n, V, d, nsplit, per,
                part.shape[2], part[0].numel(), _stream(x))
    _build.check(lib, rc, "fused_ce_dw launch")
    return dw


class _FusedCE(torch.autograd.Function):
    """Per-row loss of softmax(x @ w.T); ``plain`` runs the plain
    versions, else the kernels."""

    @staticmethod
    def forward(ctx, x, w, labels, plain):
        if plain:
            loss, lse = fused_ce_reference(x, w, labels)
        else:
            loss, lse = fused_ce_fwd(x, w, labels)
        ctx.save_for_backward(x, w, labels, lse)
        ctx.plain = plain
        return loss

    @staticmethod
    def backward(ctx, dloss):
        x, w, labels, lse = ctx.saved_tensors
        # zero the cotangent on ignored rows, as the JAX backward does
        g = torch.where(labels >= 0, dloss.float(),
                        torch.zeros_like(lse)).contiguous()
        if ctx.plain:
            dx, dw = fused_ce_bwd_reference(x, w, labels, lse, g)
        else:
            dx = fused_ce_dx(x, w, labels, lse, g)
            dw = fused_ce_dw(x, w, labels, lse, g)
        return dx, dw, None, None


def _apply(x, w, labels, plain):
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"need x (N, d) and w (V, d), got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if labels.shape != (x.shape[0],):
        raise ValueError(f"labels must be (N,), got {tuple(labels.shape)}")
    labels = labels.to(device=x.device, dtype=torch.int32).contiguous()
    return _FusedCE.apply(x.contiguous(), w.contiguous(), labels, plain)


def fused_softmax_cross_entropy(x, w, labels):
    """Per-row CE of ``softmax(x @ w.T)`` against ``labels``, (N,) fp32,
    differentiable in x and w, without the (N, V) logits in device
    memory.

    x (N, d) final hidden rows (post head-LN); w (V, d) in embedding
    layout (the tied wte feeds it directly); labels (N,) int, negative
    ones ignored (0 loss, 0 grad). CUDA tensors launch K5 and, in the
    backward, K6 and K7 (float32 or bfloat16, d % 8 == 0); CPU tensors
    run the plain versions.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return _apply(x, w, labels, plain=x.device.type == "cpu")


def fused_ce_plain(x, w, labels):
    """``fused_softmax_cross_entropy`` through the plain versions on any
    device: the function the kernels are held against on the card.
    Launches nothing."""
    return _apply(x, w, labels, plain=True)


fused_ce_fwd.launches = 0
fused_ce_dx.launches = 0
fused_ce_dw.launches = 0
