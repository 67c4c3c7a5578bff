"""Weight-only int8 matmul (kernel K12) and its plain PyTorch version.

Counterpart of ``paddle_tpu/ops/pallas/quant_matmul.py``: the CUDA
kernel in ``csrc/quant_matmul.cu`` replaces the TPU kernel ``_kernel``
(the ``pl.pallas_call`` at quant_matmul.py:91); its source note says
what bounds it on the H100 and what the design does about that.

``int8_matmul(x, q, scale)`` computes ``x @ q`` with q widened to x's
dtype, accumulated in fp32, times the per-column ``scale`` in fp32, then
rounded to x's dtype once — the order of the TPU kernel. CUDA tensors
launch the kernel; CPU tensors run the plain version. The TPU kernel's
(block_m, block_n, block_k) and its padding have no counterpart: the
kernel bounds every ragged edge itself.
"""

import ctypes

import torch

from paddle_tpu_torch.ops import _build

__all__ = ["int8_matmul", "int8_matmul_reference", "int8_matmul_cost"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def int8_matmul_cost(m, k, n, elt=2):
    """(flops, HBM bytes) of one K12 call (x (m, k), q (k, n)): the int8
    weight and the fp32 scales read once, x read and the output written
    once; 2 flops per multiply-add."""
    return 2 * m * k * n, k * n + 4 * n + elt * m * k + elt * m * n

def int8_matmul_reference(x, q, scale):
    """Plain PyTorch version of K12: ``x @ q`` in fp32, times ``scale``
    in fp32, rounded to x's dtype once."""
    n = q.shape[1]
    acc = x.reshape(-1, x.shape[-1]).float() @ q.float()
    out = acc * scale.reshape(1, -1).float()
    return out.to(x.dtype).reshape(*x.shape[:-1], n)


def _lib():
    lib = _build.load("quant_matmul")
    fn = lib.pt_int8_matmul
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, vp, vp, vp, vp, vp, i, i, i, i, i, vp]
        fn.restype = ctypes.c_int
        ws = lib.pt_int8_matmul_workspace
        ws.argtypes = [i, i, i, i]
        ws.restype = ctypes.c_long
    return lib


def _check_operands(x, q, scale):
    if q.dim() != 2 or x.dim() < 1 or x.shape[-1] != q.shape[0]:
        raise ValueError(f"need x (..., K) and q (K, N), got "
                         f"{tuple(x.shape)}, {tuple(q.shape)}")
    if q.dtype != torch.int8:
        raise TypeError(f"q must be int8, got {q.dtype}")
    if scale.numel() != q.shape[1]:
        raise ValueError(f"scale must hold N = {q.shape[1]} entries, got "
                         f"{tuple(scale.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"int8_matmul takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    if x.device.type == "cuda" and (q.device != x.device
                                    or scale.device != x.device):
        raise ValueError(f"x, q and scale must be on {x.device}")


def _launch(x2, q, scale, out):
    m, k = x2.shape
    n = q.shape[1]
    code = _DTYPE_CODES[x2.dtype]
    lib = _lib()
    vec_x = int(k % 8 == 0 and x2.data_ptr() % 16 == 0)
    vec_q = int(n % 16 == 0 and q.data_ptr() % 16 == 0)
    with torch.cuda.device(x2.device):
        # the kernel's K split (csrc/quant_matmul.cu rows_geometry)
        # sizes its fp32 workspace
        ws_len = lib.pt_int8_matmul_workspace(code, m, n, k)
        ws = (torch.empty((ws_len,), dtype=torch.float32, device=x2.device)
              if ws_len else None)
        int8_matmul.launches += 1
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        rc = lib.pt_int8_matmul(
            code, x2.data_ptr(), q.data_ptr(), scale.data_ptr(),
            out.data_ptr(), None if ws is None else ws.data_ptr(), m, n,
            k, vec_x, vec_q, stream)
    _build.check(lib, rc, "int8_matmul launch")


def int8_matmul(x, q, scale):
    """``(x @ q) * scale`` with q (K, N) int8 and scale (N,) or (1, N)
    fp32 per output column (K12). x (..., K) in bf16 or fp32; returns
    (..., N) in x's dtype."""
    _check_operands(x, q, scale)
    if x.device.type == "cpu":
        return int8_matmul_reference(x, q, scale)
    n = q.shape[1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    out = torch.empty((x2.shape[0], n), dtype=x.dtype, device=x.device)
    if x2.shape[1] == 0:
        out.zero_()
    elif x2.shape[0] and n:
        _launch(x2, q.contiguous(),
                scale.reshape(-1).to(torch.float32).contiguous(), out)
    return out.reshape(*x.shape[:-1], n)


int8_matmul.launches = 0
