"""Fused softmax cross-entropy over a projection (kernels K5, K6, K7) and
its plain PyTorch versions.

Counterpart of ``paddle_tpu/ops/pallas/fused_ce.py``. The CUDA kernels
replace its Pallas TPU kernels ``_fwd_kernel`` (K5, the ``pl.pallas_call``
at fused_ce.py:153; ``csrc/fused_ce.cu``), ``_dx_kernel`` (K6, :178) and
``_dw_kernel`` (K7, :199; both ``csrc/fused_ce_bwd.cu``); the source notes
say what bounds them on the H100 and what the designs do about that. K5
never writes the (N, V) logits to device memory. The backward
(``fused_ce_bwd``) cuts the vocabulary into chunks (``plan_chunks``) and
runs three launches per chunk: a dl pass that writes one (N, chunk) tile
of dlogits in the inputs' dtype, K6 adding its product into dx and K7
writing the chunk's rows of dw; so at most one (N, chunk) block of dl
exists, never the (N, V) logits whole. bf16 inputs run their products on
the tensor cores, fp32 inputs on the FP32 pipes.

``fused_softmax_cross_entropy`` is differentiable in x and w (a
``torch.autograd.Function``, the counterpart of the JAX ``_fused_ce``
custom_vjp): CUDA tensors launch K5 forward and ``fused_ce_bwd`` backward;
CPU tensors run ``fused_ce_reference`` and ``fused_ce_bwd_reference``,
which compute the same function through one full (N, V) fp32 logits
tensor. ``fused_ce_plain`` is the same differentiable function through
the plain versions on any device. The JAX function pads rows to its row
block; the kernels mask the ragged last tile instead, so no padded copy
is made.
"""

import ctypes
import functools

import torch

from paddle_tpu_torch.ops import _build

__all__ = ["fused_softmax_cross_entropy", "fused_ce_plain",
           "fused_ce_reference", "fused_ce_bwd_reference", "fused_ce_fwd",
           "fused_ce_bwd", "plan_chunks", "CHUNK"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# K5's (row, vocab) tiles: bf16 runs ``ce_fwd_sm90`` (128 x 256, one block
# an SM), fp32 the FP32-pipe kernel (64 x 128, three blocks an SM)
_TILES = {torch.bfloat16: (128, 256), torch.float32: (64, 128)}
_BLOCKS_PER_SM = {torch.bfloat16: 1, torch.float32: 3}
# a block's start-up (barriers, the ring's first stages), in tile steps
_START_TILES = 0.1
# the backward's vocab chunk: dl (N, CHUNK) in x's dtype and the fp32 dx
# sum (N, d) are its scratch
CHUNK = 4096


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


_VP, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "pt_fused_ce_fwd": ("fused_ce", [_I] + [_VP] * 6 + [_I] * 5 + [_VP]),
    "pt_ce_bwd_dl": ("fused_ce_bwd", [_I] + [_VP] * 6 + [_I] * 5 + [_VP]),
    "pt_ce_bwd_dx": ("fused_ce_bwd", [_I] + [_VP] * 4 + [_I] * 7 + [_VP]),
    "pt_ce_bwd_dw": ("fused_ce_bwd", [_I] + [_VP] * 3 + [_I] * 5 + [_VP]),
}


def _entry(fn_name):
    lib_name, argtypes = _ARGTYPES[fn_name]
    lib = _build.load(lib_name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
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


@functools.lru_cache(maxsize=64)
def _ranges(tiles: int, row_tiles: int, slots: int) -> tuple:
    """(nsplit, per): ``tiles`` vocab tiles cut into ``nsplit`` ranges of
    ``per`` consecutive tiles (the last one shorter, none empty) for a
    grid of ``row_tiles`` x nsplit blocks, ``slots`` of which run at once.
    Among the cuts into whole waves (at most one wave, or a multiple of
    ``slots`` blocks) it takes the one with the least time, counted in
    tile steps of the longest range per wave plus a start-up cost per
    block; a pure function of its arguments."""
    best = None
    for per in range(1, tiles + 1):
        nsplit = -(-tiles // per)
        if -(-tiles // nsplit) != per:
            continue                     # the same cut as a smaller per
        blocks = row_tiles * nsplit
        if blocks > slots and blocks % slots:
            continue                     # a partial last wave
        cost = -(-blocks // slots) * (per + _START_TILES)
        if best is None or cost < best[0]:
            best = (cost, nsplit, per)
    if best is None:                     # no whole-wave cut: one range
        return 1, tiles
    return best[1], best[2]


def _plan(dtype, n: int, V: int, sms: int) -> tuple:
    """K5's ``(nsplit, per)`` for an (n, d) x (V, d) call in ``dtype`` on
    a card of ``sms`` SMs, with that dtype's tiles."""
    bm, bn = _TILES[dtype]
    return _ranges(-(-V // bn), -(-n // bm), sms * _BLOCKS_PER_SM[dtype])


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def fused_ce_fwd(x, w, labels):
    """K5: ``(loss, lse)``, both (N,) fp32, for CUDA tensors."""
    _check(x, w, labels)
    n, d = x.shape
    V = w.shape[0]
    loss = torch.empty((n,), dtype=torch.float32, device=x.device)
    lse = torch.empty_like(loss)
    if n == 0:
        return loss, lse
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    nsplit, per = _plan(x.dtype, n, V, sms)
    part = torch.empty((nsplit, 3, n), dtype=torch.float32, device=x.device)
    lib, fn = _entry("pt_fused_ce_fwd")
    with torch.cuda.device(x.device):
        fused_ce_fwd.launches += 1
        rc = fn(_DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
                labels.data_ptr(), part.data_ptr(), loss.data_ptr(),
                lse.data_ptr(), n, V, d, nsplit, per, _stream(x))
    _build.check(lib, rc, "fused_ce_fwd launch")
    return loss, lse


def plan_chunks(V: int, width: int = CHUNK):
    """The backward's vocab chunks: ``[(v0, vc), ...]`` covering [0, V) in
    order, ``width`` columns each and the last ragged; none empty. The
    width is a positive multiple of 8 (dl's rows are read by TMA, whose
    row stride is a multiple of 16 bytes)."""
    if width <= 0 or width % 8:
        raise ValueError(f"chunk width must be a positive multiple of 8, "
                         f"got {width}")
    return [(v0, min(width, V - v0)) for v0 in range(0, V, width)]


def _dl_pass(x, w, labels, lse, g, dl, v0, vc):
    """The dl pass of chunk [v0, v0 + vc): dl[:, :vc] = the chunk's
    dlogits in x's dtype."""
    lib, fn = _entry("pt_ce_bwd_dl")
    n, d = x.shape
    _dl_pass.launches += 1
    rc = fn(_DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
            labels.data_ptr(), lse.data_ptr(), g.data_ptr(), dl.data_ptr(),
            n, d, v0, vc, dl.shape[1], _stream(x))
    _build.check(lib, rc, "fused_ce_bwd dl pass launch")


def _dx_chunk(dl, w, dx32, dx, v0, vc, first, last):
    """K6 on chunk [v0, v0 + vc): dx32 (+)= dl[:, :vc] . w[v0:v0 + vc];
    ``last`` writes dx in its dtype instead."""
    lib, fn = _entry("pt_ce_bwd_dx")
    n, d = dx.shape
    _dx_chunk.launches += 1
    rc = fn(_DTYPE_CODES[dx.dtype], dl.data_ptr(), w.data_ptr(),
            dx32.data_ptr(), dx.data_ptr(), n, d, v0, vc, dl.shape[1],
            int(first), int(last), _stream(dx))
    _build.check(lib, rc, "fused_ce_bwd K6 launch")


def _dw_chunk(dl, x, dw, v0, vc):
    """K7 on chunk [v0, v0 + vc): dw[v0:v0 + vc] = dl[:, :vc]^T . x."""
    lib, fn = _entry("pt_ce_bwd_dw")
    n, d = x.shape
    _dw_chunk.launches += 1
    rc = fn(_DTYPE_CODES[x.dtype], dl.data_ptr(), x.data_ptr(),
            dw.data_ptr(), n, d, v0, vc, dl.shape[1], _stream(x))
    _build.check(lib, rc, "fused_ce_bwd K7 launch")


def _bwd_plain(x, w, labels, lse, g, chunks):
    """The three passes chunk by chunk in plain PyTorch: dl rounded to
    x's dtype, dx summed in fp32 across the chunks, each chunk's rows of
    dw written once."""
    dx32 = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    dw = torch.empty_like(w)
    lab = labels.long()
    for v0, vc in chunks:
        wc = w[v0:v0 + vc].float()
        cols = torch.arange(v0, v0 + vc, device=x.device)
        onehot = (cols[None, :] == lab[:, None]).float()
        dl = ((torch.exp(x.float() @ wc.t() - lse[:, None]) - onehot)
              * g[:, None]).to(x.dtype).float()
        dx32 += dl @ wc
        dw[v0:v0 + vc] = (dl.t() @ x.float()).to(w.dtype)
    return dx32.to(x.dtype), dw


def fused_ce_bwd(x, w, labels, lse, g, *, chunk: int = CHUNK):
    """K6 and K7: ``(dx, dw)`` in x's and w's dtypes for the per-row loss
    cotangent ``g`` (N,) fp32, already 0 on ignored rows, and the
    forward's ``lse``. The vocabulary is cut into chunks of ``chunk``
    columns (``plan_chunks``); each takes a dl pass, K6 and K7 on CUDA
    tensors (one launch each), or the same passes in plain PyTorch on
    CPU tensors."""
    _check(x, w, labels, lse, g)
    n, d = x.shape
    V = w.shape[0]
    chunks = plan_chunks(V, chunk)
    if n == 0 or V == 0:
        return torch.zeros_like(x), torch.zeros_like(w)
    if x.device.type == "cpu":
        return _bwd_plain(x, w, labels, lse, g, chunks)
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    dl = torch.empty((n, min(chunk, -(-V // 8) * 8)), dtype=x.dtype,
                     device=x.device)
    # one chunk writes dx directly and needs no fp32 sum
    dx32 = (torch.empty((n, d), dtype=torch.float32, device=x.device)
            if len(chunks) > 1 else dx)
    with torch.cuda.device(x.device):
        for i, (v0, vc) in enumerate(chunks):
            _dl_pass(x, w, labels, lse, g, dl, v0, vc)
            _dx_chunk(dl, w, dx32, dx, v0, vc, i == 0, i == len(chunks) - 1)
            _dw_chunk(dl, x, dw, v0, vc)
    return dx, dw


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
            dx, dw = fused_ce_bwd(x, w, labels, lse, g)
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
    backward, ``fused_ce_bwd``'s dl pass, K6 and K7 per vocab chunk
    (float32 or bfloat16, d % 8 == 0); CPU tensors run the plain
    versions.
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
_dl_pass.launches = 0
_dx_chunk.launches = 0
_dw_chunk.launches = 0
