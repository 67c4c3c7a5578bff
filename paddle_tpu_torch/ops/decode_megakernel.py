"""Single-dispatch paged decode: the layer-folded decode megakernel (K8)
and the fused final-norm -> logits -> greedy-argmax epilogue (K9), with
their plain PyTorch versions.

Counterpart of ``paddle_tpu/ops/pallas/decode_megakernel.py``: the CUDA
kernels in ``csrc/decode_megakernel.cu`` replace the TPU kernels
``_mega_kernel`` (the ``pl.pallas_call`` at decode_megakernel.py:366)
and ``_epilogue_kernel`` (:458); the source note says what bounds them
on the H100, why the cooperative launch makes the grid barriers sound,
and why each phase is race-free.

- ``mega_decode_layers`` (K8): every layer of one decode step over
  flat rows, each with its own (slot, position, write flag). The pools
  are updated IN PLACE (the JAX kernel aliases them): all rows' fresh
  K/V rows are written before any row attends; a row whose flag is 0
  writes the scratch page ``L * n_pages``. Returns x_out.
- ``mega_logits_sample`` (K9): ``(tok, nonfin)``, the first-max argmax
  of the logits rounded to x's dtype and a non-finite flag per row over
  the vocabulary; ``poison`` forces a row non-finite. A flagged row's
  token is unspecified. The (B, V) logits never reach device memory.

CUDA tensors launch the kernels; CPU tensors run the plain versions,
which are the port's own block functions (``GPTBlock._qkv`` and
``_block_tail``, ``final_ln``) composed as the JAX kernel composes them.
The TPU kernel's vocab-tile autotune (``tune_mega_epilogue``,
``_resolve_vb``) and its VMEM geometry cases have no counterpart: the
kernels fix their tile widths in C and size the grid from the device.
"""

import ctypes
import math
from typing import Dict, Tuple

import torch

from paddle_tpu_torch.models.gpt import GPTBlock, GPTConfig, final_ln
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops.paged_attention import (
    paged_decode_attention_reference)

__all__ = ["mega_decode_layers", "mega_decode_layers_reference",
           "mega_logits_sample", "mega_logits_sample_reference",
           "epilogue_logits",
           "MAX_ROWS", "MAX_HEAD_DIM", "MAX_GROUP", "MAX_D_MODEL", "mega_decode_layers_cost", "mega_logits_sample_cost"]

# stacked-weight order of the kernel ABI (the JAX package's
# decode_megakernel.py:77-79); a bias-free stack has no bias entries
_WEIGHT_ORDER = ("ln1_scale", "ln1_bias", "wqkv", "bqkv", "wo", "bo",
                 "ln2_scale", "ln2_bias", "wup", "bup", "wdown",
                 "bdown")
_LN = ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias")
_BIASES = ("bqkv", "bo", "bup", "bdown")
MAX_ROWS = 64
MAX_HEAD_DIM = 128
MAX_GROUP = 8
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the widest LayerNorm'd row the kernels hold whole in shared memory
# (csrc/decode_megakernel.cu a_cap: 128 KB over 8 rows)
MAX_D_MODEL = {torch.float32: 4096, torch.bfloat16: 8192}

# device scratch of the kernels, one set per (device, stream, geometry):
# K8's q|k|v, o and MLP rows and its split partial sums, K9's zeroed
# merge words. A launch leaves
# K9's words zeroed again; launches on one stream run in order.
_SCRATCH: Dict[Tuple, Tuple[torch.Tensor, ...]] = {}


def mega_decode_layers_cost(lengths, weights, n_heads, kv_heads,
                            head_dim, elt=2):
    """(flops, HBM bytes) of one K8 call over rows attending ``lengths``
    keys each (the fresh row included) through all L layers of
    ``weights`` (the (L, ...) slabs): every slab read once, each row's
    K and V rows read once per layer and its fresh K and V rows written
    once per layer, x read and written, 4 int32 words per row; 2 flops
    per multiply-add of the four products and 4 per head dim per
    (query head, key)."""
    rows = len(lengths)
    n_layers = weights["wqkv"].shape[0]
    d_model = n_heads * head_dim
    slabs = sum(t.numel() * t.element_size() for t in weights.values())
    kv = 2 * sum(lengths) * kv_heads * head_dim * elt * n_layers
    fresh = 2 * rows * kv_heads * head_dim * elt * n_layers
    nbytes = slabs + kv + fresh + 2 * rows * d_model * elt + 4 * 4 * rows
    macs = sum(weights[n].numel() for n in ("wqkv", "wo", "wup", "wdown"))
    flops = (2 * rows * macs
             + 4 * sum(lengths) * n_heads * head_dim * n_layers)
    return flops, nbytes


def mega_logits_sample_cost(rows, d_model, vocab, elt=2):
    """(flops, HBM bytes) of one K9 call: the (vocab, d_model) head and
    the rows read once, the fp32 final-norm scale and bias, and 3 int32
    words per row (token, flag, poison); 2 flops per multiply-add of the
    head product."""
    nbytes = (vocab * d_model * elt + rows * d_model * elt
              + 2 * d_model * 4 + 3 * rows * 4)
    return 2 * rows * d_model * vocab, nbytes

def _geometry(x, weights, k_pages, page_table, n_pages, n_heads, kv_heads,
              head_dim):
    b, dm = x.shape
    L = weights["wqkv"].shape[0]
    if k_pages.shape[0] != L * n_pages + 1:
        raise ValueError(f"layer-folded pool expects {L}*{n_pages}+1 rows, "
                         f"got {k_pages.shape[0]}")
    if n_heads % kv_heads:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {n_heads} vs "
                         f"{kv_heads}")
    if tuple(k_pages.shape[1:2]) != (kv_heads,) or \
            k_pages.shape[3] != head_dim:
        raise ValueError(f"pools must be (L*P+1, {kv_heads}, page, "
                         f"{head_dim}), got {tuple(k_pages.shape)}")
    if page_table.dim() != 2:
        raise ValueError(f"page_table must be (S, max_pages), got "
                         f"{tuple(page_table.shape)}")
    return b, dm, L


def mega_decode_layers_reference(x, weights, k_pages, v_pages, page_table,
                                 positions, row_slot, row_write, *, page,
                                 n_pages, n_heads, kv_heads, head_dim,
                                 rope=False, rope_theta=10000.0,
                                 scale=None):
    """Plain PyTorch version of K8: per layer, ``GPTBlock._qkv`` on the
    rows at their positions, every row's fresh K/V row written into its
    page (or the scratch page), then paged attention over [0, pos + 1)
    of the row's slot and ``GPTBlock._block_tail``. Pools in place;
    returns x_out."""
    b, dm, L = _geometry(x, weights, k_pages, page_table, n_pages,
                         n_heads, kv_heads, head_dim)
    P, mx = int(n_pages), page_table.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(head_dim)
    blk = GPTBlock(GPTConfig(vocab_size=1, d_model=n_heads * head_dim,
                             n_layers=L, n_heads=n_heads,
                             n_kv_heads=kv_heads, rope=bool(rope),
                             rope_theta=float(rope_theta)))
    pos = positions.long()
    slot = row_slot.long()
    pid = page_table.long()[slot, torch.clamp(pos // page, max=mx - 1)]
    offs = pos % page
    tables = page_table[slot]
    lens = torch.clamp(positions + 1, max=mx * page).to(torch.int32)
    names = [n for n in _WEIGHT_ORDER if weights.get(n) is not None]
    h = x[:, None, :]
    for layer in range(L):
        w = {n: weights[n][layer] for n in names}
        q, k, v = blk._qkv(h, positions, w)
        g = torch.where(row_write == 1, layer * P + pid, L * P)
        k_pages[g, :, offs, :] = k[:, 0].to(k_pages.dtype)
        v_pages[g, :, offs, :] = v[:, 0].to(v_pages.dtype)
        o = paged_decode_attention_reference(
            q[:, 0].to(k_pages.dtype), k_pages, v_pages,
            layer * P + tables, lens, scale=scale)
        h = blk._block_tail(h, o.to(x.dtype).reshape(b, 1, -1), w)
    return h[:, 0]


def epilogue_logits(x, lnf_scale, lnf_bias, w, poison=None):
    """The (B, V) logits K9 reduces: ``final_ln``, then ``x @ w`` in x's
    dtype, poisoned rows NaN."""
    logits = final_ln(x, lnf_scale, lnf_bias) @ w
    if poison is not None:
        logits = torch.where(poison.reshape(-1, 1) != 0,
                             torch.full_like(logits, float("nan")), logits)
    return logits


def mega_logits_sample_reference(x, lnf_scale, lnf_bias, w, poison=None):
    """Plain PyTorch version of K9: (tok, nonfin) of ``epilogue_logits``
    as (B,) int32 — the first maximum (``torch.argmax``) and whether any
    logit is non-finite."""
    logits = epilogue_logits(x, lnf_scale, lnf_bias, w, poison)
    nonfin = (~torch.isfinite(logits).all(dim=-1)).to(torch.int32)
    tok = torch.argmax(logits.float(), dim=-1).to(torch.int32)
    return tok, nonfin


def _lib():
    lib = _build.load("decode_megakernel")
    fn = lib.pt_mega_decode
    if fn.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([i, ctypes.POINTER(ctypes.c_void_p)] + [vp] * 12
                       + [ctypes.c_long] + [i] * 11 + [f, f, i, vp])
        fn.restype = ctypes.c_int
        ws = lib.pt_mega_workspace
        ws.argtypes = [i] * 6
        ws.restype = ctypes.c_long
        lg = lib.pt_mega_logits
        lg.argtypes = [i] + [vp] * 8 + [i] * 5 + [vp]
        lg.restype = ctypes.c_int
    return lib


def _scratch(key, make):
    bufs = _SCRATCH.get(key)
    if bufs is None:
        bufs = _SCRATCH[key] = make()
    return bufs


def _aligned(*ts):
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _check_cuda_operands(x, weights, k_pages, v_pages, page_table, ints,
                         B, dm, L, hq, hkv, d, page):
    if B > MAX_ROWS:
        raise ValueError(f"the megakernel takes at most {MAX_ROWS} rows, "
                         f"got {B}")
    if d > MAX_HEAD_DIM or d % 2 or hq // hkv > MAX_GROUP:
        raise ValueError(f"the megakernel takes an even head_dim <= "
                         f"{MAX_HEAD_DIM} and Hq/Hkv <= {MAX_GROUP}, got "
                         f"{d} and {hq // hkv}")
    if page % 128:
        raise ValueError(f"page must be a multiple of 128, got {page}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the megakernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if dm > MAX_D_MODEL[x.dtype]:
        raise ValueError(f"the megakernel takes d_model <= "
                         f"{MAX_D_MODEL[x.dtype]} in {x.dtype}, got {dm}")
    nq, f = (hq + 2 * hkv) * d, weights["wup"].shape[-1]
    shapes = {"ln1_scale": (L, dm), "ln1_bias": (L, dm),
              "wqkv": (L, dm, nq), "bqkv": (L, nq), "wo": (L, hq * d, dm),
              "bo": (L, dm), "ln2_scale": (L, dm), "ln2_bias": (L, dm),
              "wup": (L, dm, f), "bup": (L, f), "wdown": (L, f, dm),
              "bdown": (L, dm)}
    tensors = [("x", x, x.dtype), ("k_pages", k_pages, x.dtype),
               ("v_pages", v_pages, x.dtype),
               ("page_table", page_table, torch.int32)]
    tensors += [(n, t, torch.int32) for n, t in ints.items()]
    for n, want in shapes.items():
        t = weights.get(n)
        if t is None:
            if n not in _BIASES:
                raise ValueError(f"weights[{n!r}] is missing")
            continue
        if tuple(t.shape) != want:
            raise ValueError(f"weights[{n!r}] must be {want}, got "
                             f"{tuple(t.shape)}")
        tensors.append((n, t, torch.float32 if n in _LN else x.dtype))
    for n, t, want in tensors:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{n} must be a dense tensor (the megakernel "
                            f"has no int8 weight stream)")
        if t.dtype != want:
            raise TypeError(f"{n} must be {want}, got {t.dtype}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{n} must be contiguous on {x.device}")


def mega_decode_layers(x, weights, k_pages, v_pages, page_table, positions,
                       row_slot, row_write, *, page, n_pages, n_heads,
                       kv_heads, head_dim, rope=False, rope_theta=10000.0,
                       scale=None):
    """Run every layer of one decode step in one launch (K8).

    x: (B, dm) embedded rows. weights: the (L, ...) slabs by the names of
    ``_WEIGHT_ORDER`` (biases optional; on CUDA the LayerNorm vectors
    fp32 and the rest in x's dtype). k_pages, v_pages: (L*n_pages + 1,
    Hkv, page, D) layer-folded pools, updated in place; row L*n_pages is
    the scratch page. page_table: (S, max_pages) int32, UNFOLDED (the
    kernel adds l * n_pages for layer l). positions, row_slot, row_write:
    (B,) int32. Returns x_out (B, dm), the hidden rows after the last
    block (before the final norm)."""
    b, dm, L = _geometry(x, weights, k_pages, page_table, n_pages,
                         n_heads, kv_heads, head_dim)
    hq, hkv, d = int(n_heads), int(kv_heads), int(head_dim)
    page, P = int(page), int(n_pages)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if x.device.type == "cpu":
        return mega_decode_layers_reference(
            x, weights, k_pages, v_pages, page_table, positions, row_slot,
            row_write, page=page, n_pages=P, n_heads=hq, kv_heads=hkv,
            head_dim=d, rope=rope, rope_theta=rope_theta, scale=scale)
    ints = {"positions": positions, "row_slot": row_slot,
            "row_write": row_write}
    _check_cuda_operands(x, weights, k_pages, v_pages, page_table, ints, b,
                         dm, L, hq, hkv, d, page)
    out = torch.empty_like(x)
    if b == 0:
        return out
    f = weights["wup"].shape[-1]
    nq = (hq + 2 * hkv) * d
    stream = torch.cuda.current_stream(x.device)
    code = _DTYPE_CODES[x.dtype]
    lib = _lib()
    with torch.cuda.device(x.device):
        # the kernel's depth splits (csrc/decode_megakernel.cu
        # split_count, from the device's resident blocks) size it
        ws_len = lib.pt_mega_workspace(code, b, dm, nq, hq * d, f)
    if ws_len < 0:
        _build.check(lib, -ws_len, "mega_decode_layers workspace")
    qkv, o, u, ws = _scratch(
        ("mega", x.device, stream.cuda_stream, x.dtype, b, nq, hq * d, f),
        lambda: tuple(torch.empty((b, n), dtype=x.dtype, device=x.device)
                      for n in (nq, hq * d, f))
        + (torch.empty((max(ws_len, 1),), dtype=torch.float32,
                       device=x.device),))
    slabs = [weights.get(n) for n in _WEIGHT_ORDER]
    ptrs = (ctypes.c_void_p * len(slabs))(
        *[None if t is None else t.data_ptr() for t in slabs])
    elt = 16 // x.element_size()
    vec = int(all(n % elt == 0 for n in (dm, nq, hq * d, f, d))
              and _aligned(x, out, k_pages, v_pages, qkv, o, u,
                           *[t for t in slabs if t is not None]))
    mega_decode_layers.launches += 1
    with torch.cuda.device(x.device):
        rc = lib.pt_mega_decode(
            code, ptrs, x.data_ptr(), out.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
            positions.data_ptr(), row_slot.data_ptr(), row_write.data_ptr(),
            qkv.data_ptr(), o.data_ptr(), u.data_ptr(), ws.data_ptr(),
            ws.numel(), b, dm, L, hq, hkv,
            d, f, page, P, page_table.shape[1], int(bool(rope)),
            float(rope_theta), float(scale), vec, stream.cuda_stream)
    _build.check(lib, rc, "mega_decode_layers cooperative launch")
    return out


def mega_logits_sample(x, lnf_scale, lnf_bias, w, poison=None):
    """Fused final-norm -> logits -> greedy argmax epilogue (K9).

    x: (B, dm) rows after the last block; lnf_scale, lnf_bias: (dm,)
    (fp32 on CUDA); w: (dm, V) LM projection — row-major, or the tied
    ``wte.t()`` view, whose (V, dm) rows the kernel reads along dm;
    poison: (B,) bool/int or None, rows forced non-finite. Returns (tok,
    nonfin), (B,) int32 each; a row's token is unspecified where its
    flag is set."""
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"need x (B, dm) and w (dm, V), got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if x.device.type == "cpu":
        return mega_logits_sample_reference(x, lnf_scale, lnf_bias, w,
                                            poison)
    b, dm = x.shape
    V = w.shape[1]
    if b > MAX_ROWS:
        raise ValueError(f"the epilogue takes at most {MAX_ROWS} rows, "
                         f"got {b}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the epilogue takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if dm > MAX_D_MODEL[x.dtype]:
        raise ValueError(f"the epilogue takes d_model <= "
                         f"{MAX_D_MODEL[x.dtype]} in {x.dtype}, got {dm}")
    if not isinstance(w, torch.Tensor) or w.dtype != x.dtype:
        raise TypeError("w must be a dense tensor in x's dtype (the "
                        "epilogue has no int8 head)")
    kmajor = w.stride() == (1, dm)
    if not kmajor and not w.is_contiguous():
        raise ValueError("w must be (dm, V) row-major or a (V, dm) "
                         "tensor's transpose")
    if poison is not None:
        poison = poison.reshape(-1).to(torch.int32).contiguous()
        if poison.shape != (b,):
            raise ValueError(f"poison must be ({b},), got "
                             f"{tuple(poison.shape)}")
    for n, t, want in (("x", x, x.dtype), ("lnf_scale", lnf_scale,
                                           torch.float32),
                       ("lnf_bias", lnf_bias, torch.float32)):
        if t.dtype != want or t.numel() != (b * dm if n == "x" else dm):
            raise TypeError(f"{n} must be {want} with "
                            f"{b * dm if n == 'x' else dm} entries")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{n} must be contiguous on {x.device}")
    if w.device != x.device:
        raise ValueError(f"w must be on {x.device}")
    tok = torch.empty((b,), dtype=torch.int32, device=x.device)
    nonfin = torch.empty_like(tok)
    if b == 0:
        return tok, nonfin
    stream = torch.cuda.current_stream(x.device)
    (ws,) = _scratch(("logits", x.device, stream.cuda_stream, b),
                     lambda: (torch.zeros((2 * b + 1,), dtype=torch.int64,
                                          device=x.device),))
    elt = 16 // x.element_size()
    vec = int((dm if kmajor else V) % elt == 0 and _aligned(x, w))
    lib = _lib()
    mega_logits_sample.launches += 1
    with torch.cuda.device(x.device):
        rc = lib.pt_mega_logits(
            _DTYPE_CODES[x.dtype], x.data_ptr(), lnf_scale.data_ptr(),
            lnf_bias.data_ptr(), w.data_ptr(),
            None if poison is None else poison.data_ptr(), ws.data_ptr(),
            tok.data_ptr(), nonfin.data_ptr(), b, dm, V, int(kmajor), vec,
            stream.cuda_stream)
    _build.check(lib, rc, "mega_logits_sample launch")
    return tok, nonfin


mega_decode_layers.launches = 0
mega_logits_sample.launches = 0
