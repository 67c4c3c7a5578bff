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
  ``logits_route`` picks its kernel before the launch: bf16 heads with
  16-byte rows stream the head by TMA into wgmma
  (``logits_kernel_sm90``, its geometry from ``logits_plan``), the
  rest run on the CUDA cores (``logits_kernel``).

CUDA tensors launch the kernels; CPU tensors run the plain versions,
which are the port's own block functions (``GPTBlock._qkv`` and
``_block_tail``, ``final_ln``) composed as the JAX kernel composes them.
The tensor-core K9's launch plan ``(group, n, stages, grid)`` takes the
place of the TPU kernel's vocab tile ``vb``: ``mega_logits_sample``
takes it as ``plan=``; unset, a launch takes the autotune cache's entry
for its shapes (``tune_mega_epilogue`` fills it, keyed as JAX's
``_mega_tune_key`` plus the row count, on which the port's plan
depends), else ``logits_plan``'s formula from the device's SM count and
shared memory; ``geometry.logits_reason`` refuses a plan that cannot
launch (the counterpart of ``_resolve_vb``'s VMEM clamp). The CUDA-core
route has one plan. K8 fixes its tile widths in C and sizes its grid
from the device; the JAX package tunes nothing of it either.
"""

import ctypes
import math
from typing import Dict, Tuple

import torch

from paddle_tpu_torch.models.gpt import GPTBlock, GPTConfig, final_ln
from paddle_tpu_torch.ops import _build, autotune, geometry
from paddle_tpu_torch.ops.paged_attention import (
    paged_decode_attention_reference)

__all__ = ["mega_decode_layers", "mega_decode_layers_reference",
           "mega_logits_sample", "mega_logits_sample_reference",
           "epilogue_logits",
           "MAX_ROWS", "MAX_HEAD_DIM", "MAX_GROUP", "MAX_D_MODEL",
           "mega_decode_layers_cost", "mega_logits_sample_cost",
           "PHASES", "phase_times", "logits_route", "logits_plan",
           "logits_tile_range", "logits_candidates", "tune_mega_epilogue"]

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

# the least ring of head boxes the tensor-core K9's formula plan leaves
# beside a row group (ops/geometry.py holds the kernel's arithmetic)
_K9_MIN_STAGES = 8

# device scratch of the kernels, one set per (device, stream, geometry):
# K8's q|k|v, o and MLP rows and its workspace (the grid barrier's word,
# the split counters, the split partial sums), K9's zeroed merge words. A
# launch leaves K8's counters and K9's words zeroed again; launches on
# one stream run in order.
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


# K8's phase codes in the phase-time record (csrc/decode_megakernel.cu
# kPh*): a code names the phase that ended at its grid barrier
PHASES = ("qkv", "attention", "wo", "up", "down")


def phase_times(stamps):
    """The phases K8's phase-time record holds, in order, as (layer,
    phase, ms): each phase's time from the previous barrier (or the
    kernel's start) to the barrier that ended it, all blocks done.
    ``stamps``: the int64 buffer passed as ``mega_decode_layers(...,
    stamps=)``, zeroed before the call; the record ends at its first
    unwritten pair."""
    v = [int(t) for t in stamps.reshape(-1).tolist()]
    out, prev = [], None
    for i in range(0, len(v) - 1, 2):
        t, code = v[i], v[i + 1]
        if t == 0:
            break
        if prev is not None:
            out.append((code // 16, PHASES[code % 16], (t - prev) / 1e6))
        prev = t
    return out


def mega_logits_sample_cost(rows, d_model, vocab, elt=2):
    """(flops, HBM bytes) of one K9 call: the (vocab, d_model) head and
    the rows read once, the fp32 final-norm scale and bias, and 3 int32
    words per row (token, flag, poison); 2 flops per multiply-add of the
    head product."""
    nbytes = (vocab * d_model * elt + rows * d_model * elt
              + 2 * d_model * 4 + 3 * rows * 4)
    return 2 * rows * d_model * vocab, nbytes

def logits_route(dtype, d_model, vocab, kmajor, aligned):
    """K9's kernel for a head: ``"tensor_cores"`` (``logits_kernel_sm90``:
    the head streamed by TMA into wgmma) for bf16 with rows a multiple of
    16 bytes (d_model % 8 == 0, and vocab % 8 == 0 for a row-major
    (d_model, vocab) head) and every pointer 16-byte ``aligned``; else
    ``"cuda_cores"`` (``logits_kernel``)."""
    if (dtype == torch.bfloat16 and aligned and d_model % 8 == 0
            and (kmajor or vocab % 8 == 0)):
        return "tensor_cores"
    return "cuda_cores"


def logits_plan(rows, d_model, vocab, sms,
                smem_optin=geometry.H100_SMEM_OPTIN):
    """The tensor-core K9's formula plan for ``rows`` rows: ``(group, n,
    stages, grid)``. A group of rows is LayerNormed once into shared
    memory as the wgmma B operand, beside a ring of head boxes: the
    group holds as many rows as fit beside a ring of 8 boxes, at most
    64 (d_model 2048: 32), ``n`` is the narrowest wgmma width (8, 16, 32
    or 64) that holds the group, and the ring takes the rest of the
    shared memory (the card's ``smem_optin`` less ``geometry.K9_STATIC``),
    at most 16 boxes. ``grid``: one block per SM, at most one per
    64-column vocabulary tile. The head is read once per group:
    ceil(rows / group) times."""
    limit = smem_optin - geometry.K9_STATIC
    cap = max((n for n in geometry.K9_WIDTHS
               if geometry.k9_smem(n, d_model, _K9_MIN_STAGES) <= limit),
              default=0)
    if cap == 0:
        raise ValueError(f"d_model {d_model} leaves no room for 8 rows "
                         f"beside the head ring")
    group = min(rows, cap)
    n = min(w for w in geometry.K9_WIDTHS if w >= group)
    stages = min(geometry.K9_MAX_STAGES,
                 (limit - geometry.k9_smem(n, d_model, 0)) // geometry.K9_BOX)
    tiles = -(-vocab // geometry.K9_COLS)
    return group, n, stages, max(1, min(sms, tiles))


def logits_candidates(rows, d_model, vocab, sms,
                      smem_optin=geometry.H100_SMEM_OPTIN):
    """K9's default tuning candidates at ``rows`` rows: row groups {8,
    16, 32, 64} (at most ``rows``, each at the narrowest width that holds
    it) x ring stages {4, 8, 16} x grids {sms, sms / 2, ceil(tiles / 4),
    ceil(tiles / 8)} within the vocabulary's tiles, and the formula plan
    where it is not among them. ``geometry.logits_reason`` refuses the
    ones whose shared memory does not fit (a group must fit beside at
    least one head box)."""
    tiles = -(-vocab // geometry.K9_COLS)
    grids = sorted({g for g in (sms, sms // 2, -(-tiles // 4),
                                -(-tiles // 8)) if 1 <= g <= tiles})
    cands = []
    for group in sorted({min(g, rows) for g in geometry.K9_WIDTHS}):
        n = min(w for w in geometry.K9_WIDTHS if w >= group)
        cands += [(group, n, st, g) for st in (4, 8, 16) for g in grids]
    formula = logits_plan(rows, d_model, vocab, sms, smem_optin)
    return cands + ([formula] if formula not in cands else [])


def logits_tile_range(block, vocab, grid):
    """The 64-column vocabulary tiles ``[begin, end)`` that block
    ``block`` of a ``grid``-block tensor-core K9 takes."""
    tiles = -(-vocab // geometry.K9_COLS)
    return block * tiles // grid, (block + 1) * tiles // grid


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
                       + [ctypes.c_long, vp] + [i] * 12 + [f, f, i, vp])
        fn.restype = ctypes.c_int
        ws = lib.pt_mega_workspace
        ws.argtypes = [i] * 7
        ws.restype = ctypes.c_long
        lg = lib.pt_mega_logits
        lg.argtypes = [i] + [vp] * 8 + [i] * 5 + [vp]
        lg.restype = ctypes.c_int
        tc = lib.pt_mega_logits_sm90
        tc.argtypes = [vp] * 8 + [i] * 8 + [vp]
        tc.restype = ctypes.c_int
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
                       scale=None, stamps=None):
    """Run every layer of one decode step in one launch (K8).

    x: (B, dm) embedded rows. weights: the (L, ...) slabs by the names of
    ``_WEIGHT_ORDER`` (biases optional; on CUDA the LayerNorm vectors
    fp32 and the rest in x's dtype). k_pages, v_pages: (L*n_pages + 1,
    Hkv, page, D) layer-folded pools, updated in place; row L*n_pages is
    the scratch page. page_table: (S, max_pages) int32, UNFOLDED (the
    kernel adds l * n_pages for layer l). positions, row_slot, row_write:
    (B,) int32. Returns x_out (B, dm), the hidden rows after the last
    block (before the final norm).

    stamps: None on the serving path, or a contiguous int64 CUDA tensor
    that receives the phase-time record (``phase_times`` reads it): a
    (%globaltimer ns, code) pair after each grid barrier, as many as it
    holds. A CPU call ignores it."""
    b, dm, L = _geometry(x, weights, k_pages, page_table, n_pages,
                         n_heads, kv_heads, head_dim)
    hq, hkv, d = int(n_heads), int(kv_heads), int(head_dim)
    page, P = int(page), int(n_pages)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if stamps is not None and (stamps.dtype != torch.int64
                               or stamps.device != x.device
                               or not stamps.is_contiguous()):
        raise ValueError(f"stamps must be a contiguous int64 tensor on "
                         f"{x.device}")
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
        # the grid barrier's word, the split counters and the depth
        # splits' partial sums (csrc/decode_megakernel.cu make_plan, from
        # the device's resident blocks); zeroed once: every launch leaves
        # the counters zero
        ws_len = lib.pt_mega_workspace(code, b, dm, hq, hkv, d, f)
    if ws_len < 0:
        _build.check(lib, -ws_len, "mega_decode_layers workspace")
    qkv, o, u, ws = _scratch(
        ("mega", x.device, stream.cuda_stream, x.dtype, b, dm, nq, hq * d,
         f, ws_len),
        lambda: tuple(torch.empty((b, n), dtype=x.dtype, device=x.device)
                      for n in (nq, hq * d, f))
        + (torch.zeros((max(ws_len, 1),), dtype=torch.int32,
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
            ws.numel(), None if stamps is None else stamps.data_ptr(),
            0 if stamps is None else stamps.numel(), b, dm, L, hq, hkv,
            d, f, page, P, page_table.shape[1], int(bool(rope)),
            float(rope_theta), float(scale), vec, stream.cuda_stream)
    _build.check(lib, rc, "mega_decode_layers cooperative launch")
    return out


_PLANS = autotune.memo()        # launch shape -> the cache's plan or None


def _mega_tune_key(dm, vocab, dtype, layers, page, rows, device):
    """The cache key of a K9 launch: JAX's (dm, vocab, dtype, layers,
    page) plus the row count, which sets the port's plan, and the
    device."""
    return autotune.AutotuneCache.key(
        "paged_mega", dm=dm, vocab=vocab, dtype=str(dtype), layers=layers,
        page=page, rows=rows, device=autotune.device_key(device))


def _resolve_plan(plan, rows, dm, vocab, dtype, layers, page, device):
    """The tensor-core K9's plan: ``plan`` when given, else the autotune
    cache's entry for these shapes (read once per shape and memoised),
    else ``logits_plan``; its ring and grid clamped to what the card
    holds (``geometry.clamp_logits``); ValueError with
    ``geometry.logits_reason``'s reason when no clamp makes it launch
    (a width K9 lacks, a group wider than its width, rows that leave no
    room for one head box)."""
    crd = geometry.card(device)
    if plan is None:
        shape = (rows, dm, vocab, dtype, layers, page, device)
        if shape in _PLANS:
            plan = _PLANS[shape]
        else:
            plan = _PLANS[shape] = autotune.get_cache().get(_mega_tune_key(
                dm, vocab, dtype, layers, page, rows, device))
        if plan is None:
            return logits_plan(rows, dm, vocab, crd.sms, crd.smem_optin)
    plan = geometry.clamp_logits(plan, dm, vocab, crd)
    reason = geometry.logits_reason(plan, rows, dm, vocab, crd)
    if reason:
        raise ValueError(f"K9 plan {plan}: {reason}")
    return plan


def mega_logits_sample(x, lnf_scale, lnf_bias, w, poison=None, plan=None,
                       layers=0, page=0):
    """Fused final-norm -> logits -> greedy argmax epilogue (K9).

    x: (B, dm) rows after the last block; lnf_scale, lnf_bias: (dm,)
    (fp32 on CUDA); w: (dm, V) LM projection — row-major, or the tied
    ``wte.t()`` view, whose (V, dm) rows the kernel reads along dm;
    poison: (B,) bool/int or None, rows forced non-finite. Returns (tok,
    nonfin), (B,) int32 each; a row's token is unspecified where its
    flag is set. ``plan``: the tensor-core route's ``(group, n, stages,
    grid)`` (the module's docstring; the CUDA-core route takes none);
    ``layers`` / ``page``: the folded geometry the autotune cache is
    keyed by, as the engine passes them. No plan changes a token or a
    flag."""
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"need x (B, dm) and w (dm, V), got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    b, dm = x.shape
    V = w.shape[1]
    kmajor = w.stride() == (1, dm)
    aligned = _aligned(x, w, lnf_scale, lnf_bias)
    route = logits_route(x.dtype, dm, V, kmajor, aligned)
    if plan is not None and route != "tensor_cores":
        raise ValueError("the CUDA-core K9 has one plan: plan= is for the "
                         "tensor-core route")
    if x.device.type == "cpu":
        if plan is not None:          # checked as the card would check it
            _resolve_plan(plan, b, dm, V, x.dtype, layers, page, x.device)
        return mega_logits_sample_reference(x, lnf_scale, lnf_bias, w,
                                            poison)
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
    lib = _lib()
    mega_logits_sample.launches += 1
    poison_ptr = None if poison is None else poison.data_ptr()
    with torch.cuda.device(x.device):
        if route == "tensor_cores":
            group, n, stages, grid = _resolve_plan(
                plan, b, dm, V, x.dtype, layers, page, x.device)
            rc = lib.pt_mega_logits_sm90(
                x.data_ptr(), lnf_scale.data_ptr(), lnf_bias.data_ptr(),
                w.data_ptr(), poison_ptr, ws.data_ptr(), tok.data_ptr(),
                nonfin.data_ptr(), b, dm, V, int(kmajor), group, n, stages,
                grid, stream.cuda_stream)
        else:
            elt = 16 // x.element_size()
            vec = int((dm if kmajor else V) % elt == 0 and _aligned(x, w))
            rc = lib.pt_mega_logits(
                _DTYPE_CODES[x.dtype], x.data_ptr(), lnf_scale.data_ptr(),
                lnf_bias.data_ptr(), w.data_ptr(), poison_ptr,
                ws.data_ptr(), tok.data_ptr(), nonfin.data_ptr(), b, dm, V,
                int(kmajor), vec, stream.cuda_stream)
    _build.check(lib, rc, "mega_logits_sample launch")
    return tok, nonfin


mega_decode_layers.launches = 0
mega_logits_sample.launches = 0


def tune_mega_epilogue(x, lnf_scale, lnf_bias, w, *, layers=0, page=0,
                       candidates=None, iters=3):
    """Measure the tensor-core K9's plans ``(group, n, stages, grid)`` at
    these rows and head and cache the fastest under JAX's key plus the
    row count (``_mega_tune_key``; ``autotune.tune``). Later launches of
    the same shapes on this device without an explicit plan take it.
    Candidates default to ``logits_candidates``;
    ``geometry.logits_reason`` refuses the ones that cannot launch before
    anything runs. On CUDA tensors the kernel is timed on the device; on
    CPU tensors the plain version on the host's clock. A head the
    CUDA-core route takes (fp32, or rows not 16-byte aligned) has one
    plan: nothing is timed or cached and the return is ``(None, {})``.
    Returns (plan, timings)."""
    b, dm = x.shape
    V = w.shape[1]
    kmajor = w.stride() == (1, dm)
    if logits_route(x.dtype, dm, V, kmajor,
                    _aligned(x, w, lnf_scale, lnf_bias)) != "tensor_cores":
        return None, {}
    crd = geometry.card(x.device)
    key = _mega_tune_key(dm, V, x.dtype, layers, page, b, x.device)
    if candidates is None:
        candidates = logits_candidates(b, dm, V, crd.sms, crd.smem_optin)
    poison = torch.zeros((b,), dtype=torch.int32, device=x.device)

    def build_and_run(plan):
        mega_logits_sample(x, lnf_scale, lnf_bias, w, poison, plan=plan,
                           layers=layers, page=page)

    def geom_check(plan):
        return geometry.logits_reason(plan, b, dm, V, crd)

    return autotune.tune("paged_mega", key, candidates, build_and_run,
                         iters=iters, geom_check=geom_check,
                         device=x.device)
