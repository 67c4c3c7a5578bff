"""Paged decode attention (kernels K2 fused and K2' plain), their plain
PyTorch versions, and the page allocator.

Counterpart of ``paddle_tpu/ops/pallas/paged_attention.py``: the CUDA
kernel in ``csrc/paged_attention.cu`` replaces the TPU kernel ``_kernel``
(launched by ``_paged_call``, the ``pl.pallas_call`` at
paged_attention.py:306) in both of its modes. Its source note says what
bounds it on the H100, what the design does about that, and why the
fused in-place write is race-free.

- ``paged_decode_attention`` (K2'): read-only pools, optional (m, l)
  online-softmax stats.
- ``paged_append_attend`` (K2): one more column for the current token's
  fresh K/V row, and that row written into page ``write_pids[b]`` at
  row ``lengths[b] % page``. The pools are updated IN PLACE (the JAX
  kernel aliases them); the returned pools are the same tensors.

CUDA tensors launch the kernel; CPU tensors run the plain version. The
TPU kernel's (pages_per_program, head_block) autotune geometry has no
counterpart here.
"""

import ctypes
import math
from typing import List

import torch

from paddle_tpu_torch.ops import _build

__all__ = ["paged_decode_attention", "paged_decode_attention_reference",
           "paged_append_attend", "paged_append_attend_reference",
           "PageAllocator", "MAX_GROUP", "MAX_HEAD_DIM", "paged_decode_attention_cost", "paged_append_attend_cost"]

MAX_HEAD_DIM = 128
MAX_GROUP = 8
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MASK_FLOOR = -1e30


def paged_decode_attention_cost(lengths, n_heads, kv_heads, head_dim,
                                elt=2, kv_tokens=None):
    """(flops, HBM bytes) of one K2' call over query rows attending
    ``lengths`` keys each: q read and o written once, 8 int32 words of
    table and length per row, the K and V rows of ``kv_tokens`` distinct
    keys (default sum(lengths); rows over one sequence, as the suffix
    prefill's, pass its length) read once; 4 flops per head dim per
    (query head, key)."""
    rows = len(lengths)
    kv_tokens = sum(lengths) if kv_tokens is None else kv_tokens
    nbytes = (2 * rows * n_heads * head_dim * elt
              + 2 * kv_tokens * kv_heads * head_dim * elt + 8 * rows * 4)
    return 4 * sum(lengths) * n_heads * head_dim, nbytes


def paged_append_attend_cost(lengths, n_heads, kv_heads, head_dim, elt=2):
    """(flops, HBM bytes) of one K2 call with ``lengths`` cached keys per
    row: K2' over them, plus each row's fresh K and V rows read and
    written into their page and attended as one more key."""
    rows = len(lengths)
    _, nbytes = paged_decode_attention_cost(lengths, n_heads, kv_heads,
                                            head_dim, elt)
    nbytes += 4 * rows * kv_heads * head_dim * elt
    flops = 4 * (sum(lengths) + rows) * n_heads * head_dim
    return flops, nbytes

def _attend_f32(q, k_pages, v_pages, page_table, lengths, scale):
    """fp32 (o, m, l) of the masked softmax over each row's first
    lengths[b] pool rows (gathered through its table)."""
    b, hq, d = q.shape
    hkv = k_pages.shape[1]
    group = hq // hkv
    table = page_table.long()
    # (B, max_pages, Hkv, page, D) -> (B, Hkv, max_pages * page, D)
    kc = k_pages[table].transpose(1, 2).reshape(b, hkv, -1, d).float()
    vc = v_pages[table].transpose(1, 2).reshape(b, hkv, -1, d).float()
    qg = q.reshape(b, hkv, group, d).float()
    s = torch.einsum("bhgd,bhtd->bhgt", qg, kc) * scale
    t = torch.arange(kc.shape[2], device=q.device)
    valid = t[None, :] < lengths.long()[:, None]
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1)
    p = torch.exp(s - m.clamp(min=_MASK_FLOOR)[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhgt,bhtd->bhgd", p, vc)
    o = o / torch.where(l == 0, torch.ones_like(l), l)[..., None]
    return o.reshape(b, hq, d), m.reshape(b, hq), l.reshape(b, hq)


def paged_decode_attention_reference(q, k_pages, v_pages, page_table,
                                     lengths, scale=None,
                                     return_stats=False):
    """Plain PyTorch version of K2': gather each row's pages, then a
    masked softmax in fp32. m (the running max; -inf for an empty row)
    and l (the denominator) are (B, Hq) fp32."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    o, m, l = _attend_f32(q, k_pages, v_pages, page_table, lengths, scale)
    o = o.to(q.dtype)
    return (o, m, l) if return_stats else o


def paged_append_attend_reference(q, k_pages, v_pages, k_row, v_row,
                                  page_table, write_pids, lengths,
                                  scale=None):
    """Plain PyTorch version of K2: attention over [prefix + fresh row]
    (the fresh column folded into the prefix's online-softmax stats, as
    ``fold_fresh_row`` does in the JAX package), then the fresh row
    written into its page in place. Returns (o, k_pages, v_pages)."""
    b, hq, d = q.shape
    hkv, page = k_pages.shape[1], k_pages.shape[2]
    group = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    o, m, l = _attend_f32(q, k_pages, v_pages, page_table, lengths, scale)
    qg = q.reshape(b, hkv, group, d).float()
    s_new = (torch.einsum("bhgd,bhd->bhg", qg, k_row.float())
             * scale).reshape(b, hq)
    m2 = torch.maximum(m, s_new)
    w_pre = l * torch.exp(m - m2)
    w_new = torch.exp(s_new - m2)
    v_new = v_row.float().repeat_interleave(group, dim=1)
    o = ((o * w_pre[..., None] + v_new * w_new[..., None])
         / (w_pre + w_new)[..., None])
    pids = write_pids.long()
    offs = (lengths % page).long()
    k_pages[pids, :, offs, :] = k_row.to(k_pages.dtype)
    v_pages[pids, :, offs, :] = v_row.to(v_pages.dtype)
    return o.to(q.dtype), k_pages, v_pages


def _lib():
    lib = _build.load("paged_attention")
    fn = lib.pt_paged_attention
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
                       i, i, i, i, i, i, ctypes.c_float, vp]
        fn.restype = ctypes.c_int
    return lib


def _check_operands(q, k_pages, v_pages, page_table, lengths, k_row=None,
                    v_row=None, write_pids=None):
    """Shape checks everywhere; device/dtype/contiguity checks before
    pointers go to C."""
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"need q (B,Hq,D) and pools (P,Hkv,page,D), got "
                         f"{tuple(q.shape)}, {tuple(k_pages.shape)}")
    b, hq, d = q.shape
    hkv = k_pages.shape[1]
    if k_pages.shape[3] != d:
        raise ValueError("q and pools disagree on head_dim")
    if hq % hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {hq} vs {hkv}")
    if page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError(f"page_table must be (B, max_pages), got "
                         f"{tuple(page_table.shape)}")
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be ({b},), got "
                         f"{tuple(lengths.shape)}")
    fused = k_row is not None
    if fused:
        if k_row.shape != (b, hkv, d) or v_row.shape != (b, hkv, d):
            raise ValueError(f"k_row/v_row must be ({b}, {hkv}, {d}), got "
                             f"{tuple(k_row.shape)}, {tuple(v_row.shape)}")
        if write_pids.shape != (b,):
            raise ValueError(f"write_pids must be ({b},), got "
                             f"{tuple(write_pids.shape)}")
    if q.device.type != "cuda":
        return
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"paged attention kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    if d > MAX_HEAD_DIM or hq // hkv > MAX_GROUP:
        raise ValueError(f"paged attention kernel takes head_dim <= "
                         f"{MAX_HEAD_DIM} and Hq/Hkv <= {MAX_GROUP}, got "
                         f"{d} and {hq // hkv}")
    floats = [("q", q), ("k_pages", k_pages), ("v_pages", v_pages)]
    ints = [("page_table", page_table), ("lengths", lengths)]
    if fused:
        floats += [("k_row", k_row), ("v_row", v_row)]
        ints.append(("write_pids", write_pids))
    for (name, t), want in ([(f, q.dtype) for f in floats]
                            + [(i, torch.int32) for i in ints]):
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")


def _launch(q, k_pages, v_pages, page_table, lengths, scale, stats,
            k_row=None, v_row=None, write_pids=None):
    b, hq, d = q.shape
    hkv, page = k_pages.shape[1], k_pages.shape[2]
    o = torch.empty_like(q)
    m = l = None
    if stats:
        m = torch.empty((b, hq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    if b == 0:
        return o, m, l
    lib = _lib()
    wrapper = paged_decode_attention if k_row is None else \
        paged_append_attend
    wrapper.launches += 1
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.pt_paged_attention(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
            ptr(k_row), ptr(v_row), ptr(write_pids), o.data_ptr(), ptr(m),
            ptr(l), b, hq, hkv, d, page, page_table.shape[1], float(scale),
            stream)
    _build.check(lib, rc, "paged_attention launch")
    return o, m, l


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths,
                           scale=None, return_stats=False):
    """One query row per sequence over a PAGED KV pool (K2').

    q (B, Hq, D); pools (P, Hkv, page, D); page_table (B, max_pages)
    int32, entries past ceil(lengths[b] / page) ignored; lengths (B,)
    int32. Returns o (B, Hq, D) in q's dtype, and with ``return_stats``
    also m, l (B, Hq) fp32 — the running max (-inf for an empty row) and
    the softmax denominator."""
    _check_operands(q, k_pages, v_pages, page_table, lengths)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, k_pages, v_pages, page_table, lengths, scale, return_stats)
    o, m, l = _launch(q, k_pages, v_pages, page_table, lengths, scale,
                      return_stats)
    return (o, m, l) if return_stats else o


def paged_append_attend(q, k_pages, v_pages, k_row, v_row, page_table,
                        write_pids, lengths, scale=None):
    """FUSED append+attend decode step over a paged KV pool (K2).

    Attends row b over its prefix [0, lengths[b]) plus its fresh row
    (k_row/v_row (B, Hkv, D) in pool dtype), and writes the fresh row
    into ``k_pages/v_pages[write_pids[b], :, lengths[b] % page, :]`` IN
    PLACE. Callers point inactive rows' ``write_pids`` at a scratch page.
    Returns (o, k_pages, v_pages); the pools are the input tensors."""
    _check_operands(q, k_pages, v_pages, page_table, lengths, k_row, v_row,
                    write_pids)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return paged_append_attend_reference(
            q, k_pages, v_pages, k_row, v_row, page_table, write_pids,
            lengths, scale)
    o, _, _ = _launch(q, k_pages, v_pages, page_table, lengths, scale,
                      False, k_row, v_row, write_pids)
    return o, k_pages, v_pages


paged_decode_attention.launches = 0
paged_append_attend.launches = 0


class PageAllocator:
    """LIFO free-list page allocator (a copy of the JAX package's): the
    one reserve/release implementation of the paged serving engine."""

    def __init__(self, n_pages: int, page_size: int,
                 max_pages_per_seq: int = 0):
        self.page = int(page_size)
        self.n_pages = int(n_pages)
        self.max_pages = int(max_pages_per_seq)
        self._free = list(range(n_pages - 1, -1, -1))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def reserve(self, table: List[int], n_tokens: int) -> List[int]:
        """Grow ``table`` (a list of page ids) to cover ``n_tokens``."""
        need = (n_tokens + self.page - 1) // self.page
        while len(table) < need:
            if not self._free:
                raise MemoryError("page pool exhausted")
            if self.max_pages and len(table) >= self.max_pages:
                raise MemoryError(
                    f"sequence exceeds max_pages_per_seq="
                    f"{self.max_pages}")
            table.append(self._free.pop())
        return table

    def release(self, table: List[int]):
        self._free.extend(reversed(table))
        table.clear()
