"""Paged decode attention (kernels K2 fused and K2' plain), their plain
PyTorch versions, and the page allocator.

Counterpart of ``paddle_tpu/ops/pallas/paged_attention.py``: the CUDA
kernel ``paged_kernel`` in ``csrc/paged_attention.cu`` replaces the TPU
kernel ``_kernel`` (launched by ``_paged_call``, the ``pl.pallas_call``
at paged_attention.py:306) in both of its modes. Its source note says
what bounds it on the H100, what the design does about that (16-row page
tiles by bulk copy into a ring, each (row, kv head) split over a
cluster, the merge through distributed shared memory), and why the fused
in-place write is race-free under a cluster.

- ``paged_decode_attention`` (K2'): read-only pools, optional (m, l)
  online-softmax stats.
- ``paged_append_attend`` (K2): one more column for the current token's
  fresh K/V row, and that row written into page ``write_pids[b]`` at
  row ``lengths[b] % page``. The pools are updated IN PLACE (the JAX
  kernel aliases them); the returned pools are the same tensors.

CUDA tensors launch the kernel; CPU tensors run the plain version.

The launch plan is ``(splits, stages)``: the blocks of the cluster that
walks one (row, kv head) and the slots of a block's ring. These are the
port's knobs in place of the TPU kernel's ``(pages_per_program,
head_block)``, whose DMA-per-page geometry has no counterpart on the
card. Both wrappers take them as arguments; unset, a launch takes the
autotune cache's entry for its shapes (``tune_paged_attention`` fills
it), else the formula plan of static shapes (``cluster_size``,
``ring_stages``: the table's width and the (row, kv head) pairs), so the
host never reads lengths; the plan is then clamped to validity
(``geometry.clamp_paged``).
"""

import ctypes
import math
from typing import List

import torch

from paddle_tpu_torch.device import sm_count
from paddle_tpu_torch.ops import _build, autotune, geometry

__all__ = ["paged_decode_attention", "paged_decode_attention_reference",
           "paged_append_attend", "paged_append_attend_reference",
           "PageAllocator", "MAX_GROUP", "MAX_HEAD_DIM", "cluster_size",
           "ring_stages", "paged_decode_attention_cost",
           "paged_append_attend_cost", "tune_paged_attention",
           "paged_candidates"]

MAX_HEAD_DIM = 128
MAX_GROUP = 8
MAX_SPLITS = geometry.PAGED_MAX_SPLITS
MAX_STAGES = geometry.PAGED_MAX_STAGES
TILE_ROWS = geometry.PAGED_TILE_ROWS   # pool rows a bulk-copied tile holds
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MASK_FLOOR = -1e30


def cluster_size(max_pages, page, pairs, sms):
    """Blocks of the cluster that walks one (row, kv head), from static
    shapes only: the table's width T = max_pages * page and the launch's
    (row, kv head) ``pairs`` on a card of ``sms`` SMs. The largest power
    of two, at most 8, that leaves each block at least 64 of the table's
    rows (4 tiles) and keeps the grid within 4 blocks an SM: K2's 8 rows
    x 16 kv heads take 4 (T 256 or 2048), the suffix prefill's 64 x 16
    take 1. A longer share per block costs less than a second wave or a
    wider merge (PERF.md §6, the K2 geometry sweep)."""
    t = max_pages * page
    s = 1
    while (s < MAX_SPLITS and 2 * s * 64 <= t
           and 2 * s * pairs <= 4 * sms):
        s *= 2
    return s


def ring_stages(max_pages, page, splits):
    """Ring slots of a block: the tiles of the longest share a block can
    get, ceil(T / (16 * splits)), at most MAX_STAGES (4), at least 1."""
    t = max_pages * page
    return max(1, min(MAX_STAGES, -(-t // (TILE_ROWS * splits))))


_PLANS = autotune.memo()        # launch shape -> the cache's plan or None


def _tune_key(page, hkv, d, dtype, group, fused, table_rows, pairs,
              device):
    """The cache key of a launch: the JAX key's (page, Hkv, D, dtype,
    group) per mode, plus what sets the port's plan: the table's width
    in rows, the (row, kv head) pairs, and the device."""
    return autotune.AutotuneCache.key(
        "paged_append" if fused else "paged_attention", page=page, hkv=hkv,
        d=d, dtype=str(dtype), group=group, table=table_rows, pairs=pairs,
        device=autotune.device_key(device))


def _resolve_config(splits, stages, max_pages, page, pairs, hkv, d, dtype,
                    group, fused, device, sms):
    """The launch plan ``(splits, stages)``: an explicit argument wins,
    else the autotune cache's entry for these shapes (read once per shape
    and memoised), else ``cluster_size`` / ``ring_stages``; then clamped
    to validity (``geometry.clamp_paged``)."""
    if splits is None or stages is None:
        shape = (max_pages, page, pairs, hkv, d, dtype, group, fused,
                 device)
        if shape in _PLANS:
            hit = _PLANS[shape]
        else:
            hit = _PLANS[shape] = autotune.get_cache().get(_tune_key(
                page, hkv, d, dtype, group, fused, max_pages * page, pairs,
                device))
        if hit is not None:
            splits = hit[0] if splits is None else splits
            stages = hit[1] if stages is None else stages
        else:
            if splits is None:
                splits = cluster_size(max_pages, page, pairs, sms)
            if stages is None:
                stages = ring_stages(max_pages, page, splits)
    return geometry.clamp_paged(splits, stages, max_pages, page)


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
                       i, i, i, i, i, i, ctypes.c_float, i, i, i, vp]
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
    if k_pages.shape[2] % TILE_ROWS:
        raise ValueError(f"paged attention kernel takes a page of a "
                         f"multiple of {TILE_ROWS} rows, got "
                         f"{k_pages.shape[2]}")
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
            k_row=None, v_row=None, write_pids=None, splits=None,
            stages=None):
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
    max_pages = page_table.shape[1]
    splits, stages = _resolve_config(
        splits, stages, max_pages, page, b * hkv, hkv, d, q.dtype,
        hq // hkv, k_row is not None, q.device, sm_count(q.device))
    ptrs = [t for t in (q, k_pages, v_pages, k_row, v_row, o)
            if t is not None]
    aligned = int(d * q.element_size() % 16 == 0
                  and all(t.data_ptr() % 16 == 0 for t in ptrs))
    wrapper.launches += 1
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.pt_paged_attention(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
            ptr(k_row), ptr(v_row), ptr(write_pids), o.data_ptr(), ptr(m),
            ptr(l), b, hq, hkv, d, page, max_pages, float(scale), aligned,
            splits, stages, stream)
    _build.check(lib, rc, "paged_attention launch")
    return o, m, l


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths,
                           scale=None, return_stats=False, splits=None,
                           stages=None):
    """One query row per sequence over a PAGED KV pool (K2').

    q (B, Hq, D); pools (P, Hkv, page, D); page_table (B, max_pages)
    int32, entries past ceil(lengths[b] / page) ignored; lengths (B,)
    int32. Returns o (B, Hq, D) in q's dtype, and with ``return_stats``
    also m, l (B, Hq) fp32 — the running max (-inf for an empty row) and
    the softmax denominator. ``splits`` / ``stages``: the launch plan
    (the module's docstring); unset, the cache's or the formula's. The
    plan changes no result beyond fp32 summation order."""
    _check_operands(q, k_pages, v_pages, page_table, lengths)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, k_pages, v_pages, page_table, lengths, scale, return_stats)
    o, m, l = _launch(q, k_pages, v_pages, page_table, lengths, scale,
                      return_stats, splits=splits, stages=stages)
    return (o, m, l) if return_stats else o


def paged_append_attend(q, k_pages, v_pages, k_row, v_row, page_table,
                        write_pids, lengths, scale=None, splits=None,
                        stages=None):
    """FUSED append+attend decode step over a paged KV pool (K2).

    Attends row b over its prefix [0, lengths[b]) plus its fresh row
    (k_row/v_row (B, Hkv, D) in pool dtype), and writes the fresh row
    into ``k_pages/v_pages[write_pids[b], :, lengths[b] % page, :]`` IN
    PLACE. Callers point inactive rows' ``write_pids`` at a scratch page.
    Returns (o, k_pages, v_pages); the pools are the input tensors.
    ``splits`` / ``stages``: as for ``paged_decode_attention``."""
    _check_operands(q, k_pages, v_pages, page_table, lengths, k_row, v_row,
                    write_pids)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return paged_append_attend_reference(
            q, k_pages, v_pages, k_row, v_row, page_table, write_pids,
            lengths, scale)
    o, _, _ = _launch(q, k_pages, v_pages, page_table, lengths, scale,
                      False, k_row, v_row, write_pids, splits, stages)
    return o, k_pages, v_pages


paged_decode_attention.launches = 0
paged_append_attend.launches = 0


def paged_candidates(max_pages, page, pairs, sms):
    """K2's default tuning candidates: splits {1, 2, 4, 8} x stages {1,
    2, 4}, and the formula plan where it is not among them (the guard
    refuses what cannot launch)."""
    cands = [(s, st) for s in (1, 2, 4, 8) for st in (1, 2, 4)]
    splits = cluster_size(max_pages, page, pairs, sms)
    formula = (splits, ring_stages(max_pages, page, splits))
    return cands + ([formula] if formula not in cands else [])


def tune_paged_attention(q, k_pages, v_pages, page_table, lengths,
                         scale=None, fused=True, candidates=None, iters=3):
    """Measure K2 (``fused``) or K2' launch plans ``(splits, stages)`` on
    these shapes and cache the fastest (``autotune.tune``; the JAX
    tuner's knobs are ``(pages_per_program, head_block)``, see the
    module's docstring). Later launches of the same shapes on this device
    without an explicit plan take it. Candidates default to
    ``paged_candidates``; ``geometry.paged_reason`` refuses the ones that
    cannot launch before anything runs. On CUDA tensors the kernel is
    timed on the device; on CPU tensors the plain version on the host's
    clock (its result is the same for every plan).

    The fused timing writes zero rows into the pools IN PLACE, at row
    ``lengths[b] % page`` of page ``page_table[b, 0]``, as K2 does:
    tune on throwaway pools. Keyed as ``_tune_key``. Returns (config,
    timings)."""
    b, hq, d = q.shape
    hkv, page = k_pages.shape[1], k_pages.shape[2]
    max_pages = page_table.shape[1]
    group = hq // hkv
    crd = geometry.card(q.device)
    key = _tune_key(page, hkv, d, q.dtype, group, fused, max_pages * page,
                    b * hkv, q.device)
    if candidates is None:
        candidates = paged_candidates(max_pages, page, b * hkv, crd.sms)
    if fused:
        k_row = torch.zeros((b, hkv, d), dtype=k_pages.dtype,
                            device=q.device)
        v_row = torch.zeros_like(k_row)
        wpids = page_table[:, 0].contiguous()

    def build_and_run(cfg):
        splits, stages = cfg
        if fused:
            paged_append_attend(q, k_pages, v_pages, k_row, v_row,
                                page_table, wpids, lengths, scale,
                                splits=splits, stages=stages)
        else:
            paged_decode_attention(q, k_pages, v_pages, page_table, lengths,
                                   scale, splits=splits, stages=stages)

    def geom_check(cfg):
        return geometry.paged_reason(cfg[0], cfg[1], max_pages, page, group,
                                     d, q.element_size(), crd)

    return autotune.tune("paged_append" if fused else "paged_attention",
                         key, candidates, build_and_run, iters=iters,
                         geom_check=geom_check, device=q.device)


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
