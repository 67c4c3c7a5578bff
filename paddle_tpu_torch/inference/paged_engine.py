"""Paged continuous-batching decode engine (counterpart of
``paddle_tpu/inference/paged_engine.py``): greedy serving over one
shared pool of KV pages, so memory scales with the live tokens rather
than slots x max_len.

Design, as in the JAX engine:

- **Layer-folded pools**: the per-layer pools are one
  (L*P + 1, Hkv, page, D) tensor per K and V; layer l's view of page p
  is row ``l*P + p``, and the last row is the scratch page that inactive
  slots' decode writes land in. The kernels take the whole pool and a
  per-layer folded table (``l*P + table``).
- **One-pass bucketed prefill**: a prompt attends only to itself, so it
  runs through the dense causal forward (the flash kernel K1 on CUDA)
  at a power-of-two bucket, and its valid K/V rows are written into the
  sequence's pages.
- **Prefix cache** (default; ``prefix=False`` disables): admission
  maps the longest cached page-aligned prefix read-only and prefills
  only the suffix — each layer writes the suffix rows into the slot's
  pages, then the paged kernel K2' attends with one query row per
  suffix position.
- **Single-dispatch decode** (``mega``, the default for a dense bf16
  or fp32 stack, as in the JAX engine): each decode step embeds the
  tokens, runs every layer in ONE launch of the decode megakernel (K8)
  over the unfolded page table — one row per slot, the active slots
  writing their fresh K/V rows into their pages, the others into the
  scratch page — and samples with ONE launch of the fused final-norm ->
  logits -> argmax epilogue (K9), whose non-finite flag evicts a slot.
  A ``quantize_for_inference`` model (int8 ``QuantTensor`` blocks) has
  no int8 weight stream in the megakernel, in either package: it takes
  the per-layer path, and ``mega=True`` raises for it.
- **Fused per-layer decode** (``mega=False``): each decode step runs,
  per layer, one ``paged_append_attend`` launch (K2) that folds the
  fresh K/V row into the attention and writes it into its page in
  place.
- ``steps_per_call`` steps run per dispatch with per-slot
  eos/budget/non-finite early stop on the device, and return ONE packed
  (3, chunk, S) int32 record, so a harvest is one device→host copy.
- **Pipelined dispatch** (``inflight``, default 2): see
  ``decode_engine.ResilientScheduler``.
- **Instrumentation** (``decode_engine``'s docstring): the same trace
  spans (``serve/dispatch`` with ``kind="paged"``; ``serve/admit``
  around each prefill), flight records (``admit``, ``evicted``), fault
  site ``engine.poison_logits`` (K9's ``poison`` operand on the
  single-dispatch path), ``warmup``, ``dispatch_cost`` and
  ``dispatch_fn_args``.

- **Autotune** (``autotune()``, or ``PT_PAGED_TUNE=1`` from the
  constructor, before ``warmup``): K2's plan at this engine's shapes
  and, with ``mega``, K9's at its decode rows and its verify rows
  (``ops/autotune.py``; the cache file is ``PT_AUTOTUNE_CACHE``).

- **KV handoff** (``serving/kv_transfer.py`` is the wire): a
  ``prefill_only`` engine admits and prefills but never decodes (its
  first-token metric is ``serve/prefill_s``); ``detach_handoff`` takes a
  request's pages and decode state off any engine (right after prefill,
  or mid-decode: a drain migration) and ``submit_handoff`` queues them
  on a receiver, whose admission installs the pages (one ``index_copy_``
  per pool) and continues the stream where the sender stopped;
  ``kv_bytes`` is the pages held. ``attach_fleet`` wires a
  ``serving/disagg.FleetPrefixDirectory``: admission extends a local
  prefix miss through the fleet, new prefix pages publish, and local
  invalidation or reclaim withdraws fleet-wide.

The JAX engine's read-only-pool fallback (``fused=False``) is a reference
formulation and has no counterpart here.
"""

import collections
import math
import os
import time
from typing import List, Optional

import numpy as np
import torch

from paddle_tpu_torch import device as device_lib
from paddle_tpu_torch import stats
from paddle_tpu_torch.inference.decode_engine import (Request,
                                                      ResilientScheduler,
                                                      _HandoffRequest,
                                                      _Inflight,
                                                      block_matmul_cost,
                                                      handoff_meta,
                                                      handoff_request,
                                                      handoff_rows,
                                                      resolve_engine_weights)
from paddle_tpu_torch.inference.prefix_cache import PrefixCache
from paddle_tpu_torch.models.gpt import GPTBlock
from paddle_tpu_torch.nn.functional import scaled_dot_product_attention
from paddle_tpu_torch.observability import devprof, flight, trace
from paddle_tpu_torch.ops import decode_megakernel as _mk
from paddle_tpu_torch.ops.decode_megakernel import (_WEIGHT_ORDER,
                                                    mega_decode_layers,
                                                    mega_decode_layers_cost,
                                                    mega_logits_sample,
                                                    mega_logits_sample_cost)
from paddle_tpu_torch.ops.paged_attention import (
    PageAllocator, paged_append_attend, paged_append_attend_cost,
    paged_decode_attention, paged_decode_attention_cost)

__all__ = ["PagedDecodeEngine"]


class PagedDecodeEngine(ResilientScheduler):
    """Continuous-batching greedy generation over a paged KV pool.

        eng = PagedDecodeEngine(model, n_pages=64, max_slots=8)
        r = eng.submit(prompt, max_new_tokens=64, eos_id=2)
        eng.run()                                  # r.tokens

    ``device`` defaults to CUDA and must be the model's device."""

    def __init__(self, model, n_pages: int, max_slots: int = 8,
                 page_size: int = 128, steps_per_call: int = 1,
                 buckets=(16, 32, 64, 128, 256, 512),
                 share_weights_with=None, inflight: int = 2,
                 warmup: bool = False, prefix: bool = True,
                 prefill_only: bool = False, mega: Optional[bool] = None,
                 speculative_k: int = 0, device=None):
        self.device = device_lib.resolve(device)
        cfg, head, layers, stacked = resolve_engine_weights(
            model, share_weights_with)
        if head["wte"].device != self.device:
            raise ValueError(f"model lives on {head['wte'].device}, engine "
                             f"device is {self.device}")
        if page_size % 128:
            raise ValueError("page_size must be a multiple of 128")
        self.cfg = cfg
        self.S = int(max_slots)
        self.page = int(page_size)
        self.P = int(n_pages)
        self.chunk = int(steps_per_call)
        self.spec_k = int(speculative_k)
        self._check_spec(0.0)
        self.buckets = sorted(b for b in buckets if b <= cfg.max_seq_len)
        self._head, self._layers, self._stacked = head, layers, stacked
        # the megakernel streams dense (L, ...) slabs and a dense head;
        # int8 QuantTensors go through K12 on the per-layer path
        dense = (isinstance(head["proj"], torch.Tensor)
                 and all(n in stacked for n in _WEIGHT_ORDER
                         if n in layers[0]))
        if mega is None:
            mega = dense and cfg.dtype in (torch.bfloat16, torch.float32)
        elif mega and not dense:
            raise ValueError(
                "mega=True needs dense weights: the decode megakernel has "
                "no int8 weight stream (serve a quantize_for_inference "
                "model with mega=False)")
        self.mega = bool(mega)
        self._block = GPTBlock(cfg)
        self.scale = 1.0 / math.sqrt(cfg.head_dim)
        self._mx = (cfg.max_seq_len + self.page - 1) // self.page
        L = cfg.n_layers
        dev = self.device
        # layer-folded pools: page p of layer l lives at row l*P + p; the
        # last row is the scratch page idle slots' decode writes land in
        shape = (L * self.P + 1, cfg.kv_heads, self.page, cfg.head_dim)
        self.kp = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        self.vp = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        self._scratch = L * self.P
        self._layer_base = (torch.arange(L, dtype=torch.int32, device=dev)
                            * self.P)
        self._alloc = PageAllocator(self.P, self.page)
        self._prefix = (PrefixCache(self._alloc, self.page)
                        if prefix else None)
        # a prefill-only engine admits and prefills but never decodes: its
        # slots stay bound, device-inactive, until detach_handoff; its
        # "first token" marks the end of prefill, never a client TTFT
        self.prefill_only = bool(prefill_only)
        if self.prefill_only:
            self._ttft_metric = "serve/prefill_s"
        self.fleet = None
        # pages whose KV arrived over a LOSSY wire (int8/fp8 handoff or
        # fleet fetch): served and shared locally, never re-published to
        # the fleet (re-quantizing compounds the half-step error)
        self._lossy_pids: set = set()
        self._tables: List[List[int]] = [[] for _ in range(self.S)]
        # slots evicted for non-finite logits: their private pages are
        # zeroed as they return to the free list (see _release)
        self._tainted: set = set()
        i32 = dict(dtype=torch.int32, device=dev)
        # the megakernel's flat rows: row s is slot s; a verify's row
        # s·K + j is slot s's j-th candidate
        self._rows = torch.arange(self.S, **i32)
        self._spec_rows = self._rows.repeat_interleave(max(1, self.spec_k))
        self.lengths = torch.zeros((self.S,), **i32)
        self.last = torch.zeros((self.S,), **i32)
        self.active = torch.zeros((self.S,), dtype=torch.bool, device=dev)
        # budgets / eos ids persist on device across dispatches
        self.remaining = torch.zeros((self.S,), **i32)
        self.eos_ids = torch.full((self.S,), -1, **i32)
        # speculative only: the token history the drafts read
        self.toks = (torch.zeros((self.S, cfg.max_seq_len), **i32)
                     if self.spec_k else None)
        self._slot_req: List[Optional[Request]] = [None] * self.S
        self._waiting: collections.deque = collections.deque()
        self.steps = 0
        self.tokens_emitted = 0
        self._init_pipeline(inflight)
        # host shadows for page reservation: _host_len is the harvested
        # (exact) length; _proj_len an upper bound over in-flight work
        self._host_len = np.zeros((self.S,), np.int64)
        self._proj_len = np.zeros((self.S,), np.int64)
        self._table_dev = None
        self._table_dirty = True
        self._update_pool_gauges()
        if os.environ.get("PT_PAGED_TUNE", "0") == "1":
            # tune before the first launch: the kernels read the tuned
            # plans from the autotune cache at launch time
            self.autotune()
        if warmup:
            self.warmup()

    def autotune(self, iters: int = 3, candidates=None):
        """Measure K2's launch plans ``(splits, stages)`` at this engine's
        shapes and persist the winner in the autotune cache
        (``ops/autotune.py``); with ``mega`` also K9's plans at the decode
        step's S rows and, with ``speculative_k``, at each row count a
        verify launch takes (S x K in groups of ``_verify_group_rows``):
        the port's K9 plan depends on the rows. The representative
        shapes are JAX's: the full batch, distinct in-range pages (in
        throwaway zero pools, so the engine's pools are untouched),
        lengths ``max(1, max_seq_len // 2)``, zero rows for K9. Later
        launches at these shapes take the tuned plans; ``PT_PAGED_TUNE=1``
        runs this from the constructor. Returns K2's (config, timings)."""
        from paddle_tpu_torch.ops.decode_megakernel import tune_mega_epilogue
        from paddle_tpu_torch.ops.paged_attention import tune_paged_attention
        cfg = self.cfg
        dev, dt = self.device, self.kp.dtype
        n = self.S * self._mx
        pool = (n, cfg.kv_heads, self.page, cfg.head_dim)
        kp = torch.zeros(pool, dtype=dt, device=dev)
        vp = torch.zeros_like(kp)
        q = torch.zeros((self.S, cfg.n_heads, cfg.head_dim), dtype=dt,
                        device=dev)
        table = torch.arange(n, dtype=torch.int32,
                             device=dev).reshape(self.S, self._mx)
        lengths = torch.full((self.S,), max(1, cfg.max_seq_len // 2),
                             dtype=torch.int32, device=dev)
        res = tune_paged_attention(q, kp, vp, table, lengths,
                                   scale=self.scale, fused=True,
                                   candidates=candidates, iters=iters)
        del kp, vp
        if self.mega:
            rows = {self.S}
            if self.spec_k:
                total, per = self.S * self.spec_k, self._verify_group_rows
                rows |= {per} if total >= per else {total}
                if total > per and total % per:
                    rows.add(total % per)
            head = self._head
            for r in sorted(rows):
                x = torch.zeros((r, cfg.d_model), dtype=cfg.dtype,
                                device=dev)
                tune_mega_epilogue(x, head["lnf_scale"], head["lnf_bias"],
                                   head["proj"], layers=cfg.n_layers,
                                   page=self.page, iters=iters)
        return res

    # -- pool bookkeeping ---------------------------------------------------

    @property
    def free_pages(self) -> int:
        return self._alloc.free_pages

    @property
    def kv_bytes(self) -> int:
        """Outstanding KV bytes (pages mapped by slots, both pools): the
        decode-placement load gauge."""
        cfg = self.cfg
        per_page = (2 * cfg.n_layers * cfg.kv_heads * self.page
                    * cfg.head_dim * self.kp.element_size())
        return sum(len(t) for t in self._tables) * per_page

    def _update_pool_gauges(self):
        stats.set_value("serve/pool_pages_free", self._alloc.free_pages)
        if self._prefix is not None:
            stats.set_value("serve/pool_pages_shared",
                            self._prefix.shared_pages)
            stats.set_value("serve/pool_pages_cached",
                            self._prefix.cached_pages)

    def _reserve(self, slot: int, n_tokens: int):
        tab = self._tables[slot]
        before = len(tab)
        try:
            self._alloc.reserve(tab, n_tokens)
        except MemoryError:
            # pool pressure: reclaim LRU refcount-zero prefix pages (warm
            # cache, not live sequences) before giving up
            need = (n_tokens + self.page - 1) // self.page - len(tab)
            if (self._prefix is None or self._prefix.reclaim(
                    need - self._alloc.free_pages) == 0):
                raise
            self._alloc.reserve(tab, n_tokens)
        if len(tab) != before:
            self._table_dirty = True
            self._update_pool_gauges()

    def _release(self, slot: int):
        tab = self._tables[slot]
        if tab:
            self._table_dirty = True
        scrub: List[int] = []
        if self._prefix is not None:
            # cached pages are refcounted, not freed (filter on the
            # PRE-unref keep set: unref of an invalidated page frees it)
            keep = [p for p in tab if self._prefix.owns(p)]
            for p in keep:
                if self._prefix.unref(p) is not None:
                    scrub.append(p)
            kept = set(keep)
            tab[:] = [p for p in tab if p not in kept]
        if slot in self._tainted:
            # non-finite eviction: the private pages hold KV computed
            # from poisoned activations — zero them on the way out
            self._tainted.discard(slot)
            scrub.extend(tab)
        self._alloc.release(tab)
        self._lossy_pids.difference_update(tab)
        self._lossy_pids.difference_update(scrub)
        if scrub:
            self._scrub_pages(scrub)
        self._update_pool_gauges()

    def _page_rows(self, pids) -> torch.Tensor:
        """The folded pool rows of ``pids`` in every layer, layer-major:
        row ``l * P + pids[j]`` at ``l * len(pids) + j``."""
        return (self._layer_base.long()[:, None]
                + torch.as_tensor(pids, dtype=torch.long,
                                  device=self.device)[None]).reshape(-1)

    def _scrub_pages(self, pids):
        """Zero ``pids``' rows in both pools, every layer's view."""
        ids = self._page_rows(pids)
        self.kp[ids] = 0
        self.vp[ids] = 0

    def _read_pages(self, pids):
        """``pids``' K and V in every layer as (L, len(pids), Hkv, page,
        D) CPU tensors: a deliberate device->host copy (the handoff and
        fleet payloads)."""
        cfg = self.cfg
        shape = (cfg.n_layers, len(pids), cfg.kv_heads, self.page,
                 cfg.head_dim)
        ids = self._page_rows(pids)
        return (self.kp[ids].cpu().reshape(shape),
                self.vp[ids].cpu().reshape(shape))

    def _install(self, ids, k, v):
        """Write (rows, Hkv, page, D) device tensors into both pools at
        the folded rows ``ids``: one ``index_copy_`` per pool."""
        self.kp.index_copy_(0, ids, k)
        self.vp.index_copy_(0, ids, v)

    def _upload_pages(self, pids, k, v):
        """Install (L, len(pids), Hkv, page, D) host pages at ``pids``."""
        n = k.shape[0] * k.shape[1]
        dev, dt = self.device, self.kp.dtype
        self._install(self._page_rows(pids),
                      k.reshape(n, *k.shape[2:]).to(dev, dt),
                      v.reshape(n, *v.shape[2:]).to(dev, dt))

    def _table(self) -> torch.Tensor:
        """The (S, max_pages) int32 device page table at a fixed width
        (ceil(max_seq_len / page)); re-uploaded only when a reservation
        or release changed a table."""
        if self._table_dirty or self._table_dev is None:
            out = np.zeros((self.S, self._mx), np.int32)
            for s, t in enumerate(self._tables):
                out[s, :len(t)] = t
            self._table_dev = torch.from_numpy(out).to(self.device)
            self._table_dirty = False
        return self._table_dev

    def _fold(self, table: torch.Tensor) -> torch.Tensor:
        """(rows, max_pages) table -> (L, rows, max_pages) layer-folded
        tables, each layer's a contiguous slice."""
        return (self._layer_base[:, None, None] + table[None]).contiguous()

    # -- device bodies ------------------------------------------------------

    def _embed(self, tokens, positions):
        x = self._head["wte"][tokens.long()]
        if self._head["wpe"] is not None:
            # clamp like the JAX gather: idle slots may sit at max_seq_len
            pos = positions.long().clamp(max=self.cfg.max_seq_len - 1)
            x = x + self._head["wpe"][pos]
        return x

    def _one_token(self, tables, table, lengths, last, active, poison):
        """Advance every active slot one token: per layer one fused
        append+attend launch (K2) that also writes the fresh K/V row
        (inactive slots write the scratch page). Returns the new
        lengths, the next tokens and the per-slot non-finite flags
        (``poison``'s slots included)."""
        x = self._embed(last, lengths)[:, None, :]
        pidx = torch.clamp(lengths // self.page, max=self._mx - 1)
        base = table.gather(1, pidx[:, None].long())[:, 0]
        wpids = torch.where(active[None], self._layer_base[:, None]
                            + base[None], self._scratch
                            ).to(torch.int32).contiguous()
        dt = self.kp.dtype
        blk = self._block
        for i, w in enumerate(self._layers):
            q, k, v = blk._qkv(x, lengths, w)
            o, _, _ = paged_append_attend(
                q[:, 0].to(dt).contiguous(), self.kp, self.vp,
                k[:, 0].to(dt).contiguous(), v[:, 0].to(dt).contiguous(),
                tables[i], wpids[i], lengths, scale=self.scale)
            x = blk._block_tail(x, o.to(x.dtype).reshape(x.shape), w)
        logits = self._poison(self._lm_head(x)[:, 0], poison)
        bad = active & ~torch.isfinite(logits).all(dim=-1)
        ok = active & ~bad
        nxt = torch.argmax(logits.float(), dim=-1).to(torch.int32)
        nxt = torch.where(ok, nxt, last)
        return lengths + ok.to(torch.int32), nxt, bad

    def _mega_rows(self, table, pos, row_slot, row_write, tokens, poison):
        """One megakernel pass over a flat row batch (the counterpart of
        the JAX engine's ``_mega_rows``): embed ``tokens`` at ``pos``,
        run every layer in one K8 launch over the unfolded ``table``
        (pools in place), then one K9 launch on the LM projection, which
        flags ``poison``'s rows non-finite. Returns the greedy token and
        the non-finite flag per row."""
        cfg = self.cfg
        x = self._embed(tokens, pos)
        x = mega_decode_layers(
            x, self._stacked, self.kp, self.vp, table, pos, row_slot,
            row_write, page=self.page, n_pages=self.P,
            n_heads=cfg.n_heads, kv_heads=cfg.kv_heads,
            head_dim=cfg.head_dim, rope=cfg.rope,
            rope_theta=cfg.rope_theta, scale=self.scale)
        head = self._head
        return mega_logits_sample(x, head["lnf_scale"], head["lnf_bias"],
                                  head["proj"], poison,
                                  layers=cfg.n_layers, page=self.page)

    def _one_token_mega(self, tables, table, lengths, last, active, poison):
        """Single-dispatch ``_one_token``: the same signature and greedy
        stream in two kernel launches (K8 + K9) plus the embedding and
        the bookkeeping below; ``tables`` (the folded tables of the
        per-layer path) is unused."""
        tok, nf = self._mega_rows(table, lengths, self._rows,
                                  active.to(torch.int32), last, poison)
        bad = active & (nf > 0)
        ok = active & ~bad
        nxt = torch.where(ok, tok, last)
        return lengths + ok.to(torch.int32), nxt, bad

    def _multi(self, table, lengths, last, active, remaining, eos, poison):
        """``chunk`` decode steps in one dispatch, per-slot eos/budget/
        non-finite early stop on the device (pages for the whole chunk
        are reserved before the dispatch, so ``table`` is fixed;
        ``poison``, the dispatch's injection mask, applies to every
        step). Tokens, emit flags and non-finite flags come back packed
        as one (3, chunk, S) int32 tensor."""
        if self.mega:
            one_tok, tables = self._one_token_mega, None
        else:
            one_tok, tables = self._one_token, self._fold(table)
        toks, flags, bads = [], [], []
        for _ in range(self.chunk):
            lengths, nxt, bad = one_tok(tables, table, lengths, last,
                                        active, poison)
            emit = active & ~bad
            remaining = remaining - emit.to(torch.int32)
            hit_eos = (nxt == eos) & (eos >= 0)
            active = active & ~bad & ~hit_eos & (remaining > 0)
            last = nxt
            toks.append(nxt)
            flags.append(emit)
            bads.append(bad)
        packed = torch.stack([torch.stack(toks),
                              torch.stack(flags).to(torch.int32),
                              torch.stack(bads).to(torch.int32)])
        return lengths, last, active, remaining, packed

    @property
    def _verify_group_rows(self) -> int:
        """Flat rows a single-dispatch verify launch takes (K8's and K9's
        ``MAX_ROWS``, read at call time): the whole slots that fit, or
        ``MAX_ROWS`` of one slot's rows when K exceeds it."""
        K = self.spec_k
        return _mk.MAX_ROWS // K * K if K <= _mk.MAX_ROWS else _mk.MAX_ROWS

    def _mega_verify(self, table, pos, row_write, tokens, poison):
        """The flat verify rows through ``_mega_rows``, in order, in
        groups of ``_verify_group_rows`` (one K8 + K9 pair a group).
        Causal either way: inside a launch every row is written before
        any attends, and a later launch reads the rows of its slot that
        an earlier one wrote from the pool. Returns (tokens, non-finite
        flags) per row."""
        per = self._verify_group_rows
        parts = [self._mega_rows(table, pos[r:r + per],
                                 self._spec_rows[r:r + per],
                                 row_write[r:r + per], tokens[r:r + per],
                                 poison[r:r + per])
                 for r in range(0, pos.shape[0], per)]
        if len(parts) == 1:
            return parts[0]
        return (torch.cat([t for t, _ in parts]),
                torch.cat([f for _, f in parts]))

    def _verify_paged(self, tables, table, lengths, cand, active, poison):
        """One speculative verify over the pools: the K candidates of
        every slot (cand (S, K)) at positions lengths..lengths + K - 1.
        Single-dispatch: the S·K flat rows through ``_mega_verify``
        (``poison`` is then the per-row mask). Per layer (``tables``:
        the folded tables with each slot's row repeated K times): the
        rows' fresh K/V scattered into their pages (an inactive slot's
        into the scratch page), then one K2' launch over the S·K query
        rows with pos + 1 keys each. Returns the greedy predictions
        (S, K) int32 and the per-slot non-finite flag, as
        ``DecodeEngine._verify_impl``."""
        S, K = cand.shape
        cfg = self.cfg
        pos = (lengths[:, None]
               + torch.arange(K, dtype=torch.int32, device=self.device))
        if self.mega:
            tok, nf = self._mega_verify(
                table, pos.reshape(-1),
                active.to(torch.int32).repeat_interleave(K),
                cand.reshape(-1), poison)
            pred = tok.reshape(S, K)
            bad = (nf > 0).reshape(S, K).any(dim=1)
        else:
            x = self._embed(cand, pos)
            pidx = torch.clamp(pos // self.page, max=self._mx - 1)
            pages = table.gather(1, pidx.long())
            offs = (pos % self.page).reshape(-1).long()
            lens = torch.clamp(pos + 1, max=self._mx * self.page).to(
                torch.int32).reshape(-1)
            rows = torch.where(active[None, :, None],
                               self._layer_base[:, None, None]
                               + pages[None], self._scratch).long()
            dt = self.kp.dtype
            hkv, hq, D = cfg.kv_heads, cfg.n_heads, cfg.head_dim
            blk = self._block
            for i, w in enumerate(self._layers):
                q, k, v = blk._qkv(x, lengths, w)
                r = rows[i].reshape(-1)
                self.kp[r, :, offs, :] = k.reshape(S * K, hkv, D).to(dt)
                self.vp[r, :, offs, :] = v.reshape(S * K, hkv, D).to(dt)
                o = paged_decode_attention(
                    q.reshape(S * K, hq, D).to(dt).contiguous(), self.kp,
                    self.vp, tables[i], lens, scale=self.scale)
                x = blk._block_tail(x, o.to(x.dtype).reshape(x.shape), w)
            logits = self._poison(self._lm_head(x).float(), poison)
            bad = ~torch.isfinite(logits).all(dim=2).all(dim=1)
            pred = torch.argmax(logits, dim=-1).to(torch.int32)
        return pred, bad

    def _spec_multi(self, table, toks, lengths, last, active, remaining, eos,
                    poison):
        """``chunk`` speculative steps in one dispatch over the pools
        (``_spec_chunk`` over ``_verify_paged``; pages for chunk·K rows
        a slot are reserved before it, so ``table`` is fixed)."""
        K = self.spec_k
        if self.mega:
            # the per-row poison mask, once a dispatch
            tables, poison = None, poison.repeat_interleave(K)
        else:
            tables = self._fold(table.repeat_interleave(K, dim=0))
        return self._spec_chunk(
            lambda n, cand, act: self._verify_paged(tables, table, n, cand,
                                                    act, poison),
            toks, lengths, last, active, remaining, eos)

    def _prefill(self, tokens, n, tab):
        """One-pass prefill of ONE prompt padded to its bucket
        (tokens (1, bucket)): causal self-attention only (K1 on CUDA),
        then the n valid K/V rows of every layer go into the pages.
        Returns the greedy next token as a device scalar."""
        x = self._embed(tokens, torch.arange(tokens.shape[1],
                                             device=self.device))
        zero = torch.zeros((1,), dtype=torch.int32, device=self.device)
        blk = self._block
        for i, w in enumerate(self._layers):
            q, k, v = blk._qkv(x, zero, w)
            attn = scaled_dot_product_attention(q, k, v, is_causal=True,
                                                dropout_p=0.0)
            x = blk._block_tail(x, attn.reshape(x.shape).to(x.dtype), w)
            self._write_rows(i, k[0, :n], v[0, :n], tab, 0, n)
        logits = self._lm_head(x[:, n - 1:n])[:, 0]
        return torch.argmax(logits.float(), dim=-1).to(torch.int32)[0]

    def _prefill_suffix(self, tokens, sp, n, cow_src, cow_dst, tab):
        """Suffix-only prefill over a CACHED prefix: the first ``sp``
        tokens' KV already sit in pages mapped into ``tab``. Per layer,
        the suffix rows [sp, n) are written into the slot's pages FIRST,
        then the paged kernel (K2') runs with one query row per suffix
        position — row t attends over min(sp + t + 1, n) tokens, its own
        row included. ``cow_src``/``cow_dst`` (-1 = none): copy-on-write
        of the last matched page for an exact page-multiple full match.
        tokens: (1, bucket) suffix, zero-padded."""
        dev = self.device
        bucket = tokens.shape[1]
        if cow_src >= 0:
            src = self._layer_base.long() + cow_src
            dst = self._layer_base.long() + cow_dst
            self.kp[dst] = self.kp[src]
            self.vp[dst] = self.vp[src]
        ar = torch.arange(bucket, device=dev)
        x = self._embed(tokens, sp + ar)
        lens_t = torch.clamp(sp + 1 + ar, max=n).to(torch.int32)
        row = np.zeros((self._mx,), np.int32)
        row[:len(tab)] = tab
        row_t = torch.from_numpy(row).to(dev)
        tables = self._fold(row_t[None].expand(bucket, -1))
        sp_t = torch.full((1,), sp, dtype=torch.int32, device=dev)
        dt = self.kp.dtype
        blk = self._block
        for i, w in enumerate(self._layers):
            q, k, v = blk._qkv(x, sp_t, w)
            self._write_rows(i, k[0, :n - sp], v[0, :n - sp], tab, sp, n)
            o = paged_decode_attention(q[0].to(dt).contiguous(), self.kp,
                                       self.vp, tables[i], lens_t,
                                       scale=self.scale)
            x = blk._block_tail(x, o.to(x.dtype).reshape(x.shape), w)
        logits = self._lm_head(x[:, n - sp - 1:n - sp])[:, 0]
        return torch.argmax(logits.float(), dim=-1).to(torch.int32)[0]

    def _write_rows(self, layer, k, v, tab, start, stop):
        """Write positions [start, stop) of one layer (k, v:
        (stop - start, Hkv, D)) into the slot's pages: position t lands
        in page tab[t // page] at row t % page."""
        t = np.arange(start, stop)
        rows = torch.from_numpy(layer * self.P + np.asarray(
            tab, np.int64)[t // self.page]).to(self.device)
        offs = torch.from_numpy(t % self.page).to(self.device)
        self.kp[rows, :, offs, :] = k.to(self.kp.dtype)
        self.vp[rows, :, offs, :] = v.to(self.vp.dtype)

    # -- scheduler ----------------------------------------------------------

    def check_request(self, prompt_len: int, max_new_tokens: int):
        if prompt_len < 1:
            raise ValueError("empty prompt")
        if prompt_len > self.buckets[-1]:
            raise ValueError(
                f"paged prefill caps prompts at {self.buckets[-1]} "
                f"tokens (got {prompt_len})")
        if prompt_len + max_new_tokens > self.cfg.max_seq_len:
            raise ValueError("prompt + new tokens exceed max_seq_len")
        if self.spec_k and (prompt_len + max_new_tokens
                            + self.spec_k - 1 > self.cfg.max_seq_len):
            # the last accepted token's verify writes K - 1 rows past it:
            # those positions must exist in the fixed-width table
            raise ValueError(
                f"prompt + new tokens + speculative window "
                f"({prompt_len}+{max_new_tokens}+{self.spec_k - 1}) "
                f"exceed max_seq_len {self.cfg.max_seq_len}")

    def submit(self, prompt, max_new_tokens: int = 32,
               eos_id: Optional[int] = None,
               deadline_s: Optional[float] = None,
               req_id: Optional[str] = None) -> Request:
        """See ``DecodeEngine.submit``."""
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        self.check_request(len(prompt), max_new_tokens)
        req = Request(prompt, max_new_tokens, eos_id,
                      deadline=(None if deadline_s is None
                                else time.monotonic() + deadline_s),
                      rid=req_id)
        self._waiting.append(req)
        return req

    def _free_slot(self) -> Optional[int]:
        for s, r in enumerate(self._slot_req):
            if r is None:
                return s
        return None

    def _on_evict(self, slot: int):
        """Eviction also returns the slot's pages to the pool."""
        self._release(slot)
        super()._on_evict(slot)

    def _fail(self, req, reason, slot=None,
              stat="serve/deadline_evictions"):
        if slot is not None and stat == "serve/nonfinite_evictions":
            # suspect KV: taint the slot so _release scrubs its private
            # pages, and drop every trie node its table maps so no later
            # submit of the same prompt maps the bad pages
            self._tainted.add(slot)
            if self._prefix is not None:
                for p in self._tables[slot]:
                    self._prefix.invalidate(p)
        super()._fail(req, reason, slot, stat)

    def _match_prefix(self, prompt, slot):
        """Longest-cached-prefix lookup at admission: maps the matched
        pages into the slot's (empty) table read-only and returns
        ``(sp, cow_src, chain)`` — the suffix start, the copy-on-write
        source page (-1 = none) and the prompt's digest chain. An exact
        page-multiple full match keeps all but the last page: the last
        token must re-run for first-token logits and its KV row lands
        inside that page, so it is copied to a private one. With a fleet
        directory attached, a local miss extends through the fleet."""
        chain = self._prefix.chain(prompt)
        matched = self._prefix.lookup(prompt, chain=chain)
        if self.fleet is not None and len(matched) < len(chain):
            matched.extend(self._fleet_extend(chain, len(matched)))
        n = len(prompt)
        sp, cow_src = 0, -1
        if matched and len(matched) * self.page >= n:
            cow_src = matched[-1]
            self._prefix.unref(matched[-1])
            matched = matched[:-1]
            sp = n - 1
        elif matched:
            sp = len(matched) * self.page
        self._tables[slot][:] = matched
        if matched:
            self._table_dirty = True
        return sp, cow_src, chain

    # -- fleet prefix directory ---------------------------------------------

    def attach_fleet(self, fleet):
        """Wire a ``serving/disagg.FleetPrefixDirectory`` into this
        engine: admission lookups extend through the fleet on a local
        miss, newly registered prefixes publish, and local invalidation
        or reclaim withdraws fleet-wide (the prefix cache's ``on_drop``
        hook — before the freed page can be remapped)."""
        if self._prefix is None:
            raise ValueError("fleet prefix directory needs the local "
                             "prefix cache (prefix=True)")
        self.fleet = fleet

        def _drop(digest, pid):
            fleet.withdraw(digest)
            self._lossy_pids.discard(pid)

        self._prefix.on_drop = _drop

    def _alloc_one_page(self) -> int:
        """One free page for a fleet-fetched prefix, reclaiming LRU
        refcount-zero cache pages under pressure (``_reserve``'s policy);
        MemoryError when the pool is truly full."""
        tmp: List[int] = []
        try:
            self._alloc.reserve(tmp, self.page)
        except MemoryError:
            if self._prefix.reclaim(1) == 0:
                raise
            self._alloc.reserve(tmp, self.page)
        return tmp[0]

    def _fleet_extend(self, chain, start) -> List[int]:
        """Continue a local prefix match through the fleet directory:
        fetch each next digest's page over the KV wire into a private
        page, adopt it into the local cache (ref'd for this admission),
        stop at the first fleet miss or a full pool. One
        ``serve/fleet_prefix_lookup`` per consulted admission,
        ``serve/fleet_prefix_hit_tokens`` per page of prefill skipped."""
        got: List[int] = []
        uploads = []                      # (pid, k_page, v_page)
        stats.add("serve/fleet_prefix_lookup")
        for digest in chain[start:]:
            # a stale DESCENDANT may still be canonical locally (its
            # parent was reclaimed): revive it instead of refetching
            pid = self._prefix.revive(digest)
            if pid is not None:
                got.append(pid)
                continue
            try:
                res = self.fleet.fetch(digest)
            except RuntimeError:
                # the wire guard tripped on this fleet page: expunge the
                # entry so the fleet heals, and prefill this prefix cold
                self.fleet.withdraw(digest, force=True)
                res = None
            except TimeoutError:
                res = None                # store hiccup: a miss
            if res is None:
                break
            try:
                pid = self._alloc_one_page()
            except MemoryError:
                break                     # a partial fleet hit is fine
            self._prefix.adopt(digest, pid)
            if self.fleet.wire != "fp32":
                self._lossy_pids.add(pid)
            got.append(pid)
            uploads.append((pid, *res))
            stats.add("serve/fleet_prefix_hit_tokens", self.page)
        if uploads:
            # one install per pool for the whole fetched run
            self._upload_pages([u[0] for u in uploads],
                               torch.cat([u[1] for u in uploads], dim=1),
                               torch.cat([u[2] for u in uploads], dim=1))
        return got

    def _publish_pages(self, pids) -> int:
        """Publish each of ``pids`` (with its digest) that arrived over no
        lossy wire; returns how many were published."""
        n = 0
        for digest, pid in pids:
            if pid in self._lossy_pids:
                continue
            k, v = self._read_pages([pid])
            self.fleet.publish(digest, k, v)
            n += 1
        return n

    def _fleet_publish(self):
        """Publish the pages the LAST ``register`` made canonical to the
        fleet directory (content-addressed: racing replicas converge)."""
        self._publish_pages([(d, p) for _, d, p in
                             self._prefix.last_registered])

    def fleet_republish(self) -> int:
        """Re-publish every live prefix page to the fleet directory (a
        new store generation starts empty; the caller clears the
        directory's published set first, ``fleet.reset_published()``).
        Lossy-wire pages stay excluded. Returns the pages re-published."""
        if self.fleet is None:
            return 0
        return self._publish_pages(list(self._prefix._nodes.items()))

    def _admit(self, req: Request, slot: int):
        """Reserve pages, run the one-pass (or suffix-only) prefill, and
        flip the slot live WITHOUT waiting for the sampled first token:
        it stays on the device and rides the harvest queue as a
        'prefill' record."""
        prompt = np.asarray(req.prompt, np.int32)
        n = len(prompt)
        sp, cow_src, chain = (self._match_prefix(prompt, slot)
                              if self._prefix is not None
                              else (0, -1, None))
        self._reserve(slot, n)
        tab = self._tables[slot]
        if self._prefix is not None:
            if n >= self.page:
                # register the prompt's full pages now; the prefill
                # below fills them (stream order: before any later read)
                self._prefix.register(prompt, tab, chain=chain)
                self._update_pool_gauges()
            # counters only once the reservation held (a MemoryError
            # retry re-runs this whole admission)
            stats.add("serve/prefix_lookup")
            if sp:
                stats.add("serve/prefix_hit_tokens", sp)
        bucket = next(b for b in self.buckets if b >= n - sp)
        # spans and flight events only once the reservation held (a
        # MemoryError retry re-runs this whole admission)
        trace.complete("serve/queue", req.t_submit, rid=req.rid,
                       slot=slot)
        stats.add("serve/dispatch_launches")
        stats.add("serve/dispatches/prefill")
        flight.record(req.rid, "admit", slot=slot, prompt=n,
                      bucket=bucket, cached=sp)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :n - sp] = prompt[sp:]
        tokens = torch.from_numpy(padded).to(self.device)
        with trace.span("serve/admit", slot=slot, prompt=n, bucket=bucket,
                        cached=sp, rid=req.rid):
            if sp:
                stats.add("serve/dispatches/prefill_suffix")
                cow_dst = tab[(n - 1) // self.page] if cow_src >= 0 else -1
                nxt = self._prefill_suffix(tokens, sp, n, cow_src, cow_dst,
                                           tab)
            else:
                nxt = self._prefill(tokens, n, tab)
        if self.fleet is not None and self._prefix is not None \
                and n >= self.page:
            # the prefill that fills the registered pages is enqueued;
            # publication reads them back (stream order), newly
            # canonical ones only
            self._fleet_publish()
        rem0 = req.max_new_tokens - 1
        eos0 = -1 if req.eos_id is None else int(req.eos_id)
        # a budget-of-one request (or one whose first token is eos)
        # never activates
        alive = (nxt != eos0) & (rem0 > 0)
        if self.toks is not None:
            # the drafts' history: the prompt, then the pending token
            self.toks[slot, :n] = torch.from_numpy(prompt).to(self.device)
            self.toks[slot, n] = nxt
        self.lengths[slot] = n
        self.last[slot] = nxt
        # a prefill replica never decodes: the slot stays bound (its
        # pages leave via detach_handoff) but device-inactive
        self.active[slot] = False if self.prefill_only else alive
        self.remaining[slot] = rem0
        self.eos_ids[slot] = eos0
        self._slot_req[slot] = req
        self._host_len[slot] = n
        self._proj_len[slot] = n
        self._disp_rem[slot] = 0 if self.prefill_only else rem0
        self._pending.append(_Inflight("prefill", [(slot, req)], nxt))

    def _emit(self, slot: int, req: Request, token: int):
        """Every harvested token lands here (the first, decode and
        speculative emits alike), so ``on_token`` sees each request's
        stream in order."""
        req.tokens.append(token)
        self._obs_first_token(req)
        if self.on_token is not None:
            self.on_token(req, token)
        if ((req.eos_id is not None and token == req.eos_id)
                or len(req.tokens) >= req.max_new_tokens):
            req.done = True
            self._slot_req[slot] = None
            self._release(slot)
            self.active[slot] = False
            self._obs_request_end(req)

    # -- KV handoff and migration -------------------------------------------

    def detach_handoff(self, req: Request):
        """Extract a request's KV pages and decode state and retire it
        here WITHOUT finishing it — the sending half of both handoff
        shapes. On a ``prefill_only`` engine the pages hold the prompt's
        KV (prefill -> transfer -> decode); on a decode engine the
        request may be MID-DECODE (a drain migration): the pipeline
        drains first, so rows ``[0, n)`` hold prompt + generated[:-1] and
        ``meta["tokens"]`` every token generated so far — the receiver
        re-emits the last one and continues. Call once ``req.tokens`` is
        non-empty.

        Returns ``(meta, k, v)``: ``meta`` is what ``submit_handoff``
        needs (prompt, tokens so far, valid row count, budget, eos, rid),
        ``k``/``v`` the slot's pages as (L, npages, Hkv, page, D) CPU
        tensors (rows past ``n_tokens`` are recycled-pool garbage: the
        wire codec zeroes them)."""
        if req.failed:
            raise ValueError(f"request failed before detach: {req.error}")
        if not req.tokens:
            raise ValueError("prefill not harvested yet — pump step() "
                             "until req.tokens holds the first token")
        self._drain()
        if req.done:
            raise ValueError("request completed during drain — publish "
                             "its result directly")
        try:
            slot = self._slot_req.index(req)
        except ValueError:
            raise ValueError("request no longer holds a slot (budget-1 "
                             "requests retire at harvest — publish their "
                             "result directly)") from None
        n = int(self._host_len[slot])
        npg = (n + self.page - 1) // self.page
        k, v = self._read_pages(self._tables[slot][:npg])
        meta = handoff_meta(req, n)
        flight.record(req.rid, "handoff-detach", n_tokens=n, pages=npg)
        # retire: registered prefix pages go warm, private ones free
        self._slot_req[slot] = None
        self._release(slot)
        # a mid-decode detach leaves a device-live slot: deactivate it
        self.active[slot] = False
        self._disp_rem[slot] = 0
        req.done = True
        self._obs_request_end(req)
        return meta, k, v

    def submit_handoff(self, meta: dict, k, v,
                       deadline_s: Optional[float] = None) -> Request:
        """Receiving half of the handoff: queue a request whose KV state
        was built elsewhere — right after prefill or mid-decode. ``k``/
        ``v``: (L, npages, Hkv, page, D) host pages (torch or numpy) of
        any page size holding ``n_tokens`` rows (another page size, or a
        contiguous engine's single page of n rows, is repacked into this
        pool's). Admission installs them and rebuilds the sender's device
        state; the last sender-emitted token rides the harvest queue like
        a local prefill's first token. A geometry mismatch raises
        ValueError here."""
        req = handoff_request(meta, k, v, deadline_s)
        # not check_request: its bucket cap is a PREFILL constraint, and
        # a handoff never prefills here
        if len(req.prompt) + req.max_new_tokens > self.cfg.max_seq_len:
            raise ValueError("prompt + new tokens exceed max_seq_len")
        cfg, n = self.cfg, req.kv_ntok
        want_npg = (n + self.page - 1) // self.page
        want = (cfg.n_layers, want_npg, cfg.kv_heads, self.page,
                cfg.head_dim)
        pages = []
        for name, arr in zip("kv", req.kv_pages):
            rows = handoff_rows(cfg, arr, n, name, want)
            if arr.shape[1] == want_npg and arr.shape[3] == self.page:
                pages.append(arr)
                continue
            # another blocking: the same rows, repacked into this pool's
            # page size
            pad = torch.zeros((cfg.n_layers, cfg.kv_heads,
                               want_npg * self.page, cfg.head_dim),
                              dtype=arr.dtype)
            pad[:, :, :n] = rows
            pages.append(pad.reshape(cfg.n_layers, cfg.kv_heads, want_npg,
                                     self.page, cfg.head_dim).transpose(
                                         1, 2).contiguous())
        req.kv_pages = tuple(pages)
        self._waiting.append(req)
        return req

    def _admit_handoff(self, req: _HandoffRequest, slot: int):
        """Install transferred pages instead of prefilling: reserve,
        upload the rows (one ``index_copy_`` per pool), register the
        prompt's full pages locally (and publish them to the fleet, like
        any registration) for post-prefill handoffs only, then rebuild
        the device state the sender held."""
        n = req.kv_ntok
        flight.record(req.rid, "handoff-install", n_tokens=n, slot=slot,
                      wire=req.kv_wire, generated=len(req.kv_tokens))
        self._reserve(slot, n)
        tab = self._tables[slot]
        k, v = req.kv_pages
        npg = k.shape[1]
        self._upload_pages(tab[:npg], k, v)
        req.kv_pages = None            # free the host copy
        if req.kv_wire != "fp32":
            self._lossy_pids.update(tab[:npg])
        if self._prefix is not None and n >= self.page \
                and n == len(req.prompt):
            # a migrated mid-decode slot's tail pages hold GENERATED
            # rows, which must never become prompt-prefix canon
            self._prefix.register(np.asarray(req.prompt, np.int32), tab)
            self._update_pool_gauges()
            if self.fleet is not None:
                self._fleet_publish()
        # tokens[:-1] are final (their KV sits in the installed rows);
        # tokens[-1] is pending, its KV the next dispatch's write
        req.tokens = list(req.kv_tokens[:-1])
        nxt = req.kv_tokens[-1]
        rem0 = req.max_new_tokens - len(req.kv_tokens)
        eos0 = -1 if req.eos_id is None else int(req.eos_id)
        alive = rem0 > 0 and (eos0 < 0 or nxt != eos0)
        if self.toks is not None:
            # the drafts' history: prompt + generated[:-1] in rows
            # [0, n), the pending token at n
            hist = torch.zeros((self.cfg.max_seq_len,), dtype=torch.int32)
            hist[:n + 1] = torch.tensor(req.prompt + req.kv_tokens,
                                        dtype=torch.int32)
            self.toks[slot] = hist.to(self.device)
        self.lengths[slot] = n
        self.last[slot] = nxt
        self.active[slot] = bool(alive)
        self.remaining[slot] = rem0
        self.eos_ids[slot] = eos0
        self._slot_req[slot] = req
        self._host_len[slot] = n
        self._proj_len[slot] = n
        self._disp_rem[slot] = rem0
        self._pending.append(_Inflight(
            "prefill", [(slot, req)], torch.tensor(nxt, dtype=torch.int32)))

    def step(self) -> int:
        t0 = time.perf_counter()
        base = self.tokens_emitted
        with trace.span("serve/step") as sp:
            self._evict_expired()
            self._admit_waiting()
            self._pump(self._dispatch_decode())
            n_live = sum(r is not None for r in self._slot_req)
            n = self.tokens_emitted - base
            sp.attrs["active"] = n_live
            sp.attrs["tokens"] = n
        if n_live or n:
            self._obs_step(t0, n, n_live)
        return n

    def _admit_waiting(self):
        drained = False
        while self._waiting:
            slot = self._free_slot()
            if slot is None:
                return
            req = self._waiting.popleft()
            try:
                if isinstance(req, _HandoffRequest):
                    self._admit_handoff(req, slot)
                else:
                    self._admit(req, slot)
            except MemoryError:
                # not enough pages now: return the partial reservation
                # and requeue; retired pages may sit in unharvested
                # dispatches — drain once and retry
                self._release(slot)
                self._waiting.appendleft(req)
                if self._pending and not drained:
                    self._drain()
                    drained = True
                    continue
                if not any(r is not None for r in self._slot_req):
                    raise MemoryError(
                        f"page pool ({self.P} pages of {self.page}) too "
                        f"small for even one request of "
                        f"{len(req.prompt)} tokens")
                return

    @property
    def _disp_span(self) -> int:
        """The most a dispatch grows a slot: ``chunk`` tokens, or
        chunk·K rows speculative (every verify writes K rows at
        lengths..lengths + K - 1, however many it accepts)."""
        return self.chunk * max(1, self.spec_k)

    def _reserve_chunk(self, live):
        """Reserve pages for one chunk per live slot against the
        PROJECTED length, capped at the request's prompt + budget; a
        speculative cap is K - 1 rows longer, for the rows the last
        verify writes past the last token (``check_request`` keeps them
        inside the table)."""
        for slot, req in live:
            cap = len(req.prompt) + req.max_new_tokens
            if self.spec_k:
                cap += self.spec_k - 1
            need = min(int(self._proj_len[slot]) + self._disp_span + 1,
                       cap)
            self._reserve(slot, need)

    def _dispatch_decode(self) -> bool:
        def _live():
            return [(s, r) for s, r in enumerate(self._slot_req)
                    if r is not None and self._disp_rem[s] > 0]

        live = _live()
        if not live:
            return False
        try:
            self._reserve_chunk(live)
        except MemoryError:
            # retired pages may sit in unharvested dispatches: drain,
            # re-anchor the shadows, retry once
            if not self._pending:
                raise
            self._drain()
            live = _live()
            if not live:
                return False
            self._reserve_chunk(live)
        self.steps += 1
        self._obs_host_gap()
        fn, args = self.dispatch_fn_args()
        with self._dispatch_span("paged_spec" if self.spec_k else "paged"):
            (self.lengths, self.last, self.active, self.remaining,
             packed) = fn(*args)
        for s, _ in live:
            self._proj_len[s] += self._disp_span
        self._finish_dispatch("spec" if self.spec_k else "decode", live,
                              packed)
        return True

    def _resync_budgets(self, live, cover=None):
        if cover is None:
            cover = self._pending_cover()
        if self.prefill_only:
            return          # its slots never decode: budgets stay 0
        super()._resync_budgets(live, cover)
        for slot, req in live:
            if req.done or self._slot_req[slot] is not req:
                continue
            self._proj_len[slot] = (self._host_len[slot]
                                    + self._disp_span * cover.get(slot, 0))

    def _apply_token(self, slot, req, token):
        """Harvested token: emit (which retires the request and releases
        its pages at budget/eos) and advance the exact host length."""
        self._emit(slot, req, token)
        self._host_len[slot] += 1

    def run(self) -> None:
        while self._waiting or any(r is not None for r in self._slot_req):
            self.step()
        self._drain()

    # -- warmup and device-time attribution ---------------------------------

    _STATE = ("kp", "vp", "lengths", "last", "active", "remaining",
              "eos_ids", "toks")

    def warmup(self):
        """Run one prefill per bucket (and, with the prefix cache on, one
        suffix prefill per bucket, the warm-hit admission path) and one
        decode dispatch (the speculative program on a speculative
        engine) on throwaway zero pools and state, so the first
        request loads no kernel library and takes no first-launch cost
        of its own. The engine's pools, tables and per-slot state are as
        they were; the pools exist twice while it runs. Records
        ``serve/warmup_s``."""
        t0 = time.perf_counter()
        saved = {n: getattr(self, n) for n in self._STATE}
        try:
            for n, t in saved.items():
                setattr(self, n, None if t is None else torch.zeros_like(t))
            for b in self.buckets:
                tokens = torch.zeros((1, b), dtype=torch.int64,
                                     device=self.device)
                self._prefill(tokens, 1, [0])
                if self._prefix is not None:
                    self._prefill_suffix(tokens, 0, 1, -1, -1, [0])
            fn, args = self.dispatch_fn_args()
            fn(*args)[-1].cpu()
        finally:
            for n, t in saved.items():
                setattr(self, n, t)
        stats.observe("serve/warmup_s", time.perf_counter() - t0)

    def dispatch_cost(self, name=None):
        """Flops and HBM bytes of ONE decode dispatch at the current
        geometry, as a ``devprof.CostCapture`` (``name`` defaults to
        ``"paged"``, ``"paged_spec"`` for the speculative program); see
        ``DecodeEngine.dispatch_cost`` for what is counted and how it
        differs from the JAX engine's. Per step over all S slots at their
        advancing lengths: single-dispatch, K8's cost
        (``mega_decode_layers_cost``) and K9's
        (``mega_logits_sample_cost``); per layer, each layer's four
        block products and K2's cost (``paged_append_attend_cost``,
        which counts the fresh rows' writes), then the LM-head product.
        A verify counts S·K rows, row j of a slot at position length + j
        (each slot advanced one a verify, the least a verify emits):
        single-dispatch, K8's and K9's costs once per launch group (the
        weights are read by each); per layer, the four products, K2'
        (``paged_decode_attention_cost``) and the fresh K and V rows
        written, then the LM-head product."""
        cfg = self.cfg
        S, hq, hkv, D = self.S, cfg.n_heads, cfg.kv_heads, cfg.head_dim
        elt = torch.empty((), dtype=cfg.dtype).element_size()
        pelt = self.kp.element_size()
        lengths, active = self.lengths.tolist(), self.active.tolist()
        K = max(1, self.spec_k)
        cap = self._mx * self.page
        flops = nbytes = 0
        for j in range(self.chunk):
            pos = [n + j * bool(a) for n, a in zip(lengths, active)]
            if self.spec_k:
                lens = [min(p + i + 1, cap) for p in pos for i in range(K)]
                if self.mega:
                    per = self._verify_group_rows
                    parts = [c for r in range(0, len(lens), per) for c in (
                        mega_decode_layers_cost(lens[r:r + per],
                                                self._stacked, hq, hkv, D,
                                                pelt),
                        mega_logits_sample_cost(len(lens[r:r + per]),
                                                cfg.d_model,
                                                cfg.vocab_size, elt))]
                else:
                    fa, ba = paged_decode_attention_cost(lens, hq, hkv, D,
                                                         pelt)
                    parts = [c for w in self._layers for c in (
                        block_matmul_cost(w, S * K, elt),
                        (fa, ba + 2 * S * K * hkv * D * pelt))]
                    parts.append(devprof.matmul_cost(
                        S * K, cfg.d_model, cfg.vocab_size, elt))
            elif self.mega:
                parts = [mega_decode_layers_cost(
                    [min(p + 1, self._mx * self.page) for p in pos],
                    self._stacked, hq, hkv, D, pelt),
                    mega_logits_sample_cost(S, cfg.d_model, cfg.vocab_size,
                                            elt)]
            else:
                parts = [c for w in self._layers for c in (
                    block_matmul_cost(w, S, elt),
                    paged_append_attend_cost(pos, hq, hkv, D, pelt))]
                parts.append(devprof.matmul_cost(S, cfg.d_model,
                                                 cfg.vocab_size, elt))
            flops += sum(f for f, _ in parts)
            nbytes += sum(b for _, b in parts)
        weights = self._weight_tensors(self._stacked if self.mega
                                       else self._layers)
        state = [t for t in (getattr(self, n) for n in self._STATE)
                 if t is not None]
        return self._capture(
            name or ("paged_spec" if self.spec_k else "paged"), flops,
            nbytes, weights, state)

    def dispatch_fn_args(self):
        """The decode dispatch (a bound method: the speculative program
        on a speculative engine) and its argument tuple at the current
        state; see ``DecodeEngine.dispatch_fn_args`` (calling it RUNS a
        dispatch)."""
        if self.spec_k:
            return (self._spec_multi,
                    (self._table(), self.toks, self.lengths, self.last,
                     self.active, self.remaining, self.eos_ids,
                     self._poison_mask()))
        return (self._multi,
                (self._table(), self.lengths, self.last, self.active,
                 self.remaining, self.eos_ids, self._poison_mask()))
