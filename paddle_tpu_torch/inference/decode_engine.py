"""Continuous-batching decode over slot-contiguous KV caches, and the
serving engines' shared parts (counterpart of
``paddle_tpu/inference/decode_engine.py``).

Shared with the paged engine: ``Request``, the in-flight dispatch
record, ``resolve_engine_weights`` and the ``ResilientScheduler`` core
— the lag-one dispatch/harvest pipeline, retirement on eos or budget,
deadline eviction and non-finite eviction. The pipeline maps onto
CUDA's stream order: a dispatch enqueues its kernels and returns at
once; a harvest copies the OLDEST dispatch's packed int32 record to the
host (the one device->host transfer per dispatch), which waits for that
dispatch only, while younger ones keep the card busy.

``DecodeEngine``, as in the JAX engine:

- **Slot-contiguous caches**: one (L, S, Hkv, T, D) K and V cache for S
  slots; admission assigns a request a free slot, retirement frees it.
- **Ragged decode**: every active slot advances one token per step at
  its own cache position. Each layer's ``GPTBlock.decode_step`` writes
  the slot's new row and attends over it and the prefix (at T >= 1024
  in one K10 launch, which writes the row itself); an inactive slot
  keeps the row it has.
- **Bucketed chunked prefill**, interleaved with decode dispatches
  under a per-step prompt-token budget (``prefill_tokens``, default the
  largest bucket); a tail chunk that would overrun the cache slides
  back over written positions.
- **Chunked device-side stepping** (``steps_per_call``) with per-slot
  eos/budget/non-finite early stop on the device, one packed
  (3, chunk, S) int32 record per dispatch.
- **Speculative decoding** (``speculative_k`` = K >= 2, greedy only):
  each chunk step drafts K - 1 tokens per slot by prompt lookup
  (``prompt_lookup_draft``: the trailing bigram's latest earlier
  continuation in the slot's own history ``toks``, on the device),
  verifies the pending token and the drafts in one pass of K rows a
  slot (``GPTBlock.verify_step``: the grouped einsum over the cache,
  the rows written at their positions; on an int8 engine each block
  product is one K12 launch at M = S·K) and keeps the longest run that
  matches the greedy predictions (``spec_accept``), so the stream is the
  verify pass's own greedy stream whatever the acceptance. A chunk of
  these steps is one dispatch and one packed (chunk, S, K + 2) int32
  record: K predictions, the count emitted, the non-finite flag.
- **Weight-only int8** (``weight_dtype="int8"``): the four block matmul
  weights become per-(layer, output column) int8 ``QuantTensor``s, and
  every block matmul runs K12.
- **Sampling**: temperature / top-k / top-p from a ``torch.Generator``
  seeded with ``seed``.

Instrumentation, as in the JAX engines (both engines share it):

- **Trace context**: ``submit(..., req_id=...)`` sets ``Request.rid``,
  which every request-scoped span and flight event carries.
- **Trace spans** (``observability.trace``; one flag check each when
  tracing is off): ``serve/step``, ``serve/dispatch`` (``kind``
  ``"chunk"`` here, ``"paged"`` in the paged engine), ``serve/harvest``,
  ``serve/prefill``, ``serve/queue``, ``serve/admit``,
  ``serve/request`` and ``serve/decode``, with the JAX attributes.
- **Flight records** (``observability.flight``): ``admit``,
  ``prefill-chunk``, and on a terminal failure ``evicted`` followed by
  a dump.
- **Fault injection** (``_poison_mask``, site ``engine.poison_logits``
  of ``testing.faults``): the named slots' logits turn NaN for one
  dispatch, and the non-finite guard evicts their requests.
- ``warmup()`` (or ``warmup=True``), ``dispatch_cost()`` and
  ``dispatch_fn_args()``: see their docstrings for where they differ
  from the JAX engine's (nothing compiles in eager PyTorch; the cost is
  counted, not read from a compiler). The JAX engine's retrace counters
  (``compile/retrace/*``) have no counterpart: nothing is traced.

Service hooks for the front end (``paddle_tpu_torch/serving``):
``on_token``, ``on_retire``, ``bucket_policy``, ``free_slots`` and
``queued`` (``ResilientScheduler``'s docstring).

KV handoff (``detach_handoff`` / ``submit_handoff``, ``kv_bytes``): a
request's rows leave mid-decode as ONE wire page of n rows (a drain
migration) and arrive from any sender whose (n_layers, kv_heads,
head_dim) match, paged or contiguous; ``serving/kv_transfer.py`` is the
wire.

Not ported, raising ``NotImplementedError``: tensor-parallel serving
(``mesh``).
"""

import collections
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch import device as device_lib
from paddle_tpu_torch import dtypes, stats
from paddle_tpu_torch.models.gpt import (GPTBlock, _sample_token, cache_rows,
                                         final_ln)
from paddle_tpu_torch.observability import devprof, flight, trace
from paddle_tpu_torch.ops.decode_attention import decode_attention_cost
from paddle_tpu_torch.ops.quant_matmul import int8_matmul_cost
from paddle_tpu_torch.quantization import (_BLOCK_MATMULS, QuantTensor,
                                           quantize_tensor)
from paddle_tpu_torch.testing import faults

__all__ = ["DecodeEngine", "Request", "ResilientScheduler",
           "resolve_engine_weights", "block_matmul_cost",
           "decode_roofline_tokens_per_sec", "prompt_lookup_draft",
           "spec_accept", "append_history"]


def _nbytes(t) -> int:
    """Device bytes of a tensor or an int8 ``QuantTensor`` (0 for
    None)."""
    if t is None:
        return 0
    if isinstance(t, QuantTensor):
        return _nbytes(t.q) + _nbytes(t.scale)
    return t.numel() * t.element_size()


def block_matmul_cost(w, rows: int, elt: int):
    """(flops, HBM bytes) of one layer's four block products over
    ``rows`` rows: K12's cost for an int8 ``QuantTensor`` weight, a
    dense product's (``devprof.matmul_cost``) otherwise."""
    flops = nbytes = 0
    for n in _BLOCK_MATMULS:
        k, m = w[n].shape
        f, b = (int8_matmul_cost(rows, k, m, elt)
                if isinstance(w[n], QuantTensor)
                else devprof.matmul_cost(rows, k, m, elt))
        flops += f
        nbytes += b
    return flops, nbytes


def prompt_lookup_draft(toks, lengths, last, K: int):
    """On-device prompt-lookup drafts, shared by both engines'
    speculative paths: the continuation of the latest earlier
    occurrence of the trailing bigram in each slot's own history.
    ``toks[s, i]`` is token i for i <= lengths[s] (the pending token
    ``last`` sits at index lengths[s]). Returns cand (S, K) int32 with
    cand[:, 0] = last; a slot without a match, and a draft position
    past the history, drafts 0 (the verify still emits the one
    correction token)."""
    S, T = toks.shape
    dev = toks.device
    idx = torch.arange(T, device=dev)[None, :]
    a = toks.gather(1, (lengths - 1).clamp(min=0).long()[:, None])[:, 0]
    nxt_t = torch.cat([toks[:, 1:],
                       torch.zeros((S, 1), dtype=toks.dtype, device=dev)],
                      dim=1)
    ok = ((toks == a[:, None]) & (nxt_t == last[:, None])
          & (idx <= (lengths - 2)[:, None]))
    has = ok.any(dim=1)
    # the latest match (any value without one: its drafts are masked)
    i_best = torch.where(ok, idx, -1).amax(dim=1)
    offs = (i_best + 2)[:, None] + torch.arange(K - 1, device=dev)[None, :]
    vals = toks.gather(1, offs.clamp(0, T - 1))
    valid = offs <= lengths[:, None]        # within history [0, lengths]
    tail = torch.where(has[:, None] & valid, vals, 0).to(torch.int32)
    return torch.cat([last[:, None].to(torch.int32), tail], dim=1)


def spec_accept(pred, n_acc, bad, active, remaining, eos, last):
    """Greedy speculative acceptance, shared by both engines: one
    verify's predictions (S, K), accepted-draft counts ``n_acc`` and
    non-finite flags become the per-slot count of emitted tokens
    ``n_eff`` (0..K: the accepted run plus the correction, cut after
    the first eos and at the budget ``remaining``; 0 for an inactive or
    non-finite slot), the advanced ``last`` token, ``bad`` masked by
    ``active`` (a stale inactive slot never fails a finished request),
    and whether the slot emitted its eos. Returns (n_eff int32, last,
    bad, emitted_eos)."""
    K = pred.shape[1]
    bad = bad & active
    n_raw = torch.where(bad, 0, n_acc + 1).to(torch.int32)
    j = torch.arange(K, device=pred.device)[None, :]
    is_eos = ((pred == eos[:, None]) & (eos >= 0)[:, None]
              & (j < n_raw[:, None]))
    any_eos = is_eos.any(dim=1)
    first_eos = is_eos.to(torch.int32).argmax(dim=1).to(torch.int32)
    n_eff = torch.where(any_eos, first_eos + 1, n_raw)
    n_eff = torch.minimum(n_eff, remaining.to(torch.int32))
    n_eff = torch.where(active, n_eff, 0).to(torch.int32)
    new_last = pred.gather(1, (n_eff - 1).clamp(min=0).long()[:, None])[:, 0]
    last = torch.where(n_eff > 0, new_last, last)
    emitted_eos = any_eos & (first_eos < n_eff)
    return n_eff, last, bad, emitted_eos


def append_history(toks, lengths, pred, active):
    """Append one verify's K predictions to the history ``toks`` (S, T)
    in place: pred[:, j] is the token at position lengths + 1 + j. The
    window starts at min(lengths + 1, T - K), as
    ``lax.dynamic_update_slice`` clamps it; predictions past the
    accepted run are overwritten by the next step's window or lie past
    ``lengths``, where the drafts never read. An inactive slot rewrites
    its own window (a mid-admission slot's stale length must not
    clobber the prompt its prefill wrote)."""
    T, K = toks.shape[1], pred.shape[1]
    start = (lengths.long() + 1).clamp(max=T - K)
    cols = start[:, None] + torch.arange(K, device=toks.device)[None, :]
    old = toks.gather(1, cols)
    toks.scatter_(1, cols, torch.where(active[:, None], pred, old))


def resolve_engine_weights(model, share_weights_with):
    """The donor-or-build protocol: returns (cfg, head dict, per-layer
    weight maps, stacked slabs). The head dict's ``proj`` is the LM
    projection (``GPT.head_weight``); the stacked slabs are the model's
    (L, ...) block slabs by name (``GPT.stacked``, the megakernel's
    operands; the quantized ones absent). With a donor, weights alias
    the donor's; otherwise they come from ``model``, which must be a
    dense stack; an int8 model's QuantTensors pass through as they
    are."""
    if model is None:
        if share_weights_with is None:
            raise ValueError(
                "model=None requires share_weights_with (the donor "
                "engine supplies config + weights)")
        cfg = share_weights_with.cfg
    else:
        cfg = model.cfg
        if cfg.moe_experts > 0:
            raise NotImplementedError("engines serve dense stacks")
    if share_weights_with is not None:
        if share_weights_with.cfg != cfg:
            raise ValueError(
                "share_weights_with engine serves a different model")
        return (cfg, share_weights_with._head, share_weights_with._layers,
                share_weights_with._stacked)
    # detached views: the engine runs no autograd, and sees every
    # in-place update of the model's parameters
    def detach(t):
        return t.detach() if isinstance(t, torch.Tensor) else t

    head = {n: detach(t) for n, t in (
        ("wte", model.wte), ("wpe", model.wpe),
        ("lnf_scale", model.lnf_scale), ("lnf_bias", model.lnf_bias),
        ("proj", model.head_weight()))}
    layers = [{n: detach(t) for n, t in w.items()}
              for w in model.layer_weights()]
    stacked = {n: t.detach() for n, t in model.stacked.items()}
    return cfg, head, layers, stacked


class Request:
    """One in-flight generation request.

    ``deadline`` (monotonic, absolute) bounds the request's wall time in
    the engine; past it the scheduler evicts ONLY this request with
    ``error`` set. ``error`` is also set when the non-finite-logit
    guard evicts it — check it before trusting ``tokens``.
    ``t_submit``/``t_first``/``t_end`` (perf_counter seconds) give TTFT
    and TPOT, recorded in the ``serve/ttft_s`` and ``serve/tpot_s``
    histograms. ``rid`` is the request's trace context
    (``submit(req_id=...)``): every request-scoped span and flight event
    carries it; None for a bare ``submit``."""

    __slots__ = ("prompt", "max_new_tokens", "eos_id", "tokens", "done",
                 "deadline", "error", "t_submit", "t_first", "t_end", "rid")

    def __init__(self, prompt, max_new_tokens, eos_id, deadline=None,
                 rid=None):
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.tokens: List[int] = []   # generated only
        self.done = False
        self.deadline = deadline      # absolute time.monotonic() budget
        self.error: Optional[str] = None
        self.t_submit = time.perf_counter()
        self.t_first: Optional[float] = None
        self.t_end: Optional[float] = None     # left the engine
        self.rid = rid

    @property
    def ttft_s(self) -> Optional[float]:
        """Queue wait + prefill up to the first generated token."""
        return (None if self.t_first is None
                else self.t_first - self.t_submit)

    @property
    def tpot_s(self) -> Optional[float]:
        """Mean time per generated token after the first, up to the
        request's end (None before the end or with one token)."""
        if self.t_first is None or self.t_end is None or len(
                self.tokens) < 2:
            return None
        return (self.t_end - self.t_first) / (len(self.tokens) - 1)

    @property
    def failed(self) -> bool:
        return self.error is not None

    @property
    def output(self) -> List[int]:
        return self.prompt + self.tokens


class _HandoffRequest(Request):
    """A request whose KV state was built on another replica: the wire
    pages (paged receiver) or rows (contiguous receiver), the tokens
    generated so far (one right after prefill; more when a draining
    replica migrated it mid-decode), the valid-row count and the wire
    they crossed, until admission installs them (``_admit_handoff``)."""

    __slots__ = ("kv_pages", "kv_rows", "kv_wire", "kv_tokens", "kv_ntok")


def handoff_meta(req: Request, n: int) -> dict:
    """The handoff metadata of a detached request with ``n`` valid KV
    rows (prompt + generated[:-1]): everything a receiver's
    ``submit_handoff`` needs to rebuild its device state. ``tokens``
    carries the whole generated history; the receiver re-emits the last
    one, whose KV the next dispatch writes."""
    return {"prompt": list(req.prompt), "n_tokens": n,
            "first": int(req.tokens[0]),
            "tokens": [int(t) for t in req.tokens],
            "max_new_tokens": int(req.max_new_tokens),
            "eos_id": req.eos_id, "rid": req.rid}


def handoff_request(meta: dict, k, v, deadline_s=None) -> "_HandoffRequest":
    """Validate a handoff's metadata and (L, npages, Hkv, page, D) pages
    and build its request (``kv_pages`` holds them as CPU tensors).
    Raises ValueError on inconsistent metadata."""
    from paddle_tpu_torch.serving.kv_transfer import _host
    req = _HandoffRequest(
        meta["prompt"], meta["max_new_tokens"], meta["eos_id"],
        deadline=(None if deadline_s is None
                  else time.monotonic() + deadline_s),
        rid=meta.get("rid"))
    req.kv_tokens = [int(t) for t in meta.get("tokens", [meta["first"]])]
    if len(req.prompt) < 1:
        raise ValueError("empty prompt")
    if not req.kv_tokens:
        raise ValueError("handoff meta carries no tokens")
    req.kv_ntok = int(meta.get(
        "n_tokens", len(req.prompt) + len(req.kv_tokens) - 1))
    if req.kv_ntok != len(req.prompt) + len(req.kv_tokens) - 1:
        raise ValueError(
            f"handoff meta inconsistent: n_tokens={req.kv_ntok} != "
            f"prompt {len(req.prompt)} + generated {len(req.kv_tokens)} "
            f"- 1")
    if len(req.kv_tokens) > req.max_new_tokens:
        raise ValueError("handoff carries more generated tokens than its "
                         "budget")
    req.kv_pages = (_host(k), _host(v))
    req.kv_rows = None
    # the wire these pages crossed (senders stamp it into the meta);
    # absent -> assume lossy, so the pages are never re-published
    req.kv_wire = str(meta.get("wire", "lossy"))
    return req


def handoff_rows(cfg, arr: torch.Tensor, n: int, name: str,
                 want: str) -> torch.Tensor:
    """The geometry screen of a handoff's (L, npages, Hkv, page, D)
    pages — (n_layers, kv_heads, head_dim) must match ``cfg`` and the
    pages must hold ``n`` rows, else ValueError (at submit, never as a
    shape error inside a later step) — and their first ``n`` rows as
    one (L, Hkv, n, D) tensor."""
    ok = (arr.dim() == 5 and arr.shape[0] == cfg.n_layers
          and arr.shape[2] == cfg.kv_heads
          and arr.shape[4] == cfg.head_dim
          and arr.shape[1] * arr.shape[3] >= n)
    if not ok:
        raise ValueError(
            f"handoff {name} pages shaped {tuple(arr.shape)} do not fit "
            f"this engine's geometry {want} — sender and receiver must "
            f"share (n_layers, kv_heads, head_dim) and carry n_tokens rows")
    L, npg, H, page, D = arr.shape
    return arr.transpose(1, 2).reshape(L, H, npg * page, D)[:, :, :n]


class _Inflight:
    """One in-flight dispatch awaiting harvest: the live (slot, request)
    snapshot it covered, and the on-device result. ``kind`` is
    'prefill' (payload: the sampled first token, a device scalar),
    'decode' (packed (3, chunk, S) int32: tokens / emit flags /
    non-finite flags) or 'spec' (packed (chunk, S, K + 2) int32: K
    predictions / emitted count / non-finite flag)."""

    __slots__ = ("kind", "live", "payload")

    def __init__(self, kind, live, payload):
        self.kind, self.live, self.payload = kind, live, payload


class ResilientScheduler:
    """Shared scheduling core: the pipelined dispatch/harvest loop and
    per-request degradation (evict ONE request on a deadline overrun or
    non-finite logits without disturbing its batch peers). Engines
    override ``_on_evict`` to reclaim their own per-slot resources, and
    supply ``_emit``/``_apply_token``.

    Service hooks (the front end, ``paddle_tpu_torch/serving/
    scheduler.py``, installs them):

    - ``on_token(req, token)``: called the moment a harvested token is
      appended to ``req.tokens``, in the request's stream order
      (speculative emits included).
    - ``on_retire(req)``: called exactly once when a request leaves the
      engine (retired, deadline-evicted or poison-evicted; check
      ``req.error``), from inside the harvest, the moment its slot
      frees: a front end backfills the slot here.
    - ``bucket_policy(engine, remaining)``: overrides the contiguous
      engine's chunked-prefill bucket for a chunk covering
      ``remaining`` prompt tokens (one of ``engine.buckets``). None
      keeps the smallest covering bucket; the paged engine never
      consults it."""

    on_token = None
    on_retire = None
    bucket_policy = None
    # the first-token histogram: a prefill-only engine's first token
    # marks the end of prefill (``serve/prefill_s``), never a client TTFT
    _ttft_metric = "serve/ttft_s"
    # speculative depth K (0: off); an engine's constructor sets it, and
    # the shared replay unpacks 'spec' records (chunk, S, K + 2) by it
    spec_k = 0

    @property
    def free_slots(self) -> int:
        """Slots with no request bound (admission capacity right now)."""
        return sum(r is None for r in self._slot_req)

    @property
    def queued(self) -> int:
        """Requests submitted but not yet assigned a slot."""
        return len(self._waiting)

    def _on_evict(self, slot: int):
        self.active[slot] = False

    def _fail(self, req: Request, reason: str, slot: Optional[int] = None,
              stat: str = "serve/deadline_evictions"):
        req.done = True
        req.error = reason
        if slot is not None:
            self._slot_req[slot] = None
            self._on_evict(slot)
            self._disp_rem[slot] = 0
        stats.add(stat)
        # terminal failure: dump the request's flight record now, so the
        # postmortem needs no re-run under tracing
        flight.record(req.rid, "evicted", reason=reason, stat=stat,
                      slot=slot, tokens=len(req.tokens))
        flight.dump(req.rid, reason)
        self._obs_request_end(req)

    def _poison_mask(self):
        """Injection mask for this dispatch (site
        ``engine.poison_logits``): an (S,) int32 device tensor, nonzero
        for a poisoned slot. With no fault plan it is one cached
        all-zero tensor: no allocation or copy per dispatch, and the
        plain paths skip it (``_poison``) while K9 reads it as its
        ``poison`` operand."""
        if not faults.enabled():
            mask = getattr(self, "_no_poison", None)
            if mask is None:
                mask = self._no_poison = torch.zeros(
                    (self.S,), dtype=torch.int32, device=self.device)
            return mask
        return torch.from_numpy(faults.slot_mask(
            "engine.poison_logits", self.S).astype(np.int32)).to(
                self.device)

    def _poison(self, logits, poison):
        """(S, ...) logits with the poisoned slots' rows NaN. The cached
        all-zero mask is the identity and costs no launch."""
        if poison is getattr(self, "_no_poison", None):
            return logits
        mask = poison.reshape(-1, *([1] * (logits.dim() - 1))) != 0
        return torch.where(mask, float("nan"), logits)

    def _capture(self, name, flops, nbytes, weights, state):
        """The ``CostCapture`` of one decode dispatch with its footprint:
        argument bytes (``weights``, then the caches or pools and
        per-slot vectors in ``state``) and output bytes (the packed
        record, (3, chunk, S) or speculative (chunk, S, K + 2), and four
        per-slot vectors)."""
        seen, arg = set(), 0
        for t in (*weights, *state):
            # a tied head's projection is a view of wte: count it once
            key = (id(t) if isinstance(t, QuantTensor) or t is None
                   else (t.data_ptr(), t.numel()))
            if key not in seen:
                seen.add(key)
                arg += _nbytes(t)
        words = self.spec_k + 2 if self.spec_k else 3
        out = words * self.chunk * self.S * 4 + 4 * self.S * 4
        return devprof.capture(name, flops, nbytes,
                               {"argument_size_in_bytes": arg,
                                "output_size_in_bytes": out})

    def _weight_tensors(self, layers):
        """The head tensors and every tensor of ``layers`` (a list of
        weight maps, or one map of slabs)."""
        maps = layers if isinstance(layers, list) else [layers]
        return [*self._head.values(),
                *(t for w in maps for t in w.values())]

    # -- pipelined dispatch -------------------------------------------------
    def _init_pipeline(self, inflight: int):
        """In-flight depth (the engines default to 2). Depth 1 is the
        fully synchronous baseline."""
        depth = int(inflight)
        if depth < 1:
            raise ValueError(f"in-flight depth must be >= 1, got {depth}")
        self.depth = depth
        self._pending: collections.deque = collections.deque()
        # host shadow of per-slot dispatch budgets: decides ONLY when to
        # stop dispatching — the truth (remaining/eos/active) is on device
        self._disp_rem = np.zeros((self.S,), np.int64)
        self._t_disp_end: Optional[float] = None

    def _pending_cover(self):
        """slot -> number of in-flight DECODE dispatches covering it."""
        cover: dict = {}
        for rec in self._pending:
            if rec.kind != "prefill":
                for s, _ in rec.live:
                    cover[s] = cover.get(s, 0) + 1
        return cover

    def _resync_budgets(self, live, cover=None):
        """Re-anchor the host budget shadow to harvested truth: the
        request's true remaining minus the guaranteed progress (``chunk``
        tokens each) of dispatches still in flight. Exact for the plain
        and chunked paths; for a speculative dispatch, whose yield is
        chunk..chunk·K tokens a slot, ``chunk`` is the least it yields,
        so the shadow is a lower bound, and the few dispatches it may
        add at a request's tail find the slot stopped on the device
        (at most ``depth`` of them)."""
        if cover is None:
            cover = self._pending_cover()
        for slot, req in live:
            if req.done or self._slot_req[slot] is not req:
                continue
            rem = req.max_new_tokens - len(req.tokens)
            self._disp_rem[slot] = max(
                0, rem - self.chunk * cover.get(slot, 0))

    def _obs_host_gap(self):
        """Host bubble between one dispatch's enqueue and the next."""
        if self._t_disp_end is not None:
            stats.observe("serve/host_gap_s",
                          time.perf_counter() - self._t_disp_end)

    def _dispatch_span(self, kind):
        """The ``serve/dispatch`` span of one decode dispatch (``k``: the
        speculative width, on a speculative engine)."""
        return trace.span("serve/dispatch", kind=kind, chunk=self.chunk,
                          inflight=len(self._pending),
                          **({"k": self.spec_k} if self.spec_k else {}))

    def _finish_dispatch(self, kind, live, payload):
        """Post-enqueue bookkeeping: charge the budget shadows, queue the
        in-flight record, publish the launch counters."""
        for s, _ in live:
            self._disp_rem[s] = max(0, self._disp_rem[s] - self.chunk)
        self._pending.append(_Inflight(kind, live, payload))
        self._t_disp_end = time.perf_counter()
        stats.add("serve/dispatch_launches")
        stats.add(f"serve/dispatches/{kind}")
        stats.set_value("serve/inflight", len(self._pending))

    def _pump(self, dispatched: bool):
        """Keep at most ``depth`` dispatches in flight after a dispatch;
        harvest one when there was nothing to dispatch (drain tail)."""
        if dispatched:
            while len(self._pending) >= self.depth:
                self._harvest_one()
        else:
            self._t_disp_end = None
            if self._pending:
                self._harvest_one()

    def _harvest_one(self) -> int:
        """Copy the OLDEST in-flight dispatch's packed record to the host
        (one transfer) and replay it into its Requests."""
        rec = self._pending.popleft()
        with trace.span("serve/harvest", kind=rec.kind,
                        inflight=len(self._pending)) as sp:
            arr = rec.payload.cpu().numpy()
            emitted = self._replay(rec, arr)
            sp.attrs["tokens"] = emitted
        stats.set_value("serve/inflight", len(self._pending))
        self.tokens_emitted += emitted
        return emitted

    def _drain(self):
        """Harvest every in-flight dispatch (the hard pipeline boundary
        a host-side mutation of device state needs)."""
        while self._pending:
            self._harvest_one()

    def _replay(self, rec, arr) -> int:
        """Apply one harvested record to its live snapshot. Requests
        retired or evicted since the dispatch are skipped (the device
        had already deactivated their slots)."""
        if rec.kind == "prefill":
            slot, req = rec.live[0]
            if not req.done and self._slot_req[slot] is req:
                self._emit(slot, req, int(arr))
            self._resync_budgets(rec.live)
            return 0
        if rec.kind == "spec":
            return self._replay_spec(rec, arr)
        toks = arr[0]
        flags = arr[1].astype(bool)
        bads = arr[2].astype(bool)
        total = 0
        for slot, req in rec.live:
            if req.done or self._slot_req[slot] is not req:
                continue
            for j in range(self.chunk):
                if flags[j, slot] and not req.done:
                    self._apply_token(slot, req, int(toks[j, slot]))
                    total += 1
            if bads[:, slot].any() and not req.done:
                self._fail(req, "non-finite logits", slot=slot,
                           stat="serve/nonfinite_evictions")
        self._after_replay(rec)
        self._resync_budgets(rec.live)
        return total

    def _replay_spec(self, rec, arr) -> int:
        """A speculative record (chunk, S, K + 2): per chunk step the K
        predictions, the count emitted n_eff and the non-finite flag;
        the first n_eff predictions of each step are the emitted
        tokens."""
        K = self.spec_k
        preds, effs = arr[..., :K], arr[..., K]
        bads = arr[..., K + 1].astype(bool)
        total = 0
        for slot, req in rec.live:
            if req.done or self._slot_req[slot] is not req:
                continue
            for j in range(self.chunk):
                for t in range(int(effs[j, slot])):
                    self._apply_token(slot, req, int(preds[j, slot, t]))
                    total += 1
            if bads[:, slot].any() and not req.done:
                self._fail(req, "non-finite logits", slot=slot,
                           stat="serve/nonfinite_evictions")
        self._after_replay(rec)
        self._resync_budgets(rec.live)
        return total

    def _spec_chunk(self, verify, toks, lengths, last, active, remaining,
                    eos):
        """``chunk`` speculative steps in one dispatch, both engines:
        draft from the history ``toks`` (updated in place), verify
        (``verify(lengths, cand, active)`` -> the greedy predictions
        (S, K) int32 and the per-slot non-finite flag), accept the
        drafts while they equal the prediction before them, append the
        predictions to the history, and stop a slot on eos, budget or
        non-finite logits; nothing is read back to the host. Returns
        the new lengths, last, active and remaining and the packed
        (chunk, S, K + 2) int32 record."""
        K = self.spec_k
        preds, effs, bads = [], [], []
        for _ in range(self.chunk):
            cand = prompt_lookup_draft(toks, lengths, last, K)
            pred, bad = verify(lengths, cand, active)
            n_acc = torch.cumprod(
                (cand[:, 1:] == pred[:, :-1]).to(torch.int32), dim=1).sum(1)
            n_eff, last, bad, emitted_eos = spec_accept(
                pred, n_acc, bad, active, remaining, eos, last)
            append_history(toks, lengths, pred, active)
            remaining = remaining - n_eff
            lengths = lengths + n_eff
            active = active & ~bad & ~emitted_eos & (remaining > 0)
            preds.append(pred)
            effs.append(n_eff)
            bads.append(bad)
        packed = torch.cat([torch.stack(preds),
                            torch.stack(effs)[..., None],
                            torch.stack(bads).to(torch.int32)[..., None]],
                           dim=-1)
        return lengths, last, active, remaining, packed

    def _check_spec(self, temperature: float):
        """The speculative options' contract (both engines)."""
        if self.spec_k:
            if self.spec_k < 2:
                raise ValueError("speculative_k must be >= 2 (one input "
                                 "token + at least one candidate)")
            if temperature != 0.0:
                raise NotImplementedError(
                    "speculative decoding is greedy-only (lossless "
                    "acceptance needs argmax determinism)")

    def _apply_token(self, slot: int, req: Request, token: int):
        raise NotImplementedError

    def _lm_head(self, x):
        """Final LN + the LM projection on (S, L, d) -> (S, L, V)."""
        head = self._head
        x = final_ln(x, head["lnf_scale"], head["lnf_bias"])
        return x @ head["proj"]

    def _after_replay(self, rec):
        """Post-replay hook (the contiguous engine retires here)."""

    def drain(self) -> None:
        """Block until every in-flight dispatch is harvested and applied;
        request state (``tokens``/``done``) is exact afterwards."""
        self._drain()

    # -- serving metrics ----------------------------------------------------
    def _obs_first_token(self, req: Request):
        if req.t_first is None:
            req.t_first = time.perf_counter()
            stats.observe(self._ttft_metric, req.t_first - req.t_submit)

    def _obs_request_end(self, req: Request):
        """The request left the engine (done or evicted): stamp its end,
        record its TPOT, and close its ``serve/request`` span (submit to
        end) and, after a first token, its ``serve/decode`` span (first
        token to end; a prefill-only engine has no decode phase), once.
        The ``on_retire`` hook fires here, behind the same once-only
        guard."""
        if req.t_end is not None:
            return
        req.t_end = time.perf_counter()
        if req.tpot_s is not None:
            stats.observe("serve/tpot_s", req.tpot_s)
        trace.complete("serve/request", req.t_submit, req.t_end,
                       rid=req.rid, prompt=len(req.prompt),
                       tokens=len(req.tokens), error=req.error)
        if req.t_first is not None and self._ttft_metric == "serve/ttft_s":
            trace.complete("serve/decode", req.t_first, req.t_end,
                           rid=req.rid, tokens=len(req.tokens))
        if self.on_retire is not None:
            self.on_retire(req)

    def _obs_step(self, t0: float, emitted: int, live: int):
        stats.observe("serve/queue_depth", len(self._waiting))
        stats.observe("serve/batch_occupancy", live / max(1, self.S))
        if emitted > 0:
            stats.observe("serve/token_s",
                          (time.perf_counter() - t0) / emitted)

    def _evict_expired(self):
        """Deadline sweep (queue + live slots) at each step entry. A live
        eviction mutates device state, so the pipeline drains first."""
        now = time.monotonic()
        for req in [r for r in self._waiting
                    if r.deadline is not None and now > r.deadline]:
            self._waiting.remove(req)
            self._fail(req, "deadline exceeded while queued",
                       stat="serve/queue_deadline_rejects")
        if any(req is not None and req.deadline is not None
               and now > req.deadline for req in self._slot_req):
            self._drain()
            now = time.monotonic()
            for slot, req in enumerate(self._slot_req):
                if (req is not None and req.deadline is not None
                        and now > req.deadline):
                    self._fail(req, "deadline exceeded", slot=slot)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class DecodeEngine(ResilientScheduler):
    """Continuous-batching generation over a dense GPT model with
    slot-contiguous KV caches.

        eng = DecodeEngine(model, max_slots=8, max_len=512)
        r1 = eng.submit(prompt_a, max_new_tokens=32)
        r2 = eng.submit(prompt_b, max_new_tokens=8)   # joins mid-flight
        eng.run()                                     # drains everything
        r1.tokens, r2.tokens

    Greedy by default; temperature / top-k / top-p as ``gpt.generate``;
    ``speculative_k`` (greedy only) verifies K tokens a slot per step.
    ``device`` defaults to CUDA and must be the model's device."""

    def __init__(self, model, max_slots: int = 8,
                 max_len: Optional[int] = None,
                 buckets: Optional[Sequence[int]] = None,
                 temperature: float = 0.0, top_p: float = 1.0,
                 top_k: int = 0, seed: int = 0, cache_dtype=None,
                 speculative_k: int = 0, steps_per_call: int = 1,
                 share_weights_with: "Optional[DecodeEngine]" = None,
                 weight_dtype: Optional[str] = None, mesh=None,
                 inflight: int = 2, warmup: bool = False,
                 prefill_tokens: Optional[int] = None, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "tensor-parallel serving (mesh) is not ported to "
                "paddle_tpu_torch yet (ROADMAP 'Port queue': distributed "
                "on torch.distributed)")
        self.device = device_lib.resolve(device)
        cfg, head, layers, stacked = resolve_engine_weights(
            model, share_weights_with)
        if head["wte"].device != self.device:
            raise ValueError(f"model lives on {head['wte'].device}, engine "
                             f"device is {self.device}")
        self.cfg = cfg
        # a 128-multiple cache length keeps K10 engaged, never past the
        # position table
        cap = cfg.max_seq_len
        self.T = min(_round_up(min(max_len or cap, cap), 128), cap)
        self.S = int(max_slots)
        self.sample = (float(temperature), float(top_p), int(top_k))
        self.spec_k = int(speculative_k)
        self._check_spec(float(temperature))
        if buckets is None:
            buckets = [b for b in (16, 32, 64, 128, 256, 512)
                       if b <= self.T] or [self.T]
        self.buckets = sorted(set(int(b) for b in buckets))
        if self.buckets[-1] > self.T:
            raise ValueError(
                f"bucket {self.buckets[-1]} exceeds cache length {self.T}")
        self._head, self._layers, self._stacked = head, layers, stacked
        if weight_dtype == "int8":
            self._quantize_stacked_int8()
        elif weight_dtype is not None:
            raise ValueError(f"weight_dtype must be None or 'int8', got "
                             f"{weight_dtype!r}")
        self._block = GPTBlock(cfg)
        self.chunk = int(steps_per_call)
        if self.chunk < 1:
            raise ValueError("steps_per_call must be >= 1")

        dev = self.device
        dt = (dtypes.to_dtype(cache_dtype) if cache_dtype is not None
              else cfg.dtype)
        shape = (cfg.n_layers, self.S, cfg.kv_heads, self.T, cfg.head_dim)
        self.kc = torch.zeros(shape, dtype=dt, device=dev)
        self.vc = torch.zeros(shape, dtype=dt, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        self.lengths = torch.zeros((self.S,), **i32)
        self.last = torch.zeros((self.S,), **i32)
        self.active = torch.zeros((self.S,), dtype=torch.bool, device=dev)
        # budgets / eos ids persist on the device across dispatches
        self.remaining = torch.zeros((self.S,), **i32)
        self.eos_ids = torch.full((self.S,), -1, **i32)
        # speculative only: the token history the drafts read, toks[s, i]
        # token i for i <= lengths[s] (the pending token at lengths[s])
        self.toks = (torch.zeros((self.S, self.T), **i32) if self.spec_k
                     else None)
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(int(seed))

        self._slot_req: List[Optional[Request]] = [None] * self.S
        self._waiting: collections.deque = collections.deque()
        self.steps = 0            # decode dispatches
        self.tokens_emitted = 0
        self._init_pipeline(inflight)
        self._admitting: collections.deque = collections.deque()
        # per-step prompt-token budget (default the largest bucket), at
        # least one bucket so an open admission always progresses
        self._prefill_budget = max(int(prefill_tokens or self.buckets[-1]),
                                   self.buckets[0])
        if warmup:
            self.warmup()

    @property
    def kv_bytes(self) -> int:
        """Outstanding KV bytes across live slots (the decode-placement
        load gauge): a slot-contiguous engine charges each live slot its
        whole cache window."""
        live = sum(r is not None for r in self._slot_req)
        cfg = self.cfg
        return live * (2 * cfg.n_layers * cfg.kv_heads * self.T
                       * cfg.head_dim * self.kc.element_size())

    # -- mid-decode handoff (drain migration) -------------------------------

    def detach_handoff(self, req: Request):
        """Extract an in-flight request's KV rows and decode state and
        retire it here WITHOUT finishing it — the sending half of a
        drain migration. The pipeline drains first, so rows ``[0, n)``
        hold prompt + generated[:-1] and ``meta["tokens"]`` every token
        generated so far; the receiver re-emits the last one and
        continues (token for token on the fp32 wire).

        Returns ``(meta, k, v)`` with ``k``/``v`` as ONE wire page of
        ``n_tokens`` rows — (L, 1, Hkv, n, D) CPU tensors — which
        ``kv_transfer.encode_kv_pages`` and any ``submit_handoff``
        (contiguous, or paged with matching geometry) accept."""
        if req.failed:
            raise ValueError(f"request failed before detach: {req.error}")
        if not req.tokens:
            raise ValueError("no generated token yet — pump step() until "
                             "the request holds one")
        self._drain()
        if req.done:
            raise ValueError("request completed during drain — publish "
                             "its result directly")
        try:
            slot = self._slot_req.index(req)
        except ValueError:
            raise ValueError("request no longer holds a slot") from None
        n = int(self.lengths[slot])
        if n != len(req.prompt) + len(req.tokens) - 1:
            raise ValueError(
                f"slot {slot} length {n} inconsistent with prompt "
                f"{len(req.prompt)} + generated {len(req.tokens)} - 1")
        # a deliberate device->host copy: the migration payload
        k = self.kc[:, slot, :, :n].cpu()[:, None]
        v = self.vc[:, slot, :, :n].cpu()[:, None]
        meta = handoff_meta(req, n)
        flight.record(req.rid, "handoff-detach", n_tokens=n,
                      generated=len(req.tokens))
        self._slot_req[slot] = None
        self.active[slot] = False
        self._disp_rem[slot] = 0
        req.done = True
        self._obs_request_end(req)
        return meta, k, v

    def submit_handoff(self, meta: dict, k, v,
                       deadline_s: Optional[float] = None) -> Request:
        """Receiving half of a migration: queue a request whose KV rows
        were built elsewhere. Accepts any page layout — (L, npages, Hkv,
        page, D) host pages (torch or numpy) with npages x page >=
        n_tokens — so contiguous (one page) and paged senders with
        matching (L, Hkv, D) land here; a mismatch raises ValueError.
        Admission installs the rows and rebuilds the sender's device
        state; the last sender-emitted token rides the harvest queue
        like a local prefill's first token."""
        req = handoff_request(meta, k, v, deadline_s)
        if len(req.prompt) + req.max_new_tokens > self.T:
            raise ValueError(
                f"{len(req.prompt)} prompt + {req.max_new_tokens} new "
                f"tokens exceed cache length {self.T}")
        cfg, n = self.cfg, req.kv_ntok
        want = (f"(n_layers={cfg.n_layers}, kv_heads={cfg.kv_heads}, "
                f"head_dim={cfg.head_dim}, rows>={n})")
        req.kv_rows = tuple(handoff_rows(cfg, arr, n, name, want)
                            for name, arr in zip("kv", req.kv_pages))
        req.kv_pages = None
        self._waiting.append(req)
        return req

    def _install(self, slot: int, n: int, k, v):
        """Write (L, Hkv, n, D) device rows into the slot's caches at
        positions [0, n)."""
        self.kc[:, slot, :, :n] = k
        self.vc[:, slot, :, :n] = v

    def _admit_handoff(self, req: _HandoffRequest, slot: int):
        """Install migrated rows instead of prefilling, then rebuild the
        device state the sender's drained pipeline held: rows [0, n)
        live, ``tokens[-1]`` pending as ``last`` (its KV is the next
        dispatch's write), the drafts' history row on a speculative
        engine."""
        n = req.kv_ntok
        flight.record(req.rid, "handoff-install", n_tokens=n, slot=slot,
                      wire=req.kv_wire, generated=len(req.kv_tokens))
        dev, dt = self.device, self.kc.dtype
        rows_k, rows_v = req.kv_rows
        self._install(slot, n, rows_k.to(dev, dt), rows_v.to(dev, dt))
        req.kv_rows = None             # free the host copy
        if self.toks is not None:
            hist = torch.zeros((self.T,), dtype=torch.int32)
            hist[:n + 1] = torch.tensor(req.prompt + req.kv_tokens,
                                        dtype=torch.int32)
            self.toks[slot] = hist.to(dev)
        req.tokens = list(req.kv_tokens[:-1])
        nxt = req.kv_tokens[-1]
        rem0 = req.max_new_tokens - len(req.kv_tokens)
        eos0 = -1 if req.eos_id is None else int(req.eos_id)
        alive = rem0 > 0 and (eos0 < 0 or nxt != eos0)
        self.lengths[slot] = n
        self.last[slot] = nxt
        self.active[slot] = bool(alive)
        self.remaining[slot] = rem0
        self.eos_ids[slot] = eos0
        self._slot_req[slot] = req
        self._disp_rem[slot] = rem0
        self._pending.append(_Inflight(
            "prefill", [(slot, req)], torch.tensor(nxt, dtype=torch.int32)))

    # -- weights ------------------------------------------------------------

    def _quantize_stacked_int8(self):
        """Replace each layer's four block matmul weights with int8
        QuantTensors (symmetric absmax, per-(layer, output column)
        scales: the JAX engine's stacked formula, taken one layer at a
        time). New per-layer maps, so a donor's weights
        (``share_weights_with``) are never touched; the LM head stays
        float. The float slabs of the four products leave the engine's
        stacked map, so an engine sharing these weights sees them as
        int8."""
        self._stacked = {n: t for n, t in self._stacked.items()
                         if n not in _BLOCK_MATMULS}
        self._layers = [
            {n: (quantize_tensor(t) if n in _BLOCK_MATMULS
                 and not isinstance(t, QuantTensor) else t)
             for n, t in w.items()}
            for w in self._layers]

    # -- device bodies ------------------------------------------------------

    def _sample(self, logits):
        temperature, top_p, top_k = self.sample
        return _sample_token(logits.float(), self._gen, temperature, top_p,
                             top_k)

    def _one_token(self, lengths, last, active, poison):
        """Advance every active slot one token. Returns the new lengths,
        the next tokens and the per-slot non-finite flags (a bad slot,
        poisoned ones included, emits nothing and does not advance)."""
        head = self._head
        x = head["wte"][last.long()]
        if head["wpe"] is not None:
            pos = lengths.long().clamp(max=self.cfg.max_seq_len - 1)
            x = x + head["wpe"][pos]
        x = x[:, None, :]
        # an inactive slot keeps its row: its device length is stale, and
        # with interleaved admission the row there may be a prompt row a
        # prefill wrote
        rows = cache_rows(lengths, 1, self.T, write=active)
        for i, w in enumerate(self._layers):
            x, _ = self._block.decode_step(x, w, (self.kc[i], self.vc[i]),
                                           rows)
        logits = self._poison(self._lm_head(x)[:, 0], poison)
        bad = active & ~torch.isfinite(logits).all(dim=-1)
        ok = active & ~bad
        nxt = torch.where(ok, self._sample(logits), last)
        return lengths + ok.to(torch.int32), nxt, bad

    def _multi_impl(self, lengths, last, active, remaining, eos, poison):
        """``chunk`` decode steps in one dispatch with per-slot early
        stop on the device: a slot stops at its eos id, at the end of
        its budget, or on non-finite logits (``poison``, the dispatch's
        injection mask, applies to every step). Tokens, emit flags and
        non-finite flags come back packed as one (3, chunk, S) int32
        tensor."""
        toks, flags, bads = [], [], []
        for _ in range(self.chunk):
            lengths, nxt, bad = self._one_token(lengths, last, active,
                                                poison)
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

    def _verify_impl(self, lengths, cand, active, poison):
        """One speculative verify: the K candidates of every slot
        (cand (S, K), at positions lengths..lengths + K - 1) through
        every layer's ``verify_step``, which writes the active slots'
        K/V rows, then the LM head. Returns the greedy predictions
        (S, K) int32 and the per-slot non-finite flag (``poison``'s
        slots included)."""
        S, K = cand.shape
        head = self._head
        x = head["wte"][cand.long()]
        if head["wpe"] is not None:
            pos = (lengths.long()[:, None]
                   + torch.arange(K, device=self.device)[None])
            x = x + head["wpe"][pos.clamp(max=self.cfg.max_seq_len - 1)]
        rows = cache_rows(lengths, K, self.T, write=active)
        for i, w in enumerate(self._layers):
            x, _ = self._block.verify_step(x, w, (self.kc[i], self.vc[i]),
                                           rows)
        logits = self._poison(self._lm_head(x).float(), poison)
        bad = ~torch.isfinite(logits).all(dim=2).all(dim=1)
        return torch.argmax(logits, dim=-1).to(torch.int32), bad

    def _spec_multi_impl(self, toks, lengths, last, active, remaining, eos,
                         poison):
        """``chunk`` speculative steps in one dispatch (``_spec_chunk``
        over ``_verify_impl``)."""
        return self._spec_chunk(
            lambda n, cand, act: self._verify_impl(n, cand, act, poison),
            toks, lengths, last, active, remaining, eos)

    def _prefill_impl(self, slot: int, tokens, start: int, true_total: int,
                      is_final: bool, rem0: int, eos0: int):
        """Run one prompt chunk (tokens (1, bucket)) through the slot's
        cache at [start, start + bucket). On the final chunk, sample the
        first generated token and flip the slot live on the device
        (lengths / last / active / remaining / eos_ids), so decode
        dispatches enqueued behind it pick the slot up with no host
        round trip; returns that token (a device scalar), else None. A
        speculative engine also records the chunk in the history (its
        zero pads are never read) and, on the final chunk, the pending
        token at ``true_total``."""
        head = self._head
        bucket = tokens.shape[1]
        x = head["wte"][tokens]
        if head["wpe"] is not None:
            x = x + head["wpe"][start:start + bucket]
        rows = cache_rows(torch.full((1,), start, dtype=torch.int32,
                                     device=self.device), bucket, self.T)
        for i, w in enumerate(self._layers):
            kv = (self.kc[i, slot:slot + 1], self.vc[i, slot:slot + 1])
            x, _ = self._block.verify_step(x, w, kv, rows)
        if self.toks is not None:
            self.toks[slot, start:start + bucket] = tokens[0]
        if not is_final:
            return None
        idx = min(max(true_total - 1 - start, 0), bucket - 1)
        nxt = self._sample(self._lm_head(x[:, idx:idx + 1])[:, 0])[0]
        if self.toks is not None:
            self.toks[slot, true_total] = nxt
        alive = (nxt != eos0) | (eos0 < 0) if rem0 > 0 else torch.zeros(
            (), dtype=torch.bool, device=self.device)
        self.lengths[slot] = true_total
        self.last[slot] = nxt
        self.active[slot] = alive
        self.remaining[slot] = rem0
        self.eos_ids[slot] = eos0
        return nxt

    # -- scheduler ----------------------------------------------------------

    def check_request(self, prompt_len: int, max_new_tokens: int):
        """Admission feasibility check without enqueueing. Raises
        ValueError."""
        if prompt_len < 1:
            raise ValueError("empty prompt")
        if prompt_len + max_new_tokens > self.T:
            raise ValueError(
                f"{prompt_len} prompt + {max_new_tokens} new tokens "
                f"exceed cache length {self.T}")
        if self.spec_k and (prompt_len + max_new_tokens
                            + self.spec_k - 1 > self.T):
            raise ValueError(
                f"speculative window: prompt + new + K-1 "
                f"({prompt_len}+{max_new_tokens}+{self.spec_k - 1}) "
                f"exceed cache length {self.T}")

    def submit(self, prompt, max_new_tokens: int = 32,
               eos_id: Optional[int] = None,
               deadline_s: Optional[float] = None,
               req_id: Optional[str] = None) -> Request:
        """``deadline_s``: wall-time budget for this request (queue wait
        included); past it the request is evicted alone. ``req_id``: the
        trace context carried into every request-scoped span and flight
        event."""
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

    def _admit_next(self) -> bool:
        """Move the next waiting request into a free slot as an
        incremental prefill job; its chunks dispatch under the per-step
        token budget, interleaved with decode dispatches."""
        slot = self._free_slot()
        if slot is None or not self._waiting:
            return False
        req = self._waiting.popleft()
        # the queue-wait phase ends here
        trace.complete("serve/queue", req.t_submit, rid=req.rid,
                       slot=slot)
        if isinstance(req, _HandoffRequest):
            # no prefill to run: install the transferred rows directly
            self._admit_handoff(req, slot)
            return True
        flight.record(req.rid, "admit", slot=slot, prompt=len(req.prompt))
        self._slot_req[slot] = req      # reserved; decode skips it until
        self._disp_rem[slot] = 0        # the final chunk flips it live
        self._admitting.append({
            "req": req, "slot": slot, "start": 0,
            "prompt": np.asarray(req.prompt, np.int64),
            "t0": time.perf_counter()})
        return True

    def _dispatch_prefill_chunk(self, job):
        """Dispatch ONE bucket-sized prompt chunk. On the final chunk the
        slot goes live on the device and the sampled first token rides
        the harvest queue as a 'prefill' record. Returns (bucket tokens
        consumed, finished)."""
        req, slot = job["req"], job["slot"]
        prompt, start = job["prompt"], job["start"]
        total = len(prompt)
        if self.bucket_policy is not None:
            bucket = int(self.bucket_policy(self, total - start))
            if bucket not in self.buckets:
                raise ValueError(f"bucket_policy returned {bucket}, not "
                                 f"one of {self.buckets}")
        else:
            bucket = next((x for x in self.buckets if x >= total - start),
                          self.buckets[-1])
        s0 = start
        if s0 + bucket > self.T:
            # the tail window would overrun the cache: slide it back over
            # prefilled positions (the same tokens at the same positions
            # recompute the same K/V)
            s0 = self.T - bucket
        n = min(total - s0, bucket)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :n] = prompt[s0:s0 + n]
        is_final = s0 + n >= total
        rem0 = req.max_new_tokens - 1
        eos0 = -1 if req.eos_id is None else int(req.eos_id)
        stats.add("serve/dispatch_launches")
        stats.add("serve/dispatches/prefill")
        flight.record(req.rid, "prefill-chunk", bucket=bucket,
                      start=int(s0), final=bool(is_final))
        with trace.span("serve/prefill", bucket=bucket, slot=slot,
                        rid=req.rid):
            nxt = self._prefill_impl(slot, torch.from_numpy(padded).to(
                self.device), s0, total, is_final, rem0, eos0)
        job["start"] = s0 + n
        if is_final:
            self._disp_rem[slot] = rem0
            self._pending.append(_Inflight("prefill", [(slot, req)], nxt))
            trace.complete("serve/admit", job["t0"], slot=slot,
                           prompt=total, rid=req.rid)
        return bucket, is_final

    def _advance_admissions(self):
        """Dispatch up to ``_prefill_budget`` prompt tokens of prefill
        chunks (at least one chunk when a job is open), pulling new
        requests into free slots as jobs finish."""
        if self._admitting:
            # a job whose request was evicted mid-admission is dropped:
            # its slot is free again, the partial prefill inert
            self._admitting = collections.deque(
                j for j in self._admitting if not j["req"].done)
        budget = self._prefill_budget
        while budget > 0:
            if not self._admitting and not self._admit_next():
                return
            if not self._admitting:
                # a handoff admission: rows installed directly, no
                # prefill job — pull the next waiter
                continue
            used, finished = self._dispatch_prefill_chunk(
                self._admitting[0])
            budget -= used
            if finished:
                self._admitting.popleft()

    def _emit(self, slot: int, req: Request, token: int):
        req.tokens.append(token)
        self._obs_first_token(req)
        if self.on_token is not None:
            self.on_token(req, token)
        hit_eos = req.eos_id is not None and token == req.eos_id
        if hit_eos or len(req.tokens) >= req.max_new_tokens:
            req.done = True
            self._slot_req[slot] = None
            self.active[slot] = False
            self._obs_request_end(req)

    def step(self) -> int:
        """Evict expired requests, dispatch waiting prefill chunks and
        one decode dispatch, then harvest the oldest in-flight dispatch
        once ``depth`` are queued. Returns tokens applied this call."""
        t0 = time.perf_counter()
        base = self.tokens_emitted
        with trace.span("serve/step") as sp:
            self._evict_expired()
            self._advance_admissions()
            self._pump(self._dispatch_decode())
            live = self.num_active
            n = self.tokens_emitted - base
            sp.attrs["active"] = live
            sp.attrs["tokens"] = n
        if live or n:
            self._obs_step(t0, n, live)
        return n

    def _dispatch_decode(self) -> bool:
        """Enqueue ONE decode dispatch over every live slot (chunked or
        speculative)."""
        live = [(s, r) for s, r in enumerate(self._slot_req)
                if r is not None and self._disp_rem[s] > 0]
        if not live:
            return False
        self.steps += 1
        self._obs_host_gap()
        fn, args = self.dispatch_fn_args()
        with self._dispatch_span("spec" if self.spec_k else "chunk"):
            (self.lengths, self.last, self.active, self.remaining,
             packed) = fn(*args)
        self._finish_dispatch("spec" if self.spec_k else "decode", live,
                              packed)
        return True

    def _retire_done(self, live):
        """Free slots whose request hit its budget or eos (the device
        already stopped them); a slot freed and re-admitted since the
        dispatch is left alone."""
        for slot, req in live:
            if req.done or self._slot_req[slot] is not req:
                continue
            if len(req.tokens) >= req.max_new_tokens or (
                    req.eos_id is not None and req.tokens
                    and req.tokens[-1] == req.eos_id):
                req.done = True
                self._slot_req[slot] = None
                self._disp_rem[slot] = 0
                self._obs_request_end(req)

    def _apply_token(self, slot: int, req: Request, token: int):
        # the first generated token rides a 'prefill' record (_emit), so
        # TTFT needs no check here: only the stream hook
        req.tokens.append(token)
        if self.on_token is not None:
            self.on_token(req, token)

    def _after_replay(self, rec):
        self._retire_done(rec.live)

    def run(self) -> None:
        """Run steps until every submitted request is done, then harvest
        the trailing dispatches."""
        while self._waiting or any(r is not None for r in self._slot_req):
            self.step()
        self._drain()

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self._slot_req)

    # -- warmup and device-time attribution ---------------------------------

    _STATE = ("kc", "vc", "lengths", "last", "active", "remaining",
              "eos_ids", "toks")

    def warmup(self):
        """Run one prefill chunk per bucket (the last one samples a first
        token) and one decode dispatch (the speculative program on a
        speculative engine) on throwaway zero state, so the
        first request loads no kernel library and takes no first-launch
        cost of its own. JAX compiles here; eager PyTorch has nothing to
        compile, so warmup is these runs. The engine's caches, per-slot
        state and sampling generator are as they were; the caches exist
        twice while it runs. Records ``serve/warmup_s``."""
        t0 = time.perf_counter()
        saved = {n: getattr(self, n) for n in self._STATE}
        gen_state = self._gen.get_state()
        try:
            for n, t in saved.items():
                setattr(self, n, None if t is None else torch.zeros_like(t))
            for b in self.buckets:
                self._prefill_impl(0, torch.zeros((1, b), dtype=torch.int64,
                                                  device=self.device),
                                   0, 1, b == self.buckets[-1], 0, -1)
            fn, args = self.dispatch_fn_args()
            fn(*args)[-1].cpu()
        finally:
            for n, t in saved.items():
                setattr(self, n, t)
            self._gen.set_state(gen_state)
        stats.observe("serve/warmup_s", time.perf_counter() - t0)

    def dispatch_cost(self, name=None):
        """Flops and HBM bytes of ONE decode dispatch at the current
        geometry, as a ``devprof.CostCapture`` (recorded as
        ``prof/flops[/name]``, ``prof/hbm_bytes[/name]`` and the
        ``mem/compiled_*`` footprint; ``name`` defaults to
        ``"decode"``, ``"spec"`` for the speculative program).

        Counted, not measured, and nothing runs: the engine's state is
        left as it was (the slots' lengths and active flags are read from
        the card). Each of the ``steps_per_call`` steps counts, over all
        S slots (the dispatch computes every slot), each slot at its
        length advanced one per earlier step if active: per layer the
        four block products (K12's cost on an int8 weight, else 2·M·N·K
        flops with both operands and the output moved once), the
        attention over the slot's keys (K10's cost; the plain route
        below a 1024 cache reads the same keys) and the fresh K and V
        rows written; then the LM-head product. The elementwise work
        between them (LayerNorms, biases, GELU, residuals, embedding,
        sampling) is not counted. The JAX engine reads XLA's cost
        analysis, which counts the dispatch's ``scan`` body once: its
        capture is one step whatever ``steps_per_call``; the port's is
        the whole dispatch.

        The speculative program counts, per verify, the four products
        and the LM head at S·K rows, and the grouped einsum's attention:
        every slot's whole cache (T keys) read once, its K query rows
        over T keys, the K fresh K and V rows written (the drafts,
        acceptance and history are not counted). The counts do not
        depend on the lengths."""
        cfg = self.cfg
        S, hq, hkv, D = self.S, cfg.n_heads, cfg.kv_heads, cfg.head_dim
        elt = torch.empty((), dtype=cfg.dtype).element_size()
        celt = self.kc.element_size()
        state = [t for t in (getattr(self, n) for n in self._STATE)
                 if t is not None]
        weights = self._weight_tensors(self._layers)
        if self.spec_k:
            K = self.spec_k
            # K query rows a slot count as K times the query heads over
            # the slot's T keys
            fa, ba = decode_attention_cost([self.T] * S, hq * K, hkv, D,
                                           celt)
            flops = nbytes = 0
            for w in self._layers:
                fm, bm = block_matmul_cost(w, S * K, elt)
                flops += fm + fa
                nbytes += bm + ba + 2 * S * K * hkv * D * celt
            fh, bh = devprof.matmul_cost(S * K, cfg.d_model,
                                         cfg.vocab_size, elt)
            return self._capture(name or "spec", self.chunk * (flops + fh),
                                 self.chunk * (nbytes + bh), weights, state)
        lengths, active = self.lengths.tolist(), self.active.tolist()
        flops = nbytes = 0
        for j in range(self.chunk):
            keys = [min(n + j * bool(a) + 1, self.T)
                    for n, a in zip(lengths, active)]
            for w in self._layers:
                fm, bm = block_matmul_cost(w, S, elt)
                fa, ba = decode_attention_cost(keys, hq, hkv, D, celt)
                flops += fm + fa
                nbytes += bm + ba + 2 * S * hkv * D * celt
            fh, bh = devprof.matmul_cost(S, cfg.d_model, cfg.vocab_size,
                                         elt)
            flops += fh
            nbytes += bh
        return self._capture(name or "decode", flops, nbytes, weights,
                             state)

    def dispatch_fn_args(self):
        """The decode dispatch (a bound method: the speculative program
        on a speculative engine) and the argument tuple the serving loop
        calls it with at the current state, for launch accounting
        (``devprof.count_kernel_launches``). Unlike the JAX engine's,
        whose callers lower it without running, calling it RUNS a
        dispatch: it writes the active slots' K/V rows (and history) in
        place (and draws from the sampling generator) as a real dispatch
        does, and its returned state is dropped. Call it on an engine
        with no live slot."""
        if self.spec_k:
            return (self._spec_multi_impl,
                    (self.toks, self.lengths, self.last, self.active,
                     self.remaining, self.eos_ids, self._poison_mask()))
        return (self._multi_impl,
                (self.lengths, self.last, self.active, self.remaining,
                 self.eos_ids, self._poison_mask()))


def decode_roofline_tokens_per_sec(cfg, batch: int, context: int,
                                   hbm_gbps: float,
                                   weight_bytes: int = 2,
                                   cache_bytes: int = 2) -> float:
    """Memory-bandwidth upper bound on decode throughput (a copy of the
    JAX package's): per decode step the card reads every weight once
    (batch-amortized) plus each sequence's KV prefix, so steps/s =
    BW / (W + B * kv_bytes) and tokens/s = B * steps/s."""
    n = cfg.num_params()
    kv = 2 * cfg.n_layers * cfg.kv_heads * cfg.head_dim * context
    step_bytes = n * weight_bytes + batch * kv * cache_bytes
    return batch * hbm_gbps * 1e9 / step_bytes
