"""The serving engines' shared parts (counterpart of the parts of
``paddle_tpu/inference/decode_engine.py`` the paged engine inherits):
``Request``, the in-flight dispatch record, ``resolve_engine_weights``
and the ``ResilientScheduler`` core — the lag-one dispatch/harvest
pipeline, retirement on eos or budget, deadline eviction and
non-finite eviction.

The pipeline maps onto CUDA's stream order: a dispatch enqueues its
kernels and returns at once; a harvest copies the OLDEST dispatch's
packed int32 record to the host (the one device→host transfer per
dispatch), which waits for that dispatch only, while younger ones keep
the card busy.

Left for later slices: the slot-contiguous ``DecodeEngine`` itself,
speculative-decode records, fault injection (``_poison_mask``), trace
spans and the flight recorder.
"""

import collections
import time
from typing import List, Optional

import numpy as np

from paddle_tpu_torch import stats

__all__ = ["Request", "ResilientScheduler", "resolve_engine_weights"]


def resolve_engine_weights(model, share_weights_with):
    """The donor-or-build protocol: returns (cfg, head dict, per-layer
    weight maps).
    With a donor, weights alias the donor's; otherwise they come from
    ``model``, which must be a dense stack."""
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
        return cfg, share_weights_with._head, share_weights_with._layers
    # detached views: the engine runs no autograd, and sees every
    # in-place update of the model's parameters
    head = {n: None if t is None else t.detach() for n, t in (
        ("wte", model.wte), ("wpe", model.wpe),
        ("lnf_scale", model.lnf_scale), ("lnf_bias", model.lnf_bias),
        ("lm_head", model.lm_head))}
    layers = [{n: t.detach() for n, t in w.items()}
              for w in model.layer_weights()]
    return cfg, head, layers


class Request:
    """One in-flight generation request.

    ``deadline`` (monotonic, absolute) bounds the request's wall time in
    the engine; past it the scheduler evicts ONLY this request with
    ``error`` set. ``error`` is also set when the non-finite-logit
    guard evicts it — check it before trusting ``tokens``.
    ``t_submit``/``t_first``/``t_end`` (perf_counter seconds) give TTFT
    and TPOT, recorded in the ``serve/ttft_s`` and ``serve/tpot_s``
    histograms."""

    __slots__ = ("prompt", "max_new_tokens", "eos_id", "tokens", "done",
                 "deadline", "error", "t_submit", "t_first", "t_end")

    def __init__(self, prompt, max_new_tokens, eos_id, deadline=None):
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


class _Inflight:
    """One in-flight dispatch awaiting harvest: the live (slot, request)
    snapshot it covered, and the on-device result. ``kind`` is
    'prefill' (payload: the sampled first token, a device scalar) or
    'decode' (packed (3, chunk, S) int32: tokens / emit flags /
    non-finite flags)."""

    __slots__ = ("kind", "live", "payload")

    def __init__(self, kind, live, payload):
        self.kind, self.live, self.payload = kind, live, payload


class ResilientScheduler:
    """Shared scheduling core: the pipelined dispatch/harvest loop and
    per-request degradation (evict ONE request on a deadline overrun or
    non-finite logits without disturbing its batch peers). Engines
    override ``_on_evict`` to reclaim their own per-slot resources, and
    supply ``_emit``/``_apply_token``."""

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
        self._obs_request_end(req)

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
        tokens each) of dispatches still in flight."""
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
        arr = rec.payload.cpu().numpy()
        emitted = self._replay(rec, arr)
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
        self._resync_budgets(rec.live)
        return total

    def _apply_token(self, slot: int, req: Request, token: int):
        raise NotImplementedError

    def drain(self) -> None:
        """Block until every in-flight dispatch is harvested and applied;
        request state (``tokens``/``done``) is exact afterwards."""
        self._drain()

    # -- serving metrics ----------------------------------------------------
    def _obs_first_token(self, req: Request):
        if req.t_first is None:
            req.t_first = time.perf_counter()
            stats.observe("serve/ttft_s", req.t_first - req.t_submit)

    def _obs_request_end(self, req: Request):
        """The request left the engine (done or evicted): stamp its end
        and record its TPOT, once."""
        if req.t_end is not None:
            return
        req.t_end = time.perf_counter()
        if req.tpot_s is not None:
            stats.observe("serve/tpot_s", req.tpot_s)

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
