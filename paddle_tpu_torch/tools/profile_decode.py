"""Decode-engine throughput and device-time attribution probe (counterpart
of the JAX package's ``tools/profile_decode.py``).

    python -m paddle_tpu_torch.tools.profile_decode            # on CUDA
    PD_SECTIONS=prof,mega python -m paddle_tpu_torch.tools.profile_decode

Environment, as in the JAX tool:

- ``PD_SIZE``: ``1p3b`` (default, ``gpt3_1p3b`` at cache 2048),
  ``350m`` or ``tiny``; weights drawn from seed 0.
- ``PD_SECTIONS`` (default ``engine,paged``):
  - ``engine`` — the contiguous engine at 8 and 16 slots against the
    memory-bandwidth roofline, with the pipeline report (in-flight
    depth, host gap, dispatch and harvest time, overlap) from the trace
    ring; ``PD_INFLIGHT=1,2,...`` sweeps the depth;
  - ``paged`` — the paged engine (single-dispatch by default) the same
    way, with its prefix-cache counters; ``PD_PREFIX=1`` adds the
    repeated-system-prompt sweep (cold vs warm admission, asserted);
  - ``prof`` — device-time attribution per decode path (contiguous,
    paged) and prompt length (``PD_LENGTHS``, default 128,512,1024):
    tokens/s against the analytic roofline of the engine's
    ``dispatch_cost``, launches per token, the launch-tax fraction and
    the step split (``devprof.step_fractions``), after the launch tax of
    a PyTorch ``x + 1`` and of the hand-written probe K13;
  - ``mega`` — kernel launches per decode step of the single-dispatch
    and per-layer paged paths, from ``devprof.count_kernel_launches``
    and from the ``serve/dispatch_launches`` delta; on CUDA it asserts
    single-dispatch <= 2 and per-layer == n_layers.
- ``PD_SPEC=1`` adds the speculative rows: the engine section's spec
  run (the contiguous engine at ``speculative_k=4``, 16 steps a
  dispatch, on repetition-heavy prompts: 8-token loops, the regime the
  prompt-lookup drafts serve) and the mega section's ``mega_spec`` row
  (the single-dispatch paged engine at ``speculative_k=3``, on CUDA
  gated at <= 2 launches a verify step: one K8 and one K9).

It runs on CUDA; ``--device cpu`` (or ``PD_DEVICE=cpu``) runs the plain
versions on the CPU for the tests, where the wrappers count no launch
and the roofline needs ``PT_PROF_PEAK_FLOPS``/``PT_PROF_PEAK_HBM_GBPS``.

Where it differs from the JAX tool:

- ``prof``'s paged engine takes prefill buckets up to the prompt length
  (the JAX tool's paged engine keeps its default buckets, which cap
  prompts at 512 tokens and refuse its own 1024 default);
- ``prof`` divides the roofline by the tokens of one DECODE dispatch
  (decode tokens / ``serve/dispatches/decode``), because the port's
  ``dispatch_cost`` counts one whole decode dispatch (every
  ``steps_per_call`` step); the JAX tool divides by tokens over all
  dispatches, prefills included, and its capture counts one step;
- ``prof`` recalibrates both launch-tax meters at its start
  (``force=True``), so its rows use its own calibration.
"""

import argparse
import os
import time

import numpy as np
import torch

from paddle_tpu_torch import device as device_lib
from paddle_tpu_torch import stats
from paddle_tpu_torch.inference.decode_engine import (
    DecodeEngine, decode_roofline_tokens_per_sec)
from paddle_tpu_torch.inference.paged_engine import PagedDecodeEngine
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.observability import devprof, trace

__all__ = ["release_engine", "pipeline_report", "run_engine", "run_paged",
           "prefix_sweep", "prof_section", "mega_section", "build_model",
           "main"]

_PAGE = 128


def release_engine(eng):
    """Drop an engine's big device buffers (caches or pools, and its
    references to the weights) so the next engine built in this process
    does not hold the last one's memory."""
    for attr in ("kc", "vc", "kp", "vp", "_stacked", "_layers"):
        if hasattr(eng, attr):
            setattr(eng, attr, None)


def pipeline_report(eng):
    """In-flight depth, per-step host gap, and dispatch/harvest overlap of
    the run just finished, from the trace ring and the stats histograms.
    'overlap' is the share of decode harvests that blocked while a
    younger dispatch was already enqueued; 'host_gap' the host's bubble
    between consecutive dispatch enqueues."""
    snap = stats.snapshot("serve/")
    evs, _ = trace.events()
    spans = [e for e in evs if e is not None]
    disp = [e for e in spans if e[0] == "serve/dispatch"]
    harv = [e for e in spans if e[0] == "serve/harvest"]
    dec = [e for e in harv if (e[6] or {}).get("kind") != "prefill"]
    overlapped = sum(1 for e in dec
                     if (e[6] or {}).get("inflight", 0) >= 1)
    return {
        "depth": eng.depth,
        "host_gap_p50_ms": snap.get("serve/host_gap_s.p50", 0) * 1e3,
        "host_gap_p99_ms": snap.get("serve/host_gap_s.p99", 0) * 1e3,
        "dispatch_ms": sum(e[2] for e in disp) / 1e6,
        "harvest_ms": sum(e[2] for e in harv) / 1e6,
        "overlap": overlapped / max(1, len(dec)),
    }


def _start_window():
    stats.reset("serve/")
    trace.clear(capacity=65536)
    trace.enable()          # the in-memory ring only: no file unless asked


def _end_window():
    trace.disable()
    trace.clear()


def run_engine(model, slots=8, s_pf=128, n_new=128, chunk=64, spec_k=0,
               inflight=2):
    """The contiguous engine: warm on the prompts, then time a drain of
    ``slots`` fresh ``s_pf``-token prompts (with ``spec_k``, speculative
    on repetition-heavy prompts: 8-token loops). Returns (tokens/s,
    dispatches, pipeline report)."""
    cfg = model.cfg
    eng = DecodeEngine(model, max_slots=slots,
                       max_len=s_pf + n_new + (128 + spec_k if spec_k
                                               else 0),
                       steps_per_call=chunk, speculative_k=spec_k,
                       inflight=inflight, device=model.wte.device)
    rs = np.random.RandomState(1)
    if spec_k:
        loops = [list(rs.randint(0, cfg.vocab_size, 8))
                 for _ in range(slots)]
        prompts = [(lp * (s_pf // 8 + 1))[:s_pf] for lp in loops]
    else:
        prompts = [rs.randint(0, cfg.vocab_size, s_pf)
                   for _ in range(slots)]
    for p in prompts:
        eng.submit(p, max_new_tokens=2)
    eng.run()
    _start_window()
    reqs = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
    eng.step()
    pre = sum(len(r.tokens) for r in reqs)
    d0 = eng.steps
    t0 = time.perf_counter()
    eng.run()
    dt = time.perf_counter() - t0
    toks = sum(len(r.tokens) for r in reqs) - pre
    dispatches = eng.steps - d0
    rep = pipeline_report(eng)
    _end_window()
    release_engine(eng)
    return toks / dt, dispatches, rep


def _paged_engine(model, slots, need, chunk, inflight=2, n_pages=None,
                  donor=None, buckets=None):
    if n_pages is None:
        n_pages = slots * ((need + _PAGE - 1) // _PAGE + 1) + 4
    kw = {} if buckets is None else {"buckets": buckets}
    return PagedDecodeEngine(model, n_pages=n_pages, max_slots=slots,
                             page_size=_PAGE, steps_per_call=chunk,
                             inflight=inflight, share_weights_with=donor,
                             device=(donor.device if donor is not None
                                     else model.wte.device), **kw)


def run_paged(model, prompts, n_new=128, chunk=64, inflight=2):
    """The paged engine, one slot per prompt: warm on trie-disjoint
    prompts of the same lengths (so the timed round's prefix lookups
    miss), then time the drain of ``prompts``. Returns (tokens/s,
    dispatches, pipeline report, prefix counters)."""
    eng = _paged_engine(model, len(prompts),
                        max(len(p) for p in prompts) + n_new, chunk,
                        inflight)
    rs = np.random.RandomState(4242)
    vocab = eng.cfg.vocab_size
    for p in prompts:
        eng.submit(list(rs.randint(0, vocab, len(p))), max_new_tokens=2)
    eng.run()
    _start_window()
    reqs = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
    eng.step()
    pre = sum(len(r.tokens) for r in reqs)
    d0 = eng.steps
    t0 = time.perf_counter()
    eng.run()
    dt = time.perf_counter() - t0
    toks = sum(len(r.tokens) for r in reqs) - pre
    dispatches = eng.steps - d0
    rep = pipeline_report(eng)
    snap = stats.snapshot("serve/")
    n_prompt = sum(len(p) for p in prompts)
    pfx = {
        "hit_tokens": int(snap.get("serve/prefix_hit_tokens", 0)),
        "lookups": int(snap.get("serve/prefix_lookup", 0)),
        "hit_rate": snap.get("serve/prefix_hit_tokens", 0)
        / max(1, n_prompt),
        "pool_free": int(snap.get("serve/pool_pages_free", 0)),
        "pool_shared": int(snap.get("serve/pool_pages_shared", 0)),
    }
    _end_window()
    release_engine(eng)
    return toks / dt, dispatches, rep, pfx


def prefix_sweep(model, slots, shared_len, tail_len, n_new, chunk):
    """PD_PREFIX=1: round 1 submits ``slots`` prompts sharing one
    page-aligned ``shared_len``-token system prefix (cold: registers the
    chain); round 2 submits new tails behind the same prefix (warm: must
    prefill only the tails). Asserts the warm round hit."""
    cfg = model.cfg
    if shared_len % _PAGE:
        raise ValueError("the system prefix must be page-aligned")
    rs = np.random.RandomState(7)
    shared = list(rs.randint(0, cfg.vocab_size, shared_len))
    need = shared_len + tail_len + n_new
    n_pages = 2 * (shared_len // _PAGE) + slots * (
        (need + _PAGE - 1) // _PAGE + 1) + 4
    eng = _paged_engine(model, slots, need, chunk, n_pages=n_pages)
    # warm both admission shapes on a trie-disjoint prefix: the full
    # prefill (the cold round's), then the suffix prefill (the warm's)
    warm_pfx = list(rs.randint(0, cfg.vocab_size, shared_len))
    for _ in range(2):
        eng.submit(warm_pfx + list(rs.randint(0, cfg.vocab_size,
                                              tail_len)),
                   max_new_tokens=n_new)
        eng.run()

    def round_(label):
        stats.reset("serve/prefix")
        prompts = [shared + list(rs.randint(0, cfg.vocab_size, tail_len))
                   for _ in range(slots)]
        t0 = time.perf_counter()
        reqs = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
        eng.run()
        dt = time.perf_counter() - t0
        hits = int(stats.get("serve/prefix_hit_tokens", 0))
        toks = sum(len(r.tokens) for r in reqs)
        print(f"  {label}: {dt * 1e3:.1f}ms wall "
              f"({toks} new tokens, {slots}x({shared_len}+{tail_len}) "
              f"prompt) prefix_hit_tokens={hits}", flush=True)
        return hits

    print(f"prefix sweep: shared system prompt {shared_len} tokens, "
          f"{slots} slots", flush=True)
    cold = round_("cold")
    warm = round_("warm")
    if warm < slots * _PAGE or warm <= cold:
        raise AssertionError(
            f"warm shared-prefix round hit {warm} tokens (cold {cold}; "
            f"expected >= {slots * _PAGE}): the prefix cache regressed")
    release_engine(eng)


def _prof_run(eng, prompts, n_new):
    """One timed drain for the prof section: warm on trie-disjoint
    prompts of the same lengths, then measure over the timed window
    (stats and trace ring reset at its start): tokens, wall, dispatch
    launches, decode dispatches and the step split."""
    rs = np.random.RandomState(99)
    for p in prompts:
        eng.submit(list(rs.randint(0, eng.cfg.vocab_size, len(p))),
                   max_new_tokens=2)
    eng.run()
    _start_window()
    reqs = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
    t0 = time.perf_counter()
    eng.run()
    wall = time.perf_counter() - t0
    toks = sum(len(r.tokens) for r in reqs)
    launches = int(stats.get("serve/dispatch_launches", 0))
    decode = int(stats.get("serve/dispatches/decode", 0))
    frac = devprof.step_fractions()
    _end_window()
    return {"tokens": toks, "wall_s": wall, "launches": launches,
            "decode_dispatches": decode, "requests": len(reqs),
            "step": frac}


def _buckets_upto(n):
    """The paged engine's default prefill buckets, extended by powers of
    two up to one that holds ``n`` tokens."""
    out, b = [16, 32, 64, 128, 256, 512], 1024
    while out[-1] < n:
        out.append(b)
        b *= 2
    return tuple(out)


def prof_section(model, size, lengths=None):
    """Device-time attribution per decode path (contiguous, then paged
    single-dispatch, sharing one weight donor) across prompt lengths.
    Each row prints measured tokens/s against the roofline of the
    engine's ``dispatch_cost``, the roofline fraction, dispatch launches
    per token, the launch-tax fraction and the step split, and asserts
    what the JAX tool asserts. Returns the rows as dicts."""
    cfg = model.cfg
    tiny = size == "tiny"
    if lengths is None:
        default = "32,64,128" if tiny else "128,512,1024"
        lengths = [int(x) for x in os.environ.get(
            "PD_LENGTHS", default).split(",") if x.strip()]
    slots, n_new = (4, 16) if tiny else (8, 64)
    chunk = 4 if tiny else 32
    dev = model.wte.device
    tax = devprof.launch_tax_s(force=True, device=dev)
    ptax = devprof.pallas_launch_tax_s(force=True)
    line = f"launch tax: torch x+1 {tax * 1e6:.1f}us/dispatch"
    if ptax is not None:
        line += (f", K13 probe {ptax * 1e6:.1f}us/launch (x{cfg.n_layers} "
                 f"K2 launches per step on the per-layer paged path)")
    print(line, flush=True)
    rs = np.random.RandomState(13)
    donor = None
    rows = []
    for path in ("contiguous", "paged"):
        for s_pf in lengths:
            if path == "contiguous":
                eng = DecodeEngine(
                    model if donor is None else None, max_slots=slots,
                    max_len=s_pf + n_new, steps_per_call=chunk,
                    share_weights_with=donor, device=dev)
                if donor is None:
                    donor = eng
            else:
                eng = _paged_engine(None, slots, s_pf + n_new, chunk,
                                    donor=donor,
                                    buckets=_buckets_upto(s_pf))
            prompts = [list(rs.randint(0, cfg.vocab_size, s_pf))
                       for _ in range(slots)]
            run = _prof_run(eng, prompts, n_new)
            toks, wall, launches = (run["tokens"], run["wall_s"],
                                    run["launches"])
            name = f"{path}_{s_pf}"
            cap = eng.dispatch_cost(name=name)
            per_dispatch = ((toks - run["requests"])
                            / max(1, run["decode_dispatches"]))
            aroof = devprof.roofline_tokens_per_sec(cap, per_dispatch)
            rfrac = devprof.record_roofline(name, toks / wall, aroof)
            lt = devprof.launch_tax_fraction(launches, wall, tax_s=tax,
                                             name=name)
            print(f"prof {path} len={s_pf}: {toks / wall:.1f} tok/s "
                  f"vs roofline {aroof:.1f} (frac {rfrac:.3f}) "
                  f"launches/token={launches / max(1, toks):.3f} "
                  f"launch_tax_frac={lt:.3f} "
                  f"flops/dispatch={cap.flops:.3g} "
                  f"hbm_bytes/dispatch={cap.hbm_bytes:.3g}",
                  flush=True)
            frac = run["step"]
            if frac:
                print(f"  step split: device={frac['device_frac']:.0%} "
                      f"queue={frac['queue_frac']:.0%} "
                      f"host={frac['host_frac']:.0%}"
                      + ("  [HOST-BOUND]" if frac["host_bound"]
                         else ""), flush=True)
            if not (cap.flops > 0 and cap.hbm_bytes > 0):
                raise AssertionError(f"{name}: dispatch_cost counted no "
                                     f"flops or bytes")
            if not 0 < lt <= 1.0:
                raise AssertionError(f"{name}: launch_tax_frac {lt}")
            if not (launches > 0 and toks > 0):
                raise AssertionError(f"{name}: no launches or tokens")
            rows.append({"path": path, "length": s_pf, "slots": slots,
                         "new_tokens": n_new, "steps_per_call": chunk,
                         "tokens": toks, "wall_s": wall,
                         "tokens_per_s": toks / wall,
                         "roofline_tps": aroof, "roofline_frac": rfrac,
                         "tokens_per_decode_dispatch": per_dispatch,
                         "dispatch_launches": launches,
                         "launches_per_token": launches / max(1, toks),
                         "launch_tax_frac": lt, "flops": cap.flops,
                         "hbm_bytes": cap.hbm_bytes, "step": frac})
            if eng is not donor:
                release_engine(eng)
            del eng
    release_engine(donor)
    return rows


def mega_section(model, size):
    """Kernel launches per decode step of the paged paths: the
    single-dispatch default and the per-layer path (and with
    ``PD_SPEC=1`` the single-dispatch speculative verify,
    ``speculative_k=3``), from ``devprof.count_kernel_launches`` over
    one dispatch (run on an engine with no live slot) and the
    ``serve/dispatch_launches`` delta over a short drain. On CUDA it
    asserts the single-dispatch step and verify take <= 2 launches (K8
    + K9) and the per-layer step one K2 per layer; on the CPU the
    wrappers count no launch, so it prints only. Returns label ->
    launches per step."""
    cfg = model.cfg
    dev = model.wte.device
    if cfg.n_layers < 3:
        # at L = 2 the single dispatch's 2 launches and one per layer
        # coincide; 3 layers tell them apart
        cfg = gpt.GPTConfig(vocab_size=cfg.vocab_size, max_seq_len=256,
                            d_model=cfg.d_model, n_layers=3,
                            n_heads=cfg.n_heads, dtype=cfg.dtype)
        model = gpt.GPT(cfg, seed=0, device=dev)
        print("mega section: rebuilt at n_layers=3 (launch counts at "
              "L=2 cannot tell the paths apart)", flush=True)
    tiny = size == "tiny" or cfg.d_model <= 64
    slots, s_pf, n_new = (2, 16, 8) if tiny else (8, 128, 64)
    chunk = 2 if tiny else 16
    n_pages = slots * ((s_pf + n_new + 4) // _PAGE + 2) + 2
    rs = np.random.RandomState(5)
    rows = [("mega", dict(mega=True)), ("per_layer", dict(mega=False))]
    if os.environ.get("PD_SPEC", "0") == "1":
        rows.append(("mega_spec", dict(mega=True, speculative_k=3)))
    counts = {}
    for label, kw in rows:
        eng = PagedDecodeEngine(model, n_pages=n_pages, max_slots=slots,
                                page_size=_PAGE, steps_per_call=chunk,
                                device=dev, **kw)
        prompts = [list(rs.randint(0, cfg.vocab_size, s_pf))
                   for _ in range(slots)]
        for p in prompts:   # warm, and establish the live geometry
            eng.submit(p, max_new_tokens=2)
        eng.run()
        fn, fargs = eng.dispatch_fn_args()
        lpc = devprof.count_kernel_launches(fn, *fargs)
        per_step = lpc / chunk
        d0 = int(stats.get("serve/dispatch_launches", 0))
        reqs = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
        eng.run()
        host_disp = int(stats.get("serve/dispatch_launches", 0)) - d0
        toks = sum(len(r.tokens) for r in reqs)
        counts[label] = per_step
        print(f"mega {label}: launches/step={per_step:g} "
              f"({lpc} kernel launches per {chunk}-step dispatch) "
              f"dispatch_launches_delta={host_disp} ({toks} tokens)",
              flush=True)
        if not (host_disp > 0 and toks > 0):
            raise AssertionError(f"mega {label}: nothing dispatched")
        release_engine(eng)
        del eng
    if dev.type != "cuda":
        print("mega gate: skipped on the CPU (the kernel wrappers count "
              "CUDA launches only)", flush=True)
        return counts
    if not (counts["mega"] <= 2 and counts.get("mega_spec", 0) <= 2
            and counts["per_layer"] == cfg.n_layers):
        raise AssertionError(f"launches per step {counts}, n_layers "
                             f"{cfg.n_layers}")
    spec = (f"spec {counts['mega_spec']:g} <= 2, " if "mega_spec" in counts
            else "")
    print(f"mega gate: single-dispatch {counts['mega']:g} <= 2, {spec}"
          f"per-layer {counts['per_layer']:g} == n_layers={cfg.n_layers}",
          flush=True)
    return counts


def build_model(size, device):
    """The ``PD_SIZE`` model, weights from seed 0."""
    cfg = (gpt.gpt3_1p3b(max_seq_len=2048) if size == "1p3b"
           else gpt.gpt_tiny(max_seq_len=512) if size == "tiny"
           else gpt.gpt3_350m(max_seq_len=1024))
    return gpt.GPT(cfg, seed=0, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=os.environ.get("PD_DEVICE"),
                    help="cuda (default) or cpu (the tests)")
    args = ap.parse_args(argv)
    dev = device_lib.resolve(args.device)
    size = os.environ.get("PD_SIZE", "1p3b")
    print("building model", size, flush=True)
    model = build_model(size, dev)
    cfg = model.cfg
    print("device:", torch.cuda.get_device_name(dev)
          if dev.type == "cuda" else dev, flush=True)

    def show(label, tps, disp, roof, rep):
        print(f"{label}: {tps:.1f} tok/s ({disp} dispatches) "
              f"roofline={roof:.0f} ratio={tps / roof:.3f}", flush=True)
        print(f"  pipeline: depth={rep['depth']} "
              f"host_gap p50={rep['host_gap_p50_ms']:.2f}ms "
              f"p99={rep['host_gap_p99_ms']:.2f}ms "
              f"dispatch={rep['dispatch_ms']:.1f}ms "
              f"harvest={rep['harvest_ms']:.1f}ms "
              f"overlap={rep['overlap']:.0%}", flush=True)

    sweep = [int(x) for x in os.environ.get("PD_INFLIGHT", "").split(",")
             if x.strip()] or [2]
    sections = {s.strip() for s in os.environ.get(
        "PD_SECTIONS", "engine,paged").split(",") if s.strip()}
    spec = os.environ.get("PD_SPEC", "0") == "1"
    hbm = (devprof.peak_specs(dev)[1] / 1e9
           if sections & {"engine", "paged"} else None)

    if "engine" in sections:
        for slots, s_pf, n_new in ((8, 128, 128), (16, 128, 128)):
            roof = decode_roofline_tokens_per_sec(
                cfg, slots, s_pf + n_new // 2, hbm)
            for depth in sweep:
                tps, disp, rep = run_engine(model, slots=slots,
                                            s_pf=s_pf, n_new=n_new,
                                            inflight=depth)
                show(f"slots={slots} ctx={s_pf}+{n_new}", tps, disp,
                     roof, rep)
        if spec:
            roof = decode_roofline_tokens_per_sec(cfg, 8, 192, hbm)
            for depth in sweep:
                tps, disp, rep = run_engine(model, chunk=16, spec_k=4,
                                            inflight=depth)
                show("spec k=4 chunk=16", tps, disp, roof, rep)

    if "paged" in sections:
        tiny = size == "tiny"
        slots, s_pf, n_new = (4, 128, 16) if tiny else (8, 128, 128)
        chunk = 8 if tiny else 64
        roof = decode_roofline_tokens_per_sec(
            cfg, slots, s_pf + n_new // 2, hbm)
        rs = np.random.RandomState(11)
        for depth in sweep:
            prompts = [list(rs.randint(0, cfg.vocab_size, s_pf))
                       for _ in range(slots)]
            tps, disp, rep, pfx = run_paged(model, prompts, n_new=n_new,
                                            chunk=chunk, inflight=depth)
            show(f"paged slots={slots} ctx={s_pf}+{n_new}", tps, disp,
                 roof, rep)
            print(f"  prefix: hit_rate={pfx['hit_rate']:.0%} "
                  f"hit_tokens={pfx['hit_tokens']} "
                  f"lookups={pfx['lookups']} "
                  f"pool free={pfx['pool_free']} "
                  f"shared={pfx['pool_shared']}", flush=True)
        if os.environ.get("PD_PREFIX", "0") == "1":
            prefix_sweep(model, slots=slots,
                         shared_len=256 if not tiny else 128,
                         tail_len=32, n_new=8 if tiny else 32,
                         chunk=chunk)

    if "prof" in sections:
        prof_section(model, size)

    if "mega" in sections:
        mega_section(model, size)


if __name__ == "__main__":
    main()
