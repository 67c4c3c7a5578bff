#!/usr/bin/env python3
"""GPU smoke of the PyTorch/CUDA port (``paddle_tpu_torch``).

    python3 chip_smoke.py          # one CUDA GPU; exits non-zero without

Phases, each fatal on failure:

1. device — the card's name and power limit (nvidia-smi); TF32 off;
2. build — every kernel of ``paddle_tpu_torch/csrc`` compiled with nvcc;
3. kernels — each hand-written kernel against its plain PyTorch version
   on the card, in bf16, at the shapes of the path that runs it: K1
   flash forward, K2 fused paged append+attend and K2' plain paged
   attention at the serving shapes; K1, K3 (dK/dV) and K4 (dQ) at the
   train shape (B 4, S 2048, 16 heads of 128, causal; and 4 kv heads);
   K5 (CE forward), K6 (dx) and K7 (dw) at N 8188 rows (4 x 2047), d
   2048, V 50304 with ignored labels, with the init head's near-uniform
   softmax and with a peaked one. Each output is held by its relative
   L2 error per tile or row that one block writes (``REL_L2_TOL``), so
   small entries count as much as the largest. Each prints its time
   (K1, K2, K2': the kernel's profiler device time, and its call's by
   CUDA events; the others by CUDA events), its plain version's time,
   the library call's time
   where PyTorch has one call for the same function, and its bound: the
   larger of bytes / 3.35 TB/s and FLOPs / 989.4 TFLOP/s;
4. serving — gpt3_1p3b at full width (random weights from a seed)
   through ``make_engine(mega=False)`` (the per-layer decode): 8 prompts
   of 128 tokens plus one that shares
   the first's 128-token prefix (suffix prefill), 64 new tokens each.
   The kernels' launch counters, zeroed just before, must show K1 = L x
   cold prefills, K2 = L x decode steps, K2' > 0. Every emitted token is
   checked against a teacher-forced plain forward of the port's GPT;
   then a second batch under torch.profiler;
5. train — gpt3_1p3b at full width from seed 0, bf16-moment AdamW (lr
   1e-4, wd 0.01), a fixed 4 x 2048 batch. Step 1 runs twice from the
   same weights, through the plain versions and through the kernels:
   losses within 1e-3 relative, every parameter's gradient within 2.5e-2
   relative L2. Then 5 more kernel steps: the loss must fall; step time,
   tokens/s, MFU, peak memory, launches per step (K1, K3, K4 = L; K5,
   K6, K7 = 1, counted from zero over the kernel steps) and a
   torch.profiler breakdown of one step;
6. K10 and K12 kernels, at the contiguous engine's shapes: K10
   flash-decode (B 8, 16 query heads over 16 and 4 kv heads of 128, T
   2048, lengths 0..2047 including an empty row), with and without
   (m, l); K12 int8 matmul, the four gpt3_1p3b block products at M 8
   (decode) and M 128 (a prefill bucket). Checks: ``decode_attention_
   check`` and ``quant_matmul_check``;
7. contiguous serving — the same gpt3_1p3b through
   ``make_engine(engine="contiguous")`` (cache 2048, so decode takes
   K10): 8 prompts of 128 tokens and one of 1,200 (chunked prefill over
   buckets of 512), 64 new tokens each; launches K10 = L x decode steps,
   K12 = K1 = 0; the teacher-forced check;
8. int8 serving — ``DecodeEngine(None, share_weights_with=<7's engine>,
   weight_dtype="int8")`` on the same prompts; launches K12 = 4 L per
   decode step and per prefill chunk, K10 as in 7; tokens checked
   against a teacher-forced forward of the same int8 weights with K12
   replaced by its plain version; the share of tokens equal to 7's;
9. decode device time — per decode step of each engine (contiguous
   bf16 and int8, paged single-dispatch and per-layer), from a
   torch.profiler window of decode dispatches: device ms and kernel
   launches per decode step, beside the weight-read floor;
10. generate — ``GPT.generate``, greedy, 4 prompts of 128 tokens, 32 new
   tokens, cache 2048: K10 = L x 31 launches; the teacher-forced check.

11. K8 and K9, at the single-dispatch engine's shapes (B 8 rows, 7
   slots of two 128-token pages, positions 0..255, an inactive row, two
   rows of one slot): K8 on one gpt3_1p3b layer (weights at
   1/sqrt(fan_in)) and on two llama_style_1b-shaped layers (4 kv heads,
   rope, no biases), x_out per row and the written pool rows within
   REL_L2_TOL, every other pool row bit-identical
   (``mega_layers_check``); on the model's 24 layers, x_out within
   THROUGH_DEPTH_TOL; K9 on the 24-layer output and the tied head (V
   50,304) with a planted tie, an overflowing row and a poisoned row
   (``mega_logits_check``). Device times of K8, its plain version and
   the per-layer path at the same shapes, and of K9;
12. single-dispatch serving — the same model and prompts as 4 through
   ``make_engine(model)``, whose default runs one K8 and one K9 launch
   per decode step: K8 = K9 = decode steps, K2 = 0, K1 = L x cold
   prefills, K2' > 0; the teacher-forced check; a second batch under
   torch.profiler.

13. K11, at the incubate encoder's rows (M 16 x 512), bf16, with bias,
   residual and dropout 0.1, at N 768, 1024 and 1000: y and pre per row
   within REL_L2_TOL, mean and rstd within LN_STATS_TOL, the mask (read
   through an all-ones input) equal to the plain hash bit for bit
   (``layer_norm_check``); device times of K11, its plain version and
   F.layer_norm on the precomputed sum;
14. K1, K3 and K4 with an additive bias and hash dropout 0.1 at the
   encoder's shape (B 16, S 512, 12 heads of 64): the padding bias (B,
   1, 1, S) of lengths 128..512 alone, as the encoder passes it; the
   same with kv_lens; a full (B, H, Sq, Sk) bias; and Sk 600 (the
   mask's row stride 1024): output and gradients per tile
   within REL_L2_TOL, no gradient reaching the bias
   (``attention_bias_dropout_check``), the mask read through one-hot V
   (``dropout_pattern``) equal to the plain hash (``mask_check``);
   device times of the kernels, the plain versions and sdpa with the
   same float mask and dropout;
15. encoder — the slice: a BERT-base-width post-LN encoder (12 blocks,
   d 768, 12 heads, ffn 3072, GELU; weights from seed 0 in bf16) of
   ``fused_multi_head_attention`` (padding mask, dropout and attention
   dropout 0.1) and ``fused_feedforward`` (dropout 0.1), a fixed (16,
   512, 768) input with lengths 128..512 (one full row), a masked mean
   square loss against a fixed target, the port's AdamW (lr 1e-3). Step
   1 runs twice from the same weights and generator states, through the
   plain versions (``plain_kernels``, no launch) and through the
   kernels: losses within 1e-3 relative, every gradient within 2.5e-2
   relative L2 (``encoder_step_check``). Then 5 more kernel steps: the
   loss falls; launches per step K1 = K3 = K4 = K11 = 12, every other
   kernel 0; step time, tokens/s, MFU, peak memory and a torch.profiler
   breakdown of one step;
16. the incubate layers, fp32 at d 768: ``FusedBiasDropoutResidual
   LayerNorm`` in eval equals F.layer_norm of residual + x + bias;
   ``FusedMultiTransformer`` (two pre-LN layers) decoding 4 tokens
   through its caches after a 128-token prompt matches its full causal
   forward (``cached_decode_check``); K11 = 1 and K1 = 12 launches.

17. K13, the launch probe (``ops/launch_probe.py``): one (8, 128) fp32
   copy, equal to its input bit for bit, its counter equal to the
   launches made; its device time and bound, and the launch tax
   ``devprof.pallas_launch_tax_s`` meters with it beside
   ``launch_tax_s``'s x + 1 and the same readback round around
   ``clone`` (median microseconds each);
18. the sixth slice, the serving engines' own instrumentation, on
   gpt3_1p3b from seed 0 with every kernel counter zeroed just before
   and read just after: ``paddle_tpu_torch.tools.profile_decode``'s
   ``prof`` section (contiguous and single-dispatch paged, prompts of
   128, 512 and 1024 tokens, 8 slots, 64 new tokens, chunk 32; each
   row's roofline fraction within (0, ROOFLINE_FRAC_MAX], its launch-tax
   fraction within (0, 1], a step split) and ``mega`` section
   (single-dispatch <= 2 launches per decode step, per layer 24),
   called in this process; a fault run (``faults.inject`` poisons slot
   3 for one dispatch: only that request is evicted, the others keep
   the clean batch's streams, its flight dump runs from ``admit`` to
   ``evicted``); a warmup check (TTFT of the first request cold and
   after ``warmup()``, no kernel library loaded inside either window);
   the tracing cost per decode step (off, on, on, off) and the trace
   file written under ``PT_TRACE_DIR`` (``build/traces/``) and parsed
   back for ``serve/dispatch`` and ``serve/harvest`` spans. The path
   must launch K1, K2, K2', K8, K9, K10 and K13.

Phases 11, 4, 12 and 6-10 run before 5 (which needs the card's memory
for training), 13, 14 and 17 before them, 15, 16 and 18 after 5. Should
the script near its time limit, phase 18's sweep may drop to prompts of
128 and 1024 tokens, at full width.

Then one ``{"kernels": [...]}`` line, the card line, and the last line
``{"ok": true, "device": {...}}``. Imports neither jax nor paddle_tpu.
"""

import contextlib
import itertools
import json
import math
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
H100_L2_BYTES = 50e6
# dense bf16 tensor-core peak (the JAX bench's MFU denominator too)
H100_BF16_FLOPS = 989.4e12
# the CUDA cores' fp32 peak (outside the tensor cores); the data sheet
# gives no int32 rate, so the dropout hash's integer operations (about
# HASH_OPS per cell: two lowbias32 mixes, the index and the compare)
# are counted at it
H100_CUDA_CORE_OPS = 67e12
HASH_OPS = 20
# a bf16 output rounds each entry by at most 2^-8 of itself (about 2^-9
# root mean square): the kernels' outputs are held within 2^-7 relative
# L2 of their plain versions, per tile or row that one block writes
REL_L2_TOL = 2.0 ** -7
# K10's (m, l) against the plain softmax's: fp32 sums in another order
STATS_REL_TOL = 1e-3
# an emitted token's logit within this of its row's maximum under a
# teacher-forced plain forward: four bf16 ulps at |logit| in [4, 8)
TEACHER_FORCED_TOL = 0.125
SEED = 0


def _fail(msg):
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def _event_ms(torch, fn, iters=20, warmup=3):
    """Mean milliseconds per call of ``fn`` between CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def _device_ms(torch, fn, keys=None, iters=20, warmup=3):
    """Mean device milliseconds per call of ``fn`` spent in CUDA kernels
    (those whose name holds one of ``keys``, or all), summed from a
    torch.profiler trace: the kernels' own time, without the host's
    gaps between launches, which CUDA events around back-to-back calls
    also count when a call's Python is slower than its kernels. A window
    in which the profiler recorded none of the kernels is profiled again
    (up to three windows); None when none recorded them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.time_range.end - e.time_range.start
                    for e in prof.events()
                    if e.device_type == DeviceType.CUDA
                    and (keys is None or any(k in e.name for k in keys)))
        if total:
            return total / 1e3 / iters
    return None


def _cold(operands, nbytes):
    """A function returning, call after call, one of enough copies of
    ``operands`` (a tuple of tensors) that ``nbytes`` read from each
    copy add up to twice the 50 MB L2: a timed loop then finds every
    operand cold, as the serving path finds each layer's own weights
    and cache. The first copy is ``operands`` itself."""
    n = max(1, math.ceil(2 * H100_L2_BYTES / nbytes))
    copies = [operands] + [tuple(t.clone() for t in operands)
                           for _ in range(n - 1)]
    return itertools.cycle(copies).__next__


def _bound(nbytes, flops, cuda_ops=0):
    """The least time for the work: the larger of bytes / 3.35 TB/s and
    the operations' time, tensor-core FLOPs / 989.4 TFLOP/s or CUDA-core
    operations / 67 TOP/s, whichever is longer (the pipes run at once,
    so the slowest bounds it)."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = max(flops / H100_BF16_FLOPS,
                cuda_ops / H100_CUDA_CORE_OPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _phase(record):
    print(json.dumps(record), flush=True)
    if not record["ok"]:
        _fail(f"phase {record['phase']}: {record}")


def rel_l2(got, ref, dims):
    """||got - ref|| / ||ref|| in fp32 over ``dims``: one value for each
    index of the other dims. Where ref is all zeros, got must be too."""
    ref = ref.float()
    err = (got.float() - ref).norm(dim=dims)
    return err / ref.norm(dim=dims).clamp_min(1e-30)


def tile_rel_l2(got, ref, rows=64):
    """Relative L2 error of a (B, S, H, D) output per (b, 64-row tile,
    h), the output one K1/K3/K4 block writes; returns the worst tile's
    and the whole tensor's. A ragged last tile counts its rows only
    (both sides padded with zero rows)."""
    B, S, H, D = ref.shape
    whole = rel_l2(got.reshape(1, -1), ref.reshape(1, -1), (1,)).item()
    if S % rows:
        padded = []
        for x in (got, ref):
            z = x.new_zeros((B, S + (-S % rows), H, D))
            z[:, :S] = x
            padded.append(z)
        got, ref = padded
    t = (-1, rows, H, D)
    worst = rel_l2(got.reshape(t), ref.reshape(t), (1, 3)).max().item()
    return worst, whole


def attention_grads_check(got, ref):
    """K3/K4's outputs (dq, dk, dv) against the plain backward's, each
    per 64-row tile within REL_L2_TOL."""
    errs = {n: tile_rel_l2(g, r) for n, g, r in zip(("dq", "dk", "dv"),
                                                   got, ref)}
    ok = all(worst <= REL_L2_TOL for worst, _ in errs.values())
    return {"tile_rel_l2_max": {n: e[0] for n, e in errs.items()},
            "rel_l2": {n: e[1] for n, e in errs.items()}, "ok": bool(ok)}


def ce_grads_check(dx, dw, ref_dx, ref_dw, labels):
    """K6's dx and K7's dw against the plain backward's, per row within
    REL_L2_TOL: every row of dx (an ignored row must be exactly zero)
    and of dw. The vocab rows no label picks hold only the softmax
    term, which the label rows dwarf: their worst row is reported on
    its own."""
    V = ref_dw.shape[0]
    dx_rows = rel_l2(dx, ref_dx, (1,))
    dw_rows = rel_l2(dw, ref_dw, (1,))
    picked = labels[labels >= 0].long().bincount(minlength=V) > 0
    rec = {"dx_row_rel_l2_max": dx_rows.max().item(),
           "dw_row_rel_l2_max": dw_rows.max().item(),
           "dw_unlabeled_row_rel_l2_max": dw_rows[~picked].max().item(),
           "dx_rel_l2": rel_l2(dx.reshape(1, -1), ref_dx.reshape(1, -1),
                               (1,)).item(),
           "dw_rel_l2": rel_l2(dw.reshape(1, -1), ref_dw.reshape(1, -1),
                               (1,)).item()}
    rec["ok"] = bool(rec["dx_row_rel_l2_max"] <= REL_L2_TOL
                     and rec["dw_row_rel_l2_max"] <= REL_L2_TOL)
    return rec


def decode_attention_check(o, m, l, ref_o, ref_m, ref_l, lengths):
    """K10's (o, m, l) against the plain version's on a (B, Hq, D)
    output: o per (row, head) within REL_L2_TOL where the row sees a
    key; an empty row exactly o = 0, m = -inf, l = 0; m and l within
    STATS_REL_TOL (of max(1, |ref|) for m, which crosses zero). ``m``
    and ``l`` may be None (the call without stats)."""
    live = lengths > 0
    rows = rel_l2(o, ref_o, (2,))
    rec = {"row_rel_l2_max": rows[live].max().item(),
           "finite": bool(o.float().isfinite().all().item()),
           "empty_o_zero": bool((o[~live] == 0).all().item())}
    ok = (rec["row_rel_l2_max"] <= REL_L2_TOL and rec["finite"]
          and rec["empty_o_zero"])
    if m is not None:
        rm, rl = ref_m[live], ref_l[live]
        rec["m_rel_err_max"] = ((m[live] - rm).abs()
                                / rm.abs().clamp_min(1.0)).max().item()
        rec["l_rel_err_max"] = ((l[live] - rl).abs()
                                / rl.abs()).max().item()
        rec["empty_stats_exact"] = bool(
            (m[~live] == float("-inf")).all().item()
            and (l[~live] == 0).all().item())
        ok = (ok and rec["m_rel_err_max"] <= STATS_REL_TOL
              and rec["l_rel_err_max"] <= STATS_REL_TOL
              and rec["empty_stats_exact"])
    rec["ok"] = bool(ok)
    return rec


def quant_matmul_check(out, ref):
    """K12's (M, N) output against the plain version's, per row within
    REL_L2_TOL."""
    rows = rel_l2(out, ref, (1,))
    rec = {"row_rel_l2_max": rows.max().item(),
           "finite": bool(out.float().isfinite().all().item())}
    rec["ok"] = bool(rec["row_rel_l2_max"] <= REL_L2_TOL
                     and rec["finite"])
    return rec


# K8's rows at the single-dispatch engine's shapes, (slot, position,
# write): positions 0..255 over 8 rows, an inactive row (slot 5), and
# two rows of slot 6 at consecutive positions, so the second attends
# over the first's fresh row
K8_ROWS = ((0, 0, 1), (1, 37, 1), (2, 127, 1), (3, 128, 1), (4, 200, 1),
           (5, 255, 0), (6, 1, 1), (6, 2, 1))
K8_PAGES = 2                       # pages of 128 per slot: 256 tokens
# x_out through 24 layers: bf16 roundings at other places compound over
# depth (the train phase's gradient tolerance, for the same reason)
THROUGH_DEPTH_TOL = 2.5e-2


def mega_inputs(torch, dev, gen, dm, hq, hkv, d, n_layers, bias=True,
                rope=False, dtype=None, weights=None, rows=K8_ROWS,
                page=128):
    """K8's operands: ``weights`` (the (L, ...) slabs by name), or slabs
    drawn at std 1/sqrt(fan_in), so every product moves the residual by
    about as much as it holds and an attention or write fault shows in
    x_out; LayerNorm vectors fp32 near 1 and 0; x and pools from randn;
    slot s maps pages [K8_PAGES s, K8_PAGES (s + 1)). Also returns
    ``written``, the (L*P + 1, page) mask of the pool rows the active
    rows write, and the geometry kwargs."""
    dtype = dtype or torch.bfloat16
    L = n_layers
    if weights is None:
        f, nq = 4 * dm, (hq + 2 * hkv) * d
        shapes = {"ln1_scale": (L, dm), "ln1_bias": (L, dm),
                  "wqkv": (L, dm, nq), "bqkv": (L, nq),
                  "wo": (L, hq * d, dm), "bo": (L, dm),
                  "ln2_scale": (L, dm), "ln2_bias": (L, dm),
                  "wup": (L, dm, f), "bup": (L, f), "wdown": (L, f, dm),
                  "bdown": (L, dm)}
        weights = {}
        for n, shape in shapes.items():
            if n.startswith("b") and not bias:
                continue
            z = torch.randn(shape, generator=gen, device=dev)
            if n.startswith("ln"):
                weights[n] = (1.0 if n.endswith("scale") else 0.0) + 0.1 * z
            elif n.startswith("w"):
                weights[n] = (z / shape[1] ** 0.5).to(dtype)
            else:
                weights[n] = (0.1 * z).to(dtype)
    slots = max(s for s, _, _ in rows) + 1
    P = slots * K8_PAGES
    shape = (L * P + 1, hkv, page, d)
    kp = torch.randn(shape, generator=gen, device=dev).to(dtype)
    vp = torch.randn(shape, generator=gen, device=dev).to(dtype)
    table = torch.arange(P, dtype=torch.int32, device=dev).reshape(
        slots, K8_PAGES)
    i32 = dict(dtype=torch.int32, device=dev)
    slot, pos, write = (torch.tensor(c, **i32) for c in zip(*rows))
    written = torch.zeros((L * P + 1, page), dtype=torch.bool, device=dev)
    for layer in range(L):
        for s, p, wr in rows:
            if wr:
                written[layer * P + K8_PAGES * s + p // page,
                        p % page] = True
    x = torch.randn((len(rows), dm), generator=gen, device=dev).to(dtype)
    geo = dict(page=page, n_pages=P, n_heads=hq, kv_heads=hkv,
               head_dim=d, rope=rope)
    return dict(x=x, w=weights, kp=kp, vp=vp, table=table, pos=pos,
                slot=slot, write=write, written=written, geo=geo)


def mega_layers_check(x_out, ref_x, pools, ref_pools, pools0, written,
                      tol):
    """K8 against its plain version on the same inputs: x_out per row
    and each fresh K/V row written (per pool row, offset and head, at
    ``written``) within ``tol`` relative L2 (REL_L2_TOL at one layer;
    THROUGH_DEPTH_TOL through depth, where deep layers' rows carry the
    compounded error); every other pool row bit-identical to
    ``pools0``, the scratch page (the pools' last row) excepted."""
    rec = {"row_rel_l2_max": rel_l2(x_out, ref_x, (1,)).max().item(),
           "finite": bool(x_out.float().isfinite().all().item())}
    keep = ~written
    keep[-1] = False
    errs, same = [], True
    for got, ref, before in zip(pools, ref_pools, pools0):
        got, ref, before = (t.transpose(1, 2) for t in (got, ref, before))
        errs.append(rel_l2(got[written], ref[written], (2,)).max().item())
        same = same and got[keep].equal(before[keep])
    rec.update({"written_row_rel_l2_max": max(errs),
                "untouched_bit_identical": same})
    rec["ok"] = bool(rec["finite"] and rec["row_rel_l2_max"] <= tol
                     and rec["written_row_rel_l2_max"] <= tol
                     and same)
    return rec


def mega_logits_inputs(torch, x, head_w, lnf_scale, lnf_bias,
                       tie_rows=(0, 1), overflow_row=4, poison_row=2):
    """K9's planted cases on copies of x and of the head ``head_w``
    (V, dm), the tied ``wte``: row 0's maximum at two equal columns in
    different 32-column strips, row 1's at two neighbours in one strip;
    depth 7 of x zeroed but for a large value in ``overflow_row`` and a
    small positive one in the tie rows, and one column (V - 5) that
    reads only depth 7, at -1e38, so that ``overflow_row``'s logit alone
    overflows to inf, in one strip (the tie rows' is near -2e38);
    ``poison_row`` poisoned. Returns (x, w, poison, ties {row: the
    lowest tied column})."""
    from paddle_tpu_torch.models.gpt import final_ln
    x = x.clone()
    w = head_w.clone()
    V = w.shape[0]
    k0, col = 7, V - 5
    x[:, k0] = 0
    x[overflow_row, k0] = -40
    std = x.float().std(dim=1)
    for r in tie_rows:
        x[r, k0] = 2 * std[r]
    w[col] = 0
    w[col, k0] = -1e38
    h = final_ln(x, lnf_scale, lnf_bias).float()
    ties = {}
    for r, cols in zip(tie_rows, ((1000, V // 2 + 17), (2000, 2001))):
        ties[r] = cols[0]
        for c in cols:
            w[c] = (3 * h[r] / h[r].norm()).to(w.dtype)
            w[c, k0] = 0
    poison = torch.zeros((x.shape[0],), dtype=torch.int32, device=x.device)
    poison[poison_row] = 1
    return x, w, poison, ties


def mega_logits_check(tok, nonfin, ref_logits, ref_nonfin, ties):
    """K9 against its plain version: non-finite flags exact; tokens
    equal to the plain argmax where the row is not flagged and its top
    two logits differ by more than two bf16 ulps of the maximum (closer
    ones may swap under another summation order), and on every row not
    flagged, the picked token's plain logit within two such ulps of the
    row's maximum; at each planted tie ({row: the lowest of the equal
    columns}), exactly that column."""
    lg = ref_logits.float()
    fin = lg.masked_fill(~lg.isfinite(), -3e38)
    top2 = fin.topk(2, dim=1).values
    ulp = (top2[:, 0].abs().clamp_min(1e-30).log2().floor() - 7).exp2()
    clear = (top2[:, 0] - top2[:, 1] > 2 * ulp) & (ref_nonfin == 0)
    ref_tok = fin.argmax(dim=1).to(tok.dtype)
    rec = {"flags_exact": nonfin.equal(ref_nonfin),
           "flags": nonfin.tolist(),
           "rows_compared": int(clear.sum().item()),
           "tokens_equal": bool((tok[clear] == ref_tok[clear]).all().item()),
           "ties_lowest": all(int(tok[r]) == c and int(nonfin[r]) == 0
                              for r, c in ties.items())}
    live = ref_nonfin == 0
    picked = fin.gather(1, tok.long()[:, None])[:, 0]
    gap = top2[:, 0] - picked
    rec["token_logit_gap_max"] = gap[live].max().item()
    rec["gaps_within_2ulp"] = bool((gap[live] <= 2 * ulp[live]).all().item())
    rec["ok"] = bool(rec["flags_exact"] and rec["tokens_equal"]
                     and rec["ties_lowest"] and rec["gaps_within_2ulp"])
    return rec


def k1_case(torch, dev, S, hkv, gen, B=1):
    from paddle_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_cost, flash_attention_reference)
    import torch.nn.functional as F
    Hq, D = 16, 128
    bf = torch.bfloat16
    q = torch.randn((B, S, Hq, D), generator=gen, device=dev).to(bf)
    k = torch.randn((B, S, hkv, D), generator=gen, device=dev).to(bf)
    v = torch.randn((B, S, hkv, D), generator=gen, device=dev).to(bf)
    o, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    torch.cuda.synchronize()
    ro, rlse = flash_attention_reference(q.float(), k.float(), v.float(),
                                         causal=True)
    err = (o.float() - ro).abs().max().item()
    lse_err = (lse - rlse).abs().max().item()
    # bf16 output: half an ulp is 2^-8 relative; twice that, scaled by
    # the largest |o|, covers the rounding plus fp32 summation order
    tol = 2.0 ** -7 * max(1.0, ro.abs().max().item())
    # and each 64-row tile within REL_L2_TOL (late causal rows average
    # many values and are far smaller than the largest |o|)
    tile_err = tile_rel_l2(o, ro)[0]
    lse_tol = 1e-3
    # the kernel's device time; the call's (wrapper included) by events
    ms = _device_ms(torch, lambda: flash_attention(q, k, v, causal=True),
                    keys=("flash_fwd_",))
    call_ms = _event_ms(torch, lambda: flash_attention(q, k, v,
                                                       causal=True))
    plain_ms = _event_ms(torch, lambda: flash_attention_reference(
        q, k, v, causal=True), iters=5 if B == 1 else 2, warmup=1)
    # the library call on head-major copies, kv heads expanded for GQA
    # outside the timed region
    qt, kt, vt = (x.repeat_interleave(Hq // x.shape[2], dim=2)
                  .transpose(1, 2).contiguous() for x in (q, k, v))
    lib_ms = _event_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    flops, nbytes = flash_attention_cost(B, S, S, Hq, hkv, D, causal=True,
                                         elt=q.element_size())
    bound_ms, bound_by = _bound(nbytes, flops)
    rec = {"phase": f"k1_flash_fwd_B{B}_S{S}_hkv{hkv}", "B": B, "S": S,
           "Hq": Hq, "Hkv": hkv, "D": D, "dtype": "bfloat16",
           "max_abs_err": err, "tol": tol, "lse_max_abs_err": lse_err,
           "lse_tol": lse_tol, "tile_rel_l2_max": tile_err,
           "tol_rel_l2": REL_L2_TOL, "kernel_ms": ms, "call_ms": call_ms,
           "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "ok": bool(err <= tol and lse_err <= lse_tol
                      and tile_err <= REL_L2_TOL and ms is not None)}
    _phase(rec)
    return rec


def _paged_inputs(torch, dev, gen, hkv, lengths, page=128, max_pages=2):
    B, Hq, D = len(lengths), 16, 128
    bf = torch.bfloat16
    P = B * max_pages + 1
    q = torch.randn((B, Hq, D), generator=gen, device=dev).to(bf)
    kp = torch.randn((P, hkv, page, D), generator=gen, device=dev).to(bf)
    vp = torch.randn((P, hkv, page, D), generator=gen, device=dev).to(bf)
    perm = torch.randperm(B * max_pages, generator=gen, device=dev)
    table = perm.reshape(B, max_pages).to(torch.int32).contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, table, lens


def k2_fused_case(torch, dev, gen, hkv):
    from paddle_tpu_torch.ops.paged_attention import (
        paged_append_attend, paged_append_attend_cost,
        paged_append_attend_reference)
    lengths = [0, 1, 127, 128, 255, 64, 200, 17]
    page = 128
    q, kp0, vp0, table, lens = _paged_inputs(torch, dev, gen, hkv, lengths)
    B, D = q.shape[0], q.shape[-1]
    k_row = torch.randn((B, hkv, D), generator=gen,
                        device=dev).to(q.dtype)
    v_row = torch.randn((B, hkv, D), generator=gen,
                        device=dev).to(q.dtype)
    wp = table.gather(1, (lens // page)[:, None].long())[:, 0].contiguous()
    kp1, vp1 = kp0.clone(), vp0.clone()
    o, _, _ = paged_append_attend(q, kp1, vp1, k_row, v_row, table, wp,
                                  lens)
    torch.cuda.synchronize()
    kp2, vp2 = kp0.clone(), vp0.clone()
    ro, _, _ = paged_append_attend_reference(q.float(), kp2, vp2, k_row,
                                             v_row, table, wp, lens)
    err = (o.float() - ro.float()).abs().max().item()
    tol = 2.0 ** -7 * max(1.0, ro.abs().max().item())
    row_err = rel_l2(o, ro, (2,)).max().item()   # per (slot, head)
    # exactly the target row of the target page changed, to k_row/v_row
    target = torch.zeros(kp0.shape[:3], dtype=torch.bool, device=dev)
    target[wp.long(), :, (lens % page).long()] = True
    changed = (kp1 != kp0).any(-1) | (vp1 != vp0).any(-1)
    rows_ok = bool((changed & ~target).sum().item() == 0
                   and torch.equal(kp1, kp2) and torch.equal(vp1, vp2))
    call = (lambda: paged_append_attend(q, kp1, vp1, k_row, v_row, table,
                                        wp, lens))
    ms = _device_ms(torch, call, ("paged_kernel",))
    call_ms = _event_ms(torch, call)
    plain_ms = _device_ms(torch, lambda: paged_append_attend_reference(
        q, kp2, vp2, k_row, v_row, table, wp, lens), iters=5, warmup=1)
    flops, nbytes = paged_append_attend_cost(lengths, q.shape[1], hkv, D,
                                             q.element_size())
    bound_ms, bound_by = _bound(nbytes, flops)
    rec = {"phase": f"k2_paged_fused_hkv{hkv}", "B": B, "Hq": q.shape[1],
           "Hkv": hkv, "D": D, "page": page, "lengths": lengths,
           "dtype": "bfloat16", "max_abs_err": err, "tol": tol,
           "row_rel_l2_max": row_err, "tol_rel_l2": REL_L2_TOL,
           "pool_write_exact": rows_ok, "kernel_ms": ms,
           "call_ms": call_ms, "plain_ms": plain_ms, "library_ms": None,
           "timing": "device time (torch.profiler); call_ms: CUDA "
                     "events around back-to-back calls",
           "bound_ms": bound_ms, "bound_by": bound_by,
           "ok": bool(err <= tol and row_err <= REL_L2_TOL and rows_ok
                      and None not in (ms, plain_ms))}
    _phase(rec)
    return rec


def k2_plain_case(torch, dev, gen, hkv, lengths, table_rows=None,
                  name=""):
    from paddle_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_cost,
        paged_decode_attention_reference)
    q, kp, vp, table, lens = _paged_inputs(torch, dev, gen, hkv, lengths)
    if table_rows is not None:
        # every query row reads the same sequence (the suffix prefill)
        table = table[:1].expand(len(lengths), -1).contiguous()
    o, m, l = paged_decode_attention(q, kp, vp, table, lens,
                                     return_stats=True)
    torch.cuda.synchronize()
    ro, rm, rl = paged_decode_attention_reference(
        q.float(), kp, vp, table, lens, return_stats=True)
    err = (o.float() - ro.float()).abs().max().item()
    tol = 2.0 ** -7 * max(1.0, ro.abs().max().item())
    # per (query row, head), over the rows that see a key
    row_err = rel_l2(o, ro, (2,))[lens > 0].max().item()
    fin = torch.isfinite(rm)
    stats_ok = bool(torch.equal(fin, torch.isfinite(m))
                    and torch.allclose(m[fin], rm[fin], rtol=1e-4,
                                       atol=1e-4)
                    and torch.allclose(l, rl, rtol=1e-4, atol=1e-5))
    call = (lambda: paged_decode_attention(q, kp, vp, table, lens))
    ms = _device_ms(torch, call, ("paged_kernel",))
    call_ms = _event_ms(torch, call)
    plain_ms = _device_ms(torch, lambda: paged_decode_attention_reference(
        q, kp, vp, table, lens), iters=5, warmup=1)
    D = q.shape[-1]
    flops, nbytes = paged_decode_attention_cost(
        lengths, q.shape[1], hkv, D, q.element_size(),
        kv_tokens=None if table_rows is None else max(lengths))
    bound_ms, bound_by = _bound(nbytes, flops)
    rec = {"phase": f"k2p_paged_plain{name}_hkv{hkv}", "B": len(lengths),
           "Hq": q.shape[1], "Hkv": hkv, "D": D, "page": kp.shape[2],
           "dtype": "bfloat16", "max_abs_err": err, "tol": tol,
           "row_rel_l2_max": row_err, "tol_rel_l2": REL_L2_TOL,
           "stats_ok": stats_ok, "kernel_ms": ms, "call_ms": call_ms,
           "plain_ms": plain_ms, "library_ms": None,
           "timing": "device time (torch.profiler); call_ms: CUDA "
                     "events around back-to-back calls",
           "bound_ms": bound_ms, "bound_by": bound_by,
           "ok": bool(err <= tol and row_err <= REL_L2_TOL and stats_ok
                      and None not in (ms, plain_ms))}
    _phase(rec)
    return rec


def k34_case(torch, dev, gen, hkv):
    """K3 (dK/dV) and K4 (dQ) at the train shape, on K1's own (o, lse)
    and the same delta as the plain backward."""
    from paddle_tpu_torch.ops import flash_attention as fa
    import torch.nn.functional as F
    B, S, Hq, D = 4, 2048, 16, 128
    bf = torch.bfloat16
    scale = D ** -0.5
    q = torch.randn((B, S, Hq, D), generator=gen, device=dev).to(bf)
    k = torch.randn((B, S, hkv, D), generator=gen, device=dev).to(bf)
    v = torch.randn((B, S, hkv, D), generator=gen, device=dev).to(bf)
    do = torch.randn((B, S, Hq, D), generator=gen, device=dev).to(bf)
    o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    delta = fa._delta(o, do)
    dk, dv = fa.flash_attention_bwd_dkdv(q, k, v, do, lse, delta, True,
                                         scale)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, True, scale)
    torch.cuda.synchronize()
    ref = fa.flash_attention_bwd_reference(
        q.float(), k.float(), v.float(), o, lse, do.float(), True, scale)
    # bf16 outputs of fp32 sums of the same products (p and ds rounded
    # to bf16 by the kernels only): each 64-row tile within REL_L2_TOL
    check = attention_grads_check((dq, dk, dv), ref)
    max_abs = {n: (g.float() - r).abs().max().item()
               for n, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref)}
    del ref
    dkdv_ms = _event_ms(torch, lambda: fa.flash_attention_bwd_dkdv(
        q, k, v, do, lse, delta, True, scale), iters=5, warmup=1)
    dq_ms = _event_ms(torch, lambda: fa.flash_attention_bwd_dq(
        q, k, v, do, lse, delta, True, scale), iters=5, warmup=1)
    plain_ms = _event_ms(torch, lambda: fa.flash_attention_bwd_reference(
        q, k, v, o, lse, do, True, scale), iters=2, warmup=1)
    # the library: backward of F.scaled_dot_product_attention on
    # head-major copies (kv heads expanded), computing dq, dk and dv
    qt, kt, vt = (x.repeat_interleave(Hq // x.shape[2], dim=2)
                  .transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2).contiguous()
    lib_ms = _event_ms(torch, lambda: torch.autograd.grad(
        ot, (qt, kt, vt), dot, retain_graph=True), iters=5, warmup=1)
    del qt, kt, vt, ot
    elt = q.element_size()
    pairs = B * Hq * S * (S + 1) // 2          # visible (query, key) pairs
    rows = B * Hq * S * 4 * 2                  # lse and delta, fp32
    q_bytes = B * S * Hq * D * elt             # q or do
    kv_bytes = B * S * hkv * D * elt           # k or v
    # K3 reads q, do, k, v, lse, delta and writes dk, dv; 4 products
    # (s, dp, dv, dk) of 2 D flops per pair. K4 writes dq; 3 products.
    dkdv_bound = _bound(2 * q_bytes + 4 * kv_bytes + rows, 8 * D * pairs)
    dq_bound = _bound(3 * q_bytes + 2 * kv_bytes + rows, 6 * D * pairs)
    rec = {"phase": f"k34_flash_bwd_hkv{hkv}", "B": B, "S": S, "Hq": Hq,
           "Hkv": hkv, "D": D, "dtype": "bfloat16",
           "max_abs_err": max_abs,
           "tile_rel_l2_max": check["tile_rel_l2_max"],
           "rel_l2": check["rel_l2"], "tol_rel_l2": REL_L2_TOL,
           "k3_ms": dkdv_ms, "k4_ms": dq_ms, "plain_ms": plain_ms,
           "library_ms": lib_ms,
           "k3_bound_ms": dkdv_bound[0], "k3_bound_by": dkdv_bound[1],
           "k4_bound_ms": dq_bound[0], "k4_bound_by": dq_bound[1],
           "ok": check["ok"]}
    _phase(rec)
    return rec


def _ce_run_check(torch, ce, x, w, labels, g):
    """K5, K6 and K7 once against their plain versions on the same
    inputs: per-row loss and lse within 1e-3 (fp32 sums of the same bf16
    products in another order), an ignored row's loss exactly 0, dx and
    dw by ``ce_grads_check``. The plain backward takes the inputs in
    fp32, so it does not round dl to bf16: where one term makes up a row
    of dw, the kernel's rounding of it (half a bf16 ulp, at most 2^-8)
    then counts once, not as the one-ulp gap between two roundings.
    Returns (check record, K5's lse)."""
    valid = labels >= 0
    loss, lse = ce.fused_ce_fwd(x, w, labels)
    dx = ce.fused_ce_dx(x, w, labels, lse, g)
    dw = ce.fused_ce_dw(x, w, labels, lse, g)
    torch.cuda.synchronize()
    rloss, rlse = ce.fused_ce_reference(x, w, labels)
    rdx, rdw = ce.fused_ce_bwd_reference(x.float(), w.float(), labels,
                                         lse, g)
    rec = ce_grads_check(dx, dw, rdx, rdw, labels)
    rec.update({"loss_max_abs_err": (loss - rloss).abs().max().item(),
                "lse_max_abs_err": (lse - rlse).abs().max().item(),
                "ignored_loss_zero": bool((loss[~valid] == 0).all().item()),
                "dx_max_abs_err": (dx.float() - rdx).abs().max().item(),
                "dw_max_abs_err": (dw.float() - rdw).abs().max().item()})
    del rdx, rdw
    loss_tol = 1e-3
    rec["ok"] = bool(rec["ok"] and rec["ignored_loss_zero"]
                     and rec["loss_max_abs_err"] <= loss_tol
                     and rec["lse_max_abs_err"] <= loss_tol)
    return rec, lse


def ce_case(torch, dev, gen):
    """K5, K6 and K7 at the train shape: N = 4 x 2047 rows (not a
    multiple of the 64-row tile), d 2048, V 50304, every 7th label
    ignored. Checked twice: with the model's init head (w std 0.02: a
    near-uniform softmax, timed) and with logits of std 3 (w std
    3/sqrt(d): a peaked softmax, where dx's softmax term is not lost
    under bf16 rounding of the label term)."""
    from paddle_tpu_torch.ops import fused_ce as ce
    import torch.nn.functional as F
    N, d, V = 4 * 2047, 2048, 50304
    bf = torch.bfloat16
    x = torch.randn((N, d), generator=gen, device=dev).to(bf)
    w_raw = torch.randn((V, d), generator=gen, device=dev)
    labels = torch.randint(0, V, (N,), generator=gen, device=dev,
                           dtype=torch.int32)
    labels[::7] = -1
    valid = labels >= 0
    g = torch.where(valid, 1.0, 0.0).float().contiguous()
    peaked, _ = _ce_run_check(torch, ce, x, (3 / d ** 0.5 * w_raw).to(bf),
                              labels, g)
    w = (0.02 * w_raw).to(bf)
    del w_raw
    init, lse = _ce_run_check(torch, ce, x, w, labels, g)
    fwd_ms = _event_ms(torch, lambda: ce.fused_ce_fwd(x, w, labels),
                       iters=3, warmup=1)
    dx_ms = _event_ms(torch, lambda: ce.fused_ce_dx(x, w, labels, lse, g),
                      iters=3, warmup=1)
    dw_ms = _event_ms(torch, lambda: ce.fused_ce_dw(x, w, labels, lse, g),
                      iters=3, warmup=1)
    plain_fwd_ms = _event_ms(torch, lambda: ce.fused_ce_reference(
        x, w, labels), iters=3, warmup=1)
    plain_bwd_ms = _event_ms(torch, lambda: ce.fused_ce_bwd_reference(
        x, w, labels, lse, g), iters=3, warmup=1)
    # the library: torch.matmul + F.cross_entropy in bf16, and that
    # pair's backward (dx and dw together)
    lab64 = labels.long()
    lib_fwd_ms = _event_ms(torch, lambda: F.cross_entropy(
        torch.matmul(x, w.t()), lab64, ignore_index=-1, reduction="none"),
        iters=3, warmup=1)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    lib_loss = F.cross_entropy(torch.matmul(xg, wg.t()), lab64,
                               ignore_index=-1, reduction="none")
    lib_bwd_ms = _event_ms(torch, lambda: torch.autograd.grad(
        lib_loss, (xg, wg), g, retain_graph=True), iters=3, warmup=1)
    del xg, wg, lib_loss
    elt = x.element_size()
    io = (N * d + V * d) * elt + N * 4          # x, w, labels
    mac = N * V * d
    fwd_bound = _bound(io + 2 * N * 4, 2 * mac)
    # K6 and K7 each recompute the logits and do one more product
    dx_bound = _bound(io + 2 * N * 4 + N * d * elt, 4 * mac)
    dw_bound = _bound(io + 2 * N * 4 + V * d * elt, 4 * mac)
    rec = {"phase": "k567_fused_ce", "N": N, "d": d, "V": V,
           "ignored_rows": int((~valid).sum().item()), "dtype": "bfloat16",
           "loss_tol": 1e-3, "tol_rel_l2": REL_L2_TOL,
           "check_init_head": init, "check_peaked": peaked,
           "loss_max_abs_err": max(init["loss_max_abs_err"],
                                   peaked["loss_max_abs_err"]),
           "lse_max_abs_err": max(init["lse_max_abs_err"],
                                  peaked["lse_max_abs_err"]),
           "k5_ms": fwd_ms, "k6_ms": dx_ms, "k7_ms": dw_ms,
           "plain_fwd_ms": plain_fwd_ms, "plain_bwd_ms": plain_bwd_ms,
           "library_fwd_ms": lib_fwd_ms, "library_bwd_ms": lib_bwd_ms,
           "k5_bound_ms": fwd_bound[0], "k5_bound_by": fwd_bound[1],
           "k6_bound_ms": dx_bound[0], "k6_bound_by": dx_bound[1],
           "k7_bound_ms": dw_bound[0], "k7_bound_by": dw_bound[1],
           "ok": bool(init["ok"] and peaked["ok"])}
    _phase(rec)
    return rec


K10_LENGTHS = [0, 1, 127, 128, 517, 1023, 1024, 2047]
# the four gpt3_1p3b block products (K, N): wqkv, wo, wup, wdown
K12_PRODUCTS = (("wqkv", 2048, 6144), ("wo", 2048, 2048),
                ("wup", 2048, 8192), ("wdown", 8192, 2048))


def k10_case(torch, dev, gen, hkv):
    """K10 at the contiguous engine's decode shape: B 8, 16 query heads,
    T 2048, D 128, bf16, mixed lengths with an empty row; with and
    without (m, l), each held by ``decode_attention_check``."""
    from paddle_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_cost, decode_attention_reference)
    import torch.nn.functional as F
    B, Hq, T, D = len(K10_LENGTHS), 16, 2048, 128
    bf = torch.bfloat16
    q = torch.randn((B, Hq, D), generator=gen, device=dev).to(bf)
    k = torch.randn((B, hkv, T, D), generator=gen, device=dev).to(bf)
    v = torch.randn((B, hkv, T, D), generator=gen, device=dev).to(bf)
    lens = torch.tensor(K10_LENGTHS, dtype=torch.int32, device=dev)
    o, m, l = decode_attention(q, k, v, lens, return_stats=True)
    o_plain = decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    ro, rm, rl = decode_attention_reference(q, k, v, lens,
                                            return_stats=True)
    with_stats = decode_attention_check(o, m, l, ro, rm, rl, lens)
    without = decode_attention_check(o_plain, None, None, ro, None, None,
                                     lens)
    live = lens > 0
    err = (o.float() - ro.float())[live].abs().max().item()
    elt = q.element_size()
    n_keys = sum(K10_LENGTHS)
    flops, nbytes = decode_attention_cost(K10_LENGTHS, Hq, hkv, D, elt,
                                          return_stats=True)
    # device time of the kernel (profiler) over caches found cold, beside
    # CUDA events around back-to-back calls, which count the wrapper's
    # host time too
    kv = _cold((k, v), nbytes)
    call = (lambda: decode_attention(q, *kv(), lens, return_stats=True))
    ms = _device_ms(torch, call, ("decode_kernel",))
    call_ms = _event_ms(torch, call)
    ms_no_stats = _device_ms(torch, lambda: decode_attention(q, *kv(), lens),
                             ("decode_kernel",))
    plain_ms = _device_ms(torch, lambda: decode_attention_reference(
        q, *kv(), lens, return_stats=True), iters=5, warmup=1)
    del kv
    # the library: sdpa over the whole cache with a length mask, kv
    # heads expanded outside the timed region (the empty row gives NaN
    # there; only the time is used)
    kvt = _cold(tuple(x.repeat_interleave(Hq // hkv, dim=1)
                      for x in (k, v)), 2 * n_keys * Hq * D * elt)
    mask = (torch.arange(T, device=dev)[None, :]
            < lens[:, None])[:, None, None, :]
    lib_ms = _device_ms(torch, lambda: F.scaled_dot_product_attention(
        q[:, :, None], *kvt(), attn_mask=mask))
    del kvt
    bound_ms, bound_by = _bound(nbytes, flops)
    rec = {"phase": f"k10_decode_attention_hkv{hkv}", "B": B, "Hq": Hq,
           "Hkv": hkv, "T": T, "D": D, "lengths": K10_LENGTHS,
           "dtype": "bfloat16", "check_stats": with_stats,
           "check_no_stats": without, "tol_rel_l2": REL_L2_TOL,
           "stats_tol_rel": STATS_REL_TOL, "max_abs_err": err,
           "kernel_ms": ms, "kernel_ms_no_stats": ms_no_stats,
           "call_ms": call_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "timing": "device time (torch.profiler), caches cold; "
                     "call_ms: CUDA events around back-to-back calls",
           "library": "F.scaled_dot_product_attention over the cache, "
                      "length mask",
           "bound_ms": bound_ms, "bound_by": bound_by,
           "ok": bool(with_stats["ok"] and without["ok"]
                      and None not in (ms, ms_no_stats, plain_ms,
                                       lib_ms))}
    _phase(rec)
    return rec


K12_KERNELS = ("rows_kernel", "tiles_kernel", "finalize_kernel")


def _sum_or_none(values):
    values = list(values)
    return None if None in values else sum(values)


def k12_case(torch, dev, gen):
    """K12 on the four gpt3_1p3b block products at M 8 (decode: the
    weight stream) and M 128 (a prefill bucket: the wmma tiles), bf16,
    weights drawn at std 0.02 and quantized per output column; each
    output held by ``quant_matmul_check``. The library yardstick is
    ``torch.matmul`` on the weight dequantized to bf16 beforehand, which
    reads twice the weight bytes."""
    from paddle_tpu_torch.ops.quant_matmul import (int8_matmul,
                                                   int8_matmul_cost,
                                                   int8_matmul_reference)
    from paddle_tpu_torch.quantization import quantize_tensor
    bf = torch.bfloat16
    cases, ok, err = [], True, 0.0
    for name, K, N in K12_PRODUCTS:
        qt = quantize_tensor((0.02 * torch.randn(
            (K, N), generator=gen, device=dev)).to(bf))
        w_deq = qt.dequantize()
        for M in (8, 128):
            x = torch.randn((M, K), generator=gen, device=dev).to(bf)
            out = int8_matmul(x, qt.q, qt.scale)
            torch.cuda.synchronize()
            ref = int8_matmul_reference(x, qt.q, qt.scale)
            check = quant_matmul_check(out, ref)
            err = max(err, (out.float() - ref.float()).abs().max().item())
            flops, nbytes = int8_matmul_cost(M, K, N, x.element_size())
            # every layer reads its own weights: time them cold
            wq = _cold((qt.q,), K * N)
            call = (lambda: int8_matmul(x, *wq(), qt.scale))
            ms = _device_ms(torch, call, K12_KERNELS)
            call_ms = _event_ms(torch, call)
            plain_ms = _device_ms(torch, lambda: int8_matmul_reference(
                x, *wq(), qt.scale), iters=5, warmup=1)
            wd = _cold((w_deq,), 2 * K * N)
            lib_ms = _device_ms(torch, lambda: torch.matmul(x, *wd()))
            del wq, wd
            bound_ms, bound_by = _bound(nbytes, flops)
            cases.append({"product": name, "M": M, "K": K, "N": N,
                          "check": check, "kernel_ms": ms,
                          "call_ms": call_ms, "plain_ms": plain_ms,
                          "library_ms": lib_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by})
            ok = (ok and check["ok"]
                  and None not in (ms, plain_ms, lib_ms))
    decode = [c for c in cases if c["M"] == 8]
    rec = {"phase": "k12_int8_matmul", "dtype": "bfloat16",
           "tol_rel_l2": REL_L2_TOL, "cases": cases, "max_abs_err": err,
           "timing": "device time (torch.profiler), weights cold; "
                     "call_ms: CUDA events around back-to-back calls",
           "library": "torch.matmul on the bf16-dequantized weight "
                      "(twice the weight bytes)",
           # one decode layer's four products at M 8, summed (None where
           # a time is missing: the phase then fails on ``ok``)
           "decode_layer_ms": _sum_or_none(c["kernel_ms"] for c in decode),
           "decode_layer_plain_ms": _sum_or_none(c["plain_ms"]
                                                 for c in decode),
           "decode_layer_library_ms": _sum_or_none(c["library_ms"]
                                                   for c in decode),
           "decode_layer_bound_ms": sum(c["bound_ms"] for c in decode),
           "ok": bool(ok)}
    _phase(rec)
    return rec


def _k8_bound(inp):
    """K8's least time (``mega_decode_layers_cost``): every slab read
    once, each row's valid K/V rows read once per layer, each fresh row
    written once per layer, x read and written; the operations of the
    products and of attention."""
    from paddle_tpu_torch.ops.decode_megakernel import (
        mega_decode_layers_cost)
    geo = inp["geo"]
    lens = [min(int(p) + 1, inp["table"].shape[1] * geo["page"])
            for p in inp["pos"].tolist()]
    flops, nbytes = mega_decode_layers_cost(
        lens, inp["w"], geo["n_heads"], geo["kv_heads"], geo["head_dim"],
        inp["x"].element_size())
    return _bound(nbytes, flops)


def _mega_call(mk, inp, kp, vp, plain=False):
    fn = mk.mega_decode_layers_reference if plain else mk.mega_decode_layers
    return fn(inp["x"], inp["w"], kp, vp, inp["table"], inp["pos"],
              inp["slot"], inp["write"], **inp["geo"])


def _per_layer_call(torch, inp, kp, vp):
    """One step of the per-layer (``mega=False``) engine's layer loop at
    K8's shapes, for context: per layer ``_qkv``, K2 with the inactive
    row writing the scratch page, ``_block_tail``."""
    from paddle_tpu_torch.models.gpt import GPTBlock, GPTConfig
    from paddle_tpu_torch.ops.paged_attention import paged_append_attend
    geo, w = inp["geo"], inp["w"]
    hq, hkv, d = geo["n_heads"], geo["kv_heads"], geo["head_dim"]
    L, P, page = w["wqkv"].shape[0], geo["n_pages"], geo["page"]
    blk = GPTBlock(GPTConfig(d_model=hq * d, n_layers=L, n_heads=hq,
                             n_kv_heads=hkv, rope=geo["rope"]))
    pos, table = inp["pos"], inp["table"][inp["slot"].long()]
    base = table.gather(1, (pos // page)[:, None].long())[:, 0]
    x = inp["x"][:, None]
    for layer in range(L):
        lw = {n: t[layer] for n, t in w.items()}
        q, k, v = blk._qkv(x, pos, lw)
        wp = torch.where(inp["write"] == 1, layer * P + base,
                         L * P).to(torch.int32)
        o, _, _ = paged_append_attend(
            q[:, 0].contiguous(), kp, vp, k[:, 0].contiguous(),
            v[:, 0].contiguous(), (layer * P + table).contiguous(), wp, pos)
        x = blk._block_tail(x, o.reshape(x.shape), lw)
    return x[:, 0]


def k8_case(torch, name, inp, tol, timed=False, context=False):
    """K8 once against its plain version on the same inputs
    (``mega_layers_check``) and its bound; with ``timed``, its device
    time (profiler: at gpt3_1p3b width the weights, far larger than L2,
    are read cold by every call) and the plain version's; with
    ``context``, also the per-layer path's at the same shapes and its
    kernel launches. Returns (record, x_out)."""
    from paddle_tpu_torch.ops import decode_megakernel as mk
    L = inp["w"]["wqkv"].shape[0]
    kp, vp = inp["kp"].clone(), inp["vp"].clone()
    out = _mega_call(mk, inp, kp, vp)
    torch.cuda.synchronize()
    rkp, rvp = inp["kp"].clone(), inp["vp"].clone()
    ref = _mega_call(mk, inp, rkp, rvp, plain=True)
    check = mega_layers_check(out, ref, (kp, vp), (rkp, rvp),
                              (inp["kp"], inp["vp"]), inp["written"], tol)
    del rkp, rvp
    bound_ms, bound_by = _k8_bound(inp)
    rec = {"phase": f"k8_{name}", "layers": L, "rows": K8_ROWS,
           **{k: v for k, v in inp["geo"].items()},
           "d_model": inp["x"].shape[1], "dtype": str(inp["x"].dtype),
           "biases": "bqkv" in inp["w"], "tol_rel_l2": tol,
           "check": check,
           "max_abs_err": (out.float() - ref.float()).abs().max().item(),
           "bound_ms": bound_ms, "bound_by": bound_by}
    ok = check["ok"]
    if timed:
        rec["kernel_ms"] = _device_ms(
            torch, lambda: _mega_call(mk, inp, kp, vp), ("mega_kernel",),
            iters=10, warmup=2)
        rec["plain_ms"] = _device_ms(
            torch, lambda: _mega_call(mk, inp, kp, vp, plain=True), iters=2,
            warmup=1)
        rec["library_ms"] = None
        ok = ok and None not in (rec["kernel_ms"], rec["plain_ms"])
    if context:
        rec["per_layer_path_ms"] = _device_ms(
            torch, lambda: _per_layer_call(torch, inp, kp, vp), iters=5,
            warmup=1)
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _per_layer_call(torch, inp, kp, vp)
            torch.cuda.synchronize()
        rec["per_layer_path_launches"] = sum(
            e.device_type == DeviceType.CUDA for e in prof.events())
        rec["timing"] = ("device time (torch.profiler); the per-layer "
                         "path (mega=False) at the same shapes is context, "
                         "not a library call")
        ok = ok and rec["per_layer_path_ms"] is not None
    rec["ok"] = bool(ok)
    _phase(rec)
    return rec, out


def k89_phase(torch, dev, gen, model):
    """K8 and K9 at the single-dispatch engine's shapes (phase 11): one
    gpt3_1p3b layer at full width (weights at 1/sqrt(fan_in)), one layer
    at d_model 128 (the per-layer fixed cost), two
    llama_style_1b-shaped layers (4 kv heads, rope, no biases), all 24
    of the model's own layers, each against the plain version; then K9
    on the 24-layer output and a copy of the model's tied head with a
    planted tie, an overflowing row and a poisoned row. Returns (K8
    record, K9 record)."""
    from paddle_tpu_torch.ops import decode_megakernel as mk
    cfg = model.cfg
    dm, hq, d = cfg.d_model, cfg.n_heads, cfg.head_dim
    one = mega_inputs(torch, dev, gen, dm, hq, hq, d, 1)
    k8_case(torch, "gpt3_1p3b_1layer", one, REL_L2_TOL, timed=True)
    del one
    # d_model 128: the weight stream is negligible, so the time is what
    # one layer's phases cost whatever the width (barriers, staging,
    # reductions, attention at these positions)
    narrow = mega_inputs(torch, dev, gen, 128, 2, 2, 64, 1)
    k8_case(torch, "narrow_1layer", narrow, REL_L2_TOL, timed=True)
    del narrow
    lla = mega_inputs(torch, dev, gen, dm, hq, 4, d, 2, bias=False,
                      rope=True)
    k8_case(torch, "llama_shaped_2layers", lla, REL_L2_TOL)
    del lla
    slabs = {n: t.detach() for n, t in model.stacked.items()}
    deep = mega_inputs(torch, dev, gen, dm, hq, hq, d, cfg.n_layers,
                       weights=slabs)
    k8, x24 = k8_case(torch, "gpt3_1p3b_24layers", deep, THROUGH_DEPTH_TOL,
                      timed=True, context=True)
    del deep
    torch.cuda.empty_cache()

    x, w, poison, ties = mega_logits_inputs(
        torch, x24, model.wte.detach(), model.lnf_scale.detach(),
        model.lnf_bias.detach())
    s, b = model.lnf_scale.detach(), model.lnf_bias.detach()
    tok, nonfin = mk.mega_logits_sample(x, s, b, w.t(), poison)
    torch.cuda.synchronize()
    logits = mk.epilogue_logits(x, s, b, w.t(), poison)
    _, ref_nonfin = mk.mega_logits_sample_reference(x, s, b, w.t(), poison)
    check = mega_logits_check(tok, nonfin, logits, ref_nonfin, ties)
    del logits
    ms = _device_ms(torch, lambda: mk.mega_logits_sample(x, s, b, w.t(),
                                                         poison),
                    ("logits_kernel",))
    plain_ms = _device_ms(torch, lambda: mk.mega_logits_sample_reference(
        x, s, b, w.t(), poison), iters=5, warmup=1)
    B, V = x.shape[0], w.shape[0]
    flops, nbytes = mk.mega_logits_sample_cost(B, dm, V, x.element_size())
    bound_ms, bound_by = _bound(nbytes, flops)
    k9 = {"phase": "k9_gpt3_1p3b_head", "B": B, "d_model": dm, "V": V,
          "dtype": str(x.dtype), "check": check, "ties": ties,
          "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": None,
          "timing": "device time (torch.profiler); the head (0.21 GB) "
                    "is read cold by every call",
          "bound_ms": bound_ms, "bound_by": bound_by,
          "ok": bool(check["ok"] and None not in (ms, plain_ms))}
    _phase(k9)
    return k8, k9


def _counters():
    """Every ported kernel's wrapper, by name (``ops.launch_counters``): a
    path's launches are these counters, zeroed just before the path and
    read just after."""
    from paddle_tpu_torch.ops import launch_counters
    return launch_counters()


def _zero_counters():
    for fn in _counters().values():
        fn.launches = 0


def _read_counters():
    return {n: fn.launches for n, fn in _counters().items()}


def train_phase(torch, dev, n_steps=6):
    """gpt3_1p3b train steps; see the module docstring (phase 5)."""
    import numpy as np
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops.flash_attention import flash_attention_plain
    from paddle_tpu_torch.ops.fused_ce import fused_ce_plain
    from paddle_tpu_torch.optimizer import AdamW

    cfg = gpt.gpt3_1p3b()
    B, S = 4, cfg.max_seq_len
    t0 = time.perf_counter()
    model = gpt.GPT(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (B, S)).astype(np.int32)).to(dev)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}

    def optimizer():
        return AdamW(learning_rate=1e-4, weight_decay=0.01,
                     moment_dtype=torch.bfloat16)

    # step 1 through the plain versions (differentiable, memory-light:
    # their backward recomputes from (o, lse) and (x, w, lse) as the
    # kernels do)
    def plain_attn(q, k, v, is_causal=False):
        return flash_attention_plain(q, k, v, causal=is_causal)

    opt = optimizer()
    params, state = gpt.init_train_state(model, opt)
    step = gpt.build_train_step(model, opt, attn=plain_attn,
                                ce=fused_ce_plain)
    t0 = time.perf_counter()
    params, state, loss = step(params, state, tokens)
    plain_loss = loss.item()
    plain_step_s = time.perf_counter() - t0
    plain_grads = {n: p.grad for n, p in params.items()}
    del opt, params, state, step
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(start[n])
            p.grad = None
    del start

    # the kernel path from the same weights
    opt = optimizer()
    params, state = gpt.init_train_state(model, opt)
    step = gpt.build_train_step(model, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counters()
    losses, step_s = [], []
    grad_err = {}
    for i in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss = step(params, state, tokens)
        losses.append(loss.item())          # synchronizes
        step_s.append(time.perf_counter() - t0)
        if i == 0:
            for n, p in params.items():
                ref = plain_grads[n].float()
                grad_err[n] = ((p.grad.float() - ref).norm()
                               / ref.norm().clamp(min=1e-30)).item()
            del plain_grads
    launches = _read_counters()
    peak = torch.cuda.max_memory_allocated(dev)
    L = cfg.n_layers
    expected = {n: 0 for n in launches}
    expected.update({"flash_attention": L, "flash_attention_bwd_dkdv": L,
                     "flash_attention_bwd_dq": L, "fused_ce_fwd": 1,
                     "fused_ce_dx": 1, "fused_ce_dw": 1})
    per_step = {n: c / n_steps for n, c in launches.items()}
    counts_ok = all(per_step[n] == e for n, e in expected.items())
    loss_rel = abs(losses[0] - plain_loss) / abs(plain_loss)
    # bf16 activations round at other places on the two paths, and the
    # differences grow through 24 layers of backward: the deepest
    # gradient (wpe, the residual stream at layer 0) differs most
    loss_tol, grad_tol = 1e-3, 2.5e-2
    worst = max(grad_err, key=grad_err.get)
    timed = sorted(step_s[1:])               # step 1 pays first-use costs
    med = timed[len(timed) // 2]
    tok_s = B * S / med
    finite = all(np.isfinite(losses))
    rec = {"phase": "train_gpt3_1p3b", "params": cfg.num_params(),
           "layers": L, "d_model": cfg.d_model, "batch": B, "seq": S,
           "remat": cfg.remat, "init_s": init_s,
           "plain_step1_loss": plain_loss, "plain_step1_s": plain_step_s,
           "losses": losses, "step1_loss_rel_err": loss_rel,
           "loss_tol_rel": loss_tol,
           "grad_rel_l2_max": grad_err[worst], "grad_rel_l2_worst": worst,
           "grad_tol_rel_l2": grad_tol,
           "step_s": step_s, "step_ms_median": med * 1e3,
           "tokens_per_s": tok_s,
           "mfu": cfg.flops_per_token() * tok_s / H100_BF16_FLOPS,
           "flops_per_token": cfg.flops_per_token(),
           "peak_mem_bytes": peak, "launches": launches,
           "launches_per_step": per_step,
           "expected_per_step": expected, "counts_ok": bool(counts_ok),
           "ok": bool(finite and counts_ok and loss_rel <= loss_tol
                      and grad_err[worst] <= grad_tol
                      and losses[-1] < losses[0])}
    _phase(rec)
    train_breakdown(torch, step, params, state, tokens)
    return rec


_FAMILIES = (("flash_fwd", ("flash_fwd_",)),
             ("flash_bwd", ("flash_bwd_",)),
             ("fused_ce", ("ce_fwd_kernel", "ce_fwd_merge", "ce_dx_kernel",
                           "ce_dw_kernel", "sum_ranges")),
             ("paged_attention", ("paged_kernel",)),
             ("decode_attention", ("decode_kernel",)),
             ("int8_matmul", K12_KERNELS),
             ("layer_norm", ("fused_ln_fwd",)))


def _family(name):
    for fam, keys in _FAMILIES:
        if any(k in name for k in keys):
            return fam
    low = name.lower()
    if "memcpy" in low or "memset" in low:
        return "memcpy"
    if any(k in low for k in ("gemm", "sm90", "cutlass", "cublas", "xmma",
                              "nvjet")):
        return "gemm"
    return "other"


def _device_breakdown(prof, wall_us):
    """Device time by kernel family and the busy share of ``wall_us``,
    from a torch.profiler run; None when it recorded no device
    activity (the measurement is then missing, not zero)."""
    from torch.autograd import DeviceType
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return None
    fams, by_name, spans = {}, {}, []
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        fam = _family(e.name)
        fams[fam] = fams.get(fam, 0.0) + dur
        by_name[e.name] = by_name.get(e.name, 0.0) + dur
        spans.append((e.time_range.start, e.time_range.end))
    busy, end = 0.0, float("-inf")
    for s, t in sorted(spans):
        if t > end:
            busy += t - max(s, end)
            end = t
    return {"device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / wall_us,
            "kernel_ms_by_family": {k: v / 1e3 for k, v in fams.items()},
            "top_kernels_ms": {k[:96]: v / 1e3 for k, v in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:8]},
            "kernel_launches": len(kernels)}


def train_breakdown(torch, step, params, state, tokens):
    """One more kernel step under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, loss = step(params, state, tokens)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rec = {"phase": "train_breakdown", "wall_ms": wall_us / 1e3,
           "loss": loss.item()}
    bd = _device_breakdown(prof, wall_us)
    rec["measured"] = bd is not None
    rec.update(bd or {})
    rec["ok"] = bool(torch.isfinite(loss).item())
    _phase(rec)


def teacher_forced(torch, dev, model, reqs, tol=TEACHER_FORCED_TOL):
    """Each emitted token's logit within ``tol`` of its row's maximum
    under a teacher-forced plain forward of ``model`` (plain attention,
    the model's dtype): the serving paths round their bf16 matmuls at
    other shapes (a few decode rows vs one sequence). Returns the worst
    gap, the share of tokens that are the row's argmax, whether every
    logit is finite, and ok."""
    from paddle_tpu_torch.nn.functional import attention_reference
    worst, exact, total = 0.0, 0, 0
    finite = True
    for r in reqs:
        seq = torch.tensor([r.prompt + r.tokens[:-1]], device=dev)
        logits = model(seq, attn=attention_reference)[0].float()
        finite &= bool(torch.isfinite(logits).all().item())
        n = len(r.prompt)
        rows = logits[n - 1:n - 1 + len(r.tokens)]
        toks = torch.tensor(r.tokens, device=dev)[:, None]
        gap = rows.max(dim=1).values - rows.gather(1, toks)[:, 0]
        worst = max(worst, gap.max().item())
        exact += int((gap == 0).sum().item())
        total += len(r.tokens)
    return {"teacher_forced_max_gap": worst, "teacher_forced_tol": tol,
            "teacher_forced_exact_frac": exact / max(1, total),
            "logits_finite": finite, "ok": bool(finite and worst <= tol)}


def _serve_batch(torch, dev, eng, prompts, n_new):
    """One closed batch through ``eng`` with every kernel counter zeroed
    just before and read just after: (requests, wall s, launches, peak
    device memory)."""
    from paddle_tpu_torch import stats
    stats.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counters()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (reqs, wall, _read_counters(),
            torch.cuda.max_memory_allocated(dev))


def _latency(reqs, wall):
    # exact medians over the requests' own timestamps (upper median)
    ttfts = sorted(r.ttft_s for r in reqs)
    tpots = sorted(r.tpot_s for r in reqs)
    n_tok = sum(len(r.tokens) for r in reqs)
    return {"requests": len(reqs), "new_tokens": n_tok, "wall_s": wall,
            "tokens_per_s": n_tok / wall,
            "ttft_p50_s": ttfts[len(ttfts) // 2], "ttft_max_s": ttfts[-1],
            "tpot_p50_s": tpots[len(tpots) // 2], "tpot_max_s": tpots[-1]}


def serving_phase(torch, dev, model=None, mega=False):
    """gpt3_1p3b through the paged engine (phase 4, ``mega=False``: K2
    per layer; phase 12, ``make_engine(model)``'s default single-dispatch
    decode: one K8 and one K9 launch per decode step)."""
    import numpy as np
    from paddle_tpu_torch import stats
    from paddle_tpu_torch.inference.factory import make_engine
    from paddle_tpu_torch.models import gpt

    cfg = gpt.gpt3_1p3b()
    init_s = None
    if model is None:
        t0 = time.perf_counter()
        model = gpt.GPT(cfg, seed=SEED, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
    chunk, n_new = 16, 64
    if mega:
        eng = make_engine(model, n_pages=64, max_slots=8,
                          steps_per_call=chunk)
        if not eng.mega:
            _fail("make_engine(model) did not turn the megakernel on")
    else:
        eng = make_engine(model, n_pages=64, max_slots=8,
                          steps_per_call=chunk, mega=False)
    rs = np.random.RandomState(SEED)
    prompts = [rs.randint(0, cfg.vocab_size, size=128).tolist()
               for _ in range(8)]
    prompts.append(prompts[0][:128]
                   + rs.randint(0, cfg.vocab_size, size=40).tolist())

    reqs, wall, launches, peak = _serve_batch(torch, dev, eng, prompts,
                                              n_new)
    L = cfg.n_layers
    n_suffix = int(stats.get("serve/dispatches/prefill_suffix"))
    n_cold = len(prompts) - n_suffix
    decode_steps = eng.steps * eng.chunk
    per_step = ({"mega_decode_layers": decode_steps,
                 "mega_logits_sample": decode_steps} if mega
                else {"paged_append_attend": L * decode_steps})
    others = set(launches) - set(per_step) - {"flash_attention",
                                              "paged_decode_attention"}
    counts_ok = (launches["flash_attention"] == L * n_cold
                 and all(launches[n] == c for n, c in per_step.items())
                 and launches["paged_decode_attention"] > 0
                 and n_suffix == 1
                 and all(launches[n] == 0 for n in others))
    done_ok = all(r.done and not r.failed and len(r.tokens) == n_new
                  for r in reqs)
    check = teacher_forced(torch, dev, model, reqs)
    rec = {"phase": "serving_mega_gpt3_1p3b" if mega
           else "serving_gpt3_1p3b", "mega": eng.mega,
           "params": cfg.num_params(),
           "layers": L, "d_model": cfg.d_model, "slots": 8,
           "steps_per_call": chunk, "init_s": init_s,
           **_latency(reqs, wall),
           "peak_mem_bytes": peak, "launches": launches,
           "cold_prefills": n_cold, "suffix_prefills": n_suffix,
           "decode_steps": decode_steps, "dispatches": eng.steps,
           "counts_ok": bool(counts_ok), "all_done": bool(done_ok),
           **{k: v for k, v in check.items() if k != "ok"},
           "ok": bool(counts_ok and done_ok and check["ok"])}
    _phase(rec)
    # fresh prompts: a cold batch like the first, not prefix-cache hits
    breakdown_phase(torch, eng, [rs.randint(0, cfg.vocab_size,
                                            size=128).tolist()
                                 for _ in range(8)], n_new,
                    "serving_mega_breakdown" if mega
                    else "serving_breakdown")
    return rec


def contiguous_phase(torch, dev, model):
    """gpt3_1p3b through ``make_engine(engine="contiguous")``; see the
    module docstring (phase 7). Returns (record, engine, requests)."""
    import numpy as np
    from paddle_tpu_torch import stats
    from paddle_tpu_torch.inference.factory import make_engine
    cfg = model.cfg
    chunk, n_new = 16, 64
    eng = make_engine(model, engine="contiguous", max_slots=8,
                      steps_per_call=chunk)
    rs = np.random.RandomState(SEED + 1)
    prompts = [rs.randint(0, cfg.vocab_size, size=128).tolist()
               for _ in range(8)]
    # longer than the largest bucket (512): chunked prefill, 512 + 512 +
    # a 256 bucket, interleaved with the others' decode
    prompts.append(rs.randint(0, cfg.vocab_size, size=1200).tolist())
    reqs, wall, launches, peak = _serve_batch(torch, dev, eng, prompts,
                                              n_new)
    L = cfg.n_layers
    decode_steps = eng.steps * eng.chunk
    chunks = int(stats.get("serve/dispatches/prefill"))
    expected = {n: 0 for n in launches}
    expected["decode_attention"] = L * decode_steps
    counts_ok = launches == expected
    done_ok = all(r.done and not r.failed and len(r.tokens) == n_new
                  for r in reqs)
    check = teacher_forced(torch, dev, model, reqs)
    rec = {"phase": "contiguous_gpt3_1p3b", "engine": "contiguous",
           "cache_len": eng.T, "slots": eng.S, "steps_per_call": chunk,
           "prompt_lens": [len(p) for p in prompts], "buckets": eng.buckets,
           **_latency(reqs, wall), "peak_mem_bytes": peak,
           "launches": launches, "expected_launches": expected,
           "prefill_chunks": chunks, "decode_steps": decode_steps,
           "dispatches": eng.steps, "counts_ok": bool(counts_ok),
           "all_done": bool(done_ok),
           **{k: v for k, v in check.items() if k != "ok"},
           "ok": bool(counts_ok and done_ok and check["ok"])}
    _phase(rec)
    return rec, eng, reqs


def int8_phase(torch, dev, model, donor, bf16_reqs):
    """The int8 engine over the bf16 engine's weights; see the module
    docstring (phase 8). Returns (record, engine)."""
    from paddle_tpu_torch import quantization as quant
    from paddle_tpu_torch import stats
    from paddle_tpu_torch.inference.decode_engine import DecodeEngine
    from paddle_tpu_torch.ops.quant_matmul import int8_matmul_reference
    cfg = model.cfg
    chunk, n_new = donor.chunk, 64
    eng = DecodeEngine(None, share_weights_with=donor, weight_dtype="int8",
                       max_slots=donor.S, max_len=donor.T,
                       steps_per_call=chunk)
    prompts = [r.prompt for r in bf16_reqs]
    reqs, wall, launches, peak = _serve_batch(torch, dev, eng, prompts,
                                              n_new)
    L = cfg.n_layers
    decode_steps = eng.steps * eng.chunk
    chunks = int(stats.get("serve/dispatches/prefill"))
    expected = {n: 0 for n in launches}
    expected["decode_attention"] = L * decode_steps
    expected["int8_matmul"] = 4 * L * (decode_steps + chunks)
    counts_ok = launches == expected
    done_ok = all(r.done and not r.failed and len(r.tokens) == n_new
                  for r in reqs)
    # the same int8 weights (quantize_tensor per layer, as the engine),
    # K12 replaced by its plain version for the teacher-forced forward
    qmodel = quant.quantize_for_inference(model)
    kernel = quant.int8_matmul
    quant.int8_matmul = int8_matmul_reference
    try:
        check = teacher_forced(torch, dev, qmodel, reqs)
    finally:
        quant.int8_matmul = kernel
    del qmodel
    same = sum(a == b for r, rb in zip(reqs, bf16_reqs)
               for a, b in zip(r.tokens, rb.tokens))
    total = sum(len(r.tokens) for r in reqs)
    rec = {"phase": "int8_gpt3_1p3b", "engine": "contiguous",
           "weight_dtype": "int8", **_latency(reqs, wall),
           "peak_mem_bytes": peak, "launches": launches,
           "expected_launches": expected, "prefill_chunks": chunks,
           "decode_steps": decode_steps, "dispatches": eng.steps,
           "counts_ok": bool(counts_ok), "all_done": bool(done_ok),
           **{k: v for k, v in check.items() if k != "ok"},
           "tokens_equal_to_bf16_share": same / max(1, total),
           "ok": bool(counts_ok and done_ok and check["ok"])}
    _phase(rec)
    return rec, eng


def decode_device_phase(torch, eng, name, weight_bytes, head_bytes,
                        n_dispatches=2):
    """Device time per decode step of ``eng``: 8 fresh 128-token prompts
    are admitted first, then ``n_dispatches`` decode dispatches
    (``steps_per_call`` steps each) run under torch.profiler; the
    device's busy time over their decode steps, beside the weight-read
    floor (every block weight and the LM head read once per step)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    cfg = eng.cfg
    rs = np.random.RandomState(SEED + 2)
    reqs = [eng.submit(rs.randint(0, cfg.vocab_size, size=128).tolist(),
                       max_new_tokens=64) for _ in range(eng.S)]
    while eng._waiting or getattr(eng, "_admitting", ()):
        eng.step()
    eng.drain()
    torch.cuda.synchronize()
    steps0 = eng.steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_dispatches):
            eng.step()
        eng.drain()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    decode_steps = (eng.steps - steps0) * eng.chunk
    eng.run()
    floor_ms = (weight_bytes + head_bytes) / H100_BYTES_PER_S * 1e3
    rec = {"phase": f"decode_device_{name}", "slots": eng.S,
           "decode_steps": decode_steps, "wall_ms": wall_us / 1e3,
           "block_weight_bytes": weight_bytes, "lm_head_bytes": head_bytes,
           "weight_read_floor_ms": floor_ms}
    bd = _device_breakdown(prof, wall_us)
    rec["measured"] = bd is not None
    if bd is not None:
        rec.update(bd)
        rec["device_ms_per_decode_step"] = (bd["device_busy_ms"]
                                            / max(1, decode_steps))
        rec["wall_ms_per_decode_step"] = wall_us / 1e3 / max(1,
                                                             decode_steps)
        rec["launches_per_decode_step"] = (bd["kernel_launches"]
                                           / max(1, decode_steps))
    rec["ok"] = bool(decode_steps > 0
                     and all(r.done and not r.failed for r in reqs))
    _phase(rec)
    return rec


def generate_phase(torch, dev, model):
    """``GPT.generate``, greedy, 4 prompts of 128 tokens, 32 new tokens,
    cache 2048; see the module docstring (phase 10)."""
    import numpy as np
    cfg = model.cfg
    B, S0, n_new = 4, 128, 32
    toks = np.random.RandomState(SEED + 3).randint(0, cfg.vocab_size,
                                                   size=(B, S0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counters()
    t0 = time.perf_counter()
    out = model.generate(toks, max_new_tokens=n_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counters()
    peak = torch.cuda.max_memory_allocated(dev)
    expected = {n: 0 for n in launches}
    expected["decode_attention"] = cfg.n_layers * (n_new - 1)

    class _Row:                       # the teacher-forced check's view
        def __init__(self, row):
            self.prompt = row[:S0]
            self.tokens = row[S0:]

    rows = [_Row(r) for r in out.tolist()]
    check = teacher_forced(torch, dev, model, rows)
    rec = {"phase": "generate_gpt3_1p3b", "batch": B, "prompt_len": S0,
           "new_tokens": n_new, "cache_len": cfg.max_seq_len,
           "shape": list(out.shape), "wall_s": wall,
           "tokens_per_s": B * n_new / wall, "peak_mem_bytes": peak,
           "launches": launches, "expected_launches": expected,
           "counts_ok": launches == expected,
           **{k: v for k, v in check.items() if k != "ok"},
           "ok": bool(launches == expected and check["ok"]
                      and tuple(out.shape) == (B, S0 + n_new))}
    _phase(rec)
    return rec


def serving_paths(torch, dev, gen=None):
    """Every serving path on one gpt3_1p3b (seed SEED): K8 and K9 at the
    single-dispatch engine's shapes (phase 11), paged serving per layer
    and its breakdown (phase 4), single-dispatch paged serving and its
    breakdown (12), contiguous bf16 serving (7), int8 serving (8), the
    decode device time of all four engines (9), generate (10). Returns
    (path -> launches, (K8 record, K9 record))."""
    from paddle_tpu_torch.inference.factory import make_engine
    from paddle_tpu_torch.models import gpt
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
    model = gpt.GPT(gpt.gpt3_1p3b(), seed=SEED, device=dev)
    k89 = k89_phase(torch, dev, gen, model)
    torch.cuda.empty_cache()
    serve = serving_phase(torch, dev, model)
    torch.cuda.empty_cache()
    mega = serving_phase(torch, dev, model, mega=True)
    torch.cuda.empty_cache()
    contig, eng, reqs = contiguous_phase(torch, dev, model)
    int8, q8 = int8_phase(torch, dev, model, eng, reqs)
    cfg = model.cfg
    blocks = sum(w[n].numel() for w in eng._layers
                 for n in ("wqkv", "wo", "wup", "wdown"))
    head = cfg.vocab_size * cfg.d_model * 2
    decode_device_phase(torch, eng, "bf16", 2 * blocks, head)
    decode_device_phase(torch, q8, "int8", blocks, head)
    del eng, q8, reqs
    torch.cuda.empty_cache()
    for on in (True, False):
        paged = make_engine(model, n_pages=64, max_slots=8,
                            steps_per_call=16, mega=on)
        decode_device_phase(torch, paged, "paged_mega" if on else "paged",
                            2 * blocks, head)
        del paged
        torch.cuda.empty_cache()
    generated = generate_phase(torch, dev, model)
    return ({"serving": serve["launches"], "serving_mega": mega["launches"],
             "contiguous": contig["launches"], "int8": int8["launches"],
             "generate": generated["launches"]}, k89)


def breakdown_phase(torch, eng, prompts, n_new, name="serving_breakdown"):
    """Where the serving time goes: a second batch through the same
    engine under torch.profiler, the device time of every CUDA kernel
    summed by family, and the device's busy share of the wall time.
    Reports ``measured: false`` when the profiler records no device
    activity (the measurement is then missing, not zero)."""
    from torch.profiler import ProfilerActivity, profile

    reqs = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
    steps0 = eng.steps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rec = {"phase": name, "requests": len(reqs),
           "wall_ms": wall_us / 1e3}
    bd = _device_breakdown(prof, wall_us)
    rec["measured"] = bd is not None
    if bd is not None:
        rec.update(bd)
        rec.update({"decode_steps": (eng.steps - steps0) * eng.chunk,
                    "new_tokens": sum(len(r.tokens) for r in reqs)})
    rec["ok"] = all(r.done and not r.failed for r in reqs)
    _phase(rec)


# ---------------------------------------------------------------------------
# Fifth slice: K11 and the attention bias and dropout of K1/K3/K4, the
# incubate encoder trained at BERT-base width, the Fused* layers
# ---------------------------------------------------------------------------

# K11's per-row statistics against the plain version's: fp32 sums of the
# same row in another order (mean relative to the row's scale, |mean| +
# 1 / rstd, since a row's mean may sit near zero)
LN_STATS_TOL = 1e-5
# the incubate encoder: bert_base (paddle_tpu/models/bert.py:525), post-LN
# blocks of fused_multi_head_attention + fused_feedforward, dropout 0.1
ENC_LAYERS, ENC_D, ENC_HEADS, ENC_FFN = 12, 768, 12, 3072
ENC_B, ENC_S, ENC_P = 16, 512, 0.1
ENC_LENGTHS = (128, 512)          # lengths from 128 to 512, one full row


def mask_check(got_keep, ref_keep):
    """A dropout mask read off a kernel's output against the plain hash
    mask: bit for bit."""
    bad = int((got_keep != ref_keep).sum().item())
    return {"mask_cells": int(ref_keep.numel()), "mask_mismatches": bad,
            "kept_share": ref_keep.float().mean().item(), "ok": bad == 0}


def layer_norm_check(got, ref, got_keep, ref_keep):
    """K11's (y, pre, mean, rstd) against the plain version's: y and pre
    per row (what one block writes) within REL_L2_TOL, mean and rstd
    within LN_STATS_TOL relative, and the mask the kernel applied (read
    as ``pre != 0`` of an all-ones input) equal to the plain mask bit
    for bit."""
    y, pre, mean, rstd = got
    ry, rpre, rmean, rrstd = ref
    scale = rmean.abs() + 1.0 / rrstd
    rec = {"y_row_rel_l2_max": rel_l2(y, ry, (1,)).max().item(),
           "pre_row_rel_l2_max": rel_l2(pre, rpre, (1,)).max().item(),
           "mean_rel_err_max": ((mean - rmean).abs() / scale).max().item(),
           "rstd_rel_err_max": ((rstd - rrstd).abs() / rrstd).max().item(),
           "finite": bool(y.float().isfinite().all().item())}
    m = mask_check(got_keep, ref_keep)
    rec.update({k: v for k, v in m.items() if k != "ok"})
    rec["ok"] = bool(rec["y_row_rel_l2_max"] <= REL_L2_TOL
                     and rec["pre_row_rel_l2_max"] <= REL_L2_TOL
                     and rec["mean_rel_err_max"] <= LN_STATS_TOL
                     and rec["rstd_rel_err_max"] <= LN_STATS_TOL
                     and rec["finite"] and m["ok"])
    return rec


def k11_case(torch, dev, gen, N, M=ENC_B * ENC_S, p=ENC_P, seed=-77):
    """K11 at the encoder's rows (M = 16 x 512), bf16, with bias,
    residual and dropout p, against its plain version; the mask through
    an all-ones input; device times of the kernel, its plain version and
    F.layer_norm on the precomputed sum (the nearest library call: it
    does the LayerNorm half of the work)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import _hash
    from paddle_tpu_torch.ops import layer_norm as ln
    bf = torch.bfloat16
    x = torch.randn((M, N), generator=gen, device=dev).to(bf)
    res = torch.randn((M, N), generator=gen, device=dev).to(bf)
    gamma = (1 + 0.1 * torch.randn(N, generator=gen, device=dev)).to(bf)
    beta = (0.1 * torch.randn(N, generator=gen, device=dev)).to(bf)
    bias = (0.1 * torch.randn(N, generator=gen, device=dev)).to(bf)
    args = (x, gamma, beta, bias, res, seed, 1e-5, p)
    got = ln.fused_layer_norm_fwd(*args)
    ones = torch.ones((M, N), dtype=bf, device=dev)
    probe = ln.fused_layer_norm_fwd(ones, gamma, beta, None, None, seed,
                                    1e-5, p)[1]
    torch.cuda.synchronize()
    ref = ln.fused_layer_norm_reference(*args)
    ref_keep = _hash.layer_norm_keep(seed, (M, N), p, device=dev)
    check = layer_norm_check(got, ref, probe != 0, ref_keep)
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(got[:2], ref[:2]))
    del probe, ref_keep, ones
    ms = _device_ms(torch, lambda: ln.fused_layer_norm_fwd(*args),
                    keys=("fused_ln_fwd",))
    plain_ms = _event_ms(torch, lambda: ln.fused_layer_norm_reference(
        *args), iters=5, warmup=1)
    pre = ref[1]
    lib_ms = _device_ms(torch, lambda: F.layer_norm(pre, (N,), gamma,
                                                    beta))
    elt = x.element_size()
    # x and residual read, y and pre written, the stats and the vectors
    nbytes = 4 * M * N * elt + 2 * M * 4 + 3 * N * elt
    bound_ms, bound_by = _bound(nbytes, 0, (HASH_OPS + 10) * M * N)
    rec = {"phase": f"k11_fused_layer_norm_N{N}", "M": M, "N": N,
           "dtype": "bfloat16", "dropout_p": p, "seed": seed,
           "max_abs_err": err, **{k: v for k, v in check.items()
                                  if k != "ok"},
           "tol_rel_l2": REL_L2_TOL, "stats_tol": LN_STATS_TOL,
           "kernel_ms": ms, "plain_ms": plain_ms,
           "library_ms": lib_ms, "library": "F.layer_norm(pre)",
           "bound_ms": bound_ms, "bound_by": bound_by,
           "ok": bool(check["ok"] and ms is not None)}
    _phase(rec)
    return rec


def attention_bias_dropout_check(o, ref_o, grads, ref_grads, bias_grad):
    """K1's output and K3/K4's (dq, dk, dv) with a bias and dropout
    against the plain versions', per 64-row tile within REL_L2_TOL, and
    no gradient reaching the bias (it is a constant, as in JAX)."""
    rec = attention_grads_check(grads, ref_grads)
    rec["o_tile_rel_l2_max"] = tile_rel_l2(o, ref_o)[0]
    rec["bias_grad_is_none"] = bias_grad is None
    rec["ok"] = bool(rec["ok"] and rec["o_tile_rel_l2_max"] <= REL_L2_TOL
                     and rec["bias_grad_is_none"])
    return rec


def dropout_pattern(torch, q, k, seed, p, D):
    """The keep mask K1 applied, read through its output: V one-hot over
    a window of D keys (v[key] = e_(key - w)), no bias, so o[b, i, h, j]
    is the dropped p of key w + j over the row's normaliser, zero
    exactly where the cell was dropped. Returns (B, Hq, Sq, Sk) bool."""
    from paddle_tpu_torch.ops.flash_attention import flash_attention
    B, Sk, Hkv, _ = k.shape
    eye = torch.eye(D, dtype=q.dtype, device=q.device)
    cols = []
    for w in range(0, Sk, D):
        n = min(D, Sk - w)
        v = torch.zeros_like(k)
        v[:, w:w + n] = eye[:n][None, :, None, :]
        o = flash_attention(q, k, v, dropout_p=p, dropout_seed=seed)
        cols.append((o[..., :n] != 0).permute(0, 2, 1, 3))
    return torch.cat(cols, dim=-1)


def attention_case(torch, dev, gen, name, Sk=ENC_S, bias_kind="padding",
                   B=ENC_B, Sq=ENC_S, H=ENC_HEADS, D=ENC_D // ENC_HEADS,
                   p=ENC_P, seed=12345):
    """K1, K3, K4 with an additive bias and hash dropout at the encoder's
    shape: ``padding`` is the (B, 1, 1, Sk) key mask of lengths 128..Sk
    alone, as the encoder passes it (the kernels walk every key tile);
    ``padding_kv_lens`` the same mask with kv_lens (tiles past a length
    are skipped); ``full`` a (B, H, Sq, Sk) random bias. Checks
    (``attention_bias_dropout_check``) against the plain versions; the
    mask read through one-hot V (``dropout_pattern``) against the plain
    hash; times of the kernels, the plain versions and sdpa with the same
    float mask and dropout (its own mask: for scale only)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import _hash
    from paddle_tpu_torch.ops import flash_attention as fa
    bf = torch.bfloat16
    q = (0.5 * torch.randn((B, Sq, H, D), generator=gen, device=dev)).to(bf)
    k = (0.5 * torch.randn((B, Sk, H, D), generator=gen, device=dev)).to(bf)
    v = torch.randn((B, Sk, H, D), generator=gen, device=dev).to(bf)
    do = torch.randn((B, Sq, H, D), generator=gen, device=dev).to(bf)
    kv_lens = None
    if bias_kind in ("padding", "padding_kv_lens"):
        lens = torch.linspace(ENC_LENGTHS[0], Sk, B, device=dev).round()
        visible = torch.arange(Sk, device=dev)[None, :] < lens[:, None]
        bias = torch.where(visible, 0.0, -1e30)[:, None, None, :]
        # the (query, key) pairs the kernels walk: up to each length
        # with kv_lens, every pair with the bias alone
        pairs = B * H * Sq * Sk
        if bias_kind == "padding_kv_lens":
            kv_lens = lens.to(torch.int32)
            pairs = H * Sq * int(lens.sum().item())
    else:
        bias = torch.randn((B, H, Sq, Sk), generator=gen, device=dev)
        pairs = B * H * Sq * Sk
    kw = dict(kv_lens=kv_lens, bias=bias, dropout_p=p, dropout_seed=seed)
    # a bias that asks for a gradient must get none
    bias_leaf = bias.clone().requires_grad_()
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    o = fa.flash_attention(qg, kg, vg, **{**kw, "bias": bias_leaf})
    o.backward(do)
    o = o.detach()
    grads = (qg.grad, kg.grad, vg.grad)
    torch.cuda.synchronize()
    qf, kf, vf = (t.float().requires_grad_() for t in (q, k, v))
    ro = fa.flash_attention_plain(qf, kf, vf, **kw)
    ref_grads = torch.autograd.grad(ro, (qf, kf, vf), do.float())
    check = attention_bias_dropout_check(o, ro.detach(), grads, ref_grads,
                                         bias_leaf.grad)
    err = max([(o.float() - ro).abs().max().item()]
              + [(g.float() - r).abs().max().item()
                 for g, r in zip(grads, ref_grads)])
    del qf, kf, vf, ro, ref_grads, grads
    stride = _hash.jax_key_stride(Sk)
    pattern = mask_check(dropout_pattern(torch, q, k, seed, p, D),
                         _hash.attention_keep(seed, B, H, Sq, Sk, p, stride,
                                              device=dev))
    # times: each kernel alone on the forward's own (o, lse)
    b4 = fa.attention_bias(bias, B, H, Sq, Sk)
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    delta = fa._delta(o, do)
    scale = D ** -0.5
    drop = (p, seed)
    k1_ms = _device_ms(torch, lambda: fa.flash_attention(q, k, v, **kw),
                       keys=("flash_fwd_",))
    k3_ms = _device_ms(torch, lambda: fa.flash_attention_bwd_dkdv(
        q, k, v, do, lse, delta, False, scale, kv_lens, b4, *drop),
        keys=("flash_bwd_dkdv",))
    k4_ms = _device_ms(torch, lambda: fa.flash_attention_bwd_dq(
        q, k, v, do, lse, delta, False, scale, kv_lens, b4, *drop),
        keys=("flash_bwd_dq",))
    plain_fwd_ms = _event_ms(torch, lambda: fa.flash_attention_reference(
        q, k, v, False, scale, kv_lens, b4, *drop), iters=3, warmup=1)
    plain_bwd_ms = _event_ms(torch, lambda: fa.flash_attention_bwd_reference(
        q, k, v, o, lse, do, False, scale, kv_lens, b4, *drop), iters=3,
        warmup=1)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    mask = bias.to(bf)
    lib_fwd_ms = _event_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, dropout_p=p))
    ot = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                        dropout_p=p)
    dot = do.transpose(1, 2).contiguous()
    lib_bwd_ms = _event_ms(torch, lambda: torch.autograd.grad(
        ot, (qt, kt, vt), dot, retain_graph=True), iters=5, warmup=1)
    del qt, kt, vt, ot
    elt = q.element_size()
    q_bytes = B * Sq * H * D * elt
    kv_bytes = B * Sk * H * D * elt
    rows = B * H * Sq * 4
    bias_bytes = bias.numel() * 4
    cells = pairs
    k1_bound = _bound(2 * q_bytes + 2 * kv_bytes + rows + bias_bytes,
                          4 * D * pairs, HASH_OPS * cells)
    k3_bound = _bound(2 * q_bytes + 4 * kv_bytes + 2 * rows
                          + bias_bytes, 8 * D * pairs, HASH_OPS * cells)
    k4_bound = _bound(3 * q_bytes + 2 * kv_bytes + 2 * rows
                          + bias_bytes, 6 * D * pairs, HASH_OPS * cells)
    rec = {"phase": f"k134_bias_dropout_{name}", "B": B, "Sq": Sq, "Sk": Sk,
           "H": H, "D": D, "dtype": "bfloat16", "bias": bias_kind,
           "bias_shape": list(bias.shape), "kv_lens": kv_lens is not None,
           "dropout_p": p, "mask_stride": stride, "max_abs_err": err,
           **{kk: vv for kk, vv in check.items() if kk != "ok"},
           "pattern": pattern, "tol_rel_l2": REL_L2_TOL,
           "k1_ms": k1_ms, "k3_ms": k3_ms, "k4_ms": k4_ms,
           "plain_fwd_ms": plain_fwd_ms, "plain_bwd_ms": plain_bwd_ms,
           "library_fwd_ms": lib_fwd_ms, "library_bwd_ms": lib_bwd_ms,
           "library": "sdpa, same float mask, its own dropout mask",
           "k1_bound_ms": k1_bound[0], "k1_bound_by": k1_bound[1],
           "k3_bound_ms": k3_bound[0], "k3_bound_by": k3_bound[1],
           "k4_bound_ms": k4_bound[0], "k4_bound_by": k4_bound[1],
           "ok": bool(check["ok"] and pattern["ok"]
                      and None not in (k1_ms, k3_ms, k4_ms))}
    _phase(rec)
    return rec


@contextlib.contextmanager
def plain_kernels():
    """Inside: the incubate path's kernels swapped for their plain
    versions (attention through ``flash_attention_plain``, K11 through
    ``fused_layer_norm_plain``), so a step runs the same function with
    no kernel launched."""
    from paddle_tpu_torch.nn.functional import attention as attn_mod
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import layer_norm as ln
    saved = attn_mod.flash_attention, ln.fused_layer_norm
    attn_mod.flash_attention = fa.flash_attention_plain
    ln.fused_layer_norm = ln.fused_layer_norm_plain
    try:
        yield
    finally:
        attn_mod.flash_attention, ln.fused_layer_norm = saved


def encoder_weights(torch, dev, L, d, h, ffn, seed=SEED, dtype=None):
    """The encoder's parameters, JAX layouts, drawn from ``seed``
    (std 0.02, LayerNorms at ones and zeros) as trainable leaves:
    block i's names are ``<i>.<argument of the incubate functional>``."""
    dtype = dtype or torch.bfloat16
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def leaf(t):
        return t.to(dtype).requires_grad_()

    def normal(*shape):
        return leaf(0.02 * torch.randn(shape, generator=g, device=dev))

    w = {}
    for i in range(L):
        w.update({
            f"{i}.qkv_weight": normal(3, h, d // h, d),
            f"{i}.qkv_bias": normal(3, h, d // h),
            f"{i}.linear_weight": normal(d, d),
            f"{i}.linear_bias": normal(d),
            f"{i}.ln_scale": leaf(torch.ones(d, device=dev)),
            f"{i}.ln_bias": leaf(torch.zeros(d, device=dev)),
            f"{i}.linear1_weight": normal(d, ffn),
            f"{i}.linear1_bias": normal(ffn),
            f"{i}.linear2_weight": normal(ffn, d),
            f"{i}.linear2_bias": normal(d),
            f"{i}.ln2_scale": leaf(torch.ones(d, device=dev)),
            f"{i}.ln2_bias": leaf(torch.zeros(d, device=dev))})
    return w


def encoder_forward(w, x, mask, gen, n_layers, p=ENC_P, training=True):
    """The post-LN encoder through the incubate functionals: per block
    ``fused_multi_head_attention`` (K1 with the padding bias and hash
    dropout, K11 for the bias-dropout-residual-LN tail) then
    ``fused_feedforward`` (GELU, generator dropout, post-LN)."""
    from paddle_tpu_torch.incubate.nn import functional as IF
    for i in range(n_layers):
        b = {n.split(".", 1)[1]: t for n, t in w.items()
             if n.startswith(f"{i}.")}
        x = IF.fused_multi_head_attention(
            x, b["qkv_weight"], b["linear_weight"], pre_layer_norm=False,
            ln_scale=b["ln_scale"], ln_bias=b["ln_bias"],
            qkv_bias=b["qkv_bias"], linear_bias=b["linear_bias"],
            attn_mask=mask, dropout_rate=p, attn_dropout_rate=p,
            training=training, generator=gen)
        x = IF.fused_feedforward(
            x, b["linear1_weight"], b["linear2_weight"],
            b["linear1_bias"], b["linear2_bias"], ln2_scale=b["ln2_scale"],
            ln2_bias=b["ln2_bias"], dropout1_rate=p, dropout2_rate=p,
            activation="gelu", training=training, generator=gen)
    return x


def encoder_step_check(loss, plain_loss, grad_err, loss_tol=1e-3,
                       grad_tol=2.5e-2):
    """Step 1 through the kernels against step 1 through the plain
    versions (same weights, same generator states): the losses within
    ``loss_tol`` relative, every gradient within ``grad_tol`` relative
    L2 (bf16 roundings at other places, through 12 blocks)."""
    worst = max(grad_err, key=grad_err.get)
    rec = {"step1_loss_rel_err": abs(loss - plain_loss) / abs(plain_loss),
           "grad_rel_l2_max": grad_err[worst], "grad_rel_l2_worst": worst,
           "loss_tol_rel": loss_tol, "grad_tol_rel_l2": grad_tol}
    rec["ok"] = bool(rec["step1_loss_rel_err"] <= loss_tol
                     and grad_err[worst] <= grad_tol)
    return rec


def encoder_phase(torch, dev, n_steps=6, n_layers=ENC_LAYERS):
    """The slice's main path: the BERT-base-width incubate encoder
    trained with dropout; see the module docstring (phase 15)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.optimizer import AdamW

    B, S, d = ENC_B, ENC_S, ENC_D
    w = encoder_weights(torch, dev, n_layers, d, ENC_HEADS, ENC_FFN)
    data = torch.Generator(device=dev)
    data.manual_seed(SEED)
    x = torch.randn((B, S, d), generator=data, device=dev).to(
        torch.bfloat16)
    target = torch.randn((B, S, d), generator=data, device=dev)
    lens = torch.linspace(ENC_LENGTHS[0], ENC_LENGTHS[1], B,
                          device=dev).round()
    valid = torch.arange(S, device=dev)[None, :] < lens[:, None]
    mask = valid[:, None, None, :]            # bool, True = visible
    gen = torch.Generator(device=dev)
    start = {n: t.detach().clone() for n, t in w.items()}

    def optimizer():
        opt = AdamW(learning_rate=1e-3, weight_decay=0.01)
        return opt, opt.init(w)

    def step(opt, state):
        for t in w.values():
            t.grad = None
        out = encoder_forward(w, x, mask, gen, n_layers)
        err = (out.float() - target).square().mean(-1)
        loss = (err * valid).sum() / valid.sum()
        loss.backward()
        _, state = opt.update({n: t.grad for n, t in w.items()}, state, w)
        return loss, state

    # step 1 through the plain versions, then from the same weights and
    # generator state through the kernels
    opt, state = optimizer()
    gen.manual_seed(SEED + 1)
    _zero_counters()
    with plain_kernels():
        loss, _ = step(opt, state)
    plain_launches = _read_counters()
    plain_loss = loss.item()
    plain_grads = {n: t.grad.detach().clone() for n, t in w.items()}
    with torch.no_grad():
        for n, t in w.items():
            t.copy_(start[n])
    del start
    opt, state = optimizer()
    gen.manual_seed(SEED + 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counters()
    losses, step_s, grad_err = [], [], {}
    for i in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, state = step(opt, state)
        losses.append(loss.item())
        step_s.append(time.perf_counter() - t0)
        if i == 0:
            for n, t in w.items():
                ref = plain_grads[n].float()
                grad_err[n] = ((t.grad.float() - ref).norm()
                               / ref.norm().clamp(min=1e-30)).item()
            del plain_grads
    launches = _read_counters()
    peak = torch.cuda.max_memory_allocated(dev)
    per_step = {n: c / n_steps for n, c in launches.items()}
    expected = {n: 0 for n in launches}
    expected.update({"flash_attention": n_layers,
                     "flash_attention_bwd_dkdv": n_layers,
                     "flash_attention_bwd_dq": n_layers,
                     "fused_layer_norm": n_layers})
    counts_ok = all(per_step[n] == e for n, e in expected.items())
    plain_ok = not any(plain_launches.values())
    check = encoder_step_check(losses[0], plain_loss, grad_err)
    timed = sorted(step_s[1:])               # step 1 pays first-use costs
    med = timed[len(timed) // 2]
    tok_s = B * S / med
    n_params = sum(t.numel() for t in w.values())
    flops_tok = 6 * n_params + 12 * n_layers * d * S
    # one more step under the profiler: where the time goes
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss, state = step(opt, state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    bd = _device_breakdown(prof, wall_us)
    rec = {"phase": "encoder_train_bert_base", "card": _card_line(),
           "layers": n_layers,
           "d_model": d, "heads": ENC_HEADS, "ffn": ENC_FFN, "batch": B,
           "seq": S, "dropout": ENC_P, "lengths": lens.int().tolist(),
           "params": n_params, "plain_step1_loss": plain_loss,
           "plain_launches": plain_launches, "losses": losses,
           **{k: v for k, v in check.items() if k != "ok"},
           "step_s": step_s, "step_ms_median": med * 1e3,
           "tokens_per_s": tok_s, "flops_per_token": flops_tok,
           "mfu": flops_tok * tok_s / H100_BF16_FLOPS,
           "peak_mem_bytes": peak, "launches": launches,
           "launches_per_step": per_step, "expected_per_step": expected,
           "counts_ok": bool(counts_ok),
           "breakdown_wall_ms": wall_us / 1e3,
           "breakdown_measured": bd is not None, "breakdown": bd,
           "ok": bool(check["ok"] and counts_ok and plain_ok
                      and all(np.isfinite(losses))
                      and losses[-1] < losses[0])}
    _phase(rec)
    return rec


# fp32 through two layers, the attention of one new row (Sq 1) against a
# row of the full causal forward: sums in another order
CACHED_DECODE_TOL = 1e-4


def cached_decode_check(steps, full):
    """The cached decode's per-token outputs against the full forward's
    rows at the same positions, per row within CACHED_DECODE_TOL."""
    rows = rel_l2(steps.reshape(-1, steps.shape[-1]),
                  full.reshape(-1, full.shape[-1]), (1,))
    rec = {"row_rel_l2_max": rows.max().item(),
           "tol_rel_l2": CACHED_DECODE_TOL}
    rec["ok"] = bool(rec["row_rel_l2_max"] <= CACHED_DECODE_TOL)
    return rec


def fused_layers_phase(torch, dev, n_new=4, prompt=128):
    """The incubate layers on the card, in fp32 at BERT-base width:
    ``FusedBiasDropoutResidualLayerNorm`` in eval equals the plain
    LayerNorm of residual + x + bias; ``FusedMultiTransformer`` (two
    pre-LN layers) decoding ``n_new`` tokens one at a time after a
    ``prompt``-token prefill through its caches matches its full causal
    forward (``cached_decode_check``). Counts K1 and K11 launches."""
    import torch.nn.functional as F
    from paddle_tpu_torch.incubate import nn as inn
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    d = ENC_D
    _zero_counters()
    ln = inn.FusedBiasDropoutResidualLayerNorm(d, dropout_rate=ENC_P,
                                               device=dev, generator=g)
    with torch.no_grad():
        for t in ln.parameters():
            t.copy_(torch.randn(t.shape, generator=g, device=dev))
    x, res = (torch.randn((ENC_B, 64, d), generator=g, device=dev)
              for _ in range(2))
    with torch.no_grad():
        got = ln.eval()(x, res)
        want = F.layer_norm(res + x + ln.bias, (d,), ln.weight,
                            ln.norm_bias, ln.epsilon)
    ln_err = rel_l2(got.reshape(-1, d), want.reshape(-1, d), (1,)).max()
    mt = inn.FusedMultiTransformer(d, ENC_HEADS, ENC_FFN, num_layers=2,
                                   device=dev, generator=g).eval()
    total = prompt + n_new
    toks = torch.randn((2, total, d), generator=g, device=dev)
    causal = torch.ones((total, total), dtype=torch.bool,
                        device=dev).tril()
    with torch.no_grad():
        caches = mt.gen_cache(toks)
        _, caches = mt(toks[:, :prompt], attn_mask=causal[:prompt, :prompt],
                       caches=caches)
        steps = []
        for t in range(prompt, total):
            out, caches = mt(toks[:, t:t + 1], caches=caches)
            steps.append(out)
        full = mt(toks, attn_mask=causal)
    torch.cuda.synchronize()
    launches = _read_counters()
    check = cached_decode_check(torch.cat(steps, 1), full[:, prompt:])
    expected = {n: 0 for n in launches}
    # K11 once; K1 per layer for the prefill, each new token, the full
    expected.update({"fused_layer_norm": 1,
                     "flash_attention": 2 * (n_new + 2)})
    counts_ok = launches == expected
    rec = {"phase": "incubate_fused_layers", "d_model": d,
           "ln_eval_row_rel_l2_max": ln_err.item(),
           "ln_tol_rel_l2": CACHED_DECODE_TOL, "prompt": prompt,
           "new_tokens": n_new, "cached_decode": check,
           "launches": launches, "expected": expected,
           "ok": bool(ln_err.item() <= CACHED_DECODE_TOL and check["ok"]
                      and counts_ok)}
    _phase(rec)
    return rec


# ---------------------------------------------------------------------------
# Sixth slice: K13, and the serving engines' own instrumentation through
# paddle_tpu_torch.tools.profile_decode at gpt3_1p3b
# ---------------------------------------------------------------------------

def _readback_us(torch, fn, x, iters=64):
    """Median microseconds of ``fn(x)`` followed by a scalar readback,
    the round ``devprof.pallas_launch_tax_s`` times (one untimed round
    first)."""
    float(fn(x).reshape(-1)[0])
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        float(fn(x).reshape(-1)[0])
        samples.append(time.perf_counter() - t0)
    return sorted(samples)[iters // 2] * 1e6


def k13_phase(torch, dev, gen):
    """K13, the launch probe (phase 17): its output equal to its input
    bit for bit, its counter equal to the launches made, its device time
    beside its bound, and the launch tax it meters
    (``pallas_launch_tax_s``) beside ``launch_tax_s``'s x + 1 and the
    same readback round around ``clone``."""
    from paddle_tpu_torch.observability import devprof
    from paddle_tpu_torch.ops.launch_probe import (noop_copy,
                                                   noop_copy_cost,
                                                   noop_copy_reference)
    x = torch.randn((8, 128), generator=gen, device=dev)
    n0 = noop_copy.launches
    ys = [noop_copy(x) for _ in range(3)]
    torch.cuda.synchronize()
    exact = all(torch.equal(y, x) for y in ys)
    counted = noop_copy.launches - n0
    ms = _device_ms(torch, lambda: noop_copy(x), ("noop_copy",))
    clone_ms = _device_ms(torch, lambda: noop_copy_reference(x))
    probe_us = devprof.pallas_launch_tax_s(force=True) * 1e6
    add_us = devprof.launch_tax_s(force=True, device=dev) * 1e6
    clone_us = _readback_us(torch, noop_copy_reference, x)
    flops, nbytes = noop_copy_cost()
    bound_ms, bound_by = _bound(nbytes, flops)
    rec = {"phase": "k13_launch_probe", "shape": [8, 128],
           "dtype": "float32", "exact": exact, "launches_made": 3,
           "launches_counted": counted, "kernel_ms": ms,
           "plain_ms": clone_ms, "library_ms": clone_ms,
           "timing": "device time (torch.profiler); plain and library: "
                     "x.clone(), one measurement",
           "launch_tax_probe_us": probe_us, "launch_tax_add_us": add_us,
           "launch_tax_clone_us": clone_us,
           "launch_tax": "median wall time of a launch and a scalar "
                         "readback (devprof.pallas_launch_tax_s, "
                         "launch_tax_s, the same round around clone)",
           "max_abs_err": 0.0 if exact else None,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "ok": bool(exact and counted == 3
                      and None not in (ms, clone_ms))}
    _phase(rec)
    return rec


# the roofline fraction a sound count can reach: a measured rate past
# the analytic bound means dispatch_cost counted too much
ROOFLINE_FRAC_MAX = 1.05
SLICE_KERNELS = ("flash_attention", "paged_append_attend",
                 "paged_decode_attention", "decode_attention",
                 "mega_decode_layers", "mega_logits_sample", "noop_copy")


def _slice_prompts(cfg, n=8, length=128, seed=SEED + 4):
    import numpy as np
    rs = np.random.RandomState(seed)
    return [rs.randint(0, cfg.vocab_size, size=length).tolist()
            for _ in range(n)]


def fault_check(torch, model, out_dir):
    """One poisoned slot of a single-dispatch engine: ``faults.inject``
    NaNs slot 3's logits for one dispatch. Only that request is evicted
    (``serve/nonfinite_evictions`` = 1), the others finish with the
    streams of the same batch served clean, and its flight dump (written
    under ``PT_TRACE_DIR``) runs from ``admit`` to ``evicted``."""
    import glob
    import os
    from paddle_tpu_torch import stats
    from paddle_tpu_torch.inference.factory import make_engine
    from paddle_tpu_torch.testing import faults
    prompts = _slice_prompts(model.cfg)
    runs = {}
    for poisoned in (False, True):
        eng = make_engine(model, n_pages=64, max_slots=8,
                          steps_per_call=16)
        stats.reset("serve/")
        tag = "poisoned" if poisoned else "clean"
        reqs = [eng.submit(pr, max_new_tokens=64, req_id=f"{tag}-{i}")
                for i, pr in enumerate(prompts)]
        if poisoned:
            with faults.inject("engine.poison_logits", "nan", slot=3,
                               after=1, count=1):
                eng.run()
        else:
            eng.run()
        runs[poisoned] = (reqs, int(stats.get("serve/nonfinite_evictions")))
        del eng
    clean, poisoned = runs[False][0], runs[True][0]
    others = [i for i in range(len(prompts)) if i != 3]
    dumps = glob.glob(os.path.join(out_dir,
                                   f"flight_poisoned-3.{os.getpid()}.json"))
    events = []
    if dumps:
        with open(dumps[0]) as f:
            events = [e["event"] for e in json.load(f)["events"]]
    rec = {"evicted_error": poisoned[3].error,
           "evicted_tokens": len(poisoned[3].tokens),
           "nonfinite_evictions": runs[True][1],
           "clean_nonfinite_evictions": runs[False][1],
           "others_equal_clean": all(poisoned[i].tokens == clean[i].tokens
                                     for i in others),
           "others_done": all(poisoned[i].done and not poisoned[i].failed
                              and len(poisoned[i].tokens) == 64
                              for i in others),
           "flight_events": events}
    rec["ok"] = bool(poisoned[3].error == "non-finite logits"
                     and runs[True][1] == 1 and runs[False][1] == 0
                     and rec["others_equal_clean"] and rec["others_done"]
                     and events[:1] == ["admit"]
                     and events[-1:] == ["evicted"])
    return rec


def warmup_check(torch, model):
    """TTFT of the first request of a batch, on a single-dispatch engine
    built cold and one built with ``warmup=True``; no kernel library is
    loaded inside either timed window. In one process both engines find
    every library and shape already used by earlier phases: the gap is
    what the engine itself pays on first use."""
    from paddle_tpu_torch import stats
    from paddle_tpu_torch.inference.factory import make_engine
    from paddle_tpu_torch.ops import _build
    prompts = _slice_prompts(model.cfg, seed=SEED + 5)
    rec = {}
    for warm in (False, True):
        stats.reset("serve/")
        t0 = time.perf_counter()
        eng = make_engine(model, n_pages=64, max_slots=8,
                          steps_per_call=16, warmup=warm)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        libs = _build.loaded()
        reqs = [eng.submit(pr, max_new_tokens=16) for pr in prompts]
        eng.run()
        torch.cuda.synchronize()
        rec["warm" if warm else "cold"] = {
            "engine_build_s": build_s,
            "warmup_s": stats.snapshot("serve/warmup_s").get(
                "serve/warmup_s.sum") if warm else None,
            "first_ttft_s": reqs[0].ttft_s,
            "ttft_p50_s": sorted(r.ttft_s for r in reqs)[len(reqs) // 2],
            "libraries_loaded_in_window": sorted(
                set(_build.loaded()) - set(libs))}
        del eng
    rec["warmup_recorded"] = stats.get("serve/warmup_s") == 1
    rec["ok"] = bool(rec["warmup_recorded"] and not any(
        rec[k]["libraries_loaded_in_window"] for k in ("cold", "warm")))
    return rec


def trace_check(torch, model, out_dir):
    """Tracing cost and the trace file: the same batch through a
    single-dispatch engine with tracing off, on, on, off (ms per decode
    step of each), then the ring exported where ``PT_TRACE_DIR`` points
    and parsed back: it must hold ``serve/dispatch`` and
    ``serve/harvest`` spans."""
    import os
    from paddle_tpu_torch.inference.factory import make_engine
    from paddle_tpu_torch.observability import trace
    prompts = _slice_prompts(model.cfg, seed=SEED + 6)
    eng = make_engine(model, n_pages=64, max_slots=8, steps_per_call=16)
    per_step = {"off": [], "on": []}
    trace.clear()
    for on in (False, True, True, False):
        if on:
            trace.enable()
        steps0 = eng.steps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for pr in prompts:
            eng.submit(pr, max_new_tokens=64)
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        trace.disable()
        per_step["on" if on else "off"].append(
            wall * 1e3 / max(1, (eng.steps - steps0) * eng.chunk))
    path = trace.export()
    trace.clear()
    names = set()
    if path is not None:
        with open(path) as f:
            names = {e["name"] for e in json.load(f)["traceEvents"]}
    del eng
    rec = {"ms_per_decode_step_off": per_step["off"],
           "ms_per_decode_step_on": per_step["on"],
           "trace_file": None if path is None
           else os.path.relpath(path),
           "span_names": sorted(names)}
    rec["ok"] = bool({"serve/dispatch", "serve/harvest"} <= names)
    return rec


def slice_phase(torch, dev):
    """The sixth slice at full width (phase 18): gpt3_1p3b from seed 0
    through ``paddle_tpu_torch.tools.profile_decode``'s sections, called
    in this process with every kernel counter zeroed just before and
    read just after: ``prof`` (contiguous and single-dispatch paged,
    prompts of 128, 512 and 1024 tokens, 8 slots, 64 new tokens, chunk
    32), ``mega``, then ``fault_check``, ``warmup_check`` and
    ``trace_check``. Returns the record (its ``launches`` is the slice
    path's)."""
    import os
    from paddle_tpu_torch.tools import profile_decode as pd
    out_dir = os.path.abspath(os.path.join("build", "traces"))
    old = os.environ.get("PT_TRACE_DIR")
    os.environ["PT_TRACE_DIR"] = out_dir
    try:
        model = pd.build_model("1p3b", dev)
        torch.cuda.synchronize()
        _zero_counters()
        rows = pd.prof_section(model, "1p3b", lengths=[128, 512, 1024])
        mega = pd.mega_section(model, "1p3b")
        fault = fault_check(torch, model, out_dir)
        warm = warmup_check(torch, model)
        traced = trace_check(torch, model, out_dir)
        launches = _read_counters()
    finally:
        if old is None:
            os.environ.pop("PT_TRACE_DIR", None)
        else:
            os.environ["PT_TRACE_DIR"] = old
    rows_ok = all(0 < r["roofline_frac"] <= ROOFLINE_FRAC_MAX
                  and 0 < r["launch_tax_frac"] <= 1 and r["step"]
                  for r in rows)
    launched = all(launches[n] > 0 for n in SLICE_KERNELS)
    mega_ok = (mega["mega"] <= 2
               and mega["per_layer"] == model.cfg.n_layers)
    rec = {"phase": "slice_profile_decode_gpt3_1p3b", "prof": rows,
           "roofline_frac_max": ROOFLINE_FRAC_MAX,
           "mega_launches_per_step": mega, "fault": fault,
           "warmup": warm, "trace": traced, "launches": launches,
           "launched_on_path": list(SLICE_KERNELS),
           "rows_ok": bool(rows_ok), "launched_ok": bool(launched),
           "ok": bool(rows_ok and launched and mega_ok and fault["ok"]
                      and warm["ok"] and traced["ok"])}
    _phase(rec)
    return rec



def main():
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    try:
        import paddle_tpu_torch  # noqa: F401
        from paddle_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card_line()
    print(json.dumps({"phase": "device", "card": card,
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(json.dumps({"phase": "build",
                      "seconds": time.perf_counter() - t0,
                      "kernels": sorted(libs)}), flush=True)

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    k1 = [k1_case(torch, dev, S, hkv, gen)
          for S, hkv in ((128, 16), (512, 16), (512, 4))]
    k2 = [k2_fused_case(torch, dev, gen, hkv) for hkv in (16, 4)]
    mixed = [0, 1, 127, 128, 255, 64, 200, 17]
    k2p = [k2_plain_case(torch, dev, gen, hkv, mixed) for hkv in (16, 4)]
    # the suffix prefill's shape: 64 query rows (bucket) over one
    # sequence, row t seeing min(129 + t, 168) tokens
    k2p.append(k2_plain_case(torch, dev, gen, 16,
                             [min(129 + t, 168) for t in range(64)],
                             table_rows=True, name="_suffix"))
    # the train path's shapes
    k1.append(k1_case(torch, dev, 2048, 16, gen, B=4))
    k34 = [k34_case(torch, dev, gen, hkv) for hkv in (16, 4)]
    k567 = ce_case(torch, dev, gen)
    # the contiguous engine's shapes
    k10 = [k10_case(torch, dev, gen, hkv) for hkv in (16, 4)]
    k12 = k12_case(torch, dev, gen)
    # the incubate encoder's shapes: K11, and K1/K3/K4 with the padding
    # bias as the encoder passes it (first), the same with kv_lens, a
    # full bias, and Sk 600 (the mask's stride 1024)
    k11 = [k11_case(torch, dev, gen, N) for N in (ENC_D, 1024, 1000)]
    k134 = [attention_case(torch, dev, gen, "padding"),
            attention_case(torch, dev, gen, "padding_kv_lens",
                           bias_kind="padding_kv_lens"),
            attention_case(torch, dev, gen, "full", bias_kind="full"),
            attention_case(torch, dev, gen, "sk600", Sk=600)]
    k13 = k13_phase(torch, dev, gen)
    torch.cuda.empty_cache()
    paths, (k8, k9) = serving_paths(torch, dev, gen)
    torch.cuda.empty_cache()
    train = train_phase(torch, dev)
    paths["train"] = train["launches"]
    torch.cuda.empty_cache()
    paths["encoder"] = encoder_phase(torch, dev)["launches"]
    torch.cuda.empty_cache()
    paths["fused_layers"] = fused_layers_phase(torch, dev)["launches"]
    torch.cuda.empty_cache()
    paths["slice"] = slice_phase(torch, dev)["launches"]

    def entry(name, source, replaces, ms, plain_ms, bound, library_ms,
              err, counter=None, only=None):
        by_path = {p: launches[counter or name]
                   for p, launches in paths.items()
                   if only is None or p == only}
        return {"name": name, "route": "cuda",
                "source": f"paddle_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": library_ms}

    def paged_entry(name, replaces, main, recs):
        return entry(name, "paged_attention.cu", replaces,
                     main["kernel_ms"], main["plain_ms"],
                     (main["bound_ms"], main["bound_by"]),
                     main["library_ms"],
                     max(r["max_abs_err"] for r in recs))

    fa_py = "paddle_tpu/ops/pallas/flash_attention.py"
    ce_py = "paddle_tpu/ops/pallas/fused_ce.py"
    k34m, ce_r = k34[0], k567
    print(json.dumps({"kernels": [
        entry("flash_attention", "flash_attention_fwd.cu", f"{fa_py}:213",
              k1[0]["kernel_ms"], k1[0]["plain_ms"],
              (k1[0]["bound_ms"], k1[0]["bound_by"]), k1[0]["library_ms"],
              max(r["max_abs_err"] for r in k1)),
        paged_entry("paged_append_attend",
                    "paddle_tpu/ops/pallas/paged_attention.py:306", k2[0],
                    k2),
        paged_entry("paged_decode_attention",
                    "paddle_tpu/ops/pallas/paged_attention.py:306",
                    k2p[-1], k2p),
        entry("flash_attention_bwd_dkdv", "flash_attention_bwd.cu",
              f"{fa_py}:395", k34m["k3_ms"], k34m["plain_ms"],
              (k34m["k3_bound_ms"], k34m["k3_bound_by"]),
              k34m["library_ms"],
              max(max(r["max_abs_err"]["dk"], r["max_abs_err"]["dv"])
                  for r in k34)),
        entry("flash_attention_bwd_dq", "flash_attention_bwd.cu",
              f"{fa_py}:433", k34m["k4_ms"], k34m["plain_ms"],
              (k34m["k4_bound_ms"], k34m["k4_bound_by"]),
              k34m["library_ms"],
              max(r["max_abs_err"]["dq"] for r in k34)),
        entry("fused_ce_fwd", "fused_ce.cu", f"{ce_py}:153", ce_r["k5_ms"],
              ce_r["plain_fwd_ms"], (ce_r["k5_bound_ms"],
                                     ce_r["k5_bound_by"]),
              ce_r["library_fwd_ms"],
              max(ce_r["loss_max_abs_err"], ce_r["lse_max_abs_err"])),
        entry("fused_ce_dx", "fused_ce.cu", f"{ce_py}:178", ce_r["k6_ms"],
              ce_r["plain_bwd_ms"], (ce_r["k6_bound_ms"],
                                     ce_r["k6_bound_by"]),
              ce_r["library_bwd_ms"],
              max(c["dx_max_abs_err"] for c in (ce_r["check_init_head"],
                                                ce_r["check_peaked"]))),
        entry("fused_ce_dw", "fused_ce.cu", f"{ce_py}:199", ce_r["k7_ms"],
              ce_r["plain_bwd_ms"], (ce_r["k7_bound_ms"],
                                     ce_r["k7_bound_by"]),
              ce_r["library_bwd_ms"],
              max(c["dw_max_abs_err"] for c in (ce_r["check_init_head"],
                                                ce_r["check_peaked"]))),
        entry("decode_attention", "decode_attention.cu",
              "paddle_tpu/ops/pallas/decode_attention.py:258",
              k10[0]["kernel_ms"], k10[0]["plain_ms"],
              (k10[0]["bound_ms"], k10[0]["bound_by"]),
              k10[0]["library_ms"], max(r["max_abs_err"] for r in k10)),
        # one decode layer's four block products at M 8, summed
        entry("int8_matmul", "quant_matmul.cu",
              "paddle_tpu/ops/pallas/quant_matmul.py:91",
              k12["decode_layer_ms"], k12["decode_layer_plain_ms"],
              (k12["decode_layer_bound_ms"], "bytes"),
              k12["decode_layer_library_ms"], k12["max_abs_err"]),
        # all 24 layers of one decode step at B 8
        entry("mega_decode_layers", "decode_megakernel.cu",
              "paddle_tpu/ops/pallas/decode_megakernel.py:366",
              k8["kernel_ms"], k8["plain_ms"],
              (k8["bound_ms"], k8["bound_by"]), None, k8["max_abs_err"]),
        # max_abs_err: the worst gap between the picked token's plain
        # logit and the row's plain maximum
        entry("mega_logits_sample", "decode_megakernel.cu",
              "paddle_tpu/ops/pallas/decode_megakernel.py:458",
              k9["kernel_ms"], k9["plain_ms"],
              (k9["bound_ms"], k9["bound_by"]), None,
              k9["check"]["token_logit_gap_max"]),
        # at the encoder's rows, N 768; library: F.layer_norm on the sum
        entry("fused_layer_norm", "layer_norm.cu",
              "paddle_tpu/ops/pallas/layer_norm.py:120",
              k11[0]["kernel_ms"], k11[0]["plain_ms"],
              (k11[0]["bound_ms"], k11[0]["bound_by"]),
              k11[0]["library_ms"], max(r["max_abs_err"] for r in k11)),
        # K1, K3, K4 with the padding bias (no kv_lens) and dropout at
        # the encoder's shape, as the encoder path launches them;
        # library: sdpa with the same float mask and its own dropout
        entry("flash_attention[bias+dropout]", "flash_attention_fwd.cu",
              f"{fa_py}:213", k134[0]["k1_ms"], k134[0]["plain_fwd_ms"],
              (k134[0]["k1_bound_ms"], k134[0]["k1_bound_by"]),
              k134[0]["library_fwd_ms"],
              max(r["max_abs_err"] for r in k134),
              counter="flash_attention", only="encoder"),
        entry("flash_attention_bwd_dkdv[bias+dropout]",
              "flash_attention_bwd.cu", f"{fa_py}:395", k134[0]["k3_ms"],
              k134[0]["plain_bwd_ms"],
              (k134[0]["k3_bound_ms"], k134[0]["k3_bound_by"]),
              k134[0]["library_bwd_ms"],
              max(r["max_abs_err"] for r in k134),
              counter="flash_attention_bwd_dkdv", only="encoder"),
        entry("flash_attention_bwd_dq[bias+dropout]",
              "flash_attention_bwd.cu", f"{fa_py}:433", k134[0]["k4_ms"],
              k134[0]["plain_bwd_ms"],
              (k134[0]["k4_bound_ms"], k134[0]["k4_bound_by"]),
              k134[0]["library_bwd_ms"],
              max(r["max_abs_err"] for r in k134),
              counter="flash_attention_bwd_dq", only="encoder"),
        # one (8, 128) fp32 copy; plain and library: x.clone()
        entry("noop_copy", "launch_probe.cu",
              "paddle_tpu/observability/devprof.py:291", k13["kernel_ms"],
              k13["plain_ms"], (k13["bound_ms"], k13["bound_by"]),
              k13["library_ms"], k13["max_abs_err"]),
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
