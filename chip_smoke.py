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
   K5 (CE forward) and the CE backward (``fused_ce_bwd``: per vocab
   chunk a dl pass, K6 for dx and K7 for dw) at N 8188 rows (4 x 2047),
   d 2048, V 50304 with ignored labels, with the init head's
   near-uniform softmax and with a peaked one. Each output is held by
   its relative L2 error per tile or row that one block writes
   (``REL_L2_TOL``), so small entries count as much as the largest.
   Each prints its time (K1, K2, K2', K3, the dl pass, K6, K7: the
   kernel's profiler device time, and K1, K2, K2', K3 and the whole CE
   backward also by CUDA events; the others by CUDA events), its plain
   version's time,
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
   tokens/s, MFU, peak memory, launches per step (K1, K3, K4 = L; K5 =
   1; the dl pass, K6, K7 = the vocab chunks, 13 at V 50304; counted
   from zero over the kernel steps) and a
   torch.profiler breakdown of one step;
6. K10 and K12 kernels, at the contiguous engine's shapes: K10
   flash-decode (B 8, 16 query heads over 16 and 4 kv heads of 128, T
   2048, lengths 0..2047 including an empty row), with and without
   (m, l), and with the fresh rows written inside (a row not written,
   a row clamped to T - 1: ``fresh_rows_check``, the caches bit for
   bit); K12 int8 matmul, the four gpt3_1p3b block products at M 8
   (decode, the tensor-core route) and M 32, 128 and 512 (the int8
   engine's prefill buckets, the TMA + wgmma tiles), each case naming
   its route, with a decode layer's sum at M 8 and a prefill layer's at
   M 128. Checks: ``decode_attention_check`` and
   ``quant_matmul_check``;
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
   the per-layer path at the same shapes, and of K9 (its route and
   plan named) beside ``context_ms``, the three calls a user would
   write for its function (F.layer_norm, x @ wte.t(), argmax); K8's
   phase-time record (``k8_phase_record``: block 0 stamps %globaltimer
   at each grid barrier) on one gpt3_1p3b layer, at d_model 128 and
   through the 24 layers, with the grid barriers a layer takes. Then at
   a speculative verify's flat rows (``spec_rows``: B 32 and 64, K 4
   and 8 consecutive rows a slot, one slot's rows across a page
   boundary, one inactive slot writing the scratch page): K8 on one
   llama_style_1b-shaped layer and on the 24 layers
   (``mega_layers_check``), K9 on each 24-layer output with the planted
   tie, overflow and poisoned row; K8's and K9's device times at B 8,
   32 and 64 beside their bounds (``k89_rows_ms``);
12. single-dispatch serving — the same model and prompts as 4 through
   ``make_engine(model)``, whose default runs one K8 and one K9 launch
   per decode step: K8 = K9 = decode steps, K2 = 0, K1 = L x cold
   prefills, K2' > 0; the teacher-forced check; a second batch under
   torch.profiler.

13. K11, at the incubate encoder's rows (M 16 x 512), bf16, with bias,
   residual and dropout 0.1, at N 768, 1024 and 1000: y and pre per row
   within REL_L2_TOL, mean and rstd within LN_STATS_TOL, the mask (read
   through an all-ones input) equal to the plain hash bit for bit
   (``layer_norm_check``); each N's launch plan (``_plan``: variant,
   access width, values a thread, block, grid) and one kernel in the
   profiler window of one call (bf16 vectors, the seed on the device, as
   the encoder passes them); device times of K11, its plain version and
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
   launches made; its device time and bound beside the card's launch
   floor (``launch_floor``: an empty kernel of one block of 32 threads,
   timed the same way, ``floor_ms``), and the launch tax
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

19. train with every option — gpt3_1p3b at full width, dropout 0.1,
   from seed 0, the batch of 5, ``PRNGKey(0)`` every step, AdamW with
   a 2-step linear warmup into a cosine over 6 (peak 1e-4), decay 0.01
   on every parameter but the LayerNorm scales and biases (masks over
   the slabs), the global-norm clip at 1.0, bf16 moments, and
   ``PT_NUMERICS_EVERY=1``. Checks: the first layer's salt-1 mask at
   (4, 2048, 2048) drawn on the card (from the CPU key and from the key
   on the card) equals the CPU's draw bit for bit; step 1 through the
   plain versions and through the kernels: losses 1e-3, gradients
   2.5e-2 relative L2, the clip's global norm 1e-2
   (``options_step_check``); the rate of each update equals the
   schedule's ``value_at`` on the CPU (``lr_check``); the masks
   registered on the slabs (``decay_mask_check``); the second update of
   ``stacked.wqkv`` (decayed, bf16) and ``stacked.ln1_scale`` (exempt,
   fp32) recomputed by hand from the saved (p, g, m, v) within 1e-6,
   with three controls from the same values (the unclipped gradient,
   the decay flipped, the next step): each control that moves a value
   by more than 1e-6 must fail, at least one must move, and those that
   cannot are recorded (``update_controls``; the decay term, lr * wd *
   p, is 1e-6 of p: on bf16 weights it crosses a rounding boundary on
   few elements, on a scale of 1.0 it is about the tolerance); the
   packed numerics vector
   finite with L rows per stacked family (``numerics_check``); the loss
   falls over the 6 kernel steps, launches per step K1 = K3 = K4 = 24,
   K5 = 1, the dl pass = K6 = K7 = 13; last, a step with
   ``train.grad_poison`` armed at layer 5 (the clip off, or the NaN
   norm would spread to every layer's update): ``Monitor`` names layer
   5 (``poison_check``) and dumps its ring into ``build/numerics/``.
   Printed: step times beside phase 5's (dropout 0), tokens/s, MFU,
   peak memory, the device ms of one mask and one residual dropout (and
   the 48 a step), the step with numerics off, and a torch.profiler
   breakdown of one step. Then one gpt3_1p3b step (dropout 0, the
   kernels) with each of the other options (``sweep_cases``: the ten
   optimizers, the value and per-slab norm clips, both regularizers,
   LookAhead, and AdamW after amp's O2 cast of an fp32 model, every
   parameter bf16 after it) and ModelAverage over the
   result: loss, parameters and optimizer slots finite, launches per
   step as phase 5's; each step's time.

20. the MoE GPT — ``gpt3_1p3b(moe_experts=8, moe_every=2)`` at full
   width (12 MoE blocks of 8 experts, gshard top-2, 4.14 B parameters,
   seed 0). (a) ``top_k_gating`` on one routing group's fp32 logits (T
   1024, E 8) on the card against the CPU, both gates at their
   capacity: dispatch equal, combine and aux within 1e-6, the Switch
   jitter bit for bit (``moe_gating_check``). (b) ``generate``, greedy,
   4 prompts of 128, 32 new tokens, cache 2048: K10 = L x 31, every
   other kernel 0; run again with its routing recorded (the same
   tokens), then teacher-forced through the same cached route (the
   prompt, then one token a call) with K10's plain version and the
   recorded experts replayed (``_Routes``): each token within
   TEACHER_FORCED_TOL of its row's maximum. (c) training, bf16-moment
   AdamW (lr 1e-4, wd 0.01), MOE_BATCH x 2048, ``PRNGKey(0)``: step 1
   through the kernels with its routing recorded and through the plain
   versions with those experts replayed, from the same weights (kept in
   host memory): losses 1e-3, every gradient MOE_GRAD_TOL relative L2
   (4e-2; its comment gives the measurements behind it); then 6
   kernel steps from the same weights: the loss falls, K1 = K3 = K4 =
   24 a step, every other kernel 0; printed: the tokens a MoE block
   whose own choice differed from the replayed one (a bf16 near-tie: an
   expert is a different function, so without the replay a few flips
   in the first blocks move every later gradient), step time, tokens/s,
   MFU by ``flops_per_token`` (the JAX formula: an MoE block counted as
   one dense FFN) and by the FLOPs executed (``moe_executed_flops``),
   peak memory, a torch.profiler breakdown of one step and the time of
   one AdamW update.

21. speculative serving — the same model, ``speculative_k=4``, 16
   verify steps a dispatch, 8 prompts of 128 tokens, 64 new tokens
   each, two prompt sets (8-token loops repeated, and random tokens),
   through four engines, each beside its plain twin on the same
   prompts: paged single-dispatch (``make_engine(model,
   speculative_k=4)``: one K8 and one K9 launch a verify of 32 rows),
   paged per layer (``mega=False``: K2' over the 32 query rows a layer),
   contiguous bf16 (cache 2048; a verify attends through the grouped
   einsum, no K10) and int8 (``share_weights_with``; K12 at M 32); then
   16 slots x K 8 single-dispatch (128 rows a verify, two K8 + K9
   launches). Each fatal: the teacher-forced check on every emitted
   token (int8: through K12's plain version), every request's full
   budget, the launch counts of the speculative and the plain batches
   (``serve_expected``: single-dispatch K8 = K9 = verify steps x launch
   groups, K2 = 0; per layer K2' = L x verify steps, K2 = 0; contiguous
   K10 = 0; int8 K12 = 4 L x (verify steps + prefill chunks)). Printed:
   tokens/s of both, the mean tokens a verify emits
   (``acceptance``), the share of tokens equal to the plain stream
   (``equal_share``), and each engine's device ms and launches a verify
   step (``decode_device_phase``).

Phases 11, 4, 12, 6-10 and 21 run before 5 (which needs the card's
memory for training), 13, 14 and 17 before them, 19 (and its sweep)
right after 5, 20 after the sweep, 15, 16 and 18 after 20. Should
the script near its time limit, phase 18's sweep may drop to prompts of
128 and 1024 tokens, at full width.

Every kernel time is read from a profiler window whose count of the
timed kernels is what the calls launched (``_device_ms``,
``decode_device_phase``: a window short of launches is profiled again,
up to PROFILE_WINDOWS, and the phase fails after that many).

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
    """Stop with exit code 1, the reason on standard output (beside the
    phases' records) and on standard error (where a caller that keeps
    only the error stream finds it)."""
    line = f"chip_smoke: FAILED: {msg}"
    print(line, flush=True)
    print(line, file=sys.stderr, flush=True)
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


PROFILE_WINDOWS = 3
# torch.profiler keeps only the device activities that lie inside its
# capture window, which it opens and closes on the host's clock, and an
# H100's kernel start times were seen up to 4 ms before the host's call
# that launched them: a kernel launched near a window's edge was
# dropped, in the same place window after window. So every window opens
# and closes with this much idle time (seconds), the device synchronised
# on both sides.
PROFILE_PAD_S = 0.05
# On some H100s a window lost the first 5 to 8 device activities after
# its opening pad, whatever the pad (0.05 s and 0.5 s alike; not at
# 2 s): the single-dispatch decode window lost its first step's K8
# launch and the kernels before it, window after window; one 20 ms spin
# there was lost with the 5 kernels after it. So after the opening pad
# WAKE_LAUNCHES short spin kernels (torch.cuda._sleep, WAKE_CYCLES
# each: about 10 ms in all at the card's 1.98 GHz) take the losses and
# are waited for before the body runs; the window's events leave them
# out.
WAKE_LAUNCHES = 64
WAKE_CYCLES = 300_000
WAKE_KERNEL = "spin_kernel"


class _Window:
    """A profiler window's events, the wake kernel left out."""

    def __init__(self, prof):
        self._prof = prof

    def events(self):
        return [e for e in self._prof.events()
                if WAKE_KERNEL not in e.name]


@contextlib.contextmanager
def _profiled(torch):
    """A torch.profiler window (host and CUDA activities) padded on both
    sides with PROFILE_PAD_S of idle device time, the device woken by
    WAKE_LAUNCHES spins before the body; yields the window
    (``events()``, without the spins)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        for _ in range(WAKE_LAUNCHES):
            torch.cuda._sleep(WAKE_CYCLES)
        torch.cuda.synchronize()
        yield _Window(prof)
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)


def _profile_events(torch, fn, iters):
    """(name, device microseconds) of every CUDA activity a
    torch.profiler window recorded around ``iters`` calls of ``fn``."""
    from torch.autograd import DeviceType
    with _profiled(torch) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.end - e.time_range.start)
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def _one_call_kernels(torch, fn):
    """Names of the CUDA activities in the profiler window of one call
    of ``fn``: the first of up to PROFILE_WINDOWS windows that holds
    exactly one, else the last window's. A window that lost the launch
    (or caught another activity) is profiled again, as ``_device_ms``
    does; a call that launches more than one kernel shows them in every
    window."""
    for _ in range(PROFILE_WINDOWS):
        names = [name for name, _ in _profile_events(torch, fn, 1)]
        if len(names) == 1:
            break
    return names


def _device_ms(torch, fn, keys=None, launches=None, iters=20, warmup=3):
    """Mean device milliseconds per call of ``fn`` spent in CUDA kernels
    (those whose name holds one of ``keys``, or all), summed from a
    torch.profiler trace: the kernels' own time, without the host's
    gaps between launches, which CUDA events around back-to-back calls
    also count when a call's Python is slower than its kernels.

    A window counts only when it holds every launch it should:
    ``iters`` x ``launches`` matching kernels, ``launches`` being the
    kernels one call launches (the caller's count; None: the median of
    what PROFILE_WINDOWS one-call windows recorded, for plain versions
    and library calls, whose launches the port does not fix, so that one
    window short of a launch or holding an extra one does not set it). A
    window
    with another count is profiled again, up to PROFILE_WINDOWS windows;
    None after that many bad windows (the caller's phase then fails)."""
    def matching(events):
        return [us for name, us in events
                if keys is None or any(k in name for k in keys)]

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if launches is None:
        launches = sorted(len(matching(_profile_events(torch, fn, 1)))
                          for _ in range(PROFILE_WINDOWS))[
                              PROFILE_WINDOWS // 2]
    if launches < 1:
        return None
    for _ in range(PROFILE_WINDOWS):
        got = matching(_profile_events(torch, fn, iters))
        if len(got) == iters * launches:
            return sum(got) / 1e3 / iters
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
# a speculative verify's flat rows (phase 11's extension): (B rows, K
# rows a slot) as the engines' verifies launch K8 and K9 (8 x 4, the
# split case's 8 x 8 a launch) and the other two mixes
SPEC_ROW_CASES = ((32, 4), (32, 8), (64, 4), (64, 8))


def spec_rows(B, K, page=128):
    """K8's rows of one verify: B // K slots of K consecutive rows at
    positions p..p + K - 1 of their slot (two pages each); slot 1's rows
    cross a page boundary (p = page - K // 2), the last slot is inactive
    (write 0: its rows go to the scratch page), slot 0 starts at
    position 0."""
    n = B // K
    rows = []
    for s in range(n):
        p = (page - K // 2 if s == 1
             else (37 * s) % (K8_PAGES * page - K + 1))
        rows += [(s, p + j, int(s != n - 1)) for j in range(K)]
    return tuple(rows)

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
                slot=slot, write=write, written=written, geo=geo,
                rows=rows)


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
                       tie_rows=(0, 1), overflow_row=4, poison_row=2,
                       tie_cols=None):
    """K9's planted cases on copies of x and of the head ``head_w``
    (V, dm), the tied ``wte``: row 0's maximum at two equal columns far
    apart (``tie_cols[0]``, default 1000 and V // 2 + 17: in different
    vocabulary tiles and blocks), row 1's at two neighbours in one tile
    (``tie_cols[1]``, default 2000 and 2001); depth 7 of x zeroed but
    for a large value in ``overflow_row`` and a small positive one in
    the tie rows, and one column (V - 5) that reads only depth 7, at
    -1e38, so that ``overflow_row``'s logit alone overflows to inf, in
    one tile (the tie rows' is near -2e38); ``poison_row`` poisoned.
    Rows past x's are not planted. Returns (x, w, poison, ties {row: the
    lowest tied column})."""
    from paddle_tpu_torch.models.gpt import final_ln
    x = x.clone()
    w = head_w.clone()
    B, V = x.shape[0], w.shape[0]
    if tie_cols is None:
        tie_cols = ((1000, V // 2 + 17), (2000, 2001))
    k0, col = 7, V - 5
    x[:, k0] = 0
    if overflow_row < B:
        x[overflow_row, k0] = -40
    std = x.float().std(dim=1)
    for r in tie_rows:
        if r < B:
            x[r, k0] = 2 * std[r]
    w[col] = 0
    w[col, k0] = -1e38
    h = final_ln(x, lnf_scale, lnf_bias).float()
    ties = {}
    for r, cols in zip(tie_rows, tie_cols):
        if r >= B:
            continue
        ties[r] = min(cols)
        for c in cols:
            w[c] = (3 * h[r] / h[r].norm()).to(w.dtype)
            w[c, k0] = 0
    poison = torch.zeros((B,), dtype=torch.int32, device=x.device)
    if poison_row < B:
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
                    keys=("flash_fwd_",), launches=1)
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


def _paged_geometry(table, page, pairs):
    """K2's launch geometry for a table and a launch of ``pairs`` (row,
    kv head) pairs: the cluster's blocks and the ring's slots
    (``ops/paged_attention.py``)."""
    from paddle_tpu_torch.device import sm_count
    from paddle_tpu_torch.ops import paged_attention as pa
    splits = pa.cluster_size(table.shape[1], page, pairs,
                             sm_count(table.device))
    return {"splits": splits,
            "stages": pa.ring_stages(table.shape[1], page, splits)}


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
    ms = _device_ms(torch, call, ("paged_kernel",), launches=1)
    call_ms = _event_ms(torch, call)
    plain_ms = _device_ms(torch, lambda: paged_append_attend_reference(
        q, kp2, vp2, k_row, v_row, table, wp, lens), iters=5, warmup=1)
    flops, nbytes = paged_append_attend_cost(lengths, q.shape[1], hkv, D,
                                             q.element_size())
    bound_ms, bound_by = _bound(nbytes, flops)
    rec = {"phase": f"k2_paged_fused_hkv{hkv}", "B": B, "Hq": q.shape[1],
           "Hkv": hkv, "D": D, "page": page, "lengths": lengths,
           "geometry": _paged_geometry(table, page, B * hkv),
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


# cached tokens of the 8 slots of the K2' verify case: slot 1's rows
# cross a page boundary, the last slot's reach the end of T 2048
VERIFY_SLOT_LENS = (0, 126, 131, 190, 255, 640, 1500, 2040)


def verify_rows(K, slot_lens=VERIFY_SLOT_LENS):
    """(lens, table_rows) of a per-layer verify's K2' launch: K query
    rows a slot, row j of a slot with n cached tokens at position n + j
    attending its n + j + 1 keys through the slot's table row."""
    lens = [n + j + 1 for n in slot_lens for j in range(K)]
    return lens, [s for s in range(len(slot_lens)) for _ in range(K)]


def distinct_keys(lengths, table_rows):
    """Keys K2' must read once when row r attends ``lengths[r]`` keys of
    the sequence in table row ``table_rows[r]``: the longest row's count
    for each sequence."""
    longest = {}
    for n, t in zip(lengths, table_rows):
        longest[t] = max(n, longest.get(t, 0))
    return sum(longest.values())


def k2_plain_case(torch, dev, gen, hkv, lengths, table_rows=None,
                  name="", max_pages=2):
    """K2' over query rows attending ``lengths`` keys each; with
    ``table_rows``, row r reads table row ``table_rows[r]`` (rows of one
    sequence share its pages, as the suffix prefill's and a verify's
    do), and the bound reads each sequence's keys once."""
    from paddle_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_cost,
        paged_decode_attention_reference)
    q, kp, vp, table, lens = _paged_inputs(torch, dev, gen, hkv, lengths,
                                           max_pages=max_pages)
    kv_tokens = None
    if table_rows is not None:
        idx = torch.tensor(table_rows, dtype=torch.long, device=dev)
        table = table[idx].contiguous()
        kv_tokens = distinct_keys(lengths, table_rows)
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
    ms = _device_ms(torch, call, ("paged_kernel",), launches=1)
    call_ms = _event_ms(torch, call)
    plain_ms = _device_ms(torch, lambda: paged_decode_attention_reference(
        q, kp, vp, table, lens), iters=5, warmup=1)
    D = q.shape[-1]
    flops, nbytes = paged_decode_attention_cost(
        lengths, q.shape[1], hkv, D, q.element_size(),
        kv_tokens=kv_tokens)
    bound_ms, bound_by = _bound(nbytes, flops)
    rec = {"phase": f"k2p_paged_plain{name}_hkv{hkv}", "B": len(lengths),
           "Hq": q.shape[1], "Hkv": hkv, "D": D, "page": kp.shape[2],
           "table_pages": table.shape[1], "kv_tokens": kv_tokens,
           "geometry": _paged_geometry(table, kp.shape[2],
                                       len(lengths) * hkv),
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
    # K3's own device time beside the call's (events)
    dkdv_kernel_ms = _device_ms(torch, lambda: fa.flash_attention_bwd_dkdv(
        q, k, v, do, lse, delta, True, scale), keys=("flash_bwd_dkdv",),
        launches=1, iters=5, warmup=1)
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
           "k3_ms": dkdv_ms, "k3_kernel_ms": dkdv_kernel_ms,
           "k4_ms": dq_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "timing": "k3_ms, k4_ms: CUDA events around back-to-back "
                     "calls; k3_kernel_ms: device time (torch.profiler)",
           "k3_bound_ms": dkdv_bound[0], "k3_bound_by": dkdv_bound[1],
           "k4_bound_ms": dq_bound[0], "k4_bound_by": dq_bound[1],
           "ok": bool(check["ok"] and dkdv_kernel_ms is not None)}
    _phase(rec)
    return rec


def _ce_run_check(torch, ce, x, w, labels, g):
    """K5 and the backward (its dl pass, K6 and K7 per vocab chunk) once
    against their plain versions on the same inputs: per-row loss and lse
    within 1e-3 (fp32 sums of the same bf16 products in another order),
    an ignored row's loss exactly 0, dx and dw by ``ce_grads_check``.
    The plain backward takes the inputs in fp32, so it does not round dl
    to bf16: where one term makes up a row of dw, the kernel's rounding
    of it (half a bf16 ulp, at most 2^-8) then counts once, not as the
    one-ulp gap between two roundings. Returns (check record, K5's
    lse)."""
    valid = labels >= 0
    loss, lse = ce.fused_ce_fwd(x, w, labels)
    dx, dw = ce.fused_ce_bwd(x, w, labels, lse, g)
    torch.cuda.synchronize()
    rloss, rlse = ce.fused_ce_reference(x, w, labels)
    rdx, rdw = ce.fused_ce_bwd_reference(x.float(), w.float(), labels,
                                         lse, g)
    rec = ce_grads_check(dx, dw, rdx, rdw, labels)
    rec.update({"loss_max_abs_err": (loss - rloss).abs().max().item(),
                "lse_max_abs_err": (lse - rlse).abs().max().item(),
                "ignored_loss_zero": bool((loss[~valid] == 0).all().item()),
                "ignored_dx_zero": bool((dx[~valid] == 0).all().item()),
                "dx_max_abs_err": (dx.float() - rdx).abs().max().item(),
                "dw_max_abs_err": (dw.float() - rdw).abs().max().item()})
    del rdx, rdw
    loss_tol = 1e-3
    rec["ok"] = bool(rec["ok"] and rec["ignored_loss_zero"]
                     and rec["ignored_dx_zero"]
                     and rec["loss_max_abs_err"] <= loss_tol
                     and rec["lse_max_abs_err"] <= loss_tol)
    return rec, lse


# the backward's three kernels by the epilogue in their names (the bf16
# wgmma kernel and the fp32 one share each epilogue)
CE_BWD_KEYS = {"dl": "DlEpi", "k6": "DxEpi", "k7": "DwEpi"}


def ce_case(torch, dev, gen):
    """K5 and the backward (dl pass, K6, K7) at the train shape: N = 4 x
    2047 rows (not a multiple of the 128-row tile), d 2048, V 50304, every
    7th label ignored. Checked twice: with the model's init head (w std
    0.02: a near-uniform softmax, timed) and with logits of std 3 (w std
    3/sqrt(d): a peaked softmax, where dx's softmax term is not lost
    under bf16 rounding of the label term). K5 is timed by CUDA events;
    the dl pass, K6 and K7 each by profiler device time, and the whole
    backward by CUDA events with its operands cold."""
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
    elt = x.element_size()
    fwd_ms = _event_ms(torch, lambda: ce.fused_ce_fwd(x, w, labels),
                       iters=3, warmup=1)
    def bwd():
        return ce.fused_ce_bwd(x, w, labels, lse, g)

    # each pass launches once per vocab chunk
    chunks = len(ce.plan_chunks(V))
    pass_ms = {k: _device_ms(torch, bwd, keys=(key,), launches=chunks,
                             iters=3, warmup=1)
               for k, key in CE_BWD_KEYS.items()}
    cold = _cold((x, w), (N * d + V * d) * elt)
    bwd_ms = _event_ms(torch, lambda: ce.fused_ce_bwd(*cold(), labels, lse,
                                                      g),
                       iters=3, warmup=1)
    # the backward's memory beyond its outputs: dl and the fp32 dx sum
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    bwd()
    torch.cuda.synchronize()
    scratch = (torch.cuda.max_memory_allocated(dev) - before
               - (N * d + V * d) * elt)
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
    io = (N * d + V * d) * elt + N * 4          # x, w, labels
    mac = N * V * d
    dl_bytes = N * V * elt
    fwd_bound = _bound(io + 2 * N * 4, 2 * mac)
    # one product each: the dl pass reads x, w and the row terms and
    # writes dl; K6 reads dl and w, writes dx; K7 reads dl and x, writes dw
    dl_bound = _bound(io + 2 * N * 4 + dl_bytes, 2 * mac)
    dx_bound = _bound(dl_bytes + V * d * elt + N * d * elt, 2 * mac)
    dw_bound = _bound(dl_bytes + N * d * elt + V * d * elt, 2 * mac)
    # the backward as a function: x, w, labels, lse, g in; dx, dw out;
    # three products given lse
    bwd_bound = _bound(io + 2 * N * 4 + (N * d + V * d) * elt, 6 * mac)
    rec = {"phase": "k567_fused_ce", "N": N, "d": d, "V": V,
           "chunk": ce.CHUNK, "chunks": len(ce.plan_chunks(V)),
           "k5_ranges": ce._plan(bf, N, V, torch.cuda.get_device_properties(
               dev).multi_processor_count),
           "ignored_rows": int((~valid).sum().item()), "dtype": "bfloat16",
           "loss_tol": 1e-3, "tol_rel_l2": REL_L2_TOL,
           "check_init_head": init, "check_peaked": peaked,
           "loss_max_abs_err": max(init["loss_max_abs_err"],
                                   peaked["loss_max_abs_err"]),
           "lse_max_abs_err": max(init["lse_max_abs_err"],
                                  peaked["lse_max_abs_err"]),
           "k5_ms": fwd_ms, "dl_ms": pass_ms["dl"], "k6_ms": pass_ms["k6"],
           "k7_ms": pass_ms["k7"], "bwd_ms": bwd_ms,
           "bwd_scratch_bytes": scratch,
           "plain_fwd_ms": plain_fwd_ms, "plain_bwd_ms": plain_bwd_ms,
           "library_fwd_ms": lib_fwd_ms, "library_bwd_ms": lib_bwd_ms,
           "k5_bound_ms": fwd_bound[0], "k5_bound_by": fwd_bound[1],
           "dl_bound_ms": dl_bound[0], "dl_bound_by": dl_bound[1],
           "k6_bound_ms": dx_bound[0], "k6_bound_by": dx_bound[1],
           "k7_bound_ms": dw_bound[0], "k7_bound_by": dw_bound[1],
           "bwd_bound_ms": bwd_bound[0], "bwd_bound_by": bwd_bound[1],
           "ok": bool(init["ok"] and peaked["ok"]
                      and None not in pass_ms.values())}
    _phase(rec)
    return rec


K10_LENGTHS = [0, 1, 127, 128, 517, 1023, 1024, 2047]
# the fused write's rows: the same lengths with the last clamped (a
# position past the cache writes and attends row T - 1) and row 2 not
# written (an idle slot: it attends to its cache entry); the empty row
# writes nothing
K10_FUSED_LENGTHS = K10_LENGTHS[:-1] + [2048]
K10_FUSED_WRITE = [True, True, False, True, True, True, True, True]
K10_KERNELS = ("flash_decode_sm90",)
# the four gpt3_1p3b block products (K, N): wqkv, wo, wup, wdown
K12_PRODUCTS = (("wqkv", 2048, 6144), ("wo", 2048, 2048),
                ("wup", 2048, 8192), ("wdown", 8192, 2048))


def fresh_rows_check(k, v, ref_k, ref_v, k0, v0, lengths, write):
    """K10's fused write against the plain version's: both caches equal
    bit for bit, and each cache changed from ``k0``/``v0`` (the caches
    before the call) in exactly the rows the call writes, row
    lengths[b] - 1 where write[b] holds and the row is not empty."""
    want = _fresh_row_mask(k, lengths, write)
    changed = ((k != k0).any(dim=-1).any(dim=1)
               | (v != v0).any(dim=-1).any(dim=1))
    rec = {"caches_equal": bool(k.equal(ref_k) and v.equal(ref_v)),
           "rows_written": int(changed.sum().item()),
           "rows_expected": int(want.sum().item()),
           "only_those_rows": bool((changed == want).all().item())}
    rec["ok"] = bool(rec["caches_equal"] and rec["only_those_rows"])
    return rec


def _fresh_row_mask(k, lengths, write):
    """(B, T) bool: the cache rows a fused-write call stores into."""
    B, _, T, _ = k.shape
    rows = k.new_zeros((B, T), dtype=bool)
    for b in range(B):
        n = int(lengths[b])
        if n > 0 and write[b]:
            rows[b, n - 1] = True
    return rows


def k10_case(torch, dev, gen, hkv):
    """K10 at the contiguous engine's decode shape: B 8, 16 query heads,
    T 2048, D 128, bf16, mixed lengths with an empty row; with and
    without (m, l), each held by ``decode_attention_check``; and with
    the fused write of the fresh rows (``K10_FUSED_LENGTHS``,
    ``K10_FUSED_WRITE``), the caches held by ``fresh_rows_check``."""
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
    # the fused write, on copies of the caches
    k_new = torch.randn((B, hkv, D), generator=gen, device=dev).to(bf)
    v_new = torch.randn((B, hkv, D), generator=gen, device=dev).to(bf)
    flens = torch.tensor(K10_FUSED_LENGTHS, dtype=torch.int32, device=dev)
    wr = torch.tensor(K10_FUSED_WRITE, device=dev)
    kw, vw, rk, rv = k.clone(), v.clone(), k.clone(), v.clone()
    fo, fm, fl = decode_attention(q, kw, vw, flens, return_stats=True,
                                  k_new=k_new, v_new=v_new, write=wr)
    torch.cuda.synchronize()
    rfo, rfm, rfl = decode_attention_reference(
        q, rk, rv, flens, return_stats=True, k_new=k_new, v_new=v_new,
        write=wr)
    fused = decode_attention_check(fo, fm, fl, rfo, rfm, rfl, flens)
    rows = fresh_rows_check(kw, vw, rk, rv, k, v, K10_FUSED_LENGTHS,
                            K10_FUSED_WRITE)
    err = max(err, (fo.float() - rfo.float())[flens > 0].abs().max().item())
    del kw, vw, rk, rv
    elt = q.element_size()
    n_keys = sum(K10_LENGTHS)
    flops, nbytes = decode_attention_cost(K10_LENGTHS, Hq, hkv, D, elt,
                                          return_stats=True)
    # device time of the kernel (profiler) over caches found cold, beside
    # CUDA events around back-to-back calls, which count the wrapper's
    # host time too
    kv = _cold((k, v), nbytes)
    call = (lambda: decode_attention(q, *kv(), lens, return_stats=True))
    ms = _device_ms(torch, call, K10_KERNELS, launches=1)
    call_ms = _event_ms(torch, call)
    ms_no_stats = _device_ms(torch, lambda: decode_attention(q, *kv(), lens),
                             K10_KERNELS, launches=1)
    # the decode step's call: the fresh rows written inside, no stats
    ms_fused = _device_ms(torch, lambda: decode_attention(
        q, *kv(), flens, k_new=k_new, v_new=v_new, write=wr), K10_KERNELS,
        launches=1)
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
    fused_flops, fused_bytes = decode_attention_cost(
        K10_FUSED_LENGTHS, Hq, hkv, D, elt, fresh_rows=True)
    fused_bound = _bound(fused_bytes, fused_flops)
    rec = {"phase": f"k10_decode_attention_hkv{hkv}", "B": B, "Hq": Hq,
           "Hkv": hkv, "T": T, "D": D, "lengths": K10_LENGTHS,
           "dtype": "bfloat16", "check_stats": with_stats,
           "check_no_stats": without, "fused_lengths": K10_FUSED_LENGTHS,
           "fused_write": K10_FUSED_WRITE, "check_fused": fused,
           "check_fused_rows": rows, "tol_rel_l2": REL_L2_TOL,
           "stats_tol_rel": STATS_REL_TOL, "max_abs_err": err,
           "kernel_ms": ms, "kernel_ms_no_stats": ms_no_stats,
           "kernel_ms_fused": ms_fused, "fused_bound_ms": fused_bound[0],
           "call_ms": call_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "timing": "device time (torch.profiler), caches cold; "
                     "call_ms: CUDA events around back-to-back calls",
           "library": "F.scaled_dot_product_attention over the cache, "
                      "length mask",
           "bound_ms": bound_ms, "bound_by": bound_by,
           "ok": bool(with_stats["ok"] and without["ok"] and fused["ok"]
                      and rows["ok"]
                      and None not in (ms, ms_no_stats, ms_fused, plain_ms,
                                       lib_ms))}
    _phase(rec)
    return rec


K12_KERNELS = ("int8_rows_sm90", "int8_tiles_sm90", "rows_kernel",
               "finalize_kernel")
# K12's rows: a decode step's (M 8, the tensor-core weight stream) and
# the int8 engine's prefill buckets (decode_engine.py: 16-512 tokens a
# chunk; M 32, 128 and 512, the TMA + wgmma tiles)
K12_MS = (8, 32, 128, 512)


def _sum_or_none(values):
    values = list(values)
    return None if None in values else sum(values)


def k12_case(torch, dev, gen):
    """K12 on the four gpt3_1p3b block products at each of ``K12_MS``
    (M 8: decode, the tensor-core weight stream; M 32, 128, 512: prefill
    buckets, the TMA + wgmma tiles), bf16, weights drawn at std 0.02 and
    quantized per output column; each output held by
    ``quant_matmul_check``, each case recording the kernel its route
    launches. The library yardstick is ``torch.matmul`` on the weight
    dequantized to bf16 beforehand, which reads twice the weight bytes.
    One layer's four products are summed at M 8 (``decode_layer_*``)
    and at M 128 (``prefill_layer_*``)."""
    from paddle_tpu_torch.ops.quant_matmul import (int8_matmul,
                                                   int8_matmul_cost,
                                                   int8_matmul_reference,
                                                   int8_matmul_route)
    from paddle_tpu_torch.quantization import quantize_tensor
    bf = torch.bfloat16
    cases, ok, err = [], True, 0.0
    for name, K, N in K12_PRODUCTS:
        qt = quantize_tensor((0.02 * torch.randn(
            (K, N), generator=gen, device=dev)).to(bf))
        w_deq = qt.dequantize()
        for M in K12_MS:
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
            ms = _device_ms(torch, call, K12_KERNELS, launches=1)
            call_ms = _event_ms(torch, call)
            plain_ms = _device_ms(torch, lambda: int8_matmul_reference(
                x, *wq(), qt.scale), iters=5, warmup=1)
            wd = _cold((w_deq,), 2 * K * N)
            lib_ms = _device_ms(torch, lambda: torch.matmul(x, *wd()))
            del wq, wd
            bound_ms, bound_by = _bound(nbytes, flops)
            cases.append({"product": name, "M": M, "K": K, "N": N,
                          "route": int8_matmul_route(bf, M),
                          "check": check, "kernel_ms": ms,
                          "call_ms": call_ms, "plain_ms": plain_ms,
                          "library_ms": lib_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by})
            ok = (ok and check["ok"]
                  and None not in (ms, plain_ms, lib_ms))
    decode = [c for c in cases if c["M"] == 8]
    prefill = [c for c in cases if c["M"] == 128]
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
           # the same at M 128, a prefill chunk's layer
           "prefill_layer_ms": _sum_or_none(c["kernel_ms"]
                                            for c in prefill),
           "prefill_layer_plain_ms": _sum_or_none(c["plain_ms"]
                                                  for c in prefill),
           "prefill_layer_library_ms": _sum_or_none(c["library_ms"]
                                                    for c in prefill),
           "prefill_layer_bound_ms": sum(c["bound_ms"] for c in prefill),
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


def _mega_call(mk, inp, kp, vp, plain=False, **kw):
    fn = mk.mega_decode_layers_reference if plain else mk.mega_decode_layers
    return fn(inp["x"], inp["w"], kp, vp, inp["table"], inp["pos"],
              inp["slot"], inp["write"], **inp["geo"], **kw)


def k8_phase_record(torch, mk, inp, kp, vp, reps=5):
    """K8's phase-time record (``mega_decode_layers(stamps=)``: block 0
    stamps %globaltimer at each grid barrier) over ``reps`` calls: per
    phase the median over calls of its ms summed over the layers, and
    per layer; the grid barriers a layer takes; the record's span."""
    import statistics
    L = inp["w"]["wqkv"].shape[0]
    buf = torch.zeros((2 * (16 * L + 2),), dtype=torch.int64,
                      device=kp.device)
    runs = []
    for _ in range(reps):
        buf.zero_()
        _mega_call(mk, inp, kp, vp, stamps=buf)
        torch.cuda.synchronize()
        runs.append(mk.phase_times(buf))
    sums = {}
    for run in runs:
        tot = {}
        for _, phase, ms in run:
            tot[phase] = tot.get(phase, 0.0) + ms
        for phase, ms in tot.items():
            sums.setdefault(phase, []).append(ms)
    order = [p for p in mk.PHASES if p in sums]
    ms = {p: statistics.median(sums[p]) for p in order}
    return {"ms": ms, "per_layer_ms": {p: v / L for p, v in ms.items()},
            # each phase ends at a grid barrier; the last layer's closing
            # barrier is taken only while recording
            "barriers_per_layer": len(runs[0]) / L,
            "span_ms": statistics.median(sum(m for _, _, m in run)
                                         for run in runs),
            "calls": reps}


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
    rows = inp["rows"]
    rec = {"phase": f"k8_{name}", "layers": L,
           "rows": rows if len(rows) <= 8 else len(rows),
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
            launches=1, iters=10, warmup=2)
        rec["plain_ms"] = _device_ms(
            torch, lambda: _mega_call(mk, inp, kp, vp, plain=True), iters=2,
            warmup=1)
        rec["library_ms"] = None
        rec["phases"] = k8_phase_record(torch, mk, inp, kp, vp)
        ok = ok and None not in (rec["kernel_ms"], rec["plain_ms"])
    if context:
        rec["per_layer_path_ms"] = _device_ms(
            torch, lambda: _per_layer_call(torch, inp, kp, vp), iters=5,
            warmup=1)
        from torch.autograd import DeviceType
        with _profiled(torch) as prof:
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
    planted tie, an overflowing row and a poisoned row; then both at a
    speculative verify's rows (``spec_rows_phase``) and their device
    times at B 8, 32 and 64 beside their bounds. Returns (K8 record, K9
    record), each with its verify-row records under ``spec_rows``."""
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

    k9 = k9_case(torch, dev, model, x24, "k9_gpt3_1p3b_head")
    del x24
    k8["spec_rows"], k9["spec_rows"] = spec_rows_phase(torch, dev, gen,
                                                       model)
    _phase({"phase": "k89_rows_ms",
            "k8": {8: _ms_bound(k8), **{r["rows"]: _ms_bound(r)
                                        for r in k8["spec_rows"]
                                        if "kernel_ms" in r}},
            "k9": {8: _ms_bound(k9), **{r["B"]: _ms_bound(r)
                                        for r in k9["spec_rows"]
                                        if "kernel_ms" in r}},
            "timing": "device time (torch.profiler), operands cold",
            "ok": True})
    return k8, k9


def _ms_bound(rec):
    return {"ms": rec["kernel_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"]}


def k9_case(torch, dev, model, x24, name, timed=True):
    """K9 on the rows ``x24`` (after the model's 24 layers) and a copy of
    the model's tied head with a planted tie, an overflowing row and a
    poisoned row (``mega_logits_inputs``) against its plain version
    (``mega_logits_check``); with ``timed``, its device time, the plain
    version's and the context's, its route, plan and bound. Returns the
    record."""
    from paddle_tpu_torch.ops import decode_megakernel as mk
    dm = model.cfg.d_model
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
    B, V = x.shape[0], w.shape[0]
    k9 = {"phase": name, "B": B, "d_model": dm, "V": V,
          "dtype": str(x.dtype), "check": check, "ties": ties,
          "ok": check["ok"]}
    if not timed:
        _phase(k9)
        return k9
    ms = _device_ms(torch, lambda: mk.mega_logits_sample(x, s, b, w.t(),
                                                         poison),
                    ("logits_kernel",), launches=1)
    plain_ms = _device_ms(torch, lambda: mk.mega_logits_sample_reference(
        x, s, b, w.t(), poison), iters=5, warmup=1)
    # no one PyTorch call computes K9's function: the three a user would
    # write (F.layer_norm with the norm's vectors in x's dtype, the head
    # product, argmax), timed as context and not as a library call
    import torch.nn.functional as F
    s_x, b_x, head = s.to(x.dtype), b.to(x.dtype), w.t()
    context_ms = _device_ms(torch, lambda: torch.argmax(
        F.layer_norm(x, (dm,), s_x, b_x) @ head, dim=-1))
    flops, nbytes = mk.mega_logits_sample_cost(B, dm, V, x.element_size())
    bound_ms, bound_by = _bound(nbytes, flops)
    route = mk.logits_route(x.dtype, dm, V, True, True)
    plan = (dict(zip(("group", "n", "stages", "grid"), mk.logits_plan(
        B, dm, V, torch.cuda.get_device_properties(dev)
        .multi_processor_count))) if route == "tensor_cores" else None)
    k9.update({"route": route, "plan": plan,
               "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": None,
               "context_ms": context_ms,
               "timing": "device time (torch.profiler); the head (0.21 "
                         "GB) is read cold by every call; context_ms: "
                         "F.layer_norm, x @ wte.t(), argmax",
               "bound_ms": bound_ms, "bound_by": bound_by,
               "ok": bool(check["ok"] and None not in (ms, plain_ms,
                                                       context_ms))})
    _phase(k9)
    return k9


def spec_rows_phase(torch, dev, gen, model):
    """Phase 11's extension: K8 and K9 at a speculative verify's flat
    rows (``spec_rows``), B 32 and 64 with K 4 and 8 rows a slot: K8 on
    one llama_style_1b-shaped layer (REL_L2_TOL) and on the model's 24
    layers (THROUGH_DEPTH_TOL), the written rows within the tolerance
    and every other pool row bit for bit (``mega_layers_check``); K9 on
    each 24-layer output with the tied head and its planted tie,
    overflow and poisoned row. Timed at (32, 4) and (64, 8), the
    engines' verify shapes. Returns (K8 records, K9 records)."""
    cfg = model.cfg
    dm, hq, d = cfg.d_model, cfg.n_heads, cfg.head_dim
    slabs = {n: t.detach() for n, t in model.stacked.items()}
    k8s, k9s = [], []
    for B, K in SPEC_ROW_CASES:
        rows = spec_rows(B, K)
        timed = (B, K) in ((32, 4), (64, 8))
        lla = mega_inputs(torch, dev, gen, dm, hq, 4, d, 1, bias=False,
                          rope=True, rows=rows)
        k8_case(torch, f"llama_shaped_1layer_B{B}_K{K}", lla, REL_L2_TOL)
        del lla
        deep = mega_inputs(torch, dev, gen, dm, hq, hq, d, cfg.n_layers,
                           weights=slabs, rows=rows)
        rec, x24 = k8_case(torch, f"gpt3_1p3b_24layers_B{B}_K{K}", deep,
                           THROUGH_DEPTH_TOL, timed=timed)
        rec["rows_per_slot"] = K
        k8s.append(rec)
        del deep
        torch.cuda.empty_cache()
        k9s.append(k9_case(torch, dev, model, x24,
                           f"k9_gpt3_1p3b_head_B{B}_K{K}", timed=timed))
        del x24
    return k8s, k9s


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
    from paddle_tpu_torch.ops.fused_ce import fused_ce_plain, plan_chunks
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
    # the backward launches its three kernels once per vocab chunk
    chunks = len(plan_chunks(cfg.vocab_size))
    expected = {n: 0 for n in launches}
    expected.update({"flash_attention": L, "flash_attention_bwd_dkdv": L,
                     "flash_attention_bwd_dq": L, "fused_ce_fwd": 1,
                     "fused_ce_dl": chunks, "fused_ce_dx": chunks,
                     "fused_ce_dw": chunks})
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
             ("fused_ce", ("ce_fwd_", "ce_bwd_wgmma", "ce_bwd_simt")),
             ("paged_attention", ("paged_kernel",)),
             # K8 and K9 (K9's tensor-core kernel is named for sm90, like
             # the library GEMMs below)
             ("decode_megakernel", ("mega_kernel", "logits_kernel")),
             ("decode_attention", K10_KERNELS),
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


def train_breakdown(torch, step, params, state, tokens, rng=None,
                    name="train_breakdown"):
    """One more kernel step under torch.profiler (``rng``: the dropout
    key, passed as the step's 4th argument)."""
    args = (params, state, tokens) + ((rng,) if rng is not None else ())
    torch.cuda.synchronize()
    with _profiled(torch) as prof:
        t0 = time.perf_counter()
        loss = step(*args)[2]
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rec = {"phase": name, "wall_ms": wall_us / 1e3, "loss": loss.item()}
    bd = _device_breakdown(prof, wall_us)
    rec["measured"] = bd is not None
    rec.update(bd or {})
    rec["ok"] = bool(torch.isfinite(loss).item())
    _phase(rec)


# phase 19: the train step with every option (the JAX bench's step with
# dropout, a warmup + cosine schedule, the global-norm clip, a decay
# mask over the slabs and the numerics capture)
OPT_LR, OPT_WARMUP, OPT_T_MAX, OPT_WD = 1e-4, 2, 6, 0.01
OPT_DROPOUT = 0.1
OPT_CLIP = 1.0
OPT_POISON_LAYER = 5
# the clip's global norm through kernels and plain versions: fp32 sums
# of bf16 gradients that agree to 2.5e-2 relative L2 each
NORM_TOL_REL = 1e-2
# one AdamW update recomputed by hand from the saved (p, g, m, v): the
# same fp32 operations, so the same bf16 values
UPDATE_TOL = 1e-6
# the slabs the update check recomputes: a decayed bf16 weight and an
# exempt fp32 LayerNorm scale
UPDATE_SLABS = ("stacked.wqkv", "stacked.ln1_scale")


def options_decay(name):
    """The phase's ``apply_decay_param_fun``: decay every parameter but
    the LayerNorm scales and biases (``ln1_*``, ``ln2_*``, ``lnf_*``)."""
    return not name.split(".")[-1].startswith("ln")


def options_schedule():
    """A 2-step linear warmup from 0 into a cosine over 6 steps."""
    from paddle_tpu_torch.optimizer import lr
    return lr.LinearWarmup(lr.CosineAnnealingDecay(OPT_LR, T_max=OPT_T_MAX),
                           warmup_steps=OPT_WARMUP, start_lr=0.0,
                           end_lr=OPT_LR)


def adamw_reference(torch, p, g, m, v, lr, step, decay, b1=0.9, b2=0.999,
                    eps=1e-8, wd=OPT_WD):
    """AdamW's update of one slab written out: from the parameter ``p``,
    the clipped gradient ``g`` and the moments ``m``, ``v`` before step
    ``step`` (1-based) at rate ``lr``, in fp32; the decoupled decay
    ``lr * (wd * p)`` where ``decay``. Returns the new parameter in p's
    dtype."""
    p32, g32 = p.float(), g.float()
    m32 = b1 * m.float() + (1 - b1) * g32
    v32 = b2 * v.float() + (1 - b2) * torch.square(g32)
    t = torch.tensor(float(step), dtype=torch.float32)
    bc1 = (1 - torch.tensor(b1, dtype=torch.float32) ** t).item()
    bc2 = (1 - torch.tensor(b2, dtype=torch.float32) ** t).item()
    new = p32 - lr * (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
    if decay:
        new = new - lr * (wd * p32)
    return new.to(p.dtype)


def clipped(torch, g, norm, clip=OPT_CLIP):
    """A gradient as the global-norm clip hands it to the update."""
    scale = torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0)
    return (g * scale).to(g.dtype)


def update_check(new, ref, tol=UPDATE_TOL):
    """A slab's new value against ``adamw_reference``: the largest
    absolute difference within ``tol``."""
    err = (new.float() - ref.float()).abs().max().item()
    return {"max_abs_err": err, "tol": tol, "ok": bool(err <= tol)}


def update_controls(torch, new, p0, g, m0, v0, norm, lr, step, decay,
                    wd=OPT_WD, tol=UPDATE_TOL):
    """One slab's update against the hand update (``adamw_reference`` on
    the clipped gradient at ``step``, decayed where ``decay``), and
    three controls recomputed from the same saved (p, g, m, v): the
    unclipped gradient, the decay flipped, the next step. A control
    that differs from the hand update by more than ``tol`` somewhere
    moves a value and must then fail ``update_check`` against ``new``;
    one that moves nothing (its difference under half an ulp of every
    bf16 value) cannot tell, and is listed in ``cannot_move``.
    ``moved`` counts the elements the update changed."""
    gc = clipped(torch, g, norm)
    ref = adamw_reference(torch, p0, gc, m0, v0, lr, step, decay, wd=wd)
    rec = update_check(new, ref, tol)
    rec["moved"] = int((new != p0).sum().item())
    controls = {
        "unclipped": lambda: adamw_reference(torch, p0, g, m0, v0, lr, step,
                                             decay, wd=wd),
        "decay_flipped": lambda: adamw_reference(
            torch, p0, gc, m0, v0, lr, step, not decay, wd=wd),
        "next_step": lambda: adamw_reference(torch, p0, gc, m0, v0, lr,
                                             step + 1, decay, wd=wd)}
    rec["controls"] = {}
    for name, make in controls.items():
        c = make()
        rec["controls"][name] = {
            "moves": not update_check(c, ref, tol)["ok"],
            "caught": not update_check(new, c, tol)["ok"]}
        del c
    rec["cannot_move"] = [n for n, c in rec["controls"].items()
                          if not c["moves"]]
    rec["ok"] = bool(rec["ok"] and all(
        c["caught"] for c in rec["controls"].values() if c["moves"]))
    return rec


def decay_mask_check(masks, decay_fn, n_layers):
    """The (L, 1, ...) decay masks registered on the slabs (slab entry ->
    mask, None where none is) against ``decay_fn`` over the per-layer
    names ``blocks.item_<i>.<name>`` (on bf16 weights the decay term,
    lr * wd * p, is about 1e-6 of p, under half an ulp of most values, so
    the update check sees the decision on few elements or none)."""
    bad = [n for n, m in masks.items()
           if m is None or m.shape[0] != n_layers
           or m.flatten().tolist() != [
               float(bool(decay_fn(f"blocks.item_{i}.{n[8:]}")))
               for i in range(n_layers)]]
    return {"slabs": len(masks), "wrong": bad,
            "decayed_layers": {n: int(m.sum().item())
                               for n, m in sorted(masks.items())
                               if m is not None},
            "ok": bool(masks) and not bad}


def lr_check(used, schedule, first_step=1):
    """The rates the updates used (``optimizer.last_lr``, one a step)
    against ``schedule.value_at(step)`` computed on the CPU: equal."""
    want = [float(schedule.value_at(first_step + i))
            for i in range(len(used))]
    return {"lr_used": used, "lr_expected": want,
            "ok": bool(used == want)}


def numerics_check(torch, packed, layout, n_layers):
    """The packed numerics vector: every entry finite, its size the
    layout's, tag 1 (sampled), and L rows for every stacked family."""
    stacked = [L for name, L, _ in layout.families
               if "_stacked_blocks" in name]
    finite = bool(torch.isfinite(packed).all().item())
    rec = {"size": int(packed.numel()), "layout_size": layout.size,
           "stacked_families": len(stacked),
           "rows_per_stacked_family": sorted(set(stacked)),
           "finite": finite}
    rec["ok"] = bool(finite and packed.numel() == layout.size
                     and float(packed[0]) == 1.0 and stacked
                     and all(L == n_layers for L in stacked))
    return rec


def poison_check(snap, layer):
    """A poisoned step's decoded snapshot names ``layer`` as the first
    bad layer, in a stacked gradient family, and fires the alert."""
    fam = snap.get("first_bad_family_name") or ""
    return {"first_bad_layer": snap.get("first_bad_layer"),
            "first_bad_family": fam, "alerts": snap.get("alerts"),
            "ok": bool(snap.get("first_bad_layer") == layer
                       and fam.startswith("grad/_stacked_blocks")
                       and "nonfinite" in (snap.get("alerts") or []))}


def options_step_check(loss, plain_loss, grad_err, norm, plain_norm,
                       loss_tol=1e-3, grad_tol=2.5e-2,
                       norm_tol=NORM_TOL_REL):
    """Step 1 through the kernels against step 1 through the plain
    versions (same weights, same key): losses, every gradient (relative
    L2) and the clip's global norm."""
    rec = encoder_step_check(loss, plain_loss, grad_err, loss_tol,
                             grad_tol)
    rec["clip_norm"], rec["plain_clip_norm"] = norm, plain_norm
    rec["clip_norm_rel_err"] = abs(norm - plain_norm) / abs(plain_norm)
    rec["clip_norm_tol_rel"] = norm_tol
    rec["ok"] = bool(rec["ok"] and rec["clip_norm_rel_err"] <= norm_tol)
    return rec


def options_mask_phase(torch, dev, cfg, B, S):
    """The first layer's salt-1 mask at (B, S, d), drawn on the card from
    the CPU key and from the key on the card, against the CPU's draw bit
    for bit; the device ms of one mask and of one residual dropout."""
    from paddle_tpu_torch import random as prng
    from paddle_tpu_torch.models import gpt
    shape = (B, S, cfg.d_model)
    k = prng.fold_in(prng.fold_in(prng.PRNGKey(SEED), 0), 1)
    ref = prng.bernoulli(k, 1.0 - OPT_DROPOUT, shape, device="cpu")
    got = prng.bernoulli(k, 1.0 - OPT_DROPOUT, shape)
    got_dev = prng.bernoulli(k.to(dev), 1.0 - OPT_DROPOUT, shape)
    rec = {"phase": "train_options_mask", "shape": list(shape)}
    rec.update(mask_check(got.cpu(), ref))
    rec["device_key_mismatches"] = int((got_dev.cpu() != ref).sum().item())
    del got, got_dev, ref
    x = torch.randn(shape, device=dev).to(cfg.dtype)
    lk = prng.fold_in(prng.PRNGKey(SEED), 0)
    rec["mask_ms"] = _device_ms(torch, lambda: prng.bernoulli(
        k, 1.0 - OPT_DROPOUT, shape, device=dev), iters=5)
    rec["dropout_ms"] = _device_ms(torch, lambda: gpt._maybe_dropout(
        x, OPT_DROPOUT, lk, 1), iters=5)
    # two residual dropouts a layer, forward only (remat off)
    rec["masks_per_step"] = 2 * cfg.n_layers
    rec["dropout_ms_per_step"] = (None if rec["dropout_ms"] is None else
                                  rec["dropout_ms"] * rec["masks_per_step"])
    rec["ok"] = bool(rec["ok"] and rec["device_key_mismatches"] == 0
                     and rec["mask_ms"] is not None
                     and rec["dropout_ms"] is not None)
    _phase(rec)
    return rec


def train_options_phase(torch, dev, base, n_steps=6, off_steps=2):
    """gpt3_1p3b train steps with every option; see the module docstring
    (phase 19). ``base``: phase 5's record (dropout 0, no options)."""
    import os

    import numpy as np
    from paddle_tpu_torch import random as prng
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.observability import numerics
    from paddle_tpu_torch.ops.flash_attention import flash_attention_plain
    from paddle_tpu_torch.ops.fused_ce import fused_ce_plain, plan_chunks
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm
    from paddle_tpu_torch.testing import faults

    cfg = gpt.gpt3_1p3b(dropout=OPT_DROPOUT)
    B, S = 4, cfg.max_seq_len
    L = cfg.n_layers
    masks = options_mask_phase(torch, dev, cfg, B, S)
    model = gpt.GPT(cfg, seed=SEED, device=dev)
    tokens = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (B, S)).astype(np.int32)).to(dev)
    key = prng.PRNGKey(SEED)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}

    def optimizer():
        return AdamW(learning_rate=options_schedule(), weight_decay=OPT_WD,
                     apply_decay_param_fun=options_decay,
                     grad_clip=ClipGradByGlobalNorm(OPT_CLIP),
                     moment_dtype=torch.bfloat16)

    def build(opt, every, **kw):
        prev = os.environ.get("PT_NUMERICS_EVERY")
        os.environ["PT_NUMERICS_EVERY"] = str(every)
        try:
            return gpt.build_train_step(model, opt, **kw)
        finally:
            if prev is None:
                del os.environ["PT_NUMERICS_EVERY"]
            else:
                os.environ["PT_NUMERICS_EVERY"] = prev

    def plain_attn(q, k, v, is_causal=False):
        return flash_attention_plain(q, k, v, causal=is_causal)

    opt = optimizer()
    params, state = gpt.init_train_state(model, opt)
    step = build(opt, 1, attn=plain_attn, ce=fused_ce_plain)
    plain_loss = step(params, state, tokens, key)[2].item()
    plain_norm = opt.grad_clip.last_norm.item()
    plain_grads = {n: p.grad for n, p in params.items()}
    del opt, params, state, step
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(start[n])
            p.grad = None
    del start

    opt = optimizer()
    params, state = gpt.init_train_state(model, opt)
    step = build(opt, 1)
    mon = numerics.Monitor.for_step(step, every_k=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counters()
    losses, step_s, lrs = [], [], []
    grad_err, updates, num = {}, {}, None
    for i in range(n_steps):
        saved = None
        if i == 1:
            # (p, m, v) before the second update, for the hand update
            saved = {n: (params[n].detach().clone(),
                         *(s.clone() for s in state["slots"][n]))
                     for n in UPDATE_SLABS}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss, packed = step(params, state, tokens, key)
        losses.append(loss.item())          # synchronizes
        step_s.append(time.perf_counter() - t0)
        lrs.append(opt.last_lr)
        mon.ingest(packed, i)
        if i == 0:
            for n, p in params.items():
                ref = plain_grads[n].float()
                grad_err[n] = ((p.grad.float() - ref).norm()
                               / ref.norm().clamp(min=1e-30)).item()
            del plain_grads
            step1 = options_step_check(losses[0], plain_loss, grad_err,
                                       opt.grad_clip.last_norm.item(),
                                       plain_norm)
        if saved is not None:
            norm = opt.grad_clip.last_norm
            for n, (p0, m0, v0) in saved.items():
                updates[n] = update_controls(
                    torch, params[n].detach(), p0, params[n].grad, m0, v0,
                    norm, opt.last_lr, i + 1, decay=options_decay(n))
            del saved
        if i == n_steps - 1:
            num = numerics_check(torch, packed,
                                 step.numerics_layout.layout, L)
    launches = _read_counters()
    peak = torch.cuda.max_memory_allocated(dev)
    chunks = len(plan_chunks(cfg.vocab_size))
    expected = {n: 0 for n in launches}
    expected.update({"flash_attention": L, "flash_attention_bwd_dkdv": L,
                     "flash_attention_bwd_dq": L, "fused_ce_fwd": 1,
                     "fused_ce_dl": chunks, "fused_ce_dx": chunks,
                     "fused_ce_dw": chunks})
    per_step = {n: c / n_steps for n, c in launches.items()}
    counts_ok = all(per_step[n] == e for n, e in expected.items())
    lr_rec = lr_check(lrs, options_schedule())
    decay_rec = decay_mask_check(
        {n: opt.decay_mask(n) for n in model.slab_entries()},
        options_decay, L)
    timed = sorted(step_s[1:])
    med = timed[len(timed) // 2]

    # the same step with the numerics capture off, then the profiler's
    # view of one step with it on
    step_off = build(opt, 0)
    off_s = []
    for _ in range(off_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss = step_off(params, state, tokens, key)
        loss.item()
        off_s.append(time.perf_counter() - t0)
    train_breakdown(torch, step, params, state, tokens, rng=key,
                    name="train_options_breakdown")

    # the poisoned step, the clip off: a NaN in one layer's gradient makes
    # the global norm NaN, and then every layer's update (the JAX step
    # does the same), so the provenance would name layer 0's update
    # (the alert dumps the monitor's ring into build/numerics/)
    opt.grad_clip = None
    with faults.inject(numerics.FAULT_SITE, "nan",
                       layer=OPT_POISON_LAYER):
        params, state, loss, packed = step(params, state, tokens, key)
    dump_dir = os.path.abspath(os.path.join("build", "numerics"))
    old_dir = os.environ.get("PT_NUMERICS_DIR")
    os.environ["PT_NUMERICS_DIR"] = dump_dir
    try:
        poison = poison_check(mon.ingest(packed, n_steps) or {},
                              OPT_POISON_LAYER)
    finally:
        if old_dir is None:
            del os.environ["PT_NUMERICS_DIR"]
        else:
            os.environ["PT_NUMERICS_DIR"] = old_dir
    dump = os.path.join(dump_dir, f"numerics_{n_steps}.{os.getpid()}.json")
    poison["dump"] = dump if os.path.exists(dump) else None

    tok_s = B * S / med
    finite = all(np.isfinite(losses))
    off_med = sorted(off_s)[len(off_s) // 2]
    rec = {"phase": "train_options_gpt3_1p3b", "params": cfg.num_params(),
           "layers": L, "batch": B, "seq": S, "dropout": cfg.dropout,
           "remat": cfg.remat, "schedule": "LinearWarmup(2, 0 -> 1e-4) + "
           "CosineAnnealingDecay(1e-4, T_max=6)", "weight_decay": OPT_WD,
           "decay_masks": decay_rec,
           "grad_clip_global_norm": OPT_CLIP,
           "plain_step1_loss": plain_loss, "losses": losses,
           "step1": step1, "lr": lr_rec, "update": updates,
           "numerics": num, "poison": poison,
           "step_s": step_s, "step_ms_median": med * 1e3,
           "numerics_off_step_s": off_s,
           "numerics_off_step_ms_median": off_med * 1e3,
           "numerics_cost_ms": (med - off_med) * 1e3,
           "dropout0_step_ms_median": base["step_ms_median"],
           "mask_ms": masks["mask_ms"],
           "dropout_ms_per_step": masks["dropout_ms_per_step"],
           "tokens_per_s": tok_s,
           "mfu": cfg.flops_per_token() * tok_s / H100_BF16_FLOPS,
           "peak_mem_bytes": peak, "launches": launches,
           "launches_per_step": per_step, "expected_per_step": expected,
           "counts_ok": bool(counts_ok)}
    rec["ok"] = bool(finite and counts_ok and step1["ok"] and lr_rec["ok"]
                     and decay_rec["ok"]
                     and all(u["ok"] for u in updates.values())
                     and len(updates) == len(UPDATE_SLABS)
                     and any(c["moves"] for u in updates.values()
                             for c in u["controls"].values())
                     and num is not None and num["ok"] and poison["ok"]
                     and poison["dump"] is not None
                     and losses[-1] < losses[0])
    _phase(rec)
    return rec


def sweep_cases():
    """name -> a factory of each optimizer of the port with an option:
    the ten optimizers (L2 terms on some), the value and per-slab norm
    clips, both regularizers, LookAhead, and AdamW after amp's O2 cast
    (last: ``train_sweep_phase`` builds an fp32 model for it and casts
    it)."""
    from paddle_tpu_torch import regularizer as reg
    from paddle_tpu_torch import optimizer as opt
    from paddle_tpu_torch.incubate import LookAhead
    return {
        "SGD": lambda: opt.SGD(learning_rate=1e-2, weight_decay=1e-4),
        "Momentum_nesterov": lambda: opt.Momentum(
            learning_rate=1e-3, use_nesterov=True),
        "Adam": lambda: opt.Adam(learning_rate=1e-4, weight_decay=0.01),
        "AdamW": lambda: opt.AdamW(learning_rate=1e-4),
        "Adamax": lambda: opt.Adamax(learning_rate=1e-4),
        "Adagrad": lambda: opt.Adagrad(learning_rate=1e-3),
        "Adadelta": lambda: opt.Adadelta(learning_rate=1.0),
        "RMSProp_centered": lambda: opt.RMSProp(
            learning_rate=1e-4, momentum=0.9, centered=True),
        "Lamb": lambda: opt.Lamb(learning_rate=1e-3),
        "Lars": lambda: opt.Lars(learning_rate=1e-2),
        "AdamW+ClipGradByValue": lambda: opt.AdamW(
            learning_rate=1e-4, grad_clip=opt.ClipGradByValue(1e-3)),
        "AdamW+ClipGradByNorm": lambda: opt.AdamW(
            learning_rate=1e-4, grad_clip=opt.ClipGradByNorm(0.1)),
        "Adam+L1Decay": lambda: opt.Adam(learning_rate=1e-4,
                                         weight_decay=reg.L1Decay(1e-4)),
        "AdamW+L2Decay": lambda: opt.AdamW(learning_rate=1e-4,
                                           weight_decay=reg.L2Decay(0.01)),
        "LookAhead(Adam)": lambda: LookAhead(opt.Adam(learning_rate=1e-4),
                                             alpha=0.5, k=1),
        "amp_O2+AdamW": lambda: opt.AdamW(learning_rate=1e-4),
    }


def cast_check(torch, before, after):
    """amp's O2 cast: every parameter fp32 before ``decorate`` and bf16
    after it."""
    return {"before": sorted({str(d) for d in before}),
            "after": sorted({str(d) for d in after}),
            "ok": bool(before and all(d == torch.float32 for d in before)
                       and len(after) == len(before)
                       and all(d == torch.bfloat16 for d in after))}


def finite_check(torch, tensors):
    """Every tensor of ``tensors`` (parameters, optimizer slots) finite;
    returns the names of those that are not."""
    return [n for n, t in tensors.items()
            if not bool(torch.isfinite(t).all().item())]


def train_sweep_phase(torch, dev):
    """One gpt3_1p3b train step (dropout 0, the kernels) with each
    optimizer, clip and regularizer of the port (``sweep_cases``), and
    ModelAverage over the result: the loss, every parameter and every
    optimizer slot finite, launches as phase 5's per step; the step time
    of each. The amp O2 case builds the model in fp32 and trains it after
    ``amp.decorate`` cast every parameter to bf16 (``cast_check``)."""
    import numpy as np
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.incubate import ModelAverage
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops.fused_ce import plan_chunks

    cfg = gpt.gpt3_1p3b()
    B, S, L = 4, cfg.max_seq_len, cfg.n_layers
    model = gpt.GPT(cfg, seed=SEED, device=dev)
    tokens = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (B, S)).astype(np.int32)).to(dev)
    cases, ok = {}, True
    _zero_counters()
    for name, make in sweep_cases().items():
        cast = None
        if name.startswith("amp_O2"):
            del model
            torch.cuda.empty_cache()
            model = gpt.GPT(gpt.gpt3_1p3b(dtype=torch.float32), seed=SEED,
                            device=dev)
            before = [p.dtype for p in model.parameters()]
            amp.decorate(model, level="O2", dtype="bfloat16")
            cast = cast_check(torch, before,
                              [p.dtype for p in model.parameters()])
        opt = make()
        params, state = gpt.init_train_state(model, opt)
        step = gpt.build_train_step(model, opt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss = step(params, state, tokens)[:3]
        loss = loss.item()
        step_ms = (time.perf_counter() - t0) * 1e3
        slots = state["inner"]["slots"] if "inner" in state \
            else state["slots"]
        tensors = dict(params)
        for n, slot in slots.items():
            for j, t in enumerate(slot if isinstance(slot, tuple)
                                  else (slot,)):
                tensors[f"{n}/slot{j}"] = t
        bad = finite_check(torch, tensors)
        cases[name] = {"loss": loss, "step_ms": step_ms,
                       "lr": opt.last_lr, "not_finite": bad,
                       "ok": bool(np.isfinite(loss) and not bad)}
        if cast is not None:
            cases[name]["cast"] = cast
            cases[name]["ok"] = bool(cases[name]["ok"] and cast["ok"])
        ok = ok and cases[name]["ok"]
        del opt, params, state, step, slots, tensors
        torch.cuda.empty_cache()
    launches = _read_counters()
    n = len(cases)
    ma = ModelAverage(average_window_rate=0.15)
    own = dict(model.named_parameters())
    mst = ma.accumulate(ma.init(own), own)
    averaged = ma.apply(mst, own)
    ma_bad = finite_check(torch, averaged)
    del ma, mst, averaged
    chunks = len(plan_chunks(cfg.vocab_size))
    expected = {k: 0 for k in launches}
    expected.update({"flash_attention": L, "flash_attention_bwd_dkdv": L,
                     "flash_attention_bwd_dq": L, "fused_ce_fwd": 1,
                     "fused_ce_dl": chunks, "fused_ce_dx": chunks,
                     "fused_ce_dw": chunks})
    per_step = {k: c / n for k, c in launches.items()}
    counts_ok = all(per_step[k] == e for k, e in expected.items())
    rec = {"phase": "train_sweep_gpt3_1p3b", "steps": n, "cases": cases,
           "model_average_not_finite": ma_bad, "launches": launches,
           "launches_per_step": per_step, "counts_ok": bool(counts_ok),
           "ok": bool(ok and counts_ok and not ma_bad)}
    _phase(rec)
    return rec


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
                        expect, n_dispatches=2, unit="decode", n_new=64):
    """Device time per decode step of ``eng``: 8 fresh 128-token prompts
    are admitted first, then ``n_dispatches`` decode dispatches
    (``steps_per_call`` steps each) run under torch.profiler; the
    device's busy time over their decode steps, beside the weight-read
    floor (every block weight and the LM head read once per step). The
    window counts only when it holds ``expect`` (kernel name -> launches
    per decode step) times its decode steps; else the batch runs again
    under a new window, up to PROFILE_WINDOWS, and the phase fails when
    none held them. On a speculative engine (``unit="verify"``) a step
    is one verify of K rows a slot, and ``n_new`` is large enough that
    the slots are still live when the window opens (a verify may emit
    K tokens)."""
    import numpy as np
    from torch.autograd import DeviceType
    cfg = eng.cfg
    rs = np.random.RandomState(SEED + 2)
    for window in range(1, PROFILE_WINDOWS + 1):
        reqs = [eng.submit(rs.randint(0, cfg.vocab_size, size=128).tolist(),
                           max_new_tokens=n_new) for _ in range(eng.S)]
        while eng._waiting or getattr(eng, "_admitting", ()):
            eng.step()
        eng.drain()
        torch.cuda.synchronize()
        steps0 = eng.steps
        with _profiled(torch) as prof:
            t0 = time.perf_counter()
            for _ in range(n_dispatches):
                eng.step()
            eng.drain()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        decode_steps = (eng.steps - steps0) * eng.chunk
        eng.run()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        counted = {k: sum(k in n for n in names) for k in expect}
        full = all(counted[k] == per * decode_steps
                   for k, per in expect.items())
        if full:
            break
    floor_ms = (weight_bytes + head_bytes) / H100_BYTES_PER_S * 1e3
    rec = {"phase": f"decode_device_{name}", "slots": eng.S,
           "step_unit": unit,
           "decode_steps": decode_steps, "wall_ms": wall_us / 1e3,
           "block_weight_bytes": weight_bytes, "lm_head_bytes": head_bytes,
           "weight_read_floor_ms": floor_ms,
           "launch_check": {"per_decode_step": expect, "counted": counted,
                            "windows": window, "ok": full}}
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
    rec["ok"] = bool(decode_steps > 0 and full
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


# phase 21: speculative serving (speculative_k) on both engines
SPEC_K = 4
SPEC_CHUNK = 16
SPEC_NEW = 64
SPEC_SPLIT = (16, 8)        # slots, K: 128 rows, two K8 + K9 groups


def loop_prompts(vocab, n, length=128, seed=SEED + 5):
    """Repetition-heavy prompts: ``n`` random 8-token loops repeated to
    ``length`` tokens (as the JAX package's tools/profile_decode.py
    builds its speculative prompts)."""
    import numpy as np
    rs = np.random.RandomState(seed)
    loops = [rs.randint(0, vocab, size=8).tolist() for _ in range(n)]
    return [(lp * (length // 8 + 1))[:length] for lp in loops]


def spec_groups(slots, K, max_rows=64):
    """K8 + K9 launch pairs a single-dispatch verify takes: groups of
    max_rows // K whole slots."""
    per = max(1, max_rows // K)
    return -(-slots // per)


def serve_expected(kind, names, L, steps, cold, suffix, chunks, spec):
    """The launches of one batch through engine ``kind`` (every counter in
    ``names`` not named here 0): ``steps`` decode steps, or verify steps
    when ``spec`` (then, single-dispatch, ``spec`` is the K8 + K9 pairs
    a verify), ``cold`` full and ``suffix`` suffix prefills (paged: K1 =
    L a full prefill, K2' = L a suffix prefill), ``chunks`` prefill
    chunks (contiguous). Single-dispatch: K8 = K9 = steps (x groups);
    per layer: K2 = L a step, or K2' = L a verify; contiguous: K10 = L
    a step, none in a verify (the grouped einsum); int8: the
    contiguous launches and K12 = 4 L a step and a prefill chunk."""
    exp = {n: 0 for n in names}
    if kind.startswith("paged"):
        exp["flash_attention"] = L * cold
        exp["paged_decode_attention"] = L * suffix
    if kind == "paged_mega":
        exp["mega_decode_layers"] = exp["mega_logits_sample"] = (
            steps * (spec or 1))
    elif kind == "paged":
        if spec:
            exp["paged_decode_attention"] += L * steps
        else:
            exp["paged_append_attend"] = L * steps
    else:
        exp["decode_attention"] = 0 if spec else L * steps
        if kind == "int8":
            exp["int8_matmul"] = 4 * L * (steps + chunks)
    return exp


def acceptance(effs):
    """Mean tokens a verify emitted for a live slot (the accepted drafts
    and the correction: 1..K), over the n_eff entries that emitted."""
    live = [int(n) for n in effs if n > 0]
    return sum(live) / max(1, len(live))


def equal_share(reqs, ref_reqs):
    """The share of ``reqs``' tokens equal to ``ref_reqs``' at the same
    position of the same request."""
    same = sum(a == b for r, q in zip(reqs, ref_reqs)
               for a, b in zip(r.tokens, q.tokens))
    return same / max(1, sum(len(r.tokens) for r in reqs))


def _spec_engine(torch, model, kind, K, slots=8, donor=None):
    from paddle_tpu_torch.inference.decode_engine import DecodeEngine
    from paddle_tpu_torch.inference.factory import make_engine
    if kind == "paged_mega":
        eng = make_engine(model, max_slots=slots, steps_per_call=SPEC_CHUNK,
                          speculative_k=K)
        if not eng.mega:
            _fail("make_engine(model, speculative_k=...) did not turn the "
                  "megakernel on")
        return eng
    if kind == "paged":
        return make_engine(model, max_slots=slots,
                           steps_per_call=SPEC_CHUNK, speculative_k=K,
                           mega=False)
    if kind == "contiguous":
        return make_engine(model, engine="contiguous", max_slots=slots,
                           steps_per_call=SPEC_CHUNK, speculative_k=K)
    return DecodeEngine(None, share_weights_with=donor, weight_dtype="int8",
                        max_slots=slots, max_len=donor.T,
                        steps_per_call=SPEC_CHUNK, speculative_k=K)


def _serve_counted(torch, dev, eng, prompts, n_new):
    """``_serve_batch`` with the engine's decode steps (verify steps on a
    speculative engine), its prefill counts and, speculative, the
    harvested n_eff of every slot and step."""
    from paddle_tpu_torch import stats
    effs = []
    if eng.spec_k:
        replay = eng._replay_spec

        def keep(rec, arr):
            effs.extend(arr[..., eng.spec_k].ravel().tolist())
            return replay(rec, arr)

        eng._replay_spec = keep
    steps0 = eng.steps
    try:
        reqs, wall, launches, peak = _serve_batch(torch, dev, eng, prompts,
                                                  n_new)
    finally:
        if eng.spec_k:
            eng._replay_spec = replay
    return {"reqs": reqs, "wall": wall, "launches": launches,
            "peak": peak, "steps": (eng.steps - steps0) * eng.chunk,
            "suffix": int(stats.get("serve/dispatches/prefill_suffix")),
            "prefills": int(stats.get("serve/dispatches/prefill")),
            "effs": effs}


def _spec_case(torch, dev, model, kind, name, spec, plain, prompts,
               tf_model, groups):
    """One prompt set through a speculative engine and its plain twin
    (same kind, prompts and budget): launch counts of both, every
    request's full budget, the teacher-forced check of the speculative
    tokens; tokens/s of both, mean tokens a verify, the share equal to
    the plain streams. Returns the record."""
    L = model.cfg.n_layers
    n = len(prompts)
    got = _serve_counted(torch, dev, plain, prompts, SPEC_NEW)
    res = _serve_counted(torch, dev, spec, prompts, SPEC_NEW)
    chunked = kind in ("contiguous", "int8")
    want = {}
    for r, is_spec in ((got, False), (res, True)):
        cold = 0 if chunked else n - r["suffix"]
        want[is_spec] = serve_expected(
            kind, r["launches"], L, r["steps"], cold, r["suffix"],
            r["prefills"], (groups or 1) if is_spec else 0)
    counts_ok = (got["launches"] == want[False]
                 and res["launches"] == want[True])
    done_ok = all(r.done and not r.failed and len(r.tokens) == SPEC_NEW
                  for r in res["reqs"] + got["reqs"])
    check = teacher_forced(torch, dev, tf_model, res["reqs"])
    tps, plain_tps = (sum(len(q.tokens) for q in r["reqs"]) / r["wall"]
                      for r in (res, got))
    rec = {"phase": f"spec_{kind}_{name}", "engine": kind,
           "speculative_k": spec.spec_k, "slots": spec.S,
           "steps_per_call": spec.chunk, "prompts": name,
           "requests": n, "new_tokens_each": SPEC_NEW,
           "tokens_per_s": tps, "plain_tokens_per_s": plain_tps,
           "speedup": tps / plain_tps,
           "verify_steps": res["steps"], "plain_decode_steps": got["steps"],
           "launch_groups": groups or None,
           "mean_tokens_per_verify": acceptance(res["effs"]),
           "tokens_equal_to_plain_share": equal_share(res["reqs"],
                                                      got["reqs"]),
           "launches": res["launches"], "expected_launches": want[True],
           "plain_launches": got["launches"],
           "plain_expected_launches": want[False],
           "peak_mem_bytes": res["peak"], "counts_ok": bool(counts_ok),
           "all_done": bool(done_ok),
           **{k: v for k, v in check.items() if k != "ok"},
           "ok": bool(counts_ok and done_ok and check["ok"])}
    _phase(rec)
    return rec


def spec_phase(torch, dev, model):
    """Phase 21: speculative serving at gpt3_1p3b width (``model``,
    seed SEED), ``speculative_k=4``, 16 verify steps a dispatch, 8
    prompts of 128 tokens, 64 new tokens each: repetition-heavy prompts
    (8-token loops) and random ones, through the single-dispatch paged
    engine (``make_engine(model, speculative_k=4)``), the per-layer one
    (``mega=False``), the contiguous engine in bf16 (cache 2048) and in
    int8 (``share_weights_with`` the bf16 one), each beside its plain
    twin (``_spec_case``); then the device ms and launches a verify step
    of each (``decode_device_phase``); then 16 slots x K 8
    single-dispatch, 128 rows a verify in two K8 + K9 groups. Returns
    path -> launches of the speculative batches."""
    import numpy as np
    from paddle_tpu_torch import quantization as quant
    cfg = model.cfg
    L = cfg.n_layers
    rs = np.random.RandomState(SEED + 6)
    sets = {"loops": loop_prompts(cfg.vocab_size, 8),
            "random": [rs.randint(0, cfg.vocab_size, size=128).tolist()
                       for _ in range(8)]}
    blocks = sum(t.numel() for n, t in model.stacked.items()
                 if n in ("wqkv", "wo", "wup", "wdown"))
    head = cfg.vocab_size * cfg.d_model * 2
    groups = spec_groups(8, SPEC_K)
    paths, donor = {}, None
    for kind in ("paged_mega", "paged", "contiguous", "int8"):
        spec = _spec_engine(torch, model, kind, SPEC_K, donor=donor)
        plain = _spec_engine(torch, model, kind, 0, donor=donor)
        teacher = (_TeacherModel(quant.quantize_for_inference(model),
                                 int8=True) if kind == "int8"
                   else _TeacherModel(model))
        total = {}
        for name, prompts in sets.items():
            rec = _spec_case(torch, dev, model, kind, name, spec, plain,
                             prompts, teacher,
                             groups if kind == "paged_mega" else 0)
            for k, v in rec["launches"].items():
                total[k] = total.get(k, 0) + v
        paths[f"spec_{kind}"] = total
        expect = ({"mega_kernel": groups, "logits_kernel": groups}
                  if kind == "paged_mega"
                  else {"paged_kernel": L} if kind == "paged"
                  else {K10_KERNELS[0]: 0} if kind == "contiguous"
                  else {K10_KERNELS[0]: 0, "int8_tiles_sm90": 4 * L})
        decode_device_phase(torch, spec, f"spec_{kind}",
                            blocks if kind == "int8" else 2 * blocks, head,
                            expect, unit="verify", n_new=160)
        del plain, teacher
        # the bf16 contiguous engine lends the int8 one its weights
        donor = spec if kind == "contiguous" else None
        del spec
        torch.cuda.empty_cache()
    slots, K = SPEC_SPLIT
    groups = spec_groups(slots, K)
    if groups != 2:
        _fail(f"the split case takes {groups} launch groups, not 2")
    spec = _spec_engine(torch, model, "paged_mega", K, slots=slots)
    plain = _spec_engine(torch, model, "paged_mega", 0, slots=slots)
    rec = _spec_case(torch, dev, model, "paged_mega", "loops_split", spec,
                     plain, loop_prompts(cfg.vocab_size, slots,
                                         seed=SEED + 7),
                     _TeacherModel(model), groups)
    for k, v in rec["launches"].items():
        paths["spec_paged_mega"][k] += v
    del spec, plain
    torch.cuda.empty_cache()
    return paths


class _TeacherModel:
    """``model`` as ``teacher_forced`` calls it; with ``int8``, the
    forward of a ``quantize_for_inference`` model runs with K12 replaced
    by its plain version, as ``int8_phase``'s check does."""

    def __init__(self, model, int8=False):
        self.model, self.int8 = model, int8

    def __call__(self, *args, **kwargs):
        if not self.int8:
            return self.model(*args, **kwargs)
        from paddle_tpu_torch import quantization as quant
        from paddle_tpu_torch.ops.quant_matmul import int8_matmul_reference
        kernel = quant.int8_matmul
        quant.int8_matmul = int8_matmul_reference
        try:
            return self.model(*args, **kwargs)
        finally:
            quant.int8_matmul = kernel


def serving_paths(torch, dev, gen=None):
    """Every serving path on one gpt3_1p3b (seed SEED): K8 and K9 at the
    single-dispatch engine's shapes (phase 11), paged serving per layer
    and its breakdown (phase 4), single-dispatch paged serving and its
    breakdown (12), contiguous bf16 serving (7), int8 serving (8), the
    decode device time of all four engines (9), generate (10),
    speculative serving on all four (21). Returns (path -> launches, (K8
    record, K9 record))."""
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
    L = cfg.n_layers
    decode_device_phase(torch, eng, "bf16", 2 * blocks, head,
                        {K10_KERNELS[0]: L})
    decode_device_phase(torch, q8, "int8", blocks, head,
                        {K10_KERNELS[0]: L, "int8_rows_sm90": 4 * L})
    del eng, q8, reqs
    torch.cuda.empty_cache()
    for on in (True, False):
        paged = make_engine(model, n_pages=64, max_slots=8,
                            steps_per_call=16, mega=on)
        decode_device_phase(torch, paged, "paged_mega" if on else "paged",
                            2 * blocks, head,
                            {"mega_kernel": 1, "logits_kernel": 1} if on
                            else {"paged_kernel": L})
        del paged
        torch.cuda.empty_cache()
    generated = generate_phase(torch, dev, model)
    torch.cuda.empty_cache()
    spec = spec_phase(torch, dev, model)
    return ({"serving": serve["launches"], "serving_mega": mega["launches"],
             "contiguous": contig["launches"], "int8": int8["launches"],
             "generate": generated["launches"], **spec}, k89)


def breakdown_phase(torch, eng, prompts, n_new, name="serving_breakdown"):
    """Where the serving time goes: a second batch through the same
    engine under torch.profiler, the device time of every CUDA kernel
    summed by family, and the device's busy share of the wall time.
    Reports ``measured: false`` when the profiler records no device
    activity (the measurement is then missing, not zero)."""

    reqs = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
    steps0 = eng.steps
    torch.cuda.synchronize()
    with _profiled(torch) as prof:
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
    an all-ones input; the launch plan, and one kernel in the profiler
    window of one call; device times of the kernel, its plain version
    and F.layer_norm on the precomputed sum (the nearest library call:
    it does the LayerNorm half of the work)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import _hash
    from paddle_tpu_torch.ops import layer_norm as ln
    bf = torch.bfloat16
    x = torch.randn((M, N), generator=gen, device=dev).to(bf)
    res = torch.randn((M, N), generator=gen, device=dev).to(bf)
    gamma = (1 + 0.1 * torch.randn(N, generator=gen, device=dev)).to(bf)
    beta = (0.1 * torch.randn(N, generator=gen, device=dev)).to(bf)
    bias = (0.1 * torch.randn(N, generator=gen, device=dev)).to(bf)
    # the seed on the device, as the encoder's draw_seed passes it
    args = (x, gamma, beta, bias, res, _hash.seed_tensor(seed, dev), 1e-5,
            p)
    plan = ln._plan(M, N, bf, True, torch.cuda.get_device_properties(
        dev).multi_processor_count)
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
    one_call = _one_call_kernels(torch, lambda: ln.fused_layer_norm_fwd(
        *args))
    ms = _device_ms(torch, lambda: ln.fused_layer_norm_fwd(*args),
                    keys=("fused_ln_fwd",), launches=1)
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
           "plan": plan._asdict(),
           "one_call_kernels": [name[:96] for name in one_call],
           "kernel_ms": ms, "plain_ms": plain_ms,
           "library_ms": lib_ms, "library": "F.layer_norm(pre)",
           "bound_ms": bound_ms, "bound_by": bound_by,
           "ok": bool(check["ok"] and ms is not None
                      and len(one_call) == 1
                      and "fused_ln_fwd" in one_call[0])}
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
                       keys=("flash_fwd_",), launches=1)
    k3_ms = _device_ms(torch, lambda: fa.flash_attention_bwd_dkdv(
        q, k, v, do, lse, delta, False, scale, kv_lens, b4, *drop),
        keys=("flash_bwd_dkdv",), launches=1)
    k4_ms = _device_ms(torch, lambda: fa.flash_attention_bwd_dq(
        q, k, v, do, lse, delta, False, scale, kv_lens, b4, *drop),
        keys=("flash_bwd_dq",), launches=1)
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
    with _profiled(torch) as prof:
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
    beside its bound and the card's launch floor (the empty kernel of
    ``launch_floor``, timed the same way), and the launch tax it meters
    (``pallas_launch_tax_s``) beside ``launch_tax_s``'s x + 1 and the
    same readback round around ``clone``."""
    from paddle_tpu_torch.observability import devprof
    from paddle_tpu_torch.ops.launch_probe import (launch_floor, noop_copy,
                                                   noop_copy_cost,
                                                   noop_copy_reference)
    x = torch.randn((8, 128), generator=gen, device=dev)
    n0 = noop_copy.launches
    ys = [noop_copy(x) for _ in range(3)]
    torch.cuda.synchronize()
    exact = all(torch.equal(y, x) for y in ys)
    counted = noop_copy.launches - n0
    ms = _device_ms(torch, lambda: noop_copy(x), ("noop_copy",),
                    launches=1)
    clone_ms = _device_ms(torch, lambda: noop_copy_reference(x))
    f0 = launch_floor.launches
    floor_ms = _device_ms(torch, lambda: launch_floor(dev),
                          ("launch_floor",), launches=1)
    floor = {"kernel": "launch_floor_kernel", "blocks": 1, "threads": 32,
             "memory_bytes": 0, "kernel_ms": floor_ms,
             "launches_counted": launch_floor.launches - f0}
    probe_us = devprof.pallas_launch_tax_s(force=True) * 1e6
    add_us = devprof.launch_tax_s(force=True, device=dev) * 1e6
    clone_us = _readback_us(torch, noop_copy_reference, x)
    flops, nbytes = noop_copy_cost()
    bound_ms, bound_by = _bound(nbytes, flops)
    rec = {"phase": "k13_launch_probe", "shape": [8, 128],
           "dtype": "float32", "exact": exact, "launches_made": 3,
           "launches_counted": counted, "kernel_ms": ms,
           "plain_ms": clone_ms, "library_ms": clone_ms,
           "floor_ms": floor_ms, "launch_floor": floor,
           "timing": "device time (torch.profiler); plain and library: "
                     "x.clone(); floor: the empty kernel; one "
                     "measurement each",
           "launch_tax_probe_us": probe_us, "launch_tax_add_us": add_us,
           "launch_tax_clone_us": clone_us,
           "launch_tax": "median wall time of a launch and a scalar "
                         "readback (devprof.pallas_launch_tax_s, "
                         "launch_tax_s, the same round around clone)",
           "max_abs_err": 0.0 if exact else None,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "ok": bool(exact and counted == 3
                      and None not in (ms, clone_ms, floor_ms))}
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



# phase 20: the MoE GPT (gpt3_1p3b width, 8 experts on every second
# block, gshard top-2) on the card
MOE_EXPERTS, MOE_EVERY = 8, 2
# the train batch (rows of 2048 tokens)
MOE_BATCH = 4
# the gating on the card against the CPU: the same fp32 arithmetic, the
# softmax summed in another order
MOE_GATING_TOL = 1e-6
# step 1's gradients, kernels against plain versions with the same
# experts: phase 5's 2.5e-2 was set on the dense stack (worst there
# 0.019, wpe). The MoE stack's differ more with the same kernels at the
# same shapes: the gate's gradient is a difference of two experts'
# outputs, which cancels, and the experts' outputs (std-0.02 matrices
# at full width) dwarf the residual stream at this init. On the H100
# the worst was 0.0303 (the gate of block 5) with 58-296 tokens a block
# at near-ties the plain route would have sent elsewhere; without the
# replayed experts 0.14-0.52 with 58-1371 tokens a block moved
MOE_GRAD_TOL = 4e-2


def moe_config(gpt):
    """gpt3_1p3b with 8 experts on every second block (12 MoE blocks),
    gshard top-2: about 4.1 B parameters."""
    return gpt.gpt3_1p3b(moe_experts=MOE_EXPERTS, moe_every=MOE_EVERY)


def moe_gating_check(combine, dispatch, aux, ref_combine, ref_dispatch,
                     ref_aux, jitter=None, ref_jitter=None,
                     tol=MOE_GATING_TOL):
    """``top_k_gating`` on the card against the CPU: dispatch equal,
    combine and aux within ``tol``, the jitter (when drawn) bit for
    bit. Tensors on any device; returns a record with ``ok``."""
    combine, ref_combine = combine.cpu(), ref_combine.cpu()
    rec = {"dispatch_mismatches": int((dispatch.cpu()
                                       != ref_dispatch.cpu()).sum()),
           "combine_max_abs_err": float((combine - ref_combine).abs()
                                        .max()),
           "aux_abs_err": abs(float(aux) - float(ref_aux)),
           "kept_choices": int(ref_dispatch.sum()), "tol": tol}
    ok = (rec["dispatch_mismatches"] == 0
          and rec["combine_max_abs_err"] <= tol
          and rec["aux_abs_err"] <= tol)
    if ref_jitter is not None:
        rec["jitter_mismatches"] = int((jitter.cpu()
                                        != ref_jitter.cpu()).sum())
        ok = ok and rec["jitter_mismatches"] == 0
    rec["ok"] = bool(ok)
    return rec


def moe_gating_case(torch, dev):
    """One routing group's fp32 logits (T 1024, E 8), drawn on the CPU
    and copied over, through ``top_k_gating`` on the card and on the CPU
    for both gates at their capacity (gshard top-2: 320; switch top-1,
    jitter 0.01 from ``PRNGKey(SEED)``: 160)."""
    import numpy as np
    from paddle_tpu_torch import random as prng
    from paddle_tpu_torch.incubate import moe
    T, E = 1024, MOE_EXPERTS
    logits = torch.from_numpy(np.random.RandomState(SEED + 5).randn(
        T, E).astype(np.float32))
    cases = {}
    for gate in ("gshard", "switch"):
        r = moe.Routing.for_gate(E, gate)
        cap = r.capacity(T)
        key = prng.PRNGKey(SEED) if r.jitter_eps > 0 else None
        ref = moe.top_k_gating(logits, r.k, cap, key, r.jitter_eps)
        got = moe.top_k_gating(logits.to(dev), r.k, cap, key, r.jitter_eps)
        jit = ref_jit = None
        if key is not None:
            jit = moe._jitter(key, logits.to(dev))
            ref_jit = moe._jitter(key, logits)
        cases[gate] = dict(k=r.k, capacity=cap, **moe_gating_check(
            *got, *ref, jit, ref_jit))
    rec = {"phase": "moe_gating", "tokens": T, "experts": E,
           "cases": cases, "ok": all(c["ok"] for c in cases.values())}
    _phase(rec)
    return rec


def cached_teacher_forced(torch, model, out, s0, routes,
                          tol=TEACHER_FORCED_TOL):
    """Each token ``generate`` emitted within ``tol`` of its row's maximum
    under a teacher-forced run of the same cached route (the prompt,
    then one token at a time, so each call routes the tokens
    ``generate``'s did) with K10 swapped for its plain version and the
    experts of ``routes`` (``generate``'s, recorded) replayed: a flip
    of a near-tie in bf16 sends a token to another expert, whose output
    is a different function. Also the tokens whose own choice differed
    (``flips``), per MoE block."""
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops.decode_attention import (
        decode_attention_reference)
    b, total = out.shape
    kernel = gpt.decode_attention
    gpt.decode_attention = decode_attention_reference
    try:
        with _Routes(torch, replay=routes) as pinned:
            caches = model.init_cache(b, model.cfg.max_seq_len)
            rows = [model.forward_cached(out[:, :s0], caches, 0)[0][:, -1]]
            for pos in range(s0, total - 1):
                rows.append(model.forward_cached(out[:, pos:pos + 1],
                                                 caches, pos)[0][:, -1])
    finally:
        gpt.decode_attention = kernel
    logits = torch.stack(rows, dim=1).float()        # (B, n_new, V)
    toks = out[:, s0:].long()
    gap = logits.max(dim=-1).values - logits.gather(-1, toks[..., None])[
        ..., 0]
    finite = bool(torch.isfinite(logits).all().item())
    worst = gap.max().item()
    n_moe = sum(gpt.is_moe_layer(model.cfg, i)
                for i in range(model.cfg.n_layers))
    return {"teacher_forced_max_gap": worst, "teacher_forced_tol": tol,
            "teacher_forced_exact_frac": (gap == 0).float().mean().item(),
            "routing_flips_per_moe_block": pinned.flips(n_moe),
            "logits_finite": finite, "ok": bool(finite and worst <= tol)}


def moe_generate_phase(torch, dev, model):
    """``GPT.generate`` on the MoE model, greedy, 4 prompts of 128, 32 new
    tokens, cache 2048: K10 = L x 31, every other kernel 0; the cached
    teacher-forced check."""
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
    # again with the routing recorded, for the check to replay
    with _Routes(torch) as routes:
        again = model.generate(toks, max_new_tokens=n_new)
    repeat = bool(torch.equal(again, out))
    check = cached_teacher_forced(torch, model, out, S0, routes)
    rec = {"phase": "moe_generate_gpt3_1p3b", "batch": B,
           "prompt_len": S0, "new_tokens": n_new,
           "cache_len": cfg.max_seq_len, "shape": list(out.shape),
           "wall_s": wall, "tokens_per_s": B * n_new / wall,
           "peak_mem_bytes": peak, "launches": launches,
           "expected_launches": expected,
           "counts_ok": launches == expected, "repeat_equal": repeat,
           **{k: v for k, v in check.items() if k != "ok"},
           "ok": bool(launches == expected and check["ok"] and repeat
                      and tuple(out.shape) == (B, S0 + n_new))}
    _phase(rec)
    return rec


def moe_executed_flops(cfg, B, S):
    """The FLOPs of one MoE train step at its executed shapes: every
    product's forward and its two backward products (one for the
    dispatch einsum, whose one-hot operand takes no gradient), with the
    expert products padded to capacity, the dispatch and combine
    einsums over the one-hot (G, T, E, C) tensor, causal attention over
    the keys each query sees, the full LM head; recomputation not
    counted. ``cfg.flops_per_token()`` (the JAX formula) counts an MoE
    block as one dense FFN."""
    from paddle_tpu_torch.incubate.moe import Routing
    from paddle_tpu_torch.models.gpt import is_moe_layer
    d, f, L, V = cfg.d_model, cfg.d_ffn, cfg.n_layers, cfg.vocab_size
    N = B * S
    kv = 2 * cfg.kv_heads * cfg.head_dim
    r = Routing.for_gate(cfg.moe_experts, cfg.moe_gate)
    T = min(r.tokens_per_group, N)
    G = -(-N // T)
    C = r.capacity(T)
    E = cfg.moe_experts
    dense = 2 * N * d * (d + kv) + 2 * N * d * d
    attn = 2 * 2 * B * S * (S + 1) // 2 * d
    fwd = L * (dense + attn) + 2 * N * d * V
    disp = 0
    for i in range(L):
        if is_moe_layer(cfg, i):
            disp += 2 * G * T * E * C * d
            fwd += (2 * N * d * E + 2 * 2 * G * E * C * d * f
                    + 2 * G * T * E * C * d)
        else:
            fwd += 2 * 2 * N * d * f
    return 3 * fwd + 2 * disp


class _Routes:
    """While open, routes every ``top_k_gating`` call through the gating's
    core (``moe._route``) and keeps, call by call (one a MoE block of a
    forward), each token's experts in round order and the experts that
    kept it (capacity). With ``replay`` (a closed ``_Routes``), round i
    takes the recorded run's choice instead of its own argmax, so a
    plain route runs with a kernel route's experts and drops, and
    ``flips`` counts the tokens whose own argmax rounds would have
    chosen otherwise. The jitter-free gate (gshard) only."""

    def __init__(self, torch, replay=None):
        self.torch, self.replay = torch, replay
        self.choices, self.kept, self._flips = [], [], []

    def __enter__(self):
        from paddle_tpu_torch.incubate import moe
        self._moe, self._orig = moe, moe.top_k_gating
        torch = self.torch

        def gating(logits, k, capacity, rng_key=None, jitter_eps=0.0):
            if jitter_eps > 0.0 and rng_key is not None:
                raise ValueError("_Routes takes the jitter-free gate")
            call, own = len(self.choices), []

            def choose(masked_probs, i):
                own.append(torch.argmax(masked_probs, dim=-1))
                if self.replay is None:
                    return own[-1]
                return self.replay.choices[call][..., i]

            out = moe._route(logits, k, capacity, choose)
            with torch.no_grad():
                mine = torch.stack(own, dim=-1)
                chosen = (mine if self.replay is None
                          else self.replay.choices[call])
                self.choices.append(chosen)
                self.kept.append(out[1].any(dim=-1))
                self._flips.append((mine != chosen).any(dim=-1).sum())
            return out

        moe.top_k_gating = gating
        return self

    def __exit__(self, *exc):
        self._moe.top_k_gating = self._orig
        return False

    def flips(self, n_moe):
        """Tokens whose own choice differed from the replayed one, summed
        per MoE block (calls cycle through the ``n_moe`` blocks)."""
        per_call = [int(f) for f in self._flips]
        return [sum(per_call[j::n_moe]) for j in range(n_moe)]


def moe_train_phase(torch, dev, model, n_steps=6):
    """MoE train steps (phase 20): bf16-moment AdamW (lr 1e-4, wd 0.01),
    a fixed MOE_BATCH x 2048 batch, ``PRNGKey(0)`` the step key. Step 1
    through the kernels with its routing recorded, then through the
    plain versions with those experts replayed (``_Routes``), from the
    same weights (the start weights and the kernel gradients kept in
    host memory): losses within 1e-3 relative, every gradient within
    MOE_GRAD_TOL relative L2, the tokens whose own choice differed
    printed per MoE block. Then the kernel steps from the start weights, counted: the
    loss falls; K1 = K3 = K4 = L a step, every other kernel 0; step time,
    tokens/s, MFU by the JAX formula and by the executed FLOPs, peak
    memory and a profiler breakdown."""
    import numpy as np
    from paddle_tpu_torch import random as prng
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops.flash_attention import flash_attention_plain
    from paddle_tpu_torch.optimizer import AdamW

    cfg = model.cfg
    B, S, L = MOE_BATCH, cfg.max_seq_len, cfg.n_layers
    n_moe = sum(gpt.is_moe_layer(cfg, i) for i in range(L))
    tokens = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (B, S)).astype(np.int32)).to(dev)
    key = prng.PRNGKey(0)
    # host copies (copy=True: a CPU rehearsal must not alias them)
    start = {n: p.detach().to("cpu", copy=True)
             for n, p in model.named_parameters()}

    def optimizer():
        return AdamW(learning_rate=1e-4, weight_decay=0.01,
                     moment_dtype=torch.bfloat16)

    def plain_attn(q, k, v, is_causal=False):
        return flash_attention_plain(q, k, v, causal=is_causal)

    def restart():
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(start[n])
                p.grad = None

    def step_one(attn, routes):
        opt = optimizer()
        params, state = gpt.init_train_state(model, opt)
        step = gpt.build_train_step(model, opt, attn=attn)
        t0 = time.perf_counter()
        with routes:
            loss = step(params, state, tokens, key)[2].item()
        return loss, time.perf_counter() - t0, params

    kernel_routes = _Routes(torch)
    kernel_loss, _, params = step_one(None, kernel_routes)
    kernel_grads = {n: p.grad.to("cpu", copy=True)
                    for n, p in params.items()}
    restart()
    pinned = _Routes(torch, replay=kernel_routes)
    plain_loss, plain_step_s, params = step_one(plain_attn, pinned)
    grad_err = {}
    for n, p in params.items():
        ref = p.grad.float()
        got = kernel_grads.pop(n).to(dev).float()
        grad_err[n] = ((got - ref).norm()
                       / ref.norm().clamp(min=1e-30)).item()
    del params, kernel_routes
    restart()
    del start

    opt = optimizer()
    params, state = gpt.init_train_state(model, opt)
    step = gpt.build_train_step(model, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counters()
    losses, step_s = [], []
    for i in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss = step(params, state, tokens, key)
        losses.append(loss.item())          # synchronizes
        step_s.append(time.perf_counter() - t0)
    launches = _read_counters()
    peak = torch.cuda.max_memory_allocated(dev)
    expected = {n: 0 for n in launches}
    expected.update({"flash_attention": L, "flash_attention_bwd_dkdv": L,
                     "flash_attention_bwd_dq": L})
    per_step = {n: c / n_steps for n, c in launches.items()}
    counts_ok = all(per_step[n] == e for n, e in expected.items())
    loss_rel = abs(kernel_loss - plain_loss) / abs(plain_loss)
    loss_tol, grad_tol = 1e-3, MOE_GRAD_TOL
    worst = max(grad_err, key=grad_err.get)
    over = {n: e for n, e in grad_err.items() if e > grad_tol}
    over_dense_tol = sum(e > 2.5e-2 for e in grad_err.values())
    timed = sorted(step_s[1:])               # step 1 pays first-use costs
    med = timed[len(timed) // 2]
    tok_s = B * S / med
    executed = moe_executed_flops(cfg, B, S)
    rec = {"phase": "moe_train_gpt3_1p3b", "params": sum(
               p.numel() for p in model.parameters()),
           "num_params_jax_formula": cfg.num_params(), "layers": L,
           "moe_layers": n_moe,
           "experts": cfg.moe_experts, "gate": cfg.moe_gate,
           "d_model": cfg.d_model, "batch": B, "seq": S,
           "kernel_step1_loss": kernel_loss,
           "step1_repeat_equal": losses[0] == kernel_loss,
           "plain_step1_loss": plain_loss, "plain_step1_s": plain_step_s,
           "losses": losses, "step1_loss_rel_err": loss_rel,
           "loss_tol_rel": loss_tol,
           "grad_rel_l2_max": grad_err[worst], "grad_rel_l2_worst": worst,
           "grad_over_tol": over, "grad_tol_rel_l2": grad_tol,
           "grads_over_phase5_tol": over_dense_tol,
           "routing_flips_per_moe_block": pinned.flips(n_moe),
           "tokens_per_moe_block": B * S,
           "step_s": step_s, "step_ms_median": med * 1e3,
           "tokens_per_s": tok_s,
           "flops_per_token": cfg.flops_per_token(),
           "mfu": cfg.flops_per_token() * tok_s / H100_BF16_FLOPS,
           "executed_flops_per_step": executed,
           "mfu_executed": executed / med / H100_BF16_FLOPS,
           "peak_mem_bytes": peak, "launches": launches,
           "launches_per_step": per_step, "expected_per_step": expected,
           "counts_ok": bool(counts_ok),
           "ok": bool(all(np.isfinite(losses)) and counts_ok
                      and loss_rel <= loss_tol and not over
                      and losses[-1] < losses[0])}
    _phase(rec)
    train_breakdown(torch, step, params, state, tokens, key,
                    name="moe_train_breakdown")
    # the optimizer's share of a step: one more AdamW update over the
    # last step's gradients (4.1 B values, cast to fp32 entry by entry)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt.update({n: p.grad for n, p in params.items()}, state, params)
    torch.cuda.synchronize()
    print(json.dumps({"phase": "moe_adamw_update",
                      "ms": (time.perf_counter() - t0) * 1e3}), flush=True)
    return rec


def moe_phase(torch, dev):
    """Phase 20: the MoE GPT at gpt3_1p3b width from seed 0: the gating on
    the card against the CPU, ``generate``, and training. Returns the
    launches of the generate and train paths."""
    from paddle_tpu_torch.models import gpt
    moe_gating_case(torch, dev)
    t0 = time.perf_counter()
    model = gpt.GPT(moe_config(gpt), seed=SEED, device=dev)
    torch.cuda.synchronize()
    print(json.dumps({"phase": "moe_init", "config": str(model.cfg),
                      "seconds": time.perf_counter() - t0}), flush=True)
    generated = moe_generate_phase(torch, dev, model)
    torch.cuda.empty_cache()
    trained = moe_train_phase(torch, dev, model)
    del model
    torch.cuda.empty_cache()
    return {"moe_generate": generated["launches"],
            "moe_train": trained["launches"]}


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
                             table_rows=[0] * 64, name="_suffix"))
    # the per-layer verify's shape (phase 21): SPEC_K rows for each of
    # 8 slots, the slot's table row repeated, row j of a slot with n
    # cached tokens seeing n + j + 1 keys, over a table of T 2048
    k2v = k2_plain_case(torch, dev, gen, 16, *verify_rows(SPEC_K),
                        name="_verify", max_pages=16)
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
    paths["train_options"] = train_options_phase(torch, dev,
                                                 train)["launches"]
    torch.cuda.empty_cache()
    paths["train_sweep"] = train_sweep_phase(torch, dev)["launches"]
    torch.cuda.empty_cache()
    paths.update(moe_phase(torch, dev))
    torch.cuda.empty_cache()
    paths["encoder"] = encoder_phase(torch, dev)["launches"]
    torch.cuda.empty_cache()
    paths["fused_layers"] = fused_layers_phase(torch, dev)["launches"]
    torch.cuda.empty_cache()
    paths["slice"] = slice_phase(torch, dev)["launches"]

    def entry(name, source, replaces, ms, plain_ms, bound, library_ms,
              err, counter=None, only=None, design=None):
        by_path = {p: launches[counter or name]
                   for p, launches in paths.items()
                   if only is None or p == only}
        return {"name": name, "route": "cuda",
                "source": f"paddle_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": library_ms,
                **({"design": design} if design else {})}

    def paged_entry(name, replaces, main, recs):
        return entry(name, "paged_attention.cu", replaces,
                     main["kernel_ms"], main["plain_ms"],
                     (main["bound_ms"], main["bound_by"]),
                     main["library_ms"],
                     max(r["max_abs_err"] for r in recs),
                     design="bulk-copied page tiles, a cluster per (row, "
                            "kv head), csrc/decode_attn.cuh")

    def rows_ms(rec, key):
        # device ms and bound at B 8 and at the verify rows (phase 11)
        return {str(b): {"ms": r["kernel_ms"], "bound_ms": r["bound_ms"]}
                for b, r in [(8, rec)] + [(r[key], r)
                                          for r in rec["spec_rows"]
                                          if "kernel_ms" in r]}

    fa_py = "paddle_tpu/ops/pallas/flash_attention.py"
    ce_py = "paddle_tpu/ops/pallas/fused_ce.py"
    k34m, ce_r = k34[0], k567
    # the kernels built on TMA + warp-specialised wgmma (their shared
    # Hopper pieces in csrc/sm90.cuh)
    wgmma = "TMA + wgmma, csrc/sm90.cuh"
    print(json.dumps({"kernels": [
        entry("flash_attention", "flash_attention_fwd.cu", f"{fa_py}:213",
              k1[0]["kernel_ms"], k1[0]["plain_ms"],
              (k1[0]["bound_ms"], k1[0]["bound_by"]), k1[0]["library_ms"],
              max(r["max_abs_err"] for r in k1), design=wgmma),
        paged_entry("paged_append_attend",
                    "paddle_tpu/ops/pallas/paged_attention.py:306", k2[0],
                    k2),
        # ms: the suffix prefill's 64 rows over one sequence; verify_ms:
        # the per-layer verify's 8 x SPEC_K rows (max_abs_err over both)
        dict(paged_entry("paged_decode_attention",
                         "paddle_tpu/ops/pallas/paged_attention.py:306",
                         k2p[-1], k2p + [k2v]),
             verify_ms={"rows": k2v["B"], "ms": k2v["kernel_ms"],
                        "plain_ms": k2v["plain_ms"],
                        "bound_ms": k2v["bound_ms"],
                        "bound_by": k2v["bound_by"]}),
        entry("flash_attention_bwd_dkdv", "flash_attention_bwd.cu",
              f"{fa_py}:395", k34m["k3_kernel_ms"], k34m["plain_ms"],
              (k34m["k3_bound_ms"], k34m["k3_bound_by"]),
              k34m["library_ms"],
              max(max(r["max_abs_err"]["dk"], r["max_abs_err"]["dv"])
                  for r in k34), design=wgmma),
        entry("flash_attention_bwd_dq", "flash_attention_bwd.cu",
              f"{fa_py}:433", k34m["k4_ms"], k34m["plain_ms"],
              (k34m["k4_bound_ms"], k34m["k4_bound_by"]),
              k34m["library_ms"],
              max(r["max_abs_err"]["dq"] for r in k34), design=wgmma),
        entry("fused_ce_fwd", "fused_ce.cu", f"{ce_py}:153", ce_r["k5_ms"],
              ce_r["plain_fwd_ms"], (ce_r["k5_bound_ms"],
                                     ce_r["k5_bound_by"]),
              ce_r["library_fwd_ms"],
              max(ce_r["loss_max_abs_err"], ce_r["lse_max_abs_err"]),
              design=wgmma),
        # the backward's three kernels (fused_ce_bwd.cu), each one launch
        # per vocab chunk: the dl pass computes the dlogits that the TPU's
        # K6 and K7 each recompute; library: the backward of torch.matmul
        # + F.cross_entropy (dx and dw together)
        entry("fused_ce_dl", "fused_ce_bwd.cu", f"{ce_py}:178",
              ce_r["dl_ms"], ce_r["plain_bwd_ms"],
              (ce_r["dl_bound_ms"], ce_r["dl_bound_by"]),
              ce_r["library_bwd_ms"],
              max(max(c["dx_max_abs_err"], c["dw_max_abs_err"])
                  for c in (ce_r["check_init_head"],
                            ce_r["check_peaked"])), design=wgmma),
        entry("fused_ce_dx", "fused_ce_bwd.cu", f"{ce_py}:178",
              ce_r["k6_ms"], ce_r["plain_bwd_ms"],
              (ce_r["k6_bound_ms"], ce_r["k6_bound_by"]),
              ce_r["library_bwd_ms"],
              max(c["dx_max_abs_err"] for c in (ce_r["check_init_head"],
                                                ce_r["check_peaked"])),
              design=wgmma),
        entry("fused_ce_dw", "fused_ce_bwd.cu", f"{ce_py}:199",
              ce_r["k7_ms"], ce_r["plain_bwd_ms"],
              (ce_r["k7_bound_ms"], ce_r["k7_bound_by"]),
              ce_r["library_bwd_ms"],
              max(c["dw_max_abs_err"] for c in (ce_r["check_init_head"],
                                                ce_r["check_peaked"])),
              design=wgmma),
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
        # the prefill tiles (M > 16): one layer's four products at M 128,
        # a prefill chunk of the int8 engine (launches: the int8 path's,
        # decode rows included; one counter serves both routes)
        entry("int8_matmul[prefill]", "quant_matmul.cu",
              "paddle_tpu/ops/pallas/quant_matmul.py:91",
              k12["prefill_layer_ms"], k12["prefill_layer_plain_ms"],
              (k12["prefill_layer_bound_ms"], "bytes"),
              k12["prefill_layer_library_ms"], k12["max_abs_err"],
              counter="int8_matmul", only="int8", design=wgmma),
        # all 24 layers of one decode step at B 8 (rows_ms: also at a
        # verify's 32 and 64 rows); max_abs_err over every row count
        dict(entry("mega_decode_layers", "decode_megakernel.cu",
                   "paddle_tpu/ops/pallas/decode_megakernel.py:366",
                   k8["kernel_ms"], k8["plain_ms"],
                   (k8["bound_ms"], k8["bound_by"]), None,
                   max([k8["max_abs_err"]]
                       + [r["max_abs_err"] for r in k8["spec_rows"]]),
                   design=wgmma),
             rows_ms=rows_ms(k8, "rows")),
        # max_abs_err: the worst gap between the picked token's plain
        # logit and the row's plain maximum
        # context_ms: F.layer_norm, the head product and argmax, the
        # three calls a user would write (no one call computes K9's
        # function)
        dict(entry("mega_logits_sample", "decode_megakernel.cu",
                   "paddle_tpu/ops/pallas/decode_megakernel.py:458",
                   k9["kernel_ms"], k9["plain_ms"],
                   (k9["bound_ms"], k9["bound_by"]), None,
                   max([k9["check"]["token_logit_gap_max"]]
                       + [r["check"]["token_logit_gap_max"]
                          for r in k9["spec_rows"]]),
                   design=f"{k9['route']}: TMA head stream + wgmma, "
                          f"csrc/sm90.cuh"),
             context_ms=k9["context_ms"], rows_ms=rows_ms(k9, "B")),
        # at the encoder's rows, N 768; library: F.layer_norm on the sum
        entry("fused_layer_norm", "layer_norm.cu",
              "paddle_tpu/ops/pallas/layer_norm.py:120",
              k11[0]["kernel_ms"], k11[0]["plain_ms"],
              (k11[0]["bound_ms"], k11[0]["bound_by"]),
              k11[0]["library_ms"], max(r["max_abs_err"] for r in k11),
              design="a warp per row (a block past N 1024), the row in "
                     "registers, 16-byte accesses"),
        # K1, K3, K4 with the padding bias (no kv_lens) and dropout at
        # the encoder's shape, as the encoder path launches them;
        # library: sdpa with the same float mask and its own dropout
        entry("flash_attention[bias+dropout]", "flash_attention_fwd.cu",
              f"{fa_py}:213", k134[0]["k1_ms"], k134[0]["plain_fwd_ms"],
              (k134[0]["k1_bound_ms"], k134[0]["k1_bound_by"]),
              k134[0]["library_fwd_ms"],
              max(r["max_abs_err"] for r in k134),
              counter="flash_attention", only="encoder", design=wgmma),
        entry("flash_attention_bwd_dkdv[bias+dropout]",
              "flash_attention_bwd.cu", f"{fa_py}:395", k134[0]["k3_ms"],
              k134[0]["plain_bwd_ms"],
              (k134[0]["k3_bound_ms"], k134[0]["k3_bound_by"]),
              k134[0]["library_bwd_ms"],
              max(r["max_abs_err"] for r in k134),
              counter="flash_attention_bwd_dkdv", only="encoder",
              design=wgmma),
        entry("flash_attention_bwd_dq[bias+dropout]",
              "flash_attention_bwd.cu", f"{fa_py}:433", k134[0]["k4_ms"],
              k134[0]["plain_bwd_ms"],
              (k134[0]["k4_bound_ms"], k134[0]["k4_bound_by"]),
              k134[0]["library_bwd_ms"],
              max(r["max_abs_err"] for r in k134),
              counter="flash_attention_bwd_dq", only="encoder",
              design=wgmma),
        # one (8, 128) fp32 copy; plain and library: x.clone();
        # floor_ms: the card's launch floor (an empty kernel)
        dict(entry("noop_copy", "launch_probe.cu",
                   "paddle_tpu/observability/devprof.py:291",
                   k13["kernel_ms"], k13["plain_ms"],
                   (k13["bound_ms"], k13["bound_by"]), k13["library_ms"],
                   k13["max_abs_err"]),
             floor_ms=k13["floor_ms"]),
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
