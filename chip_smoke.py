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
   (CUDA events), its plain version's time, the library call's time
   where PyTorch has one call for the same function, and its bound: the
   larger of bytes / 3.35 TB/s and FLOPs / 989.4 TFLOP/s;
4. serving — gpt3_1p3b at full width (random weights from a seed)
   through ``make_engine``: 8 prompts of 128 tokens plus one that shares
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
   torch.profiler breakdown of one step.

Then one ``{"kernels": [...]}`` line, the card line, and the last line
``{"ok": true, "device": {...}}``. Imports neither jax nor paddle_tpu.
"""

import json
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
# dense bf16 tensor-core peak (the JAX bench's MFU denominator too)
H100_BF16_FLOPS = 989.4e12
# a bf16 output rounds each entry by at most 2^-8 of itself (about 2^-9
# root mean square): the kernels' outputs are held within 2^-7 relative
# L2 of their plain versions, per tile or row that one block writes
REL_L2_TOL = 2.0 ** -7
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


def _bound(nbytes, flops):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOPS * 1e3
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
    and the whole tensor's."""
    B, S, H, D = ref.shape
    t = (-1, rows, H, D)
    worst = rel_l2(got.reshape(t), ref.reshape(t), (1, 3)).max().item()
    return worst, rel_l2(got.reshape(1, -1), ref.reshape(1, -1),
                         (1,)).item()


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


def k1_case(torch, dev, S, hkv, gen, B=1):
    from paddle_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)
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
    ms = _event_ms(torch, lambda: flash_attention(q, k, v, causal=True))
    plain_ms = _event_ms(torch, lambda: flash_attention_reference(
        q, k, v, causal=True), iters=5 if B == 1 else 2, warmup=1)
    # the library call on head-major copies, kv heads expanded for GQA
    # outside the timed region
    qt, kt, vt = (x.repeat_interleave(Hq // x.shape[2], dim=2)
                  .transpose(1, 2).contiguous() for x in (q, k, v))
    lib_ms = _event_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    elt = q.element_size()
    nbytes = (2 * B * S * Hq * D + 2 * B * S * hkv * D) * elt \
        + B * Hq * S * 4
    flops = 4 * B * Hq * D * S * (S + 1) // 2
    bound_ms, bound_by = _bound(nbytes, flops)
    rec = {"phase": f"k1_flash_fwd_B{B}_S{S}_hkv{hkv}", "B": B, "S": S,
           "Hq": Hq, "Hkv": hkv, "D": D, "dtype": "bfloat16",
           "max_abs_err": err, "tol": tol, "lse_max_abs_err": lse_err,
           "lse_tol": lse_tol, "tile_rel_l2_max": tile_err,
           "tol_rel_l2": REL_L2_TOL, "kernel_ms": ms, "plain_ms": plain_ms,
           "library_ms": lib_ms, "bound_ms": bound_ms,
           "bound_by": bound_by,
           "ok": bool(err <= tol and lse_err <= lse_tol
                      and tile_err <= REL_L2_TOL)}
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


def _paged_bytes(q, kp, lengths, hkv, rows=0):
    elt = q.element_size()
    D = q.shape[-1]
    kv = 2 * sum(lengths) * hkv * D * elt
    return (2 * q.numel() * elt + kv + 8 * q.shape[0] * 4
            + rows * 2 * q.shape[0] * hkv * D * elt)


def k2_fused_case(torch, dev, gen, hkv):
    from paddle_tpu_torch.ops.paged_attention import (
        paged_append_attend, paged_append_attend_reference)
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
    ms = _event_ms(torch, lambda: paged_append_attend(
        q, kp1, vp1, k_row, v_row, table, wp, lens))
    plain_ms = _event_ms(torch, lambda: paged_append_attend_reference(
        q, kp2, vp2, k_row, v_row, table, wp, lens), iters=5)
    n_ctx = [n + 1 for n in lengths]
    nbytes = _paged_bytes(q, kp0, lengths, hkv, rows=2)
    flops = 4 * sum(n_ctx) * q.shape[1] * D
    bound_ms, bound_by = _bound(nbytes, flops)
    rec = {"phase": f"k2_paged_fused_hkv{hkv}", "B": B, "Hq": q.shape[1],
           "Hkv": hkv, "D": D, "page": page, "lengths": lengths,
           "dtype": "bfloat16", "max_abs_err": err, "tol": tol,
           "row_rel_l2_max": row_err, "tol_rel_l2": REL_L2_TOL,
           "pool_write_exact": rows_ok, "kernel_ms": ms,
           "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
           "bound_by": bound_by,
           "ok": bool(err <= tol and row_err <= REL_L2_TOL and rows_ok)}
    _phase(rec)
    return rec


def k2_plain_case(torch, dev, gen, hkv, lengths, table_rows=None,
                  name=""):
    from paddle_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_reference)
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
    ms = _event_ms(torch, lambda: paged_decode_attention(q, kp, vp, table,
                                                         lens))
    plain_ms = _event_ms(torch, lambda: paged_decode_attention_reference(
        q, kp, vp, table, lens), iters=5)
    D = q.shape[-1]
    nbytes = _paged_bytes(q, kp, lengths if table_rows is None
                          else [max(lengths)], hkv)
    flops = 4 * sum(lengths) * q.shape[1] * D
    bound_ms, bound_by = _bound(nbytes, flops)
    rec = {"phase": f"k2p_paged_plain{name}_hkv{hkv}", "B": len(lengths),
           "Hq": q.shape[1], "Hkv": hkv, "D": D, "page": kp.shape[2],
           "dtype": "bfloat16", "max_abs_err": err, "tol": tol,
           "row_rel_l2_max": row_err, "tol_rel_l2": REL_L2_TOL,
           "stats_ok": stats_ok, "kernel_ms": ms, "plain_ms": plain_ms,
           "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
           "ok": bool(err <= tol and row_err <= REL_L2_TOL and stats_ok)}
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


def _train_counters():
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_ce as ce
    return {"flash_attention": fa.flash_attention,
            "flash_attention_bwd_dkdv": fa.flash_attention_bwd_dkdv,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
            "fused_ce_fwd": ce.fused_ce_fwd, "fused_ce_dx": ce.fused_ce_dx,
            "fused_ce_dw": ce.fused_ce_dw}


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
    counters = _train_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in counters.values():
        fn.launches = 0
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
    launches = {n: fn.launches for n, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    L = cfg.n_layers
    expected = {"flash_attention": L, "flash_attention_bwd_dkdv": L,
                "flash_attention_bwd_dq": L, "fused_ce_fwd": 1,
                "fused_ce_dx": 1, "fused_ce_dw": 1}
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
             ("paged_attention", ("paged_kernel",)))


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


def serving_phase(torch, dev):
    import numpy as np
    from paddle_tpu_torch import stats
    from paddle_tpu_torch.inference.factory import make_engine
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.nn.functional import attention_reference
    from paddle_tpu_torch.ops.flash_attention import flash_attention
    from paddle_tpu_torch.ops.paged_attention import (
        paged_append_attend, paged_decode_attention)

    cfg = gpt.gpt3_1p3b()
    t0 = time.perf_counter()
    model = gpt.GPT(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    chunk, n_new = 16, 64
    eng = make_engine(model, n_pages=64, max_slots=8, steps_per_call=chunk)
    rs = np.random.RandomState(SEED)
    prompts = [rs.randint(0, cfg.vocab_size, size=128).tolist()
               for _ in range(8)]
    prompts.append(prompts[0][:128]
                   + rs.randint(0, cfg.vocab_size, size=40).tolist())

    stats.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    flash_attention.launches = 0
    paged_append_attend.launches = 0
    paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention.launches,
                "paged_append_attend": paged_append_attend.launches,
                "paged_decode_attention": paged_decode_attention.launches}
    peak = torch.cuda.max_memory_allocated(dev)

    L = cfg.n_layers
    n_suffix = int(stats.get("serve/dispatches/prefill_suffix"))
    n_cold = len(prompts) - n_suffix
    decode_steps = eng.steps * eng.chunk
    counts_ok = (launches["flash_attention"] == L * n_cold
                 and launches["paged_append_attend"] == L * decode_steps
                 and launches["paged_decode_attention"] > 0
                 and n_suffix == 1)
    done_ok = all(r.done and not r.failed and len(r.tokens) == n_new
                  for r in reqs)

    # teacher-forced check: each emitted token's logit within `tol` of
    # its row's maximum under a plain forward (plain attention, bf16):
    # four bf16 ulps at |logit| in [4, 8) — the two paths round their
    # bf16 matmuls at different shapes (8 decode rows vs one sequence)
    tol = 0.125
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
    # exact medians over the requests' own timestamps (upper median)
    ttfts = sorted(r.ttft_s for r in reqs)
    tpots = sorted(r.tpot_s for r in reqs)
    n_tok = sum(len(r.tokens) for r in reqs)
    rec = {"phase": "serving_gpt3_1p3b", "params": cfg.num_params(),
           "layers": L, "d_model": cfg.d_model, "slots": 8,
           "steps_per_call": chunk, "requests": len(reqs),
           "new_tokens": n_tok, "init_s": init_s, "wall_s": wall,
           "tokens_per_s": n_tok / wall,
           "ttft_p50_s": ttfts[len(ttfts) // 2], "ttft_max_s": ttfts[-1],
           "tpot_p50_s": tpots[len(tpots) // 2], "tpot_max_s": tpots[-1],
           "peak_mem_bytes": peak, "launches": launches,
           "cold_prefills": n_cold, "suffix_prefills": n_suffix,
           "decode_steps": decode_steps, "dispatches": eng.steps,
           "counts_ok": bool(counts_ok), "all_done": bool(done_ok),
           "teacher_forced_max_gap": worst, "teacher_forced_tol": tol,
           "teacher_forced_exact_frac": exact / max(1, total),
           "logits_finite": finite,
           "ok": bool(counts_ok and done_ok and finite and worst <= tol)}
    _phase(rec)
    # fresh prompts: a cold batch like the first, not prefix-cache hits
    breakdown_phase(torch, eng, [rs.randint(0, cfg.vocab_size,
                                            size=128).tolist()
                                 for _ in range(8)], n_new)
    return rec


def breakdown_phase(torch, eng, prompts, n_new):
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
    rec = {"phase": "serving_breakdown", "requests": len(reqs),
           "wall_ms": wall_us / 1e3}
    bd = _device_breakdown(prof, wall_us)
    rec["measured"] = bd is not None
    if bd is not None:
        rec.update(bd)
        rec.update({"decode_steps": (eng.steps - steps0) * eng.chunk,
                    "new_tokens": sum(len(r.tokens) for r in reqs)})
    rec["ok"] = all(r.done and not r.failed for r in reqs)
    _phase(rec)


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
    torch.cuda.empty_cache()
    serve = serving_phase(torch, dev)
    torch.cuda.empty_cache()
    train = train_phase(torch, dev)

    def entry(name, source, replaces, ms, plain_ms, bound, library_ms,
              err):
        by_path = {"serving": serve["launches"].get(name, 0),
                   "train": train["launches"].get(name, 0)}
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
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
