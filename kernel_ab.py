#!/usr/bin/env python3
"""A/B readings of the flash kernels K1, K3 and K4, the fused
cross-entropy kernels K5, K6 and K7, the contiguous engine's decode
kernels K10 and K12, the paged engines' K2, K2' and K9, and the
encoder's K11 and the launch probe K13 on one GPU.

    python3 kernel_ab.py DIR_A DIR_B [--rounds 1] [--ce-chunks 2048,8192]
        [--ce-plans 2,33] [--paged-plans 2x4,8x4] [--only decode|encoder]

DIR_A and DIR_B are checkouts of the repository (for example a parent
commit unpacked with ``git archive`` and the working tree ``.``). Each
round runs A, B, B, A, so that a drift over the run falls on both
alike. Every run is a process of its own, started in its checkout's
root: it builds that checkout's kernels and times them in bf16. At the
GPT paths' shapes, without a bias or dropout (their calls): K1 at the
serving shapes (B 1, S 128 and 512, 16 heads of 128, causal) and at the
train shape (B 4, S 2048), K3 and K4 at the train shape. At the
incubate encoder's (B 16, S 512, 12 heads of 64, not causal), with its
padding bias (lengths 128..512) and hash dropout 0.1, as the encoder
calls them: K1, K3 and K4. The cross-entropy at the train shape (N 4
x 2047, d 2048, V 50304, every 7th label ignored, w at the init's std
0.02): K5 (the forward) and the backward, K6 + K7 together with
everything they launch (``fused_ce_bwd`` where the checkout has it,
else ``fused_ce_dx`` then ``fused_ce_dw``). At the contiguous engine's
decode shape (``chip_smoke.py``'s K10 and K12 cases): K10 over B 8 rows
of lengths 0..2047, 16 query heads over 16 and over 4 kv heads of 128,
T 2048, caches cold, without and with the step's fresh rows (``_write``:
written inside K10 where the checkout's wrapper takes them, else by the
index ops ``GPTBlock._write_kv_rows`` wrote them with before K10, all
launches counted); K12 on gpt3_1p3b's four block products at M 8 (the
decode rows) and M 32, 128 and 512 (the int8 engine's prefill buckets),
weights cold, each beside ``torch.matmul`` on the dequantized weight
(``library_ms``) and its bound (``bound_ms``: the int8 weight, the
scales, x and the output once at 3.35 TB/s, or the flops at 989.4
TFLOP/s), and one layer's four summed at M 8 and at M 128
(``k12_layer_M8``, ``k12_layer_M128``); at ``chip_smoke.py``'s paged
and single-dispatch shapes: K2 (``k2_fused``: B 8 rows of lengths 0..255
over a table of 2 pages of 128, 16 heads of 128, the fresh rows written;
``k2_fused_engine``: the per-layer engine's table of 16 pages, lengths
128..184), K2' (``k2p_suffix``: the suffix prefill's 64 rows over one
sequence, row t seeing min(129 + t, 168) tokens) and K9 (``k9_B8_tied``:
B 8 rows, gpt3_1p3b's tied head, V 50,304, read cold by every call, as
it is 0.21 GB); at ``chip_smoke.py`` phase 13's shapes and seed: K11
(``k11_N768``, ``k11_N1024``, ``k11_N1000``: M 8192 rows, bf16, bias,
residual and hash dropout 0.1, each checkout through its own
``fused_layer_norm_fwd``; at N 768 also without dropout, without the
residual and with neither, beside ``torch.add(x, res)`` and a copy of x,
the same bytes of three and two streams), and K13 (``k13_noop_copy``)
beside ``clone`` (``k13_clone``) and the card's launch floor
(``launch_floor``: the empty kernel, where the checkout has it), 100
calls a window. Each time is read twice: the call's device time from a
torch.profiler trace (``kernel_ms``; the CE backward and K10 sum every
kernel in the window) and the call's,
wrapper included, by CUDA events around back-to-back calls
(``call_ms``). Every device time goes through this checkout's
``chip_smoke._device_ms`` (loaded by path, so a parent checkout is
timed the same way): a profiler window counts only when it holds the
launches the calls made (the caller's count, or for a sum of every
kernel the median of three one-call windows' counts), a short window
is profiled again, and after three short windows the case reads None.
``--ce-chunks`` also times a checkout's ``fused_ce_bwd`` at those vocab
chunk widths (its default is timed as above), and ``--ce-plans`` K5 with
its vocab tiles cut into about that many ranges (where the checkout
plans them with ``fused_ce._plan``), and ``--paged-plans`` K2 and K2'
under each (cluster size)x(ring slots) geometry given (where the
checkout picks them with ``paged_attention.cluster_size`` and
``ring_stages``). ``--only decode`` times K10, K12, K2, K2' and K9
alone, ``--only encoder`` K11 and K13 alone. Prints each run's readings
as one JSON line tagged with its checkout and round, then one line with
each checkout's medians and the range (least, most) of its runs. Exits
non-zero if a run fails.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

_CHILD = r"""
import importlib.util, inspect, itertools, json, statistics, sys, torch
sys.path.insert(0, ".")
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import fused_ce as ce
if not torch.cuda.is_available():
    sys.exit("kernel_ab: no CUDA device")


# the launch-checked profiler windows of this script's own chip_smoke.py
# (loaded by path: the run's checkout may be one without them)
_spec = importlib.util.spec_from_file_location("_ab_timing", sys.argv[4])
_timing = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_timing)


def device_ms(fn, keys, iters, launches=None):
    # keys None: every kernel; launches None: one call's count, measured
    return _timing._device_ms(torch, fn, keys=keys, launches=launches,
                              iters=iters)


def call_ms(fn, iters):
    for _ in range(3):
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


dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev)
gen.manual_seed(0)
out = {}
ONLY = sys.argv[3]


# K12's kernels in either checkout (the parent's prefill route was
# ``tiles_kernel``); one of them a bf16 call
K12_KERNELS = ("int8_rows_sm90", "int8_tiles_sm90", "tiles_kernel")


def cold(ops, nbytes):
    # enough copies of ops that a loop over them reads twice the 50 MB L2
    n = max(1, -(-100_000_000 // nbytes))
    copies = [ops] + [tuple(t.clone() for t in ops) for _ in range(n - 1)]
    return itertools.cycle(copies).__next__


def decode_cases():
    from paddle_tpu_torch.ops import decode_attention as da
    from paddle_tpu_torch.ops import quant_matmul as qm
    from paddle_tpu_torch.quantization import quantize_tensor
    bf = torch.bfloat16
    lengths = [0, 1, 127, 128, 517, 1023, 1024, 2047]
    B, Hq, T, D = len(lengths), 16, 2048, 128
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    # the step's rows: the last clamped to T - 1, row 2 not written
    flens = torch.tensor(lengths[:-1] + [T], dtype=torch.int32, device=dev)
    wr = torch.tensor([True, True, False] + [True] * (B - 3), device=dev)
    fused = "k_new" in inspect.signature(da.decode_attention).parameters
    for hkv in (16, 4):
        q = torch.randn((B, Hq, D), generator=gen, device=dev).to(bf)
        k, v = (torch.randn((B, hkv, T, D), generator=gen, device=dev)
                .to(bf) for _ in range(2))
        k_new, v_new = (torch.randn((B, hkv, D), generator=gen, device=dev)
                        .to(bf) for _ in range(2))
        kv = cold((k, v), 4 * sum(lengths) * hkv * D)
        fn = lambda: da.decode_attention(q, *kv(), lens)
        if fused:
            fw = lambda: da.decode_attention(q, *kv(), flens, k_new=k_new,
                                             v_new=v_new, write=wr)
        else:
            def fw():
                kc, vc = kv()
                bi = torch.arange(B, device=dev)[:, None]
                t = (flens.long() - 1).clamp(min=0)[:, None]
                for cache, new in ((kc, k_new), (vc, v_new)):
                    new = torch.where(wr[:, None, None, None],
                                      new[:, None], cache[bi, :, t, :])
                    cache[bi, :, t, :] = new
                return da.decode_attention(q, kc, vc, flens)
        for name, f in ((f"k10_hkv{hkv}", fn), (f"k10_hkv{hkv}_write", fw)):
            out[name] = {"kernel_ms": device_ms(f, None, 50),
                         "call_ms": call_ms(f, 50)}
        del kv, k, v
    layers = {M: {"kernel_ms": 0.0, "call_ms": 0.0} for M in (8, 128)}
    for name, K, N in (("wqkv", 2048, 6144), ("wo", 2048, 2048),
                       ("wup", 2048, 8192), ("wdown", 8192, 2048)):
        qt = quantize_tensor((0.02 * torch.randn(
            (K, N), generator=gen, device=dev)).to(bf))
        wq = cold((qt.q,), K * N)
        wd = cold((qt.dequantize(),), 2 * K * N)
        for M in (8, 32, 128, 512):
            x = torch.randn((M, K), generator=gen, device=dev).to(bf)
            fn = lambda: qm.int8_matmul(x, *wq(), qt.scale)
            rec = {"kernel_ms": device_ms(fn, K12_KERNELS, 50, launches=1),
                   "call_ms": call_ms(fn, 50),
                   # torch.matmul on the dequantized weight; the bound:
                   # the weight, scales, x and out once, or the flops
                   "library_ms": device_ms(lambda: torch.matmul(x, *wd()),
                                           None, 50),
                   "bound_ms": max(
                       (K * N + 4 * N + 2 * M * (K + N)) / 3.35e12,
                       2 * M * K * N / 989.4e12) * 1e3}
            out[f"k12_{name}_M{M}"] = rec
            if M in layers:
                for key in layers[M]:
                    layers[M][key] += rec[key]
        del wq, wd
    out["k12_layer_M8"] = layers[8]
    out["k12_layer_M128"] = layers[128]


def paged_cases():
    from paddle_tpu_torch.ops import decode_megakernel as mk
    from paddle_tpu_torch.ops import paged_attention as pa
    bf = torch.bfloat16
    H, D, page = 16, 128, 128

    def inputs(lengths, mx):
        B = len(lengths)
        q = torch.randn((B, H, D), generator=gen, device=dev).to(bf)
        kp, vp = (torch.randn((B * mx + 1, H, page, D), generator=gen,
                              device=dev).to(bf) for _ in range(2))
        table = torch.randperm(B * mx, generator=gen, device=dev)
        table = table.reshape(B, mx).to(torch.int32).contiguous()
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        return q, kp, vp, table, lens

    def fused(lengths, mx):
        q, kp, vp, table, lens = inputs(lengths, mx)
        kr, vr = (torch.randn((len(lengths), H, D), generator=gen,
                              device=dev).to(bf) for _ in range(2))
        wp = table.gather(1, (lens // page)[:, None].long())[:, 0]
        wp = wp.contiguous()
        return lambda: pa.paged_append_attend(q, kp, vp, kr, vr, table, wp,
                                              lens)

    def suffix():
        lengths = [min(129 + t, 168) for t in range(64)]
        q, kp, vp, table, lens = inputs(lengths, 2)
        table = table[:1].expand(64, -1).contiguous()
        return lambda: pa.paged_decode_attention(q, kp, vp, table, lens)

    calls = {"k2_fused": fused([0, 1, 127, 128, 255, 64, 200, 17], 2),
             "k2_fused_engine": fused([128 + 8 * i for i in range(8)], 16),
             "k2p_suffix": suffix()}
    for name, fn in calls.items():
        out[name] = {"kernel_ms": device_ms(fn, ("paged_kernel",), 50, 1),
                     "call_ms": call_ms(fn, 50)}
    plans = [tuple(int(v) for v in c.split("x"))
             for c in sys.argv[5].split(",") if c]
    if plans and hasattr(pa, "ring_stages"):
        default = pa.cluster_size, pa.ring_stages
        for splits, stages in plans:
            pa.cluster_size = lambda *shape, s=splits: s
            pa.ring_stages = lambda *shape, st=stages: st
            for name, fn in calls.items():
                out[f"{name}_S{splits}x{stages}"] = {
                    "kernel_ms": device_ms(fn, ("paged_kernel",), 50, 1),
                    "call_ms": call_ms(fn, 50)}
        pa.cluster_size, pa.ring_stages = default
    dm, V = 2048, 50304
    x = torch.randn((8, dm), generator=gen, device=dev).to(bf)
    wte = (0.02 * torch.randn((V, dm), generator=gen, device=dev)).to(bf)
    s = 1.0 + 0.1 * torch.randn((dm,), generator=gen, device=dev)
    b = 0.1 * torch.randn((dm,), generator=gen, device=dev)
    fn = lambda: mk.mega_logits_sample(x, s, b, wte.t())
    out["k9_B8_tied"] = {"kernel_ms": device_ms(fn, ("logits_kernel",), 20,
                                                1),
                         "call_ms": call_ms(fn, 20)}


def encoder_cases():
    from paddle_tpu_torch.ops import _hash
    from paddle_tpu_torch.ops import launch_probe as lp
    from paddle_tpu_torch.ops import layer_norm as ln
    bf, M, P, SEED = torch.bfloat16, 8192, 0.1, -77
    for N in (768, 1024, 1000):
        x, res = (torch.randn((M, N), generator=gen, device=dev).to(bf)
                  for _ in range(2))
        gamma = (1 + 0.1 * torch.randn(N, generator=gen, device=dev)).to(bf)
        beta, bias = ((0.1 * torch.randn(N, generator=gen, device=dev))
                      .to(bf) for _ in range(2))
        seed = _hash.seed_tensor(SEED, dev)
        fn = lambda: ln.fused_layer_norm_fwd(x, gamma, beta, bias, res,
                                             seed, 1e-5, P)
        out[f"k11_N{N}"] = {"kernel_ms": device_ms(fn, ("fused_ln_fwd",),
                                                   50, 1),
                            "call_ms": call_ms(fn, 50)}
        if N == 768:
            # where the time goes: K11 without dropout, without the
            # residual, with neither, and the bytes alone (3 and 2
            # streams of M x N bf16)
            y = torch.empty_like(x)
            parts = {
                "k11_N768_nodrop": lambda: ln.fused_layer_norm_fwd(
                    x, gamma, beta, bias, res, seed, 1e-5, 0.0),
                "k11_N768_nores": lambda: ln.fused_layer_norm_fwd(
                    x, gamma, beta, bias, None, seed, 1e-5, P),
                "k11_N768_neither": lambda: ln.fused_layer_norm_fwd(
                    x, gamma, beta, bias, None, seed, 1e-5, 0.0)}
            for name, f in parts.items():
                out[name] = {"kernel_ms": device_ms(f, ("fused_ln_fwd",),
                                                    50, 1),
                             "call_ms": call_ms(f, 50)}
            for name, f in (("add_N768", lambda: torch.add(x, res, out=y)),
                            ("copy_N768", lambda: y.copy_(x))):
                out[name] = {"kernel_ms": device_ms(f, None, 50),
                             "call_ms": call_ms(f, 50)}
    x = torch.randn((8, 128), generator=gen, device=dev)
    calls = {"k13_noop_copy": (lambda: lp.noop_copy(x), ("noop_copy",), 1),
             "k13_clone": (lambda: x.clone(), None, None)}
    if hasattr(lp, "launch_floor"):
        calls["launch_floor"] = (lambda: lp.launch_floor(dev),
                                 ("launch_floor",), 1)
    for name, (fn, keys, n) in calls.items():
        out[name] = {"kernel_ms": device_ms(fn, keys, 100, n),
                     "call_ms": call_ms(fn, 100)}


if ONLY in ("decode", "encoder"):
    if ONLY == "decode":
        decode_cases()
        paged_cases()
    else:
        encoder_cases()
    print("KERNEL_AB " + json.dumps(out), flush=True)
    sys.exit(0)


def operands(B, S, H=16, D=128):
    return [torch.randn((B, S, H, D), generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(4)]


for name, B, S, iters in (("k1_B1_S128", 1, 128, 50),
                          ("k1_B1_S512", 1, 512, 50),
                          ("k1_B4_S2048", 4, 2048, 10)):
    q, k, v, _ = operands(B, S)
    fn = lambda: fa.flash_attention(q, k, v, causal=True)
    out[name] = {"kernel_ms": device_ms(fn, ("flash_fwd",), iters, 1),
                 "call_ms": call_ms(fn, iters)}
q, k, v, do = operands(4, 2048)
scale = 128 ** -0.5
o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
delta = fa._delta(o, do)
k3 = lambda: fa.flash_attention_bwd_dkdv(q, k, v, do, lse, delta, True,
                                         scale)
k4 = lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, True,
                                       scale)
out["k3_B4_S2048"] = {"kernel_ms": device_ms(k3, ("flash_bwd_dkdv",), 10, 1),
                      "call_ms": call_ms(k3, 10)}
out["k4_B4_S2048"] = {"kernel_ms": device_ms(k4, ("flash_bwd_dq",), 10, 1),
                      "call_ms": call_ms(k4, 10)}
del q, k, v, do, o, lse, delta
# the incubate encoder's call: B 16, S 512, 12 heads of 64, the padding
# bias of lengths 128..512 alone, hash dropout 0.1
B, S, H, D, P, SEED = 16, 512, 12, 64, 0.1, 12345
q, k, v, do = operands(B, S, H, D)
lens = torch.linspace(128, S, B, device=dev).round()
bias = torch.where(torch.arange(S, device=dev)[None, :] < lens[:, None],
                   0.0, -1e30)[:, None, None, :]
kw = dict(bias=bias, dropout_p=P, dropout_seed=SEED)
o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
delta = fa._delta(o, do)
b4 = fa.attention_bias(bias, B, H, S, S)
k1 = lambda: fa.flash_attention(q, k, v, **kw)
k3 = lambda: fa.flash_attention_bwd_dkdv(q, k, v, do, lse, delta, False,
                                         D ** -0.5, None, b4, P, SEED)
k4 = lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, False,
                                       D ** -0.5, None, b4, P, SEED)
out["k1_enc_B16_S512_D64"] = {"kernel_ms": device_ms(k1, ("flash_fwd",), 20,
                                                     1),
                              "call_ms": call_ms(k1, 20)}
out["k3_enc_B16_S512_D64"] = {
    "kernel_ms": device_ms(k3, ("flash_bwd_dkdv",), 20, 1),
    "call_ms": call_ms(k3, 20)}
out["k4_enc_B16_S512_D64"] = {
    "kernel_ms": device_ms(k4, ("flash_bwd_dq",), 20, 1),
    "call_ms": call_ms(k4, 20)}
del q, k, v, do, o, lse, delta, bias, b4
N, d, V = 4 * 2047, 2048, 50304
x = torch.randn((N, d), generator=gen, device=dev).to(torch.bfloat16)
w = (0.02 * torch.randn((V, d), generator=gen, device=dev)).to(
    torch.bfloat16)
labels = torch.randint(0, V, (N,), generator=gen, device=dev,
                       dtype=torch.int32)
labels[::7] = -1
g = torch.where(labels >= 0, 1.0, 0.0).float().contiguous()
k5 = lambda: ce.fused_ce_fwd(x, w, labels)
_, lse = k5()
if hasattr(ce, "fused_ce_bwd"):
    k67 = lambda: ce.fused_ce_bwd(x, w, labels, lse, g)
else:
    k67 = lambda: (ce.fused_ce_dx(x, w, labels, lse, g),
                   ce.fused_ce_dw(x, w, labels, lse, g))
out["k5_ce_N8188"] = {"kernel_ms": device_ms(k5, ("ce_fwd",), 5, 1),
                      "call_ms": call_ms(k5, 5)}
out["k67_ce_bwd_N8188"] = {"kernel_ms": device_ms(k67, None, 3),
                           "call_ms": call_ms(k67, 3)}
for c in [int(c) for c in sys.argv[1].split(",") if c]:
    if hasattr(ce, "fused_ce_bwd"):
        fn = lambda: ce.fused_ce_bwd(x, w, labels, lse, g, chunk=c)
        out[f"k67_ce_bwd_N8188_chunk{c}"] = {
            "kernel_ms": device_ms(fn, None, 3), "call_ms": call_ms(fn, 3)}
plans = [int(c) for c in sys.argv[2].split(",") if c]
if plans and hasattr(ce, "_plan"):
    # K5 with its bf16 vocab tiles (256 wide) cut into about ns ranges,
    # the plans timed in turn three times (forward, back, forward)
    tiles = -(-V // 256)
    got = {}
    default_plan = ce._plan
    for rep in range(3):
        for ns in (plans if rep % 2 == 0 else plans[::-1]):
            per = -(-tiles // ns)
            ce._plan = lambda *a, per=per: (-(-tiles // per), per)
            got.setdefault(f"k5_ce_N8188_nsplit{-(-tiles // per)}", []).append(
                (device_ms(k5, ("ce_fwd",), 5, 1), call_ms(k5, 5)))
    ce._plan = default_plan
    for case, runs in got.items():
        out[case] = {"kernel_ms": statistics.median(r[0] for r in runs),
                     "call_ms": statistics.median(r[1] for r in runs)}
del x, w, labels, g, lse
decode_cases()
paged_cases()
encoder_cases()
print("KERNEL_AB " + json.dumps(out), flush=True)
"""


# this checkout's chip_smoke.py, whose ``_device_ms`` every run uses
_TIMING = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chip_smoke.py")


def run_one(root, timeout, ce_chunks, ce_plans, only, paged_plans):
    out = subprocess.run([sys.executable, "-c", _CHILD, ce_chunks, ce_plans,
                          only, _TIMING, paged_plans],
                         cwd=root,
                         capture_output=True, text=True, timeout=timeout)
    recs = [json.loads(line[len("KERNEL_AB "):])
            for line in out.stdout.splitlines()
            if line.startswith("KERNEL_AB ")]
    if out.returncode or not recs:
        sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
        raise SystemExit(f"kernel_ab: run in {root} failed "
                         f"(rc {out.returncode})")
    return recs[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--ce-chunks", default="",
                    help="comma-separated chunk widths for fused_ce_bwd")
    ap.add_argument("--ce-plans", default="",
                    help="comma-separated range counts for K5 (bf16)")
    ap.add_argument("--paged-plans", default="",
                    help="comma-separated SPLITSxSTAGES geometries for "
                         "K2 and K2'")
    ap.add_argument("--only", default="all",
                    choices=("all", "decode", "encoder"),
                    help="'decode': time K10, K12, K2, K2' and K9 alone; "
                         "'encoder': K11 and K13")
    args = ap.parse_args()
    roots = {"a": os.path.abspath(args.a), "b": os.path.abspath(args.b)}
    got = {"a": [], "b": []}
    for rnd in range(args.rounds):
        for tag in ("a", "b", "b", "a"):
            rec = run_one(roots[tag], args.timeout, args.ce_chunks,
                          args.ce_plans, args.only, args.paged_plans)
            got[tag].append(rec)
            print(json.dumps({"kernel_ab": tag, "root": roots[tag],
                              "round": rnd, **rec}), flush=True)
    def over_runs(f):
        # a case whose windows never held all its launches reads None
        def g(vals):
            vals = list(vals)
            return None if None in vals else f(vals)
        return {tag: {case: {key: g(r[case][key] for r in recs)
                             for key in recs[0][case]}
                      for case in recs[0] if all(case in r for r in recs)}
                for tag, recs in got.items()}

    print(json.dumps({"kernel_ab_medians": over_runs(statistics.median),
                      "kernel_ab_ranges": over_runs(
                          lambda v: [min(v), max(v)])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
