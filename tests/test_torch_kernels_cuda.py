"""The port's CUDA kernels against their plain PyTorch versions, on the
GPU (marker ``cuda``; each test skips without a CUDA device). The plain
versions are held against the JAX package on the CPU in
test_torch_flash_attention.py, test_torch_flash_attention_bwd.py,
test_torch_fused_ce.py, test_torch_paged_attention.py,
test_torch_decode_attention.py, test_torch_quant_matmul.py and
test_torch_decode_megakernel.py; K8's and K9's checks are
``chip_smoke``'s (rehearsed with planted faults in
test_torch_chip_smoke_checks.py).

This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

import chip_smoke

from paddle_tpu_torch import quantization as quant
from paddle_tpu_torch.inference.decode_engine import DecodeEngine
from paddle_tpu_torch.inference.paged_engine import PagedDecodeEngine
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops.flash_attention import (flash_attention,
                                                  flash_attention_reference)
from paddle_tpu_torch.ops.fused_ce import (
    fused_ce_bwd_reference, fused_ce_dw, fused_ce_dx, fused_ce_fwd,
    fused_ce_reference, fused_softmax_cross_entropy)
from paddle_tpu_torch.ops.decode_attention import (
    decode_attention, decode_attention_reference)
from paddle_tpu_torch.ops.decode_megakernel import (
    epilogue_logits, mega_decode_layers, mega_decode_layers_reference,
    mega_logits_sample, mega_logits_sample_reference)
from paddle_tpu_torch.ops.paged_attention import (
    paged_append_attend, paged_append_attend_reference,
    paged_decode_attention, paged_decode_attention_reference)
from paddle_tpu_torch.ops.quant_matmul import (int8_matmul,
                                               int8_matmul_reference)

pytestmark = pytest.mark.cuda

# the kernels accumulate in fp32 like the plain versions; fp32 outputs
# differ by summation order, bf16 outputs by at most about one rounding
# of the output (2^-8 relative; twice that, times the largest |o|)
TOL = {torch.float32: lambda ref: 1e-4,
       torch.bfloat16: lambda ref: 2.0 ** -7 * max(1.0, ref.abs().max())}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, sq, sk, hq, hkv, d, causal, lens", [
    (2, 128, 128, 4, 4, 64, True, None),
    (1, 100, 100, 4, 2, 128, True, None),
    (2, 70, 190, 2, 2, 32, False, [0, 150]),
    (1, 300, 300, 8, 1, 128, True, [257]),
    (1, 90, 90, 4, 2, 40, True, [70]),     # D % 16 != 0: the FP32 pipes
])
def test_flash_kernel_matches_plain(dev, dtype, b, sq, sk, hq, hkv, d,
                                    causal, lens):
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    q = _randn(gen, (b, sq, hq, d), dtype, dev)
    k = _randn(gen, (b, sk, hkv, d), dtype, dev)
    v = _randn(gen, (b, sk, hkv, d), dtype, dev)
    kv_lens = (None if lens is None
               else torch.tensor(lens, dtype=torch.int32, device=dev))
    before = flash_attention.launches
    o, lse = flash_attention(q, k, v, causal=causal, kv_lens=kv_lens,
                             return_lse=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ro, rlse = flash_attention_reference(q.float(), k.float(), v.float(),
                                         causal, kv_lens=kv_lens)
    assert (o.float() - ro).abs().max().item() <= TOL[dtype](ro)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=1e-5)


def _paged(gen, dev, dtype, hq, hkv, lengths, d=128, page=128,
           max_pages=3):
    b = len(lengths)
    q = _randn(gen, (b, hq, d), dtype, dev)
    kp = _randn(gen, (b * max_pages + 1, hkv, page, d), dtype, dev)
    vp = _randn(gen, (b * max_pages + 1, hkv, page, d), dtype, dev)
    table = torch.randperm(b * max_pages, generator=gen, device=dev)
    table = table.reshape(b, max_pages).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, table, lens


LENGTHS = [0, 1, 127, 128, 129, 255, 256, 300]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq, hkv, d", [(4, 4, 128), (8, 2, 64),
                                        (8, 1, 32)])
def test_paged_plain_kernel_matches_plain(dev, dtype, hq, hkv, d):
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    q, kp, vp, table, lens = _paged(gen, dev, dtype, hq, hkv, LENGTHS, d)
    o, m, l = paged_decode_attention(q, kp, vp, table, lens,
                                     return_stats=True)
    torch.cuda.synchronize()
    ro, rm, rl = paged_decode_attention_reference(q.float(), kp, vp, table,
                                                  lens, return_stats=True)
    assert (o.float() - ro).abs().max().item() <= TOL[dtype](ro)
    assert torch.equal(torch.isinf(m), torch.isinf(rm))
    fin = torch.isfinite(rm)
    torch.testing.assert_close(m[fin], rm[fin], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(l, rl, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq, hkv", [(4, 4), (8, 2)])
def test_paged_fused_kernel_matches_plain_and_writes_one_row(dev, dtype,
                                                             hq, hkv):
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    q, kp, vp, table, lens = _paged(gen, dev, dtype, hq, hkv, LENGTHS)
    b, d = q.shape[0], q.shape[-1]
    k_row = _randn(gen, (b, hkv, d), dtype, dev)
    v_row = _randn(gen, (b, hkv, d), dtype, dev)
    wp = table.gather(1, (lens // 128).long()[:, None])[:, 0].contiguous()
    kp1, vp1, kp2, vp2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    o, _, _ = paged_append_attend(q, kp1, vp1, k_row, v_row, table, wp,
                                  lens)
    torch.cuda.synchronize()
    ro, _, _ = paged_append_attend_reference(q.float(), kp2, vp2, k_row,
                                             v_row, table, wp, lens)
    assert (o.float() - ro).abs().max().item() <= TOL[dtype](ro)
    assert torch.equal(kp1, kp2) and torch.equal(vp1, vp2)
    changed = (kp1 != kp).any(-1).nonzero().tolist()
    want = sorted([int(wp[i]), h, int(lens[i]) % 128]
                  for i in range(b) for h in range(hkv))
    assert sorted(changed) == want


def test_engine_on_gpu_matches_engine_on_cpu(dev):
    """fp32 tiny model: the same greedy streams through the kernels on
    the GPU as through the plain versions on the CPU."""
    cfg = gpt.GPTConfig(vocab_size=96, max_seq_len=256, d_model=64,
                        n_layers=2, n_heads=2, dtype=torch.float32)
    cpu_model = gpt.GPT(cfg, seed=0, device="cpu")
    weights = {n: p.detach() for n, p in cpu_model.named_parameters()
               if not n.startswith("blocks.")}
    weights.update(cpu_model.stacked)
    gpu_model = gpt.GPT(cfg, device=dev, weights={
        n: w.to(dev) for n, w in weights.items()})
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 96, size=n).tolist() for n in (5, 40, 140)]
    prompts.append(prompts[2][:128] + [7, 8, 9])
    streams = []
    for model, device in ((cpu_model, "cpu"), (gpu_model, dev)):
        eng = PagedDecodeEngine(model, n_pages=12, max_slots=4,
                                steps_per_call=4, device=device)
        reqs = [eng.submit(p, max_new_tokens=10) for p in prompts]
        eng.run()
        streams.append([r.tokens for r in reqs])
    assert streams[0] == streams[1]


def _close(got, ref, dtype):
    """Within 1e-4 (fp32: summation order) or 2^-7 (bf16: one rounding
    of the output) of max(1, the largest |ref|)."""
    rel = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    ref = ref.float()
    err = (got.float() - ref).abs().max().item()
    assert err <= rel * max(1.0, ref.abs().max().item()), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, s, hq, hkv, d, causal, lens", [
    (2, 128, 4, 4, 64, True, None),
    (1, 100, 4, 2, 128, True, None),
    (2, 190, 2, 2, 32, False, [0, 150]),
    (1, 300, 8, 1, 128, True, [257]),
    (2, 77, 4, 2, 96, False, None),
    (1, 90, 4, 2, 40, True, [70]),         # D % 16 != 0: the FP32 pipes
])
def test_flash_backward_kernels_match_plain(dev, dtype, b, s, hq, hkv, d,
                                            causal, lens):
    """K3 and K4 on the same (o, lse, delta) as the plain backward."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    q = _randn(gen, (b, s, hq, d), dtype, dev)
    k = _randn(gen, (b, s, hkv, d), dtype, dev)
    v = _randn(gen, (b, s, hkv, d), dtype, dev)
    do = _randn(gen, (b, s, hq, d), dtype, dev)
    kv_lens = (None if lens is None
               else torch.tensor(lens, dtype=torch.int32, device=dev))
    scale = d ** -0.5
    o, lse = flash_attention_reference(q, k, v, causal, scale, kv_lens)
    delta = fa._delta(o, do)
    before = (fa.flash_attention_bwd_dkdv.launches,
              fa.flash_attention_bwd_dq.launches)
    dk, dv = fa.flash_attention_bwd_dkdv(q, k, v, do, lse, delta, causal,
                                         scale, kv_lens)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, scale,
                                   kv_lens)
    torch.cuda.synchronize()
    assert (fa.flash_attention_bwd_dkdv.launches,
            fa.flash_attention_bwd_dq.launches) == (before[0] + 1,
                                                    before[1] + 1)
    rq, rk, rv = fa.flash_attention_bwd_reference(
        q.float(), k.float(), v.float(), o, lse, do.float(), causal, scale,
        kv_lens)
    for got, ref in ((dq, rq), (dk, rk), (dv, rv)):
        assert got.dtype == dtype
        _close(got, ref, dtype)


def test_flash_autograd_on_gpu_matches_cpu(dev):
    """fp32 end to end: autograd through K1/K3/K4 on the GPU against the
    plain path on the CPU."""
    rs = np.random.RandomState(0)
    arrs = [rs.randn(2, 130, h, 64).astype(np.float32) for h in (4, 2, 2)]
    do = torch.from_numpy(rs.randn(2, 130, 4, 64).astype(np.float32))
    grads = []
    for device in ("cpu", dev):
        qkv = [torch.from_numpy(a).to(device).requires_grad_()
               for a in arrs]
        o = flash_attention(*qkv, causal=True)
        grads.append(torch.autograd.grad(o, qkv, do.to(device)))
    for c, g in zip(*grads):
        torch.testing.assert_close(g.cpu(), c, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n, d, V", [(200, 64, 1000), (64, 32, 256),
                                     (333, 128, 4096), (1, 8, 130)])
def test_fused_ce_kernels_match_plain(dev, dtype, n, d, V):
    """K5 against fused_ce_reference (loss and lse to 1e-4 of the
    largest; both sum fp32 products of the same inputs), K6/K7 against
    fused_ce_bwd_reference (tolerance as for attention). Ragged rows,
    a vocabulary that is no multiple of the 128-column tile, ignored
    labels."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    x = _randn(gen, (n, d), dtype, dev)
    w = (0.5 * _randn(gen, (V, d), torch.float32, dev)).to(dtype)
    labels = torch.randint(0, V, (n,), generator=gen, device=dev,
                           dtype=torch.int32)
    labels[::3] = -1
    g = torch.randn((n,), generator=gen, device=dev)
    g = torch.where(labels >= 0, g, torch.zeros_like(g))
    before = [f.launches for f in (fused_ce_fwd, fused_ce_dx, fused_ce_dw)]
    loss, lse = fused_ce_fwd(x, w, labels)
    dx = fused_ce_dx(x, w, labels, lse, g)
    dw = fused_ce_dw(x, w, labels, lse, g)
    torch.cuda.synchronize()
    assert [f.launches for f in (fused_ce_fwd, fused_ce_dx,
                                 fused_ce_dw)] == [c + 1 for c in before]
    rloss, rlse = fused_ce_reference(x.float(), w.float(), labels)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(loss, rloss, atol=1e-4, rtol=1e-5)
    assert torch.all(loss[labels < 0] == 0)
    rdx, rdw = fused_ce_bwd_reference(x.float(), w.float(), labels, lse, g)
    assert dx.dtype == dw.dtype == dtype
    _close(dx, rdx, dtype)
    _close(dw, rdw, dtype)


def test_fused_ce_autograd_on_gpu_matches_cpu(dev):
    rs = np.random.RandomState(1)
    x = rs.randn(150, 64).astype(np.float32)
    w = rs.randn(640, 64).astype(np.float32)
    lab = rs.randint(-1, 640, size=150).astype(np.int32)
    gl = torch.from_numpy(rs.randn(150).astype(np.float32))
    outs = []
    for device in ("cpu", dev):
        xt = torch.from_numpy(x).to(device).requires_grad_()
        wt = torch.from_numpy(w).to(device).requires_grad_()
        per = fused_softmax_cross_entropy(xt, wt,
                                          torch.from_numpy(lab).to(device))
        outs.append((per,) + torch.autograd.grad(per, (xt, wt),
                                                 gl.to(device)))
    for c, g in zip(*outs):
        torch.testing.assert_close(g.cpu(), c, atol=1e-4, rtol=1e-4)


def test_train_step_on_gpu_matches_cpu(dev):
    """fp32 tiny GPT: two train steps through the kernels on the GPU and
    through the plain versions on the CPU give the same losses, step-1
    gradients and parameters. Adam divides by |g|, so an entry whose
    step-1 gradient is below 1e-4 of its parameter's largest steps by
    about +-lr on rounding noise and may differ by 2 lr per step."""
    from paddle_tpu_torch.optimizer import AdamW
    lr = 1e-3
    cfg = gpt.GPTConfig(vocab_size=256, max_seq_len=64, d_model=64,
                        n_layers=2, n_heads=2, use_bias=False,
                        dtype=torch.float32)
    tokens = torch.from_numpy(np.random.RandomState(2).randint(
        0, 256, size=(2, 48)).astype(np.int32))
    results = []
    for device in ("cpu", dev):
        model = gpt.GPT(cfg, seed=0, device="cpu")
        if device != "cpu":
            model = gpt.GPT(cfg, device=dev, weights={
                n.removeprefix("stacked."): p.detach().to(dev)
                for n, p in model.named_parameters()})
        opt = AdamW(learning_rate=lr, moment_dtype=torch.bfloat16)
        params, state = gpt.init_train_state(model, opt)
        step = gpt.build_train_step(model, opt)
        losses, grads = [], None
        for _ in range(2):
            params, state, loss = step(params, state, tokens.to(device))
            losses.append(loss.item())
            if grads is None:
                grads = {n: p.grad.cpu() for n, p in params.items()}
        results.append((losses, grads, {n: p.detach().cpu()
                                        for n, p in params.items()}))
    (cpu_loss, cpu_grad, cpu_p), (gpu_loss, gpu_grad, gpu_p) = results
    np.testing.assert_allclose(gpu_loss, cpu_loss, rtol=1e-5)
    for n, p in cpu_p.items():
        torch.testing.assert_close(gpu_grad[n], cpu_grad[n], atol=1e-5,
                                   rtol=1e-4)
        g = cpu_grad[n].abs()
        atol = torch.where(g > 1e-4 * g.max(), 2e-5, 4 * lr)
        assert ((gpu_p[n] - p).abs() <= atol).all(), n


def _gpu_copy(cpu_model, dev):
    return gpt.GPT(cpu_model.cfg, device=dev, weights={
        n.removeprefix("stacked."): p.detach().to(dev)
        for n, p in cpu_model.named_parameters()})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq, hkv, d, T, lengths", [
    (4, 4, 128, 256, [0, 1, 100, 256]),
    (8, 2, 64, 384, [383, 0, 129]),
    (16, 4, 128, 2048, [0, 1, 127, 128, 517, 1023, 1024, 2047]),
    (8, 1, 32, 128, [77, 128]),
    (6, 3, 36, 256, [5, 250]),   # bf16 rows of 72 bytes: scalar loads
])
def test_decode_attention_kernel_matches_plain(dev, dtype, hq, hkv, d, T,
                                               lengths):
    """K10 against its plain version: outputs per (row, head) within
    2^-7 relative L2 (bf16) or 1e-4 (fp32), (m, l) within 1e-4
    relative, an empty row exactly o = 0, m = -inf, l = 0."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    b = len(lengths)
    q = _randn(gen, (b, hq, d), dtype, dev)
    k = _randn(gen, (b, hkv, T, d), dtype, dev)
    v = _randn(gen, (b, hkv, T, d), dtype, dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    before = decode_attention.launches
    o, m, l = decode_attention(q, k, v, lens, return_stats=True)
    o2 = decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 2
    ro, rm, rl = decode_attention_reference(q, k, v, lens,
                                            return_stats=True)
    assert o.dtype == dtype and torch.equal(o, o2)
    live = lens > 0
    err = ((o.float() - ro.float()).norm(dim=-1)
           / ro.float().norm(dim=-1).clamp_min(1e-30))[live]
    assert err.max().item() <= (1e-4 if dtype == torch.float32
                                else 2.0 ** -7)
    assert (o[~live] == 0).all()
    assert torch.isneginf(m[~live]).all() and (l[~live] == 0).all()
    torch.testing.assert_close(m[live], rm[live], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(l, rl, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m, k, n", [
    (1, 64, 48), (3, 200, 130), (8, 2048, 2048), (16, 300, 520),
    (17, 128, 256), (64, 520, 136), (130, 2048, 6144), (5, 8192, 64)])
def test_int8_matmul_kernel_matches_plain(dev, dtype, m, k, n):
    """K12 against its plain version on both regimes (the weight stream
    for M <= 16 and every fp32 M, the wmma tiles for bf16 M > 16), with
    ragged M, K and N and split K: per row within 2^-7 relative L2
    (bf16: one rounding of fp32 sums in another order) or 1e-5 (fp32)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    x = _randn(gen, (m, k), dtype, dev)
    q = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                      dtype=torch.int32).to(torch.int8)
    scale = torch.rand((1, n), generator=gen, device=dev) * 0.02 + 1e-3
    before = int8_matmul.launches
    out = int8_matmul(x, q, scale)
    torch.cuda.synchronize()
    assert int8_matmul.launches == before + 1
    ref = int8_matmul_reference(x.float(), q, scale)
    assert out.dtype == dtype and out.shape == (m, n)
    err = ((out.float() - ref).norm(dim=-1)
           / ref.norm(dim=-1).clamp_min(1e-30))
    assert err.max().item() <= (1e-5 if dtype == torch.float32
                                else 2.0 ** -7)


def test_contiguous_engines_on_gpu_match_cpu(dev):
    """fp32 tiny model with a 1024 cache: the contiguous engine's greedy
    streams through K10 on the GPU equal the plain path's on the CPU,
    and so do the int8 engine's through K12."""
    cfg = gpt.GPTConfig(vocab_size=96, max_seq_len=1024, d_model=64,
                        n_layers=2, n_heads=2, dtype=torch.float32)
    cpu_model = gpt.GPT(cfg, seed=0, device="cpu")
    gpu_model = _gpu_copy(cpu_model, dev)
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 96, size=n).tolist() for n in (5, 40, 600)]
    streams = []
    for model, device in ((cpu_model, "cpu"), (gpu_model, dev)):
        k10, k12 = decode_attention.launches, int8_matmul.launches
        eng = DecodeEngine(model, max_slots=2, steps_per_call=4,
                           device=device)
        q8 = DecodeEngine(None, share_weights_with=eng, max_slots=2,
                          steps_per_call=4, weight_dtype="int8",
                          device=device)
        out = []
        for e in (eng, q8):
            reqs = [e.submit(p, max_new_tokens=10) for p in prompts]
            e.run()
            out.append([r.tokens for r in reqs])
        streams.append(out)
        if device != "cpu":
            assert decode_attention.launches > k10
            assert int8_matmul.launches > k12
    assert streams[0] == streams[1]


def test_generate_on_gpu_matches_cpu(dev):
    cfg = gpt.GPTConfig(vocab_size=96, max_seq_len=1024, d_model=64,
                        n_layers=2, n_heads=4, n_kv_heads=2, rope=True,
                        use_bias=False, tie_embeddings=False,
                        dtype=torch.float32)
    cpu_model = gpt.GPT(cfg, seed=1, device="cpu")
    gpu_model = _gpu_copy(cpu_model, dev)
    toks = np.random.RandomState(1).randint(0, 96, size=(3, 11))
    want = cpu_model.generate(toks, max_new_tokens=12)
    got = gpu_model.generate(toks, max_new_tokens=12)
    assert torch.equal(got.cpu(), want)
    q_want = quant.quantize_for_inference(cpu_model).generate(
        toks, max_new_tokens=12)
    q_got = quant.quantize_for_inference(gpu_model).generate(
        toks, max_new_tokens=12)
    assert torch.equal(q_got.cpu(), q_want)


@pytest.mark.parametrize("case", ["gpt3_1p3b", "llama_shaped", "fp32"])
def test_mega_decode_kernel_matches_plain(dev, case):
    """K8 over 2 layers against its plain version: full-width gpt3_1p3b
    blocks (16 kv heads, biases), llama_style_1b-shaped blocks (4 kv
    heads, rope, no biases), and a narrow fp32 stack; the chip's rows
    (an inactive row, two rows of one slot)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    if case == "gpt3_1p3b":
        inp = chip_smoke.mega_inputs(torch, dev, gen, 2048, 16, 16, 128, 2)
    elif case == "llama_shaped":
        inp = chip_smoke.mega_inputs(torch, dev, gen, 2048, 16, 4, 128, 2,
                                     bias=False, rope=True)
    else:
        inp = chip_smoke.mega_inputs(torch, dev, gen, 64, 4, 2, 16, 2,
                                     rope=True, dtype=torch.float32)
    args = (inp["table"], inp["pos"], inp["slot"], inp["write"])
    kp, vp = inp["kp"].clone(), inp["vp"].clone()
    before = mega_decode_layers.launches
    out = mega_decode_layers(inp["x"], inp["w"], kp, vp, *args,
                             **inp["geo"])
    torch.cuda.synchronize()
    assert mega_decode_layers.launches == before + 1
    rkp, rvp = inp["kp"].clone(), inp["vp"].clone()
    ref = mega_decode_layers_reference(inp["x"], inp["w"], rkp, rvp, *args,
                                       **inp["geo"])
    tol = 1e-4 if case == "fp32" else chip_smoke.REL_L2_TOL
    rec = chip_smoke.mega_layers_check(out, ref, (kp, vp), (rkp, rvp),
                                       (inp["kp"], inp["vp"]),
                                       inp["written"], tol)
    assert rec["ok"], rec


@pytest.mark.parametrize("dtype, dm, V", [(torch.bfloat16, 2048, 50304),
                                          (torch.float32, 64, 4096)])
@pytest.mark.parametrize("tied", [True, False])
def test_mega_logits_kernel_matches_plain(dev, dtype, dm, V, tied):
    """K9 on the gpt3_1p3b head (and a narrow fp32 one), tied (the
    (V, dm) ``wte`` read along dm) and untied ((dm, V) row-major), with a
    planted tie, an overflowing row and a poisoned row."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    x = _randn(gen, (8, dm), dtype, dev)
    wte = (0.02 * torch.randn((V, dm), generator=gen, device=dev)).to(dtype)
    s = 1.0 + 0.1 * torch.randn((dm,), generator=gen, device=dev)
    b = 0.1 * torch.randn((dm,), generator=gen, device=dev)
    x, w, poison, ties = chip_smoke.mega_logits_inputs(torch, x, wte, s, b)
    head = w.t() if tied else w.t().contiguous()
    before = mega_logits_sample.launches
    tok, nf = mega_logits_sample(x, s, b, head, poison)
    torch.cuda.synchronize()
    assert mega_logits_sample.launches == before + 1
    logits = epilogue_logits(x, s, b, head, poison)
    _, ref_nf = mega_logits_sample_reference(x, s, b, head, poison)
    rec = chip_smoke.mega_logits_check(tok, nf, logits, ref_nf, ties)
    assert rec["ok"], rec
    assert nf.tolist() == [0, 0, 1, 0, 1, 0, 0, 0]
    # the merge words are left zeroed: a second call agrees
    tok2, nf2 = mega_logits_sample(x, s, b, head)
    ref_tok2, ref_nf2 = mega_logits_sample_reference(x, s, b, head)
    torch.cuda.synchronize()
    assert torch.equal(nf2, ref_nf2)


# ---- K11 and the attention bias and dropout of K1/K3/K4 ----------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n, bias, residual, p", [
    (768, True, True, 0.1), (1000, True, True, 0.1),
    (1024, False, True, 0.5), (96, True, False, 0.0),
    (4096, False, False, 0.3)])
def test_layer_norm_kernel_matches_plain(dev, dtype, n, bias, residual, p):
    from paddle_tpu_torch.ops import _hash
    from paddle_tpu_torch.ops.layer_norm import (fused_layer_norm_fwd,
                                                 fused_layer_norm_reference)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    m = 300
    x = _randn(gen, (m, n), dtype, dev)
    res = _randn(gen, (m, n), dtype, dev) if residual else None
    gamma, beta = (_randn(gen, (n,), dtype, dev) for _ in range(2))
    b = _randn(gen, (n,), dtype, dev) if bias else None
    args = (x, gamma, beta, b, res, -3, 1e-5, p)
    before = fused_layer_norm_fwd.launches
    got = fused_layer_norm_fwd(*args)
    ones = torch.ones_like(x)
    probe = fused_layer_norm_fwd(ones, gamma, beta, None, None, -3, 1e-5,
                                 p)[1]
    torch.cuda.synchronize()
    assert fused_layer_norm_fwd.launches == before + 2
    ref = fused_layer_norm_reference(*args)
    for g, r in zip(got[:2], ref[:2]):
        assert (g.float() - r.float()).abs().max().item() <= \
            TOL[dtype](r.float())
    torch.testing.assert_close(got[2], ref[2], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got[3], ref[3], atol=0, rtol=1e-5)
    if p > 0:
        assert torch.equal(probe != 0,
                           _hash.layer_norm_keep(-3, (m, n), p, device=dev))


def test_layer_norm_kernel_refuses_a_row_too_wide(dev):
    from paddle_tpu_torch.ops.layer_norm import MAX_N, fused_layer_norm_fwd
    x = torch.zeros((2, MAX_N + 1), device=dev)
    g = torch.ones(MAX_N + 1, device=dev)
    with pytest.raises(ValueError, match="N <="):
        fused_layer_norm_fwd(x, g, g)


def test_layer_norm_autograd_on_gpu_matches_cpu(dev):
    from paddle_tpu_torch.ops.layer_norm import fused_layer_norm
    rs = np.random.RandomState(3)
    arrs = [rs.randn(*s).astype(np.float32)
            for s in ((4, 50, 200), (200,), (200,), (200,), (4, 50, 200),
                      (4, 50, 200), (4, 50, 200))]
    out = []
    for d in ("cpu", dev):
        ts = [torch.from_numpy(a).to(d).requires_grad_() for a in arrs[:5]]
        y, pre = fused_layer_norm(ts[0], ts[1], ts[2], residual=ts[4],
                                  bias=ts[3], dropout_p=0.2,
                                  dropout_seed=11)
        (y * torch.from_numpy(arrs[5]).to(d)
         + pre * torch.from_numpy(arrs[6]).to(d)).sum().backward()
        out.append([y.detach().cpu(), pre.detach().cpu()]
                   + [t.grad.cpu() for t in ts])
    for g, c in zip(out[1], out[0]):
        torch.testing.assert_close(g, c, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, sq, sk, hq, hkv, d, causal, bshape, lens", [
    (2, 128, 128, 4, 4, 64, False, (2, 1, 1, 128), [128, 70]),
    (2, 100, 200, 4, 2, 64, False, (1, 4, 100, 200), None),
    (1, 96, 96, 2, 2, 40, True, (1, 1, 96, 96), None),
    (2, 64, 600, 2, 1, 128, False, (2, 2, 64, 600), [600, 333]),
])
def test_flash_bias_dropout_kernels_match_plain(dev, dtype, b, sq, sk, hq,
                                                hkv, d, causal, bshape,
                                                lens):
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    q = _randn(gen, (b, sq, hq, d), dtype, dev)
    k = _randn(gen, (b, sk, hkv, d), dtype, dev)
    v = _randn(gen, (b, sk, hkv, d), dtype, dev)
    do = _randn(gen, (b, sq, hq, d), dtype, dev)
    bias = torch.randn(bshape, generator=gen, device=dev)
    bias[..., :3] = float("-inf")
    kv_lens = (None if lens is None
               else torch.tensor(lens, dtype=torch.int32, device=dev))
    kw = dict(causal=causal, kv_lens=kv_lens, bias=bias, dropout_p=0.2,
              dropout_seed=-5)
    res = []
    for fn, cast in ((flash_attention, lambda t: t),
                     (fa.flash_attention_plain, lambda t: t.float())):
        ts = [cast(t).clone().requires_grad_() for t in (q, k, v)]
        o = fn(*ts, **kw)
        o.backward(cast(do))
        res.append([o.detach()] + [t.grad for t in ts])
    torch.cuda.synchronize()
    for g, r in zip(*res):
        assert (g.float() - r).abs().max().item() <= TOL[dtype](r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_bias, p", [(False, 0.0), (True, 0.0),
                                          (False, 0.2), (True, 0.2)])
def test_flash_kernels_each_bias_dropout_build(dev, dtype, with_bias, p):
    """K1, K3 and K4 are built once per (bias, dropout) pair: each of
    the four builds against the plain versions, the seed drawn on the
    card by a CUDA generator (a device tensor the kernels read)."""
    from paddle_tpu_torch.nn.functional.attention import draw_seed
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    b, s, h, d = 2, 192, 2, 64
    q, k, v, do = (_randn(gen, (b, s, h, d), dtype, dev) for _ in range(4))
    bias = (torch.randn((b, 1, 1, s), generator=gen, device=dev)
            if with_bias else None)
    seed = draw_seed(gen, dev) if p > 0 else None
    if seed is not None:
        assert seed.device.type == "cuda" and seed.dtype == torch.int32
    kw = dict(bias=bias, dropout_p=p, dropout_seed=seed)
    res = []
    for fn, cast in ((flash_attention, lambda t: t),
                     (fa.flash_attention_plain, lambda t: t.float())):
        ts = [cast(t).clone().requires_grad_() for t in (q, k, v)]
        o = fn(*ts, **kw)
        o.backward(cast(do))
        res.append([o.detach()] + [t.grad for t in ts])
    torch.cuda.synchronize()
    for g, r in zip(*res):
        assert (g.float() - r).abs().max().item() <= TOL[dtype](r)


def test_incubate_encoder_block_on_gpu_matches_plain(dev):
    """One BERT-shaped post-LN block of the incubate functionals through
    the kernels (K1, K3, K4, K11) against the same block through their
    plain versions, dropout on, in fp32."""
    B, S, L = 2, 128, 1
    w = chip_smoke.encoder_weights(torch, dev, L, 128, 2, 512,
                                   dtype=torch.float32)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    x = torch.randn((B, S, 128), generator=g, device=dev)
    mask = (torch.arange(S, device=dev)[None, :]
            < torch.tensor([[S], [77]], device=dev))[:, None, None, :]
    res = []
    for plain in (True, False):
        g.manual_seed(1)
        for t in w.values():
            t.grad = None
        if plain:
            with chip_smoke.plain_kernels():
                out = chip_smoke.encoder_forward(w, x, mask, g, L)
                out.square().mean().backward()
        else:
            chip_smoke._zero_counters()
            out = chip_smoke.encoder_forward(w, x, mask, g, L)
            out.square().mean().backward()
            launches = chip_smoke._read_counters()
        res.append([out.detach()] + [t.grad for t in w.values()])
    torch.cuda.synchronize()
    assert launches["fused_layer_norm"] == L
    assert launches["flash_attention"] == L
    assert launches["flash_attention_bwd_dq"] == L
    for got, want in zip(res[1], res[0]):
        torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)


def test_launch_probe_kernel_copies_bit_for_bit(dev):
    """K13: the (8, 128) fp32 copy equals its input bit for bit (NaN,
    inf and -0 included), counts one launch per call, and meters a
    positive launch tax; any other operand is refused."""
    from paddle_tpu_torch.observability import devprof
    from paddle_tpu_torch.ops.launch_probe import (noop_copy,
                                                   noop_copy_reference)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    x = torch.randn((8, 128), generator=g, device=dev)
    x[0, :4] = torch.tensor([float("inf"), float("-inf"), float("nan"),
                             -0.0], device=dev)
    n0 = noop_copy.launches
    y = noop_copy(x)
    torch.cuda.synchronize()
    assert noop_copy.launches == n0 + 1 and y.data_ptr() != x.data_ptr()
    assert torch.equal(y.view(torch.int32),
                       noop_copy_reference(x).view(torch.int32))
    assert torch.equal(noop_copy(x.reshape(-1)).view(torch.int32),
                       x.reshape(-1).view(torch.int32))
    for bad in (torch.zeros((8, 64), device=dev),
                torch.zeros((8, 128), dtype=torch.bfloat16, device=dev),
                torch.zeros((128, 8), device=dev).t()):
        with pytest.raises(ValueError):
            noop_copy(bad)
    assert devprof.pallas_launch_tax_s(force=True) > 0
