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
from paddle_tpu_torch.ops import fused_ce as ce
from paddle_tpu_torch.ops.fused_ce import (
    fused_ce_bwd, fused_ce_bwd_reference, fused_ce_fwd, fused_ce_reference,
    fused_softmax_cross_entropy, plan_chunks)
from paddle_tpu_torch.ops import decode_attention as da
from paddle_tpu_torch.ops.decode_attention import (
    decode_attention, decode_attention_reference)
from paddle_tpu_torch.ops.decode_megakernel import (
    epilogue_logits, logits_plan, logits_route, logits_tile_range,
    mega_decode_layers, mega_decode_layers_reference, mega_logits_sample,
    mega_logits_sample_reference)
from paddle_tpu_torch.ops.paged_attention import (
    cluster_size, paged_append_attend, paged_append_attend_reference,
    paged_decode_attention, paged_decode_attention_reference)
from paddle_tpu_torch.ops.quant_matmul import (int8_matmul,
                                               int8_matmul_reference,
                                               int8_matmul_route)

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
    # the edges of the 128-row query and key tiles: a ragged tile, kv_len
    # inside a tile of a long walk, GQA 16:4, the D 64 instance
    (1, 200, 200, 2, 2, 128, True, None),
    (1, 2048, 2048, 2, 2, 128, True, [1000]),
    (1, 256, 256, 16, 4, 128, True, None),
    (2, 256, 256, 2, 2, 64, False, None),
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


# the per-layer engine's geometry (B 8, 16 heads of 128, a table of 16
# pages of 128: a cluster of 8 blocks), a page of 256, and rows so short
# that most of a cluster's blocks see no key
PAGED_CASES = {
    "engine": (128, 16, [0, 1, 15, 16, 17, 127, 128, 2047]),
    "page256": (256, 8, [0, 3, 64, 255, 256, 257, 1000, 2047]),
    "blocks_without_keys": (128, 16, [1, 16, 17, 33, 0, 2, 31, 200]),
}


def _paged_geometry(gen, dev, dtype, case, hkv, hq=16, d=128):
    page, mx, lengths = PAGED_CASES[case]
    q, kp, vp, table, lens = _paged(gen, dev, dtype, hq, hkv, lengths, d,
                                    page, mx)
    # 16 kv heads: a cluster of 4; 4 kv heads (GQA 4): of 8
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert cluster_size(mx, page, len(lengths) * hkv, sms) == \
        (4 if hkv == 16 else 8)
    return q, kp, vp, table, lens, page


def _row_rel_l2(o, ro, lens):
    # per (row, head), over the rows that see a key (an empty row: 0)
    err = chip_smoke.rel_l2(o, ro, (2,))
    return err[lens > 0].max().item(), o[lens == 0].abs().max().item() \
        if bool((lens == 0).any()) else 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(PAGED_CASES))
@pytest.mark.parametrize("hkv", [16, 4])
def test_paged_plain_kernel_at_engine_geometry(dev, dtype, case, hkv):
    """K2' over a cluster of blocks, each a share of the row's tiles."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    q, kp, vp, table, lens, _ = _paged_geometry(gen, dev, dtype, case,
                                                hkv)
    o, m, l = paged_decode_attention(q, kp, vp, table, lens,
                                     return_stats=True)
    torch.cuda.synchronize()
    ro, rm, rl = paged_decode_attention_reference(q.float(), kp, vp, table,
                                                  lens, return_stats=True)
    worst, empty = _row_rel_l2(o, ro, lens)
    assert worst <= chip_smoke.REL_L2_TOL and empty == 0.0
    assert torch.equal(torch.isinf(m), torch.isinf(rm))
    fin = torch.isfinite(rm)
    torch.testing.assert_close(m[fin], rm[fin], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(l, rl, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(PAGED_CASES))
@pytest.mark.parametrize("hkv", [16, 4])
def test_paged_fused_kernel_at_engine_geometry(dev, dtype, case, hkv):
    """K2 over a cluster: the fresh row folded in by one block and
    written into its page, every other pool row untouched."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    q, kp, vp, table, lens, page = _paged_geometry(gen, dev, dtype, case,
                                                   hkv)
    b, hkv, d = q.shape[0], kp.shape[1], q.shape[-1]
    k_row = _randn(gen, (b, hkv, d), dtype, dev)
    v_row = _randn(gen, (b, hkv, d), dtype, dev)
    wp = table.gather(1, (lens // page).long()[:, None])[:, 0].contiguous()
    kp1, vp1, kp2, vp2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    o, _, _ = paged_append_attend(q, kp1, vp1, k_row, v_row, table, wp,
                                  lens)
    torch.cuda.synchronize()
    ro, _, _ = paged_append_attend_reference(q.float(), kp2, vp2, k_row,
                                             v_row, table, wp, lens)
    assert chip_smoke.rel_l2(o, ro, (2,)).max().item() <= \
        chip_smoke.REL_L2_TOL
    assert torch.equal(kp1, kp2) and torch.equal(vp1, vp2)
    changed = ((kp1 != kp).any(-1) | (vp1 != vp).any(-1)).nonzero().tolist()
    want = sorted([int(wp[i]), h, int(lens[i]) % page]
                  for i in range(b) for h in range(hkv))
    assert sorted(changed) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_fused_kernel_inactive_slots_write_the_scratch_page(dev,
                                                                  dtype):
    """Every slot inactive: all write the one scratch page (the pool's
    last), several the same rows; nothing else moves, and each element
    of a written row is that element of one of the rows aimed at it (the
    writes of several slots may interleave)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    q, kp, vp, table, lens, page = _paged_geometry(gen, dev, dtype,
                                                   "engine", 16)
    b, hkv, d = q.shape[0], kp.shape[1], q.shape[-1]
    scratch = kp.shape[0] - 1
    k_row = _randn(gen, (b, hkv, d), dtype, dev)
    v_row = _randn(gen, (b, hkv, d), dtype, dev)
    wp = torch.full((b,), scratch, dtype=torch.int32, device=dev)
    kp1, vp1 = kp.clone(), vp.clone()
    o, _, _ = paged_append_attend(q, kp1, vp1, k_row, v_row, table, wp,
                                  lens)
    torch.cuda.synchronize()
    ro, _, _ = paged_append_attend_reference(q.float(), kp.clone(),
                                             vp.clone(), k_row, v_row,
                                             table, wp, lens)
    assert chip_smoke.rel_l2(o, ro, (2,)).max().item() <= \
        chip_smoke.REL_L2_TOL
    assert torch.equal(kp1[:scratch], kp[:scratch])
    assert torch.equal(vp1[:scratch], vp[:scratch])
    offs = (lens % page).long()
    for pool, old, rows in ((kp1, kp, k_row), (vp1, vp, v_row)):
        got = pool[scratch]                       # (Hkv, page, D)
        # (B, Hkv, D): slot i's row where it aims at that offset
        hit = torch.zeros_like(got, dtype=torch.bool)
        for i in range(b):
            hit[:, offs[i]] |= got[:, offs[i]] == rows[i]
        aimed = torch.zeros((page,), dtype=torch.bool, device=dev)
        aimed[offs] = True
        assert bool(hit[:, aimed].all())
        assert torch.equal(got[:, ~aimed], old[scratch][:, ~aimed])


@pytest.mark.parametrize("dtype, d", [(torch.bfloat16, 36),
                                      (torch.float32, 33)])
def test_paged_kernels_stage_unaligned_rows_by_threads(dev, dtype, d):
    """Rows of D * elt bytes that are not whole 16-byte pieces (72 and
    132 bytes) take the same kernel's threads-staged tiles: K2' and K2
    against their plain versions, the fresh rows written bit for bit."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    lengths = [0, 1, 15, 16, 17, 127, 128, 2047]
    q, kp, vp, table, lens = _paged(gen, dev, dtype, 8, 2, lengths, d,
                                    128, 16)
    o, m, l = paged_decode_attention(q, kp, vp, table, lens,
                                     return_stats=True)
    torch.cuda.synchronize()
    ro, rm, rl = paged_decode_attention_reference(q.float(), kp, vp, table,
                                                  lens, return_stats=True)
    worst, empty = _row_rel_l2(o, ro, lens)
    assert worst <= chip_smoke.REL_L2_TOL and empty == 0.0
    fin = torch.isfinite(rm)
    torch.testing.assert_close(m[fin], rm[fin], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(l, rl, atol=1e-4, rtol=1e-4)
    k_row = _randn(gen, (len(lengths), 2, d), dtype, dev)
    v_row = _randn(gen, (len(lengths), 2, d), dtype, dev)
    wp = table.gather(1, (lens // 128).long()[:, None])[:, 0].contiguous()
    kp1, vp1, kp2, vp2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    o, _, _ = paged_append_attend(q, kp1, vp1, k_row, v_row, table, wp,
                                  lens)
    torch.cuda.synchronize()
    ro, _, _ = paged_append_attend_reference(q.float(), kp2, vp2, k_row,
                                             v_row, table, wp, lens)
    assert chip_smoke.rel_l2(o, ro, (2,)).max().item() <= \
        chip_smoke.REL_L2_TOL
    assert torch.equal(kp1, kp2) and torch.equal(vp1, vp2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sp, n", [(128, 168), (1000, 1064)])
def test_paged_plain_kernel_rows_sharing_one_table(dev, dtype, sp, n):
    """The suffix prefill's call: 64 query rows over one sequence, row t
    seeing min(sp + 1 + t, n) tokens, at the engine's table of 16
    pages."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    lengths = [min(sp + 1 + t, n) for t in range(64)]
    q, kp, vp, table, lens = _paged(gen, dev, dtype, 16, 16, lengths, 128,
                                    128, 16)
    table = table[:1].expand(64, -1).contiguous()
    o, m, l = paged_decode_attention(q, kp, vp, table, lens,
                                     return_stats=True)
    torch.cuda.synchronize()
    ro, rm, rl = paged_decode_attention_reference(q.float(), kp, vp, table,
                                                  lens, return_stats=True)
    assert chip_smoke.rel_l2(o, ro, (2,)).max().item() <= \
        chip_smoke.REL_L2_TOL
    torch.testing.assert_close(m, rm, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(l, rl, atol=1e-4, rtol=1e-4)


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
    # the edges of K3's 128-key and 64-row tiles (as for K1 above)
    (1, 200, 2, 2, 128, True, None),
    (1, 2048, 2, 2, 128, True, [1000]),
    (1, 256, 16, 4, 128, True, None),
    (2, 256, 2, 2, 64, False, None),
    # the edges of K4's 128-row blocks and 64-key tiles: rows past a
    # block, kv_len inside a key tile, D 32 / 96 on the 64 / 128
    # instances, GQA 16 -> 4, not causal
    (1, 129, 4, 4, 128, True, None),
    (2, 129, 4, 2, 64, False, [100, 33]),
    (1, 200, 16, 4, 96, True, [161]),
    (2, 200, 4, 4, 32, False, [200, 96]),
    (1, 130, 2, 1, 128, False, [70]),
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
@pytest.mark.parametrize("n, d, V, chunk", [
    (200, 64, 1000, None), (64, 32, 256, None), (333, 128, 4096, None),
    (1, 8, 130, None),
    # several chunks with a ragged last one; rows no multiple of 128
    (200, 64, 1000, 256), (333, 128, 4096, 1536), (130, 72, 1000, 8),
    (517, 256, 2000, 512),
    # K5's edges: rows past a 128-row tile, a last 256-wide vocab tile
    # mostly past V (257, 130, 50,304), d 8 and 72 (one stage, zero-filled
    # past d), the train shape; at N 129 the plan's last range is short
    (129, 72, 257, None), (130, 8, 130, None), (129, 2048, 50304, None),
    (8188, 2048, 50304, None)])
def test_fused_ce_kernels_match_plain(dev, dtype, n, d, V, chunk):
    """K5 against fused_ce_reference (loss and lse to 1e-4 of the
    largest; both sum fp32 products of the same inputs), the backward's
    dl pass, K6 and K7 (``fused_ce_bwd``, one launch of each per vocab
    chunk) against fused_ce_bwd_reference (tolerance as for attention).
    Ragged rows, a vocabulary that is no multiple of the tiles, ignored
    labels, and chunk widths that leave a ragged last chunk."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    x = _randn(gen, (n, d), dtype, dev)
    w = (0.5 * _randn(gen, (V, d), torch.float32, dev)).to(dtype)
    labels = torch.randint(0, V, (n,), generator=gen, device=dev,
                           dtype=torch.int32)
    labels[::3] = -1
    if n > 1:
        labels[1] = V - 1                  # in the ragged last vocab tile
    g = torch.randn((n,), generator=gen, device=dev)
    g = torch.where(labels >= 0, g, torch.zeros_like(g))
    kw = {} if chunk is None else {"chunk": chunk}
    chunks = len(plan_chunks(V, chunk or ce.CHUNK))
    fns = (fused_ce_fwd, ce._dl_pass, ce._dx_chunk, ce._dw_chunk)
    before = [f.launches for f in fns]
    loss, lse = fused_ce_fwd(x, w, labels)
    dx, dw = fused_ce_bwd(x, w, labels, lse, g, **kw)
    torch.cuda.synchronize()
    assert [f.launches - c for f, c in zip(fns, before)] == \
        [1, chunks, chunks, chunks]
    rloss, rlse = fused_ce_reference(x.float(), w.float(), labels)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(loss, rloss, atol=1e-4, rtol=1e-5)
    assert torch.all(loss[labels < 0] == 0)
    rdx, rdw = fused_ce_bwd_reference(x.float(), w.float(), labels, lse, g)
    assert dx.dtype == dw.dtype == dtype
    _close(dx, rdx, dtype)
    _close(dw, rdw, dtype)
    assert torch.all(dx[labels < 0] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n, V, per", [(129, 50304, 5), (300, 1000, 3),
                                       (8188, 50304, 6)])
def test_fused_ce_forward_with_a_short_last_range(dev, monkeypatch, dtype,
                                                  n, V, per):
    """K5 with the vocab tiles cut into ranges of ``per`` whose last one
    is shorter (at 50,304 columns in bf16: 197 tiles, 5 x 39 + 2 and
    6 x 32 + 5), against fused_ce_reference as above."""
    bn = 256 if dtype == torch.bfloat16 else 128
    tiles = -(-V // bn)
    assert tiles % per
    monkeypatch.setattr(ce, "_plan", lambda *a: (-(-tiles // per), per))
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    x = _randn(gen, (n, 128), dtype, dev)
    w = (0.5 * _randn(gen, (V, 128), torch.float32, dev)).to(dtype)
    labels = torch.randint(0, V, (n,), generator=gen, device=dev,
                           dtype=torch.int32)
    labels[::5] = -1
    labels[1] = V - 1
    loss, lse = fused_ce_fwd(x, w, labels)
    torch.cuda.synchronize()
    rloss, rlse = fused_ce_reference(x.float(), w.float(), labels)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(loss, rloss, atol=1e-4, rtol=1e-5)


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


def _k10_check(o, m, l, ro, rm, rl, lens, dtype):
    """K10's outputs against the plain version's: per (row, head) within
    2^-7 relative L2 (bf16) or 1e-4 (fp32), (m, l) within 1e-4 relative,
    an empty row exactly o = 0, m = -inf, l = 0."""
    assert o.dtype == dtype
    live = lens > 0
    err = ((o.float() - ro.float()).norm(dim=-1)
           / ro.float().norm(dim=-1).clamp_min(1e-30))[live]
    assert err.max().item() <= (1e-4 if dtype == torch.float32
                                else 2.0 ** -7)
    assert (o[~live] == 0).all()
    assert torch.isneginf(m[~live]).all() and (l[~live] == 0).all()
    torch.testing.assert_close(m[live], rm[live], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(l, rl, atol=1e-4, rtol=1e-4)


def _k10_operands(dev, dtype, hq, hkv, d, T, b, seed=5):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q = _randn(gen, (b, hq, d), dtype, dev)
    k = _randn(gen, (b, hkv, T, d), dtype, dev)
    v = _randn(gen, (b, hkv, T, d), dtype, dev)
    return gen, q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq, hkv, d, T, lengths", [
    (4, 4, 128, 256, [0, 1, 100, 256]),
    (8, 2, 64, 384, [383, 0, 129]),
    (16, 4, 128, 2048, [0, 1, 127, 128, 517, 1023, 1024, 2047]),
    (8, 1, 32, 128, [77, 128]),
    (6, 3, 36, 256, [5, 250]),   # bf16 rows of 72 bytes: staged by threads
])
def test_decode_attention_kernel_matches_plain(dev, dtype, hq, hkv, d, T,
                                               lengths):
    """K10 against its plain version (``_k10_check``), with and without
    (m, l), one launch a call."""
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    _, q, k, v = _k10_operands(dev, dtype, hq, hkv, d, T, len(lengths))
    before = decode_attention.launches
    o, m, l = decode_attention(q, k, v, lens, return_stats=True)
    o2 = decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 2
    ro, rm, rl = decode_attention_reference(q, k, v, lens,
                                            return_stats=True)
    assert torch.equal(o, o2)
    _k10_check(o, m, l, ro, rm, rl, lens, dtype)


def _split_edges(T):
    """Lengths at, just below and just past the edges of the blocks'
    shares of a cache of T (each of ``da.cluster_size(T)`` blocks walks
    16-row tiles): 16 S k for k = 1, 2 and T / (16 S), and 0, 1."""
    s = da.cluster_size(T)
    edges = sorted({16 * s, 32 * s, T})
    got = {0, 1}
    for e in edges:
        got.update(x for x in (e - 1, e, e + 1) if 0 <= x <= T)
    return sorted(got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [128, 256, 384, 512, 1024, 2048])
def test_decode_attention_kernel_at_split_edges(dev, dtype, T):
    """K10 where a row's keys split over the cluster's blocks (1 block
    up to T 384, 2 at 512, 4 at 1024, 8 at 2048): lengths at, just below
    and just past each edge of the shares and of their 16-row tiles,
    GQA 8:2 at D 128."""
    lengths = _split_edges(T)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    _, q, k, v = _k10_operands(dev, dtype, 8, 2, 128, T, len(lengths))
    o, m, l = decode_attention(q, k, v, lens, return_stats=True)
    torch.cuda.synchronize()
    ro, rm, rl = decode_attention_reference(q, k, v, lens,
                                            return_stats=True)
    _k10_check(o, m, l, ro, rm, rl, lens, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq, hkv, d, T", [
    (16, 4, 128, 2048), (16, 16, 128, 2048), (8, 2, 64, 384),
    (8, 8, 128, 1024),
    (6, 3, 36, 256),             # bf16 rows of 72 bytes: staged by threads
])
def test_decode_attention_kernel_writes_the_fresh_row(dev, dtype, hq, hkv,
                                                      d, T):
    """K10 with the fresh rows: row lengths[b] - 1 of each cache takes
    k_new / v_new where write[b] holds, inside the one launch, and is
    attended. Rows: position 0 (length 1), one marked False (keeps and
    attends to its cache entry), one past the cache (clamped: length T,
    row T - 1 written), an empty row (writes nothing), and rows at the
    shares' edges. Every cache entry equals the plain version's bit for
    bit; o, m, l as ``_k10_check``."""
    lengths = [1, 300 % T, T, 0, 129, T - 1, 17, 16 * da.cluster_size(T)]
    write = [True, False, True, True, True, True, True, True]
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    wr = torch.tensor(write, device=dev)
    gen, q, k, v = _k10_operands(dev, dtype, hq, hkv, d, T, len(lengths))
    k_new = _randn(gen, (len(lengths), hkv, d), dtype, dev)
    v_new = _randn(gen, (len(lengths), hkv, d), dtype, dev)
    rk, rv = k.clone(), v.clone()
    before = decode_attention.launches
    o, m, l = decode_attention(q, k, v, lens, return_stats=True,
                               k_new=k_new, v_new=v_new, write=wr)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    ro, rm, rl = decode_attention_reference(q, rk, rv, lens,
                                            return_stats=True, k_new=k_new,
                                            v_new=v_new, write=wr)
    assert torch.equal(k, rk) and torch.equal(v, rv)
    for b, (n, w) in enumerate(zip(lengths, write)):
        if n > 0 and w:
            assert torch.equal(k[b, :, n - 1], k_new[b])
            assert torch.equal(v[b, :, n - 1], v_new[b])
    _k10_check(o, m, l, ro, rm, rl, lens, dtype)
    # without a mask every non-empty row is written
    o2 = decode_attention(q, k, v, lens, k_new=v_new, v_new=k_new)
    torch.cuda.synchronize()
    ro2 = decode_attention_reference(q, rk, rv, lens, k_new=v_new,
                                     v_new=k_new)
    assert torch.equal(k, rk) and torch.equal(v, rv)
    live = lens > 0
    err = ((o2.float() - ro2.float()).norm(dim=-1)
           / ro2.float().norm(dim=-1).clamp_min(1e-30))[live]
    assert err.max().item() <= (1e-4 if dtype == torch.float32
                                else 2.0 ** -7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m, k, n", [
    (1, 64, 48), (3, 200, 130), (8, 2048, 2048), (16, 300, 520),
    (17, 128, 256), (64, 520, 136), (130, 2048, 6144), (5, 8192, 64)])
def test_int8_matmul_kernel_matches_plain(dev, dtype, m, k, n):
    """K12 against its plain version on every route (bf16 M <= 16: the
    tensor-core decode rows; bf16 M > 16: the TMA + wgmma tiles; fp32:
    the rows kernel), with ragged M, K and N and split K: per row within
    2^-7 relative L2 (bf16: one rounding of fp32 sums in another order)
    or 1e-5 (fp32); one launch a call."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    x = _randn(gen, (m, k), dtype, dev)
    q = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                      dtype=torch.int32).to(torch.int8)
    scale = torch.rand((1, n), generator=gen, device=dev) * 0.02 + 1e-3
    want = ("rows_kernel" if dtype == torch.float32
            else "int8_rows_sm90" if m <= 16 else "int8_tiles_sm90")
    assert int8_matmul_route(dtype, m) == want
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


@pytest.mark.parametrize("m", list(range(1, 17)))
@pytest.mark.parametrize("k, n", [(2048, 2048), (300, 520)])
def test_int8_matmul_decode_route_every_m(dev, m, k, n):
    """The tensor-core route at every decode M from 1 to 16, at the
    N 2048 split (K over a cluster) and ragged (slots filled by
    threads): per row within 2^-7 relative L2, one launch, no workspace
    (the call allocates only its output)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(60 + m)
    x = _randn(gen, (m, k), torch.bfloat16, dev)
    q = torch.randint(-128, 128, (k, n), generator=gen, device=dev,
                      dtype=torch.int32).to(torch.int8)
    scale = torch.rand((n,), generator=gen, device=dev) * 0.02 + 1e-3
    assert int8_matmul_route(torch.bfloat16, m) == "int8_rows_sm90"
    int8_matmul(x, q, scale)               # the library is built
    torch.cuda.synchronize()
    before = int8_matmul.launches
    allocs = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
    out = int8_matmul(x, q, scale)
    torch.cuda.synchronize()
    assert int8_matmul.launches == before + 1
    assert (torch.cuda.memory_stats(dev)["allocation.all.allocated"]
            - allocs) == 1
    ref = int8_matmul_reference(x.float(), q, scale)
    err = ((out.float() - ref).norm(dim=-1)
           / ref.norm(dim=-1).clamp_min(1e-30))
    assert err.max().item() <= 2.0 ** -7


@pytest.mark.parametrize("m", [17, 63, 65, 129, 1200])
@pytest.mark.parametrize("k, n", [(2048, 2048), (1000, 1040), (300, 520),
                                  (520, 136)])
def test_int8_matmul_prefill_route_matches_plain(dev, m, k, n):
    """The prefill route (bf16, M > 16: ``int8_tiles_sm90``) at ragged
    shapes: M around the 128-row tile, N not a multiple of the 128-column
    tile, K not a multiple of the 64-deep stage. (2048, 2048): 16 column
    tiles, K split over a cluster of 8 at M <= 128 and of 2 at M 129,
    unsplit at M 1200 (160 tiles); (1000, 1040): TMA with ragged K and
    N; (300, 520) and (520, 136): x's rows (K % 8) or q's (N % 16) not
    16-byte aligned, the boxes loaded with bounds. Per row within 2^-7
    relative L2 of the plain version, one launch a call."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(7 + m)
    x = _randn(gen, (m, k), torch.bfloat16, dev)
    q = torch.randint(-128, 128, (k, n), generator=gen, device=dev,
                      dtype=torch.int32).to(torch.int8)
    scale = torch.rand((n,), generator=gen, device=dev) * 0.02 + 1e-3
    assert int8_matmul_route(torch.bfloat16, m) == "int8_tiles_sm90"
    before = int8_matmul.launches
    out = int8_matmul(x, q, scale)
    torch.cuda.synchronize()
    assert int8_matmul.launches == before + 1
    ref = int8_matmul_reference(x.float(), q, scale)
    assert out.dtype == torch.bfloat16 and out.shape == (m, n)
    err = ((out.float() - ref).norm(dim=-1)
           / ref.norm(dim=-1).clamp_min(1e-30))
    assert err.max().item() <= 2.0 ** -7


@pytest.mark.parametrize("m", [16, 40])
@pytest.mark.parametrize("k, n", [(256, 256), (272, 136)])
def test_int8_matmul_widens_every_int8_exactly(dev, m, k, n):
    """Both bf16 routes' widening (M 16: the decode rows; M 40: the
    prefill tiles): x of one-hot rows and scale 1 give q's rows back as
    bf16, bit for bit, with each picked row of q holding all 256 int8
    values (N 136: the ragged fills)."""
    cols = torch.arange(n, device=dev)
    rows = torch.arange(k, device=dev)[:, None]
    q = ((rows * 37 + cols) % 256 - 128).to(torch.int8)
    picks = torch.arange(m, device=dev) * (k // m) + 3
    x = torch.zeros((m, k), dtype=torch.bfloat16, device=dev)
    x[torch.arange(m, device=dev), picks] = 1.0
    out = int8_matmul(x, q, torch.ones((n,), device=dev))
    torch.cuda.synchronize()
    want = q[picks].to(torch.bfloat16)
    assert torch.equal(out, want)
    if n >= 256:
        for r in range(m):
            assert torch.unique(q[picks[r]]).numel() == 256


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


def _flat_rows(n):
    """``n`` flat (slot, position, write) rows, four consecutive
    positions a slot (each row attends over its slot's earlier rows'
    fresh K/V), even slots straddling the first 128-token page (positions
    126-129), every fifth row with write flag 0 (its K/V to the scratch
    page)."""
    return tuple((r // 4, (126 if r // 4 % 2 == 0 else 60 * (r // 4 % 4))
                  + r % 4, 0 if r % 5 == 4 else 1) for r in range(n))


@pytest.mark.parametrize("case", ["gpt3_1p3b", "llama_shaped", "fp32",
                                  "rows64_gqa4", "fp32_d128",
                                  "gpt3_24layers"])
def test_mega_decode_kernel_matches_plain(dev, case):
    """K8 against its plain version: 2 full-width gpt3_1p3b blocks (16
    kv heads, biases), 2 llama_style_1b-shaped blocks (4 kv heads, rope,
    no biases), a narrow fp32 stack, all on the chip's rows (an inactive
    row, two rows of one slot); 64 flat rows (``_flat_rows``: rows with
    write flag 0, positions straddling a page) over 2 blocks at d_model
    2048 with 16 query heads over 4 kv heads and rope; d_model 128 in
    fp32 (2 heads of 64) on 64 rows; 24 gpt3_1p3b blocks at the init's
    weight scale (std 0.02) on 64 rows, within 2.5e-2 (the compounded
    roundings of depth). Pools bit for bit outside the written rows."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    tol = chip_smoke.REL_L2_TOL
    if case == "gpt3_1p3b":
        inp = chip_smoke.mega_inputs(torch, dev, gen, 2048, 16, 16, 128, 2)
    elif case == "llama_shaped":
        inp = chip_smoke.mega_inputs(torch, dev, gen, 2048, 16, 4, 128, 2,
                                     bias=False, rope=True)
    elif case == "fp32":
        inp = chip_smoke.mega_inputs(torch, dev, gen, 64, 4, 2, 16, 2,
                                     rope=True, dtype=torch.float32)
        tol = 1e-4
    elif case == "rows64_gqa4":
        inp = chip_smoke.mega_inputs(torch, dev, gen, 2048, 16, 4, 128, 2,
                                     rope=True, rows=_flat_rows(64))
    elif case == "fp32_d128":
        inp = chip_smoke.mega_inputs(torch, dev, gen, 128, 2, 2, 64, 2,
                                     dtype=torch.float32,
                                     rows=_flat_rows(64))
        tol = 1e-4
    else:
        inp = chip_smoke.mega_inputs(torch, dev, gen, 2048, 16, 16, 128, 24,
                                     rows=_flat_rows(64))
        for n, t in inp["w"].items():
            if n.startswith("w"):
                t.mul_(0.02 * t.shape[1] ** 0.5)
        tol = chip_smoke.THROUGH_DEPTH_TOL
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("rows", [1, 8, 13, 32, 64])
def test_mega_logits_kernel_rows_and_ties_across_blocks(dev, dtype, tied,
                                                        rows):
    """K9 at 1 to 64 rows: bf16 on the gpt3_1p3b head (the tensor-core
    route; 64 rows are two row groups), fp32 on a narrow one (the CUDA
    cores). Row 0's planted tie straddles two blocks' vocabulary ranges:
    the lower column must win. A second call on other rows shows the
    merge words were left zeroed."""
    dm, V = (2048, 50304) if dtype == torch.bfloat16 else (64, 4096)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    x = _randn(gen, (rows, dm), dtype, dev)
    wte = (0.02 * torch.randn((V, dm), generator=gen, device=dev)).to(dtype)
    s = 1.0 + 0.1 * torch.randn((dm,), generator=gen, device=dev)
    b = 0.1 * torch.randn((dm,), generator=gen, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    group, n, stages, grid = logits_plan(rows, dm, V, sms)
    _, end0 = logits_tile_range(0, V, grid)
    cut = end0 * 64                      # block 1's first column
    x, w, poison, ties = chip_smoke.mega_logits_inputs(
        torch, x, wte, s, b, tie_cols=((cut - 1, cut), (2000, 2001)))
    head = w.t() if tied else w.t().contiguous()
    route = logits_route(dtype, dm, V, tied, True)
    assert route == ("tensor_cores" if dtype == torch.bfloat16
                     else "cuda_cores")
    if route == "tensor_cores":
        assert (group, -(-rows // group)) == (min(rows, 32),
                                              1 if rows <= 32 else 2)
    before = mega_logits_sample.launches
    tok, nf = mega_logits_sample(x, s, b, head, poison)
    torch.cuda.synchronize()
    assert mega_logits_sample.launches == before + 1
    logits = epilogue_logits(x, s, b, head, poison)
    _, ref_nf = mega_logits_sample_reference(x, s, b, head, poison)
    rec = chip_smoke.mega_logits_check(tok, nf, logits, ref_nf, ties)
    assert rec["ok"], rec
    # the rows rolled by one and no poison: stale keys or flags of the
    # first call would show
    x2 = x.roll(1, 0)
    tok2, nf2 = mega_logits_sample(x2, s, b, head)
    torch.cuda.synchronize()
    logits2 = epilogue_logits(x2, s, b, head)
    _, ref_nf2 = mega_logits_sample_reference(x2, s, b, head)
    ties2 = {(r + 1) % rows: c for r, c in ties.items()}
    rec2 = chip_smoke.mega_logits_check(tok2, nf2, logits2, ref_nf2, ties2)
    assert rec2["ok"], rec2


# ---- K11 and the attention bias and dropout of K1/K3/K4 ----------------

def _ln_rows(gen, m, n, dtype, dev, misaligned=False, fill=None):
    """(m, n) contiguous rows; ``misaligned``: starting one element past
    a 16-byte boundary (the kernel's one-element-access instance)."""
    buf = torch.empty(m * n + 1, dtype=dtype, device=dev)
    t = buf[int(misaligned):int(misaligned) + m * n].view(m, n)
    if fill is None:
        t.copy_(torch.randn((m, n), generator=gen, device=dev))
    else:
        t.fill_(fill)
    return t


# (n, m, bias, residual, dropout p, x misaligned): each of K11's plans
# (a warp per row at 8 / 24 / 32 values a lane, a block per row up to
# MAX_N; 16-byte or one-element accesses) with and without each input
_LN_CASES = [
    (33, 16, True, True, 0.1, False), (33, 1, False, False, 0.0, True),
    (768, 8192, True, True, 0.1, False), (768, 16, False, True, 0.5, True),
    (768, 1, True, False, 0.0, False),
    (1000, 8192, True, True, 0.1, False), (1000, 16, True, True, 0.1, True),
    (1024, 16, False, False, 0.3, False), (1024, 8192, True, True, 0.1, True),
    (2048, 16, True, True, 0.1, False), (2048, 1, False, True, 0.0, True),
    (16384, 16, True, True, 0.1, False), (16384, 1, True, False, 0.2, True)]


@pytest.mark.parametrize("vec_dtype", ["x's", "other"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n, m, bias, residual, p, misaligned", _LN_CASES)
def test_layer_norm_kernel_matches_plain(dev, dtype, vec_dtype, n, m, bias,
                                         residual, p, misaligned):
    """K11 under each plan against its plain version: y and pre per row
    within 2^-7 relative L2 (and the bf16 / fp32 absolute bound), mean
    and rstd within 1e-5, the mask (``pre != 0`` of an all-ones input)
    bit for bit, one launch counted per call; gamma, beta and bias in
    x's dtype or the other one."""
    from paddle_tpu_torch.ops import _hash
    from paddle_tpu_torch.ops import layer_norm as ln
    from paddle_tpu_torch.ops.layer_norm import (fused_layer_norm_fwd,
                                                 fused_layer_norm_reference)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    vdt = dtype if vec_dtype == "x's" else (
        torch.bfloat16 if dtype == torch.float32 else torch.float32)
    x = _ln_rows(gen, m, n, dtype, dev, misaligned)
    res = _ln_rows(gen, m, n, dtype, dev) if residual else None
    gamma, beta = (_randn(gen, (n,), vdt, dev) for _ in range(2))
    b = _randn(gen, (n,), vdt, dev) if bias else None
    plan = ln._plan(m, n, dtype, not misaligned,
                    torch.cuda.get_device_properties(dev)
                    .multi_processor_count)
    assert plan.variant == ("warp" if n <= ln.WARP_MAX_N else "block")
    assert (plan.vec > 1) == (not misaligned and n % (16 // x.element_size())
                              == 0)
    args = (x, gamma, beta, b, res, -3, 1e-5, p)
    before = fused_layer_norm_fwd.launches
    got = fused_layer_norm_fwd(*args)
    ones = _ln_rows(gen, m, n, dtype, dev, misaligned, fill=1.0)
    probe = fused_layer_norm_fwd(ones, gamma, beta, None, None, -3, 1e-5,
                                 p)[1]
    torch.cuda.synchronize()
    assert fused_layer_norm_fwd.launches == before + 2
    ref = fused_layer_norm_reference(*args)
    for g, r in zip(got[:2], ref[:2]):
        assert (g.float() - r.float()).abs().max().item() <= \
            TOL[dtype](r.float())
    keep = (_hash.layer_norm_keep(-3, (m, n), p, device=dev) if p > 0
            else torch.ones((m, n), dtype=torch.bool, device=dev))
    rec = chip_smoke.layer_norm_check(got, ref, probe != 0, keep)
    assert rec["ok"], rec
    torch.testing.assert_close(got[2], ref[2], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got[3], ref[3], atol=0, rtol=1e-5)


def test_layer_norm_call_with_bf16_vectors_is_one_kernel(dev):
    """One K11 call at the encoder's shape, bf16 vectors and a seed on
    the device (as the encoder passes them): one kernel in a profiler
    window of that call, nothing cast beside it."""
    from paddle_tpu_torch.ops import _hash
    from paddle_tpu_torch.ops.layer_norm import fused_layer_norm_fwd
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    bf = torch.bfloat16
    x, res = (_randn(gen, (8192, 768), bf, dev) for _ in range(2))
    g, b, bias = (_randn(gen, (768,), bf, dev) for _ in range(3))
    seed = _hash.seed_tensor(5, dev)
    fn = lambda: fused_layer_norm_fwd(x, g, b, bias, res, seed, 1e-5, 0.1)
    fn()
    events = chip_smoke._profile_events(torch, fn, 1)
    assert len(events) == 1 and "fused_ln_fwd" in events[0][0], events


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
    (2, 200, 200, 4, 2, 128, True, (2, 1, 200, 200), [200, 130]),
    # K4's edges with a bias and dropout: Sq 129 and 200, kv_len inside
    # a 64-key tile, D 32 and 96, GQA 16 -> 4
    (2, 129, 129, 16, 4, 128, True, (2, 1, 1, 129), [129, 90]),
    (1, 200, 200, 4, 4, 32, False, (1, 4, 200, 200), [100]),
    (2, 200, 96, 2, 2, 96, False, (2, 1, 1, 96), [96, 40]),
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
    the four builds against the plain versions, the seed made on the
    card from a card key (a device tensor the kernels read)."""
    from paddle_tpu_torch import random as prng
    from paddle_tpu_torch.nn.functional.attention import key_seed
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    b, s, h, d = 2, 192, 2, 64
    q, k, v, do = (_randn(gen, (b, s, h, d), dtype, dev) for _ in range(4))
    bias = (torch.randn((b, 1, 1, s), generator=gen, device=dev)
            if with_bias else None)
    seed = key_seed(prng.PRNGKey(12, device=dev), dev) if p > 0 else None
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
    plain versions, dropout on, in fp32: both under one context key, so
    both draw the same masks."""
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch import random as prng
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
        for t in w.values():
            t.grad = None
        with pnn.stateful(training=True, rng=prng.PRNGKey(1)):
            if plain:
                with chip_smoke.plain_kernels():
                    out = chip_smoke.encoder_forward(w, x, mask, L)
                    out.square().mean().backward()
            else:
                chip_smoke._zero_counters()
                out = chip_smoke.encoder_forward(w, x, mask, L)
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


def test_launch_floor_is_one_empty_kernel(dev):
    """The launch-floor probe: one launch of the empty kernel per call,
    counted, and nothing else in its profiler window."""
    from paddle_tpu_torch.ops.launch_probe import launch_floor
    n0 = launch_floor.launches
    launch_floor(dev)
    torch.cuda.synchronize()
    assert launch_floor.launches == n0 + 1
    events = chip_smoke._profile_events(torch, lambda: launch_floor(dev), 3)
    assert len(events) == 3 and all("launch_floor_kernel" in name
                                    for name, _ in events), events
    with pytest.raises(ValueError):
        launch_floor("cpu")


# ---- the launch plans the autotuner chooses from (ops/autotune.py) ------

@pytest.mark.parametrize("block_k", [64, 128])
@pytest.mark.parametrize("b, sq, sk, hq, hkv, d, causal, bshape, lens, p", [
    (2, 256, 256, 4, 4, 128, True, None, None, 0.0),
    (1, 200, 200, 2, 2, 64, True, None, [130], 0.0),
    (2, 190, 190, 16, 4, 128, True, (2, 1, 1, 190), [190, 70], 0.1),
    (2, 100, 300, 4, 2, 64, False, (1, 4, 100, 300), [300, 65], 0.2),
    (1, 129, 129, 2, 1, 128, False, (1, 1, 1, 129), None, 0.1),
    (2, 512, 512, 12, 12, 64, False, (2, 1, 1, 512), [512, 128], 0.1),
])
def test_flash_each_key_tile_matches_plain(dev, block_k, b, sq, sk, hq, hkv,
                                           d, causal, bshape, lens, p):
    """K1's 64- and 128-key instances against the plain version in bf16:
    the causal diagonal, kv_len inside a 64-key tile, a ragged last tile,
    the bias, the dropout hash's columns (Sk 300: its row stride 512)
    and the LSE, within 2^-7 relative L2 per 64-row tile; then K3 and
    K4 (fixed tiles) on each tile's LSE against the plain backward."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(block_k + sq)
    bf = torch.bfloat16
    q = _randn(gen, (b, sq, hq, d), bf, dev)
    k = _randn(gen, (b, sk, hkv, d), bf, dev)
    v = _randn(gen, (b, sk, hkv, d), bf, dev)
    do = _randn(gen, (b, sq, hq, d), bf, dev)
    bias = (None if bshape is None
            else torch.randn(bshape, generator=gen, device=dev))
    kv_lens = (None if lens is None
               else torch.tensor(lens, dtype=torch.int32, device=dev))
    kw = dict(causal=causal, kv_lens=kv_lens, bias=bias, dropout_p=p,
              dropout_seed=3 if p else None)
    res = []
    for fn, cast, tile in ((flash_attention, lambda t: t, block_k),
                           (fa.flash_attention_plain, lambda t: t.float(),
                            None)):
        ts = [cast(t).clone().requires_grad_() for t in (q, k, v)]
        before = flash_attention.launches
        o, lse = fn(*ts, return_lse=True, block_q=tile and 128,
                    block_k=tile, **kw)
        o.backward(cast(do))
        res.append((o.detach(), lse, [t.grad for t in ts]))
        if tile:
            assert flash_attention.launches == before + 1
    torch.cuda.synchronize()
    (o, lse, grads), (ro, rlse, rgrads) = res
    assert chip_smoke.tile_rel_l2(o, ro)[0] <= chip_smoke.REL_L2_TOL
    torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=1e-4)
    for g, r in zip(grads, rgrads):
        assert (g.float() - r).abs().max().item() <= TOL[bf](r)


def test_flash_refuses_a_tile_it_does_not_compile(dev):
    q = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="compiles the tiles"):
        flash_attention(q, q, q, block_q=128, block_k=256)
    with pytest.raises(ValueError, match="compiles the tiles"):
        flash_attention(q.float(), q.float(), q.float(), block_k=128)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("stages", [1, 2, 3, 4])
def test_paged_kernels_under_every_plan_match_plain(dev, dtype, splits,
                                                    stages):
    """K2' and K2 at the per-layer engine's geometry under every plan
    (splits, stages): outputs per (row, head) within REL_L2_TOL of the
    plain version, the fresh rows written exactly."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(10 * splits + stages)
    q, kp, vp, table, lens, page = _paged_geometry(gen, dev, dtype,
                                                   "engine", 16)
    o = paged_decode_attention(q, kp, vp, table, lens, splits=splits,
                               stages=stages)
    ro = paged_decode_attention_reference(q.float(), kp, vp, table, lens)
    b, hkv, d = q.shape[0], kp.shape[1], q.shape[-1]
    k_row = _randn(gen, (b, hkv, d), dtype, dev)
    v_row = _randn(gen, (b, hkv, d), dtype, dev)
    wp = table.gather(1, (lens // page).long()[:, None])[:, 0].contiguous()
    kp1, vp1, kp2, vp2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    of, _, _ = paged_append_attend(q, kp1, vp1, k_row, v_row, table, wp,
                                   lens, splits=splits, stages=stages)
    rof, _, _ = paged_append_attend_reference(q.float(), kp2, vp2, k_row,
                                              v_row, table, wp, lens)
    torch.cuda.synchronize()
    worst, empty = _row_rel_l2(o, ro, lens)
    assert worst <= chip_smoke.REL_L2_TOL and empty == 0.0
    assert chip_smoke.rel_l2(of, rof, (2,)).max().item() <= \
        chip_smoke.REL_L2_TOL
    assert torch.equal(kp1, kp2) and torch.equal(vp1, vp2)


@pytest.mark.parametrize("rows", [8, 32, 64])
def test_mega_logits_every_plan_gives_the_same_tokens(dev, rows):
    """The tensor-core K9 under every candidate plan the guard lets
    through (groups, ring depths, grids) on the gpt3_1p3b tied head with
    the planted tie, overflow and poisoned row: tokens and flags equal
    the formula plan's bit for bit, and that one passes
    mega_logits_check against the plain version."""
    from paddle_tpu_torch.ops import decode_megakernel as mk
    from paddle_tpu_torch.ops import geometry
    dm, V = 2048, 50304
    gen = torch.Generator(device=dev)
    gen.manual_seed(rows)
    x = _randn(gen, (rows, dm), torch.bfloat16, dev)
    wte = (0.02 * torch.randn((V, dm), generator=gen,
                              device=dev)).to(torch.bfloat16)
    s = 1.0 + 0.1 * torch.randn((dm,), generator=gen, device=dev)
    b = 0.1 * torch.randn((dm,), generator=gen, device=dev)
    x, w, poison, ties = chip_smoke.mega_logits_inputs(torch, x, wte, s, b)
    head = w.t()
    crd = geometry.card(dev)
    tok, nf = mega_logits_sample(x, s, b, head, poison)
    rec = chip_smoke.mega_logits_check(
        tok, nf, epilogue_logits(x, s, b, head, poison),
        mega_logits_sample_reference(x, s, b, head, poison)[1], ties)
    assert rec["ok"], rec
    plans = [p for p in mk.logits_candidates(rows, dm, V, crd.sms,
                                             crd.smem_optin)
             if geometry.logits_reason(p, rows, dm, V, crd) is None]
    assert len(plans) > 6
    for plan in plans:
        t2, f2 = mega_logits_sample(x, s, b, head, poison, plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(t2, tok) and torch.equal(f2, nf), plan


def test_tuners_time_the_kernels_and_hit_the_cache(dev, tmp_path):
    """Each tuner on the card: every timed candidate launched the kernel
    (never the plain version), the winner is cached under the card's
    key, and a second call hits the cache and launches nothing."""
    from paddle_tpu_torch.ops import autotune as at
    from paddle_tpu_torch.ops import decode_megakernel as mk
    from paddle_tpu_torch.ops import paged_attention as pa
    at.use_cache(str(tmp_path / "autotune.json"))
    try:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        q, kp, vp, table, lens, _ = _paged_geometry(
            gen, dev, torch.bfloat16, "engine", 16)
        x = _randn(gen, (8, 2048), torch.bfloat16, dev)
        wte = _randn(gen, (50304, 2048), torch.bfloat16, dev)
        s = torch.ones((2048,), device=dev)
        qa = _randn(gen, (2, 256, 4, 64), torch.bfloat16, dev)
        calls = [
            (pa.paged_append_attend,
             lambda: pa.tune_paged_attention(q, kp, vp, table, lens,
                                             iters=2)),
            (pa.paged_decode_attention,
             lambda: pa.tune_paged_attention(q, kp, vp, table, lens,
                                             fused=False, iters=2)),
            (mega_logits_sample,
             lambda: mk.tune_mega_epilogue(x, s, s, wte.t(), iters=2)),
            (flash_attention,
             lambda: fa.tune_flash_attention(qa, qa, qa, causal=True,
                                             iters=2))]
        for wrapper, call in calls:
            before = wrapper.launches
            best, timings = call()
            assert best in timings and all(t > 0 for t in timings.values())
            assert wrapper.launches - before >= 4 * len(timings)
            assert "SMs)" in at.history[-1]["key"]
            before = wrapper.launches
            assert call() == (best, {})
            assert wrapper.launches == before
    finally:
        at.use_cache()


def test_kv_handoff_on_gpu_matches_direct_serving(dev):
    """bf16 on the card: a prefill-only engine hands each request over
    the fp32 wire to a single-dispatch decode engine, and a contiguous
    engine migrates a request mid-decode to another: the streams equal
    direct serving on the same kind token for token, and the installed
    rows equal the sender's bit for bit."""
    from paddle_tpu_torch.serving import kv_transfer as kt
    cfg = gpt.GPTConfig(vocab_size=512, max_seq_len=1024, d_model=256,
                        n_layers=2, n_heads=2, dtype=torch.bfloat16)
    model = gpt.GPT(cfg, seed=0, device=dev)
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 512, size=n).tolist() for n in (40, 170, 300)]

    def carry(meta, k, v):
        h, blob = kt.encode_kv_pages(k, v, meta["n_tokens"], wire="fp32")
        return (dict(meta, wire="fp32"), *kt.decode_kv_pages(h, blob))

    def bits(t):
        return t.contiguous().view(torch.int16)

    direct = PagedDecodeEngine(model, n_pages=16, max_slots=4, device=dev)
    ref = [direct.submit(p, max_new_tokens=12) for p in prompts]
    direct.run()
    pf = PagedDecodeEngine(model, n_pages=16, max_slots=4,
                           prefill_only=True, device=dev)
    de = PagedDecodeEngine(model, n_pages=16, max_slots=4, device=dev)
    assert de.mega
    reqs = [pf.submit(p, max_new_tokens=12) for p in prompts]
    while not all(r.tokens for r in reqs):
        pf.step()
        pf.drain()
    sent = [pf.detach_handoff(r) for r in reqs]
    moved = [de.submit_handoff(*carry(*s)) for s in sent]
    de.step()
    for m, (meta, k, v) in zip(moved, sent):
        n = meta["n_tokens"]
        slot = de._slot_req.index(m)
        got = de._read_pages(de._tables[slot][:-(-n // 128)])
        for g, s in zip(got, (k, v)):
            assert torch.equal(bits(chip_smoke.kv_rows(g, n)),
                               bits(chip_smoke.kv_rows(s, n)))
    de.run()
    assert [m.tokens for m in moved] == [r.tokens for r in ref]
    src = DecodeEngine(model, max_slots=4, max_len=1024, device=dev)
    dst = DecodeEngine(model, max_slots=4, max_len=1024, device=dev)
    want = DecodeEngine(model, max_slots=4, max_len=1024, device=dev)
    wreqs = [want.submit(p, max_new_tokens=12) for p in prompts]
    want.run()
    sreqs = [src.submit(p, max_new_tokens=12) for p in prompts]
    while src.steps < 4:
        src.step()
    migrated = dst.submit_handoff(*carry(*src.detach_handoff(sreqs[0])))
    src.run()
    dst.run()
    assert migrated.tokens == wreqs[0].tokens
    assert [r.tokens for r in sreqs[1:]] == [r.tokens for r in wreqs[1:]]


def test_fleet_router_on_gpu_matches_direct_serving(dev, monkeypatch):
    """bf16 on the card, replicas in threads on a ``native.TCPStore`` the
    router hosts: two ``serve_replica`` loops over single-dispatch
    engines, then a ``serve_prefill_replica`` / ``serve_decode_replica``
    pair on the fp32 wire over the socket plane. Every stream equals
    direct serving token for token, and K1, K8 and K9 launched."""
    import threading
    from paddle_tpu_torch import native, ops
    from paddle_tpu_torch.serving import (FrontEnd, Router,
                                          serve_decode_replica,
                                          serve_prefill_replica,
                                          serve_replica)
    monkeypatch.setenv("PT_KV_WIRE", "fp32")
    cfg = gpt.GPTConfig(vocab_size=512, max_seq_len=1024, d_model=256,
                        n_layers=2, n_heads=2, dtype=torch.bfloat16)
    model = gpt.GPT(cfg, seed=0, device=dev)
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 512, size=n).tolist()
               for n in (40, 170, 300, 90)]

    def engine(**kw):
        return PagedDecodeEngine(model, n_pages=16, max_slots=4,
                                 device=dev, **kw)
    direct = engine()
    ref = [direct.submit(p, max_new_tokens=12) for p in prompts]
    direct.run()
    for fn in ops.launch_counters().values():
        fn.launches = 0
    for loops in ((serve_replica, FrontEnd(engine())),
                  (serve_replica, FrontEnd(engine()))), \
            ((serve_prefill_replica, engine(prefill_only=True)),
             (serve_decode_replica, FrontEnd(engine()))):
        router = Router(port=0, dead_after=30.0)
        ts = [threading.Thread(target=fn, args=(native.TCPStore(
                  "127.0.0.1", router.store.port), f"r{i}", arg),
                               kwargs={"max_idle_s": 60.0}, daemon=True)
              for i, (fn, arg) in enumerate(loops)]
        for t in ts:
            t.start()
        try:
            router.wait_replicas(2, timeout=60)
            ids = [router.submit(p, max_new_tokens=12) for p in prompts]
            res = router.drain(timeout=60)
        finally:
            router.shutdown()
            for t in ts:
                t.join(60)
            router.close()
        assert [res[q]["tokens"] for q in ids] == [r.tokens for r in ref]
        assert {res[q]["status"] for q in ids} == {"done"}
    counts = {n: fn.launches for n, fn in ops.launch_counters().items()}
    assert counts["flash_attention"] > 0
    assert counts["mega_decode_layers"] == counts["mega_logits_sample"] > 0
