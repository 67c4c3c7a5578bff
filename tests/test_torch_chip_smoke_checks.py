"""The checks ``chip_smoke.py`` holds the K3/K4, K5-K7, K10 and K12
kernels to, rehearsed on the CPU at small shapes: a stand-in for a
correct bf16 kernel passes, and planted faults fail. The stand-in is the plain
version on bf16 inputs (p, ds and dl rounded to bf16 before their
products, bf16 outputs, as the kernels do), held against the plain
version in fp32, so it carries at least the kernels' rounding. Each
fault leaves the largest entries right and is wrong where the gradient
is small, which a check of the largest |error| against the largest
|ref| does not see at the train shapes."""

import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu_torch.ops.fused_ce import (fused_ce_bwd_reference,
                                           fused_ce_reference)
from paddle_tpu_torch.ops.decode_attention import decode_attention_reference
from paddle_tpu_torch.ops.flash_attention import (
    flash_attention_bwd_reference, flash_attention_reference)
from paddle_tpu_torch.ops.quant_matmul import int8_matmul_reference
from paddle_tpu_torch.quantization import quantize_tensor

TOL = chip_smoke.REL_L2_TOL


def _attention(hkv, B=2, S=256, H=4):
    rs = np.random.RandomState(0)
    D = 32
    q, do = (torch.from_numpy(rs.randn(B, S, H, D).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rs.randn(B, S, hkv, D).astype(np.float32))
            for _ in range(2))
    q, k, v, do = (t.to(torch.bfloat16).float() for t in (q, k, v, do))
    o, lse = flash_attention_reference(q, k, v, causal=True)
    ref = flash_attention_bwd_reference(q, k, v, o, lse, do, True)
    bf = [t.to(torch.bfloat16) for t in (q, k, v, o, do)]
    good = flash_attention_bwd_reference(*bf[:4], lse, bf[4], True)
    return q, k, v, o, lse, do, ref, good


@pytest.mark.parametrize("hkv", [4, 2])
def test_attention_check_passes_bf16_rounding(hkv):
    *_, ref, good = _attention(hkv)
    rec = chip_smoke.attention_grads_check(good, ref)
    assert rec["ok"], rec
    # the stand-in's rounding shows, inside the tolerance
    assert 0 < max(rec["tile_rel_l2_max"].values()) < TOL


def test_attention_check_fails_planted_faults():
    # the train shape's sequence length, where late keys' dv is small
    q, k, v, o, lse, do, ref, good = _attention(1, B=1, S=2048, H=2)
    dq, dk, dv = good
    S = dv.shape[1]
    # dv zeroed past the middle of the keys, or on the last key tile
    # alone, where |dv| is small
    for start in (S // 2, S - 64):
        dv_bad = dv.clone()
        dv_bad[:, start:] = 0
        rec = chip_smoke.attention_grads_check((dq, dk, dv_bad), ref)
        assert not rec["ok"] and rec["tile_rel_l2_max"]["dv"] == 1.0
    # ds without the delta term (the backward given o = 0)
    no_delta = flash_attention_bwd_reference(
        q.bfloat16(), k.bfloat16(), v.bfloat16(), torch.zeros_like(o),
        lse, do.bfloat16(), True)
    rec = chip_smoke.attention_grads_check(no_delta, ref)
    assert not rec["ok"]
    assert min(rec["tile_rel_l2_max"]["dq"],
               rec["tile_rel_l2_max"]["dk"]) > TOL


def _ce(w_std):
    rs = np.random.RandomState(1)
    N, d, V = 300, 64, 1024               # 300 rows: not a 64-multiple
    x = torch.from_numpy(rs.randn(N, d).astype(np.float32))
    w = torch.from_numpy((w_std * rs.randn(V, d)).astype(np.float32))
    x, w = x.bfloat16(), w.bfloat16()
    labels = torch.from_numpy(rs.randint(0, V, N).astype(np.int32))
    labels[::7] = -1
    g = (labels >= 0).float()
    _, lse = fused_ce_reference(x, w, labels)
    ref = fused_ce_bwd_reference(x.float(), w.float(), labels, lse, g)
    good = fused_ce_bwd_reference(x, w, labels, lse, g)
    return x, w, labels, g, ref, good


# the init head (std 0.02) and a peaked softmax (logits of std 3)
W_STDS = [0.02, 3 / 64 ** 0.5]


@pytest.mark.parametrize("w_std", W_STDS)
def test_ce_check_passes_bf16_rounding(w_std):
    x, w, labels, g, (rdx, rdw), (dx, dw) = _ce(w_std)
    rec = chip_smoke.ce_grads_check(dx, dw, rdx, rdw, labels)
    assert rec["ok"], rec
    assert 0 < rec["dw_row_rel_l2_max"] < TOL


@pytest.mark.parametrize("w_std", W_STDS)
def test_ce_check_fails_planted_faults(w_std):
    x, w, labels, g, (rdx, rdw), (dx, dw) = _ce(w_std)
    valid = labels >= 0
    lab = labels.clamp(min=0).long()
    # dl without the exp(s - lse) term: only the one-hot part is left
    dx_onehot = (-g[:, None] * w.float()[lab]).bfloat16()
    dw_onehot = torch.zeros_like(rdw).index_add_(
        0, lab[valid], -x.float()[valid]).bfloat16()
    rec = chip_smoke.ce_grads_check(dx_onehot, dw_onehot, rdx, rdw, labels)
    assert not rec["ok"] and rec["dw_unlabeled_row_rel_l2_max"] >= 1.0
    if w_std > 0.02:
        # with a peaked softmax dx shows the fault by itself too
        assert rec["dx_row_rel_l2_max"] > TOL
    # dw written as zeros on the vocab rows no label picks
    picked = labels[valid].long().bincount(minlength=rdw.shape[0]) > 0
    dw_zeroed = dw.clone()
    dw_zeroed[~picked] = 0
    rec = chip_smoke.ce_grads_check(dx, dw_zeroed, rdx, rdw, labels)
    assert not rec["ok"] and rec["dw_unlabeled_row_rel_l2_max"] == 1.0
    # an ignored row's dx must be exactly zero
    dx_bad = dx.clone()
    dx_bad[0] = 1e-3
    assert not chip_smoke.ce_grads_check(dx_bad, dw, rdx, rdw,
                                         labels)["ok"]


def _decode(hkv):
    """K10's phase at a narrow width: the chip's lengths (an empty row
    among them) over a 2048 cache, 4 query heads of 32. The stand-in
    runs the plain version on bf16 inputs (p and o rounded to bf16, as
    the kernel rounds them); the reference on the same values in
    fp32."""
    rs = np.random.RandomState(2)
    B, Hq, T, D = len(chip_smoke.K10_LENGTHS), 4, 2048, 32
    q = torch.from_numpy(rs.randn(B, Hq, D).astype(np.float32))
    k, v = (torch.from_numpy(rs.randn(B, hkv, T, D).astype(np.float32))
            for _ in range(2))
    q, k, v = (t.bfloat16() for t in (q, k, v))
    lens = torch.tensor(chip_smoke.K10_LENGTHS, dtype=torch.int32)
    ref = decode_attention_reference(q.float(), k.float(), v.float(), lens,
                                     return_stats=True)
    good = decode_attention_reference(q, k, v, lens, return_stats=True)
    return q, k, v, lens, ref, good


@pytest.mark.parametrize("hkv", [4, 2])
def test_decode_check_passes_bf16_rounding(hkv):
    *_, lens, ref, good = _decode(hkv)
    rec = chip_smoke.decode_attention_check(*good, *ref, lens)
    assert rec["ok"], rec
    assert 0 < rec["row_rel_l2_max"] < TOL
    rec = chip_smoke.decode_attention_check(good[0], None, None, ref[0],
                                            None, None, lens)
    assert rec["ok"], rec


@pytest.mark.parametrize("hkv", [4, 2])
def test_decode_check_fails_planted_faults(hkv):
    q, k, v, lens, ref, (o, m, l) = _decode(hkv)
    check = chip_smoke.decode_attention_check
    # the last key tile (64 keys, partial or whole) of every row dropped
    short = torch.where(lens > 0, (lens - 1) // 64 * 64, lens)
    o_s, m_s, l_s = decode_attention_reference(q, k, v, short,
                                               return_stats=True)
    rec = check(o_s, m_s, l_s, *ref, lens)
    assert not rec["ok"] and rec["row_rel_l2_max"] > 0.1
    # (m, l) without the rescale: each 64-key tile's sum taken against
    # its own max and added as it stands (o and m right)
    hq, d = q.shape[1:]
    s = torch.einsum("bhgd,bhtd->bhgt",
                     q.float().reshape(len(lens), hkv, hq // hkv, d),
                     k.float()) * d ** -0.5
    s = s.masked_fill(torch.arange(k.shape[2])[None, None, None, :]
                      >= lens[:, None, None, None].long(), float("-inf"))
    tiles = s.reshape(*s.shape[:3], -1, 64)
    m_t = tiles.amax(-1, keepdim=True)
    l_bad = torch.where(torch.isneginf(m_t), 0.0,
                        torch.exp(tiles - m_t)).sum((-1, -2))
    rec = check(o, m, l_bad.reshape(l.shape), *ref, lens)
    assert not rec["ok"] and rec["l_rel_err_max"] > 0.1
    assert rec["row_rel_l2_max"] < TOL
    # NaN on the length-0 row, in the output or in its stats
    o_nan = o.clone()
    o_nan[0] = float("nan")
    rec = check(o_nan, m, l, *ref, lens)
    assert not rec["ok"] and not rec["finite"]
    m_nan = m.clone()
    m_nan[0] = float("nan")
    rec = check(o, m_nan, l, *ref, lens)
    assert not rec["ok"] and not rec["empty_stats_exact"]


def _int8(M=8, K=256, N=2048):
    """K12's decode phase at a short K: the stand-in is the plain
    version on bf16 x (its output rounded to bf16 once, as the kernel's
    is); the reference the same product in fp32."""
    rs = np.random.RandomState(3)
    qt = quantize_tensor(torch.from_numpy(
        (0.02 * rs.randn(K, N)).astype(np.float32)).bfloat16())
    x = torch.from_numpy(rs.randn(M, K).astype(np.float32)).bfloat16()
    ref = int8_matmul_reference(x.float(), qt.q, qt.scale)
    good = int8_matmul_reference(x, qt.q, qt.scale)
    return x, qt, ref, good


def test_int8_check_passes_bf16_rounding():
    *_, ref, good = _int8()
    rec = chip_smoke.quant_matmul_check(good, ref)
    assert rec["ok"], rec
    assert 0 < rec["row_rel_l2_max"] < TOL


def test_int8_check_fails_planted_faults():
    x, qt, ref, good = _int8()
    acc = x.float() @ qt.q.float()
    # the scale applied per row (scale[m]) instead of per column
    per_row = (acc * qt.scale.reshape(-1)[:x.shape[0], None]).bfloat16()
    rec = chip_smoke.quant_matmul_check(per_row, ref)
    assert not rec["ok"] and rec["row_rel_l2_max"] > 0.02
    # the last 32-column block (one strip of the kernel) left zero
    tail = good.clone()
    tail[:, -32:] = 0
    rec = chip_smoke.quant_matmul_check(tail, ref)
    assert not rec["ok"] and rec["row_rel_l2_max"] > 0.05
