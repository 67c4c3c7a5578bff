"""The checks ``chip_smoke.py`` holds the K3/K4 and K5-K7 kernels to,
rehearsed on the CPU at small shapes: a stand-in for a correct bf16
kernel passes, and planted faults fail. The stand-in is the plain
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
from paddle_tpu_torch.ops.flash_attention import (
    flash_attention_bwd_reference, flash_attention_reference)

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
