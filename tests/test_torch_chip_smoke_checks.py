"""The checks ``chip_smoke.py`` holds the K3/K4, K5-K7, K8, K9, K10 (and
its fused write of the fresh rows) and K12 kernels to (K8 also at a
speculative verify's rows), phase 20's (the MoE gating on the card
against the CPU, the routing replay that pins a plain run to a kernel
run's experts, the executed FLOPs), phase 21's (the verify rows,
launch groups, expected launches, acceptance, the share of tokens equal
to the plain stream), phase 26's (a lossy KV wire's half-step bound,
the byte equality of installed rows) and phase 27's (``fleet_check``:
request-id accounting, streams, path kernels, weight checksums),
rehearsed on the CPU at small shapes: a stand-in for a
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
from paddle_tpu_torch.ops.decode_megakernel import (
    epilogue_logits, mega_decode_layers_reference,
    mega_logits_sample_reference)
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


def _fresh(hkv=2):
    """K10's fused write at a narrow width: the caches before the call,
    the plain version's caches after it (the stand-in for the kernel's),
    and the fresh rows."""
    q, k, v, *_ = _decode(hkv)
    rs = np.random.RandomState(4)
    B, D = k.shape[0], k.shape[-1]
    k_new, v_new = (torch.from_numpy(rs.randn(B, hkv, D).astype(
        np.float32)).bfloat16() for _ in range(2))
    lens = torch.tensor(chip_smoke.K10_FUSED_LENGTHS, dtype=torch.int32)
    wr = torch.tensor(chip_smoke.K10_FUSED_WRITE)
    kw, vw = k.clone(), v.clone()
    decode_attention_reference(q, kw, vw, lens, k_new=k_new, v_new=v_new,
                               write=wr)
    return k, v, kw, vw, k_new, v_new


def test_fresh_rows_check_passes_the_plain_write():
    k0, v0, kw, vw, *_ = _fresh()
    rec = chip_smoke.fresh_rows_check(kw, vw, kw.clone(), vw.clone(), k0,
                                      v0, chip_smoke.K10_FUSED_LENGTHS,
                                      chip_smoke.K10_FUSED_WRITE)
    assert rec["ok"], rec
    # the empty row and the row not written store nothing
    assert rec["rows_written"] == rec["rows_expected"] == 6


@pytest.mark.parametrize("fault", ["unclamped", "unmasked", "missing",
                                   "stray"])
def test_fresh_rows_check_fails_planted_faults(fault):
    k0, v0, kw, vw, k_new, v_new = _fresh()
    lens, wr = chip_smoke.K10_FUSED_LENGTHS, chip_smoke.K10_FUSED_WRITE
    bad_k, bad_v = kw.clone(), vw.clone()
    if fault == "unclamped":       # the clamped row written one too early
        b = lens.index(2048)
        bad_k[b, :, 2047] = k0[b, :, 2047]
        bad_k[b, :, 2046] = k_new[b]
    elif fault == "unmasked":      # the row marked False written anyway
        b = wr.index(False)
        bad_k[b, :, lens[b] - 1] = k_new[b]
    elif fault == "missing":       # V's row left as it was
        b = 1
        bad_v[b, :, lens[b] - 1] = v0[b, :, lens[b] - 1]
    else:                          # a stray store to the empty row
        bad_k[0, :, 0] = k_new[0]
    rec = chip_smoke.fresh_rows_check(bad_k, bad_v, kw, vw, k0, v0, lens,
                                      wr)
    assert not rec["ok"] and not rec["caches_equal"]
    assert not rec["only_those_rows"] or fault == "missing"


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


def _mega_inputs(n_layers=1, rows=chip_smoke.K8_ROWS):
    """K8's phase at a narrow width (d_model 64, 4 query heads of 16
    over 2 kv heads, rope), the chip's rows (or ``rows``): the inputs in
    bf16, and the same values in fp32 for the reference."""
    gen = torch.Generator()
    gen.manual_seed(4)
    inp = chip_smoke.mega_inputs(torch, "cpu", gen, 64, 4, 2, 16, n_layers,
                                 bias=True, rope=True, rows=rows)
    ref = dict(inp, x=inp["x"].float(), kp=inp["kp"].float(),
               vp=inp["vp"].float(),
               w={n: t.float() for n, t in inp["w"].items()})
    return inp, ref


def _mega_run(inp, fault=None):
    """The plain K8 loop on ``inp``, or with one planted fault:
    ``skip_last_page`` (a row spanning pages attends only over its full
    pages), ``inactive_writes`` (the inactive row writes its slot's
    page), ``attend_before_write`` (each row writes then attends at
    once, last row first: the second of two rows of one slot attends
    before the first has written). Returns (x_out, kp, vp)."""
    from paddle_tpu_torch.models.gpt import GPTBlock, GPTConfig
    from paddle_tpu_torch.ops.paged_attention import (
        paged_decode_attention_reference as attend)
    kp, vp = inp["kp"].clone(), inp["vp"].clone()
    if fault is None:
        out = mega_decode_layers_reference(
            inp["x"], inp["w"], kp, vp, inp["table"], inp["pos"],
            inp["slot"], inp["write"], **inp["geo"])
        return out, kp, vp
    geo, w = inp["geo"], inp["w"]
    L, P, page = w["wqkv"].shape[0], geo["n_pages"], geo["page"]
    blk = GPTBlock(GPTConfig(d_model=64, n_layers=L, n_heads=4,
                             n_kv_heads=2, rope=True))
    pos = inp["pos"]
    tables = inp["table"][inp["slot"].long()]
    pid = tables.gather(1, (pos // page)[:, None].long())[:, 0].long()
    offs = (pos % page).long()
    lens = pos + 1
    if fault == "skip_last_page":
        lens = torch.where(pos >= page, pos // page * page, lens)
    write = (torch.ones_like(inp["write"]) if fault == "inactive_writes"
             else inp["write"])
    h = inp["x"][:, None]
    B = h.shape[0]
    for layer in range(L):
        lw = {n: t[layer] for n, t in w.items()}
        q, k, v = blk._qkv(h, pos, lw)
        g = torch.where(write == 1, layer * P + pid, L * P)
        order = range(B - 1, -1, -1) if fault == "attend_before_write" \
            else range(B)
        if fault != "attend_before_write":
            kp[g, :, offs] = k[:, 0]
            vp[g, :, offs] = v[:, 0]
        o = [None] * B
        for r in order:
            if fault == "attend_before_write":
                kp[g[r], :, offs[r]] = k[r, 0]
                vp[g[r], :, offs[r]] = v[r, 0]
            o[r] = attend(q[r:r + 1, 0], kp, vp,
                          layer * P + tables[r:r + 1], lens[r:r + 1])
        h = blk._block_tail(h, torch.cat(o).reshape(B, 1, -1), lw)
    return h[:, 0], kp, vp


def test_mega_layers_check_passes_bf16_rounding():
    inp, ref = _mega_inputs()
    rx, rkp, rvp = _mega_run(ref)
    gx, gkp, gvp = _mega_run(inp)
    rec = chip_smoke.mega_layers_check(gx, rx, (gkp, gvp), (rkp, rvp),
                                       (inp["kp"], inp["vp"]),
                                       inp["written"], TOL)
    assert rec["ok"], rec
    assert 0 < rec["row_rel_l2_max"] < TOL
    assert 0 < rec["written_row_rel_l2_max"] < TOL


@pytest.mark.parametrize("fault, why", [
    ("skip_last_page", "row_rel_l2_max"),
    ("inactive_writes", "untouched_bit_identical"),
    ("attend_before_write", "row_rel_l2_max"),
])
def test_mega_layers_check_fails_planted_faults(fault, why):
    inp, ref = _mega_inputs()
    rx, rkp, rvp = _mega_run(ref)
    bx, bkp, bvp = _mega_run(inp, fault)
    rec = chip_smoke.mega_layers_check(bx, rx, (bkp, bvp), (rkp, rvp),
                                       (inp["kp"], inp["vp"]),
                                       inp["written"], TOL)
    assert not rec["ok"], rec
    if why == "row_rel_l2_max":
        assert rec[why] > 2 * TOL, rec
    else:
        assert not rec[why]


@pytest.mark.parametrize("B, K", chip_smoke.SPEC_ROW_CASES)
def test_spec_rows_are_a_verify(B, K):
    """Phase 11's verify rows: B // K slots of K consecutive positions
    inside their two pages, slot 1 across the page boundary, the last
    slot inactive, every other slot written."""
    rows = chip_smoke.spec_rows(B, K)
    assert len(rows) == B
    slots = [rows[i:i + K] for i in range(0, B, K)]
    for s, run in enumerate(slots):
        assert [r[0] for r in run] == [s] * K
        p0 = run[0][1]
        assert [r[1] for r in run] == list(range(p0, p0 + K))
        assert 0 <= p0 and p0 + K - 1 < chip_smoke.K8_PAGES * 128
        assert {r[2] for r in run} == {int(s != len(slots) - 1)}
    assert slots[1][0][1] < 128 <= slots[1][-1][1]
    assert slots[0][0][1] == 0


@pytest.mark.parametrize("K", [chip_smoke.SPEC_K, 8])
def test_verify_rows_are_a_per_layer_verify(K):
    """Phase 11's K2' verify case: K rows a slot over the slot's table
    row, row j seeing n + j + 1 keys; slot 1 crosses a page, the last
    slot ends inside T 2048; the bound reads each slot's keys once."""
    lens, table_rows = chip_smoke.verify_rows(K)
    n = chip_smoke.VERIFY_SLOT_LENS
    assert table_rows == sorted(table_rows) == [
        s for s in range(len(n)) for _ in range(K)]
    for s in range(len(n)):
        assert lens[s * K:(s + 1) * K] == [n[s] + j + 1 for j in range(K)]
    assert n[1] < 128 <= n[1] + K - 1
    assert max(lens) <= 2048
    assert chip_smoke.distinct_keys(lens, table_rows) == sum(
        m + K for m in n)


def test_distinct_keys_by_hand():
    assert chip_smoke.distinct_keys([3, 5, 4, 9], [0, 0, 1, 1]) == 14
    assert chip_smoke.distinct_keys([129, 130, 168], [0, 0, 0]) == 168
    assert chip_smoke.distinct_keys([1, 2], [0, 1]) == 3


@pytest.mark.parametrize("B, K", [(32, 4), (64, 8)])
def test_mega_layers_check_at_verify_rows(B, K):
    """At a verify's rows the stand-in passes and a kernel that lets a
    row attend before an earlier row of its slot wrote fails."""
    inp, ref = _mega_inputs(rows=chip_smoke.spec_rows(B, K))
    rx, rkp, rvp = _mega_run(ref)
    gx, gkp, gvp = _mega_run(inp)
    rec = chip_smoke.mega_layers_check(gx, rx, (gkp, gvp), (rkp, rvp),
                                       (inp["kp"], inp["vp"]),
                                       inp["written"], TOL)
    assert rec["ok"], rec
    assert int(inp["written"].sum()) == (B - K)     # one slot inactive
    bx, bkp, bvp = _mega_run(inp, "attend_before_write")
    rec = chip_smoke.mega_layers_check(bx, rx, (bkp, bvp), (rkp, rvp),
                                       (inp["kp"], inp["vp"]),
                                       inp["written"], TOL)
    assert not rec["ok"] and rec["row_rel_l2_max"] > 2 * TOL, rec


@pytest.mark.parametrize("slots, K, groups", [(8, 4, 1), (16, 4, 1),
                                              (16, 8, 2), (9, 8, 2),
                                              (3, 64, 3)])
def test_spec_groups_keep_slots_whole(slots, K, groups):
    assert chip_smoke.spec_groups(slots, K) == groups


def test_serve_expected_by_hand():
    names = ["flash_attention", "paged_append_attend",
             "paged_decode_attention", "mega_decode_layers",
             "mega_logits_sample", "decode_attention", "int8_matmul",
             "noop_copy"]
    L = 24
    exp = chip_smoke.serve_expected("paged_mega", names, L, 48, 8, 1, 9, 2)
    assert exp == dict.fromkeys(names, 0) | {
        "flash_attention": 192, "paged_decode_attention": 24,
        "mega_decode_layers": 96, "mega_logits_sample": 96}
    exp = chip_smoke.serve_expected("paged_mega", names, L, 64, 8, 0, 8, 0)
    assert exp["mega_decode_layers"] == exp["mega_logits_sample"] == 64
    exp = chip_smoke.serve_expected("paged", names, L, 48, 8, 0, 8, 1)
    assert exp["paged_decode_attention"] == 24 * 48
    assert exp["paged_append_attend"] == 0
    exp = chip_smoke.serve_expected("paged", names, L, 64, 8, 0, 8, 0)
    assert exp["paged_append_attend"] == 24 * 64
    exp = chip_smoke.serve_expected("contiguous", names, L, 48, 0, 0, 8, 1)
    assert exp == dict.fromkeys(names, 0)
    exp = chip_smoke.serve_expected("int8", names, L, 48, 0, 0, 8, 1)
    assert exp == dict.fromkeys(names, 0) | {"int8_matmul": 96 * 56}
    exp = chip_smoke.serve_expected("int8", names, L, 64, 0, 0, 8, 0)
    assert exp["decode_attention"] == 24 * 64
    assert exp["int8_matmul"] == 96 * 72


def test_acceptance_and_equal_share():
    assert chip_smoke.acceptance([0, 4, 1, 0, 2, 3]) == 2.5
    assert chip_smoke.acceptance([0, 0]) == 0

    class R:
        def __init__(self, tokens):
            self.tokens = tokens

    got = [R([1, 2, 3, 4]), R([5, 6])]
    ref = [R([1, 2, 9, 4]), R([5, 7])]
    assert chip_smoke.equal_share(got, ref) == 4 / 6


def test_loop_prompts_repeat_eight_tokens():
    ps = chip_smoke.loop_prompts(50304, 8)
    assert len(ps) == 8 and all(len(p) == 128 for p in ps)
    for p in ps:
        assert p[8:] == p[:-8] and max(p) < 50304
    assert len({tuple(p) for p in ps}) == 8


def _logits():
    """K9's phase at a narrow width: d_model 64, V 4096, a head at the
    init's std 0.02, bf16, with ``mega_logits_inputs``' planted cases."""
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randn(8, 64).astype(np.float32)).bfloat16()
    wte = torch.from_numpy(
        (0.02 * rs.randn(4096, 64)).astype(np.float32)).bfloat16()
    s, b = torch.ones(64), torch.zeros(64)
    x, w, poison, ties = chip_smoke.mega_logits_inputs(torch, x, wte, s, b)
    logits = epilogue_logits(x, s, b, w.t(), poison)
    tok, nf = mega_logits_sample_reference(x, s, b, w.t(), poison)
    return logits, tok, nf, ties


def test_mega_logits_check_passes_and_plants():
    logits, tok, nf, ties = _logits()
    rec = chip_smoke.mega_logits_check(tok, nf, logits, nf, ties)
    assert rec["ok"], rec
    # the poisoned row and the overflowing row flag, nothing else
    assert nf.tolist() == [0, 0, 1, 0, 1, 0, 0, 0]
    assert rec["rows_compared"] >= 4
    assert ties == {0: 1000, 1: 2000}


def test_mega_logits_check_fails_planted_faults():
    logits, tok, nf, ties = _logits()
    check = chip_smoke.mega_logits_check
    # the last of equal maxima
    V = logits.shape[1]
    last = (V - 1 - logits.float().flip(1).argmax(1)).to(tok.dtype)
    rec = check(torch.where(nf == 0, last, tok), nf, logits, nf, ties)
    assert not rec["ok"] and not rec["ties_lowest"]
    # the flags of one 32-column strip (the one holding the overflow)
    # dropped
    keep = torch.ones(V, dtype=torch.bool)
    keep[(V - 5) // 32 * 32:(V - 5) // 32 * 32 + 32] = False
    nf_bad = (~torch.isfinite(logits[:, keep]).all(1)).to(torch.int32)
    rec = check(tok, nf_bad, logits, nf, ties)
    assert not rec["ok"] and not rec["flags_exact"]
    # a token far below its row's maximum where the top two are close
    near = [r for r in range(8) if nf[r] == 0 and r not in ties]
    bad = tok.clone()
    bad[near[0]] = logits[near[0]].float().argmin()
    rec = check(bad, nf, logits, nf, ties)
    assert not rec["ok"] and not rec["gaps_within_2ulp"]


# ---- the fifth slice: K11, the attention bias and dropout, the encoder --

def _k11(N=96, M=256, p=0.1, seed=-77):
    from paddle_tpu_torch.ops import _hash
    from paddle_tpu_torch.ops.layer_norm import fused_layer_norm_reference
    rs = np.random.RandomState(1)
    x, res = (torch.from_numpy(rs.randn(M, N).astype(np.float32))
              for _ in range(2))
    gamma, beta, bias = (torch.from_numpy(rs.randn(N).astype(np.float32))
                         for _ in range(3))
    ref = fused_layer_norm_reference(x, gamma, beta, bias, res, seed, 1e-5,
                                     p)
    # the stand-in: the plain version on bf16 inputs, bf16 outputs
    good = fused_layer_norm_reference(x.bfloat16(), gamma, beta, bias,
                                      res.bfloat16(), seed, 1e-5, p)
    keep = _hash.layer_norm_keep(seed, (M, N), p)
    return ref, good, keep


def test_layer_norm_check_passes_bf16_rounding():
    ref, good, keep = _k11()
    # the statistics of bf16 inputs differ from the fp32 ones by the
    # inputs' rounding: compare them with the plain version's on the
    # same bf16 inputs, as the chip does
    good_stats = (good[0], good[1], ref[2], ref[3])
    rec = chip_smoke.layer_norm_check(good_stats, ref, keep.clone(), keep)
    assert rec["ok"], rec
    assert 0 < rec["y_row_rel_l2_max"] < TOL


def test_layer_norm_check_fails_planted_faults():
    ref, good, keep = _k11()
    y, pre, mean, rstd = good[0], good[1], ref[2], ref[3]
    flipped = keep.clone()
    flipped[200, 17] = ~flipped[200, 17]            # one mask bit
    assert not chip_smoke.layer_norm_check((y, pre, mean, rstd), ref,
                                           flipped, keep)["ok"]
    bad_y = y.clone()
    bad_y[100] = 0                                  # one row not written
    assert not chip_smoke.layer_norm_check((bad_y, pre, mean, rstd), ref,
                                           keep, keep)["ok"]
    bad_rstd = rstd.clone()
    bad_rstd[5] *= 1 + 1e-3                         # a variance off
    assert not chip_smoke.layer_norm_check((y, pre, mean, bad_rstd), ref,
                                           keep, keep)["ok"]
    bad_mean = mean.clone()
    bad_mean[9] += 1e-3
    assert not chip_smoke.layer_norm_check((y, pre, bad_mean, rstd), ref,
                                           keep, keep)["ok"]


def _attention_bias_dropout(B=2, S=128, Sk=200, H=2, D=16, p=0.1,
                            seed=5):
    rs = np.random.RandomState(2)
    q, do = (torch.from_numpy(rs.randn(B, S, H, D).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rs.randn(B, Sk, H, D).astype(np.float32))
            for _ in range(2))
    bias = torch.from_numpy(rs.randn(B, 1, 1, Sk).astype(np.float32))
    q, k, v, do = (t.to(torch.bfloat16).float() for t in (q, k, v, do))
    o, lse = flash_attention_reference(q, k, v, False, None, None, bias,
                                       p, seed)
    ref = flash_attention_bwd_reference(q, k, v, o, lse, do, False, None,
                                        None, bias, p, seed)
    bf = [t.to(torch.bfloat16) for t in (q, k, v, o, do)]
    good_o = flash_attention_reference(*bf[:3], False, None, None, bias, p,
                                       seed)[0]
    good = flash_attention_bwd_reference(*bf[:4], lse, bf[4], False, None,
                                         None, bias, p, seed)
    return o, ref, good_o, good


def test_attention_bias_dropout_check_passes_and_fails():
    o, ref, good_o, good = _attention_bias_dropout()
    rec = chip_smoke.attention_bias_dropout_check(good_o, o, good, ref,
                                                  None)
    assert rec["ok"], rec
    # a gradient that reached the bias
    assert not chip_smoke.attention_bias_dropout_check(
        good_o, o, good, ref, torch.zeros(2, 1, 1, 200))["ok"]
    # the output of a row dropped wholesale
    bad_o = good_o.clone()
    bad_o[1, 70] = 0
    assert not chip_smoke.attention_bias_dropout_check(bad_o, o, good, ref,
                                                       None)["ok"]
    # dv without the 1 / (1 - p) scale of the kept cells
    assert not chip_smoke.attention_bias_dropout_check(
        good_o, o, (good[0], good[1], ref[2] * 0.9), ref, None)["ok"]


@pytest.mark.parametrize("sk", [200, 600])
def test_dropout_pattern_check_fails_a_wrong_stride(sk):
    """The pattern read through one-hot V (``dropout_pattern``, the
    plain K1 on the CPU) matches the JAX-stride mask; a kernel hashing
    with Sk as its stride does not."""
    from paddle_tpu_torch.ops import _hash
    B, Sq, H, D, p, seed = 1, 48, 2, 64, 0.2, 31
    rs = np.random.RandomState(4)
    q = torch.from_numpy(0.3 * rs.randn(B, Sq, H, D).astype(np.float32))
    k = torch.from_numpy(0.3 * rs.randn(B, sk, H, D).astype(np.float32))
    got = chip_smoke.dropout_pattern(torch, q, k, seed, p, D)
    stride = _hash.jax_key_stride(sk)
    assert stride != sk
    want = _hash.attention_keep(seed, B, H, Sq, sk, p, stride)
    assert chip_smoke.mask_check(got, want)["ok"]
    wrong = _hash.attention_keep(seed, B, H, Sq, sk, p, sk)
    assert not chip_smoke.mask_check(wrong, want)["ok"]
    flipped = got.clone()
    flipped[0, 1, 3, 7] = ~flipped[0, 1, 3, 7]
    rec = chip_smoke.mask_check(flipped, want)
    assert not rec["ok"] and rec["mask_mismatches"] == 1


def test_encoder_step_check():
    grads = {"0.qkv_weight": 0.004, "11.ln2_bias": 0.01}
    assert chip_smoke.encoder_step_check(2.0, 2.0005, grads)["ok"]
    assert not chip_smoke.encoder_step_check(2.0, 2.01, grads)["ok"]
    assert not chip_smoke.encoder_step_check(
        2.0, 2.0, {**grads, "3.linear_bias": 0.03})["ok"]


def test_cached_decode_check():
    rs = np.random.RandomState(6)
    full = torch.from_numpy(rs.randn(2, 4, 64).astype(np.float32))
    steps = full + 1e-6 * torch.from_numpy(
        rs.randn(2, 4, 64).astype(np.float32))
    assert chip_smoke.cached_decode_check(steps, full)["ok"]
    bad = steps.clone()
    bad[1, 3] = full[1, 2]              # a token attending one step late
    assert not chip_smoke.cached_decode_check(bad, full)["ok"]


class _Cuda:
    @staticmethod
    def synchronize():
        pass


class _Torch:
    cuda = _Cuda


def _fake_windows(monkeypatch, windows):
    """Make ``chip_smoke._profile_events`` return ``windows`` in turn (each
    a list of (kernel name, device microseconds)); returns the list of
    the iteration counts it was asked for."""
    asked = []

    def events(torch, fn, iters):
        asked.append(iters)
        return windows.pop(0)

    monkeypatch.setattr(chip_smoke, "_profile_events", events)
    return asked


@pytest.mark.parametrize("case", ["full", "short_then_full", "all_short"])
def test_device_ms_checks_each_windows_launch_count(monkeypatch, case):
    """A profiler window counts only when it holds iters x launches
    matching kernels: a full one is read at once, a short one is
    profiled again, and three short ones give None (the phase fails)."""
    iters, us = 4, 250.0
    full = [("k12_kernel", us)] * (2 * iters) + [("other", 9e9)]
    short = [("k12_kernel", us / 2)] * iters + [("other", 9e9)]
    windows = {"full": [full], "short_then_full": [short, full],
               "all_short": [short, short, short]}[case]
    asked = _fake_windows(monkeypatch, list(windows))
    got = chip_smoke._device_ms(_Torch, lambda: None, keys=("k12",),
                                launches=2, iters=iters, warmup=1)
    assert asked == [iters] * len(windows)
    if case == "all_short":
        assert got is None
        assert len(asked) == chip_smoke.PROFILE_WINDOWS
    else:
        assert got == pytest.approx(2 * us / 1e3)


def test_device_ms_counts_a_calls_launches_when_not_given(monkeypatch):
    """Without the caller's count (plain versions, library calls), the
    median of what one-call windows recorded is the count a window must
    hold per call: a one-call window that lost a launch, or caught one
    more, does not set it."""
    one = [("a", 1.0), ("b", 2.0), ("c", 3.0)]
    windows = [one, one[:2], one + [("d", 4.0)]] + [one * 2 + one[:1],
                                                    one * 2]
    asked = _fake_windows(monkeypatch, windows)
    got = chip_smoke._device_ms(_Torch, lambda: None, iters=2, warmup=0)
    assert asked == [1, 1, 1, 2, 2]
    assert got == pytest.approx(6.0 / 1e3)


@pytest.mark.parametrize("case", ["one", "lost_then_one", "two_always"])
def test_one_call_window_is_profiled_again_when_not_one(monkeypatch,
                                                         case):
    """The one-call window (K11's one launch a call) is read at once
    when it holds one kernel, profiled again when it lost the launch,
    and a call that launches two kernels shows them after
    PROFILE_WINDOWS windows."""
    one = [("fused_ln_fwd", 20.0)]
    two = [("cast", 1.0), ("fused_ln_fwd", 20.0)]
    windows = {"one": [one], "lost_then_one": [[], one],
               "two_always": [two] * chip_smoke.PROFILE_WINDOWS}[case]
    asked = _fake_windows(monkeypatch, list(windows))
    names = chip_smoke._one_call_kernels(_Torch, lambda: None)
    assert asked == [1] * len(windows)
    if case == "two_always":
        assert names == ["cast", "fused_ln_fwd"]
    else:
        assert names == ["fused_ln_fwd"]


def test_fail_reports_on_both_streams(capsys):
    """A failed phase's reason reaches standard error as well as
    standard output, and the exit code is 1."""
    with pytest.raises(SystemExit) as stop:
        chip_smoke._fail("phase x: planted")
    assert stop.value.code == 1
    out, err = capsys.readouterr()
    assert "FAILED: phase x: planted" in out
    assert "FAILED: phase x: planted" in err


def test_profiled_window_is_padded_on_both_sides(monkeypatch):
    """Every profiler window opens and closes with PROFILE_PAD_S of idle
    time, the device synchronised first, so no kernel of the body lies
    at the window's edge (where the profiler drops what it finds
    outside the window on its own clock); after the opening pad
    WAKE_LAUNCHES spins are waited for before the body, and the
    window's events leave them out."""
    import torch.profiler as tp
    log = []

    class _Prof:
        def __enter__(self):
            log.append("start")
            return self

        def __exit__(self, *exc):
            log.append("stop")
            return False

        def events(self):
            return [_Event(chip_smoke.WAKE_KERNEL), _Event("body_kernel")]

    class _Event:
        def __init__(self, name):
            self.name = name

    class _SyncCuda:
        @staticmethod
        def synchronize():
            log.append("sync")

        @staticmethod
        def _sleep(cycles):
            log.append(("spin", cycles))

    class _SyncTorch:
        cuda = _SyncCuda

    monkeypatch.setattr(tp, "profile", lambda **kw: _Prof())
    monkeypatch.setattr(chip_smoke.time, "sleep",
                        lambda s: log.append(("sleep", s)))
    with chip_smoke._profiled(_SyncTorch) as prof:
        log.append("body")
    pad = ("sleep", chip_smoke.PROFILE_PAD_S)
    spin = ("spin", chip_smoke.WAKE_CYCLES)
    assert chip_smoke.PROFILE_PAD_S > 0 and chip_smoke.WAKE_CYCLES > 0
    assert chip_smoke.WAKE_LAUNCHES > 8
    assert log == (["sync", "start", pad]
                   + [spin] * chip_smoke.WAKE_LAUNCHES
                   + ["sync", "body", "sync", pad, "stop"])
    assert [e.name for e in prof.events()] == ["body_kernel"]


def test_phase_times_reads_the_record():
    """K8's phase-time record: (time, code) pairs from the kernel's
    start, each code naming the phase that ended at its barrier (16 per
    layer), read up to the first unwritten pair."""
    from paddle_tpu_torch.ops.decode_megakernel import PHASES, phase_times
    codes = [-1] + [16 * l + p for l in range(2) for p in range(len(PHASES))]
    times = [1000 + 7000 * i for i in range(len(codes))]
    buf = torch.zeros(2 * len(codes) + 4, dtype=torch.int64)
    buf[0:2 * len(codes):2] = torch.tensor(times)
    buf[1:2 * len(codes):2] = torch.tensor(codes)
    got = phase_times(buf)
    assert [(layer, name) for layer, name, _ in got] == [
        (layer, name) for layer in range(2) for name in PHASES]
    assert all(ms == pytest.approx(0.007) for _, _, ms in got)


# ---------------------------------------------------------------------------
# phase 19: the train step with every option
# ---------------------------------------------------------------------------

def test_options_decay_exempts_only_layer_norm():
    fn = chip_smoke.options_decay
    for name in ("blocks.item_0.ln1_scale", "blocks.item_3.ln2_bias",
                 "lnf_scale", "lnf_bias"):
        assert not fn(name), name
    for name in ("blocks.item_0.wqkv", "blocks.item_5.bqkv", "wte", "wpe",
                 "blocks.item_1.bdown"):
        assert fn(name), name


def _adamw_slabs(decay, dtype, std, mean, card=False):
    """One slab through the port's AdamW (bf16 moments, the global clip,
    a decay mask) for two steps, and the inputs the hand update of the
    second needs. ``card``: the phase's schedule and decay (a rate of
    about 1e-4, wd 0.01), else a rate and decay large enough that each
    control moves every value."""
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm
    rs = np.random.RandomState(0)
    name = "stacked.w"
    p = torch.from_numpy(mean + std * rs.randn(3, 8, 16).astype(
        np.float32)).to(dtype)
    lr, wd = ((chip_smoke.options_schedule(), chip_smoke.OPT_WD) if card
              else (1e-2, 0.1))
    opt = AdamW(learning_rate=lr, weight_decay=wd,
                apply_decay_param_fun=lambda n: decay,
                grad_clip=ClipGradByGlobalNorm(chip_smoke.OPT_CLIP),
                moment_dtype=torch.bfloat16)
    opt.set_decay_mask(name, torch.full((3, 1, 1), float(decay)))
    params = {name: p}
    state = opt.init(params)
    for i in range(2):
        g = torch.from_numpy(3 * rs.randn(3, 8, 16).astype(np.float32)).to(
            torch.bfloat16)
        p0 = p.clone()
        m0, v0 = (s.clone() for s in state["slots"][name])
        params, state = opt.update({name: g}, state, params)
    return (p, p0, g, m0, v0, opt.grad_clip.last_norm, opt.last_lr,
            state["step"], wd)


@pytest.mark.parametrize("decay,dtype,std,mean", [
    (True, torch.bfloat16, 0.002, 0.0),      # stacked.wqkv
    (False, torch.float32, 0.1, 1.0)])       # stacked.ln1_scale
def test_adamw_reference_equals_the_optimizer(decay, dtype, std, mean):
    """The hand update of the second step, from the saved (p, g, m, v),
    gives the optimizer's values exactly; at a large rate and decay
    every control (the unclipped gradient, the decay flipped, the next
    step) moves values and fails, and so does an update made with any
    of them."""
    p, p0, g, m0, v0, norm, lr, step, wd = _adamw_slabs(decay, dtype, std,
                                                         mean)
    assert float(norm) > chip_smoke.OPT_CLIP       # the clip engaged
    rec = chip_smoke.update_controls(torch, p, p0, g, m0, v0, norm, lr,
                                     step, decay, wd=wd)
    assert rec["ok"] and rec["max_abs_err"] == 0.0 and rec["moved"] > 0
    assert rec["cannot_move"] == []
    assert all(c["moves"] and c["caught"] for c in rec["controls"].values())
    gc = chip_smoke.clipped(torch, g, norm)
    bad = [chip_smoke.adamw_reference(torch, p0, g, m0, v0, lr, step,
                                      decay, wd=wd),
           chip_smoke.adamw_reference(torch, p0, gc, m0, v0, lr, step,
                                      not decay, wd=wd),
           chip_smoke.adamw_reference(torch, p0, gc, m0, v0, lr, step + 1,
                                      decay, wd=wd)]
    for r in bad:
        assert not chip_smoke.update_check(p, r)["ok"]
        assert not chip_smoke.update_controls(
            torch, r, p0, g, m0, v0, norm, lr, step, decay, wd=wd)["ok"]


@pytest.mark.parametrize("slab,decay,dtype,std,mean", [
    ("stacked.wqkv", True, torch.bfloat16, 0.02, 0.0),
    ("stacked.ln1_scale", False, torch.float32, 0.0, 1.0)])
def test_update_controls_at_the_card_values(slab, decay, dtype, std, mean):
    """At the phase's own rate, decay, init and dtypes (the weights bf16,
    the LayerNorm scales fp32): the hand update is exact, the update
    moves values, and the unclipped gradient and the next step move
    them otherwise and are caught."""
    assert slab in chip_smoke.UPDATE_SLABS
    p, p0, g, m0, v0, norm, lr, step, wd = _adamw_slabs(
        decay, dtype, std, mean, card=True)
    assert float(norm) > chip_smoke.OPT_CLIP
    assert lr == pytest.approx(chip_smoke.OPT_LR, rel=1e-6)
    rec = chip_smoke.update_controls(torch, p, p0, g, m0, v0, norm, lr,
                                     step, decay, wd=wd)
    assert rec["ok"] and rec["max_abs_err"] == 0.0 and rec["moved"] > 0
    for name in ("unclipped", "next_step"):
        c = rec["controls"][name]
        assert c["moves"] and c["caught"], name
    assert all(c["caught"] for c in rec["controls"].values()
               if c["moves"])


def test_lr_check_reads_the_schedule():
    sched = chip_smoke.options_schedule()
    used = [float(sched.value_at(i)) for i in range(1, 7)]
    rec = chip_smoke.lr_check(used, chip_smoke.options_schedule())
    assert rec["ok"] and used[0] == pytest.approx(chip_smoke.OPT_LR / 2)
    # the step counter read before its increment: one step late
    late = [float(sched.value_at(i)) for i in range(0, 6)]
    assert not chip_smoke.lr_check(late, sched)["ok"]


def _packed(n_layers=3):
    from paddle_tpu_torch.observability import numerics
    grads = {"stacked.a": torch.randn(n_layers, 4),
             "stacked.b": torch.randn(n_layers, 2, 3),
             "wte": torch.randn(5, 2)}
    box = numerics.LayoutBox()
    packed = numerics.capture_step(grads, loss=torch.tensor(1.0),
                                   updates=grads,
                                   stacked_keys=["stacked.a", "stacked.b"],
                                   box=box)
    return packed, box.layout


def test_numerics_check_passes_and_fails(monkeypatch):
    monkeypatch.setenv("PT_NUMERICS_EVERY", "1")
    packed, layout = _packed()
    rec = chip_smoke.numerics_check(torch, packed, layout, 3)
    assert rec["ok"] and rec["stacked_families"] == 4
    assert not chip_smoke.numerics_check(torch, packed, layout, 4)["ok"]
    bad = packed.clone()
    bad[-1] = float("nan")
    assert not chip_smoke.numerics_check(torch, bad, layout, 3)["ok"]
    assert not chip_smoke.numerics_check(torch, torch.zeros_like(packed),
                                         layout, 3)["ok"]


def test_poison_check_names_the_layer():
    snap = {"first_bad_layer": 5,
            "first_bad_family_name": "grad/_stacked_blocks.0",
            "alerts": ["nonfinite"]}
    assert chip_smoke.poison_check(snap, 5)["ok"]
    assert not chip_smoke.poison_check(snap, 4)["ok"]
    assert not chip_smoke.poison_check(
        dict(snap, first_bad_family_name="upd/_stacked_blocks.0"), 5)["ok"]
    assert not chip_smoke.poison_check(dict(snap, alerts=[]), 5)["ok"]
    assert not chip_smoke.poison_check({}, 5)["ok"]


def test_options_step_check_holds_the_norm():
    grads = {"a": 1e-3, "b": 2e-2}
    assert chip_smoke.options_step_check(2.0, 2.001, grads, 1.5, 1.51)["ok"]
    assert not chip_smoke.options_step_check(2.0, 2.001, grads, 1.5,
                                             1.6)["ok"]
    assert not chip_smoke.options_step_check(2.0, 2.1, grads, 1.5,
                                             1.5)["ok"]
    assert not chip_smoke.options_step_check(2.0, 2.0, {"a": 0.05}, 1.5,
                                             1.5)["ok"]


def test_decay_mask_check_reads_the_registered_masks():
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.optimizer import AdamW
    model = gpt.GPT(gpt.gpt_tiny(n_layers=3), seed=0, device="cpu")
    opt = AdamW(apply_decay_param_fun=chip_smoke.options_decay)
    gpt.init_train_state(model, opt)
    masks = {n: opt.decay_mask(n) for n in model.slab_entries()}
    rec = chip_smoke.decay_mask_check(masks, chip_smoke.options_decay, 3)
    assert rec["ok"] and rec["decayed_layers"]["stacked.wqkv"] == 3
    assert rec["decayed_layers"]["stacked.ln1_scale"] == 0
    bad = dict(masks)
    bad["stacked.ln2_bias"] = torch.ones(3, 1)
    assert chip_smoke.decay_mask_check(
        bad, chip_smoke.options_decay, 3)["wrong"] == ["stacked.ln2_bias"]
    # a slab with no mask registered
    bad = dict(masks, **{"stacked.wup": None})
    assert chip_smoke.decay_mask_check(
        bad, chip_smoke.options_decay, 3)["wrong"] == ["stacked.wup"]
    assert not chip_smoke.decay_mask_check({}, chip_smoke.options_decay,
                                           3)["ok"]


def test_sweep_cases_and_finite_check():
    """Every sweep case builds an optimizer of the port; the finite
    check names a planted NaN or inf and nothing else."""
    cases = chip_smoke.sweep_cases()
    assert len(cases) == 16 and list(cases)[-1].startswith("amp_O2")
    for make in cases.values():
        assert hasattr(make(), "update")
    t = {"a": torch.ones(3), "b": torch.ones(2, 2), "c": torch.zeros(4)}
    assert chip_smoke.finite_check(torch, t) == []
    t["b"][1, 0] = float("nan")
    t["c"][2] = float("-inf")
    assert chip_smoke.finite_check(torch, t) == ["b", "c"]


def test_cast_check_wants_fp32_then_bf16():
    """The amp O2 case's check: an fp32 model before ``decorate``, every
    parameter bf16 after it; an already-bf16 model, or a parameter left
    in fp32, fails."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import gpt
    model = gpt.GPT(gpt.gpt_tiny(dtype=torch.float32), seed=0, device="cpu")
    before = [p.dtype for p in model.parameters()]
    amp.decorate(model, level="O2", dtype="bfloat16")
    after = [p.dtype for p in model.parameters()]
    rec = chip_smoke.cast_check(torch, before, after)
    assert rec["ok"] and rec["after"] == ["torch.bfloat16"]
    assert not chip_smoke.cast_check(torch, after, after)["ok"]
    assert not chip_smoke.cast_check(torch, before,
                                     after[:-1] + [torch.float32])["ok"]
    assert not chip_smoke.cast_check(torch, [], [])["ok"]


# -- phase 20: the MoE GPT -----------------------------------------------------

def _gating(gate, dev_logits=None):
    from paddle_tpu_torch import random as prng
    from paddle_tpu_torch.incubate import moe
    r = moe.Routing.for_gate(8, gate)
    logits = torch.from_numpy(np.random.RandomState(4).randn(
        256, 8).astype(np.float32))
    key = prng.PRNGKey(0) if r.jitter_eps > 0 else None
    out = moe.top_k_gating(logits, r.k, r.capacity(256), key, r.jitter_eps)
    jit = moe._jitter(key, logits) if key is not None else None
    return out, jit


@pytest.mark.parametrize("gate", ["gshard", "switch"])
def test_moe_gating_check_passes_and_fails_planted_faults(gate):
    (combine, dispatch, aux), jit = _gating(gate)
    rec = chip_smoke.moe_gating_check(combine, dispatch, aux, combine,
                                      dispatch, aux, jit, jit)
    assert rec["ok"] and rec["dispatch_mismatches"] == 0, rec
    # one kept choice moved to another slot of its expert
    t, e, c = (int(i[0]) for i in torch.nonzero(dispatch, as_tuple=True))
    moved_d, moved_c = dispatch.clone(), combine.clone()
    moved_d[t, e, c], moved_d[t, e, c + 1] = False, True
    moved_c[t, e, c + 1], moved_c[t, e, c] = combine[t, e, c], 0.0
    assert not chip_smoke.moe_gating_check(moved_c, moved_d, aux, combine,
                                           dispatch, aux)["ok"]
    # a gate off by 1e-5, the aux off by 1e-5
    assert not chip_smoke.moe_gating_check(combine + 1e-5 * dispatch,
                                           dispatch, aux, combine,
                                           dispatch, aux)["ok"]
    assert not chip_smoke.moe_gating_check(combine, dispatch, aux + 1e-5,
                                           combine, dispatch, aux)["ok"]
    if jit is not None:
        bad = jit.clone()
        bad[3, 5] = torch.nextafter(bad[3, 5], torch.tensor(2.0))
        rec = chip_smoke.moe_gating_check(combine, dispatch, aux, combine,
                                          dispatch, aux, bad, jit)
        assert not rec["ok"] and rec["jitter_mismatches"] == 1


def test_routes_record_and_replay_pin_the_experts():
    """``_Routes`` leaves the layer's output as it was when it records;
    replaying another run's choices routes as that run did (the same
    dispatch), and ``flips`` counts the tokens whose own choice
    differed."""
    from paddle_tpu_torch.incubate import moe
    layer = moe.MoELayer(16, 32, 4, tokens_per_group=32, seed=1,
                         device="cpu")
    rs = np.random.RandomState(6)
    x = torch.from_numpy(rs.randn(2, 40, 16).astype(np.float32))
    y = torch.from_numpy(rs.randn(2, 40, 16).astype(np.float32))
    with torch.no_grad():
        want = layer(x)[0]
        with chip_smoke._Routes(torch) as rx:
            got = layer(x)[0]
        with chip_smoke._Routes(torch) as ry:
            layer(y)
        with chip_smoke._Routes(torch, replay=rx) as same:
            layer(x)
        with chip_smoke._Routes(torch, replay=rx) as pinned:
            layer(y)
    assert torch.equal(got, want)
    assert len(rx.choices) == 1 and rx.choices[0].shape == (3, 32, 2)
    assert same.flips(1) == [0]
    assert all(torch.equal(a, b) for a, b in zip(pinned.kept, rx.kept))
    n_flip = int((ry.choices[0] != rx.choices[0]).any(-1).sum())
    assert pinned.flips(1) == [n_flip] and n_flip > 0


def test_moe_executed_flops_by_hand():
    """One MoE block and one dense block, 2 x 8 tokens in one group."""
    from paddle_tpu_torch.models import gpt
    cfg = gpt.gpt_tiny(n_layers=2, moe_experts=4, moe_every=2,
                       vocab_size=100)
    B, S, d, f, E = 2, 8, 64, 256, 4
    N, C = B * S, 10          # ceil(2 * 16 * 1.25 / 4)
    attn = 2 * 2 * B * S * (S + 1) // 2 * d
    proj = 2 * N * d * 3 * d + 2 * N * d * d
    dense_ffn = 2 * 2 * N * d * f
    disp = 2 * N * E * C * d
    moe_ffn = 2 * N * d * E + 2 * 2 * E * C * d * f + disp
    head = 2 * N * d * 100
    fwd = 2 * (proj + attn) + dense_ffn + moe_ffn + head
    assert chip_smoke.moe_executed_flops(cfg, B, S) == 3 * fwd + 2 * disp


# -- phase 22: the serving front end --------------------------------------

def _tiny_serving_model():
    from paddle_tpu_torch.models import gpt
    cfg = gpt.gpt_tiny(max_seq_len=2048, vocab_size=512, n_layers=2)
    model = gpt.GPT(cfg, seed=0, device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() >= 2:
                p.normal_(0, 0.3, generator=torch.Generator().manual_seed(1))
    return model


@pytest.fixture
def tiny_fe(monkeypatch):
    """A tiny model for phase 22's runs on the CPU (the phase's paged
    engine then runs the megakernel's plain versions); entry points
    default to the CPU and the card's synchronisation is a no-op."""
    from paddle_tpu_torch import device as device_lib
    resolve = device_lib.resolve
    monkeypatch.setattr(device_lib, "resolve",
                        lambda d=None: resolve("cpu" if d is None else d))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    torch.set_num_threads(1)
    return _tiny_serving_model()


def test_fe_trace_keeps_its_prompts_at_every_rate():
    slow = chip_smoke.fe_trace(50304, 1.0)
    fast = chip_smoke.fe_trace(50304, 1e9)
    assert len(slow) == chip_smoke.FE_REQUESTS
    assert [a.prompt for a in slow] == [a.prompt for a in fast]
    assert [a.max_new_tokens for a in slow] == [a.max_new_tokens
                                                for a in fast]
    assert fast[-1].t < 1e-6 < slow[-1].t
    lo, hi = chip_smoke.FE_PROMPT_LEN
    assert all(lo <= len(a.prompt) <= hi for a in slow)
    lo, hi = chip_smoke.FE_NEW_TOKENS
    assert all(lo <= a.max_new_tokens <= hi for a in slow)


def test_fe_expected_by_hand():
    names = ["flash_attention", "paged_append_attend",
             "paged_decode_attention", "mega_decode_layers",
             "mega_logits_sample", "decode_attention", "noop_copy"]
    run = {"steps": 336, "prefills": 10, "suffix": 1}
    exp = chip_smoke.fe_expected("paged", names, 24, run)
    assert exp == dict.fromkeys(names, 0) | {
        "flash_attention": 24 * 9, "paged_decode_attention": 24,
        "mega_decode_layers": 336, "mega_logits_sample": 336}
    exp = chip_smoke.fe_expected("contiguous", names, 24, run)
    assert exp == dict.fromkeys(names, 0) | {"decode_attention": 24 * 336}


def test_rung_accounting_of_a_tiny_run(tiny_fe):
    """The phase's runs on the CPU: a direct run, a closed probe and a
    tick-free wall replay through the front end give equal streams, and
    ``rung_metrics`` counts them as the requests and stats say."""
    from paddle_tpu_torch.serving import loadgen
    arrivals = loadgen.poisson_trace(8, 1e9, seed=0, vocab=512,
                                     prompt_len=(16, 40), new_tokens=(4, 9))
    runs = {}
    for mode in ("direct", "closed", "wall"):
        eng = chip_smoke._fe_engine(tiny_fe, "paged")
        runs[mode] = chip_smoke._fe_run(torch, eng, arrivals, mode=mode)
    ref = runs["direct"]
    for mode in ("closed", "wall"):
        run = runs[mode]
        assert chip_smoke.streams_equal(run["reqs"], ref["reqs"]) == (
            True, None)
        assert chip_smoke.full_budgets(run["reqs"])
        assert run["prefills"] == 8 and run["suffix"] == 0
        m = chip_smoke.rung_metrics(run["reqs"], run["wall"], run["snap"],
                                    run["backfills"])
        good = sum(a.max_new_tokens for a in arrivals)
        assert (m["completed"], m["completed_share"], m["good_tokens"]) == (
            8, 1.0, good)
        assert m["goodput_tokens_per_s"] == good / run["wall"]
        ttfts = sorted(r.ttft_s for r in run["reqs"])
        assert m["ttft_p50_s"] == ttfts[3] and m["ttft_p99_s"] == ttfts[-1]
        assert m["tpot_p99_s"] == max(r.tpot_s for r in run["reqs"])
        assert 0 < m["occupancy_mean"] <= 1
        # 8 requests over 8 slots: no step is backlogged
        assert m["fed_occupancy_mean"] is None and m["backfills"] == 0


def test_streams_equal_finds_a_planted_difference():
    class R:
        def __init__(self, tokens):
            self.tokens = tokens

    ref = [R([1, 2, 3]), R([4, 5, 6, 7])]
    assert chip_smoke.streams_equal([R([1, 2, 3]), R([4, 5, 6, 7])],
                                    ref) == (True, None)
    assert chip_smoke.streams_equal([R([1, 2, 3]), R([4, 5, 9, 7])],
                                    ref) == (False, (1, 2))
    assert chip_smoke.streams_equal([R([1, 2, 3]), R([4, 5, 6])],
                                    ref) == (False, (1, 3))
    assert chip_smoke.streams_equal([R([1, 2, 3])], ref) == (False, (1, 0))


def test_rung_metrics_percentiles_and_rejections():
    class R:
        def __init__(self, status, n, ttft=None, tpot=None):
            self.status, self.tokens = status, [0] * n
            self.ttft_s, self.tpot_s = ttft, tpot

    reqs = ([R("done", 4, 0.01 * (i + 1), 0.001 * (i + 1))
             for i in range(100)]
            + [R("rejected-queue-full", 0), R("failed", 2, 0.5, 0.2)])
    snap = {"serve/batch_occupancy.count": 4,
            "serve/batch_occupancy.sum": 3.0}
    m = chip_smoke.rung_metrics(reqs, 2.0, snap, 7)
    assert m["completed"] == 100 and m["completed_share"] == 100 / 102
    assert m["good_tokens"] == 400 and m["goodput_tokens_per_s"] == 200
    assert m["ttft_p50_s"] == pytest.approx(0.5)
    assert m["ttft_p99_s"] == pytest.approx(0.99)
    assert m["tpot_p99_s"] == pytest.approx(0.099)
    assert m["occupancy_mean"] == 0.75 and m["fed_occupancy_mean"] is None
    assert m["backfills"] == 7


def test_burst_check_passes_and_fails_planted_faults():
    from paddle_tpu_torch.serving import FrontEnd

    class Eng:
        """Just enough of an engine for the front end's bookkeeping."""
        on_token = on_retire = bucket_policy = None
        buckets, S, chunk = [16, 32], 8, 1

        def check_request(self, n, m):
            pass

    fe = FrontEnd(Eng(), queue_depth=chip_smoke.FE_BURST_DEPTH,
                  admission="priority", dynamic_buckets=False)
    reqs = [fe.submit([1, 2], max_new_tokens=3,
                      priority=chip_smoke.burst_priority(i))
            for i in range(chip_smoke.FE_BURST)]
    depth, expired = chip_smoke.FE_BURST_DEPTH, chip_smoke.FE_BURST_EXPIRED
    admitted = [r for i, r in enumerate(reqs[:depth]) if i not in expired]
    for r in admitted:
        r.status, r._buf = "done", [7, 7, 7]
    for i in expired:
        reqs[i].status = "rejected-deadline"
    order = [r.id for r in sorted(admitted,
                                  key=lambda r: (-r.priority, r.seq))]
    assert order != [r.id for r in admitted]     # not arrival order
    rec = chip_smoke.burst_check(reqs, order, len(admitted))
    assert rec["ok"] and rec["queue_full"] == 4 and rec["deadline"] == 2
    # arrival order, a prefill of a rejected request, a short stream, an
    # expired request that reached the engine
    assert not chip_smoke.burst_check(reqs, [r.id for r in admitted],
                                      len(admitted))["ok"]
    assert not chip_smoke.burst_check(reqs, order, len(admitted) + 1)["ok"]
    admitted[0]._buf = [7]
    assert not chip_smoke.burst_check(reqs, order, len(admitted))["ok"]
    admitted[0]._buf = [7, 7, 7]
    reqs[expired[0]].engine_req = object()
    assert not chip_smoke.burst_check(reqs, order, len(admitted))["ok"]


# -- phases 23 and 24: the BERT/ERNIE batch, launches and step-1 checks --

@pytest.mark.parametrize("B, S, lengths, share, max_pred",
                         [(32, 512, (128, 512), 0.15, 80),
                          (6, 40, (8, 40), 0.5, 5)])
def test_bert_batch_rows_segments_and_masked_positions(B, S, lengths,
                                                       share, max_pred):
    d = chip_smoke.bert_batch(30528, B, S, lengths, share, max_pred,
                              tasks=3)
    lens = d["lengths"]
    assert lens[0] == lengths[0] and lens[-1] == S == lengths[1]
    assert (np.diff(lens) >= 0).all()
    valid = np.arange(S)[None, :] < lens[:, None]
    np.testing.assert_array_equal(d["mask"], valid)
    assert (d["tokens"][~valid] == 0).all() and (d["types"][~valid] == 0
                                                 ).all()
    # two segments: type 1 from the middle of the valid part on
    for r, n in enumerate(lens):
        assert d["types"][r, :n].tolist() == [0] * (n // 2) + [1] * (
            n - n // 2)
    masked = d["mlm_labels"] != -100
    assert not (masked & ~valid).any()
    want = np.minimum(np.round(share * lens).astype(int), max_pred)
    np.testing.assert_array_equal(masked.sum(1), want)
    assert (d["tokens"][masked] == chip_smoke.MASK_TOKEN).all()
    assert ((d["mlm_labels"][masked] > 0)
            & (d["mlm_labels"][masked] < 30528)).all()
    assert set(np.unique(d["nsp_labels"])) <= {0, 1}
    assert d["class_labels"].sum() == round(chip_smoke.CLASS1_SHARE * B)
    assert d["tasks"].max() < 3 and (d["tasks"][~valid] == 0).all()
    # a fixed batch: the same seed gives the same arrays
    again = chip_smoke.bert_batch(30528, B, S, lengths, share, max_pred,
                                  tasks=3)
    for k in d:
        np.testing.assert_array_equal(d[k], again[k])


def test_attention_expected_and_ln_exempt():
    names = ["flash_attention", "flash_attention_bwd_dkdv",
             "flash_attention_bwd_dq", "fused_layer_norm", "fused_ce_fwd"]
    exp = chip_smoke.attention_expected(names, 12)
    assert exp == {"flash_attention": 12, "flash_attention_bwd_dkdv": 12,
                   "flash_attention_bwd_dq": 12, "fused_layer_norm": 0,
                   "fused_ce_fwd": 0}
    for n in ("bert.emb_ln_scale", "bert.layers.item_3.ln1_bias",
              "bert._stacked_layers.ln2_scale", "mlm_ln_bias"):
        assert not chip_smoke.ln_exempt(n), n
    for n in ("bert.wte", "bert._stacked_layers.bqkv", "mlm_bias",
              "cls_b", "ernie.wtask", "bert.layers.item_0.wup"):
        assert chip_smoke.ln_exempt(n), n


def test_grad_rel_l2_reads_each_tensor():
    rs = np.random.RandomState(3)
    ref = {n: torch.from_numpy(rs.randn(*s).astype(np.float32))
           for n, s in (("a", (4, 8)), ("b", (8,)))}
    got = {n: t.to(torch.bfloat16) for n, t in ref.items()}
    err = chip_smoke.grad_rel_l2(got, ref)
    assert set(err) == {"a", "b"} and 0 < max(err.values()) < 2.0 ** -8
    got["b"] = got["b"] + 0.1 * ref["b"].abs().max()
    assert chip_smoke.grad_rel_l2(got, ref)["b"] > 2.5e-2
    assert chip_smoke.encoder_step_check(
        1.0, 1.0, chip_smoke.grad_rel_l2(got, ref))["ok"] is False


def test_plain_sdpa_takes_the_padding_bias_and_kv_lens():
    """``plain_sdpa`` (phase 23/24's plain attention) equals the CPU
    reference with the same bias, for a prefix row (kv_lens cuts the
    keys) and a row with a hole (kv_lens keeps S, the bias masks)."""
    from paddle_tpu_torch.models.bert import padding_bias
    from paddle_tpu_torch.nn.functional.attention import attention_reference
    rs = np.random.RandomState(4)
    q, k, v = (torch.from_numpy(rs.randn(2, 20, 2, 16).astype(np.float32))
               for _ in range(3))
    mask = torch.ones(2, 20, dtype=torch.int32)
    mask[0, 12:] = 0
    mask[1, 5:9] = 0
    bias, kv_lens = padding_bias(mask)
    assert kv_lens.tolist() == [12, 20]
    got = chip_smoke.plain_sdpa(q, k, v, attn_mask=bias, kv_lens=kv_lens,
                                is_causal=False, dropout_p=0.0)
    want = attention_reference(q, k, v, mask=bias)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    # a planted fault: a hole row that declared its valid count as its
    # length would drop the keys after the hole
    wrong = chip_smoke.plain_sdpa(q, k, v, attn_mask=bias,
                                  kv_lens=torch.tensor([12, 16],
                                                       dtype=torch.int32))
    assert not torch.allclose(wrong[1], want[1], atol=1e-3)


@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_kv_wire_check_passes_the_codec_and_fails_a_planted_fault(wire):
    """Phase 26's lossy-wire check: bf16 pages through the port's codec
    pass; one element pushed by a full block step fails."""
    from paddle_tpu_torch.serving import kv_transfer as kt
    rs = np.random.RandomState(2)
    k = torch.from_numpy(rs.randn(2, 2, 4, 128, 16).astype(np.float32) * 3)
    k = k.to(torch.bfloat16)
    n = 200
    h, blob = kt.encode_kv_pages(k, k, n, wire=wire, block=256)
    got, _ = kt.decode_kv_pages(h, blob)
    rows = chip_smoke.kv_rows(got, n)
    worst, ok = chip_smoke.kv_wire_check(torch, rows, k, n, wire, 256)
    assert ok and 0.0 < worst <= 1.0
    bad = rows.clone()
    scale = float(k.float().reshape(-1)[:256].abs().max()) / (
        127.0 if wire == "int8" else 448.0)
    bad[0, 0, 0, 0] += 64 * scale
    assert not chip_smoke.kv_wire_check(torch, bad, k, n, wire, 256)[1]


def test_kv_bits_equal_and_rows():
    k = torch.randn(2, 3, 4, 128, 8).to(torch.bfloat16)
    rows = chip_smoke.kv_rows(k, 300)
    assert tuple(rows.shape) == (2, 4, 300, 8) and rows.is_contiguous()
    assert torch.equal(rows[:, :, 130], k[:, 1, :, 2])
    assert chip_smoke.kv_bits_equal(torch, (rows, rows), (rows.clone(),
                                                          rows.clone()))
    flipped = rows.clone()
    flipped.view(torch.int16)[1, 3, 299, 7] ^= 1
    assert not chip_smoke.kv_bits_equal(torch, (rows, flipped),
                                        (rows, rows))
    assert not chip_smoke.kv_bits_equal(torch, (rows[:, :, :299],),
                                        (rows,))


def _fleet_case():
    """A clean phase 27 part: three ids, each returned once, done, with
    its reference stream; every path kernel launched; two replicas whose
    checksums equal the main process's."""
    ids = ["rq-000001", "rq-000002", "rq-000003"]
    ref = {q: [i, i + 1, i + 2] for i, q in enumerate(ids)}
    picked = [(q, {"id": q, "status": "done", "tokens": list(ref[q]),
                   "replica": "sym1"}) for q in ids]
    launches = {n: 24 for n in chip_smoke.FLEET_PATH_KERNELS.values()}
    main_sum = {"wte": 1.5, "stacked.wqkv": -0.25}
    sums = {"sym0": dict(main_sum), "sym1": dict(main_sum)}
    return ids, picked, ref, launches, sums, main_sum


def test_fleet_check_passes_and_fails_planted_faults():
    """Phase 27's check: the clean case passes; a lost id, a duplicated
    result, a differing stream, a result not done, a foreign id, a
    missing path kernel and a replica's differing weights each fail,
    named."""
    ids, picked, ref, launches, sums, main_sum = _fleet_case()
    assert chip_smoke.fleet_check(ids, picked, ref, launches, sums,
                                  main_sum) == []
    cases = {
        "lost": (picked[:2], launches, sums),
        "returned twice": (picked + [picked[1]], launches, sums),
        "stream differs": (picked[:2] + [(ids[2], dict(
            picked[2][1], tokens=[2, 3, 5]))], launches, sums),
        "not done": (picked[:2] + [(ids[2], dict(
            picked[2][1], status="failed"))], launches, sums),
        "foreign": (picked + [("rq-999999", picked[0][1])], launches,
                    sums),
        "kernel not launched": (picked, dict(
            launches, paged_decode_attention=0), sums),
        "weights differ": (picked, launches, dict(
            sums, sym1={"wte": 1.5, "stacked.wqkv": -0.2500001})),
    }
    for what, (got, lau, sm) in cases.items():
        fails = chip_smoke.fleet_check(ids, got, ref, lau, sm, main_sum)
        assert len(fails) == 1 and fails[0].startswith(what), (what, fails)
    # the parts check no kernels themselves: the phase's record does
    assert chip_smoke.fleet_check(ids, picked, ref, {}, sums, main_sum,
                                  kernels={}) == []


def test_weight_checksum_is_per_parameter_fp64():
    from paddle_tpu_torch.models import gpt
    cfg = gpt.gpt_tiny(dtype=torch.bfloat16)
    a = gpt.GPT(cfg, seed=0, device="cpu")
    b = gpt.GPT(cfg, seed=0, device="cpu")
    sa = chip_smoke.weight_checksum(a)
    assert sa == chip_smoke.weight_checksum(b)
    assert sorted(sa) == sorted(n for n, _ in a.named_parameters())
    name, p = next(iter(b.named_parameters()))
    with torch.no_grad():
        p.view(-1)[0] = p.view(-1)[0] + 1.0
    sb = chip_smoke.weight_checksum(b)
    assert [n for n in sa if sa[n] != sb[n]] == [name]
