"""The port's decode megakernel (K8) and sampling epilogue (K9), plain
versions, against the JAX package's Pallas kernels in interpret mode on
the CPU, at small sizes (2 layers, d_model 32), inputs from a numpy
seed, fp32.

The JAX megakernel names ``pltpu.TPUMemorySpace.ANY``; jax 0.9.0
renamed that enum ``MemorySpace``. The JAX package is the reference and
is not edited, so each test that runs ``mega_decode_layers`` aliases the
old name through ``monkeypatch`` for its own length only: no conftest
and no other test sees the alias. ``mega_logits_sample`` needs none."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from paddle_tpu.ops.pallas import decode_megakernel as jax_mega
from paddle_tpu_torch.models.gpt import GPTBlock, GPTConfig
from paddle_tpu_torch.ops.decode_megakernel import (
    _WEIGHT_ORDER, logits_plan, logits_route, logits_tile_range,
    mega_decode_layers, mega_decode_layers_reference, mega_logits_sample)
from paddle_tpu_torch.ops.paged_attention import paged_append_attend
from torch_reference_compile import fast_reference_compiles  # noqa: F401

# fp32 everywhere: the two packages sum the same products in another
# order
ATOL = RTOL = 1e-5
PAGE = 128
L, P, MX = 2, 12, 3          # layers, pages per layer, pages per slot
# (slot, position, write): positions across page boundaries, an inactive
# row (slot 3), and two rows of slot 2 at consecutive positions, so the
# second attends over the first's fresh row
ROWS = [(0, 0, 1), (1, 127, 1), (2, 128, 1), (3, 130, 0), (2, 129, 1)]


@pytest.fixture
def tpu_memory_space_alias(monkeypatch):
    monkeypatch.setattr(pltpu, "TPUMemorySpace", pltpu.MemorySpace,
                        raising=False)


def _weights(rs, dm, hq, hkv, d, bias):
    nq, f = (hq + 2 * hkv) * d, 4 * dm
    shapes = {"ln1_scale": (L, dm), "ln1_bias": (L, dm),
              "wqkv": (L, dm, nq), "bqkv": (L, nq), "wo": (L, hq * d, dm),
              "bo": (L, dm), "ln2_scale": (L, dm), "ln2_bias": (L, dm),
              "wup": (L, dm, f), "bup": (L, f), "wdown": (L, f, dm),
              "bdown": (L, dm)}
    out = {}
    for n in _WEIGHT_ORDER:
        if n.startswith("b") and not bias:
            continue
        noise = rs.randn(*shapes[n]).astype(np.float32)
        if n.endswith("scale"):
            out[n] = 1.0 + 0.1 * noise
        elif n.startswith("w"):
            out[n] = noise / np.float32(np.sqrt(shapes[n][1]))
        else:
            out[n] = 0.1 * noise
    return out


def _inputs(hq, hkv, d, bias, seed=0):
    rs = np.random.RandomState(seed)
    dm = hq * d
    w = _weights(rs, dm, hq, hkv, d, bias)
    x = rs.randn(len(ROWS), dm).astype(np.float32)
    shape = (L * P + 1, hkv, PAGE, d)
    kp = (0.5 * rs.randn(*shape)).astype(np.float32)
    vp = (0.5 * rs.randn(*shape)).astype(np.float32)
    table = np.stack([np.arange(s * MX, (s + 1) * MX) for s in range(4)]
                     ).astype(np.int32)
    rows = np.asarray(ROWS, np.int32)
    return w, x, kp, vp, table, rows[:, 1], rows[:, 0], rows[:, 2]


def _run_port(w, x, kp, vp, table, pos, slot, write, **geo):
    t = torch.from_numpy
    kpt, vpt = t(kp.copy()), t(vp.copy())
    out = mega_decode_layers(
        t(x), {n: t(a) for n, a in w.items()}, kpt, vpt, t(table),
        t(pos), t(slot), t(write), page=PAGE, n_pages=P, **geo)
    return out.numpy(), kpt.numpy(), vpt.numpy()


@pytest.mark.parametrize("hq, hkv, rope, bias", [
    (4, 4, False, True),       # MHA, learned positions (gpt3-shaped)
    (4, 2, True, False),       # GQA + rope, no biases (llama-shaped)
    (4, 2, True, True),
    (4, 4, False, False),
])
def test_plain_k8_matches_jax_megakernel(tpu_memory_space_alias, hq, hkv,
                                         rope, bias):
    d = 8
    w, x, kp, vp, table, pos, slot, write = _inputs(hq, hkv, d, bias)
    geo = dict(n_heads=hq, kv_heads=hkv, head_dim=d, rope=rope,
               rope_theta=10000.0)
    want_x, want_kp, want_vp = jax_mega.mega_decode_layers(
        jnp.asarray(x), {n: jnp.asarray(a) for n, a in w.items()},
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(pos), jnp.asarray(slot), jnp.asarray(write),
        page=PAGE, n_pages=P, **geo)
    got_x, got_kp, got_vp = _run_port(w, x, kp, vp, table, pos, slot,
                                      write, **geo)
    np.testing.assert_allclose(got_x, np.asarray(want_x), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(got_kp, np.asarray(want_kp), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(got_vp, np.asarray(want_vp), atol=ATOL,
                               rtol=RTOL)
    # the fresh rows did land: every written (page, offset) moved
    for layer in range(L):
        for s, p, wr in ROWS:
            if wr:
                g = layer * P + table[s, p // PAGE]
                assert not np.array_equal(got_kp[g, :, p % PAGE],
                                          kp[g, :, p % PAGE])


def test_inactive_row_moves_only_the_scratch_page():
    w, x, kp, vp, table, pos, slot, write = _inputs(4, 2, 8, True)
    _, got_kp, got_vp = _run_port(w, x, kp, vp, table, pos, slot, write,
                                  n_heads=4, kv_heads=2, head_dim=8,
                                  rope=True)
    (idle,) = [s for s, _, wr in ROWS if not wr]
    for layer in range(L):
        pages = layer * P + table[idle]
        assert np.array_equal(got_kp[pages], kp[pages])
        assert np.array_equal(got_vp[pages], vp[pages])
    # the inactive row's write went to the scratch page, row L * P
    assert not np.array_equal(got_kp[L * P], kp[L * P])
    # nothing but the written rows and the scratch page changed
    touched = np.zeros(kp.shape[:3], bool)
    touched[L * P] = True
    for layer in range(L):
        for s, p, wr in ROWS:
            if wr:
                touched[layer * P + table[s, p // PAGE], :, p % PAGE] = True
    assert np.array_equal(got_kp[~touched], kp[~touched])
    assert np.array_equal(got_vp[~touched], vp[~touched])


def test_plain_k8_one_layer_equals_per_layer_step():
    """One layer of the plain K8, one row per slot, equals one layer of
    the engine's per-layer path (``_qkv``, K2's plain version with the
    inactive slot writing the scratch page, ``_block_tail``), pools
    included (the active rows' outputs)."""
    hq, hkv, d = 4, 2, 8
    rs = np.random.RandomState(5)
    w = {n: torch.from_numpy(a[:1]) for n, a in
         _weights(rs, hq * d, hq, hkv, d, True).items()}
    S = 4
    x = torch.from_numpy(rs.randn(S, hq * d).astype(np.float32))
    shape = (P + 1, hkv, PAGE, d)
    kp = torch.from_numpy((0.5 * rs.randn(*shape)).astype(np.float32))
    vp = torch.from_numpy((0.5 * rs.randn(*shape)).astype(np.float32))
    table = torch.arange(S * MX, dtype=torch.int32).reshape(S, MX) % P
    lengths = torch.tensor([3, 127, 128, 200], dtype=torch.int32)
    active = torch.tensor([True, True, False, True])
    geo = dict(page=PAGE, n_pages=P, n_heads=hq, kv_heads=hkv,
               head_dim=d, rope=True)

    kp1, vp1 = kp.clone(), vp.clone()
    got = mega_decode_layers_reference(
        x, w, kp1, vp1, table, lengths, torch.arange(S, dtype=torch.int32),
        active.to(torch.int32), **geo)

    blk = GPTBlock(GPTConfig(d_model=hq * d, n_layers=1, n_heads=hq,
                             n_kv_heads=hkv, rope=True,
                             dtype=torch.float32))
    layer = {n: t[0] for n, t in w.items()}
    kp2, vp2 = kp.clone(), vp.clone()
    q, k, v = blk._qkv(x[:, None], lengths, layer)
    base = table.gather(1, (lengths // PAGE)[:, None].long())[:, 0]
    wpids = torch.where(active, base, P).to(torch.int32)
    o, _, _ = paged_append_attend(q[:, 0], kp2, vp2, k[:, 0], v[:, 0],
                                  table, wpids, lengths)
    want = blk._block_tail(x[:, None], o.reshape(S, 1, -1), layer)[:, 0]
    # an inactive row's output is discarded by the engine and differs by
    # design: K2 folds its fresh row in from registers, K8 reads the pool
    # at its position, where that row was not written (as in JAX)
    torch.testing.assert_close(got[active], want[active], atol=ATOL,
                               rtol=RTOL)
    torch.testing.assert_close(kp1[:P], kp2[:P], atol=0, rtol=0)
    torch.testing.assert_close(vp1[:P], vp2[:P], atol=0, rtol=0)


def _logits_inputs(seed=3, B=6, dm=32, V=300):
    """A vocabulary that is not a multiple of the JAX tile (128 below),
    a tie across tiles (columns 17 and 270, row 0), one inside a tile
    (columns 140 and 141, row 1), an inf in one row's logits (row 3, at
    column 299 of the last, ragged tile) and a poisoned row (2)."""
    rs = np.random.RandomState(seed)
    x = rs.randn(B, dm).astype(np.float32)
    s = (1.0 + 0.1 * rs.randn(dm)).astype(np.float32)
    b = (0.1 * rs.randn(dm)).astype(np.float32)
    w = (rs.randn(dm, V) / np.sqrt(dm)).astype(np.float32)
    # column 299: zero but at depth 0, where row 3's normed value is
    # large and positive and every other row's near -3: row 3's logit
    # alone overflows, the others' are finite and far below their max
    x[:, 0] = -3.0
    x[3, 0] = 40.0
    w[:, 299] = 0.0
    w[0, 299] = 1e38
    h = torch.nn.functional.layer_norm(
        torch.from_numpy(x), (dm,), eps=1e-5).numpy() * s + b
    for r, cols in ((0, (17, 270)), (1, (140, 141))):
        for c in cols:
            w[:, c] = 3.0 * h[r] / np.linalg.norm(h[r])
            w[0, c] = 0.0
    poison = np.zeros(B, np.int32)
    poison[2] = 1
    return x, s, b, w, poison


def test_plain_k9_matches_jax_epilogue():
    x, s, b, w, poison = _logits_inputs()
    want_tok, want_nf = jax_mega.mega_logits_sample(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), jnp.asarray(w),
        jnp.asarray(poison), vb=128)
    want_tok, want_nf = np.asarray(want_tok), np.asarray(want_nf)
    t = torch.from_numpy
    tok, nf = mega_logits_sample(t(x), t(s), t(b), t(w), t(poison))
    tok, nf = tok.numpy(), nf.numpy()
    assert tok.dtype == nf.dtype == np.int32
    np.testing.assert_array_equal(nf, want_nf)
    assert nf.tolist() == [0, 0, 1, 1, 0, 0]
    ok = nf == 0
    np.testing.assert_array_equal(tok[ok], want_tok[ok])
    # the first of equal maxima, across tiles and inside one
    assert tok[0] == 17 and tok[1] == 140
    # without poison the poisoned row is finite again
    _, nf2 = mega_logits_sample(t(x), t(s), t(b), t(w))
    assert nf2.tolist() == [0, 0, 0, 1, 0, 0]


@pytest.mark.parametrize("dtype, dm, vocab, kmajor, aligned, route", [
    (torch.bfloat16, 2048, 50304, True, True, "tensor_cores"),
    (torch.bfloat16, 2048, 50304, False, True, "tensor_cores"),
    (torch.bfloat16, 2048, 50301, True, True, "tensor_cores"),
    (torch.bfloat16, 2048, 50301, False, True, "cuda_cores"),
    (torch.bfloat16, 36, 4096, True, True, "cuda_cores"),
    (torch.bfloat16, 2048, 50304, True, False, "cuda_cores"),
    (torch.float32, 2048, 50304, True, True, "cuda_cores")])
def test_k9_route_by_dtype_and_layout(dtype, dm, vocab, kmajor, aligned,
                                      route):
    """K9's kernel is chosen before the launch: bf16 heads whose rows are
    whole 16-byte pieces take the TMA + wgmma kernel, the rest the
    CUDA-core one."""
    assert logits_route(dtype, dm, vocab, kmajor, aligned) == route


@pytest.mark.parametrize("rows, dm, plan", [
    (1, 2048, (1, 8, 16)), (8, 2048, (8, 8, 16)), (13, 2048, (13, 16, 16)),
    (32, 2048, (32, 32, 12)), (64, 2048, (32, 32, 12)),
    (64, 1024, (64, 64, 12)), (64, 8192, (8, 8, 12))])
def test_k9_row_groups_fill_shared_memory(rows, dm, plan):
    """A row group holds as many rows as fit beside a ring of 8 head
    boxes (d_model 2048: 32 rows, 128 KB), at the narrowest wgmma width
    that holds it; the ring takes the rest, at most 16 boxes; one block
    per SM at gpt3_1p3b's vocabulary."""
    group, n, stages, grid = logits_plan(rows, dm, 50304, 132)
    assert (group, n, stages, grid) == plan + (132,)
    assert -(-rows // group) == (2 if (rows, dm) == (64, 2048) else
                                 8 if dm == 8192 else 1)
    assert logits_plan(rows, dm, 100, 132)[3] == 2
    with pytest.raises(ValueError, match="no room"):
        logits_plan(rows, 16384, 50304, 132)


@pytest.mark.parametrize("vocab, grid", [(50304, 132), (4096, 64),
                                         (100, 2), (50304, 1)])
def test_k9_tile_ranges_cover_the_vocabulary_once(vocab, grid):
    """The blocks' contiguous ranges of 64-column tiles partition the
    vocabulary, each within one tile of the others' length."""
    ranges = [logits_tile_range(i, vocab, grid) for i in range(grid)]
    tiles = -(-vocab // 64)
    assert ranges[0][0] == 0 and ranges[-1][1] == tiles
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    sizes = {e - s for s, e in ranges}
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1


def test_wrappers_check_shapes():
    w, x, kp, vp, table, pos, slot, write = _inputs(4, 4, 8, True)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="layer-folded pool"):
        mega_decode_layers(t(x), {n: t(a) for n, a in w.items()},
                           t(kp[:-1]), t(vp[:-1]), t(table), t(pos),
                           t(slot), t(write), page=PAGE, n_pages=P,
                           n_heads=4, kv_heads=4, head_dim=8)
    with pytest.raises(ValueError, match="GQA"):
        mega_decode_layers(t(x), {n: t(a) for n, a in w.items()}, t(kp),
                           t(vp), t(table), t(pos), t(slot), t(write),
                           page=PAGE, n_pages=P, n_heads=4, kv_heads=3,
                           head_dim=8)
    with pytest.raises(ValueError, match="need x"):
        mega_logits_sample(t(x), t(w["ln1_scale"][0]), t(w["ln1_bias"][0]),
                           t(w["wqkv"][0].T))
