"""Port kernels K2 (fused paged append+attend) and K2' (plain paged
decode attention): their plain PyTorch versions against the JAX
package's Pallas paged kernel run in interpret mode, in fp32 on the CPU
— outputs, (m, l) stats, and the pool rows the fused mode writes. The
CUDA kernel itself is held against the same plain versions on the GPU
(tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.paged_attention import (
    paged_append_attend as jax_append_attend,
    paged_decode_attention as jax_decode_attention)
from paddle_tpu_torch.ops.paged_attention import (
    PageAllocator, cluster_size, paged_append_attend,
    paged_append_attend_reference, paged_decode_attention,
    paged_decode_attention_reference, ring_stages)

# fp32 on both sides; only the summation order differs (per-page online
# softmax vs one dense softmax)
ATOL = RTOL = 2e-5
PAGE = 128
# lengths at and around page boundaries, including an empty row
LENGTHS = [0, 1, 127, 128, 129, 255, 256]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(seed, hq, hkv, d=32, lengths=LENGTHS, max_pages=3):
    rs = np.random.RandomState(seed)
    b = len(lengths)
    n_pages = b * max_pages + 1          # + one scratch page (the last)
    q = rs.randn(b, hq, d).astype(np.float32)
    kp = rs.randn(n_pages, hkv, PAGE, d).astype(np.float32)
    vp = rs.randn(n_pages, hkv, PAGE, d).astype(np.float32)
    table = rs.permutation(b * max_pages).reshape(b, max_pages)
    lens = np.asarray(lengths, np.int32)
    return q, kp, vp, table.astype(np.int32), lens


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("hq, hkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("stats", [False, True])
def test_plain_matches_jax_kernel(hq, hkv, stats):
    q, kp, vp, table, lens = _inputs(hq * 10 + hkv, hq, hkv)
    want = jax_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(lens), return_stats=stats,
        interpret=True)
    got = paged_decode_attention(*_t(q, kp, vp, table, lens),
                                 return_stats=stats)
    if not stats:
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        w = np.asarray(w)
        g = g.numpy()
        # m of an empty row is -inf on both sides
        np.testing.assert_array_equal(np.isinf(w), np.isinf(g))
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("K", [2, 4, 8])
@pytest.mark.parametrize("hq, hkv", [(4, 4), (4, 2)])
def test_plain_matches_jax_kernel_at_the_verify_shape(hq, hkv, K):
    """K2' as the per-layer speculative verify launches it: S·K query
    rows, slot s's table row repeated K times, row j of slot s over
    lengths[s] + j + 1 keys (one slot's rows cross a page boundary)."""
    slot_lens = [0, 5, 126, 250 - K]
    q, kp, vp, table, _ = _inputs(100 + K, hq, hkv, lengths=slot_lens)
    S = len(slot_lens)
    rs = np.random.RandomState(K)
    q = rs.randn(S * K, hq, q.shape[-1]).astype(np.float32)
    rows = np.repeat(table, K, axis=0)
    lens = (np.repeat(slot_lens, K) + np.tile(np.arange(K), S)
            + 1).astype(np.int32)
    want = np.asarray(jax_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(rows), jnp.asarray(lens), interpret=True))
    got = paged_decode_attention(*_t(q, kp, vp, rows, lens))
    assert got.shape == (S * K, hq, q.shape[-1])
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("hq, hkv", [(4, 4), (4, 2)])
def test_fused_matches_jax_kernel_and_writes_the_same_rows(hq, hkv):
    q, kp, vp, table, lens = _inputs(hq + 100 * hkv, hq, hkv)
    b, _, d = q.shape
    rs = np.random.RandomState(5)
    k_row = rs.randn(b, hkv, d).astype(np.float32)
    v_row = rs.randn(b, hkv, d).astype(np.float32)
    scratch = kp.shape[0] - 1
    pidx = np.minimum(lens // PAGE, table.shape[1] - 1)
    wpids = table[np.arange(b), pidx].astype(np.int32)
    # rows 1 and 5 are "inactive": they write the scratch page (at
    # distinct offsets, so the written pools are deterministic)
    wpids[[1, 5]] = scratch
    o_w, kp_w, vp_w = jax_append_attend(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(k_row), jnp.asarray(v_row), jnp.asarray(table),
        jnp.asarray(wpids), jnp.asarray(lens), interpret=True)
    kp0 = kp.copy()
    tkp, tvp = _t(kp, vp)                 # shares memory with kp, vp
    o, kp_g, vp_g = paged_append_attend(
        *_t(q), tkp, tvp, *_t(k_row, v_row, table, wpids, lens))
    assert kp_g is tkp and vp_g is tvp          # in place, like the alias
    np.testing.assert_allclose(o.numpy(), np.asarray(o_w), atol=ATOL,
                               rtol=RTOL)
    # every page but the scratch one is bit-identical (on the TPU each
    # program writes its whole page back, so of several scratch writers
    # only the last row survives; here every row lands — nobody reads
    # the scratch page either way)
    np.testing.assert_array_equal(kp_g.numpy()[:-1], np.asarray(kp_w)[:-1])
    np.testing.assert_array_equal(vp_g.numpy()[:-1], np.asarray(vp_w)[:-1])
    # exactly one row per (row, kv head) changed
    changed = np.argwhere((kp_g.numpy() != kp0).any(-1))
    want = {(int(wpids[i]), h, int(lens[i] % PAGE))
            for i in range(b) for h in range(hkv)}
    assert {tuple(c) for c in changed} == want
    np.testing.assert_array_equal(
        kp_g.numpy()[wpids[[1, 5]], :, lens[[1, 5]] % PAGE], k_row[[1, 5]])


def test_fused_equals_plain_over_the_extended_prefix():
    """Append+attend at length n == plain attention over n+1 rows once
    the fresh row sits in its page."""
    q, kp, vp, table, lens = _inputs(11, 4, 2)
    b, _, d = q.shape
    rs = np.random.RandomState(12)
    k_row = rs.randn(b, 2, d).astype(np.float32)
    v_row = rs.randn(b, 2, d).astype(np.float32)
    wpids = table[np.arange(b), lens // PAGE].astype(np.int32)
    tq, tkp, tvp, ttab, tlens = _t(q, kp, vp, table, lens)
    o, _, _ = paged_append_attend_reference(
        tq, tkp, tvp, *_t(k_row, v_row), ttab, torch.from_numpy(wpids),
        tlens)
    o_plain = paged_decode_attention_reference(tq, tkp, tvp, ttab,
                                               tlens + 1)
    np.testing.assert_allclose(o.numpy(), o_plain.numpy(), atol=ATOL,
                               rtol=RTOL)


def test_cpu_tensors_count_no_launch():
    q, kp, vp, table, lens = _t(*_inputs(2, 4, 4))
    before = (paged_decode_attention.launches,
              paged_append_attend.launches)
    paged_decode_attention(q, kp, vp, table, lens)
    rows = torch.zeros(q.shape[0], 4, q.shape[2])
    paged_append_attend(q, kp, vp, rows, rows, table,
                        torch.zeros_like(lens), lens)
    assert (paged_decode_attention.launches,
            paged_append_attend.launches) == before


def test_operand_shape_errors():
    q, kp, vp, table, lens = _t(*_inputs(3, 4, 2))
    with pytest.raises(ValueError, match="lengths"):
        paged_decode_attention(q, kp, vp, table, lens[:-1])
    with pytest.raises(ValueError, match="GQA"):
        paged_decode_attention(q[:, :3].contiguous(), kp, vp, table, lens)
    with pytest.raises(ValueError, match="k_row"):
        paged_append_attend(q, kp, vp, q, q, table, lens, lens)


@pytest.mark.parametrize("max_pages, page, pairs, splits", [
    (1, 16, 128, 1), (1, 128, 128, 2), (2, 128, 128, 4),
    (16, 128, 128, 4), (8, 256, 128, 4), (16, 128, 32, 8),
    (2, 128, 32, 4), (2, 128, 1024, 1), (16, 128, 1024, 1),
    (64, 128, 8, 8), (16, 128, 264, 2)])
def test_cluster_size_follows_the_static_shapes(max_pages, page, pairs,
                                                splits):
    """K2's cluster on 132 SMs: the largest power of two up to 8 that
    leaves a block 64 of the table's T = max_pages * page rows and keeps
    the grid within 4 blocks an SM (the per-layer engine's 8 rows x 16
    kv heads: 4; the suffix prefill's 64 x 16: 1), from static shapes,
    never the lengths."""
    assert cluster_size(max_pages, page, pairs, 132) == splits


@pytest.mark.parametrize("max_pages, page, splits, stages", [
    (1, 16, 1, 1), (1, 32, 1, 2), (1, 48, 1, 3), (2, 128, 2, 4),
    (16, 128, 8, 4), (3, 128, 2, 4)])
def test_ring_stages_hold_the_longest_share(max_pages, page, splits,
                                            stages):
    """K2's ring: as many 16-row slots as the longest share of tiles a
    block can get, at most 4."""
    assert ring_stages(max_pages, page, splits) == stages


def test_page_allocator_lifecycle():
    alloc = PageAllocator(8, PAGE, max_pages_per_seq=3)
    a, b = [], []
    alloc.reserve(a, 1)
    alloc.reserve(b, PAGE + 1)
    assert (a, b, alloc.free_pages) == ([0], [1, 2], 5)
    alloc.reserve(a, PAGE)                 # still one page
    assert a == [0]
    with pytest.raises(MemoryError, match="max_pages_per_seq"):
        alloc.reserve(b, 4 * PAGE)
    assert b == [1, 2, 3]                  # grown up to the cap
    alloc.release(b)
    assert b == [] and alloc.free_pages == 7
    c = []
    alloc.reserve(c, 3 * PAGE)
    assert c == [1, 2, 3]                  # LIFO reuse of released pages
    small = PageAllocator(2, PAGE)
    with pytest.raises(MemoryError, match="exhausted"):
        small.reserve([], 3 * PAGE)
