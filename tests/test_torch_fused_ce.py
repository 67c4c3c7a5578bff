"""Port kernels K5/K6/K7 (fused softmax cross-entropy): the plain
versions ``fused_ce_reference`` and ``fused_ce_bwd_reference``, which CPU
tensors take through the differentiable ``fused_softmax_cross_entropy``,
against the JAX package's ``fused_softmax_cross_entropy`` (Pallas,
interpret mode on the CPU) and its ``jax.grad``, in fp32; the backward's
vocab chunk plan (``plan_chunks``) and its three passes composed chunk by
chunk (``fused_ce_bwd`` on CPU tensors) against both. The CUDA kernels
are held against the same plain versions on the GPU
(tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.fused_ce import _pick_block_v
from paddle_tpu.ops.pallas.fused_ce import (
    fused_softmax_cross_entropy as jax_fused_ce)
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.ops import fused_ce as ce
from paddle_tpu_torch.ops import launch_counters
from paddle_tpu_torch.ops.fused_ce import (
    CHUNK, fused_ce_bwd, fused_ce_bwd_reference, fused_ce_plain,
    fused_ce_reference, fused_softmax_cross_entropy, plan_chunks)
from torch_reference_compile import fast_reference_compiles  # noqa: F401

# fp32 on both sides; the logsumexp runs online over 128-512-wide vocab
# blocks in JAX and in one pass here, and dx/dw sum over the vocab or
# the rows in another order
ATOL = RTOL = 2e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


CASES = {
    # name: (n, d, V, ignored-label stride); n ragged against JAX's
    # 128-row block and the kernels' 64-row tile
    "v512": (200, 32, 512, 5),
    "v1152_block_v384": (130, 64, 1152, 3),
    "v256_all_valid": (64, 16, 256, 0),
}


def _inputs(name):
    n, d, V, stride = CASES[name]
    rs = np.random.RandomState(sorted(CASES).index(name))
    x = rs.randn(n, d).astype(np.float32)
    w = (0.5 * rs.randn(V, d)).astype(np.float32)
    labels = rs.randint(0, V, size=n).astype(np.int32)
    if stride:
        labels[::stride] = -1
    g = rs.randn(n).astype(np.float32)
    return x, w, labels, g


def test_fused_loss_vocab_rule_matches_jax():
    """The GPT loss takes the fused CE for exactly the vocabularies whose
    JAX vocab tile rule finds a block (a 128-multiple divisor)."""
    for V in (50304, 1152, 512, 256, 128, 100, 32000, 50257):
        try:
            _pick_block_v(V, 512)
            want = True
        except ValueError:
            want = False
        assert gpt._use_fused_ce(gpt.gpt_tiny(vocab_size=V)) == want, V


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax(name):
    x, w, labels, _ = _inputs(name)
    want = np.asarray(jax.jit(lambda *a: jax_fused_ce(*a, interpret=True))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels)))
    got = fused_softmax_cross_entropy(torch.from_numpy(x),
                                      torch.from_numpy(w),
                                      torch.from_numpy(labels))
    assert got.dtype == torch.float32 and got.shape == (x.shape[0],)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    assert np.all(got.numpy()[labels < 0] == 0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_matches_jax_grad(name):
    x, w, labels, g = _inputs(name)

    def loss(x, w):
        per = jax_fused_ce(x, w, jnp.asarray(labels), interpret=True)
        return jnp.sum(per * jnp.asarray(g))

    want_dx, want_dw = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    per = fused_softmax_cross_entropy(xt, wt, torch.from_numpy(labels))
    dx, dw = torch.autograd.grad(per, (xt, wt), torch.from_numpy(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw), atol=ATOL,
                               rtol=RTOL)
    # ignored rows get exactly zero gradient
    assert np.all(dx.numpy()[labels < 0] == 0)


def test_plain_functions_agree_with_torch_cross_entropy():
    x, w, labels, g = _inputs("v512")
    xt, wt, lt = (torch.from_numpy(a) for a in (x, w, labels))
    loss, lse = fused_ce_reference(xt, wt, lt)
    logits = xt @ wt.t()
    want = torch.nn.functional.cross_entropy(
        logits, lt.long(), ignore_index=-1, reduction="none")
    torch.testing.assert_close(loss, want, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1))
    gt = torch.from_numpy(g)
    dx, dw = fused_ce_bwd_reference(xt, wt, lt, lse, gt)
    xg, wg = xt.clone().requires_grad_(), wt.clone().requires_grad_()
    ce = torch.nn.functional.cross_entropy(
        xg @ wg.t(), lt.long(), ignore_index=-1, reduction="none")
    want_dx, want_dw = torch.autograd.grad(ce, (xg, wg), gt)
    torch.testing.assert_close(dx, want_dx, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(dw, want_dw, atol=ATOL, rtol=RTOL)


def test_cpu_path_is_the_plain_path_and_counts_no_launch():
    x, w, labels, g = _inputs("v256_all_valid")
    fns = [fn for name, fn in launch_counters().items()
           if name.startswith("fused_ce_")]
    assert len(fns) == 4            # K5, the dl pass, K6, K7
    before = [f.launches for f in fns]
    out = []
    for fn in (fused_softmax_cross_entropy, fused_ce_plain):
        xt = torch.from_numpy(x).requires_grad_()
        wt = torch.from_numpy(w).requires_grad_()
        per = fn(xt, wt, torch.from_numpy(labels))
        out.append((per,) + torch.autograd.grad(per, (xt, wt),
                                                torch.from_numpy(g)))
    for a, b in zip(*out):
        assert torch.equal(a, b)
    xt, wt, lt = (torch.from_numpy(a) for a in (x, w, labels))
    _, lse = fused_ce_reference(xt, wt, lt)
    fused_ce_bwd(xt, wt, lt, lse, torch.from_numpy(g), chunk=64)
    assert [f.launches for f in fns] == before


@pytest.mark.parametrize("V", [1, 130, 512, 1152, 50304])
@pytest.mark.parametrize("width", [8, 64, 256, 2048, CHUNK])
def test_plan_chunks_covers_the_vocabulary(V, width):
    """[0, V) exactly, in order, no chunk empty, every chunk but the last
    ``width`` wide."""
    chunks = plan_chunks(V, width)
    assert chunks and chunks[0][0] == 0
    assert all(vc > 0 for _, vc in chunks)
    assert all(vc == width for _, vc in chunks[:-1])
    assert chunks[-1][1] <= width
    ends = [v0 + vc for v0, vc in chunks]
    assert [v0 for v0, _ in chunks[1:]] == ends[:-1]
    assert ends[-1] == V
    assert len(chunks) == -(-V // width)


@pytest.mark.parametrize("width", [0, -8, 12, 100])
def test_plan_chunks_rejects_bad_widths(width):
    with pytest.raises(ValueError, match="multiple of 8"):
        plan_chunks(512, width)


# K5's range planner (pure): (tiles, row tiles, blocks at once)
RANGE_CASES = [(197, 64, 132), (197, 2, 132), (393, 128, 396), (1, 1, 132),
               (4, 2, 132), (197, 133, 132), (1000, 7, 132), (50, 300, 132)]


def _range_bounds(tiles, nsplit, per):
    return [(i * per, min(tiles, (i + 1) * per)) for i in range(nsplit)]


@pytest.mark.parametrize("tiles, row_tiles, slots", RANGE_CASES)
def test_ce_ranges_cover_every_vocab_tile_once(tiles, row_tiles, slots):
    """Every vocab tile in exactly one range, in order, none empty, all
    but the last ``per`` tiles long; the same answer on every call."""
    nsplit, per = ce._ranges(tiles, row_tiles, slots)
    bounds = _range_bounds(tiles, nsplit, per)
    assert all(t1 > t0 for t0, t1 in bounds)
    assert all(t1 - t0 == per for t0, t1 in bounds[:-1])
    covered = [t for t0, t1 in bounds for t in range(t0, t1)]
    assert covered == list(range(tiles))
    assert ce._ranges.__wrapped__(tiles, row_tiles, slots) == (nsplit, per)


@pytest.mark.parametrize("tiles, row_tiles, slots", RANGE_CASES)
def test_ce_ranges_fill_whole_waves(tiles, row_tiles, slots):
    """The grid is at most one wave or a whole number of waves when such
    a cut exists (one range is the fallback when none does)."""
    nsplit, per = ce._ranges(tiles, row_tiles, slots)
    blocks = row_tiles * nsplit
    cuts = {-(-tiles // p) for p in range(1, tiles + 1)}
    whole = [n for n in cuts
             if row_tiles * n <= slots or row_tiles * n % slots == 0]
    if whole:
        assert blocks <= slots or blocks % slots == 0
    else:
        assert (nsplit, per) == (1, tiles)


def test_ce_plan_at_the_train_shape_is_whole_waves_of_the_h100():
    """N 8188, V 50,304 in bf16 on 132 SMs: 64 row tiles of 128 and 197
    vocab tiles of 256, cut into ranges whose grid fills whole waves."""
    nsplit, per = ce._plan(torch.bfloat16, 8188, 50304, 132)
    assert (nsplit, per) == ce._ranges(197, 64, 132)
    assert -(-197 // per) == nsplit and (nsplit - 1) * per < 197
    blocks = 64 * nsplit
    assert blocks <= 132 or blocks % 132 == 0


@pytest.mark.parametrize("n, V", [(8188, 50304), (129, 50304), (1, 130),
                                  (200, 1000)])
def test_ce_plan_takes_each_dtypes_tiles(n, V):
    """bf16 plans 128-row x 256-column tiles at one block an SM; fp32
    keeps the FP32-pipe kernel's 64 x 128 tiles at three an SM."""
    assert ce._plan(torch.bfloat16, n, V, 132) == ce._ranges(
        -(-V // 256), -(-n // 128), 132)
    assert ce._plan(torch.float32, n, V, 132) == ce._ranges(
        -(-V // 128), -(-n // 64), 396)


# chunk widths that leave a ragged last chunk: 512 = 7 x 72 + 8,
# 1152 = 5 x 200 + 152, 256 = 2 x 96 + 64
CHUNKED = {"v512": 72, "v1152_block_v384": 200, "v256_all_valid": 96}


@pytest.mark.parametrize("name", sorted(CASES))
def test_chunked_backward_matches_reference_and_jax_grad(name):
    """The three passes composed chunk by chunk (dl rounded to the dtype,
    dx summed in fp32 across the chunks, dw written per chunk): what
    ``fused_ce_bwd`` runs on CPU tensors, the kernels' chunk plan, held
    against ``fused_ce_bwd_reference`` and the JAX gradient."""
    x, w, labels, g = _inputs(name)
    g = np.where(labels >= 0, g, 0).astype(np.float32)  # the caller's g
    chunk = CHUNKED[name]
    assert plan_chunks(w.shape[0], chunk)[-1][1] < chunk

    def loss(x, w):
        per = jax_fused_ce(x, w, jnp.asarray(labels), interpret=True)
        return jnp.sum(per * jnp.asarray(g))

    want_dx, want_dw = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(w))
    xt, wt, lt, gt = (torch.from_numpy(a) for a in (x, w, labels, g))
    _, lse = fused_ce_reference(xt, wt, lt)
    dx, dw = fused_ce_bwd(xt, wt, lt, lse, gt, chunk=chunk)
    ref_dx, ref_dw = fused_ce_bwd_reference(xt, wt, lt, lse, gt)
    assert dx.dtype == dw.dtype == torch.float32
    torch.testing.assert_close(dx, ref_dx, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(dw, ref_dw, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw), atol=ATOL,
                               rtol=RTOL)
    assert np.all(dx.numpy()[labels < 0] == 0)


def test_chunked_backward_rounds_dl_to_bf16():
    """In bf16, each chunk's dl is rounded before its products, as
    ``fused_ce_bwd_reference`` rounds the whole dl: the same dx and dw
    up to fp32 summation order, then one bf16 rounding."""
    x, w, labels, g = _inputs("v1152_block_v384")
    g = np.where(labels >= 0, g, 0).astype(np.float32)
    xt, wt = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w))
    lt, gt = torch.from_numpy(labels), torch.from_numpy(g)
    _, lse = fused_ce_reference(xt, wt, lt)
    dx, dw = fused_ce_bwd(xt, wt, lt, lse, gt, chunk=200)
    ref_dx, ref_dw = fused_ce_bwd_reference(xt, wt, lt, lse, gt)
    assert dx.dtype == dw.dtype == torch.bfloat16
    for got, ref in ((dx, ref_dx), (dw, ref_dw)):
        torch.testing.assert_close(got.float(), ref.float(), atol=1e-2,
                                   rtol=2.0 ** -7)


def test_fused_ce_bwd_checks_its_inputs():
    x, w = torch.zeros(4, 16), torch.zeros(8, 16)
    labels = torch.zeros(4, dtype=torch.int32)
    lse = torch.zeros(4)
    with pytest.raises(ValueError, match="lse and g"):
        fused_ce_bwd(x, w, labels, lse, torch.zeros(4, dtype=torch.float64))
    with pytest.raises(TypeError, match="one dtype"):
        fused_ce_bwd(x, w.double(), labels, lse, lse)
    dx, dw = fused_ce_bwd(x[:0], w, labels[:0], lse[:0], lse[:0])
    assert dx.shape == (0, 16) and torch.equal(dw, torch.zeros_like(w))


def test_shape_errors_raise():
    x = torch.zeros(4, 16)
    with pytest.raises(ValueError, match="w \\(V, d\\)"):
        fused_softmax_cross_entropy(x, torch.zeros(8, 12),
                                    torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="labels"):
        fused_softmax_cross_entropy(x, torch.zeros(8, 16),
                                    torch.zeros(3, dtype=torch.int32))
