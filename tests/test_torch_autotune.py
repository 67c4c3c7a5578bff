"""The port's kernel autotuner (``paddle_tpu_torch/ops/autotune.py``) and
its three tuners against the JAX package, on the CPU.

``tune`` and ``AutotuneCache`` against ``paddle_tpu.ops.pallas.autotune``
under one fake clock: the winner, the timings, the skip of a raising
candidate, the geometry refusal before building, the error text, a hit
returning ``{}``, persistence across instances. ``tune_paged_attention``,
``tune_mega_epilogue`` and ``tune_flash_attention`` on CPU tensors
round-trip the cache, and the outputs under every candidate plan equal
the default plan's and the JAX kernel's in interpret mode, at one tiny
shape each. The plan resolvers' clamps and the geometry guard's shared
memory against hand counts. A tiny ``PagedDecodeEngine`` built with
``PT_PAGED_TUNE=1`` (mega on and off) serves the JAX ``mega=False``
engine's streams. The kernels under every plan on the card are in
test_torch_kernels_cuda.py."""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference.paged_engine import (
    PagedDecodeEngine as JaxPagedEngine)
from paddle_tpu.models import gpt as jax_gpt
from paddle_tpu.ops.pallas import autotune as jat
from paddle_tpu.ops.pallas import decode_megakernel as jax_mega
from paddle_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash_attention)
from paddle_tpu.ops.pallas.paged_attention import (
    paged_append_attend as jax_append_attend,
    paged_decode_attention as jax_decode_attention)
from paddle_tpu_torch.inference.factory import make_engine
from paddle_tpu_torch.inference.paged_engine import PagedDecodeEngine
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.models.convert import gpt_from_jax_state
from paddle_tpu_torch.ops import autotune as at
from paddle_tpu_torch.ops import decode_megakernel as mk
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import geometry
from paddle_tpu_torch.ops import paged_attention as pa
from torch_reference_compile import fast_reference_compiles  # noqa: F401

CPU = torch.device("cpu")
H100 = geometry.Card(132, 232448)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def cache(tmp_path):
    """A fresh process cache in a temporary file, the default one given
    back afterwards."""
    c = at.use_cache(str(tmp_path / "autotune.json"))
    yield c
    at.use_cache()


# -- tune and the cache against JAX's -----------------------------------------

class _Clock:
    """A fake ``time.perf_counter`` that each run of a config moves by the
    config's cost; ``built`` lists the configs run, in order."""

    COST = {"slow": 5.0, "fast": 1.0, "mid": 2.0, (1, 2): 3.0, (2, 1): 0.5,
            128: 4.0, 64: 1.5}

    def __init__(self):
        self.now = 0.0
        self.built = []

    def __call__(self):
        return self.now

    def run(self, cfg):
        self.built.append(cfg)
        if cfg == "bad":
            raise RuntimeError("the card refuses this launch")
        self.now += self.COST[tuple(cfg) if isinstance(cfg, list) else cfg]


def _both(monkeypatch, tmp_path, candidates, geom_check=None, **kw):
    """The same tuning through both packages: per package (best,
    timings, configs built, the ValueError's text or None)."""
    out = []
    for name, mod in (("jax", jat), ("port", at)):
        clock = _Clock()
        monkeypatch.setattr(time, "perf_counter", clock)
        c = mod.AutotuneCache(str(tmp_path / f"{name}.json"))
        try:
            best, timings = mod.tune("k", "key", candidates, clock.run,
                                     cache=c, geom_check=geom_check, **kw)
            out.append((best, timings, clock.built, None))
        except ValueError as e:
            out.append((None, None, clock.built, str(e)))
    return out


@pytest.mark.parametrize("candidates", [
    ["slow", "bad", "fast", "mid"],
    [(1, 2), [2, 1], "bad"],
    ["bad"],
])
@pytest.mark.parametrize("warmup, iters", [(1, 3), (0, 2)])
def test_tune_agrees_with_jax_tune(monkeypatch, tmp_path, candidates,
                                   warmup, iters):
    (jb, jt, jbuilt, jerr), (pb, pt, pbuilt, perr) = _both(
        monkeypatch, tmp_path, candidates, warmup=warmup, iters=iters)
    assert (pb, pt, pbuilt, perr) == (jb, jt, jbuilt, jerr)
    if candidates == ["bad"]:
        assert perr.startswith("autotune(k): every candidate failed for "
                               "key key")
    else:
        assert "bad" not in pt and pb == min(pt, key=pt.get)
        assert all(isinstance(c, (str, tuple)) for c in pt)


def test_geometry_refusal_before_building_agrees_with_jax(monkeypatch,
                                                          tmp_path):
    def geom_check(cfg):
        return "over the shared memory budget" if cfg == 128 else None

    (jb, jt, jbuilt, _), (pb, pt, pbuilt, _) = _both(
        monkeypatch, tmp_path, [128, 64], geom_check)
    assert (pb, pt, pbuilt) == (jb, jt, jbuilt) == (64, {64: 1.5},
                                                     [64, 64, 64, 64, 64])
    res = _both(monkeypatch, tmp_path / "only_refused", [128], geom_check)
    assert res[0][3] == res[1][3]
    assert "geometry-refused: 128: over the shared memory budget" in \
        res[1][3]


def test_a_hit_returns_no_timings_and_builds_nothing(monkeypatch,
                                                     tmp_path):
    for mod in (jat, at):
        clock = _Clock()
        monkeypatch.setattr(time, "perf_counter", clock)
        c = mod.AutotuneCache(str(tmp_path / f"{mod.__name__}.json"))
        best, _ = mod.tune("k", "key", ["slow", "fast"], clock.run,
                           cache=c)
        n = len(clock.built)
        assert mod.tune("k", "key", ["slow", "fast"], clock.run,
                        cache=c) == (best, {})
        assert len(clock.built) == n and best == "fast"
    assert at.history[-1]["hit"] and at.history[-1]["timings"] == {}


def test_cache_persists_across_instances(tmp_path):
    path = str(tmp_path / "sub" / "t.json")
    for mod in (jat, at):
        c1 = mod.AutotuneCache(path)
        c1.put("k|a=1", (128, 256))
        c2 = mod.AutotuneCache(path)
        assert c2.get("k|a=1") == (128, 256) and c2.get("k|a=2") is None
    assert at.AutotuneCache.key("k", b=1, a="x") == \
        jat.AutotuneCache.key("k", b=1, a="x") == "k|a=x|b=1"
    # the write is atomic (no temporary file left) and clear forgets
    assert not (tmp_path / "sub" / "t.json.tmp").exists()
    c = at.AutotuneCache(path)
    c.clear()
    assert c.get("k|a=1") is None
    assert at.AutotuneCache(path).get("k|a=1") == (128, 256)


def test_memoised_plans_are_dropped_when_the_cache_changes(cache):
    """A resolver reads the cache once per shape; a put (or a clear, or
    a new process cache) makes it read again."""
    args = (None, None, 2, 128, 8, 2, 32, torch.float32, 2, True, CPU, 132)
    formula = (pa.cluster_size(2, 128, 8, 132),
               pa.ring_stages(2, 128, pa.cluster_size(2, 128, 8, 132)))
    assert pa._resolve_config(*args) == formula
    key = pa._tune_key(128, 2, 32, torch.float32, 2, True, 256, 8, CPU)
    cache.put(key, (8, 1))
    assert pa._resolve_config(*args) == (8, 1)
    cache.clear()
    assert pa._resolve_config(*args) == formula
    cache.put(key, (2, 2))
    at.use_cache(cache.path)
    assert pa._resolve_config(*args) == (2, 2)


def test_keys_name_the_device():
    assert at.device_key("cpu") == at.device_key(CPU) == "cpu"
    key = mk._mega_tune_key(64, 512, torch.bfloat16, 2, 128, 8, CPU)
    assert key == ("paged_mega|device=cpu|dm=64|dtype=torch.bfloat16|"
                   "layers=2|page=128|rows=8|vocab=512")
    assert "|device=cpu|" in fa._tune_key(1, 64, 64, 2, 2, 32,
                                          torch.bfloat16, True, False,
                                          False, False, CPU)


# -- the guard and the resolvers by hand --------------------------------------

def test_paged_shared_memory_and_refusals_by_hand():
    # ring 4 x 2 x 16 x 128 x 2 = 32768 bytes; partial 1 x 130 x 4 = 520
    assert geometry.paged_smem(4, 1, 128, 2) == 32768 + 520
    # group 3 sizes the registers for 4: partial 4 x 130 x 4 = 2080
    assert geometry.paged_smem(4, 3, 128, 2) == 32768 + 2080
    # a short ring: the warps' partials (4 x 2080) set the offset
    assert geometry.paged_smem(1, 4, 128, 2) == 8320 + 2080
    T = (2, 128)                                   # 256 table rows
    assert geometry.paged_reason(8, 4, *T, 2, 128, 2, H100) is None
    assert "wider than 8" in geometry.paged_reason(16, 1, *T, 2, 128, 2,
                                                   H100)
    assert "power of two" in geometry.paged_reason(3, 1, *T, 2, 128, 2,
                                                   H100)
    assert "16-row tile" in geometry.paged_reason(4, 1, 1, 16, 2, 128, 2,
                                                  H100)
    assert "stages 5" in geometry.paged_reason(1, 5, *T, 2, 128, 2, H100)
    assert "exceed" in geometry.paged_reason(1, 4, *T, 1, 128, 2,
                                             geometry.Card(132, 33287))


@pytest.mark.parametrize("splits, stages, max_pages, page, want", [
    (16, 9, 1, 128, (8, 4)), (8, 2, 1, 64, (4, 2)), (3, 0, 16, 128, (2, 1)),
    (1, 4, 1, 16, (1, 4)), (8, 3, 2, 16, (2, 3))])
def test_paged_clamp(splits, stages, max_pages, page, want):
    assert geometry.clamp_paged(splits, stages, max_pages, page) == want


def test_paged_resolver_order(cache):
    """Explicit wins, then the cache's entry, then the formula; then the
    clamp."""
    shape = (2, 128, 8, 2, 32, torch.float32, 2, False, CPU, 132)
    assert pa._resolve_config(None, None, *shape) == (4, 4)
    assert pa._resolve_config(2, None, *shape) == \
        (2, pa.ring_stages(2, 128, 2))
    cache.put(pa._tune_key(128, 2, 32, torch.float32, 2, False, 256, 8,
                           CPU), (1, 2))
    assert pa._resolve_config(None, None, *shape) == (1, 2)
    assert pa._resolve_config(None, 4, *shape) == (1, 4)
    assert pa._resolve_config(16, 7, *shape) == (8, 4)
    # the fused mode has its own key
    assert pa._resolve_config(None, None, *shape[:7], True,
                              *shape[8:]) == (4, 4)


def test_k9_shared_memory_and_the_32_row_cap_by_hand():
    # d_model 2048: 32 slabs of 64 deep, 128 bytes a row of each
    assert geometry.k9_smem(32, 2048, 12) == 32 * 32 * 128 + 12 * 8192 + 1024
    assert geometry.k9_smem(32, 2048, 12) == 232448 - geometry.K9_STATIC
    # 64 rows need 262,144 bytes of rows alone: over the card's 230,400
    assert logits_reason_of((64, 64, 1, 132), 64) is not None
    assert "exceed" in logits_reason_of((64, 64, 1, 132), 64)
    assert logits_reason_of((32, 32, 12, 132), 64) is None
    assert "exceed" in logits_reason_of((32, 32, 13, 132), 64)
    # logits_plan's cap at d_model 2048: two groups of 32 for 64 rows
    assert mk.logits_plan(64, 2048, 50304, 132) == (32, 32, 12, 132)
    assert mk.logits_plan(64, 2048, 50304, 132, smem_optin=400000) == \
        (64, 64, 16, 132)
    for plan, words in [((8, 16, 4, 132), None), ((8, 12, 4, 132), "width"),
                        ((32, 16, 4, 132), "does not fit"),
                        ((8, 8, 17, 132), "stages 17"),
                        ((8, 8, 4, 787), "wider than the vocabulary's 786"),
                        ((8, 8, 4, 0), "grid of 0")]:
        reason = logits_reason_of(plan, 8)
        assert (reason is None) if words is None else words in reason


def logits_reason_of(plan, rows, dm=2048, vocab=50304):
    return geometry.logits_reason(plan, rows, dm, vocab, H100)


def test_k9_candidates_hold_the_formula_and_groups_up_to_rows():
    cands = mk.logits_candidates(64, 2048, 50304, 132)
    assert mk.logits_plan(64, 2048, 50304, 132) in cands
    assert {c[0] for c in cands} == {8, 16, 32, 64}
    assert {c[3] for c in cands} == {66, 99, 132, 197}
    small = mk.logits_candidates(8, 2048, 50304, 132)
    assert {(c[0], c[1]) for c in small} == {(8, 8)}
    survivors = [c for c in cands if logits_reason_of(c, 64) is None]
    assert {c[0] for c in survivors} == {8, 16, 32}


def test_k9_resolver_order_and_refusal(cache):
    args = (8, 2048, 50304, torch.bfloat16, 24, 128, CPU)
    assert mk._resolve_plan(None, *args) == mk.logits_plan(8, 2048, 50304,
                                                           132)
    cache.put(mk._mega_tune_key(2048, 50304, torch.bfloat16, 24, 128, 8,
                                CPU), (8, 8, 4, 66))
    assert mk._resolve_plan(None, *args) == (8, 8, 4, 66)
    assert mk._resolve_plan((8, 16, 8, 99), *args) == (8, 16, 8, 99)
    # the ring and the grid are clamped to what the card holds: 12 boxes
    # beside 32 rows at d_model 2048, the vocabulary's 786 tiles
    assert mk._resolve_plan((32, 32, 16, 900), *args) == (32, 32, 12, 786)
    assert mk._resolve_plan((8, 8, 0, 0), *args) == (8, 8, 1, 1)
    assert geometry.clamp_logits((64, 64, 16, 132), 2048, 50304,
                                 H100) == (64, 64, 1, 132)
    with pytest.raises(ValueError, match="exceed"):
        mk._resolve_plan((64, 64, 16, 132), *args)
    with pytest.raises(ValueError, match="does not fit"):
        mk._resolve_plan((16, 8, 4, 132), *args)


def test_flash_shared_memory_tiles_and_refusals_by_hand():
    # Q 128 rows x 2 boxes of 128 bytes; 2 stages of K and V at 128 keys
    assert geometry.flash_smem(128, 128, 128) == \
        32768 + 2 * 2 * 32768 + 5 * 8 + 1024
    # 64 keys: three stages of half the bytes
    assert geometry.flash_smem(128, 128, 64) == \
        32768 + 3 * 2 * 16384 + 7 * 8 + 1024
    assert geometry.flash_smem(64, 128, 128) == 16384 + 2 * 2 * 16384 + 1064
    bf, f32 = torch.bfloat16, torch.float32
    assert geometry.flash_tiles(bf, 64) == ((128, 64), (128, 128))
    assert geometry.flash_tiles(bf, 40) == geometry.flash_tiles(f32, 64) \
        == ((64, 32),)
    assert geometry.flash_reason(128, 64, bf, 128, H100) is None
    assert "compiles the tiles" in geometry.flash_reason(256, 512, bf, 128,
                                                         H100)
    assert "compiles the tiles" in geometry.flash_reason(128, 64, f32, 128,
                                                         H100)
    assert geometry.flash_reason(64, 32, f32, 128, H100) is None
    assert "exceed" in geometry.flash_reason(
        128, 128, bf, 128, geometry.Card(132, 164903))


def test_flash_resolver_order_and_refusal(cache):
    args = (1, 64, 64, 2, 2, 32, torch.bfloat16, True, False, False,
            False, CPU)
    assert fa._resolve_blocks(None, None, *args) == (128, 128)
    assert fa._resolve_blocks(None, None, *args[:6], torch.float32,
                              *args[7:]) == (64, 32)
    cache.put(fa._tune_key(*args), (128, 64))
    assert fa._resolve_blocks(None, None, *args) == (128, 64)
    assert fa._resolve_blocks(None, 128, *args) == (128, 128)
    with pytest.raises(ValueError, match="compiles the tiles"):
        fa._resolve_blocks(256, 256, *args)


# -- the tuners on CPU tensors against the JAX kernels ------------------------

PAGE = 128


def _paged_inputs(seed=5, hq=4, hkv=2, d=32, lengths=(0, 1, 127, 200),
                  max_pages=2):
    rs = np.random.RandomState(seed)
    b = len(lengths)
    n_pages = b * max_pages + 1
    q = rs.randn(b, hq, d).astype(np.float32)
    kp = rs.randn(n_pages, hkv, PAGE, d).astype(np.float32)
    vp = rs.randn(n_pages, hkv, PAGE, d).astype(np.float32)
    table = rs.permutation(b * max_pages).reshape(b, max_pages)
    return (q, kp, vp, table.astype(np.int32),
            np.asarray(lengths, np.int32))


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def test_tune_paged_attention_round_trips_the_cache(cache):
    q, kp, vp, table, lens = _paged_inputs()
    b, hkv, d = q.shape[0], kp.shape[1], q.shape[2]
    krow = np.random.RandomState(6).randn(b, hkv, d).astype(np.float32)
    vrow = np.random.RandomState(7).randn(b, hkv, d).astype(np.float32)
    wpids = np.full((b,), kp.shape[0] - 1, np.int32)
    want = np.asarray(jax_decode_attention(
        *map(jnp.asarray, (q, kp, vp, table, lens)), interpret=True))
    want_f, _, _ = jax_append_attend(
        *map(jnp.asarray, (q, kp, vp, krow, vrow, table, wpids, lens)),
        interpret=True)
    want_f = np.asarray(want_f)
    for fused in (False, True):
        args = _t(q, kp.copy(), vp.copy(), table, lens)
        best, timings = pa.tune_paged_attention(*args, fused=fused, iters=1)
        cands = pa.paged_candidates(2, PAGE, b * hkv, 132)
        # T 256 leaves every block of a cluster of 8 a tile: none refused
        assert set(timings) == set(cands) and best in timings
        key = pa._tune_key(PAGE, hkv, d, torch.float32, 2, fused, 256,
                           b * hkv, CPU)
        assert cache.get(key) == best
        assert pa.tune_paged_attention(*args, fused=fused, iters=1) == \
            (best, {})
        assert pa._resolve_config(None, None, 2, PAGE, b * hkv, hkv, d,
                                  torch.float32, 2, fused, CPU, 132) == best
    for splits, stages in cands:
        qt, kpt, vpt, tt, lt = _t(q, kp.copy(), vp.copy(), table, lens)
        got = pa.paged_decode_attention(qt, kpt, vpt, tt, lt,
                                        splits=splits, stages=stages)
        np.testing.assert_array_equal(
            got.numpy(), pa.paged_decode_attention(qt, kpt, vpt, tt,
                                                   lt).numpy())
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
        got_f, _, _ = pa.paged_append_attend(
            qt, kpt, vpt, *_t(krow, vrow), tt, *_t(wpids), lt,
            splits=splits, stages=stages)
        np.testing.assert_allclose(got_f.numpy(), want_f, atol=2e-5,
                                   rtol=2e-5)


def _head_inputs(seed=9, B=8, dm=64, V=512):
    """bf16 rows and a tied (V, dm) head in which every row has one clear
    winner (a column along its normed row), row 0's at two columns in
    different vocabulary tiles (a tie: the lower wins), row 2 poisoned."""
    rs = np.random.RandomState(seed)
    x = rs.randn(B, dm).astype(np.float32)
    s = (1.0 + 0.1 * rs.randn(dm)).astype(np.float32)
    b = (0.1 * rs.randn(dm)).astype(np.float32)
    wte = (rs.randn(V, dm) / np.sqrt(dm)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    h = torch.nn.functional.layer_norm(xb.float(), (dm,), eps=1e-5).numpy()
    h = h * s + b
    cols = {0: (37, 300)}
    cols.update({r: (40 + 50 * r,) for r in range(1, B)})
    for r, cs in cols.items():
        for c in cs:
            wte[c] = 3.0 * h[r] / np.linalg.norm(h[r])
    w = torch.from_numpy(wte).to(torch.bfloat16)
    poison = np.zeros(B, np.int32)
    poison[2] = 1
    return xb, torch.from_numpy(s), torch.from_numpy(b), w, poison


def test_tune_mega_epilogue_round_trips_the_cache(cache):
    x, s, b, wte, poison = _head_inputs()
    w = wte.t()                        # the tied head, as the engine's
    best, timings = mk.tune_mega_epilogue(x, s, b, w, layers=2, page=128,
                                          iters=1)
    cands = mk.logits_candidates(8, 64, 512, 132)
    assert set(timings) == set(cands) and best in timings
    key = mk._mega_tune_key(64, 512, torch.bfloat16, 2, 128, 8, CPU)
    assert cache.get(key) == best
    assert mk.tune_mega_epilogue(x, s, b, w, layers=2, page=128) == \
        (best, {})
    want_tok, want_nf = jax_mega.mega_logits_sample(
        jnp.asarray(x.float().numpy(), jnp.bfloat16), jnp.asarray(s.numpy()),
        jnp.asarray(b.numpy()), jnp.asarray(wte.float().numpy().T,
                                            jnp.bfloat16),
        jnp.asarray(poison), vb=128)
    want_tok, want_nf = np.asarray(want_tok), np.asarray(want_nf)
    pois = torch.from_numpy(poison)
    default = mk.mega_logits_sample(x, s, b, w, pois, layers=2, page=128)
    for plan in cands:
        tok, nf = mk.mega_logits_sample(x, s, b, w, pois, plan=plan,
                                        layers=2, page=128)
        assert torch.equal(tok, default[0]) and torch.equal(nf, default[1])
        np.testing.assert_array_equal(nf.numpy(), want_nf)
        ok = want_nf == 0
        np.testing.assert_array_equal(tok.numpy()[ok], want_tok[ok])
    assert default[0][0] == 37 and default[1].tolist() == [0, 0, 1, 0, 0,
                                                           0, 0, 0]
    # the CUDA-core route has one plan: nothing timed, nothing cached
    x32 = x.float()
    assert mk.tune_mega_epilogue(x32, s, b, wte.float().t()) == (None, {})
    with pytest.raises(ValueError, match="one plan"):
        mk.mega_logits_sample(x32, s, b, wte.float().t(), plan=best)
    with pytest.raises(ValueError, match="wgmma widths"):
        mk.mega_logits_sample(x, s, b, w, plan=(8, 12, 4, 2))


def test_tune_flash_attention_round_trips_the_cache(cache):
    rs = np.random.RandomState(11)
    B, S, H, D = 2, 96, 2, 32
    q, k, v = (torch.from_numpy(rs.randn(B, S, H, D).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    lens = torch.tensor([96, 50], dtype=torch.int32)
    bias = torch.from_numpy(rs.randn(B, 1, 1, S).astype(np.float32))
    kw = dict(causal=False, kv_lens=lens, bias=bias, dropout_p=0.1,
              dropout_seed=7)
    best, timings = fa.tune_flash_attention(q, k, v, iters=1, **kw)
    assert set(timings) == {(128, 64), (128, 128)} and best in timings
    key = fa._tune_key(B, S, S, H, H, D, torch.bfloat16, False, True, True,
                       True, CPU)
    assert cache.get(key) == best
    assert fa.tune_flash_attention(q, k, v, **kw) == (best, {})
    assert fa._resolve_blocks(None, None, B, S, S, H, H, D, torch.bfloat16,
                              False, True, True, True, CPU) == best
    # JAX's candidate list: only the tile the library compiles is timed
    jax_list = [(128, 128), (128, 256), (256, 256), (256, 512),
                (512, 256), (512, 512), (1024, 512)]
    _, t2 = fa.tune_flash_attention(q, k, v, causal=True, iters=1,
                                    candidates=jax_list)
    assert set(t2) == {(128, 128)}
    assert len(at.history[-1]["refused"]) == 6
    # every tile's output equals the default's and the JAX kernel's
    qj, kj, vj = (jnp.asarray(t.float().numpy()) for t in (q, k, v))
    want = np.asarray(jax_flash_attention(
        qj, kj, vj, kv_lens=jnp.asarray(lens.numpy()),
        bias=jnp.asarray(bias.numpy()), dropout_p=0.1, dropout_seed=7,
        block_q=128, block_k=128, interpret=True))
    default = fa.flash_attention(q, k, v, **kw)
    for bq, bk in timings:
        got = fa.flash_attention(q, k, v, block_q=bq, block_k=bk, **kw)
        assert torch.equal(got, default)
        np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2,
                                   rtol=2e-2)
    # the FP32 route's one tile: returned, nothing timed or cached
    assert fa.tune_flash_attention(q.float(), k.float(), v.float()) == \
        ((64, 32), {})


# -- the engine ---------------------------------------------------------------

JAX_CFG = jax_gpt.GPTConfig(vocab_size=96, max_seq_len=256, d_model=32,
                            n_layers=2, n_heads=4, dtype=jnp.float32)


def _models():
    jmodel = jax_gpt.GPT(JAX_CFG, seed=0)
    rs = np.random.RandomState(0)
    state = {}
    for k, v in sorted(jmodel.state_dict().items()):
        noise = rs.randn(*v.shape).astype(np.float32)
        state[k] = (1.0 + 0.1 * noise) if "scale" in k else 0.5 * noise
    jmodel.set_state_dict({k: jnp.asarray(v) for k, v in state.items()})
    cfg = gpt.GPTConfig(vocab_size=96, max_seq_len=256, d_model=32,
                        n_layers=2, n_heads=4, dtype=torch.float32)
    return jmodel, gpt_from_jax_state(cfg, state, device="cpu")


def test_engine_tuned_from_the_environment_serves_jax_streams(
        cache, monkeypatch):
    jmodel, model = _models()
    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, 96, size=n).tolist() for n in (5, 23, 140)]
    jeng = JaxPagedEngine(jmodel, n_pages=12, max_slots=4,
                          steps_per_call=4, mega=False)
    jreqs = [jeng.submit(p, max_new_tokens=8) for p in prompts]
    jeng.run()
    monkeypatch.setenv("PT_PAGED_TUNE", "1")
    seen = []
    monkeypatch.setattr(PagedDecodeEngine, "warmup",
                        lambda self: seen.append(len(cache._table)))
    key = pa._tune_key(PAGE, 4, 8, torch.float32, 1, True, 256, 16, CPU)
    for mega in (False, True):
        cache.clear()
        eng = make_engine(model, n_pages=12, max_slots=4, steps_per_call=4,
                          mega=mega, warmup=True, device="cpu")
        # tuned in the constructor, before warmup: K2 at (S 4, T 256); the
        # fp32 head takes K9's CUDA-core route, which has one plan
        assert seen[-1] == 1 and cache.get(key) is not None
        reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
        eng.run()
        assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
    assert eng.autotune() == (cache.get(key), {})


def test_engine_autotune_tunes_k9_at_decode_and_verify_rows(cache):
    """A bf16 single-dispatch engine with speculative_k: K9 is tuned at
    its S rows and at the verify's S x K; the streams are those of the
    untuned engine."""
    torch.manual_seed(0)
    model = gpt.GPT(gpt.gpt_tiny(max_seq_len=256, dtype=torch.bfloat16),
                    seed=0, device="cpu")
    prompts = [[1, 2, 3, 4, 1, 2, 3], [9, 8, 7, 6, 5]]
    streams = []
    for tuned in (False, True):
        eng = make_engine(model, max_slots=4, steps_per_call=2,
                          speculative_k=3, device="cpu")
        if tuned:
            n = len(at.history)
            config, timings = eng.autotune(iters=1)
            runs = list(at.history)[n:]
            assert [r["kernel"] for r in runs] == ["paged_append",
                                                   "paged_mega",
                                                   "paged_mega"]
            assert ["rows=4|" in runs[1]["key"], "rows=12|" in
                    runs[2]["key"]] == [True, True]
            assert config in timings and runs[2]["timings"]
        reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.run()
        streams.append([r.tokens for r in reqs])
    assert streams[0] == streams[1]
