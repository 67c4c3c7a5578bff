"""The port's device-time attribution (``observability/devprof.py``,
``runtime.py``) and the launch probe K13 against the JAX package, on the
CPU: ``step_fractions``, ``launch_tax_fraction``, ``record_roofline``
and ``roofline_tokens_per_sec`` equal within 1e-12 on inputs drawn from
numpy seeds; K13's plain version bit for bit against the same copy
kernel through ``pl.pallas_call`` in interpret mode (the JAX ``_noop``
is local to ``pallas_launch_tax_s``, so it is rebuilt here); the meters'
CPU behaviour (``pallas_launch_tax_s`` is None without CUDA, as the JAX
meter is off the TPU); the kernels' cost functions against hand
arithmetic; the peak table and its overrides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from paddle_tpu import stats as jstats
from paddle_tpu.observability import devprof as jdevprof
from paddle_tpu_torch import stats
from paddle_tpu_torch.observability import devprof, runtime
from paddle_tpu_torch.ops import launch_probe
from paddle_tpu_torch.ops.decode_attention import decode_attention_cost
from paddle_tpu_torch.ops.decode_megakernel import (mega_decode_layers_cost,
                                                    mega_logits_sample_cost)
from paddle_tpu_torch.ops.flash_attention import flash_attention_cost
from paddle_tpu_torch.ops.paged_attention import (
    paged_append_attend_cost, paged_decode_attention_cost)
from paddle_tpu_torch.ops.quant_matmul import int8_matmul, int8_matmul_cost
from torch_reference_compile import fast_reference_compiles  # noqa: F401

SEEDS = (0, 1, 2, 3, 4)
TOL = 1e-12


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setattr(devprof, "_launch_cache", {})
    monkeypatch.setattr(jdevprof, "_launch_cache", {})
    stats.reset()
    jstats.reset()
    yield
    stats.reset()
    jstats.reset()


def _events(rs, n=30):
    names = ["serve/dispatch", "serve/harvest", "serve/step", "x"]
    return [(names[rs.randint(4)], int(rs.randint(0, 10**9)),
             int(rs.randint(1, 10**8))) for _ in range(n)]


@pytest.mark.parametrize("seed", SEEDS)
def test_step_fractions_equal_jax(seed):
    rs = np.random.RandomState(seed)
    evs = _events(rs)
    window = None if seed % 2 else (0.1, 0.9)
    got = devprof.step_fractions(evs, window=window)
    ref = jdevprof.step_fractions(evs, window=window)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k] == pytest.approx(ref[k], abs=TOL)
        if k != "wall_s":
            assert stats.get(f"prof/{k}") == pytest.approx(
                jstats.get(f"prof/{k}"), abs=TOL)
    assert devprof.step_fractions([]) == jdevprof.step_fractions([]) == {}


@pytest.mark.parametrize("seed", SEEDS)
def test_launch_tax_fraction_equal_jax(seed):
    rs = np.random.RandomState(seed)
    for _ in range(10):
        n, wall, tax = (int(rs.randint(0, 500)), float(rs.uniform(-.1, 2)),
                        float(rs.uniform(0, 0.01)))
        got = devprof.launch_tax_fraction(n, wall, tax_s=tax, name="t")
        ref = jdevprof.launch_tax_fraction(n, wall, tax_s=tax, name="t")
        assert got == pytest.approx(ref, abs=TOL)
        assert stats.get("prof/launch_tax_frac/t") == pytest.approx(
            jstats.get("prof/launch_tax_frac/t"), abs=TOL)


@pytest.mark.parametrize("seed", SEEDS)
def test_roofline_equal_jax(seed):
    rs = np.random.RandomState(seed)
    peaks = (float(rs.uniform(1e12, 1e15)), float(rs.uniform(1e11, 5e12)))
    for _ in range(10):
        f, b = float(rs.uniform(0, 1e13)), float(rs.uniform(0, 1e11))
        tok = float(rs.randint(0, 300))
        got = devprof.roofline_tokens_per_sec(
            devprof.CostCapture("p", f, b), tok, peaks=peaks)
        ref = jdevprof.roofline_tokens_per_sec(
            jdevprof.CostCapture("p", f, b), tok, peaks=peaks)
        assert got == pytest.approx(ref, rel=TOL, abs=TOL)
        measured = float(rs.uniform(0, 1e4))
        assert devprof.record_roofline("p", measured, got) == \
            pytest.approx(jdevprof.record_roofline("p", measured, ref),
                          rel=TOL, abs=TOL)
        for key in ("prof/roofline_tps/p", "prof/roofline_frac/p"):
            assert stats.get(key) == pytest.approx(jstats.get(key),
                                                   rel=TOL, abs=TOL)


def test_k13_plain_equals_pallas_copy_bit_for_bit():
    def _noop(x_ref, o_ref):
        o_ref[...] = x_ref[...]

    x = np.random.RandomState(0).randn(8, 128).astype(np.float32)
    x[0, :4] = (np.inf, -np.inf, np.nan, -0.0)
    ref = pl.pallas_call(
        _noop, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True)(jnp.asarray(x))
    xt = torch.from_numpy(x.copy())
    got = launch_probe.noop_copy(xt)
    assert got.data_ptr() != xt.data_ptr()
    assert (got.numpy().view(np.uint32)
            == np.asarray(ref).view(np.uint32)).all()
    assert launch_probe.noop_copy.launches == 0   # CPU: plain version
    assert torch.equal(launch_probe.noop_copy_reference(xt).view(
        torch.int32), xt.view(torch.int32))


@pytest.mark.parametrize("bad", ["shape", "dtype", "layout"])
def test_k13_wrapper_refuses_other_operands(bad):
    x = {"shape": torch.zeros((8, 64)),
         "dtype": torch.zeros((8, 128), dtype=torch.float64),
         "layout": torch.zeros((128, 8)).t()}[bad]
    with pytest.raises(ValueError):
        launch_probe.noop_copy(x)


def test_k13_cost_and_bound():
    flops, nbytes = launch_probe.noop_copy_cost()
    assert (flops, nbytes) == (0, 8192)
    assert nbytes / 3.35e12 * 1e9 == pytest.approx(2.445, abs=1e-3)


def test_pallas_launch_tax_none_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU behaviour; a GPU is present")
    assert devprof.pallas_launch_tax_s() is None
    assert devprof.pallas_launch_tax_s(force=True) is None
    assert stats.get("prof/launch_tax_pallas_s", None) is None
    if jax.default_backend() != "tpu":
        assert jdevprof.pallas_launch_tax_s() is None


def test_launch_tax_calibrates_caches_and_records(monkeypatch):
    monkeypatch.setenv("PT_PROF_LAUNCH_ITERS", "3")    # floored at 8
    tax = devprof.launch_tax_s(device="cpu")
    assert 0.0 < tax < 1.0
    assert stats.get("prof/launch_tax_s") == tax
    assert devprof.launch_tax_s(device="cpu") == tax
    assert devprof._launch_cache["add:cpu"] == tax
    assert devprof._iters() == 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            devprof.launch_tax_s(force=True)


def test_peak_specs_overrides_table_and_refusal(monkeypatch):
    monkeypatch.setenv("PT_PROF_PEAK_FLOPS", "2.5e12")
    monkeypatch.setenv("PT_PROF_PEAK_HBM_GBPS", "100")
    assert devprof.peak_specs() == jdevprof.peak_specs() == (
        pytest.approx(2.5e12), pytest.approx(100e9))
    assert devprof.hbm_seconds(1e9) == pytest.approx(0.01)
    assert devprof._table_peaks("NVIDIA H100 80GB HBM3") == devprof.H100_SXM
    assert devprof._table_peaks("NVIDIA H100 SXM5 80GB") == devprof.H100_SXM
    assert devprof._table_peaks("NVIDIA H100 PCIe") is None
    assert devprof._table_peaks("NVIDIA A100-SXM4-80GB") is None
    monkeypatch.delenv("PT_PROF_PEAK_HBM_GBPS")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="PT_PROF_PEAK"):
            devprof.peak_specs()


def test_capture_records_the_jax_gauge_names():
    cap = devprof.capture("decode", 10.0, 20.0,
                          {"argument_size_in_bytes": 5,
                           "output_size_in_bytes": 6})
    assert (cap.flops, cap.hbm_bytes) == (10.0, 20.0)
    assert cap.analytic_seconds((1.0, 1.0)) == 20.0
    snap = stats.snapshot()
    assert snap["prof/flops/decode"] == 10.0
    assert snap["prof/hbm_bytes/decode"] == 20.0
    assert snap["mem/compiled_argument_size_bytes/decode"] == 5
    assert snap["mem/compiled_output_size_bytes/decode"] == 6
    devprof.capture("quiet", 1.0, 1.0, record=False)
    assert "prof/flops/quiet" not in stats.snapshot()


def test_runtime_gauges_on_the_cpu():
    assert runtime.hbm_gauges(["cpu"]) == {}
    assert runtime.hbm_gauges([torch.device("cpu")], per_device=True) == {}
    if not torch.cuda.is_available():
        assert runtime.hbm_gauges() == {}
    assert runtime.memory_analysis_gauges(
        {"argument_size_in_bytes": 3}) == {
            "mem/compiled_argument_size_bytes": 3}


def test_count_kernel_launches_sums_the_wrappers():
    x = torch.zeros((8, 128))
    assert devprof.count_kernel_launches(launch_probe.noop_copy, x) == 0

    def launches_two():
        launch_probe.noop_copy.launches += 1
        int8_matmul.launches += 1

    try:
        assert devprof.count_kernel_launches(launches_two) == 2
    finally:
        launch_probe.noop_copy.launches -= 1
        int8_matmul.launches -= 1


# -- the kernels' cost functions, by hand -------------------------------------

def test_flash_attention_cost_by_hand():
    # causal 3 x 3: pairs 1 + 2 + 3 = 6
    assert flash_attention_cost(2, 3, 3, 4, 2, 8, elt=2) == (
        4 * 2 * 4 * 8 * 6, (2 * 2 * 3 * 4 + 2 * 2 * 3 * 2) * 8 * 2
        + 2 * 4 * 3 * 4)
    assert flash_attention_cost(1, 2, 5, 1, 1, 4, causal=False, elt=4,
                                lse=False) == (4 * 4 * 10,
                                               (2 * 2 + 2 * 5) * 4 * 4)


def test_paged_and_decode_attention_cost_by_hand():
    lens = [0, 3, 5]
    f, b = paged_decode_attention_cost(lens, 4, 2, 8, elt=2)
    assert (f, b) == (4 * 8 * 4 * 8, 2 * 3 * 4 * 8 * 2 + 2 * 8 * 2 * 8 * 2
                      + 8 * 3 * 4)
    _, b1 = paged_decode_attention_cost(lens, 4, 2, 8, elt=2, kv_tokens=5)
    assert b1 == b - 2 * 3 * 2 * 8 * 2
    f2, b2 = paged_append_attend_cost(lens, 4, 2, 8, elt=2)
    assert f2 == 4 * 11 * 4 * 8
    assert b2 == b + 4 * 3 * 2 * 8 * 2
    assert decode_attention_cost(lens, 4, 2, 8, elt=2) == (
        4 * 8 * 4 * 8, 2 * 8 * 2 * 8 * 2 + 2 * 3 * 4 * 8 * 2 + 3 * 4)
    assert decode_attention_cost(lens, 4, 2, 8, elt=2, return_stats=True)[
        1] == 2 * 8 * 2 * 8 * 2 + 2 * 3 * 4 * 8 * 2 + 3 * 4 + 2 * 3 * 4 * 4


def test_int8_and_mega_cost_by_hand():
    assert int8_matmul_cost(8, 16, 32) == (2 * 8 * 16 * 32,
                                           16 * 32 + 4 * 32 + 2 * 8 * 16
                                           + 2 * 8 * 32)
    L, d, hq, hkv, hd = 2, 8, 2, 1, 4
    w = {"wqkv": torch.zeros((L, d, d + 2 * hkv * hd)),
         "wo": torch.zeros((L, d, d)), "wup": torch.zeros((L, d, 4 * d)),
         "wdown": torch.zeros((L, 4 * d, d)),
         "ln1_scale": torch.zeros((L, d))}
    slabs = sum(t.numel() * 4 for t in w.values())
    lens = [1, 4]
    macs = L * (d * 16 + d * d + 2 * d * 4 * d)
    assert mega_decode_layers_cost(lens, w, hq, hkv, hd, elt=4) == (
        2 * 2 * macs + 4 * 5 * hq * hd * L,
        slabs + 2 * 5 * hkv * hd * 4 * L + 2 * 2 * hkv * hd * 4 * L
        + 2 * 2 * d * 4 + 16 * 2)
    assert mega_logits_sample_cost(3, 8, 50, elt=2) == (
        2 * 3 * 8 * 50, 50 * 8 * 2 + 3 * 8 * 2 + 2 * 8 * 4 + 3 * 3 * 4)
    assert devprof.matmul_cost(3, 4, 5, elt=2) == (120, (20 + 12 + 15) * 2)
