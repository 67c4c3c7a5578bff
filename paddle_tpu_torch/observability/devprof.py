"""Device-time attribution (counterpart of
``paddle_tpu/observability/devprof.py``): where do the nanoseconds go on
the card? Three meters, one ``prof/`` namespace in the stats registry.

- **Roofline** — the engines' ``dispatch_cost()`` sums the flops and
  HBM bytes of one decode dispatch from the kernels' cost functions
  (``ops/*_cost``) and the dense products (:func:`matmul_cost`) into a
  :class:`CostCapture` (:func:`capture` records it);
  :func:`roofline_tokens_per_sec` combines it with the card's peaks
  (:func:`peak_specs`) into an analytic tokens/s bound, and
  :func:`record_roofline` turns a measured rate into the
  ``prof/roofline_frac`` gauge. The JAX module reads the same numbers
  from XLA's ``cost_analysis`` of the lowered program
  (``capture_jit``); eager PyTorch lowers nothing, so the port counts.
- **Launch tax** — :func:`launch_tax_s` times one tiny PyTorch launch
  (``x + 1`` on 8 int32) followed by a scalar readback, the round the
  engines pay per dispatch and harvest; :func:`pallas_launch_tax_s`
  times the same round around the hand-written launch probe (K13,
  ``ops/launch_probe.py``); :func:`launch_tax_fraction` prices
  ``serve/dispatch_launches`` against a window's wall time.
  :func:`count_kernel_launches` counts the port's kernel launches in one
  call (the counterpart of the JAX module's jaxpr and HLO counts).
- **Step decomposition** — :func:`step_fractions` splits a serving
  window into device-interaction and host-gap fractions with
  ``comm.py``'s interval algebra over the engines' ``serve/dispatch``
  and ``serve/harvest`` spans.
"""

import os
import time
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Tuple

import torch

from paddle_tpu_torch import stats
from paddle_tpu_torch.observability import comm

__all__ = ["CostCapture", "capture", "matmul_cost", "peak_specs",
           "hbm_seconds", "roofline_tokens_per_sec", "record_roofline",
           "launch_tax_s", "pallas_launch_tax_s", "launch_tax_fraction",
           "step_fractions", "count_kernel_launches"]


# ---------------------------------------------------------------------------
# device peak specs
# ---------------------------------------------------------------------------

# (dense bf16 FLOP/s, HBM bytes/s), NVIDIA's data sheet for the H100 SXM
# (the part whose device name reads "H100 80GB HBM3" or "H100 SXM")
H100_SXM = (989.4e12, 3.35e12)


def _table_peaks(name: str) -> Optional[Tuple[float, float]]:
    if "H100" in name and ("HBM3" in name or "SXM" in name):
        return H100_SXM
    return None


def peak_specs(device=None) -> Tuple[float, float]:
    """``(peak_flops_per_s, peak_hbm_bytes_per_s)`` of ``device``
    (default: CUDA device 0) from its name. ``PT_PROF_PEAK_FLOPS``
    (FLOP/s) and ``PT_PROF_PEAK_HBM_GBPS`` (GB/s) override the table. A
    card the table does not know, without both overrides, raises: a
    wrong peak is worse than none (the JAX module falls back to a TPU
    generation's peaks)."""
    env_f = os.environ.get("PT_PROF_PEAK_FLOPS")
    env_b = os.environ.get("PT_PROF_PEAK_HBM_GBPS")
    flops = float(env_f) if env_f else None
    bw = float(env_b) * 1e9 if env_b else None
    if flops is None or bw is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "peak_specs: no CUDA device to read; set "
                "PT_PROF_PEAK_FLOPS and PT_PROF_PEAK_HBM_GBPS")
        dev = torch.device("cuda", 0) if device is None else \
            torch.device(device)
        name = torch.cuda.get_device_name(dev)
        peaks = _table_peaks(name)
        if peaks is None:
            raise RuntimeError(
                f"peak_specs: no peak figures for {name!r}; set "
                f"PT_PROF_PEAK_FLOPS and PT_PROF_PEAK_HBM_GBPS")
        flops = peaks[0] if flops is None else flops
        bw = peaks[1] if bw is None else bw
    return flops, bw


def hbm_seconds(nbytes: float, device=None) -> float:
    """Analytic seconds to move ``nbytes`` through device memory at the
    card's peak rate."""
    _, bw = peak_specs(device)
    return float(nbytes) / bw


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

@dataclass
class CostCapture:
    """One dispatch's cost: flops and HBM bytes per call, plus its
    memory footprint (``argument_size_in_bytes``,
    ``output_size_in_bytes``)."""
    name: str
    flops: float
    hbm_bytes: float
    memory: Dict[str, int] = field(default_factory=dict)

    def analytic_seconds(self, peaks: Tuple[float, float]) -> float:
        """Roofline seconds per call: max(compute time, memory time)."""
        pf, pb = peaks
        return max(self.flops / pf, self.hbm_bytes / pb)


def matmul_cost(m: int, k: int, n: int, elt: int = 2) -> Tuple[int, int]:
    """(flops, HBM bytes) of a dense (m, k) @ (k, n) product in one
    dtype of ``elt`` bytes: 2 flops per multiply-add; both operands read
    and the output written once."""
    return 2 * m * k * n, (k * n + m * k + m * n) * elt


def capture(name: str, flops: float, hbm_bytes: float,
            memory: Optional[Mapping[str, int]] = None,
            record: bool = True) -> CostCapture:
    """A :class:`CostCapture` of counted costs. Records
    ``prof/flops[/name]``, ``prof/hbm_bytes[/name]`` and the
    ``mem/compiled_*`` footprint (``runtime.memory_analysis_gauges``)
    unless ``record=False``: the gauges the JAX ``capture_jit``
    records."""
    cap = CostCapture(name=name, flops=float(flops),
                      hbm_bytes=float(hbm_bytes),
                      memory=dict(memory or {}))
    if record:
        from paddle_tpu_torch.observability import runtime
        sfx = f"/{name}" if name else ""
        stats.set_value(f"prof/flops{sfx}", cap.flops)
        stats.set_value(f"prof/hbm_bytes{sfx}", cap.hbm_bytes)
        runtime.memory_analysis_gauges(cap.memory, name)
    return cap


def count_kernel_launches(fn, *args, **kwargs) -> int:
    """Kernel launches one call of ``fn(*args, **kwargs)`` makes: the sum
    of the port's wrapper ``launches`` counters across the call (CUDA
    launches only; on the CPU every kernel runs its plain version and
    the count is 0). Unlike the JAX module's jaxpr count, this RUNS
    ``fn``."""
    from paddle_tpu_torch.ops import launch_counters
    counters = launch_counters().values()
    before = sum(w.launches for w in counters)
    fn(*args, **kwargs)
    return sum(w.launches for w in counters) - before


def roofline_tokens_per_sec(cap: CostCapture, tokens_per_call: float,
                            device=None,
                            peaks: Optional[Tuple[float, float]] = None
                            ) -> float:
    """Analytic roofline tokens/s for a dispatch of cost ``cap`` emitting
    ``tokens_per_call`` tokens: tokens / max(flops / peak_flops,
    bytes / peak_bytes_per_s). 0.0 when the capture has no cost
    (callers read 0 as "no roofline")."""
    if peaks is None:
        peaks = peak_specs(device)
    t = cap.analytic_seconds(peaks)
    if t <= 0.0 or tokens_per_call <= 0:
        return 0.0
    return tokens_per_call / t


def record_roofline(name: str, measured_tps: float,
                    analytic_tps: float) -> float:
    """Record ``prof/roofline_tps[/name]`` and ``prof/roofline_frac
    [/name]`` (measured / analytic; 0 when no analytic bound exists) and
    return the fraction."""
    frac = measured_tps / analytic_tps if analytic_tps > 0 else 0.0
    sfx = f"/{name}" if name else ""
    stats.set_value(f"prof/roofline_tps{sfx}", analytic_tps)
    stats.set_value(f"prof/roofline_frac{sfx}", frac)
    return frac


# ---------------------------------------------------------------------------
# launch-tax meter
# ---------------------------------------------------------------------------

_launch_cache: Dict[str, float] = {}


def _median(xs):
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _iters() -> int:
    return max(8, int(os.environ.get("PT_PROF_LAUNCH_ITERS", "64")))


def _readback_median(launch, x, read) -> float:
    """Median wall time of ``read(launch(x))`` over ``_iters()`` rounds,
    after one untimed round."""
    read(launch(x))
    samples = []
    for _ in range(_iters()):
        t0 = time.perf_counter()
        read(launch(x))
        samples.append(time.perf_counter() - t0)
    return _median(samples)


def launch_tax_s(force: bool = False, device=None) -> float:
    """Per-dispatch overhead of one tiny PyTorch launch, calibrated once
    per process and device (``force=True`` recalibrates): the median
    wall time of ``x + 1`` on an 8-element int32 tensor followed by
    ``int(y[0])``, over ``PT_PROF_LAUNCH_ITERS`` rounds (default 64, at
    least 8). ``device`` defaults to CUDA (and raises without it).
    Records the ``prof/launch_tax_s`` gauge."""
    from paddle_tpu_torch import device as device_lib
    dev = device_lib.resolve(device)
    key = f"add:{dev}"
    if not force and key in _launch_cache:
        return _launch_cache[key]
    x = torch.zeros((8,), dtype=torch.int32, device=dev)
    tax = _readback_median(lambda v: v + 1, x, lambda y: int(y[0]))
    _launch_cache[key] = tax
    stats.set_value("prof/launch_tax_s", tax)
    return tax


def pallas_launch_tax_s(force: bool = False) -> Optional[float]:
    """Per-launch overhead of one hand-written kernel launch: the median
    wall time of a launch of the probe K13 (``noop_copy`` of an (8, 128)
    fp32 block) followed by a scalar readback, over
    ``PT_PROF_LAUNCH_ITERS`` rounds. The JAX name is kept for the
    reader; it times a Pallas no-op there. None without a CUDA device,
    as the JAX meter returns None off the TPU. On a card, a failed
    build or launch raises. Cached per process; records
    ``prof/launch_tax_pallas_s``."""
    if not torch.cuda.is_available():
        return None
    if not force and "probe" in _launch_cache:
        return _launch_cache["probe"]
    from paddle_tpu_torch.ops.launch_probe import noop_copy
    x = torch.zeros((8, 128), dtype=torch.float32,
                    device=torch.device("cuda", torch.cuda.current_device()))
    tax = _readback_median(noop_copy, x, lambda y: float(y[0, 0]))
    _launch_cache["probe"] = tax
    stats.set_value("prof/launch_tax_pallas_s", tax)
    return tax


def launch_tax_fraction(dispatches: int, wall_s: float,
                        tax_s: Optional[float] = None,
                        name: Optional[str] = None) -> float:
    """Fraction of ``wall_s`` spent on per-dispatch launch overhead:
    ``dispatches * tax / wall``, clamped to [0, 1] (pipelined launches
    overlap, so the product is an upper bound). ``dispatches`` is the
    ``serve/dispatch_launches`` delta over the window; ``tax_s``
    defaults to :func:`launch_tax_s`. Records
    ``prof/launch_tax_frac[/name]``."""
    if tax_s is None:
        tax_s = launch_tax_s()
    frac = 0.0 if wall_s <= 0 else min(1.0, dispatches * tax_s / wall_s)
    sfx = f"/{name}" if name else ""
    stats.set_value(f"prof/launch_tax_frac{sfx}", frac)
    return frac


# ---------------------------------------------------------------------------
# step decomposition
# ---------------------------------------------------------------------------

def step_fractions(events=None,
                   window: Optional[Tuple[float, float]] = None,
                   dispatch_prefix: str = "serve/dispatch",
                   harvest_prefix: str = "serve/harvest",
                   host_bound_threshold: float = 0.5,
                   record: bool = True) -> Dict[str, float]:
    """Split a serving window into device-interaction and host-gap
    fractions from the trace ring, with comm.py's exact interval
    algebra:

    - ``device_frac`` — union(dispatch and harvest spans) / wall: the
      host is enqueueing device work or blocked on its output.
    - ``queue_frac`` — union(harvest spans) / wall: blocked draining the
      dispatch queue (the device-bound signature, inside device_frac).
    - ``host_frac`` — 1 - device_frac: pure host work.
    - ``host_bound`` — 1.0 when host_frac > ``host_bound_threshold``.

    ``window`` defaults to the extent of the matched spans. Returns {}
    when nothing matched. Records the ``prof/device_frac``,
    ``prof/queue_frac``, ``prof/host_frac`` and ``prof/host_bound``
    gauges."""
    if events is None:
        from paddle_tpu_torch.observability import trace
        events, _ = trace.events()
    disp = comm.span_intervals(events, dispatch_prefix, window)
    harv = comm.span_intervals(events, harvest_prefix, window)
    both = disp + harv
    if not both:
        return {}
    if window is None:
        window = (min(a for a, _ in both), max(b for _, b in both))
    wall = window[1] - window[0]
    if wall <= 0:
        return {}
    host_gap = comm.exposed_time([window], both)
    queue_busy = wall - comm.exposed_time([window], harv)
    out = {
        "wall_s": wall,
        "device_frac": (wall - host_gap) / wall,
        "queue_frac": queue_busy / wall,
        "host_frac": host_gap / wall,
    }
    out["host_bound"] = 1.0 if out["host_frac"] > host_bound_threshold \
        else 0.0
    if record:
        for k in ("device_frac", "queue_frac", "host_frac",
                  "host_bound"):
            stats.set_value(f"prof/{k}", out[k])
    return out
