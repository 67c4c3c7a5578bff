"""Runtime telemetry: live/peak device-memory gauges and per-dispatch
memory footprints (counterpart of ``paddle_tpu/observability/runtime.py``,
written for PyTorch).

- :func:`hbm_gauges` — the CUDA caching allocator's live and peak bytes
  (``torch.cuda.memory_stats``: ``allocated_bytes.all.current`` and
  ``.peak``) as ``mem/hbm_bytes_in_use`` and ``mem/hbm_peak_bytes``,
  summed over the devices, plus per-device ``.../d{N}`` with
  ``per_device=True``. A CPU device has no such stats: asking for the
  CPU records nothing and returns ``{}``, as the JAX module does on a
  CPU backend.
- :func:`memory_analysis_gauges` — the JAX module reads a compiled
  executable's ``memory_analysis()``. Eager PyTorch compiles nothing, so
  the port records the argument and output bytes a caller counted (the
  engines' ``dispatch_cost`` counts them for one decode dispatch) under
  the same gauge names, ``mem/compiled_argument_size_bytes`` and
  ``mem/compiled_output_size_bytes``. No temp, alias or generated-code
  size exists to record.

The JAX module's compile/retrace counters (``compile/retrace/*``) have
no counterpart: nothing is traced.
"""

from typing import Mapping, Optional

import torch

from paddle_tpu_torch import stats

__all__ = ["hbm_gauges", "memory_analysis_gauges"]

_MA_FIELDS = ("argument_size_in_bytes", "output_size_in_bytes")


def hbm_gauges(devices=None, per_device: bool = False) -> dict:
    """Record the allocator's live/peak device bytes as gauges.
    ``devices``: CUDA devices (``torch.device`` or strings); default
    every visible CUDA device. Returns the flat dict recorded (empty
    when no CUDA device was asked for)."""
    if devices is None:
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if torch.cuda.is_available() else [])
    live = peak = 0
    seen = False
    out = {}
    for d in devices:
        d = torch.device(d)
        if d.type != "cuda":
            continue
        seen = True
        ms = torch.cuda.memory_stats(d)
        b = int(ms.get("allocated_bytes.all.current", 0))
        p = int(ms.get("allocated_bytes.all.peak", b))
        live += b
        peak += p
        if per_device:
            i = d.index if d.index is not None else \
                torch.cuda.current_device()
            out[f"mem/hbm_bytes_in_use/d{i}"] = b
            out[f"mem/hbm_peak_bytes/d{i}"] = p
    if not seen:
        return {}
    out["mem/hbm_bytes_in_use"] = live
    out["mem/hbm_peak_bytes"] = peak
    for k, v in out.items():
        stats.set_value(k, v)
    return out


def memory_analysis_gauges(analysis: Mapping[str, int],
                           name: Optional[str] = None) -> dict:
    """Record ``analysis`` (a mapping with ``argument_size_in_bytes``
    and ``output_size_in_bytes``) as ``mem/compiled_<field>_bytes``
    gauges, suffixed ``/<name>`` when given. Returns the recorded
    dict."""
    out = {}
    sfx = f"/{name}" if name else ""
    for field in _MA_FIELDS:
        v = analysis.get(field)
        if v is None:
            continue
        key = field[:-len("_in_bytes")]
        out[f"mem/compiled_{key}_bytes{sfx}"] = int(v)
    for k, v in out.items():
        stats.set_value(k, v)
    return out
