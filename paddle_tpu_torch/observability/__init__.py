"""Tracing, metrics and device-time attribution (counterpart of
``paddle_tpu/observability``):

- ``trace`` — ring-buffered structured spans with Chrome-trace/Perfetto
  export (``span("serve/dispatch", kind="paged")``, ``PT_TRACE_DIR``);
- ``stats`` (``paddle_tpu_torch.stats``) — counters, gauges, timers and
  log-bucketed histograms in one process-wide registry;
- ``statsz`` — opt-in live HTTP endpoint serving the snapshot
  (``PT_STATSZ_PORT``);
- ``flight`` — the per-request flight recorder; ``merge`` — trace merge
  and per-request stitch; ``comm`` — exposed-time interval algebra;
- ``runtime`` — device-memory gauges; ``devprof`` — roofline, launch
  tax (with the K13 probe) and step decomposition.

``init_from_env()`` (called once by ``import paddle_tpu_torch``)
activates only what the environment asks for: with neither
``PT_TRACE_DIR``/``PT_TRACE_FILE`` nor ``PT_STATSZ_PORT`` set it starts
no thread and opens no socket. The JAX package's ``numerics`` and
``fleet`` modules are not ported yet (ROADMAP).
"""

import os

from paddle_tpu_torch.observability import (comm, devprof, flight, merge,
                                            runtime, statsz, trace)
from paddle_tpu_torch.observability.comm import (exposed_time,
                                                 record_step_overlap,
                                                 step_overlap)
from paddle_tpu_torch.observability.merge import (merge_rank_traces,
                                                  merge_trace_files,
                                                  request_segments,
                                                  stitch_rank_traces,
                                                  stitch_trace_files)
from paddle_tpu_torch.observability.statsz import (StatszServer,
                                                   start_statsz,
                                                   stop_statsz)
from paddle_tpu_torch.observability.trace import (begin, complete, end,
                                                  instant, span)

__all__ = ["trace", "span", "begin", "end", "complete", "instant",
           "StatszServer", "start_statsz", "stop_statsz",
           "merge", "merge_trace_files", "merge_rank_traces",
           "stitch_trace_files", "stitch_rank_traces",
           "request_segments", "init_from_env",
           "comm", "exposed_time", "step_overlap", "record_step_overlap",
           "flight", "runtime", "devprof"]


def init_from_env():
    """Wire tracing (``PT_TRACE_DIR`` / ``PT_TRACE_FILE``) and the statsz
    server (``PT_STATSZ_PORT``) from the environment. Idempotent; a bad
    or busy port never breaks the importing process."""
    trace._init_from_env()
    port = os.environ.get("PT_STATSZ_PORT")
    if port:
        try:
            start_statsz(int(port))
        except (ValueError, OSError):
            pass  # the job matters more than the endpoint
