"""The serving front end (counterpart of ``paddle_tpu/serving``, its
S4a half): admission-controlled scheduling with deadline-aware queueing,
slot backfill, streaming and dynamic prefill buckets over one engine
(``scheduler.FrontEnd``), and deterministic Poisson or trace load
generation (``loadgen``). The router, disaggregated serving, KV transfer
and fleet observability are not ported yet (ROADMAP item S4).
"""

from paddle_tpu_torch.serving.loadgen import (Arrival, default_seed,
                                              from_trace, poisson_trace,
                                              replay, replay_ticks)
from paddle_tpu_torch.serving.scheduler import (FrontEnd, RequestJournal,
                                                ServeRequest,
                                                dynamic_bucket,
                                                projected_ttft)

__all__ = ["FrontEnd", "ServeRequest", "RequestJournal", "dynamic_bucket",
           "projected_ttft", "Arrival", "poisson_trace", "from_trace",
           "replay", "replay_ticks", "default_seed"]
