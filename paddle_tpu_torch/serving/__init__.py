"""The serving front end (counterpart of ``paddle_tpu/serving``, its
S4a half): admission-controlled scheduling with deadline-aware queueing,
slot backfill, streaming and dynamic prefill buckets over one engine
(``scheduler.FrontEnd``), and deterministic Poisson or trace load
generation (``loadgen``); and its S4b-1 half, KV across engines on one
host: the KV wire codec with its store and socket planes
(``kv_transfer``) and the fleet prefix directory (``disagg``). The
router, the replica serve loops, membership and fleet observability are
not ported yet (ROADMAP item 7b, S4b-2).
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
