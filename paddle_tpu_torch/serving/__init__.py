"""The serving layer (counterpart of ``paddle_tpu/serving``): the front
end — admission-controlled scheduling with deadline-aware queueing, slot
backfill, streaming and dynamic prefill buckets over one engine
(``scheduler.FrontEnd``), deterministic Poisson or trace load generation
(``loadgen``); KV across engines — the KV wire codec with its store and
socket planes (``kv_transfer``) and the fleet prefix directory
(``disagg``); and serving past one engine — the multi-replica
``router.Router`` over store membership, the symmetric replica loop
(``router.serve_replica``) and the disaggregated role loops
(``disagg.serve_prefill_replica`` / ``serve_decode_replica``).
"""

from paddle_tpu_torch.serving.disagg import (FleetPrefixDirectory,
                                             serve_decode_replica,
                                             serve_prefill_replica,
                                             serve_role)
from paddle_tpu_torch.serving.loadgen import (Arrival, default_seed,
                                              from_trace, poisson_trace,
                                              replay, replay_ticks)
from paddle_tpu_torch.serving.router import (Router, router_port,
                                             serve_replica)
from paddle_tpu_torch.serving.scheduler import (FrontEnd, RequestJournal,
                                                ServeRequest,
                                                dynamic_bucket,
                                                projected_ttft)

__all__ = ["FrontEnd", "ServeRequest", "RequestJournal", "dynamic_bucket",
           "projected_ttft", "Arrival", "poisson_trace", "from_trace",
           "replay", "replay_ticks", "default_seed", "Router",
           "serve_replica", "router_port", "FleetPrefixDirectory",
           "serve_prefill_replica", "serve_decode_replica", "serve_role"]
