"""Fleet serving (counterpart of paddle_tpu/inference/fleet_serving):

* `scheduler.py` — SLA admission (priority classes, tenant fair
  queuing, TTFT-SLO boosting, preemption victims).
* `prefix_cache.py` — the radix prefix cache: content-addressed
  copy-on-write sharing of full KV pages behind
  `LLMEngineConfig(prefix_cache=True)`.
* `kv_transfer.py` — the KV-page wire (`KVPagePayload`, the reference's
  frame): the disaggregated prefill -> decode hand-off.
* `kv_tier.py` — the host-RAM and disk spill tiers below the pool
  (`KVTierStore`, `prefix_key`) behind `LLMEngineConfig(kv_tier=...)`.
* `overload.py` — typed shedding / cancellation, the TTFT estimator,
  the prefill circuit breaker and the brownout ladder.
* `replica.py` — `LLMServer` + engine as a fleet member (heartbeats,
  roles, chaos kill).
* `router.py` — `FleetRouter`: radix-affinity routing, disaggregation,
  autoscale, failover, hot-prefix migration, the overload tick.

The cross-process stream (`send_kv_payload` / `recv_kv_payload`,
`stream_prefill` / `recv_and_decode`) rides the xproc p2p socket
transport between ranks that `distributed.launch` started.
"""
from .kv_tier import KVTierStore, prefix_key  # noqa: F401
from .kv_transfer import (KVPagePayload, pack_kv_payload,  # noqa: F401
                          recv_kv_payload, send_kv_payload,
                          unpack_kv_payload)
from .overload import (DEFAULT_BROWNOUT_LEVELS, BrownoutController,  # noqa: F401
                       CircuitBreaker, OverloadPolicy, RequestCancelled,
                       RequestShed, TTFTEstimator, note_cancelled,
                       note_hedge, note_shed)
from .prefix_cache import RadixPrefixCache  # noqa: F401
from .replica import (LocalReplica, ReplicaRegistry, fork_model,  # noqa: F401
                      recv_and_decode, stream_prefill)
from .router import AutoscalePolicy, FleetRouter  # noqa: F401
from .scheduler import Priority, SLAPolicy, SLAScheduler  # noqa: F401

__all__ = ["RadixPrefixCache", "Priority", "SLAPolicy", "SLAScheduler",
           "KVPagePayload", "pack_kv_payload", "unpack_kv_payload",
           "KVTierStore", "prefix_key",
           "send_kv_payload", "recv_kv_payload",
           "LocalReplica", "ReplicaRegistry", "fork_model",
           "stream_prefill", "recv_and_decode",
           "AutoscalePolicy", "FleetRouter",
           "OverloadPolicy", "RequestShed", "RequestCancelled",
           "TTFTEstimator", "CircuitBreaker", "BrownoutController",
           "DEFAULT_BROWNOUT_LEVELS", "note_shed", "note_cancelled",
           "note_hedge"]
