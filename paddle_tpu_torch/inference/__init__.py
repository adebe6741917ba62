"""Serving (counterpart of paddle_tpu/inference)."""
from .llm_engine import (LLMEngine, LLMEngineConfig, LLMServer,  # noqa: F401
                         PagePool, PoolExhausted)
from . import fleet_serving  # noqa: F401,E402
from .fleet_serving import (  # noqa: F401,E402
    AutoscalePolicy, FleetRouter, KVPagePayload, LocalReplica,
    OverloadPolicy, Priority, RadixPrefixCache, ReplicaRegistry,
    KVTierStore, RequestCancelled, RequestShed, SLAPolicy, SLAScheduler)
from .serving import BatchingConfig, InferenceServer  # noqa: F401,E402
from .speculative import SpeculativeDecoder  # noqa: F401,E402

__all__ = ["LLMEngine", "LLMEngineConfig", "LLMServer", "PagePool",
           "PoolExhausted", "fleet_serving", "RadixPrefixCache",
           "SLAPolicy", "SLAScheduler", "Priority", "FleetRouter",
           "AutoscalePolicy", "LocalReplica", "ReplicaRegistry",
           "KVPagePayload", "OverloadPolicy", "RequestShed",
           "RequestCancelled", "KVTierStore", "BatchingConfig",
           "InferenceServer", "SpeculativeDecoder"]
