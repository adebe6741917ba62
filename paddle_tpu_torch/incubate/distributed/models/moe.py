"""The MoE layer family at the reference's incubate path (counterpart of
paddle_tpu/incubate/distributed/models/moe.py); the implementation is
distributed/moe.py."""
from ....distributed.moe import (  # noqa: F401
    GShardGate, MoELayer, NaiveGate, SwitchGate, moe_dispatch_combine)

__all__ = ["MoELayer", "NaiveGate", "GShardGate", "SwitchGate",
           "moe_dispatch_combine"]
