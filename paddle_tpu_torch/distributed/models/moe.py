"""distributed.models.moe (counterpart of
paddle_tpu/distributed/models/moe.py): re-exports of distributed/moe.py."""
from ..moe import (  # noqa: F401
    GShardGate, MoELayer, NaiveGate, SwitchGate, moe_dispatch_combine)

__all__ = ["MoELayer", "NaiveGate", "GShardGate", "SwitchGate",
           "moe_dispatch_combine"]
