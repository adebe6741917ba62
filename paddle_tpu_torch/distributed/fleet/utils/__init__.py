"""Counterpart of paddle_tpu/distributed/fleet/utils: the hybrid-parallel
helpers (`hybrid_parallel_util`) and the pipelined inference helper
(`hybrid_parallel_inference`)."""
from . import hybrid_parallel_inference  # noqa: F401
from . import hybrid_parallel_util  # noqa: F401
from .hybrid_parallel_inference import (  # noqa: F401
    HybridParallelInferenceHelper)
from .hybrid_parallel_util import (  # noqa: F401
    broadcast_dp_parameters, broadcast_mp_parameters,
    fused_allreduce_gradients)
