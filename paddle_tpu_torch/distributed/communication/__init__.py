"""distributed.communication (counterpart of
paddle_tpu/distributed/communication): the collective API under its
new-style import path, plus the `stream` variants. The implementations
live in `distributed.collective`.
"""
from ..collective import (  # noqa: F401
    P2POp, ReduceOp, all_gather, all_gather_object, all_reduce, alltoall,
    alltoall_single, batch_isend_irecv, broadcast, reduce, reduce_scatter,
    scatter, scatter_object_list)
from . import stream  # noqa: F401

__all__ = ["ReduceOp", "stream", "all_reduce", "all_gather",
           "all_gather_object", "broadcast", "reduce", "scatter",
           "scatter_object_list", "alltoall", "alltoall_single",
           "reduce_scatter", "batch_isend_irecv", "P2POp"]
