"""Counterpart of paddle_tpu/distributed: the multi-process runtime.

`launch` starts the workers, `env` rendezvouses them over a TCPStore
into a gloo process group, `xproc` carries the eager collectives and
the p2p socket transport, `collective` the paddle-shaped eager API over
it, `resilience` the retry policy, step guards, preemption handler and
anomaly journal, `chaos` the seeded fault injection, and
`fleet.elastic` the heartbeat and join membership.
"""
from . import chaos  # noqa: F401
from . import collective  # noqa: F401
from . import env  # noqa: F401
from . import resilience  # noqa: F401
from . import xproc  # noqa: F401
from .chaos import FaultPlan  # noqa: F401
from .collective import (  # noqa: F401
    Group,
    P2POp,
    ReduceOp,
    all_gather,
    all_gather_object,
    all_reduce,
    alltoall,
    alltoall_single,
    barrier,
    batch_isend_irecv,
    broadcast,
    get_group,
    init_parallel_env,
    irecv,
    is_initialized,
    isend,
    new_group,
    p2p_shift,
    recv,
    reduce,
    reduce_scatter,
    scatter,
    scatter_object_list,
    send,
    spmd,
    wait,
)
from .env import ParallelEnv, get_rank, get_world_size  # noqa: F401
from .resilience import (  # noqa: F401
    RetryPolicy,
    StepAbort,
    StepGuard,
    install_preemption_handler,
)
