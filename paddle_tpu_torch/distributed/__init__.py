"""Counterpart of paddle_tpu/distributed: the multi-process runtime and
data-parallel training.

`launch` starts the workers, `env` rendezvouses them over a TCPStore
into a gloo process group, `mesh` lays the process world out as the
hybrid mesh, `xproc` carries the eager collectives and the p2p socket
transport, `collective` the paddle-shaped API over it (the world group
and the mesh-axis groups, `spmd`), `communication.stream` its stream
variants, `checkpoint` the sharded asynchronous atomic Checkpointer,
`parallel_step` the data-parallel / ZeRO `DistributedTrainStep`,
`sharding` the group_sharded entry point, `hybrid3d` the DP × TP × PP
plan, the GPipe schedule and the int8 TP placements, `api_extra` the
tensor-parallel `split`, `spawn` and the gloo facade (re-exported by
`parallel_with_gloo`), `cloud_utils` the cluster layout from the env
contract, `moe` the mixture-of-experts layers with the token
all-to-all over ``ep`` (re-exported by `models.moe`; `utils` holds the
eager `global_scatter` / `global_gather`), `quant_collective` the
block-scaled int8 gradient mean, `sequence_parallel` ring and Ulysses
attention over ``sp``, `auto_parallel` the annotations, the cost-model
planner and the Engine, `resilience` the retry policy,
step guards, preemption handler and anomaly journal, `chaos` the seeded
fault injection, and `fleet` the strategy facade, the topology, the
meta-optimizers, the heartbeat and join membership and
`run_with_fault_tolerance`.
"""
from . import api_extra  # noqa: F401
from . import auto_parallel  # noqa: F401
from . import chaos  # noqa: F401
from . import checkpoint  # noqa: F401
from . import collective  # noqa: F401
from . import communication  # noqa: F401
from . import env  # noqa: F401
from . import mesh  # noqa: F401
from . import moe  # noqa: F401
from . import models  # noqa: F401
from . import parallel_step  # noqa: F401
from . import quant_collective  # noqa: F401
from . import resilience  # noqa: F401
from . import sequence_parallel  # noqa: F401
from . import sharding  # noqa: F401
from . import utils  # noqa: F401
from . import xproc  # noqa: F401
from . import cloud_utils  # noqa: F401
from . import fleet  # noqa: F401
from . import hybrid3d  # noqa: F401
from . import parallel_with_gloo  # noqa: F401
from .api_extra import (  # noqa: F401
    ParallelMode,
    destroy_process_group,
    gloo_barrier,
    gloo_init_parallel_env,
    gloo_release,
    spawn,
    split,
)
from .chaos import FaultPlan  # noqa: F401
from .checkpoint import (  # noqa: F401
    Checkpointer,
    load_state_dict,
    save_state_dict,
)
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
from .communication import stream  # noqa: F401
from .env import ParallelEnv, get_rank, get_world_size  # noqa: F401
from .fleet.elastic import run_with_fault_tolerance  # noqa: F401
from .mesh import (PartitionSpec, global_mesh, init_mesh,  # noqa: F401
                   reset_mesh)
from .parallel_step import (  # noqa: F401
    DistributedTrainStep,
    shard_params_and_opt,
    sharding_of,
)
from .resilience import (  # noqa: F401
    DivergenceRollback,
    DivergenceSentinel,
    RetryPolicy,
    StepAbort,
    StepGuard,
    install_preemption_handler,
)
from .sequence_parallel import (  # noqa: F401
    RingAttention,
    ring_attention,
    ring_flash_attention,
    ulysses_attention,
)
from .auto_parallel import shard_op, shard_tensor  # noqa: F401
from .sharding import (  # noqa: F401
    group_sharded_parallel,
    save_group_sharded_model,
)
from .fleet.recompute import recompute, recompute_sequential  # noqa: F401,E402


def DataParallel(layers, **kwargs):
    """The reference's DataParallel is the identity (its gradient sync is
    compiled into the step); here `DistributedTrainStep` averages the
    gradients over the data ranks."""
    return layers
