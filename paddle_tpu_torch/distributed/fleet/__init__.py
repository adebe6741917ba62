"""fleet — the unified distributed facade (counterpart of
paddle_tpu/distributed/fleet/__init__.py).

`fleet.init(strategy=...)` lays the process world out as the strategy's
hybrid mesh and builds the `HybridCommunicateGroup`;
`distributed_optimizer` applies the strategy's meta-optimizers (lars,
dgc, localsgd) and its sharding stage (the ZeRO level
`DistributedTrainStep` takes). `TensorParallel` makes the replicated
parameters equal over the mp group; `PipelineParallel` (and
`distributed_model` at pp_degree > 1) wraps a layer stack in the
pipeline's `train_batch` / `eval_batch` (meta_parallel).
"""
from .. import collective as coll
from .. import env as env_mod
from .. import mesh as mesh_mod
from ..parallel_step import (DistributedTrainStep,  # noqa: F401
                             shard_params_and_opt)
from . import elastic  # noqa: F401
from . import meta_optimizers  # noqa: F401
from . import topology as topo_mod  # noqa: F401
from . import utils  # noqa: F401
from .topology import CommunicateTopology, HybridCommunicateGroup

__all__ = [
    "init", "is_first_worker", "worker_index", "worker_num",
    "barrier_worker", "distributed_model", "distributed_optimizer",
    "DistributedStrategy", "HybridCommunicateGroup", "CommunicateTopology",
    "get_hybrid_communicate_group", "DistributedTrainStep",
    "PipelineParallel", "TensorParallel", "ShardingParallel", "fleet",
    "shard_params_and_opt",
]

_SHARDING_STAGES = {1: "os", 2: "os_g", 3: "p_g_os"}


class DistributedStrategy:
    """Dict-backed strategy: hybrid degrees, amp, recompute, sharding
    stage, gradient merge and the meta-optimizer toggles."""

    def __init__(self):
        self.hybrid_configs = {
            "dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
            "sharding_degree": 1, "sp_degree": 1, "ep_degree": 1,
        }
        self.amp = False
        self.amp_configs = {"init_loss_scaling": 32768.0, "use_pure_fp16":
                            False, "use_bf16": True}
        self.recompute = False
        self.recompute_configs = {"checkpoints": []}
        self.sharding = False
        self.sharding_configs = {"stage": 1}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1,
                                 "micro_batch_size": 1}
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True
        self.lars = False
        self.lars_configs = {"lars_coeff": 0.001,
                             "lars_weight_decay": 0.0005,
                             "exclude_from_weight_decay": []}
        self.dgc = False
        self.dgc_configs = {"rampup_begin_step": 0, "sparsity": [0.01]}
        self.localsgd = False
        self.localsgd_configs = {"k_steps": 1}
        self.adaptive_localsgd = False
        self.adaptive_localsgd_configs = {"init_k_steps": 1}

    def __repr__(self):
        return f"DistributedStrategy(hybrid={self.hybrid_configs})"


class _Fleet:
    def __init__(self):
        self._hcg = None
        self._strategy = None
        self._initialized = False

    def init(self, role_maker=None, is_collective=True, strategy=None,
             log_level="INFO"):
        self._strategy = strategy or DistributedStrategy()
        hc = self._strategy.hybrid_configs
        mesh_mod.reset_mesh()
        self._hcg = HybridCommunicateGroup(
            dp_degree=hc.get("dp_degree", 1),
            mp_degree=hc.get("mp_degree", 1),
            pp_degree=hc.get("pp_degree", 1),
            sharding_degree=hc.get("sharding_degree", 1),
            sp_degree=hc.get("sp_degree", 1),
            ep_degree=hc.get("ep_degree", 1),
        )
        self._initialized = True
        return self

    def get_hybrid_communicate_group(self):
        return self._hcg

    def is_first_worker(self):
        return env_mod.get_rank() == 0

    def worker_index(self):
        return env_mod.get_rank()

    def worker_num(self):
        return env_mod.get_world_size()

    def barrier_worker(self):
        coll.barrier()

    def distributed_model(self, model):
        """Data parallelism and ZeRO need no wrapper (the train step
        reduces the gradients): the model itself. At pp_degree > 1 the
        `PipelineParallel` wrapper."""
        if self._hcg and self._hcg.get_pipe_parallel_world_size() > 1:
            return PipelineParallel(model, self._hcg, self._strategy)
        return model

    def distributed_optimizer(self, optimizer, strategy=None):
        """Apply the strategy: lars / dgc REPLACE the inner optimizer
        with the strategy optimizer over its learning rate and
        parameters; localsgd wraps `step` with the periodic parameter
        average; a sharding stage sets the ZeRO level."""
        st = strategy or self._strategy
        params = optimizer._params
        if st is not None and getattr(st, "lars", False):
            from ...optimizer import LarsMomentum

            cfg = st.lars_configs
            optimizer = LarsMomentum(
                optimizer._learning_rate,
                momentum=getattr(optimizer, "_momentum", 0.9),
                lars_coeff=cfg.get("lars_coeff", 0.001),
                lars_weight_decay=cfg.get("lars_weight_decay", 0.0005),
                exclude_from_weight_decay=cfg.get(
                    "exclude_from_weight_decay", []),
                grad_clip=optimizer._grad_clip, parameters=params)
        elif st is not None and getattr(st, "dgc", False):
            from .meta_optimizers import DGCMomentum

            sp = st.dgc_configs.get("sparsity", [0.999])
            optimizer = DGCMomentum(
                optimizer._learning_rate,
                momentum=getattr(optimizer, "_momentum", 0.9),
                sparsity=sp[0] if isinstance(sp, (list, tuple)) else sp,
                grad_clip=optimizer._grad_clip, parameters=params)
        if st is not None and (getattr(st, "localsgd", False)
                               or getattr(st, "adaptive_localsgd", False)):
            from .meta_optimizers import LocalSGD

            adaptive = getattr(st, "adaptive_localsgd", False)
            cfg = (st.adaptive_localsgd_configs if adaptive
                   else st.localsgd_configs)
            sync = LocalSGD(
                optimizer._parameter_list,
                k_steps=cfg.get("init_k_steps" if adaptive else "k_steps",
                                1),
                adaptive=adaptive)
            optimizer._localsgd = sync
            inner_step = optimizer.step

            def step_with_sync():
                out = inner_step()
                sync.step()
                return out

            optimizer.step = step_with_sync
        if st is not None and getattr(st, "sharding", False):
            optimizer._zero_level = _SHARDING_STAGES[int(
                st.sharding_configs.get("stage", 1))]
        optimizer._fleet_strategy = st
        return optimizer

    @property
    def strategy(self):
        return self._strategy


fleet = _Fleet()

# module-level API mirroring `paddle.distributed.fleet.*`
init = fleet.init
is_first_worker = fleet.is_first_worker
worker_index = fleet.worker_index
worker_num = fleet.worker_num
barrier_worker = fleet.barrier_worker
distributed_model = fleet.distributed_model
distributed_optimizer = fleet.distributed_optimizer
get_hybrid_communicate_group = fleet.get_hybrid_communicate_group


class TensorParallel:
    """The layers themselves, as the reference returns them, after their
    replicated (non-mp) parameters are broadcast over the mp group from
    its first rank: the Megatron layers' shards are each rank's own, and
    everything else must agree (GSPMD gives the reference that
    agreement)."""

    def __new__(cls, layers, hcg=None, **kwargs):
        from .utils.hybrid_parallel_util import broadcast_mp_parameters

        broadcast_mp_parameters(layers, hcg)
        return layers


class ShardingParallel:
    """ZeRO needs no wrapper: the layers themselves."""

    def __new__(cls, layers, hcg=None, **kwargs):
        return layers


def PipelineParallel(layers, hcg=None, strategy=None):
    from .meta_parallel.pipeline_parallel import PipelineParallel as PP

    return PP(layers, hcg, strategy)
