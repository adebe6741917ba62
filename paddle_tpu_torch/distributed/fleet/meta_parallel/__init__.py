"""Counterpart of paddle_tpu/distributed/fleet/meta_parallel: the
Megatron layers and their collectives (`mp_layers`, `mp_ops`), the
pipeline layer description (`pp_layers`), the 1F1B / interleaved
schedules (`pipeline_1f1b`) and `PipelineParallel`."""
from .mp_layers import (  # noqa: F401
    ColumnParallelLinear,
    ParallelCrossEntropy,
    RowParallelLinear,
    VocabParallelEmbedding,
    mark_sharding,
    shard_activation,
)
from .mp_ops import allreduce_mp, copy_to_mp  # noqa: F401
from .pipeline_1f1b import (  # noqa: F401
    PipelineSpecs,
    interleaved_pipeline_loss,
    interleaved_stacking_order,
    pipeline_1f1b,
    pipeline_forward_loss,
    schedule_ticks,
)
from .pipeline_parallel import PipelineParallel, spmd_pipeline  # noqa: F401
from .pp_layers import (  # noqa: F401
    LayerDesc,
    PipelineLayer,
    SegmentLayers,
    SharedLayerDesc,
)
