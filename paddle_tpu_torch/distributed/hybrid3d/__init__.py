"""DP × TP × PP over the process mesh (counterpart of
paddle_tpu/distributed/hybrid3d).

* `Hybrid3DConfig` / `init_hybrid_mesh` / `build_gpt3d` (plan.py): one
  frozen, validated plan per run; it lays the process world out as the
  mesh and builds the pipelined GPT.
* `HybridTrainStep` (jit/hybrid_step.py, re-exported here and as
  `paddle_tpu_torch.jit.HybridTrainStep`): the train step over that
  mesh, ZeRO composed on the dp axis.
* `pipeline_gpipe` (schedule.py): the GPipe schedule, interchangeable
  with 1F1B behind the same `PipelineSpecs`.
* the int8 tensor-parallel placements (tp.py).
"""
from .plan import Hybrid3DConfig, build_gpt3d, init_hybrid_mesh  # noqa: F401
from .schedule import gpipe_ticks, pipeline_gpipe  # noqa: F401
from .tp import (  # noqa: F401
    column_parallel_spec, int8_tp_placement, row_parallel_spec,
    shard_int8_linear, shard_model_int8_tp, tp_axis)
from ...jit.hybrid_step import HybridTrainStep  # noqa: F401

__all__ = [
    "Hybrid3DConfig", "init_hybrid_mesh", "build_gpt3d",
    "HybridTrainStep", "pipeline_gpipe", "gpipe_ticks",
    "shard_int8_linear", "shard_model_int8_tp", "int8_tp_placement",
    "column_parallel_spec", "row_parallel_spec", "tp_axis",
]
