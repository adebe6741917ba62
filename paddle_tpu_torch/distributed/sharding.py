"""ZeRO-style sharded data parallelism, the reference-shaped entry point
(counterpart of paddle_tpu/distributed/sharding.py).

The stages are placements that `DistributedTrainStep` carries out:
  stage 1/os     : optimizer states sharded over the 'sharding' axis
  stage 2/os_g   : + each rank updates from its block of the gradients
  stage 3/p_g_os : + parameters sharded, gathered for forward/backward
`group_sharded_parallel` records the level on the optimizer
(`_zero_level`), which a DistributedTrainStep built without its own
`zero_level` takes.
"""
from . import parallel_step as ps

__all__ = ["group_sharded_parallel", "save_group_sharded_model"]

_LEVELS = {"os": "os", "os_g": "os_g", "p_g_os": "p_g_os",
           1: "os", 2: "os_g", 3: "p_g_os"}


def group_sharded_parallel(model, optimizer, level="os_g", scaler=None,
                           group=None, offload=False, sync_buffers=False,
                           buffer_max_size=2**23, segment_size=2**20,
                           sync_comm=False):
    """Attach ZeRO placements; training must go through
    DistributedTrainStep (which reads them)."""
    lvl = _LEVELS[level]
    ps.shard_params_and_opt(model, optimizer, lvl)
    optimizer._zero_level = lvl
    if scaler is not None:
        return model, optimizer, scaler
    return model, optimizer


def save_group_sharded_model(model, output, optimizer=None):
    """`output`.pdparams (the model's state_dict) and, with an
    optimizer, `output`.pdopt (its state_dict), through `paddle.save`."""
    from ..framework.io_state import save

    save(model.state_dict(), output + ".pdparams")
    if optimizer is not None:
        save(optimizer.state_dict(), output + ".pdopt")
