"""Hybrid3DConfig — one validated description of a DP × TP × PP run
(counterpart of paddle_tpu/distributed/hybrid3d/plan.py).

The whole 3-axis plan is one frozen value that (a) lays the process
world out as the global mesh, (b) validates the model's divisibility up
front and (c) stamps itself into records (`describe`, `tag`). The public
axis is **tp**; it rides the mesh's ``mp`` axis. ZeRO composes on the
``dp`` axis by default (`zero_axis`): the dp ranks are the replica group
the optimizer state shards over.
"""
from dataclasses import dataclass
from typing import Optional

__all__ = ["Hybrid3DConfig", "init_hybrid_mesh", "build_gpt3d"]

_SCHEDULES = ("1f1b", "gpipe")
_ZERO_LEVELS = (None, "os", "os_g", "p_g_os")


@dataclass(frozen=True)
class Hybrid3DConfig:
    """Frozen plan for a 3D-parallel training run.

    dp/tp/pp: mesh degrees (tp rides the 'mp' mesh axis). n_micro: micro
    batches per global batch. schedule: '1f1b' or 'gpipe'. n_virtual:
    interleaved virtual stages per stage (1F1B only). remat: 'stage' |
    'layer' | False. zero: None | 'os' | 'os_g' | 'p_g_os' over
    `zero_axis` ('dp' or 'sharding'). sp: the sequence-parallel degree.
    quant_allreduce: the int8 dp gradient all-reduce (None defers to the
    PT_QUANT_ALLREDUCE_XLA env; `distributed.quant_collective`)."""
    dp: int = 1
    tp: int = 1
    pp: int = 1
    n_micro: int = 4
    schedule: str = "1f1b"
    n_virtual: int = 1
    remat: object = "stage"
    zero: Optional[str] = None
    zero_axis: str = "dp"
    sp: int = 1
    quant_allreduce: Optional[bool] = None

    def __post_init__(self):
        for name in ("dp", "tp", "pp", "n_micro", "n_virtual", "sp"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"{name}={v!r}: expected an int >= 1")
        if self.schedule not in _SCHEDULES:
            raise ValueError(
                f"schedule={self.schedule!r}: expected one of {_SCHEDULES}")
        if self.schedule == "gpipe" and self.n_virtual > 1:
            raise ValueError(
                "interleaved virtual stages are a 1F1B refinement; "
                "gpipe runs n_virtual=1")
        if self.zero not in _ZERO_LEVELS:
            raise ValueError(
                f"zero={self.zero!r}: expected one of {_ZERO_LEVELS}")
        if self.zero_axis not in ("dp", "sharding"):
            raise ValueError(
                f"zero_axis={self.zero_axis!r}: expected 'dp' or "
                "'sharding'")

    @property
    def n_devices(self):
        return self.dp * self.tp * self.pp * self.sp

    def mesh_kwargs(self):
        """Keyword args for `mesh.init_mesh` (tp → the 'mp' axis)."""
        return {"dp": self.dp, "pp": self.pp, "mp": self.tp,
                "sp": self.sp}

    def validate_model(self, gpt_config, moe=False):
        """Fail fast on the divisibility the pipeline needs (the model's
        messages, earlier). `moe=True` drops the ffn check."""
        if self.pp > 1 and gpt_config.num_layers % (
                self.pp * self.n_virtual):
            raise ValueError(
                f"num_layers={gpt_config.num_layers} not divisible by "
                f"pp*n_virtual={self.pp}*{self.n_virtual}")
        if self.tp > 1:
            dims = [(gpt_config.num_heads, "num_heads"),
                    (gpt_config.vocab_size, "vocab_size")]
            if not moe:
                dims.append((gpt_config.ffn_size, "ffn_size"))
            for dim, what in dims:
                if dim % self.tp:
                    raise ValueError(
                        f"{what}={dim} not divisible by tp={self.tp}")
        return self

    def describe(self):
        """Flat dict for records and telemetry labels."""
        return {
            "mesh_shape": {"dp": self.dp, "tp": self.tp, "pp": self.pp,
                           **({"sp": self.sp} if self.sp > 1 else {})},
            "n_micro": self.n_micro,
            "schedule": self.schedule,
            "n_virtual": self.n_virtual,
            "remat": self.remat if self.remat else "off",
            "zero": self.zero or "off",
            **({"quant_allreduce": True} if self.quant_allreduce
               else {}),
        }

    def tag(self):
        """Short config id, e.g. 'dp2.tp2.pp2-1f1b'."""
        parts = [f"dp{self.dp}", f"tp{self.tp}", f"pp{self.pp}"]
        if self.sp > 1:
            parts.append(f"sp{self.sp}")
        s = ".".join(parts) + f"-{self.schedule}"
        if self.n_virtual > 1:
            s += f"v{self.n_virtual}"
        if self.zero:
            s += f"-zero_{self.zero}"
        if self.quant_allreduce:
            s += "-q8"
        return s


def init_hybrid_mesh(config, devices=None):
    """Lay the process world out as the (dp, pp, mp[=tp], sp) mesh of
    `config`; the product must equal the world size (one process per
    mesh position). `devices` is the reference's device slice; the port's
    positions are processes, so it names the world size when given."""
    from .. import mesh as mesh_mod

    world = None if devices is None else len(devices)
    return mesh_mod.init_mesh(world_size=world, **config.mesh_kwargs())


def build_gpt3d(gpt_config, config, **model_kw):
    """PipelinedGPTForCausalLM wired for `config` (schedule, virtual
    stages, remat; divisibility validated up front)."""
    from ...text.models.gpt_pipeline import PipelinedGPTForCausalLM

    config.validate_model(gpt_config,
                          moe=bool(model_kw.get("moe_experts")))
    return PipelinedGPTForCausalLM(
        gpt_config, n_micro=config.n_micro, remat=config.remat,
        n_virtual=config.n_virtual, schedule=config.schedule, **model_kw)
