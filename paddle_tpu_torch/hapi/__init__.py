"""The high-level training API, `paddle.Model` (counterpart of
paddle_tpu/hapi; reference python/paddle/hapi/model.py:915,
callbacks.py:1, dynamic_flops.py).

`Model.fit` drives one `jit.TrainStep` a batch; callbacks run on the
host between steps; `flops` counts a forward's multiply-accumulates by
forward hooks and `summary` tabulates the parameters.
"""
from .callbacks import (  # noqa: F401
    Callback,
    EarlyStopping,
    LRScheduler,
    ModelCheckpoint,
    ProgBarLogger,
    ReduceLROnPlateau,
)
from .dynamic_flops import flops  # noqa: F401
from .model import Model, summary  # noqa: F401

__all__ = [
    "Model",
    "summary",
    "flops",
    "Callback",
    "ProgBarLogger",
    "ModelCheckpoint",
    "LRScheduler",
    "EarlyStopping",
    "ReduceLROnPlateau",
]
