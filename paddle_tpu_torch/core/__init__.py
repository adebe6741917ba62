"""Device, dtype, random streams, flags and errors (counterpart of
paddle_tpu/core)."""
from . import dtype, enforce, flags, place, rng  # noqa: F401
from .dtype import resolve_dtype  # noqa: F401
from .place import (CPUPlace, CUDAPlace, Place, TPUPlace,  # noqa: F401
                    get_device, get_place, resolve_device, set_device)
