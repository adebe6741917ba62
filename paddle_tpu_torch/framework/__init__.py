"""paddle.framework (counterpart of paddle_tpu/framework): `save` /
`load` and the seed controls."""
from . import io_state  # noqa: F401
from . import random  # noqa: F401
from .io_state import load, save  # noqa: F401
from .random import get_cuda_rng_state, seed, set_cuda_rng_state  # noqa: F401
