"""distributed.parallel_with_gloo (counterpart of
paddle_tpu/distributed/parallel_with_gloo.py): the CPU process-group
bring-up, re-exported from api_extra."""
from .api_extra import (  # noqa: F401
    gloo_barrier, gloo_init_parallel_env, gloo_release)

__all__ = ["gloo_init_parallel_env", "gloo_barrier", "gloo_release"]
