"""distributed.models (counterpart of paddle_tpu/distributed/models): the
MoE namespace; the implementation is distributed/moe.py."""
from . import moe  # noqa: F401
