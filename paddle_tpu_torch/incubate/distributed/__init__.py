"""incubate.distributed (counterpart of
paddle_tpu/incubate/distributed): the MoE models at the reference's
incubate path; the implementation is distributed/moe.py."""
from . import models  # noqa: F401
