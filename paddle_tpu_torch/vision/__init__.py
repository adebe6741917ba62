"""Vision (counterpart of paddle_tpu/vision): the models ported so far."""
from . import models  # noqa: F401
