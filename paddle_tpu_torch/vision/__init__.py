"""Vision (counterpart of paddle_tpu/vision): the models ported so far,
also re-exported flat (`paddle.vision.resnet50`), as the reference's."""
from . import models  # noqa: F401
from .models import *  # noqa: F401,F403
