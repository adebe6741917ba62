"""Layers and functional ops (counterpart of paddle_tpu/nn)."""
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue, clip_grad_norm_, clip_grad_value_)
from .layer import *  # noqa: F401,F403
from .decode import BeamSearchDecoder, Decoder, dynamic_decode  # noqa: F401,E402
