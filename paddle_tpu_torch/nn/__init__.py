"""Layers and functional ops (counterpart of paddle_tpu/nn)."""
from . import functional  # noqa: F401
from .layer import (Dropout, Embedding, LayerNorm, Linear, ReLU,  # noqa: F401
                    Sequential)
from .decode import BeamSearchDecoder, Decoder, dynamic_decode  # noqa: F401,E402
