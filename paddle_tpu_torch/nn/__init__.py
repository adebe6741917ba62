"""Layers and functional ops (counterpart of paddle_tpu/nn)."""
from . import functional  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue, clip_grad_norm_, clip_grad_value_)
from .layer import (Dropout, Embedding, LayerNorm, Linear,  # noqa: F401
                    MultiHeadAttention, ReLU, Sequential)
from .decode import BeamSearchDecoder, Decoder, dynamic_decode  # noqa: F401,E402
