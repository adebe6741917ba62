"""Layers and functional ops (counterpart of paddle_tpu/nn)."""
from . import functional  # noqa: F401
from .layer import Dropout, Embedding, LayerNorm, Linear  # noqa: F401
