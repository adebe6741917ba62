"""Layers (counterpart of paddle_tpu/nn/layer)."""
from . import (activation, common, container, conv, layers,  # noqa: F401
               loss, norm, pooling, rnn, transformer)
from .layers import Layer  # noqa: F401
