"""Activation layers (counterpart of paddle_tpu/nn/layer/activation.py)."""
from torch import nn

from .. import functional as F

__all__ = ["ReLU"]


class ReLU(nn.Module):
    def forward(self, x):
        return F.relu(x)
