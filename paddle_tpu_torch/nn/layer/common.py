"""Common layers (counterpart of paddle_tpu/nn/layer/common.py).

Parameter layouts follow paddle, not torch: `Linear.weight` is
[in_features, out_features], so parameter names and shapes match the
JAX package's `state_dict` key for key. Parameters are created
uninitialized on the given device; the owning model initializes them
from an explicit `torch.Generator`.
"""
import torch
from torch import nn

from ...core import rng
from .. import functional as F

__all__ = ["Linear", "Embedding", "Dropout"]


def _param(shape, device, dtype):
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


class Linear(nn.Module):
    def __init__(self, in_features, out_features, has_bias=True,
                 device=None, dtype=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = _param((in_features, out_features), device, dtype)
        self.bias = (_param((out_features,), device, dtype) if has_bias
                     else None)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")


class Embedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, device=None,
                 dtype=None):
        super().__init__()
        self.weight = _param((num_embeddings, embedding_dim), device, dtype)

    def forward(self, x):
        return F.embedding(x, self.weight)


class Dropout(nn.Module):
    """paddle's "upscale_in_train" dropout. Identity in eval mode (every
    serving path); in training the keep mask is drawn from an explicit
    generator: the one given here, else the one installed by
    `core.rng.generator_scope` (TrainStep installs one per step), else a
    fresh `core.rng.next_generator`."""

    def __init__(self, p=0.5, generator=None):
        super().__init__()
        self.p = float(p)
        self.generator = generator

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        gen = (self.generator or rng.current_generator()
               or rng.next_generator(x.device))
        keep = torch.rand(x.shape, generator=gen, device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))
