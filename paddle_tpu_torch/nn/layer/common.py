"""Common layers (counterpart of paddle_tpu/nn/layer/common.py).

Parameter layouts follow paddle, not torch: `Linear.weight` is
[in_features, out_features], so parameter names and shapes match the
JAX package's `state_dict` key for key. Parameters are made by
`layers.create_parameter` under the reference's defaults (`Linear`:
XavierUniform weight, zero bias; `Embedding`: Normal(0, 1)) or the
`weight_attr` / `bias_attr` given; a model that has its own init (the
GPT's N(0, 0.02) from its `seed`) overwrites them.
"""
import torch
from torch import nn

from ...core import rng
from .. import functional as F
from .. import initializer as I
from .layers import create_parameter

__all__ = ["Linear", "Embedding", "Dropout"]


class Linear(nn.Module):
    """`has_bias=False` is `bias_attr=False`."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, has_bias=True, device=None,
                 dtype=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        kw = dict(dtype=dtype, device=device)
        self.weight = create_parameter((in_features, out_features),
                                       weight_attr, **kw)
        self.bias = create_parameter((out_features,),
                                     bias_attr if has_bias else False,
                                     is_bias=True, **kw)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")


class Embedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 name=None, device=None, dtype=None):
        super().__init__()
        self.weight = create_parameter(
            (num_embeddings, embedding_dim), weight_attr, dtype=dtype,
            device=device, default_initializer=I.Normal(0.0, 1.0))

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
