"""Containers (counterpart of paddle_tpu/nn/layer/container.py).

Sublayers are named "0", "1", ... (or by the names given), which are the
parameter-name prefixes, so a reference model's `state_dict` loads key
for key (`convert.load_jax_state_dict`). Each is torch's container and
a `Layer`.
"""
import collections

from torch import nn

from .layers import Layer

__all__ = ["Sequential", "LayerList", "ParameterList", "LayerDict"]


class Sequential(nn.Sequential, Layer):
    """paddle's Sequential: layers as positional arguments (named "0",
    "1", ...), one OrderedDict, or (name, layer) pairs."""

    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0],
                                           collections.OrderedDict):
            super().__init__(layers[0])
        elif layers and isinstance(layers[0], (list, tuple)):
            super().__init__(collections.OrderedDict(layers))
        else:
            super().__init__(*layers)

    def __getitem__(self, idx):
        if isinstance(idx, str):
            return self._modules[idx]
        return super().__getitem__(idx)


class LayerList(nn.ModuleList, Layer):
    """paddle's LayerList (`append`, `insert`, `extend`, indexing and
    slices, as torch's ModuleList)."""


class ParameterList(nn.ParameterList, Layer):
    """paddle's ParameterList over `nn.Parameter`s."""


class LayerDict(nn.ModuleDict, Layer):
    """paddle's LayerDict: sublayers by name, in insertion order."""
