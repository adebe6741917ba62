"""paddle.save / paddle.load (counterpart of
paddle_tpu/framework/io_state.py).

A nested object (dicts, lists, tuples) is pickled with each tensor as a
`_TensorPayload` (a numpy array, whether it was a trainable Parameter,
its name), as the reference writes it; bfloat16 tensors are written as
float32 arrays (numpy has no bfloat16). `load` reads files of either
package: a pickled `paddle_tpu.framework.io_state._TensorPayload` maps
to this module's class without importing the reference. Tensors come
back on the CPU — a Parameter with `requires_grad` as it was trainable,
a plain tensor otherwise — or, with `return_numpy=True`, as the arrays.
"""
import os
import pickle

import numpy as np
import torch

__all__ = ["save", "load"]

_PROTO = 4


class _TensorPayload:
    """Pickle-stable tensor wrapper recording trainable-ness."""

    def __init__(self, array, trainable=None, name=None):
        self.array = array
        self.trainable = trainable
        self.name = name


def _array(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def _pack(obj):
    if isinstance(obj, torch.nn.Parameter):
        return _TensorPayload(_array(obj), bool(obj.requires_grad), None)
    if isinstance(obj, torch.Tensor):
        return _TensorPayload(_array(obj), None, None)
    if isinstance(obj, dict):
        return type(obj)((k, _pack(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v) for v in obj)
    return obj


def _unpack(obj, return_numpy):
    if isinstance(obj, _TensorPayload):
        if return_numpy:
            return obj.array
        t = torch.from_numpy(np.array(obj.array))
        if obj.trainable is not None:
            return torch.nn.Parameter(t, requires_grad=bool(obj.trainable))
        return t
    if isinstance(obj, dict):
        return type(obj)((k, _unpack(v, return_numpy))
                         for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(v, return_numpy) for v in obj)
    return obj


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if name == "_TensorPayload" and module.endswith(
                "framework.io_state"):
            return _TensorPayload
        return super().find_class(module, name)


def save(obj, path, protocol=_PROTO, **configs):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_pack(obj), f, protocol=protocol)


def load(path, **configs):
    with open(path, "rb") as f:
        obj = _Unpickler(f).load()
    return _unpack(obj, configs.get("return_numpy", False))
