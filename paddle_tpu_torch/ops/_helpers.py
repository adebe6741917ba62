"""Op-definition helpers (counterpart of paddle_tpu/ops/_helpers.py).

The op registry (`register_op`, `get_op`, `list_ops`, `defop`) and the
builders of the generated elementwise and reduction ops. The reference
funnels every op through its autograd tape (`apply_jfn`,
`ensure_tensor`); torch's autograd records every op itself, so an op
here is a plain function on `torch.Tensor`. What the tape also did is
kept: each op casts its float inputs under AMP by its reference name
(`amp.cast_inputs_for`, the tape's one cast point), and a Python
scalar or numpy array where a tensor is expected becomes one by
`tensor_of` (the `to_tensor` rules, on the other operand's device).
"""
import numbers

import numpy as np
import torch

from .. import amp
from ..core import dtype as dtype_mod

__all__ = ["register_op", "get_op", "list_ops", "defop", "unary_op",
           "binary_op", "reduce_op", "tensor_of", "operand", "cast",
           "axes_of", "inplace"]

_OP_REGISTRY = {}


def register_op(name, fn):
    _OP_REGISTRY[name] = fn
    return fn


def get_op(name):
    return _OP_REGISTRY[name]


def list_ops():
    return sorted(_OP_REGISTRY)


def defop(name):
    """Decorator: register a hand-written op under `name`."""

    def deco(fn):
        fn.__name__ = name
        register_op(name, fn)
        return fn

    return deco


def cast(op_name, *tensors):
    """The inputs of `op_name` under the current AMP policy (a tuple)."""
    return amp.cast_inputs_for(op_name, tensors)


def tensor_of(x, dtype=None, like=None):
    """`x` itself when it is a tensor, else `to_tensor(x, dtype)` on
    `like`'s device (or the current device)."""
    if isinstance(x, torch.Tensor):
        return x
    from .creation import to_tensor

    dev = like.device if isinstance(like, torch.Tensor) else None
    return to_tensor(x, dtype=dtype, place=dev)


def inplace(fn):
    """`fn`'s in-place `*_` form: `fn(x, ...)` written into `x` by
    `copy_`, which autograd records (a leaf that requires grad refuses
    it); a result of another shape rebinds `x`'s data, as the
    reference's method rebinds its value. Returns `x`."""

    def method(x, *args, **kwargs):
        out = fn(x, *args, **kwargs)
        if out.shape != x.shape:
            x.data = out.detach()
            return x
        return x.copy_(out)

    method.__name__ = method.__qualname__ = fn.__name__ + "_"
    method.__doc__ = f"In-place `{fn.__name__}`: see `inplace`."
    return method


def _scalar_dtype_for(scalar, tensor):
    """The dtype a Python scalar takes beside `tensor` (reference :84):
    an int or float next to a floating tensor takes the tensor's dtype;
    otherwise the scalar's own default (None)."""
    td = tensor.dtype
    if isinstance(scalar, bool):
        return None
    if isinstance(scalar, (int, float)) and dtype_mod.is_floating_point(td):
        return td
    return None


def _is_scalar(v):
    return isinstance(v, (numbers.Number, np.number, np.bool_))


def operand(v, like):
    """A binary op's other operand beside the tensor `like`: a Python
    scalar becomes a 0-d tensor, which torch's promotion ranks below a
    dimensioned tensor of its kind, as jnp ranks a weakly typed scalar
    (float32 + 2.0 stays float32, int32 + 2 stays int32); anything else
    goes through `tensor_of`."""
    if isinstance(v, torch.Tensor):
        return v
    if _is_scalar(v):
        d = _scalar_dtype_for(v, like)
        return torch.tensor(v.item() if isinstance(v, np.generic) else v,
                            dtype=d, device=like.device)
    return tensor_of(v, like=like)


def unary_op(name, tfn, doc=None):
    """Build `op(x, name=None)` from a torch function."""

    def op(x, name=None):
        (x,) = cast(op.__name__, tensor_of(x))
        return tfn(x)

    op.__name__ = name
    op.__qualname__ = name
    op.__doc__ = doc or f"Elementwise {name}."
    register_op(name, op)
    return op


def binary_op(name, tfn, doc=None):
    """Build `op(x, y, name=None)`; either side may be a Python scalar
    (`operand`)."""

    def op(x, y, name=None):
        if isinstance(x, torch.Tensor):
            y = operand(y, x)
        elif isinstance(y, torch.Tensor):
            x = operand(x, y)
        else:
            x = tensor_of(x)
            y = operand(y, x)
        x, y = cast(op.__name__, x, y)
        return tfn(x, y)

    op.__name__ = name
    op.__qualname__ = name
    op.__doc__ = doc or f"Elementwise {name} with numpy broadcasting."
    register_op(name, op)
    return op


def axes_of(axis):
    """paddle's axis argument → torch's dim (None, an int or a tuple)."""
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return None if axis is None else int(axis)


def reduce_op(name, tfn, doc=None):
    """Build `op(x, axis=None, keepdim=False, name=None)` from
    `tfn(x, dim, keepdim)` (dim None: over every element)."""

    def op(x, axis=None, keepdim=False, name=None):
        (x,) = cast(op.__name__, tensor_of(x))
        return tfn(x, axes_of(axis), keepdim)

    op.__name__ = name
    op.__qualname__ = name
    op.__doc__ = doc or f"Reduction {name} over axis."
    register_op(name, op)
    return op
