"""The layer base class, parameter attributes and the one parameter
factory of the port's layers (counterpart of
paddle_tpu/nn/layer/layers.py).

`Layer` is the reference's base class as a subclass of `torch.nn.Module`,
so a port layer stays a torch module for autograd, `.to()`, the
optimizers and `convert.load_jax_state_dict`, and gains the reference's
surface: `full_name`, `create_parameter` / `create_tensor`,
`add_parameter` / `add_sublayer`, `sublayers` / `named_sublayers`, the
forward pre / post hooks with their `HookRemoveHelper`,
`set_state_dict` (missing and unexpected keys back), `astype`.

Where both classes name a method, the override takes either calling
convention, because torch calls these on every sublayer with its own
keywords: `state_dict(destination, include_sublayers, use_hook)` or
torch's `(destination, prefix, keep_vars)`; `register_buffer(...,
persistable)` or torch's `persistent`; `parameters(include_sublayers)`
/ `named_parameters(prefix, include_sublayers)` or torch's `recurse`;
`to(device, dtype, blocking)` with paddle's names ("gpu:0",
"bfloat16") or torch's arguments. `parameters()` is a list, as the
reference's.

`create_parameter(shape, attr, ...)` follows the reference: `attr=False`
gives no parameter (None), the initializer is the attribute's, else the
layer's default, else `XavierUniform` for a weight and `Constant(0.0)`
for a bias; `trainable=False` is `requires_grad=False` (the train steps
then leave it alone). `learning_rate` lands in `p.optimize_attr`, and
`regularizer` and `need_clip` on the parameter, where the port's
optimizers and clippers read them. `name` is kept on the attribute
only: a torch tensor's `name` is read-only, and the optimizers key a
parameter by its module path.
"""
import collections
import threading

import numpy as np
import torch
from torch import nn
from torch.utils.hooks import RemovableHandle

from .. import initializer as init_mod
from ...core.dtype import convert_dtype

__all__ = ["Layer", "HookRemoveHelper", "ParamAttr", "create_parameter"]


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, init_mod.Initializer):
            return ParamAttr(initializer=attr)
        raise TypeError(f"cannot convert {type(attr)} to ParamAttr")


@torch.no_grad()
def create_parameter(shape, attr=None, dtype=None, is_bias=False,
                     default_initializer=None, device=None):
    """An initialized `nn.Parameter` of `shape` under `attr`, or None
    when `attr` is False."""
    if attr is False:
        return None
    attr = ParamAttr._to_attr(attr)
    init = attr.initializer or default_initializer
    if init is None:
        init = init_mod.Constant(0.0) if is_bias else init_mod.XavierUniform()
    value = init._init(tuple(int(s) for s in shape),
                       convert_dtype(dtype or "float32"), device)
    p = nn.Parameter(value, requires_grad=bool(attr.trainable))
    p.optimize_attr = {"learning_rate": attr.learning_rate}
    p.regularizer = attr.regularizer
    p.need_clip = attr.need_clip
    return p


class HookRemoveHelper(RemovableHandle):
    """The handle a forward hook's registration returns: `remove()`
    drops the hook (torch's `RemovableHandle`, under paddle's name)."""

    @classmethod
    def _of(cls, handle):
        helper = cls.__new__(cls)
        helper.__setstate__(handle.__getstate__())
        return helper


_names = collections.Counter()
_names_lock = threading.Lock()


def _unique_name(base):
    with _names_lock:
        n = _names[base]
        _names[base] += 1
    return f"{base}_{n}"


def _camel_to_snake(name):
    return "".join(("_" + c.lower()) if c.isupper() and i else c.lower()
                   for i, c in enumerate(name))


def _to_device(device):
    """paddle's device names ("gpu", "gpu:1", "cpu", a Place) → torch's."""
    if device is None or isinstance(device, torch.device):
        return device
    if hasattr(device, "torch_device"):
        return device.torch_device()
    name = str(device)
    if name.startswith("gpu"):
        name = "cuda" + name[3:]
    return torch.device(name)


def _is_dtype_name(x):
    if isinstance(x, torch.dtype):
        return True
    if isinstance(x, str):
        try:
            convert_dtype(x)
            return True
        except ValueError:
            return False
    return isinstance(x, np.dtype)


class Layer(nn.Module):
    """paddle's `nn.Layer` over `torch.nn.Module`."""

    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        if name_scope is None:
            name_scope = _camel_to_snake(type(self).__name__)
        self._full_name = _unique_name(name_scope)
        self._dtype = convert_dtype(dtype) if dtype is not None else None

    def full_name(self):
        return self._full_name

    # ---- parameters, buffers, sublayers ----
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        return create_parameter(shape, attr, dtype or self._dtype
                                or "float32", is_bias, default_initializer)

    def create_tensor(self, name=None, persistable=None, dtype=None):
        t = torch.zeros([], dtype=convert_dtype(dtype or "float32"))
        t.persistable = bool(persistable)
        return t

    def register_buffer(self, name, tensor, persistable=True,
                        persistent=None):
        if persistent is not None:
            persistable = persistent
        if tensor is not None and not isinstance(tensor, torch.Tensor):
            tensor = torch.as_tensor(np.asarray(tensor))
        super().register_buffer(name, tensor, persistent=bool(persistable))
        return tensor

    def add_parameter(self, name, parameter):
        if parameter is not None and not isinstance(parameter,
                                                    nn.Parameter):
            raise TypeError(f"parameter {name} must be a Parameter, got "
                            f"{type(parameter)}")
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        if sublayer is not None and not isinstance(sublayer, nn.Module):
            raise TypeError(f"sublayer {name} must be a Layer")
        self.add_module(str(name), sublayer)
        return sublayer

    def parameters(self, include_sublayers=True, recurse=None):
        return list(super().parameters(
            recurse=include_sublayers if recurse is None else recurse))

    def named_parameters(self, prefix="", include_sublayers=True,
                         recurse=None, remove_duplicate=True):
        return super().named_parameters(
            prefix=prefix,
            recurse=include_sublayers if recurse is None else recurse,
            remove_duplicate=remove_duplicate)

    def buffers(self, include_sublayers=True, recurse=None):
        return list(super().buffers(
            recurse=include_sublayers if recurse is None else recurse))

    def named_buffers(self, prefix="", include_sublayers=True, recurse=None,
                      remove_duplicate=True):
        return super().named_buffers(
            prefix=prefix,
            recurse=include_sublayers if recurse is None else recurse,
            remove_duplicate=remove_duplicate)

    def sublayers(self, include_self=False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False,
                        layers_set=None):
        """(name, layer) pairs, depth first, each layer once."""
        if layers_set is None:
            layers_set = set()
        if include_self and id(self) not in layers_set:
            layers_set.add(id(self))
            yield prefix, self
        for name, layer in self._modules.items():
            if layer is None or id(layer) in layers_set:
                continue
            layers_set.add(id(layer))
            sub = prefix + "." + name if prefix else name
            yield sub, layer
            if isinstance(layer, Layer):
                yield from layer.named_sublayers(sub, False, layers_set)
            else:
                for n, m in layer.named_modules(prefix=sub):
                    if id(m) not in layers_set:
                        layers_set.add(id(m))
                        yield n, m

    # ---- hooks ----
    def register_forward_pre_hook(self, hook, *args, **kwargs):
        """hook(layer, inputs) → None or the new inputs."""
        return HookRemoveHelper._of(
            super().register_forward_pre_hook(hook, *args, **kwargs))

    def register_forward_post_hook(self, hook):
        """hook(layer, inputs, outputs) → None or the new outputs."""
        return HookRemoveHelper._of(super().register_forward_hook(hook))

    # ---- state ----
    def state_dict(self, *args, destination=None, prefix="",
                   keep_vars=False, include_sublayers=True, use_hook=True):
        """The parameters and persistable buffers by structured name.
        Positionally paddle's (destination, include_sublayers, use_hook);
        torch's (destination, prefix, keep_vars) by keyword, as torch
        calls each sublayer."""
        if args:
            destination = args[0]
            if len(args) > 1 and isinstance(args[1], str):
                prefix = args[1]
                keep_vars = args[2] if len(args) > 2 else keep_vars
            elif len(args) > 1:
                include_sublayers = args[1]
        if include_sublayers:
            return super().state_dict(destination=destination, prefix=prefix,
                                      keep_vars=keep_vars)
        if destination is None:
            destination = collections.OrderedDict()
        self._save_to_state_dict(destination, prefix, keep_vars)
        return destination

    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy each value into the parameter or buffer of its name
        (shapes checked); returns (missing, unexpected) names."""
        entries = dict(self.named_parameters(remove_duplicate=False))
        entries.update(self.named_buffers(remove_duplicate=False))
        unexpected = []
        for name, value in state_dict.items():
            target = entries.get(name)
            if target is None:
                unexpected.append(name)
                continue
            if not isinstance(value, torch.Tensor):
                value = torch.as_tensor(np.array(value))
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(
                    f"shape mismatch for {name}: loaded "
                    f"{tuple(value.shape)} vs expected {tuple(target.shape)}")
            target.copy_(value.to(device=target.device, dtype=target.dtype))
        missing = [n for n in entries if n not in state_dict]
        return missing, unexpected

    load_dict = set_state_dict

    # ---- dtype / device ----
    def to(self, *args, **kwargs):
        """paddle's to(device, dtype, blocking) — device "cpu" / "gpu:0"
        / a Place, dtype a name — or any form of torch's."""
        blocking = kwargs.pop("blocking", None)
        args = list(args)
        if len(args) == 3 and isinstance(args[2], bool):
            blocking = args.pop()
        if blocking is not None:
            kwargs["non_blocking"] = not blocking
        dtype = kwargs.pop("dtype", None)
        device = kwargs.pop("device", None)
        rest = []
        for a in args:
            if a is None:
                continue
            if _is_dtype_name(a):
                dtype = a
            elif isinstance(a, (str, torch.device)) or hasattr(
                    a, "torch_device"):
                device = a
            else:
                rest.append(a)
        if dtype is not None:
            dtype = convert_dtype(dtype)
            kwargs["dtype"] = dtype
            self._dtype = dtype
        if device is not None:
            kwargs["device"] = _to_device(device)
        return super().to(*rest, **kwargs)

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def float(self):
        return self.astype("float32")

    def bfloat16(self):
        return self.astype("bfloat16")

    def extra_repr(self):
        return ""
