"""Top-level API gap-closers (counterpart of paddle_tpu/ops/api_misc.py).

Small ops and utility symbols the reference exports from `paddle.*`.
`create_parameter` goes through the port's parameter factory
(`nn.layer.layers.create_parameter`) on the current device;
`get_cuda_rng_state` / `set_cuda_rng_state` read and restore the port's
generator streams (`core.rng`); `set_grad_enabled` is torch's. The
in-place `*_` forms write into their first argument through
`_helpers.inplace`, the one in-place wrapper the method table uses too.
"""
import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core import place as place_mod
from ._helpers import cast, defop, inplace, tensor_of
from .extras import index_add
from .manipulation import scatter, squeeze, unsqueeze
from .math import remainder, tanh

__all__ = [
    "add_n", "logit", "multiplex", "complex", "crop", "shard_index",
    "tril_indices", "triu_indices", "randint_like", "reverse",
    "broadcast_shape", "is_tensor", "is_complex", "is_floating_point",
    "is_integer", "is_empty", "rank", "shape", "tolist", "iinfo",
    "set_printoptions", "create_parameter", "set_grad_enabled",
    "disable_signal_handler", "get_cuda_rng_state", "set_cuda_rng_state",
    "squeeze_", "unsqueeze_", "tanh_", "scatter_", "remainder_",
    "index_add_", "check_shape",
]


@defop("add_n")
def add_n(inputs, name=None):
    """Elementwise sum of a list of same-shaped tensors."""
    if isinstance(inputs, torch.Tensor):
        inputs = [inputs]
    ts = cast("add_n", *(tensor_of(t) for t in inputs))
    out = ts[0]
    for t in ts[1:]:
        out = out + t
    return out


@defop("logit")
def logit(x, eps=None, name=None):
    (x,) = cast("logit", tensor_of(x))
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x) - torch.log1p(-x)


@defop("multiplex")
def multiplex(inputs, index, name=None):
    """Row-wise select: out[i] = inputs[index[i]][i]."""
    stacked = torch.stack(cast("multiplex", *(tensor_of(t) for t in inputs)))
    idx = tensor_of(index).reshape(-1).long()
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    return stacked[idx, rows]


def complex(real, imag, name=None):
    """A complex tensor from its real and imaginary parts."""
    return torch.complex(tensor_of(real), tensor_of(imag))


@defop("crop")
def crop(x, shape=None, offsets=None, name=None):
    """`x` cut to `shape` from `offsets` (-1 in shape keeps the rest;
    None offsets are 0)."""
    x = tensor_of(x)
    nd = x.ndim
    full = list(x.shape)

    def ints(v):
        if isinstance(v, torch.Tensor):
            v = v.tolist()
        return [int(s.item()) if isinstance(s, torch.Tensor) else int(s)
                for s in v]

    shape = full if shape is None else ints(shape)
    offsets = [0] * nd if offsets is None else ints(offsets)
    shape = [full[i] - offsets[i] if shape[i] == -1 else shape[i]
             for i in range(nd)]
    return x[tuple(slice(offsets[i], offsets[i] + shape[i])
                   for i in range(nd))]


@defop("shard_index")
def shard_index(input, index_num, nshards, shard_id, ignore_value=-1,
                name=None):
    """A global index → its shard-local index, `ignore_value` outside
    shard `shard_id`."""
    if not 0 <= shard_id < nshards:
        raise ValueError(
            f"shard_id {shard_id} out of range for nshards {nshards}")
    shard_size = (index_num + nshards - 1) // nshards
    v = tensor_of(input)
    return torch.where(torch.div(v, shard_size, rounding_mode="floor")
                       == shard_id, v % shard_size, ignore_value)


def _tri_indices(fn, row, col, offset, dtype):
    if col is None:
        col = row
    r, c = fn(row, offset, col)
    return torch.as_tensor(np.stack([r, c]),
                           dtype=dtype_mod.convert_dtype(dtype),
                           device=place_mod.current_device())


def tril_indices(row, col=None, offset=0, dtype="int64"):
    return _tri_indices(np.tril_indices, row, col, offset, dtype)


def triu_indices(row, col=None, offset=0, dtype="int64"):
    return _tri_indices(np.triu_indices, row, col, offset, dtype)


def randint_like(x, low=0, high=None, dtype=None, name=None):
    """randint shaped and typed after `x` (a float dtype holds integral
    values)."""
    from ..core import rng

    x = tensor_of(x)
    d = dtype_mod.convert_dtype(dtype) if dtype else x.dtype
    if high is None:
        low, high = 0, low
    ints = torch.randint(int(low), int(high), tuple(x.shape),
                         generator=rng.next_generator(x.device),
                         device=x.device)
    return ints.to(d)


def reverse(x, axis, name=None):
    """Deprecated alias of flip."""
    from .manipulation import flip

    return flip(x, axis)


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


# ----------------------------------------------------------- predicates

def is_tensor(x):
    return isinstance(x, torch.Tensor)


def _dtype_of(x):
    return x.dtype if isinstance(x, torch.Tensor) else x


def is_complex(x):
    return dtype_mod.is_complex(_dtype_of(x))


def is_floating_point(x):
    return dtype_mod.is_floating_point(_dtype_of(x))


def is_integer(x):
    return dtype_mod.is_integer(_dtype_of(x))


def is_empty(x, name=None):
    x = tensor_of(x)
    return torch.tensor(x.numel() == 0, device=x.device)


def rank(input, name=None):
    x = tensor_of(input)
    return torch.tensor(x.ndim, device=x.device)


def shape(input, name=None):
    """The shape as a 1-D int32 tensor."""
    x = tensor_of(input)
    return torch.tensor(list(x.shape), dtype=torch.int32, device=x.device)


def tolist(x):
    return tensor_of(x).tolist()


def check_shape(shape):
    """Validate a shape argument."""
    if isinstance(shape, torch.Tensor):
        return
    for s in shape:
        if not isinstance(s, torch.Tensor) and int(s) < -1:
            raise ValueError(f"invalid dim {s} in shape {shape}")


# ----------------------------------------------------------- utilities

class iinfo:
    """Integer dtype limits."""

    def __init__(self, dtype):
        info = torch.iinfo(dtype_mod.convert_dtype(dtype))
        self.min = int(info.min)
        self.max = int(info.max)
        self.bits = int(info.bits)
        self.dtype = dtype_mod.dtype_name(info.dtype)

    def __repr__(self):
        return (f"paddle.iinfo(min={self.min}, max={self.max}, "
                f"bits={self.bits}, dtype={self.dtype})")


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    torch.set_printoptions(precision=precision, threshold=threshold,
                           edgeitems=edgeitems, linewidth=linewidth,
                           sci_mode=sci_mode)


def create_parameter(shape, dtype=None, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A standalone parameter on the current device: `attr`'s
    initializer, else `default_initializer`, else XavierUniform (a bias:
    zeros)."""
    from ..nn.layer.layers import ParamAttr
    from ..nn.layer.layers import create_parameter as _create

    attr = ParamAttr._to_attr(attr)
    if name is not None and attr.name is None:
        attr.name = name
    return _create(shape, attr, dtype=dtype_mod.dtype_name(
        dtype or "float32"), is_bias=is_bias,
        default_initializer=default_initializer,
        device=place_mod.current_device())


def set_grad_enabled(mode):
    """Context manager enabling / disabling autograd recording."""
    return torch.set_grad_enabled(mode)


def disable_signal_handler():
    """No-op: the port installs no signal handlers."""


def get_cuda_rng_state():
    """The port's generator streams' state (`core.rng.get_state`), as a
    one-element list."""
    from ..core import rng

    return [rng.get_state()]


def set_cuda_rng_state(state_list):
    from ..core import rng

    if state_list:
        rng.set_state(state_list[0])


# ------------------------------------------------- top-level inplace ops

squeeze_ = inplace(squeeze)
unsqueeze_ = inplace(unsqueeze)
tanh_ = inplace(tanh)
scatter_ = inplace(scatter)
remainder_ = inplace(remainder)
index_add_ = inplace(index_add)
