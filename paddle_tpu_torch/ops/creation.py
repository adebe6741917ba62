"""Tensor creation ops (counterpart of paddle_tpu/ops/creation.py).

paddle's default dtypes: a Python float (or a list of them) gives the
default dtype (float32), an int gives int64, a bool gives bool; a numpy
array keeps its dtype. A function with no tensor input creates on the
current device (`core.place.set_device`; CUDA until set, raising
without a GPU); `to_tensor(place=)` names one, and so does the port's
trailing `device=` keyword of `arange` (a model builds its position ids
on its own device). The `*_like` functions follow their input's
device.

The random functions draw from the port's explicit generators
(`core.rng.next_generator` on the target device, one per call),
never from torch's global one; `uniform(seed=n)` seeds its own. They
cannot reproduce jax's threefry draws and do not try to: shape, dtype,
range and moments are the reference's.
"""
import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core import place as place_mod
from ..core import rng
from ._helpers import cast, defop, tensor_of

__all__ = [
    "to_tensor", "zeros", "ones", "full", "empty", "zeros_like",
    "ones_like", "full_like", "empty_like", "arange", "linspace",
    "logspace", "eye", "rand", "randn", "normal", "uniform", "randint",
    "randperm", "bernoulli", "multinomial", "tril", "triu", "meshgrid",
    "diag", "diagflat", "diag_embed", "assign", "clone", "numel",
    "one_hot",
]


def _device(place=None):
    if place is None:
        return place_mod.current_device()
    if isinstance(place, torch.device):
        return place
    return place_mod.resolve_device(str(place).replace("gpu", "cuda"))


def _norm_shape(shape):
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def _dt(dtype, default=None):
    d = dtype_mod.convert_dtype(dtype)
    return d if d is not None else (default or dtype_mod.get_default_dtype())


def _item(v):
    return v.item() if isinstance(v, torch.Tensor) else v


@defop("to_tensor")
def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """A new tensor holding `data` (a copy), `requires_grad = not
    stop_gradient`."""
    d = dtype_mod.convert_dtype(dtype)
    if isinstance(data, torch.Tensor):
        t = data.detach().to(device=_device(place) if place is not None
                             else data.device, dtype=d, copy=True)
    else:
        arr = np.asarray(data)
        if d is None and not isinstance(data, np.ndarray):
            if arr.dtype == np.float64:
                d = dtype_mod.get_default_dtype()
            elif arr.dtype.kind in "iu":
                d = torch.int64
        if arr.dtype.kind in "iufcb":
            t = torch.from_numpy(np.array(arr, copy=True))
        else:
            t = torch.tensor(arr.tolist())
        t = t.to(device=_device(place), dtype=d)
    if not stop_gradient:
        t.requires_grad_(True)
    return t


@defop("zeros")
def zeros(shape, dtype=None, name=None):
    return torch.zeros(_norm_shape(shape), dtype=_dt(dtype), device=_device())


@defop("ones")
def ones(shape, dtype=None, name=None):
    return torch.ones(_norm_shape(shape), dtype=_dt(dtype), device=_device())


@defop("full")
def full(shape, fill_value, dtype=None, name=None):
    fill_value = _item(fill_value)
    if dtype is None:
        if isinstance(fill_value, bool):
            dtype = dtype_mod.bool_
        elif isinstance(fill_value, (int, np.integer)):
            dtype = dtype_mod.int64
    return torch.full(_norm_shape(shape), fill_value, dtype=_dt(dtype),
                      device=_device())


@defop("empty")
def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


@defop("zeros_like")
def zeros_like(x, dtype=None, name=None):
    return torch.zeros_like(tensor_of(x),
                            dtype=dtype_mod.convert_dtype(dtype))


@defop("ones_like")
def ones_like(x, dtype=None, name=None):
    return torch.ones_like(tensor_of(x), dtype=dtype_mod.convert_dtype(dtype))


@defop("full_like")
def full_like(x, fill_value, dtype=None, name=None):
    return torch.full_like(tensor_of(x), _item(fill_value),
                           dtype=dtype_mod.convert_dtype(dtype))


@defop("empty_like")
def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


@defop("arange")
def arange(start=0, end=None, step=1, dtype=None, name=None, device=None):
    """int64 when start, end and step are ints, else the default float
    dtype."""
    start, end, step = _item(start), _item(end), _item(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = (dtype_mod.int64
                 if all(isinstance(v, (int, np.integer))
                        for v in (start, end, step))
                 else dtype_mod.get_default_dtype())
    return torch.arange(start, end, step, dtype=_dt(dtype),
                        device=_device(device))


@defop("linspace")
def linspace(start, stop, num, dtype=None, name=None):
    return torch.linspace(_item(start), _item(stop), int(_item(num)),
                          dtype=_dt(dtype), device=_device())


@defop("logspace")
def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return torch.logspace(start, stop, int(num), base=base, dtype=_dt(dtype),
                          device=_device())


@defop("eye")
def eye(num_rows, num_columns=None, dtype=None, name=None):
    n = int(num_rows)
    m = n if num_columns is None else int(num_columns)
    return torch.eye(n, m, dtype=_dt(dtype), device=_device())


# ---- random ----
def _gen(device):
    return rng.next_generator(device)


@defop("rand")
def rand(shape, dtype=None, name=None):
    dev = _device()
    return torch.rand(_norm_shape(shape), generator=_gen(dev),
                      dtype=_dt(dtype), device=dev)


@defop("randn")
def randn(shape, dtype=None, name=None):
    dev = _device()
    return torch.randn(_norm_shape(shape), generator=_gen(dev),
                       dtype=_dt(dtype), device=dev)


@defop("normal")
def normal(mean=0.0, std=1.0, shape=None, name=None):
    dev = _device()
    z = torch.randn(_norm_shape(() if shape is None else shape),
                    generator=_gen(dev), dtype=dtype_mod.get_default_dtype(),
                    device=dev)
    return z * std + mean


@defop("uniform")
def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    dev = _device()
    if seed:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    else:
        gen = _gen(dev)
    u = torch.rand(_norm_shape(shape), generator=gen, dtype=_dt(dtype),
                   device=dev)
    return u * (max - min) + min


@defop("randint")
def randint(low=0, high=None, shape=(1,), dtype=None, name=None):
    if high is None:
        low, high = 0, low
    dev = _device()
    return torch.randint(int(low), int(high), _norm_shape(shape),
                         generator=_gen(dev),
                         dtype=dtype_mod.convert_dtype(dtype)
                         or dtype_mod.int64, device=dev)


@defop("randperm")
def randperm(n, dtype=None, name=None):
    dev = _device()
    return torch.randperm(int(n), generator=_gen(dev),
                          dtype=dtype_mod.convert_dtype(dtype)
                          or dtype_mod.int64, device=dev)


@defop("bernoulli")
def bernoulli(x, name=None):
    x = tensor_of(x)
    return torch.bernoulli(x.detach(), generator=_gen(x.device))


@defop("multinomial")
def multinomial(x, num_samples=1, replacement=False, name=None):
    x = tensor_of(x).detach()
    probs = torch.clamp_min(x, 0.0)
    return torch.multinomial(probs, num_samples, replacement,
                             generator=_gen(x.device))


# ---- structured ----
@defop("tril")
def tril(x, diagonal=0, name=None):
    return torch.tril(tensor_of(x), diagonal)


@defop("triu")
def triu(x, diagonal=0, name=None):
    return torch.triu(tensor_of(x), diagonal)


@defop("meshgrid")
def meshgrid(*args, **kwargs):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = args[0]
    return list(torch.meshgrid(*(tensor_of(a) for a in args),
                               indexing="ij"))


@defop("diag")
def diag(x, offset=0, padding_value=0, name=None):
    """A 1-D input → the matrix with it on the `offset` diagonal (the
    rest `padding_value`, the positions marked by the identity rolled by
    `offset`, as the reference marks them); 2-D → that diagonal."""
    x = tensor_of(x)
    d = torch.diag(x, offset)
    if x.ndim == 1 and padding_value != 0:
        mask = torch.eye(d.shape[0], dtype=torch.bool, device=x.device)
        if offset:
            mask = torch.roll(mask, offset, dims=1)
        d = torch.where(mask, d, torch.tensor(padding_value, device=x.device
                                              ).to(d.dtype))
    return d


@defop("diagflat")
def diagflat(x, offset=0, name=None):
    return torch.diagflat(tensor_of(x), offset)


@defop("diag_embed")
def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):
    return torch.diag_embed(tensor_of(input), offset, dim1, dim2)


@defop("assign")
def assign(x, output=None):
    x = tensor_of(x)
    if output is None:
        return x.detach().clone()
    with torch.no_grad():
        output.copy_(x)
    return output


@defop("clone")
def clone(x, name=None):
    return tensor_of(x).clone()


@defop("numel")
def numel(x, name=None):
    x = tensor_of(x)
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


@defop("one_hot")
def one_hot(x, num_classes, name=None):
    """Default-dtype one-hot rows; an index outside [0, num_classes)
    gives a zero row, as jax.nn.one_hot does."""
    (x,) = cast("one_hot", tensor_of(x))
    cls = torch.arange(num_classes, device=x.device)
    return (x.long()[..., None] == cls).to(dtype_mod.get_default_dtype())
