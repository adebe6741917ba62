"""Weight initializers (counterpart of paddle_tpu/nn/initializer).

An initializer is a function (shape, dtype, device) → tensor, called
when a layer creates its parameters (`nn.layer.layers.create_parameter`)
or on an existing parameter (`init(param)` refills it in place). The
fan rules, gains and bounds are the reference's; conv weights are
paddle's [out, in/groups, k…], so fan_in = in/groups · prod(k) and
fan_out = out · prod(k).

Random initializers draw from an explicit `torch.Generator`: the one
`core.rng.generator_scope` installs (the vision models install a CPU one
seeded from their `seed`, so one seed gives the same weights on the CPU
and on the card), else a fresh `core.rng.next_init_generator` on the
parameter's device. They draw on the generator's device and move the
values to the parameter's. The numbers differ from jax's for the same
seed: tests compare the deterministic initializers exactly and the
random ones by shape, bounds and moments.
"""
import math

import numpy as np
import torch

from ...core import rng
from ...core.dtype import convert_dtype as resolve_dtype

__all__ = [
    "Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
    "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
    "Assign", "Orthogonal", "Dirac", "Bilinear", "calculate_gain",
    "set_global_initializer",
]

_global_weight_init = None
_global_bias_init = None


def set_global_initializer(weight_init, bias_init=None):
    """paddle's `set_global_initializer`. The reference records the pair
    and its `create_parameter` does not read it; the port keeps that."""
    global _global_weight_init, _global_bias_init
    _global_weight_init = weight_init
    _global_bias_init = bias_init


def calculate_gain(nonlinearity, param=None):
    recipes = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "conv1d_transpose": 1.0, "conv2d_transpose": 1.0,
        "conv3d_transpose": 1.0, "tanh": 5.0 / 3, "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(
            2.0 / (1 + (param if param is not None else 0.01) ** 2)),
        "selu": 3.0 / 4,
    }
    if nonlinearity not in recipes:
        raise ValueError(f"unsupported nonlinearity: {nonlinearity}")
    return recipes[nonlinearity]


def _fans(shape):
    """(fan_in, fan_out): a vector's length for both, a matrix's [in,
    out], a conv kernel [out, in, *k]'s in·prod(k) and out·prod(k)."""
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


def _generator(device):
    return (rng.current_generator()
            or rng.next_init_generator(torch.device(device or "cpu")))


def _uniform(shape, low, high, device):
    gen = _generator(device)
    u = torch.rand(shape, generator=gen, device=gen.device)
    return u * (high - low) + low


def _normal(shape, device):
    gen = _generator(device)
    return torch.randn(shape, generator=gen, device=gen.device)


class Initializer:
    def _init(self, shape, dtype="float32", device=None):
        """A new tensor of `shape` on `device`."""
        raise NotImplementedError

    @torch.no_grad()
    def __call__(self, param, block=None):
        """Refill an existing parameter in place."""
        param.copy_(self._init(tuple(param.shape), param.dtype,
                               param.device))
        return param


def _out(values, dtype, device):
    return values.to(device=device or "cpu", dtype=resolve_dtype(dtype))


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _init(self, shape, dtype="float32", device=None):
        return torch.full(shape, float(self.value), device=device,
                          dtype=resolve_dtype(dtype))


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def _init(self, shape, dtype="float32", device=None):
        return _out(self.mean + self.std * _normal(shape, device), dtype,
                    device)


class TruncatedNormal(Initializer):
    """mean + std · a standard normal truncated to [-2, 2] (the
    reference's `jax.random.truncated_normal(k, -2, 2)`), drawn by the
    inverse CDF."""

    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def _init(self, shape, dtype="float32", device=None):
        hi = math.erf(2.0 / math.sqrt(2.0))
        lo = -hi
        z = torch.erfinv(_uniform(shape, lo, hi, device)) * math.sqrt(2.0)
        z = torch.clamp(z, -2.0, 2.0)
        return _out(self.mean + self.std * z, dtype, device)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, name=None):
        self.low, self.high = low, high

    def _init(self, shape, dtype="float32", device=None):
        return _out(_uniform(shape, self.low, self.high, device), dtype,
                    device)


class _Xavier(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _fans(self, shape):
        fi, fo = _fans(shape)
        return (self.fan_in if self.fan_in is not None else fi,
                self.fan_out if self.fan_out is not None else fo)


class XavierNormal(_Xavier):
    def _init(self, shape, dtype="float32", device=None):
        fi, fo = self._fans(shape)
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return _out(std * _normal(shape, device), dtype, device)


class XavierUniform(_Xavier):
    def _init(self, shape, dtype="float32", device=None):
        fi, fo = self._fans(shape)
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return _out(_uniform(shape, -limit, limit, device), dtype, device)


class _Kaiming(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _scale(self, shape):
        fi = self.fan_in if self.fan_in is not None else _fans(shape)[0]
        return calculate_gain(self.nonlinearity, self.negative_slope), fi


class KaimingNormal(_Kaiming):
    def _init(self, shape, dtype="float32", device=None):
        gain, fi = self._scale(shape)
        return _out(gain / math.sqrt(fi) * _normal(shape, device), dtype,
                    device)


class KaimingUniform(_Kaiming):
    def _init(self, shape, dtype="float32", device=None):
        gain, fi = self._scale(shape)
        limit = gain * math.sqrt(3.0 / fi)
        return _out(_uniform(shape, -limit, limit, device), dtype, device)


class Assign(Initializer):
    def __init__(self, value, name=None):
        self.value = value

    def _init(self, shape, dtype="float32", device=None):
        v = self.value
        v = (v.detach().cpu() if isinstance(v, torch.Tensor)
             else torch.as_tensor(np.asarray(v)))
        if tuple(v.shape) != tuple(shape):
            v = v.reshape(shape)
        return _out(v.clone(), dtype, device)


class Orthogonal(Initializer):
    def __init__(self, gain=1.0, name=None):
        self.gain = gain

    def _init(self, shape, dtype="float32", device=None):
        if len(shape) < 2:
            raise ValueError("Orthogonal init needs >=2 dims")
        rows = shape[0]
        cols = int(np.prod(shape[1:]))
        flat = _normal((max(rows, cols), min(rows, cols)), device).float()
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return _out((self.gain * q[:rows, :cols]).reshape(shape), dtype,
                    device)


class Dirac(Initializer):
    """Identity-preserving conv kernel: within each group, output
    channel i takes input channel i at the kernel's centre."""

    def __init__(self, groups=1, name=None):
        self.groups = groups

    def _init(self, shape, dtype="float32", device=None):
        if len(shape) not in (3, 4, 5):
            raise ValueError("Dirac init supports 3/4/5-D conv kernels")
        out_c, in_c = shape[0], shape[1]
        arr = np.zeros(shape, dtype=np.float32)
        per_group = out_c // self.groups
        centers = tuple(s // 2 for s in shape[2:])
        for g in range(self.groups):
            for i in range(min(per_group, in_c)):
                arr[(g * per_group + i, i) + centers] = 1.0
        return _out(torch.from_numpy(arr), dtype, device)


class Bilinear(Initializer):
    """Bilinear-upsampling kernel for transposed convs: every (out, in)
    pair gets the separable triangle filter that interpolates
    linearly."""

    def _init(self, shape, dtype="float32", device=None):
        if len(shape) != 4:
            raise ValueError("Bilinear init expects a 4-D conv kernel")
        kh, kw = int(shape[2]), int(shape[3])
        fh, fw = (kh + 1) // 2, (kw + 1) // 2
        ch = (2 * fh - 1 - fh % 2) / (2.0 * fh)
        cw = (2 * fw - 1 - fw % 2) / (2.0 * fw)
        yy = 1 - np.abs(np.arange(kh) / fh - ch)
        xx = 1 - np.abs(np.arange(kw) / fw - cw)
        filt = np.outer(yy, xx).astype("float32")
        weight = np.broadcast_to(filt, tuple(shape)).copy()
        return _out(torch.from_numpy(weight), dtype, device)
