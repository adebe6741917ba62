"""Activations (counterpart of paddle_tpu/ops/activation.py and the
activations paddle_tpu/nn/functional/__init__.py:7-35 re-exports).

Each function casts its inputs under AMP by the reference's op name
(`amp.cast_inputs_for`): `softmax` and `log_softmax` are black-listed
(f32 under O1 and O2), the rest follow their input under O1 and go down
to bfloat16 under O2. The formulas are the reference's jnp ones,
including softplus' double `where` (the unselected exp branch stays
finite) and selu's and hardsigmoid's parameters. `rrelu` in training
and `gumbel_softmax` draw from an explicit generator: the one
`core.rng.generator_scope` installs (TrainStep installs one a step),
else a fresh `core.rng.next_generator`.
"""
import torch
import torch.nn.functional as tF

from ... import amp
from ...core import rng

__all__ = [
    "celu", "elu", "gelu", "glu", "gumbel_softmax", "hardshrink",
    "hardsigmoid", "hardswish", "hardtanh", "leaky_relu", "log_sigmoid",
    "log_softmax", "maxout", "mish", "prelu", "relu", "relu6", "rrelu",
    "selu", "sigmoid", "silu", "softmax", "softplus", "softshrink",
    "softsign", "swish", "tanh", "tanhshrink", "thresholded_relu",
]


def _cast(op, x):
    (x,) = amp.cast_inputs_for(op, (x,))
    return x


def _generator(device):
    return rng.current_generator() or rng.next_generator(device)


def relu(x, name=None):
    """max(x, 0) elementwise, in x's dtype."""
    return tF.relu(_cast("relu", x))


def relu6(x, name=None):
    """min(max(x, 0), 6); its gradient is 0 at 0 and at 6, as jax's
    (`torch.clamp`'s is 1 there)."""
    return tF.relu6(_cast("relu6", x))


def sigmoid(x, name=None):
    return torch.sigmoid(_cast("sigmoid", x))


def silu(x, name=None):
    return tF.silu(_cast("silu", x))


def swish(x, name=None):
    return tF.silu(_cast("swish", x))


def tanh(x, name=None):
    return torch.tanh(_cast("tanh", x))


def mish(x, name=None):
    x = _cast("mish", x)
    return x * torch.tanh(tF.softplus(x))


def tanhshrink(x, name=None):
    x = _cast("tanhshrink", x)
    return x - torch.tanh(x)


def softsign(x, name=None):
    x = _cast("softsign", x)
    return x / (1 + torch.abs(x))


def log_sigmoid(x, name=None):
    return tF.logsigmoid(_cast("log_sigmoid", x))


def gelu(x, approximate=False, name=None):
    """GELU; the default is the exact erf form, as in the JAX package
    (`jax.nn.gelu(approximate=False)`)."""
    return tF.gelu(_cast("gelu", x),
                   approximate="tanh" if approximate else "none")


def leaky_relu(x, negative_slope=0.01, name=None):
    x = _cast("leaky_relu", x)
    return torch.where(x >= 0, x, negative_slope * x)


def elu(x, alpha=1.0, name=None):
    return tF.elu(_cast("elu", x), alpha)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    x = _cast("selu", x)
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    return tF.celu(_cast("celu", x), alpha)


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return torch.clamp(_cast("hardtanh", x), min, max)


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return torch.clamp(slope * _cast("hardsigmoid", x) + offset, 0.0, 1.0)


def hardswish(x, name=None):
    x = _cast("hardswish", x)
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hardshrink(x, threshold=0.5, name=None):
    x = _cast("hardshrink", x)
    return torch.where(torch.abs(x) > threshold, x, torch.zeros_like(x))


def softshrink(x, threshold=0.5, name=None):
    x = _cast("softshrink", x)
    return torch.sign(x) * torch.clamp_min(torch.abs(x) - threshold, 0.0)


def thresholded_relu(x, threshold=1.0, name=None):
    x = _cast("thresholded_relu", x)
    return torch.where(x > threshold, x, torch.zeros_like(x))


def softplus(x, beta=1.0, threshold=20.0, name=None):
    x = _cast("softplus", x)
    big = beta * x > threshold
    safe = torch.where(big, torch.zeros_like(x), beta * x)
    return torch.where(big, x, (1.0 / beta) * torch.log1p(torch.exp(safe)))


def prelu(x, weight, data_format="NCHW", name=None):
    """where(x > 0, x, w · x); a per-channel `weight` broadcasts along
    the channel axis (1 for NC…, the last for N…C)."""
    x, weight = amp.cast_inputs_for("prelu", (x, weight))
    if weight.numel() > 1 and x.ndim > 1:
        shape = [1] * x.ndim
        shape[1 if data_format.startswith("NC") else x.ndim - 1] = \
            weight.numel()
        weight = weight.reshape(shape)
    return torch.where(x > 0, x, weight * x)


def rrelu(x, lower=0.125, upper=0.3333333, training=True, name=None):
    """Randomized leaky ReLU: in training each negative element's slope
    is drawn from U(lower, upper); in eval the slope is their mean."""
    x = _cast("rrelu", x)
    if training:
        gen = _generator(x.device)
        r = torch.rand(x.shape, generator=gen, device=gen.device,
                       dtype=x.dtype).to(x.device)
        r = r * (upper - lower) + lower
        return torch.where(x >= 0, x, r * x)
    return torch.where(x >= 0, x, (lower + upper) / 2.0 * x)


def softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(_torch_dtype(dtype))
    return torch.softmax(_cast("softmax", x), dim=axis)


def log_softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(_torch_dtype(dtype))
    return torch.log_softmax(_cast("log_softmax", x), dim=axis)


def _torch_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """softmax((x + g) / temperature) over `axis` with Gumbel noise g;
    `hard` returns the one-hot of its argmax with the soft gradient."""
    x = _cast("gumbel_softmax", x)
    gen = _generator(x.device)
    u = torch.rand(x.shape, generator=gen, device=gen.device,
                   dtype=x.dtype).to(x.device)
    u = u * (1.0 - 1e-20) + 1e-20
    g = -torch.log(-torch.log(u))
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = torch.argmax(y, dim=axis, keepdim=True)
        onehot = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = (onehot - y).detach() + y
    return y


def maxout(x, groups, axis=1, name=None):
    """The max over each run of `groups` consecutive channels of `axis`
    (C → C / groups)."""
    x = _cast("maxout", x)
    shape = list(x.shape)
    c = shape[axis]
    shape[axis:axis + 1] = [c // groups, groups]
    return x.reshape(shape).amax(dim=axis + 1)


def glu(x, axis=-1, name=None):
    return tF.glu(_cast("glu", x), dim=axis)
