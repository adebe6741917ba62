"""Activation layers (counterpart of paddle_tpu/nn/layer/activation.py):
each holds its function's arguments and calls it; `PReLU` holds its
slope parameter (`weight`, Constant(init) by default)."""

from .. import functional as F
from .. import initializer as I
from .layers import Layer, create_parameter

__all__ = [
    "CELU", "ELU", "GELU", "GLU", "Hardshrink", "Hardsigmoid", "Hardswish",
    "Hardtanh", "LeakyReLU", "LogSigmoid", "LogSoftmax", "Maxout", "Mish",
    "PReLU", "ReLU", "ReLU6", "RReLU", "SELU", "Sigmoid", "Silu", "Softmax",
    "Softmax2D", "Softplus", "Softshrink", "Softsign", "Swish", "Tanh",
    "Tanhshrink", "ThresholdedReLU",
]


def _layer(name, fname, *params):
    """A layer class over `F.<fname>`: its constructor takes `params` (a
    tuple of (argument, default) in the function's order) and `name`."""

    def __init__(self, *args, name=None, **kw):
        Layer.__init__(self)
        values = dict(params)
        values.update(zip([p for p, _ in params], args))
        values.update(kw)
        self._args = tuple(values[p] for p, _ in params)

    def forward(self, x):
        return getattr(F, fname)(x, *self._args)

    return type(name, (Layer,), {"__init__": __init__,
                                     "forward": forward})


ReLU = _layer("ReLU", "relu")
ReLU6 = _layer("ReLU6", "relu6")
Sigmoid = _layer("Sigmoid", "sigmoid")
Silu = _layer("Silu", "silu")
Swish = _layer("Swish", "swish")
Tanh = _layer("Tanh", "tanh")
Tanhshrink = _layer("Tanhshrink", "tanhshrink")
Softsign = _layer("Softsign", "softsign")
LogSigmoid = _layer("LogSigmoid", "log_sigmoid")
Mish = _layer("Mish", "mish")
Hardswish = _layer("Hardswish", "hardswish")
Hardsigmoid = _layer("Hardsigmoid", "hardsigmoid")
ELU = _layer("ELU", "elu", ("alpha", 1.0))
CELU = _layer("CELU", "celu", ("alpha", 1.0))
GELU = _layer("GELU", "gelu", ("approximate", False))
GLU = _layer("GLU", "glu", ("axis", -1))
Hardshrink = _layer("Hardshrink", "hardshrink", ("threshold", 0.5))
Hardtanh = _layer("Hardtanh", "hardtanh", ("min", -1.0), ("max", 1.0))
LeakyReLU = _layer("LeakyReLU", "leaky_relu", ("negative_slope", 0.01))
LogSoftmax = _layer("LogSoftmax", "log_softmax", ("axis", -1))
Maxout = _layer("Maxout", "maxout", ("groups", None), ("axis", 1))
SELU = _layer("SELU", "selu", ("scale", 1.0507009873554805),
              ("alpha", 1.6732632423543772))
Softmax = _layer("Softmax", "softmax", ("axis", -1))
Softplus = _layer("Softplus", "softplus", ("beta", 1.0), ("threshold", 20.0))
Softshrink = _layer("Softshrink", "softshrink", ("threshold", 0.5))
ThresholdedReLU = _layer("ThresholdedReLU", "thresholded_relu",
                         ("threshold", 1.0))


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, device=None, dtype=None):
        super().__init__()
        self._data_format = data_format
        self.weight = create_parameter(
            (num_parameters,), weight_attr, dtype=dtype, device=device,
            default_initializer=I.Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)


class RReLU(Layer):
    """Random slopes in training, their mean in eval."""

    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None):
        super().__init__()
        self._lower, self._upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self._lower, self._upper, self.training)


class Softmax2D(Layer):
    """Softmax over the channel axis of [C, H, W] or [N, C, H, W]."""

    def forward(self, x):
        if x.ndim not in (3, 4):
            raise ValueError(
                f"Softmax2D expects 3D/4D input, got {x.ndim}D")
        return F.softmax(x, axis=-3)
