"""Activation ops (counterpart of paddle_tpu/ops/activation.py).

The functions are the port's `nn.functional` activations, the same
formulas under the same names (that module's docstring gives their AMP
casts and their generators); this module re-exports them as the tensor
API's and registers each under the reference's op name.
"""
from ..nn.functional.activation import (  # noqa: F401
    celu, elu, gelu, glu, gumbel_softmax, hardshrink, hardsigmoid,
    hardswish, hardtanh, leaky_relu, log_sigmoid, log_softmax, maxout, mish,
    prelu, relu, relu6, rrelu, selu, sigmoid, silu, softmax, softplus,
    softshrink, softsign, swish, tanh, tanhshrink, thresholded_relu)
from ._helpers import register_op

__all__ = [
    "relu", "relu6", "sigmoid", "silu", "swish", "tanh", "mish",
    "tanhshrink", "softsign", "log_sigmoid", "gelu", "leaky_relu", "elu",
    "selu", "celu", "hardtanh", "hardsigmoid", "hardswish", "hardshrink",
    "softshrink", "thresholded_relu", "softplus", "prelu", "rrelu",
    "softmax", "log_softmax", "gumbel_softmax", "maxout", "glu",
]

# the reference's module attribute (no default softplus is bound)
softplus_default = None

for _name in __all__:
    register_op("tanh_act" if _name == "tanh" else _name, globals()[_name])
