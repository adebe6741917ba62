"""Convolution layers (counterpart of paddle_tpu/nn/layer/conv.py).

The weight is [out, in/groups, k…], or [in, out/groups, k…] for a
transpose, XavierUniform by default; the bias [out], zeros, absent with
`bias_attr=False`. Both come from `layers.create_parameter`, so
`weight_attr` / `bias_attr` take a `ParamAttr`, an initializer or False.
"""

from .. import functional as F
from .layers import Layer, create_parameter

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]


def _ntuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _ConvNd(Layer):
    _n = 2
    _transposed = False

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 device=None, dtype=None):
        super().__init__()
        n = self._n
        if in_channels % groups != 0:
            raise ValueError("in_channels must be divisible by groups")
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _ntuple(kernel_size, n)
        self._stride = _ntuple(stride, n)
        self._padding = padding
        self._output_padding = output_padding
        self._dilation = _ntuple(dilation, n)
        self._groups = groups
        self._data_format = data_format
        if self._transposed:
            shape = (in_channels, out_channels // groups) + self._kernel_size
        else:
            shape = (out_channels, in_channels // groups) + self._kernel_size
        kw = dict(dtype=dtype, device=device)
        self.weight = create_parameter(shape, weight_attr, **kw)
        self.bias = create_parameter((out_channels,), bias_attr, is_bias=True,
                                     **kw)

    def forward(self, x):
        fn = getattr(F, f"conv{self._n}d")
        return fn(x, self.weight, self.bias, self._stride, self._padding,
                  self._dilation, self._groups, self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")


class _ConvTransposeNd(_ConvNd):
    _transposed = True

    def forward(self, x, output_size=None):
        fn = getattr(F, f"conv{self._n}d_transpose")
        return fn(x, self.weight, self.bias, self._stride, self._padding,
                  self._output_padding, self._groups, self._dilation,
                  output_size, self._data_format)


def _conv_class(name, n, data_format):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format=data_format,
                 device=None, dtype=None):
        _ConvNd.__init__(self, in_channels, out_channels, kernel_size,
                         stride, padding, 0, dilation, groups, weight_attr,
                         bias_attr, data_format, device, dtype)

    return type(name, (_ConvNd,), {"_n": n, "__init__": __init__})


def _transpose_class(name, n, data_format):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format=data_format,
                 device=None, dtype=None):
        _ConvNd.__init__(self, in_channels, out_channels, kernel_size,
                         stride, padding, output_padding, dilation, groups,
                         weight_attr, bias_attr, data_format, device, dtype)

    return type(name, (_ConvTransposeNd,), {"_n": n, "__init__": __init__})


Conv1D = _conv_class("Conv1D", 1, "NCL")
Conv2D = _conv_class("Conv2D", 2, "NCHW")
Conv3D = _conv_class("Conv3D", 3, "NCDHW")
Conv1DTranspose = _transpose_class("Conv1DTranspose", 1, "NCL")
Conv2DTranspose = _transpose_class("Conv2DTranspose", 2, "NCHW")
Conv3DTranspose = _transpose_class("Conv3DTranspose", 3, "NCDHW")
