"""Pooling layers (counterpart of paddle_tpu/nn/layer/pooling.py): each
holds its functional's arguments under the reference's names."""

from .. import functional as F
from .layers import Layer

__all__ = [
    "MaxPool1D", "MaxPool2D", "MaxPool3D",
    "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D",
    "AvgPool1D", "AvgPool2D", "AvgPool3D",
    "AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
    "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
]


class _MaxPool(Layer):
    _n, _format = 2, "NCHW"

    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format=None,
                 name=None):
        super().__init__()
        self.ksize = kernel_size
        self.stride = stride
        self.padding = padding
        self.return_mask = return_mask
        self.ceil_mode = ceil_mode
        self.data_format = data_format or self._format

    def forward(self, x):
        return getattr(F, f"max_pool{self._n}d")(
            x, self.ksize, self.stride, self.padding,
            return_mask=self.return_mask, ceil_mode=self.ceil_mode,
            data_format=self.data_format)

    def extra_repr(self):
        return (f"kernel_size={self.ksize}, stride={self.stride}, "
                f"padding={self.padding}")


class MaxPool1D(_MaxPool):
    _n, _format = 1, "NCL"


class MaxPool2D(_MaxPool):
    pass


class MaxPool3D(_MaxPool):
    _n, _format = 3, "NCDHW"


class _AvgPool(Layer):
    _n, _format = 2, "NCHW"

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format=None,
                 name=None):
        super().__init__()
        self.ksize = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode
        self.exclusive = exclusive
        self.data_format = data_format or self._format

    def forward(self, x):
        if self._n == 1:
            return F.avg_pool1d(x, self.ksize, self.stride, self.padding,
                                exclusive=self.exclusive,
                                ceil_mode=self.ceil_mode,
                                data_format=self.data_format)
        return getattr(F, f"avg_pool{self._n}d")(
            x, self.ksize, self.stride, self.padding,
            ceil_mode=self.ceil_mode, exclusive=self.exclusive,
            data_format=self.data_format)

    def extra_repr(self):
        return (f"kernel_size={self.ksize}, stride={self.stride}, "
                f"padding={self.padding}")


class AvgPool1D(_AvgPool):
    """paddle's order: (kernel_size, stride, padding, exclusive,
    ceil_mode)."""
    _n, _format = 1, "NCL"

    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode, exclusive)


class AvgPool2D(_AvgPool):
    pass


class AvgPool3D(_AvgPool):
    _n, _format = 3, "NCDHW"


class _AdaptivePool(Layer):
    _n, _mode, _format = 2, "avg", "NCHW"

    def __init__(self, output_size, data_format=None, name=None):
        super().__init__()
        self._output_size = output_size
        self._data_format = data_format or self._format

    def forward(self, x):
        fn = getattr(F, f"adaptive_{self._mode}_pool{self._n}d")
        if self._mode == "max" or self._n == 1:
            return fn(x, self._output_size)
        return fn(x, self._output_size, self._data_format)


class AdaptiveAvgPool1D(_AdaptivePool):
    _n, _format = 1, "NCL"


class AdaptiveAvgPool2D(_AdaptivePool):
    pass


class AdaptiveAvgPool3D(_AdaptivePool):
    _n, _format = 3, "NCDHW"


class _AdaptiveMaxPool(_AdaptivePool):
    """Takes `return_mask` and returns the maxima alone, as the
    reference does."""
    _mode = "max"

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(output_size)


class AdaptiveMaxPool1D(_AdaptiveMaxPool):
    _n = 1


class AdaptiveMaxPool2D(_AdaptiveMaxPool):
    pass


class AdaptiveMaxPool3D(_AdaptiveMaxPool):
    _n = 3


class _MaxUnPool(Layer):
    _n, _format = 2, "NCHW"

    def __init__(self, kernel_size, stride=None, padding=0, data_format=None,
                 output_size=None, name=None):
        super().__init__()
        self.ksize = kernel_size
        self.stride = stride
        self.padding = padding
        self.data_format = data_format or self._format
        self.output_size = output_size

    def forward(self, x, indices):
        return getattr(F, f"max_unpool{self._n}d")(
            x, indices, self.ksize, self.stride, self.padding,
            self.data_format, self.output_size)


class MaxUnPool1D(_MaxUnPool):
    _n, _format = 1, "NCL"


class MaxUnPool2D(_MaxUnPool):
    pass


class MaxUnPool3D(_MaxUnPool):
    _n, _format = 3, "NCDHW"
