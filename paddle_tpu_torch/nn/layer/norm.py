"""Normalization layers (counterpart of paddle_tpu/nn/layer/norm.py).

The batch norms keep the reference's running statistics as buffers
named `_mean` (zeros) and `_variance` (ones), f32, so a reference
model's `state_dict` loads key for key; `F.batch_norm` updates them in
training (biased variance, paddle's momentum) and reads them in eval or
under `use_global_stats`.

`SyncBatchNorm` is plain batch norm, as in the reference, where GSPMD
computes over the global batch. The port runs one process per rank, so
a batch norm in training under a mesh whose data axes (dp × sharding,
the axes `DistributedTrainStep` cuts rows over) hold more than one rank
takes the global batch's statistics through `F.global_batch_norm`
(every batch-norm class alike, as in the reference); the sp ranks hold
the same rows and stay out of them.
"""
import numpy as np
import torch

from ... import amp
from ...core.dtype import resolve_dtype
from .. import functional as F
from .. import initializer as I
from .layers import Layer, create_parameter

__all__ = [
    "SpectralNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
    "BatchNorm3D", "SyncBatchNorm", "LayerNorm", "GroupNorm",
    "InstanceNorm1D", "InstanceNorm2D", "InstanceNorm3D",
    "LocalResponseNorm",
]


def _scale_and_shift(shape, weight_attr, bias_attr, device, dtype):
    weight = create_parameter(shape, weight_attr, dtype=dtype, device=device,
                              default_initializer=I.Constant(1.0))
    bias = create_parameter(shape, bias_attr, dtype=dtype, device=device,
                            is_bias=True)
    return weight, bias


def _data_parallel_ranks():
    from ...distributed import mesh

    return mesh.axis_size("dp") * mesh.axis_size("sharding")


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, device=None, dtype=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight, self.bias = _scale_and_shift(
            (num_features,), weight_attr, bias_attr, device, dtype)
        self.register_buffer("_mean", torch.zeros(
            num_features, dtype=torch.float32, device=device))
        self.register_buffer("_variance", torch.ones(
            num_features, dtype=torch.float32, device=device))

    def forward(self, input):
        if (self.training and not self._use_global_stats
                and _data_parallel_ranks() > 1):
            return F.global_batch_norm(
                input, self._mean, self._variance, self.weight, self.bias,
                momentum=self._momentum, epsilon=self._epsilon,
                data_format=self._data_format)
        return F.batch_norm(
            input, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}, momentum={self._momentum}"


class BatchNorm(_BatchNormBase):
    """The legacy fluid signature, with an optional activation by name."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, dtype="float32",
                 data_layout="NCHW", in_place=False, moving_mean_name=None,
                 moving_variance_name=None,
                 do_model_average_for_mean_and_var=True,
                 use_global_stats=False, trainable_statistics=False,
                 device=None):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout,
                         use_global_stats if use_global_stats else None,
                         device=device, dtype=dtype)
        self._act = act

    def forward(self, input):
        out = super().forward(input)
        if self._act:
            out = getattr(F, self._act)(out)
        return out


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None, device=None, dtype=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats,
                         device=device, dtype=dtype)


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica batch norm: plain batch norm over the batch it is
    given (module docstring)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """`layer` with every batch norm below it swapped for a
        SyncBatchNorm sharing its parameters and buffers."""
        out = layer
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, cls):
            out = cls(layer._num_features, layer._momentum, layer._epsilon,
                      False, False, layer._data_format)
            out.weight = layer.weight
            out.bias = layer.bias
            out._buffers.update(layer._buffers)
        for name, sub in list(layer._modules.items()):
            out._modules[name] = cls.convert_sync_batchnorm(sub)
        return out


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, device=None, dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight, self.bias = _scale_and_shift(
            self.normalized_shape, weight_attr, bias_attr, device, dtype)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight,
                            self.bias, self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}"


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, device=None, dtype=None):
        super().__init__()
        self._num_groups = num_groups
        self._num_channels = num_channels
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight, self.bias = _scale_and_shift(
            (num_channels,), weight_attr, bias_attr, device, dtype)

    def forward(self, input):
        return F.group_norm(input, self._num_groups, self._epsilon,
                            self.weight, self.bias, self._data_format)


class _InstanceNormBase(Layer):
    """The affine pair is `scale` and `bias`; `weight_attr=False` drops
    both, as in the reference."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, device=None, dtype=None):
        super().__init__()
        self._epsilon = epsilon
        if weight_attr is False:
            self.scale = self.bias = None
        else:
            self.scale, self.bias = _scale_and_shift(
                (num_features,), weight_attr, bias_attr, device, dtype)

    def forward(self, input):
        return F.instance_norm(input, weight=self.scale, bias=self.bias,
                               eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k
        self.data_format = data_format

    def forward(self, input):
        return F.local_response_norm(input, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)


class SpectralNorm(Layer):
    """weight / σ, σ the largest singular value of the weight reshaped
    to [shape[dim], rest], by power iteration from the buffers `weight_u`
    / `weight_v` (seeded as the reference seeds them), which each call
    updates."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32", device=None):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._eps = eps
        h = int(weight_shape[dim])
        w = int(np.prod(weight_shape)) // h
        self._h, self._w = h, w
        gen = np.random.default_rng(0)
        u = gen.standard_normal(h).astype(np.float32)
        v = gen.standard_normal(w).astype(np.float32)
        dt = resolve_dtype(dtype)
        self.register_buffer("weight_u", torch.tensor(
            u / (np.linalg.norm(u) + eps), dtype=dt, device=device))
        self.register_buffer("weight_v", torch.tensor(
            v / (np.linalg.norm(v) + eps), dtype=dt, device=device))

    def forward(self, weight):
        (weight,) = amp.cast_inputs_for("spectral_norm", (weight,))
        dim, h, w, eps = self._dim, self._h, self._w, self._eps
        perm = (dim,) + tuple(i for i in range(weight.ndim) if i != dim)
        m = weight.permute(perm).reshape(h, w)
        u, v = self.weight_u.clone(), self.weight_v.clone()
        for _ in range(self._power_iters):
            v = m.T @ u
            v = v / (torch.linalg.norm(v) + eps)
            u = m @ v
            u = u / (torch.linalg.norm(u) + eps)
        sigma = u @ m @ v
        with torch.no_grad():
            self.weight_u.copy_(u)
            self.weight_v.copy_(v)
        return weight / sigma
