"""Normalization functionals (counterpart of
paddle_tpu/nn/functional/norm.py).

`batch_norm` in training takes its statistics in f32 whatever the input
dtype, normalizes with the biased variance, returns the input's dtype,
and updates the running statistics in place as the reference does
(:73-74): running · momentum + batch · (1 − momentum), paddle's
momentum (0.9 by default), the variance biased too. The output is
torch's `batch_norm` in training mode with no running statistics
(cuDNN on the card: its normalization is the biased one), so torch's
own update, unbiased and with the opposite momentum, never touches the
buffers; the statistics come from one `var_mean` outside autograd. The
update is skipped inside a recompute (`core.recompute`), so a
checkpointed step updates once. In eval (or `use_global_stats`) the
running statistics normalize, by the reference's formula.
`batch_norm` and `batch_norm_infer` are black-listed under AMP: a bf16
conv output enters as f32 and leaves as f32.

`layer_norm`, `group_norm`, `instance_norm`, `local_response_norm` and
`normalize` follow the reference's jnp formulas; each casts its inputs
by its op name.
"""
import torch
import torch.nn.functional as tF

from ... import amp
from ...core import recompute as _recompute

__all__ = ["batch_norm", "layer_norm", "group_norm", "instance_norm",
           "local_response_norm", "normalize"]

_CHANNEL_LAST = ("NHWC", "NLC", "NDHWC")


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    channel_last = data_format in _CHANNEL_LAST
    if use_global_stats is None:
        use_global_stats = not training
    if not use_global_stats:
        x, weight, bias = amp.cast_inputs_for("batch_norm", (x, weight, bias))
        xf = x.float()
        if channel_last:
            xf = xf.movedim(-1, 1)
        out = tF.batch_norm(
            xf, None, None,
            None if weight is None else weight.float(),
            None if bias is None else bias.float(),
            True, 0.0, epsilon)
        if channel_last:
            out = out.movedim(1, -1)
        if (training and running_mean is not None
                and not _recompute.in_recompute()):
            axes = [d for d in range(xf.ndim) if d != 1]
            with torch.no_grad():
                var, mean = torch.var_mean(xf, dim=axes, correction=0)
                running_mean.copy_(running_mean * momentum
                                   + mean * (1 - momentum))
                running_var.copy_(running_var * momentum
                                  + var * (1 - momentum))
        return out.to(x.dtype)
    x, running_mean, running_var, weight, bias = amp.cast_inputs_for(
        "batch_norm_infer", (x, running_mean, running_var, weight, bias))
    shape = [1] * x.ndim
    shape[-1 if channel_last else 1] = -1
    out = (x - running_mean.reshape(shape)) / torch.sqrt(
        running_var.reshape(shape) + epsilon)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """LayerNorm over the trailing `normalized_shape` dims; black-listed
    under AMP, so it runs in f32."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    x, weight, bias = amp.cast_inputs_for("layer_norm", (x, weight, bias))
    return tF.layer_norm(x, tuple(normalized_shape), weight, bias, epsilon)


def _affine(out, weight, bias, shape):
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    x, weight, bias = amp.cast_inputs_for("group_norm", (x, weight, bias))
    channel_last = data_format == "NHWC"
    if channel_last:
        x = x.movedim(-1, 1)
    n, c = x.shape[0], x.shape[1]
    g = x.reshape((n, num_groups, c // num_groups) + tuple(x.shape[2:]))
    axes = tuple(range(2, g.ndim))
    var, mean = torch.var_mean(g, dim=axes, correction=0, keepdim=True)
    out = ((g - mean) / torch.sqrt(var + epsilon)).reshape(x.shape)
    out = _affine(out, weight, bias, (1, c) + (1,) * (x.ndim - 2))
    return out.movedim(1, -1) if channel_last else out


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Per sample and channel over the spatial dims; like the reference
    it always uses the input's statistics and never reads or updates
    running ones."""
    x, weight, bias = amp.cast_inputs_for("instance_norm", (x, weight, bias))
    axes = tuple(range(2, x.ndim))
    var, mean = torch.var_mean(x, dim=axes, correction=0, keepdim=True)
    out = (x - mean) / torch.sqrt(var + eps)
    return _affine(out, weight, bias, (1, x.shape[1]) + (1,) * (x.ndim - 2))


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """x / (k + alpha · Σ x²)^beta, the sum over `size` neighbouring
    channels ((size − 1) // 2 below, the rest above, zero past the
    edges); alpha is not divided by size, as in the reference."""
    (x,) = amp.cast_inputs_for("local_response_norm", (x,))
    ch = 1 if data_format.startswith("NC") else x.ndim - 1
    c = x.shape[ch]
    lo = (size - 1) // 2
    pads = [0, 0] * x.ndim
    pads[2 * (x.ndim - 1 - ch)] = lo
    pads[2 * (x.ndim - 1 - ch) + 1] = size - 1 - lo
    sq = tF.pad(x * x, pads)
    acc = torch.zeros_like(x)
    for i in range(size):
        acc = acc + sq.narrow(ch, i, c)
    return x / torch.pow(k + alpha * acc, beta)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """x / max(‖x‖_p, epsilon) along `axis`."""
    (x,) = amp.cast_inputs_for("normalize", (x,))
    if p == 2:
        n = torch.sqrt(torch.sum(x * x, dim=axis, keepdim=True))
    else:
        n = torch.sum(torch.abs(x) ** p, dim=axis,
                      keepdim=True) ** (1.0 / p)
    return x / torch.clamp_min(n, epsilon)
