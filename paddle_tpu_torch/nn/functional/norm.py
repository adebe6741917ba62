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

`global_batch_norm` is batch norm in training over a data-parallel
process world, where the reference's GSPMD step takes the statistics
of the global batch: one autograd Function (`_GlobalBatchNorm`) over
the port's mesh-axis collectives. Its forward gathers each rank's
(count, sum, centred sum of squares) per channel over the data axes
and merges them in rank order with Chan's formula, in float64 on the
host, so every rank holds the same f32 mean and biased variance; the
output and the running-statistics update both use them. Its backward
sums the statistics' cotangents over the same ranks — the per-channel
Σ dy and Σ dy·x̂ — so a rank's input gradient also carries what its
rows contribute to the other ranks' losses through the shared
statistics. The sum is the right scale: each rank differentiates the
mean loss of its own rows and the train step averages the gradients
over the data axes, so the averaged gradients are those of the mean
loss over the global batch. The weight and bias gradients are the
rank's own (the step averages them).

`layer_norm`, `group_norm`, `instance_norm`, `local_response_norm` and
`normalize` follow the reference's jnp formulas; each casts its inputs
by its op name.
"""
import numpy as np
import torch
import torch.nn.functional as tF

from ... import amp
from ...core import recompute as _recompute

__all__ = ["batch_norm", "global_batch_norm", "layer_norm", "group_norm",
           "instance_norm", "local_response_norm", "normalize"]

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


def _group_sum(rows, comm):
    """Σ over the data-parallel ranks of `rows` [k, C] (float64 numpy),
    added in rank order so every rank gets the same bits."""
    from ...distributed.collective import _gather_np

    if comm is None or len(comm) == 1:
        return rows, rows[None]
    mat = _gather_np(rows, comm)
    return mat.sum(0), mat


def _data_comm(axes):
    """The ranks of this process's group along `axes` (None when the
    process has no peers: the identity, as the port's collectives)."""
    from ...distributed import collective

    if not collective._multiprocess():
        return None
    members, _ = collective.axis_comm(axes)
    return members


class _GlobalBatchNorm(torch.autograd.Function):
    """Batch norm over the global batch of the data-parallel ranks
    (module docstring). xf: f32 with channels on dim 1."""

    @staticmethod
    def forward(ctx, xf, weight, bias, eps, members):
        axes = [d for d in range(xf.ndim) if d != 1]
        c = xf.shape[1]
        n = xf.numel() // c
        shape = [1, c] + [1] * (xf.ndim - 2)
        with torch.no_grad():
            mean_l = xf.mean(dim=axes)
            m2_l = ((xf - mean_l.reshape(shape)) ** 2).sum(dim=axes)
            local = np.stack([np.full(c, float(n)),
                              xf.sum(dim=axes).double().cpu().numpy(),
                              m2_l.double().cpu().numpy()])
        _, every = _group_sum(local, members)
        counts, sums, m2s = every[:, 0], every[:, 1], every[:, 2]
        total = counts.sum(0)
        mean = sums.sum(0) / total
        m2 = m2s.sum(0) + (counts * (sums / counts - mean) ** 2).sum(0)
        mean_t = torch.as_tensor(mean, dtype=torch.float32, device=xf.device)
        var_t = torch.as_tensor(m2 / total, dtype=torch.float32,
                                device=xf.device)
        rstd = torch.rsqrt(var_t + eps)
        w = (torch.ones_like(rstd) if weight is None else weight.float())
        b = (torch.zeros_like(rstd) if bias is None else bias.float())
        scale = (rstd * w).reshape(shape)
        out = xf * scale + (b - mean_t * rstd * w).reshape(shape)
        ctx.save_for_backward(xf, mean_t, rstd, w)
        ctx.mark_non_differentiable(mean_t, var_t)
        ctx.members, ctx.total = members, float(total[0])
        ctx.has_w, ctx.has_b = weight is not None, bias is not None
        return out, mean_t, var_t

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        xf, mean_t, rstd, w = ctx.saved_tensors
        axes = [d for d in range(xf.ndim) if d != 1]
        shape = [1, xf.shape[1]] + [1] * (xf.ndim - 2)
        xhat = (xf - mean_t.reshape(shape)) * rstd.reshape(shape)
        sdy = dy.sum(dim=axes)
        sdyx = (dy * xhat).sum(dim=axes)
        local = torch.stack([sdy, sdyx]).double().cpu().numpy()
        summed, _ = _group_sum(local, ctx.members)
        g = torch.as_tensor(summed, dtype=torch.float32, device=xf.device)
        dx = (w * rstd).reshape(shape) * (
            dy - (g[0] / ctx.total).reshape(shape)
            - xhat * (g[1] / ctx.total).reshape(shape))
        return (dx, sdyx if ctx.has_w else None, sdy if ctx.has_b else None,
                None, None)


def global_batch_norm(x, running_mean, running_var, weight=None, bias=None,
                      momentum=0.9, epsilon=1e-5, data_format="NCHW",
                      axes=("dp", "sharding")):
    """Batch norm in training with the statistics of the global batch
    over the data-parallel ranks along mesh `axes` (module docstring);
    the running statistics updated with them, as `batch_norm` does."""
    x, weight, bias = amp.cast_inputs_for("batch_norm", (x, weight, bias))
    channel_last = data_format in _CHANNEL_LAST
    xf = x.float()
    if channel_last:
        xf = xf.movedim(-1, 1)
    out, mean, var = _GlobalBatchNorm.apply(xf, weight, bias, epsilon,
                                            _data_comm(tuple(axes)))
    if running_mean is not None and not _recompute.in_recompute():
        with torch.no_grad():
            running_mean.copy_(running_mean * momentum + mean * (1 - momentum))
            running_var.copy_(running_var * momentum + var * (1 - momentum))
    if channel_last:
        out = out.movedim(1, -1)
    return out.to(x.dtype)


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
