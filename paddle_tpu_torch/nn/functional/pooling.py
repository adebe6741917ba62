"""Pooling (counterpart of paddle_tpu/nn/functional/pooling.py).

The reference lowers every pooling to `lax.reduce_window`; the port
calls torch's pooling functions on the reference's windows:

- padding is an int or one int a spatial dim, or "SAME" / "VALID" (XLA's
  pairs, `conv.same_pads`); `ceil_mode` grows the high side so the last
  partial window is kept, by the reference's rule (`_grow_for_ceil`; a
  window starting in the padding is kept too, unlike torch's own
  `ceil_mode`). Padding torch's arguments cannot express (asymmetric,
  wider than half the window) is written with `F.pad`: -inf for max,
  zeros for avg;
- max pooling's gradient goes to the first maximal element of a window,
  as XLA's select-and-scatter does; `return_mask` gives each output's
  flat position in its channel's unpadded spatial plane (int32), the
  first maximal one on ties;
- avg pooling divides the window sum by the count of real (unpadded)
  elements when `exclusive` or with string padding, else by the window
  size;
- adaptive pooling uses the reference's bins: start ⌊i·in/out⌋, end
  ⌈(i+1)·in/out⌉, a reshape where out divides in; a max there passes
  its gradient to every tied maximum in equal parts, as `jnp.max` does;
- `max_unpool*` scatters each value back to its mask position (the
  last of several that share one), and drops positions outside the
  output.

Each op casts its inputs under AMP by the reference's op name (on no
list: unchanged under O1, bfloat16 under O2).
"""
import numpy as np
import torch
import torch.nn.functional as tF

from ... import amp
from .conv import _flat_pad, same_pads

__all__ = [
    "max_pool1d", "max_pool2d", "max_pool3d", "max_unpool1d",
    "max_unpool2d", "max_unpool3d", "avg_pool1d", "avg_pool2d",
    "avg_pool3d", "adaptive_avg_pool1d", "adaptive_avg_pool2d",
    "adaptive_avg_pool3d", "adaptive_max_pool1d", "adaptive_max_pool2d",
    "adaptive_max_pool3d",
]

_MAX = {1: tF.max_pool1d, 2: tF.max_pool2d, 3: tF.max_pool3d}


def _norm(v, n):
    if v is None:
        return None
    if isinstance(v, int):
        return (v,) * n
    v = tuple(int(x) for x in v)
    return v * n if len(v) == 1 else v


def _grow_for_ceil(sizes, kernel, stride, pairs):
    out = []
    for size, k, s, (lo, hi) in zip(sizes, kernel, stride, pairs):
        eff = size + lo + hi
        n_out = -(-(eff - k) // s) + 1 if eff >= k else 1
        out.append((lo, hi + max(0, (n_out - 1) * s + k - eff)))
    return out


def _window_sum(x, kernel, stride, pairs):
    """The sum of each window of channel-first `x` over zero padding."""
    if any(lo or hi for lo, hi in pairs):
        x = tF.pad(x, _flat_pad(pairs))
    if len(kernel) == 1:
        return tF.avg_pool2d(x.unsqueeze(-1), (kernel[0], 1),
                             (stride[0], 1), divisor_override=1).squeeze(-1)
    pool = tF.avg_pool2d if len(kernel) == 2 else tF.avg_pool3d
    return pool(x, kernel, stride, divisor_override=1)


def _max(x, kernel, stride, pairs, return_mask):
    n = len(kernel)
    if all(lo == hi and lo <= k // 2 for (lo, hi), k in zip(pairs, kernel)):
        res = _MAX[n](x, kernel, stride, tuple(lo for lo, _ in pairs),
                      return_indices=return_mask)
        if not return_mask:
            return res
        return res[0], res[1].to(torch.int32)
    xp = tF.pad(x, _flat_pad(pairs), value=-float("inf"))
    res = _MAX[n](xp, kernel, stride, 0, return_indices=return_mask)
    if not return_mask:
        return res
    out, idx = res
    # the padded plane's flat position → the unpadded plane's
    flat = torch.zeros_like(idx)
    rest = idx
    for d in range(n - 1, -1, -1):
        padded = xp.shape[2 + d]
        coord = rest % padded - pairs[d][0]
        rest = rest // padded
        flat = flat + coord * int(np.prod(x.shape[2 + d + 1:]))
    return out, flat.to(torch.int32)


def _pool(x, n, kernel, stride, padding, mode, ceil_mode, exclusive,
          channel_last, return_mask=False):
    kernel = _norm(kernel, n)
    stride = _norm(stride, n) or kernel
    op = (f"max_pool{n}d_with_mask" if mode == "max" and return_mask
          else f"{mode}_pool{n}d")
    (x,) = amp.cast_inputs_for(op, (x,))
    if channel_last:
        x = x.movedim(-1, 1)
    sizes = tuple(x.shape[2:])
    string = isinstance(padding, str)
    if string:
        if mode == "max" and return_mask:
            raise ValueError("return_mask with string padding is unsupported")
        pairs = (same_pads(sizes, kernel, stride)
                 if padding.upper() == "SAME" else [(0, 0)] * n)
    else:
        pairs = [(p, p) for p in _norm(padding, n)]
        if ceil_mode:
            pairs = _grow_for_ceil(sizes, kernel, stride, pairs)
    if mode == "max":
        out = _max(x, kernel, stride, pairs, return_mask)
    else:
        s = _window_sum(x, kernel, stride, pairs)
        if string or exclusive:
            cnt = _window_sum(torch.ones((1, 1) + sizes, dtype=x.dtype,
                                         device=x.device),
                              kernel, stride, pairs)
            out = s / cnt
        else:
            out = s / float(np.prod(kernel))
    if not channel_last:
        return out
    if isinstance(out, tuple):
        return tuple(t.movedim(1, -1) for t in out)
    return out.movedim(1, -1)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool(x, 1, kernel_size, stride, padding, "max", ceil_mode, True,
                 data_format == "NLC", return_mask)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    return _pool(x, 2, kernel_size, stride, padding, "max", ceil_mode, True,
                 data_format == "NHWC", return_mask)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _pool(x, 3, kernel_size, stride, padding, "max", ceil_mode, True,
                 data_format == "NDHWC", return_mask)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool(x, 1, kernel_size, stride, padding, "avg", ceil_mode,
                 exclusive, data_format == "NLC")


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool(x, 2, kernel_size, stride, padding, "avg", ceil_mode,
                 exclusive, data_format == "NHWC")


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool(x, 3, kernel_size, stride, padding, "avg", ceil_mode,
                 exclusive, data_format == "NDHWC")


def _max_unpool(x, indices, n, kernel, stride, padding, output_size,
                channel_last):
    kernel = _norm(kernel, n)
    stride = _norm(stride, n) or kernel
    p = _norm(padding, n)
    x, indices = amp.cast_inputs_for(f"max_unpool{n}d", (x, indices))
    if channel_last:
        x, indices = x.movedim(-1, 1), indices.movedim(-1, 1)
    in_spatial = tuple(x.shape[2:])
    if output_size is None:
        out_spatial = tuple((in_spatial[i] - 1) * stride[i] - 2 * p[i]
                            + kernel[i] for i in range(n))
    else:
        out_spatial = tuple(int(s) for s in output_size)[-n:]
    nb, c = x.shape[0], x.shape[1]
    lout = int(np.prod(out_spatial))
    idx = indices.reshape(nb, c, -1).long()
    # positions outside the output land in one spare slot, then drop
    idx = torch.where((idx >= 0) & (idx < lout), idx, lout)
    # where windows overlap, several values (equal: one input element's)
    # share a position; as in XLA's scatter, the last one is written and
    # takes the gradient
    order = torch.arange(idx.shape[-1], device=x.device).expand_as(idx)
    last = torch.full((nb, c, lout + 1), -1, dtype=torch.long,
                      device=x.device).scatter_reduce(2, idx, order, "amax")
    src = torch.where(last.gather(2, idx) == order, x.reshape(nb, c, -1), 0)
    out = torch.zeros((nb, c, lout + 1), dtype=x.dtype, device=x.device)
    out = out.scatter_add(2, idx, src)[..., :lout]
    out = out.reshape((nb, c) + out_spatial)
    return out.movedim(1, -1) if channel_last else out


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    return _max_unpool(x, indices, 1, kernel_size, stride, padding,
                       output_size, data_format == "NLC")


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    return _max_unpool(x, indices, 2, kernel_size, stride, padding,
                       output_size, data_format == "NHWC")


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    return _max_unpool(x, indices, 3, kernel_size, stride, padding,
                       output_size, data_format == "NDHWC")


def _adaptive(x, n, output_size, mode, channel_last):
    output_size = _norm(output_size, n)
    (x,) = amp.cast_inputs_for(f"adaptive_{mode}_pool{n}d", (x,))
    axes = (tuple(range(x.ndim - n - 1, x.ndim - 1)) if channel_last
            else tuple(range(x.ndim - n, x.ndim)))
    out = x
    for ax, out_s in zip(axes, output_size):
        in_s = out.shape[ax]
        if in_s % out_s == 0:
            r = out.reshape(out.shape[:ax] + (out_s, in_s // out_s)
                            + out.shape[ax + 1:])
            out = r.amax(dim=ax + 1) if mode == "max" else r.mean(dim=ax + 1)
            continue
        starts = (np.arange(out_s) * in_s) // out_s
        ends = -(-((np.arange(out_s) + 1) * in_s) // out_s)
        segs = [out.narrow(ax, int(s0), int(e0 - s0))
                for s0, e0 in zip(starts, ends)]
        out = torch.stack([seg.amax(dim=ax) if mode == "max"
                           else seg.mean(dim=ax) for seg in segs], dim=ax)
    return out


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, 1, output_size, "avg", False)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive(x, 2, output_size, "avg", data_format == "NHWC")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(x, 3, output_size, "avg", data_format == "NDHWC")


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    """The maxima alone: the reference takes `return_mask` and returns
    no mask."""
    return _adaptive(x, 1, output_size, "max", False)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, 2, output_size, "max", False)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, 3, output_size, "max", False)
