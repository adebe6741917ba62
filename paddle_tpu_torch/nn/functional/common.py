"""Common functionals (counterpart of
paddle_tpu/nn/functional/common.py): `linear` in paddle's [in, out]
weight layout, `embedding`, the dropouts, padding, resizing, sliding
blocks, pixel and channel shuffles, label smoothing, similarities and
the sampling grids. Each casts its inputs under AMP by the reference's
op name.

The dropouts draw their keep masks from the port's generators (the one
`core.rng.generator_scope` installs, else a fresh
`core.rng.next_generator`), never from torch's global one.

`interpolate` follows the reference, not torch: "nearest" takes input
index floor(i · in / out); "linear" / "bilinear" / "trilinear" /
"bicubic" without `align_corners` are `jax.image.resize` — half-pixel
centres, Keys' cubic with a = -0.5, and when it shrinks an axis the
kernel widened by the scale (antialiasing) — written here as one weight
matrix per resized axis; with `align_corners` every mode is the
reference's corner-aligned linear gather.
"""
import math

import numpy as np
import torch
import torch.nn.functional as tF

from ... import amp
from ...core import rng

__all__ = [
    "linear", "pairwise_distance", "fold", "dropout", "dropout2d",
    "dropout3d", "alpha_dropout", "embedding", "one_hot", "pad",
    "interpolate", "upsample", "unfold", "pixel_shuffle", "pixel_unshuffle",
    "channel_shuffle", "label_smooth", "cosine_similarity", "bilinear",
    "affine_grid", "grid_sample",
]


def linear(x, weight, bias=None, name=None):
    """y = x @ W (+ b); `weight` is [in_features, out_features]. Inputs
    of two float dtypes meet in the wider one, as jnp.matmul's do."""
    x, weight, bias = amp.cast_inputs_for("linear", (x, weight, bias))
    if x.dtype != weight.dtype:
        dt = torch.promote_types(x.dtype, weight.dtype)
        x, weight = x.to(dt), weight.to(dt)
    y = x @ weight
    return y if bias is None else y + bias


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Row gather; rows of `padding_idx` come out zero (and so take no
    gradient)."""
    (weight,) = amp.cast_inputs_for("embedding", (weight,))
    out = tF.embedding(x, weight)
    if padding_idx is None:
        return out
    pid = padding_idx if padding_idx >= 0 else weight.shape[0] + padding_idx
    return torch.where((x != pid)[..., None], out, 0.0)


def _keep_mask(shape, p, device):
    gen = rng.current_generator() or rng.next_generator(device)
    return torch.rand(shape, generator=gen, device=device) >= p


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """paddle's dropout: "upscale_in_train" scales the kept values by
    1 / (1 - p) in training; "downscale_in_infer" keeps them as they are
    and multiplies by (1 - p) at inference. `axis` draws one mask entry
    per index of those axes, shared along the rest."""
    if not training or p == 0:
        if mode == "downscale_in_infer" and not training:
            (x,) = amp.cast_inputs_for("dropout_scale", (x,))
            return x * (1 - p)
        return x
    if p == 1:
        (x,) = amp.cast_inputs_for("dropout_all", (x,))
        return torch.zeros_like(x)
    (x,) = amp.cast_inputs_for("dropout", (x,))
    shape = tuple(x.shape)
    if axis is not None:
        axes = {a % x.ndim for a in ((axis,) if isinstance(axis, int)
                                     else axis)}
        shape = tuple(s if i in axes else 1 for i, s in enumerate(shape))
    keep = _keep_mask(shape, p, x.device)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
    return torch.where(keep, x, 0.0).to(x.dtype)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    axis = (0, 1) if data_format == "NCHW" else (0, 3)
    return dropout(x, p=p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    axis = (0, 1) if data_format == "NCDHW" else (0, 4)
    return dropout(x, p=p, axis=axis, training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU's dropout: dropped values become the negative saturation,
    then an affine map keeps the mean and variance."""
    if not training or p == 0:
        return x
    (x,) = amp.cast_inputs_for("alpha_dropout", (x,))
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    keep = _keep_mask(tuple(x.shape), p, x.device)
    a = (1.0 / math.sqrt((1 - p) * (1 + p * alpha_p ** 2))) if p < 1 else 0.0
    b = -a * alpha_p * p
    return (a * torch.where(keep, x, alpha_p) + b).to(x.dtype)


def one_hot(x, num_classes, name=None):
    from ...ops.creation import one_hot as _one_hot

    return _one_hot(x, num_classes)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    from ...ops.manipulation import pad as _pad

    return _pad(x, pad, mode=mode, value=value, data_format=data_format)


# ---- resizing ----

def _triangle(t):
    return torch.clamp(1 - t.abs(), min=0)


def _keys_cubic(t):
    out = ((1.5 * t - 2.5) * t) * t + 1.0
    out = torch.where(t >= 1.0, ((-0.5 * t + 2.5) * t - 4.0) * t + 2.0, out)
    return torch.where(t >= 2.0, 0.0, out)


def _resize_weights(n_in, n_out, kernel, device):
    """jax.image's `compute_weight_mat` (scale n_out / n_in, no
    translation, antialiased): [n_in, n_out] in float64."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(n_out, dtype=torch.float64, device=device) + 0.5)
              * inv_scale - 0.5)
    t = (sample[None, :] - torch.arange(n_in, dtype=torch.float64,
                                        device=device)[:, None]).abs()
    w = kernel(t / kernel_scale)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def _resize_axis(x, ax, n_out, kernel):
    n_in = x.shape[ax]
    if n_in == n_out:
        return x
    w = _resize_weights(n_in, n_out, kernel, x.device).to(x.dtype)
    return torch.tensordot(x, w, dims=([ax], [0])).movedim(-1, ax)


def _resize_align_corners(x, outs):
    out = x
    for i, n_out in enumerate(outs):
        ax = 2 + i
        n_in = out.shape[ax]
        if n_out == 1 or n_in == 1:
            coords = torch.zeros(n_out, dtype=torch.float64, device=x.device)
        else:
            coords = torch.arange(n_out, dtype=torch.float64,
                                  device=x.device) * ((n_in - 1)
                                                      / (n_out - 1))
        lo = torch.floor(coords).long()
        hi = torch.clamp(lo + 1, 0, n_in - 1)
        shape = [1] * out.ndim
        shape[ax] = n_out
        w = (coords - lo).to(out.dtype).reshape(shape)
        out = (out.index_select(ax, lo) * (1 - w)
               + out.index_select(ax, hi) * w)
    return out


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    (x,) = amp.cast_inputs_for("interpolate", (x,))
    channel_last = data_format in ("NHWC", "NWC", "NDHWC")
    nd = x.ndim - 2
    if channel_last:
        x = x.movedim(-1, 1)
    spatial = tuple(x.shape[2:])
    if size is not None:
        s = size if isinstance(size, (list, tuple)) else [size] * nd
        outs = tuple(int(v) for v in s)
    else:
        sf = (scale_factor if isinstance(scale_factor, (list, tuple))
              else [scale_factor] * nd)
        outs = tuple(int(np.floor(sp * f)) for sp, f in zip(spatial, sf))
    if mode == "nearest":
        out = x
        for i, (n_in, n_out) in enumerate(zip(spatial, outs)):
            idx = torch.floor(torch.arange(n_out, dtype=torch.float64,
                                           device=x.device)
                              * (n_in / n_out)).long()
            out = out.index_select(2 + i, idx)
    elif mode in ("bilinear", "linear", "trilinear", "bicubic"):
        if align_corners:
            out = _resize_align_corners(x, outs)
        else:
            kernel = _keys_cubic if mode == "bicubic" else _triangle
            out = x
            for i, n_out in enumerate(outs):
                out = _resize_axis(out, 2 + i, n_out, kernel)
    elif mode == "area":
        out = x
        for i, (n_in, n_out) in enumerate(zip(spatial, outs)):
            ax = 2 + i
            if n_in % n_out == 0:
                shp = (tuple(out.shape[:ax]) + (n_out, n_in // n_out)
                       + tuple(out.shape[ax + 1:]))
                out = out.reshape(shp).mean(dim=ax + 1)
            else:
                out = _resize_axis(out, ax, n_out, _triangle)
    else:
        raise ValueError(f"unsupported interpolate mode {mode}")
    return out.movedim(1, -1) if channel_last else out


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


# ---- sliding blocks ----

def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: [N, C, H, W] → [N, C·kh·kw, L]; `paddings` 2 numbers (h, w)
    or 4 (top, left, bottom, right)."""
    (x,) = amp.cast_inputs_for("unfold", (x,))
    k, s, d = _pair(kernel_sizes), _pair(strides), _pair(dilations)
    p = _pair(paddings)
    if len(p) == 2:
        p = (p[0], p[1], p[0], p[1])
    n, c = x.shape[:2]
    x = tF.pad(x, (p[1], p[3], p[0], p[2]))
    oh = (x.shape[2] - (d[0] * (k[0] - 1) + 1)) // s[0] + 1
    ow = (x.shape[3] - (d[1] * (k[1] - 1) + 1)) // s[1] + 1
    patches = [x[:, :, i * d[0]: i * d[0] + oh * s[0]: s[0],
                 j * d[1]: j * d[1] + ow * s[1]: s[1]]
               for i in range(k[0]) for j in range(k[1])]
    return torch.stack(patches, 2).reshape(n, c * k[0] * k[1], oh * ow)


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0,
         dilations=1, name=None):
    """col2im: [N, C·kh·kw, L] → [N, C, H, W], overlaps summed (the
    inverse of unfold)."""
    (x,) = amp.cast_inputs_for("fold", (x,))
    H, W = _pair(output_sizes)
    kh, kw = _pair(kernel_sizes)
    sh, sw = _pair(strides)
    ph, pw = _pair(paddings)
    dh, dw = _pair(dilations)
    oh = (H + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    ow = (W + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    n = x.shape[0]
    c = x.shape[1] // (kh * kw)
    blocks = x.reshape(n, c, kh, kw, oh, ow)
    out = x.new_zeros((n, c, H + 2 * ph, W + 2 * pw))
    for i in range(kh):
        for j in range(kw):
            out[:, :, i * dh:i * dh + sh * oh:sh,
                j * dw:j * dw + sw * ow:sw] += blocks[:, :, i, j]
    return out[:, :, ph:ph + H, pw:pw + W]


# ---- shuffles ----

def _channels_first(x, data_format):
    return x.movedim(-1, 1) if data_format in ("NHWC",) else x


def _channels_back(x, data_format):
    return x.movedim(1, -1) if data_format in ("NHWC",) else x


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    (x,) = amp.cast_inputs_for("pixel_shuffle", (x,))
    r = upscale_factor
    x = _channels_first(x, data_format)
    n, c, h, w = x.shape
    out = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return _channels_back(out.reshape(n, c // (r * r), h * r, w * r),
                          data_format)


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    (x,) = amp.cast_inputs_for("pixel_unshuffle", (x,))
    r = downscale_factor
    x = _channels_first(x, data_format)
    n, c, h, w = x.shape
    out = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
    return _channels_back(out.reshape(n, c * r * r, h // r, w // r),
                          data_format)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    (x,) = amp.cast_inputs_for("channel_shuffle", (x,))
    x = _channels_first(x, data_format)
    n, c = x.shape[:2]
    out = x.reshape((n, groups, c // groups) + tuple(x.shape[2:]))
    return _channels_back(out.transpose(1, 2).reshape(x.shape), data_format)


# ---- labels and similarities ----

def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """(1 - epsilon) · label + epsilon · prior (uniform over the last
    axis when no prior is given)."""
    if prior_dist is not None:
        label, prior_dist = amp.cast_inputs_for("label_smooth",
                                                (label, prior_dist))
        return (1 - epsilon) * label + epsilon * prior_dist
    (label,) = amp.cast_inputs_for("label_smooth", (label,))
    return (1 - epsilon) * label + epsilon / label.shape[-1]


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    x1, x2 = amp.cast_inputs_for("cosine_similarity", (x1, x2))
    num = (x1 * x2).sum(dim=axis)
    den = (torch.linalg.vector_norm(x1, dim=axis)
           * torch.linalg.vector_norm(x2, dim=axis))
    return num / torch.clamp(den, min=eps)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """The p-norm of x - y (+ epsilon) over the last axis (p inf: the
    largest, -inf: the smallest, 0: the nonzero count)."""
    x, y = amp.cast_inputs_for("pairwise_distance", (x, y))
    d = (x - y).abs() + epsilon
    if p == float("inf"):
        out = d.amax(dim=-1)
    elif p == float("-inf"):
        out = d.amin(dim=-1)
    elif p == 0:
        out = (d != 0).to(d.dtype).sum(dim=-1)
    else:
        out = (d ** p).sum(dim=-1) ** (1.0 / p)
    return out[..., None] if keepdim else out


def bilinear(x1, x2, weight, bias=None, name=None):
    """out[b, o] = x1[b] · W[o] · x2[b] (+ bias)."""
    x1, x2, weight, bias = amp.cast_inputs_for("bilinear",
                                               (x1, x2, weight, bias))
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


# ---- sampling grids ----

def affine_grid(theta, out_shape, align_corners=True, name=None):
    """[N, H, W, 2] sampling positions in [-1, 1] of each output pixel
    under the [N, 2, 3] affine maps `theta`."""
    (theta,) = amp.cast_inputs_for("affine_grid", (theta,))
    h, w = int(out_shape[2]), int(out_shape[3])
    kw = dict(dtype=theta.dtype, device=theta.device)
    if align_corners:
        xs, ys = torch.linspace(-1, 1, w, **kw), torch.linspace(-1, 1, h, **kw)
    else:
        xs = (torch.arange(w, **kw) * 2 + 1) / w - 1
        ys = (torch.arange(h, **kw) * 2 + 1) / h - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    return torch.einsum("hwk,nck->nhwc", base, theta)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample [N, C, H, W] at the grid's [N, Hg, Wg, 2] positions in
    [-1, 1]: bilinear (out-of-range corners zero under "zeros", clamped
    otherwise) or nearest (rounded, clamped)."""
    x, grid = amp.cast_inputs_for("grid_sample", (x, grid))
    n, c, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        fx, fy = (gx + 1) * (w - 1) / 2, (gy + 1) * (h - 1) / 2
    else:
        fx, fy = ((gx + 1) * w - 1) / 2, ((gy + 1) * h - 1) / 2
    bidx = torch.arange(n, device=x.device)[:, None, None]

    def gather(ix, iy):
        v = x[bidx, :, torch.clamp(iy, 0, h - 1).long(),
              torch.clamp(ix, 0, w - 1).long()]           # N, Hg, Wg, C
        if padding_mode == "zeros":
            inb = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
            v = v * inb[..., None]
        return v

    if mode == "nearest":
        out = x[bidx, :, torch.clamp(torch.round(fy), 0, h - 1).long(),
                torch.clamp(torch.round(fx), 0, w - 1).long()]
        return out.movedim(-1, 1)
    x0, y0 = torch.floor(fx), torch.floor(fy)
    wx, wy = (fx - x0).to(x.dtype), (fy - y0).to(x.dtype)
    out = (gather(x0, y0) * ((1 - wx) * (1 - wy))[..., None]
           + gather(x0 + 1, y0) * (wx * (1 - wy))[..., None]
           + gather(x0, y0 + 1) * ((1 - wx) * wy)[..., None]
           + gather(x0 + 1, y0 + 1) * (wx * wy)[..., None])
    return out.movedim(-1, 1)
