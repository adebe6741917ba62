"""Functional image ops over numpy HWC arrays — color and geometry
(counterpart of paddle_tpu/vision/transforms/functional.py; reference
python/paddle/vision/transforms/functional*.py).

Vectorized numpy, no PIL: the affine, rotate and perspective warps are
the reference's inverse warps (each output pixel samples the source at
the inverse map's point, nearest or bilinear), not torchvision's.
"""
import numbers

import numpy as np

__all__ = [
    "adjust_brightness", "adjust_contrast", "adjust_saturation",
    "adjust_hue", "to_grayscale", "rotate", "affine", "perspective",
    "erase", "crop", "center_crop",
]


def _as_hwc(img):
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    return img


def _blend(img1, img2, ratio):
    out = img1.astype("float32") * ratio + img2.astype("float32") * (1 - ratio)
    if np.issubdtype(np.asarray(img1).dtype, np.integer):
        return out.clip(0, 255).astype(np.asarray(img1).dtype)
    return out.clip(0.0, None)


def adjust_brightness(img, brightness_factor):
    img = _as_hwc(img)
    return _blend(img, np.zeros_like(img), brightness_factor)


def adjust_contrast(img, contrast_factor):
    img = _as_hwc(img)
    mean = np.full_like(
        img, to_grayscale(img).astype("float32").mean(),
        dtype="float32" if not np.issubdtype(img.dtype, np.integer)
        else img.dtype)
    return _blend(img, mean, contrast_factor)


def adjust_saturation(img, saturation_factor):
    img = _as_hwc(img)
    gray = to_grayscale(img, num_output_channels=img.shape[2])
    return _blend(img, gray, saturation_factor)


def adjust_hue(img, hue_factor):
    """Shift hue by hue_factor∈[-0.5, 0.5] via RGB→HSV→RGB."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError(f"hue_factor {hue_factor} not in [-0.5, 0.5]")
    img = _as_hwc(img)
    if img.shape[2] == 1:
        return img
    orig_dtype = img.dtype
    arr = img.astype("float32")
    scale = 255.0 if np.issubdtype(orig_dtype, np.integer) else 1.0
    arr = arr / scale
    r, g, b = arr[..., 0], arr[..., 1], arr[..., 2]
    maxc = arr[..., :3].max(-1)
    minc = arr[..., :3].min(-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    dz = np.where(delta == 0, 1.0, delta)
    rc = (maxc - r) / dz
    gc = (maxc - g) / dz
    bc = (maxc - b) / dz
    h = np.where(r == maxc, bc - gc,
                 np.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = np.where(delta == 0, 0.0, h / 6.0) % 1.0
    h = (h + hue_factor) % 1.0
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(int) % 6
    choices = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v),
               (v, p, q)]
    r2 = np.choose(i, [c[0] for c in choices])
    g2 = np.choose(i, [c[1] for c in choices])
    b2 = np.choose(i, [c[2] for c in choices])
    out = np.stack([r2, g2, b2], axis=-1) * scale
    if img.shape[2] > 3:
        out = np.concatenate([out, img[..., 3:].astype("float32")], axis=-1)
    if np.issubdtype(orig_dtype, np.integer):
        out = out.round().clip(0, 255)
    return out.astype(orig_dtype)


def to_grayscale(img, num_output_channels=1):
    img = _as_hwc(img)
    if img.shape[2] == 1:
        gray = img.astype("float32")[..., 0]
    else:
        gray = (0.299 * img[..., 0].astype("float32")
                + 0.587 * img[..., 1].astype("float32")
                + 0.114 * img[..., 2].astype("float32"))
    if np.issubdtype(img.dtype, np.integer):
        gray = gray.round().clip(0, 255)
    gray = gray.astype(img.dtype)
    return np.repeat(gray[..., None], num_output_channels, axis=2)


# ------------------------------------------------------------- geometry

def _inverse_warp(img, m_inv, out_h, out_w, interpolation="nearest", fill=0):
    """Sample out[y, x] = img[m_inv @ (x, y, 1)]; coords outside → fill."""
    img = _as_hwc(img).astype("float32")
    ys, xs = np.meshgrid(np.arange(out_h), np.arange(out_w), indexing="ij")
    ones = np.ones_like(xs)
    coords = np.stack([xs, ys, ones], 0).reshape(3, -1).astype("float32")
    src = m_inv @ coords
    if m_inv.shape[0] == 3:  # projective: divide by w
        src = src[:2] / np.maximum(np.abs(src[2:3]), 1e-9) * np.sign(src[2:3])
    sx, sy = src[0].reshape(out_h, out_w), src[1].reshape(out_h, out_w)
    h, w = img.shape[:2]
    if interpolation == "bilinear":
        x0 = np.floor(sx).astype(int)
        y0 = np.floor(sy).astype(int)
        wx = sx - x0
        wy = sy - y0
        out = np.zeros((out_h, out_w, img.shape[2]), "float32")
        total_w = np.zeros((out_h, out_w, 1), "float32")
        for dy in (0, 1):
            for dx in (0, 1):
                xi, yi = x0 + dx, y0 + dy
                valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
                wgt = (np.where(dx, wx, 1 - wx)
                       * np.where(dy, wy, 1 - wy) * valid)
                out += img[yi.clip(0, h - 1), xi.clip(0, w - 1)] \
                    * wgt[..., None]
                total_w += wgt[..., None]
        out = np.where(total_w > 1e-6, out / np.maximum(total_w, 1e-6), fill)
    else:
        xi = np.round(sx).astype(int)
        yi = np.round(sy).astype(int)
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        out = np.where(valid[..., None],
                       img[yi.clip(0, h - 1), xi.clip(0, w - 1)],
                       np.float32(fill))
    return out


def _affine_matrix(angle, translate, scale, shear, center):
    rot = np.deg2rad(angle)
    sx, sy = (np.deg2rad(s) for s in shear)
    cx, cy = center
    tx, ty = translate
    # forward: T(center+translate) @ R(rot) @ Shear @ Scale @ T(-center)
    a = np.cos(rot - sy) / max(np.cos(sy), 1e-9)
    b = -np.cos(rot - sy) * np.tan(sx) / max(np.cos(sy), 1e-9) - np.sin(rot)
    c = np.sin(rot - sy) / max(np.cos(sy), 1e-9)
    d = -np.sin(rot - sy) * np.tan(sx) / max(np.cos(sy), 1e-9) + np.cos(rot)
    m = np.array([[scale * a, scale * b, 0.0],
                  [scale * c, scale * d, 0.0],
                  [0.0, 0.0, 1.0]], "float32")
    m[0, 2] = cx + tx - m[0, 0] * cx - m[0, 1] * cy
    m[1, 2] = cy + ty - m[1, 0] * cx - m[1, 1] * cy
    return m


def affine(img, angle=0.0, translate=(0, 0), scale=1.0, shear=(0.0, 0.0),
           interpolation="nearest", fill=0, center=None):
    img = _as_hwc(img)
    orig_dtype = img.dtype
    h, w = img.shape[:2]
    if isinstance(shear, numbers.Number):
        shear = (shear, 0.0)
    if center is None:
        center = ((w - 1) * 0.5, (h - 1) * 0.5)
    m = _affine_matrix(angle, translate, scale, shear, center)
    out = _inverse_warp(img, np.linalg.inv(m), h, w, interpolation, fill)
    if np.issubdtype(orig_dtype, np.integer):
        out = out.round().clip(0, 255)
    return out.astype(orig_dtype)


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    img = _as_hwc(img)
    orig_dtype = img.dtype
    h, w = img.shape[:2]
    if center is None:
        center = ((w - 1) * 0.5, (h - 1) * 0.5)
    m = _affine_matrix(-angle, (0, 0), 1.0, (0.0, 0.0), center)
    out_h, out_w = h, w
    if expand:
        corners = np.array(
            [[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1], [w - 1, h - 1, 1]],
            "float32").T
        mapped = m @ corners
        out_w = int(np.ceil(mapped[0].max() - mapped[0].min() + 1))
        out_h = int(np.ceil(mapped[1].max() - mapped[1].min() + 1))
        shift = np.eye(3, dtype="float32")
        shift[0, 2] = -mapped[0].min()
        shift[1, 2] = -mapped[1].min()
        m = shift @ m
    out = _inverse_warp(img, np.linalg.inv(m), out_h, out_w, interpolation,
                        fill)
    if np.issubdtype(orig_dtype, np.integer):
        out = out.round().clip(0, 255)
    return out.astype(orig_dtype)


def _homography(src_pts, dst_pts):
    """dst→src homography from 4 point pairs (least squares)."""
    a = []
    b = []
    for (dx, dy), (sx, sy) in zip(dst_pts, src_pts):
        a.append([dx, dy, 1, 0, 0, 0, -sx * dx, -sx * dy])
        b.append(sx)
        a.append([0, 0, 0, dx, dy, 1, -sy * dx, -sy * dy])
        b.append(sy)
    params = np.linalg.lstsq(np.asarray(a, "float32"),
                             np.asarray(b, "float32"), rcond=None)[0]
    return np.append(params, 1.0).reshape(3, 3).astype("float32")


def perspective(img, startpoints, endpoints, interpolation="nearest",
                fill=0):
    """Warp so that startpoints map to endpoints
    (points are [[x, y], ...] corner lists, reference convention)."""
    img = _as_hwc(img)
    orig_dtype = img.dtype
    h, w = img.shape[:2]
    m_inv = _homography(startpoints, endpoints)  # maps output pt → source pt
    out = _inverse_warp(img, m_inv, h, w, interpolation, fill)
    if np.issubdtype(orig_dtype, np.integer):
        out = out.round().clip(0, 255)
    return out.astype(orig_dtype)


# -------------------------------------------------------------- erase/crop

def erase(img, i, j, h, w, v, inplace=False):
    """Erase region [i:i+h, j:j+w] with value(s) v. Accepts HWC numpy or
    a CHW tensor (reference: functional.erase supports both)."""
    import torch

    if isinstance(img, torch.Tensor):
        arr = img.detach().cpu().numpy().copy()
        arr[..., i: i + h, j: j + w] = v
        return torch.from_numpy(arr)
    arr = _as_hwc(img)
    if not inplace:
        arr = arr.copy()
    arr[i: i + h, j: j + w] = v
    return arr


def crop(img, top, left, height, width):
    return _as_hwc(img)[top: top + height, left: left + width]


def center_crop(img, output_size):
    img = _as_hwc(img)
    if isinstance(output_size, numbers.Number):
        output_size = (int(output_size), int(output_size))
    h, w = img.shape[:2]
    th, tw = output_size
    return crop(img, (h - th) // 2, (w - tw) // 2, th, tw)
