"""Quantization (counterpart of paddle_tpu/quantization): the weight
codec `quantize_weight_int8` with its MSE clip search, and the runtime
(`runtime`): the paged-KV codecs and weight-only int8 / int4 serving.

The weight codec is numpy on the host, as in the reference
(paddle_tpu/quantization/__init__.py:45-125), and gives the reference's
codes and scales byte for byte on float32 and bf16 weights. A torch
tensor is taken through its exact float32 value. The one place where the
reference's bf16 arithmetic differs from float32 is the per-tensor scale
without the MSE search: handed a bf16 array, the reference divides it by
its bf16 absmax in bf16 (numpy's bfloat16 type rounds the float32
quotient to bf16) before the float32 multiply by qmax; `_bf16_round`
reproduces that rounding, so no bfloat16 numpy type is needed."""
import numpy as np
import torch

from . import runtime  # noqa: F401

__all__ = ["quantize_weight_int8", "runtime"]


def _search_scale_mse(vals, absmax, bits=8, fracs=None):
    """Scalar absmax refinement: the clip scale of the sweep (40 fractions
    of the absmax from 0.05 to 1, 1 included) with the least
    quant-dequant MSE over `vals`, in float64."""
    qmax = float(2 ** (bits - 1) - 1)
    if fracs is None:
        fracs = np.geomspace(0.05, 1.0, 40)
    vals = np.asarray(vals, np.float64).reshape(-1)
    best_s, best_e = float(absmax), np.inf
    for f in fracs:
        s = max(float(absmax) * float(f), 1e-8)
        step = s / qmax
        qd = np.clip(np.round(vals / step), -qmax, qmax) * step
        e = float(np.mean((qd - vals) ** 2))
        if e < best_e:
            best_e, best_s = e, s
    return best_s


def _search_scale_mse_per_channel(wv, scale0, red, bits=8, fracs=None):
    """Per-channel `_search_scale_mse`: one sweep over the clip fractions,
    the argmin kept per channel (`red` the reduced axes)."""
    qmax = float(2 ** (bits - 1) - 1)
    if fracs is None:
        fracs = np.geomspace(0.05, 1.0, 40)
    best_s = np.asarray(scale0, np.float64).copy()
    best_e = np.full(best_s.shape, np.inf)
    w64 = np.asarray(wv, np.float64)
    for f in fracs:
        s = np.maximum(scale0 * float(f), 1e-8)
        step = s / qmax
        qd = np.clip(np.round(w64 / step), -qmax, qmax) * step
        e = ((qd - w64) ** 2).mean(axis=red, keepdims=True)
        sel = e < best_e
        best_e = np.where(sel, e, best_e)
        best_s = np.where(sel, s, best_s)
    return best_s


def _host_array(w):
    if isinstance(w, torch.Tensor):
        return w.detach().to("cpu", torch.float32).numpy()
    return np.asarray(w)


def _bf16_round(x):
    """float32 array → the nearest bf16 values (ties to even), as float32."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def quantize_weight_int8(w, axis=None, search_mse=False, bits=8):
    """→ (int8 codes in [-qmax, qmax], float32 scale): per channel along
    `axis` with the keepdims shape (a [1, out] scale for axis=1 of an
    [in, out] weight), or one np.float32 scalar when `axis` is None.
    qmax = 2^(bits-1) - 1. `search_mse` refines each scale by the MSE
    clip search instead of plain absmax (at 4 bits it is the knob that
    matters: `runtime.Int4WeightOnlyLinear` always runs it)."""
    qmax = float(2 ** (bits - 1) - 1)
    wv = _host_array(w)
    if axis is None:
        scale = np.abs(wv).max() or 1e-8
        if search_mse:
            scale = _search_scale_mse(wv, scale, bits=bits)
        t = wv / scale
        if (isinstance(w, torch.Tensor) and w.dtype == torch.bfloat16
                and not search_mse):
            # the reference's bf16 / bf16-scalar quotient (module docstring)
            t = _bf16_round(t)
        q = np.clip(np.round(t * qmax), -qmax, qmax).astype(np.int8)
        return q, np.float32(scale)
    red = tuple(d for d in range(wv.ndim) if d != axis)
    scale = np.maximum(np.abs(wv).max(axis=red, keepdims=True), 1e-8)
    if search_mse:
        scale = _search_scale_mse_per_channel(wv, scale, red, bits=bits)
    q = np.clip(np.round(wv / scale * qmax), -qmax, qmax).astype(np.int8)
    # keep the keepdims shape: np.float32(arr) would collapse a size-1
    # array to a 0-d scalar (per-channel dequant turned per-tensor)
    return q, np.asarray(scale, dtype=np.float32)
