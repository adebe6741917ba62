"""Quantized runtime (counterpart of paddle_tpu/quantization/runtime.py):
weight-only int8 / int4 serving, the int8 / packed-int4 paged KV codecs
and the kv dtype resolution.

Weight-only serving: `quantize_model_int8` / `quantize_model_int4` swap
every Linear of a loaded model, in place, for `Int8WeightOnlyLinear` /
`Int4WeightOnlyLinear`: per-out-channel int8 (or packed int4) weights
held as buffers `weight_q` [in, out] (packed: [in/2, out]) and `w_step`
[1, out] f32, so `state_dict()` carries them and they load key for key
from the reference's quantized model (`convert`); activations are
quantized per row inside the op and the product is the exact int32 W8A8
GEMM (`ops/cuda_kernels/int8_gemm.py`: a CUDA kernel on the card, its
plain version on the CPU), dequantized in the epilogue. Embeddings and
the tied vocab head stay float.

Each K/V row written into a paged pool is quantized once, per
(token, head), against its own absmax, so later writes to the same page
never re-scale earlier rows; the fp32 scales live in page-shaped planes
[num_pages, page_size, heads] beside the pool. int4 packs two codes per
byte along head_dim in the split-halves layout: byte j holds code j in
its low nibble and code j + D/2 in its high nibble, so the pool's last
dim is D/2 and unpacking is two mask-and-sign-extend passes and a
concatenation.

The codecs follow the reference op for op (upcast to f32, scale =
max(absmax, 1e-8) / qmax, round half to even, clip), so codes and scales
are bit-identical to it for the same rows.

Env knob: PT_KV_DTYPE, the engine's default kv dtype (float32 |
bfloat16 | int8 | int4; unset = the model's dtype).
"""
import os

import numpy as np
import torch
from torch import nn

__all__ = ["QMAX", "QMAX4", "Int8WeightOnlyLinear", "Int4WeightOnlyLinear",
           "quantize_model_int8", "quantize_model_int4", "pack_int4",
           "unpack_int4", "resolve_kv_dtype", "kv_scale_shape",
           "quantize_kv_rows", "dequantize_kv", "quantize_kv_rows_int4",
           "dequantize_kv_int4"]

QMAX = 127.0
QMAX4 = 7.0


def pack_int4(codes, axis=0):
    """int8 codes in [-8, 7] → packed bytes, half the size along `axis`
    (which must be even-sized), split-halves layout."""
    n = codes.shape[axis]
    if n % 2:
        raise ValueError(f"pack_int4: axis {axis} size {n} is odd")
    lo, hi = torch.chunk(codes.to(torch.int32), 2, dim=axis)
    packed = (lo & 0x0F) | ((hi & 0x0F) << 4)          # 0..255
    return packed.to(torch.uint8).view(torch.int8)


def unpack_int4(packed, axis=0):
    """Inverse of `pack_int4`: packed int8 bytes → sign-extended int8
    codes, double the size along `axis` (`((x & 0xF) ^ 8) - 8`)."""
    p = packed.to(torch.int32) & 0xFF
    lo = (((p & 0xF) ^ 8) - 8).to(torch.int8)
    hi = ((((p >> 4) & 0xF) ^ 8) - 8).to(torch.int8)
    return torch.cat([lo, hi], dim=axis)


# ---------------------------------------------------------------- weights

class _WeightOnlyLinear(nn.Module):
    """A Linear over per-out-channel quantized weights: the buffers
    `weight_q` and `w_step` (the step = scale / qmax), the float bias kept
    as the replaced layer's parameter. Forward: the W8A8 linear
    (`int8_gemm.w8a8_linear`). Inference only."""

    int4 = False

    def __init__(self, linear, q, scale, qmax):
        super().__init__()
        w = linear.weight                      # [in, out] (paddle layout)
        self.in_features = int(w.shape[0])
        self.out_features = int(w.shape[1])
        q = torch.from_numpy(q)
        if self.int4:
            q = pack_int4(q, axis=0)
        self.register_buffer("weight_q", q.to(w.device))
        self.register_buffer("w_step", torch.from_numpy(
            np.asarray(scale, np.float32) / qmax).to(w.device))
        self.bias = getattr(linear, "bias", None)

    def forward(self, x):
        from ..ops.cuda_kernels import int8_gemm

        return int8_gemm.w8a8_linear(x, self.weight_q, self.w_step,
                                     self.bias, int4=self.int4)


class Int8WeightOnlyLinear(_WeightOnlyLinear):
    """Serving-time Linear over per-channel int8 weights (the reference's
    runtime.py:91): absmax per out channel, codes in [-127, 127],
    `w_step` = scale / 127."""

    def __init__(self, linear):
        from . import quantize_weight_int8

        q, scale = quantize_weight_int8(linear.weight, axis=1)
        super().__init__(linear, q, scale, QMAX)

    def extra_repr(self):
        return (f"in={self.in_features}, out={self.out_features}, "
                "weight=int8 per-channel")


class Int4WeightOnlyLinear(_WeightOnlyLinear):
    """Serving-time Linear over per-channel packed int4 weights (the
    reference's runtime.py:155): the MSE clip search always on, codes in
    [-7, 7], `w_step` = scale / 7, two codes a byte along the in-dim in
    the split-halves layout (`weight_q` [in/2, out]). An odd in_features
    cannot pair nibbles and raises (`quantize_model_int4` skips such
    layers)."""

    int4 = True

    def __init__(self, linear):
        from . import quantize_weight_int8

        if int(linear.weight.shape[0]) % 2:
            raise ValueError(
                f"Int4WeightOnlyLinear: in_features "
                f"{int(linear.weight.shape[0])} is odd — nibble packing "
                "pairs in-dim rows (quantize_model_int4 skips such layers)")
        q, scale = quantize_weight_int8(linear.weight, axis=1, bits=4,
                                        search_mse=True)
        super().__init__(linear, q, scale, QMAX4)

    def extra_repr(self):
        return (f"in={self.in_features}, out={self.out_features}, "
                "weight=int4 packed per-channel (MSE clip)")


def _linear_classes():
    from ..distributed.fleet.meta_parallel.mp_layers import (
        ColumnParallelLinear, RowParallelLinear)
    from ..nn.layer.common import Linear

    return Linear, ColumnParallelLinear, RowParallelLinear


def _swap_linears(model, skip, make, report, key, odd=False):
    """Swap every Linear-family sublayer not matched by `skip` (attribute
    path substrings) for `make(sub)`, in place, filling `report`'s layer
    count and weight bytes (`key`: the quantized bytes' entry); with
    `odd`, layers of odd in_features stay float and are counted in
    `skipped_odd`."""
    linear_types = _linear_classes()

    def swap(layer, prefix=""):
        for name, sub in list(layer.named_children()):
            path = f"{prefix}.{name}" if prefix else name
            if isinstance(sub, _WeightOnlyLinear):
                continue                   # already quantized
            if isinstance(sub, linear_types) and not any(
                    s in path for s in skip):
                w = sub.weight
                if odd and int(w.shape[0]) % 2:
                    report["skipped_odd"] += 1
                    continue
                wrapped = make(sub)
                report["layers"] += 1
                report["weight_bytes_fp"] += w.numel() * w.element_size()
                report[key] += sum(
                    b.numel() * b.element_size()
                    for b in (wrapped.weight_q, wrapped.w_step))
                setattr(layer, name, wrapped)
            else:
                swap(sub, path)

    swap(model)
    model.eval()
    return report


def quantize_model_int8(model, skip=(), tp_shard=True):
    """Swap every Linear-family sublayer (`Linear`, `ColumnParallelLinear`,
    `RowParallelLinear`) for `Int8WeightOnlyLinear`, in place. Embeddings
    and the tied vocab head (which reads the embedding) stay float.
    skip: attribute-path substrings to leave float (e.g. ("lm_head",)).
    tp_shard: the reference shards the buffers over a tensor-parallel
    mesh; on one rank there is nothing to shard (ROADMAP A11).

    Returns {layers, weight_bytes_fp, weight_bytes_int8} (weights only,
    the steps included in the int8 bytes)."""
    report = {"layers": 0, "weight_bytes_fp": 0, "weight_bytes_int8": 0}
    return _swap_linears(model, skip, Int8WeightOnlyLinear, report,
                         "weight_bytes_int8")


def quantize_model_int4(model, skip=()):
    """`quantize_model_int8`'s packed-int4 sibling: `Int4WeightOnlyLinear`
    (MSE clip search per out channel). Layers with an odd in_features
    cannot pair nibbles and stay float, counted in `skipped_odd`.

    Returns {layers, skipped_odd, weight_bytes_fp, weight_bytes_int4}."""
    report = {"layers": 0, "skipped_odd": 0, "weight_bytes_fp": 0,
              "weight_bytes_int4": 0}
    return _swap_linears(model, skip, Int4WeightOnlyLinear, report,
                         "weight_bytes_int4", odd=True)


# ---------------------------------------------------------------- kv cache

_KV_DTYPES = {
    "float32": torch.float32, "fp32": torch.float32,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "int8": torch.int8,
}


def resolve_kv_dtype(requested, compute_dtype):
    """(requested | $PT_KV_DTYPE | the model's compute dtype) → (storage
    torch dtype, quantized bits). `bits` is 0 for float pools, 8 for
    int8 and 4 for packed int4 (stored as int8, head_dim halved in the
    pool)."""
    req = requested
    if req is None:
        req = os.environ.get("PT_KV_DTYPE", "").strip() or None
    if req is None:
        return compute_dtype, 0
    if isinstance(req, str):
        key = req.lower()
        if key in ("int4", "i4"):
            return torch.int8, 4
        if key not in _KV_DTYPES:
            raise ValueError(
                f"unknown kv_dtype {req!r}: expected one of "
                f"{sorted(set(_KV_DTYPES) | {'int4'})}")
        dt = _KV_DTYPES[key]
    else:
        dt = req
        if dt not in _KV_DTYPES.values():
            raise ValueError(f"unsupported kv_dtype {dt}")
    return dt, 8 if dt == torch.int8 else 0


def kv_scale_shape(num_pages, page_size, num_heads):
    """Shape of the scale plane beside a quantized pool: one fp32 scale
    per (page, row, head)."""
    return (num_pages, page_size, num_heads)


def _quantize(x, qmax):
    f = x.to(torch.float32)
    scale = torch.clamp(f.abs().amax(dim=-1), min=1e-8) / qmax
    q = torch.clamp(torch.round(f / scale[..., None]), -qmax, qmax)
    return q.to(torch.int8), scale


def quantize_kv_rows(x):
    """[T, H, D] float → (int8 codes [T, H, D], fp32 scales [T, H]),
    per-(token, head) absmax against 127."""
    return _quantize(x, QMAX)


def dequantize_kv(q, scale):
    """Inverse of `quantize_kv_rows` → float32."""
    return q.to(torch.float32) * scale[..., None]


def quantize_kv_rows_int4(x):
    """[T, H, D] float → (packed int4 [T, H, D/2], fp32 scales [T, H]),
    per-(token, head) absmax against 7 (15 levels)."""
    q, scale = _quantize(x, QMAX4)
    return pack_int4(q, axis=-1), scale


def dequantize_kv_int4(packed, scale):
    """Inverse of `quantize_kv_rows_int4` → [T, H, D] float32."""
    return unpack_int4(packed, axis=-1).to(torch.float32) * scale[..., None]
