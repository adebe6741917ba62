"""Quantized runtime, KV half (counterpart of
paddle_tpu/quantization/runtime.py: the int8 / packed-int4 paged KV
codecs and the kv dtype resolution).

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

import torch

__all__ = ["QMAX", "QMAX4", "pack_int4", "unpack_int4", "resolve_kv_dtype",
           "kv_scale_shape", "quantize_kv_rows", "dequantize_kv",
           "quantize_kv_rows_int4", "dequantize_kv_int4"]

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
