"""W8A8 linear — the int8 GEMM of weight-only quantized serving, and its
plain version.

No Pallas kernel is behind it: the JAX package's `Int8WeightOnlyLinear`
and `Int4WeightOnlyLinear` (paddle_tpu/quantization/runtime.py:134,
:209) compute `lax.dot_general(int8, int8 -> int32)` and leave it to
XLA. On CUDA `torch.matmul` has no int8 path and `torch._int_mm` needs
more than 16 rows, so the exact int32 product is a CUDA C++ kernel for
sm_90a (`csrc/int8_gemm.cu`, whose header says what bounds it and how it
is built), bound with ctypes.

`w8a8_linear(x, weight_q, w_step, bias, int4)` computes, in the
reference's order: x's per-row codes (a_step = max(max|x|, 1e-8) / 127,
codes = clip(round_half_even(x / a_step), -127, 127)), the int32 product
with the int8 weight [in, out] (or the packed int4 weight [in/2, out],
split-halves layout), and the f32 epilogue (acc · a_step) · w_step
(+ bias), cast to x's dtype. For tensors on the CPU it runs
`w8a8_linear_plain`; for CUDA tensors it launches the kernel (and raises
on anything the kernel does not take). `launches` counts launches of the
GEMM, "w8a8" for int8 weights and "w4a8" for packed int4 ones; it moves
only where a kernel launches (a CUDA graph's capture counts once, and
its owner adds the count again at each replay).
"""
import ctypes

import torch

from ...quantization.runtime import QMAX, unpack_int4
from . import _build

__all__ = ["w8a8_linear", "w8a8_linear_plain", "quantize_rows_plain",
           "launches", "reset_launches"]

SOURCE = "paddle_tpu_torch/csrc/int8_gemm.cu"
_REF = "paddle_tpu/quantization/runtime.py"
REPLACES = {"w8a8": f"{_REF}:134 (lax.dot_general, no Pallas kernel)",
            "w4a8": f"{_REF}:209 (lax.dot_general, no Pallas kernel)"}

launches = dict.fromkeys(REPLACES, 0)

_X_KINDS = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches():
    for name in launches:
        launches[name] = 0


def quantize_rows_plain(x):
    """x [T, K] float → (codes int8 [T, K], a_step f32 [T, 1]): per-row
    absmax against 127, round half to even, clip (the reference's
    activation quantize, runtime.py:126-131). The step divides by a
    tensor of 127s: torch on CUDA turns a division by a scalar into a
    multiplication by its rounded reciprocal, which is not the
    correctly rounded quotient the reference and the kernel take."""
    f = x.to(torch.float32)
    absmax = torch.clamp(f.abs().amax(dim=-1, keepdim=True), min=1e-8)
    a_step = absmax / torch.full_like(absmax, QMAX)
    codes = torch.clamp(torch.round(f / a_step), -QMAX, QMAX)
    return codes.to(torch.int8), a_step


def _accumulate(codes, wq):
    """The exact int32 product codes [T, K] · wq [K, N]. Upcast before the
    product: torch's int8 matmul on the CPU returns int8 and wraps. On the
    card torch has no integer matmul; float64 holds every partial sum
    (|sum| <= 127 · 127 · K < 2^53) exactly, so the product is the same."""
    if codes.device.type == "cpu":
        return codes.to(torch.int32) @ wq.to(torch.int32)
    return (codes.to(torch.float64) @ wq.to(torch.float64)).to(torch.int32)


def w8a8_linear_plain(x, weight_q, w_step, bias=None, int4=False,
                      return_parts=False):
    """Plain PyTorch version on x [..., K]: the codes, the exact int32
    product, and the f32 epilogue (acc · a_step) · w_step (+ bias) in
    that order, cast to x's dtype. `return_parts`: also (codes, a_step
    [T], acc int32 [T, N])."""
    lead, K = x.shape[:-1], x.shape[-1]
    codes, a_step = quantize_rows_plain(x.reshape(-1, K))
    wq = unpack_int4(weight_q, axis=0) if int4 else weight_q
    acc = _accumulate(codes, wq)
    out = acc.to(torch.float32) * a_step * w_step.reshape(1, -1)
    if bias is not None:
        out = out + bias.to(torch.float32)
    out = out.to(x.dtype).reshape(*lead, -1)
    if return_parts:
        return out, codes, a_step.reshape(-1), acc
    return out


def w8a8_linear(x, weight_q, w_step, bias=None, int4=False,
                return_parts=False):
    """x [..., K] (f32 / bf16), weight_q int8 [K, N] or packed int4
    [K/2, N] (`int4`), w_step f32 [1, N] or [N], bias [N] or None → out
    [..., N] in x's dtype. `return_parts` (checks): also (codes int8
    [T, K], a_step f32 [T], acc int32 [T, N]) as the kernel computed
    them."""
    if x.device.type == "cpu":
        return w8a8_linear_plain(x, weight_q, w_step, bias, int4,
                                 return_parts)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch(x, weight_q, w_step, bias, bool(int4), return_parts)


def _check(name, t, device, dtypes):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _kernel_fn():
    fn = _build.load("int8_gemm").pt_w8a8_linear
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(x, weight_q, w_step, bias, int4, return_parts):
    dev = x.device
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    T = x2.shape[0]
    _check("x", x2, dev, tuple(_X_KINDS))
    _check("weight_q", weight_q, dev, (torch.int8,))
    _check("w_step", w_step, dev, (torch.float32,))
    Kw, N = weight_q.shape
    if Kw * (2 if int4 else 1) != K or w_step.numel() != N:
        raise ValueError(
            f"weight {tuple(weight_q.shape)}{' (packed int4)' if int4 else ''}"
            f" / w_step {tuple(w_step.shape)} do not fit x [..., {K}]")
    if K % (32 if int4 else 16) or N % 16:
        raise ValueError(f"the int8 GEMM needs in_features % "
                         f"{32 if int4 else 16} == 0 and out_features % 16 "
                         f"== 0, got [{K}, {N}]")
    if bias is not None:
        _check("bias", bias, dev, (x2.dtype,))
        if bias.numel() != N:
            raise ValueError(f"bias has {bias.numel()} entries, not {N}")
    out = torch.empty((T, N), dtype=x2.dtype, device=dev)
    if T == 0:
        return out.reshape(*lead, N)
    codes = torch.empty((T, K), dtype=torch.int8, device=dev)
    a_step = torch.empty((T,), dtype=torch.float32, device=dev)
    acc = (torch.empty((T, N), dtype=torch.int32, device=dev)
           if return_parts else None)
    err = _kernel_fn()(
        x2.data_ptr(), codes.data_ptr(), a_step.data_ptr(),
        weight_q.data_ptr(), w_step.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        None if acc is None else acc.data_ptr(), T, K, N,
        _X_KINDS[x2.dtype], int(int4),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"int8 GEMM launch failed: cudaError {err}")
    launches["w4a8" if int4 else "w8a8"] += 1
    out = out.reshape(*lead, N)
    if return_parts:
        return out, codes, a_step, acc
    return out
