"""W8A8 linear — the int8 GEMM of weight-only quantized serving, its
planner, and its plain version.

No Pallas kernel is behind it: the JAX package's `Int8WeightOnlyLinear`
and `Int4WeightOnlyLinear` (paddle_tpu/quantization/runtime.py:134,
:209) compute `lax.dot_general(int8, int8 -> int32)` and leave it to
XLA. On CUDA `torch.matmul` has no int8 path and `torch._int_mm` needs
more than 16 rows, so the exact int32 product is a CUDA C++ kernel for
sm_90a (`csrc/int8_gemm.cu`, whose header says what bounds it and how it
is built), bound with ctypes: at up to 16 rows (decode ticks and fused
windows) one launch a linear, the activation quantize inside; above, a
row quantize and the GEMM, which starts under it (programmatic
dependent launch).

`w8a8_linear(x, weight_q, w_step, bias, int4)` computes, in the
reference's order: x's per-row codes (a_step = max(max|x|, 1e-8) / 127,
codes = clip(round_half_even(x / a_step), -127, 127)), the int32 product
with the int8 weight [in, out] (or the packed int4 weight [in/2, out],
split-halves layout), and the f32 epilogue (acc · a_step) · w_step
(+ bias), cast to x's dtype. For tensors on the CPU it runs
`w8a8_linear_plain`; for CUDA tensors it launches the kernel (and raises
on anything the kernel does not take). `prepare` checks a weight once;
a caller that keeps its result (`_WeightOnlyLinear` does) passes it as
`prepared=` and each call then checks only x and the bias. `launches`
counts launches of the GEMM, "w8a8" for int8 weights and "w4a8" for
packed int4 ones, one a linear call; `route_launches` counts the same
calls by the plan's route ("w8a8_decode", "w8a8_wide", ...). Both move
only where a kernel launches (a CUDA graph's capture counts once, and
its owner adds the count again at each replay).

`plan(T, K, N, int4)` is the kernel's tiling, chosen here and passed to
it: the route (decode up to 16 rows, wide above: 16- or 64-token
tiles of 32 columns) and the split of the weight's rows into k-ranges
of whole 32-row steps, one thread-block cluster of at most 8 blocks per
tile, so that a shape fills the card's 132 SMs where it can. The kernel
refuses a plan whose shared memory is not what it lays out.
"""
import ctypes
import functools
from typing import NamedTuple

import torch

from ...quantization.runtime import QMAX, unpack_int4
from . import _build

__all__ = ["w8a8_linear", "w8a8_linear_plain", "quantize_rows_plain",
           "plan", "prepare", "Plan", "PreparedWeight", "launches",
           "route_launches", "reset_launches"]

SOURCE = "paddle_tpu_torch/csrc/int8_gemm.cu"
_REF = "paddle_tpu/quantization/runtime.py"
REPLACES = {"w8a8": f"{_REF}:134 (lax.dot_general, no Pallas kernel)",
            "w4a8": f"{_REF}:209 (lax.dot_general, no Pallas kernel)"}

launches = dict.fromkeys(REPLACES, 0)
ROUTES = ("decode", "wide")
# the same launches by the plan's route: "<key>_decode" (T <= 16, the
# decode kernel) and "<key>_wide" (the row quantize + the wide kernel)
route_launches = {f"{k}_{r}": 0 for k in REPLACES for r in ROUTES}

_X_KINDS = {torch.float32: 0, torch.bfloat16: 1}
# the current stream's handle as an int, without a Stream object (CUDA
# builds of torch; `torch.cuda.current_stream` where it is missing)
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)

# the kernel's layout (csrc/int8_gemm.cu: kStepRows, kWarpCols,
# kMaxSplits, kDecodeRows, kDecodeThreads, kWarpStages, kCodePad,
# kWideRows, kWideThreads, kWideStages, kCodeLd)
STEP_ROWS = 32          # weight rows (as stored) of a step: the mma's k32
WARP_COLS = 32          # output columns of a warp; of a decode block
MAX_SPLITS = 8          # k-ranges of a tile: one portable cluster
DECODE_ROWS = 16        # up to this many rows: the decode route
DECODE_WARPS = 8
WARP_STAGES = 4         # cp.async ring depth of each decode warp
CODE_PAD = 16
WIDE_ROWS = 64          # tokens of a wide block
WIDE_COLS = 128         # columns of a wide block: 4 warps
WIDE_STAGES = 6         # cp.async ring depth of a wide block
CODE_LD = 48            # a token's codes of one step in a wide stage
SMS = 132               # the H100's streaming multiprocessors
SMEM_LIMIT = 232448     # dynamic shared memory a block may opt into


def reset_launches():
    for counts in (launches, route_launches):
        for name in counts:
            counts[name] = 0


# ------------------------------------------------------------- the plan

def _smem(T, per, int4):
    """Dynamic shared memory of a block (the .cu's `decode_smem` /
    `wide_smem`). Decode: the 8 warps' weight rings, the int32 partial
    slots ([S][ceil(16 / S)] rows, at most 16 + 8), the codes of its
    k-range (a padded row per token), the rows' steps, the columns'
    w_step and bias. Wide: the ring of weight + codes stages, the partial
    slots (at most 64 + 8 rows of 128), the steps, w_step and bias."""
    h = 2 if int4 else 1
    if T <= DECODE_ROWS:
        return (DECODE_WARPS * WARP_STAGES * STEP_ROWS * WARP_COLS
                + (DECODE_ROWS + MAX_SPLITS) * WARP_COLS * 4
                + DECODE_ROWS * (h * per * STEP_ROWS + CODE_PAD)
                + DECODE_ROWS * 4 + WARP_COLS * 8)
    return (WIDE_STAGES * (WIDE_COLS * STEP_ROWS + h * WIDE_ROWS * CODE_LD)
            + (WIDE_ROWS + MAX_SPLITS) * WIDE_COLS * 4 + WIDE_ROWS * 4
            + WIDE_COLS * 8)


class Plan(NamedTuple):
    """The kernel's tiling of one [T, K] x [K, N] product: blocks of 32
    columns x 16 tokens (decode route) or 128 x 64 (wide route), each over
    `per` weight steps of 32 stored rows; `splits` blocks (one cluster)
    cover a tile's `steps`."""
    T: int
    K: int
    N: int
    int4: bool
    splits: int
    per: int
    steps: int
    m_tiles: int
    n_tiles: int
    smem: int

    @property
    def decode(self):
        """T <= 16: one launch, the quantize inside; above, the wide
        route: the row quantize, then the GEMM (two launches)."""
        return self.T <= DECODE_ROWS

    @property
    def launches(self):
        return 1 if self.decode else 2

    @property
    def rows(self):
        """The weight's rows as stored (K/2 packed int4)."""
        return self.K // 2 if self.int4 else self.K

    @property
    def blocks(self):
        return self.splits * self.n_tiles * self.m_tiles


@functools.lru_cache(maxsize=4096)
def plan(T, K, N, int4):
    """The tiling of a [T, K] x [K, N] product (`Plan`): 32 columns and
    16 tokens a block up to 16 rows, 128 x 64 above; the k-split is the
    fewest ranges of whole steps (at most 8, one cluster) that reach 132
    blocks, or the most the shape allows, and no fewer than a block's
    shared memory allows."""
    rows = K // 2 if int4 else K
    steps = -(-rows // STEP_ROWS)
    decode = T <= DECODE_ROWS
    m_tiles = -(-T // (DECODE_ROWS if decode else WIDE_ROWS))
    n_tiles = -(-N // (WARP_COLS if decode else WIDE_COLS))
    best = None
    for s in range(1, min(MAX_SPLITS, steps) + 1):
        per = -(-steps // s)
        splits = -(-steps // per)
        if _smem(T, per, int4) > SMEM_LIMIT:
            continue
        if best is None or splits > best[0]:
            best = (splits, per)
        if splits * n_tiles * m_tiles >= SMS:
            break
    if best is None:
        raise ValueError(f"the int8 GEMM cannot tile [{T}, {K}] x [{K}, "
                         f"{N}]: a k-range's codes exceed shared memory")
    splits, per = best
    return Plan(T, K, N, bool(int4), splits, per, steps, m_tiles, n_tiles,
                _smem(T, per, int4))


# -------------------------------------------------------- plain version

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
                      return_parts=False, prepared=None):
    """Plain PyTorch version on x [..., K]: the codes, the exact int32
    product, and the f32 epilogue (acc · a_step) · w_step (+ bias) in
    that order, cast to x's dtype. `return_parts`: also (codes, a_step
    [T], acc int32 [T, N]). `prepared` is taken for the kernel's
    signature and not needed."""
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


# -------------------------------------------------------------- kernel

class PreparedWeight(NamedTuple):
    """A weight the kernel takes, checked once: its tensors and bias (a
    caller re-prepares when they are replaced), K, N, the width and the
    device. Addresses are read at each call: a copied module carries
    this record with its copied tensors."""
    weight_q: torch.Tensor
    w_step: torch.Tensor
    bias: object            # the checked bias tensor, or None
    int4: bool
    K: int
    N: int
    device: torch.device


def _check(name, t, device, dtypes):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def prepare(weight_q, w_step, int4=False, bias=None):
    """Check a CUDA weight (and its bias) once: device, dtype, layout,
    alignment, the kernel's shape rules → `PreparedWeight`. Raises on
    anything the kernel does not take."""
    dev = weight_q.device
    if dev.type != "cuda":
        raise ValueError(f"prepare: the weight is on {dev}, not a card")
    _check("weight_q", weight_q, dev, (torch.int8,))
    _check("w_step", w_step, dev, (torch.float32,))
    if weight_q.dim() != 2:
        raise ValueError(f"weight_q must be 2-D, got {tuple(weight_q.shape)}")
    Kw, N = weight_q.shape
    K = Kw * (2 if int4 else 1)
    if w_step.numel() != N:
        raise ValueError(f"w_step {tuple(w_step.shape)} does not fit weight "
                         f"{tuple(weight_q.shape)}")
    if K % (32 if int4 else 16) or N % 16:
        raise ValueError(f"the int8 GEMM needs in_features % "
                         f"{32 if int4 else 16} == 0 and out_features % 16 "
                         f"== 0, got [{K}, {N}]")
    if bias is not None:
        _check("bias", bias, dev, tuple(_X_KINDS))
        if bias.numel() != N:
            raise ValueError(f"bias has {bias.numel()} entries, not {N}")
    return PreparedWeight(weight_q, w_step, bias, bool(int4), int(K), int(N),
                          dev)


def w8a8_linear(x, weight_q, w_step, bias=None, int4=False,
                return_parts=False, prepared=None):
    """x [..., K] (f32 / bf16), weight_q int8 [K, N] or packed int4
    [K/2, N] (`int4`), w_step f32 [1, N] or [N], bias [N] or None → out
    [..., N] in x's dtype. `prepared`: `prepare(weight_q, w_step, int4)`,
    kept by the caller (else it is made here, checks and all); a record
    of other tensors than `weight_q` / `w_step` raises.
    `return_parts` (checks): also (codes int8 [T, K], a_step f32 [T],
    acc int32 [T, N]) as the kernel computed them."""
    if prepared is not None and (
            prepared.weight_q is not weight_q or prepared.w_step is not w_step
            or prepared.int4 != bool(int4)):
        raise ValueError("prepared= was made for another weight: "
                         "prepare(weight_q, w_step, int4) again")
    if x.device.type == "cpu":
        return w8a8_linear_plain(x, weight_q, w_step, bias, int4,
                                 return_parts)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if prepared is None:
        prepared = prepare(weight_q, w_step, int4, bias)
    return _launch(x, prepared, bias, return_parts)


def _kernel_fn():
    fn = _build.load("int8_gemm").pt_w8a8_linear
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(x, w, bias, return_parts):
    dev = x.device
    K = x.shape[-1]
    if K != w.K or dev != w.device:
        raise ValueError(
            f"weight [{w.K}, {w.N}]{' (packed int4)' if w.int4 else ''} on "
            f"{w.device} does not fit x [..., {K}] on {dev}")
    flat = x.dim() == 2
    x2 = x if flat else x.reshape(-1, K)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    kind = _X_KINDS.get(x2.dtype)
    if kind is None:
        raise TypeError(f"x dtype {x2.dtype} not in {tuple(_X_KINDS)}")
    x_ptr = x2.data_ptr()
    if x_ptr % 16:
        raise ValueError("x must be 16-byte aligned")
    N, T = w.N, x2.shape[0]
    if bias is not None:
        if bias is not w.bias:         # the prepared bias is checked
            _check("bias", bias, dev, (x2.dtype,))
            if bias.numel() != N:
                raise ValueError(f"bias has {bias.numel()} entries, not {N}")
        elif bias.dtype != x2.dtype:
            raise TypeError(f"bias dtype {bias.dtype} is not x's {x2.dtype}")
    out = torch.empty((T, N), dtype=x2.dtype, device=dev)
    if T == 0:
        return out if flat else out.reshape(*x.shape[:-1], N)
    p = plan(T, K, N, w.int4)
    codes = a_step = acc = None
    if return_parts or not p.decode:   # the wide route's own buffers
        codes = torch.empty((T, K), dtype=torch.int8, device=dev)
        a_step = torch.empty((T,), dtype=torch.float32, device=dev)
    if return_parts:
        acc = torch.empty((T, N), dtype=torch.int32, device=dev)
    err = _kernel_fn()(
        x_ptr, w.weight_q.data_ptr(), w.w_step.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        None if codes is None else codes.data_ptr(),
        None if a_step is None else a_step.data_ptr(),
        None if acc is None else acc.data_ptr(), T, K, N, kind, int(w.int4),
        p.splits, p.per, p.smem,
        _RAW_STREAM(dev.index) if _RAW_STREAM is not None
        else torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"int8 GEMM launch failed: cudaError {err}")
    key = "w4a8" if w.int4 else "w8a8"
    launches[key] += 1
    route_launches[f"{key}_{'decode' if p.decode else 'wide'}"] += 1
    if not flat:
        out = out.reshape(*x.shape[:-1], N)
    if return_parts:
        return out, codes, a_step, acc
    return out
