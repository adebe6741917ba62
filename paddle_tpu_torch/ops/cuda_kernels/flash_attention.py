"""Flash attention — the training kernels K3-K5 and their plain versions.

Counterpart of paddle_tpu/ops/pallas_kernels/flash_attention.py. The
kernels are CUDA C++ for sm_90a (`csrc/flash_attention.cu`, whose header
says what bounds them and how they are built), bound with ctypes:

* `flash_forward`  (K3) → (out, lse)
* `flash_bwd_dq`   (K4) → dq
* `flash_bwd_dkv`  (K5) → (dk, dv)

on the [batch·heads, seq, head_dim] layout. For tensors on the CPU each
wrapper runs its `*_plain` version; for CUDA tensors it launches its
kernel (and raises on anything the kernel does not take). `launches`
counts kernel launches per wrapper — it moves only where a kernel
launches, so a run can show that its main path went through the kernels.

Each kernel has two routes, chosen by `tensor_core_route` from the
input type and head_dim alone: bf16 with head_dim 64 or 128 goes to the
tensor-core kernels (`fa_fwd_tc_kernel`, `fa_bwd_dq_tc_kernel`,
`fa_bwd_dkv_tc_kernel`), every other input to the f32-math CUDA-core
kernels, which stay the exact f32 path. A route is never a fallback: a
build or launch error raises. `tc_launches` counts the launches that
took the tensor-core route.

`_FlashAttentionBHD` and `_FlashAttentionLseBHD` are the autograd
Functions that mirror the reference's two `custom_vjp`s;
`flash_attention_bshd` is the public entry on the paddle layout
[batch, seq, heads, head_dim].
"""
import ctypes
import math

import torch

from . import _build

__all__ = ["flash_attention_bshd", "flash_attention_lse_bhd",
           "flash_forward", "flash_bwd_dq", "flash_bwd_dkv",
           "flash_forward_plain", "flash_bwd_dq_plain",
           "flash_bwd_dkv_plain", "launches", "tc_launches",
           "reset_launches", "tensor_core_route"]

NEG_INF = -1e30
DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 512
SOURCE = "paddle_tpu_torch/csrc/flash_attention.cu"
_REF = "paddle_tpu/ops/pallas_kernels/flash_attention.py"
REPLACES = {"flash_forward": f"{_REF}:42",
            "flash_bwd_dq": f"{_REF}:183",
            "flash_bwd_dkv": f"{_REF}:246"}

# head dims the tensor-core kernels are built for (bf16 inputs only)
TC_HEAD_DIMS = (64, 128)

launches = dict.fromkeys(REPLACES, 0)
tc_launches = dict.fromkeys(REPLACES, 0)


def reset_launches():
    for counts in (launches, tc_launches):
        for name in counts:
            counts[name] = 0


def tensor_core_route(dtype, head_dim):
    """True when K3, K4 and K5 on these inputs take the tensor-core
    kernels (bf16, head_dim 64 or 128); False: the CUDA-core kernels."""
    return dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS


# ---------------------------------------------------------------- plain

def _allowed(q, k, causal, lens):
    """[bh or 1, s, sk] bool: which (row, col) pairs attend."""
    s, sk = q.shape[1], k.shape[1]
    cols = torch.arange(sk, device=q.device)
    ok = torch.ones((1, s, sk), dtype=torch.bool, device=q.device)
    if causal:   # top-aligned diagonal, as in the TPU kernels
        ok = ok & (cols[None, :] <= torch.arange(s, device=q.device)[:, None])
    if lens is not None:
        ok = ok & (cols[None, None, :] < lens.long()[:, None, None])
    return ok


def _masked_kv(x, lens):
    """k / v rows past each row's valid length → zeros (as the TPU
    kernels zero them), so no 0 · inf reaches a product."""
    if lens is None:
        return x.float()
    keep = torch.arange(x.shape[1], device=x.device)[None, :] \
        < lens.long()[:, None]
    return torch.where(keep[:, :, None], x.float(), 0.0)


def flash_forward_plain(q, k, v, causal=False, lens=None):
    """Plain version of K3: q [bh, s, d], k/v [bh, sk, d], lens [bh] int
    or None → (out [bh, s, d] in q's dtype, lse [bh, 1, s] f32). Scores
    in f32; p rounded to v's dtype before the PV product; a row with no
    valid key gives zeros and lse = -1e30."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    ok = _allowed(q, k, causal, lens)
    sc = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    sc = torch.where(ok, sc, NEG_INF)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(sc - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, 1.0, l)
    out = torch.matmul(p.to(v.dtype).float(), _masked_kv(v, lens)) / safe_l
    lse = (m + torch.log(safe_l)).transpose(1, 2)
    return out.to(q.dtype), lse.contiguous()


def _bwd_plain(q, k, v, g, lse, delta, causal, lens):
    scale = 1.0 / math.sqrt(q.shape[-1])
    ok = _allowed(q, k, causal, lens)
    kf, vf = _masked_kv(k, lens), _masked_kv(v, lens)
    sc = torch.matmul(q.float(), kf.transpose(1, 2)) * scale
    p = torch.where(ok, torch.exp(sc - lse.transpose(1, 2)), 0.0)
    dp = torch.matmul(g.float(), vf.transpose(1, 2))
    ds = torch.where(ok, p * (dp - delta.transpose(1, 2)), 0.0)
    return p.to(g.dtype).float(), ds.to(q.dtype).float(), kf, scale


def flash_bwd_dq_plain(q, k, v, g, lse, delta, causal=False, lens=None):
    """Plain version of K4: dq = Σ_k ds·k·scale with ds = p∘(g·vᵀ − delta),
    p = exp(q·kᵀ·scale − lse); ds rounded to q's dtype before ds·k."""
    _, ds, kf, scale = _bwd_plain(q, k, v, g, lse, delta, causal, lens)
    return (torch.matmul(ds, kf) * scale).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, g, lse, delta, causal=False, lens=None):
    """Plain version of K5: dk = Σ_q dsᵀ·q·scale, dv = Σ_q pᵀ·g; p and
    ds rounded to the input dtype before the products."""
    p, ds, _, scale = _bwd_plain(q, k, v, g, lse, delta, causal, lens)
    dk = torch.matmul(ds.transpose(1, 2), q.float()) * scale
    dv = torch.matmul(p.transpose(1, 2), g.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------- kernels

_KINDS = {torch.float32: 0, torch.bfloat16: 1}


def _check(name, x, device, dtypes, shape, align=16):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, q on {device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name} dtype {x.dtype} not in {dtypes}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def _check_inputs(q, k, v, g=None, lse=None, delta=None, lens=None):
    """Device, dtype, shape, contiguity and alignment of every operand;
    returns (bh, s, sk, d)."""
    dev = q.device
    if q.dim() != 3:
        raise ValueError(f"q must be [bh, s, d], got {tuple(q.shape)}")
    bh, s, d = q.shape
    sk = k.shape[1] if k.dim() == 3 else -1
    if d % 8 or d > 256:
        raise ValueError(f"head_dim {d} must be a multiple of 8, <= 256")
    if min(bh, s, sk) <= 0:
        raise ValueError(f"empty attention: bh {bh}, seq {s}, seq_k {sk}")
    _check("q", q, dev, tuple(_KINDS), (bh, s, d))
    _check("k", k, dev, (q.dtype,), (bh, sk, d))
    _check("v", v, dev, (q.dtype,), (bh, sk, d))
    if g is not None:
        _check("g", g, dev, (q.dtype,), (bh, s, d))
        _check("lse", lse, dev, (torch.float32,), (bh, 1, s), align=4)
        _check("delta", delta, dev, (torch.float32,), (bh, 1, s), align=4)
    if lens is not None:
        _check("lens", lens, dev, (torch.int32,), (bh,), align=4)
    return bh, s, sk, d


def _fn(name, n_ptrs):
    fn = getattr(_build.load("flash_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _ptr(x):
    return None if x is None else x.data_ptr()


def _raise_on(err, what):
    if err:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def _device_check(q):
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")


def flash_forward(q, k, v, causal=False, lens=None):
    """K3. q [bh, s, d], k/v [bh, sk, d] (float32 or bfloat16), lens
    [bh] int32 or None (clamped to sk by the caller) → (out [bh, s, d]
    in q's dtype, lse [bh, 1, s] float32). Route: `tensor_core_route`."""
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, causal, lens)
    _device_check(q)
    bh, s, sk, d = _check_inputs(q, k, v, lens=lens)
    tc = tensor_core_route(q.dtype, d)
    out = torch.empty_like(q)
    lse = torch.empty((bh, 1, s), dtype=torch.float32, device=q.device)
    err = _fn("pt_flash_fwd_tc" if tc else "pt_flash_fwd", 6)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(lens),
        out.data_ptr(), lse.data_ptr(), bh, s, sk, d, int(bool(causal)),
        1.0 / math.sqrt(d), _KINDS[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "flash attention forward")
    launches["flash_forward"] += 1
    tc_launches["flash_forward"] += tc
    return out, lse


def flash_bwd_dq(q, k, v, g, lse, delta, causal=False, lens=None):
    """K4. g [bh, s, d] in q's dtype, lse / delta [bh, 1, s] float32 →
    dq [bh, s, d]. Route: `tensor_core_route`."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, g, lse, delta, causal, lens)
    _device_check(q)
    bh, s, sk, d = _check_inputs(q, k, v, g, lse, delta, lens)
    tc = tensor_core_route(q.dtype, d)
    dq = torch.empty_like(q)
    err = _fn("pt_flash_bwd_dq_tc" if tc else "pt_flash_bwd_dq", 8)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _ptr(lens), dq.data_ptr(), bh, s,
        sk, d, int(bool(causal)), 1.0 / math.sqrt(d), _KINDS[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "flash attention dq")
    launches["flash_bwd_dq"] += 1
    tc_launches["flash_bwd_dq"] += tc
    return dq


def flash_bwd_dkv(q, k, v, g, lse, delta, causal=False, lens=None):
    """K5. The same operands as K4 → (dk, dv), each [bh, sk, d]. Route:
    `tensor_core_route`."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, g, lse, delta, causal, lens)
    _device_check(q)
    bh, s, sk, d = _check_inputs(q, k, v, g, lse, delta, lens)
    tc = tensor_core_route(q.dtype, d)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = _fn("pt_flash_bwd_dkv_tc" if tc else "pt_flash_bwd_dkv", 9)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _ptr(lens), dk.data_ptr(),
        dv.data_ptr(), bh, s, sk, d, int(bool(causal)), 1.0 / math.sqrt(d),
        _KINDS[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "flash attention dk/dv")
    launches["flash_bwd_dkv"] += 1
    tc_launches["flash_bwd_dkv"] += tc
    return dk, dv


# ---------------------------------------------------------------- autograd

def _attn_bwd(q, k, v, out, lse, g, causal, g_lse=None, lens=None):
    """dq pass (K4) + dk/dv pass (K5). delta = rowsum(g·out) in f32 stays
    a plain op outside the kernels, as in the reference; an lse
    cotangent enters as delta − g_lse."""
    gf = g.to(q.dtype).contiguous()
    delta = (g.float() * out.float()).sum(dim=-1)[:, None, :]
    if g_lse is not None:
        delta = delta - g_lse.float()
    delta = delta.contiguous()
    dq = flash_bwd_dq(q, k, v, gf, lse, delta, causal, lens)
    dk, dv = flash_bwd_dkv(q, k, v, gf, lse, delta, causal, lens)
    return dq, dk, dv


class _FlashAttentionBHD(torch.autograd.Function):
    """Mirrors `_flash_attention_bhd` (flash_attention.py:410): the
    forward is K3, the backward K4 + K5."""

    @staticmethod
    def forward(ctx, q, k, v, lens, causal):
        out, lse = flash_forward(q, k, v, causal, lens)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.lens, ctx.causal = lens, causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _attn_bwd(q, k, v, out, lse, g, ctx.causal,
                               lens=ctx.lens)
        return dq, dk, dv, None, None


class _FlashAttentionLseBHD(torch.autograd.Function):
    """Mirrors `flash_attention_lse_bhd` (flash_attention.py:438): both
    out and lse are differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        dq, dk, dv = _attn_bwd(q, k, v, out, lse, g_out, ctx.causal,
                               g_lse=g_lse)
        return dq, dk, dv, None


def _contiguous(*xs):
    return [x.contiguous() for x in xs]


def flash_attention_lse_bhd(q, k, v, causal=False, block_q=DEFAULT_BLOCK_Q,
                            block_k=DEFAULT_BLOCK_K):
    """(out [bh, s, d], lse [bh, 1, s]) with BOTH outputs differentiable —
    the building block for streaming merges across devices. `block_q` /
    `block_k` are the TPU kernel's tile sizes, kept for the reference's
    signature: the Hopper kernels choose their tile from head_dim."""
    return _FlashAttentionLseBHD.apply(*_contiguous(q, k, v), bool(causal))


def flash_attention_bshd(q, k, v, causal=False, block_q=DEFAULT_BLOCK_Q,
                         block_k=DEFAULT_BLOCK_K, kv_lens=None):
    """Fused attention on [batch, seq, heads, head_dim] (paddle layout),
    differentiable; forward K3, backward K4 + K5, over the
    [batch·heads, seq, head_dim] layout (one transpose each way).

    kv_lens: optional [batch] int per-example valid key length (prefix
    key-padding mask), clamped to seq_k: columns >= len get zero weight
    and their k/v rows zero gradient; a length of 0 gives zero rows.
    `block_q` / `block_k` are kept for the reference's signature (see
    `flash_attention_lse_bhd`)."""
    b, s, h, d = q.shape
    sk = k.shape[1]
    if causal and s != sk:
        # the kernels' diagonal is top-aligned; the dense reference is
        # bottom-aligned — only identical for self-attention
        raise ValueError(
            f"causal flash attention requires seq_q == seq_k, got {s} vs "
            f"{sk}; use the dense path for cross-length causal masks")

    def to_bhd(t, sl):
        return t.transpose(1, 2).reshape(b * h, sl, t.shape[-1]).contiguous()

    lens = None
    if kv_lens is not None:
        # [b] -> [b·h] (batch-major, then head); clamp to seq_k so the
        # kernels' column mask also covers the buffer tail
        lens = torch.clamp(torch.as_tensor(kv_lens, device=q.device),
                           max=sk).to(torch.int32).repeat_interleave(h)
    out = _FlashAttentionBHD.apply(to_bhd(q, s), to_bhd(k, sk),
                                   to_bhd(v, sk), lens, bool(causal))
    return out.reshape(b, h, s, d).transpose(1, 2)
