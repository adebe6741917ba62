"""Ragged paged attention — the serving kernel and its plain version.

Counterpart of paddle_tpu/ops/pallas_kernels/paged_attention.py. The
kernel is CUDA C++ for sm_90a (`csrc/paged_attention.cu`, whose header
says what bounds it and how it is built), bound with ctypes.

`ragged_paged_attention` is the wrapper the model calls: for tensors on
the CPU it runs `ragged_paged_attention_plain`; for CUDA tensors it
launches the kernel (and raises on anything the kernel does not take).
`launches` counts kernel launches — it moves only where the kernel
launches, so a run can show its main path went through the kernel.
"""
import ctypes
import math

import torch

from . import _build

__all__ = ["ragged_paged_attention", "ragged_paged_attention_plain",
           "launches", "reset_launches"]

NEG_INF = -1e30
SOURCE = "paddle_tpu_torch/csrc/paged_attention.cu"
REPLACES = "paddle_tpu/ops/pallas_kernels/paged_attention.py:53"

launches = 0


def reset_launches():
    global launches
    launches = 0


def ragged_paged_attention(q, k_pool, v_pool, page_tables, slot_ids,
                           kv_lens, k_scales=None, v_scales=None,
                           frontier_offset=None):
    """q [T, H, D], pools [N, P, H, D], page_tables [S, MP] int32,
    slot_ids / kv_lens [T] int32 → out [T, H, D] in q's dtype.
    frontier_offset: optional int added to every nonzero kv_lens row."""
    if k_scales is not None or v_scales is not None:
        raise NotImplementedError(
            "int8/int4 paged KV pools come with the quantized runtime "
            "(ROADMAP A4, kernel K1's dequant branches)")
    if q.device.type == "cpu":
        return ragged_paged_attention_plain(
            q, k_pool, v_pool, page_tables, slot_ids, kv_lens,
            frontier_offset=frontier_offset)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, k_pool, v_pool, page_tables, slot_ids, kv_lens,
                   0 if frontier_offset is None else int(frontier_offset))


_KINDS = {torch.float32: 0, torch.bfloat16: 1}


def _check(name, x, device, dtypes, ndim, align=4):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, q on {device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name} dtype {x.dtype} not in {dtypes}")
    if x.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def _launch(q, k_pool, v_pool, page_tables, slot_ids, kv_lens, offset):
    dev = q.device
    floats = tuple(_KINDS)
    # the kernel moves 8 head_dim elements per 16/32-byte vector access
    _check("q", q, dev, floats, 3, align=16)
    _check("k_pool", k_pool, dev, floats, 4, align=16)
    _check("v_pool", v_pool, dev, (k_pool.dtype,), 4, align=16)
    for name, x, nd in (("page_tables", page_tables, 2),
                        ("slot_ids", slot_ids, 1), ("kv_lens", kv_lens, 1)):
        _check(name, x, dev, (torch.int32,), nd)
    T, H, D = q.shape
    _, P, Hk, Dk = k_pool.shape
    S, MP = page_tables.shape
    if (Hk, Dk) != (H, D) or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"pool shape {tuple(k_pool.shape)} / {tuple(v_pool.shape)} "
            f"does not match q [T, H={H}, D={D}]")
    if D % 8 or D > 256:
        raise ValueError(f"head_dim {D} must be a multiple of 8, <= 256")
    if slot_ids.shape[0] != T or kv_lens.shape[0] != T:
        raise ValueError("slot_ids / kv_lens must have one entry per token")
    out = torch.empty_like(q)
    if T == 0:
        return out
    fn = _build.load("paged_attention").pt_ragged_paged_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             page_tables.data_ptr(), slot_ids.data_ptr(),
             kv_lens.data_ptr(), out.data_ptr(), T, H, D, P, MP, offset,
             1.0 / math.sqrt(D), _KINDS[q.dtype], _KINDS[k_pool.dtype],
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(
            f"ragged paged attention kernel launch failed: cudaError {err}")
    global launches
    launches += 1
    return out


def ragged_paged_attention_plain(q, k_pool, v_pool, page_tables, slot_ids,
                                 kv_lens, frontier_offset=None):
    """Plain PyTorch version — the slot-grid formulation of the JAX
    package's jnp path (nn/functional/attention.py:212-282): gather each
    SLOT's kv once ([S, L, H, D]), scatter the queries onto an [S, C]
    slot grid, one batched softmax attention, gather back per token.
    Scores and softmax statistics in f32 even for bf16 pools; padding
    rows (kv_len 0) come out as exact zeros."""
    n_pages, page_size, h, d = k_pool.shape
    n_slots, pages_per_seq = page_tables.shape
    tokens = q.shape[0]
    dev = q.device
    L = pages_per_seq * page_size
    ls = kv_lens.long()
    if frontier_offset is not None:
        ls = torch.where(ls > 0, ls + frontier_offset, 0)
    sids = slot_ids.long()
    l_idx = torch.arange(L, device=dev)
    phys = (page_tables.long()[:, l_idx // page_size] * page_size
            + (l_idx % page_size)[None, :])                  # [S, L]
    work = torch.promote_types(q.dtype, k_pool.dtype)
    ks = k_pool.reshape(n_pages * page_size, h, d)[phys].to(work)
    vs = v_pool.reshape(n_pages * page_size, h, d)[phys]
    # chunk position of each token within its slot (order-stable)
    eq = sids[:, None] == sids[None, :]
    cpos = torch.tril(eq, -1).sum(dim=1)                    # [T]
    qs = torch.zeros((n_slots, tokens, h, d), dtype=work, device=dev)
    qs[sids, cpos] = q.to(work)
    lgrid = torch.zeros((n_slots, tokens), dtype=torch.long, device=dev)
    lgrid[sids, cpos] = ls
    sc = torch.einsum("schd,slhd->shcl", qs, ks) / math.sqrt(d)
    allowed = l_idx[None, None, None, :] < lgrid[:, None, :, None]
    sc = sc.masked_fill(~allowed, NEG_INF)
    w = torch.softmax(sc.float(), dim=-1).to(vs.dtype)
    o = torch.einsum("shcl,slhd->schd", w, vs).to(q.dtype)
    out = o[sids, cpos]                                     # [T, h, d]
    return torch.where((ls > 0)[:, None, None], out, torch.zeros_like(out))
