"""Ragged paged attention — the serving kernels and their plain version.

Counterpart of paddle_tpu/ops/pallas_kernels/paged_attention.py. The
kernels are CUDA C++ for sm_90a (`csrc/paged_attention.cu`, whose header
says what bounds them and how they are built), bound with ctypes:

* K1, one query row per flat token, over float pools or int8 /
  packed-int4 pools with per-row fp32 scale planes;
* K2, the same function on the speculative verify layout (`q_per_slot`):
  the T rows are slot-major blocks of qb rows, one slot per block, and
  each page of the slot is staged once per block instead of once per
  row.

Each has two routes (`paged_route`). A bf16 q on a bf16, int8 or int4
pool at head_dim 64 or 128 — every bf16 serving configuration — takes
the tensor-core route: chunks of one slot's rows staged once, split-KV
over up to 8 blocks per row and a merge, mma.sync with f32
accumulators, quantized pools staged as codes and scales
(`rpa_tc_plan_kernel` + `rpa_tc_kernel` + `rpa_tc_merge_kernel` for K1,
`rpa_tc_qblock_kernel` + `rpa_tc_qblock_merge_kernel` for K2, one
wrapper call each), derived on the device from `slot_ids` / `kv_lens`.
An f32 q, an f32 pool and every other head_dim keep the CUDA-core
kernels `rpa_kernel` / `rpa_qblock_kernel`: the exact f32 path.

`ragged_paged_attention` is the wrapper the model calls: for tensors on
the CPU it runs `ragged_paged_attention_plain`; for CUDA tensors it
launches K1 or K2 (and raises on anything the kernel does not take).
`launches` counts kernel launches, one entry per kernel and pool kind —
it moves only where a kernel launches, so a run can show its main path
went through the kernels; `tc_launches`, with the same keys, counts the
launches that took the tensor-core route. The counts move in Python, so
a CUDA graph that captures a call counts it once, at the capture: the
engine's fused window (`inference/llm_engine._FusedStep`) takes that
back and adds it again at every replay. A route is never a fallback: a
build or launch error raises.
"""
import ctypes
import math

import torch

from ...quantization.runtime import unpack_int4
from . import _build

__all__ = ["ragged_paged_attention", "ragged_paged_attention_plain",
           "launches", "tc_launches", "reset_launches", "paged_route",
           "stream_workspaces"]

NEG_INF = -1e30
MAX_QBLOCK = 16
SOURCE = "paddle_tpu_torch/csrc/paged_attention.cu"
_REF = "paddle_tpu/ops/pallas_kernels/paged_attention.py"
REPLACES = {"rpa": f"{_REF}:53", "rpa_int8": f"{_REF}:84",
            "rpa_int4": f"{_REF}:87", "qblock": f"{_REF}:131",
            "qblock_int8": f"{_REF}:168", "qblock_int4": f"{_REF}:169"}

# the tensor-core route: a bf16 q at these head dims on these pools
TC_HEAD_DIMS = (64, 128)
TC_POOL_KINDS = ("bf16", "int8", "int4")

launches = dict.fromkeys(REPLACES, 0)
tc_launches = dict.fromkeys(REPLACES, 0)


def reset_launches():
    for counts in (launches, tc_launches):
        for name in counts:
            counts[name] = 0


def paged_route(pool_kind, q_dtype, head_dim):
    """True when K1 and K2 (`q_per_slot`) on these inputs take their
    tensor-core route: a bfloat16 q on a "bf16", "int8" or "int4" pool at
    head_dim 64 or 128. False for an f32 q, an "f32" pool and every other
    head_dim: the CUDA-core `rpa_kernel` / `rpa_qblock_kernel`, which
    keep f32 math throughout (the exact f32 path)."""
    return (pool_kind in TC_POOL_KINDS and q_dtype == torch.bfloat16
            and head_dim in TC_HEAD_DIMS)


def _launch_key(kind, qb):
    """The `launches` / `tc_launches` key of a call: "rpa" (K1) or
    "qblock" (K2, `q_per_slot`), with "_int8" / "_int4" for a quantized
    pool (`kind` as `_pool_kind` names it)."""
    return ("qblock" if qb else "rpa") + (f"_{kind}" if kind else "")


def _pool_kind(k_pool, k_scales, head_dim):
    """"" for float pools, "int8" or "int4" for quantized ones: a
    quantized pool whose last dim is half of head_dim holds packed
    nibbles (the reference's discriminator)."""
    if k_scales is None:
        return ""
    return "int4" if k_pool.shape[-1] * 2 == head_dim else "int8"


def ragged_paged_attention(q, k_pool, v_pool, page_tables, slot_ids,
                           kv_lens, k_scales=None, v_scales=None,
                           frontier_offset=None, q_per_slot=None):
    """q [T, H, D], pools [N, P, H, D] (float), [N, P, H, D] int8 or
    [N, P, H, D/2] packed int4 with k_scales / v_scales [N, P, H] fp32,
    page_tables [S, MP] int32, slot_ids / kv_lens [T] int32 → out
    [T, H, D] in q's dtype.

    frontier_offset: optional int added to every nonzero kv_lens row.
    q_per_slot: optional int, the caller's guarantee that the T rows are
    slot-major blocks of exactly this many rows, one slot per block (the
    verify layout); T must be a multiple of it. On the card it selects
    K2."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("pass both k_scales and v_scales or neither")
    if q.device.type == "cpu":
        return ragged_paged_attention_plain(
            q, k_pool, v_pool, page_tables, slot_ids, kv_lens,
            k_scales=k_scales, v_scales=v_scales,
            frontier_offset=frontier_offset, q_per_slot=q_per_slot)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, k_pool, v_pool, k_scales, v_scales, page_tables,
                   slot_ids, kv_lens,
                   0 if frontier_offset is None else int(frontier_offset),
                   q_per_slot)


_Q_KINDS = {torch.float32: 0, torch.bfloat16: 1}
_KV_KINDS = {"f32": 0, "bf16": 1, "int8": 8, "int4": 4}
_FLOAT_KINDS = {torch.float32: "f32", torch.bfloat16: "bf16"}


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


def _kernel_fn(n_ptrs):
    fn = _build.load("paged_attention").pt_ragged_paged_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _tc_fn():
    fn = _build.load("paged_attention").pt_ragged_paged_attention_tc
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_longlong] + [
            ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


_tc_bytes = {}       # (T, H, D, P, MP, qb) -> workspace bytes
_tc_buffers = {}     # (device, stream) -> the workspace tensor


def _tc_workspace(dev, stream, T, H, D, P, MP, qb):
    """(workspace, its bytes) of the tensor-core route: the split partials
    (and K1's work items) as the kernel's own layout sizes them. The size
    is cached per shape; the buffer is one per (device, stream), grown to
    the largest size asked, and reused — calls on one stream run in
    order, so no allocation is made per call."""
    key = (T, H, D, P, MP, qb)
    nbytes = _tc_bytes.get(key)
    if nbytes is None:
        lib = _build.load("paged_attention")
        fn = lib.pt_ragged_paged_attention_tc_workspace
        fn.argtypes = [ctypes.c_int] * 6
        fn.restype = ctypes.c_longlong
        nbytes = _tc_bytes[key] = int(fn(*key))
    ws = _tc_buffers.get((dev, stream))
    if ws is None or ws.numel() < nbytes:
        ws = _tc_buffers[(dev, stream)] = torch.empty(
            (nbytes,), dtype=torch.uint8, device=dev)
    return ws, nbytes


def stream_workspaces(stream):
    """The tensor-core workspaces kept for `stream` (its `cuda_stream`
    handle). A CUDA graph captured on that stream holds their addresses,
    and `_tc_workspace` replaces a buffer that a later call outgrows: the
    graph's owner keeps these tensors alive."""
    return [ws for (_, st), ws in _tc_buffers.items() if st == stream]


def _launch(q, k_pool, v_pool, k_scales, v_scales, page_tables, slot_ids,
            kv_lens, offset, q_per_slot):
    dev = q.device
    T, H, D = q.shape
    kind = _pool_kind(k_pool, k_scales, D)
    # K1/K2 move 8 head_dim elements per vector access: 16 or 32 bytes
    # of a float row, 8 bytes of an int8 row; packed int4 rows are read
    # bytewise when D/2 is not a multiple of 8
    _check("q", q, dev, tuple(_Q_KINDS), 3, align=16)
    if kind:
        _check("k_pool", k_pool, dev, (torch.int8,), 4, align=8)
        _check("v_pool", v_pool, dev, (torch.int8,), 4, align=8)
        for name, s in (("k_scales", k_scales), ("v_scales", v_scales)):
            _check(name, s, dev, (torch.float32,), 3)
            if s.shape != k_pool.shape[:3]:
                raise ValueError(f"{name} shape {tuple(s.shape)} != pool "
                                 f"[N, P, H] {tuple(k_pool.shape[:3])}")
    else:
        _check("k_pool", k_pool, dev, tuple(_Q_KINDS), 4, align=16)
        _check("v_pool", v_pool, dev, (k_pool.dtype,), 4, align=16)
    pool_kind = kind or _FLOAT_KINDS[k_pool.dtype]
    for name, x, nd in (("page_tables", page_tables, 2),
                        ("slot_ids", slot_ids, 1), ("kv_lens", kv_lens, 1)):
        _check(name, x, dev, (torch.int32,), nd)
    _, P, Hk, Dk = k_pool.shape
    S, MP = page_tables.shape
    if kind == "int4" and D % 2:
        raise ValueError(f"int4 pools need an even head_dim, got {D}")
    d_store = D // 2 if kind == "int4" else D
    if (Hk, Dk) != (H, d_store) or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"pool shape {tuple(k_pool.shape)} / {tuple(v_pool.shape)} "
            f"does not match q [T, H={H}, D={D}]")
    if D % 8 or D > 256:
        raise ValueError(f"head_dim {D} must be a multiple of 8, <= 256")
    if slot_ids.shape[0] != T or kv_lens.shape[0] != T:
        raise ValueError("slot_ids / kv_lens must have one entry per token")
    qb = 0
    if q_per_slot is not None:
        qb = int(q_per_slot)
        if qb < 1 or qb > MAX_QBLOCK or T % qb:
            raise ValueError(
                f"q_per_slot {qb}: must be in 1..{MAX_QBLOCK} and divide "
                f"T={T}")
    tc = paged_route(pool_kind, q.dtype, D)
    if qb and not tc and 2 * P * D * 4 > 227 * 1024:
        raise ValueError(f"page [{P}, {D}] of K and V does not fit the "
                         "query-blocked kernel's shared memory")
    if tc and kind and k_pool.data_ptr() % 16 + v_pool.data_ptr() % 16:
        raise ValueError("the tensor-core route stages 16-byte chunks of "
                         "code rows: pools must be 16-byte aligned")
    out = torch.empty_like(q)
    if T == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    key = _launch_key(kind, qb)
    scales = (k_scales, v_scales) if kind else (k_pool, k_pool)
    if tc:
        ws, nbytes = _tc_workspace(dev, stream, T, H, D, P, MP, qb)
        err = _tc_fn()(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            scales[0].data_ptr(), scales[1].data_ptr(),
            page_tables.data_ptr(), slot_ids.data_ptr(), kv_lens.data_ptr(),
            out.data_ptr(), ws.data_ptr(), nbytes, T, H, D, P, MP, offset,
            1.0 / math.sqrt(D), 1, _KV_KINDS[pool_kind], qb, stream)
        if err:
            raise RuntimeError("ragged paged attention (tensor cores) kernel "
                               f"launch failed: cudaError {err}")
        launches[key] += 1
        tc_launches[key] += 1
        return out
    # the scale pointers of a float pool are never read
    ptrs = (q, k_pool, v_pool, *scales, page_tables, slot_ids, kv_lens, out)
    err = _kernel_fn(len(ptrs))(
        *(x.data_ptr() for x in ptrs), T, H, D, P, MP, offset,
        1.0 / math.sqrt(D), _Q_KINDS[q.dtype], _KV_KINDS[pool_kind], qb,
        stream)
    if err:
        raise RuntimeError(
            f"ragged paged attention kernel launch failed: cudaError {err}")
    launches[key] += 1
    return out


def ragged_paged_attention_plain(q, k_pool, v_pool, page_tables, slot_ids,
                                 kv_lens, k_scales=None, v_scales=None,
                                 frontier_offset=None, q_per_slot=None):
    """Plain PyTorch version — the slot-grid formulation of the JAX
    package's jnp path (nn/functional/attention.py:212-282): gather each
    SLOT's kv once ([S, L, H, D]; quantized pools dequantized to f32 by
    their per-row scales after the gather, int4 unpacked first), scatter
    the queries onto an [S, C] slot grid (C = q_per_slot when given, the
    most tokens any slot owns), one batched softmax attention, gather
    back per token. Scores and softmax statistics in f32; the weights are
    cast to V's dtype before the p·v product (bf16 for a bf16 pool, f32
    for a quantized one); padding rows (kv_len 0) come out as exact
    zeros."""
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
    ks = k_pool.reshape(n_pages * page_size, h, d)[phys]
    vs = v_pool.reshape(n_pages * page_size, h, d)[phys]
    if k_scales is not None:
        if _pool_kind(k_pool, k_scales, q.shape[-1]) == "int4":
            ks = unpack_int4(ks, axis=-1)
            vs = unpack_int4(vs, axis=-1)
            d = d * 2
        ksc = k_scales.reshape(n_pages * page_size, h)[phys]
        vsc = v_scales.reshape(n_pages * page_size, h)[phys]
        ks = ks.to(torch.float32) * ksc[..., None]
        vs = vs.to(torch.float32) * vsc[..., None]
    work = torch.promote_types(q.dtype, ks.dtype)
    ks = ks.to(work)
    # chunk position of each token within its slot (order-stable)
    eq = sids[:, None] == sids[None, :]
    cpos = torch.tril(eq, -1).sum(dim=1)                    # [T]
    C = tokens if q_per_slot is None else min(tokens, int(q_per_slot))
    qs = torch.zeros((n_slots, C, h, d), dtype=work, device=dev)
    qs[sids, cpos] = q.to(work)
    lgrid = torch.zeros((n_slots, C), dtype=torch.long, device=dev)
    lgrid[sids, cpos] = ls
    sc = torch.einsum("schd,slhd->shcl", qs, ks) / math.sqrt(d)
    allowed = l_idx[None, None, None, :] < lgrid[:, None, :, None]
    sc = sc.masked_fill(~allowed, NEG_INF)
    w = torch.softmax(sc.float(), dim=-1).to(vs.dtype)
    o = torch.einsum("shcl,slhd->schd", w, vs).to(q.dtype)
    out = o[sids, cpos]                                     # [T, h, d]
    return torch.where((ls > 0)[:, None, None], out, torch.zeros_like(out))
