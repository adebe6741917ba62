"""Block-scaled int8 gradient collectives (counterpart of
paddle_tpu/distributed/quant_collective.py).

`quantized_pmean(x, axes)` is the mean of `x` over this rank's group
along each mesh axis in turn, with int8 on the wire. Per axis, over a
group of n (the reference's five passes):

1. per-block absmax over the flat payload (blocks of `DEFAULT_BLOCK`; a
   block holding a non-finite value gets scale +inf; at least 1e-12),
   divided by 127, then the all-reduce max of the scales over the group:
   every rank holds the same scales, which makes step 3 exact in int32;
2. int8 codes of this rank's whole payload against the shared scales
   (round half to even; a non-finite ratio clamps to a finite code — the
   poison travels in the scale);
3. a reduce-scatter by n − 1 direct exchanges of one int8 shard each
   (`xproc.send_bytes` / `recv_bytes`): at hop s each rank sends the
   shard of rank (idx − s) mod n to that rank and adds the shard it
   receives into an int32 accumulator;
4. dequantize: accumulator · scale / n, this rank's shard of the mean;
5. re-quantize that shard with fresh scales, all-gather the int8 codes
   and the f32 scales, and decode: every rank decodes the same bytes.

A NaN or inf on any rank makes its block's shared scale +inf, and the
block decodes to NaN on every rank alike. The quantize and dequantize
passes run on the payload's own device (plain torch ops, as the
reference's lax ops), so int8, not f32, crosses to the host; the
exchanges run over gloo and the socket transport.

`quantized_pmean_tree` fuses every leaf of at least `MIN_QUANT_SIZE`
elements into one flat f32 payload (blocks may span leaves) and gives the
smaller leaves the exact mean; leaf dtypes are kept. `stats`, when given,
gains the bytes this rank put into the collectives and their seconds.

Users: `DistributedTrainStep(quant_allreduce=True)` over its replica
axes, `HybridTrainStep(quant_allreduce=True)` / `Hybrid3DConfig(
quant_allreduce=True)` and `PipelineSpecs(quant_dp=True)` over dp, and
PT_QUANT_ALLREDUCE_XLA=1, the opt-in default of both steps.
"""
import os
import time

import numpy as np
import torch

from . import mesh as mesh_mod

__all__ = ["xla_quant_enabled", "quantized_pmean", "quantized_pmean_tree",
           "DEFAULT_BLOCK", "MIN_QUANT_SIZE", "QMAX"]

QMAX = 127.0
# per-block shared-scale granularity: 4/block bytes of scales an element
DEFAULT_BLOCK = 512
# leaves below this many elements take the exact f32 mean
MIN_QUANT_SIZE = 64

_TAG = 7301
# the reference's scales divide by 127 as XLA compiles it: a multiply by
# the f32 reciprocal
_INV_QMAX = float(np.float32(1.0) / np.float32(QMAX))


def xla_quant_enabled():
    """The PT_QUANT_ALLREDUCE_XLA opt-in (the eager wire's is
    `quantization.runtime.quant_allreduce_enabled`)."""
    return os.environ.get(
        "PT_QUANT_ALLREDUCE_XLA", "0").strip().lower() in (
            "1", "true", "yes", "on")


def _axis_tuple(axes):
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _quantize_shared(blocks, scale):
    """int8 codes of [nb, block] f32 against per-block `scale` [nb]."""
    q = torch.nan_to_num(torch.round(blocks / scale[:, None]), nan=0.0,
                         posinf=QMAX, neginf=-QMAX)
    return q.clamp(-QMAX, QMAX).to(torch.int8)


def _block_scales(blocks):
    """Per-block absmax/127; +inf for a block with a non-finite value."""
    absmax = blocks.abs().amax(1)
    absmax = torch.where(torch.isfinite(absmax), absmax,
                         torch.full_like(absmax, float("inf")))
    return absmax.clamp_min(1e-12) * _INV_QMAX


def _note(stats, nbytes, seconds):
    if stats is not None:
        stats["bytes"] = stats.get("bytes", 0) + int(nbytes)
        stats["seconds"] = stats.get("seconds", 0.0) + seconds


def _host(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return np.ascontiguousarray(t.cpu().numpy())


def _one_axis(flat, axis, block, stats):
    """The block-scaled int8 mean of f32 [N] over this rank's `axis`
    group (module docstring, steps 1-5)."""
    from . import env, xproc
    from .collective import _gather_np, axis_comm

    members, pg = axis_comm((axis,))
    n = len(members)
    if n == 1:
        return flat
    t0 = time.perf_counter()
    sent = 0
    dev = flat.device
    N = flat.numel()
    per = -(-N // (n * block)) * block
    padded = torch.nn.functional.pad(flat, (0, per * n - N))
    nb_total = per * n // block
    # 1. the shared scales
    scale = _block_scales(padded.view(nb_total, block))
    host = _host(scale)
    scale = torch.from_numpy(xproc.all_reduce_np(
        host, op="max", group=pg)).to(dev)
    sent += host.nbytes
    # 2. my codes of the whole payload
    q = _quantize_shared(padded.view(nb_total, block), scale).view(n, per)
    # 3. the reduce-scatter, one int8 shard a hop
    idx = members.index(env.get_rank())
    q_host = _host(q)
    acc = q[idx].to(torch.int32)
    for s in range(1, n):
        dest = (idx - s) % n
        xproc.send_bytes(q_host[dest].tobytes(), members[dest], _TAG)
        sent += per
        raw = xproc.recv_bytes(members[(idx + s) % n], _TAG)
        acc = acc + torch.from_numpy(
            np.frombuffer(raw, np.int8).copy()).to(dev, torch.int32)
    # 4. my shard of the mean
    nb = per // block
    my_scale = scale[idx * nb:(idx + 1) * nb]
    mean = (acc.view(nb, block).float() * my_scale[:, None]) / torch.tensor(
        float(n), device=dev)
    # 5. re-quantized, gathered (codes and scales in one buffer), decoded
    scale2 = _block_scales(mean)
    q2 = _quantize_shared(mean, scale2).view(per)
    mine = torch.cat([q2.view(torch.uint8), scale2.view(torch.uint8)])
    host = _host(mine)
    mat = torch.from_numpy(_gather_np(host, members)).to(dev)
    sent += host.nbytes
    full_q = mat[:, :per].contiguous().view(torch.int8).reshape(nb_total,
                                                                block)
    full_s = mat[:, per:].contiguous().view(torch.float32).reshape(nb_total)
    out = (full_q.float() * full_s[:, None]).view(-1)[:N]
    _note(stats, sent, time.perf_counter() - t0)
    return out


def _live_axes(axes):
    return tuple(a for a in _axis_tuple(axes) if mesh_mod.axis_size(a) > 1)


def quantized_pmean(x, axes, block=DEFAULT_BLOCK, stats=None):
    """The mean of `x` over this rank's groups along `axes` (each in
    turn; the mean of means is the global mean at equal group sizes),
    int8 on the wire. `x` keeps its shape and dtype."""
    axes = _live_axes(axes)
    if not axes:
        return x
    flat = x.detach().float().reshape(-1)
    for ax in axes:
        flat = _one_axis(flat, ax, block, stats)
    return flat.reshape(x.shape).to(x.dtype)


def _exact_mean(leaves, axes, stats):
    """The exact mean of each small leaf over the group along `axes`:
    the members' values gathered and summed in member order, in the
    leaf's dtype, then divided by the group size."""
    from .collective import _gather_np, axis_comm

    members, _ = axis_comm(axes)
    t0 = time.perf_counter()
    out = []
    sent = 0
    for v in leaves:
        host = _host(v)
        mat = _gather_np(host, members)
        sent += host.nbytes
        acc = mat[0].copy()
        for row in mat[1:]:
            acc = acc + row
        out.append(torch.from_numpy(np.ascontiguousarray(
            acc / np.asarray(len(members), acc.dtype))).to(v.device,
                                                           v.dtype))
    _note(stats, sent, time.perf_counter() - t0)
    return out


def _flatten(tree):
    """(leaves, rebuild) in jax's order: dict keys sorted, lists and
    tuples in order (the fused payload's layout follows it)."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_flatten(v) for v in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    sizes = [len(p[0]) for p in parts]

    def rebuild(leaves):
        out, off = [], 0
        for (_, f), n in zip(parts, sizes):
            out.append(f(leaves[off:off + n]))
            off += n
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)

    return [v for p in parts for v in p[0]], rebuild


def quantized_pmean_tree(tree, axes, block=DEFAULT_BLOCK,
                         min_size=MIN_QUANT_SIZE, stats=None):
    """`quantized_pmean` of a pytree of tensors: the leaves of at least
    `min_size` elements as one fused payload, the others exact. Leaf
    dtypes are kept."""
    axes = _live_axes(axes)
    leaves, rebuild = _flatten(tree)
    if not axes or not leaves:
        return tree
    big = [i for i, v in enumerate(leaves) if v.numel() >= min_size]
    out = list(leaves)
    if big:
        flat = torch.cat([leaves[i].detach().float().reshape(-1)
                          for i in big])
        for ax in axes:
            flat = _one_axis(flat, ax, block, stats)
        off = 0
        for i in big:
            v = leaves[i]
            out[i] = flat[off:off + v.numel()].view(v.shape).to(v.dtype)
            off += v.numel()
    small = [i for i in range(len(leaves)) if i not in big]
    if small:
        red = _exact_mean([leaves[i].detach() for i in small], axes, stats)
        for i, v in zip(small, red):
            out[i] = v
    return rebuild(out)
