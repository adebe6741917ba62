"""Fused gradient all-reduce and parameter broadcasts over the hybrid
groups (counterpart of
paddle_tpu/distributed/fleet/utils/hybrid_parallel_util.py).

The gradients are coalesced into one flat buffer per dtype, so a step
makes one host collective per dtype instead of one per parameter (on the
card: one device → host copy of the bucket, the gloo all-reduce, one copy
back). The groups are the HCG's mesh-axis groups (distributed/mesh.py):
a dp group that is a strict subset of the processes reduces over its
own gloo subgroup.
"""
import time

import numpy as np
import torch

__all__ = ["fused_allreduce_gradients", "broadcast_mp_parameters",
           "broadcast_dp_parameters", "coalesced_all_reduce"]


def _host(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def coalesced_all_reduce(tensors, axes=("dp",), op="sum", stats=None):
    """The all-reduce of every tensor in `tensors` over this rank's group
    along mesh `axes`, as one flat buffer per dtype: new tensors (same
    dtype, device and shape), in order. `stats` (a dict), when given,
    gains the bytes sent into the collective and its seconds."""
    from ... import xproc
    from ...collective import axis_comm

    members, pg = axis_comm(axes)
    if len(members) == 1 or not xproc.is_multiprocess():
        return list(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    out = [None] * len(tensors)
    for dtype, idx in by_dtype.items():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        host = _host(flat)
        t0 = time.perf_counter()
        red = xproc.all_reduce_np(host, op=op, group=pg)
        if stats is not None:
            stats["bytes"] = stats.get("bytes", 0) + host.nbytes
            stats["seconds"] = (stats.get("seconds", 0.0)
                                + time.perf_counter() - t0)
        red = torch.from_numpy(np.ascontiguousarray(red)).to(
            device=flat.device, dtype=dtype)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = red[off:off + n].view(tensors[i].shape)
            off += n
    return out


def fused_allreduce_gradients(parameter_list, hcg=None):
    """Sum every parameter's `.grad` over the data-parallel group (the
    HCG's, else the world's dp axis) in one flat buffer per dtype."""
    params = [p for p in parameter_list if getattr(p, "grad", None)
              is not None]
    if not params:
        return
    reduced = coalesced_all_reduce([p.grad for p in params], ("dp",))
    for p, g in zip(params, reduced):
        p.grad = g


def _broadcast_params(parameters, axis):
    """Each parameter from position 0 of this rank's `axis` group."""
    from ... import xproc
    from ...collective import axis_comm

    members, pg = axis_comm((axis,))
    if len(members) == 1 or not xproc.is_multiprocess():
        return
    with torch.no_grad():
        for p in parameters:
            arr = xproc.broadcast_np(_host(p), src=members[0], group=pg)
            p.copy_(torch.from_numpy(np.ascontiguousarray(arr)).to(
                device=p.device, dtype=p.dtype))


def broadcast_mp_parameters(model, hcg=None):
    """Sync the replicated parameters across the mp group from its first
    rank; an mp shard (`mp_shard`, set by the tensor-parallel
    layers) is each rank's own and stays."""
    _broadcast_params([p for p in model.parameters()
                       if not getattr(p, "mp_shard", False)], "mp")


def broadcast_dp_parameters(model, hcg=None):
    """Sync the parameters across the dp group at start-up."""
    _broadcast_params(list(model.parameters()), "dp")
