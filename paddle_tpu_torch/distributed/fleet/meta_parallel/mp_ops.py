"""Tensor-parallel communication with the Megatron gradient pairing
(counterpart of paddle_tpu/distributed/fleet/meta_parallel/mp_ops.py).

Each op is a `torch.autograd.Function` over this rank's group along the
``mp`` mesh axis (the HCG's model-parallel group):

  copy_to_mp(x)     enters an mp-parallel region: identity forward, the
                    gradient all-reduced backward (each rank's partial
                    cotangent of a replicated input summed). Place it on
                    the INPUT of a column-parallel matmul.
  allreduce_mp(x)   leaves one: all-reduce forward (the partial products
                    of a row-parallel matmul), identity backward. Place
                    it on the OUTPUT of a row-parallel matmul.
  gather_mp(x)      all-gather along the last dim (a column-parallel
                    output made whole); backward keeps this rank's slice.
  split_mp(x)       this rank's slice of the last dim (a whole input made
                    row-parallel); backward all-gathers.

A plain all-reduce inside autograd would all-reduce the gradient as well
and multiply it by the mp degree: the pairing above is the whole point of
the module. At mp 1, or in one process, every op is the identity. The
collectives run over gloo through host memory (`xproc`), as the port's
other collectives do; `stats` counts their bytes and seconds.

`axis` may name one mesh axis or a tuple of them: the group is then the
ranks that share every other coordinate, ordered row-major over the
axes given (the MoE gate statistics reduce over ("dp", "ep") this way,
in one collective). `all_to_all_mp_raw` is the equal-chunk all-to-all
over such a group (the MoE token exchange; kind "alltoall").
"""
import time

import numpy as np
import torch

__all__ = ["copy_to_mp", "allreduce_mp", "gather_mp", "split_mp",
           "mp_world", "all_reduce_mp_raw", "all_gather_mp_raw",
           "all_to_all_mp_raw", "stats", "reset_stats"]

# bytes sent into the mp collectives and their seconds, by kind
stats = {}


def reset_stats():
    stats.clear()


def _note(kind, nbytes, seconds):
    d = stats.setdefault(kind, {"calls": 0, "bytes": 0, "seconds": 0.0})
    d["calls"] += 1
    d["bytes"] += int(nbytes)
    d["seconds"] += seconds


def _axes(axis):
    return (axis,) if isinstance(axis, str) else tuple(axis)


def mp_world(axis="mp"):
    """(members by position, this rank's position, torch group) of this
    rank's group along `axis` (one mesh axis or a tuple of them);
    ([rank], 0, None) in one process."""
    from ... import env, xproc
    from ...collective import axis_comm

    if not xproc.is_multiprocess():
        return [env.get_rank()], 0, None
    members, pg = axis_comm(_axes(axis))
    return members, members.index(env.get_rank()), pg


def _host(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return np.ascontiguousarray(t.cpu().numpy())


def _back(arr, like):
    # np.ascontiguousarray makes a 0-d array 1-d: keep `like`'s shape
    return torch.from_numpy(np.ascontiguousarray(arr)).to(
        device=like.device, dtype=like.dtype).reshape(like.shape)


def all_reduce_mp_raw(x, op="sum", axis="mp", kind="allreduce"):
    """The all-reduce of `x` over the mp group, outside autograd."""
    from ... import xproc

    members, _, pg = mp_world(axis)
    if len(members) == 1:
        return x
    host = _host(x)
    t0 = time.perf_counter()
    red = xproc.all_reduce_np(host, op=op, group=pg)
    _note(kind, host.nbytes, time.perf_counter() - t0)
    return _back(red, x)


def all_gather_mp_raw(x, axis="mp", dim=-1, kind="allgather"):
    """Every member's `x` concatenated along `dim` in position order,
    outside autograd."""
    from ...collective import _gather_np

    members, _, pg = mp_world(axis)
    if len(members) == 1:
        return x
    host = _host(x)
    t0 = time.perf_counter()
    mat = _gather_np(host, members)
    _note(kind, host.nbytes, time.perf_counter() - t0)
    return torch.cat([_back(mat[i], x) for i in range(len(members))],
                     dim=dim)


def all_to_all_mp_raw(x, axis="ep", kind="alltoall"):
    """x [n, ...] over a group of n: chunk j goes to the member at
    position j, and this rank's chunk from the member at position i lands
    in slot i of the result (rank r's chunk j lands in rank j's slot r).
    One gloo all-to-all on host copies, outside autograd."""
    import torch.distributed as tdist

    members, _, pg = mp_world(axis)
    n = len(members)
    if n == 1:
        return x
    if x.shape[0] != n:
        raise ValueError(f"all-to-all over {axis}: leading dim "
                         f"{x.shape[0]} != group size {n}")
    # a torch group numbers its ranks ascending; chunks go by position
    order = sorted(members)
    to_group = [members.index(r) for r in order]
    t0 = time.perf_counter()
    h = x.detach().cpu()
    send = h[to_group].contiguous()
    recv = torch.empty_like(send)
    tdist.all_to_all_single(recv, send, group=pg)
    back = torch.empty_like(recv)
    back[to_group] = recv
    _note(kind, send.numel() * send.element_size(),
          time.perf_counter() - t0)
    return back.to(x.device)


def _slice_last(x, axis="mp"):
    members, pos, _ = mp_world(axis)
    n = len(members)
    if n == 1:
        return x
    if x.shape[-1] % n:
        raise ValueError(f"last dim {x.shape[-1]} not divisible by "
                         f"{axis}={n}")
    c = x.shape[-1] // n
    return x[..., pos * c:(pos + 1) * c].contiguous()


class _CopyToMp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_mp_raw(g, axis=ctx.axis), None


class _AllreduceMp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        out = all_reduce_mp_raw(x, axis=axis)
        return out.clone() if out is x else out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherMp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_gather_mp_raw(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _slice_last(g, ctx.axis), None


class _SplitMp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _slice_last(x, axis)

    @staticmethod
    def backward(ctx, g):
        return all_gather_mp_raw(g.contiguous(), ctx.axis), None


def _trivial(axis):
    return len(mp_world(axis)[0]) == 1


def copy_to_mp(x, axis="mp"):
    """Identity forward, all-reduce of the gradient over `axis` backward
    (the reference's `_c_identity`)."""
    return x if _trivial(axis) else _CopyToMp.apply(x, axis)


def allreduce_mp(x, axis="mp"):
    """All-reduce over `axis` forward, identity backward (the
    reference's `_mp_allreduce`)."""
    return x if _trivial(axis) else _AllreduceMp.apply(x, axis)


def gather_mp(x, axis="mp"):
    """The last dim all-gathered over `axis`; backward takes this rank's
    slice (the reference's `_c_concat`)."""
    return x if _trivial(axis) else _GatherMp.apply(x, axis)


def split_mp(x, axis="mp"):
    """This rank's slice of the last dim; backward all-gathers (the
    reference's `_c_split`)."""
    return x if _trivial(axis) else _SplitMp.apply(x, axis)
