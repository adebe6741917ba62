"""Collective communication API (counterpart of
paddle_tpu/distributed/collective.py).

Rank == trainer process, one per mesh position (distributed/mesh.py).
A collective crosses processes through host numpy over `xproc` (gloo on
CPU tensors, the p2p socket transport for send / recv), as the
reference's eager branches do; the result is written back into the
caller's tensor in place, in that tensor's dtype and on its device (a
bf16 tensor crosses as float32, exactly). A world of one process is the
identity.

Groups. The reference's `Group` names mesh axes and its collectives
lower onto those axes inside an SPMD region. Here a group over axes is,
for each process, the ranks that share its other mesh coordinates; the
gloo subgroup (`torch.distributed.new_group`) of every such set is
created once, on every rank, in the same order, the first time a group
over those axes is built or used. `new_group(ranks=...)` restricts a
group to a subset of the positions along its axes, with the reference's
masked semantics: members get the members-only result, non-members keep
their own tensor.

Which ranks a call spans follows the reference: outside an SPMD region
the default group (and `group=None`) is the whole world, the eager
multi-process path; inside `spmd(...)` it is the mesh axis ``dp``, and
every group its axes. `spmd(fn, in_specs, out_specs)` runs `fn` on this
rank's block of the global inputs and assembles the outputs by
`out_specs`, so every rank returns the reference's global value.

The collectives carry values, not gradients: autograd does not flow
through them (the train steps reduce gradients explicitly).
`alltoall`, `reduce_scatter` and `p2p_shift` move their data through a
gather or an all-reduce over the group (the numbers the reference's
collectives give; the bytes of the wider collective).
"""
import functools
import os
import pickle
import threading

import numpy as np
import torch

from . import env as env_mod
from . import mesh as mesh_mod

__all__ = [
    "ReduceOp", "Group", "new_group", "get_group", "init_parallel_env",
    "is_initialized", "all_reduce", "all_gather", "all_gather_object",
    "broadcast", "reduce", "scatter", "scatter_object_list", "alltoall",
    "alltoall_single", "send", "recv", "isend", "irecv", "barrier",
    "reduce_scatter", "split_group_axes", "spmd", "p2p_shift", "P2POp",
    "batch_isend_irecv", "get_rank", "get_world_size", "wait",
]

get_rank = env_mod.get_rank
get_world_size = env_mod.get_world_size


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


class _SpmdState(threading.local):
    def __init__(self):
        self.active = False
        self.axes = ()


_spmd = _SpmdState()


class Group:
    """A communicator: one or more mesh axes, optionally restricted to a
    subset of the positions along them (`ranks`)."""

    _count = 0

    def __init__(self, axes=("dp",), ranks=None, gid=None):
        if isinstance(axes, str):
            axes = (axes,)
        self.axes = tuple(axes)
        self.ranks = None if ranks is None else [int(r) for r in ranks]
        Group._count += 1
        self.id = gid if gid is not None else Group._count

    def _static_size(self):
        return int(np.prod([mesh_mod.axis_size(a) for a in self.axes]))

    @property
    def nranks(self):
        if self.ranks is not None:
            return len(self.ranks)
        return self._static_size()

    @property
    def rank(self):
        """This process's position along the group's axes (its index in
        `ranks` for a subset group, -1 when not a member; the global rank
        on the eager world group)."""
        if self.id == 0 and not _spmd.active:
            return env_mod.get_rank()      # the eager world group
        pos = mesh_mod.global_mesh().position(self.axes, env_mod.get_rank())
        if self.ranks is None:
            return pos
        return self.get_group_rank(pos)

    @property
    def world_size(self):
        return self._static_size()

    @property
    def name(self):
        return "_".join(self.axes)

    def get_group_rank(self, rank):
        """Position along the axes → group rank (-1 when not a member)."""
        if self.ranks is None:
            return rank if 0 <= rank < self._static_size() else -1
        try:
            return self.ranks.index(rank)
        except ValueError:
            return -1

    def __repr__(self):
        return (f"Group(axes={self.axes}, nranks={self.nranks}"
                + (f", ranks={self.ranks}" if self.ranks is not None
                   else "") + ")")


_groups = {}
_default_group = None
_initialized = False
# gloo subgroups by their tuple of global ranks
_pgs = {}


def init_parallel_env(dp=None, mp=1, pp=1, sharding=1, sp=1, ep=1,
                      device=None):
    """Bring-up: the launcher's env contract → the TCPStore rendezvous
    and the gloo process group (distributed/env.py), the global mesh
    over the process world (no mesh arguments: every process on the dp
    axis), then this rank's device — ``cuda:{local_rank %
    device_count}`` by default (several ranks may share one card), which
    raises when no GPU is present; ``device="cpu"`` runs the rank on the
    CPU. Returns the default group."""
    global _default_group, _initialized
    from ..core.place import resolve_device

    dev = resolve_device(device)
    env_mod.ensure_multihost_initialized()
    if dev.type == "cuda":
        local = int(os.environ.get("PADDLE_LOCAL_RANK", "0"))
        torch.cuda.set_device(local % torch.cuda.device_count())
    n = env_mod.get_world_size()
    if dp is None:
        dp = n // (mp * pp * sharding * sp * ep)
    mesh_mod.init_mesh(dp=dp, mp=mp, pp=pp, sharding=sharding, sp=sp,
                       ep=ep)
    _default_group = Group(("dp",), gid=0)
    _initialized = True
    return _default_group


def is_initialized():
    return _initialized


def _ensure_default():
    global _default_group
    if _default_group is None:
        _default_group = Group(("dp",), gid=0)
    return _default_group


def _multiprocess():
    from . import xproc

    return xproc.is_multiprocess()


def _member_sets(g):
    """Every member set of `g` across the world (one per group along its
    axes; for a subset group, the subset of each)."""
    sets = []
    for axis_ranks in mesh_mod.global_mesh().partition(g.axes):
        if g.ranks is not None:
            axis_ranks = [axis_ranks[i] for i in g.ranks]
        sets.append(tuple(axis_ranks))
    return sets


def _ensure_pgs(g):
    """Create the gloo subgroups of `g`'s member sets, on every rank, in
    one order (`torch.distributed.new_group` is collective over the
    world)."""
    if not _multiprocess():
        return
    import torch.distributed as dist

    world = dist.get_world_size()
    for members in _member_sets(g):
        if 1 < len(members) < world and members not in _pgs:
            _pgs[members] = dist.new_group(list(members))


def _pg(members):
    """The torch process group over `members` (None: the world)."""
    import torch.distributed as dist

    if len(members) == dist.get_world_size():
        return None
    return _pgs[tuple(members)]


def axis_comm(axes):
    """(this rank's group along mesh `axes` as global ranks by position,
    its torch process group: None for the world or a group of one)."""
    members = mesh_mod.global_mesh().group_ranks(tuple(axes),
                                                 env_mod.get_rank())
    if len(members) == 1 or not _multiprocess():
        return members, None
    _ensure_pgs(Group(axes, gid=-1))
    return members, _pg(members)


def new_group(ranks=None, backend=None, timeout=None, axes=None):
    """A group over mesh `axes` (default ``dp``), restricted to the
    positions `ranks` along them when given. Every rank must call it, in
    the same order, as with the reference."""
    g = Group(axes if axes is not None else ("dp",), ranks=ranks)
    if g.ranks is not None:
        size = g._static_size()
        bad = [r for r in g.ranks if not 0 <= r < size]
        if bad:
            raise ValueError(f"ranks {bad} out of range for axes {g.axes} "
                             f"of size {size}")
    _groups[g.id] = g
    _ensure_pgs(g)
    return g


def get_group(gid=0):
    if gid == 0:
        return _ensure_default()
    return _groups.get(gid)


def split_group_axes(group):
    return (group or _ensure_default()).axes


def _is_world(group):
    """The eager world-group path: outside SPMD, the default group."""
    return not _spmd.active and (group is None or group.id == 0)


def _group_of(group):
    if group is None:
        return Group(("dp",), gid=-1) if _spmd.active else _ensure_default()
    return group


def _layout(group, masked=True):
    """(members, my index among them or -1, my position along the axes,
    the axis group's ranks) for this process."""
    me = env_mod.get_rank()
    if _is_world(group):
        world = list(range(env_mod.get_world_size()))
        return world, me, me, world
    g = _group_of(group)
    axis_ranks = mesh_mod.global_mesh().group_ranks(g.axes, me)
    pos = axis_ranks.index(me)
    if not masked or g.ranks is None:
        return axis_ranks, pos, pos, axis_ranks
    members = [axis_ranks[i] for i in g.ranks]
    return members, (members.index(me) if me in members else -1), pos, \
        axis_ranks


def _prepare(group):
    if _multiprocess() and not _is_world(group):
        _ensure_pgs(_group_of(group))


def _host(t):
    """tensor → numpy on the host (bf16 through float32: exact)."""
    t = torch.as_tensor(t).detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _like(arr, ref):
    """numpy → a tensor of `ref`'s dtype on `ref`'s device."""
    ref = torch.as_tensor(ref)
    return torch.from_numpy(np.array(arr)).to(device=ref.device,
                                              dtype=ref.dtype)


def _write(tensor, arr):
    """The result, in place into `tensor` when it is one of its shape."""
    if isinstance(tensor, torch.Tensor) and \
            tuple(tensor.shape) == tuple(np.shape(arr)):
        with torch.no_grad():
            tensor.copy_(_like(arr, tensor))
        return tensor
    if isinstance(tensor, torch.Tensor):
        return _like(arr, tensor)
    return torch.from_numpy(np.array(arr))


def _gather_np(arr, members):
    """(len(members), ...) of every member's array, in member order."""
    from . import xproc

    if len(members) == 1:
        return np.asarray(arr)[None]
    mat = xproc.all_gather_np(arr, group=_pg(members))
    # a torch group orders its ranks ascending
    order = sorted(members)
    return mat[[order.index(r) for r in members]]


def _resolve_member_rank(g, rank, what):
    """src / dst as a position along the group's axes, validated as the
    reference does (a subset group's src / dst must be a member)."""
    if g.ranks is not None:
        if g.get_group_rank(rank) == -1:
            raise ValueError(
                f"{what}={rank} is not a member of {g!r}; src/dst use "
                "the same numbering as new_group(ranks=...) (reference "
                "get_group_rank semantics)")
        return rank
    size = g._static_size()
    if not 0 <= rank < size:
        raise ValueError(f"{what}={rank} out of range for {g!r}")
    return rank


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """In-place all-reduce over the group (identity for one process; a
    subset group's non-members keep their tensor)."""
    from . import xproc

    if not _multiprocess():
        return tensor
    _prepare(group)
    members, idx, _, _ = _layout(group)
    if idx < 0 or len(members) == 1:
        return tensor
    return _write(tensor, xproc.all_reduce_np(_host(tensor), op=op,
                                              group=_pg(members)))


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce-to-root: only `dst` receives the reduced value; every other
    rank keeps its ORIGINAL tensor. `dst` is a global rank on the world
    group, a position along the axes otherwise (as `new_group(ranks=)`
    numbers them)."""
    from . import xproc

    if not _multiprocess():
        return tensor
    _prepare(group)
    if not _is_world(group):
        dst = _resolve_member_rank(_group_of(group), dst, "dst")
    members, idx, pos, _ = _layout(group)
    if idx < 0 or len(members) == 1:
        return tensor
    red = xproc.all_reduce_np(_host(tensor), op=op, group=_pg(members))
    if pos == dst:
        return _write(tensor, red)
    return tensor


def all_gather(tensor_list, tensor, group=None, sync_op=True, axis=0):
    """Every rank's tensor along the group's axes: appended to
    `tensor_list` when it is a list, else concatenated along `axis`."""
    t = torch.as_tensor(tensor)
    if not _multiprocess():
        parts = [t]
    else:
        _prepare(group)
        members, _, _, _ = _layout(group, masked=False)
        mat = _gather_np(_host(t), members)
        parts = [_like(mat[i], t) for i in range(mat.shape[0])]
    if isinstance(tensor_list, list):
        tensor_list.extend(parts)
        return tensor_list
    return torch.cat(parts, dim=axis)


def all_gather_object(object_list, obj, group=None):
    """Gather picklable objects from every trainer process."""
    from . import xproc

    if not xproc.is_multiprocess():
        object_list.append(obj)
        return object_list
    _check_world(group)
    blobs = xproc.all_gather_bytes(pickle.dumps(obj))
    object_list.extend(pickle.loads(b) for b in blobs)
    return object_list


def broadcast(tensor, src=0, group=None, sync_op=True):
    """`src`'s tensor, in place on every member (src: a global rank on
    the world group, a position along the axes otherwise)."""
    from . import xproc

    if not _multiprocess():
        return tensor
    _prepare(group)
    members, idx, _, axis_ranks = _layout(group)
    if _is_world(group):
        src_global = int(src)
    else:
        src_global = axis_ranks[
            _resolve_member_rank(_group_of(group), src, "src")]
    if idx < 0 or len(members) == 1:
        return tensor
    return _write(tensor, xproc.broadcast_np(_host(tensor), src=src_global,
                                             group=_pg(members)))


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Rank i of the group receives chunk i of `src`'s tensor (the
    concatenation of `tensor_list` when it is a list). A subset group's
    non-members get zeros."""
    from . import xproc

    parts = tensor_list if isinstance(tensor_list, (list, tuple)) else None
    full = (torch.cat([torch.as_tensor(p) for p in parts])
            if parts is not None else torch.as_tensor(
                tensor_list if isinstance(tensor_list, torch.Tensor)
                else tensor))
    if not _multiprocess():
        if parts is not None:
            return _write(tensor, _host(parts[0]))
        return tensor
    _prepare(group)
    members, idx, pos, axis_ranks = _layout(group)
    if _is_world(group):
        if parts is None and env_mod.get_rank() != src:
            full = torch.cat([torch.as_tensor(tensor)]
                             * env_mod.get_world_size())
        src_global = int(src)
    else:
        src_global = axis_ranks[
            _resolve_member_rank(_group_of(group), src, "src")]
    whole = xproc.broadcast_np(_host(full), src=src_global,
                               group=_pg(axis_ranks))
    n = len(members)
    chunk = whole.shape[0] // n
    piece = whole[max(idx, 0) * chunk:(max(idx, 0) + 1) * chunk]
    if idx < 0:
        piece = np.zeros_like(piece)
    if isinstance(tensor_list, torch.Tensor):
        return _like(piece, tensor_list)
    return _write(tensor, piece)


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    """Scatter a list of picklable objects from src (world group)."""
    from . import xproc

    if not xproc.is_multiprocess():
        out_object_list.append(in_object_list[0])
        return out_object_list
    _check_world(group)
    me = env_mod.get_rank()
    payload = pickle.dumps(in_object_list if me == src else None)
    objs = pickle.loads(xproc.all_gather_bytes(payload)[src])
    if objs is None:
        raise ValueError("scatter_object_list: src provided no objects")
    out_object_list.append(objs[me])
    return out_object_list


def _check_world(group):
    if group is not None and not _is_world(group):
        raise RuntimeError("object collectives support only the default "
                           "(world) group")


def alltoall(in_tensor_list, out_tensor_list=None, group=None,
             sync_op=True):
    """All-to-all splitting dim 0 into equal chunks: member j's chunk i
    lands as chunk j of member i (a list of tensors is stacked first)."""
    t = (torch.stack([torch.as_tensor(x) for x in in_tensor_list])
         if isinstance(in_tensor_list, (list, tuple))
         else torch.as_tensor(in_tensor_list))
    if not _multiprocess():
        return in_tensor_list
    _prepare(group)
    members, idx, _, _ = _layout(group, masked=False)
    n = len(members)
    if n == 1:
        return in_tensor_list
    if t.shape[0] % n:
        raise ValueError(f"alltoall: dim 0 ({t.shape[0]}) is not divisible "
                         f"by the group size {n}")
    mat = _gather_np(_host(t), members)
    c = t.shape[0] // n
    out = _like(np.concatenate([mat[j][idx * c:(idx + 1) * c]
                                for j in range(n)]), t)
    if isinstance(out_tensor_list, list):
        out_tensor_list.extend(out.unbind(0) if isinstance(
            in_tensor_list, (list, tuple)) else [out])
    return out


def alltoall_single(in_tensor, out_tensor=None, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """Equal-split all-to-all. Unequal split sizes raise, as the
    reference's static equal splits do: pad to uniform splits."""
    for splits in (in_split_sizes, out_split_sizes):
        if splits is not None and len(set(splits)) > 1:
            raise NotImplementedError(
                "alltoall_single with unequal split sizes is not "
                "supported (static equal splits only, as the reference) "
                "— pad to uniform splits")
    out = alltoall(in_tensor, group=group)
    if isinstance(out_tensor, torch.Tensor) and out is not in_tensor:
        return _write(out_tensor, _host(out))
    return out


def reduce_scatter(tensor, tensor_list=None, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """The group's reduction of the input (the concatenation of
    `tensor_list` when it is a list, `tensor_list` itself when it is a
    tensor, else `tensor`), split along dim 0: this rank gets its
    position's chunk, written into `tensor` when the input came from
    `tensor_list` (paddle's semantics, at every group size: in one
    process or a group of one the chunk is the whole input)."""
    from . import xproc

    parts = tensor_list if isinstance(tensor_list, (list, tuple)) else None
    t = (torch.cat([torch.as_tensor(p) for p in parts]) if parts is not None
         else torch.as_tensor(tensor_list if isinstance(
             tensor_list, torch.Tensor) else tensor))
    if not _multiprocess():
        members, idx = [env_mod.get_rank()], 0
    else:
        _prepare(group)
        members, idx, _, _ = _layout(group, masked=False)
    n = len(members)
    if n == 1:
        # a group of one reduces nothing: its whole input is its chunk
        if parts is not None or isinstance(tensor_list, torch.Tensor):
            return _write(tensor, _host(t))
        return tensor
    if t.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim 0 ({t.shape[0]}) is not "
                         f"divisible by the group size {n}")
    red = xproc.all_reduce_np(_host(t), op=op, group=_pg(members))
    c = t.shape[0] // n
    piece = red[idx * c:(idx + 1) * c]
    if parts is not None or isinstance(tensor_list, torch.Tensor):
        return _write(tensor, piece)
    return _like(piece, t)


def p2p_shift(tensor, group=None, offset=1):
    """Ring shift along the group's axes: position i's tensor lands at
    position (i + offset) mod n."""
    if not _multiprocess():
        return tensor
    _prepare(group)
    members, idx, _, _ = _layout(group, masked=False)
    n = len(members)
    if n == 1:
        return tensor
    t = torch.as_tensor(tensor)
    mat = _gather_np(_host(t), members)
    return _like(mat[(idx - offset) % n], t)


class _P2PTask:
    """Completed-on-return task handle (reference ProcessGroup::Task)."""

    def wait(self):
        return True

    def is_completed(self):
        return True


def send(tensor, dst=0, group=None, sync_op=True):
    """P2P send over the xproc socket transport, bit-exact (never the
    int8 wire); `dst` is a global rank."""
    from . import xproc

    xproc.send_np(_host(tensor), int(dst), quantize=False)
    return _P2PTask()


def recv(tensor, src=0, group=None, sync_op=True):
    """P2P recv filling `tensor` in place."""
    from . import xproc

    _write(tensor, xproc.recv_np(int(src)))
    return _P2PTask()


def isend(tensor, dst=0, group=None):
    """Async send facade (completes eagerly)."""
    return send(tensor, dst, group, sync_op=False)


def irecv(tensor, src=0, group=None):
    return recv(tensor, src, group, sync_op=False)


class P2POp:
    """One op of a batched p2p round."""

    def __init__(self, op, tensor, peer, group=None):
        if op not in (isend, irecv, send, recv):
            raise ValueError("P2POp op must be isend/irecv")
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group


def batch_isend_irecv(p2p_op_list):
    """Execute a batch of sends/recvs. Sends go first (a socket send
    completes into the peer's inbox) so mutual exchanges can't deadlock
    regardless of list order."""
    ordered = sorted(p2p_op_list,
                     key=lambda o: 0 if o.op in (isend, send) else 1)
    return [op.op(op.tensor, op.peer, op.group) for op in ordered]


def barrier(group=None):
    from . import xproc

    if not xproc.is_multiprocess():
        return
    if _is_world(group):
        xproc.barrier()
        return
    import torch.distributed as dist

    _prepare(group)
    members, idx, _, _ = _layout(group)
    if idx >= 0 and len(members) > 1:
        dist.barrier(group=_pg(members))


def wait(tensor, group=None, use_calc_stream=True):
    return tensor


# ---------------------------------------------------------------- spmd

def _axes_of(entry):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _per_leaf(specs, n):
    """One spec per argument / output (a bare spec, or None, applies to
    every one)."""
    if specs is None or isinstance(specs, mesh_mod.PartitionSpec):
        return [specs] * n
    specs = list(specs)
    if len(specs) != n:
        raise ValueError(f"{len(specs)} specs for {n} values")
    return specs


def _block(x, spec):
    """This rank's block of the global `x` under `spec`."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    mesh = mesh_mod.global_mesh()
    me = env_mod.get_rank()
    for d, entry in enumerate(spec or ()):
        axes = _axes_of(entry)
        n = int(np.prod([mesh.shape[a] for a in axes])) if axes else 1
        if n == 1:
            continue
        if x.shape[d] % n:
            raise ValueError(f"dim {d} ({x.shape[d]}) is not divisible by "
                             f"{axes} ({n})")
        size = x.shape[d] // n
        x = x.narrow(d, mesh.position(axes, me) * size, size)
    return x.clone()


def _assemble(y, spec):
    """The global value of per-rank blocks `y` under `spec`."""
    mesh = mesh_mod.global_mesh()
    me = env_mod.get_rank()
    for d, entry in enumerate(spec or ()):
        axes = _axes_of(entry)
        if not axes or int(np.prod([mesh.shape[a] for a in axes])) == 1:
            continue
        members = mesh.group_ranks(axes, me)
        _ensure_pgs(Group(axes, gid=-1))
        mat = _gather_np(_host(y), members)
        y = torch.cat([_like(mat[i], y) for i in range(mat.shape[0])],
                      dim=d)
    return y


def spmd(fn, in_specs, out_specs, group_axes=None, check_rep=False):
    """Run `fn` as one SPMD program over the process mesh: each rank
    calls it on its block of every global input (sliced by `in_specs`
    and its mesh coordinate); inside, the collectives bind to mesh axes
    (`group=None` is the ``dp`` axis); each output is assembled from the
    ranks' blocks by `out_specs` (a dimension over no axis is taken as
    replicated), so every rank returns the global value."""
    axes = tuple(group_axes or mesh_mod.mesh_axes())

    @functools.wraps(fn)
    def wrapper(*args):
        specs = _per_leaf(in_specs, len(args))
        blocks = [[_block(a, s) for a in x] if isinstance(x, (list, tuple))
                  else _block(x, s) for x, s in zip(args, specs)]
        _spmd.active, _spmd.axes = True, axes
        try:
            out = fn(*blocks)
        finally:
            _spmd.active, _spmd.axes = False, ()
        if not _multiprocess():
            return out
        single = not isinstance(out, (list, tuple))
        outs = [out] if single else list(out)
        specs = _per_leaf(out_specs, len(outs))
        outs = [_assemble(torch.as_tensor(o), s)
                for o, s in zip(outs, specs)]
        return outs[0] if single else type(out)(outs)

    return wrapper
