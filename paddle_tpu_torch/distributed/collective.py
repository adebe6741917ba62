"""Collective communication API, the process half (counterpart of
paddle_tpu/distributed/collective.py: `init_parallel_env` and the
eager, multi-process branches of the collectives).

Rank == trainer process. An eager collective crosses processes through
host numpy over `xproc` (gloo on CPU tensors, the p2p socket transport
for send / recv), as the reference's eager branches do; the result is
written back into the caller's tensor in place, in that tensor's dtype
and on its device (a bf16 tensor crosses as float32, exactly). A world
of one process is the identity. Only the world group exists: a
collective given another group raises, as the reference's eager path
does.

The mesh-axis half — `new_group(axes=...)` and masked subgroups,
`spmd`, `alltoall` / `alltoall_single`, `reduce_scatter`, `p2p_shift` —
is distributed training's (ROADMAP A11(b)) and raises, naming A11.
"""
import os
import pickle

import numpy as np
import torch

from . import env as env_mod

__all__ = [
    "ReduceOp", "Group", "new_group", "get_group", "init_parallel_env",
    "is_initialized", "all_reduce", "all_gather", "all_gather_object",
    "broadcast", "reduce", "scatter", "scatter_object_list", "alltoall",
    "alltoall_single", "send", "recv", "isend", "irecv", "barrier",
    "reduce_scatter", "spmd", "p2p_shift", "P2POp", "batch_isend_irecv",
    "get_rank", "get_world_size", "wait",
]

get_rank = env_mod.get_rank
get_world_size = env_mod.get_world_size


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


class Group:
    """A communicator. The port's eager groups span the process world
    (the reference's default group, mesh axis "dp"); groups over other
    mesh axes or rank subsets are ROADMAP A11(b)."""

    _count = 0

    def __init__(self, axes=("dp",), ranks=None, gid=None):
        if isinstance(axes, str):
            axes = (axes,)
        self.axes = tuple(axes)
        self.ranks = ranks
        Group._count += 1
        self.id = gid if gid is not None else Group._count

    @property
    def nranks(self):
        if self.ranks is not None:
            return len(self.ranks)
        return env_mod.get_world_size()

    @property
    def rank(self):
        return env_mod.get_rank()

    @property
    def world_size(self):
        return self.nranks

    @property
    def name(self):
        return "_".join(self.axes)

    def get_group_rank(self, rank):
        """Global→group rank (-1 when not a member)."""
        if self.ranks is None:
            return rank if 0 <= rank < self.nranks else -1
        try:
            return list(self.ranks).index(rank)
        except ValueError:
            return -1

    def __repr__(self):
        return (f"Group(axes={self.axes}, nranks={self.nranks}"
                + (f", ranks={list(self.ranks)}" if self.ranks is not None
                   else "") + ")")


_groups = {}
_default_group = None
_initialized = False


def _a11(what):
    raise NotImplementedError(
        f"{what} is the mesh-axis half of the collectives (distributed "
        "training), which is not ported yet: ROADMAP A11")


def init_parallel_env(device=None):
    """Bring-up: the launcher's env contract → the TCPStore rendezvous
    and the gloo process group (distributed/env.py), then this rank's
    device — ``cuda:{local_rank % device_count}`` by default (several
    ranks may share one card), which raises when no GPU is present;
    ``device="cpu"`` runs the rank on the CPU. Returns the world group.
    (The reference's mesh arguments — dp, mp, pp, ... — are A11(b).)"""
    global _default_group, _initialized
    from ..core.place import resolve_device

    dev = resolve_device(device)
    env_mod.ensure_multihost_initialized()
    if dev.type == "cuda":
        local = int(os.environ.get("PADDLE_LOCAL_RANK", "0"))
        torch.cuda.set_device(local % torch.cuda.device_count())
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


def new_group(ranks=None, backend=None, timeout=None, axes=None):
    """A group over every process (``ranks`` None or all of them). Mesh
    axes and rank subsets raise (ROADMAP A11)."""
    world = env_mod.get_world_size()
    if axes is not None or (ranks is not None
                            and sorted(ranks) != list(range(world))):
        _a11("new_group over mesh axes or a subset of the ranks")
    g = Group(("dp",), ranks=ranks)
    _groups[g.id] = g
    return g


def get_group(gid=0):
    if gid == 0:
        return _ensure_default()
    return _groups.get(gid)


def _xproc():
    from . import xproc

    return xproc if xproc.is_multiprocess() else None


def _check_xproc_group(group):
    """Eager multi-process collectives operate over ALL trainer
    processes. Raise rather than silently reducing over the wrong rank
    set."""
    if group is not None and (
            group.axes != ("dp",) or (group.ranks is not None and sorted(
                group.ranks) != list(range(env_mod.get_world_size())))):
        raise RuntimeError(
            "eager cross-process collectives support only the default "
            "(world) group; use an SPMD region for subgroup collectives"
        )


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
    """The result, in place into `tensor` when it is one."""
    if isinstance(tensor, torch.Tensor):
        with torch.no_grad():
            tensor.copy_(_like(arr, tensor))
        return tensor
    return torch.from_numpy(np.array(arr))


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """In-place all-reduce across the processes (identity for one)."""
    xp = _xproc()
    if xp is None:
        return tensor
    _check_xproc_group(group)
    return _write(tensor, xp.all_reduce_np(_host(tensor), op=op))


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce-to-root: only rank `dst` receives the reduced value; every
    other rank keeps its ORIGINAL tensor."""
    xp = _xproc()
    if xp is None:
        return tensor
    _check_xproc_group(group)
    red = xp.all_reduce_np(_host(tensor), op=op)
    if env_mod.get_rank() == dst:
        return _write(tensor, red)
    return tensor


def all_gather(tensor_list, tensor, group=None, sync_op=True, axis=0):
    """Every process's tensor: appended to `tensor_list` when it is a
    list, else concatenated along `axis`."""
    xp = _xproc()
    t = torch.as_tensor(tensor)
    if xp is None:
        parts = [t]
    else:
        _check_xproc_group(group)
        mat = xp.all_gather_np(_host(t))
        parts = [_like(mat[i], t) for i in range(mat.shape[0])]
    if isinstance(tensor_list, list):
        tensor_list.extend(parts)
        return tensor_list
    return torch.cat(parts, dim=axis)


def all_gather_object(object_list, obj, group=None):
    """Gather picklable objects from every trainer process."""
    xp = _xproc()
    if xp is None:
        object_list.append(obj)
        return object_list
    _check_xproc_group(group)
    blobs = xp.all_gather_bytes(pickle.dumps(obj))
    object_list.extend(pickle.loads(b) for b in blobs)
    return object_list


def broadcast(tensor, src=0, group=None, sync_op=True):
    """Rank `src`'s tensor, in place on every rank."""
    xp = _xproc()
    if xp is None:
        return tensor
    _check_xproc_group(group)
    return _write(tensor, xp.broadcast_np(_host(tensor), src=src))


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Rank r receives part r of `src`'s `tensor_list` (src broadcasts
    the stacked parts; each process keeps its own slice)."""
    xp = _xproc()
    if xp is None:
        if tensor_list is not None:
            return _write(tensor, _host(tensor_list[0]))
        return tensor
    _check_xproc_group(group)
    me = env_mod.get_rank()
    if tensor_list is not None and me == src:
        stacked = np.stack([_host(p) for p in tensor_list])
    else:
        one = _host(tensor)
        stacked = np.stack([np.zeros_like(one)]
                           * env_mod.get_world_size())
    stacked = xp.broadcast_np(stacked, src=src)
    return _write(tensor, stacked[me])


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    """Scatter a list of picklable objects from src."""
    xp = _xproc()
    if xp is None:
        out_object_list.append(in_object_list[0])
        return out_object_list
    _check_xproc_group(group)
    me = env_mod.get_rank()
    payload = pickle.dumps(in_object_list if me == src else None)
    objs = pickle.loads(xp.all_gather_bytes(payload)[src])
    if objs is None:
        raise ValueError("scatter_object_list: src provided no objects")
    out_object_list.append(objs[me])
    return out_object_list


class _P2PTask:
    """Completed-on-return task handle (reference ProcessGroup::Task)."""

    def wait(self):
        return True

    def is_completed(self):
        return True


def send(tensor, dst=0, group=None, sync_op=True):
    """P2P send over the xproc socket transport, bit-exact (never the
    int8 wire)."""
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
    xp = _xproc()
    if xp is not None:
        _check_xproc_group(group)
        xp.barrier()


def wait(tensor, group=None, use_calc_stream=True):
    return tensor


def spmd(fn, in_specs, out_specs, group_axes=None, check_rep=False):
    _a11("spmd")


def alltoall(in_tensor_list, out_tensor_list=None, group=None,
             sync_op=True):
    _a11("alltoall")


def alltoall_single(in_tensor, out_tensor=None, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    _a11("alltoall_single")


def reduce_scatter(tensor, tensor_list=None, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    _a11("reduce_scatter")


def p2p_shift(tensor, group=None, offset=1):
    _a11("p2p_shift")
