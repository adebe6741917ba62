"""Worker of the port's launched distributed tests
(tests/test_torch_distributed.py, tests/test_torch_parallel_step.py,
tests/test_torch_fault_tolerance.py), run under
`python -m paddle_tpu_torch.distributed.launch`:

    torch_dist_worker.py collectives OUT   # 4 ranks, mesh dp 2 x mp 2
    torch_dist_worker.py train OUT         # 2 ranks
    torch_dist_worker.py elastic OUT       # 2 ranks, --max_restart

The collective cases are defined here once, over a framework's
`distributed` module, so the test runs the same table through the JAX
package's `spmd` on a 4-device mesh. Results go to OUT as npz / JSON.
"""
import json
import os
import signal
import sys

import numpy as np

# (name, group: (axes, ranks), op(D, g, x), out-spec axes of dim 0,
#  global input shape). Every case's input spec is dim 0 over
# ("dp", "mp"): 2 rows a rank.
IN_AXES = ("dp", "mp")
COLLECTIVE_CASES = [
    ("all_reduce_sum_dp", (("dp",), None),
     lambda D, g, x: D.all_reduce(x, group=g), IN_AXES, (8, 4)),
    ("all_reduce_max_mp", (("mp",), None),
     lambda D, g, x: D.all_reduce(x, op=D.ReduceOp.MAX, group=g), IN_AXES,
     (8, 4)),
    ("all_reduce_avg_dp", (("dp",), None),
     lambda D, g, x: D.all_reduce(x, op=D.ReduceOp.AVG, group=g), IN_AXES,
     (8, 4)),
    ("all_reduce_sum_dp_mp", (("dp", "mp"), None),
     lambda D, g, x: D.all_reduce(x, group=g), IN_AXES, (8, 4)),
    ("all_gather_dp", (("dp",), None),
     lambda D, g, x: D.all_gather(None, x, group=g), IN_AXES, (8, 4)),
    ("all_gather_mp_replicated_out", (("mp",), None),
     lambda D, g, x: D.all_gather(None, x, group=g), ("dp",), (8, 4)),
    ("reduce_scatter_mp", (("mp",), None),
     lambda D, g, x: D.reduce_scatter(x, group=g), IN_AXES, (8, 4)),
    ("reduce_scatter_dp", (("dp",), None),
     lambda D, g, x: D.reduce_scatter(x, group=g), IN_AXES, (8, 4)),
    ("p2p_shift_dp", (("dp",), None),
     lambda D, g, x: D.p2p_shift(x, group=g), IN_AXES, (8, 4)),
    ("p2p_shift_dp_mp_back", (("dp", "mp"), None),
     lambda D, g, x: D.p2p_shift(x, group=g, offset=-1), IN_AXES, (8, 4)),
    ("alltoall_mp", (("mp",), None),
     lambda D, g, x: D.alltoall(x, group=g), IN_AXES, (8, 4)),
    ("alltoall_dp", (("dp",), None),
     lambda D, g, x: D.alltoall(x, group=g), IN_AXES, (8, 4)),
    ("broadcast_mp_src1", (("mp",), None),
     lambda D, g, x: D.broadcast(x, src=1, group=g), IN_AXES, (8, 4)),
    ("broadcast_dp_src0", (("dp",), None),
     lambda D, g, x: D.broadcast(x, src=0, group=g), IN_AXES, (8, 4)),
    ("reduce_dp_dst1", (("dp",), None),
     lambda D, g, x: D.reduce(x, dst=1, group=g), IN_AXES, (8, 4)),
    ("scatter_dp_src0", (("dp",), None),
     lambda D, g, x: D.scatter(x, src=0, group=g), IN_AXES, (8, 4)),
    ("masked_all_reduce", (("dp", "mp"), [0, 2, 3]),
     lambda D, g, x: D.all_reduce(x, group=g), IN_AXES, (8, 4)),
    ("masked_all_reduce_dp", (("dp",), [1]),
     lambda D, g, x: D.all_reduce(x, op=D.ReduceOp.MAX, group=g), IN_AXES,
     (8, 4)),
    ("masked_broadcast_src2", (("dp", "mp"), [0, 2, 3]),
     lambda D, g, x: D.broadcast(x, src=2, group=g), IN_AXES, (8, 4)),
    ("masked_reduce_dst3", (("dp", "mp"), [1, 3]),
     lambda D, g, x: D.reduce(x, dst=3, group=g), IN_AXES, (8, 4)),
]


def case_input(i, shape):
    """Small integers as float32: every reduction order is exact."""
    return np.random.default_rng(100 + i).integers(
        -8, 8, shape).astype(np.float32)


def _root():
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def collectives(out):
    import torch

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed.mesh import PartitionSpec as P

    D.init_parallel_env(dp=2, mp=2, device="cpu")
    rank = D.get_rank()
    res = {}
    for i, (name, (axes, ranks), op, out_axes, shape) in enumerate(
            COLLECTIVE_CASES):
        g = D.new_group(ranks=ranks, axes=axes)
        f = D.spmd(lambda x, _op=op, _g=g: _op(D, _g, x),
                   in_specs=P(IN_AXES), out_specs=P(out_axes))
        res[name] = f(torch.from_numpy(case_input(i, shape))).numpy()
    # eager world-group path: each rank's own tensor
    t = torch.full((3,), float(rank + 1))
    res["eager_world_all_reduce"] = D.all_reduce(t).numpy()
    res["eager_world_all_gather"] = D.all_gather(
        None, torch.tensor([float(rank)])).numpy()
    g = D.new_group(axes=("mp",))
    res["group_rank_nranks"] = np.array([g.rank, g.nranks])
    # reduce_scatter's list form (paddle's semantics): the mp group's sum
    # of each rank's concatenated list, this rank's chunk into `tensor`
    out_t = torch.zeros(2)
    ret = D.reduce_scatter(out_t, reduce_scatter_list(rank), group=g)
    res["reduce_scatter_list_mp"] = np.stack([out_t.numpy(), ret.numpy()])
    np.savez(os.path.join(out, f"coll_r{rank}.npz"), **res)


def reduce_scatter_list(rank):
    """The list each rank hands reduce_scatter: two 2-element parts."""
    import torch

    return [torch.full((2,), float(rank + 1)), torch.arange(2.0) + rank]


# ---- training -------------------------------------------------------

TRAIN_STEPS = 3


def _model(weights, device="cpu"):
    from paddle_tpu_torch.convert import load_jax_state_dict
    from paddle_tpu_torch.text.models.gpt import GPTForCausalLM, gpt_tiny

    m = GPTForCausalLM(gpt_tiny(), device=device)
    load_jax_state_dict(m, weights)
    return m


def _loss_fn(m, ids):
    from paddle_tpu_torch.text.models.gpt import GPTPretrainingCriterion

    return GPTPretrainingCriterion()(m(ids), ids)


def _optimizer(kind, m):
    from paddle_tpu_torch.optimizer import AdamW, Momentum

    if kind in ("lars", "dgc"):
        return Momentum(1e-2, parameters=m.named_parameters())
    return AdamW(1e-3, parameters=m.named_parameters())


TRAIN_CONFIGS = [
    # (name, mesh, zero level, fleet strategy)
    ("dp2", dict(dp=2), None, None),
    ("zero_os_g", dict(dp=1, sharding=2), "os_g", None),
    ("zero_p_g_os", dict(dp=1, sharding=2), "p_g_os", None),
    ("zero_os", dict(dp=1, sharding=2), "os", None),
    ("fleet_lars", dict(dp=2), None, "lars"),
    ("fleet_dgc", dict(dp=2), None, "dgc"),
]


def train(out):
    import torch

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.distributed.checkpoint import Checkpointer

    D.init_parallel_env(device="cpu")
    torch.set_num_threads(1)
    rank = D.get_rank()
    w = dict(np.load(os.path.join(out, "weights.npz")))
    ids = torch.from_numpy(np.load(os.path.join(out, "ids.npy")))
    res = {}
    for name, mesh, zero, strat in TRAIN_CONFIGS:
        m = _model(w)
        opt = _optimizer(strat, m)
        if strat is None:
            mesh_mod.init_mesh(**mesh)
        else:
            st = fleet.DistributedStrategy()
            st.hybrid_configs["dp_degree"] = mesh["dp"]
            setattr(st, strat, True)
            fleet.init(is_collective=True, strategy=st)
            hcg = fleet.get_hybrid_communicate_group()
            res[f"{name}/hcg"] = [hcg.get_data_parallel_world_size(),
                                  hcg.get_data_parallel_rank()]
            opt = fleet.distributed_optimizer(opt)
            res[f"{name}/optimizer"] = type(opt).__name__
        step = D.DistributedTrainStep(m, _loss_fn, opt, zero_level=zero)
        res[f"{name}/losses"] = [float(step(ids))
                                 for _ in range(TRAIN_STEPS)]
        full = step.full_parameters()
        if zero == "os_g":
            # each rank writes its blocks of the moments into one
            # checkpoint; a world-1 process reassembles them
            ck = Checkpointer(os.path.join(out, "ckpt_zero"), model=m,
                              train_step=step, async_save=True)
            ck.save(TRAIN_STEPS)
            ck.wait()
            res[f"{name}/moment_shapes"] = sorted(
                {str(tuple(v.shape)) for st_ in opt._states.values()
                 for v in st_.values()})
        if zero == "p_g_os":
            res[f"{name}/block_shapes"] = {
                n: list(p.shape) for n, p in m.named_parameters()}
            ck = Checkpointer(os.path.join(out, "ckpt_p_g_os"), model=m,
                              train_step=step)
            ck.save(TRAIN_STEPS)
        if rank == 0:
            np.savez(os.path.join(out, f"params_{name}.npz"),
                     **{n: t.detach().numpy() for n, t in full.items()})
        mesh_mod.reset_mesh()
    # the reverse layout: a world-1 checkpoint (written by the test)
    # restored into a ZeRO os_g step over 2 ranks
    mesh_mod.init_mesh(dp=1, sharding=2)
    m = _model(w)
    opt = _optimizer(None, m)
    step = D.DistributedTrainStep(m, _loss_fn, opt, zero_level="os_g")
    ck = Checkpointer(os.path.join(out, "ckpt_world1"), model=m,
                      train_step=step)
    res["reverse/loaded"] = ck.load_latest()
    res["reverse/moment_shape"] = list(
        opt._states[id(m.gpt.wte.weight)]["moment1"].shape)
    res["reverse/next_loss"] = float(step(ids))
    mesh_mod.reset_mesh()
    res.update(_eager_helpers(rank))
    with open(os.path.join(out, f"train_r{rank}.json"), "w") as f:
        json.dump(res, f)


def eager_data(rank):
    """Rank-dependent inputs of the eager helpers' small linear model."""
    rng = np.random.default_rng(7 + rank)
    return (rng.standard_normal((4, 3)).astype(np.float32),
            rng.standard_normal((3, 2)).astype(np.float32))


def _eager_helpers(rank):
    """The eager data-parallel helpers over the world's dp axis:
    broadcast_dp_parameters from rank 0, fused_allreduce_gradients (a
    sum), and LocalSGD averaging every 2 SGD steps."""
    import torch

    from paddle_tpu_torch.distributed.fleet import meta_optimizers as mo
    from paddle_tpu_torch.distributed.fleet.utils import (
        broadcast_dp_parameters, fused_allreduce_gradients)
    from paddle_tpu_torch.optimizer import SGD

    x, w0 = eager_data(rank)
    m = torch.nn.Linear(3, 2, bias=False)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(w0.T))
    broadcast_dp_parameters(m)
    out = {"eager/broadcast": m.weight.tolist()}
    loss = (m(torch.from_numpy(x)) ** 2).sum()
    loss.backward()
    fused_allreduce_gradients(list(m.parameters()))
    out["eager/grad_sum"] = m.weight.grad.tolist()
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(w0.T))
    opt = SGD(0.1, parameters=m.parameters())
    sync = mo.LocalSGD(m, k_steps=2)
    synced = []
    for _ in range(2):
        opt.clear_grad()
        (m(torch.from_numpy(x)) ** 2).sum().backward()
        opt.step()
        synced.append(sync.step())
    out["eager/localsgd"] = m.weight.tolist()
    out["eager/localsgd_synced"] = synced
    return out


# ---- fault tolerance -------------------------------------------------

ELASTIC_STEPS = 6
KILL_AT = 4


def elastic(out):
    """dp 2 DistributedTrainStep under run_with_fault_tolerance with a
    checkpoint every step; on the first pod rank 1 SIGKILLs itself after
    step KILL_AT - 1, so the launcher re-forms the pod, which resumes
    from the latest complete checkpoint."""
    import torch

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed.checkpoint import Checkpointer
    from paddle_tpu_torch.distributed.fleet.elastic import (
        run_with_fault_tolerance)

    D.init_parallel_env(device="cpu")
    torch.set_num_threads(1)
    rank = D.get_rank()
    w = dict(np.load(os.path.join(out, "weights.npz")))
    ids = torch.from_numpy(np.load(os.path.join(out, "ids.npy")))
    m = _model(w)
    opt = _optimizer(None, m)
    step = D.DistributedTrainStep(m, _loss_fn, opt)
    ck = Checkpointer(os.path.join(out, "ckpt"), model=m, train_step=step,
                      keep=2)
    marker = os.path.join(out, "kill_marker")
    losses, starts = {}, []

    def train_fn(start):
        starts.append(start)
        for s in range(start, ELASTIC_STEPS):
            losses[s] = float(step(ids))
            ck.save(s + 1)
            D.barrier()
            if rank == 1 and s == KILL_AT - 1 and os.path.exists(marker):
                os.unlink(marker)   # the re-formed pod runs clean
                os.kill(os.getpid(), signal.SIGKILL)
        return ELASTIC_STEPS

    run_with_fault_tolerance(train_fn, ck)
    with open(os.path.join(out, f"elastic_r{rank}.json"), "w") as f:
        json.dump({"starts": starts, "losses": losses,
                   "attempt": os.environ.get("PADDLE_POD_ATTEMPT")}, f)


if __name__ == "__main__":
    sys.path.insert(0, _root())
    {"collectives": collectives, "train": train,
     "elastic": elastic}[sys.argv[1]](sys.argv[2])
