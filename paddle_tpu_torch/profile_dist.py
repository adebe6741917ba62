"""Data-parallel GPT training across launched processes: each rank runs
`DistributedTrainStep` on its rows of one global batch.

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node=2 \\
        --log_dir=LOG paddle_tpu_torch/profile_dist.py \\
        --model gpt_small --sharding 2 --zero os_g --steps 3 \\
        --out DIR [--ckpt CKPT_DIR] [--device cpu]

Every rank builds the model as `profile_train.bench_gpt_step` does
(`seed(0)`, random weights from seed 0, AdamW(1e-4); gpt_small under
bf16 O1 `auto_cast`, gpt_tiny in f32) and the global batch of
`--batch` x `--seq` ids from `np.random.default_rng(0)` — bench_gpt's
— and keeps its rows by its position along (dp, sharding). The world is
`--sharding` ranks on the sharding axis (ZeRO shards over it) times the
rest on dp. The flash kernels' launch counts (K3-K5,
on the card only) are set to 0 just before the steps and read just
after. With `--ckpt` the ranks then save one checkpoint of the step
(`Checkpointer.save(steps)`, each rank its own blocks).

Each rank writes DIR/dist_out_<rank>.json: the losses, each step's wall
seconds (synchronized), the gradient all-reduce's bytes and seconds per
step, the flash launches (all and tensor-core route), peak memory, and
the checkpoint files it wrote. `--device` defaults to cuda (each rank
takes `cuda:{local_rank % device_count}`: ranks may share one card);
`--device cpu` runs the plain versions.

Tensor and pipeline parallelism: `--mesh pp=2,mp=2` (any of dp, pp, mp;
their product the world size) trains `PipelinedGPTForCausalLM` instead
(weights from seed 0, each logical array drawn whole then cut, so every
mesh trains the same model; `N_MICRO` micro-batches, per-layer
recompute) through `HybridTrainStep`, under bf16 O1 for gpt_small:

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node=4 \
        --log_dir=LOG paddle_tpu_torch/profile_dist.py --model gpt_small \
        --mesh pp=2,mp=2 --batch 8 --seq 1024 --steps 3 --out DIR

and each rank's record also holds its mesh coordinate, the p2p handoffs'
and the mp all-reduces' calls, bytes and seconds per step, the tied
embedding's gradient all-reduce, and the schedule it ran (the tick
table's row of its stage); with `--ckpt` the rank also writes its
parameter shards as DIR/params_<rank>.npz, for a gather.
"""
import os
import sys

if __package__ in (None, ""):
    # run as a script: import the package from the checkout, not from
    # the package directory the interpreter put first on the path
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from paddle_tpu_torch import amp  # noqa: E402
from paddle_tpu_torch import distributed as dist  # noqa: E402
from paddle_tpu_torch.core.rng import seed  # noqa: E402
from paddle_tpu_torch.distributed import xproc  # noqa: E402
from paddle_tpu_torch.distributed.checkpoint import Checkpointer  # noqa: E402
from paddle_tpu_torch.ops.cuda_kernels import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.optimizer import AdamW  # noqa: E402
from paddle_tpu_torch.text.models.gpt import (GPTForCausalLM,  # noqa: E402
                                              GPTPretrainingCriterion,
                                              gpt_small, gpt_tiny)

MODELS = {"gpt_small": (gpt_small, True), "gpt_tiny": (gpt_tiny, False)}
# the mesh mode's pipeline: micro-batches a step, and the recompute policy
N_MICRO, REMAT = 4, "layer"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="gpt_small", choices=sorted(MODELS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sharding", type=int, default=1,
                    help="sharding axis size (dp: the rest of the world)")
    ap.add_argument("--zero", default=None,
                    choices=("os", "os_g", "p_g_os"))
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint root to save the last step into")
    ap.add_argument("--out", required=True)
    ap.add_argument("--mesh", default=None,
                    help="tensor / pipeline mesh, e.g. pp=2,mp=2: train "
                    "PipelinedGPTForCausalLM through HybridTrainStep")
    return ap.parse_args(argv)


def parse_mesh(text):
    """'pp=2,mp=2' -> {'pp': 2, 'mp': 2}."""
    out = {}
    for part in text.split(","):
        k, v = part.split("=")
        if k.strip() not in ("dp", "pp", "mp"):
            raise ValueError(f"--mesh axis {k!r}: expected dp, pp or mp")
        out[k.strip()] = int(v)
    return out


def build_pipelined(model_name, device):
    """(config, HybridTrainStep) over the current mesh: the pipelined GPT
    from seed 0 (the same logical weights on every mesh), N_MICRO
    micro-batches, REMAT recompute, AdamW(1e-4), bf16 O1 for gpt_small."""
    from paddle_tpu_torch.jit import HybridTrainStep
    from paddle_tpu_torch.text.models.gpt_pipeline import (
        PipelinedGPTForCausalLM)

    make, o1 = MODELS[model_name]
    seed(0)
    cfg = make()
    model = PipelinedGPTForCausalLM(
        cfg, n_micro=N_MICRO, remat=REMAT, device=device, seed=0)

    def loss_fn(m, ids):
        if not o1:
            return m.loss(ids)
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            return m.loss(ids)

    opt = AdamW(1e-4, parameters=model.parameters())
    return cfg, HybridTrainStep(model, loss_fn, opt)


def _delta(after, before):
    out = {}
    for k, d in after.items():
        b = before.get(k, {})
        out[k] = {f: d[f] - b.get(f, 0) for f in d}
    return out


def main_mesh(args):
    import copy

    from paddle_tpu_torch.distributed.fleet.meta_parallel import mp_ops
    from paddle_tpu_torch.distributed.mesh import coord

    p1 = sys.modules["paddle_tpu_torch.distributed.fleet.meta_parallel."
                     "pipeline_1f1b"]
    mesh = parse_mesh(args.mesh)
    dist.init_parallel_env(device=args.device, **mesh)
    rank = dist.get_rank()
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    cfg, step = build_pipelined(args.model, device)
    build_s = time.perf_counter() - t0
    ids = global_batch(cfg, args.batch, args.seq)
    fa.reset_launches()
    p1.stats.clear()
    mp_ops.reset_stats()
    losses, step_s, comm = [], [], []
    for _ in range(args.steps):
        before = (copy.deepcopy(p1.stats), copy.deepcopy(mp_ops.stats),
                  dict(step.model.tied_stats))
        _sync(device)
        t0 = time.perf_counter()
        losses.append(float(step(ids)))
        _sync(device)
        step_s.append(time.perf_counter() - t0)
        comm.append({"dp": dict(step.comm_stats),
                     "p2p": _delta(p1.stats, before[0]),
                     "mp": _delta(mp_ops.stats, before[1]),
                     "tied_wte": {k: v - before[2].get(k, 0) for k, v in
                                  step.model.tied_stats.items()}})
    out = dict(rank=rank, model=args.model, device=str(device),
               device_name=(torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
               mesh=dist.mesh.global_mesh().shape, coord=coord(),
               n_micro=N_MICRO, remat=REMAT, batch=args.batch,
               seq=args.seq, build_s=build_s, losses=losses,
               step_seconds=step_s, comm=comm,
               schedule=[list(map(str, r)) for r in p1.last_schedule],
               launches=dict(fa.launches), tc_launches=dict(fa.tc_launches),
               peak_mb=(torch.cuda.max_memory_allocated(device) / 2**20
                        if device.type == "cuda" else None))
    os.makedirs(args.out, exist_ok=True)
    if args.ckpt:
        t0 = time.perf_counter()
        ck = Checkpointer(args.ckpt, model=step.model, train_step=step)
        ck.save(args.steps)
        out["ckpt_seconds"] = time.perf_counter() - t0
        d = ck._dir(args.steps)
        out["ckpt_files"] = sorted(f for f in os.listdir(
            os.path.join(d, "shards")) if f"#r{rank}s" in f)
        np.savez(os.path.join(args.out, f"params_{rank}.npz"),
                 **{n: p.detach().float().cpu().numpy()
                    for n, p in step.model.named_parameters()})
    with open(os.path.join(args.out, f"dist_out_{rank}.json"), "w") as f:
        json.dump(out, f)
    xproc.barrier()       # no rank exits before all finished


def build(model_name, device, zero_level=None):
    """(config, DistributedTrainStep): bench_gpt's model and optimizer."""
    make, o1 = MODELS[model_name]
    seed(0)
    cfg = make()
    model = GPTForCausalLM(cfg, device=device, seed=0)
    crit = GPTPretrainingCriterion()

    def loss_fn(m, ids):
        if not o1:
            return crit(m(ids), ids)
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            return crit(m(ids), ids)

    opt = AdamW(1e-4, parameters=model.parameters())
    return cfg, dist.DistributedTrainStep(model, loss_fn, opt,
                                          zero_level=zero_level)


def global_batch(cfg, batch, seq):
    return torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, seq)))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    args = parse_args(argv)
    if args.mesh:
        return main_mesh(args)
    dist.init_parallel_env(sharding=args.sharding, device=args.device)
    rank = dist.get_rank()
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.reset_peak_memory_stats(device)
    cfg, step = build(args.model, device, args.zero)
    ids = global_batch(cfg, args.batch, args.seq)
    fa.reset_launches()
    losses, step_s, comm = [], [], []
    for _ in range(args.steps):
        _sync(device)
        t0 = time.perf_counter()
        losses.append(float(step(ids)))
        _sync(device)
        step_s.append(time.perf_counter() - t0)
        comm.append(dict(step.comm_stats))
    out = dict(rank=rank, model=args.model, device=str(device),
               device_name=(torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
               mesh=dist.mesh.global_mesh().shape, zero=args.zero,
               batch=args.batch, seq=args.seq, losses=losses,
               step_seconds=step_s, comm=comm,
               launches=dict(fa.launches), tc_launches=dict(fa.tc_launches),
               peak_mb=(torch.cuda.max_memory_allocated(device) / 2**20
                        if device.type == "cuda" else None))
    if args.ckpt:
        t0 = time.perf_counter()
        ck = Checkpointer(args.ckpt, model=step.model, train_step=step)
        ck.save(args.steps)
        out["ckpt_seconds"] = time.perf_counter() - t0
        d = ck._dir(args.steps)
        out["ckpt_files"] = sorted(f for f in os.listdir(
            os.path.join(d, "shards")) if f"#r{rank}s" in f)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"dist_out_{rank}.json"), "w") as f:
        json.dump(out, f)
    xproc.barrier()       # neither rank exits before both finished


if __name__ == "__main__":
    main()
