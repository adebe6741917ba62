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
    return ap.parse_args(argv)


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
