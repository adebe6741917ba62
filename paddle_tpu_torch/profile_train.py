"""Where the training step's time goes on the card.

The port's counterpart of `bench_gpt` (bench.py:88): gpt_small (random
weights from a seed, f32 parameters) at batch 16 x seq 1024, bf16 O1
`amp.auto_cast`, `AdamW(1e-4)`, `jit.TrainStep`, ids from
`np.random.default_rng(0)`. Runs 3 warm-up steps, times `--steps` steps
(host clock around work that ends in a synchronize), then profiles 2
steps under `torch.profiler` and prints:

* ms/step, tokens/s and MFU = model_flops / step time / 989 TFLOP/s (the
  H100's bf16 dense peak);
* device time (the sum of the kernel rows' times on the one stream) and
  the device's idle share of the profiled wall time;
* the flash attention kernels' (K3, K4, K5) share of device time, by
  kernel symbol (CUDA-core and tensor-core route), and device
  time by kernel category;
* the kernels ordered by device time, with launch counts.

    python -m paddle_tpu_torch.profile_train [--steps N] [--trace PATH]

`--trace` also writes the Chrome trace. Needs a CUDA GPU.
"""
import argparse
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from . import amp
from .core.rng import seed
from .jit import TrainStep
from .observability.steptrace import model_flops
from .optimizer import AdamW
from .text.models.gpt import (GPTForCausalLM, GPTPretrainingCriterion,
                              gpt_small)

H100_PEAK_BF16 = 989e12          # NVIDIA data sheet, SXM, dense
BATCH, SEQ = 16, 1024
# kernel names of csrc/flash_attention.cu as the profiler shows them:
# each of K3-K5 has a CUDA-core and a tensor-core (`_tc_`) kernel
FLASH_KERNELS = {"K3": ("fa_fwd_kernel", "fa_fwd_tc_kernel"),
                 "K4": ("fa_bwd_dq_kernel", "fa_bwd_dq_tc_kernel"),
                 "K5": ("fa_bwd_dkv_kernel", "fa_bwd_dkv_tc_kernel")}
# kernel-name substrings → category (first match wins)
CATEGORIES = (
    ("flash attention K3-K5", sum(FLASH_KERNELS.values(), ())),
    ("matmul (cuBLAS)", ("nvjet", "gemm", "xmma", "cutlass")),
    ("layer norm", ("layer_norm", "GammaBeta")),
    ("reductions", ("reduce_kernel",)),
    ("copies and casts", ("copy", "Memcpy", "CatArray")),
    ("other elementwise", ("elementwise",)),
)


def bench_gpt_step(batch=BATCH, seq=SEQ, device=None):
    """(config, TrainStep, ids): the bench_gpt configuration on the port."""
    seed(0)
    cfg = gpt_small()
    model = GPTForCausalLM(cfg, device=device, seed=0)
    crit = GPTPretrainingCriterion()

    def loss_fn(m, ids):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            return crit(m(ids), ids)

    step = TrainStep(model, loss_fn,
                     AdamW(1e-4, parameters=model.parameters()))
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, seq)), device=model.device)
    return cfg, step, ids


def timed_steps(step, ids, n):
    """Losses of `n` steps and the wall seconds they took."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step(ids) for _ in range(n)]
    torch.cuda.synchronize()
    return [float(x) for x in losses], time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--trace", help="write the Chrome trace here")
    args = ap.parse_args(argv)
    cfg, step, ids = bench_gpt_step()
    timed_steps(step, ids, 3)                           # warm-up
    losses, wall = timed_steps(step, ids, args.steps)
    dt = wall / args.steps
    print(f"card: {torch.cuda.get_device_name(0)}")
    print(f"gpt_small b{BATCH}·s{SEQ} bf16 O1 AdamW: {dt * 1e3:.3f} "
          f"ms/step, {BATCH * SEQ / dt:.1f} tok/s, MFU "
          f"{model_flops(cfg, BATCH, SEQ) / dt / H100_PEAK_BF16:.4f} "
          f"(989 TFLOP/s bf16 peak), loss {losses[0]:.4f} → "
          f"{losses[-1]:.4f} over {args.steps} steps")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, pwall = timed_steps(step, ids, 2)
    # kernel rows only: the CPU-side op rows (aten::mm, autograd
    # Functions) carry their kernels' device time too
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    device_us = sum(e.self_device_time_total for e in rows)
    if not device_us:
        print("profiler recorded no device time")
        return 1
    print(f"profiled 2 steps: {pwall * 1e3:.3f} ms wall, device time "
          f"{device_us / 1e3:.3f} ms; idle share "
          f"{100 * (1 - device_us / 1e6 / pwall):.1f}%")
    for k, names in FLASH_KERNELS.items():
        for name in names:
            us = sum(e.self_device_time_total for e in rows if name in e.key)
            n = sum(e.count for e in rows if name in e.key)
            print(f"{k} {name}: {us / 1e3:.3f} ms = "
                  f"{100 * us / device_us:.1f}% of device time, {n} launches")
    by_cat = {}
    for e in rows:
        cat = next((c for c, keys in CATEGORIES
                    if any(k in e.key for k in keys)), "other")
        by_cat[cat] = by_cat.get(cat, 0) + e.self_device_time_total
    for cat, us in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"category {cat}: {us / 1e3:.3f} ms = "
              f"{100 * us / device_us:.1f}%")
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in rows[:25]:
        print(f"{e.self_device_time_total / 1e3:10.3f} ms "
              f"{100 * e.self_device_time_total / device_us:5.1f}% "
              f"{e.count:7d}x  {e.key[:90]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
