"""Where the training step's time goes on the card.

Two arms of bench.py on the port, random weights from a seed, ids from
`np.random.default_rng(0)`:

* `gpt_small` (`bench_gpt`, bench.py:88): f32 parameters at batch 16 x
  seq 1024, bf16 O1 `amp.auto_cast`, `AdamW(1e-4)`, `jit.TrainStep`;
  `--remat` is bench_gpt's `BENCH_GPT_REMAT` (bench.py:115-121: off,
  full, or a policy name such as `dots_saveable`);
* `gpt_1p3b` (`bench_gpt1p3b`, bench.py:378): `gpt_1p3b(recompute=True)`
  at batch 1 x seq 2048, `amp.decorate(level="O2")` (bf16 parameters),
  `AdamW(1e-4)`, `auto_cast(level="O2")` around
  `fused_head_loss(ids, block_size=2048)`, `TrainStep`.

Runs the warm-up steps (3; 2 for gpt_1p3b), times `--steps` steps (host
clock around work that ends in a synchronize), then profiles 2 steps
under `torch.profiler` and prints:

* ms/step, tokens/s, MFU = model_flops / step time / 989 TFLOP/s (the
  H100's bf16 dense peak) and peak memory;
* device time (the sum of the kernel rows' times on the one stream) and
  the device's idle share of the profiled wall time;
* the flash attention kernels' (K3, K4, K5) share of device time, by
  kernel symbol (CUDA-core and tensor-core route), the optimizer
  update's device time (the kernels under `Optimizer.step`'s
  "optimizer.step" range), and device time by kernel category;
* the kernels ordered by device time, with launch counts.

    python -m paddle_tpu_torch.profile_train [--model gpt_small|gpt_1p3b]
        [--remat POLICY] [--steps N] [--trace PATH] [--telemetry-ab]

`--trace` also writes the Chrome trace. `--telemetry-ab` also times
runs of the same steps with telemetry in its default mode (`TrainStep`
synchronizes after each step) and off, interleaved. Needs a CUDA GPU.
"""
import argparse
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from . import amp, observability
from .core.rng import seed
from .jit import TrainStep
from .observability.steptrace import DEFAULT_PEAK_FLOPS as H100_PEAK_BF16
from .observability.steptrace import model_flops
from .optimizer import AdamW
from .text.models.gpt import (GPTConfig, GPTForCausalLM,
                              GPTPretrainingCriterion, gpt_1p3b, gpt_small)

BATCH, SEQ = 16, 1024
BATCH_1P3B, SEQ_1P3B = 1, 2048
# the range Optimizer.step opens; its kernels are the update's device time
OPT_RANGE = "optimizer.step"
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


def parse_remat(text):
    """bench_gpt's BENCH_GPT_REMAT: off / full / a policy name."""
    text = (text or "").strip().lower()
    if text in ("", "0", "off", "false"):
        return False
    if text in ("1", "full", "true"):
        return True
    return text


def _ids(cfg, batch, seq, device):
    return torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, seq)), device=device)


def bench_gpt_step(batch=BATCH, seq=SEQ, device=None, remat=False):
    """(config, TrainStep, ids): the bench_gpt configuration on the port."""
    seed(0)
    cfg = gpt_small()
    model = GPTForCausalLM(cfg, device=device, seed=0)
    crit = GPTPretrainingCriterion()

    def loss_fn(m, ids):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            return crit(m(ids), ids)

    step = TrainStep(model, loss_fn,
                     AdamW(1e-4, parameters=model.parameters()), remat=remat)
    return cfg, step, _ids(cfg, batch, seq, model.device)


def o2_loss(m, ids):
    """bench_gpt1p3b's loss: the fused vocab head under O2."""
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        return m.fused_head_loss(ids, block_size=2048)


def gpt1p3b_model(layers=None, device=None, model_seed=0):
    """gpt_1p3b(recompute=True) (`layers` cuts its depth), random weights
    from `model_seed`, decorated O2: bf16 parameters."""
    cfg = gpt_1p3b(recompute=True)
    if layers is not None:
        cfg = GPTConfig(**dict(vars(cfg), num_layers=layers))
    model = GPTForCausalLM(cfg, device=device, seed=model_seed)
    return cfg, amp.decorate(model, level="O2", dtype="bfloat16")


def bench_gpt1p3b_step(device=None, remat=False):
    """(config, TrainStep, ids): bench_gpt1p3b's configuration on the
    port."""
    seed(0)
    cfg, model = gpt1p3b_model(device=device)
    step = TrainStep(model, o2_loss,
                     AdamW(1e-4, parameters=model.parameters()), remat=remat)
    return cfg, step, _ids(cfg, BATCH_1P3B, SEQ_1P3B, model.device)


def kernel_rows(prof):
    """The profile's kernel rows: the CPU-side op rows (aten::mm,
    autograd Functions) carry their kernels' device time too, and the
    optimizer range's device-side row spans its kernels."""
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key != OPT_RANGE
            and e.self_device_time_total > 0]


def device_us(prof):
    """Device µs of all the profile's kernels."""
    return sum(e.self_device_time_total for e in kernel_rows(prof))


def optimizer_device_us(prof):
    """Device µs of the kernels launched under the "optimizer.step"
    range (its CPU-side event carries its child ops' kernel times)."""
    return sum(e.device_time_total for e in prof.key_averages()
               if e.key == OPT_RANGE and e.device_type == DeviceType.CPU)


def timed_steps(step, ids, n):
    """Losses of `n` steps and the wall seconds they took."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step(ids) for _ in range(n)]
    torch.cuda.synchronize()
    return [float(x) for x in losses], time.perf_counter() - t0


def telemetry_ab(step, ids, n):
    """ms/step in runs of `n` steps with telemetry in its default mode
    (metrics: `TrainStep` synchronizes the device after each step to
    stamp `device_step`) and off (no sync), interleaved M/O/O/M."""
    ms = {"metrics": [], "off": []}
    for mode in ("metrics", "off", "off", "metrics"):
        prev = observability.set_mode(mode)
        try:
            _, wall = timed_steps(step, ids, n)
        finally:
            observability.set_mode(prev)
        ms[mode].append(wall / n * 1e3)
    print(f"telemetry A/B, {n} steps a run, M/O/O/M: metrics "
          f"{ms['metrics']} ms/step, off {ms['off']} ms/step; best metrics "
          f"/ best off {min(ms['metrics']) / min(ms['off']):.4f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("gpt_small", "gpt_1p3b"),
                    default="gpt_small")
    ap.add_argument("--remat", default="",
                    help="off | full | a policy name (BENCH_GPT_REMAT)")
    ap.add_argument("--steps", type=int, help="timed steps (10; gpt_1p3b 5)")
    ap.add_argument("--trace", help="write the Chrome trace here")
    ap.add_argument("--telemetry-ab", action="store_true",
                    help="also time the steps with telemetry in its default "
                         "mode and off, interleaved")
    args = ap.parse_args(argv)
    remat = parse_remat(args.remat)
    if args.model == "gpt_1p3b":
        cfg, step, ids = bench_gpt1p3b_step(remat=remat)
        label, warm, n = "gpt_1p3b b1·s2048 bf16 O2 AdamW", 2, 5
    else:
        cfg, step, ids = bench_gpt_step(remat=remat)
        label, warm, n = f"gpt_small b{BATCH}·s{SEQ} bf16 O1 AdamW", 3, 10
    n = args.steps or n
    batch, seq = ids.shape
    torch.cuda.reset_peak_memory_stats()
    timed_steps(step, ids, warm)
    losses, wall = timed_steps(step, ids, n)
    dt = wall / n
    print(f"card: {torch.cuda.get_device_name(0)}")
    print(f"{label} (remat {remat}): {dt * 1e3:.3f} ms/step, "
          f"{batch * seq / dt:.1f} tok/s, MFU "
          f"{model_flops(cfg, batch, seq) / dt / H100_PEAK_BF16:.4f} "
          f"(989 TFLOP/s bf16 peak), loss {losses[0]:.4f} → "
          f"{losses[-1]:.4f} over {n} steps, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if args.telemetry_ab:
        telemetry_ab(step, ids, n)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, pwall = timed_steps(step, ids, 2)
    rows = kernel_rows(prof)
    dev_us = device_us(prof)
    if not dev_us:
        print("profiler recorded no device time")
        return 1
    print(f"profiled 2 steps: {pwall * 1e3:.3f} ms wall, device time "
          f"{dev_us / 1e3:.3f} ms; idle share "
          f"{100 * (1 - dev_us / 1e6 / pwall):.1f}%")
    for k, names in FLASH_KERNELS.items():
        for name in names:
            us = sum(e.self_device_time_total for e in rows if name in e.key)
            count = sum(e.count for e in rows if name in e.key)
            print(f"{k} {name}: {us / 1e3:.3f} ms = "
                  f"{100 * us / dev_us:.1f}% of device time, {count} "
                  "launches")
    opt_us = optimizer_device_us(prof)
    print(f"optimizer update ({OPT_RANGE}): {opt_us / 2e3:.3f} ms a step = "
          f"{100 * opt_us / dev_us:.1f}% of device time"
          if opt_us else "optimizer update: not measured (no device time "
          f"under {OPT_RANGE})")
    by_cat = {}
    for e in rows:
        cat = next((c for c, keys in CATEGORIES
                    if any(k in e.key for k in keys)), "other")
        by_cat[cat] = by_cat.get(cat, 0) + e.self_device_time_total
    for cat, us in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"category {cat}: {us / 1e3:.3f} ms = "
              f"{100 * us / dev_us:.1f}%")
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in rows[:25]:
        print(f"{e.self_device_time_total / 1e3:10.3f} ms "
              f"{100 * e.self_device_time_total / dev_us:5.1f}% "
              f"{e.count:7d}x  {e.key[:90]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
