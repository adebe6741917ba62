"""Where the serving time goes on the card.

Runs the serve load of `chip_smoke.py` (gpt_small, bf16 weights and KV
pool, 8 greedy requests with prompts of 16-900 tokens, 32 new tokens
each; engine num_slots 8, page_size 16, token_budget 256) once to warm
up and once under `torch.profiler`, then prints:

* the burst's wall time, ticks and generated tokens;
* device time (the sum of the kernel rows' times on the one stream) and
  the device's idle share of the wall time;
* the kernels ordered by device time, with launch counts.

    python -m paddle_tpu_torch.profile_serve [--trace PATH]

`--trace` also writes the Chrome trace. Needs a CUDA GPU.
"""
import argparse
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .inference import LLMEngineConfig, LLMServer
from .text.models.gpt import GPTForCausalLM, gpt_small

PROMPT_LENS = (16, 40, 100, 200, 350, 500, 700, 900)
NEW_TOKENS = 32
ENGINE = dict(num_slots=8, page_size=16, max_model_len=1024,
              token_budget=256, kv_dtype="bfloat16")


def _burst(server, prompts):
    t0 = time.perf_counter()
    futs = [server.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    for f in futs:
        f.result(timeout=600)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", help="write the Chrome trace here")
    args = ap.parse_args(argv)
    cfg = gpt_small()
    model = GPTForCausalLM(cfg, dtype="bfloat16", seed=1234)
    rng = np.random.default_rng(1234)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in PROMPT_LENS]
    server = LLMServer(model, LLMEngineConfig(**ENGINE))
    with server:
        _burst(server, prompts)                    # warm-up
        ticks0 = server.engine.stats["steps"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = _burst(server, prompts)
        ticks = server.engine.stats["steps"] - ticks0
    gen = NEW_TOKENS * len(prompts)
    print(f"card: {torch.cuda.get_device_name(0)}")
    print(f"burst: {wall * 1e3:.3f} ms wall, {ticks} ticks "
          f"({wall * 1e3 / ticks:.3f} ms/tick), {gen} generated tokens "
          f"({gen / wall:.1f} tok/s) under the profiler")
    # kernel rows only: the CPU-side op rows (aten::mm, autograd
    # Functions) carry their kernels' device time too
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    device_us = sum(e.self_device_time_total for e in rows)
    if not device_us:
        print("profiler recorded no device time")
        return 1
    print(f"device time {device_us / 1e3:.3f} ms = "
          f"{100 * device_us / 1e6 / wall:.1f}% of wall; idle share "
          f"{100 * (1 - device_us / 1e6 / wall):.1f}%")
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in rows[:20]:
        print(f"{e.self_device_time_total / 1e3:10.3f} ms "
              f"{100 * e.self_device_time_total / device_us:5.1f}% "
              f"{e.count:7d}x  {e.key[:90]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
