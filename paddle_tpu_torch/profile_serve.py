"""Where the serving time goes on the card.

Runs serve loads of `chip_smoke.py` over gpt_small with bf16 weights, 8
greedy requests with prompts of 16-900 tokens, 32 new tokens each
(engine num_slots 8, page_size 16, token_budget 256):

* `serve` (default): bf16 KV pool, random prompt ids (chip_smoke's
  "serve" phase);
* `int8-ngram`: int8 KV pool and n-gram speculation (spec_k 4), each
  prompt a random 24-token segment repeated to its length (chip_smoke's
  "serve int8 + ngram" phase);
* `bf16-repetitive`, `int8`, `ngram`: the repetitive prompts with a bf16
  pool and no speculation, an int8 pool alone, n-gram speculation alone
  — with `int8-ngram`, the four corners that separate the int8 pool's
  cost from speculation's.

Each load runs one warm-up burst, one timed burst and one burst under
`torch.profiler`, then prints:

* the timed burst's wall time, generated tok/s and median TTFT, engine
  steps (single ticks + verify windows), proposals and acceptances, and
  the host seconds spent mining proposals;
* the timed burst's host time per engine `step()` call (a verify window
  and its straggler tick are one call): the median and its quartiles,
  and the host time spent inside the paged attention wrapper
  (`ragged_paged_attention`: checks, the launch call and its kernels'
  enqueue), per call and per step;
* the profiled burst's device time (the sum of the kernel rows' times on
  the one stream) and the device's idle share of its wall time;
* the paged attention kernels' shares of device time, by kernel symbol:
  K1 (`rpa_kernel`, and its tensor-core route's three launches) and K2
  (`rpa_qblock_kernel`, and its tensor-core route's two);
* the kernels ordered by device time, with launch counts;
* the host rows of the profiled burst ordered by self CPU time (torch
  ops and CUDA runtime calls, such as each `cudaLaunchKernel`), with
  their counts: the host trace of a burst, under the profiler's own
  overhead.

    python -m paddle_tpu_torch.profile_serve [--load LOAD ...]
        [--trace PATH]

`--trace` also writes the Chrome trace of the last load. Needs a CUDA
GPU.
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
              token_budget=256)
_NGRAM = dict(spec_mode="ngram", spec_k=4)
# kernel names of csrc/paged_attention.cu as the profiler shows them: K1
# on the CUDA cores and the three launches of its tensor-core route, K2
# on the CUDA cores and the two of its tensor-core route (a bf16 q on
# bf16, int8 and int4 pools)
PAGED_KERNELS = {"K1": ("rpa_kernel", "rpa_tc_plan_kernel", "rpa_tc_kernel",
                        "rpa_tc_merge_kernel"),
                 "K2": ("rpa_qblock_kernel", "rpa_tc_qblock_kernel",
                        "rpa_tc_qblock_merge_kernel")}
# load -> (engine knobs, repetitive prompts)
LOADS = {"serve": (dict(kv_dtype="bfloat16"), False),
         "bf16-repetitive": (dict(kv_dtype="bfloat16"), True),
         "int8": (dict(kv_dtype="int8"), True),
         "ngram": (dict(kv_dtype="bfloat16", **_NGRAM), True),
         "int8-ngram": (dict(kv_dtype="int8", **_NGRAM), True)}


def _prompts(repetitive, vocab):
    if not repetitive:
        rng = np.random.default_rng(1234)
        return [rng.integers(0, vocab, (n,)) for n in PROMPT_LENS]
    rng = np.random.default_rng(4321)
    return [np.resize(rng.integers(0, vocab, (24,)), n) for n in PROMPT_LENS]


def _burst(server, prompts):
    """(wall seconds, median TTFT seconds) of one burst."""
    t0 = time.perf_counter()
    futs = [server.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    for f in futs:
        f.result(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ttft = sorted(f.pt_request.t_first_token - t0 for f in futs)
    return wall, ttft[len(ttft) // 2]


class _HostTimer:
    """Wraps `obj.name` to record the host seconds of each call, until
    `remove`."""

    def __init__(self, obj, name):
        self.obj, self.name, self.fn = obj, name, getattr(obj, name)
        self.times = []

        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return self.fn(*args, **kw)
            finally:
                self.times.append(time.perf_counter() - t0)

        setattr(obj, name, timed)

    def remove(self):
        setattr(self.obj, self.name, self.fn)


def run_load(model, name, trace=None):
    from .ops.cuda_kernels import paged_attention as pa

    knobs, repetitive = LOADS[name]
    prompts = _prompts(repetitive, model.config.vocab_size)
    server = LLMServer(model, LLMEngineConfig(**ENGINE, **knobs))
    eng = server.engine
    timers = [_HostTimer(eng, "step"),
              _HostTimer(pa, "ragged_paged_attention")]
    if eng._spec is not None:
        timers.append(_HostTimer(eng._spec, "_propose"))
    try:
        with server:
            _burst(server, prompts)                    # warm-up
            before = dict(eng.stats)
            for t in timers:
                t.times.clear()
            wall, ttft = _burst(server, prompts)
            step_s, paged_s, *scan_s = (np.asarray(t.times) for t in timers)
            d = {k: eng.stats[k] - before.get(k, 0) for k in eng.stats}
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                pwall, _ = _burst(server, prompts)
    finally:
        for t in timers:
            t.remove()
    scan = scan_s[0].sum() if scan_s else 0.0
    steps, windows = d["steps"], d.get("ngram_windows", 0)
    gen = NEW_TOKENS * len(prompts)
    print(f"load {name} ({knobs}, {'repetitive' if repetitive else 'random'}"
          f" prompts): {wall * 1e3:.3f} ms wall, {gen / wall:.1f} generated "
          f"tok/s, TTFT median {ttft * 1e3:.3f} ms, {steps} steps = "
          f"{steps - windows} ticks + {windows} windows "
          f"({wall * 1e3 / steps:.3f} ms/step)"
          + (f", proposed {d['ngram_proposed']} accepted "
             f"{d['ngram_accepted']}, proposal scan {scan * 1e3:.3f} ms "
             "on the host" if windows else ""))
    q1, med, q3 = np.percentile(step_s, (25, 50, 75)) * 1e3
    per_step = paged_s.sum() / len(step_s) * 1e3
    print(f"  host per step() call: median {med:.3f} ms (quartiles "
          f"{q1:.3f} / {q3:.3f}) over {len(step_s)} calls; paged attention "
          f"{len(paged_s) / len(step_s):.1f} calls per step(), "
          f"{np.median(paged_s) * 1e6:.1f} µs each (median), "
          f"{per_step:.3f} ms per step() = "
          f"{100 * paged_s.sum() / step_s.sum():.1f}% of the steps' time")
    # kernel rows only: the CPU-side op rows (aten::mm, autograd
    # Functions) carry their kernels' device time too
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    device_us = sum(e.self_device_time_total for e in rows)
    if not device_us:
        print("profiler recorded no device time")
        return 1
    print(f"  profiled burst: {pwall * 1e3:.3f} ms wall, device time "
          f"{device_us / 1e3:.3f} ms = {100 * device_us / 1e6 / pwall:.1f}% "
          f"of wall; idle share {100 * (1 - device_us / 1e6 / pwall):.1f}%")
    for label, names in PAGED_KERNELS.items():
        total = 0
        for kname in names:
            us = sum(e.self_device_time_total for e in rows
                     if kname in e.key)
            n = sum(e.count for e in rows if kname in e.key)
            total += us
            if n:
                print(f"  {label} {kname}: {us / 1e3:.3f} ms = "
                      f"{100 * us / device_us:.1f}% of device time, {n} "
                      "launches")
        print(f"  {label} in all: {total / 1e3:.3f} ms = "
              f"{100 * total / device_us:.1f}% of device time")
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in rows[:12]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms "
              f"{100 * e.self_device_time_total / device_us:5.1f}% "
              f"{e.count:7d}x  {e.key[:90]}")
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU
                   and e.self_cpu_time_total > 0),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    print("  host rows of the profiled burst by self CPU time:")
    for e in host[:10]:
        print(f"  {e.self_cpu_time_total / 1e3:10.3f} ms "
              f"{e.count:7d}x  {e.key[:90]}")
    if trace:
        prof.export_chrome_trace(trace)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--load", choices=sorted(LOADS), nargs="+",
                    default=["serve"])
    ap.add_argument("--trace", help="write the Chrome trace here")
    args = ap.parse_args(argv)
    model = GPTForCausalLM(gpt_small(), dtype="bfloat16", seed=1234)
    print(f"card: {torch.cuda.get_device_name(0)}")
    rc = 0
    for i, name in enumerate(args.load):
        last = i == len(args.load) - 1
        rc |= run_load(model, name, args.trace if last else None)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
