#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (`paddle_tpu_torch`) on one
NVIDIA GPU. Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase catches and
continues:

1. card     — the card's name and power limit (nvidia-smi).
2. build    — every CUDA kernel of the serving path, from `csrc/`, with
              nvcc for sm_90a (one nvcc per source, started together).
3. kernels  — each kernel against its plain PyTorch version on the card
              at the serving path's shapes, with the tolerance stated;
              kernel / plain times (CUDA events, median of 30 launches,
              L2 flushed before each) beside the least time the card
              could take (bound).
4. serve    — `LLMServer` over gpt_small (random weights from a seed),
              bf16 weights and bf16 KV pool, 8 greedy requests with
              prompts of 16-900 tokens. The launch counts are set to 0
              just before and read just after: the paged attention
              kernel must have launched once per layer per engine tick.
5. cross    — an f32 gpt_small engine on the card and the same engine on
              the CPU (plain versions) on 2 prompts: the first frontier
              logits agree to 1e-3 max-abs; token agreement printed.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Exits non-zero without printing a result
when no CUDA device is present.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

SERVE_PROMPT_LENS = (16, 40, 100, 200, 350, 500, 700, 900)
SERVE_NEW_TOKENS = 32
SERVE_CFG = dict(num_slots=8, page_size=16, max_model_len=1024,
                 token_budget=256)


def _card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(out)   # name, power limit — as nvidia-smi prints them
    return out


def _median_ms(fn, flush, reps=30):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()       # the serving path reads each layer's pool cold
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _paged_case(dtype, offset, decode=False, seed=0):
    """The serving path's attention call at its shapes: H=12, D=64,
    P=16, MP=64 (max_model_len 1024), S=8 slots, T=token_budget rows.
    Mixed tick: one frontier per slot (kv_len 0 → padding, 1, 17
    crossing a page, the full 1024, ...), then a chunk of prefill rows
    of one slot, then padding. Decode tick (`decode`): one frontier row
    per slot at the serve phase's lengths, the rest padding. Page ids
    are shuffled; every table entry holds a valid id, so entries past a
    row's length are stale ids the kernel must not read."""
    g = torch.Generator().manual_seed(seed)
    H, D, P, MP, S = 12, 64, 16, 64, 8
    T = SERVE_CFG["token_budget"]
    N = S * MP + 1
    if decode:
        lens = [n + SERVE_NEW_TOKENS for n in SERVE_PROMPT_LENS]
        lens += [0] * (T - S)
        sid = list(range(S)) + [0] * (T - S)
    else:
        frontier = [0, 1, 17, 1024 - offset, 300, 555, 900, 33]
        chunk_slot, chunk0 = 6, 600 - offset
        n_chunk = T - S - 1
        lens = frontier + list(range(chunk0, chunk0 + n_chunk)) + [0]
        sid = list(range(S)) + [chunk_slot] * n_chunk + [0]
    perm = torch.randperm(N - 1, generator=g) + 1
    pt = perm.reshape(S, MP).to(torch.int32)
    kp = torch.randn((N, P, H, D), generator=g).to(dtype)
    vp = torch.randn((N, P, H, D), generator=g).to(dtype)
    q = torch.randn((T, H, D), generator=g).to(dtype)
    dev = torch.device("cuda")
    args = [q, kp, vp, pt, torch.tensor(sid, dtype=torch.int32),
            torch.tensor(lens, dtype=torch.int32)]
    return [a.to(dev) for a in args]


def _bound(args, offset):
    """Least time for the work of one call: bytes (each input read once —
    a slot's K/V rows up to its longest row's length — and the output
    written once) over HBM bandwidth, and the q·k + p·v flops over the
    peak rate for the input type; the larger of the two."""
    q, kp, _, pt, sid, lens = args
    T, H, D = q.shape
    eff = torch.where(lens > 0, lens + offset, 0).long().cpu()
    per_slot = {}
    for s, k in zip(sid.cpu().tolist(), eff.tolist()):
        per_slot[s] = max(per_slot.get(s, 0), k)
    kv_rows = sum(per_slot.values())
    nbytes = (2 * kv_rows * H * D * kp.element_size()
              + 2 * q.numel() * q.element_size()
              + (pt.numel() + sid.numel() + lens.numel()) * 4)
    flops = 4 * int(eff.sum()) * H * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kp.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _timed(pa, args, flush):
    ms = _median_ms(lambda: pa.ragged_paged_attention(*args), flush)
    plain_ms = _median_ms(lambda: pa.ragged_paged_attention_plain(*args),
                          flush)
    bound_ms, bound_by = _bound(args, 0)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def check_paged_attention(pa, flush):
    """Kernel vs plain version on the card, on a mixed prefill + decode
    tick (frontier offset 0 and 3) and a pure decode tick. Returns the
    mixed tick's bf16 (serving dtype) numbers."""
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        worst = 0.0
        for offset, decode in ((0, False), (3, False), (0, True)):
            args = _paged_case(dtype, offset, decode)
            out = pa.ragged_paged_attention(*args, frontier_offset=offset)
            ref = pa.ragged_paged_attention_plain(*args,
                                                  frontier_offset=offset)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            pad = args[5] == 0
            if not torch.all(out[pad] == 0):
                raise AssertionError("kv_len 0 rows are not exact zeros")
            if not torch.isfinite(out).all():
                raise AssertionError("non-finite kernel output")
            worst = max(worst, err)
        if worst > tol[dtype]:
            raise AssertionError(
                f"paged attention {dtype}: max abs err {worst:.3e} > "
                f"{tol[dtype]:.0e}")
        for decode in (False, True):
            r = _timed(pa, _paged_case(dtype, 0, decode), flush)
            print(f"paged_attention {str(dtype)[6:]} "
                  f"{'decode' if decode else 'mixed'} tick: max_abs_err "
                  f"{worst:.3e} (tol {tol[dtype]:.0e}), kernel "
                  f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
                  f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound")
            if not decode:
                res[dtype] = dict(max_abs_err=worst, **r)
    return res


def serve(pa):
    from paddle_tpu_torch.inference import LLMEngineConfig, LLMServer
    from paddle_tpu_torch.text.models.gpt import GPTForCausalLM, gpt_small

    cfg = gpt_small()
    model = GPTForCausalLM(cfg, dtype="bfloat16", seed=1234)
    rng = np.random.default_rng(1234)
    prompts = [rng.integers(0, cfg.vocab_size, (n,))
               for n in SERVE_PROMPT_LENS]
    server = LLMServer(model, LLMEngineConfig(kv_dtype="bfloat16",
                                              **SERVE_CFG))
    eng = server.engine
    with server:
        server.generate(prompts[0][:8], max_new_tokens=2)   # warm-up
        torch.cuda.synchronize()
        ticks0 = eng.stats["steps"]
        pa.reset_launches()
        t0 = time.perf_counter()
        futs = [server.submit(p, max_new_tokens=SERVE_NEW_TOKENS)
                for p in prompts]
        outs = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        launches = pa.launches
        ticks = eng.stats["steps"] - ticks0
    for p, f, o in zip(prompts, futs, outs):
        if len(o) != len(p) + SERVE_NEW_TOKENS:
            raise AssertionError(f"request returned {len(o)} tokens, "
                                 f"wanted {len(p) + SERVE_NEW_TOKENS}")
        if not (np.array_equal(o[:len(p)], p)
                and ((o >= 0) & (o < cfg.vocab_size)).all()):
            raise AssertionError("request output is not prompt + ids")
    if launches != cfg.num_layers * ticks or ticks == 0:
        raise AssertionError(
            f"paged attention launched {launches} times in {ticks} ticks; "
            f"expected {cfg.num_layers} per tick")
    # TTFT from the submission of the burst to each first token
    ttft = sorted(f.pt_request.t_first_token - t0 for f in futs)
    gen = SERVE_NEW_TOKENS * len(prompts)
    print(f"serve gpt_small bf16: {len(prompts)} requests, "
          f"{sum(SERVE_PROMPT_LENS)} prompt tokens, {gen} generated in "
          f"{wall:.3f} s = {gen / wall:.1f} generated tok/s, {ticks} ticks, "
          f"TTFT median {ttft[len(ttft) // 2]:.3f} s max {ttft[-1]:.3f} s, "
          f"paged attention launches {launches} = {cfg.num_layers} x "
          f"{ticks}")
    return launches


def cross_check():
    from paddle_tpu_torch.inference import LLMEngine, LLMEngineConfig
    from paddle_tpu_torch.text.models.gpt import GPTForCausalLM, gpt_small

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 matmuls
    torch.backends.cudnn.allow_tf32 = False
    cfg = gpt_small()
    gpu = GPTForCausalLM(cfg, dtype="float32", seed=99)
    cpu = GPTForCausalLM(cfg, device="cpu", dtype="float32", seed=0)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rng = np.random.default_rng(99)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (13, 37)]
    ecfg = dict(num_slots=2, page_size=16, max_model_len=1024,
                token_budget=64)
    runs = []
    for model in (gpu, cpu):
        eng = LLMEngine(model, LLMEngineConfig(**ecfg))
        reqs = [eng.add_request(p, max_new_tokens=4) for p in prompts]
        eng.step()      # both prompts fit the budget: 1st tick samples both
        first = eng.last_logits.float().cpu()
        while eng.has_work():
            eng.step()
        runs.append((first, [r.future.result() for r in reqs]))
    (lg, tg), (lc, tc) = runs
    err = (lg - lc).abs().max().item()
    same = sum(int(a == b) for x, y in zip(tg, tc)
               for a, b in zip(x[-4:], y[-4:]))
    print(f"cross-check gpt_small f32 card vs cpu: first frontier logits "
          f"max abs diff {err:.3e} (tol 1e-3), generated tokens agree "
          f"{same}/8")
    if not err <= 1e-3:
        raise AssertionError(f"card and cpu logits differ by {err:.3e}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch.ops.cuda_kernels import _build
    from paddle_tpu_torch.ops.cuda_kernels import paged_attention as pa

    _card()
    t0 = time.perf_counter()
    _build.build(["paged_attention"])
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc seconds per source: {_build.build_seconds})")
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    kres = check_paged_attention(pa, flush)
    del flush
    launches = serve(pa)
    cross_check()
    main_path = kres[torch.bfloat16]
    kernels = [{
        "name": "ragged_paged_attention", "route": "cuda",
        "source": pa.SOURCE, "replaces": pa.REPLACES,
        "launches": launches,
        "max_abs_err": main_path["max_abs_err"], "ms": main_path["ms"],
        "plain_ms": main_path["plain_ms"],
        "bound_ms": main_path["bound_ms"],
        "bound_by": main_path["bound_by"], "library_ms": None}]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
