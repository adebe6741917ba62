#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (`paddle_tpu_torch`) on one
NVIDIA GPU. Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase catches and
continues:

1. card     — the card's name and power limit (nvidia-smi).
2. build    — every CUDA kernel of the serving and training paths, from
              `csrc/` (paged attention, flash attention, the int8 GEMM),
              with nvcc for sm_90a (one nvcc per source, started
              together). Prints the registers, spill bytes and static
              shared memory (the `-Xptxas -v` log), the blocks per SM the
              registers allow, the paged tensor-core kernels' shared
              memory per block (static + dynamic, from the profiler's
              record of one launch each), and the count of tensor-core
              instructions (HMMA / HGMMA; IMMA for int8) in the SASS
              (`cuobjdump -sass`) of each flash kernel, of the paged
              tensor-core kernels (K1's and K2's, at head_dim 64 and 128,
              on bf16, int8 and int4 pools) and of the int8 GEMM (f32 and
              bf16 x, int8 and packed int4 weights); fails if a
              tensor-core kernel has none.
3. kernels  — each kernel against its plain PyTorch version on the card,
              each output row within a tolerance of that row's max-abs
              (1e-4 for f32 arithmetic, 2e-2 where q or the pool is
              bf16): ragged paged attention K1 on f32, bf16, int8 and
              packed-int4 pools at the serving tick's shapes (mixed
              prefill + decode tick at frontier offset 0 and 3, pure
              decode tick); its query-blocked variant K2 on the same four
              pool kinds at the speculative verify step (8 slots x 5 rows,
              a dead and a narrow slot, offset 0 and 3); each with an f32
              and a bf16 q, each call on the route `paged_route` names (a
              bf16 q on a bf16, int8 or int4 pool: the tensor-core route,
              counted in `tc_launches`); the tensor-core routes of K1 on
              layouts that break its chunks and KV splits (kv_len at split
              boundaries, 1 and 1024; a chunk whose rows end in different
              splits; a 64-row tile holding two slots' rows; padding-only
              tiles; slots in any order; page size 64 and head_dim 128;
              1300 rows at page size 5) and of K2 on verify layouts (qb 1
              and 16; a block whose rows end in different splits; dead and
              narrow blocks; page size 64 and head_dim 128), on bf16, int8
              and int4 pools, each at offset 0 and 3; flash attention
              forward, dq and dk/dv (K3-K5) at the training path's shapes
              (b·h 192, s 1024, d 64, bf16, causal) and at smaller f32 /
              bf16 cases (ragged seq, non-causal, kv_lens with a 0 row,
              seq_k != seq_q, head_dim 8, 32, 96, 128, 256); each case
              must take the route that `tensor_core_route` names (bf16 at
              head_dim 64 / 128: the tensor-core K3-K5).
              Kernel / plain / library times (CUDA events, median of 30
              launches, L2 flushed before each, a spin kernel queued
              ahead so the window holds no host gaps) beside the least
              time the card could take (bound: each input byte read once
              — codes and scales for a quantized pool — each output
              written once); for a paged call on the tensor-core route
              also the CUDA-core kernel's time on the same inputs and the
              host microseconds per call of both (400 calls back to
              back). The library times of K3-K5 are torch's
              `scaled_dot_product_attention` forward and the backward
              node it records, called directly. The int8 GEMM (the W8A8
              linear of weight-only serving) against its plain version at
              gpt_small's four linear shapes x T 8, 13 and 256, int8 and
              packed-int4 weights, bf16 and f32 x, a bias and a zero row:
              the activation codes, steps and int32 accumulators equal,
              the output within 1 ulp; timed at T 8 and 256 (bf16 x)
              beside its bound (weight bytes, or int8 operations at 1979
              TOPS), `torch._int_mm` on the same codes (T 256) and the
              float layer's bf16 `torch.addmm`.
4. serve    — `LLMServer` over gpt_small (random weights from a seed: one
              model for every serve phase), bf16 weights and bf16 KV
              pool, 8 greedy requests with prompts of 16-900 tokens. The
              launch counts are set to 0 just before and read just after:
              K1 (bf16 pool) must have launched once per layer per engine
              tick, every time on its tensor-core route, and nothing
              else.
4b. serve cross — the same engine and prompt lengths (`LLMEngine`, new
              prompts), twice on the card: through the paged kernels, and
              with `ragged_paged_attention` swapped for its plain version;
              on the bf16 pool and on the int8 pool. Request by request up
              to its first differing token, the same steps, and every
              emitted token's logits within SERVE_BF16_LOGIT_TOL max-abs;
              a token may differ only at a near-tie of the plain run (top
              two logits within that tolerance), and the request is
              compared no further.
5. serve + ngram — the same server and load with n-gram speculation
              (spec_k 4), each prompt a random 24-token segment repeated
              to its length, on an int8, a bf16 and an int4 KV pool: K2 on
              the pool must have launched once per layer per verify
              window and K1 once per layer per single tick, both more than
              0 and all on the tensor-core route, with proposals made.
              Prints tok/s, ticks, windows, proposed / accepted and TTFT.
5b. serve cross + ngram — phase 4b's method on the bf16 + ngram and
              int8 + ngram engines: the same tokens and the same windows'
              emitted (accepted + 1) counts up to a request's first
              near-tie.
5c. prng    — jax's threefry bits (`core.prng`) on the card equal the
              CPU's as integers on 8 seeds x 8 streams x 8 positions of
              folded keys at the vocab's width (50304); `sample_tokens`
              on the card vs the CPU on the same f32 logits [8, 50304] at
              temperatures 0, 0.5, 0.8, 1.3 x top_p 1, 0.9, 0.5: equal
              picks on every row whose top-2 margin (Gumbel-perturbed
              scores, or logits for greedy rows) exceeds 1e-4 of its top
              score (the rest counted); the sampler's device ms a call,
              replayed from a CUDA graph as a fused window runs it
              (`profile_serve.sampler_ms`), and its eager enqueue's host
              µs.
              Runs before phase 4 (it shares phase 3's L2 flush buffer).
5d. fused   — the fused decode window (decode_k) as one CUDA graph per
              (k, greedy-or-sampled), on the serve phase's model and 8
              prompts: (a) graph vs eager, bit-identical — one window run
              eagerly on copies of the pools and as the graph replay:
              emits and every pool and scale-plane byte equal, after an
              eager K1 call has outgrown the capture stream's workspace
              (a sentinel allocated then must stay untouched), on bf16 (k
              8 and 4, greedy; k 8 sampled), int8 and int4 pools (k 8;
              these two capture while the previous gate's engine, dead in
              a reference cycle, becomes garbage and the collector runs
              at every allocation: a graph destroyed mid-capture would
              invalidate the capture),
              the profiler seeing 12 x k `rpa_tc_kernel` launches and a
              `cudaGraphLaunch` in the replay; (b) `LLMEngine` at decode_k
              8 vs 1 (bf16 greedy and sampled, int8 greedy): every
              emitted token's logits within SERVE_BF16_LOGIT_TOL, tokens
              equal but at near-ties (of the Gumbel-perturbed scores for
              sampled requests); (c) `LLMServer` bursts at decode_k 1, 4
              and 8 on the bf16 pool (greedy, then sampled after a
              `reseed`) and at 8 on the int8 and int4 pools, the counts
              set to 0 just before each: K1 12 per single tick and 12 x k
              per warm-up and graph replay, all on the tensor-core route,
              at most two captures per server; tok/s, host and device ms
              per window (per tick at k=1) beside the card's name and
              power limit; (d) a sampled n-gram burst (spec_k 4): K2 12
              per verify window, K1 12 per tick.
5e. draft   — draft-model speculation (spec_k 4) on a damped gpt_small
              and its 1-block draft (bench.py's `_spec_draft_pair` at
              this width): (a) the propose window's graph replay vs the
              same window run eagerly on copies of the draft pools, with
              a lag-1 and a lag-0 row, after the capture stream's
              workspace was outgrown: emits and every draft pool and
              scale-plane byte equal, on bf16, int8 and int4 pools, greedy
              and sampled, the profiler seeing 5 `rpa_tc_kernel` and a
              graph launch in the replay; (b) `LLMEngine` with the draft
              vs the k=1 engine (bf16 greedy and sampled): logits within
              SERVE_BF16_LOGIT_TOL, tokens equal but at near-ties;
              (c) `LLMServer` bursts on bf16, int8 and int4 pools, the
              counts set to 0 just before each: K2 12 per verify window,
              K1 12 per target tick, 1 per draft catch-up tick and 5 per
              propose warm-up and replay, all on the tensor-core route,
              at most two propose captures, proposals accepted; tok/s,
              acceptance rate, host / draft / stream ms per window.
5f. weights — gpt_small after `quantize_model_int8` and after
              `quantize_model_int4` (48 linears each): `LLMServer` bursts
              at decode_k 1 and 4, the counts set to 0 just before each:
              the int8 GEMM 48 per tick and 48 x 4 per fused warm-up and
              replay, K1 as in 5d; the k=1 engine through the GEMM vs
              through its plain version: logits within
              SERVE_BF16_LOGIT_TOL, tokens equal but at near-ties; tok/s
              and the weight bytes saved.
5g. structured — grammar-constrained decoding on the 5e target (and its
              draft) with a synthetic 50304-string vocabulary made from a
              seed (token 0 "" is the eos, the 95 printable characters,
              all 9025 pairs, random distinct triples;
              `profile_serve.structured_token_strs`), 256 grammar states,
              8 requests of 16-200 prompt tokens and up to 120 new ones:
              a list template, a small object and a JSON schema greedy,
              the template sampled, and four unconstrained (two greedy,
              two sampled). Compile seconds, arena load / refresh ms and
              the mask's device µs at S 8 and T 40 (graph replays); the
              fused gate of 5d on structured windows (k 4, greedy and
              sampled: the graph that masks, replay vs eager byte-equal);
              a grammar loaded mid-run and a compaction forced: replay
              vs eager still equal, the tables at their addresses, one
              capture per graph key; `LLMEngine` runs at k=1, fused k=4,
              n-gram spec_k 4 and with the draft: every constrained
              output valid (its DFA replay meets no disallowed token,
              one that ended at eos fullmatches its pattern), the other
              three against k=1 (logits within SERVE_BF16_LOGIT_TOL,
              tokens equal but at near-ties of the masked scores), the
              fused run's unconstrained rows against an all-unconstrained
              run; `LLMServer` bursts on each path, mixed then
              all-unconstrained, the counts set to 0 just before each: K1
              12 per tick and 12 x k per fused warm-up and replay, K2 12
              per verify window, the draft's as in 5e, all on the
              tensor-core route; tok/s of both bursts, host µs per
              `_grammar_args` and per host-tick mask.
6. cross    — an f32 gpt_small engine on the card and the same engine on
              the CPU (plain versions) on 2 prompts: the first frontier
              logits agree to 1e-3 max-abs; token agreement printed.
7. cross quant + spec — f32 gpt_small (TF32 off), 2 repetitive prompts:
              card vs CPU first frontier logits on int8 and int4 pools
              within max(1e-3, the CPU's own int8 / int4 vs f32
              difference); on the card, the n-gram engine's tokens equal
              the k=1 engine's on f32, int8 and int4 pools; the f32 n-gram
              run must launch K1 and K2 on the f32 pool, the int8 and int4
              ones K1 and K2 on theirs, all on the CUDA-core kernels (an
              f32 q).
8. train    — `jit.TrainStep` over gpt_small at b16·s1024, bf16 O1
              `amp.auto_cast`, `AdamW(1e-4)` (bench.py's bench_gpt on the
              port): 3 warm-up steps, then 10 timed ones with the launch
              counts set to 0 just before; each flash kernel must have
              launched 12 times per step, every time on the tensor-core
              route, every loss be finite and the last below the first.
              Prints ms/step, tokens/s and MFU.
9. train cross — f32 gpt_small at b2·s128 (TF32 off): one TrainStep on
              the card and one on the CPU from the same weights; the loss
              and every parameter gradient agree to 1e-3 of each
              gradient's max-abs.
10. train cross bf16 — gpt_small at b2·s256, bf16 O1: one TrainStep on
              the card through the kernels (K3-K5 on the tensor-core
              route) and one from the same weights with the module's
              flash_forward / flash_bwd_dq / flash_bwd_dkv swapped for
              their plain versions; the losses agree to 1e-5 relative,
              and each parameter gradient's max-abs difference over its
              max-abs is within 2e-2, the median over the gradients
              within 1e-2.

The line before the last is {"kernels": [...]}: each route of K1 and K2
(bf16, f32, int8, int4 pools), K3-K5 and the int8 GEMM (int8 and int4
weights, one layer's four linears at T 8 and at T 256), with its
launches from the main-path run that drives it (K1 on bf16, int8 and
int4 pools: the greedy decode_k 8 burst of phase 5d, whose graph
replays' share is "graph_launches", plus the 5e draft burst's launches
and its propose graph replays' share, and on the bf16 pool 5g's mixed
fused burst's (K1) and n-gram burst's (K2) as
"structured_burst_launches"; the GEMM: 5f's k=1 burst, and its decode_k
4 burst's); the last line is
{"ok": true, "device": {...}}. Exits non-zero without printing a result
when no CUDA device is present.
"""
import contextlib
import gc
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, FLOP/s, int8 OP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_INT8_OPS = 1979e12
SM_REGISTERS = 65536     # 32-bit registers per SM
# the tensor-core kernels, by library, and their threads per block
# (kTcThreads in csrc/flash_attention.cu, kThreads in paged_attention.cu's
# tc namespace and in int8_gemm.cu); the paged ones are templated on
# head_dim and pool kind (1 bf16, 8 int8, 4 int4), the int8 GEMM on x's
# type and the weight's width (int8, or packed int4)
TC_KERNELS = {"flash_attention": ("fa_fwd_tc_kernel", "fa_bwd_dq_tc_kernel",
                                  "fa_bwd_dkv_tc_kernel"),
              "paged_attention": ("rpa_tc_kernel", "rpa_tc_qblock_kernel"),
              "int8_gemm": ("w8a8_gemm_kernel",)}
TC_PAGED_KINDS = (1, 8, 4)
TC_THREADS = 128

SERVE_PROMPT_LENS = (16, 40, 100, 200, 350, 500, 700, 900)
SERVE_NEW_TOKENS = 32
SERVE_CFG = dict(num_slots=8, page_size=16, max_model_len=1024,
                 token_budget=256)


def _kernel_label(mangled):
    """'fa_fwd_tc_kernel<64>' / 'fa_fwd_kernel<bf16, 4, 1>' /
    'rpa_tc_kernel<64, 8>' / 'w8a8_gemm_kernel<bf16, int4>' /
    'quantize_rows_kernel<f32>' from a mangled name of a templated flash
    attention kernel, of the paged tensor-core route or of the int8 GEMM;
    None for any other function."""
    m = re.search(r"((?:fa_|rpa_tc_)\w*?kernel|w8a8_gemm_kernel|"
                  r"quantize_rows_kernel)I(.*?)EEv", mangled)
    if not m:
        return None
    base, targs = m.groups()
    dtype = (["bf16"] if "bfloat16" in targs
             else ["f32"] if targs.startswith("f") else [])
    ints = re.findall(r"Li(\d+)E", targs)
    width = [("int8", "int4")[int(b)] for b in re.findall(r"Lb(\d)E", targs)]
    return f"{base}<{', '.join(dtype + ints + width)}>"


def _ptxas_resources(log_path):
    """{kernel label: registers, spill bytes, static shared memory} of
    the kernels `_kernel_label` names, from the nvcc `-Xptxas -v` log of
    their build."""
    res, cur = {}, None
    with open(log_path) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                cur = _kernel_label(m.group(1))
                if cur:
                    res[cur] = dict(regs=None, spill_st=0, spill_ld=0, smem=0)
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                res[cur]["spill_st"], res[cur]["spill_ld"] = map(int,
                                                                 m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m:
                res[cur]["regs"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                res[cur]["smem"] = int(m.group(1))
    return res


def _tensor_core_instructions(nvcc, so_path):
    """{kernel label: HMMA / HGMMA instructions} of the kernels
    `_kernel_label` names in the library's SASS (`cuobjdump -sass`)."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([tool, "-sass", so_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = _kernel_label(m.group(1))
            if cur:
                counts[cur] = 0
        elif cur and re.search(r"\b(?:HG?MMA|IMMA)\b", line):
            counts[cur] += 1
    return counts


def _blocks_by_registers(regs, threads):
    """Resident blocks per SM that the register file allows: a warp's
    registers are allocated in units of 256 (a lane's count rounded up
    to 8)."""
    per_warp = -(-regs * 32 // 256) * 256
    return SM_REGISTERS // (per_warp * (threads // 32))


def _tc_labels(head_dims):
    """The tensor-core kernels' labels by library: each flash kernel at
    each head_dim, each paged one at each head_dim and pool kind, the
    int8 GEMM at each x type and weight width."""
    fl, pg = TC_KERNELS["flash_attention"], TC_KERNELS["paged_attention"]
    return {"flash_attention": [f"{k}<{d}>" for k in fl for d in head_dims],
            "paged_attention": [f"{k}<{d}, {kind}>" for k in pg
                                for d in head_dims
                                for kind in TC_PAGED_KINDS],
            "int8_gemm": [f"{k}<{x}, {w}>" for k in TC_KERNELS["int8_gemm"]
                          for x in ("f32", "bf16") for w in ("int8", "int4")]}


def build_report(build, head_dims):
    """Prints the registers, spills and static shared memory (ptxas log;
    for the tensor-core kernels, the blocks per SM the registers allow)
    and the tensor-core instruction count (HMMA / HGMMA; IMMA for int8) of
    every flash kernel, of the paged tensor-core kernels and of the int8
    GEMM's two kernels; fails when a tensor-core kernel (at each of
    `head_dims`, and each pool kind for the paged ones; each x type and
    weight width for the GEMM) has no tensor-core instruction."""
    paths = build.build(list(TC_KERNELS))
    want = _tc_labels(head_dims)
    mma = {}
    for lib, so in paths.items():
        res = _ptxas_resources(so[:-3] + ".log")
        lib_mma = _tensor_core_instructions(build._nvcc(), so)
        mma.update(lib_mma)
        for label in sorted(set(res) | set(lib_mma)):
            r = res.get(label, {})
            extra = ""
            if label.split("<")[0] in TC_KERNELS[lib] and r.get("regs"):
                extra = (f", registers allow "
                         f"{_blocks_by_registers(r['regs'], TC_THREADS)} "
                         f"blocks/SM")
            print(f"build {label}: {r.get('regs')} registers, spill stores "
                  f"{r.get('spill_st')} B, spill loads {r.get('spill_ld')} "
                  f"B, static smem {r.get('smem')} B{extra}; "
                  f"{lib_mma.get(label, 0)} HMMA/HGMMA/IMMA in its SASS")
    if not all(mma.get(label, 0) > 0 for labels in want.values()
               for label in labels):
        raise AssertionError(f"tensor-core kernels without tensor-core "
                             f"instructions: {mma}")


def _card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(out)   # name, power limit — as nvidia-smi prints them
    return out


# cycles of the spin kernel queued before each timed call (about 0.1 ms):
# the host enqueues the whole call while the card spins, so the window
# between the events holds the call's device time and no host gaps
SPIN_CYCLES = 200_000


def _median_ms(fn, flush, reps=30):
    """Median over `reps` calls of the device time between CUDA events
    around `fn`, the L2 flushed before each."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()       # the serving path reads each layer's pool cold
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# pool kinds of the serving paths, and the q types checked on each;
# kernel vs plain: each output row (one token, one head) within PA_TOL of
# that row's max-abs, by the call's arithmetic (`_pa_tol`; floored at
# PA_ROW_FLOOR of the tensor's max-abs, so rows of pure cancellation
# noise do not divide by ~0)
PA_KINDS = ("float32", "bfloat16", "int8", "int4")
PA_Q_DTYPES = (torch.float32, torch.bfloat16)
PA_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
PA_ROW_FLOOR = 1e-2
# int8 / int4 pools with a bf16 q (the tensor-core route): the route keeps
# S to f32 rounding and the P·V weights to 2^-16 (w_hi + w_lo), and rounds
# only its output to bf16, where the plain version (f32 throughout) rounds
# too, so the two are the same bf16 number except where their f32 values
# straddle a rounding boundary (≈ 2^-16 / 2^-8 of the elements). At least
# this share of the live rows' elements must be bit-equal; weights kept to
# bf16's 2^-9 alone would flip tens of percent, and stay within PA_TOL.
QUANT_BF16_EQUAL = 0.95
# the speculative verify step at the serve config: 8 slots of spec_k + 1
VERIFY_SLOTS, VERIFY_QB = 8, 5


def _pools(N, P, H, D, g):
    return (torch.randn((N, P, H, D), generator=g),
            torch.randn((N, P, H, D), generator=g))


def _paged_case(offset, decode=False, seed=0):
    """The serving path's K1 call at its shapes: H=12, D=64, P=16, MP=64
    (max_model_len 1024), S=8 slots, T=token_budget rows, f32 (`_pool`
    casts or quantizes). Mixed tick: one frontier per slot (kv_len 0 →
    padding, 1, 17 crossing a page, the full 1024, ...), then a chunk of
    prefill rows of one slot, then padding. Decode tick (`decode`): one
    frontier row per slot at the serve phase's lengths, the rest padding.
    Page ids are shuffled; every table entry holds a valid id, so entries
    past a row's length are stale ids the kernel must not read."""
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
    kp, vp = _pools(N, P, H, D, g)
    q = torch.randn((T, H, D), generator=g)
    return [q, kp, vp, pt, torch.tensor(sid, dtype=torch.int32),
            torch.tensor(lens, dtype=torch.int32)]


def _verify_case(offset, seed=1):
    """The verify step's K2 call (`q_per_slot` = spec_k + 1 = 5) at the
    serve config: 8 slot-major blocks of 5 rows, T = 40; slot s's frontier
    at the serve phase's prompt length + 16, width 4 (rows j = 0..4 at
    kv_len pos0 + j + 1), except slot 2 (dead: every row 0) and slot 5
    (narrow: width 1, rows 2..4 at 0). With `offset`, every nonzero
    kv_len is stored `offset` lower, as a frontier offset expects."""
    g = torch.Generator().manual_seed(seed)
    H, D, P, MP, S, QB = 12, 64, 16, 64, VERIFY_SLOTS, VERIFY_QB
    N = S * MP + 1
    lens = []
    for s, n in enumerate(SERVE_PROMPT_LENS):
        width = -1 if s == 2 else 1 if s == 5 else QB - 1
        pos0 = n + 16
        lens += [max(pos0 + j + 1 - offset, 1) if j <= width else 0
                 for j in range(QB)]
    perm = torch.randperm(N - 1, generator=g) + 1
    pt = perm.reshape(S, MP).to(torch.int32)
    kp, vp = _pools(N, P, H, D, g)
    q = torch.randn((S * QB, H, D), generator=g)
    sid = torch.arange(S, dtype=torch.int32).repeat_interleave(QB)
    return [q, kp, vp, pt, sid, torch.tensor(lens, dtype=torch.int32)]


def _pool(case, kind, q_dtype):
    """A f32 case → (args on the card, scale kwargs): q in `q_dtype`,
    pools cast to a float kind, or quantized by the port's codec (int8,
    or packed int4 [N, P, H, D/2]) with their [N, P, H] scale planes."""
    from paddle_tpu_torch.quantization import runtime as qrt

    dev = torch.device("cuda")
    q, kp, vp, pt, sid, lens = (a.to(dev) for a in case)
    kw = {}
    if kind in ("int8", "int4"):
        quant = (qrt.quantize_kv_rows_int4 if kind == "int4"
                 else qrt.quantize_kv_rows)
        N, P, H, D = kp.shape
        (kp, ks), (vp, vs) = (quant(x.reshape(N * P, H, D)) for x in (kp, vp))
        kp, vp = (x.reshape(N, P, H, -1).contiguous() for x in (kp, vp))
        kw = dict(k_scales=ks.reshape(N, P, H).contiguous(),
                  v_scales=vs.reshape(N, P, H).contiguous())
    else:
        kp, vp = kp.to(getattr(torch, kind)), vp.to(getattr(torch, kind))
    return [q.to(q_dtype), kp, vp, pt, sid, lens], kw


def _bound(args, kw, offset):
    """Least time for the work of one call: bytes (each input read once —
    a slot's K/V rows up to its longest row's length, as codes plus their
    scales for a quantized pool — and the output written once) over HBM
    bandwidth, and the q·k + p·v flops over the peak rate for q's type;
    the larger of the two."""
    q, kp, _, pt, sid, lens = args
    T, H, D = q.shape
    eff = torch.where(lens > 0, lens + offset, 0).long().cpu()
    per_slot = {}
    for s, k in zip(sid.cpu().tolist(), eff.tolist()):
        per_slot[s] = max(per_slot.get(s, 0), k)
    kv_rows = sum(per_slot.values())
    row_bytes = kp.shape[-1] * kp.element_size() + (4 if kw else 0)
    nbytes = (2 * kv_rows * H * row_bytes
              + 2 * q.numel() * q.element_size()
              + (pt.numel() + sid.numel() + lens.numel()) * 4)
    flops = 4 * int(eff.sum()) * H * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class _cuda_cores:
    """Within the block every call takes the CUDA-core `rpa_kernel` /
    `rpa_qblock_kernel` (`paged_route` forced off): the kernels the
    tensor-core route replaced, timed beside it on the same inputs."""

    def __init__(self, pa):
        self.pa = pa

    def __enter__(self):
        self.route = self.pa.paged_route
        self.pa.paged_route = lambda *args: False

    def __exit__(self, *exc):
        self.pa.paged_route = self.route


def _host_us(fn, n=400):
    """Host microseconds per call over `n` calls back to back (the card
    runs behind; synchronized before and after, outside the window)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def _timed(pa, args, kw, flush, qb, kind):
    """Kernel, plain and bound times of one call; for a call on the
    tensor-core route also the CUDA-core kernel's time on the same inputs
    (`old_ms`) and the host microseconds per call of both."""
    def call():
        return pa.ragged_paged_attention(*args, **kw, q_per_slot=qb)

    ms = _median_ms(call, flush)
    plain_ms = _median_ms(lambda: pa.ragged_paged_attention_plain(
        *args, **kw, q_per_slot=qb), flush)
    bound_ms, bound_by = _bound(args, kw, 0)
    r = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    q = args[0]
    if pa.paged_route(ROUTE_KIND[kind], q.dtype, q.shape[-1]):
        r["host_us"] = _host_us(call)
        with _cuda_cores(pa):
            r["old_ms"] = _median_ms(call, flush)
            r["old_host_us"] = _host_us(call)
    return r


def _pa_gate(label, out, ref, tol, lens, equal=False):
    """(max abs err, worst row err / row max-abs, share of the live rows'
    elements bit-equal) of kernel `out` against plain `ref`; raises when
    the row gate (`tol`) fails, with `equal` when under QUANT_BF16_EQUAL
    of the elements are bit-equal, on non-finite output or when a kv_len
    0 row is not exact zeros."""
    if not torch.isfinite(out).all():
        raise AssertionError(f"{label}: non-finite kernel output")
    if not torch.all(out[lens == 0] == 0):
        raise AssertionError(f"{label}: kv_len 0 rows are not exact zeros")
    a, b = out.float(), ref.float()
    diff = (a - b).abs()
    rows = torch.clamp(b.abs().amax(-1),
                       min=PA_ROW_FLOOR * b.abs().max().item() + 1e-30)
    row_rel = (diff.amax(-1) / rows).max().item()
    if not row_rel <= tol:
        raise AssertionError(f"{label}: worst row err {row_rel:.3e} of its "
                             f"max-abs > {tol:.0e}")
    live = lens > 0
    share = (out[live] == ref[live]).float().mean().item()
    if equal and not share >= QUANT_BF16_EQUAL:
        raise AssertionError(f"{label}: {share:.4f} of the live elements "
                             f"bit-equal to the plain version's < "
                             f"{QUANT_BF16_EQUAL}")
    return diff.max().item(), row_rel, share


def _quant_tc(kind, q_dtype):
    """True for a bf16 q on an int8 / int4 pool: the tensor-core route's
    quantized arithmetic, held to QUANT_BF16_EQUAL."""
    return kind in ("int8", "int4") and q_dtype == torch.bfloat16


def _pa_tol(kind, q_dtype):
    """PA_TOL by the call's arithmetic: bf16's where q or the pool is bf16
    (the output, or p before P·V, is rounded to bf16 — in other places in
    the kernel and the plain version), f32's otherwise (a quantized pool
    dequantizes to f32)."""
    bf16 = torch.bfloat16 in (q_dtype, getattr(torch, kind, None))
    return PA_TOL[torch.bfloat16 if bf16 else torch.float32]


def _serving_q(kind):
    return torch.float32 if kind == "float32" else torch.bfloat16


# PA_KINDS as `paged_route` names them
ROUTE_KIND = {"float32": "f32", "bfloat16": "bf16", "int8": "int8",
              "int4": "int4"}


def _pa_call(pa, args, kw, offset, qb, kind, label):
    """One K1 / K2 call on a `kind` pool; raises unless it launched once
    and took the route `paged_route` names (a bf16 q on a bf16, int8 or
    int4 pool at head_dim 64 / 128: the tensor-core route, counted in
    `tc_launches` under the call's key; otherwise no tensor-core count
    moves)."""
    q = args[0]
    key = pa._launch_key(kind if kind in ("int8", "int4") else "", qb)
    tc = pa.paged_route(ROUTE_KIND[kind], q.dtype, q.shape[-1])
    before, tc_before = dict(pa.launches), dict(pa.tc_launches)
    out = pa.ragged_paged_attention(*args, **kw, frontier_offset=offset,
                                    q_per_slot=qb)
    moved = {k: n - before[k] for k, n in pa.launches.items()
             if n != before[k]}
    tc_moved = {k: n - tc_before[k] for k, n in pa.tc_launches.items()
                if n != tc_before[k]}
    if moved != {key: 1} or tc_moved != ({key: 1} if tc else {}):
        raise AssertionError(f"{label}: launches {moved}, tensor-core "
                             f"{tc_moved}; expected {{{key!r}: 1}}, "
                             f"tensor-core {'the same' if tc else 'none'}")
    return out


def _tc_layouts():
    """Row layouts that break K1's tensor-core route (64-row chunks of
    one slot, split-KV of 128 keys at MP·P = 1024): (name, rows as (slot,
    effective kv_len), page size, pages per sequence, head_dim). Padding
    rows are (0, 0)."""
    g = np.random.default_rng(5)
    T = SERVE_CFG["token_budget"]

    def pad(rows):
        return rows + [(0, 0)] * (T - len(rows))

    # a decode tick with kv_len at split boundaries (128, 256), one past
    # and one short of one, 1 and the full 1024
    edges = pad(list(enumerate((128, 256, 1, 1024, 129, 127, 640, 1023))))
    # one chunk whose rows end in different splits (some of a row's
    # splits empty) and a padding row inside a live chunk
    ragged = pad([(3, n) for n in (1000, 5, 300, 129, 1, 0, 700, 128)]
                 + [(0, 64), (6, 65)])
    # the 64-row tile [0, 64) holds the tail of slot 2's chunk and the
    # head of slot 5's; tiles past row 131 are padding only
    straddle = pad([(2, 500 + i) for i in range(40)]
                   + [(5, 1 + i) for i in range(61)]
                   + [(7, 990 + i) for i in range(30)])
    # slots in any order, a slot's rows apart, padding rows between
    anyorder = [(int(s), int(n) if g.random() > 0.15 else 0) for s, n in
                zip(g.integers(0, 8, 200), g.integers(1, 1025, 200))]
    # 1300 rows: the plan kernel's second round of 1024 rows; page 5 (41
    # pages, 205 keys: 4 splits of 64, tiles across pages); lengths up to
    # the last key, past it at offset 3 (clamped to the table's keys)
    long = [(s, 45 + i) for s in range(8) for i in range(160)] + [(0, 0)] * 20
    return [("split edges", edges, 16, 64, 64),
            ("ragged chunk", ragged, 16, 64, 64),
            ("two slots in a tile", straddle, 16, 64, 64),
            ("any order", anyorder, 16, 64, 64),
            ("any order, page 64, head_dim 128", anyorder, 64, 16, 128),
            ("1300 rows, page 5", long, 5, 41, 64)]


def _layout_case(rows, P, MP, D, offset, seed=2):
    """A f32 K1 call (H 12, 8 slots, shuffled page ids) on `rows`; a live
    row's kv_len is stored `offset` lower, as a frontier offset expects."""
    g = torch.Generator().manual_seed(seed)
    H, S = 12, 8
    N = S * MP + 1
    perm = torch.randperm(N - 1, generator=g) + 1
    kp, vp = _pools(N, P, H, D, g)
    q = torch.randn((len(rows), H, D), generator=g)
    lens = [max(n - offset, 1) if n else 0 for _, n in rows]
    return [q, kp, vp, perm.reshape(S, MP).to(torch.int32),
            torch.tensor([s for s, _ in rows], dtype=torch.int32),
            torch.tensor(lens, dtype=torch.int32)]


TC_POOLS = ("bfloat16", "int8", "int4")   # pools of the tensor-core route


def _check_layouts(pa, layouts, qb_of):
    """Each layout at frontier offset 0 and 3 on every pool of the
    tensor-core route (bf16 q), against the plain version on the card."""
    for name, rows, P, MP, D in layouts:
        qb = qb_of(name)
        cases = {off: _layout_case(rows, P, MP, D, off) for off in (0, 3)}
        for kind in TC_POOLS:
            worst, worst_rel, least = 0.0, 0.0, 1.0
            equal = _quant_tc(kind, torch.bfloat16)
            for offset, case in cases.items():
                label = (f"{'qblock' if qb else 'rpa'} {kind} pool, {name}, "
                         f"offset {offset}")
                args, kw = _pool(case, kind, torch.bfloat16)
                out = _pa_call(pa, args, kw, offset, qb, kind, label)
                ref = pa.ragged_paged_attention_plain(
                    *args, **kw, frontier_offset=offset, q_per_slot=qb)
                torch.cuda.synchronize()
                err, rel, share = _pa_gate(label, out, ref,
                                           PA_TOL[torch.bfloat16], args[5],
                                           equal)
                worst, worst_rel = max(worst, err), max(worst_rel, rel)
                least = min(least, share)
            print(f"{'K2' if qb else 'K1'} {kind} pool (tensor cores), {name} "
                  f"(T {len(rows)}, page {P}, head_dim {D}), offset 0 and 3: "
                  f"max_abs_err {worst:.3e}, worst row {worst_rel:.2e} of its "
                  f"max-abs (tol {PA_TOL[torch.bfloat16]:.0e}); "
                  f"{least:.4f} of the elements bit-equal"
                  + (f" (gate {QUANT_BF16_EQUAL})" if equal else ""))


def check_paged_tc_layouts(pa):
    """K1's tensor-core route (bf16 q; bf16, int8 and int4 pools) on
    `_tc_layouts`, at frontier offset 0 and 3, against the plain version
    on the card."""
    _check_layouts(pa, _tc_layouts(), lambda name: None)


def _qblock_layouts():
    """Verify layouts that break K2's tensor-core route (blocks of qb rows
    of one slot, split-KV of 128 keys at MP·P = 1024): (name, rows as
    (slot, effective kv_len) in slot-major blocks, page size, pages per
    sequence, head_dim); the name starts with qb. Row j of a block at
    pos0 has kv_len pos0 + j + 1 up to the block's width, 0 past it."""
    def block(slot, pos0, qb, width):
        return [(slot, pos0 + j + 1 if j <= width else 0) for j in range(qb)]

    # one row per slot: split boundaries (128, 256), one past, 1, the
    # full 1024, a padding row
    qb1 = list(enumerate((128, 129, 1, 1024, 0, 256, 640, 33)))
    # 16 rows: full blocks across split edges (121..136, 251..266), the
    # last split (1008..1023), a dead block, a narrow block (width 2)
    qb16 = (block(0, 100, 16, 15) + block(1, 1007, 16, 15)
            + block(2, 0, 16, -1) + block(3, 500, 16, 2)
            + block(4, 120, 16, 15) + block(5, 7, 16, 15)
            + block(6, 250, 16, 15) + block(7, 60, 16, 15))
    # 5 rows: a block whose rows end in different splits (126..130: 128
    # and 129), another across 256, the last key (1020..1024), a dead
    # block, a narrow block (width 1)
    qb5 = (block(0, 125, 5, 4) + block(1, 253, 5, 4) + block(2, 0, 5, -1)
           + block(3, 1019, 5, 4) + block(4, 40, 5, 1) + block(5, 0, 5, 4)
           + block(6, 639, 5, 4) + block(7, 383, 5, 4))
    return [("qb 1, split edges", qb1, 16, 64, 64),
            ("qb 16, split edges, dead and narrow blocks", qb16, 16, 64, 64),
            ("qb 5, rows ending in different splits, dead and narrow "
             "blocks", qb5, 16, 64, 64),
            ("qb 5, page 64, head_dim 128", qb5, 64, 16, 128)]


def check_qblock_tc_layouts(pa):
    """K2's tensor-core route (bf16 q; bf16, int8 and int4 pools) on
    `_qblock_layouts`, at frontier offset 0 and 3, against the plain
    version on the card."""
    _check_layouts(pa, _qblock_layouts(),
                   lambda name: int(name.split(",")[0].split()[1]))


def paged_launch_smem(pa):
    """Prints the shared memory per block (static + dynamic) of each paged
    tensor-core kernel at head_dim 64 and 128 on every pool kind, as the
    profiler records its launch: one K1 and one K2 (qb 5) call each on a
    verify layout. The route sizes its dynamic shared memory at launch, so
    the ptxas log shows none of it."""
    from torch.profiler import ProfilerActivity, profile

    rows = _qblock_layouts()[2][1]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for P, MP, D in ((16, 64, 64), (64, 16, 128)):
            case = _layout_case(rows, P, MP, D, 0)
            for kind in TC_POOLS:
                args, kw = _pool(case, kind, torch.bfloat16)
                for qb in (None, 5):
                    pa.ragged_paged_attention(*args, **kw, q_per_slot=qb)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    smem = {}
    for e in events:
        m = re.search(r"(rpa_tc_(?:qblock_)?kernel)<(\d+), (\d+)>",
                      e.get("name", ""))
        if m and e.get("cat") == "kernel":
            smem[f"{m[1]}<{m[2]}, {m[3]}>"] = e.get("args", {}).get(
                "shared memory", "not recorded")
    for label in sorted(smem):
        print(f"build {label}: {smem[label]} B shared memory per block "
              "(static + dynamic, the profiler's record of its launch)")


def check_paged_attention(pa, flush):
    """K1 on every pool kind at a mixed prefill + decode tick (frontier
    offset 0 and 3) and a pure decode tick, and K2 on every pool kind at
    the verify step (offset 0 and 3), each with an f32 and a bf16 q,
    against the plain version on the card and on the route `paged_route`
    names. Times each at the serving q type (bf16; f32 for the f32 pool)
    — K1 at both ticks, K2 at offset 0 — and, on the tensor-core route,
    the CUDA-core kernel it replaced and the host time per call of both.
    Returns {(kernel, kind): numbers} with K1's mixed tick."""
    res = {}
    for kernel, qb in (("rpa", None), ("qblock", VERIFY_QB)):
        cases = (((0, False), (3, False), (0, True)) if qb is None
                 else ((0, None), (3, None)))
        for kind in PA_KINDS:
            worst, worst_rel, least = 0.0, 0.0, 1.0
            for q_dtype in PA_Q_DTYPES:
                for offset, decode in cases:
                    case = (_paged_case(offset, decode) if qb is None
                            else _verify_case(offset))
                    args, kw = _pool(case, kind, q_dtype)
                    label = (f"{kernel} {kind} pool, q {str(q_dtype)[6:]}, "
                             f"offset {offset}")
                    out = _pa_call(pa, args, kw, offset, qb, kind, label)
                    ref = pa.ragged_paged_attention_plain(
                        *args, **kw, frontier_offset=offset, q_per_slot=qb)
                    torch.cuda.synchronize()
                    equal = _quant_tc(kind, q_dtype)
                    err, rel, share = _pa_gate(label, out, ref,
                                               _pa_tol(kind, q_dtype),
                                               args[5], equal)
                    worst, worst_rel = max(worst, err), max(worst_rel, rel)
                    if equal:
                        least = min(least, share)
            q_t = _serving_q(kind)
            ticks = (False, True) if qb is None else (None,)
            for decode in ticks:
                case = _paged_case(0, decode) if qb is None else \
                    _verify_case(0)
                r = _timed(pa, *_pool(case, kind, q_t), flush, qb, kind)
                tick = ("verify step" if qb else
                        "decode tick" if decode else "mixed tick")
                route = ""
                if "old_ms" in r:
                    route = (f"; tensor-core route, CUDA-core kernel "
                             f"{r['old_ms']:.4f} ms on the same inputs "
                             f"({r['old_ms'] / r['ms']:.2f}x); host "
                             f"{r['host_us']:.1f} µs per call (CUDA-core "
                             f"{r['old_host_us']:.1f})")
                equal = (f"; q bfloat16 {least:.4f} of the elements "
                         f"bit-equal (gate {QUANT_BF16_EQUAL})"
                         if _quant_tc(kind, torch.bfloat16) else "")
                print(f"{kernel} {kind} pool {tick}: max_abs_err {worst:.3e}, "
                      f"worst row {worst_rel:.2e} of its max-abs (tol "
                      + ", ".join(f"q {str(d)[6:]} {_pa_tol(kind, d):.0e}"
                                  for d in PA_Q_DTYPES)
                      + f"{equal}); q {str(q_t)[6:]}: kernel "
                      f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                      f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
                      f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound{route}")
                if not decode:
                    res[(kernel, kind)] = dict(max_abs_err=worst, **r)
    return res


# ------------------------------------------------------- the int8 GEMM

# gpt_small's four linears, (in, out): qkv, proj, fc1, fc2
GEMM_SHAPES = ((768, 2304), (768, 768), (768, 3072), (3072, 768))
# rows: the decode tick (8 slots), an odd count, the mixed tick (budget)
GEMM_ROWS = (8, 13, 256)
GEMM_TIMED_ROWS = (8, 256)
GEMM_WIDTHS = {"w8a8": False, "w4a8": True}    # launch key -> int4


def _gemm_weight(K, N, int4, seed):
    """A per-out-channel quantized weight [K, N] from N(0, 0.02) values
    (absmax scales; the MSE search is the codec's, tested on CPU): the
    int8 codes (or packed int4), the f32 steps [1, N], and the bf16
    weight of the float layer; on the card."""
    from paddle_tpu_torch.quantization import runtime as qrt

    g = torch.Generator().manual_seed(seed)
    w = torch.randn((K, N), generator=g) * 0.02
    qmax = qrt.QMAX4 if int4 else qrt.QMAX
    scale = w.abs().amax(0, keepdim=True).clamp(min=1e-8)
    q = torch.clamp(torch.round(w / scale * qmax), -qmax, qmax).to(torch.int8)
    wq = qrt.pack_int4(q, axis=0) if int4 else q
    dev = torch.device("cuda")
    return (wq.contiguous().to(dev), (scale / qmax).to(dev),
            w.to(torch.bfloat16).to(dev), q.to(dev))


def _gemm_x(T, K, dtype, seed):
    """x [T, K] on the card; row 3 is all zeros (a zero row's step is the
    floor 1e-8 / 127 and its codes 0)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((T, K), generator=g) * 2
    x[3] = 0
    return x.to(dtype).to("cuda")


def _ulps(a, b):
    """Max |a - b| in units of the last place of b's dtype at b."""
    mant = 7 if b.dtype == torch.bfloat16 else 23
    e = torch.frexp(b.float().abs().clamp(min=1e-30)).exponent
    ulp = torch.ldexp(torch.ones_like(b, dtype=torch.float32),
                      (e - 1 - mant).to(torch.float32))
    return ((a.float() - b.float()).abs() / ulp).max().item()


def _gemm_bound(T, K, N, int4, x_dtype):
    """Least time: the weight bytes (half for packed int4) and steps, x,
    the bias and the output once each over HBM bandwidth, or the 2·T·K·N
    int8 operations over the dense int8 peak; the larger."""
    xs = torch.empty((), dtype=x_dtype).element_size()
    nbytes = (K * N // (2 if int4 else 1) + 4 * N + T * K * xs + N * xs
              + T * N * xs)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * T * K * N / PEAK_INT8_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_int8_gemm(ig, flush):
    """The int8 GEMM (`int8_gemm.w8a8_linear`) against its plain version on
    the card at gpt_small's four linear shapes x T 8, 13 and 256, int8 and
    packed-int4 weights, bf16 and f32 x, with a bias and a zero row: the
    activation codes, the steps and the int32 accumulators equal, the
    outputs within 1 ulp of x's dtype. Times at T 8 and 256 with bf16 x
    (the serving type): kernel, plain, bound, `torch._int_mm` on the same
    codes where its shape rules allow (T > 16), and the float layer's bf16
    `torch.addmm`. Returns {(key, T): numbers summed over the four
    shapes} (one decoder layer's linears), each with its per-shape
    numbers."""
    res = {}
    for key, int4 in GEMM_WIDTHS.items():
        for si, (K, N) in enumerate(GEMM_SHAPES):
            wq, ws, wb, q = _gemm_weight(K, N, int4, seed=si)
            worst, worst_abs = 0.0, 0.0
            for T in GEMM_ROWS:
                for dt in (torch.bfloat16, torch.float32):
                    x = _gemm_x(T, K, dt, seed=T)
                    bias = (torch.randn((N,), device="cuda") * 0.1).to(dt)
                    before = dict(ig.launches)
                    out, codes, steps, acc = ig.w8a8_linear(
                        x, wq, ws, bias, int4, return_parts=True)
                    moved = {k: n - before[k] for k, n in ig.launches.items()
                             if n != before[k]}
                    ref, rcodes, rsteps, racc = ig.w8a8_linear_plain(
                        x, wq, ws, bias, int4, return_parts=True)
                    torch.cuda.synchronize()
                    label = f"{key} [{T}, {K}] x [{K}, {N}] {str(dt)[6:]}"
                    ulps = _ulps(out, ref)
                    if not (moved == {key: 1} and torch.equal(codes, rcodes)
                            and torch.equal(steps, rsteps)
                            and torch.equal(acc, racc) and ulps <= 1
                            and torch.isfinite(out).all()):
                        raise AssertionError(
                            f"{label}: launches {moved}, codes equal "
                            f"{torch.equal(codes, rcodes)}, steps equal "
                            f"{torch.equal(steps, rsteps)}, accumulators "
                            f"equal {torch.equal(acc, racc)}, output off "
                            f"by {ulps} ulp")
                    worst = max(worst, ulps)
                    worst_abs = max(worst_abs, (out.float() - ref.float())
                                    .abs().max().item())
            for T in GEMM_TIMED_ROWS:
                x = _gemm_x(T, K, torch.bfloat16, seed=T)
                bias = torch.zeros((N,), dtype=torch.bfloat16, device="cuda")
                codes = ig.quantize_rows_plain(x)[0]
                ms = _median_ms(lambda: ig.w8a8_linear(x, wq, ws, bias,
                                                       int4), flush)
                plain_ms = _median_ms(lambda: ig.w8a8_linear_plain(
                    x, wq, ws, bias, int4), flush)
                lib_ms = (_median_ms(lambda: torch._int_mm(codes, q), flush)
                          if T > 16 else None)
                bf16_ms = _median_ms(lambda: torch.addmm(bias, x, wb), flush)
                bound_ms, bound_by = _gemm_bound(T, K, N, int4, x.dtype)
                r = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bf16_ms=bf16_ms, bound_ms=bound_ms,
                         bound_by=bound_by, max_abs_err=worst_abs)
                print(f"int8 GEMM {key} [{T}, {K}] x [{K}, {N}]: codes, "
                      f"steps and int32 accumulators equal to the plain "
                      f"version's, output within {worst:g} ulp (T 8, 13, "
                      f"256; bf16 and f32 x); bf16 x: kernel {ms:.4f} ms, "
                      f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                      f"({bound_by}), {100 * bound_ms / ms:.1f}% of bound, "
                      f"torch._int_mm "
                      + (f"{lib_ms:.4f} ms" if lib_ms is not None else
                         "n/a (needs more than 16 rows)")
                      + f", bf16 addmm of the float layer {bf16_ms:.4f} ms")
                agg = res.setdefault((key, T), dict(
                    ms=0.0, plain_ms=0.0, library_ms=0.0 if T > 16 else None,
                    bf16_ms=0.0, bound_ms=0.0, bound_by=bound_by,
                    max_abs_err=0.0, shapes={}))
                for f in ("ms", "plain_ms", "bf16_ms", "bound_ms"):
                    agg[f] += r[f]
                agg["max_abs_err"] = max(agg["max_abs_err"], worst_abs)
                if lib_ms is not None:
                    agg["library_ms"] += lib_ms
                agg["shapes"][f"{K}x{N}"] = r
    for (key, T), r in res.items():
        print(f"int8 GEMM {key}, one layer's four linears at T {T}: kernel "
              f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bf16 addmm {r['bf16_ms']:.4f} ms"
              + (f", torch._int_mm {r['library_ms']:.4f} ms"
                 if r["library_ms"] is not None else ""))
    return res


# ---------------------------------------------------------------- K3-K5

# the training path's attention call: gpt_small at b16·s1024 → b·h 192
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 16, 1024, 10
FA_MAIN = dict(bh=TRAIN_BATCH * 12, s=TRAIN_SEQ, d=64,
               dtype=torch.bfloat16, causal=True, lens=None)
# smaller cases: f32, ragged seq (not a multiple of the 64-row tile),
# non-causal, kv_lens with a 0 row, seq_k != seq_q (`sk`), and the 32-
# and 16-row tile configs (head_dim 96, 256); bf16 ones on the edges of
# the tensor-core route (head_dim 64 / 128) and one bf16 case off it
# (head_dim 32)
FA_CASES = [
    FA_MAIN,
    dict(bh=6, s=200, d=64, dtype=torch.float32, causal=True, lens=None),
    dict(bh=6, s=200, d=64, dtype=torch.float32, causal=False,
         lens=[200, 0, 57, 64, 1, 130]),
    dict(bh=6, s=200, d=64, dtype=torch.bfloat16, causal=True,
         lens=[200, 0, 57, 64, 1, 130]),
    dict(bh=4, s=130, d=96, dtype=torch.float32, causal=True, lens=None),
    dict(bh=4, s=70, d=256, dtype=torch.float32, causal=False,
         lens=[70, 33, 0, 16]),
    dict(bh=4, s=77, d=8, dtype=torch.float32, causal=True, lens=None),
    dict(bh=4, s=50, sk=130, d=32, dtype=torch.float32, causal=False,
         lens=[130, 0, 77, 5]),
    dict(bh=6, s=200, d=64, dtype=torch.bfloat16, causal=False, lens=None),
    dict(bh=6, s=200, d=64, dtype=torch.bfloat16, causal=False,
         lens=[200, 0, 57, 64, 1, 130]),
    dict(bh=4, s=50, sk=130, d=64, dtype=torch.bfloat16, causal=False,
         lens=[130, 0, 77, 5]),
    dict(bh=4, s=384, d=128, dtype=torch.bfloat16, causal=True, lens=None),
    dict(bh=4, s=200, d=128, dtype=torch.bfloat16, causal=False,
         lens=[200, 0, 57, 130]),
    dict(bh=4, s=77, d=32, dtype=torch.bfloat16, causal=True, lens=None),
]
# out / dq / dk / dv: each row's max error within FA_TOL of that row's
# max-abs (floored at FA_ROW_FLOOR of the tensor's max-abs, so rows of
# pure cancellation noise do not divide by ~0), and the mean error within
# FA_MEAN_TOL of the mean value; lse (f32 in both types) absolute
FA_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
FA_MEAN_TOL = {torch.float32: 1e-5, torch.bfloat16: 4e-3}
FA_LSE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
FA_ROW_FLOOR = 1e-2


def _fa_inputs(case, seed=0):
    g = torch.Generator().manual_seed(seed)
    bh, s, d = case["bh"], case["s"], case["d"]
    sk = case.get("sk", s)
    q, k, v, dout = (torch.randn(shape, generator=g).to(case["dtype"])
                     for shape in ((bh, s, d), (bh, sk, d), (bh, sk, d),
                                   (bh, s, d)))
    dev = torch.device("cuda")
    lens = case["lens"]
    if lens is not None:
        lens = torch.tensor(lens, dtype=torch.int32)
    return ([x.to(dev) for x in (q, k, v, dout)],
            None if lens is None else lens.to(dev))


def _fa_pairs(case):
    """(row, key) pairs that attend: the work of these inputs."""
    s = case["s"]
    kl = torch.full((case["bh"],), s) if case["lens"] is None else \
        torch.tensor(case["lens"]).clamp(max=s)
    rows = torch.arange(s)
    per_row = torch.minimum(kl[:, None], rows[None, :] + 1) \
        if case["causal"] else kl[:, None].expand(-1, s)
    return int(per_row.clamp(min=0).sum())


def _fa_bound(name, case):
    """Least time for one call: each input read once and each output
    written once over HBM bandwidth, and the matmul flops of the
    attending pairs (2·d per pair per product: q·k and p·v forward; q·k,
    g·v and ds·k for dq; q·k, g·v, pᵀ·g and dsᵀ·q for dk/dv) over the
    peak rate of the input type; the larger of the two."""
    bh, s, d, dt = case["bh"], case["s"], case["d"], case["dtype"]
    item = torch.tensor([], dtype=dt).element_size()
    tile = bh * s * d * item              # one [bh, s, d] operand
    rows = bh * s * 4                     # one f32 [bh, s] row vector
    lens = 0 if case["lens"] is None else bh * 4
    nbytes, products = {
        "flash_forward": (3 * tile + lens + tile + rows, 2),
        "flash_bwd_dq": (4 * tile + 2 * rows + lens + tile, 3),
        "flash_bwd_dkv": (4 * tile + 2 * rows + lens + 2 * tile, 4),
    }[name]
    flops = products * 2 * d * _fa_pairs(case)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dt] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _fa_run(fa, x, lens, causal, plain):
    """K3 → delta → K4, K5 (or their plain versions)."""
    q, k, v, dout = x
    fwd, dq_fn, dkv_fn = (
        (fa.flash_forward_plain, fa.flash_bwd_dq_plain,
         fa.flash_bwd_dkv_plain) if plain else
        (fa.flash_forward, fa.flash_bwd_dq, fa.flash_bwd_dkv))
    out, lse = fwd(q, k, v, causal, lens)
    delta = (dout.float() * out.float()).sum(-1)[:, None, :].contiguous()
    dq = dq_fn(q, k, v, dout, lse, delta, causal, lens)
    dk, dv = dkv_fn(q, k, v, dout, lse, delta, causal, lens)
    return dict(out=out, lse=lse, dq=dq, dk=dk, dv=dv), delta


def _fa_library_ms(x, flush):
    """torch's own fused attention on the same inputs ([b, h, s, d]): its
    causal forward, and its backward (dq, dk, dv in one call) as the
    autograd node that forward recorded, called directly — whichever
    backend SDPA picked, and without the autograd engine's host time in
    the timed window."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, h = TRAIN_BATCH, FA_MAIN["bh"] // TRAIN_BATCH
    q, k, v, dout = (t.reshape(b, h, *t.shape[1:]) for t in x)
    fwd_ms = _median_ms(lambda: sdpa(q, k, v, is_causal=True), flush)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    node = sdpa(qg, kg, vg, is_causal=True).grad_fn
    bwd_ms = _median_ms(lambda: node(dout), flush)
    return fwd_ms, bwd_ms


def _fa_gate(label, key, a, b, dt):
    """(max abs err, worst row err / row max-abs, mean err / mean value)
    of kernel `a` against plain `b` for output `key` (lse: the last two
    are its max abs err); raises when a gate of the FA_* tolerances
    fails."""
    a, b = a.float(), b.float()
    if not torch.isfinite(a).all():
        raise AssertionError(f"flash {label} {key}: non-finite output")
    diff = (a - b).abs()
    if key == "lse":     # rows of length 0 hold -1e30 on both sides
        err = diff.max().item()
        if not err <= FA_LSE_TOL[dt]:
            raise AssertionError(f"flash {label} lse: max abs err "
                                 f"{err:.3e} > {FA_LSE_TOL[dt]:.0e}")
        return err, err, err
    top = b.abs().max().item()
    rows = torch.clamp(b.abs().amax(-1), min=FA_ROW_FLOOR * top + 1e-30)
    row_rel = (diff.amax(-1) / rows).max().item()
    mean_rel = diff.mean().item() / max(b.abs().mean().item(), 1e-30)
    if not (row_rel <= FA_TOL[dt] and mean_rel <= FA_MEAN_TOL[dt]):
        raise AssertionError(
            f"flash {label} {key}: worst row err {row_rel:.3e} of its "
            f"max-abs (tol {FA_TOL[dt]:.0e}), mean err {mean_rel:.3e} of "
            f"the mean value (tol {FA_MEAN_TOL[dt]:.0e})")
    return diff.max().item(), row_rel, mean_rel


def check_flash_attention(fa, flush):
    """K3/K4/K5 against their plain versions on the card for every case
    of FA_CASES: out, dq, dk, dv row by row (FA_TOL of each row's
    max-abs) and on average (FA_MEAN_TOL), lse absolute (FA_LSE_TOL);
    rows with kv_len 0 must be exact zeros. Times the main-path case
    (kernel, plain, library) beside the bound and returns its numbers by
    kernel."""
    res = {}
    for case in FA_CASES:
        x, lens = _fa_inputs(case)
        fa.reset_launches()
        got, _ = _fa_run(fa, x, lens, case["causal"], plain=False)
        tc = fa.tensor_core_route(case["dtype"], case["d"])
        route = dict.fromkeys(fa.REPLACES, int(tc))
        ref, _ = _fa_run(fa, x, lens, case["causal"], plain=True)
        torch.cuda.synchronize()
        label = (f"bh{case['bh']} s{case['s']} sk{case.get('sk', case['s'])}"
                 f" d{case['d']} "
                 f"{str(case['dtype'])[6:]} "
                 f"{'causal' if case['causal'] else 'full'}"
                 f"{' kv_lens' if lens is not None else ''}")
        if fa.tc_launches != route or set(fa.launches.values()) != {1}:
            raise AssertionError(f"flash {label}: launches {fa.launches}, "
                                 f"tensor-core {fa.tc_launches}; expected "
                                 f"one each, tensor-core {route}")
        errs, gates = {}, {}
        for key in got:
            errs[key], *gates[key] = _fa_gate(label, key, got[key],
                                              ref[key], case["dtype"])
        if lens is not None:
            zero = lens == 0
            for key in ("out", "dq", "dk", "dv"):
                if not torch.all(got[key][zero] == 0):
                    raise AssertionError(f"flash {key}: kv_len 0 rows are "
                                         "not exact zeros")
        print(f"flash attention {label} "
              f"({'tensor' if tc else 'CUDA'} cores): max abs err " + ", ".join(
            f"{k} {v:.3e}" for k, v in errs.items())
            + "; worst row / mean err relative " + ", ".join(
                f"{k} {r:.2e} / {m:.2e}" for k, (r, m) in gates.items()
                if k != "lse")
            + f" (tol {FA_TOL[case['dtype']]:.0e} / "
              f"{FA_MEAN_TOL[case['dtype']]:.0e}; lse "
              f"{FA_LSE_TOL[case['dtype']]:.0e} abs)")
        if case is FA_MAIN:
            res = {"flash_forward": dict(max_abs_err=max(errs["out"],
                                                         errs["lse"])),
                   "flash_bwd_dq": dict(max_abs_err=errs["dq"]),
                   "flash_bwd_dkv": dict(max_abs_err=max(errs["dk"],
                                                         errs["dv"]))}
            main = (x, lens)
        del got, ref
    x, lens = main
    q, k, v, dout = x
    causal = FA_MAIN["causal"]
    _, delta = _fa_run(fa, x, lens, causal, plain=True)
    out, lse = fa.flash_forward(q, k, v, causal, lens)
    calls = {
        "flash_forward": (
            lambda: fa.flash_forward(q, k, v, causal, lens),
            lambda: fa.flash_forward_plain(q, k, v, causal, lens)),
        "flash_bwd_dq": (
            lambda: fa.flash_bwd_dq(q, k, v, dout, lse, delta, causal, lens),
            lambda: fa.flash_bwd_dq_plain(q, k, v, dout, lse, delta, causal,
                                          lens)),
        "flash_bwd_dkv": (
            lambda: fa.flash_bwd_dkv(q, k, v, dout, lse, delta, causal,
                                     lens),
            lambda: fa.flash_bwd_dkv_plain(q, k, v, dout, lse, delta, causal,
                                           lens)),
    }
    fwd_lib, bwd_lib = _fa_library_ms(x, flush)
    for name, (kernel, plain) in calls.items():
        r = res[name]
        r["ms"] = _median_ms(kernel, flush)
        r["plain_ms"] = _median_ms(plain, flush, reps=10)
        r["bound_ms"], r["bound_by"] = _fa_bound(name, FA_MAIN)
        r["library_ms"] = fwd_lib if name == "flash_forward" else bwd_lib
        print(f"{name} bf16 b·h {FA_MAIN['bh']} s {FA_MAIN['s']} d "
              f"{FA_MAIN['d']} causal: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms"
              f"{'' if name == 'flash_forward' else ' (dq+dk+dv)'}, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound, "
              f"{r['ms'] / r['library_ms']:.2f}x the library")
    return res


def serve_model():
    """gpt_small with bf16 weights from seed 1234: the model every serve
    phase runs."""
    from paddle_tpu_torch.text.models.gpt import GPTForCausalLM, gpt_small

    return GPTForCausalLM(gpt_small(), dtype="bfloat16", seed=1234)


def serve(pa, model):
    from paddle_tpu_torch.inference import LLMEngineConfig, LLMServer

    cfg = model.config
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
        launches = dict(pa.launches)
        tc_launches = dict(pa.tc_launches)
        ticks = eng.stats["steps"] - ticks0
    _check_outputs(prompts, outs, cfg.vocab_size)
    want = dict.fromkeys(launches, 0)
    want["rpa"] = cfg.num_layers * ticks
    if launches != want or ticks == 0 or tc_launches != want:
        raise AssertionError(
            f"paged attention launched {launches} (tensor-core route "
            f"{tc_launches}) in {ticks} ticks; expected {cfg.num_layers} K1 "
            "(bf16 pool) per tick, all on the tensor-core route")
    ttft = _ttft(futs, t0)
    gen = SERVE_NEW_TOKENS * len(prompts)
    print(f"serve gpt_small bf16: {len(prompts)} requests, "
          f"{sum(SERVE_PROMPT_LENS)} prompt tokens, {gen} generated in "
          f"{wall:.3f} s = {gen / wall:.1f} generated tok/s, {ticks} ticks, "
          f"TTFT median {ttft[len(ttft) // 2]:.3f} s max {ttft[-1]:.3f} s, "
          f"paged attention launches {launches['rpa']} = {cfg.num_layers} x "
          f"{ticks}, all on K1's tensor-core route")
    return launches


# a serve path through the paged kernels vs through their plain version,
# both on the card: the max-abs difference of each emitted token's
# logits row (bf16 logits of a random-init gpt_small, |logit| below 2;
# both runs round attention's output to bf16, in other places)
SERVE_BF16_LOGIT_TOL = 5e-2
_KV_SUFFIX = {"bfloat16": "", "int8": "_int8", "int4": "_int4"}


def _drive(eng, reqs):
    """Step `eng` until it has no work. Per request (by index): its
    emitted tokens' logits rows (f32, CPU) and its chunks — the tokens
    each step emitted for it, as ("tick", 1) or ("window", n). A verify
    window's rows come from the verify step's logits (captured where the
    model hands them to `sample_tokens`), a fused window's from the
    window's logits (`_fused_fn.logits`: one [S, vocab] per iteration,
    rewritten by each replay), a tick's from `last_logits` in plan
    (admission) order. A draft-model window also samples in its propose
    step (num_slots rows a call, when it runs eagerly or is captured);
    the verify's call is the one with num_slots · (k+1) rows."""
    from paddle_tpu_torch.text.models import gpt as gpt_mod

    logits = [[] for _ in reqs]
    chunks = [[] for _ in reqs]
    window = []
    sample = gpt_mod.sample_tokens

    def capture(lv, *args, **kw):
        window.append(lv)
        return sample(lv, *args, **kw)

    Q = eng._spec.k + 1 if eng._spec is not None else 0
    gpt_mod.sample_tokens = capture
    try:
        while eng.has_work():
            before = [len(r.tokens) for r in reqs]
            frontier = {i: eng._slots.index(r) for i, r in enumerate(reqs)
                        if r in eng._slots
                        and r.n_prefilled == len(r.tokens) - 1}
            kinds = (eng.stats["fused_steps"], _spec_windows(eng))
            eng.last_logits = None
            window.clear()
            eng.step()
            grown = [i for i, r in enumerate(reqs)
                     if len(r.tokens) > before[i]]
            ticked = grown
            fused = eng.stats["fused_steps"] > kinds[0]
            if fused or _spec_windows(eng) > kinds[1]:
                # the frontier rows took a window
                ticked = [i for i in grown if i not in frontier]
                for i in grown:
                    if i in frontier:
                        n = len(reqs[i].tokens) - before[i]
                        if fused:
                            s = frontier[i]
                            rows = torch.stack(
                                [lv[s] for lv in eng._fused_fn.logits[:n]])
                        else:
                            row = frontier[i] * Q
                            verify = next(lv for lv in window if
                                          lv.shape[0] == eng.num_slots * Q)
                            rows = verify[row:row + n]
                        logits[i] += list(rows.float().cpu())
                        chunks[i].append(("window", n))
            ticked = sorted(ticked, key=lambda i: reqs[i].admit_seq)
            if ticked:
                lt = eng.last_logits.float().cpu()
                for row, i in enumerate(ticked):
                    logits[i].append(lt[row])
                    chunks[i].append(("tick", 1))
        torch.cuda.synchronize()
    finally:
        gpt_mod.sample_tokens = sample
    return logits, chunks


def _spec_windows(eng):
    """Verify windows an engine ran: n-gram and draft-model ones."""
    return (eng.stats.get("ngram_windows", 0)
            + eng.stats.get("spec_windows", 0))


def _cross_compare(label, kr, pr):
    """Request by request, up to its first differing token, the kernel
    run `kr` against the plain run `pr` (dicts of per-request tokens,
    logits rows and chunks from `_drive`): the chunks that end at or
    before the difference are equal, every emitted token's logits agree
    within SERVE_BF16_LOGIT_TOL (checked by the caller on the returned
    worst), and a differing token lies at a near-tie of the plain run (its
    top two logits within that tolerance). Returns (worst logits max-abs
    difference, rows compared, near-ties)."""
    worst, rows, ties = 0.0, 0, []
    for i in range(len(kr["tokens"])):
        tk, tp = kr["tokens"][i], pr["tokens"][i]
        diff = np.flatnonzero(tk != tp)
        d = int(diff[0]) if diff.size else len(tk)
        # the chunks that end at or before the first difference agree
        ck, n = [], 0
        for c in kr["chunks"][i]:
            if n + c[1] > d:
                break
            ck.append(c)
            n += c[1]
        cp = pr["chunks"][i][:len(ck)]
        if ck != cp:
            raise AssertionError(f"{label}: request {i}'s steps differ "
                                 f"before token {d}: {ck} vs {cp}")
        # logits of every token up to and including the first difference
        # (its context is the same in both runs)
        for j in range(min(d + 1, len(tk))):
            worst = max(worst, (kr["logits"][i][j]
                                - pr["logits"][i][j]).abs().max().item())
            rows += 1
        if d < len(tk):
            top2 = pr["logits"][i][d].topk(2).values
            gap = (top2[0] - top2[1]).item()
            if not gap <= SERVE_BF16_LOGIT_TOL:
                raise AssertionError(
                    f"{label}: request {i} token {d} is {tk[d]} vs the "
                    f"plain run's {tp[d]}, whose top two logits differ by "
                    f"{gap:.3e}")
            ties.append(f"request {i} token {d} (gap {gap:.2e})")
    return worst, rows, ties


def serve_cross(pa, model, kv_dtype, spec, prompts, label):
    """The serve path twice on the card from the same model and prompts
    (`LLMEngine` at the serve config, a `kv_dtype` pool, n-gram
    speculation with spec_k 4 when `spec`, 32 greedy tokens a request):
    through the kernels (every launch on the tensor-core route), and with
    the module's `ragged_paged_attention` swapped for its plain version
    (restored after). Request by request, up to its first differing
    token: the chunks (tick, or a window with its emitted count) are
    equal, and every emitted token's logits agree within
    SERVE_BF16_LOGIT_TOL. A differing token is allowed only where the
    plain run's top two logits lie within that tolerance (a near-tie);
    the request is compared no further."""
    from paddle_tpu_torch.inference import LLMEngine, LLMEngineConfig

    knobs = dict(spec_mode="ngram", spec_k=4) if spec else {}
    kernel = pa.ragged_paged_attention
    runs = []
    for swap in (False, True):
        eng = LLMEngine(model, LLMEngineConfig(kv_dtype=kv_dtype,
                                               **SERVE_CFG, **knobs))
        reqs = [eng.add_request(p, max_new_tokens=SERVE_NEW_TOKENS)
                for p in prompts]
        pa.reset_launches()
        try:
            if swap:
                pa.ragged_paged_attention = pa.ragged_paged_attention_plain
            logits, chunks = _drive(eng, reqs)
        finally:
            pa.ragged_paged_attention = kernel
        windows = eng.stats.get("ngram_windows", 0)
        runs.append(dict(tokens=[r.future.result()[len(p):]
                                 for r, p in zip(reqs, prompts)],
                         logits=logits, chunks=chunks,
                         ticks=eng.stats["steps"] - windows,
                         windows=windows, launches=dict(pa.launches),
                         tc=dict(pa.tc_launches),
                         accepted=eng.stats.get("ngram_accepted", 0)))
    kr, pr = runs
    sfx = _KV_SUFFIX[kv_dtype]
    layers = model.config.num_layers
    want = dict.fromkeys(kr["launches"], 0)
    want["rpa" + sfx] = layers * kr["ticks"]
    want["qblock" + sfx] = layers * kr["windows"]
    if not (kr["launches"] == kr["tc"] == want and kr["ticks"]
            and (kr["windows"] or not spec)
            and set(pr["launches"].values()) == {0}):
        raise AssertionError(
            f"{label}: kernel run {kr['ticks']} ticks + {kr['windows']} "
            f"windows, launches {kr['launches']} (tensor-core {kr['tc']}); "
            f"plain run launches {pr['launches']}")
    worst, rows, ties = _cross_compare(label, kr, pr)
    print(f"serve cross-check {label}, kernels vs plain version on the "
          f"card: {kr['ticks']} ticks + {kr['windows']} windows (plain "
          f"{pr['ticks']} + {pr['windows']}), accepted {kr['accepted']} "
          f"(plain {pr['accepted']}); {rows} emitted rows compared, logits "
          f"max abs diff {worst:.3e} (tol {SERVE_BF16_LOGIT_TOL:.0e}); "
          f"tokens differ at {len(ties)} near-ties"
          f"{': ' + ', '.join(ties) if ties else ''}; kernel run launches "
          f"{ {k: n for k, n in kr['launches'].items() if n} }, all on the "
          "tensor-core route")
    if not worst <= SERVE_BF16_LOGIT_TOL:
        raise AssertionError(f"{label}: the serve path through the kernels "
                             "disagrees with the plain version")


def _check_outputs(prompts, outs, vocab):
    for p, o in zip(prompts, outs):
        if len(o) != len(p) + SERVE_NEW_TOKENS:
            raise AssertionError(f"request returned {len(o)} tokens, "
                                 f"wanted {len(p) + SERVE_NEW_TOKENS}")
        if not (np.array_equal(o[:len(p)], p)
                and ((o >= 0) & (o < vocab)).all()):
            raise AssertionError("request output is not prompt + ids")


def _ttft(futs, t0):
    """TTFT from the submission of the burst to each first token."""
    return sorted(f.pt_request.t_first_token - t0 for f in futs)


def repetitive_prompts(vocab, lens, seed):
    """Each prompt a random 24-token segment repeated to its length: the
    prompt-lookup workload (templated and quoting traffic)."""
    rng = np.random.default_rng(seed)
    return [np.resize(rng.integers(0, vocab, (24,)), n) for n in lens]


def serve_spec(pa, model, kv_dtype):
    """`LLMServer` over the serve model with a `kv_dtype` KV pool and
    n-gram speculation (spec_k 4), at the serve config: 8 greedy requests
    of the serve phase's prompt lengths, repetitive prompts. Every window
    must launch K2 on that pool once per layer and every single tick K1
    once per layer, both at least once and all on the tensor-core route,
    with proposals made."""
    from paddle_tpu_torch.inference import LLMEngineConfig, LLMServer

    cfg = model.config
    prompts = repetitive_prompts(cfg.vocab_size, SERVE_PROMPT_LENS, 4321)
    server = LLMServer(model, LLMEngineConfig(
        kv_dtype=kv_dtype, spec_mode="ngram", spec_k=4, **SERVE_CFG))
    eng = server.engine
    keys = ("steps", "ngram_windows", "ngram_proposed", "ngram_accepted")
    with server:
        # warm-up: a prefill tick and verify windows
        server.generate(prompts[0][:24], max_new_tokens=8)
        torch.cuda.synchronize()
        before = {k: eng.stats[k] for k in keys}
        pa.reset_launches()
        t0 = time.perf_counter()
        futs = [server.submit(p, max_new_tokens=SERVE_NEW_TOKENS)
                for p in prompts]
        outs = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        launches = dict(pa.launches)
        tc_launches = dict(pa.tc_launches)
        d = {k: eng.stats[k] - before[k] for k in keys}
    _check_outputs(prompts, outs, cfg.vocab_size)
    windows = d["ngram_windows"]
    ticks = d["steps"] - windows
    sfx = _KV_SUFFIX[kv_dtype]
    want = dict.fromkeys(launches, 0)
    want["rpa" + sfx] = cfg.num_layers * ticks
    want["qblock" + sfx] = cfg.num_layers * windows
    if (launches != want or tc_launches != want
            or not (ticks and windows and d["ngram_proposed"])):
        raise AssertionError(
            f"{kv_dtype} + ngram serve: launches {launches} (tensor-core "
            f"{tc_launches}) in {ticks} ticks and {windows} windows "
            f"({d['ngram_proposed']} proposed); expected {cfg.num_layers} "
            f"K1 per tick and {cfg.num_layers} K2 per window, both > 0 and "
            "on the tensor-core route, and proposals")
    ttft = _ttft(futs, t0)
    gen = SERVE_NEW_TOKENS * len(prompts)
    print(f"serve gpt_small bf16, {kv_dtype} KV, ngram spec_k 4: "
          f"{len(prompts)} requests, {sum(SERVE_PROMPT_LENS)} prompt tokens, "
          f"{gen} generated in {wall:.3f} s = {gen / wall:.1f} generated "
          f"tok/s, {ticks} ticks + {windows} windows, proposed "
          f"{d['ngram_proposed']} accepted {d['ngram_accepted']}, TTFT "
          f"median {ttft[len(ttft) // 2]:.3f} s max {ttft[-1]:.3f} s, "
          f"launches K1{sfx} {want['rpa' + sfx]} = {cfg.num_layers} x "
          f"{ticks}, K2{sfx} {want['qblock' + sfx]} = {cfg.num_layers} x "
          f"{windows}, all on the tensor-core route")
    return launches


# ---- sampled decode and fused decode ----

# the prng phase's grid of folded keys (seed, stream, position) and width
PRNG_SEEDS = (0, 1, 7, 42, 1234, 2**31 - 1, 2**32 + 5, 2**40 + 3)
PRNG_STREAMS = (0, 1, 2, 3, 7, 100, 65535, 2**31 - 1)
PRNG_POSITIONS = (0, 1, 15, 16, 100, 1023, 4096, 2**31 - 1)
PRNG_WIDTH = 50304
SAMPLE_TEMPS = (0.0, 0.5, 0.8, 1.3)
SAMPLE_TOP_PS = (1.0, 0.9, 0.5)
# card vs CPU picks may differ only where a row's top two scores (the
# Gumbel-perturbed scores of a sampled row, the logits of a greedy one)
# lie within this share of the top score's magnitude: the card's exp,
# sums and logs round differently from the CPU's
SAMPLE_MARGIN = 1e-4
SAMPLED = dict(temperature=0.8, top_p=0.9)
FUSED_KS = (4, 8)


def check_prng(flush):
    """prng phase: jax's threefry bits (`core.prng.random_bits`) on the
    card equal the CPU's as integers, over 8 seeds x 8 streams x 8
    positions of folded keys at the vocab's width; `sample_tokens` on the
    card against the CPU on the same f32 logits [8, 50304] for every
    temperature x top_p of the grid; the sampler's device ms per call.
    Returns that time."""
    from paddle_tpu_torch.core import prng
    from paddle_tpu_torch.profile_serve import sampler_ms
    from paddle_tpu_torch.text.models import gpt as gpt_mod

    keys = torch.stack([prng.prng_key(s) for s in PRNG_SEEDS])
    keys = prng.fold_in(keys[:, None], torch.tensor(PRNG_STREAMS)[None])
    keys = prng.fold_in(keys[:, :, None],
                        torch.tensor(PRNG_POSITIONS)[None, None])
    keys = keys.reshape(-1, 2)
    bad = 0
    for chunk in keys.split(64):
        want = prng.random_bits(chunk, PRNG_WIDTH)
        got = prng.random_bits(chunk.cuda(), PRNG_WIDTH).cpu()
        bad += int((got != want).sum())
    if bad:
        raise AssertionError(f"threefry bits: {bad} of "
                             f"{keys.shape[0] * PRNG_WIDTH} differ between "
                             "card and CPU")
    g = torch.Generator().manual_seed(99)
    logits = torch.randn((8, PRNG_WIDTH), generator=g) * 2.0
    key = prng.prng_key(2024)
    streams = torch.arange(8, dtype=torch.int32) * 13 + 1
    pos = torch.tensor([1, 17, 100, 511, 512, 900, 1023, 2**31 - 2],
                       dtype=torch.int32)
    rows = near = 0
    for t in SAMPLE_TEMPS:
        for p in SAMPLE_TOP_PS:
            args = (logits, torch.full((8,), t), torch.full((8,), p),
                    streams, pos, key)
            want = gpt_mod.sample_tokens(*args)
            got = gpt_mod.sample_tokens(*(x.cuda() for x in args)).cpu()
            scores = (gpt_mod._sampling_scores(*args) if t > 0 else logits)
            top2 = scores.topk(2).values
            margin = (top2[:, 0] - top2[:, 1]) / top2[:, 0].abs()
            clear = margin > SAMPLE_MARGIN
            if not torch.equal(got[clear], want[clear]):
                raise AssertionError(
                    f"sample_tokens t={t} top_p={p}: card {got.tolist()} vs "
                    f"CPU {want.tolist()} (margins {margin.tolist()})")
            rows += 8
            near += int((~clear).sum())
    dev_args = [x.cuda() for x in (logits, torch.full((8,), 0.8),
                                   torch.full((8,), 0.9), streams, pos, key)]
    ms = sampler_ms(8, PRNG_WIDTH)
    host = _host_us(lambda: gpt_mod.sample_tokens(*dev_args), n=50)
    greedy_ms = _median_ms(lambda: gpt_mod.sample_tokens(dev_args[0]), flush)
    print(f"prng: threefry bits card == CPU on {keys.shape[0]} keys x "
          f"{PRNG_WIDTH} (8 seeds x 8 streams x 8 positions); sample_tokens "
          f"card == CPU on {rows - near}/{rows} rows whose top-2 margin "
          f"exceeds {SAMPLE_MARGIN:.0e} of the top score ({near} rows "
          f"within it, not compared); sampler {ms:.4f} ms of device a call on"
          f" [8, {PRNG_WIDTH}] (temperature 0.8, top_p 0.9; replayed from a "
          f"CUDA graph, as a fused window runs it; {host:.1f} µs of host to "
          f"enqueue it eagerly; greedy argmax {greedy_ms:.4f} ms)")
    return ms


def _fused_cfg(kv_dtype, k, **kw):
    from paddle_tpu_torch.inference import LLMEngineConfig

    return LLMEngineConfig(kv_dtype=kv_dtype, decode_k=k, seed=77,
                           **SERVE_CFG, **kw)


def _bytes(t):
    return t.view(torch.uint8)


def _grow_workspace(pa, model, kv, kv_scales, eng, stream):
    """An eager K1 call at 4096 rows on a window's capture stream, against
    `model`'s pools `kv` / `kv_scales`: the stream's tensor-core workspace
    is outgrown and replaced, so a graph that had not kept its own would
    now hold a freed address."""
    H = model.config.num_heads
    D = model.config.hidden_size // H
    q = torch.zeros((4096, H, D), dtype=torch.bfloat16, device="cuda")
    z = torch.zeros((4096,), dtype=torch.int32, device="cuda")
    pt = torch.zeros((eng.num_slots, eng.pages_per_seq), dtype=torch.int32,
                     device="cuda")
    sc = kv_scales or [None, None]
    with torch.cuda.stream(stream):
        pa.ragged_paged_attention(q, kv[0], kv[1], pt, z, z,
                                  k_scales=sc[0], v_scales=sc[1])
    torch.cuda.synchronize()


def _window_vs_eager(eng, fs, structured=False, profiled=False):
    """Step `eng` until its next fused window (with `structured`, its next
    window whose rows include a constrained one): the window runs eagerly
    on copies of the pools and scale planes from the same staged inputs,
    then as the graph replay (under the profiler with `profiled`). Returns
    the eager and replayed emits, whether every pool byte is equal, and
    the profile."""
    from torch.profiler import ProfilerActivity, profile

    run, seen = fs.run, {}

    def gated(kv, kv_scales, smp, tables=None):
        if seen or structured and tables is None:
            return run(kv, kv_scales, smp, tables)
        fs._static.copy_(fs._host)
        kv_c = [p.clone() for p in kv]
        sc_c = [p.clone() for p in kv_scales or []]
        seen["eager"] = fs.eager(kv_c, sc_c or None, smp,
                                 tables).cpu().numpy()
        with (profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) if profiled
              else contextlib.nullcontext()) as prof:
            emits = run(kv, kv_scales, smp, tables)
            torch.cuda.synchronize()
        seen["emits"] = emits
        seen["pools"] = all(torch.equal(_bytes(a), _bytes(b)) for a, b in
                            zip(kv + (kv_scales or []), kv_c + sc_c))
        seen["prof"] = prof
        return emits

    fs.run = gated
    try:
        while not seen and eng.has_work():
            eng.step()
    finally:
        del fs.run
    if not seen:
        raise AssertionError("the engine ran out of work before a window")
    return seen


def fused_gate(pa, model, kv_dtype, k, prompts, sampled=False,
               token_strs=None):
    """Graph against eager, bit-identical (the capture-correctness gate):
    an `LLMEngine` at decode_k k on a `kv_dtype` pool serves the prompts
    to its first fused window (which captures the graph); then the
    capture stream's workspace is outgrown by an eager call and a
    sentinel allocated; the next window is run eagerly on copies of the
    pools and scale planes from the same staged inputs, then as the graph
    replay under the profiler. The emits and every pool byte must be
    equal, the sentinel untouched, and the profiler must see 12 x k
    `rpa_tc_kernel` launches and a graph launch in the replay. With
    `token_strs`, the engine serves phase 5g's mixed requests (half
    constrained) and both windows are structured ones: the graph masks
    its picks. Returns the engine (its graphs still captured)."""
    from torch.autograd import DeviceType

    from paddle_tpu_torch.inference import LLMEngine

    structured = token_strs is not None
    knobs = (dict(token_strs=token_strs, grammar_states=STRUCT_STATES)
             if structured else {})
    eng = LLMEngine(model, _fused_cfg(kv_dtype, k, **knobs))
    kw = SAMPLED if sampled else {}
    requests = (struct_requests(sampled) if structured
                else [kw] * len(prompts))
    for p, r in zip(prompts, requests):
        eng.add_request(p, max_new_tokens=SERVE_NEW_TOKENS, **r)
    while (sampled, structured) not in (eng._fused_fn._graphs
                                        if eng._fused_fn else {}):
        eng.step()
    fs = eng._fused_fn
    graph = fs._graphs[(sampled, structured)]
    _grow_workspace(pa, model, eng._kv, eng._kv_scales, eng, fs._stream)
    outgrown = [w.data_ptr() for w in graph.workspaces] != [
        w.data_ptr() for w in pa.stream_workspaces(fs._stream.cuda_stream)]
    sentinel = torch.full((16 << 20,), 7, dtype=torch.int32, device="cuda")
    seen = _window_vs_eager(eng, fs, structured, profiled=True)
    rows = seen["prof"].key_averages()
    tc = sum(e.count for e in rows if e.device_type == DeviceType.CUDA
             and "rpa_tc_kernel" in e.key)
    graph_launches = sum(e.count for e in rows
                         if "cudaGraphLaunch" in e.key)
    layers = model.config.num_layers
    label = (f"{kv_dtype} k={k}{' sampled' if sampled else ''}"
             f"{' structured' if structured else ''}")
    ok = (np.array_equal(seen["emits"], seen["eager"]) and seen["pools"]
          and bool((sentinel == 7).all()) and tc == layers * k
          and graph_launches >= 1)
    print(f"fused gate {label}: graph replay vs eager run of one window: "
          f"emits equal {np.array_equal(seen['emits'], seen['eager'])}, "
          f"pools and scale planes byte-equal {seen['pools']}, after the "
          f"capture stream's workspace was outgrown ({outgrown}; sentinel "
          f"intact {bool((sentinel == 7).all())}); the profiler saw {tc} "
          f"rpa_tc_kernel launches (want {layers} x {k}) and "
          f"{graph_launches} cudaGraphLaunch in the replay")
    if not (ok and outgrown):
        raise AssertionError(f"fused gate {label} failed")
    return eng


class _GraphGraveyard(torch.cuda.graph):
    """`torch.cuda.graph` with a trap, set in its place for a gate: once
    the stream captures, the engines in `dead` (each owning captured
    graphs, each in a reference cycle, so only the cyclic collector frees
    them) become garbage, and the collector is set to run at every
    allocation. A collection during the capture would destroy their
    graphs mid-capture and invalidate it; `_FusedStep` holds the collector
    off while it captures, and the gate must pass."""

    dead = []

    def __enter__(self):
        super().__enter__()
        self._thresholds = gc.get_threshold()
        gc.set_threshold(1, 1, 1)
        type(self).dead.clear()

    def __exit__(self, *exc):
        gc.set_threshold(*self._thresholds)
        return super().__exit__(*exc)


def fused_serve(pa, model, kv_dtype, k, prompts, bursts=("greedy",)):
    """`LLMServer` at decode_k k on a `kv_dtype` pool: per burst
    ("greedy", or "sampled" at temperature 0.8 / top_p 0.9, after a
    `reseed`), a warm-up request (which captures the burst's graph), then
    the serve phase's 8 requests with the launch counts set to 0 just
    before and read just after. K1 must have launched 12 times per single
    tick and 12 x k per window — each warm-up and each replay, live rows
    or not — all on the tensor-core route (the same count in
    `tc_launches`); at most two graphs captured. Times: for decode_k > 1
    the host clock around `_try_step_fused` (its one sync included) and
    CUDA events around each graph replay (device ms, its launch latency
    included); for decode_k 1 the same around each `_step_tick` and its
    forward — an eager tick is host-bound, so its events also hold the
    card's idle gaps: "stream ms", not device time. Returns per burst
    its tok/s, host / device ms per window, windows, launches and the
    launches made by graph replays."""
    from paddle_tpu_torch.inference import LLMServer
    from paddle_tpu_torch.profile_serve import EventTimer, HostTimer

    server = LLMServer(model, _fused_cfg(kv_dtype, k))
    eng = server.engine
    layers = model.config.num_layers
    key = "rpa" + _KV_SUFFIX[kv_dtype]
    out = {}
    with server:
        for burst in bursts:
            kw = SAMPLED if burst == "sampled" else {}
            if burst == "sampled":
                eng.reseed(4321)
            server.submit(prompts[0][:8], max_new_tokens=2 * k + 2,
                          **kw).result(timeout=600)
            torch.cuda.synchronize()
            fs = eng._fused_fn
            runs0 = (fs.replays, fs.warmups) if fs else (0, 0)
            st0 = dict(eng.stats)
            host = HostTimer(eng, "_try_step_fused" if fs else "_step_tick")
            dev = EventTimer(fs, "replay") if fs else EventTimer(eng,
                                                                 "_step_fn")
            pa.reset_launches()
            t0 = time.perf_counter()
            futs = [server.submit(p, max_new_tokens=SERVE_NEW_TOKENS, **kw)
                    for p in prompts]
            outs = [f.result(timeout=600) for f in futs]
            wall = time.perf_counter() - t0
            launches, tc = dict(pa.launches), dict(pa.tc_launches)
            host.remove()
            dev.remove()
            host_ms = float(np.median(host.times)) * 1e3
            dev_ms, n = float(np.median(dev.ms())), len(host.times)
            windows = eng.stats["fused_steps"] - st0["fused_steps"]
            ticks = eng.stats["steps"] - st0["steps"] - windows
            replays = (fs.replays - runs0[0]) if fs else 0
            warmups = (fs.warmups - runs0[1]) if fs else 0
            _check_outputs(prompts, outs, model.config.vocab_size)
            want = dict.fromkeys(launches, 0)
            want[key] = layers * (ticks + k * (replays + warmups))
            if (launches != want or tc != want or replays != windows
                    or (k > 1 and not windows) or fs and fs.captures > 2):
                raise AssertionError(
                    f"fused serve {kv_dtype} k={k} {burst}: launches "
                    f"{launches} (tensor-core {tc}) in {ticks} ticks, "
                    f"{windows} windows, {replays} replays, {warmups} "
                    f"warm-ups, captures {fs.captures if fs else 0}; "
                    f"expected {want}")
            gen = SERVE_NEW_TOKENS * len(prompts)
            out[burst] = dict(tok_s=gen / wall, host_ms=host_ms,
                              dev_ms=dev_ms, windows=windows, ticks=ticks,
                              launches=want[key],
                              graph=layers * k * replays)
            what = ("device", "window") if k > 1 else ("stream", "tick")
            print(f"fused serve gpt_small bf16, {kv_dtype} KV, decode_k {k}"
                  f", {burst}: {gen} generated in {wall:.3f} s = "
                  f"{gen / wall:.1f} tok/s, {ticks} ticks + {windows} "
                  f"windows; host {host_ms:.3f} ms and {what[0]} "
                  f"{dev_ms:.3f} ms per {what[1]} (median of {n}); K1{key[3:]}"
                  f" {want[key]} = {layers} x ({ticks} + {k} x ({replays} "
                  f"replays + {warmups} warm-ups)), {layers * k * replays} "
                  f"of them from graph replays, all on the tensor-core "
                  f"route; captures {fs.captures if fs else 0}")
    return out


def _near_tie(row, req, d, key, tol):
    """(gap, allowed) of the k=1 run's pick at generated index d: the top-2
    gap of the logits for a greedy request, of the Gumbel-perturbed
    scores (`_sampling_scores` at the token's position and the request's
    stream) for a sampled one, whose logit tolerance scales by 1 / T."""
    from paddle_tpu_torch.text.models import gpt as gpt_mod

    if req.temperature <= 0:
        top2 = row.topk(2).values
        return (top2[0] - top2[1]).item(), tol
    f = torch.tensor
    scores = gpt_mod._sampling_scores(
        row[None], f([req.temperature]), f([req.top_p]),
        f([req.sample_stream]), f([req.prompt_len + d]), key)[0]
    top2 = scores.topk(2).values
    return (top2[0] - top2[1]).item(), tol / req.temperature


def fused_cross(model, kv_dtype, k, prompts, label, sampled=False,
                draft=None):
    """The serve config through `LLMEngine` twice on the card from the
    same model, prompts and seed: at decode_k 1 and at decode_k k (its
    windows graph replays) — or, with a `draft` model, with draft-model
    speculation at spec_k k (its propose windows graph replays, its
    verify on device drafts). Request by request up to its first
    differing token, every emitted token's logits within
    SERVE_BF16_LOGIT_TOL; a token may differ only at a near-tie of the
    k=1 run (`_near_tie`), and the request is compared no further."""
    from paddle_tpu_torch.inference import LLMEngine

    kw = SAMPLED if sampled else {}
    runs = []
    for kk in (1, k):
        spec = (dict(draft_model=draft, spec_k=k)
                if draft is not None and kk > 1 else {})
        eng = LLMEngine(model, _fused_cfg(kv_dtype, 1 if spec else kk,
                                          **spec))
        reqs = [eng.add_request(p, max_new_tokens=SERVE_NEW_TOKENS, **kw)
                for p in prompts]
        logits, _ = _drive(eng, reqs)
        runs.append((eng, reqs, logits))
    (e1, r1, l1), (ek, rk, lk) = runs
    windows = ek.stats["fused_steps"] + _spec_windows(ek)
    if not windows:
        raise AssertionError(f"{label}: no window ran")
    key = e1._key.cpu()
    worst, rows, ties = 0.0, 0, []
    for i, p in enumerate(prompts):
        t1 = r1[i].future.result()[len(p):]
        tk = rk[i].future.result()[len(p):]
        if not ((t1 >= 0) & (t1 < model.config.vocab_size)).all():
            raise AssertionError(f"{label}: request {i} out of vocab")
        diff = np.flatnonzero(t1 != tk)
        d = int(diff[0]) if diff.size else len(t1)
        for j in range(min(d + 1, len(t1))):
            worst = max(worst, (l1[i][j] - lk[i][j]).abs().max().item())
            rows += 1
        if d < len(t1):
            gap, tol = _near_tie(l1[i][d], r1[i], d, key,
                                 SERVE_BF16_LOGIT_TOL)
            if not gap <= tol:
                raise AssertionError(
                    f"{label}: request {i} token {d} is {tk[d]} vs the k=1 "
                    f"run's {t1[d]}, whose top two scores differ by "
                    f"{gap:.3e} (tol {tol:.2e})")
            ties.append(f"request {i} token {d} (gap {gap:.2e})")
    what = f"draft spec_k {k}" if draft is not None else f"decode_k {k}"
    print(f"fused cross-check {label}, {what} vs decode_k 1 on the card: "
          f"{windows} windows + {ek.stats['steps'] - windows} ticks vs "
          f"{e1.stats['steps']} ticks; {rows} emitted rows compared, logits "
          f"max abs diff {worst:.3e} (tol {SERVE_BF16_LOGIT_TOL:.0e}); "
          f"tokens differ at {len(ties)} near-ties"
          f"{': ' + ', '.join(ties) if ties else ''}")
    if not worst <= SERVE_BF16_LOGIT_TOL:
        raise AssertionError(f"{label}: fused and k=1 logits disagree")


def sampled_spec(pa, model):
    """(f) `LLMServer` with n-gram speculation (spec_k 4) on a bf16 pool,
    8 sampled requests (temperature 0.8, top_p 0.9) of the serve phase's
    repetitive prompts: every request finishes with in-vocab tokens, K2
    launched 12 times per verify window and K1 12 per single tick, all on
    the tensor-core route."""
    from paddle_tpu_torch.inference import LLMEngineConfig, LLMServer

    cfg = model.config
    prompts = repetitive_prompts(cfg.vocab_size, SERVE_PROMPT_LENS, 4321)
    server = LLMServer(model, LLMEngineConfig(
        kv_dtype="bfloat16", spec_mode="ngram", spec_k=4, seed=77,
        **SERVE_CFG))
    eng = server.engine
    with server:
        server.submit(prompts[0][:24], max_new_tokens=8,
                      **SAMPLED).result(timeout=600)
        torch.cuda.synchronize()
        st0 = dict(eng.stats)
        pa.reset_launches()
        t0 = time.perf_counter()
        futs = [server.submit(p, max_new_tokens=SERVE_NEW_TOKENS, **SAMPLED)
                for p in prompts]
        outs = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        launches, tc = dict(pa.launches), dict(pa.tc_launches)
    _check_outputs(prompts, outs, cfg.vocab_size)
    d = {k: eng.stats[k] - st0[k] for k in st0}
    windows = d["ngram_windows"]
    ticks = d["steps"] - windows
    want = dict.fromkeys(launches, 0)
    want["rpa"] = cfg.num_layers * ticks
    want["qblock"] = cfg.num_layers * windows
    if launches != want or tc != want or not windows:
        raise AssertionError(f"sampled ngram serve: launches {launches} "
                             f"(tensor-core {tc}), {ticks} ticks, {windows} "
                             "windows")
    gen = SERVE_NEW_TOKENS * len(prompts)
    print(f"sampled ngram serve gpt_small bf16 (temperature 0.8, top_p 0.9,"
          f" spec_k 4): {gen} generated in {wall:.3f} s = {gen / wall:.1f} "
          f"tok/s, {ticks} ticks + {windows} windows, proposed "
          f"{d['ngram_proposed']} accepted {d['ngram_accepted']}; K2 "
          f"{want['qblock']} = {cfg.num_layers} x {windows}, K1 "
          f"{want['rpa']} = {cfg.num_layers} x {ticks}, all on the "
          "tensor-core route")


def fused_phase(pa, model, random, card):
    """fused phase: the graph gates on bf16 (k 8 and 4, greedy; k 8
    sampled), int8 and int4 pools (k 8); `LLMServer` bursts at decode_k
    1, 4 and 8 on the bf16 pool (greedy, then sampled after a reseed) and
    at 8 on the int8 and int4 pools; the fused vs k=1 cross-checks (bf16
    greedy and sampled, int8 greedy); a sampled n-gram burst. Returns the
    bursts' numbers by (kv_dtype, k)."""
    for k in (8, 4):
        fused_gate(pa, model, "bfloat16", k, random)
    dead = fused_gate(pa, model, "bfloat16", 8, random, sampled=True)
    for kv in ("int8", "int4"):
        dead.cycle = dead           # garbage only to the cyclic collector
        _GraphGraveyard.dead.append(dead)
        del dead
        real, torch.cuda.graph = torch.cuda.graph, _GraphGraveyard
        try:
            dead = fused_gate(pa, model, kv, 8, random)
        finally:
            torch.cuda.graph = real
    del dead
    res = {("bfloat16", k): fused_serve(pa, model, "bfloat16", k, random,
                                        ("greedy", "sampled"))
           for k in (1, *FUSED_KS)}
    for kv in ("int8", "int4"):
        res[(kv, 8)] = fused_serve(pa, model, kv, 8, random)
    fused_cross(model, "bfloat16", 8, random, "gpt_small bf16 KV")
    fused_cross(model, "bfloat16", 8, random, "gpt_small bf16 KV sampled",
                sampled=True)
    fused_cross(model, "int8", 8, random, "gpt_small int8 KV")
    sampled_spec(pa, model)
    for burst in ("greedy", "sampled"):
        print(f"decode_k sweep, bf16 KV, {burst} ({card}): " + "; ".join(
            f"k={k} {res[('bfloat16', k)][burst]['tok_s']:.1f} tok/s, host "
            f"{res[('bfloat16', k)][burst]['host_ms']:.3f} ms / "
            f"{'device' if k > 1 else 'stream'} "
            f"{res[('bfloat16', k)][burst]['dev_ms']:.3f} ms per "
            f"{'window' if k > 1 else 'tick'}" for k in (1, *FUSED_KS)))
    return res


# ---- draft-model speculation (5e) and weight-only serving (5f) ----

SPEC_K = 4
SPEC_POOLS = ("bfloat16", "int8", "int4")


def spec_pair():
    """(target, draft) at gpt_small's width, bf16 from seed 1234, built as
    the reference bench's `_spec_draft_pair` (bench.py:831): the draft is
    one block holding copies of the target's embeddings, first block and
    final LN; the target's blocks 2-12 have proj / fc2 damped by 0.01."""
    from paddle_tpu_torch.profile_serve import spec_draft_pair
    from paddle_tpu_torch.text.models.gpt import gpt_small

    return spec_draft_pair(gpt_small(), seed=1234)


def _spec_cfg(kv_dtype, draft):
    return _fused_cfg(kv_dtype, 1, draft_model=draft, spec_k=SPEC_K)


def _draft_write_row(spec, slot, req):
    """Write the draft's KV row at position n_prefilled - 1 of `req` (the
    row a lag of 1 leaves unwritten) through the draft's single tick, so
    the request's lag becomes 0 (the state a rejected window leaves)."""
    eng = spec.engine
    ps, T = eng.page_size, spec._draft_T
    p = req.n_prefilled - 1
    rows = torch.zeros((5, T), dtype=torch.int32)
    rows[:, 0] = torch.tensor([req.tokens[p], p, slot,
                               req.pages[p // ps] * ps + p % ps, p + 1])
    rows = rows.cuda()
    spec._prefill_fn(rows[0], rows[1], rows[2], rows[3],
                     torch.from_numpy(eng._page_tables).cuda(), rows[4],
                     torch.zeros((1,), dtype=torch.int32, device="cuda"),
                     spec._kv, spec._kv_scales or None)
    req.draft_prefilled = req.n_prefilled


def draft_gate(pa, target, draft, kv_dtype, prompts, sampled=False):
    """Propose graph against eager, bit-identical: an `LLMEngine` with
    the draft (spec_k 4) on a `kv_dtype` pool serves the prompts to its
    first window (which captures the propose graph); the capture stream's
    workspace is then outgrown by an eager call and a sentinel allocated.
    At the next window with two live frontier rows, after the real
    catch-up, one row is set to a lag of 1 and another to a lag of 0;
    its propose window runs eagerly on copies of the draft pools and
    scale planes from the same staged inputs, then as the graph replay
    under the profiler. The emits and every draft pool byte must be
    equal, the sentinel untouched, and the profiler must see (k+1) x the
    draft's layers `rpa_tc_kernel` launches and a graph launch in the
    replay."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.inference import LLMEngine

    eng = LLMEngine(target, _spec_cfg(kv_dtype, draft))
    kw = SAMPLED if sampled else {}
    for p in prompts:
        eng.add_request(p, max_new_tokens=SERVE_NEW_TOKENS, **kw)
    while eng.stats["spec_windows"] == 0:
        eng.step()
    spec = eng._spec
    prop = spec._propose_fn
    graph = prop._graphs[(sampled, False)]
    _grow_workspace(pa, draft, spec._kv, spec._kv_scales, eng, prop._stream)
    outgrown = [w.data_ptr() for w in graph.workspaces] != [
        w.data_ptr() for w in pa.stream_workspaces(prop._stream.cuda_stream)]
    sentinel = torch.full((16 << 20,), 7, dtype=torch.int32, device="cuda")
    catch_up, launch, seen = spec._catch_up, prop.launch, {}

    def mixed(rows):
        catch_up(rows)
        if len(rows) < 2 or seen:
            return
        (sa, ra), (sb, rb) = rows[:2]
        if ra.n_prefilled == ra.draft_prefilled:
            ra.draft_prefilled -= 1            # lag 1
        if rb.n_prefilled - rb.draft_prefilled == 1:
            _draft_write_row(spec, sb, rb)     # lag 0
        seen["rows"] = (sa, sb)

    def gated(kv, kv_scales, smp):
        if "rows" not in seen or "emits" in seen:
            return launch(kv, kv_scales, smp)
        lag, fin = prop.host_views()[6], prop.host_views()[3]
        seen["lags"] = sorted(int(lag[s]) for s in seen["rows"]
                              if not fin[s])
        prop._static.copy_(prop._host)
        kv_c = [p.clone() for p in kv]
        sc_c = [p.clone() for p in kv_scales or []]
        seen["eager"] = prop.eager(kv_c, sc_c or None, smp).cpu()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            emits = launch(kv, kv_scales, smp)
            torch.cuda.synchronize()
        seen["emits"] = emits.cpu()
        seen["pools"] = all(torch.equal(_bytes(a), _bytes(b)) for a, b in
                            zip(kv + (kv_scales or []), kv_c + sc_c))
        seen["prof"] = prof
        return emits

    spec._catch_up, prop.launch = mixed, gated
    try:
        for _ in range(200):
            if "emits" in seen or not eng.has_work():
                break
            eng.step()
    finally:
        del spec._catch_up, prop.launch
    if "emits" not in seen:
        raise AssertionError("draft gate: no window with two frontier rows")
    rows = seen["prof"].key_averages()
    tc = sum(e.count for e in rows if e.device_type == DeviceType.CUDA
             and "rpa_tc_kernel" in e.key)
    graph_launches = sum(e.count for e in rows
                         if "cudaGraphLaunch" in e.key)
    want_tc = draft.config.num_layers * (SPEC_K + 1)
    label = f"{kv_dtype}{' sampled' if sampled else ''}"
    same = torch.equal(seen["emits"], seen["eager"])
    print(f"draft gate {label}: propose graph replay vs eager run of one "
          f"window (rows at lag {seen['lags']}): emits equal {same}, draft "
          f"pools and scale planes byte-equal {seen['pools']}, after the "
          f"capture stream's workspace was outgrown ({outgrown}; sentinel "
          f"intact {bool((sentinel == 7).all())}); the profiler saw {tc} "
          f"rpa_tc_kernel launches (want {want_tc}) and {graph_launches} "
          "cudaGraphLaunch in the replay")
    if not (same and seen["pools"] and outgrown and seen["lags"] == [0, 1]
            and bool((sentinel == 7).all()) and tc == want_tc
            and graph_launches >= 1):
        raise AssertionError(f"draft gate {label} failed")


def draft_serve(pa, target, draft, kv_dtype, prompts, card):
    """`LLMServer` with the draft (spec_k 4) on a `kv_dtype` pool: a warm-up
    request (which captures the propose graph), then the serve phase's 8
    requests with the launch counts set to 0 just before and read just
    after. K2 must have launched 12 times per verify window; K1 12 per
    target tick, once per draft layer per draft catch-up tick and (k+1)
    per draft layer per propose warm-up and replay; all on the
    tensor-core route; one replay per window, at most two propose
    captures, proposals accepted. Prints tok/s, the acceptance rate and
    host / draft / stream ms per window (`profile_serve.SpecTimer`).
    Returns the burst's numbers."""
    from paddle_tpu_torch.inference import LLMServer
    from paddle_tpu_torch.profile_serve import SpecTimer

    server = LLMServer(target, _spec_cfg(kv_dtype, draft))
    eng = server.engine
    spec = eng._spec
    prop = spec._propose_fn
    layers, dlayers = target.config.num_layers, draft.config.num_layers
    sfx = _KV_SUFFIX[kv_dtype]
    catch_ups = []
    tick = spec._prefill_fn

    def counted(*args, **kw):
        catch_ups.append(1)
        return tick(*args, **kw)

    spec._prefill_fn = counted
    with server:
        server.submit(prompts[0][:8],
                      max_new_tokens=2 * SPEC_K + 2).result(timeout=600)
        torch.cuda.synchronize()
        st0, runs0, cu0 = dict(eng.stats), (prop.replays, prop.warmups), \
            len(catch_ups)
        timer = SpecTimer(spec)
        pa.reset_launches()
        t0 = time.perf_counter()
        futs = [server.submit(p, max_new_tokens=SERVE_NEW_TOKENS)
                for p in prompts]
        outs = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        launches, tc = dict(pa.launches), dict(pa.tc_launches)
        timer.remove()
        host_ms, draft_ms, stream_ms = timer.ms()
    _check_outputs(prompts, outs, target.config.vocab_size)
    d = {k: eng.stats[k] - st0[k] for k in st0}
    windows = d["spec_windows"]
    ticks = d["steps"] - windows
    replays, warmups = prop.replays - runs0[0], prop.warmups - runs0[1]
    cus = len(catch_ups) - cu0
    want = dict.fromkeys(launches, 0)
    want["rpa" + sfx] = (layers * ticks + dlayers * cus
                         + dlayers * (SPEC_K + 1) * (replays + warmups))
    want["qblock" + sfx] = layers * windows
    if (launches != want or tc != want or replays != windows
            or not windows or prop.captures > 2 or not d["spec_accepted"]):
        raise AssertionError(
            f"draft serve {kv_dtype}: launches {launches} (tensor-core {tc})"
            f" in {ticks} ticks, {windows} windows, {cus} catch-up ticks, "
            f"{replays} replays, {warmups} warm-ups, captures "
            f"{prop.captures}, accepted {d['spec_accepted']}; expected "
            f"{want}")
    gen = SERVE_NEW_TOKENS * len(prompts)
    rate = d["spec_accepted"] / max(d["spec_proposed"], 1)
    print(f"draft serve gpt_small bf16 + 1-layer draft, {kv_dtype} KV, "
          f"spec_k {SPEC_K} ({card}): {gen} generated in {wall:.3f} s = "
          f"{gen / wall:.1f} tok/s, {ticks} ticks + {windows} windows, "
          f"proposed {d['spec_proposed']} accepted {d['spec_accepted']} = "
          f"{100 * rate:.1f}% acceptance; per window (medians) host "
          f"{host_ms:.3f} ms, draft {draft_ms:.3f} ms (catch-up + propose "
          f"replay), stream {stream_ms:.3f} ms; K2{sfx} "
          f"{want['qblock' + sfx]} = {layers} x {windows}, K1{sfx} "
          f"{want['rpa' + sfx]} = {layers} x {ticks} + {dlayers} x {cus} "
          f"catch-up ticks + {dlayers} x {SPEC_K + 1} x ({replays} replays "
          f"+ {warmups} warm-ups), all on the tensor-core route; captures "
          f"{prop.captures}")
    return dict(tok_s=gen / wall, rate=rate, host_ms=host_ms,
                draft_ms=draft_ms, stream_ms=stream_ms, windows=windows,
                launches=want["rpa" + sfx],
                graph=dlayers * (SPEC_K + 1) * replays)


def draft_phase(pa, random, card):
    """5e: the propose-graph gates (bf16, int8 and int4 pools, greedy and
    sampled), the draft engine vs the k=1 engine on the card (bf16 pool,
    greedy and sampled) and `LLMServer` bursts on the three pools.
    Returns the bursts' numbers by pool."""
    target, draft = spec_pair()
    for kv in SPEC_POOLS:
        for sampled in (False, True):
            draft_gate(pa, target, draft, kv, random, sampled)
    fused_cross(target, "bfloat16", SPEC_K, random,
                "gpt_small bf16 KV + draft", draft=draft)
    fused_cross(target, "bfloat16", SPEC_K, random,
                "gpt_small bf16 KV + draft, sampled", sampled=True,
                draft=draft)
    return {kv: draft_serve(pa, target, draft, kv, random, card)
            for kv in SPEC_POOLS}


WEIGHT_KS = (1, 4)     # decode_k of the weight-only bursts


def weights_model(bits):
    """The serve model (gpt_small bf16, seed 1234) after
    `quantize_model_int8` (bits 8) or `quantize_model_int4` (bits 4):
    every linear of the 12 blocks through the int8 GEMM. Returns (model,
    report)."""
    from paddle_tpu_torch.quantization import runtime as qrt

    model = serve_model()
    quant = qrt.quantize_model_int8 if bits == 8 else qrt.quantize_model_int4
    return model, quant(model)


def weights_serve(ig, pa, model, key, k, prompts):
    """`LLMServer` on a weight-quantized model at decode_k k (bf16 KV):
    a warm-up request, then the serve phase's 8 requests with the counts
    set to 0 just before and read just after. The int8 GEMM must have
    launched once per linear (48) per tick and 48 x k per fused warm-up
    and replay, under `key` ("w8a8" / "w4a8") only; K1 12 per tick and
    12 x k per window run. Returns tok/s and the GEMM's launches."""
    from paddle_tpu_torch.inference import LLMServer

    server = LLMServer(model, _fused_cfg("bfloat16", k))
    eng = server.engine
    layers = model.config.num_layers
    linears = 4 * layers
    with server:
        server.submit(prompts[0][:8],
                      max_new_tokens=2 * k + 2).result(timeout=600)
        torch.cuda.synchronize()
        fs = eng._fused_fn
        runs0 = (fs.replays, fs.warmups) if fs else (0, 0)
        st0 = dict(eng.stats)
        pa.reset_launches()
        ig.reset_launches()
        t0 = time.perf_counter()
        futs = [server.submit(p, max_new_tokens=SERVE_NEW_TOKENS)
                for p in prompts]
        outs = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        gemm, launches = dict(ig.launches), dict(pa.launches)
    _check_outputs(prompts, outs, model.config.vocab_size)
    windows = eng.stats["fused_steps"] - st0["fused_steps"]
    ticks = eng.stats["steps"] - st0["steps"] - windows
    runs = ((fs.replays - runs0[0]) + (fs.warmups - runs0[1])) if fs else 0
    want_g = dict.fromkeys(gemm, 0)
    want_g[key] = linears * (ticks + k * runs)
    want_k = dict.fromkeys(launches, 0)
    want_k["rpa"] = layers * (ticks + k * runs)
    if gemm != want_g or launches != want_k or (k > 1 and not windows):
        raise AssertionError(
            f"weights serve {key} k={k}: GEMM launches {gemm}, paged "
            f"{launches} in {ticks} ticks + {windows} windows ({runs} "
            f"warm-ups and replays); expected {want_g}, {want_k}")
    gen = SERVE_NEW_TOKENS * len(prompts)
    print(f"weights serve gpt_small {key} (bf16 KV, decode_k {k}): {gen} "
          f"generated in {wall:.3f} s = {gen / wall:.1f} tok/s, {ticks} "
          f"ticks + {windows} windows; int8 GEMM {want_g[key]} = {linears} "
          f"x ({ticks} + {k} x {runs}), K1 {want_k['rpa']}")
    return dict(tok_s=gen / wall, launches=want_g[key])


def weights_cross(ig, model, key, prompts):
    """The weight-quantized serve path twice on the card (`LLMEngine`,
    bf16 KV, k=1): through the int8 GEMM, and with `w8a8_linear` swapped
    for its plain version (restored after); `_cross_compare` on the
    two."""
    from paddle_tpu_torch.inference import LLMEngine

    kernel = ig.w8a8_linear
    runs = []
    for swap in (False, True):
        eng = LLMEngine(model, _fused_cfg("bfloat16", 1))
        reqs = [eng.add_request(p, max_new_tokens=SERVE_NEW_TOKENS)
                for p in prompts]
        ig.reset_launches()
        try:
            if swap:
                ig.w8a8_linear = ig.w8a8_linear_plain
            logits, chunks = _drive(eng, reqs)
        finally:
            ig.w8a8_linear = kernel
        runs.append(dict(tokens=[r.future.result()[len(p):]
                                 for r, p in zip(reqs, prompts)],
                         logits=logits, chunks=chunks,
                         ticks=eng.stats["steps"], gemm=dict(ig.launches)))
    kr, pr = runs
    label = f"gpt_small {key} weights"
    want = 4 * model.config.num_layers * kr["ticks"]
    if kr["gemm"][key] != want or set(pr["gemm"].values()) != {0}:
        raise AssertionError(f"{label}: GEMM launches {kr['gemm']} in "
                             f"{kr['ticks']} ticks (want {want}); plain run "
                             f"{pr['gemm']}")
    worst, rows, ties = _cross_compare(label, kr, pr)
    print(f"weights cross-check {label}, the int8 GEMM vs its plain version "
          f"on the card: {kr['ticks']} ticks (plain {pr['ticks']}); {rows} "
          f"emitted rows compared, logits max abs diff {worst:.3e} (tol "
          f"{SERVE_BF16_LOGIT_TOL:.0e}); tokens differ at {len(ties)} "
          f"near-ties{': ' + ', '.join(ties) if ties else ''}")
    if not worst <= SERVE_BF16_LOGIT_TOL:
        raise AssertionError(f"{label}: the int8 GEMM disagrees with its "
                             "plain version")


def weights_phase(ig, pa, random, card):
    """5f: per weight width (int8, packed int4), the quantized serve model's
    `LLMServer` bursts at decode_k 1 and 4 and the GEMM-vs-plain
    cross-check. Returns {key: {k: burst}}."""
    res = {}
    for bits, key in ((8, "w8a8"), (4, "w4a8")):
        t0 = time.perf_counter()
        model, report = weights_model(bits)
        quant_s = time.perf_counter() - t0
        fp = report["weight_bytes_fp"]
        q = report[f"weight_bytes_int{bits}"]
        print(f"weights {key}: {report['layers']} linears quantized in "
              f"{quant_s:.1f} s on the host, weight bytes {fp} -> {q} "
              f"({fp - q} saved, {fp / q:.2f}x) ({card})")
        if report["layers"] != 4 * model.config.num_layers:
            raise AssertionError(f"weights {key}: report {report}")
        res[key] = {k: weights_serve(ig, pa, model, key, k, random)
                    for k in WEIGHT_KS}
        weights_cross(ig, model, key, random)
        del model
    return res


# ---- structured decoding (5g) ----

STRUCT_STATES = 256          # grammar arena rows of the 5g engines
STRUCT_PROMPT_LENS = (16, 40, 64, 100, 128, 150, 180, 200)
STRUCT_NEW_TOKENS = 120
STRUCT_K = 4
STRUCT_PATHS = ("k=1", "fused k=4", "ngram", "draft")


def struct_requests(sampled=None):
    """The 8 requests of 5g, by prompt, eos token 0: four constrained (the
    list template greedy, the small object greedy, the JSON schema greedy,
    the template sampled) and four unconstrained (two greedy, two
    sampled). `sampled` True / False: every request sampled / greedy (the
    replay gates)."""
    from paddle_tpu_torch.profile_serve import OBJECT_A, SCHEMA, TEMPLATE

    mix = ((dict(grammar=TEMPLATE), False), (dict(grammar=OBJECT_A), False),
           (dict(json_schema=SCHEMA), False), (dict(grammar=TEMPLATE), True),
           ({}, False), ({}, False), ({}, True), ({}, True))
    return [dict(c, eos_token_id=0,
                 **(SAMPLED if (smp if sampled is None else sampled)
                    else {}))
            for c, smp in mix]


def plain_requests():
    """`struct_requests()` with the constraints taken off: the same knobs
    and, by submission order, the same sampling streams."""
    return [{k: v for k, v in r.items() if k not in ("grammar",
                                                     "json_schema")}
            for r in struct_requests()]


def _struct_cfg(path, token_strs, draft=None):
    from paddle_tpu_torch.inference import LLMEngineConfig

    knobs = {"k=1": {}, "fused k=4": dict(decode_k=STRUCT_K),
             "ngram": dict(spec_mode="ngram", spec_k=STRUCT_K),
             "draft": dict(draft_model=draft, spec_k=STRUCT_K)}[path]
    return LLMEngineConfig(kv_dtype="bfloat16", seed=77,
                           token_strs=token_strs,
                           grammar_states=STRUCT_STATES, **SERVE_CFG,
                           **knobs)


def _struct_valid(label, req, token_strs):
    """The validity gate of one constrained request: its DFA replay meets
    no disallowed token, and an output that ended at eos fullmatches the
    pattern. Returns whether it ended at eos."""
    g = req.grammar
    gen = [int(t) for t in req.future.result()[req.prompt_len:]]
    state = 0
    for j, t in enumerate(gen):
        if not g.allowed_np(state)[t]:
            raise AssertionError(
                f"{label}: generated token {j} ({t}) of a request under "
                f"{g.pattern!r} is not allowed in state {state}")
        if t == g.eos_id:
            break
        state = g.advance(state, t)
    ended = bool(gen) and gen[-1] == g.eos_id
    if ended:
        text = "".join(token_strs[t] for t in gen[:-1])
        if not re.fullmatch(g.pattern, text):
            raise AssertionError(f"{label}: {text!r} does not match "
                                 f"{g.pattern!r}")
    return ended


def struct_drive(model, cfg, prompts, requests, token_strs, label):
    """An `LLMEngine` on `cfg` serves the requests to the end through
    `_drive` (every emitted token's logits kept); every constrained
    output must be valid. Returns (engine, requests, logits)."""
    from paddle_tpu_torch.inference import LLMEngine

    eng = LLMEngine(model, cfg)
    reqs = [eng.add_request(p, max_new_tokens=STRUCT_NEW_TOKENS, **r)
            for p, r in zip(prompts, requests)]
    logits, _ = _drive(eng, reqs)
    for r in reqs:
        if r.grammar is not None:
            _struct_valid(label, r, token_strs)
    return eng, reqs, logits


def struct_cross(label, ref, run, rows_of):
    """Requests `rows_of` of `run` against the same requests of `ref` (both
    `struct_drive` results), each up to its first differing token: every
    emitted token's logits within SERVE_BF16_LOGIT_TOL; a token may differ
    only at a near-tie of `ref`'s scores there (`_near_tie`, on the logits
    masked by the request's grammar at that token), and the request is
    compared no further."""
    (e1, r1, l1), (_, rk, lk) = ref, run
    key = e1._key.cpu()
    worst, rows, ties = 0.0, 0, []
    for i, j in rows_of:
        a, b = r1[i], rk[j]
        t1 = a.future.result()[a.prompt_len:]
        tk = b.future.result()[b.prompt_len:]
        n = min(len(t1), len(tk))
        diff = np.flatnonzero(t1[:n] != tk[:n])
        d = int(diff[0]) if diff.size else n
        if d == n and len(t1) != len(tk):
            raise AssertionError(f"{label}: request {i} ends at {len(tk)} "
                                 f"tokens, the reference's at {len(t1)}")
        for m in range(min(d + 1, n)):
            worst = max(worst, (l1[i][m] - lk[j][m]).abs().max().item())
            rows += 1
        if d < n:
            row = l1[i][d]
            if a.grammar is not None:
                ok = a.grammar.allowed_np(a.grammar.replay(t1[:d]))
                row = torch.where(torch.from_numpy(ok.copy()), row, -1e30)
            gap, tol = _near_tie(row, a, d, key, SERVE_BF16_LOGIT_TOL)
            if not gap <= tol:
                raise AssertionError(
                    f"{label}: request {i} token {d} is {tk[d]} vs the "
                    f"reference's {t1[d]}, whose top two scores differ by "
                    f"{gap:.3e} (tol {tol:.2e})")
            ties.append(f"request {i} token {d} (gap {gap:.2e})")
    print(f"structured cross-check {label}: {rows} emitted rows compared, "
          f"logits max abs diff {worst:.3e} (tol "
          f"{SERVE_BF16_LOGIT_TOL:.0e}); tokens differ at {len(ties)} "
          f"near-ties{': ' + ', '.join(ties) if ties else ''}")
    if not worst <= SERVE_BF16_LOGIT_TOL:
        raise AssertionError(f"{label}: logits disagree")


def struct_serve(pa, model, path, token_strs, prompts, card, draft=None):
    """`LLMServer` on the 5g config of `path`: four warm-up requests, one
    per (greedy-or-sampled, constrained-or-not) choice (which capture
    every graph a burst can replay), then the mixed burst
    ("constrained": half the requests constrained) and the
    all-unconstrained one, the launch counts set to 0 just before each and
    read just after. Every constrained output valid; K1 12 per tick, 12 x
    k per fused warm-up and replay, 1 per draft catch-up tick and 5 per
    propose warm-up and replay, K2 12 per verify window, all on the
    tensor-core route; one replay per window, captures at most one per
    graph key. Host seconds per `_grammar_args` and per host-tick mask
    (`_mask_rows`) over the mixed burst. Returns per burst its tok/s and
    launches, and the host times."""
    from paddle_tpu_torch.inference import LLMServer
    from paddle_tpu_torch.profile_serve import HostTimer

    server = LLMServer(model, _struct_cfg(path, token_strs, draft))
    eng = server.engine
    spec = eng._spec
    layers = model.config.num_layers
    catch_ups = []
    if draft is not None:
        tick = spec._prefill_fn

        def counted(*args, **kw):
            catch_ups.append(1)
            return tick(*args, **kw)

        spec._prefill_fn = counted
    gargs = HostTimer(eng, "_grammar_args")
    hmask = HostTimer(eng, "_mask_rows")

    def burst(requests):
        futs = [server.submit(p, max_new_tokens=STRUCT_NEW_TOKENS, **r)
                for p, r in zip(prompts, requests)]
        return futs, [f.result(timeout=600) for f in futs]

    out = {}
    with server:
        # warm-ups, one request each: greedy / sampled, unconstrained /
        # constrained — every graph key a burst can replay is captured
        for r in (*plain_requests()[2:4], *struct_requests()[::3][:2]):
            server.submit(prompts[0][:8], max_new_tokens=2 * STRUCT_K + 2,
                          **r).result(timeout=600)
        torch.cuda.synchronize()
        for name, requests in (("constrained", struct_requests()),
                               ("unconstrained", plain_requests())):
            graphs = (eng._fused_fn if eng._fused_fn is not None
                      else spec._propose_fn if draft is not None else None)
            runs0 = (graphs.replays, graphs.warmups) if graphs else (0, 0)
            st0, cu0 = dict(eng.stats), len(catch_ups)
            gargs.times.clear()
            hmask.times.clear()
            pa.reset_launches()
            t0 = time.perf_counter()
            futs, outs = burst(requests)
            wall = time.perf_counter() - t0
            launches, tc = dict(pa.launches), dict(pa.tc_launches)
            times = (list(gargs.times), list(hmask.times))
            d = {k: eng.stats[k] - st0.get(k, 0) for k in eng.stats}
            windows = (d["fused_steps"] + d.get("ngram_windows", 0)
                       + d.get("spec_windows", 0))
            ticks = d["steps"] - windows
            replays = (graphs.replays - runs0[0]) if graphs else 0
            warmups = (graphs.warmups - runs0[1]) if graphs else 0
            cus = len(catch_ups) - cu0
            want = dict.fromkeys(launches, 0)
            if path == "fused k=4":
                want["rpa"] = layers * (ticks + STRUCT_K * (replays
                                                            + warmups))
            elif path == "draft":
                dl = draft.config.num_layers
                want["rpa"] = (layers * ticks + dl * cus + dl * (STRUCT_K + 1)
                               * (replays + warmups))
            else:
                want["rpa"] = layers * ticks
            if path in ("ngram", "draft"):
                want["qblock"] = layers * windows
            captures_ok = graphs is None or (
                graphs.captures == len(graphs._graphs) <= 4)
            if (launches != want or tc != want or (path != "k=1"
                                                   and not windows)
                    or (graphs is not None and replays != windows)
                    or not captures_ok):
                raise AssertionError(
                    f"structured serve {path} {name}: launches {launches} "
                    f"(tensor-core {tc}) in {ticks} ticks, {windows} "
                    f"windows, {replays} replays, {warmups} warm-ups, "
                    f"{cus} catch-up ticks; expected {want}")
            ended = [_struct_valid(f"structured serve {path}", f.pt_request,
                                   token_strs)
                     for f in futs if f.pt_request.grammar is not None]
            gen = sum(len(o) - len(p) for o, p in zip(outs, prompts))
            prop = d.get("ngram_proposed", 0) + d.get("spec_proposed", 0)
            acc = d.get("ngram_accepted", 0) + d.get("spec_accepted", 0)
            rate = f", accepted {acc} of {prop} proposals" if prop else ""
            out[name] = dict(tok_s=gen / wall, launches=want,
                             windows=windows, ticks=ticks)
            print(f"structured serve gpt_small bf16, {path}, {name} "
                  f"({card}): {gen} generated in {wall:.3f} s = "
                  f"{gen / wall:.1f} tok/s, {ticks} ticks + {windows} "
                  f"windows{rate}; constrained outputs valid, {sum(ended)} of "
                  f"{len(ended)} complete; launches "
                  f"{ {k: n for k, n in want.items() if n} } (ticks, "
                  f"{replays} replays + {warmups} warm-ups, {cus} catch-up "
                  "ticks), all on the tensor-core route; captures "
                  f"{graphs.captures if graphs else 0}")
            if name == "constrained":
                out["host_s"] = times
    gargs.remove()
    hmask.remove()
    return out


def grammar_churn_gate(model, token_strs, prompts):
    """No recapture on an arena refresh or a compaction: an `LLMEngine` at
    decode_k 4 (the 5g config) serves a template request beside two
    unconstrained ones; a second grammar is loaded mid-run (its rows copied
    into the arena's device tables in place) and the next structured
    window checked replay vs eager; after the run drains, a grammar larger
    than the arena's free rows forces a compaction (every row rewritten)
    and the next structured window is checked again. The tables keep
    their addresses and every graph key used is captured once."""
    from paddle_tpu_torch.inference import LLMEngine

    eng = LLMEngine(model, _struct_cfg("fused k=4", token_strs))
    arena = eng.grammar_arena
    compactions = []
    compact = arena._compact

    def counted(keep):
        compactions.append(len(keep))
        return compact(keep)

    arena._compact = counted
    reqs = struct_requests(False)
    for p, r in zip(prompts[:3], (reqs[0], reqs[4], reqs[5])):
        eng.add_request(p, max_new_tokens=48, **r)
    while (False, True) not in (eng._fused_fn._graphs if eng._fused_fn
                                else {}):
        eng.step()
    fs = eng._fused_fn
    ptrs = [t.data_ptr() for t in arena.device_tables()]
    refreshes = arena.refreshes
    eng.add_request(prompts[3], max_new_tokens=32, eos_token_id=0,
                    grammar=r"[a-z]{3,8}!")
    first = _window_vs_eager(eng, fs, structured=True)
    refreshed = arena.refreshes - refreshes
    while eng.has_work():
        eng.step()
    used = arena.states_used
    eng.add_request(prompts[4], max_new_tokens=16, eos_token_id=0,
                    grammar=r"[0-9a-f]{200}")
    second = _window_vs_eager(eng, fs, structured=True)
    while eng.has_work():
        eng.step()
    same = [np.array_equal(s["emits"], s["eager"]) and s["pools"]
            for s in (first, second)]
    kept = [t.data_ptr() for t in arena.device_tables()] == ptrs and all(
        g.tables is None or [t.data_ptr() for t in g.tables] == ptrs
        for g in fs._graphs.values())
    print(f"grammar churn gate: a grammar loaded mid-run ({refreshed} "
          f"refresh of the device tables) and a compaction ({used} -> "
          f"{arena.states_used} states, compactions {compactions}): replay "
          f"vs eager equal after each {same}; tables kept their addresses "
          f"{kept}; captures {fs.captures} for graph keys "
          f"{sorted(fs._graphs)}")
    if not (all(same) and kept and refreshed >= 1 and compactions == [0]
            and fs.captures == len(fs._graphs)):
        raise AssertionError("grammar churn gate failed")


def struct_timings(model, token_strs, card):
    """Grammar compile seconds and arena costs at the full vocabulary, and
    the device µs of one mask (`profile_serve.mask_ms`: the expansion and
    the `where`, replayed from a CUDA graph) at S 8 (a fused window's
    rows) and T 40 (the verify's 8 x 5)."""
    from paddle_tpu_torch.inference import LLMEngine
    from paddle_tpu_torch.profile_serve import (OBJECT_A, SCHEMA, TEMPLATE,
                                                mask_ms)

    eng = LLMEngine(model, _struct_cfg("fused k=4", token_strs))
    arena = eng.grammar_arena
    t0 = time.perf_counter()
    arena.device_tables()
    torch.cuda.synchronize()
    alloc_ms = (time.perf_counter() - t0) * 1e3
    compiled = []
    for label, kw in (("template", dict(grammar=TEMPLATE)),
                      ("object", dict(grammar=OBJECT_A)),
                      ("schema", dict(json_schema=SCHEMA))):
        t0 = time.perf_counter()
        g = eng.compile_constraint(eos_token_id=0, **kw)
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        arena.load(g)
        load_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        arena.device_tables()
        torch.cuda.synchronize()
        compiled.append(f"{label} {g.n_states} states: compile "
                        f"{compile_s:.3f} s, arena load {load_ms:.2f} ms "
                        "(host), refresh "
                        f"{(time.perf_counter() - t0) * 1e3:.2f} ms")
    arena._compact(set(arena._loaded))          # every row rewritten
    t0 = time.perf_counter()
    arena.device_tables()
    torch.cuda.synchronize()
    full_ms = (time.perf_counter() - t0) * 1e3
    s8, t40 = mask_ms(arena, 8) * 1e3, mask_ms(arena, 40) * 1e3
    mb = sum(t.numel() * t.element_size() for t in arena.device_tables())
    print(f"structured timings at vocab {arena.vocab} ({card}): "
          + "; ".join(compiled) + f"; device tables {mb / 1e6:.1f} MB "
          f"({arena.n_states} states): first copy {alloc_ms:.2f} ms, full "
          f"refresh {full_ms:.2f} ms; mask device {s8:.1f} µs at S 8, "
          f"{t40:.1f} µs at T 40 (graph replay, events)")
    return dict(mask_us_s8=s8, mask_us_t40=t40, refresh_ms=full_ms)


def structured_phase(pa, card):
    """5g: structured decoding on the 5e target (and its draft) with the
    synthetic 50304-string vocabulary: the compile and mask timings, the
    constrained replay gates (greedy, sampled), the grammar churn gate,
    the four paths through `LLMEngine` (validity; fused, n-gram and draft
    against k=1; the fused run's unconstrained rows against an
    all-unconstrained run) and through `LLMServer` (launch gates, tok/s
    constrained vs unconstrained). Returns the bursts' numbers by path."""
    from paddle_tpu_torch.profile_serve import structured_token_strs

    target, draft = spec_pair()
    vocab = target.config.vocab_size
    token_strs = structured_token_strs(vocab)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, vocab, (n,)) for n in STRUCT_PROMPT_LENS]
    timings = struct_timings(target, token_strs, card)
    for sampled in (False, True):
        fused_gate(pa, target, "bfloat16", STRUCT_K, prompts, sampled,
                   token_strs)
    grammar_churn_gate(target, token_strs, prompts)
    runs = {path: struct_drive(target, _struct_cfg(path, token_strs, draft),
                               prompts, struct_requests(), token_strs,
                               f"structured {path}")
            for path in STRUCT_PATHS}
    every = [(i, i) for i in range(len(prompts))]
    for path in STRUCT_PATHS[1:]:
        struct_cross(f"{path} vs k=1", runs["k=1"], runs[path], every)
    plain = struct_drive(target, _struct_cfg("fused k=4", token_strs),
                         prompts, plain_requests(), token_strs, "plain")
    struct_cross("co-residency, fused k=4 mixed vs all unconstrained",
                 plain, runs["fused k=4"], [(i, i) for i in range(4, 8)])
    del runs, plain
    serve = {path: struct_serve(pa, target, path, token_strs, prompts, card,
                                draft if path == "draft" else None)
             for path in STRUCT_PATHS}
    gargs = serve["fused k=4"]["host_s"][0]
    hmask = serve["k=1"]["host_s"][1]
    print(f"structured tok/s, constrained vs unconstrained ({card}): "
          + "; ".join(f"{p} {serve[p]['constrained']['tok_s']:.1f} vs "
                      f"{serve[p]['unconstrained']['tok_s']:.1f}"
                      for p in STRUCT_PATHS)
          + f"; host {np.median(gargs) * 1e6:.1f} µs per _grammar_args "
          f"(fused k=4, median of {len(gargs)}), "
          f"{np.median(hmask) * 1e6:.1f} µs per host-tick mask (k=1, "
          f"median of {len(hmask)}); mask device "
          f"{timings['mask_us_s8']:.1f} µs at S 8, "
          f"{timings['mask_us_t40']:.1f} µs at T 40")
    return serve


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


def cross_quant_spec(pa):
    """f32 gpt_small (TF32 off) on 2 repetitive prompts. Card vs CPU: the
    first frontier logits on int8 and int4 pools agree with the CPU's
    (same kv_dtype) to max(1e-3, the CPU's own int8 / int4 vs f32
    difference). On the card: the n-gram engine (spec_k 4) gives the k=1
    engine's tokens on f32, int8 and int4 pools. The f32 and int4 n-gram
    runs are the main path of K2-float and K1/K2-int4: their launches are
    counted from 0 and must be > 0."""
    from paddle_tpu_torch.inference import LLMEngine, LLMEngineConfig
    from paddle_tpu_torch.text.models.gpt import GPTForCausalLM, gpt_small

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 matmuls
    torch.backends.cudnn.allow_tf32 = False
    cfg = gpt_small()
    gpu = GPTForCausalLM(cfg, dtype="float32", seed=77)
    cpu = GPTForCausalLM(cfg, device="cpu", dtype="float32", seed=0)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    prompts = repetitive_prompts(cfg.vocab_size, (40, 70), 77)
    ecfg = dict(num_slots=2, page_size=16, max_model_len=1024,
                token_budget=128)

    def first_logits(model, kv):
        eng = LLMEngine(model, LLMEngineConfig(kv_dtype=kv, **ecfg))
        for p in prompts:
            eng.add_request(p, max_new_tokens=1)
        eng.step()      # both prompts fit the budget: 1st tick samples both
        return eng.last_logits.float().cpu()

    ref = first_logits(cpu, "float32")
    for kv in ("int8", "int4"):
        lc = first_logits(cpu, kv)
        lg = first_logits(gpu, kv)
        err = (lg - lc).abs().max().item()
        own = (lc - ref).abs().max().item()
        tol = max(1e-3, own)
        print(f"cross-check gpt_small f32 {kv} KV card vs cpu: first frontier "
              f"logits max abs diff {err:.3e} (tol {tol:.3e} = max(1e-3, the "
              f"cpu's {kv} vs f32 diff {own:.3e}))")
        if not err <= tol:
            raise AssertionError(f"{kv}: card and cpu logits differ by "
                                 f"{err:.3e}")
    launches = {}
    for kv in ("float32", "int8", "int4"):
        runs = []
        for spec in ({}, {"spec_mode": "ngram", "spec_k": 4}):
            eng = LLMEngine(gpu, LLMEngineConfig(kv_dtype=kv, **ecfg, **spec))
            reqs = [eng.add_request(p, max_new_tokens=SERVE_NEW_TOKENS)
                    for p in prompts]
            pa.reset_launches()
            while eng.has_work():
                eng.step()
            torch.cuda.synchronize()
            runs.append([r.future.result() for r in reqs])
        n = dict(pa.launches)           # the n-gram run's
        suffix = "" if kv == "float32" else f"_{kv}"
        if not (n[f"rpa{suffix}"] > 0 and n[f"qblock{suffix}"] > 0
                and set(pa.tc_launches.values()) == {0}):
            raise AssertionError(f"{kv} + ngram run launched {n} "
                                 f"(tensor-core route {pa.tc_launches}; "
                                 "an f32 q takes the CUDA-core kernels)")
        launches[kv] = n
        same = all(np.array_equal(a, b) for a, b in zip(*runs))
        st = eng.stats
        print(f"spec vs k=1 on the card, gpt_small f32 {kv} KV, ngram spec_k "
              f"4: tokens {'identical' if same else 'DIFFER'} over "
              f"{len(prompts)} x {SERVE_NEW_TOKENS}; {st['ngram_windows']} "
              f"windows, proposed {st['ngram_proposed']} accepted "
              f"{st['ngram_accepted']}; launches {n}")
        if not same:
            raise AssertionError(f"{kv}: n-gram engine tokens differ from "
                                 "the k=1 engine's")
    return launches


def train(fa):
    """The training main path: counts of K3/K4/K5 launches over the timed
    steps, and the step's numbers."""
    from paddle_tpu_torch.observability.steptrace import model_flops
    from paddle_tpu_torch.profile_train import (H100_PEAK_BF16,
                                                bench_gpt_step, timed_steps)

    cfg, step, ids = bench_gpt_step(TRAIN_BATCH, TRAIN_SEQ)
    torch.cuda.reset_peak_memory_stats()
    warm, _ = timed_steps(step, ids, 3)
    fa.reset_launches()
    losses, wall = timed_steps(step, ids, TRAIN_STEPS)
    launches = dict(fa.launches)
    tc_launches = dict(fa.tc_launches)
    losses = warm + losses
    want = cfg.num_layers * TRAIN_STEPS
    if any(n != want for n in launches.values()):
        raise AssertionError(f"flash kernels launched {launches} times in "
                             f"{TRAIN_STEPS} steps; expected {want} each")
    if set(tc_launches) != set(launches) or any(
            n != want for n in tc_launches.values()):
        raise AssertionError(f"K3-K5 took the tensor-core route "
                             f"{tc_launches} times in {TRAIN_STEPS} steps; "
                             f"expected all {want} of each")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"train losses not finite and falling: "
                             f"{losses}")
    dt = wall / TRAIN_STEPS
    tokens = TRAIN_BATCH * TRAIN_SEQ
    mfu = model_flops(cfg, TRAIN_BATCH, TRAIN_SEQ) / dt / H100_PEAK_BF16
    print(f"train gpt_small b{TRAIN_BATCH}·s{TRAIN_SEQ} bf16 O1 AdamW: "
          f"{dt * 1e3:.3f} ms/step, {tokens / dt:.1f} tok/s, MFU {mfu:.4f} "
          f"(989 TFLOP/s bf16 peak), loss {losses[0]:.4f} → "
          f"{losses[-1]:.4f} over {len(losses)} steps, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
          f"{launches} = {cfg.num_layers} x {TRAIN_STEPS} each, tensor-core "
          f"route {tc_launches}")
    return launches


def train_cross_check():
    """One f32 TrainStep on the card and on the CPU from the same weights:
    the loss and every parameter gradient."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models.gpt import (GPTForCausalLM,
                                                  GPTPretrainingCriterion,
                                                  gpt_small)

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 matmuls
    torch.backends.cudnn.allow_tf32 = False
    cfg = gpt_small()
    gpu = GPTForCausalLM(cfg, dtype="float32", seed=7)
    cpu = GPTForCausalLM(cfg, device="cpu", dtype="float32", seed=0)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    ids = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 128))
    crit = GPTPretrainingCriterion()
    runs = []
    for model in (gpu, cpu):
        step = TrainStep(model, lambda m, x: crit(m(x), x),
                         AdamW(1e-4, parameters=model.parameters()))
        loss = step(torch.as_tensor(ids, device=model.device))
        runs.append((float(loss), {n: p.grad.float().cpu()
                                   for n, p in model.named_parameters()}))
    (lg, gg), (lc, gc) = runs
    worst, where, _ = _grad_diff(gc, gg)
    print(f"train cross-check gpt_small f32 b2·s128 card vs cpu: loss "
          f"{lg:.6f} vs {lc:.6f}, worst gradient error {worst:.3e} of its "
          f"max-abs ({where}; tol 1e-3) over {len(gc)} parameters")
    if not (abs(lg - lc) <= 1e-3 * abs(lc) and worst <= 1e-3):
        raise AssertionError("card and cpu train steps disagree")


def _grad_diff(ref, other):
    """Each gradient's max-abs difference over its max-abs: (the worst,
    its name, the median over the gradients)."""
    errs = {n: ((other[n] - r).abs().max()
                / r.abs().max().clamp(min=1e-30)).item()
            for n, r in ref.items()}
    where = max(errs, key=errs.get)
    return errs[where], where, float(np.median(list(errs.values())))


# bf16 O1 step, kernels vs plain versions: the loss (relative), each
# gradient's max-abs difference over its max-abs (the worst, and the
# median over the gradients)
BF16_LOSS_TOL = 1e-5
BF16_GRAD_TOL = 2e-2
BF16_GRAD_MEDIAN_TOL = 1e-2


def train_cross_check_bf16(fa):
    """One bf16 O1 TrainStep of gpt_small at b2·s256 on the card, twice
    from the same weights: through the kernels, and with the module's
    flash_forward / flash_bwd_dq / flash_bwd_dkv swapped for their plain
    versions (restored after). The losses and the parameter gradients
    agree within the BF16_* tolerances; the kernel run takes the
    tensor-core route."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models.gpt import (GPTForCausalLM,
                                                  GPTPretrainingCriterion,
                                                  gpt_small)

    cfg = gpt_small()
    kern = GPTForCausalLM(cfg, dtype="float32", seed=8)
    plain = GPTForCausalLM(cfg, dtype="float32", seed=0)
    plain.load_state_dict(kern.state_dict())
    ids = torch.as_tensor(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 256)), device=kern.device)
    crit = GPTPretrainingCriterion()

    def loss_fn(m, x):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            return crit(m(x), x)

    names = ("flash_forward", "flash_bwd_dq", "flash_bwd_dkv")
    kernels = {n: getattr(fa, n) for n in names}
    runs = []
    for model, swap in ((kern, False), (plain, True)):
        step = TrainStep(model, loss_fn,
                         AdamW(1e-4, parameters=model.parameters()))
        fa.reset_launches()
        try:
            if swap:
                for n in names:
                    setattr(fa, n, getattr(fa, n + "_plain"))
            loss = float(step(ids))
            torch.cuda.synchronize()
        finally:
            for n in names:
                setattr(fa, n, kernels[n])
        runs.append((loss, {n: p.grad.float() for n, p in
                            model.named_parameters()},
                     dict(fa.launches), dict(fa.tc_launches)))
    (lk, gk, nk, tk), (lp, gp, np_, _) = runs
    want = cfg.num_layers
    if not (set(nk.values()) == {want} and set(tk.values()) == {want}
            and set(np_.values()) == {0}):
        raise AssertionError(f"bf16 train cross-check: kernel run launched "
                             f"{nk} (tensor-core {tk}), plain run {np_}")
    worst, where, median = _grad_diff(gp, gk)
    loss_rel = abs(lk - lp) / abs(lp)
    print(f"train cross-check gpt_small bf16 O1 b2·s256 kernels vs plain "
          f"versions on the card: loss {lk:.6f} vs {lp:.6f} ({loss_rel:.2e} "
          f"relative; tol {BF16_LOSS_TOL:.0e}), gradient error of its "
          f"max-abs: worst {worst:.3e} ({where}; tol {BF16_GRAD_TOL:.0e}), "
          f"median {median:.3e} (tol {BF16_GRAD_MEDIAN_TOL:.0e}) over "
          f"{len(gp)} parameters; kernel run launches {nk}, tensor-core {tk}")
    if not (np.isfinite(lk) and loss_rel <= BF16_LOSS_TOL
            and worst <= BF16_GRAD_TOL and median <= BF16_GRAD_MEDIAN_TOL):
        raise AssertionError("bf16 train step through the kernels disagrees "
                             "with the plain versions")


def _kernel_row(name, route, source, replaces, launches, r):
    return {"name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch.ops.cuda_kernels import _build
    from paddle_tpu_torch.ops.cuda_kernels import flash_attention as fa
    from paddle_tpu_torch.ops.cuda_kernels import int8_gemm as ig
    from paddle_tpu_torch.ops.cuda_kernels import paged_attention as pa

    card = _card()
    t0 = time.perf_counter()
    _build.build(["paged_attention", "flash_attention", "int8_gemm"])
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc seconds per source: {_build.build_seconds})")
    build_report(_build, fa.TC_HEAD_DIMS)
    paged_launch_smem(pa)
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    kres = check_paged_attention(pa, flush)
    check_paged_tc_layouts(pa)
    check_qblock_tc_layouts(pa)
    fres = check_flash_attention(fa, flush)
    gres = check_int8_gemm(ig, flush)
    sampler_ms = check_prng(flush)
    del flush
    model = serve_model()
    vocab = model.config.vocab_size
    serve(pa, model)
    rng = np.random.default_rng(4321)
    random = [rng.integers(0, vocab, (n,)) for n in SERVE_PROMPT_LENS]
    serve_cross(pa, model, "bfloat16", False, random, "gpt_small bf16 KV")
    serve_cross(pa, model, "int8", False, random, "gpt_small int8 KV")
    spec = {kv: serve_spec(pa, model, kv)
            for kv in ("int8", "bfloat16", "int4")}
    repetitive = repetitive_prompts(vocab, SERVE_PROMPT_LENS, 4321)
    for kv in ("bfloat16", "int8"):
        serve_cross(pa, model, kv, True, repetitive,
                    f"gpt_small {kv} KV + ngram spec_k 4")
    fused = fused_phase(pa, model, random, card)
    print(f"sampler: {sampler_ms:.4f} ms a call ({card})")
    del model
    drafts = draft_phase(pa, random, card)
    weights = weights_phase(ig, pa, random, card)
    structured = structured_phase(pa, card)
    cross_check()
    cx_launches = cross_quant_spec(pa)
    fa_launches = train(fa)
    train_cross_check()
    train_cross_check_bf16(fa)
    # each kernel's launches come from the main-path run that drives it:
    # K1 on the bf16, int8 and int4 pools the fused phase's greedy
    # decode_k 8 bursts (ticks, warm-ups and graph replays; the replays'
    # share in "graph_launches"), K2 on the bf16 pool the bf16 + ngram
    # burst, on int8 and int4 their pools' + ngram bursts (bf16 q: all on
    # the tensor-core route), K1 and K2 on the f32 pool (f32 q, CUDA
    # cores) the cross phase's f32 n-gram run
    k1 = {kv: fused[(kv, 8)]["greedy"] for kv in ("bfloat16", "int8",
                                                   "int4")}
    graph = {kv: k1[kv]["graph"] for kv in k1}
    rows = [("ragged_paged_attention_tc", "rpa", "bfloat16",
             k1["bfloat16"]["launches"]),
            ("ragged_paged_attention", "rpa", "float32",
             cx_launches["float32"]["rpa"]),
            ("ragged_paged_attention_int8", "rpa_int8", "int8",
             k1["int8"]["launches"]),
            ("ragged_paged_attention_int4", "rpa_int4", "int4",
             k1["int4"]["launches"]),
            ("rpa_qblock", "qblock", "bfloat16",
             spec["bfloat16"]["qblock"]),
            ("rpa_qblock_f32", "qblock", "float32",
             cx_launches["float32"]["qblock"]),
            ("rpa_qblock_int8", "qblock_int8", "int8",
             spec["int8"]["qblock_int8"]),
            ("rpa_qblock_int4", "qblock_int4", "int4",
             spec["int4"]["qblock_int4"])]
    kernels = [_kernel_row(name, "cuda", pa.SOURCE, pa.REPLACES[key], n,
                           dict(kres[(key.split("_")[0], kind)],
                                library_ms=None))
               for name, key, kind, n in rows]
    for row, (_, key, kind, _) in zip(kernels, rows):
        # only pool kinds that a fused burst or a 5e draft burst ran get
        # these counts (the f32 pool runs neither)
        if key.startswith("rpa") and kind in graph:
            row["graph_launches"] = graph[kind]
        if key.startswith("rpa") and kind in drafts:
            # the draft bursts of 5e: K1 on the draft (catch-up ticks and
            # propose windows) and the target's ticks; the propose graph
            # replays' share
            row["draft_burst_launches"] = drafts[kind]["launches"]
            row["propose_graph_launches"] = drafts[kind]["graph"]
    # 5g's mixed (half constrained) bursts on the bf16 pool: K1 in the
    # fused k=4 burst, K2 in the n-gram burst
    kernels[0]["structured_burst_launches"] = structured["fused k=4"][
        "constrained"]["launches"]["rpa"]
    kernels[4]["structured_burst_launches"] = structured["ngram"][
        "constrained"]["launches"]["qblock"]
    # the int8 GEMM: one decoder layer's four linears at the decode tick
    # (T 8) and the mixed tick (T 256), bf16 x; launches from 5f's k=1
    # burst on the quantized model (48 per tick), and its decode_k 4
    # burst's (48 per tick, 48 x 4 per fused warm-up and replay)
    for key in GEMM_WIDTHS:
        for T in GEMM_TIMED_ROWS:
            r = gres[(key, T)]
            row = _kernel_row(f"{key}_linear_t{T}", "cuda", ig.SOURCE,
                              ig.REPLACES[key], weights[key][1]["launches"],
                              r)
            row["fused_burst_launches"] = weights[key][4]["launches"]
            row["bf16_addmm_ms"] = r["bf16_ms"]
            row["per_shape_ms"] = {shape: x["ms"]
                                   for shape, x in r["shapes"].items()}
            kernels.append(row)
    for name, r in fres.items():
        kernels.append(_kernel_row(name, "cuda", fa.SOURCE,
                                   fa.REPLACES[name], fa_launches[name], r))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
