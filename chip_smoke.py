#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (`paddle_tpu_torch`) on one
NVIDIA GPU. Run from the repository root with no arguments:

    python3 chip_smoke.py [--parent DIR]

`--parent DIR` (the root of an earlier checkout, e.g. a `git archive` of
the parent commit unpacked in a gitignored directory) also times that
tree's int8 GEMM in phase 3, in turns with this one's on the same inputs.

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
              bf16 x, int8 and packed int4 weights, its decode and wide
              kernels); fails if a tensor-core kernel has none.
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
              forward, dq and dk/dv (K3-K5) at the training paths' shapes
              (b·h 192, s 1024, d 64, bf16, causal: bench_gpt; b·h 32,
              s 2048: bench_gpt1p3b) and at smaller f32 /
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
              gpt_small's four linear shapes x T 1, 8, 13, 16, 17, 48, 256
              and 300 (every tiling of its planner), int8 and packed-int4
              weights, bf16 and f32 x, a bias and a zero row: the
              activation codes, steps and int32 accumulators equal, the
              output within 1 ulp; at T <= 16 the plan must fill the
              card (>= 132 blocks); the wrapper's count, one a linear on
              the plan's route, and the device launches of a linear (the
              kernels the profiler sees: the decode kernel alone at T <=
              16, the row quantize and the wide kernel above; its
              dropped records printed as a shortfall); timed at T 8, 48
              and 256 (bf16 x)
              beside its bound (weight bytes, or int8 operations at 1979
              TOPS), `torch._int_mm` on the same codes (T > 16) and the
              float layer's bf16 `torch.addmm`, with the host µs per call
              with and without a prepared weight.
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
              K1's wrapper counting 12 x k launches in the replay, all on
              the tensor-core route, the profiler seeing `rpa_tc_kernel`,
              no other paged kernel and a `cudaGraphLaunch`
              (`_paged_records`: the profiler drops a record now and
              then, so its shortfall is printed, not failed); (b)
              `LLMEngine` at decode_k
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
              and sampled, K1's wrapper counting 5 launches in the
              replay on the tensor-core route and the profiler seeing
              `rpa_tc_kernel` and a graph launch (`_paged_records`); (b)
              `LLMEngine` with the draft
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
              the int8 GEMM 48 per tick (wide route) and 48 x 4 per
              fused warm-up and replay (decode route), K1 as in 5d; a
              decode_k 4 window's graph replay vs its eager run,
              byte-equal, the wrapper counting 48 x 4 decode-route
              linears in the replay and the profiler seeing the decode
              kernel and no other GEMM kernel; the k=1 engine through the
              GEMM vs
              through its plain version: logits within
              SERVE_BF16_LOGIT_TOL, tokens equal but at near-ties; tok/s,
              device ms per fused iteration at decode_k 4 beside the bf16
              model's, and the weight bytes saved.
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
5h. fleet   — the serving fleet on the serve phase's model, bf16 KV,
              decode_k 8, on bench.py's own fleet traffic (`fleet_phase`):
              `fleet_prefix` (bench_llm_fleet: 24 paced requests under one
              192-token system prompt through `LLMServer` with the prefix
              cache off, then on: tokens equal but at near-ties, prefill
              tokens and client TTFT p50 / p99 of both, the prefill count
              of an all-queued run equal to the CPU engine's);
              `fleet_wire` (prefill_only -> pack -> unpack -> import of a
              500-token prompt on bf16, int8 and int4 pools: the imported
              pages byte-equal to the export, scale planes included,
              tokens equal but at near-ties; export and import ms and MB a
              request); `fleet_router` (bench_llm_fleet_multi's traffic
              through one server and a 2-replica `FleetRouter`: affinity
              > 0.5, tokens equal, K1 counted on both replicas; a seeded
              replica kill: every request resolved, requeues > 0, tokens
              equal the unkilled run's; the prefill storm through a
              prefill + decode router); `fleet_capture` (a window captured
              while another replica's thread steps: replay vs eager
              byte-equal).
5i. tier    — the KV tier and chat sessions on bench.py:2237's
              `bench_kv_tier_ab` traffic (`profile_serve.kv_tier_side`: 8
              sessions x 4 turns, each prompt the previous turn's output
              plus 24 seeded tokens, 16 new tokens a turn; num_slots 2,
              page_size 16, token_budget 64, max_model_len 256, 40 pages,
              the prefix cache on), once without the tier and once with
              it (256 MiB RAM, a disk tier in a temporary directory) and
              session ids, bf16 KV, the counts set to 0 just before each:
              greedy tokens equal across the two, pages prefetched, K1 12
              per tick all on the tensor-core route; prints the prefill
              tokens off / on and their reduction, the RAM / disk hits,
              host ms per spilled and per prefetched page, the TTFT
              medians of first and of returning turns off / on. A spill
              -> prefetch round trip of one prompt's
              blocks on bf16, int8 and int4 pools: the re-exported prefix
              byte-equal (every pool and scale-plane byte). A decode_k 4
              session burst: after turn 2's admission prefetched its
              history into the pools in place, the next window's graph
              replay vs its eager run byte-equal, K1 12 x 4 in the
              replay, no new capture.
5j. generate — `GPTForCausalLM.generate` on bench.py:498's
              `bench_generate` arm (gpt_small, batch 8, 128-token
              prompts, 128 new tokens, greedy) in f32 and in bf16: tok/s
              and ms per token-step; one step's CUDA graph replay vs its
              eager run from the same static cache and inputs, byte-equal
              (logits and every cache byte), the device ms of both beside
              the bound (weights and the whole cache read once); the f32
              tokens (TF32 off) against `LLMEngine`'s k=1 tokens on the
              same prompts, equal but at near-ties (top two within
              1e-3); a ragged left-padded batch against each row alone.
5k. server  — `InferenceServer` on bench.py:532's `bench_serving` arm:
              the MLP 256 -> 1024 -> 1024 -> 64 with ReLUs (seeded
              weights), max_batch_size 64, max_delay_ms 2.0, 8 client
              threads x 64 requests: every row within 1e-5 of its max-abs
              of the module's own forward (TF32 off); req/s and the mean
              batch size.
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
8b. train 1.3B — bench.py:378's bench_gpt1p3b on the port
              (`profile_train.bench_gpt1p3b_step`): gpt_1p3b with
              per-layer recompute at b1·s2048, `amp.decorate` O2 (bf16
              parameters, f32 Adam moments), `AdamW(1e-4)`, the fused head
              under `auto_cast(level="O2")`, `TrainStep`; 2 warm-up steps,
              then 5 timed ones with the flash counts set to 0 just
              before: K3 2 x 24 launches a step (forward and each layer's
              recompute), K4 and K5 24 each, all on the tensor-core route;
              every loss finite and the last below the first; every
              parameter bf16 and every Adam moment f32. Prints ms/step,
              tok/s, MFU over model_flops at 989 TFLOP/s, peak memory and
              the optimizer update's device ms a step (one profiled step,
              the kernels under "optimizer.step").
8c. remat   — gpt_small at b16·s1024, bf16 O1, `TrainStep(remat=...)`
              for False, True, dots_saveable and everything_saveable: 2
              warm-up steps, then 3 timed; the first step's loss and every
              gradient equal across the four within 1e-6 of each
              gradient's max-abs. Prints ms/step, peak memory and K3
              launches a step per policy.
8d. steptrace A/B — bench.py:1876's bench_steptrace_overhead_ab on the
              port: a 4-layer 64-wide GPT (vocab 256) at b8·s32, 30 steps
              a run, telemetry full and metrics interleaved F/M/F/M; the
              losses bit-identical across the four runs, and each traced
              step's phases sum to its wall time. Prints the full /
              metrics ratio of the best runs (the reference's bar: 1.05)
              and `phase_summary()`.
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
10b. train cross O2 — gpt_1p3b's width with 2 layers, b1·s2048, O2
              (decorate + auto_cast), per-layer recompute: 3 steps of
              `AdamW(LinearWarmup(CosineAnnealingDecay(1e-4, 100), 2, 0,
              1e-4))` with `ClipGradByGlobalNorm(1.0)` through the kernels
              (all on the tensor-core route) and from the same weights
              with K3-K5 swapped for their plain versions: the losses,
              and the f32 loss sums before O2's divide rounds them,
              within 1e-5 relative; the learning rates equal to their
              float recomputation; step 1's bf16 gradients within phase
              10's bounds, their global norms within 1e-2 relative, the
              clip's output norm min(norm, 1) within 1e-3 (and 0.3 of the
              norm under a clip at 0.3 of the norm), and the
              warm-up's lr-0 update leaving every parameter byte-equal;
              the parameters' change over the 3 steps within 0.25 of the
              plain run's in L2. Then two `GradScaler` steps at scale
              1e38 on the kernel model: both skipped (parameters
              byte-equal), the scale halved after the second
              (decr_every_n_nan_or_inf 2).

The line before the last is {"kernels": [...]}: each route of K1 and K2
(bf16, f32, int8, int4 pools), K3-K5 and the int8 GEMM (int8 and int4
weights, a row per route: the decode kernel at T 8, the wide route at
T 256 with its T 48 times beside; one layer's four linears), with its
launches from the main-path run that drives it (K1 on bf16, int8 and
int4 pools: the greedy decode_k 8 burst of phase 5d, whose graph
replays' share is "graph_launches", plus the 5e draft burst's launches
and its propose graph replays' share, and on the bf16 pool 5g's mixed
fused burst's (K1) and n-gram burst's (K2) as
"structured_burst_launches", and 5i's tier-on session burst (bf16)
and spill -> prefetch round trips (int8, int4) as
"tier_burst_launches"; the GEMM's decode route: 5f's decode_k 4
burst, its wide route: 5f's k=1 burst, each route's count in both
bursts as "burst_launches"; K3-K5 also phase 8b's launches as
"train_1p3b_launches" and their times at its shape as "shape_1p3b");
the last line is
{"ok": true, "device": {...}}. Exits non-zero without printing a result
when no CUDA device is present.
"""
import contextlib
import gc
import json
import math
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
# head_dim and pool kind (1 bf16, 8 int8, 4 int4), the int8 GEMM's two
# (decode, T <= 16, and wide: 256 threads each) on x's type and the
# weight's width (int8, or packed int4)
TC_KERNELS = {"flash_attention": ("fa_fwd_tc_kernel", "fa_bwd_dq_tc_kernel",
                                  "fa_bwd_dkv_tc_kernel"),
              "paged_attention": ("rpa_tc_kernel", "rpa_tc_qblock_kernel"),
              "int8_gemm": ("w8a8_gemm_kernel", "w8a8_gemm_wide_kernel")}
TC_PAGED_KINDS = (1, 8, 4)
TC_THREADS = 128
TC_THREADS_OF = {"w8a8_gemm_kernel": 256, "w8a8_gemm_wide_kernel": 256}

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
    m = re.search(r"((?:fa_|rpa_tc_)\w*?kernel|w8a8_gemm\w*?kernel|"
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
    int8 GEMM's two at each x type and weight width."""
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
    GEMM's kernels; fails when a tensor-core kernel (at each of
    `head_dims`, and each pool kind for the paged ones; each x type and
    weight width for the GEMM's two) has no tensor-core instruction."""
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
            base = label.split("<")[0]
            if base in TC_KERNELS[lib] and r.get("regs"):
                threads = TC_THREADS_OF.get(base, TC_THREADS)
                extra = (f", registers allow "
                         f"{_blocks_by_registers(r['regs'], threads)} "
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


def _pool_key(pa, kv_dtype, qb=0):
    """The paged wrapper's counter key of K1 (K2 with `qb`) on a
    `kv_dtype` pool."""
    return pa._launch_key(kv_dtype if kv_dtype in ("int8", "int4") else "",
                          qb)


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
# rows: 1-16 take the decode tiling (2 token tiles a block), 17 and more
# the wide one; 8 is the decode tick, 48 the fleet's token budget, 256
# the mixed tick, 300 crosses a 64-token tile's edge, 13 / 17 are odd
GEMM_ROWS = (1, 8, 13, 16, 17, 48, 256, 300)
GEMM_TIMED_ROWS = (8, 48, 256)
GEMM_WIDTHS = {"w8a8": False, "w4a8": True}    # launch key -> int4
GEMM_LAUNCH_REPS = 3
SMS = 132
# the kernels each route of the int8 GEMM launches, once a linear
GEMM_ROUTE_KERNELS = {"decode": ("w8a8_gemm_kernel",),
                      "wide": ("quantize_rows_kernel",
                               "w8a8_gemm_wide_kernel")}


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
    """x [T, K] on the card; row 3 (where there is one) is all zeros (a
    zero row's step is the floor 1e-8 / 127 and its codes 0)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((T, K), generator=g) * 2
    if T > 3:
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


def _plan_str(p):
    return (f"{'decode' if p.decode else 'wide'} route, {p.splits} k-ranges "
            f"of {p.per} steps, {p.blocks} blocks, {p.smem} B shared "
            f"memory, {p.launches} launch{'es' if p.launches > 1 else ''}")


def _gemm_kernel_of(key):
    """The GEMM kernel a profiler record names, or None (no name is a
    part of another: "w8a8_gemm_kernel" is none of
    "w8a8_gemm_wide_kernel")."""
    names = [n for ns in GEMM_ROUTE_KERNELS.values() for n in ns
             if n in key]
    return names[0] if names else None


def _gemm_records(rows, route, linears, label, only_gemm=False):
    """Which GEMM kernels the profiler saw, by one rule for every gate:
    the exact count of linears comes from the wrapper's counter
    (`linears`, counted on `route`); the profiler's CUDA records (`rows`,
    `key_averages()`) must show each of the route's kernels, no kernel of
    the other route and (with `only_gemm`) no kernel that is not the
    GEMM's, and no kernel more than once a linear. The profiler drops a
    record now and then, so fewer is printed as its shortfall, not
    failed. Returns {kernel: records} of the route."""
    from torch.autograd import DeviceType

    seen, foreign = {}, {}
    for e in rows:
        if e.device_type != DeviceType.CUDA:
            continue
        name = _gemm_kernel_of(e.key)
        if name is None:
            foreign[e.key] = foreign.get(e.key, 0) + e.count
        else:
            seen[name] = seen.get(name, 0) + e.count
    want = GEMM_ROUTE_KERNELS[route]
    short = {n: linears - seen.get(n, 0) for n in want
             if seen.get(n, 0) < linears}
    print(f"{label}: {linears} linears on the {route} route (the wrapper's "
          f"count); the profiler saw " + ", ".join(
              f"{n} {c}" for n, c in sorted(seen.items()))
          + (f" (shortfall {short})" if short else " (none short)")
          + (f", other kernels {sum(foreign.values())}" if foreign else ""))
    if (set(seen) != set(want) or any(c > linears for c in seen.values())
            or (only_gemm and foreign)):
        raise AssertionError(f"{label}: the GEMM kernels seen {seen}, "
                             f"others {foreign}; want {want}, at most "
                             f"{linears} each")
    return seen


# csrc/paged_attention.cu's kernels: K1's tensor-core route launches the
# plan, the split-KV attention and the merge kernel
PAGED_TC_K1 = ("rpa_tc_plan_kernel", "rpa_tc_kernel", "rpa_tc_merge_kernel")
_PAGED_NAME = re.compile(r"\b(rpa_\w*kernel)\b")


def _paged_records(rows, counted, key, want, label):
    """The paged gates' rule, the GEMM's (`_gemm_records`): the exact
    count of K1 launches comes from the paged wrapper's counters across
    the replay (`counted`: {"launches": {key: n}, "tc_launches": {...}},
    the non-zero deltas; a replay adds back what its capture counted),
    which must be `want` on `key`, all on the tensor-core route, and
    nothing else. The profiler's CUDA records (`rows`, `key_averages()`)
    say only which kernels ran: `rpa_tc_kernel`, no paged kernel outside
    K1's tensor-core route, and a `cudaGraphLaunch`. It drops a record
    now and then, so fewer `rpa_tc_kernel` records than launches are
    printed as its shortfall, not failed. Returns (ok, the printed
    text)."""
    from torch.autograd import DeviceType

    seen, graphs = {}, 0
    for e in rows:
        if "cudaGraphLaunch" in e.key:
            graphs += e.count
        if e.device_type != DeviceType.CUDA:
            continue
        m = _PAGED_NAME.search(e.key)
        if m:
            seen[m.group(1)] = seen.get(m.group(1), 0) + e.count
    tc = seen.get("rpa_tc_kernel", 0)
    foreign = {n: c for n, c in seen.items() if n not in PAGED_TC_K1}
    exact = ({key: want} == counted["launches"] == counted["tc_launches"])
    ok = (exact and tc >= 1 and tc <= want and not foreign
          and graphs >= 1)
    text = (f"{label}: the wrapper counted {counted['tc_launches'] or 'none'}"
            f" on the tensor-core route, {counted['launches'] or 'none'} in "
            f"all (want {{{key!r}: {want}}}); the profiler saw "
            + (", ".join(f"{n} {c}" for n, c in sorted(seen.items()))
               or "no paged kernel")
            + (f" (shortfall {want - tc})" if tc < want else
               " (none short)")
            + f", {graphs} cudaGraphLaunch")
    return ok, text


def _mean_of(r, field):
    return float(np.mean([x[field] for x in r["shapes"].values()]))


def load_parent(root):
    """The int8 GEMM module of the checkout at `root` (e.g. a `git
    archive` of an earlier commit unpacked in a gitignored directory),
    imported as package `parent_pt`: its own kernels, built into its own
    tree at first use."""
    import importlib
    import importlib.util

    pkg = os.path.join(os.path.abspath(root), "paddle_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "parent_pt", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_pt"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("parent_pt.ops.cuda_kernels.int8_gemm")


def check_int8_gemm(ig, flush, parent=None):
    """The int8 GEMM (`int8_gemm.w8a8_linear`) against its plain version on
    the card at gpt_small's four linear shapes x GEMM_ROWS (every tiling
    of `int8_gemm.plan`), int8 and packed-int4 weights, bf16 and f32 x,
    with a bias and a zero row: the activation codes, the steps and the
    int32 accumulators equal, the outputs within 1 ulp of x's dtype; at
    T <= 16 the plan has at least 132 blocks. The device launches a
    linear: the wrapper counts each call once on the plan's route, and
    the profiler (`_gemm_records`) must see that route's kernels and no
    other over the timed calls: 1 at T <= 16, 2 above. Times at
    GEMM_TIMED_ROWS with bf16 x (the serving type): kernel, plain,
    bound, `torch._int_mm` on the same codes where its shape rules
    allow (T > 16), the float layer's bf16 `torch.addmm`, and host µs
    per call with the weight prepared (the module's path) and checked
    at each call. With `parent` (`load_parent`'s module, an earlier
    tree's GEMM) that kernel runs on the same inputs, its output equal,
    timed in turns (parent, this, this, parent) in the same process.
    Returns {(key, T): numbers summed over the four shapes} (one decoder
    layer's linears), each with its per-shape numbers."""
    res, timed = {}, []
    for key, int4 in GEMM_WIDTHS.items():
        for si, (K, N) in enumerate(GEMM_SHAPES):
            wq, ws, wb, q = _gemm_weight(K, N, int4, seed=si)
            prep = ig.prepare(wq, ws, int4)
            worst, worst_abs = 0.0, 0.0
            for T in GEMM_ROWS:
                p = ig.plan(T, K, N, int4)
                if T <= 16 and p.blocks < SMS:
                    raise AssertionError(f"{key} [{T}, {K}] x [{K}, {N}]: "
                                         f"{_plan_str(p)}, under {SMS}")
                for dt in (torch.bfloat16, torch.float32):
                    x = _gemm_x(T, K, dt, seed=T)
                    bias = (torch.randn((N,), device="cuda") * 0.1).to(dt)
                    ig.reset_launches()
                    out, codes, steps, acc = ig.w8a8_linear(
                        x, wq, ws, bias, int4, return_parts=True)
                    moved = {k: n for k, n in ig.launches.items() if n}
                    routes = {k: n for k, n in ig.route_launches.items()
                              if n}
                    route = "decode" if p.decode else "wide"
                    ref, rcodes, rsteps, racc = ig.w8a8_linear_plain(
                        x, wq, ws, bias, int4, return_parts=True)
                    torch.cuda.synchronize()
                    label = f"{key} [{T}, {K}] x [{K}, {N}] {str(dt)[6:]}"
                    ulps = _ulps(out, ref)
                    if not (moved == {key: 1}
                            and routes == {f"{key}_{route}": 1}
                            and torch.equal(codes, rcodes)
                            and torch.equal(steps, rsteps)
                            and torch.equal(acc, racc) and ulps <= 1
                            and torch.isfinite(out).all()):
                        raise AssertionError(
                            f"{label} ({_plan_str(p)}): launches {moved}, "
                            f"by route {routes}, "
                            f"codes equal {torch.equal(codes, rcodes)}, steps"
                            f" equal {torch.equal(steps, rsteps)}, "
                            f"accumulators equal {torch.equal(acc, racc)}, "
                            f"output off by {ulps} ulp")
                    worst = max(worst, ulps)
                    worst_abs = max(worst_abs, (out.float() - ref.float())
                                    .abs().max().item())
            print(f"int8 GEMM {key} [T, {K}] x [{K}, {N}]: codes, steps and "
                  f"int32 accumulators equal to the plain version's, output "
                  f"within {worst:g} ulp at T {', '.join(map(str, GEMM_ROWS))}"
                  f" (bf16 and f32 x); plans: " + "; ".join(
                      f"T {T}: {_plan_str(ig.plan(T, K, N, int4))}"
                      for T in (8, 17, 48, 256)))
            for T in GEMM_TIMED_ROWS:
                x = _gemm_x(T, K, torch.bfloat16, seed=T)
                bias = torch.zeros((N,), dtype=torch.bfloat16, device="cuda")
                codes = ig.quantize_rows_plain(x)[0]

                def kernel(x=x, wq=wq, ws=ws, bias=bias, int4=int4,
                           prep=prep):
                    return ig.w8a8_linear(x, wq, ws, bias, int4,
                                          prepared=prep)

                par = {}
                if parent is not None:
                    def old(x=x, wq=wq, ws=ws, bias=bias, int4=int4):
                        return parent.w8a8_linear(x, wq, ws, bias, int4)

                    if not torch.equal(old(), kernel()):
                        raise AssertionError(
                            f"{key} [{T}, {K}] x [{K}, {N}]: the parent "
                            "tree's GEMM and this one's outputs differ")
                    turns = [_median_ms(f, flush)
                             for f in (old, kernel, kernel, old)]
                    ms = (turns[1] + turns[2]) / 2
                    par = dict(parent_ms=(turns[0] + turns[3]) / 2,
                               turns=turns, parent_host_us=_host_us(old))
                else:
                    ms = _median_ms(kernel, flush)
                plain_ms = _median_ms(lambda: ig.w8a8_linear_plain(
                    x, wq, ws, bias, int4), flush)
                lib_ms = (_median_ms(lambda: torch._int_mm(codes, q), flush)
                          if T > 16 else None)
                bf16_ms = _median_ms(lambda: torch.addmm(bias, x, wb), flush)
                bound_ms, bound_by = _gemm_bound(T, K, N, int4, x.dtype)
                host_us = _host_us(kernel)
                host_checked_us = _host_us(lambda: ig.w8a8_linear(
                    x, wq, ws, bias, int4))
                timed.append((T, kernel))
                r = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bf16_ms=bf16_ms, bound_ms=bound_ms,
                         bound_by=bound_by, max_abs_err=worst_abs,
                         host_us=host_us, host_checked_us=host_checked_us,
                         blocks=ig.plan(T, K, N, int4).blocks, **par)
                print(f"int8 GEMM {key} [{T}, {K}] x [{K}, {N}], bf16 x: "
                      f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                      f"{bound_ms:.4f} ms ({bound_by}), "
                      f"{100 * bound_ms / ms:.1f}% of bound, torch._int_mm "
                      + (f"{lib_ms:.4f} ms" if lib_ms is not None else
                         "n/a (needs more than 16 rows)")
                      + f", bf16 addmm of the float layer {bf16_ms:.4f} ms; "
                      f"host {host_us:.1f} µs a call (weight prepared), "
                      f"{host_checked_us:.1f} µs (checked each call)"
                      + (f"; the parent tree's kernel {par['parent_ms']:.4f}"
                         f" ms (turns parent, this, this, parent: "
                         f"{', '.join(f'{t:.4f}' for t in par['turns'])}), "
                         f"host {par['parent_host_us']:.1f} µs a call"
                         if par else ""))
                agg = res.setdefault((key, T), dict(
                    ms=0.0, plain_ms=0.0, library_ms=0.0 if T > 16 else None,
                    bf16_ms=0.0, bound_ms=0.0, bound_by=bound_by,
                    max_abs_err=0.0, shapes={}))
                for f in ("ms", "plain_ms", "bf16_ms", "bound_ms",
                          "parent_ms"):
                    if f in r:
                        agg[f] = agg.get(f, 0.0) + r[f]
                agg["max_abs_err"] = max(agg["max_abs_err"], worst_abs)
                if lib_ms is not None:
                    agg["library_ms"] += lib_ms
                agg["shapes"][f"{K}x{N}"] = r
    # device launches a linear by row count: one profiler session over
    # GEMM_LAUNCH_REPS rounds of the timed calls at that T, the wrapper's
    # counts set to 0 just before: every call on the plan's route, and
    # only that route's kernels on the card (`_gemm_records`)
    from torch.profiler import ProfilerActivity, profile

    per_linear = {}
    for T in GEMM_TIMED_ROWS:
        calls = [fn for t, fn in timed if t == T] * GEMM_LAUNCH_REPS
        route = "decode" if T <= ig.DECODE_ROWS else "wide"
        torch.cuda.synchronize()
        ig.reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for fn in calls:
                fn()
            torch.cuda.synchronize()
        counted = {k: n for k, n in ig.route_launches.items() if n}
        if sum(counted.values()) != len(calls) or any(
                not k.endswith(route) for k in counted):
            raise AssertionError(f"T {T}: the wrapper counted {counted} "
                                 f"for {len(calls)} linears on the {route} "
                                 "route")
        seen = _gemm_records(prof.key_averages(), route, len(calls),
                             f"int8 GEMM at T {T}", only_gemm=True)
        per_linear[T] = len(seen)
        print(f"int8 GEMM at T {T}: {per_linear[T]} device launch"
              f"{'es' if per_linear[T] > 1 else ''} a linear "
              f"({', '.join(sorted(seen))})")
    for (key, T), r in res.items():
        r["device_launches_per_linear"] = per_linear[T]
        print(f"int8 GEMM {key}, one layer's four linears at T {T}: kernel "
              f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bf16 addmm {r['bf16_ms']:.4f} ms"
              + (f", torch._int_mm {r['library_ms']:.4f} ms"
                 if r["library_ms"] is not None else "")
              + (f", the parent tree's kernel {r['parent_ms']:.4f} ms "
                 f"({r['parent_ms'] / r['ms']:.2f}x)" if "parent_ms" in r
                 else "")
              + f"; host {_mean_of(r, 'host_us'):.1f} µs a call (checked "
              f"each call {_mean_of(r, 'host_checked_us'):.1f}"
              + (f"; parent {_mean_of(r, 'parent_host_us'):.1f}"
                 if "parent_ms" in r else "") + ")")
    return res


# ---------------------------------------------------------------- K3-K5

# the training path's attention call: gpt_small at b16·s1024 → b·h 192
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 16, 1024, 10
FA_MAIN = dict(bh=TRAIN_BATCH * 12, s=TRAIN_SEQ, d=64,
               dtype=torch.bfloat16, causal=True, lens=None, b=TRAIN_BATCH)
# phase 8b's call: gpt_1p3b at b1·s2048 → b·h 32, head_dim 2048 / 32
FA_1P3B = dict(bh=32, s=2048, d=64, dtype=torch.bfloat16, causal=True,
               lens=None, b=1)
# smaller cases: f32, ragged seq (not a multiple of the 64-row tile),
# non-causal, kv_lens with a 0 row, seq_k != seq_q (`sk`), and the 32-
# and 16-row tile configs (head_dim 96, 256); bf16 ones on the edges of
# the tensor-core route (head_dim 64 / 128) and one bf16 case off it
# (head_dim 32)
FA_CASES = [
    FA_MAIN,
    FA_1P3B,
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


def _fa_library_ms(x, flush, case):
    """torch's own fused attention on the same inputs ([b, h, s, d]): its
    causal forward, and its backward (dq, dk, dv in one call) as the
    autograd node that forward recorded, called directly — whichever
    backend SDPA picked, and without the autograd engine's host time in
    the timed window."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, h = case["b"], case["bh"] // case["b"]
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


def _fa_times(fa, case, x, lens, flush, res):
    """Kernel, plain and library times of K3-K5 on one case's inputs,
    beside the bound, into res[name]."""
    q, k, v, dout = x
    causal = case["causal"]
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
    fwd_lib, bwd_lib = _fa_library_ms(x, flush, case)
    for name, (kernel, plain) in calls.items():
        r = res[name]
        r["ms"] = _median_ms(kernel, flush)
        r["plain_ms"] = _median_ms(plain, flush, reps=10)
        r["bound_ms"], r["bound_by"] = _fa_bound(name, case)
        r["library_ms"] = fwd_lib if name == "flash_forward" else bwd_lib
        print(f"{name} bf16 b·h {case['bh']} s {case['s']} d "
              f"{case['d']} causal: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms"
              f"{'' if name == 'flash_forward' else ' (dq+dk+dv)'}, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound, "
              f"{r['ms'] / r['library_ms']:.2f}x the library")


def check_flash_attention(fa, flush):
    """K3/K4/K5 against their plain versions on the card for every case
    of FA_CASES: out, dq, dk, dv row by row (FA_TOL of each row's
    max-abs) and on average (FA_MEAN_TOL), lse absolute (FA_LSE_TOL);
    rows with kv_len 0 must be exact zeros. Times the main paths' cases
    (bench_gpt's FA_MAIN, bench_gpt1p3b's FA_1P3B: kernel, plain,
    library) beside the bound and returns their numbers by kernel, the
    FA_1P3B ones under "shape_1p3b"."""
    res, timed = {}, {}
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
        if case is FA_MAIN or case is FA_1P3B:
            timed[id(case)] = {
                "flash_forward": dict(max_abs_err=max(errs["out"],
                                                      errs["lse"])),
                "flash_bwd_dq": dict(max_abs_err=errs["dq"]),
                "flash_bwd_dkv": dict(max_abs_err=max(errs["dk"],
                                                      errs["dv"]))}
            _fa_times(fa, case, x, lens, flush, timed[id(case)])
        del got, ref
    res = timed[id(FA_MAIN)]
    for name, r in res.items():
        r["shape_1p3b"] = dict(timed[id(FA_1P3B)][name],
                               shape=[FA_1P3B["bh"], FA_1P3B["s"],
                                      FA_1P3B["d"]])
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
    """Eager K1 calls on a window's capture stream, against `model`'s
    pools `kv` / `kv_scales`, at 4096 rows and doubling until the
    stream's tensor-core workspace is outgrown and replaced (a stream
    may come with a workspace an earlier, dead owner grew): a graph that
    had not kept its own would now hold a freed address."""
    H = model.config.num_heads
    D = model.config.hidden_size // H
    sc = kv_scales or [None, None]
    before = [w.data_ptr() for w in pa.stream_workspaces(stream.cuda_stream)]
    T = 4096
    while True:
        q = torch.zeros((T, H, D), dtype=torch.bfloat16, device="cuda")
        z = torch.zeros((T,), dtype=torch.int32, device="cuda")
        pt = torch.zeros((eng.num_slots, eng.pages_per_seq),
                         dtype=torch.int32, device="cuda")
        with torch.cuda.stream(stream):
            pa.ragged_paged_attention(q, kv[0], kv[1], pt, z, z,
                                      k_scales=sc[0], v_scales=sc[1])
        torch.cuda.synchronize()
        after = [w.data_ptr()
                 for w in pa.stream_workspaces(stream.cuda_stream)]
        if after != before or T >= 1 << 16:
            return
        T *= 2


def _window_vs_eager(eng, fs, structured=False, profiled=False,
                     counts=()):
    """Step `eng` until its next fused window (with `structured`, its next
    window whose rows include a constrained one): the window runs eagerly
    on copies of the pools and scale planes from the same staged inputs,
    then as the graph replay (under the profiler with `profiled`). Returns
    the eager and replayed emits, whether every pool byte is equal, the
    profile, and what the replay added to each of the launch counts
    `counts` (wrappers' dicts, set to 0 just before the replay): a list
    of their non-zero entries, in order."""
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
        for c in counts:
            for name in c:
                c[name] = 0
        with (profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) if profiled
              else contextlib.nullcontext()) as prof:
            emits = run(kv, kv_scales, smp, tables)
            torch.cuda.synchronize()
        seen["counted"] = [{k: n for k, n in c.items() if n}
                           for c in counts]
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
               token_strs=None, gemm=False):
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
    its picks. With `gemm` (a weight-quantized model) the int8 GEMM's
    wrapper must count 4 x 12 x k linears on its decode route in the
    replay, and the profiler see that route's kernel and no other GEMM
    kernel (`_gemm_records`); without, no GEMM kernel. K1's 12 x k
    launches are counted by its wrapper, the profiler asked only which
    kernels ran (`_paged_records`). Returns the engine (its graphs still
    captured)."""
    from torch.autograd import DeviceType

    from paddle_tpu_torch.inference import LLMEngine
    from paddle_tpu_torch.ops.cuda_kernels import int8_gemm as ig

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
    seen = _window_vs_eager(
        eng, fs, structured, profiled=True,
        counts=(ig.route_launches, pa.launches, pa.tc_launches))
    gemm_counted, paged_n, paged_tc = seen["counted"]
    rows = seen["prof"].key_averages()
    layers = model.config.num_layers
    label = (f"{kv_dtype} k={k}{' sampled' if sampled else ''}"
             f"{' structured' if structured else ''}")
    linears = 4 * layers * k
    if gemm:
        label += " int8-GEMM weights"
        counted = list(gemm_counted.items())
        gemm_ok = (len(counted) == 1 and counted[0][0].endswith("_decode")
                   and counted[0][1] == linears)
        _gemm_records(rows, "decode", linears,
                      f"fused gate {label}, the replay")
    else:
        gemm_ok = not gemm_counted and not any(
            _gemm_kernel_of(e.key) for e in rows
            if e.device_type == DeviceType.CUDA)
    paged_ok, paged_text = _paged_records(
        rows, {"launches": paged_n, "tc_launches": paged_tc},
        _pool_key(pa, kv_dtype), layers * k, "K1 in the replay")
    ok = (np.array_equal(seen["emits"], seen["eager"]) and seen["pools"]
          and bool((sentinel == 7).all()) and paged_ok and gemm_ok)
    print(f"fused gate {label}: graph replay vs eager run of one window: "
          f"emits equal {np.array_equal(seen['emits'], seen['eager'])}, "
          f"pools and scale planes byte-equal {seen['pools']}, after the "
          f"capture stream's workspace was outgrown ({outgrown}; sentinel "
          f"intact {bool((sentinel == 7).all())}); {paged_text}; the int8 "
          f"GEMM's wrapper counted {gemm_counted or 'none'} in it"
          + (f" (want {linears} = 4 x {layers} x {k} on the decode route)"
             if gemm else ""))
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


# ---- the serving fleet (5h) ----

FLEET_K = 8                  # decode_k of every fleet engine (bench.py's)


def _fleet_cfg(kv_dtype="bfloat16", decode_k=FLEET_K, **kw):
    from paddle_tpu_torch.inference import LLMEngineConfig

    return LLMEngineConfig(kv_dtype=kv_dtype, page_size=16,
                           decode_k=decode_k, **kw)


def _pctl(xs, p):
    return float(np.percentile(np.asarray(xs), p))


def _paced(submit, prompts, arrive):
    """Submit prompt j at `arrive[j]` seconds after the start (Poisson
    gaps, paced as bench.py's `drive` paces them) through
    `submit(j, prompt) -> Future`. Returns the outputs, each request's
    client TTFT (its submission to the serving engine's first token) and
    the makespan."""
    futs, stamps = [], []
    t0 = time.perf_counter()
    for j, p in enumerate(prompts):
        wait = arrive[j] - (time.perf_counter() - t0)
        if wait > 0:
            time.sleep(wait)
        stamps.append(time.perf_counter())
        futs.append(submit(j, p))
    outs = [f.result(timeout=600) for f in futs]
    wall = time.perf_counter() - t0
    ttft = [f.pt_request.t_first_token - s for f, s in zip(futs, stamps)]
    return outs, ttft, wall


def _tie_check(model, label, prompts, ref, outs,
               tol=SERVE_BF16_LOGIT_TOL):
    """Request by request, `outs` against `ref` (prompt + generated
    tokens): equal, or first different at a near-tie of `ref`'s pick —
    `_near_tie` on the logits of a plain forward over the common prefix,
    top two within `tol` — and compared no further. The
    fleet paths batch a request with other rows than the reference did,
    so cuBLAS may take another algorithm. Returns the near-ties."""
    from types import SimpleNamespace

    greedy = SimpleNamespace(temperature=0.0)
    ties = []
    for i, (p, a, b) in enumerate(zip(prompts, ref, outs)):
        a, b = np.asarray(a), np.asarray(b)
        if len(a) != len(b) or not np.array_equal(b[:len(p)], p):
            raise AssertionError(f"{label}: request {i} returned {len(b)} "
                                 f"tokens, the reference {len(a)}")
        diff = np.flatnonzero(a != b)
        if not diff.size:
            continue
        d = int(diff[0])
        with torch.inference_mode():
            ids = torch.as_tensor(a[:d], device=model.device)[None]
            row = model(ids)[0, -1].float()
        gap, tol = _near_tie(row, greedy, d - len(p), None, tol)
        if not gap <= tol:
            raise AssertionError(
                f"{label}: request {i} token {d - len(p)} is {b[d]} vs "
                f"the reference's {a[d]}, whose top two logits differ by "
                f"{gap:.3e}")
        ties.append(f"request {i} token {d - len(p)} (gap {gap:.2e})")
    return ties


def _drain(eng):
    while eng.has_work():
        eng.step()
        eng.pool.assert_consistent()


def _prefill_tokens(eng, st0):
    return ((eng.stats["tokens_in"] - st0["tokens_in"])
            - (eng.stats["generated"] - st0["generated"]))


def _count_model(vocab):
    """A 1-layer 64-wide GPT of the serve vocabulary on the CPU: a
    schedule (and so its prefill-token count) depends on the prompts and
    the config, not on the model's width."""
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    return GPTForCausalLM(GPTConfig(vocab_size=vocab, hidden_size=64,
                                    num_layers=1, num_heads=2,
                                    max_seq_len=1024), device="cpu")


def fleet_prefix(model, card):
    """(1) bench.py's `bench_llm_fleet` traffic (bench.py:1205-1222): 24
    requests, one 192-token system prompt, suffixes of 8-48 tokens, 8-32
    new tokens, Poisson gaps of mean 20 ms, 3 tenants (one INTERACTIVE)
    on the cached side, num_slots 8, token_budget 48, decode_k 8, bf16 KV
    — through `LLMServer` with the prefix cache off, then on. Tokens equal
    between the runs (near-tie rule); the pool consistent after each.
    The prefill-token count of a run with every request queued at once
    (a schedule that timing cannot change) equals, with the cache on, the
    CPU engine's on the same prompts."""
    from paddle_tpu_torch.inference import LLMEngine, LLMServer, Priority
    from paddle_tpu_torch.profile_serve import HostTimer

    V = model.config.vocab_size
    rng = np.random.default_rng(0)
    sys_len, max_suffix, n_req = 192, 48, 24
    sys_prompt = rng.integers(0, V, (sys_len,))
    prompts = [np.concatenate([sys_prompt, rng.integers(0, V, (int(L),))])
               for L in rng.integers(8, max_suffix + 1, n_req)]
    gens = rng.integers(8, 33, n_req)
    arrive = np.cumsum(rng.exponential(0.02, n_req))
    cfg = dict(num_slots=8, token_budget=48,
               max_model_len=sys_len + max_suffix + 40)
    res = {}
    for cache in (False, True):
        server = LLMServer(model, _fleet_cfg(prefix_cache=cache, **cfg))
        eng = server.engine
        with server:
            server.submit(np.zeros((8,), np.int64),
                          max_new_tokens=FLEET_K + 1).result(timeout=600)
            torch.cuda.synchronize()
            st0 = dict(eng.stats)
            host = HostTimer(eng, "step")

            def submit(j, p):
                kw = (dict(tenant=f"tenant{j % 3}",
                           priority=Priority.INTERACTIVE if j % 3 == 0
                           else Priority.STANDARD) if cache else {})
                return server.submit(p, max_new_tokens=int(gens[j]), **kw)

            outs, ttft, wall = _paced(submit, prompts, arrive)
            host.remove()
            snap = (eng.prefix_cache.snapshot() if cache else None)
        eng.pool.assert_consistent()
        gen = int(sum(gens))
        res[cache] = dict(outs=outs, prefill=_prefill_tokens(eng, st0),
                          ttft_p50=_pctl(ttft, 50), ttft_p99=_pctl(ttft, 99),
                          tok_s=gen / wall, step_ms=1e3 * float(
                              np.median(host.times)), snap=snap)
    ties = _tie_check(model, "prefix cache on vs off", prompts,
                      res[False]["outs"], res[True]["outs"])
    # the count gate: the same prompts queued at once, card vs CPU
    counts = {}
    for where, m in (("card", model), ("cpu", _count_model(V))):
        eng = LLMEngine(m, _fleet_cfg(prefix_cache=True, **cfg))
        st0 = dict(eng.stats)
        for p, g in zip(prompts, gens):
            eng.add_request(p, max_new_tokens=int(g))
        _drain(eng)
        counts[where] = (_prefill_tokens(eng, st0),
                         eng.prefix_cache.snapshot()["tokens_saved"])
        eng.close()
    if counts["card"] != counts["cpu"]:
        raise AssertionError(f"prefix cache: prefill tokens / tokens saved "
                             f"{counts['card']} on the card, "
                             f"{counts['cpu']} on the CPU")
    off, on = res[False], res[True]
    print(f"fleet prefix cache ({card}): bench_llm_fleet traffic, "
          f"{n_req} requests, {int(sum(gens))} generated; prefill tokens "
          f"{off['prefill']} off -> {on['prefill']} on "
          f"(-{1 - on['prefill'] / off['prefill']:.1%}; hits "
          f"{on['snap']['hits']}, tokens saved {on['snap']['tokens_saved']}"
          f"); TTFT p50 {off['ttft_p50'] * 1e3:.1f} -> "
          f"{on['ttft_p50'] * 1e3:.1f} ms, p99 {off['ttft_p99'] * 1e3:.1f} "
          f"-> {on['ttft_p99'] * 1e3:.1f} ms; {off['tok_s']:.1f} -> "
          f"{on['tok_s']:.1f} tok/s; host ms per step() {off['step_ms']:.3f}"
          f" off, {on['step_ms']:.3f} with the trie; all queued at once: "
          f"prefill {counts['card'][0]} tokens, {counts['card'][1]} saved, "
          f"= the CPU engine's; tokens equal but at {len(ties)} near-ties"
          f"{': ' + ', '.join(ties) if ties else ''}")
    return {k: {x: v for x, v in r.items() if x != "outs"}
            for k, r in (("off", off), ("on", on))}


WIRE_ROUNDS = 5


def fleet_wire(model, card):
    """(2) The KV wire on bf16, int8 and int4 pools: a 500-token prompt
    (frontier 499: a mid-page frontier) runs prefill_only on engine P;
    its payload goes pack -> bytes -> unpack and is imported on engine
    D. D's pages, gathered back, are byte-equal to P's export, scale
    planes included; D's tokens equal P's own decode of the prompt
    (near-tie rule). Export ms (the gather and its one copy to the host,
    on D's live request with nothing in flight), import ms (page
    allocation, the copy to the card and the in-place writes, to a
    synchronize) and the frame's MB per request: medians of WIRE_ROUNDS
    rounds after one that warms the allocator and the host buffers."""
    from paddle_tpu_torch.inference import LLMEngine
    from paddle_tpu_torch.inference.fleet_serving import (
        pack_kv_payload, unpack_kv_payload)

    V = model.config.vocab_size
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, V, (500,))
    cfg = dict(num_slots=4, token_budget=48, max_model_len=600)
    out = {}
    for kv in ("bfloat16", "int8", "int4"):
        P = LLMEngine(model, _fleet_cfg(kv, **cfg))
        D = LLMEngine(model, _fleet_cfg(kv, **cfg))
        times = []
        for trial in range(1 + WIRE_ROUNDS):
            r = P.add_request(prompt, prefill_only=True)
            _drain(P)
            payload = r.future.result(timeout=0)
            raw = pack_kv_payload(payload)
            back = unpack_kv_payload(raw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            req = D.import_kv_pages(back, max_new_tokens=SERVE_NEW_TOKENS)
            D._admit()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if req.slot is None:
                raise AssertionError(f"KV wire {kv}: import not admitted")
            # the export path on D's live request: the same gather and
            # copy P's `_finish_prefill` ran, with no tick in flight
            again = D.export_kv_pages(req)
            if trial:                   # round 0 warms the allocator
                times.append(((time.perf_counter() - t1) * 1e3,
                              (t1 - t0) * 1e3))
            for a, b in zip(payload.kv + payload.scales,
                            again.kv + again.scales):
                if a.shape != b.shape or a.tobytes() != b.tobytes():
                    raise AssertionError(
                        f"KV wire {kv}: the imported pages differ from the "
                        "export")
            _drain(D)
        own = P.add_request(prompt, max_new_tokens=SERVE_NEW_TOKENS)
        _drain(P)
        ties = _tie_check(model, f"KV wire {kv}", [prompt],
                          [own.future.result(timeout=0)],
                          [req.future.result(timeout=0)])
        exp_ms, imp_ms = np.median(np.asarray(times), axis=0)
        out[kv] = dict(export_ms=exp_ms, import_ms=imp_ms,
                       mb=len(raw) / 1e6, pages=payload.num_pages)
        print(f"fleet KV wire {kv} ({card}): 500-token prompt, "
              f"n_prefilled {payload.n_prefilled}, {payload.num_pages} "
              f"pages, frame {len(raw) / 1e6:.3f} MB; export "
              f"{exp_ms:.3f} ms, import {imp_ms:.3f} ms (medians of "
              f"{WIRE_ROUNDS} rounds); pages imported "
              f"byte-equal to the export, scale planes included; tokens "
              f"equal P's own decode but at {len(ties)} near-ties")
    return out


def _router_traffic(V):
    """bench.py's `bench_llm_fleet_multi` traffic (bench.py:1348-1364):
    96 requests over 4 system prompts of 96 tokens, suffixes of 4-32,
    24-48 new tokens, Poisson gaps of mean 2 ms."""
    rng = np.random.default_rng(0)
    sys_prompts = [rng.integers(0, V, (96,)) for _ in range(4)]
    prompts = [np.concatenate([sys_prompts[j % 4],
                               rng.integers(0, V, (int(L),))])
               for j, L in enumerate(rng.integers(4, 33, 96))]
    gens = rng.integers(24, 49, 96)
    arrive = np.cumsum(rng.exponential(0.002, 96))
    return rng, prompts, gens, arrive


# bench_llm_fleet_multi's engine: num_slots 4, budget 48, the cache on
FLEET_MULTI = dict(num_slots=4, token_budget=48, max_model_len=96 + 32 + 40,
                   prefix_cache=True)


def _replica(model, name, role="serve", **kw):
    from paddle_tpu_torch.inference.fleet_serving import (LocalReplica,
                                                          fork_model)

    cfg = dict(FLEET_MULTI, **kw)
    return LocalReplica(fork_model(model), name=name, role=role,
                        config=_fleet_cfg(**cfg))


def fleet_router(pa, model, card):
    """(3)-(5): bench_llm_fleet_multi's traffic through one `LLMServer`
    and through a 2-replica `FleetRouter` (each replica its own
    `fork_model` copy): affinity hit rate > 0.5, tokens equal (near-tie
    rule); K1's launch count set to 0 just before the router burst and
    read just after (> 0, every replica ticked). Then the same traffic
    with a seeded chaos plan killing one replica at its 12th busy tick:
    every future resolves, requeues > 0, tokens equal the unkilled run's.
    Then bench.py's prefill storm (bench.py:1533-1577): 12 short 8-token
    prompts (16 new) among 8 long 156-token ones (8 new), gaps of mean
    4 ms, through one `LLMServer` and through a router with one prefill
    and one decode replica (prefill_min_tokens 48): the hand-offs equal
    the long prompts, tokens equal the single engine's."""
    from paddle_tpu_torch.distributed import chaos
    from paddle_tpu_torch.inference import LLMServer
    from paddle_tpu_torch.inference.fleet_serving import (AutoscalePolicy,
                                                          FleetRouter,
                                                          fork_model)

    V = model.config.vocab_size
    rng, prompts, gens, arrive = _router_traffic(V)
    policy = dict(min_replicas=1, max_replicas=2, heartbeat_timeout_s=5.0,
                  poll_s=0.01)

    def single(plist, glist, alist):
        server = LLMServer(fork_model(model), _fleet_cfg(**FLEET_MULTI))
        with server:
            server.submit(np.zeros((2,), np.int64),
                          max_new_tokens=FLEET_K + 1).result(timeout=600)
            outs, ttft, wall = _paced(
                lambda j, p: server.submit(p, max_new_tokens=int(glist[j])),
                plist, alist)
            occ = server.engine.mean_occupancy
        return outs, ttft, wall, occ

    def fleet(router, plist, glist, alist, count=False):
        with router:
            reps = list(router._replicas.values())
            steps0 = {r.name: r.engine.stats["steps"] for r in reps}
            torch.cuda.synchronize()
            if count:
                pa.reset_launches()
            outs, ttft, wall = _paced(
                lambda j, p: router.submit(p, max_new_tokens=int(glist[j])),
                plist, alist)
            launches = dict(pa.launches)
            steps = {r.name: r.engine.stats["steps"] - steps0[r.name]
                     for r in reps}
            m = router.metrics()
        return outs, ttft, wall, m, launches, steps

    gen = int(sum(gens))
    s_out, s_ttft, s_wall, s_occ = single(prompts, gens, arrive)
    router = FleetRouter(replicas=[_replica(model, "m0"),
                                   _replica(model, "m1")],
                         hash_block_tokens=16,
                         policy=AutoscalePolicy(**policy))
    f_out, f_ttft, f_wall, m, launches, steps = fleet(router, prompts, gens,
                                                      arrive, count=True)
    if not m["affinity_hit_rate"] > 0.5:
        raise AssertionError(f"router: affinity hit rate "
                             f"{m['affinity_hit_rate']} <= 0.5")
    if not launches["rpa"] or not all(steps.values()):
        raise AssertionError(f"router burst: K1 launched {launches}, "
                             f"replica ticks {steps}")
    ties = _tie_check(model, "router vs single", prompts, s_out, f_out)
    occ = {n: v["mean_slot_occupancy"] for n, v in m["replicas"].items()}
    # each request's phase segments (reqtrace), from the router's merged
    # timelines: "routed" is the router's ingress, "prefill_start" the
    # replica's queue and admission (submit -> admission)
    segs = {}
    for tl in m["recent_requests"]:
        for seg in tl["phases"][1:]:
            segs.setdefault(seg["phase"], []).append(seg["dt_s"])
    phases = {ph: (_pctl(v, 50), _pctl(v, 99), len(v))
              for ph, v in segs.items()}
    print(f"fleet router ({card}): bench_llm_fleet_multi traffic, 96 "
          f"requests, {gen} generated; one LLMServer {gen / s_wall:.1f} "
          f"tok/s, client TTFT p50 {_pctl(s_ttft, 50) * 1e3:.1f} ms p99 "
          f"{_pctl(s_ttft, 99) * 1e3:.1f} ms, occupancy {s_occ:.3f}; "
          f"2-replica FleetRouter {gen / f_wall:.1f} tok/s "
          f"({s_wall / f_wall:.3f}x), client TTFT p50 "
          f"{_pctl(f_ttft, 50) * 1e3:.1f} ms p99 "
          f"{_pctl(f_ttft, 99) * 1e3:.1f} ms, occupancy "
          + ", ".join(f"{n} {v:.3f}" for n, v in occ.items())
          + f"; affinity hit rate {m['affinity_hit_rate']:.3f}; K1 "
          f"launches in the burst {launches['rpa']} (replica ticks "
          f"{steps}); tokens equal but at {len(ties)} near-ties"
          f"{': ' + ', '.join(ties) if ties else ''}")
    print(f"fleet router phases ({card}), ms p50 / p99 over the last "
          f"{len(m['recent_requests'])} requests: " + "; ".join(
              f"{ph} {a * 1e3:.3f} / {b * 1e3:.3f} (n {n})"
              for ph, (a, b, n) in phases.items()))
    out = dict(phases=phases, single_tok_s=gen / s_wall, fleet_tok_s=gen / f_wall,
               single_ttft_p50=_pctl(s_ttft, 50),
               single_ttft_p99=_pctl(s_ttft, 99),
               fleet_ttft_p50=_pctl(f_ttft, 50),
               fleet_ttft_p99=_pctl(f_ttft, 99), occupancy=occ,
               single_occupancy=s_occ,
               affinity=m["affinity_hit_rate"],
               burst_launches=launches["rpa"])
    # (4) a seeded kill mid-stream
    chaos.install({"seed": 13, "injectors": [
        {"scope": "replica.kill.k0", "kind": "error", "at": [12]}]})
    try:
        router = FleetRouter(replicas=[_replica(model, "k0"),
                                       _replica(model, "k1")],
                             hash_block_tokens=16,
                             policy=AutoscalePolicy(**policy))
        k_out, _, k_wall, km, _, _ = fleet(router, prompts, gens, arrive)
        fired = chaos.get_plan().injected.get("replica.kill.k0", 0)
    finally:
        chaos.clear()
    if fired != 1 or km["replicas_lost"] != 1 or not km["requeues"] > 0:
        raise AssertionError(f"kill: fired {fired}, replicas lost "
                             f"{km['replicas_lost']}, requeues "
                             f"{km['requeues']}")
    kties = _tie_check(model, "killed fleet vs single", prompts, s_out,
                       k_out)
    print(f"fleet kill ({card}): replica k0 killed at its 12th busy tick; "
          f"{km['requeues']} requests requeued, all 96 futures resolved in "
          f"{k_wall:.3f} s ({gen / k_wall:.1f} tok/s); tokens equal the "
          f"unkilled single engine's but at {len(kties)} near-ties")
    out.update(kill_requeues=km["requeues"], kill_tok_s=gen / k_wall)
    # (5) the prefill storm
    long_len = FLEET_MULTI["max_model_len"] - 12
    shorts = [rng.integers(0, V, (8,)) for _ in range(12)]
    longs = [rng.integers(0, V, (long_len,)) for _ in range(8)]
    storm, kinds = [], []
    for i in range(12):
        if i < 8:
            storm.append(longs[i])
            kinds.append("long")
        storm.append(shorts[i])
        kinds.append("short")
    s_arrive = np.cumsum(rng.exponential(0.004, len(storm)))
    s_gens = [16 if k == "short" else 8 for k in kinds]
    sp_out, sp_ttft, _, _ = single(storm, s_gens, s_arrive)
    router = FleetRouter(
        replicas=[_replica(model, "storm_d")],
        prefill_replicas=[_replica(model, "storm_p", role="prefill")],
        prefill_min_tokens=48,
        policy=AutoscalePolicy(min_replicas=1, max_replicas=1,
                               heartbeat_timeout_s=5.0, poll_s=0.01))
    dp_out, dp_ttft, _, dm, _, _ = fleet(router, storm, s_gens, s_arrive)
    if dm["disagg_handoffs"] != 8:
        raise AssertionError(f"storm: {dm['disagg_handoffs']} hand-offs, "
                             "wanted 8")
    sties = _tie_check(model, "storm disaggregated vs single", storm,
                       sp_out, dp_out)
    short = [i for i, k in enumerate(kinds) if k == "short"]
    p99 = (_pctl([sp_ttft[i] for i in short], 99),
           _pctl([dp_ttft[i] for i in short], 99))
    print(f"fleet prefill storm ({card}): 12 short + 8 long ({long_len}) "
          f"prompts; short TTFT p99 {p99[0] * 1e3:.1f} ms on one LLMServer"
          f", {p99[1] * 1e3:.1f} ms with a prefill replica; 8 hand-offs; "
          f"tokens equal but at {len(sties)} near-ties")
    out.update(storm_short_p99_single=p99[0], storm_short_p99_disagg=p99[1])
    return out


BUSY_NEW = 500               # the busy replica's tokens per request


def fleet_capture(model, card):
    """(6) A window captured while another replica's thread steps: a
    `LocalReplica` at decode_k 1 serves a burst (eager ticks on its own
    thread and stream) while, on this thread, an `LLMEngine` at decode_k
    8 reaches its first window and captures the graph (the device gate
    holds the replica at a step boundary for the capture); its next
    window is run eagerly on copies of the pools and as the graph replay
    (`_window_vs_eager`): emits and every pool byte equal. The replica
    ticked before the capture and after it, and its outputs are whole."""
    from paddle_tpu_torch.inference import LLMEngine

    V = model.config.vocab_size
    rng = np.random.default_rng(8)
    busy = _replica(model, "busy", decode_k=1, prefix_cache=False,
                    max_model_len=600)
    try:
        bp = [rng.integers(0, V, (64,)) for _ in range(4)]
        futs = [busy.submit(p, max_new_tokens=BUSY_NEW) for p in bp]
        deadline = time.monotonic() + 60
        while busy.engine.stats["steps"] < 4 and time.monotonic() < deadline:
            time.sleep(0.005)
        eng = LLMEngine(model, _fleet_cfg(num_slots=8, token_budget=48,
                                          max_model_len=600))
        for n in (24, 40, 64, 100):
            eng.add_request(rng.integers(0, V, (n,)), max_new_tokens=40)
        before = busy.engine.stats["steps"]
        while not eng.stats["fused_steps"]:   # the first window captures
            eng.step()
        during = busy.engine.stats["steps"]
        if eng._fused_fn.cuda and eng._fused_fn.captures != 1:
            raise AssertionError("capture: the first window captured "
                                 f"{eng._fused_fn.captures} graphs")
        seen = _window_vs_eager(eng, eng._fused_fn)
        after = busy.engine.stats["steps"]
        if any(f.done() for f in futs):
            raise AssertionError("capture: the busy replica finished "
                                 "before the gate ran")
        _drain(eng)
        outs = [f.result(timeout=600) for f in futs]
    finally:
        busy.stop()
    if not (np.array_equal(seen["eager"], seen["emits"]) and seen["pools"]):
        raise AssertionError("capture beside a stepping replica: the graph "
                             "replay differs from the eager window")
    if not (during > before and after > during):
        raise AssertionError(f"capture: the busy replica ticked {before} -> "
                             f"{during} -> {after}")
    for p, o in zip(bp, outs):
        if len(o) != len(p) + BUSY_NEW or not np.array_equal(o[:len(p)], p):
            raise AssertionError("capture: the busy replica's output is "
                                 f"not prompt + {BUSY_NEW} tokens")
    print(f"fleet concurrent capture ({card}): decode_k 8 window captured "
          f"while replica 'busy' stepped (ticks {before} -> {during} -> "
          f"{after}); graph replay == eager window, emits and every pool "
          "byte")


def fleet_phase(pa, model, card):
    """5h: the serving fleet on gpt_small bf16 (module docstring)."""
    return dict(prefix=fleet_prefix(model, card),
                wire=fleet_wire(model, card),
                router=fleet_router(pa, model, card),
                capture=fleet_capture(model, card))


# ---- the KV tier and chat sessions (5i) ----

TIER_ROUND_TRIP_LEN = 48      # 3 trie blocks of 16


def _k1_counted(pa, kv_dtype, want, label):
    """The paged wrapper's counts since they were set to 0: `want` K1
    launches on a `kv_dtype` pool, every one on the tensor-core route,
    and no other paged call. Returns the count."""
    key = _pool_key(pa, kv_dtype)
    got = {k: n for k, n in pa.launches.items() if n}
    tc = {k: n for k, n in pa.tc_launches.items() if n}
    print(f"{label}: K1 {got or 'none'} ({tc or 'none'} on the "
          f"tensor-core route), want {{{key!r}: {want}}}")
    if not (got == tc == {key: want} and want > 0):
        raise AssertionError(f"{label}: K1 launches {got}, tensor-core "
                             f"{tc}; want {{{key!r}: {want}}}")
    return want


def tier_round_trip(pa, model, kv_dtype):
    """One prompt's trie blocks spilled (RAM tier) and prefetched back on
    a `kv_dtype` pool: the prefix re-exported after the prefetch must be
    byte-equal to the one exported before the spill, every pool and
    scale-plane byte, and the tokens equal. Returns the K1 launches of
    the two requests."""
    from paddle_tpu_torch.inference import LLMEngine, LLMEngineConfig

    eng = LLMEngine(model, LLMEngineConfig(
        **dict(SERVE_CFG, num_slots=2), kv_dtype=kv_dtype, decode_k=1,
        prefix_cache=True, kv_tier=dict(ram_bytes=64 << 20)))
    prompt = np.random.default_rng(91).integers(
        0, model.config.vocab_size, (TIER_ROUND_TRIP_LEN,))
    pa.reset_launches()
    outs = []
    for spill in (True, False):
        req = eng.add_request(prompt, max_new_tokens=8)
        _drain(eng)
        outs.append(req.future.result(timeout=0))
        if spill:
            before = eng.export_prefix(prompt)
            spilled = eng.prefix_cache.evict(10_000)
            eng.kv_tier.flush()
    n = _k1_counted(pa, kv_dtype,
                    model.config.num_layers * eng.stats["steps"],
                    f"tier round trip {kv_dtype}")
    after = eng.export_prefix(prompt)
    torch.cuda.synchronize()
    same = (after is not None and after.n_prefilled == before.n_prefilled
            and all(np.array_equal(a.view(np.uint8), b.view(np.uint8))
                    for a, b in zip(before.kv + before.scales,
                                    after.kv + after.scales)))
    pre = eng.stats.get("kv_pages_prefetched", 0)
    print(f"tier round trip {kv_dtype}: {spilled} pages spilled, {pre} "
          f"prefetched; re-exported prefix byte-equal {same} "
          f"({len(before.kv)} pools, {len(before.scales)} scale planes, "
          f"{before.nbytes()} bytes); tokens equal "
          f"{np.array_equal(*outs)}")
    eng.close()
    if not (same and pre == spilled > 0 and np.array_equal(*outs)):
        raise AssertionError(f"tier round trip {kv_dtype} failed")
    return n


def tier_window_gate(pa, model):
    """A decode_k 4 session burst on a tiered engine: turn 1 of every
    session (the first window captures the graph), the trie then spilled
    whole to the tier, then session 0's turn 2, whose admission
    prefetches its history into the pools in place; the next window runs
    eagerly on copies of the pools and as the graph replay: emits and
    every pool byte equal, K1 counted 12 x 4 in the replay
    (`_paged_records`), no new capture."""
    from paddle_tpu_torch.inference import LLMEngine, LLMEngineConfig
    from paddle_tpu_torch.profile_serve import KV_TIER, KV_TIER_ENGINE

    eng = LLMEngine(model, LLMEngineConfig(
        **KV_TIER_ENGINE, decode_k=4, kv_tier=dict(ram_bytes=256 << 20)))
    rng = np.random.default_rng(31)
    V = model.config.vocab_size
    users = [rng.integers(0, V, (KV_TIER["user_tokens"],))
             for _ in range(KV_TIER["sessions"])]
    first = []
    for s, u in enumerate(users):
        req = eng.add_request(u, max_new_tokens=KV_TIER["new_tokens"],
                              session_id=f"chat-{s}")
        _drain(eng)
        first.append(req.future.result(timeout=0))
    # these turns fit the pool; spill the histories so the next turn's
    # admission prefetches
    eng.prefix_cache.evict(10_000)
    eng.kv_tier.flush()
    fs = eng._fused_fn
    captures = fs.captures
    pre0 = eng.stats.get("kv_pages_prefetched", 0)
    prompt = np.concatenate([first[0], rng.integers(0, V, (24,))])
    eng.add_request(prompt, max_new_tokens=KV_TIER["new_tokens"],
                    session_id="chat-0")
    seen = _window_vs_eager(eng, fs, profiled=True,
                            counts=(pa.launches, pa.tc_launches))
    _drain(eng)
    pre = eng.stats.get("kv_pages_prefetched", 0) - pre0
    paged_ok, text = _paged_records(
        seen["prof"].key_averages(),
        {"launches": seen["counted"][0], "tc_launches": seen["counted"][1]},
        _pool_key(pa, "bfloat16"), model.config.num_layers * 4,
        "K1 in the replay")
    same = np.array_equal(seen["emits"], seen["eager"])
    print(f"tier window gate (decode_k 4, bf16 KV): session 0's turn 2 "
          f"prefetched {pre} pages in place; the next window's graph "
          f"replay vs its eager run: emits equal {same}, pools byte-equal "
          f"{seen['pools']}; {text}; captures {captures} -> {fs.captures}")
    eng.close()
    if not (same and seen["pools"] and paged_ok and pre > 0
            and fs.captures == captures):
        raise AssertionError("tier window gate failed")


def tier_phase(pa, model, card):
    """5i: the KV tier and sessions on bench_kv_tier_ab's traffic
    (module docstring). Returns the K1 launches of each pool's run."""
    from paddle_tpu_torch.profile_serve import (KV_TIER, KV_TIER_ENGINE,
                                                _ms_per_page, kv_tier_side)

    sides, counts = {}, {}
    with tempfile.TemporaryDirectory(prefix="ptkv_") as d:
        for name, tier_dir in (("off", None), ("on", d)):
            pa.reset_launches()
            side = kv_tier_side(model, tier_dir,
                                engine_knobs=dict(decode_k=1))
            counts[name] = _k1_counted(
                pa, "bfloat16", model.config.num_layers * side["steps"],
                f"tier A/B, tier {name}")
            sides[name] = side
    off, on = sides["off"], sides["on"]
    same = len(off["outs"]) == len(on["outs"]) and all(
        np.array_equal(a, b) for a, b in zip(off["outs"], on["outs"]))
    cut = 1.0 - on["prefill_tokens"] / off["prefill_tokens"]
    cold, warm = ([float(np.median([x["ttft_s"][i] for i in x[k]])) * 1e3
                   for x in (off, on)] for k in ("cold", "warm"))
    tier = on["tier"]
    pre = on["stats"].get("kv_pages_prefetched", 0)
    print(f"tier A/B ({KV_TIER['sessions']} sessions x {KV_TIER['turns']} "
          f"turns, {KV_TIER_ENGINE}; bf16 KV; {card}): prefill tokens off "
          f"{off['prefill_tokens']} / on {on['prefill_tokens']} of "
          f"{on['prompt_tokens']} = {100 * cut:.1f}% fewer (the reference "
          f"aims at >= 30%); greedy tokens equal {same}; RAM hits "
          f"{tier['ram_hits']}, disk hits {tier['disk_hits']}, misses "
          f"{tier['misses']}, spills {tier['spills']} "
          f"({tier['spill_pages']} pages), {pre} pages prefetched; host "
          f"{_ms_per_page(on['spill_s']):.4f} ms per spilled page, "
          f"{_ms_per_page(on['prefetch_s']):.4f} ms per prefetched page; "
          f"TTFT medians off / on: cold turns {cold[0]:.3f} / "
          f"{cold[1]:.3f} ms, returning turns {warm[0]:.3f} / "
          f"{warm[1]:.3f} ms; "
          f"wall off {off['wall_s']:.3f} / on {on['wall_s']:.3f} s; "
          f"sessions resumed {on['stats'].get('sessions_resumed', 0)}")
    if not (same and pre > 0):
        raise AssertionError("tier A/B: tokens differ or nothing was "
                             "prefetched")
    rt = {kv: tier_round_trip(pa, model, kv)
          for kv in ("bfloat16", "int8", "int4")}
    tier_window_gate(pa, model)
    return {"bfloat16": counts["on"], "int8": rt["int8"],
            "int4": rt["int4"], "round_trip_bf16": rt["bfloat16"]}


# ---- dense generation (5j) ----

GEN_BATCH, GEN_PROMPT, GEN_NEW = 8, 128, 128    # bench.py:498's arm
GEN_F32_TIE_TOL = 1e-3


def _gen_bound_ms(model, step):
    """The one-token step's least time: the weights and the whole static
    cache read once at the card's memory rate."""
    wbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    cbytes = sum(c.numel() * c.element_size() for c in step.caches)
    return (wbytes + cbytes) / HBM_BYTES_PER_S * 1e3


def _events_ms(fn, reps=20):
    times = []
    for _ in range(reps + 3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times[3:]))


def generate_gate(model, ids, label):
    """bench_generate's arm on `model`: tok/s and ms per token-step; one
    step's graph replay vs its eager run from the same static cache and
    inputs, byte-equal (logits and every cache byte); the eager step's
    and the replay's device ms beside the bound. Returns the tokens."""
    model.generate(ids, max_new_tokens=8)          # build and capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.generate(ids, max_new_tokens=GEN_NEW)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = int(out.shape[1]) - GEN_PROMPT
    step = model._decode_steps[(GEN_BATCH, 256, False, model.dtype)]
    with torch.inference_mode():
        snap = [c.clone() for c in step.caches]
        step.tok.copy_(out[:, GEN_PROMPT + 40:GEN_PROMPT + 41])
        step.index.fill_(GEN_PROMPT + 40)
        step.graph.replay()
        torch.cuda.synchronize()
        rlog = step.logits.clone()
        rcache = [c.clone() for c in step.caches]
        for c, c0 in zip(step.caches, snap):
            c.copy_(c0)
        elog = step.eager()
        torch.cuda.synchronize()
        same = torch.equal(_bytes(rlog), _bytes(elog)) and all(
            torch.equal(_bytes(a), _bytes(b))
            for a, b in zip(rcache, step.caches))
        eager_ms = _events_ms(step.eager)
        replay_ms = _events_ms(step.graph.replay)
    bound = _gen_bound_ms(model, step)
    print(f"generate {label} (batch {GEN_BATCH}, prompt {GEN_PROMPT}, {n} "
          f"new tokens, greedy): {GEN_BATCH * n / dt:.1f} tok/s, "
          f"{dt / n * 1e3:.4f} ms per token-step (wall); one step: graph "
          f"replay {replay_ms:.4f} ms, eager {eager_ms:.4f} ms (device, "
          f"CUDA events), bound {bound:.4f} ms (weights + cache read once "
          f"at {HBM_BYTES_PER_S / 1e12:.2f} TB/s); replay vs eager "
          f"byte-equal {same} (logits and {len(step.caches)} caches); "
          f"captures {step.captures}")
    if not (same and step.captures == 1 and n == GEN_NEW):
        raise AssertionError(f"generate {label}: replay differs from eager")
    return out.cpu().numpy()


def generate_phase(model16, card):
    """5j: dense generation (module docstring)."""
    from paddle_tpu_torch.inference import LLMEngine, LLMEngineConfig
    from paddle_tpu_torch.text.models.gpt import GPTForCausalLM, gpt_small

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 matmuls
    torch.backends.cudnn.allow_tf32 = False
    model32 = GPTForCausalLM(gpt_small(), seed=1234)
    V = model32.config.vocab_size
    ids_np = np.random.default_rng(0).integers(0, V, (GEN_BATCH, GEN_PROMPT))
    ids = torch.as_tensor(ids_np, device="cuda")
    out32 = generate_gate(model32, ids, f"f32 ({card})")
    generate_gate(model16, ids, f"bf16 ({card})")
    # the engine's k=1 tokens on the same prompts (f32 pool: K1's f32
    # kernel)
    eng = LLMEngine(model32, LLMEngineConfig(
        num_slots=GEN_BATCH, page_size=16, max_model_len=256,
        token_budget=256, kv_dtype="float32", decode_k=1))
    reqs = [eng.add_request(p, max_new_tokens=GEN_NEW) for p in ids_np]
    _drain(eng)
    ref = [r.future.result(timeout=0) for r in reqs]
    ties = _tie_check(model32, "generate vs LLMEngine (f32)", ids_np, ref,
                      out32, tol=GEN_F32_TIE_TOL)
    print(f"generate vs LLMEngine k=1 (f32, TF32 off): {GEN_BATCH} x "
          f"{GEN_NEW} tokens equal but at near-ties (top two within "
          f"{GEN_F32_TIE_TOL:.0e}): {ties or 'none'}")
    # a ragged left-padded batch against each row alone
    rng = np.random.default_rng(5)
    lens = (128, 57, 100, 9)
    rows = [rng.integers(0, V, (L,)) for L in lens]
    pad = np.zeros((len(lens), GEN_PROMPT), np.int64)
    mask = np.zeros_like(pad)
    for i, r in enumerate(rows):
        pad[i, GEN_PROMPT - len(r):] = r
        mask[i, GEN_PROMPT - len(r):] = 1
    ragged = model32.generate(torch.as_tensor(pad, device="cuda"),
                              max_new_tokens=16,
                              attention_mask=mask).cpu().numpy()
    alone = [model32.generate(torch.as_tensor(r[None], device="cuda"),
                              max_new_tokens=16).cpu().numpy()[0]
             for r in rows]
    mine = [np.concatenate([r, ragged[i, GEN_PROMPT:]])
            for i, r in enumerate(rows)]
    ties = _tie_check(model32, "ragged generate vs alone", rows, alone,
                      mine, tol=GEN_F32_TIE_TOL)
    print(f"generate ragged left-padded batch (lengths {lens}) vs each row "
          f"alone: tokens equal but at near-ties: {ties or 'none'}")
    del eng, model32


# ---- the dynamic-batching server (5k) ----

def serving_phase(card):
    """5k: bench_serving's arm (module docstring)."""
    import threading

    from paddle_tpu_torch import nn
    from paddle_tpu_torch.convert import load_jax_state_dict
    from paddle_tpu_torch.inference import BatchingConfig, InferenceServer

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 matmuls
    dims = (256, 1024, 1024, 64)
    layers = []
    for a, b in zip(dims, dims[1:]):
        layers += [nn.Linear(a, b, device="cuda"), nn.ReLU()]
    model = nn.Sequential(*layers[:-1])
    rng = np.random.default_rng(0)
    load_jax_state_dict(model, {
        name: (rng.standard_normal(tuple(p.shape)) / np.sqrt(
            p.shape[0] if p.dim() == 2 else 1)).astype(np.float32)
        for name, p in model.named_parameters()})
    xs = rng.standard_normal((512, 256)).astype(np.float32)
    with torch.inference_mode():
        own = model(torch.as_tensor(xs, device="cuda")).cpu().numpy()
    server = InferenceServer(model, BatchingConfig(max_batch_size=64,
                                                   max_delay_ms=2.0))
    n_clients, per_client = 8, 64
    sink = [None] * (n_clients * per_client)

    def client(k):
        idx = [(k * per_client + i) % 512 for i in range(per_client)]
        futs = [(i, server.submit(xs[i])) for i in idx]
        for j, (i, f) in enumerate(futs):
            sink[k * per_client + j] = (i, f.result(timeout=120)[0])

    with server:
        server.infer(xs[0])
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        dt = time.perf_counter() - t0
    rel = max(float(np.max(np.abs(y - own[i])) / np.max(np.abs(own[i])))
              for i, y in sink)
    total = n_clients * per_client
    print(f"InferenceServer (MLP {dims}, max_batch_size 64, max_delay_ms "
          f"2.0, {n_clients} clients x {per_client}; {card}): "
          f"{total / dt:.1f} req/s, mean batch {server.mean_batch_size:.1f}"
          f" ({server.stats['batches']} batches); worst row vs the "
          f"module's own forward {rel:.2e} of the row's max-abs (tol "
          f"1e-5; TF32 off)")
    if not rel <= 1e-5 or any(t.is_alive() for t in threads):
        raise AssertionError("InferenceServer outputs differ from the "
                             "module's forward")


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
    equal, the sentinel untouched, and K1's wrapper must count (k+1) x
    the draft's layers launches in the replay, all on the tensor-core
    route, the profiler seeing `rpa_tc_kernel`, no other paged kernel
    and a graph launch (`_paged_records`)."""
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
        pa.reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            emits = launch(kv, kv_scales, smp)
            torch.cuda.synchronize()
        seen["counted"] = {
            name: {k: n for k, n in c.items() if n}
            for name, c in (("launches", pa.launches),
                            ("tc_launches", pa.tc_launches))}
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
    want_tc = draft.config.num_layers * (SPEC_K + 1)
    paged_ok, paged_text = _paged_records(
        rows, seen["counted"], _pool_key(pa, kv_dtype), want_tc,
        "K1 in the replay")
    label = f"{kv_dtype}{' sampled' if sampled else ''}"
    same = torch.equal(seen["emits"], seen["eager"])
    print(f"draft gate {label}: propose graph replay vs eager run of one "
          f"window (rows at lag {seen['lags']}): emits equal {same}, draft "
          f"pools and scale planes byte-equal {seen['pools']}, after the "
          f"capture stream's workspace was outgrown ({outgrown}; sentinel "
          f"intact {bool((sentinel == 7).all())}); {paged_text}")
    if not (same and seen["pools"] and outgrown and seen["lags"] == [0, 1]
            and bool((sentinel == 7).all()) and paged_ok):
        paged = {e.key[:80]: e.count for e in rows
                 if e.device_type == DeviceType.CUDA and "rpa" in e.key}
        raise AssertionError(f"draft gate {label} failed; the profile's "
                             f"paged kernels: {paged}")


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
    and replay, under `key` ("w8a8" / "w4a8") only, and by route: a
    tick runs the engine's token budget (the wide route above 16 rows),
    a window its slots (the decode route up to 16); K1 12 per tick and
    12 x k per window run. Returns tok/s, the GEMM's launches, its
    launches by route and, for k > 1, the device ms per window (CUDA
    events around each graph replay, its launch latency included)."""
    from paddle_tpu_torch.inference import LLMServer
    from paddle_tpu_torch.profile_serve import EventTimer

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
        dev = EventTimer(fs, "replay") if fs else None
        pa.reset_launches()
        ig.reset_launches()
        t0 = time.perf_counter()
        futs = [server.submit(p, max_new_tokens=SERVE_NEW_TOKENS)
                for p in prompts]
        outs = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        gemm, launches = dict(ig.launches), dict(pa.launches)
        routes = dict(ig.route_launches)
        if dev is not None:
            dev.remove()
    dev_ms = float(np.median(dev.ms())) if dev is not None else None
    windows = eng.stats["fused_steps"] - st0["fused_steps"]
    ticks = eng.stats["steps"] - st0["steps"] - windows
    runs = ((fs.replays - runs0[0]) + (fs.warmups - runs0[1])) if fs else 0
    want_g = dict.fromkeys(gemm, 0)
    want_g[key] = linears * (ticks + k * runs)
    want_r = dict.fromkeys(routes, 0)
    for rows, n in ((eng.token_budget, ticks), (eng.num_slots, k * runs)):
        want_r[f"{key}_{'decode' if rows <= ig.DECODE_ROWS else 'wide'}"] \
            += linears * n
    want_k = dict.fromkeys(launches, 0)
    want_k["rpa"] = layers * (ticks + k * runs)
    if (gemm != want_g or routes != want_r or launches != want_k
            or (k > 1 and not windows)):
        raise AssertionError(
            f"weights serve {key} k={k}: GEMM launches {gemm} (by route "
            f"{routes}), paged {launches} in {ticks} ticks + {windows} "
            f"windows ({runs} warm-ups and replays); expected {want_g} "
            f"({want_r}), {want_k}")
    _check_outputs(prompts, outs, model.config.vocab_size)
    gen = SERVE_NEW_TOKENS * len(prompts)
    print(f"weights serve gpt_small {key} (bf16 KV, decode_k {k}): {gen} "
          f"generated in {wall:.3f} s = {gen / wall:.1f} tok/s, {ticks} "
          f"ticks + {windows} windows; int8 GEMM {want_g[key]} = {linears} "
          f"x ({ticks} + {k} x {runs}) (decode route "
          f"{routes[key + '_decode']}, wide {routes[key + '_wide']}), K1 "
          f"{want_k['rpa']}"
          + (f"; device {dev_ms:.3f} ms per window (median of "
             f"{len(dev.events)} replays)" if dev_ms is not None else ""))
    return dict(tok_s=gen / wall, launches=want_g[key], dev_ms=dev_ms,
                routes={r: routes[f"{key}_{r}"] for r in ig.ROUTES})


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


def weights_phase(ig, pa, random, card, bf16_window_ms=None):
    """5f: per weight width (int8, packed int4), the quantized serve model's
    decode_k 4 graph gate (`fused_gate`, the GEMM inside the replay),
    `LLMServer` bursts at decode_k 1 and 4 and the GEMM-vs-plain
    cross-check; the device ms per fused iteration at decode_k 4 beside
    `bf16_window_ms` / 4 (the bf16 model's decode_k 4 window, phase 5d).
    Returns {key: {k: burst}}."""
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
        fused_gate(pa, model, "bfloat16", 4, random, gemm=True)
        res[key] = {k: weights_serve(ig, pa, model, key, k, random)
                    for k in WEIGHT_KS}
        weights_cross(ig, model, key, random)
        del model
        it = res[key][4]["dev_ms"] / 4
        print(f"weights {key}: device {it:.4f} ms per fused iteration at "
              f"decode_k 4 (graph replay / 4)"
              + (f", the bf16 model's {bf16_window_ms / 4:.4f} ms "
                 f"({it / (bf16_window_ms / 4):.3f}x)"
                 if bf16_window_ms else "") + f" ({card})")
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


# ---- the rest of the training half (8b-8d, 10b) ----

TRAIN_1P3B_WARM, TRAIN_1P3B_STEPS = 2, 5


def _adam_state_dtypes(step):
    """The set of (parameter dtype) and of (Adam moment dtype) over the
    step's parameters."""
    states = step.optimizer._states
    return ({p.dtype for p in step._params},
            {states[id(p)][k].dtype for p in step._params
             for k in ("moment1", "moment2")})


def train_1p3b(fa, card):
    """Phase 8b: bench_gpt1p3b on the port. Returns the flash launches of
    the timed steps by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.observability.steptrace import model_flops
    from paddle_tpu_torch.profile_train import (
        BATCH_1P3B, H100_PEAK_BF16, SEQ_1P3B, bench_gpt1p3b_step, device_us,
        optimizer_device_us, timed_steps)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, step, ids = bench_gpt1p3b_step()
    build_s = time.perf_counter() - t0
    warm, _ = timed_steps(step, ids, TRAIN_1P3B_WARM)
    fa.reset_launches()
    losses, wall = timed_steps(step, ids, TRAIN_1P3B_STEPS)
    launches, tc = dict(fa.launches), dict(fa.tc_launches)
    L, n = cfg.num_layers, TRAIN_1P3B_STEPS
    want = {"flash_forward": 2 * L * n, "flash_bwd_dq": L * n,
            "flash_bwd_dkv": L * n}
    if launches != want or tc != want:
        raise AssertionError(f"8b: flash launches {launches}, tensor-core "
                             f"{tc} in {n} steps; expected {want}, all on "
                             "the tensor-core route")
    losses = warm + losses
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"8b: losses not finite and falling: {losses}")
    p_dtypes, m_dtypes = _adam_state_dtypes(step)
    if p_dtypes != {torch.bfloat16} or m_dtypes != {torch.float32}:
        raise AssertionError(f"8b: parameters {p_dtypes}, Adam moments "
                             f"{m_dtypes}; expected bf16 and f32")
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, pwall = timed_steps(step, ids, 1)
    dev_us = device_us(prof)
    opt_us = optimizer_device_us(prof)
    dt = wall / n
    tokens = BATCH_1P3B * SEQ_1P3B
    flops = model_flops(cfg, BATCH_1P3B, SEQ_1P3B)
    print(f"train 1.3B gpt_1p3b b{BATCH_1P3B}·s{SEQ_1P3B} O2 bf16 params, "
          f"per-layer recompute, fused head, AdamW ({card}): "
          f"{dt * 1e3:.3f} ms/step, {tokens / dt:.1f} tok/s, MFU "
          f"{flops / dt / H100_PEAK_BF16:.4f} ({flops / 1e12:.2f} TFLOP a "
          f"step at 989 TFLOP/s), loss {losses[0]:.4f} → {losses[-1]:.4f} "
          f"over {len(losses)} steps, peak memory {peak / 2**30:.2f} GiB; "
          f"profiled step {pwall * 1e3:.3f} ms wall, device "
          f"{dev_us / 1e3:.3f} ms, optimizer update "
          + (f"{opt_us / 1e3:.3f} ms = {100 * opt_us / dev_us:.1f}% of "
             "device time" if opt_us and dev_us else "not measured")
          + f"; launches {launches} in {n} steps (tensor-core {tc}); model "
          f"built in {build_s:.1f} s")
    del step
    gc.collect()
    torch.cuda.empty_cache()
    return launches


REMAT_POLICIES = (False, True, "dots_saveable", "everything_saveable")
REMAT_WARM, REMAT_STEPS = 2, 3
# the same ops on the same inputs, recomputed: loss and every gradient
# equal across the policies up to this share of each gradient's max-abs
REMAT_TOL = 1e-6


def remat_phase(fa, card):
    """Phase 8c: bench_gpt's BENCH_GPT_REMAT policies on the port."""
    from paddle_tpu_torch.profile_train import bench_gpt_step, timed_steps

    ref = None
    for policy in REMAT_POLICIES:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg, step, ids = bench_gpt_step(TRAIN_BATCH, TRAIN_SEQ, remat=policy)
        (loss,), _ = timed_steps(step, ids, 1)
        grads = {n: p.grad.detach().float().clone()
                 for n, p in step.model.named_parameters()}
        timed_steps(step, ids, REMAT_WARM - 1)
        fa.reset_launches()
        _, wall = timed_steps(step, ids, REMAT_STEPS)
        k3 = fa.launches["flash_forward"] / REMAT_STEPS
        peak = torch.cuda.max_memory_allocated()
        if ref is None:
            ref = (loss, grads)
            worst, where = 0.0, "-"
        else:
            worst, where, _ = _grad_diff(ref[1], grads)
            if not (abs(loss - ref[0]) <= REMAT_TOL * abs(ref[0])
                    and worst <= REMAT_TOL):
                raise AssertionError(
                    f"8c: remat={policy!r} first step loss {loss} vs "
                    f"{ref[0]}, worst gradient error {worst:.3e} ({where})")
        print(f"remat {policy!r} gpt_small b{TRAIN_BATCH}·s{TRAIN_SEQ} bf16 "
              f"O1 ({card}): {wall / REMAT_STEPS * 1e3:.3f} ms/step, peak "
              f"memory {peak / 2**30:.2f} GiB, K3 {k3:.0f} launches a step; "
              f"first loss {loss:.6f}, worst gradient error vs remat False "
              f"{worst:.3e} of its max-abs ({where}; tol {REMAT_TOL:.0e})")
        del step, grads
    gc.collect()
    torch.cuda.empty_cache()


AB_STEPS = 30


def steptrace_ab(card):
    """Phase 8d: bench_steptrace_overhead_ab on the port."""
    from paddle_tpu_torch import observability
    from paddle_tpu_torch.core.rng import seed
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.observability import steptrace, tracing
    from paddle_tpu_torch.observability.steptrace import model_flops
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models.gpt import (GPTConfig, GPTForCausalLM,
                                                  GPTPretrainingCriterion)

    # full mode's exports (at exit) go to the checkout's telemetry/
    os.environ.setdefault("PT_TELEMETRY_DIR", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "telemetry"))
    cfg = GPTConfig(vocab_size=256, hidden_size=64, num_layers=4,
                    num_heads=4, max_seq_len=64)
    batch, seq = 8, 32
    ids_np = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               (batch, seq))
    crit = GPTPretrainingCriterion()

    def run(mode):
        prev = observability.set_mode(mode)
        try:
            steptrace.reset()
            steptrace.arm_goodput(
                flops_per_step=model_flops(cfg, batch, seq),
                tokens_per_step=batch * seq)
            seed(0)
            m = GPTForCausalLM(cfg, seed=0)
            step = TrainStep(m, lambda mm, i: crit(mm(i), i),
                             AdamW(1e-3, parameters=m.parameters()))
            ids = torch.as_tensor(ids_np, device=m.device)
            step(ids)            # new signature: quiet
            step(ids)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses = [step(ids) for _ in range(AB_STEPS)]
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            recs = steptrace.recent_steps()
            for rec in recs:
                dts = sum(e["dt_s"] for e in rec["timeline"])
                if abs(dts - rec["total_s"]) > 1e-9:
                    raise AssertionError(
                        f"8d {mode}: step {rec['step']}'s phases sum to "
                        f"{dts} s, its wall time is {rec['total_s']} s")
            if len(recs) != AB_STEPS + 1:
                raise AssertionError(f"8d {mode}: {len(recs)} traced "
                                     f"steps; expected {AB_STEPS + 1}")
            per_phase = {}
            for rec in recs[1:]:        # the timed steps
                for e in rec["timeline"][1:]:
                    per_phase[e["phase"]] = per_phase.get(
                        e["phase"], 0.0) + e["dt_s"]
            return ([x.item() for x in losses], total,
                    {k: round(v / AB_STEPS * 1e3, 4)
                     for k, v in per_phase.items()})
        finally:
            observability.set_mode(prev)
            steptrace.reset()
            tracing.reset()

    totals = {"full": [], "metrics": []}
    ref, summary = None, None
    for _ in range(2):
        for mode in ("full", "metrics"):
            losses, t, ps = run(mode)
            totals[mode].append(t)
            summary = ps if mode == "full" else summary
            if ref is None:
                ref = losses
            elif losses != ref:
                raise AssertionError(f"8d: {mode} losses differ from the "
                                     f"first run's: {losses} vs {ref}")
    ratio = min(totals["full"]) / min(totals["metrics"])
    print(f"steptrace A/B ({card}): {AB_STEPS} steps a run, full "
          f"{totals['full']} s vs metrics {totals['metrics']} s, best "
          f"ratio {ratio:.4f} (reference bar 1.05); losses bit-identical "
          f"across the 4 runs ({ref[0]!r} → {ref[-1]!r}); full mode's "
          f"mean ms a step by phase {json.dumps(summary)}; process-wide "
          f"phase_summary() {json.dumps(steptrace.phase_summary())}")


def _warm_cosine_lr(epoch):
    """LinearWarmup(CosineAnnealingDecay(1e-4, 100), 2, 0, 1e-4)'s lr at
    `epoch`, recomputed in floats: the warm-up line below epoch 2, then
    the cosine at its own epoch (one behind)."""
    if epoch < 2:
        return (1e-4 - 0.0) * (epoch / float(2)) + 0.0
    return 0 + (1e-4 - 0) * (1 + math.cos(math.pi * (epoch - 1) / 100)) / 2


# 10b: the parameters' change over 3 O2 steps, kernel run vs plain run,
# in L2 of the plain run's change: Adam steps each element by about lr
# whatever its gradient's size, so an element whose tiny gradient takes
# the other sign moves the other way; a skipped update gives 1, a
# flipped one 2
O2_MOVE_TOL = 0.25


def _global_norm(grads):
    return float(torch.sqrt(sum((g.float() ** 2).sum() for g in grads)))


def train_cross_check_o2(fa, card):
    """Phase 10b: the O2 step at gpt_1p3b's width (2 layers) through the
    kernels vs their plain versions, with a schedule and clipping; then
    the GradScaler's skip."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW, lr
    from paddle_tpu_torch.profile_train import gpt1p3b_model, o2_loss

    cfg, kern = gpt1p3b_model(layers=2, model_seed=10)
    _, plain = gpt1p3b_model(layers=2, model_seed=0)
    plain.load_state_dict(kern.state_dict())
    start = {n: p.detach().clone() for n, p in kern.named_parameters()}
    ids = torch.as_tensor(np.random.default_rng(10).integers(
        0, cfg.vocab_size, (1, 2048)), device=kern.device)
    names = ("flash_forward", "flash_bwd_dq", "flash_bwd_dkv")
    kernels = {n: getattr(fa, n) for n in names}
    cast_inputs_for = amp.cast_inputs_for
    sums = []

    def spy(op, tensors):
        # the f32 loss sum, before O2's divide rounds it to bf16
        if op == "divide":
            sums.append(float(tensors[0].detach()))
        return cast_inputs_for(op, tensors)

    runs = []
    for model, swap in ((kern, False), (plain, True)):
        sched = lr.LinearWarmup(lr.CosineAnnealingDecay(1e-4, 100), 2, 0,
                                1e-4)
        opt = AdamW(sched, parameters=model.parameters(),
                    grad_clip=ClipGradByGlobalNorm(1.0))
        step = TrainStep(model, o2_loss, opt)
        fa.reset_launches()
        losses, lrs = [], []
        sums.clear()
        amp.cast_inputs_for = spy
        try:
            if swap:
                for n in names:
                    setattr(fa, n, getattr(fa, n + "_plain"))
            for i in range(3):
                lrs.append(opt.get_lr())
                losses.append(float(step(ids)))
                sched.step()
                if i == 0:
                    # step 1's raw gradients, its clip, and its update at
                    # the warm-up's lr 0 (which leaves every parameter)
                    pairs = [(p, p.grad) for p in step._params]
                    grads = {n: p.grad.clone()
                             for n, p in model.named_parameters()}
                    norm = _global_norm(g for _, g in pairs)
                    clipped = _global_norm(
                        g for _, g in opt._grad_clip(pairs))
                    # and a clip that must bite, at 0.3 of the norm
                    bitten = _global_norm(g for _, g in ClipGradByGlobalNorm(
                        0.3 * norm)(pairs)) / (0.3 * norm)
                    kept = all(torch.equal(p, start[n]) for n, p in
                               model.named_parameters())
            torch.cuda.synchronize()
        finally:
            amp.cast_inputs_for = cast_inputs_for
            for n in names:
                setattr(fa, n, kernels[n])
        moved = {n: (p.detach().float() - start[n].float())
                 for n, p in model.named_parameters()}
        runs.append(dict(loss=losses, lr=lrs, sum=list(sums), grads=grads,
                         norm=norm, clipped=clipped, bitten=bitten,
                         kept=kept, moved=moved,
                         launches=dict(fa.launches),
                         tc=dict(fa.tc_launches), opt=opt))
    k, pl = runs
    lk, lp, rk, nk, tk, opt = (k["loss"], pl["loss"], k["lr"], k["launches"],
                               k["tc"], k["opt"])
    want_lr = [_warm_cosine_lr(e) for e in range(3)]
    L = cfg.num_layers
    want = {"flash_forward": 2 * L * 3, "flash_bwd_dq": L * 3,
            "flash_bwd_dkv": L * 3}
    if not (nk == want and tk == want
            and set(pl["launches"].values()) == {0}):
        raise AssertionError(f"10b: kernel run launched {nk} (tensor-core "
                             f"{tk}), plain run {pl['launches']}; expected "
                             f"{want}")
    if not (rk == pl["lr"] == want_lr):
        raise AssertionError(f"10b: lr sequences {rk} / {pl['lr']}, "
                             f"recomputed {want_lr}")
    rel = [abs(a - b) / abs(b) for a, b in zip(lk, lp)]
    if not (all(np.isfinite(lk)) and max(rel) <= BF16_LOSS_TOL):
        raise AssertionError(f"10b: losses {lk} vs plain {lp} (relative "
                             f"{rel}; tol {BF16_LOSS_TOL:.0e})")
    sum_rel = [abs(a - b) / abs(b) for a, b in zip(k["sum"], pl["sum"])]
    if not (len(sum_rel) == 3 and all(np.isfinite(k["sum"]))
            and max(sum_rel) <= BF16_LOSS_TOL):
        raise AssertionError(f"10b: f32 loss sums {k['sum']} vs plain "
                             f"{pl['sum']} (relative {sum_rel}; tol "
                             f"{BF16_LOSS_TOL:.0e})")
    worst, where, median = _grad_diff(pl["grads"], k["grads"])
    if not (worst <= BF16_GRAD_TOL and median <= BF16_GRAD_MEDIAN_TOL):
        raise AssertionError(f"10b: step 1's gradients, kernels vs plain: "
                             f"worst {worst:.3e} ({where}), median "
                             f"{median:.3e} of their max-abs")
    norm_rel = abs(k["norm"] - pl["norm"]) / pl["norm"]
    clip_rel = [abs(r[c] - w) / w for r in runs for c, w in
                (("clipped", min(r["norm"], 1.0)), ("bitten", 1.0))]
    if not (norm_rel <= BF16_GRAD_MEDIAN_TOL and max(clip_rel) <= 1e-3
            and k["kept"] and pl["kept"]):
        raise AssertionError(
            f"10b: step 1's global norms {k['norm']} / {pl['norm']}, "
            f"after the clip {k['clipped']} / {pl['clipped']}, a clip at "
            f"0.3 of the norm off by {clip_rel[1]} / {clip_rel[3]}; parameters "
            f"left by the lr-0 update: {k['kept']} / {pl['kept']}")
    dk = torch.cat([k["moved"][n].view(-1) for n in pl["moved"]])
    dp = torch.cat([pl["moved"][n].view(-1) for n in pl["moved"]])
    move_rel = float((dk - dp).norm() / dp.norm())
    if not (float(dp.norm()) > 0 and move_rel <= O2_MOVE_TOL):
        raise AssertionError(f"10b: the parameters' change over 3 steps, "
                             f"kernels vs plain, off by {move_rel:.3e} in "
                             f"L2 of the plain run's (tol {O2_MOVE_TOL})")
    # two overflowing GradScaler steps on the kernel model
    scaler = GradScaler(init_loss_scaling=1e38)
    params = [p for p in kern.parameters()]
    before = [p.detach().clone() for p in params]
    natural = []
    for _ in range(2):
        opt.clear_grad()
        scaled = scaler.scale(o2_loss(kern, ids))
        scaled.backward()
        overflow = not all(bool(torch.isfinite(p.grad).all())
                           for p in params)
        natural.append(overflow)
        if not overflow:
            # bf16 keeps f32's exponent range: the 1e38 scale overflows the
            # scaled loss (inf) but the backward is seeded with the scale
            # itself and stays finite; plant the overflow an overflowing
            # backward leaves
            with torch.no_grad():
                params[0].grad.view(-1)[0] = float("inf")
        scaler.step(opt)
        scaler.update()
    same = all(torch.equal(p, b) for p, b in zip(params, before))
    if not (same and scaler._scale == 1e38 * 0.5
            and scaler._bad_steps == 0
            and not torch.isfinite(scaled.detach())):
        raise AssertionError(f"10b: GradScaler at 1e38 — parameters "
                             f"byte-equal {same}, scale {scaler._scale}, "
                             f"bad steps {scaler._bad_steps}")
    print(f"train cross-check O2 gpt_1p3b width, 2 layers, b1·s2048, "
          f"recompute, AdamW(LinearWarmup(CosineAnnealingDecay)) + "
          f"ClipGradByGlobalNorm(1.0), kernels vs plain versions on the "
          f"card ({card}): losses {lk} vs {lp} (relative {rel}; tol "
          f"{BF16_LOSS_TOL:.0e}), lr {rk} equal to the recomputation; "
          f"f32 loss sums before the O2 divide {k['sum']} vs {pl['sum']} "
          f"(relative {sum_rel}); step 1's bf16 gradients: worst "
          f"{worst:.3e} of their max-abs ({where}; tol "
          f"{BF16_GRAD_TOL:.0e}), median {median:.3e} (tol "
          f"{BF16_GRAD_MEDIAN_TOL:.0e}); global norm {k['norm']:.6f} vs "
          f"{pl['norm']:.6f}, after ClipGradByGlobalNorm(1.0) "
          f"{k['clipped']:.6f} vs {pl['clipped']:.6f}, at 0.3 of the "
          f"norm off by {max(clip_rel):.2e} (tol 1e-3); lr-0 step left "
          f"every parameter; parameters' change over 3 steps off by "
          f"{move_rel:.3e} in L2 (tol {O2_MOVE_TOL}; L2 of the change "
          f"{float(dp.norm()):.4f}); "
          f"kernel run launches {nk}, tensor-core {tk}. GradScaler at 1e38: "
          f"scaled loss {float(scaled.detach())}, two steps skipped "
          f"(parameters byte-equal), scale → {scaler._scale:.3e}; backward overflowed "
          f"by itself: {natural}")
    del kern, plain, runs, opt, k, pl, dk, dp, start
    gc.collect()
    torch.cuda.empty_cache()


def _kernel_row(name, route, source, replaces, launches, r):
    return {"name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]}


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of an earlier checkout whose "
                    "int8 GEMM phase 3 times beside this one's")
    args = ap.parse_args(argv)
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
    gres = check_int8_gemm(
        ig, flush, load_parent(args.parent) if args.parent else None)
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
    t_fleet = time.perf_counter()
    fleet = fleet_phase(pa, model, card)
    print(f"fleet phase: {time.perf_counter() - t_fleet:.1f} s")
    t_tier = time.perf_counter()
    tier = tier_phase(pa, model, card)
    print(f"tier phase: {time.perf_counter() - t_tier:.1f} s")
    t_gen = time.perf_counter()
    generate_phase(model, card)
    serving_phase(card)
    print(f"generate and server phases: "
          f"{time.perf_counter() - t_gen:.1f} s")
    del model
    drafts = draft_phase(pa, random, card)
    weights = weights_phase(ig, pa, random, card,
                            fused[("bfloat16", 4)]["greedy"]["dev_ms"])
    structured = structured_phase(pa, card)
    cross_check()
    cx_launches = cross_quant_spec(pa)
    fa_launches = train(fa)
    t_train = time.perf_counter()
    fa_1p3b = train_1p3b(fa, card)
    remat_phase(fa, card)
    steptrace_ab(card)
    print(f"train phases 8b-8d: {time.perf_counter() - t_train:.1f} s")
    train_cross_check()
    train_cross_check_bf16(fa)
    t_o2 = time.perf_counter()
    train_cross_check_o2(fa, card)
    print(f"train cross-check O2 (10b): {time.perf_counter() - t_o2:.1f} s")
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
    # 5h: K1 (bf16 pool) across the 2-replica router burst
    kernels[0]["fleet_burst_launches"] = fleet["router"]["burst_launches"]
    # 5i: K1 in the tier-on session burst (bf16 pool) and in the spill ->
    # prefetch round trips (int8, int4 pools)
    for i, kv in ((0, "bfloat16"), (2, "int8"), (3, "int4")):
        kernels[i]["tier_burst_launches"] = tier[kv]
    # the int8 GEMM, a row per kernel route: the decode kernel timed at
    # the decode tick (T 8), the wide route (row quantize + wide kernel)
    # at the mixed tick (T 256), with its times at the fleet's budget (T
    # 48) beside; one decoder layer's four linears, bf16 x. `launches`:
    # the route's linears counted in the 5f burst that drives it (the
    # decode route: the decode_k 4 burst's windows; the wide route: the
    # k=1 burst's ticks); `burst_launches`: the route's count in each 5f
    # burst
    for key in GEMM_WIDTHS:
        for T, route, burst in ((8, "decode", 4), (256, "wide", 1)):
            r = gres[(key, T)]
            counts = {f"decode_k {k}": weights[key][k]["routes"][route]
                      for k in WEIGHT_KS}
            if not counts[f"decode_k {burst}"]:
                raise AssertionError(f"the int8 GEMM's {route} route ran "
                                     f"no time in 5f's {key} bursts")
            row = _kernel_row(f"{key}_linear_t{T}", "cuda", ig.SOURCE,
                              ig.REPLACES[key], counts[f"decode_k {burst}"],
                              r)
            row["kernel_route"] = route
            row["burst_launches"] = counts
            row["device_launches_per_linear"] = r[
                "device_launches_per_linear"]
            row["bf16_addmm_ms"] = r["bf16_ms"]
            row["per_shape_ms"] = {shape: x["ms"]
                                   for shape, x in r["shapes"].items()}
            row["host_us"] = _mean_of(r, "host_us")
            if "parent_ms" in r:
                row["parent_ms"] = r["parent_ms"]
            if route == "wide":
                w = gres[(key, 48)]
                row["t48"] = dict(
                    ms=w["ms"], plain_ms=w["plain_ms"],
                    bound_ms=w["bound_ms"], bound_by=w["bound_by"],
                    library_ms=w["library_ms"], bf16_addmm_ms=w["bf16_ms"],
                    per_shape_ms={shape: x["ms"]
                                  for shape, x in w["shapes"].items()},
                    **({"parent_ms": w["parent_ms"]} if "parent_ms" in w
                       else {}))
            kernels.append(row)
    for name, r in fres.items():
        row = _kernel_row(name, "cuda", fa.SOURCE, fa.REPLACES[name],
                          fa_launches[name], r)
        # 8b: bench_gpt1p3b's launches, and the times at its shape
        row["train_1p3b_launches"] = fa_1p3b[name]
        row["shape_1p3b"] = r["shape_1p3b"]
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
