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
              head_dim 64 / 128: the tensor-core K3-K5); and at bench_bert's
              bidirectional b·h 384, s 512, d 64, bf16, with no mask and
              with phase 12 (c)'s lengths as kv_lens (a row's length
              repeated over its 12 heads).
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
5l. disagg  — prefill -> decode across two processes on the one card
              (`disagg_phase`): the port's launcher (`python -m
              paddle_tpu_torch.distributed.launch --nproc_per_node=2`)
              runs paddle_tpu_torch/profile_disagg.py at gpt_small (bf16
              weights from seed 1234), bf16 and int8 pools, 8 slots,
              page 16, budget 256, the serve phase's 8 prompt lengths
              and 32 new tokens, greedy, under the reference chaos test's
              plan (a sock.send error at rank 0's call 1, a 0.2 s
              sock.recv stall at rank 1's call 0). Rank 0 prefills every
              prompt at once on a prefill-only engine and streams each
              payload over the xproc socket transport; rank 1 serves the
              prompts on a local engine, then imports the streamed pages
              into a decode engine as they arrive. Gates: the launcher
              exits 0 (a dying rank fails it); per pool, rank 1's tokens
              equal its local engine's, pages imported = sent > 0, trace
              ids equal in order, each stamped kv_transfer; rank 0 resent
              (send_retries >= 1) and journaled the injection; K1 in both
              ranks (and rank 1's local engine), all on the tensor-core
              route. Prints MB a request, each rank's legs, socket MB/s,
              disaggregated vs local TTFT, rank 1's decode tok/s, each
              rank's peak memory and the phase's seconds.
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
8e. distributed — checkpointed, fault-tolerant data-parallel training
              at bench_gpt's geometry (gpt_small b16·s1024, bf16 O1,
              AdamW(1e-4), `profile_dist.build`): (a) `DistributedTrainStep`
              at world 1, ZeRO os_g, 3 warm-up + 10 timed steps: the losses
              bit-equal to phase 8's `TrainStep` run, K3-K5 12 x 10 each on
              the tensor-core route; ms/step, tok/s, MFU beside phase 8's.
              (b) `run_with_fault_tolerance` around 6 steps with an async
              `Checkpointer` save every 3 and a chaos fault (scope "step")
              at step 5: it restores step 3 and ends with the final loss and
              every parameter and Adam moment byte-equal to an
              uninterrupted run; a shard of the newest checkpoint truncated,
              `load_latest` falls back to step 3; prints the checkpoint's
              bytes, each save's step-path stall and its commit's seconds
              off the path, and the load's. (c) two processes sharing the
              card under the launcher (`profile_dist.py`, mesh sharding 2,
              ZeRO os_g, 8 of the 16 rows a rank, gradients over gloo
              through the host) for 2 steps: each rank's losses within
              1e-3 relative of (a)'s first 2, K3-K5 12 x 2 a rank, each
              rank's shards in one checkpoint with DONE.0 and DONE.1, and
              a world-1 load of it taking the next step within 1e-3 of
              (a)'s; prints s/step, the all-reduce's bytes and seconds and
              each rank's peak memory.
8f. tensor and pipeline parallelism — (a) bench.py:427's
              bench_gpt1p3b_pp at world 1: `PipelinedGPTForCausalLM(
              gpt_1p3b, n_micro=2, remat="layer")` under bf16 O2,
              `AdamW(1e-4)`, `HybridTrainStep` on the degenerate mesh, b2·
              s2048, 2 warm-up + 5 timed steps: K3 96 launches a step (24
              layers x 2 micro-batches, forward and recompute), K4 and K5
              48, all tensor-core; against the serial GPTForCausalLM at
              the same weights (carried by `convert.pipelined_to_gpt_state`),
              batch and remat, timed in the same call as the yardstick:
              step 0's f32 loss within 5e-5 relative (the serial one read
              before O2's divide) and its gradients within 1e-1 of their
              max-abs (median 5e-2), where two planted faults (the first
              layer skipped, the last micro-batch dropped) must fail both.
              Prints ms/step, tok/s, MFU at 989 TFLOP/s, peak memory and
              one profiled step's device time for each. (b) pp 2 x mp 2
              as four processes sharing the card (`profile_dist.py --mesh
              pp=2,mp=2`): gpt_small's widths, depth cut from 12 layers
              to 6 (to make room for 8h), b8·s1024, n_micro 4, per-layer
              remat, bf16 O1, 2 steps (3 until the room for phase 13),
              gloo for every collective through the
              host, p2p over the socket transport: each rank's losses
              within 3e-5 relative of a world-1 run on the card (same seed
              and batch; the two planted faults at world 1 must fail it),
              K3 24 launches a step a rank (3 layers x 4 x 2),
              K4 and K5 12, all tensor-core, each rank's executed schedule
              equal to its stage's row of `schedule_table(4, 2)`, and the
              ranks' one checkpoint loaded at world 1 equal to their
              gathered shards. Prints s/step, the p2p and mp all-reduce
              bytes and seconds, the tied wte's all-reduce and each rank's
              peak memory.
8g. mixture of experts and the int8 gradient exchange — (a) bench.py:
              427's bench_gpt1p3b_pp arm with BENCH_MOE_EXPERTS:
              `PipelinedGPTForCausalLM` at gpt_1p3b's widths (d 2048, 32
              heads of 64) with its depth cut from 24 layers to 4, 8
              experts of hidden 8192, top-1, capacity 1.25, n_micro 2,
              per-layer remat, bf16 O2, AdamW(1e-4), HybridTrainStep on
              the degenerate mesh, b2·s2048, 2 warm-up + 5 timed steps.
              Gate 1: one full-width MoE FFN (T 2048) at top-1 and top-2,
              f32 with TF32 off, card vs CPU from the same weights: the
              same expert for every token, the same kept set, outputs
              within 1e-4 of their max-abs, aux within 1e-6. Gate 2: step
              0 through K3-K5 against the same weights with their plain
              versions, the plain run routed as the kernels' run routed
              (an ulp of a bf16 gate logit flips a near tie): the f32
              loss within 1e-4 relative, the gradients within 1e-1 of
              their max-abs (median 5e-2; an H100 reads 2.5e-6 and 1.2e-2
              / 8.0e-3, the faults at least 6.3e-4 and 0.82 / 0.42), the
              share of tokens the plain run would route alike printed.
              Two faults planted on the card
              (the capacity drop skipped; the gate probability left out of
              the combine) must fail gates 1 and 2. Gate 3: K3 16 launches
              a step (4 layers x 2 micro-batches, forward and recompute),
              K4 and K5 8, all tensor-core. Gate 4: the 7 steps' losses
              (aux term included) finite and falling. Prints ms/step,
              tok/s, MFU at 989 TFLOP/s over the active top-1 FLOPs, peak
              memory, tokens per expert and the dropped share, and one
              profiled step's device ms (expert GEMMs, dispatch / combine,
              attention, the rest). (b) ep 2 as two processes sharing the
              card (`profile_dist.py --mesh ep=2 --moe 4`): gpt_small
              widths, 2 layers, b2·s1024, n_micro 2, bf16 O1, capacity
              4.0, 2 steps (3 until the room for phase 13): each rank's
              step 0 loss (the same weights)
              within 3e-5 relative of a world-1 run on the card, the next
              steps within 1e-3 (bf16 rounding orders, magnified by Adam),
              the all-to-all replaced by a self-copy must fail both, each
              rank
              holds 2 of the 4 experts, K3-K5 8 / 4 / 4 a step a rank;
              prints the all-to-all's calls, bytes and seconds a step and
              s/step. (c) in 8e (c)'s launch, after its exact steps: 3
              steps of `DistributedTrainStep(quant_allreduce=True)` from
              the same start: losses within 5 % of the exact ones, the
              exchange's bytes at most 0.26 of the exact f32 exchange's,
              the int8 mean of a whole gradient within one int8 step of
              the exact mean in every block (an H100 reads 0.994; the
              exchange skipped, a planted fault, reads 118 and must fail
              it), a NaN planted in rank 0's gradient
              decoding to NaN in the same block on both ranks; prints the
              exchange's seconds a step beside the exact one's.
8h. sequence parallelism and the auto-parallel Engine — (a) the lse
              route: `flash_attention_lse_bhd` at gpt_1p3b's attention
              shape (B·H 32, S 2048, D 64, bf16), causal and full, with
              random cotangents on out AND lse: out, lse, dq, dk and dv
              against the plain f32 autograd of the same function (each
              error over the reference's max-abs: out 2e-2, lse 1e-3
              absolute, gradients 5e-2); the lse cotangent dropped (a
              planted fault) must fail the gradients' gate. Then two
              processes sharing the card (`profile_dist.py --ring-check
              --auto`): `ring_flash_attention` at sp 2 over one
              4096-token causal sequence (b 1, 32 heads, head_dim 64,
              bf16), each rank's output and q / k / v gradient shards
              within 2e-2 (out) / 5e-2 (gradients) of flash attention
              over the whole sequence and of the dense f32
              `ring_attention`; K3 once causal on rank 0, once causal and
              once full on rank 1, K4 / K5 alike, all tensor-core. (c) in
              the same launch: the auto-parallel Engine in full-auto
              mode over the two processes (the H100 ClusterSpec lays the
              world out), gpt_small widths at 2 layers as plain layers
              (`profile_dist.auto_gpt`), f32, b4·s512, AdamW(1e-4), 3
              steps: the plan printed, the losses within 5e-5 relative of
              the same model's serial steps on the card. (b) the
              pipelined GPT at pp 2 x sp 2, four processes (`profile_dist
              --mesh pp=2,sp=2`): gpt_small widths, depth cut to 4
              layers, b4·s2048, n_micro 2, per-layer remat, bf16 O1,
              HybridTrainStep, AdamW(1e-4), 2 steps (3 until the room for
              phase 13): step 0's loss within
              3e-5 relative of world 1 on the card (the same weights),
              the next steps within 1e-3, the sp replicas' parameters
              bit-equal after the steps; K3 2·(idx + 1), K4 / K5 idx + 1
              per layer and micro-batch on sp rank idx, all
              tensor-core. Three planted faults each fail a gate: a ring
              that skips its blocks below the diagonal and labels
              shifted within each shard (step 0's loss), the gradients
              left unsummed over sp (the replicas' parameters). Prints
              s/step, the ring's frames, bytes and seconds a step, peak
              memory a rank.
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
11. vision   — bench.py's vision arms on the port's conv, pooling,
              batch-norm and initializer layers (no Pallas kernel is on
              this path: cuDNN's convolutions, torch's pooling and batch
              norm; cuDNN picks algorithms without a benchmark sweep).
              (a) ResNet-50 whole, 1000 classes, f32 with TF32 off, b2 at
              3x224x224, the same seeded weights on the card and the CPU:
              one TrainStep with Momentum(0.1) on each, and one in f64
              on the CPU: the loss within 1e-4 relative of the CPU's
              f32; the gradients no farther from the f64 step's than 2x
              the CPU f32's (worst and median of each gradient's
              max-abs difference over its max-abs: random-init ResNet-50
              is ill-conditioned in f32, the CPU's own f32 0.2 / 2e-2
              off), every batch norm's running `_mean` / `_variance`
              within max(1e-5, 2x the CPU f32's distance) of the f64
              step's (of max(1, max-abs)); the remat=True step's
              statistics within 1e-5 of remat=False's; `F.conv2d` with
              "SAME" at stride 2 (sizes 56 and 57) within 1e-4 of the
              convolution over XLA's pairs written out. Three planted
              faults must each fail its gate by 2x: the running variance
              by torch's own rule (unbiased, momentum 0.1), a second
              update under remat, "SAME" split symmetrically.
              (b) bench_resnet: b64 at 3x224x224, Momentum(0.1), bf16 O1
              under `amp.auto_cast`, TrainStep: step 0's loss within 1e-2
              relative of the f32 step 0 from the same weights, then 2
              warm-up and 10 timed steps ending in a synchronize; every
              loss finite, the running statistics moved; ms/step, img/s,
              peak memory and MFU (forward FLOPs counted from the conv
              and linear shapes the model sees, x3, over 989 TFLOP/s).
              (c) bench_mnist: LeNet b128 at 1x28x28, Momentum(0.01),
              f32, the eager backward / step / clear_grad loop: 3 steps
              on the card and on the CPU from the same weights, losses
              and parameters within 1e-5; then 20 timed steps, ms/step
              and steps/s.
12. bert     — BERT / ERNIE pretraining (text.models.bert) on the tensor
              API, K3-K5 bidirectional (no new kernel). (a) BERT-base
              widths at 2 layers, f32 with TF32 off, b2·s128: one
              TrainStep (AdamW) on the card and on the CPU from the same
              weights, the loss within 1e-5 relative, each gradient's
              max-abs difference within 1e-5 of its max-abs; two planted
              card steps, attention forced causal and TF32 allowed in
              the matmuls, must each fail a gate by 2x. (b) bench_bert (bench.py:199): bert_base,
              b32·s512, bf16 O1, AdamW(1e-4), TrainStep, ids / labels /
              NSP labels from default_rng(0) as bench.py:227-233, both
              heads (forward() + BertPretrainingCriterion, and
              fused_mlm_loss) from the same weights: 3 warm-up and 10
              timed steps each; ms/step, samples/s, peak memory, MFU
              (bench.py:247-252's FLOP count over 989 TFLOP/s); step 0's
              O1 loss within 1e-2 relative of the f32 loss at those
              weights; K3-K5 12 x 13 each a head, all on the tensor
              cores, none causal. (c) a padded b32·s512 batch as 1-D
              lengths (one row full, one short, the rest drawn): one O1
              step, K3-K5 12 each with kv_lens on the tensor cores,
              against the same batch's step through the 2-D keep-mask
              (the dense path): the sequence output on the valid
              positions (the worst row's mean difference) within 2e-2 of
              its mean, each gradient within 6e-2 of its max-abs; the
              step with no mask (planted: the padding attended) must
              fail a gate by 2x. (d) the tensor API on CUDA
              tensors against the port's CPU result, 31 cases (the
              traps: descending sorts and top-k with ties, repeated-index
              scatter / put_along_axis / index_put, unique's first
              occurrence and its NaNs folded into one, nonzero, mode;
              and a spread of the rest): integer, bool and index outputs
              equal, float ones within 1e-5 of max(1, max-abs), NaNs in
              the same places.
13. mt       — Transformer-base (`nn.Transformer()` at its defaults: d 512,
              8 heads, 6 + 6 layers, FFN 2048, post-norm; dropout 0.1,
              attention and activation dropout 0) with source and target
              embeddings over a 37,000-id vocabulary scaled by √512 plus
              sinusoidal positions, the projection tied to the target
              embedding, label smoothing 0.1 (`F.label_smooth` +
              `cross_entropy(soft_label=True)`), Adam(0.9, 0.98, 1e-9)
              under NoamDecay(512, 4000); K3-K5 run the encoder's
              self-attention and the equal-length cross-attention (no new
              kernel). (a) its widths at 2 + 2 layers, f32 with TF32
              off, dropout 0, b2 · source 128 · target 128: one
              TrainStep on the card and on the CPU from the same weights,
              the loss within 1e-5 relative, each gradient within 1e-4
              of its max-abs; the decoder without its tgt_mask (planted)
              must fail a gate by 2x. (b) 6 + 6 layers, b32 · source 128
              · target 128, bf16 O1, `jit.TrainStep`, 3 warm-up and 10
              timed steps: ms/step, target tokens/s, peak memory, MFU
              (the step's FLOPs from the shapes over 989 TFLOP/s); step
              0's O1 loss within 1e-2 of the f32 loss under the same
              dropout masks; K3-K5 12 x 13 each, all on the tensor
              cores, none causal. (c) beam search with the caches on the
              (b) model, f32: b8 · source 128, beam 4, at most 32 new
              tokens, `BeamSearchDecoder` + `dynamic_decode` over a cell
              carrying `TransformerDecoder.gen_cache(memory)` (static
              caches and memory tiled by `tile_beam_merge_with_batch`):
              every step's cached logits within 1e-4 of a no-cache
              decoder forward over the same prefixes; the caches not
              appended (planted) must fail it by 2x; tokens/s; the CPU's
              decode beside it for information. (d) a 2-layer
              bidirectional LSTM (512), a GRU and a SimpleRNN, b32 ·
              t128, f32 with TF32 off: outputs, final states and
              gradients card vs CPU and the card's fused route vs its
              plain loop within 1e-4 of max-abs; ms forward + backward.
14. hapi     — the high-level vision training path (no new kernel;
              cuDNN's convolutions through the port's `F.conv2d`). (a)
              every family of the rest of the zoo (MobileNet v1 / v2 /
              v3 small / large at scale 0.25-0.5, VGG-11 with batch norm,
              AlexNet, SqueezeNet 1.0 / 1.1, DenseNet-121, GoogLeNet with
              its aux heads, Inception-v3, ShuffleNetV2 x0.25 and its
              swish variant) at the CPU tests' sizes (64 px, 96 for
              AlexNet and Inception-v3, 10 classes; VGG without its
              classifier, read out by a random projection), b2,
              dropout 0, f32 with TF32 off, one forward + backward on
              the card and on the CPU (in 4 processes meanwhile) from the
              same weights: in eval mode the loss and every gradient
              (max-abs difference over max-abs) within 1e-4; in train
              mode the loss within 1e-4 and the gradients within 1e-3
              of their norm, but for MobileNetV2, DenseNet-121 and
              Inception-v3, whose train-mode gradients at random init
              amplify rounding past any such limit (eval mode alone);
              MobileNetV2 without its residual add and ShuffleNetV2
              without its channel shuffle (planted) must fail the eval
              gate by 2x, and the latter the train gate. (b) an ImageNet-style folder written
              from a seed into a temporary directory (16 classes, 1024
              training and 256 eval images, uint8 HWC `.npy`, sides
              256-384) read by `DatasetFolder(loader=np.load)` through
              the training transform (RandomResizedCrop(224),
              RandomHorizontalFlip, Normalize(ImageNet mean / std, HWC),
              Transpose) and the eval one (Resize(256), CenterCrop(224),
              Normalize, Transpose); the eval loader's batches at
              num_workers 4 byte-equal, in order, to num_workers 0;
              images/s at 0 and 4 workers. (c) `hapi.Model` over
              `vision.models.mobilenet_v2()` (width 1.0, 1000 classes,
              3.5 M parameters): prepare(Momentum(0.1, 0.9),
              CrossEntropyLoss, Accuracy(topk=(1, 5))), fit(train, eval,
              batch_size 64, epochs 1, num_workers 4) in f32: 16 finite
              losses, the optimizer's `_step_count` and
              `pt_train_steps_total` each 16 up; the weights after fit
              evaluated on the card and on the CPU port (TF32 off) over
              the 256 eval images: the loss within 1e-6 relative, the
              logits within 1e-5 of max-abs, top-1 / top-5 equal but on
              counted near-ties, and the card's eval with TF32 allowed
              (planted) failing a gate by 2x; one `fit` step of 16 eval
              images (one a class) from those weights, card vs CPU: the
              loss within 1e-5, the update within 5e-2 of its norm, the
              step over labels shifted by one image (planted) failing a
              gate by 2x; `predict` after `save` and a fresh
              `Model.load` bit-equal to `predict` before; ms/step and
              images/s from `profiler.benchmark()`, the same TrainStep on
              a batch already on the card, the idle share of one profiled
              step, peak memory, MFU = 3 x 2 x `hapi.flops` MACs at 224²
              x 64 / step time over the f32 peak (67 TFLOP/s) and over
              989 TFLOP/s.

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
"tier_burst_launches", and 5l's per-rank counts (bf16, int8 pools) as
"disagg_launches"; the GEMM's decode route: 5f's decode_k 4
burst, its wide route: 5f's k=1 burst, each route's count in both
bursts as "burst_launches"; K3-K5 also phase 8b's launches as
"train_1p3b_launches" and their times at its shape as "shape_1p3b",
phase 8e's launches at world 1 and in each rank of dp 2 as
"dist_launches", phase 8f's at world 1 (1.3B) and in each rank of
pp 2 x mp 2 as "pipe_launches", phase 8g's at world 1 (the MoE GPT)
and in each rank of ep 2 as "moe_launches", and phase 8h's in each rank
of the sp 2 ring check and of pp 2 x sp 2 as "sp_launches", with their
causal share as "sp_causal_launches", and phase 12's in each
bench_bert head and in the padded batch as "bert_launches", with their
times at bench_bert's bidirectional shape as "shape_bert", and phase
13 (b)'s as "mt_launches", with their times at its shape [B·H 256, S
128, D 64] as "shape_mt");
the last line is
{"ok": true, "device": {...}}. Exits non-zero without printing a result
when no CUDA device is present.
"""
import contextlib
import copy
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


# a profiler session that records no device activity at all (the
# tracer missed the whole window, seen once in a GEMM gate) is taken
# again, up to this many sessions in all
PROFILE_TRIES = 3


def _any_device_record(rows):
    from torch.autograd import DeviceType

    return any(e.device_type == DeviceType.CUDA for e in rows)


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
        for _ in range(PROFILE_TRIES):
            ig.reset_launches()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for fn in calls:
                    fn()
                torch.cuda.synchronize()
            rows = prof.key_averages()
            if _any_device_record(rows):
                break
            print(f"int8 GEMM at T {T}: the profiler recorded no device "
                  "activity at all; profiling the calls again")
        counted = {k: n for k, n in ig.route_launches.items() if n}
        if sum(counted.values()) != len(calls) or any(
                not k.endswith(route) for k in counted):
            raise AssertionError(f"T {T}: the wrapper counted {counted} "
                                 f"for {len(calls)} linears on the {route} "
                                 "route")
        seen = _gemm_records(rows, route, len(calls),
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
# phase 12's call: bench_bert (bert_base at b32·s512) → b·h 384, head_dim
# 768 / 12, bidirectional
FA_BERT = dict(bh=32 * 12, s=512, d=64, dtype=torch.bfloat16, causal=False,
               lens=None, b=32)
# phase 13 (b)'s call: Transformer-base at b32, source and target 128 →
# b·h 256, head_dim 512 / 8, bidirectional (the encoder's self-attention
# and the equal-length cross-attention)
FA_MT = dict(bh=32 * 8, s=128, d=64, dtype=torch.bfloat16, causal=False,
             lens=None, b=32)


def bert_pad_lens(b=32, s=512):
    """12 (c)'s padded batch as lengths: row 0 at full length, row 1
    short (s // 14), the rest drawn from default_rng(2) in [1, s]."""
    lens = np.random.default_rng(2).integers(1, s + 1, b)
    lens[0], lens[1] = s, max(1, s // 14)
    return lens


# phase 12 (c)'s call: the same shape with those lengths as kv_lens, one
# a row repeated over its 12 heads (the [b, s, h, d] → [b·h, s, d] cut)
FA_BERT_PAD = dict(FA_BERT, lens=np.repeat(bert_pad_lens(), 12).tolist())
# smaller cases: f32, ragged seq (not a multiple of the 64-row tile),
# non-causal, kv_lens with a 0 row, seq_k != seq_q (`sk`), and the 32-
# and 16-row tile configs (head_dim 96, 256); bf16 ones on the edges of
# the tensor-core route (head_dim 64 / 128) and one bf16 case off it
# (head_dim 32)
FA_CASES = [
    FA_MAIN,
    FA_1P3B,
    FA_BERT,
    FA_BERT_PAD,
    FA_MT,
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
    forward (causal as the case is), and its backward (dq, dk, dv in one
    call) as the autograd node that forward recorded, called directly —
    whichever backend SDPA picked, and without the autograd engine's host
    time in the timed window."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, h = case["b"], case["bh"] // case["b"]
    causal = case["causal"]
    q, k, v, dout = (t.reshape(b, h, *t.shape[1:]) for t in x)
    fwd_ms = _median_ms(lambda: sdpa(q, k, v, is_causal=causal), flush)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    node = sdpa(qg, kg, vg, is_causal=causal).grad_fn
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
              f"{case['d']} {'causal' if causal else 'full'}: kernel "
              f"{r['ms']:.4f} ms, plain "
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
    (bench_gpt's FA_MAIN, bench_gpt1p3b's FA_1P3B, bench_bert's FA_BERT,
    Transformer-base's FA_MT:
    kernel, plain, library) beside the bound and returns their numbers by
    kernel, the FA_1P3B ones under "shape_1p3b", the FA_BERT ones under
    "shape_bert", the FA_MT ones (phase 13) under "shape_mt"."""
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
        if case is FA_MAIN or case is FA_1P3B or case is FA_BERT \
                or case is FA_MT:
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
        for key, case in (("shape_1p3b", FA_1P3B), ("shape_bert", FA_BERT),
                          ("shape_mt", FA_MT)):
            r[key] = dict(timed[id(case)][name],
                          shape=[case["bh"], case["s"], case["d"]],
                          causal=case["causal"])
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


# ---- disaggregated prefill -> decode, two processes on the card (5l) ----

DISAGG_KV = ("bfloat16", "int8")
DISAGG_TIMEOUT_S = 240
# the reference's 2-process chaos test's shape (tests/test_fleet_router.py)
DISAGG_PLAN = {"seed": 77, "injectors": [
    {"scope": "sock.send", "kind": "error", "at": [1], "ranks": [0]},
    {"scope": "sock.recv", "kind": "delay", "at": [0], "delay_s": 0.2,
     "ranks": [1]}]}
DISAGG_KEY = {"bfloat16": "rpa", "int8": "rpa_int8"}


def launch_disagg(out_dir, model="gpt_small", device="cuda",
                  timeout=DISAGG_TIMEOUT_S):
    """The launcher (`launcher_cmd`) with --nproc_per_node=2 over
    paddle_tpu_torch/profile_disagg.py under DISAGG_PLAN, from the
    checkout's root; the launcher runs in a session of its own, and a
    timeout SIGTERMs it (it kills its pod) and then SIGKILLs the rest.
    Returns (rank 0's json, rank 1's json, seconds)."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [*launcher_cmd(2, f"{out_dir}/log"),
           os.path.join("paddle_tpu_torch", "profile_disagg.py"),
           "--model", model, "--device", device,
           "--kv", ",".join(DISAGG_KV), "--out", out_dir]
    env = dict(os.environ, PYTHONPATH=root,
               PT_CHAOS_PLAN=json.dumps(DISAGG_PLAN))
    t0 = time.perf_counter()
    p = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True,
                         start_new_session=True)
    try:
        out, _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, 15)
        try:
            out, _ = p.communicate(timeout=20)
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, 9)
            out, _ = p.communicate()
        raise AssertionError(f"5l: the launch ran past {timeout} s:\n"
                             f"{out[-4000:]}")
    seconds = time.perf_counter() - t0
    if p.returncode != 0:
        log1 = os.path.join(out_dir, "log", "default.rank1.log")
        tail = open(log1).read()[-4000:] if os.path.exists(log1) else ""
        raise AssertionError(f"5l: the launcher exited {p.returncode}:\n"
                             f"{out[-4000:]}\n--- rank 1 ---\n{tail}")
    outs = []
    for r in range(2):
        with open(os.path.join(out_dir, f"disagg_out_{r}.json")) as f:
            outs.append(json.load(f))
    return outs[0], outs[1], seconds


def disagg_gates(r0, r1, out_dir):
    """5l's gates on the ranks' outputs, the K1 counts aside (see
    `disagg_k1`): per pool, rank 1's tokens equal its local engine's,
    every page sent is imported, trace ids equal in order and each
    stamped `kv_transfer`; rank 0 resent at least once (the injected
    sock.send fault) and journaled the injection."""
    for kv in DISAGG_KV:
        p0, p1 = r0["pools"][kv], r1["pools"][kv]
        bad = [(r["prompt"], r["first_diff"]) for r in p1["received"]
               if not r["equal"]]
        if bad:
            raise AssertionError(
                f"5l {kv}: the disaggregated tokens differ from the local "
                f"engine's at (prompt, first different token) {bad}")
        if not p1["kv_pages_imported"] == p0["sent_pages"] > 0:
            raise AssertionError(
                f"5l {kv}: {p0['sent_pages']} pages sent, "
                f"{p1['kv_pages_imported']} imported")
        ids = p0["trace_ids"]
        if (p1["recv_trace_ids"] != ids or len(set(ids)) != len(ids)
                or not all(r["transfer_stamped"] for r in p1["received"])):
            raise AssertionError(f"5l {kv}: trace ids sent {ids}, "
                                 f"received {p1['recv_trace_ids']}")
    if r0["send_retries"] < 1:
        raise AssertionError("5l: the injected sock.send fault was not "
                             "absorbed by a resend (send_retries 0)")
    with open(os.path.join(out_dir, "log", "anomalies.rank0.jsonl")) as f:
        events = [json.loads(line) for line in f]
    if not any(e["kind"] == "chaos_injected" and e["scope"] == "sock.send"
               for e in events):
        raise AssertionError("5l: rank 0's journal holds no sock.send "
                             "injection")


def disagg_k1(r0, r1):
    """K1 launched in both ranks on every pool, all on its tensor-core
    route (a bf16 q), and no other paged kernel. Returns {pool:
    {"rank0": n, "rank1": n}} (rank 1: its decode engine's round)."""
    out = {}
    for kv in DISAGG_KV:
        key = DISAGG_KEY[kv]
        counts = {}
        for name, c in (("rank0", r0["pools"][kv]),
                        ("rank1", r1["pools"][kv]),
                        ("rank1 local", r1["pools"][kv]["local"])):
            n = c["launches"][key]
            others = {k: v for k, v in c["launches"].items()
                      if v and k != key}
            if not n or c["tc_launches"] != c["launches"] or others:
                raise AssertionError(
                    f"5l {kv}: {name} launched {c['launches']} (tensor-"
                    f"core route {c['tc_launches']}); expected K1 "
                    f"'{key}' only, all on the tensor-core route")
            counts[name] = n
        out[kv] = {"rank0": counts["rank0"], "rank1": counts["rank1"]}
    return out


def _med(xs):
    return float(np.median(np.asarray(xs, dtype=np.float64)))


def disagg_report(r0, r1, card, seconds):
    """Print 5l's numbers, per pool kind, beside the card."""
    for kv in DISAGG_KV:
        p0, p1 = r0["pools"][kv], r1["pools"][kv]
        sent = {r["trace_id"]: r for r in p0["streamed"]}
        mb, wire_mb, wire_s, socket_mbs, legs = [], 0.0, 0.0, [], []
        for r in p1["received"]:
            s0 = sent[r["trace_id"]]
            f_mb = s0["frame_bytes"] / 1e6
            # send start (rank 0) -> frame unpacked (rank 1), wall clocks
            # of one host; less the pack and unpack: the socket's share
            total_ms = (r["t_arrived"] - s0["t_send0"]) * 1e3
            wire_ms = total_ms - s0["pack_ms"] - r["unpack_ms"]
            mb.append(f_mb)
            legs.append(total_ms)
            if wire_ms > 0:
                socket_mbs.append(f_mb / (wire_ms / 1e3))
                wire_mb += f_mb
                wire_s += wire_ms / 1e3
        ttft = [r["ttft_ms"] for r in p1["received"]]
        lttft = p1["local"]["ttft_ms"]
        faults = (" (the plan's injected faults land in this round: the "
                  "0.2 s recv stall and one resend)"
                  if kv == DISAGG_KV[0] else "")
        print(f"disagg {kv} ({card}): {r0['model']}, {len(mb)} requests "
              f"(prompts {r0['prompt_lens']}, {r0['new_tokens']} new "
              f"tokens, greedy), {p0['sent_pages']} pages streamed rank 0 "
              f"-> rank 1; MB a request median {_med(mb):.3f} (min "
              f"{min(mb):.3f}, max {max(mb):.3f}); rank 0 medians: gather "
              f"{_med([s['gather_ms'] for s in p0['streamed']]):.3f} ms, "
              f"pack {_med([s['pack_ms'] for s in p0['streamed']]):.3f} ms, "
              f"pack + send {_med([s['send_ms'] for s in p0['streamed']]):.3f}"
              f" ms; send start -> unpacked on rank 1 "
              f"{_med(legs):.3f} ms (max {max(legs):.3f}); rank 1 medians: "
              f"unpack {_med([r['unpack_ms'] for r in p1['received']]):.3f}"
              f" ms, unpacked -> imported "
              f"{_med([r['import_ms'] for r in p1['received']]):.3f} ms; "
              f"socket {wire_mb / wire_s if wire_s else float('nan'):.1f} "
              f"MB/s over all frames (median of requests "
              f"{_med(socket_mbs) if socket_mbs else float('nan'):.1f}); "
              f"TTFT disaggregated (queued on rank 0 -> first token on "
              f"rank 1) median {_med(ttft):.1f} ms max {max(ttft):.1f} ms, "
              f"local engine median {_med(lttft):.1f} ms max "
              f"{max(lttft):.1f} ms; rank 1 decode "
              f"{p1['decode_tok_s']:.1f} tok/s, local engine "
              f"{p1['local']['tok_s']:.1f} tok/s (prefill included); "
              f"peak MB rank 0 {p0['peak_mb']:.1f}, rank 1 decode "
              f"{p1['peak_mb']:.1f}, rank 1 local {p1['local']['peak_mb']:.1f};"
              f" tokens equal the local engine's, pages imported "
              f"{p1['kv_pages_imported']} = sent{faults}")
    print(f"disagg phase ({card}): launcher to exit {seconds:.1f} s, "
          f"rank 0 {r0['seconds']:.1f} s and rank 1 {r1['seconds']:.1f} s "
          f"of pool rounds; send_retries {r0['send_retries']}")


def disagg_phase(card):
    """5l: prefill on rank 0 -> KV pages over the socket -> decode on
    rank 1, two processes on the one card (module docstring)."""
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="disagg_") as d:
        r0, r1, seconds = launch_disagg(d)
        disagg_gates(r0, r1, d)
        k1 = disagg_k1(r0, r1)
        disagg_report(r0, r1, card, seconds)
    print(f"disagg K1 launches ({card}): {k1} (rank 1 local engine: "
          + ", ".join(f"{kv} {r1['pools'][kv]['local']['launches'][DISAGG_KEY[kv]]}"
                      for kv in DISAGG_KV) + ")")
    return k1


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
    del step
    return launches, losses, dt * 1e3


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


# ---- checkpointed, fault-tolerant data-parallel training (8e) ----

DIST_WARM, DIST_STEPS = 3, 10
# 8e (b): a save every CKPT_EVERY steps, a fault at step CKPT_FAULT_AT,
# CKPT_STEPS in all
CKPT_EVERY, CKPT_FAULT_AT, CKPT_STEPS = 3, 5, 6
# 8e (c): two ranks, two steps (phase 11 took the third's room)
DIST_RANKS, DIST_DP2_STEPS = 2, 2
DIST_TIMEOUT_S = 300
# 8e (c): two ranks on half batches vs one rank on the whole batch, bf16
# O1: each rank's backward reduces its 8 rows in another order than the
# whole batch's, the two gradients are averaged after, and Adam's
# per-element normalization magnifies differences in small gradient
# elements into steps of up to lr — the losses of the next steps differ
# by far less than this
DIST_LOSS_RTOL = 1e-3


def _dist_step(device="cuda", model="gpt_small", zero="os_g"):
    from paddle_tpu_torch.profile_dist import build

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return build(model, torch.device(device), zero)


def _flash_gate(fa, want, label, counted=True):
    launches, tc = dict(fa.launches), dict(fa.tc_launches)
    if counted and (set(launches.values()) != {want}
                    or set(tc.values()) != {want}):
        raise AssertionError(f"{label}: flash launches {launches}, tensor-"
                             f"core {tc}; expected {want} of each, all on "
                             "the tensor-core route")
    return launches


def dist_world1(fa, card, ref_losses, ref_ms, device="cuda",
                model="gpt_small", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                counted=True):
    """8e (a): DistributedTrainStep at world 1, ZeRO os_g, bench_gpt's
    geometry: its losses against phase 8's TrainStep run (same seed and
    batch), K3-K5 12 x steps. Returns (all losses, launches)."""
    from paddle_tpu_torch.observability.steptrace import model_flops
    from paddle_tpu_torch.profile_dist import global_batch
    from paddle_tpu_torch.profile_train import H100_PEAK_BF16, timed_steps

    cfg, step = _dist_step(device, model)
    ids = global_batch(cfg, batch, seq).to(device)
    warm, _ = timed_steps(step, ids, DIST_WARM)
    fa.reset_launches()
    losses, wall = timed_steps(step, ids, DIST_STEPS)
    launches = _flash_gate(fa, cfg.num_layers * DIST_STEPS, "8e (a)",
                           counted)
    losses = warm + losses
    if losses != list(ref_losses):
        diff = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        raise AssertionError(f"8e (a): DistributedTrainStep losses {losses} "
                             f"differ from TrainStep's {list(ref_losses)} "
                             f"(worst relative {diff:.3e}); expected "
                             "bit-equal")
    dt = wall / DIST_STEPS
    mfu = model_flops(cfg, batch, seq) / dt / H100_PEAK_BF16
    print(f"8e (a) DistributedTrainStep world 1, ZeRO os_g, {model} "
          f"b{batch}·s{seq} AdamW ({card}): {dt * 1e3:.3f} ms/step "
          f"(phase 8's TrainStep {ref_ms:.3f}: {dt * 1e3 / ref_ms:.4f}x), "
          f"{batch * seq / dt:.1f} tok/s, MFU {mfu:.4f} (989 TFLOP/s); "
          f"{len(losses)} losses bit-equal to TrainStep's ({losses[0]:.6f}"
          f" → {losses[-1]:.6f}); launches {launches} = "
          f"{cfg.num_layers} x {DIST_STEPS}, all tensor-core")
    del step
    return losses, launches


def _ckpt_run(step, ids, root, plan=None):
    """CKPT_STEPS steps under run_with_fault_tolerance, an async save
    every CKPT_EVERY steps; returns (losses by step, starts, saves)."""
    from paddle_tpu_torch.distributed import chaos
    from paddle_tpu_torch.distributed.checkpoint import Checkpointer
    from paddle_tpu_torch.distributed.fleet.elastic import (
        run_with_fault_tolerance)

    ck = Checkpointer(root, model=step.model, train_step=step,
                      async_save=True, keep=3)
    losses, starts, saves = {}, [], []

    def train_fn(start):
        starts.append(start)
        for s in range(start, CKPT_STEPS):
            chaos.fire("step")
            losses[s] = float(step(ids))
            if (s + 1) % CKPT_EVERY == 0:
                ck.save(s + 1)
                saves.append(ck.last_stats)
        ck.wait()
        return CKPT_STEPS

    if plan is not None:
        chaos.install(plan)
    try:
        run_with_fault_tolerance(train_fn, ck)
    finally:
        chaos.clear()
    return losses, starts, saves, ck


def _state_equal(a, b):
    """Every parameter and every Adam accumulator of two steps' models
    byte-equal: the names that differ."""
    pa, pb = dict(a.model.named_parameters()), dict(b.model.named_parameters())
    bad = [n for n in pa if not torch.equal(pa[n], pb[n])]
    sa, sb = a.optimizer._states, b.optimizer._states
    for n in pa:
        for k, v in sa[id(pa[n])].items():
            if not torch.equal(v, sb[id(pb[n])][k]):
                bad.append(f"{n}/{k}")
    return bad


def ckpt_phase(card, device="cuda", model="gpt_small", batch=TRAIN_BATCH,
               seq=TRAIN_SEQ):
    """8e (b): run_with_fault_tolerance around bench_gpt's step with an
    async save every 3 steps and an injected fault at step 5: it restores
    step 3 and ends bit-equal to an uninterrupted 6-step run; a torn
    checkpoint is skipped by load_latest."""
    from paddle_tpu_torch.distributed.checkpoint import Checkpointer
    from paddle_tpu_torch.profile_dist import global_batch

    plan = {"injectors": [{"scope": "step", "kind": "error",
                           "at": [CKPT_FAULT_AT]}]}
    with tempfile.TemporaryDirectory(prefix="ckpt_") as d:
        cfg, ft = _dist_step(device, model)
        ids = global_batch(cfg, batch, seq).to(device)
        t0 = time.perf_counter()
        ft_losses, starts, saves, ck = _ckpt_run(ft, ids, d + "/ft", plan)
        ft_s = time.perf_counter() - t0
        if starts != [0, CKPT_EVERY]:
            raise AssertionError(f"8e (b): the run started at {starts}; "
                                 f"expected [0, {CKPT_EVERY}] (a restore "
                                 f"of step {CKPT_EVERY})")
        _, ref = _dist_step(device, model)
        ref_losses, _, _, _ = _ckpt_run(ref, ids, d + "/ref")
        bad = _state_equal(ft, ref)
        if ft_losses != ref_losses or bad:
            raise AssertionError(f"8e (b): the resumed run's losses "
                                 f"{ft_losses} vs {ref_losses}; tensors "
                                 f"not byte-equal: {bad[:8]}")
        # the torn fallback: truncate one shard of the newest checkpoint
        newest = ck._dir(CKPT_STEPS)
        with open(os.path.join(newest, "meta.json")) as f:
            meta = json.load(f)
        nbytes = sum(meta["integrity"]["shards"].values())
        shard = os.path.join(newest, "shards",
                             meta["leaves"][0]["shards"][0]["file"])
        with open(shard, "r+b") as f:
            f.truncate(os.path.getsize(shard) - 8)
        got = Checkpointer(d + "/ft", model=ft.model,
                           train_step=ft).load_latest()
        if got != CKPT_EVERY:
            raise AssertionError(f"8e (b): load_latest past a torn "
                                 f"checkpoint gave {got}; expected "
                                 f"{CKPT_EVERY}")
        t0 = time.perf_counter()
        Checkpointer(d + "/ref", model=ref.model, train_step=ref).load(
            CKPT_STEPS)
        load_s = time.perf_counter() - t0
    stats = [(s["stall_s"], s["committer"].seconds, s["committer"].bytes)
             for s in saves]
    print(f"8e (b) checkpoint + fault tolerance, {model} b{batch}·s{seq} "
          f"AdamW ({card}): fault at step {CKPT_FAULT_AT} → "
          f"restored step {CKPT_EVERY}, finished {CKPT_STEPS} steps in "
          f"{ft_s:.2f} s; final loss {ft_losses[CKPT_STEPS - 1]:.6f} and "
          f"every parameter and moment byte-equal to the uninterrupted "
          f"run; checkpoint {nbytes} bytes ({nbytes / 1e9:.4f} GB); saves "
          + "; ".join(f"step-path stall {st * 1e3:.1f} ms "
                      f"({b / st / 1e9:.2f} GB/s), commit {c:.3f} s off the "
                      f"path ({b / c / 1e9:.3f} GB/s)"
                      for st, c, b in stats)
          + f"; load of {CKPT_STEPS} {load_s:.3f} s "
          f"({nbytes / load_s / 1e9:.3f} GB/s); a truncated shard in "
          f"step {CKPT_STEPS}'s checkpoint: load_latest fell back to "
          f"{got}")
    del ft, ref
    return {"bytes": nbytes, "saves": stats, "load_s": load_s}



def launcher_cmd(nproc, log_dir):
    """The user's launch command for `nproc` ranks: `python -m
    paddle_tpu_torch.distributed.launch`, which hosts their store."""
    return [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
            f"--nproc_per_node={nproc}", f"--log_dir={log_dir}"]


STARTUP_STAMPS = ("imports", "rendezvous", "cuda_context", "kernels",
                  "blas", "model", "dynamo", "ready")


def print_startup(label, outs, t_wall):
    """What each rank of a launch did before its first step, from its
    record's "startup" stamps (profile_dist.py): the seconds each stage
    took, the launcher's spawn first (the command's start to the rank's
    first line), then each step's seconds."""
    parts = []
    for o in outs:
        st = o.get("startup")
        if not st:
            continue
        prev, segs = 0.0, [f"spawn {st['proc_start'] - t_wall:.2f}"]
        for k in STARTUP_STAMPS:
            if k in st:
                segs.append(f"{k} {st[k] - prev:.2f}")
                prev = st[k]
        steps = o.get("step_seconds") or []
        segs.append("steps " + ", ".join(f"{x:.2f}" for x in steps))
        parts.append(f"rank {o['rank']}: " + ", ".join(segs))
    print(f"{label} startup, seconds a stage: " + "; ".join(parts))

def launch_dist(out_dir, model="gpt_small", device="cuda", batch=TRAIN_BATCH,
                seq=TRAIN_SEQ, timeout=DIST_TIMEOUT_S):
    """The launcher (`launcher_cmd`) with --nproc_per_node=2 over
    paddle_tpu_torch/profile_dist.py at ZeRO os_g over a sharding axis
    of 2, saving a checkpoint; returns (the ranks' json, seconds)."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [*launcher_cmd(DIST_RANKS, f"{out_dir}/log"),
           os.path.join("paddle_tpu_torch", "profile_dist.py"),
           "--model", model, "--device", device, "--sharding",
           str(DIST_RANKS), "--zero", "os_g", "--steps",
           str(DIST_DP2_STEPS), "--batch", str(batch), "--seq", str(seq),
           "--ckpt", os.path.join(out_dir, "ck"), "--out", out_dir,
           "--quant-steps", str(QUANT_STEPS)]
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("PT_CHAOS_PLAN", None)
    t0 = time.perf_counter()
    t_wall = time.time()
    p = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True,
                         start_new_session=True)
    try:
        out, _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, 15)
        try:
            out, _ = p.communicate(timeout=20)
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, 9)
            out, _ = p.communicate()
        raise AssertionError(f"8e (c): the launch ran past {timeout} s:\n"
                             f"{out[-4000:]}")
    seconds = time.perf_counter() - t0
    if p.returncode != 0:
        log1 = os.path.join(out_dir, "log", "default.rank1.log")
        tail = open(log1).read()[-4000:] if os.path.exists(log1) else ""
        raise AssertionError(f"8e (c): the launcher exited {p.returncode}:"
                             f"\n{out[-4000:]}\n--- rank 1 ---\n{tail}")
    outs = []
    for r in range(DIST_RANKS):
        with open(os.path.join(out_dir, f"dist_out_{r}.json")) as f:
            outs.append(json.load(f))
    print_startup("8e (c)", outs, t_wall)
    return outs, seconds


def _rel(a, b):
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def dist_dp2(card, world1_losses, device="cuda", model="gpt_small",
             batch=TRAIN_BATCH, seq=TRAIN_SEQ, counted=True):
    """8e (c): two processes sharing the card at ZeRO os_g (sharding axis
    2, 8 rows a rank), gradients through gloo on the host; then a world-1
    process (this one) loads their checkpoint and takes the next step.
    The same launch then runs 8g (c)'s int8 steps. Returns each rank's
    flash launches and the ranks' records."""
    from paddle_tpu_torch.distributed.checkpoint import Checkpointer
    from paddle_tpu_torch.profile_dist import global_batch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    n = DIST_DP2_STEPS
    with tempfile.TemporaryDirectory(prefix="dist_") as d:
        outs, seconds = launch_dist(d, model, device, batch, seq)
        for r, o in enumerate(outs):
            rel = _rel(o["losses"], world1_losses[:n])
            if rel > DIST_LOSS_RTOL:
                raise AssertionError(f"8e (c): rank {r}'s losses "
                                     f"{o['losses']} vs world 1's "
                                     f"{world1_losses[:n]} (relative "
                                     f"{rel:.3e} > {DIST_LOSS_RTOL})")
            if counted:
                from paddle_tpu_torch.profile_dist import MODELS

                L = MODELS[model][0]().num_layers
                want = {k: L * n for k in o["launches"]}
                if o["launches"] != want or o["tc_launches"] != want:
                    raise AssertionError(f"8e (c): rank {r} launched "
                                         f"{o['launches']} (tensor-core "
                                         f"{o['tc_launches']}); expected "
                                         f"{want}")
            if not o["ckpt_files"]:
                raise AssertionError(f"8e (c): rank {r} wrote no shard "
                                     "into the checkpoint")
        ck_dir = os.path.join(d, "ck", f"ckpt-{n:08d}")
        markers = sorted(f for f in os.listdir(ck_dir)
                         if f.startswith("DONE."))
        if markers != [f"DONE.{r}" for r in range(DIST_RANKS)]:
            raise AssertionError(f"8e (c): commit markers {markers}")
        cfg, step = _dist_step(device, model)
        got = Checkpointer(os.path.join(d, "ck"), model=step.model,
                           train_step=step).load_latest()
        ids = global_batch(cfg, batch, seq).to(device)
        nxt = float(step(ids))
        rel_next = abs(nxt - world1_losses[n]) / abs(world1_losses[n])
        if got != n or rel_next > DIST_LOSS_RTOL:
            raise AssertionError(f"8e (c): world 1 loaded step {got} and "
                                 f"took loss {nxt} vs the uninterrupted "
                                 f"{world1_losses[n]} (relative "
                                 f"{rel_next:.3e})")
        del step
    o0, o1 = outs
    rels = [_rel(o["losses"], world1_losses[:n]) for o in outs]
    print(f"8e (c) dp 2 on one card (two processes, mesh sharding 2, ZeRO "
          f"os_g, {batch // DIST_RANKS} rows a rank, gradients over gloo "
          f"through the host; {card}): launcher to exit {seconds:.1f} s; "
          + "; ".join(
              f"rank {o['rank']}: s/step {[round(s, 4) for s in o['step_seconds']]}"
              f", all-reduce {o['comm'][-1]['bytes']} bytes in "
              f"{o['comm'][-1]['seconds']:.3f} s "
              f"({o['comm'][-1]['bytes'] / o['comm'][-1]['seconds'] / 1e9:.3f}"
              f" GB/s; step's gradient exchange {o['comm'][-1]['step_comm_s']:.3f}"
              f" s; parameter blocks' all-gather "
              f"{o['comm'][-1].get('gather_s', 0.0):.3f} s), peak "
              + (f"{o['peak_mb']:.0f} MB" if o["peak_mb"] is not None
                 else "not measured")
              + f", losses {o['losses']} "
              f"(relative to world 1 {rel:.2e}), launches {o['launches']}, "
              f"checkpoint save {o['ckpt_seconds']:.2f} s, "
              f"{len(o['ckpt_files'])} shard files"
              for o, rel in zip(outs, rels))
          + f"; DONE.0 and DONE.1 present; world 1 loaded step {n} and "
          f"took loss {nxt:.6f} vs the uninterrupted {world1_losses[n]:.6f}"
          f" (relative {rel_next:.2e}; tol {DIST_LOSS_RTOL:.0e})")
    return {f"rank{o['rank']}": o["launches"] for o in (o0, o1)}, outs


def dist_phase(fa, card, train_losses, train_ms):
    """8e: (a), (b), (c) in turn; returns the flash launches of (a) and
    of each rank of (c), and (c)'s records (for 8g (c))."""
    t0 = time.perf_counter()
    losses, launches = dist_world1(fa, card, train_losses, train_ms)
    ckpt = ckpt_phase(card)
    ranks, outs = dist_dp2(card, losses)
    print(f"8e phase: {time.perf_counter() - t0:.1f} s")
    return {"world1": launches, **ranks, "ckpt": ckpt, "outs": outs}


# ---- tensor and pipeline parallelism (8f) ----

PP_WARM, PP_STEPS = 2, 5
PP_BATCH, PP_SEQ, PP_MICRO = 2, 2048, 2
# 8f (a), against the serial GPT at the same weights and batch: step 0's
# f32 loss (the serial one taken before O2's divide rounds it to bf16),
# and step 0's bf16 gradients (each one's max-abs difference over its
# max-abs: the worst, and the median over the gradients). The pipelined
# GPT's GELU is jax's tanh form (the reference's gpt_pipeline.py; the flat
# GPT's is the exact erf) and it sums two micro-batches' bf16 gradients.
# Each limit lies between the sound run's gap and the gaps of two faults
# the phase plants at the same weights (the first layer skipped; the last
# micro-batch dropped), which must fail it. On an H100: loss 7.1e-6 sound,
# 1.7e-3 and 1.9e-4 planted; gradients worst 2.3e-2 / median 1.2e-2
# sound, at least 1.46 / 0.88 planted.
PP_LOSS_RTOL = 5e-5
PP_GRAD_TOL, PP_GRAD_MEDIAN_TOL = 1e-1, 5e-2
MESH_RANKS, MESH_STEPS = 4, 3
# 8f (b)'s depth, cut from gpt_small's 12 layers to make room for 8h
# (at 4 layers the dropped-micro-batch fault lands within 3 % of the
# loss gate)
MESH_LAYERS = 6
MESH_BATCH, MESH_SEQ = 8, 1024
MESH_TIMEOUT_S = 300
# 8f (b): four ranks (pp 2 x mp 2) against world 1, bf16 O1: each
# row-parallel matmul's two bf16 partial products are rounded before the
# all-reduce adds them, and the micro losses meet in another order. The
# limit lies between that gap and the planted faults' at world 1 (on an
# H100 at 12 layers: 1.17e-5 sound; 6.1e-5 and 2.1e-4 planted).
MESH_LOSS_RTOL = 3e-5


def _pp_o2_loss(m, ids):
    from paddle_tpu_torch import amp

    with amp.auto_cast(level="O2", dtype="bfloat16"):
        return m.loss(ids)


def planted_faults(model, ids, loss_fn, grads=False):
    """A pipelined GPT's loss at its current weights with a fault planted:
    the first decoder layer skipped, and the last micro-batch dropped.
    {fault: (f32 loss, the parameters' gradients or None)}; the model is
    left as it was (no update, gradients cleared)."""
    M = model.n_micro
    stacked = model._stacked
    out = {}
    for name in ("first layer skipped", "last micro-batch dropped"):
        x = ids
        if name == "first layer skipped":
            model._stacked = lambda: {k: v[1:] for k, v in stacked().items()}
        else:
            model.n_micro = M - 1
            x = ids[:ids.shape[0] // M * (M - 1)]
        try:
            with torch.set_grad_enabled(grads):
                loss = loss_fn(model, x)
                g = None
                if grads:
                    loss.backward()
                    g = {n: p.grad.clone()
                         for n, p in model.named_parameters()}
        finally:
            model.__dict__.pop("_stacked", None)
            model.n_micro = M
            model.zero_grad(set_to_none=True)
        out[name] = (float(loss.detach()), g)
    return out


def pp_world1(fa, card):
    """8f (a): bench_gpt1p3b_pp on the card at world 1 — the pipelined
    GPT-1.3B (n_micro 2, per-layer remat) under bf16 O2 through
    HybridTrainStep on the degenerate mesh, beside the serial
    GPTForCausalLM step at the same weights (carried by convert), batch
    and remat policy. Step 0's f32 loss and gradients are held to the
    serial step's, and shown to catch two planted faults. Returns the
    flash launches of the timed steps."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.convert import pipelined_to_gpt_state
    from paddle_tpu_torch.distributed import mesh as tmesh
    from paddle_tpu_torch.jit import HybridTrainStep, TrainStep
    from paddle_tpu_torch.observability.steptrace import model_flops
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.profile_train import (H100_PEAK_BF16, _ids,
                                                kernel_rows, o2_loss,
                                                timed_steps)
    from paddle_tpu_torch.text.models.gpt import GPTForCausalLM, gpt_1p3b
    from paddle_tpu_torch.text.models.gpt_pipeline import (
        PipelinedGPTForCausalLM)
    from torch.profiler import ProfilerActivity, profile

    def profiled(step):
        # one more step under the profiler: its device time by kernel
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            timed_steps(step, ids, 1)
        out = {}
        for e in kernel_rows(prof):
            out[e.key] = out.get(e.key, 0) + e.self_device_time_total
        return out

    tmesh.reset_mesh()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = gpt_1p3b(recompute=True)
    pipe = PipelinedGPTForCausalLM(cfg, n_micro=PP_MICRO, remat="layer",
                                   device="cuda", seed=0)
    flat = GPTForCausalLM(cfg, device="cuda", seed=0)
    with torch.no_grad():
        sd = pipelined_to_gpt_state(
            {n: p.detach() for n, p in pipe.named_parameters()}, cfg)
        for n, p in flat.named_parameters():
            p.copy_(sd[n])
    del sd
    amp.decorate(pipe, level="O2", dtype="bfloat16")
    amp.decorate(flat, level="O2", dtype="bfloat16")
    build_s = time.perf_counter() - t0
    ids = _ids(cfg, PP_BATCH, PP_SEQ, "cuda")
    tokens = PP_BATCH * (PP_SEQ - 1)

    def flat_grads(model):
        return pipelined_to_gpt_state(
            {n: p.grad for n, p in model.named_parameters()}, cfg)

    # the serial step, its f32 loss sums taken before O2's divide
    serial = TrainStep(flat, o2_loss,
                       AdamW(1e-4, parameters=flat.parameters()))
    cast_inputs_for, sums = amp.cast_inputs_for, []

    def spy(op, tensors):
        if op == "divide":
            sums.append(float(tensors[0].detach()))
        return cast_inputs_for(op, tensors)

    amp.cast_inputs_for = spy
    try:
        s_warm, _ = timed_steps(serial, ids, 1)
        s_grads = {n: p.grad.clone() for n, p in flat.named_parameters()}
        s_warm += timed_steps(serial, ids, PP_WARM - 1)[0]
        _, s_wall = timed_steps(serial, ids, PP_STEPS)
    finally:
        amp.cast_inputs_for = cast_inputs_for
    s_mean = [x / tokens for x in sums]
    s_prof = profiled(serial)
    del serial, flat
    gc.collect()
    torch.cuda.empty_cache()

    faults = {}
    for name, (loss, g) in planted_faults(pipe, ids, _pp_o2_loss,
                                          grads=True).items():
        worst, where, median = _grad_diff(s_grads, pipelined_to_gpt_state(
            g, cfg))
        faults[name] = (abs(loss - s_mean[0]) / abs(s_mean[0]), worst,
                        median)
        del g
    step = HybridTrainStep(pipe, _pp_o2_loss,
                           AdamW(1e-4, parameters=pipe.parameters()))
    warm, _ = timed_steps(step, ids, 1)
    worst, where, median = _grad_diff(s_grads, flat_grads(pipe))
    del s_grads
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    warm += timed_steps(step, ids, PP_WARM - 1)[0]
    fa.reset_launches()
    losses, wall = timed_steps(step, ids, PP_STEPS)
    launches, tc = dict(fa.launches), dict(fa.tc_launches)
    peak = torch.cuda.max_memory_allocated()
    p_prof = profiled(step)
    more = sorted(set(p_prof) | set(s_prof), key=lambda k: s_prof.get(k, 0)
                  - p_prof.get(k, 0))[:4]
    L, n, M = cfg.num_layers, PP_STEPS, PP_MICRO
    rel = abs(warm[0] - s_mean[0]) / abs(s_mean[0])
    losses = warm + losses
    traj = _rel(losses, s_mean)
    dt, s_dt = wall / n, s_wall / n
    flops = model_flops(cfg, PP_BATCH, PP_SEQ)
    print(f"8f (a) PipelinedGPTForCausalLM gpt_1p3b, degenerate mesh, "
          f"n_micro {M}, per-layer remat, O2, HybridTrainStep, "
          f"b{PP_BATCH}·s{PP_SEQ} ({card}): {dt * 1e3:.3f} ms/step, "
          f"{PP_BATCH * PP_SEQ / dt:.1f} tok/s, MFU "
          f"{flops / dt / H100_PEAK_BF16:.4f} (989 TFLOP/s), peak "
          f"{peak / 2**30:.2f} GiB; the serial GPTForCausalLM step at the "
          f"same weights, batch and remat {s_dt * 1e3:.3f} ms/step "
          f"({dt / s_dt:.4f}x); one profiled step each: device "
          f"{sum(p_prof.values()) / 1e3:.3f} ms vs the serial "
          f"{sum(s_prof.values()) / 1e3:.3f} ms, the kernels that grew "
          f"most (ms, pipelined vs serial): "
          + ", ".join(f"{k[:60]} {p_prof.get(k, 0) / 1e3:.3f} vs "
                      f"{s_prof.get(k, 0) / 1e3:.3f}" for k in more)
          + f"; step 0's f32 loss {warm[0]:.6f} vs the "
          f"serial f32 {s_mean[0]:.6f} (bf16 {s_warm[0]}; relative "
          f"{rel:.3e}, tol {PP_LOSS_RTOL:.0e}); step 0's gradients: worst "
          f"{worst:.3e} of their max-abs ({where}; tol "
          f"{PP_GRAD_TOL:.0e}), median {median:.3e} (tol "
          f"{PP_GRAD_MEDIAN_TOL:.0e}); planted faults at the same weights: "
          + "; ".join(f"{k}: loss {v[0]:.3e}, gradients worst {v[1]:.3e}, "
                      f"median {v[2]:.3e}" for k, v in faults.items())
          + f"; the {len(losses)} steps' losses {losses[0]:.4f} → "
          f"{losses[-1]:.4f}, off the serial f32 trajectory by {traj:.3e} "
          f"at most; launches {launches} in {n} steps = ({L} layers x {M} "
          f"micro-batches, x 2 for K3), all tensor-core; models built in "
          f"{build_s:.1f} s")
    want = {"flash_forward": 2 * L * M * n, "flash_bwd_dq": L * M * n,
            "flash_bwd_dkv": L * M * n}
    if launches != want or tc != want:
        raise AssertionError(f"8f (a): flash launches {launches}, tensor-"
                             f"core {tc} in {n} steps; expected {want}")
    if rel > PP_LOSS_RTOL:
        raise AssertionError(f"8f (a): step 0's loss {warm[0]} vs the "
                             f"serial GPT's f32 {s_mean[0]} (relative "
                             f"{rel:.3e} > {PP_LOSS_RTOL})")
    if not (worst <= PP_GRAD_TOL and median <= PP_GRAD_MEDIAN_TOL):
        raise AssertionError(f"8f (a): step 0's gradients vs the serial "
                             f"GPT's: worst {worst:.3e} ({where}), median "
                             f"{median:.3e}")
    for k, (lr, gw, gm) in faults.items():
        if lr <= PP_LOSS_RTOL or (gw <= PP_GRAD_TOL
                                  and gm <= PP_GRAD_MEDIAN_TOL):
            raise AssertionError(f"8f (a): a planted fault ({k}) passes a "
                                 f"gate: loss {lr:.3e}, gradients worst "
                                 f"{gw:.3e}, median {gm:.3e}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"8f (a): losses not finite and falling: "
                             f"{losses}")
    del step, pipe
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def launch_mesh(out_dir, timeout=MESH_TIMEOUT_S, meanwhile=None):
    """`profile_dist.py --mesh pp=2,mp=2` under the launcher, four
    processes sharing the card, with `meanwhile()` run here while they
    start; returns (the ranks' json, seconds)."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [*launcher_cmd(MESH_RANKS, f"{out_dir}/log"),
           os.path.join("paddle_tpu_torch", "profile_dist.py"),
           "--model", "gpt_small", "--device", "cuda", "--mesh",
           "pp=2,mp=2", "--layers", str(MESH_LAYERS), "--steps",
           str(MESH_STEPS), "--batch", str(MESH_BATCH),
           "--seq", str(MESH_SEQ), "--ckpt", os.path.join(out_dir, "ck"),
           "--out", out_dir]
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("PT_CHAOS_PLAN", None)
    t0 = time.perf_counter()
    t_wall = time.time()
    p = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True,
                         start_new_session=True)
    try:
        if meanwhile is not None:
            meanwhile()
        out, _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, 15)
        try:
            out, _ = p.communicate(timeout=20)
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, 9)
            out, _ = p.communicate()
        raise AssertionError(f"8f (b): the launch ran past {timeout} s:\n"
                             f"{out[-4000:]}")
    except BaseException:
        os.killpg(p.pid, 9)
        p.communicate()
        raise
    seconds = time.perf_counter() - t0
    if p.returncode != 0:
        tails = ""
        for r in range(MESH_RANKS):
            f = os.path.join(out_dir, "log", f"default.rank{r}.log")
            if os.path.exists(f):
                tails += f"\n--- rank {r} ---\n" + open(f).read()[-3000:]
        raise AssertionError(f"8f (b): the launcher exited {p.returncode}:"
                             f"\n{out[-4000:]}{tails}")
    outs = []
    for r in range(MESH_RANKS):
        with open(os.path.join(out_dir, f"dist_out_{r}.json")) as f:
            outs.append(json.load(f))
    print_startup("8f (b)", outs, t_wall)
    return outs, seconds


def _per_step(o, kind, key):
    """(bytes, seconds) of one comm kind a steady step, summed over its
    sub-kinds' send / receive (the last step's)."""
    d = o["comm"][-1][kind]
    if key is not None:
        d = {k: v for k, v in d.items() if k.startswith(key)}
        return (sum(v["bytes"] for v in d.values()),
                sum(v["seconds"] for v in d.values()))
    return d.get("bytes", 0), d.get("seconds", 0.0)


def _step0(o):
    """A rank's first step: its seconds, its p2p receives' wait and its
    mp all-reduces' seconds, and the model build before it."""
    c = o["comm"][0]
    recv = c["p2p"].get("p2p_recv", {}).get("seconds", 0.0)
    mp = c["mp"].get("allreduce", {}).get("seconds", 0.0)
    return (f"; step 0 {o['step_seconds'][0]:.2f} s (p2p receives "
            f"{recv:.2f} s, mp all-reduces {mp:.2f} s; the model built in "
            f"{o['build_s']:.1f} s before it)")


def pp_mp_phase(fa, card):
    """8f (b): pp 2 x mp 2 as four processes sharing the card
    (`profile_dist.py --mesh`), gpt_small b8·s1024, n_micro 4, per-layer
    remat, bf16 O1, MESH_STEPS steps, gloo for every collective and the
    socket
    transport for p2p: each rank's losses against a world-1
    PipelinedGPTForCausalLM on the card (same weights and batch), its
    K3-K5 launches, its executed schedule against the tick table, and
    one checkpoint of every rank's shards loaded at world 1. Returns the
    ranks' flash launches."""
    from paddle_tpu_torch.convert import gather_pipelined_state
    from paddle_tpu_torch.distributed import mesh as tmesh
    from paddle_tpu_torch.distributed.checkpoint import Checkpointer
    from paddle_tpu_torch.distributed.fleet.meta_parallel.pipeline_1f1b \
        import schedule_table
    from paddle_tpu_torch.profile_dist import (N_MICRO, build_pipelined,
                                               global_batch)

    tmesh.reset_mesh()
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    world = {}

    def world1():
        # the world-1 reference, run while the four processes start
        cfg, ref = build_pipelined("gpt_small", dev, layers=MESH_LAYERS)
        ids = global_batch(cfg, MESH_BATCH, MESH_SEQ).to(dev)
        faults = {k: v[0] for k, v in
                  planted_faults(ref.model, ids, ref.loss_fn).items()}
        losses = [float(ref(ids)) for _ in range(MESH_STEPS)]
        world.update(cfg=cfg, ref_losses=losses, faults={
            k: abs(v - losses[0]) / abs(losses[0])
            for k, v in faults.items()})
        del ref
        gc.collect()
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="mesh_") as d:
        outs, seconds = launch_mesh(d, meanwhile=world1)
        cfg, ref_losses, faults = (world[k] for k in (
            "cfg", "ref_losses", "faults"))
        L = cfg.num_layers // 2
        table = schedule_table(N_MICRO, 2)
        shards = {}
        for r, o in enumerate(outs):
            k = MESH_STEPS * L * N_MICRO
            want = {"flash_forward": 2 * k, "flash_bwd_dq": k,
                    "flash_bwd_dkv": k}
            if o["launches"] != want or o["tc_launches"] != want:
                raise AssertionError(f"8f (b): rank {r} launched "
                                     f"{o['launches']} (tensor-core "
                                     f"{o['tc_launches']}); expected {want}")
            stage = o["coord"]["pp"]
            rows = []
            for t, f, b in table[stage]:
                if f is not None:
                    rows.append([str(t), "F", str(f[0]), str(f[1])])
                if b is not None:
                    rows.append([str(t), "B", str(b[0]), str(b[1])])
            if o["schedule"] != rows:
                raise AssertionError(f"8f (b): rank {r} ran {o['schedule']}"
                                     f"; the table's row is {rows}")
            shards[(stage, o["coord"]["mp"])] = dict(np.load(
                os.path.join(d, f"params_{r}.npz")))
        gathered = gather_pipelined_state(shards, cfg, 2, 2)
        t0 = time.perf_counter()
        _, w1 = build_pipelined("gpt_small", dev, layers=MESH_LAYERS)
        got = Checkpointer(os.path.join(d, "ck"), model=w1.model,
                           train_step=w1).load_latest()
        load_s = time.perf_counter() - t0
        bad = [n for n, p in w1.model.named_parameters()
               if not np.array_equal(p.detach().float().cpu().numpy(),
                                     gathered[n])]
        if got != MESH_STEPS or bad:
            raise AssertionError(f"8f (b): world 1 loaded step {got}; "
                                 f"parameters unequal to the gathered "
                                 f"shards: {bad[:8]}")
        del w1
    print(f"8f (b) pp 2 x mp 2 on one card (four processes, gpt_small "
          f"widths x {MESH_LAYERS} layers, b{MESH_BATCH}·s{MESH_SEQ}, "
          f"n_micro {N_MICRO}, per-layer "
          f"remat, bf16 O1, HybridTrainStep; gloo through the host for the "
          f"mp all-reduces, the socket transport for p2p; {card}): launcher "
          f"to exit {seconds:.1f} s; world 1 on the card {ref_losses}; "
          f"planted faults at world 1 off its step 0 by "
          + ", ".join(f"{v:.3e} ({k})" for k, v in faults.items())
          + f" (tol {MESH_LOSS_RTOL:.0e}); "
          + "; ".join(
              f"rank {o['rank']} (pp {o['coord']['pp']}, mp "
              f"{o['coord']['mp']}): s/step "
              f"{[round(x, 4) for x in o['step_seconds']]}, p2p "
              f"{_per_step(o, 'p2p', 'p2p_send')[0]} bytes sent, "
              f"{_per_step(o, 'p2p', 'p2p')[1]:.3f} s in send + receive, mp "
              f"all-reduce {_per_step(o, 'mp', 'allreduce')[0]} bytes in "
              f"{_per_step(o, 'mp', 'allreduce')[1]:.3f} s, tied wte "
              f"all-reduce {_per_step(o, 'tied_wte', None)[0]} bytes in "
              f"{_per_step(o, 'tied_wte', None)[1]:.3f} s a step, peak "
              + (f"{o['peak_mb']:.0f} MB" if o["peak_mb"] is not None
                 else "not measured")
              + _step0(o)
              + f", losses {o['losses']} (relative to world 1 "
              f"{_rel(o['losses'], ref_losses):.2e}), launches "
              f"{o['launches']}, schedule = the table's row of stage "
              f"{o['coord']['pp']}"
              for o in outs)
          + f"; the checkpoint (each rank's shards) loaded at world 1, step "
          f"{got}, every parameter equal to the gathered shards, in "
          f"{load_s:.2f} s")
    for o in outs:
        rel = _rel(o["losses"], ref_losses)
        if rel > MESH_LOSS_RTOL:
            raise AssertionError(f"8f (b): rank {o['rank']}'s losses "
                                 f"{o['losses']} vs world 1's {ref_losses} "
                                 f"(relative {rel:.3e} > {MESH_LOSS_RTOL})")
    bad = {k: v for k, v in faults.items() if v <= MESH_LOSS_RTOL}
    if bad:
        raise AssertionError(f"8f (b): planted faults at world 1 pass the "
                             f"loss gate ({MESH_LOSS_RTOL}): {bad}")
    return {f"rank{o['rank']}": o["launches"] for o in outs}


def pipe_phase(fa, card):
    """8f: (a) and (b); returns their flash launches."""
    t0 = time.perf_counter()
    w1 = pp_world1(fa, card)
    ranks = pp_mp_phase(fa, card)
    print(f"8f phase: {time.perf_counter() - t0:.1f} s")
    return {"world1_1p3b": w1, **{f"pp2mp2_{k}": v
                                  for k, v in ranks.items()}}


# ---- mixture-of-experts training and the int8 gradient exchange (8g) ----

# 8g (a): bench.py:427's bench_gpt1p3b_pp arm with BENCH_MOE_EXPERTS 8 at
# gpt_1p3b's widths, its depth cut from 24 layers to 4
MOE_E, MOE_TOPK, MOE_CF, MOE_LAYERS = 8, 1, 1.25, 4
MOE_BATCH, MOE_SEQ, MOE_MICRO = 2, 2048, 2
MOE_WARM, MOE_STEPS = 2, 5
# gate 1: one full-width MoE FFN, f32 with TF32 off, card vs CPU
MOE_FFN_TOKENS = 2048
MOE_FFN_OUT_TOL, MOE_FFN_AUX_TOL = 1e-4, 1e-6
# gate 2: step 0 through K3-K5 vs their plain versions, bf16 O2. The
# kernels' rounding moves a token's bf16 gate logits by an ulp, which
# flips a near-tie routing (1.2 % of the routings on an H100), and a
# flipped token's expert gradients move with it; so the plain run and
# the planted faults replay the kernel run's routing (`_moe_routes`'
# `replay`), and the gate holds the rest of the step. The limits are
# 8f (a)'s, between the sound gap and the two planted faults (the
# capacity drop skipped; the gate probability left out of the combine).
# On an H100: loss 2.5e-6 sound, 1.1e-3 and 6.3e-4 planted; gradients
# worst 1.2e-2 / median 8.0e-3 sound, at least 0.82 / 0.42 planted
MOE_LOSS_RTOL = 1e-4
MOE_GRAD_TOL, MOE_GRAD_MEDIAN_TOL = 1e-1, 5e-2
# 8g (b): two processes, ep 2, gpt_small widths, 2 layers, capacity 4.0
# (nothing drops, so the grouped routing keeps the serial token set)
MOE_EP_RANKS, MOE_EP_E, MOE_EP_LAYERS, MOE_EP_CF = 2, 4, 2, 4.0
MOE_EP_BATCH, MOE_EP_SEQ, MOE_EP_MICRO, MOE_EP_STEPS = 2, 1024, 2, 3
# each rank's step 0 loss (the same weights as world 1's) within
# MOE_EP_LOSS_RTOL; the later steps within MOE_EP_TRAJ_RTOL, 8e (c)'s
# bar: under bf16 O1 the experts' weight gradients sum their bucket rows
# in another order at ep 2 (each rank's group, then the other's), and
# Adam's per-element normalization turns those roundings into steps of
# up to lr (an H100: step 0 4.3e-7, the next steps 1.0e-4; the same gap
# on the CPU in bf16, none in f32). The self-copy fault moves step 0 by
# 1.0e-3 and the trajectory by 8.5e-3.
MOE_EP_LOSS_RTOL, MOE_EP_TRAJ_RTOL = 3e-5, 1e-3
MOE_EP_TIMEOUT_S = 300
# 8g (c), in 8e (c)'s launch: the reference's bar
# (tests/test_quant_collective.py:168) and a quarter of the f32 bytes;
# the int8 mean of a whole gradient within one int8 step of the exact
# mean in every block (the two rounding passes' bound over one axis,
# half a step each; 1e-3 of a step more for the f32 arithmetic). On an
# H100, gpt_small's wte gradient: 0.994 steps sound, 118 with the
# exchange skipped
QUANT_STEPS, QUANT_LOSS_RTOL, QUANT_BYTES_RATIO = 3, 0.05, 0.26
QUANT_GAP_STEPS = 1.001


def _moe_model(seed=0):
    """The 8g (a) model: PipelinedGPTForCausalLM at gpt_1p3b's widths, 4
    layers, 8 experts of hidden 8192, top-1 at capacity 1.25, n_micro 2,
    per-layer remat, decorated O2."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.text.models.gpt import gpt_1p3b
    from paddle_tpu_torch.text.models.gpt_pipeline import (
        PipelinedGPTForCausalLM)

    cfg = gpt_1p3b()
    cfg.num_layers = MOE_LAYERS
    model = PipelinedGPTForCausalLM(
        cfg, n_micro=MOE_MICRO, remat="layer", moe_experts=MOE_E,
        moe_hidden=cfg.ffn_size, moe_topk=MOE_TOPK,
        moe_capacity_factor=MOE_CF, device="cuda", seed=seed)
    amp.decorate(model, level="O2", dtype="bfloat16")
    return cfg, model


@contextlib.contextmanager
def _moe_routes(routes, fault=None, replay=None):
    """Record each routing call's (experts it would pick, kept) into
    `routes`; with `replay` (an earlier run's `routes`, in call order),
    route each call to the experts recorded there instead, the gate
    probabilities taken from this call's own; with `fault`, plant it:
    "capacity drop skipped" (every token fits) or "gate probability left
    out" (the combine weighs each expert's output by 1)."""
    from paddle_tpu_torch.distributed import moe as tmoe

    route, capacity = tmoe._route, tmoe.moe_a2a_capacity
    replay = None if replay is None else iter(replay)

    def spy(probs, num_experts, cap):
        if replay is None:
            out = route(probs, num_experts, cap)
            mine = out[0]
        else:
            # probs <= 1: the recorded expert takes every argmax
            idx = next(replay)[0].to(probs.device)
            out = route(probs.detach() + 2.0 * torch.nn.functional.one_hot(
                idx, num_experts).to(probs.dtype), num_experts, cap)
            out = (out[0], probs.gather(-1, idx[:, None])[:, 0]) + out[2:]
            mine = probs.argmax(-1)
        routes.append((mine.detach().cpu(), out[4].detach().cpu()))
        if fault == "gate probability left out":
            out = (out[0], torch.ones_like(out[1])) + out[2:]
        return out

    tmoe._route = spy
    if fault == "capacity drop skipped":
        tmoe.moe_a2a_capacity = lambda tokens, ep, e, cf: tokens // ep
    try:
        yield routes
    finally:
        tmoe._route, tmoe.moe_a2a_capacity = route, capacity


def moe_ffn_gate(card, d=2048, dh=8192, T=MOE_FFN_TOKENS):
    """8g (a) gate 1: one full-width MoE FFN (`_moe_ffn`: d 2048, 8
    experts of 8192, T 2048, capacity 1.25) at top-1 and top-2, in f32
    with TF32 off, on the card and on the CPU from the same weights and
    input: the same expert for every token, the same kept set, outputs
    within 1e-4 of their max-abs, aux within 1e-6; each planted fault on
    the card fails it."""
    from paddle_tpu_torch.text.models.gpt_pipeline import _moe_ffn

    E = MOE_E
    gen = torch.Generator().manual_seed(17)

    def rnd(*shape, scale=0.02):
        return torch.randn(*shape, generator=gen) * scale

    p_cpu = {"gate_w": rnd(d, E), "moe_w1": rnd(E, d, dh),
             "moe_b1": rnd(E, 1, dh), "moe_w2": rnd(E, dh, d),
             "moe_b2": rnd(E, 1, d)}
    # the tokens lean towards expert 0 (a component along its gate
    # column), so that it overflows at top-1 and at top-2 and the
    # capacity drop shows
    g0 = p_cpu["gate_w"][:, 0]
    h_cpu = torch.nn.functional.layer_norm(
        rnd(1, T, d, scale=1.0) + 1.5 * g0 / g0.norm(), [d])
    p_gpu = {k: v.cuda() for k, v in p_cpu.items()}
    h_gpu = h_cpu.cuda()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def run(p, h, topk, fault=None):
        routes = []
        with _moe_routes(routes, fault), torch.no_grad():
            out, aux = _moe_ffn(p, h, E, 1, MOE_CF, 1, topk)
        return out.float().cpu(), float(aux), routes

    def compare(ref, got):
        same_expert = all(torch.equal(a[0], b[0])
                          for a, b in zip(ref[2], got[2]))
        same_kept = all(torch.equal(a[1], b[1])
                        for a, b in zip(ref[2], got[2]))
        err = float((got[0] - ref[0]).abs().max() / ref[0].abs().max())
        aux = abs(got[1] - ref[1])
        ok = (len(ref[2]) == len(got[2]) and same_expert and same_kept
              and err <= MOE_FFN_OUT_TOL and aux <= MOE_FFN_AUX_TOL)
        return ok, same_expert, same_kept, err, aux

    lines, fails = [], []
    try:
        for topk in (1, 2):
            cpu = run(p_cpu, h_cpu, topk)
            t0 = time.perf_counter()
            card_run = run(p_gpu, h_gpu, topk)
            torch.cuda.synchronize()
            ok, se, sk, err, aux = compare(cpu, card_run)
            dropped = sum(int((~k).sum()) for _, k in cpu[2])
            lines.append(f"top-{topk}: same experts {se}, same kept set "
                         f"{sk} ({dropped} of {T * topk} routings dropped "
                         f"on both), output {err:.3e} of its max-abs (tol "
                         f"{MOE_FFN_OUT_TOL:.0e}), aux {cpu[1]:.6f} vs "
                         f"{card_run[1]:.6f} (|diff| {aux:.2e}, tol "
                         f"{MOE_FFN_AUX_TOL:.0e}), card "
                         f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
            if not ok:
                fails.append(f"top-{topk}")
            for fault in ("capacity drop skipped",
                          "gate probability left out"):
                f_ok, se, sk, err, aux = compare(
                    cpu, run(p_gpu, h_gpu, topk, fault))
                lines.append(f"  planted '{fault}': same kept set {sk}, "
                             f"output {err:.3e}, aux |diff| {aux:.2e} -> "
                             f"{'PASSES (bad)' if f_ok else 'fails'}")
                if f_ok:
                    fails.append(f"top-{topk} planted {fault}")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    print(f"8g (a) gate 1, one MoE FFN at full width (d {d}, {E} experts "
          f"of {dh}, T {T}, capacity {MOE_CF}), f32 TF32 off, card vs CPU "
          f"({card}): " + "; ".join(lines))
    if fails:
        raise AssertionError(f"8g (a) gate 1 failed: {fails}")
    del p_gpu, h_gpu


def _moe_step0(model, ids, fault=None, replay=None):
    """One forward + backward of `model` at its weights (no update):
    (the f32 loss, {name: gradient}, routes); `replay` routes it as an
    earlier run's routes say (`_moe_routes`)."""
    routes = []
    model.zero_grad(set_to_none=True)
    with _moe_routes(routes, fault, replay):
        loss = _pp_o2_loss(model, ids)
        loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads, routes


def _moe_breakdown(prof):
    """One profiled step's device ms: the expert GEMMs (aten::bmm, forward,
    recompute and backward), dispatch / combine with the routing (the
    index gathers, their backward scatters, argmax, cumsum, one-hot),
    attention (K3-K5), the optimizer update and the rest."""
    from torch.autograd import DeviceType

    from paddle_tpu_torch.profile_train import (OPT_RANGE, device_us,
                                                kernel_rows)

    rows = prof.key_averages()
    total = device_us(prof)

    def ops(names):
        return sum(e.device_time_total for e in rows
                   if e.device_type == DeviceType.CPU and e.key in names)

    experts = ops({"aten::bmm"})
    dispatch = ops({"aten::index_select", "aten::index_add_",
                    "aten::index_put_", "aten::argmax", "aten::cumsum",
                    "aten::one_hot", "aten::gather", "aten::nonzero"})
    attention = sum(e.self_device_time_total for e in kernel_rows(prof)
                    if "fa_fwd" in e.key or "fa_bwd" in e.key)
    update = ops({OPT_RANGE})
    return {"total": total / 1e3, "expert GEMMs": experts / 1e3,
            "dispatch / combine": dispatch / 1e3,
            "attention (K3-K5)": attention / 1e3,
            "optimizer update": update / 1e3,
            "rest": (total - experts - dispatch - attention - update)
            / 1e3}


def moe_world1(fa, card):
    """8g (a): the MoE GPT at gpt_1p3b's widths (4 layers) under bf16 O2,
    AdamW(1e-4), HybridTrainStep on the degenerate mesh, b2·s2048: gate
    1 (`moe_ffn_gate`); gate 2, step 0 through K3-K5 against the same
    weights with their plain versions, routed as the kernels' run routed
    (the f32 loss and every gradient; the share of tokens the plain run
    would route alike printed; the two planted faults, on the same
    routing, must fail it); gate 3, the flash launches of the timed
    steps; gate 4, the 7 steps' losses (aux term included) finite and
    falling. Returns the flash launches of the timed steps."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.distributed import mesh as tmesh
    from paddle_tpu_torch.distributed import moe as tmoe
    from paddle_tpu_torch.jit import HybridTrainStep
    from paddle_tpu_torch.observability.steptrace import model_flops
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.profile_train import (H100_PEAK_BF16, _ids,
                                                timed_steps)

    tmesh.reset_mesh()
    gc.collect()
    torch.cuda.empty_cache()
    moe_ffn_gate(card)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg, model = _moe_model()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    ids = _ids(cfg, MOE_BATCH, MOE_SEQ, "cuda")
    # gate 2
    loss_k, grads_k, routes_k = _moe_step0(model, ids)
    names = ("flash_forward", "flash_bwd_dq", "flash_bwd_dkv")
    kernels = {n: getattr(fa, n) for n in names}
    fa.reset_launches()
    try:
        for n in names:
            setattr(fa, n, getattr(fa, n + "_plain"))
        loss_p, grads_p, routes_p = _moe_step0(model, ids,
                                               replay=routes_k)
    finally:
        for n in names:
            setattr(fa, n, kernels[n])
    plain_launches = dict(fa.launches)
    alike = float(np.mean([float((a[0] == b[0]).float().mean())
                           for a, b in zip(routes_k, routes_p)]))
    rel = abs(loss_k - loss_p) / abs(loss_p)
    worst, where, median = _grad_diff(grads_p, grads_k)
    del grads_k
    faults = {}
    for fault in ("capacity drop skipped", "gate probability left out"):
        lf, gf, _ = _moe_step0(model, ids, fault, replay=routes_k)
        fw, _, fm = _grad_diff(grads_p, gf)
        faults[fault] = (abs(lf - loss_p) / abs(loss_p), fw, fm)
        del gf
    del grads_p
    gc.collect()
    torch.cuda.empty_cache()
    # the training run
    step = HybridTrainStep(model, _pp_o2_loss,
                           AdamW(1e-4, parameters=model.parameters()))
    torch.cuda.reset_peak_memory_stats()
    warm, _ = timed_steps(step, ids, MOE_WARM)
    auxs = [float(model.aux_loss)]
    fa.reset_launches()
    losses, wall = timed_steps(step, ids, MOE_STEPS)
    launches, tc = dict(fa.launches), dict(fa.tc_launches)
    auxs.append(float(model.aux_loss))
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        timed_steps(step, ids, 1)
    split = _moe_breakdown(prof)
    tmoe.route_stats = {}
    try:
        with torch.no_grad():
            _pp_o2_loss(model, ids)
        routing = tmoe.route_stats
    finally:
        tmoe.route_stats = None
    n, L, M = MOE_STEPS, MOE_LAYERS, MOE_MICRO
    dt = wall / n
    losses = warm + losses
    flops = model_flops(cfg, MOE_BATCH, MOE_SEQ)   # ffn = one expert's
    print(f"8g (a) PipelinedGPTForCausalLM MoE, gpt_1p3b widths (d 2048, "
          f"32 heads of 64), {L} layers of 24, {MOE_E} experts of hidden "
          f"{cfg.ffn_size}, top-{MOE_TOPK}, capacity {MOE_CF}, n_micro "
          f"{M}, per-layer remat, O2, AdamW(1e-4), HybridTrainStep, "
          f"b{MOE_BATCH}·s{MOE_SEQ} ({card}; {n_params / 1e9:.3f} B "
          f"parameters, built (host) in {build_s:.1f} s): "
          f"{dt * 1e3:.3f} ms/step, "
          f"{MOE_BATCH * MOE_SEQ / dt:.1f} tok/s, MFU "
          f"{flops / dt / H100_PEAK_BF16:.4f} at 989 TFLOP/s over the "
          f"active top-1 FLOPs ({flops / 1e12:.3f} TFLOP a step: one "
          f"expert a token; the dispatch and combine are index gathers "
          f"and not counted, nor the capacity's empty slots), peak "
          f"{peak / 2**30:.2f} GiB; one profiled step's device ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
          + f"; tokens per expert (no-grad pass at the final weights, "
          f"summed over layers and micro-batches) {routing['tokens']}, "
          f"dropped {routing['dropped']} of {routing['routed']} "
          f"({routing['dropped'] / routing['routed']:.4f}); gate 2, step 0 "
          f"kernels vs plain: f32 loss {loss_k:.6f} vs {loss_p:.6f} "
          f"(relative {rel:.3e}, tol {MOE_LOSS_RTOL:.0e}), gradients worst "
          f"{worst:.3e} of their max-abs ({where}; tol {MOE_GRAD_TOL:.0e}),"
          f" median {median:.3e} (tol {MOE_GRAD_MEDIAN_TOL:.0e}), on the "
          f"kernels' routing (the plain run's own would route "
          f"{alike:.5f} of the tokens alike); planted faults: "
          + "; ".join(f"{k}: loss {v[0]:.3e}, gradients worst {v[1]:.3e}, "
                      f"median {v[2]:.3e}" for k, v in faults.items())
          + f"; the {len(losses)} steps' losses (aux term included) "
          f"{[round(x, 4) for x in losses]}, aux {auxs[0]:.4f} -> "
          f"{auxs[1]:.4f}; launches {launches} in {n} steps ({L} layers x "
          f"{M} micro-batches, x 2 for K3), tensor-core {tc}; the plain "
          f"run launched {plain_launches}")
    want = {"flash_forward": 2 * L * M * n, "flash_bwd_dq": L * M * n,
            "flash_bwd_dkv": L * M * n}
    if launches != want or tc != want or set(
            plain_launches.values()) - {0}:
        raise AssertionError(f"8g (a): flash launches {launches}, tensor-"
                             f"core {tc} in {n} steps, the plain run's "
                             f"{plain_launches}; expected {want}")
    if not (rel <= MOE_LOSS_RTOL and worst <= MOE_GRAD_TOL
            and median <= MOE_GRAD_MEDIAN_TOL):
        raise AssertionError(f"8g (a): step 0 kernels vs plain: loss "
                             f"{rel:.3e}, gradients worst {worst:.3e} "
                             f"({where}), median {median:.3e}")
    for k, (lr, gw, gm) in faults.items():
        if lr <= MOE_LOSS_RTOL and gw <= MOE_GRAD_TOL \
                and gm <= MOE_GRAD_MEDIAN_TOL:
            raise AssertionError(f"8g (a): a planted fault ({k}) passes "
                                 f"gate 2: loss {lr:.3e}, gradients worst "
                                 f"{gw:.3e}, median {gm:.3e}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"8g (a): losses not finite and falling: "
                             f"{losses}")
    del step, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def launch_ep(out_dir, device="cuda", model="gpt_small", seq=MOE_EP_SEQ,
              timeout=MOE_EP_TIMEOUT_S, meanwhile=None):
    """`profile_dist.py --mesh ep=2 --moe 4` under the launcher, two
    processes sharing the card, with the self-copy fault planted after
    the steps and `meanwhile()` run here while they start; returns (the
    ranks' json, seconds)."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [*launcher_cmd(MOE_EP_RANKS, f"{out_dir}/log"),
           os.path.join("paddle_tpu_torch", "profile_dist.py"),
           "--model", model, "--device", device, "--mesh",
           f"ep={MOE_EP_RANKS}", "--moe", str(MOE_EP_E), "--moe-cf",
           str(MOE_EP_CF), "--layers", str(MOE_EP_LAYERS), "--n-micro",
           str(MOE_EP_MICRO), "--steps", str(MOE_EP_STEPS), "--batch",
           str(MOE_EP_BATCH), "--seq", str(seq), "--plant",
           "a2a_self_copy", "--out", out_dir]
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("PT_CHAOS_PLAN", None)
    t0 = time.perf_counter()
    t_wall = time.time()
    p = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True,
                         start_new_session=True)
    try:
        if meanwhile is not None:
            meanwhile()
        out, _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, 15)
        try:
            out, _ = p.communicate(timeout=20)
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, 9)
            out, _ = p.communicate()
        raise AssertionError(f"8g (b): the launch ran past {timeout} s:\n"
                             f"{out[-4000:]}")
    except BaseException:
        os.killpg(p.pid, 9)
        p.communicate()
        raise
    seconds = time.perf_counter() - t0
    if p.returncode != 0:
        log1 = os.path.join(out_dir, "log", "default.rank1.log")
        tail = open(log1).read()[-4000:] if os.path.exists(log1) else ""
        raise AssertionError(f"8g (b): the launcher exited {p.returncode}:"
                             f"\n{out[-4000:]}\n--- rank 1 ---\n{tail}")
    outs = []
    for r in range(MOE_EP_RANKS):
        with open(os.path.join(out_dir, f"dist_out_{r}.json")) as f:
            outs.append(json.load(f))
    print_startup("8g (b)", outs, t_wall)
    return outs, seconds


def moe_ep_phase(card, device="cuda", model="gpt_small", seq=MOE_EP_SEQ,
                 counted=True):
    """8g (b): ep 2 as two processes sharing the card: each rank's step 0
    loss (at the same weights) within 3e-5 relative of a world-1 run on
    the card, its later steps within 1e-3; the self-copy fault fails
    both; each rank holds 2 of the 4 experts; K3-K5 per rank. Returns
    the ranks' flash launches."""
    from paddle_tpu_torch.distributed import mesh as tmesh
    from paddle_tpu_torch.profile_dist import build_pipelined, global_batch

    tmesh.reset_mesh()
    gc.collect()
    torch.cuda.empty_cache()
    world = {}

    def world1():
        # the world-1 reference, run while the two processes start
        cfg, ref = build_pipelined(
            model, torch.device(device), moe=MOE_EP_E, moe_cf=MOE_EP_CF,
            layers=MOE_EP_LAYERS, n_micro=MOE_EP_MICRO)
        ids = global_batch(cfg, MOE_EP_BATCH, seq).to(device)
        world.update(cfg=cfg, ref_losses=[float(ref(ids))
                                       for _ in range(MOE_EP_STEPS)])
        del ref
        gc.collect()
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="ep_") as d:
        outs, seconds = launch_ep(d, device, model, seq, meanwhile=world1)
    cfg, ref_losses = world["cfg"], world["ref_losses"]
    L, M, n = MOE_EP_LAYERS, MOE_EP_MICRO, MOE_EP_STEPS
    want = {"flash_forward": 2 * L * M * n, "flash_bwd_dq": L * M * n,
            "flash_bwd_dkv": L * M * n}
    rels = [(_rel(o["losses"][:1], ref_losses), _rel(o["losses"],
                                                     ref_losses))
            for o in outs]
    planted = [(_rel(o["planted_losses"][:1], ref_losses),
                _rel(o["planted_losses"], ref_losses)) for o in outs]

    def a2a(o):
        d = o["comm"][-1]["mp"].get("alltoall", {})
        return d.get("calls", 0), d.get("bytes", 0), d.get("seconds", 0.0)

    print(f"8g (b) ep {MOE_EP_RANKS} on one card (two processes, {model} "
          f"widths, {L} layers, {MOE_EP_E} experts of hidden "
          f"{cfg.ffn_size}, top-1, capacity {MOE_EP_CF}, "
          f"b{MOE_EP_BATCH}·s{seq}, n_micro "
          f"{M}, bf16 O1, HybridTrainStep; the token all-to-all over gloo "
          f"through the host; {card}): launcher to exit {seconds:.1f} s; "
          f"world 1 on the card {ref_losses}; "
          + "; ".join(
              f"rank {o['rank']} (ep {o['coord']['ep']}, holds "
              f"{o['experts_held']} experts): s/step "
              f"{[round(x, 4) for x in o['step_seconds']]}, all-to-all "
              f"{a2a(o)[0]} calls, {a2a(o)[1]} bytes, {a2a(o)[2]:.3f} s a "
              f"step, losses {o['losses']} (relative to world 1: step 0 "
              f"{rel[0]:.2e}, tol {MOE_EP_LOSS_RTOL:.0e}; all steps "
              f"{rel[1]:.2e}, tol {MOE_EP_TRAJ_RTOL:.0e}), aux "
              f"{[round(x, 5) for x in o['aux']]}, tokens per expert "
              f"{o['routing']['tokens']} (dropped {o['routing']['dropped']}"
              f" of {o['routing']['routed']}), planted self-copy "
              f"all-to-all {o['planted_losses']} (relative: step 0 "
              f"{pl[0]:.2e}, all steps {pl[1]:.2e}), "
              f"launches {o['launches']}, peak "
              + (f"{o['peak_mb']:.0f} MB" if o["peak_mb"] is not None
                 else "not measured")
              for o, rel, pl in zip(outs, rels, planted)))
    for o, rel, pl in zip(outs, rels, planted):
        if rel[0] > MOE_EP_LOSS_RTOL or rel[1] > MOE_EP_TRAJ_RTOL:
            raise AssertionError(f"8g (b): rank {o['rank']}'s losses "
                                 f"{o['losses']} vs world 1's {ref_losses}"
                                 f" (relative {rel[0]:.3e}, {rel[1]:.3e})")
        if pl[0] <= MOE_EP_LOSS_RTOL or pl[1] <= MOE_EP_TRAJ_RTOL:
            raise AssertionError(f"8g (b): the planted self-copy passes a "
                                 f"gate on rank {o['rank']}: "
                                 f"{o['planted_losses']} ({pl[0]:.3e}, "
                                 f"{pl[1]:.3e})")
        if o["experts_held"] != MOE_EP_E // MOE_EP_RANKS:
            raise AssertionError(f"8g (b): rank {o['rank']} holds "
                                 f"{o['experts_held']} experts")
        if counted and (o["launches"] != want or o["tc_launches"] != want):
            raise AssertionError(f"8g (b): rank {o['rank']} launched "
                                 f"{o['launches']} (tensor-core "
                                 f"{o['tc_launches']}); expected {want}")
    return {f"rank{o['rank']}": o["launches"] for o in outs}


def quant_gate(outs, card):
    """8g (c), from 8e (c)'s launch: 3 steps of DistributedTrainStep(
    quant_allreduce=True) from the same start as the exact steps: losses
    within 5 % of the exact run's, the exchange's bytes at most 0.26 of
    the exact f32 exchange's, the int8 mean of a whole gradient within
    one int8 step of the exact mean in every block (the exchange skipped,
    planted, must fail that), and a NaN planted in rank 0's gradient
    decoding to NaN in the same block on both ranks."""
    blocks = [tuple(o["poison_blocks"]) for o in outs]
    lines = []
    for o in outs:
        q, exact = o["quant"], o["losses"][:QUANT_STEPS]
        rel = max(abs(a - b) / abs(b) for a, b in zip(q["losses"], exact))
        ratio = q["comm"][-1]["bytes"] / o["comm"][-1]["bytes"]
        lines.append(
            f"rank {o['rank']}: int8 losses {q['losses']} vs exact {exact}"
            f" (relative {rel:.3e}, tol {QUANT_LOSS_RTOL}); the exchange "
            f"{q['comm'][-1]['bytes']} bytes in "
            f"{q['comm'][-1]['seconds']:.3f} s a step vs the exact "
            f"{o['comm'][-1]['bytes']} bytes in "
            f"{o['comm'][-1]['seconds']:.3f} s ({ratio:.4f}x, tol "
            f"{QUANT_BYTES_RATIO}); s/step "
            f"{[round(x, 4) for x in q['step_seconds']]} vs "
            f"{[round(x, 4) for x in o['step_seconds']]}; a gradient of "
            f"{o['exchange_numel']} elements: int8 mean vs the exact one "
            f"{o['exchange_gap']:.4f} int8 steps at most (tol "
            f"{QUANT_GAP_STEPS}), with the exchange skipped (planted) "
            f"{o['exchange_gap_planted']:.4f}; the planted NaN decoded as "
            f"NaN in blocks {o['poison_blocks']} ({o['poison_nan']} "
            f"elements)")
        if rel > QUANT_LOSS_RTOL or ratio > QUANT_BYTES_RATIO or not (
                o["exchange_gap"] <= QUANT_GAP_STEPS
                < o["exchange_gap_planted"]):
            raise AssertionError(f"8g (c): {lines[-1]}")
    from paddle_tpu_torch.profile_dist import POISON_AT

    print(f"8g (c) the int8 gradient exchange in 8e (c)'s launch (ZeRO "
          f"os_g over sharding 2, axes {outs[0]['quant']['axes']}; {card}):"
          f" " + "; ".join(lines))
    if len(set(blocks)) != 1 or blocks[0] != (POISON_AT // 512,):
        raise AssertionError(f"8g (c): the NaN planted at {POISON_AT} on "
                             f"rank 0 decoded in blocks {blocks}")


def moe_phase(fa, card, dist_outs):
    """8g: (a), (b), (c); returns the flash launches of (a) and of each
    rank of (b)."""
    t0 = time.perf_counter()
    w1 = moe_world1(fa, card)
    ranks = moe_ep_phase(card)
    quant_gate(dist_outs, card)
    print(f"8g phase: {time.perf_counter() - t0:.1f} s")
    return {"world1_moe_1p3b_widths": w1,
            **{f"ep2_{k}": v for k, v in ranks.items()}}


# ---- sequence parallelism and the auto-parallel Engine (8h) ----

# (a) the lse route at gpt_1p3b's attention shape, bf16 against the plain
# f32 autograd: out and the gradients over their reference's max-abs, lse
# absolute. Bounds set from bf16's 8-bit mantissa (p, ds rounded before
# their products: the flash phase's 2e-2 / 5e-2).
LSE_BH, LSE_S, LSE_D = 32, 2048, 64
LSE_OUT_TOL, LSE_LSE_TOL, LSE_GRAD_TOL = 2e-2, 1e-3, 5e-2
# the 2-process launch: the ring check, then the full-auto Engine
RING_SEQ, RING_OUT_TOL, RING_GRAD_TOL = 4096, 2e-2, 5e-2
AUTO_LAYERS, AUTO_BATCH, AUTO_SEQ, AUTO_STEPS = 2, 4, 512, 3
AUTO_LOSS_RTOL = 5e-5
CHECKS_TIMEOUT_S = 300
# (b) pp 2 x sp 2: gpt_small widths, depth cut to 4 layers
SP_RANKS, SP_LAYERS, SP_BATCH, SP_SEQ, SP_MICRO, SP_STEPS = 4, 4, 4, 2048, \
    2, 3
SP_LOSS_RTOL, SP_LATER_RTOL = 3e-5, 1e-3
SP_TIMEOUT_S = 420
SP_PLANTS = ("ring_skip", "label_unshifted", "sp_grad_sum")


def _plain_lse_attention(q, k, v, causal):
    """The plain f32 version of `flash_attention_lse_bhd`: (out, lse
    [bh, 1, s]) by dense softmax, differentiable in both."""
    qf, kf, vf = q.float(), k.float(), v.float()
    sc = torch.matmul(qf, kf.transpose(1, 2)) / math.sqrt(q.shape[-1])
    if causal:
        s = q.shape[1]
        keep = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        sc = sc.masked_fill(~keep, -1e30)
    lse = torch.logsumexp(sc, dim=-1)
    out = torch.matmul(torch.exp(sc - lse[..., None]), vf)
    return out, lse[:, None, :]


def _err(got, want):
    return float((got.detach().float() - want.detach().float()).abs().max()
                 / want.detach().float().abs().max().clamp_min(1e-30))


def lse_route_gate(fa, device="cuda", shape=(LSE_BH, LSE_S, LSE_D)):
    """8h (a), one process: the lse route with a non-zero lse cotangent,
    causal and full, against the plain f32 autograd; the cotangent
    dropped must fail the gradients' bound."""
    gen = torch.Generator(device=device).manual_seed(81)
    q, k, v, g = (torch.randn(shape, generator=gen, device=device)
                  .to(torch.bfloat16) for _ in range(4))
    g_lse = torch.randn((shape[0], 1, shape[1]), generator=gen,
                        device=device)
    res = {}
    for causal in (True, False):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out, lse = fa.flash_attention_lse_bhd(*leaves, causal)
        torch.autograd.backward([out, lse], [g, g_lse])
        got = [out, lse] + [t.grad for t in leaves]
        refs = [t.clone().requires_grad_() for t in (q, k, v)]
        ro, rl = _plain_lse_attention(*refs, causal)
        torch.autograd.backward([ro, rl], [g.float(), g_lse])
        want = [ro, rl] + [t.grad for t in refs]
        # the planted fault: the kernels' backward without the lse
        # cotangent
        dropped = fa._attn_bwd(q, k, v, out.detach(), lse.detach(), g,
                               causal)
        torch.cuda.synchronize()
        e = {"out": _err(got[0], want[0]),
             "lse": float((got[1] - want[1]).detach().abs().max()),
             "dq": _err(got[2], want[2]), "dk": _err(got[3], want[3]),
             "dv": _err(got[4], want[4]),
             "dropped": max(_err(a, b) for a, b in zip(dropped, want[2:]))}
        res["causal" if causal else "full"] = e
    print(f"8h (a) the lse route (flash_attention_lse_bhd, [B·H {LSE_BH}, "
          f"S {LSE_S}, D {LSE_D}] bf16, random out and lse cotangents) vs "
          f"the plain f32 autograd, error over max-abs (lse absolute): "
          + "; ".join(f"{k}: " + ", ".join(f"{n} {x:.3e}" for n, x in
                                          e.items()) for k, e in res.items())
          + f" (tol out {LSE_OUT_TOL:.0e}, lse {LSE_LSE_TOL:.0e}, gradients "
          f"{LSE_GRAD_TOL:.0e}; 'dropped': the lse cotangent left out, a "
          f"planted fault that must fail the gradients' tol)")
    for k, e in res.items():
        bad = [n for n, tol in (("out", LSE_OUT_TOL), ("lse", LSE_LSE_TOL),
                                ("dq", LSE_GRAD_TOL), ("dk", LSE_GRAD_TOL),
                                ("dv", LSE_GRAD_TOL)) if not e[n] <= tol]
        if bad:
            raise AssertionError(f"8h (a) lse route ({k}): {bad} off "
                                 f"their tolerances: {e}")
        if not e["dropped"] > LSE_GRAD_TOL:
            raise AssertionError(f"8h (a) lse route ({k}): the dropped lse "
                                 f"cotangent passes the gradients' gate: "
                                 f"{e['dropped']:.3e}")
    return res


def _launch_profile_dist(out_dir, nproc, args, timeout, label,
                         meanwhile=None):
    """`profile_dist.py ARGS` under the launcher, `nproc` processes
    sharing the card, with `meanwhile()` run here while they start;
    returns (the ranks' json, seconds)."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [*launcher_cmd(nproc, f"{out_dir}/log"),
           os.path.join("paddle_tpu_torch", "profile_dist.py"),
           *args, "--out", out_dir]
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("PT_CHAOS_PLAN", None)
    t0 = time.perf_counter()
    t_wall = time.time()
    p = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True,
                         start_new_session=True)
    try:
        if meanwhile is not None:
            meanwhile()
        out, _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, 15)
        try:
            out, _ = p.communicate(timeout=20)
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, 9)
            out, _ = p.communicate()
        raise AssertionError(f"{label}: the launch ran past {timeout} s:\n"
                             f"{out[-4000:]}")
    except BaseException:
        os.killpg(p.pid, 9)
        p.communicate()
        raise
    seconds = time.perf_counter() - t0
    if p.returncode != 0:
        tails = ""
        for r in range(nproc):
            f = os.path.join(out_dir, "log", f"default.rank{r}.log")
            if os.path.exists(f):
                tails += f"\n--- rank {r} ---\n" + open(f).read()[-3000:]
        raise AssertionError(f"{label}: the launcher exited {p.returncode}:"
                             f"\n{out[-4000:]}{tails}")
    outs = []
    for r in range(nproc):
        with open(os.path.join(out_dir, f"dist_out_{r}.json")) as f:
            outs.append(json.load(f))
    print_startup(label, outs, t_wall)
    return outs, seconds


def auto_serial(device="cuda", model="gpt_small", seq=AUTO_SEQ):
    """The full-auto arm's model stepped serially (no Engine, one
    process): its losses, the reference of 8h (c)'s gate."""
    from paddle_tpu_torch.core.rng import seed
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.profile_dist import (auto_batches, auto_gpt,
                                               lm_loss, model_config)

    cfg, _ = model_config(model, AUTO_LAYERS)
    seed(0)
    m = auto_gpt(cfg, torch.device(device))
    opt = AdamW(1e-4, parameters=m.parameters())
    losses = []
    for x, y in auto_batches(cfg, AUTO_BATCH, seq, AUTO_STEPS):
        loss = lm_loss(m(x.to(device)), y.to(device))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    del m, opt
    return losses


def ring_auto_phase(card, device="cuda", model="gpt_small",
                    ring_seq=RING_SEQ, auto_seq=AUTO_SEQ, counted=True):
    """8h (a)'s ring and (c): one 2-process launch. Returns the ranks'
    ring-call flash launches (all and causal)."""
    serial = []

    def world1():
        # (c)'s serial reference, run while the two processes start
        serial.extend(auto_serial(device, model, auto_seq))
        gc.collect()
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="ring_") as d:
        outs, seconds = _launch_profile_dist(
            d, 2, ["--model", model, "--device", device, "--ring-check",
                   "--ring-seq", str(ring_seq), "--auto", "--layers",
                   str(AUTO_LAYERS), "--batch", str(AUTO_BATCH), "--seq",
                   str(auto_seq), "--steps", str(AUTO_STEPS)],
            CHECKS_TIMEOUT_S, "8h (a, c)", meanwhile=world1)
    fails = []
    for o in outs:
        rc, a = o["ring_check"], o["auto"]
        i = rc["idx"]
        for ref in ("vs_whole", "vs_dense"):
            e = rc[ref]
            if not (e["out"] <= RING_OUT_TOL and max(
                    e[n] for n in ("dq", "dk", "dv")) <= RING_GRAD_TOL):
                fails.append(f"rank {o['rank']} {ref} {e}")
        want = {"flash_forward": i + 1, "flash_bwd_dq": i + 1,
                "flash_bwd_dkv": i + 1}
        causal = dict.fromkeys(want, 1)
        if counted and (rc["launches"] != want or rc["tc_launches"] != want
                        or rc["causal_launches"] != causal):
            fails.append(f"rank {o['rank']} ring launches {rc['launches']}"
                         f" (tensor-core {rc['tc_launches']}, causal "
                         f"{rc['causal_launches']}); expected {want}, "
                         f"causal {causal}")
        rel = _rel(a["losses"], serial)
        if not rel <= AUTO_LOSS_RTOL:
            fails.append(f"rank {o['rank']} Engine losses {a['losses']} vs "
                         f"serial {serial}: {rel:.3e}")
    a0 = outs[0]["auto"]
    print(f"8h (a) ring_flash_attention at sp 2 over one {ring_seq}-token "
          f"causal sequence (b 1, 32 heads, head_dim 64, "
          f"{outs[0]['ring_check']['dtype']}), two processes on one card "
          f"({card}): launcher to exit {seconds:.1f} s; "
          + "; ".join(
              f"rank {o['rank']}: vs the whole sequence's flash "
              + ", ".join(f"{n} {x:.3e}" for n, x in
                          o["ring_check"]["vs_whole"].items())
              + ", vs the dense f32 ring "
              + ", ".join(f"{n} {x:.3e}" for n, x in
                          o["ring_check"]["vs_dense"].items())
              + f" (tol {RING_OUT_TOL:.0e} / {RING_GRAD_TOL:.0e}); ring "
              f"call {o['ring_check']['seconds']:.3f} s, frames "
              f"{o['ring_check']['ring'].get('ring_p2p', {})}, launches "
              f"{o['ring_check']['launches']} (causal "
              f"{o['ring_check']['causal_launches']}, tensor-core "
              f"{o['ring_check']['tc_launches']})" for o in outs))
    print(f"8h (c) the auto-parallel Engine, auto_mode='full' over 2 "
          f"processes, the H100 ClusterSpec, gpt_small widths x "
          f"{AUTO_LAYERS} layers as plain layers, f32, b{AUTO_BATCH}·"
          f"s{auto_seq}, AdamW(1e-4) ({card}): plan {a0['plan']}; mesh "
          f"{ {k: v for k, v in a0['mesh'].items() if v > 1} }; realized "
          f"{[u for u in a0['realized'] if u[1] != 'rep']} ("
          f"{sum(u[1] == 'rep' for u in a0['realized'])} units "
          f"replicated); losses "
          + "; ".join(f"rank {o['rank']} {o['auto']['losses']}"
                      for o in outs)
          + f" vs serial {serial} (tol {AUTO_LOSS_RTOL:.0e}); s/step "
          + "; ".join(f"rank {o['rank']} "
                      f"{[round(x, 4) for x in o['auto']['step_seconds']]}"
                      for o in outs)
          + f"; mp collectives a step (rank 0) {a0['comm'][-1]}; peak "
          + ", ".join("not measured" if o["peak_mb"] is None else
                      f"{o['peak_mb']:.0f} MB" for o in outs))
    if fails:
        raise AssertionError("8h (a, c): " + "; ".join(fails))
    return {f"ring_rank{o['rank']}": (o["ring_check"]["launches"],
                                      o["ring_check"]["causal_launches"])
            for o in outs}


def pp_sp_phase(card, device="cuda", model="gpt_small", seq=SP_SEQ,
                counted=True):
    """8h (b): pp 2 x sp 2 as four processes sharing the card, against a
    world-1 run of the same pipelined GPT on the card, with the three
    planted faults. Returns the ranks' flash launches (all and causal)."""
    from paddle_tpu_torch.distributed import mesh as tmesh
    from paddle_tpu_torch.profile_dist import build_pipelined, global_batch

    tmesh.reset_mesh()
    gc.collect()
    torch.cuda.empty_cache()
    ref_losses = []

    def world1():
        # the world-1 reference, run while the four processes start
        cfg, ref = build_pipelined(model, torch.device(device),
                                   layers=SP_LAYERS, n_micro=SP_MICRO,
                                   seq=seq)
        ids = global_batch(cfg, SP_BATCH, seq).to(device)
        ref_losses.extend(float(ref(ids)) for _ in range(SP_STEPS))
        del ref
        gc.collect()
        torch.cuda.empty_cache()

    args = ["--model", model, "--device", device, "--mesh", "pp=2,sp=2",
            "--layers", str(SP_LAYERS), "--n-micro", str(SP_MICRO),
            "--steps", str(SP_STEPS), "--batch", str(SP_BATCH), "--seq",
            str(seq)]
    for plant in SP_PLANTS:
        args += ["--plant", plant]
    with tempfile.TemporaryDirectory(prefix="sp_") as d:
        outs, seconds = _launch_profile_dist(d, SP_RANKS, args,
                                             SP_TIMEOUT_S, "8h (b)",
                                             meanwhile=world1)
    fails = []
    L = SP_LAYERS // 2
    digests = {}
    for o in outs:
        c = o["coord"]
        digests.setdefault(c["pp"], {})[c["sp"]] = o
        n = SP_STEPS * L * SP_MICRO * (c["sp"] + 1)
        want = {"flash_forward": 2 * n, "flash_bwd_dq": n,
                "flash_bwd_dkv": n}
        k = SP_STEPS * L * SP_MICRO
        causal = {"flash_forward": 2 * k, "flash_bwd_dq": k,
                  "flash_bwd_dkv": k}
        if counted and (o["launches"] != want or o["tc_launches"] != want
                        or o["causal_launches"] != causal):
            fails.append(f"rank {o['rank']} launched {o['launches']} "
                         f"(tensor-core {o['tc_launches']}, causal "
                         f"{o['causal_launches']}); expected {want}, "
                         f"causal {causal}")
        r0 = abs(o["losses"][0] - ref_losses[0]) / abs(ref_losses[0])
        rl = _rel(o["losses"][1:], ref_losses[1:])
        if not (r0 <= SP_LOSS_RTOL and rl <= SP_LATER_RTOL):
            fails.append(f"rank {o['rank']} losses {o['losses']} vs world "
                         f"1 {ref_losses}: step 0 {r0:.3e}, later "
                         f"{rl:.3e}")
    planted = {}
    for stage, by_sp in digests.items():
        if by_sp[0]["param_digest"] != by_sp[1]["param_digest"]:
            fails.append(f"stage {stage}: the sp replicas' parameters "
                         "differ after the steps")
        p0, p1 = by_sp[0]["planted"], by_sp[1]["planted"]
        for name in ("ring_skip", "label_unshifted"):
            x = abs(p0[name]["losses"][0] - ref_losses[0]) / abs(
                ref_losses[0])
            planted[name] = max(planted.get(name, 0.0), x)
        # the fault shows where any stage's replicas part
        planted["sp_grad_sum replicas equal"] = planted.get(
            "sp_grad_sum replicas equal", True) and (
            p0["sp_grad_sum"]["param_digest"]
            == p1["sp_grad_sum"]["param_digest"])
    for name in ("ring_skip", "label_unshifted"):
        if not planted[name] > SP_LOSS_RTOL:
            fails.append(f"the planted {name} passes the step-0 gate: "
                         f"{planted[name]:.3e}")
    if planted["sp_grad_sum replicas equal"]:
        fails.append("the planted sp_grad_sum leaves the sp replicas "
                     "equal")

    def ring(o):
        d = o["comm"][-1]["ring"].get("ring_p2p", {})
        return (f"{d.get('calls', 0)} frames, {d.get('bytes', 0)} bytes, "
                f"{d.get('seconds', 0.0):.3f} s")

    print(f"8h (b) PipelinedGPTForCausalLM at pp 2 x sp 2 on one card "
          f"(four processes; gpt_small widths, depth cut to {SP_LAYERS} "
          f"layers; b{SP_BATCH}·s{seq}, n_micro {SP_MICRO}, per-layer "
          f"remat, bf16 O1, HybridTrainStep, AdamW(1e-4); the ring over "
          f"the socket transport, the sp gradient sums and the tied wte "
          f"over gloo; {card}): launcher to exit {seconds:.1f} s; world 1 "
          f"on the card {ref_losses}; planted: ring_skip "
          f"{planted['ring_skip']:.3e}, label_unshifted "
          f"{planted['label_unshifted']:.3e} off world 1's step 0 (tol "
          f"{SP_LOSS_RTOL:.0e}), sp_grad_sum: the sp replicas' parameters "
          f"{'equal' if planted['sp_grad_sum replicas equal'] else 'differ'}"
          f"; " + "; ".join(
              f"rank {o['rank']} (pp {o['coord']['pp']}, sp "
              f"{o['coord']['sp']}): s/step "
              f"{[round(x, 4) for x in o['step_seconds']]}, the ring a "
              f"step {ring(o)}, peak "
              + (f"{o['peak_mb']:.0f} MB" if o["peak_mb"] is not None
                 else "not measured")
              + f", losses {o['losses']}, launches {o['launches']} (causal "
              f"{o['causal_launches']})" for o in outs))
    if fails:
        raise AssertionError("8h (b): " + "; ".join(fails))
    return {f"pp2sp2_rank{o['rank']}": (o["launches"], o["causal_launches"])
            for o in outs}


def sp_phase(fa, card):
    """8h: (a) the lse route and the ring, (c) the Engine (one launch),
    (b) pp 2 x sp 2; returns the flash launches of each rank's ring
    call and of pp 2 x sp 2."""
    t0 = time.perf_counter()
    lse_route_gate(fa)
    launches = ring_auto_phase(card)
    launches.update(pp_sp_phase(card))
    print(f"8h phase: {time.perf_counter() - t0:.1f} s")
    return launches


# ---- the vision training path (11) ----
#
# bench.py's two vision arms (bench_resnet :161, bench_mnist :338) on
# the port's conv, pooling, batch-norm and initializer layers. No Pallas
# kernel is on this path (convolutions are cuDNN's, pooling and batch
# norm torch's), so it adds no row to the kernels line. cuDNN picks its
# algorithms by heuristics (no benchmark sweep); every time is taken
# after a first step.

VISION_SHAPE = (3, 224, 224)
VISION_CROSS_BATCH = 2            # 11 (a): ResNet-50 f32, card vs CPU
VISION_BATCH, VISION_WARM, VISION_STEPS = 64, 2, 10   # 11 (b)
LENET_BATCH, LENET_CROSS_STEPS, LENET_STEPS = 128, 3, 20   # 11 (c)
# 11 (a): the card's f32 step (TF32 off) against the CPU's f32 step and
# the CPU's f64 step from the same weights. The loss within 1e-4
# relative of the CPU's f32. Random-init ResNet-50 in training is
# ill-conditioned in f32: the CPU's own f32 gradients are up to 0.2 of
# their max-abs (median 2e-2) off its f64 ones, so no f32 step can hold
# 1e-3 against another; the card's gradients must instead lie no farther
# from the f64 step than VISION_NOISE_MARGIN times the CPU's f32 do, at
# the worst tensor and at the median. Each running statistic within
# max(1e-5, VISION_NOISE_MARGIN x the CPU f32's distance) of the f64
# step's, over max(1, its max-abs) (the CPU f32's own: 6.6e-6)
VISION_LOSS_RTOL, VISION_STAT_TOL, VISION_NOISE_MARGIN = 1e-4, 1e-5, 2.0
# 11 (b): step 0's bf16 O1 loss against the f32 step 0 from the same
# weights (bf16 convolutions, f32 batch norm)
VISION_O1_RTOL = 1e-2
# 11 (c): LeNet card vs CPU, losses and parameters
LENET_TOL = 1e-5
# a planted fault must move its gate's measure past this many times the
# gate's tolerance
VISION_FAULT_MARGIN = 2.0


def _resnet_ce(m, x, y):
    from paddle_tpu_torch.nn import functional as F

    return F.cross_entropy(m(x), y)


def _resnet_ce_o1(m, x, y):
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import functional as F

    with amp.auto_cast(level="O1", dtype="bfloat16"):
        return F.cross_entropy(m(x), y)


def _vision_batch(n, shape, classes, seed, device):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n,) + shape).astype(
        np.float32)).to(device)
    y = torch.from_numpy(rng.integers(0, classes, (n,))).to(device)
    return x, y


def _bn_stats(model):
    return {n: b.detach().float().cpu().clone()
            for n, b in model.named_buffers()
            if n.endswith("._mean") or n.endswith("._variance")}


def _stat_gap(ref, other):
    """The worst running statistic's max-abs difference over max(1, its
    max-abs), and its name."""
    gaps = {n: ((other[n] - r).abs().max()
                / max(1.0, float(r.abs().max()))).item()
            for n, r in ref.items()}
    where = max(gaps, key=gaps.get)
    return gaps[where], where


def _resnet_step(model, x, y, loss_fn=_resnet_ce, remat=False):
    """One TrainStep with Momentum(0.1): (loss, {name: gradient on the
    CPU}, running statistics)."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import Momentum

    step = TrainStep(model, loss_fn,
                     Momentum(0.1, parameters=model.parameters()),
                     remat=remat)
    loss = float(step(x, y))
    grads = {n: p.grad.float().cpu() for n, p in model.named_parameters()}
    return loss, grads, _bn_stats(model)


@contextlib.contextmanager
def _planted(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def _torch_rule_batch_norm(x, running_mean, running_var, weight=None,
                           bias=None, training=False, momentum=0.9,
                           epsilon=1e-5, data_format="NCHW",
                           use_global_stats=None, name=None):
    """Planted fault: batch norm whose running statistics follow torch's
    own rule (unbiased variance, momentum 0.1 on the batch)."""
    return torch.nn.functional.batch_norm(
        x.float(), running_mean, running_var, weight, bias,
        training=training, momentum=0.1, eps=epsilon)


def _symmetric_same_pads(sizes, windows, strides):
    """Planted fault: "SAME" padding split evenly, the odd unit on both
    sides."""
    pads = []
    for size, w, s in zip(sizes, windows, strides):
        total = max((-(-size // s) - 1) * s + w - size, 0)
        pads.append(((total + 1) // 2, (total + 1) // 2))
    return pads


def same_padding_gate(device="cuda"):
    """`F.conv2d(padding="SAME")` at stride 2 on even and odd sizes
    (ResNet-50's layer2 input, 56 and 57) against the same convolution
    over XLA's pairs written out here (out = ceil(in / 2), the odd unit
    of padding on the high side). Returns the worst error over the
    output's max-abs (inf on a shape mismatch)."""
    from paddle_tpu_torch.nn import functional as F

    g = torch.Generator(device="cpu").manual_seed(11)
    w = torch.randn(128, 64, 3, 3, generator=g).to(device)
    worst = 0.0
    for size in (56, 57):
        x = torch.randn(2, 64, size, size, generator=g).to(device)
        out = (size + 1) // 2
        total = max((out - 1) * 2 + 3 - size, 0)
        lo, hi = total // 2, total - total // 2
        want = torch.nn.functional.conv2d(
            torch.nn.functional.pad(x, (lo, hi, lo, hi)), w, stride=2)
        got = F.conv2d(x, w, padding="SAME", stride=2)
        if got.shape != want.shape:
            return math.inf
        worst = max(worst, ((got - want).abs().max()
                            / want.abs().max()).item())
    return worst


def vision_cross(card, device="cuda", shape=VISION_SHAPE):
    """11 (a): ResNet-50 whole (1000 classes) in f32 with TF32 off, b2 at
    3x224x224: one TrainStep with Momentum(0.1) on the card and one on
    the CPU from the same weights and batch; the remat step's running
    statistics against the plain step's; the "SAME" padding gate; and
    the three planted faults, each of which must fail its gate."""
    from paddle_tpu_torch.core import recompute
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn.functional import conv as conv_mod
    from paddle_tpu_torch.vision.models import resnet50

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    t0 = time.perf_counter()
    gpu = resnet50(num_classes=1000, device=device, seed=0)
    init = {k: v.detach().clone() for k, v in gpu.state_dict().items()}
    cpu = resnet50(num_classes=1000, device="cpu", seed=0)
    same_init = all(torch.equal(v.cpu(), cpu.state_dict()[k])
                    for k, v in init.items())
    if not same_init:
        raise AssertionError("11 (a): resnet50(seed=0) built different "
                             "weights on the card and on the CPU")
    x, y = _vision_batch(VISION_CROSS_BATCH, shape, 1000, 0, "cpu")
    lc, gc_, sc = _resnet_step(cpu, x, y)
    cpu.double()
    cpu.load_state_dict({k: v.cpu().double() if v.is_floating_point()
                         else v.cpu() for k, v in init.items()})
    _, g64, s64 = _resnet_step(cpu, x.double(), y)
    xg, yg = x.to(device), y.to(device)

    def card_step(**kw):
        gpu.load_state_dict(init)
        return _resnet_step(gpu, xg, yg, **kw)

    lg, gg, sg = card_step()
    g_worst, g_where, g_median = _grad_diff(g64, gg)
    c_worst, c_where, c_median = _grad_diff(g64, gc_)
    f32_worst, _, f32_median = _grad_diff(gc_, gg)
    s_worst, s_where = _stat_gap(s64, sg)
    c_stat, _ = _stat_gap(s64, sc)
    s_f32, _ = _stat_gap(sc, sg)
    stat_tol = max(VISION_STAT_TOL, VISION_NOISE_MARGIN * c_stat)
    loss_rel = abs(lg - lc) / abs(lc)
    _, _, sr = card_step(remat=True)
    remat_gap, _ = _stat_gap(sg, sr)
    same_err = same_padding_gate(device)
    # planted faults, each against its gate
    with _planted(F, "batch_norm", _torch_rule_batch_norm):
        _, _, s_fault = card_step()
    fault_rule, _ = _stat_gap(s64, s_fault)
    with _planted(recompute, "in_recompute", lambda: False):
        _, _, s_twice = card_step(remat=True)
    fault_twice, _ = _stat_gap(sg, s_twice)
    with _planted(conv_mod, "same_pads", _symmetric_same_pads):
        fault_same = same_padding_gate(device)
    seconds = time.perf_counter() - t0
    print(f"11 (a) ResNet-50 f32 (TF32 off) b{VISION_CROSS_BATCH}·{shape}, "
          f"1000 classes, one TrainStep Momentum(0.1), card vs CPU ({card})"
          f": loss {lg:.6f} vs {lc:.6f} (relative {loss_rel:.3e}; tol "
          f"{VISION_LOSS_RTOL:g}); gradients against the CPU's f64 step, "
          f"over each one's max-abs: the card's f32 worst {g_worst:.3e} "
          f"({g_where}), median {g_median:.3e}, the CPU's f32 worst "
          f"{c_worst:.3e} ({c_where}), median {c_median:.3e} (gate: the "
          f"card within {VISION_NOISE_MARGIN:g}x the CPU's; card vs CPU "
          f"f32 worst {f32_worst:.3e}, median {f32_median:.3e}) over "
          f"{len(gc_)} parameters; running statistics against the f64 "
          f"step: the card {s_worst:.3e} ({s_where}), the CPU's f32 "
          f"{c_stat:.3e} (tol {stat_tol:.3e}; card vs CPU f32 "
          f"{s_f32:.3e}) over {len(sc)}; remat=True's statistics "
          f"{remat_gap:.3e} off remat=False's; \"SAME\" at stride 2 vs "
          f"XLA's pairs {same_err:.3e}; planted: torch's running-stat rule "
          f"{fault_rule:.3e}, a second update under remat "
          f"{fault_twice:.3e}, symmetric \"SAME\" {fault_same:.3e}; "
          f"{seconds:.1f} s")
    if not (loss_rel <= VISION_LOSS_RTOL
            and g_worst <= VISION_NOISE_MARGIN * c_worst
            and g_median <= VISION_NOISE_MARGIN * c_median
            and s_worst <= stat_tol):
        raise AssertionError("11 (a): card and CPU ResNet-50 steps disagree")
    if remat_gap > VISION_STAT_TOL:
        raise AssertionError("11 (a): remat=True updated the running "
                             "statistics otherwise than remat=False")
    if same_err > 1e-4:
        raise AssertionError("11 (a): \"SAME\" padding is not XLA's")
    margin = VISION_FAULT_MARGIN
    if not (fault_rule > margin * stat_tol
            and fault_twice > margin * VISION_STAT_TOL
            and fault_same > margin * 1e-4):
        raise AssertionError("11 (a): a planted fault passed its gate")
    del gpu, cpu
    gc.collect()
    torch.cuda.empty_cache()


def conv_linear_flops(model, x):
    """Forward FLOPs of `model`'s convolutions and linears on `x` (2 per
    multiply-add: out elements × in-channels/groups × kernel area), from
    the shapes each layer sees in one no-grad eval pass."""
    from paddle_tpu_torch import nn as pnn

    total = [0]

    def conv_hook(m, inp, out):
        k = int(np.prod(m._kernel_size))
        total[0] += 2 * out.numel() * (m._in_channels // m._groups) * k

    def linear_hook(m, inp, out):
        total[0] += 2 * out.numel() * m.in_features

    hooks = [m.register_forward_hook(conv_hook if isinstance(m, pnn.Conv2D)
                                     else linear_hook)
             for m in model.modules()
             if isinstance(m, (pnn.Conv2D, pnn.Linear))]
    was = model.training
    model.eval()
    try:
        with torch.no_grad():
            model(x)
    finally:
        model.train(was)
        for h in hooks:
            h.remove()
    return total[0]


def vision_resnet(card, device="cuda", shape=VISION_SHAPE,
                  batch=VISION_BATCH):
    """11 (b): the bench_resnet arm at its shapes: ResNet-50, b64 at
    3x224x224, 1000 classes, Momentum(0.1), bf16 O1 under
    `amp.auto_cast`, TrainStep. Step 0's O1 loss against the f32 step 0
    from the same weights; 2 warm-up steps, then 10 timed ones ending in
    a synchronize."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.profile_train import H100_PEAK_BF16
    from paddle_tpu_torch.vision.models import resnet50

    model = resnet50(num_classes=1000, device=device, seed=0)
    x, y = _vision_batch(batch, shape, 1000, 0, device)
    flops_img = conv_linear_flops(model, x[:1])
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    stats0 = _bn_stats(model)
    l32, _, _ = _resnet_step(model, x, y)
    model.load_state_dict(init)
    step = TrainStep(model, _resnet_ce_o1,
                     Momentum(0.1, parameters=model.parameters()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [float(step(x, y)) for _ in range(VISION_WARM)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last = [step(x, y) for _ in range(VISION_STEPS)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / VISION_STEPS
    losses += [float(v) for v in last]
    peak = torch.cuda.max_memory_allocated() / 2**30
    moved, _ = _stat_gap(stats0, _bn_stats(model))
    step_flops = 3 * flops_img * batch
    mfu = step_flops / dt / H100_PEAK_BF16
    o1_rel = abs(losses[0] - l32) / abs(l32)
    print(f"11 (b) bench_resnet: ResNet-50 b{batch}·{shape}, "
          f"1000 classes, Momentum(0.1), bf16 O1, TrainStep ({card}): "
          f"{dt * 1e3:.3f} ms/step, {batch / dt:.1f} img/s, MFU "
          f"{mfu:.4f} ({flops_img / 1e9:.3f} GFLOP an image's forward "
          f"from the conv and linear shapes, x3 for the step: "
          f"{step_flops / 1e12:.3f} TFLOP; 989 TFLOP/s bf16 peak), peak "
          f"memory {peak:.2f} GiB; step 0 O1 loss {losses[0]:.6f} vs f32 "
          f"{l32:.6f} (relative {o1_rel:.3e}; tol {VISION_O1_RTOL:g}); "
          f"losses {losses[0]:.4f} → {losses[-1]:.4f} over {len(losses)} "
          f"steps; running statistics moved {moved:.3e}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"11 (b): losses not finite: {losses}")
    if o1_rel > VISION_O1_RTOL:
        raise AssertionError("11 (b): the O1 step 0 is not the f32 one")
    if not moved > 0.0:
        raise AssertionError("11 (b): the running statistics did not move")
    del step, model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(ms=dt * 1e3, img_s=batch / dt, mfu=mfu, peak_gib=peak,
                gflop_img=flops_img / 1e9)


def _lenet_steps(model, x, y, steps):
    """bench_mnist's eager loop: forward, `backward()`, `step()`,
    `clear_grad()` with Momentum(0.01); returns the loss tensors."""
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Momentum

    opt = Momentum(0.01, parameters=model.parameters())
    out = []
    for _ in range(steps):
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        out.append(loss.detach())
    return out


def vision_lenet(card, device="cuda"):
    """11 (c): the bench_mnist arm: LeNet, b128 at 1x28x28, Momentum(0.01),
    f32, eager. 3 steps on the card and 3 on the CPU from the same weights
    (losses and parameters within LENET_TOL), then 20 timed steps."""
    from paddle_tpu_torch.vision.models import LeNet

    x, y = _vision_batch(LENET_BATCH, (1, 28, 28), 10, 0, "cpu")
    runs = []
    for dev in (device, "cpu"):
        m = LeNet(device=dev, seed=0)
        losses = _lenet_steps(m, x.to(dev), y.to(dev), LENET_CROSS_STEPS)
        runs.append(([float(v) for v in losses],
                     {n: p.detach().cpu() for n, p in m.named_parameters()}))
    (lg, pg), (lc, pc) = runs
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    p_worst = max((pg[n] - p).abs().max().item() for n, p in pc.items())
    m = LeNet(device=device, seed=0)
    xg, yg = x.to(device), y.to(device)
    _lenet_steps(m, xg, yg, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last = _lenet_steps(m, xg, yg, LENET_STEPS)
    float(last[-1])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / LENET_STEPS
    print(f"11 (c) bench_mnist: LeNet b{LENET_BATCH}·1x28x28, Momentum(0.01)"
          f", f32, eager backward / step / clear_grad ({card}): "
          f"{dt * 1e3:.3f} ms/step, {1 / dt:.1f} steps/s; "
          f"{LENET_CROSS_STEPS} steps card vs CPU: losses {lg} vs {lc} "
          f"(relative {loss_rel:.3e}), parameters {p_worst:.3e} apart (tol "
          f"{LENET_TOL:g})")
    if not (loss_rel <= LENET_TOL and p_worst <= LENET_TOL):
        raise AssertionError("11 (c): card and CPU LeNet steps disagree")
    return dict(ms=dt * 1e3, steps_s=1 / dt)


def vision_phase(card):
    """11: (a) the ResNet-50 cross-check with its planted faults, (b)
    bench_resnet, (c) bench_mnist."""
    t0 = time.perf_counter()
    vision_cross(card)
    resnet = vision_resnet(card)
    lenet = vision_lenet(card)
    print(f"vision phase (11): {time.perf_counter() - t0:.1f} s")
    return resnet, lenet


# ---- BERT / ERNIE pretraining and the tensor API (12) ----

# (a): BERT-base widths, depth cut, f32 with TF32 off, b2·s128, card vs CPU;
# the loss relative, each gradient's max-abs difference over its max-abs.
# The limits sit between the sound readings (H100 80GB HBM3: loss 8.5e-8,
# worst gradient 1.52e-6) and the planted faults (causal attention: loss
# 1.0e-3, gradients 1.37; TF32 matmuls on the card: 4.0e-6, 9.9e-4)
BERT_CROSS_LAYERS, BERT_CROSS_BATCH, BERT_CROSS_SEQ = 2, 2, 128
BERT_CROSS_LOSS_TOL = 1e-5
BERT_CROSS_GRAD_TOL = 1e-5
# (b) bench_bert (bench.py:199): bert_base, b32·s512, bf16 O1, AdamW(1e-4)
BERT_BATCH, BERT_SEQ = 32, 512
BERT_WARM, BERT_STEPS = 3, 10
BERT_O1_TOL = 1e-2       # step 0's O1 loss vs the f32 loss, relative
# (c): the lengths (kv_lens) route vs the keep-mask (dense) route, both
# bf16 O1 from the same weights: the sequence output on each row's valid
# positions (the worst row's mean |difference| over its mean |value|) and
# each gradient's max-abs difference over its max-abs (the worst). Set
# from the readings (H100 80GB HBM3): sound 5.36e-3 / 2.32e-2; planted no
# mask (the padding attended) 0.164 / 0.279
BERT_PAD_SEQ_TOL = 2e-2
BERT_PAD_GRAD_TOL = 6e-2
# (d): float outputs card vs CPU, of max(1, the CPU's max-abs)
TAPI_TOL = 1e-5


def _bert_batch(cfg, b, s, seed):
    """bench.py:227-233's ids (int32), MLM labels (15 % of positions,
    -100 elsewhere) and NSP labels, from default_rng(seed), on the card."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (b, s))
    labels = np.full((b, s), -100, np.int64)
    mask = rng.random((b, s)) < 0.15
    labels[mask] = ids[mask]
    nsp = rng.integers(0, 2, (b,))
    dev = torch.device("cuda")
    return (torch.as_tensor(ids.astype(np.int32), device=dev),
            torch.as_tensor(labels, device=dev), torch.as_tensor(nsp,
                                                                 device=dev))


class _CausalF:
    """The functional namespace with scaled_dot_product_attention forced
    causal: 12 (a)'s planted fault."""

    def __init__(self, F):
        self._F = F

    def __getattr__(self, name):
        return getattr(self._F, name)

    def scaled_dot_product_attention(self, *a, **kw):
        return self._F.scaled_dot_product_attention(*a, **dict(
            kw, is_causal=True))


def _bert_grads(model, batch):
    """(loss, {name: f32 gradient on the host}) of one TrainStep."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models.bert import BertPretrainingCriterion

    crit = BertPretrainingCriterion()

    def loss_fn(m, ids, labels, nsp):
        ml, nl = m(ids)
        return crit(ml, labels, nl, nsp)

    step = TrainStep(model, loss_fn, AdamW(1e-4, parameters=model.parameters()))
    dev = next(iter(model.parameters())).device
    loss = float(step(*(t.to(dev) for t in batch)))
    return loss, {n: p.grad.float().cpu() for n, p in model.named_parameters()}


def bert_cross(fa):
    """12 (a): one f32 TrainStep of BERT-base widths (depth cut) on the
    card (K3-K5 bidirectional, CUDA-core route for f32) and on the CPU
    (their plain versions) from the same weights; then two planted card
    steps, attention forced causal and TF32 allowed in the matmuls, each
    of which must fail a gate by 2x."""
    from paddle_tpu_torch.text.models import bert

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = bert.BertConfig(**dict(vars(bert.bert_base()),
                                 num_layers=BERT_CROSS_LAYERS))
    gpu = bert.BertForPretraining(cfg, seed=12)
    w0 = {k: v.detach().clone() for k, v in gpu.state_dict().items()}
    cpu = bert.BertForPretraining(cfg, device="cpu", seed=None)
    cpu.load_state_dict({k: v.cpu() for k, v in w0.items()})
    batch = _bert_batch(cfg, BERT_CROSS_BATCH, BERT_CROSS_SEQ, 12)
    fa.reset_launches()
    lg, gg = _bert_grads(gpu, batch)
    launches, causal = dict(fa.launches), dict(fa.causal_launches)
    lc, gc = _bert_grads(cpu, batch)
    planted = bert.BertForPretraining(cfg, seed=None)
    planted.load_state_dict(w0)
    F = bert.F
    bert.F = _CausalF(F)
    try:
        lp, gp = _bert_grads(planted, batch)
    finally:
        bert.F = F
    planted.load_state_dict(w0)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        lt, gt = _bert_grads(planted, batch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    loss_rel = abs(lg - lc) / abs(lc)
    worst, where, median = _grad_diff(gc, gg)

    def ratio(loss, grads):
        w, at, _ = _grad_diff(gc, grads)
        rel = abs(loss - lc) / abs(lc)
        return (rel, w, at,
                max(rel / BERT_CROSS_LOSS_TOL, w / BERT_CROSS_GRAD_TOL))

    p_loss, p_worst, p_where, p_ratio = ratio(lp, gp)
    t_loss, t_worst, t_where, t_ratio = ratio(lt, gt)
    print(f"12 (a) BERT-base widths x {BERT_CROSS_LAYERS} layers f32 (TF32 "
          f"off) b{BERT_CROSS_BATCH}·s{BERT_CROSS_SEQ}, one TrainStep, card "
          f"vs CPU: loss {lg:.6f} vs {lc:.6f} (relative {loss_rel:.3e}; tol "
          f"{BERT_CROSS_LOSS_TOL:.0e}), gradients: worst {worst:.3e} of its "
          f"max-abs ({where}; tol {BERT_CROSS_GRAD_TOL:.0e}), median "
          f"{median:.3e} over {len(gc)} parameters; card launches "
          f"{launches} (non-causal); planted causal=True on the card: loss "
          f"{p_loss:.3e}, gradients worst {p_worst:.3e} ({p_where}) -> "
          f"{p_ratio:.1f}x its gate; planted TF32 matmuls on the card: loss "
          f"{t_loss:.3e}, gradients worst {t_worst:.3e} ({t_where}) -> "
          f"{t_ratio:.1f}x its gate")
    if launches != dict.fromkeys(fa.REPLACES, BERT_CROSS_LAYERS) or any(
            causal.values()):
        raise AssertionError(f"12 (a): card launches {launches}, causal "
                             f"{causal}")
    if not (loss_rel <= BERT_CROSS_LOSS_TOL and worst <= BERT_CROSS_GRAD_TOL):
        raise AssertionError("12 (a): the card's BERT step disagrees with "
                             "the CPU's")
    for fault, r in (("causal", p_ratio), ("TF32", t_ratio)):
        if r < 2.0:
            raise AssertionError(f"12 (a): the planted {fault} fault moved "
                                 f"its measure only {r:.2f}x its gate")
    del gpu, cpu, planted
    return {"loss_rel": loss_rel, "worst": worst, "planted": p_ratio,
            "planted_tf32": t_ratio}


def _bert_flops(cfg, batch, seq):
    """bench.py:247-252's count: 6 x the matmul parameters a token, plus
    the attention's products, forward and backward."""
    d, L, v = cfg.hidden_size, cfg.num_layers, cfg.vocab_size
    per_layer = 4 * d * d + 2 * d * cfg.intermediate_size
    p_matmul = L * per_layer + v * d + 2 * d * d
    return 6 * p_matmul * batch * seq + L * batch * (4 * seq * seq * d) * 3


def _flash_counts(fa, want, label):
    """K3-K5's counts since the last reset: `want` each, all on the
    tensor cores, none causal."""
    got = (dict(fa.launches), dict(fa.tc_launches), dict(fa.causal_launches))
    if (got[0] != dict.fromkeys(fa.REPLACES, want) or got[1] != got[0]
            or any(got[2].values())):
        raise AssertionError(f"12 {label}: launches {got[0]}, tensor-core "
                             f"{got[1]}, causal {got[2]}; expected {want} "
                             "each, all tensor-core, none causal")
    return got[0]


def bench_bert(fa, card):
    """12 (b): bench_bert on the port — bert_base, b32·s512, bf16 O1,
    AdamW(1e-4), `TrainStep`, both heads (forward() + the criterion, and
    fused_mlm_loss) from the same weights: 3 warm-up and 10 timed steps
    each, step 0's O1 loss against the f32 loss at those weights. Returns
    (the model with its first weights, their copy, the launches by head)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.profile_train import H100_PEAK_BF16
    from paddle_tpu_torch.text.models import bert

    cfg = bert.bert_base()
    model = bert.BertForPretraining(cfg, seed=0)
    w0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    crit = bert.BertPretrainingCriterion()
    ids, labels, nsp = _bert_batch(cfg, BERT_BATCH, BERT_SEQ, 0)
    with torch.no_grad():
        ml, nl = model(ids)
        f32_loss = float(crit(ml, labels, nl, nsp))
        del ml, nl

    def forward_head(m, a, b, c):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            ml, nl = m(a)
            return crit(ml, b, nl, c)

    def fused_head(m, a, b, c):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            return m.fused_mlm_loss(a, b, nsp_labels=c, block_size=4096)

    flops = _bert_flops(cfg, BERT_BATCH, BERT_SEQ)
    out = {}
    for head, loss_fn in (("forward head", forward_head),
                          ("fused head", fused_head)):
        model.load_state_dict(w0)
        step = TrainStep(model, loss_fn,
                         AdamW(1e-4, parameters=model.parameters()))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        warm = [float(step(ids, labels, nsp)) for _ in range(BERT_WARM)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [step(ids, labels, nsp) for _ in range(BERT_STEPS)]
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / BERT_STEPS
        losses = warm + [float(x) for x in losses]
        launches = _flash_counts(
            fa, cfg.num_layers * (BERT_WARM + BERT_STEPS), f"(b) {head}")
        o1_rel = abs(losses[0] - f32_loss) / abs(f32_loss)
        peak = torch.cuda.max_memory_allocated() / 2**30
        mfu = flops / dt / H100_PEAK_BF16
        print(f"12 (b) bench_bert bert_base b{BERT_BATCH}·s{BERT_SEQ} bf16 "
              f"O1 AdamW(1e-4) TrainStep, {head} ({card}): "
              f"{dt * 1e3:.3f} ms/step, {BERT_BATCH / dt:.1f} samples/s, "
              f"MFU {mfu:.4f} ({flops / 1e12:.3f} TFLOP a step at 989 "
              f"TFLOP/s), peak memory {peak:.2f} GiB; step 0's O1 loss "
              f"{losses[0]:.6f} vs f32 {f32_loss:.6f} (relative "
              f"{o1_rel:.3e}; tol {BERT_O1_TOL:.0e}); losses "
              f"{losses[0]:.4f} -> {losses[-1]:.4f} over {len(losses)} "
              f"steps; launches {launches} = {cfg.num_layers} x "
              f"{BERT_WARM + BERT_STEPS}, all tensor-core, none causal")
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
                and o1_rel <= BERT_O1_TOL):
            raise AssertionError(f"12 (b) {head}: losses {losses}, f32 "
                                 f"{f32_loss}")
        out[head] = dict(ms=dt * 1e3, samples_per_s=BERT_BATCH / dt,
                         mfu=mfu, peak_gib=peak, launches=launches)
        del step
    return model, w0, out


def _bert_pad_run(model, w0, loss_fn, batch):
    """One O1 TrainStep from `w0`: (the sequence output as f32, {name:
    f32 gradient}), both on the card."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW

    model.load_state_dict(w0)
    seen = []
    hook = model.bert.register_forward_hook(
        lambda m, i, o: seen.append(o[0].detach().float()))
    step = TrainStep(model, loss_fn, AdamW(1e-4,
                                           parameters=model.parameters()))
    try:
        step(*batch)
    finally:
        hook.remove()
    return seen[0], {n: p.grad.float().clone()
                     for n, p in model.named_parameters()}


def _pad_seq_diff(ref, other, lens):
    """The worst row's mean |difference| over its valid positions, over
    the row's mean |value| there."""
    worst = 0.0
    for r, n in enumerate(lens.tolist()):
        a, b = ref[r, :n], other[r, :n]
        worst = max(worst, ((b - a).abs().mean()
                            / a.abs().mean().clamp(min=1e-30)).item())
    return worst


def bert_padded(fa, model, w0, card):
    """12 (c): a padded bench_bert batch as 1-D lengths (`bert_pad_lens`:
    one row at full length, one short, the rest drawn), one O1 TrainStep
    from `w0` on each route: K3-K5 with kv_lens on the tensor-core route
    (counted), and the same batch through the 2-D keep-mask (the dense
    path). The sequence output on the valid positions and every gradient
    must agree; the same step with no mask (planted: the padding
    attended) must miss a limit by 2x."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.text.models import bert

    cfg = model.config
    crit = bert.BertPretrainingCriterion()
    ids, labels, nsp = _bert_batch(cfg, BERT_BATCH, BERT_SEQ, 1)
    lens = bert_pad_lens(BERT_BATCH, BERT_SEQ)
    lens_t = torch.as_tensor(lens, device="cuda")
    keep = (torch.arange(BERT_SEQ, device="cuda")[None, :]
            < lens_t[:, None]).long()

    def loss_fn(m, a, mask, b, c):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            ml, nl = m(a, attention_mask=mask)
            return crit(ml, b, nl, c)

    dense = _bert_pad_run(model, w0, loss_fn, (ids, keep, labels, nsp))
    fa.reset_launches()
    got = _bert_pad_run(model, w0, loss_fn, (ids, lens_t, labels, nsp))
    torch.cuda.synchronize()
    launches = _flash_counts(fa, cfg.num_layers, "(c)")
    planted = _bert_pad_run(model, w0,
                            lambda m, a, b, c: loss_fn(m, a, None, b, c),
                            (ids, labels, nsp))
    seq = _pad_seq_diff(dense[0], got[0], lens)
    worst, where, median = _grad_diff(dense[1], got[1])
    p_seq = _pad_seq_diff(dense[0], planted[0], lens)
    p_worst, p_where, _ = _grad_diff(dense[1], planted[1])
    p_ratio = max(p_seq / BERT_PAD_SEQ_TOL, p_worst / BERT_PAD_GRAD_TOL)
    print(f"12 (c) padded bench_bert batch (lengths {int(lens.min())}-"
          f"{int(lens.max())}, mean {lens.mean():.1f}) ({card}): the kv_lens "
          f"route vs the keep-mask (dense) route, one O1 step each: "
          f"sequence output on the valid positions, worst row {seq:.3e} "
          f"(tol {BERT_PAD_SEQ_TOL:.0e}); gradients worst {worst:.3e} "
          f"({where}; tol {BERT_PAD_GRAD_TOL:.0e}), median {median:.3e}; "
          f"launches {launches}, all tensor-core, none causal; planted no "
          f"mask (padding attended): sequence {p_seq:.3e}, gradients worst "
          f"{p_worst:.3e} ({p_where}) -> {p_ratio:.1f}x its gate")
    if not (np.isfinite(seq) and seq <= BERT_PAD_SEQ_TOL
            and worst <= BERT_PAD_GRAD_TOL):
        raise AssertionError("12 (c): the kv_lens route disagrees with the "
                             "dense route")
    if p_ratio < 2.0:
        raise AssertionError(f"12 (c): the planted fault (padding attended) "
                             f"moved its measure only {p_ratio:.2f}x its "
                             "gate")
    return launches


def _tapi_cases():
    """(label, function name, inputs builder, kwargs): the tensor API on
    the card against the port's CPU result (12 d). The traps of the port:
    descending sorts with ties, top-k ties, repeated-index writes,
    unique's first occurrence, nonzero, mode; and a spread of the rest."""
    def ints(g, *shape, hi=5):
        return g.integers(0, hi, shape)

    def f32(g, *shape):
        return g.standard_normal(shape).astype(np.float32)

    def ties(g, *shape):
        return np.round(g.standard_normal(shape), 1).astype(np.float32)

    return [
        ("argsort descending ties", "argsort",
         lambda g: [ints(g, 64, 257)], dict(axis=1, descending=True)),
        ("argsort ascending ties", "argsort",
         lambda g: [ties(g, 300, 64)], dict(axis=0)),
        ("sort descending", "sort", lambda g: [ties(g, 64, 257)],
         dict(axis=1, descending=True)),
        ("topk ties largest", "topk", lambda g: [ties(g, 64, 500)],
         dict(k=17)),
        ("topk ties smallest", "topk", lambda g: [ties(g, 64, 500)],
         dict(k=17, largest=False)),
        ("unique return_index", "unique", lambda g: [ints(g, 20000, hi=300)],
         dict(return_index=True, return_inverse=True, return_counts=True)),
        ("unique rows", "unique", lambda g: [ints(g, 4000, 3, hi=4)],
         dict(axis=0, return_index=True, return_counts=True)),
        ("unique with NaNs", "unique",
         lambda g: [np.where(g.random(5000) < 0.1, np.nan,
                             ties(g, 5000)).astype(np.float32)],
         dict(return_index=True, return_inverse=True, return_counts=True)),
        ("scatter repeated rows", "scatter",
         lambda g: [f32(g, 300, 64), ints(g, 5000, hi=300), f32(g, 5000, 64)],
         {}),
        ("scatter overwrite=False", "scatter",
         lambda g: [f32(g, 300, 64), ints(g, 5000, hi=300), f32(g, 5000, 64)],
         dict(overwrite=False)),
        ("put_along_axis repeated", "put_along_axis",
         lambda g: [f32(g, 64, 100), ints(g, 64, 500, hi=100),
                    f32(g, 64, 500)], dict(axis=1)),
        ("put_along_axis add", "put_along_axis",
         lambda g: [f32(g, 64, 100), ints(g, 64, 500, hi=100),
                    f32(g, 64, 500)], dict(axis=1, reduce="add")),
        ("index_put repeated", "index_put",
         lambda g: [f32(g, 200, 8), (ints(g, 3000, hi=200),),
                    f32(g, 3000, 8)], {}),
        ("nonzero", "nonzero", lambda g: [ints(g, 100, 200, hi=3)], {}),
        ("mode", "mode", lambda g: [ints(g, 50, 301, hi=7)], dict(axis=1)),
        ("kthvalue ties", "kthvalue", lambda g: [ties(g, 40, 129)],
         dict(k=50, axis=1)),
        ("cummax ties", "cummax", lambda g: [ties(g, 16, 1000)],
         dict(axis=1)),
        ("searchsorted", "searchsorted",
         lambda g: [np.sort(ties(g, 1000)), ties(g, 4000)], dict(right=True)),
        ("gather_nd", "gather_nd",
         lambda g: [f32(g, 30, 40, 8), ints(g, 500, 2, hi=30)], {}),
        ("masked_select", "masked_select",
         lambda g: [f32(g, 300, 70), ints(g, 300, 70, hi=2).astype(bool)],
         {}),
        ("unique_consecutive", "unique_consecutive",
         lambda g: [ints(g, 5000, hi=3)],
         dict(return_inverse=True, return_counts=True)),
        ("one_hot", "one_hot", lambda g: [ints(g, 3000, hi=12)],
         dict(num_classes=10)),
        ("reshape 0 / -1", "reshape", lambda g: [f32(g, 6, 8, 10)],
         dict(shape=[0, -1, 5])),
        ("strided_slice negative", "strided_slice",
         lambda g: [f32(g, 50, 60)],
         dict(axes=[0, 1], starts=[49, 3], ends=[0, 60], strides=[-3, 4])),
        ("pad reflect", "pad", lambda g: [f32(g, 2, 3, 20, 30)],
         dict(pad=[3, 2, 4, 1], mode="reflect")),
        ("logsumexp", "logsumexp", lambda g: [f32(g, 64, 300)], dict(axis=1)),
        ("cumsum", "cumsum", lambda g: [f32(g, 64, 300)], dict(axis=1)),
        ("median even", "median", lambda g: [f32(g, 64, 300)], dict(axis=1)),
        ("where", "where",
         lambda g: [ints(g, 80, 90, hi=2).astype(bool), f32(g, 80, 90),
                    f32(g, 90)], {}),
        ("sum int32", "sum", lambda g: [ints(g, 70, 80, hi=9).astype(
            np.int32)], dict(axis=0)),
        ("mean", "mean", lambda g: [f32(g, 64, 300)], dict(axis=[0, 1])),
    ]


def _tapi_args(v, dev):
    if isinstance(v, np.ndarray):
        return torch.as_tensor(v, device=dev)
    if isinstance(v, tuple):
        return tuple(_tapi_args(x, dev) for x in v)
    return v


def _tapi_leaves(out):
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in _tapi_leaves(o)]
    return [out]


def tensor_api_on_card(card):
    """12 (d): each case of `_tapi_cases` on CUDA tensors against the
    port's CPU result: integer, bool and index outputs exact, float ones
    within TAPI_TOL; the dtypes and shapes equal."""
    from paddle_tpu_torch import ops

    exact = floats = 0
    worst = 0.0
    for i, (label, fn, build, kw) in enumerate(_tapi_cases()):
        inputs = build(np.random.default_rng(100 + i))
        got = getattr(ops, fn)(*(_tapi_args(v, "cuda") for v in inputs),
                               **kw)
        want = getattr(ops, fn)(*(_tapi_args(v, "cpu") for v in inputs), **kw)
        g_leaves, w_leaves = _tapi_leaves(got), _tapi_leaves(want)
        if len(g_leaves) != len(w_leaves):
            raise AssertionError(f"12 (d) {label}: {len(g_leaves)} outputs "
                                 f"vs {len(w_leaves)}")
        for g, w in zip(g_leaves, w_leaves):
            if g.device.type != "cuda":
                raise AssertionError(f"12 (d) {label}: output on {g.device}")
            g = g.cpu()
            if g.dtype != w.dtype or g.shape != w.shape:
                raise AssertionError(f"12 (d) {label}: {g.dtype} "
                                     f"{tuple(g.shape)} vs {w.dtype} "
                                     f"{tuple(w.shape)}")
            if w.is_floating_point():
                nan = torch.isnan(w)
                if not torch.equal(nan, torch.isnan(g)):
                    raise AssertionError(f"12 (d) {label}: NaNs differ")
                g, w = g[~nan], w[~nan]
                err = float((g - w).abs().max()) if w.numel() else 0.0
                rel = err / max(1.0, float(w.abs().max()) if w.numel()
                                else 1.0)
                worst = max(worst, rel)
                floats += 1
                if not rel <= TAPI_TOL:
                    raise AssertionError(f"12 (d) {label}: {rel:.3e} of "
                                         f"max(1, max-abs) > {TAPI_TOL:.0e}")
            else:
                exact += 1
                if not torch.equal(g, w):
                    raise AssertionError(f"12 (d) {label}: not equal to the "
                                         "CPU's")
    n = len(_tapi_cases())
    print(f"12 (d) the tensor API on the card vs the port's CPU ({card}): "
          f"{n} cases, {exact} integer / bool / index outputs equal, "
          f"{floats} float outputs within {worst:.3e} of max(1, max-abs) "
          f"(tol {TAPI_TOL:.0e})")
    return n


def bert_phase(fa, card):
    """12: (a) card vs CPU with its planted fault, (b) bench_bert, (c) the
    padded batch, (d) the tensor API on the card. Returns K3-K5's
    launches in (b) and (c) by kernel and run."""
    t0 = time.perf_counter()
    bert_cross(fa)
    model, w0, bench = bench_bert(fa, card)
    padded = bert_padded(fa, model, w0, card)
    del model, w0
    gc.collect()
    torch.cuda.empty_cache()
    tensor_api_on_card(card)
    print(f"bert phase (12): {time.perf_counter() - t0:.1f} s")
    return {name: {"bench_bert forward head":
                   bench["forward head"]["launches"][name],
                   "bench_bert fused head":
                   bench["fused head"]["launches"][name],
                   "padded kv_lens": padded[name]}
            for name in fa.REPLACES}


# ---- Transformer-base training, beam search and the RNNs (13) ----

# The model: `nn.Transformer()` at its defaults (Transformer-base, Vaswani
# et al. 2017, Table 3: d_model 512, 8 heads of 64, 6 + 6 layers, FFN
# 2048, ReLU, post-norm), dropout 0.1 with attn_dropout / act_dropout 0
# (§5.4); source and target embeddings over one 37,000-id vocabulary
# (§5.1) scaled by √512 plus sinusoidal positions (§3.5); the pre-softmax
# projection tied to the target embedding (§3.4); label smoothing 0.1
# through `F.label_smooth` and `cross_entropy(soft_label=True)`;
# Adam(0.9, 0.98, 1e-9) under NoamDecay(512, 4000) (§5.3). Ids from
# default_rng.
MT_VOCAB, MT_D, MT_HEADS, MT_FF = 37000, 512, 8, 2048
MT_START, MT_END = 1, 2
# (a): the widths at 2 + 2 layers, f32 with TF32 off, dropout 0,
# b2 · source 128 · target 128, one TrainStep, card (K3-K5 on the CUDA
# cores: f32) vs CPU (their plain versions); the loss relative, each
# gradient's max-abs difference over its max-abs. The planted fault: the
# decoder run without its tgt_mask.
MT_CROSS_LAYERS, MT_CROSS_BATCH, MT_CROSS_SEQ = 2, 2, 128
MT_CROSS_LOSS_TOL = 1e-5
MT_CROSS_GRAD_TOL = 1e-4
# (b): 6 + 6 layers, b32 · source 128 · target 128 (4096 tokens a side),
# bf16 O1, `jit.TrainStep`, 3 warm-up and 10 timed steps
MT_BATCH, MT_SEQ = 32, 128
MT_WARM, MT_STEPS = 3, 10
MT_O1_TOL = 1e-2         # step 0's O1 loss vs the f32 loss, relative
# (c): the (b) model after its steps, f32, b8 · source 128, beam 4, at
# most 32 new tokens; the gate: each cached step's logits against a
# no-cache decoder forward over the same prefixes, max-abs difference
# over the logits' max-abs
MT_BEAM_BATCH, MT_BEAM, MT_BEAM_STEPS = 8, 4, 32
MT_BEAM_TOL = 1e-4
# (d): a 2-layer bidirectional LSTM (input and hidden 512), a 1-layer GRU
# and SimpleRNN, b32 · t128, f32 with TF32 off: outputs, final states and
# gradients card vs CPU, and the fused route vs the plain loop on the
# card, each over its reference's max-abs
RNN_BATCH, RNN_T, RNN_WIDTH = 32, 128, 512
RNN_TOL = 1e-4


def _sinusoid(n, d, device):
    pos = torch.arange(n, dtype=torch.float64)[:, None]
    i = torch.arange(0, d, 2, dtype=torch.float64)
    ang = pos / torch.pow(10000.0, i / d)
    pe = torch.zeros(n, d, dtype=torch.float64)
    pe[:, 0::2], pe[:, 1::2] = torch.sin(ang), torch.cos(ang)
    return pe.float().to(device)


def mt_model(layers=6, dropout=0.1, seed=0, device="cuda"):
    """Transformer-base around `nn.Transformer`, built on the CPU from
    `seed` (the port's initializers draw there) and moved to `device`."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.nn import functional as F

    class MTModel(nn.Layer):
        def __init__(self):
            super().__init__()
            # N(0, d^-1/2): the tied projection then starts with unit-scale
            # logits
            emb = nn.ParamAttr(initializer=nn.initializer.Normal(
                0.0, MT_D ** -0.5))
            self.src_emb = nn.Embedding(MT_VOCAB, MT_D, weight_attr=emb)
            self.tgt_emb = nn.Embedding(MT_VOCAB, MT_D, weight_attr=emb)
            self.transformer = nn.Transformer(
                MT_D, MT_HEADS, layers, layers, MT_FF, dropout=dropout,
                attn_dropout=0.0, act_dropout=0.0)
            self.drop = nn.Dropout(dropout)
            self.register_buffer("pe", _sinusoid(1024, MT_D, "cpu"),
                                 persistable=False)

        def embed(self, emb, ids, offset=0):
            x = emb(ids) * math.sqrt(MT_D)
            return self.drop(x + self.pe[offset:offset + ids.shape[1]])

        def logits(self, h):
            return F.linear(h, self.tgt_emb.weight.T)

        def forward(self, src, tgt_in, tgt_mask=True):
            mask = (self.transformer.generate_square_subsequent_mask(
                tgt_in.shape[1]) if tgt_mask else None)
            h = self.transformer(self.embed(self.src_emb, src),
                                 self.embed(self.tgt_emb, tgt_in),
                                 tgt_mask=mask)
            return self.logits(h)

    rng.seed(seed)
    with rng.generator_scope(torch.Generator().manual_seed(seed)):
        model = MTModel()
    return model.to(device)


def mt_loss(model, src, tgt_in, labels, tgt_mask=True):
    """Label-smoothed (0.1) cross entropy over the tied logits."""
    from paddle_tpu_torch.nn import functional as F

    logits = model(src, tgt_in, tgt_mask)
    soft = F.label_smooth(F.one_hot(labels, MT_VOCAB), epsilon=0.1)
    return F.cross_entropy(logits, soft, soft_label=True)


def mt_o1_loss(model, src, tgt_in, labels):
    from paddle_tpu_torch import amp

    with amp.auto_cast(level="O1", dtype="bfloat16"):
        return mt_loss(model, src, tgt_in, labels)


def mt_batch(b, s, seed, device):
    """(source, target input, target labels): ids in [3, vocab), the
    target input the labels shifted right after the start token."""
    g = np.random.default_rng(seed)
    src = g.integers(3, MT_VOCAB, (b, s))
    tgt = g.integers(3, MT_VOCAB, (b, s))
    tin = np.concatenate([np.full((b, 1), MT_START), tgt[:, :-1]], 1)
    return tuple(torch.as_tensor(a, device=device) for a in (src, tin, tgt))


def mt_flops(b, s, layers=6):
    """6 x the matrix parameters a token (the tied projection counted),
    plus the 3 x layers attention products: 4·b·s²·d forward, x3 with
    the backward."""
    enc = layers * (4 * MT_D * MT_D + 2 * MT_D * MT_FF)
    dec = layers * (8 * MT_D * MT_D + 2 * MT_D * MT_FF)
    return (6 * b * s * (enc + dec + MT_VOCAB * MT_D)
            + 3 * layers * 12 * b * s * s * MT_D)


def _mt_optimizer(model):
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.optimizer.lr import NoamDecay

    sched = NoamDecay(d_model=MT_D, warmup_steps=4000)
    return Adam(sched, beta1=0.9, beta2=0.98, epsilon=1e-9,
                parameters=model.parameters()), sched


def _mt_grads(model, batch, tgt_mask=True):
    """(loss, {name: gradient on the host}) of one f32 TrainStep."""
    from paddle_tpu_torch.jit import TrainStep

    opt, _ = _mt_optimizer(model)
    step = TrainStep(model, lambda m, a, b, c: mt_loss(m, a, b, c,
                                                       tgt_mask), opt)
    loss = float(step(*batch))
    return loss, {n: p.grad.float().cpu() for n, p in model.named_parameters()}


def mt_cross(fa):
    """13 (a): one f32 TrainStep of Transformer-base's widths at 2 + 2
    layers on the card and on the CPU from the same weights, and the
    planted card step (the decoder without its tgt_mask)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = mt_model(MT_CROSS_LAYERS, dropout=0.0, seed=21)
    w0 = {k: v.detach().clone() for k, v in gpu.state_dict().items()}
    cpu = mt_model(MT_CROSS_LAYERS, dropout=0.0, seed=21, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in w0.items()})
    batch = mt_batch(MT_CROSS_BATCH, MT_CROSS_SEQ, 21, "cuda")
    fa.reset_launches()
    lg, gg = _mt_grads(gpu, batch)
    launches = dict(fa.launches)
    lc, gc = _mt_grads(cpu, tuple(t.cpu() for t in batch))
    gpu.load_state_dict(w0)
    lp, gp = _mt_grads(gpu, batch, tgt_mask=False)
    loss_rel = abs(lg - lc) / abs(lc)
    # the key projections' biases take a gradient of exactly 0 (softmax is
    # shift-invariant per row): both sides hold rounding noise there
    gc = {n: g for n, g in gc.items() if not n.endswith("k_proj.bias")}
    worst, where, median = _grad_diff(gc, gg)
    p_worst, p_where, _ = _grad_diff(gc, gp)
    p_loss = abs(lp - lc) / abs(lc)
    p_ratio = max(p_loss / MT_CROSS_LOSS_TOL, p_worst / MT_CROSS_GRAD_TOL)
    print(f"13 (a) Transformer-base widths x {MT_CROSS_LAYERS} + "
          f"{MT_CROSS_LAYERS} layers f32 (TF32 off) b{MT_CROSS_BATCH} · "
          f"source {MT_CROSS_SEQ} · target {MT_CROSS_SEQ}, one TrainStep, "
          f"card vs CPU: loss {lg:.6f} vs {lc:.6f} (relative {loss_rel:.3e}; "
          f"tol {MT_CROSS_LOSS_TOL:.0e}), gradients: worst {worst:.3e} of "
          f"its max-abs ({where}; tol {MT_CROSS_GRAD_TOL:.0e}), median "
          f"{median:.3e} over {len(gc)} parameters (the k_proj biases, 0 in "
          f"exact arithmetic, left out); card launches "
          f"{launches}; planted (no tgt_mask): loss {p_loss:.3e}, gradients "
          f"worst {p_worst:.3e} ({p_where}) -> {p_ratio:.1f}x its gate")
    want = 2 * MT_CROSS_LAYERS      # encoder self + equal-length cross
    if launches != dict.fromkeys(fa.REPLACES, want):
        raise AssertionError(f"13 (a): card launches {launches}, expected "
                             f"{want} each")
    if not (loss_rel <= MT_CROSS_LOSS_TOL and worst <= MT_CROSS_GRAD_TOL):
        raise AssertionError("13 (a): the card's Transformer step disagrees "
                             "with the CPU's")
    if p_ratio < 2.0:
        raise AssertionError(f"13 (a): the planted fault moved its measure "
                             f"only {p_ratio:.2f}x its gate")
    del gpu, cpu
    return {"loss_rel": loss_rel, "worst": worst, "planted": p_ratio}


def mt_bench(fa, card):
    """13 (b): Transformer-base whole, bf16 O1, `TrainStep`, the Noam
    schedule stepped after each step; K3-K5 counted from zero over the
    13 steps. Returns (the model after its steps, K3-K5's launches)."""
    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.profile_train import H100_PEAK_BF16

    model = mt_model(seed=0)
    batch = mt_batch(MT_BATCH, MT_SEQ, 0, "cuda")
    # the f32 loss at the first weights, under the dropout masks the
    # first TrainStep draws (the same generator: seed, then the same
    # call index)
    rng.seed(7)
    with torch.no_grad(), rng.generator_scope(rng.next_generator("cuda")):
        f32_loss = float(mt_loss(model, *batch))
    opt, sched = _mt_optimizer(model)
    step = TrainStep(model, mt_o1_loss, opt)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rng.seed(7)
    fa.reset_launches()
    losses = []
    for i in range(MT_WARM + MT_STEPS):
        if i == MT_WARM:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(step(*batch))
        sched.step()
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / MT_STEPS
    launches = (dict(fa.launches), dict(fa.tc_launches),
                dict(fa.causal_launches))
    prof_line = _mt_profile(step, sched, batch)
    losses = [float(x) for x in losses]
    flops = mt_flops(MT_BATCH, MT_SEQ)
    mfu = flops / dt / H100_PEAK_BF16
    peak = torch.cuda.max_memory_allocated() / 2**30
    o1_rel = abs(losses[0] - f32_loss) / abs(f32_loss)
    tokens = MT_BATCH * MT_SEQ
    print(f"13 (b) Transformer-base (6 + 6 layers, d {MT_D}, {MT_HEADS} "
          f"heads, FFN {MT_FF}, vocab {MT_VOCAB}) b{MT_BATCH} · source "
          f"{MT_SEQ} · target {MT_SEQ} bf16 O1 Adam(0.9, 0.98, 1e-9) + "
          f"NoamDecay(512, 4000) TrainStep ({card}): {dt * 1e3:.3f} ms/step, "
          f"{tokens / dt:.1f} target tokens/s, MFU {mfu:.4f} "
          f"({flops / 1e12:.4f} TFLOP a step at 989 TFLOP/s), peak memory "
          f"{peak:.2f} GiB; step 0's O1 loss {losses[0]:.6f} vs f32 "
          f"{f32_loss:.6f} (relative {o1_rel:.3e}; tol {MT_O1_TOL:.0e}); "
          f"losses {losses[0]:.4f} -> {losses[-1]:.4f} over {len(losses)} "
          f"steps (lr {opt.get_lr():.3e} at the last: the warm-up); "
          f"launches {launches[0]}, tensor-core {launches[1]}, causal "
          f"{launches[2]}")
    print(prof_line)
    want = 2 * 6 * (MT_WARM + MT_STEPS)
    if (launches[0] != dict.fromkeys(fa.REPLACES, want)
            or launches[1] != launches[0] or any(launches[2].values())):
        raise AssertionError(f"13 (b): launches {launches}; expected {want} "
                             "each, all tensor-core, none causal")
    if not (all(np.isfinite(losses)) and o1_rel <= MT_O1_TOL):
        raise AssertionError(f"13 (b): losses {losses}, f32 {f32_loss}")
    return model, launches[0], dict(ms=dt * 1e3, tokens_per_s=tokens / dt,
                                    mfu=mfu, peak_gib=peak)


def _mt_profile(step, sched, batch):
    """One more step of 13 (b) under torch.profiler: its wall and device
    time, the idle share, the kernels it launched, the optimizer
    update's device share and the device time by category
    (profile_train's)."""
    from paddle_tpu_torch import profile_train as pt

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(*batch)
        sched.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = pt.kernel_rows(prof)
    dev = pt.device_us(prof)
    if not dev:
        return "13 (b) profiled step: the profiler recorded no device time"
    cats = {}
    for e in rows:
        cat = next((c for c, keys in pt.CATEGORIES
                    if any(k in e.key for k in keys)), "other")
        cats[cat] = cats.get(cat, 0) + e.self_device_time_total
    opt = pt.optimizer_device_us(prof)
    return (f"13 (b) one profiled step: {wall * 1e3:.3f} ms wall, device "
            f"{dev / 1e3:.3f} ms, idle {100 * (1 - dev / 1e6 / wall):.1f} %, "
            f"{sum(e.count for e in rows)} kernel launches; the optimizer "
            f"update {opt / 1e3:.3f} ms ({100 * opt / dev:.1f} %); by "
            f"category: " + ", ".join(
                f"{c} {us / 1e3:.3f} ms" for c, us in
                sorted(cats.items(), key=lambda kv: -kv[1])))


def _mt_decode(model, src, check=False, fault=False):
    """Beam search with the caches: `BeamSearchDecoder` + `dynamic_decode`
    over a cell that carries `TransformerDecoder.gen_cache(memory)`'s
    incremental caches and the prefix; the static caches and the memory
    tiled by `tile_beam_merge_with_batch`. With `check`, each step's
    cached logits against a no-cache decoder forward over the same
    prefixes (returns the worst max-abs difference over the logits'
    max-abs); `fault` drops every append to the caches after the
    first step's."""
    from paddle_tpu_torch import nn

    tile = nn.BeamSearchDecoder.tile_beam_merge_with_batch
    dec = model.transformer.decoder
    mem = model.transformer.encoder(model.embed(model.src_emb, src))
    caches = dec.gen_cache(mem)
    static = [nn.MultiHeadAttention.StaticCache(tile(s.k, MT_BEAM),
                                                tile(s.v, MT_BEAM))
              for _, s in caches]
    mem_t = tile(mem, MT_BEAM)
    worst = [0.0]

    def cell(ids, state):
        incr, prefix = state
        t = prefix.shape[1]
        x = model.embed(model.tgt_emb, ids[:, None], offset=t)
        h, new = dec(x, mem_t, cache=[(c, s) for c, s in
                                      zip(incr, static)])
        logits = model.logits(h[:, 0])
        prefix = torch.cat([prefix, ids[:, None]], 1)
        if check:
            full = dec(model.embed(model.tgt_emb, prefix), mem_t,
                       tgt_mask=model.transformer
                       .generate_square_subsequent_mask(t + 1))
            ref = model.logits(full[:, -1])
            worst[0] = max(worst[0], float((logits - ref).abs().max()
                                           / ref.abs().max()))
        nxt = incr if fault and t else [c for c, _ in new]
        return logits, (nxt, prefix)

    bsd = nn.BeamSearchDecoder(cell, MT_START, MT_END, MT_BEAM)
    empty = torch.zeros((src.shape[0], 0), dtype=torch.int64,
                        device=src.device)
    ids, _, lens = nn.dynamic_decode(
        bsd, inits=([c for c, _ in caches], empty),
        max_step_num=MT_BEAM_STEPS, return_length=True)
    return ids, lens, worst[0]


def mt_beam(model, card):
    """13 (c): the (b) model, f32, eval: a timed beam search, the gated
    one, the planted one (caches not appended after the first step: from
    the third position on each step attends a stale prefix), and the same
    search on
    the CPU from the same weights (for information)."""
    model.eval()
    torch.backends.cuda.matmul.allow_tf32 = False
    src = mt_batch(MT_BEAM_BATCH, MT_SEQ, 3, "cuda")[0]
    with torch.no_grad():
        _mt_decode(model, src[:1])                       # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, lens, _ = _mt_decode(model, src)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        _, _, worst = _mt_decode(model, src, check=True)
        _, _, planted = _mt_decode(model, src, check=True, fault=True)
        cids, _, _ = _mt_decode(copy.deepcopy(model).cpu(), src.cpu())
    steps = ids.shape[1]
    same = int(sum(torch.equal(a, b) for a, b in zip(ids.cpu()[:, :, 0],
                                                     cids[:, :, 0])))
    new_tokens = MT_BEAM_BATCH * steps
    print(f"13 (c) beam search, Transformer-base after 13 (b), f32, "
          f"b{MT_BEAM_BATCH} · source {MT_SEQ}, beam {MT_BEAM}, "
          f"{steps} steps ({card}): {dt * 1e3:.1f} ms, "
          f"{new_tokens / dt:.1f} tokens/s ({new_tokens} best-beam tokens), "
          f"{MT_BEAM_BATCH * MT_BEAM * steps / dt:.1f} beam tokens/s; the "
          f"cached step vs a no-cache forward over the same prefixes: "
          f"worst {worst:.3e} of the logits' max-abs (tol "
          f"{MT_BEAM_TOL:.0e}); planted (cache not appended): {planted:.3e}"
          f" -> {planted / MT_BEAM_TOL:.1f}x its gate; best beams equal to "
          f"the CPU's decode from the same weights: {same} of "
          f"{MT_BEAM_BATCH} (information only)")
    if not worst <= MT_BEAM_TOL:
        raise AssertionError("13 (c): the cached decode disagrees with the "
                             "no-cache forward")
    if planted < 2 * MT_BEAM_TOL:
        raise AssertionError(f"13 (c): the planted fault moved its measure "
                             f"only {planted / MT_BEAM_TOL:.2f}x its gate")
    return dict(ms=dt * 1e3, tokens_per_s=new_tokens / dt, worst=worst,
                planted=planted, same=same)


def _flat_rnn(res):
    """An RNN's (outputs, final states) as a list of tensors."""
    out, st = res
    return [out] + (list(st) if isinstance(st, tuple) else [st])


def _rnn_run(net, x, probes, loop=False):
    """Σ (outputs and final states) · probes, backward, on the net's own
    route or (`loop`) its plain time loop: (every leaf as f32 on the
    host, {name: gradient}, input gradient, ms)."""
    x = x.detach().clone().requires_grad_()
    net.zero_grad()
    t0 = time.perf_counter()
    leaves = _flat_rnn(net._apply_route(net._loop, x) if loop else net(x))
    sum((a * p).sum() for a, p in zip(leaves, probes)).backward()
    if x.is_cuda:
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return ([a.detach().float().cpu() for a in leaves],
            {n: p.grad.float().cpu() for n, p in net.named_parameters()},
            x.grad.float().cpu(), ms)


def _rnn_gap(ref, got):
    (rl, rg, rx, _), (gl, gg, gx, _) = ref, got
    errs = [((a - b).abs().max() / b.abs().max()).item()
            for a, b in zip(gl, rl)]
    errs += [((gg[n] - r).abs().max() / r.abs().max().clamp(min=1e-30)
              ).item() for n, r in rg.items()]
    errs.append(((gx - rx).abs().max() / rx.abs().max()).item())
    return max(errs)


def rnn_phase(card):
    """13 (d): the RNNs card vs CPU and, on the card, the fused route vs
    the plain loop; ms for forward + backward (the second of two runs)."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.core import rng

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for label, build in (
            ("LSTM 2-layer bidirect", lambda: nn.LSTM(
                RNN_WIDTH, RNN_WIDTH, num_layers=2, direction="bidirect")),
            ("GRU", lambda: nn.GRU(RNN_WIDTH, RNN_WIDTH)),
            ("SimpleRNN", lambda: nn.SimpleRNN(RNN_WIDTH, RNN_WIDTH))):
        rng.seed(31)
        cpu = build()
        gpu = build().to("cuda")
        gpu.load_state_dict(cpu.state_dict())
        g = torch.Generator().manual_seed(31)
        x = torch.randn(RNN_BATCH, RNN_T, RNN_WIDTH, generator=g)
        with torch.no_grad():
            shapes = [o.shape for o in _flat_rnn(cpu(x[:, :2]))]
        shapes[0] = (RNN_BATCH, RNN_T) + tuple(shapes[0][2:])
        probes = [torch.randn(s, generator=g) for s in shapes]
        ref = _rnn_run(cpu, x, probes)
        xg, pg = x.cuda(), [p.cuda() for p in probes]
        fused = [_rnn_run(gpu, xg, pg) for _ in range(2)][-1]
        plain = [_rnn_run(gpu, xg, pg, loop=True) for _ in range(2)][-1]
        vs_cpu = max(_rnn_gap(ref, fused), _rnn_gap(ref, plain))
        vs_plain = _rnn_gap(plain, fused)
        print(f"13 (d) {label} {RNN_WIDTH} b{RNN_BATCH} · t{RNN_T} f32 (TF32 "
              f"off) ({card}): card vs CPU worst {vs_cpu:.3e} of max-abs "
              f"over the outputs, final states and gradients (tol "
              f"{RNN_TOL:.0e}); fused route vs the plain loop on the card "
              f"{vs_plain:.3e}; forward + backward {fused[3]:.2f} ms fused, "
              f"{plain[3]:.2f} ms plain loop, {ref[3]:.1f} ms on the CPU")
        if not (vs_cpu <= RNN_TOL and vs_plain <= RNN_TOL):
            raise AssertionError(f"13 (d) {label}: the card disagrees")
        out[label] = dict(fused_ms=fused[3], plain_ms=plain[3],
                          vs_cpu=vs_cpu, vs_plain=vs_plain)
    return out


def mt_phase(fa, card):
    """13: (a) card vs CPU with its planted fault, (b) Transformer-base,
    (c) the cached beam search, (d) the RNNs. Returns K3-K5's launches in
    (b) by kernel."""
    t0 = time.perf_counter()
    mt_cross(fa)
    model, launches, _ = mt_bench(fa, card)
    mt_beam(model, card)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    rnn_phase(card)
    print(f"transformer phase (13): {time.perf_counter() - t0:.1f} s")
    return launches


# ---- the high-level vision training path (14) ----
#
# A paddle user's image-classification loop: `paddle.Model(net).prepare(
# opt, loss, Accuracy()).fit(DatasetFolder(..., transform), eval_data,
# batch_size, num_workers=4)` — the port's DataLoader with its worker
# processes, the vision transforms and datasets, hapi and the profiler's
# ips meter over `jit.TrainStep`. No Pallas kernel is on this path
# (convolutions are cuDNN's), so it adds no row to the kernels line.

# 14 (a): (constructor, its arguments, image side, classes); VGG without
# its classifier, as in tests/test_torch_vision_zoo.py (at 64 px its
# first linear layer alone holds 102.8 M weights: seconds of CPU steps
# and a gigabyte of gradients to carry back), read out by a fixed
# random projection
ZOO_CASES = [
    ("mobilenet_v1", dict(scale=0.25), 64, 10),
    ("mobilenet_v2", dict(scale=0.5), 64, 10),
    ("mobilenet_v3_small", dict(scale=0.5), 64, 10),
    ("mobilenet_v3_large", dict(scale=0.5), 64, 10),
    ("vgg11", dict(batch_norm=True), 64, 0),
    ("alexnet", {}, 96, 10),
    ("squeezenet1_0", {}, 64, 10),
    ("squeezenet1_1", {}, 64, 10),
    ("densenet121", {}, 64, 10),
    ("googlenet", {}, 64, 10),
    ("inception_v3", {}, 96, 10),
    ("shufflenet_v2_x0_25", {}, 64, 10),
    ("ShuffleNetV2", dict(scale=0.25, act="swish"), 64, 10),
]
ZOO_BATCH = 2
# Gate 1, eval mode (batch norm on its running statistics, every other
# layer as in training): the card's f32 step (TF32 off) against the
# CPU's, the loss (relative) and each gradient (its max-abs difference
# over its max-abs) within ZOO_EVAL_TOL. Gate 2, train mode (batch
# statistics): the loss within ZOO_EVAL_TOL and the gradients, all
# together, within ZOO_TRAIN_TOL of their norm. At random init a
# train-mode network with batch norm is chaotic to a degree: the
# rounding of one summation order grows layer by layer. The families of
# ZOO_EVAL_ONLY are chaotic at these sizes (Inception-v3's last maps
# are 1×1, so its last batch norm sees 2 values a channel and passes no
# gradient but rounding): gate 1 alone holds them. A planted fault must
# pass ZOO_FAULT_MARGIN x the gate it is planted under. The CPU's steps
# run in ZOO_CPU_PROCS processes forked from the DataLoader's
# forkserver, while the card steps
ZOO_EVAL_TOL, ZOO_TRAIN_TOL, ZOO_FAULT_MARGIN = 1e-4, 1e-3, 2.0
ZOO_EVAL_ONLY = ("mobilenet_v2", "densenet121", "inception_v3")
ZOO_CPU_PROCS, ZOO_CPU_THREADS = 4, 2
# 14 (b): the folder and the transforms
FOLDER_CLASSES, FOLDER_TRAIN, FOLDER_EVAL = 16, 1024, 256
FOLDER_SIDES = (256, 384)
IMAGENET_MEAN = [123.675, 116.28, 103.53]
IMAGENET_STD = [58.395, 57.12, 57.375]
# 14 (c): hapi fit
FIT_BATCH, FIT_WORKERS, FIT_LR = 64, 4, 0.1
# the weights after fit, card vs CPU over the eval set: the loss within
# FIT_EVAL_RTOL (relative) and the logits within FIT_LOGITS_TOL of their
# max-abs; the card's eval with TF32 allowed must miss a gate by
# ZOO_FAULT_MARGIN. Then one `fit` step of FIT_STEP_BATCH eval images
# from those weights, card vs CPU: the loss within FIT_STEP_LOSS_TOL and
# the update (the parameters' change) within FIT_STEP_TOL of its norm;
# the card's step over labels shifted by one image (a wrong batch
# pairing) must miss a gate by ZOO_FAULT_MARGIN.
FIT_EVAL_RTOL, FIT_LOGITS_TOL = 1e-6, 1e-5
FIT_STEP_BATCH, FIT_STEP_LOSS_TOL, FIT_STEP_TOL = 16, 1e-5, 5e-2
# the CPU's side: FIT_CPU_PROCS one-thread processes, the eval set in
# chunks of FIT_CPU_CHUNK images
FIT_CPU_PROCS, FIT_CPU_CHUNK = 6, 32
# float32 outside the tensor cores, the H100 SXM data sheet
H100_PEAK_F32 = 67e12
FIT_DEVICE_WARM, FIT_DEVICE_STEPS = 2, 10


def _zoo_model(name, kw, classes, device="cpu"):
    from paddle_tpu_torch.vision import models

    m = getattr(models, name)(num_classes=classes, device=device, seed=0,
                              **kw)
    for sub in m.modules():
        if type(sub).__name__ == "Dropout":
            sub.p = 0.0
    return m


def _zoo_batch(size, classes):
    """(x, y), y None for a model without a classifier."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (ZOO_BATCH, 3, size, size)).astype(np.float32))
    if not classes:
        return x, None
    return x, torch.from_numpy(rng.integers(0, classes, (ZOO_BATCH,)))


def _zoo_step(model, x, y):
    """One forward + backward: (loss, {name: f64 CPU grad}); the loss is
    the cross entropy of each output, or without a classifier (`y` None)
    the outputs read out by a fixed random projection."""
    from paddle_tpu_torch.nn import functional as F

    for p in model.parameters():
        p.grad = None
    out = model(x)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    if y is None:
        probe = [torch.from_numpy(np.random.default_rng(1).standard_normal(
            tuple(o.shape))).to(o) for o in outs]
        loss = sum((o * p).sum() for o, p in zip(outs, probe))
    else:
        loss = sum(F.cross_entropy(o, y) for o in outs)
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().double().cpu()
                                  for n, p in model.named_parameters()}


def _zoo_errs(ref, other):
    """(worst, its name) of each gradient's max-abs difference over
    max(its max-abs, 1e-3 of the largest): the biases of a batch norm a
    later train-mode batch norm follows get analytically zero
    gradients, rounding alone."""
    floor = 1e-3 * max(float(r.abs().max()) for r in ref.values())
    errs = {n: float((other[n] - r).abs().max()) / max(
        float(r.abs().max()), floor, 1e-30) for n, r in ref.items()}
    where = max(errs, key=errs.get)
    return errs[where], where


def _zoo_norm_err(ref, other):
    """The gradients' difference over their norm, all tensors as one."""
    num = sum(float(((other[n] - r) ** 2).sum()) for n, r in ref.items())
    return (num / sum(float((r ** 2).sum()) for r in ref.values())) ** 0.5


def _zoo_cpu(case):
    """The CPU's side of 14 (a) for one family (in a worker process): the
    f32 train-mode step (none for ZOO_EVAL_ONLY) and the f32 eval-mode
    step; the gradients go back as f32 arrays."""
    name, kw, size, classes = case
    torch.set_num_threads(ZOO_CPU_THREADS)
    t0 = time.perf_counter()
    cpu = _zoo_model(name, kw, classes)
    x, y = _zoo_batch(size, classes)
    f32 = lambda lg: (lg[0], {k: v.float().numpy()  # noqa: E731
                              for k, v in lg[1].items()})
    # the train step on a copy: it moves the running statistics the
    # eval step reads
    train = (None if name in ZOO_EVAL_ONLY
             else f32(_zoo_step(copy.deepcopy(cpu), x, y)))
    cpu.eval()
    return dict(train=train, eval=f32(_zoo_step(cpu, x, y)),
                seconds=time.perf_counter() - t0)


@contextlib.contextmanager
def _zoo_fault(name):
    """Plant a fault in the port's class for the block (none for None)."""
    from paddle_tpu_torch.nn.layer import common
    from paddle_tpu_torch.vision.models import mobilenet

    if name is None:
        yield
        return
    if name == "no residual":
        cls, attr = mobilenet.InvertedResidual, "forward"
        new = lambda self, x: self.conv(x)  # noqa: E731
    else:
        cls, attr = common.ChannelShuffle, "forward"
        new = lambda self, x: x  # noqa: E731
    old = getattr(cls, attr)
    setattr(cls, attr, new)
    try:
        yield
    finally:
        setattr(cls, attr, old)


def zoo_cross(card, device="cuda"):
    """14 (a): each zoo family, the card's steps against the CPU's (gates
    1 and 2 above); the CPU's steps in worker processes meanwhile."""
    import concurrent.futures as cf
    import multiprocessing

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    lines, bad, faults = [], [], {}
    plants = {"mobilenet_v2": "no residual",
              "shufflenet_v2_x0_25": "no shuffle"}
    pool = cf.ProcessPoolExecutor(
        ZOO_CPU_PROCS, mp_context=multiprocessing.get_context("forkserver"))
    # the CPU's costliest families first (VGG's 103 M-weight linear,
    # AlexNet's, DenseNet's and Inception's depth)
    order = sorted(ZOO_CASES, key=lambda c: c[0] not in (
        "vgg11", "alexnet", "densenet121", "inception_v3"))
    card_s = wait_s = 0.0
    try:
        futs = [pool.submit(_zoo_cpu, case) for case in order]
        for case, fut in zip(order, futs):
            name, kw, size, classes = case
            t1 = time.perf_counter()
            base = _zoo_model(name, kw, classes)
            x, y = _zoo_batch(size, classes)
            xg, yg = x.to(device), None if y is None else y.to(device)

            def card_step(eval_mode=False, fault=None):
                m = copy.deepcopy(base).to(device)
                if eval_mode:
                    m.eval()
                with _zoo_fault(fault):
                    return _zoo_step(m, xg, yg)

            train = name not in ZOO_EVAL_ONLY
            lg, gg = card_step() if train else (None, None)
            le, ge = card_step(eval_mode=True)
            fault = (card_step(eval_mode=True, fault=plants[name])
                     if name in plants else None)
            t_fault = (card_step(fault=plants[name])
                       if train and name in plants else None)
            del base
            t2 = time.perf_counter()
            ref = fut.result()
            card_s += t2 - t1
            wait_s += time.perf_counter() - t2
            as64 = lambda g: {k: torch.from_numpy(v).double()  # noqa: E731
                              for k, v in g.items()}
            lce, gce = ref["eval"][0], as64(ref["eval"][1])
            # gate 1: eval mode
            e_loss = abs(le - lce) / abs(lce)
            e_worst, e_where = _zoo_errs(gce, ge)
            ok = e_loss <= ZOO_EVAL_TOL and e_worst <= ZOO_EVAL_TOL
            line = (f"{name}{kw or ''} {size}px: eval loss {e_loss:.1e}, "
                    f"worst gradient {e_worst:.1e} ({e_where})")
            if fault is not None:
                lf, gf = fault
                faults[f"{plants[name]}, eval"] = max(
                    abs(lf - lce) / abs(lce), _zoo_errs(gce, gf)[0]
                ) / ZOO_EVAL_TOL
            # gate 2: train mode
            if train:
                lc, gc_ = ref["train"][0], as64(ref["train"][1])
                t_loss = abs(lg - lc) / abs(lc)
                t_norm = _zoo_norm_err(gc_, gg)
                ok = ok and t_loss <= ZOO_EVAL_TOL and t_norm <= ZOO_TRAIN_TOL
                line += (f"; train loss {t_loss:.1e}, gradients "
                         f"{t_norm:.1e} of their norm (worst tensor "
                         f"{_zoo_errs(gc_, gg)[0]:.1e})")
                if t_fault is not None:
                    lf, gf = t_fault
                    faults[f"{plants[name]}, train"] = max(
                        abs(lf - lc) / abs(lc) / ZOO_EVAL_TOL,
                        _zoo_norm_err(gc_, gf) / ZOO_TRAIN_TOL)
            if not ok:
                bad.append(name)
            lines.append(f"{line} over {len(ge)}; CPU "
                         f"{ref['seconds']:.1f} s")
    finally:
        pool.shutdown(cancel_futures=True)
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    print(f"14 (a) the zoo, b{ZOO_BATCH}, f32 with TF32 off ({card}): gate "
          f"1, eval mode, card vs CPU within {ZOO_EVAL_TOL:g}; gate 2, train "
          f"mode, the loss within {ZOO_EVAL_TOL:g} and the gradients within "
          f"{ZOO_TRAIN_TOL:g} of their norm (not for "
          f"{', '.join(ZOO_EVAL_ONLY)}): " + "; ".join(lines)
          + "; planted, the gate's worst measure over its tolerance: "
          + ", ".join(f"{k} {v:.3g}x" for k, v in faults.items())
          + f"; {seconds:.1f} s ({card_s:.1f} s building and stepping on "
          f"the card, {wait_s:.1f} s waiting for the CPU's steps)")
    if bad:
        raise AssertionError(f"14 (a): card and CPU disagree for {bad}")
    if not all(v > ZOO_FAULT_MARGIN for v in faults.values()):
        raise AssertionError(f"14 (a): a planted fault passed: {faults}")


def write_image_folder(root, seed=0):
    """An ImageNet-style tree under root/{train,eval}/<class>/<i>.npy:
    FOLDER_CLASSES classes, uint8 HWC images, sides in FOLDER_SIDES."""
    rng = np.random.default_rng(seed)
    lo, hi = FOLDER_SIDES
    nbytes = 0
    for split, n in (("train", FOLDER_TRAIN), ("eval", FOLDER_EVAL)):
        for i in range(n):
            d = os.path.join(root, split, f"n{i % FOLDER_CLASSES:02d}")
            os.makedirs(d, exist_ok=True)
            h, w = (int(v) for v in rng.integers(lo, hi + 1, 2))
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            np.save(os.path.join(d, f"{i:05d}.npy"), img)
            nbytes += img.nbytes
    return nbytes


def folder_datasets(root):
    from paddle_tpu_torch.vision import datasets, transforms as T

    norm = T.Normalize(IMAGENET_MEAN, IMAGENET_STD, data_format="HWC")
    train_tf = T.Compose([T.RandomResizedCrop(224),
                          T.RandomHorizontalFlip(), norm, T.Transpose()])
    eval_tf = T.Compose([T.Resize(256), T.CenterCrop(224), norm,
                         T.Transpose()])
    kw = dict(loader=np.load, extensions=(".npy",))
    return (datasets.DatasetFolder(os.path.join(root, "train"),
                                   transform=train_tf, **kw),
            datasets.DatasetFolder(os.path.join(root, "eval"),
                                   transform=eval_tf, **kw))


def _loader_pass(ds, workers):
    from paddle_tpu_torch.io import DataLoader

    t0 = time.perf_counter()
    out = [tuple(t.numpy() for t in b) for b in DataLoader(
        ds, batch_size=FIT_BATCH, num_workers=workers, timeout=300)]
    return out, time.perf_counter() - t0


def input_pipeline(card, root):
    """14 (b): the folder, the loaders at 0 and 4 workers, the gate."""
    t0 = time.perf_counter()
    nbytes = write_image_folder(root)
    write_s = time.perf_counter() - t0
    train_ds, eval_ds = folder_datasets(root)
    ref, s0 = _loader_pass(eval_ds, 0)
    got, s4 = _loader_pass(eval_ds, FIT_WORKERS)
    same = len(got) == len(ref) and all(
        a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
        for gb, rb in zip(got, ref) for a, b in zip(gb, rb))
    n = len(eval_ds)
    print(f"14 (b) input pipeline ({card}): wrote {len(train_ds)} + {n} "
          f"images ({nbytes / 2**20:.1f} MiB, {FOLDER_CLASSES} classes, "
          f"sides {FOLDER_SIDES}) in {write_s:.2f} s; the eval loader "
          f"(Resize(256), CenterCrop(224), Normalize, Transpose; batch "
          f"{FIT_BATCH}): {n / s0:.1f} images/s at 0 workers, "
          f"{n / s4:.1f} at {FIT_WORKERS} (the pool's start and drain "
          f"included: one batch a worker); {len(got)} batches at "
          f"{FIT_WORKERS} workers byte-equal to 0 workers' in order: "
          f"{same}")
    if not same:
        raise AssertionError("14 (b): the batches of 4 workers are not "
                             "those of 0 workers")
    return train_ds, eval_ds, ref


def _near_tie_flips(card_logits, cpu_logits, labels, k):
    """Samples whose top-k verdict differs card vs CPU, and how many of
    them are near-ties: the label's logit within twice the row's
    card-vs-CPU difference of the k-th largest."""
    from paddle_tpu_torch.metric import Accuracy

    acc = Accuracy(topk=(k,))
    a = acc.compute(card_logits, labels).numpy()[:, :k].any(-1)
    b = acc.compute(cpu_logits, labels).numpy()[:, :k].any(-1)
    flips = np.nonzero(a != b)[0]
    ties = 0
    for i in flips:
        row = cpu_logits[i]
        kth = np.sort(row)[::-1][k - 1: k + 1]
        diff = np.abs(card_logits[i] - row).max()
        lab = row[int(labels[i])]
        if min(abs(lab - kth[0]), abs(lab - kth[1])) <= 2 * diff:
            ties += 1
    return len(flips), ties


def _sync_dev(device):
    if device == "cuda":
        torch.cuda.synchronize()


def _loss_log():
    """A hapi callback that keeps each training step's loss (`losses`)."""
    from paddle_tpu_torch import hapi

    class LossLog(hapi.Callback):
        def __init__(self):
            super().__init__()
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(float(np.asarray(logs["loss"])[0]))

    return LossLog()


def _mobilenet_from(weights, device):
    """hapi.Model over MobileNetV2 holding `weights`, prepared as 14 (c)'s
    (Momentum, cross entropy)."""
    from paddle_tpu_torch import hapi, nn
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import mobilenet_v2

    net = mobilenet_v2(device=device, seed=0)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in
                         weights.items()})
    model = hapi.Model(net)
    model.prepare(Momentum(FIT_LR, momentum=0.9,
                           parameters=net.parameters()),
                  nn.CrossEntropyLoss())
    return model


def _cpu_logits(weights, x):
    """MobileNetV2's logits on the CPU port, `weights` loaded (in a
    worker process)."""
    torch.set_num_threads(1)
    return _mobilenet_from(weights, "cpu").predict_batch([x])[0]


def _fit_step(weights, x, y, device="cpu"):
    """One `Model.fit` step over the batch (x, y) from `weights`, Dropout
    at p 0: (its loss, {name: the parameter's change})."""
    from paddle_tpu_torch.io import TensorDataset

    if device == "cpu":
        torch.set_num_threads(1)
    model = _mobilenet_from(weights, device)
    # the classifier's Dropout at p 0: the card's and the CPU's masks
    # come from different generators
    for sub in model.network.modules():
        if type(sub).__name__ == "Dropout":
            sub.p = 0.0
    log = _loss_log()
    model.fit(TensorDataset([torch.from_numpy(x), torch.from_numpy(y)]),
              batch_size=len(y), epochs=1, shuffle=False, verbose=0,
              callbacks=[log])
    return log.losses[0], {
        n: p.detach().cpu().numpy() - weights[n]
        for n, p in model.network.named_parameters()}


def _update_err(ref, other):
    """The updates' difference over their norm, all parameters as one."""
    num = sum(float(((other[n] - r).astype(np.float64) ** 2).sum())
              for n, r in ref.items())
    return (num / sum(float((r.astype(np.float64) ** 2).sum())
                      for r in ref.values())) ** 0.5


def _eval_from_logits(logits, labels, batch):
    """`Model.evaluate`'s loss (the mean over batches of each batch's mean
    cross entropy) and Accuracy(topk=(1, 5)) from stacked logits."""
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.nn import functional as F

    acc = Accuracy(topk=(1, 5))
    losses = []
    for i in range(0, len(labels), batch):
        lo = torch.from_numpy(logits[i:i + batch])
        la = torch.from_numpy(labels[i:i + batch])
        losses.append(float(F.cross_entropy(lo, la)))
        acc.update(acc.compute(lo, la))
    top1, top5 = acc.accumulate()
    return {"loss": sum(losses) / len(losses), "acc_top1": top1,
            "acc_top5": top5}


def fit_phase(card, train_ds, eval_ds, eval_batches, tmp, device="cuda"):
    """14 (c): hapi.Model.fit over MobileNetV2 at width 1.0."""
    import concurrent.futures as cf
    import multiprocessing

    from paddle_tpu_torch import hapi, nn, profiler
    from paddle_tpu_torch.jit import _STEPS_TOTAL
    from paddle_tpu_torch import profile_train as pt
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.profile_train import H100_PEAK_BF16
    from paddle_tpu_torch.vision.models import mobilenet_v2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = mobilenet_v2(device=device, seed=0)
    n_params = sum(p.numel() for p in net.parameters())
    macs = hapi.flops(net, [1, 3, 224, 224])
    model = hapi.Model(net)
    opt = Momentum(FIT_LR, momentum=0.9, parameters=net.parameters())
    model.prepare(opt, nn.CrossEntropyLoss(), Accuracy(topk=(1, 5)))
    log = _loss_log()
    steps0, count0 = opt._step_count, _STEPS_TOTAL.value
    _sync_dev(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logs = model.fit(train_ds, eval_ds, batch_size=FIT_BATCH, epochs=1,
                     num_workers=FIT_WORKERS, verbose=0, callbacks=[log])
    _sync_dev(device)
    fit_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if device == "cuda" else float("nan"))
    stepped = (opt._step_count - steps0, _STEPS_TOTAL.value - count0)
    bm = profiler.benchmark()
    meter = bm.stats(batch_size=FIT_BATCH)
    times = list(bm.step_times)
    n_train = len(train_ds) // FIT_BATCH
    if not (len(log.losses) == n_train
            and all(np.isfinite(log.losses))):
        raise AssertionError(f"14 (c): losses {log.losses}")
    if stepped != (n_train, n_train):
        raise AssertionError(f"14 (c): {n_train} steps, but the optimizer "
                             f"and pt_train_steps_total moved {stepped}")
    # the weights after fit: the eval set's logits and one fit step on
    # the CPU port, in worker processes while the card goes on
    w = {k: v.detach().cpu().numpy().copy()
         for k, v in net.state_dict().items()}
    # the step's images spread over the classes (the eval set is in
    # class order), so that shifting the labels changes each pairing
    images = np.concatenate([b[0] for b in eval_batches])
    labels = np.concatenate([b[1] for b in eval_batches])
    every = len(images) // FIT_STEP_BATCH
    xs, ys = images[::every], labels[::every]
    pool = cf.ProcessPoolExecutor(
        FIT_CPU_PROCS, mp_context=multiprocessing.get_context("forkserver"))
    t_cpu = time.perf_counter()
    try:
        cpu_step = pool.submit(_fit_step, w, xs, ys)
        cpu_logits = [pool.submit(_cpu_logits, w,
                                  images[i:i + FIT_CPU_CHUNK])
                      for i in range(0, len(images), FIT_CPU_CHUNK)]
        ev_card = model.evaluate(eval_batches, verbose=0)
        lg = model.predict(eval_batches, stack_outputs=True)[0]
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            lg_tf32 = model.predict(eval_batches, stack_outputs=True)[0]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        step_card = _fit_step(w, xs, ys, device)
        step_wrong = _fit_step(w, xs, np.roll(ys, 1), device)
        lc = np.concatenate([f.result() for f in cpu_logits])
        step_cpu = cpu_step.result()
    finally:
        pool.shutdown(cancel_futures=True)
    cpu_s = time.perf_counter() - t_cpu
    ev_cpu = _eval_from_logits(lc, labels, FIT_BATCH)
    ev_tf32 = _eval_from_logits(lg_tf32, labels, FIT_BATCH)

    def eval_errs(card_ev, card_lg):
        return (abs(card_ev["loss"] - ev_cpu["loss"]) / abs(ev_cpu["loss"]),
                float(np.abs(card_lg - lc).max() / np.abs(lc).max()))

    def step_errs(card):
        return (abs(card[0] - step_cpu[0]) / abs(step_cpu[0]),
                _update_err(step_cpu[1], card[1]))

    loss_rel, logit_rel = eval_errs(ev_card, lg)
    tf32 = eval_errs(ev_tf32, lg_tf32)
    tf32_x = max(tf32[0] / FIT_EVAL_RTOL, tf32[1] / FIT_LOGITS_TOL)
    step = step_errs(step_card)
    wrong = step_errs(step_wrong)
    wrong_x = max(wrong[0] / FIT_STEP_LOSS_TOL, wrong[1] / FIT_STEP_TOL)
    flips = {k: _near_tie_flips(lg, lc, labels, k) for k in (1, 5)}
    # predict after save and a fresh load, bit for bit
    torch.backends.cudnn.deterministic = True
    try:
        before = model.predict(eval_batches, stack_outputs=True)[0]
        path = os.path.join(tmp, "mobilenet_v2")
        model.save(path)
        fresh_net = mobilenet_v2(device=device, seed=1)
        fresh = hapi.Model(fresh_net)
        fresh.prepare(Momentum(FIT_LR, momentum=0.9,
                               parameters=fresh_net.parameters()),
                      nn.CrossEntropyLoss())
        fresh.load(path)
        after = fresh.predict(eval_batches, stack_outputs=True)[0]
    finally:
        torch.backends.cudnn.deterministic = False
    reload_equal = bool(np.array_equal(before, after))
    # the same TrainStep on a batch already on the card
    train_step = model._train_step
    xb = torch.from_numpy(eval_batches[0][0]).to(device)
    yb = torch.from_numpy(eval_batches[0][1]).to(device)
    for _ in range(FIT_DEVICE_WARM):
        train_step(xb, yb)
    _sync_dev(device)
    t1 = time.perf_counter()
    for _ in range(FIT_DEVICE_STEPS):
        train_step(xb, yb)
    _sync_dev(device)
    dev_ms = (time.perf_counter() - t1) / FIT_DEVICE_STEPS * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        _sync_dev(device)
        t2 = time.perf_counter()
        train_step(xb, yb)
        _sync_dev(device)
        wall = time.perf_counter() - t2
    dev_us = pt.device_us(prof)
    idle = 1 - dev_us / 1e6 / wall if dev_us else float("nan")
    fit_ms = meter["avg_batch_cost_s"] * 1e3
    steady_ms = float(np.median(times[1:])) * 1e3 if len(times) > 1 \
        else fit_ms
    step_flops = 3 * 2 * macs * FIT_BATCH
    print(f"14 (c) hapi.Model.fit: MobileNetV2 width 1.0, {n_params} "
          f"parameters, 1000 classes, Momentum({FIT_LR}, 0.9), f32, batch "
          f"{FIT_BATCH}, {FIT_WORKERS} workers ({card}): {len(log.losses)} "
          f"steps, losses {log.losses[0]:.4f} → {log.losses[-1]:.4f}; "
          f"optimizer and pt_train_steps_total +{stepped[0]} / "
          f"+{stepped[1]}; fit {fit_s:.2f} s with the eval pass (eval "
          f"loss {logs.get('eval_loss', float('nan')):.4f}, top-1 "
          f"{logs.get('eval_acc_top1', float('nan')):.4f}); "
          f"profiler.benchmark(): {fit_ms:.3f} ms/step, "
          f"{FIT_BATCH / meter['avg_batch_cost_s']:.1f} images/s over "
          f"{meter['steps']} steps (median after the first "
          f"{steady_ms:.3f} ms, {FIT_BATCH / steady_ms * 1e3:.1f} images/s); "
          f"the same TrainStep on a batch on the card {dev_ms:.3f} ms/step"
          f", {FIT_BATCH / dev_ms * 1e3:.1f} images/s (the loader's cost: "
          f"{steady_ms - dev_ms:.3f} ms a step); one profiled step "
          f"{wall * 1e3:.3f} ms wall, device {dev_us / 1e3:.3f} ms, idle "
          f"{100 * idle:.1f} %; peak memory {peak:.2f} GiB; from "
          f"hapi.flops' {macs / 1e6:.3f} M MACs an image at 224² x 3 x 2 x "
          f"{FIT_BATCH} = {step_flops / 1e12:.4f} TFLOP a step, MFU over "
          f"the f32 peak outside the tensor cores (67 TFLOP/s; TF32 is off) "
          f"{step_flops / (steady_ms / 1e3) / H100_PEAK_F32:.4f} (fit, "
          f"steady) / {step_flops / (dev_ms / 1e3) / H100_PEAK_F32:.4f} "
          f"(batch on the card), over the bf16 peak (989 TFLOP/s) "
          f"{step_flops / (steady_ms / 1e3) / H100_PEAK_BF16:.4f} / "
          f"{step_flops / (dev_ms / 1e3) / H100_PEAK_BF16:.4f}; the weights "
          f"after fit, card vs CPU over the {len(labels)} eval images: "
          f"loss {ev_card['loss']:.6f} vs {ev_cpu['loss']:.6f} (relative "
          f"{loss_rel:.3e}; tol {FIT_EVAL_RTOL:g}), logits {logit_rel:.3e} "
          f"of max-abs apart (tol {FIT_LOGITS_TOL:g}), top-1 "
          f"{ev_card['acc_top1']:.4f} vs {ev_cpu['acc_top1']:.4f}, top-5 "
          f"{ev_card['acc_top5']:.4f} vs {ev_cpu['acc_top5']:.4f}, "
          f"samples flipped (near-ties among them): top-1 {flips[1][0]} "
          f"({flips[1][1]}), top-5 {flips[5][0]} ({flips[5][1]}); planted, "
          f"the card's eval with TF32 allowed: loss {tf32[0]:.3e}, logits "
          f"{tf32[1]:.3e} ({tf32_x:.3g}x its gate); one fit step of "
          f"{FIT_STEP_BATCH} eval images from those weights, card vs CPU: "
          f"loss {step_card[0]:.6f} vs {step_cpu[0]:.6f} (relative "
          f"{step[0]:.3e}; tol {FIT_STEP_LOSS_TOL:g}), update {step[1]:.3e} "
          f"of its norm apart (tol {FIT_STEP_TOL:g}); planted, labels "
          f"shifted by one image: loss {wrong[0]:.3e}, update "
          f"{wrong[1]:.3e} ({wrong_x:.3g}x its gate); the CPU's share "
          f"{cpu_s:.2f} s (in {FIT_CPU_PROCS} processes beside the card); "
          f"predict after save / load bit-equal: {reload_equal}")
    if loss_rel > FIT_EVAL_RTOL or logit_rel > FIT_LOGITS_TOL:
        raise AssertionError("14 (c): the card's and the CPU's eval "
                             "disagree")
    if tf32_x <= ZOO_FAULT_MARGIN:
        raise AssertionError("14 (c): the eval with TF32 allowed passed")
    if step[0] > FIT_STEP_LOSS_TOL or step[1] > FIT_STEP_TOL:
        raise AssertionError("14 (c): the card's and the CPU's fit step "
                             "disagree")
    if wrong_x <= ZOO_FAULT_MARGIN:
        raise AssertionError("14 (c): the step over shifted labels passed")
    if any(f != t for f, t in flips.values()):
        raise AssertionError(f"14 (c): top-k verdicts differ beyond "
                             f"near-ties: {flips}")
    if not reload_equal:
        raise AssertionError("14 (c): predict after load is not predict "
                             "before")
    del train_step, model, fresh, net, fresh_net
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return dict(fit_ms=fit_ms, steady_ms=steady_ms, dev_ms=dev_ms,
                idle=idle, peak_gib=peak, macs=macs)


def _start_forkserver():
    """Start the DataLoader workers' forkserver, if it is not running: it
    imports torch and the port (≈ 10 s on the card's host) while other
    work runs."""
    from multiprocessing import forkserver

    from paddle_tpu_torch.io import multiprocess

    multiprocess._context("forkserver")
    forkserver.ensure_running()


def hapi_phase(card):
    """14: (a) the zoo cross-check, (b) the input pipeline, (c) fit."""
    import shutil

    t0 = time.perf_counter()
    _start_forkserver()
    zoo_cross(card)
    tmp = tempfile.mkdtemp(prefix="pt_hapi_")
    try:
        train_ds, eval_ds, eval_batches = input_pipeline(
            card, os.path.join(tmp, "folder"))
        out = fit_phase(card, train_ds, eval_ds, eval_batches, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"hapi phase (14): {time.perf_counter() - t0:.1f} s")
    return out


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
    t_start = t0 = time.perf_counter()
    _build.build(["paged_attention", "flash_attention", "int8_gemm"])
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc seconds per source: {_build.build_seconds})")
    build_report(_build, fa.TC_HEAD_DIMS)
    # the DataLoader workers' forkserver (phase 14) imports torch and the
    # port, ≈ 10 s of one core: started here, it is ready long before
    _start_forkserver()
    t_checks = time.perf_counter()
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
    print(f"kernel checks (2-3): {time.perf_counter() - t_checks:.1f} s")
    t_serve = time.perf_counter()
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
    print(f"serve phases (4-5d): {time.perf_counter() - t_serve:.1f} s")
    t_fleet = time.perf_counter()
    fleet = fleet_phase(pa, model, card)
    print(f"fleet phase: {time.perf_counter() - t_fleet:.1f} s")
    t_disagg = time.perf_counter()
    disagg = disagg_phase(card)
    print(f"disagg phase (5l): {time.perf_counter() - t_disagg:.1f} s")
    t_tier = time.perf_counter()
    tier = tier_phase(pa, model, card)
    print(f"tier phase: {time.perf_counter() - t_tier:.1f} s")
    t_gen = time.perf_counter()
    generate_phase(model, card)
    serving_phase(card)
    print(f"generate and server phases: "
          f"{time.perf_counter() - t_gen:.1f} s")
    del model
    t_draft = time.perf_counter()
    drafts = draft_phase(pa, random, card)
    weights = weights_phase(ig, pa, random, card,
                            fused[("bfloat16", 4)]["greedy"]["dev_ms"])
    structured = structured_phase(pa, card)
    print(f"draft, weights and structured phases (5e-5g): "
          f"{time.perf_counter() - t_draft:.1f} s")
    t_cross = time.perf_counter()
    cross_check()
    cx_launches = cross_quant_spec(pa)
    fa_launches, train_losses, train_ms = train(fa)
    print(f"cross checks and train (6-8): "
          f"{time.perf_counter() - t_cross:.1f} s")
    t_train = time.perf_counter()
    fa_1p3b = train_1p3b(fa, card)
    remat_phase(fa, card)
    steptrace_ab(card)
    print(f"train phases 8b-8d: {time.perf_counter() - t_train:.1f} s")
    t_dist = time.perf_counter()
    dist = dist_phase(fa, card, train_losses, train_ms)
    pipe = pipe_phase(fa, card)
    moe = moe_phase(fa, card, dist["outs"])
    sp = sp_phase(fa, card)
    print(f"multi-process phases (8e-8h): "
          f"{time.perf_counter() - t_dist:.1f} s")
    t_cross = time.perf_counter()
    train_cross_check()
    train_cross_check_bf16(fa)
    t_o2 = time.perf_counter()
    train_cross_check_o2(fa, card)
    print(f"train cross-check O2 (10b): {time.perf_counter() - t_o2:.1f} s")
    print(f"train cross-checks (9-10b): "
          f"{time.perf_counter() - t_cross:.1f} s")
    vision_phase(card)
    bert = bert_phase(fa, card)
    mt = mt_phase(fa, card)
    hapi_phase(card)
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
    # 5l: K1 in each rank of the disaggregated run (bf16, int8 pools)
    kernels[0]["disagg_launches"] = disagg["bfloat16"]
    kernels[2]["disagg_launches"] = disagg["int8"]
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
        # 8e: DistributedTrainStep at world 1, and each rank of dp 2
        row["dist_launches"] = {"world1": dist["world1"][name],
                                "dp2_rank0": dist["rank0"][name],
                                "dp2_rank1": dist["rank1"][name]}
        # 8f: the pipelined GPT-1.3B at world 1, and each rank of pp 2 x
        # mp 2
        row["pipe_launches"] = {k: v[name] for k, v in pipe.items()}
        # 8g: the MoE GPT at gpt_1p3b's widths at world 1, and each rank
        # of ep 2
        row["moe_launches"] = {k: v[name] for k, v in moe.items()}
        # 8h: each rank's ring call (sp 2) and each rank of pp 2 x sp 2
        row["sp_launches"] = {k: v[0][name] for k, v in sp.items()}
        row["sp_causal_launches"] = {k: v[1][name] for k, v in sp.items()}
        # 12: bench_bert's two heads and the padded batch (kv_lens), all
        # bidirectional; the times at bench_bert's shape
        row["bert_launches"] = bert[name]
        row["shape_bert"] = r["shape_bert"]
        # 13 (b): Transformer-base's steps (the encoder's self-attention
        # and the equal-length cross-attention, bidirectional); the times
        # at its shape
        row["mt_launches"] = mt[name]
        row["shape_mt"] = r["shape_mt"]
        kernels.append(row)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from the "
          "build to the result")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
