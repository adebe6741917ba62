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
  cost from speculation's;
* `fused`, `fused-int8`: the serve load at decode_k 8 (fused windows, one
  CUDA graph replay each) on a bf16 / int8 pool;
* `sampled`, `sampled-fused`: the serve load with every request sampled
  (temperature 0.8, top_p 0.9) at decode_k 1 / 8;
* `draft`, `draft-int8`: draft-model speculation (spec_k 4) on a bf16 /
  int8 pool, the random prompts, the target and its 1-layer draft from
  `spec_draft_pair` (the reference bench's `_spec_draft_pair`,
  bench.py:831: the draft holds the target's embeddings, first block and
  final LN; the target's later blocks have proj / fc2 damped by 0.01);
* `int8-weights`: the serve load on the model after
  `quantize_model_int8` (every linear through the int8 GEMM);
* `structured`: the serve load at decode_k 4 with every other request
  constrained (`STRUCTURED`: chip_smoke phase 5g's grammars and JSON
  schema, eos token 0; one sampled), the engine given the synthetic
  50304-string vocabulary of `structured_token_strs` and 256 grammar
  states.

Each load runs one warm-up burst, one timed burst and one burst under
`torch.profiler`, then prints:

* the card's name and power limit (nvidia-smi);
* the timed burst's wall time, generated tok/s and median TTFT, engine
  steps (single ticks + verify or fused windows), proposals and
  acceptances, and the host seconds spent mining proposals;
* for the fused loads, the host ms per window (`_try_step_fused`, its one
  sync included) and the device ms per window (CUDA events around each
  graph replay, its launch latency included); for the draft loads, the
  acceptance rate and, per window, the host ms (`try_window`, its one
  sync included), the draft ms (CUDA events from the draft's catch-up to
  the proposals' gather after the propose replay) and the stream ms
  (events from the catch-up to the verify's end: device time and the
  eager steps' idle gaps); for the sampled loads, the
  sampler's device ms per call (`sample_tokens` on [num_slots, vocab]
  replayed from a CUDA graph, as a window runs it: `sampler_ms`); for
  the structured load, the host µs per `_grammar_args` call (the window's
  grammar states and tables) and per host-tick mask (`_mask_rows`), the
  device ms of one mask expansion and `where` on [num_slots, vocab]
  (`mask_ms`) and its share of a window's device time (decode_k of them
  per window);
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
import subprocess
import time
import types

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .core import prng
from .inference import LLMEngineConfig, LLMServer
from .quantization.runtime import quantize_model_int8
from .text.models.gpt import (GPTConfig, GPTForCausalLM, gpt_small,
                              grammar_allowed, sample_tokens)

PROMPT_LENS = (16, 40, 100, 200, 350, 500, 700, 900)
NEW_TOKENS = 32
ENGINE = dict(num_slots=8, page_size=16, max_model_len=1024,
              token_budget=256)
_NGRAM = dict(spec_mode="ngram", spec_k=4)
_DRAFT = dict(spec_k=4)           # the draft model is added by `run_load`
_SAMPLED = dict(temperature=0.8, top_p=0.9)
# kernel names of csrc/paged_attention.cu as the profiler shows them: K1
# on the CUDA cores and the three launches of its tensor-core route, K2
# on the CUDA cores and the two of its tensor-core route (a bf16 q on
# bf16, int8 and int4 pools)
PAGED_KERNELS = {"K1": ("rpa_kernel", "rpa_tc_plan_kernel", "rpa_tc_kernel",
                        "rpa_tc_merge_kernel"),
                 "K2": ("rpa_qblock_kernel", "rpa_tc_qblock_kernel",
                        "rpa_tc_qblock_merge_kernel")}
# csrc/int8_gemm.cu: the activation quantize and the W8A8 GEMM
GEMM_KERNELS = {"int8 GEMM": ("quantize_rows_kernel", "w8a8_gemm_kernel")}
# the structured load's grammars (chip_smoke phase 5g): a JSON-ish list
# template whose DFA has 99 states at the synthetic vocabulary, a small
# object, and a schema with a string and an integer property
TEMPLATE = r'\[(\{"k":[0-9]\},){8,12}\]'
OBJECT_A = r'\{"a":[0-9]{1,3}\}'
SCHEMA = {"type": "object", "properties": {"name": {"type": "string"},
                                           "count": {"type": "integer"}}}
_EOS = dict(eos_token_id=0)
STRUCTURED = [dict(grammar=TEMPLATE, **_EOS), _EOS,
              dict(grammar=OBJECT_A, **_EOS), _EOS,
              dict(json_schema=SCHEMA, **_EOS), _EOS,
              dict(grammar=TEMPLATE, **_EOS, **_SAMPLED), _EOS]
# load -> (engine knobs, repetitive prompts, request knobs — or one per
# prompt[, model]): model "draft" serves `spec_draft_pair`'s target with
# its draft, "int8-weights" the serve model after `quantize_model_int8`
LOADS = {"serve": (dict(kv_dtype="bfloat16"), False, {}),
         "bf16-repetitive": (dict(kv_dtype="bfloat16"), True, {}),
         "int8": (dict(kv_dtype="int8"), True, {}),
         "ngram": (dict(kv_dtype="bfloat16", **_NGRAM), True, {}),
         "int8-ngram": (dict(kv_dtype="int8", **_NGRAM), True, {}),
         "fused": (dict(kv_dtype="bfloat16", decode_k=8), False, {}),
         "fused-int8": (dict(kv_dtype="int8", decode_k=8), False, {}),
         "sampled": (dict(kv_dtype="bfloat16"), False, _SAMPLED),
         "sampled-fused": (dict(kv_dtype="bfloat16", decode_k=8), False,
                           _SAMPLED),
         "draft": (dict(kv_dtype="bfloat16", **_DRAFT), False, {}, "draft"),
         "draft-int8": (dict(kv_dtype="int8", **_DRAFT), False, {},
                        "draft"),
         "int8-weights": (dict(kv_dtype="bfloat16"), False, {},
                          "int8-weights"),
         "structured": (dict(kv_dtype="bfloat16", decode_k=4,
                             grammar_states=256), False, STRUCTURED)}


def structured_token_strs(vocab, seed=1234):
    """A synthetic tokenizer vocabulary of `vocab` surface strings, from a
    seed: token 0 is "" (the eos), then the 95 printable ASCII characters,
    all 9025 two-character strings of them, then distinct random
    three-character strings — so a grammar's scaffolding is crossed by
    multi-character tokens, as a real BPE vocabulary's is."""
    chars = [chr(c) for c in range(32, 127)]
    strs = [""] + chars + [a + b for a in chars for b in chars]
    n = vocab - len(strs)
    if n < 0:
        raise ValueError(f"vocab {vocab} < {len(strs)}")
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(chars) ** 3, size=n, replace=False)
    c = len(chars)
    strs += [chars[i // (c * c)] + chars[i // c % c] + chars[i % c]
             for i in idx.tolist()]
    return strs


def spec_draft_pair(config, draft_layers=1, damp=0.01, dtype="bfloat16",
                    seed=1234, device=None):
    """(target, draft) as the reference bench's `_spec_draft_pair`
    (bench.py:831) builds them, from a seed: the target `config` with the
    proj and fc2 weights (and biases) of every block past the first
    `draft_layers` damped by `damp`; the draft the same configuration at
    `draft_layers` blocks, holding copies of the target's embeddings,
    first blocks and final LN (copies: a later quantization of one does
    not alter the other). The draft's logits track the target's, so
    proposals are accepted at a measured rate."""
    target = GPTForCausalLM(config, device=device, dtype=dtype, seed=seed)
    with torch.no_grad():
        for layer in target.gpt.layers[draft_layers:]:
            for lin in (layer.proj, layer.fc2):
                lin.weight.mul_(damp)
                if lin.bias is not None:
                    lin.bias.mul_(damp)
    dcfg = GPTConfig(**dict(vars(config), num_layers=draft_layers))
    draft = GPTForCausalLM(dcfg, device=target.device, dtype=dtype, seed=seed)
    big = target.state_dict()
    draft.load_state_dict({k: big[k].clone() for k in draft.state_dict()})
    return target, draft


def _prompts(repetitive, vocab):
    if not repetitive:
        rng = np.random.default_rng(1234)
        return [rng.integers(0, vocab, (n,)) for n in PROMPT_LENS]
    rng = np.random.default_rng(4321)
    return [np.resize(rng.integers(0, vocab, (24,)), n) for n in PROMPT_LENS]


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _burst(server, prompts, request):
    """(wall seconds, median TTFT seconds) of one burst; `request` holds
    the knobs of every request, or is a list of one dict per prompt."""
    if not isinstance(request, list):
        request = [request] * len(prompts)
    t0 = time.perf_counter()
    futs = [server.submit(p, max_new_tokens=NEW_TOKENS, **kw)
            for p, kw in zip(prompts, request)]
    for f in futs:
        f.result(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ttft = sorted(f.pt_request.t_first_token - t0 for f in futs)
    return wall, ttft[len(ttft) // 2]


class EventTimer:
    """Wraps `obj.name` with CUDA events around each call, until `remove`:
    the device time of a graph replay (its launch latency included); for
    an eager, host-bound call also the card's idle gaps."""

    def __init__(self, obj, name):
        self.obj, self.name, self.fn = obj, name, getattr(obj, name)
        self.own = name in vars(obj)   # else the class's method
        self.events = []

        def timed(*args, **kw):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            try:
                return self.fn(*args, **kw)
            finally:
                b.record()
                self.events.append((a, b))

        setattr(obj, name, timed)

    def ms(self):
        torch.cuda.synchronize()
        return np.asarray([a.elapsed_time(b) for a, b in self.events])

    def remove(self):
        _restore(self)


def _graph_ms(fn, reps=20):
    """Median device ms of `fn()` as a fused window pays it: captured in a
    CUDA graph (after three warm-up calls on a side stream), CUDA events
    around each replay (its launch latency included). Eagerly a call's
    many small launches take more host time than device time, which a
    timed eager call would count as device gaps."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    times = []
    for _ in range(reps + 3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times[3:]))


def sampler_ms(rows, vocab, reps=20):
    """Median device ms of one `sample_tokens` call on [rows, vocab] f32
    logits, every row sampled (temperature 0.8, top_p 0.9), replayed from
    a CUDA graph (`_graph_ms`)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    args = (torch.randn((rows, vocab), device="cuda", generator=g),
            torch.full((rows,), 0.8, device="cuda"),
            torch.full((rows,), 0.9, device="cuda"),
            torch.arange(rows, dtype=torch.int32, device="cuda"),
            torch.full((rows,), 100, dtype=torch.int32, device="cuda"),
            prng.prng_key(1234, device="cuda"))
    return _graph_ms(lambda: sample_tokens(*args), reps)


def mask_ms(arena, rows, reps=20):
    """Median device ms of one grammar mask on [rows, vocab] f32 logits —
    `grammar_allowed` over the arena's device words at `rows` random
    resident states, then the `where` that `sample_tokens(allowed=)`
    applies — replayed from a CUDA graph (`_graph_ms`)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    _, words = arena.device_tables()
    states = torch.randint(0, arena.states_used, (rows,), device="cuda",
                           generator=g, dtype=torch.int32)
    logits = torch.randn((rows, arena.vocab), device="cuda", generator=g)
    return _graph_ms(lambda: torch.where(
        grammar_allowed(words, states, arena.vocab), logits, -1e30), reps)


class HostTimer:
    """Wraps `obj.name` to record the host seconds of each call, until
    `remove`."""

    def __init__(self, obj, name):
        self.obj, self.name, self.fn = obj, name, getattr(obj, name)
        self.own = name in vars(obj)   # else the class's method
        self.times = []

        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return self.fn(*args, **kw)
            finally:
                self.times.append(time.perf_counter() - t0)

        setattr(obj, name, timed)

    def remove(self):
        _restore(self)


class SpecTimer:
    """Times each draft-model window of `spec` (an engine's
    `SpeculativeDecoder`), until `remove`: the host seconds of
    `try_window` (its one sync included), and CUDA events at the start of
    the draft's catch-up, after the proposals' gather (the propose replay
    and the device gather) and after the verify. Draft ms: catch-up +
    propose; window ms: the whole window on the stream, the eager steps'
    idle gaps included."""

    def __init__(self, spec):
        self.host = HostTimer(spec, "try_window")
        self.marks = []          # per window: [start, drafted, verified]
        self.wraps = [self._wrap(spec, "_catch_up", start=True),
                      self._wrap(spec._propose_fn, "drafts"),
                      self._wrap(spec, "_verify_fn")]

    def _wrap(self, obj, name, start=False):
        fn = getattr(obj, name)

        def wrapped(*args, **kw):
            if start:
                self.marks.append([])
                self._event()
            out = fn(*args, **kw)
            if not start:
                self._event()
            return out

        wrap = types.SimpleNamespace(obj=obj, name=name, fn=fn,
                                     own=name in vars(obj))
        setattr(obj, name, wrapped)
        return wrap

    def _event(self):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.marks[-1].append(e)

    def ms(self):
        """(host, draft, window) ms per window: medians."""
        torch.cuda.synchronize()
        done = [m for m in self.marks if len(m) == 3]
        return (float(np.median(self.host.times)) * 1e3,
                float(np.median([a.elapsed_time(b) for a, b, _ in done])),
                float(np.median([a.elapsed_time(c) for a, _, c in done])))

    def remove(self):
        for timer in (self.host, *self.wraps):
            _restore(timer)


def _restore(timer):
    """Undo a timer's wrap: the object's own attribute back, or the class's
    method again (a bound method left in the instance would be a
    reference cycle, freed only by the cyclic collector)."""
    if timer.own:
        setattr(timer.obj, timer.name, timer.fn)
    else:
        delattr(timer.obj, timer.name)


def run_load(model, name, trace=None, draft=None):
    """Runs `name` of LOADS on `model` (with `draft` as the draft model of
    the draft loads) and prints its numbers."""
    from .ops.cuda_kernels import paged_attention as pa

    knobs, repetitive, request = LOADS[name][:3]
    vocab = model.config.vocab_size
    prompts = _prompts(repetitive, vocab)
    structured = request is STRUCTURED
    if structured:
        knobs = dict(knobs, token_strs=structured_token_strs(vocab))
    server = LLMServer(model, LLMEngineConfig(**ENGINE, **knobs,
                                              draft_model=draft))
    eng = server.engine
    timers = [HostTimer(eng, "step"),
              HostTimer(pa, "ragged_paged_attention"),
              HostTimer(eng, "_try_step_fused"),
              HostTimer(eng, "_grammar_args"), HostTimer(eng, "_mask_rows")]
    if eng.spec_mode == "ngram":
        timers.append(HostTimer(eng._spec, "_propose"))
    replay = spec_timer = None
    try:
        with server:
            _burst(server, prompts, request)           # warm-up (captures)
            if eng._fused_fn is not None:
                replay = EventTimer(eng._fused_fn, "replay")
            if eng.spec_mode == "draft":
                spec_timer = SpecTimer(eng._spec)
            before = dict(eng.stats)
            for t in timers:
                t.times.clear()
            wall, ttft = _burst(server, prompts, request)
            step_s, paged_s, window_s, gargs_s, gmask_s, *scan_s = (
                np.asarray(t.times) for t in timers)
            replay_ms = replay.ms() if replay is not None else None
            spec_ms = spec_timer.ms() if spec_timer is not None else None
            d = {k: eng.stats[k] - before.get(k, 0) for k in eng.stats}
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                pwall, _ = _burst(server, prompts, request)
    finally:
        for t in timers:
            t.remove()
        if replay is not None:
            replay.remove()
        if spec_timer is not None:
            spec_timer.remove()
    scan = scan_s[0].sum() if scan_s else 0.0
    steps = d["steps"]
    windows = (d.get("ngram_windows", 0) + d.get("spec_windows", 0)
               + d["fused_steps"])
    gen = d["generated"]        # a constrained request may end at eos
    shown = {k: v for k, v in knobs.items() if k != "token_strs"}
    if structured:
        n = sum("grammar" in r or "json_schema" in r for r in request)
        request_s = f"{n} of {len(request)} requests constrained"
    else:
        request_s = str(request) if request else ""
    print(f"load {name} ({shown}, {'repetitive' if repetitive else 'random'}"
          f" prompts{', ' + request_s if request_s else ''}; "
          f"{_card()}): {wall * 1e3:.3f} ms wall, {gen / wall:.1f} generated "
          f"tok/s, TTFT median {ttft * 1e3:.3f} ms, {steps} steps = "
          f"{steps - windows} ticks + {windows} windows "
          f"({wall * 1e3 / steps:.3f} ms/step)"
          + (f", proposed {d['ngram_proposed']} accepted "
             f"{d['ngram_accepted']}, proposal scan {scan * 1e3:.3f} ms "
             "on the host" if d.get("ngram_windows") else ""))
    if replay_ms is not None and len(replay_ms):
        print(f"  fused windows (decode_k {eng.decode_k}): host "
              f"{np.median(window_s) * 1e3:.3f} ms per window (median, its "
              f"sync included), device {np.median(replay_ms):.3f} ms per "
              f"window (median over {len(replay_ms)} replays; "
              f"{np.median(replay_ms) / eng.decode_k:.3f} ms per token "
              "iteration)")
    if spec_ms is not None:
        prop, acc = d["spec_proposed"], d["spec_accepted"]
        print(f"  draft windows (spec_k {eng._spec.k}): {d['spec_windows']}"
              f" windows, proposed {prop} accepted {acc} = "
              f"{100 * acc / max(prop, 1):.1f}% acceptance; per window "
              f"(medians): host {spec_ms[0]:.3f} ms (its sync included), "
              f"draft {spec_ms[1]:.3f} ms (catch-up + propose replay), "
              f"stream {spec_ms[2]:.3f} ms (catch-up to verify end)")
    if not structured and request.get("temperature", 0) > 0:
        print(f"  sampler: {sampler_ms(eng.num_slots, vocab):.4f} ms of "
              f"device per sample_tokens call on [{eng.num_slots}, {vocab}]")
    if structured:
        mms = mask_ms(eng.grammar_arena, eng.num_slots)
        share = (f"{100 * eng.decode_k * mms / np.median(replay_ms):.2f}% "
                 "of a window's device time" if replay_ms is not None
                 and len(replay_ms) else "no window timed")
        print(f"  grammar: host {np.median(gargs_s) * 1e6:.1f} µs per "
              f"_grammar_args (median of {len(gargs_s)}), "
              + (f"{np.median(gmask_s) * 1e6:.1f} µs per host-tick mask "
                 f"(median of {len(gmask_s)}); " if len(gmask_s) else
                 "no host-tick mask; ")
              + f"device {mms * 1e3:.1f} µs per mask on [{eng.num_slots}, "
              f"{vocab}] (graph replay), {eng.decode_k} a window = {share};"
              f" {eng.stats['structured_requests']} constrained requests, "
              f"{eng.grammar_arena.states_used} arena states")
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
    for label, names in {**PAGED_KERNELS, **GEMM_KERNELS}.items():
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
    models = {}

    def model_for(kind):       # built once each, at first use
        if kind not in models:
            if kind == "draft":
                models[kind] = spec_draft_pair(gpt_small())
            else:
                m = GPTForCausalLM(gpt_small(), dtype="bfloat16", seed=1234)
                if kind == "int8-weights":
                    quantize_model_int8(m)
                models[kind] = (m, None)
        return models[kind]

    print(f"card: {_card()}")
    rc = 0
    for i, name in enumerate(args.load):
        last = i == len(args.load) - 1
        model, draft = model_for((LOADS[name][3:] or (None,))[0])
        rc |= run_load(model, name, args.trace if last else None, draft)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
