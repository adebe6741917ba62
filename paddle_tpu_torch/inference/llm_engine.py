"""Continuous-batching LLM serving engine with a paged KV cache
(counterpart of paddle_tpu/inference/llm_engine.py: greedy and sampled
decode, single ticks, fused k-token windows, speculative windows and
grammar-constrained decoding).

* Paged KV cache — per layer a pool [num_pages, page_size, heads,
  head_dim] with per-sequence page tables; pages are allocated as a
  sequence grows and freed when it finishes. Physical page 0 is the
  trash page: padding-token writes land there and are never attended.
  `kv_dtype="int8"` / `"int4"` stores quantized rows (int4: two nibbles
  per byte, the pool's last dim head_dim / 2) with an fp32 scale plane
  [num_pages, page_size, heads] beside each pool; attention dequantizes
  on gather.
* Continuous scheduler — every step admits queued prompts into free
  decode slots (`SLAScheduler` order: FIFO under the default class),
  fills a flat token budget with one frontier token per running
  sequence plus chunked prefill, picks each frontier's next token, and
  evicts on EOS or budget. A dry pool preempts the youngest sequence
  back to the queue; the re-run is deterministic.
* Sampling — temperature 0 is greedy; temperature > 0 draws from the
  temperature-scaled, top-p-truncated distribution with jax's threefry
  bits keyed on (engine seed, request stream, token position)
  (`sample_tokens`), so a sampled request's tokens do not depend on
  decode_k, on batching or on preemption, and equal the JAX engine's.
* One eager step per tick (`_PagedStep`) over the fixed geometry
  (token_budget flat tokens, num_slots page tables); the attention
  inside is the ragged paged attention kernel K1 on the card.
* Fused decode (`decode_k` > 1) — rows at their sampling frontier take
  k tokens in one window (`_FusedStep`: on the card one captured CUDA
  graph per (k, greedy-or-sampled), K1 replayed inside it), with the
  pick, EOS and budget masking on the device and one host sync per
  window; rows still prefilling take a single tick in the same step.
* Speculation — rows at their sampling frontier take one verify window
  per step instead, scored in one ragged step through the query-blocked
  kernel K2: `spec_mode="ngram"` proposes by prompt lookup
  (`NgramSpeculator`, inference/structured/ngram.py), `draft_model=` by
  a small draft model with its own mirrored KV pools, its propose window
  one CUDA graph (`SpeculativeDecoder`, inference/speculative.py); rows
  still prefilling take a single tick in the same step.
* Structured decoding — with `LLMEngineConfig(token_strs=...)` a request
  may carry `grammar=` (a regex or a `CompiledGrammar`) or `json_schema=`
  (inference/structured): compiled at submit to a token-level DFA loaded
  into the engine's `GrammarArena`, whose device tables mask every pick
  of a constrained row — on the host at a single tick, inside the fused
  window's graph and inside the verify. The host keeps each request's
  DFA state (`_Request.gstate`) as a replay of its emitted tokens. A
  window with no constrained row runs the graph without any mask op.

    server = LLMServer(model)                  # GPTForCausalLM
    with server:
        fut = server.submit(prompt_ids, max_new_tokens=64)
        tokens = fut.result()   # np.int64 [prompt + generated]

Greedy decode is token-for-token identical to the JAX package's engine
(tests/test_torch_llm_engine.py); eos semantics follow its contract
(the emitted eos is kept, nothing after it).
"""
import gc
import itertools
import os
import queue
import time as _time
from concurrent.futures import Future

import numpy as np
import torch

from ..core import prng
from ..quantization import runtime as _qrt
from ..text.models.gpt import sample_tokens
from .fleet_serving import Priority, SLAScheduler
from .serving import _FutureQueueServer
from .structured import (CompiledGrammar, GrammarArena, GrammarError,
                         compile_regex, schema_to_regex,
                         validate_constraints)
from .structured.arena import GrammarCache

__all__ = ["PagePool", "PoolExhausted", "LLMEngineConfig", "LLMEngine",
           "LLMServer"]


class PoolExhausted(RuntimeError):
    """No free KV pages (the scheduler preempts and retries on this)."""


class PagePool:
    """Refcounted fixed-size KV-page allocator. Physical page 0 is the
    reserved trash page, so pages 1..num_pages-1 are allocable. A free
    of an already-free page raises instead of double-inserting it into
    the free list (which would later hand one page to two sequences)."""

    def __init__(self, num_pages, page_size):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is trash)")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        # LIFO free stack, seeded so the first allocs hand out 1, 2, ...
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._ref = {}  # live page id -> refcount (>= 1)

    @property
    def num_free(self):
        return len(self._free)

    @property
    def num_live(self):
        return len(self._ref)

    def refcount(self, page):
        return self._ref.get(int(page), 0)

    def alloc(self):
        if not self._free:
            raise PoolExhausted(f"all {self.num_pages - 1} KV pages in use")
        p = self._free.pop()
        if p in self._ref:
            raise RuntimeError(f"corrupt free list: page {p} is already live")
        self._ref[p] = 1
        return p

    def share(self, page):
        """Add one holder to a live page; sharing a freed page raises."""
        p = int(page)
        if p not in self._ref:
            raise RuntimeError(f"share of non-live KV page {p}")
        self._ref[p] += 1
        return p

    def free(self, pages):
        for p in pages:
            p = int(p)
            if p not in self._ref:
                raise RuntimeError(
                    f"double free of KV page {p} (live: {len(self._ref)})")
            self._ref[p] -= 1
            if self._ref[p] == 0:
                del self._ref[p]
                self._free.append(p)

    def assert_consistent(self):
        if len(self._free) != len(set(self._free)):
            raise RuntimeError("corrupt free list: duplicate pages")
        both = set(self._free) & set(self._ref)
        if both:
            raise RuntimeError(f"pages both free and live: {sorted(both)}")
        if 0 in self._ref or 0 in self._free:
            raise RuntimeError("trash page 0 entered circulation")
        total = len(self._free) + len(self._ref)
        if total != self.num_pages - 1:
            raise RuntimeError(
                f"page leak: {len(self._free)} free + {len(self._ref)} "
                f"live != {self.num_pages - 1}")


# knobs of the JAX engine that this port does not run yet → ROADMAP row
_UNPORTED_KNOBS = {
    "prefix_cache": "A10 (serving fleet: prefix cache)",
    "hash_block_tokens": "A10 (serving fleet: prefix cache)",
    "kv_tier": "A10 (serving fleet: KV tier)",
    "session_ttl_s": "A10 (serving fleet: sessions)",
    "session_max": "A10 (serving fleet: sessions)",
}


class LLMEngineConfig:
    """Engine sizing.

    num_slots     max concurrently-decoding sequences
    page_size     tokens per KV page
    num_pages     pool size incl. the trash page; default
                  num_slots * ceil(max_model_len / page_size) + 1
    max_model_len per-sequence token cap; default model max_seq_len
    token_budget  flat tokens per step (>= num_slots); the surplus over
                  the decode tokens is the chunked-prefill bandwidth.
                  Default num_slots + max(num_slots, 8).
    kv_dtype      pool dtype "float32" | "bfloat16" | "int8" | "int4"
                  (int8 / packed int4 rows with per-row fp32 scale
                  planes, dequantized on gather). Default: the
                  PT_KV_DTYPE env var, else the model's dtype.
    seed          engine PRNG seed for temperature / top-p sampling (the
                  key lives in a device buffer the fused graph reads:
                  `reseed()` captures nothing); greedy decode ignores it
    decode_k      fused-decode window: rows at their sampling frontier
                  take k tokens per window, one CUDA graph replay and
                  one host sync (a window that the pool or a budget
                  cuts short rides `rem` through the same graph).
                  Default: the PT_DECODE_K env var, else 1 (single
                  ticks). Admission and preemption happen at window
                  boundaries.
    sla_policy    fleet_serving.SLAPolicy for admission order
    draft_model   optional draft model (a GPTForCausalLM of the same
                  vocabulary on the same device) enabling draft-model
                  speculation (inference/speculative.py): it proposes
                  spec_k tokens per live sequence through its own
                  mirrored KV pools, the model verifies k+1 positions per
                  slot in one ragged step; greedy and sampled outputs
                  stay token-identical to the non-speculative engine.
                  decode_k is then ignored.
    spec_mode     None (speculation off unless draft_model is set, which
                  implies "draft"), "draft" (needs draft_model) or
                  "ngram": prompt-lookup proposals from each request's
                  own tokens, verified the same way
                  (inference/structured/ngram.py); "ngram" with a
                  draft_model is an error.
    spec_k        proposals per speculative window. Default: the
                  PT_SPEC_K env var, else 4. Ignored without speculation.
    token_strs    one surface string per token id (len == the model's
                  vocab): enables structured decoding (requests with
                  grammar= / json_schema=); "" marks a token no grammar
                  allows (specials, padding; the eos is allowed in
                  accepting states)
    grammar_states
                  rows of the grammar arena (>= 2; row 0 is the mask
                  identity), the most DFA states resident at once and so
                  the state budget of one grammar (grammar_states - 1).
                  Default 128. Without token_strs the arena is one row.

    Every other knob of the JAX engine raises NotImplementedError naming
    its ROADMAP row when set."""

    def __init__(self, num_slots=4, page_size=16, num_pages=None,
                 max_model_len=None, token_budget=None, kv_dtype=None,
                 seed=0, sla_policy=None, spec_k=None, spec_mode=None,
                 decode_k=None, draft_model=None, token_strs=None,
                 grammar_states=None, **unported):
        for name, value in unported.items():
            if name not in _UNPORTED_KNOBS:
                raise TypeError(
                    f"LLMEngineConfig got an unexpected keyword {name!r}")
            if value is not None:
                raise NotImplementedError(
                    f"LLMEngineConfig({name}=...) is not ported yet: "
                    f"ROADMAP {_UNPORTED_KNOBS[name]}")
        self.num_slots = int(num_slots)
        self.page_size = int(page_size)
        self.num_pages = num_pages
        self.max_model_len = max_model_len
        self.token_budget = token_budget
        if kv_dtype is not None:   # a bad name raises here, not at serve
            _qrt.resolve_kv_dtype(kv_dtype, torch.float32)
        self.kv_dtype = kv_dtype
        self.seed = int(seed)
        self.sla_policy = sla_policy
        if spec_k is None:
            spec_k = int(os.environ.get("PT_SPEC_K", "4"))
        self.spec_k = int(spec_k)
        self.draft_model = draft_model
        if spec_mode is None and draft_model is not None:
            spec_mode = "draft"
        if spec_mode not in (None, "draft", "ngram"):
            raise ValueError(
                "spec_mode must be None, 'draft', or 'ngram', got "
                f"{spec_mode!r}")
        if spec_mode == "draft" and draft_model is None:
            raise ValueError(
                "spec_mode='draft' needs draft_model= (pass "
                "spec_mode='ngram' for draft-model-free speculation)")
        if spec_mode == "ngram" and draft_model is not None:
            raise ValueError(
                "spec_mode='ngram' is draft-model-free — drop "
                "draft_model= (or use spec_mode='draft')")
        self.spec_mode = spec_mode
        self.token_strs = (None if token_strs is None
                           else list(token_strs))
        self.grammar_states = int(128 if grammar_states is None
                                  else grammar_states)
        if self.grammar_states < 2:
            raise ValueError(
                "grammar_states must be >= 2 (row 0 is the reserved "
                f"mask-identity row), got {self.grammar_states}")
        if decode_k is None:
            decode_k = int(os.environ.get("PT_DECODE_K", "1"))
        self.decode_k = int(decode_k)
        if self.num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        if self.page_size < 1:
            raise ValueError("page_size must be >= 1")
        if self.spec_k < 1:
            raise ValueError("spec_k must be >= 1")
        if self.decode_k < 1:
            raise ValueError("decode_k must be >= 1")

    @staticmethod
    def kv_bytes_per_page(model_config, page_size, kv_dtype=None):
        """Bytes ONE page costs across every layer's k+v pool, scale
        planes included: int8 rows cost head_dim + 4 bytes per head,
        packed int4 rows head_dim / 2 + 4."""
        dt, quantized = _qrt.resolve_kv_dtype(kv_dtype, torch.float32)
        nh = model_config.num_heads
        hd = model_config.hidden_size // nh
        if quantized == 4:
            per_row = nh * (hd // 2)      # packed nibbles
        else:
            per_row = nh * hd * torch.empty((), dtype=dt).element_size()
        if quantized:
            per_row += nh * 4  # fp32 scale per (row, head)
        return 2 * model_config.num_layers * page_size * per_row

    @classmethod
    def for_pool_budget(cls, model_config, budget_bytes, page_size=16,
                        kv_dtype=None, **kw):
        """Size `num_pages` to a page-pool byte budget (the equal-bytes
        capacity comparison: int8 pools admit ~4x the pages of fp32)."""
        per_page = cls.kv_bytes_per_page(model_config, page_size, kv_dtype)
        num_pages = max(2, int(budget_bytes) // per_page + 1)  # + trash
        return cls(page_size=page_size, num_pages=num_pages,
                   kv_dtype=kv_dtype, **kw)


def _check_sampling(temperature, top_p):
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")


class _PagedStep:
    """The engine's one decode step — the eager counterpart of the JAX
    package's compiled `_CompiledPagedStep`. The pools and scale planes
    are updated in place by the step (where JAX donated them to the
    executable). Returns the logits."""

    def __init__(self, model):
        self.model = model

    def __call__(self, tok, pos, sid, widx, pt, klen, smp, kv,
                 kv_scales=None):
        with torch.inference_mode():
            logits, *_ = self.model._paged_decode_core(
                tok, pos, sid, widx, pt, klen, smp, kv, kv_scales=kv_scales)
        return logits


class _Graph:
    """One captured window and every tensor whose address it holds."""

    def __init__(self, graph, emits, logits, counts, workspaces, tables):
        self.graph = graph
        self.emits = emits            # [k, S] int32, rewritten by a replay
        self.logits = logits          # k f32 frontier logits [S, vocab]
        self.counts = counts          # [(count dict, {name: launches})]
        self.workspaces = workspaces  # K1's workspace on the capture stream
        self.tables = tables          # the grammar arena's pair, or None


class _FusedStep:
    """The engine's fused k-token decode window — the counterpart of the
    JAX package's `_CompiledFusedStep` (llm_engine.py:562), whose jitted
    `lax.scan` becomes one captured `torch.cuda.CUDAGraph` of
    `_paged_decode_fused` per (greedy-or-sampled, structured-or-not)
    choice (at most four per engine, each captured at the first window
    that needs it), replayed for every later window. A window that the
    pool or a budget cuts short rides `rem` through the same graph. A
    structured graph masks each pick through the grammar arena's device
    tables, which keep their addresses for the engine's lifetime (the
    arena refreshes them in place); the other graphs hold no mask op.
    With `propose` it is the draft model's propose window
    (`inference/speculative._ProposeStep`, never masked, as in the
    reference): the static buffer carries each row's lag and frontier
    token where the fused window's carries its grammar state.

    The engine writes every per-window input into one pinned host buffer
    (`host_views`); one copy moves it into the static device buffer the
    graph reads, and one copy brings the emits back: the window's one
    sync. The key is read from the engine's device buffer, so `reseed`
    rewrites it and captures nothing.

    Capture: a warm-up run of the window on the step's private stream
    first, so one-time CUDA setup (K1's cudaFuncSetAttribute, cuBLAS's
    workspace, the ctypes loads) happens outside the capture; then the
    capture, under capture_error_mode="global", so a host sync inside the
    window fails loudly. Python's cyclic garbage collector is run before
    the capture and held off during it: a dead object that owns a CUDA
    graph (another engine's) would otherwise be freed mid-capture, and
    destroying a graph while a stream captures invalidates the capture.
    Nothing else launches on the capture stream, and each graph keeps a
    reference to every tensor whose address it holds: the static buffers
    and the key (owned here and by the engine), the grammar tables, its
    logits and emits, and K1's tensor-core workspace for the stream (the
    wrapper replaces a workspace when a call needs a larger one, and the
    graph would keep the old address). The kernel wrappers (K1's and the int8
    GEMM's) count their launches in Python, which runs only during the
    capture: the counts the capture added are taken back, and added
    again at every replay.

    On a CPU model a window runs eagerly (the tests' path). On CUDA a
    failed capture or replay raises; nothing falls back to an eager loop.
    `captures` / `warmups` / `replays` count what happened."""

    def __init__(self, model, k, page_size, num_slots, pages_per_seq, key,
                 propose=False):
        self.model = model
        self.k = int(k)
        self.page_size = int(page_size)
        self.S, self.MP = int(num_slots), int(pages_per_seq)
        self.key = key
        self.propose = bool(propose)
        self._ints = 8 if self.propose else 7     # int32 rows of [S]
        dev = model.device
        self.cuda = dev.type == "cuda"
        n = (self._ints + 2) * self.S + self.S * self.MP
        self._host = torch.zeros((n,), dtype=torch.int32,
                                 pin_memory=self.cuda)
        self._static = torch.zeros((n,), dtype=torch.int32, device=dev)
        self._stream = torch.cuda.Stream(dev) if self.cuda else None
        self._graphs = {}          # (sampled, structured) -> _Graph
        self.captures = self.warmups = self.replays = 0
        self.logits = []           # the last window's f32 logits, per tick

    def host_views(self):
        """numpy views of the host buffer the engine fills: tok0, pos0,
        rem, fin0 (1 = empty slot), eos, streams [S] int32, then gstate0
        [S] int32 (arena-absolute grammar state, 0 = unconstrained) or, in
        propose mode, lag, frontier [S] int32; temps, top_ps [S] float32,
        page_tables [S, MP] int32."""
        S, n, buf = self.S, self._ints, self._host.numpy()
        return (*buf[:n * S].reshape(n, S),
                *buf[n * S:(n + 2) * S].view(np.float32).reshape(2, S),
                buf[(n + 2) * S:].reshape(S, self.MP))

    def eager(self, kv, kv_scales, sampled, tables=None, logits_out=None):
        """The window run eagerly on the staged inputs (the warm-up, the
        capture's body, the CPU path) → emits [k, S] int32 on the pools'
        device. `tables`: the grammar arena's device (trans, mask), or
        None for a window without the mask."""
        S, n, v = self.S, self._ints, self._static
        ints = v[:n * S].view(n, S)
        tok0, pos0, rem, fin0, eos, streams = ints[:6]
        temps, top_ps = v[n * S:(n + 2) * S].view(torch.float32).view(2, S)
        if self.propose:
            mode = dict(lag=ints[6], frontier=ints[7])
        elif tables is not None:
            mode = dict(gstate0=ints[6], gtrans=tables[0], gmask=tables[1])
        else:
            mode = {}
        with torch.inference_mode():
            emits, _, _ = self.model._paged_decode_fused(
                self.k, self.page_size, tok0, pos0, rem, fin0 != 0, eos,
                temps, top_ps, streams, v[(n + 2) * S:].view(S, self.MP),
                kv, kv_scales, key=self.key if sampled else None,
                logits_out=logits_out, **mode)
        return emits

    def launch(self, kv, kv_scales, sampled, tables=None):
        """Stage the host buffer and run one window → emits [k, S] int32
        on the device, with no host sync: on the card the graph's own
        output, rewritten by the next replay. The host's choice of graph:
        `sampled` (any row's temperature > 0) and `tables` (the grammar
        arena's device pair when any row has a grammar, else None)."""
        self._static.copy_(self._host, non_blocking=self.cuda)
        if not self.cuda:
            self.logits = []
            return self.eager(kv, kv_scales, sampled, tables, self.logits)
        key = (sampled, tables is not None)
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = self._capture(kv, kv_scales, sampled,
                                                  tables)
        self.replay(g)
        self.logits = g.logits
        return g.emits

    def run(self, kv, kv_scales, sampled, tables=None):
        """`launch`, then the window's one sync → emits numpy [k, S]."""
        return self.launch(kv, kv_scales, sampled, tables).cpu().numpy()

    def replay(self, g):
        g.graph.replay()
        for counts, added in g.counts:
            for name, n in added.items():
                counts[name] += n
        self.replays += 1

    def _capture(self, kv, kv_scales, sampled, tables=None):
        from ..ops.cuda_kernels import int8_gemm as ig
        from ..ops.cuda_kernels import paged_attention as pa

        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            self.eager(kv, kv_scales, sampled, tables)  # warm-up, counted
        self.warmups += 1
        counters = (pa.launches, pa.tc_launches, ig.launches)
        before = [dict(c) for c in counters]
        graph = torch.cuda.CUDAGraph()
        logits = []
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=stream,
                                  capture_error_mode="global"):
                emits = self.eager(kv, kv_scales, sampled, tables, logits)
        finally:
            if collecting:
                gc.enable()
        counts = []
        for c, b in zip(counters, before):
            added = {name: c[name] - b[name] for name in c
                     if c[name] != b[name]}
            for name, n in added.items():
                c[name] -= n                     # the capture launched none
            counts.append((c, added))
        self.captures += 1
        return _Graph(graph, emits, logits, counts,
                      pa.stream_workspaces(stream.cuda_stream), tables)


class _Request:
    _ids = itertools.count()

    def __init__(self, tokens, max_new_tokens, eos_token_id, future,
                 tenant="default", priority=None, ttft_slo_s=None,
                 temperature=0.0, top_p=1.0):
        _check_sampling(float(temperature), float(top_p))
        # 0: greedy; > 0: sampled, keyed on (engine seed, sample_stream,
        # position), so a preemption replay draws the same tokens
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.sample_stream = 0    # engine-assigned at add_request
        self.spec_off = False     # per-request spec_mode="off" opt-out
        # structured decoding: the compiled DFA and the request's
        # grammar-LOCAL state, a pure function of the generated tokens
        # (each emitted token is replayed through `grammar.advance`), so a
        # preempted request resumes at the right state: `tokens` is kept
        self.grammar = None
        self.gstate = 0
        self.rid = next(_Request._ids)
        self.tokens = [int(t) for t in tokens]  # prompt, grows as decoded
        self.prompt_len = len(self.tokens)
        self.max_new = int(max_new_tokens)
        self.eos = eos_token_id
        self.future = future if future is not None else Future()
        self.target = None        # total-token cap, set at add_request
        self.pages = []           # physical page ids, logical order
        self.n_prefilled = 0      # kv-written tokens (reset on preempt)
        self.draft_prefilled = 0  # draft-pool valid prefix (speculation)
        self.admit_seq = None     # admission order (preemption picks max)
        self.preemptions = 0
        self.tenant = str(tenant)
        self.priority = int(Priority.STANDARD if priority is None
                            else priority)
        if self.priority < 0:
            raise ValueError(
                f"priority must be >= 0, got {self.priority} "
                "(negative ranks are reserved for SLO escalation)")
        self.ttft_slo_s = ttft_slo_s
        self._arrival = None      # scheduler enqueue stamp
        self.t_submit = _time.perf_counter()
        self.t_first_token = None

    @property
    def num_generated(self):
        return len(self.tokens) - self.prompt_len

    def result_array(self):
        return np.asarray(self.tokens, np.int64)


class LLMEngine:
    """Scheduler + paged-KV state around one decode step. Drive it
    directly —

        eng = LLMEngine(model)
        req = eng.add_request(prompt_ids, max_new_tokens=32)
        while eng.has_work():
            eng.step()
        tokens = req.future.result()

    — or through `LLMServer`. The engine runs on the model's device."""

    def __init__(self, model, config=None):
        model.eval()
        self.model = model
        self.device = model.device
        mcfg = model.config
        cfg = config or LLMEngineConfig()
        self.num_slots = cfg.num_slots
        self.page_size = cfg.page_size
        self.max_model_len = int(cfg.max_model_len or mcfg.max_seq_len)
        if self.max_model_len > mcfg.max_seq_len:
            raise ValueError(
                f"max_model_len {self.max_model_len} exceeds the model's "
                f"max_seq_len {mcfg.max_seq_len}")
        self.pages_per_seq = -(-self.max_model_len // self.page_size)
        self.token_budget = int(cfg.token_budget
                                or self.num_slots + max(self.num_slots, 8))
        if self.token_budget < self.num_slots:
            raise ValueError(
                f"token_budget {self.token_budget} < num_slots "
                f"{self.num_slots}: every running sequence needs one "
                "decode token per step")
        num_pages = int(cfg.num_pages
                        or self.num_slots * self.pages_per_seq + 1)
        self.pool = PagePool(num_pages, self.page_size)
        nh = mcfg.num_heads
        hd = mcfg.hidden_size // nh
        # pool in the configured kv_dtype (default: the model's dtype);
        # kv_quantized is the code width (0 float / 8 / 4). int4 packs two
        # nibbles per byte along head_dim, so the pool's last dim is hd/2
        # — the shape is the codec's discriminator downstream
        cache_dt, self.kv_quantized = _qrt.resolve_kv_dtype(cfg.kv_dtype,
                                                            model.dtype)
        hd_store = hd
        if self.kv_quantized == 4:
            if hd % 2:
                raise ValueError(
                    f"kv_dtype='int4' needs an even head_dim, got {hd} "
                    "(nibble packing pairs head_dim elements)")
            hd_store = hd // 2
            self.kv_dtype = "int4"
        else:
            self.kv_dtype = str(cache_dt).replace("torch.", "")
        self._pool_shape = (num_pages, self.page_size, nh, hd_store)
        self._kv = [torch.zeros(self._pool_shape, dtype=cache_dt,
                                device=self.device)
                    for _ in range(2 * mcfg.num_layers)]
        self._kv_scales = [
            torch.zeros(_qrt.kv_scale_shape(num_pages, self.page_size, nh),
                        dtype=torch.float32, device=self.device)
            for _ in range(2 * mcfg.num_layers if self.kv_quantized else 0)]
        self._page_tables = np.zeros(
            (self.num_slots, self.pages_per_seq), np.int32)
        self._slots = [None] * self.num_slots
        # sampling: the key lives in a device buffer the fused graph reads
        self._seed = cfg.seed
        self._key = prng.prng_key(cfg.seed, device=self.device)
        self._sample_streams = itertools.count()
        self.decode_k = cfg.decode_k
        self._fused_fn = None     # built at the first fused window
        self.sched = SLAScheduler(cfg.sla_policy)
        self._admit_counter = itertools.count()
        self._step_fn = _PagedStep(model)
        self.stats = {"steps": 0, "tokens_in": 0, "generated": 0,
                      "finished": 0, "preemptions": 0, "fused_steps": 0}
        # f32 frontier logits of the last tick that sampled (cross-checks;
        # a fused window's are `_fused_fn.logits`)
        self.last_logits = None
        # structured decoding (inference/structured): the grammar arena's
        # device tables are read by the fused and verify windows at a
        # fixed shape, [grammar_states, vocab] with token_strs, the lone
        # mask-identity row without. The compile cache is lock-guarded:
        # `LLMServer.submit` compiles on the caller's thread
        self.token_strs = (list(cfg.token_strs)
                           if cfg.token_strs is not None else None)
        if (self.token_strs is not None
                and len(self.token_strs) != mcfg.vocab_size):
            raise ValueError(
                f"token_strs has {len(self.token_strs)} entries but "
                f"the model vocab is {mcfg.vocab_size} — one surface "
                "string per token id")
        self.grammar_arena = GrammarArena(
            mcfg.vocab_size,
            cfg.grammar_states if self.token_strs is not None else 1,
            device=self.device)
        self._grammar_cache = GrammarCache()
        self.stats["structured_requests"] = 0
        # speculative decoding: rows at their sampling frontier take one
        # verify window per step (inference/speculative.py with a draft
        # model, inference/structured/ngram.py with prompt lookup)
        self.spec_mode = cfg.spec_mode
        self._spec = None
        if cfg.draft_model is not None:
            from .speculative import SpeculativeDecoder

            self._spec = SpeculativeDecoder(self, cfg.draft_model,
                                            cfg.spec_k)
        elif cfg.spec_mode == "ngram":
            from .structured.ngram import NgramSpeculator

            self._spec = NgramSpeculator(self, cfg.spec_k)

    def pool_bytes(self):
        """Resident KV pool bytes across layers, scale planes included."""
        total = sum(p.numel() * p.element_size()
                    for p in self._kv + self._kv_scales)
        if self._spec is not None:
            total += self._spec.pool_bytes()
        return int(total)

    @property
    def waiting(self):
        """The admission queue (supports len() / bool() / iteration)."""
        return self.sched

    # ---- structured decoding: the constraint surface ----

    def compile_constraint(self, grammar=None, json_schema=None,
                           eos_token_id=None):
        """Compile one per-request constraint to a `CompiledGrammar`
        through the engine's hash-keyed cache (a hot schema compiles once
        per engine). Thread-safe: `LLMServer.submit` calls it on the
        caller's thread, so a bad grammar raises at submit(). Raises
        GrammarError (a ValueError) for unsupported syntax or a DFA over
        the arena's state budget."""
        what = "json_schema=" if json_schema is not None else "grammar="
        if self.token_strs is None:
            raise GrammarError(
                f"{what}: this engine has no token_strs — pass "
                "LLMEngineConfig(token_strs=[...]) to enable structured "
                "decoding")
        if isinstance(grammar, CompiledGrammar):
            if grammar.vocab != len(self.token_strs):
                raise GrammarError(
                    f"grammar=: CompiledGrammar vocab {grammar.vocab} "
                    f"!= engine vocab {len(self.token_strs)}")
            return grammar
        if eos_token_id is None:
            raise GrammarError(
                f"{what}: constrained decoding needs eos_token_id= (the "
                "grammar decides WHEN the output is complete by "
                "unmasking eos in accepting states)")
        pattern = (grammar if grammar is not None
                   else schema_to_regex(json_schema))
        ck = (pattern, int(eos_token_id))
        hit = self._grammar_cache.lookup(ck)
        if hit is not None:
            return hit
        # compiled outside the cache's lock (host work, possibly slow); a
        # racing duplicate compile is wasted work, not corruption
        try:
            cg = compile_regex(pattern, self.token_strs,
                               eos_id=int(eos_token_id),
                               max_states=self.grammar_arena.capacity)
        except GrammarError:
            self._grammar_cache.reject()
            raise
        return self._grammar_cache.insert(ck, cg)

    def _resolve_constraint(self, grammar, json_schema, eos_token_id,
                            spec_mode):
        """The submit gate of `add_request` and `LLMServer.submit`:
        structural validation, the engine-context checks and the grammar
        compile. Returns the CompiledGrammar or None."""
        validate_constraints(grammar=grammar, json_schema=json_schema,
                             spec_mode=spec_mode)
        if spec_mode not in (None, "off") and spec_mode != (
                self.spec_mode or "off"):
            raise ValueError(
                f"spec_mode={spec_mode!r}: this engine runs "
                f"spec_mode={self.spec_mode!r} — speculation is an "
                "engine resource; per-request spec_mode can only "
                "opt OUT ('off') or restate the engine's mode")
        if grammar is None and json_schema is None:
            return None
        return self.compile_constraint(grammar=grammar,
                                       json_schema=json_schema,
                                       eos_token_id=eos_token_id)

    def _live_grammar_hashes(self):
        """Hashes of grammars still referenced by queued or running
        requests — what arena compaction must keep."""
        live = {r.grammar.hash for r in self._slots
                if r is not None and r.grammar is not None}
        live.update(r.grammar.hash for r in self.sched
                    if r.grammar is not None)
        return live

    def _grammar_args(self, rows):
        """Per-window grammar inputs of the fused and verify steps: the
        arena-absolute DFA state of each slot, int32 [num_slots] (0 = the
        mask-identity row: empty and unconstrained slots), and the arena's
        device (trans, mask) when a row of `rows` has a grammar, else None
        — the reference's lax.cond on any(gstate > 0), decided on the
        host: the window then runs without a mask op. Reading the tables
        copies the rows the arena changed into them, in place."""
        gst = np.zeros((self.num_slots,), np.int32)
        for slot, req in rows:
            if req.grammar is not None:
                gst[slot] = (self.grammar_arena.base_of(req.grammar)
                             + req.gstate)
        tables = self.grammar_arena.device_tables() if gst.any() else None
        return gst, tables

    def _structured_metrics(self):
        """The structured-decoding block of the reference's `metrics()`
        (ROADMAP A10 ports `metrics()` itself): None unless the engine has
        token_strs. Engine-local counts."""
        if self.token_strs is None:
            return None
        gc_ = self._grammar_cache.snapshot()
        return {
            "grammars_resident": len(self.grammar_arena._loaded),
            "states_used": self.grammar_arena.states_used,
            "state_budget": self.grammar_arena.n_states,
            "requests": self.stats.get("structured_requests", 0),
            "compiles": gc_["compiles"],
            "cache_hits": gc_["cache_hits"],
            "rejects": gc_["rejects"],
        }

    # ---- client side ----

    def add_request(self, prompt, max_new_tokens=32, eos_token_id=None,
                    future=None, tenant="default", priority=None,
                    ttft_slo_s=None, temperature=0.0, top_p=1.0,
                    spec_mode=None, grammar=None, json_schema=None):
        """Enqueue one request (1-D int token ids); returns the
        `_Request`, whose `future` resolves to np.int64 [prompt +
        generated].

        spec_mode: per-request speculation override — None inherits the
        engine's mode; "off" disables proposals for this request; the
        engine's own mode is accepted; any other mode raises
        (speculation is an engine resource).

        grammar: a regex string (or a structured.CompiledGrammar)
        constraining the generated tokens; json_schema: a JSON-schema
        dict lowered to one (canonical no-whitespace JSON). At most one of
        the two; both need LLMEngineConfig(token_strs=...) and an
        eos_token_id. The grammar compiles and loads into the arena here,
        so a bad or oversized one raises here."""
        grammar_obj = self._resolve_constraint(grammar, json_schema,
                                               eos_token_id, spec_mode)
        toks = np.asarray(prompt).reshape(-1)
        if toks.size == 0:
            raise ValueError("empty prompt")
        if toks.size > self.max_model_len:
            raise ValueError(
                f"prompt length {toks.size} exceeds max_model_len "
                f"{self.max_model_len}")
        if -(-int(toks.size) // self.page_size) > self.pool.num_pages - 1:
            raise ValueError(
                f"prompt needs more KV pages than the pool holds "
                f"({self.pool.num_pages - 1})")
        req = _Request(toks, max_new_tokens, eos_token_id, future,
                       tenant=tenant, priority=priority,
                       ttft_slo_s=ttft_slo_s, temperature=temperature,
                       top_p=top_p)
        # one sampling stream per request, kept across preemption replays
        req.sample_stream = next(self._sample_streams)
        req.spec_off = spec_mode == "off"
        req.target = min(req.prompt_len + req.max_new, self.max_model_len)
        if grammar_obj is not None:
            # loaded now (GrammarError at submit, not mid-serve); the
            # device tables take the rows at the next constrained window
            req.grammar = grammar_obj
            try:
                self.grammar_arena.load(
                    grammar_obj, live=self._live_grammar_hashes())
            except Exception:
                self._grammar_cache.reject()
                raise
            self.stats["structured_requests"] += 1
        if req.target <= req.prompt_len:
            # zero budget: the prompt echoes back
            if not req.future.cancelled():
                req.future.set_result(req.result_array())
            return req
        self.sched.enqueue(req)
        return req

    def has_work(self):
        return bool(self.waiting) or any(r is not None for r in self._slots)

    def reseed(self, seed):
        """Swap the sampling key. It lives in a device buffer that the
        fused graphs read, so this rewrites the buffer and captures
        nothing."""
        self._seed = int(seed)
        self._key.copy_(prng.prng_key(self._seed))

    def abort_all(self, exc):
        """Fail every live and queued request with `exc` (device-error
        path), release all pages, re-zero the pools and scale planes (the
        draft's too) — a step that died mid-write leaves them half
        updated — in place, so the fused and propose graphs stay valid,
        and restore the sampling key."""
        for slot, req in enumerate(self._slots):
            if req is not None:
                self._release(slot, req)
                if not req.future.done():
                    req.future.set_exception(exc)
        for req in self.sched.drain():
            if not req.future.done():
                req.future.set_exception(exc)
        with torch.inference_mode():
            for p in self._kv + self._kv_scales:
                p.zero_()
        if self._spec is not None:
            self._spec.reset_pools()
        self.reseed(self._seed)

    # ---- scheduler ----

    def _release(self, slot, req):
        self.pool.free(req.pages)
        req.pages = []
        req.n_prefilled = 0
        req.draft_prefilled = 0   # a replay re-prefills both pools
        self._page_tables[slot, :] = 0
        self._slots[slot] = None

    def _finish(self, slot, req):
        self._release(slot, req)
        self.stats["finished"] += 1
        # a client may have cancel()ed while the request was in flight
        if not req.future.cancelled():
            req.future.set_result(req.result_array())

    def _preempt(self, slot, req, reason):
        """Evict-and-requeue one running sequence. Its generated tokens
        and its sampling stream are kept: the re-decode of
        prompt+generated reproduces the same continuation, greedy or
        sampled."""
        self._release(slot, req)
        req.preemptions += 1
        self.stats["preemptions"] += 1
        self.sched.note_preemption(reason)
        self.sched.push_front(req)

    def _preempt_one(self, keep_req, worse_than=None, reason="pool",
                     allow_equal=False):
        """Preempt the scheduler's victim pick (lowest priority class,
        then youngest). False when there is no legal victim."""
        pick = self.sched.pick_victim(
            self._slots, keep=keep_req, worse_than=worse_than,
            now=_time.perf_counter(), allow_equal=allow_equal)
        if pick is None:
            return False
        self._preempt(*pick, reason=reason)
        return True

    def _try_admit(self, req):
        """Place one popped request into a slot (the JAX engine's branch
        without prefix cache and without KV import): page-fit check with
        lowest-priority preemption as the pressure valve, then page-table
        setup. False when the request cannot be placed yet."""
        now = _time.perf_counter()
        victims = [r for r in self._slots
                   if r is not None and self.sched.less_urgent(r, req, now)]
        no_slot = None not in self._slots
        if no_slot and not victims:
            return False
        # feasibility first: preempting a runner destroys its progress,
        # so evict only when a slot and enough pages can exist. With
        # speculation, one page of headroom per live frontier slot stays
        # free, so a burst of admissions cannot drain the pool to where
        # every verify window collapses to width 0
        headroom = (self._spec.window_headroom()
                    if self._spec is not None else 0)
        need = -(-len(req.tokens) // self.page_size) + headroom
        if (self.pool.num_free < need
                and self.pool.num_free + sum(len(r.pages) for r in victims)
                < need):
            return False
        if no_slot and not self._preempt_one(None, worse_than=req,
                                             reason="priority"):
            return False
        while self.pool.num_free < need:
            if not self._preempt_one(None, worse_than=req,
                                     reason="priority"):
                return False
        slot = self._slots.index(None)
        req.admit_seq = next(self._admit_counter)
        req.pages = []
        req.n_prefilled = 0
        req.draft_prefilled = 0
        self._page_tables[slot, :] = 0
        self._slots[slot] = req
        return True

    def _admit(self):
        now = _time.perf_counter()
        while self.sched:
            req = self.sched.pop_next(now)
            if req is None:
                break
            if not self._try_admit(req):
                self.sched.push_front(req)
                break

    def _active(self):
        """Running sequences in admission order (deterministic plan)."""
        return sorted(((slot, req) for slot, req in enumerate(self._slots)
                       if req is not None), key=lambda it: it[1].admit_seq)

    def _plan(self, only_slots=None):
        """Allot this step's flat token budget: one frontier token per
        running sequence first, then chunked prefill in admission order.
        Allocates the pages the planned tokens will write; a dry pool
        preempts the youngest sequence and replans. `only_slots`
        restricts the plan to those slots (the straggler tick of a
        speculative step: the frontier rows already took their window);
        victims of a dry pool are still picked from all running
        sequences."""
        while True:
            active = self._active()
            if only_slots is not None:
                active = [(s, r) for s, r in active if s in only_slots]
            if not active:
                return None
            alloc = {}
            budget = self.token_budget - len(active)
            for slot, req in active:
                remaining = len(req.tokens) - req.n_prefilled
                take = 1 + min(remaining - 1, budget)
                budget -= take - 1
                alloc[slot] = take
            ok = True
            for slot, req in active:
                last = req.n_prefilled + alloc[slot] - 1
                try:
                    while last // self.page_size >= len(req.pages):
                        page = self.pool.alloc()
                        self._page_tables[slot, len(req.pages)] = page
                        req.pages.append(page)
                except PoolExhausted:
                    # the victim may be no more urgent than the growing
                    # sequence (equal urgency: preempt-youngest)
                    if not self._preempt_one(req, worse_than=req,
                                             allow_equal=True):
                        kept = -(-len(req.tokens) // self.page_size)
                        if (kept <= self.pool.num_pages - 1
                                and any(r is not None and r is not req
                                        for r in self._slots)):
                            # every other runner outranks req: req
                            # itself yields its pages and requeues
                            self._preempt(slot, req, reason="pool")
                        else:
                            # kept tokens outgrew the whole pool
                            self._release(slot, req)
                            if not req.future.done():
                                req.future.set_exception(PoolExhausted(
                                    f"request {req.rid} needs more KV "
                                    "pages than the pool holds"))
                    ok = False
                    break
            if ok:
                return [(slot, req, alloc[slot]) for slot, req in active]

    def step(self):
        """One scheduler tick: admit (new and preempted sequences join
        only here, at window boundaries) → either one multi-token window
        over the rows at their sampling frontier — speculative with
        `spec_mode`, else fused when decode_k > 1 — or one decode step
        over the planned flat tokens with a pick at each frontier → evict
        finished. Rows still prefilling take a single tick in the same
        step (`only_slots`), so a straggler does not force the whole
        engine off windows; a window that cannot cover even one token per
        row returns None and the step runs a single tick, which owns
        preemption. Returns the requests finished."""
        self._admit()
        if self._spec is not None or self.decode_k > 1:
            active = self._active()
            frontier = [(s, r) for s, r in active
                        if r.n_prefilled == len(r.tokens) - 1]
            if frontier:
                out = (self._spec.try_window(frontier)
                       if self._spec is not None
                       else self._try_step_fused(frontier))
                if out is not None:
                    stragglers = {s for s, r in active
                                  if r.n_prefilled != len(r.tokens) - 1}
                    if stragglers:
                        out = out + self._step_tick(only_slots=stragglers)
                    return out
        return self._step_tick()

    # ---- fused multi-token decode window ----

    def _try_step_fused(self, active):
        """One fused decode window over `active` (the frontier rows), or
        None when the pool cannot cover even a 1-token window. The
        window's pages are reserved up front; when the pool (or a
        sequence's budget) cannot cover k, the window spills to the k'
        that fits through `rem`, in the same graph."""
        ps = self.page_size
        k = self.decode_k

        def pages_needed(w):
            tot = 0
            for _, req in active:
                writes = min(w, req.target - len(req.tokens))
                last = req.n_prefilled + writes - 1
                tot += max(0, last // ps + 1 - len(req.pages))
            return tot

        avail = self.pool.num_free
        w = k
        while w > 1 and pages_needed(w) > avail:
            w -= 1        # spill: the largest window the pool covers
        if pages_needed(w) > avail:
            return None   # not even 1 token a row: the single tick preempts
        rem_arg = {}
        for slot, req in active:
            want = min(w, req.target - len(req.tokens))
            last = req.n_prefilled + want - 1
            while last // ps >= len(req.pages):
                page = self.pool.alloc()
                self._page_tables[slot, len(req.pages)] = page
                req.pages.append(page)
            rem_arg[slot] = want

        if self._fused_fn is None:
            self._fused_fn = _FusedStep(self.model, k, ps, self.num_slots,
                                        self.pages_per_seq, self._key)
        fused = self._fused_fn
        tok0, pos0, rem, fin0, eos, streams, gstate, temps, tops, pt = \
            fused.host_views()
        for col, empty in ((tok0, 0), (pos0, 0), (rem, 0), (fin0, 1),
                           (eos, -1), (streams, 0), (temps, 0.0),
                           (tops, 1.0)):
            col[:] = empty            # an empty slot: finished, greedy
        pt[:] = self._page_tables
        gstate[:], tables = self._grammar_args(active)
        gen_before = {}
        for slot, req in active:
            tok0[slot] = req.tokens[-1]
            pos0[slot] = req.n_prefilled
            rem[slot] = rem_arg[slot]
            fin0[slot] = 0
            if req.eos is not None:
                eos[slot] = int(req.eos)
            temps[slot] = req.temperature
            tops[slot] = req.top_p
            streams[slot] = req.sample_stream
            gen_before[slot] = req.num_generated
        t0 = _time.perf_counter()
        try:
            emits = fused.run(self._kv, self._kv_scales or None,
                              any(r.temperature > 0 for _, r in active),
                              tables)
        except Exception as e:
            # the pools may be half written: fail the in-flight work and
            # re-zero, as the single tick does
            self.abort_all(e)
            raise
        # window-boundary SLO accounting: how long a window runs
        self.sched.note_boundary(_time.perf_counter() - t0)

        self.stats["steps"] += 1
        self.stats["fused_steps"] += 1
        finished = []
        now = _time.perf_counter()
        total = 0
        for slot, req in active:
            emitted, done = 0, False
            for j in range(int(rem_arg[slot])):
                t = int(emits[j, slot])
                req.tokens.append(t)
                if req.grammar is not None:
                    # the window's DFA advance, replayed on the host
                    req.gstate = req.grammar.advance(req.gstate, t)
                emitted += 1
                if ((req.eos is not None and t == req.eos)
                        or len(req.tokens) >= req.target):
                    done = True   # the window masked the rest already
                    break
            req.n_prefilled += emitted
            total += emitted
            self.stats["generated"] += emitted
            self.sched.note_tokens(req.tenant, emitted)
            if gen_before[slot] == 0 and emitted > 0:
                req.t_first_token = now
                self.sched.note_first_token(req, now - req.t_submit)
            if done:
                self._finish(slot, req)
                finished.append(req)
        self.stats["tokens_in"] += total
        return finished

    # ---- single tick (prefill / mixed / k=1) ----

    def _host_sample_rows(self, lv, reqs):
        """The tick's frontier picks when a row samples: the same
        `sample_tokens` as the fused window, keyed on the same engine key
        at each row's position (the index its new token takes), so a
        request draws the same tokens whichever path serves a tick. Padded
        to num_slots rows (pad rows greedy), as the reference pads its
        jitted sampler; the per-row inputs make one copy to the device."""
        n, S = len(reqs), self.num_slots
        buf = np.zeros((4, S), np.int32)     # temps, top_ps, streams, pos
        f = buf[:2].view(np.float32)
        f[1] = 1.0
        for j, r in enumerate(reqs):
            f[0, j] = r.temperature
            f[1, j] = r.top_p
            buf[2, j] = r.sample_stream
            buf[3, j] = len(r.tokens)
        dev = torch.from_numpy(buf).to(self.device)
        temps, tops = dev[:2].view(torch.float32)
        lv = torch.nn.functional.pad(lv, (0, 0, 0, S - n))
        return sample_tokens(lv, temps, tops, dev[2], dev[3],
                             self._key)[:n]

    def _mask_rows(self, lv, reqs):
        """The tick's grammar mask (the reference's llm_engine.py:2664):
        each constrained row's allowed tokens at its DFA state
        (`CompiledGrammar.allowed_np`, all True for the other rows), built
        on the host, one copy to the device, and applied to the logits as
        `sample_tokens(allowed=)` applies the windows' mask."""
        allow = np.ones(tuple(lv.shape), bool)
        for j, r in enumerate(reqs):
            if r.grammar is not None:
                allow[j] = r.grammar.allowed_np(r.gstate)
        return torch.where(torch.from_numpy(allow).to(self.device), lv,
                           -1e30)

    def _step_tick(self, only_slots=None):
        plan = self._plan(only_slots)
        if plan is None:
            return []
        T, S, MP = self.token_budget, self.num_slots, self.pages_per_seq
        ps = self.page_size
        # every per-tick index array in ONE host buffer → one copy to the
        # device: tok, pos, sid, widx, klen [T] | sample_idx [S] | tables
        buf = np.zeros((5 * T + S + S * MP,), np.int32)
        tok, pos, sid, widx, klen = buf[:5 * T].reshape(5, T)
        sample_idx = buf[5 * T:5 * T + S]
        buf[5 * T + S:] = self._page_tables.reshape(-1)
        sample_slots = []
        i = 0
        for slot, req, take in plan:
            for k in range(take):
                p = req.n_prefilled + k
                tok[i] = req.tokens[p]
                pos[i] = p
                sid[i] = slot
                widx[i] = req.pages[p // ps] * ps + p % ps
                klen[i] = p + 1
                if p == len(req.tokens) - 1:
                    # per-SLOT sampling frontier: the vocab head runs only
                    # on these gathered rows
                    sample_idx[slot] = i
                    sample_slots.append(slot)
                i += 1
        # rows past i stay 0: padding tokens (kv_len 0) writing trash row 0
        dev = torch.from_numpy(buf).to(self.device)
        tok_d, pos_d, sid_d, widx_d, klen_d = dev[:5 * T].view(5, T)
        smp_d = dev[5 * T:5 * T + S]
        pt_d = dev[5 * T + S:].view(S, MP)
        try:
            logits = self._step_fn(tok_d, pos_d, sid_d, widx_d, pt_d,
                                   klen_d, smp_d, self._kv,
                                   self._kv_scales or None)
            nxt = []
            if sample_slots:
                lv = logits[0, sample_slots].float()
                self.last_logits = lv
                reqs = [self._slots[s] for s in sample_slots]
                if any(r.grammar is not None for r in reqs):
                    lv = self._mask_rows(lv, reqs)
                if any(r.temperature > 0 for r in reqs):
                    nxt = self._host_sample_rows(lv, reqs)
                else:
                    nxt = lv.argmax(dim=-1)
                nxt = nxt.tolist()   # the tick's one sync
        except Exception as e:
            # the pools may be half written: fail the in-flight work and
            # re-zero so a direct-drive caller's engine stays serviceable
            self.abort_all(e)
            raise

        self.stats["steps"] += 1
        self.stats["tokens_in"] += i
        finished = []
        for slot, req, take in plan:
            req.n_prefilled += take
            self.sched.note_tokens(req.tenant, take)
        now = _time.perf_counter()
        for slot, t in zip(sample_slots, nxt):
            req = self._slots[slot]
            req.tokens.append(int(t))
            if req.grammar is not None:
                req.gstate = req.grammar.advance(req.gstate, int(t))
            self.stats["generated"] += 1
            if req.num_generated == 1:      # replays don't re-count
                req.t_first_token = now
                self.sched.note_first_token(req, now - req.t_submit)
            if ((req.eos is not None and t == req.eos)
                    or len(req.tokens) >= req.target):
                self._finish(slot, req)
                finished.append(req)
        return finished


class LLMServer(_FutureQueueServer):
    """Continuous-batching text-generation server: one background thread
    owns an `LLMEngine`; `submit` is thread-safe."""

    _thread_name = "llm-engine"

    def __init__(self, model, config=None):
        super().__init__()
        self._engine = LLMEngine(model, config)
        self.stats = self._engine.stats
        self.stats.setdefault("requests", 0)

    @property
    def engine(self):
        return self._engine

    def submit(self, prompt, max_new_tokens=32, eos_token_id=None,
               tenant="default", priority=None, ttft_slo_s=None,
               temperature=0.0, top_p=1.0, spec_mode=None, grammar=None,
               json_schema=None):
        """Enqueue one prompt (1-D int token ids). Returns a Future
        resolving to np.int64 [prompt + generated] (eos kept, nothing
        after it). The sampling knobs and the constraint kwargs
        (`grammar=`, `json_schema=`, `spec_mode=`; see
        `LLMEngine.add_request`) are checked, and the grammar compiled,
        here on the caller's thread, so a bad one raises at submit() and
        never inside the serve loop. The engine-side `_Request` is
        attached to the future as `fut.pt_request` once the engine thread
        has taken it in."""
        _check_sampling(float(temperature), float(top_p))
        grammar = self._engine._resolve_constraint(
            grammar, json_schema, eos_token_id, spec_mode)
        fut = Future()
        fut.pt_request = None
        self._enqueue(dict(
            prompt=np.asarray(prompt).reshape(-1),
            max_new_tokens=int(max_new_tokens), eos_token_id=eos_token_id,
            future=fut, tenant=tenant, priority=priority,
            ttft_slo_s=ttft_slo_s, temperature=float(temperature),
            top_p=float(top_p), spec_mode=spec_mode, grammar=grammar))
        return fut

    def generate(self, prompt, max_new_tokens=32, eos_token_id=None):
        return self.submit(prompt, max_new_tokens, eos_token_id).result()

    def _ingest(self, payload):
        fut = payload.pop("future")
        if fut.cancelled():
            return
        try:
            fut.pt_request = self._engine.add_request(future=fut,
                                                      **payload)
            self.stats["requests"] += 1
        except Exception as e:  # a bad request must not kill the loop
            if not fut.done():
                fut.set_exception(e)

    def _loop(self):
        eng = self._engine
        while self._running or not self._q.empty() or eng.has_work():
            try:
                while True:
                    self._ingest(self._q.get_nowait())
            except queue.Empty:
                pass
            if not eng.has_work():
                try:   # idle: block briefly for the next submission
                    self._ingest(self._q.get(timeout=0.05))
                except queue.Empty:
                    continue
            try:
                eng.step()
            except Exception as e:
                # fail every in-flight future with the error (it re-raises
                # at each caller's result()); the loop keeps serving
                eng.abort_all(e)
