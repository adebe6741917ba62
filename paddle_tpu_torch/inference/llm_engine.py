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
* Shared-prefix radix KV cache (`LLMEngineConfig(prefix_cache=True)` /
  PT_PREFIX_CACHE) — fleet_serving.RadixPrefixCache indexes full prompt
  pages by token content; a request whose prompt prefix is resident
  maps the shared pages copy-on-write into its page table and skips
  their prefill. Pages are shared by page-table aliasing and refcounts
  only: no kernel changes, the graphs keep their inputs.
* The KV wire — `add_request(prefill_only=True)` prefills up to the
  sampling frontier and resolves to a `fleet_serving.KVPagePayload`
  (`export_kv_pages`: one gather of exactly the request's pages, one
  copy to the host); `add_request(kv_import=payload)` /
  `import_kv_pages` writes a payload's pages into freshly allocated
  pages IN PLACE (`index_copy_` into the existing pools: the captured
  graphs hold the pools' addresses) and decodes from its frontier.
* The KV tier — `kv_tier=` spills evicted trie nodes to host RAM and
  disk (`fleet_serving.KVTierStore`; the snapshot is `_gather_pages`,
  ordered on the engine's stream) and prefetches them back through
  `_write_imported_pages` at admission. Chat sessions — `session_id=`
  pins a finished turn's blocks, generated tokens included, so the next
  turn resumes from the conversation's frontier.
* Overload surface — `abort(rid)`, hard deadlines (`deadline_s`),
  brownout caps (`apply_brownout`; L4 sheds session pinning), the
  process-wide `pt_*` metrics of the port's registry
  (observability/metrics.py), `metrics()` and `LLMServer.
  start_metrics_http`.

On the card each engine runs its steps on a stream of its own, so the
replicas of one process (fleet_serving.replica) never share K1's
per-stream workspace, and every step holds a share of the process-wide
device gate (`_GATE`), which a graph capture takes exclusively: no other
thread launches or syncs while a window is captured.

    server = LLMServer(model)                  # GPTForCausalLM
    with server:
        fut = server.submit(prompt_ids, max_new_tokens=64)
        tokens = fut.result()   # np.int64 [prompt + generated]

Greedy decode is token-for-token identical to the JAX package's engine
(tests/test_torch_llm_engine.py); eos semantics follow its contract
(the emitted eos is kept, nothing after it).
"""
import collections
import contextlib
import gc
import itertools
import os
import queue
import threading
import time as _time
import weakref
from concurrent.futures import Future

import numpy as np
import torch

from ..core import prng
from ..observability import flight_recorder as _fr
from ..observability import metrics as _obs
from ..observability import reqtrace as _reqtrace
from ..observability.tracing import trace_span as _trace_span
from ..quantization import runtime as _qrt
from ..text.models.gpt import sample_tokens
from .fleet_serving.overload import (RequestCancelled, RequestShed,
                                     note_cancelled, note_shed)
from .fleet_serving.kv_tier import (_SESSION_ACTIVE, _SESSION_RESUMED,
                                    _TIER_BYTES, _TIER_EVICTIONS,
                                    _TIER_HITS, _TIER_PAGES, KVTierStore,
                                    prefix_key)
from .fleet_serving.prefix_cache import RadixPrefixCache
from .fleet_serving.scheduler import Priority, SLAScheduler
from .serving import _FutureQueueServer
from .structured import (CompiledGrammar, GrammarArena, GrammarError,
                         compile_regex, schema_to_regex,
                         validate_constraints)
from .structured.arena import GrammarCache
from .structured.compiler import _STRUCT_CACHE_HITS, _STRUCT_REQS

__all__ = ["PagePool", "PoolExhausted", "LLMEngineConfig", "LLMEngine",
           "LLMServer", "SUBMIT_KWARGS"]

# the reference's serving metrics, by name, in the port's registry
_REQS_TOTAL = _obs.counter("pt_llm_requests_total", "requests accepted")
_FINISHED_TOTAL = _obs.counter("pt_llm_finished_total",
                               "requests finished (eos or budget)")
_PREEMPTIONS_TOTAL = _obs.counter(
    "pt_llm_preemptions_total", "sequences preempted on a dry page pool")
_STEPS_TOTAL = _obs.counter("pt_llm_steps_total", "scheduler ticks")
_ABORTS_TOTAL = _obs.counter("pt_llm_aborts_total",
                             "abort_all events (device-error path)")
_TOKENS_TOTAL = _obs.counter(
    "pt_llm_tokens_total",
    "flat tokens through the decode step: one decode token per "
    "sampling frontier, the rest chunked prefill",
    labelnames=("phase",))
_QUEUE_DEPTH = _obs.gauge("pt_llm_queue_depth", "requests waiting")
_LIVE_SLOTS = _obs.gauge("pt_llm_live_slots", "sequences decoding")
_SLOT_OCC = _obs.gauge("pt_llm_slot_occupancy",
                       "live slots / num_slots, last tick")
_PAGE_OCC = _obs.gauge("pt_llm_kv_page_occupancy",
                       "live KV pages / allocable pages")
_PAGE_FRAG = _obs.gauge(
    "pt_llm_kv_fragmentation",
    "internal fragmentation: 1 - written tokens / live page capacity")
_ADMIT_SECONDS = _obs.histogram("pt_llm_admission_seconds",
                                "submit -> first decode-slot admission")
_TTFT_SECONDS = _obs.histogram("pt_llm_ttft_seconds",
                               "submit -> first generated token")
_REQ_TOK_RATE = _obs.histogram(
    "pt_llm_request_tokens_per_sec",
    "per-request generated tok/s (admission -> finish)",
    buckets=(1, 2, 5, 10, 20, 50, 100, 200, 500, 1000, 2000, 5000,
             10000))
_KV_POOL_BYTES = _obs.gauge(
    "pt_kv_pool_bytes",
    "resident KV page-pool bytes (pools + scale planes), by the pool "
    "dtype", labelnames=("dtype",))
_FUSED_STEPS = _obs.counter(
    "pt_decode_fused_steps",
    "fused k-step decode windows dispatched (one host sync per window)")
_DISPATCHES = _obs.counter(
    "pt_decode_dispatches_total",
    "decode-step dispatches (host round trips), single tick or fused "
    "window")
_TOK_PER_DISPATCH = _obs.gauge(
    "pt_decode_tokens_per_dispatch",
    "generated tokens the last decode-step dispatch produced")


class PoolExhausted(RuntimeError):
    """No free KV pages (the scheduler preempts and retries on this)."""


def _payload_trace(payload):
    """The TraceContext a KVPagePayload carries (restored once and
    cached on the payload), or None: the disaggregated hand-off keeps the
    prefill side's trace, at `LLMServer.submit` and `add_request` alike."""
    ctx = getattr(payload, "trace_ctx", None)
    if ctx is None and getattr(payload, "trace", None):
        ctx = _reqtrace.TraceContext.from_dict(payload.trace)
        payload.trace_ctx = ctx
    return ctx


# the numpy dtype a pool's bytes travel as on the KV wire (numpy has no
# bfloat16: a bf16 pool travels as its 2-byte words)
_NP_CARRIER = {torch.float32: np.float32, torch.bfloat16: np.uint16,
               torch.float16: np.float16, torch.int8: np.int8}


def _np_carrier(t):
    return _NP_CARRIER[t.dtype]


class _DeviceGate:
    """The process-wide gate between engine steps and graph captures on
    the card. Every step holds a share (`shared`, re-entrant per thread);
    `_FusedStep._capture` takes it exclusively (`exclusive`), giving up
    the calling thread's own share for the time of the capture and taking
    it back after. So while a window is captured no other replica's
    thread is inside a step: none launches into the capture's window
    (the capture's launch counts stay its own), none makes a host sync
    (under capture_error_mode="global" that would fail the capture) and
    none captures at the same time (the collector hold-off is one
    process-wide switch). A waiting capture holds new shares back, so a
    busy fleet cannot starve it; other threads pause at a step boundary
    for the time of one capture."""

    def __init__(self):
        self._cv = threading.Condition()
        self._shared = 0
        self._exclusive = False
        self._waiting = 0          # captures waiting for the gate
        self._tls = threading.local()

    @contextlib.contextmanager
    def shared(self):
        depth = getattr(self._tls, "depth", 0)
        if depth == 0:
            with self._cv:
                while self._exclusive or self._waiting:
                    self._cv.wait()
                self._shared += 1
        self._tls.depth = depth + 1
        try:
            yield
        finally:
            self._tls.depth = depth
            if depth == 0:
                with self._cv:
                    self._shared -= 1
                    self._cv.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        held = getattr(self._tls, "depth", 0) > 0
        with self._cv:
            if held:
                self._shared -= 1
                self._cv.notify_all()
            self._waiting += 1
            while self._exclusive or self._shared:
                self._cv.wait()
            self._waiting -= 1
            self._exclusive = True
        try:
            yield
        finally:
            with self._cv:
                self._exclusive = False
                if held:
                    self._shared += 1
                self._cv.notify_all()


_GATE = _DeviceGate()

# cuda_stream handle -> weakref to the live engine or window that owns it
_STREAM_OWNERS = {}
_STREAM_LOCK = threading.Lock()


def _private_stream(owner, device):
    """A CUDA stream no other live engine or window owns. torch hands
    streams out of a small per-device pool, round robin, so two objects
    can be given the same stream; K1's tensor-core workspace is one per
    stream, and a captured window keeps its capture stream's workspace.
    Two live owners of one stream would share a workspace between
    replicas stepping on different threads. Raises when the pool holds no
    free stream."""
    for attempt in range(2):
        if attempt:
            gc.collect()       # owners dead in reference cycles let go
        with _STREAM_LOCK:
            # the pool's round robin visits every stream of both
            # priorities within this many draws
            for i in range(128):
                stream = torch.cuda.Stream(device, priority=-(i % 2))
                held = _STREAM_OWNERS.get(stream.cuda_stream)
                if held is None or held() is None:
                    _STREAM_OWNERS[stream.cuda_stream] = weakref.ref(owner)
                    return stream
    raise RuntimeError(
        "no CUDA stream of the pool is free: too many live engines")


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

    @property
    def num_shared(self):
        # list() copy: a metrics scrape reads this from another thread
        return sum(1 for c in list(self._ref.values()) if c > 1)

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
    prefix_cache  shared-prefix radix KV cache over the page pool
                  (fleet_serving.RadixPrefixCache): full prompt blocks
                  are indexed by token content and mapped copy-on-write
                  into later requests' page tables, skipping their
                  prefill. Default: the PT_PREFIX_CACHE env var
                  (1 / true / yes / on), else off.
    hash_block_tokens
                  trie block size in tokens; must be a multiple of
                  page_size when the cache is on. Default page_size.
    kv_tier       KV memory below the device pool
                  (fleet_serving.kv_tier). Falsy (default) = off. True
                  enables the host-RAM spill tier with its defaults; a
                  dict passes `KVTierStore` knobs through (`ram_bytes`,
                  `disk_dir`, `disk_bytes`, `max_pending`, `mmap`).
                  Requires prefix_cache: the tier spills and prefetches
                  trie nodes.
    session_ttl_s chat-session TTL: seconds a session stays tracked
                  after its last turn (default 600). See
                  `add_request(session_id=)`.
    session_max   LRU cap on tracked sessions (default 256)."""

    def __init__(self, num_slots=4, page_size=16, num_pages=None,
                 max_model_len=None, token_budget=None, kv_dtype=None,
                 seed=0, sla_policy=None, spec_k=None, spec_mode=None,
                 decode_k=None, draft_model=None, token_strs=None,
                 grammar_states=None, prefix_cache=None,
                 hash_block_tokens=None, kv_tier=None,
                 session_ttl_s=None, session_max=None):
        self.num_slots = int(num_slots)
        self.page_size = int(page_size)
        self.num_pages = num_pages
        self.max_model_len = max_model_len
        self.token_budget = token_budget
        if prefix_cache is None:
            prefix_cache = os.environ.get(
                "PT_PREFIX_CACHE", "0").strip().lower() in (
                    "1", "true", "yes", "on")
        self.prefix_cache = bool(prefix_cache)
        self.hash_block_tokens = int(
            self.page_size if hash_block_tokens is None
            else hash_block_tokens)
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
        self.kv_tier = kv_tier
        self.session_ttl_s = float(600.0 if session_ttl_s is None
                                   else session_ttl_s)
        self.session_max = int(256 if session_max is None
                               else session_max)
        if self.kv_tier and not self.prefix_cache:
            raise ValueError(
                "kv_tier requires prefix_cache=True: the tier "
                "spills and prefetches radix-trie nodes, so without "
                "the trie there is nothing to tier")
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
        if self.hash_block_tokens < 1:
            raise ValueError("hash_block_tokens must be >= 1")
        if self.prefix_cache and (
                self.hash_block_tokens % self.page_size != 0):
            # a misaligned block would map pages whose tail rows hold
            # another request's tokens: reject at config time
            raise ValueError(
                f"prefix_cache requires page_size ({self.page_size}) "
                f"to divide hash_block_tokens "
                f"({self.hash_block_tokens}): a trie block must cover "
                "an exact number of KV pages, otherwise a shared "
                "mapping would alias a partially-matching page")

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
    again at every replay. The warm-up and the capture run under the
    device gate taken exclusively (`_GATE`): with several engines in one
    process (a fleet's replicas, each stepping on its own thread) no
    other thread launches, syncs or captures meanwhile, so the counts,
    the global capture mode and the collector hold-off stay this
    capture's own.

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
        self._stream = _private_stream(self, dev) if self.cuda else None
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
        with _GATE.exclusive():
            return self._capture_locked(kv, kv_scales, sampled, tables)

    def _capture_locked(self, kv, kv_scales, sampled, tables):
        from ..ops.cuda_kernels import int8_gemm as ig
        from ..ops.cuda_kernels import paged_attention as pa

        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            self.eager(kv, kv_scales, sampled, tables)  # warm-up, counted
        self.warmups += 1
        counters = (pa.launches, pa.tc_launches, ig.launches,
                    ig.route_launches)
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
        # chat sessions: set by add_request; _session_seen marks a
        # returning session (the resume telemetry)
        self.session_id = None
        self._session_seen = False
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
        self.slot = None
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
        # disaggregated serving (fleet_serving.kv_transfer): a
        # prefill-only request stops at its sampling frontier and
        # resolves to its exported KVPagePayload; a request carrying
        # _kv_import admits with its prompt KV written from another
        # replica's payload (consumed at admission: a preemption replay
        # prefills the ordinary way)
        self.prefill_only = False
        self._kv_import = None
        self.cached_prefix = 0    # tokens served from the prefix cache
        self._cow_pending = 0     # COW splits taken by the last match
        self.published_blocks = 0  # trie blocks this mapping covers
        self.t_submit = _time.perf_counter()
        self.t_first_admit = None
        self.t_first_token = None
        self.deadline_t = None    # absolute perf_counter hard deadline
        self.trace = None         # reqtrace.TraceContext (add_request)

    @property
    def do_sample(self):
        return self.temperature > 0.0

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
        # shared-prefix radix cache over the pool (fleet_serving)
        self.hash_block_tokens = int(cfg.hash_block_tokens)
        self.prefix_cache = (
            RadixPrefixCache(self.pool, self.page_size,
                             self.hash_block_tokens)
            if cfg.prefix_cache else None)
        self._admit_counter = itertools.count()
        # KV memory below the pool (fleet_serving.kv_tier): trie
        # evictions spill to the host tiers, trie misses probe the tier
        # and prefetch through the import scatter
        self.kv_tier = None
        if cfg.kv_tier:
            kw = dict(cfg.kv_tier) if isinstance(cfg.kv_tier, dict) else {}
            self.kv_tier = KVTierStore(**kw)
            self.prefix_cache.spill_fn = self._spill_node
        self._spill_count = 0     # spills queued (the kv_spill stamp)
        # chat sessions: session_id -> {last_used, turns}. The KV is not
        # here: a finished turn's blocks are pinned in the trie and age
        # into the tier like any prefix; this table tracks liveness for
        # TTL / LRU expiry and the resume telemetry. Engine thread only
        self._sessions = collections.OrderedDict()
        self.session_ttl_s = cfg.session_ttl_s
        self.session_max = cfg.session_max
        self._step_fn = _PagedStep(model)
        self.stats = {"steps": 0, "tokens_in": 0, "generated": 0,
                      "finished": 0, "preemptions": 0, "fused_steps": 0,
                      "occupancy_sum": 0.0}
        # recent per-request phase timelines (reqtrace), appended at
        # first token / prefill export: the `metrics()` drill-down
        self._timelines = collections.deque(maxlen=64)
        # overload plane (fleet_serving.overload): the brownout caps
        # dict is replaced whole by apply_brownout (from the router's
        # monitor thread) and read at host decision points only
        self._brownout = {}
        self._spec_stash = None    # speculator parked by brownout L2
        self._deadlines_armed = False  # any deadline request ever seen
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
        _KV_POOL_BYTES.labels(dtype=self.kv_dtype).set(self.pool_bytes())
        # on the card: the engine's own stream (module docstring), after
        # the pools' and the model's initialization on the current one
        self._stream = None
        if self.device.type == "cuda":
            self._stream = _private_stream(self, self.device)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))

    @contextlib.contextmanager
    def _on_device(self):
        """The engine's device context: on the card a share of the
        process-wide device gate and the engine's stream; the caller's
        stream waits for the engine's work on the way out, so a direct
        reader of the pools after a step sees its writes. A no-op on the
        CPU."""
        if self._stream is None:
            yield
            return
        with _GATE.shared():
            with torch.cuda.stream(self._stream):
                yield
            torch.cuda.current_stream(self.device).wait_stream(self._stream)

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
            _STRUCT_CACHE_HITS.inc()
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
        """The structured-decoding block of `metrics()`: None unless the
        engine has token_strs. Engine-local counts — the `pt_structured_*`
        counters of the registry are process-cumulative across every
        engine in the process."""
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

    # ---- telemetry ----

    @property
    def mean_occupancy(self):
        s = self.stats["steps"]
        return self.stats["occupancy_sum"] / s if s else 0.0

    def kv_fragmentation(self):
        """Internal fragmentation of the live KV pages: unwritten slots /
        (live pages x page_size), counted as per-request tail waste
        (shared and trie pages are full by construction, so a shared
        prefix is never counted once per sharer)."""
        cap = self.pool.num_live * self.page_size
        if not cap:
            return 0.0
        waste = sum(len(r.pages) * self.page_size - r.n_prefilled
                    for r in self._slots if r is not None)
        return max(0.0, waste / cap)

    def metrics(self):
        """Live engine view + the process-wide serving counters of the
        port's registry — the reference's `metrics()`, key for key (its
        `executables` is the number of captured window graphs here).
        Reads only: safe from another thread."""
        live = sum(r is not None for r in self._slots)
        fused = self._fused_fn
        return {
            "queue_depth": len(self.waiting),
            "live_slots": live,
            "num_slots": self.num_slots,
            "kv_dtype": self.kv_dtype,
            "kv_pool_bytes": self.pool_bytes(),
            "slot_occupancy": live / self.num_slots,
            "mean_slot_occupancy": self.mean_occupancy,
            "kv_page_occupancy":
                self.pool.num_live / (self.pool.num_pages - 1),
            "kv_fragmentation": self.kv_fragmentation(),
            "kv_pages_shared": self.pool.num_shared,
            "prefix_cache": (self.prefix_cache.snapshot()
                             if self.prefix_cache is not None else None),
            "sched": self.sched.snapshot(),
            "requests": int(_REQS_TOTAL.value),
            "finished": int(_FINISHED_TOTAL.value),
            "preemptions": int(_PREEMPTIONS_TOTAL.value),
            "steps": int(_STEPS_TOTAL.value),
            "aborts": int(_ABORTS_TOTAL.value),
            "prefill_tokens":
                int(_TOKENS_TOTAL.labels(phase="prefill").value),
            "decode_tokens":
                int(_TOKENS_TOTAL.labels(phase="decode").value),
            "decode_k": self.decode_k,
            "spec": self._spec_metrics(),
            "ngram": self._ngram_metrics(),
            "structured": self._structured_metrics(),
            "fused_steps": int(_FUSED_STEPS.value),
            "dispatches": int(_DISPATCHES.value),
            "tokens_per_dispatch": _TOK_PER_DISPATCH.value,
            "admission_p50_s": _ADMIT_SECONDS.quantile(0.5),
            "admission_p99_s": _ADMIT_SECONDS.quantile(0.99),
            "ttft_p50_s": _TTFT_SECONDS.quantile(0.5),
            "ttft_p95_s": _TTFT_SECONDS.quantile(0.95),
            "ttft_p99_s": _TTFT_SECONDS.quantile(0.99),
            "request_tok_per_s_p50": _REQ_TOK_RATE.quantile(0.5),
            "request_phase_seconds": _reqtrace.phase_summary(),
            "recent_requests": list(self._timelines),
            "executables": 0 if fused is None else len(fused._graphs),
            "kv_tier": self._tier_metrics(),
            "sessions": {"active": len(self._sessions),
                         "resumed": self.stats.get("sessions_resumed", 0),
                         "shed": self.stats.get("sessions_shed", 0)},
        }

    def _tier_metrics(self):
        """kv_tier block of `metrics()`: None without a tier; else the
        store's snapshot, with the hbm rung's gauges published beside it
        (the store sees only ram / disk: the device pool is the top
        rung, so its live pages report here)."""
        if self.kv_tier is None:
            return None
        live = self.pool.num_live
        per_page = self.pool_bytes() / max(1, self.pool.num_pages)
        _TIER_PAGES.labels(tier="hbm").set(live)
        _TIER_BYTES.labels(tier="hbm").set(int(live * per_page))
        return self.kv_tier.snapshot()

    def _spec_metrics(self):
        """Draft-model speculation block of `metrics()`: None without a
        draft model (the n-gram proposer reports under `ngram`). The
        counters are process-cumulative; the per-engine window count
        rides `stats`."""
        if self._spec is None or getattr(self._spec, "mode",
                                         "draft") != "draft":
            return None
        from .speculative import (_SPEC_ACCEPTED, _SPEC_DRAFT_SECONDS,
                                  _SPEC_PROPOSED)

        proposed = _SPEC_PROPOSED.value
        return {
            "spec_k": self._spec.k,
            "windows": self.stats.get("spec_windows", 0),
            "proposed": int(proposed),
            "accepted": int(_SPEC_ACCEPTED.value),
            "acceptance_rate": (
                _SPEC_ACCEPTED.value / proposed if proposed else None),
            "draft_seconds": round(float(_SPEC_DRAFT_SECONDS.value), 4),
            "draft_pool_bytes": self._spec.pool_bytes(),
        }

    def _ngram_metrics(self):
        """n-gram speculation block of `metrics()`: None unless this
        engine runs spec_mode="ngram"."""
        if getattr(self._spec, "mode", None) != "ngram":
            return None
        proposed = self.stats.get("ngram_proposed", 0)
        accepted = self.stats.get("ngram_accepted", 0)
        return {
            "spec_k": self._spec.k,
            "windows": self.stats.get("ngram_windows", 0),
            "proposed": int(proposed),
            "accepted": int(accepted),
            "acceptance_rate": (accepted / proposed if proposed
                                else None),
        }

    def _note_timeline(self, req):
        """Record the request's phase timeline (reqtrace) for the
        `metrics()["recent_requests"]` drill-down; quiet traces (warm-up
        requests) stay out."""
        if req.trace.quiet:
            return
        self._timelines.append({
            "rid": req.rid, "trace_id": req.trace.trace_id,
            "phases": req.trace.timeline(),
            "total_s": req.trace.total_s()})

    # ---- client side ----

    def add_request(self, prompt, max_new_tokens=32, eos_token_id=None,
                    future=None, tenant="default", priority=None,
                    ttft_slo_s=None, temperature=0.0, top_p=1.0,
                    prefill_only=False, kv_import=None, trace=None,
                    deadline_s=None, session_id=None, grammar=None,
                    json_schema=None, spec_mode=None):
        """Enqueue one request (1-D int token ids); returns the
        `_Request`, whose `future` resolves to np.int64 [prompt +
        generated].

        prefill_only: prefill up to the sampling frontier (prompt_len - 1
        tokens written) and resolve the future to the exported
        `fleet_serving.KVPagePayload`; no token is sampled and
        max_new_tokens is ignored. kv_import: a KVPagePayload from another
        engine's `export_kv_pages`: the request admits with its prompt KV
        written from the payload and decodes from its frontier; the
        payload's geometry must match this engine's pool exactly, checked
        here. trace: the request's reqtrace.TraceContext (default: the
        payload's, else a fresh one). deadline_s: a hard deadline in
        seconds from now — an expired request is cancelled (its future
        raises RequestCancelled), a non-positive one is shed here
        (RequestShed).

        spec_mode: per-request speculation override — None inherits the
        engine's mode; "off" disables proposals for this request; the
        engine's own mode is accepted; any other mode raises
        (speculation is an engine resource).

        grammar: a regex string (or a structured.CompiledGrammar)
        constraining the generated tokens; json_schema: a JSON-schema
        dict lowered to one (canonical no-whitespace JSON). At most one of
        the two; both need LLMEngineConfig(token_strs=...) and an
        eos_token_id. The grammar compiles and loads into the arena here,
        so a bad or oversized one raises here.

        session_id: the request is one turn of a chat session (needs the
        prefix cache; ignored without it). The finished turn's blocks,
        generated tokens included, stay pinned in the trie (and age into
        the KV tier), so the next turn, whose prompt embeds this one's
        output, resumes from the conversation's frontier."""
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
            _STRUCT_REQS.inc()
            self.stats["structured_requests"] += 1
        if session_id is not None and self.prefix_cache is not None:
            req.session_id = str(session_id)
            req._session_seen = self._touch_session(req.session_id)
        _REQS_TOTAL.inc()
        # trace identity: the caller's (the router / server stamped
        # `queued` at its ingress), else the payload's, else fresh
        if trace is None and kv_import is not None:
            trace = _payload_trace(kv_import)
        req.trace = trace if trace is not None else _reqtrace.new_trace()
        req.trace.stamp("queued")   # no-op when the ingress stamped it
        # overload plane: brownout ingress caps and the hard deadline. A
        # shed resolves the future typed; it never raises from here
        caps = self._brownout
        sp = caps.get("shed_priority")
        if sp is not None and req.priority >= int(sp):
            return self._shed_at_admit(req, "brownout")
        if not prefill_only:
            cap = caps.get("max_new_cap")
            if cap is not None:
                req.target = min(req.target,
                                 req.prompt_len + max(1, int(cap)))
        if deadline_s is not None:
            ds = float(deadline_s)
            if ds <= 0.0:   # expired before admission: reject at submit
                return self._shed_at_admit(req, "deadline")
            req.deadline_t = req.t_submit + ds
            self._deadlines_armed = True
        if kv_import is not None:
            self._check_import(req, kv_import)
            req._kv_import = kv_import
        if prefill_only:
            req.prefill_only = True
            req.target = req.prompt_len
            if req.prompt_len == 1:
                # nothing before the frontier: an empty export (the
                # decode side prefills the single prompt token itself)
                if not req.future.cancelled():
                    req.future.set_result(
                        self._empty_payload(toks, req.trace))
                return req
        elif req.target <= req.prompt_len:
            # zero budget: the prompt echoes back
            if not req.future.cancelled():
                req.future.set_result(req.result_array())
            return req
        self.sched.enqueue(req)
        _QUEUE_DEPTH.set(len(self.sched))
        return req

    def has_work(self):
        return bool(self.waiting) or any(r is not None for r in self._slots)

    def reseed(self, seed):
        """Swap the sampling key. It lives in a device buffer that the
        fused graphs read, so this rewrites the buffer and captures
        nothing."""
        self._seed = int(seed)
        with self._on_device():      # ordered with the engine's steps
            self._key.copy_(prng.prng_key(self._seed))

    def abort_all(self, exc):
        """Fail every live and queued request with `exc` (device-error
        path), release all pages, drop the prefix trie (the re-zeroed
        pools invalidate every cached page), re-zero the pools and scale
        planes (the draft's too) — a step that died mid-write leaves them
        half updated — in place, so the fused and propose graphs stay
        valid, and restore the sampling key."""
        try:
            _fr.dump("engine_abort", error=repr(exc), inflight=[
                {"rid": r.rid, "trace_id": r.trace.trace_id}
                for r in self._slots if r is not None])
        except Exception:
            pass   # the postmortem must never mask the abort itself
        for slot, req in enumerate(self._slots):
            if req is not None:
                self._release(slot, req)
                if not req.future.done():
                    req.future.set_exception(exc)
        for req in self.sched.drain():
            if not req.future.done():
                req.future.set_exception(exc)
        if self.prefix_cache is not None:
            self.prefix_cache.clear()
        with self._on_device():
            with torch.inference_mode():
                for p in self._kv + self._kv_scales:
                    p.zero_()
            if self._spec is not None:
                self._spec.reset_pools()
            self.reseed(self._seed)
        _ABORTS_TOTAL.inc()
        _QUEUE_DEPTH.set(0)
        _LIVE_SLOTS.set(0)
        _SLOT_OCC.set(0.0)

    def abort(self, request_id, reason="client", exc=None,
              counted=False):
        """Evict one request (client cancel / deadline expiry) wherever
        it lives: a slot occupant releases its pages (shared trie pages
        keep the trie's own reference) and its page-table row; a queued
        request leaves the scheduler. The future resolves with `exc`
        (default RequestCancelled) unless already done. False when the id
        is unknown — already finished. Co-resident requests are
        untouched: no pool re-zero, no reseed, no recapture (contrast
        `abort_all`). `counted=True`: the caller (the router's `cancel`)
        already counted this cancellation."""
        rid = int(request_id)
        for slot, req in enumerate(self._slots):
            if req is not None and req.rid == rid:
                self._release(slot, req)
                self._resolve_cancel(req, reason, exc, counted=counted)
                live = sum(r is not None for r in self._slots)
                _LIVE_SLOTS.set(live)
                _SLOT_OCC.set(live / self.num_slots)
                return True
        for req in list(self.sched):
            if req.rid == rid:
                if not self.sched.remove(req):
                    return False
                self._resolve_cancel(req, reason, exc, counted=counted)
                _QUEUE_DEPTH.set(len(self.sched))
                return True
        return False

    def _resolve_cancel(self, req, reason, exc=None, counted=False):
        """Shared tail of every cancellation path: count, stamp the
        timeline, flight-record, resolve the future typed."""
        if not counted:
            note_cancelled(reason)
        req.trace.stamp("cancelled")
        self._note_timeline(req)
        _fr.record_event("request_cancelled", rid=req.rid,
                         trace_id=req.trace.trace_id, reason=reason)
        if not req.future.done():
            req.future.set_exception(
                exc if exc is not None
                else RequestCancelled(reason=reason,
                                      trace_id=req.trace.trace_id))

    def _shed_at_admit(self, req, reason):
        """Typed admission refusal (add_request): the future resolves
        with RequestShed; nothing was consumed, nothing to release."""
        note_shed(reason)
        _fr.record_event("request_shed", rid=req.rid,
                         trace_id=req.trace.trace_id, reason=reason)
        if not req.future.done():
            req.future.set_exception(
                RequestShed(reason, trace_id=req.trace.trace_id))
        return req

    def _expire_deadlines(self):
        """Cancel every live or queued request whose hard deadline has
        passed (top of step(), armed once a deadline request exists)."""
        now = _time.perf_counter()
        hit = False
        for slot, req in enumerate(self._slots):
            if (req is not None and req.deadline_t is not None
                    and now > req.deadline_t):
                self._release(slot, req)
                self._resolve_cancel(req, "deadline")
                hit = True
        stale = [r for r in self.sched
                 if r.deadline_t is not None and now > r.deadline_t]
        for req in stale:
            if self.sched.remove(req):
                self._resolve_cancel(req, "deadline")
                hit = True
        if hit:
            live = sum(r is not None for r in self._slots)
            _LIVE_SLOTS.set(live)
            _SLOT_OCC.set(live / self.num_slots)
            _QUEUE_DEPTH.set(len(self.sched))

    # ---- brownout (fleet_serving.overload) ----

    def apply_brownout(self, caps):
        """Install the fleet's brownout caps ({} = full service). Called
        from the router's monitor thread: the dict is replaced whole and
        read at host decision points only (admission caps, window
        widths); parking or restoring the speculator runs on the engine
        thread at the top of step() (`_sync_brownout`)."""
        self._brownout = dict(caps)

    def _sync_brownout(self):
        """Engine-thread half of the ladder's L2: park the speculator and
        release its draft pools (the memory returns now), or restore it —
        `reset_pools` reallocates zeroed pools and each slot's
        draft_prefilled reset makes the next window's catch-up replay the
        draft KV. L4 sheds session pinning before any traffic is shed:
        the tracking entries drop (later turns stop resuming); blocks
        already pinned age out through the trie's LRU."""
        enabled = self._brownout.get("spec_enabled", True)
        if self._spec is not None and enabled is False:
            self._spec_stash, self._spec = self._spec, None
            self._spec_stash.release_pools()
            _KV_POOL_BYTES.labels(dtype=self.kv_dtype).set(
                self.pool_bytes())
        elif (self._spec is None and self._spec_stash is not None
                and enabled):
            self._spec, self._spec_stash = self._spec_stash, None
            self._spec.reset_pools()
            for r in self._slots:
                if r is not None:
                    r.draft_prefilled = 0   # draft pool is cold: replay
            _KV_POOL_BYTES.labels(dtype=self.kv_dtype).set(
                self.pool_bytes())
        if self._brownout.get("session_pin", True) is False \
                and self._sessions:
            self.stats["sessions_shed"] = (
                self.stats.get("sessions_shed", 0) + len(self._sessions))
            self._sessions.clear()
            _SESSION_ACTIVE.set(0)

    def close(self):
        """Retire the engine: drop the prefix trie (its clear() publishes
        the negative resident-pages delta, so a process that cycles
        engines does not leave pt_prefix_cache_resident_pages inflated)
        and close the KV tier's commit thread. Idempotent; the engine
        stays usable with a cold trie."""
        if self.prefix_cache is not None:
            self.prefix_cache.clear()
        if self.kv_tier is not None:
            self.kv_tier.close()

    # ---- disaggregated serving: the KV wire ----
    # Both directions run on the thread that owns the engine (inside
    # step(), or on the server's thread for export_prefix), on the
    # engine's stream: the export gather right after the tick that
    # reached the frontier, the import ahead of the next tick.

    def export_kv_pages(self, req):
        """Cut the request's KV pages (every layer pool and scale plane,
        byte for byte, the partially filled frontier page included) into
        a `fleet_serving.KVPagePayload`. The request keeps its pages:
        export is a read."""
        from .fleet_serving.kv_transfer import KVPagePayload

        kv, scales = self._gather_pages(req.pages)
        self.stats["kv_pages_exported"] = (
            self.stats.get("kv_pages_exported", 0) + len(req.pages))
        req.trace.stamp("kv_export")
        return KVPagePayload(np.asarray(req.tokens, np.int32),
                             req.n_prefilled, self.page_size,
                             self.kv_dtype, kv, scales,
                             trace=req.trace.to_dict())

    def _gather_pages(self, page_ids):
        """One gather of exactly `page_ids` rows from every pool and
        scale plane, packed into one byte buffer on the device and
        brought to the host in ONE copy (the reference pads to a fixed
        width to keep one executable; eager torch needs no padding).
        Returns (kv, scales): owned numpy arrays, a bf16 pool's as uint16
        words."""
        arrays = self._kv + self._kv_scales
        n = len(page_ids)
        with self._on_device():
            ids = torch.as_tensor(list(page_ids), dtype=torch.long,
                                  device=self.device)
            flat = torch.cat([a.index_select(0, ids).reshape(-1)
                              .view(torch.uint8) for a in arrays])
            host = flat.cpu().numpy()
        out, off = [], 0
        for a in arrays:
            shape = (n,) + tuple(a.shape[1:])
            nb = int(np.prod(shape)) * a.element_size()
            out.append(host[off:off + nb].view(_np_carrier(a))
                       .reshape(shape).copy())
            off += nb
        return out[:len(self._kv)], out[len(self._kv):]

    def import_kv_pages(self, payload, **kw):
        """Admit one request whose prompt KV arrives pre-computed (another
        engine's `export_kv_pages`): the payload's tokens are the prompt
        and decoding starts at its frontier. Takes `add_request`'s
        keywords."""
        return self.add_request(payload.tokens, kv_import=payload, **kw)

    def _empty_payload(self, toks, trace=None):
        from .fleet_serving.kv_transfer import KVPagePayload

        if trace is not None:
            trace.stamp("kv_export")
        return KVPagePayload(
            toks, 0, self.page_size, self.kv_dtype,
            [np.zeros((0,) + tuple(p.shape[1:]), _np_carrier(p))
             for p in self._kv],
            [np.zeros((0,) + tuple(s.shape[1:]), np.float32)
             for s in self._kv_scales],
            trace=trace.to_dict() if trace is not None else None)

    def _check_import(self, req, payload):
        """Geometry validation at submit time (an import that
        reinterprets pages under another page_size / kv_dtype / head
        layout would serve garbage logits, not an error). The reference's
        checks and messages; every mismatching array in one error."""
        if payload.page_size != self.page_size:
            raise ValueError(
                f"kv_import page_size {payload.page_size} != engine "
                f"page_size {self.page_size}")
        if payload.kv_dtype != self.kv_dtype:
            raise ValueError(
                f"kv_import kv_dtype {payload.kv_dtype!r} != engine "
                f"kv_dtype {self.kv_dtype!r} (pools must match "
                "byte-for-byte; re-prefill instead)")
        if len(payload.kv) != len(self._kv):
            raise ValueError(
                f"kv_import carries {len(payload.kv)} pools, engine "
                f"has {len(self._kv)} (different num_layers?)")
        if len(payload.scales) != len(self._kv_scales):
            raise ValueError(
                "kv_import scale planes do not match the engine pool "
                f"({len(payload.scales)} vs {len(self._kv_scales)})")
        n_pages = payload.num_pages
        bad = []
        for i, a in enumerate(payload.kv):
            want = (n_pages,) + tuple(self._kv[i].shape[1:])
            if tuple(a.shape) != want:
                bad.append(f"pool {i} shape {tuple(a.shape)} != {want}")
        for i, a in enumerate(payload.scales):
            want = (n_pages,) + tuple(self._kv_scales[i].shape[1:])
            if tuple(a.shape) != want:
                bad.append(f"scale plane {i} shape {tuple(a.shape)} "
                           f"!= {want}")
        if bad:
            raise ValueError(
                f"kv_import geometry mismatch (engine page geometry "
                f"x {n_pages} pages), {len(bad)} failing arrays: "
                + "; ".join(bad))
        if not 0 <= payload.n_prefilled <= req.prompt_len - 1:
            raise ValueError(
                f"kv_import n_prefilled {payload.n_prefilled} outside "
                f"[0, prompt_len-1] ({req.prompt_len - 1}): the decode "
                "side owns the frontier token")
        need = -(-payload.n_prefilled // self.page_size)
        if payload.num_pages != need:
            raise ValueError(
                f"kv_import ships {payload.num_pages} pages but "
                f"n_prefilled {payload.n_prefilled} needs {need}")

    def _write_imported_pages(self, page_ids, payload):
        """Write the payload's page rows into this engine's pools at
        freshly allocated page ids, byte for byte (no dequant / requant).
        The pools are written IN PLACE (`index_copy_`), never rebound:
        the captured fused / propose graphs hold their addresses. One
        host-to-device copy of every row, on the engine's stream."""
        if not page_ids:
            return
        from .fleet_serving.kv_transfer import _KV_PAGES_STREAMED

        arrays = self._kv + self._kv_scales
        rows = list(payload.kv) + list(payload.scales)
        host = np.concatenate([np.ascontiguousarray(r).reshape(-1)
                               .view(np.uint8) for r in rows])
        with self._on_device(), torch.inference_mode():
            dev = torch.from_numpy(host).to(self.device)
            ids = torch.as_tensor(list(page_ids), dtype=torch.long,
                                  device=self.device)
            off = 0
            for a, r in zip(arrays, rows):
                nb = r.nbytes
                src = dev[off:off + nb].view(a.dtype).view(
                    (len(page_ids),) + tuple(a.shape[1:]))
                a.index_copy_(0, ids, src)
                off += nb
        self.stats["kv_pages_imported"] = (
            self.stats.get("kv_pages_imported", 0) + len(page_ids))
        _KV_PAGES_STREAMED.inc(len(page_ids))

    def export_prefix(self, tokens):
        """Cut the trie's longest cached prefix of `tokens` into a
        `KVPagePayload` (the router's hot-prefix migration source). The
        payload satisfies the kv_import frontier contract for a request
        with these exact tokens (n_prefilled <= len-1, exact page count),
        so the pulling engine admits it through the ordinary import and
        publishes it into its own trie. None when nothing is cached.
        Engine thread only (the LLMServer's control queue)."""
        if self.prefix_cache is None:
            return None
        from .fleet_serving.kv_transfer import KVPagePayload

        toks = np.asarray(tokens).reshape(-1)
        cached, pages = self.prefix_cache.match(toks)
        bt = self.prefix_cache.block_tokens
        # the import contract leaves the frontier token to the decode
        # side: a fully covered prompt exports one block less
        while pages and cached >= toks.size:
            cached -= self.prefix_cache.cow_split(pages)
        if not pages:
            return None
        kv, scales = self._gather_pages(pages)
        self.pool.free(pages)   # match()'s share refs, returned
        self.stats["kv_pages_migrated_out"] = (
            self.stats.get("kv_pages_migrated_out", 0) + cached // bt
            * self.prefix_cache.pages_per_block)
        return KVPagePayload(toks, cached, self.page_size,
                             self.kv_dtype, kv, scales)

    # ---- KV memory below the pool (fleet_serving.kv_tier) ----

    def _spill_node(self, node):
        """RadixPrefixCache spill hook: one dying trie node's pages to
        the host (a synchronous snapshot through the export's gather, on
        the engine's stream: the pages are reused the moment the trie
        frees them, and a queued window writes them on the same stream)
        and into the tier's spill queue (the commit is asynchronous).
        Keyed by the node's full token prefix; the payload carries only
        the node's own block pages. Swallows its own failures: eviction
        is relieving pool pressure, and a lost spill only costs the
        re-prefill."""
        from .fleet_serving.kv_transfer import KVPagePayload

        try:
            blocks = []
            n = node
            while n.block is not None:
                blocks.append(n.block)
                n = n.parent
            blocks.reverse()
            toks = np.asarray([t for blk in blocks for t in blk], np.int32)
            kv, scales = self._gather_pages(node.pages)
            payload = KVPagePayload(toks, int(toks.size), self.page_size,
                                    self.kv_dtype, kv, scales)
            _TIER_EVICTIONS.labels(tier="hbm").inc(len(node.pages))
            if self.kv_tier.put(prefix_key(toks), payload):
                self._spill_count += 1
                self.stats["kv_pages_spilled"] = (
                    self.stats.get("kv_pages_spilled", 0)
                    + len(node.pages))
        except Exception:   # never block the eviction path
            self.stats["kv_spill_errors"] = (
                self.stats.get("kv_spill_errors", 0) + 1)

    def _prefetch_tier(self, req, cached, pages):
        """Extend a trie match from the spill tiers: for each block past
        the trie's frontier whose prefix the tier holds, allocate fresh
        pages, write the frame into them IN PLACE
        (`_write_imported_pages`: captured graphs hold the pools) and
        re-insert the node, so this request and every later one maps it
        as an ordinary trie hit. Stops at the first tier miss, a dry
        pool, or `pages_per_seq`. Returns the extended (cached, pages);
        the new pages carry the engine's own alloc references, released
        through the request's pages like match()'s share references."""
        bt = self.prefix_cache.block_tokens
        ppb = self.prefix_cache.pages_per_block
        toks = req.tokens
        hit = False
        while (cached + bt <= len(toks)
               and (len(pages) + ppb) <= self.pages_per_seq):
            payload = self.kv_tier.get(prefix_key(toks[:cached + bt]))
            if payload is None:      # a tier miss (or a rotten frame)
                break
            new_pages = []
            try:
                for _ in range(ppb):
                    new_pages.append(self._alloc_page())
            except PoolExhausted:
                # a prefetch must never starve the request's own prompt
                # pages: give back and serve what there is
                self.pool.free(new_pages)
                break
            self._write_imported_pages(new_pages, payload)
            self.prefix_cache.insert(toks[:cached + bt], pages + new_pages)
            pages.extend(new_pages)
            cached += bt
            hit = True
            self.stats["kv_pages_prefetched"] = (
                self.stats.get("kv_pages_prefetched", 0) + ppb)
        if hit:
            req.trace.stamp("kv_prefetch")
        return cached, pages

    # ---- chat sessions ----

    def _touch_session(self, sid):
        """Create or refresh one session entry and TTL / LRU-expire the
        rest. True when the session already existed (a returning turn).
        Expiry drops only the tracking entry: the session's KV ages out
        through the trie's and the tier's LRU like any prefix."""
        now = _time.perf_counter()
        seen = sid in self._sessions
        ent = self._sessions.pop(sid, None) or {"turns": 0}
        ent["last_used"] = now
        self._sessions[sid] = ent
        while self._sessions:
            head = next(iter(self._sessions))
            if (len(self._sessions) > self.session_max
                    or (now - self._sessions[head]["last_used"]
                        > self.session_ttl_s)):
                del self._sessions[head]
            else:
                break
        _SESSION_ACTIVE.set(len(self._sessions))
        return seen

    def _publish_session(self, req):
        """Pin a finished session turn: insert every full block of the
        final token sequence, generated tokens included (unlike the
        prompt-only `_publish_prefix`), so the next turn resumes from
        the conversation's frontier. The trie holds its reference after
        `_release` frees the request's own; under pool pressure the
        blocks spill to the tier like any node."""
        if (req.session_id is None or self.prefix_cache is None
                or self._brownout.get("session_pin", True) is False):
            return
        bt = self.hash_block_tokens
        ppb = self.prefix_cache.pages_per_block
        nb = req.n_prefilled // bt     # only KV-written rows publish
        if nb:
            self.prefix_cache.insert(req.tokens[:nb * bt],
                                     req.pages[:nb * ppb])
        ent = self._sessions.get(req.session_id)
        if ent is not None:
            ent["turns"] += 1

    def _finish_prefill(self, slot, req):
        """Retire a prefill-only request at its frontier: export the
        payload, release the slot and pages, resolve the future to the
        payload."""
        req.trace.stamp("prefill_end")
        payload = self.export_kv_pages(req)
        self._note_timeline(req)
        self._release(slot, req)
        self.stats["finished"] += 1
        self.stats["prefill_exports"] = (
            self.stats.get("prefill_exports", 0) + 1)
        _FINISHED_TOTAL.inc()
        if not req.future.cancelled():
            req.future.set_result(payload)

    # ---- scheduler ----

    def _release(self, slot, req):
        self.pool.free(req.pages)  # shared pages decref; the trie keeps
        req.pages = []             # its own reference
        req.n_prefilled = 0
        req.draft_prefilled = 0   # a replay re-prefills both pools
        req.cached_prefix = 0
        req.published_blocks = 0
        req.slot = None
        self._page_tables[slot, :] = 0
        self._slots[slot] = None

    def _finish(self, slot, req):
        # session pinning reads req.pages: it precedes the release
        self._publish_session(req)
        self._release(slot, req)
        self.stats["finished"] += 1
        _FINISHED_TOTAL.inc()
        if req.t_first_admit is not None and req.num_generated:
            dt = _time.perf_counter() - req.t_first_admit
            if dt > 0:
                _REQ_TOK_RATE.observe(req.num_generated / dt)
        # a client may have cancel()ed while the request was in flight
        if not req.future.cancelled():
            req.future.set_result(req.result_array())

    def _preempt(self, slot, req, reason):
        """Evict-and-requeue one running sequence. Its generated tokens
        and its sampling stream are kept: the re-decode of
        prompt+generated reproduces the same continuation, greedy or
        sampled, and with the prefix cache on its replayed prefill
        re-hits the trie."""
        self._release(slot, req)
        req.preemptions += 1
        self.stats["preemptions"] += 1
        _PREEMPTIONS_TOTAL.inc()
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

    def _alloc_page(self):
        """Pool alloc with prefix-cache pressure relief: a dry pool first
        reclaims LRU trie-only pages before the caller has to preempt."""
        try:
            return self.pool.alloc()
        except PoolExhausted:
            if (self.prefix_cache is not None
                    and self.prefix_cache.evict(1) > 0):
                return self.pool.alloc()
            raise

    def _map_prefix(self, req):
        """Match the request's tokens against the radix trie and map the
        shared pages (the request holds one pool reference per page).
        `req.cached_prefix` tokens of prefill are skipped. Copy-on-write
        cap: at least one token runs through the model (the frontier
        logit), and its KV write may not land in a shared page, so a
        fully cached prompt splits its tail block back to private
        recompute."""
        cached, pages = self.prefix_cache.match(req.tokens)
        if self.kv_tier is not None:
            # extend the trie's frontier from the spill tiers before the
            # COW cap: a prefetched block re-enters the trie, so a fully
            # covered prompt splits its tail back like any hit
            cached, pages = self._prefetch_tier(req, cached, pages)
        splits = 0
        while pages and cached >= len(req.tokens):
            cached -= self.prefix_cache.cow_split(pages)
            splits += 1
        req.cached_prefix = cached
        req._cow_pending = splits
        return pages

    def _publish_prefix(self, req):
        """Register the request's newly completed full PROMPT blocks in
        the trie (its own mapped blocks are already there; insert is
        idempotent). Generated-token pages stay private."""
        bt = self.hash_block_tokens
        covered = min(req.n_prefilled, req.prompt_len)
        nblocks = covered // bt
        if nblocks > req.published_blocks:
            ppb = self.prefix_cache.pages_per_block
            self.prefix_cache.insert(req.tokens[:nblocks * bt],
                                     req.pages[:nblocks * ppb])
            req.published_blocks = nblocks

    def _try_admit(self, req):
        """Place one popped request into a slot: prefix-cache mapping,
        page-fit check (with trie eviction and lowest-priority preemption
        as pressure valves), page-table setup, the KV import. False —
        with every transient reference released — when the request
        cannot be placed yet."""
        spills0 = self._spill_count    # the kv_spill stamp's baseline
        # cheap bails first: a blocked head-of-queue request must not
        # pay a prefix match and a feasibility walk on every tick.
        # (a) no free slot and no legal victim
        if None not in self._slots:
            now = _time.perf_counter()
            if not any(r is not None
                       and self.sched.less_urgent(r, req, now)
                       for r in self._slots):
                return False
        # with speculation, one page of headroom per live frontier slot
        # stays free, so a burst of admissions cannot drain the pool to
        # where every verify window collapses to width 0
        headroom = (self._spec.window_headroom()
                    if self._spec is not None else 0)
        # (b) the pool is short even in the best case: the trie can map
        # at most resident_pages into the prompt and reclaim at most
        # resident_pages more
        need_all = -(-len(req.tokens) // self.page_size)
        if self.pool.num_free - headroom < need_all:
            now = _time.perf_counter()
            avail = self.pool.num_free - headroom + sum(
                len(r.pages) for r in self._slots if r is not None
                and self.sched.less_urgent(r, req, now))
            resident = (self.prefix_cache.resident_pages
                        if self.prefix_cache is not None else 0)
            if avail + 2 * resident < need_all:
                return False
        # an imported request's prompt KV arrives in its payload: a trie
        # mapping on top would alias pages the import must write
        pages = (self._map_prefix(req)
                 if self.prefix_cache is not None
                 and req._kv_import is None else [])

        def give_up():
            if pages:
                self.pool.free(pages)
            req.cached_prefix = 0
            return False

        # feasibility first: preempting a runner destroys its progress,
        # so evict only once a slot and enough reclaimable pages can
        # exist (`reclaimable` is an upper bound; the loops below still
        # give up cleanly when eviction falls short)
        need = (-(-len(req.tokens) // self.page_size) - len(pages)
                + headroom)
        if None not in self._slots or self.pool.num_free < need:
            now = _time.perf_counter()
            victims = [r for r in self._slots if r is not None
                       and self.sched.less_urgent(r, req, now)]
            if None not in self._slots and not victims:
                return give_up()
            reclaimable = self.pool.num_free + sum(
                len(r.pages) for r in victims)
            if self.prefix_cache is not None:
                reclaimable += self.prefix_cache.reclaimable_pages()
            if reclaimable < need:
                return give_up()
        if None not in self._slots:
            if not self._preempt_one(None, worse_than=req,
                                     reason="priority"):
                return give_up()
        # the prompt's remaining pages must fit (head-of-class blocking:
        # a short prompt never jumps its own class's queue)
        while self.pool.num_free < need:
            short = need - self.pool.num_free
            if (self.prefix_cache is not None
                    and self.prefix_cache.evict(short) > 0):
                continue
            if not self._preempt_one(None, worse_than=req,
                                     reason="priority"):
                return give_up()
        slot = self._slots.index(None)
        req.slot = slot
        req.admit_seq = next(self._admit_counter)
        req.pages = list(pages)
        req.n_prefilled = req.cached_prefix
        if req._kv_import is not None:
            # disaggregated hand-off: write the payload's pages and join
            # at the frontier. The payload is consumed: a later
            # preemption replay prefills the prompt the ordinary way
            imp, req._kv_import = req._kv_import, None
            req.pages = [self._alloc_page()
                         for _ in range(imp.num_pages)]
            self._write_imported_pages(req.pages, imp)
            req.n_prefilled = imp.n_prefilled
            req.trace.stamp("kv_import")
        # mirrored draft pool: a shared page's draft rows were written by
        # the publishing request's own catch-up (same page ids, tokens
        # and draft model), so the mapped prefix is draft-valid too; a
        # publisher that never ran a window leaves rows whose proposals
        # the lossless verify rejects (acceptance rate, not correctness)
        req.draft_prefilled = (req.cached_prefix
                               if self._spec is not None else 0)
        req.published_blocks = req.cached_prefix // self.hash_block_tokens
        self._page_tables[slot, :] = 0
        self._page_tables[slot, :len(req.pages)] = req.pages
        self._slots[slot] = req
        if self.prefix_cache is not None:
            self.prefix_cache.note_mapped(
                req.cached_prefix, pages, cow_splits=req._cow_pending)
        if req.t_first_admit is None:
            req.t_first_admit = _time.perf_counter()
            _ADMIT_SECONDS.observe(req.t_first_admit - req.t_submit)
        if self._spill_count > spills0:
            # this admission's pool pressure pushed trie pages to the
            # spill tier (prefix_cache.evict -> _spill_node)
            req.trace.stamp("kv_spill")
        if self.kv_tier is not None and req.cached_prefix > 0:
            _TIER_HITS.labels(tier="hbm").inc()
        if (req.session_id is not None and req._session_seen
                and req.cached_prefix > 0):
            req._session_seen = False   # one resume per turn, not replay
            _SESSION_RESUMED.inc()
            self.stats["sessions_resumed"] = (
                self.stats.get("sessions_resumed", 0) + 1)
        if req.n_prefilled < len(req.tokens) - 1:
            req.trace.stamp("prefill_start")
        else:
            # a full import / full trie hit: no prefill runs here
            req.trace.stamp("prefill_end")
        if (req.prefill_only
                and req.n_prefilled >= req.prompt_len - 1):
            # the import (or a full trie hit) already covers the
            # frontier: nothing left for this engine to compute
            self._finish_prefill(slot, req)
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
                if req.prefill_only:
                    # the frontier token belongs to the decode side of
                    # the hand-off: stop one short, so no logit is
                    # computed (and no token sampled) here
                    remaining -= 1
                take = 1 + min(remaining - 1, budget)
                budget -= take - 1
                alloc[slot] = take
            ok = True
            for slot, req in active:
                last = req.n_prefilled + alloc[slot] - 1
                try:
                    while last // self.page_size >= len(req.pages):
                        page = self._alloc_page()
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
        preemption. Returns the requests finished.

        On the card the step holds a share of the device gate and runs on
        the engine's stream (`_on_device`)."""
        with self._on_device():
            return self._step()

    def _step(self):
        self._sync_brownout()
        if self._deadlines_armed:
            self._expire_deadlines()
        self._admit()
        if self._spec is not None or self.decode_k > 1:
            active = self._active()
            frontier = [(s, r) for s, r in active
                        if r.n_prefilled == len(r.tokens) - 1]
            if frontier:
                for _s, r in frontier:
                    if r.num_generated == 0:
                        r.trace.stamp("first_decode_dispatch")
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
        if self.prefix_cache is not None:
            avail += self.prefix_cache.reclaimable_pages()
        # brownout window cap (overload ladder L3): a smaller window rides
        # `rem` through the same graph
        cap = self._brownout.get("decode_k_cap")
        w = k if cap is None else max(1, min(k, int(cap)))
        while w > 1 and pages_needed(w) > avail:
            w -= 1        # spill: the largest window the pool covers
        if pages_needed(w) > avail:
            return None   # not even 1 token a row: the single tick preempts
        # reserve the window's pages up front (_alloc_page evicts LRU
        # trie pages under pressure; reclaimable was an upper bound, so a
        # short row spills further instead of failing the window)
        rem_arg = {}
        for slot, req in active:
            want = min(w, req.target - len(req.tokens))
            last = req.n_prefilled + want - 1
            try:
                while last // ps >= len(req.pages):
                    page = self._alloc_page()
                    self._page_tables[slot, len(req.pages)] = page
                    req.pages.append(page)
                writes = want
            except PoolExhausted:
                writes = min(want, len(req.pages) * ps - req.n_prefilled)
                if writes < 1:
                    return None
            rem_arg[slot] = writes

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
            with _trace_span("llm_engine.fused_step", k=k,
                             live=len(active)):
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
        self.stats["occupancy_sum"] += len(active) / self.num_slots
        _STEPS_TOTAL.inc()
        _FUSED_STEPS.inc()
        _DISPATCHES.inc()
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
                self._note_first_token(req, now)
            if done:
                self._finish(slot, req)
                finished.append(req)
        self.stats["tokens_in"] += total
        _TOKENS_TOTAL.labels(phase="decode").inc(total)
        _TOK_PER_DISPATCH.set(total)
        self._note_load()
        return finished

    def _note_first_token(self, req, now):
        """TTFT bookkeeping of a request's first generated token, on
        every path (tick, fused window, verify window)."""
        ttft = now - req.t_submit
        req.t_first_token = now
        req.trace.stamp("first_token")
        self._note_timeline(req)
        _TTFT_SECONDS.observe(ttft)
        self.sched.note_first_token(req, ttft)

    def _note_load(self, live=None):
        """The whole-engine load gauges after a dispatch."""
        if live is None:
            live = sum(r is not None for r in self._slots)
        _QUEUE_DEPTH.set(len(self.waiting))
        _LIVE_SLOTS.set(live)
        _SLOT_OCC.set(live / self.num_slots)
        _PAGE_OCC.set(self.pool.num_live / (self.pool.num_pages - 1))
        _PAGE_FRAG.set(self.kv_fragmentation())

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
                    if req.num_generated == 0:
                        # prefill ends and decode begins in this tick
                        req.trace.stamp("prefill_end")
                        req.trace.stamp("first_decode_dispatch")
                i += 1
        # rows past i stay 0: padding tokens (kv_len 0) writing trash row 0
        dev = torch.from_numpy(buf).to(self.device)
        tok_d, pos_d, sid_d, widx_d, klen_d = dev[:5 * T].view(5, T)
        smp_d = dev[5 * T:5 * T + S]
        pt_d = dev[5 * T + S:].view(S, MP)
        try:
            with _trace_span("llm_engine.step", tokens=i, live=len(plan)):
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
        self.stats["occupancy_sum"] += len(plan) / self.num_slots
        _STEPS_TOTAL.inc()
        _DISPATCHES.inc()
        # a straggler tick covers only the prefill rows: it must not
        # overwrite the window's whole-engine gauges with its own subset
        if only_slots is None or sample_slots:
            _TOK_PER_DISPATCH.set(len(sample_slots))
        _TOKENS_TOTAL.labels(phase="decode").inc(len(sample_slots))
        _TOKENS_TOTAL.labels(phase="prefill").inc(i - len(sample_slots))
        finished = []
        for slot, req, take in plan:
            req.n_prefilled += take
            if req.n_prefilled >= len(req.tokens) - 1:
                req.trace.stamp("prefill_end")
            self.sched.note_tokens(req.tenant, take)
            if self.prefix_cache is not None:
                self._publish_prefix(req)
            if (req.prefill_only
                    and req.n_prefilled >= len(req.tokens) - 1):
                # the hand-off: the frontier is reached — export the
                # pages and retire (the publish above already put the
                # full prompt blocks in the trie)
                self._finish_prefill(slot, req)
                finished.append(req)
        now = _time.perf_counter()
        for slot, t in zip(sample_slots, nxt):
            req = self._slots[slot]
            req.tokens.append(int(t))
            if req.grammar is not None:
                req.gstate = req.grammar.advance(req.gstate, int(t))
            self.stats["generated"] += 1
            if req.num_generated == 1:      # replays don't re-count
                self._note_first_token(req, now)
            if ((req.eos is not None and t == req.eos)
                    or len(req.tokens) >= req.target):
                self._finish(slot, req)
                finished.append(req)
        self._note_load(len(plan) if only_slots is None else None)
        return finished


# the full `LLMServer.submit` keyword surface (the reference's):
# FleetRouter.submit screens unknown keywords against it, so a typo
# raises at submit() with its name instead of inside a replica's loop
SUBMIT_KWARGS = frozenset((
    "max_new_tokens", "eos_token_id", "tenant", "priority",
    "ttft_slo_s", "temperature", "top_p", "prefill_only", "kv_import",
    "trace", "deadline_s", "session_id", "grammar", "json_schema",
    "spec_mode"))


class LLMServer(_FutureQueueServer):
    """Continuous-batching text-generation server: one background thread
    owns an `LLMEngine`; `submit` is thread-safe."""

    _thread_name = "llm-engine"

    def __init__(self, model, config=None):
        super().__init__()
        self._engine = LLMEngine(model, config)
        self._http = None
        self.stats = self._engine.stats
        self.stats.setdefault("requests", 0)

    @property
    def engine(self):
        return self._engine

    def metrics(self):
        """The engine's `metrics()` snapshot. Reads only."""
        return self._engine.metrics()

    def start_metrics_http(self, port=0, host="127.0.0.1"):
        """Optional stdlib-only pull endpoint: GET /metrics serves the
        port's registry in Prometheus text, /metrics.json the snapshot
        with this engine's view under "extra". port=0 picks a free port;
        returns the handle (`.url`, `.port`). Stopped with the server."""
        if self._http is None:
            from ..observability import start_http_server

            self._http = start_http_server(port=port, host=host,
                                           extra_json=self.metrics)
        return self._http

    def stop(self):
        super().stop()
        self._engine.close()
        if self._http is not None:
            self._http.stop()
            self._http = None

    def submit(self, prompt, max_new_tokens=32, eos_token_id=None,
               tenant="default", priority=None, ttft_slo_s=None,
               temperature=0.0, top_p=1.0, prefill_only=False,
               kv_import=None, trace=None, deadline_s=None,
               session_id=None, grammar=None, json_schema=None,
               spec_mode=None):
        """Enqueue one prompt (1-D int token ids). Returns a Future
        resolving to np.int64 [prompt + generated] (eos kept, nothing
        after it) — or, with `prefill_only=True`, to the exported
        `fleet_serving.KVPagePayload` (`kv_import` is the receiving side;
        see `LLMEngine.add_request`). The sampling knobs and the
        constraint kwargs (`grammar=`, `json_schema=`, `spec_mode=`) are
        checked, and the grammar compiled, here on the caller's thread,
        so a bad one raises at submit() and never inside the serve loop.
        The trace is minted here (or taken from the payload), so its
        `queued` stamp covers the server's queue. The engine-side
        `_Request` is attached to the future as `fut.pt_request` once the
        engine thread has taken it in. `session_id` marks the request as
        one turn of a chat session (`LLMEngine.add_request`)."""
        _check_sampling(float(temperature), float(top_p))
        grammar = self._engine._resolve_constraint(
            grammar, json_schema, eos_token_id, spec_mode)
        fut = Future()
        fut.pt_request = None
        if trace is None and kv_import is not None:
            trace = _payload_trace(kv_import)
        if trace is None:
            trace = _reqtrace.new_trace()
        trace.stamp("queued")
        self._enqueue(dict(
            prompt=np.asarray(prompt).reshape(-1),
            max_new_tokens=int(max_new_tokens), eos_token_id=eos_token_id,
            future=fut, tenant=tenant, priority=priority,
            ttft_slo_s=ttft_slo_s, temperature=float(temperature),
            top_p=float(top_p), prefill_only=bool(prefill_only),
            kv_import=kv_import, trace=trace, deadline_s=deadline_s,
            session_id=session_id, spec_mode=spec_mode, grammar=grammar))
        return fut

    def export_prefix(self, tokens):
        """Future -> the engine trie's longest cached prefix of `tokens`
        as a `KVPagePayload` (or None): the router's hot-prefix migration
        source. The cut runs on the engine thread, a control message on
        the submission queue."""
        fut = Future()
        self._enqueue({"_export_prefix": np.asarray(tokens).reshape(-1),
                       "_export_future": fut})
        return fut

    def generate(self, prompt, max_new_tokens=32, eos_token_id=None):
        return self.submit(prompt, max_new_tokens, eos_token_id).result()

    def abort(self, request_id, reason="client", counted=False):
        """Cancel one in-flight request by its engine rid. The abort
        rides the submission queue, so the engine thread applies it
        between steps; an unknown or finished rid is a no-op."""
        self._enqueue({"_abort": int(request_id),
                       "_abort_reason": str(reason),
                       "_abort_counted": bool(counted)})

    def _ingest(self, payload):
        if "_abort" in payload:   # control message, not a submission
            self._engine.abort(payload["_abort"],
                               reason=payload["_abort_reason"],
                               counted=payload["_abort_counted"])
            return
        if "_export_prefix" in payload:
            fut = payload["_export_future"]
            try:
                res = self._engine.export_prefix(payload["_export_prefix"])
                if not fut.cancelled():
                    fut.set_result(res)
            except Exception as e:
                if not fut.done():
                    fut.set_exception(e)
            return
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

    def _tick_hook(self):
        """Per-iteration hook of the serve loop (the fleet replica's
        heartbeat and chaos kill: fleet_serving.replica overrides it).
        True ends the loop dead: no drain, no future resolved — the
        process-death shape the router's failover requeues."""
        return False

    def _loop(self):
        eng = self._engine
        while self._running or not self._q.empty() or eng.has_work():
            if self._tick_hook():
                return
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
