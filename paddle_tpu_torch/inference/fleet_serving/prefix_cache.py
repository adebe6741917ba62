"""Radix prefix cache — content-addressed COW sharing of KV pages
(counterpart of paddle_tpu/inference/fleet_serving/prefix_cache.py, the
port's own copy: the same trie, the same results and snapshots under the
same operation sequence).

A fleet of requests carrying the same system prompt re-prefills and
re-stores identical KV over and over: with a 128-token system prompt
and 32-token user suffixes, ~80% of every prefill is redundant compute
AND redundant HBM. This cache de-duplicates both.

Design (the vLLM/SGLang radix-cache shape, page-pool native):

* **Token trie at block granularity.** Prompts are split into blocks of
  `block_tokens` (a multiple of the pool's `page_size`; default equal).
  Each trie node is keyed by its block's exact token tuple — python's
  hash gives the content addressing, tuple equality makes collisions
  impossible — and owns the physical page ids whose KV holds exactly
  those tokens at those positions. A node's identity is its PATH from
  the root, so equal blocks under different prefixes are distinct
  (positions differ, so their KV differs — RoPE).

* **Sharing is page-table aliasing + refcounts.** `match()` walks the
  trie and maps each hit page into the caller's page table after
  `PagePool.share()` (refcount + 1). The engine then starts the
  request's prefill AFTER the cached tokens: shared pages are read by
  paged attention but never written. KV rows depend only on (token,
  position) prefix — identical prefix, identical rows — so greedy
  outputs are token-identical to the uncached path (pinned by
  tests/test_torch_prefix_cache.py).

* **Copy-on-write split.** A request may only write pages it owns
  exclusively. When its first divergent write would land INSIDE a
  shared page (e.g. the prompt is an exact block multiple and fully
  cached, so the frontier token's KV row lands in the last shared
  page), the engine splits: the shared mapping is dropped
  (`release()`, refcount − 1) and the block's rows are recomputed into
  a freshly-allocated private page. The "copy" is a replayed prefill of
  ≤ block_tokens tokens through the SAME decode executable — no page-
  copy kernel, no second executable, and bit-identical page contents.

* **LRU eviction under pool pressure.** Trie nodes whose pages nobody
  maps (pool refcount 1 — the trie's own reference) are evictable; the
  engine calls `evict()` before preempting a running sequence when the
  pool runs dry. Leaves evict first (a node's children extend its
  prefix, so parents are only reclaimable once their subtree is gone),
  least-recently-matched first.

Telemetry (docs/OBSERVABILITY.md): pt_prefix_cache_hits,
pt_prefix_cache_pages_shared, pt_prefix_cache_prefill_tokens_saved,
pt_prefix_cache_cow_splits, pt_prefix_cache_evicted_pages, and the
pt_prefix_cache_resident_pages gauge.
"""
import heapq
import itertools

from ...observability import metrics as _obs

__all__ = ["RadixPrefixCache"]

_HITS = _obs.counter(
    "pt_prefix_cache_hits",
    "requests admitted with a non-empty shared-prefix mapping")
_PAGES_SHARED = _obs.counter(
    "pt_prefix_cache_pages_shared",
    "KV pages mapped read-only into an admitted request's page table")
_TOKENS_SAVED = _obs.counter(
    "pt_prefix_cache_prefill_tokens_saved",
    "prompt tokens whose prefill was skipped via a cache hit")
_COW_SPLITS = _obs.counter(
    "pt_prefix_cache_cow_splits",
    "shared-page mappings split copy-on-write (divergent write)")
_EVICTED = _obs.counter(
    "pt_prefix_cache_evicted_pages",
    "trie-held pages reclaimed by LRU eviction under pool pressure")
_RESIDENT = _obs.gauge(
    "pt_prefix_cache_resident_pages",
    "pages currently pinned by the prefix trie (refcount holders)")


class _TrieNode:
    __slots__ = ("block", "pages", "parent", "children", "last_used")

    def __init__(self, block, pages, parent):
        self.block = block      # tuple of block_tokens token ids
        self.pages = pages      # tuple of physical page ids (aligned)
        self.parent = parent
        self.children = {}      # block tuple -> _TrieNode
        self.last_used = 0


class RadixPrefixCache:
    """Token-trie index over a `PagePool`'s resident KV pages (module
    docstring has the design). The cache owns one pool reference per
    indexed page; `match()` hands the caller one more per mapped page
    (released through the ordinary `pool.free` path when the request's
    pages are released)."""

    def __init__(self, pool, page_size, block_tokens=None):
        self.pool = pool
        self.page_size = int(page_size)
        self.block_tokens = int(block_tokens or page_size)
        if (self.block_tokens < self.page_size
                or self.block_tokens % self.page_size):
            raise ValueError(
                f"block_tokens {self.block_tokens} must be a positive "
                f"multiple of page_size {self.page_size}: the trie maps "
                "whole pages, so a hash block must cover an exact page "
                "count")
        self.pages_per_block = self.block_tokens // self.page_size
        self._root = _TrieNode(None, (), None)
        self._clock = itertools.count(1)
        self._nodes = 0
        self._resident_published = 0
        # KV tier hook (fleet_serving.kv_tier, docs/SERVING.md "KV
        # memory hierarchy"): called with the dying node BEFORE its
        # pages are freed, so the engine can snapshot them D2H and
        # spill to the host-RAM tier. None = eviction simply drops.
        # clear() does NOT spill — a cleared trie means the pool's
        # bytes are invalid (abort path) or the engine is retiring.
        self.spill_fn = None
        # local mirror of the registry counters (per-cache attribution:
        # the registry is process-global across engines)
        self.stats = {"hits": 0, "misses": 0, "pages_shared": 0,
                      "tokens_saved": 0, "cow_splits": 0,
                      "evicted_pages": 0, "inserted_blocks": 0}

    # ---- introspection ----

    @property
    def num_nodes(self):
        return self._nodes

    @property
    def resident_pages(self):
        return self._nodes * self.pages_per_block

    def _touch(self, node):
        node.last_used = next(self._clock)

    def _publish_resident(self):
        # the gauge is process-global: publish the DELTA so several
        # engines' caches SUM into it instead of last-writer-wins
        cur = self.resident_pages
        _RESIDENT.inc(cur - self._resident_published)
        self._resident_published = cur

    # ---- lookup ----

    def match(self, tokens):
        """Longest cached prefix of `tokens` at block granularity.

        Returns (cached_tokens, page_ids): the caller now HOLDS one
        pool reference per returned page (``pool.share`` applied) and
        must release them through ``pool.free`` — either when the
        request's pages are released or immediately on an abandoned
        admission attempt."""
        bt = self.block_tokens
        node = self._root
        pages = []
        cached = 0
        while cached + bt <= len(tokens):
            blk = tuple(int(t) for t in tokens[cached:cached + bt])
            child = node.children.get(blk)
            if child is None:
                break
            node = child
            self._touch(node)
            for p in node.pages:
                self.pool.share(p)
            pages.extend(node.pages)
            cached += bt
        return cached, pages

    def note_mapped(self, cached_tokens, pages, cow_splits=0):
        """Telemetry for a mapping that actually ADMITTED (called by
        the engine once per successful admission — match() and
        cow_split() run on every admission ATTEMPT, including ones
        pushed back for a slot, and must not inflate hit/split rates):
        prefill tokens skipped + pages aliased + COW splits taken."""
        if cow_splits:
            self.stats["cow_splits"] += cow_splits
            _COW_SPLITS.inc(cow_splits)
        if cached_tokens:
            self.stats["hits"] += 1
            self.stats["tokens_saved"] += int(cached_tokens)
            self.stats["pages_shared"] += len(pages)
            _HITS.inc()
            _TOKENS_SAVED.inc(int(cached_tokens))
            _PAGES_SHARED.inc(len(pages))
        else:
            self.stats["misses"] += 1

    def cow_split(self, pages):
        """Drop the tail block's shared mapping so its rows can be
        recomputed into private pages (module docstring: COW-by-
        recompute). `pages` is the FULL mapped list; the last block's
        pages are released in place. Returns the tokens un-cached.
        NOT counted here — the engine reports splits through
        `note_mapped` on successful admission only, so a request
        re-splitting across pushed-back admission attempts counts
        once."""
        tail = pages[-self.pages_per_block:]
        del pages[-self.pages_per_block:]
        self.pool.free(tail)
        return self.block_tokens

    # ---- registration ----

    def insert(self, tokens, pages):
        """Index fully-written pages under their token blocks. `tokens`
        and `pages` must be block-aligned views of one request's
        prefilled prompt (positions 0..len(tokens)); only full blocks
        register. Idempotent: blocks already present (including ones
        this request itself mapped from the trie) are left untouched —
        no re-share, no replacement, so two requests racing the same
        new prefix keep the first registration and the loser simply
        stays private. Returns the number of NEW nodes."""
        bt, ppb = self.block_tokens, self.pages_per_block
        node = self._root
        new = 0
        for b in range(len(tokens) // bt):
            blk = tuple(int(t) for t in tokens[b * bt:(b + 1) * bt])
            child = node.children.get(blk)
            if child is None:
                pg = tuple(int(p) for p in pages[b * ppb:(b + 1) * ppb])
                for p in pg:
                    self.pool.share(p)
                child = _TrieNode(blk, pg, node)
                node.children[blk] = child
                self._nodes += 1
                new += 1
            self._touch(child)
            node = child
        if new:
            self.stats["inserted_blocks"] += new
            self._publish_resident()
        return new

    # ---- reclamation ----

    def _evictable_leaves(self):
        out = []
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif all(self.pool.refcount(p) == 1 for p in n.pages):
                out.append(n)
        return out

    def _drop(self, node):
        del node.parent.children[node.block]
        if self.spill_fn is not None:
            # snapshot-before-free: after pool.free these page ids are
            # reusable and the bytes can be overwritten any tick. The
            # hook owns its own error handling (a failed spill must
            # never block the eviction that is relieving pool pressure).
            self.spill_fn(node)
        self.pool.free(node.pages)
        self._nodes -= 1
        return len(node.pages)

    def reclaimable_pages(self):
        """Pages a full eviction cascade could free: every node whose
        subtree pins NO live-mapped (refcount > 1) page is ultimately
        evictable (leaves first, then their newly-leaf parents). The
        engine's admission feasibility check reads this BEFORE
        preempting runners, so running sequences never lose their KV
        for an admission that cannot succeed anyway. Iterative like
        every other trie traversal here: a long-context prompt chains
        one node per block, deeper than python's recursion limit."""
        order = []
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            order.append(n)
            stack.extend(n.children.values())
        free = 0
        pinned = {}   # id(node) -> subtree pins a live-mapped page
        for n in reversed(order):   # preorder reversed: children first
            pin = (any(self.pool.refcount(p) > 1 for p in n.pages)
                   or any(pinned[id(c)] for c in n.children.values()))
            pinned[id(n)] = pin
            if not pin:
                free += len(n.pages)
        return free

    def evict(self, num_pages):
        """Reclaim >= `num_pages` pages from trie-only nodes (pool
        refcount 1), least-recently-used leaves first. Returns pages
        actually freed (0 when every resident page is still mapped by a
        live request). ONE tree scan seeds an LRU heap and a dropped
        victim's parent enters it as its subtree drains — an eviction
        cascade is O(nodes log nodes), not O(nodes²) of rescans on the
        admission path."""
        freed = 0
        heap = [(n.last_used, id(n), n)
                for n in self._evictable_leaves()]
        heapq.heapify(heap)
        while freed < num_pages and heap:
            _, _, victim = heapq.heappop(heap)
            freed += self._drop(victim)
            parent = victim.parent
            if (parent is not self._root and not parent.children
                    and all(self.pool.refcount(p) == 1
                            for p in parent.pages)):
                heapq.heappush(heap,
                               (parent.last_used, id(parent), parent))
        if freed:
            self.stats["evicted_pages"] += freed
            _EVICTED.inc(freed)
            self._publish_resident()
        return freed

    def clear(self):
        """Drop every node and release the trie's pool references —
        the engine's abort path (re-zeroed pools invalidate all cached
        KV) and teardown."""
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            self.pool.free(n.pages)
        self._root = _TrieNode(None, (), None)
        self._nodes = 0
        self._publish_resident()

    def snapshot(self):
        """Metrics view for `LLMEngine.metrics()` (per-cache counters,
        unlike the process-global registry)."""
        out = dict(self.stats)
        out["nodes"] = self._nodes
        out["resident_pages"] = self.resident_pages
        out["block_tokens"] = self.block_tokens
        return out
