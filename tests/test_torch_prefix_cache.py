"""Radix prefix cache: the PyTorch port against the JAX package on CPU.

The trie (`RadixPrefixCache`) must give the reference trie's results,
refcounts and snapshots under the same operation sequence. With
`prefix_cache=True` the port engine's greedy tokens, prefill-token count
and cache snapshot must equal the reference engine's (gpt_tiny, the same
weights in both), and its tokens must equal the port's own engine
without the cache — at k=1, fused decode_k 4 and n-gram speculation, on
float32, int8 and int4 pools; plus copy-on-write on a fully cached
prompt, eviction under pool pressure and a preemption replaying through
the cache. Mirrors the prefix-cache cases of tests/test_fleet_serving.py.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import llm_engine as jeng
from paddle_tpu.inference.fleet_serving import (
    RadixPrefixCache as JaxRadix)
from paddle_tpu.text.models import GPTForCausalLM as JaxGPT
from paddle_tpu.text.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.convert import export_state_dict
from paddle_tpu_torch.inference import llm_engine as teng
from paddle_tpu_torch.inference.fleet_serving import RadixPrefixCache
from paddle_tpu_torch.inference.fleet_serving import prefix_cache as tpc
from paddle_tpu_torch.text.models.gpt import GPTForCausalLM, gpt_tiny

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs in several
    worker processes at once, and torch's thread pool oversubscribes the
    cores then (small ops slow down tenfold); results do not change."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


VOCAB = 2048
ENGINE = dict(num_slots=2, page_size=16, token_budget=8, max_model_len=96)
STATS = ("steps", "tokens_in", "generated", "finished", "preemptions")


@pytest.fixture(autouse=True)
def _serial_mesh():
    from paddle_tpu.distributed import mesh as mesh_mod

    mesh_mod.reset_mesh()
    yield


@pytest.fixture(scope="module")
def pair():
    """gpt_tiny in both packages, the port's seeded init copied into the
    reference (under it a random model repeats its own tokens, so the
    n-gram engine's windows accept proposals)."""
    from paddle_tpu.distributed import mesh as mesh_mod

    mesh_mod.reset_mesh()
    tm = GPTForCausalLM(gpt_tiny(), device="cpu", seed=43)
    jm = JaxGPT(jax_gpt_tiny())
    jm.set_state_dict({k: paddle.to_tensor(v)
                       for k, v in export_state_dict(tm).items()})
    jm.eval()
    return jm, tm


def _drain(eng, cap=2000):
    steps = 0
    while eng.has_work():
        eng.step()
        eng.pool.assert_consistent()
        steps += 1
        assert steps < cap, "engine failed to drain"
    return steps


def _serve(eng, prompts, max_new, staged=False):
    """Serve `prompts`; `staged` drains after each submission, so every
    later request can hit the blocks the earlier ones published."""
    reqs = []
    for p in prompts:
        reqs.append(eng.add_request(p, max_new_tokens=max_new))
        if staged:
            _drain(eng)
    _drain(eng)
    return [r.future.result(timeout=0) for r in reqs]


def _prefill(eng):
    return eng.stats["tokens_in"] - eng.stats["generated"]


def _shared_prompts(seed, sys_len=32, suffixes=(5, 9, 3, 12)):
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(0, VOCAB, (sys_len,))
    return [np.concatenate([sys_p, rng.integers(0, VOCAB, (L,))])
            for L in suffixes]


def _both(pair, prompts, max_new, staged=False, **cfg):
    """The same prompts through the reference and the port engine with
    the same config; tokens, schedule stats, prefill tokens and the
    trie snapshot must agree. Returns the port engine and its tokens."""
    jm, tm = pair
    je = jeng.LLMEngine(jm, jeng.LLMEngineConfig(**cfg))
    te = teng.LLMEngine(tm, teng.LLMEngineConfig(**cfg))
    jout = _serve(je, prompts, max_new, staged)
    tout = _serve(te, prompts, max_new, staged)
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(b, a)
    for key in STATS:
        assert te.stats[key] == je.stats[key], key
    assert _prefill(te) == _prefill(je)
    if cfg.get("prefix_cache"):
        assert te.prefix_cache.snapshot() == je.prefix_cache.snapshot()
    return te, tout


# ---- config ----

def test_config_rejects_misaligned_hash_block():
    with pytest.raises(ValueError, match="divide hash_block_tokens"):
        teng.LLMEngineConfig(page_size=16, prefix_cache=True,
                             hash_block_tokens=24)
    with pytest.raises(ValueError, match="divide hash_block_tokens"):
        teng.LLMEngineConfig(page_size=16, prefix_cache=True,
                             hash_block_tokens=8)
    assert teng.LLMEngineConfig(
        page_size=16, prefix_cache=True,
        hash_block_tokens=32).hash_block_tokens == 32
    assert teng.LLMEngineConfig(page_size=16, prefix_cache=False,
                                hash_block_tokens=24).prefix_cache is False
    with pytest.raises(ValueError, match="hash_block_tokens"):
        teng.LLMEngineConfig(page_size=16, prefix_cache=True,
                             hash_block_tokens=0)


def test_config_prefix_cache_env_knob(monkeypatch):
    monkeypatch.setenv("PT_PREFIX_CACHE", "1")
    assert teng.LLMEngineConfig().prefix_cache is True
    monkeypatch.setenv("PT_PREFIX_CACHE", "0")
    assert teng.LLMEngineConfig().prefix_cache is False
    assert teng.LLMEngineConfig(prefix_cache=True).prefix_cache is True
    monkeypatch.delenv("PT_PREFIX_CACHE")
    assert teng.LLMEngineConfig().prefix_cache is False
    with pytest.raises(ValueError, match="multiple of page_size"):
        RadixPrefixCache(teng.PagePool(4, 16), 16, block_tokens=24)


# ---- the trie against the reference trie ----

def _trie_ops(seed, n_ops=60):
    """A seeded operation sequence over a small token alphabet (so
    prefixes collide): insert / match / evict / cow_split /
    reclaimable_pages / release."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n_ops):
        kind = rng.choice(["insert", "insert", "match", "match", "evict",
                           "release", "reclaim"])
        n_blocks = int(rng.integers(1, 4))
        toks = [int(t) for t in rng.integers(0, 3, (4 * n_blocks,))]
        ops.append((str(kind), toks, int(rng.integers(1, 4))))
    return ops


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trie_matches_reference_under_the_same_ops(seed):
    """Each side owns its own pool; every result, every refcount and
    every snapshot must agree after every operation."""
    sides = []
    for pool_cls, cache_cls in ((jeng.PagePool, JaxRadix),
                                (teng.PagePool, RadixPrefixCache)):
        pool = pool_cls(num_pages=40, page_size=4)
        sides.append((pool, cache_cls(pool, page_size=4), []))
    for kind, toks, n in _trie_ops(seed):
        results = []
        for pool, cache, held in sides:
            if kind == "insert":
                if pool.num_free < len(toks) // 4:
                    results.append(None)
                    continue
                pages = [pool.alloc() for _ in range(len(toks) // 4)]
                res = cache.insert(toks, pages)
                pool.free(pages)           # the trie keeps its own ref
            elif kind == "match":
                cached, pages = cache.match(toks + [9])
                if pages and cached >= len(toks):
                    cached -= cache.cow_split(pages)
                held.append(pages)
                res = (cached, list(pages))
            elif kind == "evict":
                res = cache.evict(n)
            elif kind == "release":
                res = None
                if held:
                    pool.free(held.pop(0))
            else:
                res = cache.reclaimable_pages()
            results.append(res)
        assert results[0] == results[1], kind
        (jp, jc, _), (tp, tc, _) = sides
        assert tc.snapshot() == jc.snapshot()
        assert tp.num_free == jp.num_free and tp.num_live == jp.num_live
        assert ({p: tp.refcount(p) for p in range(1, 40)}
                == {p: jp.refcount(p) for p in range(1, 40)})
    for pool, cache, held in sides:
        for pages in held:
            pool.free(pages)
        cache.clear()
        pool.assert_consistent()
        assert pool.num_live == 0


def test_radix_cache_match_insert_refcounts():
    pool = teng.PagePool(num_pages=10, page_size=4)
    cache = RadixPrefixCache(pool, page_size=4)
    toks = list(range(100, 112))           # 3 full blocks of 4
    pages = [pool.alloc() for _ in range(3)]
    assert cache.insert(toks, pages) == 3
    assert cache.num_nodes == 3 and cache.resident_pages == 3
    assert all(pool.refcount(p) == 2 for p in pages)  # owner + trie
    assert cache.insert(toks, pages) == 0              # idempotent
    cached, mapped = cache.match(toks + [7, 8])
    assert cached == 12 and mapped == pages
    assert all(pool.refcount(p) == 3 for p in pages)
    pool.free(mapped)
    cached, mapped = cache.match(toks[:8] + [55, 56, 57, 58])
    assert cached == 8 and mapped == pages[:2]
    pool.free(mapped)
    cached, mapped = cache.match([1, 2, 3, 4] + toks)  # path-keyed
    assert cached == 0 and mapped == []
    pool.free(pages)
    assert all(pool.refcount(p) == 1 for p in pages)
    cache.clear()
    assert pool.num_live == 0
    pool.assert_consistent()


def test_radix_cache_lru_eviction_leaves_first():
    pool = teng.PagePool(num_pages=8, page_size=4)
    cache = RadixPrefixCache(pool, page_size=4)
    a = [pool.alloc() for _ in range(2)]
    b = [pool.alloc() for _ in range(2)]
    cache.insert([1, 2, 3, 4, 5, 6, 7, 8], a)
    cache.insert([9, 10, 11, 12, 13, 14, 15, 16], b)
    pool.free(a + b)
    pool.free(cache.match([1, 2, 3, 4, 5, 6, 7, 8])[1])   # A is MRU
    assert cache.evict(1) >= 1
    cached_b, mapped_b = cache.match([9, 10, 11, 12, 13, 14, 15, 16])
    assert cached_b <= 4
    pool.free(mapped_b)
    cached, mapped = cache.match([1, 2, 3, 4])
    assert cached == 4
    assert cache.evict(100) >= 1
    assert cache.match([5, 6, 7, 8])[0] == 0
    pool.free(mapped)
    cache.clear()
    pool.assert_consistent()
    assert pool.num_live == 0


def test_reclaimable_pages_counts_cascade_not_mapped():
    pool = teng.PagePool(num_pages=8, page_size=4)
    cache = RadixPrefixCache(pool, page_size=4)
    a = [pool.alloc() for _ in range(3)]
    cache.insert(list(range(1, 13)), a)
    pool.free(a)
    assert cache.reclaimable_pages() == 3
    cached, mapped = cache.match([1, 2, 3, 4])
    assert cached == 4
    assert cache.reclaimable_pages() == 2
    assert cache.evict(100) == 2
    pool.free(mapped)
    assert cache.reclaimable_pages() == 1
    cache.clear()
    pool.assert_consistent()


def test_reclaimable_pages_deep_chain_no_recursion_limit():
    depth = 1500
    pool = teng.PagePool(depth + 2, 1)
    cache = RadixPrefixCache(pool, page_size=1)
    pages = [pool.alloc() for _ in range(depth)]
    cache.insert(list(range(depth)), pages)
    pool.free(pages)
    assert cache.reclaimable_pages() == depth
    assert cache.evict(depth) == depth
    pool.assert_consistent()


def test_resident_pages_gauge_sums_across_caches():
    prev = tobs.set_mode("metrics")
    try:
        base = tpc._RESIDENT.value
        pool_a, pool_b = teng.PagePool(8, 4), teng.PagePool(8, 4)
        ca = RadixPrefixCache(pool_a, page_size=4)
        cb = RadixPrefixCache(pool_b, page_size=4)
        ca.insert(list(range(8)), [pool_a.alloc() for _ in range(2)])
        cb.insert(list(range(4)), [pool_b.alloc()])
        assert tpc._RESIDENT.value - base == 3
        cb.clear()
        assert tpc._RESIDENT.value - base == 2
        ca.clear()
        assert tpc._RESIDENT.value - base == 0
    finally:
        tobs.set_mode(prev)


# ---- the engine with the cache against the reference engine ----

MODES = {"k1": {}, "fused4": {"decode_k": 4}, "ngram": {"spec_mode": "ngram",
                                                        "spec_k": 4}}


@pytest.mark.parametrize("kv_dtype", ["float32", "int8", "int4"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_prefix_hit_parity_with_reference(pair, mode, kv_dtype):
    """Shared system prompt (2 pages) + distinct suffixes: the later
    requests map the published blocks and skip their prefill. Tokens,
    prefill tokens and the trie snapshot equal the reference engine's;
    tokens equal the port's own engine without the cache, which
    prefilled exactly `tokens_saved` more tokens."""
    prompts = _shared_prompts(5)
    cfg = dict(ENGINE, kv_dtype=kv_dtype, **MODES[mode])
    te, cached = _both(pair, prompts, 6, staged=True, prefix_cache=True,
                       **cfg)
    snap = te.prefix_cache.snapshot()
    assert snap["hits"] >= 3 and snap["tokens_saved"] >= 96, snap
    cold = teng.LLMEngine(pair[1], teng.LLMEngineConfig(**cfg))
    plain = _serve(cold, prompts, 6, staged=True)
    for a, b in zip(cached, plain):
        np.testing.assert_array_equal(a, b)
    assert _prefill(te) == _prefill(cold) - snap["tokens_saved"]
    assert te.pool.num_live == snap["resident_pages"]
    assert te.metrics()["prefix_cache"]["hits"] == snap["hits"]
    te.close()
    assert te.pool.num_live == 0


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_cow_split_on_fully_cached_prompt(pair, kv_dtype):
    """A prompt of an exact page multiple, fully cached: the frontier
    token's KV write would land inside the last shared page, so the
    mapping splits copy-on-write; tokens equal the first run's and the
    reference's."""
    p32 = np.random.default_rng(6).integers(0, VOCAB, (32,))
    te, (r1, r2) = _both(pair, [p32, p32], 5, staged=True,
                         prefix_cache=True, kv_dtype=kv_dtype, **ENGINE)
    snap = te.prefix_cache.snapshot()
    assert snap["cow_splits"] == 1 and snap["tokens_saved"] == 16, snap
    np.testing.assert_array_equal(r1, r2)


def test_prefix_cache_eviction_under_pool_pressure(pair):
    """Distinct prompts fill the trie until the pool runs dry: LRU
    trie-only pages are reclaimed, every request completes, and the
    schedule and tokens equal the reference's."""
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, VOCAB, (20,)) for _ in range(6)]
    te, outs = _both(pair, prompts, 6, prefix_cache=True,
                     **dict(ENGINE, num_pages=7, max_model_len=48))
    assert te.prefix_cache.snapshot()["evicted_pages"] > 0
    assert all(len(o) == 26 for o in outs)


def test_preempted_request_replays_through_cache(pair):
    """A preempted sequence re-prefills on re-admission and re-hits its
    own published prompt blocks; tokens equal the uncached run and the
    reference's, with the same preemptions."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, VOCAB, (20,)) for _ in range(4)]
    cfg = dict(num_slots=3, page_size=16, num_pages=8, max_model_len=48,
               token_budget=8)
    te, outs = _both(pair, prompts, 20, prefix_cache=True, **cfg)
    assert te.stats["preemptions"] > 0, "pool was not tight enough"
    assert te.sched.stats["preemptions_pool"] >= 1
    assert te.prefix_cache.snapshot()["tokens_saved"] > 0
    plain = _serve(teng.LLMEngine(pair[1], teng.LLMEngineConfig(**cfg)),
                   prompts, 20)
    for a, b in zip(outs, plain):
        np.testing.assert_array_equal(a, b)


def test_kv_fragmentation_not_zeroed_by_shared_pages(pair):
    sys_p = np.random.default_rng(41).integers(0, VOCAB, (32,))
    eng = teng.LLMEngine(pair[1], teng.LLMEngineConfig(
        **dict(ENGINE, token_budget=16), prefix_cache=True))
    eng.add_request(np.concatenate([sys_p, [5, 6, 7]]), max_new_tokens=8)
    _drain(eng)
    eng.add_request(np.concatenate([sys_p, [9]]), max_new_tokens=8)
    eng.add_request(np.concatenate([sys_p, [11]]), max_new_tokens=8)
    eng.step()
    live = [r for r in eng._slots if r is not None]
    assert len(live) == 2 and all(r.cached_prefix == 32 for r in live)
    cap = eng.pool.num_live * 16
    assert sum(r.n_prefilled for r in live) > cap
    waste = sum(len(r.pages) * 16 - r.n_prefilled for r in live)
    assert eng.kv_fragmentation() == pytest.approx(waste / cap)
    assert 0.0 < eng.kv_fragmentation() < 1.0
    _drain(eng)


def test_cow_split_counts_once_per_admission(pair):
    rng = np.random.default_rng(43)
    p32 = rng.integers(0, VOCAB, (32,))
    eng = teng.LLMEngine(pair[1], teng.LLMEngineConfig(
        **dict(ENGINE, num_slots=1), prefix_cache=True))
    eng.add_request(p32, max_new_tokens=12)
    _drain(eng)
    eng.add_request(rng.integers(0, VOCAB, (20,)), max_new_tokens=12)
    r2 = eng.add_request(p32, max_new_tokens=12)
    _drain(eng)
    assert r2.future.done()
    assert eng.prefix_cache.snapshot()["cow_splits"] == 1


def test_blocked_admission_skips_trie_walk(pair):
    rng = np.random.default_rng(23)
    eng = teng.LLMEngine(pair[1], teng.LLMEngineConfig(
        **dict(ENGINE, num_slots=1), prefix_cache=True))
    first = eng.add_request(rng.integers(0, VOCAB, (16,)),
                            max_new_tokens=12)
    eng.step()
    assert first.slot is not None
    blocked = eng.add_request(rng.integers(0, VOCAB, (16,)),
                              max_new_tokens=4)
    calls = []
    real_match = eng.prefix_cache.match
    eng.prefix_cache.match = lambda toks: (calls.append(1)
                                           or real_match(toks))
    for _ in range(3):
        eng.step()
    assert blocked.slot is None and not calls
    eng.prefix_cache.match = real_match
    _drain(eng)
    assert len(blocked.future.result(timeout=0)) == 20


def test_engine_close_retracts_resident_pages_gauge(pair):
    prev = tobs.set_mode("metrics")
    try:
        base = tpc._RESIDENT.value
        eng = teng.LLMEngine(pair[1], teng.LLMEngineConfig(
            **ENGINE, prefix_cache=True))
        r = eng.add_request(np.random.default_rng(29).integers(
            0, VOCAB, (32,)), max_new_tokens=4)
        _drain(eng)
        r.future.result(timeout=0)
        assert tpc._RESIDENT.value - base > 0
        eng.close()
        assert tpc._RESIDENT.value - base == 0
        eng.close()
        assert tpc._RESIDENT.value - base == 0
    finally:
        tobs.set_mode(prev)


def test_metrics_keys_match_reference(pair):
    """`metrics()` carries the reference's keys, and its prefix-cache
    block the reference's snapshot keys."""
    jm, tm = pair
    cfg = dict(ENGINE, prefix_cache=True)
    je = jeng.LLMEngine(jm, jeng.LLMEngineConfig(**cfg))
    te = teng.LLMEngine(tm, teng.LLMEngineConfig(**cfg))
    prompts = _shared_prompts(3, suffixes=(4, 6))
    _serve(je, prompts, 3, staged=True)
    _serve(te, prompts, 3, staged=True)
    jmx, tmx = je.metrics(), te.metrics()
    assert set(tmx) == set(jmx)
    assert set(tmx["prefix_cache"]) == set(jmx["prefix_cache"])
    assert set(tmx["sched"]) == set(jmx["sched"])
    assert tmx["prefix_cache"] == jmx["prefix_cache"]
    assert tmx["kv_pages_shared"] == jmx["kv_pages_shared"]
