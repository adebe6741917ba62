"""KV memory below the pool and chat sessions: the PyTorch port against
the JAX package on CPU.

`KVTierStore` (host-RAM and disk spill tiers) and the engine's
`kv_tier=` / `session_id=`: byte parity of a spill -> prefetch round
trip on every pool kind, a RAM hit, a spill fault that journals while
serving stays correct, restart hygiene of the disk tier, mmap reads, a
spill queue that never blocks, migration, session resume, pins that
cover generated tokens, TTL / LRU expiry, brownout shedding pins first —
mirroring tests/test_kv_tier.py — plus the cross-package cases: a frame
spilled by either package reads back byte-equal in the other, and with
the tier and sessions on the port's greedy tokens and prefill counts
equal the reference engine's (f32 / int8 / int4 pools at k=1 and
decode_k 4; n-gram speculation on f32). Every thread is joined with a
timeout; disk tiers live in tmp_path.
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import llm_engine as jeng
from paddle_tpu.inference.fleet_serving import KVTierStore as JaxTierStore
from paddle_tpu.inference.fleet_serving import prefix_key as jax_prefix_key
from paddle_tpu.text.models import GPTForCausalLM as JaxGPT
from paddle_tpu.text.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.convert import export_state_dict
from paddle_tpu_torch.distributed import chaos, resilience
from paddle_tpu_torch.inference import llm_engine as teng
from paddle_tpu_torch.inference.fleet_serving import (
    AutoscalePolicy, FleetRouter, KVPagePayload, KVTierStore, LocalReplica,
    fork_model, prefix_key)
from paddle_tpu_torch.inference.fleet_serving import kv_tier as kv_tier_mod
from paddle_tpu_torch.text.models.gpt import GPTForCausalLM, gpt_tiny

pytestmark = pytest.mark.torch_port

VOCAB = 2048


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs in several
    worker processes at once, and torch's thread pool oversubscribes the
    cores then; results do not change."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _serial_mesh():
    from paddle_tpu.distributed import mesh as mesh_mod

    mesh_mod.reset_mesh()
    yield


@pytest.fixture(autouse=True)
def _clean_chaos():
    chaos.clear()
    yield
    chaos.clear()


@pytest.fixture(scope="module")
def pair():
    """gpt_tiny in both packages with the port's seeded weights."""
    from paddle_tpu.distributed import mesh as mesh_mod

    mesh_mod.reset_mesh()
    tm = GPTForCausalLM(gpt_tiny(), device="cpu", seed=30)
    jm = JaxGPT(jax_gpt_tiny())
    jm.set_state_dict({k: paddle.to_tensor(v)
                       for k, v in export_state_dict(tm).items()})
    jm.eval()
    return jm, tm


@pytest.fixture(scope="module")
def model(pair):
    return pair[1]


def _drain(eng, cap=800):
    steps = 0
    while eng.has_work():
        eng.step()
        eng.pool.assert_consistent()
        steps += 1
        assert steps < cap, "engine failed to drain"
    return steps


def _ecfg(pkg=teng, **kw):
    base = dict(num_slots=4, page_size=16, token_budget=32,
                max_model_len=96, prefix_cache=True)
    base.update(kw)
    return pkg.LLMEngineConfig(**base)


def _prompts(rng, lens):
    return [rng.integers(0, VOCAB, (int(L),)).astype(np.int32)
            for L in lens]


def _payload_bytes(p):
    return ([np.asarray(a).tobytes() for a in p.kv],
            [np.asarray(a).tobytes() for a in p.scales])


def _mk_payload(rng, tokens=16, pages=1):
    """A synthetic f32 frame for store-level tests (no engine)."""
    toks = rng.integers(0, 1000, (tokens,)).astype(np.int32)
    kv = [rng.standard_normal((pages, 16, 2, 4)).astype(np.float32)]
    return toks, KVPagePayload(toks, tokens, 16, "float32", kv, [])


def _serve(eng, prompt, max_new=4, **kw):
    req = eng.add_request(prompt, max_new_tokens=max_new, **kw)
    _drain(eng)
    return req


# ---- round trips ----

@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8", "int4"])
def test_tier_round_trip_byte_parity(model, tmp_path, kv_dtype):
    """export -> spill (RAM) -> demote (disk) -> prefetch -> re-export is
    byte-identical for every pool and scale plane; ram_bytes=1 sends
    every frame through both tiers. Prompt 23 leaves a mid-page trie
    frontier, 33 covers two full blocks."""
    rng = np.random.default_rng(3)
    for plen in (23, 33):
        prompt = _prompts(rng, [plen])[0]
        eng = teng.LLMEngine(model, _ecfg(
            kv_dtype=kv_dtype,
            kv_tier=dict(ram_bytes=1, disk_dir=str(tmp_path / kv_dtype),
                         disk_bytes=1 << 30)))
        out = _serve(eng, prompt).future.result(timeout=0)
        ref = eng.export_prefix(prompt)
        assert ref is not None and ref.kv_dtype == kv_dtype
        assert bool(ref.scales) == (kv_dtype in ("int8", "int4"))
        assert eng.prefix_cache.evict(10_000) > 0
        eng.kv_tier.flush()
        snap = eng.kv_tier.snapshot()
        assert snap["spills"] > 0 and snap["demotions"] == snap["spills"]
        assert eng.prefix_cache.resident_pages == 0
        out2 = _serve(eng, prompt).future.result(timeout=0)
        assert eng.kv_tier.snapshot()["disk_hits"] > 0
        np.testing.assert_array_equal(out, out2)
        back = eng.export_prefix(prompt)
        assert back.n_prefilled == ref.n_prefilled
        np.testing.assert_array_equal(back.tokens, ref.tokens)
        assert _payload_bytes(back) == _payload_bytes(ref)
        eng.close()


def test_tier_ram_hit_round_trip(model):
    """RAM tier only: spill -> prefetch from RAM, tokens identical, the
    kv_prefetch stamp on the resumed request, the tier block and the
    hbm rung in metrics()."""
    rng = np.random.default_rng(5)
    prompt = _prompts(rng, [48])[0]
    eng = teng.LLMEngine(model, _ecfg(kv_tier=dict(ram_bytes=64 << 20)))
    out = _serve(eng, prompt).future.result(timeout=0)
    assert eng.prefix_cache.evict(10_000) > 0
    eng.kv_tier.flush()
    req2 = _serve(eng, prompt)
    np.testing.assert_array_equal(out, req2.future.result(timeout=0))
    snap = eng.kv_tier.snapshot()
    assert snap["ram_hits"] > 0 and snap["disk_hits"] == 0
    assert "kv_prefetch" in [p["phase"] for p in req2.trace.timeline()]
    assert eng.stats["kv_pages_prefetched"] == 3
    assert eng.stats["kv_pages_spilled"] == 3
    m = eng.metrics()["kv_tier"]
    assert m["ram_entries"] == 3 and m["ram_hits"] == snap["ram_hits"]
    assert kv_tier_mod._TIER_PAGES.labels(tier="hbm").value == \
        eng.pool.num_live
    eng.close()
    assert not eng.kv_tier._thread.is_alive()


# ---- faults and restart hygiene ----

def test_spill_fault_journals_and_serving_stays_correct(model):
    """A seeded fault in the commit thread journals
    (`kv_tier_spill_failed`), drops the entry, and serving stays
    token-identical: the tier is never a correctness dependency."""
    rng = np.random.default_rng(11)
    prompt = _prompts(rng, [48])[0]
    chaos.install({"seed": 7, "injectors": [
        {"scope": "kv_tier.spill", "kind": "error", "at": [0, 1, 2]}]})
    before = len(resilience.events("kv_tier_spill_failed"))
    eng = teng.LLMEngine(model, _ecfg(kv_tier=dict(ram_bytes=64 << 20)))
    out = _serve(eng, prompt).future.result(timeout=0)
    assert eng.prefix_cache.evict(10_000) > 0
    eng.kv_tier.flush()
    snap = eng.kv_tier.snapshot()
    assert snap["spill_failed"] == 3 and snap["ram_entries"] == 0
    evs = resilience.events("kv_tier_spill_failed")
    assert len(evs) == before + 3
    assert "InjectedFault" in evs[-1]["error"]
    out2 = _serve(eng, prompt).future.result(timeout=0)
    np.testing.assert_array_equal(out, out2)
    assert eng.kv_tier.snapshot()["misses"] > 0
    eng.close()


def test_disk_restart_gc_and_adopt(tmp_path):
    """A new store over the same directory removes `.tmp` leftovers and
    unparseable frames (journaled as `kv_tier_gc`) and adopts intact
    frames byte-identical."""
    rng = np.random.default_rng(2)
    d = str(tmp_path / "tier")
    store = KVTierStore(ram_bytes=1, disk_dir=d, disk_bytes=1 << 30)
    toks, payload = _mk_payload(rng)
    assert store.put(prefix_key(toks), payload)
    store.flush()
    assert store.snapshot()["demotions"] == 1
    store.close()
    with open(os.path.join(d, "deadbeef.ptkv.tmp"), "wb") as f:
        f.write(b"half a frame")
    with open(os.path.join(d, "c0ffee00.ptkv"), "wb") as f:
        f.write(b"PTKVgarbage-that-is-not-a-frame")
    before = len(resilience.events("kv_tier_gc"))
    store2 = KVTierStore(ram_bytes=1, disk_dir=d, disk_bytes=1 << 30)
    snap = store2.snapshot()
    assert snap["adopted"] == 1 and snap["gc_files"] == 2
    assert len(resilience.events("kv_tier_gc")) == before + 2
    left = sorted(os.listdir(d))
    assert len(left) == 1 and left[0].endswith(".ptkv")
    back = store2.get(prefix_key(toks))
    np.testing.assert_array_equal(back.tokens, payload.tokens)
    assert _payload_bytes(back) == _payload_bytes(payload)
    store2.close()


def test_disk_mmap_read_byte_identity(tmp_path, monkeypatch):
    """The mmap read path returns the streamed read's bytes; the knob
    flows through `mmap=` and the PT_KV_TIER_MMAP default."""
    rng = np.random.default_rng(7)
    d = str(tmp_path / "tier")
    store = KVTierStore(ram_bytes=1, disk_dir=d, disk_bytes=1 << 30,
                        mmap=True)
    frames = {}
    for i in range(3):
        toks, payload = _mk_payload(rng, tokens=8 + i)
        frames[prefix_key(toks)] = payload
        assert store.put(prefix_key(toks), payload)
    store.flush()
    for key, ref in frames.items():
        back = store.get(key)
        assert isinstance(back.kv[0], np.memmap)
        assert _payload_bytes(back) == _payload_bytes(ref)
    assert store.snapshot()["mmap_reads"] == 3
    store.close()
    store2 = KVTierStore(ram_bytes=1, disk_dir=d, disk_bytes=1 << 30,
                         mmap=False)
    assert store2.snapshot()["adopted"] == 3
    for key, ref in frames.items():
        back = store2.get(key)
        assert not isinstance(back.kv[0], np.memmap)
        assert _payload_bytes(back) == _payload_bytes(ref)
    store2.close()
    monkeypatch.setenv("PT_KV_TIER_MMAP", "0")
    store3 = KVTierStore(ram_bytes=1 << 20)
    assert store3.use_mmap is False
    store3.close()


def test_spill_queue_never_blocks(monkeypatch):
    """`put` never waits on the commit thread: with the thread wedged
    mid-pack, puts past the queue bound reject (counted) at once."""
    rng = np.random.default_rng(4)
    gate = threading.Event()
    real_pack = kv_tier_mod.pack_kv_payload

    def slow_pack(payload):
        gate.wait(timeout=30)
        return real_pack(payload)

    monkeypatch.setattr(kv_tier_mod, "pack_kv_payload", slow_pack)
    store = KVTierStore(ram_bytes=64 << 20, max_pending=2)
    try:
        payloads = [_mk_payload(rng) for _ in range(4)]
        t0 = time.monotonic()
        results = [store.put(prefix_key(t), p) for t, p in payloads]
        assert time.monotonic() - t0 < 1.0, "put blocked"
        assert results.count(False) >= 1
        assert store.snapshot()["spill_rejected"] >= 1
        gate.set()
        store.flush()
        assert store.snapshot()["spills"] == results.count(True)
    finally:
        gate.set()
        store.close()
    assert not store._thread.is_alive()


# ---- across the packages ----

@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8", "int4"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_frames_cross_packages(pair, tmp_path, kv_dtype, writer):
    """A frame one package's engine spills to disk is adopted by the
    other package's store and reads back byte-equal, under the same
    `prefix_key`."""
    jm, tm = pair
    rng = np.random.default_rng(21)
    prompt = _prompts(rng, [40])[0]
    assert prefix_key(prompt) == jax_prefix_key(prompt)
    d = str(tmp_path / "tier")
    pkg, mdl = (teng, tm) if writer == "port" else (jeng, jm)
    eng = pkg.LLMEngine(mdl, _ecfg(pkg, kv_dtype=kv_dtype, kv_tier=dict(
        ram_bytes=1, disk_dir=d, disk_bytes=1 << 30)))
    _serve(eng, prompt)
    assert eng.prefix_cache.evict(10_000) == 2
    eng.kv_tier.flush()
    keys = [prefix_key(prompt[:n]) for n in (16, 32)]
    mine = [eng.kv_tier.get(k) for k in keys]
    eng.close()
    other = (JaxTierStore if writer == "port" else KVTierStore)(
        ram_bytes=1, disk_dir=d, disk_bytes=1 << 30)
    try:
        assert other.snapshot()["adopted"] == 2
        for k, a in zip(keys, mine):
            b = other.get(k)
            assert b.kv_dtype == a.kv_dtype == kv_dtype
            assert b.n_prefilled == a.n_prefilled
            np.testing.assert_array_equal(b.tokens, a.tokens)
            assert _payload_bytes(b) == _payload_bytes(a)
    finally:
        other.close()


def _chat(pkg, mdl, kv_dtype, tier_dir, **knobs):
    """3 sessions x 2 turns, each prompt the previous turn's output plus
    12 user tokens, on a pool that evicts histories between turns; the
    commit thread is drained after each turn so both packages see the
    same tier."""
    rng = np.random.default_rng(31)
    users = [[rng.integers(0, VOCAB, (12,)).astype(np.int32)
              for _ in range(2)] for _ in range(3)]
    eng = pkg.LLMEngine(mdl, _ecfg(
        pkg, num_slots=2, max_model_len=128, num_pages=5,
        kv_dtype=kv_dtype, kv_tier=dict(ram_bytes=1 << 20,
                                        disk_dir=tier_dir), **knobs))
    history, outs = [None] * 3, []
    for t in range(2):
        for s in range(3):
            prompt = (users[s][t] if history[s] is None else np.concatenate(
                [history[s].astype(np.int32), users[s][t]]))
            out = _serve(eng, prompt, 6,
                         session_id=f"chat-{s}").future.result(timeout=0)
            eng.kv_tier.flush()
            history[s] = out
            outs.append(out)
    stats = {k: eng.stats.get(k, 0) for k in (
        "kv_pages_spilled", "kv_pages_prefetched", "sessions_resumed")}
    stats["prefill"] = eng.stats["tokens_in"] - eng.stats["generated"]
    eng.close()
    return outs, stats


_PATHS = {"k1": dict(decode_k=1), "k4": dict(decode_k=4),
          "ngram": dict(spec_mode="ngram", spec_k=4)}


@pytest.mark.parametrize("kv_dtype,path", [
    (kv, p) for kv in ("float32", "int8", "int4") for p in ("k1", "k4")]
    + [("float32", "ngram")])
def test_tier_sessions_match_reference(pair, tmp_path, kv_dtype, path):
    """With the tier and session ids on, the port's tokens, prefill
    count, spilled / prefetched pages and resumed sessions equal the
    reference engine's: single ticks (K1), fused windows, and n-gram
    verify windows (K2)."""
    jm, tm = pair
    jout, jst = _chat(jeng, jm, kv_dtype, str(tmp_path / "j"),
                      **_PATHS[path])
    tout, tst = _chat(teng, tm, kv_dtype, str(tmp_path / "t"),
                      **_PATHS[path])
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(b, a)
    assert tst == jst
    assert tst["kv_pages_prefetched"] > 0 and tst["sessions_resumed"] > 0


# ---- migration and the fleet's tier signal ----

def test_migration_with_tiers_token_identical(model):
    """Two tiered replicas behind the router: a hot prefix's pages are
    pulled to the idle peer over the KV wire, the tokens equal a plain
    engine's, and the fleet's tier block folds both replicas' real
    snapshots into the autoscale signal."""
    rng = np.random.default_rng(15)
    sysp = _prompts(rng, [32])[0]
    prompts = [np.concatenate([sysp, _prompts(rng, [3 + j])[0]])
               for j in range(6)]
    plain = teng.LLMEngine(model, _ecfg(prefix_cache=False))
    ref = [_serve(plain, p, 6).future.result(timeout=0) for p in prompts]

    def make(name):
        return LocalReplica(fork_model(model), name=name, config=_ecfg(
            kv_tier=dict(ram_bytes=64 << 20)))

    a, b = make("a"), make("b")
    router = FleetRouter(replicas=[a, b], migrate_hot_hits=2,
                         migrate_interval_s=60.0, migrate_budget=1,
                         policy=AutoscalePolicy(min_replicas=2,
                                                max_replicas=2))
    with router:
        first = router.submit(prompts[0], max_new_tokens=6)
        first.result(timeout=60)
        holder = a if a.engine.prefix_cache.resident_pages else b
        peer = b if holder is a else a
        busy = holder.submit(_prompts(rng, [20])[0], max_new_tokens=60)
        deadline = time.monotonic() + 10
        while holder.load() <= peer.load() and time.monotonic() < deadline:
            time.sleep(0.02)
        futs = [router.submit(p, max_new_tokens=6) for p in prompts[1:]]
        outs = [first.result()] + [f.result(timeout=120) for f in futs]
        busy.result(timeout=120)
        m = router.metrics()
        pressure = router._fleet_spill_pressure(router._alive_replicas())
    for x, y in zip(ref, outs):
        np.testing.assert_array_equal(x, y)
    assert m["migrations"] == 1 and m["migration_failures"] == 0
    assert m["kv_tier"]["replicas_with_tier"] == 2
    assert pressure is None or 0.0 <= pressure <= 1.0


def test_tier_spill_pressure_drives_scale_up(model, monkeypatch):
    """The autoscaler reads real tier snapshots: a replica whose commit
    thread is wedged (a one-job queue) rejects its spills, its tier
    block shows spill pressure 0.5, and the router scales out on the
    second hot tick with the queue empty."""
    gate = threading.Event()
    real_pack = kv_tier_mod.pack_kv_payload

    def wedged_pack(payload):
        gate.wait(timeout=30)
        return real_pack(payload)

    monkeypatch.setattr(kv_tier_mod, "pack_kv_payload", wedged_pack)
    rep = LocalReplica(fork_model(model), name="hot", config=_ecfg(
        num_slots=2, num_pages=9,
        kv_tier=dict(ram_bytes=64 << 20, max_pending=1)))
    built = []

    def factory(name):
        r = LocalReplica(fork_model(model), name=name, config=_ecfg())
        built.append(r)
        return r

    router = FleetRouter(replicas=[rep], factory=factory,
                         policy=AutoscalePolicy(
                             min_replicas=1, max_replicas=2,
                             queue_high=1000, cooldown_s=0.0,
                             spill_high=0.5))
    try:
        rng = np.random.default_rng(8)
        for p in _prompts(rng, [40] * 8):
            rep.submit(p, max_new_tokens=2).result(timeout=60)
        snap = rep.engine.metrics()["kv_tier"]
        assert snap["spill_rejected"] > 0 and snap["spills"] == 0
        assert router._fleet_spill_pressure([rep]) == 0.5
        router._autoscale_tick()
        assert not built
        router._autoscale_tick()
        assert len(built) == 1 and router.stats["spill_scale_ups"] == 1
    finally:
        gate.set()
        router.stop()
    assert not rep.engine.kv_tier._thread.is_alive()


# ---- sessions ----

def test_session_resume_skips_history_prefill(model):
    """Turn 2 (turn 1's output + new tokens) resumes from the pinned
    frontier: the history's prefill is skipped and the resume telemetry
    fires; tokens equal a fresh engine's."""
    rng = np.random.default_rng(9)
    eng = teng.LLMEngine(model, _ecfg(max_model_len=128,
                                      kv_tier=dict(ram_bytes=64 << 20)))
    p1 = _prompts(rng, [40])[0]
    out1 = _serve(eng, p1, 8, session_id="chat-1").future.result(timeout=0)
    assert eng.metrics()["sessions"]["active"] == 1
    p2 = np.concatenate([out1.astype(np.int32), _prompts(rng, [10])[0]])
    r2 = _serve(eng, p2, 8, session_id="chat-1")
    assert eng.stats.get("sessions_resumed") == 1
    assert eng.metrics()["sessions"]["resumed"] == 1
    assert eng.prefix_cache.stats["tokens_saved"] == 32   # 47 rows written
    ref_eng = teng.LLMEngine(model, _ecfg(max_model_len=128,
                                          prefix_cache=False))
    np.testing.assert_array_equal(
        _serve(ref_eng, p2, 8).future.result(timeout=0),
        r2.future.result(timeout=0))
    eng.close()


def test_session_pin_covers_generated_tokens(model):
    """The pin covers generated tokens: the trie matches the whole
    output deeper than the prompt-only publish reaches."""
    rng = np.random.default_rng(13)
    p1 = _prompts(rng, [30])[0]
    eng = teng.LLMEngine(model, _ecfg(max_model_len=128))
    out1 = _serve(eng, p1, 8, session_id="s").future.result(timeout=0)
    cached, pages = eng.prefix_cache.match(out1.astype(np.int32))
    eng.pool.free(pages)
    assert cached == (len(out1) // 16) * 16 > (len(p1) // 16) * 16
    eng.close()


def test_session_ttl_and_lru_expiry(model):
    rng = np.random.default_rng(17)
    eng = teng.LLMEngine(model, _ecfg(session_max=2, session_ttl_s=600))
    for sid in ("a", "b", "c"):
        _serve(eng, _prompts(rng, [20])[0], 2,
               session_id=sid).future.result(timeout=0)
    assert set(eng._sessions) == {"b", "c"}       # LRU: "a" expired
    eng._sessions["b"]["last_used"] -= 1e6
    eng._touch_session("c")
    assert set(eng._sessions) == {"c"}
    assert eng.metrics()["sessions"]["active"] == 1
    assert kv_tier_mod._SESSION_ACTIVE.value == 1
    eng.close()


def test_brownout_sheds_session_pinning_before_traffic(model):
    """Ladder rung L4 (session_pin False) drops the tracked sessions and
    stops pinning finished turns; traffic shedding starts at L5."""
    from paddle_tpu_torch.inference.fleet_serving.overload import \
        DEFAULT_BROWNOUT_LEVELS as L

    assert L[4].get("session_pin") is False
    assert "shed_priority" not in L[4]
    assert L[5].get("shed_priority") is not None
    rng = np.random.default_rng(19)
    eng = teng.LLMEngine(model, _ecfg(max_model_len=128))
    _serve(eng, _prompts(rng, [40])[0], 4,
           session_id="s").future.result(timeout=0)
    assert eng.metrics()["sessions"]["active"] == 1
    resident = eng.prefix_cache.resident_pages
    eng.apply_brownout(dict(L[4]))
    _serve(eng, _prompts(rng, [40])[0], 4,
           session_id="t").future.result(timeout=0)
    assert eng.metrics()["sessions"]["active"] == 0
    assert eng.stats["sessions_shed"] == 2     # "s", and "t" at its submit
    # the second turn published its two prompt blocks, no session pin
    assert eng.prefix_cache.resident_pages == resident + 2
    eng.apply_brownout({})
    eng.close()


def test_session_id_through_the_server(model):
    """`LLMServer.submit(session_id=)` reaches the engine: the second
    turn resumes."""
    rng = np.random.default_rng(29)
    server = teng.LLMServer(fork_model(model), _ecfg(max_model_len=128))
    with server:
        p1 = _prompts(rng, [36])[0]
        out1 = server.submit(p1, max_new_tokens=6,
                             session_id="u").result(timeout=60)
        p2 = np.concatenate([out1.astype(np.int32), _prompts(rng, [5])[0]])
        server.submit(p2, max_new_tokens=6,
                      session_id="u").result(timeout=60)
        assert server.metrics()["sessions"]["resumed"] == 1


def test_import_geometry_error_reports_all_mismatches(model):
    """A payload with several wrong arrays fails with one error naming
    every failing pool, as the reference's does."""
    eng = teng.LLMEngine(model, _ecfg(kv_tier=dict(ram_bytes=1 << 20)))
    prompt = _prompts(np.random.default_rng(23), [20])[0]
    bad = KVPagePayload(prompt, 16, 16, "float32",
                        [np.zeros((1, 16, 4, 16), np.float32)] * 4, [])
    with pytest.raises(ValueError) as ei:
        eng.add_request(prompt, kv_import=bad)
    msg = str(ei.value)
    assert "4 failing arrays" in msg
    for i in range(4):
        assert f"pool {i} shape (1, 16, 4, 16) != (1, 16, 4, 32)" in msg
    eng.close()
