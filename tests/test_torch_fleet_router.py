"""Replicas, the fleet router and the overload plane of the PyTorch port
on CPU (gpt_tiny).

Mirrors the cases of tests/test_fleet_router.py, test_fleet_serving.py
and test_overload_control.py that belong to this slice: registry
heartbeats; a replica's submit surface against the engine; affinity
concentrating shared prefixes (tokens equal the reference engine's);
least-loaded spreading; a chaos kill's token identity; a wedged replica
failing over and being re-adopted; autoscale up and down; disaggregated
prefill/decode; a dead prefill replica falling back; the tier-aware
autoscale helpers; the router's and the engine's `metrics()` keys
against the reference's; the overload pieces (`TTFTEstimator`,
`CircuitBreaker`, `BrownoutController`) driven with explicit `now=`
through the same transitions as the reference's; engine abort, deadlines
and brownout caps; the router's parking bound, cancellation, deadline
admission, breaker and hedging. Waits are polls of at most a second.
"""
import json
import os
import time
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import llm_engine as jeng
from paddle_tpu.inference.fleet_serving import overload as jovl
from paddle_tpu.inference.fleet_serving import router as jrouter
from paddle_tpu.text.models import GPTForCausalLM as JaxGPT
from paddle_tpu.text.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.convert import export_state_dict
from paddle_tpu_torch.distributed import chaos
from paddle_tpu_torch.inference import llm_engine as teng
from paddle_tpu_torch.inference.fleet_serving import (
    AutoscalePolicy, BrownoutController, CircuitBreaker, FleetRouter,
    LocalReplica, OverloadPolicy, Priority, ReplicaRegistry,
    RequestCancelled, RequestShed, TTFTEstimator, fork_model)
from paddle_tpu_torch.inference.fleet_serving import overload as ovl
from paddle_tpu_torch.observability import flight_recorder as flight
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
def model():
    return GPTForCausalLM(gpt_tiny(), device="cpu", seed=53)


def _ecfg(**kw):
    base = dict(num_slots=4, page_size=16, token_budget=32,
                max_model_len=96)
    base.update(kw)
    return teng.LLMEngineConfig(**base)


def _drain(eng, cap=800):
    steps = 0
    while eng.has_work():
        eng.step()
        eng.pool.assert_consistent()
        steps += 1
        assert steps < cap, "engine failed to drain"


def _reference(model, prompts, max_new=12, **cfg_kw):
    """The port's single engine (the fleet's token reference)."""
    eng = teng.LLMEngine(model, _ecfg(**cfg_kw))
    reqs = [eng.add_request(p, max_new_tokens=max_new) for p in prompts]
    _drain(eng)
    return [r.future.result(timeout=0) for r in reqs]


def _prompts(rng, lens):
    return [rng.integers(0, VOCAB, (int(L),)).astype(np.int32)
            for L in lens]


def _mk_factory(model, **cfg_kw):
    def make(name, role="serve"):
        return LocalReplica(fork_model(model), name=name, role=role,
                            config=_ecfg(**cfg_kw))
    return make


def _wait(cond, limit=20.0):
    deadline = time.monotonic() + limit
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    return cond()


def _shed_count():
    return sum(c.value for _, c in ovl._SHED_TOTAL._series())


def _cancel_count():
    return sum(c.value for _, c in ovl._CANCELLED_TOTAL._series())


# ---- replicas ----

def test_fork_model_copies_weights_privately(model):
    fork = fork_model(model)
    assert type(fork) is type(model) and fork.config is not None
    for (n, a), (_, b) in zip(model.state_dict().items(),
                              fork.state_dict().items()):
        assert a.data_ptr() != b.data_ptr(), n
        assert a.device == b.device and bool((a == b).all()), n


def test_replica_registry_heartbeats(model, tmp_path, monkeypatch):
    reg = ReplicaRegistry(timeout_s=0.5)
    rep = LocalReplica(fork_model(model), name="r0", registry=reg,
                       config=_ecfg())
    try:
        assert reg.alive("r0") and rep.alive and "r0" in reg.live()
        assert reg.ages()["r0"] < 0.5
        rep.kill()          # stops beating: dead by staleness
        assert _wait(lambda: not reg.alive("r0"), 10)
        assert not rep.running
    finally:
        reg.deregister("r0")
    assert "r0" not in reg.live()
    # the heartbeat-file mirror: hb_<rid> files created, refreshed and
    # removed as the reference's registry does, over the same sequence
    from types import SimpleNamespace

    from paddle_tpu.inference.fleet_serving import replica as jrep
    from paddle_tpu_torch.distributed.fleet import elastic as tel

    views = {}
    for mod, name in ((jrep, "reference"), (None, "port")):
        d = tmp_path / name
        regs = (mod.ReplicaRegistry if mod else ReplicaRegistry)(
            hb_dir=str(d), timeout_s=5.0)
        a = SimpleNamespace(name="a", rid=3, running=True)
        b = SimpleNamespace(name="b", rid=5, running=True)
        seen = []
        regs.register(a)
        regs.register(b)
        seen.append(sorted(os.listdir(d)))
        before = os.path.getmtime(d / "hb_3")
        time.sleep(0.02)
        regs.beat("a")
        seen.append(os.path.getmtime(d / "hb_3") >= before)
        regs.deregister("b")
        seen.append(sorted(os.listdir(d)))
        regs.deregister("b")             # idempotent
        regs.deregister("a")
        seen.append(sorted(os.listdir(d)))
        views[name] = seen
    assert views["port"] == views["reference"] == [
        ["hb_3", "hb_5"], True, ["hb_3"], []]
    # an ElasticManager over a live registry's directory sees its members
    reg2 = ReplicaRegistry(hb_dir=str(tmp_path / "live"))
    reg2.register(SimpleNamespace(name="m", rid=7, running=True))
    monkeypatch.setenv("PADDLE_HEARTBEAT_DIR", str(tmp_path / "live"))
    monkeypatch.delenv("PADDLE_ELASTIC_MASTER", raising=False)
    assert [r for r, _ in tel.ElasticManager().peers()] == [7]
    reg2.deregister("m")


def test_replica_submit_surface_matches_engine(model, tmp_path):
    rng = np.random.default_rng(6)
    prompts = _prompts(rng, [10, 22, 35])
    ref = _reference(model, prompts, max_new=8)
    rep = LocalReplica(fork_model(model), config=_ecfg())
    try:
        # the warm-up ran a tick, and its counters were reset
        assert rep.engine.stats["steps"] == 0
        futs = [rep.submit(p, max_new_tokens=8) for p in prompts]
        for a, f in zip(ref, futs):
            np.testing.assert_array_equal(a, f.result(timeout=60))
        payload = rep.submit_prefill(prompts[2]).result(timeout=60)
        assert payload.n_prefilled == len(prompts[2]) - 1
        rf = rep.submit_imported(payload, max_new_tokens=8)
        np.testing.assert_array_equal(ref[2], rf.result(timeout=60))
        m = rep.metrics()
        assert m["replica"]["name"] == rep.name and m["replica"]["alive"]
        assert rep.load() == (0, 0.0)
        # a session turn serves the same tokens; the replica's telemetry
        # file carries its own view, named by replica
        np.testing.assert_array_equal(
            ref[0], rep.submit(prompts[0], max_new_tokens=8,
                               session_id="s").result(timeout=60))
        path = rep.export_telemetry(str(tmp_path))
        assert path.endswith(f".{rep.name}.json")
        with open(path) as f:
            dumped = json.load(f)
        assert dumped["replica"] == rep.name
        assert dumped["view"]["replica"]["name"] == rep.name
    finally:
        rep.stop()


def test_replica_warms_the_fused_window(model):
    rep = LocalReplica(fork_model(model), config=_ecfg(decode_k=4))
    try:
        assert rep.engine._fused_fn is not None
        assert rep.engine.stats["fused_steps"] == 0
    finally:
        rep.stop()


def test_llm_server_threads_the_submit_surface(model):
    """`LLMServer.submit` takes the reference's whole keyword surface,
    `stop()` closes the engine, and the control messages (abort,
    export_prefix) ride the submission queue."""
    assert set(teng.SUBMIT_KWARGS) == set(jeng.SUBMIT_KWARGS)
    rng = np.random.default_rng(14)
    sysp = rng.integers(0, VOCAB, (32,))
    server = teng.LLMServer(fork_model(model), _ecfg(prefix_cache=True))
    with server:
        fut = server.submit(np.concatenate([sysp, [1, 2]]),
                            max_new_tokens=4, tenant="t", priority=1,
                            ttft_slo_s=5.0, deadline_s=30.0)
        out = fut.result(timeout=60)
        assert len(out) == 38 and fut.pt_request.trace is not None
        pl = server.export_prefix(np.concatenate([sysp, [3]])).result(
            timeout=60)
        assert pl.n_prefilled == 32
        server.abort(10 ** 9)          # unknown rid: a no-op
        assert server.metrics()["prefix_cache"]["resident_pages"] == 2
        http = server.start_metrics_http()
        assert server.start_metrics_http() is http      # one per server
        with urllib.request.urlopen(http.url + ".json", timeout=10) as r:
            view = json.loads(r.read())
        assert view["extra"]["prefix_cache"]["resident_pages"] == 2
    assert server._http is None                 # stop() ended it
    assert server.engine.pool.num_live == 0     # stop() cleared the trie


# ---- the router ----

def test_router_affinity_concentrates_shared_prefixes(model):
    """Shared-prefix traffic routes to the replica holding the prefix
    (hit rate > 0.5 on a 2-group workload); tokens equal the port's
    single engine and the reference engine with the same weights."""
    rng = np.random.default_rng(7)
    groups = _prompts(rng, [32, 32])
    prompts = [np.concatenate([groups[j % 2], _prompts(rng, [4 + j])[0]])
               for j in range(10)]
    ref = _reference(model, prompts, max_new=8, prefix_cache=True)
    from paddle_tpu.distributed import mesh as mesh_mod

    mesh_mod.reset_mesh()
    jm = JaxGPT(jax_gpt_tiny())
    jm.set_state_dict({k: paddle.to_tensor(v)
                       for k, v in export_state_dict(model).items()})
    jm.eval()
    je = jeng.LLMEngine(jm, jeng.LLMEngineConfig(
        num_slots=4, page_size=16, token_budget=32, max_model_len=96))
    jr = [je.add_request(p, max_new_tokens=8) for p in prompts]
    _drain(je)
    make = _mk_factory(model, prefix_cache=True)
    router = FleetRouter(replicas=[make("a"), make("b")],
                         hash_block_tokens=16,
                         policy=AutoscalePolicy(min_replicas=2,
                                                max_replicas=2))
    with router:
        futs = [router.submit(p, max_new_tokens=8) for p in prompts]
        outs = [f.result(timeout=120) for f in futs]
        m = router.metrics()
    for a, b, j in zip(ref, outs, jr):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(j.future.result(timeout=0), b)
    assert m["affinity_hit_rate"] > 0.5
    assert m["requests"] == 10
    assert m["ttft_p50_s"] is not None and m["ttft_p99_s"] is not None


def test_router_least_loaded_fallback_spreads(model):
    rng = np.random.default_rng(8)
    prompts = _prompts(rng, [8] * 8)   # < hash_block_tokens: no keys
    make = _mk_factory(model)
    router = FleetRouter(replicas=[make("a"), make("b")],
                         policy=AutoscalePolicy(min_replicas=2,
                                                max_replicas=2))
    with router:
        futs = [router.submit(p, max_new_tokens=16) for p in prompts]
        [f.result(timeout=120) for f in futs]
        m = router.metrics()
    assert m["affinity_hit_rate"] == 0.0
    assert all(v["mean_slot_occupancy"] > 0
               for v in m["replicas"].values()), m["replicas"]


def test_router_failover_chaos_kill_token_identity(model):
    """A seeded chaos plan kills replica "a" mid-stream (busy tick 6);
    its in-flight requests requeue onto the survivor and the outputs
    equal the unkilled single engine's. Every future resolves."""
    rng = np.random.default_rng(9)
    prompts = _prompts(rng, rng.integers(6, 40, 10))
    ref = _reference(model, prompts, max_new=12)
    chaos.install({"seed": 5, "injectors": [
        {"scope": "replica.kill.a", "kind": "error", "at": [6]}]})
    make = _mk_factory(model)
    router = FleetRouter(
        replicas=[make("a"), make("b")],
        policy=AutoscalePolicy(min_replicas=1, max_replicas=2,
                               heartbeat_timeout_s=0.5, poll_s=0.01))
    with router:
        futs = [router.submit(p, max_new_tokens=12) for p in prompts]
        outs = [f.result(timeout=120) for f in futs]
        m = router.metrics()
    for a, b in zip(ref, outs):
        np.testing.assert_array_equal(a, b)
    assert m["replicas_lost"] == 1
    assert m["requeues"] >= 1
    assert chaos.get_plan().injected.get("replica.kill.a") == 1
    dumps = [e for e in flight.recorder().events("failover_requeue")]
    assert dumps, "the requeues were not flight-recorded"


def test_router_wedged_replica_fails_over(model):
    """A wedged loop (a delay injector: the thread lives, heartbeats
    stop) counts dead by staleness; its work requeues, and once the
    wedge clears the member is re-adopted."""
    rng = np.random.default_rng(13)
    prompts = _prompts(rng, rng.integers(6, 40, 10))
    ref = _reference(model, prompts, max_new=12)
    chaos.install({"seed": 2, "injectors": [
        {"scope": "replica.kill.a", "kind": "delay", "at": [4],
         "delay_s": 1.0}]})
    make = _mk_factory(model)
    router = FleetRouter(
        replicas=[make("a"), make("b")],
        policy=AutoscalePolicy(min_replicas=1, max_replicas=2,
                               heartbeat_timeout_s=0.3, poll_s=0.01))
    with router:
        futs = [router.submit(p, max_new_tokens=12) for p in prompts]
        outs = [f.result(timeout=120) for f in futs]
        assert _wait(lambda: router.num_replicas() == 2, 20)
        m = router.metrics()
    for a, b in zip(ref, outs):
        np.testing.assert_array_equal(a, b)
    assert m["replicas_lost"] == 1 and m["requeues"] >= 1
    assert m.get("replicas_recovered", 0) == 1
    assert set(m["replicas"]) == {"a", "b"}


def test_router_autoscale_up_and_down(model):
    rng = np.random.default_rng(10)
    prompts = _prompts(rng, rng.integers(6, 30, 36))
    ref = _reference(model, prompts, max_new=24)
    make = _mk_factory(model)
    router = FleetRouter(
        factory=make,
        policy=AutoscalePolicy(min_replicas=1, max_replicas=3,
                               queue_high=2, queue_low=0,
                               cooldown_s=0.05, poll_s=0.01))
    with router:
        assert router.num_replicas() == 1
        futs = [router.submit(p, max_new_tokens=24) for p in prompts]
        peak = 1
        while not all(f.done() for f in futs):
            peak = max(peak, router.num_replicas())
            time.sleep(0.01)
        outs = [f.result(timeout=0) for f in futs]
        assert _wait(lambda: router.num_replicas() == 1, 20)
        m = router.metrics()
    for a, b in zip(ref, outs):
        np.testing.assert_array_equal(a, b)
    assert peak >= 2, "burst never scaled up"
    assert m["scale_ups"] >= 1 and m["scale_downs"] >= 1


def test_router_disaggregated_prefill_decode(model):
    rng = np.random.default_rng(11)
    long_p = _prompts(rng, [64, 80, 72])
    short_p = _prompts(rng, [8, 10])
    prompts = [long_p[0], short_p[0], long_p[1], short_p[1], long_p[2]]
    ref = _reference(model, prompts, max_new=8)
    make = _mk_factory(model)
    router = FleetRouter(
        replicas=[make("d1")],
        prefill_replicas=[make("p1", role="prefill")],
        prefill_min_tokens=48,
        policy=AutoscalePolicy(min_replicas=1, max_replicas=1))
    with router:
        futs = [router.submit(p, max_new_tokens=8) for p in prompts]
        outs = [f.result(timeout=120) for f in futs]
        m = router.metrics()
    for a, b in zip(ref, outs):
        np.testing.assert_array_equal(a, b)
    assert m["disagg_handoffs"] == 3
    assert m["replicas"]["p1"]["role"] == "prefill"
    eng = m["replicas"]["d1"]["engine"]
    assert eng["kv_pages_shared"] == 0 and "recent_requests" not in eng


def test_router_dead_prefill_replica_falls_back(model):
    rng = np.random.default_rng(12)
    prompts = _prompts(rng, [64, 70])
    ref = _reference(model, prompts, max_new=8)
    make = _mk_factory(model)
    pre = make("p1", role="prefill")
    router = FleetRouter(
        replicas=[make("d1")], prefill_replicas=[pre],
        prefill_min_tokens=48,
        policy=AutoscalePolicy(min_replicas=1, max_replicas=1,
                               heartbeat_timeout_s=0.5, poll_s=0.01))
    with router:
        pre.kill()
        assert _wait(lambda: not pre.alive, 10)
        futs = [router.submit(p, max_new_tokens=8) for p in prompts]
        outs = [f.result(timeout=120) for f in futs]
    for a, b in zip(ref, outs):
        np.testing.assert_array_equal(a, b)


def test_router_hot_prefix_migration(model):
    """With migration on, a hot prefix's pages are pulled from the busy
    holder to an idle peer over the KV wire (pack -> unpack), and the
    tokens stay the single engine's."""
    rng = np.random.default_rng(15)
    sysp = _prompts(rng, [32])[0]
    prompts = [np.concatenate([sysp, _prompts(rng, [3 + j])[0]])
               for j in range(8)]
    ref = _reference(model, prompts, max_new=6, prefix_cache=True)
    make = _mk_factory(model, prefix_cache=True)
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
        busy = holder.submit(_prompts(rng, [20])[0], max_new_tokens=80)
        assert _wait(lambda: holder.load() > peer.load(), 10)
        futs = [router.submit(p, max_new_tokens=6) for p in prompts[1:]]
        outs = [first.result()] + [f.result(timeout=120) for f in futs]
        busy.result(timeout=120)
        m = router.metrics()
    for x, y in zip(ref, outs):
        np.testing.assert_array_equal(x, y)
    assert m["migrations"] == 1 and m["migration_failures"] == 0
    assert peer.engine.stats.get("kv_pages_imported", 0) >= 2
    assert holder.engine.stats.get("kv_pages_migrated_out", 0) == 2


def test_router_submit_screens_unknown_kwargs(model):
    router = FleetRouter(replicas=[_mk_factory(model)("a")],
                         policy=AutoscalePolicy(min_replicas=1,
                                                max_replicas=1))
    with pytest.raises(RuntimeError, match="not started"):
        router.submit(np.arange(4))
    with router:
        with pytest.raises(TypeError, match="unknown kwarg"):
            router.submit(np.arange(4), max_new_tokenz=3)
        http = router.start_metrics_http()
        assert router.start_metrics_http() is http      # one per router
        with urllib.request.urlopen(http.url, timeout=10) as r:
            assert b"pt_router_requests" in r.read()
        with urllib.request.urlopen(http.url + ".json", timeout=10) as r:
            assert "replicas" in json.loads(r.read())["extra"]
    assert router._http is None                          # stop() ended it


class _FakeEngine:
    mean_occupancy = 0.0

    def __init__(self, kv_tier=None):
        self._kv_tier = kv_tier

    def metrics(self):
        out = {"recent_requests": []}
        if self._kv_tier is not None:
            out["kv_tier"] = dict(self._kv_tier)
        return out


class _FakeReplica:
    role = "serve"
    alive = True
    running = True
    _registry = None

    def __init__(self, name, kv_tier=None):
        self.name = name
        self.rid = f"rid-{name}"
        self.engine = _FakeEngine(kv_tier)

    def queue_depth(self):
        return 0

    def load(self):
        return (0, 0.0)

    def stop(self):
        self.alive = False


TIER_A = {"spills": 6, "spill_pages": 12, "spill_failed": 1,
          "spill_rejected": 1, "ram_hits": 6, "disk_hits": 2,
          "misses": 2, "ram_dropped": 1, "disk_dropped": 0,
          "ram_bytes": 4096, "disk_bytes": 1024}
TIER_B = {"spills": 2, "spill_pages": 4, "spill_failed": 0,
          "spill_rejected": 0, "ram_hits": 2, "disk_hits": 0,
          "misses": 8, "ram_dropped": 0, "disk_dropped": 0,
          "ram_bytes": 2048, "disk_bytes": 0}


def test_router_metrics_keys_match_reference():
    """The fleet snapshot carries the reference router's keys, and the
    tier fold gives the reference's numbers on the same snapshots."""
    mine = FleetRouter(replicas=[_FakeReplica("a", TIER_A),
                                 _FakeReplica("b", TIER_B)]).metrics()
    ref = jrouter.FleetRouter(replicas=[_FakeReplica("a", TIER_A),
                                        _FakeReplica("b", TIER_B)]
                              ).metrics()
    assert set(mine) == set(ref)
    assert set(mine["overload"]) == set(ref["overload"])
    assert mine["kv_tier"] == ref["kv_tier"]
    assert mine["kv_tier"]["hit_rate"] == pytest.approx(10 / 20)
    assert mine["kv_tier"]["spill_pressure"] == pytest.approx(2 / 12)
    assert FleetRouter(replicas=[_FakeReplica("c")]).metrics()[
        "kv_tier"] is None


def test_tier_block_folds_tier_snapshots():
    a = {"spills": 2, "spill_rejected": 1, "ram_hits": 3, "misses": 1,
         "ram_dropped": 0, "disk_dropped": 0}
    b = {"spills": 1, "spill_rejected": 0, "ram_hits": 1, "misses": 3,
         "ram_dropped": 1, "disk_dropped": 0}
    block = FleetRouter._tier_block([a, None, {}, b])
    assert block == jrouter.FleetRouter._tier_block([a, None, {}, b])
    assert block["replicas_with_tier"] == 2
    assert abs(block["hit_rate"] - 0.5) < 1e-9
    assert abs(block["spill_pressure"] - 2 / 6) < 1e-9
    assert FleetRouter._tier_block([]) is None
    assert FleetRouter._tier_block([None, {}]) is None


def test_spill_pressure_scale_up_with_hysteresis():
    tier_hot = {"spills": 2, "spill_failed": 0, "spill_rejected": 4,
                "ram_hits": 1, "disk_hits": 1, "misses": 0,
                "ram_dropped": 4, "disk_dropped": 0}
    tier_cold = {k: 0 for k in tier_hot}
    built = []

    def factory(name):
        rep = _FakeReplica(name, dict(tier_cold))
        built.append(rep)
        return rep

    router = FleetRouter(
        replicas=[_FakeReplica("hot0", tier_hot)], factory=factory,
        policy=AutoscalePolicy(min_replicas=1, max_replicas=2,
                               queue_high=1000, cooldown_s=0.0,
                               spill_high=0.5))
    router._autoscale_tick()
    assert not built and router.stats["spill_scale_ups"] == 0
    router._autoscale_tick()
    assert len(built) == 1 and router.stats["spill_scale_ups"] == 1
    router._autoscale_tick()
    router._autoscale_tick()
    assert len(built) == 1 and router.stats["scale_downs"] == 0


def test_fleet_spill_pressure_none_without_tiers():
    router = FleetRouter(replicas=[_FakeReplica("bare0")],
                         policy=AutoscalePolicy(min_replicas=1,
                                                max_replicas=2,
                                                cooldown_s=0.0))
    assert router._fleet_spill_pressure(router._alive_replicas()) is None
    router._autoscale_tick()
    router._autoscale_tick()
    assert router.stats["scale_ups"] == 0


# ---- overload pieces: the reference's transitions ----

def test_typed_rejections_carry_context():
    e = RequestShed("deadline_unmeetable", retry_after_s=0.25,
                    trace_id="t-1")
    assert (e.reason, e.retry_after_s, e.trace_id) == (
        "deadline_unmeetable", 0.25, "t-1")
    assert str(e) == str(jovl.RequestShed(
        "deadline_unmeetable", retry_after_s=0.25, trace_id="t-1"))
    c = RequestCancelled(reason="deadline", trace_id="t-2")
    assert c.reason == "deadline" and isinstance(c, RuntimeError)


def _breaker_script(rng, n=200):
    """A seeded event script over a breaker: (op, now, latency)."""
    t, out = 0.0, []
    for _ in range(n):
        t += float(rng.uniform(0.0, 0.6))
        op = str(rng.choice(["allow", "ok", "fail", "slow"]))
        out.append((op, t, float(rng.uniform(0.0, 0.3))))
    return out


@pytest.mark.parametrize("latency_s", [None, 0.1])
def test_circuit_breaker_transitions_match_reference(latency_s):
    kw = dict(window=6, failure_rate=0.5, min_events=3, reset_s=1.0,
              latency_s=latency_s)
    mine, ref = CircuitBreaker(**kw), jovl.CircuitBreaker(**kw)
    for op, now, lat in _breaker_script(np.random.default_rng(3)):
        outs = []
        for br in (mine, ref):
            if op == "allow":
                outs.append(br.allow(now=now))
            elif op == "fail":
                outs.append(br.record_failure(now=now))
            else:
                outs.append(br.record_success(
                    latency_s=lat if op == "slow" else 0.0, now=now))
        assert outs[0] == outs[1], (op, now)
        assert mine.snapshot() == ref.snapshot(), (op, now)


def test_circuit_breaker_state_machine():
    br = CircuitBreaker(window=8, failure_rate=0.5, min_events=4,
                        reset_s=1.0)
    assert br.state == "closed" and br.allow(now=0.0)
    for _ in range(3):
        br.record_failure(now=0.0)
    assert br.state == "closed"
    br.record_failure(now=0.0)
    assert br.state == "open" and br.opens == 1
    assert not br.allow(now=0.5)
    assert br.allow(now=1.5) and br.state == "half_open"
    assert not br.allow(now=1.6)
    br.record_failure(now=1.7)
    assert br.state == "open" and br.opens == 2
    assert br.allow(now=3.0)
    br.record_success(latency_s=0.0, now=3.1)
    assert br.state == "closed" and br.snapshot()["window"] == []


def test_circuit_breaker_abandoned_probe_ages_out():
    br = CircuitBreaker(window=4, failure_rate=0.5, min_events=2,
                        reset_s=1.0)
    br.record_failure(now=0.0)
    br.record_failure(now=0.0)
    assert br.state == "open"
    assert br.allow(now=1.5)
    assert not br.allow(now=1.6)
    assert br.allow(now=1.5 + max(br.reset_s, 1.0) + 0.1)


@pytest.mark.parametrize("seed", [0, 1])
def test_brownout_transitions_match_reference(seed):
    kw = dict(brownout_high=4.0, brownout_low=1.0, brownout_step_ticks=2,
              brownout_recover_ticks=3)
    applied = ([], [])
    mine = BrownoutController(OverloadPolicy(**kw),
                              apply_fn=lambda lv, c: applied[0].append(
                                  (lv, c)))
    ref = jovl.BrownoutController(jovl.OverloadPolicy(**kw),
                                  apply_fn=lambda lv, c: applied[1].append(
                                      (lv, c)))
    rng = np.random.default_rng(seed)
    t = 0.0
    for _ in range(300):
        t += 0.1
        p = float(rng.choice([0.0, 0.5, 2.0, 5.0, 9.0]))
        assert mine.note_pressure(p, now=t) == ref.note_pressure(p, now=t)
        assert mine.snapshot() == ref.snapshot()
    assert applied[0] == applied[1] and applied[0]
    assert mine.dwell(now=t) == ref.dwell(now=t)
    assert mine.levels == ref.levels


def test_brownout_hysteresis_journal_and_dwell():
    applied = []
    pol = OverloadPolicy(brownout_high=4.0, brownout_low=1.0,
                         brownout_step_ticks=2, brownout_recover_ticks=3)
    ctl = BrownoutController(pol, apply_fn=lambda lv, caps:
                             applied.append((lv, caps)))
    assert ctl.enabled and ctl.level == 0 and ctl.shed_priority() is None
    assert ctl.note_pressure(9.0, now=0.0) == 0
    assert ctl.note_pressure(2.0, now=0.1) == 0
    assert ctl.note_pressure(9.0, now=0.2) == 0
    assert ctl.note_pressure(9.0, now=0.3) == 1
    assert applied[-1][0] == 1
    t = 0.4
    while ctl.level < len(ctl.levels) - 1:
        ctl.note_pressure(9.0, now=t)
        t += 0.1
    assert ctl.level == 5
    assert ctl.shed_priority() == int(Priority.BATCH)
    assert ctl.caps()["spec_enabled"] is False
    t += 1.0
    for dt in (0.0, 0.1):
        ctl.note_pressure(0.0, now=t + dt)
    assert ctl.level == 5
    ctl.note_pressure(0.0, now=t + 0.2)
    assert ctl.level == 4
    hops = [(j["from"], j["to"]) for j in ctl.journal]
    assert hops == [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 4)]
    assert abs(sum(ctl.dwell(now=t + 0.2)) - (t + 0.2)) < 1e-6


def test_brownout_disabled_is_inert():
    ctl = BrownoutController(OverloadPolicy())
    assert not ctl.enabled
    for i in range(50):
        assert ctl.note_pressure(1e9, now=float(i)) == 0
    assert ctl.journal == []


def test_ttft_estimator_matches_reference():
    mine, ref = TTFTEstimator(), jovl.TTFTEstimator()
    rng = np.random.default_rng(4)
    cum, t = 0.0, 100.0
    for _ in range(100):
        t += float(rng.uniform(0.01, 1.0))
        cum += float(rng.integers(-50, 500))
        n_prompt = int(rng.integers(4, 200))
        for est in (mine, ref):
            est.note_progress(cum, t=t)
            est.note_prompt(n_prompt)
        assert mine.snapshot() == ref.snapshot()
        q = float(rng.integers(0, 10_000))
        assert mine.lower_bound_ttft(q) == ref.lower_bound_ttft(q)
    est = TTFTEstimator()
    assert est.lower_bound_ttft(10_000) == 0.0
    est.note_progress(0.0, t=100.0)
    est.note_progress(500.0, t=101.0)
    est.note_progress(600.0, t=102.0)
    est.note_progress(50.0, t=103.0)
    assert est.peak_rate() == pytest.approx(500.0)
    assert est.lower_bound_ttft(1000) == pytest.approx(2.0)


# ---- the engine's overload surface ----

def test_engine_abort_frees_pool_coresidents_unperturbed(model):
    rng = np.random.default_rng(7)
    pa, pb = _prompts(rng, [20, 17])
    ref_b = _reference(model, [pb], max_new=12)[0]
    eng = teng.LLMEngine(model, _ecfg())
    ra = eng.add_request(pa, max_new_tokens=40)
    rb = eng.add_request(pb, max_new_tokens=12)
    for _ in range(3):
        eng.step()
    assert ra.slot is not None and rb.slot is not None
    pages_b = len(rb.pages)
    t0 = len(flight.recorder().events("request_cancelled"))
    c0 = _cancel_count()
    assert eng.abort(ra.rid) is True
    assert eng.pool.num_live == pages_b
    with pytest.raises(RequestCancelled) as ei:
        ra.future.result(timeout=0)
    assert ei.value.reason == "client" and "cancelled" in ra.trace.phases
    assert _cancel_count() == c0 + 1
    evs = flight.recorder().events("request_cancelled")
    assert len(evs) == t0 + 1
    assert evs[-1]["trace_id"] == ra.trace.trace_id
    _drain(eng)
    np.testing.assert_array_equal(rb.future.result(timeout=0), ref_b)
    assert eng.abort(ra.rid) is False and eng.abort(10 ** 9) is False


def test_engine_abort_queued_request(model):
    rng = np.random.default_rng(8)
    pa, pb = _prompts(rng, [12, 12])
    eng = teng.LLMEngine(model, _ecfg(num_slots=1))
    ra = eng.add_request(pa, max_new_tokens=8)
    rb = eng.add_request(pb, max_new_tokens=8)
    eng.step()
    assert ra.slot is not None and rb.slot is None
    assert eng.abort(rb.rid) is True
    with pytest.raises(RequestCancelled):
        rb.future.result(timeout=0)
    _drain(eng)
    assert ra.future.result(timeout=0) is not None
    assert eng.pool.num_live == 0


def test_engine_deadlines(model):
    """Expired at submit -> RequestShed; expiring mid-decode ->
    RequestCancelled with the slot freed; a met deadline changes no
    byte."""
    rng = np.random.default_rng(9)
    p, q = _prompts(rng, [10, 14])
    eng = teng.LLMEngine(model, _ecfg())
    s0 = _shed_count()
    for ds in (0.0, -1.0):
        req = eng.add_request(p, max_new_tokens=8, deadline_s=ds)
        with pytest.raises(RequestShed) as ei:
            req.future.result(timeout=0)
        assert ei.value.reason == "deadline"
    assert _shed_count() == s0 + 2 and not eng.has_work()
    req = eng.add_request(p, max_new_tokens=64, deadline_s=0.15)
    steps = 0
    while not req.future.done():
        eng.step()
        time.sleep(0.01)
        steps += 1
        assert steps < 400, "deadline never fired"
    with pytest.raises(RequestCancelled) as ei:
        req.future.result(timeout=0)
    assert ei.value.reason == "deadline"
    assert len(req.tokens) < len(p) + 64
    assert not eng.has_work() and eng.pool.num_live == 0
    ref = _reference(model, [q], max_new=10)[0]
    ok = eng.add_request(q, max_new_tokens=10, deadline_s=60.0)
    _drain(eng)
    assert ok.future.result(timeout=0).tobytes() == ref.tobytes()


def test_engine_brownout_caps_max_new_window_and_shed(model):
    rng = np.random.default_rng(12)
    p, pb = _prompts(rng, [10, 10])
    ref = _reference(model, [p], max_new=12)[0]
    eng = teng.LLMEngine(model, _ecfg())
    eng.apply_brownout({"max_new_cap": 2})
    req = eng.add_request(p, max_new_tokens=12)
    _drain(eng)
    out = req.future.result(timeout=0)
    assert len(out) == len(p) + 2
    assert out.tobytes() == ref[:len(out)].tobytes()
    eng.apply_brownout({})
    req2 = eng.add_request(p, max_new_tokens=12)
    _drain(eng)
    assert req2.future.result(timeout=0).tobytes() == ref.tobytes()
    eng2 = teng.LLMEngine(model, _ecfg(decode_k=4))
    eng2.apply_brownout({"decode_k_cap": 1})
    req3 = eng2.add_request(p, max_new_tokens=12)
    _drain(eng2)
    assert req3.future.result(timeout=0).tobytes() == ref.tobytes()
    eng.apply_brownout({"shed_priority": int(Priority.BATCH)})
    shed = eng.add_request(p, max_new_tokens=4, priority=Priority.BATCH)
    kept = eng.add_request(pb, max_new_tokens=4)
    with pytest.raises(RequestShed) as ei:
        shed.future.result(timeout=0)
    assert ei.value.reason == "brownout"
    _drain(eng)
    assert kept.future.result(timeout=0) is not None


@pytest.mark.parametrize("spec", ["draft", "ngram"])
def test_engine_brownout_spec_park_and_restore(model, spec):
    """L2 parks the speculator (the draft pools released: pool_bytes
    drops), recovery restores it with fresh pools, L1's spec_k_cap
    narrows the windows — tokens equal the plain engine's throughout."""
    rng = np.random.default_rng(14)
    prompts = _prompts(rng, [12, 18])
    ref = _reference(model, prompts, max_new=8)
    if spec == "draft":
        draft = GPTForCausalLM(gpt_tiny(), device="cpu",
                               seed=31)
        eng = teng.LLMEngine(model, _ecfg(draft_model=draft, spec_k=4))
    else:
        eng = teng.LLMEngine(model, _ecfg(spec_mode="ngram", spec_k=4))
    bytes_full = eng.pool_bytes()

    def run():
        reqs = [eng.add_request(p, max_new_tokens=8) for p in prompts]
        _drain(eng)
        for r, want in zip(reqs, ref):
            assert r.future.result(timeout=0).tobytes() == want.tobytes()

    eng.apply_brownout({"spec_enabled": False})
    run()
    assert eng._spec is None and eng._spec_stash is not None
    if spec == "draft":
        assert eng.pool_bytes() < bytes_full
    eng.apply_brownout({})
    run()
    assert eng._spec is not None and eng._spec_stash is None
    assert eng.pool_bytes() == bytes_full
    windows = eng.stats[f"{spec if spec == 'ngram' else 'spec'}_windows"]
    eng.apply_brownout({"spec_k_cap": 1})
    run()
    assert eng.stats[
        f"{spec if spec == 'ngram' else 'spec'}_windows"] > windows


def test_engine_metrics_keys_match_reference(model):
    """`metrics()` of the port engine and of the reference engine have
    the same keys, with spec / ngram / structured blocks present in the
    same cases."""
    from paddle_tpu.distributed import mesh as mesh_mod

    mesh_mod.reset_mesh()
    jm = JaxGPT(jax_gpt_tiny())
    jm.set_state_dict({k: paddle.to_tensor(v)
                       for k, v in export_state_dict(model).items()})
    jm.eval()
    for cfg in ({}, {"spec_mode": "ngram"}):
        je = jeng.LLMEngine(jm, jeng.LLMEngineConfig(
            num_slots=2, max_model_len=64, **cfg))
        te = teng.LLMEngine(model, _ecfg(num_slots=2, max_model_len=64,
                                         **cfg))
        for e in (je, te):
            e.add_request(np.arange(5), max_new_tokens=3)
            _drain(e)
        jmx, tmx = je.metrics(), te.metrics()
        assert set(tmx) == set(jmx)
        for key in ("spec", "ngram", "structured", "prefix_cache",
                    "kv_tier"):
            assert (tmx[key] is None) == (jmx[key] is None), key
        if tmx["ngram"] is not None:
            assert set(tmx["ngram"]) == set(jmx["ngram"])
        assert tmx["recent_requests"] and set(
            tmx["recent_requests"][0]) == set(jmx["recent_requests"][0])


# ---- the router's overload plane ----

def test_router_parking_queue_is_bounded(model):
    rng = np.random.default_rng(20)
    prompts = _prompts(rng, [8] * 5)
    a = _mk_factory(model)("a")
    router = FleetRouter(
        replicas=[a],
        policy=AutoscalePolicy(min_replicas=1, max_replicas=1,
                               heartbeat_timeout_s=0.3, poll_s=0.01),
        overload=OverloadPolicy(max_parked=3))
    with router:
        a.kill()
        assert _wait(lambda: router.num_replicas() == 0, 20)
        futs = [router.submit(p, max_new_tokens=4) for p in prompts]
        with router._lock:
            parked = sum(rr.stage == "parked"
                         for rr in router._inflight.values())
        assert parked == 3 and router.stats["shed"] == 2
        for f in futs[3:]:
            with pytest.raises(RequestShed) as ei:
                f.result(timeout=5)
            assert ei.value.reason == "no_capacity"
        assert not any(f.done() for f in futs[:3])
    for f in futs[:3]:
        with pytest.raises(RuntimeError):
            f.result(timeout=5)


def test_router_cancel_propagates_to_engine_and_frees(model):
    rng = np.random.default_rng(21)
    p_long, p_b = _prompts(rng, [8, 12])
    ref_b = _reference(model, [p_b], max_new=8)[0]
    a = _mk_factory(model)("a")
    router = FleetRouter(
        replicas=[a],
        policy=AutoscalePolicy(min_replicas=1, max_replicas=1,
                               heartbeat_timeout_s=5.0, poll_s=0.01))
    with router:
        fut = router.submit(p_long, max_new_tokens=80)
        rid = fut.pt_rid

        def ingested():
            with router._lock:
                rr = router._inflight.get(rid)
            return rr is None or (rr.internal is not None and getattr(
                rr.internal, "pt_request", None) is not None)

        assert _wait(ingested, 20)
        c0 = _cancel_count()
        assert router.cancel(rid, reason="client") is True
        with pytest.raises(RequestCancelled) as ei:
            fut.result(timeout=10)
        assert ei.value.reason == "client"
        assert _cancel_count() == c0 + 1
        assert router.stats["cancelled"] == 1
        assert _wait(lambda: a.engine.pool.num_live == 0, 20)
        out = router.submit(p_b, max_new_tokens=8).result(timeout=60)
        np.testing.assert_array_equal(out, ref_b)
        assert router.cancel(rid) is False


def test_router_deadline_admission_and_identity(model):
    rng = np.random.default_rng(22)
    p_small, p_big = _prompts(rng, [12, 64])
    ref = _reference(model, [p_small], max_new=8)[0]
    router = FleetRouter(
        replicas=[_mk_factory(model)("a")],
        policy=AutoscalePolicy(min_replicas=1, max_replicas=1,
                               heartbeat_timeout_s=5.0, poll_s=0.01))
    with router:
        with pytest.raises(RequestShed) as ei:
            router.submit(p_small, max_new_tokens=8,
                          deadline_s=0.0).result(timeout=5)
        assert ei.value.reason == "deadline"
        assert ei.value.retry_after_s is None
        router._estimator.note_progress(0.0, t=100.0)
        router._estimator.note_progress(500.0, t=101.0)
        with pytest.raises(RequestShed) as ei:
            router.submit(p_big, max_new_tokens=8,
                          deadline_s=0.001).result(timeout=5)
        assert ei.value.reason == "deadline_unmeetable"
        assert ei.value.retry_after_s > 0
        out = router.submit(p_small, max_new_tokens=8,
                            deadline_s=60.0).result(timeout=60)
        assert out.tobytes() == ref.tobytes()
        assert router.stats["shed"] == 2


def test_router_breaker_opens_on_sick_prefill_tier(model):
    rng = np.random.default_rng(23)
    prompts = _prompts(rng, [48] * 6)
    ref = _reference(model, prompts, max_new=12)
    sick_pre = LocalReplica(fork_model(model), name="pre", role="prefill",
                            config=_ecfg(max_model_len=32))
    router = FleetRouter(
        replicas=[_mk_factory(model)("a")], prefill_replicas=[sick_pre],
        prefill_min_tokens=40,
        policy=AutoscalePolicy(min_replicas=1, max_replicas=1,
                               heartbeat_timeout_s=10.0, poll_s=0.01))
    with router:
        outs = [router.submit(p, max_new_tokens=12).result(timeout=120)
                for p in prompts]
        m = router.metrics()
    for want, got in zip(ref, outs):
        np.testing.assert_array_equal(want, got)
    br = m["overload"]["breaker"]
    assert br["opens"] >= 1 and br["state"] != "closed"
    assert m["disagg_handoffs"] == 0 and m["replicas_lost"] == 0
    assert ovl._BREAKER_STATE.value in (0.5, 1.0)


def test_router_hedge_rescues_wedged_replica(model):
    rng = np.random.default_rng(24)
    prompts = _prompts(rng, rng.integers(6, 24, 8))
    ref = _reference(model, prompts, max_new=16)
    chaos.install({"seed": 4, "injectors": [
        {"scope": "replica.kill.a", "kind": "delay", "at": [3],
         "delay_s": 1.0}]})
    make = _mk_factory(model)
    router = FleetRouter(
        replicas=[make("a"), make("b")],
        policy=AutoscalePolicy(min_replicas=2, max_replicas=2,
                               heartbeat_timeout_s=30.0, poll_s=0.01),
        overload=OverloadPolicy(hedge_after_s=0.1, hedge_stale_s=0.1))
    with router:
        futs = [router.submit(p, max_new_tokens=16) for p in prompts]
        outs = [f.result(timeout=60) for f in futs]
        m = router.metrics()
    for want, got in zip(ref, outs):
        np.testing.assert_array_equal(want, got)
    assert m["hedges"] >= 1 and m["replicas_lost"] == 0
    assert chaos.get_plan().injected.get("replica.kill.a", 0) >= 1
