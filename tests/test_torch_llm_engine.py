"""Continuous-batching engine: the PyTorch port against the JAX
package's `LLMEngine` on CPU (gpt_tiny, the same weights in both).

Greedy outputs must be token-identical, with chunked prefill and with
preemption, on float, int8 and packed-int4 KV pools, and the schedule
itself (ticks, preemptions) must match. Also: `PagePool` invariants, the
`LLMServer` surface, the sampling knobs' checks, the knobs that are not
ported yet, and the rule
that the port imports neither jax nor the JAX package. Speculative
(n-gram) engines: tests/test_torch_speculative.py.
"""
import ast
import pathlib
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import llm_engine as jeng
from paddle_tpu.text.models import GPTForCausalLM as JaxGPT
from paddle_tpu.text.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.convert import load_jax_state_dict
from paddle_tpu_torch.inference import llm_engine as teng
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


ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _serial_mesh():
    from paddle_tpu.distributed import mesh as mesh_mod

    mesh_mod.reset_mesh()
    yield


def _pair(seed):
    paddle.seed(seed)
    jm = JaxGPT(jax_gpt_tiny())
    jm.eval()
    tm = GPTForCausalLM(gpt_tiny(), device="cpu")
    load_jax_state_dict(tm, {k: np.array(v.numpy())
                             for k, v in jm.state_dict().items()})
    return jm, tm


def _drain(eng, limit):
    steps = 0
    while eng.has_work():
        eng.step()
        eng.pool.assert_consistent()
        steps += 1
        assert steps < limit
    return steps


def _run_both(seed, prompts, max_new, **cfg):
    jm, tm = _pair(seed)
    je = jeng.LLMEngine(jm, jeng.LLMEngineConfig(**cfg))
    te = teng.LLMEngine(tm, teng.LLMEngineConfig(**cfg))
    jr = [je.add_request(p, max_new_tokens=max_new) for p in prompts]
    tr = [te.add_request(p, max_new_tokens=max_new) for p in prompts]
    _drain(je, 500)
    _drain(te, 500)
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(b.future.result(timeout=0),
                                      a.future.result(timeout=0))
    assert te.pool.num_live == 0
    for key in ("steps", "tokens_in", "generated", "finished",
                "preemptions"):
        assert te.stats[key] == je.stats[key], key
    return te


def test_greedy_token_identical_with_chunked_prefill():
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 2048, (L,)) for L in (5, 13, 8, 21, 3)]
    te = _run_both(30, prompts, 7, num_slots=3, page_size=16,
                   token_budget=8, max_model_len=64)
    # prompts longer than the budget were prefilled over several ticks
    assert te.stats["tokens_in"] > te.stats["steps"]


def test_greedy_token_identical_with_preemption():
    rng = np.random.default_rng(7)
    # 4 sequences of 3 pages each through a 5-page pool
    prompts = [rng.integers(0, 2048, (20,)) for _ in range(4)]
    te = _run_both(31, prompts, 20, num_slots=3, page_size=16,
                   num_pages=6, max_model_len=48, token_budget=8)
    assert te.stats["preemptions"] > 0, "pool was not tight enough"


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_quantized_greedy_token_identical_with_chunked_prefill(kv_dtype):
    """int8 / packed-int4 pools: each new row quantized once in the pool
    (codes and scales byte-identical to the reference's codec), attention
    dequantizing on gather; greedy tokens and the schedule equal the
    reference engine's with the same kv_dtype."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 2048, (L,)) for L in (5, 13, 8, 21, 3)]
    te = _run_both(32, prompts, 9, num_slots=3, page_size=16,
                   token_budget=8, max_model_len=64, kv_dtype=kv_dtype)
    assert te.kv_dtype == kv_dtype
    assert te.stats["tokens_in"] > te.stats["steps"]
    assert all(float(s.abs().sum()) > 0 for s in te._kv_scales)


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_quantized_greedy_token_identical_with_preemption(kv_dtype):
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, 2048, (20,)) for _ in range(4)]
    te = _run_both(33, prompts, 20, num_slots=3, page_size=16,
                   num_pages=6, max_model_len=48, token_budget=8,
                   kv_dtype=kv_dtype)
    assert te.stats["preemptions"] > 0, "pool was not tight enough"


def test_eos_contract_matches_jax():
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, 2048, (6,))
    jm, tm = _pair(24)
    te = teng.LLMEngine(tm, teng.LLMEngineConfig(
        num_slots=2, page_size=16, max_model_len=64))
    base = te.add_request(prompt, max_new_tokens=8)
    _drain(te, 100)
    eos = int(base.future.result()[6 + 1])   # the 2nd generated token
    je = jeng.LLMEngine(jm, jeng.LLMEngineConfig(
        num_slots=2, page_size=16, max_model_len=64))
    jr = je.add_request(prompt, max_new_tokens=8, eos_token_id=eos)
    tr = te.add_request(prompt, max_new_tokens=8, eos_token_id=eos)
    _drain(je, 100)
    _drain(te, 100)
    out = tr.future.result(timeout=0)
    assert len(out) == 6 + 2 and out[-1] == eos
    np.testing.assert_array_equal(out, jr.future.result(timeout=0))


def test_page_pool_alloc_free_invariants():
    pool = teng.PagePool(num_pages=5, page_size=16)
    assert pool.num_free == 4   # page 0 reserved as trash
    pages = [pool.alloc() for _ in range(4)]
    assert 0 not in pages and len(set(pages)) == 4
    with pytest.raises(teng.PoolExhausted):
        pool.alloc()
    pool.share(pages[0])
    pool.free([pages[0]])
    assert pool.refcount(pages[0]) == 1
    pool.free(pages[:2])
    pool.assert_consistent()
    with pytest.raises(RuntimeError, match="double free"):
        pool.free([pages[0]])
    pool.free(pages[2:])
    pool.assert_consistent()
    assert pool.num_free == 4 and pool.num_live == 0


def test_engine_rejects_unservable_requests():
    tm = GPTForCausalLM(gpt_tiny(), device="cpu", seed=1)
    eng = teng.LLMEngine(tm, teng.LLMEngineConfig(
        num_slots=2, page_size=16, num_pages=3, max_model_len=64))
    with pytest.raises(ValueError, match="empty prompt"):
        eng.add_request(np.zeros((0,), np.int64))
    with pytest.raises(ValueError, match="max_model_len"):
        eng.add_request(np.zeros((65,), np.int64))
    with pytest.raises(ValueError, match="KV pages"):
        eng.add_request(np.zeros((40,), np.int64))
    req = eng.add_request(np.arange(5), max_new_tokens=0)
    np.testing.assert_array_equal(req.future.result(timeout=0),
                                  np.arange(5))


@pytest.mark.parametrize("knob,row", [
    ({"session_ttl_s": 30.0}, "A10"), ({"session_max": 8}, "A10"),
    ({"kv_tier": True}, "A10")])
def test_unported_knobs_raise_naming_roadmap_row(knob, row):
    """The knobs ROADMAP row A10b ported take the reference's values and
    defaults; the tier keeps the reference's check that it needs the
    prefix cache (tests/test_torch_kv_tier.py serves with them)."""
    assert row + "b" == "A10b"
    if "kv_tier" in knob:
        for pkg in (teng, jeng):
            with pytest.raises(ValueError, match="prefix_cache"):
                pkg.LLMEngineConfig(**knob)
        knob = dict(knob, prefix_cache=True)
    tc, jc = teng.LLMEngineConfig(**knob), jeng.LLMEngineConfig(**knob)
    for name in ("kv_tier", "session_ttl_s", "session_max"):
        assert getattr(tc, name) == getattr(jc, name), name


def test_sampling_knobs_validated_at_submit():
    """temperature >= 0 and top_p in (0, 1] are checked where a request
    enters (add_request, and `submit` on the caller's thread); a sampled
    request is served, and an unknown knob is a TypeError."""
    tm = GPTForCausalLM(gpt_tiny(), device="cpu", seed=1)
    eng = teng.LLMEngine(tm, teng.LLMEngineConfig(num_slots=2,
                                                  max_model_len=32))
    with pytest.raises(ValueError, match="temperature"):
        eng.add_request(np.arange(3), temperature=-0.1)
    with pytest.raises(ValueError, match="top_p"):
        eng.add_request(np.arange(3), temperature=0.7, top_p=1.01)
    req = eng.add_request(np.arange(3), max_new_tokens=4, temperature=0.7,
                          top_p=0.5)
    assert req.sample_stream == 0 and req.top_p == 0.5
    _drain(eng, 50)
    assert len(req.future.result(timeout=0)) == 7
    with pytest.raises(TypeError):
        teng.LLMEngineConfig(no_such_knob=1)


def test_llm_server_concurrent_submits_match_jax():
    rng = np.random.default_rng(19)
    prompts = [rng.integers(0, 2048, (L,)) for L in (4, 11, 7, 16, 2, 9)]
    jm, tm = _pair(35)
    cfg = dict(num_slots=3, page_size=16, token_budget=8, max_model_len=64)
    je = jeng.LLMEngine(jm, jeng.LLMEngineConfig(**cfg))
    jr = [je.add_request(p, max_new_tokens=5) for p in prompts]
    _drain(je, 300)
    server = teng.LLMServer(tm, teng.LLMEngineConfig(**cfg))
    results, lock = {}, threading.Lock()

    def client(idxs):
        futs = [(i, server.submit(prompts[i], max_new_tokens=5))
                for i in idxs]
        for i, f in futs:
            out = f.result(timeout=120)
            with lock:
                results[i] = out

    with server:
        threads = [threading.Thread(target=client, args=(r,))
                   for r in (range(0, 3), range(3, 6))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        bad = server.submit(np.zeros((200,), np.int64), max_new_tokens=4)
        with pytest.raises(ValueError, match="max_model_len"):
            bad.result(timeout=60)
        assert len(server.generate(np.arange(3), max_new_tokens=2)) == 5
    for i, r in enumerate(jr):
        np.testing.assert_array_equal(results[i], r.future.result())
    assert server.stats["requests"] == len(prompts) + 1
    assert server.engine.pool.num_live == 0
    with pytest.raises(RuntimeError, match="not started"):
        server.submit(np.arange(3))


def test_step_error_fails_futures_and_resets_engine():
    tm = GPTForCausalLM(gpt_tiny(), device="cpu", seed=2)
    eng = teng.LLMEngine(tm, teng.LLMEngineConfig(num_slots=2,
                                                  max_model_len=32))
    req = eng.add_request(np.arange(4), max_new_tokens=3)

    def boom(*a):
        raise RuntimeError("device lost")

    eng._step_fn = boom
    with pytest.raises(RuntimeError, match="device lost"):
        eng.step()
    with pytest.raises(RuntimeError, match="device lost"):
        req.future.result(timeout=0)
    assert not eng.has_work() and eng.pool.num_live == 0
    assert all(float(p.abs().sum()) == 0.0 for p in eng._kv)


def test_step_error_rezeroes_scale_planes():
    tm = GPTForCausalLM(gpt_tiny(), device="cpu", seed=2)
    eng = teng.LLMEngine(tm, teng.LLMEngineConfig(
        num_slots=2, max_model_len=32, kv_dtype="int8"))
    eng.add_request(np.arange(5), max_new_tokens=4)
    eng.step()
    assert all(float(s.sum()) > 0 for s in eng._kv_scales)
    eng.add_request(np.arange(3), max_new_tokens=4)
    step_fn = eng._step_fn

    def boom(*a):
        step_fn(*a)          # the pools are half written, then the error
        raise RuntimeError("device lost")

    eng._step_fn = boom
    with pytest.raises(RuntimeError, match="device lost"):
        eng.step()
    assert not eng.has_work() and eng.pool.num_live == 0
    assert all(float(p.abs().sum()) == 0.0
               for p in eng._kv + eng._kv_scales)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    # an AST scan over every module of the port (and chip_smoke.py): the
    # test process itself has jax loaded, so a sys.modules check could
    # not tell. ml_dtypes is banned too: the card's machine lacks it
    files = sorted((ROOT / "paddle_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    # the vision path's modules are among the scanned
    scanned = {f.relative_to(ROOT).as_posix() for f in files}
    for name in ("vision/models/resnet.py", "vision/models/lenet.py",
                 "nn/functional/conv.py", "nn/functional/pooling.py",
                 "nn/functional/norm.py", "nn/functional/activation.py",
                 "nn/layer/conv.py", "nn/layer/pooling.py",
                 "nn/layer/norm.py", "nn/layer/layers.py",
                 "nn/initializer/__init__.py", "core/recompute.py",
                 "ops/__init__.py", "ops/_helpers.py", "ops/creation.py",
                 "ops/math.py", "ops/manipulation.py", "ops/activation.py",
                 "ops/linalg.py", "ops/extras.py", "ops/control_flow.py",
                 "ops/api_misc.py", "tensor_core.py", "linalg.py",
                 "text/models/bert.py",
                 # the high-level vision training path
                 "io/__init__.py", "io/multiprocess.py",
                 "native/__init__.py", "metric/__init__.py",
                 "profiler/__init__.py", "profiler/statistic.py",
                 "hapi/__init__.py", "hapi/callbacks.py", "hapi/model.py",
                 "hapi/dynamic_flops.py", "hapi/summary.py",
                 "vision/__init__.py", "vision/transforms/__init__.py",
                 "vision/transforms/functional.py",
                 "vision/transforms/color_geometry.py",
                 "vision/datasets/__init__.py", "vision/datasets/folder.py",
                 "vision/datasets/flowers_voc.py",
                 "vision/models/mobilenet.py", "vision/models/mobilenetv1.py",
                 "vision/models/mobilenetv3.py", "vision/models/vgg.py",
                 "vision/models/alexnet.py", "vision/models/squeezenet.py",
                 "vision/models/densenet.py", "vision/models/googlenet.py",
                 "vision/models/inceptionv3.py",
                 "vision/models/shufflenetv2.py",
                 # deployment: capture, save / load, predictors, the
                 # static facade and the detection ops
                 "jit/__init__.py", "jit/autograph.py",
                 "inference/__init__.py", "inference/serving.py",
                 "static/__init__.py", "static/nn.py",
                 "static/nn_build.py", "static/sequence.py",
                 "vision/ops.py"):
        assert f"paddle_tpu_torch/{name}" in scanned, name
    bad = []
    for f in files:
        for mod in _imports(f):
            if mod.split(".")[0] in ("jax", "jaxlib", "paddle_tpu",
                                     "ml_dtypes"):
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad


def test_default_device_raises_without_gpu(monkeypatch):
    from paddle_tpu_torch import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_sla_scheduler_priority_slo_and_victims():
    from paddle_tpu_torch.inference.fleet_serving import (
        Priority, SLAPolicy, SLAScheduler)

    def req(priority, tenant="t", slo=None, t_submit=0.0):
        r = teng._Request([1], 1, None, None, tenant=tenant,
                          priority=priority, ttft_slo_s=slo)
        r.t_submit = t_submit
        return r

    s = SLAScheduler(SLAPolicy(tenant_weights={"heavy": 2.0}))
    batch, std, inter = (req(Priority.BATCH), req(Priority.STANDARD),
                         req(Priority.INTERACTIVE))
    for r in (batch, std, inter):
        s.enqueue(r)
    assert s.pop_next(1.0) is inter and s.pop_next(1.0) is std
    # a batch request past 70 % of its TTFT SLO outranks a fresh
    # interactive one
    late = req(Priority.BATCH, slo=1.0, t_submit=0.0)
    s.enqueue(late)
    s.enqueue(req(Priority.INTERACTIVE, t_submit=0.9))
    assert s.pop_next(0.8) is late
    # victims: lowest priority, then youngest; never a more urgent one
    a, b = req(Priority.STANDARD), req(Priority.BATCH)
    a.admit_seq, b.admit_seq = 0, 1
    assert s.pick_victim([a, b, None]) == (1, b)
    assert s.pick_victim([a, None], worse_than=req(Priority.STANDARD)) is None
    assert s.less_urgent(b, a) and not s.less_urgent(a, b)
