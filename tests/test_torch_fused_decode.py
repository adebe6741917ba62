"""Sampled decode and fused multi-token decode (`decode_k`): the PyTorch
port against the JAX package's engine on CPU (gpt_tiny, the same weights
in both), on the prompts of tests/test_fused_decode.py.

Greedy fused windows at decode_k 2, 4 and 8 must give the tokens of the
reference's k=1 engine and of its own fused engine, with EOS inside a
window, preemption at a window boundary and int8 / int4 pools; sampled
requests (temperature 0.8) the reference's tokens at the same seed, at
k=1 and k=2, through a reseed and an abort; and `stats["fused_steps"]`
the reference's. On CPU a window runs eagerly (`_FusedStep`); the CUDA
graph that serves it on the card is checked by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import llm_engine as jeng
from paddle_tpu.text.models import GPTForCausalLM as JaxGPT
from paddle_tpu.text.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.convert import export_state_dict, load_jax_state_dict
from paddle_tpu_torch.core import prng
from paddle_tpu_torch.inference import llm_engine as teng
from paddle_tpu_torch.quantization import runtime as trt
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


ENGINE = dict(num_slots=3, page_size=16, token_budget=8, max_model_len=64)
MAX_NEW = 24


@pytest.fixture(autouse=True)
def _serial_mesh():
    from paddle_tpu.distributed import mesh as mesh_mod

    mesh_mod.reset_mesh()
    yield


@pytest.fixture(scope="module")
def pair():
    """The reference's seeded gpt_tiny (tests/test_fused_decode.py's
    model) and the port's with its weights. The mesh is reset here too:
    a module-scoped fixture runs before the function-scoped reset, under
    whatever mesh the worker's previous test left."""
    from paddle_tpu.distributed import mesh as mesh_mod

    mesh_mod.reset_mesh()
    paddle.seed(30)
    jm = JaxGPT(jax_gpt_tiny())
    jm.eval()
    tm = GPTForCausalLM(gpt_tiny(), device="cpu")
    load_jax_state_dict(tm, {k: np.array(v.numpy())
                             for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 2048, (L,)) for L in (5, 13, 8)]


def _drain(eng, cap=500):
    steps = 0
    while eng.has_work():
        eng.step()
        eng.pool.assert_consistent()
        steps += 1
        assert steps < cap, "engine failed to drain"


def _serve(mod, model, prompts, max_new=MAX_NEW, temperature=0.0, top_p=1.0,
           eos=None, **cfg):
    eng = mod.LLMEngine(model, mod.LLMEngineConfig(**dict(ENGINE, **cfg)))
    reqs = [eng.add_request(p, max_new_tokens=max_new, eos_token_id=eos,
                            temperature=temperature, top_p=top_p)
            for p in prompts]
    _drain(eng)
    assert eng.pool.num_live == 0
    return [r.future.result(timeout=0) for r in reqs], eng


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def ref_k1(pair, prompts):
    """The reference's k=1 greedy engine: the baseline every fused k is
    held to."""
    return _serve(jeng, pair[0], prompts, decode_k=1)[0]


def _window_inputs(kv_dtype, sampled):
    """Pools holding a random prefix for 3 slots (float, or codes +
    scales) and one window's arguments: slot 0 live for the whole window,
    slot 1 live with an emit budget of 2 and an eos, slot 2 empty."""
    rng = np.random.default_rng(3)
    L, N, P, H, D, MP, S = 2, 14, 8, 4, 32, 4, 3
    pools = [rng.standard_normal((N, P, H, D)).astype(np.float32)
             for _ in range(2 * L)]
    scales = None
    if kv_dtype is not None:
        f = (trt.quantize_kv_rows_int4 if kv_dtype == "int4"
             else trt.quantize_kv_rows)
        qs = [f(torch.from_numpy(p.reshape(N * P, H, D))) for p in pools]
        pools = [c.numpy().reshape(N, P, H, -1) for c, _ in qs]
        scales = [s.numpy().reshape(N, P, H) for _, s in qs]
    pt = (1 + rng.permutation(N - 1)[:S * MP]).reshape(S, MP).astype(
        np.int32)
    win = dict(tok0=rng.integers(0, 2048, (S,)).astype(np.int32),
               pos0=np.array([13, 6, 0], np.int32),
               rem=np.array([4, 2, 0], np.int32),
               fin0=np.array([False, False, True]),
               eos=np.array([-1, 5, -1], np.int32),
               temps=np.array([0.8, 0.0, 0.0] if sampled else [0.0] * 3,
                              np.float32),
               top_ps=np.array([0.9, 1.0, 1.0], np.float32),
               streams=np.array([4, 9, 0], np.int32))
    return pools, scales, pt, win, P


def _run_window(model, jax_side, pools, scales, pt, win, P, k, seed):
    names = ("tok0", "pos0", "rem", "fin0", "eos", "temps", "top_ps",
             "streams")
    if jax_side:
        import jax
        import jax.numpy as jnp

        from paddle_tpu.autograd import engine as ag

        with ag.no_grad_guard():
            emits, kv, kvs = model._paged_decode_fused(
                k, P, *(jnp.asarray(win[n]) for n in names),
                jnp.asarray(pt), [jnp.asarray(p) for p in pools],
                None if scales is None else [jnp.asarray(s)
                                             for s in scales],
                jax.random.PRNGKey(seed))
        return (np.asarray(emits), [np.asarray(p) for p in kv],
                [np.asarray(s) for s in kvs])
    kv = [torch.from_numpy(p.copy()) for p in pools]
    kvs = None if scales is None else [torch.from_numpy(s.copy())
                                       for s in scales]
    sampled = bool((win["temps"] > 0).any())
    with torch.inference_mode():
        emits, kv, kvs = model._paged_decode_fused(
            k, P, *(torch.from_numpy(win[n]) for n in names),
            torch.from_numpy(pt), kv, kvs,
            key=prng.prng_key(seed) if sampled else None)
    return (emits.numpy(), [p.numpy() for p in kv],
            [] if kvs is None else [s.numpy() for s in kvs])


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("kv_dtype", [None, "int8", "int4"])
def test_decode_window_matches_reference(pair, kv_dtype, sampled):
    """`_paged_decode_fused` on both sides from the same pools, k=4: a
    live row, a row that spends its budget of 2 (and whose eos, had it
    come, would stop it), an empty slot; greedy, or slot 0 sampled.
    Emits equal the reference's exactly; the pools the window wrote
    agree (float to 1e-5, codes to one step, scales to 1e-5)."""
    jm, tm = pair
    pools, scales, pt, win, P = _window_inputs(kv_dtype, sampled)
    got, tkv, tkvs = _run_window(tm, False, pools, scales, pt, win, P, 4, 11)
    want, jkv, jkvs = _run_window(jm, True, pools, scales, pt, win, P, 4, 11)
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] >= 0).all() and (got[2:, 1] == -1).all()
    assert (got[:, 2] == -1).all()
    for a, b in zip(tkv, jkv):
        if kv_dtype is None:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        else:
            assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1
    for a, b in zip(tkvs, jkvs):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    # the eos cuts slot 1 right after it: emitted, then -1
    win["eos"][1] = got[0, 1]
    cut, _, _ = _run_window(tm, False, pools, scales, pt, win, P, 4, 11)
    ref, _, _ = _run_window(jm, True, pools, scales, pt, win, P, 4, 11)
    np.testing.assert_array_equal(cut, ref)
    assert cut[0, 1] == got[0, 1] and (cut[1:, 1] == -1).all()


@pytest.mark.parametrize("k", [2, 4, 8])
def test_fused_greedy_token_identical(pair, prompts, ref_k1, k):
    jm, tm = pair
    outs, te = _serve(teng, tm, prompts, decode_k=k)
    _same(outs, ref_k1)
    # the windows really ran fused, beside prefill ticks
    assert te.stats["fused_steps"] > 0
    assert te.stats["steps"] > te.stats["fused_steps"]
    assert te._fused_fn.captures == 0       # CPU: eager windows, no graph
    jouts, je = _serve(jeng, jm, prompts, decode_k=k)
    _same(outs, jouts)
    for key in ("steps", "fused_steps", "generated", "tokens_in",
                "finished"):
        assert te.stats[key] == je.stats[key], key


def test_fused_eos_mid_window(pair, prompts, ref_k1):
    """An eos picked at generated index 1 of a 4-token window: the window
    masks the row's later iterations and the host stops there, as the k=1
    engine does."""
    jm, tm = pair
    plen = len(prompts[0])
    eos = int(ref_k1[0][plen + 1])
    ref, _ = _serve(jeng, jm, prompts, decode_k=1, eos=eos)
    outs, te = _serve(teng, tm, prompts, decode_k=4, eos=eos)
    assert te.stats["fused_steps"] > 0
    _same(outs, ref)
    assert len(outs[0]) == plen + 2 and outs[0][-1] == eos


def test_fused_preemption_at_boundary(pair):
    """4 sequences of 3 pages each through a 5-page pool at decode_k 2:
    windows reserve their pages up front, spill to what the pool covers,
    and hand the step to the single tick (which preempts) when not even
    one token a row fits. The tokens must not notice."""
    jm, tm = pair
    rng = np.random.default_rng(7)
    prompts4 = [rng.integers(0, 2048, (20,)) for _ in range(4)]
    cfg = dict(num_pages=6, max_model_len=48)
    ref, _ = _serve(jeng, jm, prompts4, max_new=20, decode_k=1, **cfg)
    outs, te = _serve(teng, tm, prompts4, max_new=20, decode_k=2, **cfg)
    assert te.stats["preemptions"] > 0, "pool was not tight enough"
    assert te.stats["fused_steps"] > 0
    _same(outs, ref)


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_fused_quantized_pools(pair, prompts, kv_dtype):
    """int8 / packed-int4 pools: each window quantizes its rows into the
    pools and scale planes in place; tokens equal the reference's k=1
    engine on the same pool kind."""
    jm, tm = pair
    ref, _ = _serve(jeng, jm, prompts, decode_k=1, kv_dtype=kv_dtype)
    outs, te = _serve(teng, tm, prompts, decode_k=4, kv_dtype=kv_dtype)
    assert te.stats["fused_steps"] > 0
    _same(outs, ref)


@pytest.mark.parametrize("k", [1, 2])
def test_sampled_tokens_match_reference(pair, prompts, k):
    """temperature 0.8 / top_p 0.9: the keyed draw (engine seed, request
    stream, position) gives the reference's tokens at k=1 (the host tick's
    sampler) and k=2 (the fused window's)."""
    jm, tm = pair
    ref, _ = _serve(jeng, jm, prompts, temperature=0.8, top_p=0.9, seed=7,
                    decode_k=1)
    outs, te = _serve(teng, tm, prompts, temperature=0.8, top_p=0.9, seed=7,
                      decode_k=k)
    _same(outs, ref)
    assert (te.stats["fused_steps"] > 0) == (k > 1)


def test_sampling_depends_on_seed_not_on_k(pair, prompts, ref_k1):
    jm, tm = pair
    base, _ = _serve(teng, tm, prompts, temperature=0.8, seed=7, decode_k=1)
    fused, _ = _serve(teng, tm, prompts, temperature=0.8, seed=7,
                      decode_k=4)
    _same(fused, base)
    assert any(not np.array_equal(a, g) for a, g in zip(base, ref_k1))
    other, _ = _serve(teng, tm, prompts, temperature=0.8, seed=8, decode_k=4)
    assert any(not np.array_equal(a, b) for a, b in zip(fused, other))


def test_reseed_matches_a_fresh_engine(pair, prompts):
    """reseed() rewrites the key in place: the engine then samples as an
    engine built with that seed and the same request history does."""
    jm, tm = pair
    eng = teng.LLMEngine(tm, teng.LLMEngineConfig(**ENGINE, decode_k=2,
                                                  seed=1))
    key = eng._key
    eng.reseed(9)
    assert eng._key is key
    reqs = [eng.add_request(p, max_new_tokens=12, temperature=0.8)
            for p in prompts]
    _drain(eng)
    ref, _ = _serve(jeng, jm, prompts, max_new=12, temperature=0.8, seed=9,
                    decode_k=1)
    _same([r.future.result(timeout=0) for r in reqs], ref)


def test_abort_recovery_restores_prng_key(pair, prompts):
    """The reference's scenario: a sampled request dies in abort_all; the
    recovered engine samples as an unaborted engine with the same request
    history (streams are assigned per add_request). Pools are zeroed in
    place and the key restored, so the window's tensors stay the same."""
    jm, tm = pair
    cfg = dict(ENGINE, decode_k=2, seed=7)
    eng = teng.LLMEngine(tm, teng.LLMEngineConfig(**cfg))
    doomed = eng.add_request(prompts[0], max_new_tokens=8, temperature=0.8)
    eng.step()
    eng.step()
    assert eng.stats["fused_steps"] == 1
    pools = [p.data_ptr() for p in eng._kv]
    eng._key.fill_(12345)          # a window died with the key half written
    eng.abort_all(RuntimeError("injected device error"))
    with pytest.raises(RuntimeError, match="injected"):
        doomed.future.result(timeout=0)
    assert [p.data_ptr() for p in eng._kv] == pools
    assert all(float(p.abs().sum()) == 0.0 for p in eng._kv)
    reqs = [eng.add_request(p, max_new_tokens=MAX_NEW, temperature=0.8)
            for p in prompts]
    _drain(eng)
    je = jeng.LLMEngine(jm, jeng.LLMEngineConfig(**cfg))
    je.add_request(prompts[0], max_new_tokens=8, temperature=0.8)
    _drain(je)
    ref = [je.add_request(p, max_new_tokens=MAX_NEW, temperature=0.8)
           for p in prompts]
    _drain(je)
    _same([r.future.result(timeout=0) for r in reqs],
          [r.future.result(timeout=0) for r in ref])


def test_sampling_and_decode_k_validation(pair, monkeypatch):
    _, tm = pair
    eng = teng.LLMEngine(tm, teng.LLMEngineConfig(num_slots=2,
                                                  max_model_len=64))
    with pytest.raises(ValueError, match="temperature"):
        eng.add_request(np.zeros((3,), np.int32), temperature=-0.5)
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError, match="top_p"):
            eng.add_request(np.zeros((3,), np.int32), top_p=bad)
    with pytest.raises(ValueError, match="decode_k"):
        teng.LLMEngineConfig(decode_k=0)
    monkeypatch.setenv("PT_DECODE_K", "3")
    assert teng.LLMEngineConfig().decode_k == 3
    monkeypatch.delenv("PT_DECODE_K")
    assert teng.LLMEngineConfig().decode_k == 1
    server = teng.LLMServer(tm, teng.LLMEngineConfig(num_slots=2,
                                                     max_model_len=64))
    with server:
        with pytest.raises(ValueError, match="temperature"):
            server.submit(np.arange(3), temperature=-1.0)
        with pytest.raises(ValueError, match="top_p"):
            server.submit(np.arange(3), top_p=0.0)
        out = server.submit(np.arange(3), max_new_tokens=4,
                            temperature=0.7, top_p=0.9).result(timeout=60)
    assert len(out) == 7 and ((out >= 0) & (out < 2048)).all()


def test_sample_stream_survives_preemption(pair):
    """A preempted sampled request keeps its stream and re-draws the same
    tokens: the tight pool's outputs equal a roomy pool's."""
    _, tm = pair
    rng = np.random.default_rng(7)
    prompts4 = [rng.integers(0, 2048, (20,)) for _ in range(4)]
    roomy, _ = _serve(teng, tm, prompts4, max_new=20, temperature=0.8,
                      max_model_len=48, decode_k=2)
    tight, te = _serve(teng, tm, prompts4, max_new=20, temperature=0.8,
                       max_model_len=48, num_pages=6, decode_k=2)
    assert te.stats["preemptions"] > 0
    _same(tight, roomy)


@pytest.fixture(scope="module")
def ngram_pair():
    """gpt_tiny in both packages with the port's seeded init copied into
    the reference (the n-gram tests' model: it repeats itself, so
    proposals are accepted)."""
    from paddle_tpu.distributed import mesh as mesh_mod

    mesh_mod.reset_mesh()
    tm = GPTForCausalLM(gpt_tiny(), device="cpu", seed=41)
    jm = JaxGPT(jax_gpt_tiny())
    jm.set_state_dict({k: paddle.to_tensor(v)
                       for k, v in export_state_dict(tm).items()})
    jm.eval()
    return jm, tm


def test_sampled_ngram_engine_matches_reference(ngram_pair):
    """Sampled rows through the verify step: each position's pick is the
    keyed draw, so the n-gram engine's tokens equal the reference n-gram
    engine's and the port's own k=1 engine's, window, proposal and
    acceptance counts included. The prompts repeat the model's own greedy
    chain and the temperature is low (0.1), so some sampled proposals are
    accepted and some rejected."""
    jm, tm = ngram_pair
    start = np.random.default_rng(3).integers(0, 2048, (3,))
    chain = _serve(teng, tm, [start], max_new=30,
                   max_model_len=96)[0][0][3:]
    rng = np.random.default_rng(3)
    prompts = [np.concatenate([chain[:24], chain[:4]]),
               np.concatenate([rng.integers(0, 2048, (4,)), chain[:12],
                               chain[:3]]),
               rng.integers(0, 2048, (19,))]
    cfg = dict(spec_mode="ngram", spec_k=3, seed=5, max_model_len=96)
    kw = dict(max_new=30, temperature=0.1, top_p=0.9)
    ref, je = _serve(jeng, jm, prompts, **kw, **cfg)
    outs, te = _serve(teng, tm, prompts, **kw, **cfg)
    _same(outs, ref)
    for key in ("steps", "ngram_windows", "ngram_proposed",
                "ngram_accepted"):
        assert te.stats[key] == je.stats[key], key
    assert 0 < te.stats["ngram_accepted"] < te.stats["ngram_proposed"]
    k1, _ = _serve(teng, tm, prompts, **kw, seed=5, max_model_len=96)
    _same(outs, k1)
    greedy, _ = _serve(teng, tm, prompts, max_new=30, max_model_len=96)
    assert any(not np.array_equal(a, b) for a, b in zip(outs, greedy))


def test_fused_step_capture_bookkeeping(pair, monkeypatch):
    """`_FusedStep._capture` with torch.cuda's graph API replaced by
    stand-ins that run the captured body eagerly on the CPU: the warm-up's
    K1 calls count, the capture's are taken back, and every replay adds
    them again; the cyclic collector is collected before the capture and
    held off during it (a dead graph destroyed mid-capture invalidates the
    capture on the card), then restored."""
    import contextlib
    import gc

    from paddle_tpu_torch.ops.cuda_kernels import paged_attention as pa

    _, tm = pair
    during = []

    class Stream:
        cuda_stream = 1

        def wait_stream(self, other):
            pass

    class Graph:
        def replay(self):
            pass

    @contextlib.contextmanager
    def capture(graph, stream=None, capture_error_mode=None):
        assert capture_error_mode == "global"
        during.append(gc.isenabled())
        yield

    real = pa.ragged_paged_attention

    def counting(q, *args, **kw):
        pa.launches["rpa"] += 1
        return real(q, *args, **kw)

    monkeypatch.setattr(pa, "ragged_paged_attention", counting)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", capture)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream())
    fs = teng._FusedStep(tm, 2, 16, 3, 4, prng.prng_key(0))
    fs.host_views()[3][:] = 1                 # every slot empty
    fs._static.copy_(fs._host)
    fs.cuda, fs._stream = True, Stream()
    kv = [torch.zeros((5, 16, 4, 32)) for _ in range(4)]
    saved = dict(pa.launches)
    try:
        pa.reset_launches()
        g = fs._capture(kv, None, False)
        # 2 layers x 2 iterations: the warm-up's, not the capture's
        assert pa.launches["rpa"] == 4 and g.counts[0][1] == {"rpa": 4}
        fs.replay(g)
        fs.replay(g)
        assert pa.launches["rpa"] == 12
    finally:
        pa.launches.update(saved)
    assert during == [False] and gc.isenabled()
    assert (fs.captures, fs.warmups, fs.replays) == (1, 1, 2)
    assert len(g.logits) == 2 and g.emits.shape == (2, 3)
    assert (g.emits == -1).all()              # empty slots emit nothing
