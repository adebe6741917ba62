"""N-gram speculative decoding: the PyTorch port against the JAX package
on CPU (gpt_tiny, the same weights in both).

The verify step (`_paged_verify_fused`) must emit exactly the reference's
tokens on float, int8 and int4 pools — full and partial acceptance, a
narrow slot, a dead slot, the emit budget and EOS inside the window. The
n-gram engine (`spec_mode="ngram"`, spec_k 2 and 4) must give greedy
tokens identical to the reference's n-gram engine AND to the port's own
k=1 engine, with the same window / proposed / accepted counts, through
chunked prefill, EOS, preemption and a per-request opt-out.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference import llm_engine as jeng
from paddle_tpu.inference.structured import ngram as jngram
from paddle_tpu.text.models import GPTForCausalLM as JaxGPT
from paddle_tpu.text.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.convert import export_state_dict
from paddle_tpu_torch.inference import llm_engine as teng
from paddle_tpu_torch.inference.structured import ngram as tngram
from paddle_tpu_torch.quantization import runtime as trt
from paddle_tpu_torch.text.models.gpt import (GPTForCausalLM, gpt_tiny,
                                              sample_tokens)

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


ENGINE = dict(num_slots=3, page_size=16, token_budget=8, max_model_len=96)
STATS = ("steps", "tokens_in", "generated", "finished", "preemptions",
         "ngram_windows", "ngram_proposed", "ngram_accepted")


@pytest.fixture(autouse=True)
def _serial_mesh():
    from paddle_tpu.distributed import mesh as mesh_mod

    mesh_mod.reset_mesh()
    yield


def _make_pair(seed):
    """gpt_tiny in both packages with the port's seeded init (N(0, 0.02)
    matrices) copied into the reference. Under that init a random model
    falls into short loops of its own tokens, which prompt lookup then
    proposes — so windows accept; the reference's own init gives a
    position-driven chain that never repeats."""
    from paddle_tpu.distributed import mesh as mesh_mod

    mesh_mod.reset_mesh()
    tm = GPTForCausalLM(gpt_tiny(), device="cpu", seed=seed)
    jm = JaxGPT(jax_gpt_tiny())
    jm.set_state_dict({k: paddle.to_tensor(v)
                       for k, v in export_state_dict(tm).items()})
    jm.eval()
    return jm, tm


@pytest.fixture(scope="module")
def pair():
    return _make_pair(41)


def _chain(tm, seed, n=30):
    """The model's own greedy continuation of a random 3-token start. A
    random gpt_tiny continues mostly as a function of its last token, so
    a prompt whose suffix repeats the chain's start is followed by the
    chain again — which is exactly what prompt lookup proposes."""
    start = np.random.default_rng(seed).integers(0, 2048, (3,))
    eng = teng.LLMEngine(tm, teng.LLMEngineConfig(**ENGINE))
    return _serve(eng, [start], n)[0][3:]


def _prompts(pair, seed):
    """A repetitive-suffix workload (the prompt-lookup sweet spot): two
    prompts that end in a repeat of the model's own chain, one plain
    random prompt longer than the token budget (chunked prefill while
    the others decode)."""
    rng = np.random.default_rng(seed)
    chain = _chain(pair[1], seed)
    return [np.concatenate([chain[:24], chain[:4]]),
            np.concatenate([rng.integers(0, 2048, (4,)), chain[:12],
                            chain[:3]]),
            rng.integers(0, 2048, (19,))]


def _drain(eng, limit=600):
    steps = 0
    while eng.has_work():
        eng.step()
        eng.pool.assert_consistent()
        steps += 1
        assert steps < limit
    return steps


def _serve(eng, prompts, max_new, eos=None, spec_modes=None):
    reqs = [eng.add_request(p, max_new_tokens=max_new, eos_token_id=eos,
                            **({} if spec_modes is None
                               else {"spec_mode": spec_modes[i]}))
            for i, p in enumerate(prompts)]
    _drain(eng)
    assert eng.pool.num_live == 0
    return [r.future.result(timeout=0) for r in reqs]


def _three_engines(pair, prompts, max_new, eos=None, spec_modes=None,
                   **cfg):
    """(reference n-gram, port n-gram, port k=1) outputs and engines."""
    jm, tm = pair
    spec = dict(ENGINE, spec_mode="ngram", **cfg)
    je = jeng.LLMEngine(jm, jeng.LLMEngineConfig(**spec))
    te = teng.LLMEngine(tm, teng.LLMEngineConfig(**spec))
    plain = {k: v for k, v in spec.items() if k not in ("spec_mode",
                                                        "spec_k")}
    t1 = teng.LLMEngine(tm, teng.LLMEngineConfig(**plain))
    outs = [_serve(e, prompts, max_new, eos, spec_modes)
            for e in (je, te)]
    outs.append(_serve(t1, prompts, max_new, eos))
    return outs, (je, te, t1)


def _assert_same(outs, engines):
    ref, got, k1 = outs
    for a, b, c in zip(ref, got, k1):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(b, c)
    je, te, _ = engines
    for key in STATS:
        assert te.stats[key] == je.stats[key], key


@pytest.mark.parametrize("spec_k", [2, 4])
@pytest.mark.parametrize("kv_dtype", [None, "int8", "int4"])
def test_ngram_engine_token_identical(pair, kv_dtype, spec_k):
    outs, engines = _three_engines(pair, _prompts(pair, spec_k), 40,
                                   spec_k=spec_k, kv_dtype=kv_dtype)
    _assert_same(outs, engines)
    te = engines[1]
    assert te.stats["ngram_windows"] > 0
    assert te.stats["ngram_accepted"] > 0, "no proposal was accepted"
    # a window emits up to k+1 tokens: fewer steps than the k=1 engine
    assert te.stats["steps"] < engines[2].stats["steps"]
    assert te.sched.stats["spec_proposed"] == te.stats["ngram_proposed"]
    assert te.sched.boundary_lag_s > 0.0


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_ngram_eos_mid_window(pair, kv_dtype):
    """An eos the model emits inside an accepted window: kept, nothing
    after it, the same as the k=1 engine and the reference."""
    prompts = _prompts(pair, 7)
    _, tm = pair
    plain = teng.LLMEngine(tm, teng.LLMEngineConfig(**ENGINE,
                                                    kv_dtype=kv_dtype))
    free = _serve(plain, prompts[:1], 40)[0][len(prompts[0]):]
    # the first token that repeats: the windows there are accepted ones
    vals, first = np.unique(free, return_index=True)
    counts = np.array([(free == v).sum() for v in vals])
    eos = int(vals[np.argmax(np.where(counts > 1, first, -1))])
    outs, engines = _three_engines(pair, prompts, 40, eos=eos, spec_k=4,
                                   kv_dtype=kv_dtype)
    _assert_same(outs, engines)
    ended = [o for o in outs[1] if o[-1] == eos]
    assert ended, "no request stopped at the eos"
    assert engines[1].stats["ngram_accepted"] > 0


@pytest.mark.parametrize("kv_dtype", [None, "int4"])
def test_ngram_preemption(pair, kv_dtype):
    """Four requests of up to 3 pages each through a 5-page pool: windows
    reserve proposal pages, preempt and replay; tokens and stats still
    equal the reference's and the k=1 engine's tokens."""
    rng = np.random.default_rng(17)
    chain = _chain(pair[1], 17)
    prompts = [np.concatenate([rng.integers(0, 2048, (2,)), chain[:n - 6],
                               chain[:4]]) for n in (20, 22, 18, 21)]
    outs, engines = _three_engines(pair, prompts, 22, spec_k=4,
                                   kv_dtype=kv_dtype, num_pages=6,
                                   max_model_len=48)
    _assert_same(outs, engines)
    assert engines[1].stats["preemptions"] > 0, "pool was not tight enough"


def test_ngram_per_request_opt_out(pair):
    prompts = _prompts(pair, 9)
    outs, engines = _three_engines(pair, prompts, 30, spec_k=4,
                                   spec_modes=["off", "ngram", None])
    _assert_same(outs, engines)
    # the opted-out request proposed nothing: rerun it alone
    _, te, _ = engines
    jm, tm = pair
    alone = teng.LLMEngine(tm, teng.LLMEngineConfig(**ENGINE,
                                                    spec_mode="ngram"))
    _serve(alone, prompts[:1], 30, spec_modes=["off"])
    assert alone.stats["ngram_proposed"] == 0
    assert alone.stats["ngram_windows"] > 0   # verify-only windows


def test_ngram_proposals_match_reference():
    rng = np.random.default_rng(5)

    class _Req:
        def __init__(self, toks):
            self.tokens = toks

    class _Spec:
        k, max_match, scan_window = 4, 3, 512

    histories = [[1, 2, 3, 9, 1, 2, 3], [7], [5, 5, 5, 5], [1, 2, 1, 2, 1],
                 [9, 8, 7, 6]]
    histories += [list(rng.integers(0, 6, (n,))) for n in (12, 40, 700)]
    for h in histories:
        h = [int(t) for t in h]
        want = jngram.NgramSpeculator._propose(_Spec, _Req(h))
        got = tngram.NgramSpeculator._propose(_Spec, _Req(h))
        assert got == want, h
    assert tngram.NgramSpeculator._propose(_Spec, _Req([1, 2, 3, 9, 1, 2,
                                                        3])) == [9, 1, 2, 3]


def _verify_inputs(seed, kv_dtype):
    """Pools holding a random 'prefix' for 3 slots (float, or codes +
    scales), page tables, and per-slot window arguments: slot 0 full
    width, slot 1 narrow (width 1) with an emit budget of 2, slot 2
    dead."""
    rng = np.random.default_rng(seed)
    L, N, P, H, D, MP = 2, 14, 8, 4, 32, 4
    S, k = 3, 3
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
               width=np.array([k, 1, 0], np.int32),
               rem=np.array([9, 2, 0], np.int32),
               fin0=np.array([False, False, True]),
               eos=np.full((S,), -1, np.int32))
    return pools, scales, pt, win, k, P


def _run_verify(model, jax_side, pools, scales, pt, win, drafts, k, P):
    S = pt.shape[0]
    if jax_side:
        from paddle_tpu.autograd import engine as ag

        with ag.no_grad_guard():
            emits, kv, kvs = model._paged_verify_fused(
                k, P, *(jnp.asarray(win[n]) for n in ("tok0", "pos0")),
                jnp.asarray(drafts), jnp.asarray(win["width"]),
                jnp.asarray(win["rem"]), jnp.asarray(win["fin0"]),
                jnp.asarray(win["eos"]), jnp.zeros((S,), jnp.float32),
                jnp.ones((S,), jnp.float32), jnp.zeros((S,), jnp.int32),
                jnp.asarray(pt), [jnp.asarray(p) for p in pools],
                None if scales is None else [jnp.asarray(s)
                                             for s in scales],
                jax.random.PRNGKey(0))
        return (np.asarray(emits), [np.asarray(p) for p in kv],
                [np.asarray(s) for s in kvs])
    kv = [torch.from_numpy(p.copy()) for p in pools]
    kvs = None if scales is None else [torch.from_numpy(s.copy())
                                       for s in scales]
    with torch.inference_mode():
        emits, kv, kvs = model._paged_verify_fused(
            k, P, *(torch.from_numpy(win[n]) for n in ("tok0", "pos0")),
            torch.from_numpy(drafts), torch.from_numpy(win["width"]),
            torch.from_numpy(win["rem"]), torch.from_numpy(win["fin0"]),
            torch.from_numpy(win["eos"]), torch.zeros((S,)),
            torch.from_numpy(pt), kv, kvs)
    return (emits.numpy(), [p.numpy() for p in kv],
            [] if kvs is None else [s.numpy() for s in kvs])


@pytest.mark.parametrize("kv_dtype", [None, "int8", "int4"])
def test_verify_step_matches_reference(kv_dtype):
    """`_paged_verify_fused` on both sides from the same pools: slot 0's
    proposals are the model's own picks (built position by position, so
    all k are accepted), slot 1 is narrow with an emit budget of 2, slot
    2 is dead. Emits equal the reference's exactly; then an eos inside
    slot 0's accepted window cuts the emits after it."""
    jm, tm = _make_pair(43)
    pools, scales, pt, win, k, P = _verify_inputs(3, kv_dtype)
    drafts = np.random.default_rng(4).integers(0, 2048, (3, k)).astype(
        np.int32)
    for j in range(k):       # accept one more proposal per pass
        emits, _, _ = _run_verify(tm, False, pools, scales, pt, win, drafts,
                                  k, P)
        drafts[0, j] = emits[j, 0]
    drafts[1, 0] = emits[0, 1]
    got, tkv, tkvs = _run_verify(tm, False, pools, scales, pt, win, drafts,
                                 k, P)
    want, jkv, jkvs = _run_verify(jm, True, pools, scales, pt, win, drafts,
                                  k, P)
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] >= 0).all()                 # k accepted + 1
    assert (got[:2, 1] >= 0).all() and (got[2:, 1] == -1).all()  # rem 2
    assert (got[:, 2] == -1).all()                # dead slot
    for a, b in zip(tkv, jkv):
        if kv_dtype is None:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        else:   # codes of rows the two frameworks wrote: at most one step
            assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1
    for a, b in zip(tkvs, jkvs):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    win["eos"][0] = got[1, 0]
    cut, _, _ = _run_verify(tm, False, pools, scales, pt, win, drafts, k, P)
    ref, _, _ = _run_verify(jm, True, pools, scales, pt, win, drafts, k, P)
    np.testing.assert_array_equal(cut, ref)
    first = int(np.argmax(got[:, 0] == got[1, 0]))
    assert (cut[:first + 1, 0] == got[:first + 1, 0]).all()
    assert (cut[first + 1:, 0] == -1).all()


def test_sample_tokens_greedy_first_max_and_unported_draws():
    """Greedy rows take the first maximal index; a draw needs the engine's
    key (the host picks the branch), so a sampled row without one
    raises."""
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [3.0, -1.0, 3.0, 3.0]])
    assert sample_tokens(logits).tolist() == [1, 0]
    assert sample_tokens(logits, torch.zeros(2)).dtype == torch.int32
    with pytest.raises(ValueError, match="key"):
        sample_tokens(logits, torch.tensor([0.0, 0.7]))


def test_spec_config_and_per_request_validation(monkeypatch):
    with pytest.raises(ValueError, match="spec_mode"):
        teng.LLMEngineConfig(spec_mode="turbo")
    with pytest.raises(ValueError, match="spec_k"):
        teng.LLMEngineConfig(spec_mode="ngram", spec_k=0)
    monkeypatch.setenv("PT_SPEC_K", "3")
    assert teng.LLMEngineConfig(spec_mode="ngram").spec_k == 3
    tm = GPTForCausalLM(gpt_tiny(), device="cpu", seed=1)
    spec = teng.LLMEngine(tm, teng.LLMEngineConfig(
        num_slots=2, max_model_len=32, spec_mode="ngram"))
    assert spec._spec.k == 3 and spec.pool_bytes() == sum(
        p.numel() * p.element_size() for p in spec._kv)
    with pytest.raises(ValueError, match="engine resource"):
        spec.add_request(np.arange(4), spec_mode="draft")
    with pytest.raises(ValueError, match="must be one of"):
        spec.add_request(np.arange(4), spec_mode="warp")
    plain = teng.LLMEngine(tm, teng.LLMEngineConfig(num_slots=2,
                                                    max_model_len=32))
    with pytest.raises(ValueError, match="engine resource"):
        plain.add_request(np.arange(4), spec_mode="ngram")
    plain.add_request(np.arange(4), spec_mode="off", max_new_tokens=2)
    _drain(plain)
    server = teng.LLMServer(tm, teng.LLMEngineConfig(num_slots=2,
                                                     max_model_len=32))
    with server:
        with pytest.raises(ValueError, match="spec_mode"):
            server.submit(np.arange(3), spec_mode="warp")


def test_window_headroom_counts_frontier_slots(pair):
    jm, tm = pair
    te = teng.LLMEngine(tm, teng.LLMEngineConfig(**ENGINE,
                                                 spec_mode="ngram"))
    te.add_request(np.arange(3), max_new_tokens=8)
    te.add_request(np.arange(30), max_new_tokens=8)   # prefills 4 ticks
    te.step()
    assert te._spec.window_headroom() == 1
    assert te._spec.pool_bytes() == 0


def test_scheduler_boundary_lag_escalates_a_window_early():
    from paddle_tpu_torch.inference.fleet_serving import (Priority,
                                                          SLAScheduler)

    s = SLAScheduler()
    r = teng._Request([1], 1, None, None, priority=Priority.BATCH,
                      ttft_slo_s=1.0)
    r.t_submit = 0.0
    assert s._at_risk(r, 0.6) is None           # 0.6 < 0.7 of the SLO
    s.note_boundary(0.2)
    assert s.boundary_lag_s == pytest.approx(0.2)
    assert s._at_risk(r, 0.6) == pytest.approx(1.0)
    s.note_boundary(5.0)                        # capped at 1 s, then EMA
    assert s.boundary_lag_s == pytest.approx(0.6)
    s.note_spec_window(4, 3)
    s.note_spec_window(2, 0)
    assert (s.stats["spec_proposed"], s.stats["spec_accepted"]) == (6, 3)


def test_llm_server_ngram_int8_matches_reference(pair):
    jm, tm = pair
    prompts = _prompts(pair, 11)
    cfg = dict(ENGINE, spec_mode="ngram", spec_k=4, kv_dtype="int8")
    je = jeng.LLMEngine(jm, jeng.LLMEngineConfig(**cfg))
    want = _serve(je, prompts, 24)
    server = teng.LLMServer(tm, teng.LLMEngineConfig(**cfg))
    with server:
        futs = [server.submit(p, max_new_tokens=24) for p in prompts]
        got = [f.result(timeout=120) for f in futs]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert server.stats["ngram_windows"] > 0
