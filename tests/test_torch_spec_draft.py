"""Draft-model speculative decoding: the PyTorch port against the JAX
package's draft engine on CPU (gpt_tiny width, the same weights in both).

The pair is the reference's tests/test_speculative.py `_make_pair`: a
4-block target whose blocks 2-4 have proj / fc2 damped, and a 1-block
draft holding the target's embeddings, first block and final LN, carried
into the port by `convert`. The draft's propose window
(`_paged_decode_fused` with lag / frontier) must emit the reference's
tokens and write the reference's draft KV on float, int8 and int4 pools;
the draft engine's greedy and sampled tokens must equal the reference's
draft engine's and the port's own k=1 engine's, with the same window,
proposal and acceptance counts, through an adversarial draft, EOS inside
a window, preemption at a boundary, per-request opt-out and a
chunk-prefilling straggler; `abort_all` must zero the draft pools in
place. On CPU the propose window runs eagerly (`_ProposeStep`); its CUDA
graph is checked against the eager window on the card by chip_smoke.py.
"""
import contextlib
import gc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference import llm_engine as jeng
from paddle_tpu.text.models import GPTForCausalLM as JaxGPT
from paddle_tpu.text.models.gpt import GPTConfig as JaxConfig
from paddle_tpu.text.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.convert import load_jax_state_dict
from paddle_tpu_torch.core import prng
from paddle_tpu_torch.inference import llm_engine as teng
from paddle_tpu_torch.inference import speculative as tspec
from paddle_tpu_torch.quantization import runtime as trt
from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

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
STATS = ("steps", "tokens_in", "generated", "finished", "preemptions",
         "spec_windows", "spec_proposed", "spec_accepted")


@pytest.fixture(autouse=True)
def _serial_mesh():
    from paddle_tpu.distributed import mesh as mesh_mod

    mesh_mod.reset_mesh()
    yield


def _port(jm, cfg):
    tm = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
    load_jax_state_dict(tm, {k: np.array(v.numpy())
                             for k, v in jm.state_dict().items()})
    tm.eval()
    return tm


def _make_pair(seed=30, layers=4, draft_layers=1, damp=0.05):
    """The reference's `_make_pair` (tests/test_speculative.py:41): the
    target's blocks past the first have their residual projections
    damped, the draft is the first block with the embeddings and final
    LN, weight for weight. Returns the reference pair and the port's."""
    from paddle_tpu.distributed import mesh as mesh_mod

    mesh_mod.reset_mesh()
    paddle.seed(seed)
    cfg = dict(vocab_size=2048, hidden_size=128, num_layers=layers,
               num_heads=4, max_seq_len=256)
    big = JaxGPT(JaxConfig(**cfg))
    big.eval()
    for layer in big.gpt.layers[draft_layers:]:
        for lin in (layer.proj, layer.fc2):
            lin.weight._value = lin.weight._value * damp
            if lin.bias is not None:
                lin.bias._value = lin.bias._value * damp
    dcfg = dict(cfg, num_layers=draft_layers)
    draft = JaxGPT(JaxConfig(**dcfg))
    draft.eval()
    bsd = big.state_dict()
    for k, p in draft.state_dict().items():
        p._value = bsd[k]._value
    return (big, draft), (_port(big, cfg), _port(draft, dcfg))


@pytest.fixture(scope="module")
def pairs():
    return _make_pair()


@pytest.fixture(scope="module")
def rand_draft():
    """An unrelated random draft (the reference's `rand_draft`): almost
    every proposal is rejected, so every window rolls back."""
    from paddle_tpu.distributed import mesh as mesh_mod

    mesh_mod.reset_mesh()
    paddle.seed(99)
    jd = JaxGPT(jax_gpt_tiny())
    jd.eval()
    return jd, _port(jd, dict(vocab_size=2048, hidden_size=128,
                              num_layers=2, num_heads=4, max_seq_len=256))


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 2048, (n,)) for n in (5, 13, 8)]


def _drain(eng, cap=800):
    steps = 0
    while eng.has_work():
        eng.step()
        eng.pool.assert_consistent()
        for r in eng._slots:
            if r is not None and hasattr(r, "draft_prefilled"):
                # the draft prefix may lag, never run ahead
                assert 0 <= r.draft_prefilled <= r.n_prefilled
        steps += 1
        assert steps < cap, "engine failed to drain"


def _serve(mod, model, prompts, max_new=MAX_NEW, temperature=0.0, eos=None,
           spec_modes=None, **cfg):
    eng = mod.LLMEngine(model, mod.LLMEngineConfig(**dict(ENGINE, **cfg)))
    reqs = [eng.add_request(p, max_new_tokens=max_new, eos_token_id=eos,
                            temperature=temperature,
                            **({} if spec_modes is None
                               else {"spec_mode": spec_modes[i]}))
            for i, p in enumerate(prompts)]
    _drain(eng)
    assert eng.pool.num_live == 0
    return [r.future.result(timeout=0) for r in reqs], eng


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _three(pairs, prompts, **kw):
    """(reference draft engine, port draft engine, port k=1 engine)
    outputs, with the two draft engines' stats equal."""
    (jbig, jdraft), (tbig, tdraft) = pairs
    cfg = {k: v for k, v in kw.items()
           if k not in ("max_new", "temperature", "eos", "spec_modes")}
    req = {k: v for k, v in kw.items() if k not in cfg}
    ref, je = _serve(jeng, jbig, prompts, draft_model=jdraft, **req, **cfg)
    got, te = _serve(teng, tbig, prompts, draft_model=tdraft, **req, **cfg)
    plain = {k: v for k, v in cfg.items() if k != "spec_k"}
    req.pop("spec_modes", None)
    k1, _ = _serve(teng, tbig, prompts, **req, **plain)
    _same(got, ref)
    _same(got, k1)
    for key in STATS:
        assert te.stats[key] == je.stats[key], key
    return got, te


# ---------------------------------------------------------------- window

def _propose_inputs(kv_dtype, sampled):
    """Draft pools holding a random prefix for 3 slots (float, or codes +
    scales) and one propose window of k+1 = 5 iterations: slot 0 at lag 1
    (it starts at pos0 - 1 = 12 from the token there; its iteration-0
    pick is forced to the frontier token), slot 1 at lag 0 with an emit
    budget of 3 and an eos, slot 2 empty."""
    rng = np.random.default_rng(3)
    L, N, P, H, D, MP, S = 1, 14, 8, 4, 32, 4, 3
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
               rem=np.array([5, 3, 0], np.int32),
               fin0=np.array([False, False, True]),
               eos=np.array([-1, 5, -1], np.int32),
               temps=np.array([0.8, 0.0, 0.0] if sampled else [0.0] * 3,
                              np.float32),
               top_ps=np.array([0.9, 1.0, 1.0], np.float32),
               streams=np.array([4, 9, 0], np.int32),
               lag=np.array([1, 0, 0], np.int32),
               frontier=np.array([77, 0, 0], np.int32))
    return pools, scales, pt, win, P


_NAMES = ("tok0", "pos0", "rem", "fin0", "eos", "temps", "top_ps",
          "streams")


def _run_propose(model, jax_side, pools, scales, pt, win, P, k, seed):
    if jax_side:
        from paddle_tpu.autograd import engine as ag

        with ag.no_grad_guard():
            emits, kv, kvs = model._paged_decode_fused(
                k, P, *(jnp.asarray(win[n]) for n in _NAMES),
                jnp.asarray(pt), [jnp.asarray(p) for p in pools],
                None if scales is None else [jnp.asarray(s)
                                             for s in scales],
                jax.random.PRNGKey(seed), lag=jnp.asarray(win["lag"]),
                frontier=jnp.asarray(win["frontier"]))
        return (np.asarray(emits), [np.asarray(p) for p in kv],
                [np.asarray(s) for s in kvs])
    kv = [torch.from_numpy(p.copy()) for p in pools]
    kvs = None if scales is None else [torch.from_numpy(s.copy())
                                       for s in scales]
    sampled = bool((win["temps"] > 0).any())
    with torch.inference_mode():
        emits, kv, kvs = model._paged_decode_fused(
            k, P, *(torch.from_numpy(win[n]) for n in _NAMES),
            torch.from_numpy(pt), kv, kvs,
            key=prng.prng_key(seed) if sampled else None,
            lag=torch.from_numpy(win["lag"]),
            frontier=torch.from_numpy(win["frontier"]))
    return (emits.numpy(), [p.numpy() for p in kv],
            [] if kvs is None else [s.numpy() for s in kvs])


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("kv_dtype", [None, "int8", "int4"])
def test_propose_window_matches_reference(pairs, kv_dtype, sampled):
    """The draft's propose window on both sides from the same pools: the
    emits equal the reference's exactly, the lag-1 row's first emit is
    its frontier token, and the draft pools the window wrote equal the
    reference's (float rows to 1e-5 — the two packages' f32 products sum
    in other orders — codes byte for byte, scales to 1e-5)."""
    (_, jdraft), (_, tdraft) = pairs
    pools, scales, pt, win, P = _propose_inputs(kv_dtype, sampled)
    got, tkv, tkvs = _run_propose(tdraft, False, pools, scales, pt, win, P,
                                  5, 11)
    want, jkv, jkvs = _run_propose(jdraft, True, pools, scales, pt, win, P,
                                   5, 11)
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 77 and (got[:, 0] >= 0).all()
    assert (got[3:, 1] == -1).all()          # its budget of 3 spent
    assert (got[:, 2] == -1).all()
    for a, b in zip(tkv, jkv):
        if kv_dtype is None:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(a, b)
    for a, b in zip(tkvs, jkvs):
        np.testing.assert_allclose(a, b, rtol=1e-5)


def test_propose_drafts_gather_skips_the_lag_row():
    """drafts[s, j] = emits[lag_s + j, s], read from the static buffer the
    window staged: a lag-1 row's proposals start at its second emit."""
    model = GPTForCausalLM(GPTConfig(vocab_size=64, hidden_size=32,
                                     num_layers=1, num_heads=2,
                                     max_seq_len=64), device="cpu")
    prop = tspec._ProposeStep(model, 3, 16, 3, 4, prng.prng_key(0))
    lag = prop.host_views()[6]
    lag[:] = [1, 0, 1]
    prop._static.copy_(prop._host)
    emits = torch.arange(12, dtype=torch.int32).reshape(4, 3)
    drafts = prop.drafts(emits)
    np.testing.assert_array_equal(drafts.numpy(),
                                  [[3, 6, 9], [1, 4, 7], [5, 8, 11]])


def test_propose_step_capture_bookkeeping(pairs, monkeypatch):
    """`_ProposeStep` through `_FusedStep`'s capture machinery with
    torch.cuda's graph API replaced by stand-ins that run the captured
    body eagerly on the CPU: the warm-up's K1 calls count, the capture's
    are taken back, every replay adds them again, the collector is held
    off during the capture, and lag / frontier ride the static buffer."""
    from paddle_tpu_torch.ops.cuda_kernels import paged_attention as pa

    _, (_, tdraft) = pairs
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
    prop = tspec._ProposeStep(tdraft, 2, 16, 3, 4, prng.prng_key(0))
    views = prop.host_views()
    assert len(views) == 11                  # 8 int rows, 2 float, tables
    views[3][:] = 1                          # every slot empty
    prop._static.copy_(prop._host)
    prop.cuda, prop._stream = True, Stream()
    kv = [torch.zeros((5, 16, 4, 32)) for _ in range(2)]
    saved = dict(pa.launches)
    try:
        pa.reset_launches()
        g = prop._capture(kv, None, False)
        # 1 draft layer x 3 iterations: the warm-up's, not the capture's
        assert pa.launches["rpa"] == 3 and g.counts[0][1] == {"rpa": 3}
        prop.replay(g)
        assert pa.launches["rpa"] == 6
    finally:
        pa.launches.update(saved)
    assert during == [False] and gc.isenabled()
    assert (prop.captures, prop.warmups, prop.replays) == (1, 1, 1)
    assert g.emits.shape == (3, 3) and (g.emits == -1).all()


# ---------------------------------------------------------------- engine

@pytest.mark.parametrize("spec_k", [2, 4])
@pytest.mark.parametrize("kv_dtype", [None, "int8", "int4"])
def test_draft_greedy_token_identical(pairs, prompts, kv_dtype, spec_k):
    """Greedy tokens equal to the reference's draft engine AND to the
    port's k=1 engine, with the same steps, windows, proposals and
    acceptances; windows ran and accepted proposals."""
    _, te = _three(pairs, prompts, spec_k=spec_k, kv_dtype=kv_dtype)
    assert te.stats["spec_windows"] > 0 and te.stats["spec_accepted"] > 0
    assert te.stats["steps"] > te.stats["spec_windows"]   # prefill ticks
    assert te._fused_fn is None            # a draft engine never fuses
    if kv_dtype is not None:
        assert te._spec._kv_scales and te._spec._quantized


def test_draft_adversarial_random_draft(pairs, prompts, rand_draft):
    """An unrelated random draft: almost every proposal rejected, every
    window rolled back, and the tokens still the k=1 engine's and the
    reference's."""
    (jbig, _), (tbig, _) = pairs
    jd, td = rand_draft
    ref, je = _serve(jeng, jbig, prompts, draft_model=jd, spec_k=4)
    got, te = _serve(teng, tbig, prompts, draft_model=td, spec_k=4)
    k1, _ = _serve(teng, tbig, prompts)
    _same(got, ref)
    _same(got, k1)
    for key in STATS:
        assert te.stats[key] == je.stats[key], key
    assert te.stats["spec_proposed"] > 0
    assert te.stats["spec_accepted"] < te.stats["spec_proposed"] / 4


def test_draft_eos_mid_window(pairs, prompts):
    (_, _), (tbig, _) = pairs
    ref0, _ = _serve(teng, tbig, prompts)
    plen = len(prompts[0])
    eos = int(ref0[0][plen + 1])        # generated index 1: mid-window
    outs, te = _three(pairs, prompts, spec_k=4, eos=eos)
    assert te.stats["spec_windows"] > 0
    assert len(outs[0]) == plen + 2 and outs[0][-1] == eos


def test_draft_preemption_at_boundary(pairs):
    """A tight pool: window reservations narrow, a frontier write with
    no page falls back to the single tick, which preempts at the window
    boundary; the replay re-prefills both pools."""
    rng = np.random.default_rng(7)
    prompts4 = [rng.integers(0, 2048, (20,)) for _ in range(4)]
    _, te = _three(pairs, prompts4, max_new=20, spec_k=2, num_pages=6,
                   max_model_len=48)
    assert te.stats["preemptions"] > 0 and te.stats["spec_windows"] > 0


def test_draft_per_request_off(pairs, prompts):
    """spec_mode "off" on one request (width 0: a plain decode row of the
    verify), "draft" and None on the others."""
    _, te = _three(pairs, prompts, spec_k=3,
                   spec_modes=["off", "draft", None])
    assert te.stats["spec_proposed"] > 0


def test_draft_accepted_count_ignores_picks_past_the_width(prompts):
    """Both models with the final LN zeroed: every logit is 0, so every
    pick is token 0, the token the verify reads where a row proposed
    nothing. A width-0 ("off") row's pick of token 0 is not an accepted
    proposal: the accepted count stays the reference's (every proposal
    accepted, none more)."""
    (jbig, jdraft), (tbig, tdraft) = _make_pair(seed=31)
    for jm in (jbig, jdraft):
        for p in (jm.gpt.ln_f.weight, jm.gpt.ln_f.bias):
            p._value = p._value * 0
    with torch.no_grad():
        for tm in (tbig, tdraft):
            tm.gpt.ln_f.weight.zero_()
            tm.gpt.ln_f.bias.zero_()
    outs, te = _three(((jbig, jdraft), (tbig, tdraft)), prompts, spec_k=3,
                      spec_modes=["off", "draft", None])
    for out, p in zip(outs, prompts):
        assert not out[len(p):].any()
    assert te.stats["spec_accepted"] == te.stats["spec_proposed"] > 0


def _serve_with_straggler(model, prompts, long_prompt, **cfg):
    """Two requests decode; a long prompt is admitted mid-run and
    chunk-prefills at token_budget 6 while the others take windows."""
    eng = teng.LLMEngine(model, teng.LLMEngineConfig(
        num_slots=3, page_size=16, token_budget=6, max_model_len=64, **cfg))
    reqs = [eng.add_request(p, max_new_tokens=20) for p in prompts[:2]]
    for _ in range(6):
        eng.step()
    reqs.append(eng.add_request(long_prompt, max_new_tokens=10))
    ragged = 0
    while eng.has_work():
        w0 = eng.stats.get("spec_windows", 0)
        eng.step()
        if eng.stats.get("spec_windows", 0) > w0 and any(
                r is not None and r.n_prefilled < len(r.tokens) - 1
                for r in eng._slots):
            ragged += 1
    return [r.future.result(timeout=0) for r in reqs], ragged


def test_draft_windows_beside_a_prefilling_straggler(pairs, prompts):
    _, (tbig, tdraft) = pairs
    long_prompt = np.random.default_rng(17).integers(0, 2048, (40,))
    ref, _ = _serve_with_straggler(tbig, prompts, long_prompt)
    outs, ragged = _serve_with_straggler(tbig, prompts, long_prompt,
                                         draft_model=tdraft, spec_k=4)
    assert ragged > 0, "no window ran beside the straggler"
    _same(outs, ref)


@pytest.mark.parametrize("spec_k", [2, 4])
def test_draft_sampled_matches_reference_and_k(pairs, prompts, spec_k):
    """Sampled rows (temperature 0.8): each position's pick is the keyed
    draw, so the tokens equal the reference's draft engine's at the same
    seed and the port's k=1 sampled engine's (invariant to spec_k); the
    draft, keyed on the same draw, still has proposals accepted."""
    _, te = _three(pairs, prompts, spec_k=spec_k, temperature=0.8, seed=7)
    assert te.stats["spec_accepted"] > 0
    _, (tbig, _) = pairs
    greedy, _ = _serve(teng, tbig, prompts)
    sampled, _ = _serve(teng, tbig, prompts, temperature=0.8, seed=7)
    assert any(not np.array_equal(a, b) for a, b in zip(sampled, greedy))


def test_draft_abort_zeroes_pools_in_place(pairs, prompts):
    """abort_all re-zeros the draft pools in place (the propose graph
    holds their addresses): the same tensors, all zero; after a reseed
    the recovered engine serves the k=1 engine's greedy tokens (a sampled
    rerun would draw from later request streams than a fresh engine's)."""
    _, (tbig, tdraft) = pairs
    eng = teng.LLMEngine(tbig, teng.LLMEngineConfig(
        **ENGINE, draft_model=tdraft, spec_k=2, seed=7, kv_dtype="int8"))
    doomed = eng.add_request(prompts[0], max_new_tokens=8)
    for _ in range(3):
        eng.step()
    spec = eng._spec
    ptrs = [p.data_ptr() for p in spec._kv + spec._kv_scales]
    assert any(bool(p.any()) for p in spec._kv)
    eng.abort_all(RuntimeError("injected device error"))
    with pytest.raises(RuntimeError, match="injected"):
        doomed.future.result(timeout=0)
    assert [p.data_ptr() for p in spec._kv + spec._kv_scales] == ptrs
    assert not any(bool(p.any()) for p in spec._kv + spec._kv_scales)
    eng.reseed(7)
    reqs = [eng.add_request(p, max_new_tokens=12) for p in prompts]
    _drain(eng)
    assert eng.stats["spec_accepted"] > 0
    fresh, _ = _serve(teng, tbig, prompts, max_new=12, kv_dtype="int8")
    _same([r.future.result(timeout=0) for r in reqs], fresh)


def test_draft_pools_mirror_the_engine(pairs):
    """The draft pools share the engine's page geometry in its kv dtype
    (int4: head_dim halved, scale planes beside), and `pool_bytes`
    counts them."""
    _, (tbig, tdraft) = pairs
    for kv, dt, d in ((None, torch.float32, 32), ("int4", torch.int8, 16)):
        eng = teng.LLMEngine(tbig, teng.LLMEngineConfig(
            **ENGINE, draft_model=tdraft, kv_dtype=kv))
        spec = eng._spec
        assert eng.spec_mode == "draft" and spec.k == 4
        assert len(spec._kv) == 2 and spec._kv[0].dtype == dt
        assert spec._kv[0].shape == (eng.pool.num_pages, 16, 4, d)
        assert len(spec._kv_scales) == (2 if kv else 0)
        own = sum(p.numel() * p.element_size()
                  for p in eng._kv + eng._kv_scales)
        assert eng.pool_bytes() == own + spec.pool_bytes() > own


def test_draft_config_validation(pairs, rand_draft):
    """The errors of the reference's test_spec_config_validation, and the
    spec_mode / draft_model pairing of its LLMEngineConfig."""
    _, (tbig, tdraft) = pairs
    with pytest.raises(ValueError, match="spec_k"):
        teng.LLMEngineConfig(spec_k=0)
    with pytest.raises(ValueError, match="draft_model"):
        teng.LLMEngineConfig(spec_mode="draft")
    with pytest.raises(ValueError, match="draft-model-free"):
        teng.LLMEngineConfig(spec_mode="ngram", draft_model=tdraft)
    assert teng.LLMEngineConfig(draft_model=tdraft).spec_mode == "draft"
    other = GPTForCausalLM(GPTConfig(vocab_size=512, hidden_size=64,
                                     num_layers=1, num_heads=2,
                                     max_seq_len=256), device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        teng.LLMEngine(tbig, teng.LLMEngineConfig(
            num_slots=2, page_size=16, max_model_len=64, draft_model=other))
    short = GPTForCausalLM(GPTConfig(vocab_size=2048, hidden_size=64,
                                     num_layers=1, num_heads=2,
                                     max_seq_len=32), device="cpu")
    with pytest.raises(ValueError, match="max_seq_len"):
        teng.LLMEngine(tbig, teng.LLMEngineConfig(
            num_slots=2, page_size=16, max_model_len=64, draft_model=short))
    eng = teng.LLMEngine(tbig, teng.LLMEngineConfig(
        num_slots=2, page_size=16, max_model_len=64,
        draft_model=rand_draft[1]))
    with pytest.raises(ValueError, match="engine resource"):
        eng.add_request(np.arange(4), spec_mode="ngram")
    eng.add_request(np.arange(4), spec_mode="draft", max_new_tokens=2)
    eng.add_request(np.arange(4), spec_mode="off", max_new_tokens=2)
    _drain(eng)


def test_spec_draft_pair_copies_the_target():
    """profile_serve.spec_draft_pair (the serve tools' pair): the draft
    holds copies of the target's embeddings, first block and final LN —
    no shared storage — and the target's later blocks are damped."""
    from paddle_tpu_torch.profile_serve import spec_draft_pair

    cfg = GPTConfig(vocab_size=256, hidden_size=64, num_layers=3,
                    num_heads=2, max_seq_len=64)
    target, draft = spec_draft_pair(cfg, dtype="float32", seed=3,
                                    device="cpu")
    ref = GPTForCausalLM(cfg, device="cpu", seed=3)
    big = target.state_dict()
    for k, v in draft.state_dict().items():
        assert torch.equal(v, big[k]) and v.data_ptr() != big[k].data_ptr()
    assert draft.config.num_layers == 1
    torch.testing.assert_close(target.gpt.layers[1].fc2.weight,
                               ref.gpt.layers[1].fc2.weight * 0.01)
    assert torch.equal(target.gpt.layers[0].fc2.weight,
                       ref.gpt.layers[0].fc2.weight)
