"""Structured decoding: the PyTorch port against the JAX package's
(paddle_tpu/inference/structured and its hooks in the model and the
engine) on CPU.

The host compilers must give the reference's tables and regex strings
byte for byte, the arena the reference's tables through loads and a
compaction (with the device pair keeping its addresses), the mask
expansion and the masked sampler the reference's values and picks. The
engines serve a ~96-token char-level GPT (token i > 0 = chr(31 + i),
token 0 = "" and the eos, as the reference's tests/test_structured.py)
at a damped 2-block target with a 1-block draft holding its first block:
constrained and unconstrained requests, greedy and sampled, co-resident,
must emit the reference engine's tokens at k=1, at decode_k 2 and 4, with
n-gram speculation and with the draft, on f32, int8 and int4 pools, with
preemption and with an eos inside a draft window. On CPU the windows run
eagerly; chip_smoke.py phase 5g holds their CUDA graphs against the eager
windows on the card.
"""
import json
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import inference as jinference
from paddle_tpu.inference import llm_engine as jeng
from paddle_tpu.inference import structured as jst
from paddle_tpu.text.models import GPTForCausalLM as JaxGPT
from paddle_tpu.text.models import gpt as jgpt
from paddle_tpu.text.models.gpt import GPTConfig as JaxConfig
from paddle_tpu_torch.convert import export_state_dict
from paddle_tpu_torch.core import prng
from paddle_tpu_torch.inference import llm_engine as teng
from paddle_tpu_torch.inference import speculative as tspec
from paddle_tpu_torch.inference import structured as tst
from paddle_tpu_torch.profile_serve import spec_draft_pair
from paddle_tpu_torch.text.models import gpt as tgpt
from paddle_tpu_torch.text.models.gpt import GPTConfig

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


# token i>0 = chr(31+i); token 0 = the eos token (empty string)
TOKS = [""] + [chr(c) for c in range(32, 127)]
PAT = r'\{"a":[0-9]{1,3}\}'
SCHEMA = {"type": "object", "properties": {"s": {"type": "string"},
                                           "n": {"type": "integer"}}}
ENGINE = dict(num_slots=4, page_size=16, token_budget=8, max_model_len=128,
              token_strs=TOKS)
SAMPLED = dict(temperature=0.8, top_p=0.9)
# constrained greedy / sampled, unconstrained greedy / sampled, a schema
REQUESTS = (dict(grammar=PAT), dict(grammar=PAT, **SAMPLED), {}, SAMPLED,
            dict(json_schema=SCHEMA))
MAX_NEW = 24
STATS = ("steps", "tokens_in", "generated", "finished", "preemptions",
         "structured_requests")


@pytest.fixture(autouse=True)
def _serial_mesh():
    from paddle_tpu.distributed import mesh as mesh_mod

    mesh_mod.reset_mesh()
    yield


def _to_reference(model, cfg):
    jm = JaxGPT(JaxConfig(**cfg))
    jm.set_state_dict({k: paddle.to_tensor(v)
                       for k, v in export_state_dict(model).items()})
    jm.eval()
    return jm


@pytest.fixture(scope="module")
def models():
    """(target, draft) in the port from a seed (`spec_draft_pair`: the
    draft is the target's first block, so proposals are accepted), and the
    same weights in the reference."""
    from paddle_tpu.distributed import mesh as mesh_mod

    mesh_mod.reset_mesh()
    cfg = dict(vocab_size=len(TOKS), hidden_size=64, num_layers=2,
               num_heads=4, max_seq_len=128)
    tm, td = spec_draft_pair(GPTConfig(**cfg), damp=0.05, dtype="float32",
                             seed=30, device="cpu")
    return ((_to_reference(tm, cfg),
             _to_reference(td, dict(cfg, num_layers=1))), (tm, td))


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(1, len(TOKS), (n,)) for n in (6, 9, 12, 7, 10)]


def _drain(eng, cap=900):
    steps = 0
    while eng.has_work():
        eng.step()
        eng.pool.assert_consistent()
        steps += 1
        assert steps < cap, "engine failed to drain"


def _serve(mod, model, prompts, requests=REQUESTS, max_new=MAX_NEW, **cfg):
    eng = mod.LLMEngine(model, mod.LLMEngineConfig(**dict(ENGINE, **cfg)))
    reqs = [eng.add_request(p, max_new_tokens=max_new, eos_token_id=0, **kw)
            for p, kw in zip(prompts, requests)]
    _drain(eng)
    return [r.future.result(timeout=0) for r in reqs], eng, reqs


def _text(req):
    out = req.future.result(timeout=0)[req.prompt_len:]
    return "".join(TOKS[t] for t in out)


def _check_valid(req):
    """The request's DFA replay meets no disallowed token, its host state
    equals that replay, and an output that ended at eos fullmatches."""
    g = req.grammar
    gen = [int(t) for t in req.future.result(timeout=0)[req.prompt_len:]]
    state = 0
    for t in gen:
        assert g.allowed_np(state)[t], (g.pattern, gen)
        if t == g.eos_id:
            break
        state = g.advance(state, t)
    assert req.gstate == g.replay(gen) == state
    if gen and gen[-1] == g.eos_id:
        text = "".join(TOKS[t] for t in gen[:-1])
        assert re.fullmatch(g.pattern, text), text


def _both(models, prompts, path, kv_dtype, requests=REQUESTS,
          max_new=MAX_NEW, **extra):
    (jm, jd), (tm, td) = models
    cfg = dict(PATHS[path], kv_dtype=kv_dtype, **extra)
    outs = []
    for mod, model, draft in ((jeng, jm, jd), (teng, tm, td)):
        c = dict(cfg)
        if c.pop("draft", False):
            c.update(draft_model=draft, spec_k=4)
        outs.append(_serve(mod, model, prompts, requests, max_new, **c))
    (jo, je, _), (to, te, tr) = outs
    for i, (a, b) in enumerate(zip(jo, to)):
        np.testing.assert_array_equal(b, a, err_msg=f"request {i}")
    for key in STATS + tuple(k for k in je.stats if "spec_" in k
                             or "ngram_" in k):
        assert te.stats[key] == je.stats[key], key
    for r in tr:
        if r.grammar is not None:
            _check_valid(r)
    assert te.pool.num_live == 0
    return te, tr


# ---- host compilers ----

MULTI = TOKS + ["ab", "{\"", "\":", "12", "a}", "\"a", "}]", "[{", "0,"]

PATTERNS = [r"abc", r"a|bc", r"[0-9]+", r"[a-f]{2,4}", r"(ab)*c",
            r"\d\d:\d\d", r'"[^"]*"', r"x?y+", r"a.c", r"\{\}", PAT,
            r'\[(\{"k":[0-9]\},){2,3}\]', r"[^a-z]{0,2}\w\s\S", r"(?:a|b)+",
            r"[0-9]{1,3}", r"\.\*x{3,}"]


@pytest.mark.parametrize("vocab", ["chars", "multi"])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_compile_regex_tables_byte_equal(pattern, vocab):
    """trans / accept / hash byte-equal to the reference's, over the
    reference tests' patterns, on the char vocabulary and on one with
    multi-character tokens crossing the grammars' scaffolding."""
    toks = TOKS if vocab == "chars" else MULTI
    for eos in (0, None):
        want = jst.compile_regex(pattern, toks, eos_id=eos)
        got = tst.compile_regex(pattern, toks, eos_id=eos)
        assert got.trans.dtype == np.int32 and got.accept.dtype == bool
        assert got.trans.tobytes() == want.trans.tobytes()
        assert got.accept.tobytes() == want.accept.tobytes()
        assert (got.hash, got.eos_id, got.n_states, got.vocab) == (
            want.hash, want.eos_id, want.n_states, want.vocab)
        state = got.replay([1, 2, 3])
        assert state == want.replay([1, 2, 3])
        assert got.is_complete(state) == want.is_complete(state)
        np.testing.assert_array_equal(got.allowed_np(state),
                                      want.allowed_np(state))


@pytest.mark.parametrize("pattern,kw", [
    (r"(ab", {}), (r"^abc$", {}), (r"[0-9]{40,60}", dict(max_states=16)),
    ("", {}), (r"a{2,1}", {}), (r"a{x}", {}), (r"*a", {}), (r"[ab", {}),
    (r"a)", {}), ("\\", {}), ("\u00e9x", {}), (r"a{3", {}),
    (r"ab", dict(eos_id=500))])
def test_compile_regex_loud_rejects_match_reference(pattern, kw):
    kw = dict(dict(eos_id=0), **kw)
    with pytest.raises(jst.GrammarError) as want:
        jst.compile_regex(pattern, TOKS, **kw)
    with pytest.raises(tst.GrammarError) as got:
        tst.compile_regex(pattern, TOKS, **kw)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, ValueError)


@pytest.mark.parametrize("schema", [
    SCHEMA,
    {"type": "object", "properties": {
        "name": {"type": "string"}, "age": {"type": "integer"},
        "score": {"type": "number"}, "ok": {"type": "boolean"},
        "none": {"type": "null"},
        "tags": {"type": "array", "items": {"type": "integer"},
                 "maxItems": 2}}},
    {"type": "string", "enum": ["a", "b"]},
    {"enum": [1, "x", None, True]},
    {"type": "string", "pattern": "[a-z]+"},
    {"type": "array", "items": {"type": "boolean"}, "minItems": 2,
     "maxItems": 4},
    {"type": "array", "items": {"type": "number"}, "minItems": 1},
    {"type": "array", "items": {"type": "null"}, "maxItems": 0},
    {"properties": {"a\"b": {"type": "integer"}}},
    {"type": "object", "properties": {"child": {"type": "blob"}}},
    {"type": "object"}, {"type": "array"}, {"enum": []}, {"enum": [[1]]},
    {"type": "array", "items": {"type": "null"}, "maxItems": 65},
    {"type": "string", "pattern": ""}, "not a dict"])
def test_schema_to_regex_strings_equal(schema):
    try:
        want = jst.schema_to_regex(schema)
    except jst.GrammarError as e:
        with pytest.raises(tst.GrammarError) as got:
            tst.schema_to_regex(schema)
        assert str(got.value) == str(e)
        return
    assert tst.schema_to_regex(schema) == want


def test_validate_constraints_matches_reference():
    cg = tst.compile_regex("a+", TOKS, eos_id=0)
    for kw in (dict(grammar="a", json_schema={"type": "null"}),
               dict(grammar=12), dict(grammar=""), dict(json_schema="x"),
               dict(spec_mode="turbo")):
        with pytest.raises(ValueError) as want:
            jst.validate_constraints(**kw)
        with pytest.raises(ValueError) as got:
            tst.validate_constraints(**kw)
        assert str(got.value) == str(want.value)
    for kw in (dict(grammar="a+"), dict(grammar=cg), dict(spec_mode="off"),
               dict(json_schema={"type": "null"}), {}):
        tst.validate_constraints(**kw)
    assert tst.SPEC_MODES == jst.SPEC_MODES


# ---- the arena ----

def test_arena_tables_byte_equal_through_load_and_compaction():
    """Load, load, then a load that compacts away the unreferenced
    grammar: the host tables byte-equal to the reference arena's after
    each, the bases equal, and the device pair keeps its addresses while
    taking each change (int32 words, the same bits)."""
    pats = (r"[0-9]{2}", r"[a-z ]{1,9}!", r"[0-9]{10,12}")
    jg = [jst.compile_regex(p, MULTI, eos_id=0) for p in pats]
    tg = [tst.compile_regex(p, MULTI, eos_id=0) for p in pats]
    ja = jst.GrammarArena(len(MULTI), 24)
    ta = tst.GrammarArena(len(MULTI), 24, device="cpu")
    trans, mask = ta.device_tables()
    ptrs = (trans.data_ptr(), mask.data_ptr())
    assert ta.refreshes == 1 and ta.device_tables()[0] is trans
    assert ta.refreshes == 1                   # nothing changed: no copy
    assert int(mask[0].eq(-1).all()) == 1      # identity row, bit 31 too
    for i, live in ((0, None), (1, None), (2, {tg[0].hash})):
        want = ja.load(jg[i], live=None if live is None else {jg[0].hash})
        assert ta.load(tg[i], live=live) == want
        for h in ja._loaded:
            assert ta.base_of(h) == ja.base_of(h)
        assert ta.trans.tobytes() == ja.trans.tobytes()
        assert ta.mask.dtype == np.uint32
        assert ta.mask.tobytes() == ja.mask.tobytes()
        assert ta.states_used == ja.states_used
        got = ta.device_tables()
        assert (got[0].data_ptr(), got[1].data_ptr()) == ptrs
        assert got[0].numpy().tobytes() == ja.trans.tobytes()
        assert got[1].numpy().tobytes() == ja.mask.tobytes()
        jt, jm = ja.device_tables()
        assert np.asarray(jt).tobytes() == got[0].numpy().tobytes()
        assert np.asarray(jm).tobytes() == got[1].numpy().tobytes()
    assert ta.refreshes == 4
    assert set(ta._loaded) == {tg[0].hash, tg[2].hash}
    with pytest.raises(tst.GrammarError, match="arena full") as got:
        ta.load(tst.compile_regex(r"[0-9]{20,30}", MULTI, eos_id=0),
                live={tg[0].hash, tg[2].hash})
    with pytest.raises(jst.GrammarError) as want:
        ja.load(jst.compile_regex(r"[0-9]{20,30}", MULTI, eos_id=0),
                live={jg[0].hash, jg[2].hash})
    assert str(got.value) == str(want.value)


def test_grammar_allowed_matches_reference_bit_31_included():
    rng = np.random.default_rng(3)
    for vocab in (96, 100, 128):
        W = (vocab + 31) // 32
        words = rng.integers(0, 2**32, (9, W), dtype=np.uint64).astype(
            np.uint32)
        words[0] = 0xFFFFFFFF
        words[1] = 0x80000000                  # bit 31 alone
        words[2] = 0x00000001
        states = np.array([0, 1, 2, 3, 8, 1, 0, 5], np.int32)
        want = np.asarray(jgpt.grammar_allowed(jnp.asarray(words),
                                               jnp.asarray(states), vocab))
        got = tgpt.grammar_allowed(torch.from_numpy(words.view(np.int32)),
                                   torch.from_numpy(states), vocab)
        assert got.dtype == torch.bool and tuple(got.shape) == (8, vocab)
        np.testing.assert_array_equal(got.numpy(), want)
        assert got[1, 31] and not got[1, :31].any()


def test_sample_tokens_allowed_matches_reference_on_50_seeded_batches():
    """The reference's `sample_tokens(allowed=)` (jitted) and the port's on
    [8, 2048] logits under random masks (one all-True row, one row with a
    single allowed token): mixed temperatures, top_p 0.1-1, random
    streams, positions and 64-bit seeds. Every pick equal, every pick
    allowed, and all-True rows pick as `allowed=None` does."""
    import jax

    fn = jax.jit(jgpt.sample_tokens)
    temps0 = np.array([0, 0.5, 0.8, 1.3, 1.0, 0.7, 2.0, 0.3], np.float32)
    tops0 = np.array([1.0, 0.9, 0.5, 0.95, 0.1, 1.0, 0.7, 0.99], np.float32)
    for seed in range(50):
        rng = np.random.default_rng(seed)
        logits = (rng.standard_normal((8, 2048))
                  * rng.uniform(0.5, 4)).astype(np.float32)
        allowed = rng.random((8, 2048)) < rng.uniform(0.01, 0.9)
        allowed[0] = True
        allowed[1] = False
        allowed[1, rng.integers(0, 2048)] = True
        temps = temps0[rng.permutation(8)]
        tops = tops0[rng.permutation(8)]
        streams = rng.integers(0, 1000, (8,)).astype(np.int32)
        pos = rng.integers(0, 2**31 - 1, (8,)).astype(np.int32)
        ks = int(rng.integers(0, 2**40))
        args = (logits, temps, tops, streams, pos)
        want = np.asarray(fn(*(jnp.asarray(x) for x in args),
                             jax.random.PRNGKey(ks),
                             allowed=jnp.asarray(allowed)))
        t_args = [torch.from_numpy(x) for x in args]
        got = tgpt.sample_tokens(*t_args, prng.prng_key(ks),
                                 allowed=torch.from_numpy(allowed))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(seed))
        assert allowed[np.arange(8), got.numpy()].all()
        free = tgpt.sample_tokens(*t_args, prng.prng_key(ks))
        assert int(free[0]) == int(got[0])
        greedy = tgpt.sample_tokens(torch.from_numpy(logits),
                                    allowed=torch.from_numpy(allowed))
        np.testing.assert_array_equal(
            greedy.numpy(), np.where(allowed, logits, -1e30).argmax(-1))


# ---- the engines ----

PATHS = {"k1": dict(decode_k=1), "k2": dict(decode_k=2),
         "k4": dict(decode_k=4), "ngram": dict(spec_mode="ngram", spec_k=4),
         "draft": dict(draft=True)}


@pytest.mark.parametrize("path,kv_dtype", [
    ("k1", "float32"), ("k2", "float32"), ("k4", "float32"),
    ("ngram", "float32"), ("draft", "float32"), ("k1", "int8"),
    ("k4", "int8"), ("ngram", "int8"), ("draft", "int4"), ("k4", "int4"),
    ("ngram", "int4")])
def test_engine_tokens_equal_reference(models, prompts, path, kv_dtype):
    """Two constrained rows (greedy and sampled), two unconstrained ones
    and a json_schema row, co-resident in one engine (5 requests, 4
    slots): tokens and counts equal to the reference engine's; every
    constrained output valid, its host state the replay of its tokens."""
    te, tr = _both(models, prompts, path, kv_dtype)
    assert te.stats["structured_requests"] == 3
    assert _text(tr[0]).endswith("}")          # reached eos: complete
    if path == "ngram":
        assert te.stats["ngram_accepted"] > 0
    if path == "draft":
        assert te.stats["spec_accepted"] > 0


@pytest.mark.parametrize("path", ["k1", "k4", "ngram", "draft"])
def test_coresident_unconstrained_rows_equal_plain_engine(models, prompts,
                                                          path):
    """The unconstrained rows beside constrained ones emit what an engine
    with no token_strs emits for them alone (the mask-identity row)."""
    (_, _), (tm, td) = models
    extra = dict(PATHS[path])
    if extra.pop("draft", False):
        extra.update(draft_model=td, spec_k=4)
    mixed, _, _ = _serve(teng, tm, prompts, **extra)
    # the same sampling streams: requests 0-1 unconstrained here
    plain, _, _ = _serve(teng, tm, prompts[:4], ({}, {}) + REQUESTS[2:4],
                         token_strs=None, **extra)
    for a, b in zip(mixed[2:4], plain[2:4]):
        np.testing.assert_array_equal(a, b)


def test_unconstrained_windows_run_no_mask(models, prompts, monkeypatch):
    """With no constrained row resident the windows and ticks expand no
    mask (the unstructured graph); with one they do, in every window."""
    (_, _), (tm, _) = models
    calls = []
    real = tgpt.grammar_allowed

    def counted(*a):
        calls.append(a[1].shape[0])
        return real(*a)

    monkeypatch.setattr(tgpt, "grammar_allowed", counted)
    for extra in (dict(decode_k=4), dict(spec_mode="ngram", spec_k=4)):
        _serve(teng, tm, prompts[2:4], REQUESTS[2:4], **extra)
        assert calls == []
    _, eng, _ = _serve(teng, tm, prompts[:1], REQUESTS[:1], decode_k=4)
    assert len(calls) == 4 * eng.stats["fused_steps"] > 0


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_constrained_preemption_state_is_replay(models, kv_dtype):
    """`[0-9]{25,}` never accepts within max_new, so rows run full length
    through a pool tight enough to preempt: tokens equal the reference's
    under the same pressure, and each request's DFA state equals the
    replay of its emitted tokens (never reset by a preemption)."""
    rng = np.random.default_rng(7)
    ps = [rng.integers(1, len(TOKS), (20,)) for _ in range(4)]
    req = dict(grammar=r"[0-9]{25,}", **SAMPLED)
    te, tr = _both(models, ps, "k2", kv_dtype, (req,) * 4, max_new=20,
                   max_model_len=48, num_pages=6)
    assert te.stats["preemptions"] > 0, "pool was not tight enough"
    for r in tr:
        assert _text(r).isdigit() and len(_text(r)) == 20


def test_eos_inside_a_draft_window(models, monkeypatch):
    """The eos is "w", a token the draft proposes (the propose window is
    unmasked), so a propose window emits -1 after it, gathered as token 0
    into the verify, whose state chain runs through those drafts: tokens,
    counts and states equal the reference's, and such a window ran."""
    rng = np.random.default_rng(11)
    ps = [rng.integers(1, len(TOKS), (n,)) for n in (5, 8, 11, 6)]
    eos = TOKS.index("w")
    windows = []
    real = tspec._ProposeStep.drafts

    def drafts(self, emits):
        views = self.host_views()
        rem, fin = views[2], views[3]
        e = emits.numpy()
        windows.append(any(
            (e[:rem[s], s] == -1).any() for s in range(self.S) if not fin[s]))
        return real(self, emits)

    monkeypatch.setattr(tspec._ProposeStep, "drafts", drafts)
    (jm, jd), (tm, td) = models
    outs = []
    for mod, model, draft in ((jeng, jm, jd), (teng, tm, td)):
        eng = mod.LLMEngine(model, mod.LLMEngineConfig(
            **dict(ENGINE, draft_model=draft, spec_k=4)))
        reqs = [eng.add_request(p, max_new_tokens=MAX_NEW, eos_token_id=eos,
                                grammar=r"[0-9a-z]{3,20}", **kw)
                for p, kw in zip(ps, ({}, SAMPLED, {}, SAMPLED))]
        _drain(eng)
        outs.append((eng, reqs))
    (je, jr), (te, tr) = outs
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(b.future.result(timeout=0),
                                      a.future.result(timeout=0))
        assert b.gstate == a.gstate
        _check_valid(b)
    for key in STATS + ("spec_windows", "spec_proposed", "spec_accepted"):
        assert te.stats[key] == je.stats[key], key
    assert any(windows), "no propose window picked the eos"


def test_json_schema_end_to_end(models, prompts):
    (_, _), (tm, _) = models
    _, eng, reqs = _serve(teng, tm, prompts[:1],
                          (dict(json_schema=SCHEMA, **SAMPLED),),
                          max_new=80, decode_k=4)
    _check_valid(reqs[0])
    assert reqs[0].future.result(timeout=0)[-1] == 0   # ended at eos
    obj = json.loads(_text(reqs[0]))
    assert set(obj) == {"s", "n"}
    assert isinstance(obj["s"], str) and isinstance(obj["n"], int)


def test_validation_names_the_kwarg_at_add_request_and_submit(models,
                                                              prompts):
    (_, _), (tm, _) = models
    p = prompts[0]
    eng = teng.LLMEngine(tm, teng.LLMEngineConfig(**ENGINE))
    with pytest.raises(ValueError, match="not both"):
        eng.add_request(p, grammar="a+", json_schema={"type": "null"},
                        eos_token_id=0)
    with pytest.raises(ValueError, match="CompiledGrammar"):
        eng.add_request(p, grammar=12, eos_token_id=0)
    with pytest.raises(tst.GrammarError, match="eos_token_id"):
        eng.add_request(p, grammar="a+")
    with pytest.raises(tst.GrammarError, match=r"json_schema: .*\$\.x"):
        eng.add_request(p, json_schema={"properties": {"x": {}}},
                        eos_token_id=0)
    other = tst.compile_regex("[0-9]+", TOKS[:50], eos_id=0)
    with pytest.raises(tst.GrammarError, match="vocab"):
        eng.add_request(p, grammar=other, eos_token_id=0)
    bare = teng.LLMEngine(tm, teng.LLMEngineConfig(
        num_slots=2, page_size=16, max_model_len=64))
    with pytest.raises(ValueError, match="token_strs"):
        bare.add_request(p, grammar="a+", eos_token_id=0)
    tight = teng.LLMEngine(tm, teng.LLMEngineConfig(
        **dict(ENGINE, grammar_states=8)))
    with pytest.raises(tst.GrammarError, match="state budget"):
        tight.add_request(p, grammar=r"[0-9]{30,40}", eos_token_id=0)
    assert tight._structured_metrics()["rejects"] == 1
    assert not eng.has_work() and not tight.has_work()
    with teng.LLMServer(tm, teng.LLMEngineConfig(**ENGINE)) as server:
        with pytest.raises(TypeError, match="grammer"):
            server.submit(p, max_new_tokens=4, grammer="a+")
        with pytest.raises(ValueError, match="spec_mode"):
            server.submit(p, max_new_tokens=4, spec_mode="warp")
        with pytest.raises(tst.GrammarError, match="unterminated"):
            server.submit(p, max_new_tokens=4, eos_token_id=0,
                          grammar="(ab")
        with pytest.raises(ValueError, match="json_schema"):
            server.submit(p, max_new_tokens=4, json_schema="{}")
        f = server.submit(p, max_new_tokens=6, eos_token_id=0,
                          grammar=r"[0-9]{1,4}")
        out = f.result(timeout=120)[len(p):]
        assert re.fullmatch(r"[0-9]{1,4}",
                            "".join(TOKS[t] for t in out if t != 0))
        assert server.stats["requests"] == 1


def test_config_knobs_and_structured_metrics_match_reference(models,
                                                             prompts):
    """token_strs / grammar_states checks as the reference's; the
    structured metrics block equal to the reference's `metrics()` after
    compiles, a cache hit, a reject and a compaction."""
    (jm, _), (tm, _) = models
    for mod in (jeng, teng):
        with pytest.raises(ValueError, match="grammar_states must be >= 2"):
            mod.LLMEngineConfig(token_strs=TOKS, grammar_states=1)
        with pytest.raises(ValueError, match="one surface string"):
            mod.LLMEngine(jm if mod is jeng else tm,
                          mod.LLMEngineConfig(token_strs=TOKS[:-1]))
    assert teng.LLMEngineConfig().grammar_states == 128
    metrics = []
    for mod, model in ((jeng, jm), (teng, tm)):
        eng = mod.LLMEngine(model, mod.LLMEngineConfig(
            **dict(ENGINE, grammar_states=24)))
        assert (eng.grammar_arena.n_states, eng.grammar_arena.vocab) == (
            24, len(TOKS))
        for pat in (r"[0-9]{2}", r"[0-9]{2}", r"[a-z]{1,9}!"):
            eng.add_request(prompts[0], max_new_tokens=4, eos_token_id=0,
                            grammar=pat)
        _drain(eng)
        with pytest.raises(ValueError):
            eng.add_request(prompts[0], eos_token_id=0,
                            grammar=r"[0-9]{30,40}")
        eng.add_request(prompts[1], max_new_tokens=4, eos_token_id=0,
                        grammar=r"[0-9]{10,15}")    # compacts the others
        _drain(eng)
        metrics.append(eng._structured_metrics())
    assert metrics[1] == metrics[0]
    assert teng.LLMEngine(tm, teng.LLMEngineConfig(
        num_slots=2, max_model_len=64))._structured_metrics() is None


def test_llm_server_constrained_matches_reference(models, prompts):
    """`LLMServer.submit(grammar= | json_schema=)` serves the reference
    engine's tokens."""
    (jm, _), (tm, _) = models
    reqs = REQUESTS[:2] + REQUESTS[4:]
    with jinference.LLMServer(jm, jeng.LLMEngineConfig(
            **dict(ENGINE, decode_k=2))) as js:
        futs = [js.submit(p, max_new_tokens=MAX_NEW, eos_token_id=0, **kw)
                for p, kw in zip(prompts, reqs)]
        want = [f.result(timeout=300) for f in futs]
    with teng.LLMServer(tm, teng.LLMEngineConfig(
            **dict(ENGINE, decode_k=2))) as ts:
        futs = [ts.submit(p, max_new_tokens=MAX_NEW, eos_token_id=0, **kw)
                for p, kw in zip(prompts, reqs)]
        got = [f.result(timeout=300) for f in futs]
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
