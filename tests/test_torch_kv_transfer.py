"""The KV-page wire: the PyTorch port against the JAX package on CPU.

A prefill_only payload exported by one package, packed by it, unpacked by
the other and imported into the other's engine decodes to the tokens of
the exporting package's own decode replica — both directions, on
float32, bfloat16, int8 and int4 pools, with a mid-page and a
page-aligned frontier. Frames cross both ways with byte-equal arrays (a
bf16 pool as the port's uint16 words, the reference's ml_dtypes array).
The port's `_check_import` raises the reference's messages. Plus the
single-token prompt, a preempted import replaying deterministically,
the prefill tier publishing its prefix blocks, `export_prefix`, the
in-place pool write, and the cross-process stream raising without a
multi-process runtime.
Mirrors the KV-wire cases of tests/test_fleet_router.py.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import llm_engine as jeng
from paddle_tpu.inference.fleet_serving import kv_transfer as jkv
from paddle_tpu.text.models import GPTForCausalLM as JaxGPT
from paddle_tpu.text.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.convert import export_state_dict
from paddle_tpu_torch.inference import llm_engine as teng
from paddle_tpu_torch.inference.fleet_serving import kv_transfer as tkv
from paddle_tpu_torch.inference.fleet_serving import replica as trep
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
KV_DTYPES = ["float32", "bfloat16", "int8", "int4"]


@pytest.fixture(autouse=True)
def _serial_mesh():
    from paddle_tpu.distributed import mesh as mesh_mod

    mesh_mod.reset_mesh()
    yield


@pytest.fixture(scope="module")
def pair():
    from paddle_tpu.distributed import mesh as mesh_mod

    mesh_mod.reset_mesh()
    tm = GPTForCausalLM(gpt_tiny(), device="cpu", seed=47)
    jm = JaxGPT(jax_gpt_tiny())
    jm.set_state_dict({k: paddle.to_tensor(v)
                       for k, v in export_state_dict(tm).items()})
    jm.eval()
    return jm, tm


def _cfg(mod, **kw):
    base = dict(num_slots=4, page_size=16, token_budget=32,
                max_model_len=96)
    base.update(kw)
    return mod.LLMEngineConfig(**base)


def _drain(eng, cap=800):
    steps = 0
    while eng.has_work():
        eng.step()
        eng.pool.assert_consistent()
        steps += 1
        assert steps < cap, "engine failed to drain"


def _prefill(mod, model, prompt, **kw):
    eng = mod.LLMEngine(model, _cfg(mod, **kw))
    req = eng.add_request(prompt, prefill_only=True)
    _drain(eng)
    assert eng.stats["generated"] == 0 and eng.pool.num_live == 0
    return req.future.result(timeout=0)


def _decode(mod, model, payload, max_new=8, **kw):
    eng = mod.LLMEngine(model, _cfg(mod, **kw))
    req = eng.import_kv_pages(payload, max_new_tokens=max_new)
    _drain(eng)
    assert eng.stats.get("kv_pages_imported", 0) == payload.num_pages
    return req.future.result(timeout=0)


def _bytes(a):
    return np.ascontiguousarray(a).tobytes()


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, VOCAB, (n,)).astype(
        np.int32)


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@pytest.mark.parametrize("plen", [23, 33])
def test_reference_payload_imports_into_port(pair, kv_dtype, plen):
    """Reference prefill -> reference pack -> port unpack -> port
    import: the port decodes the reference decode replica's tokens, and
    its pools hold the payload's bytes (a re-export returns them)."""
    jm, tm = pair
    prompt = _prompt(plen, plen)
    jpl = _prefill(jeng, jm, prompt, kv_dtype=kv_dtype)
    assert jpl.n_prefilled == plen - 1
    assert jpl.num_pages == -(-(plen - 1) // 16)
    ref = _decode(jeng, jm, jpl, kv_dtype=kv_dtype)
    tpl = tkv.unpack_kv_payload(jkv.pack_kv_payload(jpl))
    assert tpl.kv_dtype == kv_dtype and tpl.trace == jpl.trace
    got = _decode(teng, tm, tpl, kv_dtype=kv_dtype)
    np.testing.assert_array_equal(got, ref)
    dec = teng.LLMEngine(tm, _cfg(teng, kv_dtype=kv_dtype))
    req = dec.import_kv_pages(tpl, max_new_tokens=4)
    dec._admit()
    out = dec.export_kv_pages(req)
    for a, b in zip(jpl.kv + jpl.scales, out.kv + out.scales):
        assert _bytes(a) == _bytes(b)
    _drain(dec)


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@pytest.mark.parametrize("plen", [23, 33])
def test_port_payload_imports_into_reference(pair, kv_dtype, plen):
    """Port prefill -> port pack -> reference unpack -> reference
    import: the reference decodes the port decode replica's tokens."""
    jm, tm = pair
    prompt = _prompt(plen + 100, plen)
    tpl = _prefill(teng, tm, prompt, kv_dtype=kv_dtype)
    assert tpl.n_prefilled == plen - 1
    ref = _decode(teng, tm, tpl, kv_dtype=kv_dtype)
    jpl = jkv.unpack_kv_payload(tkv.pack_kv_payload(tpl))
    got = _decode(jeng, jm, jpl, kv_dtype=kv_dtype)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_frames_cross_both_ways_byte_equal(pair, kv_dtype):
    jm, tm = pair
    prompt = _prompt(3, 23)
    for src, pack, unpack in (
            (_prefill(jeng, jm, prompt, kv_dtype=kv_dtype),
             jkv.pack_kv_payload, tkv.unpack_kv_payload),
            (_prefill(teng, tm, prompt, kv_dtype=kv_dtype),
             tkv.pack_kv_payload, jkv.unpack_kv_payload)):
        back = unpack(pack(src))
        assert (back.n_prefilled, back.page_size, back.kv_dtype) == (
            src.n_prefilled, src.page_size, src.kv_dtype)
        np.testing.assert_array_equal(back.tokens, src.tokens)
        assert len(back.kv) == len(src.kv)
        assert len(back.scales) == len(src.scales)
        for a, b in zip(src.kv + src.scales, back.kv + back.scales):
            assert a.shape == b.shape and _bytes(a) == _bytes(b)
        if kv_dtype == "bfloat16":
            # the port carries bf16 as uint16 words, the reference as
            # ml_dtypes.bfloat16: each side unpacks to its own
            want = (np.uint16 if unpack is tkv.unpack_kv_payload
                    else ml_dtypes.bfloat16)
            assert all(a.dtype == want for a in back.kv)
        if kv_dtype in ("int8", "int4"):
            assert back.scales and back.scales[0].dtype == np.float32
        else:
            assert back.scales == []


def test_port_frame_is_the_reference_frame(pair):
    """Packed from arrays of the same bytes, the two packages' frames
    are the same bytes except where numpy's header names the dtype of a
    bf16 array (uint16 words here, a 2-byte void type there)."""
    jm, tm = pair
    tpl = _prefill(teng, tm, _prompt(4, 20))
    jpl = jkv.unpack_kv_payload(tkv.pack_kv_payload(tpl))
    assert jkv.pack_kv_payload(jpl) == tkv.pack_kv_payload(tpl)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_disagg_prefill_decode_token_identity(pair, kv_dtype):
    """Prefill on engine A, hand the pages over, decode on engine B ==
    the single engine == the reference's single engine, across mixed
    prompt lengths (mid-page and page-aligned frontiers)."""
    jm, tm = pair
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, VOCAB, (L,)) for L in (7, 16, 17, 23, 33,
                                                      48)]
    single = teng.LLMEngine(tm, _cfg(teng, kv_dtype=kv_dtype))
    jsingle = jeng.LLMEngine(jm, _cfg(jeng, kv_dtype=kv_dtype))
    sr = [single.add_request(p, max_new_tokens=12) for p in prompts]
    jr = [jsingle.add_request(p, max_new_tokens=12) for p in prompts]
    _drain(single)
    _drain(jsingle)
    pre = teng.LLMEngine(tm, _cfg(teng, kv_dtype=kv_dtype))
    dec = teng.LLMEngine(tm, _cfg(teng, kv_dtype=kv_dtype))
    payloads = []
    for p in prompts:
        r = pre.add_request(p, prefill_only=True)
        _drain(pre)
        payloads.append(r.future.result(timeout=0))
    assert pre.stats["generated"] == 0 and pre.pool.num_live == 0
    assert pre.stats["prefill_exports"] == len(prompts)
    reqs = [dec.import_kv_pages(
        tkv.unpack_kv_payload(tkv.pack_kv_payload(pl)), max_new_tokens=12)
        for pl in payloads]
    _drain(dec)
    for a, b, r in zip(sr, jr, reqs):
        got = r.future.result(timeout=0)
        np.testing.assert_array_equal(got, a.future.result(timeout=0))
        np.testing.assert_array_equal(got, b.future.result(timeout=0))
    assert dec.stats["kv_pages_imported"] == sum(
        pl.num_pages for pl in payloads)
    assert pre.stats["kv_pages_exported"] == dec.stats["kv_pages_imported"]


def test_prefill_only_single_token_prompt(pair):
    """prompt_len 1: nothing before the frontier — the export is empty
    (resolved without a step) and the decode side prefills the lone
    token itself; the reference's empty payload imports too."""
    jm, tm = pair
    prompt = np.asarray([5], np.int32)
    ref = teng.LLMEngine(tm, _cfg(teng))
    rr = ref.add_request(prompt, max_new_tokens=6)
    _drain(ref)
    pre = teng.LLMEngine(tm, _cfg(teng))
    payload = pre.add_request(prompt, prefill_only=True).future.result(
        timeout=0)
    assert payload.n_prefilled == 0 and payload.num_pages == 0
    for pl in (payload, tkv.unpack_kv_payload(jkv.pack_kv_payload(
            jeng.LLMEngine(jm, _cfg(jeng)).add_request(
                prompt, prefill_only=True).future.result(timeout=0)))):
        np.testing.assert_array_equal(_decode(teng, tm, pl, 6),
                                      rr.future.result(timeout=0))


def _bad_payloads(payload):
    """Payloads that break one geometry rule each (the reference test's
    cases), as (label, payload)."""
    out = []
    b = tkv.unpack_kv_payload(tkv.pack_kv_payload(payload))
    b.n_prefilled = len(payload.tokens)
    out.append(("frontier", b))
    b = tkv.unpack_kv_payload(tkv.pack_kv_payload(payload))
    b.kv = b.kv[:-1]
    out.append(("pools", b))
    b = tkv.unpack_kv_payload(tkv.pack_kv_payload(payload))
    b.kv[1] = b.kv[1][:-1]
    out.append(("ragged", b))
    b = tkv.unpack_kv_payload(tkv.pack_kv_payload(payload))
    b.kv = [a[:-1] for a in b.kv]
    b.scales = [a[:-1] for a in b.scales]
    out.append(("page count", b))
    b = tkv.unpack_kv_payload(tkv.pack_kv_payload(payload))
    b.page_size = 8
    out.append(("page_size", b))
    return out


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_check_import_raises_the_reference_messages(pair, kv_dtype):
    """Every geometry mismatch raises at submit, with the reference's
    message word for word."""
    jm, tm = pair
    payload = _prefill(teng, tm, _prompt(1, 40), kv_dtype=kv_dtype)
    dec = teng.LLMEngine(tm, _cfg(teng, kv_dtype=kv_dtype))
    jdec = jeng.LLMEngine(jm, _cfg(jeng, kv_dtype=kv_dtype))
    cases = _bad_payloads(payload)
    if kv_dtype == "int8":
        b = tkv.unpack_kv_payload(tkv.pack_kv_payload(payload))
        b.scales[0] = b.scales[0][:, :8]
        cases.append(("scale plane", b))
        b = tkv.unpack_kv_payload(tkv.pack_kv_payload(payload))
        b.scales = b.scales[:-1]
        cases.append(("scale count", b))
    other = "int8" if kv_dtype == "float32" else "float32"
    cases.append(("kv_dtype", _prefill(teng, tm, _prompt(1, 40),
                                       kv_dtype=other)))
    for label, bad in cases:
        with pytest.raises(ValueError) as te:
            dec.import_kv_pages(bad, max_new_tokens=4)
        jbad = jkv.unpack_kv_payload(tkv.pack_kv_payload(bad))
        jbad.page_size, jbad.n_prefilled = bad.page_size, bad.n_prefilled
        with pytest.raises(ValueError) as je:
            jdec.import_kv_pages(jbad, max_new_tokens=4)
        assert str(te.value) == str(je.value), label
    assert not dec.has_work() and dec.pool.num_live == 0


def test_import_geometry_validation(pair):
    jm, tm = pair
    prompt = _prompt(1, 20)
    payload = _prefill(teng, tm, prompt)
    with pytest.raises(ValueError, match="page_size"):
        teng.LLMEngine(tm, _cfg(teng, page_size=8)).import_kv_pages(
            payload, max_new_tokens=4)
    with pytest.raises(ValueError, match="kv_dtype"):
        teng.LLMEngine(tm, _cfg(teng, kv_dtype="int8")).import_kv_pages(
            payload, max_new_tokens=4)
    dec = teng.LLMEngine(tm, _cfg(teng))
    bad = tkv.unpack_kv_payload(tkv.pack_kv_payload(payload))
    bad.n_prefilled = len(prompt)
    with pytest.raises(ValueError, match="n_prefilled"):
        dec.import_kv_pages(bad, max_new_tokens=4)
    bad2 = tkv.unpack_kv_payload(tkv.pack_kv_payload(payload))
    bad2.kv = bad2.kv[:-1]
    with pytest.raises(ValueError, match="pools"):
        dec.import_kv_pages(bad2, max_new_tokens=4)
    bad3 = tkv.unpack_kv_payload(tkv.pack_kv_payload(payload))
    bad3.kv[1] = bad3.kv[1][:-1]
    with pytest.raises(ValueError, match="pool 1"):
        dec.import_kv_pages(bad3, max_new_tokens=4)
    qpl = _prefill(teng, tm, prompt, kv_dtype="int8")
    qbad = tkv.unpack_kv_payload(tkv.pack_kv_payload(qpl))
    qbad.scales[0] = qbad.scales[0][:, :8]
    with pytest.raises(ValueError, match="scale plane 0"):
        teng.LLMEngine(tm, _cfg(teng, kv_dtype="int8")).import_kv_pages(
            qbad, max_new_tokens=4)


def test_import_writes_the_pools_in_place(pair):
    """The captured windows hold the pools' addresses: an import writes
    into the existing tensors and never rebinds them."""
    jm, tm = pair
    payload = _prefill(teng, tm, _prompt(2, 40), kv_dtype="int8")
    dec = teng.LLMEngine(tm, _cfg(teng, kv_dtype="int8"))
    ptrs = [t.data_ptr() for t in dec._kv + dec._kv_scales]
    objs = [id(t) for t in dec._kv + dec._kv_scales]
    dec.import_kv_pages(payload, max_new_tokens=4)
    dec._admit()
    assert [t.data_ptr() for t in dec._kv + dec._kv_scales] == ptrs
    assert [id(t) for t in dec._kv + dec._kv_scales] == objs
    assert any(float(s.abs().sum()) > 0 for s in dec._kv_scales)
    _drain(dec)


def test_preempted_import_replays_deterministically(pair):
    """A preempted imported request lost its pages: the replay prefills
    the ordinary way and the greedy continuation is unchanged (the
    payload is consumed once)."""
    jm, tm = pair
    prompt = _prompt(4, 30)
    ref = teng.LLMEngine(tm, _cfg(teng))
    rr = ref.add_request(prompt, max_new_tokens=10)
    _drain(ref)
    dec = teng.LLMEngine(tm, _cfg(teng))
    r = dec.import_kv_pages(_prefill(teng, tm, prompt), max_new_tokens=10)
    dec.step()
    dec.step()
    assert r.slot is not None
    dec._preempt(r.slot, r, reason="pool")
    _drain(dec)
    np.testing.assert_array_equal(r.future.result(timeout=0),
                                  rr.future.result(timeout=0))
    assert r.preemptions == 1


def test_prefill_only_publishes_prefix_blocks(pair):
    jm, tm = pair
    rng = np.random.default_rng(5)
    sysp = rng.integers(0, VOCAB, (32,))
    a = np.concatenate([sysp, rng.integers(0, VOCAB, (8,))])
    b = np.concatenate([sysp, rng.integers(0, VOCAB, (9,))])
    pre = teng.LLMEngine(tm, _cfg(teng, prefix_cache=True))
    ra = pre.add_request(a, prefill_only=True)
    _drain(pre)
    rb = pre.add_request(b, prefill_only=True)
    _drain(pre)
    assert pre.prefix_cache.stats["hits"] >= 1
    assert rb.future.result(timeout=0).n_prefilled == len(b) - 1
    ra.future.result(timeout=0)
    # the hit-served payload still decodes to the single engine's tokens
    single = teng.LLMEngine(tm, _cfg(teng))
    sr = single.add_request(b, max_new_tokens=6)
    _drain(single)
    np.testing.assert_array_equal(
        _decode(teng, tm, rb.future.result(timeout=0), 6),
        sr.future.result(timeout=0))


def test_export_prefix_satisfies_the_import_contract(pair):
    """`export_prefix` cuts the trie's cached prefix into a payload that
    imports on another engine and decodes to the single engine's tokens,
    and gives back the match's page references."""
    jm, tm = pair
    rng = np.random.default_rng(9)
    sysp = rng.integers(0, VOCAB, (32,))
    donor = teng.LLMEngine(tm, _cfg(teng, prefix_cache=True))
    r = donor.add_request(np.concatenate([sysp, [1, 2, 3]]),
                          max_new_tokens=2)
    _drain(donor)
    r.future.result(timeout=0)
    live = donor.pool.num_live
    prompt = np.concatenate([sysp, [7, 8]])
    payload = donor.export_prefix(prompt)
    assert donor.pool.num_live == live
    assert payload.n_prefilled == 32 and payload.num_pages == 2
    assert donor.export_prefix(rng.integers(0, VOCAB, (40,))) is None
    full = donor.export_prefix(sysp)   # fully cached: one block less
    assert full.n_prefilled == 16 and full.num_pages == 1
    single = teng.LLMEngine(tm, _cfg(teng))
    sr = single.add_request(prompt, max_new_tokens=6)
    _drain(single)
    np.testing.assert_array_equal(_decode(teng, tm, payload, 6),
                                  sr.future.result(timeout=0))
    assert teng.LLMEngine(tm, _cfg(teng)).export_prefix(prompt) is None


def test_trace_rides_the_payload(pair):
    """The payload carries the prefill side's trace (the reference's
    wire dict); the importing engine continues that trace."""
    jm, tm = pair
    payload = _prefill(teng, tm, _prompt(6, 20))
    assert set(payload.trace) == {"trace_id", "parent_id", "quiet",
                                  "phases"}
    for phase in ("queued", "prefill_start", "prefill_end", "kv_export"):
        assert phase in payload.trace["phases"]
    dec = teng.LLMEngine(tm, _cfg(teng))
    req = dec.import_kv_pages(
        tkv.unpack_kv_payload(tkv.pack_kv_payload(payload)),
        max_new_tokens=3)
    _drain(dec)
    assert req.trace.trace_id == payload.trace["trace_id"]
    assert {"kv_import", "first_token"} <= set(req.trace.phases)


def test_cross_process_stream_needs_the_multiprocess_runtime(pair,
                                                            monkeypatch):
    """Without an initialized process group the four stream calls raise
    the reference's RuntimeError (its `_kv_client` message), binding
    nothing, while run_with_fault_tolerance, which needs no transport,
    runs. The stream itself runs between two launched processes in
    tests/test_torch_disagg.py."""
    from concurrent.futures import Future
    from types import SimpleNamespace

    from paddle_tpu_torch.distributed import xproc as txp
    from paddle_tpu_torch.distributed.fleet import elastic as tel

    jm, tm = pair
    payload = _prefill(teng, tm, _prompt(5, 20))
    done = Future()
    done.set_result(payload)
    replica = SimpleNamespace(submit_prefill=lambda prompt, **kw: done)
    monkeypatch.setattr(txp, "_transport", None)
    for call in (lambda: tkv.send_kv_payload(payload, 1),
                 lambda: tkv.recv_kv_payload(0, timeout_ms=10),
                 lambda: trep.stream_prefill(replica, [1], 1),
                 lambda: trep.recv_and_decode(replica, 0, timeout_ms=10)):
        with pytest.raises(RuntimeError, match="^p2p send/recv needs the "
                           "multi-process runtime: start workers via "):
            call()
    assert txp._transport is None
    # the supervision loop needs no transport: a one-process run over a
    # checkpointer that has nothing to restore starts at step 0
    ck = SimpleNamespace(load_latest=lambda: None, wait=lambda: None)
    assert tel.run_with_fault_tolerance(lambda start: ("ran", start),
                                        ck) == ("ran", 0)


def test_gather_is_one_copy_of_exact_pages(pair):
    """The export gathers exactly the request's pages (no fixed-width
    padding: eager torch does not recompile per page count)."""
    jm, tm = pair
    eng = teng.LLMEngine(tm, _cfg(teng, kv_dtype="bfloat16"))
    req = eng.add_request(_prompt(8, 50), prefill_only=True)
    _drain(eng)
    payload = req.future.result(timeout=0)
    assert payload.num_pages == 4
    assert all(a.shape[0] == 4 and a.dtype == np.uint16
               for a in payload.kv)
    assert payload.nbytes() == sum(a.nbytes for a in payload.kv)
    assert eng.kv_dtype == "bfloat16"
    assert eng._kv[0].dtype == torch.bfloat16
