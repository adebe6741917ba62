"""Quantized runtime, KV half: the PyTorch port against the JAX package's
quantization/runtime.py on CPU.

The int8 / packed-int4 codecs must be BYTE-identical to the reference on
the same rows (f32 and bf16 inputs, ties at .5, all-zero rows), and so
must the kv dtype resolution, the page-size arithmetic and the engine's
pool layout. The quantized engine's greedy tokens are held to the
reference engine's in tests/test_torch_llm_engine.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference import llm_engine as jeng
from paddle_tpu.quantization import runtime as jrt
from paddle_tpu.text.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.text.models.gpt import _paged_cache_write_quant as jwrite
from paddle_tpu_torch.inference import llm_engine as teng
from paddle_tpu_torch.quantization import runtime as trt
from paddle_tpu_torch.text.models.gpt import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.text.models.gpt import _paged_cache_write_quant as twrite

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True)
def _serial_mesh():
    from paddle_tpu.distributed import mesh as mesh_mod

    mesh_mod.reset_mesh()
    yield


# absmax 127 (head 0) and 7 (head 1): scale exactly 1 for int8 / int4,
# so every k + .5 below is a tie that must round to even
_TIES = np.zeros((3, 16), np.float32)
_TIES[0] = [-126.5, -125.5, -2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5, 64.5,
            65.5, 100.5, 101.5, 125.5, 126.5, 127.0]
_TIES[1] = [-7, -6.5, -5.5, -4.5, -3.5, -2.5, -1.5, -0.5, 0.5, 1.5, 2.5,
            3.5, 4.5, 5.5, 6.5, 7]


def _rows(seed, dtype):
    """[T, H, D] rows with the codec's edge cases: an all-zero row, rows
    whose scaled values land exactly on .5 for both qmax, a row with one
    huge element, tiny values near the 1e-8 floor."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((40, 3, 16)) * 2.5).astype(np.float32)
    x[0] = 0.0
    x[1] = _TIES
    x[2, 0, 3] = 1e4
    x[3] = 1e-9
    if dtype == "bfloat16":
        return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_kv_rows_byte_identical(bits, dtype):
    jx, tx = _rows(bits, dtype)
    jf, tf = ((jrt.quantize_kv_rows, trt.quantize_kv_rows) if bits == 8
              else (jrt.quantize_kv_rows_int4, trt.quantize_kv_rows_int4))
    jq, js = jf(jx)
    tq, ts = tf(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tq.numpy().tobytes() == np.asarray(jq).tobytes()
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    # the .5 ties went to even (numpy's rounding) in both
    head = 0 if bits == 8 else 1
    codes = tq if bits == 8 else trt.unpack_int4(tq, axis=-1)
    assert np.array_equal(codes[1, head].numpy(), np.round(_TIES[head]))
    assert np.all(ts[0].numpy() > 0)      # all-zero row: the 1e-8 floor


@pytest.mark.parametrize("bits", [8, 4])
def test_dequantize_kv_matches_reference(bits):
    jx, tx = _rows(20 + bits, "float32")
    if bits == 8:
        jq, js = jrt.quantize_kv_rows(jx)
        ref = jrt.dequantize_kv(jq, js)
        got = trt.dequantize_kv(*trt.quantize_kv_rows(tx))
    else:
        jq, js = jrt.quantize_kv_rows_int4(jx)
        ref = jrt.dequantize_kv_int4(jq, js)
        got = trt.dequantize_kv_int4(*trt.quantize_kv_rows_int4(tx))
    assert got.numpy().tobytes() == np.asarray(ref).tobytes()


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_pack_unpack_int4_byte_identical(axis):
    rng = np.random.default_rng(3)
    codes = rng.integers(-8, 8, (4, 6, 10)).astype(np.int8)
    packed = trt.pack_int4(torch.from_numpy(codes), axis=axis)
    ref = np.asarray(jrt.pack_int4(codes, axis=axis))
    assert packed.dtype == torch.int8
    assert packed.numpy().tobytes() == ref.tobytes()
    # split-halves layout: byte j = code j (low) | code j + n/2 (high)
    n = codes.shape[axis]
    lo = np.take(codes, range(n // 2), axis=axis).astype(np.int32) & 0xF
    hi = np.take(codes, range(n // 2, n), axis=axis).astype(np.int32) & 0xF
    assert np.array_equal(packed.numpy().view(np.uint8), lo | (hi << 4))
    back = trt.unpack_int4(packed, axis=axis)
    assert np.array_equal(back.numpy(), codes)
    assert np.array_equal(back.numpy(),
                          np.asarray(jrt.unpack_int4(ref, axis=axis)))


def test_pack_int4_odd_axis_raises():
    codes = torch.zeros((3, 5), dtype=torch.int8)
    with pytest.raises(ValueError, match="odd"):
        trt.pack_int4(codes, axis=1)
    with pytest.raises(ValueError, match="odd"):
        jrt.pack_int4(np.zeros((3, 5), np.int8), axis=1)


@pytest.mark.parametrize("name", ["float32", "fp32", "bfloat16", "bf16",
                                  "int8", "INT8", "int4", "i4"])
def test_resolve_kv_dtype_names_match_reference(name):
    jdt, jbits = jrt.resolve_kv_dtype(name, jnp.float32)
    tdt, tbits = trt.resolve_kv_dtype(name, torch.float32)
    assert tbits == jbits
    assert str(tdt).replace("torch.", "") == str(jnp.dtype(jdt))


def test_resolve_kv_dtype_env_default_and_errors(monkeypatch):
    monkeypatch.delenv("PT_KV_DTYPE", raising=False)
    assert trt.resolve_kv_dtype(None, torch.bfloat16) == (torch.bfloat16, 0)
    monkeypatch.setenv("PT_KV_DTYPE", "int4")
    assert trt.resolve_kv_dtype(None, torch.float32) == (torch.int8, 4)
    assert jrt.resolve_kv_dtype(None, jnp.float32)[1] == 4
    monkeypatch.setenv("PT_KV_DTYPE", "bf16")
    assert trt.resolve_kv_dtype(None, torch.float32) == (torch.bfloat16, 0)
    assert trt.resolve_kv_dtype(torch.int8, torch.float32) == (torch.int8, 8)
    with pytest.raises(ValueError) as t_err:
        trt.resolve_kv_dtype("fp8", torch.float32)
    with pytest.raises(ValueError) as j_err:
        jrt.resolve_kv_dtype("fp8", jnp.float32)
    assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError, match="kv_dtype"):
        teng.LLMEngineConfig(kv_dtype="fp8")


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8", "int4"])
def test_kv_bytes_per_page_and_pool_budget_match_reference(kv_dtype):
    jcfg, tcfg = jax_gpt_tiny(), gpt_tiny()
    for ps in (8, 16):
        assert (teng.LLMEngineConfig.kv_bytes_per_page(tcfg, ps, kv_dtype)
                == jeng.LLMEngineConfig.kv_bytes_per_page(jcfg, ps,
                                                          kv_dtype))
    budget = 3 << 20
    t = teng.LLMEngineConfig.for_pool_budget(tcfg, budget, kv_dtype=kv_dtype,
                                             num_slots=2)
    j = jeng.LLMEngineConfig.for_pool_budget(jcfg, budget, kv_dtype=kv_dtype,
                                             num_slots=2)
    assert (t.num_pages, t.page_size, t.num_slots) == (j.num_pages,
                                                       j.page_size,
                                                       j.num_slots)


@pytest.mark.parametrize("kv_dtype,store,kind", [
    ("int8", 32, torch.int8), ("int4", 16, torch.int8),
    ("bfloat16", 32, torch.bfloat16)])
def test_engine_pool_layout_and_bytes_match_reference(kv_dtype, store, kind):
    from paddle_tpu.text.models import GPTForCausalLM as JaxGPT

    cfg = dict(num_slots=2, page_size=8, max_model_len=32, kv_dtype=kv_dtype)
    te = teng.LLMEngine(GPTForCausalLM(gpt_tiny(), device="cpu", seed=1),
                        teng.LLMEngineConfig(**cfg))
    je = jeng.LLMEngine(JaxGPT(jax_gpt_tiny()), jeng.LLMEngineConfig(**cfg))
    assert te.kv_dtype == je.kv_dtype == kv_dtype
    assert all(p.shape == (9, 8, 4, store) and p.dtype == kind
               for p in te._kv)
    quantized = kv_dtype in ("int8", "int4")
    assert len(te._kv_scales) == (4 if quantized else 0)
    assert all(s.shape == (9, 8, 4) and s.dtype == torch.float32
               for s in te._kv_scales)
    assert te.pool_bytes() == je.pool_bytes()


def test_int4_needs_an_even_head_dim():
    from paddle_tpu_torch.text.models.gpt import GPTConfig

    odd = GPTConfig(vocab_size=64, hidden_size=24, num_layers=1, num_heads=8,
                    max_seq_len=32)   # head_dim 3
    model = GPTForCausalLM(odd, device="cpu")
    with pytest.raises(ValueError, match="even head_dim"):
        teng.LLMEngine(model, teng.LLMEngineConfig(kv_dtype="int4"))


@pytest.mark.parametrize("bits", [8, 4])
def test_paged_cache_write_quant_matches_reference(bits):
    """Rows written into a quantized pool: codes and scale planes are
    byte-identical to the reference's write, each row at its flat slot,
    the trash row included (padding rows all target row 0)."""
    rng = np.random.default_rng(bits)
    N, P, H, D = 5, 4, 2, 16
    d_store = D // 2 if bits == 4 else D
    pools = [rng.integers(-100, 100, (N, P, H, d_store)).astype(np.int8)
             for _ in range(2)]
    scales = [rng.uniform(0.01, 1.0, (N, P, H)).astype(np.float32)
              for _ in range(2)]
    k_new = rng.standard_normal((6, H, D)).astype(np.float32)
    v_new = rng.standard_normal((6, H, D)).astype(np.float32)
    widx = np.array([5, 6, 7, 17, 0, 0], np.int32)
    ref = jwrite(*[paddle.to_tensor(a) for a in (*pools, *scales, k_new,
                                                 v_new, widx)])
    ts = [torch.from_numpy(a.copy()) for a in (*pools, *scales)]
    twrite(*ts, torch.from_numpy(k_new), torch.from_numpy(v_new),
           torch.from_numpy(widx))
    for got, want in zip(ts, ref):
        want = np.asarray(want.numpy())
        # row 0 is the trash row: two padding writes collide there
        assert got.numpy()[0, 1:].tobytes() == want[0, 1:].tobytes()
        assert got.numpy()[1:].tobytes() == want[1:].tobytes()
