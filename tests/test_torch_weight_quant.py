"""Weight-only quantized serving: the PyTorch port against the JAX
package's quantization (quantize_weight_int8, quantization/runtime.py's
Int8WeightOnlyLinear / Int4WeightOnlyLinear / quantize_model_int8 /
quantize_model_int4) on CPU.

The weight codec must give the reference's codes and scales byte for byte
(8 bits, and 4 bits with the MSE clip search; per channel with the
keepdims shape, and per tensor), the quantized linears the reference's
buffers byte for byte, the reference's activation codes and outputs
within one ulp; the model swaps must report and place what the
reference's do (skip and odd in-dims included); quantized gpt_tiny logits
and the int8-weight engine's greedy tokens must match the reference's,
and `convert` must carry the quantized buffers both ways. On the CPU the
W8A8 product is the int8 GEMM's plain version (`ops/cuda_kernels/
int8_gemm.py`); the CUDA kernel itself is checked against it on the card
by chip_smoke.py.
"""
import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import quantization as jq
from paddle_tpu.inference import llm_engine as jeng
from paddle_tpu.quantization import runtime as jrt
from paddle_tpu.text.models import GPTForCausalLM as JaxGPT
from paddle_tpu.text.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch import quantization as tq
from paddle_tpu_torch.convert import export_state_dict, load_jax_state_dict
from paddle_tpu_torch.inference import llm_engine as teng
from paddle_tpu_torch.nn.layer.common import Linear as TLinear
from paddle_tpu_torch.ops.cuda_kernels import int8_gemm as ig
from paddle_tpu_torch.quantization import runtime as trt
from paddle_tpu_torch.text.models.gpt import GPTForCausalLM, gpt_tiny

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True)
def _serial_mesh():
    from paddle_tpu.distributed import mesh as mesh_mod

    mesh_mod.reset_mesh()
    yield


def _weight(seed, shape=(96, 40)):
    """N(0, 0.02) values with an outlier column and an all-zero column
    (whose scale is the 1e-8 floor)."""
    w = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * 0.02
    w[5, 3] = 0.4
    w[:, 7] = 0.0
    return w


@pytest.mark.parametrize("bits,search_mse", [(8, False), (8, True),
                                              (4, True), (4, False)])
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_quantize_weight_matches_reference(axis, bits, search_mse):
    w = _weight(1)
    want_q, want_s = jq.quantize_weight_int8(w, axis=axis,
                                             search_mse=search_mse,
                                             bits=bits)
    got_q, got_s = tq.quantize_weight_int8(torch.from_numpy(w), axis=axis,
                                           search_mse=search_mse, bits=bits)
    np.testing.assert_array_equal(got_q, np.asarray(want_q))
    assert got_q.dtype == np.int8
    want_s = np.asarray(want_s)
    assert np.asarray(got_s).shape == want_s.shape      # keepdims kept
    assert np.asarray(got_s).dtype == np.float32
    np.testing.assert_array_equal(np.asarray(got_s), want_s)
    if axis == 1:
        assert want_s.shape == (1, w.shape[1])


@pytest.mark.parametrize("search_mse", [False, True])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("axis", [None, 1])
def test_quantize_weight_bf16_matches_reference(axis, bits, search_mse):
    """A bf16 weight: the reference is handed the bf16 array and computes
    in numpy's bfloat16 type, the port takes the torch bf16 tensor. Codes
    and scales byte-equal over seeded [256, 64] weights; per tensor
    without the search the reference rounds its quotient to bf16 (the
    smallest input where that decides a code: [0.390625, 3.0] at 8 bits,
    code 16, not 17)."""
    ws = [np.random.default_rng(seed).standard_normal((256, 64)) * 0.02
          for seed in range(6)]
    ws.append(np.array([[0.390625, 3.0]]))
    for w in ws:
        wj = jnp.asarray(w, jnp.bfloat16)
        want_q, want_s = jq.quantize_weight_int8(
            wj, axis=axis, search_mse=search_mse, bits=bits)
        got_q, got_s = tq.quantize_weight_int8(
            torch.from_numpy(np.array(wj.astype(jnp.float32))).bfloat16(),
            axis=axis, search_mse=search_mse, bits=bits)
        np.testing.assert_array_equal(got_q, np.asarray(want_q))
        want_s = np.asarray(want_s)
        assert np.asarray(got_s).dtype == np.float32
        assert np.asarray(got_s).shape == want_s.shape
        np.testing.assert_array_equal(np.asarray(got_s), want_s)


def test_mse_search_never_worse_and_matches_reference():
    vals = np.concatenate([np.random.default_rng(2).standard_normal(500),
                           [25.0]]).astype(np.float32)
    am = float(np.abs(vals).max())
    for bits in (8, 4):
        got = tq._search_scale_mse(vals, am, bits=bits)
        assert got == jq._search_scale_mse(vals, am, bits=bits)
        assert got <= am
    w = _weight(3)
    s0 = np.maximum(np.abs(w).max(axis=0, keepdims=True), 1e-8)
    np.testing.assert_array_equal(
        tq._search_scale_mse_per_channel(w, s0, (0,), bits=4),
        jq._search_scale_mse_per_channel(w, s0, (0,), bits=4))


def _linear_pair(seed, n_in=64, n_out=48, bias=True):
    """A reference Linear and the port's with its weights."""
    paddle.seed(seed)
    jl = jnn.Linear(n_in, n_out, bias_attr=None if bias else False)
    tl = TLinear(n_in, n_out, has_bias=bias, device="cpu")
    load_jax_state_dict(tl, {k: np.array(v.numpy())
                             for k, v in jl.state_dict().items()})
    return jl, tl


def _x(seed, n_in=64):
    x = np.random.default_rng(seed).standard_normal((6, n_in)).astype(
        np.float32) * 3
    x[2] = 0.0                                   # a zero row
    x[4, :3] = [127.0, 63.5, -0.5]               # its codes: ties at .5
    return x


def _ref_codes(x):
    """The reference's activation quantize, runtime.py:126-131."""
    f = jnp.asarray(x).astype(jnp.float32)
    a_step = jnp.maximum(jnp.max(jnp.abs(f), axis=-1, keepdims=True),
                         1e-8) / jrt.QMAX
    return np.asarray(jnp.clip(jnp.round(f / a_step), -jrt.QMAX,
                               jrt.QMAX).astype(jnp.int8))


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("width", ["int8", "int4"])
def test_weight_only_linear_matches_reference(width, bias):
    """Buffers byte-equal, activation codes byte-equal, outputs within one
    ulp of f32 (the int32 products are exact; the f32 epilogue is taken
    in the same order)."""
    jl, tl = _linear_pair(4, bias=bias)
    cls = {"int8": (jrt.Int8WeightOnlyLinear, trt.Int8WeightOnlyLinear),
           "int4": (jrt.Int4WeightOnlyLinear, trt.Int4WeightOnlyLinear)}
    jm, tm = cls[width][0](jl), cls[width][1](tl)
    np.testing.assert_array_equal(tm.weight_q.numpy(),
                                  np.asarray(jm.weight_q.numpy()))
    np.testing.assert_array_equal(tm.w_step.numpy(),
                                  np.asarray(jm.w_step.numpy()))
    assert tuple(tm.w_step.shape) == (1, 48)
    assert tm.weight_q.shape[0] == (32 if width == "int4" else 64)
    x = _x(5)
    codes, _ = ig.quantize_rows_plain(torch.from_numpy(x))
    np.testing.assert_array_equal(codes.numpy(), _ref_codes(x))
    want = np.asarray(jm(paddle.to_tensor(x)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_weight_only_linear_bf16_input_keeps_dtype():
    jl, tl = _linear_pair(6)
    tm = trt.Int8WeightOnlyLinear(tl)
    jm = jrt.Int8WeightOnlyLinear(jl)
    x = _x(7)
    got = tm(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    want = np.asarray(jm(paddle.to_tensor(jnp.asarray(x, jnp.bfloat16)))
                      .numpy()).astype(np.float32)
    np.testing.assert_array_equal(got.float().detach().numpy(), want)


def test_int4_linear_odd_in_features_raises():
    _, tl = _linear_pair(8, n_in=7)
    with pytest.raises(ValueError, match="odd"):
        trt.Int4WeightOnlyLinear(tl)


def test_w8a8_plain_is_exact_and_counts_nothing_on_cpu():
    """Codes of ±127 over K 3072: sums far past int8 (and past f32's
    exact integers), equal to numpy's int64 product; the CPU path is the
    plain version and moves no launch count."""
    rng = np.random.default_rng(9)
    codes = rng.integers(-127, 128, (5, 3072)).astype(np.int8)
    codes[0] = 127
    w = rng.integers(-127, 128, (3072, 32)).astype(np.int8)
    w[:, 0] = 127
    before = dict(ig.launches)
    acc = ig._accumulate(torch.from_numpy(codes), torch.from_numpy(w))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(
        acc.numpy(), codes.astype(np.int64) @ w.astype(np.int64))
    assert acc[0, 0].item() == 127 * 127 * 3072
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    wq = torch.from_numpy(rng.integers(-7, 8, (64, 16)).astype(np.int8))
    steps = torch.rand((1, 16))
    out = ig.w8a8_linear(x, trt.pack_int4(wq, axis=0), steps, int4=True)
    np.testing.assert_array_equal(
        out.numpy(), ig.w8a8_linear_plain(x, wq, steps).numpy())
    assert ig.launches == before


class _JNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.a = jnn.Linear(8, 16)
        self.b = jnn.Linear(7, 16)
        self.c = jnn.Linear(16, 8)


class _TNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.a = TLinear(8, 16, device="cpu")
        self.b = TLinear(7, 16, device="cpu")
        self.c = TLinear(16, 8, device="cpu")


@pytest.mark.parametrize("skip", [(), ("c",)])
@pytest.mark.parametrize("width", ["int8", "int4"])
def test_quantize_model_reports_and_swaps_match_reference(width, skip):
    paddle.seed(10)
    jm = _JNet()
    tm = _TNet()
    load_jax_state_dict(tm, {k: np.array(v.numpy())
                             for k, v in jm.state_dict().items()})
    fn = f"quantize_model_{width}"
    want = getattr(jrt, fn)(jm, skip=skip)
    got = getattr(trt, fn)(tm, skip=skip)
    want.pop("tp_placements", None)
    assert got == want
    for name in ("a", "b", "c"):
        assert (type(getattr(tm, name)).__name__
                == type(getattr(jm, name)).__name__), name
    if width == "int4":
        assert got["skipped_odd"] == 1 and isinstance(tm.b, TLinear)
    js = {k: np.array(v.numpy()) for k, v in jm.state_dict().items()}
    ts = export_state_dict(tm)
    assert set(ts) == set(js)
    for k in js:
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)


@pytest.fixture(scope="module")
def tiny_pair():
    from paddle_tpu.distributed import mesh as mesh_mod

    mesh_mod.reset_mesh()
    paddle.seed(30)
    jm = JaxGPT(jax_gpt_tiny())
    jm.eval()
    tm = GPTForCausalLM(gpt_tiny(), device="cpu")
    load_jax_state_dict(tm, {k: np.array(v.numpy())
                             for k, v in jm.state_dict().items()})
    return jm, tm


def _quantized(pair, width):
    jm0, tm0 = pair
    jm = JaxGPT(jax_gpt_tiny())
    jm.set_state_dict(jm0.state_dict())
    jm.eval()
    tm = copy.deepcopy(tm0)
    rj = getattr(jrt, f"quantize_model_{width}")(jm)
    rt = getattr(trt, f"quantize_model_{width}")(tm)
    rj.pop("tp_placements", None)
    assert rt == rj and rt["layers"] == 8        # 4 linears x 2 blocks
    return jm, tm


@pytest.mark.parametrize("width", ["int8", "int4"])
def test_quantized_gpt_tiny_logits_match_reference(tiny_pair, width):
    jm, tm = _quantized(tiny_pair, width)
    js = {k: np.array(v.numpy()) for k, v in jm.state_dict().items()}
    for k, v in export_state_dict(tm).items():
        np.testing.assert_array_equal(v, js[k], err_msg=k)
    ids = np.random.default_rng(11).integers(0, 2048, (2, 24))
    want = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("width", ["int8", "int4"])
def test_convert_carries_quantized_buffers(tiny_pair, width):
    """A reference model quantized by quantize_model_<width> loads into a
    port model quantized the same way from other weights: every code and
    step byte-equal, and both compute the same logits; exported back,
    the arrays equal the reference's."""
    jm, _ = _quantized(tiny_pair, width)
    other = GPTForCausalLM(gpt_tiny(), device="cpu", seed=99)
    getattr(trt, f"quantize_model_{width}")(other)
    js = {k: np.array(v.numpy()) for k, v in jm.state_dict().items()}
    assert not np.array_equal(
        other.gpt.layers[0].qkv.weight_q.numpy(),
        js["gpt.layers.0.qkv.weight_q"])
    load_jax_state_dict(other, js)
    buffers = dict(other.named_buffers())
    assert {k for k in buffers if k.endswith(("weight_q", "w_step"))} == {
        k for k in js if k.endswith(("weight_q", "w_step"))}
    for k, v in export_state_dict(other).items():
        np.testing.assert_array_equal(v, js[k], err_msg=k)
    assert buffers["gpt.layers.0.qkv.weight_q"].dtype == torch.int8
    ids = np.random.default_rng(12).integers(0, 2048, (1, 16))
    with torch.no_grad():
        got = other(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jm(paddle.to_tensor(ids)).numpy()), rtol=0,
        atol=1e-5)


@pytest.mark.parametrize("width", ["int8", "int4"])
def test_weight_quantized_engine_greedy_matches_reference(tiny_pair,
                                                          width):
    jm, tm = _quantized(tiny_pair, width)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 2048, (n,)) for n in (5, 13, 8)]
    cfg = dict(num_slots=3, page_size=16, token_budget=8, max_model_len=64)
    outs = []
    for mod, model in ((jeng, jm), (teng, tm)):
        eng = mod.LLMEngine(model, mod.LLMEngineConfig(**cfg))
        reqs = [eng.add_request(p, max_new_tokens=16) for p in prompts]
        while eng.has_work():
            eng.step()
        outs.append([r.future.result(timeout=0) for r in reqs])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(b, a)
