"""The int8 GEMM's planner and split-K on CPU: the PyTorch port's
`ops/cuda_kernels/int8_gemm.py` against the JAX package's weight-only
product (`lax.dot_general(int8, int8 -> int32)` of
paddle_tpu/quantization/runtime.py, with its `unpack_int4` for packed
int4 weights).

`plan(T, K, N, int4)` is the kernel's tiling, passed to the CUDA kernel
at each launch: its k-ranges must tile the weight's rows exactly, in
whole 32-row steps, each packed int4 range meeting the right two slices
of x; gpt_small's shapes must fill the card's 132 SMs at every decode
row count; and its shared memory must be what `csrc/int8_gemm.cu` lays
out, from the constants the source declares. The int32 product summed
range by range over the plan (the kernel's split-K, in plain torch) must
equal the reference's product bit for bit. The kernel itself runs on the
card only; chip_smoke.py phase 3 holds it to the plain version there.
"""
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from paddle_tpu.quantization import runtime as jrt
from paddle_tpu_torch import profile_serve
from paddle_tpu_torch.ops.cuda_kernels import _build
from paddle_tpu_torch.ops.cuda_kernels import int8_gemm as ig
from paddle_tpu_torch.quantization import runtime as trt
from paddle_tpu_torch.text.models.gpt import gpt_small, gpt_tiny

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


ROWS = (1, 8, 13, 16, 17, 48, 256, 300)


def _linear_shapes(cfg):
    """(in, out) of a GPT block's four linears: qkv, proj, fc1, fc2."""
    d = cfg.hidden_size
    return ((d, 3 * d), (d, d), (d, 4 * d), (4 * d, d))


SHAPES = {"gpt_tiny": _linear_shapes(gpt_tiny()),
          "gpt_small": _linear_shapes(gpt_small())}


def _source_constants():
    with open(os.path.join(_build.CSRC, "int8_gemm.cu")) as f:
        src = f.read()
    return {name: int(v) for name, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", src)}


def _ranges(p):
    """[(first, end)) stored weight rows of each k-range of plan `p`, in
    rank order (the kernel's ranges: rank s takes steps [s·per,
    (s + 1)·per))."""
    step = p.per * ig.STEP_ROWS
    return [(s * step, min((s + 1) * step, p.rows)) for s in range(p.splits)]


def _x_ranges(p):
    """Per k-range, the slices of x's columns it meets: the same rows for
    int8; for packed int4 rows [p0, p1), x's [p0, p1) (low nibbles) and
    [K/2 + p0, K/2 + p1) (high nibbles)."""
    if not p.int4:
        return [[r] for r in _ranges(p)]
    return [[(p0, p1), (p.rows + p0, p.rows + p1)] for p0, p1 in _ranges(p)]


def _accumulate_split(codes, weight_q, int4, p):
    """The kernel's split-K in plain torch: the int32 product of codes
    [T, K] with weight_q (int8 [K, N] or packed int4 [K/2, N]) summed
    k-range by k-range over plan `p`, each range's packed rows unpacked
    against its two slices of x for int4."""
    acc = torch.zeros((codes.shape[0], weight_q.shape[1]), dtype=torch.int32)
    for (r0, r1), cols in zip(_ranges(p), _x_ranges(p)):
        wr = weight_q[r0:r1]
        parts = (trt.unpack_int4(wr, axis=0).chunk(2, dim=0) if int4
                 else (wr,))
        for (c0, c1), wpart in zip(cols, parts):
            acc += codes[:, c0:c1].to(torch.int32) @ wpart.to(torch.int32)
    return acc


def test_planner_constants_are_the_kernels():
    """The planner's layout constants are the ones csrc/int8_gemm.cu
    declares (its shared memory formula is built from them)."""
    c = _source_constants()
    assert c["kDecodeThreads"] // 32 == ig.DECODE_WARPS
    assert (c["kStepRows"], c["kWarpCols"], c["kMaxSplits"],
            c["kDecodeRows"], c["kWarpStages"], c["kCodePad"],
            c["kWideRows"], c["kWideStages"], c["kCodeLd"]) == (
        ig.STEP_ROWS, ig.WARP_COLS, ig.MAX_SPLITS, ig.DECODE_ROWS,
        ig.WARP_STAGES, ig.CODE_PAD, ig.WIDE_ROWS, ig.WIDE_STAGES,
        ig.CODE_LD)
    assert c["kWideCols"] == ig.WIDE_COLS


def _smem_from_source(p):
    """Shared memory of a block as the kernel carves it. Decode route:
    the 8 warps' weight rings, the int32 partial tile, the codes (a
    padded row per token, both x slices for int4), the rows' steps.
    Wide route: the ring of stages (a weight tile and the 64 tokens'
    codes, padded, per x slice), the partial slots, the steps; both:
    the columns' w_step and bias."""
    c = _source_constants()
    h = 2 if p.int4 else 1
    if p.decode:
        rows, cols = c["kDecodeRows"], c["kWarpCols"]
        return ((c["kDecodeThreads"] // 32) * c["kWarpStages"]
                * c["kStepRows"] * cols
                + (rows + c["kMaxSplits"]) * cols * 4
                + rows * (h * p.per * c["kStepRows"] + c["kCodePad"])
                + rows * 4 + cols * 4 * 2)
    rows, cols = c["kWideRows"], c["kWideCols"]
    return (c["kWideStages"] * (cols * c["kStepRows"]
                                + h * rows * c["kCodeLd"])
            + (rows + c["kMaxSplits"]) * cols * 4 + rows * 4
            + cols * 4 * 2)


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("T", ROWS)
@pytest.mark.parametrize("model", sorted(SHAPES))
def test_plan_tiles_k_exactly(model, T, int4):
    """Every shape's k-ranges tile the stored rows exactly, without
    overlap, in whole steps; int4 ranges meet x's [p0, p1) and
    [K/2 + p0, K/2 + p1), which together cover x's columns once; the
    token tiles cover T; the shared memory is the kernel's layout."""
    for K, N in SHAPES[model]:
        p = ig.plan(T, K, N, int4)
        rows = K // 2 if int4 else K
        assert p.rows == rows and p.steps == -(-rows // ig.STEP_ROWS)
        assert 1 <= p.splits <= ig.MAX_SPLITS
        ranges = _ranges(p)
        assert len(ranges) == p.splits
        assert ranges[0][0] == 0 and ranges[-1][1] == rows
        for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
            assert a1 == b0                       # no gap, no overlap
        for r0, r1 in ranges:
            assert r0 < r1
            assert r0 % ig.STEP_ROWS == 0
            assert r1 == rows or (r1 - r0) == p.per * ig.STEP_ROWS
        cols = sorted(c for parts in _x_ranges(p) for c in parts)
        if int4:
            for (p0, p1), parts in zip(ranges, _x_ranges(p)):
                assert parts == [(p0, p1), (K // 2 + p0, K // 2 + p1)]
        assert cols[0][0] == 0 and cols[-1][1] == K
        for (a0, a1), (b0, _) in zip(cols, cols[1:]):
            assert a1 == b0
        rows_a_block = 16 if T <= 16 else 64
        assert p.decode == (T <= 16) and p.launches == (1 if T <= 16 else 2)
        assert p.m_tiles * rows_a_block >= T > (p.m_tiles - 1) * rows_a_block
        assert p.n_tiles * (ig.WARP_COLS if T <= 16 else ig.WIDE_COLS) >= N
        assert p.smem == _smem_from_source(p) <= ig.SMEM_LIMIT


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("T", [1, 8, 13, 16])
def test_plan_fills_the_card_at_decode_rows(T, int4):
    """gpt_small's four linears at every decode row count launch at
    least one block per SM (132 on an H100)."""
    for K, N in SHAPES["gpt_small"]:
        p = ig.plan(T, K, N, int4)
        assert p.blocks >= ig.SMS, (K, N, p)


def _reference_acc(codes, wq, int4):
    """The reference's int32 product (runtime.py:134 / :209)."""
    w = jrt.unpack_int4(wq, axis=0) if int4 else jnp.asarray(wq)
    return np.asarray(lax.dot_general(
        jnp.asarray(codes), w, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32))


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("T,K,N", [(8, 768, 768), (13, 3072, 768),
                                   (17, 768, 2304), (48, 128, 512),
                                   (300, 512, 128), (5, 224, 48)])
def test_split_k_sum_equals_reference(T, K, N, int4):
    """The int32 sum over the planner's k-ranges (the kernel's split-K,
    computed by the plain path) equals the reference's dot_general on
    the same seeded codes and weights: tolerance 0, equal bits. Codes at
    the ±127 edge make sums that f32 could not hold."""
    rng = np.random.default_rng(K + N + T)
    codes = rng.integers(-127, 128, (T, K)).astype(np.int8)
    codes[0] = 127
    qmax = 7 if int4 else 127
    q = rng.integers(-qmax, qmax + 1, (K, N)).astype(np.int8)
    q[:, 0] = qmax
    wq = (trt.pack_int4(torch.from_numpy(q), axis=0).numpy() if int4
          else q)
    p = ig.plan(T, K, N, int4)
    got = _accumulate_split(torch.from_numpy(codes), torch.from_numpy(wq),
                            int4, p)
    want = _reference_acc(codes, wq, int4)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0].item() == 127 * qmax * K


def test_prepare_refuses_a_weight_off_the_card():
    wq = torch.zeros((64, 32), dtype=torch.int8)
    with pytest.raises(ValueError, match="not a card"):
        ig.prepare(wq, torch.ones((1, 32)))


def test_weight_only_linear_keeps_no_prepared_weight_on_cpu():
    """On CPU tensors the module takes the plain version and prepares
    nothing; a move clears whatever was kept."""
    from paddle_tpu_torch.nn.layer.common import Linear

    rng = np.random.default_rng(0)
    lin = Linear(64, 32, device="cpu")        # parameters uninitialized
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(
            rng.standard_normal((64, 32)).astype(np.float32) * 0.02))
        lin.bias.copy_(torch.from_numpy(
            rng.standard_normal(32).astype(np.float32) * 0.1))
    m = trt.Int8WeightOnlyLinear(lin)
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    with torch.no_grad():
        out = m(x)
    assert m._gemm_weight is None
    torch.testing.assert_close(
        out, ig.w8a8_linear_plain(x, m.weight_q, m.w_step, m.bias),
        rtol=0, atol=0)
    m._gemm_weight = "stale"
    m.to(torch.device("cpu"))
    assert m._gemm_weight is None


def test_profile_serve_names_the_gemm_kernel():
    """profile_serve's GEMM rows name the kernels the source defines: the
    decode route's GEMM (the activation quantize inside), the row
    quantize and the wide route's GEMM."""
    with open(os.path.join(_build.CSRC, "int8_gemm.cu")) as f:
        defined = set(re.findall(r"\b(\w+_kernel)\(const ", f.read()))
    assert set(sum(profile_serve.GEMM_KERNELS.values(), ())) == defined


def test_profile_gemm_loads_an_earlier_tree():
    """chip_smoke.py's `--parent DIR` (phase 3 times an earlier tree's
    GEMM beside this one's) loads another checkout's GEMM module as its
    own package (here this tree's): its plain path agrees bit for bit."""
    import importlib.util
    import sys

    root = os.path.dirname(_build._PKG)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    parent = smoke.load_parent(root)
    try:
        assert parent.__name__ == "parent_pt.ops.cuda_kernels.int8_gemm"
        assert parent is not ig
        rng = np.random.default_rng(3)
        x = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32))
        wq = torch.from_numpy(rng.integers(-127, 128, (64, 32)).astype(
            np.int8))
        ws = torch.from_numpy(rng.random((1, 32)).astype(np.float32))
        np.testing.assert_array_equal(
            parent.w8a8_linear(x, wq, ws).numpy(),
            ig.w8a8_linear_plain(x, wq, ws).numpy())
    finally:
        for name in [n for n in sys.modules if n.startswith("parent_pt")]:
            del sys.modules[name]


def test_prepared_record_of_another_weight_raises():
    """`prepared=` must be the record of the tensors passed: a stale one
    raises before any launch (on CPU tensors too, where the plain
    version would not read it)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    wq = torch.from_numpy(rng.integers(-127, 128, (64, 32)).astype(np.int8))
    ws = torch.from_numpy(rng.random((1, 32)).astype(np.float32))
    rec = ig.PreparedWeight(wq, ws, None, False, 64, 32, torch.device("cpu"))
    torch.testing.assert_close(
        ig.w8a8_linear(x, wq, ws, prepared=rec),
        ig.w8a8_linear_plain(x, wq, ws), rtol=0, atol=0)
    for stale in (rec._replace(weight_q=wq.clone()),
                  rec._replace(w_step=ws.clone()), rec._replace(int4=True)):
        with pytest.raises(ValueError, match="another weight"):
            ig.w8a8_linear(x, wq, ws, prepared=stale)


def test_route_counts_stay_still_on_cpu():
    """`route_launches` has a count per (width, route); the CPU's plain
    path moves neither it nor `launches`, and `reset_launches` zeroes
    both."""
    assert set(ig.route_launches) == {"w8a8_decode", "w8a8_wide",
                                      "w4a8_decode", "w4a8_wide"}
    ig.route_launches["w8a8_wide"] += 3
    ig.launches["w8a8"] += 3
    ig.reset_launches()
    assert set(ig.route_launches.values()) == set(ig.launches.values()) == {0}
    x = torch.ones((20, 64))
    wq = torch.ones((64, 32), dtype=torch.int8)
    ig.w8a8_linear(x, wq, torch.ones((1, 32)))
    assert set(ig.route_launches.values()) == set(ig.launches.values()) == {0}
