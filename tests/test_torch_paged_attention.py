"""Ragged paged attention: the PyTorch port's plain version against the
JAX package's jnp path and its Pallas kernels in interpret mode — K1
(`_rpa_kernel`) on float, int8 and packed-int4 pools, and K2
(`_rpa_qblock_kernel`, `q_per_slot`) on the speculative verify layout.

Same inputs (numpy, seeded) through both packages, f32, at the
tolerance the JAX package's own parity tests use (rtol 1e-5, atol 1e-6:
online vs plain softmax differ only in summation order; 2e-5 against
the Pallas kernels on quantized pools and the verify layout, as the
reference's own K2 test holds it).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.pallas_kernels import paged_attention as pak
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops.cuda_kernels import paged_attention as tpa
from paddle_tpu_torch.quantization import runtime as trt

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


@pytest.fixture(autouse=True)
def _serial_mesh():
    from paddle_tpu.distributed import mesh as mesh_mod

    mesh_mod.reset_mesh()
    yield


def _case(rng, page_size, lens, extras, H=2, D=16, stale=True):
    """Contiguous per-slot K/V scattered into a shuffled page pool.
    Tokens: one frontier per slot (kv_len = lens[s]), the `extras`
    (slot, kv_len) mid-sequence rows, and one padding row (kv_len 0).
    With `stale`, page-table entries past each slot's length hold other
    live page ids, as a real engine's tables may."""
    S, P = len(lens), page_size
    MP = -(-max(lens) // P) + 1
    N = sum(-(-int(l) // P) for l in lens) + 1
    pool_k = rng.standard_normal((N, P, H, D)).astype(np.float32)
    pool_v = rng.standard_normal((N, P, H, D)).astype(np.float32)
    pool_k[0] = pool_v[0] = 0.0
    pt = np.zeros((S, MP), np.int32)
    perm = list(rng.permutation(np.arange(1, N)))
    for s in range(S):
        used = -(-int(lens[s]) // P)
        for j in range(used):
            pt[s, j] = int(perm.pop())
        if stale:
            pt[s, used:] = rng.integers(1, N, (MP - used,))
    sid = list(range(S)) + [s for s, _ in extras] + [0]
    klen = [int(l) for l in lens] + [k for _, k in extras] + [0]
    q = rng.standard_normal((len(sid), H, D)).astype(np.float32)
    return (q, pool_k, pool_v, pt, np.asarray(sid, np.int32),
            np.asarray(klen, np.int32))


def _port(args, offset=None):
    ts = [torch.from_numpy(a.copy()) for a in args]
    return TF.paged_attention(*ts, frontier_offset=offset).numpy()


def _jax_jnp(args, offset=None):
    off = None if offset is None else paddle.to_tensor(
        np.asarray(offset, np.int32))
    return JF.paged_attention(*[paddle.to_tensor(a) for a in args],
                              frontier_offset=off).numpy()


def _jax_pallas(args, offset=None):
    return np.asarray(pak.ragged_paged_attention(
        *[jnp.asarray(a) for a in args], frontier_offset=offset,
        interpret=True))


@pytest.mark.parametrize("page_size", [16, 64])
@pytest.mark.parametrize("offset", [None, 3])
def test_plain_matches_jax_jnp(page_size, offset):
    rng = np.random.default_rng(page_size + (offset or 0))
    # ragged: page-crossing, exactly one page, one short of a page, 1
    lens = [2 * page_size + 7, page_size, page_size - 1, 1]
    extras = [(0, 5), (0, page_size + 1), (1, 3)]
    args = _case(rng, page_size, lens, extras)
    out = _port(args, offset)
    np.testing.assert_allclose(out, _jax_jnp(args, offset), rtol=1e-5,
                               atol=1e-6)
    assert np.all(out[-1] == 0.0)   # kv_len 0: exact zeros, not NaN
    assert np.isfinite(out).all()


@pytest.mark.parametrize("page_size,offset", [(16, None), (16, 2),
                                              (64, 5)])
def test_plain_matches_pallas_interpret(page_size, offset):
    rng = np.random.default_rng(100 + page_size)
    lens = [40, 19, 1] if page_size == 16 else [130, 64, 2]
    extras = [(0, 7), (1, 13)]
    args = _case(rng, page_size, lens, extras)
    out = _port(args, offset)
    np.testing.assert_allclose(out, _jax_pallas(args, offset), rtol=1e-5,
                               atol=1e-6)
    assert np.all(out[-1] == 0.0)


def test_wrapper_runs_plain_on_cpu_and_counts_no_launch():
    rng = np.random.default_rng(7)
    args = _case(rng, 16, [20, 3], [(0, 4)])
    before = dict(tpa.launches)
    ts = [torch.from_numpy(a.copy()) for a in args]
    out = tpa.ragged_paged_attention(*ts)
    ref = tpa.ragged_paged_attention_plain(*ts)
    assert torch.equal(out, ref)
    qk, qs = _quantize(args[1], 8)
    vk, vs = _quantize(args[2], 8)
    qargs = [torch.from_numpy(a.copy()) for a in
             (args[0], qk, vk, *args[3:])]
    scales = dict(k_scales=torch.from_numpy(qs), v_scales=torch.from_numpy(vs))
    assert torch.equal(tpa.ragged_paged_attention(*qargs, **scales),
                       tpa.ragged_paged_attention_plain(*qargs, **scales))
    # the CPU path launches no kernel, of any kind
    assert tpa.launches == before
    assert set(tpa.launches) == set(tpa.REPLACES) == {
        "rpa", "rpa_int8", "rpa_int4", "qblock", "qblock_int8",
        "qblock_int4"}
    tpa.reset_launches()
    assert all(n == 0 for n in tpa.launches.values())


def test_scales_come_in_pairs():
    rng = np.random.default_rng(8)
    q, kp, vp, pt, sid, klen = (torch.from_numpy(a.copy()) for a in
                                _case(rng, 16, [5], []))
    sc = torch.ones(kp.shape[:3])
    with pytest.raises(ValueError, match="both"):
        TF.paged_attention(q, kp, vp, pt, sid, klen, k_scales=sc)
    with pytest.raises(ValueError, match="both"):
        tpa.ragged_paged_attention(q, kp, vp, pt, sid, klen, v_scales=sc)


def _quantize(pool, bits):
    """A float pool [N, P, H, D] → (codes, scales) by the port's codec
    (byte-identical to the reference's, tests/test_torch_quant_runtime)."""
    N, P, H, D = pool.shape
    f = trt.quantize_kv_rows_int4 if bits == 4 else trt.quantize_kv_rows
    codes, scales = f(torch.from_numpy(pool.reshape(N * P, H, D)))
    return (codes.numpy().reshape(N, P, H, -1),
            scales.numpy().reshape(N, P, H))


def _quant_args(args, bits):
    q, kp, vp, pt, sid, klen = args
    kc, ks = _quantize(kp, bits)
    vc, vs = _quantize(vp, bits)
    return (q, kc, vc, pt, sid, klen), (ks, vs)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("offset", [None, 3])
def test_quantized_plain_matches_pallas_interpret(bits, offset):
    """K1's dequant branches: int8 and packed-int4 pools (codes + per-row
    scale planes gathered through the same page ids), page-crossing rows,
    stale table entries, a padding row."""
    rng = np.random.default_rng(200 + bits + (offset or 0))
    args, (ks, vs) = _quant_args(
        _case(rng, 16, [40, 19, 1], [(0, 7), (1, 13)]), bits)
    ts = [torch.from_numpy(a.copy()) for a in args]
    out = TF.paged_attention(*ts, k_scales=torch.from_numpy(ks),
                             v_scales=torch.from_numpy(vs),
                             frontier_offset=offset).numpy()
    ref = np.asarray(pak.ragged_paged_attention(
        *[jnp.asarray(a) for a in args], k_scales=jnp.asarray(ks),
        v_scales=jnp.asarray(vs), frontier_offset=offset, interpret=True))
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
    assert np.all(out[-1] == 0.0) and np.isfinite(out).all()


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_plain_matches_jax_jnp(bits):
    rng = np.random.default_rng(300 + bits)
    args, (ks, vs) = _quant_args(
        _case(rng, 16, [37, 16, 2], [(0, 9)]), bits)
    ts = [torch.from_numpy(a.copy()) for a in args]
    out = TF.paged_attention(*ts, k_scales=torch.from_numpy(ks),
                             v_scales=torch.from_numpy(vs)).numpy()
    ref = JF.paged_attention(*[paddle.to_tensor(a) for a in args],
                             k_scales=paddle.to_tensor(ks),
                             v_scales=paddle.to_tensor(vs)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def _verify_case(rng, offset):
    """The speculative verify layout (tests/test_speculative.py:491): S
    slot-major blocks of Q = k+1 rows; slot 0 full width, slot 1 narrow
    (width 2: rows past it have kv_len 0), slot 2 dead (every row 0).
    Rows of one block share pages, and the narrow slot's short rows run
    over pages a longer sibling needs (the all-masked-row edge)."""
    S, MP, N, P, H, D = 3, 4, 13, 8, 4, 64
    Q = 4
    T = S * Q
    q = rng.standard_normal((T, H, D)).astype(np.float32)
    kp = rng.standard_normal((N, P, H, D)).astype(np.float32)
    vp = rng.standard_normal((N, P, H, D)).astype(np.float32)
    pt = rng.integers(1, N, (S, MP)).astype(np.int32)
    sid = np.repeat(np.arange(S, dtype=np.int32), Q)
    lens = np.zeros((T,), np.int32)
    pos0, width = [5, 11, 0], [3, 2, -1]
    for s in range(S):
        for j in range(Q):
            if width[s] >= 0 and j <= width[s]:
                lens[s * Q + j] = pos0[s] + j + 1
    if offset:
        lens = np.where(lens > 0, np.maximum(lens - offset, 1), 0)
    return (q, kp, vp, pt, sid, lens.astype(np.int32)), Q


@pytest.mark.parametrize("pool", ["float32", "int8", "int4"])
@pytest.mark.parametrize("offset", [0, 2])
def test_qblock_plain_matches_pallas_interpret(pool, offset):
    """K2 (`q_per_slot`): the port's plain version — the function K2
    computes — against the reference's query-blocked Pallas kernel on
    float, int8 and int4 pools, with a dead slot, a narrow slot and
    frontier offset 0 and 2; and the hinted call equals the unhinted."""
    rng = np.random.default_rng(400 + offset)
    args, Q = _verify_case(rng, offset)
    scales = {}
    jscales = {}
    if pool != "float32":
        args, (ks, vs) = _quant_args(args, 4 if pool == "int4" else 8)
        scales = dict(k_scales=torch.from_numpy(ks),
                      v_scales=torch.from_numpy(vs))
        jscales = dict(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    ts = [torch.from_numpy(a.copy()) for a in args]
    off = offset or None
    out = TF.paged_attention(*ts, **scales, frontier_offset=off,
                             max_tokens_per_slot=Q).numpy()
    ref = np.asarray(pak.ragged_paged_attention(
        *[jnp.asarray(a) for a in args], **jscales, frontier_offset=off,
        q_per_slot=Q, interpret=True))
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
    unhinted = TF.paged_attention(*ts, **scales, frontier_offset=off).numpy()
    np.testing.assert_array_equal(out, unhinted)
    lens = args[5]
    assert np.all(out[lens == 0] == 0.0) and np.isfinite(out).all()


def test_bf16_pool_plain_matches_jax_jnp():
    # bf16 pools: the port rounds where the JAX path rounds (scores in
    # the pool dtype, softmax in f32, p cast to the pool dtype) — equal
    # to bf16 resolution
    rng = np.random.default_rng(9)
    q, kp, vp, pt, sid, klen = _case(rng, 16, [37, 16, 2], [(0, 9)])
    port = TF.paged_attention(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(kp).bfloat16(),
        torch.from_numpy(vp).bfloat16(), torch.from_numpy(pt),
        torch.from_numpy(sid), torch.from_numpy(klen)).float().numpy()
    ref = np.asarray(JF.paged_attention(
        paddle.to_tensor(jnp.asarray(q, jnp.bfloat16)),
        paddle.to_tensor(jnp.asarray(kp, jnp.bfloat16)),
        paddle.to_tensor(jnp.asarray(vp, jnp.bfloat16)),
        paddle.to_tensor(pt), paddle.to_tensor(sid),
        paddle.to_tensor(klen))._value.astype(jnp.float32))
    np.testing.assert_allclose(port, ref, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("qb", [None, 5])
@pytest.mark.parametrize("kind,q_dtype,d,tc", [
    *[(k, torch.bfloat16, d, True) for k in ("bf16", "int8", "int4")
      for d in (64, 128)],
    *[(k, torch.bfloat16, d, False) for k in ("bf16", "int8", "int4")
      for d in (8, 32, 96, 256)],
    *[(k, torch.float32, d, False) for k in ("bf16", "int8", "int4")
      for d in (64, 128)],
    ("f32", torch.float32, 64, False), ("f32", torch.bfloat16, 64, False),
    ("f32", torch.bfloat16, 128, False),
])
def test_paged_route_by_pool_kind_dtype_and_head_dim(kind, q_dtype, d, tc,
                                                     qb):
    """K1 and K2 (`q_per_slot`) take the tensor-core route for a bf16 q on
    a bf16, int8 or int4 pool at head_dim 64 / 128 only; an f32 q, an f32
    pool and other head dims keep the CUDA-core `rpa_kernel` /
    `rpa_qblock_kernel`. Either route counts the call under the same
    key, and `tc_launches` has every key of `launches`."""
    assert tpa.paged_route(kind, q_dtype, d) is tc
    key = tpa._launch_key("" if kind in ("bf16", "f32") else kind, qb)
    assert key == ("qblock" if qb else "rpa") + (
        f"_{kind}" if kind in ("int8", "int4") else "")
    assert key in tpa.launches and key in tpa.tc_launches


@pytest.mark.parametrize("pool", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("qb", [None, 4])
def test_tensor_core_route_counts_stay_zero_on_cpu(pool, qb):
    """The tensor-core route's inputs (a bf16 q at head_dim 64 on a bf16,
    int8 or int4 pool; K1, and K2 on a verify layout) on CPU tensors run
    the plain version: no count moves."""
    rng = np.random.default_rng(10)
    if qb:
        args, _ = _verify_case(rng, 0)
    else:
        args = _case(rng, 16, [40, 3], [(0, 17)], H=2, D=64)
    scales = {}
    if pool != "bf16":
        args, (ks, vs) = _quant_args(args, 4 if pool == "int4" else 8)
        scales = dict(k_scales=torch.from_numpy(ks),
                      v_scales=torch.from_numpy(vs))
    ts = [torch.from_numpy(a.copy()) for a in args]
    ts[0] = ts[0].to(torch.bfloat16)
    if pool == "bf16":
        ts[1:3] = [t.to(torch.bfloat16) for t in ts[1:3]]
    tpa.reset_launches()
    out = tpa.ragged_paged_attention(*ts, **scales, q_per_slot=qb)
    assert torch.equal(out, tpa.ragged_paged_attention_plain(
        *ts, **scales, q_per_slot=qb))
    assert torch.equal(out, TF.paged_attention(*ts, **scales,
                                               max_tokens_per_slot=qb))
    assert set(tpa.tc_launches) == set(tpa.launches) == set(tpa.REPLACES)
    assert all(n == 0 for n in tpa.launches.values())
    assert all(n == 0 for n in tpa.tc_launches.values())


def test_profile_serve_names_every_paged_kernel():
    """profile_serve names every kernel that csrc/paged_attention.cu
    defines (K1 and K2, each on both routes), and no symbol is a
    substring of another (the profiler rows match by substring)."""
    import os
    import re

    from paddle_tpu_torch import profile_serve
    from paddle_tpu_torch.ops.cuda_kernels import _build

    with open(os.path.join(_build.CSRC, "paged_attention.cu")) as f:
        defined = set(re.findall(r"\b(rpa_\w*kernel)\(const ", f.read()))
    names = sum(profile_serve.PAGED_KERNELS.values(), ())
    assert {"rpa_kernel", "rpa_tc_plan_kernel", "rpa_tc_kernel",
            "rpa_tc_merge_kernel"} == set(profile_serve.PAGED_KERNELS["K1"])
    assert {"rpa_qblock_kernel", "rpa_tc_qblock_kernel",
            "rpa_tc_qblock_merge_kernel"} == set(
                profile_serve.PAGED_KERNELS["K2"])
    assert set(names) == defined
    assert not any(a != b and a in b for a in names for b in names)


def _rows_case(rng, rows, page_size=8, pages_per_seq=6, S=4, H=2, D=16):
    """K1 inputs for an explicit row layout: `rows` lists (slot, kv_len)
    per flat token (kv_len 0: padding); every page-table entry holds a
    live page id, so entries past a row's length are stale ids."""
    N = S * pages_per_seq + 1
    pool_k = rng.standard_normal((N, page_size, H, D)).astype(np.float32)
    pool_v = rng.standard_normal((N, page_size, H, D)).astype(np.float32)
    pt = (rng.permutation(N - 1) + 1).reshape(S, pages_per_seq)
    q = rng.standard_normal((len(rows), H, D)).astype(np.float32)
    sid = np.asarray([s for s, _ in rows], np.int32)
    klen = np.asarray([n for _, n in rows], np.int32)
    return q, pool_k, pool_v, pt.astype(np.int32), sid, klen


@pytest.mark.parametrize("layout,offset", [
    ("two slots in a tile", None), ("ragged chunk", 2), ("any order", 3)])
def test_plain_matches_pallas_on_tensor_core_route_layouts(layout, offset):
    """The row layouts K1's tensor-core route cuts into chunks and KV
    splits (chip_smoke.py holds the route to the plain version on them):
    the plain version equals the reference's Pallas K1 on each — a tile
    holding the tail of one slot's rows and the head of another's, a
    slot's rows ending at very different lengths with a padding row
    among them, slots in any order with a slot's rows apart."""
    rng = np.random.default_rng(500 + len(layout))
    L = 48
    if layout == "two slots in a tile":
        rows = ([(2, 20 + i) for i in range(20)]
                + [(1, 1 + i) for i in range(12)] + [(0, 0)] * 4)
    elif layout == "ragged chunk":
        rows = [(3, n) for n in (L - 2, 5, 30, 17, 1, 0, 40, 16)] + [(0, 9)]
    else:
        rows = [(int(s), int(n) if rng.random() > 0.2 else 0) for s, n in
                zip(rng.integers(0, 4, 30), rng.integers(1, L - 2, 30))]
    args = _rows_case(rng, rows)
    out = _port(args, offset)
    np.testing.assert_allclose(out, _jax_pallas(args, offset), rtol=1e-5,
                               atol=1e-6)
    assert np.all(out[args[5] == 0] == 0.0) and np.isfinite(out).all()


def _block(slot, pos0, qb, width):
    """One slot-major verify block: row j at kv_len pos0 + j + 1 up to
    `width`, 0 past it (width -1: a dead block)."""
    return [(slot, pos0 + j + 1 if j <= width else 0) for j in range(qb)]


# K2's verify layouts at a small size (S 4 slots, page 8, 16 pages per
# sequence: 128 keys, which the tensor-core route cuts into 2 splits of
# 64): (rows, qb) — chip_smoke.py holds the route to the plain version on
# the same shapes at the serving size
QBLOCK_LAYOUTS = {
    # one row per slot: a split boundary, one past it, 1, a padding row
    "qb 1": ([(0, 64), (1, 65), (2, 1), (3, 0)], 1),
    # 16 rows: a block across the split edge, a dead block, a narrow
    # block (width 2), a block up to the last key
    "qb 16": (_block(0, 50, 16, 15) + _block(1, 0, 16, -1)
              + _block(2, 20, 16, 2) + _block(3, 112, 16, 15), 16),
    # 5 rows ending in different splits (62..66), the last key, a dead and
    # a narrow block
    "rows across splits, dead and narrow": (
        _block(0, 61, 5, 4) + _block(1, 123, 5, 4) + _block(2, 0, 5, -1)
        + _block(3, 9, 5, 1), 5),
}


def _qblock_layout_args(rng, layout, offset):
    rows, qb = QBLOCK_LAYOUTS[layout]
    args = list(_rows_case(rng, rows, page_size=8, pages_per_seq=16))
    # a live row's kv_len is stored `offset` lower, as a frontier expects
    args[5] = np.where(args[5] > 0, np.maximum(args[5] - offset, 1),
                       0).astype(np.int32)
    return tuple(args), qb


@pytest.mark.parametrize("pool", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("layout,offset", [
    ("qb 1", 0), ("qb 16", 3), ("rows across splits, dead and narrow", 2)])
def test_qblock_verify_layouts_match_pallas_interpret(layout, offset, pool):
    """K2 through the port's wrapper (`q_per_slot`; the plain version on
    CPU tensors) against the reference's query-blocked Pallas kernel
    (`_qblock_call`) in interpret mode, on the verify layouts that break
    the tensor-core route's blocks and splits, on bf16, int8 and int4
    pools. bf16: both sides in bf16 (p rounded to bf16 before P·V in
    both), at bf16 resolution; quantized pools at 2e-5 as the
    reference's own K2 test."""
    rng = np.random.default_rng(600 + offset + len(layout))
    args, qb = _qblock_layout_args(rng, layout, offset)
    scales, jscales = {}, {}
    if pool != "bf16":
        args, (ks, vs) = _quant_args(args, 4 if pool == "int4" else 8)
        scales = dict(k_scales=torch.from_numpy(ks),
                      v_scales=torch.from_numpy(vs))
        jscales = dict(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    ts = [torch.from_numpy(a.copy()) for a in args]
    jargs = [jnp.asarray(a) for a in args]
    if pool == "bf16":
        ts[:3] = [t.to(torch.bfloat16) for t in ts[:3]]
        jargs[:3] = [a.astype(jnp.bfloat16) for a in jargs[:3]]
    out = tpa.ragged_paged_attention(*ts, **scales, frontier_offset=offset,
                                     q_per_slot=qb).float().numpy()
    ref = np.asarray(pak.ragged_paged_attention(
        *jargs, **jscales, frontier_offset=offset, q_per_slot=qb,
        interpret=True).astype(jnp.float32))
    tol = 2e-2 if pool == "bf16" else 2e-5
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)
    lens = args[5]
    assert np.all(out[lens == 0] == 0.0) and np.isfinite(out).all()


def _tc_route_emulation(q, codes_k, codes_v, ks, vs, pt, sid, lens,
                        hi_only=False, tile=16):
    """The tensor-core route's arithmetic on a quantized pool, in f32 on
    the CPU (a test-local emulation, not a second plain version): per
    (row, head), over tiles of `tile` keys (a K2 warp's slice) with the
    online softmax, S = (q · codes) · k-scale · 1/sqrt(D), and the P·V
    weight w = p · v-scale split into w_hi = bf16(w) and
    w_lo = bf16(w − w_hi), both multiplied with the codes; the row sum
    takes the unscaled p. `hi_only` drops w_lo."""
    T, H, D = q.shape
    P = codes_k.shape[1]
    bf = lambda x: x.to(torch.bfloat16).float()   # noqa: E731
    out = torch.zeros((T, H, D))
    for t in range(T):
        kv = int(lens[t])
        if kv == 0:
            continue
        keys = torch.arange(kv)
        pages = torch.as_tensor(pt[sid[t]])[keys // P].long()
        ck = codes_k[pages, keys % P].float()            # [kv, H, D]
        cv = codes_v[pages, keys % P].float()
        sk, sv = ks[pages, keys % P], vs[pages, keys % P]   # [kv, H]
        m = torch.full((H,), -1e30)
        l = torch.zeros(H)
        acc = torch.zeros((H, D))
        for k0 in range(0, kv, tile):
            sl = slice(k0, min(k0 + tile, kv))
            s = torch.einsum("hd,khd->hk", q[t], ck[sl]) * sk[sl].T / D ** 0.5
            m_new = torch.maximum(m, s.max(dim=1).values)
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[:, None])
            l = l * alpha + p.sum(dim=1)
            w = p * sv[sl].T
            w_hi = bf(w)
            pv = torch.einsum("hk,khd->hd", w_hi, cv[sl])
            if not hi_only:
                pv = pv + torch.einsum("hk,khd->hd", bf(w - w_hi), cv[sl])
            acc = acc * alpha[:, None] + pv
            m = m_new
        out[t] = acc / l[:, None]
    return out


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_tensor_core_quantized_arithmetic_matches_pallas(bits, kernel):
    """The algebra of the tensor-core route on int8 / int4 pools — the
    k-scale folded into S after the code product, the v-scale folded into
    p and the weight carried as two bf16 halves — against the reference's
    Pallas kernel in interpret mode (which dequantizes to f32 and keeps p
    in f32), in f32 within 1e-5 of the output's max-abs; q holds bf16
    values, as the route's q does. With w_lo dropped the same comparison
    fails that bound: the low half is what carries p to f32 accuracy."""
    rng = np.random.default_rng(700 + bits)
    if kernel == "K1":
        args = _case(rng, 8, [37, 60, 5], [(0, 20), (1, 9)], H=2, D=32)
        qb = None
    else:
        args, qb = _qblock_layout_args(
            rng, "rows across splits, dead and narrow", 0)
    q = torch.from_numpy(args[0]).to(torch.bfloat16).float()
    args = (q.numpy(),) + tuple(args[1:])
    args, (ks, vs) = _quant_args(args, bits)
    ref = np.asarray(pak.ragged_paged_attention(
        *[jnp.asarray(a) for a in args], k_scales=jnp.asarray(ks),
        v_scales=jnp.asarray(vs), q_per_slot=qb, interpret=True))
    codes = [torch.from_numpy(c) for c in args[1:3]]
    if bits == 4:
        codes = [trt.unpack_int4(c, axis=-1) for c in codes]
    emu = [_tc_route_emulation(q, *codes, torch.from_numpy(ks),
                               torch.from_numpy(vs), args[3], args[4],
                               args[5], hi_only=h).numpy()
           for h in (False, True)]
    top = np.abs(ref).max()
    err, err_hi = (np.abs(e - ref).max() / top for e in emu)
    assert err <= 1e-5, err
    assert err_hi > 1e-5, err_hi
    assert np.all(emu[0][args[5] == 0] == 0.0)
