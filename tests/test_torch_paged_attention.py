"""Ragged paged attention: the PyTorch port's plain version against the
JAX package's jnp path and its Pallas kernel in interpret mode.

Same inputs (numpy, seeded) through both packages, f32, at the
tolerance the JAX package's own parity tests use (rtol 1e-5, atol 1e-6:
online vs plain softmax differ only in summation order).
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

pytestmark = pytest.mark.torch_port


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
    before = tpa.launches
    ts = [torch.from_numpy(a.copy()) for a in args]
    out = tpa.ragged_paged_attention(*ts)
    ref = tpa.ragged_paged_attention_plain(*ts)
    assert torch.equal(out, ref)
    assert tpa.launches == before   # the CPU path launches no kernel


def test_quantized_pools_not_ported_yet():
    rng = np.random.default_rng(8)
    q, kp, vp, pt, sid, klen = (torch.from_numpy(a.copy()) for a in
                                _case(rng, 16, [5], []))
    sc = torch.ones(kp.shape[:3])
    with pytest.raises(NotImplementedError, match="A4"):
        TF.paged_attention(q, kp, vp, pt, sid, klen, k_scales=sc,
                           v_scales=sc)


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
