"""Flash attention (kernels K3-K5): the PyTorch port's plain versions and
autograd Functions against the JAX package's Pallas kernels in interpret
mode (`_fa_forward`, `_attn_bwd_pallas`, and `jax.vjp` through
`flash_attention_bshd` / `flash_attention_lse_bhd`).

Same inputs (numpy, seeded, cast to float32 explicitly: the test conftest
turns x64 on) through both packages. Tolerances: float32 1e-5 max abs
(online vs plain softmax and the two frameworks' matmuls differ only in
summation order); bfloat16 2e-2 max abs (both round p / ds and the
outputs to bf16, at different running maxima).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas_kernels import flash_attention as jfa
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops.cuda_kernels import flash_attention as tfa

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


TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True)
def _serial_mesh():
    from paddle_tpu.distributed import mesh as mesh_mod

    mesh_mod.reset_mesh()
    yield


def _arrays(rng, n, shape):
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _pair(a, dtype):
    """The same numpy values as a jax array and a torch tensor in
    `dtype` (both round to bf16 to nearest even)."""
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, ref, dtype, what):
    err = np.abs(_np(got) - _np(ref)).max()
    assert err <= TOL[dtype], f"{what}: max abs err {err:.3e}"


# bh, s, d, block (the TPU kernel's tile; s=200 is not a multiple of it)
CASES = [
    pytest.param(3, 200, 16, 128, "float32", False, None, id="f32-s200"),
    pytest.param(3, 200, 16, 128, "float32", True, None,
                 id="f32-s200-causal"),
    pytest.param(3, 200, 16, 128, "float32", False, [200, 0, 57],
                 id="f32-s200-lens0"),
    pytest.param(3, 200, 16, 128, "float32", True, [130, 0, 1],
                 id="f32-s200-causal-lens0"),
    pytest.param(2, 128, 32, 64, "float32", True, None,
                 id="f32-s128-causal"),
    pytest.param(2, 128, 32, 64, "bfloat16", True, None,
                 id="bf16-s128-causal"),
    pytest.param(3, 200, 16, 128, "bfloat16", False, [200, 0, 90],
                 id="bf16-s200-lens0"),
]


@pytest.mark.parametrize("bh,s,d,block,dtype,causal,lens", CASES)
def test_plain_kernels_match_pallas_interpret(bh, s, d, block, dtype,
                                              causal, lens):
    rng = np.random.default_rng(bh * s + d)
    (jq, tq), (jk, tk), (jv, tv), (jg, tg) = (
        _pair(a, dtype) for a in _arrays(rng, 4, (bh, s, d)))
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32)

    out, lse = jfa._fa_forward(jq, jk, jv, causal, block, block, True,
                               lens=jl)
    dq, dk, dv = jfa._attn_bwd_pallas(jq, jk, jv, out, lse, jg, causal,
                                      block, block, True, lens=jl)

    tout, tlse = tfa.flash_forward(tq, tk, tv, causal, tl)
    assert tout.dtype == tq.dtype and tlse.shape == (bh, 1, s)
    _close(tout, out, dtype, "out")
    lse_np = np.asarray(lse)
    live = lse_np > -1e29          # rows with at least one valid key
    np.testing.assert_allclose(_np(tlse)[live], lse_np[live], atol=1e-5)
    np.testing.assert_array_equal(_np(tlse)[~live], lse_np[~live])
    delta = (tg.float() * tout.float()).sum(-1)[:, None, :]
    tdq = tfa.flash_bwd_dq(tq, tk, tv, tg, tlse, delta, causal, tl)
    tdk, tdv = tfa.flash_bwd_dkv(tq, tk, tv, tg, tlse, delta, causal, tl)
    for name, got, ref in (("dq", tdq, dq), ("dk", tdk, dk), ("dv", tdv, dv)):
        _close(got, ref, dtype, name)
    if lens is not None:
        zero = np.asarray(lens) == 0
        for t in (tout, tdq, tdk, tdv):
            assert np.all(_np(t)[zero] == 0.0)     # exact zeros


@pytest.mark.parametrize("causal,kv_lens", [(True, None), (False, [5, 19])])
def test_autograd_bshd_matches_jax_vjp(causal, kv_lens):
    b, s, h, d = 2, 19, 2, 8
    rng = np.random.default_rng(7)
    q, k, v, g = _arrays(rng, 4, (b, s, h, d))
    jl = None if kv_lens is None else jnp.asarray(kv_lens, jnp.int32)

    def ref(q_, k_, v_):
        return jfa.flash_attention_bshd(q_, k_, v_, causal=causal,
                                        block_q=8, block_k=8,
                                        interpret=True, kv_lens=jl)

    out, vjp = jax.vjp(ref, *(jnp.asarray(a) for a in (q, k, v)))
    grads = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tout = tfa.flash_attention_bshd(tq, tk, tv, causal=causal,
                                    kv_lens=kv_lens)
    tout.backward(torch.from_numpy(g))
    _close(tout, out, "float32", "out")
    for name, t, r in zip("qkv", (tq, tk, tv), grads):
        _close(t.grad, r, "float32", f"d{name}")


def test_lse_variant_with_lse_cotangent_matches_jax_vjp():
    bh, s, d = 3, 40, 16
    rng = np.random.default_rng(11)
    q, k, v, g = _arrays(rng, 4, (bh, s, d))
    g_lse = rng.standard_normal((bh, 1, s)).astype(np.float32)

    def ref(q_, k_, v_):
        return jfa.flash_attention_lse_bhd(q_, k_, v_, True, 16, 16, True)

    (out, lse), vjp = jax.vjp(ref, *(jnp.asarray(a) for a in (q, k, v)))
    grads = vjp((jnp.asarray(g), jnp.asarray(g_lse)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tout, tlse = tfa.flash_attention_lse_bhd(tq, tk, tv, causal=True)
    torch.autograd.backward((tout, tlse), (torch.from_numpy(g),
                                           torch.from_numpy(g_lse)))
    _close(tout, out, "float32", "out")
    _close(tlse, lse, "float32", "lse")
    for name, t, r in zip("qkv", (tq, tk, tv), grads):
        _close(t.grad, r, "float32", f"d{name}")


def test_wrappers_run_plain_on_cpu_and_count_no_launch():
    tfa.reset_launches()
    q = torch.randn(2, 9, 8)
    out, lse = tfa.flash_forward(q, q, q, True)
    delta = torch.zeros(2, 1, 9)
    tfa.flash_bwd_dq(q, q, q, q, lse, delta, True)
    tfa.flash_bwd_dkv(q, q, q, q, lse, delta, True)
    assert set(tfa.launches) == set(tfa.REPLACES)
    assert all(n == 0 for n in tfa.launches.values())
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_forward(q.to("meta"), q.to("meta"), q.to("meta"))


@pytest.mark.parametrize("dtype,d,tc", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 128, True),
    *[(torch.float32, d, False) for d in (8, 32, 64, 96, 128, 256)],
    *[(torch.bfloat16, d, False) for d in (8, 32, 96, 256)],
])
def test_tensor_core_route_by_dtype_and_head_dim(dtype, d, tc):
    """bf16 at head_dim 64 / 128 takes the tensor-core K3, K4 and K5; f32
    at any head_dim and bf16 at any other head_dim the CUDA-core
    kernels."""
    assert tfa.tensor_core_route(dtype, d) is tc


def test_tensor_core_counts_stay_zero_on_cpu():
    """A bf16 head_dim-64 CPU tensor (the tensor-core route's inputs) runs
    the plain versions: neither count moves."""
    tfa.reset_launches()
    rng = np.random.default_rng(2)
    q, k, v, g = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in _arrays(rng, 4, (2, 33, 64)))
    out, lse = tfa.flash_forward(q, k, v, True)
    delta = (g.float() * out.float()).sum(-1)[:, None, :]
    tfa.flash_bwd_dkv(q, k, v, g, lse, delta, True)
    tfa.flash_bwd_dq(q, k, v, g, lse, delta, True)
    assert set(tfa.tc_launches) == {"flash_forward", "flash_bwd_dq",
                                    "flash_bwd_dkv"}
    assert all(n == 0 for n in tfa.tc_launches.values())
    assert all(n == 0 for n in tfa.launches.values())


def test_profile_train_names_every_flash_kernel():
    """profile_train names every kernel that csrc/flash_attention.cu
    defines (both routes of K3, K4 and K5), and no symbol is a substring
    of another (the profiler rows match by substring)."""
    import os
    import re

    from paddle_tpu_torch import profile_train
    from paddle_tpu_torch.ops.cuda_kernels import _build

    with open(os.path.join(_build.CSRC, "flash_attention.cu")) as f:
        defined = set(re.findall(r"^(fa_\w+_kernel)\(", f.read(), re.M))
    names = sum(profile_train.FLASH_KERNELS.values(), ())
    assert {"fa_fwd_tc_kernel", "fa_bwd_dq_tc_kernel",
            "fa_bwd_dkv_tc_kernel"} <= defined
    assert profile_train.FLASH_KERNELS["K4"] == ("fa_bwd_dq_kernel",
                                                 "fa_bwd_dq_tc_kernel")
    assert set(names) == defined
    assert set(names) <= set(profile_train.CATEGORIES[0][1])
    assert not any(a != b and a in b for a in names for b in names)


def test_bshd_contract_causal_cross_length_and_kv_lens_clamp():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(_arrays(rng, 1, (2, 6, 2, 8))[0])
    k = torch.from_numpy(_arrays(rng, 1, (2, 7, 2, 8))[0])
    with pytest.raises(ValueError, match="seq_q == seq_k"):
        tfa.flash_attention_bshd(q, k, k, causal=True)
    # a length past seq_k is clamped to seq_k: same as no mask
    full = tfa.flash_attention_bshd(q, k, k)
    over = tfa.flash_attention_bshd(q, k, k, kv_lens=[100, 7])
    np.testing.assert_array_equal(full.numpy(), over.numpy())


@pytest.mark.parametrize("kv_lens", [None, [9, 0]])
def test_sdpa_flash_path_matches_reference_sdpa(kv_lens):
    """F.scaled_dot_product_attention with no mask and no dropout takes
    the flash path (plain versions on CPU); the reference on CPU takes
    its jnp path — both must agree, kv_lens (with a 0 row) included."""
    import paddle_tpu as paddle
    from paddle_tpu.nn import functional as JF

    rng = np.random.default_rng(5)
    q, k, v = _arrays(rng, 3, (2, 9, 2, 8))
    ref = JF.scaled_dot_product_attention(
        *(paddle.to_tensor(a) for a in (q, k, v)), is_causal=True,
        kv_lens=None if kv_lens is None else paddle.to_tensor(
            np.asarray(kv_lens, np.int32))).numpy()
    out = TF.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), is_causal=True,
        kv_lens=None if kv_lens is None else torch.tensor(kv_lens))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_sdpa_dense_path_mask_and_dropout():
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(a) for a in _arrays(rng, 3, (1, 5, 1, 8)))
    mask = torch.ones(5, 5, dtype=torch.bool).tril()
    masked = TF.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    causal = TF.scaled_dot_product_attention(q, k, v, is_causal=True)
    np.testing.assert_allclose(masked.numpy(), causal.numpy(), atol=1e-6)
    # attention dropout draws its keep mask from an explicit generator:
    # the same generator state gives the same output
    outs = [TF.scaled_dot_product_attention(
        q, k, v, dropout_p=0.5, is_causal=True) for _ in range(2)]
    from paddle_tpu_torch.core import rng as trng
    with trng.generator_scope(torch.Generator().manual_seed(1)):
        a = TF.scaled_dot_product_attention(q, k, v, dropout_p=0.5)
    with trng.generator_scope(torch.Generator().manual_seed(1)):
        b = TF.scaled_dot_product_attention(q, k, v, dropout_p=0.5)
    assert torch.equal(a, b)
    assert all(o.shape == (1, 5, 1, 8) for o in outs)
    # eval (training=False) drops nothing
    ev = TF.scaled_dot_product_attention(q, k, v, dropout_p=0.5,
                                         is_causal=True, training=False)
    np.testing.assert_allclose(ev.numpy(), causal.numpy(), atol=1e-6)
