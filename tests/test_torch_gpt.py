"""GPT: the PyTorch port against the JAX package on CPU, with the JAX
model's weights loaded through `load_jax_state_dict`.

Tolerance rtol/atol 1e-4 in f32: the two frameworks sum the matmuls and
reductions in different orders.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.text.models import GPTForCausalLM as JaxGPT
from paddle_tpu.text.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.convert import load_jax_state_dict
from paddle_tpu_torch.distributed.fleet.meta_parallel.mp_layers import (
    split_fused_qkv)
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


TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _serial_mesh():
    from paddle_tpu.distributed import mesh as mesh_mod

    mesh_mod.reset_mesh()
    yield


def _pair(seed=30):
    paddle.seed(seed)
    jm = JaxGPT(jax_gpt_tiny())
    jm.eval()
    arrays = {k: np.array(v.numpy()) for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(gpt_tiny(), device="cpu")
    load_jax_state_dict(tm, arrays)
    return jm, tm, arrays


def test_state_dict_loads_key_for_key_and_copies():
    _, tm, arrays = _pair()
    names = dict(tm.named_parameters())
    assert set(names) == set(arrays)
    for k, a in arrays.items():
        assert tuple(names[k].shape) == a.shape
        np.testing.assert_array_equal(names[k].detach().numpy(), a)
    # a copy, never a view of the caller's array
    w = arrays["gpt.wte.weight"]
    w0 = w[0, 0].copy()
    w[0, 0] += 1.0
    assert names["gpt.wte.weight"][0, 0].item() == pytest.approx(float(w0))


def test_forward_logits_match_jax():
    jm, tm, _ = _pair()
    ids = np.random.default_rng(1).integers(0, 2048, (2, 12))
    ref = jm(paddle.to_tensor(ids)).numpy()
    with torch.no_grad():
        out = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_split_fused_qkv_layout():
    # [b, s, 3·nh·hd] packs (q|k|v) outermost, then heads: a split in
    # another order keeps the shapes, so pin the values
    b, s, nh, hd = 1, 2, 2, 3
    x = torch.arange(b * s * 3 * nh * hd).reshape(b, s, 3 * nh * hd)
    q, k, v = split_fused_qkv(x, b, s, nh, hd)
    assert q.shape == (b, s, nh, hd)
    assert q[0, 0, 1, 0].item() == hd          # q head 1 follows head 0
    assert k[0, 0, 0, 0].item() == nh * hd     # k after all of q
    assert v[0, 1, 0, 0].item() == 3 * nh * hd + 2 * nh * hd


def _tick_inputs():
    """Two ticks of a 2-slot engine with 4-token pages: tick 0 prefills
    slot 0 (7 tokens, crossing into its 2nd page) and slot 1 (3 tokens);
    tick 1 decodes one token per slot. The rest of each tick is padding
    rows. Pools start with random stale content, so unwritten rows are
    not zeros."""
    rng = np.random.default_rng(2)
    P, MP, N = 4, 4, 9
    pt = np.zeros((2, MP), np.int32)
    pt[0, :2] = [5, 3]
    pt[1, :1] = [7]
    pt[0, 2:] = [2, 8]      # stale ids past the live pages
    pt[1, 1:] = [1, 4, 6]

    def rows(slot, positions):
        return [int(pt[slot, p // P]) * P + p % P for p in positions]

    T = 12
    ticks = []
    # tick 0: slot 0 positions 0..6, slot 1 positions 0..2, 2 padding
    tok = rng.integers(0, 2048, (T,)).astype(np.int32)
    pos = np.array(list(range(7)) + list(range(3)) + [0, 0], np.int32)
    sid = np.array([0] * 7 + [1] * 3 + [0, 0], np.int32)
    widx = np.array(rows(0, range(7)) + rows(1, range(3)) + [0, 0],
                    np.int32)
    klen = np.array(list(range(1, 8)) + list(range(1, 4)) + [0, 0],
                    np.int32)
    tok[10:] = 0
    ticks.append((tok, pos, sid, widx, klen, np.array([6, 9], np.int32)))
    # tick 1: one decode token per slot, the rest padding
    tok1 = np.zeros((T,), np.int32)
    tok1[:2] = rng.integers(0, 2048, (2,))
    pos1 = np.zeros((T,), np.int32)
    pos1[:2] = [7, 3]
    sid1 = np.zeros((T,), np.int32)
    sid1[1] = 1
    widx1 = np.zeros((T,), np.int32)
    widx1[:2] = [rows(0, [7])[0], rows(1, [3])[0]]
    klen1 = np.zeros((T,), np.int32)
    klen1[:2] = [8, 4]
    ticks.append((tok1, pos1, sid1, widx1, klen1,
                  np.array([0, 1], np.int32)))
    shape = (N, P, 4, 32)
    pools = [rng.standard_normal(shape).astype(np.float32)
             for _ in range(4)]
    return pt, ticks, pools


def test_paged_decode_core_ticks_match_jax():
    jm, tm, _ = _pair(seed=31)
    pt, ticks, pools = _tick_inputs()
    jkv = [paddle.to_tensor(p) for p in pools]
    tkv = [torch.from_numpy(p.copy()) for p in pools]
    for tick in ticks:
        tok, pos, sid, widx, klen, smp = tick
        jlogits, *jkv = jm._paged_decode_core(
            *[paddle.to_tensor(a) for a in (tok, pos, sid, widx)],
            paddle.to_tensor(pt), paddle.to_tensor(klen),
            paddle.to_tensor(smp), jkv)
        with torch.inference_mode():
            tlogits, *tout = tm._paged_decode_core(
                *[torch.from_numpy(a) for a in (tok, pos, sid, widx)],
                torch.from_numpy(pt), torch.from_numpy(klen),
                torch.from_numpy(smp), tkv)
        assert tlogits.shape == (1, 2, 2048)
        # (logits, *pools) as the reference returns them; the pools are
        # the tensors passed in, updated in place
        assert len(tout) == len(tkv) and all(
            a is b for a, b in zip(tout, tkv))
        np.testing.assert_allclose(tlogits.numpy(), jlogits.numpy(), **TOL)
    for jp, tp in zip(jkv, tkv):   # pools updated in place, same rows
        np.testing.assert_allclose(tp.numpy(), jp.numpy(), **TOL)


def test_default_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTForCausalLM(gpt_tiny())


def test_seeded_init_is_reproducible():
    a = GPTForCausalLM(gpt_tiny(), device="cpu", seed=3)
    b = GPTForCausalLM(gpt_tiny(), device="cpu", seed=3)
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    ln = a.gpt.layers[0].ln1
    assert torch.all(ln.weight == 1) and torch.all(ln.bias == 0)
    assert a.gpt.wte.weight.std().item() == pytest.approx(0.02, rel=0.1)
