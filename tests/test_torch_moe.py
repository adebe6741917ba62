"""Mixture-of-experts (paddle_tpu_torch/distributed/moe.py, the MoE
branch of text/models/gpt_pipeline.py, the pipeline's aux channel, the
facades and distributed.utils) against the JAX package's.

Routing: `switch_dispatch`, `topk_rounds` and `topk_pack_dispatch` on the
same probabilities give the reference's dispatch and combine tensors
exactly (the same expert for every token, the same kept set, the same
slots); `moe_dispatch_combine` and `MoELayer` (top-1 and top-2, the
reference's weights carried by `convert`) its outputs within 1e-5, its
aux within 1e-6 and its gradients within 1e-5. The pipelined MoE GPT at
world 1, top-1 and top-2, with a capacity factor that drops tokens and
one that does not: three TrainStep steps' losses and aux, and step 0's
gradients, against the reference. As gloo processes (tests/
torch_hybrid_worker.py `moe`, four ranks): pp 2 x ep 2 and ep 2 x dp 2
against the reference on its own meshes, three-step trajectories within
1e-5 (lossless capacity, where the grouped routing keeps the serial
token set); each rank holds E/ep experts; a pp x ep checkpoint loads at
world 1 equal to the gathered shards.

Tolerances: f32 on the CPU, the reference's matmuls at "highest"
precision; the two frameworks sum in different orders (1e-5 relative on
losses, 1e-5 of each gradient's max-abs).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed import moe as jmoe
from paddle_tpu.text.models.gpt import GPTConfig as JaxCfg
from paddle_tpu.text.models.gpt_pipeline import (
    PipelinedGPTForCausalLM as JaxPipe)
from paddle_tpu_torch import convert
from paddle_tpu_torch.distributed import mesh as tmesh
from paddle_tpu_torch.distributed import moe as tmoe
from paddle_tpu_torch.jit import HybridTrainStep, TrainStep
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.text.models.gpt import GPTConfig
from paddle_tpu_torch.text.models.gpt_pipeline import (
    PipelinedGPTForCausalLM)

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


CFG = dict(vocab_size=256, hidden_size=64, num_layers=4, num_heads=4,
           max_seq_len=32)
MOE = dict(moe_experts=4, moe_hidden=64)
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _reset():
    tmesh.reset_mesh()
    yield
    tmesh.reset_mesh()
    jmesh.reset_mesh()


def _probs(seed, t=48, E=4, ties=False):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((t, E)).astype(np.float32)
    if ties:
        # exact ties: both argmaxes take the first maximal index
        logits[::5, 1] = logits[::5, 2] = 3.0
    p = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))
    return p


# ---- routing ----

@pytest.mark.parametrize("capacity,ties", [(6, False), (16, False),
                                           (4, True)])
def test_switch_dispatch_matches_reference(capacity, ties):
    p = _probs(1, ties=ties)
    want = jmoe.switch_dispatch(jnp.asarray(p), 4, capacity, jnp.float32)
    got = tmoe.switch_dispatch(torch.from_numpy(p), 4, capacity,
                               torch.float32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("topk", [1, 2, 3])
def test_topk_rounds_and_pack_dispatch_match_reference(topk):
    p = _probs(2)
    for g, w in zip(tmoe.topk_rounds(torch.from_numpy(p), topk),
                    jmoe.topk_rounds(jnp.asarray(p), topk)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want = jmoe.topk_pack_dispatch(jnp.asarray(p), 4, 7, jnp.float32, topk)
    got = tmoe.topk_pack_dispatch(torch.from_numpy(p), 4, 7,
                                  torch.float32, topk)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=0,
                               atol=1e-6)


def test_capacities_and_the_reference_asymmetry():
    """moe_a2a_capacity's rounding, and the two callers' capacities:
    moe_dispatch_combine (MoELayer) passes cf, moe_a2a_dispatch_combine
    and the pipelined GPT's _moe_ffn pass cf·topk."""
    for args in ((48, 1, 4, 1.25), (48, 2, 4, 1.25), (7, 1, 8, 0.1),
                 (512, 8, 8, 1.25), (2048, 1, 8, 2.5)):
        assert tmoe.moe_a2a_capacity(*args) == jmoe.moe_a2a_capacity(*args)
    seen = {}

    def spy(mod, name):
        real = getattr(mod, name)

        def f(tokens, ep, E, cf):
            seen.setdefault(mod.__name__, []).append(cf)
            return real(tokens, ep, E, cf)
        return f

    x = np.random.default_rng(3).standard_normal((16, 8)).astype(np.float32)
    logits = np.random.default_rng(4).standard_normal((16, 4)).astype(
        np.float32)
    orig = tmoe.moe_a2a_capacity
    tmoe.moe_a2a_capacity = spy(tmoe, "moe_a2a_capacity")
    try:
        tmoe.moe_dispatch_combine(torch.from_numpy(x), torch.from_numpy(
            logits), lambda e: e, 4, capacity_factor=1.5, topk=2)
        m = PipelinedGPTForCausalLM(GPTConfig(**CFG), moe_topk=2,
                                    moe_capacity_factor=1.5, device="cpu",
                                    **MOE)
        with torch.no_grad():
            m.loss(torch.zeros((8, 16), dtype=torch.long))
    finally:
        tmoe.moe_a2a_capacity = orig
    assert seen[tmoe.__name__][0] == 1.5
    assert set(seen[tmoe.__name__][1:]) == {3.0}


def _expert_fn_jax(w1, b1, w2, b2):
    def f(e):
        h = jax.nn.gelu(jnp.einsum("ecd,edh->ech", e, w1) + b1)
        return jnp.einsum("ech,ehd->ecd", h, w2) + b2
    return f


def _expert_fn_torch(w1, b1, w2, b2):
    return lambda e: tmoe.expert_ffn(
        e, w1, b1, w2, b2,
        lambda h: torch.nn.functional.gelu(h, approximate="tanh"))


@pytest.mark.parametrize("topk,cf", [(1, 1.25), (2, 1.25), (2, 4.0)])
def test_moe_dispatch_combine_matches_reference(topk, cf):
    rng = np.random.default_rng(5)
    t, d, E, dh = 40, 16, 4, 24
    arrs = [rng.standard_normal(s).astype(np.float32) * 0.3 for s in
            ((t, d), (t, E), (E, d, dh), (E, 1, dh), (E, dh, d),
             (E, 1, d))]

    def jfn(x, g, w1, b1, w2, b2):
        out, aux = jmoe.moe_dispatch_combine(
            x, g, _expert_fn_jax(w1, b1, w2, b2), E, capacity_factor=cf,
            topk=topk)
        return jnp.sum(out * jnp.cos(out)) + 0.5 * aux, (out, aux)

    (_, (w_out, w_aux)), w_grads = jax.value_and_grad(
        jfn, argnums=tuple(range(6)), has_aux=True)(
            *[jnp.asarray(a) for a in arrs])
    ts = [torch.tensor(a, requires_grad=True) for a in arrs]
    out, aux = tmoe.moe_dispatch_combine(
        ts[0], ts[1], _expert_fn_torch(*ts[2:]), E, capacity_factor=cf,
        topk=topk)
    ((out * torch.cos(out)).sum() + 0.5 * aux).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(w_out),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(w_aux), rtol=0, atol=1e-6)
    for g, w in zip(ts, w_grads):
        w = np.asarray(w)
        np.testing.assert_allclose(g.grad.numpy(), w, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("topk", [1, 2])
def test_moe_layer_matches_reference(topk):
    """MoELayer with the reference's weights: outputs, aux_loss and every
    gradient."""
    paddle.seed(3)
    ref = jmoe.MoELayer(16, 32, 4, topk=topk, capacity_factor=1.25)
    w = {k: np.array(v.numpy()) for k, v in ref.state_dict().items()}
    layer = tmoe.MoELayer(16, 32, 4, topk=topk, capacity_factor=1.25,
                          device="cpu")
    convert.load_jax_state_dict(layer, w)
    x = np.random.default_rng(6).standard_normal((2, 12, 16)).astype(
        np.float32)
    y_ref = ref(paddle.to_tensor(x))
    (y_ref * y_ref).sum().backward()
    y = layer(torch.from_numpy(x))
    (y * y).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), y_ref.numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(float(layer.aux_loss),
                               float(np.asarray(ref.aux_loss)), rtol=0,
                               atol=1e-6)
    for n, p in ref.named_parameters():
        want = np.asarray(p.grad.numpy())
        got = dict(layer.named_parameters())[n].grad.numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(
            1.0, np.abs(want).max()), err_msg=n)
    assert tuple(layer.w1._pspec) == ("ep", None, None)


# ---- the pipelined MoE GPT at world 1 ----

def _ids(seed=0):
    return np.random.default_rng(seed).integers(0, 256, (8, 16))


def _jit_grads(m, t):
    """{name: gradient} of the reference's `m.loss(t)`, taken under one
    `jax.jit` (its eager tape compiles a program an op, which a cold
    compile cache pays op by op); the model's state is left as it was."""
    params = list(m.named_parameters())
    bufs = list(m.named_buffers())

    def pure(vals):
        held = [p._value for _, p in params]
        held_b = [b._value for _, b in bufs]
        for (_, p), v in zip(params, vals):
            p._value = v
        try:
            return m.loss(t)._value
        finally:
            for (_, p), v in zip(params, held):
                p._value = v
            for (_, b), v in zip(bufs, held_b):
                b._value = v

    grads = jax.jit(jax.grad(pure))([p._value for _, p in params])
    return {n: np.asarray(g) for (n, _), g in zip(params, grads)}


def _reference(ids, steps=3, **kw):
    """(weights, step-0 gradients, losses, aux per step) of the
    reference's MoE GPT at world 1."""
    jmesh.reset_mesh()
    jmesh.init_mesh(devices=jax.devices()[:1])
    with jax.default_matmul_precision("highest"):
        paddle.seed(0)
        m = JaxPipe(JaxCfg(**CFG), n_micro=4, **MOE, **kw)
        w = {k: np.array(v.numpy()) for k, v in m.state_dict().items()}
        t = paddle.to_tensor(ids)
        grads = _jit_grads(m, t)
        opt = paddle.optimizer.AdamW(1e-3, parameters=m.parameters())
        step = paddle.jit.TrainStep(m, lambda mm, i: mm.loss(i), opt)
        losses, auxs = [], []
        for _ in range(steps):
            losses.append(float(step(t).numpy()))
            auxs.append(float(m.aux_loss.numpy()))
    jmesh.reset_mesh()
    return w, grads, losses, auxs


@pytest.mark.parametrize("topk,cf", [(1, 1.25), (1, 4.0), (2, 1.25)])
def test_pipelined_moe_world_one_matches_reference(topk, cf):
    """Loss, aux and gradients at world 1: cf 1.25 drops tokens (the
    capacity is ceil(32·cf·k/4) per micro of 32 tokens), cf 4.0 keeps
    every one (top-2 at cf 4.0 runs in the ep 2 x dp 2 job below)."""
    ids = _ids(7)
    w, grads, losses, auxs = _reference(ids, moe_topk=topk,
                                        moe_capacity_factor=cf)
    m = PipelinedGPTForCausalLM(GPTConfig(**CFG), n_micro=4, moe_topk=topk,
                                moe_capacity_factor=cf, device="cpu",
                                **MOE).load_logical(w)
    assert not hasattr(m, "stk_fc1_w")
    m.loss(torch.as_tensor(ids)).backward()
    for n, p in m.named_parameters():
        want = grads[n]
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=1e-5 * max(1e-3, np.abs(want).max()),
                                   err_msg=n)
    m.zero_grad(set_to_none=True)
    step = HybridTrainStep(m, lambda mm, i: mm.loss(i),
                           AdamW(1e-3, parameters=m.parameters()))
    got, got_aux = [], []
    for _ in range(3):
        got.append(float(step(torch.as_tensor(ids))))
        got_aux.append(float(m.aux_loss))
    np.testing.assert_allclose(got, losses, rtol=RTOL)
    np.testing.assert_allclose(got_aux, auxs, rtol=RTOL)
    assert got[-1] < got[0]


# ---- as gloo processes: pp 2 x ep 2 and ep 2 x dp 2 ----

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_hybrid_worker as worker  # noqa: E402


def _reference_on_mesh(ids, mesh_kw, **kw):
    """The reference's losses and aux on its own 4-device mesh (pp > 1:
    the 1F1B shard_map with the token all-to-all; pp 1: the degenerate
    path, which routes the whole micro-batch on every device)."""
    jmesh.reset_mesh()
    jmesh.init_mesh(devices=jax.devices()[:4], **mesh_kw)
    with jax.default_matmul_precision("highest"):
        paddle.seed(0)
        m = JaxPipe(JaxCfg(**CFG), n_micro=worker.N_MICRO, **worker.MOE,
                    **kw)
        opt = paddle.optimizer.AdamW(worker.LR, parameters=m.parameters())
        step = paddle.jit.TrainStep(m, lambda mm, i: mm.loss(i), opt)
        t = paddle.to_tensor(ids)
        losses, auxs = [], []
        for _ in range(worker.STEPS):
            losses.append(float(step(t).numpy()))
            auxs.append(float(m.aux_loss.numpy()))
    jmesh.reset_mesh()
    return losses, auxs


@pytest.fixture(scope="module")
def moe_job(tmp_path_factory):
    from test_torch_mp_layers import launch_worker

    out = tmp_path_factory.mktemp("moe")
    ids = _ids(13)
    w, _, _, _ = _reference(ids, steps=0, moe_capacity_factor=4.0)
    np.savez(out / "moe_weights.npz", **w)
    np.save(out / "moe_ids.npy", ids)
    launch_worker("moe", out, 4, timeout=300)
    res = [json.load(open(out / f"moe_r{r}.json")) for r in range(4)]
    jmesh.reset_mesh()
    return out, ids, w, res


@pytest.mark.parametrize("name", [n for n, _, _ in worker.MOE_RUNS])
def test_moe_meshes_match_reference(moe_job, name):
    """Each rank's three-step losses (and aux) against the reference on
    its own mesh; each rank holds E/ep = 2 experts; at pp 2 x ep 2 the
    all-to-all ran (2 rounds of dispatch + combine per layer, forward and
    recompute and backward)."""
    _, ids, _, res = moe_job
    mesh, kw = {n: (m, k) for n, m, k in worker.MOE_RUNS}[name]
    want, want_aux = _reference_on_mesh(ids, mesh, **kw)
    for r in res:
        np.testing.assert_allclose(r[name]["losses"], want, rtol=RTOL)
        np.testing.assert_allclose(r[name]["aux"], want_aux, rtol=RTOL)
        assert r[name]["experts"] == 2
        assert r[name]["alltoall"]["calls"] > 0
    assert sorted(tuple(r[name]["coord"]) for r in res) == sorted(
        {"pp2ep2": [(0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1)],
         "ep2dp2": [(0, 0, 0), (0, 0, 1), (1, 0, 0), (1, 0, 1)]}[name])


def test_pp_ep_checkpoint_loads_at_world_one(moe_job):
    """The pp 2 x ep 2 job's checkpoint (each rank's shards in logical
    coordinates) loads into a world-1 model equal to the gathered
    shards."""
    from paddle_tpu_torch.distributed.checkpoint import Checkpointer

    out, _, _, res = moe_job
    shards = {}
    for rank, r in enumerate(res):
        _, stage, e = r["pp2ep2"]["coord"]
        shards[(stage, 0, e)] = dict(np.load(out / f"moe_params_r{rank}.npz"))
    cfg = GPTConfig(**CFG)
    gathered = convert.gather_pipelined_state(shards, cfg, pp=2, ep=2)
    m = PipelinedGPTForCausalLM(cfg, n_micro=worker.N_MICRO, device="cpu",
                                **worker.MOE)
    step = HybridTrainStep(m, lambda mm, i: mm.loss(i),
                           AdamW(worker.LR, parameters=m.parameters()))
    got = Checkpointer(str(out / "ckpt"), model=m,
                       train_step=step).load_latest()
    assert got == worker.STEPS
    for n, p in m.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), gathered[n],
                                      err_msg=n)
    # the cut and the gather are inverse at pp x mp x ep
    w = {k: v for k, v in moe_job[2].items() if k != "aux_loss"}
    cut = {(s, r, e): convert.cut_pipelined_state(w, cfg, 2, 2, s, r,
                                                  ep=2, ep_rank=e)
           for s in range(2) for r in range(2) for e in range(2)}
    assert cut[(0, 1, 1)]["stk_moe_w1"].shape == (2, 2, 64, 64)
    assert cut[(1, 0, 0)]["stk_gate_w"].shape == (2, 64, 4)
    back = convert.gather_pipelined_state(cut, cfg, 2, 2, ep=2)
    for k in w:
        np.testing.assert_array_equal(back[k], w[k], err_msg=k)
    with pytest.raises(ValueError, match="MoE"):
        convert.pipelined_to_gpt_state(w, cfg)


# ---- validation, the eager dispatch API, the facades ----

def test_moe_experts_not_divisible_by_ep_raises():
    tmesh.init_mesh(pp=2, ep=4, world_size=8)
    with pytest.raises(ValueError, match="moe_experts=6 not divisible by "
                       "ep=4"):
        PipelinedGPTForCausalLM(GPTConfig(**CFG), moe_experts=6,
                                device="cpu")
    tmesh.reset_mesh()
    with pytest.raises(ValueError, match="ep=2"):
        # the token exchange needs its ep ranks as processes
        tmoe.moe_a2a_dispatch_combine(torch.zeros(8, 4), torch.zeros(4, 4),
                                      lambda e: e, 4, 2)
    with pytest.raises(ValueError, match="num_experts=3 not divisible"):
        tmoe.moe_a2a_dispatch_combine(torch.zeros(8, 4), torch.zeros(4, 3),
                                      lambda e: e, 3, 2)
    with pytest.raises(ValueError, match="token count 7 not divisible"):
        tmoe.moe_a2a_dispatch_combine(torch.zeros(7, 4), torch.zeros(4, 4),
                                      lambda e: e, 4, 2)


def test_global_scatter_gather_match_reference():
    from paddle_tpu.distributed import utils as jutils
    from paddle_tpu_torch.distributed import utils as tutils

    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    for lc, gc in (([2, 4], [3, 3]), ([2, 3], [2, 3]), ([1, 5], [1, 5])):
        outs = []
        for fn, mk in ((jutils.global_scatter, paddle.to_tensor),
                       (tutils.global_scatter, torch.as_tensor)):
            try:
                outs.append(np.asarray(fn(mk(x), mk(np.array(lc)),
                                          mk(np.array(gc))).numpy()))
            except ValueError as e:
                outs.append(str(e))
        assert type(outs[0]) is type(outs[1])
        if isinstance(outs[0], str):
            assert outs[0] == outs[1]
        else:
            np.testing.assert_array_equal(outs[0], outs[1])
    for gc in ([3, 3], [2, 2]):
        msgs = []
        for fn, mk in ((jutils.global_gather, paddle.to_tensor),
                       (tutils.global_gather, torch.as_tensor)):
            try:
                fn(mk(x), mk(np.array([3, 3])), mk(np.array(gc)))
                msgs.append(None)
            except ValueError as e:
                msgs.append(str(e))
        assert msgs[0] == msgs[1]
    assert len(tutils.find_free_ports(3)) == 3
    log = tutils.get_logger("INFO", name="pt_moe_test")
    assert log.level == 20 and log.handlers


def test_facades_reexport_the_moe_module():
    import paddle_tpu_torch.distributed as tdist
    from paddle_tpu_torch.distributed.models import moe as dm
    from paddle_tpu_torch.incubate.distributed.models import moe as im

    for name in dm.__all__:
        assert getattr(dm, name) is getattr(tmoe, name)
        assert getattr(im, name) is getattr(tmoe, name)
    assert tdist.moe is tmoe
    assert set(dm.__all__) == set(
        __import__("paddle_tpu.distributed.models.moe",
                   fromlist=["x"]).__all__)
