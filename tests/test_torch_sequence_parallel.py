"""Sequence parallelism (paddle_tpu_torch/distributed/sequence_parallel.py
and the sp branch of the pipelined GPT) against the JAX package's.

As gloo processes under the port's launcher (tests/torch_hybrid_worker.py
`sp_pipe`, `sp_3d`):

- The pipelined GPT at pp 2 × sp 2 (1F1B, GPipe, per-layer remat, and a
  MoE model of 4 experts at capacity 4.0, so nothing drops) and at pp 2
  × mp 2 × sp 2: three HybridTrainStep steps against the reference's
  TrainStep on its own mesh and at world 1, 1e-5 relative (the
  reference's own tests hold 2e-4; f32 on the CPU, the two frameworks'
  summation orders); the
  no-grad loss equals the training loss; the checkpoint is written by sp
  rank 0 alone and loads at world 1.

The ring and Ulysses attention are held in
tests/test_torch_sequence_ring.py, the sequence-sharded flat
DistributedTrainStep in tests/test_torch_sequence_step.py (split so the
three run on three workers).

In-process: the reference's ValueErrors (pp 1 × sp 2, an indivisible
sequence).
"""
import functools
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as paddle
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.text.models.gpt import GPTConfig as JaxCfg
from paddle_tpu.text.models.gpt_pipeline import (
    PipelinedGPTForCausalLM as JaxPipe)
from paddle_tpu_torch.distributed import mesh as tmesh
from paddle_tpu_torch.text.models.gpt import GPTConfig
from paddle_tpu_torch.text.models.gpt_pipeline import (
    PipelinedGPTForCausalLM)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_hybrid_worker as worker  # noqa: E402

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


TOL = 1e-5


@pytest.fixture(autouse=True)
def _reset():
    tmesh.reset_mesh()
    yield
    tmesh.reset_mesh()
    jmesh.reset_mesh()


# ---- sequence parallelism in the pipelined GPT ----------------------------

CFG = worker.CFG


def _sp_ids():
    return np.random.default_rng(17).integers(0, 256, (8, 16))


def _reference(mesh_kw, ids, steps=3, **kw):
    """(weights, losses, aux, no-grad loss) of the reference's pipelined
    GPT through TrainStep on its own mesh (None: world 1)."""
    jmesh.reset_mesh()
    if mesh_kw is None:
        jmesh.init_mesh(devices=jax.devices()[:1])
    else:
        n = int(np.prod(list(mesh_kw.values())))
        jmesh.init_mesh(devices=jax.devices()[:n], **mesh_kw)
    with jax.default_matmul_precision("highest"):
        paddle.seed(0)
        m = JaxPipe(JaxCfg(**CFG), n_micro=worker.N_MICRO, **kw)
        w = {k: np.array(v.numpy()) for k, v in m.state_dict().items()
             if k != "aux_loss"}
        t = paddle.to_tensor(ids)
        with paddle.no_grad():
            eval_loss = float(m.loss(t).numpy())
        opt = paddle.optimizer.AdamW(worker.LR, parameters=m.parameters())
        step = paddle.jit.TrainStep(m, lambda mm, i: mm.loss(i), opt)
        losses, auxs = [], []
        for _ in range(steps):
            losses.append(float(step(t).numpy()))
            auxs.append(float(m.aux_loss.numpy()) if kw.get("moe_experts")
                        else 0.0)
    jmesh.reset_mesh()
    return w, losses, auxs, eval_loss


@functools.lru_cache(maxsize=None)
def _serial(moe):
    """The reference's world-1 losses (the dense or the MoE model)."""
    return _reference(None, _sp_ids(), **(worker.MOE if moe else {}))[1]


@pytest.fixture(scope="module")
def sp_weights(tmp_path_factory):
    out = tmp_path_factory.mktemp("sp_pipe")
    ids = _sp_ids()
    np.save(out / "sp_ids.npy", ids)
    w, _, _, _ = _reference(None, ids, steps=0)
    np.savez(out / "pipe_weights.npz", **w)
    wm, _, _, _ = _reference(None, ids, steps=0, **worker.MOE)
    np.savez(out / "moe_weights.npz", **wm)
    return out, ids


@pytest.fixture(scope="module")
def sp_job(sp_weights):
    from test_torch_mp_layers import launch_worker

    out, ids = sp_weights
    launch_worker("sp_pipe", out, 4, timeout=300)
    return out, ids, [json.load(open(out / f"sp_pipe_r{r}.json"))
                      for r in range(4)]


def _kw(name):
    return {n: kw for n, _, kw, _ in worker.SP_RUNS}[name]


@pytest.mark.parametrize("name", [n for n, _, _, _ in worker.SP_RUNS])
def test_pp_sp_trajectory_matches_reference(sp_job, name):
    """Each rank's three losses (and the MoE aux) against the reference's
    pp 2 × sp 2 mesh and its world 1; every rank of the mesh reports the
    global loss; the ring ran on every rank."""
    _, ids, res = sp_job
    kw = _kw(name)
    _, want, want_aux, _ = _reference({"pp": 2, "sp": 2}, ids, **kw)
    # at world 1 the schedule and the remat policy do not change the math
    np.testing.assert_allclose(want, _serial(bool(kw.get("moe_experts"))),
                               rtol=TOL)
    for r in res:
        np.testing.assert_allclose(r[name]["losses"], want, rtol=TOL,
                                   err_msg=name)
        if kw.get("moe_experts"):
            np.testing.assert_allclose(r[name]["aux"], want_aux, rtol=TOL)
        assert r[name]["ring"]["ring_p2p"]["calls"] > 0
    assert sorted(tuple(r[name]["coord"]) for r in res) == [
        (0, p, 0, s) for p in (0, 1) for s in (0, 1)]


def test_sp_eval_forward_only(sp_job):
    """The reference's test_sp_eval_forward_only: the no-grad fill-drain
    loss equals the training schedule's, and both equal the reference's
    at the same weights; `forward` runs the whole sequence."""
    out, ids, res = sp_job
    _, _, _, want = _reference({"pp": 2, "sp": 2}, ids, steps=0)
    for r in res:
        assert np.isclose(r["eval/no_grad_loss"], r["eval/grad_loss"],
                          rtol=1e-6)
        np.testing.assert_allclose(r["eval/no_grad_loss"], want, rtol=TOL)
    assert len({round(r["forward/logits_sum"], 3) for r in res}) == 1


def test_sp_checkpoint_written_once_and_loads(sp_job):
    """The sp ranks hold identical shards: only sp rank 0 writes them, and
    the checkpoint loads at world 1 equal to the gathered shards."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed.checkpoint import Checkpointer
    from paddle_tpu_torch.jit import HybridTrainStep
    from paddle_tpu_torch.optimizer import AdamW

    out, _, res = sp_job
    files = os.listdir(out / "sp_ckpt" / "ckpt-00000003" / "shards")
    writers = {int(f.split("#r")[1].split("s")[0]) for f in files}
    sp0 = {rank for rank, r in enumerate(res) if r["pp2sp2"]["coord"][3] == 0}
    assert writers == sp0
    shards = {}
    for rank, r in enumerate(res):
        _, stage, _, s = r["pp2sp2"]["coord"]
        p = dict(np.load(out / f"sp_params_r{rank}.npz"))
        if s == 0:
            shards[(stage, 0)] = p
        else:   # the sp replicas hold the same values
            for n, v in p.items():
                np.testing.assert_array_equal(v, shards[(stage, 0)][n])
    cfg = GPTConfig(**CFG)
    gathered = convert.gather_pipelined_state(shards, cfg, pp=2)
    m = PipelinedGPTForCausalLM(cfg, n_micro=worker.N_MICRO, device="cpu")
    step = HybridTrainStep(m, lambda mm, i: mm.loss(i),
                           AdamW(worker.LR, parameters=m.parameters()))
    assert Checkpointer(str(out / "sp_ckpt"), model=m,
                        train_step=step).load_latest() == worker.STEPS
    for n, p in m.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), gathered[n],
                                      err_msg=n)


def test_pp_mp_sp_trajectory_matches_reference(sp_weights):
    """pp 2 × mp 2 × sp 2 as eight processes against the reference's
    8-device mesh and its world 1."""
    from test_torch_mp_layers import launch_worker

    out, ids = sp_weights
    launch_worker("sp_3d", out, 8, timeout=300)
    res = [json.load(open(out / f"sp_3d_r{r}.json")) for r in range(8)]
    _, want, _, _ = _reference({"pp": 2, "mp": 2, "sp": 2}, ids)
    np.testing.assert_allclose(want, _serial(False), rtol=TOL)
    for r in res:
        np.testing.assert_allclose(r["pp2mp2sp2"]["losses"], want,
                                   rtol=TOL)
    assert len({tuple(r["pp2mp2sp2"]["coord"]) for r in res}) == 8


def test_sp_validation_keeps_the_reference_messages():
    """pp 1 × sp 2 and a sequence indivisible by sp raise the reference's
    ValueErrors (before any collective)."""
    cfg = GPTConfig(**CFG)
    tmesh.init_mesh(sp=2, world_size=2)
    m = PipelinedGPTForCausalLM(cfg, device="cpu")
    with pytest.raises(ValueError, match="needs pp > 1"):
        m.loss(torch.zeros((8, 16), dtype=torch.long))
    tmesh.reset_mesh()
    tmesh.init_mesh(pp=2, sp=2, world_size=4)
    m = PipelinedGPTForCausalLM(cfg, n_micro=2, device="cpu")
    with pytest.raises(ValueError, match="sequence length 17 not divisible "
                       "by sp=2"):
        m.loss(torch.zeros((4, 17), dtype=torch.long))
