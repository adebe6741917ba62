"""The sequence-sharded flat DistributedTrainStep (paddle_tpu_torch/
distributed/parallel_step.py at sp > 1) against the JAX package's.

As gloo processes under the port's launcher (tests/torch_hybrid_worker.py
`seq_step`, 2 ranks at sp 2 and 4 at dp 2 × sp 2): three AdamW steps on
gpt_tiny against the reference's step under batch_specs=[P("dp", "sp")]
on its CPU mesh, losses 1e-5 relative, parameters 1e-4 max-abs (AdamW
magnifies summation noise in small gradients into whole steps), the sp
replicas bit-equal; beside it, the loss each rank's columns alone would
give is not the serial loss. (Split from tests/test_torch_sequence_parallel.py
so the two halves run on two workers.)
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as JP

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.text.models.gpt import GPTConfig as JaxCfg
from paddle_tpu_torch.distributed import mesh as tmesh
from paddle_tpu_torch.text.models.gpt import GPTConfig

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


def _seq_reference(weights, ids, mesh_kw):
    """(losses, {name: parameter}) of the reference's DistributedTrainStep
    with batch_specs=[P("dp", "sp")] on its own CPU mesh: three AdamW
    steps over the global batch."""
    from paddle_tpu.text.models import GPTForCausalLM as JaxGPT
    from paddle_tpu.text.models import GPTPretrainingCriterion as JaxCrit

    jmesh.reset_mesh()
    n = int(np.prod(list(mesh_kw.values())))
    jmesh.init_mesh(devices=jax.devices()[:n], **mesh_kw)
    try:
        with jax.default_matmul_precision("highest"):
            jm = JaxGPT(JaxCfg(**worker.SEQ_CFG))
            jm.set_state_dict({k: paddle.to_tensor(v)
                               for k, v in weights.items()})
            opt = paddle.optimizer.AdamW(worker.LR,
                                         parameters=jm.parameters())
            step = jdist.DistributedTrainStep(
                jm, lambda m, x: JaxCrit()(m(x), x), opt,
                batch_specs=[JP("dp", "sp")])
            t = paddle.to_tensor(ids)
            losses = [float(step(t).numpy()) for _ in range(worker.STEPS)]
        params = {k: np.asarray(v._value, np.float32)
                  for k, v in jm.state_dict().items()}
        return losses, params
    finally:
        jmesh.reset_mesh()


def _seq_ids():
    return np.random.default_rng(3).integers(0, 256, (2, 16))


@pytest.fixture(scope="module")
def seq_weights():
    """The reference gpt_tiny case's weights (2 layers, vocab 256, d 64)."""
    from paddle_tpu.text.models import GPTForCausalLM as JaxGPT

    paddle.seed(0)
    jm = JaxGPT(JaxCfg(**worker.SEQ_CFG))
    return {k: np.array(v.numpy()) for k, v in jm.state_dict().items()}


@pytest.mark.parametrize("world", sorted(worker.SEQ_MESHES))
def test_sequence_sharded_distributed_step_matches_reference(
        tmp_path, seq_weights, world):
    """§0: under batch_specs=[P("dp", "sp")] the reference's GSPMD step
    computes the serial model over the whole sequence. The port's ranks
    of the sp axis each keep their rows' whole sequence, so at sp 2 and
    at dp 2 × sp 2 three AdamW steps give the reference's losses within
    1e-5 relative (the two frameworks' summation orders), and the sp
    replicas' parameters stay bit-equal."""
    from test_torch_mp_layers import launch_worker

    ids = _seq_ids()
    np.savez(tmp_path / "seq_weights.npz", **seq_weights)
    np.save(tmp_path / "seq_ids.npy", ids)
    launch_worker("seq_step", tmp_path, world, timeout=180)
    want, ref_params = _seq_reference(seq_weights, ids,
                                      worker.SEQ_MESHES[world])
    metas = [json.load(open(tmp_path / f"seq{world}_r{r}.json"))
             for r in range(world)]
    params = [dict(np.load(tmp_path / f"seq{world}_r{r}.npz"))
              for r in range(world)]
    for r, m in enumerate(metas):
        np.testing.assert_allclose(m["losses"], want, rtol=TOL,
                                   err_msg=f"rank {r}")
    for r, m in enumerate(metas):
        for q, o in enumerate(metas):
            if o["dp"] == m["dp"] and o["sp"] != m["sp"]:
                for k, v in params[r].items():
                    assert np.array_equal(v, params[q][k]), (r, q, k)
    assert set(params[0]) == set(ref_params)
    for k, v in params[0].items():
        np.testing.assert_allclose(v, ref_params[k], rtol=0, atol=1e-4,
                                   err_msg=k)


def test_sequence_columns_alone_are_not_the_serial_loss():
    """Why the ranks of sp must each run the whole sequence: gpt_tiny's
    serial loss against the mean of its two column halves' losses (each
    half alone: positions from 0, attention cut at the edge, the shift
    losing a position a half) differ by more than 1e-3."""
    from paddle_tpu_torch.text.models.gpt import (GPTForCausalLM,
                                                  GPTPretrainingCriterion)

    model = GPTForCausalLM(GPTConfig(**worker.SEQ_CFG), device="cpu",
                           seed=0)
    crit = GPTPretrainingCriterion()
    ids = torch.as_tensor(_seq_ids())
    with torch.no_grad():
        serial = float(crit(model(ids), ids))
        halves = [float(crit(model(ids[:, c]), ids[:, c]))
                  for c in (slice(0, 8), slice(8, 16))]
    assert abs(np.mean(halves) - serial) > 1e-3, (halves, serial)
