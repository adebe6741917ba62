"""Sequence parallelism (paddle_tpu_torch/distributed/sequence_parallel.py
and the sp branch of the pipelined GPT) against the JAX package's.

As gloo processes under the port's launcher (tests/torch_hybrid_worker.py
`ring`, `sp_pipe`, `sp_3d`):

- `ring_attention`, `ring_flash_attention` (the plain kernels on the CPU)
  and `ulysses_attention` at sp 4 and sp 2, causal and full: each rank's
  output shard and its q / k / v gradients of a probe loss against the
  reference's functions on its own sp mesh (shard_map, Pallas in
  interpret mode), 1e-5; the Ulysses heads check raises the reference's
  ValueError; the sep group of the topology is the ring's group; the
  causal ring skips the blocks above the diagonal.
- The pipelined GPT at pp 2 × sp 2 (1F1B, GPipe, per-layer remat, and a
  MoE model of 4 experts at capacity 4.0, so nothing drops) and at pp 2
  × mp 2 × sp 2: three HybridTrainStep steps against the reference's
  TrainStep on its own mesh and at world 1, 1e-5 relative (the
  reference's own tests hold 2e-4; f32 on the CPU, the two frameworks'
  summation orders); the
  no-grad loss equals the training loss; the checkpoint is written by sp
  rank 0 alone and loads at world 1.

The sequence-sharded flat DistributedTrainStep (`seq_step`, 2 ranks at
sp 2 and 4 at dp 2 × sp 2): three AdamW steps on gpt_tiny against the
reference's step under batch_specs=[P("dp", "sp")] on its CPU mesh,
losses 1e-5 relative, parameters 1e-4 max-abs (AdamW magnifies
summation noise in small gradients into whole steps), the sp replicas
bit-equal; beside it, the loss each rank's columns alone would give is
not the serial loss.

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
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
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

TOL = 1e-5
B, S, H, D = 2, 32, 4, 8


@pytest.fixture(autouse=True)
def _reset():
    tmesh.reset_mesh()
    yield
    tmesh.reset_mesh()
    jmesh.reset_mesh()


# ---- the ring and Ulysses attention -------------------------------------

def _ring_inputs():
    rng = np.random.default_rng(21)
    return {n: rng.standard_normal((B, S, H, D)).astype(np.float32)
            for n in ("q", "k", "v", "w")}


def _reference_ring(a, sp, fn, causal):
    """(out, dq, dk, dv) of the reference's `fn` on its sp mesh."""
    jmesh.reset_mesh()
    jmesh.init_mesh(devices=jax.devices()[:sp], sp=sp)
    f = jdist.spmd(lambda q, k, v: getattr(jdist, fn)(q, k, v,
                                                      causal=causal),
                   in_specs=(JP(None, "sp"),) * 3, out_specs=JP(None, "sp"),
                   group_axes=("sp",))
    w = jnp.asarray(a["w"])

    @jax.jit
    def out_and_grads(q, k, v):
        out, vjp = jax.vjp(f, q, k, v)
        return (out,) + vjp(w)

    with jax.default_matmul_precision("highest"):
        got = out_and_grads(*(jnp.asarray(a[n]) for n in ("q", "k", "v")))
    jmesh.reset_mesh()
    return [np.asarray(g) for g in got]


@pytest.fixture(scope="module")
def ring_job(tmp_path_factory):
    from test_torch_mp_layers import launch_worker

    out = tmp_path_factory.mktemp("ring")
    a = _ring_inputs()
    np.savez(out / "ring_inputs.npz", **a)
    launch_worker("ring", out, 4, timeout=240)
    arrays = [dict(np.load(out / f"ring_r{r}.npz")) for r in range(4)]
    meta = [json.load(open(out / f"ring_r{r}.json")) for r in range(4)]
    return a, arrays, meta


@pytest.mark.parametrize("fn", worker.RING_FNS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("run", [name for name, _ in worker.RING_RUNS])
def test_ring_matches_reference(ring_job, run, causal, fn):
    a, arrays, meta = ring_job
    sp = dict(worker.RING_RUNS)[run]["sp"]
    want = _reference_ring(a, sp, fn, causal)
    s_loc = S // sp
    for rank in range(4):
        idx = meta[rank][run]["idx"]
        cols = slice(idx * s_loc, (idx + 1) * s_loc)
        key = f"{run}/{fn}/{int(causal)}"
        for name, w in zip(("out", "dq", "dk", "dv"), want):
            np.testing.assert_allclose(arrays[rank][f"{key}/{name}"],
                                       w[:, cols], rtol=TOL, atol=TOL,
                                       err_msg=f"rank {rank} {key}/{name}")


@pytest.mark.parametrize("run", [name for name, _ in worker.RING_RUNS])
def test_ring_blocks_heads_check_and_sep_group(ring_job, run):
    """Per rank and forward: 2 calls each of the dense and the flash ring
    (full, causal); the causal ring runs its diagonal block causal, the
    blocks below it full and skips the ones above; Ulysses' heads check
    is the reference's message; the sep group is the ring's group."""
    _, _, meta = ring_job
    sp = dict(worker.RING_RUNS)[run]["sp"]
    for rank in range(4):
        m = meta[rank][run]
        idx, st = m["idx"], m["stats"]
        # two ring functions x (full + causal): full sees sp full blocks
        assert st["causal"]["calls"] == 2
        assert st["full"]["calls"] == 2 * (sp + idx)
        assert st.get("skipped", {}).get("calls", 0) == 2 * (sp - 1 - idx)
        # K/V frames: sp - 1 forward, sp - 1 backward per call
        assert st["ring_p2p"]["calls"] == 4 * 2 * (sp - 1)
        assert m["ulysses_error"] == (f"heads {sp + 1} not divisible by "
                                      f"sp degree {sp}")
        sep = m["sep"]
        assert sep["axes"] == ["sp"] and sep["nranks"] == sp
        assert sep["rank"] == idx and sep["ring"][idx] == rank


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
