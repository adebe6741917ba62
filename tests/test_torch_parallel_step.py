"""DistributedTrainStep, ZeRO and the fleet facade (paddle_tpu_torch/
distributed/parallel_step.py, sharding.py, fleet/) against the JAX
package's.

World 1: the port's DistributedTrainStep (plain and at every ZeRO level)
equals its TrainStep bit for bit. Two launched gloo processes
(tests/torch_dist_worker.py `train`, one launch for every case) run
gpt_tiny from the JAX model's weights on the global batch for 3 steps:
dp 2; ZeRO os / os_g / p_g_os over a sharding axis of 2; `fleet.init`
→ `distributed_optimizer` with the lars and dgc strategies at dp 2. Each
is held against the reference's DistributedTrainStep on a 2-device CPU
mesh over the same weights and batch. Tolerances, each with its reason:

* losses 1e-5 relative — the frameworks sum matmuls and reductions in
  different orders, and the port averages two half-batch losses and
  gradients where the reference reduces over the whole batch;
* parameters after 3 steps 1e-4 max-abs (AdamW; Adam normalises each
  update to ~lr = 1e-3, so summation noise in a small gradient element
  is magnified into its step — test_torch_train's bound), 1e-5 for the
  momentum optimizers (their steps scale with the gradient itself).

A ZeRO checkpoint written by both ranks (each rank its blocks of the
moments) reassembles at world 1 into a step that continues exactly as
the 2-rank run's full state would.
"""
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as paddle
from paddle_tpu import distributed as jdist
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.text.models import GPTForCausalLM as JaxGPT
from paddle_tpu.text.models import GPTPretrainingCriterion as JaxCrit
from paddle_tpu.text.models.gpt import gpt_tiny as jax_gpt_tiny
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch.core import rng as trng
from paddle_tpu_torch.distributed import mesh as tmesh
from paddle_tpu_torch.distributed.checkpoint import Checkpointer
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.optimizer import AdamW

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_worker as worker  # noqa: E402

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


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT_S = 150
WEIGHT_SEED = 40


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env["PT_CKPT_FSYNC"] = "0"
    env.pop("PT_CHAOS_PLAN", None)
    return env


def launch(mode, out, nproc, extra=(), timeout=LAUNCH_TIMEOUT_S):
    """Run the worker under the port's launcher in a session of its own;
    on a timeout SIGTERM the launcher (it kills its pod), then fail."""
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           f"--nproc_per_node={nproc}", f"--log_dir={out}/log", *extra,
           os.path.join(ROOT, "tests", "torch_dist_worker.py"), mode,
           str(out)]
    p = subprocess.Popen(cmd, env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True,
                         start_new_session=True)
    try:
        so, se = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGTERM)
        so, se = p.communicate(timeout=30)
        pytest.fail(f"launch {mode} timed out after {timeout} s\n{so}\n{se}")
    return p.returncode, so, se


def reference_weights(out):
    """The JAX gpt_tiny's weights and a seeded global batch, written for
    the worker; returns (weights, ids)."""
    paddle.seed(WEIGHT_SEED)
    jm = JaxGPT(jax_gpt_tiny())
    w = {k: np.array(v.numpy()) for k, v in jm.state_dict().items()}
    ids = np.random.default_rng(0).integers(0, 2048, (4, 32)).astype(
        np.int64)
    np.savez(os.path.join(out, "weights.npz"), **w)
    np.save(os.path.join(out, "ids.npy"), ids)
    return w, ids


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    out = tmp_path_factory.mktemp("train")
    w, ids = reference_weights(str(out))
    # a world-1 checkpoint after 3 steps, for the workers to restore
    # into a 2-rank ZeRO step, and the loss of the 4th step
    tmesh.reset_mesh()
    m, _, step = _world1_step(w)
    for _ in range(3):
        step(torch.from_numpy(ids))
    Checkpointer(str(out / "ckpt_world1"), model=m, train_step=step).save(3)
    next_loss = float(step(torch.from_numpy(ids)))
    rc, so, se = launch("train", out, 2)
    assert rc == 0, f"{so}\n{se}"
    res = [json.load(open(out / f"train_r{r}.json")) for r in range(2)]
    for r in res:
        r["world1/next_loss"] = next_loss
    return out, w, ids, res


def _jax_run(name, w, ids):
    """The reference's DistributedTrainStep on a 2-device CPU mesh:
    (losses, {name: final parameter})."""
    _, mesh, zero, strat = next(c for c in worker.TRAIN_CONFIGS
                                if c[0] == name)
    jmesh.reset_mesh()
    jmesh.init_mesh(devices=jax.devices()[:2], **mesh)
    try:
        jm = JaxGPT(jax_gpt_tiny())
        jm.set_state_dict({k: paddle.to_tensor(v) for k, v in w.items()})
        if strat is None:
            opt = paddle.optimizer.AdamW(1e-3, parameters=jm.parameters())
        else:
            opt = paddle.optimizer.Momentum(1e-2,
                                            parameters=jm.parameters())
            st = jfleet.DistributedStrategy()
            st.hybrid_configs["dp_degree"] = mesh["dp"]
            setattr(st, strat, True)
            opt = jfleet.distributed_optimizer(opt, strategy=st)
        step = jdist.DistributedTrainStep(
            jm, lambda m, x: JaxCrit()(m(x), x), opt, zero_level=zero)
        t = paddle.to_tensor(ids)
        losses = [float(step(t).numpy()) for _ in range(worker.TRAIN_STEPS)]
        params = {k: np.asarray(v._value, np.float32)
                  for k, v in jm.state_dict().items()}
        return losses, params
    finally:
        jmesh.reset_mesh()


@pytest.mark.parametrize("name", [c[0] for c in worker.TRAIN_CONFIGS])
def test_two_rank_step_matches_reference(trained, name):
    out, w, ids, res = trained
    jl, jp = _jax_run(name, w, ids)
    for r in range(2):
        np.testing.assert_allclose(res[r][f"{name}/losses"], jl, rtol=1e-5)
    # the ranks agree exactly: one averaged gradient, one update
    assert res[0][f"{name}/losses"] == res[1][f"{name}/losses"]
    tp = dict(np.load(out / f"params_{name}.npz"))
    assert set(tp) <= set(jp) and len(tp) > 10
    atol = 1e-5 if name.startswith("fleet") else 1e-4
    for k, v in tp.items():
        np.testing.assert_allclose(v, jp[k], rtol=0, atol=atol,
                                   err_msg=f"{name} {k}")


def test_zero_blocks_and_fleet_wiring(trained):
    """os_g keeps each moment's block of the largest divisible dimension
    (wte [2048, 128] → [1024, 128]); p_g_os holds parameter blocks
    between steps; fleet builds the dp 2 HCG and swaps the optimizer."""
    _, _, _, res = trained
    for r in range(2):
        shapes = res[r]["zero_os_g/moment_shapes"]
        assert "(1024, 128)" in shapes and "(2048, 128)" not in shapes
        blocks = res[r]["zero_p_g_os/block_shapes"]
        assert blocks["gpt.wte.weight"] == [1024, 128]
        assert blocks["gpt.layers.0.fc1.weight"] == [128, 256]
        assert res[r]["fleet_lars/optimizer"] == "LarsMomentum"
        assert res[r]["fleet_dgc/optimizer"] == "DGCMomentum"
        assert res[r]["fleet_lars/hcg"] == [2, r]


def _world1_step(w, zero=None):
    m = worker._model(w)
    opt = AdamW(1e-3, parameters=m.named_parameters())
    return m, opt, tdist.DistributedTrainStep(m, worker._loss_fn, opt,
                                              zero_level=zero)


def test_zero_checkpoint_reassembles_at_world_one(trained):
    """Both ranks wrote their blocks of the moments (and rank 0 the
    replicated parameters) into one checkpoint: it loads into a world-1
    step, whose parameters equal the 2-rank run's and whose next step
    matches a world-1 run of 4 steps (1e-5 relative: the 2-rank
    trajectory's summation order)."""
    out, w, ids, _ = trained
    tmesh.reset_mesh()
    ck_dir = out / "ckpt_zero"
    meta = json.load(open(ck_dir / "ckpt-00000003" / "meta.json"))
    assert meta["commit"]["world"] == 2
    assert (ck_dir / "ckpt-00000003" / "DONE.0").is_file()
    assert (ck_dir / "ckpt-00000003" / "DONE.1").is_file()
    m1 = {e["path"]: e for e in meta["leaves"]}[
        "train_step_opt/gpt.wte.weight/moment1"]
    assert sorted(s["index"][0] for s in m1["shards"]) == [[0, 1024],
                                                          [1024, 2048]]
    assert {s["file"].split("#")[1] for s in m1["shards"]} == {"r0s0.npy",
                                                              "r1s0.npy"}
    m, opt, step = _world1_step(w)
    ck = Checkpointer(str(ck_dir), model=m, train_step=step)
    assert ck.load_latest() == 3 and opt._step_count == 3
    tp = dict(np.load(out / "params_zero_os_g.npz"))
    for n, p in m.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), tp[n])
    assert opt._states[id(m.gpt.wte.weight)]["moment1"].shape == (2048, 128)
    resumed = float(step(torch.from_numpy(ids)))
    _, _, ref = _world1_step(w)
    for _ in range(3):
        ref(torch.from_numpy(ids))
    np.testing.assert_allclose(resumed, float(ref(torch.from_numpy(ids))),
                               rtol=1e-5)


def test_p_g_os_checkpoint_writes_parameter_blocks(trained):
    """At p_g_os each rank writes its parameter blocks; loaded at world 1
    they are the whole parameters the 2-rank run ended with."""
    out, w, _, _ = trained
    tmesh.reset_mesh()
    ck_dir = out / "ckpt_p_g_os"
    meta = json.load(open(ck_dir / "ckpt-00000003" / "meta.json"))
    wte = {e["path"]: e for e in meta["leaves"]}["model/gpt.wte.weight"]
    assert len(wte["shards"]) == 2
    m, _, step = _world1_step(w)
    assert Checkpointer(str(ck_dir), model=m,
                        train_step=step).load_latest() == 3
    tp = dict(np.load(out / "params_zero_p_g_os.npz"))
    for n, p in m.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), tp[n])


@pytest.mark.parametrize("zero", [None, "os", "os_g", "p_g_os"])
def test_world_one_equals_train_step(zero):
    """At world 1 the step is TrainStep's, bit for bit, at every level
    (a sharding axis of 1 splits nothing)."""
    tmesh.reset_mesh()
    paddle.seed(WEIGHT_SEED)
    w = {k: np.array(v.numpy())
         for k, v in JaxGPT(jax_gpt_tiny()).state_dict().items()}
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, 2048, (2, 32)))
    runs = []
    for kind in ("train_step", "dist"):
        trng.seed(0)
        m = worker._model(w)
        opt = AdamW(1e-3, parameters=m.parameters())
        step = (TrainStep(m, worker._loss_fn, opt) if kind == "train_step"
                else tdist.DistributedTrainStep(m, worker._loss_fn, opt,
                                                zero_level=zero))
        losses = [float(step(ids)) for _ in range(3)]
        runs.append((losses, {n: p.detach().clone()
                              for n, p in m.named_parameters()},
                     opt.state_dict()))
    (l0, p0, s0), (l1, p1, s1) = runs
    assert l0 == l1
    assert all(torch.equal(p0[n], p1[n]) for n in p0)
    assert all(torch.equal(s0[k], s1[k]) for k in s0
               if isinstance(s0[k], torch.Tensor))


def test_group_sharded_and_refusals(tmp_path):
    """group_sharded_parallel records the level the step takes;
    save_group_sharded_model writes the .pdparams / .pdopt that
    `paddle.load` reads back; quant_allreduce validates its
    path (the reference's ValueError at ZeRO p_g_os), a norm-reading
    optimizer over a split axis raises, and the tensor / pipeline
    wrappers wrap."""
    from paddle_tpu_torch.distributed import fleet as tfleet
    from paddle_tpu_torch.distributed.sharding import (
        group_sharded_parallel, save_group_sharded_model)
    from paddle_tpu_torch.optimizer import LarsMomentum

    tmesh.reset_mesh()
    m = torch.nn.Linear(4, 4)
    opt = AdamW(1e-3, parameters=m.parameters())
    assert group_sharded_parallel(m, opt, level=2) == (m, opt)
    assert opt._zero_level == "os_g"
    assert tdist.DistributedTrainStep(m, lambda mm, x: mm(x).sum(),
                                      opt).zero == "os_g"
    out = str(tmp_path / "sharded" / "m")
    save_group_sharded_model(m, out, opt)
    back = tpaddle.load(out + ".pdparams")
    assert set(back) == set(m.state_dict())
    for k, v in m.state_dict().items():
        assert torch.equal(back[k], v)
    assert set(tpaddle.load(out + ".pdopt")) == set(opt.state_dict())
    # at world 1 there is no replica axis to quantize over
    assert tdist.DistributedTrainStep(m, None, opt, quant_allreduce=True
                                      )._quant_axes == ()
    tmesh.init_mesh(sharding=2, world_size=2)
    try:
        with pytest.raises(ValueError, match="zero_level='p_g_os'"):
            tdist.DistributedTrainStep(m, None, opt, zero_level="p_g_os",
                                       quant_allreduce=True)
        with pytest.raises(NotImplementedError, match="norms"):
            tdist.DistributedTrainStep(
                m, None, LarsMomentum(0.1, parameters=m.parameters()),
                zero_level="os")
    finally:
        tmesh.reset_mesh()
    # tensor and pipeline parallelism are ported (ROADMAP A11(b) parts
    # 1-2): at world 1 TensorParallel is the layers themselves and
    # PipelineParallel wraps them
    assert tfleet.TensorParallel(m) is m
    pp = tfleet.PipelineParallel(m)
    assert pp._layers is m and pp.accumulate_steps == 1


def test_profile_dist_defaults_to_the_card_and_runs_on_the_cpu(
        monkeypatch, tmp_path):
    """profile_dist runs on CUDA unless asked for the CPU (and raises
    where there is none); at world 1 on the CPU it trains, writes its
    record and saves one checkpoint that holds every shard."""
    from paddle_tpu_torch import profile_dist

    for var in ("PADDLE_TRAINERS_NUM", "PADDLE_MASTER"):
        monkeypatch.delenv(var, raising=False)
    assert profile_dist.parse_args(["--out", "x"]).device == "cuda"
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            profile_dist.main(["--out", str(tmp_path)])
    try:
        profile_dist.main(["--model", "gpt_tiny", "--device", "cpu",
                           "--zero", "os_g", "--batch", "2", "--seq", "16",
                           "--steps", "2", "--ckpt", str(tmp_path / "ck"),
                           "--out", str(tmp_path)])
    finally:
        tmesh.reset_mesh()
    out = json.load(open(tmp_path / "dist_out_0.json"))
    assert len(out["losses"]) == 2 and out["mesh"]["sharding"] == 1
    assert out["launches"] == {"flash_forward": 0, "flash_bwd_dq": 0,
                               "flash_bwd_dkv": 0}   # CPU: plain versions
    meta = json.load(open(tmp_path / "ck" / "ckpt-00000002" / "meta.json"))
    assert meta["commit"]["world"] == 1
    assert len(out["ckpt_files"]) == sum(
        len(e["shards"]) for e in meta["leaves"])


def test_eager_data_parallel_helpers(trained):
    """In the same launch: broadcast_dp_parameters hands rank 0's weight
    to rank 1; fused_allreduce_gradients sums the ranks' gradients;
    LocalSGD averages the ranks' weights on its 2nd call only. The
    expectations are each rank's local arithmetic, run here (f32, the
    same ops: 1e-6 relative)."""
    _, _, _, res = trained
    w_rank0 = worker.eager_data(0)[1].T
    grads, local = [], []
    for r in range(2):
        x, w0 = worker.eager_data(r)
        w = torch.from_numpy(w_rank0.copy()).requires_grad_()
        (torch.from_numpy(x) @ w.T).pow(2).sum().backward()
        grads.append(w.grad.numpy())
        w = torch.from_numpy(w0.T.copy())
        for _ in range(2):
            w = w.detach().requires_grad_()
            (torch.from_numpy(x) @ w.T).pow(2).sum().backward()
            w = w - 0.1 * w.grad
        local.append(w.detach().numpy())
    for r in range(2):
        np.testing.assert_array_equal(res[r]["eager/broadcast"], w_rank0)
        np.testing.assert_allclose(res[r]["eager/grad_sum"],
                                   grads[0] + grads[1], rtol=1e-6)
        assert res[r]["eager/localsgd_synced"] == [False, True]
        np.testing.assert_allclose(res[r]["eager/localsgd"],
                                   (local[0] + local[1]) / 2, rtol=1e-6,
                                   atol=1e-7)


def test_world_one_checkpoint_restores_into_two_rank_zero(trained):
    """The reverse layout: a world-1 checkpoint restores into a ZeRO os_g
    step over 2 ranks (each rank takes its block of every moment) whose
    next loss matches the world-1 run's 4th (1e-5 relative: the 2-rank
    step averages two half-batch gradients)."""
    _, _, _, res = trained
    for r in range(2):
        assert res[r]["reverse/loaded"] == 3
        assert res[r]["reverse/moment_shape"] == [1024, 128]
        np.testing.assert_allclose(res[r]["reverse/next_loss"],
                                   res[r]["world1/next_loss"], rtol=1e-5)
