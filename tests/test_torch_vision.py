"""The vision training path (paddle_tpu_torch/vision/models, ROADMAP A12)
against the JAX package's on the CPU: the ResNet family and LeNet with
the reference's weights carried across by `convert` (the reference holds
a seeded init of the port's: its own initializers are stubbed, `_pair`),
on the same numpy inputs; the reference's gradients are taken under one
`jax.jit`. Tolerances, each with its reason:

Every tensor is compared by its largest difference over its own
max-abs (over 1 where that is smaller: running means sit near 0).

* forward and gradients, f32: 1e-4 of each tensor's max-abs — the
  frameworks sum convolutions and reductions in different orders. The
  check runs ResNet-18 in training and ResNet-50 in eval: at 32×32 input
  ResNet-50's last stage normalizes 1×1 maps over the batch alone, and
  there f32 rounding moves its gradients by 0.26-0.43 of their max-abs
  against an f64 run in both frameworks alike (the port's f32 and the
  reference's land equally far from the port's f64), so its training
  pass is held by the loss and the running statistics, 1e-4 each (its
  last stages' statistics over 16 images, 1×1 and 2×2 maps, carry
  2e-5 of summation noise; torch's CPU convolution changes its
  algorithm with the thread count, and the noise with it);
* running statistics: 1e-5 of their max-abs (f32 means and biased
  variances, one momentum step each, fed by the activations' summation
  noise);
* three `TrainStep`s with Momentum(1e-3) on ResNet-18: losses 1e-5
  relative, parameters and running statistics 1e-5; one bf16 O1
  step: the loss within 2e-2 relative (bf16 convolutions, f32 batch
  norm); `remat=True` equal to `remat=False` bit for bit, and a recompute
  that updated the statistics again (planted) moves them;
* LeNet's eager `backward` / `step` / `clear_grad` loop for three steps:
  losses and parameters 1e-5;
* batch norm over a data-parallel process world (gloo ranks under the
  port's launcher, tests/torch_hybrid_worker.py `bn`): at dp 2 each
  layer of `BatchNorm2D` / `SyncBatchNorm` in NCHW and NHWC on its
  half of a seeded [8, 16, 6, 6] batch against the reference's
  `batch_norm` on the whole batch — output, input gradient, the ranks'
  summed weight and bias gradients, every rank's running statistics —
  1e-5; three Momentum steps of ResNet-18 under `DistributedTrainStep`
  at dp 2 and at dp 2 × sharding 2 (os_g) against the reference's step
  on its CPU mesh: losses 1e-5 relative, running statistics 1e-5, the
  dp replicas' parameters bit-equal; and the statistics of each rank's
  rows alone put ResNet-18's loss more than 1e-3 off the global
  batch's. A mesh that declares dp 2 in a process without peers is
  plain batch norm there.
"""
import contextlib
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu.vision import models as JM
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.convert import export_state_dict, load_jax_state_dict
from paddle_tpu_torch.core import recompute as trecompute
from paddle_tpu_torch.distributed import mesh as tmesh
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision import models as TM

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_hybrid_worker as worker  # noqa: E402

pytestmark = pytest.mark.torch_port

TOL = 1e-4
STAT_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once; results do not change."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(n, shape=(3, 32, 32), classes=10, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n,) + shape).astype(np.float32),
            rng.integers(0, classes, (n,)).astype(np.int64))


def _pair(name, **kw):
    """(reference model, port model with its weights, the weights). The
    weights are a port model's seeded init (seed 1): the reference's
    initializers compile a program a shape on the CPU (≈ 17 s for
    ResNet-50 with a cold compile cache), so they are stubbed to zeros
    and the reference takes the weights by `set_state_dict`; the port
    model under test (seed 0: other weights) then takes the reference's
    whole state_dict through `convert`."""
    src = getattr(TM, name)(device="cpu", seed=1, **kw)
    with _zero_reference_init():
        jm = getattr(JM, name)(**kw)
    missing, unexpected = jm.set_state_dict(export_state_dict(src))
    assert not missing and not unexpected, (missing, unexpected)
    w = {k: np.array(v.numpy()) for k, v in jm.state_dict().items()}
    tm = getattr(TM, name)(device="cpu", **kw)
    load_jax_state_dict(tm, w)
    return jm, tm, w


@contextlib.contextmanager
def _zero_reference_init():
    """The reference's initializers make zeros (no program to compile)."""
    from paddle_tpu.nn import initializer as jinit

    saved = {cls: vars(cls)["_init"] for cls in vars(jinit).values()
             if isinstance(cls, type) and "_init" in vars(cls)}
    for cls in saved:
        cls._init = _zero_init
    try:
        yield
    finally:
        for cls, fn in saved.items():
            cls._init = fn


def _zero_init(self, shape, dtype):
    import jax.numpy as jnp

    return jnp.asarray(np.zeros(shape, np.dtype(dtype)))


def _reference_grads(jm, x, y):
    """The reference's (logits, loss, {name: grad}, {name: state after
    the forward}) of cross entropy, its gradient taken under one
    `jax.jit` (the eager tape compiles a program an op: ≈ 34 s for
    ResNet-50 with a cold cache, one program ≈ 8 s)."""
    params = list(jm.named_parameters())
    bufs = list(jm.named_buffers())

    def pure(vals):
        held = [p._value for _, p in params]
        held_b = [b._value for _, b in bufs]
        for (_, p), v in zip(params, vals):
            p._value = v
        try:
            logits = jm(paddle.to_tensor(x))
            loss = paddle.nn.functional.cross_entropy(logits,
                                                      paddle.to_tensor(y))
            return loss._value, (logits._value,
                                 [b._value for _, b in bufs])
        finally:
            for (_, p), v in zip(params, held):
                p._value = v
            for (_, b), v in zip(bufs, held_b):
                b._value = v

    with jax.default_matmul_precision("highest"):
        (loss, (logits, new_bufs)), grads = jax.jit(
            jax.value_and_grad(pure, has_aux=True))(
                [p._value for _, p in params])
    state = {n: np.asarray(p._value) for n, p in params}
    state.update({n: np.asarray(v) for (n, _), v in zip(bufs, new_bufs)})
    return (np.asarray(logits), float(loss),
            {n: np.asarray(g) for (n, _), g in zip(params, grads)}, state)


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _near(got, want, tol):
    """max |got − want| ≤ tol · max(1, max |want|): relative for large
    tensors, absolute for small ones (a running mean near 0)."""
    return float(np.abs(got - want).max()) <= tol * max(
        1.0, float(np.abs(want).max()))


def _stats(state):
    return {k: v for k, v in state.items()
            if k.endswith("._mean") or k.endswith("._variance")}


@pytest.mark.parametrize("name,mode,n", [("resnet18", "train", 16),
                                         ("resnet50", "eval", 4)])
def test_resnet_forward_and_gradients(name, mode, n):
    jm, tm, _ = _pair(name, num_classes=10)
    x, y = _batch(n)
    if mode == "eval":
        jm.eval()
        tm.eval()
    jlogits, jloss, jgrads, jstate = _reference_grads(jm, x, y)
    tlogits = tm(torch.from_numpy(x))
    tloss = TF.cross_entropy(tlogits, torch.from_numpy(y))
    tloss.backward()
    assert _rel(tlogits.detach().numpy(), jlogits) < TOL
    np.testing.assert_allclose(float(tloss.detach()), jloss, rtol=TOL)
    for k, p in tm.named_parameters():
        assert _rel(p.grad.numpy(), jgrads[k]) < TOL, k
    want = _stats(jstate)
    got = _stats(export_state_dict(tm))
    assert set(got) == set(want) and len(got) > 10
    for k in want:
        assert _near(got[k], want[k], STAT_TOL), k


def test_resnet50_training_forward_and_statistics():
    jm, tm, _ = _pair("resnet50", num_classes=10)
    x, y = _batch(16)
    _, jloss, _, jstate = _reference_grads(jm, x, y)
    with torch.no_grad():
        tloss = TF.cross_entropy(tm(torch.from_numpy(x)), torch.from_numpy(y))
    np.testing.assert_allclose(float(tloss), jloss, rtol=TOL)
    want = _stats(jstate)
    got = _stats(export_state_dict(tm))
    for k in want:
        assert _near(got[k], want[k], TOL), k


def _ce(m, x, y):
    return TF.cross_entropy(m(x), y)


def _ce_o1(m, x, y):
    with tamp.auto_cast(level="O1", dtype="bfloat16"):
        return TF.cross_entropy(m(x), y)


# the steps' learning rate and batch. At bench_resnet's lr 0.1 this
# random-init ResNet-18's loss climbs 3.9 → 6.7 in three steps and at
# 0.01 falls to 0.09; either way the summation noise grows with the
# steps (parameters 0.14 / 1.9e-3 apart after three, in both directions
# alike). At 1e-3 over 16 images every step stays within 1 ulp of the
# parameters
LR, B = 1e-3, 16


def _reference_steps(jm, x, y, steps, o1=False):
    def loss_fn(m, a, b):
        if o1:
            with jamp.auto_cast(level="O1", dtype="bfloat16"):
                return paddle.nn.functional.cross_entropy(m(a), b)
        return paddle.nn.functional.cross_entropy(m(a), b)

    opt = paddle.optimizer.Momentum(LR, parameters=jm.parameters())
    step = paddle.jit.TrainStep(jm, loss_fn, opt)
    with jax.default_matmul_precision("highest"):
        losses = [float(step(paddle.to_tensor(x),
                             paddle.to_tensor(y)).numpy())
                  for _ in range(steps)]
    return losses, {k: np.asarray(v.numpy(), np.float32)
                    for k, v in jm.state_dict().items()}


def _port_steps(tm, x, y, steps, loss_fn=_ce, remat=False):
    step = TrainStep(tm, loss_fn, Momentum(LR, parameters=tm.parameters()),
                     remat=remat)
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
              for _ in range(steps)]
    return losses, export_state_dict(tm)


def test_resnet18_train_steps_match_reference():
    jm, tm, _ = _pair("resnet18", num_classes=10)
    x, y = _batch(B)
    jl, jstate = _reference_steps(jm, x, y, 3)
    tl, tstate = _port_steps(tm, x, y, 3)
    np.testing.assert_allclose(tl, jl, rtol=STAT_TOL)
    assert set(tstate) == set(jstate)
    for k, v in tstate.items():
        assert _near(v, jstate[k], STAT_TOL), k


def test_resnet18_o1_step_matches_reference():
    jm, tm, _ = _pair("resnet18", num_classes=10)
    x, y = _batch(B)
    jl, _ = _reference_steps(jm, x, y, 1, o1=True)
    tl, _ = _port_steps(tm, x, y, 1, loss_fn=_ce_o1)
    np.testing.assert_allclose(tl, jl, rtol=2e-2)


def test_remat_updates_running_statistics_once(monkeypatch):
    """Under remat=True the backward runs the forward again; the batch
    norms' running statistics still take one update a step, so three
    steps equal remat=False's bit for bit. With the recompute's guard
    planted away (a second update a step) they move."""
    _, tm, w = _pair("resnet18", num_classes=10)
    x, y = _batch(B)
    runs = {}
    for remat in (False, True):
        m = TM.resnet18(num_classes=10, device="cpu")
        load_jax_state_dict(m, w)
        runs[remat] = _port_steps(m, x, y, 3, remat=remat)
    assert runs[True][0] == runs[False][0]
    for k, v in runs[False][1].items():
        assert np.array_equal(runs[True][1][k], v), k
    monkeypatch.setattr(trecompute, "in_recompute", lambda: False)
    m = TM.resnet18(num_classes=10, device="cpu")
    load_jax_state_dict(m, w)
    planted = _stats(_port_steps(m, x, y, 3, remat=True)[1])
    want = _stats(runs[False][1])
    assert max(np.abs(planted[k] - want[k]).max() for k in want) > 1e-3


def test_lenet_eager_loop_matches_reference():
    """bench_mnist's loop: forward, `backward()`, `step()`,
    `clear_grad()`, three times with Momentum(0.01)."""
    paddle.seed(0)
    jm = JM.LeNet()
    w = {k: np.array(v.numpy()) for k, v in jm.state_dict().items()}
    tm = TM.LeNet(device="cpu")
    load_jax_state_dict(tm, w)
    x, y = _batch(16, shape=(1, 28, 28))
    jopt = paddle.optimizer.Momentum(0.01, parameters=jm.parameters())
    topt = Momentum(0.01, parameters=tm.parameters())
    jx, jy = paddle.to_tensor(x), paddle.to_tensor(y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    jl, tl = [], []
    with jax.default_matmul_precision("highest"):
        for _ in range(3):
            loss = paddle.nn.functional.cross_entropy(jm(jx), jy)
            loss.backward()
            jopt.step()
            jopt.clear_grad()
            jl.append(float(loss.numpy()))
    for _ in range(3):
        loss = TF.cross_entropy(tm(tx), ty)
        loss.backward()
        topt.step()
        topt.clear_grad()
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=STAT_TOL)
    got = export_state_dict(tm)
    for k, v in jm.state_dict().items():
        assert _near(got[k], np.asarray(v.numpy()), STAT_TOL), k


@pytest.mark.parametrize("name,kw", [
    ("resnet50", dict(num_classes=1000)), ("LeNet", {}),
    ("resnet34", dict(num_classes=10)),
    ("resnext50_32x4d", dict(num_classes=10)),
    ("wide_resnet50_2", dict(num_classes=10))])
def test_state_dict_carries_across_key_for_key(name, kw):
    """`convert.load_jax_state_dict` takes the reference model's whole
    `state_dict` (the batch norms' `_mean` / `_variance` included) and
    `export_state_dict` gives the same arrays back."""
    _, tm, w = _pair(name, **kw)
    back = export_state_dict(tm)
    assert set(back) == set(w)
    for k, v in w.items():
        assert back[k].shape == v.shape and np.array_equal(back[k], v), k


def test_models_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (TM.resnet50, TM.LeNet):
        with pytest.raises(RuntimeError, match="no"):
            make()


def test_batch_norm_under_a_peerless_data_parallel_mesh_is_local():
    """A mesh that declares dp 2 in a process without peers: the data
    axes' collectives are the identity there, as the port's others are,
    so the global batch is this process's own and the result is plain
    batch norm's (it used to raise)."""
    bn = TM.resnet18(num_classes=10, device="cpu").bn1
    x = torch.from_numpy(_batch(4, (64, 4, 4))[0])
    want = TF.batch_norm(x, torch.zeros(64), torch.ones(64), bn.weight,
                         bn.bias, training=True)
    tmesh.init_mesh(dp=2, world_size=2)
    try:
        got = bn(x)
        assert _rel(got.detach().numpy(), want.detach().numpy()) < 1e-6
        bn.eval()
        bn(x)
        TM.LeNet(device="cpu")(torch.zeros(1, 1, 28, 28))
    finally:
        tmesh.reset_mesh()


# ---- batch norm over a data-parallel process world (gloo ranks) -----------

def _bn_inputs():
    rng = np.random.default_rng(31)
    return {"x": rng.standard_normal((8, 16, 6, 6)).astype(np.float32) * 2
            + 0.5,
            "gy": rng.standard_normal((8, 16, 6, 6)).astype(np.float32),
            "w": rng.uniform(0.5, 1.5, 16).astype(np.float32),
            "b": rng.standard_normal(16).astype(np.float32),
            # the batch of the single-process steps above (B = 16): at 8
            # images the serial steps already drift 2.4e-5 apart by the
            # third (the summation noise these steps magnify)
            "images": _batch(B)[0], "labels": _batch(B)[1]}


@pytest.fixture(scope="module")
def bn_job(tmp_path_factory):
    """The worker at dp 2 and at dp 2 × sharding 2 (tests/
    torch_hybrid_worker.py `bn`), on the reference's ResNet-18 weights."""
    from test_torch_mp_layers import launch_worker

    out = tmp_path_factory.mktemp("bn")
    a = _bn_inputs()
    paddle.seed(0)
    jm = JM.resnet18(num_classes=10)
    w = {k: np.array(v.numpy()) for k, v in jm.state_dict().items()}
    np.savez(out / "bn_inputs.npz", **a)
    np.savez(out / "bn_weights.npz", **w)
    runs = {}
    for world in sorted(worker.BN_MESHES):
        launch_worker("bn", out, world, timeout=300)
        runs[world] = [
            (dict(np.load(out / f"bn{world}_r{r}.npz")),
             json.load(open(out / f"bn{world}_r{r}.json")))
            for r in range(world)]
    return a, w, runs


def _reference_bn(a, fmt):
    """(out, dx, dw, db, running mean, running var) of the reference's
    batch_norm over the whole batch in training, Σ out · gy."""
    x, gy = a["x"], a["gy"]
    if fmt == "NHWC":
        x, gy = x.transpose(0, 2, 3, 1), gy.transpose(0, 2, 3, 1)
    xt = paddle.to_tensor(x, stop_gradient=False)
    wt = paddle.to_tensor(a["w"], stop_gradient=False)
    bt = paddle.to_tensor(a["b"], stop_gradient=False)
    rm = paddle.to_tensor(np.zeros(16, np.float32))
    rv = paddle.to_tensor(np.ones(16, np.float32))
    y = paddle.nn.functional.batch_norm(xt, rm, rv, wt, bt, training=True,
                                        data_format=fmt)
    dx, dw, db = paddle.grad(paddle.sum(y * paddle.to_tensor(gy)),
                             [xt, wt, bt])
    return [np.asarray(t.numpy()) for t in (y, dx, dw, db, rm, rv)]


@pytest.mark.parametrize("cls,fmt", worker.BN_LAYERS)
def test_batch_norm_over_a_data_parallel_world_takes_the_global_batch(
        bn_job, cls, fmt):
    """At dp 2 each rank holds half of a seeded [8, 16, 6, 6] batch: its
    output and input gradient are the reference's whole-batch ones on
    its rows, the ranks' weight and bias gradients add up to the
    reference's, and every rank's running statistics are the
    reference's, all within 1e-5."""
    a, _, runs = bn_job
    want = dict(zip(("out", "dx", "dw", "db", "mean", "var"),
                    _reference_bn(a, fmt)))
    ranks = sorted(runs[2], key=lambda r: r[1]["pos"])
    key = f"{cls}/{fmt}"
    for name in ("out", "dx"):
        got = np.concatenate([r[0][f"{key}/{name}"] for r in ranks])
        assert _rel(got, want[name]) < STAT_TOL, name
    for name in ("dw", "db"):
        got = sum(r[0][f"{key}/{name}"] for r in ranks)
        assert _rel(got, want[name]) < STAT_TOL, name
    for r in ranks:
        for name in ("mean", "var"):
            assert _near(r[0][f"{key}/{name}"], want[name], STAT_TOL), name


def _reference_dist_steps(w, a, mesh):
    from paddle_tpu import distributed as jdist
    from paddle_tpu.distributed import mesh as jmesh

    n = int(np.prod(list(mesh.values())))
    jmesh.reset_mesh()
    jmesh.init_mesh(devices=jax.devices()[:n], **mesh)
    try:
        jm = JM.resnet18(num_classes=10)
        jm.set_state_dict({k: paddle.to_tensor(v) for k, v in w.items()})
        opt = paddle.optimizer.Momentum(LR, parameters=jm.parameters())
        step = jdist.DistributedTrainStep(
            jm, lambda m, x, y: paddle.nn.functional.cross_entropy(m(x), y),
            opt, zero_level="os_g" if mesh.get("sharding", 1) > 1 else None)
        with jax.default_matmul_precision("highest"):
            losses = [float(step(paddle.to_tensor(a["images"]),
                                 paddle.to_tensor(a["labels"])).numpy())
                      for _ in range(3)]
        return losses, {k: np.asarray(v.numpy(), np.float32)
                        for k, v in jm.state_dict().items()}
    finally:
        jmesh.reset_mesh()


@pytest.mark.parametrize("world", [2, 4])
def test_resnet18_distributed_steps_match_the_reference(bn_job, world):
    """Three Momentum steps of ResNet-18 under DistributedTrainStep at
    dp 2 and at dp 2 × sharding 2 (os_g): the losses and the running
    statistics within 1e-5 of the reference's DistributedTrainStep on
    its CPU mesh (the global batch's statistics there), and the dp
    replicas' parameters bit-equal."""
    a, w, runs = bn_job
    want_losses, want_state = _reference_dist_steps(
        w, a, worker.BN_MESHES[world])
    ranks = runs[world]
    for res, meta in ranks:
        np.testing.assert_allclose(meta["losses"], want_losses,
                                   rtol=STAT_TOL)
        state = {k[len("resnet/"):]: v for k, v in res.items()
                 if k.startswith("resnet/")}
        assert set(state) == set(want_state)
        for k, v in _stats(state).items():
            assert _near(v, want_state[k], STAT_TOL), k
    first = ranks[0][0]
    for res, meta in ranks[1:]:
        for k, v in res.items():
            if k.startswith("resnet/"):
                assert np.array_equal(v, first[k]), (meta, k)


def test_each_ranks_own_statistics_are_not_the_global_batch():
    """Why the statistics must be global: ResNet-18's training loss on
    the batch of 8 against the mean of its two halves' losses, each half
    normalized by its own statistics (what a rank alone would compute)
    — more than 1e-3 apart."""
    _, tm, _ = _pair("resnet18", num_classes=10)
    x, y = (torch.from_numpy(v) for v in _batch(8))
    with torch.no_grad():
        whole = float(TF.cross_entropy(tm(x), y))
        halves = np.mean([float(TF.cross_entropy(tm(x[i:i + 4]),
                                                 y[i:i + 4]))
                          for i in (0, 4)])
    assert abs(whole - halves) > 1e-3
