"""The vision training path (paddle_tpu_torch/vision/models, ROADMAP A12)
against the JAX package's on the CPU: the ResNet family and LeNet with
the reference's weights carried across by `convert`, on the same numpy
inputs. Tolerances, each with its reason:

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
  losses and parameters 1e-5.
"""
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
    """(reference model, port model with its weights, the weights)."""
    paddle.seed(0)
    jm = getattr(JM, name)(**kw)
    w = {k: np.array(v.numpy()) for k, v in jm.state_dict().items()}
    tm = getattr(TM, name)(device="cpu", **kw)
    load_jax_state_dict(tm, w)
    return jm, tm, w


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
    with jax.default_matmul_precision("highest"):
        jlogits = jm(paddle.to_tensor(x))
        jloss = paddle.nn.functional.cross_entropy(jlogits,
                                                   paddle.to_tensor(y))
        jloss.backward()
    tlogits = tm(torch.from_numpy(x))
    tloss = TF.cross_entropy(tlogits, torch.from_numpy(y))
    tloss.backward()
    assert _rel(tlogits.detach().numpy(), np.asarray(jlogits.numpy())) < TOL
    np.testing.assert_allclose(float(tloss.detach()), float(jloss.numpy()),
                               rtol=TOL)
    jgrads = {k: np.asarray(p.grad.numpy()) for k, p in jm.named_parameters()}
    for k, p in tm.named_parameters():
        assert _rel(p.grad.numpy(), jgrads[k]) < TOL, k
    want = _stats({k: np.asarray(v.numpy())
                   for k, v in jm.state_dict().items()})
    got = _stats(export_state_dict(tm))
    assert set(got) == set(want) and len(got) > 10
    for k in want:
        assert _near(got[k], want[k], STAT_TOL), k


def test_resnet50_training_forward_and_statistics():
    jm, tm, _ = _pair("resnet50", num_classes=10)
    x, y = _batch(16)
    with jax.default_matmul_precision("highest"):
        jloss = paddle.nn.functional.cross_entropy(
            jm(paddle.to_tensor(x)), paddle.to_tensor(y))
    with torch.no_grad():
        tloss = TF.cross_entropy(tm(torch.from_numpy(x)), torch.from_numpy(y))
    np.testing.assert_allclose(float(tloss), float(jloss.numpy()), rtol=TOL)
    want = _stats({k: np.asarray(v.numpy())
                   for k, v in jm.state_dict().items()})
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


def test_batch_norm_over_a_data_parallel_world_raises():
    """One process per rank would normalize with its rows' statistics
    alone, where the reference's GSPMD step takes the global batch's."""
    tm = TM.LeNet(device="cpu")
    bn = TM.resnet18(num_classes=10, device="cpu").bn1
    x = torch.zeros(2, 64, 4, 4)
    tmesh.init_mesh(dp=2, world_size=2)
    try:
        with pytest.raises(NotImplementedError,
                           match=r"A12 \(batch norm over a data-parallel "
                                 r"world\)"):
            bn(x)
        bn.eval()
        bn(x)
        tm(torch.zeros(1, 1, 28, 28))
    finally:
        tmesh.reset_mesh()
