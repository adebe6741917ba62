"""The rest of the vision model zoo (paddle_tpu_torch/vision/models: the
MobileNets, VGG, AlexNet, SqueezeNet, DenseNet, GoogLeNet, Inception-v3,
ShuffleNetV2) against the JAX package's on the CPU, each family at the
reference tests' small sizes (tests/test_vision_models_zoo.py: 64 px,
96 px for AlexNet and Inception-v3, scale ≤ 0.5 where the constructor
takes one, 10 classes), batch 2, f32, every Dropout at p 0.

The weights are the port's seeded initial weights, loaded into the
reference model (`set_state_dict`); the reference is built with its
initializers stubbed to zeros for the length of the test (its eager
initializers compile one program per parameter shape, 5-16 s a model).
Its loss and gradients are taken as its compiled `TrainStep` takes
them, `jax.value_and_grad` over the parameter values under one
`jax.jit` (the eager tape compiles every op: 20-40 s a model).

Tolerances (each gradient's error is its max-abs difference over its
own max-abs, or over 1e-3 of the model's largest gradient where its own
is smaller: the biases of a batch norm that a later train-mode batch
norm follows get analytically zero gradients, 1e-7-1e-9 of rounding):

* eval mode (the running statistics): the loss, the logits and every
  gradient within 1e-5; f32 rounding puts the port 3e-7-1e-6 from its
  own f64 run on the same weights;
* train mode (batch statistics over 2 images, the card's setting): the
  loss and the running statistics within 1e-4, the logits (max-abs
  difference over max-abs) and the gradients (their difference over
  their norm, all tensors as one) within 1e-3. At random init a
  train-mode network with batch norm amplifies rounding layer by layer:
  the port and the reference read 2e-6-8e-6 apart on the loss, up to
  5.6e-5 on the logits and 1.6e-4 on the gradients (MobileNetV2).
  Inception-v3 is held in eval mode only: its last maps are 1×1, so its
  last batch norm sees 2 values a channel, normalizes them to ±1 and
  passes no gradient but rounding (the two frameworks' losses read
  1.3e-1 apart).

VGG is held without its classifier (`num_classes=0`): at 64 px its
first linear layer alone holds 102.8 M weights, 411 MB in f32 a
framework; the card's cross-check (chip_smoke 14 (a)) runs it whole.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.nn import initializer as jinit
from paddle_tpu.vision import models as JM
from paddle_tpu_torch.convert import export_state_dict
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.vision import models as TM

pytestmark = pytest.mark.torch_port

TOL = 1e-5
TRAIN_LOSS_TOL, TRAIN_TOL = 1e-4, 1e-3
EVAL_ONLY = ("inception_v3",)

# (constructor, its arguments, image side, classes)
FAMILIES = [
    ("mobilenet_v1", dict(scale=0.25), 64, 10),
    ("mobilenet_v2", dict(scale=0.5), 64, 10),
    ("mobilenet_v3_small", dict(scale=0.5), 64, 10),
    ("mobilenet_v3_large", dict(scale=0.5), 64, 10),
    ("vgg11", dict(batch_norm=True), 64, 0),
    ("alexnet", {}, 96, 10),
    ("squeezenet1_0", {}, 64, 10),
    ("squeezenet1_1", {}, 64, 10),
    ("densenet121", {}, 64, 10),
    ("googlenet", {}, 64, 10),
    ("inception_v3", {}, 96, 10),
    ("shufflenet_v2_x0_25", {}, 64, 10),
    ("ShuffleNetV2", dict(scale=0.25, act="swish"), 64, 10),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _zero_init(self, shape, dtype):
    return jnp.asarray(np.zeros(shape, np.dtype(dtype)))


def _no_dropout(layers):
    for m in layers:
        if type(m).__name__ == "Dropout":
            m.p = 0.0


def _models(name, kw, classes, monkeypatch):
    """(reference model, port model) holding the port's seeded weights."""
    tm = getattr(TM, name)(num_classes=classes, device="cpu", **kw)
    for cls in vars(jinit).values():
        if isinstance(cls, type) and "_init" in vars(cls):
            monkeypatch.setattr(cls, "_init", _zero_init)
    jm = getattr(JM, name)(num_classes=classes, **kw)
    monkeypatch.undo()
    missing, unexpected = jm.set_state_dict(export_state_dict(tm))
    assert not missing and not unexpected, (missing, unexpected)
    _no_dropout(jm.sublayers())
    _no_dropout(tm.modules())
    return jm, tm


def _outs(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _reference(jm, x, y, classes):
    """The reference's (loss, outputs, {name: grad}, {buffer: value after
    the forward}) under one jit."""
    params = list(jm.named_parameters())
    bufs = list(jm.named_buffers())

    def pure(vals):
        held = [p._value for _, p in params]
        held_b = [b._value for _, b in bufs]
        for (_, p), v in zip(params, vals):
            p._value = v
        try:
            outs = _outs(jm(paddle.to_tensor(x)))
            if classes:
                loss = sum(paddle.nn.functional.cross_entropy(
                    o, paddle.to_tensor(y)) for o in outs)
            else:
                loss = sum((o * paddle.to_tensor(
                    _probe(o.shape))).sum() for o in outs)
            return loss._value, ([o._value for o in outs],
                                 [b._value for _, b in bufs])
        finally:
            for (_, p), v in zip(params, held):
                p._value = v
            for (_, b), v in zip(bufs, held_b):
                b._value = v

    with jax.default_matmul_precision("highest"):
        (loss, (outs, new_bufs)), grads = jax.jit(
            jax.value_and_grad(pure, has_aux=True))(
                [p._value for _, p in params])
    return (float(loss), [np.asarray(o) for o in outs],
            {n: np.asarray(g) for (n, _), g in zip(params, grads)},
            {n: np.asarray(v) for (n, _), v in zip(bufs, new_bufs)})


def _probe(shape):
    """A fixed random readout for a model without a classifier."""
    return np.random.default_rng(1).standard_normal(
        tuple(shape)).astype(np.float32)


def _port(tm, x, y, classes):
    """The port's (loss, outputs, {name: grad}, {buffer: value}) on a
    copy of `tm`."""
    import copy

    m = copy.deepcopy(tm)
    outs = _outs(m(torch.from_numpy(x)))
    if classes:
        loss = sum(TF.cross_entropy(o, torch.from_numpy(y)) for o in outs)
    else:
        loss = sum((o * torch.from_numpy(_probe(o.shape))).sum()
                   for o in outs)
    loss.backward()
    grads = {n: p.grad.double().numpy() for n, p in m.named_parameters()}
    return (float(loss.detach()), [o.detach().double().numpy()
                                   for o in outs], grads,
            {n: b.detach().double().numpy() for n, b in m.named_buffers()})


def _grad_errs(got, want):
    floor = 1e-3 * max(float(np.abs(g).max()) for g in want.values())
    return {n: float(np.abs(got[n] - want[n]).max()
                     / max(float(np.abs(want[n]).max()), floor, 1e-30))
            for n in want}


def _norm_err(got, want):
    """The gradients' difference over their norm, all tensors as one."""
    num = sum(float(((got[n] - w) ** 2).sum()) for n, w in want.items())
    return (num / sum(float((w ** 2).sum()) for w in want.values())) ** 0.5


def _buf_err(got, want):
    """The running statistics' worst difference over max(1, max-abs)
    (a running mean sits near 0); 0 for a model without batch norm."""
    return max([float(np.abs(got[n] - v).max()
                      / max(1.0, float(np.abs(v).max())))
                for n, v in want.items()] or [0.0])


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name,kw,size,classes", FAMILIES,
                         ids=[f[0] for f in FAMILIES])
def test_zoo_family_matches_the_reference(name, kw, size, classes,
                                          monkeypatch):
    jm, tm = _models(name, kw, classes, monkeypatch)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, size, size)).astype(np.float32)
    y = rng.integers(0, max(classes, 1), (2,)).astype(np.int64)
    assert set(dict(tm.named_parameters())) == \
        set(dict(jm.named_parameters()))

    # train mode: batch statistics
    if name not in EVAL_ONLY:
        jl, jouts, jgrads, jbufs = _reference(jm, x, y, classes)
        tl, touts, tgrads, tbufs = _port(tm, x, y, classes)
        checks = {
            "loss": (abs(tl - jl) / abs(jl), TRAIN_LOSS_TOL),
            "statistics": (_buf_err(tbufs, jbufs), TRAIN_LOSS_TOL),
            "logits": (max(_rel(t, j) for t, j in zip(touts, jouts)),
                       TRAIN_TOL),
            "gradients": (_norm_err(tgrads, jgrads), TRAIN_TOL),
        }
        bad = {k: v for k, v in checks.items() if v[0] > v[1]}
        assert not bad, bad

    # eval mode: the running statistics, the tight bound
    jm.eval()
    tm.eval()
    jl, jouts, jgrads, _ = _reference(jm, x, y, classes)
    tl, touts, tgrads, _ = _port(tm, x, y, classes)
    assert abs(tl - jl) <= TOL * abs(jl), (tl, jl)
    for t, j in zip(touts, jouts):
        assert _rel(t, j) <= TOL
    bad = {n: e for n, e in _grad_errs(tgrads, jgrads).items() if e > TOL}
    assert not bad, bad


@pytest.mark.parametrize("fn", ["ReLU6", "relu6"])
def test_relu6_gradient_is_zero_at_both_corners_as_the_reference(fn):
    """jax.nn.relu6's gradient is 0 at 0 and at 6; torch.clamp's is 1
    there. A 1×1 convolution without bias over a pixel the previous
    ReLU6 zeroed feeds exactly 0 to the next ReLU6: MobileNetV2's eval
    gradients moved by 1.3 of their max-abs on the clamp."""
    from paddle_tpu_torch import nn as tnn

    x = np.array([-1.0, 0.0, 3.0, 6.0, 7.0], np.float32)
    jx = paddle.to_tensor(x, stop_gradient=False)
    (paddle.nn.ReLU6()(jx) if fn == "ReLU6"
     else paddle.nn.functional.relu6(jx)).sum().backward()
    tx = torch.tensor(x, requires_grad=True)
    (tnn.ReLU6()(tx) if fn == "ReLU6" else TF.relu6(tx)).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(),
                                  np.asarray(jx.grad.numpy()))
    np.testing.assert_array_equal(tx.grad.numpy(), [0, 0, 1, 0, 0])
