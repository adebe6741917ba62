"""The port's `nn.Layer` and the rest of the skeleton (autograd, save /
load, places, generators, flags, errors) against the JAX package's on
the CPU, on the same numpy inputs from `np.random.default_rng(seed)`.

`Layer` is a `torch.nn.Module`: the methods both classes name are
called here both ways — as the reference calls them and as torch (and
torch's own callers) do. Gradients go through `paddle_tpu.grad` and the
port's `grad`. Tolerances: 1e-6 of each tensor's max-abs in f32, 1e-12
in f64; integer outputs and dtypes exact.
"""
import collections
import importlib
import inspect
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import nn as tnn

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


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _tol(a):
    return 1e-12 if np.asarray(a).dtype == np.float64 else 1e-6


def _arrays(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


# ---- Layer: the paddle surface and torch's callers ----

class _TNet(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = tnn.Linear(3, 4)
        self.bn = tnn.BatchNorm1D(4)
        self.register_buffer("step", torch.zeros(1), persistable=False)
        self.scale = self.create_parameter([4], default_initializer=None,
                                           is_bias=True)

    def forward(self, x):
        return self.bn(self.fc(x)) * self.scale


class _JNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = jnn.Linear(3, 4)
        self.bn = jnn.BatchNorm1D(4)
        self.register_buffer("step", paddle.zeros([1]), persistable=False)
        self.scale = self.create_parameter([4], is_bias=True)

    def forward(self, x):
        return self.bn(self.fc(x)) * self.scale


def test_layer_is_a_torch_module_with_the_reference_names():
    t, j = _TNet(), _JNet()
    assert isinstance(t, torch.nn.Module) and isinstance(t, tnn.Layer)
    assert list(t.state_dict()) == list(j.state_dict())
    assert [n for n, _ in t.named_parameters()] == \
        [n for n, _ in j.named_parameters()]
    assert [n for n, _ in t.named_sublayers()] == \
        [n for n, _ in j.named_sublayers()]
    assert [n for n, _ in t.named_sublayers(prefix="m", include_self=True)] \
        == [n for n, _ in j.named_sublayers(prefix="m", include_self=True)]
    assert [type(m).__name__ for m in t.sublayers(include_self=True)] == \
        ["_TNet"] + [type(m).__name__ for m in j.sublayers()]
    assert t.full_name().startswith("__t_net_") and \
        j.full_name().startswith("__j_net_")
    assert tnn.Linear(2, 2).full_name() != tnn.Linear(2, 2).full_name()


def test_state_dict_both_ways():
    t = _TNet()
    # paddle's positional (destination, include_sublayers)
    assert list(t.state_dict(None, False)) == ["scale"]
    assert list(t.fc.state_dict(include_sublayers=False)) == ["weight",
                                                              "bias"]
    dest = collections.OrderedDict()
    assert t.state_dict(dest) is dest and "fc.weight" in dest
    # torch's keywords, as torch calls each sublayer
    sd = t.state_dict(destination=None, prefix="net.", keep_vars=True)
    assert list(sd)[0] == "net.scale" and isinstance(sd["net.fc.weight"],
                                                     torch.nn.Parameter)
    assert not isinstance(t.state_dict()["fc.weight"], torch.nn.Parameter)
    assert "step" not in t.state_dict()     # non-persistable buffer
    u = _TNet()
    u.load_state_dict(t.state_dict())
    for k, v in t.state_dict().items():
        assert torch.equal(u.state_dict()[k], v)


def test_register_buffer_both_ways():
    t = tnn.Layer()
    t.register_buffer("a", torch.ones(2), persistable=False)
    t.register_buffer("b", torch.ones(2), persistent=False)
    t.register_buffer("c", torch.ones(2), False)
    out = t.register_buffer("d", np.arange(3))
    assert isinstance(out, torch.Tensor) and out.tolist() == [0, 1, 2]
    t.register_buffer("e", torch.zeros(1))
    assert list(t.state_dict()) == ["d", "e"]
    assert [n for n, _ in t.named_buffers()] == ["a", "b", "c", "d", "e"]


def test_parameters_both_ways():
    t = _TNet()
    ps = t.parameters()
    assert isinstance(ps, list) and len(ps) == 5
    assert len(t.parameters(include_sublayers=False)) == 1
    assert len(t.parameters(False)) == 1
    assert len(t.parameters(recurse=False)) == 1
    assert [n for n, _ in t.named_parameters("p", False)] == ["p.scale"]
    assert [n for n, _ in t.named_parameters(prefix="p", recurse=False)] \
        == ["p.scale"]
    assert len(t.buffers()) == 3 and len(t.buffers(recurse=False)) == 1
    # torch's own callers
    opt = torch.optim.SGD(t.parameters(), lr=0.1)
    t(torch.ones(2, 3)).sum().backward()
    torch.nn.utils.clip_grad_norm_(t.parameters(), 1.0)
    opt.step()
    assert len(list(t.modules())) == 3


def test_to_astype_train_eval_both_ways():
    t = _TNet()
    assert t.to("cpu") is t and t.fc.weight.dtype == torch.float32
    t.to(dtype="float64")
    assert t.fc.weight.dtype == torch.float64 and t._dtype == torch.float64
    t.to("cpu", "float32", True)
    assert t.fc.weight.dtype == torch.float32
    t.to(torch.float64)
    assert t.bn._mean.dtype == torch.float64
    t.to(device=torch.device("cpu"), dtype=torch.float32)
    t.to(tpaddle.CPUPlace())
    t.to(torch.zeros(1, dtype=torch.float64))
    assert t.fc.weight.dtype == torch.float64
    assert t.astype("bfloat16").fc.weight.dtype == torch.bfloat16
    assert t.float().fc.weight.dtype == torch.float32
    assert t.bfloat16().scale.dtype == torch.bfloat16
    assert t.eval() is t and not t.training and not t.fc.training
    t.train()
    assert t.training and t.bn.training
    t.train(False)
    assert not t.bn.training
    t.train(mode=True)
    assert t.bn.training


def test_hooks_return_a_remove_helper():
    for mod, mk in ((tnn, torch.ones), (jnn, paddle.ones)):
        lin = mod.Linear(2, 2)
        pre = lin.register_forward_pre_hook(
            lambda layer, inputs: (inputs[0] * 2,))
        post = lin.register_forward_post_hook(
            lambda layer, inputs, out: out + 1)
        a = lin(mk([2]))
        pre.remove()
        b = lin(mk([2]))
        post.remove()
        c = lin(mk([2]))
        if mod is tnn:
            assert isinstance(pre, tnn.layer.layers.HookRemoveHelper)
            w = lin.weight.detach().numpy()
            bias = lin.bias.detach().numpy()
            np.testing.assert_allclose(a.detach().numpy(),
                                       2 * w.sum(0) + bias + 1, rtol=1e-6)
            np.testing.assert_allclose(b.detach().numpy(),
                                       w.sum(0) + bias + 1, rtol=1e-6)
            np.testing.assert_allclose(c.detach().numpy(), w.sum(0) + bias,
                                       rtol=1e-6)
        else:
            w, bias = lin.weight.numpy(), lin.bias.numpy()
            np.testing.assert_allclose(a.numpy(), 2 * w.sum(0) + bias + 1,
                                       rtol=1e-6)


def test_set_state_dict_returns_missing_and_unexpected():
    j, t = _JNet(), _TNet()
    arrays = _arrays(j)
    arrays.pop("bn._variance")
    arrays["extra"] = np.zeros(2, np.float32)
    jm, ju = j.set_state_dict({k: paddle.to_tensor(v)
                               for k, v in arrays.items()})
    tm, tu = t.set_state_dict(arrays)
    assert (tm, tu) == (jm, ju) == (["step", "bn._variance"], ["extra"])
    assert t.load_dict is not None
    np.testing.assert_array_equal(t.fc.weight.detach().numpy(),
                                  arrays["fc.weight"])
    with pytest.raises(ValueError, match="shape mismatch"):
        t.set_state_dict({"fc.weight": np.zeros((2, 2), np.float32)})


def test_create_and_add_parameters_and_sublayers():
    t = tnn.Layer(dtype="float64")
    p = t.create_parameter([2, 3])
    assert p.dtype == torch.float64 and p.requires_grad
    assert t.create_parameter([2], attr=False) is None
    assert t.add_parameter("w", p) is p and t.w is p
    with pytest.raises(TypeError):
        t.add_parameter("x", torch.ones(2))
    sub = tnn.Linear(2, 2)
    assert t.add_sublayer("fc", sub) is sub and t.fc is sub
    assert [n for n, _ in t.named_sublayers()] == ["fc"]
    c = t.create_tensor(persistable=True)
    assert c.shape == () and c.persistable
    frozen = t.create_parameter([2], attr=tnn.ParamAttr(
        trainable=False, learning_rate=0.5))
    assert not frozen.requires_grad and \
        frozen.optimize_attr["learning_rate"] == 0.5
    assert tnn.Linear(2, 3).extra_repr() == "in_features=2, out_features=3"


def _reference_layer_classes():
    """Every class the reference's nn exports (and its models) that
    subclasses its Layer, with the port's counterpart by name."""
    import paddle_tpu.text.models as jtext
    import paddle_tpu.vision.models as jvis
    import paddle_tpu_torch.text.models.bert as tbert
    import paddle_tpu_torch.text.models.gpt as tgpt
    import paddle_tpu_torch.vision.models as tvis
    from paddle_tpu.distributed.fleet.meta_parallel import (
        mp_layers as jmp)
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        mp_layers as tmp)

    pairs = []
    for jmod, tmods in ((jnn, [tnn]), (jvis, [tvis]),
                        (jtext, [tgpt, tbert]), (jmp, [tmp])):
        for name in dir(jmod):
            obj = getattr(jmod, name)
            if inspect.isclass(obj) and issubclass(obj, jnn.Layer):
                for tm in tmods:
                    if hasattr(tm, name):
                        pairs.append((name, getattr(tm, name)))
    return pairs


def test_every_port_layer_is_a_layer_where_the_reference_s_is():
    pairs = _reference_layer_classes()
    assert len(pairs) > 130
    bad = [name for name, cls in pairs if not issubclass(cls, tnn.Layer)]
    assert not bad, bad
    m = tpaddle.vision.models.resnet18(device="cpu")
    assert all(isinstance(s, tnn.Layer) for s in m.sublayers())


# ---- autograd ----

def _both(seed, shape, dtype=np.float64):
    a = np.random.default_rng(seed).standard_normal(shape).astype(dtype)
    return (paddle.to_tensor(a, stop_gradient=False),
            torch.tensor(a, requires_grad=True))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_grad_matches_the_reference(dtype):
    jx, tx = _both(0, (3, 4), dtype)
    jw, tw = _both(1, (4, 2), dtype)
    jy = paddle.tanh(paddle.matmul(jx, jw))
    ty = torch.tanh(tx @ tw)
    jg = paddle.grad(jy, [jx, jw], grad_outputs=paddle.to_tensor(
        np.full((3, 2), 0.5, dtype)), retain_graph=True)
    tg = tpaddle.grad(ty, [tx, tw], grad_outputs=torch.full(
        (3, 2), 0.5, dtype=tx.dtype), retain_graph=True)
    for a, b in zip(tg, jg):
        assert _rel(a.numpy(), b.numpy()) < _tol(a.numpy())
    # None grad_outputs are ones
    jd = paddle.grad((jx ** 3).sum(), jx)[0]
    td = tpaddle.grad((tx ** 3).sum(), tx)[0]
    assert _rel(td.numpy(), jd.numpy()) < _tol(td.numpy())
    # second order through create_graph (d²/dx² Σx³ = 6x)
    td = tpaddle.grad((tx ** 3).sum(), tx, create_graph=True)[0]
    t2 = tpaddle.grad(td.sum(), tx)[0]
    assert _rel(t2.numpy(), 6 * tx.detach().numpy()) < _tol(t2.numpy())


def test_grad_rules_unused_inputs_and_retained_graph():
    for grad, both in ((paddle.grad, lambda s: _both(s, (2,))[0]),
                       (tpaddle.grad, lambda s: _both(s, (2,))[1])):
        x, z = both(0), both(1)
        y = (x * 2).sum()
        with pytest.raises(ValueError, match="allow_unused"):
            grad(y, [x, z], retain_graph=True)
        gx, gz = grad(y, [x, z], allow_unused=True)
        assert gz is None and np.allclose(
            gx.numpy() if grad is paddle.grad else gx.detach().numpy(), 2.0)
    x = torch.ones(2, requires_grad=True)
    y = (x * x).sum()
    tpaddle.grad(y, x)          # retain_graph defaults to create_graph
    with pytest.raises(RuntimeError):
        tpaddle.grad(y, x)
    assert tpaddle.is_grad_enabled()
    with tpaddle.no_grad():
        assert not tpaddle.is_grad_enabled()
    with tpaddle.autograd.set_grad_enabled(False):
        assert not (x * 2).requires_grad
    x.grad = None
    tpaddle.autograd.backward([(x * 3).sum()], [torch.tensor(2.0)])
    assert x.grad.tolist() == [6.0, 6.0]


def _py_layers():
    class JCube(paddle.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, k=3.0):
            ctx.save_for_backward(x)
            return x ** 3 * k

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensor()
            return g * 9.0 * x ** 2

    class TCube(tpaddle.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, k=3.0):
            ctx.save_for_backward(x)
            return x ** 3 * k

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensor()
            return g * 9.0 * x ** 2

    return JCube, TCube


def test_py_layer_matches_the_reference():
    JCube, TCube = _py_layers()
    jx, tx = _both(3, (5,))
    jy, ty = JCube.apply(jx, k=3.0), TCube.apply(tx, k=3.0)
    assert _rel(ty.detach().numpy(), jy.numpy()) < 1e-12
    (jg,) = paddle.grad(jy.sum(), jx)
    (tg,) = tpaddle.grad(ty.sum(), tx)
    assert _rel(tg.numpy(), jg.numpy()) < 1e-12
    ctx = tpaddle.autograd.PyLayerContext()
    ctx.set_materialize_grads(False)
    ctx.mark_non_differentiable(tx)
    assert not ctx._materialize_grads and ctx._non_differentiable == (tx,)

    class TwoOut(tpaddle.autograd.PyLayer):
        @staticmethod
        def forward(ctx, a, scale, b):
            ctx.mark_non_differentiable(b)
            return [a * scale, b]

        @staticmethod
        def backward(ctx, ga, gb):
            return ga * 2.0, None

    a, b = torch.ones(2, requires_grad=True), torch.ones(2)
    out, out_b = TwoOut.apply(a, 2.0, b)
    out.sum().backward()
    assert a.grad.tolist() == [2.0, 2.0] and not out_b.requires_grad


# ---- save / load ----

def test_load_reads_a_file_the_reference_wrote(tmp_path):
    j = _JNet()
    arrays = _arrays(j)
    state = {"model": j.state_dict(), "step": 7, "lr": [0.1, (0.2,)]}
    path = str(tmp_path / "ref" / "model.pdparams")
    paddle.save(state, path)
    got = tpaddle.load(path)
    assert got["step"] == 7 and got["lr"] == [0.1, (0.2,)]
    assert list(got["model"]) == list(arrays)
    for k, v in got["model"].items():
        np.testing.assert_array_equal(v.detach().numpy(), arrays[k])
    assert isinstance(got["model"]["fc.weight"], torch.nn.Parameter)
    assert got["model"]["fc.weight"].requires_grad
    assert not isinstance(got["model"]["bn._mean"], torch.nn.Parameter)
    raw = tpaddle.load(path, return_numpy=True)
    assert isinstance(raw["model"]["fc.weight"], np.ndarray)
    t = _TNet()
    assert t.set_state_dict(got["model"]) == (["step"], [])
    np.testing.assert_array_equal(t.bn._variance.numpy(),
                                  arrays["bn._variance"])
    # the file names the reference's class, which the port never imports
    with open(path, "rb") as f:
        assert b"paddle_tpu.framework.io_state" in f.read()


def test_save_load_round_trip(tmp_path):
    t = _TNet()
    frozen = torch.nn.Parameter(torch.ones(2), requires_grad=False)
    obj = {"sd": t.state_dict(), "p": t.fc.weight, "frozen": frozen,
           "bf16": torch.ones(3, dtype=torch.bfloat16), "n": None}
    tpaddle.save(obj, str(tmp_path / "x.pd"))
    back = tpaddle.load(str(tmp_path / "x.pd"))
    assert isinstance(back["p"], torch.nn.Parameter) and \
        back["p"].requires_grad
    assert not back["frozen"].requires_grad
    assert back["bf16"].dtype == torch.float32 and back["n"] is None
    for k, v in t.state_dict().items():
        assert torch.equal(back["sd"][k], v)
    assert pickle.load(open(str(tmp_path / "x.pd"), "rb")) is not None


# ---- places, generators, flags, errors ----

def test_places_answer_for_this_machine():
    for mod in (paddle, tpaddle):
        assert mod.CPUPlace() == mod.CPUPlace()
        assert mod.TPUPlace(0) != mod.CUDAPlace(0)
        assert mod.CUDAPlace(2).get_device_id() == 2
        assert repr(mod.CUDAPlace(1)) == "Place(gpu:1)"
        assert isinstance(mod.CUDAPinnedPlace(), mod.CPUPlace)
        assert issubclass(mod.XPUPlace, mod.TPUPlace)
        assert len({mod.CPUPlace(), mod.CPUPlace(), mod.TPUPlace(1)}) == 2
    assert tpaddle.CUDAPlace(1).torch_device() == torch.device("cuda", 1)
    assert tpaddle.CPUPlace().torch_device() == torch.device("cpu")
    assert tpaddle.is_compiled_with_cuda() == torch.cuda.is_available()
    assert not tpaddle.is_compiled_with_tpu()
    assert not tpaddle.is_compiled_with_xpu()
    assert tpaddle.device_count() == torch.cuda.device_count()
    if not torch.cuda.is_available():
        assert tpaddle.get_cudnn_version() is None
    from paddle_tpu_torch.core import place

    old = place._current
    try:
        assert tpaddle.set_device(tpaddle.CPUPlace()) == torch.device("cpu")
        assert tpaddle.get_place() == tpaddle.CPUPlace()
        assert tpaddle.get_device() == "cpu"
    finally:
        place._current = old


def test_generators_replay_from_their_state():
    from paddle_tpu_torch.core import rng

    g = rng.Generator(5)
    s = g.get_state()
    a = torch.rand(4, generator=g.next_generator())
    b = torch.rand(4, generator=g.next_generator())
    assert not torch.equal(a, b)
    g.set_state(s)
    assert torch.equal(torch.rand(4, generator=g.next_generator()), a)
    assert g.manual_seed(5).get_state() == (5, 0)
    tracker = tpaddle.get_rng_state_tracker()
    tracker.reset()
    tracker.add("mp", 11)
    with pytest.raises(ValueError, match="already exists"):
        tracker.add("mp", 11)
    x = torch.ones(64)
    state = tracker.get("mp").get_state()
    with tracker.rng_state("mp"):
        d1 = tnn.functional.dropout(x, 0.5)
    tracker.get("mp").set_state(state)
    with tracker.rng_state("mp"):
        d2 = tnn.functional.dropout(x, 0.5)
    assert torch.equal(d1, d2) and tracker.get("mp").get_state() == (11, 1)
    tracker.reset()
    # the global stream: default_generator is seed()'s
    gen = rng.default_generator()
    tpaddle.seed(3)
    assert gen.get_state()[:2] == (3, 0) and gen.seed() == 3
    st = tpaddle.framework.get_cuda_rng_state()
    e1 = tnn.functional.dropout(x, 0.5)
    tpaddle.framework.set_cuda_rng_state(st)
    assert torch.equal(tnn.functional.dropout(x, 0.5), e1)
    gen.manual_seed(3)
    assert torch.equal(tnn.functional.dropout(x, 0.5), e1)


def test_flags_match_the_reference():
    from paddle_tpu.core import flags as jflags
    from paddle_tpu_torch.core import flags as tflags

    seen = {}
    for name, mod in (("j", jflags), ("t", tflags)):
        got = []
        mod.on_flag_change(f"pr_test_{name}", got.append)
        assert mod.define_flag(f"pr_test_{name}", 3, "doc") == 3
        assert mod.define_flag(f"pr_test_{name}", 9) == 3
        mod.set_flags({f"FLAGS_pr_test_{name}": "7"})
        mod.set_flags({f"pr_new_{name}": True})
        seen[name] = (mod.get_flags([f"pr_test_{name}", "missing"]),
                      mod.get_flags(f"pr_new_{name}"),
                      mod.get_flag("nope"), got)
    assert [list(seen["t"][0].values()), list(seen["t"][1].values()),
            seen["t"][2], seen["t"][3]] == \
        [list(seen["j"][0].values()), list(seen["j"][1].values()),
         seen["j"][2], seen["j"][3]] == [[7], [True], None, [7]]
    assert "check_nan_inf" in tpaddle.get_flags()
    tpaddle.set_flags({"log_level": 1})
    assert tpaddle.get_flags("log_level") == {"log_level": 1}
    tpaddle.set_flags({"log_level": 0})


def test_enforce_raises_the_reference_errors():
    from paddle_tpu.core import enforce as je
    from paddle_tpu_torch.core import enforce as te

    for name in ("EnforceNotMet", "InvalidArgumentError", "NotFoundError",
                 "UnimplementedError", "OutOfRangeError"):
        assert getattr(te, name).__mro__[1] is getattr(je, name).__mro__[1]
    te.enforce(True)
    with pytest.raises(te.EnforceNotMet, match="bad"):
        te.enforce(False, "bad")
    with pytest.raises(te.InvalidArgumentError, match="expected 1 == 2"):
        te.enforce_eq(1, 2, "x")
    with pytest.raises(te.InvalidArgumentError, match=r"expected 1 > 2"):
        te.enforce_gt(1, 2)
    with pytest.raises(te.InvalidArgumentError, match=r"\(2,\) vs \(3,\)"):
        te.enforce_shape_match([2], [3])


def test_save_group_sharded_model_writes_what_load_reads(tmp_path):
    from paddle_tpu_torch.distributed.sharding import \
        save_group_sharded_model
    from paddle_tpu_torch.optimizer import AdamW

    m = tnn.Linear(3, 2)
    opt = AdamW(1e-3, parameters=m.parameters())
    m(torch.ones(1, 3)).sum().backward()
    opt.step()
    out = str(tmp_path / "ck" / "model")
    save_group_sharded_model(m, out, opt)
    params = tpaddle.load(out + ".pdparams")
    assert torch.equal(params["weight"], m.weight.detach())
    assert set(tpaddle.load(out + ".pdopt")) == set(opt.state_dict())


# ---- coverage ----

_MODULES = ["nn.layer.layers", "autograd", "autograd.engine",
            "autograd.py_layer", "framework", "framework.io_state",
            "framework.random", "core.place", "core.rng", "core.flags",
            "core.enforce",
            # the high-level vision training path
            "io", "io.multiprocess", "metric", "profiler",
            "profiler.statistic", "hapi", "hapi.callbacks", "hapi.model",
            "hapi.dynamic_flops", "hapi.summary", "vision",
            "vision.transforms", "vision.transforms.functional",
            "vision.transforms.color_geometry", "vision.datasets",
            "vision.datasets.folder", "vision.datasets.flowers_voc",
            "vision.models", "vision.models.mobilenet",
            "vision.models.mobilenetv1", "vision.models.mobilenetv3",
            "vision.models.vgg", "vision.models.alexnet",
            "vision.models.squeezenet", "vision.models.densenet",
            "vision.models.googlenet", "vision.models.inceptionv3",
            "vision.models.shufflenetv2"]
# names of the reference's modules that name jax machinery the port has
# no use for (its own generators and devices stand in for them)
_JAX_ONLY = {"core.place": {"jax"}, "core.rng": {"jax", "np",
                                                 "trace_key_scope",
                                                 "next_key", "seed",
                                                 "contextlib",
                                                 "threading"},
             "autograd.engine": {"run_backward", "apply", "wrap",
                                 "GradNode", "no_grad_guard",
                                 "enable_grad_guard", "register_tensor_class",
                                 "jax", "jnp", "np", "threading"}}


def _public(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n, v in vars(mod).items() if not n.startswith("_")
                 and (inspect.isclass(v) or inspect.isfunction(v))
                 and getattr(v, "__module__", "") == mod.__name__]
    return set(names)


@pytest.mark.parametrize("path", _MODULES)
def test_every_reference_name_has_a_port(path):
    ref = importlib.import_module("paddle_tpu." + path)
    port = importlib.import_module("paddle_tpu_torch." + path)
    missing = sorted(n for n in _public(ref) - _JAX_ONLY.get(path, set())
                     if not hasattr(port, n))
    assert not missing, missing


_NEW_MODULES = [
    "nn/layer/layers.py", "nn/layer/rnn.py", "nn/layer/transformer.py",
    "nn/layer/loss.py", "nn/layer/common.py", "nn/functional/common.py",
    "nn/functional/loss.py", "nn/functional/extras.py", "nn/utils/__init__.py",
    "nn/quant/__init__.py", "autograd/__init__.py", "autograd/engine.py",
    "autograd/py_layer.py", "framework/__init__.py", "framework/io_state.py",
    "framework/random.py", "core/place.py", "core/rng.py", "core/flags.py",
    "core/enforce.py"]


@pytest.mark.parametrize("path", _NEW_MODULES)
def test_new_module_imports_neither_jax_nor_the_jax_package(path):
    """The AST rule of tests/test_torch_llm_engine.py over this slice's
    modules, each named (the scan there walks every file)."""
    import ast
    import os

    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "paddle_tpu_torch")
    with open(os.path.join(root, path)) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0]
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib",
                                                    "paddle_tpu",
                                                    "ml_dtypes")]
    assert not bad, bad
