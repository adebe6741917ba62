"""The static facade: the PyTorch port's `static` Program / Executor /
freeze / prune / run, every `static.nn` builder and every
`sequence_*` op against the JAX package on CPU, on the same numpy
inputs and weights (`Assign` initializers), within 1e-5. Mirrors
tests/test_static_extras.py."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as tpaddle
from paddle_tpu import nn as jnn
from paddle_tpu import static as jstatic
from paddle_tpu.static import nn as jsnn
from paddle_tpu.static.sequence import LoDTensor as JLoD
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.static import nn as tsnn
from paddle_tpu_torch.static.sequence import LoDTensor as TLoD

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


CPU = tpaddle.CPUPlace()


@pytest.fixture(autouse=True)
def _serial_mesh():
    from paddle_tpu.distributed import mesh as mesh_mod

    mesh_mod.reset_mesh()
    yield


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(got, want, tol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = want.numpy() if hasattr(want, "numpy") else want
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------- program

def _build(static_mod):
    main = static_mod.Program()
    with static_mod.program_guard(main):
        static_mod.data(name="x", shape=[None, 4], dtype="float32")
        static_mod.data(name="k", shape=[None, 4], dtype="float32")
    main.stages.append(lambda env: env.__setitem__("y", env["x"] * 2.0))
    main.stages.append(lambda env: env.__setitem__("z", env["y"] + 3.0))
    # w depends on k ONLY — pruning to z must drop k from the feeds
    main.stages.append(lambda env: env.__setitem__(
        "w", (env["k"] * env["k"]).sum()))
    return main


FEED = {"x": _rng(0).normal(size=(2, 4)).astype(np.float32),
        "k": np.full((2, 4), 2.0, np.float32)}


def test_executor_matches_reference():
    want = jstatic.Executor().run(_build(jstatic), feed=FEED,
                                  fetch_list=["z", "w"])
    got = tstatic.Executor(CPU).run(_build(tstatic), feed=FEED,
                                    fetch_list=["z", "w"])
    for g, w in zip(got, want):
        _close(g, w)


def test_freeze_run_and_prune():
    main = _build(tstatic)
    ir = main.freeze(fetch_list=["z", "w"], batch_size=2, place=CPU)
    assert "aten.mul.Tensor" in ir.ops and "aten.add.Tensor" in ir.ops
    assert ir.op_histogram()["aten.mul.Tensor"] >= 2
    assert "mul" in ir.as_text()
    out = ir.run(FEED)
    eager = tstatic.Executor(CPU).run(main, feed=FEED, fetch_list=["z", "w"])
    _close(out["z"], eager[0])
    _close(out["w"], eager[1])
    pruned = ir.prune(["z"])
    assert len(pruned.ops) < len(ir.ops)
    assert "aten.sum.default" not in pruned.ops
    assert pruned.feed_names == ["x"]
    out = pruned.run({"x": FEED["x"]})
    assert set(out) == {"z"}
    _close(out["z"], FEED["x"] * 2.0 + 3.0)
    with pytest.raises(KeyError):
        ir.prune(["nope"])


def test_frozen_run_checks_the_signature():
    ir = _build(tstatic).freeze(fetch_list=["z"], batch_size=2, place=CPU)
    with pytest.raises(ValueError, match="frozen at"):
        ir.run({"x": np.ones((5, 4), np.float32),
                "k": np.ones((2, 4), np.float32)})
    with pytest.raises(ValueError, match="frozen at"):
        ir.run({"x": np.ones((2, 4), np.float64),
                "k": np.ones((2, 4), np.float32)})
    with pytest.raises(KeyError, match="placeholder"):
        _build(tstatic).freeze(fetch_list=["z"], place=CPU,
                               feed_specs={"X": ((2, 4), "float32")})


def test_freeze_lifts_layer_constants_and_prunes_them():
    """The parameters a stage closes over become leading inputs; a fetch
    that does not reach a layer drops that layer's constants."""
    fc = tnn.Linear(4, 3)
    main = tstatic.Program()
    with tstatic.program_guard(main):
        tstatic.data("x", [2, 4])
    main.stages.append(lambda env: env.__setitem__("h", fc(env["x"])))
    main.stages.append(lambda env: env.__setitem__("d", env["x"] * 3.0))
    ir = main.freeze(["h", "d"], place=CPU)
    assert len(ir._consts) == 2
    assert len(ir.prune(["d"])._consts) == 0
    with torch.no_grad():
        _close(ir.run({"x": FEED["x"]})["h"], fc(torch.from_numpy(FEED["x"])))


def test_freeze_keeps_tensor_control_flow_as_cond():
    """A to_static function with a tensor `if` freezes to torch.cond: the
    frozen program takes either arm by its feed."""
    @tpaddle.jit.to_static
    def pick(x):
        if x.sum() > 0:
            y = x * 2.0
        else:
            y = x - 1.0
        return y

    main = tstatic.Program()
    with tstatic.program_guard(main):
        tstatic.data("x", [2, 4])
    main.stages.append(lambda env: env.__setitem__("y", pick(env["x"])))
    ir = main.freeze(["y"], place=CPU)
    assert any("cond" in op for op in ir.ops)
    for sign in (1.0, -1.0):
        x = np.abs(FEED["x"]) * sign
        _close(ir.run({"x": x})["y"], pick(torch.from_numpy(x)))


def test_clone_envelope_and_dataset_loop():
    main = tstatic.Program()
    with tstatic.program_guard(main):
        tstatic.data(name="x", shape=[None, 2], dtype="float32")
    main.stages.append(lambda env: env.__setitem__("y", env["x"] * 2))
    cloned = main.clone(for_test=True)
    cloned.stages.append(lambda env: env.__setitem__("z", env["y"] + 1))
    assert len(main.stages) == 1 and len(cloned.stages) == 2
    exe = tstatic.Executor(CPU)
    (z,) = exe.run(cloned, feed={"x": np.ones((1, 2), np.float32)},
                   fetch_list=["z"])
    _close(z, [[3.0, 3.0]])

    class DS(list):
        _use_var = ["x"]

    ds = DS([[(np.ones(2, np.float32),)] * 2] * 3)
    (y,) = exe.train_from_dataset(program=main, dataset=ds,
                                  fetch_list=["y"])
    _close(y, np.full((2, 2), 2.0))
    assert exe.infer_from_dataset(program=main, dataset=ds,
                                  fetch_list=["y"]) is not None
    with pytest.raises(ValueError):
        exe.train_from_dataset(program=main)


def test_facade_surface(tmp_path, capsys):
    bs = tstatic.BuildStrategy()
    cp = tstatic.CompiledProgram(tstatic.Program(), bs).with_data_parallel()
    assert cp.build_strategy is bs
    assert tstatic.ParallelExecutor is tstatic.CompiledProgram
    assert tstatic.Scope().local_scope() is not None
    with tstatic.ipu_shard_guard():
        pass
    with pytest.raises(RuntimeError):
        tstatic.IpuCompiledProgram()
    gv = tstatic.create_global_var([2], 1.5, "float32")
    _close(gv, [1.5, 1.5])
    from paddle_tpu_torch.core import place

    tpaddle.set_device("cpu")
    try:
        assert tuple(tstatic.create_parameter([2, 3], "float32").shape) \
            == (2, 3)
    finally:
        place._current = None
    data = tstatic.serialize_program([], [])
    assert isinstance(tstatic.deserialize_program(data), tstatic.Program)
    tstatic.save_to_file(str(tmp_path / "b"), b"abc")
    assert tstatic.load_from_file(str(tmp_path / "b")) == b"abc"
    assert tstatic.exponential_decay(0.1, 100, 0.9) is not None
    tstatic.save(tstatic.Program(), str(tmp_path / "p"))
    assert (tmp_path / "p.pdmodel").exists()
    assert tstatic.load(tstatic.Program(), str(tmp_path / "p")) is None
    with pytest.raises(NotImplementedError, match="jit.save"):
        tstatic.save_inference_model("p", [], [], None)
    with pytest.raises(NotImplementedError, match="jit.load"):
        tstatic.load_inference_model("p", None)
    x = torch.tensor([1.0, 2.0])
    assert tstatic.Print(x, message="dbg") is x
    assert "dbg" in capsys.readouterr().out
    assert list(tstatic.batch(lambda: iter(range(5)), 2)()) == [
        [0, 1], [2, 3], [4]]
    assert tpaddle.in_dynamic_mode()
    tpaddle.enable_static()
    assert not tpaddle.in_dynamic_mode()
    tpaddle.disable_static()
    assert tpaddle.in_dynamic_mode()


def test_metrics_match_reference():
    probs = np.array([[0.1, 0.9], [0.8, 0.2]], np.float32)
    lbl = np.array([[1], [1]])
    _close(tstatic.accuracy(torch.from_numpy(probs), torch.from_numpy(lbl)),
           jstatic.accuracy(paddle.to_tensor(probs), paddle.to_tensor(lbl)))
    p2 = np.array([[0.3, 0.7], [0.6, 0.4]], np.float32)
    l2 = np.array([1, 0])
    _close(tstatic.auc(torch.from_numpy(p2), torch.from_numpy(l2))[0],
           jstatic.auc(paddle.to_tensor(p2), paddle.to_tensor(l2))[0])
    p, y = np.array([0.5, 0.8], np.float32), np.array([0.0, 1.0], np.float32)
    for g, w in zip(tstatic.ctr_metric_bundle(p, y),
                    jstatic.ctr_metric_bundle(paddle.to_tensor(p),
                                              paddle.to_tensor(y))):
        _close(g, w)


def test_ema_apply_restore():
    ema = tstatic.ExponentialMovingAverage(0.5)
    p = torch.nn.Parameter(torch.full((2,), 4.0))
    ema.update([p])
    with torch.no_grad():
        p.fill_(8.0)
    ema.update([p])
    with ema.apply():
        assert float(p[0]) < 8.0
    assert float(p[0]) == 8.0


# ---------------------------------------------------------------- builders

def _attr(pkg_nn, arr):
    return pkg_nn.ParamAttr(initializer=pkg_nn.initializer.Assign(arr))


def _both(fn, *arrays, tol=1e-5):
    """fn(snn, nn_pkg, *tensors) in both packages; outputs compared."""
    want = fn(jsnn, jnn, *[paddle.to_tensor(a) for a in arrays])
    got = fn(tsnn, tnn, *[torch.from_numpy(np.asarray(a)) for a in arrays])
    for g, w in zip(got if isinstance(got, (list, tuple)) else [got],
                    want if isinstance(want, (list, tuple)) else [want]):
        _close(g, w, tol)


R = _rng(1)
W44 = R.standard_normal((4, 6)).astype(np.float32)
X24 = R.standard_normal((2, 4)).astype(np.float32)
IMG = R.standard_normal((2, 3, 6, 6)).astype(np.float32)
VOL = R.standard_normal((1, 2, 4, 4, 4)).astype(np.float32)
K2D = R.standard_normal((5, 3, 3, 3)).astype(np.float32) * 0.3
K2T = R.standard_normal((3, 5, 3, 3)).astype(np.float32) * 0.3
K3D = R.standard_normal((3, 2, 2, 2, 2)).astype(np.float32) * 0.3
K3T = R.standard_normal((2, 3, 2, 2, 2)).astype(np.float32) * 0.3

BUILDERS = {
    "fc": (lambda s, n, x: s.fc(x, 6, weight_attr=_attr(n, W44),
                                bias_attr=_attr(n, W44[0]),
                                activation="relu"), [X24]),
    "fc_multi": (lambda s, n, x: s.fc([x, x * 2], 6,
                                      weight_attr=_attr(n, W44)), [X24]),
    "conv2d": (lambda s, n, x: s.conv2d(x, 5, 3, padding=1,
                                        param_attr=_attr(n, K2D),
                                        act="relu"), [IMG]),
    "conv3d": (lambda s, n, x: s.conv3d(x, 3, 2,
                                        param_attr=_attr(n, K3D)), [VOL]),
    "conv2d_transpose": (lambda s, n, x: s.conv2d_transpose(
        x, 5, filter_size=3, stride=2, param_attr=_attr(n, K2T)), [IMG]),
    "conv2d_transpose_output_size": (lambda s, n, x: s.conv2d_transpose(
        x, 5, output_size=[13, 13], stride=2, param_attr=_attr(n, K2T)),
        [IMG]),
    "conv3d_transpose": (lambda s, n, x: s.conv3d_transpose(
        x, 3, filter_size=2, param_attr=_attr(n, K3T)), [VOL]),
    "batch_norm_train": (lambda s, n, x: s.batch_norm(x), [IMG]),
    "batch_norm_test": (lambda s, n, x: s.batch_norm(x, is_test=True),
                        [IMG]),
    "instance_norm": (lambda s, n, x: s.instance_norm(x), [IMG]),
    "layer_norm": (lambda s, n, x: s.layer_norm(x, act="relu"), [IMG]),
    "group_norm": (lambda s, n, x: s.group_norm(x[:, :2].reshape(
        [2, 2, 6, 6]), 2), [IMG]),
    "data_norm": (lambda s, n, x: s.data_norm(x), [X24]),
    "embedding": (lambda s, n, i: s.embedding(i, (5, 6),
                                              param_attr=_attr(n, R2W)),
                  [np.array([[0, 3], [4, 1]])]),
    "sparse_embedding": (lambda s, n, i: s.sparse_embedding(
        i, (5, 6), param_attr=_attr(n, R2W)), [np.array([1, 2, 2])]),
    "prelu_all": (lambda s, n, x: s.prelu(x, "all"), [IMG]),
    "prelu_channel": (lambda s, n, x: s.prelu(
        x, "channel", param_attr=_attr(n, np.array([0.1, 0.2, 0.3],
                                                    np.float32))), [IMG]),
    "prelu_element": (lambda s, n, x: s.prelu(x, "element"), [X24]),
    "spectral_norm": (lambda s, n, w: s.spectral_norm(w, power_iters=3),
                      [W44]),
    "bilinear": (lambda s, n, x, y: s.bilinear_tensor_product(
        x, y, 3, param_attr=_attr(n, BIW)), [X24, W44[:2]]),
    "row_conv": (lambda s, n, x: s.row_conv(x, 2, param_attr=_attr(
        n, W44[:3])), [R.standard_normal((2, 5, 6)).astype(np.float32)]),
    "row_conv_flat": (lambda s, n, x: s.row_conv(x, 1, param_attr=_attr(
        n, W44[:2])), [R.standard_normal((5, 6)).astype(np.float32)]),
    "crf_decoding": (lambda s, n, x, t: s.crf_decoding(x, transition=t),
                     [R.standard_normal((2, 5, 4)).astype(np.float32),
                      R.standard_normal((4, 4)).astype(np.float32)]),
    "py_func": (lambda s, n, x: s.py_func(lambda a: a * 2 + 1, x, None),
                [X24]),
    "cvm": (lambda s, n, x, c: s.continuous_value_model(x, c, True),
            [X24, X24[:, :2]]),
    "cvm_strip": (lambda s, n, x, c: s.continuous_value_model(x, c, False),
                  [X24, X24[:, :2]]),
}
R2W = R.standard_normal((5, 6)).astype(np.float32)
BIW = R.standard_normal((3, 4, 6)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_matches_reference(name):
    fn, arrays = BUILDERS[name]
    _both(fn, *arrays)


def test_deform_conv2d_builder_matches_reference():
    x = R.standard_normal((1, 2, 5, 5)).astype(np.float32)
    off = R.standard_normal((1, 18, 5, 5)).astype(np.float32) * 0.7
    mask = R.random((1, 9, 5, 5)).astype(np.float32)
    w = R.standard_normal((3, 2, 3, 3)).astype(np.float32)
    _both(lambda s, n, a, o, m: s.deform_conv2d(
        a, o, m, 3, 3, padding=1, weight_attr=_attr(n, w)), x, off, mask)


def test_nce_matches_reference_on_the_same_noise(monkeypatch):
    import jax
    import jax.numpy as jnp

    from paddle_tpu_torch.static import nn_build

    neg = np.array([[1, 2, 3], [0, 4, 4], [2, 2, 1], [3, 0, 4]])
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.asarray(neg))
    monkeypatch.setattr(nn_build, "_nce_negatives",
                        lambda *a: torch.from_numpy(neg))
    x = R.standard_normal((4, 6)).astype(np.float32)
    w, b = R2W, R2W[:, 0].copy()
    _both(lambda s, n, a, lbl: s.nce(a, lbl, 5, num_neg_samples=3,
                                     param_attr=_attr(n, w),
                                     bias_attr=_attr(n, b)),
          x, np.array([1, 2, 3, 0]))


def test_nce_draws_from_the_ports_generator():
    x = torch.randn(4, 6)
    out = tsnn.nce(x, torch.tensor([1, 2, 3, 0]), 10)
    assert out.shape == (4, 1) and bool((out > 0).all())


def test_multi_box_head_priors_match_reference():
    feats = [R.standard_normal((1, 4, 3, 3)).astype(np.float32),
             R.standard_normal((1, 4, 2, 2)).astype(np.float32)]
    img = np.zeros((1, 3, 12, 12), np.float32)
    kw = dict(base_size=12, num_classes=3, aspect_ratios=[[2.0], [2.0, 3.0]],
              min_ratio=20, max_ratio=90, clip=True)
    want = jsnn.multi_box_head([paddle.to_tensor(f) for f in feats],
                               paddle.to_tensor(img), **kw)
    got = tsnn.multi_box_head([torch.from_numpy(f) for f in feats],
                              torch.from_numpy(img), **kw)
    for g, w in zip(got[:2], want[:2]):
        assert tuple(g.shape) == tuple(w.shape)
    _close(got[2], want[2])
    _close(got[3], want[3])


def _rnn(snn, seq, w):
    rnn = snn.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(seq)
        h = rnn.memory(shape=[2], batch_ref=seq)
        nh = (h + xt) * w
        rnn.update_memory(h, nh)
        rnn.step_output(nh)
    return rnn()


def test_static_rnn_replay_and_gradients():
    seq = np.arange(12.0, dtype=np.float32).reshape(3, 2, 2)
    jw = paddle.create_parameter([2], "float32")
    jw._value = jw._value * 0 + 0.5
    jw.stop_gradient = False
    want = _rnn(jsnn, paddle.to_tensor(seq), jw)
    tw = torch.nn.Parameter(torch.full((2,), 0.5))
    got = _rnn(tsnn, torch.from_numpy(seq), tw)
    _close(got, want)
    want.sum().backward()
    got.sum().backward()
    _close(tw.grad, jw.grad)


# ---------------------------------------------------------------- sequences

LOD = [0, 2, 2, 5, 6]
FLAT = R.standard_normal((6, 3)).astype(np.float32)


def _lods(arr=FLAT, lod=LOD):
    return JLoD(arr, lod), TLoD(torch.from_numpy(np.asarray(arr)), lod)


def _seq_both(fn, *extra):
    j, t = _lods()
    want = fn(jsnn, j, *extra)
    got = fn(tsnn, t, *extra)
    for g, w in zip(got if isinstance(got, tuple) else [got],
                    want if isinstance(want, tuple) else [want]):
        _close(g, w)
        if hasattr(w, "lod"):
            assert list(g.lod) == list(w.lod)


SEQ = {
    "pool_sum": lambda s, x: s.sequence_pool(x, "sum"),
    "pool_average": lambda s, x: s.sequence_pool(x, "average"),
    "pool_sqrt": lambda s, x: s.sequence_pool(x, "sqrt"),
    "pool_max": lambda s, x: s.sequence_pool(x, "max", pad_value=-7.0),
    "pool_min": lambda s, x: s.sequence_pool(x, "min"),
    "first_step": lambda s, x: s.sequence_first_step(x),
    "last_step": lambda s, x: s.sequence_last_step(x),
    "softmax": lambda s, x: s.sequence_softmax(
        s.LoDTensor(x.numpy()[:, :1] if hasattr(x, "_value") else
                    x[:, :1], LOD)),
    "reverse": lambda s, x: s.sequence_reverse(x),
    "concat": lambda s, x: s.sequence_concat([x, x]),
    "pad": lambda s, x: s.sequence_pad(x, np.float32(-1.0)),
    "pad_maxlen": lambda s, x: s.sequence_pad(x, np.float32(0.5), maxlen=2),
    "expand": lambda s, x: s.sequence_expand(x, x),
    "reshape": lambda s, x: s.sequence_reshape(x, 1),
    "slice": lambda s, x: s.sequence_slice(
        x, np.array([0, 0, 1, 0]), np.array([1, 0, 2, 1])),
}


@pytest.mark.parametrize("name", sorted(SEQ))
def test_sequence_op_matches_reference(name):
    _seq_both(SEQ[name])


def test_sequence_unpad_expand_as_scatter_enumerate_conv():
    padded = R.standard_normal((3, 4, 2)).astype(np.float32)
    lens = np.array([2, 0, 3])
    want = jsnn.sequence_unpad(paddle.to_tensor(padded),
                               paddle.to_tensor(lens))
    got = tsnn.sequence_unpad(torch.from_numpy(padded), torch.from_numpy(lens))
    _close(got, want)
    assert got.lod == want.lod
    y = _lods()
    rows = FLAT[:4]
    for g, w in ((tsnn.sequence_expand_as(torch.from_numpy(rows), y[1]),
                  jsnn.sequence_expand_as(paddle.to_tensor(rows), y[0])),
                 (tsnn.sequence_expand(torch.from_numpy(rows), y[1]),
                  jsnn.sequence_expand(paddle.to_tensor(rows), y[0]))):
        _close(g, w)
        assert g.lod == w.lod
    base = np.zeros((3, 5), np.float32)
    idx_lod = [0, 2, 3, 5]
    idx = np.array([[0], [4], [2], [1], [1]])
    upd = np.arange(5, dtype=np.float32)
    _close(tsnn.sequence_scatter(torch.from_numpy(base),
                                 TLoD(torch.from_numpy(idx), idx_lod),
                                 torch.from_numpy(upd)),
           jsnn.sequence_scatter(paddle.to_tensor(base), JLoD(idx, idx_lod),
                                 paddle.to_tensor(upd)))
    ids = np.array([[1], [2], [3], [4], [5]])
    _close(tsnn.sequence_enumerate(TLoD(torch.from_numpy(ids), [0, 3, 5]), 2),
           jsnn.sequence_enumerate(JLoD(ids, [0, 3, 5]), 2))
    w = R.standard_normal((9, 4)).astype(np.float32)
    j, t = _lods()
    _close(tsnn.sequence_conv(t, 4, 3, param_attr=_attr(tnn, w), act="tanh"),
           jsnn.sequence_conv(j, 4, 3, param_attr=_attr(jnn, w), act="tanh"))


def test_lod_tensor_keeps_autograd_history():
    x = torch.randn(6, 3, requires_grad=True)
    out = tsnn.sequence_pool(TLoD(x * 2.0, LOD), "sum")
    out.sum().backward()
    _close(x.grad, np.full((6, 3), 2.0))
