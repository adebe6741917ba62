"""The high-level API (paddle_tpu_torch/hapi, metric, profiler) against the
JAX package's on the CPU.

* `Model.fit` / `evaluate` / `predict` (Momentum, batch 8, no shuffle,
  the port's seeded weights loaded into the reference, dropout at p 0):
  LeNet, every loss and the eval logs within 1e-5; MobileNetV2 at scale
  0.25 on 64×64 images, eval and predict within 1e-5 and the fit's
  losses held as the zoo test holds train mode (f32 rounding through
  train-mode batch norm grows step by step in either framework).
* `Accuracy` ranks as the reference does where scores tie (numpy's
  unstable argsort), which `torch.topk` does not; Precision, Recall,
  Auc and `accuracy` equal the reference's.
* Each callback fed the same events and logs as the reference's does
  the same: the bar's lines, checkpoints, LR steps, early stops, plateau
  cuts.
* `flops` and `summary` count what the reference's count.
* `save` / `load` round trips, and the port's `load` reads the
  reference's own `.pdparams` / `.pdopt`.
* The profiler: the `benchmark()` meter fed by `TrainStep` (a tick and
  the batch size a step, the steptrace wall when the plane is on), a
  recorded window's chrome trace parsed into the op tables.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import hapi as jhapi
from paddle_tpu import io as jio
from paddle_tpu import metric as jmetric
from paddle_tpu.nn import initializer as jinit
from paddle_tpu.vision import models as JM
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import hapi as thapi
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import metric as tmetric
from paddle_tpu_torch import profiler as tprofiler
from paddle_tpu_torch.convert import export_state_dict
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.observability import steptrace
from paddle_tpu_torch.vision import models as TM

pytestmark = pytest.mark.torch_port

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _zero_init(self, shape, dtype):
    return jnp.asarray(np.zeros(shape, np.dtype(dtype)))


def _pair(name, monkeypatch, **kw):
    """(reference model, port model) holding the port's seeded weights;
    the reference built with its initializers stubbed (see
    tests/test_torch_vision_zoo.py)."""
    tm = getattr(TM, name)(device="cpu", **kw)
    for cls in vars(jinit).values():
        if isinstance(cls, type) and "_init" in vars(cls):
            monkeypatch.setattr(cls, "_init", _zero_init)
    jm = getattr(JM, name)(**kw)
    monkeypatch.undo()
    jm.set_state_dict(export_state_dict(tm))
    for m in list(jm.sublayers()) + list(tm.modules()):
        if type(m).__name__ == "Dropout":
            m.p = 0.0
    return jm, tm


class _Images:
    def __init__(self, n, seed, shape=(3, 64, 64)):
        rng = np.random.default_rng(seed)
        self.x = rng.standard_normal((n,) + shape).astype(np.float32)
        self.y = rng.integers(0, 10, (n,)).astype(np.int64)

    def __getitem__(self, i):
        return self.x[i], self.y[i]

    def __len__(self):
        return len(self.x)


class _JImages(_Images, jio.Dataset):
    pass


class _TImages(_Images, tio.Dataset):
    pass


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


class _Losses(thapi.Callback):
    """Collects each train step's loss."""

    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(np.asarray(logs["loss"]).reshape(-1)[0]))


class _JLosses(jhapi.Callback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(np.asarray(logs["loss"]).reshape(-1)[0]))


def _prepared(jm, tm, lr):
    jmodel, tmodel = jhapi.Model(jm), thapi.Model(tm)
    jmodel.prepare(paddle.optimizer.Momentum(
        lr, momentum=0.9, parameters=jm.parameters()),
        paddle.nn.CrossEntropyLoss(), jmetric.Accuracy(topk=(1, 5)))
    tmodel.prepare(tpaddle.optimizer.Momentum(
        lr, momentum=0.9, parameters=tm.parameters()),
        tpaddle.nn.CrossEntropyLoss(), tmetric.Accuracy(topk=(1, 5)),
        amp_configs={"level": "O1"})   # stored, unused: runs in f32
    return jmodel, tmodel


def _fit_both(jmodel, tmodel, shape, epochs):
    jc, tc = _JLosses(), _Losses()
    with jax.default_matmul_precision("highest"):
        jlogs = jmodel.fit(_JImages(24, 0, shape), _JImages(16, 1, shape),
                           batch_size=8, epochs=epochs, shuffle=False,
                           verbose=0, callbacks=[jc])
    tlogs = tmodel.fit(_TImages(24, 0, shape), _TImages(16, 1, shape),
                       batch_size=8, epochs=epochs, shuffle=False,
                       verbose=0, callbacks=[tc])
    assert len(tc.losses) == len(jc.losses) == 3 * epochs
    assert set(tlogs) == set(jlogs)
    return np.array(tc.losses), np.array(jc.losses), tlogs, jlogs


def _eval_predict_both(jmodel, tmodel, shape):
    with jax.default_matmul_precision("highest"):
        jres = jmodel.evaluate(_JImages(16, 2, shape), batch_size=8,
                               verbose=0)
        jpred = jmodel.predict(_JImages(12, 3, shape), batch_size=8,
                               stack_outputs=True)
    tres = tmodel.evaluate(_TImages(16, 2, shape), batch_size=8, verbose=0)
    tpred = tmodel.predict(_TImages(12, 3, shape), batch_size=8,
                           stack_outputs=True)
    assert abs(tres["loss"] - jres["loss"]) <= TOL * abs(jres["loss"])
    assert tres["acc_top1"] == jres["acc_top1"]
    assert tres["acc_top5"] == jres["acc_top5"]
    assert tpred[0].shape == (12, 10) and _rel(tpred[0], jpred[0]) <= TOL


def test_fit_evaluate_predict_match_the_reference(monkeypatch):
    """LeNet (no batch norm), two epochs of three Momentum(1e-2) steps:
    every loss, the eval logs, `evaluate` and `predict` within 1e-5."""
    jm, tm = _pair("LeNet", monkeypatch)
    jmodel, tmodel = _prepared(jm, tm, 1e-2)
    tl, jl, tlogs, jlogs = _fit_both(jmodel, tmodel, (1, 28, 28), 2)
    assert np.all(np.abs(tl - jl) <= TOL * np.abs(jl)), (tl, jl)
    assert abs(tlogs["eval_loss"] - jlogs["eval_loss"]) <= \
        TOL * abs(jlogs["eval_loss"])
    assert tlogs["eval_acc_top1"] == jlogs["eval_acc_top1"]
    assert tlogs["eval_acc_top5"] == jlogs["eval_acc_top5"]
    assert tmodel._optimizer._step_count == 6
    _eval_predict_both(jmodel, tmodel, (1, 28, 28))


def _f64_losses(tm, lr, steps):
    """The port's losses of the same steps in f64 on a copy: its own
    distance from exact arithmetic."""
    import copy

    m = copy.deepcopy(tm).to(torch.float64)
    step = tpaddle.jit.TrainStep(
        m, lambda mm, x, y: tpaddle.nn.functional.cross_entropy(mm(x), y),
        tpaddle.optimizer.Momentum(lr, momentum=0.9,
                                   parameters=m.parameters()))
    data = _Images(24, 0)
    return np.array([float(step(torch.from_numpy(
        data.x[i:i + 8]).double(), torch.from_numpy(data.y[i:i + 8])))
        for i in range(0, 8 * steps, 8)])


def test_mobilenet_v2_under_fit_matches_the_reference(monkeypatch):
    """MobileNetV2 at scale 0.25 on 64×64 images, batch 8: `evaluate` and
    `predict` (eval mode) within 1e-5 before training; then three
    Momentum(1e-3) steps: the first loss within 1e-5, the next within
    1e-5 or 8x the port's own f32 distance from its f64 run. Train-mode
    batch norm over the last stage's 2×2 maps amplifies f32 rounding
    step by step: the port's f32 and f64 runs part by 2e-7, 5e-6, then
    5.7e-3 of the loss (measured), and the reference's f32 run parts
    from both alike (the zoo test's train-mode rule)."""
    jm, tm = _pair("mobilenet_v2", monkeypatch, scale=0.25, num_classes=10)
    jmodel, tmodel = _prepared(jm, tm, 1e-3)
    _eval_predict_both(jmodel, tmodel, (3, 64, 64))
    exact = _f64_losses(tm, 1e-3, 3)
    tl, jl, _, _ = _fit_both(jmodel, tmodel, (3, 64, 64), 1)
    assert abs(tl[0] - jl[0]) <= TOL * abs(jl[0])
    noise = np.abs(tl - exact)
    assert np.all(np.abs(tl - jl) <= np.maximum(TOL * np.abs(jl),
                                                8 * noise)), (tl, jl, exact)
    assert tmodel._optimizer._step_count == 3


def test_train_batch_rules():
    net = tpaddle.nn.Linear(4, 3)
    model = thapi.Model(net)
    with pytest.raises(RuntimeError, match="prepare"):
        model.train_batch([np.zeros((2, 4), np.float32)])
    model.prepare(tpaddle.optimizer.SGD(0.1, parameters=net.parameters()),
                  tpaddle.nn.CrossEntropyLoss())
    with pytest.raises(NotImplementedError, match="update=False"):
        model.train_batch([np.zeros((2, 4), np.float32)],
                          [np.zeros((2, 1), np.int64)], update=False)
    with pytest.raises(TypeError):
        model.prepare(loss="not callable")


# ---- metrics ----------------------------------------------------------------

def test_accuracy_with_tied_scores_ranks_as_the_reference():
    rng = np.random.default_rng(0)
    pred = rng.integers(0, 3, (64, 6)).astype(np.float32)   # many ties
    label = rng.integers(0, 6, (64, 1)).astype(np.int64)
    j, t = jmetric.Accuracy(topk=(1, 2, 3)), tmetric.Accuracy(topk=(1, 2, 3))
    jc = np.asarray(j.compute(paddle.to_tensor(pred),
                              paddle.to_tensor(label)).numpy())
    tc = t.compute(torch.from_numpy(pred), torch.from_numpy(label))
    np.testing.assert_array_equal(tc.numpy(), jc)
    assert t.update(tc) == j.update(jc)
    assert t.accumulate() == j.accumulate() and t.name() == j.name()
    # torch.topk orders the ties otherwise: ranking with it would differ
    topk = torch.topk(torch.from_numpy(pred), 3).indices.numpy()
    assert not np.array_equal(topk == label, jc.astype(bool))
    for k in (1, 3):
        assert float(tmetric.accuracy(torch.from_numpy(pred),
                                      torch.from_numpy(label), k=k)) == \
            float(jmetric.accuracy(paddle.to_tensor(pred),
                                   paddle.to_tensor(label), k=k).numpy())


def test_precision_recall_auc_equal_the_reference():
    rng = np.random.default_rng(1)
    for _ in range(3):
        p = rng.random((50, 1)).astype(np.float32)
        y = rng.integers(0, 2, (50, 1)).astype(np.int64)
        for name in ("Precision", "Recall", "Auc"):
            j, t = getattr(jmetric, name)(), getattr(tmetric, name)()
            j.update(p, y)
            t.update(torch.from_numpy(p), torch.from_numpy(y))
            assert t.accumulate() == j.accumulate(), name
            assert t.name() == j.name()
    two = rng.random((20, 2)).astype(np.float32)
    j, t = jmetric.Auc(num_thresholds=99), tmetric.Auc(num_thresholds=99)
    y = rng.integers(0, 2, (20,))
    j.update(two, y)
    t.update(two, y)
    assert t.accumulate() == j.accumulate()


# ---- callbacks --------------------------------------------------------------

class _FakeModel:
    """What the callbacks touch of a Model: save, the optimizer,
    stop_training."""

    def __init__(self, opt):
        self._optimizer = opt
        self.stop_training = False
        self.saved = []

    def save(self, path):
        self.saved.append(path)


def _drive(cb, model, evals, steps=3, epochs=3):
    """Run a callback through fit's event order with fixed logs."""
    cb.set_model(model)
    cb.set_params({"epochs": epochs, "steps": steps, "verbose": 2,
                   "save_dir": "/ckpt"})
    cb.on_train_begin()
    lrs = []
    for e in range(epochs):
        cb.on_epoch_begin(e)
        for s in range(steps):
            cb.on_train_batch_begin(s)
            cb.on_train_batch_end(s, {"loss": [0.5 + s], "batch_size": 4})
            lrs.append(model._optimizer.get_lr())
        cb.on_epoch_end(e, {"loss": [0.5]})
        cb.on_eval_begin()
        cb.on_eval_end(evals[e])
        if model.stop_training:
            break
    cb.on_train_end({})
    return lrs


@pytest.mark.parametrize("case", ["lr_step", "lr_epoch", "early_stop",
                                  "early_stop_acc", "plateau",
                                  "plateau_scheduler", "checkpoint"])
def test_callbacks_act_as_the_reference(case):
    evals = [{"loss": 1.0, "acc": 0.5}, {"loss": 1.2, "acc": 0.4},
             {"loss": 0.9, "acc": 0.45}, {"loss": 1.5, "acc": 0.3}]
    out = []
    for pkg, hp in ((paddle, jhapi), (tpaddle, thapi)):
        net = pkg.nn.Linear(2, 2)
        sched = case in ("lr_step", "lr_epoch", "plateau_scheduler")
        lr = pkg.optimizer.lr.StepDecay(0.1, step_size=2, gamma=0.5) \
            if sched else 0.1
        opt = pkg.optimizer.SGD(lr, parameters=net.parameters())
        model = _FakeModel(opt)
        cb = {"lr_step": lambda: hp.LRScheduler(),
              "lr_epoch": lambda: hp.LRScheduler(by_step=False,
                                                 by_epoch=True),
              "early_stop": lambda: hp.EarlyStopping(patience=1,
                                                     verbose=0),
              "early_stop_acc": lambda: hp.EarlyStopping(
                  "acc", patience=2, verbose=0, min_delta=0.01),
              "plateau": lambda: hp.ReduceLROnPlateau(patience=1,
                                                      factor=0.5, verbose=0),
              "plateau_scheduler": lambda: hp.ReduceLROnPlateau(
                  patience=1, verbose=0),
              "checkpoint": lambda: hp.ModelCheckpoint(2, "/ckpt")}[case]()
        lrs = _drive(cb, model, evals, epochs=4)
        out.append((lrs, model.stop_training, model.saved,
                    getattr(cb, "best", None), getattr(cb, "wait", None)))
    assert out[1] == out[0]


def test_progbar_logger_prints_the_reference_s_lines(capsys):
    texts = []
    for hp in (jhapi, thapi):
        bar = hp.ProgBarLogger(log_freq=2, verbose=2)
        bar.set_params({"epochs": 1, "steps": 4})
        bar.on_train_begin()
        bar.on_epoch_begin(0)
        for s in range(4):
            bar.on_train_batch_end(s, {"loss": [0.25 * s], "lr": 0.1,
                                       "batch_size": 8})
        bar.on_epoch_end(0, {"loss": [0.75], "acc": 0.5})
        bar.on_eval_end({"loss": 0.5, "acc_top1": 0.25})
        err = capsys.readouterr().err
        # the rates and times differ run to run: keep the rest
        texts.append([ln.split(" - ")[:3] if ln.startswith("step") else
                      ln.split(" in ")[0] if ln.startswith("Epoch 1 done")
                      else ln for ln in err.splitlines()])
    assert texts[1] == texts[0] and len(texts[0]) == 5


# ---- flops, summary, save / load --------------------------------------------

@pytest.mark.parametrize("name,kw,size", [
    ("mobilenet_v2", dict(num_classes=1000), 64),
    ("shufflenet_v2_x0_25", dict(num_classes=10), 64),
    ("LeNet", {}, 28)])
def test_flops_and_summary_count_what_the_reference_counts(name, kw, size,
                                                           monkeypatch,
                                                           capsys):
    jm, tm = _pair(name, monkeypatch, **kw)
    chans = 1 if name == "LeNet" else 3
    jf = paddle.flops(jm, [1, chans, size, size])
    tf = tpaddle.flops(tm, [1, chans, size, size], print_detail=True)
    assert tf == jf and tf > 0
    js, ts = paddle.summary(jm), tpaddle.summary(tm)
    assert ts == js
    assert thapi.Model(tm).summary() == js
    out = capsys.readouterr().out
    assert f"Total FLOPs: {tf}" in out
    if name == "mobilenet_v2":
        assert ts["total_params"] == 3504872   # 3.5 M at width 1.0


def test_mobilenet_v2_flops_at_224():
    """The count chip_smoke 14 (c) takes its MFU from."""
    m = TM.mobilenet_v2(device="cpu")
    assert tpaddle.flops(m, [1, 3, 224, 224]) == 320_238_568


def test_save_load_round_trip_and_the_reference_s_files(tmp_path,
                                                        monkeypatch):
    jm, tm = _pair("mobilenet_v2", monkeypatch, scale=0.25, num_classes=10)
    jmodel = jhapi.Model(jm)
    jopt = paddle.optimizer.Momentum(0.01, parameters=jm.parameters())
    jmodel.prepare(jopt, paddle.nn.CrossEntropyLoss())
    x = _JImages(8, 4)
    with jax.default_matmul_precision("highest"):
        jmodel.train_batch([x.x], [x.y])
        jmodel.save(str(tmp_path / "ref" / "ckpt"))
        jpred = jmodel.predict_batch([x.x])[0]
    # the port reads the reference's files: the parameters by their
    # structured names, the step count; the reference names its
    # accumulators after its tensors ("generated_tensor_N", a process-wide
    # counter) and the port after parameter order ("param_i"), so the
    # velocities cross only through convert.load_jax_optimizer_state
    net = TM.mobilenet_v2(scale=0.25, num_classes=10, device="cpu", seed=9)
    tmodel = thapi.Model(net)
    topt = tpaddle.optimizer.Momentum(0.01, parameters=net.parameters())
    tmodel.prepare(topt, tpaddle.nn.CrossEntropyLoss())
    tmodel.load(str(tmp_path / "ref" / "ckpt"))
    assert _rel(tmodel.predict_batch([x.x])[0], jpred) <= TOL
    assert topt._step_count == 1
    assert not set(jopt.state_dict()) & set(topt.state_dict()) - {"@step"}
    # and its own: save, a fresh model, load, the same predictions bit
    # for bit, the optimizer's step and velocities restored
    tmodel.train_batch([x.x], [x.y])
    tmodel.save(str(tmp_path / "port" / "ckpt"))
    before = tmodel.predict_batch([x.x])[0]
    fresh_net = TM.mobilenet_v2(scale=0.25, num_classes=10, device="cpu",
                                seed=3)
    fresh = thapi.Model(fresh_net)
    fresh_opt = tpaddle.optimizer.Momentum(
        0.01, parameters=fresh_net.parameters())
    fresh.prepare(fresh_opt, tpaddle.nn.CrossEntropyLoss())
    fresh.load(str(tmp_path / "port" / "ckpt"))
    np.testing.assert_array_equal(fresh.predict_batch([x.x])[0], before)
    assert fresh_opt._step_count == tmodel._optimizer._step_count
    want = tmodel._optimizer.state_dict()
    got = fresh_opt.state_dict()
    assert set(got) == set(want) and len(want) > 10
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(got[k], v), k
    assert os.path.exists(tmp_path / "port" / "ckpt.pdopt")


# ---- the profiler -----------------------------------------------------------

def _tiny_step():
    net = tpaddle.nn.Linear(4, 3)
    opt = tpaddle.optimizer.SGD(0.1, parameters=net.parameters())
    step = tpaddle.jit.TrainStep(
        net, lambda m, x, y: tpaddle.nn.functional.cross_entropy(m(x), y),
        opt)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (5, 4)).astype(np.float32))
    y = torch.tensor([0, 1, 2, 0, 1])
    return step, x, y


@pytest.mark.parametrize("plane", [False, True])
def test_benchmark_meter_is_fed_by_train_step(plane, monkeypatch,
                                              tmp_path):
    """Four steps: the first (a new batch signature, quiet) ticks the
    meter's own clock, which arms its interval; the next three record a
    step each — their wall from the phase plane when it is on."""
    monkeypatch.setenv("PT_TELEMETRY_DIR", str(tmp_path))
    step, x, y = _tiny_step()
    bm = tprofiler.benchmark()
    prev = obs.mode()
    obs.set_mode("metrics" if plane else "off")
    steptrace.reset()
    bm.enable()
    try:
        for _ in range(4):
            step(x, y)
        s = bm.stats()
        walls = [t["total_s"] for t in steptrace.recent_steps()]
    finally:
        bm.disable()
        obs.set_mode(prev)
        steptrace.reset()
    assert bm.auto_fed and bm.samples == 20
    assert s["steps"] == 3 and "ips" in bm.summary()
    if plane:
        assert len(walls) == 3
        assert bm.step_times == pytest.approx(walls)


def test_profiler_window_writes_a_trace_the_tables_parse(tmp_path):
    step, x, y = _tiny_step()
    prof = tprofiler.Profiler(
        scheduler=tprofiler.make_scheduler(closed=1, ready=0, record=2),
        on_trace_ready=tprofiler.export_chrome_tracing(str(tmp_path)))
    prof.start()
    for _ in range(4):
        with tprofiler.RecordEvent("hapi_step"):
            step(x, y)
        prof.step(num_samples=5)
    prof.stop()
    data = prof.statistic_data()
    assert data is not None
    names = {r["name"] for r in data.rows("host")}
    assert "hapi_step" in names and any("aten::" in n for n in names)
    assert data.rows("host", "calls")[0]["calls"] >= 2
    assert "ips" in prof.step_info()
    assert "Host Op Summary" in tprofiler.statistic.render(data)
    tprofiler.Profiler(timer_only=True).summary()


def test_top_level_binds_the_high_level_api_without_cuda_or_builds():
    """`import paddle_tpu_torch as paddle` gives paddle.Model / flops /
    summary / callbacks / io / metric / profiler / hapi and the vision
    transforms and datasets, as the reference's top level (its
    __init__.py:67-115, :183), without jax, without initialising CUDA
    and without building the native library."""
    import subprocess
    import sys

    assert tpaddle.Model is thapi.Model and tpaddle.flops is thapi.flops
    assert tpaddle.callbacks is thapi.callbacks
    code = ("import sys, torch, paddle_tpu_torch as p; "
            "assert 'jax' not in sys.modules; "
            "assert not torch.cuda.is_initialized(); "
            "assert p.native._lib is None and not p.native._tried; "
            "print(p.Model.__name__, p.flops.__name__, p.summary.__name__, "
            "p.callbacks.EarlyStopping.__name__, p.io.DataLoader.__name__, "
            "p.metric.Accuracy.__name__, p.profiler.Profiler.__name__, "
            "p.hapi.Model.__name__, "
            "p.vision.transforms.RandomResizedCrop.__name__, "
            "p.vision.datasets.DatasetFolder.__name__, "
            "p.vision.mobilenet_v2.__name__)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [
        "Model", "flops", "summary", "EarlyStopping", "DataLoader",
        "Accuracy", "Profiler", "Model", "RandomResizedCrop",
        "DatasetFolder", "mobilenet_v2"]
