"""The port's recurrent layers (paddle_tpu_torch/nn/layer/rnn.py) against
the JAX package's on the CPU: the three cells, `RNN` / `BiRNN` over a
cell, and `SimpleRNN` / `LSTM` / `GRU` in every mode, direction and
`time_major`, with and without initial states — outputs, final states
and every gradient (through `paddle_tpu.grad` and the port's `grad`) —
from the reference's weights carried key for key.

Tolerances: 1e-12 of each tensor's max-abs in float64 (both models cast
with `astype`; x64 is on in tests/conftest.py), 1e-6 in float32. Also:
three f32 `TrainStep` steps of an LSTM (losses and parameters 1e-6),
the inter-layer dropout rule, and `sequence_length`, which the
reference accepts and ignores.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import export_state_dict, load_jax_state_dict
from paddle_tpu_torch.core import rng as trng

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


def _pair(name, *args, dtype="float32", **kw):
    j = getattr(jnn, name)(*args, **kw)
    t = getattr(tnn, name)(*args, **kw)
    assert list(t.state_dict()) == list(j.state_dict())
    load_jax_state_dict(t, {k: np.asarray(v.numpy())
                            for k, v in j.state_dict().items()})
    if dtype == "float64":
        j.astype("float64")
        t.astype("float64")
    return j, t


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _flat(o)]
    return [out]


def _run(j, t, arrays, dtype, call=lambda m, *a: m(*a)):
    """Outputs and the gradients of Σ out · probe (every output leaf)
    with respect to the inputs and every parameter."""
    tol = 1e-12 if dtype == "float64" else 1e-6
    jin = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    tin = [torch.tensor(a, requires_grad=True) for a in arrays]
    jout, tout = _flat(call(j, *jin)), _flat(call(t, *tin))
    assert len(jout) == len(tout)
    rs = np.random.default_rng(17)
    jl, tl = 0, 0
    for a, b in zip(tout, jout):
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        assert _rel(a.detach().numpy(), b.numpy()) < tol
        probe = rs.standard_normal(tuple(a.shape)).astype(dtype)
        jl = jl + (b * paddle.to_tensor(probe)).sum()
        tl = tl + (a * torch.from_numpy(probe)).sum()
    jparams = [p for _, p in j.named_parameters()]
    tparams = [p for _, p in t.named_parameters()]
    jg = paddle.grad(jl, jin + jparams)
    tg = tpaddle.grad(tl, tin + tparams)
    for a, b in zip(tg, jg):
        assert _rel(a.numpy(), b.numpy()) < tol
    return tout


def _x(shape, dtype, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("cell,args", [
    ("SimpleRNNCell", (5, 6)), ("SimpleRNNCell", (5, 6, "relu")),
    ("LSTMCell", (5, 6)), ("GRUCell", (5, 6))])
def test_cells_match_the_reference(cell, args, dtype):
    j, t = _pair(cell, *args, dtype=dtype)
    lstm = cell == "LSTMCell"
    x = _x((4, 5), dtype)
    h = _x((4, 6), dtype, 1)
    states = [h, _x((4, 6), dtype, 2)] if lstm else [h]

    def call(m, xv, *s):
        return m(xv, tuple(s) if lstm else s[0])

    _run(j, t, [x] + states, dtype, call)
    # no states: zeros of the reference's default float32
    _run(j, t, [x.astype(np.float32)], "float32", lambda m, xv: m(xv)) \
        if dtype == "float32" else None


@pytest.mark.parametrize("time_major", [False, True])
@pytest.mark.parametrize("wrapper", ["RNN", "RNN reverse", "BiRNN"])
def test_rnn_wrappers_match_the_reference(wrapper, time_major):
    jc, tc = _pair("GRUCell", 4, 5)
    shape = (6, 3, 4) if time_major else (3, 6, 4)
    if wrapper == "BiRNN":
        jc2, tc2 = _pair("LSTMCell", 4, 5)
        j = jnn.BiRNN(jc, jc2, time_major=time_major)
        t = tnn.BiRNN(tc, tc2, time_major=time_major)
    else:
        rev = wrapper.endswith("reverse")
        j = jnn.RNN(jc, is_reverse=rev, time_major=time_major)
        t = tnn.RNN(tc, is_reverse=rev, time_major=time_major)
    _run(j, t, [_x(shape, "float32")], "float32")


NETS = [(name, direction, tm, layers)
        for name in ("SimpleRNN", "LSTM", "GRU")
        for direction in ("forward", "bidirect")
        for tm in (False, True)
        for layers in (1, 2)]


@pytest.mark.parametrize("name,direction,time_major,layers", NETS,
                         ids=[f"{n}-{d}-{'tm' if tm else 'bm'}-{l}"
                              for n, d, tm, l in NETS])
def test_nets_match_the_reference(name, direction, time_major, layers):
    j, t = _pair(name, 4, 5, num_layers=layers, direction=direction,
                 time_major=time_major, dtype="float64")
    x = _x((7, 3, 4) if time_major else (3, 7, 4), "float64")
    _run(j, t, [x], "float64")
    # given initial states [layers × directions, batch, hidden]
    n = layers * (2 if direction == "bidirect" else 1)
    h0 = _x((n, 3, 5), "float64", 1)
    if name == "LSTM":
        c0 = _x((n, 3, 5), "float64", 2)
        _run(j, t, [x, h0, c0], "float64",
             lambda m, xv, h, c: m(xv, (h, c)))
    else:
        _run(j, t, [x, h0], "float64", lambda m, xv, h: m(xv, h))


def test_simple_rnn_relu_and_f32_lstm_match_the_reference():
    j, t = _pair("SimpleRNN", 4, 5, num_layers=2, activation="relu")
    _run(j, t, [_x((2, 6, 4), "float32")], "float32")
    j, t = _pair("LSTM", 4, 5, num_layers=2, direction="bidirect")
    _run(j, t, [_x((2, 6, 4), "float32")], "float32")


def test_parameter_names_and_gate_order():
    t = tnn.LSTM(3, 4, num_layers=2, direction="bidirect")
    names = [n for n, _ in t.named_parameters()]
    assert names[:8] == ["weight_ih_0", "weight_hh_0", "bias_ih_0",
                         "bias_hh_0", "weight_ih_0_reverse",
                         "weight_hh_0_reverse", "bias_ih_0_reverse",
                         "bias_hh_0_reverse"]
    assert t.weight_ih_1.shape == (16, 8)
    # GRU: n = tanh(xn + r · hn), h = (1 - z) · n + z · h
    g = tnn.GRUCell(2, 3)
    x, h = torch.randn(1, 2, dtype=torch.float64), torch.randn(
        1, 3, dtype=torch.float64)
    g.astype("float64")
    xr, xz, xn = (x @ g.weight_ih.T + g.bias_ih).chunk(3, -1)
    hr, hz, hn = (h @ g.weight_hh.T + g.bias_hh).chunk(3, -1)
    r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
    want = (1 - z) * torch.tanh(xn + r * hn) + z * h
    assert torch.allclose(g(x, h)[0], want, rtol=1e-12, atol=0)


def test_sequence_length_is_ignored_as_in_the_reference():
    j, t = _pair("GRU", 4, 5, num_layers=2, direction="bidirect")
    x = _x((3, 6, 4), "float32")
    lens = np.array([6, 2, 4])
    jo, jh = j(paddle.to_tensor(x), sequence_length=paddle.to_tensor(lens))
    to, th = t(torch.from_numpy(x), sequence_length=torch.from_numpy(lens))
    to2, th2 = t(torch.from_numpy(x))
    assert torch.equal(to, to2) and torch.equal(th, th2)
    assert _rel(to.detach().numpy(), jo.numpy()) < 1e-6
    # every position past a sequence's length is computed all the same
    assert to[1, 3:].abs().sum() > 0


def test_inter_layer_dropout_spares_the_last_layer():
    t = tnn.LSTM(4, 5, num_layers=2, dropout=0.5)
    x = torch.from_numpy(_x((3, 6, 4), "float32"))
    t.eval()
    ref = t(x)[0]
    t.train()
    with trng.generator_scope(torch.Generator().manual_seed(3)):
        a = t(x)[0]
    with trng.generator_scope(torch.Generator().manual_seed(3)):
        b = t(x)[0]
    assert torch.equal(a, b) and not torch.allclose(a, ref)
    # dropout 1.0 zeros layer 0's output: layer 1 then sees only zeros,
    # and its own output is not dropped
    t.dropout = 1.0
    out = t(x)[0]
    top = tnn.LSTM(5, 5)
    with torch.no_grad():
        for src, dst in (("weight_ih_1", "weight_ih_0"),
                         ("weight_hh_1", "weight_hh_0"),
                         ("bias_ih_1", "bias_ih_0"),
                         ("bias_hh_1", "bias_hh_0")):
            getattr(top, dst).copy_(getattr(t, src))
    want = top(torch.zeros(3, 6, 5))[0]
    assert torch.allclose(out, want, rtol=1e-6, atol=1e-7) and out.abs(
        ).sum() > 0


class _JNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.rnn = jnn.LSTM(4, 6, num_layers=2, direction="bidirect")
        self.head = jnn.Linear(12, 3)

    def forward(self, x):
        return self.head(self.rnn(x)[0])


class _TNet(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.rnn = tnn.LSTM(4, 6, num_layers=2, direction="bidirect")
        self.head = tnn.Linear(12, 3)

    def forward(self, x):
        return self.head(self.rnn(x)[0])


def test_lstm_train_step_matches_the_reference():
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import SGD

    j, t = _JNet(), _TNet()
    load_jax_state_dict(t, {k: np.asarray(v.numpy())
                            for k, v in j.state_dict().items()})
    x = _x((4, 7, 4), "float32")
    y = _x((4, 7, 3), "float32", 5)
    jstep = paddle.jit.TrainStep(
        j, lambda m, a, b: jnn.functional.mse_loss(m(a), b),
        paddle.optimizer.SGD(0.5, parameters=j.parameters()))
    tstep = TrainStep(t, lambda m, a, b: tnn.functional.mse_loss(m(a), b),
                      SGD(0.5, parameters=t.parameters()))
    jl = [float(jstep(paddle.to_tensor(x), paddle.to_tensor(y)).numpy())
          for _ in range(3)]
    tl = [float(tstep(torch.from_numpy(x), torch.from_numpy(y)))
          for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    assert tl[-1] < tl[0]
    tparams = export_state_dict(t)
    for k, v in j.state_dict().items():
        assert _rel(tparams[k], v.numpy()) < 1e-6, k
