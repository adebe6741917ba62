"""`jit.to_static` with AutoGraph and `jit.save` / `load`: the PyTorch
port against the JAX package on CPU.

The AutoGraph cases are the patterns of tests/test_autograph.py written
once, over tensor methods and operators only (counters come in as
inputs), and decorated by both packages' `to_static`: the same numpy
inputs go through both, and the outputs must agree (f32, 1e-6). The
saved-and-loaded layers are held against the reference's loaded layer
on the same weights (`convert`), within 1e-6."""
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import jit as jjit
from paddle_tpu import nn as jnn
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import load_jax_state_dict

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


@pytest.fixture(autouse=True)
def _serial_mesh():
    from paddle_tpu.distributed import mesh as mesh_mod

    mesh_mod.reset_mesh()
    yield


# ---------------------------------------------------------------- cases

def if_else(x):
    if x.sum() > 0:
        y = x * 2
    else:
        y = x - 1
    return y


def elif_chain(x):
    s = x.sum()
    if s > 10:
        out = x * 0
    elif s > 0:
        out = x + 100
    else:
        out = -x
    return out


def guard_clause(x):
    if x.sum() < 0:
        return x * 0
    y = x + 1
    return y * y


def both_arms_return(x):
    if x.mean() > 1:
        return x - 1
    else:
        return x + 1


def nested_if(x):
    if x.sum() > 0:
        if x.max() > 10:
            y = x / 10
        else:
            y = x
    else:
        y = x * 0
    return y


def while_accumulate(x, i):
    s = x * 0
    while i < 5:
        s = s + x
        i = i + 1
    return s


def while_on_value(x):
    while x.sum() < 100:
        x = x * 2
    return x


def for_rows(xs):
    acc = xs[0] * 0
    for row in xs:
        acc = acc + row * row
    return acc


def for_range_tensor(x, n):
    s = x * 0
    for i in range(n):
        s = s + x + i
    return s


def while_break(x, i):
    while i < 10:
        i = i + 1
        if i > x.sum():
            break
        x = x + 0.5
    return x, i


def while_continue(n, i, s):
    while i < n:
        i = i + 1
        if i % 2 == 0:
            continue
        s = s + i
    return s


def return_in_while(x, i):
    while i < 100:
        i = i + 1
        if i > x.sum():
            return i * 10
        x = x + 0.0
    return i


def python_flow(x, flag, n):
    if flag:
        x = x + 1
    for _ in range(n):
        x = x * 2
    return x


def _f32(*v):
    return np.asarray(v, np.float32)


CASES = [
    (if_else, [_f32(1.0, 2.0)]), (if_else, [_f32(-1.0, -2.0)]),
    (elif_chain, [_f32(20.0)]), (elif_chain, [_f32(1.0)]),
    (elif_chain, [_f32(-3.0)]),
    (guard_clause, [_f32(-5.0)]), (guard_clause, [_f32(2.0)]),
    (both_arms_return, [_f32(4.0)]), (both_arms_return, [_f32(0.0)]),
    (nested_if, [_f32(20.0)]), (nested_if, [_f32(5.0)]),
    (nested_if, [_f32(-5.0)]),
    (while_accumulate, [_f32(2.0), np.int32(0)]),
    (while_on_value, [_f32(3.0)]),
    (for_rows, [_f32([1.0, 2.0], [3.0, 4.0])]),
    (for_range_tensor, [_f32(1.0), np.int64(4)]),
    (while_break, [_f32(3.0), np.float32(0.0)]),
    (while_continue, [np.float32(10.0), np.float32(0.0), np.float32(0.0)]),
    (return_in_while, [_f32(4.0), np.float32(0.0)]),
]


def _run_both(fn, arrays, *py):
    ref = jjit.to_static(fn)(*[paddle.to_tensor(a) for a in arrays], *py)
    out = tjit.to_static(fn)(*[torch.from_numpy(np.asarray(a))
                               for a in arrays], *py)
    return ref, out


def _as_list(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


@pytest.mark.parametrize("fn,arrays", CASES,
                         ids=[f"{c[0].__name__}-{i}"
                              for i, c in enumerate(CASES)])
def test_to_static_matches_reference(fn, arrays):
    ref, out = _run_both(fn, arrays)
    for r, o in zip(_as_list(ref), _as_list(out)):
        np.testing.assert_allclose(o.numpy(), r.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_python_values_keep_python_semantics():
    for flag, n, want in ((True, 3, 16.0), (False, 2, 4.0)):
        ref, out = _run_both(python_flow, [_f32(1.0)], flag, n)
        assert float(out[0]) == float(ref.numpy()[0]) == want


def test_eager_arms_raise_only_when_saved():
    """One arm runs in eager mode, so unequal arms do not raise there
    (the reference traces both and raises); jit.save of the same
    function still raises."""
    def mismatch(x):
        if x.sum() > 0:
            y = (x, x)
        else:
            y = x
        return y

    with pytest.raises(Exception, match="branch|structure"):
        jjit.to_static(mismatch)(paddle.to_tensor(_f32(1.0)))
    out = tjit.to_static(mismatch)(torch.tensor([1.0]))
    assert isinstance(out, tuple)

    class Net(tnn.Layer):
        def forward(self, x):
            return tjit.to_static(mismatch)(x)[0]

    with pytest.raises(Exception, match="branch|structure"):
        tjit.save(Net(), "/nonexistent-never-written/m",
                  input_spec=[tjit.InputSpec([2])])


def test_eager_while_is_differentiable():
    """The port's eager `while` over a tensor test takes gradients (the
    reference's lax.while_loop cannot be reverse-differentiated)."""
    x = torch.tensor([3.0], requires_grad=True)
    y = tjit.to_static(while_on_value)(x)
    y.sum().backward()
    assert float(x.grad) == 64.0


def test_cache_key_counts_signatures_modes_and_grad():
    class Net(tnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = tnn.Linear(4, 4, device="cpu")

        def forward(self, x):
            return self.fc(x)

    net = tjit.to_static(Net())
    sf = net._static_function
    net(torch.ones(2, 4))
    net(torch.ones(2, 4))
    assert len(sf._cache) == 1
    net(torch.ones(3, 4))
    assert len(sf._cache) == 2
    net.eval()
    net(torch.ones(3, 4))
    assert len(sf._cache) == 3
    with torch.no_grad():
        net(torch.ones(3, 4))
    assert len(sf._cache) == 4
    assert sf.concrete_program is not None
    tjit.enable_to_static(False)
    try:
        net(torch.ones(5, 4))
        assert len(sf._cache) == 4
    finally:
        tjit.enable_to_static(True)


# ------------------------------------------------------------ save / load

class _JNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.conv = jnn.Conv2D(3, 4, 3, padding=1)
        self.bn = jnn.BatchNorm2D(4)
        self.fc = jnn.Linear(4 * 8 * 8, 5)

    def forward(self, x):
        h = jnn.functional.relu(self.bn(self.conv(x)))
        return self.fc(h.reshape([h.shape[0], -1]))


class _TNet(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.conv = tnn.Conv2D(3, 4, 3, padding=1)
        self.bn = tnn.BatchNorm2D(4)
        self.fc = tnn.Linear(4 * 8 * 8, 5)

    def forward(self, x):
        h = tnn.functional.relu(self.bn(self.conv(x)))
        return self.fc(h.reshape([h.shape[0], -1]))


def _flow(h):
    """Tensor-dependent if, a while with break and `for x in tensor`."""
    if h.sum() > 0:
        y = h * 2.0
    else:
        y = h - 1.0
    acc = y[0] * 0
    k = y.sum() * 0
    while k < 3:
        k = k + 1
        acc = acc + y[0] * k
        if acc.sum() > 50.0:
            break
    for row in y:
        acc = acc + row * 0.5
    return acc


class _JFlow(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = jnn.Linear(6, 6)
        self._flow = jjit.to_static(_flow)

    def forward(self, x):
        return self._flow(self.fc(x))


class _TFlow(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = tnn.Linear(6, 6)
        self._flow = tjit.to_static(_flow)

    def forward(self, x):
        return self._flow(self.fc(x))


def _pair(jcls, tcls):
    paddle.seed(1)
    jm = jcls()
    jm.eval()
    tm = tcls()
    load_jax_state_dict(tm, {k: np.asarray(v.numpy())
                             for k, v in jm.state_dict().items()})
    tm.eval()
    return jm, tm


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """(reference loaded layer, port loaded layer, port eager layer, the
    input) for the conv net and the control-flow net."""
    d = tmp_path_factory.mktemp("jit")
    out = {}
    rng = np.random.default_rng(0)
    for name, (jc, tc, shape) in {
            "conv": (_JNet, _TNet, [None, 3, 8, 8]),
            "flow": (_JFlow, _TFlow, [4, 6])}.items():
        jm, tm = _pair(jc, tc)
        jjit.save(jm, str(d / f"j_{name}"),
                  input_spec=[jjit.InputSpec(shape, "float32")])
        tjit.save(tm, str(d / f"t_{name}"),
                  input_spec=[tjit.InputSpec(shape, "float32")])
        x = rng.standard_normal([1 if s is None else s for s in shape]
                                ).astype(np.float32)
        out[name] = (jjit.load(str(d / f"j_{name}")),
                     tjit.load(str(d / f"t_{name}"), device="cpu"), tm, x,
                     str(d / f"t_{name}"))
    return out


@pytest.mark.parametrize("name", ["conv", "flow"])
def test_saved_and_loaded_matches_reference(saved, name):
    jl, tl, tm, x, _ = saved[name]
    ref = jl(paddle.to_tensor(x)).numpy()
    got = tl(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        np.testing.assert_allclose(got, tm(torch.from_numpy(x)).numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_flow_program_holds_the_control_flow_ops(saved):
    """The control flow is in the program (cond, while_loop, scan), not
    baked to the example's branch: a negative input takes the other
    arm, as the eager layer does."""
    _, tl, tm, x, _ = saved["flow"]
    ops = {str(n.target) for m in tl._program.modules()
           if isinstance(m, torch.fx.GraphModule)
           for n in m.graph.nodes if n.op == "call_function"}
    text = " ".join(ops)
    assert "cond" in text and "while_loop" in text and "scan" in text
    for scale in (1.0, -40.0):
        xi = torch.from_numpy(x * scale)
        with torch.no_grad():
            np.testing.assert_allclose(tl(xi).numpy(), tm(xi).numpy(),
                                       rtol=1e-6, atol=1e-6)


def test_none_dim_exported_at_one_and_other_shapes_raise(saved):
    _, tl, _, x, path = saved["conv"]
    assert tl._input_specs[0][0] == [1, 3, 8, 8]
    with pytest.raises(ValueError, match="saved at"):
        tl(torch.zeros(2, 3, 8, 8))
    from paddle_tpu_torch.framework.io_state import load as tload

    b = tload(path + ".pdiparams", return_numpy=True)
    assert b["n_inputs"] == 1 and len(b["names"]) == len(b["params"])


def test_save_requires_input_spec_and_load_refuses_stablehlo(tmp_path):
    with pytest.raises(ValueError, match="input_spec"):
        tjit.save(_TNet(), str(tmp_path / "m"))
    (tmp_path / "r.stablehlo").write_bytes(b"\0")
    with pytest.raises(ValueError, match="cannot load"):
        tjit.load(str(tmp_path / "r"), device="cpu")


def test_saved_attention_records_the_flash_custom_op(tmp_path):
    """A model that reaches F.scaled_dot_product_attention on bf16
    inputs exports the `paddle_tpu_torch::flash_fwd` op (K3), not the
    plain version's ops, and its loaded output equals the eager one."""
    class Attn(tnn.Layer):
        def forward(self, q):
            return tnn.functional.scaled_dot_product_attention(q, q, q)

    tjit.save(Attn(), str(tmp_path / "a"),
              input_spec=[tjit.InputSpec([2, 16, 2, 64], "bfloat16")])
    tl = tjit.load(str(tmp_path / "a"), device="cpu")
    ops = [str(n.target) for n in tl._program.graph.nodes
           if n.op == "call_function"]
    assert "paddle_tpu_torch.flash_fwd.default" in ops
    assert not any("softmax" in o or "matmul" in o or "bmm" in o
                   for o in ops)
    q = torch.randn(2, 16, 2, 64).bfloat16()
    assert torch.equal(tl(q), Attn()(q))


def test_set_compiler_options_are_kept(saved):
    _, tl, _, _, _ = saved["conv"]
    assert tl.set_compiler_options({"k": 1}) is tl
    assert tl._compiler_options == {"k": 1}


def test_traced_layer_and_translator_surface(tmp_path):
    net = _TNet()
    net.eval()
    x = torch.randn(1, 3, 8, 8)
    outs, traced = tjit.TracedLayer.trace(net, [x])
    assert torch.equal(outs, traced(x))
    traced.save_inference_model(str(tmp_path / "tr"),
                                input_spec=[tjit.InputSpec([1, 3, 8, 8])])
    assert (tmp_path / "tr.pt2").exists()
    pt = tjit.ProgramTranslator.get_instance()
    pt.enable(False)
    assert tjit._to_static_enabled is False
    pt.enable(True)
    tjit.set_verbosity(3)
    tjit.set_code_level(2)
    assert tjit.dy2static.set_verbosity is not None
    assert tjit.not_to_static(if_else)._not_to_static
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tjit.ignore_module([np])
