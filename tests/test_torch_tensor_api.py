"""The tensor API (paddle_tpu_torch/ops, tensor_core, linalg) against
the JAX package's on the CPU.

One parametrised case per public function of the reference's `ops`
namespace and of `paddle_tpu.linalg.__all__` (CASES): the same numpy
inputs, made from `default_rng(seed)`, go through the reference (as
`paddle_tpu.to_tensor`) and the port (CPU torch tensors). Tolerances:
exact for integer, bool and index outputs and for every dtype;
rtol = atol = 1e-6 in f32; 1e-12 in f64 (the tests run with x64,
tests/conftest.py). The differentiable cases also hold the gradient of
Σ out · w (w a seeded cotangent) from `paddle_tpu.grad` against
`torch.autograd.grad`, 1e-6.

Named cases pin the traps of the port: descending sort / argsort ties
(last index first), `topk` ties (lower index first, also with
largest=False), `scatter` / `put_along_axis` / `index_put` with repeated
indices (the last writer wins; overwrite=False sums), `unique` with
return_index (the first occurrence), `mode`, `reshape`'s 0 and −1,
`split`'s −1. Random ops are held to shape, dtype, range, moments and
reproducibility under a seed, not to jax's draws. The coverage case
fails if a reference name has no port counterpart or no case here; the
method-table case checks that every name the reference installs on its
Tensor resolves in `ops.TENSOR_METHODS`, and that no port module
patches `torch.Tensor`.

Where the decompositions are unique only up to a sign or phase (svd,
qr, eigh, eig, svd_lowrank) the cases compare what is unique: the
reconstruction and the spectrum.
"""
import ast
import os
import zlib

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu.linalg as JL
import paddle_tpu.ops as jops
import paddle_tpu_torch as T
import paddle_tpu_torch.linalg as TL
import paddle_tpu_torch.ops as tops
from paddle_tpu_torch.core import place as tplace

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

# the reference's tape helpers: torch's autograd records every op, so
# they have no counterpart (ops/_helpers.py)
NO_COUNTERPART = {"apply_jfn", "ensure_tensor"}


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    old = tplace._current
    T.set_device("cpu")
    yield
    tplace._current = old


# ---- inputs -------------------------------------------------------------

def f32(g, *shape, lo=-2.0, hi=2.0):
    return g.uniform(lo, hi, shape).astype(np.float32)


def f64(g, *shape, lo=-2.0, hi=2.0):
    return g.uniform(lo, hi, shape)


def ints(g, *shape, lo=0, hi=5, dtype=np.int64):
    return g.integers(lo, hi, shape).astype(dtype)


def bools(g, *shape):
    return g.random(shape) < 0.5


def spd(g, n, dtype=np.float32):
    a = g.standard_normal((n, n))
    return (a @ a.T + n * np.eye(n)).astype(dtype)


def well(g, n, dtype=np.float32):
    return (g.standard_normal((n, n)) + 3 * np.eye(n)).astype(dtype)


class Arr:
    """A numpy array passed as a tensor to both frameworks; diff=True
    marks the input a gradient is taken for."""

    def __init__(self, a, diff=False):
        self.a, self.diff = a, diff


def A(a):
    return Arr(a, diff=True)


class C:
    def __init__(self, name, build, grad=False, fn=None, id=None,
                 cmp=None):
        self.name, self.build, self.grad = name, build, grad
        self.fn = fn or name
        self.id = id or name
        self.cmp = cmp

    def inputs(self):
        return self.build(np.random.default_rng(zlib.crc32(
            self.id.encode())))


def _to_ref(v, diff_ok):
    if isinstance(v, Arr):
        return J.to_tensor(v.a, stop_gradient=not (v.diff and diff_ok))
    if isinstance(v, dict):
        return {k: _to_ref(x, diff_ok) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_to_ref(x, diff_ok) for x in v)
    return v


def _to_port(v, diff_ok):
    if isinstance(v, Arr):
        return torch.tensor(v.a, requires_grad=bool(v.diff and diff_ok))
    if isinstance(v, dict):
        return {k: _to_port(x, diff_ok) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_to_port(x, diff_ok) for x in v)
    return v


def _diff_inputs(v, out):
    if isinstance(v, Arr) and v.diff:
        out.append(v)
    elif isinstance(v, (list, tuple)):
        for x in v:
            _diff_inputs(x, out)
    return out


def _leaves(v, fn, out):
    if isinstance(v, (list, tuple)):
        for x in v:
            _leaves(x, fn, out)
    elif fn(v):
        out.append(v)
    return out


# ---- comparison ------------------------------------------------------------

def _np_of(v):
    if isinstance(v, torch.Tensor):
        v = v.detach()
        return v.numpy() if v.dtype != torch.bfloat16 else v.float().numpy()
    if isinstance(v, J.Tensor):
        return np.asarray(v._value)
    return v


def _dname(a):
    return np.asarray(a).dtype.name


def _close(ref, got, what):
    r, p = _np_of(ref), _np_of(got)
    if ref is None or got is None:
        assert ref is None and got is None, what
        return
    if not isinstance(r, np.ndarray) and not isinstance(p, np.ndarray):
        assert r == p, (what, r, p)
        return
    r, p = np.asarray(r), np.asarray(p)
    assert r.shape == p.shape, (what, r.shape, p.shape)
    assert _dname(r) == _dname(p), (what, r.dtype, p.dtype)
    if r.dtype.kind in "iub":
        np.testing.assert_array_equal(p, r, err_msg=what)
    else:
        tol = 1e-12 if r.dtype in (np.float64, np.complex128) else 1e-6
        np.testing.assert_allclose(p, r, rtol=tol, atol=tol, err_msg=what)


def _cmp_tree(ref, got, what="out"):
    if isinstance(ref, (list, tuple)):
        assert isinstance(got, (list, tuple)), (what, type(got))
        assert type(got) is type(ref), (what, type(ref), type(got))
        assert len(ref) == len(got), what
        for i, (r, g) in enumerate(zip(ref, got)):
            _cmp_tree(r, g, f"{what}[{i}]")
        return
    _close(ref, got, what)


def _call(mod, fn, args, kw):
    f = getattr(mod, fn) if isinstance(fn, str) else fn
    return f(*args, **kw)


# ---- the case table --------------------------------------------------------

def _u(name, dom=None, grad=True):
    lo, hi = dom or (-2.0, 2.0)
    return C(name, lambda g: ([A(f32(g, 3, 4, lo=lo, hi=hi))], {}),
             grad=grad)


def _b(name, grad=True, lo=-2.0, hi=2.0, y_lo=None, y_hi=None):
    return C(name, lambda g: ([A(f32(g, 3, 4, lo=lo, hi=hi)),
                               A(f32(g, 4, lo=y_lo if y_lo is not None
                                     else lo,
                                     hi=y_hi if y_hi is not None else hi))],
                              {}), grad=grad)


def _r(name, grad=True, **kw):
    return C(name, lambda g: ([A(f32(g, 3, 4, 5))], dict(kw)), grad=grad,
             id=f"{name}{kw}")


POS = (0.5, 3.0)
UNIT = (-0.9, 0.9)

CASES = [
    # ---- math: elementwise unary
    *[_u(n) for n in ("abs", "neg", "exp", "expm1", "square", "sin", "cos",
                      "tan", "atan", "sinh", "cosh", "tanh", "asinh",
                      "erf", "deg2rad", "rad2deg", "sign", "sgn",
                      "stanh", "positive")],
    *[_u(n, POS) for n in ("log", "log2", "log10", "log1p", "sqrt",
                           "rsqrt", "reciprocal", "lgamma", "digamma")],
    *[_u(n, UNIT) for n in ("asin", "acos", "atanh", "erfinv")],
    _u("acosh", (1.2, 3.0)),
    *[_u(n, grad=False) for n in ("floor", "ceil", "round", "trunc",
                                  "frac", "isnan", "isinf", "isfinite",
                                  "angle", "real", "imag", "conj")],
    *[_u(n, (-3.0, 3.0), grad=False) for n in ("i0", "i0e", "i1", "i1e")],
    C("logical_not", lambda g: ([Arr(bools(g, 3, 4))], {})),
    C("bitwise_not", lambda g: ([Arr(ints(g, 3, 4, lo=-9, hi=9))], {})),
    # ---- math: elementwise binary (tensor-tensor, broadcasting)
    *[_b(n) for n in ("add", "subtract", "multiply", "maximum", "minimum",
                      "fmax", "fmin", "atan2", "hypot", "logaddexp")],
    _b("divide", y_lo=0.5, y_hi=2.0),
    _b("pow", lo=0.5, hi=2.0),
    *[_b(n, grad=False) for n in ("floor_divide", "mod", "remainder",
                                  "floor_mod", "copysign", "nextafter",
                                  "equal", "not_equal", "greater_than",
                                  "greater_equal", "less_than",
                                  "less_equal")],
    C("ldexp", lambda g: ([Arr(f32(g, 3, 4)),
                           Arr(ints(g, 4, lo=-3, hi=4, dtype=np.int32))],
                          {})),
    C("heaviside", lambda g: ([Arr(np.array([-1., 0., 2.], np.float32)),
                               Arr(np.array([.5, .25, .75], np.float32))],
                              {})),
    *[C(n, lambda g: ([Arr(ints(g, 3, 4, lo=1, hi=40)),
                       Arr(ints(g, 4, lo=1, hi=40))], {}))
      for n in ("gcd", "lcm")],
    *[C(n, lambda g: ([Arr(bools(g, 3, 4)), Arr(bools(g, 4))], {}))
      for n in ("logical_and", "logical_or", "logical_xor")],
    *[C(n, lambda g: ([Arr(ints(g, 3, 4, lo=-20, hi=20)),
                       Arr(ints(g, 4, lo=-20, hi=20))], {}))
      for n in ("bitwise_and", "bitwise_or", "bitwise_xor")],
    C("add", lambda g: ([A(f32(g, 3, 4)), 2.5], {}), grad=True,
      id="add_scalar"),
    C("multiply", lambda g: ([Arr(ints(g, 3, 4, dtype=np.int32)), 3], {}),
      id="multiply_int32_scalar"),
    C("subtract", lambda g: ([2.0, A(f32(g, 3))], {}), grad=True,
      id="subtract_scalar_first"),
    # ---- math: reductions
    *[_r(n, axis=ax, keepdim=k) for n in ("sum", "mean", "max", "min",
                                          "prod", "amax", "amin",
                                          "logsumexp")
      for ax, k in ((None, False), (1, True), ([0, 2], False))],
    _r("nansum", axis=1), _r("nanmean", axis=[0, 1]),
    _r("std", axis=1), _r("std", axis=None, unbiased=False),
    _r("var", axis=[0, 2], keepdim=True), _r("var", unbiased=False),
    _r("median", axis=1), _r("median", axis=None),
    _r("quantile", q=0.3, axis=2), _r("quantile", q=np.array([0.1, 0.9]), axis=1,
                                      keepdim=True),
    C("sum", lambda g: ([Arr(ints(g, 3, 4, dtype=np.int32))],
                        dict(axis=0)), id="sum_int32_promotes"),
    C("sum", lambda g: ([Arr(bools(g, 3, 4))], {}), id="sum_bool"),
    C("prod", lambda g: ([Arr(ints(g, 3, 4, lo=1, hi=4,
                                   dtype=np.int32))], dict(axis=1)),
      id="prod_int32_promotes"),
    *[C(n, lambda g: ([Arr(f32(g, 3, 5))], kw), id=f"{n}{kw}")
      for n in ("argmax", "argmin")
      for kw in ({}, dict(axis=1), dict(axis=0, keepdim=True),
                 dict(axis=None, keepdim=True))],
    *[C(n, lambda g: ([Arr(bools(g, 3, 4, 2))], kw), id=f"{n}{kw}")
      for n in ("all", "any")
      for kw in ({}, dict(axis=1), dict(axis=[0, 2], keepdim=True))],
    C("count_nonzero", lambda g: ([Arr(ints(g, 3, 4, hi=3))],
                                  dict(axis=1))),
    # ---- math: cumulative, misc
    C("cumsum", lambda g: ([A(f32(g, 3, 4))], dict(axis=1)), grad=True),
    C("cumsum", lambda g: ([A(f32(g, 3, 4))], {}), grad=True,
      id="cumsum_flat"),
    C("cumsum", lambda g: ([Arr(ints(g, 3, 4, dtype=np.int32))],
                           dict(axis=0)), id="cumsum_int32"),
    C("cumprod", lambda g: ([A(f32(g, 3, 4, lo=0.5, hi=1.5))],
                            dict(dim=1)), grad=True),
    *[C(n, lambda g: ([Arr(ints(g, 3, 6, hi=4).astype(np.float32))], kw),
        id=f"{n}{kw}")
      for n in ("cummax", "cummin") for kw in (dict(axis=1), {})],
    C("diff", lambda g: ([A(f32(g, 3, 5))], dict(n=2, axis=1)), grad=True),
    C("diff", lambda g: ([Arr(f32(g, 4)), ], dict(prepend=Arr(f32(g, 2)),
                                               append=Arr(f32(g, 1)))),
      id="diff_pre_append"),
    C("trace", lambda g: ([A(f32(g, 4, 5))], dict(offset=1)), grad=True),
    C("kron", lambda g: ([A(f32(g, 2, 3)), A(f32(g, 3, 2))], {}),
      grad=True),
    C("inner", lambda g: ([A(f32(g, 2, 3)), A(f32(g, 4, 3))], {}),
      grad=True),
    C("outer", lambda g: ([A(f32(g, 3)), A(f32(g, 4))], {}), grad=True),
    C("equal_all", lambda g: ([Arr(ints(g, 3)), Arr(ints(g, 3))], {})),
    C("allclose", lambda g: ([Arr(f32(g, 3)), Arr(f32(g, 3))], {})),
    C("isclose", lambda g: ([Arr(np.array([1., 2., 3.], np.float32)),
                             Arr(np.array([1., 2.1, 3.], np.float32))], {})),
    C("scale", lambda g: ([A(f32(g, 3, 4))], dict(scale=2.0, bias=1.0)),
      grad=True),
    C("scale", lambda g: ([A(f32(g, 3, 4))], dict(
        scale=2.0, bias=1.0, bias_after_scale=False, act="relu")),
      grad=True, id="scale_before_act"),
    C("clip", lambda g: ([A(f32(g, 3, 4))], dict(min=-0.5, max=0.7)),
      grad=True),
    C("lerp", lambda g: ([A(f32(g, 3, 4)), A(f32(g, 3, 4))],
                         dict(weight=0.3)), grad=True),
    C("addmm", lambda g: ([A(f32(g, 3, 4)), A(f32(g, 3, 5)),
                           A(f32(g, 5, 4))], dict(beta=0.5, alpha=2.0)),
      grad=True),
    C("_identity", lambda g: ([A(f32(g, 3))], {}), grad=True,
      id="math._identity"),
    # ---- creation
    C("to_tensor", lambda g: ([[1.5, 2.0]], {}), id="to_tensor_float"),
    C("to_tensor", lambda g: ([[1, 2]], {}), id="to_tensor_int"),
    C("to_tensor", lambda g: ([True], {}), id="to_tensor_bool"),
    C("to_tensor", lambda g: ([f64(g, 3)], {}), id="to_tensor_ndarray_f64"),
    C("to_tensor", lambda g: ([[1, 2]], dict(dtype="float32")),
      id="to_tensor_dtype"),
    C("zeros", lambda g: ([[2, 3]], {})),
    C("ones", lambda g: ([[2, 3]], dict(dtype="int32"))),
    C("full", lambda g: ([[2, 3], 1.5], {})),
    C("full", lambda g: ([[2], 7], {}), id="full_int"),
    C("full", lambda g: ([[2], True], {}), id="full_bool"),
    C("empty", lambda g: ([[2, 3]], {})),
    C("zeros_like", lambda g: ([Arr(ints(g, 2, 3))], {})),
    C("ones_like", lambda g: ([Arr(f32(g, 2, 3))], dict(dtype="float64"))),
    C("full_like", lambda g: ([Arr(f32(g, 2, 3)), 4.0], {})),
    C("empty_like", lambda g: ([Arr(f32(g, 2, 3))], {})),
    C("arange", lambda g: ([5], {})),
    C("arange", lambda g: ([1, 10, 3], {}), id="arange_step"),
    C("arange", lambda g: ([0.0, 1.0, 0.25], {}), id="arange_float"),
    C("linspace", lambda g: ([0.0, 1.0, 7], {})),
    C("logspace", lambda g: ([0.0, 2.0, 5], {})),
    C("eye", lambda g: ([3], {})),
    C("eye", lambda g: ([3, 4], dict(dtype="int64")), id="eye_rect"),
    C("tril", lambda g: ([A(f32(g, 4, 4))], dict(diagonal=-1)), grad=True),
    C("triu", lambda g: ([A(f32(g, 4, 5))], dict(diagonal=1)), grad=True),
    C("meshgrid", lambda g: ([Arr(f32(g, 3)), Arr(f32(g, 4))], {})),
    C("diag", lambda g: ([A(f32(g, 3))], dict(offset=1)), grad=True),
    C("diag", lambda g: ([Arr(f32(g, 3))], dict(offset=1,
                                               padding_value=9.0)),
      id="diag_padding"),
    C("diag", lambda g: ([A(f32(g, 4, 4))], dict(offset=-1)), grad=True,
      id="diag_of_matrix"),
    C("diagflat", lambda g: ([A(f32(g, 2, 2))], dict(offset=1)), grad=True),
    C("diag_embed", lambda g: ([A(f32(g, 2, 3))], {}), grad=True),
    C("assign", lambda g: ([Arr(f32(g, 3))], {})),
    C("clone", lambda g: ([A(f32(g, 3))], {}), grad=True),
    C("numel", lambda g: ([Arr(f32(g, 3, 4))], {})),
    C("one_hot", lambda g: ([Arr(ints(g, 5, hi=4))], dict(num_classes=4))),
    # ---- manipulation
    C("cast", lambda g: ([Arr(f32(g, 3))], dict(dtype="int32"))),
    C("reshape", lambda g: ([A(f32(g, 2, 3, 4))], dict(shape=[6, -1])),
      grad=True),
    C("flatten", lambda g: ([A(f32(g, 2, 3, 4))],
                            dict(start_axis=1, stop_axis=2)), grad=True),
    C("transpose", lambda g: ([A(f32(g, 2, 3, 4))], dict(perm=[2, 0, 1])),
      grad=True),
    C("moveaxis", lambda g: ([A(f32(g, 2, 3, 4))], dict(source=0,
                                                      destination=2)),
      grad=True),
    C("swapaxes", lambda g: ([A(f32(g, 2, 3, 4))], dict(axis0=0, axis1=2)),
      grad=True),
    C("squeeze", lambda g: ([A(f32(g, 1, 3, 1))], dict(axis=[0, 1])),
      grad=True),
    C("squeeze", lambda g: ([A(f32(g, 1, 3, 1))], {}), id="squeeze_all"),
    C("unsqueeze", lambda g: ([A(f32(g, 2, 3))], dict(axis=[0, -1])),
      grad=True),
    C("concat", lambda g: ([[A(f32(g, 2, 3)), A(f32(g, 1, 3))]], {}),
      grad=True),
    C("stack", lambda g: ([[A(f32(g, 2, 3)), A(f32(g, 2, 3))]],
                          dict(axis=1)), grad=True),
    C("split", lambda g: ([A(f32(g, 6, 2))], dict(num_or_sections=3)),
      grad=True),
    C("chunk", lambda g: ([A(f32(g, 2, 6))], dict(chunks=2, axis=1)),
      grad=True),
    C("unbind", lambda g: ([A(f32(g, 3, 2))], dict(axis=1)), grad=True),
    C("tile", lambda g: ([A(f32(g, 2, 3))], dict(repeat_times=[2, 1, 2])),
      grad=True),
    C("expand", lambda g: ([A(f32(g, 1, 3))], dict(shape=[2, -1, 3])),
      grad=True),
    C("broadcast_to", lambda g: ([A(f32(g, 3))], dict(shape=[2, 3])),
      grad=True),
    C("expand_as", lambda g: ([A(f32(g, 1, 3)), Arr(f32(g, 4, 3))], {}),
      grad=True),
    C("broadcast_tensors", lambda g: ([[A(f32(g, 1, 3)),
                                        A(f32(g, 2, 1))]], {}), grad=True),
    C("flip", lambda g: ([A(f32(g, 2, 3))], dict(axis=[0, 1])), grad=True),
    C("rot90", lambda g: ([A(f32(g, 2, 3))], dict(k=3)), grad=True),
    C("roll", lambda g: ([A(f32(g, 2, 3))], dict(shifts=2)), grad=True),
    C("roll", lambda g: ([A(f32(g, 2, 3))], dict(shifts=[1, -1],
                                                 axis=[0, 1])),
      id="roll_axes"),
    C("gather", lambda g: ([A(f32(g, 5, 3)), Arr(ints(g, 4, hi=5))],
                           dict(axis=0)), grad=True),
    C("gather_nd", lambda g: ([A(f32(g, 4, 3, 2)),
                               Arr(ints(g, 5, 2, hi=3))], {}), grad=True),
    C("take_along_axis", lambda g: ([A(f32(g, 3, 4)),
                                     Arr(ints(g, 3, 2, hi=4))],
                                    dict(axis=1)), grad=True),
    C("put_along_axis", lambda g: ([A(f32(g, 3, 4)),
                                    Arr(np.array([[0], [2], [3]])),
                                    A(f32(g, 3, 1))], dict(axis=1)),
      grad=True),
    C("put_along_axis", lambda g: ([A(f32(g, 3, 4)),
                                    Arr(ints(g, 3, 3, hi=4)),
                                    A(f32(g, 3, 3))],
                                   dict(axis=1, reduce="add")),
      grad=True, id="put_along_axis_add"),
    C("scatter", lambda g: ([A(f32(g, 5, 3)), Arr(np.array([4, 0, 2])),
                             A(f32(g, 3, 3))], {}), grad=True),
    C("scatter_nd_add", lambda g: ([A(f32(g, 4, 3)),
                                    Arr(np.array([[1], [3], [1]])),
                                    A(f32(g, 3, 3))], {}), grad=True),
    C("scatter_nd", lambda g: ([Arr(np.array([[1, 2], [0, 0], [1, 2]])),
                                A(f32(g, 3))], dict(shape=[2, 3])),
      grad=True),
    C("index_select", lambda g: ([A(f32(g, 3, 5)), Arr(ints(g, 4, hi=5))],
                                 dict(axis=1)), grad=True),
    C("index_sample", lambda g: ([A(f32(g, 3, 5)),
                                  Arr(ints(g, 3, 2, hi=5))], {}),
      grad=True),
    C("masked_select", lambda g: ([Arr(f32(g, 3, 4)),
                                   Arr(bools(g, 3, 4))], {})),
    C("masked_fill", lambda g: ([A(f32(g, 3, 4)), Arr(bools(g, 3, 4)),
                                 -1.5], {}), grad=True),
    C("where", lambda g: ([Arr(bools(g, 3, 4)), A(f32(g, 3, 4)),
                           A(f32(g, 4))], {}), grad=True),
    C("where", lambda g: ([Arr(bools(g, 3, 4))], {}), id="where_nonzero"),
    C("nonzero", lambda g: ([Arr(ints(g, 3, 4, hi=2))], {})),
    C("nonzero", lambda g: ([Arr(ints(g, 3, 4, hi=2))], dict(as_tuple=True)),
      id="nonzero_tuple"),
    C("sort", lambda g: ([A(f32(g, 3, 5))], dict(axis=1)), grad=True),
    C("argsort", lambda g: ([Arr(f32(g, 3, 5))], dict(axis=0))),
    C("topk", lambda g: ([A(f32(g, 3, 6))], dict(k=2)), grad=True),
    C("kthvalue", lambda g: ([A(f32(g, 3, 6))], dict(k=3, axis=1)),
      grad=True),
    C("mode", lambda g: ([Arr(ints(g, 3, 7, hi=3))], dict(axis=1))),
    C("searchsorted", lambda g: ([Arr(np.sort(f32(g, 6))),
                                  Arr(f32(g, 4))], {})),
    C("searchsorted", lambda g: ([Arr(np.array([1, 2, 2, 5])),
                                  Arr(np.array([2, 5, 0]))],
                                 dict(right=True, out_int32=True)),
      id="searchsorted_right_int32"),
    C("bucketize", lambda g: ([Arr(f32(g, 4)), Arr(np.sort(f32(g, 6)))],
                              {})),
    C("unique", lambda g: ([Arr(ints(g, 3, 4, hi=5))],
                           dict(return_inverse=True, return_counts=True))),
    C("unique", lambda g: ([Arr(ints(g, 5, 2, hi=2))],
                           dict(axis=0, return_counts=True)),
      id="unique_rows"),
    C("unique_consecutive", lambda g: ([Arr(np.array([1, 1, 2, 2, 2, 1,
                                                      3]))],
                                       dict(return_inverse=True,
                                            return_counts=True))),
    C("pad", lambda g: ([A(f32(g, 1, 2, 3, 3))], dict(pad=[1, 0, 2, 1])),
      grad=True),
    *[C("pad", lambda g: ([A(f32(g, 1, 2, 4, 5))],
                          dict(pad=[2, 1, 1, 3], mode=m)), grad=True,
        id=f"pad_{m}") for m in ("reflect", "replicate", "circular")],
    C("pad", lambda g: ([A(f32(g, 1, 4, 5, 2))],
                        dict(pad=[1, 2, 0, 1], data_format="NHWC",
                             value=3.0)), grad=True, id="pad_nhwc"),
    C("pad", lambda g: ([A(f32(g, 3, 4))], dict(pad=[1, 0, 0, 2])),
      grad=True, id="pad_full"),
    C("repeat_interleave", lambda g: ([A(f32(g, 2, 3))],
                                      dict(repeats=2, axis=1)), grad=True),
    C("repeat_interleave", lambda g: ([Arr(f32(g, 3))],
                                      dict(repeats=Arr(np.array([1, 0, 2])),
                                           axis=0)),
      id="repeat_interleave_tensor"),
    C("tensordot", lambda g: ([A(f32(g, 2, 3, 4)), A(f32(g, 3, 4, 5))],
                              dict(axes=2)), grad=True),
    C("slice", lambda g: ([A(f32(g, 4, 5, 6))],
                          dict(axes=[0, 2], starts=[1, -3], ends=[3, 100])),
      grad=True),
    C("strided_slice", lambda g: ([A(f32(g, 5, 6))],
                                  dict(axes=[0, 1], starts=[0, 5],
                                       ends=[5, 0], strides=[2, -2])),
      grad=True),
    C("reshape_", lambda g: ([Arr(f32(g, 2, 3))], dict(shape=[3, 2]))),
    # ---- linalg
    C("matmul", lambda g: ([A(f32(g, 2, 3, 4)), A(f32(g, 4, 5))], {}),
      grad=True),
    C("matmul", lambda g: ([A(f32(g, 4, 3)), A(f32(g, 5, 4))],
                           dict(transpose_x=True, transpose_y=True)),
      grad=True, id="matmul_transposed"),
    C("mm", lambda g: ([A(f32(g, 3, 4)), A(f32(g, 4, 2))], {}), grad=True),
    C("bmm", lambda g: ([A(f32(g, 2, 3, 4)), A(f32(g, 2, 4, 2))], {}),
      grad=True),
    C("dot", lambda g: ([A(f32(g, 2, 3)), A(f32(g, 2, 3))], {}), grad=True),
    C("mv", lambda g: ([A(f32(g, 3, 4)), A(f32(g, 4))], {}), grad=True),
    C("t", lambda g: ([A(f32(g, 3, 4))], {}), grad=True),
    *[C("norm", lambda g: ([A(f32(g, 3, 4))], kw), grad=True,
        id=f"norm{kw}")
      for kw in ({}, dict(p=2, axis=1), dict(p=1, axis=[0, 1]),
                 dict(p=float("inf"), axis=0, keepdim=True),
                 dict(p=3, axis=1), dict(p="fro", axis=[0, 1]))],
    C("dist", lambda g: ([A(f32(g, 3, 4)), A(f32(g, 3, 4))], dict(p=3)),
      grad=True),
    C("cond_number", lambda g: ([Arr(well(g, 4, np.float64))], {})),
    C("cross", lambda g: ([A(f32(g, 2, 3)), A(f32(g, 2, 3))], {}),
      grad=True),
    C("histogram", lambda g: ([Arr(f64(g, 50))], dict(bins=7))),
    C("histogram", lambda g: ([Arr(f64(g, 50))], dict(bins=5, min=-1,
                                                     max=1)),
      id="histogram_range"),
    C("bincount", lambda g: ([Arr(ints(g, 20, hi=6))], {})),
    C("bincount", lambda g: ([Arr(ints(g, 20, hi=6)), ],
                             dict(weights=Arr(f32(g, 20)), minlength=8)),
      id="bincount_weights"),
    C("matrix_power", lambda g: ([A(f32(g, 3, 3, lo=-1, hi=1))],
                                 dict(n=3)), grad=True),
    *[C(n, lambda g: ([A(well(g, 4, np.float64))], {}), grad=True)
      for n in ("inverse", "inv", "det", "slogdet")],
    C("pinv", lambda g: ([Arr(f64(g, 4, 3))], {})),
    C("eigvalsh", lambda g: ([Arr(spd(g, 4, np.float64))], {})),
    C("cholesky", lambda g: ([A(spd(g, 4, np.float64))], {}), grad=True),
    C("cholesky", lambda g: ([Arr(spd(g, 4, np.float64))],
                             dict(upper=True)), id="cholesky_upper"),
    C("cholesky_solve", lambda g: ([Arr(f64(g, 4, 2)),
                                    Arr(np.linalg.cholesky(
                                        spd(g, 4, np.float64)))], {})),
    C("solve", lambda g: ([A(well(g, 4, np.float64)), A(f64(g, 4, 2))], {}),
      grad=True),
    C("triangular_solve", lambda g: ([Arr(np.triu(well(g, 4, np.float64))),
                                      Arr(f64(g, 4, 2))], {})),
    C("triangular_solve", lambda g: ([Arr(np.tril(well(g, 4, np.float64))),
                                      Arr(f64(g, 4, 2))],
                                     dict(upper=False, transpose=True,
                                          unitriangular=True)),
      id="triangular_solve_lower_t"),
    C("matrix_rank", lambda g: ([Arr(f64(g, 4, 3) @ f64(g, 3, 5))], {})),
    C("multi_dot", lambda g: ([[A(f32(g, 3, 4)), A(f32(g, 4, 5)),
                                A(f32(g, 5, 2))]], {}), grad=True),
    C("einsum", lambda g: (["bij,bjk->bik", A(f32(g, 2, 3, 4)),
                            A(f32(g, 2, 4, 5))], {}), grad=True),
    C("corrcoef", lambda g: ([Arr(f64(g, 3, 6))], {})),
    C("cov", lambda g: ([Arr(f64(g, 3, 6))], dict(rowvar=False,
                                                  ddof=False))),
    # ---- extras
    C("logcumsumexp", lambda g: ([A(f32(g, 3, 4))], dict(axis=1)),
      grad=True),
    C("cumulative_trapezoid", lambda g: ([A(f32(g, 3, 5))], dict(dx=0.5)),
      grad=True),
    C("cumulative_trapezoid", lambda g: ([A(f32(g, 3, 5)),
                                          Arr(np.sort(f32(g, 3, 5)))], {}),
      id="cumulative_trapezoid_x"),
    C("nanmedian", lambda g: ([Arr(np.where(bools(g, 3, 6), np.nan,
                                            f32(g, 3, 6)))], dict(axis=1))),
    C("nanquantile", lambda g: ([Arr(np.where(bools(g, 3, 6), np.nan,
                                              f32(g, 3, 6)))],
                                dict(q=0.25, axis=1))),
    C("index_add", lambda g: ([A(f32(g, 4, 3)), Arr(np.array([0, 2, 0])),
                               0, A(f32(g, 3, 3))], {}), grad=True),
    C("index_put", lambda g: ([A(f32(g, 4, 3)),
                               (Arr(np.array([0, 3])), Arr(np.array([1, 2]))),
                               A(f32(g, 2))], {}), grad=True),
    C("index_put", lambda g: ([A(f32(g, 4, 3)),
                               (Arr(np.array([0, 3, 0])),),
                               A(f32(g, 3, 3))], dict(accumulate=True)),
      grad=True, id="index_put_accumulate"),
    C("take", lambda g: ([A(f32(g, 3, 4)), Arr(np.array([[0, 11], [5, 20]]))],
                         {}), grad=True),
    C("take", lambda g: ([Arr(f32(g, 3, 4)), Arr(np.array([-1, 13]))],
                         dict(mode="wrap")), id="take_wrap"),
    C("msort", lambda g: ([A(f32(g, 4, 3))], {}), grad=True),
    C("as_strided", lambda g: ([A(f32(g, 12))], dict(shape=[3, 2],
                                                     stride=[4, 1],
                                                     offset=1)),
      grad=True),
    C("unfold", lambda g: ([A(f32(g, 3, 8))], dict(axis=1, size=3,
                                                   step=2)), grad=True),
    C("view", lambda g: ([A(f32(g, 2, 6))], dict(shape_or_dtype=[3, 4])),
      grad=True),
    C("view", lambda g: ([Arr(f32(g, 2, 4))],
                         dict(shape_or_dtype="int32")), id="view_dtype"),
    C("view_as", lambda g: ([A(f32(g, 2, 6)), Arr(f32(g, 4, 3))], {}),
      grad=True),
    C("unflatten", lambda g: ([A(f32(g, 2, 6))], dict(axis=1,
                                                      shape=[2, 3])),
      grad=True),
    C("unstack", lambda g: ([A(f32(g, 2, 3))], dict(axis=1)), grad=True),
    C("vsplit", lambda g: ([A(f32(g, 4, 3))], dict(num_or_indices=2)),
      grad=True),
    C("hsplit", lambda g: ([A(f32(g, 2, 6))], dict(num_or_indices=[1, 4])),
      grad=True),
    C("dsplit", lambda g: ([A(f32(g, 2, 2, 4))], dict(num_or_indices=2)),
      grad=True),
    C("diagonal", lambda g: ([A(f32(g, 3, 4, 5))], dict(offset=1, axis1=1,
                                                        axis2=2)),
      grad=True),
    C("renorm", lambda g: ([A(f32(g, 3, 4))], dict(p=2, axis=0,
                                                   max_norm=1.0)),
      grad=True),
    C("nan_to_num", lambda g: ([Arr(np.array([np.nan, np.inf, -np.inf,
                                              1.5], np.float32))],
                               dict(nan=0.5, posinf=9.0))),
    C("vander", lambda g: ([A(f32(g, 4))], dict(n=3)), grad=True),
    C("vander", lambda g: ([Arr(f32(g, 4))], dict(increasing=True)),
      id="vander_increasing"),
    C("polygamma", lambda g: ([Arr(f32(g, 5, lo=0.5, hi=3.0))], dict(n=1))),
    C("fmod", lambda g: ([A(f32(g, 3, 4)), Arr(f32(g, 4, lo=0.5, hi=2))],
                         {}), grad=True),
    C("float_power", lambda g: ([A(f32(g, 3, lo=0.5, hi=2.0)),
                                 Arr(f32(g, 3))], {}), grad=True),
    C("isreal", lambda g: ([Arr(f32(g, 3))], {})),
    C("as_complex", lambda g: ([Arr(f32(g, 3, 2))], {})),
    C("as_real", lambda g: ([Arr((f32(g, 3) + 1j * f32(g, 3)).astype(
        np.complex64))], {})),
    C("histogramdd", lambda g: ([Arr(f64(g, 30, 2))],
                                dict(bins=3, ranges=[(-2, 2), (-2, 2)]))),
    C("pdist", lambda g: ([A(f32(g, 4, 3))], {}), grad=True),
    C("cdist", lambda g: ([A(f32(g, 3, 2)), A(f32(g, 4, 2))], dict(p=1.0)),
      grad=True),
    C("lu", lambda g: ([Arr(well(g, 4, np.float64))], {})),
    C("lu", lambda g: ([Arr(well(g, 4, np.float64))],
                       dict(get_infos=True)), id="lu_infos"),
    # ---- api_misc
    C("add_n", lambda g: ([[A(f32(g, 2, 3)), A(f32(g, 2, 3)),
                            A(f32(g, 2, 3))]], {}), grad=True),
    C("logit", lambda g: ([A(f32(g, 3, lo=0.1, hi=0.9))], dict(eps=0.2)),
      grad=True),
    C("multiplex", lambda g: ([[A(f32(g, 3, 2)), A(f32(g, 3, 2))],
                               Arr(np.array([[1], [0], [1]]))], {}),
      grad=True),
    C("complex", lambda g: ([Arr(f32(g, 3)), Arr(f32(g, 3))], {})),
    C("crop", lambda g: ([A(f32(g, 4, 5))], dict(shape=[2, -1],
                                                 offsets=[1, 2])),
      grad=True),
    C("shard_index", lambda g: ([Arr(ints(g, 6, 1, hi=20))],
                                dict(index_num=20, nshards=2, shard_id=1))),
    C("tril_indices", lambda g: ([4, 3, -1], {})),
    C("triu_indices", lambda g: ([3], dict(offset=1))),
    C("reverse", lambda g: ([A(f32(g, 2, 3))], dict(axis=1)), grad=True),
    C("broadcast_shape", lambda g: ([[2, 1, 3], [4, 3]], {})),
    C("is_empty", lambda g: ([Arr(np.zeros((0, 3), np.float32))], {})),
    C("rank", lambda g: ([Arr(f32(g, 2, 3))], {})),
    C("shape", lambda g: ([Arr(f32(g, 2, 3))], {})),
    C("tolist", lambda g: ([Arr(ints(g, 2, 2))], {})),
    # ---- activation
    *[C(n, lambda g: ([A(f32(g, 3, 4))], {}), grad=True, fn=n,
        id=f"activation.{n}")
      for n in ("relu", "relu6", "sigmoid", "silu", "swish", "tanh",
                "mish", "tanhshrink", "softsign", "log_sigmoid", "gelu",
                "leaky_relu", "elu", "selu", "celu", "hardtanh",
                "hardsigmoid", "hardswish", "hardshrink", "softshrink",
                "thresholded_relu", "softplus", "softmax", "log_softmax",
                "glu")],
    C("prelu", lambda g: ([A(f32(g, 2, 3, 4)), A(f32(g, 3))], {}),
      grad=True, id="activation.prelu"),
    C("maxout", lambda g: ([A(f32(g, 2, 4, 3))], dict(groups=2)),
      grad=True, id="activation.maxout"),
    C("rrelu", lambda g: ([A(f32(g, 3, 4))], dict(training=False)),
      grad=True, id="activation.rrelu_eval"),
]

# cases whose functions live outside the flat namespace
_MODULE_OF = {c.id: c.id.split(".")[0] for c in CASES
              if c.id.split(".")[0] in ("activation", "math")}


def _fn(mod_ref, mod_port, case):
    sub = _MODULE_OF.get(case.id)
    if sub:
        return getattr(getattr(mod_ref, sub), case.fn), \
            getattr(getattr(mod_port, sub), case.fn)
    return getattr(mod_ref, case.fn), getattr(mod_port, case.fn)


def _float_out(out):
    leaves = _leaves(out, lambda v: isinstance(v, torch.Tensor)
                     and v.is_floating_point() and v.requires_grad, [])
    return leaves[0] if leaves else None


def _ref_float_out(out):
    leaves = _leaves(out, lambda v: isinstance(v, J.Tensor)
                     and np.asarray(v._value).dtype.kind == "f"
                     and not v.stop_gradient, [])
    return leaves[0] if leaves else None


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_op_matches_reference(case):
    args, kw = case.inputs()
    fr, fp = _fn(jops, tops, case)
    ref = fr(*_to_ref(args, case.grad), **_to_ref(kw, case.grad))
    got = fp(*_to_port(args, case.grad), **_to_port(kw, case.grad))
    _cmp_tree(ref, got)
    if not case.grad:
        return
    # the gradient of Σ out · w through the first float output
    args_r = _to_ref(args, True)
    kw_r = _to_ref(kw, True)
    args_p = _to_port(args, True)
    kw_p = _to_port(kw, True)
    out_r = _ref_float_out(fr(*args_r, **kw_r))
    out_p = _float_out(fp(*args_p, **kw_p))
    assert out_r is not None and out_p is not None
    w = np.random.default_rng(7).standard_normal(
        tuple(out_p.shape)).astype(np.asarray(out_r._value).dtype)
    xs_r = _leaves([args_r, list(kw_r.values())],
                   lambda v: isinstance(v, J.Tensor)
                   and not v.stop_gradient, [])
    xs_p = _leaves([args_p, list(kw_p.values())],
                   lambda v: isinstance(v, torch.Tensor) and v.requires_grad,
                   [])
    g_r = J.grad(J.sum(out_r * J.to_tensor(w)), xs_r, allow_unused=True)
    g_p = torch.autograd.grad((out_p * torch.from_numpy(w)).sum(), xs_p,
                              allow_unused=True)
    for i, (a, b) in enumerate(zip(g_r, g_p)):
        if a is None:
            assert b is None or not b.any(), i
            continue
        b = torch.zeros_like(xs_p[i]) if b is None else b
        _close(a, b, f"grad[{i}]")


# ---- the decompositions: what is unique -------------------------------------

def _np(v):
    return _np_of(v)


@pytest.mark.parametrize("full", [False, True])
def test_svd_reconstructs_like_the_reference(full):
    a = np.random.default_rng(1).standard_normal((4, 3))
    ur, sr, vr = jops.svd(J.to_tensor(a), full_matrices=full)
    up, sp, vp = tops.svd(torch.tensor(a), full_matrices=full)
    assert [tuple(t.shape) for t in (up, sp, vp)] == \
        [tuple(t.shape) for t in (ur, sr, vr)]
    np.testing.assert_allclose(_np(sp), _np(sr), rtol=1e-12, atol=1e-12)
    k = min(a.shape)
    rec = _np(up)[:, :k] * _np(sp) @ _np(vp)[:k]
    np.testing.assert_allclose(rec, a, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("mode", ["reduced", "complete"])
def test_qr_reconstructs_like_the_reference(mode):
    a = np.random.default_rng(2).standard_normal((5, 3))
    qr_, rr = jops.qr(J.to_tensor(a), mode=mode)
    qp, rp = tops.qr(torch.tensor(a), mode=mode)
    assert qp.shape == tuple(qr_.shape) and rp.shape == tuple(rr.shape)
    np.testing.assert_allclose(_np(qp) @ _np(rp), a, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.abs(_np(rp)), np.abs(_np(rr)),
                               rtol=1e-12, atol=1e-12)


def test_eigh_and_eig_spectra_match_the_reference():
    g = np.random.default_rng(3)
    s = spd(g, 4, np.float64)
    wr, _ = jops.eigh(J.to_tensor(s))
    wp, vp = tops.eigh(torch.tensor(s))
    np.testing.assert_allclose(_np(wp), _np(wr), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(s @ _np(vp), _np(vp) * _np(wp),
                               rtol=1e-12, atol=1e-12)
    a = well(g, 4, np.float64)
    er = np.sort_complex(_np(jops.eig(J.to_tensor(a))[0]))
    ep, vep = tops.eig(torch.tensor(a))
    np.testing.assert_allclose(np.sort_complex(_np(ep)), er, rtol=1e-12,
                               atol=1e-12)
    assert _dname(_np(ep)) == _dname(er)
    np.testing.assert_allclose(a @ _np(vep), _np(vep) * _np(ep), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(
        np.sort_complex(_np(tops.eigvals(torch.tensor(a)))),
        np.sort_complex(_np(jops.eigvals(J.to_tensor(a)))), rtol=1e-12,
        atol=1e-12)


def test_lstsq_and_lu_unpack_match_the_reference():
    g = np.random.default_rng(4)
    a, b = g.standard_normal((6, 3)), g.standard_normal((6, 2))
    xr = jops.lstsq(J.to_tensor(a), J.to_tensor(b))
    xp = tops.lstsq(torch.tensor(a), torch.tensor(b))
    assert len(xp) == len(xr)
    np.testing.assert_allclose(_np(xp[0]), _np(xr[0]), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(_np(xp[1]), _np(xr[1]), rtol=1e-12,
                               atol=1e-12)
    assert int(xp[2]) == int(_np(xr[2]))
    np.testing.assert_allclose(_np(xp[3]), _np(xr[3]), rtol=1e-12,
                               atol=1e-12)
    m = well(g, 4, np.float64)
    lr = jops.lu(J.to_tensor(m))
    lp = tops.lu(torch.tensor(m))
    _cmp_tree(jops.lu_unpack(*lr), tops.lu_unpack(*lp))


def test_svd_lowrank_recovers_a_low_rank_matrix():
    g = np.random.default_rng(5)
    a = g.standard_normal((8, 2)) @ g.standard_normal((2, 6))
    u, s, v = tops.svd_lowrank(torch.tensor(a), q=4)
    ur, sr, vr = jops.svd_lowrank(J.to_tensor(a), q=4)
    assert tuple(u.shape) == tuple(ur.shape) and tuple(v.shape) == \
        tuple(vr.shape)
    np.testing.assert_allclose(_np(s)[:2], _np(sr)[:2], rtol=1e-10)
    np.testing.assert_allclose(_np(u) * _np(s) @ _np(v).T, a, atol=1e-10)


# ---- the traps ---------------------------------------------------------------

def test_descending_sort_and_argsort_put_ties_last_index_first():
    a = np.array([[3, 1, 3, 2, 1, 1], [0, 0, 5, 5, 0, 5]], np.int64)
    for fn in ("sort", "argsort"):
        ref = getattr(jops, fn)(J.to_tensor(a), axis=1, descending=True)
        got = getattr(tops, fn)(torch.tensor(a), axis=1, descending=True)
        _close(ref, got, fn)
    got = tops.argsort(torch.tensor(a), axis=1, descending=True)
    assert got[0].tolist() == [2, 0, 3, 5, 4, 1]
    # torch's own stable descending order puts the first index first
    assert torch.argsort(torch.tensor(a), dim=1, descending=True,
                         stable=True)[0].tolist() == [0, 2, 3, 1, 4, 5]


@pytest.mark.parametrize("largest", [True, False])
def test_topk_ties_keep_the_lower_index(largest):
    a = np.array([[1., 3., 3., 2., 3., 1.], [2., 2., 2., 2., 0., 0.]],
                 np.float32)
    ref = jops.topk(J.to_tensor(a), 3, largest=largest)
    got = tops.topk(torch.tensor(a), 3, largest=largest)
    _cmp_tree(ref, got)
    assert got[1][0].tolist() == ([1, 2, 4] if largest else [0, 5, 3])


def test_scatter_repeated_rows_last_writer_wins_and_overwrite_false_sums():
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    idx = np.array([1, 3, 1, 1])
    upd = np.arange(12, dtype=np.float32).reshape(4, 3) + 100
    for ow in (True, False):
        ref = jops.scatter(J.to_tensor(x), J.to_tensor(idx),
                           J.to_tensor(upd), overwrite=ow)
        got = tops.scatter(torch.tensor(x), torch.tensor(idx),
                           torch.tensor(upd), overwrite=ow)
        _close(ref, got, f"overwrite={ow}")
    got = tops.scatter(torch.tensor(x), torch.tensor(idx), torch.tensor(upd))
    assert got[1].tolist() == upd[3].tolist()
    got = tops.scatter(torch.tensor(x), torch.tensor(idx), torch.tensor(upd),
                       overwrite=False)
    assert got[1].tolist() == (upd[0] + upd[2] + upd[3]).tolist()


def test_put_along_axis_and_index_put_repeated_index_last_writer_wins():
    arr = np.zeros((2, 4), np.float32)
    idx = np.array([[1, 1, 1], [3, 0, 3]])
    val = np.array([[5., 6., 7.], [8., 9., 10.]], np.float32)
    ref = jops.put_along_axis(J.to_tensor(arr), J.to_tensor(idx),
                              J.to_tensor(val), 1)
    got = tops.put_along_axis(torch.tensor(arr), torch.tensor(idx),
                              torch.tensor(val), 1)
    _close(ref, got, "put_along_axis")
    assert got.tolist() == [[0., 7., 0., 0.], [9., 0., 0., 10.]]
    ref = jops.put_along_axis(J.to_tensor(arr), J.to_tensor(idx),
                              J.to_tensor(val), 1, reduce="mul")
    got = tops.put_along_axis(torch.tensor(arr) + 1, torch.tensor(idx),
                              torch.tensor(val), 1, reduce="mul")
    _close(jops.put_along_axis(J.to_tensor(arr + 1), J.to_tensor(idx),
                               J.to_tensor(val), 1, reduce="mul"), got,
           "mul")
    x = np.zeros((3, 2), np.float32)
    rows = np.array([2, 0, 2])
    v = np.array([[1., 1.], [2., 2.], [3., 3.]], np.float32)
    ref = jops.index_put(J.to_tensor(x), (J.to_tensor(rows),),
                         J.to_tensor(v))
    got = tops.index_put(torch.tensor(x), (torch.tensor(rows),),
                         torch.tensor(v))
    _close(ref, got, "index_put")
    assert got[2].tolist() == [3., 3.]


def test_unique_return_index_is_the_first_occurrence():
    a = np.array([4, 1, 4, 2, 1, 1, 9, 2])
    ref = jops.unique(J.to_tensor(a), return_index=True,
                      return_inverse=True, return_counts=True)
    got = tops.unique(torch.tensor(a), return_index=True,
                      return_inverse=True, return_counts=True)
    _cmp_tree(ref, got)
    assert got[1].tolist() == [1, 3, 0, 6]
    rows = np.array([[1, 2], [0, 0], [1, 2], [0, 1]])
    _cmp_tree(jops.unique(J.to_tensor(rows), return_index=True, axis=0),
              tops.unique(torch.tensor(rows), return_index=True, axis=0))


def test_mode_smallest_of_the_most_frequent_and_its_last_index():
    a = np.array([[1, 2, 2, 3, 3], [4, 4, 1, 1, 0], [7, 7, 7, 7, 7]])
    for axis, keep in ((1, False), (0, True)):
        _cmp_tree(jops.mode(J.to_tensor(a), axis=axis, keepdim=keep),
                  tops.mode(torch.tensor(a), axis=axis, keepdim=keep))
    v, i = tops.mode(torch.tensor(a))
    assert v.tolist() == [2, 1, 7] and i.tolist() == [2, 3, 4]


def test_reshape_zero_copies_the_input_dim_and_split_minus_one():
    a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    got = tops.reshape(torch.tensor(a), [0, -1, 2])
    _close(jops.reshape(J.to_tensor(a), [2, -1, 2]), got, "reshape")
    parts = tops.split(torch.tensor(a), [1, -1], axis=2)
    _cmp_tree(jops.split(J.to_tensor(a), [1, -1], axis=2), parts)
    assert [p.shape[2] for p in parts] == [1, 3]


def test_nonzero_and_where_int64_indices():
    a = np.array([[0, 3], [2, 0], [0, 0]])
    got = tops.nonzero(torch.tensor(a))
    assert got.dtype == torch.int64 and got.tolist() == [[0, 1], [1, 0]]


# ---- control flow ---------------------------------------------------------

def test_control_flow_follows_the_reference_eager_path():
    for mod, conv in ((jops, J.to_tensor), (tops, torch.tensor)):
        x = conv(np.float32(2.0))
        assert float(mod.cond(conv(True), lambda: x * 2,
                              lambda: x * 3)) == 4.0
        assert float(mod.cond(conv(False), lambda: x * 2,
                              lambda: x * 3)) == 6.0
        i, s = mod.while_loop(lambda i, s: i < 4,
                              lambda i, s: (i + 1, s + i),
                              [conv(np.int64(0)), conv(np.int64(0))])
        assert int(i) == 4 and int(s) == 6
        assert float(mod.case([(conv(False), lambda: x),
                               (conv(True), lambda: x + 1)],
                              default=lambda: x - 1)) == 3.0
        assert float(mod.case([(conv(False), lambda: x),
                               (conv(False), lambda: x + 5)])) == 7.0
        assert float(mod.switch_case(conv(np.int64(1)),
                                     {0: lambda: x, 1: lambda: x * 10})) \
            == 20.0
        assert float(mod.switch_case(conv(np.int64(7)),
                                     [lambda: x, lambda: x * 10],
                                     default=lambda: x * 0)) == 0.0
        assert float(mod.switch_case(conv(np.int64(7)),
                                     [(1, lambda: x), (3, lambda: x * 5)])
                     ) == 10.0


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_matches_the_reference_and_its_gradient(reverse):
    g = np.random.default_rng(6)
    xs, w, c0 = g.standard_normal((5, 3)), g.standard_normal((3, 3)), \
        g.standard_normal(3)
    wr = J.to_tensor(w, stop_gradient=False)
    xr = J.to_tensor(xs, stop_gradient=False)
    cr, yr = jops.scan(lambda c, x: (J.tanh(J.matmul(c, wr) + x),
                                     J.sum(c * x)),
                       J.to_tensor(c0), xr, reverse=reverse)
    wp = torch.tensor(w, requires_grad=True)
    xp = torch.tensor(xs, requires_grad=True)
    cp, yp = tops.scan(lambda c, x: (torch.tanh(c @ wp + x), (c * x).sum()),
                       torch.tensor(c0), xp, reverse=reverse)
    _close(cr, cp, "carry")
    _close(yr, yp, "ys")
    gr = J.grad(J.sum(cr) + J.sum(yr), [wr, xr])
    gp = torch.autograd.grad(cp.sum() + yp.sum(), [wp, xp])
    for a, b in zip(gr, gp):
        _close(a, b, "grad")


# ---- random ops: shape, dtype, range, moments, reproducibility ------------

def _draw(fn, *a, **k):
    T.seed(123)
    first = fn(*a, **k)
    T.seed(123)
    again = fn(*a, **k)
    assert torch.equal(first, again), fn
    T.seed(124)
    assert not torch.equal(fn(*a, **k), first) or first.numel() < 4, fn
    return first


def test_random_ops_shape_dtype_range_moments_reproducible():
    n = 20000
    u = _draw(tops.rand, [n])
    assert u.dtype == torch.float32 and float(u.min()) >= 0.0 \
        and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.02
    z = _draw(tops.randn, [n], dtype="float64")
    assert z.dtype == torch.float64
    assert abs(float(z.mean())) < 0.03 and abs(float(z.std()) - 1) < 0.03
    z = _draw(tops.normal, 2.0, 0.5, [n])
    assert abs(float(z.mean()) - 2.0) < 0.02 and \
        abs(float(z.std()) - 0.5) < 0.02
    u = _draw(tops.uniform, [n], min=-3.0, max=1.0)
    assert float(u.min()) >= -3.0 and float(u.max()) < 1.0 and \
        abs(float(u.mean()) + 1.0) < 0.05
    assert torch.equal(tops.uniform([8], seed=5), tops.uniform([8], seed=5))
    r = _draw(tops.randint, 3, 9, [n])
    assert r.dtype == torch.int64 and set(r.unique().tolist()) == \
        set(range(3, 9))
    p = _draw(tops.randperm, 50)
    assert p.dtype == torch.int64 and sorted(p.tolist()) == list(range(50))
    b = _draw(tops.bernoulli, torch.full([n], 0.3))
    assert b.dtype == torch.float32 and abs(float(b.mean()) - 0.3) < 0.02
    m = _draw(tops.multinomial, torch.tensor([0.1, 0.0, 0.9]), 2000, True)
    assert m.dtype == torch.int64 and 1 not in m.tolist() and \
        abs(float((m == 2).float().mean()) - 0.9) < 0.03
    m = tops.multinomial(torch.tensor([[0.2, 0.3, 0.5]] * 2), 3)
    assert sorted(m[0].tolist()) == [0, 1, 2]
    s = _draw(tops.standard_normal, [n])
    assert abs(float(s.std()) - 1) < 0.03
    po = _draw(tops.poisson, torch.full([n], 4.0))
    assert abs(float(po.mean()) - 4.0) < 0.1
    ri = _draw(tops.randint_like, torch.zeros(n), 2, 5)
    assert ri.dtype == torch.float32 and float(ri.min()) == 2.0 and \
        float(ri.max()) == 4.0
    # ... and they leave torch's global generator alone
    st = torch.get_rng_state()
    tops.rand([10])
    tops.randn([10])
    assert torch.equal(st, torch.get_rng_state())


def test_inplace_random_fills_and_rng_state():
    x = torch.zeros(20000)
    T.seed(3)
    T.ops.TENSOR_METHODS["uniform_"](x, -2.0, 2.0)
    assert float(x.min()) >= -2.0 and abs(float(x.mean())) < 0.05
    T.ops.TENSOR_METHODS["exponential_"](x, 2.0)
    assert float(x.min()) > 0 and abs(float(x.mean()) - 0.5) < 0.02
    state = tops.get_cuda_rng_state()
    a = tops.rand([4])
    tops.set_cuda_rng_state(state)
    assert torch.equal(tops.rand([4]), a)


# ---- the rest of the namespace ----------------------------------------------

def test_registry_builders_and_utilities():
    assert "reshape" in tops.list_ops() and tops.get_op("reshape") is \
        tops.reshape
    assert set(jops.list_ops()) - set(tops.list_ops()) <= {"identity"}
    tops.register_op("_probe_op", tops.add)
    assert tops.get_op("_probe_op") is tops.add

    @tops.defop("_probe_def")
    def probe(x):
        return x

    assert tops.get_op("_probe_def") is probe
    sq = tops.unary_op("_probe_sq", torch.square)
    assert sq(torch.tensor([3.0])).tolist() == [9.0]
    mx = tops.binary_op("_probe_max", torch.maximum)
    assert mx(torch.tensor([1.0, 5.0]), 2.0).tolist() == [2.0, 5.0]
    sm = tops.reduce_op("_probe_sum", lambda x, d, k: x.sum(d, keepdim=k))
    assert sm(torch.ones(2, 3), axis=1).tolist() == [3.0, 3.0]
    for dt in ("int8", "int32", "int64", "uint8"):
        a, b = jops.iinfo(dt), tops.iinfo(dt)
        assert (a.min, a.max, a.bits, a.dtype) == (b.min, b.max, b.bits,
                                                   b.dtype)
    t = torch.zeros(2, 3)
    assert tops.is_tensor(t) and not tops.is_tensor(3)
    assert tops.is_floating_point(t) and not tops.is_integer(t)
    assert tops.is_integer(torch.zeros(2, dtype=torch.int32))
    assert tops.is_complex(torch.zeros(2, dtype=torch.complex64))
    tops.check_shape([2, -1])
    with pytest.raises(ValueError):
        tops.check_shape([2, -3])
    with pytest.raises(ValueError):
        jops.check_shape([2, -3])
    with tops.set_grad_enabled(False):
        assert not torch.is_grad_enabled()
    assert torch.is_grad_enabled()
    tops.disable_signal_handler()
    tops.set_printoptions(precision=4)
    tops.set_printoptions(precision=8)
    x = torch.tensor([1.0, 2.0])
    assert tops.increment(x, 2.0) is x and x.tolist() == [3.0, 4.0]
    y = torch.tensor([4.0, 16.0])
    assert tops.rsqrt_(y) is y and y.tolist() == [0.5, 0.25]


def test_create_parameter_follows_its_attribute():
    from paddle_tpu_torch.nn import initializer as I

    p = tops.create_parameter([3, 4], dtype="float32",
                              default_initializer=I.Constant(0.5))
    assert isinstance(p, T.Parameter) and p.requires_grad
    assert p.shape == (3, 4) and torch.all(p == 0.5)
    b = tops.create_parameter([4], is_bias=True)
    assert torch.all(b == 0)
    frozen = tops.create_parameter(
        [2], attr=T.nn.ParamAttr(trainable=False, learning_rate=0.1))
    assert not frozen.requires_grad and \
        frozen.optimize_attr["learning_rate"] == 0.1


def test_inplace_forms_write_into_their_argument():
    x = torch.zeros(1, 3, 1)
    assert tops.squeeze_(x, [0]) is x and x.shape == (3, 1)
    assert tops.unsqueeze_(x, 0) is x and x.shape == (1, 3, 1)
    y = torch.tensor([0.5, -0.5])
    tops.tanh_(y)
    np.testing.assert_allclose(y.numpy(), np.tanh([0.5, -0.5]), rtol=1e-6)
    z = torch.tensor([5.0, 7.0])
    tops.remainder_(z, 3.0)
    assert z.tolist() == [2.0, 1.0]
    s = torch.zeros(3, 2)
    tops.scatter_(s, torch.tensor([2, 2]), torch.ones(2, 2) * 4)
    assert s[2].tolist() == [4.0, 4.0]
    ia = torch.zeros(3, 2)
    tops.index_add_(ia, torch.tensor([0, 0]), 0, torch.ones(2, 2))
    assert ia[0].tolist() == [2.0, 2.0]
    r = torch.arange(6.0)
    assert tops.reshape_(r, [2, 3]) is r and r.shape == (2, 3)


def test_tensor_core_functional_methods():
    from paddle_tpu_torch import tensor_core as tc

    x = torch.ones(2, 3, requires_grad=True)
    assert tc.astype(x, "float64").dtype == torch.float64
    assert tc.cast(x, "int32").dtype == torch.int32
    assert not tc.stop_gradient(x)
    tc.set_stop_gradient(x, True)
    assert tc.stop_gradient(x)
    y = torch.ones(3, requires_grad=True)
    (y * 2).sum().backward()
    tc.clear_grad(y)
    assert y.grad is None
    (y * 2).sum().backward()
    tc.clear_gradient(y, set_to_zero=True)
    assert y.grad is not None and not y.grad.any()
    z = torch.zeros(2, 2)
    tc.set_value(z, np.array([[1, 2], [3, 4]]))
    assert z.tolist() == [[1.0, 2.0], [3.0, 4.0]]
    with pytest.raises(ValueError):
        tc.set_value(z, np.zeros(3))
    assert tc.numel(z) == 4 and tc.place(z) == torch.device("cpu")
    for shape, kw in (((5, 3), dict(wrap=True)), ((5, 3), {}),
                      ((3, 4), dict(offset=1)), ((3, 3, 3), {})):
        a = np.zeros(shape, np.float32)
        ref = J.to_tensor(a)
        ref.fill_diagonal_(7.0, **kw)
        got = tc.fill_diagonal_(torch.tensor(a), 7.0, **kw)
        _close(ref, got, f"fill_diagonal_ {shape} {kw}")


def test_top_level_namespace_and_dtypes():
    x = T.to_tensor([[1.0, 2.0], [3.0, 4.0]])
    assert T.reshape(x, [0, -1]).shape == (2, 2)
    assert T.float32 is torch.float32 and T.bool is torch.bool and \
        T.int64 is torch.int64
    assert T.linalg.__name__ == "paddle_tpu_torch.linalg"
    assert T.linalg.cond is tops.cond_number and T.cond is tops.cond
    assert T.Tensor is torch.Tensor
    assert T.get_device() == "cpu"
    assert isinstance(T.float32, T.dtype)
    for name in ("to_tensor", "reshape", "matmul", "sum", "topk", "scan",
                 "add_n", "logcumsumexp", "cond", "while_loop"):
        assert getattr(T, name) is getattr(tops, name), name
    # every ported subpackage is bound at the top, as the reference's
    # are (test_top_level_namespace_binds_every_ported_subpackage)
    for sub in _SUBPACKAGES:
        assert getattr(T, sub.split(".")[0]).__name__.startswith(
            "paddle_tpu_torch.")
    # deployment at the top, as the reference binds it
    assert T.InputSpec is T.jit.InputSpec is T.static.InputSpec
    for name in ("to_static", "save", "load", "TranslatedLayer"):
        assert callable(getattr(T.jit, name)), name
    assert T.vision.ops.nms is T.vision.ops.__dict__["nms"]
    assert callable(T.enable_static) and callable(T.disable_static)
    assert T.in_dynamic_mode()
    old = T.get_default_dtype()
    T.set_default_dtype("float64")
    try:
        assert T.to_tensor([1.5]).dtype == torch.float64
        assert T.arange(0.0, 1.0, 0.5).dtype == torch.float64
    finally:
        T.set_default_dtype(old)


# the ported subpackages the top level binds, with the reference's
# module at the same path
_SUBPACKAGES = ["optimizer", "distributed", "distributed.fleet", "jit",
                "vision", "vision.models", "text", "inference", "incubate",
                "observability", "nn", "amp", "framework", "autograd",
                "quantization", "io", "metric", "profiler", "hapi",
                "vision.transforms", "vision.datasets", "static",
                "static.nn", "vision.ops"]


@pytest.mark.parametrize("sub", _SUBPACKAGES)
def test_top_level_namespace_binds_every_ported_subpackage(sub):
    """`import paddle_tpu_torch as paddle` reaches each ported subpackage
    (no jax imported, no CUDA library built or loaded), and each exports
    every name the reference's exports that the port defines in that
    subpackage's modules."""
    import importlib
    import subprocess
    import sys
    import types

    mod = T
    for part in sub.split("."):
        mod = getattr(mod, part)
    assert isinstance(mod, types.ModuleType) and \
        mod.__name__ == "paddle_tpu_torch." + sub
    ref = importlib.import_module("paddle_tpu." + sub)
    defined = set()
    for name, m in list(sys.modules.items()):
        if m is not None and (name == mod.__name__ or name.startswith(
                mod.__name__ + ".")):
            defined |= {n for n in vars(m) if not n.startswith("_")}
    ref_names = {n for n in dir(ref) if not n.startswith("_")
                 and not isinstance(getattr(ref, n), types.ModuleType)}
    unexported = sorted(n for n in ref_names & defined
                        if not hasattr(mod, n))
    assert not unexported, unexported
    if sub == "optimizer":
        code = ("import sys, paddle_tpu_torch as p; "
                "from paddle_tpu_torch.ops.cuda_kernels import _build; "
                "assert 'jax' not in sys.modules; "
                "assert not _build._libs; "
                "print(p.jit.HybridTrainStep.__name__, "
                "p.inference.SpeculativeDecoder.__name__, "
                "p.distributed.global_mesh.__name__, "
                "p.distributed.recompute.__name__, "
                "p.distributed.recompute_sequential.__name__, "
                "p.distributed.DataParallel(3), "
                "p.distributed.fleet.shard_params_and_opt.__name__, "
                "p.vision.resnet50.__name__, p.vision.LeNet.__name__, "
                "p.ParamAttr.__name__, p.DataParallel(4))")
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             capture_output=True, text=True, timeout=120,
                             env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert out.returncode == 0, out.stderr
        assert out.stdout.split() == [
            "HybridTrainStep", "SpeculativeDecoder", "global_mesh",
            "recompute", "recompute_sequential", "3",
            "shard_params_and_opt", "resnet50", "LeNet", "ParamAttr", "4"]


def test_unique_folds_nans_as_the_reference():
    """numpy's unique (the reference) sorts NaN last and folds every NaN
    into one value; all four outputs agree."""
    nan = np.nan
    for data in ([nan, nan], [nan, 1.0], [2.0, nan, 1.0, 2.0],
                 [nan, 3.0, nan, -1.0, 3.0, nan, 0.5]):
        a = np.array(data, np.float32)
        ref = J.unique(J.to_tensor(a), return_index=True,
                       return_inverse=True, return_counts=True)
        got = tops.unique(torch.from_numpy(a), return_index=True,
                          return_inverse=True, return_counts=True)
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r.numpy()))
        assert len(got) == 4
    u, c = tops.unique(torch.tensor([2.0, nan, 1.0, 2.0]),
                       return_counts=True)
    assert u[:2].tolist() == [1.0, 2.0] and bool(torch.isnan(u[2]))
    assert c.tolist() == [1, 2, 1]


@pytest.mark.parametrize("name", ["sign", "sgn"])
def test_sign_of_a_complex_tensor_is_x_over_its_modulus(name):
    """jnp.sign: x / |x|, 0 at 0; its gradient is zero, as jax defines
    it, for complex and real inputs alike."""
    for a in (np.array([1j, 3 + 4j, 0j, -2 - 2j], np.complex64),
              np.array([1j, 3 + 4j, 0j], np.complex128),
              np.array([-1.5, 0.0, 2.0], np.float32)):
        ref = getattr(J, name)(J.to_tensor(a))
        x = torch.from_numpy(a).requires_grad_()
        got = getattr(T, name)(x)
        assert got.dtype == x.dtype
        np.testing.assert_allclose(got.detach().numpy(),
                                   np.asarray(ref.numpy()), rtol=1e-6)
        jx = J.to_tensor(a, stop_gradient=False)
        (jg,) = J.grad(J.real(getattr(J, name)(jx)).sum()
                       if np.iscomplexobj(a) else getattr(J, name)(jx).sum(),
                       jx)
        (tg,) = T.grad(got.real.sum() if got.is_complex() else got.sum(), x)
        assert not np.any(np.asarray(jg.numpy())) and not tg.any()
    np.testing.assert_allclose(
        T.sign(torch.tensor([3 + 4j])).numpy(), [0.6 + 0.8j], rtol=1e-6)


def test_creation_defaults_to_cuda_and_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(tplace, "_current", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn, args in ((tops.zeros, ([2],)), (tops.to_tensor, ([1.0],)),
                     (tops.arange, (3,)), (tops.rand, ([2],))):
        with pytest.raises(RuntimeError, match="no"):
            fn(*args)
    # a tensor's own device is kept
    assert tops.zeros_like(torch.ones(2)).device.type == "cpu"


def test_amp_casts_ops_by_their_reference_names():
    from paddle_tpu_torch import amp

    x = torch.ones(2, 3, dtype=torch.bfloat16)
    w = torch.ones(3, 2)
    with amp.auto_cast(level="O1"):
        assert tops.sum(x).dtype == torch.float32          # black list
        assert tops.matmul(w, w.T).dtype == torch.bfloat16  # white list
        assert tops.reshape(x, [3, 2]).dtype == torch.bfloat16
        assert tops.reshape(w, [6]).dtype == torch.float32  # follows
    with amp.auto_cast(level="O2"):
        assert tops.reshape(w, [6]).dtype == torch.bfloat16


# ---- coverage ---------------------------------------------------------------

def _reference_names():
    import types

    names = set()
    for n in dir(jops):
        fn = getattr(jops, n)
        if n.startswith("_") or isinstance(fn, types.ModuleType) or \
                not callable(fn):
            continue
        if getattr(fn, "__module__", "").startswith("paddle_tpu.ops"):
            names.add(n)
    return names - NO_COUNTERPART


# names exercised by the named tests above rather than by CASES
NAMED = {"svd", "qr", "eigh", "eig", "eigvals", "lstsq", "lu_unpack",
         "svd_lowrank", "cond", "while_loop", "case", "switch_case", "scan",
         "rand", "randn", "normal", "uniform", "randint", "randperm",
         "bernoulli", "multinomial", "standard_normal", "poisson",
         "randint_like", "get_cuda_rng_state", "set_cuda_rng_state",
         "register_op", "get_op", "list_ops", "defop", "unary_op",
         "binary_op", "reduce_op", "iinfo", "is_tensor", "is_complex",
         "is_floating_point", "is_integer", "check_shape",
         "set_grad_enabled", "disable_signal_handler", "set_printoptions",
         "increment", "rsqrt_", "create_parameter", "squeeze_", "unsqueeze_",
         "tanh_", "scatter_", "remainder_", "index_add_"}


def test_every_reference_name_has_a_port_counterpart_and_a_case():
    ref = _reference_names()
    missing = sorted(n for n in ref if not hasattr(tops, n))
    assert not missing, missing
    missing = sorted(n for n in JL.__all__ if not hasattr(TL, n))
    assert not missing, missing
    assert list(TL.__all__) == list(JL.__all__)
    covered = {c.fn for c in CASES} | NAMED
    untested = sorted(n for n in ref | set(JL.__all__) if n not in covered
                      and not (n in ("cond",) and "cond_number" in covered))
    assert not untested, untested
    for n in JL.__all__:
        assert getattr(TL, n) is (tops.cond_number if n == "cond"
                                  else getattr(tops, n)), n
    # ops.activation: every name of the reference's module
    from paddle_tpu.ops import activation as ja
    from paddle_tpu_torch.ops import activation as ta

    act = {n for n in dir(ja) if not n.startswith("_")
           and callable(getattr(ja, n))
           and getattr(getattr(ja, n), "__module__", "").startswith(
               "paddle_tpu.ops")} - NO_COUNTERPART - {
        "apply_jfn", "defop", "unary_op"}
    missing = sorted(n for n in act if not hasattr(ta, n))
    assert not missing, missing
    assert act <= {c.fn for c in CASES if c.id in _MODULE_OF} | \
        {"gumbel_softmax", "rrelu"}


def _reference_tensor_methods():
    """The names the reference's `_install_tensor_methods` puts on its
    Tensor (paddle_tpu/ops/__init__.py:63-): the ops of its method
    modules that its Tensor class does not define itself, less its skip
    list and its helpers, then its explicit and in-place names and the
    operators."""
    from paddle_tpu.ops import (activation, api_misc, extras, linalg,
                                manipulation, math)

    src = open(os.path.join(ROOT, "paddle_tpu", "tensor_core.py")).read()
    cls = next(n for n in ast.parse(src).body
               if isinstance(n, ast.ClassDef) and n.name == "Tensor")
    own = {n.name for n in cls.body if isinstance(n, ast.FunctionDef)}
    skip = {"to_tensor", "meshgrid", "einsum", "iinfo", "set_printoptions",
            "create_parameter", "set_grad_enabled", "disable_signal_handler",
            "get_cuda_rng_state", "set_cuda_rng_state", "check_shape",
            "tril_indices", "triu_indices"}
    helpers = {"apply_jfn", "ensure_tensor", "value_of", "defop",
               "unary_op", "binary_op", "reduce_op", "register_op",
               "get_op", "list_ops"}
    names = set()
    for m in (math, manipulation, linalg, activation, extras, api_misc):
        for n in dir(m):
            fn = getattr(m, n)
            if n.startswith("_") or not callable(fn) or isinstance(fn, type):
                continue
            if not getattr(fn, "__module__", "").startswith(
                    "paddle_tpu.ops"):
                continue
            if n in skip or n in helpers or n in own:
                continue
            names.add(n)
    names |= {"mean", "sum", "max", "min", "prod", "abs", "matmul", "mm",
              "dot", "norm", "zero_like", "cond", "uniform_",
              "exponential_"}
    names |= {nm + "_" for nm in (
        "add", "subtract", "multiply", "scale", "clip", "floor", "ceil",
        "exp", "sqrt", "rsqrt", "reciprocal", "round", "tanh", "squeeze",
        "unsqueeze", "flatten", "scatter", "remainder", "index_add",
        "erfinv", "lerp", "put_along_axis")}
    names |= {"__add__", "__radd__", "__sub__", "__rsub__", "__mul__",
              "__rmul__", "__truediv__", "__rtruediv__", "__floordiv__",
              "__mod__", "__pow__", "__rpow__", "__neg__", "__abs__",
              "__matmul__", "__rmatmul__", "__eq__", "__ne__", "__lt__",
              "__le__", "__gt__", "__ge__", "__invert__", "__and__",
              "__or__", "__xor__"}
    names |= {"astype", "cast", "set_value", "fill_diagonal_", "clear_grad",
              "clear_gradient", "numel", "place"}
    return names


def test_every_reference_tensor_method_resolves_in_the_port_table():
    table = tops.TENSOR_METHODS
    missing = sorted(n for n in _reference_tensor_methods()
                     if n not in table)
    assert not missing, missing
    x = torch.tensor([[1.0, 4.0], [9.0, 16.0]])
    assert table["scale"](x, 2.0).tolist() == [[2.0, 8.0], [18.0, 32.0]]
    assert table["cond"] is tops.cond_number
    assert table["__rsub__"](x, 1.0).tolist() == [[0., -3.], [-8., -15.]]
    y = x.clone()
    assert table["sqrt_"](y) is y and y.tolist() == [[1., 2.], [3., 4.]]
    y = torch.ones(1, 2)
    assert table["squeeze_"](y) is y and y.shape == (2,)


def test_no_port_module_patches_torch_tensor():
    """No assignment to an attribute of torch.Tensor (or setattr on it)
    anywhere in the port."""
    bad = []
    for dirpath, _, files in os.walk(os.path.join(ROOT,
                                                  "paddle_tpu_torch")):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tree = ast.parse(open(path).read())
            for node in ast.walk(tree):
                targets = []
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                    targets = [node.target]
                for t in targets:
                    if isinstance(t, ast.Attribute) and \
                            ast.unparse(t.value) in ("torch.Tensor",
                                                     "Tensor", "_torch.Tensor"):
                        bad.append(f"{path}:{node.lineno}")
                if isinstance(node, ast.Call) and \
                        ast.unparse(node.func) == "setattr" and node.args \
                        and ast.unparse(node.args[0]) in (
                            "torch.Tensor", "Tensor"):
                    bad.append(f"{path}:{node.lineno}")
    assert not bad, bad
