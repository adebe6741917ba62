"""The layers the vision path stands on (paddle_tpu_torch/nn: conv,
pooling, normalization, activations, initializers, ParamAttr,
containers) against the JAX package's on the CPU, on the same numpy
inputs from `np.random.default_rng(seed)`.

Each functional case runs forward on both, then backward from the same
random probe of its output (loss = Σ out · probe) and compares every
float input's gradient. Tolerances, each with its reason:

* f32 outputs and gradients: 1e-5 of each tensor's max-abs — the
  frameworks sum windows and reductions in different orders;
* running statistics: 1e-6 (three momentum steps of one small tensor);
* the deterministic initializers (Constant, Assign, Dirac, Bilinear)
  exactly; the random ones by shape, bounds and moments: mean within
  4 σ/√n of the target, std within 2 % (n ≥ 40,000 draws).
"""
import math

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn import initializer as JI
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import export_state_dict, load_jax_state_dict
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn import initializer as TI
from paddle_tpu_torch.optimizer import SGD

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


TOL = 1e-5


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _randn(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _check(jfn, tfn, arrays, tol=TOL, seed=1):
    """Forward and every float input's gradient, reference vs port.
    Returns the port's outputs."""
    jin = [paddle.to_tensor(a, stop_gradient=not np.issubdtype(
        a.dtype, np.floating)) for a in arrays]
    tin = [torch.tensor(a, requires_grad=np.issubdtype(a.dtype, np.floating))
           for a in arrays]
    with jax.default_matmul_precision("highest"):
        jout = jfn(*jin)
    tout = tfn(*tin)
    jouts = jout if isinstance(jout, (tuple, list)) else (jout,)
    touts = tout if isinstance(tout, (tuple, list)) else (tout,)
    assert len(jouts) == len(touts)
    for j, t in zip(jouts, touts):
        jv = np.asarray(j.numpy())
        tv = t.detach().numpy()
        if np.issubdtype(jv.dtype, np.integer):
            np.testing.assert_array_equal(tv, jv)
        else:
            assert _rel(tv, jv) < tol
    probe = _randn(np.random.default_rng(seed), tuple(touts[0].shape))
    with jax.default_matmul_precision("highest"):
        (jouts[0] * paddle.to_tensor(probe)).sum().backward()
    (touts[0] * torch.from_numpy(probe)).sum().backward()
    for j, t in zip(jin, tin):
        if t.requires_grad:
            assert _rel(t.grad.numpy(), np.asarray(j.grad.numpy())) < tol
    return touts


# ---- convolutions ---------------------------------------------------------

CONV_CASES = {
    # name: (n, x shape, w shape, kwargs)
    "int_pad": (2, (2, 4, 9, 9), (6, 4, 3, 3), dict(padding=1)),
    "same_s2_odd": (2, (2, 4, 9, 9), (6, 4, 3, 3),
                    dict(padding="SAME", stride=2)),
    "same_s2_even": (2, (2, 4, 8, 8), (6, 4, 3, 3),
                     dict(padding="same", stride=2)),
    "same_s2_even_kernel": (2, (2, 4, 9, 10), (6, 4, 4, 4),
                            dict(padding="SAME", stride=2)),
    "valid_s2": (2, (2, 4, 9, 9), (6, 4, 3, 3),
                 dict(padding="VALID", stride=2)),
    "per_dim": (2, (2, 4, 9, 7), (6, 4, 3, 3), dict(padding=[1, 2])),
    "pairs": (2, (2, 4, 9, 7), (6, 4, 3, 3),
              dict(padding=[[1, 0], [2, 1]], stride=2)),
    "flat_pairs": (2, (2, 4, 9, 7), (6, 4, 3, 3),
                   dict(padding=[1, 0, 2, 1])),
    "full_spec": (2, (2, 4, 9, 7), (6, 4, 3, 3),
                  dict(padding=[[0, 0], [0, 0], [1, 0], [0, 2]])),
    "nhwc_full_spec": (2, (2, 9, 7, 4), (6, 4, 3, 3),
                       dict(padding=[[0, 0], [1, 0], [0, 2], [0, 0]],
                            data_format="NHWC")),
    "nhwc_same_s2": (2, (2, 9, 8, 4), (6, 4, 3, 3),
                     dict(padding="SAME", stride=2, data_format="NHWC")),
    "depthwise_dilated": (2, (2, 4, 11, 11), (8, 1, 3, 3),
                          dict(groups=4, dilation=2, padding=2)),
    "groups2_dilation": (2, (2, 4, 9, 9), (6, 2, 3, 3),
                         dict(groups=2, dilation=(2, 1), padding="SAME")),
    "no_bias": (2, (2, 4, 8, 8), (6, 4, 1, 1), dict(stride=2, bias=False)),
    "conv1d_same_s2": (1, (2, 4, 11), (6, 4, 3),
                       dict(padding="SAME", stride=2)),
    "conv1d_nlc": (1, (2, 11, 4), (6, 4, 3),
                   dict(padding=1, data_format="NLC")),
    "conv3d": (3, (1, 2, 5, 6, 5), (4, 2, 3, 3, 3),
               dict(padding="SAME", stride=2)),
    "conv3d_ndhwc": (3, (1, 5, 6, 5, 2), (4, 2, 3, 3, 3),
                     dict(padding=1, data_format="NDHWC")),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_matches_reference(case):
    n, xs, ws, kw = CONV_CASES[case]
    kw = dict(kw)
    rng = np.random.default_rng(3)
    arrays = [_randn(rng, xs), _randn(rng, ws)]
    if kw.pop("bias", True):
        arrays.append(_randn(rng, (ws[0],)))
    name = f"conv{n}d"
    _check(lambda *a: getattr(JF, name)(*a, **kw),
           lambda *a: getattr(TF, name)(*a, **kw), arrays)


CONV_T_CASES = {
    "s2_p1_opad1": (2, (2, 4, 5, 6), (4, 3, 3, 3),
                    dict(stride=2, padding=1, output_padding=1)),
    "groups2_opad": (2, (2, 4, 5, 5), (4, 2, 3, 3),
                     dict(stride=2, padding=1, output_padding=1, groups=2)),
    "pairs_opad": (2, (2, 4, 5, 6), (4, 3, 3, 3),
                   dict(stride=2, padding=[[1, 0], [0, 2]],
                        output_padding=1)),
    "opad_above_hi": (2, (2, 4, 5, 6), (4, 3, 3, 3),
                      dict(stride=3, padding=[[0, 1], [1, 0]],
                           output_padding=2)),
    "dilation2": (2, (2, 4, 5, 5), (4, 3, 3, 3),
                  dict(stride=2, padding=2, dilation=2, output_padding=1)),
    "nhwc_opad": (2, (2, 5, 6, 4), (4, 3, 3, 3),
                  dict(stride=2, padding=1, output_padding=1,
                       data_format="NHWC")),
    "conv1d_opad": (1, (2, 4, 7), (4, 3, 4),
                    dict(stride=3, padding=1, output_padding=2)),
    "conv3d_opad": (3, (1, 2, 3, 4, 3), (2, 3, 3, 3, 3),
                    dict(stride=2, padding=1, output_padding=1)),
}


@pytest.mark.parametrize("case", sorted(CONV_T_CASES))
def test_conv_transpose_matches_reference(case):
    n, xs, ws, kw = CONV_T_CASES[case]
    rng = np.random.default_rng(4)
    groups = kw.get("groups", 1)
    arrays = [_randn(rng, xs), _randn(rng, ws),
              _randn(rng, (ws[1] * groups,))]
    name = f"conv{n}d_transpose"
    _check(lambda *a: getattr(JF, name)(*a, **kw),
           lambda *a: getattr(TF, name)(*a, **kw), arrays)


def test_conv_transpose_refuses_string_padding():
    x, w = torch.zeros(1, 2, 4, 4), torch.zeros(2, 2, 3, 3)
    with pytest.raises(ValueError, match="SAME/VALID"):
        TF.conv2d_transpose(x, w, padding="SAME")


def test_same_padding_puts_the_odd_unit_high():
    """stride 2 over 8 with a 3-wide kernel: out 4, total padding 1, all
    of it on the high side (XLA), where a symmetric split would pad the
    low side."""
    x = torch.arange(8.0).reshape(1, 1, 8)
    w = torch.tensor([[[1.0, 0.0, 0.0]]])
    out = TF.conv1d(x, w, padding="SAME", stride=2)
    assert out.flatten().tolist() == [0.0, 2.0, 4.0, 6.0]


def test_conv_amp_o1_bias_promotes_to_f32():
    """conv2d is white-listed (bf16 under O1); its bias add is a separate
    op on no list, so bf16 + f32 gives f32 in both packages."""
    rng = np.random.default_rng(5)
    x, w, b = (_randn(rng, (1, 2, 5, 5)), _randn(rng, (3, 2, 3, 3)),
               _randn(rng, (3,)))
    with jamp.auto_cast(level="O1", dtype="bfloat16"):
        j = JF.conv2d(paddle.to_tensor(x), paddle.to_tensor(w),
                      paddle.to_tensor(b), padding=1)
        jn = JF.conv2d(paddle.to_tensor(x), paddle.to_tensor(w), padding=1)
    with tamp.auto_cast(level="O1", dtype="bfloat16"):
        t = TF.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(b), padding=1)
        tn = TF.conv2d(torch.from_numpy(x), torch.from_numpy(w), padding=1)
    assert str(j.dtype).endswith("float32") and t.dtype == torch.float32
    assert str(jn.dtype).endswith("bfloat16") and tn.dtype == torch.bfloat16
    assert _rel(t.numpy(), np.asarray(j.numpy())) < 1e-2


@pytest.mark.parametrize("cls,args,kw", [
    ("Conv1D", (4, 6, 3), dict(padding=1)),
    ("Conv2D", (4, 6, 3), dict(stride=2, padding="SAME", groups=2)),
    ("Conv3D", (2, 4, 3), dict(bias_attr=False)),
    ("Conv1DTranspose", (4, 6, 3), dict(stride=2, output_padding=1)),
    ("Conv2DTranspose", (4, 6, 3), dict(stride=2, padding=1, groups=2,
                                        output_padding=1)),
    ("Conv3DTranspose", (2, 4, 3), dict(stride=2)),
])
def test_conv_layers_match_reference(cls, args, kw):
    paddle.seed(0)
    jl = getattr(jnn, cls)(*args, **kw)
    tl = getattr(tnn, cls)(*args, **kw)
    w = {k: np.array(v.numpy()) for k, v in jl.state_dict().items()}
    assert {k: v.shape for k, v in w.items()} == {
        k: tuple(v.shape) for k, v in tl.state_dict().items()}
    load_jax_state_dict(tl, w)
    n = int(cls[4])
    shape = (2, args[0]) + (6,) * n
    x = _randn(np.random.default_rng(6), shape)
    with jax.default_matmul_precision("highest"):
        j = jl(paddle.to_tensor(x))
    t = tl(torch.from_numpy(x))
    assert _rel(t.detach().numpy(), np.asarray(j.numpy())) < TOL


# ---- pooling ----------------------------------------------------------------

POOL_CASES = {
    # name: (function, x shape, kwargs)
    "max2d_k3s2p1": ("max_pool2d", (2, 3, 9, 9),
                     dict(kernel_size=3, stride=2, padding=1)),
    "max2d_ceil": ("max_pool2d", (2, 3, 9, 8),
                   dict(kernel_size=2, stride=2, ceil_mode=True)),
    "max2d_same": ("max_pool2d", (2, 3, 9, 8),
                   dict(kernel_size=3, stride=2, padding="SAME")),
    "max2d_mask": ("max_pool2d", (2, 3, 9, 9),
                   dict(kernel_size=3, stride=2, padding=1,
                        return_mask=True)),
    "max2d_mask_ceil": ("max_pool2d", (2, 3, 9, 8),
                        dict(kernel_size=3, stride=2, padding=1,
                             ceil_mode=True, return_mask=True)),
    "max2d_nhwc": ("max_pool2d", (2, 9, 9, 3),
                   dict(kernel_size=3, stride=2, padding=1,
                        data_format="NHWC")),
    "max1d": ("max_pool1d", (2, 3, 11), dict(kernel_size=3, stride=2,
                                             padding=1, ceil_mode=True)),
    "max3d": ("max_pool3d", (1, 2, 5, 6, 5), dict(kernel_size=2, stride=2,
                                                  ceil_mode=True)),
    "avg2d_exclusive": ("avg_pool2d", (2, 3, 9, 9),
                        dict(kernel_size=3, stride=2, padding=1)),
    "avg2d_inclusive": ("avg_pool2d", (2, 3, 9, 9),
                        dict(kernel_size=3, stride=2, padding=1,
                             exclusive=False)),
    "avg2d_ceil_exclusive": ("avg_pool2d", (2, 3, 9, 8),
                             dict(kernel_size=3, stride=2, padding=1,
                                  ceil_mode=True)),
    "avg2d_ceil_inclusive": ("avg_pool2d", (2, 3, 9, 8),
                             dict(kernel_size=3, stride=2, padding=1,
                                  ceil_mode=True, exclusive=False)),
    "avg2d_same": ("avg_pool2d", (2, 3, 9, 8),
                   dict(kernel_size=3, stride=2, padding="SAME")),
    "avg2d_nhwc": ("avg_pool2d", (2, 9, 8, 3),
                   dict(kernel_size=2, stride=2, data_format="NHWC")),
    "avg1d": ("avg_pool1d", (2, 3, 11), dict(kernel_size=3, stride=2,
                                             padding=1, exclusive=False)),
    "avg3d": ("avg_pool3d", (1, 2, 5, 6, 5), dict(kernel_size=2, stride=2,
                                                  padding=1)),
    "adaptive_avg2d_uneven": ("adaptive_avg_pool2d", (2, 3, 7, 5),
                              dict(output_size=(3, 2))),
    "adaptive_avg2d_divisible": ("adaptive_avg_pool2d", (2, 3, 8, 6),
                                 dict(output_size=(4, 1))),
    "adaptive_avg2d_nhwc": ("adaptive_avg_pool2d", (2, 7, 5, 3),
                            dict(output_size=3, data_format="NHWC")),
    "adaptive_avg1d": ("adaptive_avg_pool1d", (2, 3, 10),
                       dict(output_size=4)),
    "adaptive_avg3d": ("adaptive_avg_pool3d", (1, 2, 5, 4, 6),
                       dict(output_size=(2, 3, 4))),
    "adaptive_max2d_uneven": ("adaptive_max_pool2d", (2, 3, 8, 7),
                              dict(output_size=3)),
    "adaptive_max1d": ("adaptive_max_pool1d", (2, 3, 10),
                       dict(output_size=3)),
    "adaptive_max3d": ("adaptive_max_pool3d", (1, 2, 5, 4, 6),
                       dict(output_size=2)),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool_matches_reference(case):
    fn, shape, kw = POOL_CASES[case]
    x = _randn(np.random.default_rng(7), shape)
    _check(lambda a: getattr(JF, fn)(a, **kw),
           lambda a: getattr(TF, fn)(a, **kw), [x])


@pytest.mark.parametrize("n,shape,kw", [
    (2, (2, 3, 8, 8), dict(kernel_size=2, stride=2)),
    (2, (2, 3, 9, 9), dict(kernel_size=3, stride=2, padding=1)),
    (1, (2, 3, 10), dict(kernel_size=2, stride=2)),
    (3, (1, 2, 4, 4, 4), dict(kernel_size=2, stride=2)),
])
def test_max_unpool_matches_reference(n, shape, kw):
    """max pooling with its mask, then the unpool back to the input's
    size: values at their argmax positions, zeros elsewhere."""
    x = _randn(np.random.default_rng(8), shape)
    pool, unpool = f"max_pool{n}d", f"max_unpool{n}d"

    def run(F, a):
        out, mask = getattr(F, pool)(a, return_mask=True, **kw)
        return getattr(F, unpool)(out, mask, output_size=shape[2:], **kw)

    _check(lambda a: run(JF, a), lambda a: run(TF, a), [x])


@pytest.mark.parametrize("cls,args,kw,shape", [
    ("MaxPool2D", (3,), dict(stride=2, padding=1), (2, 3, 9, 9)),
    ("MaxPool1D", (2,), dict(stride=2, ceil_mode=True), (2, 3, 9)),
    ("AvgPool2D", (3,), dict(stride=2, padding=1, exclusive=False),
     (2, 3, 9, 9)),
    ("AvgPool1D", (3,), dict(stride=2, padding=1), (2, 3, 9)),
    ("AvgPool3D", (2,), dict(stride=2), (1, 2, 4, 4, 4)),
    ("AdaptiveAvgPool2D", ((1, 1),), {}, (2, 3, 5, 5)),
    ("AdaptiveAvgPool1D", (3,), {}, (2, 3, 7)),
    ("AdaptiveMaxPool2D", (2,), {}, (2, 3, 5, 5)),
    ("MaxPool3D", (2,), dict(stride=2), (1, 2, 4, 4, 4)),
])
def test_pool_layers_match_reference(cls, args, kw, shape):
    x = _randn(np.random.default_rng(9), shape)
    j = getattr(jnn, cls)(*args, **kw)(paddle.to_tensor(x))
    t = getattr(tnn, cls)(*args, **kw)(torch.from_numpy(x))
    assert _rel(t.numpy(), np.asarray(j.numpy())) < TOL


# ---- normalization ----------------------------------------------------------

@pytest.mark.parametrize("shape,data_format", [
    ((4, 3, 5, 6), "NCHW"), ((4, 5, 6, 3), "NHWC"), ((6, 3), "NCHW"),
    ((4, 3, 7), "NCL"), ((2, 3, 3, 4, 5), "NCDHW")])
def test_batch_norm_training_and_running_statistics(shape, data_format):
    """Three training calls (output, running mean and biased variance,
    paddle's momentum 0.9), then eval reading the running statistics;
    gradients of the last training call."""
    rng = np.random.default_rng(10)
    c = shape[-1] if data_format == "NHWC" else shape[1]
    w, b = _randn(rng, (c,)), _randn(rng, (c,))
    jm, jv = paddle.to_tensor(np.zeros(c, np.float32)), paddle.to_tensor(
        np.ones(c, np.float32))
    tm, tv = torch.zeros(c), torch.ones(c)
    for i in range(3):
        x = _randn(rng, shape) * (i + 1) + i
        _check(lambda a, ww, bb: JF.batch_norm(a, jm, jv, ww, bb,
                                               training=True,
                                               data_format=data_format),
               lambda a, ww, bb: TF.batch_norm(a, tm, tv, ww, bb,
                                               training=True,
                                               data_format=data_format),
               [x, w, b], seed=i)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm.numpy()),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv.numpy()),
                                   rtol=0, atol=1e-6)
    x = _randn(rng, shape)
    _check(lambda a, ww, bb: JF.batch_norm(a, jm, jv, ww, bb,
                                           data_format=data_format),
           lambda a, ww, bb: TF.batch_norm(a, tm, tv, ww, bb,
                                           data_format=data_format),
           [x, w, b])


def test_batch_norm_rule_is_biased_paddle_momentum_not_torch_own():
    """The update torch's own batch_norm would make (unbiased variance,
    momentum 0.1 on the batch) differs from paddle's: the port takes
    paddle's."""
    x = torch.arange(8.0).reshape(4, 2)
    rm, rv = torch.zeros(2), torch.ones(2)
    TF.batch_norm(x, rm, rv, training=True)
    biased = x.var(dim=0, unbiased=False)
    torch.testing.assert_close(rv, 0.9 + 0.1 * biased)
    torch.testing.assert_close(rm, 0.1 * x.mean(dim=0))
    tm_, tv_ = torch.zeros(2), torch.ones(2)
    torch.nn.functional.batch_norm(x, tm_, tv_, training=True, momentum=0.1)
    assert not torch.allclose(tv_, rv)


def test_batch_norm_amp_o1_runs_f32():
    """batch_norm is black-listed: a bf16 input enters as f32 and the
    output is f32, in both packages; the statistics are f32."""
    rng = np.random.default_rng(11)
    x = _randn(rng, (4, 3, 5, 5))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    jx = paddle.to_tensor(x).astype("bfloat16")
    jm, jv = paddle.to_tensor(np.zeros(3, np.float32)), paddle.to_tensor(
        np.ones(3, np.float32))
    tm, tv = torch.zeros(3), torch.ones(3)
    with jamp.auto_cast(level="O1", dtype="bfloat16"):
        j = JF.batch_norm(jx, jm, jv, training=True)
    with tamp.auto_cast(level="O1", dtype="bfloat16"):
        t = TF.batch_norm(xb, tm, tv, training=True)
    assert str(j.dtype).endswith("float32") and t.dtype == torch.float32
    assert _rel(t.numpy(), np.asarray(j.numpy())) < TOL
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv.numpy()), atol=1e-6)
    # without AMP a bf16 input keeps its dtype; the statistics stay f32
    out = TF.batch_norm(xb, tm, tv, training=True)
    assert out.dtype == torch.bfloat16 and tv.dtype == torch.float32


@pytest.mark.parametrize("case", ["group_nchw", "group_nhwc", "instance",
                                  "lrn_nchw", "lrn_nhwc", "normalize_p2",
                                  "normalize_p1", "layer_norm"])
def test_norms_match_reference(case):
    rng = np.random.default_rng(12)
    if case.startswith("group"):
        fmt = "NHWC" if case.endswith("nhwc") else "NCHW"
        shape = (2, 5, 4, 6) if fmt == "NHWC" else (2, 6, 5, 4)
        arrays = [_randn(rng, shape), _randn(rng, (6,)), _randn(rng, (6,))]
        jf = lambda a, w, b: JF.group_norm(a, 3, 1e-5, w, b, fmt)  # noqa
        tf = lambda a, w, b: TF.group_norm(a, 3, 1e-5, w, b, fmt)  # noqa
    elif case == "instance":
        arrays = [_randn(rng, (2, 3, 5, 4)), _randn(rng, (3,)),
                  _randn(rng, (3,))]
        jf = lambda a, w, b: JF.instance_norm(a, weight=w, bias=b)  # noqa
        tf = lambda a, w, b: TF.instance_norm(a, weight=w, bias=b)  # noqa
    elif case.startswith("lrn"):
        fmt = "NHWC" if case.endswith("nhwc") else "NCHW"
        arrays = [_randn(rng, (2, 7, 4, 5))]
        jf = lambda a: JF.local_response_norm(a, 5, 1e-2, 0.75, 2.0,  # noqa
                                              fmt)
        tf = lambda a: TF.local_response_norm(a, 5, 1e-2, 0.75, 2.0,  # noqa
                                              fmt)
    elif case.startswith("normalize"):
        p = 2 if case.endswith("p2") else 1
        arrays = [_randn(rng, (3, 4, 5))]
        jf = lambda a: JF.normalize(a, p=p, axis=1)  # noqa
        tf = lambda a: TF.normalize(a, p=p, axis=1)  # noqa
    else:
        arrays = [_randn(rng, (3, 4, 6)), _randn(rng, (6,)),
                  _randn(rng, (6,))]
        jf = lambda a, w, b: JF.layer_norm(a, 6, w, b)  # noqa
        tf = lambda a, w, b: TF.layer_norm(a, 6, w, b)  # noqa
    _check(jf, tf, arrays)


@pytest.mark.parametrize("cls,args,kw,shape", [
    ("BatchNorm2D", (3,), {}, (4, 3, 5, 5)),
    ("BatchNorm1D", (3,), dict(momentum=0.8), (6, 3)),
    ("BatchNorm3D", (2,), {}, (2, 2, 3, 3, 3)),
    ("BatchNorm", (3,), dict(act="relu"), (4, 3, 5, 5)),
    ("BatchNorm2D", (3,), dict(use_global_stats=True), (4, 3, 5, 5)),
    ("BatchNorm2D", (3,), dict(weight_attr=False, bias_attr=False),
     (4, 3, 5, 5)),
    ("SyncBatchNorm", (3,), {}, (4, 3, 5, 5)),
    ("GroupNorm", (2, 4), {}, (2, 4, 3, 3)),
    ("InstanceNorm2D", (3,), {}, (2, 3, 4, 4)),
    ("InstanceNorm1D", (3,), dict(weight_attr=False), (2, 3, 6)),
    ("LocalResponseNorm", (3,), {}, (2, 5, 4, 4)),
    ("LayerNorm", (6,), {}, (2, 3, 6)),
])
def test_norm_layers_match_reference(cls, args, kw, shape):
    """Parameter and buffer names (`_mean` / `_variance`), a training
    call (buffers after it) and an eval call."""
    paddle.seed(0)
    jl = getattr(jnn, cls)(*args, **kw)
    tl = getattr(tnn, cls)(*args, **kw)
    w = {k: np.array(v.numpy()) for k, v in jl.state_dict().items()}
    assert sorted(w) == sorted(tl.state_dict())
    load_jax_state_dict(tl, w)
    rng = np.random.default_rng(13)
    for train in (True, False):
        x = _randn(rng, shape) + 0.5
        if not train:
            jl.eval()
            tl.eval()
        j = jl(paddle.to_tensor(x))
        t = tl(torch.from_numpy(x))
        assert _rel(t.detach().numpy(), np.asarray(j.numpy())) < TOL
        got = export_state_dict(tl)
        for k, v in jl.state_dict().items():
            np.testing.assert_allclose(got[k], np.asarray(v.numpy()),
                                       rtol=0, atol=1e-6, err_msg=k)


def test_spectral_norm_matches_reference():
    """weight / σ by one power iteration from the seeded u / v buffers,
    which both packages update per call."""
    rng = np.random.default_rng(14)
    w = _randn(rng, (6, 4, 3))
    jl, tl = jnn.SpectralNorm((6, 4, 3), dim=1), tnn.SpectralNorm((6, 4, 3),
                                                                  dim=1)
    for _ in range(2):
        _check(jl, tl, [w])
    np.testing.assert_allclose(tl.weight_u.numpy(),
                               np.asarray(jl.weight_u.numpy()), atol=1e-6)


def test_convert_sync_batchnorm_keeps_parameters_and_buffers():
    net = tnn.Sequential(tnn.Conv2D(2, 3, 3), tnn.BatchNorm2D(3))
    before = export_state_dict(net)
    sync = tnn.SyncBatchNorm.convert_sync_batchnorm(net)
    assert isinstance(sync[1], tnn.SyncBatchNorm)
    assert sync[1].weight is net[1].weight
    after = export_state_dict(sync)
    assert sorted(after) == sorted(before)
    for k in before:
        np.testing.assert_array_equal(after[k], before[k])


# ---- activations ------------------------------------------------------------

ACT_CASES = [
    ("relu", {}), ("relu6", {}), ("sigmoid", {}), ("silu", {}), ("swish", {}),
    ("tanh", {}), ("mish", {}), ("tanhshrink", {}), ("softsign", {}),
    ("log_sigmoid", {}), ("gelu", {}), ("gelu", dict(approximate=True)),
    ("leaky_relu", dict(negative_slope=0.2)), ("elu", dict(alpha=0.7)),
    ("selu", {}), ("selu", dict(scale=1.5, alpha=2.0)),
    ("celu", dict(alpha=1.3)), ("hardtanh", dict(min=-0.5, max=0.8)),
    ("hardsigmoid", {}), ("hardsigmoid", dict(slope=0.2, offset=0.4)),
    ("hardswish", {}), ("hardshrink", dict(threshold=0.4)),
    ("softshrink", dict(threshold=0.3)),
    ("thresholded_relu", dict(threshold=0.5)), ("softplus", {}),
    ("softplus", dict(beta=2.0, threshold=1.5)), ("softmax", dict(axis=1)),
    ("log_softmax", {}), ("maxout", dict(groups=2, axis=1)),
    ("glu", dict(axis=1)), ("rrelu", dict(training=False)),
]


@pytest.mark.parametrize("fn,kw", ACT_CASES,
                         ids=[f"{f}-{i}" for i, (f, _) in
                              enumerate(ACT_CASES)])
def test_activation_matches_reference(fn, kw):
    x = _randn(np.random.default_rng(15), (3, 4, 5)) * 3
    _check(lambda a: getattr(JF, fn)(a, **kw),
           lambda a: getattr(TF, fn)(a, **kw), [x])


@pytest.mark.parametrize("fmt,shape,n", [("NCHW", (2, 3, 4, 4), 3),
                                         ("NHWC", (2, 4, 4, 3), 3),
                                         ("NCHW", (2, 3, 4), 1)])
def test_prelu_matches_reference(fmt, shape, n):
    rng = np.random.default_rng(16)
    _check(lambda a, w: JF.prelu(a, w, fmt), lambda a, w: TF.prelu(a, w, fmt),
           [_randn(rng, shape), _randn(rng, (n,))])


def test_random_activations_draw_from_the_generator():
    """rrelu in training: each negative element scaled by a slope in
    [lower, upper], positives kept; gumbel_softmax rows sum to 1, and
    `hard` gives one-hot rows."""
    from paddle_tpu_torch.core import rng as trng

    x = -torch.rand(200, 50) - 0.1
    gen = torch.Generator().manual_seed(0)
    with trng.generator_scope(gen):
        y = TF.rrelu(x, 0.1, 0.3, training=True)
        g = TF.gumbel_softmax(torch.randn(5, 7), hard=False)
        h = TF.gumbel_softmax(torch.randn(5, 7), hard=True)
    r = y / x
    assert float(r.min()) >= 0.1 - 1e-6 and float(r.max()) <= 0.3 + 1e-6
    assert float(r.std()) > 0.03
    torch.testing.assert_close(TF.rrelu(-x, training=True), -x)
    torch.testing.assert_close(g.sum(dim=-1), torch.ones(5))
    assert set(h.unique().tolist()) == {0.0, 1.0}
    torch.testing.assert_close(h.sum(dim=-1), torch.ones(5))


def test_softmax_is_black_listed_under_amp():
    x = torch.randn(2, 5).to(torch.bfloat16)
    with tamp.auto_cast(level="O1", dtype="bfloat16"):
        assert TF.softmax(x).dtype == torch.float32
        assert TF.log_softmax(x).dtype == torch.float32
        assert TF.relu(x).dtype == torch.bfloat16
    with tamp.auto_cast(level="O2", dtype="bfloat16"):
        assert TF.sigmoid(x.float()).dtype == torch.bfloat16


ACT_LAYERS = [
    ("ReLU", (), {}), ("ReLU6", (), {}), ("Sigmoid", (), {}), ("Silu", (), {}),
    ("Swish", (), {}), ("Tanh", (), {}), ("Tanhshrink", (), {}),
    ("Softsign", (), {}), ("LogSigmoid", (), {}), ("Mish", (), {}),
    ("Hardswish", (), {}), ("Hardsigmoid", (), {}), ("ELU", (0.5,), {}),
    ("CELU", (), dict(alpha=2.0)), ("GELU", (True,), {}), ("GLU", (1,), {}),
    ("Hardshrink", (0.3,), {}), ("Hardtanh", (-0.3, 0.6), {}),
    ("LeakyReLU", (0.3,), {}), ("LogSoftmax", (1,), {}), ("Maxout", (2,), {}),
    ("SELU", (), {}), ("Softmax", (), dict(axis=1)),
    ("Softplus", (2.0, 3.0), {}), ("Softshrink", (0.2,), {}),
    ("ThresholdedReLU", (0.4,), {}), ("Softmax2D", (), {}), ("RReLU", (), {}),
    ("PReLU", (4,), dict(init=0.1)),
]


@pytest.mark.parametrize("cls,args,kw", ACT_LAYERS,
                         ids=[c for c, _, _ in ACT_LAYERS])
def test_activation_layers_match_reference(cls, args, kw):
    x = _randn(np.random.default_rng(17), (2, 4, 3, 5)) * 2
    jl, tl = getattr(jnn, cls)(*args, **kw), getattr(tnn, cls)(*args, **kw)
    if cls == "RReLU":
        jl.eval()
        tl.eval()
    assert sorted(jl.state_dict()) == sorted(tl.state_dict())
    load_jax_state_dict(tl, {k: np.array(v.numpy())
                             for k, v in jl.state_dict().items()})
    _check(jl, tl, [x])


# ---- initializers, ParamAttr, containers ------------------------------------

def _jinit(init, shape):
    return np.asarray(init._init(shape, "float32"))


def _tinit(init, shape):
    return init._init(shape, "float32").numpy()


@pytest.mark.parametrize("name,args,shape", [
    ("Constant", (0.7,), (3, 4)),
    ("Assign", (np.arange(12, dtype=np.float32).reshape(3, 4),), (3, 4)),
    ("Assign", (np.arange(12, dtype=np.float32),), (3, 4)),
    ("Dirac", (), (4, 4, 3, 3)),
    ("Dirac", (2,), (6, 2, 3)),
    ("Bilinear", (), (3, 2, 4, 4)),
    ("Bilinear", (), (2, 1, 3, 5)),
])
def test_deterministic_initializers_equal_reference(name, args, shape):
    np.testing.assert_array_equal(_tinit(getattr(TI, name)(*args), shape),
                                  _jinit(getattr(JI, name)(*args), shape))


@pytest.mark.parametrize("shape", [(5,), (7, 3), (8, 4, 3, 3), (6, 2, 5),
                                   (4, 3, 2, 2, 2)])
def test_fans_and_gains_equal_reference(shape):
    assert TI._fans(shape) == JI._fans(shape)
    for nl, p in [("relu", None), ("leaky_relu", 0.2), ("tanh", None),
                  ("selu", None), ("conv2d", None), ("leaky_relu", None)]:
        assert TI.calculate_gain(nl, p) == JI.calculate_gain(nl, p)


def _moments(init, shape, mean, std, low=None, high=None):
    from paddle_tpu_torch.core import rng as trng

    with trng.generator_scope(torch.Generator().manual_seed(1)):
        v = _tinit(init, shape).astype(np.float64)
    assert v.shape == shape
    n = v.size
    assert abs(v.mean() - mean) < 4 * std / math.sqrt(n) + 1e-12
    assert abs(v.std() - std) < 0.02 * std
    if low is not None:
        assert v.min() >= low and v.max() <= high


@pytest.mark.parametrize("case", ["normal", "truncated", "uniform",
                                  "xavier_normal", "xavier_uniform",
                                  "xavier_fans", "kaiming_normal",
                                  "kaiming_uniform", "kaiming_leaky"])
def test_random_initializers_shape_fans_and_moments(case):
    conv = (64, 32, 5, 5)                 # fan_in 800, fan_out 1600
    fi, fo = 32 * 25, 64 * 25
    if case == "normal":
        _moments(TI.Normal(1.0, 2.0), (200, 300), 1.0, 2.0)
    elif case == "truncated":
        # a standard normal cut to [-2, 2] has std 0.8796
        _moments(TI.TruncatedNormal(0.5, 2.0), (200, 300), 0.5,
                 2.0 * 0.879626, -3.5, 4.5)
    elif case == "uniform":
        _moments(TI.Uniform(-2.0, 4.0), (200, 300), 1.0, 6 / math.sqrt(12),
                 -2.0, 4.0)
    elif case == "xavier_normal":
        _moments(TI.XavierNormal(), conv, 0.0, math.sqrt(2 / (fi + fo)))
    elif case == "xavier_uniform":
        lim = math.sqrt(6 / (fi + fo))
        _moments(TI.XavierUniform(), conv, 0.0, lim / math.sqrt(3), -lim,
                 lim)
    elif case == "xavier_fans":
        lim = 2.0 * math.sqrt(6 / (10 + 30))
        _moments(TI.XavierUniform(fan_in=10, fan_out=30, gain=2.0),
                 (300, 200), 0.0, lim / math.sqrt(3), -lim, lim)
    elif case == "kaiming_normal":
        _moments(TI.KaimingNormal(), conv, 0.0, math.sqrt(2.0) / math.sqrt(fi))
    elif case == "kaiming_uniform":
        lim = math.sqrt(2.0) * math.sqrt(3.0 / fi)
        _moments(TI.KaimingUniform(), conv, 0.0, lim / math.sqrt(3), -lim,
                 lim)
    else:
        gain = math.sqrt(2.0 / (1 + 0.3 ** 2))
        _moments(TI.KaimingNormal(negative_slope=0.3,
                                  nonlinearity="leaky_relu"),
                 conv, 0.0, gain / math.sqrt(fi))


@pytest.mark.parametrize("shape", [(4, 9), (9, 4), (3, 2, 2)])
def test_orthogonal_initializer_is_orthogonal(shape):
    v = _tinit(TI.Orthogonal(gain=1.5), shape).reshape(shape[0], -1)
    small = v @ v.T if shape[0] <= v.shape[1] else v.T @ v
    np.testing.assert_allclose(small, 2.25 * np.eye(small.shape[0]),
                               atol=1e-5)


def test_initializer_call_refills_a_parameter_and_seeds_reproduce():
    from paddle_tpu_torch.core import rng as trng

    p = torch.nn.Parameter(torch.zeros(3, 4))
    TI.Constant(2.0)(p)
    assert float(p.sum()) == 24.0
    trng.seed(3)
    a = tnn.Conv2D(3, 4, 3).weight.detach().clone()
    trng.seed(3)
    b = tnn.Conv2D(3, 4, 3).weight.detach().clone()
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_param_attr_false_trainable_and_attributes():
    """`bias_attr=False` gives no bias (reference: the same keys);
    `trainable=False` keeps a parameter out of the train step's update;
    `learning_rate`, `regularizer` and `need_clip` land where the
    optimizers read them; an initializer passed as the attribute is
    used."""
    from paddle_tpu_torch.jit import TrainStep

    paddle.seed(0)
    jl = jnn.Linear(4, 3, bias_attr=False)
    tl = tnn.Linear(4, 3, bias_attr=False)
    assert sorted(jl.state_dict()) == sorted(tl.state_dict()) == ["weight"]
    assert tnn.Conv2D(2, 3, 3, bias_attr=False).bias is None
    reg = object()
    attr = tnn.ParamAttr(name="frozen_w", initializer=TI.Constant(0.5),
                         learning_rate=0.25, regularizer=reg,
                         trainable=False, need_clip=False)
    lin = tnn.Linear(4, 3, weight_attr=attr,
                     bias_attr=TI.Constant(1.0))
    w = lin.weight
    assert not w.requires_grad
    assert w.optimize_attr == {"learning_rate": 0.25}
    assert w.regularizer is reg and w.need_clip is False
    assert float(w.sum()) == 6.0 and float(lin.bias.sum()) == 3.0
    before = w.detach().clone()
    step = TrainStep(lin, lambda m, x: m(x).sum(),
                     SGD(0.1, parameters=[p for p in lin.parameters()
                                          if p.requires_grad]))
    step(torch.ones(2, 4))
    torch.testing.assert_close(w.detach(), before, rtol=0, atol=0)
    assert float(lin.bias.sum()) != 3.0
    half = tnn.Linear(4, 3, weight_attr=tnn.ParamAttr(learning_rate=0.5))
    assert half.weight.optimize_attr["learning_rate"] == 0.5


def test_defaults_follow_the_reference():
    """Linear / Conv: XavierUniform weights within the reference's limit
    and zero biases; BatchNorm ones / zeros with zero / one statistics;
    PReLU its init; Embedding N(0, 1)."""
    lin = tnn.Linear(40, 60)
    lim = math.sqrt(6 / 100)
    assert float(lin.weight.abs().max()) <= lim and float(
        lin.bias.abs().sum()) == 0.0
    conv = tnn.Conv2D(8, 16, 3)
    lim = math.sqrt(6 / (8 * 9 + 16 * 9))
    assert float(conv.weight.abs().max()) <= lim
    bn = tnn.BatchNorm2D(5)
    assert bn.weight.tolist() == [1.0] * 5 and bn.bias.tolist() == [0.0] * 5
    assert bn._mean.tolist() == [0.0] * 5 and bn._variance.tolist() == [
        1.0] * 5
    assert tnn.PReLU(init=0.3).weight.tolist() == pytest.approx([0.3])
    emb = tnn.Embedding(400, 100).weight
    assert abs(float(emb.std()) - 1.0) < 0.02


def test_containers_name_sublayers_as_the_reference():
    paddle.seed(0)
    jnet = jnn.LayerList([jnn.Linear(2, 3), jnn.Linear(3, 2)])
    jnet.append(jnn.Linear(2, 2))
    jd = jnn.LayerDict({"a": jnn.Linear(2, 2), "b": jnn.Conv2D(2, 2, 1)})
    tnet = tnn.LayerList([tnn.Linear(2, 3), tnn.Linear(3, 2)])
    tnet.append(tnn.Linear(2, 2))
    td = tnn.LayerDict({"a": tnn.Linear(2, 2), "b": tnn.Conv2D(2, 2, 1)})
    assert sorted(jnet.state_dict()) == sorted(tnet.state_dict())
    assert sorted(jd.state_dict()) == sorted(td.state_dict())
    assert len(tnet) == 3 and isinstance(tnet[1:], tnn.LayerList)
    assert "b" in td and list(td.keys()) == ["a", "b"]
    ps = tnn.ParameterList([torch.nn.Parameter(torch.zeros(2)),
                            torch.nn.Parameter(torch.ones(3))])
    jps = jnn.ParameterList([paddle.create_parameter([2], "float32"),
                             paddle.create_parameter([3], "float32")])
    assert sorted(ps.state_dict()) == sorted(jps.state_dict())
    seq = tnn.Sequential(tnn.Conv2D(1, 2, 3), tnn.ReLU())
    assert isinstance(seq[0], tnn.Conv2D) and len(seq[:1]) == 1
