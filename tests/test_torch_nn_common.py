"""The rest of the port's nn — functional / layer common, every loss and
cross-entropy mode, the functional extras, nn.utils and nn.quant —
against the JAX package's on the CPU, on the same numpy inputs from
`np.random.default_rng(seed)`.

Each case runs forward on both, then takes every float input's
gradient of Σ out · probe (one random probe) through `paddle_tpu.grad`
and the port's `grad`. Tolerances: 1e-6 of each tensor's max-abs in f32
and 1e-12 in f64 (x64 is on in tests/conftest.py); integer outputs and
dtypes exact. A random draw (dropout masks, class sampling, power
iteration's start) differs between the packages; those cases hold the
rules instead.
"""
import importlib

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import load_jax_state_dict
from paddle_tpu_torch.core import rng as trng
from paddle_tpu_torch.nn import functional as TF

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
    scale = max(np.abs(want).max(), 1e-30) if want.size else 1.0
    return float(np.abs(got - want).max() / scale) if got.size else 0.0


def _tol(dtype):
    return 1e-12 if dtype == np.float64 else 1e-6


def _t(a):
    return torch.tensor(a, requires_grad=np.issubdtype(a.dtype, np.floating))


def _j(a):
    return paddle.to_tensor(a, stop_gradient=not np.issubdtype(
        a.dtype, np.floating))


def _out_list(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _check(jfn, tfn, arrays, tol=None, grads=True, seed=7):
    """Outputs and every float input's gradient, reference vs port."""
    dtype = next((a.dtype for a in arrays
                  if np.issubdtype(a.dtype, np.floating)), np.float32)
    tol = tol or _tol(dtype)
    jin, tin = [_j(a) for a in arrays], [_t(a) for a in arrays]
    with jax.default_matmul_precision("highest"):
        jouts = _out_list(jfn(*jin))
    touts = _out_list(tfn(*tin))
    assert len(jouts) == len(touts)
    for j, t in zip(jouts, touts):
        jv, tv = np.asarray(j.numpy()), t.detach().numpy()
        assert str(tv.dtype) == str(jv.dtype), (tv.dtype, jv.dtype)
        if np.issubdtype(jv.dtype, np.floating):
            assert _rel(tv, jv) < tol, _rel(tv, jv)
        else:
            np.testing.assert_array_equal(tv, jv)
    if not grads:
        return touts
    fl = [i for i, a in enumerate(arrays)
          if np.issubdtype(a.dtype, np.floating)]
    probe = np.random.default_rng(seed).standard_normal(
        tuple(touts[0].shape)).astype(np.asarray(jouts[0].numpy()).dtype)
    with jax.default_matmul_precision("highest"):
        jg = paddle.grad((jouts[0] * paddle.to_tensor(probe)).sum(),
                         [jin[i] for i in fl], allow_unused=True)
    tg = tpaddle.grad((touts[0] * torch.from_numpy(probe)).sum(),
                      [tin[i] for i in fl], allow_unused=True)
    for i, a, b in zip(fl, tg, jg):
        # no gradient reaches an input that only selects (a label, a
        # rounded grid): None on one side, zeros or None on the other
        if a is None or b is None:
            assert not np.any((a if b is None else b).numpy() if (
                a is not None or b is not None) else 0), i
            continue
        assert _rel(a.numpy(), np.asarray(b.numpy())) < tol, (
            i, _rel(a.numpy(), np.asarray(b.numpy())))
    return touts


def _rn(seed, *shape, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _ints(seed, hi, *shape):
    return np.random.default_rng(seed).integers(0, hi, shape).astype(
        np.int64)


def _unit(seed, *shape, dtype=np.float64):
    return np.random.default_rng(seed).uniform(0.05, 0.95, shape).astype(
        dtype)


# ---- functional common ----

COMMON = [
    ("linear", lambda F: lambda x, w, b: F.linear(x, w, b),
     lambda: [_rn(0, 3, 4), _rn(1, 4, 5), _rn(2, 5)]),
    ("embedding padding_idx", lambda F: lambda i, w: F.embedding(
        i, w, padding_idx=2), lambda: [_ints(0, 6, 3, 4), _rn(1, 6, 5)]),
    # x64 (tests/conftest.py) widens jax.nn.one_hot's default float; the
    # reference yields float32 without it, as the port does
    ("one_hot", lambda F: (lambda i: F.one_hot(i, 7).astype("float32"))
     if F is JF else (lambda i: F.one_hot(i, 7)),
     lambda: [_ints(3, 7, 4, 3)]),
    ("pad reflect", lambda F: lambda x: F.pad(x, [1, 2, 2, 1],
                                              mode="reflect"),
     lambda: [_rn(0, 2, 3, 5, 6)]),
    ("pad constant NHWC", lambda F: lambda x: F.pad(
        x, [1, 0, 2, 1], value=1.5, data_format="NHWC"),
     lambda: [_rn(0, 2, 5, 6, 3)]),
    ("unfold", lambda F: lambda x: F.unfold(x, [2, 3], strides=[1, 2],
                                            paddings=1, dilations=[2, 1]),
     lambda: [_rn(0, 2, 3, 7, 8)]),
    ("fold", lambda F: lambda x: F.fold(x, [5, 6], 2, strides=1,
                                        paddings=1),
     lambda: [_rn(0, 2, 12, 42)]),
    ("pixel_shuffle", lambda F: lambda x: F.pixel_shuffle(x, 2),
     lambda: [_rn(0, 2, 8, 3, 4)]),
    ("pixel_shuffle NHWC", lambda F: lambda x: F.pixel_shuffle(
        x, 2, data_format="NHWC"), lambda: [_rn(0, 2, 3, 4, 8)]),
    ("pixel_unshuffle", lambda F: lambda x: F.pixel_unshuffle(x, 2),
     lambda: [_rn(0, 2, 3, 4, 6)]),
    ("channel_shuffle", lambda F: lambda x: F.channel_shuffle(x, 3),
     lambda: [_rn(0, 2, 6, 3, 4)]),
    ("label_smooth", lambda F: lambda y: F.label_smooth(y, epsilon=0.2),
     lambda: [_unit(0, 4, 6)]),
    ("label_smooth prior", lambda F: lambda y, p: F.label_smooth(
        y, p, epsilon=0.1), lambda: [_unit(0, 4, 6), _unit(1, 1, 6)]),
    ("cosine_similarity", lambda F: lambda a, b: F.cosine_similarity(
        a, b, axis=-1), lambda: [_rn(0, 5, 7), _rn(1, 5, 7)]),
    ("pairwise_distance p2", lambda F: lambda a, b: F.pairwise_distance(
        a, b, keepdim=True), lambda: [_rn(0, 5, 7), _rn(1, 5, 7)]),
    ("pairwise_distance p1", lambda F: lambda a, b: F.pairwise_distance(
        a, b, p=1.0), lambda: [_rn(0, 5, 7), _rn(1, 5, 7)]),
    ("pairwise_distance inf", lambda F: lambda a, b: F.pairwise_distance(
        a, b, p=float("inf")), lambda: [_rn(0, 5, 7), _rn(1, 5, 7)]),
    ("bilinear", lambda F: lambda a, b, w, c: F.bilinear(a, b, w, c),
     lambda: [_rn(0, 4, 3), _rn(1, 4, 5), _rn(2, 6, 3, 5), _rn(3, 1, 6)]),
    ("affine_grid", lambda F: lambda th: F.affine_grid(th, [2, 3, 4, 5]),
     lambda: [_rn(0, 2, 2, 3)]),
    ("affine_grid half", lambda F: lambda th: F.affine_grid(
        th, [2, 3, 4, 5], align_corners=False), lambda: [_rn(0, 2, 2, 3)]),
    ("grid_sample zeros", lambda F: lambda x, g: F.grid_sample(x, g),
     lambda: [_rn(0, 2, 3, 5, 6), _rn(1, 2, 4, 3, 2) * 0.8]),
    ("grid_sample border half", lambda F: lambda x, g: F.grid_sample(
        x, g, padding_mode="border", align_corners=False),
     lambda: [_rn(0, 2, 3, 5, 6), _rn(1, 2, 4, 3, 2) * 1.2]),
    ("grid_sample nearest", lambda F: lambda x, g: F.grid_sample(
        x, g, mode="nearest"),
     lambda: [_rn(0, 2, 3, 5, 6), _rn(1, 2, 4, 3, 2) * 0.9]),
]

# interpolate: the reference's own rules (module docstring of the
# port's common.py), float64 and float32
RESIZE = [
    ("nearest up 5->7", dict(size=[7, 9], mode="nearest"), (2, 3, 5, 6)),
    ("nearest down 7->3", dict(size=[3, 4], mode="nearest"), (2, 3, 7, 9)),
    ("nearest scale", dict(scale_factor=1.7, mode="nearest"),
     (1, 2, 5, 6)),
    ("bilinear up", dict(size=[9, 11], mode="bilinear"), (2, 3, 5, 6)),
    ("bilinear down (antialiased)", dict(size=[3, 4], mode="bilinear"),
     (2, 3, 8, 9)),
    ("bicubic up", dict(size=[9, 7], mode="bicubic"), (2, 3, 5, 6)),
    ("bicubic down (antialiased)", dict(size=[3, 2], mode="bicubic"),
     (2, 3, 8, 7)),
    ("bilinear align_corners", dict(size=[7, 3], mode="bilinear",
                                    align_corners=True), (2, 3, 5, 6)),
    ("bicubic align_corners", dict(size=[4, 9], mode="bicubic",
                                   align_corners=True), (2, 3, 5, 6)),
    ("linear 1D", dict(size=[11], mode="linear", data_format="NCW"),
     (2, 3, 6)),
    ("trilinear down", dict(size=[2, 5, 3], mode="trilinear",
                            data_format="NCDHW"), (1, 2, 5, 6, 7)),
    ("bilinear NHWC", dict(scale_factor=[1.5, 0.5], mode="bilinear",
                           data_format="NHWC"), (2, 6, 8, 3)),
    ("area divisible", dict(size=[3, 2], mode="area"), (2, 3, 6, 8)),
    ("area ragged", dict(size=[4, 5], mode="area"), (2, 3, 6, 8)),
]


@pytest.mark.parametrize("label,fn,build", COMMON,
                         ids=[c[0] for c in COMMON])
def test_common_functionals_match_the_reference(label, fn, build):
    _check(fn(JF), fn(TF), build())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("label,kw,shape", RESIZE,
                         ids=[c[0] for c in RESIZE])
def test_interpolate_takes_the_reference_s_rules(label, kw, shape, dtype):
    _check(lambda x: JF.interpolate(x, **kw),
           lambda x: TF.interpolate(x, **kw), [_rn(3, *shape, dtype=dtype)])


def test_interpolate_traps_differ_from_torch_s_defaults():
    """Shrinking, the reference (jax.image.resize) antialiases and
    torch's F.interpolate does not; its cubic is Keys' a = -0.5 where
    torch's is -0.75. The port is the reference's on both."""
    x = torch.from_numpy(_rn(4, 1, 2, 8, 8))
    for mode, size in (("bilinear", [3, 3]), ("bicubic", [12, 12])):
        ref = JF.interpolate(paddle.to_tensor(x.numpy()), size=size,
                             mode=mode).numpy()
        got = TF.interpolate(x, size=size, mode=mode).numpy()
        lib = torch.nn.functional.interpolate(x, size=size, mode=mode,
                                              align_corners=False).numpy()
        assert _rel(got, ref) < 1e-12 and _rel(lib, ref) > 1e-3, mode


def test_dropout_rules():
    x = torch.from_numpy(_rn(0, 64, 32))
    jx = paddle.to_tensor(x.numpy())
    for p in (0.0, 0.3, 1.0):
        for training in (False, True):
            if training and 0 < p < 1:
                continue
            for mode in ("upscale_in_train", "downscale_in_infer"):
                got = TF.dropout(x, p, training=training, mode=mode)
                ref = JF.dropout(jx, p, training=training, mode=mode)
                assert _rel(got.numpy(), ref.numpy()) < 1e-12, (p, mode)
    # in training the kept values scale by 1 / (1 - p), from the port's
    # generators: one seeded generator gives one mask
    for mode, scale in (("upscale_in_train", 1 / 0.75),
                        ("downscale_in_infer", 1.0)):
        with trng.generator_scope(torch.Generator().manual_seed(5)):
            a = TF.dropout(x, 0.25, mode=mode)
        with trng.generator_scope(torch.Generator().manual_seed(5)):
            b = TF.dropout(x, 0.25, mode=mode)
        assert torch.equal(a, b)
        kept = a != 0
        assert torch.allclose(a[kept], x[kept] * scale)
        assert 0.6 < kept.float().mean() < 0.9
    # axis: one draw per index of the axis, shared along the rest
    a = TF.dropout(x, 0.5, axis=1)
    assert torch.equal(a[0] != 0, a[5] != 0)
    d2 = TF.dropout2d(torch.ones(4, 6, 3, 3), 0.5)
    assert torch.equal(d2.amax((2, 3)), d2.amin((2, 3)))
    d3 = TF.dropout3d(torch.ones(2, 5, 2, 3, 3), 0.5, data_format="NDHWC")
    assert torch.equal(d3.amax((1, 2, 3)), d3.amin((1, 2, 3)))
    # alpha dropout: dropped entries go to a·α' + b, kept ones a·x + b
    y = TF.alpha_dropout(x, 0.2)
    a_ = 1.0 / np.sqrt(0.8 * (1 + 0.2 * (1.6732632423543772 *
                                         1.0507009873554805) ** 2))
    b_ = -a_ * (-1.6732632423543772 * 1.0507009873554805) * 0.2
    dropped = torch.isclose(y, torch.full_like(
        y, a_ * -1.6732632423543772 * 1.0507009873554805 + b_))
    assert torch.allclose(y[~dropped], a_ * x[~dropped] + b_)
    assert torch.equal(TF.alpha_dropout(x, 0.2, training=False), x)
    lay = tnn.Dropout(0.5, mode="downscale_in_infer").eval()
    assert torch.allclose(lay(x), x * 0.5)


def test_common_layers_match_the_reference():
    rs = np.random.default_rng(9)
    x4 = rs.standard_normal((2, 8, 6, 6)).astype(np.float32)
    cases = [
        ("Identity", (3, 4), {}, [x4]),
        ("Flatten", (), dict(start_axis=1, stop_axis=2), [x4]),
        ("Pad1D", (2,), dict(mode="replicate"), [x4[:, :, 0]]),
        ("Pad2D", ([1, 0, 2, 1],), dict(mode="circular"), [x4]),
        ("ZeroPad2D", (1,), {}, [x4]),
        ("Pad3D", (1,), {}, [x4[None]]),
        ("Upsample", (), dict(size=[9, 4], mode="bilinear"), [x4]),
        ("UpsamplingNearest2D", (), dict(scale_factor=2), [x4]),
        ("UpsamplingBilinear2D", (), dict(size=[7, 5]), [x4]),
        ("CosineSimilarity", (), dict(axis=1), [x4, x4[::-1].copy()]),
        ("PairwiseDistance", (), dict(p=3.0), [x4[:, 0], x4[:, 1]]),
        ("Unfold", ([2, 2],), dict(strides=2), [x4]),
        ("Fold", ([4, 4], 2), {}, [x4.reshape(2, 8, 36)[:, :, :9]]),
        ("PixelShuffle", (2,), {}, [x4]),
        ("PixelUnshuffle", (2,), {}, [x4]),
        ("ChannelShuffle", (4,), {}, [x4]),
    ]
    for name, args, kw, arrays in cases:
        jl, tl = getattr(jnn, name)(*args, **kw), getattr(tnn, name)(
            *args, **kw)
        _check(jl, tl, [np.ascontiguousarray(a) for a in arrays])
    for name, args, arrays in (
            ("Bilinear", (3, 4, 5), [_rn(0, 6, 3, dtype=np.float32),
                                     _rn(1, 6, 4, dtype=np.float32)]),
            ("Embedding", (7, 4), [_ints(2, 7, 3, 5)])):
        jl = getattr(jnn, name)(*args)
        tl = getattr(tnn, name)(*args)
        load_jax_state_dict(tl, {k: np.asarray(v.numpy())
                                 for k, v in jl.state_dict().items()})
        _check(jl, tl, arrays)
    emb = tnn.Embedding(5, 3, padding_idx=1)
    assert not emb.weight[1].any() and not emb(torch.tensor([1])).any()


# ---- losses ----

def _soft(seed, *shape):
    p = np.random.default_rng(seed).uniform(0.1, 1.0, shape)
    return p / p.sum(-1, keepdims=True)


def _labels_with_ignored(seed, hi, *shape):
    y = _ints(seed, hi, *shape)
    y.reshape(-1)[::4] = -100
    return y


CE_CASES = [
    ("hard mean", dict(), lambda: [_rn(0, 6, 5), _ints(1, 5, 6)]),
    ("hard ignore weight", dict(reduction="mean"),
     lambda: [_rn(0, 6, 5), _labels_with_ignored(1, 5, 6), _unit(2, 5)]),
    ("hard keepdim label sum", dict(reduction="sum"),
     lambda: [_rn(0, 6, 5), _ints(1, 5, 6, 1)]),
    ("soft mean", dict(soft_label=True), lambda: [_rn(0, 6, 5), _soft(1, 6,
                                                                      5)]),
    ("soft none", dict(soft_label=True, reduction="none"),
     lambda: [_rn(0, 3, 4, 5), _soft(1, 3, 4, 5)]),
    ("soft weight mean", dict(soft_label=True),
     lambda: [_rn(0, 6, 5), _soft(1, 6, 5), _unit(2, 5)]),
    ("soft weight sum", dict(soft_label=True, reduction="sum"),
     lambda: [_rn(0, 6, 5), _soft(1, 6, 5), _unit(2, 5)]),
    ("probabilities", dict(use_softmax=False),
     lambda: [_soft(0, 6, 5), _ints(1, 5, 6)]),
    ("probabilities soft", dict(use_softmax=False, soft_label=True,
                                reduction="none"),
     lambda: [_soft(0, 6, 5), _soft(1, 6, 5)]),
    ("axis 1 hard", dict(axis=1), lambda: [_rn(0, 4, 5, 3),
                                           _ints(1, 5, 4, 3)]),
    ("axis 1 ignore weight none", dict(axis=1, reduction="none"),
     lambda: [_rn(0, 4, 5, 3), _labels_with_ignored(1, 5, 4, 1, 3),
              _unit(2, 5)]),
    ("axis 0 soft weight", dict(axis=0, soft_label=True),
     lambda: [_rn(0, 5, 4), _soft(1, 4, 5).T.copy(), _unit(2, 5)]),
]


@pytest.mark.parametrize("label,kw,build", CE_CASES,
                         ids=[c[0] for c in CE_CASES])
def test_cross_entropy_modes_match_the_reference(label, kw, build):
    def fn(F):
        def call(x, y, *w):
            return F.cross_entropy(x, y, weight=w[0] if w else None, **kw)
        return call

    arrays = build()
    # the reference computes the log-softmax in float32
    _check(fn(JF), fn(TF), arrays, tol=1e-6)
    _check(fn(JF), fn(TF), [a.astype(np.float32) if a.dtype == np.float64
                            else a for a in arrays])


@pytest.mark.parametrize("kw", [dict(), dict(soft_label=True),
                                dict(axis=1, return_softmax=True)])
def test_softmax_with_cross_entropy_matches_the_reference(kw):
    x = _rn(0, 4, 5, 3, dtype=np.float32)
    if kw.get("soft_label"):
        y = _soft(1, 4, 5, 3).astype(np.float32)
    else:
        ax = kw.get("axis", -1)
        y = np.expand_dims(_ints(1, x.shape[ax], 4, 3 if ax == 1 else 5),
                           ax)
    _check(lambda a, b: JF.softmax_with_cross_entropy(a, b, **kw),
           lambda a, b: TF.softmax_with_cross_entropy(a, b, **kw), [x, y])


LOSSES = [
    ("nll_loss", lambda F: lambda x, y, w: F.nll_loss(x, y, w),
     lambda: [_rn(0, 6, 5, 2), _labels_with_ignored(1, 5, 6, 2),
              _unit(2, 5)]),
    ("nll_loss sum", lambda F: lambda x, y: F.nll_loss(x, y,
                                                       reduction="sum"),
     lambda: [_rn(0, 6, 5), _ints(1, 5, 6)]),
    ("mse_loss", lambda F: F.mse_loss, lambda: [_rn(0, 4, 3), _rn(1, 4, 3)]),
    ("l1_loss none", lambda F: lambda a, b: F.l1_loss(a, b, "none"),
     lambda: [_rn(0, 4, 3), _rn(1, 4, 3)]),
    ("smooth_l1_loss", lambda F: lambda a, b: F.smooth_l1_loss(
        a, b, delta=0.7), lambda: [_rn(0, 4, 3), _rn(1, 4, 3)]),
    ("binary_cross_entropy", lambda F: lambda p, y, w:
     F.binary_cross_entropy(p, y, w), lambda: [_unit(0, 4, 3),
                                               _unit(1, 4, 3),
                                               _unit(2, 3)]),
    ("bce_with_logits", lambda F: lambda x, y, w, pw:
     F.binary_cross_entropy_with_logits(x, y, w, pos_weight=pw),
     lambda: [_rn(0, 4, 3) * 3, _unit(1, 4, 3), _unit(2, 3),
              _unit(3, 3) * 3]),
    ("bce_with_logits sum", lambda F: lambda x, y:
     F.binary_cross_entropy_with_logits(x, y, reduction="sum"),
     lambda: [_rn(0, 4, 3) * 3, _unit(1, 4, 3)]),
    ("kl_div batchmean", lambda F: lambda x, y: F.kl_div(x, y, "batchmean"),
     lambda: [np.log(_soft(0, 4, 5)), _soft(1, 4, 5)]),
    ("kl_div none", lambda F: lambda x, y: F.kl_div(x, y, "none"),
     lambda: [np.log(_soft(0, 4, 5)), _soft(1, 4, 5) * (
         _ints(2, 2, 4, 5) > 0)]),
    ("margin_ranking_loss", lambda F: lambda a, b, y:
     F.margin_ranking_loss(a, b, y, margin=0.2),
     lambda: [_rn(0, 8), _rn(1, 8), np.sign(_rn(2, 8))]),
    ("hinge_embedding_loss", lambda F: lambda x, y:
     F.hinge_embedding_loss(x, y, margin=0.5),
     lambda: [_rn(0, 8), np.sign(_rn(2, 8))]),
    ("cosine_embedding_loss", lambda F: lambda a, b, y:
     F.cosine_embedding_loss(a, b, y, margin=0.1),
     lambda: [_rn(0, 6, 4), _rn(1, 6, 4), np.sign(_rn(2, 6))]),
    ("triplet_margin_loss", lambda F: lambda a, p, n:
     F.triplet_margin_loss(a, p, n, margin=0.5, p=3.0, swap=True),
     lambda: [_rn(0, 6, 4), _rn(1, 6, 4), _rn(2, 6, 4)]),
    ("log_loss", lambda F: F.log_loss, lambda: [_unit(0, 6, 1),
                                                _unit(1, 6, 1)]),
    ("square_error_cost", lambda F: F.square_error_cost,
     lambda: [_rn(0, 6, 2), _rn(1, 6, 2)]),
    ("sigmoid_focal_loss", lambda F: lambda x, y, n: F.sigmoid_focal_loss(
        x, y, n, gamma=1.5), lambda: [_rn(0, 6, 3), _unit(1, 6, 3),
                                      np.array([4.0])]),
    ("huber_loss", lambda F: lambda a, b: F.huber_loss(a, b, delta=0.5),
     lambda: [_rn(0, 6, 3), _rn(1, 6, 3)]),
    ("poisson_nll_loss", lambda F: lambda a, b: F.poisson_nll_loss(
        a, b, full=True), lambda: [_rn(0, 6, 3), _unit(1, 6, 3) * 4]),
    ("poisson_nll_loss rate", lambda F: lambda a, b: F.poisson_nll_loss(
        a, b, log_input=False), lambda: [_unit(0, 6, 3) * 3,
                                         _unit(1, 6, 3) * 4]),
    ("multi_label_soft_margin_loss", lambda F: lambda x, y, w:
     F.multi_label_soft_margin_loss(x, y, w),
     lambda: [_rn(0, 6, 4), (_ints(1, 2, 6, 4) * 1.0), _unit(2, 4)]),
    ("dice_loss", lambda F: F.dice_loss,
     lambda: [_soft(0, 4, 3, 5), _ints(1, 5, 4, 3, 1)]),
    ("npair_loss", lambda F: F.npair_loss,
     lambda: [_rn(0, 6, 4), _rn(1, 6, 4), _ints(2, 3, 6)]),
    ("soft_margin_loss", lambda F: F.soft_margin_loss,
     lambda: [_rn(0, 6, 4), np.sign(_rn(1, 6, 4))]),
    ("triplet_margin_with_distance_loss", lambda F: lambda a, p, n:
     F.triplet_margin_with_distance_loss(a, p, n, margin=0.3, swap=True),
     lambda: [_rn(0, 6, 4), _rn(1, 6, 4), _rn(2, 6, 4)]),
    ("margin_cross_entropy", lambda F: lambda x, y: F.margin_cross_entropy(
        x, y, margin1=1.0, margin2=0.3, margin3=0.1, scale=8.0,
        return_softmax=True), lambda: [np.tanh(_rn(0, 6, 5)),
                                       _ints(1, 5, 6)]),
    ("hsigmoid_loss default tree", lambda F: lambda x, y, w, b:
     F.hsigmoid_loss(x, y, 7, w, b), lambda: [_rn(0, 5, 4), _ints(1, 7, 5),
                                              _rn(2, 6, 4), _rn(3, 6, 1)]),
    ("hsigmoid_loss custom", lambda F: lambda x, y, w, t, c:
     F.hsigmoid_loss(x, y, 4, w, path_table=t, path_code=c),
     lambda: [_rn(0, 3, 4), _ints(1, 4, 3), _rn(2, 4, 4),
              np.array([[0, 1, -1], [0, 2, 3], [1, -1, -1]]),
              np.array([[1, 0, 0], [0, 1, 1], [1, 0, 0]])]),
]


# losses whose reference computes a log-softmax in float32 whatever the
# input's dtype: held at the float32 tolerance
F32_INSIDE = {"npair_loss"}


@pytest.mark.parametrize("label,fn,build", LOSSES,
                         ids=[c[0] for c in LOSSES])
def test_losses_match_the_reference(label, fn, build):
    _check(fn(JF), fn(TF), build(),
           tol=1e-6 if label in F32_INSIDE else None)


@pytest.mark.parametrize("reduction,norm", [("mean", False), ("sum", True),
                                            ("none", False)])
def test_ctc_loss_matches_the_reference(reduction, norm):
    T, B, C, L = 9, 3, 5, 3
    logits = _rn(0, T, B, C)
    labels = _ints(1, C - 1, B, L) + 1
    il, ll = np.array([9, 7, 5]), np.array([3, 2, 0])
    _check(lambda x, y: JF.ctc_loss(x, y, paddle.to_tensor(il),
                                    paddle.to_tensor(ll),
                                    reduction=reduction,
                                    norm_by_times=norm),
           lambda x, y: TF.ctc_loss(x, y, torch.from_numpy(il),
                                    torch.from_numpy(ll),
                                    reduction=reduction,
                                    norm_by_times=norm), [logits, labels])


def test_loss_layers_match_the_reference():
    rs = np.random.default_rng(3)
    x = rs.standard_normal((6, 5))
    y = rs.integers(0, 5, 6).astype(np.int64)
    cases = [
        ("CrossEntropyLoss", dict(soft_label=False, axis=-1), [x, y]),
        ("MSELoss", {}, [x, x[::-1].copy()]),
        ("L1Loss", dict(reduction="sum"), [x, x[::-1].copy()]),
        ("NLLLoss", {}, [x, y]),
        ("BCELoss", {}, [_unit(0, 6, 5), _unit(1, 6, 5)]),
        ("BCEWithLogitsLoss", {}, [x, _unit(1, 6, 5)]),
        ("KLDivLoss", dict(reduction="sum"), [np.log(_soft(0, 6, 5)),
                                              _soft(1, 6, 5)]),
        ("SmoothL1Loss", dict(delta=0.5), [x, x[::-1].copy()]),
        ("MarginRankingLoss", dict(margin=0.1), [x[:, 0].copy(),
                                                 x[:, 1].copy(),
                                                 np.sign(x[:, 2])]),
        ("CosineEmbeddingLoss", {}, [x, x[::-1].copy(), np.sign(x[:, 0])]),
        ("TripletMarginLoss", {}, [x, x[::-1].copy(), x * 0.5]),
        ("HingeEmbeddingLoss", {}, [x, np.sign(x[::-1])]),
        ("HuberLoss", {}, [x, x[::-1].copy()]),
        ("PoissonNLLLoss", {}, [x, _unit(2, 6, 5)]),
        ("MultiLabelSoftMarginLoss", {}, [x, (x > 0) * 1.0]),
        ("SoftMarginLoss", {}, [x, np.sign(x[::-1])]),
        ("TripletMarginWithDistanceLoss", {}, [x, x[::-1].copy(), x * 0.3]),
    ]
    for name, kw, arrays in cases:
        # cross entropy's log-softmax is float32 in the reference
        _check(getattr(jnn, name)(**kw), getattr(tnn, name)(**kw), arrays,
               tol=1e-6 if name == "CrossEntropyLoss" else None)
    il, ll = np.array([6, 4]), np.array([2, 1])
    _check(lambda a, b: jnn.CTCLoss()(a, b, paddle.to_tensor(il),
                                      paddle.to_tensor(ll)),
           lambda a, b: tnn.CTCLoss()(a, b, torch.from_numpy(il),
                                      torch.from_numpy(ll)),
           [_rn(4, 6, 2, 4), _ints(5, 3, 2, 2) + 1])
    jl, tl = jnn.HSigmoidLoss(4, 6), tnn.HSigmoidLoss(4, 6)
    load_jax_state_dict(tl, {k: np.asarray(v.numpy())
                             for k, v in jl.state_dict().items()})
    _check(jl, tl, [_rn(6, 5, 4, dtype=np.float32), _ints(7, 6, 5)])


# ---- extras ----

def test_extras_match_the_reference():
    lens = np.array([[3, 1], [0, 4]], np.int64)
    _check(lambda l: JF.sequence_mask(l, maxlen=5, dtype="float32"),
           lambda l: TF.sequence_mask(l, maxlen=5, dtype="float32"),
           [lens], grads=False)
    _check(JF.sequence_mask, TF.sequence_mask, [lens], grads=False)
    for fmt, shape in (("NCHW", (6, 8, 2, 3)), ("NHWC", (6, 2, 3, 8))):
        _check(lambda x: JF.temporal_shift(x, 3, 0.25, data_format=fmt),
               lambda x: TF.temporal_shift(x, 3, 0.25, data_format=fmt),
               [_rn(0, *shape)])
    for fmt in ("NCHW", "NHWC"):
        _check(lambda x: JF.zeropad2d(x, [1, 2, 0, 3], data_format=fmt),
               lambda x: TF.zeropad2d(x, [1, 2, 0, 3], data_format=fmt),
               [_rn(1, 2, 3, 4, 5)])
    b, h, m, d = 2, 2, 5, 4
    rs = np.random.default_rng(2)
    offset = np.zeros((b, h, m + 1), np.int64)
    cols = []
    for i in range(b):
        for j in range(h):
            row_cols = [np.sort(rs.choice(m, rs.integers(1, m + 1),
                                          replace=False))
                        for _ in range(m)]
            offset[i, j, 1:] = np.cumsum([len(c) for c in row_cols])
            cols.append(np.concatenate(row_cols))
    nnz = max(len(c) for c in cols)
    columns = np.stack([np.pad(c, (0, nnz - len(c))) for c in cols]
                       ).reshape(b, h, nnz)
    # pad entries sit past each row's offsets, so they select nothing
    offset[..., -1] = np.minimum(offset[..., -1], nnz)
    # the reference's softmax runs in float32 whatever q's dtype
    _check(lambda q, k, v, o, c: JF.sparse_attention(q, k, v, o, c),
           lambda q, k, v, o, c: TF.sparse_attention(q, k, v, o, c),
           [_rn(3, b, h, m, d), _rn(4, b, h, m, d), _rn(5, b, h, m, d),
            offset, columns], tol=1e-6)


def test_class_center_sample_keeps_every_positive():
    y = np.array([3, 7, 3, 1, 9], np.int64)
    # every class positive: nothing to draw, both packages agree exactly
    jr, js = JF.class_center_sample(paddle.to_tensor(y), 10, 4)
    tr, ts = TF.class_center_sample(torch.from_numpy(y), 10, 4)
    np.testing.assert_array_equal(tr.numpy(), jr.numpy())
    np.testing.assert_array_equal(ts.numpy(), js.numpy())
    with trng.generator_scope(torch.Generator().manual_seed(1)):
        r1, s1 = TF.class_center_sample(torch.from_numpy(y), 20, 8)
    with trng.generator_scope(torch.Generator().manual_seed(1)):
        r2, s2 = TF.class_center_sample(torch.from_numpy(y), 20, 8)
    assert torch.equal(s1, s2) and torch.equal(r1, r2)
    s = s1.numpy()
    assert len(s) == 8 and np.all(np.diff(s) > 0)
    assert set(y) <= set(s) and np.array_equal(s[r1.numpy()], y)


def test_inplace_activations():
    x = torch.from_numpy(_rn(0, 4, 5))
    ref = {"relu_": JF.relu(paddle.to_tensor(x.numpy())),
           "elu_": JF.elu(paddle.to_tensor(x.numpy()), 0.5),
           "tanh_": paddle.tanh(paddle.to_tensor(x.numpy())),
           "softmax_": JF.softmax(paddle.to_tensor(x.numpy()), axis=0)}
    for name, kw in (("relu_", {}), ("elu_", dict(alpha=0.5)),
                     ("tanh_", {}), ("softmax_", dict(axis=0))):
        y = x.clone()
        out = getattr(TF, name)(y, **kw)
        assert out is y and _rel(y.numpy(), ref[name].numpy()) < 1e-12


# ---- nn.utils and nn.quant ----

def test_parameter_vectors_match_the_reference():
    jl = jnn.Linear(3, 4)
    tl = tnn.Linear(3, 4)
    arrays = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    load_jax_state_dict(tl, arrays)
    jv = jnn.utils.parameters_to_vector(jl.parameters())
    tv = tnn.utils.parameters_to_vector(tl.parameters())
    np.testing.assert_array_equal(tv.numpy(), jv.numpy())
    vec = np.arange(16, dtype=np.float32)
    jnn.utils.vector_to_parameters(paddle.to_tensor(vec), jl.parameters())
    tnn.utils.vector_to_parameters(torch.from_numpy(vec), tl.parameters())
    for k, v in tl.state_dict().items():
        np.testing.assert_array_equal(v.numpy(),
                                      jl.state_dict()[k].numpy())


@pytest.mark.parametrize("dim", [0, 1])
def test_weight_norm_matches_the_reference(dim):
    jl, tl = jnn.Linear(4, 3), tnn.Linear(4, 3)
    load_jax_state_dict(tl, {k: np.asarray(v.numpy())
                             for k, v in jl.state_dict().items()})
    jnn.utils.weight_norm(jl, dim=dim)
    tnn.utils.weight_norm(tl, dim=dim)
    assert sorted(n for n, _ in tl.named_parameters()) == \
        sorted(n for n, _ in jl.named_parameters())
    x = _rn(0, 5, 4, dtype=np.float32)
    jy, ty = jl(paddle.to_tensor(x)), tl(torch.from_numpy(x))
    assert _rel(ty.detach().numpy(), jy.numpy()) < 1e-6
    jg = paddle.grad(jy.sum(), [jl.weight_g, jl.weight_v])
    tg = tpaddle.grad(ty.sum(), [tl.weight_g, tl.weight_v])
    for a, b in zip(tg, jg):
        assert _rel(a.numpy(), b.numpy()) < 1e-6
    jnn.utils.remove_weight_norm(jl)
    tnn.utils.remove_weight_norm(tl)
    assert _rel(tl.weight.detach().numpy(), jl.weight.numpy()) < 1e-6
    assert sorted(n for n, _ in tl.named_parameters()) == ["bias", "weight"]


def test_spectral_norm_converges_to_the_reference():
    jl, tl = jnn.Linear(5, 4), tnn.Linear(5, 4)
    load_jax_state_dict(tl, {k: np.asarray(v.numpy())
                             for k, v in jl.state_dict().items()})
    # the start vectors differ (each package's own draws); enough power
    # iterations reach the same largest singular value
    jnn.utils.spectral_norm(jl, n_power_iterations=200)
    tnn.spectral_norm(tl, n_power_iterations=200)
    x = _rn(1, 3, 5, dtype=np.float32)
    jy, ty = jl(paddle.to_tensor(x)), tl(torch.from_numpy(x))
    assert _rel(ty.detach().numpy(), jy.numpy()) < 1e-5
    (g,) = tpaddle.grad(ty.sum(), [tl._parameters["weight"]])
    assert torch.isfinite(g).all()


def test_nn_quant_names_the_runtime_s_layers():
    from paddle_tpu_torch.quantization import runtime

    for name in tnn.quant.__all__:
        assert getattr(tnn.quant, name) is getattr(runtime, name)
    assert issubclass(tnn.quant.Int8WeightOnlyLinear, tnn.Layer)


# ---- coverage ----

# the reference's nn.quant also lists its QAT / PTQ classes, which are
# ROADMAP A12 part 4's
_LATER = {"nn.quant": {"ImperativeQuantAware", "PostTrainingQuantization",
                       "QuantizedLinear"}}


@pytest.mark.parametrize("path", [
    "nn.functional.common", "nn.functional.loss", "nn.functional.extras",
    "nn.functional", "nn.layer.common", "nn.layer.loss", "nn.layer.rnn",
    "nn.layer.transformer", "nn.utils", "nn.quant", "nn"])
def test_every_reference_name_has_a_port(path):
    ref = importlib.import_module("paddle_tpu." + path)
    port = importlib.import_module("paddle_tpu_torch." + path)
    names = getattr(ref, "__all__", None) or [
        n for n in dir(ref) if not n.startswith("_")
        and not isinstance(getattr(ref, n), type(importlib))]
    missing = sorted(n for n in set(names) - _LATER.get(path, set())
                     if not hasattr(port, n))
    assert not missing, missing
