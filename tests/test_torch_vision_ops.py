"""`vision.ops`: every detection primitive of the PyTorch port against
the JAX package's on CPU, on the same numpy inputs, within 1e-5, kept
indices equal — with tied scores for `nms`, `matrix_nms` and
`generate_proposals` (each package's own tie order: `nms` a stable
descending sort, the other two numpy's `argsort(-s)`), and `roi_align`
with `aligned` both ways."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.vision import ops as jops
from paddle_tpu_torch.vision import ops as tops

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


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().numpy()
    return np.asarray(v.numpy() if hasattr(v, "numpy") else v)


def _close(got, want, tol=1e-5):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                               rtol=tol, atol=tol)


def _equal(got, want):
    np.testing.assert_array_equal(_np(got), _np(want))


def _both(name, *arrays, **kw):
    want = getattr(jops, name)(*[paddle.to_tensor(a) for a in arrays], **kw)
    got = getattr(tops, name)(*[torch.from_numpy(np.asarray(a))
                                for a in arrays], **kw)
    return got, want


def _boxes(rng, n, size=50.0):
    xy = rng.uniform(0, size, (n, 2)).astype(np.float32)
    wh = rng.uniform(size / 25, size / 3, (n, 2)).astype(np.float32)
    return np.concatenate([xy, xy + wh], 1)


RNG = np.random.default_rng(0)
B40 = _boxes(RNG, 40)


def test_box_area_and_iou():
    _close(*_both("box_area", B40))
    _close(*_both("box_iou", B40, B40[:7]))


@pytest.mark.parametrize("kind", ["scores", "tied", "none", "category",
                                  "top_k"])
def test_nms_kept_indices_equal(kind):
    s = RNG.random(40).astype(np.float32)
    kw = {}
    if kind == "tied":
        s = np.round(s * 4).astype(np.float32) / 4   # heavy ties
    arrays = [B40]
    if kind == "none":
        kw["scores"] = None
    elif kind == "category":
        cats = RNG.integers(0, 3, 40)
        want = jops.nms(paddle.to_tensor(B40), 0.2,
                        scores=paddle.to_tensor(s),
                        category_idxs=paddle.to_tensor(cats))
        got = tops.nms(torch.from_numpy(B40), 0.2, scores=torch.from_numpy(s),
                       category_idxs=torch.from_numpy(cats))
        _equal(got, want)
        return
    want = jops.nms(paddle.to_tensor(B40), 0.2,
                    scores=None if kind == "none" else paddle.to_tensor(s),
                    top_k=5 if kind == "top_k" else None)
    got = tops.nms(torch.from_numpy(B40), 0.2,
                   scores=None if kind == "none" else torch.from_numpy(s),
                   top_k=5 if kind == "top_k" else None)
    assert got.dtype == torch.int64
    _equal(got, want)
    assert len(arrays) == 1


def test_nms_empty():
    assert tops.nms(torch.zeros(0, 4)).shape == (0,)


FEAT = RNG.standard_normal((2, 5, 12, 14)).astype(np.float32)
ROIS = np.concatenate([_boxes(RNG, 6, 40.0)], 0)
ROIS_NUM = np.array([4, 2], np.int32)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("sampling_ratio", [-1, 3])
def test_roi_align(aligned, sampling_ratio):
    want = jops.roi_align(paddle.to_tensor(FEAT), paddle.to_tensor(ROIS),
                          paddle.to_tensor(ROIS_NUM), (3, 4), 0.25,
                          sampling_ratio=sampling_ratio, aligned=aligned)
    got = tops.roi_align(torch.from_numpy(FEAT), torch.from_numpy(ROIS),
                         torch.from_numpy(ROIS_NUM), (3, 4), 0.25,
                         sampling_ratio=sampling_ratio, aligned=aligned)
    _close(got, want)
    layer = tops.RoIAlign(2, 0.25)
    _close(layer(torch.from_numpy(FEAT), torch.from_numpy(ROIS),
                 torch.from_numpy(ROIS_NUM), aligned=aligned),
           jops.RoIAlign(2, 0.25)(paddle.to_tensor(FEAT),
                                  paddle.to_tensor(ROIS),
                                  paddle.to_tensor(ROIS_NUM),
                                  aligned=aligned))


def test_roi_pool_and_psroi_pool():
    got, want = _both("roi_pool", FEAT, ROIS, ROIS_NUM, output_size=3,
                      spatial_scale=0.25)
    _close(got, want)
    _close(tops.RoIPool((2, 3), 0.25)(torch.from_numpy(FEAT),
                                      torch.from_numpy(ROIS),
                                      torch.from_numpy(ROIS_NUM)),
           jops.RoIPool((2, 3), 0.25)(paddle.to_tensor(FEAT),
                                      paddle.to_tensor(ROIS),
                                      paddle.to_tensor(ROIS_NUM)))
    ps = RNG.standard_normal((2, 8, 12, 14)).astype(np.float32)
    got, want = _both("psroi_pool", ps, ROIS, ROIS_NUM, output_size=2,
                      spatial_scale=0.25)
    _close(got, want)
    _close(tops.PSRoIPool(2, 0.25)(torch.from_numpy(ps),
                                   torch.from_numpy(ROIS),
                                   torch.from_numpy(ROIS_NUM)), want)


@pytest.mark.parametrize("iou_aware,clip,scale", [
    (False, True, 1.0), (True, False, 1.05)])
def test_yolo_box(iou_aware, clip, scale):
    na, cls = 3, 4
    c = na * (5 + cls) + (na if iou_aware else 0)
    x = RNG.standard_normal((2, c, 5, 6)).astype(np.float32)
    isz = np.array([[320, 384], [300, 280]], np.int32)
    anchors = [10, 13, 16, 30, 33, 23]
    got, want = _both("yolo_box", x, isz, anchors=anchors, class_num=cls,
                      conf_thresh=0.3, downsample_ratio=32, clip_bbox=clip,
                      scale_x_y=scale, iou_aware=iou_aware,
                      iou_aware_factor=0.4)
    for g, w in zip(got, want):
        _close(g, w, 1e-4)


@pytest.mark.parametrize("smooth,score", [(True, False), (False, True)])
def test_yolo_loss(smooth, score):
    na, cls, h = 3, 4, 8
    x = RNG.standard_normal((2, na * (5 + cls), h, h)).astype(np.float32)
    # gts well inside the grid, the padded ones (w = h = 0) never share
    # a cell with a valid one
    gt = np.array([[[100, 120, 40, 60], [200, 50, 90, 30], [0, 0, 0, 0]],
                   [[60, 180, 20, 25], [150, 150, 120, 110],
                    [210, 220, 15, 12]]], np.float32)
    lbl = np.array([[1, 3, 0], [2, 0, 1]], np.int64)
    anchors = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]
    args = [x, gt, lbl]
    kw = dict(anchors=anchors, anchor_mask=[0, 1, 2], class_num=cls,
              ignore_thresh=0.5, downsample_ratio=32,
              use_label_smooth=smooth)
    if score:
        kw_s = RNG.random((2, 3)).astype(np.float32)
        want = jops.yolo_loss(*[paddle.to_tensor(a) for a in args],
                              gt_score=paddle.to_tensor(kw_s), **kw)
        got = tops.yolo_loss(*[torch.from_numpy(a) for a in args],
                             gt_score=torch.from_numpy(kw_s), **kw)
    else:
        got, want = _both("yolo_loss", *args, **kw)
    _close(got, want, 1e-4)


@pytest.mark.parametrize("gaussian", [False, True])
def test_matrix_nms_with_ties(gaussian):
    boxes = np.stack([_boxes(RNG, 30, 1.0) for _ in range(2)])
    scores = RNG.random((2, 4, 30)).astype(np.float32)
    scores[:, :, ::3] = 0.5       # ties in every class
    got, want = _both("matrix_nms", boxes, scores, score_threshold=0.1,
                      post_threshold=0.05, nms_top_k=20, keep_top_k=25,
                      use_gaussian=gaussian, return_index=True)
    _close(got[0], want[0])
    _equal(got[1], want[1])
    _equal(got[2], want[2])


@pytest.mark.parametrize("mask,groups,dg", [(True, 1, 1), (False, 2, 2)])
def test_deform_conv2d(mask, groups, dg):
    x = RNG.standard_normal((2, 4, 7, 6)).astype(np.float32)
    off = (RNG.standard_normal((2, 2 * dg * 9, 4, 3)) * 1.5).astype(
        np.float32)
    w = RNG.standard_normal((6, 4 // groups, 3, 3)).astype(np.float32)
    b = RNG.standard_normal(6).astype(np.float32)
    m = RNG.random((2, dg * 9, 4, 3)).astype(np.float32) if mask else None
    kw = dict(stride=(2, 2), padding=1, dilation=1, deformable_groups=dg,
              groups=groups)
    want = jops.deform_conv2d(paddle.to_tensor(x), paddle.to_tensor(off),
                              paddle.to_tensor(w), paddle.to_tensor(b),
                              mask=None if m is None else
                              paddle.to_tensor(m), **kw)
    got = tops.deform_conv2d(torch.from_numpy(x), torch.from_numpy(off),
                             torch.from_numpy(w), torch.from_numpy(b),
                             mask=None if m is None else torch.from_numpy(m),
                             **kw)
    _close(got, want, 1e-4)
    layer = tops.DeformConv2D(4, 6, 3, 2, 1, 1, dg, groups)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w))
        layer.bias.copy_(torch.from_numpy(b))
    _close(layer(torch.from_numpy(x), torch.from_numpy(off),
                 None if m is None else torch.from_numpy(m)), want, 1e-4)


def test_read_file_and_decode_jpeg(tmp_path):
    p = tmp_path / "f.bin"
    p.write_bytes(bytes(range(10)))
    _equal(tops.read_file(str(p)), jops.read_file(str(p)))
    try:
        from PIL import Image
    except ImportError:
        with pytest.raises(RuntimeError, match="PIL"):
            tops.decode_jpeg(tops.read_file(str(p)))
        return
    img = np.zeros((4, 5, 3), np.uint8)
    img[..., 0] = 200
    Image.fromarray(img).save(tmp_path / "a.png")
    out = tops.decode_jpeg(tops.read_file(str(tmp_path / "a.png")))
    _equal(out, img.transpose(2, 0, 1))


def test_distribute_fpn_proposals():
    rois = _boxes(RNG, 30, 400.0)
    num = np.array([12, 18], np.int32)
    got = tops.distribute_fpn_proposals(torch.from_numpy(rois), 2, 5, 4, 224,
                                        rois_num=torch.from_numpy(num))
    want = jops.distribute_fpn_proposals(paddle.to_tensor(rois), 2, 5, 4,
                                         224, rois_num=paddle.to_tensor(num))
    for g, w in zip(got[0], want[0]):
        _close(g, w)
    _equal(got[1], want[1])
    for g, w in zip(got[2], want[2]):
        _equal(g, w)


@pytest.mark.parametrize("offset", [False, True])
def test_generate_proposals_with_tied_scores(offset):
    n, a, h, w = 2, 3, 6, 7
    scores = RNG.random((n, a, h, w)).astype(np.float32)
    scores = np.round(scores * 8).astype(np.float32) / 8   # ties
    deltas = (RNG.standard_normal((n, 4 * a, h, w)) * 0.3).astype(np.float32)
    anchors = np.concatenate([
        np.stack(np.meshgrid(np.arange(w) * 16, np.arange(h) * 16), -1)[
            :, :, None, :].repeat(a, 2).astype(np.float32),
        np.stack(np.meshgrid(np.arange(w) * 16, np.arange(h) * 16), -1)[
            :, :, None, :].repeat(a, 2).astype(np.float32)
        + np.array([16, 32, 48], np.float32)[None, None, :, None]], -1)
    var = np.full((h, w, a, 4), 1.0, np.float32)
    isz = np.array([[96, 112], [80, 100]], np.float32)
    kw = dict(pre_nms_top_n=60, post_nms_top_n=20, nms_thresh=0.5,
              min_size=2.0, pixel_offset=offset, return_rois_num=True)
    got, want = _both("generate_proposals", scores, deltas, isz, anchors,
                      var, **kw)
    _close(got[0], want[0])
    _close(got[1], want[1])
    _equal(got[2], want[2])


@pytest.mark.parametrize("order,flip,clip", [(False, True, False),
                                             (True, False, True)])
def test_prior_box(order, flip, clip):
    feat = np.zeros((1, 2, 4, 5), np.float32)
    img = np.zeros((1, 3, 32, 40), np.float32)
    got, want = _both("prior_box", feat, img, min_sizes=[8.0, 16.0],
                      max_sizes=[16.0, 24.0], aspect_ratios=(2.0, 3.0),
                      flip=flip, clip=clip, min_max_aspect_ratios_order=order)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("normalized", [True, False])
def test_box_coder_encode_decode(normalized):
    priors = _boxes(RNG, 5, 1.0 if normalized else 50.0)
    var = np.array([[0.1, 0.1, 0.2, 0.2]] * 5, np.float32)
    targets = _boxes(RNG, 3, 1.0 if normalized else 50.0)
    got, want = _both("box_coder", priors, var, targets,
                      code_type="encode_center_size",
                      box_normalized=normalized)
    _close(got, want)
    deltas = (RNG.standard_normal((3, 5, 4)) * 0.2).astype(np.float32)
    for axis in (0, 1):
        pr = priors if axis == 0 else priors[:3]
        d = deltas if axis == 0 else deltas[:, :3]
        want = jops.box_coder(paddle.to_tensor(pr), [0.1, 0.1, 0.2, 0.2],
                              paddle.to_tensor(d),
                              code_type="decode_center_size",
                              box_normalized=normalized, axis=axis)
        got = tops.box_coder(torch.from_numpy(pr), [0.1, 0.1, 0.2, 0.2],
                             torch.from_numpy(d),
                             code_type="decode_center_size",
                             box_normalized=normalized, axis=axis)
        _close(got, want)


def test_edit_distance():
    a = np.array([[1, 2, 3, 4], [5, 6, 0, 0], [1, 1, 1, 1]], np.int64)
    b = np.array([[1, 3, 4, 0], [5, 6, 7, 0], [2, 1, 1, 2]], np.int64)
    la, lb = np.array([4, 2, 3]), np.array([3, 3, 4])
    for norm in (True, False):
        got, want = _both("edit_distance", a, b, normalized=norm,
                          ignored_tokens=[0], input_length=la,
                          label_length=lb)
        _close(got[0], want[0])
        _equal(got[1], want[1])
