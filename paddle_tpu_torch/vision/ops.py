"""Detection primitives (counterpart of paddle_tpu/vision/ops.py;
reference python/paddle/vision/ops.py — nms:1663, roi_align:1302,
roi_pool:1175, box_coder; CUDA kernels
paddle/phi/kernels/gpu/nms_kernel.cu, roi_align_kernel.cu).

The arithmetic runs on the tensors' device, in the reference's order of
operations; what is sequential or data-dependent runs on the host, as in
the reference:

* `nms` computes the IoU matrix (and its threshold) on the device and
  walks the greedy suppression on the host over a stable descending sort
  of the scores (`jnp.argsort` in the reference is stable; with
  `scores=None` the rank is `arange(n, 0, -1)`);
* `matrix_nms` and `generate_proposals` rank with numpy's default
  `argsort(-s)`, which is not stable: their ranking is done on the host
  with numpy, so ties order as the reference's do (`torch.sort` orders
  them differently);
* `roi_align` / `roi_pool` / `psroi_pool` gather every RoI's sample grid
  at once from the [N·H·W, C] rows of the feature map;
  `roi_align`'s `sampling_ratio <= 0` means 2 samples per bin side (the
  reference's rule, not paddle's adaptive count).
"""
import numpy as np
import torch
import torch.nn.functional as TF

__all__ = ["nms", "roi_align", "roi_pool", "box_area", "box_iou",
           "RoIAlign", "RoIPool", "yolo_box", "yolo_loss", "matrix_nms",
           "psroi_pool", "PSRoIPool", "deform_conv2d", "read_file",
           "decode_jpeg", "DeformConv2D", "distribute_fpn_proposals",
           "generate_proposals", "prior_box", "box_coder", "edit_distance"]


def _t(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def _host(x):
    return np.asarray(_t(x).detach().cpu())


def _div(a, n):
    """a / n correctly rounded on every device: torch on CUDA divides by
    a Python number as a multiply by its rounded reciprocal, an ulp off
    the quotient the reference (and the CPU) takes — at RoI coordinates
    of a few hundred pixels that ulp moves a bilinear sample's output by
    ≈ 2e-5 of its scale, and can move a bin edge."""
    return a / torch.full((), float(n), dtype=a.dtype, device=a.device)


def box_area(boxes):
    b = _t(boxes)
    return (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])


def _iou(a, b):
    area1 = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area2 = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area1[:, None] + area2[None, :] - inter + 1e-10)


def box_iou(boxes1, boxes2):
    a = _t(boxes1)
    return _iou(a, _t(boxes2).to(a.device))


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None, name=None):
    """Greedy NMS (reference ops.py:1663): kept indices (int64, on the
    boxes' device) by descending score."""
    b = _t(boxes)
    n = int(b.shape[0])
    if n == 0:
        return torch.zeros((0,), dtype=torch.int64, device=b.device)
    s = (np.arange(n, 0, -1, dtype=np.float32) if scores is None
         else _host(scores))
    k = n if top_k is None else min(int(top_k), n)
    over = _iou(b, b) > iou_threshold
    if category_idxs is not None:
        # class-aware: boxes of different categories never suppress
        cats = _t(category_idxs).to(b.device)
        over = over & (cats[:, None] == cats[None, :])
    over = _host(over)
    order = np.argsort(-s, kind="stable")
    alive = np.ones(n, bool)
    kept = []
    for idx in order:
        if not alive[idx]:
            continue
        kept.append(idx)
        alive &= ~over[idx]
        alive[idx] = True
    return torch.as_tensor(np.asarray(kept[:k], np.int64), device=b.device)


def _rows(x):
    """[N, C, H, W] → [N·H·W, C]: one gather reads a sample's channels."""
    n, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(n * h * w, c)


def _img_of_roi(boxes_num, device):
    bn = _host(boxes_num).reshape(-1)
    return torch.as_tensor(np.repeat(np.arange(len(bn)), bn),
                           device=device)


def _grid(rows, img, ys, xs, h, w):
    """rows[(img, y, x)] for every (RoI, y sample, x sample): [R, Y, X,
    C]."""
    idx = (img[:, None, None] * (h * w) + ys.long()[:, :, None] * w
           + xs.long()[:, None, :])
    return rows[idx]


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    """Bilinear RoI align (reference ops.py:1302). x: [N, C, H, W];
    boxes: [R, 4] (x1, y1, x2, y2); boxes_num: RoIs per image →
    [R, C, ph, pw]."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    ph, pw = output_size
    sr = 2 if sampling_ratio <= 0 else int(sampling_ratio)
    xv = _t(x)
    bv = _t(boxes).to(device=xv.device, dtype=xv.dtype)
    n, c, h, w = xv.shape
    img = _img_of_roi(boxes_num, xv.device)
    off = 0.5 if aligned else 0.0
    sb = bv * spatial_scale - off
    x1, y1, x2, y2 = sb[:, 0:1], sb[:, 1:2], sb[:, 2:3], sb[:, 3:4]
    rw = torch.clamp(x2 - x1, min=1.0 if not aligned else 1e-6)
    rh = torch.clamp(y2 - y1, min=1.0 if not aligned else 1e-6)
    bin_h, bin_w = _div(rh, ph), _div(rw, pw)  # [R, 1]
    dev = xv.device
    ar_p = torch.arange(ph, device=dev, dtype=xv.dtype)
    ar_q = torch.arange(pw, device=dev, dtype=xv.dtype)
    sub = torch.arange(sr, device=dev, dtype=xv.dtype) + 0.5
    # [R, ph·sr] / [R, pw·sr] sample coordinates, in the reference's
    # order of operations
    ys = ((ar_p[None, :, None] * bin_h[:, :, None] + y1[:, :, None])
          + _div(sub[None, None, :] * bin_h[:, :, None], sr)).reshape(
              -1, ph * sr)
    xs = ((ar_q[None, :, None] * bin_w[:, :, None] + x1[:, :, None])
          + _div(sub[None, None, :] * bin_w[:, :, None], sr)).reshape(
              -1, pw * sr)
    y0 = torch.clamp(torch.floor(ys), 0, h - 1)
    x0 = torch.clamp(torch.floor(xs), 0, w - 1)
    y1i = torch.clamp(y0 + 1, 0, h - 1)
    x1i = torch.clamp(x0 + 1, 0, w - 1)
    wy = (torch.clamp(ys, 0, h - 1) - y0)[:, :, None, None]
    wx = (torch.clamp(xs, 0, w - 1) - x0)[:, None, :, None]
    rows = _rows(xv)
    val = (_grid(rows, img, y0, x0, h, w) * (1 - wy) * (1 - wx)
           + _grid(rows, img, y1i, x0, h, w) * wy * (1 - wx)
           + _grid(rows, img, y0, x1i, h, w) * (1 - wy) * wx
           + _grid(rows, img, y1i, x1i, h, w) * wy * wx)
    val = val.reshape(-1, ph, sr, pw, sr, c).mean(dim=(2, 4))
    return val.permute(0, 3, 1, 2)


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
             name=None):
    """Max-pool RoI pooling (reference ops.py:1175): the roi_align grid
    with max instead of mean, 4 nearest samples per bin side."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    ph, pw = output_size
    xv = _t(x)
    bv = _t(boxes).to(device=xv.device, dtype=xv.dtype)
    n, c, h, w = xv.shape
    img = _img_of_roi(boxes_num, xv.device)
    rb = torch.round(bv * spatial_scale)
    x1, y1, x2, y2 = rb[:, 0:1], rb[:, 1:2], rb[:, 2:3], rb[:, 3:4]
    rh = torch.clamp(y2 - y1 + 1, min=1.0)[:, :, None]
    rw = torch.clamp(x2 - x1 + 1, min=1.0)[:, :, None]
    sr = 4
    dev = xv.device
    sub = _div((torch.arange(sr, device=dev, dtype=xv.dtype) + 0.5)[None, :],
               sr)
    gy = torch.arange(ph, device=dev, dtype=xv.dtype)[:, None] + sub
    gx = torch.arange(pw, device=dev, dtype=xv.dtype)[:, None] + sub
    ys = torch.clamp(y1[:, :, None] + _div(gy[None] * rh, ph), 0, h - 1)
    xs = torch.clamp(x1[:, :, None] + _div(gx[None] * rw, pw), 0, w - 1)
    val = _grid(_rows(xv), img, ys.reshape(-1, ph * sr).to(torch.int32),
                xs.reshape(-1, pw * sr).to(torch.int32), h, w)
    val = val.reshape(-1, ph, sr, pw, sr, c).amax(dim=(2, 4))
    return val.permute(0, 3, 1, 2)


class RoIAlign:
    """Layer wrapper (reference ops.py:1450)."""

    def __init__(self, output_size, spatial_scale=1.0):
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def __call__(self, x, boxes, boxes_num, aligned=True):
        return roi_align(x, boxes, boxes_num, self.output_size,
                         self.spatial_scale, aligned=aligned)


class RoIPool:
    """Layer wrapper (reference ops.py:1285)."""

    def __init__(self, output_size, spatial_scale=1.0):
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def __call__(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, self.output_size,
                        self.spatial_scale)


def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, clip_bbox=True, name=None, scale_x_y=1.0,
             iou_aware=False, iou_aware_factor=0.5):
    """Decode a YOLOv3 head into boxes + scores (reference vision/ops.py
    yolo_box → yolo_box_op). x: [N, na·(5+class_num), H, W]; img_size:
    [N, 2] (h, w) → (boxes [N, na·H·W, 4] xyxy in image pixels, scores
    [N, na·H·W, class_num])."""
    v = _t(x)
    isz = _t(img_size).to(v.device)
    na = len(anchors) // 2
    anchor_wh = torch.as_tensor(
        np.asarray(anchors, np.float32).reshape(na, 2), device=v.device)
    n, c, h, w = v.shape
    if iou_aware:
        # layout: [na·iou, na·(5+cls)] — the iou logits first
        iou_p = torch.sigmoid(v[:, :na].reshape(n, na, 1, h, w))
        v = v[:, na:]
    v = v.reshape(n, na, 5 + class_num, h, w)
    tx, ty, tw, th = v[:, :, 0], v[:, :, 1], v[:, :, 2], v[:, :, 3]
    conf = torch.sigmoid(v[:, :, 4])
    cls = torch.sigmoid(v[:, :, 5:])
    if iou_aware:
        conf = conf ** (1 - iou_aware_factor) * \
            iou_p[:, :, 0] ** iou_aware_factor
    gx = torch.arange(w, dtype=torch.float32, device=v.device)[
        None, None, None, :]
    gy = torch.arange(h, dtype=torch.float32, device=v.device)[
        None, None, :, None]
    bias = 0.5 * (scale_x_y - 1.0)
    cx = _div(torch.sigmoid(tx) * scale_x_y - bias + gx, w)
    cy = _div(torch.sigmoid(ty) * scale_x_y - bias + gy, h)
    aw = anchor_wh[:, 0][None, :, None, None]
    ah = anchor_wh[:, 1][None, :, None, None]
    bw = _div(torch.exp(tw) * aw, downsample_ratio * w)
    bh = _div(torch.exp(th) * ah, downsample_ratio * h)
    im_h = isz[:, 0].to(torch.float32)[:, None, None, None]
    im_w = isz[:, 1].to(torch.float32)[:, None, None, None]
    x0 = (cx - bw / 2) * im_w
    y0 = (cy - bh / 2) * im_h
    x1 = (cx + bw / 2) * im_w
    y1 = (cy + bh / 2) * im_h
    if clip_bbox:
        zero = torch.zeros((), device=v.device)
        x0 = torch.clamp(x0, zero, im_w - 1)
        y0 = torch.clamp(y0, zero, im_h - 1)
        x1 = torch.clamp(x1, zero, im_w - 1)
        y1 = torch.clamp(y1, zero, im_h - 1)
    boxes = torch.stack([x0, y0, x1, y1], -1).reshape(n, -1, 4)
    keep = (conf > conf_thresh).to(cls.dtype)
    scores = (conf[:, :, None] * cls * keep[:, :, None]).permute(
        0, 1, 3, 4, 2).reshape(n, -1, class_num)
    return boxes, scores


def _bce(pred_logit, target):
    return TF.softplus(pred_logit) - target * pred_logit


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    """YOLOv3 training loss (reference vision/ops.py yolo_loss →
    yolov3_loss op): xy / wh regression on responsible anchors,
    objectness with an IoU-ignore band, per-class BCE. x: [N,
    na·(5+cls), H, W]; gt_box: [N, B, 4] (cx, cy, w, h in image units);
    gt_label: [N, B] → per-image loss [N]."""
    v = _t(x)
    dev = v.device
    gtb = _t(gt_box).to(dev)
    gtl = _t(gt_label).to(dev)
    full_wh = np.asarray(anchors, np.float32).reshape(-1, 2)
    mask_wh = full_wh[np.asarray(anchor_mask)]
    na = len(anchor_mask)
    n, c, h, w = v.shape
    v = v.reshape(n, na, 5 + class_num, h, w)
    input_size = downsample_ratio * h  # square net input assumption
    gscore = (_t(gt_score).to(dev) if gt_score is not None else
              torch.ones(gtb.shape[:2], dtype=torch.float32, device=dev))
    gx = _div(gtb[..., 0], input_size)
    gy = _div(gtb[..., 1], input_size)
    gw = _div(gtb[..., 2], input_size)
    gh = _div(gtb[..., 3], input_size)
    valid = (gw > 0) & (gh > 0)
    fa = torch.as_tensor(full_wh / input_size, device=dev)
    inter = torch.minimum(gw[..., None], fa[:, 0]) * \
        torch.minimum(gh[..., None], fa[:, 1])
    union = gw[..., None] * gh[..., None] + fa[:, 0] * fa[:, 1] - inter
    best = torch.argmax(inter / torch.clamp(union, min=1e-10), -1)
    mask_arr = torch.as_tensor(np.asarray(anchor_mask), device=dev)
    hit = best[..., None] == mask_arr
    in_mask = hit.any(-1) & valid
    local_a = torch.argmax(hit.to(torch.int32), -1)
    ci = torch.clamp((gx * w).to(torch.int32), 0, w - 1).long()
    cj = torch.clamp((gy * h).to(torch.int32), 0, h - 1).long()
    bidx = torch.arange(n, device=dev)[:, None].expand_as(ci)
    sel = (bidx.reshape(-1), local_a.reshape(-1), cj.reshape(-1),
           ci.reshape(-1))

    def scat(vals, base=0.0):
        t = torch.full((n, na, h, w), base, dtype=torch.float32, device=dev)
        src = torch.where(in_mask, vals.to(torch.float32),
                          torch.full_like(vals, base, dtype=torch.float32))
        return t.index_put(sel, src.reshape(-1))

    obj_t = scat(torch.where(in_mask, 1.0, 0.0))
    tscore = scat(gscore)
    tx_t = scat(gx * w - ci)
    ty_t = scat(gy * h - cj)
    ma = torch.as_tensor(mask_wh / input_size, device=dev)
    aw_sel = ma[:, 0][local_a]
    ah_sel = ma[:, 1][local_a]
    tw_t = scat(torch.log(torch.clamp(gw / torch.clamp(aw_sel, min=1e-10),
                                      min=1e-10)))
    th_t = scat(torch.log(torch.clamp(gh / torch.clamp(ah_sel, min=1e-10),
                                      min=1e-10)))
    smooth = 1.0 / class_num if use_label_smooth else 0.0
    onehot = TF.one_hot(gtl.long(), class_num).to(torch.float32)
    onehot = onehot * (1.0 - 2 * smooth) + smooth
    tcls = torch.zeros((n, na, h, w, class_num), dtype=torch.float32,
                       device=dev).index_put(
        sel, torch.where(in_mask[..., None], onehot, 0.0).reshape(
            -1, class_num))
    wgt = scat(2.0 - gw * gh) * tscore
    px, py = v[:, :, 0], v[:, :, 1]
    pw_, ph_ = v[:, :, 2], v[:, :, 3]
    pobj, pcls = v[:, :, 4], v[:, :, 5:].permute(0, 1, 3, 4, 2)
    loss_xy = (_bce(px, tx_t) + _bce(py, ty_t)) * wgt
    loss_wh = (torch.abs(pw_ - tw_t) + torch.abs(ph_ - th_t)) * wgt
    loss_cls = _bce(pcls, tcls).sum(-1) * obj_t * tscore
    # objectness: ignore predictions overlapping any gt > thresh
    gxp = _div(torch.sigmoid(px) + torch.arange(w, dtype=torch.float32,
                                                device=dev), w)
    gyp = _div(torch.sigmoid(py) + torch.arange(h, dtype=torch.float32,
                                                device=dev)[:, None], h)
    bwp = torch.exp(pw_) * ma[:, 0][None, :, None, None]
    bhp = torch.exp(ph_) * ma[:, 1][None, :, None, None]
    p0x, p0y = gxp - bwp / 2, gyp - bhp / 2
    p1x, p1y = gxp + bwp / 2, gyp + bhp / 2
    g0x, g0y = gx - gw / 2, gy - gh / 2
    g1x, g1y = gx + gw / 2, gy + gh / 2
    ix = torch.clamp(
        torch.minimum(p1x[..., None], g1x[:, None, None, None]) -
        torch.maximum(p0x[..., None], g0x[:, None, None, None]), min=0.0)
    iy = torch.clamp(
        torch.minimum(p1y[..., None], g1y[:, None, None, None]) -
        torch.maximum(p0y[..., None], g0y[:, None, None, None]), min=0.0)
    inter_p = ix * iy
    union_p = (bwp * bhp)[..., None] + (gw * gh)[:, None, None, None] \
        - inter_p
    iou_p = inter_p / torch.clamp(union_p, min=1e-10)
    iou_p = torch.where(valid[:, None, None, None], iou_p, 0.0)
    ignore = (iou_p.amax(-1) > ignore_thresh) & (obj_t == 0)
    loss_obj = torch.where(
        ignore, 0.0,
        _bce(pobj, obj_t) * torch.where(obj_t > 0, tscore, 1.0))
    return (loss_xy + loss_wh + loss_obj).sum((1, 2, 3)) + \
        loss_cls.sum((1, 2, 3))


def matrix_nms(bboxes, scores, score_threshold, post_threshold=0.0,
               nms_top_k=400, keep_top_k=200, use_gaussian=False,
               gaussian_sigma=2.0, background_label=0, normalized=True,
               return_index=False, return_rois_num=True, name=None):
    """Matrix NMS (SOLOv2; reference vision/ops.py matrix_nms →
    matrix_nms_op): scores decay by pairwise IoU instead of hard
    suppression. Host-side, as the reference (dynamic counts; numpy's
    ranking)."""
    device = _t(bboxes).device
    bb = _host(bboxes).astype(np.float32)
    sc = _host(scores).astype(np.float32)
    n, m = sc.shape[0], sc.shape[2]
    outs, indices, counts = [], [], []
    offset = 0.0 if normalized else 1.0
    for b in range(n):
        dets_b = []
        idx_b = []
        for c in range(sc.shape[1]):
            if c == background_label:
                continue
            s = sc[b, c]
            keep = np.where(s > score_threshold)[0]
            if keep.size == 0:
                continue
            order = keep[np.argsort(-s[keep])][:nms_top_k]
            boxes_c = bb[b, order]
            s_c = s[order].copy()
            # pairwise IoU (upper triangle: j suppressed by higher i)
            x0, y0, x1, y1 = boxes_c.T
            area = (x1 - x0 + offset) * (y1 - y0 + offset)
            ix0 = np.maximum(x0[:, None], x0[None, :])
            iy0 = np.maximum(y0[:, None], y0[None, :])
            ix1 = np.minimum(x1[:, None], x1[None, :])
            iy1 = np.minimum(y1[:, None], y1[None, :])
            iw = np.maximum(ix1 - ix0 + offset, 0)
            ih = np.maximum(iy1 - iy0 + offset, 0)
            iou = iw * ih / np.maximum(
                area[:, None] + area[None, :] - iw * ih, 1e-10)
            iou = np.triu(iou, 1)
            iou_cmax = iou.max(0)
            if use_gaussian:
                decay = np.exp(-(iou ** 2 - iou_cmax[None, :] ** 2)
                               / gaussian_sigma).min(0)
            else:
                decay = ((1 - iou) / np.maximum(1 - iou_cmax[None, :],
                                                1e-10)).min(0)
            s_dec = s_c * decay
            for j in range(len(order)):
                if s_dec[j] > post_threshold:
                    dets_b.append([c, s_dec[j], *boxes_c[j]])
                    idx_b.append(b * m + order[j])
        if dets_b:
            dets_b = np.asarray(dets_b, np.float32)
            idx_b = np.asarray(idx_b, np.int64)
            top = np.argsort(-dets_b[:, 1])[:keep_top_k]
            dets_b, idx_b = dets_b[top], idx_b[top]
            outs.append(dets_b)
            indices.append(idx_b)
            counts.append(len(dets_b))
        else:
            counts.append(0)
    out = (np.concatenate(outs) if outs
           else np.zeros((0, 6), np.float32))
    index = (np.concatenate(indices) if indices
             else np.zeros((0,), np.int64))
    rets = [torch.as_tensor(out, device=device)]
    if return_index:
        rets.append(torch.as_tensor(index, device=device))
    if return_rois_num:
        rets.append(torch.as_tensor(np.asarray(counts, np.int32),
                                    device=device))
    return tuple(rets) if len(rets) > 1 else rets[0]


def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
               name=None):
    """Position-sensitive RoI pooling (reference vision/ops.py
    psroi_pool → psroi_pool_op): input channels C = out_c·ph·pw; output
    bin (i, j) average-pools its own channel group inside that bin, from
    an integral image (accumulated in float64; the reference's is f32)."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    ph, pw = output_size
    xv = _t(x)
    dev = xv.device
    bv = _t(boxes).to(device=dev, dtype=xv.dtype)
    n, c, hh, ww = xv.shape
    out_c = c // (ph * pw)
    bi = _img_of_roi(boxes_num, dev)
    rois = bv * spatial_scale
    x0, y0, x1, y1 = rois[:, 0:1], rois[:, 1:2], rois[:, 2:3], rois[:, 3:4]
    rh = _div(torch.clamp(y1 - y0, min=0.1), ph)
    rw = _div(torch.clamp(x1 - x0, min=0.1), pw)
    # the integral image in float64: in f32 its corners carry the
    # rounding of sums over up to H·W values, which the four-corner
    # difference then exposes (≈ 2e-5 of the output's scale at an FPN
    # level), and a different summation order per device shows it
    feats = xv.reshape(n, out_c, ph * pw, hh, ww).to(torch.float64)
    csum = torch.cumsum(torch.cumsum(feats, -1), -2)
    csum = TF.pad(csum, (1, 0, 1, 0))
    ip = torch.arange(ph, device=dev, dtype=xv.dtype)[None, :]
    jp = torch.arange(pw, device=dev, dtype=xv.dtype)[None, :]
    hs = torch.clamp(torch.floor(y0 + ip * rh).to(torch.int32), 0, hh)
    he = torch.clamp(torch.ceil(y0 + (ip + 1) * rh).to(torch.int32), 0, hh)
    ws = torch.clamp(torch.floor(x0 + jp * rw).to(torch.int32), 0, ww)
    we = torch.clamp(torch.ceil(x0 + (jp + 1) * rw).to(torch.int32), 0, ww)
    binid = (torch.arange(ph, device=dev)[:, None] * pw
             + torch.arange(pw, device=dev)[None, :])
    # csum as [n, ph·pw, H+1, W+1, out_c] rows: one gather per corner
    planes = csum.permute(0, 2, 3, 4, 1).reshape(-1, out_c)

    def corner(yy, xx):
        idx = (((bi[:, None, None] * (ph * pw) + binid[None]) * (hh + 1)
                + yy.long()[:, :, None]) * (ww + 1) + xx.long()[:, None, :])
        return planes[idx]                       # [R, ph, pw, out_c]

    total = (corner(he, we) - corner(hs, we) - corner(he, ws)
             + corner(hs, ws))
    cnt = torch.clamp((he - hs)[:, :, None] * (we - ws)[:, None, :], min=1)
    out = (total / cnt[..., None]).to(xv.dtype)
    return out.permute(0, 3, 1, 2)


class PSRoIPool:
    """Layer wrapper (reference vision/ops.py PSRoIPool)."""

    def __init__(self, output_size, spatial_scale=1.0):
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def __call__(self, x, boxes, boxes_num):
        return psroi_pool(x, boxes, boxes_num, self.output_size,
                          self.spatial_scale)


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable convolution v1 / v2 (reference vision/ops.py
    deform_conv2d → deformable_conv op): bilinear-sample the input at
    the offset positions of every kernel tap, then contract with the
    weight. offset: [N, 2·dg·kh·kw, H_out, W_out]; mask (v2):
    [N, dg·kh·kw, H_out, W_out]."""
    xv = _t(x)
    dev = xv.device
    ov = _t(offset).to(dev)
    wv = _t(weight).to(dev)
    mv = None if mask is None else _t(mask).to(dev)
    s = (stride, stride) if isinstance(stride, int) else tuple(stride)
    p = (padding, padding) if isinstance(padding, int) else tuple(padding)
    d = (dilation, dilation) if isinstance(dilation, int) else tuple(dilation)
    n, c, h, w = xv.shape
    out_c, cpg, kh, kw = wv.shape
    ho = (h + 2 * p[0] - d[0] * (kh - 1) - 1) // s[0] + 1
    wo = (w + 2 * p[1] - d[1] * (kw - 1) - 1) // s[1] + 1
    dg = deformable_groups
    cpg_d = c // dg
    ov = ov.reshape(n, dg, kh * kw, 2, ho, wo)
    # [n·dg·h·w, cpg_d] rows: one gather reads a sample's channels
    rows = xv.reshape(n, dg, cpg_d, h, w).permute(0, 1, 3, 4, 2).reshape(
        -1, cpg_d)
    base_y = (torch.arange(ho, device=dev) * s[0] - p[0])[:, None]
    base_x = (torch.arange(wo, device=dev) * s[1] - p[1])[None, :]
    plane = (torch.arange(n, device=dev)[:, None] * dg
             + torch.arange(dg, device=dev)[None, :])[:, :, None, None]
    taps = []
    for ki in range(kh):
        for kj in range(kw):
            tap = ki * kw + kj
            py = base_y + ki * d[0] + ov[:, :, tap, 0]   # [n, dg, ho, wo]
            px = base_x + kj * d[1] + ov[:, :, tap, 1]
            y0 = torch.floor(py)
            x0f = torch.floor(px)
            wy = py - y0
            wx = px - x0f
            vals = torch.zeros((n, dg, ho, wo, cpg_d), dtype=xv.dtype,
                               device=dev)
            for dy in (0, 1):
                for dx in (0, 1):
                    yy = (y0 + dy).to(torch.int32)
                    xx = (x0f + dx).to(torch.int32)
                    ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                    yy = torch.clamp(yy, 0, h - 1).long()
                    xx = torch.clamp(xx, 0, w - 1).long()
                    wgt = ((wy if dy == 1 else 1 - wy)
                           * (wx if dx == 1 else 1 - wx)
                           * ok).to(xv.dtype)
                    g = rows[(plane * h + yy) * w + xx]  # [n,dg,ho,wo,cpg_d]
                    vals = vals + g * wgt[..., None]
            if mv is not None:
                m_t = mv.reshape(n, dg, kh * kw, ho, wo)[:, :, tap]
                vals = vals * m_t[..., None]
            taps.append(vals.permute(0, 1, 4, 2, 3).reshape(n, c, ho, wo))
    patches = torch.stack(taps, 2)  # [n, c, kh·kw, ho, wo]
    pat = patches.reshape(n, groups, (c // groups) * kh * kw, ho * wo)
    wv2 = wv.reshape(groups, out_c // groups, cpg * kh * kw)
    out = torch.einsum("goc,ngcl->ngol", wv2, pat).reshape(n, out_c, ho, wo)
    if bias is not None:
        out = out + _t(bias).to(dev).reshape(1, -1, 1, 1)
    return out


def read_file(filename, name=None):
    """File bytes as a uint8 1-D tensor (reference vision/ops.py
    read_file)."""
    with open(filename, "rb") as f:
        data = np.frombuffer(f.read(), np.uint8).copy()
    return torch.from_numpy(data)


def decode_jpeg(x, mode="unchanged", name=None):
    """JPEG decode (reference vision/ops.py decode_jpeg → nvjpeg), by
    PIL, imported on use; raises where PIL is missing rather than
    producing wrong pixels. Returns [C, H, W] uint8."""
    try:
        import io

        from PIL import Image
    except ImportError:
        raise RuntimeError(
            "decode_jpeg requires an image codec (PIL), which this "
            "environment does not provide; decode on the host data "
            "pipeline before feeding tensors") from None
    img = Image.open(io.BytesIO(_host(x).tobytes()))
    if mode == "gray":
        img = img.convert("L")
    elif mode == "rgb":
        img = img.convert("RGB")
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return torch.from_numpy(arr.transpose(2, 0, 1).copy())


class DeformConv2D(torch.nn.Module):
    """Deformable conv layer owning weight / bias (reference vision/ops.py
    DeformConv2D)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        from ..nn.layer.layers import create_parameter

        k = ((kernel_size, kernel_size) if isinstance(kernel_size, int)
             else tuple(kernel_size))
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.deformable_groups = deformable_groups
        self.groups = groups
        self.weight = create_parameter(
            [out_channels, in_channels // groups, k[0], k[1]], weight_attr)
        self.bias = (None if bias_attr is False else create_parameter(
            [out_channels], bias_attr, is_bias=True))

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, self.weight, self.bias,
                             self.stride, self.padding, self.dilation,
                             self.deformable_groups, self.groups, mask)


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, pixel_offset=False,
                             rois_num=None, name=None):
    """Assign RoIs to FPN levels by scale (reference vision/ops.py
    distribute_fpn_proposals): the level on the device, the per-level
    split (dynamic counts) on the host."""
    r = _t(fpn_rois).to(torch.float32)
    dev = r.device
    off = 1.0 if pixel_offset else 0.0
    w = torch.clamp(r[:, 2] - r[:, 0] + off, min=0.0)
    h = torch.clamp(r[:, 3] - r[:, 1] + off, min=0.0)
    scale = torch.sqrt(w * h)
    lvl = torch.floor(torch.log2(_div(scale, refer_scale) + 1e-8)) \
        + refer_level
    lvl = _host(torch.clamp(lvl, min_level, max_level)).astype(np.int64)
    multi_rois, restore_parts, nums = [], [], []
    owner = None
    if rois_num is not None:
        bn = _host(rois_num).reshape(-1)
        owner = np.repeat(np.arange(len(bn)), bn)
    for level in range(min_level, max_level + 1):
        idx = np.where(lvl == level)[0]
        multi_rois.append(r[torch.as_tensor(idx, device=dev)])
        restore_parts.append(idx)
        if owner is not None:
            nums.append(torch.as_tensor(np.bincount(
                owner[idx], minlength=len(bn)).astype(np.int32),
                device=dev))
    order = np.concatenate(restore_parts) if restore_parts else \
        np.zeros((0,), np.int64)
    restore = np.empty_like(order)
    restore[order] = np.arange(len(order))
    restore_t = torch.as_tensor(restore.reshape(-1, 1), device=dev)
    if rois_num is not None:
        return multi_rois, restore_t, nums
    return multi_rois, restore_t


def generate_proposals(scores, bbox_deltas, img_size, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       pixel_offset=False, return_rois_num=False,
                       name=None):
    """RPN proposal generation (reference vision/ops.py
    generate_proposals → generate_proposals_v2 op): decode deltas against
    anchors, clip to the image, drop tiny boxes, top-k + NMS. The ranking
    is numpy's on the host (module docstring), the decode on the device.

    scores [N, A, H, W]; bbox_deltas [N, 4A, H, W]; anchors [H, W, A, 4];
    variances [H, W, A, 4]; img_size [N, 2] (h, w)."""
    sc_t = _t(scores).to(torch.float32)
    dev = sc_t.device
    dl = _t(bbox_deltas).to(device=dev, dtype=torch.float32)
    anc = _t(anchors).to(device=dev, dtype=torch.float32).reshape(-1, 4)
    var = _t(variances).to(device=dev, dtype=torch.float32).reshape(-1, 4)
    isz = _host(img_size).astype(np.float32)
    n, a, h, w = sc_t.shape
    off = 1.0 if pixel_offset else 0.0
    flat_s = sc_t.permute(0, 2, 3, 1).reshape(n, -1)       # [N, H·W·A]
    host_s = _host(flat_s)
    all_rois, all_scores, nums = [], [], []
    for b in range(n):
        order_np = np.argsort(-host_s[b])[:pre_nms_top_n]
        order = torch.as_tensor(order_np, device=dev)
        d = dl[b].reshape(a, 4, h, w).permute(2, 3, 0, 1).reshape(-1, 4)
        s_b = flat_s[b][order]
        d_b, an_b, va_b = d[order], anc[order], var[order]
        aw = an_b[:, 2] - an_b[:, 0] + off
        ah = an_b[:, 3] - an_b[:, 1] + off
        acx = an_b[:, 0] + aw * 0.5
        acy = an_b[:, 1] + ah * 0.5
        cx = va_b[:, 0] * d_b[:, 0] * aw + acx
        cy = va_b[:, 1] * d_b[:, 1] * ah + acy
        bw = aw * torch.exp(torch.clamp(va_b[:, 2] * d_b[:, 2], max=10.0))
        bh = ah * torch.exp(torch.clamp(va_b[:, 3] * d_b[:, 3], max=10.0))
        x0 = cx - bw * 0.5
        y0 = cy - bh * 0.5
        x1 = cx + bw * 0.5 - off
        y1 = cy + bh * 0.5 - off
        imh, imw = float(isz[b][0]), float(isz[b][1])
        x0 = torch.clamp(x0, 0, imw - off)
        y0 = torch.clamp(y0, 0, imh - off)
        x1 = torch.clamp(x1, 0, imw - off)
        y1 = torch.clamp(y1, 0, imh - off)
        keep = ((x1 - x0 + off) >= min_size) & ((y1 - y0 + off) >= min_size)
        boxes_b = torch.stack([x0, y0, x1, y1], -1)[keep]
        s_b = s_b[keep]
        if len(boxes_b):
            kept = nms(boxes_b, nms_thresh, scores=s_b)[:post_nms_top_n]
            boxes_b, s_b = boxes_b[kept], s_b[kept]
        all_rois.append(boxes_b)
        all_scores.append(s_b)
        nums.append(len(boxes_b))
    rets = (torch.cat(all_rois) if all_rois
            else torch.zeros((0, 4), device=dev),
            torch.cat(all_scores) if all_scores
            else torch.zeros((0,), device=dev))
    if return_rois_num:
        rets = rets + (torch.as_tensor(np.asarray(nums, np.int32),
                                       device=dev),)
    return rets


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5,
              min_max_aspect_ratios_order=False, name=None):
    """SSD prior (anchor) boxes for one feature map (reference phi
    prior_box kernel): (boxes [H, W, P, 4] normalized xmin / ymin / xmax
    / ymax, variances [H, W, P, 4]), on the input's device. The box
    table depends on shapes only and is built with numpy, as in the
    reference."""
    device = _t(input).device
    H, W = int(input.shape[2]), int(input.shape[3])
    Him, Wim = int(image.shape[2]), int(image.shape[3])
    step_w = steps[0] if steps and steps[0] > 0 else Wim / W
    step_h = steps[1] if len(steps) > 1 and steps[1] > 0 else Him / H
    ars = [1.0]
    for ar in aspect_ratios:
        if not any(abs(ar - e) < 1e-6 for e in ars):
            ars.append(float(ar))
            if flip:
                ars.append(1.0 / float(ar))
    # per-cell prior (w, h) list in the reference kernel's order:
    # default [min@ar1, other ars..., sqrt(min·max)];
    # min_max_aspect_ratios_order=True puts the max prior right after min
    whs = []
    for idx, ms in enumerate(min_sizes):
        ms = float(ms)

        def _max_prior():
            mx = float(max_sizes[idx])
            s = float(np.sqrt(ms * mx))
            whs.append((s, s))

        if min_max_aspect_ratios_order:
            whs.append((ms, ms))
            if max_sizes:
                _max_prior()
            for ar in ars:
                if abs(ar - 1.0) < 1e-6:
                    continue
                whs.append((ms * np.sqrt(ar), ms / np.sqrt(ar)))
        else:
            for ar in ars:
                whs.append((ms * np.sqrt(ar), ms / np.sqrt(ar)))
            if max_sizes:
                _max_prior()
    whs = np.asarray(whs, np.float32)  # [P, 2]
    P = whs.shape[0]
    cx = (np.arange(W, dtype=np.float32) + offset) * step_w
    cy = (np.arange(H, dtype=np.float32) + offset) * step_h
    cxg, cyg = np.meshgrid(cx, cy)  # [H, W]
    cxg = cxg[..., None]
    cyg = cyg[..., None]
    half_w = whs[None, None, :, 0] / 2.0
    half_h = whs[None, None, :, 1] / 2.0
    boxes = np.stack([
        (cxg - half_w) / Wim, (cyg - half_h) / Him,
        (cxg + half_w) / Wim, (cyg + half_h) / Him,
    ], axis=-1).astype(np.float32)  # [H, W, P, 4]
    if clip:
        boxes = np.clip(boxes, 0.0, 1.0)
    vars_ = np.broadcast_to(
        np.asarray(variance, np.float32), (H, W, P, 4)).copy()
    return (torch.as_tensor(boxes, device=device),
            torch.as_tensor(vars_, device=device))


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, axis=0,
              name=None):
    """Encode / decode boxes against priors (reference phi box_coder
    kernel). encode: target [N, 4] vs priors [M, 4] → [N, M, 4] deltas;
    decode: target [N, M, 4] (or [N, 4] broadcast by axis) → boxes."""
    pb = _t(prior_box).to(torch.float32)
    dev = pb.device
    tb = _t(target_box).to(device=dev, dtype=torch.float32)
    if prior_box_var is None:
        pbv = torch.ones_like(pb)
    elif isinstance(prior_box_var, (list, tuple)):
        pbv = torch.as_tensor(np.asarray(prior_box_var, np.float32),
                              device=dev).expand(pb.shape)
    else:
        pbv = _t(prior_box_var).to(device=dev, dtype=torch.float32)
    norm = 0.0 if box_normalized else 1.0
    pw = pb[:, 2] - pb[:, 0] + norm
    ph = pb[:, 3] - pb[:, 1] + norm
    pcx = pb[:, 0] + pw / 2.0
    pcy = pb[:, 1] + ph / 2.0
    if code_type == "encode_center_size":
        tw = tb[:, 2] - tb[:, 0] + norm
        th = tb[:, 3] - tb[:, 1] + norm
        tcx = tb[:, 0] + tw / 2.0
        tcy = tb[:, 1] + th / 2.0
        dx = (tcx[:, None] - pcx[None, :]) / pw[None, :]
        dy = (tcy[:, None] - pcy[None, :]) / ph[None, :]
        dw = torch.log(tw[:, None] / pw[None, :])
        dh = torch.log(th[:, None] / ph[None, :])
        out = torch.stack([dx, dy, dw, dh], dim=-1)  # [N, M, 4]
        return out / pbv[None, :, :]
    # decode_center_size
    t = tb if tb.dim() == 3 else tb[:, None, :]
    if axis == 0:
        pcx_b, pcy_b = pcx[None, :], pcy[None, :]
        pw_b, ph_b = pw[None, :], ph[None, :]
        v = pbv[None, :, :]
    else:
        pcx_b, pcy_b = pcx[:, None], pcy[:, None]
        pw_b, ph_b = pw[:, None], ph[:, None]
        v = pbv[:, None, :]
    d = t * v
    ocx = pcx_b + d[..., 0] * pw_b
    ocy = pcy_b + d[..., 1] * ph_b
    ow = torch.exp(d[..., 2]) * pw_b
    oh = torch.exp(d[..., 3]) * ph_b
    return torch.stack([ocx - ow / 2.0, ocy - oh / 2.0,
                        ocx + ow / 2.0 - norm,
                        ocy + oh / 2.0 - norm], dim=-1)


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None, name=None):
    """Levenshtein distance between token sequences (reference phi
    edit_distance kernel): a host DP loop, as the reference kernel's.
    input / label: [B, T] int (padded); *_length: [B] valid lengths →
    (distance [B, 1] float32, sequence_num [1] int64)."""
    device = _t(input).device
    a = _host(input)
    b = _host(label)
    B = a.shape[0]
    a_len = (_host(input_length).reshape(-1) if input_length is not None
             else np.full(B, a.shape[1], np.int64))
    b_len = (_host(label_length).reshape(-1) if label_length is not None
             else np.full(B, b.shape[1], np.int64))
    ignored = set(int(t) for t in (ignored_tokens or []))
    out = np.zeros((B, 1), np.float32)
    for i in range(B):
        s1 = [int(t) for t in a[i, : int(a_len[i])] if int(t) not in ignored]
        s2 = [int(t) for t in b[i, : int(b_len[i])] if int(t) not in ignored]
        n, m = len(s1), len(s2)
        dp = np.arange(m + 1, dtype=np.int64)
        for r in range(1, n + 1):
            prev = dp.copy()
            dp[0] = r
            for c in range(1, m + 1):
                dp[c] = min(prev[c] + 1, dp[c - 1] + 1,
                            prev[c - 1] + (s1[r - 1] != s2[c - 1]))
        dist = float(dp[m])
        if normalized:
            if m == 0:
                raise ValueError(
                    "edit_distance(normalized=True): reference string "
                    f"(label row {i}) is empty after filtering — the "
                    "normalized error rate is undefined")
            dist = dist / m
        out[i, 0] = dist
    return (torch.as_tensor(out, device=device),
            torch.as_tensor(np.asarray([B], np.int64), device=device))
