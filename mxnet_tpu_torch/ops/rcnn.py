"""Faster R-CNN's region-proposal op (reference: mxnet_tpu/ops/rcnn.py,
after example/rcnn/rcnn/symbol/proposal.py and
rcnn/processing/generate_anchor.py).

``Proposal`` at fixed shapes over the whole batch, as the reference's is
``jnp`` under ``vmap``: decode every anchor, clip, drop boxes under the
minimum size, take the top ``rpn_pre_nms_top_n`` scores, matrix NMS
(suppressed by any higher-ranked overlapping box), then the top
``rpn_post_nms_top_n`` survivors, slots with no survivor filled with the
best box. Top-k takes ``lax.top_k``'s order (:func:`~.tensor.top_k`) and
``argmax`` the first maximum. The anchor helpers are numpy, as the
reference's; the anchor field is a constant kept on the input's device
(:func:`~.contrib_det.device_constant`).
"""
from __future__ import annotations

import numpy as np
import torch

from .contrib_det import _suppressed, device_constant
from .registry import register_op
from .tensor import top_k


def _iou_matrix_plus1(a, b):
    """IoU with the +1 pixel convention (width = x2 - x1 + 1) between
    (..., N, 4) and (..., M, 4) corner boxes, as the reference's
    ``bbox_overlaps``."""
    area_a = (a[..., 2] - a[..., 0] + 1) * (a[..., 3] - a[..., 1] + 1)
    area_b = (b[..., 2] - b[..., 0] + 1) * (b[..., 3] - b[..., 1] + 1)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt + 1, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def generate_base_anchors(scales, ratios, base_size=16):
    """(k, 4) corner-form anchors centred on (0, 0), k = len(scales) *
    len(ratios), ratios outer (reference: generate_anchor.py)."""
    anchors = []
    for r in ratios:
        size = base_size * base_size
        ws = np.round(np.sqrt(size / r))
        hs = np.round(ws * r)
        for s in scales:
            w, h = ws * s, hs * s
            anchors.append([-(w - 1) / 2, -(h - 1) / 2,
                            (w - 1) / 2, (h - 1) / 2])
    return np.array(anchors, np.float32)


def full_anchor_field(feat_h, feat_w, stride, scales, ratios,
                      base_size=None):
    """(feat_h * feat_w * k, 4) anchors over the feature map, row-major over
    (y, x, k), the order the RPN heads' (2k, H, W) maps flatten to.
    ``base_size`` defaults to the stride, so scale s means s * stride
    pixels."""
    base = generate_base_anchors(scales, ratios, base_size or stride)
    sx = (np.arange(feat_w) * stride)[None, :, None]
    sy = (np.arange(feat_h) * stride)[:, None, None]
    shift = np.stack(
        [np.broadcast_to(sx, (feat_h, feat_w, 1)),
         np.broadcast_to(sy, (feat_h, feat_w, 1))] * 2, axis=-1
    ).reshape(feat_h, feat_w, 1, 4)
    return (shift + base[None, None]).reshape(-1, 4).astype(np.float32)


@register_op("Proposal", inputs=("cls_prob", "bbox_pred", "im_info"),
             alias=("_contrib_Proposal",))
def _proposal(ctx, attrs, cls_prob, bbox_pred, im_info):
    """RPN scores and deltas to proposals: (N * rpn_post_nms_top_n, 5) rows
    [batch_idx, x1, y1, x2, y2]. ``cls_prob`` is (N, 2k, H, W), the k
    background maps then the k foreground ones; ``bbox_pred`` (N, 4k, H,
    W); ``im_info`` (N, 3) rows [height, width, scale]."""
    stride = int(attrs.get("feature_stride", 16))
    scales = tuple(float(s) for s in attrs.get("scales", (8, 16, 32)))
    ratios = tuple(float(r) for r in attrs.get("ratios", (0.5, 1, 2)))
    pre_n = int(attrs.get("rpn_pre_nms_top_n", 6000))
    post_n = int(attrs.get("rpn_post_nms_top_n", 300))
    nms_thresh = float(attrs.get("threshold", 0.7))
    min_size = float(attrs.get("rpn_min_size", 16))

    n, twok, fh, fw = cls_prob.shape
    k = twok // 2
    anchors = device_constant(
        ("Proposal", fh, fw, stride, scales, ratios),
        lambda: full_anchor_field(fh, fw, stride, scales, ratios),
        cls_prob.device)
    na = anchors.shape[0]
    aw = anchors[:, 2] - anchors[:, 0] + 1
    ah = anchors[:, 3] - anchors[:, 1] + 1
    acx = anchors[:, 0] + aw / 2
    acy = anchors[:, 1] + ah / 2

    fg = cls_prob[:, k:].permute(0, 2, 3, 1).reshape(n, -1)        # (N, A)
    d = bbox_pred.reshape(n, k, 4, fh, fw).permute(0, 3, 4, 1, 2) \
        .reshape(n, -1, 4)
    cx = d[..., 0] * aw + acx
    cy = d[..., 1] * ah + acy
    w = torch.exp(torch.clamp(d[..., 2], -10, 10)) * aw
    h = torch.exp(torch.clamp(d[..., 3], -10, 10)) * ah
    zero = torch.zeros((), dtype=cx.dtype, device=cx.device)
    xmax = (im_info[:, 1] - 1)[:, None]
    ymax = (im_info[:, 0] - 1)[:, None]
    boxes = torch.stack([
        torch.minimum(torch.maximum(cx - (w - 1) / 2, zero), xmax),
        torch.minimum(torch.maximum(cy - (h - 1) / 2, zero), ymax),
        torch.minimum(torch.maximum(cx + (w - 1) / 2, zero), xmax),
        torch.minimum(torch.maximum(cy + (h - 1) / 2, zero), ymax)], dim=-1)
    ms = (min_size * im_info[:, 2])[:, None]
    keep = ((boxes[..., 2] - boxes[..., 0] + 1 >= ms)
            & (boxes[..., 3] - boxes[..., 1] + 1 >= ms))
    kk = min(pre_n, na)
    top_score, top_idx = top_k(
        torch.where(keep, fg, torch.full_like(fg, -1.0)), kk)
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    iou = _iou_matrix_plus1(top_boxes, top_boxes)
    dead = _suppressed(iou, top_score, nms_thresh) | (top_score <= 0)
    final = torch.where(dead, torch.full_like(top_score, -1.0), top_score)
    out_score, out_idx = top_k(final, min(post_n, kk))
    rois = torch.gather(top_boxes, 1, out_idx[..., None].expand(-1, -1, 4))
    best = torch.gather(top_boxes, 1, torch.argmax(final, dim=1)[:, None, None]
                        .expand(-1, 1, 4))                       # (N, 1, 4)
    rois = torch.where((out_score > 0)[..., None], rois, best)
    if post_n > kk:
        rois = torch.cat([rois, best.expand(-1, post_n - kk, 4)], dim=1)
    batch_ix = torch.arange(n, dtype=rois.dtype, device=rois.device)[
        :, None, None].expand(n, post_n, 1)
    return torch.cat([batch_ix, rois], dim=-1).reshape(-1, 5)
