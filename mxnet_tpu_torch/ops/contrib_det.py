"""SSD's detection operators (reference: mxnet_tpu/ops/contrib_det.py, after
example/ssd/operator/multibox_*.{cc,cu}).

``MultiBoxPrior``, ``MultiBoxTarget`` and ``MultiBoxDetection`` as torch
ops over the whole batch at fixed shapes, as the reference's are ``jnp``
under ``vmap``: no host sync, no data-dependent shape, so each body runs
on ``meta`` tensors for shape inference and inside a captured step. Where
the reference's result depends on an order, the order is the reference's:
``argmax`` takes the first maximum, ``lax.top_k`` the lowest index among
equal values (:func:`~.tensor.top_k`), ``jnp.argsort`` is stable, and a
scatter with repeated indices keeps the last row's value.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import register_op
from .tensor import top_k


def _iou_matrix(a, b):
    """IoU between corner boxes ``a`` (..., N, 4) and ``b`` (..., M, 4):
    (..., N, M), 0 where the union is empty."""
    area_a = torch.clamp(a[..., 2] - a[..., 0], min=0.0) * \
        torch.clamp(a[..., 3] - a[..., 1], min=0.0)
    area_b = torch.clamp(b[..., 2] - b[..., 0], min=0.0) * \
        torch.clamp(b[..., 3] - b[..., 1], min=0.0)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


_CONSTANTS: dict = {}


def device_constant(key, make, device):
    """``make()`` (numpy or a CPU tensor) on ``device``, made once per key and
    device and kept: a captured CUDA graph may copy nothing from the host,
    so a constant is made by the eager run before the capture and the
    graph reads the kept tensor."""
    full = (key, str(device))
    t = _CONSTANTS.get(full)
    if t is None:
        t = _CONSTANTS[full] = torch.as_tensor(make(), device=device)
    return t


def _tuple(v, default):
    v = default if v is None else v
    return (v,) if isinstance(v, (int, float)) else tuple(v)


@register_op("MultiBoxPrior", alias=("_contrib_MultiBoxPrior",))
def _multibox_prior(ctx, attrs, data):
    """Anchor boxes (1, H*W*A, 4) for each cell of ``data``'s (H, W), row
    by row, A = len(sizes) + len(ratios) - 1 a cell: each size at
    ratios[0], then sizes[0] at each further ratio; centred at ``(i +
    offset) * step`` (step 1/H and 1/W unless ``steps`` gives it). Depends
    on ``data``'s shape only: made on the CPU once per shape and device
    (:func:`device_constant`)."""
    sizes = _tuple(attrs.get("sizes"), (1.0,))
    ratios = _tuple(attrs.get("ratios"), (1.0,))
    steps = attrs.get("steps", (-1.0, -1.0))
    offsets = attrs.get("offsets", (0.5, 0.5))
    h, w = data.shape[2], data.shape[3]
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w

    def make():
        cy = (torch.arange(h, dtype=torch.float32) + offsets[0]) * step_y
        cx = (torch.arange(w, dtype=torch.float32) + offsets[1]) * step_x
        cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
        centers = torch.stack([cxg.reshape(-1), cyg.reshape(-1)], dim=-1)
        whs = [(s * np.sqrt(ratios[0]), s / np.sqrt(ratios[0]))
               for s in sizes]
        whs += [(sizes[0] * np.sqrt(r), sizes[0] / np.sqrt(r))
                for r in ratios[1:]]
        half = torch.from_numpy(np.asarray(whs, np.float32)) / 2.0
        mins = centers[:, None, :] - half[None, :, :]
        maxs = centers[:, None, :] + half[None, :, :]
        return torch.cat([mins, maxs], dim=-1).reshape(1, -1, 4)

    key = ("MultiBoxPrior", h, w, sizes, ratios, tuple(steps), tuple(offsets))
    return device_constant(key, make, data.device)


def _last_writer(best_anchor, na):
    """For each anchor, the last row g with ``best_anchor[g]`` equal to it
    (-1 if none): (B, A). The reference's ``zeros.at[best_anchor].set(v)``
    keeps the last row's value where rows repeat an anchor; a one-hot and
    the largest row index give that order without a scatter (whose order
    on repeated indices the card does not define)."""
    g = best_anchor.shape[1]
    hit = best_anchor[:, :, None] == torch.arange(
        na, device=best_anchor.device)
    rows = torch.arange(g, device=best_anchor.device)[None, :, None]
    return torch.where(hit, rows, -1).amax(dim=1)


@register_op("MultiBoxTarget", inputs=("anchor", "label", "cls_pred"),
             num_outputs=3, alias=("_contrib_MultiBoxTarget",))
def _multibox_target(ctx, attrs, anchor, label, cls_pred):
    """Match anchors to ground truth: ``[loc_target (B, A*4), loc_mask (B,
    A*4), cls_target (B, A)]``. ``label`` is (B, G, 5) rows [cls, xmin,
    ymin, xmax, ymax], cls -1 for padding. An anchor is positive at IoU >=
    ``overlap_threshold`` with its best box, or as some valid box's best
    anchor; its class target is the box's class + 1 (0 background). With
    ``negative_mining_ratio`` > 0 the negatives are ranked by their largest
    non-background softmax of ``cls_pred`` (stable, hardest first) and all
    but ``ratio * positives`` of them get -1 (ignored). Regression targets
    are the centre-size encoding over ``variances``. The outputs are
    targets: nothing here is differentiated."""
    iou_thresh = float(attrs.get("overlap_threshold", 0.5))
    variances = attrs.get("variances", (0.1, 0.1, 0.2, 0.2))
    ratio = float(attrs.get("negative_mining_ratio", -1))
    with torch.no_grad():
        anchors = anchor.detach().reshape(-1, 4)
        label = label.detach()
        na = anchors.shape[0]
        valid = label[..., 0] >= 0                       # (B, G)
        gt_boxes = label[..., 1:5]                       # (B, G, 4)
        iou = _iou_matrix(anchors.expand(label.shape[0], na, 4), gt_boxes)
        iou = torch.where(valid[:, None, :], iou, torch.full_like(iou, -1.0))
        best_gt = torch.argmax(iou, dim=2)               # (B, A)
        best_iou = torch.amax(iou, dim=2)
        writer = _last_writer(torch.argmax(iou, dim=1), na)
        forced = (writer >= 0) & torch.gather(valid, 1, writer.clamp(min=0))
        pos = (best_iou >= iou_thresh) | forced
        cls_t = torch.where(
            pos, torch.gather(label[..., 0], 1, best_gt) + 1.0,
            torch.zeros((), dtype=label.dtype, device=label.device))
        if ratio > 0:
            conf = torch.softmax(cls_pred.detach(), dim=1)
            hardness = torch.where(pos, float("-inf"),
                                   torch.amax(conf[:, 1:], dim=1))
            order = torch.argsort(-hardness, dim=1, stable=True)
            rank = torch.empty_like(order).scatter_(
                1, order, torch.arange(na, device=order.device).expand_as(
                    order).contiguous())
            keep_n = ratio * pos.sum(dim=1, keepdim=True).to(torch.float32)
            ignored = ~pos & (rank.to(torch.float32) >= keep_n)
            cls_t = torch.where(ignored, torch.full_like(cls_t, -1.0), cls_t)
        aw = anchors[:, 2] - anchors[:, 0]
        ah = anchors[:, 3] - anchors[:, 1]
        acx = (anchors[:, 0] + anchors[:, 2]) / 2
        acy = (anchors[:, 1] + anchors[:, 3]) / 2
        g = torch.gather(gt_boxes, 1, best_gt[..., None].expand(-1, -1, 4))
        gw = torch.clamp(g[..., 2] - g[..., 0], min=1e-8)
        gh = torch.clamp(g[..., 3] - g[..., 1], min=1e-8)
        gcx = (g[..., 0] + g[..., 2]) / 2
        gcy = (g[..., 1] + g[..., 3]) / 2
        tx = (gcx - acx) / (aw * variances[0])
        ty = (gcy - acy) / (ah * variances[1])
        tw = torch.log(gw / aw) / variances[2]
        th = torch.log(gh / ah) / variances[3]
        mask = pos.to(torch.float32)[..., None].expand(-1, -1, 4)
        loc_t = torch.stack([tx, ty, tw, th], dim=-1) * mask
        b = label.shape[0]
        return loc_t.reshape(b, -1), mask.reshape(b, -1), cls_t


def _decode(anchors, locs, variances):
    """Centre-size decoding of ``locs`` (B, A, 4) against ``anchors`` (A,
    4) into corner boxes (B, A, 4)."""
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    cx = locs[..., 0] * variances[0] * aw + acx
    cy = locs[..., 1] * variances[1] * ah + acy
    w = torch.exp(locs[..., 2] * variances[2]) * aw
    h = torch.exp(locs[..., 3] * variances[3]) * ah
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def _suppressed(iou, score, thresh, same=None):
    """Matrix NMS: entry i of the score-sorted list is suppressed when some
    entry j with a positive score that ranks above it (a higher score, or
    an equal one earlier in the list) overlaps it by more than ``thresh``
    (and, with ``same``, has its class). (B, k) from (B, k, k) and (B,
    k)."""
    k = score.shape[-1]
    idx = torch.arange(k, device=score.device)
    sj, si = score[:, None, :], score[:, :, None]
    higher = (sj > si) | ((sj == si) & (idx[None, :] < idx[:, None]))
    hit = (iou > thresh) & higher & (sj > 0)
    if same is not None:
        hit = hit & same
    return hit.any(dim=2)


@register_op("MultiBoxDetection", inputs=("cls_prob", "loc_pred", "anchor"),
             alias=("_contrib_MultiBoxDetection",))
def _multibox_detection(ctx, attrs, cls_prob, loc_pred, anchor):
    """Decode and per-class NMS: (B, A, 6) rows [cls_id, score, xmin,
    ymin, xmax, ymax] from ``cls_prob`` (B, C+1, A), background at 0. The
    first ``min(nms_topk, A)`` rows are the top scores in ``lax.top_k``'s
    order (a score at or below ``threshold`` counts as -1); a row that is
    not kept has cls_id -1 and keeps its score and box; the rest are -1."""
    thresh = float(attrs.get("threshold", 0.01))
    nms_thresh = float(attrs.get("nms_threshold", 0.5))
    variances = attrs.get("variances", (0.1, 0.1, 0.2, 0.2))
    nms_topk = int(attrs.get("nms_topk", 400))
    anchors = anchor.reshape(-1, 4)
    b, na = cls_prob.shape[0], anchors.shape[0]
    boxes = _decode(anchors, loc_pred.reshape(b, na, 4), variances)
    scores = cls_prob[:, 1:]                            # (B, C, A)
    cls_id = torch.argmax(scores, dim=1)
    score = torch.amax(scores, dim=1)
    k = min(nms_topk, na)
    top_score, top_idx = top_k(
        torch.where(score > thresh, score, torch.full_like(score, -1.0)), k)
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    top_cls = torch.gather(cls_id, 1, top_idx)
    iou = _iou_matrix(top_boxes, top_boxes)
    same = top_cls[:, :, None] == top_cls[:, None, :]
    valid = (top_score > 0) & ~_suppressed(iou, top_score, nms_thresh, same)
    ids = torch.where(valid, top_cls.to(cls_prob.dtype),
                      torch.full_like(top_score, -1.0))
    out = torch.cat([ids[..., None], top_score[..., None], top_boxes], dim=-1)
    pad = torch.full((b, na - k, 6), -1.0, dtype=out.dtype, device=out.device)
    return torch.cat([out, pad], dim=1)
