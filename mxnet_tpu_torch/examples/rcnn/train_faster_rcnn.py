#!/usr/bin/env python
"""Faster R-CNN with its two stages trained jointly in one graph
(reference: example/rcnn/train_faster_rcnn.py, after rcnn/symbol/
symbol_vgg.py, proposal.py, proposal_target.py and core/loader.py) on
synthetic scenes of a square or a cross:

  backbone convs -> RPN head (2k cls, 4k bbox)          [rpn losses]
    -> Proposal (anchor decode and NMS, in the graph)
    -> ProposalTarget, a Custom op (fg/bg sampling and targets, host numpy)
    -> ROIPooling -> FC heads (per-ROI cls and bbox deltas) [rcnn losses]

``train_and_eval`` trains it (Adam) and scores the test graph's top
detection per fresh scene: class accuracy and mean IoU. The ``Custom``
node runs host code, so the module's step is not captured as a CUDA graph
(``Module.step_info()`` names the node); it runs eagerly on the card.

Run on the card: ``python -m mxnet_tpu_torch.examples.rcnn.
train_faster_rcnn [--epochs 10]``; on the CPU: ``--cpu``.
"""
from __future__ import annotations

import argparse

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.io import DataBatch
from mxnet_tpu_torch.ops.rcnn import full_anchor_field

IMG = 64
STRIDE = 4
FEAT = IMG // STRIDE
SCALES = (3.0, 4.0, 5.0)   # 12/16/20 px anchors at base size STRIDE
RATIOS = (1.0,)
K = len(SCALES) * len(RATIOS)
NUM_CLASSES = 3            # background, square, cross
ROIS_PER_IMG = 16
FG_FRACTION = 0.5
POST_NMS = 24
# per-coordinate bbox-target normalisation (reference:
# config.TRAIN.BBOX_STDS)
BBOX_STDS = np.array([0.1, 0.1, 0.2, 0.2], np.float32)
DATA_NAMES = ("data", "gt_boxes", "rpn_bbox_target", "rpn_bbox_weight",
              "im_info")


def anchors_np():
    return full_anchor_field(FEAT, FEAT, STRIDE, SCALES, RATIOS)


# --------------------------------------------------------------- scene data
def draw_scene(rng):
    x = rng.randn(IMG, IMG).astype(np.float32) * 0.05
    cls = rng.randint(0, 2)            # 0 = square, 1 = cross
    size = rng.randint(12, 22)
    x0 = rng.randint(2, IMG - size - 2)
    y0 = rng.randint(2, IMG - size - 2)
    if cls == 0:
        x[y0:y0 + size, x0:x0 + size] = 1.0
    else:
        mid = size // 2
        x[y0 + mid - 2:y0 + mid + 2, x0:x0 + size] = 1.0
        x[y0:y0 + size, x0 + mid - 2:x0 + mid + 2] = 1.0
    gt = np.array([x0, y0, x0 + size - 1, y0 + size - 1], np.float32)
    return x[None], gt, cls + 1        # class ids 1/2; 0 is background


def iou_np(a, b):
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(0.0, rb - lt + 1)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def bbox_transform(rois, gt):
    """Deltas (dx, dy, dw, dh) that move ``rois`` onto ``gt`` (reference:
    rcnn/processing/bbox_transform.py)."""
    rw = rois[:, 2] - rois[:, 0] + 1
    rh = rois[:, 3] - rois[:, 1] + 1
    rcx = rois[:, 0] + rw / 2
    rcy = rois[:, 1] + rh / 2
    gw = gt[:, 2] - gt[:, 0] + 1
    gh = gt[:, 3] - gt[:, 1] + 1
    gcx = gt[:, 0] + gw / 2
    gcy = gt[:, 1] + gh / 2
    return np.stack([(gcx - rcx) / rw, (gcy - rcy) / rh,
                     np.log(gw / rw), np.log(gh / rh)], axis=-1)


def anchor_targets(gt_box, rng):
    """RPN labels (1 fg, 0 bg, -1 ignored), targets and weights for one
    image (reference: AnchorLoader)."""
    anc = anchors_np()
    na = anc.shape[0]
    inside = ((anc[:, 0] >= -8) & (anc[:, 1] >= -8)
              & (anc[:, 2] < IMG + 8) & (anc[:, 3] < IMG + 8))
    iou = iou_np(anc, gt_box[None])[:, 0]
    labels = np.full(na, -1, np.float32)
    labels[inside & (iou < 0.3)] = 0
    labels[inside & (iou >= 0.55)] = 1
    labels[np.argmax(iou)] = 1         # the best anchor is always positive
    neg = np.where(labels == 0)[0]
    keep_neg = min(3 * int((labels == 1).sum()) + 8, len(neg))
    labels[rng.permutation(neg)[keep_neg:]] = -1
    targets = np.zeros((na, 4), np.float32)
    pos = labels == 1
    targets[pos] = bbox_transform(anc[pos], np.repeat(gt_box[None],
                                                      pos.sum(), axis=0))
    weights = np.zeros((na, 4), np.float32)
    weights[pos] = 1.0
    return labels, targets, weights


def make_batch(rng, n):
    imgs = np.zeros((n, 1, IMG, IMG), np.float32)
    gts = np.zeros((n, 5), np.float32)          # [cls, x1, y1, x2, y2]
    rpn_label = np.zeros((n, K * FEAT * FEAT), np.float32)
    rpn_target = np.zeros((n, 4 * K, FEAT, FEAT), np.float32)
    rpn_weight = np.zeros((n, 4 * K, FEAT, FEAT), np.float32)
    for i in range(n):
        imgs[i], gt, cls = draw_scene(rng)
        gts[i] = [cls, *gt]
        lab, tgt, wgt = anchor_targets(gt, rng)
        rpn_label[i] = lab
        # (A, 4) row-major over (y, x, k) -> (4k, H, W)
        rpn_target[i] = tgt.reshape(FEAT, FEAT, K * 4).transpose(2, 0, 1)
        rpn_weight[i] = wgt.reshape(FEAT, FEAT, K * 4).transpose(2, 0, 1)
    im_info = np.tile(np.array([IMG, IMG, 1.0], np.float32), (n, 1))
    return imgs, gts, rpn_label, rpn_target, rpn_weight, im_info


def to_batch(arrays, ctx):
    """A ``DataBatch`` on ``ctx`` in ``DATA_NAMES``' order."""
    imgs, gts, rl, rt, rw_, info = arrays
    return DataBatch(data=[mx.nd.array(a, ctx)
                           for a in (imgs, gts, rt, rw_, info)],
                     label=[mx.nd.array(rl, ctx)])


# ------------------------------------------------- ProposalTarget custom op
@mx.operator.register("proposal_target_toy")
class ProposalTargetProp(mx.operator.CustomOpProp):
    """Sample fg/bg ROIs and per-ROI cls and bbox targets (reference:
    rcnn/symbol/proposal_target.py)."""

    def __init__(self, batch_images="0"):
        super().__init__(need_top_grad=False)
        self._n = int(batch_images)

    def list_arguments(self):
        return ["rois", "gt_boxes"]

    def list_outputs(self):
        return ["rois_out", "label", "bbox_target", "bbox_weight"]

    def infer_shape(self, in_shape):
        r = self._n * ROIS_PER_IMG
        return in_shape, [[r, 5], [r], [r, 4 * NUM_CLASSES],
                          [r, 4 * NUM_CLASSES]], []

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return ProposalTargetOp(self._n)


class ProposalTargetOp(mx.operator.CustomOp):
    """Draws from ``RandomState(11)`` made with the operator, as the
    reference's: the backward's fresh operator draws the forward's
    sample again."""

    def __init__(self, n):
        self._n = n
        self._rng = np.random.RandomState(11)

    def forward(self, is_train, req, in_data, out_data, aux):
        rois = in_data[0].asnumpy()          # (N * POST_NMS, 5)
        gts = in_data[1].asnumpy()           # (N, 5) [cls, box]
        out_r = np.zeros((self._n * ROIS_PER_IMG, 5), np.float32)
        out_l = np.zeros(self._n * ROIS_PER_IMG, np.float32)
        out_t = np.zeros((self._n * ROIS_PER_IMG, 4 * NUM_CLASSES),
                         np.float32)
        out_w = np.zeros_like(out_t)
        fg_per = int(ROIS_PER_IMG * FG_FRACTION)
        for i in range(self._n):
            r = rois[rois[:, 0] == i][:, 1:]
            # the ground-truth box joins the candidates, as in the reference
            r = np.concatenate([r, gts[i:i + 1, 1:]], axis=0)
            iou = iou_np(r, gts[i:i + 1, 1:])[:, 0]
            fg = np.where(iou >= 0.5)[0]
            bg = np.where(iou < 0.5)[0]
            pick_fg = self._rng.permutation(fg)[:fg_per]
            need_bg = ROIS_PER_IMG - len(pick_fg)
            pick_bg = self._rng.permutation(bg)[:need_bg]
            if len(pick_bg) < need_bg:    # too few: pad with repeats
                pad = self._rng.choice(np.concatenate([fg, bg]),
                                       need_bg - len(pick_bg))
                pick_bg = np.concatenate([pick_bg, pad])
            pick = np.concatenate([pick_fg, pick_bg]).astype(int)
            sl = slice(i * ROIS_PER_IMG, (i + 1) * ROIS_PER_IMG)
            out_r[sl, 0] = i
            out_r[sl, 1:] = r[pick]
            lab = np.where(iou[pick] >= 0.5, gts[i, 0], 0.0)
            out_l[sl] = lab
            deltas = bbox_transform(r[pick], np.repeat(gts[i:i + 1, 1:],
                                                       len(pick), axis=0))
            for j, (c, dl) in enumerate(zip(lab, deltas)):
                if c > 0:
                    c4 = int(c) * 4
                    out_t[sl.start + j, c4:c4 + 4] = dl / BBOX_STDS
                    out_w[sl.start + j, c4:c4 + 4] = 1.0
        for dst, r_, src in zip(out_data, req, (out_r, out_l, out_t, out_w)):
            self.assign(dst, r_, src)

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        for g in in_grad:                     # targets are data
            self.assign(g, "write", mx.nd.zeros(g.shape, g.context))


# ------------------------------------------------------------------ symbols
def backbone(data):
    b = mx.sym.Convolution(data, num_filter=16, kernel=(3, 3), pad=(1, 1),
                           name="c1")
    b = mx.sym.Activation(b, act_type="relu")
    b = mx.sym.Pooling(b, kernel=(2, 2), stride=(2, 2), pool_type="max")
    b = mx.sym.Convolution(b, num_filter=32, kernel=(3, 3), pad=(1, 1),
                           name="c2")
    b = mx.sym.Activation(b, act_type="relu")
    b = mx.sym.Pooling(b, kernel=(2, 2), stride=(2, 2), pool_type="max")
    b = mx.sym.Convolution(b, num_filter=32, kernel=(3, 3), pad=(1, 1),
                           name="c3")
    return mx.sym.Activation(b, act_type="relu")


def _rpn(feat, batch):
    """The RPN head: (scores reshaped to (N, 2, H*W*k), bbox deltas)."""
    rpn = mx.sym.Convolution(feat, num_filter=32, kernel=(3, 3), pad=(1, 1),
                             name="rpn_conv")
    rpn = mx.sym.Activation(rpn, act_type="relu")
    rpn_cls = mx.sym.Convolution(rpn, num_filter=2 * K, kernel=(1, 1),
                                 name="rpn_cls_score")
    rpn_bbox = mx.sym.Convolution(rpn, num_filter=4 * K, kernel=(1, 1),
                                  name="rpn_bbox_pred")
    # (N, 2k, H, W) -> (N, 2, H*W*k): anchors flatten row-major over (y, x,
    # k), the order of anchor_targets' labels
    cls_r = mx.sym.Reshape(
        mx.sym.transpose(
            mx.sym.Reshape(rpn_cls, shape=(batch, K, 2, FEAT * FEAT)),
            axes=(0, 2, 3, 1)),
        shape=(batch, 2, FEAT * FEAT * K))
    return cls_r, rpn_bbox


def _kfast(probs, batch):
    """(N, 2, H*W*k) probabilities back to (N, 2k, H, W), k fastest, as
    full_anchor_field lays anchors out."""
    fg_bg = mx.sym.Reshape(probs, shape=(batch, 2, FEAT, FEAT, K))
    return mx.sym.Reshape(mx.sym.transpose(fg_bg, axes=(0, 1, 4, 2, 3)),
                          shape=(batch, 2 * K, FEAT, FEAT))


def _proposal(prob_kfast, rpn_bbox, im_info):
    return mx.sym.Proposal(
        prob_kfast, rpn_bbox, im_info, feature_stride=STRIDE, scales=SCALES,
        ratios=RATIOS, rpn_pre_nms_top_n=200, rpn_post_nms_top_n=POST_NMS,
        threshold=0.7, rpn_min_size=6, name="rois")


def _heads(feat, rois):
    pooled = mx.sym.ROIPooling(feat, rois, pooled_size=(6, 6),
                               spatial_scale=1.0 / STRIDE, name="roi_pool")
    flat = mx.sym.Flatten(pooled)
    fc = mx.sym.FullyConnected(flat, num_hidden=128, name="fc6")
    fc = mx.sym.Activation(fc, act_type="relu")
    cls_score = mx.sym.FullyConnected(fc, num_hidden=NUM_CLASSES,
                                      name="cls_score")
    bbox_pred = mx.sym.FullyConnected(fc, num_hidden=4 * NUM_CLASSES,
                                      name="bbox_pred")
    return cls_score, bbox_pred


def get_train_symbol(batch):
    data = mx.sym.Variable("data")
    gt_boxes = mx.sym.Variable("gt_boxes")
    rpn_label = mx.sym.Variable("rpn_label")
    rpn_target = mx.sym.Variable("rpn_bbox_target")
    rpn_weight = mx.sym.Variable("rpn_bbox_weight")
    im_info = mx.sym.Variable("im_info")

    feat = backbone(data)
    cls_r, rpn_bbox = _rpn(feat, batch)
    rpn_cls_loss = mx.sym.SoftmaxOutput(
        cls_r, label=rpn_label, multi_output=True, use_ignore=True,
        ignore_label=-1, normalization="valid", name="rpn_cls_prob")
    rpn_bbox_loss = mx.sym.MakeLoss(
        mx.sym.sum(rpn_weight * mx.sym.smooth_l1(rpn_bbox - rpn_target,
                                                 scalar=3.0)) / batch,
        name="rpn_bbox_loss")
    # the proposal layer reads the softmaxed scores, detached: the RPN
    # trains by its own losses
    prob_kfast = _kfast(mx.sym.BlockGrad(mx.sym.softmax(cls_r, axis=1)),
                        batch)
    rois = _proposal(prob_kfast, mx.sym.BlockGrad(rpn_bbox), im_info)
    tgt = mx.sym.Custom(rois, gt_boxes, op_type="proposal_target_toy",
                        batch_images=str(batch), name="ptarget")
    rois_s, label_s, bbox_t, bbox_w = (tgt[0], tgt[1], tgt[2], tgt[3])
    cls_score, bbox_pred = _heads(feat, mx.sym.BlockGrad(rois_s))
    cls_loss = mx.sym.SoftmaxOutput(cls_score, label=label_s,
                                    normalization="batch", name="cls_prob")
    bbox_loss = mx.sym.MakeLoss(
        mx.sym.sum(bbox_w * mx.sym.smooth_l1(bbox_pred - bbox_t,
                                             scalar=1.0))
        / (batch * ROIS_PER_IMG), name="bbox_loss")
    return mx.sym.Group([rpn_cls_loss, rpn_bbox_loss, cls_loss, bbox_loss,
                         mx.sym.BlockGrad(rois_s), mx.sym.BlockGrad(label_s)])


def get_test_symbol(batch):
    """Inference graph: RPN proposals, then the heads (reference:
    get_vgg_test)."""
    data = mx.sym.Variable("data")
    im_info = mx.sym.Variable("im_info")
    feat = backbone(data)
    cls_r, rpn_bbox = _rpn(feat, batch)
    prob_kfast = _kfast(mx.sym.softmax(cls_r, axis=1), batch)
    rois = _proposal(prob_kfast, rpn_bbox, im_info)
    cls_score, bbox_pred = _heads(feat, rois)
    cls_prob = mx.sym.softmax(cls_score, axis=-1)
    return mx.sym.Group([rois, cls_prob, bbox_pred])


def decode_rois(rois, deltas, cls_ids):
    rw = rois[:, 2] - rois[:, 0] + 1
    rh = rois[:, 3] - rois[:, 1] + 1
    rcx = rois[:, 0] + rw / 2
    rcy = rois[:, 1] + rh / 2
    d = deltas.reshape(len(rois), NUM_CLASSES, 4)
    d = d[np.arange(len(rois)), cls_ids] * BBOX_STDS
    cx = d[:, 0] * rw + rcx
    cy = d[:, 1] * rh + rcy
    w = np.exp(d[:, 2]) * rw
    h = np.exp(d[:, 3]) * rh
    return np.stack([cx - (w - 1) / 2, cy - (h - 1) / 2,
                     cx + (w - 1) / 2, cy + (h - 1) / 2], axis=-1)


def bind_train(batch, ctx):
    mod = mx.mod.Module(get_train_symbol(batch), context=ctx,
                        data_names=DATA_NAMES, label_names=("rpn_label",))
    mod.bind(data_shapes=[("data", (batch, 1, IMG, IMG)),
                          ("gt_boxes", (batch, 5)),
                          ("rpn_bbox_target", (batch, 4 * K, FEAT, FEAT)),
                          ("rpn_bbox_weight", (batch, 4 * K, FEAT, FEAT)),
                          ("im_info", (batch, 3))],
             label_shapes=[("rpn_label", (batch, K * FEAT * FEAT))])
    return mod


def evaluate(mod, batch, seed, ctx, rounds=6):
    """The test graph with ``mod``'s weights over ``rounds`` batches of
    fresh scenes: (class accuracy, mean IoU) of each scene's top
    detection."""
    test_mod = mx.mod.Module(get_test_symbol(batch), context=ctx,
                             data_names=("data", "im_info"), label_names=())
    test_mod.bind(data_shapes=[("data", (batch, 1, IMG, IMG)),
                               ("im_info", (batch, 3))], for_training=False)
    args, auxs = mod.get_params()
    test_mod.set_params(args, auxs)  # the train-only keys are ignored
    eval_rng = np.random.RandomState(seed + 100)
    n_eval, correct, ious = 0, 0, []
    for _ in range(rounds):
        imgs = np.zeros((batch, 1, IMG, IMG), np.float32)
        gt_list = []
        for i in range(batch):
            imgs[i], gt, cls = draw_scene(eval_rng)
            gt_list.append((gt, cls))
        info = np.tile(np.array([IMG, IMG, 1.0], np.float32), (batch, 1))
        test_mod.forward(DataBatch(data=[mx.nd.array(imgs, ctx),
                                         mx.nd.array(info, ctx)]),
                         is_train=False)
        rois, cls_prob, bbox = [o.asnumpy() for o in test_mod.get_outputs()]
        for i in range(batch):
            sel = rois[:, 0] == i
            r, p, d = rois[sel][:, 1:], cls_prob[sel], bbox[sel]
            score = p[:, 1:].max(axis=1)        # best non-background
            cid = p[:, 1:].argmax(axis=1) + 1
            j = int(np.argmax(score))
            box = decode_rois(r[j:j + 1], d[j:j + 1], np.array([cid[j]]))[0]
            gt, cls = gt_list[i]
            n_eval += 1
            correct += int(cid[j] == cls)
            ious.append(iou_np(box[None], gt[None])[0, 0])
    return correct / n_eval, float(np.mean(ious))


def train_and_eval(epochs=10, batch=4, steps_per_epoch=24, lr=2e-3, seed=0,
                   ctx=None, log=print):
    """Train on ``ctx`` (default the card, gpu(0)) and return (class
    accuracy, mean IoU) on fresh scenes."""
    ctx = mx.gpu(0) if ctx is None else ctx
    rng = np.random.RandomState(seed)
    mod = bind_train(batch, ctx)
    mx.random.seed(seed)
    np.random.seed(seed)
    mod.init_params(mx.init.Xavier(factor_type="in", magnitude=2.0))
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": lr})
    for epoch in range(epochs):
        tot = 0.0
        for _ in range(steps_per_epoch):
            b = to_batch(make_batch(rng, batch), ctx)
            mod.forward(b, is_train=True)
            mod.backward()
            mod.update()
            outs = mod.get_outputs()
            tot += float(outs[1].asnumpy()) + float(outs[3].asnumpy())
        log(f"epoch {epoch}: rpn_bbox+rcnn_bbox loss "
            f"{tot / steps_per_epoch:.4f}")
    acc, miou = evaluate(mod, batch, seed, ctx)
    log(f"eval: cls acc {acc:.3f}, mean IoU {miou:.3f} over {6 * batch} "
        "scenes")
    return acc, miou


def main(argv=None):
    ap = argparse.ArgumentParser(description="Train Faster R-CNN on "
                                 "synthetic scenes")
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU (default: the card, gpu(0))")
    args = ap.parse_args(argv)
    acc, miou = train_and_eval(epochs=args.epochs,
                               ctx=mx.cpu() if args.cpu else mx.gpu(0))
    assert acc >= 0.8 and miou >= 0.5, (acc, miou)
    print("train_faster_rcnn OK")
    return acc, miou


if __name__ == "__main__":
    main()
