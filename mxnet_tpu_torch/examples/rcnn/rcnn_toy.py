#!/usr/bin/env python
"""Two-stage detection, Fast R-CNN style (reference: example/rcnn/
rcnn_toy.py): a conv body, proposals, ROIPooling, per-ROI class and
box-regression heads.

Proposals are jittered ground-truth boxes and random negatives (standing
in for an RPN); ROIPooling crops the shared conv features and the heads
classify {background, square, cross} and regress box deltas. 120 steps
of 16 images (8 ROIs each), Adam lr 2e-3; the last step's ROI accuracy must
exceed 0.8.

Run on the card: ``python -m mxnet_tpu_torch.examples.rcnn.rcnn_toy``; on
the CPU: ``--cpu``.
"""
from __future__ import annotations

import argparse

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.io import DataBatch

IMG = 48
R_PER_IMG = 8


def draw_scene(rng):
    """One 1xIMGxIMG image with one object: a filled square or a cross."""
    x = rng.randn(IMG, IMG).astype(np.float32) * 0.05
    cls = rng.randint(0, 2)            # 0 = square, 1 = cross
    size = rng.randint(10, 18)
    x0 = rng.randint(2, IMG - size - 2)
    y0 = rng.randint(2, IMG - size - 2)
    if cls == 0:
        x[y0:y0 + size, x0:x0 + size] = 1.0
    else:
        mid = size // 2
        x[y0 + mid - 1:y0 + mid + 2, x0:x0 + size] = 1.0
        x[y0:y0 + size, x0 + mid - 1:x0 + mid + 2] = 1.0
    return x[None], np.array([x0, y0, x0 + size, y0 + size], np.float32), cls


def make_batch(rng, n):
    """n scenes and R_PER_IMG ROIs each: half jittered boxes of the object
    (with regression targets), half random boxes (background unless they
    cover 30 % of the object)."""
    imgs = np.zeros((n, 1, IMG, IMG), np.float32)
    rois, labels, targets, weights = [], [], [], []
    for i in range(n):
        img, gt, cls = draw_scene(rng)
        imgs[i] = img
        for r in range(R_PER_IMG):
            if r < R_PER_IMG // 2:
                jit = gt + rng.uniform(-3, 3, 4).astype(np.float32)
                jit = np.clip(jit, 0, IMG - 1)
                cx, cy = (jit[0] + jit[2]) / 2, (jit[1] + jit[3]) / 2
                w, h = jit[2] - jit[0], jit[3] - jit[1]
                gcx, gcy = (gt[0] + gt[2]) / 2, (gt[1] + gt[3]) / 2
                gw, gh = gt[2] - gt[0], gt[3] - gt[1]
                delta = [(gcx - cx) / max(w, 1), (gcy - cy) / max(h, 1),
                         np.log(gw / max(w, 1)), np.log(gh / max(h, 1))]
                rois.append([i, *jit])
                labels.append(cls + 1)
                targets.append(delta)
                weights.append(1.0)
            else:
                s = rng.randint(8, 16)
                rx = rng.randint(0, IMG - s)
                ry = rng.randint(0, IMG - s)
                box = np.array([rx, ry, rx + s, ry + s], np.float32)
                inter = (max(0, min(box[2], gt[2]) - max(box[0], gt[0])) *
                         max(0, min(box[3], gt[3]) - max(box[1], gt[1])))
                labels.append(0 if inter < 0.3 * (gt[2] - gt[0]) *
                              (gt[3] - gt[1]) else cls + 1)
                rois.append([i, *box])
                targets.append([0.0, 0.0, 0.0, 0.0])
                weights.append(0.0)
    return (imgs, np.array(rois, np.float32),
            np.array(labels, np.float32), np.array(targets, np.float32),
            np.array(weights, np.float32)[:, None])


def build(mx, num_classes=3):
    """The training graph over ``mx`` (this package, or any with its
    symbol API)."""
    data = mx.sym.Variable("data")
    rois = mx.sym.Variable("rois")
    label = mx.sym.Variable("label")
    bbox_target = mx.sym.Variable("roi_bbox_target")
    bbox_weight = mx.sym.Variable("roi_bbox_weight")

    body = mx.sym.Activation(mx.sym.Convolution(
        data, num_filter=16, kernel=(3, 3), pad=(1, 1), name="c1"),
        act_type="relu")
    body = mx.sym.Pooling(body, kernel=(2, 2), stride=(2, 2), pool_type="max")
    body = mx.sym.Activation(mx.sym.Convolution(
        body, num_filter=32, kernel=(3, 3), pad=(1, 1), name="c2"),
        act_type="relu")
    pooled = mx.sym.ROIPooling(data=body, rois=rois, pooled_size=(4, 4),
                               spatial_scale=0.5, name="roipool")
    flat = mx.sym.Flatten(pooled)
    fc = mx.sym.Activation(mx.sym.FullyConnected(flat, num_hidden=64,
                                                 name="fc"), act_type="relu")
    cls_score = mx.sym.FullyConnected(fc, num_hidden=num_classes, name="cls")
    cls_prob = mx.sym.SoftmaxOutput(cls_score, label, name="cls_prob")
    bbox_pred = mx.sym.FullyConnected(fc, num_hidden=4, name="bbox")
    bbox_loss = mx.sym.MakeLoss(
        mx.sym.broadcast_mul(
            mx.sym.smooth_l1(bbox_pred - mx.sym.BlockGrad(bbox_target),
                             scalar=1.0),
            mx.sym.BlockGrad(bbox_weight)) * (1.0 / R_PER_IMG),
        name="bbox_loss")
    return mx.sym.Group([cls_prob, bbox_loss])


DATA_NAMES = ("data", "rois", "roi_bbox_target", "roi_bbox_weight")


def bind_module(ctx, n_img=16):
    n_roi = n_img * R_PER_IMG
    mod = mx.mod.Module(build(mx), context=ctx, data_names=DATA_NAMES,
                        label_names=("label",))
    mod.bind(data_shapes=[("data", (n_img, 1, IMG, IMG)),
                          ("rois", (n_roi, 5)),
                          ("roi_bbox_target", (n_roi, 4)),
                          ("roi_bbox_weight", (n_roi, 1))],
             label_shapes=[("label", (n_roi,))])
    return mod


def to_batch(arrays, ctx):
    imgs, rois, labels, targets, weights = arrays
    return DataBatch(data=[mx.nd.array(a, ctx) for a in
                           (imgs, rois, targets, weights)],
                     label=[mx.nd.array(labels, ctx)])


def train(ctx, steps=120, log=print):
    """Train on ``ctx`` for ``steps`` steps of 16 images; returns the last
    step's ROI accuracy."""
    rng = np.random.RandomState(0)
    n_img = 16
    mod = bind_module(ctx, n_img)
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": 2e-3})
    for step in range(steps):
        arrays = make_batch(rng, n_img)
        mod.forward(to_batch(arrays, ctx), is_train=True)
        mod.backward()
        mod.update()
        if step % 30 == 0 or step == steps - 1:
            cls_prob = mod.get_outputs()[0].asnumpy()
            acc = float((cls_prob.argmax(1) == arrays[2]).mean())
            log(f"step {step}: roi cls acc {acc:.3f}")
    return acc


def main(argv=None, log=print):
    ap = argparse.ArgumentParser(description="Train a Fast R-CNN toy")
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU (default: the card, gpu(0))")
    args = ap.parse_args(argv)
    acc = train(mx.cpu() if args.cpu else mx.gpu(0), log=log)
    assert acc > 0.8, acc
    return acc


if __name__ == "__main__":
    main()
