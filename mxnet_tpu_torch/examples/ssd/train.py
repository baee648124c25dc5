#!/usr/bin/env python
"""End-to-end SSD training on synthetic detection data (reference:
example/ssd/train.py).

Each 3x64x64 image holds one bright axis-aligned rectangle (class: the
red or the blue channel); labels are VOC-style rows [cls, xmin, ymin,
xmax, ymax] in [0, 1], padded with -1. ``train_ssd`` trains the multibox
pipeline with ``Module`` (Adam, lr 5e-3; its step is the fused step,
captured on the card as one CUDA graph), then binds the detection graph
with the trained weights; ``main`` reports the top detection's mean IoU and
class accuracy over 64 held-out images.

Run on the card: ``python -m mxnet_tpu_torch.examples.ssd.train``; on the
CPU: ``--cpu``.
"""
from __future__ import annotations

import argparse

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.examples.ssd.metric import _iou
from mxnet_tpu_torch.examples.ssd.symbol import get_ssd_detect, get_ssd_train


def make_dataset(n, rng, img=64):
    x = np.zeros((n, 3, img, img), np.float32)
    y = np.full((n, 2, 5), -1.0, np.float32)  # up to 2 rows, -1 padded
    for i in range(n):
        w, h = rng.randint(16, 40, 2)
        x0 = rng.randint(0, img - w)
        y0 = rng.randint(0, img - h)
        cls = rng.randint(0, 2)
        chan = 0 if cls == 0 else 2
        x[i] += rng.randn(3, img, img).astype(np.float32) * 0.05
        x[i, chan, y0:y0 + h, x0:x0 + w] = 1.0
        y[i, 0] = [cls, x0 / img, y0 / img, (x0 + w) / img, (y0 + h) / img]
    return x, y


def iou(a, b):
    """Scalar box IoU."""
    return float(_iou(np.asarray(a), np.asarray(b)[None])[0])


def train_ssd(epochs=10, batch=32, train_size=256, seed=0, log=print,
              ctx=None):
    """Train the multibox pipeline on ``ctx`` (default the card, gpu(0))
    and return (the training module, the detection module bound with its
    weights, the training iterator)."""
    ctx = mx.gpu(0) if ctx is None else ctx
    rng = np.random.RandomState(seed)
    x, y = make_dataset(train_size, rng)
    it = mx.io.NDArrayIter(x, label=y, batch_size=batch,
                           shuffle=True, label_name="label")

    mod = mx.mod.Module(get_ssd_train(num_classes=2), context=ctx,
                        label_names=("label",))
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mx.random.seed(seed)
    np.random.seed(seed)
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": 5e-3})

    for epoch in range(epochs):
        it.reset()
        tot = n = 0.0
        for batch_ in it:
            mod.forward(batch_, is_train=True)
            cls_prob, loc_loss, cls_t, _ = [o.asnumpy()
                                            for o in mod.get_outputs()]
            keep = cls_t >= 0  # -1: ignored by hard negative mining
            target = np.maximum(cls_t, 0)[:, None, :].astype(int)
            ll = -np.log(np.maximum(
                np.take_along_axis(cls_prob, target, 1)[:, 0, :], 1e-9))
            tot += float(ll[keep].mean() + loc_loss.sum())
            n += 1
            mod.backward()
            mod.update()
        log(f"epoch {epoch}: train loss {tot / n:.4f}")

    det_mod = mx.mod.Module(get_ssd_detect(num_classes=2), context=ctx,
                            label_names=None)
    det_mod.bind(data_shapes=it.provide_data, for_training=False)
    arg_params, aux_params = mod.get_params()
    det_mod.set_params(arg_params, aux_params, allow_missing=False)
    return mod, det_mod, it


def detection_quality(det_mod, batch=32, n_images=64, seed=1):
    """(mean IoU of each image's top detection with its box, class
    accuracy of that detection) over ``n_images`` held-out images."""
    xt, yt = make_dataset(n_images, np.random.RandomState(seed))
    dets = det_mod.predict(mx.io.NDArrayIter(xt, batch_size=batch)).asnumpy()
    ious, hits = [], 0
    for i in range(len(xt)):
        d = dets[i]
        d = d[d[:, 0] >= 0]
        if not len(d):
            ious.append(0.0)
            continue
        best = d[np.argmax(d[:, 1])]
        ious.append(iou(best[2:6], yt[i, 0, 1:5]))
        hits += int(best[0] == yt[i, 0, 0])
    return float(np.mean(ious)), hits / len(xt)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Train SSD on synthetic scenes")
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--train-size", type=int, default=256)
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU (default: the card, gpu(0))")
    args = ap.parse_args(argv)
    ctx = mx.cpu() if args.cpu else mx.gpu(0)
    _, det_mod, _ = train_ssd(epochs=args.epochs, batch=args.batch,
                              train_size=args.train_size, ctx=ctx)
    miou, acc = detection_quality(det_mod, batch=args.batch)
    print(f"eval: mean IoU {miou:.3f}, class acc {acc:.3f}")
    return miou, acc


if __name__ == "__main__":
    main()
