#!/usr/bin/env python
"""SSD evaluation with VOC-style mAP (reference: example/ssd/evaluate.py,
after evaluate/evaluate_net.py and eval_voc.py): the detection graph over
an evaluation set, mean average precision at each IoU threshold.

Run on the card: ``python -m mxnet_tpu_torch.examples.ssd.evaluate
[--epochs 10]`` (it trains first: the synthetic scenes stand in for VOC,
so there is no checkpoint to load; ``evaluate_net(det_mod)`` scores any
bound detection module); on the CPU: ``--cpu``. The gate: mAP@0.5 >= 0.5.
"""
from __future__ import annotations

import argparse

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.examples.ssd.metric import MApMetric
from mxnet_tpu_torch.examples.ssd.train import make_dataset, train_ssd


def evaluate_net(det_mod, batch=32, n_images=64, seed=1,
                 thresholds=(0.5, 0.75)):
    """Detections against the boxes: {iou_threshold: mAP} (reference:
    evaluate_net.py)."""
    xt, yt = make_dataset(n_images, np.random.RandomState(seed))
    det_it = mx.io.NDArrayIter(xt, batch_size=batch)
    dets = det_mod.predict(det_it).asnumpy()[:n_images]
    out = {}
    for t in thresholds:
        m = MApMetric(ovp_thresh=t)
        m.update([yt], [dets])
        out[t] = m.get()[1]
    return out


def train_and_map(epochs=10, batch=32, train_size=256, seed=0, log=print,
                  ctx=None):
    """Train the SSD pipeline (``train.train_ssd``) on ``ctx`` (default
    the card) and return {iou_threshold: mAP}."""
    _, det_mod, _ = train_ssd(epochs=epochs, batch=batch,
                              train_size=train_size, seed=seed, log=log,
                              ctx=ctx)
    return evaluate_net(det_mod, batch=batch)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Train SSD and report its mAP")
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card, gpu(0))")
    args = ap.parse_args(argv)
    maps = train_and_map(epochs=args.epochs,
                         ctx=mx.cpu() if args.cpu else mx.gpu(0))
    for t, v in maps.items():
        print(f"mAP@{t}: {v:.3f}")
    assert maps[0.5] >= 0.5, maps
    print("evaluate OK")
    return maps


if __name__ == "__main__":
    main()
