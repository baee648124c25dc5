#!/usr/bin/env python
"""Score a saved checkpoint (reference: example/image-classification/score.py:
``Module.load``, a forward-only bind and the accuracy and cross-entropy
metrics over an iterator).

``python -m mxnet_tpu_torch.examples.image_classification.score [--prefix P]
[--epoch N] [--cpu]``: where ``P-symbol.json`` is missing it first trains
LeNet on the reference's synthetic digits (512 images of ten prototypes)
and checkpoints it there; then it scores ``P-NNNN.params`` on the card
(gpu 0), or on the CPU with ``--cpu``. The prefix defaults to
``score_demo`` in the temporary directory.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..")))

import mxnet_tpu_torch as mx  # noqa: E402


def digits(batch_size=64):
    """The reference's 512 synthetic digits as a shuffled iterator."""
    rng = np.random.RandomState(0)
    proto = rng.randn(10, 1, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, 512)
    x = proto[y] + rng.randn(512, 1, 28, 28).astype(np.float32) * 0.3
    return mx.io.NDArrayIter(x, y.astype(np.float32), batch_size=batch_size,
                             shuffle=True)


def main(argv=None):
    """Score as the command line says; returns the metrics."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--prefix",
                    default=os.path.join(tempfile.gettempdir(), "score_demo"))
    ap.add_argument("--epoch", type=int, default=2)
    ap.add_argument("--cpu", action="store_true",
                    help="score on the CPU instead of the card")
    args = ap.parse_args(argv)
    ctx = mx.cpu() if args.cpu else mx.gpu(0)

    it = digits()
    if not os.path.exists(f"{args.prefix}-symbol.json"):
        mod = mx.mod.Module(mx.models.lenet.get_symbol(10), context=ctx)
        mod.fit(it, optimizer="sgd",
                optimizer_params={"learning_rate": 0.05, "momentum": 0.5},
                initializer=mx.init.Xavier(),
                epoch_end_callback=mx.callback.do_checkpoint(args.prefix),
                num_epoch=args.epoch)

    scored = mx.mod.Module.load(args.prefix, args.epoch, context=ctx)
    scored.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
                for_training=False)
    metrics = [mx.metric.create(m) for m in ("acc", "ce")]
    it.reset()
    for batch in it:
        scored.forward(batch, is_train=False)
        for m in metrics:
            scored.update_metric(m, batch.label)
    for m in metrics:
        name, val = m.get()
        print(f"{name}: {val:.4f}")
    return metrics


if __name__ == "__main__":
    main()
