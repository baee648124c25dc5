#!/usr/bin/env python
"""Inference scoring benchmark (reference:
example/image-classification/benchmark_score.py, the docs/how_to/perf.md
inference tables).

``python -m mxnet_tpu_torch.examples.image_classification.benchmark_score
[--networks alexnet,resnet,inception-bn] [--batch-sizes 1,32] [--dtype
float32|bfloat16] [--cpu]`` prints ``network: <n> batch: <b>  <x> img/s``
for each pair. Each forward is ``Module.forward(is_train=False)``: on the
card the evaluation forward captured as one CUDA graph and replayed. The
rate is the reference's: the difference of two timed runs of forwards
(``num_batches // 4`` and ``num_batches``), each ended by reading one
output value to the host.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..")))

import mxnet_tpu_torch as mx  # noqa: E402


def bind_scorer(network, batch_size, image_shape=(3, 224, 224),
                dtype="float32", ctx=None, **kwargs):
    """A forward-only Module of ``network`` (1000 classes, Xavier weights)
    bound at ``batch_size`` on ``ctx`` (default gpu 0), and one batch of
    random images for it."""
    net = mx.models.get_model(network).get_symbol(
        num_classes=1000, image_shape=",".join(map(str, image_shape)),
        **kwargs)
    ctx = ctx if ctx is not None else mx.gpu(0)
    mod = mx.mod.Module(net, context=ctx,
                        amp=None if dtype == "float32" else dtype)
    shape = (batch_size,) + tuple(image_shape)
    mod.bind(data_shapes=[("data", shape)],
             label_shapes=[("softmax_label", (batch_size,))],
             for_training=False)
    mod.init_params(mx.init.Xavier())
    rng = np.random.RandomState(0)
    batch = mx.io.DataBatch(
        data=[mx.nd.array(rng.rand(*shape).astype(np.float32), ctx)],
        label=[mx.nd.zeros(batch_size, ctx)])
    return mod, batch


def images_per_s(forward, read, batch_size, num_batches=50):
    """The reference's rate of ``forward``: three forwards first, then two
    timed runs of ``max(2, num_batches // 4)`` and ``num_batches`` forwards,
    each ended by ``read()`` (one value to the host); images a second of
    their difference."""
    for _ in range(3):
        forward()
    read()

    def timed(n):
        tic = time.time()
        for _ in range(n):
            forward()
        read()
        return time.time() - tic

    n1 = max(2, num_batches // 4)
    t1 = timed(n1)
    t2 = timed(num_batches)
    return batch_size * (num_batches - n1) / (t2 - t1)


def score(network, batch_size, image_shape=(3, 224, 224), num_batches=50,
          dtype="float32", ctx=None, **kwargs):
    """Images a second of ``Module.forward(is_train=False)`` on one batch
    (reference: benchmark_score.py ``score``)."""
    mod, batch = bind_scorer(network, batch_size, image_shape, dtype, ctx,
                             **kwargs)
    return images_per_s(
        lambda: mod.forward(batch, is_train=False),
        lambda: float(mod.get_outputs()[0].asnumpy().ravel()[0]),
        batch_size, num_batches)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--networks", default="alexnet,resnet,inception-bn")
    parser.add_argument("--batch-sizes", default="1,32")
    parser.add_argument("--dtype", default="float32")
    parser.add_argument("--image-shape", default="3,224,224")
    parser.add_argument("--num-batches", type=int, default=50)
    parser.add_argument("--cpu", action="store_true",
                        help="score on the CPU instead of the card")
    args = parser.parse_args(argv)
    ctx = mx.cpu() if args.cpu else mx.gpu(0)
    image_shape = tuple(int(x) for x in args.image_shape.split(","))
    rates = {}
    for net in args.networks.split(","):
        kwargs = {"num_layers": 50} if net == "resnet" else {}
        for b in [int(x) for x in args.batch_sizes.split(",")]:
            speed = score(net, b, image_shape, args.num_batches, args.dtype,
                          ctx, **kwargs)
            rates[(net, b)] = speed
            print(f"network: {net} batch: {b}  {speed:.1f} img/s")
    return rates


if __name__ == "__main__":
    main()
