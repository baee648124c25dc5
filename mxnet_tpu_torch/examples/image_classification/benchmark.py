#!/usr/bin/env python
"""Sweep training configurations on one device (reference:
example/image-classification/benchmark.py, which sweeps device counts and
batch sizes and prints one CSV table).

``python -m mxnet_tpu_torch.examples.image_classification.benchmark
[--networks resnet] [--batch-sizes 32,64] [--steps 5] [--cpu]`` times the
module's training step (the fused step, captured on the card) of each
network and batch size and prints the reference's CSV rows. Only one device
is ported: ``--devices`` above 1 and ``--tp`` above 1 raise. On the card
the images are 224 px over 1000 classes, on the CPU 32 px over 16
(``--image-size`` sets the size).
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


def bench_one(network, batch, image, classes, steps, ctx):
    """Images a second of ``steps`` training steps of ``network`` at
    ``batch``, after two untimed steps."""
    kwargs = {"num_layers": 50} if network == "resnet" else {}
    net = mx.models.get_model(network).get_symbol(
        num_classes=classes, image_shape=f"3,{image},{image}", **kwargs)
    mod = mx.mod.Module(net, context=ctx)
    mod.bind(data_shapes=[("data", (batch, 3, image, image))],
             label_shapes=[("softmax_label", (batch,))])
    mod.init_params(mx.init.Xavier(rnd_type="gaussian", magnitude=2))
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    rng = np.random.RandomState(0)
    b = mx.io.DataBatch(
        data=[mx.nd.array(rng.rand(batch, 3, image, image)
                          .astype(np.float32), ctx)],
        label=[mx.nd.array(rng.randint(0, classes, batch)
                           .astype(np.float32), ctx)])

    def step():
        mod.forward(b, is_train=True)
        mod.backward()
        mod.update()

    def sync():
        ex = mod._exec_group._executor
        return float(ex.arg_dict[ex._diff_args[0]].asnumpy().ravel()[0])

    for _ in range(2):
        step()
    sync()
    tic = time.time()
    for _ in range(steps):
        step()
    sync()
    return batch * steps / (time.time() - tic)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--networks", default="resnet")
    ap.add_argument("--batch-sizes", default="32,64")
    ap.add_argument("--devices", default=None,
                    help="comma list of data-parallel degrees to sweep "
                         "(only 1 is ported)")
    ap.add_argument("--tp", type=int, default=1,
                    help="model-parallel degree (only 1 is ported)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--image-size", type=int, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)
    degrees = [int(d) for d in args.devices.split(",")] if args.devices \
        else [1]
    if any(d > 1 for d in degrees) or args.tp > 1:
        raise mx.MXNetError(
            "benchmark.py over several devices (--devices above 1, --tp "
            "above 1) is not ported: the port runs one device")
    ctx = mx.cpu() if args.cpu else mx.gpu(0)
    image = args.image_size or (32 if args.cpu else 224)
    classes = 16 if args.cpu else 1000

    print("network,devices,tp,batch,img_per_sec,speedup_vs_1dev")
    rows = []
    for network in args.networks.split(","):
        for bs in (int(b) for b in args.batch_sizes.split(",")):
            ips = bench_one(network, bs, image, classes, args.steps, ctx)
            rows.append((network, 1, 1, bs, ips, 1.0))
            print(f"{network},1,1,{bs},{ips:.1f},{1.0:.2f}")
    return rows


if __name__ == "__main__":
    main()
