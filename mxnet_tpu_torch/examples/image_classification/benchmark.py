#!/usr/bin/env python
"""Sweep training configurations over device counts and batch sizes
(reference: example/image-classification/benchmark.py, one CSV table).

``python -m mxnet_tpu_torch.examples.image_classification.benchmark
[--networks resnet] [--devices 1,2] [--batch-sizes 32,64] [--steps 5]
[--cpu]`` times the module's training step of each network, data-parallel
degree and batch size and prints the reference's CSV rows, with the speedup
over one device. One device runs the fused step (captured on the card),
several the data-parallel group's split path over ``gpu(0..n-1)`` (on the
CPU ``cpu(0..n-1)``); a degree above the cards present, or a batch it does
not divide, is skipped, as in the reference. ``--devices`` defaults to 1
and every card. Model parallelism (``--tp`` above 1) is not ported and
raises. On the card the images are 224 px over 1000 classes, on the CPU 32
px over 16 (``--image-size`` sets the size).
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
    ``batch`` over the contexts ``ctx``, after two untimed steps."""
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
                          .astype(np.float32), ctx[0])],
        label=[mx.nd.array(rng.randint(0, classes, batch)
                           .astype(np.float32), ctx[0])])

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
                         "(default: 1 and every card)")
    ap.add_argument("--tp", type=int, default=1,
                    help="model-parallel degree (only 1 is ported)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--image-size", type=int, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)
    if args.tp > 1:
        raise mx.MXNetError(
            "benchmark.py --tp above 1 (model parallelism) is not ported")
    n_all = None if args.cpu else mx.num_gpus()
    degrees = [int(d) for d in args.devices.split(",")] if args.devices \
        else sorted({1, n_all or 1})
    image = args.image_size or (32 if args.cpu else 224)
    classes = 16 if args.cpu else 1000
    make = mx.cpu if args.cpu else mx.gpu

    print("network,devices,tp,batch,img_per_sec,speedup_vs_1dev")
    rows = []
    base = {}
    for network in args.networks.split(","):
        for n_dev in degrees:
            if n_all is not None and n_dev > n_all:
                continue   # one device always runs: the speedup's base
            for bs in (int(b) for b in args.batch_sizes.split(",")):
                if bs % n_dev:
                    continue
                ips = bench_one(network, bs, image, classes, args.steps,
                                [make(i) for i in range(n_dev)])
                if n_dev == 1:
                    base[network, bs] = ips
                speedup = ips / base[network, bs] \
                    if (network, bs) in base else float("nan")
                rows.append((network, n_dev, 1, bs, ips, speedup))
                print(f"{network},{n_dev},1,{bs},{ips:.1f},{speedup:.2f}")
    return rows


if __name__ == "__main__":
    main()
