#!/usr/bin/env python
"""Train an MLP or LeNet on MNIST (reference:
example/image-classification/train_mnist.py).

``python -m mxnet_tpu_torch.examples.image_classification.train_mnist
[--network lenet]`` trains on the card (``--gpus``, default gpu 0);
``--cpu`` trains on the CPU. The idx files are read from ``--data-dir``;
where they are missing, the reference's synthetic digits stand in for them
(ten ``RandomState(0)`` prototypes with noise: 6000 training and 1000
validation images).
"""
from __future__ import annotations

import argparse
import gzip
import os
import struct
import sys

import numpy as np

sys.path.insert(0, os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..")))

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch.examples.image_classification.common import (  # noqa: E402
    fit)


def read_data(label_path, image_path):
    with gzip.open(label_path) as flbl:
        struct.unpack(">II", flbl.read(8))
        label = np.frombuffer(flbl.read(), dtype=np.int8)
    with gzip.open(image_path, "rb") as fimg:
        _, num, rows, cols = struct.unpack(">IIII", fimg.read(16))
        image = np.frombuffer(fimg.read(), dtype=np.uint8).reshape(
            len(label), rows, cols)
    return label, image


def synthetic_digits():
    """The reference's stand-in for MNIST: (train labels, train images, val
    labels, val images), images 0-255 of ten prototypes plus noise."""
    rng = np.random.RandomState(0)
    proto = rng.rand(10, 28, 28).astype(np.float32)
    train_lbl = rng.randint(0, 10, 6000)
    train_img = (proto[train_lbl] * 255 +
                 rng.randn(6000, 28, 28) * 16).clip(0, 255)
    val_lbl = rng.randint(0, 10, 1000)
    val_img = (proto[val_lbl] * 255 +
               rng.randn(1000, 28, 28) * 16).clip(0, 255)
    return train_lbl, train_img, val_lbl, val_img


def get_mnist_iter(args, kv):
    data_dir = args.data_dir
    if os.path.exists(os.path.join(data_dir, "train-images-idx3-ubyte.gz")):
        train_lbl, train_img = read_data(
            os.path.join(data_dir, "train-labels-idx1-ubyte.gz"),
            os.path.join(data_dir, "train-images-idx3-ubyte.gz"))
        val_lbl, val_img = read_data(
            os.path.join(data_dir, "t10k-labels-idx1-ubyte.gz"),
            os.path.join(data_dir, "t10k-images-idx3-ubyte.gz"))
    else:
        train_lbl, train_img, val_lbl, val_img = synthetic_digits()

    def to4d(img):
        return img.reshape(img.shape[0], 1, 28, 28).astype(np.float32) / 255

    train = mx.io.NDArrayIter(to4d(train_img), train_lbl.astype(np.float32),
                              args.batch_size, shuffle=True)
    val = mx.io.NDArrayIter(to4d(val_img), val_lbl.astype(np.float32),
                            args.batch_size)
    return train, val


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="train mnist",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--num-classes", type=int, default=10)
    parser.add_argument("--num-examples", type=int, default=60000)
    parser.add_argument("--data-dir", type=str, default="data/")
    fit.add_fit_args(parser)
    parser.set_defaults(network="mlp", num_epochs=10, batch_size=64, lr=0.01,
                        lr_step_epochs="10")
    return parser.parse_args(argv)


def main(argv=None, **fit_kwargs):
    """Train as the command line says; returns the Module and its
    validation accuracy. ``fit_kwargs`` go to ``Module.fit``."""
    args = parse_args(argv)
    if args.network == "mlp":
        net = mx.models.mlp.get_symbol(num_classes=args.num_classes)
    else:
        net = mx.models.lenet.get_symbol(num_classes=args.num_classes)
    mod = fit.fit(args, net, get_mnist_iter, **fit_kwargs)
    _, val = get_mnist_iter(args, None)
    acc = dict(mod.score(val, "acc"))["accuracy"]
    print(f"validation accuracy {acc:.4f}")
    return mod, acc


if __name__ == "__main__":
    main()
