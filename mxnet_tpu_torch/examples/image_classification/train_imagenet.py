#!/usr/bin/env python
"""Train an image classifier on ImageNet-style RecordIO files (reference:
example/image-classification/train_imagenet.py).

``python -m mxnet_tpu_torch.examples.image_classification.train_imagenet
--data-train train.rec [--data-val val.rec]`` trains ResNet-50 at 224 px
under bf16 mixed precision on the card (``--gpus``, default gpu 0);
``--cpu`` trains on the CPU. Each step is ``fit``'s fused step, captured
on the card as one CUDA graph and replayed, as the reference's is one
compiled program; ``MXNET_RUN_N_STEPS=n`` runs ``n`` of them a call, and
``MXTPU_NO_FUSED_STEP=1`` the split path. Pack the files with
``mxnet_tpu_torch/tools/im2rec.py``.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..")))

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch.examples.image_classification.common import (  # noqa: E402
    data, fit)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="train imagenet-1k",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    fit.add_fit_args(parser)
    data.add_data_args(parser)
    data.add_data_aug_args(parser)
    parser.set_defaults(
        network="resnet",
        num_layers=50,
        num_classes=1000,
        num_examples=1281167,
        image_shape="3,224,224",
        min_random_scale=1,
        num_epochs=90,
        lr_step_epochs="30,60,80",
        lr=0.1,
        batch_size=256,
        dtype="bfloat16",
    )
    return parser.parse_args(argv)


def main(argv=None, data_loader=None, **fit_kwargs):
    """Train as the command line says; returns ``fit.fit``'s result.
    ``data_loader`` replaces ``data.get_rec_iter``; ``fit_kwargs`` go to
    ``Module.fit``."""
    args = parse_args(argv)
    net = mx.models.get_model(args.network).get_symbol(
        num_classes=args.num_classes,
        **({"num_layers": args.num_layers} if args.num_layers else {}),
        image_shape=args.image_shape)
    return fit.fit(args, net, data_loader or data.get_rec_iter, **fit_kwargs)


if __name__ == "__main__":
    main()
