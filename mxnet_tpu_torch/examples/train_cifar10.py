"""Train a ResNet on CIFAR-10-shaped data through ``Module.fit`` (reference:
example/image-classification/train_cifar10.py and the part of its
common/fit.py that it runs).

The data is synthetic: one random prototype image per class plus noise of
sigma 1.2 (per-pixel signal-to-noise below 1), 32x32x3, 10 classes; 90 %
trains, 10 % validates. The defaults are the reference's convergence gate
(ResNet-20, 8 epochs, batch 128, 2048 examples, SGD lr 0.05, momentum 0.9,
wd 1e-4, Xavier gaussian in magnitude 2), which it passes at 1.0 on the
CPU; ``--gate 0.9`` exits non-zero below that final validation accuracy.

Run on the card: ``python -m mxnet_tpu_torch.examples.train_cifar10``; on
the CPU: ``--cpu``.
"""
import argparse
import logging
import sys
import time

import numpy as np


def synthetic(n=2048, noise=1.2):
    """Class-prototype data at CIFAR's shapes (the reference's data: its
    seed, its draws)."""
    rng = np.random.RandomState(0)
    proto = rng.randn(10, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, n)
    x = proto[y] + rng.randn(n, 3, 32, 32).astype(np.float32) * noise
    return x, y.astype(np.float32)


def lr_schedule(mx, args, epoch_size):
    """The learning rate and MultiFactorScheduler of ``--lr-step-epochs``
    (reference: common/fit.py ``_get_lr_scheduler``, from epoch 0)."""
    if not args.lr_factor or args.lr_factor >= 1:
        return args.lr, None
    steps = [epoch_size * int(e) for e in args.lr_step_epochs.split(",")
             if int(e) > 0]
    if not steps:
        return args.lr, None
    return args.lr, mx.lr_scheduler.MultiFactorScheduler(
        step=steps, factor=args.lr_factor)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="train a ResNet on synthetic CIFAR-10-shaped data",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--network", default="resnet")
    ap.add_argument("--num-layers", type=int, default=20)
    ap.add_argument("--num-classes", type=int, default=10)
    ap.add_argument("--num-examples", type=int, default=2048)
    ap.add_argument("--num-epochs", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--lr-factor", type=float, default=0.1)
    ap.add_argument("--lr-step-epochs", default="30,60")
    ap.add_argument("--mom", type=float, default=0.9)
    ap.add_argument("--wd", type=float, default=0.0001)
    ap.add_argument("--disp-batches", type=int, default=20)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="bfloat16 computes under mixed precision")
    ap.add_argument("--synthetic-noise", type=float, default=1.2)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the shuffle and the initial weights")
    ap.add_argument("--gate", type=float, default=None,
                    help="exit non-zero unless the final validation "
                         "accuracy reaches this")
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU (default: the card, gpu(0))")
    args = ap.parse_args(argv)
    import mxnet_tpu_torch as mx

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)-15s %(message)s")
    ctx = mx.cpu() if args.cpu else mx.gpu(0)
    np.random.seed(args.seed)
    mx.random.seed(args.seed)
    x, y = synthetic(args.num_examples, args.synthetic_noise)
    split = int(len(x) * 0.9)
    train = mx.io.NDArrayIter(x[:split], y[:split],
                              batch_size=args.batch_size, shuffle=True)
    val = mx.io.NDArrayIter(x[split:], y[split:], batch_size=args.batch_size)
    net = mx.models.get_model(args.network).get_symbol(
        num_classes=args.num_classes, num_layers=args.num_layers,
        image_shape="3,32,32")
    lr, scheduler = lr_schedule(mx, args, split // args.batch_size)
    mod = mx.mod.Module(net, context=ctx,
                        amp=None if args.dtype == "float32" else args.dtype)
    t0 = time.perf_counter()
    mod.fit(train, eval_data=val, eval_metric=["accuracy"],
            num_epoch=args.num_epochs, optimizer="sgd",
            optimizer_params={"learning_rate": lr, "wd": args.wd,
                              "lr_scheduler": scheduler,
                              "momentum": args.mom},
            initializer=mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                       magnitude=2),
            batch_end_callback=mx.callback.Speedometer(args.batch_size,
                                                       args.disp_batches))
    acc = dict(mod.score(val, "acc"))["accuracy"]
    print(f"final validation accuracy {acc:.4f} after {args.num_epochs} "
          f"epochs in {time.perf_counter() - t0:.1f} s on {ctx}", flush=True)
    if args.gate is not None and acc < args.gate:
        sys.exit(f"convergence gate FAILED: {acc:.4f} < {args.gate}")
    return acc


if __name__ == "__main__":
    main()
