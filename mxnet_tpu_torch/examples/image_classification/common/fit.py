"""The shared training driver of the image-classification examples
(reference: example/image-classification/common/fit.py)."""
from __future__ import annotations

import argparse
import logging
import os
import time

import mxnet_tpu_torch as mx


def add_fit_args(parser: argparse.ArgumentParser):
    """The reference's training options, with ``--gpus`` naming the cards
    and ``--cpu`` training on the CPU."""
    train = parser.add_argument_group("Training", "model training")
    train.add_argument("--network", type=str, help="the neural network to use")
    train.add_argument("--num-layers", type=int,
                       help="number of layers in the neural network")
    train.add_argument("--gpus", type=str,
                       help="the cards to run on, e.g. 0 (default: gpu 0)")
    train.add_argument("--cpu", action="store_true",
                       help="train on the CPU instead of the card")
    train.add_argument("--kv-store", type=str, default="local",
                       help="key-value store type")
    train.add_argument("--num-epochs", type=int, default=100)
    train.add_argument("--lr", type=float, default=0.1)
    train.add_argument("--lr-factor", type=float, default=0.1)
    train.add_argument("--lr-step-epochs", type=str, default="30,60")
    train.add_argument("--optimizer", type=str, default="sgd")
    train.add_argument("--mom", type=float, default=0.9)
    train.add_argument("--wd", type=float, default=0.0001)
    train.add_argument("--batch-size", type=int, default=128)
    train.add_argument("--disp-batches", type=int, default=20)
    train.add_argument("--model-prefix", type=str)
    train.add_argument("--load-epoch", type=int)
    train.add_argument("--top-k", type=int, default=0)
    train.add_argument("--test-io", type=int, default=0)
    train.add_argument("--benchmark", type=int, default=0,
                       help="1 = use synthetic data to benchmark")
    train.add_argument("--dtype", type=str, default="float32",
                       choices=["float32", "bfloat16"],
                       help="bfloat16 computes under mixed precision")
    return train


def _get_lr_scheduler(args, kv, epoch_size):
    if not args.lr_factor or args.lr_factor >= 1:
        return args.lr, None
    begin_epoch = args.load_epoch or 0
    step_epochs = [int(x) for x in args.lr_step_epochs.split(",")]
    lr = args.lr
    for s in step_epochs:
        if begin_epoch >= s:
            lr *= args.lr_factor
    steps = [epoch_size * (x - begin_epoch) for x in step_epochs
             if x - begin_epoch > 0]
    if not steps:
        return lr, None
    return lr, mx.lr_scheduler.MultiFactorScheduler(step=steps,
                                                    factor=args.lr_factor)


def _load_model(args):
    if args.load_epoch is None or args.model_prefix is None:
        return None, None, None
    sym, arg_params, aux_params = mx.model.load_checkpoint(
        args.model_prefix, args.load_epoch, ctx=mx.cpu())
    logging.info("Loaded model %s-%04d.params", args.model_prefix,
                 args.load_epoch)
    return sym, arg_params, aux_params


def _save_model(args, rank=0):
    """Checkpoints under ``--model-prefix`` (worker r > 0 of a distributed
    job under ``<prefix>-<r>``)."""
    if args.model_prefix is None:
        return None
    dst_dir = os.path.dirname(args.model_prefix)
    if dst_dir and not os.path.isdir(dst_dir):
        os.makedirs(dst_dir)
    return mx.callback.do_checkpoint(
        args.model_prefix if rank == 0 else f"{args.model_prefix}-{rank}")


def devices(args):
    """``--cpu``: the CPU; else the cards of ``--gpus`` (default gpu 0)."""
    if args.cpu:
        return [mx.cpu()]
    if not args.gpus:
        return [mx.gpu(0)]
    return [mx.gpu(int(i)) for i in args.gpus.split(",")]


def read_once(args, train):
    """Read ``train`` once without training (``--test-io 1``), logging
    images a second every ``--disp-batches`` batches; returns the images
    and seconds of the whole pass."""
    tic = t0 = time.perf_counter()
    n = 0
    for i, batch in enumerate(train):
        for arr in batch.data:
            arr.wait_to_read()
        n += batch.data[0].shape[0] - batch.pad
        if (i + 1) % args.disp_batches == 0:
            logging.info("Batch [%d]\tSpeed: %.2f samples/sec", i,
                         args.disp_batches * args.batch_size
                         / (time.perf_counter() - tic))
            tic = time.perf_counter()
    return n, time.perf_counter() - t0


def fit(args, network, data_loader, **kwargs):
    """Train ``network`` on the iterators of ``data_loader(args, kv)``
    (reference: fit.py ``fit``); ``--kv-store dist_*`` joins the job of
    ``tools/launch.py`` and shards the data by the store's rank (the log
    lines say ``Node[rank]``): SGD or NAG with momentum, a
    MultiFactorScheduler over ``--lr-step-epochs``, Xavier initialisation,
    the accuracy metric (and top-k), a Speedometer and checkpoints under
    ``--model-prefix`` from ``--load-epoch``. ``kwargs`` go to
    ``Module.fit`` over these. Returns the Module, or with ``--test-io`` the
    images and seconds of one pass over the training data."""
    devs = devices(args)
    kv = None
    if "dist" in args.kv_store:
        # the worker joins the launcher's job (NCCL on the cards, gloo with
        # --cpu) and reads its shard of the data
        mx.distributed.init(ctx=devs[0])
        kv = mx.kv.create(args.kv_store)
    rank = kv.rank if kv else 0
    logging.basicConfig(level=logging.INFO,
                        format=f"%(asctime)-15s Node[{rank}] %(message)s")
    logging.info("start with arguments %s", args)

    train, val = data_loader(args, kv)
    if args.test_io:
        return read_once(args, train)

    sym, arg_params, aux_params = _load_model(args)
    if sym is not None:
        network = sym
    epoch_size = getattr(args, "num_examples", 50000) // args.batch_size
    lr, lr_scheduler = _get_lr_scheduler(args, kv, epoch_size)
    model = mx.mod.Module(
        context=devs, symbol=network,
        amp=None if args.dtype == "float32" else args.dtype)
    optimizer_params = {"learning_rate": lr, "wd": args.wd,
                        "lr_scheduler": lr_scheduler}
    if args.optimizer in ("sgd", "nag"):
        optimizer_params["momentum"] = args.mom
    eval_metrics = ["accuracy"]
    if args.top_k > 0:
        eval_metrics.append(mx.metric.create("top_k_accuracy",
                                             top_k=args.top_k))
    fit_args = dict(
        begin_epoch=args.load_epoch or 0, num_epoch=args.num_epochs,
        eval_data=val, eval_metric=eval_metrics,
        kvstore=kv if kv is not None else args.kv_store,
        optimizer=args.optimizer, optimizer_params=optimizer_params,
        initializer=mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2),
        arg_params=arg_params, aux_params=aux_params,
        batch_end_callback=[mx.callback.Speedometer(args.batch_size,
                                                    args.disp_batches)],
        epoch_end_callback=_save_model(args, rank), allow_missing=True)
    fit_args.update(kwargs)
    model.fit(train, **fit_args)
    return model
