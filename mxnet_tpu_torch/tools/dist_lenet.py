#!/usr/bin/env python
"""Data-parallel LeNet over N local processes (the port's counterpart of
tests/nightly/dist_lenet.py, with its gate): each worker trains on its
shard of a synthetic separable dataset with ``kvstore="dist_sync"`` (or
the synchronous type ``--kv-store`` names), the gradients all-reduced across the workers, and every worker's accuracy on
its shard must clear 0.9:

    python tools/launch.py -n 2 -- python mxnet_tpu_torch/tools/dist_lenet.py --cpu

``--cpu`` joins over gloo; without it each worker takes ``gpu(rank %
cards)`` over NCCL. ``--no-shuffle`` keeps each shard's order, and
``--save DIR`` writes each worker's final weights to ``DIR/rank<r>.npz``.
``--as-one N``, in one process without the launcher, trains a Module over
N contexts (``cpu(0..N-1)``, or ``gpu(0..N-1)``) on the N shards' batches
joined (batch i of every shard, in rank order, one batch), so replica r
takes shard r's rows: the run that N synchronous workers equal.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..")))

import numpy as np  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import distributed  # noqa: E402

BATCH = 32


def shards(nworker):
    """The same data on every worker, shard r = rows r, r + n, ... (the
    ImageRecordIter part_index/num_parts pattern)."""
    rng = np.random.RandomState(0)
    proto = rng.randn(10, 1, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, 1024)
    x = proto[y] + rng.randn(1024, 1, 28, 28).astype(np.float32) * 0.3
    return [(x[r::nworker], y[r::nworker].astype(np.float32))
            for r in range(nworker)]


def joined(nworker):
    """Batch i of every shard, in rank order, as one batch of
    ``nworker * BATCH`` rows."""
    parts = shards(nworker)
    steps = len(parts[0][0]) // BATCH
    xs, ys = [], []
    for i in range(steps):
        for x, y in parts:
            xs.append(x[i * BATCH:(i + 1) * BATCH])
            ys.append(y[i * BATCH:(i + 1) * BATCH])
    return np.concatenate(xs), np.concatenate(ys)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="CPU arrays over gloo (default: a card, NCCL)")
    ap.add_argument("--no-shuffle", action="store_true")
    ap.add_argument("--save", default=None,
                    help="write the final weights to DIR/rank<r>.npz")
    ap.add_argument("--as-one", type=int, default=0, metavar="N",
                    help="one process over N shards' joined batches")
    ap.add_argument("--kv-store", default="dist_sync",
                    help="the workers' store type (default dist_sync)")
    args = ap.parse_args(argv)
    rank = int(os.environ.get("MXTPU_PROCESS_ID", "0"))
    ctx = mx.cpu() if args.cpu else mx.gpu(rank % max(1, mx.num_gpus()))
    distributed.init(ctx=ctx)
    try:
        rank, nworker = distributed.rank(), distributed.size()
        mx.random.seed(0)
        if args.as_one:
            xs, ys = joined(args.as_one)
            batch, kvstore, tag = BATCH * args.as_one, "local", "one"
            contexts = [(mx.cpu if args.cpu else mx.gpu)(i)
                        for i in range(args.as_one)]
        else:
            xs, ys = shards(nworker)[rank]
            batch, kvstore, tag = BATCH, args.kv_store, f"rank{rank}"
            contexts = [ctx]
        it = mx.io.NDArrayIter(xs, ys, batch_size=batch,
                               shuffle=not args.no_shuffle)
        mod = mx.mod.Module(mx.models.lenet.get_symbol(10), context=contexts)
        mod.fit(it, optimizer="sgd", kvstore=kvstore,
                optimizer_params={"learning_rate": 0.05, "momentum": 0.5},
                initializer=mx.init.Xavier(), num_epoch=3)
        acc = dict(mod.score(it, "acc"))["accuracy"]
        assert acc > 0.9, f"worker {rank}: acc {acc}"
        if args.save:
            args_, _ = mod.get_params()
            np.savez(os.path.join(args.save, f"{tag}.npz"),
                     **{k: v.asnumpy() for k, v in args_.items()})
        print(f"worker {rank}/{nworker}: dist_lenet OK acc={acc:.3f} "
              f"backend={distributed.backend()}", flush=True)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
