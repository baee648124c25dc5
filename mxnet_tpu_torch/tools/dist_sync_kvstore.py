#!/usr/bin/env python
"""The distributed kvstore's worker, run as N local processes by the
launcher (the port's counterpart of tests/nightly/dist_sync_kvstore.py,
with its asserts: rank 0's initial values everywhere, the exact sums of a
synchronous push with and without an updater, a big key, no dead node, and
``dist_async``'s uneven local pushes averaged by ``sync_weights``):

    python tools/launch.py -n 2 -- python mxnet_tpu_torch/tools/dist_sync_kvstore.py --cpu

``--cpu`` joins over gloo with CPU arrays; without it each worker takes
``gpu(rank % cards)`` and joins over NCCL.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..")))

import numpy as np  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import distributed  # noqa: E402


def run():
    shape = (3, 3)
    big_shape = (120, 120)  # the reference slices keys > BIGARRAY_BOUND

    kv = mx.kv.create("dist_sync")
    rank = kv.rank
    nworker = kv.num_workers
    assert nworker == int(os.environ.get("MXTPU_NUM_PROCESSES", 1))

    # init: rank0's values broadcast
    kv.init(3, mx.nd.ones(shape) * (rank + 7))  # non-rank0 value ignored
    kv.init(99, mx.nd.ones(big_shape) * (rank + 1))
    out = mx.nd.empty(shape)
    kv.pull(3, out=out)
    np.testing.assert_allclose(out.asnumpy(), 7 * np.ones(shape))

    # push: each worker pushes rank+1; the aggregate is n(n+1)/2, stored
    # as is (no updater)
    kv.push(3, mx.nd.ones(shape) * (rank + 1))
    kv.pull(3, out=out)
    expect = sum(r + 1 for r in range(nworker))
    np.testing.assert_allclose(out.asnumpy(), expect * np.ones(shape))

    big = mx.nd.empty(big_shape)
    kv.push(99, mx.nd.ones(big_shape) * 2.0)
    kv.pull(99, out=big)
    np.testing.assert_allclose(big.asnumpy(),
                               2.0 * nworker * np.ones(big_shape))

    # updater path: Test adds the rescaled aggregate to the weights
    kv.set_optimizer(mx.optimizer.Test(rescale_grad=1.0))
    kv.push(3, mx.nd.ones(shape))
    kv.pull(3, out=out)
    np.testing.assert_allclose(out.asnumpy(),
                               (expect + nworker) * np.ones(shape))

    # failure detection: every worker heartbeating => zero dead nodes
    assert distributed.get_num_dead_node(timeout=30.0) == 0

    # dist_async: pushes apply locally at once (workers push UNEVEN
    # counts), then sync_weights() at an aligned point averages
    akv = mx.kv.create("dist_async")
    akv.init(7, mx.nd.ones(shape))
    aout = mx.nd.empty(shape)
    for step in range(rank + 1):  # uneven push counts per worker
        akv.push(7, mx.nd.ones(shape) * (rank + 1) * (step + 1))
        akv.pull(7, out=aout)
        np.testing.assert_allclose(  # purely local value
            aout.asnumpy(), (rank + 1) * (step + 1) * np.ones(shape))
    akv.sync_weights()  # aligned point: one call per worker
    akv.pull(7, out=aout)
    avg = sum((r + 1) * (r + 1) for r in range(nworker)) / nworker
    np.testing.assert_allclose(aout.asnumpy(), avg * np.ones(shape))

    kv._barrier()
    print(f"worker {rank}/{nworker}: dist_sync_kvstore OK "
          f"backend={distributed.backend()}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="CPU arrays over gloo (default: a card, NCCL)")
    args = ap.parse_args(argv)
    rank = int(os.environ.get("MXTPU_PROCESS_ID", "0"))
    ctx = mx.cpu() if args.cpu else mx.gpu(rank % max(1, mx.num_gpus()))
    with ctx:
        distributed.init(ctx=ctx)
        try:
            run()
        finally:
            distributed.shutdown()


if __name__ == "__main__":
    main()
